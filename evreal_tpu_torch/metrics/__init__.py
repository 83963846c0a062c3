from evreal_tpu_torch.metrics.functional import mse, ssim
