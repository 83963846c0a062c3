from evreal_tpu_torch.metrics.functional import mse, ssim
from evreal_tpu_torch.metrics.tracker import EvalMetricsTracker, MetricTracker
