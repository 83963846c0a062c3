"""ColorNet (``evreal_tpu/models/colornet.py``; reference model/model.py:46-105):
the events of an RGBW Bayer sensor reconstructed per colour channel at half
resolution and as grayscale at full resolution, then merged into a BGR
frame.

As in the JAX package, the four half-resolution channels step as ONE
batch-4 recurrent state and the full-resolution grayscale as a batch-1
state (the model is batch-equivariant: the same numbers as the reference's
five sequential passes). The chunk's windows voxelize in one launch, in
f32 at HIGHEST (the color path never runs in bf16), with TF32 off unless
``EVREAL_PRECISION`` says otherwise (``utils.matmul_precision_ctx``). The
uint8 merge (``utils/color.py``) runs on the device, next to the frames,
where the JAX package merges on the host with OpenCV.
"""

import os

import torch

from evreal_tpu_torch.ops.normalize import post_process_normalization_frames
from evreal_tpu_torch.ops.pad import CropParams
from evreal_tpu_torch.parallel.mesh import replica_on
from evreal_tpu_torch.utils import U8_LUT, matmul_precision_ctx, upload
from evreal_tpu_torch.utils.color import merge_channels_into_color_image

# Bayer pattern slices on (H, W): reference model/model.py:54-58
CHANNEL_SLICES = {
    "R": (slice(0, None, 2), slice(0, None, 2)),
    "G": (slice(0, None, 2), slice(1, None, 2)),
    "B": (slice(1, None, 2), slice(1, None, 2)),
    "W": (slice(1, None, 2), slice(0, None, 2)),
}
COLOR_ORDER = ("R", "G", "B", "W")


def to_u8(img):
    """``clip(img * 255, 0, 255)`` truncated to uint8, the JAX color
    path's quantization of the channel reconstructions."""
    return (img * 255).clamp(0, 255).to(torch.uint8)


class ColorRunner:
    """Chunked color eval for one (model, full sensor resolution) on one
    device. ``voxel_stage`` maps an event-buffer dict to ``(T, B, H, W)``
    f32 voxel grids (the grayscale runner's, with its event norm);
    ``post_norm`` is the method's post-norm of the merged frames."""

    lanes = 1
    dtype = torch.float32  # never the bf16 serving mode

    def __init__(self, model, *, height, width, voxel_stage, post_norm,
                 device, chunk_t=None):
        self.device = torch.device(device)
        self.model = replica_on(model, self.device).eval()
        self.voxel_stage = voxel_stage
        self.post_norm = post_norm
        self.u8_lut = torch.from_numpy(U8_LUT).to(self.device)
        # the color model makes 5 passes a window, so the default chunk is
        # smaller than the grayscale runner's 32; EVREAL_CHUNK_T applies
        if chunk_t is None:
            chunk_t = int(os.environ.get("EVREAL_CHUNK_T", "16"))
        self.chunk_t = chunk_t
        enc = model.num_encoders
        self.crop_half = CropParams(width // 2, height // 2, enc)
        self.crop_full = CropParams(width, height, enc)

    def init_state(self):
        ph2, pw2 = self.crop_half.padded_shape
        ph, pw = self.crop_full.padded_shape
        kw = {"device": self.device, "dtype": torch.float32}
        return {"color": self.model.init_state(4, ph2, pw2, **kw),
                "gray": self.model.init_state(1, ph, pw, **kw)}

    def upload(self, arrays):
        return upload(arrays, self.device)

    @torch.no_grad()
    def reconstruct(self, state, vox):
        """``vox`` (n, B, H, W) f32 -> (state, channels (n, 4, H/2, W/2)
        uint8 in ``COLOR_ORDER``, gray (n, H, W) uint8)."""
        with matmul_precision_ctx():
            # even-crop before the Bayer slicing: at an odd sensor side the
            # 0::2 and 1::2 slices differ by one and could not stack (the
            # JAX package's choice, models/colornet.py:78-91)
            even = vox[..., :self.crop_half.height * 2,
                       :self.crop_half.width * 2]
            color = torch.stack([even[..., CHANNEL_SLICES[c][0],
                                      CHANNEL_SLICES[c][1]]
                                 for c in COLOR_ORDER], 1)
            color = self.crop_half.pad(color)  # (n, 4, B, ph2, pw2)
            gray = self.crop_full.pad(vox)     # (n, B, ph, pw)
            cstate, gstate = state["color"], state["gray"]
            cimgs, gimgs = [], []
            for i in range(vox.shape[0]):
                out, cstate = self.model(color[i], cstate)
                cimgs.append(out["image"][:, 0])
                out, gstate = self.model(gray[i:i + 1], gstate)
                gimgs.append(out["image"][0, 0])
            cimgs = self.crop_half.crop(torch.stack(cimgs))
            gimgs = self.crop_full.crop(torch.stack(gimgs))
        return ({"color": cstate, "gray": gstate}, to_u8(cimgs),
                to_u8(gimgs))

    @staticmethod
    def merge(channels, gray):
        """(n, 4, H/2, W/2) and (n, H, W) uint8 -> (n, H, W, 3) BGR uint8."""
        return merge_channels_into_color_image(channels, gray)

    @torch.no_grad()
    def post(self, merged):
        """Merged frames (n, H, W, 3) uint8 -> f32 in [0, 1] after the
        post-norm, each frame over its three channels, and the clip."""
        frames = self.u8_lut[merged.long()]
        return post_process_normalization_frames(
            frames, self.post_norm).clamp(0.0, 1.0)

    @torch.no_grad()
    def run(self, state, bufs, valid_t):
        """One chunk: voxelize all of ``bufs`` in one launch, reconstruct
        and merge its first ``valid_t`` windows. Returns (state, merged
        BGR uint8 (n, H, W, 3), clipped f32 frames (n, H, W, 3))."""
        vox = self.voxel_stage(bufs)
        state, channels, gray = self.reconstruct(state, vox[:valid_t])
        merged = self.merge(channels, gray)
        return state, merged, self.post(merged)
