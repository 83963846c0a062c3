"""Center zero-pad / crop to a multiple of 2^num_encoders
(``evreal_tpu/ops/pad.py``; reference CropParameters, utils/util.py:20-59):
pad_top = ceil(d/2), pad_bottom = floor(d/2), and crop back around the
padded image's center. Works on ``(..., H, W)`` tensors (NCHW)."""

from math import ceil, floor

import torch.nn.functional as F


def optimal_crop_size(max_size, max_subsample_factor, safety_margin=0):
    f = 2 ** max_subsample_factor
    size = f * ceil(max_size / f)
    return size + safety_margin * f


class CropParams:
    def __init__(self, width, height, num_encoders, safety_margin=0):
        self.height = height
        self.width = width
        self.height_crop = optimal_crop_size(height, num_encoders,
                                             safety_margin)
        self.width_crop = optimal_crop_size(width, num_encoders,
                                            safety_margin)

        dh = self.height_crop - height
        dw = self.width_crop - width
        self.padding_top = ceil(0.5 * dh)
        self.padding_bottom = floor(0.5 * dh)
        self.padding_left = ceil(0.5 * dw)
        self.padding_right = floor(0.5 * dw)

        cx = floor(self.width_crop / 2)
        cy = floor(self.height_crop / 2)
        self.ix0 = cx - floor(width / 2)
        self.ix1 = cx + ceil(width / 2)
        self.iy0 = cy - floor(height / 2)
        self.iy1 = cy + ceil(height / 2)

    @property
    def padded_shape(self):
        return (self.height_crop, self.width_crop)

    def pad(self, x):
        """Zero-pad ``(..., H, W)`` to the padded shape."""
        return F.pad(x, (self.padding_left, self.padding_right,
                         self.padding_top, self.padding_bottom))

    def crop(self, x):
        """Crop ``(..., H, W)`` back to the original (height, width)."""
        return x[..., self.iy0:self.iy1, self.ix0:self.ix1]
