"""Letterbox without OpenCV: a bilinear resize in PyTorch plus a pad of 114.

Port of ``experiment_yolo_tpu/data/augment.py:letterbox``, with the same gain,
the same resized size and the same pad split (``round(d - 0.1)`` before,
``round(d + 0.1)`` after). The resize is half-pixel bilinear, as OpenCV's
INTER_LINEAR; OpenCV rounds through 11-bit fixed-point weights, so a resized
pixel may differ from its result by a grey level or two.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


PAD_VALUE = 114


def letterbox(img: np.ndarray, new_shape: Union[int, Tuple[int, int]] = (640, 640)
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Ratio-preserving resize + centred pad of 114 of an (H, W, 3) uint8 image.

    Returns (image, gain, (padw, padh)).
    """
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    new_w, new_h = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw, dh = (new_shape[1] - new_w) / 2, (new_shape[0] - new_h) / 2
    if (shape[1], shape[0]) != (new_w, new_h):
        x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False)
        img = (x[0].permute(1, 2, 0) + 0.5).floor().clamp(0, 255).to(torch.uint8).numpy()
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((new_h + top + bottom, new_w + left + right, img.shape[2]), PAD_VALUE, dtype=np.uint8)
    out[top:top + new_h, left:left + new_w] = img
    return out, r, (left, top)
