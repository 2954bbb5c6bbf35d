"""The segmentation, pose and oriented-box heads: ``Proto``, ``Segment``,
``Pose``, ``OBB``, the mask assembly, the keypoint decode and the angle decode.

Port of ``experiment_yolo_tpu/nn/heads_extra.py`` (``Proto:23``,
``Segment:40``, ``Pose:68``, ``OBB:94``, ``assemble_masks:875``,
``decode_kpts:884``, ``decode_obb_angle:905``),
NCHW, with the Ultralytics fork's state-dict names: ``Segment`` is a
:class:`~experiment_yolo_torch.nn.modules.Detect` (``cv2.{i}.{j}``,
``cv3.{i}.{j}``) with per-level mask-coefficient branches ``cv4.{i}.{j}`` and
a ``proto`` (``cv1``, ``upsample``, ``cv2``, ``cv3``); ``Pose`` and ``OBB``
are a ``Detect`` with per-level keypoint or angle branches ``cv4.{i}.{j}``.

The prototype upsampling is a 2x2 stride-2 transposed convolution with a
bias (flax ``nn.ConvTranspose``, which does not flip its kernel; PyTorch's
``ConvTranspose2d`` is a convolution's gradient and does, so the converter
flips the kernel's two spatial axes, ``utils/convert.py``). In bf16 its
input, weight and bias are cast to the compute dtype, as every convolution's.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from experiment_yolo_torch.nn.modules import Conv, Detect, cast_conv
from experiment_yolo_torch.ops.anchors import make_anchors


class Proto(nn.Module):
    """Mask prototypes: Conv 3x3 -> 2x transposed upsample -> Conv 3x3 -> Conv 1x1 to ``nm``."""

    dtype = torch.float32  # the compute dtype of the transposed convolution

    def __init__(self, c1: int, c_: int = 256, nm: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, nm, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, up = self.dtype, self.upsample
        y = F.conv_transpose2d(self.cv1(x).to(dt), up.weight.to(dt), up.bias.to(dt), stride=2)
        return self.cv3(self.cv2(y))


class Segment(Detect):
    """Detect + per-level mask coefficients (``c4 = max(ch[0] // 4, nm)``
    channels, then ``nm``) + prototypes from the first level's map. Returns
    (detect maps [(B, 4*reg_max + nc, H, W)], coefficient maps [(B, nm, H,
    W)], protos (B, nm, 2*H0, 2*W0))."""

    def __init__(self, nc: int, nm: int = 32, npr: int = 256, ch: Sequence[int] = (), reg_max: int = 16):
        super().__init__(nc, ch, reg_max)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = self._branches(ch, max(ch[0] // 4, nm), nm)

    def forward(self, xs: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
        det = self._maps(xs, self.cv2, self.cv3)
        coeffs = [cast_conv(seq[2], seq[1](seq[0](x)), self.dtype) for seq, x in zip(self.cv4, xs)]
        return det, coeffs, self.proto(xs[0])


class Pose(Detect):
    """Detect + per-level keypoint regression (``c4 = max(ch[0] // 4, nk)``
    channels, then ``nk = kpt_shape[0] * kpt_shape[1]``, keypoint-major).
    Returns (detect maps [(B, 4*reg_max + nc, H, W)], keypoint maps [(B, nk,
    H, W)])."""

    def __init__(self, nc: int = 1, kpt_shape: Sequence[int] = (17, 3), ch: Sequence[int] = (), reg_max: int = 16):
        super().__init__(nc, ch, reg_max)
        self.kpt_shape = tuple(int(k) for k in kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = self._branches(ch, max(ch[0] // 4, nk), nk)

    def forward(self, xs: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        det = self._maps(xs, self.cv2, self.cv3)
        return det, [cast_conv(seq[2], seq[1](seq[0](x)), self.dtype) for seq, x in zip(self.cv4, xs)]


class OBB(Detect):
    """Detect + per-level rotation-angle branches (``c4 = max(ch[0] // 4, ne)``
    channels, then ``ne``). Returns (detect maps [(B, 4*reg_max + nc, H, W)],
    angle maps [(B, ne, H, W)]); :func:`decode_obb_angle` maps the angle to
    (-pi/4, 3pi/4)."""

    def __init__(self, nc: int = 1, ne: int = 1, ch: Sequence[int] = (), reg_max: int = 16):
        super().__init__(nc, ch, reg_max)
        self.ne = int(ne)
        self.cv4 = self._branches(ch, max(ch[0] // 4, self.ne), self.ne)

    def forward(self, xs: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        det = self._maps(xs, self.cv2, self.cv3)
        return det, [cast_conv(seq[2], seq[1](seq[0](x)), self.dtype) for seq, x in zip(self.cv4, xs)]


def decode_obb_angle(angle_maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Angle maps [(B, ne, H, W)] -> (B, A, ne) radians in (-pi/4, 3pi/4),
    ``(sigmoid - 0.25) * pi`` in the maps' dtype, anchors level by level in
    row-major order."""
    flat = torch.cat([a.flatten(2).transpose(1, 2) for a in angle_maps], 1)
    return (torch.sigmoid(flat) - 0.25) * math.pi


def flat_kpts(kpt_maps: Sequence[torch.Tensor], kpt_shape: Sequence[int]) -> torch.Tensor:
    """Per-level keypoint maps [(B, nk*nd, H, W)] -> (B, A, nk, nd), anchors
    level by level in row-major order, as JAX's NHWC reshape gives them."""
    b = kpt_maps[0].shape[0]
    return torch.cat([k.flatten(2).transpose(1, 2) for k in kpt_maps], 1).reshape(b, -1, *kpt_shape)


def decode_kpts(kpt_maps: Sequence[torch.Tensor], strides: Sequence[int], kpt_shape: Sequence[int] = (17, 3)
                ) -> torch.Tensor:
    """Keypoints in input pixels (B, A, nk, nd) from the raw maps, in JAX's
    form (not the reference's): xy = (2 * p + anchor - 0.5) * stride on the
    raw regression, the visibility sigmoided; xy come out in f32 (the anchors
    are), the visibility is cast up from the compute dtype."""
    flat = flat_kpts(kpt_maps, kpt_shape)
    anchors, stride_t = make_anchors([k.shape[2:] for k in kpt_maps], strides, 0.5, device=flat.device)
    xy = (flat[..., :2] * 2.0 + (anchors[None, :, None] - 0.5)) * stride_t[None, :, None]
    if kpt_shape[1] == 3:
        return torch.cat([xy, torch.sigmoid(flat[..., 2:3]).to(xy.dtype)], -1)
    return xy


def assemble_masks(coeffs: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """``sigmoid(coeffs . protos)`` per detection: coefficients (B, K, nm) of
    K kept detections and protos (B, nm, Hp, Wp) -> (B, K, Hp, Wp)
    probabilities (JAX ``assemble_masks``, there with NHWC protos)."""
    return torch.sigmoid(torch.einsum("bkn,bnhw->bkhw", coeffs, protos.to(coeffs.dtype)))
