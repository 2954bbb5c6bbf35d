"""The core modules of the detect paths, NCHW, Ultralytics state-dict names.

Port of the forward math of ``experiment_yolo_tpu/nn/modules.py``: ``Conv``
(``ConvBN``), ``Bottleneck``, ``C2f``, ``SPPF``, ``Upsample``, ``Concat``,
``Add``, ``ZoomCat``, ``ScalSeq``, ``LDConv`` and ``Detect``: every block of
``yolov8.yaml``, ``yolov8-p2.yaml``, ``yolov8-ASF.yaml``,
``yolov8-ASF-P2.yaml``, ``yolov8-ASF-P2P2.yaml`` and ``yolov8-LD-P2.yaml``. The
Mamba/VSS blocks of ``yolov8-C2f-VSS.yaml`` are in ``nn/zoo_blocks.py``.
Parameter and buffer names are those of the Ultralytics fork (``conv``/``bn``,
``cv1``/``cv2``/``m.{k}``, LDConv ``p_conv``/``conv.0``/``conv.1``, ScalSeq
``conv3d``/``bn``, Detect ``cv2.{i}.{j}``/``cv3.{i}.{j}``), so a state dict in
that layout loads as is.

Every BatchNorm uses eps 1e-3 and momentum 0.03, as in the JAX package (the
fork's ``initialize_weights`` sets those on its BatchNorm2d layers), and in
train mode updates its running variance with the biased batch variance, as
the JAX package does (``BatchNorm2d``, ``BatchNorm3d`` below).

Compute dtype (``dtype``, bf16 under ``amp``): parameters and BatchNorm
buffers stay f32, and the JAX package's cast points are kept, with explicit
casts rather than ``torch.autocast`` (whose op lists cast elsewhere): every
convolution casts its input, weight and bias to the compute dtype (flax's
``nn.Conv(dtype=...)``); BatchNorm in train mode normalises in f32 with f32
statistics and casts back, in eval mode it folds scale and shift in f32,
rounds them to the input's dtype and applies them there (``nn/norm.py``);
activations run in the compute dtype; LDConv takes its offsets in f32 and
its gather in f32 from the widened source, rounded once to the compute dtype
before the (N, 1) projection (``nn/modules.py:780-805``). A model's modules
take the dtype from :attr:`DetectionModel.dtype` (``nn/tasks.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from experiment_yolo_torch.ops.kernels.ldconv_gather import ldconv_gather

BN_EPS, BN_MOMENTUM = 1e-3, 0.03


def cast_conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d`` or ``nn.Conv3d``) with its input, weight and
    bias in ``dtype``, as flax's ``nn.Conv(dtype=...)`` computes; the f32
    parameters stay as they are."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return conv._conv_forward(x.to(dtype), conv.weight.to(dtype), bias)


class _BiasedRunningVar:
    """Train mode of the JAX package's BatchNorm (``nn/norm.py:72-78,155``):
    normalise with the batch's biased statistics, as PyTorch does, but move
    ``running_var`` towards the *biased* batch variance, where PyTorch's own
    update uses the unbiased one. Eval mode is PyTorch's.

    An input of another dtype (bf16) is normalised as the JAX package does:
    in train mode in f32, cast back to the input's dtype; in eval mode with
    scale and shift folded in f32 and applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            if self.training:
                return self.forward(x.float()).to(x.dtype)
            r = torch.rsqrt(self.running_var + self.eps)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            g = (self.weight * r).to(x.dtype).view(shape)
            b = (self.bias - self.running_mean * self.weight * r).to(x.dtype).view(shape)
            return x * g + b
        if not self.training:
            return super().forward(x)
        # F.batch_norm moves a copy by momentum * (unbiased variance) and keeps it
        # for the backward; scale that move by (n-1)/n to the biased one (C
        # elements: no second pass over x)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            torch.lerp((1.0 - self.momentum) * self.running_var, var, (n - 1) / n, out=self.running_var)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_BiasedRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the JAX package's biased running-variance update."""


class BatchNorm3d(_BiasedRunningVar, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with the JAX package's biased running-variance update."""


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU; 'same' padding k // 2."""

    dtype = torch.float32  # the compute dtype

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(cast_conv(self.conv, x, self.dtype)))


class Bottleneck(nn.Module):
    """Two 3x3 Convs with an optional residual add."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 3)
        self.cv2 = Conv(c_, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """cv1 -> split in two -> n bottlenecks chained on the tail -> concat all -> cv2."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, e=1.0) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    """cv1 -> three chained k x k max pools (stride 1, 'same') -> concat -> cv2."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * 4, c2, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(self.m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class Concat(nn.Module):
    """Channel concat of a list of maps."""

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, 1)


class Add(nn.Module):
    """Elementwise sum of a list of maps (DEAL's ASF fusion)."""

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class ZoomCat(nn.Module):
    """Scale-zoomed concat of (large, mid, small) levels (the fork's
    ``Zoom_cat``): the large level max- plus average-pooled over exact 2x2
    windows to the middle one's size, the small level upsampled (nearest) to
    it, then all three concatenated on channels. No parameters; it computes
    in its inputs' dtype."""

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        large, mid, small = xs
        h, w = mid.shape[2:]
        if tuple(large.shape[2:]) != (2 * h, 2 * w):
            raise ValueError(f"Zoom_cat: the large level is {tuple(large.shape[2:])}, expected twice the middle "
                             f"level's {(h, w)}")
        if h % small.shape[2] or w % small.shape[3]:
            raise ValueError(f"Zoom_cat: the small level {tuple(small.shape[2:])} does not divide the middle "
                             f"level's {(h, w)}")
        pooled = self.window_max(large) + F.avg_pool2d(large, 2)
        return torch.cat([pooled, mid, F.interpolate(small, size=(h, w), mode="nearest")], 1)

    @staticmethod
    def window_max(x: torch.Tensor) -> torch.Tensor:
        """The max over each 2x2 window of (B, C, 2h, 2w)."""
        return F.max_pool2d(x, 2)


class ScalSeq(nn.Module):
    """Scale-sequence fusion: three pyramid levels projected to c2, upsampled
    to the finest, stacked on a scale axis, Conv3d 1x1x1 + BatchNorm3d over
    (B, scale, H, W) + LeakyReLU 0.1, then max over the scale axis."""

    dtype = torch.float32  # the compute dtype of conv3d

    def __init__(self, inc: Sequence[int], c2: int):
        super().__init__()
        if inc[0] != c2:
            self.conv0 = Conv(inc[0], c2, 1)
        self.conv1 = Conv(inc[1], c2, 1)
        self.conv2 = Conv(inc[2], c2, 1)
        self.conv3d = nn.Conv3d(c2, c2, 1)
        self.bn = BatchNorm3d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        p3, p4, p5 = xs
        if hasattr(self, "conv0"):
            p3 = self.conv0(p3)
        size = p3.shape[2:]  # the pyramid's levels differ by integer factors
        p4 = F.interpolate(self.conv1(p4), size=size, mode="nearest")
        p5 = F.interpolate(self.conv2(p5), size=size, mode="nearest")
        y = self.bn(cast_conv(self.conv3d, torch.stack([p3, p4, p5], 2), self.dtype))  # (B, C, 3, H, W)
        return self.scale_max(self.act(y))

    @staticmethod
    def act(y: torch.Tensor) -> torch.Tensor:
        """LeakyReLU 0.1."""
        return F.leaky_relu(y, 0.1)

    @staticmethod
    def scale_max(z: torch.Tensor) -> torch.Tensor:
        """The max over the scale axis (2) of (B, C, 3, H, W)."""
        return z.amax(2)


class LDConv(nn.Module):
    """Linear deformable convolution: a 3x3 offset conv ``p_conv`` predicts 2N
    offsets per output pixel (the first N rows, the last N columns); kernel K3
    samples the input bilinearly at the N deformed points; the (N, 1) conv
    ``conv.0`` is one matmul over the N*C samples; then BatchNorm and SiLU.

    The reference fork's quirks carried by the JAX package are kept: the border
    double count lives in the gather, ``p_conv`` starts with a zero weight and a
    uniform(+-1/sqrt(fan_in)) bias (:func:`init_weights`, :meth:`seeded_init`).

    In bf16, as the JAX LDConv: ``p_conv`` runs in bf16 and its offsets go to
    f32, positions and bilinear weights stay f32, K3 widens the bf16 source,
    sums in f32 and rounds once to bf16, and the projection is a bf16 matmul.
    """

    dtype = torch.float32  # the compute dtype

    def __init__(self, c1: int, c2: int, num_param: int = 3, stride: int = 1):
        super().__init__()
        self.num_param, self.stride = num_param, stride
        self.conv = nn.Sequential(
            nn.Conv2d(c1, c2, (num_param, 1), (num_param, 1), bias=False),
            BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.SiLU(),
        )
        self.p_conv = nn.Conv2d(c1, 2 * num_param, 3, stride, 1)

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """The reference zero-inits only ``p_conv``'s weight; its bias keeps its draw."""
        self.p_conv.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        off = cast_conv(self.p_conv, x, dt).float()  # (B, 2N, h, w)
        b, _, h, w = off.shape
        feat = ldconv_gather(x.to(dt).contiguous(), off.contiguous(), self.stride)  # (B, h*w, N*C) n-major
        weight = self.conv[0].weight  # (O, C, N, 1) -> (O, N*C), n-major like feat
        proj = weight[..., 0].transpose(1, 2).reshape(weight.shape[0], -1).to(dt)
        y = torch.matmul(proj, feat.transpose(1, 2)).reshape(b, -1, h, w)
        return self.conv[2](self.conv[1](y))


class Detect(nn.Module):
    """Decoupled anchor-free head: per level a box branch (cv2 -> 4*reg_max) and
    a class branch (cv3 -> nc); returns the raw maps (B, 4*reg_max + nc, H, W)."""

    dtype = torch.float32  # the compute dtype of the last 1x1 convs; the maps come out in it

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        self.no = nc + 4 * reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(c, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1)) for c in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(c, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1)) for c in ch)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        def branch(seq, x):
            return cast_conv(seq[2], seq[1](seq[0](x)), self.dtype)

        return [torch.cat([branch(box, x), branch(cls, x)], 1) for x, box, cls in zip(xs, self.cv2, self.cv3)]


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: every conv and linear weight and bias from
    uniform(+-1/sqrt(fan_in)) (PyTorch's own default), BatchNorm and LayerNorm
    at identity; then each module's own ``seeded_init(generator)`` where it
    has one (LDConv's zero offset weight, SS2D's scan parameters)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            bound = 1.0 / (m.weight[0].numel() ** 0.5)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            m.reset_parameters()
    for m in model.modules():
        if hasattr(m, "seeded_init"):
            m.seeded_init(generator)
