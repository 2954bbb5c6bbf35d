"""The Mamba/VSS family of the module zoo: ``SS2D``, ``VSSBlock`` and the
generic CSP containers ``C2fX`` / ``C3X`` that hold them.

Port of the forward math of ``experiment_yolo_tpu/nn/zoo_blocks.py`` for the
inner blocks ``VSS`` (a bottleneck whose second conv is a ``VSSBlock``) and
``LVMB`` (a bare ``VSSBlock``); any other inner block of the zoo raises
``NotImplementedError`` by name. The maps between modules are NCHW, as
everywhere in this package; ``SS2D`` itself takes (B, H, W, C), as the JAX
module and VMamba's do.

Module names follow the Ultralytics state dict: ``cv1``, ``cv2``, (``cv3``),
``m.{k}``; inside ``m.{k}``, ``cv1`` and ``cv2.ln_1`` /
``cv2.self_attention.*`` for VSS, ``ln_1`` / ``self_attention.*`` for LVMB.
SS2D's five raw parameters keep the JAX package's shapes, with the direction
axis first: ``x_proj_weight`` (4, dt_rank + 2N, d_inner), ``dt_projs_weight``
(4, d_inner, dt_rank), ``dt_projs_bias`` (4, d_inner), ``A_logs``
(4, d_inner, N), ``Ds`` (4, d_inner).

Both LayerNorms use eps 1e-6, as the JAX package does (flax's default for
``out_norm``, explicit for ``ln_1``); ``torch.nn.LayerNorm`` defaults to 1e-5.

Compute dtype (``dtype``, bf16 under ``amp``, set by
:attr:`~experiment_yolo_torch.nn.tasks.DetectionModel.dtype`): as in the JAX
package's ``SS2D`` (``zoo_blocks.py:1016-1046``), ``in_proj``, the depthwise
``conv2d``, ``out_norm``, the gate and ``out_proj`` compute in it with their
f32 parameters cast at each forward, and the two LayerNorms take their
statistics in f32 as flax's ``nn.LayerNorm(dtype=...)`` does, returning the
compute dtype; the sequences are widened to f32 for the ``x_proj`` and
``dt_proj`` products, the softplus, ``-exp(A_logs)`` and the scan (K4 and its
backward take f32 only), and ``y`` is cast back before ``out_norm``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from experiment_yolo_torch.nn.modules import Conv, cast_conv
from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan

LN_EPS = 1e-6
# SS2D's four scans: row-major, column-major, and each of the two from its end
REVERSED = (False, False, True, True)
SOURCE = (0, 1, 0, 1)  # the sequence each direction reads


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``ln`` with its statistics and its affine step in f32, returned in
    ``dtype``: flax's ``nn.LayerNorm(dtype=...)``, which widens a bf16 input
    and rounds its result once."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class SS2D(nn.Module):
    """2-D selective scan over a (B, H, W, C) map: ``in_proj`` -> split into
    ``x`` and the gate ``z`` -> depthwise 3x3 conv + SiLU -> four sequences
    (row-major, column-major, and each from its end) -> per direction the
    projections to ``dt``, ``B``, ``C`` and kernel K4, one call for the four,
    which walks the reversed directions backwards in place -> un-transpose
    and sum -> LayerNorm -> ``* silu(z)`` -> ``out_proj``."""

    dtype = torch.float32  # the compute dtype around the scan; the scan itself runs in f32

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3, expand: int = 2):
        super().__init__()
        self.d_inner, self.d_state = expand * d_model, d_state
        self.dt_rank = math.ceil(d_model / 16)
        d, n, r = self.d_inner, d_state, self.dt_rank
        self.in_proj = nn.Linear(d_model, 2 * d, bias=False)
        self.conv2d = nn.Conv2d(d, d, d_conv, padding=(d_conv - 1) // 2, groups=d, bias=True)
        self.x_proj_weight = nn.Parameter(torch.empty(4, r + 2 * n, d))
        self.dt_projs_weight = nn.Parameter(torch.empty(4, d, r))
        self.dt_projs_bias = nn.Parameter(torch.empty(4, d))
        self.A_logs = nn.Parameter(torch.empty(4, d, n))
        self.Ds = nn.Parameter(torch.empty(4, d))
        self.out_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.out_proj = nn.Linear(d, d_model, bias=False)
        self.seeded_init(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """The JAX module's own init: ``A_logs = log(1..N)`` for every channel
        and direction, ``dt_projs_bias = softplus^-1(0.01)``, ``Ds = 1``, and
        the two projection stacks normal with std 1/sqrt(fan_in), so that a
        seeded model's decays lie where a trained model's do."""
        self.A_logs.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32)).expand_as(self.A_logs))
        self.dt_projs_bias.fill_(math.log(math.expm1(0.01)))
        self.Ds.fill_(1.0)
        for w in (self.x_proj_weight, self.dt_projs_weight):
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[-1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bsz, h, w, _ = x.shape
        d, n, r, dtype = self.d_inner, self.d_state, self.dt_rank, self.dtype
        xc, z = F.linear(x.to(dtype), self.in_proj.weight.to(dtype)).chunk(2, -1)
        xc = F.silu(cast_conv(self.conv2d, xc.permute(0, 3, 1, 2), dtype))  # (B, d, H, W)
        row = xc.permute(0, 2, 3, 1).reshape(bsz, h * w, d)
        col = xc.permute(0, 3, 2, 1).reshape(bsz, h * w, d)
        xs = torch.stack([row, col], 1).float()  # (B, 2, L, d): the row-major and the column-major sequence
        # Directions 2 and 3 scan the same two sequences from their ends. The projections are pointwise over
        # L, so all four run on the unreversed sequences, each with its own weights; K4 walks 2 and 3
        # backwards, reads their x from 0 and 1, and returns every y in the order of its sequence.
        w_x = self.x_proj_weight.view(2, 2, r + 2 * n, d).transpose(2, 3)  # [reversed?, row or column]
        dbl = torch.matmul(xs[:, None], w_x).view(bsz, 4, h * w, r + 2 * n)
        dt, bs, cs = dbl.split([r, n, n], -1)  # B and C stay views: K4 takes their strides
        dt = F.softplus(torch.matmul(dt, self.dt_projs_weight.transpose(1, 2)) + self.dt_projs_bias[:, None])
        ys = selective_scan(xs, dt, -torch.exp(self.A_logs), bs, cs, self.Ds, reverse=REVERSED, source=SOURCE)
        y = ys[:, 0] + ys[:, 2]
        ycol = ys[:, 1] + ys[:, 3]
        y = y + ycol.reshape(bsz, w, h, d).transpose(1, 2).reshape(bsz, h * w, d)
        y = layer_norm(self.out_norm, y.reshape(bsz, h, w, d).to(dtype), dtype) * F.silu(z)
        return F.linear(y, self.out_proj.weight.to(dtype))


class VSSBlock(nn.Module):
    """LayerNorm over channels -> SS2D -> residual, on an NCHW map, in the
    compute dtype ``dtype`` (its SS2D takes the same)."""

    dtype = torch.float32

    def __init__(self, c: int, d_state: int = 16):
        super().__init__()
        self.ln_1 = nn.LayerNorm(c, eps=LN_EPS)
        self.self_attention = SS2D(c, d_state=d_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 2, 3, 1).to(self.dtype)
        return (y + self.self_attention(layer_norm(self.ln_1, y, self.dtype))).permute(0, 3, 1, 2)


class VSSBottleneck(nn.Module):
    """Bottleneck whose second conv is a VSSBlock (the JAX package's
    ``_SwapBottleneck`` with the ``VSS`` unit): ``cv1`` Conv of kernel ``k0``,
    ``cv2`` VSSBlock, and the residual when ``shortcut`` holds."""

    def __init__(self, c: int, k0: int = 3, shortcut: bool = True):
        super().__init__()
        self.cv1 = Conv(c, c, k0)
        self.cv2 = VSSBlock(c)
        self.add = shortcut  # input and output channels are both c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


# inner block per chain slot: a constructor taking (c, shortcut, k0). k0 is the bottleneck's
# cv1 kernel: 3 inside C2f_<X>, 1 inside C3_<X>.
INNER_BLOCKS: Dict[str, Callable[[int, bool, int], nn.Module]] = {
    "VSS": lambda c, shortcut, k0: VSSBottleneck(c, k0, shortcut),
    "LVMB": lambda c, shortcut, k0: VSSBlock(c),
}


def inner_block(inner: str, c: int, shortcut: bool, k0: int) -> nn.Module:
    if inner not in INNER_BLOCKS:
        raise NotImplementedError(f"zoo inner block {inner!r} is not ported to experiment_yolo_torch; "
                                  f"the port covers {', '.join(INNER_BLOCKS)}")
    return INNER_BLOCKS[inner](c, shortcut, k0)


class C2fX(nn.Module):
    """C2f with a zoo inner block (``C2f_<X>``): cv1 -> split in two -> n
    inner blocks chained on the tail -> concat all -> cv2."""

    def __init__(self, c1: int, c2: int, inner: str, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(inner_block(inner, self.c, shortcut, 3) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3X(nn.Module):
    """C3 with a zoo inner block (``C3_<X>``): cv1 -> n inner blocks in a
    chain, beside cv2 on the same input; concat -> cv3."""

    def __init__(self, c1: int, c2: int, inner: str, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(inner_block(inner, c_, shortcut, 1) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))
