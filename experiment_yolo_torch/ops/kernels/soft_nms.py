"""Kernel K5: Gaussian soft-NMS, and its plain PyTorch version.

Replaces ``experiment_yolo_tpu/ops/nms.py:_soft_nms_keep``, a ``lax.fori_loop``
in JAX (not a Pallas kernel). The kernel, ``csrc/soft_nms.cu``, runs one
block per image: it drops the candidates at or below the 0.25 floor at load,
holds the others in registers, and makes each step one decay pass (an exact
fma pre-test before any division) fused with the next pick's reduction, one
barrier a step. A chain of dependent steps bounds it, not bytes or
arithmetic; an image leaves its loop at the first step that does not keep,
and the source says why that and the floor give the plain loop's result.

:func:`soft_nms` launches the kernel for CUDA tensors (one launch per call for
the whole batch) and takes :func:`soft_nms_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from experiment_yolo_torch.ops.boxes import box_iou
from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float)
MAX_K = 8192  # 24 bytes a candidate in shared memory: 192 KB of the 227 KB a block can have
_SIGMA = 0.5  # the Gaussian decay exp(-iou^2 / sigma)
_SOFT_SCORE_THRESHOLD = 0.25  # a step keeps while the best live score exceeds this, whatever conf is
_EARLY_EXIT_EVERY = 16  # plain version: steps between checks that any image still keeps boxes


def soft_nms_plain(shifted: torch.Tensor, cand_scores: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                   max_det: int, first_idx: Optional[torch.Tensor] = None,
                   n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian soft-NMS over (B, K) score-sorted candidates -> per-candidate
    output scores (decayed; -1 where not kept).

    Each step takes the best live box, decays by exp(-iou^2 / sigma) every live
    score whose IoU with it exceeds ``iou_thres``, and stops keeping once the
    best live score falls to 0.25 (the fork's threshold, whatever ``conf``
    is). With ``first_idx``/``n_valid`` set it reproduces the fork's
    quirks: the first box kept is the first in anchor order, and a step keeps
    only while at least two boxes survive, so the last lone survivor is dropped.
    Once no image keeps a box, no later step can: the loop then ends early.
    """
    b, k = cand_scores.shape
    rows = torch.arange(b, device=cand_scores.device)
    live = torch.where(valid, cand_scores, torch.full_like(cand_scores, -1.0))
    out = torch.full_like(cand_scores, -1.0)
    for t in range(min(max_det, k)):
        if first_idx is not None:
            i = first_idx if t == 0 else live.argmax(-1)
            m = n_valid if t == 0 else (live > _SOFT_SCORE_THRESHOLD).sum(-1)
            cond = m >= 2
        else:
            i = live.argmax(-1)
            cond = live[rows, i] > _SOFT_SCORE_THRESHOLD
        si = live[rows, i]
        iou = box_iou(shifted[rows, i][:, None], shifted)[:, 0]  # (B, K)
        decay = torch.where(iou > iou_thres, torch.exp(-(iou ** 2) / _SIGMA), torch.ones_like(iou))
        live = torch.where(cond[:, None], live * decay, live)
        live[rows, i] = -1.0
        out[rows, i] = torch.where(cond, si, out[rows, i])
        if t % _EARLY_EXIT_EVERY == _EARLY_EXIT_EVERY - 1 and not bool(cond.any()):
            break
    return out


def soft_nms(shifted: torch.Tensor, cand_scores: torch.Tensor, valid: torch.Tensor, iou_thres: float,
             max_det: int, first_idx: Optional[torch.Tensor] = None,
             n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`soft_nms_plain` through kernel K5 for CUDA tensors: class-offset
    xyxy boxes (B, K, 4) f32, scores (B, K) f32, the conf gate (B, K) bool
    and, for the quirk, ``first_idx`` and ``n_valid`` (B,) int64, both or
    neither."""
    if (first_idx is None) != (n_valid is None):
        raise ValueError("soft_nms: first_idx and n_valid come together (the quirk) or not at all")
    if shifted.device.type == "cpu":
        return soft_nms_plain(shifted, cand_scores, valid, iou_thres, max_det, first_idx, n_valid)
    _build.validate(shifted, "soft_nms boxes", torch.float32, 3)
    _build.validate(cand_scores, "soft_nms scores", torch.float32, 2)
    _build.validate(valid, "soft_nms valid", torch.bool, 2)
    b, k, four = shifted.shape
    if four != 4 or tuple(cand_scores.shape) != (b, k) or tuple(valid.shape) != (b, k):
        raise ValueError(f"soft_nms: boxes {tuple(shifted.shape)}, scores {tuple(cand_scores.shape)} and valid "
                         f"{tuple(valid.shape)} must be (B, K, 4), (B, K) and (B, K)")
    if first_idx is not None:
        for t, what in ((first_idx, "first_idx"), (n_valid, "n_valid")):
            _build.validate(t, f"soft_nms {what}", torch.int64, 1)
            if t.shape[0] != b:
                raise ValueError(f"soft_nms: {what} has {t.shape[0]} entries for {b} images")
    if shifted.data_ptr() % 16:
        raise ValueError("soft_nms: boxes must be 16-byte aligned (the kernel loads one float4 per box)")
    if k > MAX_K:
        raise ValueError(f"soft_nms: K={k} candidates exceed the kernel's {MAX_K}")
    out = torch.empty((b, k), dtype=torch.float32, device=shifted.device)
    if b and k:
        quirk = (first_idx.data_ptr(), n_valid.data_ptr()) if first_idx is not None else (None, None)
        _build.launch("soft_nms", _ARGS, shifted.data_ptr(), cand_scores.data_ptr(), valid.data_ptr(), *quirk,
                      out.data_ptr(), b, k, max(min(int(max_det), k), 0), float(iou_thres), device=shifted.device)
        soft_nms.launches += 1
    return out


soft_nms.launches = 0
