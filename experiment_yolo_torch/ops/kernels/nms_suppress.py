"""Kernel K2: greedy hard-NMS suppression, and its plain PyTorch version.

Replaces ``experiment_yolo_tpu/ops/pallas/nms_kernel.py:_nms_suppress_kernel``
(reached through ``nms_suppress``). The kernel, ``csrc/nms_suppress.cu``, is
the bitmask form of greedy NMS: a pass over the whole card writes, for every
pair (i, j > i), one bit that says whether i would suppress j; one warp per
image then walks the candidates in score order with the suppressed bits in
registers. A chain of dependent decisions bounds it, not bytes or
arithmetic; the source says how the design keeps each decision short.

:func:`nms_suppress` launches the kernel for CUDA tensors (two launches, one
count) and takes :func:`nms_suppress_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from experiment_yolo_torch.ops.boxes import box_iou
from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_float)
MAX_K = 8192  # 128 64-bit words of one row: at most four per lane of the chain's warp


def nms_suppress_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, K) bool for score-sorted, class-offset xyxy boxes (B, K, 4)
    and candidate mask ``valid`` (B, K): box i suppresses every later j with
    IoU > ``iou_thres`` while i is itself kept (the JAX package's
    ``nms_suppress_reference``, batched)."""
    k = boxes.shape[1]
    iou = box_iou(boxes, boxes)  # (B, K, K)
    later = torch.arange(k, device=boxes.device)
    keep = valid.clone()
    for i in range(k):
        keep &= ~((iou[:, i] > iou_thres) & keep[:, i:i + 1] & (later > i))
    return keep


def nms_suppress(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """:func:`nms_suppress_plain` through kernel K2 for CUDA tensors."""
    if boxes.device.type == "cpu":
        return nms_suppress_plain(boxes, valid, iou_thres)
    _build.validate(boxes, "nms_suppress boxes", torch.float32, 3)
    _build.validate(valid, "nms_suppress valid", torch.bool, 2)
    b, k, four = boxes.shape
    if four != 4 or tuple(valid.shape) != (b, k):
        raise ValueError(f"nms_suppress: boxes {tuple(boxes.shape)} and valid {tuple(valid.shape)} "
                         "must be (B, K, 4) and (B, K)")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_suppress: boxes must be 16-byte aligned (the kernel loads one float4 per box)")
    if k > MAX_K:
        raise ValueError(f"nms_suppress: K={k} candidates exceed the kernel's {MAX_K}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b and k:
        # the pair pass's bit per (i, j > i): row i's 64-bit words from its own word on (the rest is never read)
        mask = torch.empty((b, k, (k + 63) // 64), dtype=torch.int64, device=boxes.device)
        _build.launch("nms_suppress", _ARGS, boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(),
                      b, k, float(iou_thres), device=boxes.device)
        nms_suppress.launches += 1
    return keep


nms_suppress.launches = 0
