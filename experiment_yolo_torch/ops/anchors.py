"""Anchor-free grid machinery and the Detect decode, on NCHW head maps.

Port of ``experiment_yolo_tpu/ops/anchors.py`` (``make_anchors``,
``dist2bbox``, ``bbox2dist``, ``decode_detections``); the DFL decode itself is kernel K1,
with its plain version, in ``ops/kernels/dfl_decode.py``. Anchors are in
(x, y) = (col, row) order in grid units, row-major over each level, as in the
JAX package, so anchor ``a`` of a level is pixel ``a`` of its flattened map.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 grid_cell_offset: float = 0.5, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (A, 2) in grid units and per-anchor strides (A, 1), f32."""
    points, stride_t = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        stride_t.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points), torch.cat(stride_t)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances (..., A, 4) around anchor points -> boxes."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from the anchor points, clamped to
    [0, reg_max - 0.01] (the DFL targets)."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:4]
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def decode_detections(feats: List[torch.Tensor], strides: Sequence[int], nc: int,
                      reg_max: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw Detect maps [(B, 4*reg_max + nc, H_i, W_i)] -> boxes (B, A, 4) xywh in
    input pixels and sigmoid scores (B, A, nc).

    Decodes per level, as the JAX package does: the box channels of each map
    go straight to the DFL kernel, and the levels meet only as (B, A_i, 4) boxes.
    """
    b = feats[0].shape[0]
    shapes = [tuple(f.shape[2:4]) for f in feats]
    anchor_points, stride_t = make_anchors(shapes, strides, 0.5, device=feats[0].device)
    boxes, cls = [], []
    start = 0
    for f, (h, w) in zip(feats, shapes):
        a = h * w
        dist = dfl_decode(f, reg_max)  # (B, a, 4)
        ap, st = anchor_points[start:start + a], stride_t[start:start + a]
        boxes.append(dist2bbox(dist, ap[None], xywh=True) * st[None])
        cls.append(f[:, 4 * reg_max:].reshape(b, nc, a).transpose(1, 2))
        start += a
    return torch.cat(boxes, 1), torch.sigmoid(torch.cat(cls, 1))
