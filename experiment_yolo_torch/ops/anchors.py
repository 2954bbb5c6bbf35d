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

from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_levels


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

    The box channels of every map go straight to the DFL kernel, which decodes
    all levels in one launch into the concatenated (B, A, 4) distances; the
    elementwise box arithmetic after it gives each level's boxes exactly as a
    decode per level, as the JAX package's, would.
    """
    b = feats[0].shape[0]
    shapes = [tuple(f.shape[2:4]) for f in feats]
    anchor_points, stride_t = make_anchors(shapes, strides, 0.5, device=feats[0].device)
    boxes = dist2bbox(dfl_decode_levels(feats, reg_max), anchor_points[None], xywh=True) * stride_t[None]
    cls = torch.cat([f[:, 4 * reg_max:].reshape(b, nc, h * w).transpose(1, 2) for f, (h, w) in zip(feats, shapes)], 1)
    return boxes, torch.sigmoid(cls)
