"""Seeded inputs, labelled batches and weights for runs on the card without a
dataset or a checkpoint, and offsets that stress the LDConv gather's
backward: ``chip_smoke.py``, ``profile_predict``, ``profile_train`` and
``kernel_variants``. Test scaffolding, not a dataset."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from experiment_yolo_torch.nn.modules import LDConv
from experiment_yolo_torch.ops.kernels.ldconv_gather import grid_points

# mixed (h, w) so that letterbox both resizes and pads
MIXED_SIZES: Tuple[Tuple[int, int], ...] = ((640, 640), (480, 640), (720, 1280), (375, 500), (1080, 810),
                                            (512, 512), (427, 640), (640, 427))


def seeded_images(n: int, seed: int) -> List[np.ndarray]:
    """``n`` uint8 BGR images, cycling through ``MIXED_SIZES``: 32-px blocks
    of colour plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = MIXED_SIZES[i % len(MIXED_SIZES)]
        base = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
        img = np.repeat(np.repeat(base, 32, 0), 32, 1)[:h, :w].astype(np.int16)
        out.append(np.clip(img + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


# one fill colour per class (BGR order does not matter: the step takes pixels as given)
CLASS_COLOURS = ((230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200), (245, 130, 48), (145, 30, 180),
                 (70, 240, 240), (240, 50, 230))


def seeded_batch(batch: int, imgsz: int, seed: int, nc: int = 6, max_boxes: int = 16) -> Dict[str, np.ndarray]:
    """A labelled batch in the training step's format: ``img`` (B, imgsz,
    imgsz, 3) uint8 of dark noise with 2 to ``max_boxes`` filled rectangles
    per image in their class's colour, 8 to 128 px on a side (at most half the
    image), so that the stride-4 level gets objects too; ``bboxes`` (B, M, 4)
    normalised xywh, ``cls`` (B, M) int32 and ``mask`` (B, M) bool, padded to
    M = ``max_boxes``."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 48, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    bboxes = np.zeros((batch, max_boxes, 4), np.float32)
    cls = np.zeros((batch, max_boxes), np.int32)
    mask = np.zeros((batch, max_boxes), bool)
    side = (8, max(9, min(128, imgsz // 2)))
    for i in range(batch):
        for j in range(int(rng.integers(2, max_boxes + 1))):
            w, h = (int(v) for v in rng.integers(side[0], side[1] + 1, 2))
            x0, y0 = int(rng.integers(0, imgsz - w + 1)), int(rng.integers(0, imgsz - h + 1))
            c = int(rng.integers(0, nc))
            img[i, y0:y0 + h, x0:x0 + w] = CLASS_COLOURS[c % len(CLASS_COLOURS)]
            bboxes[i, j] = ((x0 + w / 2) / imgsz, (y0 + h / 2) / imgsz, w / imgsz, h / imgsz)
            cls[i, j], mask[i, j] = c, True
    return {"img": img, "bboxes": bboxes, "cls": cls, "mask": mask}


@torch.no_grad()
def he_normal_(model: torch.nn.Module, seed: int) -> None:
    """Redraw every conv weight He-normal (std sqrt(2 / fan_in)) from a seeded
    generator and set the Detect class-bias priors to 0.

    With PyTorch's default init the activations of the 27 layers shrink
    towards zero: every LD-P2 score then sits at 0.5009 within 1e-4, and NMS
    only breaks near-ties. He-normal weights keep the activations' scale, as
    a trained network's are, so scores and boxes spread and NMS does real
    work. LDConv's offset conv keeps its zero weight and uniform bias (the
    reference's init), so its offsets are one value per channel, the same at
    every pixel: ``chip_smoke.py`` also holds kernel K3 to its plain version
    on random offsets. In a VSS model SS2D's depthwise conv is redrawn like
    any conv; its linear layers and scan parameters keep their own init, whose
    step sizes sit near 0.01, so K4 is held on random inputs too.
    """
    gen = torch.Generator().manual_seed(seed)
    offset_convs = {id(m.p_conv) for m in model.modules() if isinstance(m, LDConv)}
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) and id(m) not in offset_convs:
            std = math.sqrt(2.0 / m.weight[0].numel())
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
    for cls in model.model[-1].cv3:
        cls[-1].bias.zero_()


def _offsets_to(off: torch.Tensor, stride: int, tr: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """The offsets (B, 2N, h, w) that put each sample of an LDConv with
    offsets shaped like ``off`` at the source position (``tr``, ``tc``), both
    (B, N, h, w): a sample's position is its grid position plus its offset."""
    b, n2, h, w = off.shape
    n = n2 // 2
    pts = torch.tensor(grid_points(n), dtype=torch.float32)  # (N, 2)
    rows = (torch.arange(h, dtype=torch.float32) * stride)[:, None].expand(h, w)
    cols = (torch.arange(w, dtype=torch.float32) * stride)[None, :].expand(h, w)
    return torch.cat([tr - rows - pts[:, 0].reshape(1, n, 1, 1), tc - cols - pts[:, 1].reshape(1, n, 1, 1)], 1)


def contention_offsets(x: torch.Tensor, off: torch.Tensor, stride: int, gen: torch.Generator,
                       share: float = 0.9) -> torch.Tensor:
    """Offsets (like ``off``) that put a ``share`` of the samples at one of
    sixteen source positions, a quarter of a pixel past the points of a 4 x 4
    grid at (H (2k + 1) / 8, W (2l + 1) / 8), so that their bilinear corners
    and their adds in the backward land on the same 64 source pixels; the rest
    keep ``off``."""
    b, n2, h, w = off.shape
    n, (hx, wx) = n2 // 2, x.shape[2:]
    pick = torch.randint(0, 16, (b, n, h, w), generator=gen)
    tr = (hx * (2 * (pick // 4) + 1) // 8).float() + 0.25
    tc = (wx * (2 * (pick % 4) + 1) // 8).float() + 0.25
    pulled = torch.rand((b, n, h, w), generator=gen) < share
    cont = _offsets_to(off, stride, tr, tc)
    return torch.where(torch.cat([pulled, pulled], 1), cont, off.cpu()).to(off.device)


def seam_offsets(x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
    """Offsets (like ``off``) that put every sample a quarter of a pixel
    past source row H / 2 and column (j + 1) mod w, j its output column. The
    cells of neighbouring output pixels then follow each other also from the
    last pixel of one image or sampling point to the first of the next: where
    h * w is no multiple of 32, one warp of the backward holds both, and must
    not merge their adds unless they go into the same channel plane."""
    b, n2, h, w = off.shape
    n = n2 // 2
    tr = torch.full((b, n, h, w), float(x.shape[2] // 2) + 0.25)
    tc = ((torch.arange(w) + 1) % w).float().expand(b, n, h, w) + 0.25
    return _offsets_to(off, stride, tr, tc).to(off.device)
