"""Seeded inputs and weights for runs on the card without a dataset or a
checkpoint: ``chip_smoke.py`` and ``profile_predict``."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from experiment_yolo_torch.nn.modules import LDConv

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
    on random offsets.
    """
    gen = torch.Generator().manual_seed(seed)
    offset_convs = {id(m.p_conv) for m in model.modules() if isinstance(m, LDConv)}
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) and id(m) not in offset_convs:
            std = math.sqrt(2.0 / m.weight[0].numel())
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
    for cls in model.model[-1].cv3:
        cls[-1].bias.zero_()
