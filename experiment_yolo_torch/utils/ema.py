"""Exponential moving average of a model's parameters and BatchNorm statistics.

Port of ``experiment_yolo_tpu/utils/ema.py:15-22`` (``ema_decay``,
``ema_update``): the decay ramps as ``decay * (1 - exp(-updates / tau))`` so
early updates move fast, and the average covers the parameters and the float
buffers (the BatchNorm running mean and variance), as the reference's
``ModelEMA`` does.
"""

from __future__ import annotations

import copy
import math
from typing import List

import torch
from torch import nn


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    return decay * (1.0 - math.exp(-updates / tau))


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], new: List[torch.Tensor], updates: int, decay: float = 0.9999,
               tau: float = 2000.0) -> None:
    """In place: ema <- d*ema + (1-d)*new, with the ramped decay d."""
    d = ema_decay(updates, decay, tau)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, new, alpha=1.0 - d)


class ModelEMA:
    """A copy of ``model`` in eval mode that follows it by :func:`ema_update`."""

    def __init__(self, model: nn.Module, decay: float = 0.9999, tau: float = 2000.0):
        self.ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.decay, self.tau = decay, tau
        self.updates = 0

    @staticmethod
    def tracked(model: nn.Module) -> List[torch.Tensor]:
        """The tensors the average covers: parameters, then float buffers."""
        return [*model.parameters(), *(b for b in model.buffers() if b.is_floating_point())]

    def update(self, model: nn.Module) -> None:
        self.updates += 1
        ema_update(self.tracked(self.ema), [t.detach() for t in self.tracked(model)], self.updates, self.decay,
                   self.tau)
