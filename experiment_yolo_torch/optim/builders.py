"""The optimizer with Ultralytics semantics: nesterov SGD over three parameter
groups, warmup schedules and the reference's ramped firing plan.

Port of ``experiment_yolo_tpu/optim/builders.py`` (``_torch_step_plan``,
``param_group_label``, ``lr_lambda``, ``warmup_schedules``, ``yolo_sgd`` and
``build_optimizer`` for SGD). Gradients accumulate as sums in ``.grad``, as
repeated ``backward()`` calls leave them; :meth:`YoloSGD.step` is called once
per micro-batch and fires when the firing plan says so: it clips the summed
gradient to a global norm, adds L2 weight decay to the weight group, and takes
a nesterov step with the group's warmup learning rate and momentum.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

GROUPS = ("weight", "norm", "bias")
CLIP_NORM = 10.0  # global-norm clip of the summed gradient, as the JAX package's


def _torch_step_plan(nb: int, epochs: int, warmup_epochs: float, k_full: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's optimizer firing plan (its trainer.py:783-815).

    During warmup (nw = max(round(warmup_epochs*nb), 100) batches) accumulate
    ramps 1 -> k_full; the optimizer fires at batch ni whenever
    ni - last_opt_step >= accumulate. Returns (k_table, ni_table): update u
    accumulated k_table[u] batches and sees the warmup LR and momentum of
    batch ni_table[u].
    """
    nw = max(round(warmup_epochs * nb), 100) if warmup_epochs > 0 else -1
    total = max(nb * epochs, 1)
    ks, nis, last, acc = [], [], -1, k_full
    for ni in range(total):
        if ni <= nw:
            acc = max(1, int(round(np.interp(ni, [0, nw], [1, k_full]))))
        if ni - last >= acc:
            ks.append(ni - last)
            nis.append(ni)
            last = ni
    if not ks:  # degenerate tiny runs: one update of everything
        ks, nis = [total], [total - 1]
    return np.asarray(ks, np.int32), np.asarray(nis, np.int32)


def param_group_label(name: str, module: nn.Module) -> str:
    """'bias' | 'norm' | 'weight' for parameter ``name`` of ``module``.

    As the reference (and the JAX package) test ``bias`` first, BatchNorm
    biases join the bias group; BatchNorm weights form the norm group; every
    other weight (convolutions, LDConv's ``conv.0`` and ``p_conv``, ScalSeq's
    ``conv3d``) is in the weight group, the only one with weight decay.
    """
    if name.rsplit(".", 1)[-1] == "bias":
        return "bias"
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return "norm"
    return "weight"


def param_groups(model: nn.Module) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
    """The model's named parameters by group label, in ``named_parameters`` order."""
    groups: Dict[str, List[Tuple[str, nn.Parameter]]] = {g: [] for g in GROUPS}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            groups[param_group_label(name, module)].append((name, p))
    return groups


def lr_lambda(epochs: int, lrf: float, cos_lr: bool) -> Callable[[float], float]:
    """Per-epoch LR factor (the reference's ``_setup_scheduler``)."""
    if cos_lr:
        return lambda e: ((1 - math.cos(e * math.pi / epochs)) / 2) * (lrf - 1) + 1
    return lambda e: max(1 - e / epochs, 0) * (1.0 - lrf) + lrf


def warmup_schedules(lr0: float, lf: Callable[[float], float], nb: int, warmup_epochs: float,
                     warmup_bias_lr: float, warmup_momentum: float, momentum: float):
    """Batch-indexed (lr, bias_lr, momentum) schedules: over the first
    nw = max(warmup_epochs*nb, 100) batches the LR ramps linearly from 0 (the
    bias group's from ``warmup_bias_lr``) to ``lr0 * lf(epoch)`` and the
    momentum from ``warmup_momentum`` to ``momentum``; ``warmup_epochs <= 0``
    turns warmup off, the 100-batch floor included."""
    nw = max(round(warmup_epochs * nb), 100) if warmup_epochs > 0 else 0
    if nw == 0:
        def flat(step: float) -> float:
            return lr0 * lf(math.floor(step / nb))

        return flat, flat, (lambda step: momentum)

    def lr_at(step: float, start: float) -> float:
        target = lr0 * lf(math.floor(step / nb))
        if step >= nw:
            return target
        return start + min(max(step / nw, 0.0), 1.0) * (target - start)

    def momentum_fn(step: float) -> float:
        if step >= nw:
            return momentum
        return warmup_momentum + min(max(step / nw, 0.0), 1.0) * (momentum - warmup_momentum)

    return (lambda step: lr_at(step, 0.0)), (lambda step: lr_at(step, warmup_bias_lr)), momentum_fn


class YoloSGD(torch.optim.Optimizer):
    """Torch-semantics nesterov SGD with the firing plan and global-norm clip.

    Per update: g = clip(sum of the accumulated gradients); g += wd*p on the
    weight group only; buf = mu*buf + g; p -= lr*(g + mu*buf), with the bias
    group's own warmup LR. ``k_table``/``ni_table`` (from
    :func:`_torch_step_plan`) say how many micro-batches each update
    accumulates and at which batch its schedules are read.
    """

    def __init__(self, groups: Dict[str, List[Tuple[str, nn.Parameter]]], lr_fn, bias_lr_fn, momentum_fn,
                 weight_decay: float, k_table: Sequence[int], ni_table: Sequence[int]):
        param_groups = [{"params": [p for _, p in groups[g]], "names": [n for n, _ in groups[g]], "label": g}
                        for g in GROUPS if groups[g]]
        super().__init__(param_groups, {})
        self.lr_fn, self.bias_lr_fn, self.momentum_fn = lr_fn, bias_lr_fn, momentum_fn
        self.weight_decay = weight_decay
        self.k_table, self.ni_table = [int(k) for k in k_table], [int(n) for n in ni_table]
        self.updates = 0  # updates fired
        self.mini_step = 0  # micro-batches accumulated towards the next update
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _table(self, table: List[int]) -> int:
        return table[min(self.updates, len(table) - 1)]

    def schedules(self) -> Tuple[float, float, float]:
        """(lr, bias lr, momentum) of the next update."""
        ni = self._table(self.ni_table)
        return self.lr_fn(ni), self.bias_lr_fn(ni), self.momentum_fn(ni)

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        """Count one micro-batch whose gradient sits in ``.grad``; fire the
        update when the plan says so. Returns whether it fired; the caller
        zeroes the gradients after an update fired."""
        if closure is not None:
            raise ValueError("YoloSGD.step takes no closure")
        self.mini_step += 1
        if self.mini_step < self._table(self.k_table):
            return False
        lr_w, lr_b, mu = self.schedules()
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.where(norm < CLIP_NORM, 1.0, CLIP_NORM / norm))
        for group in self.param_groups:
            ps = group["params"]
            g = [p.grad for p in ps]
            if group["label"] == "weight" and self.weight_decay:
                g = torch._foreach_add(g, ps, alpha=self.weight_decay)
            bufs = [self.state[p]["momentum_buffer"] for p in ps]
            torch._foreach_mul_(bufs, mu)
            torch._foreach_add_(bufs, g)
            d = torch._foreach_add(g, bufs, alpha=mu)  # nesterov
            torch._foreach_add_(ps, d, alpha=-(lr_b if group["label"] == "bias" else lr_w))
        self.updates += 1
        self.mini_step = 0
        return True


def build_optimizer(model: nn.Module, name: str, lr0: float, momentum: float, weight_decay: float, nb: int,
                    epochs: int, lrf: float, cos_lr: bool, warmup_epochs: float, warmup_bias_lr: float,
                    warmup_momentum: float, accumulate: int = 1) -> YoloSGD:
    """The optimizer of the JAX package's ``build_optimizer`` for SGD, and for
    ``auto`` where it resolves to SGD (``epochs >= 50``).

    Updates follow the reference's firing plan: during warmup the optimizer
    fires nearly every batch, accumulating ever more of them up to
    ``accumulate``, and each update sees the schedules of the batch it fires
    on (with ``accumulate=1`` every batch fires).
    """
    if name == "auto":
        if epochs < 50:
            raise NotImplementedError(f"optimizer=auto with epochs={epochs} < 50 resolves to AdamW, which is not "
                                      "ported to experiment_yolo_torch (ROADMAP.md catalogue item 9); use SGD")
        name = "SGD"
    if name in ("Adam", "AdamW", "NAdam", "RAdam", "RMSProp", "SOAP"):
        raise NotImplementedError(f"optimizer {name!r} is not ported to experiment_yolo_torch "
                                  "(ROADMAP.md catalogue item 9); use SGD")
    if name != "SGD":
        raise ValueError(f"unknown optimizer {name!r}")
    lf = lr_lambda(epochs, lrf, cos_lr)
    lr_fn, bias_lr_fn, momentum_fn = warmup_schedules(lr0, lf, nb, warmup_epochs, warmup_bias_lr,
                                                      warmup_momentum, momentum)
    k_table, ni_table = _torch_step_plan(nb, epochs, warmup_epochs if warmup_epochs > 0 else 0.0, accumulate)
    return YoloSGD(param_groups(model), lr_fn, bias_lr_fn, momentum_fn, weight_decay, k_table, ni_table)
