"""The optimizers with Ultralytics semantics: three parameter groups, warmup
schedules and the reference's ramped firing plan, under nesterov SGD, the
Adam family, RMSProp or SOAP.

Port of ``experiment_yolo_tpu/optim/builders.py`` (``_torch_step_plan``,
``param_group_label``, ``lr_lambda``, ``warmup_schedules``, ``yolo_sgd`` and
``build_optimizer``, whose optax chains for Adam, AdamW, NAdam, RAdam and
RMSProp are written out here by hand). Gradients accumulate as sums in
``.grad``, as repeated ``backward()`` calls leave them; ``step()`` is called
once per micro-batch and fires when the firing plan says so: it clips the
summed gradient to a global norm and takes the optimizer's update with the
warmup learning rate of the batch it fires on.
"""

from __future__ import annotations

import ctypes
import ctypes.util
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


# the normalisation layers, as the reference's build_optimizer finds them: every torch.nn class named *Norm*
NORM_LAYERS = tuple(v for k, v in nn.__dict__.items() if "Norm" in k and isinstance(v, type))


def param_group_label(name: str, module: nn.Module) -> str:
    """'bias' | 'norm' | 'weight' for parameter ``name`` of ``module``.

    As the reference (and the JAX package) test ``bias`` first, normalisation
    biases join the bias group; the weights of normalisation layers
    (BatchNorm, and VSS's LayerNorms, whose flax parameter is a ``scale``)
    form the norm group; every other weight (convolutions, LDConv's ``conv.0``
    and ``p_conv``, ScalSeq's ``conv3d``, SS2D's projections and raw scan
    parameters) is in the weight group, the only one with weight decay.
    """
    if name.rsplit(".", 1)[-1] == "bias":
        return "bias"
    if isinstance(module, NORM_LAYERS):
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


class YoloOptimizer(torch.optim.Optimizer):
    """The part every optimizer of the port shares: the parameter groups, the
    firing plan and the global-norm clip.

    Per update: g = clip(sum of the accumulated gradients), then
    :meth:`_update` with the learning rates and momentum of the batch the
    update fires on. ``k_table``/``ni_table`` (from :func:`_torch_step_plan`)
    say how many micro-batches each update accumulates and at which batch its
    schedules are read. Subclasses keep their state in ``self.state[p]``,
    made by :meth:`_init_state`, so that ``state_dict()`` carries all of it.
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
                self.state[p].update(self._init_state(p))

    def _init_state(self, p: torch.Tensor) -> Dict:
        raise NotImplementedError

    def _update(self, lr_w: float, lr_b: float, mu: float) -> None:
        """Apply one update from the clipped gradients in ``.grad``."""
        raise NotImplementedError

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
            raise ValueError(f"{type(self).__name__}.step takes no closure")
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
        self._update(lr_w, lr_b, mu)
        self.updates += 1
        self.mini_step = 0
        return True

    def state_dict(self) -> Dict:
        """``torch.optim.Optimizer``'s, with the firing plan's counters."""
        return {**super().state_dict(), "updates": self.updates, "mini_step": self.mini_step}

    def load_state_dict(self, state_dict: Dict) -> None:
        state_dict = dict(state_dict)
        self.updates, self.mini_step = int(state_dict.pop("updates")), int(state_dict.pop("mini_step"))
        super().load_state_dict(state_dict)


class YoloSGD(YoloOptimizer):
    """Torch-semantics nesterov SGD (the JAX package's ``yolo_sgd``): g +=
    wd*p on the weight group only; buf = mu*buf + g; p -= lr*(g + mu*buf),
    with the bias group's own warmup LR and the momentum warmup."""

    def _init_state(self, p):
        return {"momentum_buffer": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, lr_w, lr_b, mu):
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


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.powf.restype, _LIBM.powf.argtypes = ctypes.c_float, (ctypes.c_float, ctypes.c_float)


def f32_power(base: float, count: int) -> float:
    """``base ** count`` as JAX computes it in f32: XLA's power is the C
    library's ``powf`` of the f32 base. Adam's ``1 - b2 ** t`` near 1e-3, and
    RAdam's rho_t near its threshold, turn one last-place difference of the
    power into 6e-5 of the step and more."""
    return float(_LIBM.powf(float(np.float32(base)), float(count)))


def f32(x) -> float:
    """``x`` rounded to f32, as a Python float."""
    return float(np.float32(x))


class YoloAdam(YoloOptimizer):
    """optax's ``adam``, ``adamw``, ``nadam`` and ``radam`` with the
    arguments the JAX package passes (``b1`` the momentum, ``b2`` 0.999,
    ``eps`` 1e-8): every group moves at the weight group's LR (no bias warmup
    LR, no momentum warmup), and only AdamW decays, the weight group alone,
    decoupled (``u += wd * p`` after Adam's scaling).

    At update t: m = b1*m + (1-b1)*g, v = b2*v + (1-b2)*g^2, m_hat = m / (1 -
    b1^t) (NAdam: b1*m/(1 - b1^(t+1)) + (1-b1)*g/(1 - b1^t)), v_hat = v / (1 -
    b2^t), u = m_hat / (sqrt(v_hat) + eps); RAdam scales u by the
    rectification r where rho_t >= 5 and takes m_hat alone below it.
    ``inject_hyperparams`` hands optax its hyperparameters as f32 arrays, so
    ``1 - b2`` and the bias corrections are f32 arithmetic on f32(b2) (0.999
    rounds 1.3e-5 of ``1 - b2`` away): the scalars here are computed so.
    """

    b2, eps, RADAM_THRESHOLD = 0.999, 1e-8, 5.0

    def __init__(self, family: str, *args, b1: float, **kwargs):
        self.family, self.b1 = family, b1
        super().__init__(*args, **kwargs)

    def _init_state(self, p):
        return {"exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, lr_w, lr_b, mu):
        one, t = np.float32(1), self.updates + 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1, bc2 = float(one - np.float32(f32_power(b1, t))), float(one - np.float32(f32_power(b2, t)))
        scale, rectified = 1.0, True
        if self.family == "RAdam":
            ro_inf = np.float32(2) / (one - b2) - one
            b2t = np.float32(f32_power(b2, t))
            ro = ro_inf - np.float32(2 * t) * b2t / (one - b2t)
            rectified = bool(ro >= self.RADAM_THRESHOLD)
            if rectified:
                scale = float(np.sqrt((ro - np.float32(4)) * (ro - np.float32(2)) * ro_inf
                                      / ((ro_inf - np.float32(4)) * (ro_inf - np.float32(2)) * ro)))
        for group in self.param_groups:
            ps = group["params"]
            g = [p.grad for p in ps]
            m = [self.state[p]["exp_avg"] for p in ps]
            v = [self.state[p]["exp_avg_sq"] for p in ps]
            torch._foreach_mul_(m, float(b1))
            torch._foreach_add_(m, torch._foreach_mul(g, float(one - b1)))
            torch._foreach_mul_(v, float(b2))
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), float(one - b2)))
            if self.family == "NAdam":
                bc1_next = float(one - np.float32(f32_power(b1, t + 1)))
                m_hat = torch._foreach_add(torch._foreach_mul(torch._foreach_div(m, bc1_next), float(b1)),
                                           torch._foreach_mul(torch._foreach_div(g, bc1), float(one - b1)))
            else:
                m_hat = torch._foreach_div(m, bc1)
            if rectified:
                denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), f32(self.eps))
                u = torch._foreach_div(torch._foreach_mul(m_hat, scale) if self.family == "RAdam" else m_hat, denom)
            else:
                u = m_hat
            if self.family == "AdamW" and group["label"] == "weight" and self.weight_decay:
                u = torch._foreach_add(u, torch._foreach_mul(ps, self.weight_decay))
            # -lr * u rounded before the add, as optax's scale and apply_updates round it (alpha would fuse them)
            torch._foreach_add_(ps, torch._foreach_mul(u, -lr_w))


class YoloRMSProp(YoloOptimizer):
    """optax's ``rmsprop(lr, momentum=momentum)`` as the JAX package builds it:
    v = 0.9*v + 0.1*g^2, u = -lr * g / sqrt(v + 1e-8), then a trace buf = u +
    momentum*buf taken as the step; the weight group's LR for every group, no
    weight decay. Its hyperparameters are f32, as ``inject_hyperparams``
    makes them."""

    DECAY, EPS = 0.9, 1e-8

    def __init__(self, *args, momentum: float, **kwargs):
        self.momentum = momentum
        super().__init__(*args, **kwargs)

    def _init_state(self, p):
        return {"square_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "momentum_buffer": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, lr_w, lr_b, mu):
        decay = np.float32(self.DECAY)
        for group in self.param_groups:
            ps = group["params"]
            g = [p.grad for p in ps]
            v = [self.state[p]["square_avg"] for p in ps]
            bufs = [self.state[p]["momentum_buffer"] for p in ps]
            torch._foreach_mul_(v, float(decay))
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), float(np.float32(1) - decay)))
            u = torch._foreach_mul(torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(v, f32(self.EPS))), g),
                                   -lr_w)
            torch._foreach_mul_(bufs, f32(self.momentum))
            torch._foreach_add_(bufs, u)
            torch._foreach_add_(ps, bufs)


OPTIMIZERS = ("SGD", "Adam", "AdamW", "NAdam", "RAdam", "RMSProp", "SOAP")


def build_optimizer(model: nn.Module, name: str, lr0: float, momentum: float, weight_decay: float, nb: int,
                    epochs: int, lrf: float, cos_lr: bool, warmup_epochs: float, warmup_bias_lr: float,
                    warmup_momentum: float, accumulate: int = 1) -> YoloOptimizer:
    """The optimizer of the JAX package's ``build_optimizer``: ``name`` one of
    :data:`OPTIMIZERS` or ``auto``, which takes AdamW with ``lr0`` 0.002 and
    ``momentum`` 0.9 for runs shorter than 50 epochs and SGD otherwise.

    Updates follow the reference's firing plan: during warmup the optimizer
    fires nearly every batch, accumulating ever more of them up to
    ``accumulate``, and each update sees the schedules of the batch it fires
    on (with ``accumulate=1`` every batch fires).
    """
    if name == "auto":
        if epochs < 50:
            name, lr0, momentum = "AdamW", 0.002, 0.9
        else:
            name = "SGD"
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}: one of {', '.join(OPTIMIZERS)} or auto")
    lf = lr_lambda(epochs, lrf, cos_lr)
    lr_fn, bias_lr_fn, momentum_fn = warmup_schedules(lr0, lf, nb, warmup_epochs, warmup_bias_lr,
                                                      warmup_momentum, momentum)
    k_table, ni_table = _torch_step_plan(nb, epochs, warmup_epochs if warmup_epochs > 0 else 0.0, accumulate)
    args = (param_groups(model), lr_fn, bias_lr_fn, momentum_fn, weight_decay, k_table, ni_table)
    if name == "SGD":
        return YoloSGD(*args)
    if name == "RMSProp":
        return YoloRMSProp(*args, momentum=momentum)
    if name == "SOAP":
        from experiment_yolo_torch.optim.soap import SOAP

        return SOAP(*args)
    return YoloAdam(name, *args, b1=momentum)
