"""SOAP (Shampoo with Adam in the preconditioner's eigenbasis, arXiv:2409.11321).

Port of ``experiment_yolo_tpu/optim/soap.py`` on the port's optimizer base
(groups, firing plan, global-norm clip). Per parameter tensor:

- one Kronecker factor ``GG_i`` per axis (axes longer than
  ``max_precond_dim`` are left alone; 1-D parameters run plain Adam);
- the eigenbasis ``Q_i`` from ``eigh`` on the first update, which applies no
  step, then refreshed every ``precondition_frequency`` updates by one
  power iteration and a QR, sorted by the estimated eigenvalues, with
  ``exp_avg_sq`` permuted to match;
- Adam in the rotated space, ``exp_avg`` carried across a refresh by
  projecting it back and into the new basis;
- decoupled weight decay on the weight group.

``torch.linalg.eigh`` and ``qr`` stand where the JAX package calls
``jnp.linalg``. An eigenvector's sign differs from library to library; it
cancels between projecting and projecting back. A degenerate eigenvalue does
not: a tie gives each library another basis of its eigenspace.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from experiment_yolo_torch.optim.builders import YoloOptimizer, f32_power


def _project(g: torch.Tensor, qs: List[Optional[torch.Tensor]], transpose: bool) -> torch.Tensor:
    """Rotate ``g`` into (``transpose=False``) or out of (True) the
    eigenbasis: each step takes the leading axis and appends the result at the
    end, so that the axes come back in their order."""
    for q in qs:
        g = g.movedim(0, -1) if q is None else torch.tensordot(g, q, dims=([0], [1 if transpose else 0]))
    return g


def _update_gg(gg, g: torch.Tensor, beta: float):
    """GG_i <- beta * GG_i + (1 - beta) * (g g^T summed over the other axes)."""
    out = []
    for i, m in enumerate(gg):
        if m is None:
            out.append(None)
            continue
        axes = [j for j in range(g.ndim) if j != i]
        out.append(m * beta + torch.tensordot(g, g, dims=(axes, axes)) * (1 - beta))
    return out


def _eigh_q(gg):
    """Each factor's eigenvectors, by descending eigenvalue."""
    return [None if m is None else
            torch.linalg.eigh(m + 1e-30 * torch.eye(m.shape[0], dtype=m.dtype, device=m.device))[1].flip(1)
            for m in gg]


def _qr_refresh(gg, qs, exp_avg_sq: torch.Tensor):
    """One power iteration and QR for each factor, its columns sorted by the
    estimated eigenvalues, ``exp_avg_sq`` permuted along that axis to match."""
    new_qs = []
    for i, (m, o) in enumerate(zip(gg, qs)):
        if m is None:
            new_qs.append(None)
            continue
        est_eig = ((o.T @ m) * o.T).sum(1)  # diag(o^T m o)
        sort_idx = torch.argsort(-est_eig, stable=True)
        exp_avg_sq = exp_avg_sq.index_select(i, sort_idx)
        new_qs.append(torch.linalg.qr(m @ o[:, sort_idx])[0])
    return new_qs, exp_avg_sq


class SOAP(YoloOptimizer):
    """The JAX package's ``soap`` as its ``build_optimizer`` calls it: the
    weight group's LR for every group, decoupled decay on the weight group,
    and its defaults, ``b1 = b2 = shampoo_beta = 0.95``, ``eps`` 1e-8,
    ``max_precond_dim`` 10,000 and bias correction, with a refresh every
    ``precondition_frequency`` (10) updates. Each parameter's state holds
    ``exp_avg``, ``exp_avg_sq`` and one factor ``gg`` and basis ``q`` per
    axis (None where an axis is not preconditioned)."""

    b1 = b2 = shampoo_beta = 0.95
    eps, max_precond_dim = 1e-8, 10000

    def __init__(self, *args, precondition_frequency: int = 10, **kwargs):
        self.precondition_frequency = precondition_frequency
        super().__init__(*args, **kwargs)

    def _init_state(self, p):
        dims = [None] * p.ndim if p.ndim <= 1 else [d if d <= self.max_precond_dim else None for d in p.shape]
        return {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p),
                "gg": [None if d is None else p.new_zeros((d, d)) for d in dims],
                "q": [None if d is None else torch.eye(d, dtype=p.dtype, device=p.device) for d in dims]}

    def _adam(self, st, g, lr):
        """Adam on ``g`` in the current basis -> the step in the original one."""
        b1, b2 = self.b1, self.b2
        st["exp_avg"].mul_(b1).add_(g * (1 - b1))
        st["exp_avg_sq"].mul_(b2).add_(g * g * (1 - b2))
        f32, t = np.float32, self.updates
        bc1, bc2 = f32(1) - f32(f32_power(b1, t)), f32(1) - f32(f32_power(b2, t))
        step_size = f32(lr) * np.sqrt(bc2) / bc1
        return st["exp_avg"] / (st["exp_avg_sq"].sqrt() + self.eps), -float(step_size)

    def _update(self, lr_w, lr_b, mu):
        first, refresh = self.updates == 0, self.updates % self.precondition_frequency == 0
        for group in self.param_groups:
            decay = group["label"] == "weight" and self.weight_decay > 0
            for p in group["params"]:
                g, st = p.grad, self.state[p]
                preconditioned = any(q is not None for q in st["q"])
                if not preconditioned and g.ndim <= 1:  # plain Adam, which also skips the first update
                    d = None if first else torch.mul(*self._adam(st, g, lr_w))
                elif first:  # statistics and the first basis, no step
                    st["gg"] = _update_gg(st["gg"], g, self.shampoo_beta)
                    if preconditioned:
                        st["q"] = _eigh_q(st["gg"])
                    d = None
                else:
                    norm_grad, step_size = self._adam(st, _project(g, st["q"], False), lr_w)
                    d = _project(norm_grad, st["q"], True) * step_size
                    exp_avg = _project(st["exp_avg"], st["q"], True)
                    st["gg"] = _update_gg(st["gg"], g, self.shampoo_beta)
                    if preconditioned and refresh:
                        st["q"], st["exp_avg_sq"] = _qr_refresh(st["gg"], st["q"], st["exp_avg_sq"])
                    st["exp_avg"] = _project(exp_avg, st["q"], False)
                if decay:
                    wd = p * float(np.float32(lr_w) * np.float32(self.weight_decay))
                    d = -wd if d is None else d - wd
                if d is not None:
                    p.add_(d)
