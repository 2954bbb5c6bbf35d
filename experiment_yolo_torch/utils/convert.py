"""JAX-package variables -> this package's ``state_dict``.

The port's own copy of the name and layout mapping of
``experiment_yolo_tpu/utils/torch_convert.py`` (read in the other direction),
for the module types of the detect slice. It takes the JAX package's
``{'params', 'batch_stats'}`` as nested dicts of numpy arrays and returns a
state dict for ``model.load_state_dict(..., strict=True)``.

Layout rules:
- conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var -> running_mean/var
- LDConv Dense ``proj`` (N*C, O), n-major -> the (N, 1) conv ``conv.0.weight``
  (O, C, N, 1): W[o, i, n, 0] = dense[n*C + i, o]
- ScalSeq Dense ``conv3d`` (I, O) -> Conv3d weight (O, I, 1, 1, 1)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Rule = Tuple[str, Tuple[str, ...], Callable[[np.ndarray], np.ndarray]]


def _same(w: np.ndarray) -> np.ndarray:
    return w


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _bn(prefix: Tuple[str, ...], leaf: str) -> Rule:
    if leaf in ("weight", "bias"):
        return "params", (*prefix, "scale" if leaf == "weight" else "bias"), _same
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", (*prefix, leaf[len("running_"):]), _same
    raise KeyError(leaf)


def _conv_bn(prefix: Tuple[str, ...], rest: List[str]) -> Rule:
    """A ``Conv`` (conv + bn) at ``prefix``: rest is ['conv', 'weight'] or ['bn', leaf]."""
    if rest == ["conv", "weight"]:
        return "params", (*prefix, "conv", "kernel"), _conv
    if rest[0] == "bn":
        return _bn((*prefix, "bn"), rest[1])
    raise KeyError(".".join(rest))


def _proj(dense: np.ndarray, n: int) -> np.ndarray:
    nc, o = dense.shape
    return dense.reshape(n, nc // n, o).transpose(2, 1, 0)[..., None]


def _rule(mtype: str, rest: List[str], module) -> Rule:
    """Where the JAX variables hold the torch leaf ``rest`` of a layer of ``mtype``."""
    if mtype == "C2f":
        if rest[0] == "m":  # m.{k}.cv1.conv.weight -> m{k}/cv1/conv/kernel
            return _conv_bn((f"m{rest[1]}", rest[2]), rest[3:])
        return _conv_bn((rest[0],), rest[1:])
    if mtype == "SPPF":
        return _conv_bn((rest[0],), rest[1:])
    if mtype == "LDConv":
        if rest[0] == "p_conv":
            return "params", ("p_conv", "kernel" if rest[1] == "weight" else "bias"), \
                _conv if rest[1] == "weight" else _same
        if rest[:2] == ["conv", "0"]:
            return "params", ("proj", "kernel"), lambda w: _proj(w, module.num_param)
        if rest[:2] == ["conv", "1"]:
            return _bn(("bn",), rest[2])
    if mtype == "ScalSeq":
        if rest[0] == "conv3d":
            if rest[1] == "weight":
                return "params", ("conv3d", "kernel"), lambda w: w.T[..., None, None, None]
            return "params", ("conv3d", "bias"), _same
        if rest[0] == "bn":
            return _bn(("bn",), rest[1])
        return _conv_bn((rest[0],), rest[1:])
    if mtype == "Detect":  # cv2.{i}.{j}: j in (0, 1) a Conv, j == 2 a bare Conv2d
        name = f"{rest[0]}_{rest[1]}_{rest[2]}"
        if rest[2] == "2":
            return "params", (name, "kernel" if rest[3] == "weight" else "bias"), \
                _conv if rest[3] == "weight" else _same
        return _conv_bn((name,), rest[3:])
    raise KeyError(f"module type {mtype} has no weights to convert")


def jax_variables_to_state_dict(variables: Dict, model) -> Dict[str, torch.Tensor]:
    """The JAX package's variables -> a full ``state_dict`` for ``model``."""
    out: Dict[str, torch.Tensor] = {}
    for name, ref in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros_like(ref)
            continue
        parts = name.split(".")
        idx = int(parts[1])
        layer = model.model[idx]
        try:
            kind, path, fn = _rule(layer.type, parts[2:], layer)
        except KeyError as e:
            raise KeyError(f"{name}: no JAX counterpart ({e})") from None
        node = variables[kind][f"layers_{idx}"]
        for k in path:
            node = node[k]
        arr = fn(np.asarray(node, np.float32))
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{name}: converted shape {arr.shape} != model shape {tuple(ref.shape)}")
        out[name] = torch.tensor(arr)
    return out
