"""JAX-package variables -> this package's ``state_dict``.

The port's own copy of the name and layout mapping of
``experiment_yolo_tpu/utils/torch_convert.py`` (read in the other direction),
for the layer types the port builds: ``Conv``, ``LDConv``, ``C2f``, ``SPPF``,
``ScalSeq``, ``Detect`` and the zoo containers ``C2f_VSS``, ``C2f_LVMB``,
``C3_VSS``, ``C3_LVMB``. It takes the JAX package's
``{'params', 'batch_stats'}`` as nested dicts of numpy arrays and returns a
state dict for ``model.load_state_dict(..., strict=True)``; a tree shaped like
``params`` alone (a gradient or a momentum buffer) converts to the port's
parameter names the same way.

Layout rules:
- conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var -> running_mean/var
- LDConv Dense ``proj`` (N*C, O), n-major -> the (N, 1) conv ``conv.0.weight``
  (O, C, N, 1): W[o, i, n, 0] = dense[n*C + i, o]
- ScalSeq Dense ``conv3d`` (I, O) -> Conv3d weight (O, I, 1, 1, 1)
- VSSBlock / SS2D: Dense kernel (I, O) -> Linear weight (O, I); the depthwise
  conv kernel (3, 3, 1, d_inner) -> (d_inner, 1, 3, 3) by the conv rule, and
  its bias; LayerNorm scale/bias -> weight/bias; the five raw parameters
  (``x_proj_weight``, ``dt_projs_weight``, ``dt_projs_bias``, ``A_logs``,
  ``Ds``) by name and unchanged: the port keeps the JAX package's shapes,
  direction axis first, not VMamba's flattened (4*d_inner, ...) ones
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


SS2D_RAW = ("x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs", "Ds")


def _vss(prefix: Tuple[str, ...], rest: List[str]) -> Rule:
    """A ``VSSBlock`` at ``prefix``: rest is ['ln_1', leaf] or ['self_attention', ...]."""
    if rest[0] == "ln_1":
        return "params", (*prefix, "ln_1", "scale" if rest[1] == "weight" else "bias"), _same
    if rest[0] != "self_attention":
        raise KeyError(".".join(rest))
    prefix, name, leaf = (*prefix, "self_attention"), rest[1], rest[2:]
    if name in SS2D_RAW:
        return "params", (*prefix, name), _same
    if name in ("in_proj", "out_proj") and leaf == ["weight"]:
        return "params", (*prefix, name, "kernel"), lambda w: w.T
    if name == "conv2d":
        return "params", (*prefix, name, "kernel" if leaf == ["weight"] else "bias"), \
            _conv if leaf == ["weight"] else _same
    if name == "out_norm":
        return "params", (*prefix, name, "scale" if leaf == ["weight"] else "bias"), _same
    raise KeyError(".".join(rest))


def _zoo(inner: str, rest: List[str]) -> Rule:
    """A ``C2f_<inner>`` / ``C3_<inner>`` container: its own Convs, and in
    ``m.{k}`` a VSS bottleneck (``cv1`` Conv, ``cv2`` VSSBlock) or a bare
    VSSBlock (LVMB)."""
    if rest[0] != "m":
        return _conv_bn((rest[0],), rest[1:])
    slot, rest = f"m{rest[1]}", rest[2:]
    if inner == "LVMB":
        return _vss((slot,), rest)
    if rest[0] == "cv1":
        return _conv_bn((slot, "cv1"), rest[1:])
    return _vss((slot, rest[0]), rest[1:])


def _rule(mtype: str, rest: List[str], module) -> Rule:
    """Where the JAX variables hold the torch leaf ``rest`` of a layer of ``mtype``."""
    if mtype == "Conv":
        return _conv_bn((), rest)
    if mtype in ("C2f_VSS", "C2f_LVMB", "C3_VSS", "C3_LVMB"):
        return _zoo(mtype.partition("_")[2], rest)
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


def _leaf_rule(name: str, model) -> Rule:
    """The rule of state-dict entry ``name``, its path starting at its layer."""
    parts = name.split(".")
    layer = model.model[int(parts[1])]
    try:
        kind, path, fn = _rule(layer.type, parts[2:], layer)
    except KeyError as e:
        raise KeyError(f"{name}: no JAX counterpart ({e})") from None
    return kind, (f"layers_{parts[1]}", *path), fn


def jax_path(name: str, model) -> Tuple[str, Tuple[str, ...]]:
    """Where the JAX variables hold state-dict entry ``name``: the collection
    (``params`` or ``batch_stats``) and the path inside it."""
    return _leaf_rule(name, model)[:2]


def _convert(name: str, ref: torch.Tensor, variables: Dict, model) -> torch.Tensor:
    kind, path, fn = _leaf_rule(name, model)
    node = variables[kind]
    for k in path:
        node = node[k]
    arr = fn(np.asarray(node, np.float32))
    if arr.shape != tuple(ref.shape):
        raise ValueError(f"{name}: converted shape {arr.shape} != model shape {tuple(ref.shape)}")
    return torch.tensor(arr)


def jax_variables_to_state_dict(variables: Dict, model) -> Dict[str, torch.Tensor]:
    """The JAX package's variables -> a full ``state_dict`` for ``model``."""
    return {name: torch.zeros_like(ref) if name.endswith("num_batches_tracked") else
            _convert(name, ref, variables, model) for name, ref in model.state_dict().items()}


def jax_params_to_named(tree: Dict, model) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX ``params`` (a gradient, a momentum buffer,
    an EMA of the parameters) -> {parameter name of ``model``: tensor}, in the
    port's layouts, so that it compares leaf by leaf with the port's own."""
    return {name: _convert(name, p, {"params": tree}, model) for name, p in model.named_parameters()}
