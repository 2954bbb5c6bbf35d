"""Checkpoints in PyTorch's own format.

Port of ``experiment_yolo_tpu/engine/checkpoint.py`` (``save_checkpoint``,
``load_checkpoint``, ``load_matching_variables``). A checkpoint is one
``torch.save`` file (``weights/last.pt``, ``best.pt``, ``epochN.pt``) holding
what the JAX package keeps in its Orbax state and ``meta.yaml``:

- ``model`` and ``ema``: the model's and the EMA's state dicts, with the
  Ultralytics names of the port's modules (``utils/convert.py``'s naming);
- ``model_yaml``, ``nc`` and ``task``, so that :func:`load_checkpoint`
  rebuilds the model;
- ``names``, ``epoch``, ``best_fitness`` and ``train_args``;
- for ``last``, ``train_state``: the optimizer's ``state_dict`` (SGD's
  momentum buffers, Adam's moments, SOAP's factors, bases and moments, and
  the counters: updates fired, micro-batches accumulated), the EMA's update
  count, Wise-IoU's ``iou_mean``, EMASlide's ``slide_mean`` and the step,
  from which training resumes.

Tensors are saved on the CPU, so a checkpoint written on the card loads on a
CPU-only machine. The weights are f32 whatever the model's compute dtype
(parameters and buffers never leave f32); the dtype to compute in is chosen
when the checkpoint is loaded. Orbax checkpoints of the JAX package are not read: convert
their variables with ``utils/convert.py:jax_variables_to_state_dict``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from experiment_yolo_torch.nn.tasks import DetectionModel


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str | Path, model: DetectionModel, *, ema: Optional[torch.nn.Module] = None,
                    train_state: Optional[Dict] = None, meta: Optional[Dict] = None) -> Path:
    """Write ``model`` (and its EMA copy, and the train state) with its YAML
    and ``meta`` (names, epoch, best_fitness, train_args) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    ckpt = {"model_yaml": dict(model.yaml), "nc": model.nc, "task": "detect", "names": dict(model.names),
            **(meta or {}), "model": _cpu(model.state_dict())}
    if ema is not None:
        ckpt["ema"] = _cpu(ema.state_dict())
    if train_state is not None:
        ckpt["train_state"] = _cpu(train_state)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(ckpt, tmp)
    tmp.replace(path)  # a reader never sees half a file
    return path


def read_checkpoint(path: str | Path) -> Dict:
    """The checkpoint's dict, tensors on the CPU."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"checkpoint {path} not found (the port writes weights/<name>.pt files; Orbax "
                                "directories of the JAX package are not read)")
    return torch.load(path, map_location="cpu", weights_only=True)


def _weights(ckpt: Dict, prefer_ema: bool) -> Dict[str, torch.Tensor]:
    return ckpt["ema"] if prefer_ema and ckpt.get("ema") is not None else ckpt["model"]


def load_matching_variables(path: str | Path, model: torch.nn.Module, prefer_ema: bool = True) -> Tuple[int, int]:
    """Load the checkpoint's tensors into ``model`` wherever name and shape
    match (the reference's ``intersect_dicts``), so that a checkpoint of a
    different ``nc`` still lends its compatible layers. Returns (matched,
    total) over ``model``'s state-dict entries."""
    src = _weights(read_checkpoint(path), prefer_ema)
    dst = model.state_dict()
    take = {k: v for k, v in src.items() if k in dst and v.shape == dst[k].shape}
    model.load_state_dict(take, strict=False)
    return len(take), len(dst)


def load_checkpoint(path: str | Path, device="cuda", prefer_ema: bool = True,
                    dtype: torch.dtype = torch.float32) -> DetectionModel:
    """The model of a checkpoint, rebuilt from its YAML on ``device`` with its
    names and, by default, the EMA weights (the reference validates and
    exports the EMA model), computing in ``dtype``."""
    ckpt = read_checkpoint(path)
    model = DetectionModel(ckpt["model_yaml"], device=device, dtype=dtype)
    model.load_state_dict(_weights(ckpt, prefer_ema), strict=True)
    model.names = {int(k): v for k, v in ckpt["names"].items()}
    return model
