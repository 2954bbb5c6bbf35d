"""Configuration: the copied ``default.yaml`` plus overrides.

Port of ``experiment_yolo_tpu/cfg/__init__.py`` (``get_cfg``,
``check_dict_alignment``, ``check_imgsz``),
with the checks of the keys the detect predict path, the training step and
the training loop read. Every key of ``default.yaml`` is accepted as an
override, so a config written for the JAX package loads here unchanged.
"""

from __future__ import annotations

import difflib
import math
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional

import yaml

CFG_DIR = Path(__file__).resolve().parent
DEFAULT_CFG_PATH = CFG_DIR / "default.yaml"

_FRACTION_KEYS = {"conf", "iou"}
_INT_KEYS = {"max_det", "imgsz", "batch", "epochs", "nbs", "patience", "close_mosaic", "workers", "save_period"}
_BOOL_KEYS = {"agnostic_nms", "soft_nms_quirk", "amp", "ema", "cos_lr", "val", "save", "rect", "multi_scale",
              "single_cls", "exist_ok"}
_NMS_TYPES = ("soft", "hard")


def yaml_load(path: str | Path) -> dict:
    """Load a YAML file into a dict."""
    with open(path, encoding="utf-8") as f:
        return yaml.safe_load(f) or {}


def default_cfg() -> Dict[str, Any]:
    """The defaults of ``default.yaml`` as a fresh dict."""
    return yaml_load(DEFAULT_CFG_PATH)


def _coerce(k: str, v: Any) -> Any:
    if v is None or v == "None":
        return None
    if k == "resume":  # a bool, or the path of a checkpoint to resume from
        if isinstance(v, bool):
            return v
        if not isinstance(v, (str, Path)):
            raise TypeError(f"'resume={v}' must be a bool or a checkpoint path")
        return {"true": True, "false": False}.get(str(v).lower(), str(v))
    if k in _BOOL_KEYS and not isinstance(v, bool):
        if isinstance(v, str) and v.lower() in ("true", "false"):
            return v.lower() == "true"
        raise TypeError(f"'{k}={v}' must be a bool")
    if k in _INT_KEYS and not isinstance(v, int):
        try:
            return int(v)
        except (TypeError, ValueError) as e:
            raise TypeError(f"'{k}={v}' must be an int") from e
    if k in _FRACTION_KEYS:
        try:
            v = float(v)
        except (TypeError, ValueError) as e:
            raise TypeError(f"'{k}={v}' must be a number") from e
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"'{k}={v}' must be in [0, 1]")
    if k == "nms_type" and v not in _NMS_TYPES:
        raise ValueError(f"'nms_type={v}' must be one of {_NMS_TYPES}")
    return v


def check_dict_alignment(base: dict, custom: dict) -> None:
    """Raise ``SyntaxError`` naming every key of ``custom`` that ``base``
    lacks, with close-match suggestions."""
    mismatched = [k for k in custom if k not in base]
    if mismatched:
        msgs = []
        for k in mismatched:
            close = difflib.get_close_matches(k, base.keys(), n=3, cutoff=0.5)
            msgs.append(f"'{k}' is not a valid config key" + (f" — did you mean {close}?" if close else ""))
        raise SyntaxError("\n".join(msgs))


def get_cfg(overrides: Optional[dict] = None) -> SimpleNamespace:
    """Merge ``default.yaml`` < overrides into a validated namespace.

    Unknown keys raise ``SyntaxError`` with close-match suggestions, as in
    the JAX package.
    """
    base = default_cfg()
    overrides = dict(overrides or {})
    check_dict_alignment(base, overrides)
    merged = {**base, **overrides}
    return SimpleNamespace(**{k: _coerce(k, v) for k, v in merged.items()})


def check_imgsz(imgsz: int, stride: int = 32) -> int:
    """Round ``imgsz`` up to a multiple of the model's max stride."""
    return int(math.ceil(imgsz / stride) * stride)
