"""Predict-time configuration: the copied ``default.yaml`` plus overrides.

Port of ``experiment_yolo_tpu/cfg/__init__.py`` (``get_cfg``/``check_imgsz``),
cut to what the detect predict path reads: ``conf``, ``iou``, ``max_det``,
``agnostic_nms``, ``nms_type``, ``soft_nms_quirk``, ``classes``, ``imgsz``
and ``batch``. Every key of ``default.yaml`` is still accepted as an override,
so a config written for the JAX package loads here unchanged.
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
_INT_KEYS = {"max_det", "imgsz", "batch"}
_BOOL_KEYS = {"agnostic_nms", "soft_nms_quirk"}
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


def get_cfg(overrides: Optional[dict] = None) -> SimpleNamespace:
    """Merge ``default.yaml`` < overrides into a validated namespace.

    Unknown keys raise ``SyntaxError`` with close-match suggestions, as in
    the JAX package.
    """
    base = default_cfg()
    overrides = dict(overrides or {})
    unknown = [k for k in overrides if k not in base]
    if unknown:
        msgs = []
        for k in unknown:
            close = difflib.get_close_matches(k, base.keys(), n=3, cutoff=0.5)
            msgs.append(f"'{k}' is not a valid config key" + (f" — did you mean {close}?" if close else ""))
        raise SyntaxError("\n".join(msgs))
    merged = {**base, **overrides}
    return SimpleNamespace(**{k: _coerce(k, v) for k, v in merged.items()})


def check_imgsz(imgsz: int, stride: int = 32) -> int:
    """Round ``imgsz`` up to a multiple of the model's max stride."""
    return int(math.ceil(imgsz / stride) * stride)
