"""Callback event bus: the port's copy of ``experiment_yolo_tpu/utils/callbacks.py``.

Integrations register handlers on these events; the core only fires them.
The training loop fires ``on_pretrain_routine_start``,
``on_train_epoch_start``, ``on_fit_epoch_end`` and ``on_train_end``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

EVENTS = [
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_val_start",
    "on_val_batch_start",
    "on_val_batch_end",
    "on_val_end",
    "on_predict_start",
    "on_predict_batch_start",
    "on_predict_batch_end",
    "on_predict_postprocess_end",
    "on_predict_end",
    "on_export_start",
    "on_export_end",
]


class Callbacks:
    def __init__(self):
        self._hooks: Dict[str, List[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown callback event {event!r} (valid: {EVENTS})")
        self._hooks[event].append(fn)

    def run(self, event: str, **kwargs) -> None:
        for fn in self._hooks.get(event, []):
            fn(**kwargs)
