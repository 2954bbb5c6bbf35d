"""Device selection and host helpers: the package logger, YAML saving, run
directories and the newest run's checkpoint.

The helpers are the port's copies of ``experiment_yolo_tpu/utils/__init__.py``
(``LOGGER``, ``yaml_save``, ``colorstr``, ``increment_path``,
``get_latest_run``).
"""

from __future__ import annotations

import glob
import logging
import os
import sys
from pathlib import Path

import torch
import yaml


def _make_logger(name: str = "yolo_torch", verbose: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.INFO if verbose else logging.ERROR)
    logger.propagate = False
    return logger


LOGGER = _make_logger()


def select_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names a card that is absent.

    The entry points run on the card unless the caller asks for the CPU: there
    is no silent fall-back.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} was asked for but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def yaml_save(file: str | Path, data: dict) -> None:
    Path(file).parent.mkdir(parents=True, exist_ok=True)
    clean = {k: (str(v) if isinstance(v, Path) else v) for k, v in data.items()}
    with open(file, "w", encoding="utf-8") as f:
        yaml.safe_dump(clean, f, sort_keys=False, allow_unicode=True)


def colorstr(*args) -> str:
    """ANSI-coloured string, e.g. colorstr('blue', 'bold', 'hello')."""
    *prefix, string = args if len(args) > 1 else ("blue", "bold", args[0])
    codes = {"black": "\033[30m", "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
             "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
             "bold": "\033[1m", "end": "\033[0m"}
    return "".join(codes.get(x, "") for x in prefix) + str(string) + codes["end"]


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """Increment a path: runs/exp -> runs/exp2, runs/exp3, ..."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def get_latest_run(search_dir: str | Path = "runs") -> str:
    """The newest ``weights/last*`` checkpoint under ``search_dir``, by mtime."""
    cands = glob.glob(str(Path(search_dir) / "**" / "weights" / "last*"), recursive=True)
    return max(cands, key=os.path.getmtime) if cands else ""
