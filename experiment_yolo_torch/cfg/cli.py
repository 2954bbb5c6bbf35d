"""The ``yolo-torch`` command-line interface.

Port of ``experiment_yolo_tpu/cfg/cli.py``: ``yolo-torch MODE key=value ...``
(or ``python -m experiment_yolo_torch.cfg.cli MODE key=value ...``) with the
JAX CLI's modes and ``key=value`` grammar. Ported: ``train``, ``val``,
``predict`` and ``serve``, which build a :class:`YOLO` from ``model=`` and
take every ``default.yaml`` key, and ``cfg``, ``version``, ``checks`` and
``copy-cfg``. The other modes raise ``NotImplementedError`` naming their
``ROADMAP.md`` item. ``device=`` is a key of the port's own: the card
(``cuda``) unless it says ``cpu``.

``predict``'s ``source=`` is what ``YOLO.predict`` takes from a command line:
an image file (JPEG, PNG, BMP) or a folder of them, read by
``data/loaders.py``; videos and streams wait for ROADMAP.md queue 1 item 3.5.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict, List

from experiment_yolo_torch.cfg import DEFAULT_CFG_PATH, check_dict_alignment, default_cfg
from experiment_yolo_torch.utils import LOGGER, colorstr

MODES = ("train", "val", "predict", "track", "export", "benchmark", "serve",
         "cfg", "version", "checks", "settings", "copy-cfg", "explorer", "login", "logout")
UNPORTED = {"track": "trackers/*", "export": "engine/exporter.py", "benchmark": "utils/benchmarks.py",
            "settings": "utils/__init__.py:SettingsManager", "explorer": "data/explorer.py", "login": "hub.py",
            "logout": "hub.py"}  # mode -> what it needs, all of ROADMAP.md queue 1 item 10

USAGE = f"""
    yolo-torch MODE ARGS

    Where MODE in {MODES} and ARGS are key=value pairs, e.g.:

        yolo-torch train model=yolov8-LD-P2.yaml data=data.yaml epochs=10 imgsz=640 optimizer=AdamW
        yolo-torch val model=runs/detect/train/weights/best.pt data=data.yaml
        yolo-torch predict model=runs/detect/train/weights/best.pt source=images/ conf=0.25
        yolo-torch serve model=runs/detect/train/weights/best.pt port=8000
        yolo-torch version | checks | copy-cfg
        yolo-torch cfg            # print default config

    device=cuda (the default) or device=cpu.
"""


def parse_key_value(args: List[str]) -> Dict[str, Any]:
    """Parse k=v tokens with YAML-ish scalar coercion."""
    import ast

    out: Dict[str, Any] = {}
    for a in args:
        if "=" not in a:
            raise SyntaxError(f"argument {a!r} is not key=value\n{USAGE}")
        k, v = a.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        elif v.lower() in ("none", "null", ""):
            out[k] = None
        else:
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
    return out


def entrypoint(argv: List[str] | None = None) -> Any:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        LOGGER.info(USAGE)
        return None
    mode, *rest = argv
    if mode not in MODES:
        raise SyntaxError(f"invalid mode {mode!r}; expected one of {MODES}\n{USAGE}")
    if mode in UNPORTED:
        raise NotImplementedError(f"mode {mode!r} ({UNPORTED[mode]}) is not ported to experiment_yolo_torch yet "
                                  "(ROADMAP.md queue 1 item 10)")
    if mode == "cfg":
        for k, v in default_cfg().items():
            LOGGER.info(f"{k}={v}")
        return None
    if mode == "version":
        from experiment_yolo_torch import __version__

        LOGGER.info(__version__)
        return __version__
    if mode == "checks":
        import platform

        import torch

        LOGGER.info(f"python {platform.python_version()} on {platform.platform()}")
        LOGGER.info(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA device(s)")
        for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
            LOGGER.info(f"  device {i}: {torch.cuda.get_device_name(i)}")
        return None
    if mode == "copy-cfg":
        import shutil

        dst = Path.cwd() / (DEFAULT_CFG_PATH.stem + "_copy.yaml")
        shutil.copy2(DEFAULT_CFG_PATH, dst)
        LOGGER.info(f"{DEFAULT_CFG_PATH} copied to {dst}")
        return dst

    overrides = parse_key_value(rest)
    model_src = overrides.pop("model", None)
    if model_src is None:
        raise SyntaxError(f"'model=' is required for mode {mode!r}\n{USAGE}")
    source = overrides.pop("source", None)
    device = overrides.pop("device", "cuda")
    if mode == "serve":
        from experiment_yolo_torch.serve import DetectionServer

        host = str(overrides.pop("host", "127.0.0.1"))
        port = int(overrides.pop("port", 8000))
        server = DetectionServer(model_src, device=device, **overrides)
        bound = server.start(host=host, port=port)
        LOGGER.info(f"{colorstr('serve:')} ready on {host}:{bound} — POST /predict, GET /health")
        try:
            server._http_thread.join()
        except KeyboardInterrupt:
            server.stop()
        return server
    check_dict_alignment({**default_cfg(), "model": None, "source": None}, overrides)

    from experiment_yolo_torch.engine.model import YOLO

    model = YOLO(model_src, device=device)
    if mode == "train":
        return model.train(**overrides)
    if mode == "val":
        stats = model.val(**overrides)
        LOGGER.info(f"val: {json.dumps(stats)}")
        return stats
    if source is None:
        raise SyntaxError("'source=' is required for predict")
    results = model.predict(source, **overrides)
    LOGGER.info(f"{colorstr('predict:')} {len(results)} images")
    for r in results:
        LOGGER.info(f"  {r.path}: {len(r.boxes)} detections")
    return results


if __name__ == "__main__":
    entrypoint()
