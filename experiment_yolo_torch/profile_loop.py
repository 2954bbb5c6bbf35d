"""Where a training step's wall time goes when the threaded loader feeds it.

Usage, on a machine with an NVIDIA GPU:
    python3 -m experiment_yolo_torch.profile_loop [workers ...]

Writes a synthetic BMP dataset (64 images at 640) under ``build/``, then for
each loader setting trains LD-P2 (nc=3) for one epoch of 8 steps of batch 8
through ``DetectionTrainer.train()`` (no validation, no checkpoint) and
reports the step's wall time, the share of it spent waiting for the next
batch, and the loader's ms per batch alone (nothing else running). Settings:
``workers`` threads (default 8 and 4) times the row chunk of the warp's
bilinear blends (``data/augment.py:BLEND_ROWS``: 32 rows, as it is, and the
whole image in one pass, which makes 20 times fewer numpy calls, each holding
the GIL between its loops), in turns (32, whole, whole, 32). First, as a
yardstick, the same steps through ``train_step`` on batches made beforehand
(no loader thread running). One JSON line per setting, then the card's name
and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from experiment_yolo_torch import DetectionModel, DetectionTrainer
from experiment_yolo_torch.data import DataLoader, make_synthetic_dataset
from experiment_yolo_torch.data import augment as A
from experiment_yolo_torch.data import build
from experiment_yolo_torch.nn.tasks import yaml_model_load

IMGSZ, BATCH, N_TRAIN, SEED = 640, 8, 64, 0
CHUNKS = (32, IMGSZ, IMGSZ, 32)  # output rows per pass of the warp's blends, in turns


def _args(data, project, workers):
    return {"data": str(data), "epochs": 1, "batch": BATCH, "imgsz": IMGSZ, "workers": workers, "amp": False,
            "optimizer": "SGD", "val": False, "save": False, "project": str(project), "verbose": False}


def _model():
    return DetectionModel({**yaml_model_load("yolov8-LD-P2.yaml"), "nc": 3}, device="cuda",
                          generator=torch.Generator().manual_seed(SEED))


def alone_step_ms(data, project):
    """Median wall ms of a step through ``train_step`` on batches made
    beforehand, each ending in a synchronize: the step without a loader."""
    trainer = DetectionTrainer(_model(), _args(data, project, 8))
    batches = list(DataLoader(build.build_yolo_dataset(trainer.args, Path(data).parent / "images" / "train"),
                              BATCH, workers=8, seed=SEED))
    times = []
    for b in batches * 2:
        t = time.perf_counter()
        trainer.train_step(trainer._host_batch(b))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times[len(batches):])


def loop(data, project, workers):
    """One epoch through ``train()``: step wall ms, wait share, and the loader alone."""
    waits, iterate = [], build.DataLoader.__iter__

    def timed_iter(self):
        it = iterate(self)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t0)
            yield item

    trainer = DetectionTrainer(_model(), _args(data, project, workers))
    build.DataLoader.__iter__ = timed_iter
    try:
        t = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        build.DataLoader.__iter__ = iterate
    loader = DataLoader(trainer.train_loader.dataset, BATCH, workers=workers, seed=SEED)
    gaps, t = [], time.perf_counter()
    for _ in loader:
        gaps.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
    steps = len(waits)
    return {"workers": workers, "steps": steps, "step_wall_ms": wall / steps * 1e3, "wait_share": sum(waits) / wall,
            "img_per_s": steps * BATCH / wall, "loader_alone_ms_per_batch": statistics.median(gaps[1:])}


def main(argv):
    workers = [int(a) for a in argv] or [8, 4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parents[1] / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        data = make_synthetic_dataset(Path(tmp) / "data", n_train=N_TRAIN, n_val=8, imgsz=IMGSZ, seed=SEED)
        A.hsv2bgr(np.zeros((1, 1, 3), np.uint8))  # the HSV table, built once before any timing
        print(json.dumps({"train_step_alone_ms": alone_step_ms(data, Path(tmp) / "runs")}), flush=True)
        default = A.BLEND_ROWS
        for rows in CHUNKS:
            A.BLEND_ROWS = rows
            try:
                for w in workers:
                    print(json.dumps({"blend_rows": rows, **loop(data, Path(tmp) / "runs", w)}), flush=True)
            finally:
                A.BLEND_ROWS = default
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")


if __name__ == "__main__":
    main(sys.argv[1:])
