"""Where a served batch spends its time on the card.

Usage, on a machine with an NVIDIA GPU and the CUDA toolkit:

    python -m experiment_yolo_torch.profile_predict [model.yaml]

Builds the model (default ``yolov8-LD-P2.yaml``; ``yolov8-C2f-VSS.yaml`` for
the Mamba/VSS detector), at n scale, with seeded weights
(``utils/seeded.py``) and serves seeded images of mixed sizes through
``DetectionPredictor`` at imgsz 640, batch 8, f32 with TF32 off, once per NMS
type: first without the profiler, then under ``torch.profiler``. Prints one
JSON line per NMS type: wall ms per batch with and without the profiler, the
host's letterbox ms, device busy ms and idle share, and device ms per batch
by group (convolutions, the port's kernels, copies, the rest) and for the
top kernels.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.nn.tasks import DetectionModel
from experiment_yolo_torch.utils.seeded import he_normal_, seeded_images

BATCHES, BATCH, IMGSZ, SEED = 4, 8, 640, 0
KERNELS = {"dfl_decode_kernel": "K1 dfl_decode", "nms_suppress_kernel": "K2 nms_suppress",
           "ldconv_gather_kernel": "K3 ldconv_gather", "selective_scan_kernel": "K4 selective_scan",
           "soft_nms_kernel": "K5 soft_nms"}
CONV_WORDS = ("conv", "xmma", "cudnn", "implicit", "fprop", "winograd", "fft")
GEMM_WORDS = ("gemm", "cutlass")


def group_of(name: str) -> str:
    for k, g in KERNELS.items():
        if k in name:
            return g
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copies"
    if any(w in low for w in CONV_WORDS):
        return "convolution"
    if any(w in low for w in GEMM_WORDS):
        return "matmul (LDConv and SS2D projections)"
    return "other (elementwise, reductions, sort, pooling)"


def profile(model, images, nms_type: str, batch: int = BATCH, imgsz: int = IMGSZ) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    pred = DetectionPredictor(model, {"imgsz": imgsz, "batch": batch, "nms_type": nms_type})
    n_batches = len(images) // batch
    pred(images[:batch])  # warm-up
    t = time.perf_counter()
    results = pred(images)
    plain_wall = (time.perf_counter() - t) / n_batches * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pred(images)
        wall = (time.perf_counter() - t) / n_batches * 1e3
    by_group, by_kernel, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total / n_batches
        by_group[group_of(evt.key)] += us / 1e3
        by_kernel[evt.key] += us / 1e3
        counts[evt.key] += evt.count // n_batches
    busy = sum(by_group.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "nms_type": nms_type, "batch": batch, "imgsz": imgsz, "batches": n_batches,
        "wall_ms_per_batch": plain_wall, "wall_ms_per_batch_profiled": wall,
        "host_letterbox_ms_per_batch": sum(r.speed["preprocess"] for r in results) / n_batches,
        "device_busy_ms_per_batch": busy if busy else "not measured (no device events recorded)",
        "device_idle_share_profiled": 1 - busy / wall if busy else "not measured",
        "device_ms_per_batch_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": k[:90], "ms_per_batch": v, "launches_per_batch": counts[k]} for k, v in top],
    }


def main(cfg: str = "yolov8-LD-P2.yaml") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: no CUDA device; this measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    model = DetectionModel(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    he_normal_(model, SEED + 1)
    images = seeded_images(BATCHES * BATCH, SEED)
    for nms_type in ("hard", "soft"):
        row = profile(model, images, nms_type)
        print(json.dumps({"cfg": cfg, **row, "card": card}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:2])
