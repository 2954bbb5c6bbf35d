"""Where a training step spends its time on the card.

Usage, on a machine with an NVIDIA GPU and the CUDA toolkit:

    python -m experiment_yolo_torch.profile_train [f32|bf16] [model.yaml]

Builds the model (``yolov8-LD-P2.yaml`` unless another YAML is named, e.g.
``yolov8-C2f-VSS.yaml``; n scale) with seeded weights
(``utils/seeded.py``) and trains it through ``DetectionTrainer.train_step`` on
seeded labelled batches at imgsz 640, batch 8, with TF32 off, in f32
(``amp=False``, the default of this tool) or in bf16 (``amp=True``): warm-up
steps, then timed steps without the profiler, then the same number under
``torch.profiler``. Prints one JSON line: wall ms per step with and without
the profiler, device busy ms and idle share, and device ms per step by group:
convolutions, BatchNorm and LayerNorm forward and backward, the matmuls
(LDConv's projection, SS2D's projections), kernels K1, K3 and K4 forward and
backward, TAL and the loss, the rest of the forward and of the backward, the
optimizer and the EMA (the bf16 forms of K1 and K3 in groups of their own). A
kernel's phase is the
``record_function`` range of ``train_step`` it was launched from (the
backward's kernels are launched from autograd's own thread).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.tasks import DetectionModel
from experiment_yolo_torch.utils.seeded import he_normal_, seeded_batch

STEPS, WARMUP, BATCH, IMGSZ, SEED = 6, 3, 8, 640, 0
KERNELS = {"dfl_decode_kernel": "K1 dfl_decode", "dfl_decode_bwd_kernel": "K1 dfl_decode_bwd",
           "ldconv_gather_kernel": "K3 ldconv_gather", "ldconv_gather_bwd_kernel": "K3 ldconv_gather_bwd",
           **{f"selective_scan_kernel_{p}": "K4 selective_scan" for p in ("ends", "carry", "outputs")},
           **{f"selective_scan_bwd_kernel_{p}": "K4 selective_scan_bwd"
              for p in ("starts", "gcarry", "main", "dx", "bc", "params")}}
PHASES = ("forward", "loss", "backward", "optimizer", "ema")
BN_WORDS = ("bn_fw", "bn_bw", "batch_norm", "batchnorm")  # cuDNN's and PyTorch's own BatchNorm kernels
LN_WORDS = ("layer_norm", "layernorm", "gammabeta")  # PyTorch's LayerNorm kernels, forward and backward
CONV_WORDS = ("conv", "xmma", "cudnn", "implicit", "fprop", "dgrad", "wgrad", "winograd", "fft")
GEMM_WORDS = ("gemm", "cutlass")


def phase_of(evt) -> str:
    """The ``train_step`` range an event ran under, following its CPU parents."""
    while evt is not None:
        if evt.name in PHASES:
            return evt.name
        if evt.name.startswith("autograd::engine"):
            return "backward"
        evt = evt.cpu_parent
    return "outside the step"


def group_of(kernel: str, phase: str) -> str:
    name = kernel.removeprefix("void ")  # a template's demangled name starts with its return type
    for k, g in KERNELS.items():
        if name == k or name.startswith((k + "(", k + "<")):
            return g + (" bf16" if "__nv_bfloat16" in name.split("(")[0] else "")
    low = kernel.lower()
    if low.startswith(("memcpy", "memset")):
        return "copies"
    if phase in ("forward", "backward"):
        if any(w in low for w in BN_WORDS):
            return f"BatchNorm {phase}"
        if any(w in low for w in LN_WORDS):
            return f"LayerNorm {phase}"
        if any(w in low for w in CONV_WORDS):
            return f"convolution {phase}"
        if any(w in low for w in GEMM_WORDS):
            return f"matmul (LDConv, SS2D projections) {phase}"
        return f"{phase}: other (activations, gather glue)"
    if phase == "loss":
        return "TAL and the loss"
    return phase


def profile(trainer: DetectionTrainer, batches) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for i in range(WARMUP):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(STEPS):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t) / STEPS * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(STEPS):
            trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / STEPS * 1e3
    by_group, launches = defaultdict(float), defaultdict(int)
    for evt in prof.events():
        if not evt.kernels:
            continue
        phase = phase_of(evt)
        for k in evt.kernels:
            g = group_of(k.name, phase)
            by_group[g] += k.duration / STEPS / 1e3
            launches[g] += 1
    busy = sum(by_group.values())
    return {
        "batch": BATCH, "imgsz": IMGSZ, "steps": STEPS, "wall_ms_per_step": plain_wall,
        "wall_ms_per_step_profiled": wall, "img_per_s": BATCH / plain_wall * 1e3,
        "device_busy_ms_per_step": busy if busy else "not measured (no device events recorded)",
        "device_idle_share_profiled": 1 - busy / wall if busy else "not measured",
        "device_ms_per_step_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "launches_per_step_by_group": {g: n / STEPS for g, n in sorted(launches.items(), key=lambda kv: -kv[1])},
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device; this measures the card")
    args = sys.argv[1:]
    dtype = next((a for a in args if a in ("f32", "bf16")), "f32")
    cfg = next((a for a in args if a.endswith(".yaml")), "yolov8-LD-P2.yaml")
    unknown = [a for a in args if a not in (dtype, cfg)]
    if unknown:
        raise SystemExit(f"profile_train: unknown arguments {unknown}: [f32|bf16] [model.yaml]")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    model = DetectionModel(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    he_normal_(model, SEED + 1)
    trainer = DetectionTrainer(model, {"amp": dtype == "bf16", "batch": BATCH, "imgsz": IMGSZ})
    batches = [seeded_batch(BATCH, IMGSZ, SEED + 10 + i, nc=model.nc) for i in range(4)]
    print(json.dumps({**profile(trainer, batches), "cfg": cfg, "dtype": dtype, "card": card}), flush=True)


if __name__ == "__main__":
    main()
