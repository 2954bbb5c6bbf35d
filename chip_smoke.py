#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``experiment_yolo_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
 1. print the card's name and power limit (``nvidia-smi``);
 2. turn TF32 off for matmuls and cuDNN convolutions (full f32 throughout);
 3. build the five CUDA libraries of ``experiment_yolo_torch/csrc`` (seven
    kernels) with nvcc;
 4. build ``yolov8-LD-P2.yaml`` (n scale, nc=6) on the card from a seeded
    generator, and run one batch of 8 at 640 to take each kernel's inputs
    from the main path: the Detect maps (K1), the ten LDConv sources and
    offsets (K3), the hard-NMS candidates (K2);
 5. hold each kernel against its plain PyTorch version on those inputs
    (K1 and K3 within 1e-5 abs, K2 identical masks), K3 also on random
    offsets at the same shapes that vary by pixel and image and reach 40 px
    out of bounds, K2 also on made-up candidates (a ragged K = 1,000, K =
    8,192, duplicates, IoUs exactly at the threshold, interleaved invalid
    candidates, an image with none valid); time kernel, plain version and,
    for K3, ``F.grid_sample`` as a library yardstick (CUDA events, median of
    20 runs after warm-up), and read each kernel's device time from a
    ``torch.profiler`` trace, for K3 also layer by layer beside each layer's
    bound; K2's bound is the largest of its pair arithmetic, its bytes and
    its chain of decisions (the earlier design's own bound beside it);
 6. serve 20 batches of 8 seeded images of mixed sizes through
    ``DetectionPredictor`` at imgsz 640, once with soft and once with hard
    NMS, with every launch counter set to 0 just before and read just after
    (1 K5 per soft batch, 1 K2 per hard batch), and report the median batch
    time and its spread;
 7. run one batch through the same weights on the CPU with the plain versions
    and compare raw maps, the decode of the card's maps (K1 on the card, the
    plain version on the CPU) and hard-NMS detections; a second card forward
    of the batch (``model.predict``) reported beside, not gated (cuDNN may
    choose convolution algorithms whose sums differ from call to call);
 8. validate LD-P2 with ``DetectionValidator`` on 4 seeded labelled batches of
    8 at 640 (``ori_shape`` 640 x 640, ``ratio_pad`` (1, 0, 0)), soft-NMS in
    quirk mode and then hard NMS, counters at 0 just before each run and read
    just after (exactly 3 K1 and 10 K3 per forward, 1 K5 per soft batch, 1 K2
    per hard batch), and report img/s and the per-batch median and spread;
    hold K5 against its plain version on each batch's own candidate pools
    (multi-label, K = 4,096, quirk on and off) and on made-up pools (K = 1, a
    ragged K = 1,000, K = 4,096 and 8,192, duplicates, IoUs at the threshold,
    a decay onto the 0.25 floor, an image with none valid, the quirk's first
    box in the last slot, a trained-like pool with 5% of its scores above the
    floor, IoUs one float32 spacing from the threshold, a pool in which every
    box overlaps every other): identical kept sets, scores within 1e-6
    relative, every output bit-equal;
    the stats through K5 must equal those of the same maps through the plain
    loop on the card; time K5 on the first batch's pool beside its bound (the
    chain of steps the busiest image takes);
 9. take one training step (``DetectionTrainer.train_step``, batch 8 at 640,
    seeded labelled batches) and capture, through hooks, each LDConv's source,
    offsets and incoming gradient and each level's Detect map, decoded
    distances and incoming gradient; hold the K1 and K3 backward kernels
    against their plain versions on them (and K3's on phase 5's random
    offsets, on offsets that put 90% of each layer's samples on sixteen
    source positions and on seam offsets, whose neighbouring pixels' cells
    follow each other across images and sampling points; also the same ten
    layers at imgsz 608, where several have h*w no multiple of 32 and split
    their channels unevenly over threads, on random, contention and seam
    offsets), each output of each level or layer (K3's ``dx`` and
    ``doff`` apart) within 1e-5 of its own largest plain value (on the
    contention offsets K3's error and the plain version's against a plain
    version that sums in float64 reported beside), and K3's forward
    bit-equal to its plain version on the 608 layers; time them
    as phase 5 times the forwards (K3's device time summing every launch of
    its wrapper, the zero fill of ``dx`` included, also layer by layer), with
    ``F.grid_sample``'s backward as K3's yardstick;
10. take 20 timed training steps (CIoU) after 3 warm-up steps, 4 distinct
    seeded batches in turn, with every launch counter set to 0 just before and
    read just after (exactly 3 K1, 3 K1-backward, 10 K3 and 10 K3-backward
    launches per step); every loss and gradient finite, parameters and EMA
    moved;
11. take one step from the same weights and batch at 320, batch 2, on the card
    and on the CPU (plain versions), with warmup off and ``nbs`` equal to the
    batch, so that the step fires at once with the full LR of every group,
    once with CIoU and once with the paper's recipe (Wise-IoU v3, NWD,
    ``iou_ratio`` 0.5): identical foreground count, losses within 1e-4
    relative, every parameter's gradient, momentum buffer (clipped gradient
    plus weight decay) and update within 1e-3 relative L2 (an absolute floor
    of 1e-6 under a norm of 1e-5; an update also gets one f32 spacing of each
    new parameter, since each side rounds p + update once), and with the
    recipe the new ``iou_mean`` within 1e-6 relative;
12. build ``yolov8-C2f-VSS.yaml`` (n scale, nc=6: ten VSS blocks) on the card
    from the same seeds, SS2D's own init kept, and run phase 4's batch to
    take the selective-scan calls of every block as SS2D makes them: ten
    calls of K4, each covering a block's four scan directions (40 scans per
    forward) on two unreversed sequences, with the reverse flags, the
    direction-to-source index, and ``B`` and ``C`` as strided views;
13. hold K4 against its plain version on one block's call at each of the
    four pyramid levels (L = 25,600, 6,400, 1,600, 400), on random inputs of
    the same shapes and at a ragged L = 1,003 (``dt`` a softplus of a normal,
    ``A`` minus the exp of a normal and ``D`` per direction, two of four
    directions reversed, ``B`` and ``C`` views of a tensor with rows of 33
    floats: the seeded ``dt`` sits near 0.01 and its ``A`` and ``D`` are the
    same for every direction), every direction within 1e-5 of its own
    largest plain value; time one forward's ten calls (median of 20) and
    their plain versions (median of 3: each walks up to 25,600 steps in
    Python), and each level's call alone;
14. serve 20 batches of 8 through ``DetectionPredictor`` on the VSS model, soft
    then hard NMS, counters at 0 just before and read just after: exactly 10
    K4 and 3 K1 launches per forward, 1 K5 per soft batch, 1 K2 per hard
    batch, no K3;
15. run 2 images of that batch through the same weights on the CPU (plain
    versions) and compare raw maps and hard-NMS detections as phase 7 does;
16. build ``yolov8.yaml`` and ``yolov8-ASF-P2P2.yaml`` (n scale) on the card and
    push one batch through each: finite raw maps of the expected shapes,
    strides 8/16/32 and 4/8/16;
17. print a ``{"kernel_detail": ...}``, a ``{"served": ...}``, a ``{"trained":
    ...}``, a ``{"served_vss": ...}`` and a ``{"validated": ...}`` line, then
    the ``{"kernels": [...]}`` line for the seven kernels, the card's name and
    power limit, and last ``{"ok": true, "device": {...}}``.

It exits non-zero and prints no result without a CUDA device, or when the
package is not beside it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CFG = "yolov8-LD-P2.yaml"
VSS_CFG = "yolov8-C2f-VSS.yaml"
PLAIN_CONV_CFGS = {"yolov8.yaml": (8, 16, 32), "yolov8-ASF-P2P2.yaml": (4, 8, 16)}  # config -> expected strides
IMGSZ, BATCH, SEED = 640, 8, 0
N_IMAGES, SERVE_BATCHES = 32, 20  # 4 distinct batches of seeded images, served in turn
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_BATCHES = 20, 3, 4  # timed steps, warm-up steps, distinct seeded batches
CMP_IMGSZ, CMP_BATCH = 320, 2  # the card-versus-CPU training step
VSS_CMP_BATCH = 2  # the VSS card-versus-CPU batch: the CPU walks 25,600 scan steps one by one
PLAIN_SCAN_RUNS = 3  # timed runs of K4's plain version: one forward's ten scans walk 76,800 steps in Python
K4_RTOL = 1e-5  # K4 vs plain: each direction's max abs error over that direction's largest plain value
BWD_RTOL = 1e-5  # backward kernels vs plain: max abs error over each output's largest plain value (atomics' order)
RAGGED_IMGSZ = 608  # K3's backward is also held at this size: LDConv outputs of 76 x 76 and 38 x 38 pixels
CONF, IOU = 0.25, 0.7
RUNS, WARMUP = 20, 3
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# and f32 operations/s outside the tensor cores (none of these kernels uses them).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K2's bound is the largest of three: the IoU arithmetic of every pair (i, j > i) over the f32 rate, its
# bytes over HBM, and the chain of keep/suppress decisions of the image with most valid candidates, which
# depend on each other in score order and cost at least the latency of one dependent register operation
# each (4 clocks on Hopper), at the SXM part's 1.98 GHz. The bound stated for the earlier one-block-per-image
# design, kept beside it, was that design's own cost: a shared-memory round trip (about 30 clocks) per
# candidate and one more per kept box.
SM_CLOCK_HZ = 1.98e9
DEPENDENT_OP_CLOCKS = 4
IOU_OPS = 14  # 2 min, 2 max, 2 sub, 2 clamps, 3 mul/add/sub for inter and union, + eps, the division, the compare
SMEM_ROUND_TRIP_CLOCKS = 30  # the earlier design's bound's assumption
RAGGED_SCAN_LENGTH = 1003  # K4 also at a length that is no multiple of its chunk (48 here) or its 8-step tile
VAL_BATCHES = 4  # seeded labelled batches of the val phase
K5_RTOL = 1e-6  # K5 vs plain: kept scores' relative error (the same rounded operations: bit-equal, also gated)
VAL_PROTOCOLS = {"soft-quirk": {"nms_type": "soft", "soft_nms_quirk": True},  # PARITY.md's protocol
                 "hard": {"nms_type": "hard", "soft_nms_quirk": False}}
RECIPE = {"use_wiseiou": True, "wiou_ltype": "WIoU", "nwd": True, "iou_ratio": 0.5}  # EXPERIMENTS.md's box loss


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int = RUNS, warmup: int = WARMUP) -> float:
    """Median milliseconds of ``fn`` on the card: CUDA events around each of
    ``runs`` calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, per_call: int, runs: int = 5, span: str | None = None):
    """Device milliseconds per call of ``fn`` spent in CUDA kernels whose name
    holds ``span`` (by default ``kernel``; ``""``: every device event of the
    trace, a wrapper's fills included), from a ``torch.profiler`` trace that
    holds all ``runs * per_call`` launches of the kernels named ``kernel``
    (``per_call``: those one call launches); None if five traces in a row miss
    some (a trace now and then comes back without some of a kernel's events,
    and its sum would read low). Late in a long process a trace has been seen
    to drop its first kernel every time: a spin kernel, not timed, goes
    first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    span = kernel if span is None else span
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]
        launched = sum(e.count for e in events if kernel in e.key)
        if launched == runs * per_call:
            return sum(e.self_device_time_total for e in events if span in e.key) / runs / 1e3
        print(f"chip_smoke: a trace held {launched} of the {runs * per_call} launches of {kernel}: "
              f"{ {e.key[:60]: e.count for e in events} }", file=sys.stderr, flush=True)
    return None


def bound(nbytes: float, ops: float):
    """Least time (ms) the card could take: bytes over HBM rate or operations
    over the f32 rate, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_inputs(model, x):
    """One forward on batch ``x``: the Detect maps, each LDConv's (source,
    offsets, stride), and the NMS pool that the serving path hands to K1, K3
    and K2 or K5 (``soft_nms``'s arguments; K2 takes its boxes and valid)."""
    import torch

    from experiment_yolo_torch.nn.modules import LDConv
    from experiment_yolo_torch.ops.anchors import decode_detections
    from experiment_yolo_torch.utils.seeded import soft_nms_pools

    ld = []
    hooks = [m.register_forward_pre_hook(lambda m, a: ld.append((a[0], m.p_conv(a[0]), m.stride)))
             for m in model.modules() if isinstance(m, LDConv)]
    with torch.no_grad():
        feats = model(x)
    for h in hooks:
        h.remove()
    boxes, scores = decode_detections(feats, model.stride, model.nc, model.reg_max)
    return feats, ld, soft_nms_pools(boxes, scores, val=False)[""][0]


def check_k1(feats):
    import torch

    # the kernel's own wrapper, without the autograd.Function around it
    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_fwd as dfl_decode
    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_plain

    err = max((a - b).abs().max().item() for a, b in
              zip([dfl_decode(f) for f in feats], [dfl_decode_plain(f) for f in feats]))
    # a cross-group logit spread far past exp's range must stay finite
    spread = feats[-1].clone()
    spread[:, 0:16, 0, 0] += 200.0
    spread[:, 16:32, 0, 0] -= 200.0
    got, want = dfl_decode(spread), dfl_decode_plain(spread)
    check(bool(torch.isfinite(got).all()), "K1 dfl_decode: non-finite output under a +-200 logit spread")
    err = max(err, (got - want).abs().max().item())
    torch.cuda.synchronize()
    check(err <= 1e-5, f"K1 dfl_decode disagrees with its plain version: max abs err {err}")
    ms = cuda_ms(lambda: [dfl_decode(f) for f in feats])
    dev_ms = device_ms(lambda: [dfl_decode(f) for f in feats], "dfl_decode_kernel", len(feats))
    plain_ms = cuda_ms(lambda: [dfl_decode_plain(f) for f in feats])
    groups = sum(f.shape[0] * f.shape[2] * f.shape[3] * 4 for f in feats)
    nbytes = groups * 16 * 4 + groups * 4  # 16 bins read, one distance written, f32
    b_ms, b_by = bound(nbytes, groups * (6 * 16 + 1))  # max, sub, exp, 2 sums (3 ops), one division
    return dict(name="dfl_decode", route="cuda", source="experiment_yolo_torch/csrc/dfl_decode.cu",
                replaces="experiment_yolo_tpu/ops/pallas/dfl_decode.py:46", max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def made_up_candidates(gen):
    """K2's made-up cases, each (boxes (B, K, 4), valid (B, K), threshold):
    clustered candidates at a ragged K = 1,000 and at the largest K, 8,192;
    exact duplicates; pairs whose float32 IoU is exactly 0.7, 0.8 or 0.6
    (small integers: 7/10 ties with the threshold and must not suppress);
    invalid candidates interleaved with valid ones; an image with no valid
    candidate."""
    import torch

    def clustered(b, k):
        centres = (torch.rand(b, k // 8 + 1, 2, generator=gen) * 600).repeat_interleave(8, 1)[:, :k]
        centres = centres + torch.randn(b, k, 2, generator=gen) * 6
        wh = torch.rand(b, k, 2, generator=gen) * 50 + 10
        return torch.cat([centres - wh / 2, centres + wh / 2], -1).contiguous()

    def some_valid(b, k):
        return torch.rand(b, k, generator=gen) > 0.2

    dup = clustered(2, 512)
    dup[:, 1::2] = dup[:, 0::2]
    x0 = 20.0 * torch.arange(300, dtype=torch.float32)
    inner = torch.tensor([7.0, 8.0, 6.0]).repeat(100)
    zero, one = torch.zeros(300), torch.ones(300)
    ties = torch.stack([torch.stack([x0, zero, x0 + 10, one], -1), torch.stack([x0, zero, x0 + inner, one], -1)], 1)
    ties = torch.stack([ties.reshape(600, 4), ties[torch.randperm(300, generator=gen)].reshape(600, 4)])
    interleaved = some_valid(2, 1024)
    interleaved[:, 1::2] = False
    none = some_valid(2, 1024)
    none[1] = False
    return {"ragged K=1000": (clustered(3, 1000), some_valid(3, 1000), IOU),
            "K=8192": (clustered(2, 8192), some_valid(2, 8192), IOU),
            "duplicates": (dup, some_valid(2, 512), IOU),
            "IoU at the threshold": (ties.contiguous(), torch.ones(2, 600, dtype=torch.bool), 0.7),
            "interleaved invalid": (clustered(2, 1024), interleaved, 0.5),
            "an image with no valid candidate": (clustered(2, 1024), none, 0.5)}


def k2_bound(valid, k: int):
    """(least ms, what bounds it, the three times) for a batch of K = ``k``
    candidates per image: pair arithmetic, bytes, the longest chain."""
    pairs = valid.shape[0] * k * (k - 1) / 2
    times = {"pairs_ms": pairs * IOU_OPS / F32_OPS_PER_S * 1e3,
             "bytes_ms": valid.numel() * (16 + 1 + 1) / HBM_BYTES_PER_S * 1e3,  # boxes, valid read; keep written
             "chain_ms": int(valid.sum(1).max()) * DEPENDENT_OP_CLOCKS / SM_CLOCK_HZ * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "bytes" if worst == "bytes_ms" else "operations", times


def check_k2(shifted, valid):
    import torch

    from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress, nms_suppress_plain

    keep, want = nms_suppress(shifted, valid, IOU), nms_suppress_plain(shifted, valid, IOU)
    torch.cuda.synchronize()
    mismatched = int((keep != want).sum())
    check(mismatched == 0, f"K2 nms_suppress: {mismatched} keep flags differ from its plain version")
    check(bool(want.any()) and bool((valid & ~want).any()), "K2 inputs neither keep nor suppress: no real work")
    made_up = {}
    for label, (boxes, ok, thr) in made_up_candidates(torch.Generator().manual_seed(SEED + 5)).items():
        boxes, ok = boxes.cuda(), ok.cuda()
        got, ref = nms_suppress(boxes, ok, thr), nms_suppress_plain(boxes, ok, thr)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        check(bad == 0, f"K2 nms_suppress: {bad} keep flags differ from its plain version on the {label} case")
        made_up[label] = {"K": boxes.shape[1], "images": boxes.shape[0], "kept": int(ref.sum()),
                          "valid": int(ok.sum()), "mismatched": bad,
                          "device_ms": device_ms(lambda: nms_suppress(boxes, ok, thr), "nms_suppress_kernel", 2)}
    check(made_up["IoU at the threshold"]["kept"] == 1000, "K2's tie case should keep the 7/10 and 6/10 pairs whole")
    ms = cuda_ms(lambda: nms_suppress(shifted, valid, IOU))
    dev_ms = device_ms(lambda: nms_suppress(shifted, valid, IOU), "nms_suppress_kernel", 2)  # pairs, chain
    plain_ms = cuda_ms(lambda: nms_suppress_plain(shifted, valid, IOU))
    b_ms, b_by, parts = k2_bound(valid, shifted.shape[1])
    old_clocks = int(((valid.sum(1) + want.sum(1)) * SMEM_ROUND_TRIP_CLOCKS).max())
    return dict(name="nms_suppress", route="cuda", source="experiment_yolo_torch/csrc/nms_suppress.cu",
                replaces="experiment_yolo_tpu/ops/pallas/nms_kernel.py:26", max_abs_err=float(mismatched), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                kept=int(want.sum()), candidates=int(valid.sum()), bound_parts=parts,
                bound_assumption=f"largest of: {IOU_OPS} f32 operations per pair (i, j > i) over "
                                 f"{F32_OPS_PER_S / 1e12:g} TFLOP/s; 18 bytes per candidate over HBM; the image "
                                 f"with most valid candidates deciding them one after another at "
                                 f"{DEPENDENT_OP_CLOCKS} clocks (one dependent register operation) each, "
                                 f"{SM_CLOCK_HZ / 1e9} GHz",
                old_design_bound_ms=old_clocks / SM_CLOCK_HZ * 1e3,
                old_design_bound_assumption=f"one block per image: {SMEM_ROUND_TRIP_CLOCKS} clocks per candidate plus "
                                            f"{SMEM_ROUND_TRIP_CLOCKS} per kept box, longest image",
                made_up=made_up)


def _random_offsets_like(o, gen):
    import torch

    r = torch.randn(o.shape, generator=gen) * 4
    far = torch.rand(o.shape, generator=gen) < 0.02
    return torch.where(far, r + 40 * r.sign(), r).to(o.device)


def random_offsets(ld):
    """The seeded model's offset convs keep the reference init (zero weights),
    so the main path's offsets are one value per channel. The kernels are
    also held on offsets that vary by pixel and image: N(0, 4^2) px, and 2%
    of them pushed 40 px further, far outside the source."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 2)
    return [(x, _random_offsets_like(o, gen), s) for x, o, s in ld]


def grid_sample_grids(layers):
    """``F.grid_sample``'s grids (B, hw, N, [x, y]) for the LDConv positions
    of each (source, offsets, stride): border clamp, no border double count."""
    import torch

    from experiment_yolo_torch.ops.kernels.ldconv_gather import grid_points

    out = []
    for x, o, s in layers:
        b, n2, h, w = o.shape
        n, (hx, wx) = n2 // 2, x.shape[2:]
        pts = torch.tensor(grid_points(n), dtype=torch.float32, device=x.device)
        o = o.reshape(b, 2, n, h * w).permute(0, 3, 2, 1)  # (B, hw, N, [row, col])
        rows = (torch.arange(h, device=x.device, dtype=torch.float32) * s)[:, None].expand(h, w).reshape(1, -1, 1)
        cols = (torch.arange(w, device=x.device, dtype=torch.float32) * s)[None, :].expand(h, w).reshape(1, -1, 1)
        pr, pc = rows + pts[:, 0] + o[..., 0], cols + pts[:, 1] + o[..., 1]
        out.append(torch.stack([pc / (wx - 1) * 2 - 1, pr / (hx - 1) * 2 - 1], -1))
    return out


def check_k3(ld, rand_ld):
    import torch.nn.functional as F

    # the kernel's own wrapper, without the autograd.Function around it
    from experiment_yolo_torch.ops.kernels.ldconv_gather import ldconv_gather_fwd as ldconv_gather
    from experiment_yolo_torch.ops.kernels.ldconv_gather import ldconv_gather_plain

    got = [ldconv_gather(x, o, s) for x, o, s in ld]
    err = max((a - ldconv_gather_plain(x, o, s)).abs().max().item() for a, (x, o, s) in zip(got, ld))
    check(err <= 1e-5, f"K3 ldconv_gather disagrees with its plain version: max abs err {err}")
    rand_err = max((ldconv_gather(x, o, s) - ldconv_gather_plain(x, o, s)).abs().max().item() for x, o, s in rand_ld)
    check(rand_err <= 1e-5, f"K3 ldconv_gather disagrees with its plain version on random offsets: {rand_err}")

    def library(layers, gs):
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True)
                for (x, _, _), g in zip(layers, gs)]

    def kernel(layers):
        return [ldconv_gather(x, o, s) for x, o, s in layers]

    ms = cuda_ms(lambda: kernel(ld))
    dev_ms = device_ms(lambda: kernel(ld), "ldconv_gather_kernel", len(ld))
    plain_ms = cuda_ms(lambda: [ldconv_gather_plain(x, o, s) for x, o, s in ld])
    main_grids, rand_grids = grid_sample_grids(ld), grid_sample_grids(rand_ld)
    library_ms = cuda_ms(lambda: library(ld, main_grids))
    # ten calls cost the host more than the card, for the kernel and for the library: their device times beside them
    library_device_ms = device_ms(lambda: library(ld, main_grids), "grid_sampler", len(ld))
    random = {"max_abs_err": rand_err, "ms": cuda_ms(lambda: kernel(rand_ld)),
              "device_ms": device_ms(lambda: kernel(rand_ld), "ldconv_gather_kernel", len(ld)),
              "library_ms": cuda_ms(lambda: library(rand_ld, rand_grids)),
              "library_device_ms": device_ms(lambda: library(rand_ld, rand_grids), "grid_sampler", len(ld))}
    nbytes = ops = 0
    layers = []
    for (x, o, s), (_, ro, _), y in zip(ld, rand_ld, got):
        b, n2, h, w = o.shape
        cost = ((x.numel() + o.numel() + y.numel()) * 4,
                y.numel() * 9 + b * h * w * (n2 // 2) * 24)  # 4 products, 3 sums, 2 scalings; positions and weights
        nbytes, ops = nbytes + cost[0], ops + cost[1]
        layers.append({"shape": f"{tuple(x.shape)}->{tuple(y.shape)}", "stride": s,
                       "device_ms": device_ms(lambda: ldconv_gather(x, o, s), "ldconv_gather_kernel", 1),
                       "random_device_ms": device_ms(lambda: ldconv_gather(x, ro, s), "ldconv_gather_kernel", 1),
                       "bound_ms": bound(*cost)[0]})
    b_ms, b_by = bound(nbytes, ops)
    shapes = [row["shape"] for row in layers]
    return dict(name="ldconv_gather", route="cuda", source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                replaces="experiment_yolo_tpu/ops/pallas/ldconv_kernel.py:29", max_abs_err=max(err, rand_err),
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                main_path_max_abs_err=err, library_device_ms=library_device_ms, random_offsets=random, shapes=shapes,
                layers=layers)


def k5_bound(out, k: int):
    """(least ms, what bounds it, the two times) of soft-NMS on one batch whose
    plain output is ``out`` (B, K): each image runs one step per kept box and
    one more that does not keep (at most min(300, K)), and each step needs
    ceil(log2 K) dependent compares for its argmax at 4 clocks each; the
    busiest image bounds the batch. Its bytes (boxes, scores and flags read,
    scores written: 25 per candidate) beside it."""
    steps = int(((out > -1).sum(1) + 1).clamp(max=min(300, k)).max())
    times = {"chain_ms": steps * math.ceil(math.log2(max(k, 2))) * DEPENDENT_OP_CLOCKS / SM_CLOCK_HZ * 1e3,
             "bytes_ms": out.numel() * 25 / HBM_BYTES_PER_S * 1e3}
    worst = max(times, key=times.get)
    return times[worst], "operations" if worst == "chain_ms" else "bytes", times, steps


def check_k5(pools, serve_pool):
    """K5 against its plain version on the val batches' own pools
    (``pools``: (label, args, kw) with args (boxes, scores, valid, iou_thres,
    max_det)) and on made-up pools, each with and without the quirk:
    identical kept sets, kept scores within K5_RTOL relative, and every
    output bit-equal (the same rounded operations). Timed on the
    first val pool, beside its bound; the serving path's pool (K = 1,024, one
    label per anchor) timed too."""
    import torch

    from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms, soft_nms_plain
    from experiment_yolo_torch.utils.seeded import soft_nms_cases

    def held(label, args, kw):
        got, want = soft_nms(*args, **kw), soft_nms_plain(*args, **kw)
        torch.cuda.synchronize()
        kept = want > -1
        check(bool(((got > -1) == kept).all()), f"K5 soft_nms: kept sets differ from its plain version on {label}")
        rel = ((got - want).abs()[kept] / want[kept].abs()).max().item() if bool(kept.any()) else 0.0
        check(rel <= K5_RTOL, f"K5 soft_nms: kept scores differ from its plain version by {rel} relative on {label}")
        check(torch.equal(got, want), f"K5 soft_nms: not bit-equal to its plain version on {label}")
        return {"K": args[0].shape[1], "images": args[0].shape[0], "kept": int(kept.sum()),
                "valid": int(args[2].sum()), "max_abs_err": (got - want).abs().max().item(), "rel_err": rel,
                "bit_equal": True}

    main = {label: held(label, args, kw) for label, args, kw in pools}
    made_up = {}
    for label, (boxes, scores, valid, thr, first_idx, n_valid) in soft_nms_cases(SEED + 6, "cuda").items():
        for quirk in (False, True):
            kw = {"first_idx": first_idx, "n_valid": n_valid} if quirk else {}
            row = held(f"the {label} case" + (" (quirk)" if quirk else ""), (boxes, scores, valid, thr, 300), kw)
            row["device_ms"] = device_ms(lambda: soft_nms(boxes, scores, valid, thr, 300, **kw),
                                         "soft_nms_kernel", 1)
            made_up[label + (" quirk" if quirk else "")] = row
    label, args, kw = pools[0]
    ms = cuda_ms(lambda: soft_nms(*args, **kw))
    dev_ms = device_ms(lambda: soft_nms(*args, **kw), "soft_nms_kernel", 1)
    out = soft_nms_plain(*args, **kw)
    plain_ms = cuda_ms(lambda: soft_nms_plain(*args, **kw))
    b_ms, b_by, parts, steps = k5_bound(out, args[0].shape[1])
    s_out = soft_nms_plain(*serve_pool)
    serve = {"K": serve_pool[0].shape[1], "kept": int((s_out > -1).sum()), "ms": cuda_ms(lambda: soft_nms(*serve_pool)),
             "device_ms": device_ms(lambda: soft_nms(*serve_pool), "soft_nms_kernel", 1),
             "plain_ms": cuda_ms(lambda: soft_nms_plain(*serve_pool)),
             "bound_ms": k5_bound(s_out, serve_pool[0].shape[1])[0],
             **{k: v for k, v in held("the serving pool", serve_pool, {}).items() if k in ("rel_err", "bit_equal")}}
    rows = (*main.values(), *made_up.values())
    err, rel = max(r["max_abs_err"] for r in rows), max(r["rel_err"] for r in rows)
    return dict(name="soft_nms", route="cuda", source="experiment_yolo_torch/csrc/soft_nms.cu",
                replaces="experiment_yolo_tpu/ops/nms.py:129", max_abs_err=err, rel_err=rel, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, timed_on=label,
                bound_parts=parts, bound_steps=steps,
                bound_assumption=f"the busiest image's {steps} steps (kept boxes and the one that stops), each "
                                 f"ceil(log2 K) dependent compares at {DEPENDENT_OP_CLOCKS} clocks, "
                                 f"{SM_CLOCK_HZ / 1e9} GHz; 25 bytes per candidate over HBM",
                main_path_pools=main, made_up=made_up,
                serving_pool=serve, library="none: no single PyTorch call computes soft-NMS")


def val_batches(nc: int):
    """VAL_BATCHES seeded labelled batches of BATCH at IMGSZ in the val
    loader's format: letterboxed at gain 1 and no pad."""
    import numpy as np

    from experiment_yolo_torch.utils.seeded import VAL_SEED, seeded_batch

    extra = {"ori_shape": np.full((BATCH, 2), IMGSZ, np.int32),
             "ratio_pad": np.tile(np.float32([1.0, 0.0, 0.0]), (BATCH, 1))}
    return [{**seeded_batch(BATCH, IMGSZ, SEED + VAL_SEED + i, nc=nc), **extra} for i in range(VAL_BATCHES)]


def validate_timed(model, batches, counters, card):
    """``DetectionValidator`` with soft-NMS in quirk mode and with hard NMS,
    every launch counter at 0 just before each run and read just after; the
    time of each batch is taken between the validator's requests for the
    next one (forward, NMS, copy to the host, matching). Returns the results
    per protocol and the launches of both runs."""
    import torch

    from experiment_yolo_torch import DetectionValidator

    out, launches = {}, dict.fromkeys(counters, 0)
    n = len(batches)
    for label, args in VAL_PROTOCOLS.items():
        validator = DetectionValidator(args)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        stamps = []

        def timed():
            for b in batches:
                stamps.append(time.perf_counter())
                yield b

        stats = validator(model, timed(), model.names)
        stamps.append(time.perf_counter())
        run = {name: fn.launches for name, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update(dfl_decode=3 * n, ldconv_gather=10 * n)
        want["soft_nms" if args["nms_type"] == "soft" else "nms_suppress"] = n
        check(run == want, f"the {label} val main path launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        batch_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        median_ms = statistics.median(batch_ms)
        out[label] = {"stats": stats, "batches": n, "batch_ms": batch_ms, "batch_ms_median": median_ms,
                      "batch_ms_min": min(batch_ms), "batch_ms_max": max(batch_ms),
                      "img_per_s_at_median": BATCH / median_ms * 1e3,
                      "img_per_s_overall": n * BATCH / sum(batch_ms) * 1e3, "launches": run}
        log(f"validated {CFG} {label}: {n} batches of {BATCH} at {IMGSZ}: median {median_ms:.2f} ms per batch (min "
            f"{min(batch_ms):.2f}, max {max(batch_ms):.2f}), {out[label]['img_per_s_at_median']:.2f} img/s at the "
            f"median, stats {stats}, launches {run}, {card}")
    return out, launches


def val_pools_and_plain_stats(model, batches):
    """Each val batch's decoded maps once: its soft-NMS pools (multi-label,
    K = 4,096 at conf 0.001, quirk on and off) for K5's check, and the
    validator's soft-quirk stats with K5 and with the plain loop on those
    same maps, which must be equal."""
    import torch

    import experiment_yolo_torch.ops.nms as nms
    from experiment_yolo_torch import DetectionValidator
    from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms, soft_nms_plain
    from experiment_yolo_torch.utils.metrics import DetMetrics
    from experiment_yolo_torch.utils.seeded import model_input, soft_nms_pools

    validator = DetectionValidator({**VAL_PROTOCOLS["soft-quirk"], "verbose": False})
    metrics = {"kernel": DetMetrics(), "plain": DetMetrics()}
    counts = {"kernel": [], "plain": []}
    pools = []
    for i, b in enumerate(batches):
        with torch.no_grad():
            boxes, scores = model.predict(model_input(b["img"], "cuda"))  # as infer does
        for kind, fn in (("kernel", soft_nms), ("plain", soft_nms_plain)):
            nms.soft_nms = fn
            try:
                det, n = (t.cpu().numpy() for t in validator.nms(boxes, scores))
            finally:
                nms.soft_nms = soft_nms
            validator.score_batch(metrics[kind], det, n, b)
            counts[kind] += n.tolist()
        pools += [(f"val batch {i}{quirk}", args, kw)
                  for quirk, (args, kw) in soft_nms_pools(boxes, scores, val=True).items()]
    stats = {kind: m.result() for kind, m in metrics.items()}
    check(counts["kernel"] == counts["plain"], f"val detections per image with K5 {counts['kernel']}, plain loop "
                                               f"{counts['plain']}")
    check(stats["kernel"] == stats["plain"], f"val stats with K5 {stats['kernel']} != plain loop {stats['plain']}")
    return pools, {"stats_with_k5": stats["kernel"], "stats_with_plain_loop": stats["plain"],
                   "detections_per_image": counts["kernel"]}


def capture_train_inputs(trainer, batch):
    """One training step with hooks on the two differentiable kernels: each
    LDConv's (source, offsets, stride, incoming gradient) and each level's
    (Detect map, decoded distances, incoming gradient), as the step hands
    them to K3, K1 and their backward kernels. Separate from
    :func:`capture_inputs`, which runs under ``no_grad``."""
    import experiment_yolo_torch.nn.modules as modules
    import experiment_yolo_torch.utils.loss as loss

    ld, levels = [], []
    gather, decode = modules.ldconv_gather, loss.dfl_decode

    def keep_grad(out, entry):
        out.register_hook(lambda g: entry.append(g.detach().contiguous().clone()))

    def gather_hook(x, off, stride):
        out = gather(x, off, stride)
        ld.append([x.detach(), off.detach(), stride])
        keep_grad(out, ld[-1])
        return out

    def decode_hook(feat, reg_max=16):
        out = decode(feat, reg_max)
        levels.append([feat.detach(), out.detach()])
        keep_grad(out, levels[-1])
        return out

    modules.ldconv_gather, loss.dfl_decode = gather_hook, decode_hook
    try:
        trainer.train_step(batch)
    finally:
        modules.ldconv_gather, loss.dfl_decode = gather, decode
    check(len(ld) == 10 and all(len(e) == 4 for e in ld), f"captured {len(ld)} LDConv backward inputs, expected 10")
    check(len(levels) == 3 and all(len(e) == 3 for e in levels), f"captured {len(levels)} decode levels, expected 3")
    return [tuple(e) for e in ld], [tuple(e) for e in levels]


def _rel_err(got, want):
    """(max abs error, and the worst of each pair's max abs error over that
    pair's own largest plain value) of tensor pairs, so that every output of
    every layer is held on its own scale."""
    errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    return max(errs), max(e / max(b.abs().max().item(), 1e-30) for e, b in zip(errs, want))


def check_k1_bwd(levels):
    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_bwd, dfl_decode_bwd_plain

    def kernel():
        return [dfl_decode_bwd(f, y, g) for f, y, g in levels]

    def plain():
        return [dfl_decode_bwd_plain(f, y, g) for f, y, g in levels]

    err, rel = _rel_err(kernel(), plain())
    check(rel <= BWD_RTOL, f"K1 dfl_decode_bwd disagrees with its plain version: max abs err {err} ({rel} relative)")
    groups = sum(f.shape[0] * f.shape[2] * f.shape[3] * 4 for f, _, _ in levels)
    no = levels[0][0].shape[1]
    # per anchor: 64 box logits, y and g (4 each) read; the whole dx map (no channels) written
    nbytes = sum(f.shape[0] * f.shape[2] * f.shape[3] * (64 + 4 + 4 + no) * 4 for f, _, _ in levels)
    b_ms, b_by = bound(nbytes, groups * 16 * 10)  # per bin: max, 2 exps and subs, sum, then p*g*(r-y)
    return dict(name="dfl_decode_bwd", route="cuda", source="experiment_yolo_torch/csrc/dfl_decode.cu",
                replaces="experiment_yolo_tpu/ops/pallas/dfl_decode.py:53", max_abs_err=err, rel_err=rel,
                ms=cuda_ms(kernel), device_ms=device_ms(kernel, "dfl_decode_bwd_kernel", len(levels)),
                plain_ms=cuda_ms(plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shapes=[f"{tuple(f.shape)}->{tuple(f.shape)}" for f, _, _ in levels])


def check_k3_bwd(ld, rand_ld):
    """K3's backward against its plain version on one training step's inputs,
    on phase 5's random offsets, on contention offsets (90% of each layer's
    samples on sixteen source positions) and on seam offsets, and on the same
    layers at RAGGED_IMGSZ on random, contention and seam offsets, each
    output (``dx``, ``doff``) of each layer within BWD_RTOL of its own largest
    plain value; on the contention offsets the kernel's and the plain
    version's errors against the plain version summed in float64 are
    reported beside that gate. K3's forward is held bit-equal to its plain
    version on the RAGGED_IMGSZ layers. Device times sum every launch the
    wrapper makes, the zero fill of ``dx`` included; also layer by layer
    beside each layer's bytes bound."""
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.ldconv_gather import (ldconv_gather_bwd, ldconv_gather_bwd_plain,
                                                                 ldconv_gather_fwd, ldconv_gather_plain)
    from experiment_yolo_torch.utils.seeded import contention_offsets, seam_offsets

    bwd_kernel = "ldconv_gather_bwd_kernel"  # timed with every event of its calls: dx's fill, a memset of doff

    def kernel(layers):
        return [t for x, o, dy, s in layers for t in ldconv_gather_bwd(x, o, dy, s)]

    def plain(layers):
        return [t for x, o, dy, s in layers for t in ldconv_gather_bwd_plain(x, o, dy, s)]

    main = [(x, o, dy, s) for x, o, s, dy in ld]
    gen = torch.Generator().manual_seed(SEED + 3)
    rand = [(x, o, torch.randn(dy.shape, generator=gen).to(dy.device), s)
            for (x, o, s), (_, _, _, dy) in zip(rand_ld, ld)]
    contended = [(x, contention_offsets(x, o, s, gen), dy, s) for x, o, dy, s in rand]
    seam = [(x, seam_offsets(x, o, s), dy, s) for x, o, dy, s in rand]
    # the same layers at RAGGED_IMGSZ: every source and output side scaled, random sources and gradients
    ragged = []
    for x, o, dy, s in main:
        b, c, hx, wx = x.shape
        hx, wx = hx * RAGGED_IMGSZ // IMGSZ, wx * RAGGED_IMGSZ // IMGSZ
        o = torch.empty(b, o.shape[1], hx // s, wx // s, device=o.device)
        ragged.append((torch.randn(b, c, hx, wx, generator=gen).to(x.device), _random_offsets_like(o, gen),
                       torch.randn(b, o.shape[2] * o.shape[3], dy.shape[2], generator=gen).to(dy.device), s))
    fwd = [(ldconv_gather_fwd(x, o, s), ldconv_gather_plain(x, o, s)) for x, o, _, s in ragged]
    fwd_err = max((a - b).abs().max().item() for a, b in fwd)
    check(all(torch.equal(a, b) for a, b in fwd),
          f"K3 ldconv_gather is not bit-equal to its plain version at imgsz {RAGGED_IMGSZ}: max abs err {fwd_err}")
    del fwd
    errs, vs_f64 = {}, {}
    ragged_contended = [(x, contention_offsets(x, o, s, gen), dy, s) for x, o, dy, s in ragged]
    for kind, layers in (("main", main), ("random", rand), ("contention", contended), ("seam", seam),
                         (f"{RAGGED_IMGSZ} random", ragged), (f"{RAGGED_IMGSZ} contention", ragged_contended),
                         (f"{RAGGED_IMGSZ} seam", [(x, seam_offsets(x, o, s), dy, s) for x, o, dy, s in ragged])):
        got, want = kernel(layers), plain(layers)
        errs[kind] = _rel_err(got, want)
        check(errs[kind][1] <= BWD_RTOL, f"K3 ldconv_gather_bwd disagrees with its plain version on {kind} offsets: "
                                         f"{errs[kind][0]} ({errs[kind][1]} relative)")
        if "contention" in kind:  # reported, not gated: how far each float32 order is from float64 sums
            exact = [t for x, o, dy, s in layers for t in ldconv_gather_bwd_plain(x, o, dy, s, torch.float64)]
            vs_f64[kind] = {"kernel": _rel_err(got, exact), "plain": _rel_err(want, exact)}
            del exact

    # F.grid_sample's backward on the same positions and incoming gradients
    grids = grid_sample_grids([(x, o, s) for x, o, _, s in main])
    xs = [x.clone().requires_grad_() for x, _, _, _ in main]
    gs = [g.requires_grad_() for g in grids]
    outs = [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True) for x, g in zip(xs, gs)]
    dys = [dy.reshape(dy.shape[0], dy.shape[1], o.shape[1] // 2, -1).permute(0, 3, 1, 2).contiguous()
           for _, o, dy, _ in main]  # (B, C, hw, N), grid_sample's output layout
    library_ms = cuda_ms(lambda: torch.autograd.grad(outs, xs + gs, dys, retain_graph=True))

    def cost(x, o, dy):
        b, n2, h, w = o.shape
        return ((2 * x.numel() + 2 * o.numel() + dy.numel()) * 4,  # x, off, dy read; dx, doff written
                dy.numel() * 23 + b * h * w * (n2 // 2) * 30)  # per channel: d, 2 x 7 for the offsets, 4 + 4 scatter

    nbytes = ops = 0
    layers = []
    for i, (x, o, dy, s) in enumerate(main):
        nb, op = cost(x, o, dy)
        nbytes, ops = nbytes + nb, ops + op
        layers.append({"shape": f"{tuple(dy.shape)}->{tuple(x.shape)},{tuple(o.shape)}", "stride": s,
                       "device_ms": device_ms(lambda: ldconv_gather_bwd(x, o, dy, s), bwd_kernel, 1, span=""),
                       "random_device_ms": device_ms(lambda: ldconv_gather_bwd(*rand[i][:3], s), bwd_kernel, 1,
                                                     span=""),
                       "contention_device_ms": device_ms(lambda: ldconv_gather_bwd(*contended[i][:3], s), bwd_kernel,
                                                         1, span=""),
                       "bound_ms": bound(nb, op)[0]})
    b_ms, b_by = bound(nbytes, ops)
    err, rel = max(e for e, _ in errs.values()), max(r for _, r in errs.values())
    return dict(name="ldconv_gather_bwd", route="cuda", source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                replaces="experiment_yolo_tpu/nn/modules.py:469", max_abs_err=err, rel_err=rel,
                ms=cuda_ms(lambda: kernel(main)),
                device_ms=device_ms(lambda: kernel(main), bwd_kernel, len(main), span=""),
                plain_ms=cuda_ms(lambda: plain(main)), bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                main_path={"max_abs_err": errs["main"][0], "rel_err": errs["main"][1]},
                other_offsets={kind: {"max_abs_err": e, "rel_err": r} for kind, (e, r) in errs.items()
                               if kind not in ("main", "random", "contention")},
                ragged_shapes=[f"{tuple(dy.shape)}->{tuple(x.shape)},{tuple(o.shape)}" for x, o, dy, _ in ragged],
                forward_at_ragged_imgsz={"imgsz": RAGGED_IMGSZ, "bit_equal": True, "max_abs_err": fwd_err},
                contention_vs_float64={kind: {who: {"max_abs_err": e, "rel_err": r} for who, (e, r) in v.items()}
                                       for kind, v in vs_f64.items()},
                random_offsets={"max_abs_err": errs["random"][0], "rel_err": errs["random"][1],
                                "ms": cuda_ms(lambda: kernel(rand)),
                                "device_ms": device_ms(lambda: kernel(rand), bwd_kernel, len(rand), span="")},
                contention_offsets={"max_abs_err": errs["contention"][0], "rel_err": errs["contention"][1],
                                    "ms": cuda_ms(lambda: kernel(contended)),
                                    "device_ms": device_ms(lambda: kernel(contended), bwd_kernel, len(contended),
                                                           span="")},
                device_ms_counts="every launch of the wrapper, the zero fill of dx included", layers=layers)


def train_timed(trainer, batches, counters):
    """TRAIN_WARMUP steps, then TRAIN_STEPS timed steps (host clock around
    each step and a synchronize) with every launch counter at 0 just before;
    returns the step times, the launches and the last losses."""
    import torch

    model = trainer.state.model
    for i in range(TRAIN_WARMUP):
        trainer.train_step(batches[i % len(batches)])
    before = [t.detach().clone() for t in model.parameters()]
    ema_before = [t.detach().clone() for t in trainer.state.ema.ema.parameters()]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    step_ms, finite = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        comps = trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        finite.append(torch.stack([torch.isfinite(torch.stack([v.float() for v in comps.values()])).all()]
                                  + [torch.isfinite(g).all() for g in grads]).all())
        check(len(grads) == len(before), f"step {i}: {len(before) - len(grads)} parameters have no gradient")
    launches = {name: fn.launches for name, fn in counters.items()}
    check(bool(torch.stack(finite).all()), "a loss or a gradient of the timed steps is not finite")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    ema_moved = sum(not torch.equal(a, b) for a, b in zip(ema_before, trainer.state.ema.ema.parameters()))
    check(moved > 0 and ema_moved > 0, f"parameters moved {moved}, EMA moved {ema_moved}: expected both > 0")
    return step_ms, launches, {k: v.item() for k, v in comps.items()}, moved, ema_moved


def compare_train_cpu(state_dict, batch, recipe=None):
    """One step from the same weights and batch on the card and on the CPU.
    Warmup is off and ``nbs`` is the batch, so the step fires at once and
    every group, the weight group with its decay included, moves at lr0.
    ``recipe``: loss switches (Wise-IoU, NWD); then the new ``iou_mean`` is
    held too."""
    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.engine.trainer import DetectionTrainer

    out = {}
    for dev in ("cuda", "cpu"):
        model = DetectionModel(CFG, device=dev)
        model.load_state_dict(state_dict, strict=True)
        before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        trainer = DetectionTrainer(model, {"amp": False, "batch": CMP_BATCH, "imgsz": CMP_IMGSZ, "nbs": CMP_BATCH,
                                           "warmup_epochs": 0.0, **(recipe or {})})
        opt = trainer.state.optimizer
        lrs = opt.schedules()
        comps = trainer.train_step(batch)
        check(opt.updates == 1 and min(lrs[:2]) > 0, f"{dev}: the compared step fired {opt.updates} updates at "
                                                     f"(lr, bias lr, momentum) {lrs}: expected 1 with both LRs > 0")
        out[dev] = dict(comps={k: v.item() for k, v in comps.items()}, lrs=lrs, iou_mean=trainer.state.iou_mean.item(),
                        grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                        momentum={n: opt.state[p]["momentum_buffer"].cpu() for n, p in model.named_parameters()},
                        after={n: p.detach().cpu() for n, p in model.named_parameters()},
                        updates={n: p.detach().cpu() - before[n] for n, p in model.named_parameters()})
    gpu, cpu = out["cuda"], out["cpu"]
    check(gpu["comps"]["fg"] == cpu["comps"]["fg"], f"foreground count {gpu['comps']['fg']} on the card, "
                                                      f"{cpu['comps']['fg']} on the CPU")
    loss_rel = max(abs(gpu["comps"][k] - cpu["comps"][k]) / abs(cpu["comps"][k]) for k in ("box", "cls", "dfl"))
    check(loss_rel <= 1e-4, f"loss components differ from the CPU's by {loss_rel} relative > 1e-4")

    def worst(a, b, slack=None):
        """Largest relative L2 difference over tensors, and the tensors that miss
        1e-3 relative (or 1e-6 absolute under a norm of 1e-5) by more than the
        absolute L2 allowance ``slack[n]``."""
        rels, bad = [], []
        for n in b:
            diff, norm = float(np.linalg.norm(a[n] - b[n])), float(np.linalg.norm(b[n]))
            ok = diff <= (1e-6 if norm < 1e-5 else 1e-3 * norm) + (slack[n] if slack else 0.0)
            rels.append(diff / norm if norm >= 1e-5 else 0.0)
            if not ok:
                bad.append(n)
        return max(rels), bad

    grad_rel, bad = worst(gpu["grads"], cpu["grads"])
    check(not bad, f"gradients differ from the CPU's beyond 1e-3 relative L2: {bad[:5]}")
    mom_rel, bad = worst(gpu["momentum"], cpu["momentum"])
    check(not bad, f"momentum buffers differ from the CPU's beyond 1e-3 relative L2: {bad[:5]}")
    # a parameter near 1 that moves by 1e-4 carries f32 rounding of ~1e-3 of its update
    spacing = {n: float(np.linalg.norm(np.spacing(p.numpy()))) for n, p in cpu["after"].items()}
    upd_rel, bad = worst(gpu["updates"], cpu["updates"], spacing)
    check(not bad, f"parameter updates differ from the CPU's beyond 1e-3 relative L2: {bad[:5]}")
    iou_rel = abs(gpu["iou_mean"] - cpu["iou_mean"]) / abs(cpu["iou_mean"])
    if recipe:
        check(iou_rel <= 1e-6 and cpu["iou_mean"] != 1.0, f"iou_mean {gpu['iou_mean']} on the card, {cpu['iou_mean']} "
                                                          "on the CPU: not within 1e-6 relative, or it did not move")
    return {"imgsz": CMP_IMGSZ, "batch": CMP_BATCH, "loss_switches": recipe or "CIoU",
            "lr_bias_lr_momentum": gpu["lrs"], "fg": gpu["comps"]["fg"],
            "iou_mean_card": gpu["iou_mean"], "iou_mean_cpu": cpu["iou_mean"], "iou_mean_rel_err": iou_rel,
            "loss_max_rel_err": loss_rel, "grad_max_rel_l2": grad_rel, "momentum_max_rel_l2": mom_rel,
            "update_max_rel_l2": upd_rel,
            "loss_card": {k: gpu["comps"][k] for k in ("box", "cls", "dfl")},
            "loss_cpu": {k: cpu["comps"][k] for k in ("box", "cls", "dfl")}}


def match_fraction(a, b, tol=1e-2):
    """Fraction of detections of ``a`` (N, 6) that have one in ``b`` of the same
    class with every coordinate within ``tol`` px."""
    import numpy as np

    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    close = (np.abs(a[:, None, :4] - b[None, :, :4]).max(-1) <= tol) & (a[:, None, 5] == b[None, :, 5])
    return float(close.any(1).mean())


def capture_scan_inputs(model, x):
    """One forward on batch ``x`` under ``no_grad``: the arguments of every
    selective-scan call, in order, as SS2D hands them to K4: (positional,
    keyword) pairs."""
    import torch

    import experiment_yolo_torch.nn.zoo_blocks as zoo

    calls, scan = [], zoo.selective_scan

    def scan_hook(*args, **kwargs):
        calls.append((args, kwargs))
        return scan(*args, **kwargs)

    zoo.selective_scan = scan_hook
    try:
        with torch.no_grad():
            feats = model(x)
    finally:
        zoo.selective_scan = scan
    return feats, calls


def check_k4(calls):
    """K4 against its plain version on one VSS block's call per pyramid
    level, exactly as SS2D makes it, on random inputs of the same shapes and
    at one ragged length (the seeded model's ``dt`` sits near 0.01 and its
    ``A`` and ``D`` do not differ by direction): every direction within
    K4_RTOL of its own largest plain value. Timed over the ten calls of one
    forward."""
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.selective_scan import chunk_length, selective_scan, selective_scan_plain

    levels = {}
    for args, kwargs in calls:
        levels.setdefault(args[1].shape[2], (args, kwargs))  # the first block of each sequence length
    check(sorted(levels) == [(IMGSZ // s) ** 2 for s in (32, 16, 8, 4)], f"scan lengths {sorted(levels)}")
    gen = torch.Generator().manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    def random_call(bsz, length, dim):
        """Random inputs in SS2D's form: two sequences for four directions, two of them reversed (not
        SS2D's two), per-direction A and D, B and C as views of one tensor with rows of 33 floats."""
        wide = randn(bsz, 4, length, 2 * 16 + 1)
        args = (randn(bsz, 2, length, dim), F.softplus(randn(bsz, 4, length, dim)), -torch.exp(randn(4, dim, 16)),
                wide[..., 1:17], wide[..., 17:], randn(4, dim))
        return args, {"reverse": (True, False, False, True), "source": (1, 0, 0, 1)}

    def worst(got, want):
        """(max abs error, the worst direction's max abs error over that
        direction's largest plain value)."""
        err = (got - want).abs().amax((0, 2, 3))
        return err.max().item(), (err / want.abs().amax((0, 2, 3))).max().item()

    def cost(args):
        """Bytes (x, dt, A, B, C, D read once, y written once) and operations of one call: per (sequence,
        step, channel, state) 8 (dt*A, exp, dt*B, *x, h*da, +, h*C, the sum), per (sequence, step, channel) 2
        more for the skip."""
        n = args[1].numel()
        return (sum(t.numel() for t in args) + n) * 4, n * (16 * 8 + 2)

    def passes(args):
        """The kernels one call launches: the ends and carry passes only where the scan has more than one chunk."""
        bsz, g, length, dim = args[1].shape
        return 3 if length > chunk_length(bsz * g, length, dim, sms) else 1

    def held(kind, length, args, kwargs):
        e, r = worst(selective_scan(*args, **kwargs), selective_scan_plain(*args, **kwargs))
        torch.cuda.synchronize()
        check(r <= K4_RTOL, f"K4 selective_scan disagrees with its plain version on {kind} inputs at "
                            f"L={length}: max abs err {e} ({r} of the direction's largest plain value)")
        return e, r

    detail, err, rel = [], 0.0, 0.0
    with torch.no_grad():
        for length, (args, kwargs) in sorted(levels.items()):
            x, dt, _, b, _, _ = args
            check(dt.dim() == 4 and dt.shape[1] == 4 and x.shape[1] == 2, f"a call covers x {x.shape}, dt {dt.shape}: "
                                                                           "not four directions on two sequences")
            check(kwargs.get("reverse") == (False, False, True, True) and kwargs.get("source") == (0, 1, 0, 1)
                  and not b.is_contiguous(), f"SS2D's call at L={length} is not the strided, flagged form: {kwargs}")
            bsz, _, _, dim = dt.shape
            row = {"shape_B_G_L_D": list(dt.shape), "dt_main_median": dt.median().item(), "B_row_floats": b.stride(2),
                   "chunk_steps": chunk_length(bsz * 4, length, dim, sms)}
            for kind, (a, k) in (("main", (args, kwargs)), ("random", random_call(bsz, length, dim))):
                e, r = held(kind, length, a, k)
                row[f"{kind}_max_abs_err"], row[f"{kind}_rel_err"] = e, r
                err, rel = max(err, e), max(rel, r)
            row["ms"] = cuda_ms(lambda: selective_scan(*args, **kwargs))
            row["device_ms"] = device_ms(lambda: selective_scan(*args, **kwargs), "selective_scan_kernel",
                                         passes(args))
            row["bytes"] = cost(args)[0]
            row["bound_ms"] = bound(*cost(args))[0]
            detail.append(row)
        # a length that is no multiple of the chunk or the tile, at the widest level's batch and a middle width
        bsz, dim = detail[0]["shape_B_G_L_D"][0], detail[1]["shape_B_G_L_D"][3]
        chunk = chunk_length(bsz * 4, RAGGED_SCAN_LENGTH, dim, sms)
        check(RAGGED_SCAN_LENGTH % chunk and RAGGED_SCAN_LENGTH % 8, f"L={RAGGED_SCAN_LENGTH} is not ragged for chunks of {chunk}")
        e, r = held("ragged random", RAGGED_SCAN_LENGTH, *random_call(bsz, RAGGED_SCAN_LENGTH, dim))
        err, rel = max(err, e), max(rel, r)
        ragged = {"shape_B_G_L_D": [bsz, 4, RAGGED_SCAN_LENGTH, dim], "chunk_steps": chunk, "max_abs_err": e, "rel_err": r}

        def kernel():
            return [selective_scan(*args, **kwargs) for args, kwargs in calls]

        ms, dev_ms = cuda_ms(kernel), device_ms(kernel, "selective_scan_kernel", sum(passes(a) for a, _ in calls))
        plain_ms = cuda_ms(lambda: [selective_scan_plain(*args, **kwargs) for args, kwargs in calls],
                           runs=PLAIN_SCAN_RUNS, warmup=1)
    nbytes, ops = (sum(v) for v in zip(*(cost(args) for args, _ in calls)))
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="selective_scan", route="cuda", source="experiment_yolo_torch/csrc/selective_scan.cu",
                replaces="experiment_yolo_tpu/ops/pallas/selective_scan.py:50", max_abs_err=err, rel_err=rel, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, plain_runs=PLAIN_SCAN_RUNS, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launches_per_forward=len(calls), scans_per_forward=sum(args[1].shape[1] for args, _ in calls),
                bytes_per_forward=nbytes, levels=detail, ragged=ragged)


def serve_timed(model, images, counters, per_forward, card, label):
    """SERVE_BATCHES batches of BATCH through ``DetectionPredictor`` with soft
    and then hard NMS, every launch counter at 0 just before each run and read
    just after; ``per_forward`` is the launches one forward must make. Returns
    the timings per NMS type, the launches of both runs, the hard results."""
    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionPredictor

    stream = [images[i % N_IMAGES] for i in range(SERVE_BATCHES * BATCH)]
    launches = dict.fromkeys(counters, 0)
    served = {}
    hard_results = None
    for nms_type in ("soft", "hard"):
        pred = DetectionPredictor(model, {"imgsz": IMGSZ, "batch": BATCH, "nms_type": nms_type})
        pred(images[:BATCH])  # warm-up: cuDNN picks its algorithms
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        results, batch_ms = [], []
        for start in range(0, len(stream), BATCH):
            t = time.perf_counter()
            results += pred(stream[start:start + BATCH])  # ends in a copy to the host, which waits for the card
            batch_ms.append((time.perf_counter() - t) * 1e3)
        run = {name: fn.launches for name, fn in counters.items()}
        want = {name: per_forward.get(name, 0) * SERVE_BATCHES for name in counters}
        want["nms_suppress"] = SERVE_BATCHES if nms_type == "hard" else 0
        want["soft_nms"] = SERVE_BATCHES if nms_type == "soft" else 0
        check(run == want, f"{label} {nms_type} NMS main path launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        check(len(results) == len(stream), f"{len(results)} results for {len(stream)} images")
        counts = [len(r) for r in results]
        check(min(counts) > 0, f"{label} {nms_type}: an image has no detections: {counts}")
        for r, img in zip(results, stream):
            d = r.boxes.data
            check(bool(np.isfinite(d).all()), f"{label} {nms_type}: non-finite detections")
            h, w = img.shape[:2]
            check(bool((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all() and (d[:, [1, 3]] >= 0).all()
                       and (d[:, [1, 3]] <= h).all()), f"{label} {nms_type}: boxes outside their image")
            check(bool(((d[:, 4] > CONF) & (d[:, 4] <= 1)).all() and ((d[:, 5] >= 0) & (d[:, 5] < model.nc)).all()),
                  f"{label} {nms_type}: scores or classes out of range")
        per_batch = results[::BATCH]  # every result of a batch carries that batch's speed
        median_ms = statistics.median(batch_ms)
        served[nms_type] = {
            "batches": SERVE_BATCHES, "batch_ms_median": median_ms, "batch_ms_min": min(batch_ms),
            "batch_ms_max": max(batch_ms), "batch_ms_p10_p90": statistics.quantiles(batch_ms, n=10)[::8],
            "img_per_s_at_median": BATCH / median_ms * 1e3, "img_per_s_overall": len(stream) / sum(batch_ms) * 1e3,
            "host_preprocess_ms_per_batch_median": statistics.median(r.speed["preprocess"] * BATCH for r in per_batch),
            "inference_ms_per_batch_median": statistics.median(r.speed["inference"] * BATCH for r in per_batch),
            "detections_per_image": sum(counts) / len(counts), "launches": run}
        log(f"served {label} {nms_type} NMS: {len(stream)} images in {SERVE_BATCHES} batches of {BATCH} at {IMGSZ}: "
            f"median {median_ms:.2f} ms per batch (min {min(batch_ms):.2f}, max {max(batch_ms):.2f}), "
            f"{served[nms_type]['img_per_s_at_median']:.2f} img/s at the median, launches {run}, {card}")
        if nms_type == "hard":
            hard_results = results
    check(hard_results is not None, "hard NMS did not run")
    return served, launches


def compare_serving_cpu(cfg, model, x):
    """Batch ``x`` through ``model`` on the card and through the same weights
    on the CPU, plain versions only: raw maps, decode, hard-NMS detections.
    The decode is held on one set of card maps, decoded on the card and on
    the CPU; how far ``model.predict``'s own forward of ``x`` lands from it is
    reported, not gated."""
    import numpy as np
    import torch

    from experiment_yolo_torch import DetectionModel
    from experiment_yolo_torch.ops.anchors import decode_detections
    from experiment_yolo_torch.ops.nms import non_max_suppression

    cpu = DetectionModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        cpu_feats = cpu(x.cpu())
        feats = model(x)
        gpu_boxes, gpu_scores = decode_detections(feats, model.stride, model.nc, model.reg_max)
        predicted = model.predict(x)  # a second forward of the same batch
    repeat_err = max((a - b).abs().max().item() for a, b in zip(predicted, (gpu_boxes, gpu_scores)))
    map_err = max((a.cpu() - b).abs().max().item() for a, b in zip(feats, cpu_feats))
    check(map_err <= 1e-3, f"{cfg}: raw head maps differ from the CPU's by {map_err} > 1e-3")
    # decode and hard NMS on the card's own maps, once on the card (K1, K2) and once on the CPU (plain)
    cb, cs = decode_detections([f.cpu() for f in feats], model.stride, model.nc, model.reg_max)
    dec_err = (gpu_boxes.cpu() - cb).abs().max().item()
    check(dec_err <= 1e-3, f"{cfg}: decoded boxes differ from the CPU decode of the same maps by {dec_err} px")
    nms_kw = dict(conf_thres=CONF, iou_thres=IOU, nms_type="hard")
    gd, gn = non_max_suppression(gpu_boxes, gpu_scores, **nms_kw)
    pd, pn = non_max_suppression(gpu_boxes.cpu(), gpu_scores.cpu(), **nms_kw)
    gd, gn, pd, pn = gd.cpu().numpy(), gn.cpu().numpy(), pd.numpy(), pn.numpy()
    check((gn == pn).all(), f"{cfg}: hard-NMS counts on the card {gn.tolist()} != on the CPU {pn.tolist()}")
    check(int(gn.min()) > 0, f"{cfg}: an image of the compared batch has no detection: {gn.tolist()}")
    check((gd[..., 5] == pd[..., 5]).all(), f"{cfg}: hard-NMS classes differ between card and CPU")
    det_err = float(np.abs(gd[..., :4] - pd[..., :4]).max())
    check(det_err <= 1e-2, f"{cfg}: hard-NMS boxes differ between card and CPU by {det_err} px")
    # the whole CPU path on its own maps: near-equal scores may swap places in a
    # sort, so a few detections may differ; hold most of them
    cd, cn = non_max_suppression(*decode_detections(cpu_feats, model.stride, model.nc, model.reg_max), **nms_kw)
    cd, cn = cd.numpy(), cn.numpy()
    frac = min(match_fraction(gd[i, :gn[i]], cd[i, :cn[i]]) for i in range(len(gn)))
    check(frac >= 0.95, f"{cfg}: only {frac:.3f} of an image's card detections are on the CPU path")
    return {"batch": len(gn), "map_max_abs_err": map_err, "decode_max_abs_err_px": dec_err,
            "predict_again_max_abs_err": repeat_err,
            "nms_same_maps_max_abs_err_px": det_err, "cpu_path_min_match_fraction": frac,
            "cpu_path_max_count_gap": int(np.abs(gn - cn).max()), "counts": gn.tolist()}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    pkg = ROOT / "experiment_yolo_torch" / "__init__.py"
    if not pkg.exists():
        fail(f"{pkg.parent} is missing: run from the root of a checkout")
    sys.path.insert(0, str(ROOT))

    import experiment_yolo_torch
    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.ops.kernels import (_build, dfl_decode, ldconv_gather, nms_suppress, selective_scan,
                                                   soft_nms)
    from experiment_yolo_torch.utils.seeded import (VAL_CONF, letterboxed, model_input, seeded_batch, seeded_images,
                                                    seeded_model)

    check(Path(experiment_yolo_torch.__file__).resolve() == pkg.resolve(), "imported a package other than the checkout's")
    counters = {"dfl_decode": dfl_decode.dfl_decode, "dfl_decode_bwd": dfl_decode.dfl_decode_bwd,
                "nms_suppress": nms_suppress.nms_suppress, "ldconv_gather": ldconv_gather.ldconv_gather,
                "ldconv_gather_bwd": ldconv_gather.ldconv_gather_bwd,
                "selective_scan": selective_scan.selective_scan, "soft_nms": soft_nms.soft_nms}

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    # 2. full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")

    # 3. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built {', '.join(_build.KERNELS)} (kernels {', '.join(counters)}) for sm_90a in {secs:.2f} s "
        "(nvcc, one process per source, in parallel)")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def logged_model(cfg):
        model = seeded_model(cfg, SEED)
        log(f"model {cfg} scale n: {sum(p.numel() for p in model.parameters())} params, strides {model.stride}, "
            f"seeded weights (PyTorch init from seed {SEED}, conv weights redrawn He-normal from seed {SEED + 1}), "
            "Detect class-bias priors set to 0")
        return model

    # 4. model and the main path's kernel inputs
    model = logged_model(CFG)
    images = seeded_images(N_IMAGES, SEED)
    x = model_input(letterboxed(images[:BATCH], IMGSZ), "cuda")
    feats, ld, serve_pool = capture_inputs(model, x)
    check(len(ld) == 10, f"expected 10 LDConv layers on the path, found {len(ld)}")

    # 5. each kernel against its plain version, and timed
    rand_ld = random_offsets(ld)
    kernels = [check_k1(feats), check_k2(serve_pool[0], serve_pool[2]), check_k3(ld, rand_ld)]
    for k in kernels:
        log(f"{k['name']}: max abs err {k['max_abs_err']}, kernel {k['ms']:.4f} ms (device {k['device_ms']} ms), "
            f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})")
    log(f"  K2 bound: {kernels[1]['bound_assumption']}: {kernels[1]['bound_parts']}; the earlier design's own "
        f"bound {kernels[1]['old_design_bound_ms']:.4f} ms ({kernels[1]['old_design_bound_assumption']})")
    for label, row in kernels[1]["made_up"].items():
        log(f"  K2 {label}: {row}")
    log(f"  K3 library device ms {kernels[2]['library_device_ms']}, random offsets: {kernels[2]['random_offsets']}")
    for row in kernels[2]["layers"]:
        log(f"  K3 layer {row}")

    # 6. the main path: DetectionPredictor, soft then hard NMS, one batch per call
    served, launches = serve_timed(model, images, counters, {"dfl_decode": len(model.stride), "ldconv_gather": 10},
                                   card, CFG)
    # 7. the same batch through the same weights on the CPU, plain versions only
    compare = compare_serving_cpu(CFG, model, x)
    log(f"CPU comparison: {json.dumps(compare)}")

    # 8. the val main path: DetectionValidator, soft-NMS in quirk mode then hard; K5 against its plain version
    vbatches = val_batches(model.nc)
    validated, run = validate_timed(model, vbatches, counters, card)
    for name in launches:
        launches[name] += run[name]
    pools, validated["k5_vs_plain_loop"] = val_pools_and_plain_stats(model, vbatches)
    # the serving path's soft-NMS pool (the predictor's defaults: no quirk)
    k5 = check_k5(pools, serve_pool)
    del pools, serve_pool
    log(f"soft_nms: max abs err {k5['max_abs_err']} ({k5['rel_err']} relative on kept scores), kernel "
        f"{k5['ms']:.4f} ms (device {k5['device_ms']} ms) on {k5['timed_on']}, plain {k5['plain_ms']:.4f} ms, "
        f"library none, bound {k5['bound_ms']:.4f} ms ({k5['bound_by']}: {k5['bound_assumption']}: "
        f"{k5['bound_parts']})")
    log(f"  K5 val stats with K5 and with the plain loop: {json.dumps(validated['k5_vs_plain_loop'])}")
    for label, row in (*k5["main_path_pools"].items(), *k5["made_up"].items()):
        log(f"  K5 {label}: {row}")
    log(f"  K5 serving pool: {k5['serving_pool']}")

    # 9. the backward kernels on one training step's inputs
    trainer = DetectionTrainer(model, {"amp": False, "batch": BATCH, "imgsz": IMGSZ})
    batches = [seeded_batch(BATCH, IMGSZ, SEED + 10 + i, nc=model.nc) for i in range(TRAIN_BATCHES)]
    ld_train, levels = capture_train_inputs(trainer, batches[0])
    bwd = [check_k1_bwd(levels), check_k3_bwd(ld_train, rand_ld)]
    for k in bwd:
        log(f"{k['name']}: max abs err {k['max_abs_err']} ({k['rel_err']} of the largest plain value), kernel "
            f"{k['ms']:.4f} ms (device {k['device_ms']} ms), plain {k['plain_ms']:.4f} ms, library {k['library_ms']} "
            f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    log(f"  K3 bwd main path {bwd[1]['main_path']}, random offsets {bwd[1]['random_offsets']}, contention offsets "
        f"{bwd[1]['contention_offsets']}, others {bwd[1]['other_offsets']}; device ms count "
        f"{bwd[1]['device_ms_counts']}")
    log(f"  K3 bwd contention offsets against the plain version summed in float64 (reported; the gate is "
        f"{BWD_RTOL} against float32): {json.dumps(bwd[1]['contention_vs_float64'])}")
    log(f"  K3 forward at imgsz {RAGGED_IMGSZ}: {bwd[1]['forward_at_ragged_imgsz']}")
    for row in bwd[1]["layers"]:
        log(f"  K3 bwd layer {row}")
    kernels = [kernels[0], bwd[0], kernels[1], kernels[2], bwd[1]]

    # 10. the training main path: DetectionTrainer.train_step, one batch per call
    step_ms, run, last, moved, ema_moved = train_timed(trainer, batches, counters)
    want = {"dfl_decode": 3 * TRAIN_STEPS, "dfl_decode_bwd": 3 * TRAIN_STEPS, "nms_suppress": 0,
            "ldconv_gather": 10 * TRAIN_STEPS, "ldconv_gather_bwd": 10 * TRAIN_STEPS, "selective_scan": 0,
            "soft_nms": 0}
    check(run == want, f"the training steps launched {run}, expected {want}")
    for name in launches:
        launches[name] += run[name]
    median_ms = statistics.median(step_ms)
    opt = trainer.state.optimizer
    trained = {"steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "batch": BATCH, "imgsz": IMGSZ, "dtype": "float32",
               "step_ms_median": median_ms, "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
               "step_ms_p10_p90": statistics.quantiles(step_ms, n=10)[::8], "img_per_s_at_median": BATCH / median_ms * 1e3,
               "launches": run, "updates_fired": opt.updates, "micro_batches": trainer.state.step,
               "accumulate": trainer.accumulate, "last_losses": last, "params_moved": moved, "ema_moved": ema_moved,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"trained: {TRAIN_STEPS} steps of {BATCH} at {IMGSZ}: median {median_ms:.2f} ms per step (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {trained['img_per_s_at_median']:.2f} img/s at the median, "
        f"launches {run}, {opt.updates} updates over {trainer.state.step} micro-batches, {card}")

    # 11. one training step on the card and on the CPU, same weights and batch, CIoU and the paper's recipe
    cmp_batch = seeded_batch(CMP_BATCH, CMP_IMGSZ, SEED + 20, nc=model.nc)
    cmp_state = {k: v.cpu() for k, v in model.state_dict().items()}
    trained["cpu_comparison"] = compare_train_cpu(cmp_state, cmp_batch)
    log(f"training CPU comparison: {json.dumps(trained['cpu_comparison'])}")
    trained["cpu_comparison_recipe"] = compare_train_cpu(cmp_state, cmp_batch, RECIPE)
    log(f"training CPU comparison with the recipe: {json.dumps(trained['cpu_comparison_recipe'])}")
    del trainer, model, ld, ld_train, rand_ld, levels, feats
    torch.cuda.empty_cache()

    # 12. the VSS detector and the scan inputs of one forward
    vss = logged_model(VSS_CFG)
    _, calls = capture_scan_inputs(vss, x)
    check(len(calls) == 10, f"expected 10 VSS blocks on the path, found {len(calls)} scan calls")

    # 13. K4 against its plain version, and timed
    k4 = check_k4(calls)
    del calls
    log(f"selective_scan: max abs err {k4['max_abs_err']} ({k4['rel_err']} of a direction's largest plain value), "
        f"kernel {k4['ms']:.4f} ms (device {k4['device_ms']} ms) for one forward's {k4['launches_per_forward']} "
        f"launches ({k4['scans_per_forward']} scans), plain {k4['plain_ms']:.1f} ms (median of {k4['plain_runs']}), "
        f"library none, bound {k4['bound_ms']:.4f} ms ({k4['bound_by']})")
    for row in k4["levels"]:
        log(f"  K4 level {row}")
    log(f"  K4 ragged {k4['ragged']}")
    kernels += [k4, k5]

    # 14. the VSS main path: DetectionPredictor, soft then hard NMS
    served_vss, run = serve_timed(vss, images, counters, {"dfl_decode": len(vss.stride),
                                                          "selective_scan": k4["launches_per_forward"]}, card, VSS_CFG)
    for name in launches:
        launches[name] += run[name]
    # 15. a smaller batch through the same weights on the CPU, plain versions only
    compare_vss = compare_serving_cpu(VSS_CFG, vss, x[:VSS_CMP_BATCH])
    log(f"VSS CPU comparison: {json.dumps(compare_vss)}")
    del vss

    # 16. the plain-Conv configs: one batch each
    plain_conv = {}
    for cfg, strides in PLAIN_CONV_CFGS.items():
        m = logged_model(cfg)
        with torch.no_grad():
            maps = m(x)
        check(m.stride == strides, f"{cfg}: strides {m.stride}, expected {strides}")
        check([tuple(f.shape) for f in maps] == [(BATCH, m.nc + 4 * m.reg_max, IMGSZ // s, IMGSZ // s) for s in strides],
              f"{cfg}: raw map shapes {[tuple(f.shape) for f in maps]}")
        check(all(bool(torch.isfinite(f).all()) for f in maps), f"{cfg}: non-finite raw maps")
        plain_conv[cfg] = {"strides": list(m.stride), "params": sum(p.numel() for p in m.parameters()),
                           "map_abs_max": max(f.abs().max().item() for f in maps)}
    log(f"plain-Conv configs: {json.dumps(plain_conv)}")

    # 17. the result lines
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["kernel_ms"] = k["ms"]
        check(k["launches"] > 0, f"{k['name']} was launched no time on a main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "kernel_ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernel_detail": [{k: v for k, v in kern.items() if k not in keys or k == "name"}
                                      for kern in kernels]}))
    log(json.dumps({"served": served, "cpu_comparison": compare, "imgsz": IMGSZ, "batch": BATCH, "dtype": "float32",
                    "card": card}))
    log(json.dumps({"trained": trained, "card": card}))
    log(json.dumps({"served_vss": served_vss, "cpu_comparison": compare_vss, "plain_conv_configs": plain_conv,
                    "cfg": VSS_CFG, "imgsz": IMGSZ, "batch": BATCH, "dtype": "float32", "card": card}))
    log(json.dumps({"validated": validated, "cfg": CFG, "imgsz": IMGSZ, "batch": BATCH, "conf": VAL_CONF,
                    "dtype": "float32", "card": card}))
    # last of the long lines, so that a reader of the output's tail gets it whole
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(f"card: {card}")
    log(f"total seconds after the card check: {time.perf_counter() - t0:.1f}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
