#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``experiment_yolo_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
 1. print the card's name and power limit (``nvidia-smi``);
 2. turn TF32 off for matmuls and cuDNN convolutions (full f32 throughout);
 3. build the three CUDA libraries of ``experiment_yolo_torch/csrc`` (five
    kernels) with nvcc;
 4. build ``yolov8-LD-P2.yaml`` (n scale, nc=6) on the card from a seeded
    generator, and run one batch of 8 at 640 to take each kernel's inputs
    from the main path: the Detect maps (K1), the ten LDConv sources and
    offsets (K3), the hard-NMS candidates (K2);
 5. hold each kernel against its plain PyTorch version on those inputs
    (K1 and K3 within 1e-5 abs, K2 identical masks), K3 also on random
    offsets at the same shapes that vary by pixel and image and reach 40 px
    out of bounds; time kernel, plain version and, for K3, ``F.grid_sample``
    as a library yardstick (CUDA events, median of 20 runs after warm-up),
    and read each kernel's device time from a ``torch.profiler`` trace;
 6. serve 20 batches of 8 seeded images of mixed sizes through
    ``DetectionPredictor`` at imgsz 640, once with soft and once with hard
    NMS, with every launch counter set to 0 just before and read just after,
    and report the median batch time and its spread;
 7. run one batch through the same weights on the CPU with the plain versions
    and compare raw maps and hard-NMS detections;
 8. take one training step (``DetectionTrainer.train_step``, batch 8 at 640,
    seeded labelled batches) and capture, through hooks, each LDConv's source,
    offsets and incoming gradient and each level's Detect map, decoded
    distances and incoming gradient; hold the K1 and K3 backward kernels
    against their plain versions on them (and K3's on phase 5's random
    offsets), each output of each level or layer (K3's ``dx`` and ``doff``
    apart) within 1e-5 of its own largest plain value, and time them as phase
    5 times the forwards, with ``F.grid_sample``'s backward as K3's yardstick;
 9. take 20 timed training steps after 3 warm-up steps, 4 distinct seeded
    batches in turn, with every launch counter set to 0 just before and read
    just after (exactly 3 K1, 3 K1-backward, 10 K3 and 10 K3-backward launches
    per step); every loss and gradient finite, parameters and EMA moved;
10. take one step from the same weights and batch at 320, batch 2, on the card
    and on the CPU (plain versions), with warmup off and ``nbs`` equal to the
    batch, so that the step fires at once with the full LR of every group:
    identical foreground count, losses within 1e-4 relative, every
    parameter's gradient, momentum buffer (clipped gradient plus weight decay)
    and update within 1e-3 relative L2 (an absolute floor of 1e-6 under a norm
    of 1e-5; an update also gets one f32 spacing of each new parameter, since
    each side rounds p + update once);
11. print a ``{"kernels": [...]}`` line, a ``{"served": ...}`` line and a
    ``{"trained": ...}`` line, and last ``{"ok": true, "device": {...}}``.

It exits non-zero and prints no result without a CUDA device, or when the
package is not beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CFG = "yolov8-LD-P2.yaml"
IMGSZ, BATCH, SEED = 640, 8, 0
N_IMAGES, SERVE_BATCHES = 32, 20  # 4 distinct batches of seeded images, served in turn
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_BATCHES = 20, 3, 4  # timed steps, warm-up steps, distinct seeded batches
CMP_IMGSZ, CMP_BATCH = 320, 2  # the card-versus-CPU training step
BWD_RTOL = 1e-5  # backward kernels vs plain: max abs error over each output's largest plain value (atomics' order)
CONF, IOU = 0.25, 0.7
RUNS, WARMUP = 20, 3
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# and f32 operations/s outside the tensor cores (none of these kernels uses them).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn) -> float:
    """Median milliseconds of ``fn`` on the card: CUDA events around each of
    RUNS calls after WARMUP calls."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, runs: int = 5):
    """Device milliseconds per call of ``fn`` spent in the CUDA kernel named
    ``kernel``, from a ``torch.profiler`` trace; None if three traces in a
    row hold no device time for it (a trace now and then comes back without
    the kernel's events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
        if us:
            return us / runs / 1e3
    return None


def bound(nbytes: float, ops: float):
    """Least time (ms) the card could take: bytes over HBM rate or operations
    over the f32 rate, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_inputs(model, x):
    """One forward on batch ``x``: the Detect maps, each LDConv's (source,
    offsets, stride), and the hard-NMS candidates that the main path hands
    to K1, K3 and K2."""
    import torch

    from experiment_yolo_torch.nn.modules import LDConv
    from experiment_yolo_torch.ops.anchors import decode_detections
    from experiment_yolo_torch.ops.nms import nms_candidates

    ld = []
    hooks = [m.register_forward_pre_hook(lambda m, a: ld.append((a[0], m.p_conv(a[0]), m.stride)))
             for m in model.modules() if isinstance(m, LDConv)]
    with torch.no_grad():
        feats = model(x)
    for h in hooks:
        h.remove()
    boxes, scores = decode_detections(feats, model.stride, model.nc, model.reg_max)
    cand = nms_candidates(boxes, scores, CONF)
    return feats, ld, cand.shifted.contiguous(), cand.valid


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
    dev_ms = device_ms(lambda: [dfl_decode(f) for f in feats], "dfl_decode_kernel")
    plain_ms = cuda_ms(lambda: [dfl_decode_plain(f) for f in feats])
    groups = sum(f.shape[0] * f.shape[2] * f.shape[3] * 4 for f in feats)
    nbytes = groups * 16 * 4 + groups * 4  # 16 bins read, one distance written, f32
    b_ms, b_by = bound(nbytes, groups * (6 * 16 + 1))  # max, sub, exp, 2 sums (3 ops), one division
    return dict(name="dfl_decode", route="cuda", source="experiment_yolo_torch/csrc/dfl_decode.cu",
                replaces="experiment_yolo_tpu/ops/pallas/dfl_decode.py:46", max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_k2(shifted, valid):
    import torch

    from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress, nms_suppress_plain

    keep, want = nms_suppress(shifted, valid, IOU), nms_suppress_plain(shifted, valid, IOU)
    torch.cuda.synchronize()
    mismatched = int((keep != want).sum())
    check(mismatched == 0, f"K2 nms_suppress: {mismatched} keep flags differ from its plain version")
    check(bool(want.any()) and bool((valid & ~want).any()), "K2 inputs neither keep nor suppress: no real work")
    ms = cuda_ms(lambda: nms_suppress(shifted, valid, IOU))
    dev_ms = device_ms(lambda: nms_suppress(shifted, valid, IOU), "nms_suppress_kernel")
    plain_ms = cuda_ms(lambda: nms_suppress_plain(shifted, valid, IOU))
    b, k = valid.shape
    later = torch.arange(k, device=valid.device).flip(0)  # candidates after index i: k-1-i
    pairs = int((later * want).sum())  # IoUs this data needs: each kept i against every later j
    b_ms, b_by = bound(b * k * (16 + 1 + 1), pairs * 13 + b * k * 3)  # ~13 ops per IoU and test
    return dict(name="nms_suppress", route="cuda", source="experiment_yolo_torch/csrc/nms_suppress.cu",
                replaces="experiment_yolo_tpu/ops/pallas/nms_kernel.py:26", max_abs_err=float(mismatched), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                kept=int(want.sum()), candidates=int(valid.sum()))


def random_offsets(ld):
    """The seeded model's offset convs keep the reference init (zero weights),
    so the main path's offsets are one value per channel. The kernels are
    also held on offsets that vary by pixel and image: N(0, 4^2) px, and 2%
    of them pushed 40 px further, far outside the source."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 2)
    rand_ld = []
    for x, o, s in ld:
        r = torch.randn(o.shape, generator=gen) * 4
        far = torch.rand(o.shape, generator=gen) < 0.02
        rand_ld.append((x, torch.where(far, r + 40 * r.sign(), r).to(o.device), s))
    return rand_ld


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
    dev_ms = device_ms(lambda: kernel(ld), "ldconv_gather_kernel")
    plain_ms = cuda_ms(lambda: [ldconv_gather_plain(x, o, s) for x, o, s in ld])
    main_grids, rand_grids = grid_sample_grids(ld), grid_sample_grids(rand_ld)
    library_ms = cuda_ms(lambda: library(ld, main_grids))
    random = {"max_abs_err": rand_err, "ms": cuda_ms(lambda: kernel(rand_ld)),
              "device_ms": device_ms(lambda: kernel(rand_ld), "ldconv_gather_kernel"),
              "library_ms": cuda_ms(lambda: library(rand_ld, rand_grids))}
    nbytes = ops = 0
    for (x, o, _), y in zip(ld, got):
        b, n2, h, w = o.shape
        nbytes += (x.numel() + o.numel() + y.numel()) * 4
        ops += y.numel() * 9 + b * h * w * (n2 // 2) * 24  # 4 products, 3 sums, 2 scalings; positions and weights
    b_ms, b_by = bound(nbytes, ops)
    shapes = [f"{tuple(x.shape)}->{tuple(y.shape)}" for (x, _, _), y in zip(ld, got)]
    return dict(name="ldconv_gather", route="cuda", source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                replaces="experiment_yolo_tpu/ops/pallas/ldconv_kernel.py:29", max_abs_err=max(err, rand_err),
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                main_path_max_abs_err=err, random_offsets=random, shapes=shapes)


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
                ms=cuda_ms(kernel), device_ms=device_ms(kernel, "dfl_decode_bwd_kernel"), plain_ms=cuda_ms(plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shapes=[f"{tuple(f.shape)}->{tuple(f.shape)}" for f, _, _ in levels])


def check_k3_bwd(ld, rand_ld):
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.ldconv_gather import ldconv_gather_bwd, ldconv_gather_bwd_plain

    def kernel(layers):
        return [t for x, o, dy, s in layers for t in ldconv_gather_bwd(x, o, dy, s)]

    def plain(layers):
        return [t for x, o, dy, s in layers for t in ldconv_gather_bwd_plain(x, o, dy, s)]

    main = [(x, o, dy, s) for x, o, s, dy in ld]
    gen = torch.Generator().manual_seed(SEED + 3)
    rand = [(x, o, torch.randn(dy.shape, generator=gen).to(dy.device), s)
            for (x, o, s), (_, _, _, dy) in zip(rand_ld, ld)]
    err, rel = _rel_err(kernel(main), plain(main))
    check(rel <= BWD_RTOL, f"K3 ldconv_gather_bwd disagrees with its plain version: {err} ({rel} relative)")
    rand_err, rand_rel = _rel_err(kernel(rand), plain(rand))
    check(rand_rel <= BWD_RTOL, f"K3 ldconv_gather_bwd disagrees on random offsets: {rand_err} ({rand_rel} relative)")

    # F.grid_sample's backward on the same positions and incoming gradients
    grids = grid_sample_grids([(x, o, s) for x, o, _, s in main])
    xs = [x.clone().requires_grad_() for x, _, _, _ in main]
    gs = [g.requires_grad_() for g in grids]
    outs = [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True) for x, g in zip(xs, gs)]
    dys = [dy.reshape(dy.shape[0], dy.shape[1], o.shape[1] // 2, -1).permute(0, 3, 1, 2).contiguous()
           for _, o, dy, _ in main]  # (B, C, hw, N), grid_sample's output layout
    library_ms = cuda_ms(lambda: torch.autograd.grad(outs, xs + gs, dys, retain_graph=True))

    nbytes = ops = 0
    for x, o, dy, _ in main:
        b, n2, h, w = o.shape
        nbytes += (2 * x.numel() + 2 * o.numel() + dy.numel()) * 4  # x, off, dy read; dx, doff written
        ops += dy.numel() * 23 + b * h * w * (n2 // 2) * 30  # per channel: d, 2 x 7 for the offsets, 4 + 4 scatter
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="ldconv_gather_bwd", route="cuda", source="experiment_yolo_torch/csrc/ldconv_gather.cu",
                replaces="experiment_yolo_tpu/nn/modules.py:469", max_abs_err=max(err, rand_err), rel_err=max(rel, rand_rel),
                ms=cuda_ms(lambda: kernel(main)), device_ms=device_ms(lambda: kernel(main), "ldconv_gather_bwd_kernel"),
                plain_ms=cuda_ms(lambda: plain(main)), bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                random_offsets={"max_abs_err": rand_err, "rel_err": rand_rel, "ms": cuda_ms(lambda: kernel(rand)),
                                "device_ms": device_ms(lambda: kernel(rand), "ldconv_gather_bwd_kernel")},
                shapes=[f"{tuple(dy.shape)}->{tuple(x.shape)},{tuple(o.shape)}" for x, o, dy, _ in main])


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


def compare_train_cpu(state_dict, batch):
    """One step from the same weights and batch on the card and on the CPU.
    Warmup is off and ``nbs`` is the batch, so the step fires at once and
    every group, the weight group with its decay included, moves at lr0."""
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
                                           "warmup_epochs": 0.0})
        opt = trainer.state.optimizer
        lrs = opt.schedules()
        comps = trainer.train_step(batch)
        check(opt.updates == 1 and min(lrs[:2]) > 0, f"{dev}: the compared step fired {opt.updates} updates at "
                                                     f"(lr, bias lr, momentum) {lrs}: expected 1 with both LRs > 0")
        out[dev] = dict(comps={k: v.item() for k, v in comps.items()}, lrs=lrs,
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
    return {"imgsz": CMP_IMGSZ, "batch": CMP_BATCH, "lr_bias_lr_momentum": gpu["lrs"], "fg": gpu["comps"]["fg"],
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    pkg = ROOT / "experiment_yolo_torch" / "__init__.py"
    if not pkg.exists():
        fail(f"{pkg.parent} is missing: run from the root of a checkout")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    import experiment_yolo_torch
    from experiment_yolo_torch import DetectionModel, DetectionPredictor
    from experiment_yolo_torch.data.augment import letterbox
    from experiment_yolo_torch.ops.anchors import decode_detections
    from experiment_yolo_torch.ops.kernels import _build, dfl_decode, ldconv_gather, nms_suppress
    from experiment_yolo_torch.ops.nms import non_max_suppression
    from experiment_yolo_torch.engine.trainer import DetectionTrainer
    from experiment_yolo_torch.utils.seeded import he_normal_, seeded_batch, seeded_images

    check(Path(experiment_yolo_torch.__file__).resolve() == pkg.resolve(), "imported a package other than the checkout's")
    counters = {"dfl_decode": dfl_decode.dfl_decode, "dfl_decode_bwd": dfl_decode.dfl_decode_bwd,
                "nms_suppress": nms_suppress.nms_suppress, "ldconv_gather": ldconv_gather.ldconv_gather,
                "ldconv_gather_bwd": ldconv_gather.ldconv_gather_bwd}

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

    # 4. model and the main path's kernel inputs
    model = DetectionModel(CFG, device="cuda", generator=torch.Generator().manual_seed(SEED))
    he_normal_(model, SEED + 1)
    log(f"model {CFG} scale n: {sum(p.numel() for p in model.parameters())} params, strides {model.stride}, "
        f"seeded weights (PyTorch init from seed {SEED}, conv weights redrawn He-normal from seed {SEED + 1}), "
        "Detect class-bias priors set to 0")
    images = seeded_images(N_IMAGES, SEED)
    lb = np.stack([letterbox(img, IMGSZ)[0][..., ::-1] for img in images[:BATCH]])
    x = (torch.from_numpy(np.ascontiguousarray(lb)).cuda().permute(0, 3, 1, 2).float() / 255.0).contiguous()
    feats, ld, shifted, valid = capture_inputs(model, x)
    check(len(ld) == 10, f"expected 10 LDConv layers on the path, found {len(ld)}")

    # 5. each kernel against its plain version, and timed
    rand_ld = random_offsets(ld)
    kernels = [check_k1(feats), check_k2(shifted, valid), check_k3(ld, rand_ld)]
    for k in kernels:
        log(f"{k['name']}: max abs err {k['max_abs_err']}, kernel {k['ms']:.4f} ms (device {k['device_ms']} ms), "
            f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})")

    # 6. the main path: DetectionPredictor, soft then hard NMS, one batch per call
    per_forward = {"dfl_decode": len(model.stride), "ldconv_gather": 10}
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
        want = {"dfl_decode": per_forward["dfl_decode"] * SERVE_BATCHES, "dfl_decode_bwd": 0,
                "nms_suppress": SERVE_BATCHES if nms_type == "hard" else 0,
                "ldconv_gather": per_forward["ldconv_gather"] * SERVE_BATCHES, "ldconv_gather_bwd": 0}
        check(run == want, f"{nms_type} NMS main path launched {run}, expected {want}")
        for name in launches:
            launches[name] += run[name]
        check(len(results) == len(stream), f"{len(results)} results for {len(stream)} images")
        counts = [len(r) for r in results]
        check(min(counts) > 0, f"{nms_type}: an image has no detections: {counts}")
        for r, img in zip(results, stream):
            d = r.boxes.data
            check(bool(np.isfinite(d).all()), f"{nms_type}: non-finite detections")
            h, w = img.shape[:2]
            check(bool((d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= w).all() and (d[:, [1, 3]] >= 0).all()
                       and (d[:, [1, 3]] <= h).all()), f"{nms_type}: boxes outside their image")
            check(bool(((d[:, 4] > CONF) & (d[:, 4] <= 1)).all() and ((d[:, 5] >= 0) & (d[:, 5] < model.nc)).all()),
                  f"{nms_type}: scores or classes out of range")
        per_batch = results[::BATCH]  # every result of a batch carries that batch's speed
        median_ms = statistics.median(batch_ms)
        served[nms_type] = {
            "batches": SERVE_BATCHES, "batch_ms_median": median_ms, "batch_ms_min": min(batch_ms),
            "batch_ms_max": max(batch_ms), "batch_ms_p10_p90": statistics.quantiles(batch_ms, n=10)[::8],
            "img_per_s_at_median": BATCH / median_ms * 1e3, "img_per_s_overall": len(stream) / sum(batch_ms) * 1e3,
            "host_preprocess_ms_per_batch_median": statistics.median(r.speed["preprocess"] * BATCH for r in per_batch),
            "inference_ms_per_batch_median": statistics.median(r.speed["inference"] * BATCH for r in per_batch),
            "detections_per_image": sum(counts) / len(counts), "launches": run}
        log(f"served {nms_type} NMS: {len(stream)} images in {SERVE_BATCHES} batches of {BATCH} at {IMGSZ}: "
            f"median {median_ms:.2f} ms per batch (min {min(batch_ms):.2f}, max {max(batch_ms):.2f}), "
            f"{served[nms_type]['img_per_s_at_median']:.2f} img/s at the median, launches {run}, {card}")
        if nms_type == "hard":
            hard_results = results
    # 7. the same batch through the same weights on the CPU, plain versions only
    cpu = DetectionModel(CFG, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        cpu_feats = cpu(x.cpu())
        gpu_boxes, gpu_scores = model.predict(x)
    map_err = max((a.cpu() - b).abs().max().item() for a, b in zip(feats, cpu_feats))
    check(map_err <= 1e-3, f"raw head maps differ from the CPU's by {map_err} > 1e-3")
    # decode and hard NMS on the card's own maps, once on the card (K1, K2) and once on the CPU (plain)
    cb, cs = decode_detections([f.cpu() for f in feats], model.stride, model.nc, model.reg_max)
    dec_err = (gpu_boxes.cpu() - cb).abs().max().item()
    check(dec_err <= 1e-3, f"decoded boxes differ from the CPU decode of the same maps by {dec_err} px")
    nms_kw = dict(conf_thres=CONF, iou_thres=IOU, nms_type="hard")
    gd, gn = non_max_suppression(gpu_boxes, gpu_scores, **nms_kw)
    pd, pn = non_max_suppression(gpu_boxes.cpu(), gpu_scores.cpu(), **nms_kw)
    gd, gn, pd, pn = gd.cpu().numpy(), gn.cpu().numpy(), pd.numpy(), pn.numpy()
    check((gn == pn).all(), f"hard-NMS counts on the card {gn.tolist()} != on the CPU {pn.tolist()}")
    check((gd[..., 5] == pd[..., 5]).all(), "hard-NMS classes differ between card and CPU")
    det_err = float(np.abs(gd[..., :4] - pd[..., :4]).max())
    check(det_err <= 1e-2, f"hard-NMS boxes differ between card and CPU by {det_err} px")
    # the whole CPU path on its own maps: near-equal scores may swap places in a
    # sort, so a few detections may differ; hold most of them
    cd, cn = non_max_suppression(*decode_detections(cpu_feats, model.stride, model.nc, model.reg_max), **nms_kw)
    cd, cn = cd.numpy(), cn.numpy()
    frac = min(match_fraction(gd[i, :gn[i]], cd[i, :cn[i]]) for i in range(BATCH))
    count_gap = int(np.abs(gn - cn).max())
    check(frac >= 0.95, f"only {frac:.3f} of an image's card detections are on the CPU path")
    compare = {"map_max_abs_err": map_err, "decode_max_abs_err_px": dec_err, "nms_same_maps_max_abs_err_px": det_err,
               "cpu_path_min_match_fraction": frac, "cpu_path_max_count_gap": count_gap,
               "counts": gn.tolist()}
    log(f"CPU comparison: {json.dumps(compare)}")
    check(hard_results is not None, "hard NMS did not run")

    # 8. the backward kernels on one training step's inputs
    trainer = DetectionTrainer(model, {"amp": False, "batch": BATCH, "imgsz": IMGSZ})
    batches = [seeded_batch(BATCH, IMGSZ, SEED + 10 + i, nc=model.nc) for i in range(TRAIN_BATCHES)]
    ld_train, levels = capture_train_inputs(trainer, batches[0])
    bwd = [check_k1_bwd(levels), check_k3_bwd(ld_train, rand_ld)]
    for k in bwd:
        log(f"{k['name']}: max abs err {k['max_abs_err']} ({k['rel_err']} of the largest plain value), kernel "
            f"{k['ms']:.4f} ms (device {k['device_ms']} ms), plain {k['plain_ms']:.4f} ms, library {k['library_ms']} "
            f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    kernels = [kernels[0], bwd[0], kernels[1], kernels[2], bwd[1]]

    # 9. the training main path: DetectionTrainer.train_step, one batch per call
    step_ms, run, last, moved, ema_moved = train_timed(trainer, batches, counters)
    want = {"dfl_decode": 3 * TRAIN_STEPS, "dfl_decode_bwd": 3 * TRAIN_STEPS, "nms_suppress": 0,
            "ldconv_gather": 10 * TRAIN_STEPS, "ldconv_gather_bwd": 10 * TRAIN_STEPS}
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
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["kernel_ms"] = k["ms"]

    # 10. one training step on the card and on the CPU, same weights and batch
    cmp_batch = seeded_batch(CMP_BATCH, CMP_IMGSZ, SEED + 20, nc=model.nc)
    trained["cpu_comparison"] = compare_train_cpu({k: v.cpu() for k, v in model.state_dict().items()}, cmp_batch)
    log(f"training CPU comparison: {json.dumps(trained['cpu_comparison'])}")

    # 11. the result lines
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "kernel_ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(json.dumps({"kernel_detail": [{k: v for k, v in kern.items() if k not in keys or k == "name"}
                                      for kern in kernels]}))
    log(json.dumps({"served": served, "imgsz": IMGSZ, "batch": BATCH, "dtype": "float32", "card": card}))
    log(json.dumps({"trained": trained, "card": card}))
    log(f"card: {card}")
    log(f"total seconds after the card check: {time.perf_counter() - t0:.1f}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
