#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``experiment_yolo_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
 1. print the card's name and power limit (``nvidia-smi``);
 2. turn TF32 off for matmuls and cuDNN convolutions (full f32 throughout);
 3. build the three CUDA kernels of ``experiment_yolo_torch/csrc`` with nvcc;
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
 8. print a ``{"kernels": [...]}`` line and a ``{"served": ...}`` line, and
    last ``{"ok": true, "device": {...}}``.

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
    ``kernel``, from a ``torch.profiler`` trace; None if the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
    return us / runs / 1e3 if us else None


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

    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode, dfl_decode_plain

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


def check_k3(ld):
    import torch
    import torch.nn.functional as F

    from experiment_yolo_torch.ops.kernels.ldconv_gather import grid_points, ldconv_gather, ldconv_gather_plain

    # The seeded model's offset convs keep the reference init (zero weights),
    # so the main path's offsets are one value per channel. Hold the kernel
    # also on offsets that vary by pixel and image: N(0, 4^2) px, and 2% of
    # them pushed 40 px further, far outside the source.
    gen = torch.Generator().manual_seed(SEED + 2)
    rand_ld = []
    for x, o, s in ld:
        r = torch.randn(o.shape, generator=gen) * 4
        far = torch.rand(o.shape, generator=gen) < 0.02
        rand_ld.append((x, torch.where(far, r + 40 * r.sign(), r).to(o.device), s))
    got = [ldconv_gather(x, o, s) for x, o, s in ld]
    err = max((a - ldconv_gather_plain(x, o, s)).abs().max().item() for a, (x, o, s) in zip(got, ld))
    check(err <= 1e-5, f"K3 ldconv_gather disagrees with its plain version: max abs err {err}")
    rand_err = max((ldconv_gather(x, o, s) - ldconv_gather_plain(x, o, s)).abs().max().item() for x, o, s in rand_ld)
    check(rand_err <= 1e-5, f"K3 ldconv_gather disagrees with its plain version on random offsets: {rand_err}")

    def grids(layers):
        """F.grid_sample's grids for the same positions (border clamp, no
        border double count)."""
        out = []
        for x, o, s in layers:
            b, n2, h, w = o.shape
            n, (hx, wx) = n2 // 2, x.shape[2:]
            pts = torch.tensor(grid_points(n), dtype=torch.float32, device=x.device)
            o = o.reshape(b, 2, n, h * w).permute(0, 3, 2, 1)  # (B, hw, N, [row, col])
            rows = (torch.arange(h, device=x.device, dtype=torch.float32) * s)[:, None].expand(h, w).reshape(1, -1, 1)
            cols = (torch.arange(w, device=x.device, dtype=torch.float32) * s)[None, :].expand(h, w).reshape(1, -1, 1)
            pr, pc = rows + pts[:, 0] + o[..., 0], cols + pts[:, 1] + o[..., 1]
            out.append(torch.stack([pc / (wx - 1) * 2 - 1, pr / (hx - 1) * 2 - 1], -1))  # (B, hw, N, [x, y])
        return out

    def library(layers, gs):
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="border", align_corners=True)
                for (x, _, _), g in zip(layers, gs)]

    def kernel(layers):
        return [ldconv_gather(x, o, s) for x, o, s in layers]

    ms = cuda_ms(lambda: kernel(ld))
    dev_ms = device_ms(lambda: kernel(ld), "ldconv_gather_kernel")
    plain_ms = cuda_ms(lambda: [ldconv_gather_plain(x, o, s) for x, o, s in ld])
    main_grids, rand_grids = grids(ld), grids(rand_ld)
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
    from experiment_yolo_torch.utils.seeded import he_normal_, seeded_images

    check(Path(experiment_yolo_torch.__file__).resolve() == pkg.resolve(), "imported a package other than the checkout's")
    counters = {"dfl_decode": dfl_decode.dfl_decode, "nms_suppress": nms_suppress.nms_suppress,
                "ldconv_gather": ldconv_gather.ldconv_gather}

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
    log(f"built {', '.join(_build.KERNELS)} for sm_90a in {secs:.2f} s (nvcc, one process per source, in parallel)")
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
    kernels = [check_k1(feats), check_k2(shifted, valid), check_k3(ld)]
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
        want = {"dfl_decode": per_forward["dfl_decode"] * SERVE_BATCHES,
                "ldconv_gather": per_forward["ldconv_gather"] * SERVE_BATCHES,
                "nms_suppress": SERVE_BATCHES if nms_type == "hard" else 0}
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
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["kernel_ms"] = k["ms"]

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

    # 8. the result lines
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "kernel_ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(json.dumps({"kernel_detail": [{k: v for k, v in kern.items() if k not in keys or k == "name"}
                                      for kern in kernels]}))
    log(json.dumps({"served": served, "imgsz": IMGSZ, "batch": BATCH, "dtype": "float32", "card": card}))
    log(f"card: {card}")
    log(f"total seconds after the card check: {time.perf_counter() - t0:.1f}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
