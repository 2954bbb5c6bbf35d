"""What bounds K2, K3, K3's backward and K4 on the card: time throwaway
variants of their sources.

Usage, on a machine with an NVIDIA Hopper GPU and the CUDA toolkit:

    python3 -m experiment_yolo_torch.kernel_variants [k2|k3|k3bwd|k4|all] [--baseline ROOT]

Each variant is the kernel's source with a few pieces of text replaced (no
exp, no shared-memory reads of B and C, no copies from device memory, another
tile size, ...), built beside the real library in ``build/variants/`` and
swapped in behind the kernel's own wrapper. A variant that leaves out work
computes wrong values: only its time means something. Times are device
milliseconds per call and per kernel name from a ``torch.profiler`` trace, at
the shapes ``yolov8-C2f-VSS.yaml`` (K4) and ``yolov8-LD-P2.yaml`` (K3) give
their kernels at batch 8, imgsz 640, on seeded random inputs (K4: step sizes
near 0.01 and decays -1..-16, as the seeded model; K3: one offset per channel,
as the seeded model, and offsets N(0, 4^2) px with 2% pushed 40 px further).
K3's backward is timed per layer on those offsets and on offsets that pull
90% of a layer's samples onto sixteen source positions (many adds on one address),
summing every launch its wrapper makes (the zero fill of ``dx`` included);
K2 on clustered candidates, a batch of 8 images at K = 1,024 (the main path's
pre-NMS top-k) and at K = 8,192. One JSON line per variant; the card's name
and power limit come first, and for K4 the real kernel's error against its
plain version at L = 6,400 with step sizes near 0.01 and near 0.001.

``--baseline ROOT`` also times K3's backward built from another checkout
(say the parent commit, unpacked with ``git archive``) behind this one's
wrapper, so that two versions are compared in one process; the two sources
must have the same ``ldconv_gather_bwd_launch`` signature.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels.ldconv_gather import (ldconv_gather_bwd, ldconv_gather_bwd_plain,
                                                             ldconv_gather_fwd, ldconv_gather_plain)
from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress, nms_suppress_plain
from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan, selective_scan_plain
from experiment_yolo_torch.utils.seeded import contention_offsets

EXP = ("ex2(dtv * r.a2[n])", "(dtv * r.a2[n])")
READ_B = ("const float4 bq = b4[q];", "const float4 bq = make_float4(dtv, xv, u, dtv);")
READ_C = ("const float4 cq = c4[q];", "const float4 cq = make_float4(xv, u, dtv, xv);")
COPIES = (("    if (k < tiles) load_tile", "    if (k < tiles && a.L < 0) load_tile"),
          ("    if (k + STAGES - 1 < tiles)\n", "    if (k + STAGES - 1 < tiles && a.L < 0)\n"))
# variant -> (old, new) pieces of csrc/selective_scan.cu
K4_VARIANTS = {
    "as it is": (),
    "no exp": (EXP,),
    "expf": ((EXP[0], "expf(dtv * r.a2[n])"),),
    "no shared-memory reads of B, C": (READ_B, READ_C),
    "no copies from device memory": COPIES,
    "no copies, no exp, no reads of B, C": (*COPIES, EXP, READ_B, READ_C),
    "every step checked": (("    if (s + TILE <= w.s1)\n", "    if (s + TILE <= w.s1 && a.L < 0)\n"),),
    "2 stages": (("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),),
    "tiles of 4 steps": (("constexpr int TILE = 8; ", "constexpr int TILE = 4; "),),
    "4 warps a block": (("constexpr int WARPS = 2;", "constexpr int WARPS = 4;"),),
}
# variant -> (old, new) pieces of csrc/ldconv_gather.cu
K3_VARIANTS = {
    "as it is": (),
    "tiles of 32 KB": (("T * NC > 4096", "T * NC > 8192"),),
    "tiles of 8 KB": (("T * NC > 4096", "T * NC > 2048"),),
    "channel loop unrolled by 2": (("#pragma unroll 4\n    for (int c = first", "#pragma unroll 2\n    for (int c = first"),),
    "channel loop unrolled by 8": (("#pragma unroll 4\n    for (int c = first", "#pragma unroll 8\n    for (int c = first"),),
}
# variant -> (old, new) pieces of csrc/ldconv_gather.cu, for the backward kernel
K3BWD_VARIANTS = {
    "as it is": (),
    "no pairs or merges: four 4-byte adds a sample": (("r.merge = live &&", "r.merge = false &&"),
                                                       ("r.pair = aligned &&", "r.pair = false &&"),
                                                       ("r.cross = aligned &&", "r.cross = false &&")),
    "no channel split": (("BWD_MIN_THREADS = 270336;", "BWD_MIN_THREADS = 0;"),),
    "at least 4 channels a thread": (("BWD_MIN_CHANNELS = 8;", "BWD_MIN_CHANNELS = 4;"),),
    "at least 16 channels a thread": (("BWD_MIN_CHANNELS = 8;", "BWD_MIN_CHANNELS = 16;"),),
}
# variant -> (old, new) pieces of csrc/nms_suppress.cu
K2_VARIANTS = {
    "as it is": (),
    "pair blocks of 64 rows": (("constexpr int PAIR_ROWS = 128;", "constexpr int PAIR_ROWS = 64;"),),
    "no IEEE division (wrong masks)": (("const float iou = __fdiv_rn(", "const float iou = __fmul_rn("),),
    "sixteen rows' loads in flight": (("int t[8];", "int t[16];"), ("u < 8; ++u) {", "u < 16; ++u) {"),
                                      ("u < 8; ++u)\n", "u < 16; ++u)\n")),
}
SCAN_LEVELS = ((25600, 32, 1), (6400, 64, 2), (1600, 128, 4), (400, 256, 8))  # L, d_inner, dt_rank at P2..P5
GATHER_LAYERS = ((3, 3, 2, 640), (16, 3, 2, 320), (32, 3, 2, 160), (64, 3, 2, 80), (128, 1, 1, 40), (64, 1, 1, 80),
                 (64, 1, 1, 80), (32, 1, 1, 160), (32, 3, 2, 160), (64, 3, 2, 80))  # C, N, stride, source size
BATCH = 8


def build_variants(name: str, variants, baseline: Path | None = None) -> dict:
    """One library per variant of ``csrc/<name>.cu``, all nvcc runs at once;
    with ``baseline`` (the root of another checkout) also that checkout's
    ``csrc/<name>.cu`` as it is, under the tag ``"baseline"``."""
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / f"{name}.cu").read_text()
    procs = {}
    for i, (tag, pieces) in enumerate(variants.items()):
        text = source
        for old, new in pieces:
            if old not in text:
                raise ValueError(f"variant {tag!r} of {name}.cu: {old!r} is not in the source")
            text = text.replace(old, new)
        path = out_dir / f"{name}_{i}.cu"
        path.write_text(text)
        lib = path.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(path)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    if baseline is not None:
        csrc = baseline / "experiment_yolo_torch" / "csrc"
        lib = out_dir / f"{name}_baseline.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / f"{name}.cu")]
        procs["baseline"] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {tag!r} of {name}.cu:\n{log}")
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def swap_in(name: str, lib: ctypes.CDLL) -> None:
    """Put ``lib`` behind the wrappers of ``csrc/<name>.cu``."""
    _build._libs[name] = lib
    for entry in [e for e in _build._fns if e.startswith(name)]:
        del _build._fns[entry]


def device_ms(fn, mark: str, runs: int = 5) -> dict:
    """Device milliseconds per call of ``fn`` by kernel, for kernels whose
    name holds ``mark`` (that prefix dropped from the keys; ``""`` takes every
    device event of the trace, fills and copies included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].replace("void ", "").replace(mark, "").strip("_") or e.key:
            e.self_device_time_total / runs / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and mark in e.key and e.self_device_time_total}


def scan_variants(gen: torch.Generator) -> None:
    kw = dict(reverse=(False, False, True, True), source=(0, 1, 0, 1))
    calls = {}
    for length, dim, rank in SCAN_LEVELS:
        dbl = torch.randn(BATCH, 4, length, rank + 32, generator=gen).cuda()
        calls[length] = (torch.randn(BATCH, 2, length, dim, generator=gen).cuda(),
                         (0.01 + 1e-4 * torch.randn(BATCH, 4, length, dim, generator=gen)).cuda(),
                         -torch.arange(1, 17, dtype=torch.float32).expand(4, dim, 16).contiguous().cuda(),
                         dbl[..., rank:rank + 16], dbl[..., rank + 16:], torch.randn(4, dim, generator=gen).cuda())

    def rel_err(args):
        """The worst direction's max abs error over that direction's largest plain value."""
        want = selective_scan_plain(*args, **kw)
        return ((selective_scan(*args, **kw) - want).abs().amax((0, 2, 3)) / want.abs().amax((0, 2, 3))).max().item()

    with torch.no_grad():
        # the slower the decay, the longer a difference between the kernel's exp and the plain version's lives
        x, dt, *rest = calls[6400]
        print(json.dumps({"kernel": "K4", "rel_err_at_L6400": {"step sizes near 0.01": rel_err(calls[6400]),
                                                               "near 0.001": rel_err((x, dt / 10, *rest))}}), flush=True)
        for tag, lib in build_variants("selective_scan", K4_VARIANTS).items():
            swap_in("selective_scan", lib)
            row = {"kernel": "K4", "variant": tag, "rel_err_at_L400": rel_err(calls[400])}
            for length, args in calls.items():
                passes = device_ms(lambda: selective_scan(*args, **kw), "selective_scan_kernel")
                row[f"L{length}"] = {**passes, "all": sum(passes.values())}
            print(json.dumps(row), flush=True)


def gather_variants(gen: torch.Generator) -> None:
    layers = []
    for c, n, stride, size in GATHER_LAYERS:
        h = size // stride
        smooth = (torch.rand(2 * n, generator=gen) * 0.6 - 0.3)[None, :, None, None].expand(BATCH, 2 * n, h, h)
        rand = torch.randn(BATCH, 2 * n, h, h, generator=gen) * 4
        rand = torch.where(torch.rand(rand.shape, generator=gen) < 0.02, rand + 40 * rand.sign(), rand)
        layers.append((torch.randn(BATCH, c, size, size, generator=gen).cuda(), smooth.contiguous().cuda(), rand.cuda(), stride))
    want = [ldconv_gather_plain(x, rand, s) for x, _, rand, s in layers]
    for tag, lib in build_variants("ldconv_gather", K3_VARIANTS).items():
        swap_in("ldconv_gather", lib)
        err = max((ldconv_gather_fwd(x, rand, s) - w).abs().max().item() for (x, _, rand, s), w in zip(layers, want))
        row = {"kernel": "K3", "variant": tag, "max_abs_err": err}
        for kind, which in (("smooth", 1), ("random", 2)):
            per_layer = [sum(device_ms(lambda: ldconv_gather_fwd(layer[0], layer[which], layer[3]),
                                       "ldconv_gather_kernel").values()) for layer in layers]
            row[f"{kind}_offsets_ms"] = {"layers": per_layer, "all": sum(per_layer)}
        print(json.dumps(row), flush=True)


def gather_bwd_variants(gen: torch.Generator, baseline: Path | None) -> None:
    layers = []
    for c, n, stride, size in GATHER_LAYERS:
        h = size // stride
        x = torch.randn(BATCH, c, size, size, generator=gen)
        smooth = (torch.rand(2 * n, generator=gen) * 0.6 - 0.3)[None, :, None, None].expand(BATCH, 2 * n, h, h)
        rand = torch.randn(BATCH, 2 * n, h, h, generator=gen) * 4
        rand = torch.where(torch.rand(rand.shape, generator=gen) < 0.02, rand + 40 * rand.sign(), rand)
        cont = contention_offsets(x, rand, stride, gen)
        dy = torch.randn(BATCH, h * h, n * c, generator=gen)
        layers.append((x.cuda(), {"smooth": smooth.contiguous().cuda(), "random": rand.cuda(), "contention": cont.cuda()},
                       dy.cuda(), stride))
    want = {kind: [ldconv_gather_bwd_plain(x, offs[kind], dy, s) for x, offs, dy, s in layers]
            for kind in ("random", "contention")}

    def rel_err(kind):
        """The worst output's max abs error over its own largest plain value (dx and doff apart)."""
        worst = 0.0
        for (x, offs, dy, s), ref in zip(layers, want[kind]):
            for got, exp in zip(ldconv_gather_bwd(x, offs[kind], dy, s), ref):
                worst = max(worst, ((got - exp).abs().max() / exp.abs().max().clamp(min=1e-30)).item())
        return worst

    for tag, lib in build_variants("ldconv_gather", K3BWD_VARIANTS, baseline).items():
        swap_in("ldconv_gather", lib)
        row = {"kernel": "K3 bwd", "variant": tag, "rel_err": {kind: rel_err(kind) for kind in want}}
        for kind in ("smooth", "random", "contention"):
            per_layer = [device_ms(lambda: ldconv_gather_bwd(x, offs[kind], dy, s), "") for x, offs, dy, s in layers]
            row[f"{kind}_offsets_ms"] = {"layers": [sum(v.values()) for v in per_layer],
                                         "all": sum(sum(v.values()) for v in per_layer),
                                         "by_kernel": {k: sum(v.get(k, 0.0) for v in per_layer)
                                                       for k in {k for v in per_layer for k in v}}}
        print(json.dumps(row), flush=True)


def nms_cases(gen: torch.Generator):
    """Clustered xyxy candidates of 8 images (about a fifth of them invalid)
    at K = 1,024 and 8,192, and the IoU threshold of the main path."""
    cases = {}
    for k in (1024, 8192):
        centres = (torch.rand(BATCH, k // 8, 2, generator=gen) * 600).repeat_interleave(8, 1)
        centres = centres + torch.randn(BATCH, k, 2, generator=gen) * 6
        wh = torch.rand(BATCH, k, 2, generator=gen) * 50 + 10
        boxes = torch.cat([centres - wh / 2, centres + wh / 2], -1).contiguous()
        valid = torch.rand(BATCH, k, generator=gen) > 0.2
        cases[k] = (boxes.cuda(), valid.cuda())
    return cases, 0.7


def nms_variants(gen: torch.Generator) -> None:
    cases, thr = nms_cases(gen)
    want = {k: nms_suppress_plain(b, v, thr) for k, (b, v) in cases.items()}
    for tag, lib in build_variants("nms_suppress", K2_VARIANTS).items():
        swap_in("nms_suppress", lib)
        row = {"kernel": "K2", "variant": tag}
        for k, (b, v) in cases.items():
            row[f"K{k}"] = {"mismatched": int((nms_suppress(b, v, thr) != want[k]).sum()), "kept": int(want[k].sum()),
                            "candidates": int(v.sum()),
                            **device_ms(lambda: nms_suppress(b, v, thr), "nms_suppress_kernel")}
        print(json.dumps(row), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    args = sys.argv[1:]
    baseline = None
    if "--baseline" in args:
        i = args.index("--baseline")
        baseline = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    which = args[0] if args else "all"
    if which not in ("k2", "k3", "k3bwd", "k4", "all"):
        sys.exit(f"kernel_variants: unknown target {which!r}: one of k2, k3, k3bwd, k4, all")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    _build.build_all()
    gen = torch.Generator().manual_seed(0)
    targets = {"k4": scan_variants, "k3": gather_variants}
    for name, fn in targets.items():
        if which in (name, "all"):
            fn(gen)
    if which in ("k3bwd", "all"):
        gather_bwd_variants(gen, baseline)
    if which in ("k2", "all"):
        nms_variants(gen)


if __name__ == "__main__":
    main()
