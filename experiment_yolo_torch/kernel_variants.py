"""What bounds K1, K2, K3, K3's backward, their bf16 forms, K4, K4's backward
and K5 on the card: time throwaway variants of their sources.

Usage, on a machine with an NVIDIA Hopper GPU and the CUDA toolkit:

    python3 -m experiment_yolo_torch.kernel_variants [k1|k1bf16|k2|k3|k3bwd|k3bf16|k3bwdbf16|k4|k4bwd|k5|all] [--baseline ROOT]

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
pre-NMS top-k) and at K = 8,192. K5 on the pools the seeded LD-P2 model
gives the main paths at batch 8, 640: the validator's (multi-label, K =
4,096 at conf 0.001, quirk on and off) and the predictor's (K = 1,024 at
conf 0.25), and on the made-up trained-like pool (5% above the 0.25 floor);
each K5 variant's row also counts the made-up pools of
``utils/seeded.py:soft_nms_cases`` (quirk on and off) on which it differs
from the plain version, so that the rows marked "mutation" show which case
catches a broken pre-test. One JSON line per variant; the card's name and
power limit come first, and for K4 the real kernel's error against its
plain version at L = 6,400 with step sizes near 0.01 and near 0.001.

``k3bf16`` and ``k3bwdbf16`` time K3's bf16 forms per layer on bf16
sources and incoming gradients and on smooth, random, contention and seam
offsets (``bf16_layers``), each beside its bytes bound: the forward beside
the f32 form on the same positions (the sources widened beforehand), with
its bit-equality to the plain version on every kind; the backward with
every launch of a call counted, its ``dx`` against the plain version in bf16
spacings (the ``chip_smoke.py`` gate: at most 1 passes), ``doff``'s error
and whether two calls give the same bits.

``k1`` and ``k1bf16`` time K1's forward (f32 and bf16 maps) on the seeded
LD-P2 model's Detect maps at batch 8, 640 (a bf16 forward's for ``k1bf16``),
on random logits at the same shapes and at imgsz 608 (levels of 152, 76 and
38 squared): one launch for every level, and each level alone (one launch a
level), beside the bytes bound; each variant's width per level, its error
against the plain version and, with ``--baseline``, whether its output is
bit-equal to the baseline's. The variants: loads of 2, 8 and 16 bytes a
bin (the widest a level may take; 4 as built), 16-byte loads with the side
groups of a thread in turn, at least 6 blocks a SM, half the sides' loads at
a time, no exp, loads only, the runtime-``reg_max`` instance, and 64 or 256
threads a block; the ptxas lines (registers, spills) of each build come
first.

``k4bwd`` times K4's backward by kernel name at the four levels, through
the autograd Function (one forward kept, its backward run again), on the K4
inputs above with a seeded ``dy``, with each variant's largest error against
the f32 plain backward over the six gradients and whether two calls gave the
same bits; the ptxas lines come first. Its variants leave out the exps, the
sums over channels, or the copies into the ring, or change the history's row
pad, the tile length (in the source and the wrapper together), the ring's
stages and the warps a block; ``--baseline`` calls the other checkout's
backward through the parent commit's C signature, which took no scratch for
the tile start states.

``--baseline ROOT`` also times K1, K3's backward, K3's bf16 forms, K4's backward or K5 built
from another checkout (say the parent commit, unpacked with ``git
archive``), so that two versions are compared in one process. K1's baseline
is called through the earlier C signature, one map a launch (the first
design's), K4's backward's through the one without the tile start states; K3's backward,
K3's bf16 forward and K5 run behind this checkout's wrapper, so the two
sources must have the same ``ldconv_gather_bwd_launch``,
``ldconv_gather_bf16_launch`` or ``soft_nms_launch`` signature; the bf16
backward's baseline is called through the earlier C signature, which took no
scratch (an f32 ``dx`` filled with zeros, the kernel, the cast). A time comes
only from a trace that holds every launch of the timed calls; where five
traces in a row miss some, the row shows NaN.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels.ldconv_gather import (_BWD_ARGS, _geom_args, ldconv_gather_bwd,
                                                             ldconv_gather_bwd_plain, ldconv_gather_fwd,
                                                             ldconv_gather_plain)
from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress, nms_suppress_plain
from experiment_yolo_torch.ops.kernels.selective_scan import (chunk_length, selective_scan, selective_scan_bwd_plain,
                                                              selective_scan_plain)
from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms, soft_nms_plain
from experiment_yolo_torch.utils.seeded import (VAL_SEED, contention_offsets, letterboxed, model_input, seam_offsets,
                                                seeded_batch, seeded_images, seeded_model, soft_nms_cases,
                                                soft_nms_pools)

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
# variant -> ((old, new) pieces of csrc/selective_scan.cu, settings of ops/kernels/selective_scan.py), for the
# backward kernels
BWD_LOADS = (("    if (k < tiles) load_bwd_tile<VEC>(st[k]", "    if (k < tiles && a.L < 0) load_bwd_tile<VEC>(st[k]"),
             ("    if (k + WALK_STAGES - 1 < tiles)\n      load_bwd_tile",
              "    if (k + WALK_STAGES - 1 < tiles && a.L < 0)\n      load_bwd_tile"),
             ("    if (k < tiles) load(k);", "    if (k < tiles && a.L < 0) load(k);"),
             ("    if (k + BWD_STAGES - 1 < tiles) load(", "    if (k + BWD_STAGES - 1 < tiles && a.L < 0) load("))


def _bwd_tile(n: int):
    """Tiles of ``n`` steps, in the source and in the wrapper (which sizes the tile start states' scratch)."""
    return (("constexpr int BWD_TILE = 4;", f"constexpr int BWD_TILE = {n};"),), {"BWD_TILE": n}


K4BWD_VARIANTS = {
    "as it is": ((), {}),
    "no exps": ((("ex2(dtv * r.a2[n])", "(dtv * r.a2[n])"),), {}),
    "no channel sums (dB, dC)": ((("  if (GUARD && i >= steps) return;", "  if (a.L > 0) return;"),), {}),
    "no ring: no copies from device memory": (BWD_LOADS, {}),
    "history rows of 32 floats (no pad)": ((("constexpr int HIST_ROW = LANES + 4;", "constexpr int HIST_ROW = LANES;"),),
                                           {}),
    "tiles of 2 steps": _bwd_tile(2),
    "tiles of 8 steps": _bwd_tile(8),
    "3 stages": ((("constexpr int BWD_STAGES = 2;", "constexpr int BWD_STAGES = 3;"),), {}),
    "2 warps a block": ((("constexpr int BWD_WARPS = 1;", "constexpr int BWD_WARPS = 2;"),), {}),
    "pass 1 in tiles of 4 steps, 2 stages": ((("constexpr int WALK_TILE = 8;", "constexpr int WALK_TILE = 4;"),
                                              ("constexpr int WALK_STAGES = 3;", "constexpr int WALK_STAGES = 2;")), {}),
    "pass 1 in tiles of 16 steps, 2 stages": ((("constexpr int WALK_TILE = 8;", "constexpr int WALK_TILE = 16;"),
                                               ("constexpr int WALK_STAGES = 3;", "constexpr int WALK_STAGES = 2;")), {}),
    "pass 1 in blocks of 4 warps": ((("constexpr int WALK_WARPS = 2;", "constexpr int WALK_WARPS = 4;"),), {}),
    "pass 1 at most 80 registers": ((("__launch_bounds__(WALK_WARPS * LANES) selective_scan_bwd_kernel_starts",
                                      "__launch_bounds__(WALK_WARPS * LANES, 12) selective_scan_bwd_kernel_starts"),),
                                    {}),
    "main pass at most 96 registers": ((("__launch_bounds__(BWD_WARPS * LANES) selective_scan_bwd_kernel_main",
                                         "__launch_bounds__(BWD_WARPS * LANES, 21) selective_scan_bwd_kernel_main"),),
                                       {}),
    "params in blocks of 8 warps": ((("constexpr int PARAM_WARPS = 32;", "constexpr int PARAM_WARPS = 8;"),), {}),
}
# the parent commit's C signature of selective_scan_bwd_launch took no scratch for the tile start states (the
# tenth pointer now)
K4BWD_HS_ARG = 9
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
# variant -> (old, new) pieces of csrc/ldconv_gather.cu, for the bf16 forward kernel
K3BF16_VARIANTS = {
    "as it is": (),
    "no 4-byte tile reads in the stores": (("if (NC % 8 == 0 && head == 0) {", "if (NC < 0) {"),),
    "tiles of 8 KB": (("T * NC > 8192 ||", "T * NC > 4096 ||"),),
    "tiles of 32 KB": (("T * NC > 8192 ||", "T * NC > 16384 ||"),),
    "no two blocks a SM rule": (("< 2LL * sms", "< 0LL * sms"),),
}
# variant -> (old, new) pieces of csrc/ldconv_gather.cu, for the bf16 backward
K3BWDBF16_VARIANTS = {
    "as it is": (),
    "no 16-byte quads (the f32 form's adds)": (("constexpr bool quads = !std::is_same<TX, float>::value;",
                                                "constexpr bool quads = false;"),),
}
# the kernel each call of a bf16 form launches once: the forward's by the source ("baseline": the parent
# commit's template instantiation), the backward's in either
BF16_FWD_KERNELS = {"as it is": "ldconv_gather_bf16_kernel", "baseline": "ldconv_gather_kernel<__nv_bfloat16"}
BF16_BWD_KERNEL = "ldconv_gather_bwd_kernel<__nv_bfloat16"
OFFSET_KINDS = ("smooth", "random", "contention", "seam")
# variant -> ((old, new) pieces of csrc/dfl_decode.cu, settings of ops/kernels/dfl_decode.py)
K1_EXP = ("const float e = expf(v[s][r][j] - m);", "const float e = v[s][r][j] - m;")


def _k1_loads(n: int, *pieces):
    """A thread's load a bin at most ``n`` bytes, in the source and in the wrapper, and further ``pieces``."""
    return (("constexpr int MAX_LOAD_BYTES = 4;", f"constexpr int MAX_LOAD_BYTES = {n};"), *pieces), \
        {"MAX_LOAD_BYTES": n}


K1_VARIANTS = {
    "as it is": ((), {}),
    "2-byte loads (bf16: one anchor a thread)": _k1_loads(2),
    "8-byte loads": _k1_loads(8),
    "16-byte loads": _k1_loads(16),
    "16-byte loads, side groups in turn": _k1_loads(16, ("#pragma unroll\n    for (int s0 = 0;",
                                                         "#pragma unroll 1\n    for (int s0 = 0;")),
    "at least 6 blocks a SM": ((("__launch_bounds__(DECODE_THREADS)", "__launch_bounds__(DECODE_THREADS, 6)"),), {}),
    "half the sides' loads at a time": ((("constexpr int SIDES = 4 / R::WORDS;",
                                          "constexpr int SIDES = (4 / R::WORDS + 1) / 2;"),), {}),
    "no exp": ((K1_EXP,), {}),
    "loads only: no max, no exp": ((K1_EXP, ("#pragma unroll\n          for (int r = 0; r < REG; ++r) "
                                             "m = fmaxf(m, v[s][r][j]);", "m = 0.f;")), {}),
    "runtime reg_max instance": ((("if (reg_max == REG_MAX)", "if (reg_max == -REG_MAX)"),), {}),
    "64 threads a block": ((("constexpr int DECODE_THREADS = 128;", "constexpr int DECODE_THREADS = 64;"),),
                           {"THREADS": 64}),
    "256 threads a block": ((("constexpr int DECODE_THREADS = 128;", "constexpr int DECODE_THREADS = 256;"),),
                            {"THREADS": 256}),
}
K1_OLD_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int)
# variant -> (old, new) pieces of csrc/nms_suppress.cu
K2_VARIANTS = {
    "as it is": (),
    "pair blocks of 64 rows": (("constexpr int PAIR_ROWS = 128;", "constexpr int PAIR_ROWS = 64;"),),
    "no IEEE division (wrong masks)": (("const float iou = __fdiv_rn(", "const float iou = __fmul_rn("),),
    "sixteen rows' loads in flight": (("int t[8];", "int t[16];"), ("u < 8; ++u) {", "u < 16; ++u) {"),
                                      ("u < 8; ++u)\n", "u < 16; ++u)\n")),
}
PRE_TEST = "fmaf(thr, u, -inter) >= 0.f"
SIZE = ("constexpr int THREADS = 512;", "constexpr int MIN_PER_THREAD = 2;")
# variant -> (old, new) pieces of csrc/soft_nms.cu; a variant that empties a part times the rest
K5_VARIANTS = {
    "as it is": (),
    "up to 1,024 threads an image": ((SIZE[0], SIZE[0].replace("512", "1024")),),
    "up to 256 threads an image": ((SIZE[0], SIZE[0].replace("512", "256")),),
    "at least 4 candidates a thread": ((SIZE[1], SIZE[1].replace("2;", "4;")),),
    "at least 8 candidates a thread": ((SIZE[1], SIZE[1].replace("2;", "8;")),),
    "every launched warp steps": (("= max(32, min(static_cast<int>(blockDim.x), (n + 32 * C - 1) / (32 * C) * 32));",
                                   "= static_cast<int>(blockDim.x);"),),
    "decay pass emptied (the pick's removal kept)": (("slow |= 1u << c;", "slow |= 0u;"),),
    "reductions emptied: picks in index order, slots and barrier kept": (
        ("unsigned best = __reduce_max_sync(FULL, key[0]);", "unsigned best = key[0] | 0x3f800000u;"),
        ("unsigned pick = __reduce_min_sync(FULL, key[0] == best ? mine : UINT_MAX);",
         "unsigned pick = static_cast<unsigned>(s % max(n, 1)) + (mine & 0u);"),
        ("unsigned count = quirk ? __reduce_add_sync(FULL, static_cast<unsigned>(cnt)) : 0u;",
         "unsigned count = 2u + (cnt & 0);"),
        ("best = __reduce_max_sync(FULL, e.x);", "best = e.x | 0x3f800000u;"),
        ("pick = __reduce_min_sync(FULL, e.x == best ? e.y : UINT_MAX);",
         "pick = static_cast<unsigned>(s % max(n, 1)) + (e.y & 0u);"),
        ("count = quirk ? __reduce_add_sync(FULL, e.z) : 0u;", "count = 2u + (e.z & 0u);"),
        ("if (!(quirk ? count >= 2u : best != 0u)) break;", "if (s >= n) break;")),
    "no pre-test: a division per live candidate": ((f" && !({PRE_TEST})", ""),),
    "no floor compaction: every valid candidate loaded": (
        ("ok[j] && sc[j] > KEEP_FLOOR);", "ok[j]);"),
        ("pos != s_first ? s_live[pos] : 0.f;", "pos != s_first && s_live[pos] > KEEP_FLOOR ? s_live[pos] : 0.f;")),
    "mutation: pre-test > in place of >=": ((PRE_TEST, PRE_TEST.replace(">=", ">")),),
    "mutation: pre-test without the fma": ((PRE_TEST, "__fsub_rn(__fmul_rn(thr, u), inter) >= 0.f"),),
    "mutation: the pre-test decides alone": (("if (iou > thr) {", "if (true) {"),),
}
SCAN_LEVELS = ((25600, 32, 1), (6400, 64, 2), (1600, 128, 4), (400, 256, 8))  # L, d_inner, dt_rank at P2..P5
GATHER_LAYERS = ((3, 3, 2, 640), (16, 3, 2, 320), (32, 3, 2, 160), (64, 3, 2, 80), (128, 1, 1, 40), (64, 1, 1, 80),
                 (64, 1, 1, 80), (32, 1, 1, 160), (32, 3, 2, 160), (64, 3, 2, 80))  # C, N, stride, source size
BATCH = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
build_logs: dict = {}  # variant -> nvcc's output (ptxas registers and spills), of the last build_variants


def build_variants(name: str, variants, baseline: Path | None = None) -> dict:
    """One library per variant of ``csrc/<name>.cu``, all nvcc runs at once;
    with ``baseline`` (the root of another checkout) also that checkout's
    ``csrc/<name>.cu`` as it is, under the tag ``"baseline"``."""
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, _build.CSRC, pieces) for tag, pieces in variants.items()]
    if baseline is not None:
        jobs.append(("baseline", baseline / "experiment_yolo_torch" / "csrc", ()))
    procs = {}
    for i, (tag, csrc, pieces) in enumerate(jobs):
        text = (csrc / f"{name}.cu").read_text()
        for old, new in pieces:
            if old not in text:
                raise ValueError(f"variant {tag!r} of {csrc / name}.cu: {old!r} is not in the source")
            text = text.replace(old, new)
        path = out_dir / f"{name}_{i}.cu"
        path.write_text(text)
        lib = path.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(path)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {tag!r} of {name}.cu:\n{log}")
        build_logs[tag] = log
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def swap_in(name: str, lib: ctypes.CDLL) -> None:
    """Put ``lib`` behind the wrappers of ``csrc/<name>.cu``."""
    _build._libs[name] = lib
    for entry in [e for e in _build._fns if e.startswith(name)]:
        del _build._fns[entry]


def device_ms(fn, kernel: str, per_call: int, runs: int = 5, span: str | None = None) -> dict:
    """Device milliseconds per call of ``fn`` by kernel, for kernels whose
    name holds ``span`` (by default ``kernel``; that prefix dropped from the
    keys; ``""`` takes every device event of the trace, fills and copies
    included), from a trace that holds all ``runs * per_call`` launches of
    the kernels named ``kernel`` (``per_call``: those one call launches). A
    trace now and then misses some, and its times would read low: after five
    such traces in a row the one key ``"incomplete trace"`` holds NaN. A
    spin kernel, not timed, goes first: late in a long process a trace has
    been seen to drop its first kernel every time."""
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
        if sum(e.count for e in events if kernel in e.key) == runs * per_call:
            return {e.key.split("(")[0].replace("void ", "").replace(span, "").strip("_") or e.key:
                    e.self_device_time_total / runs / 1e3 for e in events if span in e.key}
    return {"incomplete trace": float("nan")}


def scan_variants(gen: torch.Generator) -> None:
    kw = dict(reverse=(False, False, True, True), source=(0, 1, 0, 1))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
                bsz, g, _, dim = args[1].shape
                kernels = 3 if length > chunk_length(bsz * g, length, dim, sms) else 1  # ends and carry if chunked
                passes = device_ms(lambda: selective_scan(*args, **kw), "selective_scan_kernel", kernels)
                row[f"L{length}"] = {**passes, "all": sum(passes.values())}
            print(json.dumps(row), flush=True)


def _k4bwd_old_signature(launch):
    """``_build.launch`` for the parent's backward library: its entry point as the wrapper calls it, without the
    tile start states' scratch."""
    def call(name, argtypes, *args, **kw):
        if name == "selective_scan_bwd":
            argtypes = (*argtypes[:K4BWD_HS_ARG], *argtypes[K4BWD_HS_ARG + 1:])
            args = (*args[:K4BWD_HS_ARG], *args[K4BWD_HS_ARG + 1:])
        return launch(name, argtypes, *args, **kw)

    return call


def scan_bwd_variants(gen: torch.Generator, baseline: Path | None) -> None:
    from experiment_yolo_torch.ops.kernels import selective_scan as k4

    kw = dict(reverse=(False, False, True, True), source=(0, 1, 0, 1))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    calls = {}
    for length, dim, rank in SCAN_LEVELS:
        dbl = torch.randn(BATCH, 4, length, rank + 32, generator=gen).cuda()
        args = (torch.randn(BATCH, 2, length, dim, generator=gen).cuda(),
                (0.01 + 1e-4 * torch.randn(BATCH, 4, length, dim, generator=gen)).cuda(),
                -torch.arange(1, 17, dtype=torch.float32).expand(4, dim, 16).contiguous().cuda(),
                dbl[..., rank:rank + 16], dbl[..., rank + 16:], torch.randn(4, dim, generator=gen).cuda())
        dy = torch.randn(BATCH, 4, length, dim, generator=gen).cuda()
        chunked = length > chunk_length(BATCH * 4, length, dim, sms)
        # the starts, g's carry where chunked, main, dx, dB/dC groups, dA/dD; the parent's (the baseline): g's ends
        # and carry where chunked, main, dx, dB/dC groups, dA/dD
        launches = (4 + chunked + (dim > 32), 3 + 2 * chunked + (dim > 32))
        calls[length] = (args, dy, launches, selective_scan_bwd_plain(*args, dy, **kw))
    libs = build_variants("selective_scan", {tag: pieces for tag, (pieces, _) in K4BWD_VARIANTS.items()}, baseline)
    kept = ("registers", "spill", "bwd_kernel")
    ptxas = {tag: [ln.strip() for ln in log.splitlines() if any(k in ln for k in kept)] for tag, log in build_logs.items()}
    print(json.dumps({"kernel": "K4 bwd", "ptxas": ptxas}), flush=True)
    settings, launch = {"BWD_TILE": k4.BWD_TILE}, _build.launch
    for tag, lib in libs.items():
        swap_in("selective_scan", lib)
        for name, value in {**settings, **K4BWD_VARIANTS.get(tag, ((), {}))[1]}.items():
            setattr(k4, name, value)
        _build.launch = _k4bwd_old_signature(launch) if tag == "baseline" else launch
        row, err = {"kernel": "K4 bwd", "variant": tag}, 0.0
        for length, (args, dy, launches, want) in calls.items():
            leaves = [t.detach().requires_grad_() for t in args]
            y = selective_scan(*leaves, **kw)
            got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
            again = torch.autograd.grad(y, leaves, dy, retain_graph=True)
            err = max(err, *(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)))
            passes = device_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
                               "selective_scan_bwd_kernel", launches[tag == "baseline"])
            row[f"L{length}"] = {**passes, "all": sum(passes.values()),
                                 "same_bits_twice": all(torch.equal(a, b) for a, b in zip(got, again))}
        row["rel_err_vs_plain"] = err
        row["all_levels"] = sum(v["all"] for k, v in row.items() if k.startswith("L"))
        print(json.dumps(row), flush=True)
    _build.launch = launch
    for name, value in settings.items():
        setattr(k4, name, value)


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
                                       "ldconv_gather_kernel", 1).values()) for layer in layers]
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
            per_layer = [device_ms(lambda: ldconv_gather_bwd(x, offs[kind], dy, s), "ldconv_gather_bwd_kernel", 1,
                                   span="") for x, offs, dy, s in layers]
            row[f"{kind}_offsets_ms"] = {"layers": [sum(v.values()) for v in per_layer],
                                         "all": sum(sum(v.values()) for v in per_layer),
                                         "by_kernel": {k: sum(v.get(k, 0.0) for v in per_layer)
                                                       for k in {k for v in per_layer for k in v}}}
        print(json.dumps(row), flush=True)


def bf16_layers(gen: torch.Generator):
    """The ten LD-P2 layers at batch 8, 640 in bf16: (bf16 source, {kind: offsets}, bf16 incoming gradient,
    stride), the offsets smooth (one value per channel, as the seeded model's), random (N(0, 4^2) px, 2% pushed
    40 px further), contention (90% of the samples on sixteen source positions) and seam."""
    layers = []
    for c, n, stride, size in GATHER_LAYERS:
        h = size // stride
        x = torch.randn(BATCH, c, size, size, generator=gen)
        smooth = (torch.rand(2 * n, generator=gen) * 0.6 - 0.3)[None, :, None, None].expand(BATCH, 2 * n, h, h)
        rand = torch.randn(BATCH, 2 * n, h, h, generator=gen) * 4
        rand = torch.where(torch.rand(rand.shape, generator=gen) < 0.02, rand + 40 * rand.sign(), rand)
        offs = {"smooth": smooth.contiguous(), "random": rand, "contention": contention_offsets(x, rand, stride, gen),
                "seam": seam_offsets(x, rand, stride)}
        dy = torch.randn(BATCH, h * h, n * c, generator=gen)
        layers.append((x.cuda().bfloat16(), {k: v.cuda() for k, v in offs.items()}, dy.cuda().bfloat16(), stride))
    return layers


def _bf16_bounds(layers, backward: bool):
    """Each layer's bytes bound (ms) at bf16: forward x, offsets read and out written; backward x, offsets, dy
    read and dx, doff written."""
    out = []
    for x, offs, dy, _ in layers:
        o = offs["smooth"]
        nbytes = x.numel() * 2 * (2 if backward else 1) + o.numel() * 4 * (2 if backward else 1) + dy.numel() * 2
        out.append(nbytes / 3.35e12 * 1e3)
    return out


def _within_bf16_spacing(got, want) -> float:
    """The worst element's error over one bf16 spacing of the plain value plus 1e-5 of the largest plain value
    (chip_smoke.py's bf16 dx gate: at most 1 passes)."""
    want = want.float()
    _, e = torch.frexp(want.abs().clamp(min=torch.finfo(torch.bfloat16).tiny))
    allowed = torch.ldexp(torch.ones_like(want), e - 8) + 1e-5 * want.abs().max()
    return ((got.float() - want).abs() / allowed).max().item()


def gather_bf16_variants(gen: torch.Generator, baseline: Path | None) -> None:
    """The bf16 forward per layer and offset kind, each variant (and the baseline's bf16 form) beside the f32
    form on the same positions (the sources widened beforehand, not timed); bit-equality with the plain
    version on every kind."""
    layers = bf16_layers(gen)
    wide = [x.float() for x, _, _, _ in layers]
    bounds = _bf16_bounds(layers, False)
    print(json.dumps({"kernel": "K3 bf16", "bound_ms": {"layers": bounds, "all": sum(bounds)}}), flush=True)
    want = {kind: [ldconv_gather_plain(x, offs[kind], s) for x, offs, _, s in layers] for kind in OFFSET_KINDS}
    for tag, lib in build_variants("ldconv_gather", K3BF16_VARIANTS, baseline).items():
        swap_in("ldconv_gather", lib)
        name = BF16_FWD_KERNELS["baseline" if tag == "baseline" else "as it is"]
        row = {"kernel": "K3 bf16", "variant": tag,
               "bit_equal": {kind: all(torch.equal(ldconv_gather_fwd(x, offs[kind], s), w)
                                       for (x, offs, _, s), w in zip(layers, want[kind])) for kind in OFFSET_KINDS}}
        for kind in OFFSET_KINDS:
            per_layer = [sum(device_ms(lambda: ldconv_gather_fwd(x, offs[kind], s), name, 1, span="").values())
                         for x, offs, _, s in layers]
            f32 = [sum(device_ms(lambda: ldconv_gather_fwd(xw, offs[kind], s), "ldconv_gather_kernel<float", 1,
                                 span="").values()) for xw, (_, offs, _, s) in zip(wide, layers)]
            row[kind] = {"layers": per_layer, "all": sum(per_layer), "f32_form_layers": f32, "f32_form_all": sum(f32)}
        print(json.dumps(row), flush=True)


def _baseline_bwd_bf16(lib: ctypes.CDLL):
    """The parent commit's bf16 backward as its wrapper called it: an f32 dx filled with zeros, the kernel's
    adds, the cast to bf16 (its C entry point took no scratch)."""
    fn = lib.ldconv_gather_bwd_bf16_launch
    fn.restype, fn.argtypes = ctypes.c_int, [*_BWD_ARGS, ctypes.c_void_p]

    def call(x, off, dy, stride):
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        doff = torch.empty_like(off)
        rc = fn(x.data_ptr(), off.data_ptr(), dy.data_ptr(), dx.data_ptr(), doff.data_ptr(),
                *_geom_args(x, off, stride), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"baseline ldconv_gather_bwd_bf16 launch: CUDA error {rc}")
        return dx.to(x.dtype), doff

    return call


def gather_bwd_bf16_variants(gen: torch.Generator, baseline: Path | None) -> None:
    """The bf16 backward per layer and offset kind, every launch of a call counted (the parent's dx fill and
    cast, this one's bucket passes), beside the baseline's; its dx against the plain version in bf16 spacings
    (at most 1 passes), doff's worst error over its largest plain value, and whether two calls give the same
    bits."""
    layers = bf16_layers(gen)
    bounds = _bf16_bounds(layers, True)
    print(json.dumps({"kernel": "K3 bwd bf16", "bound_ms": {"layers": bounds, "all": sum(bounds)}}), flush=True)
    want = {kind: [ldconv_gather_bwd_plain(x, offs[kind], dy, s) for x, offs, dy, s in layers] for kind in OFFSET_KINDS}
    for tag, lib in build_variants("ldconv_gather", K3BWDBF16_VARIANTS, baseline).items():
        swap_in("ldconv_gather", lib)
        call = _baseline_bwd_bf16(lib) if tag == "baseline" else ldconv_gather_bwd
        row = {"kernel": "K3 bwd bf16", "variant": tag}
        for kind in OFFSET_KINDS:
            dx_sp = doff_rel = 0.0
            repeatable = True
            for (x, offs, dy, s), (want_dx, want_doff) in zip(layers, want[kind]):
                dx, doff = call(x, offs[kind], dy, s)
                dx2, doff2 = call(x, offs[kind], dy, s)
                repeatable = repeatable and torch.equal(dx, dx2) and torch.equal(doff, doff2)
                dx_sp = max(dx_sp, _within_bf16_spacing(dx, want_dx))
                doff_rel = max(doff_rel, ((doff - want_doff).abs().max() / want_doff.abs().max()).item())
            per_layer = [sum(device_ms(lambda: call(x, offs[kind], dy, s), BF16_BWD_KERNEL, 1, span="").values())
                         for x, offs, dy, s in layers]
            row[kind] = {"layers": per_layer, "all": sum(per_layer), "dx_err_over_gate": dx_sp,
                         "doff_rel_err": doff_rel, "two_calls_bit_identical": repeatable}
        print(json.dumps(row), flush=True)


def k1_cases(dtype: torch.dtype, gen: torch.Generator) -> dict:
    """K1's timed inputs: the seeded LD-P2 model's Detect maps of one batch of 8
    seeded images at 640 (computed in ``dtype``), random logits (N(0, 3^2)) at
    the same shapes, and random logits at imgsz 608."""
    model = seeded_model("yolov8-LD-P2.yaml", 0).eval()
    model.dtype = dtype
    with torch.no_grad():
        maps = [f.contiguous() for f in model(model_input(letterboxed(seeded_images(BATCH, 0), 640), "cuda"))]
    del model

    def rand(shapes):
        return [(torch.randn(s, generator=gen) * 3).to("cuda", dtype) for s in shapes]

    return {"seeded LD-P2 maps": maps, "random logits": rand([f.shape for f in maps]),
            "random logits at 608": rand([(BATCH, maps[0].shape[1], 608 // s, 608 // s) for s in (4, 8, 16)])}


def _k1_parent(lib: ctypes.CDLL, dtype: torch.dtype):
    """The baseline's forward as the first design's wrapper called it: one launch a map, then the levels
    concatenated (the copy not timed: device_ms counts only the kernels)."""
    fn = lib.dfl_decode_bf16_launch if dtype == torch.bfloat16 else lib.dfl_decode_launch
    fn.restype, fn.argtypes = ctypes.c_int, [*K1_OLD_ARGS, ctypes.c_void_p]

    def call(feats):
        outs = []
        for f in feats:
            b, no, h, w = f.shape
            out = torch.empty((b, h * w, 4), dtype=torch.float32, device=f.device)
            if fn(f.data_ptr(), out.data_ptr(), b, h * w, no * h * w, 16, torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("baseline dfl_decode launch failed")
            outs.append(out)
        return torch.cat(outs, 1)

    return call


def dfl_variants(dtype: torch.dtype, gen: torch.Generator, baseline: Path | None) -> None:
    """K1's forward in ``dtype`` per variant and input: one launch for every level and one a level, beside the
    bytes bound (each logit read once, each distance written once); widths, error against plain, and bit-equality
    with the baseline."""
    from experiment_yolo_torch.ops.kernels import dfl_decode as k1

    label = "K1 bf16" if dtype == torch.bfloat16 else "K1"
    cases = k1_cases(dtype, gen)
    bounds = {case: sum(f.shape[0] * f.shape[2] * f.shape[3] * (64 * f.element_size() + 16) for f in feats)
              / HBM_BYTES_PER_S * 1e3 for case, feats in cases.items()}
    print(json.dumps({"kernel": label, "bound_ms": bounds,
                      "shapes": {case: [list(f.shape) for f in feats] for case, feats in cases.items()}}), flush=True)
    plain = {case: k1.dfl_decode_levels_fwd([f.cpu() for f in feats]).cuda() for case, feats in cases.items()}
    libs = build_variants("dfl_decode", {tag: pieces for tag, (pieces, _) in K1_VARIANTS.items()}, baseline)
    print(json.dumps({"kernel": label, "ptxas": {tag: [ln.strip() for ln in log.splitlines()
                                                       if "registers" in ln or "spill" in ln]
                                                 for tag, log in build_logs.items()}}), flush=True)
    parent = {}
    if baseline is not None:
        call = _k1_parent(libs["baseline"], dtype)
        parent = {case: call(feats) for case, feats in cases.items()}
        row = {"kernel": label, "variant": "baseline"}
        for case, feats in cases.items():
            row[case] = {"per_level_launches_ms": sum(device_ms(lambda: call(feats), "dfl_decode_kernel",
                                                                len(feats)).values()),
                         "max_abs_err_vs_plain": (parent[case] - plain[case]).abs().max().item()}
        print(json.dumps(row), flush=True)
    settings = {name: getattr(k1, name) for name in ("MAX_LOAD_BYTES", "THREADS")}
    for tag, (_, overrides) in K1_VARIANTS.items():
        swap_in("dfl_decode", libs[tag])
        for name, value in {**settings, **overrides}.items():
            setattr(k1, name, value)
        row = {"kernel": label, "variant": tag}
        for case, feats in cases.items():
            got = k1.dfl_decode_levels_fwd(feats)
            one = sum(device_ms(lambda: k1.dfl_decode_levels_fwd(feats), "dfl_decode_kernel", 1).values())
            each = [sum(device_ms(lambda: k1.dfl_decode_levels_fwd([f]), "dfl_decode_kernel", 1).values())
                    for f in feats]
            table = k1.level_table([(f.shape[2] * f.shape[3], f.stride(0), f.data_ptr()) for f in feats],
                                   feats[0].element_size())
            row[case] = {"one_launch_ms": one, "bound_share": bounds[case] / one, "per_level_ms": each,
                         "per_level_sum_ms": sum(each), "widths": [t.width for t in table],
                         "max_abs_err_vs_plain": (got - plain[case]).abs().max().item()}
            if parent:
                row[case]["bit_equal_to_baseline"] = bool(torch.equal(got, parent[case]))
        print(json.dumps(row), flush=True)
    for name, value in settings.items():
        setattr(k1, name, value)


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
                            **device_ms(lambda: nms_suppress(b, v, thr), "nms_suppress_kernel", 2)}
        print(json.dumps(row), flush=True)


def main_path_pools() -> dict:
    """K5's timed pools, (args, keywords) of ``soft_nms``, from the seeded
    LD-P2 model in eval mode at the seeds of ``chip_smoke.py`` (seed 0): the
    first val batch's pool (quirk on and off), the serving batch's pool, and
    the made-up trained-like pool."""
    model = seeded_model("yolov8-LD-P2.yaml", 0).eval()
    val = seeded_batch(BATCH, 640, VAL_SEED, nc=model.nc)["img"]
    served = letterboxed(seeded_images(BATCH, 0), 640)
    pools = {}
    with torch.no_grad():
        for label, img, is_val in (("val pool", val, True), ("serving pool", served, False)):
            for quirk, pool in soft_nms_pools(*model.predict(model_input(img, "cuda")), val=is_val).items():
                pools[label + quirk] = pool
    boxes, scores, valid, thr, first_idx, n_valid = soft_nms_cases(6, "cuda")["trained-like K=4096"]
    pools["trained-like quirk"] = ((boxes, scores, valid, thr, 300), {"first_idx": first_idx, "n_valid": n_valid})
    return pools


def soft_nms_variants(baseline: Path | None) -> None:
    pools = main_path_pools()
    cases = [(f"{label}{' quirk' if quirk else ''}", (b, s, v, thr, 300),
              {"first_idx": f, "n_valid": n} if quirk else {})
             for label, (b, s, v, thr, f, n) in soft_nms_cases(6, "cuda").items() for quirk in (False, True)]
    want = {label: soft_nms_plain(*args, **kw) for label, args, kw in cases}
    want_pools = {label: soft_nms_plain(*args, **kw) for label, (args, kw) in pools.items()}
    for tag, lib in build_variants("soft_nms", K5_VARIANTS, baseline).items():
        swap_in("soft_nms", lib)
        row = {"kernel": "K5", "variant": tag,
               "cases_differing_from_plain": [label for label, args, kw in cases
                                              if not torch.equal(soft_nms(*args, **kw), want[label])]}
        for label, (args, kw) in pools.items():
            got = soft_nms(*args, **kw)
            row[label] = {"above_floor": int((args[2] & (args[1] > 0.25)).sum()), "kept": int((got > -1).sum()),
                          "kept_by_plain": int((want_pools[label] > -1).sum()),
                          "bit_equal": bool(torch.equal(got, want_pools[label])),
                          "device_ms": sum(device_ms(lambda: soft_nms(*args, **kw), "soft_nms_kernel", 1).values())}
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
    if which not in ("k1", "k1bf16", "k2", "k3", "k3bwd", "k3bf16", "k3bwdbf16", "k4", "k4bwd", "k5", "all"):
        sys.exit(f"kernel_variants: unknown target {which!r}: one of k1, k1bf16, k2, k3, k3bwd, k3bf16, k3bwdbf16, "
                 "k4, k4bwd, k5, all")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    _build.build_all()
    gen = torch.Generator().manual_seed(0)
    if which in ("k1", "all"):
        dfl_variants(torch.float32, gen, baseline)
    if which in ("k1bf16", "all"):
        dfl_variants(torch.bfloat16, gen, baseline)
    targets = {"k4": scan_variants, "k3": gather_variants}
    for name, fn in targets.items():
        if which in (name, "all"):
            fn(gen)
    if which in ("k4bwd", "all"):
        scan_bwd_variants(gen, baseline)
    if which in ("k3bwd", "all"):
        gather_bwd_variants(gen, baseline)
    if which in ("k3bf16", "all"):
        gather_bf16_variants(gen, baseline)
    if which in ("k3bwdbf16", "all"):
        gather_bwd_bf16_variants(gen, baseline)
    if which in ("k2", "all"):
        nms_variants(gen)
    if which in ("k5", "all"):
        soft_nms_variants(baseline)


if __name__ == "__main__":
    main()
