"""Kernel K4 and its backward, from ``csrc/selective_scan.cu`` itself, run on
the CPU through ``tests/cuda_emu/cuda_runtime.h``, against their plain versions.

The source is compiled with g++ after a few rewrites: ``cp.async`` becomes a
copy, ``ex2.approx`` becomes ``exp2f``, the dynamic shared memory one buffer,
and each ``<<<grid, block, smem, stream>>>`` launch a call of the emulator,
which runs every CUDA thread of a block as a coroutine and makes barriers and
shuffles wait for the whole block or warp. The wrappers' own launch code
(``_launch``, ``_launch_bwd``: scratch, strides, flags, chunk lengths) calls
the emulated library in place of the card's. So the kernels' index
arithmetic, chunk carries, reverse walks, sums over lanes, states and channel
groups and their barriers are checked here; their speed, the real ``ex2``'s
rounding and the card's memory model are not (``chip_smoke.py`` holds the
built kernels against the plain versions on the card).

Shapes are small but reach every branch: several chunks with a ragged last
one, the longest chunk the backward takes (512 steps), channels that leave
dead lanes (D = 5) or span several 32-channel groups (D = 40, 70), reversed
directions and shared sources. Tolerance 1e-5 of each output's largest
value, the card's gate (the kernels sum in another order).
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels import selective_scan as scan_module

RTOL = 1e-5
EMU = _build.CSRC.parents[1] / "tests" / "cuda_emu"


def _split_top(text):
    """``text`` split at its commas outside brackets."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "([{"
        depth -= ch in ")]}"
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def _host_source(text):
    """The CUDA source rewritten for the emulator (see the module docstring)."""
    text = re.sub(r"template <int BYTES>\n__device__ __forceinline__ void cp_async\(void\* smem, const void\* gmem\) \{"
                  r".*?\n\}\n", "template <int BYTES>\ninline void cp_async(void* smem, const void* gmem) "
                  "{ std::memcpy(smem, gmem, BYTES); }\n", text, flags=re.S)
    text = text.replace('asm volatile("cp.async.commit_group;\\n" ::);', "")
    text = re.sub(r'asm volatile\("cp\.async\.wait_group %0;\\n" ::"n"\(\w+ - 2\)\);', "", text)
    text = text.replace('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));', "r = exp2f(v);")
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];", r"float* \1 = emu::dynamic_smem.data();",
                  text)

    def launch(m):
        grid, block, smem = _split_top(m.group(2))[:3]
        return f"emu::launch(dim3({grid}), dim3({block}), [&] {{ {m.group(1)}({m.group(3)}); }}, {smem});"

    text = re.sub(r"([A-Za-z_]\w*(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", launch, text, flags=re.S)
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "asm" not in code and "<<<" not in code, "a piece of PTX or a launch the emulator cannot take"
    return text


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/selective_scan.cu`` built for the CPU emulator and loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("emulated")
    src = out / "selective_scan.cpp"
    src.write_text(_host_source((_build.CSRC / "selective_scan.cu").read_text()))
    lib = out / "libselective_scan.so"
    build = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", str(EMU), "-I",
                            str(_build.CSRC), "-o", str(lib), str(src)], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-3000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture
def on_emulator(emulated, monkeypatch):
    """The wrappers' launches go to the emulated library; CPU tensors pass the
    device check; ``chunk`` sets the forward's chunk length."""
    def launch(name, argtypes, *args, device, lib=None):
        fn = getattr(emulated, f"{name}_launch")
        fn.restype, fn.argtypes = ctypes.c_int, [*argtypes, ctypes.c_void_p]
        assert fn(*args, None) == 0, name

    chunk = {}
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "validate", lambda *a, **k: None)
    monkeypatch.setattr(scan_module, "chunk_length", lambda sequences, length, dim, sms: chunk["steps"])
    monkeypatch.setattr(scan_module, "_sm_count", lambda device: 132)
    before = scan_module.selective_scan.launches, scan_module.selective_scan_bwd.launches
    yield chunk
    scan_module.selective_scan.launches, scan_module.selective_scan_bwd.launches = before


def _inputs(b, gx, length, d, seed, rank=3):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    wide = randn(b, 4, length, rank + 32)  # B and C as views of one projection, as SS2D hands them over
    dt = torch.nn.functional.softplus(randn(b, 4, length, d))
    return (randn(b, gx, length, d), dt, -torch.exp(randn(4, d, 16)), wide[..., rank:rank + 16],
            wide[..., rank + 16:], randn(4, d)), randn(b, 4, length, d)


@pytest.mark.parametrize("b,gx,length,d,chunk,reverse,source,with_d", [
    (1, 2, 37, 5, 8, (False, False, True, True), (0, 1, 0, 1), True),  # five chunks, a ragged one; 27 dead lanes
    (2, 3, 131, 40, 64, (True, False, False, True), (1, 1, 0, 2), True),  # two channel groups, shared sources
    (1, 4, 600, 4, 512, None, None, False),  # the longest chunk the backward takes, no skip term
    (1, 2, 43, 70, 16, (False, False, True, True), (0, 1, 0, 1), False),  # three channel groups, one ragged
], ids=["ragged-chunks", "channel-groups", "longest-chunk", "three-groups"])
def test_emulated_kernels_match_the_plain_versions(on_emulator, b, gx, length, d, chunk, reverse, source, with_d):
    """K4's y and its backward's six gradients, through the wrappers' launch
    code and the forward's carry, within 1e-5 of each plain output's largest
    value; each call counted once."""
    on_emulator["steps"] = chunk
    args, dy = _inputs(b, gx, length, d, seed=length + d)
    if not with_d:
        args = (*args[:5], None)
    before = scan_module.selective_scan.launches, scan_module.selective_scan_bwd.launches
    y, carry, got_chunk = scan_module._launch(*args, reverse, source)
    grads = scan_module._launch_bwd(*args, dy, reverse, source, carry, got_chunk)
    assert got_chunk == chunk and (carry is None) == (length <= chunk)
    assert (scan_module.selective_scan.launches, scan_module.selective_scan_bwd.launches) == (before[0] + 1,
                                                                                             before[1] + 1)
    want = (scan_module.selective_scan_plain(*args, reverse, source),
            *scan_module.selective_scan_bwd_plain(*args, dy, reverse, source))
    for name, g, w in zip(("y", "dx", "ddt", "dA", "dB", "dC", "dD"), (y, *grads), want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) <= RTOL * float(w.abs().max()), name


def test_emulator_rewrites_every_launch_and_piece_of_ptx():
    """The rewrite leaves no PTX (copies, their commits and waits, ``ex2``),
    no dynamic shared memory declaration (aligned or not) and no ``<<<``
    launch in the source, and turns each of its launches into a call of the
    emulator."""
    text = (_build.CSRC / "selective_scan.cu").read_text()
    host = _host_source(text)
    assert host.count("emu::launch(") == text.count("<<<") >= 8
    assert "extern __shared__" not in host and host.count("emu::dynamic_smem.data()") == text.count("extern __shared__")
    code = "\n".join(line.split("//")[0] for line in host.splitlines())
    for piece in ("cp.async", "wait_group", "commit_group", "ex2.approx"):
        assert piece in text and piece not in code, piece
