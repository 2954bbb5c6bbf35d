"""Build the libraries of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` kernel is compiled on its own for ``sm_90a`` into a
shared library with a plain C interface, ``build/kernels/lib<name>-<hash>.so``
at the root of the checkout, where ``<hash>`` covers the source, the shared
header and the flags. All kernels are compiled at once, one ``nvcc`` each, the
first time any kernel is asked for; later calls (and later processes) reuse
the libraries. :func:`build` is the one builder of ``csrc/``: the image codec
(``data/codec.py``) builds its libraries with it too, into ``build/codec/``.

Each library exports ``<name>_launch`` and may export more entry points
(``dfl_decode_bwd_launch`` beside ``dfl_decode_launch``). Every C entry point
takes the CUDA stream last and returns the value of ``cudaGetLastError()``
after its launch; :func:`launch` raises on a non-zero value, so a launch the
card refuses never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("dfl_decode", "nms_suppress", "ldconv_gather", "selective_scan", "soft_nms")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_log: Dict[str, str] = {}  # library name -> the compiler's output (registers, spills)


class Job(NamedTuple):
    """One library of ``csrc/``: ``compiler`` (``nvcc`` or a host compiler)
    with ``flags`` on ``source``, linked with ``libs``, into ``build_dir``;
    ``deps`` are further files its hash covers (a shared header)."""
    source: Path
    compiler: str
    flags: Tuple[str, ...]
    libs: Tuple[str, ...] = ()
    deps: Tuple[Path, ...] = ()
    build_dir: Path = BUILD_DIR

    def target(self, name: str) -> Path:
        h = hashlib.sha256()
        for part in (self.source, *self.deps):
            h.update(part.read_bytes())
        h.update(" ".join([self.compiler, *self.flags, *self.libs]).encode())
        return self.build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def compiler(name: str) -> str:
    """The path of ``nvcc`` (on PATH, else under /usr/local/cuda) or of a host compiler on PATH."""
    found = shutil.which(name) or ("/usr/local/cuda/bin/nvcc" if name == "nvcc" else "")
    if not found or not Path(found).exists():
        raise RuntimeError(f"{name} not found" + (": the CUDA toolkit (PATH or /usr/local/cuda)" if name == "nvcc"
                                                  else " on PATH"))
    return found


def build(jobs: Mapping[str, Job]) -> Dict[str, Path]:
    """Compile every job whose library is missing, all at once, one process
    each; return each job's library. Raises with the compiler's output on
    failure."""
    targets = {name: job.target(name) for name, job in jobs.items()}
    procs = {}
    try:
        for name, job in jobs.items():
            if targets[name].exists():
                continue
            cmd = [compiler(job.compiler), *job.flags, "-I", str(CSRC)]
            job.build_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=job.build_dir)
            os.close(fd)
            procs[name] = (subprocess.Popen([*cmd, "-o", tmp, str(job.source), *job.libs], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp)
    finally:
        failed = {}
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode:
                Path(tmp).unlink(missing_ok=True)
                failed[name] = out
            else:
                os.replace(tmp, targets[name])  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(f"{jobs[n].compiler} failed for {n}:\n{out}" for n, out in failed.items()))
    return targets


def build_all() -> float:
    """Compile every kernel that has no library yet, all in parallel, and load
    them. Returns the seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    jobs = {n: Job(CSRC / f"{n}.cu", "nvcc", NVCC_FLAGS, deps=(CSRC / "common.cuh",)) for n in KERNELS
            if n not in _libs}
    for name, target in build(jobs).items():
        _libs[name] = ctypes.CDLL(str(target))
    return time.perf_counter() - t0


def _function(lib: str, entry: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """``<entry>_launch`` of library ``lib``, building all kernels on first use."""
    if entry not in _fns:
        if lib not in _libs:
            build_all()
        fn = getattr(_libs[lib], f"{entry}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [*argtypes, ctypes.c_void_p]  # the stream comes last
        _fns[entry] = fn
    return _fns[entry]


def launch(name: str, argtypes: Sequence, *args, device, lib: str | None = None) -> None:
    """Launch entry point ``<name>_launch`` of library ``lib`` (default
    ``name``) on PyTorch's current stream of ``device``; raise with CUDA's
    message if the launch returned an error."""
    import torch

    lib = lib or name
    fn = _function(lib, name, argtypes)
    # the raw handle of PyTorch's current stream; the public call builds a Stream object around it first
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:  # a launch goes to the calling thread's current device
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc:
        err = _libs[lib].ey_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(f"{name} launch: CUDA error {rc} ({err(rc).decode()})")


class Form:
    """A further form of a kernel (its bf16 form): the name of its C entry
    point, ``<name>_launch``, and the launches its wrapper made, counted as a
    wrapper function's ``launches`` are."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def validate(t, what: str, dtype, ndim: int, dense_last_only: bool = False) -> None:
    """The checks every wrapper makes before handing a pointer to a kernel.
    ``dtype``: one dtype, or a tuple of those the kernel has a form for.
    ``dense_last_only``: the kernel takes the other axes' strides, so only the
    last axis must be dense."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got one on {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if dense_last_only:
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: expected unit stride along the last axis, got strides {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
