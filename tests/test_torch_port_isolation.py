"""The PyTorch port stands alone: no JAX, no JAX package, no OpenCV, PIL or
matplotlib, its own copies of the YAMLs, and no silent fall-back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import experiment_yolo_torch
from experiment_yolo_torch import DetectionModel, DetectionPredictor

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(experiment_yolo_torch.__file__).resolve().parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__") for p in PORT.rglob("*.py"))

_PROBE = """
import sys
import numpy as np
import torch
mods = sys.argv[1:]
for m in mods:
    __import__(m)
from experiment_yolo_torch import DetectionModel, DetectionPredictor
from experiment_yolo_torch.ops.kernels import dfl_decode, ldconv_gather, nms_suppress, selective_scan, soft_nms
model = DetectionModel("yolov8-LD-P2.yaml", device="cpu")
imgs = [np.random.default_rng(0).integers(0, 256, (64, 48, 3), dtype=np.uint8)]
for nms_type in ("soft", "hard"):
    DetectionPredictor(model, {"imgsz": 64, "batch": 1, "nms_type": nms_type})(imgs)
from experiment_yolo_torch import DetectionValidator
from experiment_yolo_torch.utils.seeded import seeded_batch
val = {**seeded_batch(2, 64, 1), "ori_shape": np.full((2, 2), 64), "ratio_pad": np.tile(np.float32([1, 0, 0]), (2, 1))}
for nms_type, quirk in (("soft", True), ("hard", False)):
    DetectionValidator({"nms_type": nms_type, "soft_nms_quirk": quirk, "verbose": False})(model, [val], model.names)
vss = {"nc": 6, "scales": {"n": [0.33, 0.25, 1024]},
       "backbone": [[-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 3, "C2f_VSS", [128, True]]],
       "head": [[-1, 1, "C3_LVMB", [128]], [[2, 3], 1, "Detect", ["nc"]]]}
DetectionPredictor(DetectionModel(vss, device="cpu"), {"imgsz": 64, "batch": 1, "nms_type": "hard"})(imgs)
dbl = torch.rand(1, 4, 12, 33)  # K4 as SS2D calls it: two sequences, reversed directions, B and C as views
y = selective_scan.selective_scan(torch.rand(1, 2, 12, 8), torch.rand(1, 4, 12, 8), -torch.rand(4, 8, 16),
                                  dbl[..., 1:17], dbl[..., 17:], torch.rand(4, 8), reverse=(False, False, True, True),
                                  source=(0, 1, 0, 1))
assert y.shape == (1, 4, 12, 8) and bool(torch.isfinite(y).all())
from experiment_yolo_torch.engine.trainer import DetectionTrainer
DetectionTrainer(model, {"amp": False, "batch": 2, "use_wiseiou": True, "nwd": True}).train_step(seeded_batch(2, 64, 0))
launches = [dfl_decode.dfl_decode.launches, ldconv_gather.ldconv_gather.launches, nms_suppress.nms_suppress.launches,
            dfl_decode.dfl_decode_bwd.launches, ldconv_gather.ldconv_gather_bwd.launches,
            selective_scan.selective_scan.launches, soft_nms.soft_nms.launches]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "experiment_yolo_tpu", "cv2", "PIL", "matplotlib"))
print(len(mods), launches, bad)
"""


def test_port_imports_no_jax_and_cpu_launches_nothing():
    """In a fresh interpreter: import every port module, serve two CPU
    predicts of LD-P2 and one of a small VSS model, validate LD-P2 with
    soft-NMS in quirk mode and with hard NMS, and take one CPU training step
    with Wise-IoU and NWD. Nothing of JAX, the JAX package, OpenCV, PIL or
    matplotlib is loaded, and no kernel launch, forward or backward, is
    counted: CPU tensors take the plain versions."""
    assert len(MODULES) >= 20
    out = subprocess.run([sys.executable, "-c", _PROBE, *MODULES], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == f"{len(MODULES)} [0, 0, 0, 0, 0, 0, 0] []"


def test_port_sources_name_no_cv2_pil_or_jax():
    """No port source imports OpenCV, PIL, matplotlib, JAX or the JAX package, by an
    import statement or by name (docstrings may cite the JAX code they port,
    and ``cv2`` is also a layer name of the Ultralytics state dict)."""
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        for word in ("import_module", "__import__", '"cv2"', "'cv2'", '"PIL"', "'PIL'"):
            assert word not in text, f"{path.relative_to(ROOT)} names {word}"
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "experiment_yolo_tpu", "cv2", "PIL",
                                                  "matplotlib"), \
                    f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("name", ["default.yaml", "models/yolov8-LD-P2.yaml", "models/yolov8.yaml",
                                  "models/yolov8-ASF-P2P2.yaml"])
def test_yaml_copies_equal_originals(name):
    assert (PORT / "cfg" / name).read_bytes() == (ROOT / "experiment_yolo_tpu" / "cfg" / name).read_bytes()


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """The model is the one entry point that takes a device: without one it
    asks for the card and raises when there is none; the predictor runs
    wherever its model lives, so it reaches the CPU only on request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionModel("yolov8-LD-P2.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionModel("yolov8-LD-P2.yaml", device="cuda")
    model = DetectionModel("yolov8-LD-P2.yaml", device="cpu")
    assert DetectionPredictor(model, {"imgsz": 64}).device == torch.device("cpu")


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is neither on the CPU nor on the card (here ``meta``)
    is refused by every wrapper before any build or launch: only a CPU
    tensor reaches a plain version."""
    from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode, dfl_decode_bwd
    from experiment_yolo_torch.ops.kernels.ldconv_gather import ldconv_gather, ldconv_gather_bwd
    from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress
    from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan
    from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms

    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="CUDA tensor"):
        dfl_decode(torch.zeros(1, 70, 4, 4, **meta))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dfl_decode_bwd(torch.zeros(1, 70, 4, 4, **meta), torch.zeros(1, 16, 4, **meta), torch.zeros(1, 16, 4, **meta))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ldconv_gather(torch.zeros(1, 3, 8, 8, **meta), torch.zeros(1, 6, 8, 8, **meta), 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ldconv_gather_bwd(torch.zeros(1, 3, 8, 8, **meta), torch.zeros(1, 6, 8, 8, **meta),
                          torch.zeros(1, 64, 9, **meta), 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_suppress(torch.zeros(1, 8, 4, **meta), torch.zeros(1, 8, dtype=torch.bool, **meta), 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        soft_nms(torch.zeros(1, 8, 4, **meta), torch.zeros(1, 8, **meta), torch.zeros(1, 8, dtype=torch.bool, **meta),
                 0.5, 300)
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan(torch.zeros(1, 8, 4, **meta), torch.zeros(1, 8, 4, **meta), torch.zeros(4, 16, **meta),
                       torch.zeros(1, 8, 16, **meta), torch.zeros(1, 8, 16, **meta), torch.zeros(4, **meta))
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan(torch.zeros(1, 1, 8, 4, **meta), torch.zeros(1, 2, 8, 4, **meta), torch.zeros(2, 4, 16, **meta),
                       torch.zeros(1, 2, 8, 16, **meta), torch.zeros(1, 2, 8, 16, **meta), torch.zeros(2, 4, **meta),
                       reverse=(False, True), source=(0, 0))


# entry point -> (library, the wrapper module's argument-list name)
ENTRY_POINTS = {"dfl_decode": ("dfl_decode", "_ARGS"), "nms_suppress": ("nms_suppress", "_ARGS"),
                "ldconv_gather": ("ldconv_gather", "_ARGS"), "dfl_decode_bwd": ("dfl_decode", "_BWD_ARGS"),
                "ldconv_gather_bwd": ("ldconv_gather", "_BWD_ARGS"), "selective_scan": ("selective_scan", "_ARGS"),
                "soft_nms": ("soft_nms", "_ARGS")}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_ctypes_argtypes_match_the_c_entry_points(name):
    """Each wrapper's ctypes argument list matches ``<name>_launch`` in its
    CUDA source, parameter for parameter (the stream, last, is added by
    ``_build``): a mismatch would only show as a failed call on the card."""
    import ctypes
    import importlib
    import re

    from experiment_yolo_torch.ops.kernels import _build

    lib, attr = ENTRY_POINTS[name]
    src = (_build.CSRC / f"{lib}.cu").read_text()
    params = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src).group(1)
    types = [" ".join(p.split()[:-1]) for p in params.split(",")]
    assert types[-1] == "cudaStream_t"
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    want = [ctypes.c_void_p if t.endswith("*") else ctype[t] for t in types[:-1]]
    assert list(getattr(importlib.import_module(f"experiment_yolo_torch.ops.kernels.{lib}"), attr)) == want
    assert lib in _build.KERNELS


def test_model_rejects_bad_inputs_and_unknown_layers():
    model = DetectionModel("yolov8-LD-P2.yaml", device="cpu")
    with pytest.raises(ValueError, match="rank 4"):
        model(torch.zeros(3, 64, 64))
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros(1, 3, 60, 64))
    cfg = dict(model.yaml)
    cfg["backbone"] = [[-1, 1, "GhostConv", [16, 3, 2]]] + list(cfg["backbone"][1:])
    with pytest.raises(NotImplementedError, match="GhostConv.*the port covers Conv, LDConv, C2f,.*VSS, LVMB"):
        DetectionModel(cfg, device="cpu")
    cfg["backbone"] = [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "C2f_Faster", [16, True]]] + list(cfg["backbone"][2:])
    with pytest.raises(NotImplementedError, match="C2f_Faster"):  # a zoo inner block that is not ported
        DetectionModel(cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        DetectionModel("no-such-model.yaml", device="cpu")
    assert np.isclose(sum(p.numel() for p in model.parameters()), 918_288)
