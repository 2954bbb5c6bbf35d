"""Model assembly: a YAML graph spec -> ``DetectionModel`` (an ``nn.Module``).

Port of ``experiment_yolo_tpu/nn/tasks.py`` (``parse_model``,
``DetectionModel``) for the module types of ``yolov8.yaml``, ``yolov8-p2.yaml``,
``yolov8-ASF.yaml``, ``yolov8-ASF-P2.yaml``, ``yolov8-ASF-P2P2.yaml``,
``yolov8-LD-P2.yaml``, ``yolov8-C2f-VSS.yaml``, ``yolov8-aux.yaml``,
``yolov8-lafiyolo.yaml``, ``yolov8-efficientnet.yaml``, ``yolov8-seg.yaml``,
``yolov8-pose.yaml`` and ``yolov8-obb.yaml`` (``PORTED`` below), and the ``C2f_LDConv`` block, which no YAML uses:
channel and depth scaling (``MBConv`` takes its repeats inside), savelist
routing, strides from the graph's own downsampling (a ``Zoom_cat`` takes its
middle source's), and the Detect bias priors, for a Detect on three or four
levels, a ``DetectAux`` (its aux branches' priors too), a ``Segment``
(``SegmentationModel``), a ``Pose`` (``PoseModel``) or an ``OBB`` (``OBBModel``). Layers live in ``self.model``
so that state-dict names read ``model.{i}.<module names>``, as in the
Ultralytics fork.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from experiment_yolo_torch.cfg import CFG_DIR, yaml_load
from experiment_yolo_torch.nn.heads_extra import OBB, Pose, Proto, Segment, assemble_masks, decode_kpts, decode_obb_angle
from experiment_yolo_torch.nn.modules import (C2f, SPPF, Add, C2fLD, Concat, Conv, ConvBNAct, Detect, DetectAux,
                                              LDConv, MBConv, ScalSeq, ZoomCat, init_weights)
from experiment_yolo_torch.nn.zoo_blocks import INNER_BLOCKS, SS2D, C2fX, C3X, VSSBlock
from experiment_yolo_torch.ops.anchors import decode_detections, decode_rboxes
from experiment_yolo_torch.utils import select_device


PORTED = "Conv, LDConv, C2f, C2f_LDConv, SPPF, MBConv, nn.Upsample, Concat, Add, ScalSeq, Zoom_cat, Detect, " \
         "DetectAux, Segment, Pose, OBB, and " \
         "C2f_<X> / C3_<X> for X in " + ", ".join(INNER_BLOCKS)


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _scale_ch(c2: int, nc: int, width: float, max_channels: float) -> int:
    return c2 if c2 == nc else make_divisible(min(c2, max_channels) * width, 8)


def parse_model(d: dict, ch: int = 3) -> Tuple[List[nn.Module], List[int], List[int]]:
    """Build the layers of a model YAML dict.

    Each layer gets ``f`` (absolute source indices, -1 for the previous layer),
    ``i`` and ``type``. Returns (layers, save, detect strides): ``save`` lists
    the layers whose outputs later layers read, and the strides are the
    input-pixel stride of each map the Detect layer consumes.
    """
    nc = d.get("nc", 80)
    depth, width, max_channels = 1.0, 1.0, float("inf")
    if d.get("scales"):
        scale = d.get("scale") or next(iter(d["scales"]))
        depth, width, max_channels = d["scales"][scale]

    chs: List[int] = []
    down: List[Fraction] = []  # each layer's output stride in input pixels
    layers: List[nn.Module] = []
    save = set()
    det_strides: List[int] = []
    for i, (f, n, mname, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        args = [{"None": None, "True": True, "False": False}.get(a, a) if isinstance(a, str) else a for a in args]
        f_list = f if isinstance(f, list) else [f]
        abs_f = [j if j == -1 else (j % i if j < 0 else j) for j in f_list]
        src = [i - 1 if j == -1 else j for j in abs_f]
        c1 = chs[src[0]] if i else ch
        s_in = down[src[0]] if i else Fraction(1)
        n = max(round(n * depth), 1) if n > 1 else n
        zoo, _, inner = mname.partition("_")
        if mname in ("Conv", "LDConv"):  # args: [c2, k, stride] and [c2, num_param, stride]
            c2 = _scale_ch(args[0], nc, width, max_channels)
            mod = (Conv if mname == "Conv" else LDConv)(c1, c2, *args[1:])
            s_out = s_in * (args[2] if len(args) > 2 else 1)
        elif mname == "MBConv":  # args: [c2, e, act, drop_path, stride]; the repeats go inside the module
            c2 = _scale_ch(args[0], nc, width, max_channels)
            e, act, drop_path, stride = [*args[1:5], *[6, "SiLU", 0.0, 1][len(args) - 1:]]
            mod = MBConv(c1, c2, n, e, str(act).lower(), drop_path, stride)
            s_out, n = s_in * stride, 1
        elif mname in ("C2f", "C2f_LDConv"):  # args: [c2, shortcut]; C2f_LDConv's bottlenecks are LDConv pairs
            c2 = _scale_ch(args[0], nc, width, max_channels)
            mod = (C2f if mname == "C2f" else C2fLD)(c1, c2, n, args[1] if len(args) > 1 else False)
            s_out = s_in
        elif zoo in ("C2f", "C3") and inner in INNER_BLOCKS:  # args: [c2, shortcut]
            c2 = _scale_ch(args[0], nc, width, max_channels)
            mod = (C2fX if zoo == "C2f" else C3X)(c1, c2, inner, n, bool(args[1]) if len(args) > 1 else False)
            s_out = s_in
        elif mname == "SPPF":
            c2 = _scale_ch(args[0], nc, width, max_channels)
            mod = SPPF(c1, c2, *args[1:])
            s_out = s_in
        elif mname == "nn.Upsample":  # args: [None, scale, mode]
            if (args[2] if len(args) > 2 else "nearest") != "nearest":
                raise NotImplementedError(f"layer {i}: only nearest upsampling is ported")
            c2, mod = c1, nn.Upsample(scale_factor=int(args[1]), mode="nearest")
            s_out = s_in / int(args[1])
        elif mname == "Concat":
            c2, mod, s_out = sum(chs[j] for j in src), Concat(), s_in
        elif mname == "Add":
            c2, mod, s_out = chs[src[-1]], Add(), s_in
        elif mname == "Zoom_cat":  # (large, mid, small): the output has the middle source's stride
            s_out = down[src[1]] if len(src) == 3 else None
            if s_out is None or [down[j] for j in src] != [s_out / 2, s_out, s_out * 2]:
                raise ValueError(f"layer {i}: Zoom_cat takes three sources of strides (s/2, s, 2s), got "
                                 f"{[str(down[j]) for j in src]}")
            c2, mod = sum(chs[j] for j in src), ZoomCat()
        elif mname == "ScalSeq":
            c2 = make_divisible(args[0] * width, 8)
            mod, s_out = ScalSeq([chs[j] for j in src], c2), s_in
        elif mname == "Detect":
            c2, mod, s_out = 0, Detect(nc, [chs[j] for j in src]), s_in
            det_strides = [int(down[j]) for j in src]
        elif mname == "DetectAux":  # the main head reads the first half of the sources, the aux head the rest
            nl = len(src) // 2
            det_strides = [int(down[j]) for j in src]
            if len(src) % 2 or det_strides[:nl] != det_strides[nl:]:
                raise ValueError(f"layer {i}: DetectAux takes 2*nl sources whose second half has the first half's "
                                 f"strides, got {det_strides}")
            c2, mod, s_out, det_strides = 0, DetectAux(nc, [chs[j] for j in src]), s_in, det_strides[:nl]
        elif mname == "Segment":  # args: [nc, nm, npr]; npr scales with the width
            nm = args[1] if len(args) > 1 else 32
            npr = _scale_ch(args[2] if len(args) > 2 else 256, nc, width, max_channels)
            c2, mod, s_out = 0, Segment(nc, nm, npr, [chs[j] for j in src]), s_in
            det_strides = [int(down[j]) for j in src]
        elif mname == "Pose":  # args: [nc, kpt_shape]; the literal string 'kpt_shape' reads the YAML's top-level key
            ks = args[1] if len(args) > 1 else (17, 3)
            if isinstance(ks, str):
                ks = d.get("kpt_shape", (17, 3))
            c2, mod, s_out = 0, Pose(nc, tuple(ks), [chs[j] for j in src]), s_in
            det_strides = [int(down[j]) for j in src]
        elif mname == "OBB":  # args: [nc, ne]
            c2, mod, s_out = 0, OBB(nc, args[1] if len(args) > 1 else 1, [chs[j] for j in src]), s_in
            det_strides = [int(down[j]) for j in src]
        elif mname == "Classify" or mname.startswith(("Segment_", "Pose_", "OBB_")):
            raise NotImplementedError(f"module {mname!r} (layer {i}): the classify head and the other segment, "
                                      "pose and OBB heads are not ported to experiment_yolo_torch yet (ROADMAP.md "
                                      "catalogue item 13)")
        else:
            raise NotImplementedError(f"module {mname!r} (layer {i}) is not ported to experiment_yolo_torch; "
                                      f"the port covers {PORTED}")
        if n > 1 and not isinstance(mod, (C2f, C2fX, C3X)):  # C2fLD is a C2f
            raise NotImplementedError(f"layer {i}: repeats of {mname} are not ported")
        mod.f, mod.i, mod.type = abs_f if len(abs_f) > 1 else abs_f[0], i, mname
        save.update(j for j in abs_f if j != -1)
        layers.append(mod)
        chs.append(c2)
        down.append(s_out)
    return layers, sorted(save), det_strides


def yaml_model_load(path: Union[str, Path]) -> dict:
    """Load a model YAML from a path, or by name from ``cfg/models/``, where a
    scaled name stands for its family's file (``yolov8n.yaml`` is
    ``yolov8.yaml`` at scale n)."""
    path = Path(path)
    unified = re.sub(r"(\d+)([nslmx])(.*)$", r"\1\3", path.stem) + path.suffix  # yolov8n-p2 -> yolov8-p2
    for cand in (path, CFG_DIR / "models" / path.name, CFG_DIR / "models" / unified):
        if cand.exists():
            d = yaml_load(cand)
            m = re.search(r"yolov\d+([nslmx])", path.stem)
            d["scale"] = m.group(1) if m else d.get("scale")
            d["yaml_file"] = str(path)
            return d
    raise FileNotFoundError(f"model yaml {path} not found (searched {path} and {CFG_DIR / 'models'})")


class DetectionModel(nn.Module):
    """YOLO detection model built from a YAML, on ``device`` (default the card).

    ``forward`` returns the raw per-level Detect maps (B, 4*reg_max + nc, H, W);
    ``predict`` decodes them into boxes (B, A, 4) xywh in input pixels and
    sigmoid scores (B, A, nc). Weights are drawn from ``generator`` (a
    ``torch.Generator`` seeded with 0 when none is given), then the Detect
    bias priors are set.

    ``dtype`` is the compute dtype (f32, or bf16 as under ``amp``): the input
    is cast to it and every layer computes in it, while parameters and
    BatchNorm buffers stay f32 (``nn/modules.py``). Setting :attr:`dtype`
    later switches the compute dtype in place, as the JAX trainer's rebuild
    with ``dtype=bfloat16`` does; the raw maps come out in it.
    """

    task = "detect"

    def __init__(self, cfg: Union[str, Path, dict] = "yolov8-LD-P2.yaml", device="cuda",
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = select_device(device)
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        layers, self.save, strides = parse_model(self.yaml)
        if not isinstance(layers[-1], Detect):
            raise NotImplementedError("the last layer must be Detect")
        head_task = {Segment: "segment", Pose: "pose", OBB: "obb"}.get(type(layers[-1]), "detect")
        if head_task != self.task:
            raise ValueError(f"{type(self).__name__} cannot take a {type(layers[-1]).__name__} head: build a "
                             f"{TASK_MODELS[head_task].__name__}")
        self.model = nn.ModuleList(layers)
        self.nc, self.reg_max = self.detect.nc, self.detect.reg_max
        self.stride = tuple(strides)
        self.names: Dict[int, str] = {i: f"{i}" for i in range(self.nc)}
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self._bias_init()
        self.eval()
        self.to(dev)
        self.dtype = dtype

    @property
    def dtype(self) -> torch.dtype:
        return self.detect.dtype

    @dtype.setter
    def dtype(self, dtype: torch.dtype) -> None:
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"compute dtype {dtype}: the port computes in torch.float32 or torch.bfloat16")
        for m in self.modules():
            if isinstance(m, (Conv, ConvBNAct, LDConv, ScalSeq, Detect, Proto, SS2D, VSSBlock)):
                m.dtype = dtype

    @torch.no_grad()
    def _bias_init(self) -> None:
        """Detect bias priors: box 1.0, class log(5 / nc / (640 / stride)^2),
        on DetectAux's aux branches too."""
        head = self.detect
        pairs = [(head.cv2, head.cv3)] + ([(head.cv4, head.cv5)] if isinstance(head, DetectAux) else [])
        for boxes, classes in pairs:
            for box, cls, s in zip(boxes, classes, self.stride):
                box[-1].bias.fill_(1.0)
                cls[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    @property
    def detect(self) -> Detect:
        return self.model[-1]

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _check_input(self, x: torch.Tensor) -> None:
        if x.dim() != 4:
            raise ValueError(f"expected a batched NCHW input of rank 4, got shape {tuple(x.shape)}")
        s = max(self.stride)
        if x.shape[2] % s or x.shape[3] % s:
            raise ValueError(f"input spatial dims {x.shape[2]}x{x.shape[3]} must be divisible by the max stride {s}")

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        self._check_input(x)
        x = x.to(self.dtype)
        saved: Dict[int, torch.Tensor] = {}
        for m in self.model:
            if isinstance(m.f, list):
                x = [x if j == -1 else saved[j] for j in m.f]
            elif m.f != -1:
                x = saved[m.f]
            x = m(x)
            if m.i in self.save:
                saved[m.i] = x
        return x

    def predict(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Boxes and scores of the main head's maps (a DetectAux in train mode
        also returns its aux maps, which are not decoded)."""
        return decode_detections(self(x)[:len(self.stride)], self.stride, self.nc, self.reg_max)


class SegmentationModel(DetectionModel):
    """Instance segmentation model (JAX ``nn/tasks.py:1121``): a
    :class:`DetectionModel` whose last layer is a ``Segment``. ``forward``
    returns (detect maps, coefficient maps, protos); :meth:`predict` returns
    (boxes (B, A, 4) xywh in input pixels, scores (B, A, nc), coefficients
    (B, A, nm), protos (B, nm, Hp, Wp)); the masks of the detections NMS
    keeps come from :meth:`kept_outputs`."""

    task = "segment"

    def __init__(self, cfg: Union[str, Path, dict] = "yolov8-seg.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)

    def predict(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        det, coeffs, protos = self(x)
        boxes, scores = decode_detections(det, self.stride, self.nc, self.reg_max)
        flat = torch.cat([c.flatten(2) for c in coeffs], 2).transpose(1, 2)  # (B, A, nm)
        return boxes, scores, flat, protos

    @staticmethod
    def kept_outputs(coeffs: torch.Tensor, protos: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The mask probabilities (B, K, Hp, Wp) of the anchors ``idx`` (B, K)
        an NMS kept, from :meth:`predict`'s coefficients and protos."""
        return assemble_masks(torch.gather(coeffs, 1, idx.long()[..., None].expand(-1, -1, coeffs.shape[-1])), protos)


class PoseModel(DetectionModel):
    """Pose model (JAX ``nn/tasks.py:1147``): a :class:`DetectionModel` whose
    last layer is a ``Pose`` of ``kpt_shape`` (nk, nd). ``forward`` returns
    (detect maps, keypoint maps); :meth:`predict` returns (boxes (B, A, 4)
    xywh in input pixels, scores (B, A, nc), keypoints (B, A, nk, nd) in
    input pixels, ``nn/heads_extra.py:decode_kpts``)."""

    task = "pose"

    def __init__(self, cfg: Union[str, Path, dict] = "yolov8-pose.yaml", *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.kpt_shape = self.detect.kpt_shape

    def predict(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        det, kpt_maps = self(x)
        boxes, scores = decode_detections(det, self.stride, self.nc, self.reg_max)
        return boxes, scores, decode_kpts(kpt_maps, self.stride, self.kpt_shape)

    @staticmethod
    def kept_outputs(kpts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The keypoints (B, K, nk, nd) of the anchors ``idx`` (B, K) an NMS
        kept, from :meth:`predict`'s keypoints."""
        return torch.gather(kpts, 1, idx.long()[..., None, None].expand(-1, -1, *kpts.shape[2:]))


def guess_model_task(cfg) -> str:
    """The task of a model YAML path or dict (JAX ``nn/tasks.py:1194``): from
    the name (``-seg``, ``-pose``, ``-obb``, ``-cls``), else from the last
    layer's module."""
    name = str(cfg.get("yaml_file", "")) if isinstance(cfg, dict) else str(cfg)
    head = ""
    if isinstance(cfg, dict):
        rows = list(cfg.get("head", [])) or list(cfg.get("backbone", []))
        head = rows[-1][2] if rows else ""
    for key, task in (("-seg", "segment"), ("-pose", "pose"), ("-obb", "obb"), ("-cls", "classify")):
        if key in name:
            return task
    for prefix, task in (("Segment", "segment"), ("Pose", "pose"), ("OBB", "obb"), ("Classify", "classify")):
        if str(head).startswith(prefix):
            return task
    return "detect"


class OBBModel(DetectionModel):
    """Oriented-box model (JAX ``nn/tasks.py:1173``): a :class:`DetectionModel`
    whose last layer is an ``OBB``. ``forward`` returns (detect maps, angle
    maps); :meth:`predict` returns (rboxes (B, A, 5) xywhr, xywh in input
    pixels and the angle in radians in (-pi/4, 3pi/4), scores (B, A, nc)),
    ``ops/anchors.py:decode_rboxes``."""

    task = "obb"

    def predict(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        det, angle_maps = self(x)
        return decode_rboxes(det, decode_obb_angle(angle_maps), self.stride, self.nc, self.reg_max)


TASK_MODELS = {"detect": DetectionModel, "segment": SegmentationModel, "pose": PoseModel, "obb": OBBModel}


def task_model(task: str):
    """The model class of ``task``; classify raises naming ROADMAP.md
    catalogue item 13."""
    if task not in TASK_MODELS:
        raise NotImplementedError(f"task={task!r} is not ported to experiment_yolo_torch yet (ROADMAP.md "
                                  "catalogue item 13); the port builds detect, segment, pose and obb models")
    return TASK_MODELS[task]
