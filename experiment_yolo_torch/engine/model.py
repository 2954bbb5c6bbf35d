"""The ``YOLO`` facade: one object that routes train, val and predict.

Port of ``experiment_yolo_tpu/engine/model.py:YOLO`` for detection,
segmentation, pose and oriented boxes. The model is a :class:`~experiment_yolo_torch.nn.tasks.DetectionModel`
or, for a segment, pose or obb YAML (the task guessed from its name or head,
as JAX ``engine/model.py:30-42``) or checkpoint, a ``SegmentationModel``, a
``PoseModel`` or an ``OBBModel``, built from a YAML or a checkpoint of the port; ``train``,
``val`` and ``predict`` go to :class:`DetectionTrainer` (whose rebuild of a
pose head to the dataset's ``kpt_shape`` the facade takes up, as JAX
``engine/model.py:109``), the task's validator (``DetectionValidator``,
``SegmentationValidator``, ``PoseValidator`` or ``OBBValidator``) and
:class:`DetectionPredictor` with the facade's overrides under the call's, and
the paper's two-stage inference, ``double_predict`` and ``sliced_predict``, to
``engine/double_inference.py`` and ``engine/sliced.py``. The JAX facade's
further methods raise ``NotImplementedError`` naming their ``ROADMAP.md``
item.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from experiment_yolo_torch.engine.checkpoint import load_checkpoint, load_matching_variables, save_checkpoint
from experiment_yolo_torch.nn.tasks import guess_model_task, task_model, yaml_model_load
from experiment_yolo_torch.utils import LOGGER


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"YOLO.{what} is not ported to experiment_yolo_torch yet (ROADMAP.md {item})")


class YOLO:
    """Unified detection, segmentation, pose and oriented-box model API, on the card unless ``device='cpu'``.

    ``model`` is a model YAML (by path, or by name from the port's
    ``cfg/models``; ``nc`` overrides its class count) or a ``.pt`` checkpoint
    the port wrote (its EMA weights and names). ``dtype`` is the compute dtype
    of val and predict; training follows ``amp`` (bf16 by default) and hands
    the model back in ``dtype``.

    The initial weights of a YAML come from a ``torch.Generator`` seeded with
    ``seed``. They differ from the JAX facade's for the same seed, since the
    two frameworks draw other numbers: to compare the two, convert one
    package's weights into the other (``utils/convert.py``).

    Example::

        model = YOLO("yolov8-LD-P2.yaml", nc=3)
        model.train(data="data.yaml", epochs=3, imgsz=640)  # optimizer auto: AdamW below 50 epochs
        results = model.predict([bgr_image])
    """

    def __init__(self, model: str | Path = "yolov8n.yaml", nc: Optional[int] = None, dtype=torch.float32,
                 seed: int = 0, task: Optional[str] = None, device="cuda"):
        model = str(model)
        if task is not None:
            task_model(task)  # classify raises naming ROADMAP.md catalogue item 13
        self.ckpt_path: Optional[str] = None
        if model.endswith((".yaml", ".yml")):
            cfg = yaml_model_load(model)
            if nc:
                cfg = {**cfg, "nc": nc}
            self.model = task_model(task or guess_model_task(model))(
                cfg, device=device, generator=torch.Generator().manual_seed(seed), dtype=dtype)
        elif model.endswith(".pt"):
            self.model = load_checkpoint(model, device, dtype=dtype)
            self.ckpt_path = model
        elif model.endswith((".stablehlo", ".tflite", ".onnx")) or (Path(model) / "saved_model.pb").exists():
            raise _unported("__init__ on an exported model (nn/autobackend.py)", "catalogue item 15")
        else:
            raise ValueError(f"unsupported model source {model!r}: expected a model .yaml or a checkpoint .pt of "
                             "experiment_yolo_torch (convert JAX checkpoints with utils/convert.py)")
        self.dtype = dtype
        self.overrides: Dict[str, Any] = {}
        self.trainer = None
        self.predictor = None
        self._predictor_key: Optional[Dict[str, Any]] = None
        self._callbacks: Dict[str, list] = {}

    # -- info ---------------------------------------------------------------
    @property
    def nc(self) -> int:
        return self.model.nc

    @property
    def names(self) -> Dict[int, str]:
        """Class index -> name of the model."""
        return self.model.names

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    @property
    def task(self) -> str:
        return self.model.task

    def info(self) -> str:
        s = f"{type(self.model).__name__}(nc={self.nc}, strides={self.model.stride}, params={self.num_params():,})"
        LOGGER.info(s)
        return s

    # -- callbacks ------------------------------------------------------------
    def add_callback(self, event: str, fn) -> None:
        """Register a training-event hook, installed on every trainer this facade creates."""
        self._callbacks.setdefault(event, []).append(fn)

    def clear_callback(self, event: str) -> None:
        self._callbacks.pop(event, None)

    def reset_callbacks(self) -> None:
        self._callbacks = {}

    # -- task routing ---------------------------------------------------------
    def __call__(self, source, stream: bool = False, **kwargs) -> List:
        """``model(images)`` is :meth:`predict`."""
        return self.predict(source, stream=stream, **kwargs)

    def train(self, **kwargs) -> Dict[str, float]:
        """Train the model in place with :class:`DetectionTrainer` (the
        ``default.yaml`` defaults, so bf16 compute), then keep the EMA weights
        of the best epoch (of the last when none was saved as best), in eval
        mode and the facade's dtype; a pose model that the trainer rebuilt to
        the dataset's ``kpt_shape`` replaces the facade's. Returns the
        trainer's metrics."""
        from experiment_yolo_torch.engine.trainer import DetectionTrainer

        self.trainer = DetectionTrainer(self.model, {**self.overrides, **kwargs})
        for event, fns in self._callbacks.items():
            for fn in fns:
                self.trainer.callbacks.add(event, fn)
        try:
            results = self.trainer.train()
            if self.trainer.rebuilt_model:
                self.model = self.trainer.model
            self.model.load_state_dict(self.trainer.best_state, strict=True)
        finally:
            self.model.dtype = self.dtype
            self.model.eval()
        self.predictor = None
        return results

    def val(self, **kwargs) -> Dict[str, float]:
        """Validate on ``data``'s split with the task's validator
        (:class:`DetectionValidator`, ``SegmentationValidator``: box and mask
        mAP, ``PoseValidator``: box and pose mAP, or ``OBBValidator``: rotated-box
        mAP)."""
        from experiment_yolo_torch.engine.validator import DetectionValidator
        from experiment_yolo_torch.engine.validators_extra import TASK_VALIDATORS

        return TASK_VALIDATORS.get(self.task, DetectionValidator)({**self.overrides, **kwargs})(self.model)

    def predict(self, source, stream: bool = False, **kwargs) -> List:
        """Detect (and segment, find keypoints, or find oriented boxes) in ``source`` with :class:`DetectionPredictor`, built again
        when the overrides change: an (H, W, 3) uint8 BGR array, an image file
        (JPEG, PNG, BMP), a folder of them, or a list of any of these. A list
        of :class:`Results`, or a generator of them with ``stream``. Videos
        and streams raise naming ROADMAP.md queue 1 item 3.5."""
        from experiment_yolo_torch.engine.predictor import DetectionPredictor

        key = {**self.overrides, **kwargs}
        if self.predictor is None or key != self._predictor_key:
            self.predictor, self._predictor_key = DetectionPredictor(self.model, key), key
        return self.predictor(source, stream=stream)

    def sliced_predict(self, source, stream: bool = False, slice: int = 512, overlap: float = 0.2,
                       include_full: bool = True, **kwargs):
        """SAHI-style sliced inference for small objects (the reference's
        SAHI example): an overlapping grid of ``slice``-px tiles of each
        image, one batched forward of them (and of the letterboxed full image
        when ``include_full``), one NMS over the image's merged candidates.
        ``source`` as :meth:`predict` takes it. A list of :class:`Results`,
        or a generator of them with ``stream``."""
        from experiment_yolo_torch.engine.sliced import SlicedPredictor

        self._detect_only("sliced_predict")
        pred = SlicedPredictor(self.model, {**self.overrides, **kwargs}, slice=slice, overlap=overlap,
                               include_full=include_full)
        return pred(source, stream=stream)

    def double_predict(self, source, stream: bool = False, **kwargs):
        """Two-stage crop-and-refine inference (the reference's
        ``double_inference.py``): :meth:`predict`, then each confident box
        inferred again on its padded crop and replaced where the crop's box
        beats it (:class:`DoubleInference`). ``source`` as :meth:`predict`
        takes it; a generator of the refined :class:`Results` with ``stream``."""
        from experiment_yolo_torch.engine.double_inference import DoubleInference

        self._detect_only("double_predict")
        refine = DoubleInference(self.model)
        gen = (refine.refine(r) for r in self.predict(source, stream=True, **kwargs))
        return gen if stream else list(gen)

    def _detect_only(self, what: str) -> None:
        if self.task != "detect":
            raise NotImplementedError(f"YOLO.{what} refines boxes of a detection model; this is a {self.task} model")

    def save(self, path: str | Path) -> Path:
        """Write the model (f32 weights, YAML, names) as a checkpoint ``YOLO`` and ``load`` read."""
        return save_checkpoint(path, self.model)

    def load(self, weights: str | Path) -> "YOLO":
        """Take every tensor of a checkpoint whose name and shape match this
        model's (the reference's ``intersect_dicts``), so that a checkpoint of
        another ``nc`` still seeds the shared layers. Returns self."""
        matched, total = load_matching_variables(weights, self.model)
        LOGGER.info(f"load: transferred {matched}/{total} variables from {weights}")
        self.load_counts = (matched, total)
        self.predictor = None
        return self

    def fuse(self) -> "YOLO":
        """Conv+BN fusion: a no-op kept for API parity, as in the JAX package. Returns self."""
        return self

    # -- not ported -------------------------------------------------------------
    def track(self, *args, **kwargs):
        raise _unported("track (trackers/*)", "catalogue item 15")

    def benchmark(self, *args, **kwargs):
        raise _unported("benchmark (utils/benchmarks.py)", "catalogue item 15")

    def tune(self, *args, **kwargs):
        raise _unported("tune (engine/tuner.py)", "catalogue item 15")

    def export(self, *args, **kwargs):
        raise _unported("export (engine/exporter.py, export/*)", "catalogue item 15")

    def embed(self, *args, **kwargs):
        raise _unported("embed (data/explorer.py)", "catalogue item 15")

    def profile(self, *args, **kwargs):
        raise _unported("profile (the per-layer FLOPs table of nn/tasks.py)", "catalogue item 15")
