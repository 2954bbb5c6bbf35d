"""Detection predictor: source -> letterbox -> model -> NMS -> Results.

Port of ``experiment_yolo_tpu/engine/predictor.py`` (``load_source``,
``DetectionPredictor``) for detection. A source is an array, an image file,
a folder or a list of them (``data/loaders.py``); its JPEGs are decoded for
the model's device, a batch of files at a time. Letterbox runs on the host;
the batch goes to the device as uint8 and is normalised there; forward,
decode and NMS run on the device; boxes are mapped back to each original
image with its (gain, pad). The batch shape is fixed: a short last batch is
padded with black images.

One batch is in flight, as in the JAX package's software pipeline: batch i
is launched on the card's stream with its copy back to pinned host memory,
the host decodes and letterboxes batch i+1, launches it, and only then waits
for batch i's results.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from experiment_yolo_torch.cfg import check_imgsz, get_cfg
from experiment_yolo_torch.data.augment import letterbox
from experiment_yolo_torch.engine.results import Results
from experiment_yolo_torch.ops.nms import non_max_suppression

Source = Union[str, Path, np.ndarray, List]


def load_source(source: Source, vid_stride: int = 1, device="cuda", chunk: int = 1):
    """A source -> an iterator of (label, BGR image) pairs (JAX ``load_source``
    over ``data/loaders.py``). Streams raise naming ROADMAP.md queue 1 item 3.5."""
    from experiment_yolo_torch.data import loaders

    if loaders.is_stream_source(source):
        raise loaders.unported_video(f"stream source {source!r}")
    return ((label, frame) for label, frame, _meta in
            loaders.iter_images_and_videos(source, vid_stride, device=device, chunk=chunk))


class DetectionPredictor:
    """``DetectionPredictor(model, overrides)(source)`` -> list of :class:`Results`.

    It runs where ``model`` lives (the card unless the model was built with
    ``device='cpu'``) and never moves the model.
    """

    def __init__(self, model, overrides: Optional[Dict] = None):
        self.args = get_cfg(overrides)
        if self.args.conf is None:
            self.args.conf = 0.25
        self.device = model.device
        self.model = model
        self.imgsz = check_imgsz(int(self.args.imgsz), max(model.stride))
        self.batch = max(int(self.args.batch), 1)

    def _nms(self, boxes: torch.Tensor, scores: torch.Tensor):
        return non_max_suppression(
            boxes, scores,
            conf_thres=float(self.args.conf),
            iou_thres=float(self.args.iou),
            max_det=int(self.args.max_det),
            agnostic=bool(self.args.agnostic_nms),
            nms_type=str(self.args.nms_type or "soft"),
            soft_first_quirk=bool(self.args.soft_nms_quirk),
        )

    @torch.no_grad()
    def infer(self, imgs: torch.Tensor):
        """(B, H, W, 3) uint8 RGB on the device -> (detections (B, max_det, 6), counts (B,)).
        The images are normalised in the model's compute dtype."""
        x = (imgs.permute(0, 3, 1, 2).to(self.model.dtype) / 255.0).contiguous()
        return self._nms(*self.model.predict(x))

    def _preprocess(self, chunk):
        pre = [letterbox(img, (self.imgsz, self.imgsz)) for _, img in chunk]
        batch = np.zeros((self.batch, self.imgsz, self.imgsz, 3), np.uint8)
        for i, (img, _, _) in enumerate(pre):
            batch[i] = img[..., ::-1]  # BGR -> RGB
        return pre, batch

    def _launch(self, batch: np.ndarray):
        """Launch a batch and its copy back to the host; returns (det, counts,
        event): host tensors valid once ``event`` (None on the CPU) has passed."""
        x = torch.from_numpy(batch)
        if self.device.type != "cuda":
            return (*self.infer(x), None)
        det, counts = self.infer(x.pin_memory().to(self.device, non_blocking=True))
        det_h = torch.empty(det.shape, dtype=det.dtype, pin_memory=True)
        counts_h = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
        det_h.copy_(det, non_blocking=True)
        counts_h.copy_(counts, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return det_h, counts_h, event

    def __call__(self, source: Source, stream: bool = False):
        """Detect in ``source``: a list of :class:`Results`, or a generator of
        them with ``stream=True`` (JAX ``stream_inference``)."""
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def stream_inference(self, source: Source) -> Iterator[Results]:
        frames = load_source(source, vid_stride=int(self.args.vid_stride or 1), device=self.device, chunk=self.batch)

        def chunks():
            chunk = []
            for item in frames:
                chunk.append(item)
                if len(chunk) == self.batch:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        pending = None  # (chunk, pre, det, counts, event, t0, t1): the batch in flight
        for chunk in chunks():
            t0 = time.perf_counter()
            pre, batch = self._preprocess(chunk)
            t1 = time.perf_counter()
            launched = (chunk, pre, *self._launch(batch), t0, t1)
            if pending is not None:
                yield from self._postprocess(*pending)
            pending = launched
        if pending is not None:
            yield from self._postprocess(*pending)

    def _postprocess(self, chunk, pre, det, counts, event, t0, t1) -> List[Results]:
        if event is not None:
            event.synchronize()
        det, counts = det.numpy(), counts.numpy()
        t2 = time.perf_counter()
        speed = {"preprocess": (t1 - t0) * 1000 / len(chunk), "inference": (t2 - t1) * 1000 / len(chunk)}
        results = []
        for i, ((path, orig), (_, gain, (padw, padh))) in enumerate(zip(chunk, pre)):
            d = det[i, :int(counts[i])].copy()
            oh, ow = orig.shape[:2]
            d[:, [0, 2]] = ((d[:, [0, 2]] - padw) / gain).clip(0, ow)
            d[:, [1, 3]] = ((d[:, [1, 3]] - padh) / gain).clip(0, oh)
            if self.args.classes is not None:
                d = d[np.isin(d[:, 5].astype(int), np.atleast_1d(self.args.classes))]
            results.append(Results(orig, path, self.model.names, d, speed=speed, device=self.device))
        return results
