"""Detection predictor: source -> letterbox -> model -> NMS -> Results.

Port of ``experiment_yolo_tpu/engine/predictor.py`` (``load_source``,
``DetectionPredictor``) for detection, segmentation, pose and oriented boxes. A source is an array, an image file,
a folder or a list of them (``data/loaders.py``); its JPEGs are decoded for
the model's device, a batch of files at a time. Letterbox runs on the host;
the batch goes to the device as uint8 and is normalised there; forward,
decode and NMS run on the device; boxes are mapped back to each original
image with its (gain, pad). The batch shape is fixed: a short last batch is
padded with black images.

A segmentation model's NMS also returns the kept anchors, whose mask
coefficients make the masks at proto resolution (``kept_outputs``); each
image's masks are then taken to its original size on the device, all at
once, as JAX ``_masks_to_orig`` takes them one by one with OpenCV (float32
linear resizes to the letterbox square, the padding cut, to the original
size, ``> 0.5``, cut to each box), and only then copied to the host. A pose
model's kept anchors give their keypoints (JAX ``engine/predictor.py:126-130``),
copied back with the detections and mapped to the original image through
its (gain, pad), clipped to it (``:241-249``). An OBB model's detections
come from rotated NMS (kernel K7; hard, whatever ``nms_type`` says, JAX
``:131-137``): centres back through (gain, pad) and clipped to the image,
extents divided by the gain, the angle as it is (``:224-229``); ``classes``
does not filter them, as in JAX.

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
from experiment_yolo_torch.data.augment import letterbox, resize_linear_f32
from experiment_yolo_torch.engine.results import Results
from experiment_yolo_torch.ops.nms import nms_rotated, non_max_suppression

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

    def _nms(self, boxes: torch.Tensor, scores: torch.Tensor, return_idx: bool = False):
        return non_max_suppression(
            boxes, scores,
            conf_thres=float(self.args.conf),
            iou_thres=float(self.args.iou),
            max_det=int(self.args.max_det),
            agnostic=bool(self.args.agnostic_nms),
            nms_type=str(self.args.nms_type or "soft"),
            soft_first_quirk=bool(self.args.soft_nms_quirk),
            return_idx=return_idx,
        )

    @torch.no_grad()
    def infer(self, imgs: torch.Tensor):
        """(B, H, W, 3) uint8 RGB on the device -> (detections (B, max_det, 6),
        counts (B,)), and for a segmentation model the mask probabilities (B,
        max_det, Hp, Wp) of the kept rows, for a pose model their keypoints
        (B, max_det, nk, nd) in letterbox pixels; an OBB model's detections
        are (B, max_det, 7) [xywhr, conf, cls]. The images are normalised in
        the model's compute dtype."""
        x = (imgs.permute(0, 3, 1, 2).to(self.model.dtype) / 255.0).contiguous()
        if self.model.task == "detect":
            return self._nms(*self.model.predict(x))
        if self.model.task == "obb":
            a = self.args
            return nms_rotated(*self.model.predict(x), conf_thres=float(a.conf), iou_thres=float(a.iou),
                               max_det=int(a.max_det))
        boxes, scores, *rest = self.model.predict(x)
        det, counts, idx = self._nms(boxes, scores, return_idx=True)
        return det, counts, self.model.kept_outputs(*rest, idx)

    def _preprocess(self, chunk):
        pre = [letterbox(img, (self.imgsz, self.imgsz)) for _, img in chunk]
        batch = np.zeros((self.batch, self.imgsz, self.imgsz, 3), np.uint8)
        for i, (img, _, _) in enumerate(pre):
            batch[i] = img[..., ::-1]  # BGR -> RGB
        return pre, batch

    def _launch(self, batch: np.ndarray):
        """Launch a batch and its copy back to the host; returns (det, counts,
        extra, event): det and counts host tensors valid once ``event`` (None
        on the CPU) has passed; extra None for a detection model, the masks
        on the device for a segmentation model, the keypoints on the host
        (valid with det) for a pose model."""
        x = torch.from_numpy(batch)
        if self.device.type != "cuda":
            out = self.infer(x)
            return (*out[:2], out[2] if len(out) > 2 else None, None)
        out = self.infer(x.pin_memory().to(self.device, non_blocking=True))
        pose = self.model.task == "pose"  # keypoints come back with the detections; masks stay on the card
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in (out if pose else out[:2])]
        event = torch.cuda.Event()
        event.record()
        return host[0], host[1], host[2] if pose else (out[2] if len(out) > 2 else None), event

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

        pending = None  # (chunk, pre, det, counts, extra, event, t0, t1): the batch in flight
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

    def _postprocess(self, chunk, pre, det, counts, extra, event, t0, t1) -> List[Results]:
        if event is not None:
            event.synchronize()
        det, counts = det.numpy(), counts.numpy()
        t2 = time.perf_counter()
        speed = {"preprocess": (t1 - t0) * 1000 / len(chunk), "inference": (t2 - t1) * 1000 / len(chunk)}
        results = []
        for i, ((path, orig), (_, gain, (padw, padh))) in enumerate(zip(chunk, pre)):
            d = det[i, :int(counts[i])].copy()
            oh, ow = orig.shape[:2]
            if self.model.task == "obb":  # xywhr: centres unpadded and clipped, extents over the gain
                d[:, 0] = ((d[:, 0] - padw) / gain).clip(0, ow)
                d[:, 1] = ((d[:, 1] - padh) / gain).clip(0, oh)
                d[:, 2:4] = d[:, 2:4] / gain
                results.append(Results(orig, path, self.model.names, None, speed=speed, device=self.device, obb=d))
                continue
            d[:, [0, 2]] = ((d[:, [0, 2]] - padw) / gain).clip(0, ow)
            d[:, [1, 3]] = ((d[:, [1, 3]] - padh) / gain).clip(0, oh)
            keep = None
            if self.args.classes is not None:
                keep = np.isin(d[:, 5].astype(int), np.atleast_1d(self.args.classes))
                d = d[keep]
            m = k = None
            if extra is not None and self.model.task == "pose":
                k = extra[i, :int(counts[i])].float().numpy().copy()  # (n, nk, nd) letterbox pixels
                if keep is not None:
                    k = k[keep]
                k[..., 0] = ((k[..., 0] - padw) / gain).clip(0, ow)
                k[..., 1] = ((k[..., 1] - padh) / gain).clip(0, oh)
            elif extra is not None:
                probs = extra[i, :int(counts[i])]
                if keep is not None:
                    probs = probs[torch.from_numpy(keep).to(probs.device)]
                m = self._masks_to_orig(probs, d, gain, padw, padh, oh, ow)
            results.append(Results(orig, path, self.model.names, d, speed=speed, device=self.device, masks=m,
                                   keypoints=k))
        return results

    def _masks_to_orig(self, probs: torch.Tensor, d: np.ndarray, gain: float, padw: float, padh: float, oh: int,
                       ow: int) -> np.ndarray:
        """Mask probabilities (n, Hp, Wp) at proto resolution -> (n, oh, ow)
        bool in the original image, each cut to its box (JAX
        ``engine/predictor.py:_masks_to_orig``), computed where ``probs`` lie."""
        full, inside = masks_to_orig_probs(probs, d, self.imgsz, gain, padw, padh, oh, ow)
        masks = (full > 0.5) & inside
        if not masks.is_cuda:
            return masks.numpy()
        # into page-locked memory, which the array then holds: an image's hundreds of MB of masks copy at the
        # link's rate, where a pageable copy stages them through the host's own memory bandwidth
        host = torch.empty(masks.shape, dtype=torch.bool, pin_memory=True)
        host.copy_(masks)
        return host.numpy()


def masks_to_orig_probs(probs: torch.Tensor, d: np.ndarray, imgsz: int, gain: float, padw: float, padh: float,
                        oh: int, ow: int):
    """The mask probabilities (n, Hp, Wp) of an image letterboxed to the
    ``imgsz`` square, taken to its original (oh, ow): resized to the square,
    the padding cut, resized to (oh, ow) (OpenCV's float32 linear resizes);
    and each detection's box window (n, oh, ow) from its xyxy ``d`` in the
    original image, truncated to whole pixels."""
    top, left = int(round(padh)), int(round(padw))
    nh, nw = int(round(oh * gain)), int(round(ow * gain))
    up = resize_linear_f32(probs.float(), (imgsz, imgsz))[:, top:top + nh, left:left + nw]
    full = resize_linear_f32(up.contiguous(), (ow, oh))
    b = torch.from_numpy(d[:, :4].astype(int)).to(probs.device)
    cols = torch.arange(ow, device=probs.device)
    rows = torch.arange(oh, device=probs.device)
    inside = ((cols >= b[:, 0, None].clamp(min=0)) & (cols < b[:, 2, None]))[:, None, :] & \
             ((rows >= b[:, 1, None].clamp(min=0)) & (rows < b[:, 3, None]))[:, :, None]
    return full, inside
