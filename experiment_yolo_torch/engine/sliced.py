"""Sliced (SAHI-style) inference: a slice grid, one batched forward, one NMS.

Port of ``experiment_yolo_tpu/engine/sliced.py``, the counterpart of the
reference fork's SAHI example (slice 512, overlap 0.2). Every slice of an
image goes through the model in one batch; the boxes are shifted by their
slices' origins into the image's pixels, the letterboxed full image's boxes
(``include_full``) are mapped back to them, and one NMS runs over all of the
image's candidates, with a class offset larger than the image.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from experiment_yolo_torch.cfg import check_imgsz, get_cfg
from experiment_yolo_torch.data.augment import letterbox
from experiment_yolo_torch.engine.results import Results
from experiment_yolo_torch.ops.nms import non_max_suppression


def slice_grid(h: int, w: int, slice: int, overlap: float) -> List[Tuple[int, int]]:
    """(y0, x0) slice origins covering an h x w image with at least
    ``overlap`` between neighbours: sahi's tiling, a fixed step of
    ``slice * (1 - overlap)`` and the last slice flush with the image's edge
    (origin 0 where the image is smaller than a slice; its slice is then
    zero-padded)."""
    step = max(int(slice * (1.0 - overlap)), 1)

    def starts(extent: int) -> List[int]:
        if extent <= slice:
            return [0]
        s = list(range(0, extent - slice + 1, step))
        if s[-1] != extent - slice:
            s.append(extent - slice)
        return s

    return [(y, x) for y in starts(h) for x in starts(w)]


def nms_max_wh(h: int, w: int) -> float:
    """The NMS class offset for boxes in the pixels of an h x w image: 7680,
    doubled until it exceeds the image's largest side, so that boxes of two
    classes never overlap after the shift."""
    mwh = 7680.0
    while mwh <= max(h, w):
        mwh *= 2
    return mwh


class SlicedPredictor:
    """``SlicedPredictor(model, overrides, slice, overlap, include_full)(images)``
    -> one :class:`Results` per (H, W, 3) uint8 BGR image, in its own pixels.

    It runs where ``model`` lives and in its compute dtype. ``slice`` and the
    full image's ``imgsz`` are rounded up to a multiple of the model's largest
    stride. NMS follows the overrides (``nms_type``, soft by default, and
    ``soft_nms_quirk``, ``conf``, ``iou``, ``max_det``, ``agnostic_nms``),
    then boxes are clipped to the image and ``classes`` filters them.
    """

    def __init__(self, model, overrides: Optional[Dict] = None, slice: int = 512, overlap: float = 0.2,
                 include_full: bool = True):
        self.args = get_cfg(overrides)
        if self.args.conf is None:
            self.args.conf = 0.25
        self.model = model
        self.device = model.device
        self.slice = check_imgsz(int(slice), max(model.stride))
        self.overlap = float(overlap)
        self.include_full = bool(include_full)
        self.imgsz = check_imgsz(int(self.args.imgsz), max(model.stride))

    def _input(self, imgs: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 RGB on the host -> the model's (N, 3, H, W) input on its device."""
        x = torch.from_numpy(imgs).to(self.device)
        return (x.permute(0, 3, 1, 2).to(self.model.dtype) / 255.0).contiguous()

    @torch.no_grad()
    def infer(self, slices: np.ndarray, offsets: np.ndarray, full: Optional[np.ndarray], gain: float,
              pad: np.ndarray, max_wh: float):
        """Slices (N, s, s, 3) uint8 RGB with their origins (N, 2) [x0, y0],
        and the letterboxed full image (1, imgsz, imgsz, 3) with its gain and
        (padw, padh), or None -> (detections (1, max_det, 6), counts (1,)) in
        the image's pixels."""
        boxes, scores = self.model.predict(self._input(slices))  # (N, A, 4) xywh, (N, A, nc)
        off = torch.from_numpy(offsets).to(boxes.device)
        boxes = boxes + torch.cat([off, torch.zeros_like(off)], -1)[:, None, :]  # centres shift, sizes stay
        n, a, nc = scores.shape
        boxes, scores = boxes.reshape(1, n * a, 4), scores.reshape(1, n * a, nc)
        if full is not None:
            fb, fs = self.model.predict(self._input(full))
            p = torch.from_numpy(np.concatenate([pad, np.zeros(2, np.float32)])).to(fb.device)
            fb = (fb - p) / torch.tensor(gain, dtype=torch.float32, device=fb.device)  # undo the letterbox
            boxes, scores = torch.cat([boxes, fb], 1), torch.cat([scores, fs.to(scores.dtype)], 1)
        return non_max_suppression(
            boxes, scores,
            conf_thres=float(self.args.conf),
            iou_thres=float(self.args.iou),
            max_det=int(self.args.max_det),
            agnostic=bool(self.args.agnostic_nms),
            nms_type=str(self.args.nms_type or "soft"),
            soft_first_quirk=bool(self.args.soft_nms_quirk),
            max_wh=max_wh,
        )

    def _prepare(self, img: np.ndarray):
        """One BGR image -> its RGB slices (zero-padded at the edges, not
        letterboxed), their origins, and the letterboxed full image with its
        gain and pad (None where ``include_full`` is off)."""
        h, w = img.shape[:2]
        s = self.slice
        grid = slice_grid(h, w, s, self.overlap)
        slices = np.zeros((len(grid), s, s, 3), np.uint8)
        offsets = np.zeros((len(grid), 2), np.float32)  # (x0, y0)
        rgb = img[..., ::-1]
        for i, (y0, x0) in enumerate(grid):
            tile = rgb[y0:y0 + s, x0:x0 + s]
            slices[i, :tile.shape[0], :tile.shape[1]] = tile
            offsets[i] = (x0, y0)
        full = gain = pad = None
        if self.include_full:
            fimg, g, (pw, ph) = letterbox(img, (self.imgsz, self.imgsz))
            full, gain, pad = fimg[None, ..., ::-1].copy(), np.float32(g), np.asarray([pw, ph], np.float32)
        return slices, offsets, full, gain, pad

    def __call__(self, source: Union[np.ndarray, Sequence[np.ndarray]], stream: bool = False):
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def stream_inference(self, source: Union[np.ndarray, Sequence[np.ndarray]]) -> Iterator[Results]:
        images = [source] if isinstance(source, np.ndarray) else list(source)
        for k, img in enumerate(images):
            t0 = time.perf_counter()
            slices, offsets, full, gain, pad = self._prepare(img)
            t1 = time.perf_counter()
            det, counts = self.infer(slices, offsets, full, gain, pad, nms_max_wh(*img.shape[:2]))
            det, counts = det.cpu().numpy(), counts.cpu().numpy()
            t2 = time.perf_counter()
            d = det[0, :int(counts[0])].copy()
            oh, ow = img.shape[:2]
            d[:, [0, 2]] = d[:, [0, 2]].clip(0, ow)
            d[:, [1, 3]] = d[:, [1, 3]].clip(0, oh)
            if self.args.classes is not None:
                d = d[np.isin(d[:, 5].astype(int), np.atleast_1d(self.args.classes))]
            yield Results(img, f"image{k}", self.model.names, d,
                          speed={"preprocess": (t1 - t0) * 1000, "inference": (t2 - t1) * 1000})
