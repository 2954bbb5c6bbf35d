"""Batch iteration: a threaded, prefetching loader over ``YOLODataset``.

Port of ``experiment_yolo_tpu/data/build.py`` (``DataLoader``,
``build_yolo_dataset``, ``build_dataloader``), with its design kept: a
producer thread hands each batch's samples to a ``ThreadPoolExecutor`` of
``workers`` threads (numpy's loops release the GIL), stacks them into numpy
arrays and puts them on a bounded prefetch queue; leaving the loop early sets a
stop event. Not ``torch.utils.data.DataLoader`` with worker processes: the
samples' seeds must be the JAX loader's, ``default_rng(seed + epoch)`` for the
shuffle and ``seed * 1_000_003 + epoch * 10_007 + index`` for each sample, so
that both packages yield the same batches.

Training drops the last partial batch; validation pads it with index 0 (the
validator stops at the dataset's length). ``rect`` batches (validation) are
sorted by aspect ratio. Sharding batches over processes (multi-host) waits for
DDP, ROADMAP.md catalogue item 15.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from experiment_yolo_torch.data.dataset import YOLODataset


def _stack(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Epoch-based shuffling loader with background prefetch."""

    def __init__(self, dataset: YOLODataset, batch_size: int, shuffle: bool = True, workers: int = 8, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 4, mosaic: Optional[bool] = None, rect: bool = False,
                 stride: int = 32, shard_by_process: bool = False):
        if shard_by_process:
            raise NotImplementedError("shard_by_process (multi-host loading) is not ported to experiment_yolo_torch "
                                      "yet: it comes with DDP (ROADMAP.md catalogue item 15)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.mosaic = mosaic  # None: the dataset's default; False: close_mosaic
        self.rect = rect and not shuffle  # rect batches are a validation feature
        self.stride = stride
        self.epoch = 0
        if self.rect:
            # sorted by aspect ratio; each batch's shape is imgsz scaled by its extreme aspect, stride-rounded
            shapes = dataset.image_shapes().astype(np.float64)
            ar = shapes[:, 0] / shapes[:, 1]  # h / w
            self._rect_order = np.argsort(ar)
            nb = (len(dataset) + batch_size - 1) // batch_size
            self._batch_shapes = []
            s = dataset.imgsz
            for b in range(nb):
                ari = ar[self._rect_order[b * batch_size:(b + 1) * batch_size]]
                mini, maxi = ari.min(), ari.max()
                hw = [1.0, 1.0]
                if maxi < 1:
                    hw = [maxi, 1.0]
                elif mini > 1:
                    hw = [1.0, 1.0 / mini]
                self._batch_shapes.append((int(np.ceil(hw[0] * s / self.stride) * self.stride),
                                           int(np.ceil(hw[1] * s / self.stride) * self.stride)))

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def image_order(self) -> np.ndarray:
        """Dataset indices in iteration order (valid for shuffle=False)."""
        return self._rect_order.copy() if self.rect else np.arange(len(self.dataset))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        idxs = self._rect_order.copy() if self.rect else np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(idxs)
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def produce():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        batch_idx = idxs[b * self.batch_size:(b + 1) * self.batch_size]
                        if len(batch_idx) < self.batch_size and not self.drop_last:
                            pad = np.zeros(self.batch_size - len(batch_idx), batch_idx.dtype)
                            batch_idx = np.concatenate([batch_idx, pad])  # pad with index 0
                        seeds = [self.seed * 1_000_003 + self.epoch * 10_007 + int(i) for i in batch_idx]
                        if self.shuffle:
                            samples = list(pool.map(
                                lambda a: self.dataset.get_sample(a[0], np.random.default_rng(a[1]), mosaic=self.mosaic),
                                zip(batch_idx.tolist(), seeds)))
                        else:
                            shape = self._batch_shapes[b] if self.rect else None
                            samples = list(pool.map(lambda i: self.dataset.get_val_sample(i, shape=shape),
                                                    batch_idx.tolist()))
                        q.put(_stack(samples))
            except BaseException as e:  # handed to the consumer, which raises it
                failure.append(e)
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield batch
        finally:
            stop.set()
            while t.is_alive():  # free a producer blocked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


def build_yolo_dataset(cfg, img_path, mode: str = "train", device="cuda", data: Optional[dict] = None
                       ) -> YOLODataset:
    """The dataset of ``mode`` ('train' augments) from a config namespace,
    decoding its JPEGs for ``device``; ``data``, the resolved dataset YAML,
    gives a pose dataset its ``kpt_shape`` and ``flip_idx``."""
    return YOLODataset(img_path=img_path, imgsz=cfg.imgsz, augment=mode == "train", hyp=cfg,
                       max_labels=getattr(cfg, "max_labels", 128),
                       fraction=getattr(cfg, "fraction", 1.0) if mode == "train" else 1.0,
                       single_cls=getattr(cfg, "single_cls", False), task=getattr(cfg, "task", "detect") or "detect",
                       kpt_shape=(data or {}).get("kpt_shape", (17, 3)), flip_idx=(data or {}).get("flip_idx"),
                       cache=getattr(cfg, "cache", False), device=device)


def build_dataloader(dataset, batch_size, workers=8, shuffle=True, seed=0, drop_last=True,
                     shard_by_process=False) -> DataLoader:
    return DataLoader(dataset, batch_size, shuffle=shuffle, workers=workers, seed=seed, drop_last=drop_last,
                      shard_by_process=shard_by_process)
