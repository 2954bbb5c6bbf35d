"""The detection training step.

Port of ``experiment_yolo_tpu/engine/trainer.py`` for its detect branch: the
state of ``TrainState``, the loss config of ``DetectionTrainer.__init__``, the
optimizer, state and EMA set-up of ``train()``, and the step of
``_make_train_step`` as :meth:`DetectionTrainer.train_step`. One step takes a
batch as the JAX step does (uint8 NHWC images and padded labels), runs the
forward in train mode (BatchNorm statistics update), the loss (kernel K1 for
the decode, TAL, BCE, CIoU, DFL), the backward (the K1 and K3 backward kernels
on the card), the optimizer on its firing plan, and the EMA.

Not ported yet: the dataset-driven ``train()`` loop, which needs the data
slice (ROADMAP.md queue 1 item 10), and bf16 (``amp=True``, ROADMAP.md queue 0
item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
from torch.profiler import record_function

from experiment_yolo_torch.cfg import get_cfg
from experiment_yolo_torch.nn.tasks import DetectionModel
from experiment_yolo_torch.optim.builders import YoloSGD, build_optimizer
from experiment_yolo_torch.utils.ema import ModelEMA
from experiment_yolo_torch.utils.loss import LossConfig, detection_loss

NB = 100  # batches per epoch for the schedules until a dataset sets it (the JAX package's bench.py uses 100)


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds, in PyTorch's objects: ``params`` and
    ``batch_stats`` live in ``model``, ``opt_state`` (momentum buffers,
    updates fired, micro-batches accumulated) in ``optimizer``, and
    ``ema_params``, ``ema_batch_stats`` and ``ema_updates`` in ``ema``."""

    model: DetectionModel
    optimizer: YoloSGD
    ema: Optional[ModelEMA]
    step: int = 0  # micro-batches taken


class DetectionTrainer:
    """Trains a :class:`DetectionModel` where it lives, one batch per
    :meth:`train_step`.

    ``overrides`` are ``default.yaml`` keys. The warmup and LR schedules and
    the firing plan assume ``NB`` batches per epoch.
    """

    def __init__(self, model: DetectionModel, overrides: Optional[Dict] = None):
        self.args = args = get_cfg(overrides)
        if args.amp:
            raise NotImplementedError("amp=True (bf16 compute) is not ported to experiment_yolo_torch yet "
                                      "(ROADMAP.md queue 0 item 6); pass amp=False for f32")
        self.loss_cfg = LossConfig(nc=model.nc, reg_max=model.reg_max, box=args.box, cls=args.cls, dfl=args.dfl,
                                   use_wiseiou=args.use_wiseiou, nwd=args.nwd, iou_type=args.iou_type or "CIoU")
        # gradient accumulation towards the nominal batch size, weight decay scaled to match
        self.accumulate = max(round(args.nbs / args.batch), 1)
        weight_decay = args.weight_decay * args.batch * self.accumulate / args.nbs
        optimizer = build_optimizer(model, args.optimizer, args.lr0, args.momentum, weight_decay, NB, args.epochs,
                                    args.lrf, args.cos_lr, args.warmup_epochs, args.warmup_bias_lr,
                                    args.warmup_momentum, accumulate=self.accumulate)
        ema = ModelEMA(model, args.ema_decay, args.ema_tau) if args.ema else None  # a copy, in eval mode
        model.train()
        self.state = TrainState(model, optimizer, ema)

    def train_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """One micro-batch: ``img`` (B, H, W, 3) uint8 (no channel flip),
        ``bboxes`` (B, M, 4) normalised xywh, ``cls`` (B, M), ``mask`` (B, M),
        as numpy arrays or tensors. Returns the loss components (``box``,
        ``cls``, ``dfl``, each with its gain), ``loss`` and the foreground
        count ``fg``, as tensors on the model's device.

        The EMA follows the model after every micro-batch, whether the
        optimizer fired or not, as in the JAX package.
        """
        st = self.state
        dev = st.model.device
        img = torch.as_tensor(batch["img"])
        if img.dim() != 4 or img.shape[-1] != 3 or img.dtype != torch.uint8:
            raise ValueError(f"train_step: img must be (B, H, W, 3) uint8, got {tuple(img.shape)} {img.dtype}")
        if st.optimizer.mini_step == 0:
            st.optimizer.zero_grad()  # a new accumulation window
        with record_function("forward"):
            x = img.to(dev, non_blocking=True).permute(0, 3, 1, 2).float().div(255.0).contiguous()
            feats = st.model(x)
        targets = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True) for k in ("bboxes", "cls", "mask")}
        with record_function("loss"):
            total, comps, res = detection_loss(feats, targets, st.model.stride, self.loss_cfg)
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            st.optimizer.step()
        if st.ema is not None:
            with record_function("ema"):
                st.ema.update(st.model)
        st.step += 1
        return {**{k: v.detach() for k, v in comps.items()}, "loss": total.detach(), "fg": res.fg_mask.sum()}
