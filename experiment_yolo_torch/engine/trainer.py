"""The detection trainer: the training step and the dataset-driven loop.

Port of ``experiment_yolo_tpu/engine/trainer.py`` for its detect branch:

- :meth:`DetectionTrainer.train_step` is ``_make_train_step``'s step: a batch
  as the JAX step takes it (uint8 NHWC images and padded labels), the image
  cast to the compute dtype and scaled by 1/255, the forward
  in train mode (BatchNorm statistics update), the loss (kernel K1 for the
  decode, TAL or ATSS, the class-loss zoo, the IoU zoo or the paper's Wise-IoU
  v3 with the NWD blend, DFL), the backward (the K1 and K3 backward kernels on
  the card), the optimizer (SGD, the Adam family, RMSProp or SOAP) on its
  firing plan, and the EMA;
- :meth:`DetectionTrainer.train` is ``train()``: the dataset and the threaded
  loader, the optimizer built for the loader's batches per epoch, epochs with
  ``close_mosaic`` and ``multi_scale``, the per-epoch mean of the loss
  components (read one step late, so that the host never waits for the step it
  just launched), validation of the EMA model after every epoch through one
  dataset-driven ``DetectionValidator``, ``results.csv``, the ``last``,
  ``best`` and ``epochN`` checkpoints, ``resume`` and ``EarlyStopping``.

``amp=True`` (the default) trains as the JAX package does: the model computes
in bf16 (its :attr:`~experiment_yolo_torch.nn.tasks.DetectionModel.dtype`,
set in place where JAX rebuilds the model), the loss runs in mixed precision,
and the parameters, the optimizer state and the EMA stay f32. ``train()``
first runs :meth:`DetectionTrainer._check_amp`, which falls back to f32 when
bf16 diverges; the per-epoch validation of the EMA model runs in the compute
dtype, as JAX's ``_validate`` runs its bf16 rebuild.

Not ported: the mesh, FSDP, ``autobatch`` and ``plots`` (ROADMAP.md catalogue
item 15), each of which raises; the kernel-warehouse temperature and the task
losses, whose models the port does not build (catalogue items 14 and 13).
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from experiment_yolo_torch.cfg import check_imgsz, get_cfg
from experiment_yolo_torch.data.augment import resize_linear
from experiment_yolo_torch.data.build import DataLoader, build_yolo_dataset
from experiment_yolo_torch.data.dataset import check_det_dataset
from experiment_yolo_torch.engine.checkpoint import read_checkpoint, save_checkpoint
from experiment_yolo_torch.nn.tasks import DetectionModel
from experiment_yolo_torch.optim.builders import YoloOptimizer, build_optimizer
from experiment_yolo_torch.utils import LOGGER, colorstr, get_latest_run, increment_path
from experiment_yolo_torch.utils.callbacks import Callbacks
from experiment_yolo_torch.utils.ema import ModelEMA
from experiment_yolo_torch.utils.loss import LossConfig, detection_loss

NB = 100  # batches per epoch of the schedules for train_step callers, who have no loader (the JAX bench.py's)
LOSS_KEYS = ("box", "cls", "dfl")  # the JAX step's loss components, in its sorted order
MULTI_SCALE = (0.75, 0.9, 1.0, 1.15, 1.3)  # multi_scale's fixed bucket set, times imgsz


def _host(comps: Mapping) -> np.ndarray:
    """The loss components of a step as host floats (one device sync)."""
    return np.asarray(torch.stack([comps[k] for k in LOSS_KEYS]).tolist())


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds, in PyTorch's objects: ``params`` and
    ``batch_stats`` live in ``model``, ``opt_state`` (the optimizer's state:
    SGD's momentum buffers, Adam's moments, SOAP's factors, bases and
    moments; the updates fired and the micro-batches accumulated) in
    ``optimizer``, and ``ema_params``, ``ema_batch_stats`` and
    ``ema_updates`` in ``ema``; ``iou_mean`` is Wise-IoU's running mean of
    1 - IoU, a 0-d f32 tensor on the model's device. ``slide_mean`` is
    EMASlide's running IoU: None, as the JAX step keeps it (each step starts
    EMASlide from 1 at step 1), unless a caller sets a 0-d tensor, which
    :meth:`DetectionTrainer.train_step` then threads with the step count."""

    model: DetectionModel
    optimizer: YoloOptimizer
    ema: Optional[ModelEMA]
    iou_mean: torch.Tensor
    step: int = 0  # micro-batches taken
    slide_mean: Optional[torch.Tensor] = None


class EarlyStopping:
    """Stop when fitness has not improved for ``patience`` epochs."""

    def __init__(self, patience: int = 50):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: Optional[float]) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience


class DetectionTrainer:
    """Trains a :class:`DetectionModel` where it lives: one batch per
    :meth:`train_step`, or a dataset's epochs with :meth:`train`.

    ``overrides`` are ``default.yaml`` keys. Until :meth:`train` builds the
    optimizer for its loader, the warmup and LR schedules and the firing plan
    assume ``NB`` batches per epoch. ``amp`` sets the model's compute dtype in
    place: bf16 when True (the default), f32 when False; :meth:`train` gives
    the model back in the compute dtype it came with.
    """

    def __init__(self, model: DetectionModel, overrides: Optional[Dict] = None):
        self.args = args = get_cfg(overrides)
        if args.batch == -1:
            raise NotImplementedError("batch=-1 (autobatch, utils/autobatch.py) is not ported to "
                                      "experiment_yolo_torch yet (ROADMAP.md catalogue item 15)")
        self.model = model
        self.caller_dtype = model.dtype  # restored when train() returns
        self.dtype = torch.bfloat16 if args.amp else torch.float32
        model.dtype = self.dtype
        self.amp_check: Optional[Dict] = None  # what _check_amp found, once train() ran it
        self.best_state: Optional[Dict[str, torch.Tensor]] = None  # the best epoch's EMA weights, after train()
        self.callbacks = Callbacks()
        self.metrics: Dict[str, float] = {}
        self.save_dir = self._get_save_dir()
        self.loss_cfg = LossConfig(nc=model.nc, reg_max=model.reg_max, box=args.box, cls=args.cls, dfl=args.dfl,
                                   use_wiseiou=args.use_wiseiou, wiou_ltype=args.wiou_ltype, nwd=args.nwd,
                                   iou_ratio=args.iou_ratio, iou_type=args.iou_type or "CIoU",
                                   inner_iou=args.inner_iou, focaler_iou=args.focaler_iou)
        # gradient accumulation towards the nominal batch size, weight decay scaled to match
        self.accumulate = max(round(args.nbs / args.batch), 1)
        self.state = self._fresh_state(NB)

    def _fresh_state(self, nb: int) -> TrainState:
        """The state ``train()`` starts from: the optimizer for ``nb`` batches
        per epoch, the EMA a copy of the model (in eval mode), ``iou_mean`` 1."""
        args, model = self.args, self.model
        weight_decay = args.weight_decay * args.batch * self.accumulate / args.nbs
        optimizer = build_optimizer(model, args.optimizer, args.lr0, args.momentum, weight_decay, nb, args.epochs,
                                    args.lrf, args.cos_lr, args.warmup_epochs, args.warmup_bias_lr,
                                    args.warmup_momentum, accumulate=self.accumulate)
        ema = ModelEMA(model, args.ema_decay, args.ema_tau) if args.ema else None
        model.train()
        return TrainState(model, optimizer, ema, torch.ones((), dtype=torch.float32, device=model.device))

    def _get_save_dir(self) -> Path:
        return increment_path(Path(self.args.project or "runs/detect") / (self.args.name or "train"),
                              exist_ok=self.args.exist_ok)

    def train_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """One micro-batch: ``img`` (B, H, W, 3) uint8 (no channel flip),
        ``bboxes`` (B, M, 4) normalised xywh, ``cls`` (B, M), ``mask`` (B, M),
        as numpy arrays or tensors. Returns the loss components (``box``,
        ``cls``, ``dfl``, each with its gain), ``loss`` and the foreground
        count ``fg``, as tensors on the model's device.

        The EMA and Wise-IoU's ``iou_mean`` follow every micro-batch, whether
        the optimizer fired or not, as in the JAX package.
        """
        st = self.state
        dev = st.model.device
        img = torch.as_tensor(batch["img"])
        if img.dim() != 4 or img.shape[-1] != 3 or img.dtype != torch.uint8:
            raise ValueError(f"train_step: img must be (B, H, W, 3) uint8, got {tuple(img.shape)} {img.dtype}")
        if st.optimizer.mini_step == 0:
            st.optimizer.zero_grad()  # a new accumulation window
        with record_function("forward"):
            x = img.to(dev, non_blocking=True).permute(0, 3, 1, 2).to(self.dtype).div(255.0).contiguous()
            feats = st.model(x)
        targets = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True) for k in ("bboxes", "cls", "mask")}
        with record_function("loss"):
            if st.slide_mean is None:
                total, comps, res, st.iou_mean = detection_loss(feats, targets, st.model.stride, self.loss_cfg,
                                                                st.iou_mean)
            else:
                total, comps, res, st.iou_mean, st.slide_mean = detection_loss(
                    feats, targets, st.model.stride, self.loss_cfg, st.iou_mean, st.slide_mean, st.step)
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            st.optimizer.step()
        if st.ema is not None:
            with record_function("ema"):
                st.ema.update(st.model)
        st.step += 1
        return {**{k: v.detach() for k, v in comps.items()}, "loss": total.detach(), "fg": res.fg_mask.sum()}

    # ------------------------------------------------------------------
    def _check_unported(self) -> None:
        args = self.args
        if int(args.fsdp or 0) > 1 or int(args.n_devices or 1) > 1:
            raise NotImplementedError("the device mesh (n_devices > 1, fsdp > 1) is not ported to "
                                      "experiment_yolo_torch yet: it maps to DDP or FSDP (ROADMAP.md catalogue "
                                      "item 15)")
        if args.plots:
            raise NotImplementedError("plots=True draws figures, which are not ported to experiment_yolo_torch yet "
                                      "(utils/plotting.py, ROADMAP.md catalogue item 15)")
        if (args.task or "detect") != "detect":
            raise NotImplementedError(f"task={args.task!r} (its losses and validators) is not ported to "
                                      "experiment_yolo_torch yet (ROADMAP.md catalogue item 13)")
        if not args.data:
            raise ValueError("train() needs a dataset: pass data=<data.yaml>")

    def _host_batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The batch as tensors in pinned host memory on the card's machine,
        so that ``train_step``'s uploads run asynchronously."""
        pin = self.model.device.type == "cuda"
        out = {}
        for k in ("img", "bboxes", "cls", "mask"):
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            out[k] = t.pin_memory() if pin else t
        return out

    def train(self) -> Dict[str, float]:
        """Train on ``args.data`` for ``args.epochs`` epochs; returns the last
        epoch's validation metrics and ``epochs_run``. The model leaves in the
        compute dtype it had before the trainer was built."""
        try:
            return self._train()
        finally:
            self.model.dtype = self.caller_dtype

    def _train(self) -> Dict[str, float]:
        args = self.args
        self.callbacks.run("on_pretrain_routine_start", trainer=self)
        self._check_unported()
        args.imgsz = check_imgsz(int(args.imgsz), max(self.model.stride))
        data = check_det_dataset(args.data)
        if data["nc"] != self.model.nc:
            raise ValueError(f"dataset nc={data['nc']} but model nc={self.model.nc} — build the model with "
                             f"nc={data['nc']}")
        self.data = data
        self.model.names = data["names"]

        train_set = build_yolo_dataset(args, data["train"], mode="train", device=self.model.device)
        self.train_loader = DataLoader(train_set, args.batch, shuffle=True, workers=args.workers, seed=args.seed)
        nb = len(self.train_loader)
        if nb == 0:
            raise ValueError(f"training set smaller than batch size {args.batch}")
        self.state = self._fresh_state(nb)  # the schedules and the firing plan for this loader's epochs
        start_epoch, best_fitness = 0, 0.0
        if args.resume:
            start_epoch, best_fitness = self._load_resume_state()
            LOGGER.info(f"Resuming from epoch {start_epoch + 1} (best_fitness {best_fitness:.4f})")
        if args.amp:
            self._check_amp()
        stopper = EarlyStopping(args.patience)
        stopper.best_fitness = best_fitness
        stopper.best_epoch = max(start_epoch - 1, 0)
        LOGGER.info(f"{colorstr('train:')} {len(train_set)} images, {nb} batches/epoch, {args.epochs} epochs, "
                    f"batch {args.batch} on {self.model.device}, optimizer={args.optimizer}, amp={args.amp}")

        epoch = start_epoch
        for epoch in range(start_epoch, args.epochs):
            self.epoch = epoch
            self.callbacks.run("on_train_epoch_start", trainer=self)
            if args.close_mosaic and epoch == args.epochs - args.close_mosaic:
                LOGGER.info("Closing dataloader mosaic")
                self.train_loader.mosaic = False
            self.train_loader.set_epoch(epoch)
            t0 = time.time()
            mean_loss, n_acc, pending = np.zeros(len(LOSS_KEYS)), 0, None
            ms_rng = np.random.default_rng(args.seed + 10_000 + epoch)
            for batch in self.train_loader:
                if args.multi_scale:
                    batch = self._rescale_batch(batch, ms_rng)
                comps = self.train_step(self._host_batch(batch))
                if pending is not None:  # the previous step's losses: reading them waits only for that step
                    mean_loss = (mean_loss * n_acc + _host(pending)) / (n_acc + 1)
                    n_acc += 1
                pending = comps
            if pending is not None:
                mean_loss = (mean_loss * n_acc + _host(pending)) / (n_acc + 1)
                n_acc += 1
            dt = time.time() - t0
            loss_str = "  ".join(f"{k} {v:.4f}" for k, v in zip(LOSS_KEYS, mean_loss))
            LOGGER.info(f"epoch {epoch + 1}/{args.epochs}  {loss_str}  {nb * args.batch / dt:.1f} img/s")
            self.loss_items = dict(zip(LOSS_KEYS, mean_loss.tolist()))

            fitness = self._validate() if args.val else None
            self._save_metrics_csv(epoch)
            self.callbacks.run("on_fit_epoch_end", trainer=self)

            if args.save:
                # best_fitness moves before `last` is written, so that a resume from it restores this epoch's best
                improved = fitness is not None and fitness >= best_fitness
                if improved:
                    best_fitness = fitness
                self._save("last", epoch, best_fitness)
                if improved:
                    self._save("best", epoch, best_fitness)
                if args.save_period > 0 and (epoch + 1) % args.save_period == 0:
                    self._save(f"epoch{epoch + 1}", epoch, best_fitness)
            if stopper(epoch, fitness):
                LOGGER.info(f"EarlyStopping at epoch {epoch + 1} (best epoch {stopper.best_epoch + 1})")
                break

        if self.best_state is None:  # no epoch saved as best: the last one's
            self.best_state = self._weights_copy()
        self.metrics["epochs_run"] = epoch + 1
        self.callbacks.run("on_train_end", trainer=self)
        return self.metrics

    def _weights_copy(self) -> Dict[str, torch.Tensor]:
        """A copy of the EMA model's state dict (the model's when ``ema`` is off)."""
        st = self.state
        return {k: v.detach().clone() for k, v in (st.ema.ema if st.ema else st.model).state_dict().items()}

    def _check_amp(self) -> None:
        """bf16 health check (the JAX package's ``_check_amp``, after the
        reference's ``check_amp``): an f32 and a bf16 forward of the model in
        eval mode on a uniform 64 px input; when any output's relative L2
        distance exceeds 0.1, or a value is not finite, training falls back to
        f32 compute with a log line. Its findings go to :attr:`amp_check`.
        Unlike the JAX package's, an exception is not caught: a kernel that
        fails to build or launch must not be hidden behind an f32 run."""
        model = self.model
        x = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(0)).to(model.device)
        training = model.training
        model.eval()
        try:
            with torch.no_grad():
                model.dtype = torch.float32
                want = model(x)
                model.dtype = torch.bfloat16
                got = model(x)
        finally:
            model.train(training)
        rel, finite = 0.0, True
        for a, b in zip(got, want):
            a = a.float()
            finite = finite and bool(torch.isfinite(a).all())
            rel = max(rel, float((a - b).norm() / (b.norm() + 1e-6)))
        self.amp_check = {"rel_err": rel, "finite": finite, "passed": finite and rel <= 0.1}
        if self.amp_check["passed"]:
            LOGGER.info(f"AMP check ok (bf16 rel err {rel:.4f})")
            return
        LOGGER.info(f"AMP check failed (rel err {rel:.3f}) — disabling bf16 compute")
        self.dtype = model.dtype = torch.float32
        if self.state.ema is not None:
            self.state.ema.ema.dtype = torch.float32

    def _rescale_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """Multi-scale training on a fixed bucket set of imgsz (stride-rounded):
        the labels are normalised, so only the pixels resize."""
        s = max(self.model.stride)
        buckets = sorted({int(round(self.args.imgsz * f / s) * s) for f in MULTI_SCALE})
        sz = int(rng.choice(buckets))
        if sz == batch["img"].shape[1]:
            return batch
        return {**batch, "img": np.stack([resize_linear(im, (sz, sz)) for im in batch["img"]])}

    def _validate(self) -> Optional[float]:
        """Validate the EMA model (the model itself when ``ema`` is off), in the
        compute dtype, with one validator for the whole run: its dataset and
        loader are built once."""
        from experiment_yolo_torch.engine.validator import DetectionValidator

        st = self.state
        if getattr(self, "_validator", None) is None:
            a = self.args
            self._validator = DetectionValidator({"data": a.data, "imgsz": a.imgsz, "batch": a.batch, "conf": 0.001,
                                                  "iou": 0.7, "max_det": a.max_det, "workers": a.workers,
                                                  "max_labels": a.max_labels, "split": a.split, "verbose": False})
        stats = self._validator(st.ema.ema if st.ema is not None else st.model)
        self.metrics.update(stats)
        return stats.get("fitness")

    def _save_metrics_csv(self, epoch: int) -> None:
        """Append this epoch's losses and metrics to ``results.csv``."""
        row = {"epoch": epoch + 1, **{f"train/{k}": round(v, 5) for k, v in self.loss_items.items()}}
        row.update({f"metrics/{k}": round(v, 5) for k, v in self.metrics.items() if isinstance(v, float)})
        self.save_dir.mkdir(parents=True, exist_ok=True)
        path = self.save_dir / "results.csv"
        exists = path.exists()
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if not exists:
                w.writeheader()
            w.writerow(row)

    def _train_state(self) -> Dict:
        """What resuming needs beyond the weights: the optimizer's
        ``state_dict`` (its state, whatever the family, and its counters)
        and, inside an accumulation window, the gradients summed so far; the
        EMA's update count; ``iou_mean``, ``slide_mean``; the step."""
        st = self.state
        params = [p for g in st.optimizer.param_groups for p in g["params"]]
        return {"optimizer": st.optimizer.state_dict(),
                "grads": [p.grad for p in params] if st.optimizer.mini_step else None,
                "ema_updates": st.ema.updates if st.ema is not None else 0, "iou_mean": st.iou_mean,
                "slide_mean": st.slide_mean, "step": st.step}

    def _save(self, name: str, epoch: int, best_fitness: float) -> None:
        """The weights and the EMA (an inference checkpoint) and, for 'last',
        the whole train state to resume from."""
        st = self.state
        meta = {"names": self.data["names"], "epoch": int(epoch), "best_fitness": float(best_fitness),
                "train_args": {k: v for k, v in vars(self.args).items()
                               if v is None or isinstance(v, (int, float, str, bool))}}
        save_checkpoint(self.save_dir / "weights" / f"{name}.pt", st.model, ema=st.ema.ema if st.ema else None,
                        train_state=self._train_state() if name == "last" else None, meta=meta)
        if name == "best":
            self.best_state = self._weights_copy()

    def _load_resume_state(self) -> Tuple[int, float]:
        """Restore the state from ``args.resume``: a ``last.pt`` path, or True
        for the newest ``weights/last.pt`` under the project, by mtime.
        Returns (first epoch to run, best fitness so far)."""
        resume = self.args.resume
        if resume is True or str(resume).lower() == "true":
            resume = get_latest_run(self.args.project or "runs/detect")
            if not resume:
                raise FileNotFoundError("resume=True but no previous run with a weights/last.pt was found")
        ckpt = read_checkpoint(resume)
        ts = ckpt.get("train_state")
        if ts is None:
            raise ValueError(f"{resume} holds no train state: resume from a run's weights/last.pt")
        st, dev = self.state, self.model.device
        st.model.load_state_dict(ckpt["model"], strict=True)
        if st.ema is not None:
            st.ema.ema.load_state_dict(ckpt["ema"], strict=True)
            st.ema.updates = int(ts["ema_updates"])
        st.optimizer.load_state_dict(ts["optimizer"])
        params = [p for g in st.optimizer.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            p.grad = ts["grads"][i].to(dev) if ts["grads"] is not None else None
        st.iou_mean, st.step = ts["iou_mean"].to(dev), int(ts["step"])
        st.slide_mean = ts["slide_mean"].to(dev) if ts["slide_mean"] is not None else None
        return int(ckpt["epoch"]) + 1, float(ckpt["best_fitness"])
