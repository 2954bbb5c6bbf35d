"""A training recipe of the switches this slice ports, end to end: one
``DetectionTrainer.train_step`` of LD-P2 n against one step of the JAX
package's ``_make_train_step``, and ``YOLO(...).train()`` with no
``optimizer`` argument.

The recipe: ``optimizer='auto'`` with ``epochs=10`` (AdamW, ``lr0`` 0.002,
``b1`` 0.9), the SIoU box loss with Inner-IoU, and through ``LossConfig``
the varifocal class loss and the ATSS assigner. Both trainers take the same
seeded batch at 64 px, batch 2, ``amp=False``, with warmup off and ``nbs``
equal to the batch, so that the step fires at once at the full LR. The
weights are the port's seeded He-normal init moved into JAX with the JAX
package's own ``utils/torch_convert.py:convert_state_dict``, as in
``tests/test_torch_port_wiou.py``; the JAX step is compiled once for the
file.

Adam's first update is ``lr * g / (|g| + eps)``: it follows the sign of
every gradient, also of those that sit at rounding noise, so the two steps'
updates are not compared with each other. The port's update is held instead
to the JAX optimizer's update computed on the port's own gradients.

The JAX LD-P2 takes its LDConv layers on the gather path (``sampling='gather'``,
what K3 computes), as ``tests/test_torch_port_amp.py``'s: the default ``auto``
compiles a dense hat window as well, a TPU workaround the port does not carry
(ROADMAP catalogue item 5), for a minute of compile a train step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from experiment_yolo_torch.cfg.cli import entrypoint
from experiment_yolo_torch.data import make_synthetic_dataset
from experiment_yolo_torch.engine.model import YOLO
from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.nn.tasks import yaml_model_load
from experiment_yolo_torch.optim.builders import YoloAdam, _torch_step_plan
from experiment_yolo_torch.utils import LOGGER
from experiment_yolo_torch.utils.convert import jax_params_to_named
from experiment_yolo_torch.utils.seeded import he_normal_, seeded_batch
from experiment_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from experiment_yolo_tpu.engine.trainer import TrainState
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.optim.builders import build_optimizer
from experiment_yolo_tpu.utils.torch_convert import convert_state_dict
from test_torch_port_amp import _gather_ldconv

CFG, IMGSZ, BATCH = "yolov8-LD-P2.yaml", 64, 2
OVERRIDES = {"amp": False, "batch": BATCH, "imgsz": IMGSZ, "epochs": 10, "warmup_epochs": 0.0, "nbs": BATCH,
             "iou_type": "SIoU", "inner_iou": True}
LOSS_FIELDS = {"cls_loss": "varifocal", "assigner": "atss"}  # LossConfig fields, as in the JAX package


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (``mu``, ``nu``) inside the JAX chain's state."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, tuple):
            stack.extend(node)
        elif hasattr(node, "inner_state"):
            stack.append(node.inner_state)
    raise LookupError("no ScaleByAdamState in the optimizer state")


@pytest.fixture(scope="module")
def step():
    tm = TorchModel(CFG, device="cpu")
    he_normal_(tm, 3)
    with _gather_ldconv():
        jm = JaxModel(CFG)
    variables = convert_state_dict({k: v.numpy() for k, v in tm.state_dict().items()
                                    if not k.endswith("num_batches_tracked")}, jm)
    tr = DetectionTrainer(tm, OVERRIDES)
    tr.loss_cfg = dataclasses.replace(tr.loss_cfg, **LOSS_FIELDS)
    jt = JaxTrainer(model=jm, variables=variables, overrides=OVERRIDES)
    jt.loss_cfg = dataclasses.replace(jt.loss_cfg, exact_topk=True, **LOSS_FIELDS)
    a = jt.args
    jt.tx = build_optimizer(variables["params"], name=a.optimizer, lr0=a.lr0, momentum=a.momentum,
                            weight_decay=a.weight_decay * a.batch / a.nbs, nb=100, epochs=a.epochs, lrf=a.lrf,
                            cos_lr=a.cos_lr, warmup_epochs=a.warmup_epochs, warmup_bias_lr=a.warmup_bias_lr,
                            warmup_momentum=a.warmup_momentum, nc=jm.nc, accumulate=1)
    params0 = jax.tree.map(np.array, variables["params"])  # the step donates its state
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(variables["params"]),
                       ema_params=jax.tree.map(jnp.copy, variables["params"]),
                       ema_batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
                       iou_mean=jnp.asarray(1.0, jnp.float32), step=jnp.zeros([], jnp.int32),
                       ema_updates=jnp.zeros([], jnp.int32))
    batch = seeded_batch(BATCH, IMGSZ, 0)
    state, jcomps = jt._make_train_step()(state, {k: jnp.asarray(v) for k, v in batch.items()})

    opt = tr.state.optimizer
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    raw, fire = {}, opt.step

    def spy():  # the summed gradients as the optimizer receives them, before it clips them
        raw.update({n: p.grad.clone() for n, p in tm.named_parameters()})
        return fire()

    opt.step = spy
    comps = tr.train_step(batch)
    del opt.step
    # the JAX optimizer's update on the port's own gradients, from the same parameters and initial state
    jgrads = convert_state_dict({n: g.numpy() for n, g in raw.items()}, jm)["params"]
    jupd, _ = jax.jit(jt.tx.update)(jgrads, jt.tx.init(params0), params0)
    adam = _adam_state(state.opt_state)
    return dict(tr=tr, opt=opt, comps={k: float(v) for k, v in comps.items()}, jcomps=jax.tree.map(float, jcomps),
                clipped={n: p.grad.numpy() for n, p in tm.named_parameters()},
                update={n: (p.detach() - before[n]).numpy() for n, p in tm.named_parameters()},
                after={n: p.detach().numpy() for n, p in tm.named_parameters()},
                **{k: {n: v.numpy() for n, v in jax_params_to_named(tree, tm).items()}
                   for k, tree in (("jmu", adam.mu), ("jnu", adam.nu), ("jupdate", jupd))})


def _rel_ok(got, want, rtol=1e-3, floor=1e-6, slack=0.0):
    """Relative L2 within ``rtol`` (plus an absolute ``slack``), or an
    absolute L2 within ``floor`` for a tensor whose norm is below 1e-5."""
    diff, norm = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
    return diff <= floor + slack if norm < 1e-5 else diff <= rtol * norm + slack


def test_auto_resolves_to_adamw_and_the_loss_switches_hold(step):
    opt, cfg = step["opt"], step["tr"].loss_cfg
    assert isinstance(opt, YoloAdam) and opt.family == "AdamW" and opt.b1 == 0.9 and opt.updates == 1
    assert opt.schedules()[0] == pytest.approx(0.002)  # lr0 0.002 in the first epoch, no warmup
    assert (cfg.iou_type, cfg.inner_iou, cfg.cls_loss, cfg.assigner) == ("SIoU", True, "varifocal", "atss")


def test_recipe_losses_match_jax(step):
    """Box (SIoU with Inner-IoU), cls (varifocal) and dfl within 1e-4
    relative, on the ATSS assignment."""
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(step["comps"][k], step["jcomps"][k], rtol=1e-4, err_msg=k)
    assert step["comps"]["fg"] > 10


def test_recipe_gradients_and_moments_match_jax(step):
    """The clipped gradients (JAX's first moment over 1 - b1) and AdamW's two
    moments, leaf by leaf: 1e-3 relative L2, with an absolute floor of 1e-6
    where the norm is below 1e-5; the second moment as the root of its
    elements over 1 - b2, each gradient's magnitude, which takes the same
    floor."""
    one, b1, b2 = np.float32(1), np.float32(0.9), np.float32(0.999)
    opt, model = step["opt"], step["tr"].state.model
    for name, p in model.named_parameters():
        jmu, jnu = step["jmu"][name], step["jnu"][name]
        assert _rel_ok(step["clipped"][name], jmu / (one - b1)), name
        assert _rel_ok(opt.state[p]["exp_avg"].numpy(), jmu), name
        assert _rel_ok(np.sqrt(opt.state[p]["exp_avg_sq"].numpy() / (one - b2)), np.sqrt(jnu / (one - b2))), name
    assert sum(float(np.abs(v).sum()) > 0 for v in step["jnu"].values()) > 0.9 * len(step["jnu"])


def test_recipe_update_is_the_jax_optimizers_on_the_ports_gradients(step):
    """The port's AdamW update within 1e-5 relative L2 of the JAX chain's
    update on the same gradients (clip, Adam, decoupled decay on the weight
    group), plus one f32 spacing of each new parameter (each side rounds
    p + u once); nine in ten parameters moved (a bias whose gradient
    BatchNorm cancels to 0 takes no step and no decay)."""
    bad = [n for n, u in step["update"].items()
           if not _rel_ok(u, step["jupdate"][n], rtol=1e-5, floor=0.0,
                          slack=float(np.linalg.norm(np.spacing(step["after"][n]))))]
    assert not bad, bad[:5]
    assert sum(np.abs(u).max() > 0 for u in step["update"].values()) > 0.9 * len(step["update"])


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_yolo_train_without_optimizer_runs_adamw(one_thread, tmp_path):
    """``YOLO(...).train(epochs=1)`` with no ``optimizer`` argument: ``auto``
    with fewer than 50 epochs trains with AdamW (bf16 compute, the default
    ``amp``), with finite losses, and ``last.pt`` holds AdamW's moments and
    resumes."""
    data = make_synthetic_dataset(tmp_path / "data", n_train=4, n_val=2, imgsz=IMGSZ, seed=0)
    yolo = YOLO(CFG, nc=3, device="cpu", seed=0)
    args = {"data": str(data), "epochs": 1, "batch": BATCH, "imgsz": IMGSZ, "workers": 2,
            "project": str(tmp_path / "runs"), "verbose": False}
    metrics = yolo.train(**args)
    trainer = yolo.trainer
    opt = trainer.state.optimizer
    assert trainer.args.optimizer == "auto" and isinstance(opt, YoloAdam) and opt.family == "AdamW"
    assert metrics["epochs_run"] == 1 and opt.updates == 2 and np.isfinite(list(trainer.loss_items.values())).all()
    last = torch.load(trainer.save_dir / "weights" / "last.pt", weights_only=True)
    moments = last["train_state"]["optimizer"]["state"]
    assert len(moments) == len(list(yolo.model.parameters())) and set(moments[0]) == {"exp_avg", "exp_avg_sq"}
    resumed = YOLO(CFG, nc=3, device="cpu", seed=1)
    assert resumed.train(**{**args, "epochs": 2, "resume": str(trainer.save_dir / "weights" / "last.pt")}
                         )["epochs_run"] == 2
    # the firing plan of 2 epochs of 2 batches, accumulating towards nbs 64: the third batch does not fire
    assert resumed.trainer.state.optimizer.updates == len(_torch_step_plan(2, 2, 3.0, 32)[0]) == 3


def test_cli_trains_with_adamw_and_the_iou_zoo(one_thread, tmp_path):
    """``yolo-torch train ... optimizer=AdamW iou_type=GIoU focaler_iou=True``
    runs an epoch (the refusals of these switches are gone) and logs the
    optimizer it was given."""
    data = make_synthetic_dataset(tmp_path / "data", n_train=4, n_val=2, imgsz=IMGSZ, seed=0)
    cfg = tmp_path / "ld3.yaml"
    cfg.write_text(yaml.safe_dump({**yaml_model_load(CFG), "nc": 3}))
    logged = []
    LOGGER.addFilter(lambda record: logged.append(record.getMessage()) or True)
    try:
        metrics = entrypoint(["train", f"model={cfg}", f"data={data}", "epochs=1", "imgsz=64", "batch=2", "workers=2",
                              "device=cpu", "verbose=False", "optimizer=AdamW", "iou_type=GIoU", "focaler_iou=True",
                              f"project={tmp_path / 'runs'}"])
    finally:
        LOGGER.filters.clear()
    assert metrics["epochs_run"] == 1 and any("optimizer=AdamW" in line for line in logged)


def test_train_step_threads_emaslides_slide_mean_on_request(one_thread):
    """``TrainState.slide_mean`` is None, as the JAX step keeps EMASlide's
    running IoU (each step starts it from 1); set to a 0-d tensor, two
    ``train_step``s thread it (it moves on each) and the train state that
    ``last.pt`` saves carries it."""
    model = TorchModel(CFG, device="cpu")
    he_normal_(model, 4)
    tr = DetectionTrainer(model, {"amp": False, "batch": BATCH, "imgsz": IMGSZ})
    tr.loss_cfg = dataclasses.replace(tr.loss_cfg, cls_loss="emaslide")
    assert tr.state.slide_mean is None
    tr.state.slide_mean = torch.ones(())
    seen = []
    for seed in (0, 1):
        batch = seeded_batch(BATCH, IMGSZ, seed)
        tr.train_step(batch)
        seen.append(tr.state.slide_mean.item())
    assert tr.state.step == 2 and seen[0] != 1.0 and seen[1] != seen[0]
    assert tr._train_state()["slide_mean"].item() == seen[1]
