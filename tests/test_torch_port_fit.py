"""The training loop: the port's ``DetectionTrainer.train()`` against the JAX
package's ``train()``, and the port's checkpoints and resume.

Both loops train LD-P2 n (nc=3) from one JAX init (PRNGKey(0)), converted
into the port, on one synthetic BMP dataset written by the port (8 train and
4 val images at 64 px), batch 2, 2 epochs, SGD with ``amp=False``, each
validating its EMA model after every epoch (soft-NMS, conf 0.001). The JAX
loop runs on one device with the exact top-k in its loss, as
``tests/test_torch_port_train.py`` sets it. Augment is set so that nothing is
resampled (no mosaic, scale, translation or HSV; the horizontal flip, which
is exact, stays), so both steps see bit-equal batches. The JAX step and
validator are compiled once for the file.

Over the eight steps the two runs drift apart as f32 noise is amplified (the
mechanism ``docs/TRAINING_PARITY.md`` describes): the first epoch's mean
losses agree to 2.3e-5 relative, the second's to 3.1e-4; the weights to
3.6e-3 relative L2 at worst (LDConv's offset convs, which start at zero and
hold only updates that pass through the gather's backward, and BatchNorm
biases, which move at the warmup bias LR of 0.1). So the second epoch's
losses are held to 1e-3 and the weights to 1e-2: schedules built for 100
batches an epoch instead of the loader's 4 miss those bars by 2.6e-2 (first
epoch), 0.15 and 2.05, an EMA that never updates by 1.0.

The JAX LD-P2 takes its LDConv layers on the gather path (``sampling='gather'``,
what K3 computes), as ``tests/test_torch_port_amp.py``'s: the default ``auto``
compiles a dense hat window as well, a TPU workaround the port does not carry
(ROADMAP catalogue item 5), for a minute of compile a train step.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from experiment_yolo_torch.data import make_synthetic_dataset
from experiment_yolo_torch.engine.checkpoint import load_checkpoint, load_matching_variables, read_checkpoint
from experiment_yolo_torch.engine.trainer import DetectionTrainer, EarlyStopping
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.nn.tasks import yaml_model_load
from experiment_yolo_torch.utils import get_latest_run
from experiment_yolo_torch.utils.convert import jax_variables_to_state_dict
from experiment_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from experiment_yolo_tpu.engine.trainer import EarlyStopping as JaxEarlyStopping
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from test_torch_port_amp import _gather_ldconv

CFG, NC, IMGSZ, BATCH, EPOCHS = "yolov8-LD-P2.yaml", 3, 64, 2, 2
STILL = {"mosaic": 0.0, "scale": 0.0, "translate": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0}
LOSS_KEYS = ("box", "cls", "dfl")


def _overrides(data, project, **kw):
    return {"data": str(data), "epochs": EPOCHS, "batch": BATCH, "imgsz": IMGSZ, "amp": False, "optimizer": "SGD",
            "workers": 2, "project": str(project), **STILL, **kw}


def _spy_steps(jt, tt, jbatches, tbatches):
    """Record the batch each step of either loop takes."""
    make = jt._make_train_step

    def jax_make():
        step = make()

        def spy(state, batch, *rest):
            jbatches.append({k: np.asarray(v) for k, v in batch.items()})
            return step(state, batch, *rest)
        return spy

    jt._make_train_step = jax_make
    step = tt.train_step

    def spy(batch):
        tbatches.append({k: np.asarray(v).copy() for k, v in batch.items()})
        return step(batch)

    tt.train_step = spy


def _record(trainer, log):
    """Each epoch's mean losses and validation metrics, as ``on_fit_epoch_end`` sees them."""
    trainer.callbacks.add("on_fit_epoch_end", lambda trainer: log.append(
        ({k: float(trainer.loss_items[k]) for k in LOSS_KEYS},
         {k: float(v) for k, v in trainer.metrics.items() if k != "epochs_run"})))


def _port_model(state_dict=None):
    model = TorchModel({**yaml_model_load(CFG), "nc": NC}, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps on one intra-op thread: under the test run's
    parallel workers a pool of eight per worker oversubscribes the CPUs, and
    a step then took up to 100 times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    data = make_synthetic_dataset(root / "data", n_train=8, n_val=4, imgsz=IMGSZ, seed=0)
    with _gather_ldconv():
        jm = JaxModel(CFG, nc=NC)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    init = jax_variables_to_state_dict(variables, _port_model())

    jt = JaxTrainer(jm, variables, _overrides(data, root / "jax", n_devices=1, save=False))
    jt.loss_cfg = dataclasses.replace(jt.loss_cfg, exact_topk=True)
    tt = DetectionTrainer(_port_model(init), _overrides(data, root / "torch"))
    jlog, tlog, jbatches, tbatches = [], [], [], []
    _record(jt, jlog)
    _record(tt, tlog)
    _spy_steps(jt, tt, jbatches, tbatches)
    jmetrics = jt.train()
    tmetrics = tt.train()
    del tt.train_step  # the spy; later tests train again from this trainer's checkpoints
    model = _port_model()
    return dict(root=root, data=data, init=init, jt=jt, jlog=jlog, jmetrics=jmetrics, tt=tt, tlog=tlog,
                tmetrics=tmetrics, jbatches=jbatches, tbatches=tbatches,
                jstate=jax_variables_to_state_dict(jax.tree.map(np.asarray, jt.variables), model),
                jema=jax_variables_to_state_dict(jax.tree.map(np.asarray, jt.ema_variables), model))


def _rel_ok(got, want, rtol=1e-2, floor=1e-6):
    """Relative L2 within ``rtol``, or an absolute L2 within ``floor`` for a
    tensor whose norm is below 1e-5 (a BatchNorm-cancelled bias)."""
    diff, norm = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
    return diff <= floor if norm < 1e-5 else diff <= rtol * norm


def test_every_step_takes_the_same_batch(fit):
    """Both loops take 4 steps an epoch, and each step the same batch: the
    loader's order, flips and labels, bit for bit."""
    assert len(fit["tbatches"]) == len(fit["jbatches"]) == EPOCHS * 4
    for i, (t, j) in enumerate(zip(fit["tbatches"], fit["jbatches"])):
        assert sorted(t) == sorted(j) == ["bboxes", "cls", "img", "mask"]
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"step {i} {k}")


def test_epoch_losses_match_jax(fit):
    """Each epoch's mean box, cls and dfl: within 1e-4 relative after the
    first epoch, 1e-3 after the second (the module docstring says why); and
    falling."""
    assert len(fit["tlog"]) == len(fit["jlog"]) == EPOCHS
    for (t, _), (j, _), rtol in zip(fit["tlog"], fit["jlog"], (1e-4, 1e-3)):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(t[k], j[k], rtol=rtol, err_msg=k)
    assert fit["tlog"][1][0]["box"] < fit["tlog"][0][0]["box"]


def test_epoch_val_stats_match_jax(fit):
    """Each epoch's validation of the EMA model: the same keys, within 1e-3."""
    for (_, t), (_, j) in zip(fit["tlog"], fit["jlog"]):
        assert sorted(t) == sorted(j) == ["fitness", "mAP50", "mAP50-95", "precision", "recall"]
        for k in t:
            assert abs(t[k] - j[k]) <= 1e-3, (k, t[k], j[k])


@pytest.mark.parametrize("which", ["model", "ema"])
def test_final_weights_match_jax(fit, which):
    """Parameters and BatchNorm statistics after the loop (the model's and
    the EMA's) within 1e-2 relative L2 tensor by tensor (1e-6 absolute under
    a norm of 1e-5; the module docstring says why not 1e-3), and most of them
    moved from the init."""
    tt = fit["tt"]
    got = (tt.state.model if which == "model" else tt.state.ema.ema).state_dict()
    want = fit["jstate" if which == "model" else "jema"]
    bad = [n for n, v in got.items() if not n.endswith("num_batches_tracked")
           and not _rel_ok(v.numpy(), want[n].numpy())]
    assert not bad, bad[:5]
    moved = sum(not torch.equal(v, fit["init"][n]) for n, v in got.items() if not n.endswith("num_batches_tracked"))
    assert moved >= 0.9 * (len(got) - sum(n.endswith("num_batches_tracked") for n in got))


def test_epochs_run_results_csv_and_checkpoints(fit):
    """The same ``epochs_run`` and ``results.csv`` columns as JAX; the port
    wrote ``last.pt`` and ``best.pt`` with the model YAML, names, epoch and
    train args, and ``last.pt`` alone holds the train state."""
    assert fit["tmetrics"]["epochs_run"] == fit["jmetrics"]["epochs_run"] == EPOCHS
    t_csv = (fit["tt"].save_dir / "results.csv").read_text().splitlines()
    j_csv = (fit["jt"].save_dir / "results.csv").read_text().splitlines()
    assert t_csv[0] == j_csv[0] and len(t_csv) == len(j_csv) == EPOCHS + 1
    weights = fit["tt"].save_dir / "weights"
    assert sorted(p.name for p in weights.iterdir()) == ["best.pt", "last.pt"]
    last, best = read_checkpoint(weights / "last.pt"), read_checkpoint(weights / "best.pt")
    assert last["epoch"] == EPOCHS - 1 and last["names"] == {0: "circle", 1: "square", 2: "triangle"}
    assert last["train_args"]["batch"] == BATCH and last["model_yaml"]["nc"] == NC
    assert "train_state" in last and "train_state" not in best


def test_load_checkpoint_gives_the_ema_model(fit):
    """``load_checkpoint`` rebuilds the model from the YAML with the EMA
    weights and the names: its maps equal the trainer's EMA model's, bit for
    bit; ``load_matching_variables`` moves them into a model of another nc
    wherever name and shape match (all but the class branches' last layers)."""
    tt = fit["tt"]
    model = load_checkpoint(tt.save_dir / "weights" / "last.pt", device="cpu").eval()
    x = torch.rand(2, 3, IMGSZ, IMGSZ, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(model(x), tt.state.ema.ema(x)))
    assert model.names == {0: "circle", 1: "square", 2: "triangle"}
    other = TorchModel({**yaml_model_load(CFG), "nc": 5}, device="cpu")
    matched, total = load_matching_variables(tt.save_dir / "weights" / "last.pt", other)
    assert matched == total - 2 * len(other.stride)  # cv3.{i}.2.weight and .bias
    first = next(iter(other.state_dict()))
    assert torch.equal(other.state_dict()[first], tt.state.ema.ema.state_dict()[first])


def _state(trainer):
    st = trainer.state
    params = [p for g in st.optimizer.param_groups for p in g["params"]]
    return {"model": st.model.state_dict(), "ema": st.ema.ema.state_dict(),
            "momentum": [st.optimizer.state[p]["momentum_buffer"] for p in params],
            "counters": (st.optimizer.updates, st.optimizer.mini_step, st.ema.updates, st.step),
            "iou_mean": st.iou_mean}


def test_resume_equals_an_unbroken_run(fit):
    """One epoch, then ``resume=last.pt`` for the second, ends where the two
    epochs straight ended: parameters, BatchNorm statistics, EMA, momentum
    buffers, counters and ``iou_mean`` bit-equal. Then ``resume=True`` picks
    the newest ``weights/last.pt`` under the project by mtime, not an older
    one, and runs only the epochs left."""
    root = fit["root"]
    project = root / "resume"
    first = DetectionTrainer(_port_model(fit["init"]), _overrides(fit["data"], project, epochs=1))
    assert first.train()["epochs_run"] == 1
    last = first.save_dir / "weights" / "last.pt"
    resumed = DetectionTrainer(_port_model(), _overrides(fit["data"], project, resume=str(last)))
    assert resumed.train()["epochs_run"] == EPOCHS
    want, got = _state(fit["tt"]), _state(resumed)
    assert got["counters"] == want["counters"] and got["counters"][3] == EPOCHS * 4
    assert torch.equal(got["iou_mean"], want["iou_mean"])
    assert all(torch.equal(a, b) for a, b in zip(got["momentum"], want["momentum"]))
    for key in ("model", "ema"):
        bad = [n for n, v in got[key].items() if not torch.equal(v, want[key][n])]
        assert not bad, (key, bad[:5])

    # resume=True: the newest last.pt by mtime (an older copy with a later run number is passed over)
    decoy = project / "train9" / "weights" / "last.pt"
    decoy.parent.mkdir(parents=True)
    shutil.copy(resumed.save_dir / "weights" / "last.pt", decoy)  # epoch 2 done: nothing would be left to run
    os.utime(decoy, (1, 1))
    os.utime(last, None)
    assert get_latest_run(project) == str(last)
    again = DetectionTrainer(_port_model(), _overrides(fit["data"], project, resume=True))
    log = []
    _record(again, log)
    assert again.train()["epochs_run"] == EPOCHS and len(log) == 1
    assert all(torch.equal(v, want["model"][n]) for n, v in again.state.model.state_dict().items())


@pytest.mark.parametrize("fitness", [[0.1, 0.2, 0.2, 0.1, 0.3], [0.5, 0.4, 0.3], [None, 0.1, 0.0, 0.05]])
def test_early_stopping_matches_jax(fitness):
    """``EarlyStopping(patience=1)`` stops at the same epochs as the JAX class."""
    t, j = EarlyStopping(1), JaxEarlyStopping(1)
    assert [t(e, f) for e, f in enumerate(fitness)] == [j(e, f) for e, f in enumerate(fitness)]
    assert (t.best_epoch, t.best_fitness) == (j.best_epoch, j.best_fitness)


def test_early_stopping_ends_the_loop(fit):
    """With ``patience=1`` the loop stops after the epoch that does not
    improve on the best fitness (here a fitness made to fall)."""
    trainer = DetectionTrainer(_port_model(fit["init"]), _overrides(fit["data"], fit["root"] / "stop", epochs=5,
                                                                    patience=1, save=False))
    falling = iter([0.3, 0.2, 0.1, 0.0, 0.0])
    trainer._validate = lambda: next(falling)
    assert trainer.train()["epochs_run"] == 2


def test_train_refuses_unported_switches_and_a_wrong_nc(fit):
    for kw, match in (({"plots": True}, "catalogue item 15"), ({"n_devices": 2}, "catalogue item 15"),
                      ({"fsdp": 2}, "catalogue item 15")):
        with pytest.raises(NotImplementedError, match=match):
            DetectionTrainer(_port_model(), _overrides(fit["data"], fit["root"] / "no", **kw)).train()
    with pytest.raises(NotImplementedError, match="catalogue item 15"):
        DetectionTrainer(_port_model(), {"batch": -1, "amp": False})
    with pytest.raises(ValueError, match="nc=3"):
        DetectionTrainer(TorchModel(CFG, device="cpu"), _overrides(fit["data"], fit["root"] / "no")).train()


LOOP_KEYS = ("data", "epochs", "patience", "close_mosaic", "workers", "save_period", "val", "save", "rect",
             "multi_scale", "single_cls", "exist_ok", "resume", "split", "project", "name", "fraction", "cache",
             "seed", "max_labels", "mosaic", "mosaic9", "mixup", "copy_paste", "degrees", "translate", "scale", "shear",
             "perspective", "flipud", "fliplr", "hsv_h", "hsv_s", "hsv_v")


def test_loop_cfg_defaults_match_jax_and_coerce():
    """The keys the loop reads default as in the JAX package; the ints and
    bools coerce from strings, and ``resume`` is a bool or a path."""
    from experiment_yolo_torch.cfg import get_cfg as t_cfg
    from experiment_yolo_tpu.cfg import get_cfg as j_cfg

    t, j = t_cfg(), j_cfg()
    assert {k: getattr(t, k) for k in LOOP_KEYS} == {k: getattr(j, k) for k in LOOP_KEYS}
    a = t_cfg({"epochs": "3", "patience": "1", "close_mosaic": "0", "workers": "2", "save_period": "-1",
               "val": "false", "save": "True", "rect": "true", "multi_scale": "false", "single_cls": "false",
               "exist_ok": "true", "resume": "True"})
    assert (a.epochs, a.patience, a.close_mosaic, a.workers, a.save_period) == (3, 1, 0, 2, -1)
    assert (a.val, a.save, a.rect, a.multi_scale, a.single_cls, a.exist_ok, a.resume) == (False, True, True, False,
                                                                                          False, True, True)
    assert t_cfg({"resume": "runs/detect/train/weights/last.pt"}).resume == "runs/detect/train/weights/last.pt"
    for bad in ({"epochs": "two"}, {"val": "yes"}, {"resume": 3}):
        with pytest.raises(TypeError):
            t_cfg(bad)


def test_multi_scale_matches_jax_and_trains(fit):
    """``multi_scale``: the same bucket draws and resized pixels as the JAX
    trainer's ``_rescale_batch`` (one bucket set, stride-rounded, labels
    untouched), and an epoch of ``train()`` with it runs."""
    batch = dict(fit["tbatches"][0])
    sizes = set()
    for seed in range(20):
        t = fit["tt"]._rescale_batch(batch, np.random.default_rng(seed))
        j = fit["jt"]._rescale_batch(batch, np.random.default_rng(seed))
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        sizes.add(t["img"].shape[1])
    assert sizes == {48, 64, 80}
    trainer = DetectionTrainer(_port_model(fit["init"]), _overrides(fit["data"], fit["root"] / "ms", epochs=1,
                                                                    multi_scale=True, val=False, save=False))
    assert trainer.train()["epochs_run"] == 1 and np.isfinite(list(trainer.loss_items.values())).all()
