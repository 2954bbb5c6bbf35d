"""The VSS family in training, f32 and bf16 (``amp=True``, the default): a
port ``train_step`` of a small VSS detector against one step of the JAX
package's ``_make_train_step``, and the bf16 SS2D against the JAX package's.

The detector holds two ``C2f_VSS`` levels of one VSS block each (d_inner 32
and 64) and a Detect on both, at 64 px, batch 2: scans of 256 and 64 steps.
Its weights are the JAX init moved off its constants with a numpy seed
(``tests/test_torch_port_vss.py:_shake``: decays, step sizes and skips that
differ by channel and direction). Both trainers take one seeded labelled
batch with ``nbs`` equal to the batch and warmup off, so that the step fires
at once and every parameter group moves at lr0 (``tests/test_torch_port_amp.py``'s
setting). The JAX side scans with ``associative_scan`` and trains through its
autodiff, the port walks the recurrence and its reverse step by step
(``selective_scan_bwd_plain`` is the CPU form of kernel K4's backward).

Gates, as ``tests/test_torch_port_train.py`` and ``tests/test_torch_port_amp.py``
set them: in f32 losses within 1e-4 relative,
every momentum buffer (the clipped gradient plus weight decay) within 1e-3
relative L2, parameters within 1e-5 abs + 1e-4 rel; in bf16, loss
components, momentum buffers and updates no further from JAX's f32 step
than 1.5 times JAX's own bf16 step is, in relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn import zoo_blocks as tz
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.utils import convert
from experiment_yolo_torch.utils.convert import jax_params_to_named, jax_variables_to_state_dict
from experiment_yolo_torch.utils.seeded import seeded_batch
from experiment_yolo_tpu.nn import zoo_blocks as jz
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from test_torch_port_amp import FIRE_AT_ONCE, RATIO, _jax_step, _momentum, _rel
from test_torch_port_train import _rel_ok
from test_torch_port_vss import _load, _shake

IMGSZ, BATCH = 64, 2
SMALL = {
    "nc": 6,
    "scales": {"n": [0.33, 0.25, 1024]},
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],  # 0  /2
        [-1, 1, "Conv", [128, 3, 2]],  # 1  /4
        [-1, 3, "C2f_VSS", [128, True]],  # 2  one VSS bottleneck at n scale
        [-1, 1, "Conv", [256, 3, 2]],  # 3  /8
        [-1, 3, "C2f_VSS", [256, True]],  # 4
    ],
    "head": [[[2, 4], 1, "Detect", ["nc"]]],  # 5
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps():
    """One step from the same weights and batch: JAX f32 and bf16, the port in
    f32 (``amp=False``) and with ``DetectionTrainer``'s defaults (bf16)."""
    jm = JaxModel(dict(SMALL))
    variables = _shake(jm.init(jax.random.PRNGKey(0)), seed=13)
    ref = TorchModel(dict(SMALL), device="cpu")
    state = jax_variables_to_state_dict(variables, ref)
    params = dict(ref.named_parameters())
    batch = seeded_batch(BATCH, IMGSZ, 0)
    out = {}
    for label, amp in (("jax f32", False), ("jax bf16", True)):
        new, comps = _jax_step(jm, variables, batch, amp)
        after = jax_variables_to_state_dict(jax.tree.map(np.asarray, {"params": new.params,
                                                                        "batch_stats": new.batch_stats}), ref)
        out[label] = {"comps": [comps[k] for k in ("box", "cls", "dfl")],
                      "momentum": {n: np.asarray(v) for n, v in jax_params_to_named(_momentum(new.opt_state),
                                                                                      ref).items()},
                      "updates": {n: after[n].numpy() - state[n].numpy() for n in params}, "after": after}
    for label, amp in (("port f32", False), ("port bf16", True)):
        model = TorchModel(dict(SMALL), device="cpu")
        model.load_state_dict(state, strict=True)
        trainer = DetectionTrainer(model, {**FIRE_AT_ONCE, "amp": amp})
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        comps = trainer.train_step(batch)
        opt = trainer.state.optimizer
        out[label] = {"comps": [float(comps[k]) for k in ("box", "cls", "dfl")], "fg": float(comps["fg"]),
                      "momentum": {n: opt.state[p]["momentum_buffer"].numpy() for n, p in model.named_parameters()},
                      "updates": {n: (p.detach() - before[n]).numpy() for n, p in model.named_parameters()},
                      "after": model.state_dict(), "dtype": model.dtype, "fired": opt.updates,
                      "scans": sum(isinstance(m, tz.SS2D) for m in model.modules())}
    return out


def test_f32_step_losses_and_foreground_match_jax(steps):
    port, jax_ = steps["port f32"], steps["jax f32"]
    assert port["scans"] == 2 and port["fired"] == 1 and port["dtype"] == torch.float32
    assert port["fg"] > 10
    np.testing.assert_allclose(port["comps"], jax_["comps"], rtol=1e-4)


def test_f32_step_every_momentum_buffer_matches_jax(steps):
    """Every parameter's momentum buffer, SS2D's scan parameters (the
    gradients of K4's backward) among them, within 1e-3 relative L2."""
    port, jax_ = steps["port f32"], steps["jax f32"]
    bad = [n for n in port["momentum"] if not _rel_ok(port["momentum"][n], jax_["momentum"][n])]
    assert not bad, bad[:5]
    scan = [n for n in port["momentum"] if n.rsplit(".", 1)[-1] in ("x_proj_weight", "dt_projs_weight",
                                                                     "dt_projs_bias", "A_logs", "Ds")]
    assert len(scan) == 10 and all(np.abs(port["momentum"][n]).max() > 0 for n in scan)


def test_f32_step_parameters_and_bn_statistics_match_jax(steps):
    port, jax_ = steps["port f32"], steps["jax f32"]
    for name, v in port["after"].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), jax_["after"][name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("what", ["comps", "momentum", "updates"])
def test_bf16_step_matches_jax_bf16_step(steps, what):
    """The port's bf16 step (its default) is no further from JAX's f32 step
    than 1.5 times JAX's own bf16 step is."""
    assert steps["port bf16"]["dtype"] == torch.bfloat16 and steps["port bf16"]["fired"] == 1
    ref = steps["jax f32"][what]
    own, got = _rel(steps["jax bf16"][what], ref), _rel(steps["port bf16"][what], ref)
    assert 0 < got <= RATIO * own, (what, got, own)


@pytest.mark.parametrize("d_model", [16, 32])
def test_bf16_ss2d_matches_jax_bf16_ss2d(d_model):
    """SS2D in bf16 (``in_proj``, ``conv2d``, ``out_norm``, the gate and
    ``out_proj`` in bf16; the projections to dt, B, C and the scan in f32):
    its output is bf16 and no further from JAX's f32 SS2D than 1.5 times
    JAX's bf16 SS2D is, on a non-square map."""
    x = np.random.default_rng(d_model).standard_normal((2, 6, 10, d_model)).astype(np.float32)
    params = _shake(jax.jit(jz.SS2D(d_model=d_model).init)(jax.random.PRNGKey(0), x), seed=d_model + 1)["params"]
    j32 = np.asarray(jax.jit(jz.SS2D(d_model=d_model).apply)({"params": params}, x))
    j16 = jax.jit(jz.SS2D(d_model=d_model, dtype=jnp.bfloat16).apply)({"params": params}, jnp.asarray(x, jnp.bfloat16))
    j16 = np.asarray(j16).astype(np.float32)
    tm = _load(tz.SS2D(d_model), {"params": {"self_attention": params}},
               lambda parts: convert._vss((), ["self_attention", *parts]))
    tm.dtype = torch.bfloat16
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    own, dist = _rel(j16, j32), _rel(got.float().numpy(), j32)
    assert 0 < dist <= RATIO * own, (dist, own)


def test_vss_model_switches_every_scan_block_to_the_compute_dtype():
    """``DetectionModel.dtype`` reaches every SS2D and VSSBlock; their
    parameters stay f32 and the bf16 forward gives bf16 maps."""
    model = TorchModel(dict(SMALL), device="cpu", dtype=torch.bfloat16)
    blocks = [m for m in model.modules() if isinstance(m, (tz.SS2D, tz.VSSBlock))]
    assert len(blocks) == 4 and all(m.dtype == torch.bfloat16 for m in blocks)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        maps = model(torch.rand(1, 3, IMGSZ, IMGSZ))
    assert all(f.dtype == torch.bfloat16 and bool(torch.isfinite(f.float()).all()) for f in maps)
    model.dtype = torch.float32
    assert all(m.dtype == torch.float32 for m in blocks)


def test_every_vss_parameter_lands_in_the_jax_group():
    """Each parameter of the VSS detector lands in the group the JAX package's
    ``param_group_label`` gives its counterpart (found through the converter):
    the LayerNorms' weights (flax ``scale``) in the norm group, without weight
    decay, as BatchNorm's; their biases and ``conv2d``'s in the bias group;
    SS2D's projections and raw scan parameters, ``dt_projs_bias`` among them,
    in the weight group."""
    from experiment_yolo_torch.optim import builders as tb
    from experiment_yolo_tpu.optim import builders as jb

    model = TorchModel(dict(SMALL), device="cpu")
    shapes = jax.eval_shape(JaxModel(dict(SMALL)).init, jax.random.PRNGKey(0))["params"]
    jlabels = {tuple(getattr(p, "key", p) for p in path): jb.param_group_label(path, leaf)
               for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    groups = tb.param_groups(model)
    for label, named in groups.items():
        for name, _ in named:
            kind, path = convert.jax_path(name, model)
            assert kind == "params" and jlabels[path] == label, (name, label)
    block = "model.2.m.0.cv2"
    assert {f"{block}.ln_1.weight", f"{block}.self_attention.out_norm.weight"} <= {n for n, _ in groups["norm"]}
    assert {f"{block}.self_attention.{p}" for p in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs",
                                                    "Ds")} <= {n for n, _ in groups["weight"]}


def test_check_amp_passes_on_the_vss_model():
    """``_check_amp`` on ``yolov8-C2f-VSS.yaml`` (64 px): bf16 within 0.1
    relative L2 of f32, so training stays in bf16; the scan, which runs in
    f32 inside the bf16 model, does not make it fall back."""
    model = TorchModel("yolov8-C2f-VSS.yaml", device="cpu")
    trainer = DetectionTrainer(model, {"batch": BATCH, "imgsz": IMGSZ})
    trainer._check_amp()
    assert trainer.amp_check["passed"] and trainer.amp_check["finite"] and 0 < trainer.amp_check["rel_err"] < 0.01
    assert trainer.dtype == model.dtype == trainer.state.ema.ema.dtype == torch.bfloat16
