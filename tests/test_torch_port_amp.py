"""bf16 compute (``amp=True``, the default) of the PyTorch port against the
JAX package's bf16 model and train step.

One JAX init (PRNGKey(0)) of ``yolov8-LD-P2.yaml`` at n scale is converted
into the port. The JAX models are built with ``dtype=float32`` and
``dtype=bfloat16``, their LDConv layers on the exact gather path
(``sampling='gather'``, the path the port's kernel K3 computes; the default
``'auto'`` takes a dense hat-window path at these offsets). Sizes: 64 px,
batch 2. The train steps run with ``nbs`` equal to the batch and warmup off,
so that the step fires at once and every parameter group moves at lr0.

Criterion for bf16 (the two frameworks round at other places, so bf16
results cannot agree bit for bit): the port's bf16 result is no further from
the JAX package's f32 result than 1.5 times the JAX package's own bf16
result is, in relative L2. Measured here (CPU, one torch thread): raw maps
2.0365e-3 from JAX f32 against JAX bf16's 2.0366e-3 (port bf16 vs JAX bf16
2.06e-4); in the step, loss components 9.67e-4 against 1.06e-3 (port vs JAX
bf16 7.23e-4), momentum buffers and updates 0.149 against 0.250 (port vs
JAX bf16 0.231): bf16 moves one step's gradient far from f32, in either
package.
"""

import contextlib
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiment_yolo_tpu.nn.modules as jax_modules
from experiment_yolo_torch.engine.checkpoint import load_checkpoint, read_checkpoint, save_checkpoint
from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.modules import Detect
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_bwd_plain, dfl_decode_plain
from experiment_yolo_torch.ops.kernels.ldconv_gather import WINDOW_R, ldconv_gather_bwd_plain, ldconv_gather_plain
from experiment_yolo_torch.utils.convert import jax_params_to_named, jax_variables_to_state_dict
from experiment_yolo_torch.utils import LOGGER
from experiment_yolo_torch.utils.seeded import seeded_batch
from experiment_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from experiment_yolo_tpu.engine.trainer import TrainState
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.optim.builders import YoloSGDState, build_optimizer
from experiment_yolo_tpu.ops.pallas.dfl_decode import dfl_decode_pallas
from experiment_yolo_tpu.ops.pallas.ldconv_kernel import bilinear_gather_single

CFG, IMGSZ, BATCH = "yolov8-LD-P2.yaml", 64, 2
FIRE_AT_ONCE = {"batch": BATCH, "imgsz": IMGSZ, "nbs": BATCH, "warmup_epochs": 0.0}
RATIO = 1.5  # the port's bf16 distance from JAX's f32 over JAX's own bf16 distance, at most


class _GatherLDConv(jax_modules.LDConv):
    sampling: str = "gather"


_GatherLDConv.__name__ = _GatherLDConv.__qualname__ = "LDConv"


@contextlib.contextmanager
def _gather_ldconv():
    """JAX models built inside take their LDConv layers on the exact gather path."""
    orig = jax_modules.LDConv
    jax_modules.LDConv = _GatherLDConv
    try:
        yield
    finally:
        jax_modules.LDConv = orig


def _rel(got, want) -> float:
    """Relative L2 distance over a list (or dict) of arrays taken as one vector."""
    if isinstance(want, dict):
        got, want = [got[k] for k in want], list(want.values())
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)) for a, b in zip(got, want))
    return (num / sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in want)) ** 0.5


def _spacing(x) -> np.ndarray:
    """The bf16 spacing at each element's magnitude."""
    _, e = np.frexp(np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU steps on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    with _gather_ldconv():
        jm = JaxModel(CFG)
        jm16 = JaxModel(CFG, dtype=jnp.bfloat16)
    assert all(getattr(m, "sampling", "gather") == "gather" for m in jm16.module.layers)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    state = jax_variables_to_state_dict(variables, TorchModel(CFG, device="cpu"))
    return jm, jm16, variables, state


def _port(state, dtype=torch.float32):
    model = TorchModel(CFG, device="cpu", dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model


@pytest.fixture(scope="module")
def maps(models):
    jm, jm16, variables, state = models
    x = np.random.default_rng(0).random((BATCH, IMGSZ, IMGSZ, 3), dtype=np.float32)
    j32 = [np.transpose(np.asarray(f, np.float32), (0, 3, 1, 2)) for f in jax.jit(jm.apply)(variables, x)]
    j16 = [np.transpose(np.asarray(f.astype(jnp.float32)), (0, 3, 1, 2)) for f in jax.jit(jm16.apply)(variables, x)]
    model = _port(state, torch.bfloat16)
    with torch.no_grad():
        t16 = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return j32, j16, t16


def test_bf16_raw_maps_match_jax_bf16(maps):
    """The port's bf16 forward gives bf16 maps no further from JAX's f32 maps
    than 1.5 times JAX's own bf16 maps are."""
    j32, j16, t16 = maps
    assert all(t.dtype == torch.bfloat16 for t in t16)
    t16 = [t.float().numpy() for t in t16]
    own, got = _rel(j16, j32), _rel(t16, j32)
    assert 0 < got <= RATIO * own, (got, own)
    assert _rel(t16, j16) < own  # nearer to JAX's bf16 maps than either is to f32


def _momentum(opt_state):
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if isinstance(node, YoloSGDState):
            return node.momentum
        if isinstance(node, tuple):
            stack.extend(node)
    raise LookupError("no YoloSGDState in the optimizer state")


def _jax_step(jm, variables, batch, amp):
    """One step of the JAX package's ``_make_train_step``, compiled once, with
    the optimizer its ``train()`` builds; ``amp`` rebuilds the model in bf16."""
    with _gather_ldconv():
        jt = JaxTrainer(model=jm, variables=variables, overrides={**FIRE_AT_ONCE, "amp": amp})
    jt.loss_cfg = dataclasses.replace(jt.loss_cfg, exact_topk=True)
    a = jt.args
    jt.tx = build_optimizer(variables["params"], name=a.optimizer, lr0=a.lr0, momentum=a.momentum,
                            weight_decay=a.weight_decay, nb=100, epochs=a.epochs, lrf=a.lrf, cos_lr=a.cos_lr,
                            warmup_epochs=a.warmup_epochs, warmup_bias_lr=a.warmup_bias_lr,
                            warmup_momentum=a.warmup_momentum, nc=jm.nc, accumulate=1)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(variables["params"]),
                       ema_params=jax.tree.map(jnp.copy, variables["params"]),
                       ema_batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
                       iou_mean=jnp.asarray(1.0, jnp.float32), step=jnp.zeros([], jnp.int32),
                       ema_updates=jnp.zeros([], jnp.int32))
    new, comps = jt._make_train_step()(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return new, jax.tree.map(float, comps)


@pytest.fixture(scope="module")
def steps(models):
    """One step from the same weights and batch: JAX f32, JAX bf16 (amp=True)
    and the port with ``DetectionTrainer``'s defaults (amp=True)."""
    jm, _, variables, state = models
    batch = seeded_batch(BATCH, IMGSZ, 0)
    ref = TorchModel(CFG, device="cpu")
    out = {}
    for label, amp in (("jax f32", False), ("jax bf16", True)):
        new, comps = _jax_step(jm, variables, batch, amp)
        out[label] = {"comps": [comps[k] for k in ("box", "cls", "dfl")],
                      "momentum": {n: np.asarray(v) for n, v in jax_params_to_named(_momentum(new.opt_state),
                                                                                      ref).items()},
                      "updates": {n: np.asarray(p) - state[n].numpy()
                                  for n, p in jax_variables_to_state_dict(jax.tree.map(np.asarray, {
                                      "params": new.params, "batch_stats": new.batch_stats}), ref).items()
                                  if n in dict(ref.named_parameters())}}
    model = _port(state)
    trainer = DetectionTrainer(model, {k: v for k, v in FIRE_AT_ONCE.items()})  # amp: the default
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    comps = trainer.train_step(batch)
    opt = trainer.state.optimizer
    out["port bf16"] = {"comps": [float(comps[k]) for k in ("box", "cls", "dfl")],
                        "momentum": {n: opt.state[p]["momentum_buffer"].numpy() for n, p in model.named_parameters()},
                        "updates": {n: (p.detach() - before[n]).numpy() for n, p in model.named_parameters()},
                        "dtype": model.dtype, "updates_fired": opt.updates}
    return out


def test_trainer_defaults_train_in_bf16(steps):
    assert steps["port bf16"]["dtype"] == torch.bfloat16 and steps["port bf16"]["updates_fired"] == 1


@pytest.mark.parametrize("what", ["comps", "momentum", "updates"])
def test_bf16_step_matches_jax_bf16_step(steps, what):
    """Loss components, momentum buffers (the step's clipped gradient plus
    weight decay) and parameter updates of the port's bf16 step: no further
    from JAX's f32 step than 1.5 times JAX's bf16 step is, in relative L2."""
    ref = steps["jax f32"][what]
    own, got = _rel(steps["jax bf16"][what], ref), _rel(steps["port bf16"][what], ref)
    assert 0 < got <= RATIO * own, (what, got, own)


@pytest.fixture
def logged():
    """The messages of the port's logger during a test."""
    class Records(logging.Handler):
        def __init__(self):
            super().__init__()
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    handler = Records()
    LOGGER.addHandler(handler)
    yield handler.messages
    LOGGER.removeHandler(handler)


def test_check_amp_passes_on_ldp2(logged):
    """``_check_amp`` on LD-P2: bf16 within 0.1 relative L2 of f32, so training
    stays in bf16; the model's mode and its BatchNorm statistics are left as
    they were."""
    model = TorchModel(CFG, device="cpu")
    trainer = DetectionTrainer(model, {"batch": BATCH, "imgsz": IMGSZ})
    running = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    trainer._check_amp()
    assert trainer.amp_check["passed"] and trainer.amp_check["finite"] and 0 < trainer.amp_check["rel_err"] < 0.01
    assert trainer.dtype == model.dtype == trainer.state.ema.ema.dtype == torch.bfloat16 and model.training
    assert all(torch.equal(model.state_dict()[k], v) for k, v in running.items())
    assert logged == [f"AMP check ok (bf16 rel err {trainer.amp_check['rel_err']:.4f})"]


def test_check_amp_falls_back_to_f32_on_divergence(monkeypatch, logged):
    """A bf16 forward that diverges (here Detect's bf16 maps are doubled)
    makes ``_check_amp`` fall back to f32 with the JAX package's log line:
    the trainer, its model and its EMA then compute in f32."""
    forward = Detect.forward

    def diverging(self, xs):
        out = forward(self, xs)
        return [2 * f for f in out] if self.dtype == torch.bfloat16 else out

    monkeypatch.setattr(Detect, "forward", diverging)
    model = TorchModel(CFG, device="cpu")
    trainer = DetectionTrainer(model, {"batch": BATCH, "imgsz": IMGSZ})
    trainer._check_amp()
    assert not trainer.amp_check["passed"] and trainer.amp_check["rel_err"] > 0.9
    assert trainer.dtype == model.dtype == trainer.state.ema.ema.dtype == torch.float32
    assert logged == [f"AMP check failed (rel err {trainer.amp_check['rel_err']:.3f}) — disabling bf16 compute"]


def test_check_amp_lets_exceptions_through(monkeypatch):
    """Unlike the JAX package's check, which logs "skipped", an exception in
    either forward propagates: a kernel that fails must not be hidden."""
    def broken(self, xs):
        raise RuntimeError("a kernel failed")

    monkeypatch.setattr(Detect, "forward", broken)
    trainer = DetectionTrainer(TorchModel(CFG, device="cpu"), {"batch": BATCH, "imgsz": IMGSZ})
    with pytest.raises(RuntimeError, match="a kernel failed"):
        trainer._check_amp()


def _head_map(seed, h=8, w=8):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((2, 70, h, w))).astype(np.float32)
    x[0, 0:16, 0, 0] += 200.0  # a cross-group logit spread far past exp's range
    x[0, 16:32, 0, 0] -= 200.0
    return torch.from_numpy(x).bfloat16()


def _nhwc_box(x):
    b, _, h, w = x.shape
    return jnp.asarray(np.transpose(x[:, :64].float().numpy(), (0, 2, 3, 1)).reshape(b, h * w, 64)).astype(
        jnp.bfloat16)


def test_plain_k1_on_bf16_matches_pallas_interpret():
    """K1's plain version on a bf16 map: widened, computed in f32, f32 out,
    within 1e-5 of ``dfl_decode_pallas`` in interpret mode on the same bf16
    input (which widens it first too)."""
    x = _head_map(0)
    got = dfl_decode_plain(x)
    assert got.dtype == torch.float32
    want = np.asarray(dfl_decode_pallas(_nhwc_box(x), 16, True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_k1_backward_on_bf16_matches_pallas_vjp():
    """K1's plain backward on a bf16 map: ``dx`` in bf16, within one bf16
    spacing of the VJP of ``dfl_decode_pallas`` (whose ``_bwd_kernel`` writes
    dx in the input's dtype) on the same inputs; class channels exactly 0."""
    x = _head_map(1)
    g = np.random.default_rng(2).standard_normal((2, 64, 4)).astype(np.float32)
    y, vjp = jax.vjp(lambda d: dfl_decode_pallas(d, 16, True), _nhwc_box(x))
    want = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    got = dfl_decode_bwd_plain(x, torch.from_numpy(np.asarray(y)), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16 and not got[:, 64:].float().any()
    box = np.transpose(got[:, :64].float().numpy(), (0, 2, 3, 1)).reshape(2, 64, 64)
    assert (np.abs(box - want) <= _spacing(want)).all()


def test_plain_k3_on_bf16_matches_pallas_interpret():
    """K3's plain version on a bf16 source: the f32 gather of the widened
    source times the border multiplier, rounded once to bf16; against
    ``bilinear_gather_single`` in interpret mode on the same bf16 source and
    positions, rounded likewise: within one bf16 spacing (the two sum their
    corners in another order)."""
    from test_torch_port_ldconv import _border_mul, _inputs, _jax_positions

    n, stride = 3, 1
    x, off = _inputs(4, n, stride)
    xb = torch.from_numpy(x).bfloat16()
    b, c, hx, wx = x.shape
    p, pad_r, pad_c = _jax_positions(off, stride, hx, wx)
    xp = np.pad(np.transpose(xb.float().numpy(), (0, 2, 3, 1)), ((0, 0), (WINDOW_R, pad_r), (WINDOW_R, pad_c),
                                                                  (0, 0)), mode="edge")
    mul = np.asarray(_border_mul(p, hx, wx))
    got = ldconv_gather_plain(xb, torch.from_numpy(off), stride)
    assert got.dtype == torch.bfloat16
    for i in range(b):
        q = np.asarray(p[i]).reshape(-1, 2)
        want = np.asarray(bilinear_gather_single(jnp.asarray(xp[i]).astype(jnp.bfloat16), jnp.asarray(q),
                                                 interpret=True))
        want = np.asarray(jnp.asarray((want * mul[i].reshape(-1, 1)).reshape(-1, n * c)).astype(jnp.bfloat16),
                          np.float32)
        assert (np.abs(got[i].float().numpy() - want) <= _spacing(want)).all()


def test_plain_k3_backward_on_bf16_rounds_the_f32_sums_once():
    """K3's plain backward on a bf16 source and gradient: ``dx`` is the f32
    result on the widened inputs rounded once to bf16, ``doff`` the f32
    result itself."""
    from test_torch_port_ldconv import _inputs

    x, off = _inputs(5, 3, 1)
    xb = torch.from_numpy(x).bfloat16()
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 13 * 11, 15)).astype(np.float32)).bfloat16()
    dx, doff = ldconv_gather_bwd_plain(xb, torch.from_numpy(off), dy, 1)
    dx32, doff32 = ldconv_gather_bwd_plain(xb.float(), torch.from_numpy(off), dy.float(), 1)
    assert dx.dtype == torch.bfloat16 and doff.dtype == torch.float32
    assert torch.equal(dx, dx32.bfloat16()) and torch.equal(doff, doff32)


def test_wrappers_refuse_other_dtypes_on_the_card():
    """On a CUDA tensor the kernels take f32 or bf16 and nothing else: the
    check every wrapper makes raises on float16 (here on a stand-in for a
    CUDA tensor, before any launch)."""
    class CudaStandIn:
        device = torch.device("cuda")
        dtype = torch.float16

        def dim(self):
            return 4

    with pytest.raises(TypeError, match="expected torch.float32 or torch.bfloat16, got torch.float16"):
        _build.validate(CudaStandIn(), "ldconv_gather x", (torch.float32, torch.bfloat16), 4)


def test_vss_models_refuse_bf16():
    """VSS models no longer refuse bf16: the JAX package's SS2D runs its scan
    in f32 inside a bf16 model, and so does the port's. A VSS model builds
    in bf16 and switches to it, every SS2D and VSSBlock with it, and
    ``DetectionTrainer``'s defaults (amp=True) train it in bf16."""
    from experiment_yolo_torch.nn.zoo_blocks import SS2D, VSSBlock

    model = TorchModel("yolov8-C2f-VSS.yaml", device="cpu", dtype=torch.bfloat16)
    blocks = [m for m in model.modules() if isinstance(m, (SS2D, VSSBlock))]
    assert model.dtype == torch.bfloat16 and len(blocks) == 20 and all(m.dtype == torch.bfloat16 for m in blocks)
    model.dtype = torch.float32
    assert all(m.dtype == torch.float32 for m in blocks)
    trainer = DetectionTrainer(model, {"batch": BATCH})
    assert trainer.dtype == model.dtype == trainer.state.ema.ema.dtype == torch.bfloat16
    assert all(m.dtype == torch.bfloat16 for m in blocks)


def test_checkpoints_hold_f32_weights_whatever_the_compute_dtype(tmp_path):
    model = TorchModel(CFG, device="cpu", dtype=torch.bfloat16)
    save_checkpoint(tmp_path / "m.pt", model)
    assert all(v.dtype in (torch.float32, torch.int64) for v in read_checkpoint(tmp_path / "m.pt")["model"].values())
    loaded = load_checkpoint(tmp_path / "m.pt", device="cpu", dtype=torch.bfloat16)
    assert loaded.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in loaded.parameters())
