"""The pose family in the PyTorch port against the JAX package: the whole
``PoseModel`` (``yolov8-pose.yaml`` at n scale, nc 1, kpt 17 x 3, 64 px:
parameter count, converter, raw maps and ``predict``) and at 5 x 3 its
parameter count and its ``Pose`` head with the keypoint decode;
``pose_loss`` in f32 and bf16 with its gradients (both keypoint shapes, an
invisible keypoint, no foreground); ``kpt_oks_np`` and ``PoseValidator``'s
stats; the synthetic pose dataset's labels and the keypoints of its samples
through letterbox, mosaic 4 and 9, the warp, flips (with and without
``flip_idx``) and MixUp; the predictor's keypoints in the original image,
``Results.Keypoints``, ``to_dict`` and the server's JSON; a pose checkpoint's
round trip and the head rebuilt to a dataset's ``kpt_shape``.

JAX variables are the model's init tree (``jax.eval_shape``) filled from a
seed (``tests/test_torch_port_asf.py:_seeded_like_init``). Each JAX function
is jitted once for the file.
"""

import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch import YOLO
from experiment_yolo_torch.cfg import get_cfg as t_cfg
from experiment_yolo_torch.data import YOLODataset as TDataset
from experiment_yolo_torch.data import augment as TA
from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.data import make_synthetic_task_dataset as t_make
from experiment_yolo_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.results import Results as TResults
from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.engine.validators_extra import PoseValidator, kpt_oks_np
from experiment_yolo_torch.nn.tasks import DetectionModel as TDetModel
from experiment_yolo_torch.nn.tasks import PoseModel as TPoseModel
from experiment_yolo_torch.nn.tasks import guess_model_task, task_model, yaml_model_load
from experiment_yolo_torch.serve import serialize_results
from experiment_yolo_torch.utils.convert import jax_variables_to_state_dict
from experiment_yolo_torch.utils.loss import LossConfig as TLossConfig
from experiment_yolo_torch.utils.seeded import sized_boxes_
from experiment_yolo_torch.utils.task_losses import OKS_SIGMA, pose_loss as t_pose_loss
from experiment_yolo_tpu.cfg import get_cfg as j_cfg
from experiment_yolo_tpu.data import DataLoader as JLoader
from experiment_yolo_tpu.data import YOLODataset as JDataset
from experiment_yolo_tpu.data.synthetic import make_synthetic_task_dataset as j_make
from experiment_yolo_tpu.engine.results import Results as JResults
from experiment_yolo_tpu.engine.validators_extra import PoseValidator as JValidator
from experiment_yolo_tpu.engine.validators_extra import kpt_oks_np as j_kpt_oks_np
from experiment_yolo_tpu.nn.tasks import PoseModel as JPoseModel
from experiment_yolo_tpu.serve import serialize_results as j_serialize
from experiment_yolo_tpu.utils.loss import LossConfig as JLossConfig
from experiment_yolo_tpu.utils.task_losses import OKS_SIGMA as J_OKS_SIGMA
from experiment_yolo_tpu.utils.task_losses import pose_loss as j_pose_loss
from test_torch_port_asf import _seeded_like_init

NC, IMGSZ, REG_MAX = 1, 64, 16
STRIDES = (8, 16, 32)
SHAPES = [(IMGSZ // s, IMGSZ // s) for s in STRIDES]
RATIO = 1.5  # bf16: the port's distance from JAX's f32 over JAX's own bf16 distance, at most (the _amp criterion)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))


def _pose_cfg(kpt_shape):
    return {**yaml_model_load("yolov8n-pose.yaml"), "nc": NC, "kpt_shape": list(kpt_shape)}


# -- the model -------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pose_pair():
    """``yolov8-pose.yaml`` at n scale, nc 1, 17 x 3: the JAX model and seeded
    variables, and the port model with them converted."""
    cfg = _pose_cfg((17, 3))
    jm = JPoseModel(cfg)
    variables = _seeded_like_init(jm, 7)
    tm = TPoseModel(cfg, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    tm.eval()
    return jm, variables, tm


def test_pose_model_build_predict_and_task_match_jax(pose_pair):
    """Parameter count and strides of the JAX model; the eval forward's
    detect and keypoint maps, and ``predict``'s boxes, scores and keypoints
    (pixels, JAX's raw ``2 p + anchor - 0.5`` form, visibility sigmoided),
    within 1e-4 of each tensor's largest value; the head's ``kpt_shape``
    from the YAML's top-level key."""
    jm, variables, tm = pose_pair
    assert tm.kpt_shape == tuple(jm.kpt_shape) == (17, 3)
    assert sum(p.numel() for p in tm.parameters()) == sum(v.size for v in jax.tree.leaves(variables["params"]))
    assert tuple(tm.stride) == tuple(jm.strides) == STRIDES
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    (jdet, jkpt), jpred = jax.jit(lambda v, xx: (jm.module.apply(v, xx, False), jm.predict(v, xx)))(variables,
                                                                                                   jnp.asarray(x))
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    with torch.no_grad():
        tdet, tkpt = tm(xt)
        tpred = tm.predict(xt)
    for t, j in [*zip(tdet, jdet), *zip(tkpt, jkpt)]:
        j = _nchw(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0)
    for i, (t, j) in enumerate(zip(tpred, jpred)):
        j = np.asarray(j)
        assert t.shape == j.shape, i
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0, err_msg=str(i))
    assert tpred[2].shape == (2, sum(h * w for h, w in SHAPES), 17, 3)


def test_pose_head_at_5x3_matches_jax():
    """At 5 x 3: the whole model's parameter count equal to its JAX init
    tree's, and its ``Pose`` head alone (seeded variables through the
    converter, random neck maps) with ``decode_kpts``: the
    detect and keypoint maps and the decoded keypoints within 1e-4 of each
    tensor's largest value."""
    from experiment_yolo_tpu.nn.heads_extra import Pose as JPose
    from experiment_yolo_tpu.nn.heads_extra import decode_kpts as j_decode_kpts

    from experiment_yolo_torch.nn.heads_extra import decode_kpts as t_decode_kpts

    cfg = _pose_cfg((5, 3))
    jm5 = JPoseModel(cfg)
    variables = _seeded_like_init(jm5, 8)
    tm5 = TPoseModel(cfg, device="cpu")
    tm5.load_state_dict(jax_variables_to_state_dict(variables, tm5), strict=True)
    tm5.eval()
    assert tm5.kpt_shape == tuple(jm5.kpt_shape) == (5, 3)
    assert sum(p.numel() for p in tm5.parameters()) == sum(v.size for v in jax.tree.leaves(variables["params"]))
    thead = tm5.detect
    ch = [m[0].conv.in_channels for m in thead.cv2]
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, h, w, c)).astype(np.float32) for (h, w), c in zip(SHAPES, ch)]
    jhead = JPose(nc=NC, kpt_shape=(5, 3), ch=tuple(ch))
    layer = f"layers_{len(tm5.model) - 1}"
    v = {k: t[layer] for k, t in variables.items()}
    jdet, jkpt = jax.jit(lambda vv, xx: jhead.apply(vv, xx, False))(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        tdet, tkpt = thead([torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))) for x in xs])
    for t, j in [*zip(tdet, jdet), *zip(tkpt, jkpt)]:
        j = _nchw(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0)
    want = np.asarray(j_decode_kpts(jkpt, STRIDES, (5, 3)))
    got = t_decode_kpts(tkpt, STRIDES, (5, 3)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_pose_task_routing():
    """A ``-pose`` YAML builds a ``PoseModel`` through the facade; a
    ``DetectionModel`` refuses a Pose head and a ``PoseModel`` a Detect head;
    the two-stage methods refuse a pose model; classify still raises
    naming catalogue item 13."""
    assert guess_model_task("yolov8n-pose.yaml") == "pose" and task_model("pose") is TPoseModel
    yolo = YOLO("yolov8n-pose.yaml", device="cpu")
    assert type(yolo.model) is TPoseModel and yolo.task == "pose" and yolo.model.kpt_shape == (17, 3)
    for method in (yolo.double_predict, yolo.sliced_predict):
        with pytest.raises(NotImplementedError, match="detection model"):
            method([np.zeros((64, 64, 3), np.uint8)])
    with pytest.raises(ValueError, match="PoseModel"):
        TDetModel(_pose_cfg((17, 3)), device="cpu")
    with pytest.raises(ValueError, match="DetectionModel"):
        TPoseModel("yolov8n.yaml", device="cpu")
    for task in ("classify",):
        with pytest.raises(NotImplementedError, match="catalogue item 13"):
            task_model(task)


# -- the keypoint loss -----------------------------------------------------------------------------------------

def _loss_inputs(kpt_shape, seed, invisible=0.0, no_fg=False, m=6):
    """Three detect maps, keypoint maps and labels of ``m`` boxes an image
    with their keypoints (inside the boxes; a share ``invisible`` of them at
    visibility 0, one per instance at least when that share is > 0); with
    ``no_fg`` every label row is padding."""
    rng = np.random.default_rng(seed)
    nk, nd = kpt_shape
    b = 2
    maps = [(2 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32) for h, w in SHAPES]
    kmaps = [(0.5 * rng.standard_normal((b, nk * nd, h, w))).astype(np.float32) for h, w in SHAPES]
    wh = rng.uniform(12, 40, (b, m, 2))
    xy = rng.uniform(wh / 2, IMGSZ - wh / 2)
    bboxes = (np.concatenate([xy, wh], -1) / IMGSZ).astype(np.float32)
    kp = xy[:, :, None] + rng.uniform(-0.5, 0.5, (b, m, nk, 2)) * wh[:, :, None]
    vis = np.where(rng.uniform(size=(b, m, nk)) < invisible, 0.0, 2.0)
    if invisible:
        vis[..., 0] = 0.0
    kpts = np.concatenate([kp / IMGSZ, vis[..., None]], -1)[..., :nd].astype(np.float32)
    lab = {"bboxes": bboxes, "cls": np.zeros((b, m), np.int32), "mask": np.full((b, m), not no_fg),
           "keypoints": kpts}
    return maps, kmaps, lab


LOSS_CASES = {"17x3": ((17, 3), {}), "5x3, invisible keypoints": ((5, 3), {"invisible": 0.3}),
              "5x3, no foreground": ((5, 3), {"no_fg": True})}


@partial(jax.jit, static_argnames=("kpt_shape",))
def _jax_pose_fn(feats, kmaps, lab, kpt_shape):
    def fn(f, k):
        total, comps, _ = j_pose_loss(f, k, lab, STRIDES, JLossConfig(nc=NC, exact_topk=True), None,
                                      kpt_shape=kpt_shape)
        return total, comps

    return jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(feats, kmaps)


def _jax_pose_loss(maps, kmaps, lab, kpt_shape, dtype):
    """(total, comps, gradients with respect to the maps and keypoint maps),
    jitted; the keypoint maps in ``dtype``, the maps f32, as the JAX
    trainer's pose branch hands them."""
    (total, comps), grads = _jax_pose_fn([jnp.asarray(np.transpose(m, (0, 2, 3, 1))) for m in maps],
                                         [jnp.asarray(np.transpose(k, (0, 2, 3, 1))).astype(dtype) for k in kmaps],
                                         {k: jnp.asarray(v) for k, v in lab.items()}, kpt_shape)
    return float(total), {k: float(v) for k, v in comps.items()}, [_nchw(x) for x in (*grads[0], *grads[1])]


def _port_pose_loss(maps, kmaps, lab, kpt_shape, dtype):
    f = [torch.from_numpy(m).requires_grad_() for m in maps]
    k = [torch.from_numpy(x).to(dtype).requires_grad_() for x in kmaps]
    total, comps, res, _ = t_pose_loss(f, k, {n: torch.from_numpy(v) for n, v in lab.items()}, STRIDES,
                                       TLossConfig(nc=NC), kpt_shape=kpt_shape)
    total.backward()
    return total.item(), {n: v.item() for n, v in comps.items()}, [x.grad.float().numpy() for x in (*f, *k)], res


@pytest.fixture(scope="module")
def pose_losses():
    out = {}
    for name, (kpt_shape, kw) in LOSS_CASES.items():
        maps, kmaps, lab = _loss_inputs(kpt_shape, 0, **kw)
        out[name] = {"j32": _jax_pose_loss(maps, kmaps, lab, kpt_shape, jnp.float32),
                     "j16": _jax_pose_loss(maps, kmaps, lab, kpt_shape, jnp.bfloat16),
                     "t32": _port_pose_loss(maps, kmaps, lab, kpt_shape, torch.float32),
                     "t16": _port_pose_loss(maps, kmaps, lab, kpt_shape, torch.bfloat16), "lab": lab}
    return out


def _rel_l2(a, b):
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb else np.linalg.norm(a)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_pose_loss_matches_jax(pose_losses, case):
    """f32: the total and box, cls, dfl, pose, kobj within 1e-5 relative of
    JAX's (1e-6 absolute where JAX's is 0: no foreground), each gradient
    within 1e-4 relative L2 (1e-6 absolute where JAX's is 0)."""
    total, comps, grads, res = pose_losses[case]["t32"]
    jtotal, jcomps, jgrads = pose_losses[case]["j32"]
    fg = int(res.fg_mask.sum())
    assert (fg == 0) == case.endswith("no foreground")
    assert sorted(comps) == sorted(jcomps) == ["box", "cls", "dfl", "kobj", "pose"]
    for k in jcomps:
        np.testing.assert_allclose(comps[k], jcomps[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert _rel_l2(g, jg) <= (1e-4 if np.linalg.norm(jg) else 1e-6), i
    if fg:
        assert jcomps["pose"] > 0 and jcomps["kobj"] > 0
    if "invisible" in case:
        assert (pose_losses[case]["lab"]["keypoints"][..., 2] == 0).any()


@pytest.mark.parametrize("what", ["values", "gradients"])
def test_pose_loss_bf16_within_jax_bf16_error(pose_losses, what):
    """Keypoint maps in bf16 (the maps f32): over the cases, the port's values
    (total and components) or gradients are no further from JAX's f32
    results than 1.5 times JAX's own bf16 results are."""
    def vec(r):
        return np.asarray([r[0], *[r[1][k] for k in ("box", "cls", "dfl", "pose", "kobj")]]) if what == "values" \
            else np.concatenate([g.ravel() for g in r[2]])
    port = jaxd = 0.0
    for case in LOSS_CASES:
        ref = vec(pose_losses[case]["j32"])
        port += np.sum((vec(pose_losses[case]["t16"]) - ref) ** 2)
        jaxd += np.sum((vec(pose_losses[case]["j16"]) - ref) ** 2)
    assert jaxd > 0
    assert np.sqrt(port) <= RATIO * np.sqrt(jaxd), (np.sqrt(port), np.sqrt(jaxd))


def test_kpt_oks_matches_jax():
    """``kpt_oks_np`` equal to JAX's, COCO sigmas and 1 / nk ones, with
    invisible ground-truth keypoints and predictions of 2 dims."""
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(OKS_SIGMA, J_OKS_SIGMA)
    for nk, nd_pred in ((17, 3), (5, 2)):
        pred = rng.uniform(0, 50, (7, nk, nd_pred))
        gt = np.concatenate([rng.uniform(0, 50, (4, nk, 2)), rng.integers(0, 3, (4, nk, 1))], -1)
        area = rng.uniform(50, 900, 4)
        sig = OKS_SIGMA if nk == 17 else np.ones(nk) / nk
        np.testing.assert_array_equal(kpt_oks_np(pred, gt, area, sig), j_kpt_oks_np(pred, gt, area, sig))


# -- data --------------------------------------------------------------------------------------------------------

SIZES = [(64, 64), (48, 80), (96, 64), (80, 40), (64, 100), (33, 77)]
SAMPLE_HYPS = {
    "mosaic4, warp, flips": {"degrees": 10.0, "shear": 5.0, "perspective": 1e-4, "flipud": 0.5},
    "mosaic9, warp": {"mosaic9": 1.0, "degrees": 10.0, "flipud": 0.5, "translate": 0.3},
    "mixup": {"mixup": 1.0, "degrees": 10.0, "perspective": 1e-4},
    "letterbox, warp, flips": {"mosaic": 0.0, "degrees": 10.0, "shear": 5.0, "flipud": 0.5, "scale": 0.9},
    "letterbox": {"mosaic": 0.0, "degrees": 0.0, "translate": 0.0, "scale": 0.0, "fliplr": 0.0, "hsv_h": 0.0,
                  "hsv_s": 0.0, "hsv_v": 0.0},
}
FLIP_IDX = [0, 3, 4, 1, 2]  # the centre stays, the ring's keypoints swap in pairs


@pytest.fixture(scope="module")
def pose_data(tmp_path_factory):
    """The port's synthetic pose dataset (6 train, 4 val at 64 px, 5
    keypoints), and a copy at mixed image sizes."""
    root = tmp_path_factory.mktemp("pose")
    yaml = t_make(root / "synthetic", "pose", n_train=6, n_val=4, imgsz=IMGSZ, seed=0)
    shutil.copytree(root / "synthetic", root / "mixed", ignore=shutil.ignore_patterns("*.cache.npy"))
    for split in ("train", "val"):
        for i, f in enumerate(sorted((root / "mixed" / "images" / split).glob("*.bmp"))):
            h, w = SIZES[i % len(SIZES)]
            image_io.imwrite(f, TA.resize_linear(image_io.imread(f, "cpu"), (w, h)))
    return root, yaml


def test_synthetic_pose_labels_match_jax(pose_data, tmp_path):
    """The same draws as the JAX generator: label files and data.yaml
    (``kpt_shape: [5, 3]``) equal; each image shows its rings and dots."""
    root, yaml = pose_data
    j_make(tmp_path / "j", "pose", n_train=6, n_val=4, imgsz=IMGSZ, seed=0)
    for split in ("train", "val"):
        files = sorted((root / "synthetic" / "labels" / split).glob("*.txt"))
        assert len(files) == (6 if split == "train" else 4)
        for f in files:
            assert f.read_text() == (tmp_path / "j" / "labels" / split / f.name).read_text()
    assert [ln for ln in yaml.read_text().splitlines() if not ln.startswith("path")] == \
        [ln for ln in (tmp_path / "j" / "data.yaml").read_text().splitlines() if not ln.startswith("path")]
    img = image_io.imread(root / "synthetic" / "images" / "train" / "00000.bmp", "cpu")
    assert (img == 255).all(-1).sum() >= 29  # at least one object's five dots


@pytest.mark.parametrize("flip_idx", [None, FLIP_IDX], ids=["no flip_idx", "flip_idx"])
@pytest.mark.parametrize("name", list(SAMPLE_HYPS))
def test_pose_samples_match_jax(pose_data, name, flip_idx):
    """``get_sample`` for 4 seeds and every image of the mixed set, task pose:
    boxes, classes and the label mask identical to the JAX package's, the
    keypoints within 1e-5 px (through mosaic, warp, flips with or without
    ``flip_idx``, MixUp); some keypoints leave the canvas and turn invisible."""
    root, _ = pose_data
    ov = {"imgsz": IMGSZ, "task": "pose", "fliplr": 0.5, **SAMPLE_HYPS[name]}
    path = root / "mixed" / "images" / "train"
    tds = TDataset(path, imgsz=IMGSZ, augment=True, hyp=t_cfg(ov), task="pose", device="cpu", kpt_shape=(5, 3),
                   flip_idx=flip_idx)
    jds = JDataset(path, imgsz=IMGSZ, augment=True, hyp=j_cfg(overrides=ov), task="pose", kpt_shape=(5, 3),
                   flip_idx=flip_idx)
    invisible = 0
    for seed in range(4):
        for i in range(len(tds)):
            t, j = tds.get_sample(i, np.random.default_rng(seed)), jds.get_sample(i, np.random.default_rng(seed))
            assert sorted(t) == sorted(j) == ["bboxes", "cls", "img", "keypoints", "mask"]
            for k in ("bboxes", "cls", "mask"):
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"seed {seed} image {i} {k}")
            assert t["keypoints"].shape == (128, 5, 3)
            np.testing.assert_allclose(t["keypoints"][..., :2] * IMGSZ, j["keypoints"][..., :2] * IMGSZ, atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(t["keypoints"][..., 2], j["keypoints"][..., 2])
            invisible += int(((t["keypoints"][..., 2] == 0) & t["mask"][:, None]).sum())
    assert invisible > 0 or name == "letterbox"


def test_pose_val_samples_and_loader_match_jax(pose_data):
    """Letterboxed val samples (labels, keypoints, ``ori_shape``,
    ``ratio_pad``) equal; the loader stacks ``keypoints`` (B, 128, 5, 3)."""
    from experiment_yolo_torch.data import DataLoader as TLoader

    root, _ = pose_data
    path = root / "mixed" / "images" / "val"
    tds = TDataset(path, imgsz=IMGSZ, augment=False, task="pose", device="cpu", kpt_shape=(5, 3))
    jds = JDataset(path, imgsz=IMGSZ, augment=False, task="pose", kpt_shape=(5, 3))
    for i in range(len(tds)):
        t, j = tds.get_val_sample(i), jds.get_val_sample(i)
        assert sorted(t) == sorted(j)
        for k in t:
            if k != "img":
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"{i} {k}")
    batch = next(iter(TLoader(tds, 2, shuffle=False, workers=1)))
    assert batch["keypoints"].shape == (2, 128, 5, 3) and batch["keypoints"].dtype == np.float32


# -- validator, predictor, results, server, checkpoint, the head rebuild ----------------------------------------

class _StubModel:
    """What the JAX validator asks of a model: strides, ``kpt_shape``, and
    ``predict`` handing back fixed outputs (the port model's on the same batch)."""

    def __init__(self, outs, strides, kpt_shape):
        self.outs, self.strides, self.kpt_shape = outs, strides, kpt_shape

    def predict(self, variables, imgs):
        return self.outs


@pytest.fixture(scope="module")
def confident_pose_model():
    """The port's pose model at 5 x 3, nc 1, with boxes of about 20 px and
    class logits around 0 (a seeded model's priors keep every score under
    the val conf)."""
    tm = TPoseModel(_pose_cfg((5, 3)), device="cpu")
    with torch.no_grad():
        sized_boxes_(tm, 20.0)
        for cls in tm.detect.cv3:
            cls[-1].bias.zero_()
    tm.eval()
    return tm


def test_pose_validator_matches_jax(pose_data, confident_pose_model):
    """``PoseValidator`` on the pose dataset's mixed-size val split: its stats
    (box and pose families, fitness) equal to the JAX validator's run on the
    port model's outputs for the same batch (multi-label hard NMS through
    K2's plain version against JAX's loop, keypoints back through each
    image's gain and pad, OKS with 0.53 of the original box's area)."""
    root, yaml = pose_data
    tm = confident_pose_model
    mixed = yaml.parent.parent / "mixed" / "data.yaml"
    mixed.write_text(yaml.read_text().replace(str(yaml.parent), str(mixed.parent)))
    ov = {"data": str(mixed), "imgsz": IMGSZ, "batch": 4, "workers": 1, "verbose": False}
    got = PoseValidator(ov)(tm)
    jds = JDataset(root / "mixed" / "images" / "val", imgsz=IMGSZ, augment=False, task="pose", kpt_shape=(5, 3))
    batch = next(iter(JLoader(jds, 4, shuffle=False, workers=1, drop_last=False)))
    x = torch.from_numpy(batch["img"]).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        outs = tuple(jnp.asarray(t.numpy()) for t in tm.predict(x))
    want = JValidator({"data": str(mixed), "imgsz": IMGSZ, "batch": 4, "workers": 1, "verbose": False})(
        _StubModel(outs, tm.stride, (5, 3)), None)
    assert sorted(got) == sorted(want)
    assert got["box_mAP50"] > 0 and got["pose_recall"] >= 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_predictor_keypoints_results_and_server_match_jax(confident_pose_model, tmp_path):
    """``DetectionPredictor`` on a pose model: one (nk, 3) keypoint set a
    detection, the kept anchors' decoded keypoints taken back through each
    image's gain and pad and clipped to it, the class filter applied to them;
    ``Results.keypoints`` (``xy``, ``conf``), ``to_dict``, ``tojson`` and the
    server's JSON equal to JAX's ``Results`` and ``serialize_results`` on the
    same arrays; a pose checkpoint's round trip rebuilds a 5 x 3
    ``PoseModel`` with the same keypoints."""
    tm = confident_pose_model
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (50, 70, 3), np.uint8), rng.integers(0, 255, (90, 40, 3), np.uint8)]
    pred = DetectionPredictor(tm, {"imgsz": IMGSZ, "batch": 2, "conf": 0.3, "max_det": 20, "nms_type": "hard"})
    res = pred(imgs)
    x = torch.from_numpy(np.stack([TA.letterbox(im, IMGSZ)[0][..., ::-1] for im in imgs]).copy())
    det, counts, kpts = pred.infer(x)
    for i, (r, im) in enumerate(zip(res, imgs)):
        n = int(counts[i])
        assert n > 0 and r.keypoints.data.shape == (n, 5, 3)
        _, gain, (padw, padh) = TA.letterbox(im, IMGSZ)
        want = kpts[i, :n].numpy().copy()
        want[..., 0] = ((want[..., 0] - padw) / gain).clip(0, im.shape[1])
        want[..., 1] = ((want[..., 1] - padh) / gain).clip(0, im.shape[0])
        np.testing.assert_array_equal(r.keypoints.data, want)
        j = JResults(im, r.path, r.names, r.boxes.data, keypoints=r.keypoints.data)
        np.testing.assert_array_equal(r.keypoints.xy, j.keypoints.xy)
        np.testing.assert_array_equal(r.keypoints.conf, j.keypoints.conf)
        assert r.to_dict() == j.to_dict() and r.tojson(normalize=True) == j.tojson(normalize=True)
        assert serialize_results(r) == j_serialize(j) and "keypoints" in serialize_results(r)["detections"][0]
    two = TResults(imgs[0], "a", {0: "blob"}, res[0].boxes.data, keypoints=res[0].keypoints.data[..., :2])
    assert two.keypoints.conf is None and serialize_results(two) == j_serialize(
        JResults(imgs[0], "a", {0: "blob"}, res[0].boxes.data, keypoints=res[0].keypoints.data[..., :2]))
    filt = DetectionPredictor(tm, {"imgsz": IMGSZ, "batch": 2, "conf": 0.3, "max_det": 20, "nms_type": "hard",
                                   "classes": [1]})(imgs)
    assert all(r.keypoints.data.shape == (0, 5, 3) for r in filt)
    ckpt = save_checkpoint(tmp_path / "pose.pt", tm)
    back = load_checkpoint(ckpt, "cpu")
    assert type(back) is TPoseModel and back.kpt_shape == (5, 3)
    assert torch.load(ckpt, weights_only=True)["task"] == "pose"
    res2 = DetectionPredictor(back, {"imgsz": IMGSZ, "batch": 2, "conf": 0.3, "max_det": 20, "nms_type": "hard"})(imgs)
    for r, r2 in zip(res, res2):
        np.testing.assert_array_equal(r.keypoints.data, r2.keypoints.data)


def test_head_rebuilt_to_the_datasets_kpt_shape(pose_data):
    """A 17 x 3 model trained on the 5 x 3 dataset: the trainer rebuilds it
    at 5 x 3 with every weight drawn from ``seed``, as a fresh ``PoseModel``
    of that shape draws them; ``YOLO(...).train()`` takes the rebuilt model
    up, its losses carry pose and kobj, and its ``last.pt`` reloads as a 5 x
    3 ``PoseModel`` equal to the facade's."""
    root, yaml = pose_data
    trainer = DetectionTrainer(TPoseModel(_pose_cfg((17, 3)), device="cpu"), {"seed": 3, "amp": False})
    trainer._rebuild_pose_head((5, 3))
    fresh = TPoseModel(_pose_cfg((5, 3)), device="cpu", generator=torch.Generator().manual_seed(3))
    assert trainer.rebuilt_model and trainer.model.kpt_shape == (5, 3)
    assert all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(), fresh.state_dict().values()))
    yolo = YOLO("yolov8n-pose.yaml", device="cpu")
    metrics = yolo.train(data=str(yaml), epochs=1, batch=6, imgsz=IMGSZ, workers=1, amp=False,
                         project=str(root / "runs"), optimizer="SGD")
    assert yolo.model.kpt_shape == (5, 3) and yolo.model is yolo.trainer.model
    assert set(yolo.trainer.loss_items) == {"box", "cls", "dfl", "kobj", "pose"} and "pose_mAP50" in metrics
    back = YOLO(str(yolo.trainer.save_dir / "weights" / "last.pt"), device="cpu").model
    assert type(back) is TPoseModel and back.kpt_shape == (5, 3)
    ema = yolo.trainer.state.ema.ema.state_dict()
    assert all(torch.equal(v, ema[k]) for k, v in back.state_dict().items())
