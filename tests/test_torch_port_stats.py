"""The fork's significance protocol in the PyTorch port against the JAX
package: ``utils/stats.py`` (``bootstrap_indices``, ``compare_scores`` with its
all-zero branch, ``ComparisonResult.summary``, ``compare_models``) bit for
bit; ``compare_models.py`` (``map50_of_subset`` on the same per-image stats,
``per_image_stats`` of a port model against the JAX script's function run on
that model's predictions and the JAX dataset); ``run_experiment.py`` (the
seed and ``DEAL_LOSS`` plumbing, the reuse of a finished run, and one run of
``main`` at 64 px on the CPU).
"""

import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from experiment_yolo_torch import YOLO
from experiment_yolo_torch import compare_models as t_cm
from experiment_yolo_torch import run_experiment as t_run
from experiment_yolo_torch.data import make_synthetic_dataset
from experiment_yolo_torch.data.dataset import YOLODataset as TDataset
from experiment_yolo_torch.utils import stats as t_stats
from experiment_yolo_torch.utils.seeded import sized_boxes_
from experiment_yolo_tpu.data.dataset import YOLODataset as JDataset
from experiment_yolo_tpu.utils import stats as j_stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import compare_models as j_cm  # noqa: E402
import run_experiment as j_run  # noqa: E402

IMGSZ = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,nb,frac,seed", [(256, 30, 0.5, 42), (7, 5, 0.3, 0), (1, 3, 0.5, 9)])
def test_bootstrap_indices_match_jax(n, nb, frac, seed):
    got, want = t_stats.bootstrap_indices(n, nb, frac, seed), j_stats.bootstrap_indices(n, nb, frac, seed)
    assert len(got) == len(want) == nb
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert len(g) == max(1, int(n * frac))


def _scores(case):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.2, 0.6, 30)
    return {"paired, shifted": (a, a - 0.01 + rng.normal(0, 0.005, 30)),
            "all-zero differences": (a, a.copy()),
            "independent": (a, rng.uniform(0.2, 0.6, 30))}[case]


@pytest.mark.parametrize("case", ["paired, shifted", "all-zero differences", "independent"])
def test_compare_scores_and_summary_match_jax(case):
    """Every field of ``ComparisonResult`` (scores, Shapiro, t, Wilcoxon,
    Cohen's d, mean, both intervals) and the summary line equal to JAX's,
    NaN where JAX gives NaN."""
    a, b = _scores(case)
    with warnings.catch_warnings():  # scipy warns of a zero range on the all-zero case, on both sides
        warnings.simplefilter("ignore")
        got, want = t_stats.compare_scores(a, b), j_stats.compare_scores(a, b)
    for field in want.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.summary() == want.summary()
    if case == "all-zero differences":
        assert got.mean_diff == 0.0 and got.cohens_d == 0.0 and got.ci_t == (0.0, 0.0)


def test_compare_models_matches_jax():
    """The callable form: the same subsamples go to both scorers."""
    score = np.random.default_rng(0).uniform(0, 1, 40)

    def fa(idx):
        return float(score[idx].mean())

    def fb(idx):
        return float(score[idx].mean() - 0.01 * np.cos(idx).mean())

    got, want = t_stats.compare_models(fa, fb, 40, 12, 0.5, 4), j_stats.compare_models(fa, fb, 40, 12, 0.5, 4)
    np.testing.assert_array_equal(got.scores_a, want.scores_a)
    np.testing.assert_array_equal(got.scores_b, want.scores_b)
    assert got.summary() == want.summary()


@pytest.fixture(scope="module")
def confident(tmp_path_factory):
    """A synthetic dataset (12 val images at 64 px) and the port's yolov8n
    with boxes of about 10 px and class logits around 0, so that it finds
    objects at conf 0.001 and some of them match."""
    root = tmp_path_factory.mktemp("stats")
    data = make_synthetic_dataset(root / "data", n_train=2, n_val=12, imgsz=IMGSZ, seed=11)
    yolo = YOLO("yolov8n.yaml", nc=3, device="cpu")
    with torch.no_grad():
        sized_boxes_(yolo.model, 10.0)
        for cls in yolo.model.detect.cv3:
            cls[-1].bias.zero_()
    return data, yolo


def test_per_image_stats_and_map50_of_subset_match_jax(confident):
    """``per_image_stats`` of the port model equal to the JAX script's
    function on the same model's predictions over the JAX dataset's items
    (the images through cv2, the labels through the JAX parser); then
    ``map50_of_subset`` equal to JAX's on the same stats, over the
    bootstrap subsamples of the protocol."""
    data, yolo = confident
    val = data.parent / "images" / "val"
    got = t_cm.per_image_stats(yolo, TDataset(val, imgsz=IMGSZ, augment=False, device="cpu"), IMGSZ)
    want = j_cm.per_image_stats(yolo, JDataset(val, imgsz=IMGSZ, augment=False), IMGSZ)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    assert sum(int(s[0][:, 0].sum()) for s in got) > 0  # some detections match at IoU 0.5
    for idx in t_stats.bootstrap_indices(len(got), 30, 0.5, seed=42):
        assert t_cm.map50_of_subset(got, idx) == j_cm.map50_of_subset(want, idx)


class _RecorderYOLO:
    """Stands in for YOLO: records the constructor's and train()'s keywords, never trains."""

    calls: list = []

    def __init__(self, cfg, **kw):
        self.cfg, self.ctor_kw = cfg, kw

    def train(self, **kw):
        _RecorderYOLO.calls.append((self.cfg, self.ctor_kw, kw))


def test_train_one_reuses_finished_run(tmp_path, monkeypatch):
    root = tmp_path / "exp"
    ckpt = root / "train" / "yolov8n_s3" / "weights" / "best.pt"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(b"")

    def _explode(*a, **k):
        raise AssertionError("a finished run must not train again")

    monkeypatch.setattr(t_run, "YOLO", _explode)
    assert t_run.train_one("yolov8n.yaml", 3, tmp_path / "data.yaml", root, 40, 320, 16, False) == ckpt


def test_train_one_passes_seed_and_deal_loss_as_jax(tmp_path, monkeypatch):
    """The seed reaches the weights' draw and the loop on every leg, the DEAL
    legs alone take the paper's loss (``DEAL_LOSS`` equal to JAX's), and the
    run names and every other keyword are the JAX script's."""
    calls = {}
    for mod, key in ((t_run, "port"), (j_run, "jax")):
        monkeypatch.setattr(mod, "YOLO", _RecorderYOLO)
        _RecorderYOLO.calls = []
        mod.train_one("yolov8-LD-P2.yaml", 7, tmp_path / "d.yaml", tmp_path / key, 40, 320, 16, True)
        mod.train_one("yolov8n.yaml", 7, tmp_path / "d.yaml", tmp_path / key, 40, 320, 16, False)
        calls[key] = list(_RecorderYOLO.calls)
    assert t_run.DEAL_LOSS == j_run.DEAL_LOSS
    (cfg_a, ctor_a, train_a), (cfg_b, ctor_b, train_b) = calls["port"]
    assert ctor_a["seed"] == train_a["seed"] == ctor_b["seed"] == train_b["seed"] == 7
    assert all(train_a[k] == v for k, v in t_run.DEAL_LOSS.items()) and "use_wiseiou" not in train_b
    assert (train_a["name"], train_b["name"]) == ("yolov8-LD-P2_s7", "yolov8n_s7")
    for (pc, pk, pt), (jc, jk, jt) in zip(calls["port"], calls["jax"]):
        assert pc == jc and pk == {**jk, "device": "cuda"}
        assert {k: v for k, v in pt.items() if k != "project"} == {k: v for k, v in jt.items() if k != "project"}


def test_run_experiment_main_writes_its_report_and_reuses_runs(tmp_path, monkeypatch):
    """``main`` at 64 px, one epoch, one seed, yolov8n against LD-P2 on the
    CPU: ``results.json`` and ``EXPERIMENTS.md`` under the run's root with a
    row for each model and the comparison; a second call trains nothing."""
    argv = ["seeds=0", "epochs=1", "imgsz=64", "batch=2", "n_train=2", "n_val=2", f"root={tmp_path / 'exp'}",
            "deal=yolov8-LD-P2.yaml", "device=cpu"]
    first = t_run.main(argv)
    root = tmp_path / "exp"
    assert json.loads((root / "results.json").read_text()) == first
    assert sorted(first) == ["yolov8-LD-P2_s0", "yolov8n_s0"]
    report = (root / "EXPERIMENTS.md").read_text()
    assert "| yolov8n | 0 |" in report and "| yolov8-LD-P2 | 0 |" in report and "Paired bootstrap" in report

    def _no_training(*a, **k):
        raise AssertionError("a finished run trained again")

    monkeypatch.setattr(YOLO, "train", _no_training)
    assert t_run.main(argv) == first
