"""The fork's headline experiment on the card: DEAL-YOLO against the baseline.

Port of ``scripts/run_experiment.py``: several seeds of each DEAL
configuration, trained with the paper's box loss (Wise-IoU v3 focusing with
the NWD blend), against vanilla yolov8n on the shared synthetic dataset, then
the reference's bootstrap protocol (``testandcox.py:253-307``): 30 subsamples
of half the val set, each model's mAP50 on each (``compare_models.py``),
and Shapiro, paired t, Wilcoxon, the t and bootstrap intervals and Cohen's d
(``utils/stats.py``) for each DEAL run against the baseline of its seed.

Usage (the card by default; ``device=cpu`` for the CPU)::

    python -m experiment_yolo_torch.run_experiment [seeds=0,1,2] [epochs=40] [imgsz=320] [batch=16]
        [n_train=128] [n_val=256] [root=runs/experiment] [deal=yolov8-LD-P2.yaml,yolov8-ASF-P2P2.yaml]
        [base=yolov8n.yaml] [device=cuda]

A relative ``root`` is taken from the repository's root. A run is keyed by
its configuration and seed, and one whose ``weights/best.pt`` exists is
reused, so an interrupted sweep resumes where it stopped. The report goes to
``<root>/EXPERIMENTS.md`` beside ``<root>/results.json`` (the JAX script
writes its report to the repository's own ``EXPERIMENTS.md``).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import List

import numpy as np

from experiment_yolo_torch.cfg.cli import parse_key_value
from experiment_yolo_torch.compare_models import map50_of_subset, per_image_stats
from experiment_yolo_torch.data.dataset import YOLODataset
from experiment_yolo_torch.data.synthetic import make_synthetic_dataset
from experiment_yolo_torch.engine.model import YOLO
from experiment_yolo_torch.utils import LOGGER
from experiment_yolo_torch.utils.stats import bootstrap_indices, compare_scores

REPO = Path(__file__).resolve().parents[1]
# the DEAL paper's box loss: Wise-IoU v3 focusing blended with NWD (train keys of default.yaml)
DEAL_LOSS = {"use_wiseiou": True, "wiou_ltype": "WIoU", "nwd": True, "iou_ratio": 0.5}


def train_one(cfg: str, seed: int, data_yaml: Path, root: Path, epochs: int, imgsz: int, batch: int,
              deal_loss: bool, device="cuda") -> Path:
    """Train ``cfg`` with ``seed`` (the weights' draw and the loop's) under
    ``root/train/<cfg stem>_s<seed>``, or reuse that run when its
    ``weights/best.pt`` exists; returns that checkpoint's path."""
    name = f"{Path(cfg).stem}_s{seed}"
    ckpt = root / "train" / name / "weights" / "best.pt"
    if ckpt.exists():
        LOGGER.info(f"experiment: reusing finished run {name}")
        return ckpt
    t0 = time.time()
    m = YOLO(cfg, nc=3, seed=seed, device=device)  # the synthetic dataset's 3 classes
    m.train(data=str(data_yaml), epochs=epochs, imgsz=imgsz, batch=batch, seed=seed, optimizer="SGD", lr0=0.01,
            val=True, save=True, project=str(root / "train"), name=name, exist_ok=True, plots=False,
            **(DEAL_LOSS if deal_loss else {}))
    LOGGER.info(f"experiment: trained {name} in {time.time() - t0:.0f}s")
    return ckpt


def full_val(ckpt: Path, data_yaml: Path, imgsz: int, device="cuda") -> dict:
    """The validator's stats of a checkpoint on the dataset's val split."""
    r = YOLO(str(ckpt), device=device).val(data=str(data_yaml), imgsz=imgsz, batch=8, plots=False, verbose=False)
    return {k: float(v) for k, v in r.items() if isinstance(v, (int, float))}


def main(argv: List[str]) -> dict:
    """Run the grid and the protocol; returns ``results.json``'s content."""
    t_start = time.time()
    kv = parse_key_value(argv)
    raw_seeds = kv.get("seeds", "0,1,2")
    seeds = [int(s) for s in raw_seeds] if isinstance(raw_seeds, (list, tuple)) else \
        [int(s) for s in str(raw_seeds).split(",")]
    epochs = int(kv.get("epochs", 40))
    imgsz = int(kv.get("imgsz", 320))
    batch = int(kv.get("batch", 16))
    n_train = int(kv.get("n_train", 128))
    n_val = int(kv.get("n_val", 256))
    device = str(kv.get("device", "cuda"))
    root = Path(str(kv.get("root", "runs/experiment")))
    if not root.is_absolute():
        root = REPO / root
    deal_cfgs = str(kv.get("deal", "yolov8-LD-P2.yaml,yolov8-ASF-P2P2.yaml")).split(",")
    base_cfg = str(kv.get("base", "yolov8n.yaml"))
    root.mkdir(parents=True, exist_ok=True)

    data_yaml = make_synthetic_dataset(root / "dataset", n_train=n_train, n_val=n_val, imgsz=imgsz, seed=11)
    ds = YOLODataset(data_yaml.parent / "images" / "val", imgsz=imgsz, augment=False, device=device)

    # the grid: the baseline and each DEAL configuration, every seed
    runs: dict = {}
    for cfg in [base_cfg] + deal_cfgs:
        for seed in seeds:
            ck = train_one(cfg, seed, data_yaml, root, epochs, imgsz, batch, cfg != base_cfg, device)
            runs[(cfg, seed)] = {"ckpt": ck, "val": full_val(ck, data_yaml, imgsz, device)}
            LOGGER.info(f"experiment: {Path(cfg).stem} s{seed} -> {runs[(cfg, seed)]['val']}")

    # the testandcox protocol: a paired bootstrap for each (DEAL configuration, seed)
    idxs = bootstrap_indices(len(ds), n_bootstrap=30, fraction=0.5, seed=42)

    def boot_scores(ckpt):
        stats = per_image_stats(YOLO(str(ckpt), device=device), ds, imgsz)
        return np.asarray([map50_of_subset(stats, i) for i in idxs])

    base_boot = {s: boot_scores(runs[(base_cfg, s)]["ckpt"]) for s in seeds}
    comparisons = []
    for cfg in deal_cfgs:
        for s in seeds:
            r = compare_scores(boot_scores(runs[(cfg, s)]["ckpt"]), base_boot[s])
            comparisons.append((cfg, s, r))
            LOGGER.info(f"experiment: {Path(cfg).stem} vs base (seed {s}): {r.summary()}")

    def val_row(cfg, s):
        v = runs[(cfg, s)]["val"]
        return (f"| {Path(cfg).stem} | {s} | {v['precision']:.4f} | {v['recall']:.4f} "
                f"| {v['mAP50']:.4f} | {v['mAP50-95']:.4f} |")

    def cmp_row(cfg, s, r):
        sig = "yes" if min(r.t_p, r.wilcoxon_p) < 0.05 else "no"
        return (f"| {Path(cfg).stem} | {s} | {r.scores_a.mean():.4f} | {r.scores_b.mean():.4f} "
                f"| {r.mean_diff:+.4f} | {r.t_p:.2e} | {r.wilcoxon_p:.2e} | {r.cohens_d:.2f} "
                f"| [{r.ci_bootstrap[0]:+.4f}, {r.ci_bootstrap[1]:+.4f}] | {sig} |")

    mean_by_cfg = {cfg: np.mean([runs[(cfg, s)]["val"]["mAP50"] for s in seeds]) for cfg in [base_cfg] + deal_cfgs}
    where = root.relative_to(REPO) if root.is_relative_to(REPO) else root
    report = f"""# DEAL-YOLO vs baseline — the fork's experiment, end to end on {device}

The experiment the reference fork exists to run (`testandcox.py`: DEAL
weights vs vanilla yolov8n, bootstrap mAP50 significance), run with
`experiment_yolo_torch`: every model trained here ({epochs} epochs, {imgsz}px,
batch {batch}, SGD) on the shared synthetic dataset ({n_train} train /
{n_val} val images, seed 11), the DEAL configurations with the paper's
Wise-IoU + NWD box loss ({DEAL_LOSS}), then the reference's statistical
protocol (`testandcox.py:253-307` through `utils/stats.py`): 30 bootstrap
subsamples of 50% of val, per-subsample mAP50 pairs, Shapiro + paired t +
Wilcoxon + Cohen's d + bootstrap CI.

## Per-seed full-val metrics

| model | seed | P | R | mAP50 | mAP50-95 |
|---|---|---|---|---|---|
""" + "\n".join(val_row(cfg, s) for cfg in [base_cfg] + deal_cfgs for s in seeds) + """

Seed-mean mAP50: """ + ", ".join(f"{Path(c).stem} {m:.4f}" for c, m in mean_by_cfg.items()) + """.

## Paired bootstrap significance (DEAL − baseline, same seed)

30 subsamples × 50% of val; each row pairs the DEAL model's per-subsample
mAP50 with the baseline's on the same subsamples.

| deal model | seed | deal mAP50 | base mAP50 | mean diff | t p | wilcoxon p | Cohen's d | 95% boot CI | significant |
|---|---|---|---|---|---|---|---|---|---|
""" + "\n".join(cmp_row(cfg, s, r) for cfg, s, r in comparisons) + f"""

Reproduce: `python -m experiment_yolo_torch.run_experiment seeds={",".join(map(str, seeds))} epochs={epochs} imgsz={imgsz}`.
Checkpoints under `{where}/train/`.
"""
    (root / "EXPERIMENTS.md").write_text(report)
    results = {f"{Path(cfg).stem}_s{s}": runs[(cfg, s)]["val"] for cfg in [base_cfg] + deal_cfgs for s in seeds}
    (root / "results.json").write_text(json.dumps(results, indent=1))
    LOGGER.info(f"experiment: wrote {root / 'EXPERIMENTS.md'} and {root / 'results.json'} "
                f"in {time.time() - t_start:.1f} s")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
