"""Bootstrap significance testing for the comparison of two models.

The port's own copy of ``experiment_yolo_tpu/utils/stats.py`` (the fork's
``testandcox.py`` protocol): bootstrap subsamples of the test set, a metric
of each model on each subsample, then Shapiro-Wilk normality, the paired
t-test, the Wilcoxon signed-rank test, confidence intervals and Cohen's d.
numpy and scipy only, with the same generator (``np.random.default_rng``) and
the same draws in the same order, so the same inputs give the same indices
and the same statistics as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import scipy.stats


@dataclass
class ComparisonResult:
    scores_a: np.ndarray
    scores_b: np.ndarray
    shapiro_p_a: float
    shapiro_p_b: float
    t_stat: float
    t_p: float
    wilcoxon_stat: float
    wilcoxon_p: float
    cohens_d: float
    mean_diff: float
    ci_t: tuple
    ci_bootstrap: tuple

    def summary(self) -> str:
        sig = "SIGNIFICANT" if self.t_p < 0.05 else "not significant"
        return (f"mean diff {self.mean_diff:+.4f} ({sig}, paired t p={self.t_p:.4f}, "
                f"wilcoxon p={self.wilcoxon_p:.4f}, d={self.cohens_d:.3f}, "
                f"95% CI t=[{self.ci_t[0]:.4f}, {self.ci_t[1]:.4f}] "
                f"bootstrap=[{self.ci_bootstrap[0]:.4f}, {self.ci_bootstrap[1]:.4f}])")


def bootstrap_indices(n: int, n_bootstrap: int = 30, fraction: float = 0.5, seed: int = 0) -> List[np.ndarray]:
    """``n_bootstrap`` subsamples of ``fraction * n`` indices drawn with replacement."""
    rng = np.random.default_rng(seed)
    k = max(1, int(n * fraction))
    return [rng.integers(0, n, k) for _ in range(n_bootstrap)]


def compare_models(eval_fn_a: Callable[[np.ndarray], float], eval_fn_b: Callable[[np.ndarray], float], n_images: int,
                   n_bootstrap: int = 30, fraction: float = 0.5, seed: int = 0) -> ComparisonResult:
    """Paired bootstrap comparison of two models: ``eval_fn_*`` map a
    subsample's index array to a scalar metric (mAP50, say), both on the same
    subsamples."""
    idxs = bootstrap_indices(n_images, n_bootstrap, fraction, seed)
    a = np.asarray([eval_fn_a(i) for i in idxs])
    b = np.asarray([eval_fn_b(i) for i in idxs])
    return compare_scores(a, b)


def compare_scores(a: np.ndarray, b: np.ndarray, seed: int = 0) -> ComparisonResult:
    """The statistics of two paired score vectors (``testandcox.py:253-307``);
    all-zero differences give a Wilcoxon statistic of 0 and p 1."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    diff = a - b
    n = len(diff)
    sh_a = scipy.stats.shapiro(a).pvalue if n >= 3 else float("nan")
    sh_b = scipy.stats.shapiro(b).pvalue if n >= 3 else float("nan")
    t_stat, t_p = scipy.stats.ttest_rel(a, b)
    try:
        w_stat, w_p = scipy.stats.wilcoxon(a, b)
    except ValueError:  # all-zero differences
        w_stat, w_p = 0.0, 1.0
    sd = diff.std(ddof=1)
    d = diff.mean() / sd if sd > 0 else 0.0
    se = scipy.stats.sem(diff)
    ci_t = scipy.stats.t.interval(0.95, n - 1, loc=diff.mean(), scale=se) if se > 0 else (diff.mean(), diff.mean())
    rng = np.random.default_rng(seed)
    boots = [rng.choice(diff, n, replace=True).mean() for _ in range(2000)]
    ci_b = (float(np.percentile(boots, 2.5)), float(np.percentile(boots, 97.5)))
    return ComparisonResult(scores_a=a, scores_b=b, shapiro_p_a=float(sh_a), shapiro_p_b=float(sh_b),
                            t_stat=float(t_stat), t_p=float(t_p), wilcoxon_stat=float(w_stat), wilcoxon_p=float(w_p),
                            cohens_d=float(d), mean_diff=float(diff.mean()), ci_t=(float(ci_t[0]), float(ci_t[1])),
                            ci_bootstrap=ci_b)
