"""Kernel K5's plain version (Gaussian soft-NMS) against the JAX package's
``ops/nms.py:_soft_nms_keep`` on made-up candidate pools, with and without
the fork's quirk, and the wrapper on the CPU.

The pools come from ``utils/seeded.py:soft_nms_cases``, the ones
``chip_smoke.py`` holds the kernel to on the card: K = 1, a ragged K = 1,000,
K = 4,096 and K = 8,192, duplicates with equal scores, IoUs exactly at the
threshold, a score that the decay puts exactly on the 0.25 floor, an image
with no valid candidate, the quirk's first box in the last slot, a pool like
a trained detector's (5% above the floor), pairs one float32 spacing from
the threshold, and a pool in which every box overlaps every other.

Two shortcuts of the kernel rest on arguments checked here on the plain
version and in float64: it drops the candidates at or below the 0.25 floor
at load, and it skips the IoU's division where an exact fma shows the
quotient cannot exceed the threshold.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms, soft_nms_plain
from experiment_yolo_torch.utils.seeded import iou_parts, soft_nms_cases, threshold_pairs
from experiment_yolo_tpu.ops.nms import _soft_nms_keep

MAX_DET = 300
CASES = soft_nms_cases(7)


@partial(jax.jit, static_argnums=(3, 4))
def _jax_keep(shifted, scores, valid, thr, max_det):
    return _soft_nms_keep(shifted, scores, valid, thr, 0.5, 0.25, max_det)


@partial(jax.jit, static_argnums=(3, 4))
def _jax_keep_quirk(shifted, scores, valid, thr, max_det, first_idx, n_valid):
    return _soft_nms_keep(shifted, scores, valid, thr, 0.5, 0.25, max_det, first_idx=first_idx, n_valid=n_valid)


@pytest.mark.parametrize("quirk", [False, True], ids=["plain", "quirk"])
@pytest.mark.parametrize("label", list(CASES))
def test_soft_nms_plain_matches_jax(label, quirk):
    """Identical kept sets, kept scores within 1e-6 relative, image by image."""
    boxes, scores, valid, thr, first_idx, n_valid = CASES[label]
    kw = {"first_idx": first_idx, "n_valid": n_valid} if quirk else {}
    got = soft_nms_plain(boxes, scores, valid, thr, MAX_DET, **kw).numpy()
    for i in range(len(boxes)):
        args = (jnp.asarray(boxes[i].numpy()), jnp.asarray(scores[i].numpy()), jnp.asarray(valid[i].numpy()), thr,
                MAX_DET)
        want = np.asarray(_jax_keep_quirk(*args, jnp.int32(first_idx[i]), jnp.int32(n_valid[i])) if quirk
                          else _jax_keep(*args))
        np.testing.assert_array_equal(got[i] > -1, want > -1, err_msg=f"{label} image {i}: kept sets differ")
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=0, err_msg=f"{label} image {i}")
    kept = got > -1
    if label == "an image with none valid":
        assert kept[0].any() and not kept[1].any()
    elif label != "K=1":
        assert kept.any() and not kept.all()


def test_ties_at_the_threshold_and_the_floor_decide_alike():
    """The pairs at IoU exactly 0.7 keep both scores undecayed (IoU above the
    threshold decays, equal does not); the score the decay puts on 0.25 is
    not kept (a step keeps while the best score is above 0.25)."""
    boxes, scores, valid, thr, _, _ = CASES["IoU at the threshold"]
    out = soft_nms_plain(boxes, scores, valid, thr, MAX_DET)[0]
    inner = boxes[0, :, 2] - boxes[0, :, 0]  # 10 for the first of a pair, 7, 8 or 6 for the second
    seven = inner == 7
    kept7 = out[seven] > -1
    assert kept7.any() and torch.equal(out[seven][kept7], scores[0][seven][kept7])
    boxes, scores, valid, thr, _, _ = CASES["decay onto 0.25"]
    out = soft_nms_plain(boxes, scores, valid, thr, MAX_DET)[0]
    assert out[0] == scores[0, 0] and out[1] == -1 and (out[2:5] == scores[0, 2:5]).all() and out[5] == -1


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_the_quirk_pair():
    boxes, scores, valid, thr, first_idx, n_valid = CASES["duplicates"]
    before = soft_nms.launches
    for kw in ({}, {"first_idx": first_idx, "n_valid": n_valid}):
        assert torch.equal(soft_nms(boxes, scores, valid, thr, MAX_DET, **kw),
                           soft_nms_plain(boxes, scores, valid, thr, MAX_DET, **kw))
    assert soft_nms.launches == before
    with pytest.raises(ValueError, match="first_idx and n_valid"):
        soft_nms(boxes, scores, valid, thr, MAX_DET, first_idx=first_idx)


def _jax_out(boxes, scores, valid, thr, first_idx, n_valid, quirk):
    out = []
    for i in range(len(boxes)):
        args = (jnp.asarray(boxes[i].numpy()), jnp.asarray(scores[i].numpy()), jnp.asarray(valid[i].numpy()), thr,
                MAX_DET)
        out.append(np.asarray(_jax_keep_quirk(*args, jnp.int32(first_idx[i]), jnp.int32(n_valid[i])) if quirk
                              else _jax_keep(*args)))
    return np.stack(out)


@pytest.mark.parametrize("quirk", [False, True], ids=["plain", "quirk"])
@pytest.mark.parametrize("label", list(CASES))
def test_candidates_at_or_below_the_floor_change_nothing(label, quirk):
    """The kernel drops every candidate at or below 0.25 at load (the quirk's
    first pick is read from the whole pool): making them invalid, all but the
    quirk's first candidate, with first_idx and n_valid as given, leaves the
    output identical, in the plain version and in the JAX function."""
    boxes, scores, valid, thr, first_idx, n_valid = CASES[label]
    kw = {"first_idx": first_idx, "n_valid": n_valid} if quirk else {}
    above = valid & (scores > 0.25)
    if quirk:
        rows = torch.arange(len(boxes))
        above[rows, first_idx] = valid[rows, first_idx]
    want = soft_nms_plain(boxes, scores, valid, thr, MAX_DET, **kw)
    assert torch.equal(soft_nms_plain(boxes, scores, above, thr, MAX_DET, **kw), want)
    got = _jax_out(boxes, scores, above, thr, first_idx, n_valid, quirk)
    np.testing.assert_array_equal(got > -1, want.numpy() > -1, err_msg=f"{label}: kept sets differ")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=0, err_msg=label)


def _near_threshold(rng, n, thr):
    """Nested xyxy box pairs (n, 2, 4) float32 whose IoU lies within a few
    float32 spacings of ``thr``, at offsets up to 1,000 px."""
    f32 = np.float32
    x0, y0 = (rng.integers(0, 10, (2, n)) * 100).astype(f32)
    big = rng.uniform(10, 60, (n, 2)).astype(f32)
    h = (big[:, 1] * rng.uniform(0.75, 1, n)).astype(f32)
    w = (f32(thr) * big[:, 0] * big[:, 1] / h).astype(f32)
    w = (w + rng.integers(-3, 4, n) * np.spacing(w)).astype(f32)
    a = np.stack([x0, y0, x0 + big[:, 0], y0 + big[:, 1]], -1)
    b = np.stack([x0, y0, x0 + w, y0 + h], -1)
    return np.stack([a, b], 1).astype(f32)


@pytest.mark.parametrize("thr", [0.7, 0.5, 0.45, 0.3])
def test_exact_pre_test_never_skips_a_decay(thr):
    """The kernel skips the division where fmaf(thr, u, -inter) >= 0: one
    rounding keeps the sign of thr * u - inter, which float64 holds exactly
    (the product of two float32 is exact there; the difference keeps its
    sign). No pair it skips has a rounded inter / u above thr, over random
    and near-threshold pairs; a pre-test rounded twice (no fma) would skip
    some that decay, unless thr is a power of two."""
    rng = np.random.default_rng(int(thr * 100))
    xy = rng.uniform(0, 100, (200_000, 2, 2)).astype(np.float32)
    random = np.concatenate([xy, xy + rng.uniform(0, 50, (200_000, 2, 2)).astype(np.float32)], -1)
    near = _near_threshold(rng, 200_000, thr)
    t = np.float32(thr)
    for kind, pairs in (("random", random), ("near the threshold", near)):
        inter, union, iou = (x.numpy() for x in iou_parts(torch.from_numpy(pairs[:, 0]),
                                                            torch.from_numpy(pairs[:, 1])))
        skipped = np.float64(t) * union.astype(np.float64) - inter.astype(np.float64) >= 0
        assert not (skipped & (iou > t)).any(), f"{kind}: the pre-test skips a pair whose IoU exceeds {thr}"
        assert skipped.any() and (~skipped).any()
    if np.frexp(t)[0] != 0.5:  # at a power of two thr * u is exact in float32: two roundings are one
        twice = (t * union).astype(np.float32) - inter >= 0
        assert (twice & (iou > t)).any(), "no near-threshold pair where a pre-test without the fma goes wrong"
    assert (iou > t).any() and (iou == t).any() and (iou < t).any()


def test_threshold_pairs_are_of_their_kinds():
    """The card case's three kinds, each checked in float64: one spacing
    above (decays; the two-rounding pre-test would skip it), one below, and
    exactly above yet rounded onto the threshold (no decay)."""
    pairs = threshold_pairs(0.7, 8, torch.Generator().manual_seed(3))
    inter, union, iou = iou_parts(pairs[:, 0], pairs[:, 1])
    t = torch.tensor(0.7, dtype=torch.float32)
    exact = t.double() * union.double() - inter.double()
    above, below, onto = (slice(8 * i, 8 * (i + 1)) for i in range(3))
    assert bool((iou[above] == torch.nextafter(t, torch.tensor(1.0))).all() and (exact[above] < 0).all())
    assert bool((t * union[above] - inter[above] >= 0).all())
    assert bool((iou[below] == torch.nextafter(t, torch.tensor(0.0))).all() and (exact[below] >= 0).all())
    assert bool((iou[onto] == t).all() and (exact[onto] < 0).all())
