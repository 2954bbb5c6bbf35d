"""Kernel K5's plain version (Gaussian soft-NMS) against the JAX package's
``ops/nms.py:_soft_nms_keep`` on made-up candidate pools, with and without
the fork's quirk, and the wrapper on the CPU.

The pools come from ``utils/seeded.py:soft_nms_cases``, the ones
``chip_smoke.py`` holds the kernel to on the card: K = 1, a ragged K = 1,000,
K = 4,096 and K = 8,192, duplicates with equal scores, IoUs exactly at the
threshold, a score that the decay puts exactly on the 0.25 floor, an image
with no valid candidate, and the quirk's first box in the last slot.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms, soft_nms_plain
from experiment_yolo_torch.utils.seeded import soft_nms_cases
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
