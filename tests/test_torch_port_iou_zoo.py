"""The IoU zoo of the box loss in the port against the JAX package: every
``bbox_iou`` variant plain, with Inner-IoU and with Focaler-IoU, on xyxy and
xywh boxes, and every Wise-IoU ``ltype`` under each focusing mode and base
term, values and gradients with respect to the predictions.

The box pairs are ``tests/test_torch_port_wiou.py``'s: overlapping,
disjoint, nested and equal boxes, some sharing an edge, so that ``min``,
``max``, ``clip`` and ``abs`` meet ties and zeros. Where JAX gives NaN (a
square root of 0 in SIoU's gradient, a negative focusing ``beta`` under v2
when an Inner-IoU rounds above 1) the port must give NaN at the same
elements; every other element is held to the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.boxes import IOU_TYPES, WIOU_LTYPES
from experiment_yolo_torch.ops.boxes import bbox_iou as t_bbox_iou
from experiment_yolo_torch.ops.boxes import wise_iou_loss as t_wiou
from experiment_yolo_tpu.ops.boxes import bbox_iou as j_bbox_iou
from experiment_yolo_tpu.ops.boxes import wise_iou_loss as j_wiou
from experiment_yolo_tpu.ops.boxes import xyxy2xywh as j_xyxy2xywh
from test_torch_port_wiou import _box_pairs

BASES = {"plain": {}, "inner": {"inner": True}, "focaler": {"focaler": True}}
HW = 400.0  # MPDIoU's normaliser, the image diagonal squared in grid units of a 16 x 12 map


def _close(got, want, rtol):
    """Equal NaN positions; elsewhere within ``rtol`` of the largest |value|."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], atol=rtol * np.abs(want[~nan]).max(), rtol=0)


@pytest.mark.parametrize("xywh", [False, True], ids=["xyxy", "xywh"])
@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("iou_type", IOU_TYPES)
def test_bbox_iou_variant_matches_jax(iou_type, base, xywh):
    """Values within 1e-5 of the largest |value|, the gradient with respect
    to the predictions within 1e-4 of its largest |value|."""
    pred, target = _box_pairs(0)
    if xywh:
        pred, target = np.array(j_xyxy2xywh(pred)), np.array(j_xyxy2xywh(target))
    kw = {**BASES[base], **({} if iou_type == "IoU" else {iou_type: True})}
    if iou_type == "MPDIoU":
        kw["mpdiou_hw"] = HW
    want, vjp = jax.vjp(lambda p: j_bbox_iou(p, jnp.asarray(target), xywh=xywh, **kw), jnp.asarray(pred))
    g = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(g))
    p = torch.tensor(pred, requires_grad=True)
    got = t_bbox_iou(p, torch.from_numpy(target), xywh=xywh, **kw)
    got.backward(torch.from_numpy(g))
    assert got.shape == want.shape
    _close(got.detach().numpy(), want, 1e-5)
    _close(p.grad.numpy(), jgrad, 1e-4)


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("monotonous", [None, True, False], ids=["plain", "v2", "v3"])
@pytest.mark.parametrize("ltype", WIOU_LTYPES)
def test_wise_iou_ltype_matches_jax(ltype, monotonous, base):
    """The loss within 1e-5 of the largest |value|, the new running mean
    within 1e-5 of JAX's, the gradient with respect to the predictions
    within 1e-4 of its largest |value| (``l2_box``, CIoU's ``alpha`` and
    ``beta`` out of it in both)."""
    pred, target = _box_pairs(1)
    kw = dict(ltype=ltype, monotonous=monotonous, **BASES[base])
    if ltype == "MPDIoU":
        kw["mpdiou_hw"] = HW
    (want, jmean), vjp = jax.vjp(lambda p: j_wiou(p, jnp.asarray(target), jnp.float32(0.6), **kw), jnp.asarray(pred))
    g = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    (jgrad,) = vjp((jnp.asarray(g), jnp.zeros((), jnp.float32)))
    p = torch.tensor(pred, requires_grad=True)
    got, mean = t_wiou(p, torch.from_numpy(target), torch.tensor(0.6), **kw)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want, 1e-5)
    np.testing.assert_allclose(mean.item(), float(jmean), rtol=1e-5)
    _close(p.grad.numpy(), jgrad, 1e-4)
