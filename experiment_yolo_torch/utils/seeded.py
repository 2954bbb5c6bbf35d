"""Seeded inputs, labelled batches and weights for runs on the card without a
dataset or a checkpoint, offsets that stress the LDConv gather's backward, and
made-up candidate pools for soft-NMS: ``chip_smoke.py``, ``profile_predict``,
``profile_train``, ``kernel_variants`` and the tests. Test scaffolding, not a
dataset."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from experiment_yolo_torch.nn.modules import LDConv
from experiment_yolo_torch.ops.boxes import box_iou
from experiment_yolo_torch.ops.kernels.ldconv_gather import grid_points

# mixed (h, w) so that letterbox both resizes and pads
MIXED_SIZES: Tuple[Tuple[int, int], ...] = ((640, 640), (480, 640), (720, 1280), (375, 500), (1080, 810),
                                            (512, 512), (427, 640), (640, 427))


def seeded_images(n: int, seed: int) -> List[np.ndarray]:
    """``n`` uint8 BGR images, cycling through ``MIXED_SIZES``: 32-px blocks
    of colour plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = MIXED_SIZES[i % len(MIXED_SIZES)]
        base = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
        img = np.repeat(np.repeat(base, 32, 0), 32, 1)[:h, :w].astype(np.int16)
        out.append(np.clip(img + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


# one fill colour per class (BGR order does not matter: the step takes pixels as given)
CLASS_COLOURS = ((230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200), (245, 130, 48), (145, 30, 180),
                 (70, 240, 240), (240, 50, 230))


def seeded_batch(batch: int, imgsz: int, seed: int, nc: int = 6, max_boxes: int = 16) -> Dict[str, np.ndarray]:
    """A labelled batch in the training step's format: ``img`` (B, imgsz,
    imgsz, 3) uint8 of dark noise with 2 to ``max_boxes`` filled rectangles
    per image in their class's colour, 8 to 128 px on a side (at most half the
    image), so that the stride-4 level gets objects too; ``bboxes`` (B, M, 4)
    normalised xywh, ``cls`` (B, M) int32 and ``mask`` (B, M) bool, padded to
    M = ``max_boxes``."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 48, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    bboxes = np.zeros((batch, max_boxes, 4), np.float32)
    cls = np.zeros((batch, max_boxes), np.int32)
    mask = np.zeros((batch, max_boxes), bool)
    side = (8, max(9, min(128, imgsz // 2)))
    for i in range(batch):
        for j in range(int(rng.integers(2, max_boxes + 1))):
            w, h = (int(v) for v in rng.integers(side[0], side[1] + 1, 2))
            x0, y0 = int(rng.integers(0, imgsz - w + 1)), int(rng.integers(0, imgsz - h + 1))
            c = int(rng.integers(0, nc))
            img[i, y0:y0 + h, x0:x0 + w] = CLASS_COLOURS[c % len(CLASS_COLOURS)]
            bboxes[i, j] = ((x0 + w / 2) / imgsz, (y0 + h / 2) / imgsz, w / imgsz, h / imgsz)
            cls[i, j], mask[i, j] = c, True
    return {"img": img, "bboxes": bboxes, "cls": cls, "mask": mask}


@torch.no_grad()
def he_normal_(model: torch.nn.Module, seed: int) -> None:
    """Redraw every conv weight He-normal (std sqrt(2 / fan_in)) from a seeded
    generator and set the Detect class-bias priors to 0.

    With PyTorch's default init the activations of the 27 layers shrink
    towards zero: every LD-P2 score then sits at 0.5009 within 1e-4, and NMS
    only breaks near-ties. He-normal weights keep the activations' scale, as
    a trained network's are, so scores and boxes spread and NMS does real
    work. LDConv's offset conv keeps its zero weight and uniform bias (the
    reference's init), so its offsets are one value per channel, the same at
    every pixel: ``chip_smoke.py`` also holds kernel K3 to its plain version
    on random offsets. In a VSS model SS2D's depthwise conv is redrawn like
    any conv; its linear layers and scan parameters keep their own init, whose
    step sizes sit near 0.01, so K4 is held on random inputs too.
    """
    gen = torch.Generator().manual_seed(seed)
    offset_convs = {id(m.p_conv) for m in model.modules() if isinstance(m, LDConv)}
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) and id(m) not in offset_convs:
            std = math.sqrt(2.0 / m.weight[0].numel())
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
    for cls in model.model[-1].cv3:
        cls[-1].bias.zero_()


# the main paths' pools and inputs, shared by chip_smoke.py and kernel_variants
VAL_SEED = 30  # val batch i of a run with seed s is seeded_batch(batch, imgsz, s + VAL_SEED + i, nc)
SERVE_CONF, VAL_CONF, NMS_IOU, NMS_MAX_DET = 0.25, 0.001, 0.7, 300  # the predictor's and the validator's defaults


def seeded_model(cfg, seed: int, device="cuda"):
    """``cfg``'s DetectionModel with PyTorch's init drawn from ``seed`` and
    the conv weights redrawn by :func:`he_normal_` from ``seed + 1``."""
    from experiment_yolo_torch.nn.tasks import DetectionModel

    model = DetectionModel(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    he_normal_(model, seed + 1)
    return model


def letterboxed(images: List[np.ndarray], imgsz: int) -> np.ndarray:
    """BGR ``images`` letterboxed to ``imgsz`` and flipped to RGB, as the
    predictor hands them to the model: (B, imgsz, imgsz, 3) uint8."""
    from experiment_yolo_torch.data.augment import letterbox

    return np.stack([letterbox(img, imgsz)[0][..., ::-1] for img in images])


def model_input(img: np.ndarray, device) -> torch.Tensor:
    """A (B, H, W, 3) uint8 batch as the model takes it: (B, 3, H, W) float32 in [0, 1]."""
    return (torch.from_numpy(np.ascontiguousarray(img)).to(device).permute(0, 3, 1, 2).float() / 255.0).contiguous()


def soft_nms_pools(boxes: torch.Tensor, scores: torch.Tensor, *, val: bool) -> Dict[str, Tuple[tuple, dict]]:
    """K5's input on a main path, from one batch's decoded ``boxes`` and
    ``scores`` (``model.predict``): the arguments (class-offset boxes, scores,
    valid, iou_thres, max_det) and keywords of ``soft_nms``. The predictor's
    pool (the best class of each anchor at conf SERVE_CONF) under ``""``; with
    ``val`` the validator's (multi-label, K = VAL_PRE_NMS_TOPK at conf
    VAL_CONF), with the quirk's ``first_idx`` and ``n_valid`` under
    ``" quirk"`` and without the quirk's first box under ``""``."""
    from experiment_yolo_torch.engine.validator import VAL_PRE_NMS_TOPK
    from experiment_yolo_torch.ops.nms import nms_candidates

    out = {}
    for quirk in ((True, False) if val else (False,)):
        c = (nms_candidates(boxes, scores, VAL_CONF, first_box=quirk, multi_label=True, pre_nms_topk=VAL_PRE_NMS_TOPK)
             if val else nms_candidates(boxes, scores, SERVE_CONF))
        kw = {"first_idx": c.first_idx, "n_valid": c.n_valid} if quirk else {}
        out[" quirk" if quirk else ""] = ((c.shifted.contiguous(), c.scores.contiguous(), c.valid, NMS_IOU,
                                           NMS_MAX_DET), kw)
    return out


def _offsets_to(off: torch.Tensor, stride: int, tr: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """The offsets (B, 2N, h, w) that put each sample of an LDConv with
    offsets shaped like ``off`` at the source position (``tr``, ``tc``), both
    (B, N, h, w): a sample's position is its grid position plus its offset."""
    b, n2, h, w = off.shape
    n = n2 // 2
    pts = torch.tensor(grid_points(n), dtype=torch.float32)  # (N, 2)
    rows = (torch.arange(h, dtype=torch.float32) * stride)[:, None].expand(h, w)
    cols = (torch.arange(w, dtype=torch.float32) * stride)[None, :].expand(h, w)
    return torch.cat([tr - rows - pts[:, 0].reshape(1, n, 1, 1), tc - cols - pts[:, 1].reshape(1, n, 1, 1)], 1)


def contention_offsets(x: torch.Tensor, off: torch.Tensor, stride: int, gen: torch.Generator,
                       share: float = 0.9) -> torch.Tensor:
    """Offsets (like ``off``) that put a ``share`` of the samples at one of
    sixteen source positions, a quarter of a pixel past the points of a 4 x 4
    grid at (H (2k + 1) / 8, W (2l + 1) / 8), so that their bilinear corners
    and their adds in the backward land on the same 64 source pixels; the rest
    keep ``off``."""
    b, n2, h, w = off.shape
    n, (hx, wx) = n2 // 2, x.shape[2:]
    pick = torch.randint(0, 16, (b, n, h, w), generator=gen)
    tr = (hx * (2 * (pick // 4) + 1) // 8).float() + 0.25
    tc = (wx * (2 * (pick % 4) + 1) // 8).float() + 0.25
    pulled = torch.rand((b, n, h, w), generator=gen) < share
    cont = _offsets_to(off, stride, tr, tc)
    return torch.where(torch.cat([pulled, pulled], 1), cont, off.cpu()).to(off.device)


def seam_offsets(x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
    """Offsets (like ``off``) that put every sample a quarter of a pixel
    past source row H / 2 and column (j + 1) mod w, j its output column. The
    cells of neighbouring output pixels then follow each other also from the
    last pixel of one image or sampling point to the first of the next: where
    h * w is no multiple of 32, one warp of the backward holds both, and must
    not merge their adds unless they go into the same channel plane."""
    b, n2, h, w = off.shape
    n = n2 // 2
    tr = torch.full((b, n, h, w), float(x.shape[2] // 2) + 0.25)
    tc = ((torch.arange(w) + 1) % w).float().expand(b, n, h, w) + 0.25
    return _offsets_to(off, stride, tr, tc).to(off.device)


SoftNmsCase = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float, torch.Tensor, torch.Tensor]


def soft_nms_cases(seed: int, device="cpu") -> Dict[str, SoftNmsCase]:
    """Made-up candidate pools for soft-NMS (kernel K5), each (class-offset
    xyxy boxes (B, K, 4), scores (B, K) sorted descending, the conf gate (B,
    K), the IoU threshold, and the quirk's ``first_idx`` and ``n_valid`` (B,)
    int64, a valid candidate and at least the valid count) on ``device``:

    - K = 1, a ragged K = 1,000, K = 4,096 and K = 8,192 of clustered boxes;
    - exact duplicates with equal scores (ties in the argmax);
    - pairs whose float32 IoU is exactly 0.7, 0.8 or 0.6 (small integers:
      7/10 ties with the threshold and must not decay);
    - a score that the decay puts exactly on the 0.25 floor (found on
      ``device``, whose ``exp`` the plain version uses);
    - an image with no valid candidate;
    - the quirk's first box in the last slot, scored out of order, as the
      pool's forced slot is;
    - a pool like a trained detector's at conf 0.001: K = 4,096 over 6
      classes, about 5% of the scores above the 0.25 floor and the rest down
      to 0.001 (the kernel drops those at load and stops early);
    - pairs whose float32 IoU is one spacing above or below the threshold,
      and pairs whose exact quotient is above it but rounds onto it (see
      :func:`threshold_pairs`);
    - a pool in which every box overlaps every other, so that no pair skips
      the exact IoU by its intersection alone.
    """
    gen = torch.Generator().manual_seed(seed)

    def clustered(b, k):
        centres = (torch.rand(b, k // 8 + 1, 2, generator=gen) * 600).repeat_interleave(8, 1)[:, :k]
        centres = centres + torch.randn(b, k, 2, generator=gen) * 6
        wh = torch.rand(b, k, 2, generator=gen) * 50 + 10
        return torch.cat([centres - wh / 2, centres + wh / 2], -1)

    def scores_of(b, k):  # squares of uniforms: about half above the 0.25 floor
        return torch.rand(b, k, generator=gen).pow(2).sort(-1, descending=True).values

    def case(boxes, scores, valid, thr=0.7, first_idx=None, n_valid=None):
        b, k = scores.shape
        if first_idx is None:  # a random valid candidate, or 0 where none is valid
            first_idx = torch.where(valid, torch.rand(b, k, generator=gen), -1.0).argmax(-1)
        if n_valid is None:
            n_valid = valid.sum(-1) + torch.randint(0, 3, (b,), generator=gen)
        return tuple(t.to(device).contiguous() for t in (boxes.float(), scores.float(), valid)) + (
            thr, first_idx.to(device), n_valid.to(device))

    cases = {}
    for label, b, k in (("K=1", 2, 1), ("ragged K=1000", 3, 1000), ("K=4096", 2, 4096), ("K=8192", 2, 8192)):
        sc = scores_of(b, k)
        cases[label] = case(clustered(b, k), sc, sc > 0.001)
    dup, sc = clustered(2, 512), scores_of(2, 512)
    dup[:, 1::2], sc[:, 1::2] = dup[:, 0::2], sc[:, 0::2]
    cases["duplicates"] = case(dup, sc, sc > 0.001)

    x0 = 20.0 * torch.arange(300, dtype=torch.float32)
    inner = torch.tensor([7.0, 8.0, 6.0]).repeat(100)
    zero, one = torch.zeros(300), torch.ones(300)
    ties = torch.stack([torch.stack([x0, zero, x0 + 10, one], -1), torch.stack([x0, zero, x0 + inner, one], -1)], 1)
    ties = torch.stack([ties.reshape(600, 4), ties[torch.randperm(300, generator=gen)].reshape(600, 4)])
    sc = (0.3 + 0.7 * torch.rand(2, 600, generator=gen)).sort(-1, descending=True).values
    cases["IoU at the threshold"] = case(ties, sc, torch.ones(2, 600, dtype=torch.bool))

    # A (0.95) decays B (IoU 8/10) onto exactly 0.25; C, D, F sit apart, E below the floor
    pair = torch.tensor([[0.0, 0.0, 10.0, 1.0], [0.0, 0.0, 8.0, 1.0]], device=device)
    decay = torch.exp(-(box_iou(pair[:1], pair[1:])[0, 0] ** 2) / 0.5)
    s = 0.25 / decay
    for _ in range(64):
        landed = s * decay
        if landed == 0.25:
            break
        s = torch.nextafter(s, torch.tensor(1.0 if landed < 0.25 else 0.0, device=device))
    if (s * decay).item() != 0.25:
        raise RuntimeError("no score found whose decay lands on 0.25")
    far = [[100.0 * i, 0.0, 100.0 * i + 10, 1.0] for i in range(1, 5)]
    boxes = torch.tensor([pair.tolist()[0], pair.tolist()[1], *far])
    sc = torch.tensor([0.95, s.item(), 0.5, 0.3, 0.26, 0.2])
    cases["decay onto 0.25"] = case(boxes[None], sc[None], torch.ones(1, 6, dtype=torch.bool))

    sc = scores_of(2, 256)
    valid = sc > 0.001
    valid[1] = False
    cases["an image with none valid"] = case(clustered(2, 256), sc, valid, first_idx=torch.tensor([0, 0]),
                                             n_valid=valid.sum(-1))
    sc = scores_of(2, 300)
    sc[:, -1] = 0.6
    valid = sc > 0.001
    valid[:, -1] = True
    cases["quirk first in the last slot"] = case(clustered(2, 300), sc, valid, first_idx=torch.tensor([299, 299]))

    b, k, n_hi = 2, 4096, 205
    cls = torch.randint(0, 6, (b, k), generator=gen)
    hi = 0.25 + 0.7 * torch.rand(b, n_hi, generator=gen)
    lo = 10 ** (math.log10(0.001) + (math.log10(0.25) - math.log10(0.001)) * torch.rand(b, k - n_hi, generator=gen))
    sc = torch.cat([hi, lo], 1).sort(-1, descending=True).values
    cases["trained-like K=4096"] = case(clustered(b, k) + (cls * 7680.0)[..., None], sc, sc > 0.001)

    pairs = threshold_pairs(0.7, 32, gen)
    sc = (0.3 + 0.7 * torch.rand(2, pairs.shape[0] * 2, generator=gen)).sort(-1, descending=True).values
    order = torch.randperm(pairs.shape[0], generator=gen)
    boxes = torch.stack([pairs.reshape(-1, 4), pairs[order].reshape(-1, 4)])
    cases["IoU one spacing from the threshold"] = case(boxes, sc, torch.ones_like(sc, dtype=torch.bool))

    centres = 300 + 16 * torch.rand(2, 1024, 2, generator=gen) - 8
    wh = 40 + 20 * torch.rand(2, 1024, 2, generator=gen)
    sc = (0.3 + 0.7 * torch.rand(2, 1024, generator=gen)).sort(-1, descending=True).values
    cases["all overlapping"] = case(torch.cat([centres - wh / 2, centres + wh / 2], -1), sc, sc > 0.001)
    return cases


def iou_parts(a: torch.Tensor, b: torch.Tensor):
    """(inter, union, iou) of xyxy box pairs (N, 4) in float32, rounded
    operation by operation as ``box_iou`` and kernel K5 round them."""
    inter = (torch.minimum(a[:, 2:], b[:, 2:]) - torch.maximum(a[:, :2], b[:, :2])).clamp(min=0).prod(-1)
    area_a, area_b = (a[:, 2:] - a[:, :2]).clamp(min=0).prod(-1), (b[:, 2:] - b[:, :2]).clamp(min=0).prod(-1)
    union = area_a + area_b - inter + 1e-7
    return inter, union, inter / union


def threshold_pairs(thr: float, per_kind: int, gen: torch.Generator, trials: int = 8192) -> torch.Tensor:
    """(3 * per_kind, 2, 4) xyxy pairs, each in its own 100 px cell, of
    three kinds around ``t``, ``thr`` in float32, ``per_kind`` each:

    - IoU one spacing above ``t`` where thr * u - inter, rounded twice (no
      fma), is still >= 0: a pre-test without the fma would skip a decay;
    - IoU one spacing below ``t`` (no decay, and the exact pre-test skips it);
    - inter / u above ``t`` exactly, yet its rounded quotient equal to ``t``
      (no decay): a pre-test that decided alone would decay.

    Found by a seeded search over nested boxes near the threshold, with the
    float32 operations of ``box_iou`` on the boxes' own coordinates."""
    t = torch.tensor(thr, dtype=torch.float32)
    above, below = torch.nextafter(t, torch.tensor(1.0)), torch.nextafter(t, torch.tensor(0.0))
    n = 3 * per_kind
    cell = torch.arange(n, dtype=torch.float32)
    x0 = (100 * (cell % 16))[:, None].expand(n, trials)
    y0 = (100 * (cell // 16))[:, None].expand(n, trials)
    big = 10 + 50 * torch.rand(n, trials, 2, generator=gen)
    h = big[..., 1] * (0.75 + 0.25 * torch.rand(n, trials, generator=gen))
    w = t * big[..., 0] * big[..., 1] / h
    w = w + torch.randint(-3, 4, (n, trials), generator=gen) * (torch.nextafter(w, w + 1) - w)
    a = torch.stack([x0, y0, x0 + big[..., 0], y0 + big[..., 1]], -1).reshape(-1, 4)
    b = torch.stack([x0, y0, x0 + w, y0 + h], -1).reshape(-1, 4)
    inter, union, iou = iou_parts(a, b)
    exact = t.double() * union.double() - inter.double()  # exact product; the difference keeps its sign
    kinds = ((iou == above) & (t * union - inter >= 0), iou == below, (exact < 0) & (iou == t))
    out = []
    for i, hit in enumerate(kinds):
        hit = hit.reshape(n, trials)[i * per_kind:(i + 1) * per_kind]
        if not bool(hit.any(1).all()):
            raise RuntimeError(f"threshold_pairs: no pair of kind {i} found in some cell")
        j = hit.int().argmax(1) + torch.arange(i * per_kind, (i + 1) * per_kind) * trials
        out.append(torch.stack([a[j], b[j]], 1))
    return torch.cat(out)
