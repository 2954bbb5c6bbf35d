"""The data slice against the JAX package: image files, the synthetic
dataset, ``YOLODataset`` (file scan, labels, label cache), every OpenCV
counterpart of ``data/augment.py``, the augmented and the letterboxed
samples, and the threaded ``DataLoader``.

The datasets are written by the port (24-bit BMP, which ``cv2.imread`` reads
to the same bytes), at 64 px, then copied at mixed sizes so that the
mosaics and the letterbox resize. Pixels of whole samples are held to the
JAX package's within 2 grey levels and under 0.5 on average, labels
identically; each OpenCV counterpart is held bit-equal to OpenCV.
"""

import math
import shutil

import cv2
import numpy as np
import pytest

from experiment_yolo_torch.cfg import get_cfg as t_cfg
from experiment_yolo_torch.data import DataLoader as TLoader
from experiment_yolo_torch.data import YOLODataset as TDataset
from experiment_yolo_torch.data import augment as TA
from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.data import make_synthetic_dataset as t_make
from experiment_yolo_tpu.cfg import get_cfg as j_cfg
from experiment_yolo_tpu.data import DataLoader as JLoader
from experiment_yolo_tpu.data import YOLODataset as JDataset
from experiment_yolo_tpu.data import make_synthetic_dataset as j_make

IMGSZ = 64
SIZES = [(64, 64), (48, 80), (96, 64), (80, 40), (64, 100), (33, 77)]  # (h, w) of the mixed copies
SEEDS = range(24)
HYPS = {  # every branch of get_sample, HSV at its defaults
    "mosaic4, warp": {"degrees": 10.0, "shear": 5.0, "perspective": 1e-4, "flipud": 0.5},
    "mosaic9": {"mosaic9": 1.0, "degrees": 10.0, "shear": 5.0, "flipud": 0.5},
    "mixup": {"mixup": 1.0, "degrees": 10.0, "perspective": 1e-4},
    "letterbox, warp": {"mosaic": 0.0, "degrees": 10.0, "shear": 5.0, "perspective": 1e-4, "flipud": 0.5},
}


def _close(a, b):
    """Within 2 grey levels, under 0.5 on average."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 2 and d.mean() < 0.5, (d.max(), d.mean())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's synthetic BMP dataset (6 train, 5 val at 64 px), and a copy
    whose images are resized to ``SIZES`` (labels are normalised, so they
    hold)."""
    root = tmp_path_factory.mktemp("data")
    t_make(root / "synthetic", n_train=6, n_val=5, imgsz=IMGSZ, seed=0)
    shutil.copytree(root / "synthetic", root / "mixed", ignore=shutil.ignore_patterns("*.cache.npy"))
    for split in ("train", "val"):
        for i, f in enumerate(sorted((root / "mixed" / "images" / split).glob("*.bmp"))):
            h, w = SIZES[i % len(SIZES)]
            image_io.imwrite(f, TA.resize_linear(image_io.imread(f), (w, h)))
    return root


def _datasets(path, **hyp):
    ov = {"imgsz": IMGSZ, **hyp}
    return (TDataset(path, imgsz=IMGSZ, augment=True, hyp=t_cfg(ov)),
            JDataset(path, imgsz=IMGSZ, augment=True, hyp=j_cfg(overrides=ov)))


# -- image files ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 13), (64, 64), (5, 3), (33, 77)])
def test_bmp_round_trip_reads_as_opencv_does(tmp_path, shape):
    """A BMP written by ``image_io`` reads back equal, ``cv2.imread`` reads it
    to the same bytes, its header gives the shape, and a BMP written by
    OpenCV reads equal too (rows padded to 4 bytes for odd widths)."""
    img = np.random.default_rng(0).integers(0, 256, (*shape, 3), dtype=np.uint8)
    image_io.imwrite(tmp_path / "a.bmp", img)
    np.testing.assert_array_equal(image_io.imread(tmp_path / "a.bmp"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.bmp")), img)
    assert image_io.image_shape(tmp_path / "a.bmp") == shape
    cv2.imwrite(str(tmp_path / "b.bmp"), img)
    np.testing.assert_array_equal(image_io.imread(tmp_path / "b.bmp"), img)


def test_jax_written_sidecar_is_read_as_is(tmp_path):
    """A JPEG dataset that the JAX package decoded into ``cache='disk'``
    sidecars: the port reads each image from its sidecar, equal to
    ``cv2.imread`` of the JPEG, and its shape from the sidecar's header."""
    j_make(tmp_path, n_train=3, n_val=1, imgsz=IMGSZ, seed=1)
    jds = JDataset(tmp_path / "images" / "train", imgsz=IMGSZ, augment=False, cache="disk")
    for i in range(len(jds)):
        jds._load_item(i)
    tds = TDataset(tmp_path / "images" / "train", imgsz=IMGSZ, augment=False)
    assert tds.im_files == jds.im_files and all(f.endswith(".jpg") for f in tds.im_files)
    for i, f in enumerate(tds.im_files):
        np.testing.assert_array_equal(tds._load_item(i)["img"], cv2.imread(f))
    np.testing.assert_array_equal(tds.image_shapes(), jds.image_shapes())


def test_jpeg_without_a_sidecar_raises(tmp_path):
    """No silent skip: the dataset scan raises naming the file and the libjpeg route."""
    j_make(tmp_path, n_train=2, n_val=1, imgsz=IMGSZ, seed=2)
    jpg = sorted((tmp_path / "images" / "train").glob("*.jpg"))[0]
    with pytest.raises(NotImplementedError, match=rf"{jpg.name}.*libjpeg"):
        image_io.imread(jpg)
    with pytest.raises(NotImplementedError, match="libjpeg"):
        TDataset(tmp_path / "images" / "train", imgsz=IMGSZ, augment=False)


# -- the synthetic dataset and YOLODataset ------------------------------------------

def test_synthetic_labels_and_yaml_match_jax(tmp_path):
    """Same seed, same draws: identical label files and data.yaml."""
    t_yaml = t_make(tmp_path / "t", n_train=6, n_val=2, imgsz=IMGSZ, seed=0)
    j_yaml = j_make(tmp_path / "j", n_train=6, n_val=2, imgsz=IMGSZ, seed=0)
    t_labels = sorted((tmp_path / "t" / "labels").rglob("*.txt"))
    assert len(t_labels) == 8
    for f in t_labels:
        assert f.read_text() == (tmp_path / "j" / f.relative_to(tmp_path / "t")).read_text(), f
    assert t_yaml.read_text().replace(str(tmp_path / "t"), "R") == j_yaml.read_text().replace(str(tmp_path / "j"), "R")
    img = image_io.imread(sorted((tmp_path / "t" / "images" / "train").glob("*.bmp"))[0])
    assert img.shape == (IMGSZ, IMGSZ, 3) and img.min() >= 40 and img.max() >= 120  # offset noise, a shape


def test_dataset_files_labels_and_cache_key_match_jax(data, tmp_path):
    """The same image list, parsed labels and label-cache key; a changed
    label file changes both keys alike and both re-parse it."""
    shutil.copytree(data / "synthetic", tmp_path / "d")
    path = tmp_path / "d" / "images" / "train"
    tds, jds = _datasets(path)
    assert tds.im_files == jds.im_files and len(tds) == 6
    key = tds._cache_key()
    assert key == jds._cache_key()
    for a, b in zip(tds.labels, jds.labels):
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_array_equal(a["bboxes_n"], b["bboxes_n"])
    label = tmp_path / "d" / "labels" / "train" / "00000.txt"
    label.write_text(label.read_text() + "2 0.5 0.5 0.25 0.25\n")
    tds2, jds2 = _datasets(path)
    assert tds2._cache_key() == jds2._cache_key() != key
    assert len(tds2.labels[0]["cls"]) == len(jds2.labels[0]["cls"]) == len(tds.labels[0]["cls"]) + 1


def test_fraction_single_cls_and_image_caches(data, tmp_path):
    """``fraction`` and ``single_cls`` give the JAX dataset's files and labels;
    ``cache='ram'`` keeps the decoded image, ``cache='disk'`` writes the
    ``.npy`` sidecar the JAX package writes and reads it back."""
    shutil.copytree(data / "mixed", tmp_path / "d")
    path = tmp_path / "d" / "images" / "train"
    tds = TDataset(path, imgsz=IMGSZ, fraction=0.5, single_cls=True)
    jds = JDataset(path, imgsz=IMGSZ, fraction=0.5, single_cls=True)
    assert tds.im_files == jds.im_files and len(tds) == 3
    for a, b in zip(tds.labels, jds.labels):
        np.testing.assert_array_equal(a["cls"], b["cls"])
        assert not a["cls"].any()
    ram = TDataset(path, imgsz=IMGSZ, cache="ram")
    first = ram._load_item(1)["img"]
    assert ram._load_item(1)["img"] is first
    disk = TDataset(path, imgsz=IMGSZ, cache="disk")
    img = disk._load_item(2)["img"]
    sidecar = image_io.sidecar(disk.im_files[2])
    assert sidecar.exists()
    np.testing.assert_array_equal(np.load(sidecar), img)
    np.testing.assert_array_equal(JDataset(path, imgsz=IMGSZ, cache="disk")._load_item(2)["img"], img)


# -- the OpenCV counterparts --------------------------------------------------------

@pytest.mark.parametrize("src, dst", [((100, 150), (85, 128)), ((61, 61), (128, 128)), ((128, 96), (64, 48)),
                                      ((720, 1280), (360, 640)), ((33, 77), (64, 28)), ((64, 64), (41, 41))])
def test_resize_linear_is_opencv_bit_for_bit(src, dst):
    img = np.random.default_rng(3).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(TA.resize_linear(img, dst[::-1]), want)


@pytest.mark.parametrize("seed", range(4))
def test_warps_and_rotation_matrix_are_opencv_bit_for_bit(seed):
    """``rotation_matrix_2d`` equals ``getRotationMatrix2D``; affine and
    perspective warps of a blurred noise image with flat patches (sharp
    edges) equal ``warpAffine`` and ``warpPerspective``, borders included."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, (160, 128, 3), dtype=np.uint8), (7, 7), 0)
    img[30:60, 40:90] = (200, 30, 100)
    angle, scale = rng.uniform(-30, 30), rng.uniform(0.5, 1.5)
    R = np.eye(3)
    R[:2] = TA.rotation_matrix_2d(angle, scale)
    np.testing.assert_array_equal(R[:2], cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale))
    C, S, T, P = np.eye(3), np.eye(3), np.eye(3), np.eye(3)
    C[:2, 2] = -64, -80
    S[0, 1], S[1, 0] = (math.tan(v * math.pi / 180) for v in rng.uniform(-5, 5, 2))
    T[:2, 2] = rng.uniform(0.3, 0.7, 2) * 96
    P[2, :2] = rng.uniform(-2e-3, 2e-3, 2)
    M = T @ S @ R @ C
    np.testing.assert_array_equal(TA.warp_affine(img, M[:2], (96, 80)),
                                  cv2.warpAffine(img, M[:2], dsize=(96, 80), borderValue=(114, 114, 114)))
    M = T @ S @ R @ P @ C
    np.testing.assert_array_equal(TA.warp_perspective(img, M, (96, 80)),
                                  cv2.warpPerspective(img, M, dsize=(96, 80), borderValue=(114, 114, 114)))


def test_hsv_conversions_are_opencv_bit_for_bit_on_every_input():
    """BGR -> HSV on all 2^24 colours; HSV -> BGR on all 180 * 256 * 256 inputs."""
    bgr = np.arange(1 << 24, dtype=np.uint32).view(np.uint8).reshape(4096, 4096, 4)[..., :3].copy()
    np.testing.assert_array_equal(TA.bgr2hsv(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"), -1)
    hsv = hsv.astype(np.uint8).reshape(180 * 256, 256, 3)
    np.testing.assert_array_equal(TA.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


# -- samples ------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(HYPS))
def test_get_sample_matches_jax(data, name):
    """``get_sample(i, default_rng(seed))`` for 24 seeds and every image of
    the mixed set: boxes, classes and mask identical (every draw in the JAX
    order), pixels within 2 grey levels. The hyperparameters reach
    ``name``'s branch, and its samples keep boxes."""
    tds, jds = _datasets(data / "mixed" / "images" / "train", **HYPS[name])
    kept = 0
    for seed in SEEDS:
        for i in range(len(tds)):
            t, j = tds.get_sample(i, np.random.default_rng(seed)), jds.get_sample(i, np.random.default_rng(seed))
            assert sorted(t) == sorted(j) == ["bboxes", "cls", "img", "mask"]
            for k in ("bboxes", "cls", "mask"):
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"seed {seed} image {i} {k}")
            _close(t["img"], j["img"])
            kept += int(t["mask"].sum())
    assert kept > len(SEEDS) * len(tds)


def test_get_val_sample_matches_jax(data):
    """Letterboxed samples at mixed sizes, square and at a rect shape: labels,
    ``ori_shape`` and ``ratio_pad`` identical, pixels within 2 grey levels."""
    tds, jds = _datasets(data / "mixed" / "images" / "val")
    for shape in (None, (48, 64), (64, 32)):
        for i in range(len(tds)):
            t, j = tds.get_val_sample(i, shape), jds.get_val_sample(i, shape)
            assert sorted(t) == sorted(j)
            for k in t:
                if k != "img":
                    np.testing.assert_array_equal(t[k], j[k], err_msg=f"{shape} {i} {k}")
            _close(t["img"], j["img"])


# -- the loader ----------------------------------------------------------------------

def _same_batches(t_loader, j_loader, epochs):
    n = 0
    for epoch in range(epochs):
        t_loader.set_epoch(epoch)
        j_loader.set_epoch(epoch)
        t_batches, j_batches = list(t_loader), list(j_loader)
        assert len(t_batches) == len(j_batches) == len(t_loader) == len(j_loader)
        for t, j in zip(t_batches, j_batches):
            assert sorted(t) == sorted(j)
            for k in t:
                if k != "img":
                    np.testing.assert_array_equal(t[k], j[k], err_msg=f"epoch {epoch} {k}")
            _close(t["img"], j["img"])
            n += 1
    return n


def test_train_loader_matches_jax(data):
    """Two epochs, shuffled, two workers, the default augment (mosaic): the
    same number of batches (the partial one dropped), the same order and
    labels, pixels within 2 grey levels; then with mosaic closed."""
    tds, jds = _datasets(data / "mixed" / "images" / "train")
    t_loader, j_loader = TLoader(tds, 4, shuffle=True, workers=2, seed=3), JLoader(jds, 4, shuffle=True, workers=2,
                                                                                    seed=3)
    assert _same_batches(t_loader, j_loader, 2) == 2
    t_loader.mosaic = j_loader.mosaic = False
    assert _same_batches(t_loader, j_loader, 1) == 1


def test_val_loader_rect_matches_jax(data):
    """Validation with rect batches of 2 over 5 mixed-size images: the same
    aspect-sorted order and batch shapes, the last batch padded with image 0."""
    tds, jds = _datasets(data / "mixed" / "images" / "val")
    t_loader = TLoader(tds, 2, shuffle=False, workers=2, drop_last=False, rect=True)
    j_loader = JLoader(jds, 2, shuffle=False, workers=2, drop_last=False, rect=True)
    np.testing.assert_array_equal(t_loader.image_order(), j_loader.image_order())
    assert t_loader._batch_shapes == j_loader._batch_shapes and len(set(t_loader._batch_shapes)) > 1
    assert _same_batches(t_loader, j_loader, 1) == 3
    last = list(t_loader)[-1]
    np.testing.assert_array_equal(last["ori_shape"][1], tds.image_shapes()[0])


def test_leaving_the_loop_early_stops_the_producer(data):
    """Breaking out of an epoch ends the producer thread (no batch is left
    waiting on the queue), and the next epoch starts afresh."""
    import threading

    tds, _ = _datasets(data / "mixed" / "images" / "train")
    loader = TLoader(tds, 2, shuffle=True, workers=2, prefetch=1)
    before = threading.active_count()
    for batch in loader:
        break
    assert threading.active_count() == before
    assert len(list(loader)) == 3
