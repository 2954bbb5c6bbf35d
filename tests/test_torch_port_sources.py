"""The predictor's sources and ``Results``' methods against the JAX package,
on the CPU (JPEGs through libjpeg, bit-equal to the JAX package's OpenCV).

- ``data/loaders.py:iter_images_and_videos`` on a mixed folder (JPEG, PNG and
  BMP, a subfolder, files of other kinds) and on a list of arrays and files:
  the JAX package's labels, frames and order;
- ``YOLODataset`` on the JAX package's own synthetic JPEG dataset, with a
  truncated and a tiny image among it: the same files dropped, the JAX
  package's images bit for bit, its labels and shapes; a JPEG cut in its
  scan data, which the JAX package keeps, dropped with a message;
- ``Boxes``' conversions and ``Results.save_txt`` / ``to_dict`` / ``tojson``
  / ``verbose`` / ``save_crop`` on the same detections: the same bytes,
  strings and files.
"""

import shutil

import cv2
import numpy as np
import pytest

from experiment_yolo_torch.data import YOLODataset as TDataset
from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.data import loaders as tloaders
from experiment_yolo_torch.engine.results import Results
from experiment_yolo_torch.utils.seeded import seeded_images
from experiment_yolo_tpu.data import YOLODataset as JDataset
from experiment_yolo_tpu.data import loaders as jloaders
from experiment_yolo_tpu.data import make_synthetic_dataset as j_make
from experiment_yolo_tpu.engine.results import Results as JResults

IMGSZ = 64


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Seeded images written by OpenCV as JPEG, PNG and BMP, one in a
    subfolder, beside a text file and an empty ``.npy`` that no loader reads."""
    root = tmp_path_factory.mktemp("mixed")
    (root / "sub").mkdir()
    for i, img in enumerate(seeded_images(5, 3)):
        ext = ("jpg", "png", "bmp", "jpeg", "PNG")[i]
        cv2.imwrite(str((root / "sub" if i == 3 else root) / f"{i}.{ext}"), img)
    (root / "notes.txt").write_text("not an image")
    (root / "0.npy").write_bytes(b"")
    return root


def _frames(gen):
    return [(label, frame, meta) for label, frame, meta in gen]


@pytest.mark.parametrize("chunk", [1, 2, 8])
def test_folder_frames_labels_and_order_match_jax(folder, chunk):
    want = _frames(jloaders.iter_images_and_videos(str(folder)))
    got = _frames(tloaders.iter_images_and_videos(str(folder), device="cpu", chunk=chunk))
    assert [g[0] for g in got] == [w[0] for w in want] and len(got) == 5
    for (_, gf, gm), (_, wf, wm) in zip(got, want):
        assert gm == wm
        np.testing.assert_array_equal(gf, wf)


def test_lists_of_arrays_and_files_match_jax(folder):
    img = np.full((9, 11, 3), 7, np.uint8)
    source = [img, folder / "1.png", str(folder / "0.jpg"), [img, folder / "sub"]]
    want = _frames(jloaders.iter_images_and_videos(source))
    got = _frames(tloaders.iter_images_and_videos(source, device="cpu", chunk=3))
    assert [g[0] for g in got] == [w[0] for w in want] == ["array", str(folder / "1.png"), str(folder / "0.jpg"),
                                                           "array", str(folder / "sub" / "3.jpeg")]
    for (_, gf, gm), (_, wf, wm) in zip(got, want):
        assert gm == wm
        np.testing.assert_array_equal(gf, wf)
    assert tloaders.is_stream_source(0) and tloaders.is_stream_source("rtsp://a")
    assert not tloaders.is_stream_source(folder)


def test_sources_still_to_port_raise_naming_the_item(folder, tmp_path):
    (tmp_path / "clip.mp4").write_bytes(b"\x00" * 64)
    for source in (tmp_path / "clip.mp4", tmp_path, "rtsp://camera/1", 0, "list.streams"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 3.5"):
            list(tloaders.iter_images_and_videos(source, device="cpu"))
    for call in (lambda: tloaders.LoadStreams("0"), tloaders.load_screenshot):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 3.5"):
            call()
    with pytest.raises(FileNotFoundError, match="not found"):
        list(tloaders.iter_images_and_videos(tmp_path / "missing.jpg", device="cpu"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no images/videos"):
        list(tloaders.iter_images_and_videos(tmp_path / "empty", device="cpu"))


def test_yolo_dataset_on_a_jax_jpeg_dataset(tmp_path):
    """The JAX package's synthetic dataset (JPEG), with a truncated JPEG and a
    5 x 5 one added: both packages drop those two, and the port's images are
    the JAX package's bit for bit, with its labels and header shapes."""
    j_make(tmp_path, n_train=5, n_val=1, imgsz=IMGSZ, seed=4)
    train = tmp_path / "images" / "train"
    first = sorted(train.glob("*.jpg"))[0]
    (train / "zz_cut.jpg").write_bytes(first.read_bytes()[:12])
    cv2.imwrite(str(train / "zz_tiny.jpg"), np.full((5, 5, 3), 99, np.uint8))
    for name in ("zz_cut", "zz_tiny"):
        shutil.copy(tmp_path / "labels" / "train" / f"{first.stem}.txt", tmp_path / "labels" / "train" / f"{name}.txt")
    jds = JDataset(train, imgsz=IMGSZ, augment=False)
    (tmp_path / "labels" / "train.cache.npy").unlink()  # the port builds its own scan
    tds = TDataset(train, imgsz=IMGSZ, augment=False, device="cpu")
    assert tds.im_files == jds.im_files and len(tds) == 5
    for i in range(len(tds)):
        t, j = tds._load_item(i), jds._load_item(i)
        np.testing.assert_array_equal(t["img"], j["img"])
        np.testing.assert_array_equal(t["bboxes"], j["bboxes"])
        np.testing.assert_array_equal(t["cls"], j["cls"])
        for k in ("img", "bboxes", "cls", "ratio_pad", "ori_shape"):
            np.testing.assert_array_equal(tds.get_val_sample(i)[k], jds.get_val_sample(i)[k])
    np.testing.assert_array_equal(tds.image_shapes(), jds.image_shapes())


def test_yolo_dataset_drops_a_jpeg_cut_in_its_scan_data(tmp_path):
    """A JPEG whose header is whole but whose scan data is cut: the JAX
    package keeps it (PIL's verify reads the header; OpenCV fills the rest
    with grey), the port drops it, naming it, since its decoders refuse it."""
    from experiment_yolo_torch.utils import LOGGER

    j_make(tmp_path, n_train=3, n_val=1, imgsz=IMGSZ, seed=5)
    train = tmp_path / "images" / "train"
    cut = sorted(train.glob("*.jpg"))[1]
    cut.write_bytes(cut.read_bytes()[:-200])
    assert str(cut) in JDataset(train, imgsz=IMGSZ, augment=False).im_files
    (tmp_path / "labels" / "train.cache.npy").unlink()
    logged = []
    LOGGER.addFilter(lambda record: logged.append(record.getMessage()) or True)
    try:
        tds = TDataset(train, imgsz=IMGSZ, augment=False, device="cpu")
    finally:
        LOGGER.filters.clear()
    assert str(cut) not in tds.im_files and len(tds) == 2
    assert any(cut.name in m and "corrupt image" in m and "truncated JPEG" in m for m in logged), logged
    with pytest.raises(ValueError, match=f"{cut.name}: truncated JPEG"):
        image_io.imread(cut, device="cpu")


DETS = np.array([[1.234567, 2.5, 30.125, 40.999, 0.876543, 0], [10.0, 0.004, 79.995, 47.5, 0.25, 2],
                 [5.5, 6.5, 27.5, 38.5, 0.1234567, 7], [60.0, 20.0, 79.0, 47.0, 0.5, 0]], np.float32)
NAMES = {0: "person", 1: "bicycle", 2: "car"}


@pytest.fixture(scope="module")
def results():
    img = seeded_images(1, 9)[0][:48, :80].copy()
    return Results(img, "a.jpg", NAMES, DETS, device="cpu"), JResults(img, "a.jpg", NAMES, DETS)


def test_boxes_conversions_match_jax(results):
    t, j = results
    for k in ("xyxy", "conf", "cls", "xywh", "xyxyn", "xywhn"):
        got, want = getattr(t.boxes, k), getattr(j.boxes, k)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)


def test_results_text_methods_match_jax(results, tmp_path):
    t, j = results
    for conf in (False, True):
        t.save_txt(tmp_path / "t" / f"{conf}.txt", save_conf=conf)
        j.save_txt(tmp_path / "j" / f"{conf}.txt", save_conf=conf)
        assert (tmp_path / "t" / f"{conf}.txt").read_bytes() == (tmp_path / "j" / f"{conf}.txt").read_bytes()
    assert t.to_dict() == j.to_dict()
    assert t.tojson() == j.tojson() and t.tojson(normalize=True) == j.tojson(normalize=True)
    assert t.verbose() == j.verbose() == "2 persons, 1 car, 1 7, "
    empty = np.zeros((0, 6), np.float32)
    te, je = Results(t.orig_img, "b.jpg", NAMES, empty), JResults(j.orig_img, "b.jpg", NAMES, empty)
    assert te.verbose() == je.verbose() and te.tojson() == je.tojson() and te.to_dict() == je.to_dict() == []
    te.save_txt(tmp_path / "te.txt")
    je.save_txt(tmp_path / "je.txt")
    assert (tmp_path / "te.txt").read_bytes() == (tmp_path / "je.txt").read_bytes()


@pytest.mark.parametrize("file_name", ["im.jpg", "crop.png"])
def test_save_crop_writes_jaxs_files(results, tmp_path, file_name):
    """The same files under the same names; a JPEG crop has OpenCV's bytes
    (libjpeg with ``cv2.imwrite``'s settings), a PNG crop its pixels."""
    t, j = results
    t.save_crop(tmp_path / "t", file_name)
    j.save_crop(tmp_path / "j", file_name)
    got = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.*"))
    assert got == sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.*")) and len(got) == 4
    for rel in got:
        if rel.suffix == ".jpg":
            assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
        np.testing.assert_array_equal(image_io.imread(tmp_path / "t" / rel, device="cpu"),
                                      cv2.imread(str(tmp_path / "j" / rel)))
