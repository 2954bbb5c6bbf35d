"""The port's ``YOLO`` facade (``experiment_yolo_torch/engine/model.py``).

``YOLO(...).train()`` with the defaults (bf16 compute) against
``DetectionTrainer.train()`` on the same model and dataset (bit-equal),
``val`` and ``predict`` against direct calls, ``save`` / ``load`` /
``YOLO(.pt)``, the JAX facade's methods that the port does not have, and the
facade's refusals. LD-P2 n (nc=3) on a synthetic BMP dataset of 4 train and 2
val images at 64 px, batch 2, one epoch; the port's CPU loops run on one torch
thread, as ``tests/test_torch_port_fit.py``'s do.
"""

import numpy as np
import pytest
import torch

from experiment_yolo_torch import YOLO
from experiment_yolo_torch.data import make_synthetic_dataset
from experiment_yolo_torch.data.image_io import imread
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.engine.validator import DetectionValidator
from experiment_yolo_torch.nn.tasks import DetectionModel, yaml_model_load

CFG, NC, IMGSZ, BATCH = "yolov8-LD-P2.yaml", 3, 64, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synthetic_dataset(tmp_path_factory.mktemp("facade") / "data", n_train=4, n_val=2, imgsz=IMGSZ, seed=0)


def _args(data, project):
    return {"data": str(data), "epochs": 1, "batch": BATCH, "imgsz": IMGSZ, "optimizer": "SGD", "workers": 2,
            "project": str(project), "verbose": False}


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """The facade and ``DetectionTrainer`` with the defaults (``amp`` too) on
    the same initial weights and data."""
    root = tmp_path_factory.mktemp("runs")
    yolo = YOLO(CFG, nc=NC, device="cpu", seed=0)
    events = []
    yolo.add_callback("on_train_epoch_start", lambda trainer: events.append("epoch"))
    metrics = yolo.train(**_args(data, root / "facade"))
    model = DetectionModel({**yaml_model_load(CFG), "nc": NC}, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    direct = DetectionTrainer(model, _args(data, root / "direct"))
    direct_metrics = direct.train()
    return dict(yolo=yolo, metrics=metrics, direct=direct, direct_metrics=direct_metrics, model=model,
                events=events)


def test_train_is_bit_equal_to_the_trainer_with_the_defaults(trained):
    """Same initial weights (the seeded generator), both in bf16 (``amp``
    defaults to True), the same metrics and the same best weights bit for
    bit; the facade keeps those weights, in its dtype and in eval mode."""
    yolo, direct = trained["yolo"], trained["direct"]
    assert yolo.trainer.dtype == direct.dtype == torch.bfloat16
    assert yolo.trainer.amp_check["passed"] and direct.amp_check["passed"]
    assert trained["metrics"] == trained["direct_metrics"]
    assert yolo.trainer.loss_items == direct.loss_items
    for k, v in direct.best_state.items():
        assert torch.equal(yolo.model.state_dict()[k], v), k
        assert torch.equal(yolo.trainer.best_state[k], v), k
    assert yolo.model.dtype == torch.float32 and not yolo.model.training
    assert trained["events"] == ["epoch"]


def test_the_trainer_gives_the_model_back_in_its_dtype(trained):
    """``DetectionTrainer`` computes in bf16 while it trains, and its
    ``train()`` gives the caller's f32 model back in f32, when training ends
    and when it fails; a bf16 model comes back in bf16 from an f32 run."""
    model = trained["model"]
    assert trained["direct"].dtype == torch.bfloat16 and model.dtype == torch.float32
    with torch.no_grad():
        assert all(f.dtype == torch.float32 for f in model(torch.zeros(1, 3, IMGSZ, IMGSZ)))
    trainer = DetectionTrainer(model, {"batch": BATCH})  # no data: train() raises
    assert model.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="needs a dataset"):
        trainer.train()
    assert model.dtype == torch.float32
    model.dtype = torch.bfloat16
    trainer = DetectionTrainer(model, {"batch": BATCH, "amp": False})
    assert model.dtype == torch.float32
    with pytest.raises(ValueError, match="needs a dataset"):
        trainer.train()
    assert model.dtype == torch.bfloat16
    model.dtype = torch.float32


def test_initial_weights_equal_a_model_from_the_same_seed():
    a = YOLO(CFG, nc=NC, device="cpu", seed=3)
    b = DetectionModel({**yaml_model_load(CFG), "nc": NC}, device="cpu", generator=torch.Generator().manual_seed(3))
    c = YOLO(CFG, nc=NC, device="cpu", seed=4)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.model.state_dict().items())
    assert not all(torch.equal(v, c.model.state_dict()[k]) for k, v in a.model.state_dict().items())


def test_val_and_predict_equal_the_direct_calls(trained, data):
    yolo = trained["yolo"]
    args = {"data": str(data), "imgsz": IMGSZ, "batch": BATCH, "workers": 2, "verbose": False}
    assert yolo.val(**args) == DetectionValidator(args)(yolo.model)
    images = [imread(p) for p in sorted((data.parent / "images" / "val").iterdir())]
    kw = {"imgsz": IMGSZ, "batch": BATCH, "conf": 0.0001}
    got, want = yolo.predict(images, **kw), DetectionPredictor(yolo.model, kw)(images)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    np.testing.assert_array_equal(yolo(images[0], **kw)[0].boxes.data, want[0].boxes.data)


def test_save_load_round_trip_and_matched_counts(trained, tmp_path):
    yolo = trained["yolo"]
    yolo.save(tmp_path / "m.pt")
    again = YOLO(tmp_path / "m.pt", device="cpu")
    assert again.ckpt_path == str(tmp_path / "m.pt") and again.names == yolo.names and again.nc == NC
    assert all(torch.equal(v, again.model.state_dict()[k]) for k, v in yolo.model.state_dict().items())
    fresh = YOLO(CFG, nc=NC, device="cpu", seed=1)
    assert fresh.load(tmp_path / "m.pt") is fresh
    assert fresh.load_counts[0] == fresh.load_counts[1] == len(yolo.model.state_dict())
    assert all(torch.equal(v, fresh.model.state_dict()[k]) for k, v in yolo.model.state_dict().items())
    # heads swapped: nc=5 keeps every tensor but the class convs' last layer, weight and bias, at three levels
    other = YOLO(CFG, nc=5, device="cpu").load(tmp_path / "m.pt")
    matched, total = other.load_counts
    assert total == len(other.model.state_dict()) and total - matched == 6


def test_info_names_and_fuse(trained):
    yolo = trained["yolo"]
    n = sum(p.numel() for p in yolo.model.parameters())
    assert yolo.num_params() == n
    assert yolo.info() == f"DetectionModel(nc={NC}, strides=(4, 8, 16), params={n:,})"
    assert yolo.names == {0: "circle", 1: "square", 2: "triangle"}
    assert yolo.fuse() is yolo


def test_callbacks_register_clear_and_reset():
    yolo = YOLO(CFG, device="cpu")
    yolo.add_callback("on_train_end", print)
    yolo.add_callback("on_train_end", len)
    yolo.add_callback("on_fit_epoch_end", print)
    assert yolo._callbacks == {"on_train_end": [print, len], "on_fit_epoch_end": [print]}
    yolo.clear_callback("on_train_end")
    assert yolo._callbacks == {"on_fit_epoch_end": [print]}
    yolo.reset_callbacks()
    assert yolo._callbacks == {}


def test_scaled_names_and_dtype():
    """``yolov8n.yaml`` (the default) is ``yolov8.yaml`` at scale n; ``dtype``
    sets the compute dtype of val and predict."""
    assert YOLO(device="cpu").model.stride == (8, 16, 32)
    assert YOLO(CFG, device="cpu", dtype=torch.bfloat16).model.dtype == torch.bfloat16


@pytest.mark.parametrize("method,item", [
    ("track", "catalogue item 15"), ("benchmark", "catalogue item 15"), ("tune", "catalogue item 15"), ("export", "catalogue item 15"),
    ("embed", "catalogue item 15"), ("profile", "catalogue item 15")])
def test_unported_methods_raise_naming_their_item(method, item):
    with pytest.raises(NotImplementedError, match=f"YOLO.{method} .*ROADMAP.md {item}"):
        getattr(YOLO(CFG, device="cpu"), method)("image.jpg")


def test_refusals(tmp_path):
    """Files and folders are read now (missing ones raise as in the JAX
    package) and ``stream=True`` yields the results; videos, streams and WebP
    raise naming ROADMAP.md queue 1 item 3.5."""
    yolo = YOLO(CFG, device="cpu")
    img = np.zeros((32, 32, 3), np.uint8)
    for source in ("images/", tmp_path / "a.bmp", ["a.bmp"]):
        with pytest.raises(FileNotFoundError, match="not found"):
            yolo.predict(source)
    streamed = yolo.predict([img], stream=True, imgsz=64)
    assert not isinstance(streamed, list)
    np.testing.assert_array_equal(next(streamed).boxes.data, yolo.predict([img], imgsz=64)[0].boxes.data)
    (tmp_path / "clip.mp4").write_bytes(bytes(16))
    (tmp_path / "a.webp").write_bytes(b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(16))
    for source in (tmp_path / "clip.mp4", "rtsp://camera/1", 0, tmp_path / "a.webp"):
        with pytest.raises(NotImplementedError, match="queue 1 item 3.5"):
            yolo.predict(source)
    with pytest.raises(TypeError, match="unsupported source"):
        yolo.predict(3.5)
    with pytest.raises(NotImplementedError, match="catalogue item 13"):
        YOLO(CFG, device="cpu", task="classify")
    for task in ("segment", "pose"):  # ported, but this head is Detect
        with pytest.raises(ValueError, match="build a DetectionModel"):
            YOLO(CFG, device="cpu", task=task)
    with pytest.raises(NotImplementedError, match="catalogue item 15"):
        YOLO("model.onnx", device="cpu")
    with pytest.raises(ValueError, match="unsupported model source"):
        YOLO(tmp_path, device="cpu")
