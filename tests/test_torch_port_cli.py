"""The port's CLI (``experiment_yolo_torch/cfg/cli.py``) against the JAX
package's: ``parse_key_value`` and the unknown-key refusal on the same argv,
``train``, ``val`` and ``predict`` at ``device=cpu`` on a synthetic BMP
dataset (4 train and 2 val images at 64 px), the special modes, and the
modes that are not ported. The port's CPU loops run on one torch thread."""

import json
import logging

import numpy as np
import pytest
import torch
import yaml

from experiment_yolo_torch import YOLO
from experiment_yolo_torch.cfg import check_dict_alignment, default_cfg
from experiment_yolo_torch.cfg.cli import MODES, UNPORTED, entrypoint, parse_key_value
from experiment_yolo_torch.data import make_synthetic_dataset
from experiment_yolo_torch.nn.tasks import yaml_model_load
from experiment_yolo_torch.utils import LOGGER
from experiment_yolo_tpu.cfg import DEFAULT_CFG_DICT
from experiment_yolo_tpu.cfg import check_dict_alignment as jax_check_dict_alignment
from experiment_yolo_tpu.cfg.cli import MODES as JAX_MODES
from experiment_yolo_tpu.cfg.cli import parse_key_value as jax_parse_key_value


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def logged():
    """The messages of the port's logger during a test."""
    class Records(logging.Handler):
        def __init__(self):
            super().__init__()
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    handler = Records()
    LOGGER.addHandler(handler)
    yield handler.messages
    LOGGER.removeHandler(handler)


@pytest.mark.parametrize("argv", [
    ["epochs=3", "imgsz=640", "lr0=0.01", "amp=False", "name=exp", "conf=None", "classes=[0, 2]"],
    ["model=runs/detect/train/weights/best.pt", "data=data.yaml", "device=cpu", "save=true", "project="],
    ["scale=(0.5, 1.5)", "mode=val", "iou=.7", "tracker=bytetrack.yaml", "x=1e-3", "y=-2"]])
def test_parse_key_value_matches_jax(argv):
    assert parse_key_value(argv) == jax_parse_key_value(argv)


def test_a_token_without_equals_raises_as_in_jax():
    for fn in (parse_key_value, jax_parse_key_value):
        with pytest.raises(SyntaxError, match="'epochs' is not key=value"):
            fn(["epochs"])


def test_unknown_key_raises_syntax_error_as_in_jax():
    """The same message, close matches included, from the port's
    ``check_dict_alignment`` and the CLI as from the JAX package's."""
    custom = {"epochz": 3, "imgsize": 640}
    with pytest.raises(SyntaxError) as jax_err:
        jax_check_dict_alignment({**DEFAULT_CFG_DICT, "model": None, "source": None}, custom)
    with pytest.raises(SyntaxError) as port_err:
        check_dict_alignment({**default_cfg(), "model": None, "source": None}, custom)
    assert str(port_err.value) == str(jax_err.value)
    assert "'epochz' is not a valid config key — did you mean ['epochs', 'warmup_epochs']?" in str(jax_err.value)
    with pytest.raises(SyntaxError, match="'epochz' is not a valid config key"):
        entrypoint(["val", "model=yolov8-LD-P2.yaml", "epochz=3", "device=cpu"])


def test_modes_are_the_jax_clis_and_the_unported_raise():
    assert MODES == JAX_MODES
    for mode in UNPORTED:
        with pytest.raises(NotImplementedError, match=f"mode '{mode}' .*ROADMAP.md queue 1 item 10"):
            entrypoint([mode, "model=yolov8-LD-P2.yaml"])
    with pytest.raises(SyntaxError, match="invalid mode 'fit'"):
        entrypoint(["fit"])
    with pytest.raises(SyntaxError, match="'model=' is required"):
        entrypoint(["val", "data=x.yaml"])


def test_special_modes(tmp_path, monkeypatch, logged):
    from experiment_yolo_torch import __version__

    assert entrypoint([]) is None
    assert entrypoint(["version"]) == __version__ == "0.1.0"
    assert entrypoint(["cfg"]) is None
    assert entrypoint(["checks"]) is None
    monkeypatch.chdir(tmp_path)
    dst = entrypoint(["copy-cfg"])
    assert dst == tmp_path / "default_copy.yaml" and yaml.safe_load(dst.read_text()) == default_cfg()
    out = "\n".join(logged)
    assert "yolo-torch MODE ARGS" in out and "\namp=True\n" in out and "\ntorch " in out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``train`` from a model YAML with nc=3, then ``val`` and ``predict`` of its best.pt."""
    root = tmp_path_factory.mktemp("cli")
    data = make_synthetic_dataset(root / "data", n_train=4, n_val=2, imgsz=64, seed=0)
    cfg = root / "ld3.yaml"
    cfg.write_text(yaml.safe_dump({**yaml_model_load("yolov8-LD-P2.yaml"), "nc": 3}))
    common = [f"data={data}", "imgsz=64", "batch=2", "workers=2", "device=cpu", "verbose=False"]
    metrics = entrypoint(["train", f"model={cfg}", "epochs=1", "optimizer=SGD", f"project={root / 'runs'}", *common])
    best = root / "runs" / "train" / "weights" / "best.pt"
    logged = []
    LOGGER.addFilter(lambda record: logged.append(record.getMessage()) or True)
    try:
        stats = entrypoint(["val", f"model={best}", *common])
    finally:
        LOGGER.filters.clear()
    results = entrypoint(["predict", f"model={best}", f"source={data.parent / 'images' / 'val'}", "imgsz=64",
                          "conf=0.0001", "device=cpu"])
    return dict(data=data, best=best, metrics=metrics, stats=stats, results=results, logged=logged)


def test_train_val_predict_on_the_cpu(run):
    """``train`` trains (bf16 by default) and writes best.pt; ``val`` of it
    equals the facade's ``val`` and logs the stats as JSON; ``predict``
    reads the folder's BMP images and equals the facade's ``predict``."""
    assert run["metrics"]["epochs_run"] == 1 and run["best"].is_file()
    yolo = YOLO(run["best"], device="cpu")
    assert run["stats"] == yolo.val(data=str(run["data"]), imgsz=64, batch=2, workers=2, verbose=False)
    from experiment_yolo_torch.data.image_io import imread

    images = [imread(p) for p in sorted((run["data"].parent / "images" / "val").iterdir())]
    want = yolo.predict(images, imgsz=64, conf=0.0001)
    assert len(run["results"]) == len(want) == 2
    for a, b in zip(run["results"], want):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    lines = [m for m in run["logged"] if m.startswith("val: {")]
    assert len(lines) == 1 and json.loads(lines[0][len("val: "):]) == run["stats"]


def test_predict_sources_it_cannot_read(run, tmp_path):
    with pytest.raises(FileNotFoundError, match="queue 1 item 3.3"):
        entrypoint(["predict", f"model={run['best']}", f"source={tmp_path / 'video.mp4'}", "device=cpu"])
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(NotImplementedError, match="needs a decoder library"):
        entrypoint(["predict", f"model={run['best']}", f"source={tmp_path}", "device=cpu"])
    with pytest.raises(SyntaxError, match="'source=' is required"):
        entrypoint(["predict", f"model={run['best']}", "device=cpu"])
