"""The port's HTTP server (``experiment_yolo_torch/serve.py``) on the CPU:
``/health``, BMP and base64 JSON request bodies, detections equal to
``DetectionPredictor``'s on the same images, the coalescing of concurrent
requests, JPEG and PNG bodies answered as the BMP of the same pixels, and the
refusal of bodies it cannot decode yet (WebP, TIFF). The
wire format against the JAX package's server: ``serialize_results`` on the
same detections, and the answers and ``/health`` of both servers, each
serving the same weights, to the same requests. LD-P2 n with seeded
weights, batch 2 at 64 px, on ephemeral ports of 127.0.0.1."""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from experiment_yolo_torch import YOLO
from experiment_yolo_torch.data.image_io import imwrite
from experiment_yolo_torch.engine.checkpoint import save_checkpoint
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.results import Results
from experiment_yolo_torch.serve import DetectionServer, serialize_results
from experiment_yolo_torch.utils.seeded import seeded_images, seeded_model
from experiment_yolo_tpu.engine.model import YOLO as JaxYOLO
from experiment_yolo_tpu.engine.results import Results as JaxResults
from experiment_yolo_tpu.serve import DetectionServer as JaxServer
from experiment_yolo_tpu.serve import serialize_results as jax_serialize_results
from experiment_yolo_tpu.utils.torch_convert import convert_state_dict

CFG, IMGSZ, BATCH = "yolov8-LD-P2.yaml", 64, 2


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("serve")
    ckpt = save_checkpoint(root / "seeded.pt", seeded_model(CFG, 0, device="cpu"))
    server = DetectionServer(str(ckpt), batch=BATCH, imgsz=IMGSZ, max_wait_ms=50.0, device="cpu")
    port = server.start(host="127.0.0.1", port=0)
    images = seeded_images(6, 0)
    bodies = []
    for i, img in enumerate(images):
        imwrite(root / f"{i}.bmp", img)
        bodies.append((root / f"{i}.bmp").read_bytes())
    yield dict(server=server, url=f"http://127.0.0.1:{port}", images=images, bodies=bodies, ckpt=ckpt)
    server.stop()
    torch.set_num_threads(n)


def _post(url, body, json_body=False):
    headers = {"Content-Type": "application/json"} if json_body else {}
    req = urllib.request.Request(f"{url}/predict", data=body, headers=headers)
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def _predictor(served):
    return DetectionPredictor(served["server"].yolo.model, {"batch": BATCH, "imgsz": IMGSZ, "conf": 0.25})


def test_bmp_and_base64_bodies_give_the_predictors_detections(served):
    want = _predictor(served)(served["images"][:2])
    for body, res in zip(served["bodies"][:2], want):
        raw = _post(served["url"], body)
        b64 = _post(served["url"], json.dumps({"image": base64.b64encode(body).decode()}).encode(), json_body=True)
        assert raw["detections"] == b64["detections"] == serialize_results(res)["detections"]
        assert len(raw["detections"]) > 0 and raw["speed_ms"] > 0


def test_concurrent_requests_are_coalesced_and_counted(served):
    """Six requests from three threads: every answer equals the predictor's,
    and /health counts them in batches of at most the server's batch."""
    before = dict(served["server"].batcher.stats)
    answers = [None] * 6

    def client(k):
        for i in range(k, 6, 3):
            answers[i] = _post(served["url"], served["bodies"][i])

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = _predictor(served)(served["images"])
    for got, res in zip(answers, want):
        assert got["detections"] == serialize_results(res)["detections"]
    health = json.loads(urllib.request.urlopen(f"{served['url']}/health", timeout=60).read())
    stats = health["batching"]
    assert health["status"] == "ok" and health["batch"] == BATCH and health["imgsz"] == IMGSZ
    assert health["model"] == CFG and health["queue"] == 0  # the YAML the checkpoint's model was built from
    assert stats["items"] - before["items"] == 6 and 3 <= stats["batches"] - before["batches"] <= 6
    assert stats["max_batch"] <= BATCH


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_jpeg_and_png_bodies_answer_415_naming_the_queue_item(served, fmt, tmp_path):
    """A JPEG or PNG body, raw or base64, answers what the BMP of the same
    pixels answers (OpenCV decodes the JPEG for the BMP; the port's libjpeg
    gives the same bytes); a WebP or TIFF body still answers 415, naming
    ROADMAP.md queue 1 item 3.5."""
    import cv2

    for img in served["images"][:2]:
        body = bytes(cv2.imencode(".jpg" if fmt == "JPEG" else ".png", img)[1])
        imwrite(tmp_path / "same.bmp", cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR))
        want = _post(served["url"], (tmp_path / "same.bmp").read_bytes())["detections"]
        b64 = json.dumps({"image": base64.b64encode(body).decode()}).encode()
        assert _post(served["url"], body)["detections"] == want
        assert _post(served["url"], b64, json_body=True)["detections"] == want
        assert len(want) > 0
    for body in (b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(16), b"II*\x00" + bytes(16)):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(served["url"], body)
        assert err.value.code == 415
        msg = json.loads(err.value.read())["error"]
        assert "WebP and TIFF bodies" in msg and "ROADMAP.md queue 1 item 3.5" in msg


def test_malformed_requests_and_unknown_paths(served):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(served["url"], b"not an image, but longer than a BMP header would be: " * 2)
    assert err.value.code == 400 and "not a BMP" in json.loads(err.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as err:  # a truncated JPEG: the client's error
        _post(served["url"], b"\xff\xd8\xff\xe0\x00\x10JFIF")
    assert err.value.code == 400 and "truncated JPEG" in json.loads(err.value.read())["error"]
    for req in (urllib.request.Request(f"{served['url']}/nope"),
                urllib.request.Request(f"{served['url']}/health", data=b"x")):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 404


def test_a_facade_can_be_served_and_stopping_fails_queued_requests():
    yolo = YOLO(CFG, device="cpu")
    server = DetectionServer(yolo, batch=1, imgsz=IMGSZ, device="cpu")
    assert server.yolo is yolo and yolo.model.yaml["yaml_file"] == CFG
    fut = server.batcher.submit(np.zeros((8, 8, 3), np.uint8))  # never started: stop() fails it
    server.stop()
    with pytest.raises(RuntimeError, match="server stopped"):
        fut.result(timeout=5)


def test_serialize_results_matches_jax_on_the_same_detections():
    """One image's detections, a class without a name among them, through
    both packages' ``serialize_results``: the same dict."""
    img = np.zeros((48, 80, 3), np.uint8)
    dets = np.array([[1.234567, 2.5, 30.125, 40.999, 0.876543, 0], [10.0, 0.004, 79.995, 47.5, 0.25, 2],
                     [5.5, 6.5, 7.5, 8.5, 0.1234567, 7]], np.float32)
    names = {0: "person", 1: "bicycle", 2: "car"}
    got = serialize_results(Results(img, "a.bmp", names, dets))
    assert got == jax_serialize_results(JaxResults(img, "a.bmp", names, dets))
    assert [d["name"] for d in got["detections"]] == ["person", "car", "7"]
    empty = np.zeros((0, 6), np.float32)
    assert serialize_results(Results(img, "b.bmp", names, empty)) == \
        jax_serialize_results(JaxResults(img, "b.bmp", names, empty)) == {"detections": []}


@pytest.fixture(scope="module")
def against_jax(served):
    """The port's and the JAX package's servers, each serving ``served``'s
    weights from the model YAML, answer the same three BMP bodies, sent one
    at a time; then each one's ``/health``."""
    state = served["server"].yolo.model.state_dict()
    port_yolo = YOLO(CFG, device="cpu")
    port_yolo.model.load_state_dict(state)
    jax_yolo = JaxYOLO(CFG)
    jax_yolo.variables = convert_state_dict({k: v.numpy() for k, v in state.items()
                                             if not k.endswith("num_batches_tracked")}, jax_yolo.model)
    out = {}
    for side, server in (("port", DetectionServer(port_yolo, batch=BATCH, imgsz=IMGSZ, device="cpu")),
                         ("jax", JaxServer(jax_yolo, batch=BATCH, imgsz=IMGSZ))):
        url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
        try:
            answers = [_post(url, body) for body in served["bodies"][:3]]
            health = json.loads(urllib.request.urlopen(f"{url}/health", timeout=60).read())
        finally:
            server.stop()
        out[side] = answers, health
    return out


def test_answers_match_the_jax_servers(against_jax):
    """The same keys, the same detections in the same order: classes and
    names equal, boxes and confidences within one step of the rounding both
    servers apply (0.01 px, 1e-4)."""
    for got, want in zip(against_jax["port"][0], against_jax["jax"][0]):
        assert got.keys() == want.keys() == {"detections", "speed_ms"}
        assert len(got["detections"]) == len(want["detections"]) > 0
        for g, w in zip(got["detections"], want["detections"]):
            assert g.keys() == w.keys() and (g["cls"], g["name"]) == (w["cls"], w["name"])
            assert np.allclose(g["box"], w["box"], rtol=0, atol=0.01 + 1e-9), (g, w)
            assert abs(g["conf"] - w["conf"]) <= 1e-4 + 1e-9, (g, w)


def test_health_matches_the_jax_servers(against_jax):
    """``/health`` after the same three requests: the same payload, the model
    YAML's name, the fixed shape, the empty queue and the batching counts
    (three batches of one) alike."""
    health = against_jax["port"][1]
    assert health == against_jax["jax"][1]
    assert health == {"status": "ok", "model": CFG, "batch": BATCH, "imgsz": IMGSZ, "queue": 0,
                      "batching": {"batches": 3, "items": 3, "max_batch": 1}}
