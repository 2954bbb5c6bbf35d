"""An HTTP detection server with dynamic batching.

Port of ``experiment_yolo_tpu/serve.py`` (``_Batcher``, ``DetectionServer``,
``serialize_results``): one :class:`DetectionPredictor` at a fixed
``(batch, imgsz)`` behind a batching window.

- every request is decoded on the host and queued; a collector thread takes
  requests for up to ``max_wait_ms`` or until the batch is full, and runs
  them as one predictor call (a short batch is padded to the fixed shape by
  the predictor), so one batch of requests costs one forward;
- HTTP is the standard library's ``ThreadingHTTPServer``.

API::

    GET  /health   -> {"status": "ok", "model" (the model YAML's path as given),
                       "batch", "imgsz", "queue",
                       "batching": {"batches", "items", "max_batch"}}
    POST /predict  body = the bytes of a JPEG, PNG or 24-bit BMP file, or JSON
                   {"image": <base64 of them>};
                   -> {"detections": [{"box": [x1, y1, x2, y2], "conf", "cls",
                       "name"}], "speed_ms"}

Bodies are decoded by ``data/image_io.py`` as ``cv2.imdecode`` decodes them
in the JAX server, JPEGs for the model's device (nvJPEG on the card, libjpeg
on the CPU). A WebP or TIFF body answers 415, naming ROADMAP.md queue 1 item
3.5; a body that is no image, or a broken one, answers 400.

Usage::

    server = DetectionServer("best.pt", batch=8, imgsz=640)
    port = server.start(port=0)      # returns at once (daemon threads)
    ...
    server.stop()
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from experiment_yolo_torch.data.codec import decode
from experiment_yolo_torch.utils import LOGGER


class _Batcher:
    """Collects requests into fixed-shape batches for one predictor."""

    def __init__(self, predictor, batch: int, max_wait_ms: float):
        self.predictor = predictor
        self.batch = batch
        self.max_wait = max_wait_ms / 1000.0
        self.q: "queue.Queue[tuple]" = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        # served on /health: batches run, requests in them, the largest batch coalesced
        self.stats = {"batches": 0, "items": 0, "max_batch": 0}

    def submit(self, img: np.ndarray) -> Future:
        fut: Future = Future()
        self.q.put((img, fut))
        return fut

    def _collect(self) -> List[tuple]:
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait
        while len(items) < self.batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                items.append(self.q.get(timeout=left))
            except queue.Empty:
                break
        return items

    def _loop(self) -> None:
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            self.stats["batches"] += 1
            self.stats["items"] += len(items)
            self.stats["max_batch"] = max(self.stats["max_batch"], len(items))
            try:
                t0 = time.perf_counter()
                results = self.predictor([im for im, _ in items])
                dt = (time.perf_counter() - t0) * 1000
                for (_, fut), res in zip(items, results):
                    if not fut.cancelled():
                        fut.set_result((res, dt / len(items)))
            except Exception as e:  # fail every request of the batch, keep serving
                for _, fut in items:
                    if not fut.cancelled():
                        fut.set_exception(e)


class DetectionServer:
    """HTTP detection service over one :class:`DetectionPredictor` at a fixed
    ``(batch, imgsz)``, on the card unless ``device='cpu'``. ``model`` is a
    :class:`~experiment_yolo_torch.engine.model.YOLO` or what ``YOLO`` takes
    (a model YAML or a checkpoint ``.pt``); ``overrides`` are the predictor's
    ``default.yaml`` keys."""

    def __init__(self, model, batch: int = 8, imgsz: int = 640, conf: float = 0.25, max_wait_ms: float = 10.0,
                 device="cuda", **overrides):
        from experiment_yolo_torch.engine.model import YOLO
        from experiment_yolo_torch.engine.predictor import DetectionPredictor

        self.yolo = model if isinstance(model, YOLO) else YOLO(str(model), device=device)
        self.predictor = DetectionPredictor(self.yolo.model, {"batch": batch, "imgsz": imgsz, "conf": conf,
                                                              "verbose": False, **overrides})
        self.batch, self.imgsz = self.predictor.batch, self.predictor.imgsz
        self.batcher = _Batcher(self.predictor, self.batch, max_wait_ms)
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 8000) -> int:
        """Start the batching and HTTP threads after one warm-up batch; returns
        the bound port (``port=0`` binds an ephemeral one)."""
        self.warmup()
        self.batcher.thread.start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: the server logs through LOGGER
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok", "model": server.yolo.model.yaml.get("yaml_file", "model"),
                                     "batch": server.batch,
                                     "imgsz": server.imgsz, "queue": server.batcher.q.qsize(),
                                     "batching": dict(server.batcher.stats)})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                    if self.headers.get("Content-Type", "").startswith("application/json"):
                        raw = base64.b64decode(json.loads(raw)["image"])
                    img = server._decode(raw)
                except NotImplementedError as e:  # a format the port cannot decode yet
                    self._send(415, {"error": f"{type(e).__name__}: {e}"})
                    return
                except Exception as e:  # a malformed request: the client's error
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    self._send(200, server.predict_one(img))
                except Exception as e:  # an inference or device fault: the server's
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._http_thread.start()
        bound = self.httpd.server_address[1]
        LOGGER.info(f"serve: listening on {host}:{bound} (batch={self.batch}, imgsz={self.imgsz})")
        return bound

    def stop(self) -> None:
        """Stop serving: close the HTTP server, end the batching thread, and
        fail the requests still queued."""
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
        self.batcher._stop.set()
        if self.batcher.thread.is_alive():
            self.batcher.thread.join(timeout=60)
        while True:
            try:
                _, fut = self.batcher.q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("server stopped"))

    def warmup(self) -> None:
        """One batch through the predictor before traffic (cuDNN picks its algorithms)."""
        self.predictor([np.zeros((self.imgsz, self.imgsz, 3), np.uint8)])

    # -- inference ----------------------------------------------------------
    def _decode(self, raw: bytes) -> np.ndarray:
        """A request body -> (H, W, 3) uint8 BGR: a JPEG, PNG or 24-bit BMP."""
        if (raw[:4] == b"RIFF" and raw[8:12] == b"WEBP") or raw[:4] in (b"II*\x00", b"MM\x00*"):
            raise NotImplementedError("WebP and TIFF bodies are not decoded by experiment_yolo_torch yet "
                                      "(ROADMAP.md queue 1 item 3.5); send a JPEG, PNG or BMP")
        return decode(raw, "request body", self.yolo.model.device)

    def predict_one(self, img: np.ndarray) -> dict:
        res, batch_ms = self.batcher.submit(img).result(timeout=60)
        return {**serialize_results(res), "speed_ms": round(batch_ms, 2)}


def serialize_results(res) -> dict:
    """One image's :class:`Results` -> a JSON-safe dict of its detections."""
    names = res.names or {}
    return {"detections": [{"box": [round(float(v), 2) for v in b.tolist()], "conf": round(float(c), 4),
                            "cls": int(k), "name": str(names.get(int(k), int(k)))}
                           for b, c, k in zip(res.boxes.xyxy, res.boxes.conf, res.boxes.cls)]}
