"""Inference sources: arrays, image files and folders of them.

Port of ``experiment_yolo_tpu/data/loaders.py`` (``IMG_FORMATS``,
``VID_FORMATS``, ``is_stream_source``, ``iter_images_and_videos``) for image
sources. The predictor consumes one generator of ``(label, BGR frame, meta)``
tuples, as in the JAX package: ``"array"`` for an array, the path for a file.
Files are decoded by ``data/image_io.py``, ``chunk`` files at a time, so that
a chunk's JPEGs are one nvJPEG call on the card.

Video files, webcams, RTSP/HTTP streams, YouTube URLs and screenshots (JAX
``loaders.py:66-224``) go through ``cv2.VideoCapture`` or ``mss`` in the JAX
package; the card's machine has no video decoder the port may use (no
``ffmpeg``), so they raise, naming ROADMAP.md queue 1 item 3.5.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Tuple, Union

import numpy as np

from experiment_yolo_torch.data import image_io

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}

Frame = Tuple[str, np.ndarray, dict]  # (label, BGR image, meta)


def unported_video(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to experiment_yolo_torch yet: it waits for a video decoder "
                               "on the card (ROADMAP.md queue 1 item 3.5); pass image files, folders or arrays")


def is_stream_source(source) -> bool:
    """True for webcam indices, ``*.streams`` lists and URL protocols, which the
    JAX package routes to ``LoadStreams``."""
    if isinstance(source, int):
        return True
    s = str(source)
    return (s.isnumeric() or s.endswith(".streams")
            or s.lower().startswith(("rtsp://", "rtmp://", "http://", "https://", "tcp://")))


def _entries(source) -> Iterator[Union[np.ndarray, Path]]:
    """The arrays and image files of ``source``, in the JAX package's order."""
    if isinstance(source, np.ndarray):
        yield source
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from _entries(s)
        return
    if is_stream_source(source):
        raise unported_video(f"stream source {source!r}")
    if not isinstance(source, (str, Path)):
        raise TypeError(f"unsupported source of type {type(source).__name__}: expected an (H, W, 3) uint8 BGR "
                        "array, an image file, a folder, or a list of them")
    p = Path(source)
    if p.is_dir():
        files = sorted(f for f in p.rglob("*") if f.suffix.lstrip(".").lower() in IMG_FORMATS | VID_FORMATS)
        if not files:
            raise FileNotFoundError(f"no images/videos in {p}")
        for f in files:
            yield from _entries(f)
        return
    if not p.is_file():
        raise FileNotFoundError(f"source {source} not found")
    if p.suffix.lstrip(".").lower() in VID_FORMATS:
        raise unported_video(f"video file {p}")
    yield p


def _decoded(group: List[Union[np.ndarray, Path]], device) -> Iterator[Frame]:
    files = [e for e in group if isinstance(e, Path)]
    try:
        imgs = iter(image_io.imread_many(files, device))
    except ValueError as e:
        raise ValueError(f"could not read image: {e}") from None
    for e in group:
        if isinstance(e, Path):
            yield str(e), next(imgs), {"kind": "image"}
        else:
            yield "array", e, {"kind": "image"}


def iter_images_and_videos(source, vid_stride: int = 1, device="cuda", chunk: int = 1) -> Iterator[Frame]:
    """Yield ``(label, BGR frame, meta)`` from arrays, image files and folders
    (recursive, sorted), as the JAX package's (``vid_stride`` steps through a
    video's frames there; videos raise here). JPEGs are decoded for
    ``device`` (nvJPEG on the card, libjpeg on the CPU), ``chunk`` files at a
    time."""
    group: List[Union[np.ndarray, Path]] = []
    for e in _entries(source):
        group.append(e)
        if len(group) >= chunk:
            yield from _decoded(group, device)
            group = []
    if group:
        yield from _decoded(group, device)


class LoadStreams:
    """Threaded multi-stream reader of the JAX package (``cv2.VideoCapture``): not ported."""

    def __init__(self, sources, vid_stride: int = 1, buffer: bool = False):
        raise unported_video(f"LoadStreams({sources!r})")


def load_screenshot(monitor: int = 0, region=None) -> Frame:
    """Screenshot source of the JAX package (``mss``): not ported."""
    raise unported_video("a screenshot source")
