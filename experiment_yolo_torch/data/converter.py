"""DOTA annotations to YOLO-OBB labels.

Port of ``experiment_yolo_tpu/data/converter.py``'s ``DOTA_CLASSES`` and
``convert_dota_to_yolo_obb`` (the reference's ``converter.py:320-428``).
Each image's size comes from its header through ``data/image_io.py``, not
OpenCV; the label text is the JAX function's (``{c:.6g}``). The other
converters of that module (COCO, SAM) are not part of the port.
"""

from __future__ import annotations

from pathlib import Path

from experiment_yolo_torch.data import image_io

# DOTA v1/v2 category names -> contiguous YOLO-OBB class ids (DOTA v1.0's classes are the first 15)
DOTA_CLASSES = {
    "plane": 0, "ship": 1, "storage-tank": 2, "baseball-diamond": 3,
    "tennis-court": 4, "basketball-court": 5, "ground-track-field": 6,
    "harbor": 7, "bridge": 8, "large-vehicle": 9, "small-vehicle": 10,
    "helicopter": 11, "roundabout": 12, "soccer-ball-field": 13,
    "swimming-pool": 14, "container-crane": 15, "airport": 16, "helipad": 17,
}


def image_size(path: Path):
    """(h, w) of an image as ``cv2.imread`` would decode it, from its header;
    ``FileNotFoundError`` for a file that does not decode, as the JAX tools
    raise when ``cv2.imread`` gives None."""
    try:
        return image_io.image_shape(path, whole=True)
    except (ValueError, NotImplementedError, OSError):
        raise FileNotFoundError(f"could not read image {path}") from None


def convert_dota_to_yolo_obb(dota_root_path: str) -> None:
    """DOTA original annotations -> YOLO-OBB labels. Expects
    ``images/{train,val}`` and ``labels/{train,val}_original`` (``x1 y1 ...
    x4 y4 category difficulty`` lines); writes the normalised corners, one
    ``cls x1 y1 ... x4 y4`` line an object, into ``labels/{train,val}``."""
    root = Path(dota_root_path)
    for phase in ("train", "val"):
        image_dir = root / "images" / phase
        orig_dir = root / "labels" / f"{phase}_original"
        save_dir = root / "labels" / phase
        save_dir.mkdir(parents=True, exist_ok=True)
        for image_path in sorted(image_dir.iterdir()):
            if image_path.suffix.lower() not in (".png", ".jpg", ".jpeg"):
                continue
            h, w = image_size(image_path)
            orig_label = orig_dir / f"{image_path.stem}.txt"
            out_lines = []
            if orig_label.exists():
                for line in orig_label.read_text().splitlines():
                    parts = line.strip().split()
                    if len(parts) < 9:
                        continue
                    cls = DOTA_CLASSES[parts[8]]
                    coords = [float(p) for p in parts[:8]]
                    norm = [c / w if i % 2 == 0 else c / h for i, c in enumerate(coords)]
                    out_lines.append(f"{cls} " + " ".join(f"{c:.6g}" for c in norm))
            (save_dir / f"{image_path.stem}.txt").write_text("\n".join(out_lines) + ("\n" if out_lines else ""))
