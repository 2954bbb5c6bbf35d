"""PyTorch + CUDA port of the DEAL-YOLO detector for NVIDIA Hopper.

Sibling of ``experiment_yolo_tpu`` (the JAX reference): NCHW tensors,
Ultralytics state-dict names, and hand-written ``sm_90a`` kernels for the
DFL decode and its backward, hard-NMS suppression, and the LDConv bilinear
gather and its backward. It imports neither JAX nor the JAX package.
"""

from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.tasks import DetectionModel

__all__ = ["DetectionModel", "DetectionPredictor", "DetectionTrainer"]
