"""PyTorch + CUDA port of the DEAL-YOLO detector (and its segmentation and pose families) for NVIDIA Hopper.

Sibling of ``experiment_yolo_tpu`` (the JAX reference): NCHW tensors,
Ultralytics state-dict names, and hand-written ``sm_90a`` kernels for the
DFL decode and its backward, hard-NMS suppression, Gaussian soft-NMS, the
LDConv bilinear gather and its backward, and the selective scan of the
Mamba/VSS blocks. It imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from experiment_yolo_torch.engine.model import YOLO
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.engine.validator import DetectionValidator
from experiment_yolo_torch.engine.validators_extra import PoseValidator, SegmentationValidator
from experiment_yolo_torch.nn.tasks import DetectionModel, PoseModel, SegmentationModel

__all__ = ["YOLO", "DetectionModel", "DetectionPredictor", "DetectionTrainer", "DetectionValidator", "PoseModel",
           "PoseValidator", "SegmentationModel", "SegmentationValidator", "__version__"]
