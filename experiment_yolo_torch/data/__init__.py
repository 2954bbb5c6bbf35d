"""Data: YOLO-format datasets, augmentations, the threaded loader, image files and the synthetic dataset."""

from experiment_yolo_torch.data.build import DataLoader, build_dataloader, build_yolo_dataset
from experiment_yolo_torch.data.dataset import YOLODataset, check_det_dataset
from experiment_yolo_torch.data.synthetic import make_synthetic_dataset, make_synthetic_task_dataset

__all__ = ["DataLoader", "YOLODataset", "build_dataloader", "build_yolo_dataset", "check_det_dataset",
           "make_synthetic_dataset", "make_synthetic_task_dataset"]
