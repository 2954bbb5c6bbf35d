"""Tensor ops of the predict path: boxes, anchors and DFL decode, NMS."""
