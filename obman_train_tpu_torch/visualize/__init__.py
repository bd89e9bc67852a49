"""Figures of the port (the JAX package's ``visualize/``): numpy and
matplotlib on host arrays, no torch."""

from obman_train_tpu_torch.visualize.displaymano import save_pck_img, visualize_batch
from obman_train_tpu_torch.visualize.viz2d import visualize_joints_2d

__all__ = ["visualize_joints_2d", "visualize_batch", "save_pck_img"]
