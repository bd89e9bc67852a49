from obman_train_tpu_torch.native.build import load_imageproc_lib, load_physics_lib

__all__ = ["load_imageproc_lib", "load_physics_lib"]
