"""The serving entry points of the port (the JAX package's ``demo/``)."""

from obman_train_tpu_torch.demo.attention import attention_overlay
from obman_train_tpu_torch.demo.export import export_model, load_exported
from obman_train_tpu_torch.demo.inference import DemoModel

__all__ = ["DemoModel", "attention_overlay", "export_model", "load_exported"]
