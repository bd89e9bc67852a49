from obman_train_tpu_torch.simulation.intersect import intersect_vox
from obman_train_tpu_torch.simulation.savemano import load_batch_info, save_obj
from obman_train_tpu_torch.simulation.simulate import full_simul, run_simulation

__all__ = [
    "run_simulation",
    "full_simul",
    "intersect_vox",
    "load_batch_info",
    "save_obj",
]
