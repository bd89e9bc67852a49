from obman_train_tpu_torch.train.steps import (
    OptaxRMSprop,
    TrainState,
    create_train_state,
    lr_schedule,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "OptaxRMSprop",
    "TrainState",
    "create_train_state",
    "lr_schedule",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
]
