from obman_train_tpu_torch.train.metrics import AverageMeters, EvalUtil
from obman_train_tpu_torch.train.steps import (
    OptaxRMSprop,
    TrainState,
    create_train_state,
    dropout_generator,
    lr_schedule,
    make_eval_step,
    make_optimizer,
    make_train_step,
    points_generator,
)

__all__ = [
    "AverageMeters",
    "EvalUtil",
    "OptaxRMSprop",
    "TrainState",
    "create_train_state",
    "dropout_generator",
    "lr_schedule",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "points_generator",
]
