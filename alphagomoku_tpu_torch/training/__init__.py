from .train import (
    TrainConfig,
    TrainState,
    RAdam,
    create_train_state,
    draw_modes,
    make_train_step,
    make_eval_step,
    make_distill_step,
    schedule,
    average_params,
)
from .manager import ManagerConfig, TrainingManager

__all__ = [
    "TrainConfig",
    "TrainState",
    "RAdam",
    "create_train_state",
    "draw_modes",
    "make_train_step",
    "make_eval_step",
    "make_distill_step",
    "schedule",
    "average_params",
    "ManagerConfig",
    "TrainingManager",
]
