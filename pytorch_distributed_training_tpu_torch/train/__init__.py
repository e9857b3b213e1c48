"""Training layer of the port: precision policy, optimizer
transformations, state, the train/eval steps and the epoch loop."""

from .policy import Policy, make_policy
from .state import TrainState, create_train_state, infer_state_shardings
from .step import make_eval_step, make_train_step, step_objective
from .trainer import Trainer, TrainerConfig

__all__ = [
    "Policy", "make_policy", "TrainState", "create_train_state",
    "infer_state_shardings",
    "make_train_step", "make_eval_step", "step_objective", "Trainer",
    "TrainerConfig",
]
