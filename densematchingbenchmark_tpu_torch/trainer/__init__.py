"""Training of the port: optimizer and schedule, train state, train step
and the epoch loop (counterparts of densematchingbenchmark_tpu/trainer/)."""

from .loop import train_matcher
from .optim import build_optimizer, make_lr_schedule
from .state import TrainState
from .train_step import make_flow_train_step, make_train_step

__all__ = ["train_matcher", "build_optimizer", "make_lr_schedule",
           "TrainState", "make_train_step", "make_flow_train_step"]
