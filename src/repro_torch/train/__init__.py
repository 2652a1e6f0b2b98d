"""The training loop: train step, microbatch accumulation, fault drill,
straggler watchdog.  Counterpart of the JAX package's ``train/``."""
from .trainer import (TrainConfig, Trainer, make_train_step,  # noqa: F401
                      pick_microbatches)
from .fault import SimulatedFailure, StragglerWatchdog  # noqa: F401
