"""The LM's training: the train and eval steps and the straggler monitor
(the port of ``repro.train``)."""
from .step import make_eval_step, make_train_step
from .straggler import StragglerMonitor

__all__ = ["make_train_step", "make_eval_step", "StragglerMonitor"]
