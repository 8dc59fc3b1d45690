from repro_torch.train.loop import Preemption, TrainLoop
from repro_torch.train.precision import (POLICIES, Precision, cast_floating,
                                         get_precision)
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_eval_step, make_loss_and_grads,
                                    make_train_step)

__all__ = ["TrainState", "make_train_step", "make_loss_and_grads",
           "make_eval_step",
           "init_train_state", "TrainLoop", "Preemption",
           "Precision", "POLICIES", "get_precision", "cast_floating"]
