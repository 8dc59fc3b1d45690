from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    get_optimizer,
    lamb,
    sgd,
    sgdm,
)
from repro_torch.optim.schedules import (constant, cosine, step_decay,
                                         warmup_cosine)

__all__ = [
    "Optimizer", "sgd", "sgdm", "adam", "adamw", "lamb", "get_optimizer",
    "constant", "cosine", "step_decay", "warmup_cosine",
]
