from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    apply_updates,
    sgd,
    yogi,
)
