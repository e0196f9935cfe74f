from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    momentum,
    sgd,
    yogi,
)
