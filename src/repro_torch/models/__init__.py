from repro_torch.models.registry import (
    ModelFns,
    cls_logits,
    cls_loss,
    get_loss_fn,
    get_model,
    lm_loss,
    split_cls_loss,
    split_lm_loss,
)
