from repro_torch.peft.lora import (
    count_trainable,
    default_lora_targets,
    init_peft,
    peft_layer_groups,
    target_dims,
)
