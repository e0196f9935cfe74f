from repro_torch.peft.lora import default_lora_targets, init_peft, target_dims
