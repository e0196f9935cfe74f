from repro_torch.peft.lora import init_peft, target_dims
