"""The paper's comparison arms (port of ``repro/core/baselines``):
backprop FL (FedAvg, FedYogi, FedSGD, FedAvgSplit) and zero-order FL
(FedMeZO, BAFFLE+, FwdLLM+). Neither reaches a kernel: backprop runs the
model in reverse mode outside the forward-AD region, and the zero-order
clients only run primal forwards."""
from repro_torch.core.baselines.backprop import make_backprop_round_step
from repro_torch.core.baselines.zeroorder import (
    ZO_DEFAULTS,
    ZOState,
    init_zo_state,
    make_zeroorder_round_step,
)
