"""SPRY — forward-gradient estimator, layer-to-client assignment and the FL
round steps (port of ``repro/core``)."""
from repro_torch.core.assignment import (
    UnitIndex,
    assignment_matrix,
    build_mask_tree,
    client_counts,
    enumerate_units,
)
from repro_torch.core.forward_grad import (
    SplitLoss,
    fold_in,
    forward_gradient,
    masked_perturbation,
    reconstruct_gradient,
    stacked_perturbations,
)
from repro_torch.core.spry import (
    SpryState,
    aggregate_payloads,
    estimator_route,
    init_state,
    make_client_jvp_fn,
    make_client_update_fn,
    make_count_tree,
    make_rebuild_fn,
    make_round_step,
    make_round_step_per_iteration,
    make_task_loss,
)
