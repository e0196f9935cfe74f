from repro_torch.utils.pytree import (
    tree_cast,
    tree_dot,
    tree_leaves,
    tree_map,
    tree_norm,
    tree_paths,
    tree_unflatten_like,
    tree_zeros_like,
)
