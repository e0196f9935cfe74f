from repro_torch.utils.pytree import (
    tree_cast,
    tree_leaves,
    tree_map,
    tree_paths,
    tree_unflatten_like,
    tree_zeros_like,
)
