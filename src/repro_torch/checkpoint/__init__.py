"""Crash-safe checkpoints of the port, in the reference's file format."""
from repro_torch.checkpoint.async_state import (
    decode_async_snapshot,
    encode_async_snapshot,
)
from repro_torch.checkpoint.io import CheckpointError, load_pytree, save_pytree
from repro_torch.checkpoint.manifest import (
    RunManifest,
    load_checkpoint,
    read_manifest,
    save_checkpoint,
    tree_content_hash,
    write_manifest,
)
