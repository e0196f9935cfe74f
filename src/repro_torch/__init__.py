"""PyTorch/CUDA port of the SPRY reproduction (see ROADMAP.md)."""
