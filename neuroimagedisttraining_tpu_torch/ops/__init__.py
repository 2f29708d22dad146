"""Hand-written CUDA kernels beside their plain PyTorch versions, SNIP
scoring and masks."""
