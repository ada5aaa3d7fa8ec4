"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (the CPU path and the reference the card is held to)."""
