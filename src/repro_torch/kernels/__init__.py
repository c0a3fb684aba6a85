"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch between them (``ops``). Sources live in ``csrc/``; ``build``
compiles them with nvcc at first use."""
