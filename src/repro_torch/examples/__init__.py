"""The repo's ``examples/`` on the port, one module each, run as
``python -m repro_torch.examples.<name> [--device cpu]`` (the card unless
told otherwise; ``scaling_crossover`` is host arithmetic and takes no
device). Each keeps its original's assertions."""
