"""The paper's three applications as simrt generator apps (the port of
``repro.apps``): HPCG (CG on a 7-point Laplacian), CloverLeaf (2-D Euler,
slab halos) and PIC (1-D electrostatic particle-in-cell).  Each takes a
``device``: ``None`` means the card, which raises without CUDA."""
