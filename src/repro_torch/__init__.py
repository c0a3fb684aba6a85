"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.models.layers`` <-> ``repro.models.layers`` and so on)
and imports ``torch``, ``numpy`` and the standard library only — never
``jax`` and never ``repro``. Where it needs code of a jax-free ``repro``
module (the FT core, the clock, the configs) it keeps its own copy.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise instead of falling back. The hand-written
CUDA kernels (``repro_torch.kernels``) are compiled at first use, never at
import.
"""
