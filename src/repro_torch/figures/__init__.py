"""The paper's figures that drive the port's own entry points (the others
run the reference's ``benchmarks/`` modules bound to the port:
``tests/test_torch_fig_digests.py``, ``tests/test_torch_fig11_12.py``)."""
