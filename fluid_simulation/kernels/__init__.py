"""Hand-written GPU kernels for the hot path.

``rbgs_sweep``: one red-black Gauss-Seidel sweep and its setBounds in a single
launch (Pallas through Triton). ``ops.linsolve.linear_solver`` calls it on the
GPU; the jnp sweep in ``ops/linsolve.py`` is its reference.
"""
