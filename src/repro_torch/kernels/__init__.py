"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

Nothing here compiles or loads a kernel at import: ``_build`` runs ``nvcc``
on first use, so CPU-only machines import every module cleanly.
"""
