"""PyTorch/CUDA port of the ``repro`` partitioner (see README.md).

It mirrors ``repro``'s module paths, imports neither ``jax`` nor ``repro``,
and runs its entry points on the CUDA card unless the caller passes
``device="cpu"``.
"""
