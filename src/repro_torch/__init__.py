"""repro_torch — ACiS (complex processing in the switch fabric) on PyTorch.

The port of the JAX package :mod:`repro` to PyTorch and CUDA: all ranks
of a mesh live in one tensor on one device (:mod:`repro_torch.mesh`),
switch programs compile through the same pass pipeline
(:mod:`repro_torch.core`), and the hot per-hop combine and the bucket
arena pack are hand-written CUDA kernels (:mod:`repro_torch.kernels`).
Nothing here imports JAX or the reference package.
"""
