"""HADES on PyTorch and CUDA: the port of `src/repro` (JAX on a TPU) to
PyTorch with hand-written Hopper kernels.

The package mirrors the JAX package's layout (`configs/`, `core/`,
`kernels/`, `models/`, `runtime/`, `launch/`) so each module's
counterpart is easy to find. It imports `torch` and never `jax`, and
nothing of `repro`: what it needs from there it keeps its own copy of.
Entry points (`models.model.Model`, `runtime.server.Server`,
`launch/serve.py`) run on `cuda` unless the caller passes
`device="cpu"`; without CUDA and without an explicit CPU request they
raise.
"""
