"""repro_torch — the kernel-tuner benchmarking suite on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100 (Hopper, sm_90a).
It imports ``torch`` and never ``jax``, and nothing of ``repro``: where it
needs a module of the JAX package that touches no JAX (search spaces, the
compiled space table, the tuners, the results database, telemetry), it
keeps its own copy, which behaves the same (``tests/test_torch_*.py`` hold
each copy to that).  Every Pallas TPU kernel on a ported path becomes a
CUDA C++ kernel written by hand for Hopper, under ``csrc/``; it is built
with ``nvcc`` at first use (``repro_torch._build``).

Entry point: ``python -m repro_torch.quickstart`` (GEMM tuning on the card).
"""
