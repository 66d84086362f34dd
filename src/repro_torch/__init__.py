"""PyTorch/CUDA port of the stream-triggered (ST) communication library.

Mirrors the JAX package ``repro`` (the reference, which this package
never imports): the triggered-op IR, schedule passes and cost simulator
are exact copies, and the executors run every rank of the process grid
on one CUDA device, with hand-written Hopper kernels (``csrc/``) where
the JAX package has Pallas kernels.
"""
