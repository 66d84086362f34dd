"""Hand-written CUDA kernels (``csrc/``), each with a plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that routes by device."""
