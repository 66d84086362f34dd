"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell once (see README.md)."""
