"""Hand-written CUDA kernels for Hopper, their wrappers and their plain
PyTorch versions (``ref.py``)."""
