"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell once (``perfbench/run.py``).  Nothing here imports
JAX or the JAX package."""
