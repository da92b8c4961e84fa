"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the serving ops around them.  ``csrc/`` holds the CUDA sources;
``build.py`` compiles them with ``nvcc`` at first use."""
