"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Importing this package needs neither ``nvcc`` nor a card: the library is
built and loaded at the first CUDA call (``build.load_library``).
"""
