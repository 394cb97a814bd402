"""Hand-written CUDA kernels of the port (csrc/*.cu) and their wrappers."""
