"""PyTorch/CUDA port of the ``repro`` serving system (ReLU Strikes Back:
activation sparsity in LLM inference), for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it. Entry points run on CUDA unless the caller passes ``device="cpu"``;
kernels are hand-written CUDA C++ (``csrc/``), built by nvcc at first use.
"""
