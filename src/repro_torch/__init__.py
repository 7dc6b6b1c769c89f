"""PyTorch/CUDA port of the ``repro`` system for one NVIDIA H100.

The package mirrors ``src/repro/`` module for module (``configs``,
``core``, ``core/ops``, ``kernels``, ``models``, ``runtime``,
``launch``).  Plain tensor code is PyTorch; every Pallas kernel of the
JAX package on the ported path is a CUDA C++ kernel written by hand for
Hopper (``csrc/*.cu``), built with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/_build.py``).

Registry impl names map onto the JAX ones: ``xla`` -> ``torch`` (the
reference), ``pallas`` -> ``cuda`` (gemm kernels), ``pallas_naive`` ->
``cuda_naive`` (the paper's unstaged GEMM), ``pallas_fused`` ->
``cuda_fused`` (flash-attention kernels), ``pallas_grouped`` ->
``cuda_grouped`` (grouped expert GEMMs).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper runs its plain PyTorch version.
"""
