"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``paged_ragged_attention``: CUDA C++ (``csrc/paged_ragged_attention.cu``),
  built by ``build.py`` with nvcc for sm_90a and loaded with ctypes.
* ``rmsnorm``: Triton.

``ops`` dispatches by the device of the tensors.
"""
