"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``paged_ragged_attention``: CUDA C++ (``csrc/paged_ragged_attention.cu``).
* ``flash_attention``: CUDA C++ (``csrc/flash_attention.cu``).
* ``decode_attention`` and ``paged_decode_attention``: CUDA C++, one source
  (``csrc/decode_attention.cu``) templated on how a key is addressed.
* ``ssd_scan``: the SSD intra-chunk step, CUDA C++ (``csrc/ssd_chunk.cu``).
* ``rmsnorm``: CUDA C++ (``csrc/rmsnorm.cu``; row-wise, grouped with one
  scale row per head, or a layer's q and k norms in one launch).

The CUDA sources are built by ``build.py`` with nvcc for sm_90a and loaded
with ctypes. ``ops`` dispatches by the device of the tensors.
"""
