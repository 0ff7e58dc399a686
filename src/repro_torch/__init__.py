"""PyTorch port of the shift-parallelism serving stack, for one NVIDIA H100.

Laid out like ``repro`` (the JAX reference package) so that every module
here has its counterpart there. The port imports neither ``jax`` nor
anything of ``repro``: it keeps its own copies of the configs, the head
planner and the paged-cache control plane.

Its kernels are written by hand for Hopper (``kernels/``). Each sits
beside a plain PyTorch version of the same function; a wrapper takes the
plain version only for tensors that lie on the CPU and launches the
kernel for CUDA tensors. Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``.
"""
