"""PyTorch / CUDA port of d3d12renderer_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module layout.  It imports torch and numpy only;
the JAX package stays the reference that the port's tests hold it against.
"""
