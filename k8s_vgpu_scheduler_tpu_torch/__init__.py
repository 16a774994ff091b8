"""PyTorch/CUDA port of the compute path of k8s_vgpu_scheduler_tpu.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
