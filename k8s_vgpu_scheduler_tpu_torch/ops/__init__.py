"""Attention kernels and their plain PyTorch versions."""
