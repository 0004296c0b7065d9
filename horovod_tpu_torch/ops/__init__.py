"""Fusion and the flash-attention kernels of the port."""
