"""Optimizer, schedule, clipping, accumulation and the flash-attention kernels."""
