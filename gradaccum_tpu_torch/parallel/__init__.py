"""Attention cores beyond the flash kernels (the port of ``gradaccum_tpu/parallel``).

Only the single-device ``blockwise_attention`` is ported; the mesh-bound
cores (ring, Ulysses) and the parallel train steps wait for data and
sequence parallelism (ROADMAP.md).
"""
