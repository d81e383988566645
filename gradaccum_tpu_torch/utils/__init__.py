"""Parameter naming, device selection, FLOPs accounting and the CUDA build."""
