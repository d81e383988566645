"""Memory-lean storage: the blockwise int8 codec of optimizer moments."""
