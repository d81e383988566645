"""Memory-lean storage: the blockwise int8 codec of optimizer moments
(``quant``) and the radix index of the serving prefix cache (``radix``)."""
