"""Memory-lean storage: the int8 codec of optimizer moments and of the KV
pool (``quant``), the radix index of the serving prefix cache (``radix``),
and the host and disk rungs below the KV pool (``tiers``)."""
