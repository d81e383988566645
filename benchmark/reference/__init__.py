"""The plain reference: BERT and GPT-2 training steps in float32 PyTorch.

Nothing here imports the program under test, JAX or the JAX package. The
pieces that must draw exactly what the program draws are frozen copies:
the attention dropout hash (``hash_dropout.py``) and the per-step seed
(``seeds.py``). The hidden dropout masks come from a ``torch.Generator``
seeded as the program seeds its own, drawn in the program's order.
"""
