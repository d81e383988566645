"""gradaccum_tpu_torch: the PyTorch/CUDA port of gradaccum_tpu for NVIDIA Hopper.

A second package beside the JAX one, module for module: the same gradient-
accumulation train step (K micro-batches, average, clip, AdamW with warmup
and polynomial decay) in scan mode and in the reference's streaming
``tf.cond`` mode, with the non-finite guard and dynamic loss scaling; Adam,
Adam-mini and SGD, with float32 masters, q8 moments and fused
Adam-accumulation; the BERT classifier, the GPT decoder, the MNIST CNN and
the housing MLP, with bfloat16 parameter storage; and the
flash-attention kernels rewritten by hand in CUDA C++ for sm_90a
(``csrc/``). It imports torch and never jax or gradaccum_tpu. Entry points
run on the card unless the caller asks for the CPU, where every kernel's
plain PyTorch version runs instead.
"""
