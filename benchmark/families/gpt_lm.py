"""GPT-2 causal language modelling through the port: ``models/gpt.py ::
gpt_lm_bundle`` with the causal flash kernels and the float32 tied head."""

from __future__ import annotations

import torch

from benchmark.families import copy_weights
from benchmark.reference import gpt as reference

model_cfg = reference.model_cfg


def program_bundle(cfg: dict, precision: str, weights_fn):
    from gradaccum_tpu_torch.models.gpt import GPTLM, GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.models.init import store_in
    from gradaccum_tpu_torch.ops.flash_attention import causal_flash_attention

    rates = {cfg["dropout"], cfg["attention_dropout"], cfg["embedding_dropout"]}
    if len(rates) != 1:
        raise ValueError(f"the port's GPT has one dropout rate; the configuration has {rates}")
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    compute = dtype if precision == "bf16" else None
    gcfg = GPTConfig(vocab_size=cfg["vocab"], hidden_size=cfg["hidden"],
                     num_layers=cfg["layers"], num_heads=cfg["heads"],
                     intermediate_size=cfg["intermediate"],
                     max_position_embeddings=cfg["positions"], dropout=cfg["dropout"],
                     layer_norm_eps=cfg["eps"], dtype=dtype)
    bundle = gpt_lm_bundle(gcfg, attention_fn=causal_flash_attention, compute_dtype=compute)

    def init(seed, device):
        with torch.device(device):
            model = GPTLM(gcfg, causal_flash_attention)
        copy_weights(model, weights_fn())
        return store_in(model, compute)

    return bundle._replace(init=init)
