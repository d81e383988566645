"""BERT sequence classification through the port: ``models/bert.py ::
bert_classifier_bundle`` with the padded flash kernels."""

from __future__ import annotations

import torch

from benchmark.families import copy_weights
from benchmark.reference import bert as reference

model_cfg = reference.model_cfg


def program_bundle(cfg: dict, precision: str, weights_fn):
    """The port's bundle; its ``init`` builds the module on the device and
    copies in ``weights_fn()`` (the benchmark's weights) instead of drawing
    its own on the host."""
    from gradaccum_tpu_torch.models.bert import (BertClassifier, BertConfig,
                                                 bert_classifier_bundle)
    from gradaccum_tpu_torch.models.init import store_in
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention

    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    compute = dtype if precision == "bf16" else None
    bcfg = BertConfig(vocab_size=cfg["vocab"], hidden_size=cfg["hidden"],
                      num_layers=cfg["layers"], num_heads=cfg["heads"],
                      intermediate_size=cfg["intermediate"],
                      max_position_embeddings=cfg["positions"], type_vocab_size=cfg["types"],
                      hidden_dropout=cfg["hidden_dropout"],
                      attention_dropout=cfg["attention_dropout"], layer_norm_eps=cfg["eps"],
                      dtype=dtype)
    bundle = bert_classifier_bundle(bcfg, cfg["classes"], attention_fn=flash_attention,
                                    compute_dtype=compute)

    def init(seed, device):
        with torch.device(device):
            model = BertClassifier(bcfg, cfg["classes"], flash_attention)
        copy_weights(model, weights_fn())
        return store_in(model, compute)

    return bundle._replace(init=init)
