"""BERT for sequence classification (run_classifier.py's model), plain.

Post-LayerNorm encoder with exact-erf GELU, learned positions and
segment embeddings, a tanh pooler over [CLS], hidden dropout after the
embeddings, after each attention and FFN output and on the pooled row,
attention dropout on the probabilities, and a float32 classifier head.
Parameter names are the module paths ``bert.layer_<i>.attention.query``
and so on, weights [out, in].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nn import (attention, dense, draw_keep, draw_seed, drop, layer_norm,
                                    rows_of)


def model_cfg(c: dict) -> dict:
    """The sizes of a ``bert_config.json``-style configuration."""
    return {"hidden": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"], "intermediate": c["intermediate_size"],
            "vocab": c["vocab_size"], "positions": c["max_position_embeddings"],
            "types": c["type_vocab_size"], "eps": c["layer_norm_eps"],
            "hidden_dropout": c["hidden_dropout_prob"],
            "attention_dropout": c["attention_probs_dropout_prob"],
            "classes": c["num_labels"], "std": c["initializer_range"]}


def param_specs(cfg: dict):
    """``[(name, shape, init)]``, init one of ``normal``, ``zeros``, ``ones``."""
    h, i = cfg["hidden"], cfg["intermediate"]
    specs = [("bert.word_embeddings.weight", (cfg["vocab"], h), "normal"),
             ("bert.position_embeddings.weight", (cfg["positions"], h), "normal"),
             ("bert.token_type_embeddings.weight", (cfg["types"], h), "normal")]
    specs += _norm("bert.embeddings_LayerNorm", h)
    for n in range(cfg["layers"]):
        p = f"bert.layer_{n}."
        for name in ("query", "key", "value", "output"):
            specs += _dense(p + "attention." + name, h, h)
        specs += _norm(p + "attention_LayerNorm", h)
        specs += _dense(p + "intermediate", h, i) + _dense(p + "ffn_output", i, h)
        specs += _norm(p + "output_LayerNorm", h)
    return specs + _dense("pooler", h, h) + _dense("classifier", h, cfg["classes"])


def _dense(name, fan_in, fan_out):
    return [(name + ".weight", (fan_out, fan_in), "normal"), (name + ".bias", (fan_out,), "zeros")]


def _norm(name, h):
    return [(name + ".weight", (h,), "ones"), (name + ".bias", (h,), "zeros")]


def draw(cfg: dict, rows: int, seq: int, generator: torch.Generator) -> dict:
    """One micro-batch's dropout draws, in the program's order: the
    embeddings; per layer the attention seed, the attention output, the
    FFN output; the pooled row."""
    h, rh, ra = cfg["hidden"], cfg["hidden_dropout"], cfg["attention_dropout"]
    out = {"emb": draw_keep(generator, (rows, seq, h), rh), "layers": []}
    for _ in range(cfg["layers"]):
        seed = draw_seed(generator) if ra > 0 else None
        out["layers"].append((seed, draw_keep(generator, (rows, seq, h), rh),
                              draw_keep(generator, (rows, seq, h), rh)))
    out["pooled"] = draw_keep(generator, (rows, h), rh)
    return out


def block_loss(W, cfg: dict, batch: dict, d: dict, rows: torch.Tensor, micro: int, prec: str):
    """The summed cross entropy of the block's rows (``rows``: their
    indices in the micro-batch; ``batch`` holds them, cut to the block's
    longest real length) over ``micro``, the micro-batch's size: the blocks
    of a micro-batch add up to its mean. A padded key takes no weight in the
    softmax (its score is -1e9 below), so cutting the padding changes
    nothing the [CLS] row sees."""
    ids, mask = batch["input_ids"].long(), batch["input_mask"]
    s = ids.shape[1]
    rh, ra, eps = cfg["hidden_dropout"], cfg["attention_dropout"], cfg["eps"]
    x = (W["bert.word_embeddings.weight"][ids] + W["bert.position_embeddings.weight"][:s][None]
         + W["bert.token_type_embeddings.weight"][batch["segment_ids"].long()])
    x = drop(layer_norm(x, W, "bert.embeddings_LayerNorm", eps), rows_of(d["emb"], rows, s), rh)
    add_mask = (1.0 - mask[:, None, None, :].float()) * -1e9
    for n, (seed, keep_attn, keep_ffn) in enumerate(d["layers"]):
        p = f"bert.layer_{n}."
        a = attention(x, W, p + "attention.", cfg["heads"], add_mask, False, ra, seed, rows,
                      prec)
        x = layer_norm(x + drop(a, rows_of(keep_attn, rows, s), rh), W, p + "attention_LayerNorm",
                       eps)
        f = dense(F.gelu(dense(x, W, p + "intermediate", prec)), W, p + "ffn_output", prec)
        x = layer_norm(x + drop(f, rows_of(keep_ffn, rows, s), rh), W, p + "output_LayerNorm", eps)
    pooled = torch.tanh(dense(x[:, 0], W, "pooler", prec))
    pooled = drop(pooled, rows_of(d["pooled"], rows, s), rh)
    logits = F.linear(pooled, W["classifier.weight"], W["classifier.bias"])
    ce = -torch.gather(F.log_softmax(logits, dim=-1), 1, batch["label"].long()[:, None])
    return ce.sum() / micro


def flop_layers(cfg: dict) -> dict:
    """Sizes the analytic FLOP count reads (``yardstick/flops.py``)."""
    return {"hidden": cfg["hidden"], "layers": cfg["layers"], "heads": cfg["heads"],
            "intermediate": cfg["intermediate"], "head_flops_per_row":
            2 * cfg["hidden"] * cfg["hidden"] + 2 * cfg["hidden"] * cfg["classes"],
            "head_flops_per_token": 0, "causal": False}
