"""GPT-2 causal language model, plain.

Pre-LayerNorm decoder (``x + attn(LN(x))``, ``x + mlp(LN(x))``) with
causal attention, learned positions, tanh-approximate GELU, hidden
dropout after the embeddings and after each attention and MLP output,
attention dropout on the probabilities, a final LayerNorm and the head
tied to the word table in float32. The loss is the mean next-token cross
entropy over every shifted position.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nn import (attention, dense, draw_keep, draw_seed, drop, layer_norm,
                                    rows_of)


def model_cfg(c: dict) -> dict:
    """The sizes of a GPT-2 ``config.json``."""
    h = c["n_embd"]
    return {"hidden": h, "layers": c["n_layer"], "heads": c["n_head"],
            "intermediate": c.get("n_inner") or 4 * h, "vocab": c["vocab_size"],
            "positions": c["n_positions"], "eps": c["layer_norm_epsilon"],
            "dropout": c["resid_pdrop"], "attention_dropout": c["attn_pdrop"],
            "embedding_dropout": c["embd_pdrop"], "std": c["initializer_range"]}


def param_specs(cfg: dict):
    h, i = cfg["hidden"], cfg["intermediate"]
    specs = [("word_embeddings.weight", (cfg["vocab"], h), "normal"),
             ("position_embeddings.weight", (cfg["positions"], h), "normal")]
    for n in range(cfg["layers"]):
        p = f"layer_{n}."
        specs += _norm(p + "attention_LayerNorm", h)
        for name in ("query", "key", "value", "output"):
            specs += _dense(p + "attention." + name, h, h)
        specs += _norm(p + "mlp_LayerNorm", h)
        specs += _dense(p + "intermediate", h, i) + _dense(p + "ffn_output", i, h)
    return specs + _norm("final_LayerNorm", h)


def _dense(name, fan_in, fan_out):
    return [(name + ".weight", (fan_out, fan_in), "normal"), (name + ".bias", (fan_out,), "zeros")]


def _norm(name, h):
    return [(name + ".weight", (h,), "ones"), (name + ".bias", (h,), "zeros")]


def draw(cfg: dict, rows: int, seq: int, generator: torch.Generator) -> dict:
    """One micro-batch's dropout draws in the program's order: the
    embeddings; per layer the attention seed, the attention output, the
    MLP output."""
    h, rd = cfg["hidden"], cfg["dropout"]
    out = {"emb": draw_keep(generator, (rows, seq, h), cfg["embedding_dropout"]), "layers": []}
    for _ in range(cfg["layers"]):
        seed = draw_seed(generator) if cfg["attention_dropout"] > 0 else None
        out["layers"].append((seed, draw_keep(generator, (rows, seq, h), rd),
                              draw_keep(generator, (rows, seq, h), rd)))
    return out


def block_loss(W, cfg: dict, batch: dict, d: dict, rows: torch.Tensor, micro: int, prec: str):
    """The block's summed next-token cross entropy (``rows``: the block's
    row indices in the micro-batch) over ``micro · (S − 1)`` positions: the
    blocks of a micro-batch add up to its mean."""
    ids = batch["input_ids"].long()
    s = ids.shape[1]
    rd, ra, eps = cfg["dropout"], cfg["attention_dropout"], cfg["eps"]
    table = W["word_embeddings.weight"]
    x = table[ids] + W["position_embeddings.weight"][:s][None]
    x = drop(x, rows_of(d["emb"], rows, s), cfg["embedding_dropout"])
    for n, (seed, keep_attn, keep_mlp) in enumerate(d["layers"]):
        p = f"layer_{n}."
        h = attention(layer_norm(x, W, p + "attention_LayerNorm", eps), W, p + "attention.",
                      cfg["heads"], None, True, ra, seed, rows, prec)
        x = x + drop(h, rows_of(keep_attn, rows, s), rd)
        h = F.gelu(dense(layer_norm(x, W, p + "mlp_LayerNorm", eps), W, p + "intermediate", prec),
                   approximate="tanh")
        x = x + drop(dense(h, W, p + "ffn_output", prec), rows_of(keep_mlp, rows, s), rd)
    x = layer_norm(x, W, "final_LayerNorm", eps)
    logits = torch.matmul(x, table.t())
    nll = -torch.gather(F.log_softmax(logits[:, :-1], dim=-1), -1, ids[:, 1:, None])
    return nll.sum() / (micro * (s - 1))


def flop_layers(cfg: dict) -> dict:
    return {"hidden": cfg["hidden"], "layers": cfg["layers"], "heads": cfg["heads"],
            "intermediate": cfg["intermediate"], "head_flops_per_row": 0,
            "head_flops_per_token": 2 * cfg["hidden"] * cfg["vocab"], "causal": True}
