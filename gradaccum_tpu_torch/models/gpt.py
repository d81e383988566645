"""GPT-style decoder-only causal language model, for the port.

The port of ``gradaccum_tpu/models/gpt.py``: a pre-LayerNorm transformer
decoder (GPT-2's residual layout, ``x + attn(LN(x))``, ``x + mlp(LN(x))``)
with causal attention, learned positions, a tanh-approximate GELU MLP and a
weight-tied head computed in float32 (``logits = x @ Eᵀ``). The attention
block is BERT's ``SelfAttention`` (``models/bert.py``) and the parameter
names are BERT's plus ``attention_LayerNorm``, ``mlp_LayerNorm``,
``final_LayerNorm`` and ``position_embeddings``, so the weights carry
across with ``interop.py`` unchanged.

The ``attention_fn`` slot takes ``dense_attention`` (the model then adds a
dense [1, 1, S, S] causal mask at -1e9) or
``ops/flash_attention.py :: causal_flash_attention``, which advertises
``handles_causality``: no mask is built and the kernels cut the triangle.
Attention dropout goes into the flash kernels as a rate and a seed; hidden
dropout draws from the batch's ``torch.Generator`` as BERT's does.

``GPTConfig.dtype`` is the compute dtype; ``gpt_lm_bundle(compute_dtype=)``
stores the parameters in it too (the float32 masters live in the
optimizer). The head and the loss stay float32. A sequence longer than
``max_position_embeddings`` raises.

:func:`greedy_generate` re-runs the whole prefix for each new token. The
KV-cache decode of JAX's ``models/gpt_decode.py`` belongs to the serving
stack and is not ported yet (ROADMAP.md).

Under ``gpt_tp_rules`` (``parallel/tp.py``) the blocks run as BERT's do
(``models/bert.py``), and the tied head reads the vocab-sharded table:
each rank's vocab slice of the logits, all-gathered whole with
``gather_slices`` (a vocab-parallel cross entropy would skip the gather).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gradaccum_tpu_torch.estimator.estimator import ModelBundle
from gradaccum_tpu_torch.estimator.metrics import Metric
from gradaccum_tpu_torch.models.bert import (
    BertConfig,
    Dense,
    Embed,
    LayerNorm,
    SelfAttention,
    _remat,
    column_input,
    dense_attention,
    dropout,
)
from gradaccum_tpu_torch.models.init import init_weights, store_in
from gradaccum_tpu_torch.parallel import tp
from gradaccum_tpu_torch.parallel.mesh import axis_mesh


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.float32
    remat: bool = False

    @staticmethod
    def small(**kw) -> "GPTConfig":
        return GPTConfig(**kw)

    @staticmethod
    def tiny_for_tests(**kw) -> "GPTConfig":
        return GPTConfig(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
                         intermediate_size=64, max_position_embeddings=64, **kw)


def _bert_cfg_view(cfg: GPTConfig) -> BertConfig:
    """The BertConfig fields ``SelfAttention`` reads."""
    return BertConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                      num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                      intermediate_size=cfg.intermediate_size,
                      max_position_embeddings=cfg.max_position_embeddings,
                      hidden_dropout=cfg.dropout, attention_dropout=cfg.dropout,
                      layer_norm_eps=cfg.layer_norm_eps, dtype=cfg.dtype)


class DecoderBlock(nn.Module):
    """Pre-LN: ``x + attn(LN(x))``, then ``x + mlp(LN(x))``."""

    def __init__(self, config: GPTConfig, attention_fn: Callable = dense_attention):
        super().__init__()
        cfg = config
        self.config = cfg
        self.attention_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)
        self.attention = SelfAttention(_bert_cfg_view(cfg), attention_fn)
        self.mlp_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.ffn_output = Dense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)

    def _drop(self, x, deterministic, generator):
        rate = self.config.dropout
        return x if deterministic or rate == 0 else dropout(x, rate, generator)

    def forward(self, x, mask, deterministic: bool, generator=None):
        h = self.attention(self.attention_LayerNorm(x), mask, deterministic, generator)
        x = x + self._drop(h, deterministic, generator)
        h = column_input(self.mlp_LayerNorm(x), self.intermediate)
        h = F.gelu(self.intermediate(h), approximate="tanh")
        return x + self._drop(self.ffn_output.row_parallel(h), deterministic, generator)


class GPTLM(nn.Module):
    def __init__(self, config: GPTConfig, attention_fn: Callable = dense_attention):
        super().__init__()
        cfg = config
        self.config = cfg
        self.attention_fn = attention_fn
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                                         cfg.dtype)
        for i in range(cfg.num_layers):  # layer_<i>: the flax module names
            self.add_module(f"layer_{i}", DecoderBlock(cfg, attention_fn))
        self.final_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, input_ids, deterministic: bool = True, generator=None):
        """Float32 logits [B, S, vocab]."""
        cfg = self.config
        b, s = input_ids.shape
        if s > cfg.max_position_embeddings:
            # a gather past the table would reuse or miss rows: refuse instead
            raise ValueError(f"sequence length {s} exceeds max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        dev = input_ids.device
        x = self.word_embeddings(input_ids) + \
            self.position_embeddings(torch.arange(s, device=dev)[None, :])
        if not deterministic and cfg.dropout > 0:
            x = dropout(x, cfg.dropout, generator)
        if getattr(self.attention_fn, "handles_causality", False):
            mask = None  # the kernels cut the triangle
        else:
            # position q attends keys <= q: an additive [1, 1, S, S] mask
            causal = torch.tril(torch.ones((s, s), dtype=torch.float32, device=dev))
            mask = ((1.0 - causal) * -1e9).to(cfg.dtype)[None, None, :, :]
        for i in range(cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            if cfg.remat:
                x = _remat(layer, x, mask, deterministic, generator)
            else:
                x = layer(x, mask, deterministic, generator)
        x = self.final_LayerNorm(x)
        # the weight-tied head, in float32; a vocab-sharded table gives this
        # rank's vocab slice of the logits, gathered whole (the loss after
        # it is replicated, so the gather's backward keeps the slice)
        table = self.word_embeddings.weight
        axis = tp.axis_of(table, 0)
        if axis is None:
            return torch.einsum("bsd,vd->bsv", x.float(), table.float())
        mesh = axis_mesh(axis)
        part = torch.einsum("bsd,vd->bsv", tp.copy_to(x, mesh).float(), table.float())
        return tp.gather_slices(part, mesh, dim=-1)


def next_token_loss(logits, input_ids, loss_mask=None):
    """Mean causal-LM cross entropy: position t predicts token t+1.
    ``loss_mask`` ([B, S] 0/1) weights the positions whose next token
    counts; default all S-1 shifted positions."""
    targets = input_ids[:, 1:].long()
    lp = F.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    if loss_mask is None:
        return torch.mean(nll)
    w = loss_mask[:, :targets.shape[1]].to(nll.dtype)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def token_accuracy() -> Metric:
    """Streaming next-token accuracy over the positions ``loss_mask`` keeps
    (all of them without one)."""

    def update(outputs, batch):
        logits = outputs["logits"][:, :-1]
        targets = torch.as_tensor(batch["input_ids"], device=logits.device)[:, 1:]
        hit = (torch.argmax(logits, dim=-1) == targets).float()
        mask = batch.get("loss_mask")
        if mask is None:
            return float(hit.sum()), float(hit.numel())
        w = torch.as_tensor(mask, device=logits.device)[:, :targets.shape[1]].float()
        return float((hit * w).sum()), float(w.sum())

    return Metric(update, lambda total, count: total / max(count, 1.0))


def gpt_lm_bundle(config: GPTConfig, attention_fn: Callable = dense_attention,
                  compute_dtype: Any = None) -> ModelBundle:
    """ModelBundle for causal-LM training: batches ``{"input_ids": [B, S]
    int}`` (and an optional ``"loss_mask"`` [B, S]); the harness adds the
    ``"rng"`` generator for dropout. ``compute_dtype`` (``torch.bfloat16``)
    stores the parameters in it and runs the decoder in it; pair it with
    ``adamw(..., master_dtype=torch.float32)``."""
    if compute_dtype is not None:
        config = dataclasses.replace(config, dtype=compute_dtype)

    def init(seed: int, device) -> GPTLM:
        model = GPTLM(config, attention_fn)
        init_weights(model, torch.Generator().manual_seed(seed))
        return store_in(model, compute_dtype).to(device)

    def loss(model, batch):
        logits = model(batch["input_ids"], False, batch.get("rng"))
        return next_token_loss(logits, batch["input_ids"], batch.get("loss_mask"))

    @torch.no_grad()
    def predict(model, batch):
        logits = model(batch["input_ids"], True)
        return {"logits": logits, "next_token": torch.argmax(logits[:, -1], dim=-1)}

    return ModelBundle(init=init, loss=loss, predict=predict,
                       eval_metrics={"token_accuracy": token_accuracy()}, needs_rng=True,
                       label_keys=())  # the LM's targets ARE input_ids (shifted inside)


@torch.no_grad()
def greedy_generate(model: GPTLM, prompt_ids, num_steps: int, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Append ``num_steps`` tokens to ``prompt_ids`` ([S] or [B, S]): the
    argmax of the last position's logits, or a sample at ``temperature``
    from ``generator``. Each step re-runs the whole prefix."""
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    dev = next(model.parameters()).device
    ids = torch.as_tensor(prompt_ids, device=dev).long()
    if ids.dim() == 1:
        ids = ids[None, :]
    for _ in range(num_steps):
        last = model(ids, True)[:, -1]
        if temperature > 0:
            nxt = torch.multinomial(torch.softmax(last / temperature, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids
