"""BERT encoder + classification head for the port.

The port of ``gradaccum_tpu/models/bert.py``: post-LayerNorm transformer
encoder, exact-erf GELU FFN at 4x hidden, learned position embeddings, tanh
pooler over [CLS] and a float32 classifier head. The module tree and its
submodule names mirror the flax one, so every parameter keeps its JAX path
name (``utils/tree.py``) and the weights carry across
(``interop.py``).

``BertConfig.dtype`` is the compute dtype: each Dense casts its input and
weights to it (bfloat16 on the card's main path), LayerNorm computes in
float32 and returns the compute dtype, and the head and loss stay float32,
as flax's ``dtype=`` does. The parameters stay float32, unless the bundle's
``compute_dtype`` stores them in that dtype too (the float32 masters then
live in the optimizer, ``adamw(master_dtype=torch.float32)``).

Dropout draws from the explicit ``torch.Generator`` a batch carries under
``"rng"``; attention dropout goes into the flash kernels as a rate and a
seed drawn from that generator (``attention_fn.inkernel_dropout``).

Options ported from JAX: ``remat`` (activation checkpointing per encoder
layer, with the layer's draws replayed in the recompute), the MoE FFN
(``num_experts > 0``: ``models/moe.py`` in every layer, the mean per-layer
load-balance loss added to the loss at ``moe_aux_weight``), and the
sparse-embedding hooks (``word_rows``: the loss with the gathered word rows
as an argument, for ``ops/sparse_embed.py``).

**Sequence parallelism** (``seq_axis``): the encoder runs on this rank's
token block of every sequence (``parallel/ring_attention.py ::
shard_seq_batch``) with a sequence-parallel ``attention_fn``
(``make_ring_attention_fn``, ``make_ulysses_attention_fn``). Position ids
are global (local position + rank · S_local); the [CLS] row lives on rank 0
of the axis, and the readout sums it over the axis (``tp.reduce_from``:
forward sum, backward identity), so the pooler and classifier run on the
same values on every rank and each rank computes their whole gradient,
while the embeddings' and encoder's gradients are each rank's part. The
head's parameters say so (``parallel/sharding.py :: invariant_axes``): the
step sums the parts over the axis and counts the head's once. Dropout is
refused, as in JAX.

**Tensor and expert parallelism.** A model whose parameters
``parallel/sharding.py :: shard_params`` cut by rules (``parallel/tp.py``:
``bert_tp_rules``, ``bert_tp_ep_rules``; ``models/moe.py ::
moe_ep_rules``) runs on its blocks and issues the collectives GSPMD would
insert, read from each weight's placement: a column-parallel layer (QKV,
intermediate) takes its input through ``copy_to``, a row-parallel one
(attention output, FFN output) sums its output with ``reduce_from`` and
adds its replicated bias once after the sum, a vocab-sharded word table
looks up with ``vocab_parallel_embed``, and the expert bank runs its own
experts (``moe_apply(ep=...)``). Each rank attends its own ``num_heads/tp``
heads through the same attention core: the flash kernels take the heads'
place in the whole attention (``head_offset``, ``heads_total``), so their
dropout draws the tp=1 keep mask's slice, and the dense core draws the
whole [B, heads, S, S] mask and keeps its heads. Hidden dropout acts on
replicated activations, and every rank of a model group draws it from the
same generator state, so the replicas stay equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gradaccum_tpu_torch.estimator.estimator import ModelBundle
from gradaccum_tpu_torch.estimator.metrics import accuracy
from gradaccum_tpu_torch.models.init import init_weights, store_in
from gradaccum_tpu_torch.models.moe import ExpertShards, moe_apply, moe_init
from gradaccum_tpu_torch.ops.sparse_embed import SparseEmbedHooks
from gradaccum_tpu_torch.parallel import tp
from gradaccum_tpu_torch.parallel.mesh import axis_mesh, current_mesh
from gradaccum_tpu_torch.parallel.sharding import mark_invariant


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 512  # H
    num_layers: int = 4  # L
    num_heads: int = 8  # A
    intermediate_size: int = 2048  # 4H
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.float32
    remat: bool = False  # checkpoint each encoder layer (recompute in the backward)
    # Mixture-of-Experts FFN: 0 = dense. When > 0, every layer's FFN is an
    # expert bank (models/moe.py) and the loss adds moe_aux_weight times
    # the mean per-layer load-balance loss.
    num_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1  # 1 = Switch routing; 2 = GShard-style top-2
    moe_aux_weight: float = 0.01

    @staticmethod
    def small(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def tiny_for_tests(**kw) -> "BertConfig":
        return BertConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                          intermediate_size=64, max_position_embeddings=64, **kw)


def dense_attention(q, k, v, mask, dropout_fn=None):
    """Plain attention core: full [B, heads, S, S] scores.

    ``q, k, v``: [B, heads, S, head_dim]; ``mask``: [B, 1, 1, S] additive.
    """
    depth = torch.tensor(q.shape[-1], dtype=q.dtype, device=q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.sqrt(depth)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_fn is not None:
        probs = dropout_fn(probs)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def dropout(x, rate: float, generator: torch.Generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1/(1 - rate). The mask comes from ``generator``."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def head_dropout(p, rate: float, generator: torch.Generator, first: int, total: int):
    """:func:`dropout` of the probabilities ``p`` [B, heads, S, S] of heads
    ``[first, first + heads)`` of a ``total``-head attention: the whole
    attention's mask is drawn and these heads' slice kept, so the ranks of
    a model group draw alike and together drop what one device would."""
    b, h, q, k = p.shape
    keep_prob = 1.0 - rate
    keep = torch.rand((b, total, q, k), generator=generator,
                      device=p.device)[:, first:first + h] < keep_prob
    return torch.where(keep, p / keep_prob, torch.zeros((), dtype=p.dtype, device=p.device))


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 parameters, the product in the
    compute dtype. A column-parallel Dense (its output features split, the
    input already through ``copy_to``) runs as is on its block."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def row_parallel(self, x):
        """The layer on ``x`` whose features this rank holds a slice of,
        when its weight's input features are split: the partial products
        summed over the axis (``reduce_from``), then the replicated bias,
        added once. An unsplit Dense is :meth:`forward`."""
        axis = tp.axis_of(self.weight, 1)
        if axis is None:
            return self(x)
        dt = self.compute_dtype
        y = tp.reduce_from(F.linear(x.to(dt), self.weight.to(dt)), axis_mesh(axis))
        return y + self.bias.to(dt)


def column_input(x, dense: Dense):
    """``x`` entering the column-parallel ``dense`` (its output features
    split over an axis) through ``copy_to``; unchanged otherwise."""
    axis = tp.axis_of(dense.weight, 0)
    return x if axis is None else tp.copy_to(x, axis_mesh(axis))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and affine in float32,
    the result in the compute dtype."""

    def __init__(self, features: int, eps: float, dtype):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=...)``: a float32 table, rows in the compute dtype."""

    def __init__(self, num: int, features: int, dtype):
        super().__init__(num, features)
        self.compute_dtype = dtype

    def forward(self, ids):
        axis = tp.axis_of(self.weight, 0)
        if axis is not None:  # vocab-sharded: this rank holds a block of rows
            return tp.vocab_parallel_embed(ids, self.weight, axis_mesh(axis)).to(
                self.compute_dtype)
        return super().forward(ids.long()).to(self.compute_dtype)


class SelfAttention(nn.Module):
    def __init__(self, config: BertConfig, attention_fn: Callable = dense_attention):
        super().__init__()
        cfg = config
        self.config = cfg
        self.attention_fn = attention_fn
        for name in ("query", "key", "value", "output"):
            self.add_module(name, Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype))

    def forward(self, x, mask, deterministic: bool, generator=None):
        cfg = self.config
        b, s, _ = x.shape
        head_dim = cfg.hidden_size // cfg.num_heads
        # under tensor parallelism this rank's heads are a block of them
        heads = self.query.weight.shape[0] // head_dim
        axis = tp.axis_of(self.query.weight, 0)
        first = 0 if axis is None else axis_mesh(axis).rank * heads
        x = column_input(x, self.query)

        def split_heads(t):
            return t.reshape(b, s, heads, head_dim).transpose(1, 2).contiguous()

        q, k, v = (split_heads(layer(x)) for layer in (self.query, self.key, self.value))
        dropout_fn, extra = None, {}
        rate = cfg.attention_dropout
        if rate > 0 and not deterministic:
            if getattr(self.attention_fn, "inkernel_dropout", False):
                # the flash kernels never materialize the probabilities a
                # dropout_fn would act on: they take a rate and a seed, and
                # key the mask on these heads' place in the whole attention
                extra = dict(dropout_rate=rate, generator=generator)
                if axis is not None:
                    extra.update(head_offset=first, heads_total=cfg.num_heads)
            elif axis is None:
                dropout_fn = lambda p: dropout(p, rate, generator)  # noqa: E731
            else:
                dropout_fn = lambda p: head_dropout(  # noqa: E731
                    p, rate, generator, first, cfg.num_heads)
        ctx = self.attention_fn(q, k, v, mask, dropout_fn, **extra)
        ctx = ctx.transpose(1, 2).reshape(b, s, heads * head_dim)
        return self.output.row_parallel(ctx)


class MoEFFN(nn.Module):
    """Expert-bank FFN slot of :class:`EncoderLayer` (submodule ``moe``).
    Its parameters are raw arrays in JAX, not Dense kernels, and keep
    JAX's names and layouts (``router`` [D, E], ``w_in`` [E, D, H], ``b_in``
    [E, H], ``w_out`` [E, H, D], ``b_out`` [E, D]). They are cast to the
    compute dtype before routing. ``last_aux`` holds the routing statistics
    of the newest call, detached, for reports."""

    def __init__(self, config: BertConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        d, h, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        shapes = {"router": (d, e), "w_in": (e, d, h), "b_in": (e, h),
                  "w_out": (e, h, d), "b_out": (e, d)}
        for name, shape in shapes.items():  # drawn by init_from
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))
        self.last_aux = None

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        cfg = self.config
        drawn = moe_init(generator, cfg.hidden_size, cfg.intermediate_size, cfg.num_experts)
        for name, t in drawn.items():
            getattr(self, name).copy_(t)

    def shards(self):
        """The :class:`~.moe.ExpertShards` of this bank's placement, or
        None when it is whole on this rank."""
        e_axis, m_axis = tp.axis_of(self.w_in, 0), tp.axis_of(self.w_in, 2)
        if e_axis is None and m_axis is None:
            return None
        first = 0 if e_axis is None else axis_mesh(e_axis).rank * self.w_in.shape[0]
        axes = tuple(a for a in (e_axis, m_axis) if a is not None)
        group = axis_mesh(axes[0]) if len(axes) == 1 else current_mesh().over(axes)
        return ExpertShards(first, group, None if m_axis is None else axis_mesh(m_axis))

    def forward(self, x):
        cfg = self.config
        params = {name: p.to(cfg.dtype) for name, p in self.named_parameters()}
        y, aux = moe_apply(params, x, cfg.moe_capacity_factor, cfg.moe_top_k,
                           ep=self.shards())
        self.last_aux = {key: v.detach() for key, v in aux.items()}
        return y, aux["load_balance_loss"]


class EncoderLayer(nn.Module):
    """One post-LN encoder layer. ``forward`` returns ``(x, load_balance)``,
    the second None for the dense FFN."""

    def __init__(self, config: BertConfig, attention_fn: Callable = dense_attention):
        super().__init__()
        cfg = config
        self.config = cfg
        self.attention = SelfAttention(cfg, attention_fn)
        self.attention_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)
        if cfg.num_experts > 0:
            self.moe = MoEFFN(cfg)
        else:
            self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
            self.ffn_output = Dense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)
        self.output_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)

    def _drop(self, x, deterministic, generator):
        rate = self.config.hidden_dropout
        return x if deterministic or rate == 0 else dropout(x, rate, generator)

    def forward(self, x, mask, deterministic: bool, generator=None):
        attn_out = self.attention(x, mask, deterministic, generator)
        attn_out = self._drop(attn_out, deterministic, generator)
        # post-LN (original BERT): LN(x + sublayer(x))
        x = self.attention_LayerNorm(x + attn_out)
        load_balance = None
        if self.config.num_experts > 0:
            ffn, load_balance = self.moe(x)
        else:  # exact erf GELU
            ffn = self.ffn_output.row_parallel(
                F.gelu(self.intermediate(column_input(x, self.intermediate))))
        ffn = self._drop(ffn, deterministic, generator)
        return self.output_LayerNorm(x + ffn), load_balance


def _remat(layer, x, mask, deterministic, generator):
    """``layer`` under ``torch.utils.checkpoint`` (JAX's ``nn.remat``): its
    activations are recomputed in the backward. The layer draws its dropout
    masks and flash seed from ``generator``, which ``checkpoint``'s
    ``preserve_rng_state`` does not cover (it saves the default generators
    only), so the layer draws from its own generator set to the caller's
    state at entry, and set to it again for the recompute: the recompute
    replays the same draws, and the caller's generator moves on exactly as
    far as the layer drew, as without remat."""
    if generator is None:
        return checkpoint(layer, x, mask, deterministic, None,
                          use_reentrant=False, preserve_rng_state=False)
    entry = generator.get_state()
    own = torch.Generator(device=generator.device)

    def run(x_, mask_):
        own.set_state(entry)
        return layer(x_, mask_, deterministic, own)

    out = checkpoint(run, x, mask, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(own.get_state())
    return out


class BertEncoder(nn.Module):
    """``seq_axis``: the encoder runs on this rank's token block of a
    sequence sharded over that mesh axis, with global position ids."""

    def __init__(self, config: BertConfig, attention_fn: Callable = dense_attention,
                 seq_axis: Optional[str] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.seq_axis = seq_axis
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                                         cfg.dtype)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size, cfg.dtype)
        self.embeddings_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)
        # layer_<i>, not a ModuleList: the names are the flax module names
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, attention_fn))

    def forward(self, input_ids, input_mask=None, segment_ids=None,
                deterministic: bool = True, generator=None, word_rows=None):
        """``(sequence output, MoE aux loss or None)``. ``word_rows``: the
        pre-gathered [B, S, hidden] word-embedding rows, read in place of
        the table (the sparse embedding-gradient path)."""
        cfg = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        if input_mask is None:
            input_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        if segment_ids is None:
            segment_ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
        positions = torch.arange(s, device=dev)[None, :]
        if self.seq_axis is not None:
            # the local block of a seq-sharded sequence: global positions
            positions = positions + axis_mesh(self.seq_axis).rank * s
        word = self.word_embeddings(input_ids) if word_rows is None else word_rows.to(cfg.dtype)
        x = word + self.position_embeddings(positions) + self.token_type_embeddings(segment_ids)
        x = self.embeddings_LayerNorm(x)
        if not deterministic and cfg.hidden_dropout > 0:
            x = dropout(x, cfg.hidden_dropout, generator)
        # additive mask: 0 where attended, -1e9 where padded
        mask = (1.0 - input_mask[:, None, None, :].float()) * -1e9
        mask = mask.to(cfg.dtype)
        terms = []
        for i in range(cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            if cfg.remat:
                x, load_balance = _remat(layer, x, mask, deterministic, generator)
            else:
                x, load_balance = layer(x, mask, deterministic, generator)
            if load_balance is not None:
                terms.append(load_balance)
        return x, (sum(terms) / len(terms) if terms else None)


class BertClassifier(nn.Module):
    """Encoder + tanh pooler + dropout classifier (run_classifier.py's head).

    With ``seq_axis`` the [CLS] token lives on rank 0 of the axis; its row
    is summed over the axis (zeros elsewhere), so the head runs on the same
    values on every rank, and its parameters are marked invariant over the
    axis (each rank's gradient of them is the whole one)."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 attention_fn: Callable = dense_attention, seq_axis: Optional[str] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.seq_axis = seq_axis
        self.bert = BertEncoder(cfg, attention_fn, seq_axis)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype)
        self.classifier = Dense(cfg.hidden_size, num_classes, torch.float32)
        if seq_axis is not None:
            for head in (self.pooler, self.classifier):
                for p in head.parameters():
                    mark_invariant(p, seq_axis)

    def forward(self, input_ids, input_mask=None, segment_ids=None,
                deterministic: bool = True, generator=None):
        return self.logits_and_aux(input_ids, input_mask, segment_ids, deterministic,
                                   generator)[0]

    def logits_and_aux(self, input_ids, input_mask=None, segment_ids=None,
                       deterministic: bool = True, generator=None, word_rows=None):
        """``(logits, MoE aux loss or None)``; ``word_rows`` as in
        :meth:`BertEncoder.forward`."""
        cfg = self.config
        seq, moe_aux = self.bert(input_ids, input_mask, segment_ids, deterministic,
                                 generator, word_rows)
        cls = seq[:, 0]  # with seq_axis: local token 0 of this rank's block
        if self.seq_axis is not None:
            mesh = axis_mesh(self.seq_axis)
            first = torch.tensor(mesh.rank == 0, device=cls.device)
            cls = tp.reduce_from(torch.where(first, cls, torch.zeros_like(cls)), mesh)
        pooled = torch.tanh(self.pooler(cls))
        if not deterministic and cfg.hidden_dropout > 0:
            pooled = dropout(pooled, cfg.hidden_dropout, generator)
        return self.classifier(pooled.float()), moe_aux


def bert_classifier_bundle(config: BertConfig, num_classes: int = 2,
                           attention_fn: Callable = dense_attention,
                           seq_axis: Optional[str] = None,
                           compute_dtype: Any = None) -> ModelBundle:
    """ModelBundle for CoLA/Yelp-style sequence classification.

    Batches: ``{"input_ids": [B,S], "input_mask": [B,S], "segment_ids":
    [B,S], "label": [B]}`` integer tensors, plus the harness's ``"rng"``
    generator for dropout (``needs_rng=True``). ``init(seed, device)``
    builds the model with random weights from ``seed``. The bundle's
    ``sparse_embed`` hooks name the word-embedding table and give the loss
    with the gathered rows as an argument (``ops/sparse_embed.py``).

    ``compute_dtype`` (``torch.bfloat16``): store the parameters in that
    dtype and run the encoder in it (the classifier head and the loss stay
    float32); pair it with ``adamw(..., master_dtype=torch.float32)``.

    ``seq_axis`` builds the sequence-parallel model (pair it with a
    sequence-parallel ``attention_fn``): its ``loss`` and ``predict`` run on
    a rank's token block under a mesh with that axis, and its parameters are
    the dense model's, so ``init`` draws the same weights. Dropout is
    refused in that mode, as in JAX.
    """
    if seq_axis is not None and (config.hidden_dropout > 0 or config.attention_dropout > 0):
        raise ValueError(
            "sequence-parallel BERT requires hidden_dropout=0 and "
            "attention_dropout=0 (standard for long-context training)"
        )
    if compute_dtype is not None:
        config = dataclasses.replace(config, dtype=compute_dtype)

    def init(seed: int, device) -> BertClassifier:
        model = BertClassifier(config, num_classes, attention_fn, seq_axis)
        init_weights(model, torch.Generator().manual_seed(seed))
        return store_in(model, compute_dtype).to(device)

    def _logits(model, batch, deterministic, word_rows=None):
        return model.logits_and_aux(batch["input_ids"], batch.get("input_mask"),
                                    batch.get("segment_ids"), deterministic,
                                    batch.get("rng"), word_rows)

    def loss_with_rows(model, word_rows, batch):
        """The loss with the word-embedding rows as an argument (None: the
        table's own lookup). With rows given the table goes unused, so the
        caller builds its gradient from d(loss)/d(rows) by scatter-add."""
        logits, moe_aux = _logits(model, batch, False, word_rows)
        # scatter, not F.one_hot: one_hot range-checks its input on the host,
        # a device sync per micro-batch
        onehot = torch.zeros_like(logits).scatter_(-1, batch["label"].long()[:, None], 1.0)
        ce = -torch.mean(torch.sum(onehot * F.log_softmax(logits, dim=-1), dim=-1))
        return ce if moe_aux is None else ce + config.moe_aux_weight * moe_aux

    def loss(model, batch):
        return loss_with_rows(model, None, batch)

    @torch.no_grad()
    def predict(model, batch):
        logits, _ = _logits(model, batch, deterministic=True)
        return {"logits": logits, "classes": torch.argmax(logits, dim=-1),
                "probabilities": torch.softmax(logits, dim=-1)}

    hooks = SparseEmbedHooks(table_path="params/bert/word_embeddings/embedding",
                             ids_key="input_ids", loss_with_rows=loss_with_rows)
    return ModelBundle(init=init, loss=loss, predict=predict,
                       eval_metrics={"accuracy": accuracy()}, needs_rng=True,
                       sparse_embed=hooks)
