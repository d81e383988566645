"""Pipeline-parallel BERT: the flagship model on the GPipe schedule.

The port of ``gradaccum_tpu/models/bert_pp.py``. The dense
``BertClassifier``'s parameter dictionary (``models/bert.py``, JAX's names)
regroups into the ``parallel/pp.py :: PipelineParams`` layout: the
embeddings as the pipe-replicated ``pre``, the encoder layers as
homogeneous stages (layer ``s·m + j`` is stage s's ``sub_j``), the pooler
and classifier as the ``post`` head. The values are the dense model's, so a
pipeline run can be held leaf for leaf against single-device training, and
dense checkpoints (HF imports included) pipeline without conversion.

:func:`bert_pp_fns` gives ``pre_fn`` / ``stage_fn`` / ``loss_fn`` for
``make_pp_train_step``: each applies the port's BERT modules (one template
module per kind, built once) to the parameters it is handed through
``torch.func.functional_call``. With ``remat`` each layer runs under
``torch.utils.checkpoint``, its recompute calling the layer on the same
parameters. Dropout must be 0 and the FFN dense, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from gradaccum_tpu_torch.interop import state_dict_key
from gradaccum_tpu_torch.models.bert import BertConfig, Dense, Embed, EncoderLayer, LayerNorm

EMBED_KEYS = (
    "word_embeddings",
    "position_embeddings",
    "token_type_embeddings",
    "embeddings_LayerNorm",
)


class BertEmbeddings(nn.Module):
    """Embedding sum + LayerNorm, named as ``BertEncoder``'s so dense
    dictionaries regroup without renaming."""

    def __init__(self, config: BertConfig):
        super().__init__()
        cfg = config
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                                         cfg.dtype)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size, cfg.dtype)
        self.embeddings_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, input_ids, segment_ids=None):
        b, s = input_ids.shape
        if segment_ids is None:
            segment_ids = torch.zeros((b, s), dtype=torch.int32, device=input_ids.device)
        positions = torch.arange(s, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(positions)
             + self.token_type_embeddings(segment_ids))
        return self.embeddings_LayerNorm(x)


class BertStage(nn.Module):
    """``layers_per_stage`` encoder layers named ``sub_j``, so every stage's
    parameter dictionary has the same names (stackable)."""

    def __init__(self, config: BertConfig, layers_per_stage: int):
        super().__init__()
        self.layers_per_stage = layers_per_stage
        for j in range(layers_per_stage):
            self.add_module(f"sub_{j}", EncoderLayer(config))


class BertHead(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2):
        super().__init__()
        self.pooler = Dense(config.hidden_size, config.hidden_size, config.dtype)
        self.classifier = Dense(config.hidden_size, num_classes, torch.float32)

    def forward(self, cls):
        pooled = torch.tanh(self.pooler(cls))
        return self.classifier(pooled.float())


def _torch_names(params: Dict[str, torch.Tensor], strip: str = "params/") -> Dict[str, Any]:
    """``{torch state_dict key: tensor}`` for ``functional_call`` from a
    dictionary in JAX's names (``strip`` removed first)."""
    return {state_dict_key(name[len(strip):] if name.startswith(strip) else name): t
            for name, t in params.items()}


def bert_pp_partition(dense_params: Dict[str, torch.Tensor], n_stages: int
                      ) -> Tuple[Dict[str, torch.Tensor], list, Dict[str, torch.Tensor]]:
    """Regroup a dense ``BertClassifier`` dictionary (``params/bert/...``,
    ``params/pooler/...``, ``params/classifier/...``) into ``(pre,
    [stage dicts], post)``: layer ``s*m + j`` becomes stage s's ``sub_j``
    (``m = L / n_stages``; L must divide evenly)."""
    layers = sorted({name.split("/")[2] for name in dense_params
                     if name.startswith("params/bert/layer_")},
                    key=lambda s: int(s.rsplit("_", 1)[1]))
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} encoder layers do not split over {n_stages} stages")
    m = n_layers // n_stages
    pre = {f"params/{name[len('params/bert/'):]}": t for name, t in dense_params.items()
           if name.split("/")[2] in EMBED_KEYS and name.startswith("params/bert/")}
    stages = []
    for s in range(n_stages):
        stage = {}
        for j in range(m):
            head = f"params/bert/{layers[s * m + j]}/"
            stage.update({f"params/sub_{j}/{name[len(head):]}": t
                          for name, t in dense_params.items() if name.startswith(head)})
        stages.append(dict(sorted(stage.items())))
    post = {name: t for name, t in dense_params.items()
            if name.startswith(("params/pooler/", "params/classifier/"))}
    return dict(sorted(pre.items())), stages, post


def bert_pp_merge(params) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`bert_pp_partition` on a whole ``PipelineParams``
    (stages stacked ``[P, ...]``): stage s's ``sub_j`` becomes
    ``layer_{s*m+j}``, so the dense model evaluates pipeline-trained weights."""
    subs = sorted({name.split("/")[1] for name in params.stages},
                  key=lambda s: int(s.rsplit("_", 1)[1]))
    m = len(subs)
    n_stages = next(iter(params.stages.values())).shape[0]
    dense = {f"params/bert/{name[len('params/'):]}": t for name, t in params.pre.items()}
    for s in range(n_stages):
        for j, sub in enumerate(subs):
            head = f"params/{sub}/"
            dense.update({f"params/bert/layer_{s * m + j}/{name[len(head):]}": t[s]
                          for name, t in params.stages.items() if name.startswith(head)})
    dense.update(params.post)
    return dense


def bert_pipeline_spec(cfg: BertConfig, n_stages: int, num_classes: int = 2):
    """The ``parallel/pp.py :: PipelineSpec`` that runs BERT on the pipeline
    through the Estimator (``Estimator(..., mesh=<pipe mesh>,
    pipeline=bert_pipeline_spec(...))``)."""
    from gradaccum_tpu_torch.parallel.pp import PipelineSpec

    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} encoder layers do not split over {n_stages} stages")
    pre_fn, stage_fn, loss_fn = bert_pp_fns(cfg, cfg.num_layers // n_stages, num_classes)
    return PipelineSpec(n_stages=n_stages, partition=bert_pp_partition, merge=bert_pp_merge,
                        pre_fn=pre_fn, stage_fn=stage_fn, loss_fn=loss_fn,
                        input_key="input_ids", ctx_keys=("input_mask",))


def bert_pp_fns(cfg: BertConfig, layers_per_stage: int, num_classes: int = 2):
    """``(pre_fn, stage_fn, loss_fn)`` for ``make_pp_train_step``.

    ``stage_fn`` takes the attention mask through the pipeline's ctx (pass
    ``ctx_keys=("input_mask",)``; without it, no padding). ``loss_fn`` runs
    the pooler and classifier on [CLS] and returns the mean softmax cross
    entropy: the dense bundle's loss (the stages' FFN is dense)."""
    if cfg.hidden_dropout > 0 or cfg.attention_dropout > 0:
        raise ValueError(
            "pipeline-parallel BERT requires hidden_dropout=0 and "
            "attention_dropout=0"
        )
    if cfg.num_experts > 0:
        raise ValueError("pipeline-parallel BERT supports dense FFN only")
    # templates on the meta device: functional_call supplies every parameter
    with torch.device("meta"):
        embed = BertEmbeddings(cfg)
        stage = BertStage(cfg, layers_per_stage)
        head = BertHead(cfg, num_classes)
    subs = [(getattr(stage, f"sub_{j}"), f"params/sub_{j}/") for j in range(layers_per_stage)]

    def pre_fn(pre_params, micro_batch):
        return functional_call(embed, _torch_names(pre_params),
                               (micro_batch["input_ids"], micro_batch.get("segment_ids")))

    def stage_fn(stage_params, x, ctx):
        input_mask = ctx.get("input_mask")
        mask = None
        if input_mask is not None:
            mask = ((1.0 - input_mask[:, None, None, :].float()) * -1e9).to(cfg.dtype)
        for layer, prefix in subs:
            own = {name: t for name, t in stage_params.items() if name.startswith(prefix)}
            weights = _torch_names(own, strip=prefix)

            def run(x_, mask_, layer=layer, weights=weights):
                return functional_call(layer, weights, (x_, mask_, True))[0]

            if cfg.remat:
                # the recompute calls the layer on the same parameters
                x = checkpoint(run, x, mask, use_reentrant=False, preserve_rng_state=False)
            else:
                x = run(x, mask)
        return x

    def loss_fn(post_params, final_acts, labels):
        logits = functional_call(head, _torch_names(post_params), (final_acts[:, 0],))
        onehot = torch.zeros_like(logits).scatter_(-1, labels["label"].long()[:, None], 1.0)
        return -torch.mean(torch.sum(onehot * F.log_softmax(logits, dim=-1), dim=-1))

    return pre_fn, stage_fn, loss_fn
