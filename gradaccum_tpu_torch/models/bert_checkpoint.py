"""Pretrained BERT checkpoints in the HuggingFace format, read without transformers.

The port of ``gradaccum_tpu/models/bert_checkpoint.py``. The reference
fine-tunes a pretrained BERT-Small; its weights travel as a saved
HuggingFace model directory (``config.json`` plus ``model.safetensors``,
its sharded form with ``model.safetensors.index.json``, or
``pytorch_model.bin``). JAX reads it through ``transformers``; the port
reads the directory itself, so it needs neither ``transformers`` nor
``safetensors``:

- ``config.json`` with ``json``; keys it lacks take
  ``transformers.BertConfig``'s defaults (older google-converted configs
  omit some);
- ``.safetensors`` files with :func:`read_safetensors` (an 8-byte
  little-endian header length, a JSON header of ``dtype``/``shape``/
  ``data_offsets``, then the raw bytes; F32, F16 and BF16);
- ``pytorch_model.bin`` with ``torch.load(weights_only=True)``.

The HF names map onto the port's (the JAX package's) parameter names:

==========================================  =====================================
HF name (a leading ``bert.`` is stripped)   port name, under ``params/bert/``
==========================================  =====================================
embeddings.word_embeddings.weight           word_embeddings/embedding
embeddings.position_embeddings.weight       position_embeddings/embedding
embeddings.token_type_embeddings.weight     token_type_embeddings/embedding
embeddings.LayerNorm.{weight,bias}          embeddings_LayerNorm/{scale,bias}
encoder.layer.N.attention.self.query.*      layer_N/attention/query/{kernel,bias}
encoder.layer.N.attention.self.key.*        layer_N/attention/key/*
encoder.layer.N.attention.self.value.*      layer_N/attention/value/*
encoder.layer.N.attention.output.dense.*    layer_N/attention/output/*
encoder.layer.N.attention.output.LayerNorm  layer_N/attention_LayerNorm
encoder.layer.N.intermediate.dense.*        layer_N/intermediate/*
encoder.layer.N.output.dense.*              layer_N/ffn_output/*
encoder.layer.N.output.LayerNorm            layer_N/output_LayerNorm
pooler.dense.*                              params/pooler/* (top level)
classifier.*                                params/classifier/* (top level)
==========================================  =====================================

HF's ``Linear.weight`` is [out, in], which is torch's layout too: no
transpose here (JAX transposes it into a flax kernel). Every tensor comes
out float32, as JAX's ``_np`` makes it.

Where JAX's ``AutoModel`` would differ from a plain reading: the classifier
head is taken only when ``architectures`` names a ``*SequenceClassification``
class (``AutoModel`` drops it otherwise); a tensor the model needs but the
files lack raises with the missing names (``AutoModel`` would draw fresh
random weights, which no reference can match).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from gradaccum_tpu_torch.models.bert import BertConfig

# transformers.BertConfig's defaults, for keys a config.json omits
HF_BERT_DEFAULTS = {
    "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
    "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
}
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


# --------------------------------------------------------------------------
# reading the files
# --------------------------------------------------------------------------


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, in its stored dtype (F32,
    F16 or BF16; another dtype raises), as CPU tensors that own their
    memory."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", blob[:8])
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header length {n} runs past the file end")
    header = json.loads(blob[8:8 + n])
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}; only "
                             f"{sorted(_SAFETENSORS_DTYPES)} are read")
        shape = [int(d) for d in entry["shape"]]
        start, end = (int(x) for x in entry["data_offsets"])
        numel = 1
        for d in shape:
            numel *= d
        if not 0 <= start <= end <= len(data) or end - start != numel * dtype.itemsize:
            raise ValueError(f"{path}: {name} data_offsets [{start}, {end}] do not hold "
                             f"{shape} {entry['dtype']} in {len(data)} data bytes")
        chunk = bytearray(data[start:end])  # a copy the tensor owns
        t = torch.frombuffer(chunk, dtype=dtype) if numel else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def read_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a saved HF model directory, as transformers finds
    it: ``model.safetensors``, else the shards named by
    ``model.safetensors.index.json``, else ``pytorch_model.bin``."""
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    pickled = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(single):
        return read_safetensors(single)
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, torch.Tensor] = {}
        for shard in shards:
            out.update(read_safetensors(os.path.join(path, shard)))
        return out
    if os.path.exists(pickled):
        return torch.load(pickled, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{path}: no model.safetensors, model.safetensors.index.json "
                            "or pytorch_model.bin")


# --------------------------------------------------------------------------
# mapping
# --------------------------------------------------------------------------


def _hf_names(config: BertConfig) -> Dict[str, str]:
    """``{port name: HF name}`` for every tensor of the encoder and pooler."""
    names = {}

    def dense(port, hf):
        names[f"{port}/kernel"] = f"{hf}.weight"
        names[f"{port}/bias"] = f"{hf}.bias"

    def layer_norm(port, hf):
        names[f"{port}/scale"] = f"{hf}.weight"
        names[f"{port}/bias"] = f"{hf}.bias"

    b = "params/bert"
    for table in ("word", "position", "token_type"):
        names[f"{b}/{table}_embeddings/embedding"] = f"embeddings.{table}_embeddings.weight"
    layer_norm(f"{b}/embeddings_LayerNorm", "embeddings.LayerNorm")
    for i in range(config.num_layers):
        port, hf = f"{b}/layer_{i}", f"encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            dense(f"{port}/attention/{proj}", f"{hf}.attention.self.{proj}")
        dense(f"{port}/attention/output", f"{hf}.attention.output.dense")
        layer_norm(f"{port}/attention_LayerNorm", f"{hf}.attention.output.LayerNorm")
        dense(f"{port}/intermediate", f"{hf}.intermediate.dense")
        dense(f"{port}/ffn_output", f"{hf}.output.dense")
        layer_norm(f"{port}/output_LayerNorm", f"{hf}.output.LayerNorm")
    dense("params/pooler", "pooler.dense")
    return names


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32).contiguous().clone()


def convert_hf_state_dict(state_dict: Mapping[str, Any], config: BertConfig,
                          num_classes: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``{port name: float32 tensor}`` for :class:`models.bert.BertClassifier`.

    Keys may carry a leading ``bert.`` (``BertForSequenceClassification``)
    or not (``BertModel``). A tensor the model needs and the dict lacks
    raises with the missing names. The classifier head is taken when the
    dict has one (its width must be ``num_classes`` when that is given),
    else zero-initialized at ``num_classes``.
    """
    sd = {(key[len("bert."):] if key.startswith("bert.") else key): value
          for key, value in state_dict.items()}
    names = _hf_names(config)
    missing = sorted(hf for hf in names.values() if hf not in sd)
    if missing:
        raise ValueError(f"the checkpoint lacks {len(missing)} tensor(s) the model "
                         f"needs: {missing}")
    params = {port: _f32(sd[hf]) for port, hf in names.items()}
    if "classifier.weight" in sd:
        kernel, bias = _f32(sd["classifier.weight"]), _f32(sd["classifier.bias"])
        if num_classes is not None and kernel.shape[0] != num_classes:
            raise ValueError(
                f"checkpoint classifier head has {kernel.shape[0]} classes but "
                f"num_classes={num_classes}; drop the head from the state dict or "
                "match num_classes")
    else:
        if num_classes is None:
            raise ValueError("checkpoint has no classifier head; pass num_classes to "
                             "zero-initialize one (the fine-tune head)")
        kernel = torch.zeros(num_classes, config.hidden_size)
        bias = torch.zeros(num_classes)
    params["params/classifier/kernel"] = kernel
    params["params/classifier/bias"] = bias
    return params


def config_from_hf(hf_config: Mapping[str, Any], **overrides) -> BertConfig:
    """:class:`BertConfig` from a parsed ``config.json``; missing keys take
    ``transformers.BertConfig``'s defaults. An activation other than the
    original BERT erf-GELU raises rather than converting to a silently
    different model."""
    c = dict(HF_BERT_DEFAULTS, **hf_config)
    if c["hidden_act"] != "gelu":
        raise ValueError(
            f"checkpoint uses hidden_act={c['hidden_act']!r}; models.bert implements "
            "the original BERT erf-gelu only — converting would silently change the "
            "forward pass")
    kw = dict(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        type_vocab_size=c["type_vocab_size"], hidden_dropout=c["hidden_dropout_prob"],
        attention_dropout=c["attention_probs_dropout_prob"],
        layer_norm_eps=c["layer_norm_eps"],
    )
    kw.update(overrides)
    return BertConfig(**kw)


def load_hf_checkpoint(path: str, num_classes: int = 2,
                       **config_overrides) -> Tuple[BertConfig, Dict[str, torch.Tensor]]:
    """A saved HF BERT model directory -> ``(BertConfig, {name: tensor})``,
    ready for ``Estimator(warm_start=...)``: the reference pointing
    ``run_classifier.py`` at the downloaded BERT-Small checkpoint."""
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    state_dict = read_hf_state_dict(path)
    architectures = hf_config.get("architectures") or []
    if not any("SequenceClassification" in a for a in architectures):
        # a base model has no head, whatever the files hold
        state_dict = {key: v for key, v in state_dict.items()
                      if not key.startswith("classifier.")}
    config = config_from_hf(hf_config, **config_overrides)
    return config, convert_hf_state_dict(state_dict, config, num_classes=num_classes)
