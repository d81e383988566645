"""Cells cut to a size the CPU tests can run in a second: the same files,
configurations and traffic, every width and depth small."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import spec

CELLS = ("bert-large.seq512", "gpt2-medium.seq1024", "bert-large.seq512.f32")


def tiny_cell(name: str, precision=None) -> dict:
    c = copy.deepcopy(spec.cell(name))
    conf, mix = c["config"], c["mix"]
    if conf["family"] == "bert_classifier":
        conf.update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64, vocab_size=1200, max_position_embeddings=64)
        mix.update(seq_len=32, median=12, min=4, max=32, micro_batch=4,
                   num_micro_batches=2, vocab_size=1200)
    else:
        conf.update(n_embd=32, n_layer=2, n_head=2, vocab_size=96, n_positions=64, n_ctx=64)
        mix.update(seq_len=32, median=20, min=4, max=64, micro_batch=4, num_micro_batches=2,
                   vocab_size=96, eos_id=95)
    c["work"]["reference_block_rows"] = 2
    if precision is not None:
        c["work"]["precision"] = precision
    return c


def card():
    """Skip unless a CUDA card is here (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
