"""Remat (activation checkpointing per encoder layer) in the port's BERT.

With dropout 0.1 the layer draws its hidden-dropout masks and its flash
seed from the batch's generator, which ``torch.utils.checkpoint`` does not
restore for the recompute. The layer replays its draws, so remat and no
remat give bitwise equal losses, gradients and updates, and leave the
generator in the same state. Against JAX's ``remat=True`` (dropout off,
flash core in interpret mode) logits, loss and every gradient agree to
1e-5, as without remat (tests/test_torch_bert.py).
"""

import dataclasses
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as tadamw
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.utils.tree import named_parameters

jbert = importlib.import_module("gradaccum_tpu.models.bert")
jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def make_batch(seed=0, n=4, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, s)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, s), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


def tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def bundle_and_model(remat, **cfg_kw):
    cfg = tbert.BertConfig.tiny_for_tests(remat=remat, **cfg_kw)
    bundle = tbert.bert_classifier_bundle(cfg, attention_fn=tfa.flash_attention)
    return bundle, bundle.init(0, "cpu")


@pytest.mark.parametrize("num_experts", [0, 2])
def test_remat_gradients_are_bitwise_equal_with_dropout(num_experts):
    results = {}
    for remat in (False, True):
        bundle, model = bundle_and_model(remat, num_experts=num_experts)
        named = named_parameters(model)
        gen = torch.Generator().manual_seed(11)
        loss = bundle.loss(model, dict(tensors(make_batch(1)), rng=gen))
        grads = torch.autograd.grad(loss, list(named.values()))
        results[remat] = (loss, grads, gen.get_state())
    (l0, g0, s0), (l1, g1, s1) = results[False], results[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)  # the recompute drew nothing from the caller's generator
    # dropout really ran: another generator seed moves the loss
    bundle, model = bundle_and_model(True, num_experts=num_experts)
    other = bundle.loss(model, dict(tensors(make_batch(1)), rng=torch.Generator().manual_seed(12)))
    assert not torch.equal(other, l1)


def test_remat_scan_update_is_bitwise_equal():
    k = 2
    finals = {}
    for remat in (False, True):
        bundle, model = bundle_and_model(remat)
        opt = tadamw.adamw(1e-3)
        step = tacc.accumulate_scan(lambda p, b, m=model: bundle.loss(m, b), opt,
                                    tacc.GradAccumConfig(k, clip_norm=1.0), needs_rng=True)
        state = tacc.scan_init(named_parameters(model), opt)
        gen = torch.Generator().manual_seed(3)
        for i in range(2):
            sb = tacc.stack_micro_batches(tensors(make_batch(10 + i, n=2 * k)), k)
            state, _ = step(state, sb, gen)
        finals[remat] = state.params
    assert all(torch.equal(finals[False][n], finals[True][n]) for n in finals[False])


def test_remat_recomputes_each_layer_forward(monkeypatch):
    calls = []
    plain = tfa.flash_forward_reference

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(tfa, "flash_forward_reference", counted)
    counts = {}
    for remat in (False, True):
        bundle, model = bundle_and_model(remat)
        calls.clear()
        loss = bundle.loss(model, dict(tensors(make_batch(2)), rng=torch.Generator()))
        loss.backward()
        counts[remat] = len(calls)
    layers = tbert.BertConfig.tiny_for_tests().num_layers
    assert counts == {False: layers, True: 2 * layers}


@functools.lru_cache(maxsize=None)
def jax_remat_side():
    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0,
                                          remat=True)
    core = functools.partial(jfa.flash_attention, block_q=16, block_k=16)
    bundle = jbert.bert_classifier_bundle(cfg, attention_fn=core)
    batch = make_batch()
    params = bundle.init(jax.random.PRNGKey(0), {k: v[:1] for k, v in batch.items()})
    loss, grads = jax.value_and_grad(bundle.loss)(params, dict(batch, rng=jax.random.PRNGKey(1)))
    logits = bundle.predict(params, batch)["logits"]
    return (jax.device_get(params), float(loss), np.asarray(logits),
            dict(jtree.named_leaves(jax.device_get(grads))))


def test_remat_matches_jax_remat():
    params, loss_j, logits_j, grads_j = jax_remat_side()
    bundle, model = bundle_and_model(True, hidden_dropout=0.0, attention_dropout=0.0)
    assert dataclasses.asdict(model.config)["remat"] is True
    model.load_state_dict(params_from_jax(params))
    tb = dict(tensors(make_batch()), rng=torch.Generator())
    np.testing.assert_allclose(bundle.predict(model, tb)["logits"].numpy(), logits_j, **TOL)
    named = named_parameters(model)
    loss = bundle.loss(model, tb)
    np.testing.assert_allclose(loss.item(), loss_j, **TOL)
    grads = dict(jtree.named_leaves(params_to_jax(dict(
        zip(named, torch.autograd.grad(loss, list(named.values())))))))
    for name in grads_j:
        np.testing.assert_allclose(grads[name], np.asarray(grads_j[name]), err_msg=name, **TOL)
