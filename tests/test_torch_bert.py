"""The port's BERT classifier held against the JAX package's.

``BertConfig.tiny_for_tests()`` at S=16 with dropout off: the JAX bundle
(flash core, Pallas interpret mode, blocks 16) is initialised from
``PRNGKey(0)`` and its parameters are carried into the port with
``params_from_jax``; both then see the same numpy batch. Logits and loss
agree to 1e-5 and every named gradient to 1e-5 (float32 throughout; only
summation order differs).
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax, state_dict_key
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.ops import adamw as tadamw
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.utils.tree import named_parameters

jbert = importlib.import_module("gradaccum_tpu.models.bert")
jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

N, S = 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def make_batch(seed=0, n=N, s=S, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    seg = ((np.arange(s)[None, :] >= lengths[:, None] // 2) * mask).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, s)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": seg,
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


def torch_batch(batch, seed=0):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["rng"] = torch.Generator().manual_seed(seed)
    return out


@functools.lru_cache(maxsize=None)
def jax_side():
    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    core = functools.partial(jfa.flash_attention, block_q=16, block_k=16)
    bundle = jbert.bert_classifier_bundle(cfg, attention_fn=core)
    batch = make_batch()
    params = bundle.init(jax.random.PRNGKey(0), {k: v[:1] for k, v in batch.items()})
    jb = dict(batch, rng=jax.random.PRNGKey(1))
    loss, grads = jax.value_and_grad(bundle.loss)(params, jb)
    logits = bundle.predict(params, batch)["logits"]
    return (jax.device_get(params), float(loss), np.asarray(logits),
            dict(jtree.named_leaves(jax.device_get(grads))))


def port_model(attention_fn=tfa.flash_attention, **cfg_kw):
    cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0,
                                          **cfg_kw)
    bundle = tbert.bert_classifier_bundle(cfg, attention_fn=attention_fn)
    model = bundle.init(0, "cpu")
    model.load_state_dict(params_from_jax(jax_side()[0]))
    return bundle, model


def test_names_and_weights_round_trip():
    params = jax_side()[0]
    jax_names = dict(jtree.named_leaves(params))
    _, model = port_model()
    named = named_parameters(model)
    assert list(named) == list(jax_names)  # same names, same (flatten) order
    back = dict(jtree.named_leaves(params_to_jax(named)))
    for name, arr in jax_names.items():
        np.testing.assert_array_equal(back[name], np.asarray(arr), err_msg=name)
    assert state_dict_key("params/bert/layer_0/attention/query/kernel") == \
        "bert.layer_0.attention.query.weight"


def test_logits_and_loss_match_jax():
    _, loss_j, logits_j, _ = jax_side()
    bundle, model = port_model()
    tb = torch_batch(make_batch())
    np.testing.assert_allclose(bundle.predict(model, tb)["logits"].numpy(), logits_j, **TOL)
    np.testing.assert_allclose(bundle.loss(model, tb).item(), loss_j, **TOL)


def test_every_named_gradient_matches_jax():
    grads_j = jax_side()[3]
    bundle, model = port_model()
    named = named_parameters(model)
    loss = bundle.loss(model, torch_batch(make_batch()))
    grads = torch.autograd.grad(loss, list(named.values()))
    grads_t = dict(jtree.named_leaves(params_to_jax(dict(zip(named, grads)))))
    assert grads_t.keys() == grads_j.keys()
    for name in grads_j:
        np.testing.assert_allclose(grads_t[name], np.asarray(grads_j[name]),
                                   err_msg=name, **TOL)


def test_decay_mask_name_sets_match_jax():
    params = jax_side()[0]
    mask_j = dict(jtree.named_leaves(
        jadamw._decay_mask(params, jadamw.DEFAULT_WEIGHT_DECAY_EXCLUSIONS)))
    _, model = port_model()
    mask_t = tadamw.decay_mask(named_parameters(model),
                               tadamw.DEFAULT_WEIGHT_DECAY_EXCLUSIONS)
    assert {n for n, on in mask_t.items() if on} == {n for n, on in mask_j.items() if on}
    assert {n for n, on in mask_t.items() if not on} == {n for n, on in mask_j.items() if not on}


def test_dense_attention_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 2, 16, 8)).astype(np.float32) for _ in range(3))
    mask = np.where(np.arange(16) < 11, 0.0, -1e9).astype(np.float32)[None, None, None, :]
    want = np.asarray(jbert.dense_attention(q, k, v, mask))
    got = tbert.dense_attention(*(torch.tensor(x) for x in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_and_dense_cores_agree_in_the_port():
    _, flash_model = port_model()
    bundle, dense_model = port_model(attention_fn=tbert.dense_attention)
    tb = torch_batch(make_batch(seed=4))
    np.testing.assert_allclose(bundle.loss(flash_model, tb).item(),
                               bundle.loss(dense_model, tb).item(), **TOL)


def test_dropout_follows_the_generator():
    cfg = tbert.BertConfig.tiny_for_tests()  # hidden and attention dropout 0.1
    bundle = tbert.bert_classifier_bundle(cfg, attention_fn=tfa.flash_attention)
    model = bundle.init(0, "cpu")
    batch = make_batch(seed=5)
    losses = [bundle.loss(model, torch_batch(batch, seed=s)).item() for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
    deterministic = bundle.predict(model, torch_batch(batch))["logits"]
    assert torch.equal(deterministic, bundle.predict(model, torch_batch(batch, 9))["logits"])


@pytest.mark.parametrize("kw", [dict(seq_axis="seq"), dict(compute_dtype=torch.bfloat16)])
def test_unported_options_raise(kw):
    # seq_axis was refused before the sequence-parallel slice: it now raises
    # only JAX's refusal of dropout (tests/test_torch_sp.py holds the model
    # against JAX) and draws the dense model's parameters; compute_dtype was
    # refused before the mixed-precision slice and now stores the parameters
    # in bfloat16 (tests/test_torch_mixed.py holds its forward against JAX)
    if "seq_axis" in kw:
        with pytest.raises(ValueError, match="sequence-parallel BERT requires"):
            tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests(), **kw)
        from gradaccum_tpu_torch.utils.tree import named_parameters

        cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
        sp = named_parameters(tbert.bert_classifier_bundle(cfg, **kw).init(0, "cpu"))
        dense = named_parameters(tbert.bert_classifier_bundle(cfg).init(0, "cpu"))
        assert sp.keys() == dense.keys()
        assert all(torch.equal(sp[k], dense[k]) for k in sp)
        return
    model = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests(), **kw).init(0, "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_moe_raises():
    # the MoE FFN is ported (tests/test_torch_moe.py holds it against JAX);
    # what still raises is a top-k outside [1, num_experts], as in JAX
    cfg = tbert.BertConfig.tiny_for_tests(num_experts=2, moe_top_k=3)
    bundle = tbert.bert_classifier_bundle(cfg)
    model = bundle.init(0, "cpu")
    assert hasattr(model.bert.layer_0, "moe") and not hasattr(model.bert.layer_0, "intermediate")
    with pytest.raises(ValueError, match="top_k=3"):
        bundle.loss(model, torch_batch(make_batch(seed=6)))
