"""The port's MoE FFN and MoE BERT held against the JAX package's.

``moe_apply`` gets the same numpy parameters and tokens on both sides
(float32). The router's softmax gates are continuous, so the random inputs
here have no ties: ``torch.topk`` and ``lax.top_k`` may order equal gates
differently, and the parity below holds on inputs without ties. Outputs,
aux values and gradients agree to 1e-5 (summation order only); the dropped
fraction, a count, agrees exactly. The tiny MoE BERT (flash core, dropout
off) agrees with JAX's on logits, loss (which includes 0.01 x the mean
load-balance loss) and every gradient to 1e-5, as the dense BERT does.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax, state_dict_key
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.models import moe as tmoe
from gradaccum_tpu_torch.ops import adamw as tadamw
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.utils import flops as tflops
from gradaccum_tpu_torch.utils.tree import named_parameters

jbert = importlib.import_module("gradaccum_tpu.models.bert")
jmoe = importlib.import_module("gradaccum_tpu.models.moe")
jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")
jflops = importlib.import_module("gradaccum_tpu.utils.flops")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

D, HID, E, T = 16, 32, 4, 24
TOL = dict(rtol=1e-5, atol=1e-5)
LEAVES = ("router", "w_in", "b_in", "w_out", "b_out")


def moe_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(D, E)).astype(np.float32) / 4,
            "w_in": rng.normal(size=(E, D, HID)).astype(np.float32) / 4,
            "b_in": rng.normal(size=(E, HID)).astype(np.float32) / 10,
            "w_out": rng.normal(size=(E, HID, D)).astype(np.float32) / 6,
            "b_out": rng.normal(size=(E, D)).astype(np.float32) / 10}


def tokens(seed=1, shape=(T, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def run_jax(params, x, cf, k):
    y, aux = jmoe.moe_apply({n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x),
                            cf, k)
    return np.asarray(y), {n: float(v) for n, v in aux.items()}


def run_port(params, x, cf, k):
    y, aux = tmoe.moe_apply({n: torch.tensor(v) for n, v in params.items()}, torch.tensor(x),
                            cf, k)
    return y.numpy(), {n: float(v) for n, v in aux.items()}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_matches_jax(top_k, capacity_factor):
    params, x = moe_params(), tokens()
    y_j, aux_j = run_jax(params, x, capacity_factor, top_k)
    y_t, aux_t = run_port(params, x, capacity_factor, top_k)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    assert aux_t["dropped_fraction"] == aux_j["dropped_fraction"]
    for name in ("load_balance_loss", "router_entropy"):
        np.testing.assert_allclose(aux_t[name], aux_j[name], err_msg=name, **TOL)
    if capacity_factor < 1:
        assert aux_t["dropped_fraction"] > 0  # the case really drops tokens


def test_moe_leading_dims_fold_like_jax():
    params, x = moe_params(2), tokens(3, shape=(2, T // 2, D))
    y_j, _ = run_jax(params, x, 1.25, 2)
    y_t, _ = run_port(params, x, 1.25, 2)
    assert y_t.shape == x.shape
    np.testing.assert_allclose(y_t, y_j, **TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_gradients_match_jax(top_k):
    params, x = moe_params(4), tokens(5)
    g = tokens(6)

    def jloss(p, x_):
        y, aux = jmoe.moe_apply(p, x_, 1.0, top_k)
        return jnp.sum(y * g) + aux["load_balance_loss"]

    jp = {n: jnp.asarray(v) for n, v in params.items()}
    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_apply(tp, tx, 1.0, top_k)
    loss = torch.sum(y * torch.tensor(g)) + aux["load_balance_loss"]
    grads = torch.autograd.grad(loss, list(tp.values()) + [tx])
    for name, got in zip(list(tp) + ["x"], grads):
        want = gx_j if name == "x" else gp_j[name]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


def test_moe_refuses_a_bad_top_k():
    params = {n: torch.tensor(v) for n, v in moe_params().items()}
    for k in (0, E + 1):
        with pytest.raises(ValueError, match="top_k"):
            tmoe.moe_apply(params, torch.tensor(tokens()), 1.25, k)


def make_batch(seed=0, n=4, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, s)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, s), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


MOE_CFG = dict(num_experts=4, moe_top_k=2, hidden_dropout=0.0, attention_dropout=0.0)


@functools.lru_cache(maxsize=None)
def jax_side():
    cfg = jbert.BertConfig.tiny_for_tests(**MOE_CFG)
    core = functools.partial(jfa.flash_attention, block_q=16, block_k=16)
    bundle = jbert.bert_classifier_bundle(cfg, attention_fn=core)
    batch = make_batch()
    params = bundle.init(jax.random.PRNGKey(0), {k: v[:1] for k, v in batch.items()})
    loss, grads = jax.value_and_grad(bundle.loss)(params, dict(batch, rng=jax.random.PRNGKey(1)))
    logits = bundle.predict(params, batch)["logits"]
    return (jax.device_get(params), float(loss), np.asarray(logits),
            dict(jtree.named_leaves(jax.device_get(grads))))


def port_model():
    cfg = tbert.BertConfig.tiny_for_tests(**MOE_CFG)
    bundle = tbert.bert_classifier_bundle(cfg, attention_fn=tfa.flash_attention)
    model = bundle.init(0, "cpu")
    model.load_state_dict(params_from_jax(jax_side()[0]))
    return bundle, model


def torch_batch(batch):
    return dict({k: torch.as_tensor(v) for k, v in batch.items()},
                rng=torch.Generator().manual_seed(0))


def test_moe_bert_logits_loss_and_grads_match_jax():
    _, loss_j, logits_j, grads_j = jax_side()
    bundle, model = port_model()
    tb = torch_batch(make_batch())
    np.testing.assert_allclose(bundle.predict(model, tb)["logits"].numpy(), logits_j, **TOL)
    named = named_parameters(model)
    loss = bundle.loss(model, tb)
    np.testing.assert_allclose(loss.item(), loss_j, **TOL)
    grads = torch.autograd.grad(loss, list(named.values()))
    grads_t = dict(jtree.named_leaves(params_to_jax(dict(zip(named, grads)))))
    assert grads_t.keys() == grads_j.keys()
    for name in grads_j:
        np.testing.assert_allclose(grads_t[name], np.asarray(grads_j[name]), err_msg=name,
                                   **TOL)


def test_moe_bert_loss_adds_the_load_balance_term():
    bundle, model = port_model()
    tb = torch_batch(make_batch(3))
    logits, aux = model.logits_and_aux(tb["input_ids"], tb["input_mask"], tb["segment_ids"],
                                       False, tb["rng"])
    ce = torch.nn.functional.cross_entropy(logits, tb["label"].long())
    assert aux.item() > 0
    np.testing.assert_allclose(bundle.loss(model, tb).item(), (ce + 0.01 * aux).item(),
                               rtol=1e-6)
    layer = model.bert.layer_0.moe
    assert set(layer.last_aux) == {"load_balance_loss", "dropped_fraction", "router_entropy"}


def test_moe_interop_names_layouts_and_decay_match_jax():
    params = jax_side()[0]
    jax_names = dict(jtree.named_leaves(params))
    _, model = port_model()
    named = named_parameters(model)
    assert list(named) == list(jax_names)
    moe_names = [n for n in named if n.split("/")[-2] == "moe"]
    assert sorted({n.split("/")[-1] for n in moe_names}) == sorted(LEAVES)
    for name in moe_names:  # raw arrays: the same layout on both sides, no transpose
        np.testing.assert_array_equal(named[name].detach().numpy(), np.asarray(jax_names[name]))
    assert state_dict_key("params/bert/layer_0/moe/w_in") == "bert.layer_0.moe.w_in"
    back = dict(jtree.named_leaves(params_to_jax(named)))
    for name, arr in jax_names.items():
        np.testing.assert_array_equal(back[name], np.asarray(arr), err_msg=name)
    mask_j = dict(jtree.named_leaves(
        jadamw._decay_mask(params, jadamw.DEFAULT_WEIGHT_DECAY_EXCLUSIONS)))
    mask_t = tadamw.decay_mask(named, tadamw.DEFAULT_WEIGHT_DECAY_EXCLUSIONS)
    assert mask_t == {n: bool(v) for n, v in mask_j.items()}
    # b_in/b_out hold no "bias": they decay, in JAX and in the port
    assert all(mask_t[n] for n in moe_names)


def test_moe_init_draws_every_expert_leaf():
    cfg = tbert.BertConfig.tiny_for_tests(num_experts=3)
    model = tbert.bert_classifier_bundle(cfg).init(5, "cpu")
    moe = model.bert.layer_1.moe
    assert moe.w_in.shape == (3, cfg.hidden_size, cfg.intermediate_size)
    assert moe.router.std().item() == pytest.approx(cfg.hidden_size ** -0.5, rel=0.3)
    assert moe.w_out.std().item() == pytest.approx(cfg.intermediate_size ** -0.5, rel=0.3)
    assert not moe.b_in.any() and not moe.b_out.any()


@pytest.mark.parametrize("experts,top_k", [(0, 1), (8, 1), (8, 2)])
def test_moe_flops_match_jax(experts, top_k):
    args = (512, 4, 2048, 128, 2)
    assert tflops.bert_train_flops_per_seq(*args, num_experts=experts, moe_top_k=top_k) == \
        jflops.bert_train_flops_per_seq(*args, num_experts=experts, moe_top_k=top_k)


def test_padded_batch_drops_the_same_fraction_as_jax(monkeypatch):
    """The MoE drop rate seen on the card (0.40 at BERT-Small width on the
    synthetic sentences) is a property of the padded batch, not of the
    port: at reduced width (H 128, 8 experts, top-2, capacity 1.25, dense
    attention, dropout 0) with JAX's weights carried across and a batch
    that is >= 85 % padding, every layer drops exactly the fraction JAX's
    drops. Padding tokens differ only by position and crowd the same
    experts."""
    cfg_kw = dict(vocab_size=200, hidden_size=128, num_layers=2, num_heads=2,
                  intermediate_size=256, max_position_embeddings=64, num_experts=8,
                  moe_top_k=2, hidden_dropout=0.0, attention_dropout=0.0)
    rng = np.random.default_rng(11)
    n, s = 8, 64
    lengths = rng.integers(3, 9, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    assert 1 - mask.mean() >= 0.85
    batch = {"input_ids": (rng.integers(5, 200, size=(n, s)) * mask).astype(np.int32),
             "input_mask": mask, "segment_ids": np.zeros((n, s), np.int32),
             "label": np.zeros(n, np.int32)}
    jb = jbert.bert_classifier_bundle(jbert.BertConfig(**cfg_kw))
    params = jb.init(jax.random.PRNGKey(0), {k: v[:1] for k, v in batch.items()})
    dropped_j = []
    apply = jmoe.moe_apply

    def recording(*args, **kw):
        y, aux = apply(*args, **kw)
        dropped_j.append(float(aux["dropped_fraction"]))
        return y, aux

    monkeypatch.setattr(jmoe, "moe_apply", recording)
    jb.predict(params, batch)
    tb = tbert.bert_classifier_bundle(tbert.BertConfig(**cfg_kw))
    model = tb.init(0, "cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    tb.predict(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    dropped_t = [float(getattr(model.bert, f"layer_{i}").moe.last_aux["dropped_fraction"])
                 for i in range(2)]
    assert len(dropped_j) == 2 and dropped_t == dropped_j
    assert max(dropped_t) > 0.1  # the padded batch really overflows the experts
