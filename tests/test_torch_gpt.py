"""The port's GPT decoder held against JAX's ``models/gpt.py``.

``GPTConfig.tiny_for_tests(dropout=0.0)`` at S=16: JAX's bundle is
initialised from ``PRNGKey(0)`` and its parameters carried into the port
with ``params_from_jax``; both then see the same numpy token ids.

- Logits and loss within 1e-5, every named gradient within 1e-4 (float32),
  with the dense core and its [S, S] causal mask, and with
  ``causal_flash_attention`` (JAX's Pallas kernels in interpret mode,
  blocks 16; the port's plain versions on the CPU): no mask is built there.
- ``compute_dtype=bfloat16``: parameters stored in bfloat16, the forward
  within bfloat16 tolerance of JAX's from the same bfloat16 weights.
- ``greedy_generate`` appends the same tokens as JAX's; ``token_accuracy``
  and the masked loss equal JAX's; a sequence past the position table
  raises; names and weights round-trip through ``interop.py``; the logits
  are causal.
- The bf16-vs-f32 loss-curve gate of ``tests/test_mixed.py``: a bfloat16
  model with float32 masters and a float32 model train on one repeated
  batch for 6 updates, both end below 0.8x their first loss, and the
  bfloat16 loss stays within 8 % of the float32 loss at every update.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as topt
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.utils.tree import named_parameters

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

N, S = 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 forward against JAX's from the same bfloat16 weights: every
# product rounds to bfloat16 (2^-8 relative) in another order; the head is
# float32 over a bfloat16 final LayerNorm
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _jax_flash():
    core = functools.partial(jfa.causal_flash_attention, block_q=16, block_k=16)
    core.handles_causality = True
    core.inkernel_dropout = True
    return core


def ids(seed=0, n=N, s=S, vocab=96):
    return np.random.default_rng(seed).integers(0, vocab, size=(n, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_side(flash: bool):
    cfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    bundle = jgpt.gpt_lm_bundle(cfg, attention_fn=_jax_flash()) if flash \
        else jgpt.gpt_lm_bundle(cfg)
    batch = {"input_ids": ids()}
    params = bundle.init(jax.random.PRNGKey(0), batch)
    loss, grads = jax.value_and_grad(bundle.loss)(params, dict(batch, rng=jax.random.PRNGKey(1)))
    logits = bundle.predict(params, batch)["logits"]
    return (jax.device_get(params), float(loss), np.asarray(logits),
            dict(jtree.named_leaves(jax.device_get(grads))))


def port_model(flash: bool, compute_dtype=None):
    cfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    core = tfa.causal_flash_attention if flash else tgpt.dense_attention
    bundle = tgpt.gpt_lm_bundle(cfg, attention_fn=core, compute_dtype=compute_dtype)
    model = bundle.init(0, "cpu")
    model.load_state_dict(params_from_jax(jax_side(False)[0]))
    return bundle, model


def _batch(x, seed=0):
    return {"input_ids": torch.as_tensor(x), "rng": torch.Generator().manual_seed(seed)}


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "causal-flash"])
def test_logits_loss_and_gradients_match_jax(flash):
    params, loss_j, logits_j, grads_j = jax_side(flash)
    # one initialisation for both cores: the carried weights are the same
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(params),
                                                    jax.tree.leaves(jax_side(False)[0])))
    bundle, model = port_model(flash)
    tfa.reset_launch_counts()
    np.testing.assert_allclose(bundle.predict(model, _batch(ids()))["logits"].numpy(),
                               logits_j, **TOL)
    named = named_parameters(model)
    loss = bundle.loss(model, _batch(ids()))
    np.testing.assert_allclose(loss.item(), loss_j, **TOL)
    grads = torch.autograd.grad(loss, list(named.values()))
    grads_t = dict(jtree.named_leaves(params_to_jax(dict(zip(named, grads)))))
    assert grads_t.keys() == grads_j.keys()
    for name in grads_j:
        np.testing.assert_allclose(grads_t[name], np.asarray(grads_j[name]), err_msg=name,
                                   **GRAD_TOL)
    # CPU tensors reach the plain versions, never a kernel
    assert sum(tfa.launch_counts().values()) == 0


def test_bf16_storage_forward_matches_jax():
    params = jax_side(False)[0]
    cfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    jb = jgpt.gpt_lm_bundle(cfg, compute_dtype=jnp.bfloat16)
    jparams = jtree.tree_cast_floating(params, jnp.bfloat16)
    bundle, model = port_model(False, compute_dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    got = bundle.predict(model, _batch(ids()))["logits"]
    want = np.asarray(jb.predict(jparams, {"input_ids": ids()})["logits"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
    np.testing.assert_allclose(bundle.loss(model, _batch(ids())).item(),
                               float(jb.loss(jparams, {"input_ids": ids(),
                                                       "rng": jax.random.PRNGKey(0)})),
                               **BF16_TOL)


def test_greedy_generate_matches_jax():
    params = jax_side(False)[0]
    jb = jgpt.gpt_lm_bundle(jgpt.GPTConfig.tiny_for_tests(dropout=0.0))
    prompt = ids(seed=3, n=1, s=6)[0]
    want = np.asarray(jgpt.greedy_generate(params, jb, prompt, 5))
    for flash in (False, True):
        _, model = port_model(flash)
        got = tgpt.greedy_generate(model, prompt, 5)
        assert got.shape == (1, 11)
        np.testing.assert_array_equal(got.numpy(), want)
    sampled = [tgpt.greedy_generate(model, prompt, 4, temperature=1.0,
                                    generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(*sampled)
    with pytest.raises(ValueError, match="generator"):
        tgpt.greedy_generate(model, prompt, 2, temperature=1.0)


def test_token_accuracy_and_masked_loss_match_jax():
    params, _, logits_j, _ = jax_side(False)
    bundle, model = port_model(False)
    mask = (np.arange(S)[None, :] < np.asarray([16, 9, 4, 12])[:, None]).astype(np.int32)
    batch = {"input_ids": ids(), "loss_mask": mask}
    outputs = bundle.predict(model, {"input_ids": torch.as_tensor(ids())})
    metric, jmetric = tgpt.token_accuracy(), jgpt.token_accuracy()
    for b in ({"input_ids": ids()}, batch):
        total, count = metric.update(outputs, b)
        jtotal, jcount = jmetric.update({"logits": logits_j}, b)
        assert (total, count) == (float(jtotal), float(jcount))
        assert metric.finalize(total, count) == float(jmetric.finalize(jtotal, jcount))
    got = tgpt.next_token_loss(outputs["logits"], torch.as_tensor(ids()), torch.as_tensor(mask))
    want = jgpt.next_token_loss(logits_j, ids(), mask)
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_position_check_causality_and_interop_round_trip():
    params = jax_side(False)[0]
    bundle, model = port_model(False)
    with pytest.raises(ValueError, match="exceeds max_position_embeddings 64"):
        model(torch.zeros((1, 65), dtype=torch.long))
    jax_names = dict(jtree.named_leaves(params))
    named = named_parameters(model)
    assert list(named) == list(jax_names)
    assert {"params/final_LayerNorm/scale", "params/position_embeddings/embedding",
            "params/layer_1/mlp_LayerNorm/bias",
            "params/layer_0/attention_LayerNorm/scale"} <= set(named)
    back = dict(jtree.named_leaves(params_to_jax(named)))
    for name, arr in jax_names.items():
        np.testing.assert_array_equal(back[name], np.asarray(arr), err_msg=name)
    a = ids(seed=4, n=2)
    b = a.copy()
    b[:, 9:] = (b[:, 9:] + 7) % 96
    la = bundle.predict(model, {"input_ids": torch.as_tensor(a)})["logits"]
    lb = bundle.predict(model, {"input_ids": torch.as_tensor(b)})["logits"]
    assert torch.allclose(la[:, :9], lb[:, :9], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(la[:, -1], lb[:, -1])


def test_bf16_vs_f32_loss_curve():
    """tests/test_mixed.py::test_bf16_vs_f32_gpt_loss_curve in the port:
    micro-batch 4 x K=2, seq 16, AdamW lr 1e-2 (weight decay 0.01), one
    batch repeated for 6 updates, dropout 0."""
    cfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    batch = tacc.stack_micro_batches({"input_ids": torch.as_tensor(ids(seed=9, n=8))}, 2)

    def run(compute_dtype, opt):
        bundle = tgpt.gpt_lm_bundle(cfg, compute_dtype=compute_dtype)
        model = bundle.init(3, "cpu")
        step = tacc.accumulate_scan(lambda p, b: bundle.loss(model, b), opt,
                                    tacc.GradAccumConfig(2), needs_rng=True)
        state = tacc.scan_init(named_parameters(model), opt)
        gen = torch.Generator().manual_seed(0)
        losses = []
        for _ in range(6):
            state, aux = step(state, batch, gen)
            losses.append(float(aux["loss"]))
        return losses

    f32 = run(None, topt.adamw(1e-2, weight_decay_rate=0.01))
    bf16 = run(torch.bfloat16, topt.adamw(1e-2, weight_decay_rate=0.01,
                                          master_dtype=torch.float32))
    assert f32[-1] < f32[0] * 0.8 and bf16[-1] < bf16[0] * 0.8
    for a, b in zip(f32, bf16):
        assert abs(a - b) / max(abs(a), 1e-6) < 0.08, (f32, bf16)
