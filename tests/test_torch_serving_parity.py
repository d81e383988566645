"""The engine-parity gate of the port's serving engine, against JAX.

Three seeded ``SimulationDriver`` traces (JAX's draws: the same requests in
both packages) through the port's engine with the fixed pool and the paged
pool, at ``decode_block`` 1 and 4 and ``decode_block_set=(1, 4)``, greedy
and sampled (temperature 0.8, top_k 5): every request's stream equals the
port's ``generate_cached`` on that request alone, token for token (its seed
as the key), and equals JAX's engine on the same trace. The decode tick
sees one input-shape signature per block size it ran, never more (JAX's
``decode_compile_count``), and the engine ends idle with every block and
reservation back.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.serving import Engine, SimulationDriver
from gradaccum_tpu_torch.utils import prng

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jserving = importlib.import_module("gradaccum_tpu.serving")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SAMPLING = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=5)}
POOLS = {"fixed": {}, "paged": dict(page_size=4)}
BLOCKS = {"block1": dict(decode_block=1), "block4": dict(decode_block=4),
          "set1-4": dict(decode_block_set=(1, 4))}
TRACE = dict(n_requests=9, arrival_rate=0.6, prompt_len=(1, 12), max_new=(1, 12))


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, params_tree(model)


@pytest.fixture(scope="module")
def references(lm):
    """Per (seed, sampling): JAX's engine records on the trace and the port's
    ``generate_cached`` for each request, computed once."""
    jcfg, params, tcfg, tree = lm
    cache = {}

    def get(seed, sampling):
        if (seed, sampling) not in cache:
            kw = SAMPLING[sampling]
            jeng = jserving.Engine(params, jcfg, num_slots=4, max_len=32, **kw)
            jdrv = jserving.SimulationDriver(jeng, seed=seed)
            trace = jdrv.make_trace(**TRACE)
            jax_tokens = [rec["tokens"] for rec in jdrv.run(trace)]
            solo = [tdec.generate_cached(
                tree, tcfg, item.prompt, item.max_new_tokens,
                temperature=kw.get("temperature", 0.0), top_k=kw.get("top_k"),
                rng=prng.PRNGKey(item.rng_seed))[0, item.prompt.size:].tolist()
                for item in trace]
            cache[(seed, sampling)] = (trace, jax_tokens, solo)
        return cache[(seed, sampling)]

    return get


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_streams_equal_generate_cached_and_jax(lm, references, seed, sampling, pool,
                                                      blocks):
    _, _, tcfg, tree = lm
    trace, jax_tokens, solo = references(seed, sampling)
    engine = Engine(tree, tcfg, num_slots=4, max_len=32, device="cpu",
                    **SAMPLING[sampling], **POOLS[pool], **BLOCKS[blocks])
    driver = SimulationDriver(engine, seed=seed)
    assert [(i.arrival_tick, i.prompt.tolist(), i.max_new_tokens) for i in
            driver.make_trace(**TRACE)] == [(i.arrival_tick, i.prompt.tolist(),
                                              i.max_new_tokens) for i in trace]
    records = driver.run(trace)
    for item, rec, want, jax_want in zip(trace, records, solo, jax_tokens):
        assert rec["status"] == "done"
        assert rec["tokens"] == want, (item.prompt, rec["tokens"], want)
        assert rec["tokens"] == jax_want
    ran = set(engine.metrics.summary()["decode_block_ticks"])
    assert engine.decode_compile_count() == len(ran) <= len(engine.decode_block_set)
    assert engine.idle
    if pool == "paged":
        assert engine.pool.allocated_blocks == 0
        assert engine.pool.unreserved_blocks == engine.pool.num_blocks
