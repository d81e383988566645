"""The memory ladder, measured end to end: optimizer state and KV bytes.

The port of ``tools/bench_mem.py``. Two legs, one result:

**Optimizer state bytes** — a small GPT (vocab 512, H 128, L 2, A 4, FFN
256, seq 64, batch 8) trained with Adam at float32 moments (8 B/param), q8
moments (blockwise int8, ~2.05 B/param) and Adam-mini with a q8 first moment
(~1.03 B/param); the bytes are counted from the real ``(m, v)`` state after
training, and every leg's loss must fall.

**KV bytes per resumable stream** — the serving engine, GPT
``tiny_for_tests``, twice over the same 16-stream greedy workload at equal
memory (the same pool bytes, the same host-swap budget of 16384 bytes).
At tick 24 every stream holding KV is preempted at once (a full drain), and
each leg is judged on how many streams stay RESUMABLE (a swap record
survives):

- ``bf16+host``: a bfloat16 pool, records in the bounded host store, which
  evicts the oldest once the budget is spent (those streams re-prefill);
  its records hold the bfloat16 bits as ``int16`` (``serving/swap.py``);
- ``int8+tiered``: an int8 pool (more blocks for the same bytes) with the
  host rung of the tiered store at the same budget, so drained records ride
  the disk rung and every stream stays resumable.

The metric is RAM bytes (pool + host budget) per stream held resumable.
Each churned leg must emit the same tokens as a calm run of its dtype on an
uncontended pool.

JAX's acceptance: >= 4x lower optimizer state bytes per parameter for the
top rung with every loss falling, >= 2x lower KV RAM per resumable stream,
and parity. ``--fast`` trains 8 steps instead of 30. One JSON line per row
on standard output and the acceptance; ``--out FILE`` writes the whole
result (no default file, so JAX's ``BENCH_mem.json`` is never overwritten).
Runs on the card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_mem [--fast] [--steps N]
        [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SEQ = 64
BATCH = 8
DRAIN_TICK = 24
HOST_BUDGET = 16384


def _state_bytes(state) -> int:
    from gradaccum_tpu_torch.memory.quant import QuantTensor

    total = 0
    for tree in (state.m, state.v):
        for leaf in tree.values():
            if isinstance(leaf, QuantTensor):
                total += leaf.nbytes
            else:
                total += leaf.numel() * leaf.element_size()
    return total


def optimizer_ladder(steps: int, device):
    import numpy as np
    import torch

    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.ops.adamw import adam, adam_mini

    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                    intermediate_size=256, max_position_embeddings=SEQ, dropout=0.0)
    bundle = gpt_lm_bundle(cfg)
    rng = np.random.default_rng(20260807)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))).to(device)
    batch = {"input_ids": ids}
    legs = [("f32", adam(1e-3)), ("q8", adam(1e-3, moment_dtype="q8")),
            ("adam_mini+q8", adam_mini(1e-3, moment_dtype="q8"))]
    rows = []
    for name, opt in legs:
        model = bundle.init(0, device)
        params = dict(model.named_parameters())
        n_params = sum(p.numel() for p in params.values())
        state = opt.init(params)
        with torch.no_grad():
            first = float(bundle.loss(model, batch))
        for step in range(steps):
            model.zero_grad(set_to_none=True)
            bundle.loss(model, batch).backward()
            grads = {n: p.grad for n, p in params.items()}
            new, state = opt.update(grads, state, params, step)
            with torch.no_grad():
                for n, p in params.items():
                    if new[n] is not p:
                        p.copy_(new[n])
        with torch.no_grad():
            final = float(bundle.loss(model, batch))
        rows.append({"config": name, "n_params": int(n_params),
                     "state_bytes_per_param": round(_state_bytes(state) / n_params, 4),
                     "first_loss": round(first, 5), "final_loss": round(final, 5)})
    base = rows[0]["state_bytes_per_param"]
    for r in rows:
        r["ladder_vs_f32"] = round(base / r["state_bytes_per_param"], 3)
    return rows


def serve_leg(params, cfg, prompts, gen, num_blocks, device, drain=False, **kw):
    """One engine run; at DRAIN_TICK (if asked) preempt every stream holding
    KV and count the records the swap store kept."""
    from gradaccum_tpu_torch.serving import Engine

    eng = Engine(params, cfg, num_slots=len(prompts), max_len=48, page_size=4,
                 num_blocks=num_blocks, device=device, **kw)
    rids = [eng.submit(p, gen) for p in prompts]
    drained = resumable = tick = 0
    while not eng.idle:
        eng.step()
        tick += 1
        if drain and tick == DRAIN_TICK:
            drained = sum(bool(eng.preempt(r)) for r in rids)
            resumable = len(eng._swap_store)
    tokens = [list(eng.results[r]) for r in rids]
    tiers = eng._swap_store.stats() if kw.get("swap") == "tiered" else None
    return tokens, drained, resumable, tiers, eng


def kv_ladder(device):
    import numpy as np
    import torch

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    params = params_tree(gpt_lm_bundle(cfg).init(0, device))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32) for _ in range(16)]
    gen = 24
    # equal memory: the same pool bytes (the int8 pool gets more blocks for
    # them) and the same host-swap budget
    tb_bf16 = 2 * cfg.num_layers * cfg.hidden_size * 2
    tb_int8 = 2 * cfg.num_layers * (cfg.hidden_size + cfg.num_heads * 4)
    blocks_bf16 = 24
    pool_bytes = blocks_bf16 * 4 * tb_bf16
    blocks_int8 = pool_bytes // (4 * tb_int8)
    tok_bf, dr_bf, res_bf, _, _ = serve_leg(
        params, cfg, prompts, gen, blocks_bf16, device, drain=True,
        cache_dtype=torch.bfloat16, admission="optimistic", swap="host",
        swap_max_bytes=HOST_BUDGET)
    tok_i8, dr_i8, res_i8, tiers, _ = serve_leg(
        params, cfg, prompts, gen, blocks_int8, device, drain=True, cache_dtype=torch.int8,
        admission="optimistic", swap="tiered", swap_max_bytes=HOST_BUDGET)
    # calm runs on uncontended pools, one per dtype (int8 and bf16 logits
    # differ in their low bits)
    calm_bf = serve_leg(params, cfg, prompts, gen, 128, device, cache_dtype=torch.bfloat16)[0]
    calm_i8 = serve_leg(params, cfg, prompts, gen, 128, device, cache_dtype=torch.int8)[0]
    ram = pool_bytes + HOST_BUDGET

    def row(name, drained, resumable, tokens, calm):
        return {"config": name, "streams": len(prompts), "device_pool_bytes": int(pool_bytes),
                "host_swap_budget_bytes": HOST_BUDGET, "streams_drained": int(drained),
                "streams_resumable_after_drain": int(resumable),
                "ram_bytes_per_resumable_stream": round(ram / max(resumable, 1), 1),
                "all_streams_complete": all(len(t) == gen for t in tokens),
                "greedy_parity_vs_calm": tokens == calm}

    rows = [dict(row("bf16+host", dr_bf, res_bf, tok_bf, calm_bf), token_bytes=tb_bf16,
                 num_blocks=int(blocks_bf16)),
            dict(row("int8+tiered", dr_i8, res_i8, tok_i8, calm_i8), token_bytes=tb_int8,
                 num_blocks=int(blocks_int8), tier_demotions=tiers["demotions"],
                 tier_promotions=tiers["promotions"], tier_evictions=tiers["evictions"])]
    if not (dr_bf >= 2 and dr_i8 >= 2):
        raise RuntimeError("the drain found no streams with KV")
    if not (tiers["demotions"] >= 1 and tiers["promotions"] >= 1):
        raise RuntimeError("the disk rung was never exercised")
    return rows


def kv_verdict(rows):
    """The KV ladder's half of JAX's acceptance: ``(ladder, passed)``, the
    ladder the bf16 row's RAM per resumable stream over the int8 row's,
    passed at >= 2x with every stream complete and equal to its calm run."""
    ladder = (rows[0]["ram_bytes_per_resumable_stream"]
              / rows[1]["ram_bytes_per_resumable_stream"])
    parity = all(r["greedy_parity_vs_calm"] and r["all_streams_complete"] for r in rows)
    return ladder, bool(ladder >= 2.0 and parity)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="8 training steps instead of 30")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None, help="write the whole result here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    steps = args.steps if args.steps is not None else (8 if args.fast else 30)
    opt_rows = optimizer_ladder(steps, device)
    for r in opt_rows:
        print(json.dumps(r))
    kv_rows = kv_ladder(device)
    for r in kv_rows:
        print(json.dumps(r))
    kv_x, kv_ok = kv_verdict(kv_rows)
    state_x = opt_rows[-1]["ladder_vs_f32"]
    all_train = all(r["final_loss"] < r["first_loss"] for r in opt_rows)
    passed = state_x >= 4.0 and all_train and kv_ok
    result = {
        "bench": "quantized tiered memory ladder (q8 optimizer moments + Adam-mini; int8 KV "
                 "over host->disk tiers)",
        "device": str(device),
        "optimizer_state_ladder": opt_rows,
        "kv_stream_ladder": kv_rows,
        "state_bytes_ladder_vs_f32": state_x,
        "kv_ram_per_stream_ladder_vs_bf16": round(kv_x, 3),
        "acceptance": {
            "required": ">=4x optimizer state bytes/param vs the f32 baseline with every "
                        "leg's loss decreasing, AND >=2x lower KV RAM per stream held "
                        "resumable through a full pool drain vs bf16 host-swap paging at "
                        "equal device-pool + host-swap bytes, with greedy parity through "
                        "forced tier demotions/promotions",
            "measured_state_ladder": state_x,
            "measured_kv_ladder": round(kv_x, 3),
            "passed": bool(passed),
        },
    }
    print(json.dumps({"acceptance": result["acceptance"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
