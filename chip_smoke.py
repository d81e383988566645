#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA H100.

    python3 chip_smoke.py     # one card, about fifteen minutes

Phases, each of which fails the run if it fails:

1. build: compile every CUDA source of ``gradaccum_tpu_torch/csrc`` with
   nvcc (one process per source, all started together); print the time and
   each kernel's registers and spills as ptxas reports them, and fail if
   any float32 or bfloat16 kernel (forward, dq, dk/dv; all six Hopper
   designs: TMA, mbarriers, wgmma) spills at any head dim, or if ptxas
   serializes the wgmma of the float32 forward, dq or dk/dv kernel or of
   the bfloat16 dq kernel (its C7515 report; every kernel it serializes is
   printed).
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the BERT-Small main-path shape q/k/v [8, 8, 128, 64], in float32
   (``flash_attention.cu``: forward, dq and dk/dv on the tensor cores in
   3xTF32) and bfloat16 (``flash_attention_tc.cu``), with a padded mask
   and without, causal, and with attention dropout 0.1 under a fixed seed;
   in both dtypes also at ragged lengths S = 100 and 200 and at head dims
   16, 32 and 128; and at GPT's shapes,
   causal, no mask, dropout 0.1: [8, 8, 512, 64] in bfloat16 and float32
   (GPT-Small) and [16, 4, 64, 32] in float32 (``gpt_lm``). The dq
   kernel's delta = rowsum(dO * O) is held against the plain one. Read the
   keep mask back out of the forward, dq and dk/dv kernels (float32 and
   bfloat16, both at S = 200, and at both GPT shapes) and require it equal
   to the plain mask bit for bit; and, as one rank's heads under tensor
   parallelism, the kernels on heads 4-7 of [8, 8, 128, 64] told their
   place (``head_offset=4, heads_total=8``): their keep mask exactly the
   slice of the 8-head plain mask, and o, lse, dq, dk, dv within TOL of
   the slice of the plain version's outputs on all 8 heads, in float32 and
   bfloat16; and the kernels of each dtype launched first from a fresh
   thread (as autograd's device thread launches them), their outputs equal
   to the main thread's. Then time each kernel, its plain version
   and the PyTorch call that computes the same function
   (scaled_dot_product_attention's forward, and its backward, which
   computes dq, dk and dv together, for both backward kernels; never used
   by the port), at the main path's conditions in bfloat16 and in float32
   (``bert_finetune``'s default dtype), and at GPT-Small's (bf16 and
   float32 [8, 8, 512, 64], causal: SDPA with is_causal=True) and
   ``gpt_lm``'s (float32 [16, 4, 64, 32], causal).
3. agree: the tiny BERT classifier's loss and gradients on the card (through
   the kernels) against the same model on the CPU (plain versions).
4. main: the entry point ``gradaccum_tpu_torch/examples/bert_finetune.py``
   at BERT-Small width (L-4 H-512 A-8, vocab 30522, seq 128), micro-batch
   8 x K=4, bfloat16 compute, random weights from a seed, scan mode, for a
   few optimizer updates and its evaluations (after the first chunk and at
   the end). The kernels' launch counts are zeroed just before and read
   just after, and must match the path exactly, with every launch on the
   tensor-core route.
5. profile: a torch.profiler window over three more updates of the same
   run: wall and card-busy time per update, idle share, top kernels; before
   it, the bf16 kernels' tensor-map lookups and encodes in one update.
6. streaming: the same entry point in streaming mode (the reference's
   tf.cond train op, first-step quirk on), 8 windows of K=4 = 32 micro-batch
   calls and its evaluations; launch counts exact and all on the tensor
   cores, applies at micro-batch steps 0, 4, ..., 28; then a profile window
   over three of its updates (12 host steps), as in phase 5.
7. stream=scan: BERT-Small bf16 with dropout 0, the same weights and
   batches, 2 windows of quirk-free streaming against 2 scan updates: every
   float32 parameter within 1e-6 (the accumulation order is the same).
8. guard: streaming and scan BERT-Small bf16 with skip_nonfinite and a
   dynamic loss scale; one micro-batch of the first window and all of the
   second have a NaN loss. The skip counts must be exact, the all-bad
   window must leave parameters and moments bitwise unchanged, the scale
   must halve at each dirty window, and every parameter stay finite.
9. mnist / housing: the MNIST entry point, variants 01 (batch 200, K=1) and
   02 (batch 100, K=2), and the housing entry point (batch 59, K=3), in
   streaming mode on synthetic data: finite loss that falls below its first
   value, accuracy or MAE/RMSE and 5 predictions.
10. xla-bwd: ``flash_attention(bwd_impl="xla")`` (the forward kernel, then
    autograd through the blockwise core) against the kernels' backward
    (``"pallas"``) at [8, 8, 128, 64], float32 and bfloat16, with a padded
    mask and without, causal and not: dq, dk, dv and dmask within the TOL
    table (float32) or XLA_BWD_TOL (bfloat16). Per call the forward kernel
    launches once and the dq and dk/dv kernels never.
11. warm start: a BERT-Small HuggingFace directory (config.json,
    model.safetensors from a seeded generator, a 30522-line vocab.txt)
    and train/dev TSVs written here, then the entry point with
    ``--hf-checkpoint DIR --data-dir DIR --bf16``: before the first update
    every parameter equals the file's tensor bit for bit and the classifier
    is zero; then a few updates and the evaluations, launch counts exact
    and on the tensor cores.
12. remat: BERT-Small bf16, dropout 0.1, one scan update with remat and
    one without from the same weights, batch and generator seed: every
    parameter bitwise equal, the forward kernel launched twice as often in
    training (the recompute), the backward kernels as often; peak memory
    of both.
13. sparse embed: BERT-Small bf16, dropout 0, 2 scan updates with the
    word-embedding gradient accumulated as rows against the dense path,
    every parameter within SPARSE_ATOL; then a profile window of the entry
    point with ``--sparse-embed-grad``.
14. MoE: the entry point at BERT-Small width with 8 experts, top-2, bf16,
    scan: finite loss, exact launch counts; the loss is the cross entropy
    plus 0.01 x the mean load-balance loss; the dropped fraction, seq/s and
    MFU (against the MoE FLOPs).

15. GPT-Small ladder: GPT-Small (vocab 50257, L-4 H-512 A-8, FFN 2048),
    seq 512, micro 8 x K=4, dropout 0.1, on the causal flash kernels,
    seeded token ids, scan mode through the Estimator, four updates a leg:
    (a) float32 AdamW, (b) bfloat16 parameters with float32 masters, (c) (b)
    with fused Adam-accumulation, (d) (b) with q8 moments, (e) Adam-mini
    with masters and q8 moments; clip 1.0 except (c). Per leg: optimizer +
    accumulator and parameter bytes per parameter, peak memory above the
    starting state, seq/s and tokens/s, finite losses, launches exactly 16
    per kernel per update (on the float32 route ``tf32x3`` in (a), ``tc``
    otherwise). Then fused against two-pass bitwise at K=1 after one
    update, and 6 updates on one repeated batch with dropout 0: the bf16 +
    master loss within 8 % of the float32 loss at each, both below 0.8x
    their first. Then a profile window over two bf16 + master updates, and
    one over two float32 updates (leg (a)).
16. GPT guard: GPT-Small bf16 + master at depth 2, fused, skip_nonfinite and
    a dynamic loss scale, streaming and scan; NaN loss in one micro-batch of
    the first window and in all of the second: skip counts exact, the
    all-bad window a bitwise no-op over parameters, masters and moments,
    the scale halving at each dirty window.
17. gpt_lm: the entry point with ``--flash`` (float32, route ``tf32x3``),
    scan and streaming, 32 micro-steps and ``--sample 40`` (decoded with the
    KV cache, which launches no flash kernel): the loss falls, token
    accuracy in [0, 1], launch counts exact from its JSON line.
18. bert f32: the entry point ``bert_finetune`` at its default dtype
    (float32, no ``--bf16``), BERT-Small width, seq 128, micro-batch 8 x
    K=4, scan, 2 updates and its evaluations: the only entry-point run of
    the float32 forward with a padded mask. Launch counts exact, every
    launch on the float32 route ``tf32x3``.

19. dp: data parallelism and ZeRO-1 (``gradaccum_tpu_torch/parallel``) on
    the one card. (a) World size 1 over NCCL: BERT-Small bf16 scan, micro 8
    x K=4, three updates through ``Estimator(mesh=...)``, parameters and
    moments bitwise equal to the no-mesh run from the same weights and
    batches, launch counts exact and on ``tc``, exactly one all-reduce per
    update; the NCCL kernels' card time from a profiler window over two
    more updates, and seq/s beside the no-mesh run's. (b) Two ranks that
    share the card over gloo, spawned here (``python3 chip_smoke.py
    --dp-rank DIR`` is a rank): explicit DP, BERT-Small bf16, micro 4 per
    rank x K=4, dropout 0, two updates, then ZeRO-1 ``"collective"`` on the
    same run; each rank within 1e-5 of the single-process run on the same
    global batches (each rank's micro-batches run on one card, so only the
    order of the sums differs) and ZeRO-1 within 1e-7 of DP; launch counts
    exact per rank; optimizer + accumulator bytes per parameter. (c) GPT-Small
    bf16 + float32 masters + fused + ZeRO-1 (ladder leg (c), ``zero1=True``)
    at the two ranks, two updates: bytes per parameter per rank (JAX's
    accounting: 6), peak memory per rank, a finite loss.

20. resilience (``resilience/``, ``obs/``, the Estimator's hooks), BERT-Small
    bf16 micro 8 x K=4, dropout 0.1, random weights from the run seed:
    (a) streaming, async checkpoints every 3 micro-steps, a crash injected
    after a seeded micro-step inside a window; a fresh Estimator resumes
    from the newest checkpoint (itself mid-window) and its parameters, m, v,
    accumulators and post-resume losses are bitwise those of the
    uninterrupted run; the flight dump holds the fault; the uninterrupted
    run's train/step spans carry the accumulate/apply labels. (b) One byte of
    the newest checkpoint flipped: quarantined, and the restore equals the
    previous checkpoint exactly. (c) The process sends itself SIGTERM: the
    final checkpoint lands at that micro-step with the async writer drained,
    and the resume is bitwise. (d) Two gloo ranks share the card through the
    launcher (``python3 chip_smoke.py --drain-rank DIR`` is a rank), explicit
    DP in scan mode; rank 1 alone is preempted, and DrainConsensus over the
    c10d store stops both at the same micro-step, where the final checkpoint
    lands. (e) A StepWindowProfiler window of 2 updates writes a Chrome trace
    holding K1, K2 and K3 under their kernel names (32 each); the scan spans
    are labelled scan-cycle. (f) Card-busy ms per update and seq/s with obs
    and the async writer on, then both off, a checkpoint every update: a
    finding, printed, not a gate.
21. export: BERT-Small exported in float32 (route ``tf32x3``) and bf16
    (``tc``) through ``Estimator.export_model`` from a one-row sample, and
    ``gpt_lm --flash --export-dir`` and ``housing --export-dir`` after their
    training; one fresh process that imports only
    ``gradaccum_tpu_torch.estimator.export`` loads every artifact and calls
    it at batch 8 and 3: outputs within 1e-6 (float32) / 1e-2 (bf16) of
    ``predict`` on the same weights and batch, classes equal, the flash
    forward launched inside each kernel artifact on the expected route
    (counted by the wrapper and by the profiler), none in housing's, no
    model module imported. Then the native reader (``data/native.py``) is
    built and byte-identical to the numpy readers on a generated idx pair
    and CSV, and the flash wrapper's wall time per call is printed
    (``utils/call_overhead.py``). The exports run before phase 20, and the
    loader process beside it; the checks come after it.

22. model parallelism (``parallel/{mesh,sharding,tp,zero}.py``, the models'
    collectives): ranks spawned here share the card over gloo
    (``python3 chip_smoke.py --mp-rank DIR N`` is a rank), each leg against
    the same run in one process (tp=1) from the same seed and batches,
    BERT-Small (vocab 30522, L-4 H-512 A-8, seq 128), micro 8 x K=4, through
    ``Estimator(mesh=make_mesh(...), sharding_rules=...)``. (a) tp=2 in
    float32 (route ``tf32x3``), dropout 0.1, 3 updates: losses within
    relative 1e-5, each update's norm before clipping within NORM_RTOL,
    the gathered parameters within rtol 2e-4, atol 2e-5 (JAX's
    ``tests/test_tp.py``); each rank's kernels launched on [8, 4, 128, 64]
    with its head offset, seen in a profiler window. (b) The same in
    bfloat16 (``tc``), held to TOL's bfloat16 limits. (c) 8 experts top-2,
    bf16, tp=2 x ep=2 (4 ranks, ``bert_tp_ep_rules``), 2 updates: the
    dropped fraction of every layer exactly the one process's. (d) dp=2 x
    tp=2, ZeRO-1 with the rules, Adam-mini, dropout 0, float32, 2 updates,
    within 1e-5; bytes per parameter per rank; its checkpoint (the global
    state) restored in one process bitwise equal to the gathered state.
    Every leg's collectives per update must equal the design's count
    (``_mp_predicted_calls``, PERF.md); gloo's SUM/MIN all-reduce,
    all-gather and broadcast are asked on a ``new_group`` subgroup with CUDA
    tensors, and so are ``ppermute`` (round the ring and along a pipeline)
    and ``all_to_all`` in float32 and bfloat16, their received values
    checked.

23. sequence and pipeline parallelism (``parallel/{ring_attention,ulysses,
    sp,pp}.py``, ``models/bert_pp.py``) and long context: ranks spawned here
    share the card over gloo (``python3 chip_smoke.py --sppp-rank DIR N`` is
    a rank), BERT-Small float32, dropout 0, micro 8 x K=4, 2 updates of SGD
    at lr 1 with the clip at 1 through the Estimator, each leg against the
    same run in one process from the same seed and batches: (a) sp=2 ring at
    seq 512 (the dense twin evaluating), (b) the same with Ulysses, (c)
    pipe=2 at seq 128 with the guard, rank 0's stage output of one
    micro-batch NaN: it is skipped on both ranks as in the one process
    (whose loss sees a NaN in that micro-batch), and the global checkpoint
    restores in one process bitwise; (d) data=2 x pipe=2. Losses within
    relative 1e-5, parameters within rtol 2e-4, atol 2e-5, and each tensor's
    move from its initial value within 1e-3 of the one-process move in norm
    (plus 1e-6 of the whole move, for gradients zero but for rounding);
    every leg's collectives per update equal the design's count
    (``_sppp_predicted_calls``, PERF.md); ``ppermute`` and ``all_to_all``
    asked on every mesh axis in both dtypes, values checked; gloo's
    send/recv of a CUDA tensor asked in two ranks of their own
    (``--p2p-rank``; a finding). (e) ``bench_longcontext`` at S = 512, 2048
    and 8192 (16384 tokens per step, bf16), all four cores, the sharded ones
    at 2 seq ranks, 5 iterations: ms per step, tokens/s and peak memory of
    each row, the flash leg's launches per step exact; no flash, ring or
    Ulysses row may fail; each kernel against its plain version in bf16
    within TOL at [32, 8, 512, 64], [8, 8, 2048, 64] and [2, 8, 8192, 64]
    (dropout 0; 0.1 too at 2048), and timed at those shapes beside its
    bound, plain version and SDPA in a process of its own
    (``--longctx-timing PATH``). Every time in the kernels line says how it
    was taken (``ms_from``: the profiler's device events, or CUDA events
    where the profiler kept losing events).

24. serving (``models/gpt_decode.py``, ``serving/``): GPT-Small (vocab
    50257, L-4 H-512 A-8, FFN 2048, 512 positions), float32, random weights
    from SERVE_SEED. (a) A fixed-pool engine (8 slots, max_len 512, decode
    block 8) and a paged engine of equal pool bytes (page 16, 32 slots)
    each serve a seeded ``SimulationDriver`` trace of 24 requests (prompts
    16-256 tokens, 16-96 new): every stream equals ``generate_cached`` on
    the card token for token; a difference prints its first position and
    the reference's top-2 logit gap there, and fails. (b) The same at
    temperature 0.8, top-k 50, against ``generate_cached`` with the
    request's seed. (c) ``ServingServer`` over a paged engine: a request
    cancelled after its first token gives its slot and blocks back, 8
    concurrent streams equal ``generate_cached``, a full queue rejects. (d)
    ``bench_serving`` default and ``--paged`` legs (tokens/s serial and
    engine, TTFT p50/p99 in wall ms and in ticks, KV bytes per token in
    flight; results in ``build/chip_smoke_serving/``). (e) A profiler
    window over 4 ticks of the sampled fixed engine: wall and card-busy ms
    per tick, idle share, launches per micro-step (model, sampling, engine)
    and the top kernels, in a process of its own (``--serving-profile``:
    late in the script profiler windows lose events). No flash kernel
    launches in this phase.

25. prefix sharing, copy-on-write and speculative decoding, the same
    GPT-Small model. (a) A seeded trace of 24 requests sharing a 192-token
    system prompt (unique tails of 4-40 tokens, 16-64 new; the leader at
    tick 0, then four a tick) through paged engines of equal pool bytes
    (page 16, decode block 8): prefix off, prefix on without COW tails, and
    COW on, greedy and at T 0.8 top-k 50. Every stream equals the other
    legs' and ``generate_cached``'s token for token (a difference passes
    only where the reference's top-2 logit gap is under NEAR_TIE, and is
    printed), and each pool ends with no block allocated; per leg: prefill
    tokens computed and skipped, hit rate, blocks saved, KV bytes per token
    in flight, tokens/s, TTFT p50/p99 in wall ms and in ticks. Then
    sub-page sharing: a prompt sharing 8 tokens of the leader's tail page
    forks it at admission, an identical one forks at its first decode
    write; both streams equal ``generate_cached``. (b) Speculation, k = 4,
    a draft of the target's first layer (``truncate_draft_params``), on
    phase 24's trace, the fixed and the paged pool: greedy streams equal
    ``generate_cached`` (the near-tie rule again), sampled ones complete and
    identical over two runs; the accept rate, tokens per cycle, and tokens/s
    at closed load against the non-speculative engine (decode block 8);
    then a target whose layers past the first add nothing (their attention
    output and ``ffn_output`` scaled by 0, as JAX's ``tools/bench_spec.py``
    builds it), whose accept rate must read >= 0.95. (c) ``bench_serving
    --prefix`` at JAX's full bench config; its acceptance passes. (d) A
    profiler window over 4 sampled speculative cycles, 8 slots, in a
    process of its own (``--spec-profile``): launches per cycle split into
    the draft's steps, its sampling, the verify step and the accept rule,
    card-busy ms per cycle and the idle share. No flash kernel launches.

26. admission control, preemption and swap, int8 KV and overlapped
    prefill, the same GPT-Small model, every tensor on the card. (a)
    ``bench_admission``'s long-tail trace (28 requests declaring 20 new, 8
    slots, 16 blocks of 4) through reserve, quantile and optimistic: every
    stream against ``generate_cached`` under the near-tie rule, a real
    preemption in the optimistic leg, and the best overcommitting leg at
    1.5x reserve or more on requests per 1k ticks or peak concurrency
    (JAX's acceptance); per leg those, the preemptions, swap-outs,
    swap-ins, re-prefills and wall tokens/s. (b) 8 requests admitted at
    once into a pool their decode runs dry, one also preempted by
    ``Engine.preempt``, under host, recompute and tiered swap (a host rung
    of 4 pages, so records reach disk): host and tiered streams equal the
    calm run's token for token, re-prefilled ones under the near-tie rule;
    a rotted record falls back once; the ms and MiB/s of a swap-out and a
    swap-in of one 256-position request beside the ms of re-prefilling it.
    (c) ``kv_quantize`` on the card bitwise its CPU run; the int8 engine
    churned through the tiered store equals a calm int8 engine token for
    token; int8 against float32 agreement (recorded) and KV bytes per
    position; ``bench_mem``'s KV ladder to JAX's acceptance. (d) phase 24's
    trace with ``overlap_prefill`` on and off, identical streams; ms and
    card-busy ms per tick and the idle share of both over 4 profiled ticks
    (``--overlap-profile``, a process of its own). (e) No flash kernel
    launches.

27. serving recovery, the watchdog and the live ops plane, the same
    GPT-Small model. (a) The CPU tests' fault schedule through
    ``ServingServer`` (every request submitted before the loop starts):
    ``MID_DECODE_TICK`` in the lockstep tick (fixed pool) and after both
    dispatches of the overlapped one, ``POOL_PAGE_TABLE`` ``corrupt`` on a
    paged pool with a prefix cache (``BlockTableCorruption`` at upload),
    a crash mid speculative cycle (k = 4, overlapped), and ``MID_SWAP_IO``
    crashing a victim's swap-out on phase 26's overcommitted leg: each
    fault recovered once, every in-slot request requeued, the requeued
    streams equal the calm run's under the near-tie rule, the pool
    invariants after every recover (free + live blocks, refcounts against
    the page tables, the prefix index, swap records); the ms of each
    ``recover()`` and of the requeued re-prefills; then
    ``max_engine_faults + 1`` consecutive faults fail every handle and
    ``stop()`` raises. (b) A ``slow_tick`` of 10x ``watchdog_timeout``
    fails its handle within twice the timeout; one of 0.1x is harmless.
    (c) A server with a sentinel, ``default_serving_objectives`` and
    ``telemetry_port=0``: two ticks slowed by 1 s fire
    ``latency_cliff`` once, ``bind_default_remediations`` recovers and
    requeues with token parity, the anomaly resolves; every endpoint
    answers over HTTP and ``/metrics`` parses; ``/readyz`` and
    ``/healthz`` answer 503 after a give-up. No flash kernel launches in
    (a)-(c). (d) The BERT-Small main path (bf16, micro 8 x K=4, scan) for
    2 updates with ``RunConfig(slos=, sentinel=)``: losses, weights and
    launch counts equal the run without them. (e) ``bench_slo`` on the
    card, 48 requests: the ops plane's cost per tick over the baseline
    tick at GPT-Small width and at JAX's tiny bench model, each at most
    1.02 (JAX's gate), with the card's name and power limit.

28. live reconfiguration and the replica fleet, the same GPT-Small model
    on a paged pool (4 slots, 64 blocks of 16, decode block 4; phase 27's
    4 requests of 32-96 prompt tokens and 24 new), every stream against a
    calm run under the near-tie rule. (a) A grow to 128 blocks after 2
    ticks: no preemption, the prefix cache kept, the card's peak and kept
    allocation across it against the old pool's bytes; shrinks to 32 blocks
    through the host-swap and the re-prefill resume; a shrink to 2 refused
    with JAX's demand and supply. (b) ``params_digest`` of GPT-Small timed;
    a swap to identical weights through the port's checkpoint (swapped K/V
    kept), to new weights in memory (each continuation ``generate_cached``
    of prompt + generated under them), and from a rotted file (``ok=False``,
    the old weights keep serving). (c) ``MID_RECONFIG`` kills at 2n and at
    2n+1 of the retry, then a clean retry. (d) Two replicas on the card
    sharing the weights (the bytes each adds printed): lockstep streams and
    unique ids; ``replica_drain``/``replica_activate`` through the server
    with rebound handles; a seeded ``replica_kill`` at ``FLEET_STEP`` taken
    through DEAD (on the tick clock) to a proof-gated excise and a
    ``replica_add``; the free-running server's two loop threads. No flash
    kernel launches in (a)-(d). ``reconfigure()`` wall ms per kind. (e)
    ``bench_reconfig`` and ``bench_fleet`` on the card, each at JAX's 1.5x
    with parity.
29. the self-healing ladder, the same GPT-Small model and phase 28's
    requests on its paged pool at one token a tick, the sentinel and the
    healer on the tick clock, a degradation that arms on a tick and sleeps
    25x the warm-up's median healthy tick until ``recover()`` clears it.
    (a) A lockstep server with ``Healer(default_ladders(server=...))``:
    the cliff fires and the ``recover_requeue`` rung heals it in its
    window; ``stats()["healer"]`` and the manifest's ladders; fire->resolve
    ticks and ms. (b) ``recover()`` does not clear it: the ladder grows the
    pool (``initiator="healer"`` in the result and the metrics; the
    reconfiguration's ms), then freezes ``exhausted`` with one
    ``healer_frozen`` at severity page and no action after. (c) A
    free-running fleet of two: replica 1 degrades and only its engine
    recovers; then a killed replica walks the ``dead_replica`` ladder
    (targeted recover, proof-gated excise, healer-tagged add) and its
    displaced streams finish on the survivor. Every stream against a calm
    run under the near-tie rule; no flash kernel launches in (a)-(c). (d)
    ``bench_heal --fast`` (MTTR ratio against JAX's 1.5, the flap leg
    terminal) and ``chaos_smoke`` for one seed, on the card.
30. the serving mesh: GPT-Small f32 at nanoGPT's padded vocabulary 50304
    (the model axis must divide it; prompts draw ids below 50257), two
    gloo ranks sharing the card (``python3 chip_smoke.py
    --serving-mesh-rank DIR``), each leg against the same engine in one
    process under the near-tie rule (sampled streams: the sampler's top-2
    perturbed scores), both ranks' streams and bookkeeping identical. (a)
    ``Engine(mesh=serving_mesh(2))``, 8 slots, block 4, on a seeded trace
    of 6 requests: paged greedy, fixed-pool T 0.8 top-k 50, speculative
    k = 4 (a 1-layer draft, the first 3 requests); collectives per
    micro-step (2L + 2) and per cycle as the design counts; pool bytes per
    rank half of tp=1's; ms per tick wall and card-busy ms at tp=1 (rank 0
    alone) and tp=2, gloo's host ms per tick and the card's copy ms
    (profiler windows of the card alone on rank 0). (b) A seeded
    ``MID_DECODE_TICK`` crash, ``recover`` and the requeue; a preemption
    through the host swap store; a pool grow and a checkpoint swap to the
    same weights (``weights_unchanged``: the whole tree's ``params_digest``
    on each rank equals one process's). (c) ``ReplicatedEngine(replicas=2,
    tp=2)`` stepped on the trace and drained. (d) ``serving_smoke --paged
    --mesh dp,tp`` and ``bench_serving --mesh --fast``, in processes of
    their own beside the ranks' start-up and legs (a)-(c) and the
    one-process runs; the timing windows wait for all of them: tp parity
    and one tick signature (the bench's 1.5x replica term reads host
    threads on one card, printed, not gated). No flash kernel launches,
    here or on the ranks.
31. the server over the serving mesh and the operator tools: two gloo
    ranks share the card (``python3 chip_smoke.py --mesh-server-rank
    DIR``), GPT-Small f32 at vocab 50304 as in phase 30; rank 0 runs
    ``ServingServer`` and rank 1 ``follow()``s it. (a) The lockstep server
    over ``Engine(mesh=serving_mesh(2))``: 6 client threads submit phase
    30's trace, greedy (paged) and sampled (fixed pool). (b) One server
    with a seeded ``MID_DECODE_TICK`` crash recovered and requeued through
    it and a pool grow through ``server.reconfigure``, traced, with a
    flight recorder. (c) The free-running server over
    ``ReplicatedEngine(replicas=2, tp=2)`` on the trace. Every stream
    against phase 30's one-process streams under the near-tie rule, both
    ranks stopped cleanly. Then, once the tools are done, the ms per tick
    through the server with 8 slots decoding against phase 30's engine
    alone, and the commands and host ms of each control exchange. (d)
    ``bench_mixed`` and ``bench_obs`` on the card, in processes of their
    own beside the ranks, into ``chiprun_out/chip_smoke_tools/``; both
    acceptances printed; then ``obs_report`` over (b)'s trace and flight
    dumps and ``bench_trend --dir`` over that directory, both exiting 0.
    No flash kernel launches.

The last three lines of standard output are the card's name and power
limit, a JSON line describing every kernel in each dtype (bfloat16: launches
from the main path, and at phase 23's long-context shapes; float32: from
``gpt_lm --flash`` in scan mode, and from phase 18 under
``launches_bert_f32``), and the
result line ``{"ok": true, "device": {...}}``. Without a card, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "gradaccum_tpu_torch"

# the BERT-Small main path: micro-batch 8, 8 heads, seq 128, head dim 64
B, H, S, D = 8, 8, 128, 64
RATE, SEED = 0.1, 0x5EED1234
UPDATES = 8  # optimizer updates on the main path
LAYERS, K = 4, 4  # BERT-Small depth, and K on the main path
# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s and FLOP/s by type.
# float32: the fastest float32-accurate product rate of the card, 3xTF32 on the
# tensor cores (495 TFLOP/s of TF32, three products for each), so that a bound
# is the least time for the work whatever the kernel runs; the 67 TFLOP/s of
# float32 FMA outside the tensor cores is printed beside it.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 495e12 / 3}
F32_FMA_FLOPS = 67e12
# |kernel - plain| <= ATOL + RTOL*|plain|, per output. float32: both sides
# run float32 math in another summation order. bfloat16: both compute in
# float32 from the same bf16 inputs; o/dq/dk/dv round once to bf16 (2^-8
# relative), lse and dmask stay float32. delta (the dq kernel's row
# correction) sums the same float32 products in another order, in both
# dtypes (a product of two bf16 values is exact in float32).
TOL = {
    "torch.float32": {"o": (1e-5, 1e-5), "lse": (1e-5, 1e-5), "dq": (1e-4, 1e-4),
                      "delta": (1e-5, 1e-5), "dk": (1e-4, 1e-4), "dv": (1e-4, 1e-4),
                      "dmask": (1e-4, 1e-4)},
    "torch.bfloat16": {"o": (1e-2, 1e-2), "lse": (1e-4, 1e-4), "dq": (1e-2, 1e-2),
                       "delta": (1e-5, 1e-5), "dk": (1e-2, 1e-2), "dv": (1e-2, 1e-2),
                       "dmask": (1e-3, 1e-3)},
}
REPLACES = {
    "flash_fwd": "gradaccum_tpu/ops/flash_attention.py:127",
    "flash_bwd_dq": "gradaccum_tpu/ops/flash_attention.py:348",
    "flash_bwd_dkv": "gradaccum_tpu/ops/flash_attention.py:399",
}
# the source of each kernel by dtype: bfloat16 (the main path) and float32
SOURCES = {"torch.bfloat16": f"{PACKAGE}/csrc/flash_attention_tc.cu",
           "torch.float32": f"{PACKAGE}/csrc/flash_attention.cu"}
# beside the main shape, in both dtypes: the ragged lengths (one key tile
# with a ragged edge, and more than one) and every other head dim the
# wrapper accepts
EXTRA_SHAPES = [(B, H, 100, D), (B, H, 200, D), (B, H, S, 128), (B, H, S, 16),
                (B, H, S, 32)]
# the kernels ptxas must report without spills, at every head dim: every
# float32 kernel, and the three bfloat16 ones (Hopper designs)
NO_SPILL = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
            "flash_fwd_tc_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel")
# the kernels whose wgmma ptxas must not serialize (its C7515 report: every
# product then waits for the one before), at every head dim: the float32
# forward, dq and dk/dv kernels and the bfloat16 dq kernel. The build
# prints every kernel it reports.
NO_SERIAL = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel", "flash_dq_tc_kernel")
# GPT-Small's attention (micro 8, 8 heads, seq 512, head dim 64: bf16 on the
# tensor cores, and float32 in ladder leg (a)) and gpt_lm's (micro 16,
# 4 heads, seq 64, head dim 32, float32): causal, no mask, dropout 0.1
GPT_SHAPE = (8, 8, 512, 64)
GPT_LM_SHAPE = (16, 4, 64, 32)
# bwd_impl="xla" in bfloat16 against the kernels' backward: the blockwise
# core computes as JAX's does, its scores, P and the autograd cotangents
# rounded to bf16 (2^-8 relative) before each product, where the kernels
# keep them float32: 1-3 % relative on dq/dk/dv. dmask comes back in the
# mask's bf16 on both paths, whose spacing is 0.25 for |dmask| in [32, 64).
XLA_BWD_TOL = {"dq": (3e-2, 3e-2), "dk": (3e-2, 3e-2), "dv": (3e-2, 3e-2),
               "dmask": (0.5, 3e-2)}
# sparse against dense embedding gradients after 2 AdamW updates at lr
# 2e-5: the table's gradient sums the same float32 row cotangents in another
# order (index_add_ on the card adds with atomics), and AdamW without bias
# correction moves a weight by up to 2x a gradient difference (lr/eps·0.1)
SPARSE_ATOL = 1e-6


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# --------------------------------------------------------------------------
# phase 1: build
# --------------------------------------------------------------------------


def phase_build():
    from gradaccum_tpu_torch.utils import cuda_build

    sources = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    # one nvcc per source, all started together (threads wait on subprocesses)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        for future in [pool.submit(cuda_build.build, s) for s in sources]:
            future.result()
    from gradaccum_tpu_torch.ops import flash_attention as fa

    fa.build_kernels()
    print(f"[build] {len(sources)} source(s) in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{s} {cuda_build.build_seconds.get(s, 0.0):.1f} s" for s in sources))
    spilled, seen = [], set()
    for s in sources:
        log = cuda_build.library_path(s).with_suffix(".log")
        for name, regs, stores, loads in _ptxas_summary(log.read_text()):
            print(f"[build] ptxas {s}: {name} {regs} registers, spill stores {stores} B, "
                  f"loads {loads} B")
            seen.add(name)
            if name.split("<")[0] in NO_SPILL and (stores or loads):
                spilled.append(name)
    missing = [f"{k}<{d}>" for k in NO_SPILL for d in (16, 32, 64, 128)
               if f"{k}<{d}>" not in seen]
    check(not missing, f"no ptxas report for {missing}")
    check(not spilled, f"ptxas reports spills in {spilled}")
    serialized = sorted(name for s in sources for name in _ptxas_serialized(
        cuda_build.library_path(s).with_suffix(".log").read_text()))
    print(f"[build] ptxas serializes the wgmma of: {', '.join(serialized) or 'no kernel'}")
    bad = [name for name in serialized if name.split("<")[0] in NO_SERIAL]
    check(not bad, f"ptxas serializes every wgmma of {bad} (C7515)")


def _kernel_name(mangled):
    """e.g. ..18flash_dq_tc_kernelILi64EEEv.. -> flash_dq_tc_kernel<64>"""
    import re

    m = re.search(r"(flash_[a-z_]+?_kernel)ILi(\d+)EEEv", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def _ptxas_serialized(text):
    """The kernels whose wgmma ptxas serializes (its C7515 report)."""
    import re

    return [_kernel_name(m.group(1)) for m in re.finditer(
        r"\(C7515\)[^\n]*in the function '(\w+)'", text)]


def _ptxas_summary(text):
    """``(kernel, registers, spill store bytes, spill load bytes)`` for each
    kernel instance in nvcc's ``-Xptxas -v`` report."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spills = _kernel_name(entry.group(1)), (0, 0)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append((name, int(regs.group(1))) + spills)
            name = None
    return out


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def _inputs(dtype, masked, seed=0, shape=(B, H, S, D)):
    import torch

    b, _, s, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    mask = None
    if masked:
        # padded keys as BERT builds them: (1 - input_mask) * -1e9
        lengths = torch.randint(s // 4, s + 1, (b,), generator=g, device="cuda")
        pad = torch.arange(s, device="cuda")[None, :] >= lengths[:, None]
        mask = (pad.float() * -1e9).to(dtype).reshape(b, 1, 1, s).contiguous()
    return q, k, v, mask, do


def _err(name, got, want, dtype):
    atol, rtol = TOL[str(dtype)][name]
    got, want = got.float(), want.float()
    check(bool(got.isfinite().all()), f"{name}: non-finite kernel output")
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return float(err.max()), ok, atol, rtol


def phase_kernels():
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    # (padded mask, causal, dropout rate)
    cases = [(True, False, 0.0), (False, False, 0.0), (False, True, 0.0),
             (True, False, RATE), (True, True, RATE)]
    gpt = [(False, True, RATE)]
    runs = [(torch.float32, (B, H, S, D), cases), (torch.bfloat16, (B, H, S, D), cases)]
    runs += [(torch.bfloat16, shape, cases) for shape in EXTRA_SHAPES]
    runs += [(torch.float32, shape, cases) for shape in EXTRA_SHAPES]
    runs += [(torch.bfloat16, GPT_SHAPE, gpt), (torch.float32, GPT_SHAPE, gpt),
             (torch.float32, GPT_LM_SHAPE, gpt)]
    for dtype, shape, shape_cases in runs:
        for masked, causal, rate in shape_cases:
            _check_kernels(fa, dtype, shape, masked, causal, rate, worst)
    for dtype, shape in ((torch.float32, (B, H, S, D)), (torch.bfloat16, (B, H, S, D)),
                         (torch.bfloat16, (B, H, 200, D)), (torch.float32, (B, H, 200, D)),
                         (torch.bfloat16, GPT_SHAPE),
                         (torch.float32, GPT_SHAPE), (torch.float32, GPT_LM_SHAPE)):
        _check_keep_masks(fa, dtype, shape)
    for dtype in (torch.float32, torch.bfloat16):
        # one rank's heads under tensor parallelism: heads 4-7 of 8
        _check_keep_masks(fa, dtype, (B, H // 2, S, D), head_offset=H // 2, heads_total=H)
        _check_head_slice(fa, dtype)
    _check_fresh_thread(fa)
    return worst


def _check_fresh_thread(fa):
    """The kernels of each dtype launched from a new thread whose first CUDA
    calls are theirs, as autograd's device thread makes them when the
    attention's backward is the first node it runs: each library encodes
    its tensor maps there (a driver call, which needs the device's context
    current in the thread): every kernel of both, the forward first. Every
    output equals the main thread's bit for bit."""
    import threading

    import torch

    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda")  # no copy in the thread
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, mask, do = _inputs(dtype, True, seed=5)

        def run():
            o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, False, RATE)
            dq, delta = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o, lse, False, RATE)
            dk, dv, dm = fa.flash_bwd_dkv_cuda(q, k, v, mask, seed, do, lse, delta, False,
                                               RATE)
            return {"o": o, "lse": lse, "dq": dq, "delta": delta, "dk": dk, "dv": dv,
                    "dmask": dm}

        outs, errors = {}, []

        def in_thread():
            try:
                outs.update(run())
                torch.cuda.synchronize()
            except Exception as e:  # reported below, in the main thread
                errors.append(e)

        worker = threading.Thread(target=in_thread)
        worker.start()
        worker.join()
        name = str(dtype)[6:]
        check(not errors, f"the {name} kernels failed in a fresh thread: {errors}")
        want = run()
        torch.cuda.synchronize()
        differ = [key for key, x in want.items() if not torch.equal(x, outs[key])]
        check(not differ, f"the {name} kernels' {differ} in a fresh thread differ from the "
                          f"main thread's")
        print(f"[kernels] {name} forward, dq and dk/dv launched first from a fresh thread: "
              "outputs equal the main thread's bit for bit")


def _check_kernels(fa, dtype, shape, masked, causal, rate, worst, tag="kernels"):
    """Each kernel against its plain version on one case, within TOL; the
    largest error of each kernel lands in ``worst``."""
    import torch

    q, k, v, mask, do = _inputs(dtype, masked, shape=shape)
    seed = SEED if rate else None
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
    o_r, lse_r = fa.flash_forward_reference(q, k, v, mask, seed, causal, rate)
    # each backward kernel gets exactly its plain twin's inputs: dk/dv the
    # plain delta, which the dq kernel's own is held against
    delta = fa._delta(do, o_r)
    dq, delta_k = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o_r, lse_r, causal, rate)
    dk, dv, dm = fa.flash_bwd_dkv_cuda(q, k, v, mask, seed, do, lse_r, delta, causal, rate)
    dq_r, dk_r, dv_r, dm_r = fa.flash_backward_reference(
        q, k, v, mask, seed, o_r, lse_r, do, causal, rate)
    torch.cuda.synchronize()
    outs = {"o": (o, o_r), "lse": (lse, lse_r), "dq": (dq, dq_r),
            "delta": (delta_k, delta), "dk": (dk, dk_r), "dv": (dv, dv_r)}
    if masked:
        outs["dmask"] = (dm, dm_r)
    line = []
    for name, (got, want) in outs.items():
        err, ok, atol, rtol = _err(name, got, want, dtype)
        kernel = {"o": "flash_fwd", "lse": "flash_fwd", "dq": "flash_bwd_dq",
                  "delta": "flash_bwd_dq"}.get(name, "flash_bwd_dkv")
        key = (kernel, str(dtype))
        worst[key] = max(worst.get(key, 0.0), err)
        line.append(f"{name}={err:.2e}")
        check(ok, f"{name} disagrees ({dtype}, {shape}, mask={masked}, "
                  f"causal={causal}, rate={rate}): max |err| {err:.3e} > "
                  f"{atol} + {rtol}|ref|")
    print(f"[{tag}] {str(dtype)[6:]:8s} {shape} mask={int(masked)} "
          f"causal={int(causal)} rate={rate}: " + " ".join(line))


def _check_head_slice(fa, dtype, first=H // 2):
    """The kernels on heads [first, H) of the main shape, told their place
    (``head_offset=first, heads_total=H``), against the matching slice of
    the plain version's outputs on all H heads, dropout on: o, lse, dq,
    dk, dv within TOL."""
    import torch

    q, k, v, mask, do = _inputs(dtype, True, seed=3)
    o_r, lse_r = fa.flash_forward_reference(q, k, v, mask, SEED, False, RATE)
    dq_r, dk_r, dv_r, _ = fa.flash_backward_reference(q, k, v, mask, SEED, o_r, lse_r, do,
                                                      False, RATE)
    part = [x[:, first:].contiguous() for x in (q, k, v, do, o_r)]
    qp, kp, vp, dop, op = part
    lsep = lse_r[:, first:].contiguous()
    heads = dict(head_offset=first, heads_total=H)
    o, lse = fa.flash_fwd_cuda(qp, kp, vp, mask, SEED, False, RATE, **heads)
    dq, _ = fa.flash_bwd_dq_cuda(qp, kp, vp, mask, SEED, dop, op, lsep, False, RATE, **heads)
    dk, dv, _ = fa.flash_bwd_dkv_cuda(qp, kp, vp, mask, SEED, dop, lsep, fa._delta(dop, op),
                                      False, RATE, False, **heads)
    torch.cuda.synchronize()
    line = []
    for name, got, want in (("o", o, o_r), ("lse", lse, lse_r), ("dq", dq, dq_r),
                            ("dk", dk, dk_r), ("dv", dv, dv_r)):
        err, ok, atol, rtol = _err(name, got, want[:, first:], dtype)
        check(ok, f"{name} on heads {first}-{H - 1} of {H} ({dtype}) disagrees with the "
                  f"slice of the plain version: max |err| {err:.3e} > {atol} + {rtol}|ref|")
        line.append(f"{name}={err:.2e}")
    print(f"[kernels] {str(dtype)[6:]} heads {first}-{H - 1} of {H} (head_offset={first}, "
          f"heads_total={H}) against the plain version's slice: " + " ".join(line))


def _check_keep_masks(fa, dtype, shape, head_offset=0, heads_total=None):
    """Read the keep decisions back out of the forward, dq and dk/dv kernels
    and require them equal to the plain mask. With q = k = 0 every
    probability is 1/s, so o[i, d] = keep[i, c*D + d]/(keep_prob*s) when v
    is the one-hot block c; dv[j, d] = keep[c*D + d, j]/(keep_prob*s)
    likewise when dO is the one-hot block c of query rows. For dq, q = 0,
    o = 0 (so delta = 0) and every row of v and dO is e_0 (so dP = 1); with
    k the one-hot block c, dq[i, d] = scale*keep[i, c*D + d]/(keep_prob*s).
    All three are positive (bfloat16 too) exactly where the element is
    kept. The last block of a ragged length is narrower than D. With
    ``head_offset`` and ``heads_total`` the kernels run heads [head_offset,
    head_offset + h) of a wider attention, and their mask must be that
    slice of the whole attention's plain mask."""
    import torch

    b, h, s, d = shape
    total = heads_total or h
    want = fa.dropout_keep_mask(SEED, b, total, s, RATE,
                                device="cuda")[:, head_offset:head_offset + h]
    heads = dict(head_offset=head_offset, heads_total=total)
    zeros = torch.zeros(shape, dtype=dtype, device="cuda")
    e0 = torch.zeros(shape, dtype=dtype, device="cuda")
    e0[..., 0] = 1
    lse = torch.full((b, h, s, 1), math.log(s), device="cuda")
    delta = torch.zeros(b, h, s, 1, device="cuda")
    got = {name: torch.empty(b, h, s, s, dtype=torch.bool, device="cuda")
           for name in ("forward", "dq", "dk/dv")}
    for c0 in range(0, s, d):
        w = min(d, s - c0)
        onehot = torch.zeros(shape, dtype=dtype, device="cuda")
        onehot[:, :, c0:c0 + w, :w] = torch.eye(w, dtype=dtype, device="cuda")
        o, _ = fa.flash_fwd_cuda(zeros, zeros, onehot, None, SEED, False, RATE, **heads)
        got["forward"][..., c0:c0 + w] = o[..., :w] > 0
        dq, _ = fa.flash_bwd_dq_cuda(zeros, onehot, e0, None, SEED, e0, zeros, lse,
                                     False, RATE, **heads)
        got["dq"][..., c0:c0 + w] = dq[..., :w] > 0
        _, dv, _ = fa.flash_bwd_dkv_cuda(zeros, zeros, zeros, None, SEED, onehot, lse,
                                         delta, False, RATE, True, **heads)
        got["dk/dv"][:, :, c0:c0 + w, :] = (dv[..., :w] > 0).transpose(-1, -2)
    torch.cuda.synchronize()
    kind = f"{str(dtype)[6:]} {list(shape)}" + (
        f" heads {head_offset}-{head_offset + h - 1} of {total}" if total != h else "")
    for name, mask in got.items():
        check(torch.equal(mask, want), f"{name} kernel keep mask ({kind}) differs "
                                       f"from the plain mask")
    print(f"[kernels] keep mask exact in flash_fwd, flash_bwd_dq and flash_bwd_dkv, "
          f"{kind} (route {fa.route(dtype)}; rate {RATE}, seed {SEED:#x}, "
          f"kept {want.float().mean().item():.4f})")


def _time_ms(fn, iters=50, warmup=5):
    """Wall time per call (ms) of back-to-back calls, between two CUDA
    events: the card's time when a call's kernels outlast its host
    dispatch, the dispatch's when they do not."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters=50, warmup=5, attempts=3):
    """Card time per call (ms): the device time of every kernel, copy and
    memset the calls launched, summed from torch.profiler's device events,
    over the number of calls. Host dispatch is not in it. Returns the time,
    the device events' names, the longest first, and the method that gave
    the time: ``"profiler"`` or ``"cuda_events"``. A window that records
    no device event at all (seen once, in the first window of a process),
    or an event a number of times that is not a multiple of the calls (a
    window that lost some of its events would read low: late in a long
    process windows lose half their events), is profiled again; when the
    last attempt loses events too, the time is the CUDA events' over the
    same back-to-back calls (``_time_ms``: the card's time where the calls'
    kernels outlast their dispatch, an upper bound otherwise), with a note
    and the method ``"cuda_events"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sorted(((e.self_device_time_total, e.key) for e in events), reverse=True)
        ragged = [f"{e.key[:40]} x{e.count}" for e in events if e.count % iters]
        if device and not ragged:
            return (sum(t for t, _ in device) / iters / 1e3, [key for _, key in device],
                    "profiler")
        if device and attempt + 1 == attempts:
            ms = _time_ms(fn, iters, warmup)
            print(f"[timing] device events not a multiple of {iters} calls: {ragged}; "
                  f"CUDA events over the calls instead: {ms:.4f} ms a call")
            return ms, [key for _, key in device], "cuda_events"
        print(f"[timing] profiler window {attempt + 1} of {attempts} saw "
              + (f"device events not a multiple of {iters} calls: {ragged}" if device
                 else "no device event"))
    raise SmokeError("the profiler saw no device time: card times cannot be read")


def _bounds(dtype, masked, shape=(B, H, S, D), causal=False):
    """Least time (ms) for each kernel's work at ``shape``: bytes it must
    move (inputs read once, outputs written once) over the memory rate,
    against its matrix-product FLOPs over the peak for its type. Causal
    attention computes the lower triangle only: half the FLOPs."""
    import torch

    b, h, s, d = shape
    e = torch.finfo(dtype).bits // 8
    act = b * h * s * d * e  # one [B,H,S,D] tensor
    row = b * h * s * 4  # one f32 [B,H,S] row tensor (lse, delta, dmask)
    mask = b * s * e if masked else 0
    seed = 8
    pairs = b * h * s * s * d // (2 if causal else 1)  # (query, key) pairs x D
    work = {
        # q k v mask seed -> o lse; QK^T and PV
        "flash_fwd": (3 * act + mask + seed + act + row, 4 * pairs),
        # q k v dO o lse mask seed -> dq delta; QK^T, dO V^T, dS K
        "flash_bwd_dq": (5 * act + row + mask + seed + act + row, 6 * pairs),
        # q k v dO lse delta mask seed -> dk dv dmask; QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (4 * act + 2 * row + mask + seed + 2 * act + (row if masked else 0),
                          8 * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out


def phase_timing(shape=(B, H, S, D), masked=True, causal=False, label="bert", dtype=None,
                 rate=RATE):
    """Each kernel, its plain version and the library yardstick with dropout
    0.1: at the main path's conditions (BERT-Small bf16, padded mask, not
    causal), or at GPT's (no mask, causal: GPT-Small's seq 512 in bf16 and
    float32, gpt_lm's [16, 4, 64, 32] in float32). Every number is card time
    per call (torch.profiler device events); the wall time per call of
    back-to-back calls, dispatch included, is printed beside each
    kernel's. Returns the times, the bounds, and for each kernel the method
    behind each of its times (``_device_ms``)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from gradaccum_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    q, k, v, mask, do = _inputs(dtype, masked, seed=1, shape=shape)
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda") if rate else None
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
    _, delta = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o, lse, causal, rate)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(
            q, k, v, mask, seed, do, o, lse, causal, rate),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, mask, seed, do, lse, delta, causal, rate),
    }
    timed = {name: _device_ms(fn) for name, fn in calls.items()}
    ms = {name: t[0] for name, t in timed.items()}
    wall = {name: _time_ms(fn) for name, fn in calls.items()}
    # the plain backward computes dq, dk, dv and dmask in one pass: its time
    # stands beside both backward kernels
    plain_bwd, _, plain_bwd_from = _device_ms(lambda: fa.flash_backward_reference(
        q, k, v, mask, seed, o, lse, do, causal, rate), iters=20)
    plain_fwd, _, plain_fwd_from = _device_ms(lambda: fa.flash_forward_reference(
        q, k, v, mask, seed, causal, rate), iters=20)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    # SDPA's backward computes dq, dk and dv in one call: its time stands
    # beside both backward kernels, so K2 + K3 is the fair comparison. The
    # window holds the backward alone (the forward ran once, before it).
    # The backend is pinned, so every run times the same kernels: the
    # memory-efficient one takes an additive mask and dropout in bfloat16.
    backend = SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        sdpa_fwd, fwd_kernels, sdpa_fwd_from = _device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, is_causal=causal))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, dropout_p=rate,
                                                is_causal=causal)
    sdpa_bwd, bwd_kernels, sdpa_bwd_from = _device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qg, kg, vg), do, retain_graph=True))
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}
    method = {name: {"ms": timed[name][2],
                     "plain_ms": plain_fwd_from if name == "flash_fwd" else plain_bwd_from,
                     "library_ms": sdpa_fwd_from if name == "flash_fwd" else sdpa_bwd_from}
              for name in ms}
    print(f"[timing] {label} {str(dtype)[6:]} {list(shape)} mask={int(masked)} "
          f"causal={int(causal)} dropout={rate}")
    print(f"[timing] sdpa backend {backend.name}: forward {sdpa_fwd:.4f} ms "
          f"({', '.join(n[:60] for n in fwd_kernels[:3])}), backward (dq + dk + dv) "
          f"{sdpa_bwd:.4f} ms ({', '.join(n[:60] for n in bwd_kernels[:3])}); "
          f"flash dq + dk/dv {ms['flash_bwd_dq']:.4f} + {ms['flash_bwd_dkv']:.4f} = "
          f"{ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.4f} ms")
    bounds = _bounds(dtype, masked, shape, causal)
    for name in ms:
        nbytes, flops = bounds[name][2], bounds[name][3]
        fma = ""
        if dtype == torch.float32:
            fma = (f"; {max(nbytes / PEAK_BYTES, flops / F32_FMA_FLOPS) * 1e6:.2f} us at "
                   f"the {F32_FMA_FLOPS / 1e12:.0f} TFLOP/s of float32 FMA")
        print(f"[timing] {name} ({fa.route(dtype)}): {ms[name]:.4f} ms on the card "
              f"({flops / ms[name] / 1e9:.0f} TFLOP/s), "
              f"{wall[name]:.4f} ms a call with dispatch (plain {plain[name]:.4f} ms, "
              f"sdpa {library[name]:.4f} ms; bound {bounds[name][0] * 1e3:.2f} us by "
              f"{bounds[name][1]}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP{fma}; "
              f"times from {method[name]})")
    return ms, plain, library, bounds, method


# --------------------------------------------------------------------------
# phase 3: the card against the CPU on a small model
# --------------------------------------------------------------------------


def phase_agree():
    import numpy as np
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.utils.tree import named_parameters

    cfg = BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    rng = np.random.default_rng(7)
    n, s = 4, 16
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
    batch = {"input_ids": rng.integers(5, cfg.vocab_size, size=(n, s)) * mask,
             "input_mask": mask, "segment_ids": np.zeros((n, s), np.int64),
             "label": rng.integers(0, 2, size=n)}
    results = {}
    for device in ("cpu", "cuda"):
        bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
        model = bundle.init(0, device)
        params = named_parameters(model)
        tb = {key: torch.as_tensor(val, device=device) for key, val in batch.items()}
        tb["rng"] = torch.Generator(device=device).manual_seed(0)
        loss = bundle.loss(model, tb)
        grads = torch.autograd.grad(loss, list(params.values()))
        results[device] = (loss.item(), {name: g.cpu() for name, g in zip(params, grads)})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results["cuda"]
    check(math.isfinite(l_gpu), "tiny BERT loss on the card is not finite")
    check(abs(l_cpu - l_gpu) <= 1e-5 * max(1.0, abs(l_cpu)),
          f"tiny BERT loss: card {l_gpu} vs cpu {l_cpu}")
    worst = max(float((g_gpu[n_] - g_cpu[n_]).abs().max()) for n_ in g_cpu)
    check(worst <= 1e-4, f"tiny BERT gradients: card vs cpu max |err| {worst:.3e} > 1e-4")
    print(f"[agree] tiny BERT f32 on the card vs the CPU: loss {l_gpu:.6f} vs {l_cpu:.6f}, "
          f"{len(g_cpu)} gradients within 1e-4 (max |err| {worst:.2e})")


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def phase_main(updates: int):
    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.ops import flash_attention as fa

    k, layers = K, LAYERS
    model_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    shutil.rmtree(model_dir, ignore_errors=True)  # a fresh run, not a resume
    argv = ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(k), "--max-steps", str(updates * k),
            "--model-dir", model_dir]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts = fa.launch_counts()
    routes = fa.route_counts()
    check(math.isfinite(result["loss"]), f"main path loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"ran {result['updates']} updates, wanted {updates}")
    _check_launches("main", counts, routes, layers * k * updates, result, "tc")
    print(f"[main] BERT-Small bf16 micro 8 x K={k}, seq {S}: {updates} updates, "
          f"loss {result['loss']:.4f}, {result['seq/s']:.1f} seq/s, "
          f"mfu {result['mfu']:.4f}, eval accuracy {result['accuracy']:.4f} "
          f"({result['evaluations']} evaluations); launches {counts}, routes {routes}")
    return counts, result


def _check_launches(phase, counts, routes, train_calls, result, route):
    """Each training forward/backward launches every kernel once per layer;
    each eval batch launches the forward once per layer. Every launch on
    ``route``: ``tc`` for bf16, ``tf32x3`` for float32."""
    evals = LAYERS * result["eval_batches"] * result["evaluations"]
    want = {"flash_fwd": train_calls + evals,
            "flash_bwd_dq": train_calls, "flash_bwd_dkv": train_calls}
    check(counts == want, f"{phase}: launch counts {counts} != {want} ({train_calls} "
                          f"per kernel in training, + {LAYERS} forward per eval batch x "
                          f"{result['eval_batches']} batches x {result['evaluations']} "
                          f"evaluations)")
    want_routes = {name: {r: n if r == route else 0 for r in ("tc", "tf32x3")}
                   for name, n in want.items()}
    check(routes == want_routes, f"{phase}: route counts {routes} != {want_routes}")


def phase_profile(updates: int = 3, mode: str = "scan", extra=()):
    """Where the time of the main path (or of its streaming or sparse
    embedding twin, ``extra`` flags) goes: a torch.profiler window over a
    few updates of the same run (after two warm-up updates and one more
    that counts the bf16 kernels' tensor-map lookups and encodes). Reports
    wall time per update, the card's busy time per update (sum of kernel and
    copy time, one stream), its idle share, and the top kernels."""
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.ops import flash_attention as fa

    args = bert_finetune.parse_args(
        ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
         "--accum-k", str(K), "--max-steps", "400", "--mode", mode, *extra])
    est, train_fn, _, _, _ = bert_finetune.setup(args)
    host_steps = K if mode == "streaming" else 1  # per update
    it = iter(train_fn())
    est.train(itertools.islice(it, 2 * host_steps), final_save=False)
    # the bf16 kernels' tensor maps over one more update: a lookup for each
    # map a launch needs, an encode (host time) for each the cache missed
    maps0, f32_maps0 = fa.tc_map_counts(), fa.f32_map_counts()
    est.train(itertools.islice(it, host_steps), final_save=False)
    maps = {key: n - maps0[key] for key, n in fa.tc_map_counts().items()}
    f32_maps = {key: n - f32_maps0[key] for key, n in fa.f32_map_counts().items()}
    print(f"[profile] {' '.join([mode, *extra])}: tensor maps in one update: "
          f"{maps['lookups']} lookups, {maps['encodes']} encodes (misses of the cache); "
          f"float32 library {f32_maps['lookups']} lookups, {f32_maps['encodes']} encodes")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(itertools.islice(it, updates * host_steps), final_save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # only device-side events (kernels, copies, memsets): the host ops
    # that launched them carry the same device time again
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    kernels = [(e.key, e.self_device_time_total, e.count) for e in device]
    busy = sum(t for _, t, _ in kernels) / 1e6
    per_update = wall / updates
    if busy == 0:
        print("[profile] the profiler saw no device time on this machine")
        return
    flash = sum(t for key, t, _ in kernels if "flash_" in key) / 1e6
    launches = sum(c for _, _, c in kernels) / updates
    print(f"[profile] {' '.join([mode, *extra])}, {updates} updates: "
          f"{per_update * 1e3:.2f} ms/update wall, "
          f"card busy {busy / updates * 1e3:.2f} ms/update "
          f"(idle share {1 - busy / wall:.3f}), {launches:.0f} kernels/update, "
          f"flash kernels {flash / updates * 1e3:.2f} ms/update")
    for key, t, count in sorted(kernels, key=lambda x: -x[1])[:8]:
        print(f"[profile]   {t / updates / 1e3:8.3f} ms/update  {count // updates:5d}x  {key[:90]}")


# --------------------------------------------------------------------------
# phases 6-9: streaming mode, the guard, the MNIST and housing trainers
# --------------------------------------------------------------------------


def phase_streaming(windows: int = 8):
    """The entry point in streaming mode: one micro-batch per host step."""
    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.ops import flash_attention as fa

    steps = windows * K
    argv = ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(K), "--max-steps", str(steps), "--mode", "streaming"]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    check(math.isfinite(result["loss"]), f"streaming loss is not finite: {result['loss']}")
    check(result["updates"] == windows, f"ran {result['updates']} windows, wanted {windows}")
    _check_launches("streaming", counts, routes, LAYERS * steps, result, "tc")
    want_applies = list(range(0, steps, K))  # the first-step quirk: phase 0
    check(result["apply_steps"] == want_applies,
          f"streaming applied at {result['apply_steps']}, wanted {want_applies}")
    print(f"[streaming] BERT-Small bf16 micro 8, K={K}, quirk on: {steps} micro-batch "
          f"calls, applies at {result['apply_steps']}; launches {counts}, all tc")
    print(f"[streaming] loss {result['loss']:.4f}, {result['seq/s']:.1f} seq/s, "
          f"mfu {result['mfu']:.4f}, eval accuracy {result['accuracy']:.4f}")
    return result


def _bert_small_batches(n, seed, vocab=30522, seq=S):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(seq // 4, seq + 1, size=n)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, seq)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, seq), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


def phase_stream_scan(windows: int = 2, micro: int = 8):
    """Quirk-free streaming against scan on the card, from the same weights
    on the same batches: the same accumulation order, so the same floats."""
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.utils.tree import named_parameters

    cfg = BertConfig.small(dtype=torch.bfloat16, hidden_dropout=0.0, attention_dropout=0.0)
    bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
    config = acc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False)
    data = _bert_small_batches(windows * K * micro, seed=3)
    batches = [{key: torch.as_tensor(v[i * micro:(i + 1) * micro], device="cuda")
                for key, v in data.items()} for i in range(windows * K)]
    gen = torch.Generator(device="cuda").manual_seed(0)  # dropout 0: never drawn
    finals = {}
    for mode in ("scan", "streaming"):
        model = bundle.init(19830610, "cuda")
        opt = adamw(warmup_polynomial_decay(2e-5, 16, 2), weight_decay_rate=0.01)
        loss_fn = lambda params, batch, m=model: bundle.loss(m, batch)  # noqa: E731
        if mode == "scan":
            step = acc.accumulate_scan(loss_fn, opt, config, needs_rng=True)
            state = acc.scan_init(named_parameters(model), opt)
            for w in range(windows):
                window = batches[w * K:(w + 1) * K]
                stacked = {key: torch.stack([b[key] for b in window]) for key in data}
                state, _ = step(state, stacked, gen)
        else:
            step = acc.streaming_step(loss_fn, opt, config, needs_rng=True)
            state = acc.streaming_init(named_parameters(model), opt)
            applied = []
            for batch in batches:
                state, aux = step(state, batch, gen)
                applied.append(int(aux["applied"]))
            check(applied == ([0] * (K - 1) + [1]) * windows,
                  f"quirk-free streaming applied {applied}")
        finals[mode] = state
    torch.cuda.synchronize()
    check(finals["scan"].step == finals["streaming"].step == windows * K, "step counts differ")
    a, b = finals["scan"].params, finals["streaming"].params
    with torch.no_grad():
        diff = max(float((a[n] - b[n]).abs().max()) for n in a)
        bitwise = all(torch.equal(a[n], b[n]) for n in a)
        moved = max(float((a[n] - w).abs().max()) for n, w in
                    named_parameters(bundle.init(19830610, "cuda")).items())
    check(all(bool(t.isfinite().all()) for t in a.values()), "stream=scan: non-finite weights")
    check(diff <= 1e-6, f"stream=scan: max |diff| {diff:.3e} > 1e-6")
    check(moved > 1e-6, f"stream=scan: the weights did not move ({moved:.3e})")
    print(f"[stream=scan] BERT-Small bf16, dropout 0, {windows} windows of K={K}: "
          f"{len(a)} float32 parameters, max |streaming - scan| {diff:.3e} "
          f"({'bitwise equal' if bitwise else 'not bitwise'}; weights moved {moved:.3e})")
    return diff


def phase_guard(micro: int = 8):
    """The non-finite guard and dynamic loss scaling on the card, in both
    modes: window 0 has one NaN micro-batch, window 1 only NaN ones, window 2
    none. A batch column ``poison`` multiplies the loss (1.0 or NaN)."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig

    base = bert_classifier_bundle(BertConfig.small(dtype=torch.bfloat16),
                                  attention_fn=flash_attention)
    bundle = base._replace(loss=lambda m, b: base.loss(m, b) * b["poison"].mean())
    init_scale = 2.0 ** 15
    accum = GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False, skip_nonfinite=True,
                            loss_scale=LossScaleConfig(init_scale=init_scale))
    bad = {(0, 1)} | {(1, i) for i in range(K)}  # (window, micro-batch)
    data = _bert_small_batches(3 * K * micro, seed=4)
    data["poison"] = np.ones(3 * K * micro, np.float32)
    for w, i in bad:
        j = (w * K + i) * micro
        data["poison"][j:j + micro] = np.nan
    want_skips = [sum(1 for w, _ in bad if w == win) for win in range(3)]
    want_scales = [init_scale / 2, init_scale / 4, init_scale / 4]  # dirty, dirty, clean
    for mode in ("streaming", "scan"):
        est = Estimator(bundle, adamw(2e-5), accum,
                        RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None),
                        mode=mode, device="cuda")
        host = micro * (K if mode == "scan" else 1)
        rows = K * micro
        skips, snaps = [], []
        for w in range(3):
            window = {key: v[w * rows:(w + 1) * rows] for key, v in data.items()}
            est.train([{key: v[j:j + host] for key, v in window.items()}
                       for j in range(0, rows, host)])
            skips.append(est.nonfinite_skips)
            state = est._state
            snaps.append([t.clone() for t in (*state.params.values(),
                                              *state.opt_state.m.values(),
                                              *state.opt_state.v.values())])
        check(skips == want_skips, f"guard ({mode}): skipped {skips}, wanted {want_skips}")
        unchanged = all(torch.equal(x, y) for x, y in zip(snaps[0], snaps[1]))
        check(unchanged, f"guard ({mode}): the all-bad window changed params or moments")
        check(not all(torch.equal(x, y) for x, y in zip(snaps[1], snaps[2])),
              f"guard ({mode}): the clean window after it did not apply")
        series = dict(est.loss_scale_series)
        scales = [series[(w + 1) * K] for w in range(3)]
        check(scales == want_scales, f"guard ({mode}): scale at window ends {scales}, "
                                     f"wanted {want_scales}")
        check(all(bool(t.isfinite().all()) for t in snaps[2]),
              f"guard ({mode}): a parameter or moment is not finite")
        print(f"[guard] {mode}: skipped {skips} micro-batches per window (NaN loss "
              f"injected), all-bad window bitwise no-op, loss scale at window ends "
              f"{scales}, every parameter finite")


def phase_small_models():
    """The MNIST (variants 01, 02) and housing entry points, streaming."""
    from gradaccum_tpu_torch.examples import housing, mnist

    out = {}
    for variant in ("01", "02"):
        r = mnist.main(["--device", "cuda", "--variant", variant, "--mode", "streaming",
                        "--max-steps", "200"])
        _check_falls(f"mnist {variant}", r)
        print(f"[mnist] variant {variant} (batch {r['micro_batch']}, K={r['accum_k']}, "
              f"streaming): {r['steps']} steps, {r['updates']} updates, loss "
              f"{r['first_loss']:.4f} -> {r['loss']:.4f}, accuracy {r['accuracy']:.4f}, "
              f"{r['ms_per_host_step']:.3f} ms per host step, {r['examples/s']:.0f} examples/s")
        out[f"mnist_{variant}"] = r
    r = housing.main(["--device", "cuda", "--mode", "streaming", "--max-steps", "300"])
    _check_falls("housing", r)
    print(f"[housing] batch {r['micro_batch']}, K={r['accum_k']}, streaming: {r['steps']} "
          f"steps, loss {r['first_loss']:.2f} -> {r['loss']:.2f}, train MAE "
          f"{r['train_mae']:.3f} RMSE {r['train_rmse']:.3f}, test MAE {r['test_mae']:.3f} "
          f"RMSE {r['test_rmse']:.3f}, {r['ms_per_host_step']:.3f} ms per host step")
    print("[housing] predictions " + ", ".join(
        f"{p:.3f} (label {y:.3f})" for p, y in zip(r["predictions"], r["labels"])))
    out["housing"] = r
    return out


def _check_falls(name, r):
    check(math.isfinite(r["loss"]) and math.isfinite(r["first_loss"]),
          f"{name}: non-finite loss {r['first_loss']} -> {r['loss']}")
    check(r["loss"] < r["first_loss"], f"{name}: loss did not fall "
                                       f"({r['first_loss']} -> {r['loss']})")


# --------------------------------------------------------------------------
# phases 10-14: the blockwise backward, warm start, remat, sparse embed, MoE
# --------------------------------------------------------------------------


def _attention_grads(fa, q, k, v, mask, do, causal, **kw):
    """dq, dk, dv (and dmask with a mask) of ``flash_attention`` through
    autograd, and the launch counts of that one call."""
    import torch

    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    m = None if mask is None else mask.clone().requires_grad_()
    fa.reset_launch_counts()
    out = fa.flash_attention(*ins, m, causal=causal, **kw)
    grads = torch.autograd.grad(out, ins + ([m] if m is not None else []), do)
    torch.cuda.synchronize()
    return grads, fa.launch_counts()


def phase_xla_bwd():
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype)] if dtype == torch.float32 else XLA_BWD_TOL
        for masked in (True, False):
            for causal in (False, True):
                q, k, v, mask, do = _inputs(dtype, masked, seed=2)
                want, _ = _attention_grads(fa, q, k, v, mask, do, causal)
                got, counts = _attention_grads(fa, q, k, v, mask, do, causal, bwd_impl="xla")
                check(counts == {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
                      f"xla-bwd launched {counts}: one forward and no backward kernel wanted")
                line = []
                for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
                    g, w = g.float(), w.float()
                    atol, rtol = tol[name]
                    err = (g - w).abs()
                    check(bool(g.isfinite().all()), f"xla-bwd {name}: non-finite")
                    check(bool((err <= atol + rtol * w.abs()).all()),
                          f"xla-bwd {name} ({dtype}, mask={masked}, causal={causal}): max "
                          f"|xla - pallas| {float(err.max()):.3e} > {atol} + {rtol}|pallas|")
                    line.append(f"{name}={float(err.max()):.2e}")
                print(f"[xla-bwd] {str(dtype)[6:]:8s} mask={int(masked)} causal={int(causal)}: "
                      f"launches {counts}; |xla - pallas| " + " ".join(line))


# chip_smoke's own HF naming (independent of models/bert_checkpoint.py):
# port path segments -> HF module path, and leaf -> HF leaf
_HF_SEGMENTS = {
    "word_embeddings": "embeddings.word_embeddings",
    "position_embeddings": "embeddings.position_embeddings",
    "token_type_embeddings": "embeddings.token_type_embeddings",
    "embeddings_LayerNorm": "embeddings.LayerNorm",
    "attention/query": "attention.self.query", "attention/key": "attention.self.key",
    "attention/value": "attention.self.value", "attention/output": "attention.output.dense",
    "attention_LayerNorm": "attention.output.LayerNorm",
    "intermediate": "intermediate.dense", "ffn_output": "output.dense",
    "output_LayerNorm": "output.LayerNorm", "pooler": "pooler.dense",
}
_HF_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def _hf_name(port_name):
    """``params/bert/layer_1/attention/query/kernel`` ->
    ``encoder.layer.1.attention.self.query.weight``."""
    parts = port_name.split("/")[1:]
    if parts[0] == "bert":
        parts = parts[1:]
    prefix = []
    if parts[0].startswith("layer_"):
        prefix, parts = [f"encoder.layer.{parts[0][6:]}"], parts[1:]
    return ".".join(prefix + [_HF_SEGMENTS["/".join(parts[:-1])], _HF_LEAVES[parts[-1]]])


def _write_hf_dir(path, names_shapes, seed=1234):
    """A BertModel directory in HF's format at BERT-Small width: config.json,
    model.safetensors (float32 from a seeded generator, written by a small
    writer: the card has no safetensors package) and vocab.txt (the special
    tokens, the synthetic corpus's words, then [unused{i}] to 30522 lines),
    plus train.tsv and dev.tsv. Returns ``{HF name: array}``."""
    import numpy as np

    from gradaccum_tpu_torch.examples.bert_finetune import synthetic_text_task

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    tensors = {}
    for port_name, shape in names_shapes.items():
        if port_name.startswith("params/classifier/"):
            continue  # a base model: no head
        tensors[_hf_name(port_name)] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, arr in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for arr in tensors.values():
            f.write(arr.tobytes())
    config = {"architectures": ["BertModel"], "model_type": "bert", "hidden_act": "gelu",
              "vocab_size": 30522, "hidden_size": 512, "num_hidden_layers": LAYERS,
              "num_attention_heads": 8, "intermediate_size": 2048,
              "max_position_embeddings": 512, "type_vocab_size": 2,
              "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
              "layer_norm_eps": 1e-12}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    train = synthetic_text_task(512, seed=1)
    dev = synthetic_text_task(256, seed=2)
    words = sorted({w for text in train[0] + dev[0] for w in text.split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    vocab += [f"[unused{i}]" for i in range(30522 - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    for split, (texts, labels) in (("train", train), ("dev", dev)):
        with open(os.path.join(path, f"{split}.tsv"), "w") as f:
            for i, (text, label) in enumerate(zip(texts, labels)):
                f.write(f"{label}\tid{i}\t{text}\n")
    return tensors


def phase_warm_start(updates: int = 4):
    import torch

    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.models.bert import BertConfig, BertClassifier
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.utils.tree import named_parameters

    hf_dir = os.path.join(ROOT, "build", "chip_smoke_hf")
    shutil.rmtree(hf_dir, ignore_errors=True)
    shapes = {name: tuple(p.shape) for name, p in
              named_parameters(BertClassifier(BertConfig.small(num_layers=LAYERS))).items()}
    t0 = time.perf_counter()
    tensors = _write_hf_dir(hf_dir, shapes)
    mb = os.path.getsize(os.path.join(hf_dir, "model.safetensors")) / 1e6
    argv = ["--device", "cuda", "--hf-checkpoint", hf_dir, "--data-dir", hf_dir, "--bf16",
            "--mode", "scan", "--seq-len", str(S), "--accum-k", str(K),
            "--max-steps", str(updates * K),
            "--model-dir", os.path.join(ROOT, "build", "chip_smoke_warm")]
    # the weights before the first update, through the entry point's own setup
    est, _, _, cfg, _ = bert_finetune.setup(bert_finetune.parse_args(argv))
    params = est.train([], final_save=False).params
    check(set(params) == {n for n in shapes}, "warm start: parameter names differ")
    for name, p in params.items():
        if name.startswith("params/classifier/"):
            check(not bool(p.any()), f"warm start: {name} is not zero")
            continue
        want = torch.from_numpy(tensors[_hf_name(name)]).to(p.device)
        check(torch.equal(p.detach(), want), f"warm start: {name} differs from the file's "
                                             f"{_hf_name(name)}")
    print(f"[warm-start] wrote a BERT-Small HF directory ({mb:.1f} MB model.safetensors, "
          f"30522-line vocab.txt) in {time.perf_counter() - t0:.1f} s; before the first "
          f"update all {len(params) - 2} encoder and pooler tensors equal the file's bit for "
          f"bit and the classifier is zero")
    del est, params
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    check(math.isfinite(result["loss"]), f"warm start: loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"warm start: ran {result['updates']} updates")
    check(0.0 <= result["accuracy"] <= 1.0, f"warm start: accuracy {result['accuracy']}")
    _check_launches("warm-start", counts, routes, LAYERS * K * updates, result, "tc")
    print(f"[warm-start] --hf-checkpoint --data-dir --bf16, micro 8 x K={K}: {updates} "
          f"updates, loss {result['first_loss']:.4f} -> {result['loss']:.4f}, eval accuracy "
          f"{result['accuracy']:.4f} ({result['evaluations']} evaluations of "
          f"{result['eval_batches']} batches), {result['seq/s']:.1f} seq/s; launches "
          f"{counts}, all tc")


def _bert_small_step(cfg, micro=8, sparse=False):
    """A fresh BERT-Small model from seed 19830610 and its scan step (flash
    core, clip 1.0, AdamW over the main path's schedule)."""
    from gradaccum_tpu_torch.models.bert import bert_classifier_bundle
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.ops.sparse_embed import accumulate_scan_sparse_embed
    from gradaccum_tpu_torch.utils.tree import named_parameters

    bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
    model = bundle.init(19830610, "cuda")
    opt = adamw(warmup_polynomial_decay(2e-5, 16, 2), weight_decay_rate=0.01)
    config = acc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False)
    if sparse:
        hooks = bundle.sparse_embed._replace(
            loss_with_rows=lambda p, rows, b: bundle.sparse_embed.loss_with_rows(model, rows, b))
        step = accumulate_scan_sparse_embed(hooks, opt, config)
    else:
        step = acc.accumulate_scan(lambda p, b: bundle.loss(model, b), opt, config,
                                   needs_rng=True)
    return step, acc.scan_init(named_parameters(model), opt)


def _stacked(updates, micro, seed):
    import torch

    data = _bert_small_batches(updates * K * micro, seed=seed)
    return [{key: torch.as_tensor(v[u * K * micro:(u + 1) * K * micro], device="cuda")
             .reshape(K, micro, *v.shape[1:]) for key, v in data.items()}
            for u in range(updates)]


def phase_remat():
    import dataclasses

    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig
    from gradaccum_tpu_torch.ops import flash_attention as fa

    (batch,) = _stacked(1, 8, seed=5)
    finals, counts, peak = {}, {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(BertConfig.small(dtype=torch.bfloat16), remat=remat)
        step, state = _bert_small_step(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)  # dropout 0.1 draws here
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # both runs' states: measure above it
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        state, aux = step(state, batch, gen)
        torch.cuda.synchronize()
        counts[remat] = fa.launch_counts()
        peak[remat] = torch.cuda.max_memory_allocated() - held
        finals[remat] = (state, float(aux["loss"]), gen.get_state())
        check(math.isfinite(finals[remat][1]), f"remat={remat}: loss is not finite")
    per_layer = LAYERS * K
    check(counts[False] == {"flash_fwd": per_layer, "flash_bwd_dq": per_layer,
                            "flash_bwd_dkv": per_layer}, f"remat off: launches {counts[False]}")
    check(counts[True] == {"flash_fwd": 2 * per_layer, "flash_bwd_dq": per_layer,
                           "flash_bwd_dkv": per_layer}, f"remat on: launches {counts[True]}")
    a, b = finals[False][0].params, finals[True][0].params
    with torch.no_grad():
        diff = max(float((a[n] - b[n]).abs().max()) for n in a)
    check(all(torch.equal(a[n], b[n]) for n in a),
          f"remat: parameters after one update differ from no remat (max |diff| {diff:.3e})")
    check(finals[False][1] == finals[True][1], "remat: the losses differ")
    check(torch.equal(finals[False][2], finals[True][2]),
          "remat: the generator ended in another state")
    print(f"[remat] BERT-Small bf16, dropout 0.1, micro 8 x K={K}, one update: all {len(a)} "
          f"float32 parameters and the loss ({finals[True][1]:.6f}) bitwise equal with and "
          f"without remat, the generator in the same state; launches {counts[False]} without, "
          f"{counts[True]} with; the update's peak memory above the state it started "
          f"from (torch.cuda.max_memory_allocated) {peak[False] / 2**20:.1f} MiB without, "
          f"{peak[True] / 2**20:.1f} MiB with")
    return peak


def phase_sparse_embed(updates: int = 2):
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig

    cfg = BertConfig.small(dtype=torch.bfloat16, hidden_dropout=0.0, attention_dropout=0.0)
    batches = _stacked(updates, 8, seed=6)
    finals = {}
    for sparse in (False, True):
        step, state = _bert_small_step(cfg, sparse=sparse)
        gen = torch.Generator(device="cuda").manual_seed(0)  # dropout 0: never drawn
        for batch in batches:
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        finals[sparse] = state
    a, b = finals[False].params, finals[True].params
    with torch.no_grad():
        diffs = {n: float((a[n] - b[n]).abs().max()) for n in a}
        moved = float((a["params/bert/word_embeddings/embedding"]
                       - _bert_small_step(cfg)[1].params[
                           "params/bert/word_embeddings/embedding"]).abs().max())
    worst = max(diffs, key=diffs.get)
    check(all(bool(t.isfinite().all()) for t in b.values()), "sparse embed: non-finite weights")
    check(diffs[worst] <= SPARSE_ATOL, f"sparse embed: {worst} differs from the dense path by "
                                       f"{diffs[worst]:.3e} > {SPARSE_ATOL}")
    check(moved > 1e-6, f"sparse embed: the table did not move ({moved:.3e})")
    print(f"[sparse-embed] BERT-Small bf16, dropout 0, {updates} updates of micro 8 x K={K}: "
          f"{len(a)} float32 parameters within {SPARSE_ATOL} of the dense path (max |diff| "
          f"{diffs[worst]:.3e} in {worst}; table {diffs['params/bert/word_embeddings/embedding']:.3e}"
          f", moved {moved:.3e})")


def phase_moe(updates: int = 4, experts: int = 8, top_k: int = 2):
    import numpy as np
    import torch

    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention

    # the loss is the cross entropy plus 0.01 x the mean load-balance loss
    cfg = BertConfig.small(dtype=torch.bfloat16, num_experts=experts, moe_top_k=top_k)
    bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
    model = bundle.init(7, "cuda")
    batch = {key: torch.as_tensor(v, device="cuda")
             for key, v in _bert_small_batches(8, seed=8).items()}
    with torch.no_grad():
        batch["rng"] = torch.Generator(device="cuda").manual_seed(3)
        loss = float(bundle.loss(model, batch))
        batch["rng"] = torch.Generator(device="cuda").manual_seed(3)
        logits, aux = model.logits_and_aux(batch["input_ids"], batch["input_mask"],
                                           batch["segment_ids"], False, batch["rng"])
        ce = float(torch.nn.functional.cross_entropy(logits, batch["label"].long()))
    check(math.isfinite(float(aux)) and float(aux) > 0, f"MoE: load balance {float(aux)}")
    check(abs(loss - (ce + 0.01 * float(aux))) <= 1e-5,
          f"MoE: loss {loss} != ce {ce} + 0.01 x load balance {float(aux)}")
    del model

    argv = ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(K), "--max-steps", str(updates * K), "--mode", "scan",
            "--num-experts", str(experts), "--moe-top-k", str(top_k)]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    check(math.isfinite(result["loss"]), f"MoE: loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"MoE: ran {result['updates']} updates")
    _check_launches("moe", counts, routes, LAYERS * K * updates, result, "tc")
    check(np.isfinite(result["moe_dropped_fraction"]), "MoE: dropped fraction not finite")
    print(f"[moe] BERT-Small bf16, {experts} experts, top-{top_k}, micro 8 x K={K}: loss = ce "
          f"{ce:.6f} + 0.01 x load balance {float(aux):.6f} on one batch; {updates} updates, "
          f"loss {result['loss']:.4f}, eval accuracy {result['accuracy']:.4f}, dropped "
          f"fraction {result['moe_dropped_fraction']:.4f} (router entropy "
          f"{result['moe_router_entropy']:.4f}), {result['seq/s']:.1f} seq/s, mfu "
          f"{result['mfu']:.4f} (MoE FLOPs); launches {counts}, all tc")


# --------------------------------------------------------------------------
# phases 15-17: GPT-Small mixed precision, the fused guard, gpt_lm
# --------------------------------------------------------------------------

GPT_SEQ, GPT_MICRO, GPT_K, GPT_LAYERS = 512, 8, 4, 4
GPT_VOCAB = 50257
LADDER_UPDATES = 4
TRACK_LR, TRACK_IDS = 2e-3, 512  # the loss-tracking check: rate, token id range


def _gpt_batches(n, seed, vocab=None):
    """``n`` host batches of K x micro seeded token-id rows (seq 512), ids
    below ``vocab`` (default: the whole vocabulary)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = GPT_K * GPT_MICRO
    return [{"input_ids": rng.integers(0, vocab or GPT_VOCAB, size=(rows, GPT_SEQ))
             .astype(np.int32)} for _ in range(n)]


def _gpt_estimator(compute_dtype, opt, fused=False, clip=1.0, dropout=0.1, layers=GPT_LAYERS,
                   k=GPT_K, mode="scan", guard=None, loss=None, mesh=None, zero1=False):
    """GPT-Small (vocab 50257, H 512, A 8, FFN 2048, 512 positions) on the
    causal flash kernels, through the Estimator; ``guard``: a loss scale
    config (skip_nonfinite on); ``loss``: a wrapper of the bundle's loss;
    ``mesh``/``zero1``: a rank of a data-parallel run."""
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.flash_attention import causal_flash_attention

    bundle = gpt_lm_bundle(GPTConfig.small(dropout=dropout, num_layers=layers),
                           attention_fn=causal_flash_attention, compute_dtype=compute_dtype)
    if loss is not None:
        bundle = bundle._replace(loss=loss(bundle.loss))
    accum = GradAccumConfig(k, clip_norm=clip, fused_adam=fused, first_step_quirk=False,
                            skip_nonfinite=guard is not None, loss_scale=guard)
    return Estimator(bundle, opt, accum,
                     RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None),
                     mode=mode, device="cuda", mesh=mesh, zero1=zero1)


def _state_tensors(state):
    """Every tensor of a train state: parameters, then the optimizer state
    (q8 moments as their codes and scales), in a fixed order."""
    from gradaccum_tpu_torch.memory.quant import QuantTensor

    out = list(state.params.values())
    for value in state.opt_state:
        for t in (value.values() if isinstance(value, dict) else [value]):
            out.extend([t.q, t.scale] if isinstance(t, QuantTensor) else [t])
    return out


def _nbytes(t):
    return t.nbytes if hasattr(t, "q") else t.numel() * t.element_size()


def _release():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _gpt_leg(name, compute_dtype, opt, fused=False, clip=1.0):
    """One rung of the ladder: LADDER_UPDATES scan updates at micro 8 x K=4,
    dropout 0.1. Returns the row printed for it."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    est = _gpt_estimator(compute_dtype, opt, fused=fused, clip=clip)
    state = est.train([], final_save=False)  # weights and optimizer state
    n = sum(p.numel() for p in state.params.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state = est.train(_gpt_batches(LADDER_UPDATES, seed=15), final_save=False)
    torch.cuda.synchronize()
    counts, routes = fa.launch_counts(), fa.route_counts()
    peak = torch.cuda.max_memory_allocated() - held
    opt_bytes = sum(_nbytes(t) for field in state.opt_state
                    for t in (field.values() if isinstance(field, dict) else [field]))
    # two-pass: the float32 accumulator the scan step allocates; fused: none
    accum_bytes = 0 if fused else 4 * n
    param_bytes = sum(_nbytes(p) for p in state.params.values())
    first, last = float(est.first_loss), float(est.last_loss)
    check(math.isfinite(first) and math.isfinite(last), f"ladder {name}: loss {first} -> {last}")
    per_update = GPT_LAYERS * GPT_K
    want = {kname: per_update * LADDER_UPDATES for kname in counts}
    route = "tf32x3" if compute_dtype is None else "tc"
    check(counts == want, f"ladder {name}: launches {counts} != {want}")
    check(all(routes[kname][route] == want[kname] for kname in want),
          f"ladder {name}: routes {routes}, all on {route} wanted")
    seq_s = est.examples_per_sec()
    row = {"leg": name, "params": n, "opt_plus_accum_B_per_param": (opt_bytes + accum_bytes) / n,
           "opt_B_per_param": opt_bytes / n, "accum_B_per_param": accum_bytes / n,
           "param_B_per_param": param_bytes / n, "peak_above_state_MiB": peak / 2**20,
           "seq/s": seq_s, "tokens/s": seq_s * GPT_SEQ, "first_loss": first, "loss": last,
           "launches_per_update": per_update, "route": route}
    print(f"[ladder] {name:24s} opt+accum {row['opt_plus_accum_B_per_param']:6.3f} B/param "
          f"(optimizer {row['opt_B_per_param']:.3f}, accumulator {row['accum_B_per_param']:.0f})"
          f", params {row['param_B_per_param']:.0f} B/param, peak above state "
          f"{row['peak_above_state_MiB']:.1f} MiB, {seq_s:.1f} seq/s = "
          f"{row['tokens/s']:.0f} tokens/s, loss {first:.4f} -> {last:.4f}; "
          f"{per_update} launches per kernel per update, all {route}")
    del est, state
    _release()
    return row


def phase_gpt_ladder():
    """GPT-Small seq 512, micro 8 x K=4, dropout 0.1, scan mode, through the
    Estimator: the mixed-precision ladder, then fused against two-pass
    bitwise at K=1, then the bf16 + master loss against the f32 loss."""
    import torch

    from gradaccum_tpu_torch.ops.adamw import adam_mini, adamw

    f32, bf16 = torch.float32, torch.bfloat16
    legs = [
        ("(a) f32", None, adamw(1e-4, weight_decay_rate=0.01), False, 1.0),
        ("(b) bf16+master", bf16, adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32),
         False, 1.0),
        ("(c) bf16+master+fused", bf16,
         adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32), True, None),
        ("(d) bf16+master+q8", bf16,
         adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32, moment_dtype="q8"), False, 1.0),
        ("(e) adam_mini+master+q8", bf16, adam_mini(1e-4, master_dtype=f32, moment_dtype="q8"),
         False, 1.0),
    ]
    rows = [_gpt_leg(*leg) for leg in legs]
    print("[ladder] " + json.dumps(rows))

    # fused against two-pass at K=1 over one update: bitwise
    batch = _gpt_batches(1, seed=16)[0]
    finals = []
    for fused in (False, True):
        est = _gpt_estimator(bf16, adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32),
                             fused=fused, clip=None, k=1)
        state = est.train([{"input_ids": batch["input_ids"][:GPT_MICRO]}], final_save=False)
        torch.cuda.synchronize()
        finals.append([t.clone() for t in _state_tensors(state)])
        del est, state
        _release()
    same = all(torch.equal(a, b) for a, b in zip(*finals))
    check(len(finals[0]) == len(finals[1]) and same,
          "ladder: fused differs from two-pass at K=1 after one update")
    print(f"[ladder] fused equals two-pass bit for bit at K=1 after one update "
          f"({len(finals[0])} tensors: bf16 params, f32 masters, m, v)")
    del finals

    # one repeated batch, dropout 0: the bf16 + master loss tracks f32
    track = _gpt_batches(1, seed=17, vocab=TRACK_IDS)[0]
    curves = {}
    for name, dtype, opt in (("f32", None, adamw(TRACK_LR, weight_decay_rate=0.01)),
                             ("bf16+master", bf16, adamw(TRACK_LR, weight_decay_rate=0.01,
                                                         master_dtype=f32))):
        est = _gpt_estimator(dtype, opt, clip=None, dropout=0.0)
        curves[name] = []
        for _ in range(6):
            est.train([track], final_save=False)
            curves[name].append(float(est.last_loss))
        del est
        _release()
    a, b = curves["f32"], curves["bf16+master"]
    rel = [abs(x - y) / max(abs(x), 1e-6) for x, y in zip(a, b)]
    check(a[-1] < 0.8 * a[0] and b[-1] < 0.8 * b[0],
          f"loss tracking: a loss did not fall below 0.8x its first: f32 {a}, bf16 {b}")
    check(max(rel) < 0.08, f"loss tracking: bf16 + master off f32 by {max(rel):.4f} (f32 {a}, "
                           f"bf16 {b})")
    print(f"[ladder] one repeated batch (ids < {TRACK_IDS}), dropout 0, AdamW lr {TRACK_LR}: "
          f"f32 {[round(x, 4) for x in a]}, bf16+master {[round(x, 4) for x in b]}; "
          f"largest relative gap {max(rel):.4f} (gate 0.08)")
    return rows


def phase_gpt_profile(updates=2, f32=False):
    """Where the time of a GPT-Small bf16 + master update (or, with
    ``f32``, a float32 update: ladder leg (a)) goes: a torch.profiler window
    over ``updates`` scan updates after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.ops.adamw import adamw

    if f32:
        name = "f32 (ladder leg (a))"
        est = _gpt_estimator(None, adamw(1e-4, weight_decay_rate=0.01))
    else:
        name = "bf16+master"
        est = _gpt_estimator(torch.bfloat16, adamw(1e-4, weight_decay_rate=0.01,
                                                   master_dtype=torch.float32))
    batches = _gpt_batches(1 + updates, seed=18)
    est.train(batches[:1], final_save=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(batches[1:], final_save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels) / 1e6
    if busy == 0:
        print("[gpt-profile] the profiler saw no device time on this machine")
        return
    flash = sum(t for key, t, _ in kernels if "flash_" in key) / 1e6
    bwd = sum(t for key, t, _ in kernels if "flash_dq" in key or "flash_dkv" in key) / 1e6
    # the only float32 matrix products of a bf16 update are the tied head's
    head = sum(t for key, t, _ in kernels if "gemm" in key.lower()
               and "bf16" not in key.lower() and "16816" not in key) / 1e6
    gemms = "float32 GEMMs" if f32 else "float32 GEMMs (the tied head)"
    print(f"[gpt-profile] GPT-Small {name}, micro 8 x K=4, seq 512, {updates} updates: "
          f"{wall / updates * 1e3:.2f} ms/update wall, card busy {busy / updates * 1e3:.2f} "
          f"ms/update (idle share {1 - busy / wall:.3f}), "
          f"{sum(c for _, _, c in kernels) / updates:.0f} kernels/update, flash kernels "
          f"{flash / updates * 1e3:.2f} ms/update ({flash / busy:.3f} of busy; dq + dk/dv "
          f"{bwd / updates * 1e3:.2f}), {gemms} {head / updates * 1e3:.2f} ms/update "
          f"({head / busy:.3f} of busy)")
    for key, t, count in sorted(kernels, key=lambda x: -x[1])[:10]:
        print(f"[gpt-profile]   {t / updates / 1e3:8.3f} ms/update  {count // updates:5d}x  "
              f"{key[:90]}")
    del est
    _release()


def phase_gpt_guard(micro: int = GPT_MICRO):
    """The fused guard: GPT-Small bf16 + master at depth 2, fused_adam,
    skip_nonfinite and a dynamic loss scale, streaming and scan; window 0
    has one NaN micro-batch, window 1 only NaN ones, window 2 none. A batch
    column ``poison`` multiplies the loss (1.0 or NaN)."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig

    init_scale = 2.0 ** 15
    bad = {(0, 1)} | {(1, i) for i in range(GPT_K)}
    rows = 3 * GPT_K * micro
    data = {"input_ids": np.random.default_rng(19).integers(
        0, GPT_VOCAB, size=(rows, GPT_SEQ)).astype(np.int32),
        "poison": np.ones(rows, np.float32)}
    for w, i in bad:
        j = (w * GPT_K + i) * micro
        data["poison"][j:j + micro] = np.nan
    want_skips = [sum(1 for w, _ in bad if w == win) for win in range(3)]
    want_scales = [init_scale / 2, init_scale / 4, init_scale / 4]
    for mode in ("streaming", "scan"):
        est = _gpt_estimator(torch.bfloat16, adamw(1e-4, master_dtype=torch.float32),
                             fused=True, clip=None, layers=2, mode=mode,
                             guard=LossScaleConfig(init_scale=init_scale),
                             loss=lambda base: lambda m, b: base(m, b) * b["poison"].mean())
        host = micro * (GPT_K if mode == "scan" else 1)
        per_window = GPT_K * micro
        skips, snaps = [], []
        for w in range(3):
            window = {key: v[w * per_window:(w + 1) * per_window] for key, v in data.items()}
            est.train([{key: v[j:j + host] for key, v in window.items()}
                       for j in range(0, per_window, host)])
            skips.append(est.nonfinite_skips)
            state = est._state
            if mode == "streaming":
                check(state.accum_grads == (), "fused guard: the streaming state carries "
                                               "an accumulator")
            snaps.append([t.clone() for t in _state_tensors(state)])
        check(skips == want_skips, f"fused guard ({mode}): skipped {skips}, wanted {want_skips}")
        check(all(torch.equal(x, y) for x, y in zip(snaps[0], snaps[1])),
              f"fused guard ({mode}): the all-bad window changed params, masters or moments")
        check(not all(torch.equal(x, y) for x, y in zip(snaps[1], snaps[2])),
              f"fused guard ({mode}): the clean window after it did not apply")
        series = dict(est.loss_scale_series)
        scales = [series[(w + 1) * GPT_K] for w in range(3)]
        check(scales == want_scales, f"fused guard ({mode}): scale at window ends {scales}, "
                                     f"wanted {want_scales}")
        check(all(bool(t.isfinite().all()) for t in snaps[2] if t.is_floating_point()),
              f"fused guard ({mode}): a parameter, master or moment is not finite")
        print(f"[gpt-guard] {mode}, GPT-Small bf16+master depth 2, fused: skipped {skips} "
              f"micro-batches per window (NaN loss injected), all-bad window bitwise no-op over "
              f"{len(snaps[0])} tensors (params, masters, m, v), loss scale at window ends "
              f"{scales}")
        del est, snaps
        _release()


def phase_gpt_lm(steps: int = 32):
    """The gpt_lm entry point with --flash (float32: every launch on the
    float32 route ``tf32x3``) in scan and streaming mode, with --sample 40."""
    from gradaccum_tpu_torch.examples import gpt_lm
    from gradaccum_tpu_torch.ops import flash_attention as fa

    layers = 4  # gpt_lm's model
    out = {}
    for mode in ("scan", "streaming"):
        fa.reset_launch_counts()
        r = gpt_lm.main(["--device", "cuda", "--flash", "--mode", mode, "--max-steps",
                         str(steps), "--sample", "40"])
        counts, routes = fa.launch_counts(), fa.route_counts()
        check(math.isfinite(r["loss"]) and math.isfinite(r["first_loss"]),
              f"gpt_lm {mode}: loss {r['first_loss']} -> {r['loss']}")
        check(r["loss"] < r["first_loss"], f"gpt_lm {mode}: the loss did not fall "
                                           f"({r['first_loss']} -> {r['loss']})")
        check(0.0 <= r["token_accuracy"] <= 1.0, f"gpt_lm {mode}: accuracy {r['token_accuracy']}")
        train = layers * r["steps"]
        # --sample decodes with the KV cache (torch ops): no flash launch
        forward = train + layers * r["eval_batches"] * r["evaluations"]
        want = {"flash_fwd": forward, "flash_bwd_dq": train, "flash_bwd_dkv": train}
        check(counts == want, f"gpt_lm {mode}: launches {counts} != {want}")
        check(all(routes[k]["tf32x3"] == n and routes[k]["tc"] == 0 for k, n in want.items()),
              f"gpt_lm {mode}: routes {routes}, all tf32x3 wanted")
        print(f"[gpt_lm] --flash --mode {mode}: {r['steps']} micro-steps, {r['updates']} "
              f"updates, loss {r['first_loss']:.4f} -> {r['loss']:.4f}, token accuracy "
              f"{r['token_accuracy']:.4f} ({r['evaluations']} evaluations of "
              f"{r['eval_batches']} batches), {r['examples/s']:.1f} seq/s, decode "
              f"{r['decode_tokens_per_sec']:.1f} tokens/s (KV cache); launches {counts}, all "
              f"tf32x3; sample {r['sample']!r}")
        out[mode] = dict(r, launches=counts)
    return out


def phase_bert_f32(updates: int = 2):
    """The entry point at its default dtype, float32 (no --bf16): BERT-Small,
    seq 128, micro 8 x K=4, scan, ``updates`` updates and its evaluations.
    The only entry-point run of the float32 forward with a padded mask;
    every launch on the float32 route ``tf32x3``."""
    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.ops import flash_attention as fa

    argv = ["--device", "cuda", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(K), "--max-steps", str(updates * K)]
    fa.reset_launch_counts()
    maps0 = fa.f32_map_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    maps = {key: n - maps0[key] for key, n in fa.f32_map_counts().items()}
    check(result["dtype"] == "float32", f"bert f32: ran in {result['dtype']}")
    check(math.isfinite(result["loss"]), f"bert f32: loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"bert f32: ran {result['updates']} updates, "
                                        f"wanted {updates}")
    _check_launches("bert f32", counts, routes, LAYERS * K * updates, result, "tf32x3")
    print(f"[bert-f32] BERT-Small float32 micro 8 x K={K}, seq {S}: {updates} updates, "
          f"loss {result['first_loss']:.4f} -> {result['loss']:.4f}, {result['seq/s']:.1f} "
          f"seq/s, eval accuracy {result['accuracy']:.4f} ({result['evaluations']} "
          f"evaluations of {result['eval_batches']} batches); launches {counts}, all tf32x3; "
          f"the float32 kernels' tensor maps: {maps['lookups']} lookups, "
          f"{maps['encodes']} encodes")
    return counts


# --------------------------------------------------------------------------
# phase 19: data parallelism and ZeRO-1
# --------------------------------------------------------------------------

DP_UPDATES_A, DP_UPDATES_B, DP_UPDATES_C = 3, 2, 2
DP_MICRO_B = 4  # rows per rank in leg (b): a global micro-batch of 8
DP_ATOL, ZERO1_ATOL = 1e-5, 1e-7
NORM_RTOL = 1e-4  # the gradient norm's relative gap (order of sums only)
DP_DIR = os.path.join(ROOT, "build", "chip_smoke_dp")


def _bert_dp_estimator(mesh=None, zero1=False, dropout=0.1, k=K, lr=None, mode="scan",
                       **run):
    """BERT-Small bf16 (vocab 30522, seq 128) on the flash kernels through
    the Estimator, random weights from the run seed; ``lr``: a constant
    rate (else the main path's schedule); ``run``: more RunConfig fields."""
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay

    import torch

    cfg = BertConfig.small(dtype=torch.bfloat16, hidden_dropout=dropout,
                           attention_dropout=dropout)
    rate = lr if lr is not None else warmup_polynomial_decay(2e-5, 400, 40)
    return Estimator(bert_classifier_bundle(cfg, attention_fn=flash_attention),
                     adamw(rate, weight_decay_rate=0.01),
                     GradAccumConfig(k, clip_norm=1.0, first_step_quirk=False),
                     RunConfig(**dict(dict(log_step_count_steps=1000,
                                           save_checkpoints_steps=None), **run)),
                     mode=mode, device="cuda", mesh=mesh, zero1=zero1)


def _host_batches(updates, rows, seed, seq=S):
    data = _bert_small_batches(updates * rows, seed=seed, seq=seq)
    return [{key: v[u * rows:(u + 1) * rows] for key, v in data.items()} for u in range(updates)]


def _state_bytes(state, n, accum_bytes):
    """Optimizer + accumulator bytes per parameter held by this rank: the
    optimizer state's tensors, plus ``accum_bytes``, the buffers the scan
    step allocated for its window (none under fused accumulation)."""
    opt = sum(_nbytes(t) for field in state.opt_state
              for t in (field.values() if isinstance(field, dict) else [field]))
    return (opt + accum_bytes) / n


def _spy_window(acc):
    """Record the bytes of every window accumulator the scan step
    allocates (``accumulation._window_accum``) and each update's gradient
    norm before clipping; returns ``(accum_bytes, wrap)``, where
    ``wrap(est, norms)`` makes ``est``'s built step append to ``norms``."""
    window = acc._window_accum
    held = []

    def measured(params, n_stats=0):
        out = window(params, n_stats)
        held.append(sum(_nbytes(b) for b in out[1]))
        return out

    acc._window_accum = measured

    def wrap(est, norms):
        inner = est._train_step

        def step(state, batch, *rng):
            state, aux = inner(state, batch, *rng)
            norms.append(float(aux["grad_norm"]))
            return state, aux

        est._train_step = step

    return held, wrap


def _launches_per_kernel(updates, k=K, layers=LAYERS):
    return {name: layers * k * updates for name in REPLACES}


def _dp_leg_a():
    """World size 1 over NCCL against the no-mesh run: bitwise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.examples.common import free_port
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    batches = _host_batches(DP_UPDATES_A + 2, K * B, seed=21)
    ref = _bert_dp_estimator()
    ref_state = ref.train(batches[:DP_UPDATES_A], final_save=False)
    torch.cuda.synchronize()
    ref_seq = ref.examples_per_sec()
    ref_state = ref_state._replace(params={n: p.detach().clone()
                                           for n, p in ref_state.params.items()})
    mesh_lib.initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = mesh_lib.data_parallel_mesh()
        check(mesh.backend == "nccl", f"dp (a): backend {mesh.backend}, wanted nccl")
        est = _bert_dp_estimator(mesh=mesh)
        est.train([], final_save=False)  # weights, optimizer state, the broadcast
        fa.reset_launch_counts()
        mesh.reset_calls()
        state = est.train(batches[:DP_UPDATES_A], final_save=False)
        torch.cuda.synchronize()
        counts, routes, calls = fa.launch_counts(), fa.route_counts(), dict(mesh.calls)
        seq = est.examples_per_sec()
        with torch.no_grad():
            same = [name for name in ref_state.params
                    if torch.equal(state.params[name], ref_state.params[name])
                    and torch.equal(state.opt_state.m[name], ref_state.opt_state.m[name])
                    and torch.equal(state.opt_state.v[name], ref_state.opt_state.v[name])]
        check(len(same) == len(ref_state.params),
              f"dp (a): {len(ref_state.params) - len(same)} parameters or moments differ from "
              f"the no-mesh run at world 1")
        want = _launches_per_kernel(DP_UPDATES_A)
        check(counts == want, f"dp (a): launches {counts} != {want}")
        check(all(routes[n]["tc"] == want[n] for n in want), f"dp (a): routes {routes}")
        check(calls.get("all_reduce") == DP_UPDATES_A
              and calls.get("all_reduce:grads") == DP_UPDATES_A,
              f"dp (a): collectives {calls}, wanted one all-reduce per update")
        print(f"[dp] (a) BERT-Small bf16 micro 8 x K={K}, world 1 over NCCL, "
              f"{DP_UPDATES_A} updates: {len(same)} parameters and their m, v bitwise equal "
              f"to the no-mesh run; launches {counts}, all tc; collectives {calls} "
              f"(one all-reduce per update); {seq:.1f} seq/s against {ref_seq:.1f} "
              f"without the mesh")
        # seq/s in turns (no mesh, mesh, mesh, no mesh), two updates each
        turns = []
        for name, e in (("no mesh", ref), ("mesh", est), ("mesh", est), ("no mesh", ref)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.train(batches[DP_UPDATES_A:], final_save=False)
            torch.cuda.synchronize()
            turns.append(f"{name} {2 * K * B / (time.perf_counter() - t0):.1f}")
        print(f"[dp] (a) seq/s in turns of 2 updates: {', '.join(turns)}")
        # a profiler window of two updates each: the NCCL kernels, the card's
        # busy time, and the host ops that take the most time
        for name, e in (("mesh", est), ("no mesh", ref)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                e.train(batches[DP_UPDATES_A:], final_save=False)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / 2 * 1e3
            events = prof.key_averages()
            device = [(ev.key, ev.self_device_time_total, ev.count) for ev in events
                      if ev.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(t for _, t, _ in device) / 2 / 1e3
            line = (f"[dp] (a) profile, {name}: {wall:.2f} ms/update wall, card busy "
                    f"{busy:.2f} ms/update")
            if e is est:
                nccl = [row for row in device if "nccl" in row[0].lower()]
                seen = ", ".join(f"{key[:60]} x{c}" for key, _, c in nccl) or "none"
                line += (f", NCCL card time {sum(t for _, t, _ in nccl) / 2 / 1e3:.4f} "
                         f"ms/update (kernels: {seen})")
            host = sorted((ev for ev in events
                           if ev.device_type == torch.autograd.DeviceType.CPU),
                          key=lambda ev: -ev.self_cpu_time_total)[:6]
            print(line + "; host ops by self time per update: " + ", ".join(
                f"{ev.key[:40]} {ev.self_cpu_time_total / 2 / 1e3:.2f} ms x{ev.count // 2}"
                for ev in host))
    finally:
        mesh_lib.shutdown()
    del ref, est
    _release()


def _dp_rank(outdir):
    """One rank of legs (b) and (c): gloo on the shared card."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    from gradaccum_tpu_torch.ops import accumulation as acc

    fa.build_kernels()  # the parent built them: loads the libraries
    mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    out = {}
    window_bytes, wrap = _spy_window(acc)
    try:
        mesh = mesh_lib.data_parallel_mesh()
        rows = DP_MICRO_B * mesh.world * K
        batches = _host_batches(DP_UPDATES_B, rows, seed=22)
        for tag, zero1 in (("dp", False), ("zero1", "collective")):
            est = _bert_dp_estimator(mesh=mesh, zero1=zero1, dropout=0.0, lr=2e-5)
            est.train([], final_save=False)
            norms = []
            wrap(est, norms)
            fa.reset_launch_counts()
            window_bytes.clear()
            t0 = time.perf_counter()
            state = est.train(batches, final_save=False)
            torch.cuda.synchronize()
            n = sum(p.numel() for p in state.params.values())
            out[tag] = {"params": {k: v.detach().cpu() for k, v in state.params.items()},
                        "launches": fa.launch_counts(), "routes": fa.route_counts(),
                        "bytes": _state_bytes(state, n, max(window_bytes)), "grad_norms": norms,
                        "seconds": time.perf_counter() - t0}
            del est, state
            _release()
        # (c) GPT-Small bf16 + master + fused + ZeRO-1 (ladder leg (c))
        est = _gpt_estimator(torch.bfloat16, adamw(1e-4, weight_decay_rate=0.01,
                                                   master_dtype=torch.float32),
                             fused=True, clip=None, mesh=mesh, zero1=True)
        state = est.train([], final_save=False)
        n = sum(p.numel() for p in state.params.values())
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        mesh.reset_calls()
        window_bytes.clear()
        import numpy as np

        ids = np.concatenate([_gpt_batches(1, seed=23 + u)[0]["input_ids"]
                              for u in range(mesh.world)])  # K x micro rows per rank
        rng = np.random.default_rng(24)
        more = [{"input_ids": rng.permutation(ids)} for _ in range(DP_UPDATES_C - 1)]
        t0 = time.perf_counter()
        state = est.train([{"input_ids": ids}] + more, final_save=False)
        torch.cuda.synchronize()
        out["gpt"] = {"bytes": _state_bytes(state, n, max(window_bytes, default=0)), "params": n,
                      "peak_MiB": (torch.cuda.max_memory_allocated() - held) / 2**20,
                      "held_MiB": held / 2**20, "launches": fa.launch_counts(),
                      "routes": fa.route_counts(), "first_loss": float(est.first_loss),
                      "loss": float(est.last_loss), "seconds": time.perf_counter() - t0,
                      "calls": dict(mesh.calls)}
        out["gloo_cuda"] = _probe_gloo_cuda()
        torch.save(out, os.path.join(outdir, f"rank{mesh.rank}.pt"))
        rank = mesh.rank
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _probe_gloo_cuda():
    """Which collectives this torch's gloo runs on CUDA tensors, asked
    directly in a group of its own with a short timeout: the port stages
    none through host memory (``parallel/mesh.py``), so a refusal here
    names the op that would fail."""
    import datetime

    import torch
    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=30))
    x = torch.ones(4, device="cuda")
    rank = dist.get_rank(group)

    def all_to_all():
        # rank r sends [r, r] to each peer: it receives [j, j] from rank j
        got = torch.empty(4, device="cuda")
        dist.all_to_all_single(got, torch.full((4,), float(rank), device="cuda"),
                               group=group)
        want = torch.tensor([0.0, 0.0, 1.0, 1.0], device="cuda")
        return None if torch.equal(got, want) else f"wrong values {got.tolist()}"

    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                                              group=group),
        "all_to_all_single": all_to_all,
    }
    found = {}
    for name, op in ops.items():
        try:
            wrong = op()
            torch.cuda.synchronize()
            found[name] = wrong or "runs on CUDA tensors"
        except (RuntimeError, ValueError) as e:
            found[name] = f"refused: {str(e).splitlines()[0][:120]}"
    return found


def _dp_legs_bc():
    """Two ranks on the one card over gloo, spawned here."""
    import torch

    from gradaccum_tpu_torch.examples.common import spawn_ranks
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.utils.tree import named_parameters

    world = 2
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    # the single-process reference on the same global batches: one card
    # runs each rank's K micro-batches of 4 rows (the same products, so
    # only the order of the sums differs), denominator K x 2, one update
    # each, at the ranks' constant rate
    rows = DP_MICRO_B * world * K
    est = _bert_dp_estimator(dropout=0.0, lr=2e-5, k=K * world)
    state = est.train([], final_save=False)
    step = est._step_fn()
    ref_norms = []
    for batch in _host_batches(DP_UPDATES_B, rows, seed=22):
        stacked = acc.stack_micro_batches(est._to_device(batch), K)  # [K, 8, ...]
        local = {key: x.reshape(K, world, DP_MICRO_B, *x.shape[2:]).transpose(0, 1)
                 .reshape(K * world, DP_MICRO_B, *x.shape[2:]) for key, x in stacked.items()}
        state, aux = step(state, local, torch.Generator(device="cuda"))
        ref_norms.append(float(aux["grad_norm"]))
    torch.cuda.synchronize()
    ref = {name: p.detach().cpu() for name, p in named_parameters(est.module).items()}
    del est, state, step
    _release()
    t0 = time.perf_counter()
    spawn_ranks("chip_smoke", ["--dp-rank", DP_DIR], world, "cuda", deadline_s=600)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt")) for r in range(world)]
    want_b = _launches_per_kernel(DP_UPDATES_B)
    for r, out in enumerate(ranks):
        for tag in ("dp", "zero1"):
            check(out[tag]["launches"] == want_b,
                  f"dp (b) rank {r} {tag}: launches {out[tag]['launches']} != {want_b}")
            check(all(out[tag]["routes"][n]["tc"] == want_b[n] for n in want_b),
                  f"dp (b) rank {r} {tag}: routes {out[tag]['routes']}")
        err = max(float((out["dp"]["params"][n] - ref[n]).abs().max()) for n in ref)
        zerr = max(float((out["zero1"]["params"][n] - out["dp"]["params"][n]).abs().max())
                   for n in ref)
        moved = max(float((out["dp"]["params"][n] - w).abs().max()) for n, w in
                    named_parameters(_bert_dp_estimator(dropout=0.0).model.init(
                        19830610, "cpu")).items())
        # clipping and Adam hide the gradient's scale from the parameters:
        # the norm of the averaged gradient before clipping shows it
        norm_err = max(abs(a / b - 1.0) for tag in ("dp", "zero1")
                       for a, b in zip(out[tag]["grad_norms"], ref_norms))
        check(len(out["dp"]["grad_norms"]) == len(out["zero1"]["grad_norms"]) == DP_UPDATES_B
              and norm_err <= NORM_RTOL,
              f"dp (b) rank {r}: gradient norms {out['dp']['grad_norms']} (DP), "
              f"{out['zero1']['grad_norms']} (ZeRO-1) against {ref_norms}")
        check(err <= DP_ATOL, f"dp (b) rank {r}: DP off the single-process run by {err:.3e}")
        check(zerr <= ZERO1_ATOL, f"dp (b) rank {r}: ZeRO-1 off DP by {zerr:.3e}")
        check(moved > 10 * DP_ATOL, f"dp (b) rank {r}: the weights did not move ({moved:.3e})")
        print(f"[dp] (b) rank {r}/2, gloo on the shared card, BERT-Small bf16 micro "
              f"{DP_MICRO_B} per rank x K={K}, dropout 0, {DP_UPDATES_B} updates: max |DP - "
              f"single process| {err:.3e} (limit {DP_ATOL:g}), max |ZeRO-1 - DP| {zerr:.3e} "
              f"(limit {ZERO1_ATOL:g}), weights moved {moved:.3e}; gradient norms before "
              f"clipping {out['dp']['grad_norms']} against {ref_norms} single-process "
              f"(max relative gap {norm_err:.3e}, limit {NORM_RTOL:g}); launches "
              f"{out['dp']['launches']} per run, all tc; optimizer + accumulator "
              f"{out['dp']['bytes']:.3f} B/param (DP) and {out['zero1']['bytes']:.3f} "
              f"(ZeRO-1); {out['dp']['seconds']:.2f} s and {out['zero1']['seconds']:.2f} s "
              f"for the {DP_UPDATES_B} updates")
    want_c = _launches_per_kernel(DP_UPDATES_C, k=GPT_K, layers=GPT_LAYERS)
    for r, out in enumerate(ranks):
        g = out["gpt"]
        check(math.isfinite(g["first_loss"]) and math.isfinite(g["loss"]),
              f"dp (c) rank {r}: loss {g['first_loss']} -> {g['loss']}")
        check(g["launches"] == want_c, f"dp (c) rank {r}: launches {g['launches']} != {want_c}")
        print(f"[dp] (c) rank {r}/2, GPT-Small bf16 + f32 masters + fused + ZeRO-1 "
              f"(ladder leg (c)), micro {GPT_MICRO} per rank x K={GPT_K}, seq {GPT_SEQ}, "
              f"{DP_UPDATES_C} updates: optimizer + accumulator {g['bytes']:.3f} B/param "
              f"({g['params']} parameters; JAX's accounting: 6), peak {g['peak_MiB']:.1f} MiB "
              f"above the {g['held_MiB']:.1f} MiB state, loss {g['first_loss']:.4f} -> "
              f"{g['loss']:.4f}, {g['seconds']:.2f} s; launches {g['launches']}; "
              f"collectives {g['calls']}")
    print(f"[dp] legs (b) and (c): the two ranks took {spawn_s:.1f} s, process start included")
    print(f"[dp] gloo with CUDA tensors on this torch (asked directly): {ranks[0]['gloo_cuda']}")


def phase_dp():
    """Data parallelism and ZeRO-1 on the one card: (a) world 1 over NCCL,
    (b) and (c) two ranks sharing the card over gloo."""
    _dp_leg_a()
    _dp_legs_bc()


# --------------------------------------------------------------------------
# phase 22: model parallelism (tensor and expert parallelism, ZeRO-1 with rules)
# --------------------------------------------------------------------------

MP_DIR = os.path.join(ROOT, "build", "chip_smoke_mp")
MP_LOSS_RTOL = 1e-5  # float32 legs: losses against the one-process run
MP_PARAM_TOL = (2e-4, 2e-5)  # rtol, atol: JAX's tests/test_tp.py
MP_EXPERTS, MP_TOP_K = 8, 2


def _mp_legs():
    """The legs of phase 22 by name: ranks, mesh axes, rules and the run."""
    import torch

    from gradaccum_tpu_torch.parallel.tp import bert_tp_ep_rules, bert_tp_rules

    return {
        "tp_f32": dict(world=2, axes=[("data", 1), ("model", 2)], rules=bert_tp_rules(),
                       dtype=torch.float32, dropout=0.1, updates=3),
        "tp_bf16": dict(world=2, axes=[("data", 1), ("model", 2)], rules=bert_tp_rules(),
                        dtype=torch.bfloat16, dropout=0.1, updates=3),
        "tpep_f32": dict(world=4, axes=[("data", 1), ("model", 2), ("expert", 2)],
                         rules=bert_tp_ep_rules(), dtype=torch.float32, dropout=0.1,
                         updates=2, experts=MP_EXPERTS),
        # bf16: the router's input differs from one process's by rounding
        # (the row-parallel sums), which flips the routing of near-tied
        # tokens: the ranks must agree exactly, the one process is a finding
        "tpep": dict(world=4, axes=[("data", 1), ("model", 2), ("expert", 2)],
                     rules=bert_tp_ep_rules(), dtype=torch.bfloat16, dropout=0.1, updates=2,
                     experts=MP_EXPERTS, ranks_only=True),
        "zero1": dict(world=4, axes=[("data", 2), ("model", 2)], rules=bert_tp_rules(),
                      dtype=torch.float32, dropout=0.0, updates=2, adam_mini=True, zero1=True),
    }


def _mp_predicted_calls(name):
    """The collectives of one update the design predicts (PERF.md, phase
    22), by ``"<axes>/<op>[:<tag>]"``: per micro-batch on the model axis the
    vocab lookup's sum, then per layer the attention output's sum forward
    and the QKV ``copy_to`` sum backward, and the FFN's pair (the MoE's:
    the combine's sum forward and x's and the gates' ``copy_to`` backward,
    over model+expert, and b_out's ``copy_to`` over model); per update one
    scalar norm all-reduce over the split axes; under dp=2 one gradient
    average per micro-batch over data; ZeRO-1 one parameter all-gather and
    Adam-mini one statistics all-reduce per split axis."""
    L = LAYERS
    if name in ("tp_f32", "tp_bf16"):
        return {"model/all_reduce": K * (1 + 4 * L) + 1}
    if name in ("tpep", "tpep_f32"):
        return {"model/all_reduce": K * (1 + 3 * L),
                "model+expert/all_reduce": K * 3 * L + 1}
    return {"model/all_reduce": K * (1 + 4 * L) + 1 + 1,
            "data/all_reduce": K + 1, "data/all_gather": 1}


def _bert_mp_estimator(mesh=None, rules=None, dtype=None, dropout=0.1, experts=0,
                       adam_mini=False, zero1=False, model_dir=None, **_leg):
    """BERT-Small (vocab 30522, seq 128, L-4 H-512 A-8) on the flash
    kernels through the Estimator, random weights from the run seed, the
    main path's schedule; ``experts``: the MoE FFN, top-2."""
    import torch

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adam_mini as mini, adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay

    cfg = BertConfig.small(dtype=dtype or torch.float32, hidden_dropout=dropout,
                           attention_dropout=dropout, num_experts=experts,
                           moe_top_k=MP_TOP_K if experts else 1)
    rate = warmup_polynomial_decay(2e-5, 400, 40)
    opt = mini(rate) if adam_mini else adamw(rate, weight_decay_rate=0.01)
    return Estimator(bert_classifier_bundle(cfg, attention_fn=flash_attention), opt,
                     GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False),
                     RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None,
                               model_dir=model_dir),
                     mode="scan", device="cuda", mesh=mesh, zero1=zero1, sharding_rules=rules)


def _mp_run(est, batches, norms, mesh=None, profile_last=False):
    """Train one update per batch: the losses, the collectives of each
    update, and (``profile_last``) the card's flash kernels in a profiler
    window over the last update."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    losses, calls, seen = [], [], {}
    for i, batch in enumerate(batches):
        if mesh is not None:
            mesh.reset_calls()
        if profile_last and i == len(batches) - 1:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                est.train([batch], final_save=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            device = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            # gloo moves a CUDA tensor through host memory: its copies are
            # the collectives' card time
            seen = {"flash": {e.key[:40]: e.count for e in device if "flash_" in e.key},
                    "wall_ms": wall * 1e3,
                    "busy_ms": sum(e.self_device_time_total for e in device) / 1e3,
                    "copy_ms": sum(e.self_device_time_total for e in device
                                   if "memcpy" in e.key.lower()) / 1e3,
                    "flash_ms": sum(e.self_device_time_total for e in device
                                    if "flash_" in e.key) / 1e3}
        else:
            est.train([batch], final_save=False)
        losses.append(float(est.last_loss))
        if mesh is not None:
            calls.append({k: v for k, v in mesh.calls.items() if ":" not in k})
    return losses, calls, seen


def _model_numel(est):
    """The model's parameter count, from this rank's blocks and their
    placement."""
    from gradaccum_tpu_torch.parallel.sharding import placement

    total = 0
    for p in est._state.params.values():
        n = p.numel()
        for axis in placement(p) or ():
            n *= est.mesh.shape[axis] if axis else 1
        total += n
    return total


def _wrap_norms(est, norms):
    """Make ``est``'s built step append each update's norm before clipping."""
    inner = est._train_step

    def step(state, batch, *rng):
        state, aux = inner(state, batch, *rng)
        norms.append(float(aux["grad_norm"]))
        return state, aux

    est._train_step = step


def _moe_dropped(est):
    return [float(getattr(est.module.bert, f"layer_{i}").moe.last_aux["dropped_fraction"])
            for i in range(LAYERS)]


def _mp_rank(outdir, world):
    """One rank of phase 22: gloo on the shared card; runs every leg of
    ``world`` ranks."""
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    
    fa.build_kernels()  # the parent built them: loads the libraries
    mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    window_bytes, wrap = _spy_window(acc)
    launch = fa._launch
    shapes = set()

    def spy(name, dtype, t0, *args):
        # (B, H, S, D, head_offset, heads_total) of every kernel launch
        shapes.add((name, args[-11], args[-10], args[-9], args[0], args[-3], args[-2]))
        return launch(name, dtype, t0, *args)

    fa._launch = spy
    out = {}
    try:
        for name, leg in _mp_legs().items():
            if leg["world"] != int(world):
                continue
            mesh = mesh_lib.make_mesh(leg["axes"])
            if name == "zero1":
                out["gloo_subgroups"] = _probe_gloo_subgroup(mesh)
            model_dir = os.path.join(outdir, f"ckpt_{name}") if name == "zero1" else None
            est = _bert_mp_estimator(mesh, model_dir=model_dir, **leg)
            est.train([], final_save=False)
            norms = []
            wrap(est, norms)
            window_bytes.clear()
            shapes.clear()
            fa.reset_launch_counts()
            batches = _host_batches(leg["updates"], K * B, seed=61)
            t0 = time.perf_counter()
            losses, calls, seen = _mp_run(est, batches, norms, mesh, profile_last=True)
            seconds = time.perf_counter() - t0
            state = est._state
            n = _model_numel(est)
            res = {"losses": losses, "norms": norms, "calls": calls, "profile": seen,
                   "launches": fa.launch_counts(), "routes": fa.route_counts(),
                   "shapes": sorted(shapes), "seconds": seconds,
                   "bytes": _state_bytes(state, n, max(window_bytes, default=0)),
                   "param_bytes": sum(_nbytes(p) for p in state.params.values()) / n}
            if leg.get("experts"):
                res["dropped"] = _moe_dropped(est)
            whole = est._global_state(state)  # every rank gathers
            if mesh.rank == 0:
                res["params"] = {k: v.detach().float().cpu() for k, v in whole.params.items()}
                if name == "zero1":
                    res["gathered"] = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                                       for k, v in ckpt_lib.flatten(whole).items()}
            if model_dir:
                est._save(state)  # the global state: every rank gathers, rank 0 writes
                est._ckpt_sync()
            out[name] = res
            del est, state, whole
            _release()
        torch.save(out, os.path.join(outdir, f"rank{mesh_lib.current_mesh().rank}.pt"))
        rank = mesh_lib.current_mesh().rank
    finally:
        fa._launch = launch
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _probe_gloo_subgroup(mesh):
    """Whether this torch's gloo runs each collective the model axes issue
    on CUDA tensors in a ``dist.new_group`` subgroup (the model axis of a
    data x model mesh): SUM and MIN all-reduce, all-gather and broadcast,
    in float32 and bfloat16."""
    import torch

    m = mesh.axis("model")
    found = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(4, dtype=dtype, device=mesh.device)
        ops = {
            "all_reduce": lambda: m.all_reduce_(x.clone(), tag="probe"),
            "pmin": lambda: m.pmin_flag(torch.ones((), dtype=torch.bool, device=mesh.device)),
            "all_gather": lambda: m.all_gather(x, tag="probe"),
            "broadcast": lambda: m.broadcast_(x.clone(), tag="probe"),
        }
        ops.update(_collective_probes(m, dtype))
        for name, op in ops.items():
            key = f"{name}:{str(dtype)[6:]}"
            try:
                wrong = op()
                torch.cuda.synchronize()
                found[key] = wrong if isinstance(wrong, str) else "runs"
            except (RuntimeError, ValueError) as e:
                found[key] = f"refused: {str(e).splitlines()[0][:100]}"
    m.reset_calls()
    return found


def _collective_probes(m, dtype):
    """The differentiable collectives of ``parallel/mesh.py`` on the axis
    mesh ``m``, each a function that returns None when every rank received
    the values it should, else a string saying what came: ``ppermute``
    round the ring and along the pipeline (the first rank gets zeros), and
    ``all_to_all``."""
    import torch

    n, r, dev = m.world, m.rank, m.device

    def block(rank):  # what rank ``rank`` sends: its index in every value
        return (torch.arange(6, device=dev, dtype=torch.float32) + 100 * rank).to(dtype)

    def compare(got, want):
        return None if torch.equal(got, want) else f"wrong values {got.float().tolist()}"

    def ring():
        return compare(m.ppermute(block(r), [(i, (i + 1) % n) for i in range(n)],
                                  tag="probe"), block((r - 1) % n))

    def pipe():
        want = torch.zeros_like(block(r)) if r == 0 else block(r - 1)
        return compare(m.ppermute(block(r), [(i, i + 1) for i in range(n - 1)],
                                  tag="probe"), want)

    def all_to_all():
        # rank r's chunk j is [r, j]; rank r receives chunk r of every rank
        x = torch.tensor([[r, j] for j in range(n)], device=dev, dtype=torch.float32)
        want = torch.tensor([[j, r] for j in range(n)], device=dev, dtype=torch.float32)
        return compare(m.all_to_all(x.to(dtype), 0, 0, tag="probe"), want.to(dtype))

    return {"ppermute_ring": ring, "ppermute_pipe": pipe, "all_to_all": all_to_all}


def _mp_reference(name, leg):
    """The leg in one process (tp=1, no mesh) on the same global batches."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    est = _bert_mp_estimator(**dict(leg, rules=None, zero1=False))
    est.train([], final_save=False)
    norms = []
    _wrap_norms(est, norms)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    losses, _, _ = _mp_run(est, _host_batches(leg["updates"], K * B, seed=61), norms)
    torch.cuda.synchronize()
    ref = {"losses": losses, "norms": norms, "launches": fa.launch_counts(),
           "seconds": time.perf_counter() - t0,
           "params": {k: v.detach().float().cpu() for k, v in est._state.params.items()}}
    if leg.get("experts"):
        ref["dropped"] = _moe_dropped(est)
    del est
    _release()
    return ref


def _mp_check(name, leg, ref, ranks):
    """Hold each rank of leg ``name`` against the one-process run."""
    import torch

    bf16 = leg["dtype"] == torch.bfloat16
    atol, rtol = TOL["torch.bfloat16"]["o"] if bf16 else (MP_PARAM_TOL[1], MP_PARAM_TOL[0])
    loss_rtol = TOL["torch.bfloat16"]["o"][1] if bf16 else MP_LOSS_RTOL
    want_launch = _launches_per_kernel(leg["updates"])
    want_calls = _mp_predicted_calls(name)
    heads = H // dict(leg["axes"])["model"]
    route = "tc" if bf16 else "tf32x3"
    ranks_only = leg.get("ranks_only", False)
    for r, out in enumerate(ranks):
        res = out[name]
        gaps = [abs(a - b) / abs(b) for a, b in zip(res["losses"], ref["losses"])]
        norm_gap = max(abs(a / b - 1.0) for a, b in zip(res["norms"], ref["norms"]))
        if ranks_only:
            # every rank of a model copy computes the same loss, norm and drops
            for key in ("losses", "norms", "dropped"):
                check(res[key] == ranks[0][name][key],
                      f"mp {name} rank {r}: {key} {res[key]} against rank 0's "
                      f"{ranks[0][name][key]}")
        else:
            check(len(gaps) == leg["updates"] and max(gaps) <= loss_rtol,
                  f"mp {name} rank {r}: losses {res['losses']} against {ref['losses']}")
            check(norm_gap <= (TOL["torch.bfloat16"]["o"][1] if bf16 else NORM_RTOL),
                  f"mp {name} rank {r}: norms {res['norms']} against {ref['norms']}")
        check(res["launches"] == want_launch and ref["launches"] == want_launch,
              f"mp {name} rank {r}: launches {res['launches']} (one process "
              f"{ref['launches']}) != {want_launch}")
        check(all(res["routes"][k][route] == want_launch[k] for k in want_launch),
              f"mp {name} rank {r}: routes {res['routes']}")
        for u, calls in enumerate(res["calls"]):
            check(calls == want_calls, f"mp {name} rank {r} update {u}: collectives {calls}, "
                                       f"the design predicts {want_calls}")
        kinds = {(b, h, s, d) for _, b, h, s, d, _, _ in res["shapes"]}
        offsets = {(off, total) for *_, off, total in res["shapes"]}
        rows = B // dict(leg["axes"])["data"]
        import numpy as np

        coords = dict(zip([a for a, _ in leg["axes"]],
                          np.unravel_index(r, [n for _, n in leg["axes"]])))
        # the dropout key places this rank's heads in the whole attention;
        # without dropout the kernels are asked for their own heads
        want_off = {(int(coords["model"]) * heads, H)} if leg["dropout"] else {(0, heads)}
        check(kinds == {(rows, heads, S, D)} and offsets == want_off,
              f"mp {name} rank {r}: kernel shapes {kinds}, head offset/total {offsets}, "
              f"wanted {(rows, heads, S, D)} and {want_off}")
        prof = res["profile"]
        check(len(prof["flash"]) >= 3, f"mp {name} rank {r}: the profiler window saw the "
                                       f"flash kernels {prof['flash']}")
        if leg.get("experts") and not ranks_only:
            check(res["dropped"] == ref["dropped"],
                  f"mp {name} rank {r}: dropped fraction {res['dropped']} against "
                  f"{ref['dropped']}")
        line = (f"[mp] {name} rank {r}/{leg['world']} {dict(leg['axes'])}, "
                f"{str(leg['dtype'])[6:]} route {route}, dropout {leg['dropout']}, "
                f"{leg['updates']} updates: losses {res['losses']} against {ref['losses']} "
                f"one process (max relative gap {max(gaps):.2e}, "
                f"{'not gated' if ranks_only else f'limit {loss_rtol:g}'}); norms "
                f"before clipping gap {norm_gap:.2e}; kernels on {sorted(kinds)} with head "
                f"offset/total {sorted(offsets)}; last update under the profiler: "
                f"{prof['wall_ms']:.1f} ms wall, card busy {prof['busy_ms']:.2f} ms, of which "
                f"gloo's host copies {prof['copy_ms']:.2f} ms and the flash kernels "
                f"{prof['flash_ms']:.2f} ms ({prof['flash']}); "
                f"collectives per update {res['calls'][0]}; optimizer + accumulator "
                f"{res['bytes']:.3f} B and parameters {res['param_bytes']:.3f} B per "
                f"parameter of the model on this rank; {res['seconds']:.2f} s against "
                f"{ref['seconds']:.2f} s one process")
        if leg.get("experts"):
            line += (f"; dropped fraction per layer {res['dropped']} (one process "
                     f"{ref['dropped']})")
        print(line)
    params = ranks[0][name]["params"]
    skip = ("attention/key/bias",) if leg.get("adam_mini") else ()
    worst = 0.0
    for k, want in ref["params"].items():
        if any(s_ in k for s_ in skip):
            continue
        err = (params[k] - want).abs()
        worst = max(worst, float(err.max()))
        check(ranks_only or bool((err <= atol + rtol * want.abs()).all()),
              f"mp {name}: parameter {k} off the one-process run by {float(err.max()):.3e}")
    if ranks_only:
        print(f"[mp] {name}: the ranks agree exactly on losses, norms and drops; against "
              f"the one-process run (a finding, not a gate): max loss gap "
              f"{max(gaps):.3e}, max |parameter err| {worst:.3e}")
        return
    print(f"[mp] {name}: every gathered parameter within atol {atol:g} + rtol {rtol:g} of "
          f"the one-process run (max |err| {worst:.3e})"
          + (" (the key biases aside: their gradient is zero but for rounding and Adam-mini "
             "divides it by its own RMS)" if skip else ""))


def phase_mp():
    """Model parallelism on the one card, its ranks sharing it over gloo:
    (a) tp=2 BERT-Small float32 (route tf32x3) and (b) bfloat16 (tc) with
    dropout 0.1 against tp=1 in one process; (c) MoE-BERT bf16 at tp=2 x
    ep=2; (d) ZeRO-1 with rules and Adam-mini at dp=2 x tp=2, and its
    checkpoint restored in one process."""
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.examples.common import spawn_ranks

    legs = _mp_legs()
    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR)
    for world in (2, 4):
        names = [n for n, leg in legs.items() if leg["world"] == world]
        refs = {n: _mp_reference(n, legs[n]) for n in names}
        t0 = time.perf_counter()
        spawn_ranks("chip_smoke", ["--mp-rank", MP_DIR, str(world)], world, "cuda",
                    deadline_s=900)
        took = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(MP_DIR, f"rank{r}.pt")) for r in range(world)]
        for n in names:
            _mp_check(n, legs[n], refs[n], ranks)
        print(f"[mp] the {world} ranks took {took:.1f} s, process start included")
        if world == 4:
            print(f"[mp] gloo on a new_group subgroup with CUDA tensors (asked directly): "
                  f"{ranks[0]['gloo_subgroups']}")
            check(all(v == "runs" for v in ranks[0]["gloo_subgroups"].values()),
                  f"mp: gloo refused a subgroup collective: {ranks[0]['gloo_subgroups']}")
            # (d) the tp=2 x dp=2 checkpoint restores in one process, bitwise
            est = _bert_mp_estimator(model_dir=os.path.join(MP_DIR, "ckpt_zero1"),
                                     **dict(legs["zero1"], rules=None, zero1=False))
            restored = ckpt_lib.flatten(est._init_state())
            gathered = ranks[0]["zero1"]["gathered"]
            same = [k for k in gathered if k in restored and (
                torch.equal(restored[k].cpu(), gathered[k])
                if isinstance(gathered[k], torch.Tensor) else restored[k] == gathered[k])]
            check(len(same) == len(gathered) == len(restored),
                  f"mp (d): {len(gathered) - len(same)} of {len(gathered)} leaves of the "
                  f"restored checkpoint differ from the gathered state")
            print(f"[mp] (d) the checkpoint written at dp=2 x tp=2 (ZeRO-1, Adam-mini) restored "
                  f"in one process: {len(same)} leaves bitwise equal to the gathered state")
            del est
            _release()


# --------------------------------------------------------------------------
# phase 23: sequence and pipeline parallelism, and long context
# --------------------------------------------------------------------------

SPPP_DIR = os.path.join(ROOT, "build", "chip_smoke_sp_pp")
SPPP_UPDATES = 2
SP_SEQ, PP_SEQ = 512, 128  # sequence-parallel legs at seq 512, pipeline legs at 128
PP_POISON = (0, 1)  # (update, micro-batch) whose stage-0 output is NaN on pipe rank 0
LONG_SEQS = (512, 2048, 8192)  # bench_longcontext at 16384 tokens per step
LONG_SHAPES = [(32, H, 512, D), (8, H, 2048, D), (2, H, 8192, D)]
LONG_CHECK = (8, H, 2048, D)  # the kernels also with dropout against their plain versions
SPPP_LR = 1.0  # SGD: each parameter moves by its clipped gradient
SPPP_DELTA_RTOL = 1e-3  # each tensor's move against one process's, relative in norm
SPPP_MOVE_FLOOR = 1e-6  # ... plus this share of the whole move, in norm: the floor of a
# tensor whose gradient is zero but for rounding (the key bias: softmax ignores it)


def _sppp_legs():
    """The legs of phase 23 by name: ranks, mesh axes and the run."""
    return {
        "sp_ring": dict(world=2, axes=[("data", 1), ("seq", 2)], core="ring", seq=SP_SEQ),
        "sp_ulysses": dict(world=2, axes=[("data", 1), ("seq", 2)], core="ulysses",
                           seq=SP_SEQ),
        "pp": dict(world=2, axes=[("pipe", 2), ("data", 1)], seq=PP_SEQ, guard=True),
        "dp_pp": dict(world=4, axes=[("pipe", 2), ("data", 2)], seq=PP_SEQ),
    }


def _sppp_predicted_calls(name):
    """The collectives of one update the design predicts (PERF.md, phase
    23): the ring one ppermute per hop per layer forward and one back, the
    Ulysses core two all-to-alls forward, two back and a mask all-gather per
    layer, the [CLS] readout's sum per micro-batch, and ONE gradient
    all-reduce per update over data and seq (data=1: over seq); the
    pipeline 2 (K + P - 2) ppermutes, one all-reduce on pipe, one on data
    with a data axis, and under the guard two MIN all-reduces."""
    L = LAYERS
    if name == "sp_ring":
        return {"seq/ppermute": K * 2 * L, "seq/all_reduce": K + 1}
    if name == "sp_ulysses":
        return {"seq/all_to_all": K * 4 * L, "seq/all_gather": K * L, "seq/all_reduce": K + 1}
    if name == "pp":
        return {"pipe/ppermute": 2 * K, "pipe/all_reduce": 1, "pipe/pmin": 2}
    return {"pipe/ppermute": 2 * K, "pipe/all_reduce": 1, "data/all_reduce": 1}


def _sppp_cfg():
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig

    return BertConfig.small(dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0)


def _sppp_opt():
    """SGD at SPPP_LR: the move is the gradient itself (Adam would divide out
    a gradient off by a constant factor, such as a head summed over seq)."""
    from gradaccum_tpu_torch.ops.adamw import sgd

    return sgd(SPPP_LR)


def _sppp_estimator(leg=None, mesh=None, model_dir=None, poison_rank=False):
    """BERT-Small float32, dropout 0, micro 8 x K=4, through the Estimator:
    with ``leg`` on its mesh (the sequence-parallel model and its dense
    twin, or the pipeline of two stages), else the one-process run; the
    guarded legs skip non-finite micro-batches. ``poison_rank``: this
    rank's stage output of micro-batch ``PP_POISON`` is NaN."""
    import torch

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import bert_classifier_bundle
    from gradaccum_tpu_torch.models.bert_pp import bert_pipeline_spec
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.parallel.ring_attention import make_ring_attention_fn
    from gradaccum_tpu_torch.parallel.ulysses import make_ulysses_attention_fn

    leg = leg or {}
    cfg = _sppp_cfg()
    bundle = bert_classifier_bundle(cfg)
    kw = {}
    if "core" in leg:
        core = make_ring_attention_fn() if leg["core"] == "ring" else make_ulysses_attention_fn()
        kw["eval_model"] = bundle
        bundle = bert_classifier_bundle(cfg, attention_fn=core, seq_axis="seq")
    elif "pipe" in dict(leg.get("axes", ())):
        spec = bert_pipeline_spec(cfg, 2)
        if poison_rank:
            calls = []
            ticks = K + 2 - 1

            def stage_fn(params, x, ctx, inner=spec.stage_fn):
                # rank 0 holds micro-batch t at tick t; a select, so the NaN
                # takes no gradient back into the stage (as an overflow the
                # next stage's guard catches)
                y = inner(params, x, ctx)
                update, micro = divmod(len(calls), ticks)
                calls.append(1)
                hit = torch.tensor((update, micro) == PP_POISON, device=y.device)
                return torch.where(hit, torch.full_like(y, float("nan")), y)

            spec = spec._replace(stage_fn=stage_fn)
        kw["pipeline"] = spec
    elif leg.get("guard"):  # the one-process twin of the guarded pipeline leg
        base = bundle
        bundle = base._replace(loss=lambda m, b: base.loss(m, b) + b["poison"].sum() * 0)
    return Estimator(bundle, _sppp_opt(),
                     GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False,
                                     skip_nonfinite=bool(leg.get("guard"))),
                     RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None,
                               model_dir=model_dir),
                     mode="scan", device="cuda", mesh=mesh, **kw)


def _sppp_batches(leg, poisoned=False):
    """The leg's host batches (K x micro rows of its length); ``poisoned``
    adds the float column whose NaN marks micro-batch ``PP_POISON`` for the
    one-process twin of the guarded leg."""
    import numpy as np

    rows = K * B * dict(leg["axes"]).get("data", 1)
    batches = _host_batches(SPPP_UPDATES, rows, seed=71, seq=leg["seq"])
    if poisoned:
        for u, batch in enumerate(batches):
            poison = np.zeros((rows, 1), np.float32)
            if u == PP_POISON[0]:
                micro = rows // K
                poison[PP_POISON[1] * micro] = np.nan
            batch["poison"] = poison
    return batches


def _sppp_run(est, batches, mesh=None):
    """Train one update per batch: losses, skip counts, each update's
    collectives, and (one process: ``mesh`` None) the initial parameters."""
    losses, calls, skipped = [], [], []
    est.train([], final_save=False)
    init = None if mesh is not None else {
        k: v.detach().float().cpu().clone() for k, v in est._state.params.items()}
    inner = est._train_step

    def step(state, batch, *rng):
        state, aux = inner(state, batch, *rng)
        skipped.append(int(aux.get("skipped", 0)))
        return state, aux

    est._train_step = step
    for batch in batches:
        if mesh is not None:
            mesh.reset_calls()
        est.train([batch], final_save=False)
        losses.append(float(est.last_loss))
        if mesh is not None:
            calls.append({k: v for k, v in mesh.calls.items() if ":" not in k})
    return losses, calls, skipped, init


def _sppp_rank(outdir, world):
    """One rank of phase 23: gloo on the shared card; every leg of
    ``world`` ranks, then the collectives probed on its meshes."""
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    os.environ["GRADACCUM_EVENTS"] = "0"  # (c)'s checkpoints: no TensorBoard import
    mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    out = {}
    try:
        for name, leg in _sppp_legs().items():
            if leg["world"] != int(world):
                continue
            mesh = mesh_lib.make_mesh(leg["axes"])
            model_dir = os.path.join(outdir, f"ckpt_{name}") if leg.get("guard") else None
            est = _sppp_estimator(leg, mesh, model_dir,
                                  poison_rank=leg.get("guard") and mesh.coords["pipe"] == 0)
            t0 = time.perf_counter()
            losses, calls, skipped, _ = _sppp_run(est, _sppp_batches(leg), mesh)
            res = {"losses": losses, "calls": calls, "skipped": skipped,
                   "seconds": time.perf_counter() - t0,
                   "peak_MiB": torch.cuda.max_memory_allocated() / 2**20}
            whole = est._global_state(est._state)  # every rank gathers
            params = whole.params
            if est.pipeline is not None:
                params = est.pipeline.merge(params)
            if mesh.rank == 0:
                res["params"] = {k: v.detach().float().cpu() for k, v in params.items()}
                if model_dir:
                    res["gathered"] = {k: v.detach().cpu() for k, v in
                                       ckpt_lib.flatten(whole).items()
                                       if isinstance(v, torch.Tensor)}
            if model_dir:
                est._save(est._state)  # the whole state: every rank gathers, rank 0 writes
                est._ckpt_sync()
            for axis in mesh.axis_names:
                if mesh.shape[axis] > 1:
                    m = mesh.axis(axis)
                    for dtype in (torch.float32, torch.bfloat16):
                        for op, fn in _collective_probes(m, dtype).items():
                            key = f"{axis}:{op}:{str(dtype)[6:]}"
                            try:
                                res.setdefault("probes", {})[key] = fn() or "values right"
                            except (RuntimeError, ValueError) as e:
                                res.setdefault("probes", {})[key] = \
                                    f"refused: {str(e).splitlines()[0][:100]}"
            out[name] = res
            del est, whole, params
            _release()
        torch.save(out, os.path.join(outdir, f"rank{mesh_lib.current_mesh().rank}.pt"))
        rank = mesh_lib.current_mesh().rank
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _p2p_rank(outdir):
    """One rank of the point-to-point probe: gloo's send/recv of a CUDA
    tensor, the values received written down."""
    import torch
    import torch.distributed as dist

    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=30)
    try:
        rank = dist.get_rank()
        x = torch.arange(8, dtype=torch.float32, device="cuda") + 1
        if rank == 0:
            dist.send(x, 1)
        else:
            got = torch.zeros_like(x)
            dist.recv(got, 0)
            torch.cuda.synchronize()
            found = "values right" if torch.equal(got, x) else \
                f"wrong values {got.tolist()}"
            with open(os.path.join(outdir, "p2p.json"), "w") as f:
                json.dump({"send_recv": found}, f)
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _probe_p2p():
    """gloo's send/recv on CUDA tensors, in two ranks of their own: a
    finding, not a gate (the port's ppermute runs on the all-to-all). A
    crash or a hang of the pair is the finding too."""
    from gradaccum_tpu_torch.examples.common import spawn_ranks

    d = os.path.join(SPPP_DIR, "p2p")
    os.makedirs(d, exist_ok=True)
    try:
        spawn_ranks("chip_smoke", ["--p2p-rank", d], 2, "cuda", deadline_s=90)
    except RuntimeError as e:  # the probe's own finding: the ranks failed
        return f"the ranks failed: {e}"
    with open(os.path.join(d, "p2p.json")) as f:
        return json.load(f)["send_recv"]


def _sppp_check(name, leg, ref, ranks):
    """Hold each rank of leg ``name`` against the one-process run."""
    rtol, atol = MP_PARAM_TOL
    want_calls = _sppp_predicted_calls(name)
    for r, out in enumerate(ranks):
        res = out[name]
        gaps = [abs(a - b) / abs(b) for a, b in zip(res["losses"], ref["losses"])]
        check(len(gaps) == SPPP_UPDATES and max(gaps) <= MP_LOSS_RTOL,
              f"sp/pp {name} rank {r}: losses {res['losses']} against {ref['losses']}")
        for u, calls in enumerate(res["calls"]):
            check(calls == want_calls, f"sp/pp {name} rank {r} update {u}: collectives "
                                       f"{calls}, the design predicts {want_calls}")
        if leg.get("guard"):
            want_skips = [1 if u == PP_POISON[0] else 0 for u in range(SPPP_UPDATES)]
            check(res["skipped"] == want_skips == ref["skipped"],
                  f"sp/pp {name} rank {r}: skipped {res['skipped']} (one process "
                  f"{ref['skipped']}), wanted {want_skips}")
        bad = {k: v for k, v in res["probes"].items() if v != "values right"}
        check(not bad, f"sp/pp {name} rank {r}: collectives on CUDA tensors: {bad}")
        print(f"[sp/pp] {name} rank {r}/{leg['world']} {dict(leg['axes'])}, seq "
              f"{leg['seq']}, float32, dropout 0, {SPPP_UPDATES} updates: losses "
              f"{res['losses']} against {ref['losses']} one process (max relative gap "
              f"{max(gaps):.2e}, limit {MP_LOSS_RTOL:g}); skipped per update "
              f"{res['skipped']}; collectives per update {res['calls'][0]}; peak "
              f"{res['peak_MiB']:.0f} MiB on the card (all ranks' processes); "
              f"{res['seconds']:.2f} s against {ref['seconds']:.2f} s one process; "
              f"probes {res['probes']}")
    params = ranks[0][name]["params"]
    moves = {k: want - ref["init"][k] for k, want in ref["params"].items()}
    whole = sum(float(m.norm()) ** 2 for m in moves.values()) ** 0.5
    worst, worst_move = 0.0, 0.0
    for k, want in ref["params"].items():
        err = (params[k] - want).abs()
        worst = max(worst, float(err.max()))
        check(bool((err <= atol + rtol * want.abs()).all()),
              f"sp/pp {name}: parameter {k} off the one-process run by {float(err.max()):.3e}")
        # the move itself, which the parameters' own size hides: a gradient
        # off by a factor (a head summed n_seq times) moves a tensor that far
        move = float(moves[k].norm())
        gap = float((params[k] - ref["init"][k] - moves[k]).norm())
        check(gap <= SPPP_DELTA_RTOL * move + SPPP_MOVE_FLOOR * whole,
              f"sp/pp {name}: parameter {k} moved {gap:.3e} (in norm) off the one-process "
              f"run's move of {move:.3e} (whole move {whole:.4f})")
        if move > SPPP_MOVE_FLOOR * whole:
            worst_move = max(worst_move, gap / move)
    print(f"[sp/pp] {name}: every parameter within atol {atol:g} + rtol {rtol:g} of the "
          f"one-process run (max |err| {worst:.3e}); each tensor's move within "
          f"{SPPP_DELTA_RTOL:g} of its one-process move in norm, plus {SPPP_MOVE_FLOOR:g} of "
          f"the whole move {whole:.4f} (SGD lr {SPPP_LR:g}, clip 1; worst relative gap "
          f"{worst_move:.3e} among tensors that moved more than that)")


def _sppp_reference(name, leg):
    """The leg in one process on the same global batches."""
    import torch

    est = _sppp_estimator(dict(guard=True) if leg.get("guard") else None)
    t0 = time.perf_counter()
    losses, _, skipped, init = _sppp_run(
        est, _sppp_batches(leg, poisoned=leg.get("guard", False)))
    torch.cuda.synchronize()
    ref = {"losses": losses, "skipped": skipped, "seconds": time.perf_counter() - t0,
           "params": {k: v.detach().float().cpu() for k, v in est._state.params.items()},
           "init": init}
    del est
    _release()
    return ref


def _sppp_restore_check(ranks):
    """(c)'s checkpoint, written at pipe=2, restored in one process into
    the whole pipeline state: every leaf bitwise the gathered one."""
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.models.bert import bert_classifier_bundle
    from gradaccum_tpu_torch.models.bert_pp import bert_pp_partition
    from gradaccum_tpu_torch.parallel.pp import pp_init
    from gradaccum_tpu_torch.utils.tree import named_parameters

    dense = named_parameters(bert_classifier_bundle(_sppp_cfg()).init(RunConfig().seed, "cuda"))
    pre, stages, post = bert_pp_partition(dense, 2)
    template = pp_init(stages, _sppp_opt(), pre_params=pre, post_params=post)
    restored = ckpt_lib.flatten(ckpt_lib.restore(os.path.join(SPPP_DIR, "ckpt_pp"), template))
    gathered = ranks[0]["pp"]["gathered"]
    same = [k for k in gathered if k in restored and torch.equal(restored[k].cpu(), gathered[k])]
    check(len(same) == len(gathered),
          f"sp/pp (c): {len(gathered) - len(same)} of {len(gathered)} leaves of the restored "
          f"checkpoint differ from the gathered state")
    print(f"[sp/pp] (c) the checkpoint written at pipe=2 restored in one process: "
          f"{len(same)} leaves bitwise equal to the gathered state")
    del template, restored
    _release()


def _longctx_timing(path):
    """Each kernel timed at LONG_SHAPES (dropout 0, the bench's conditions)
    beside its bound, plain version and SDPA, in a process of its own:
    late in the whole script, profiler windows at these shapes lose device
    events. Writes phase_timing's tuples to ``path`` as JSON."""
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device", file=sys.stderr)
        return 2
    try:
        timing = {"x".join(map(str, shape)): phase_timing(shape, masked=True,
                                                           label="longctx", rate=0.0)
                  for shape in LONG_SHAPES}
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    with open(path, "w") as f:
        json.dump(timing, f)
    return 0


def _longcontext():
    """(e) ``bench_longcontext`` on the card: its rows at LONG_SEQS, the
    flash leg's launches, and each kernel against its plain version at
    every shape of LONG_SHAPES (dropout 0, and dropout RATE at LONG_CHECK);
    then each kernel timed at LONG_SHAPES in a process of its own
    (``_longctx_timing``)."""
    import ast
    import csv

    import torch

    from gradaccum_tpu_torch.examples import bench_longcontext as bench
    from gradaccum_tpu_torch.ops import flash_attention as fa

    worst = {}
    for shape, rate in [(shape, 0.0) for shape in LONG_SHAPES] + [(LONG_CHECK, RATE)]:
        _check_kernels(fa, torch.bfloat16, shape, True, False, rate, worst, tag="longctx")
        _release()
    out = os.path.join(SPPP_DIR, "longcontext.csv")
    t0 = time.perf_counter()
    bench.main(["--seqs", *map(str, LONG_SEQS), "--iters", "5", "--remat-legs", "none",
                "--out", out])
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    print(f"[longctx] bench_longcontext took {time.perf_counter() - t0:.1f} s")
    launches = {}
    for row in rows:
        print(f"[longctx] {row['core']:8s} seq {row['seq']:>5s} micro {row['micro_batch']:>2s}: "
              f"{row['ms_per_step']} ms/step, {row['tokens_per_sec']} tokens/s, peak "
              f"{row['peak_temp_mb']} MiB above the state ({row['device']})"
              + (f", error {row['error']}" if row["error"] else ""))
        check(not (row["core"] != "dense" and row["error"]),
              f"longctx: the {row['core']} leg at seq {row['seq']} failed: {row['error']}")
        if row["core"] == "flash":
            per_step = ast.literal_eval(row["launches_per_step"])
            launches[int(row["seq"])] = per_step
            check(per_step == {name: LAYERS for name in REPLACES},
                  f"longctx: flash leg at seq {row['seq']} launched {per_step} per step, "
                  f"wanted {LAYERS} of each")
    path = os.path.join(SPPP_DIR, "longctx_timing.json")
    sys.stdout.flush()  # the timing process prints after what this one printed
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--longctx-timing", path],
                        cwd=ROOT, timeout=600).returncode
    check(rc == 0, f"longctx: the kernel timing process exited {rc}")
    with open(path) as f:
        timed = json.load(f)
    timing = {shape: timed["x".join(map(str, shape))] for shape in LONG_SHAPES}
    return {"rows": rows, "launches": launches, "timing": timing, "worst": worst}


def _in_background(fn):
    """Run ``fn`` in a thread; returns the function that waits for it and
    gives its result (or raises its exception)."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by the waiter
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return wait


def phase_sp_pp():
    """Sequence and pipeline parallelism on the one card, ranks sharing it
    over gloo: (a) sp=2 ring and (b) Ulysses, BERT-Small float32 at seq
    512; (c) pipe=2 with the guard and a micro-batch poisoned on one rank,
    and its checkpoint restored in one process; (d) data=2 x pipe=2; each
    against one process. Then the point-to-point probe and (e) the
    long-context bench with the flash kernels."""
    import torch

    from gradaccum_tpu_torch.examples.common import spawn_ranks

    t_phase = time.perf_counter()
    legs = _sppp_legs()
    shutil.rmtree(SPPP_DIR, ignore_errors=True)
    os.makedirs(SPPP_DIR)
    # the probe and each spawn of ranks start their processes while this
    # one runs the references: the legs' numbers do not depend on it, their
    # printed seconds do
    p2p = _in_background(_probe_p2p)
    for world in (2, 4):
        names = [n for n, leg in legs.items() if leg["world"] == world]
        t0 = time.perf_counter()
        spawned = _in_background(lambda w=world: spawn_ranks(
            "chip_smoke", ["--sppp-rank", SPPP_DIR, str(w)], w, "cuda", deadline_s=900))
        refs = {n: _sppp_reference(n, legs[n]) for n in names}
        spawned()
        took = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(SPPP_DIR, f"rank{r}.pt")) for r in range(world)]
        for n in names:
            _sppp_check(n, legs[n], refs[n], ranks)
        print(f"[sp/pp] the {world} ranks and their references took {took:.1f} s, process "
              f"start included")
        if world == 2:
            _sppp_restore_check(ranks)
    print(f"[sp/pp] gloo send/recv of a CUDA tensor (two ranks of their own): {p2p()}")
    long = _longcontext()
    print(f"[sp/pp] phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return long


# --------------------------------------------------------------------------
# phase 20: resilience and observability on the card
# --------------------------------------------------------------------------

RES_DIR = os.path.join(ROOT, "build", "chip_smoke_resilience")
RES_STEPS = 16  # micro-steps of the streaming runs: 4 windows of K=4
RES_SAVE = 3  # checkpoint cadence: never a window boundary (K=4)
COST_UPDATES = 3  # updates of each leg of (f)


def _res_estimator(model_dir, mode="streaming", **run):
    """BERT-Small bf16, dropout 0.1, micro 8 x K=4, on the flash kernels,
    checkpointing into ``model_dir`` every RES_SAVE micro-steps."""
    run = dict(dict(model_dir=model_dir, save_checkpoints_steps=RES_SAVE,
                    keep_checkpoint_max=5), **run)
    return _bert_dp_estimator(mode=mode, lr=2e-5, **run)


def _res_batches(n, rows=8):
    return _host_batches(n, rows, seed=31)


def _flat_equal(fa, fb):
    """The first leaf of two flat states (``checkpoint.flatten``, or a
    checkpoint's payload) that differs, else None."""
    import torch

    if fa.keys() != fb.keys():
        return f"leaves {sorted(fa.keys() ^ fb.keys())[:3]}"
    for key in fa:
        x, y = fa[key], fb[key]
        if isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                return key
        elif x != y:
            return key
    return None


def _losses(model_dir):
    with open(os.path.join(model_dir, "loss_vs_step.csv")) as f:
        next(f)
        return dict(line.strip().split(",") for line in f)


def _res_crash_resume():
    """(a) crash inside a window, resume from a mid-window checkpoint with
    the async writer, bitwise against the uninterrupted run; (b) a flipped
    byte in the newest checkpoint is caught and the previous one restored."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.obs import flight, trace
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.resilience import faults

    batches = _res_batches(RES_STEPS)
    ref_dir, crash_dir = (os.path.join(RES_DIR, d) for d in ("ref", "crash"))
    tracer = trace.Tracer(capacity=None)
    with trace.installed(tracer):  # the reference needs its final state only
        est = _res_estimator(ref_dir, async_checkpoint=True, save_checkpoints_steps=None)
        ref = est.train(batches, max_steps=RES_STEPS)
    branches = [e["args"]["branch"] for e in tracer.snapshot() if e["name"] == "train/step"]
    # no first-step quirk: the window applies at step % K == K - 1
    want = (["accumulate"] * (K - 1) + ["apply"]) * (RES_STEPS // K)
    check(branches == want, f"resilience (a): train/step labels {branches}")
    ref_flat = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in ckpt_lib.flatten(ref).items()}
    del est, ref
    _release()

    crash_at = int(np.random.default_rng(0xC0FFEE).integers(7, 12))
    check(crash_at % K != 0, f"resilience (a): crash step {crash_at} on a window edge")
    inj = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(
        faults.POST_TRAIN_STEP, at=crash_at)]))
    est = _res_estimator(crash_dir, async_checkpoint=True)
    crashed = False
    with trace.installed(trace.Tracer()), faults.installed(inj):
        try:
            est.train(batches, max_steps=RES_STEPS)
        except faults.InjectedCrash:
            crashed = True
    check(crashed and inj.fired == [(faults.POST_TRAIN_STEP, crash_at, "crash")],
          f"resilience (a): the crash did not fire ({inj.fired})")
    check(est._res.async_ckpt is None, "resilience (a): the crash left the writer open")
    dumps = flight.list_dumps(crash_dir)
    seen = flight.fault_events(flight.load_dump(dumps[-1])["events"]) if dumps else []
    check(seen == inj.fired, f"resilience (a): flight dump faults {seen} != {inj.fired}")
    del est
    _release()
    ckpt_step = ckpt_lib.latest_checkpoint(crash_dir)[0]
    check(0 < ckpt_step < crash_at and ckpt_step % K, f"resilience (a): resumed from "
          f"step {ckpt_step}, not inside a window before the crash at {crash_at}")
    est = _res_estimator(crash_dir, async_checkpoint=True)
    fa.reset_launch_counts()
    resumed = est.train(batches[ckpt_step:], max_steps=RES_STEPS)
    counts = fa.launch_counts()
    want_counts = {n: LAYERS * (RES_STEPS - ckpt_step) for n in REPLACES}
    check(counts == want_counts, f"resilience (a): launches {counts} != {want_counts}")
    diff = _flat_equal(ref_flat, ckpt_lib.flatten(resumed))
    check(diff is None, f"resilience (a): the resumed state differs from the "
          f"uninterrupted run at {diff}")
    loss_ref, loss_res = _losses(ref_dir), _losses(crash_dir)
    after = sorted(int(s) for s in loss_res if int(s) > ckpt_step)
    check(after and all(loss_res[str(s)] == loss_ref[str(s)] for s in after),
          "resilience (a): post-resume losses differ from the uninterrupted run")
    print(f"[resilience] (a) BERT-Small bf16 streaming, micro 8 x K={K}, dropout 0.1, async "
          f"checkpoints every {RES_SAVE} micro-steps: crash at micro-step {crash_at} "
          f"(seeded), resumed in a fresh Estimator from the mid-window checkpoint at "
          f"{ckpt_step}; parameters, m, v, accumulators, good count and step bitwise equal "
          f"to the uninterrupted run after {RES_STEPS} micro-steps, {len(after)} "
          f"post-resume losses bitwise equal; flight dump holds {seen}; launches after "
          f"the resume {counts}; train/step labels {branches[:K]} per window")

    # (b) one flipped byte in the newest checkpoint
    (prev_step, prev_path), (new_step, new_path) = ckpt_lib.all_checkpoints(crash_dir)[-2:]
    data = bytearray(open(new_path, "rb").read())
    data[len(data) // 2] ^= 0x01
    with open(new_path, "wb") as f:
        f.write(bytes(data))
    want = torch.load(prev_path, map_location="cpu", weights_only=True)
    restored = ckpt_lib.restore(crash_dir, resumed)
    diff = _flat_equal(want, ckpt_lib.flatten(restored))
    check(diff is None and os.path.exists(new_path + ".corrupt")
          and not os.path.exists(new_path),
          f"resilience (b): restore after a bit flip in ckpt-{new_step} differs from "
          f"ckpt-{prev_step} at {diff}, or the file was not quarantined")
    print(f"[resilience] (b) one byte flipped in ckpt-{new_step}.pt: the manifest's sha256 "
          f"caught it, the file was quarantined as .corrupt, and the restore equals "
          f"ckpt-{prev_step}.pt exactly")
    del est, resumed, restored
    _release()
    return ref_flat


def _res_sigterm(ref_flat):
    """(c) the process sends itself SIGTERM mid-train: the final checkpoint
    lands at that micro-step with the async writer drained, and the resume
    is bitwise."""
    import signal

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.resilience import manifest, preemption

    batches = _res_batches(RES_STEPS)
    d = os.path.join(RES_DIR, "sigterm")
    sig_at = 9

    def stream():
        for i, b in enumerate(batches):
            if i == sig_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    # no periodic saves: the drain's own checkpoint is the one resumed from
    est = _res_estimator(d, async_checkpoint=True, save_checkpoints_steps=None)
    with preemption.PreemptionHandler():
        state = est.train(stream(), max_steps=RES_STEPS)
    stopped = est.drained_at_step
    newest = ckpt_lib.latest_checkpoint(d)
    check(stopped == state.step == sig_at + 1 and newest[0] == stopped
          and manifest.verify(d, newest[1]) is True and not preemption.requested(),
          f"resilience (c): drained at {stopped} (state {state.step}), newest checkpoint "
          f"{newest}, signal at batch {sig_at}")
    del est, state
    _release()
    resumed = _res_estimator(d, async_checkpoint=True, save_checkpoints_steps=None).train(
        batches[stopped:], max_steps=RES_STEPS)
    diff = _flat_equal(ref_flat, ckpt_lib.flatten(resumed))
    check(diff is None, f"resilience (c): the resume after SIGTERM differs at {diff}")
    print(f"[resilience] (c) SIGTERM sent while batch {sig_at} was read: the loop stopped "
          f"at micro-step {stopped}, the async writer drained and ckpt-{stopped}.pt "
          f"verifies against the manifest before train() returned; the resume to "
          f"{RES_STEPS} is bitwise equal to the uninterrupted run")
    del resumed
    _release()


DRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_drain")
DRAIN_UPDATES = 4  # host steps offered to each rank (scan, K micro-batches each)


def _drain_rank(outdir):
    """One rank of phase 20 (d): explicit DP over gloo on the shared card,
    the drain agreed over the c10d store; rank 1 alone is preempted."""
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.resilience.preemption import DrainConsensus

    fa.build_kernels()  # the parent built them: loads the libraries
    mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    try:
        mesh = mesh_lib.data_parallel_mesh()
        consensus = DrainConsensus(timeout_ms=60_000)
        est = _bert_dp_estimator(mesh=mesh, dropout=0.1, lr=2e-5,
                                 model_dir=os.path.join(outdir, "ckpt"),
                                 drain_consensus=consensus)
        batches = _host_batches(DRAIN_UPDATES, DP_MICRO_B * mesh.world * K, seed=41)

        def stream():
            for i, b in enumerate(batches):
                if mesh.rank == 1 and i == 1:
                    consensus.request()  # this rank alone sees the preemption
                yield b

        state = est.train(stream())
        out = {"rank": mesh.rank, "drained_at_step": est.drained_at_step, "step": state.step,
               "multiprocess": consensus.multiprocess, "rounds": consensus._round}
        with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
        rank = mesh.rank
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _start_drain_ranks():
    """(d), started: two gloo ranks on the card through the launcher, in a
    thread, so that they run while the parent's legs (a)-(c) and (e) do."""
    import threading

    from gradaccum_tpu_torch.examples.common import spawn_ranks

    shutil.rmtree(DRAIN_DIR, ignore_errors=True)
    os.makedirs(DRAIN_DIR)
    job = {"t0": time.perf_counter()}

    def run():
        try:
            spawn_ranks("chip_smoke", ["--drain-rank", DRAIN_DIR], 2, "cuda", deadline_s=600)
        except BaseException as e:  # noqa: BLE001 — reported by _res_drain_ranks
            job["error"] = e
        job["took"] = time.perf_counter() - job["t0"]

    job["thread"] = threading.Thread(target=run, daemon=True)
    job["thread"].start()
    return job


def _res_drain_ranks(job):
    """(d), checked: the drain was agreed over the c10d store and both
    ranks landed the same final step."""
    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib

    job["thread"].join()
    check("error" not in job, f"resilience (d): the ranks failed: {job.get('error')}")
    ranks = []
    for r in range(2):
        with open(os.path.join(DRAIN_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    steps = {r["drained_at_step"] for r in ranks}
    newest = ckpt_lib.latest_checkpoint(os.path.join(DRAIN_DIR, "ckpt"))
    check(len(steps) == 1 and None not in steps and all(r["multiprocess"] for r in ranks)
          and 0 < ranks[0]["drained_at_step"] < DRAIN_UPDATES * K
          and newest is not None and newest[0] == ranks[0]["drained_at_step"],
          f"resilience (d): ranks {ranks}, newest checkpoint {newest}")
    print(f"[resilience] (d) two gloo ranks sharing the card, explicit DP, BERT-Small bf16 "
          f"micro {DP_MICRO_B} per rank x K={K}: rank 1 alone preempted while reading its "
          f"second host batch; DrainConsensus over the c10d store stopped both ranks at "
          f"micro-step {ranks[0]['drained_at_step']} ({ranks[0]['rounds']} store rounds), "
          f"the final checkpoint is ckpt-{newest[0]}.pt; {job['took']:.1f} s with process "
          f"start, beside legs (a)-(c) and (e)")


def _trace_kernels(path):
    """``{kernel name: count}`` of the card's kernel events in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _res_profiler():
    """(e) a StepWindowProfiler window of 2 updates holds K1-K3 under their
    kernel names; the scan spans carry their label."""
    from gradaccum_tpu_torch.obs import trace

    prof_dir = os.path.join(RES_DIR, "profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    tracer = trace.Tracer(capacity=None)
    est = _bert_dp_estimator(profile_dir=prof_dir, profile_start_step=K,
                             profile_num_steps=2 * K)
    with trace.installed(tracer):
        est.train(_res_batches(4, rows=8 * K))
    files = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    check(files == ["trace-0001.json"], f"resilience (e): profile dir holds {files}")
    kernels = _trace_kernels(os.path.join(prof_dir, files[0]))
    want = {"flash_fwd_tc_kernel": 2 * K * LAYERS, "flash_dq_tc_kernel": 2 * K * LAYERS,
            "flash_dkv_tc_kernel": 2 * K * LAYERS}
    got = {short: sum(c for name, c in kernels.items() if short in name) for short in want}
    check(got == want, f"resilience (e): kernels in the trace {got} != {want}")
    labels = [e["args"]["branch"] for e in tracer.snapshot() if e["name"] == "train/step"]
    check(labels == ["scan-cycle"] * 4, f"resilience (e): span labels {labels}")
    print(f"[resilience] (e) StepWindowProfiler window of 2 updates: {files[0]} holds "
          f"{got} CUDA kernel events (K1-K3 under their names, {len(kernels)} kernel names "
          f"in all); train/step spans {labels}")
    del est
    _release()


def _cost_leg(on: bool):
    """Card-busy ms and seq/s per update of BERT-Small bf16 scan with a
    checkpoint every update: obs and the async writer on, or both off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.obs import trace

    d = os.path.join(RES_DIR, "cost-on" if on else "cost-off")
    shutil.rmtree(d, ignore_errors=True)
    batches = _res_batches(2 * COST_UPDATES + 1, rows=8 * K)
    timed, profiled = batches[1:COST_UPDATES + 1], batches[COST_UPDATES + 1:]
    est = _bert_dp_estimator(model_dir=d, save_checkpoints_steps=K, async_checkpoint=on)
    with trace.installed(trace.Tracer() if on else trace.NULL):
        est.train(batches[:1])  # warm-up: its first step is never timed
        est.train_stats.update(host_steps=0, examples=0, seconds=0.0)
        est.train(timed)
        seq_s = est.examples_per_sec()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            est.train(profiled)
            torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    del est
    _release()
    return busy / len(profiled), seq_s


def _res_cost():
    """(f) the machinery's cost: a finding, not a gate."""
    on_busy, on_seq = _cost_leg(True)
    off_busy, off_seq = _cost_leg(False)
    print(f"[resilience] (f) BERT-Small bf16 scan, micro 8 x K={K}, a checkpoint every "
          f"update: obs + async writer ON {on_busy:.3f} card-busy ms/update, "
          f"{on_seq:.1f} seq/s; OFF (obs off, synchronous saves) {off_busy:.3f} card-busy "
          f"ms/update, {off_seq:.1f} seq/s")
    return {"on": [on_busy, on_seq], "off": [off_busy, off_seq]}


def phase_resilience():
    """Phase 20: crash and resume, corruption, SIGTERM, the drain across
    ranks (its two processes run beside the other legs), the profiler
    window and spans, then the cost of the machinery, alone on the card."""
    t0 = time.perf_counter()
    shutil.rmtree(RES_DIR, ignore_errors=True)
    os.makedirs(RES_DIR)
    drain = _start_drain_ranks()
    try:
        ref_flat = _res_crash_resume()
        _res_sigterm(ref_flat)
        _res_profiler()
    finally:
        drain["thread"].join()  # the launcher ends its ranks, by its deadline at the latest
    _res_drain_ranks(drain)
    cost = _res_cost()
    print(f"[resilience] phase 20 took {time.perf_counter() - t0:.1f} s")
    return cost


# --------------------------------------------------------------------------
# phase 21: export, and the native reader
# --------------------------------------------------------------------------

EXPORT_DIR = os.path.join(ROOT, "build", "chip_smoke_export")
EXPORT_TOL = {"float32": 1e-6, "bfloat16": 1e-2}  # loaded artifact against predict

# a fresh process that imports only the export module: loads every artifact,
# calls it at each batch, counts the flash forward launches (the wrapper's
# count, per route, and the profiler's kernel events) and the port's modules
_LOADER = r"""
import json, os, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from gradaccum_tpu_torch.estimator.export import load_exported
root = sys.argv[1]
report = {}
for name in sorted(os.listdir(root)):
    d = os.path.join(root, name)
    if not os.path.exists(os.path.join(d, "model.pt2")):
        continue
    fn = load_exported(d)
    fa = sys.modules["gradaccum_tpu_torch.ops.flash_attention"]  # imported by load_exported
    outs = {}
    fa.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for rows in (8, 3):
            batch = dict(np.load(os.path.join(d, f"batch{rows}.npz")))
            out = fn(batch)
            for key, v in out.items():
                outs[f"{key}{rows}"] = v.float().cpu().numpy()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "flash_fwd" in e.key)
    np.savez(os.path.join(d, "loaded.npz"), **outs)
    report[name] = {"routes": fa.route_counts()["flash_fwd"], "kernel_events": kernels}
report["modules"] = sorted(m for m in sys.modules if m.startswith("gradaccum_tpu_torch"))
print(json.dumps(report))
"""


def _export_bert(dtype_name):
    """BERT-Small (random weights from the run seed) exported from one row."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention

    d = os.path.join(EXPORT_DIR, f"bert_{dtype_name}")
    cfg = BertConfig.small(dtype=getattr(torch, dtype_name))
    est = Estimator(bert_classifier_bundle(cfg, attention_fn=flash_attention), adamw(2e-5),
                    GradAccumConfig(K), RunConfig(), mode="scan", device="cuda")
    strip = lambda b: {k: v for k, v in b.items() if k != "label"}  # noqa: E731
    t0 = time.perf_counter()
    est.export_model(d, strip(_bert_small_batches(1, seed=51)))
    took = time.perf_counter() - t0
    want = {}
    for rows in (8, 3):
        batch = strip(_bert_small_batches(rows, seed=52 + rows))
        np.savez(os.path.join(d, f"batch{rows}.npz"), **batch)
        preds = list(est.predict([batch]))
        for key in preds[0]:
            want[f"{key}{rows}"] = np.stack([p[key] for p in preds]).astype(np.float32)
    del est
    _release()
    return want, took


def _export_entry(name, argv, rebuild):
    """Run an entry point with --export-dir and --model-dir; ``rebuild``
    gives ``(bundle, batches)``: the model the entry trained (its weights
    come from its final checkpoint) and the batches to call."""
    import importlib

    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.utils.tree import named_parameters

    d = os.path.join(EXPORT_DIR, name)
    model_dir = os.path.join(EXPORT_DIR, f"{name}-model")
    module = importlib.import_module(f"gradaccum_tpu_torch.examples.{name}")
    t0 = time.perf_counter()
    out = module.main([*argv, "--export-dir", d, "--model-dir", model_dir])
    took = time.perf_counter() - t0
    check(out["export"] == os.path.join(d, "model.pt2"), f"export: {name} wrote {out}")
    bundle, batches = rebuild()
    model = bundle.init(19830610, "cuda")
    ckpt_lib.restore_params(model_dir, named_parameters(model))
    want = {}
    for rows, batch in batches.items():
        np.savez(os.path.join(d, f"batch{rows}.npz"), **batch)
        with torch.no_grad():
            got = bundle.predict(model, {k: torch.as_tensor(v).cuda() for k, v in batch.items()})
        for key, v in got.items():
            want[f"{key}{rows}"] = v.float().cpu().numpy()
    del model
    _release()
    return want, took


def _gpt_lm_rebuild():
    import numpy as np

    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.ops.flash_attention import causal_flash_attention

    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=4, num_heads=4,
                    max_position_embeddings=64, dropout=0.1)
    rng = np.random.default_rng(61)
    return (gpt_lm_bundle(cfg, attention_fn=causal_flash_attention),
            {rows: {"input_ids": rng.integers(0, 256, size=(rows, 64)).astype(np.int32)}
             for rows in (8, 3)})


def _housing_rebuild():
    import numpy as np

    from gradaccum_tpu_torch.models.housing_mlp import housing_mlp_bundle

    rng = np.random.default_rng(62)
    return housing_mlp_bundle(), {rows: {"x": rng.normal(size=(rows, 14)).astype(np.float32),
                                         "y": np.zeros((rows, 1), np.float32)}
                                  for rows in (8, 3)}


def _native_check():
    """The native reader builds on this machine and gives the numpy
    readers' bytes on a generated idx pair and a numeric CSV."""
    import gzip
    import struct

    import numpy as np

    from gradaccum_tpu_torch.data import csv as csv_lib
    from gradaccum_tpu_torch.data import mnist, native

    check(native.available(), f"export: the native reader did not build: "
          f"{native.build_error}")
    d = os.path.join(EXPORT_DIR, "native")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(63)
    images = rng.integers(0, 256, size=(100, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=100, dtype=np.uint8)
    img, lab, table = (os.path.join(d, n) for n in ("img-idx3.gz", "lab-idx1.gz", "t.csv"))
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">iiii", mnist.IMAGE_MAGIC, 100, 28, 28) + images.tobytes())
    with gzip.open(lab, "wb") as f:
        f.write(struct.pack(">ii", mnist.LABEL_MAGIC, 100) + labels.tobytes())
    with open(table, "w") as f:
        f.write("a,b,c\n" + "".join(",".join(repr(float(v)) for v in row) + "\n"
                                     for row in rng.normal(0, 30, size=(200, 3))))
    fast = (mnist.read_images(img), mnist.read_labels(lab),
            csv_lib.read_csv(table, columns=["a", "b", "c"]))
    get_lib = native.get_lib
    native.get_lib = lambda: None  # the numpy readers
    try:
        slow = (mnist.read_images(img), mnist.read_labels(lab),
                csv_lib.read_csv(table, columns=["a", "b", "c"]))
    finally:
        native.get_lib = get_lib
    same = (fast[0].tobytes() == slow[0].tobytes() and fast[1].tobytes() == slow[1].tobytes()
            and all(fast[2][c].tobytes() == slow[2][c].tobytes() for c in "abc"))
    check(same, "export: the native reader's bytes differ from the numpy readers'")
    print("[export] native reader: built into build/native/ on this machine, available; "
          "idx images/labels (gzip) and a numeric CSV byte-identical to the numpy readers")


def phase_export():
    """Phase 21, started: BERT-Small exported in float32 and bf16, gpt_lm
    and housing through --export-dir, and the loader process started on
    them (it runs beside phase 20); returns what ``phase_export_check``
    holds the loaded artifacts against."""
    t0 = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    want, took = {}, {}
    for dt in ("float32", "bfloat16"):
        want[f"bert_{dt}"], took[f"bert_{dt}"] = _export_bert(dt)
    want["gpt_lm"], took["gpt_lm"] = _export_entry(
        "gpt_lm", ["--flash", "--max-steps", "8", "--sample", "0"], _gpt_lm_rebuild)
    want["housing"], took["housing"] = _export_entry(
        "housing", ["--max-steps", "60"], _housing_rebuild)
    loader = subprocess.Popen([sys.executable, "-c", _LOADER, EXPORT_DIR],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    return {"want": want, "took": took, "loader": loader, "t0": t0,
            "seconds": time.perf_counter() - t0}


def phase_export_check(job):
    """Phase 21, checked: every artifact, loaded in one fresh process that
    imports only the export module, against predict; the flash forward
    launched inside it on the expected route; the native reader; the
    wrapper's wall time per call (measured with the card to itself)."""
    import numpy as np

    from gradaccum_tpu_torch.utils import call_overhead

    t0 = time.perf_counter()
    want, took = job["want"], job["took"]
    try:
        out, err = job["loader"].communicate(timeout=600)
    except subprocess.TimeoutExpired:
        job["loader"].kill()
        raise SmokeError("export: the loader did not finish in 600 s")
    check(job["loader"].returncode == 0, f"export: the loader failed: {err[-3000:]}")
    report = json.loads(out.strip().splitlines()[-1])
    check(not any(".models" in m or ".examples" in m for m in report["modules"]),
          f"export: the loader imported model code: {report['modules']}")
    routes = {"bert_float32": "tf32x3", "bert_bfloat16": "tc", "gpt_lm": "tf32x3",
              "housing": None}
    tol = {"bert_float32": 1e-6, "bert_bfloat16": 1e-2, "gpt_lm": 1e-6, "housing": 1e-6}
    launches = {}
    for name, route in routes.items():
        got = dict(np.load(os.path.join(EXPORT_DIR, name, "loaded.npz")))
        check(got.keys() == want[name].keys(), f"export {name}: outputs {sorted(got)}")
        err = 0.0
        for key, w in want[name].items():
            if key.startswith(("classes", "next_token")):
                check(np.array_equal(got[key], w), f"export {name}: {key} differ")
            else:
                err = max(err, float(np.abs(got[key] - w).max()))
        check(err <= tol[name], f"export {name}: loaded artifact off predict by {err:.3e} "
              f"(limit {tol[name]:g})")
        r = report[name]
        n = sum(r["routes"].values())
        if route is None:
            check(n == 0 and r["kernel_events"] == 0, f"export {name}: launches {r}")
        else:
            check(n > 0 and r["routes"][route] == n and r["kernel_events"] == n,
                  f"export {name}: flash forward launches {r} (route {route})")
        launches[name] = r
        print(f"[export] {name}: exported in {took[name]:.1f} s from a one-row sample; "
              f"loaded in a fresh process (imports {len(report['modules'])} port modules, "
              f"no model code) and called at batch 8 and 3: max |artifact - predict| "
              f"{err:.3e} (limit {tol[name]:g}), classes equal; flash forward launches "
              f"inside the artifact {r['routes']} ({r['kernel_events']} kernel events under "
              f"the profiler)")
    _native_check()
    overhead = call_overhead.measure()
    print(f"[export] flash wrapper wall time per call (bf16 [8, 8, 128, 64], dropout 0.1): "
          f"training forward {overhead['train_forward_ms']:.4f} ms, forward + backward "
          f"{overhead['train_forward_backward_ms']:.4f} ms, inference forward "
          f"{overhead['inference_forward_ms']:.4f} ms, the kernel wrapper alone "
          f"{overhead['kernel_wrapper_ms']:.4f} ms, the operator "
          f"{overhead['operator_ms']:.4f} ms, the same kernel as a custom_op "
          f"{overhead['custom_op_ms']:.4f} ms")
    print(f"[export] phase 21 took {job['seconds'] + time.perf_counter() - t0:.1f} s (the "
          f"loader ran beside phase 20)")
    return launches, overhead


# --------------------------------------------------------------------------
# phase 24: serving (cached and paged decode, the engine, the server)
# --------------------------------------------------------------------------

SERVE_SEED = 24  # the model's weights and the trace
SERVE_TRACE = dict(n_requests=24, arrival_rate=0.5, prompt_len=(16, 256), max_new=(16, 96))
SERVE_SAMPLING = dict(temperature=0.8, top_k=50)
SERVE_PROFILE_TICKS = 4
SERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_serving")


def _serve_model():
    """GPT-Small (vocab 50257, L-4 H-512 A-8, FFN 2048, 512 positions),
    float32, random weights from SERVE_SEED, as the decode tree."""
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    cfg = GPTConfig.small(dropout=0.0)
    return cfg, params_tree(gpt_lm_bundle(cfg).init(SERVE_SEED, "cuda"))


def _first_gap(params, cfg, prompt, got, want):
    """The first position where two streams differ and the top-2 gap of the
    reference's logits there."""
    import torch

    from gradaccum_tpu_torch.models.gpt_decode import prefill

    pos = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    ids = torch.tensor([list(prompt) + list(want[:pos])], device="cuda")
    _, logits = prefill(params, cfg, ids, ids.shape[1])
    top2 = torch.topk(logits[0], 2).values
    return pos, float(top2[0] - top2[1])


def _serve_solo(params, cfg, trace, sampling):
    """Each request of ``trace`` alone through ``generate_cached`` on the card
    (its seed as the key)."""
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached
    from gradaccum_tpu_torch.utils import prng

    return [generate_cached(params, cfg, item.prompt, item.max_new_tokens,
                            rng=prng.PRNGKey(item.rng_seed), **sampling)
            [0, item.prompt.size:].tolist() for item in trace]


def _serve_check(tag, params, cfg, trace, records, wants):
    """Every request's stream against its ``generate_cached`` tokens."""
    for item, rec, want in zip(trace, records, wants):
        check(rec["status"] == "done", f"[serving] {tag}: request {rec['request_id']} "
                                       f"ended {rec['status']}")
        if rec["tokens"] != want:
            pos, gap = _first_gap(params, cfg, item.prompt, rec["tokens"], want)
            raise SmokeError(f"[serving] {tag}: request {rec['request_id']} (prompt "
                             f"{item.prompt.size}, {item.max_new_tokens} new) first differs "
                             f"from generate_cached at token {pos}: {rec['tokens'][pos]} "
                             f"against {want[pos]}, the reference's top-2 logit gap there "
                             f"{gap:.3e}")


def _serve_engines(params, cfg, sampling, tag):
    """(a)/(b): a fixed engine (8 slots, max_len 512, decode block 8) and a
    paged engine at equal pool bytes (page 16, 4x the slots) serve one
    seeded trace; every stream equals generate_cached."""
    import torch

    from gradaccum_tpu_torch.serving import Engine, Scheduler, SimulationDriver

    pool_bytes, wants = {}, None
    # the paged pool holds the fixed pool's 8 x 512 positions as 256 blocks
    for pool, kw in (("fixed", dict(num_slots=8)),
                     ("paged", dict(num_slots=32, page_size=16, num_blocks=256))):
        engine = Engine(params, cfg, max_len=512, decode_block=8,
                        scheduler=Scheduler(max_queue=64), **kw, **sampling)
        driver = SimulationDriver(engine, seed=SERVE_SEED)
        trace = driver.make_trace(**SERVE_TRACE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = driver.run(trace)
        wall = time.perf_counter() - t0
        if wants is None:  # one trace (one seed) for both pools: one reference
            wants = _serve_solo(params, cfg, trace, sampling)
        _serve_check(f"{tag} {pool}", params, cfg, trace, records, wants)
        m = engine.metrics.summary()
        tokens = sum(len(r["tokens"]) for r in records)
        pool_bytes[pool] = engine.kv_pool_bytes
        check(engine.decode_compile_count() == 1,
              f"[serving] {tag} {pool}: {engine.decode_compile_count()} tick signatures")
        print(f"[serving] ({'a' if not sampling else 'b'}) {tag} {pool}: {len(records)} "
              f"requests, {tokens} tokens token for token with generate_cached; {m['ticks']} "
              f"ticks, {tokens / wall:.1f} tokens/s, {1e3 * wall / m['ticks']:.2f} ms/tick "
              f"(wall, trace on the tick clock), KV {m['kv_bytes_per_token_in_flight']:.0f} "
              f"B/token in flight of a {engine.kv_pool_bytes / 2 ** 20:.1f} MiB pool, "
              f"{engine.prefill_compile_count()} prefill signatures")
    check(pool_bytes["fixed"] == pool_bytes["paged"],
          f"[serving] pools of unequal bytes: {pool_bytes}")
    return trace, wants


def _serve_server(params, cfg):
    """(c): 8 concurrent streams through ServingServer, a cancelled request
    handing its slot and blocks back, and a full queue rejecting."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from gradaccum_tpu_torch.models.gpt_decode import generate_cached
    from gradaccum_tpu_torch.serving import (Engine, QueueFull, Scheduler,
                                             ServingServer)

    rng = np.random.default_rng(SERVE_SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129))).astype(np.int32)
               for _ in range(8)]
    # decode block 1: the request to cancel runs 400 ticks, far longer than
    # the wait between its first token and the cancel
    engine = Engine(params, cfg, num_slots=8, max_len=512, page_size=16, decode_block=1,
                    scheduler=Scheduler(max_queue=16))
    with ServingServer(engine) as srv:
        doomed = srv.submit(prompts[0][:64], 400)
        first = next(iter(doomed))
        check(srv.cancel(doomed.request_id), "[serving] (c) cancel refused")
        tokens, reason = doomed.result(timeout=60)
        check(reason == "cancelled" and tokens[0] == first,
              f"[serving] (c) cancelled stream ended {reason}")
        stats = srv.stats()
        check(stats["active_slots"] == 0 and stats["free_kv_blocks"] == stats["num_kv_blocks"],
              f"[serving] (c) the cancelled request kept its slot or blocks: {stats}")

        def stream(i):
            handle = srv.submit(prompts[i], 48, rng_seed=i)
            return list(handle), handle.result(timeout=120)

        with ThreadPoolExecutor(8) as pool:
            results = list(pool.map(stream, range(8)))
    for prompt, (streamed, (tokens, reason)) in zip(prompts, results):
        want = generate_cached(params, cfg, prompt, 48)[0, prompt.size:].tolist()
        check(reason == "length" and streamed == tokens == want,
              f"[serving] (c) a stream differs from generate_cached ({reason})")
    full = ServingServer(Engine(params, cfg, num_slots=1, max_len=64,
                                scheduler=Scheduler(max_queue=2)))
    full.submit(prompts[0][:8], 4)
    full.submit(prompts[1][:8], 4)
    try:
        full.submit(prompts[2][:8], 4)
        raise SmokeError("[serving] (c) a full queue accepted a request")
    except QueueFull as e:
        rejected = str(e)
    full.stop()
    print(f"[serving] (c) ServingServer: a request cancelled after its first token gave its "
          f"slot and blocks back; 8 concurrent streams token for token with generate_cached; "
          f"a full queue rejects: {rejected!r}")


def _serve_bench():
    """(d): bench_serving's default and --paged legs on the card."""
    from gradaccum_tpu_torch.examples import bench_serving

    os.makedirs(SERVE_DIR, exist_ok=True)
    out = {}
    for name, argv in (("default", []), ("paged", ["--paged"])):
        path = os.path.join(SERVE_DIR, f"bench_serving_{name}.json")
        out[name] = bench_serving.main(["--device", "cuda", "--out", path, *argv])
    r, p = out["default"], out["paged"]
    print(f"[serving] (d) bench_serving: serial {r['serial_tokens_per_s']:.1f} tokens/s, "
          f"engine {r['engine']['tokens_per_s']:.1f} tokens/s "
          f"({r['speedup_vs_serial']:.2f}x serial, {r['engine']['ms_per_tick']:.2f} ms/tick, "
          f"KV {r['engine']['kv_bytes_per_token_in_flight']:.0f} B/token in flight)")
    for leg in r["sweep"]:
        print(f"[serving] (d)   load {leg['load_fraction']:.2f}x ({leg['offered_rps']:.1f} "
              f"rps): {leg['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 "
              f"{leg['ttft_s']['p50'] * 1e3:.2f}/{leg['ttft_s']['p99'] * 1e3:.2f} ms wall, "
              f"{leg['ttft_ticks']['p50']:.1f}/{leg['ttft_ticks']['p99']:.1f} ticks, occupancy "
              f"{leg['occupancy_mean']:.2f}, KV {leg['kv_bytes_per_token_in_flight']:.0f} "
              f"B/token")
    for pool in ("fixed", "paged"):
        leg = p[pool]
        print(f"[serving] (d)   --paged {pool} ({leg['num_slots']} slots): "
              f"{leg['tokens_per_s']:.1f} tokens/s, peak {leg['peak_concurrent_requests']} "
              f"concurrent, KV {leg['kv_bytes_per_token_in_flight']:.0f} B/token in flight, "
              f"{leg['ms_per_tick']:.2f} ms/tick")
    print(f"[serving] (d)   --paged: concurrency {p['concurrency_gain']:.2f}x, KV bytes/token "
          f"{p['kv_bytes_per_token_ratio']:.3f}x, acceptance {p['acceptance']['passed']}")


def _device_events(fn):
    """Run ``fn`` under torch.profiler; the device events (kernels, copies,
    memsets) as ``(key, device_us, count)`` and the wall seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ([(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA], wall)


def _launches_per_call(fn, iters=8, attempts=3):
    """Device launches per call of ``fn``: profiler windows over ``iters``
    calls until two in a row count the same total (a window that lost
    events counts fewer), rounded over the calls (a window of 8 decode steps
    counted one event short of 8 x 160 every time on the card). Per-kernel
    counts need not divide: an elementwise kernel's name changes with its
    operands' alignment."""
    totals = []
    for _ in range(attempts + 1):
        events, _ = _device_events(lambda: [fn() for _ in range(iters)])
        totals.append(sum(count for _, _, count in events))
        if len(totals) > 1 and totals[-1] == totals[-2]:
            return round(totals[-1] / iters)
    raise SmokeError(f"[serving] (e) launch counts of {iters} calls disagree: {totals}")


def _serve_profile(params, cfg):
    """(e): a profiler window over SERVE_PROFILE_TICKS ticks of the sampled
    fixed engine with all 8 slots decoding: wall and card-busy ms per tick,
    idle share, launches per micro-step split into the model (one
    decode_step_ragged, profiled alone), sampling (one sample_token, alone)
    and the engine's own; the top kernels."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.models.gpt_decode import decode_step_ragged, sample_token
    from gradaccum_tpu_torch.serving import Engine

    block = 8
    engine = Engine(params, cfg, num_slots=8, max_len=512, decode_block=block,
                    **SERVE_SAMPLING)
    rng = np.random.default_rng(SERVE_SEED + 2)
    for i in range(8):
        engine.submit(rng.integers(0, cfg.vocab_size, 128).astype(np.int32), 300, rng_seed=i)
    engine.step()  # admits all 8
    engine.step()  # one warm tick
    events, wall = _device_events(lambda: [engine.step() for _ in range(SERVE_PROFILE_TICKS)])
    busy = sum(t for _, t, _ in events) / 1e6
    if busy == 0:
        raise SmokeError("[serving] (e) the profiler saw no device time")
    launches = sum(c for _, _, c in events) / (SERVE_PROFILE_TICKS * block)
    pool = engine.pool
    active = torch.ones(8, dtype=torch.bool, device="cuda")
    tokens = engine._cur_tok.clone()
    model = _launches_per_call(lambda: decode_step_ragged(params, cfg, pool.as_cache(),
                                                          tokens, active))
    logits = torch.randn(8, cfg.vocab_size, device="cuda")
    sampling = _launches_per_call(lambda: sample_token(
        logits, engine._rngs, engine._gen, SERVE_SAMPLING["temperature"],
        SERVE_SAMPLING["top_k"]))
    per_tick = wall / SERVE_PROFILE_TICKS
    print(f"[serving] (e) profile, {SERVE_PROFILE_TICKS} ticks of {block} micro-steps, 8 "
          f"slots, GPT-Small f32, T 0.8 top-k 50: {per_tick * 1e3:.2f} ms/tick wall, card "
          f"busy {busy / SERVE_PROFILE_TICKS * 1e3:.2f} ms/tick (idle share "
          f"{1 - busy / wall:.3f}); {launches:.1f} launches per micro-step: model {model}, "
          f"sampling {sampling}, engine {launches - model - sampling:.1f}")
    for key, t, count in sorted(events, key=lambda x: -x[1])[:8]:
        print(f"[serving]   {t / SERVE_PROFILE_TICKS / 1e3:8.3f} ms/tick  "
              f"{count // SERVE_PROFILE_TICKS:5d}x  {key[:90]}")


def _serving_profile_main():
    """Phase 24 (e) in a process of its own (``--serving-profile``): late in
    the whole script profiler windows lose events."""
    cfg, params = _serve_model()
    try:
        _serve_profile(params, cfg)
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    return 0


def phase_serving():
    """Phase 24: the serving path at GPT-Small width on the card. No flash
    kernel launches here: the decode attention is torch ops, as JAX's is
    XLA (the counters stay 0). Returns the trace and its greedy
    ``generate_cached`` streams for phase 25."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launch_counts()
    cfg, params = _serve_model()
    greedy = _serve_engines(params, cfg, {}, "greedy")
    _serve_engines(params, cfg, SERVE_SAMPLING, "T 0.8 top-k 50")
    _serve_server(params, cfg)
    _serve_bench()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serving-profile"],
                          timeout=300)
    check(proc.returncode == 0, f"[serving] (e) the profile process failed (exit "
                                f"{proc.returncode})")
    counts = fa.launch_counts()
    check(not any(counts.values()), f"[serving] flash kernels launched: {counts}")
    print(f"[serving] flash launches in phase 24: {counts}; phase 24 took "
          f"{time.perf_counter() - t0:.1f} s")
    return greedy


# --------------------------------------------------------------------------
# phase 25: prefix sharing, copy-on-write and speculative decoding
# --------------------------------------------------------------------------

PREFIX_SYS_LEN = 192  # the shared system prompt: 12 pages of 16
PREFIX_TRACE = dict(n=24, tail=(4, 40), new=(16, 64))
# equal pool bytes for the three legs: 160 blocks of 16 hold about 9
# unshared requests of the trace, or all 24 with the system prompt shared
PREFIX_ENGINE = dict(num_slots=24, max_len=320, page_size=16, num_blocks=160,
                     decode_block=8)
SPEC_K = 4
SPEC_PROFILE_CYCLES = 4
# a greedy stream may leave generate_cached's only where the reference's two
# best logits are closer than this: a batch of another shape moves cuBLAS's
# rounding by ~1e-6
NEAR_TIE = 1e-4


def _prefix_trace(cfg):
    """24 requests behind one 192-token system prompt: the leader at tick 0
    (its pages are indexed before anyone else admits), then four arrivals a
    tick, more than the pool holds unshared."""
    import numpy as np

    from gradaccum_tpu_torch.serving import TraceItem

    rng = np.random.default_rng(SERVE_SEED + 25)
    sys_p = rng.integers(0, cfg.vocab_size, PREFIX_SYS_LEN).astype(np.int32)
    lo, hi = PREFIX_TRACE["tail"]
    new_lo, new_hi = PREFIX_TRACE["new"]
    return [TraceItem(arrival_tick=0 if i == 0 else 1 + (i - 1) // 4,
                      prompt=np.concatenate([sys_p, rng.integers(
                          0, cfg.vocab_size, int(rng.integers(lo, hi + 1))).astype(np.int32)]),
                      max_new_tokens=int(rng.integers(new_lo, new_hi + 1)), rng_seed=i)
            for i in range(PREFIX_TRACE["n"])]


def _drive(engine, trace):
    """Run ``trace`` on the tick clock, submitting each arrival at its tick;
    returns the streams in trace order, the wall seconds, and TTFT in wall
    ms and in ticks (submit to the tick whose admission read the first
    token back)."""
    import torch

    from gradaccum_tpu_torch.utils.timing import LatencySeries

    pending = sorted(range(len(trace)), key=lambda i: trace[i].arrival_tick)
    rids, submitted = {}, {}
    ttft_ms, ttft_ticks = LatencySeries(), LatencySeries()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or not engine.idle:
        while pending and trace[pending[0]].arrival_tick <= engine.tick_count:
            item = trace[pending.pop(0)]
            rid = engine.submit(item.prompt, item.max_new_tokens, rng_seed=item.rng_seed)
            rids[item.rng_seed] = rid
            submitted[rid] = (time.perf_counter(), engine.tick_count)
        events = engine.step()
        now = time.perf_counter()
        for rid in events.admitted:
            ts, tick = submitted.pop(rid)
            ttft_ms.add(1e3 * (now - ts))
            ttft_ticks.add(events.tick - tick)
    wall = time.perf_counter() - t0
    streams = []
    for item in trace:
        tokens, status = engine.pop_result(rids[item.rng_seed])
        check(status == "done", f"[prefix/spec] request {item.rng_seed} ended {status}")
        streams.append(list(tokens))
    return streams, wall, ttft_ms.summary(), ttft_ticks.summary()


def _near_tie_check(tag, params, cfg, prompt, got, want, cases):
    """``got`` must equal ``want``; a first difference passes only where the
    reference's top-2 logit gap there is under NEAR_TIE (added to
    ``cases`` and printed)."""
    if got == want:
        return
    pos, gap = _first_gap(params, cfg, prompt, got, want)
    if gap >= NEAR_TIE:
        raise SmokeError(f"[prefix/spec] {tag}: a stream first differs at token {pos}: "
                         f"{got[pos]} against {want[pos]}, the reference's top-2 logit gap "
                         f"{gap:.3e}")
    cases.append((tag, pos, gap))
    print(f"[prefix/spec]   {tag}: near tie at token {pos} (top-2 gap {gap:.3e}): "
          f"{got[pos]} against {want[pos]}")


def _prefix_legs(params, cfg, sampling, tag):
    """(a): prefix off, on without COW tails, and COW on, at equal pool
    bytes; every stream against generate_cached."""
    from gradaccum_tpu_torch.serving import Engine, Scheduler

    trace = _prefix_trace(cfg)
    wants = _serve_solo(params, cfg, trace, sampling)
    cases, kv = [], {}
    for leg, kw in (("off", dict(prefix_cache=False)),
                    ("on", dict(prefix_cache=True, cow_tails=False)),
                    ("cow", dict(prefix_cache=True))):
        engine = Engine(params, cfg, scheduler=Scheduler(max_queue=64), **PREFIX_ENGINE, **kw,
                        **sampling)
        streams, wall, ttft_ms, ttft_ticks = _drive(engine, trace)
        for item, got, want in zip(trace, streams, wants):
            if sampling:  # a draw has no near tie to excuse it
                check(got == want, f"[prefix/spec] (a) {tag} {leg}: request {item.rng_seed} "
                                   f"differs from generate_cached")
            else:
                _near_tie_check(f"(a) {tag} {leg} request {item.rng_seed}", params, cfg,
                                item.prompt, got, want, cases)
        pool, m = engine.pool, engine.metrics.summary()
        check(pool.allocated_blocks == 0 and pool.unreserved_blocks == pool.num_blocks,
              f"[prefix/spec] (a) {tag} {leg}: the pool kept {pool.allocated_blocks} blocks")
        check(engine.decode_compile_count() == 1,
              f"[prefix/spec] (a) {tag} {leg}: {engine.decode_compile_count()} tick signatures")
        if leg != "off":
            check(m["prefill_tokens_skipped"] > 0 and m["prefix_hit_rate"] > 0,
                  f"[prefix/spec] (a) {tag} {leg}: nothing shared")
        kv[leg] = m["kv_bytes_per_token_in_flight"]
        hit = "-" if m["prefix_hit_rate"] is None else f"{m['prefix_hit_rate']:.3f}"
        print(f"[prefix/spec] (a) {tag} {leg}: prefill {m['prefill_tokens_computed']} tokens "
              f"computed, {m['prefill_tokens_skipped']} skipped, hit rate {hit}, "
              f"{m['blocks_saved']} blocks saved, COW forks {m['cow_forks']}; KV "
              f"{m['kv_bytes_per_token_in_flight']:.0f} B/token in flight; "
              f"{sum(map(len, streams)) / wall:.1f} tokens/s over {m['ticks']} ticks; TTFT "
              f"p50/p99 {ttft_ms['p50']:.2f}/{ttft_ms['p99']:.2f} ms wall, "
              f"{ttft_ticks['p50']:.1f}/{ttft_ticks['p99']:.1f} ticks; "
              f"{engine.prefill_compile_count()} prefill signatures")
    print(f"[prefix/spec] (a) {tag}: KV bytes per token on/off {kv['on'] / kv['off']:.3f}, "
          f"cow/off {kv['cow'] / kv['off']:.3f}; {len(cases)} near ties")


def _cow_fork_check(params, cfg):
    """(a) sub-page sharing: B shares 8 tokens of the leader's 13th page
    (forked at its admission), C is the leader's prompt (fully shared, its
    fork deferred to the first decode write)."""
    import numpy as np

    from gradaccum_tpu_torch.models.gpt_decode import generate_cached
    from gradaccum_tpu_torch.serving import Engine

    trace = _prefix_trace(cfg)
    rng = np.random.default_rng(SERVE_SEED + 26)
    a = np.concatenate([trace[0].prompt[:PREFIX_SYS_LEN],
                        rng.integers(0, cfg.vocab_size, 20).astype(np.int32)])
    b = np.concatenate([a[:PREFIX_SYS_LEN + 8],
                        rng.integers(0, cfg.vocab_size, 9).astype(np.int32)])
    engine = Engine(params, cfg, **PREFIX_ENGINE, prefix_cache=True)
    rids = [engine.submit(a, 24)]
    engine.step()
    for prompt in (b, a.copy()):
        rids.append(engine.submit(prompt, 24))
        engine.step()
    engine.run_until_idle()
    cases = []
    for name, prompt, rid in zip("ABC", (a, b, a), rids):
        want = generate_cached(params, cfg, prompt, 24)[0, prompt.size:].tolist()
        _near_tie_check(f"(a) COW {name}", params, cfg, prompt, engine.results[rid], want,
                        cases)
    m = engine.metrics
    check(m.cow_adoptions == 2 and m.cow_forks == 2,
          f"[prefix/spec] (a) COW: {m.cow_adoptions} adoptions, {m.cow_forks} forks "
          f"(want 2 and 2)")
    check(engine.pool.allocated_blocks == 0, "[prefix/spec] (a) COW: the pool kept blocks")
    print(f"[prefix/spec] (a) COW: a prompt sharing 8 tokens of a tail page forked it at "
          f"admission, an identical prompt at its first decode write ({m.cow_tokens_shared} "
          f"tokens shared sub-page); streams against generate_cached, {len(cases)} near ties")


def _closed_load(engine, trace):
    """All of ``trace`` submitted at once, run to idle: ``(streams, wall)``."""
    import torch

    rids = [engine.submit(item.prompt, item.max_new_tokens, rng_seed=item.rng_seed)
            for item in trace]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_until_idle()
    wall = time.perf_counter() - t0
    return [list(engine.pop_result(rid)[0]) for rid in rids], wall


def _spec_versus_plain(tag, params, cfg, draft, trace, min_accept=None):
    """Closed load through the speculative engine and the plain one (fixed
    pool, 8 slots, decode block 8), greedy: equal streams, tokens/s, the
    accept rate and tokens per slot-cycle."""
    from gradaccum_tpu_torch.serving import Engine, Scheduler

    plain = Engine(params, cfg, num_slots=8, max_len=512, decode_block=8,
                   scheduler=Scheduler(max_queue=64))
    want, plain_wall = _closed_load(plain, trace)
    spec = Engine(params, cfg, num_slots=8, max_len=512, speculate_k=SPEC_K,
                  draft_params=draft[0], draft_cfg=draft[1], scheduler=Scheduler(max_queue=64))
    got, spec_wall = _closed_load(spec, trace)
    cases = []
    for item, g, w in zip(trace, got, want):
        _near_tie_check(f"(b) {tag} closed load request {item.rng_seed}", params, cfg,
                        item.prompt, g, w, cases)
    rate = spec.metrics.spec_accept_rate()
    if min_accept is not None:
        check(rate >= min_accept, f"[prefix/spec] (b) {tag}: accept rate {rate:.3f} < "
                                  f"{min_accept}")
    tokens = sum(item.max_new_tokens for item in trace)
    print(f"[prefix/spec] (b) {tag}, closed load, fixed pool: speculative "
          f"{tokens / spec_wall:.1f} tokens/s against plain {tokens / plain_wall:.1f} "
          f"({plain_wall / spec_wall:.3f}x); accept rate {rate:.4f}, "
          f"{1 + SPEC_K * rate:.3f} tokens per slot-cycle, {spec.metrics.ticks} cycles "
          f"against {plain.metrics.ticks} ticks of 8; {len(cases)} near ties")


def _zeroed_tail(params, cfg):
    """The target with every layer past the first adding nothing: its
    attention output and ffn_output scaled by 0 (JAX's
    ``tools/bench_spec.py :: _build_model`` at eps 0). New tensors: the
    model of the other legs is untouched."""
    import torch

    tree = {"params": dict(params["params"])}
    for i in range(1, cfg.num_layers):
        layer = dict(params["params"][f"layer_{i}"])
        attention = dict(layer["attention"])
        attention["output"] = {k: torch.zeros_like(t) for k, t in attention["output"].items()}
        layer["attention"] = attention
        layer["ffn_output"] = {k: torch.zeros_like(t) for k, t in layer["ffn_output"].items()}
        tree["params"][f"layer_{i}"] = layer
    return tree


def _spec_legs(params, cfg, trace, wants):
    """(b): speculation on phase 24's trace, fixed and paged, greedy and
    sampled; then closed load against the plain engine, at random weights
    and with the target's tail zeroed."""
    from gradaccum_tpu_torch.models.gpt_decode import truncate_draft_params
    from gradaccum_tpu_torch.serving import Engine, Scheduler, SimulationDriver

    draft = truncate_draft_params(params, cfg, 1)
    cases = []
    for pool, kw in (("fixed", dict(num_slots=8)),
                     ("paged", dict(num_slots=32, page_size=16, num_blocks=256))):
        def run(sampling):
            engine = Engine(params, cfg, max_len=512, speculate_k=SPEC_K,
                            draft_params=draft[0], draft_cfg=draft[1],
                            scheduler=Scheduler(max_queue=64), **kw, **sampling)
            t0 = time.perf_counter()
            records = SimulationDriver(engine, seed=SERVE_SEED).run(trace)
            wall = time.perf_counter() - t0
            check(all(r["status"] == "done" for r in records),
                  f"[prefix/spec] (b) {pool}: a request did not finish")
            check(engine.decode_compile_count() == 1,
                  f"[prefix/spec] (b) {pool}: {engine.decode_compile_count()} tick signatures")
            if engine.paged:
                check(engine.pool.allocated_blocks == 0,
                      f"[prefix/spec] (b) {pool}: the pool kept blocks")
            return [r["tokens"] for r in records], engine, wall

        streams, engine, wall = run({})
        for item, got, want in zip(trace, streams, wants):
            _near_tie_check(f"(b) {pool} greedy request {item.rng_seed}", params, cfg,
                            item.prompt, got, want, cases)
        rate = engine.metrics.spec_accept_rate()
        print(f"[prefix/spec] (b) {pool} greedy, k={SPEC_K}: accept rate {rate:.4f}, "
              f"{1 + SPEC_K * rate:.3f} tokens per slot-cycle, {engine.metrics.ticks} cycles, "
              f"{sum(map(len, streams)) / wall:.1f} tokens/s on the trace")
        first, engine, wall = run(SERVE_SAMPLING)
        second, _, _ = run(SERVE_SAMPLING)
        check(first == second, f"[prefix/spec] (b) {pool} sampled: two runs differ")
        check(all(len(s) == item.max_new_tokens for s, item in zip(first, trace)),
              f"[prefix/spec] (b) {pool} sampled: a stream is incomplete")
        rate = engine.metrics.spec_accept_rate()
        print(f"[prefix/spec] (b) {pool} T 0.8 top-k 50: two runs identical and complete; "
              f"accept rate {rate:.4f}, {1 + SPEC_K * rate:.3f} tokens per slot-cycle, "
              f"{engine.metrics.ticks} cycles, {sum(map(len, first)) / wall:.1f} tokens/s on "
              f"the trace")
    print(f"[prefix/spec] (b) greedy streams against generate_cached: {len(cases)} near ties")
    _spec_versus_plain("random weights", params, cfg, draft, trace)
    zeroed = _zeroed_tail(params, cfg)
    _spec_versus_plain("tail zeroed", zeroed, cfg, truncate_draft_params(zeroed, cfg, 1),
                       trace, min_accept=0.95)


def _prefix_bench():
    """(c): bench_serving --prefix at JAX's full bench config."""
    from gradaccum_tpu_torch.examples import bench_serving

    os.makedirs(SERVE_DIR, exist_ok=True)
    r = bench_serving.main(["--device", "cuda", "--prefix", "--out",
                            os.path.join(SERVE_DIR, "bench_serving_prefix.json")])
    check(r["acceptance"]["passed"], f"[prefix/spec] (c) bench_serving --prefix failed its "
                                     f"acceptance: {r['acceptance']}")
    for leg in ("off", "on"):
        m = r[leg]
        print(f"[prefix/spec] (c) --prefix {leg}: {m['tokens_per_s']:.1f} tokens/s, prefill "
              f"{m['prefill_tokens_computed']} computed / {m['prefill_tokens_skipped']} skipped, "
              f"KV {m['kv_bytes_per_token_in_flight']:.0f} B/token, TTFT p50 "
              f"{m['ttft_s_p50'] * 1e3:.2f} ms, {m['prefill_programs']} prefill signatures")
    print(f"[prefix/spec] (c) --prefix: prefill cut {r['prefill_reduction']:.2f}x, KV bytes per "
          f"token {r['kv_bytes_per_token_ratio']:.3f}x, {r['prefix_speedup']:.3f}x tokens/s; "
          f"acceptance passed")


def _spec_profile(params, cfg):
    """(d): a profiler window over SPEC_PROFILE_CYCLES sampled speculative
    cycles, 8 slots decoding: wall and card-busy ms per cycle, the idle
    share, and launches per cycle split into the draft's k + 1 steps, its
    k draws, the verify step, and the rest (the accept rule and the final
    draw), each part profiled alone."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.models.gpt_decode import (DecodeCache, decode_step_ragged,
                                                      truncate_draft_params,
                                                      verify_step_ragged)
    from gradaccum_tpu_torch.serving import Engine

    draft, draft_cfg = truncate_draft_params(params, cfg, 1)
    engine = Engine(params, cfg, num_slots=8, max_len=512, speculate_k=SPEC_K,
                    draft_params=draft, draft_cfg=draft_cfg, **SERVE_SAMPLING)
    rng = np.random.default_rng(SERVE_SEED + 3)
    for i in range(8):
        engine.submit(rng.integers(0, cfg.vocab_size, 128).astype(np.int32), 300, rng_seed=i)
    engine.step()  # admits all 8
    engine.step()  # one warm cycle
    events, wall = _device_events(lambda: [engine.step() for _ in range(SPEC_PROFILE_CYCLES)])
    busy = sum(t for _, t, _ in events) / 1e6
    if busy == 0:
        raise SmokeError("[prefix/spec] (d) the profiler saw no device time")
    total = sum(c for _, _, c in events) / SPEC_PROFILE_CYCLES
    pool, active = engine.pool, torch.ones(8, dtype=torch.bool, device="cuda")
    tokens = engine._cur_tok.clone()
    draft_step = _launches_per_call(lambda: decode_step_ragged(
        draft, draft_cfg, DecodeCache(engine._draft_k, engine._draft_v, pool.lengths), tokens,
        active))
    logits = torch.randn(8, cfg.vocab_size, device="cuda")
    draw = _launches_per_call(lambda: engine._draft_draw(logits, pool.lengths))
    verify = _launches_per_call(lambda: verify_step_ragged(
        params, cfg, pool.as_cache(), tokens[:, None].expand(8, SPEC_K + 1), active))
    accept = total - (SPEC_K + 1) * draft_step - SPEC_K * draw - verify
    per_cycle = wall / SPEC_PROFILE_CYCLES
    print(f"[prefix/spec] (d) profile, {SPEC_PROFILE_CYCLES} sampled cycles (k={SPEC_K}, T 0.8 "
          f"top-k 50), 8 slots: {per_cycle * 1e3:.2f} ms/cycle wall, card busy "
          f"{busy / SPEC_PROFILE_CYCLES * 1e3:.2f} ms/cycle (idle share {1 - busy / wall:.3f}); "
          f"{total:.1f} launches per cycle: draft {SPEC_K + 1} x {draft_step}, its sampling "
          f"{SPEC_K} x {draw}, verify {verify}, accept and final draw {accept:.1f}; accept rate "
          f"{engine.metrics.spec_accept_rate():.4f}")
    for key, t, count in sorted(events, key=lambda x: -x[1])[:6]:
        print(f"[prefix/spec]   {t / SPEC_PROFILE_CYCLES / 1e3:8.3f} ms/cycle  "
              f"{count // SPEC_PROFILE_CYCLES:5d}x  {key[:90]}")


def _spec_profile_main():
    """Phase 25 (d) in a process of its own (``--spec-profile``)."""
    cfg, params = _serve_model()
    try:
        _spec_profile(params, cfg)
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    return 0


def phase_prefix_spec(serving):
    """Phase 25: prefix sharing, copy-on-write and speculative decoding at
    GPT-Small width; ``serving`` is phase 24's trace and its greedy
    ``generate_cached`` streams. No flash kernel launches."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launch_counts()
    print(f"[prefix/spec] on {_smi()}")
    cfg, params = _serve_model()
    _prefix_legs(params, cfg, {}, "greedy")
    _prefix_legs(params, cfg, SERVE_SAMPLING, "T 0.8 top-k 50")
    _cow_fork_check(params, cfg)
    _spec_legs(params, cfg, *serving)
    _prefix_bench()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--spec-profile"],
                          timeout=300)
    check(proc.returncode == 0, f"[prefix/spec] (d) the profile process failed (exit "
                                f"{proc.returncode})")
    counts = fa.launch_counts()
    check(not any(counts.values()), f"[prefix/spec] flash kernels launched: {counts}")
    print(f"[prefix/spec] flash launches in phase 25: {counts}; phase 25 took "
          f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 26: admission control, preemption and swap, int8 KV, overlapped prefill
# --------------------------------------------------------------------------

# (b)/(c): 8 requests submitted at once; prompts 48-112, 96 new. Optimistic
# admission takes all 8 at tick 0 in 64 blocks of 16 (their asks: the prompt
# and one page), whose worst case needs ~88: decode runs the pool dry. The
# calm run reserves the worst case in 128 blocks and admits the same batch
SWAP_TRACE = dict(n=8, prompt=(48, 112), new=96)
SWAP_ENGINE = dict(num_slots=8, max_len=256, page_size=16, decode_block=4)
SWAP_BLOCKS, CALM_BLOCKS = 64, 128
SWAP_PREEMPT_TICK = 2          # the forced preemption: the lowest running id
TIER_HOST_PAGES = 4  # the tiered host rung holds 4 pages: most records go to disk
SWAP_COST_LEN = (192, 64)      # (prompt, generated) of the swap-cost request
OVERLAP_PROFILE_TICKS = 4


def _admission_legs(params, cfg):
    """(a): bench_admission's long-tail trace (its full config: 28 requests
    declaring 20 new, 8 slots, 16 blocks of 4) through reserve, quantile and
    optimistic at GPT-Small width; every stream against its
    generate_cached greedy stream on the card under the near-tie rule; the
    bench's acceptance."""
    from gradaccum_tpu_torch.examples import bench_admission

    items = bench_admission.make_workload(params, cfg, 28, bench_admission.DECLARED_NEW, 7)
    cases, legs = [], []
    for admission in bench_admission.policies():
        leg, streams = bench_admission.run_leg(params, cfg, items, admission,
                                               **bench_admission.shapes(False))
        for i, (it, got) in enumerate(zip(items, streams)):
            _near_tie_check(f"(a) {leg['admission']} request {i}", params, cfg, it["prompt"],
                            got, it["want"], cases)
        leg["parity_ok"] = True  # held above, under the near-tie rule
        legs.append(leg)
        print(f"[admission] (a) {leg['admission']}: {leg['requests_per_1k_ticks']} requests "
              f"per 1k ticks, peak concurrency {leg['peak_concurrency']}, "
              f"{leg['preemptions']} preemptions, {leg['swap_outs']} swap-outs, "
              f"{leg['swap_ins']} swap-ins, {leg['reprefills']} re-prefills, "
              f"{leg['ticks_to_drain']} ticks, {leg['tokens_per_s']:.1f} tokens/s wall")
    acc = bench_admission.acceptance(legs)
    check(acc["passed"], f"[admission] (a) JAX's acceptance failed: {acc} {legs}")
    print(f"[admission] (a) best overcommitting leg against reserve: "
          f"{acc['admitted_rate_x']:.3f}x requests per 1k ticks, "
          f"{acc['peak_concurrency_x']:.3f}x peak concurrency; {len(cases)} near ties; "
          f"acceptance passed")


def _swap_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED + 26)
    lo, hi = SWAP_TRACE["prompt"]
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1))).astype(np.int32)
            for _ in range(SWAP_TRACE["n"])]


def _tier_host_bytes(cfg, int8=False):
    """TIER_HOST_PAGES pages of K/V at the pool's storage layout."""
    per_position = 2 * cfg.num_layers * (cfg.hidden_size + cfg.num_heads * 4 if int8
                                         else cfg.hidden_size * 4)
    return TIER_HOST_PAGES * SWAP_ENGINE["page_size"] * per_position


def _swap_run(params, cfg, prompts, num_blocks, force=True, rot=False, **kw):
    """All of ``prompts`` submitted at tick 0, run to idle; at
    SWAP_PREEMPT_TICK the running request of the lowest id is preempted
    (its host record rotted by one element if ``rot``). Returns the streams
    and the engine."""
    from gradaccum_tpu_torch.serving import Engine

    engine = Engine(params, cfg, num_blocks=num_blocks, **SWAP_ENGINE, **kw)
    rids = [engine.submit(p, SWAP_TRACE["new"]) for p in prompts]
    while not engine.idle:
        engine.step()
        if force and engine.tick_count == SWAP_PREEMPT_TICK:
            running = [r for r in rids if engine.status[r] == "running"]
            check(running and engine.preempt(running[0]),
                  "[admission] the forced preemption found no running request")
            if rot:
                check(engine._swap_store is not None and running[0] in engine._swap_store,
                      "[admission] the forced preemption left no record to rot")
                engine._swap_store._recs[running[0]].arrays["k"].flat[0] += 1.0
        check(engine.tick_count < 2000, "[admission] a swap run did not drain")
    check(all(engine.status[r] == "done" for r in rids), "[admission] a request did not finish")
    pool = engine.pool
    check(pool.allocated_blocks == 0 and pool.unreserved_blocks == pool.num_blocks,
          f"[admission] the pool kept {pool.allocated_blocks} blocks")
    return [list(engine.results[r]) for r in rids], engine


def _swap_costs(params, cfg):
    """(b) the recompute-against-memory trade: one request (prompt 192, 64
    generated, 256 positions) preempted and resumed in an otherwise idle
    engine, three times per mode: the ms and MB/s of the swap-out (read
    back, sha256, store) and the swap-in (sha check, upload, scatter, the
    slot's state), and the ms of re-prefilling the same 256 positions."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.serving import Engine

    prompt_len, generated = SWAP_COST_LEN
    prompt = np.random.default_rng(SERVE_SEED + 27).integers(
        0, cfg.vocab_size, prompt_len).astype(np.int32)
    out = {}
    for swap in ("host", "recompute"):
        engine = Engine(params, cfg, num_slots=1, max_len=512, page_size=16, decode_block=8,
                        admission="quantile", swap=swap)
        rid = engine.submit(prompt, 256)
        while len(engine.results[rid]) < generated:
            engine.step()
        length = int(engine._slot_len[0])
        outs, ins = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.preempt(rid)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            check(engine._try_resume() == [rid], f"[admission] (b) {swap}: no resume")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            outs.append(t1 - t0)
            ins.append(t2 - t1)
        m = engine.metrics
        check(m.preemptions == 3 and (m.swap_ins if swap == "host" else m.reprefills) == 3,
              f"[admission] (b) {swap}: {m.swap_ins} swap-ins, {m.reprefills} re-prefills")
        out[swap] = (float(np.median(outs)), float(np.median(ins)),
                     m.swap_bytes_out / 3, length)
        engine.cancel(rid)
    host_out, host_in, nbytes, length = out["host"]
    re_out, re_in, _, _ = out["recompute"]
    mb = nbytes / 2 ** 20
    print(f"[admission] (b) swap cost of one request ({length} positions, {mb:.2f} MiB of "
          f"K/V): swap-out {host_out * 1e3:.2f} ms ({mb / host_out:.1f} MiB/s), swap-in "
          f"{host_in * 1e3:.2f} ms ({mb / host_in:.1f} MiB/s); recompute: park "
          f"{re_out * 1e3:.2f} ms, re-prefill {re_in * 1e3:.2f} ms (median of 3)")


def _swap_legs(params, cfg):
    """(b): preemption by pool pressure and by preempt() under host,
    recompute and tiered swap (its host rung smaller than most records),
    against the calm run of the same batch; a rotted record falls back."""
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    prompts = _swap_prompts(cfg)
    n = SWAP_TRACE["new"]
    wants = [generate_cached(params, cfg, p, n)[0, p.size:].tolist() for p in prompts]
    calm, engine = _swap_run(params, cfg, prompts, CALM_BLOCKS, force=False)
    check(engine.metrics.preemptions == 0, "[admission] (b) the calm run preempted")
    calm_ticks = engine.metrics.ticks
    cases, runs = [], {}
    for mode, kw in (("host", dict(swap="host")), ("recompute", dict(swap="recompute")),
                     ("tiered", dict(swap="tiered", swap_max_bytes=_tier_host_bytes(cfg))),
                     ("host, rotted", dict(swap="host", rot=True))):
        streams, engine = _swap_run(params, cfg, prompts, SWAP_BLOCKS,
                                    admission="optimistic", **kw)
        runs[mode] = streams
        for i, (p, got, want) in enumerate(zip(prompts, streams, wants)):
            _near_tie_check(f"(b) {mode} request {i}", params, cfg, p, got, want, cases)
        m = engine.metrics
        check(m.preemptions >= 2, f"[admission] (b) {mode}: {m.preemptions} preemptions")
        tiers = ""
        if mode == "tiered":
            st = engine._swap_store.stats()
            check(st["demotions"] >= 1 and st["promotions"] >= 1,
                  f"[admission] (b) tiered: no record reached disk: {st}")
            tiers = f", {st['demotions']} demotions, {st['promotions']} promotions"
        if mode == "host, rotted":
            check(m.swap_fallbacks == 1, f"[admission] (b) rotted: {m.swap_fallbacks} "
                                         "swap fallbacks")
        else:
            check(m.swap_fallbacks == 0, f"[admission] (b) {mode}: {m.swap_fallbacks} "
                                         "swap fallbacks")
        print(f"[admission] (b) {mode}: {m.preemptions} preemptions ({m.swap_outs} swapped "
              f"out, {m.swap_bytes_out / 2 ** 20:.2f} MiB), {m.swap_ins} swap-ins, "
              f"{m.reprefills} re-prefills, {m.swap_fallbacks} swap fallbacks{tiers}; "
              f"{m.ticks} ticks against the calm run's {calm_ticks}")
    # swap-in restores the exact bytes, and every run admitted the same
    # batch at tick 0: the swapped streams are the calm run's, bit for bit
    check(runs["host"] == calm and runs["tiered"] == calm,
          "[admission] (b) a swap-in stream differs from the calm run's")
    same = sum(a == b for a, b in zip(runs["recompute"], calm))
    print(f"[admission] (b) host and tiered streams equal the calm run's token for token; "
          f"re-prefill streams equal it in {same} of {len(calm)}; {len(cases)} near ties "
          f"against generate_cached")
    _swap_costs(params, cfg)
    return calm


def _int8_legs(params, cfg, calm_f32):
    """(c): kv_quantize on the card bitwise its CPU run; an int8 engine
    churned by pressure and preempt() through the tiered store equals a calm
    int8 engine token for token; int8 against float32 agreement (recorded);
    KV bytes per token in flight; bench_mem's KV ladder."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.examples import bench_mem
    from gradaccum_tpu_torch.memory.quant import kv_quantize

    x = torch.randn(4, 8, 8, 16, 64, generator=torch.Generator().manual_seed(26)) * 3
    x[0, 0, 0, 0] = 0
    x[0, 0, 0, 1] = torch.finfo(torch.float32).max
    x[0, 0, 0, 2] = -torch.finfo(torch.float32).max
    q_card, s_card = kv_quantize(x.cuda())
    q_cpu, s_cpu = kv_quantize(x)
    check(torch.equal(q_card.cpu(), q_cpu)
          and torch.equal(s_card.cpu().view(torch.int32), s_cpu.view(torch.int32)),
          "[admission] (c) kv_quantize on the card differs from its CPU run")
    prompts = _swap_prompts(cfg)
    calm, calm_engine = _swap_run(params, cfg, prompts, CALM_BLOCKS, force=False,
                                  cache_dtype=torch.int8)
    churned, engine = _swap_run(params, cfg, prompts, SWAP_BLOCKS, admission="optimistic",
                                swap="tiered", swap_max_bytes=_tier_host_bytes(cfg, int8=True),
                                cache_dtype=torch.int8)
    m, st = engine.metrics, engine._swap_store.stats()
    check(m.preemptions >= 2 and m.swap_ins >= 1 and m.swap_fallbacks == 0
          and st["demotions"] >= 1 and st["promotions"] >= 1,
          f"[admission] (c) the int8 churn missed the ladder: {m.preemptions} preemptions, "
          f"{m.swap_ins} swap-ins, {st}")
    check(churned == calm, "[admission] (c) the churned int8 engine differs from the calm one")
    agree = [next((i for i, (a, b) in enumerate(zip(s, f)) if a != b), len(s)) / len(s)
             for s, f in zip(calm, calm_f32)]
    exact = sum(s == f for s, f in zip(calm, calm_f32))
    kv8 = calm_engine.metrics.summary()["kv_bytes_per_token_in_flight"]
    f32_bytes = 2 * cfg.num_layers * cfg.hidden_size * 4
    print(f"[admission] (c) kv_quantize on the card bitwise its CPU run; int8 churn: "
          f"{m.preemptions} preemptions, {m.swap_ins} swap-ins, {st['demotions']} demotions, "
          f"{st['promotions']} promotions: token for token with the calm int8 engine")
    print(f"[admission] (c) int8 against float32 greedy: {exact} of {len(calm)} streams equal, "
          f"{float(np.mean(agree)):.3f} of tokens before the first difference (recorded, not "
          f"gated); KV {calm_engine._token_bytes} B per position against float32's "
          f"{f32_bytes} ({calm_engine._token_bytes / f32_bytes:.4f}); {kv8:.0f} B per token in "
          f"flight")
    rows = bench_mem.kv_ladder("cuda")
    ladder, passed = bench_mem.kv_verdict(rows)
    bf, i8 = rows
    check(passed, f"[admission] (c) bench_mem's KV ladder failed its acceptance: {rows}")
    print(f"[admission] (c) bench_mem KV ladder: bf16+host {bf['streams_resumable_after_drain']}"
          f" resumable, {bf['ram_bytes_per_resumable_stream']:.1f} RAM B/stream; int8+tiered "
          f"{i8['streams_resumable_after_drain']} resumable, "
          f"{i8['ram_bytes_per_resumable_stream']:.1f}: {ladder:.3f}x; parity with the calm "
          f"runs; acceptance passed")


def _overlap_legs(params, cfg, trace, wants):
    """(d): phase 24's trace through the paged engine with overlap_prefill
    on and off: identical streams, each against generate_cached."""
    from gradaccum_tpu_torch.serving import Engine, Scheduler, SimulationDriver

    got, cases = {}, []
    for overlap in (False, True):
        engine = Engine(params, cfg, num_slots=32, max_len=512, page_size=16, num_blocks=256,
                        decode_block=8, overlap_prefill=overlap,
                        scheduler=Scheduler(max_queue=64))
        t0 = time.perf_counter()
        records = SimulationDriver(engine, seed=SERVE_SEED).run(trace)
        wall = time.perf_counter() - t0
        check(all(r["status"] == "done" for r in records),
              f"[admission] (d) overlap {overlap}: a request did not finish")
        got[overlap] = [r["tokens"] for r in records]
        print(f"[admission] (d) phase 24's trace, overlap_prefill={overlap}: "
              f"{engine.metrics.ticks} ticks, {wall * 1e3 / engine.metrics.ticks:.2f} ms/tick "
              f"wall, {sum(map(len, got[overlap])) / wall:.1f} tokens/s")
    check(got[True] == got[False], "[admission] (d) overlap changed a stream")
    for item, toks, want in zip(trace, got[True], wants):
        _near_tie_check(f"(d) request {item.rng_seed}", params, cfg, item.prompt, toks, want,
                        cases)
    print(f"[admission] (d) overlap on and off: identical streams; {len(cases)} near ties "
          f"against generate_cached")


def _overlap_profile(params, cfg):
    """(d): a profiler window over OVERLAP_PROFILE_TICKS ticks, overlap off
    and on: 7 slots decoding and one 128-token admission a tick (one new
    token, so it retires at its readback): wall and card-busy ms per tick,
    the idle share."""
    import numpy as np

    from gradaccum_tpu_torch.serving import Engine

    rng = np.random.default_rng(SERVE_SEED + 4)
    long_prompts = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32) for _ in range(7)]
    short = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
             for _ in range(OVERLAP_PROFILE_TICKS + 1)]
    for overlap in (False, True):
        engine = Engine(params, cfg, num_slots=8, max_len=512, page_size=16, decode_block=8,
                        overlap_prefill=overlap)
        for p in long_prompts:
            engine.submit(p, 300)
        engine.step()  # admits the 7
        engine.submit(short[-1], 1)
        engine.step()  # one warm tick with an admission

        def window():
            for p in short[:OVERLAP_PROFILE_TICKS]:
                engine.submit(p, 1)
                engine.step()

        events, wall = _device_events(window)
        busy = sum(t for _, t, _ in events) / 1e6
        if busy == 0:
            raise SmokeError("[admission] (d) the profiler saw no device time")
        print(f"[admission] (d) profile, overlap_prefill={overlap}, {OVERLAP_PROFILE_TICKS} "
              f"ticks of 8 micro-steps, 7 slots decoding + one 128-token admission a tick: "
              f"{wall / OVERLAP_PROFILE_TICKS * 1e3:.2f} ms/tick wall, card busy "
              f"{busy / OVERLAP_PROFILE_TICKS * 1e3:.2f} ms/tick (idle share "
              f"{1 - busy / wall:.3f})")


def _overlap_profile_main():
    """Phase 26 (d)'s profile in a process of its own (``--overlap-profile``)."""
    cfg, params = _serve_model()
    try:
        _overlap_profile(params, cfg)
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    return 0


def phase_admission(serving):
    """Phase 26: admission control, preemption and swap, int8 KV and
    overlapped prefill at GPT-Small width; ``serving`` is phase 24's trace
    and its greedy ``generate_cached`` streams. No flash kernel launches:
    the codec, the page view and the block moves are torch ops, as JAX's
    are XLA."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launch_counts()
    print(f"[admission] on {_smi()}")
    cfg, params = _serve_model()
    _admission_legs(params, cfg)
    calm_f32 = _swap_legs(params, cfg)
    _int8_legs(params, cfg, calm_f32)
    _overlap_legs(params, cfg, *serving)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--overlap-profile"],
                          timeout=300)
    check(proc.returncode == 0, f"[admission] (d) the profile process failed (exit "
                                f"{proc.returncode})")
    counts = fa.launch_counts()
    check(not any(counts.values()), f"[admission] flash kernels launched: {counts}")
    print(f"[admission] (e) flash launches in phase 26: {counts}; phase 26 took "
          f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 27: serving recovery, the watchdog and the live ops plane
# --------------------------------------------------------------------------

RECOVER_SYS_LEN = 64  # the prefix leg's shared system prompt: 4 pages of 16
RECOVER_TRACE = dict(n=4, prompt=(32, 96), new=24)
RECOVER_ENGINE = dict(num_slots=4, max_len=256, decode_block=4)
WATCHDOG_TIMEOUT = 0.5  # s: a one-step GPT-Small tick takes milliseconds
WATCHDOG_STALL = 10 * WATCHDOG_TIMEOUT
CLIFF_TICKS = (12, 13)  # ticks of the ops-plane leg slowed by CLIFF_SLEEP
CLIFF_SLEEP = 1.0
RECOVER_DIR = os.path.join(ROOT, "build", "chip_smoke_recovery")


def _recover_prompts(cfg, salt, system=0):
    """RECOVER_TRACE's prompts from seed SERVE_SEED + salt, behind a shared
    ``system``-token prompt when given."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED + salt)
    head = rng.integers(0, cfg.vocab_size, system).astype(np.int32)
    lo, hi = RECOVER_TRACE["prompt"]
    return [np.concatenate([head, rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
                            .astype(np.int32)]) for _ in range(RECOVER_TRACE["n"])]


def _pool_invariants(engine, failed=()):
    """What must hold after ``recover()``: every slot released and gated;
    on a paged pool free + live blocks = num_blocks, each block's refcount
    the page-table rows holding it, each row its slot's block list, the
    prefix index and the radix tails naming live blocks only; no swap
    record of a recovered request. Returns the violations."""
    from collections import Counter

    bad = []
    pool = engine.pool
    for s, req in enumerate(engine._slot_req):
        if req is not None or engine._active[s] or engine._slot_len[s]:
            bad.append(f"slot {s} not released")
    if engine.paged:
        held = Counter()
        for s in range(pool.num_slots):
            row = [int(b) for b in pool.page_table[s] if b != pool.num_blocks]
            if row != pool.blocks_of(s):
                bad.append(f"slot {s}: row {row} against blocks {pool.blocks_of(s)}")
            held.update(pool.blocks_of(s))
        live = sum(pool.refcount(b) > 0 for b in range(pool.num_blocks))
        if pool.free_blocks + live != pool.num_blocks:
            bad.append(f"{pool.free_blocks} free + {live} live != {pool.num_blocks}")
        bad += [f"block {b}: refcount {pool.refcount(b)}, rows {held[b]}"
                for b in range(pool.num_blocks) if pool.refcount(b) != held[b]]
        if engine.prefix_cache is not None:
            named = set(engine.prefix_cache._by_block) | set(engine.prefix_cache._tails._by_value)
            bad += [f"the prefix index names freed block {b}" for b in sorted(named)
                    if pool.refcount(b) == 0]
    store = engine._swap_store
    if store is not None:
        bad += [f"a swap record of {r.request_id} survived" for r in failed
                if r.request_id in store]
    return bad


def _faulted_serve(tag, engine, prompts, n, specs, **server_kw):
    """Serve ``prompts`` through a ServingServer under the fault schedule
    ``specs`` (FaultSpec keyword dicts), every request submitted before the
    loop starts. Each recover is timed and followed by the pool invariants.
    Returns the streams (None for a failed request), the counts, the
    recover ms and the requeued re-prefill ms (the serve/prefill spans
    after the first recover: they read the first tokens back)."""
    from gradaccum_tpu_torch.obs import trace as obs_trace
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import ServingServer

    recover_ms, bad = [], []
    plain = engine.recover

    def recover():
        t0 = time.perf_counter()
        failed = plain()
        recover_ms.append(1e3 * (time.perf_counter() - t0))
        bad.extend(_pool_invariants(engine, failed))
        return failed

    engine.recover = recover
    tracer = obs_trace.Tracer(capacity=None)
    inj = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(**s) for s in specs]))
    with faults.installed(inj), obs_trace.installed(tracer):
        server = ServingServer(engine, **server_kw)
        handles = [server.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)]
        server.start()
        streams = []
        for h in handles:
            try:
                streams.append(list(h.result(timeout=300)[0]))
            except RuntimeError:
                streams.append(None)
        try:
            server.stop()
            stopped = "ok"
        except RuntimeError as e:
            stopped = type(e.__cause__).__name__
    check(not specs or inj.fired, f"[recovery] {tag}: the fault schedule never fired")
    check(not bad, f"[recovery] {tag}: pool invariants broken after recover: {bad[:4]}")
    events = tracer.snapshot()
    names = [e["name"] for e in events]
    first = names.index("serve/recover") if "serve/recover" in names else len(events)
    counts = dict(
        fired=[tuple(f) for f in inj.fired],
        faults=names.count("serve/engine_fault"),
        failed=sum(e["args"]["failed"] for e in events if e["name"] == "serve/recover"),
        requeued=names.count("req/requeue"),
        given_up=sum(1 for e in events if e["name"] == "serve/engine_fault"
                     and e["args"]["give_up"]),
        errors=sorted({e["args"]["error"] for e in events if e["name"] == "serve/engine_fault"}),
        stopped=stopped)
    prefill_ms = [e["dur"] / 1e3 for e in events[first:] if e["name"] == "serve/prefill"]
    return streams, counts, recover_ms, prefill_ms


def _recover_legs(params, cfg):
    """(a): the fault schedule of the CPU tests on the card; requeued
    streams against the calm run under the near-tie rule."""
    import numpy as np

    from gradaccum_tpu_torch.models.gpt_decode import truncate_draft_params
    from gradaccum_tpu_torch.serving import Engine

    n = RECOVER_TRACE["new"]
    prompts = _recover_prompts(cfg, 30)
    prefix_prompts = _recover_prompts(cfg, 31, system=RECOVER_SYS_LEN)
    draft = truncate_draft_params(params, cfg, 1)
    calm = _faulted_serve("calm", Engine(params, cfg, **RECOVER_ENGINE), prompts, n, [])[0]
    calm_prefix = _faulted_serve("calm prefix", Engine(params, cfg, **RECOVER_ENGINE),
                                 prefix_prompts, n, [])[0]
    crash = [dict(point="mid_decode_tick", at=2)]
    legs = [
        ("MID_DECODE_TICK, lockstep", dict(), prompts, crash, calm),
        ("MID_DECODE_TICK, overlapped", dict(overlap_prefill=True), prompts,
         [dict(point="mid_decode_tick", at=0)], calm),
        ("POOL_PAGE_TABLE corrupt, paged + prefix",
         dict(page_size=16, num_blocks=64, prefix_cache=True), prefix_prompts,
         [dict(point="pool_page_table", at=2, kind="corrupt")], calm_prefix),
        ("mid spec cycle, k=4", dict(page_size=16, num_blocks=64, speculate_k=SPEC_K,
                                     draft_params=draft[0], draft_cfg=draft[1],
                                     decode_block=1, overlap_prefill=True),
         prompts, crash, calm),
    ]
    cases, recover_ms, prefill_ms = [], [], []
    for tag, kw, ps, specs, want in legs:
        engine = Engine(params, cfg, **dict(RECOVER_ENGINE, **kw))
        streams, counts, r_ms, p_ms = _faulted_serve(tag, engine, ps, n, specs,
                                                     max_requeues=2)
        check(counts["faults"] == 1 and counts["requeued"] == counts["failed"] >= 1
              and counts["given_up"] == 0 and counts["stopped"] == "ok",
              f"[recovery] (a) {tag}: counts {counts}")
        if "corrupt" in tag:
            check(counts["errors"] == ["BlockTableCorruption"],
                  f"[recovery] (a) {tag}: faulted with {counts['errors']}")
        for i, (p, got, w) in enumerate(zip(ps, streams, want)):
            _near_tie_check(f"(a) {tag} request {i}", params, cfg, p, got, w, cases)
        recover_ms += r_ms
        if tag.endswith("lockstep"):
            prefill_ms = p_ms
        print(f"[recovery] (a) {tag}: {counts['failed']} failed, {counts['requeued']} "
              f"requeued, recover {r_ms[0]:.3f} ms; streams equal the calm run's")
    # MID_SWAP_IO: a crash inside a victim's swap-out on phase 26's
    # overcommitted leg, against its calm run
    swap_prompts = _swap_prompts(cfg)
    swap_calm = _swap_run(params, cfg, swap_prompts, CALM_BLOCKS, force=False)[0]
    engine = Engine(params, cfg, num_blocks=SWAP_BLOCKS, admission="optimistic", swap="host",
                    **SWAP_ENGINE)
    streams, counts, r_ms, _ = _faulted_serve(
        "MID_SWAP_IO", engine, swap_prompts, SWAP_TRACE["new"],
        [dict(point="mid_swap_io", at=None)], max_requeues=2)
    check(counts["faults"] == 1 and counts["failed"] >= 1 and counts["stopped"] == "ok"
          and engine.pool.allocated_blocks == 0 and len(engine._swap_store) == 0,
          f"[recovery] (a) MID_SWAP_IO: counts {counts}, {engine.pool.allocated_blocks} blocks "
          f"kept, {len(engine._swap_store)} records kept")
    for i, (p, got, w) in enumerate(zip(swap_prompts, streams, swap_calm)):
        _near_tie_check(f"(a) MID_SWAP_IO request {i}", params, cfg, p, got, w, cases)
    recover_ms += r_ms
    print(f"[recovery] (a) MID_SWAP_IO crash mid-preemption: {counts['failed']} failed, "
          f"{counts['requeued']} requeued, {engine.metrics.preemptions} preemptions after "
          f"the requeue; streams equal the calm run's")
    # the give-up: max_engine_faults + 1 consecutive faulted ticks
    engine = Engine(params, cfg, **RECOVER_ENGINE)
    streams, counts, _, _ = _faulted_serve(
        "give-up", engine, prompts, n, [dict(point="mid_decode_tick", at=None, count=100)],
        max_requeues=5, max_engine_faults=3)
    check(streams == [None] * len(prompts) and counts["faults"] == 4
          and counts["given_up"] == 1 and counts["stopped"] == "InjectedCrash",
          f"[recovery] (a) give-up: {counts}, streams {[s is None for s in streams]}")
    print(f"[recovery] (a) give-up after {counts['faults']} consecutive faults: every handle "
          f"failed, stop() raised {counts['stopped']}; {len(cases)} near ties")
    print(f"[recovery] (a) recover() ms over {len(recover_ms)} recovers: min "
          f"{min(recover_ms):.3f}, median {float(np.median(recover_ms)):.3f}, max "
          f"{max(recover_ms):.3f}; requeued re-prefill ms (lockstep leg, "
          f"{len(prefill_ms)} prefills of {RECOVER_TRACE['prompt']}-token prompts): "
          f"{', '.join(f'{x:.2f}' for x in prefill_ms)}")


def _watchdog_legs(params, cfg):
    """(b): a slow_tick ten times the watchdog's budget fails the stalled
    handle within the budget plus slack; one at a tenth of it is harmless."""
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    prompt = _recover_prompts(cfg, 32)[0]
    want = generate_cached(params, cfg, prompt, 8)[0, prompt.size:].tolist()
    engine = Engine(params, cfg, num_slots=2, max_len=256)
    with ServingServer(engine) as warm:  # first ticks out of the window
        check(warm.submit(prompt, 8).result(timeout=120)[0] == want,
              "[recovery] (b) the warm-up stream differs from generate_cached")
    stall = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(
        faults.MID_DECODE_TICK, at=None, kind=faults.KIND_SLOW_TICK, delay=WATCHDOG_STALL)]))
    with faults.installed(stall):
        server = ServingServer(engine, watchdog_timeout=WATCHDOG_TIMEOUT)
        handle = server.submit(prompt, 8)
        t0 = time.perf_counter()
        server.start()
        try:
            handle.result(timeout=60)
            raise SmokeError("[recovery] (b) a stalled tick did not fail its handle")
        except RuntimeError as e:
            failed_after = time.perf_counter() - t0
            check(isinstance(e.__cause__, TimeoutError),
                  f"[recovery] (b) the stalled handle failed with {e.__cause__!r}")
        wedged = server._thread
        try:
            server.stop()
            raise SmokeError("[recovery] (b) stop() after a stall did not raise")
        except RuntimeError:
            pass
        wedged.join(WATCHDOG_STALL + 30)  # the stalled tick ends; its loop then exits
        check(not wedged.is_alive(), "[recovery] (b) the stalled loop never exited")
    check(failed_after < 2 * WATCHDOG_TIMEOUT,
          f"[recovery] (b) the stalled handle failed after {failed_after:.3f} s, past "
          f"{2 * WATCHDOG_TIMEOUT} s")
    engine = Engine(params, cfg, num_slots=2, max_len=256)
    slow = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(
        faults.MID_DECODE_TICK, at=1, kind=faults.KIND_SLOW_TICK,
        delay=0.1 * WATCHDOG_TIMEOUT)]))
    with faults.installed(slow):
        with ServingServer(engine, watchdog_timeout=WATCHDOG_TIMEOUT) as server:
            tokens, reason = server.submit(prompt, 8).result(timeout=120)
    check(slow.fired and tokens == want and reason == "length",
          f"[recovery] (b) a slow tick under budget changed the stream ({reason})")
    print(f"[recovery] (b) a {WATCHDOG_STALL:.1f} s stalled tick failed its handle after "
          f"{failed_after:.3f} s (watchdog {WATCHDOG_TIMEOUT} s) and stop() raised; a "
          f"{0.1 * WATCHDOG_TIMEOUT:.2f} s slow tick was harmless (stream equals "
          f"generate_cached)")


def _get_json(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _ops_legs(params, cfg):
    """(c): a server with a sentinel, the stock serving objectives and
    telemetry on an ephemeral port: every endpoint over HTTP, an injected
    latency cliff fired once, recovered and requeued with token parity by
    bind_default_remediations, then resolved; /readyz 503 after a give-up."""
    import re

    from gradaccum_tpu_torch.models.gpt_decode import generate_cached
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.obs.slo import SLOEvaluator, default_serving_objectives
    from gradaccum_tpu_torch.resilience import faults, remediation
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    n = 48
    prompts = _recover_prompts(cfg, 33)
    wants = [generate_cached(params, cfg, p, n)[0, p.size:].tolist() for p in prompts]
    engine = Engine(params, cfg, num_slots=4, max_len=256)
    snt = Sentinel(clock=lambda: float(engine.tick_count), cliff_warmup=8,
                   cliff_consecutive=2, cliff_score=50.0)
    server = ServingServer(engine, max_requeues=2, max_engine_faults=1, sentinel=snt,
                           slo=SLOEvaluator(default_serving_objectives()), telemetry_port=0)
    remediation.bind_default_remediations(snt, server=server)
    plain = engine.step

    def step():
        if engine.tick_count in CLIFF_TICKS:
            time.sleep(CLIFF_SLEEP)
        return plain()

    engine.step = step
    handles = [server.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)]
    server.start()
    tel = server.telemetry
    port = tel.port
    try:
        results = [h.result(timeout=300) for h in handles]
        cases = []
        for i, (p, (got, reason), w) in enumerate(zip(prompts, results, wants)):
            check(reason == "length", f"[recovery] (c) request {i} ended {reason}")
            _near_tie_check(f"(c) cliff request {i}", params, cfg, p, got, w, cases)
        states = [(a.kind, a.state) for a in snt.anomalies]
        check(states == [("latency_cliff", "fire"), ("latency_cliff", "resolve")],
              f"[recovery] (c) anomalies {states}")
        fire = snt.anomalies[0]
        got = {}
        for path in ("/metrics", "/healthz", "/readyz", "/varz", "/trace", "/slo", "/sentinel",
                     "/"):
            status, body = _get_json(tel.url(path))
            check(status == 200, f"[recovery] (c) {path} answered {status}")
            got[path] = body
        samples = [line for line in got["/metrics"].splitlines()
                   if line and not line.startswith("#")]
        sample_re = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')
        for line in samples:
            check(sample_re.match(line), f"[recovery] (c) /metrics line {line!r}")
            float(line.rsplit(" ", 1)[1])
        check("serving_tokens_emitted_total" in got["/metrics"], "[recovery] (c) /metrics "
              "lacks serving_tokens_emitted_total")
        varz = json.loads(got["/varz"])
        check(varz["metrics"]["tokens_emitted"] >= len(prompts) * n,
              f"[recovery] (c) /varz tokens {varz['metrics']['tokens_emitted']}")
        check("serve/ttft_p99" in json.loads(got["/slo"])["objectives"],
              "[recovery] (c) /slo lacks serve/ttft_p99")
        check(json.loads(got["/sentinel"])["anomalies"] == 2, "[recovery] (c) /sentinel")
        check("serve/recover" in {e["name"] for e in json.loads(got["/trace"])["traceEvents"]},
              "[recovery] (c) /trace holds no serve/recover")
        ready_before = json.loads(got["/readyz"])["ok"]
        # the give-up: two consecutive faulted ticks past max_engine_faults=1
        inj = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(
            faults.MID_DECODE_TICK, at=None, count=100)]))
        with faults.installed(inj):
            doomed = server.submit(prompts[0], 4)
            try:
                doomed.result(timeout=120)
                raise SmokeError("[recovery] (c) the give-up left a handle alive")
            except RuntimeError:
                pass
            ready_after, _ = _get_json(tel.url("/readyz"))
            health_after, _ = _get_json(tel.url("/healthz"))
    finally:
        try:
            server.stop()
            stopped = "ok"
        except RuntimeError:
            stopped = "raised"
    check(ready_before and ready_after == 503 and health_after == 503 and stopped == "raised",
          f"[recovery] (c) /readyz {ready_before} then {ready_after}, /healthz {health_after}, "
          f"stop() {stopped}")
    print(f"[recovery] (c) every endpoint answered on 127.0.0.1:{port} "
          f"({len(samples)} /metrics samples parsed); latency_cliff fired once at tick "
          f"{fire.at:.0f} (score {fire.detail['score']}), recover_and_requeue requeued the "
          f"streams token for token ({len(cases)} near ties), the anomaly resolved; /readyz "
          f"200 -> 503 and /healthz 503 after the give-up, stop() raised")


def _ops_training():
    """(d): the BERT-Small main path (bf16, micro 8 x K=4, scan), 2 updates
    with RunConfig(slos=, sentinel=) and without: losses and weights
    bitwise equal, the same kernel launches."""
    import torch

    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.obs.slo import SLOEvaluator, default_training_objectives
    from gradaccum_tpu_torch.ops import flash_attention as fa

    runs = {}
    for attach in (False, True):
        d = os.path.join(RECOVER_DIR, f"train_{attach}")
        shutil.rmtree(d, ignore_errors=True)
        kw = (dict(slos=SLOEvaluator(default_training_objectives()), sentinel=Sentinel())
              if attach else {})
        est = _bert_dp_estimator(mode="scan", model_dir=d, log_step_count_steps=1, **kw)
        fa.reset_launch_counts()
        est.train(_host_batches(2, 8 * K, seed=27), max_steps=2 * K)
        torch.cuda.synchronize()
        counts = dict(fa.launch_counts())
        est.close()
        runs[attach] = (_losses(d), {n: t.detach().cpu() for n, t in est._state.params.items()},
                        counts)
    (l0, p0, c0), (l1, p1, c1) = runs[False], runs[True]
    check(len(l0) == 2 and l0 == l1, f"[recovery] (d) losses differ: {l0} against {l1}")
    check(all(torch.equal(p0[n], p1[n]) for n in p0), "[recovery] (d) weights differ")
    check(c0 == c1 and all(c0.values()), f"[recovery] (d) launches {c0} against {c1}")
    print(f"[recovery] (d) BERT-Small bf16 scan, 2 updates: with slos and sentinel attached "
          f"the {len(l0)} losses and every weight are bitwise the run without; launches "
          f"{c0} in both")


def phase_recovery():
    """Phase 27: serving recovery, the watchdog and the live ops plane at
    GPT-Small width (phase 24's model), then the training side and the
    ops plane's cost. Only (d) launches flash kernels (the training step)."""
    import torch

    from gradaccum_tpu_torch.examples import bench_slo
    from gradaccum_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(RECOVER_DIR, exist_ok=True)
    fa.reset_launch_counts()
    smi = _smi()
    print(f"[recovery] on {smi}")
    cfg, params = _serve_model()
    marks = [("model", time.perf_counter())]
    _recover_legs(params, cfg)
    marks.append(("(a)", time.perf_counter()))
    _watchdog_legs(params, cfg)
    marks.append(("(b)", time.perf_counter()))
    _ops_legs(params, cfg)
    marks.append(("(c)", time.perf_counter()))
    counts = fa.launch_counts()
    check(not any(counts.values()), f"[recovery] flash kernels launched in (a)-(c): {counts}")
    _ops_training()
    marks.append(("(d)", time.perf_counter()))
    ratios = {}
    for model in ("small", "tiny"):
        result = bench_slo.main(["--device", "cuda", "--model", model, "--requests", "48",
                                 "--out", os.path.join(RECOVER_DIR, f"bench_slo_{model}.json")])
        serve = result["serve"]
        ratios[model] = serve["overhead_ratio"]
        print(f"[recovery] (e) bench_slo --model {model} on {smi}: baseline "
              f"{serve['baseline_s_per_tick'] * 1e3:.4f} ms per tick, ops plane "
              f"{serve['ops_plane_s_per_tick'] * 1e6:.3f} us per tick, ratio "
              f"{serve['overhead_ratio']:.6f} (gate {bench_slo.GATE})")
    marks.append(("(e)", time.perf_counter()))
    check(max(ratios.values()) <= bench_slo.GATE,
          f"[recovery] (e) the ops plane's cost per tick {ratios} exceeds {bench_slo.GATE}")
    prev, parts = t0, []
    for name, at in marks:
        parts.append(f"{name} {at - prev:.1f} s")
        prev = at
    print(f"[recovery] phase 27 took {time.perf_counter() - t0:.1f} s ({', '.join(parts)})")


# --------------------------------------------------------------------------
# phase 28: live reconfiguration and the replica fleet on one card
# --------------------------------------------------------------------------

RECONFIG_DIR = os.path.join(ROOT, "build", "chip_smoke_reconfig")
RECONFIG_ENGINE = dict(num_slots=4, max_len=256, page_size=16, decode_block=4)
RECONFIG_BLOCKS = 64   # 16,384 B x 16 positions a block: 16 MiB of K/V
RECONFIG_TICKS = 2     # ticks every stream runs before the reconfiguration


def _reconfig_run(engine, prompts, n, spec=None, ticks=RECONFIG_TICKS, between=None):
    """Submit ``prompts`` (``n`` new tokens, seed = index), step ``ticks``
    ticks, apply ``spec`` (timed; ``between(engine)`` instead when given), run
    to idle. Returns the streams, the result and the reconfigure() ms."""
    import torch

    rids = [engine.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)]
    for _ in range(ticks):
        engine.step()
    result, ms = None, None
    if spec is not None or between is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = between(engine) if between is not None else engine.reconfigure(spec)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    engine.run_until_idle()
    streams = []
    for rid in rids:
        tokens, status = engine.pop_result(rid)
        check(status == "done", f"[reconfig] request {rid} ended {status}")
        streams.append([int(t) for t in tokens])
    return streams, result, ms


def _against(tag, params, cfg, prompts, streams, wants, cases):
    for i, (p, got, want) in enumerate(zip(prompts, streams, wants)):
        _near_tie_check(f"{tag} request {i}", params, cfg, p, got, want, cases)


def _resize_legs(params, cfg, prompts, calm, n, cases, wall):
    """(a): grow under traffic (no preemption, the prefix cache kept), shrink
    through the host-swap and the re-prefill resume, and a shrink below
    demand refused with JAX's demand and supply."""
    import torch

    from gradaccum_tpu_torch.serving import Engine, ReconfigError, pool_resize

    pool_bytes = (RECONFIG_BLOCKS + 1) * RECONFIG_ENGINE["page_size"] * 16384
    engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, prefix_cache=True,
                    **RECONFIG_ENGINE)
    indexed, mem = [], []

    def grow(e):
        indexed.append(len(e.prefix_cache))
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        result = e.reconfigure(pool_resize(2 * RECONFIG_BLOCKS))
        torch.cuda.synchronize()
        mem.extend([torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()])
        indexed.append(len(e.prefix_cache))
        return result

    streams, res, ms = _reconfig_run(engine, prompts, n, between=grow)
    peak, kept = mem[1] - mem[0], mem[2] - mem[0]
    check(res.ok and res.preempted == 0 and res.detail["incremental"]
          and res.detail["segments"] == [RECONFIG_BLOCKS, RECONFIG_BLOCKS]
          and engine.metrics.preemptions == 0 and indexed[0] == indexed[1] > 0,
          f"[reconfig] (a) grow: {res.to_dict()}, {engine.metrics.preemptions} preemptions, "
          f"prefix entries {indexed}")
    _against("(a) grow", params, cfg, prompts, streams, calm, cases)
    wall["pool grow"] = ms
    print(f"[reconfig] (a) grow {RECONFIG_BLOCKS} -> {2 * RECONFIG_BLOCKS} blocks under "
          f"traffic: 0 preemptions, segments {res.detail['segments']}, {indexed[1]} prefix "
          f"entries kept, streams equal the calm run's; reconfigure() {ms:.3f} ms; across the "
          f"grow the card's allocation peaked {peak / 2**20:.2f} MiB above its level before "
          f"and kept {kept / 2**20:.2f} MiB, against the old pool's {pool_bytes / 2**20:.2f} MiB")
    for swap in ("host", "recompute"):
        engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, admission="optimistic",
                        swap=swap, **RECONFIG_ENGINE)
        streams, res, ms = _reconfig_run(engine, prompts, n,
                                         pool_resize(RECONFIG_BLOCKS // 2))
        m = engine.metrics
        resumed = m.swap_ins if swap == "host" else m.reprefills
        check(res.ok and res.preempted == len(prompts) and resumed == len(prompts),
              f"[reconfig] (a) shrink {swap}: {res.to_dict()}, swap-ins {m.swap_ins}, "
              f"re-prefills {m.reprefills}")
        _against(f"(a) shrink {swap}", params, cfg, prompts, streams, calm, cases)
        wall[f"shrink ({swap})"] = ms
        print(f"[reconfig] (a) shrink {RECONFIG_BLOCKS} -> {RECONFIG_BLOCKS // 2} blocks, "
              f"swap={swap}: {res.preempted} parked, {resumed} resumed by "
              f"{'swap-in' if swap == 'host' else 're-prefill'}, streams equal the calm run's; "
              f"reconfigure() {ms:.3f} ms")
    engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, **RECONFIG_ENGINE)
    for i, p in enumerate(prompts):
        engine.submit(p, n, rng_seed=i)
    engine.step()
    # JAX's floor: the largest single worst-case reservation, not the sum
    demand = max(-(-(p.size + n) // RECONFIG_ENGINE["page_size"]) for p in prompts)
    try:
        engine.reconfigure(pool_resize(2))
        raise SmokeError("[reconfig] (a) a shrink below demand was not refused")
    except ReconfigError as e:
        check(e.demand == demand and e.supply == 2 and engine.num_blocks == RECONFIG_BLOCKS,
              f"[reconfig] (a) refusal demand {e.demand} supply {e.supply}, want {demand}/2")
    engine.run_until_idle()
    print(f"[reconfig] (a) a shrink to 2 blocks refused: demand {demand}, supply 2, nothing "
          f"changed")


def _ckpt_legs(params, cfg, prompts, calm, n, cases, wall):
    """(b): identical weights through the port's checkpoint (swapped K/V
    kept), changed weights (the continuation is generate_cached under them),
    a rotted checkpoint (ok=False, the old weights keep serving)."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import gpt_lm_bundle
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached
    from gradaccum_tpu_torch.serving import Engine, checkpoint_swap
    from gradaccum_tpu_torch.serving import reconfig

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    digest = reconfig.params_digest(params)
    digest_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = sum(t.numel() * t.element_size() for t in reconfig._leaves(params))
    d = os.path.join(RECONFIG_DIR, "ckpt")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    path = ckpt.save(d, {"params": params, "step": 1}, step=1)
    save_s = time.perf_counter() - t0
    engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, **RECONFIG_ENGINE)
    streams, res, ms = _reconfig_run(engine, prompts, n, checkpoint_swap(checkpoint=d))
    check(res.ok and res.detail["weights_unchanged"] and res.preempted == len(prompts)
          and engine.metrics.swap_ins == len(prompts)
          and reconfig.params_digest(engine.params) == digest,
          f"[reconfig] (b) same weights: {res.to_dict()}, swap-ins {engine.metrics.swap_ins}")
    _against("(b) same weights", params, cfg, prompts, streams, calm, cases)
    wall["checkpoint swap (file, same weights)"] = ms
    print(f"[reconfig] (b) params_digest of GPT-Small ({nbytes / 2**20:.1f} MiB, copied to the "
          f"host) {digest_ms:.1f} ms; checkpoint saved in {save_s:.2f} s; the swap from it "
          f"kept the swapped K/V ({engine.metrics.swap_ins} swap-ins), streams equal the calm "
          f"run's; reconfigure() {ms:.1f} ms (restore, two digests, park, resume set-up)")
    other = params_tree(gpt_lm_bundle(cfg).init(SERVE_SEED + 1, "cuda"))
    engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, **RECONFIG_ENGINE)
    gen = {}

    def swap(e):
        gen.update({i: len(e.results[rid]) for i, rid in enumerate(sorted(e.results))})
        return e.reconfigure(checkpoint_swap(params=other))

    streams, res, ms = _reconfig_run(engine, prompts, n, between=swap)
    check(res.ok and not res.detail["weights_unchanged"] and engine.metrics.swap_ins == 0
          and engine.metrics.reprefills == len(prompts),
          f"[reconfig] (b) new weights: {res.to_dict()}")
    for i, (p, got) in enumerate(zip(prompts, streams)):
        g = gen[i]
        _near_tie_check(f"(b) before the swap, request {i}", params, cfg, p, got[:g],
                        calm[i][:g], cases)
        ext = np.concatenate([p, np.asarray(got[:g], np.int32)])
        want = generate_cached(other, cfg, ext, n - g)[0, ext.size:].tolist()
        _near_tie_check(f"(b) new weights, request {i}", other, cfg, ext, got[g:], want, cases)
    wall["checkpoint swap (in memory, new weights)"] = ms
    print(f"[reconfig] (b) new weights in memory after {sorted(gen.values())} tokens: every "
          f"continuation equals generate_cached of prompt + generated under them "
          f"({engine.metrics.reprefills} re-prefills, no swap-in); reconfigure() {ms:.1f} ms")
    del other
    with open(path, "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff\xff")
    engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, **RECONFIG_ENGINE)
    streams, res, ms = _reconfig_run(engine, prompts, n, checkpoint_swap(checkpoint=d))
    check(not res.ok and res.detail["quarantined"] and res.preempted == 0
          and "rejected" in res.reason and engine.metrics.reconfig_failures == 1,
          f"[reconfig] (b) rotted checkpoint: {res.to_dict()}")
    _against("(b) rotted checkpoint", params, cfg, prompts, streams, calm, cases)
    print(f"[reconfig] (b) a rotted checkpoint: ok=False, quarantined "
          f"({sorted(os.listdir(d))}), the old weights kept serving the calm streams")


def _kill_legs(params, cfg, prompts, calm, n, cases, wall):
    """(c): MID_RECONFIG kills at 2n and at 2n+1 of the retry, then a clean
    retry; the streams are the calm ones."""
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, pool_resize

    engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, admission="optimistic",
                    swap="host", **RECONFIG_ENGINE)
    inj = faults.FaultInjector(faults.FaultSchedule([
        faults.FaultSpec(faults.MID_RECONFIG, at=0), faults.FaultSpec(faults.MID_RECONFIG, at=3)]))
    states = []

    def kills(e):
        with faults.installed(inj):
            for _ in range(3):
                try:
                    states.append(e.reconfigure(pool_resize(RECONFIG_BLOCKS // 2)).ok)
                except faults.InjectedCrash:
                    states.append((e.num_blocks, e.pool.active_count))
                e.step()
        return None

    streams, _, _ = _reconfig_run(engine, prompts, n, between=kills)
    check([tuple(f) for f in inj.fired] == [("mid_reconfig", 0, "crash"),
                                           ("mid_reconfig", 3, "crash")]
          and states[0] == (RECONFIG_BLOCKS, 0) and states[1][0] == RECONFIG_BLOCKS // 2
          and states[2] is True and engine._reconfig_count == 3,
          f"[reconfig] (c) fired {inj.fired}, states {states}")
    _against("(c) MID_RECONFIG", params, cfg, prompts, streams, calm, cases)
    print(f"[reconfig] (c) MID_RECONFIG kills at 0 (old pool, all parked) and 3 (new pool, "
          f"all parked), then a clean retry: streams equal the calm run's")


def _fleet_legs(params, cfg, prompts, calm, n, cases, wall):
    """(d): two replicas sharing the card: the weights once, a pool each;
    lockstep streams, drain/activate through the server with rebound
    handles, a seeded replica_kill taken through DEAD to excise to add, and
    the free-running server's two loop threads."""
    import torch

    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import (ReplicatedEngine, ServingServer, fleet as fl,
                                             reconfig, replica_activate, replica_add,
                                             replica_drain, replica_excise)

    def make(**kw):
        return ReplicatedEngine(params, cfg, replicas=2, tp=1, num_blocks=RECONFIG_BLOCKS,
                                **dict(RECONFIG_ENGINE, **kw))

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fleet = make()
    torch.cuda.synchronize()
    added = (torch.cuda.memory_allocated() - before) / 2
    shared = all(a is b for a, b in zip(reconfig._leaves(fleet.replicas[0].params),
                                        reconfig._leaves(params)))
    check(shared, "[reconfig] (d) a replica copied the weights")
    rids = [fleet.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)]
    fleet.run_until_idle()
    streams = [[int(t) for t in fleet.pop_result(r)[0]] for r in rids]
    check(len(set(rids)) == len(rids) and {r % 2 for r in rids} == {0, 1},
          f"[reconfig] (d) ids {rids}")
    _against("(d) lockstep fleet", params, cfg, prompts, streams, calm, cases)
    print(f"[reconfig] (d) two replicas on the card share the weights (no copy); each adds "
          f"{added / 2**20:.2f} MiB (its pool and slot state); lockstep streams equal one "
          f"engine's, ids {rids} unique on the two lattices")
    # drain and activate through the lockstep server: handles rebound
    server = ServingServer(fleet).start()
    try:
        handles = [server.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)]
        for h in handles:
            next(iter(h))
        t0 = time.perf_counter()
        res = server.reconfigure(replica_drain(1), timeout=300)
        wall["replica drain (server)"] = 1e3 * (time.perf_counter() - t0)
        out = [h.result(timeout=300) for h in handles]
        t0 = time.perf_counter()
        back = server.reconfigure(replica_activate(1), timeout=300)
        wall["replica activate (server)"] = 1e3 * (time.perf_counter() - t0)
    finally:
        server.stop()
    check(res.ok and res.detail["resubmitted"] and back.ok and fleet.active_replicas == [0, 1],
          f"[reconfig] (d) drain {res.to_dict()}, activate {back.to_dict()}")
    _against("(d) drain", params, cfg, prompts, [[int(t) for t in o[0]] for o in out], calm,
             cases)
    print(f"[reconfig] (d) replica_drain(1) under traffic moved {len(res.detail['resubmitted'])} "
          f"streams with their handles rebound, streams equal the calm run's; activate ok")
    # a seeded replica_kill at FLEET_STEP: DEAD on the tick clock, excise, add
    fleet = make(fleet_lease_ttl=5.0, fleet_suspect_after=2.0)
    rids = {fleet.submit(p, n, rng_seed=i): i for i, p in enumerate(prompts)}
    plan = faults.FaultSchedule([faults.FaultSpec(faults.FLEET_STEP, at=3,
                                                  kind=faults.KIND_REPLICA_KILL, target=1)])
    with faults.installed(faults.FaultInjector(plan)):
        for _ in range(60):
            fleet.step()
            if fleet.fleet.state(1) == fl.DEAD:
                break
    dead_tick = fleet.tick_count
    t0 = time.perf_counter()
    res = fleet.reconfigure(replica_excise(1))
    wall["replica excise"] = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    add = fleet.reconfigure(replica_add())
    torch.cuda.synchronize()
    wall["replica add"] = 1e3 * (time.perf_counter() - t0)
    add_bytes = torch.cuda.memory_allocated() - before
    moved = res.detail["resubmitted"]
    fleet.run_until_idle()
    streams = [None] * len(prompts)
    for rid, i in rids.items():
        tokens, status = fleet.pop_result(moved.get(rid, rid))
        check(status == "done", f"[reconfig] (d) request {rid} ended {status}")
        streams[i] = [int(t) for t in tokens]
    proof = res.detail["excise_proof"]
    check(res.ok and proof["valid"] and proof["absent"] == [1] and add.ok
          and fleet.fleet.state(1) == fl.EXCISED and fleet.active_replicas == [0, 2],
          f"[reconfig] (d) excise {res.to_dict()}, add {add.to_dict()}")
    _against("(d) kill/excise", params, cfg, prompts, streams, calm, cases)
    print(f"[reconfig] (d) replica_kill at FLEET_STEP 3: DEAD at fleet tick {dead_tick} "
          f"(lease 5 ticks), excise proof {proof}, {len(moved)} streams replayed on the "
          f"survivor, replica_add +{add_bytes / 2**20:.2f} MiB on the card while serving; "
          f"streams equal the calm run's")
    # free running: one loop thread per replica
    fleet = make()
    server = ServingServer(fleet, free_running=True).start()
    try:
        out = [h.result(timeout=300) for h in
               [server.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)]]
        st = server.stats()
    finally:
        server.stop()
    check(st["free_running"] and all(p["tick"] > 0 for p in st["per_replica"]),
          f"[reconfig] (d) free running: {[p['tick'] for p in st['per_replica']]}")
    _against("(d) free running", params, cfg, prompts, [[int(t) for t in o[0]] for o in out],
             calm, cases)
    print(f"[reconfig] (d) free-running server, two loop threads (ticks "
          f"{[p['tick'] for p in st['per_replica']]}): streams equal the calm run's")


def phase_reconfig():
    """Phase 28: live reconfiguration and the replica fleet at GPT-Small
    width (phase 24's model) on the paged pool, then the two benches. No
    flash kernel launches in (a)-(d)."""
    import torch

    from gradaccum_tpu_torch.examples import bench_fleet, bench_reconfig
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(RECONFIG_DIR, exist_ok=True)
    smi = _smi()
    print(f"[reconfig] on {smi}")
    cfg, params = _serve_model()
    n = RECOVER_TRACE["new"]
    prompts = _recover_prompts(cfg, 40)
    fa.reset_launch_counts()
    calm = _reconfig_run(Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, **RECONFIG_ENGINE),
                         prompts, n)[0]
    marks = [("model and calm run", time.perf_counter())]
    cases, wall = [], {}
    _resize_legs(params, cfg, prompts, calm, n, cases, wall)
    marks.append(("(a)", time.perf_counter()))
    _ckpt_legs(params, cfg, prompts, calm, n, cases, wall)
    marks.append(("(b)", time.perf_counter()))
    _kill_legs(params, cfg, prompts, calm, n, cases, wall)
    marks.append(("(c)", time.perf_counter()))
    _fleet_legs(params, cfg, prompts, calm, n, cases, wall)
    marks.append(("(d)", time.perf_counter()))
    counts = fa.launch_counts()
    check(not any(counts.values()), f"[reconfig] flash kernels launched in (a)-(d): {counts}")
    print(f"[reconfig] reconfigure() wall ms on {smi}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in wall.items())
          + f"; {len(cases)} near ties; flash launches {dict(counts)}")
    rec = bench_reconfig.main(["--device", "cuda", "--json",
                               os.path.join(RECONFIG_DIR, "bench_reconfig.json")])
    fleet = bench_fleet.main(["--device", "cuda", "--json",
                              os.path.join(RECONFIG_DIR, "bench_fleet.json")])
    acc = rec["acceptance"]
    check(acc["passed"], f"[reconfig] (e) bench_reconfig: {acc}")
    check(fleet["acceptance"]["passed"], f"[reconfig] (e) bench_fleet: {fleet['acceptance']} "
                                         f"{fleet['supervised']} {fleet['no_excision']}")
    print(f"[reconfig] (e) bench_reconfig on {smi}: live/stop-the-world availability "
          f"{acc['availability_ratio_resize']} (resize), {acc['availability_ratio_ckpt_swap']} "
          f"(checkpoint swap), gate {bench_reconfig.GATE}; bench_fleet: supervised "
          f"{fleet['supervised']['availability']} against {fleet['no_excision']['availability']} "
          f"= {fleet['availability_ratio']} (gate {bench_fleet.GATE}), MTTR "
          f"{fleet['supervised']['mttr_ticks']} ticks; both with parity")
    marks.append(("(e)", time.perf_counter()))
    prev, parts = t0, []
    for name, at in marks:
        parts.append(f"{name} {at - prev:.1f} s")
        prev = at
    print(f"[reconfig] phase 28 took {time.perf_counter() - t0:.1f} s ({', '.join(parts)})")


# --------------------------------------------------------------------------
# phase 29: the self-healing ladder on one card
# --------------------------------------------------------------------------

HEAL_DIR = os.path.join(ROOT, "build", "chip_smoke_heal")
HEAL_ENGINE = dict(RECONFIG_ENGINE, decode_block=1)  # one token a tick: windows count ticks
HEAL_ARM = 12        # healthy ticks the sentinel sees before the degradation arms: the
                     # prefill tick's weight in the EWMA baseline decays to 3 %
HEAL_VERIFY = 4.0    # ticks a rung gets before the ladder escalates ((b), (c))


def _heal_sentinel(clock, **kw):
    """A sentinel on ``clock``; a degraded tick scores tens of deviations, 12
    keeps a lone host hiccup below the line."""
    from gradaccum_tpu_torch.obs.sentinel import Sentinel

    knobs = dict(cliff_warmup=4, cliff_consecutive=2, cliff_score=12.0, lease=1e9)
    knobs.update(kw)
    return Sentinel(clock=clock, **knobs)


def _heal_marks(snt, kind):
    """Wall times of ``kind``'s fire and resolve records: [(state, tick, s)]."""
    marks = []
    snt.on(kind, lambda a: marks.append(("fire", a.at, time.perf_counter())))
    snt.on_resolve(kind, lambda a: marks.append(("resolve", a.at, time.perf_counter())))
    return marks


def _fire_to_resolve(marks, tag):
    fire = next((m for m in marks if m[0] == "fire"), None)
    resolve = next((m for m in marks if m[0] == "resolve" and fire and m[1] >= fire[1]), None)
    check(fire is not None and resolve is not None, f"[heal] {tag}: no fire->resolve in {marks}")
    return resolve[1] - fire[1], 1e3 * (resolve[2] - fire[2])


def _served_streams(server, prompts, n):
    """Submit every request before the loop starts (the arm tick then lands
    on the same traffic), serve, stop; the streams and finish reasons."""
    handles = [server.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)]
    server.start()
    try:
        out = [h.result(timeout=300) for h in handles]
    finally:
        server.stop()
    return [[int(t) for t in toks] for toks, _ in out], [r for _, r in out]


def _heal_lockstep(params, cfg, prompts, calm, n, cases):
    """(a) and (b): the lockstep server with the stock ladders."""
    import torch

    from gradaccum_tpu_torch.examples.chaos_smoke import DEGRADE_FACTOR, degrade, tick_median
    from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
    from gradaccum_tpu_torch.resilience.healer import Healer, default_ladders
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    cliff = obs_sentinel.LATENCY_CLIFF
    stock = {k: [r.name for r in v] for k, v in default_ladders(server=object()).items()}
    out = {}
    for leg, healable in (("(a)", True), ("(b)", False)):
        engine = Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, **HEAL_ENGINE)
        median = tick_median(engine, prompts)
        delay = DEGRADE_FACTOR * median
        wedge = degrade(engine, engine.tick_count + HEAL_ARM, delay, healable=healable)
        snt = _heal_sentinel(lambda e=engine: float(e.tick_count), lease=60.0)
        marks = _heal_marks(snt, cliff)
        server = ServingServer(engine, max_requeues=6, max_engine_faults=6, sentinel=snt)
        healer = Healer(snt, default_ladders(server=server),
                        verify_window=20.0 if healable else HEAL_VERIFY, cooldown=0.5)
        server.attach_healer(healer)
        grow_ms = []
        plain_reconfigure = engine.reconfigure

        def reconfigure(spec, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = plain_reconfigure(spec, **kw)
            torch.cuda.synchronize()
            grow_ms.append(1e3 * (time.perf_counter() - t0))
            return result

        engine.reconfigure = reconfigure
        polls = []  # the healer's cost on the loop: seconds of each poll
        plain_poll = healer.poll

        def poll(now=None):
            t0 = time.perf_counter()
            taken = plain_poll(now)
            polls.append(time.perf_counter() - t0)
            return taken

        healer.poll = poll
        streams, reasons = _served_streams(server, prompts, n)
        st = server.stats()
        check(all(r in ("eos", "length") for r in reasons), f"[heal] {leg} reasons {reasons}")
        _against(f"{leg} heal", params, cfg, prompts, streams, calm, cases)
        manifest = engine.manifest()["healer"]
        check(manifest["ladders"] == stock, f"[heal] {leg} manifest ladders {manifest}")
        if healable:
            heal = healer.heal_log[0] if healer.heal_log else {}
            check(healer.healed_total >= 1 and heal.get("action") == "recover_requeue"
                  and heal.get("kind") == cliff and st["healer"]["healed_total"] >= 1
                  and wedge["armed"] and not wedge["on"] and not healer.frozen(),
                  f"[heal] (a) healer {healer.status()}, wedge {wedge}")
            ticks, ms = _fire_to_resolve(marks, "(a)")
            poll_us = 1e6 * sorted(polls)[len(polls) // 2]
            out["a"] = dict(ticks=ticks, ms=ms, median_ms=1e3 * median, delay_ms=1e3 * delay,
                            mttr=heal["mttr"], poll_us=poll_us)
            print(f"[heal] (a) lockstep, healthy tick {1e3 * median:.3f} ms (median of the "
                  f"warm-up), degraded {1e3 * delay:.1f} ms from tick {HEAL_ARM} on: "
                  f"latency_cliff fired and the recover_requeue rung healed it, fire->resolve "
                  f"{ticks:.0f} ticks = {ms:.1f} ms; healed_total {st['healer']['healed_total']}; "
                  f"manifest ladders {manifest['ladders'][cliff]}; healer.poll median "
                  f"{poll_us:.1f} us over {len(polls)} calls on the loop "
                  f"({poll_us / (1e4 * median):.3f} % of a healthy tick); streams equal the calm "
                  f"run's")
            continue
        frozen = healer.frozen()
        fires = [a for a in snt.anomalies
                 if a.kind == obs_sentinel.HEALER_FROZEN and a.state == "fire"]
        result = engine.last_reconfig
        by_init = dict(engine.metrics.reconfigs_by_initiator)
        check(frozen == [{"kind": cliff, "replica": None, "why": "exhausted"}]
              and len(fires) == 1 and fires[0].severity == "page"
              # the page carries the ladder's snapshot at the freeze: no action after it
              and fires[0].detail["healer"]["actions_total"] == healer.actions_total
              and st["healer"]["frozen_total"] == 1,
              f"[heal] (b) frozen {frozen}, healer_frozen {[a.to_dict() for a in fires]}, "
              f"{healer.actions_total} actions, anomalies "
              f"{[(a.kind, a.state, a.at) for a in snt.anomalies]}, wedge {wedge}")
        check(result is not None and result.ok and result.kind == "pool_resize"
              and result.initiator == "healer" and by_init == {"healer": 1}
              and engine.num_blocks > RECONFIG_BLOCKS and len(grow_ms) == 1,
              f"[heal] (b) reconfig {result and result.to_dict()}, by initiator {by_init}, "
              f"{engine.num_blocks} blocks")
        out["b"] = dict(grow_ms=grow_ms[0], blocks=engine.num_blocks, actions=healer.actions_total)
        print(f"[heal] (b) recover does not clear it: the ladder walked recover_requeue -> "
              f"(replica_drain skipped) -> pool_grow {RECONFIG_BLOCKS}->{engine.num_blocks} "
              f"blocks (initiator {result.initiator}, {grow_ms[0]:.1f} ms on the loop) -> "
              f"frozen exhausted; healer_frozen once at severity {fires[0].severity}, "
              f"{healer.actions_total} actions, none after the freeze; streams equal the calm "
              f"run's")
    return out


def _heal_fleet(params, cfg, prompts, calm, n, cases):
    """(c): a free-running fleet of two replicas on the card."""
    from gradaccum_tpu_torch.examples.chaos_smoke import DEGRADE_FACTOR, degrade, tick_median
    from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
    from gradaccum_tpu_torch.obs import trace as obs_trace
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.resilience.healer import Healer, default_ladders
    from gradaccum_tpu_torch.serving import ReplicatedEngine, ServingServer, fleet as fl

    def make(**kw):
        return ReplicatedEngine(params, cfg, replicas=2, tp=1, num_blocks=RECONFIG_BLOCKS,
                                **dict(HEAL_ENGINE, **kw))

    def clock_of(fleet):
        return lambda: float(max(e.tick_count for e in fleet.replicas))

    # replica 1 degrades; the recover is routed to its loop alone
    fleet = make()
    median = tick_median(fleet, prompts)
    delay = DEGRADE_FACTOR * median
    wedge = degrade(fleet.replicas[1], fleet.replicas[1].tick_count + HEAL_ARM, delay)
    calm0 = degrade(fleet.replicas[0], 1 << 30, 0.0)  # counts replica 0's recovers only
    snt = _heal_sentinel(clock_of(fleet))
    server = ServingServer(fleet, max_requeues=6, max_engine_faults=6, sentinel=snt,
                           free_running=True)
    healer = Healer(snt, default_ladders(server=server), verify_window=1e4, cooldown=0.5)
    server.attach_healer(healer)
    streams, reasons = _served_streams(server, prompts, n)
    heals = [h for h in healer.heal_log if h["replica"] == 1]
    check(heals and heals[0]["action"] == "recover_requeue" and wedge["recovers"] >= 1
          and not wedge["on"] and calm0["recovers"] == 0,
          f"[heal] (c) heals {healer.heal_log}, replica 1 recovers {wedge['recovers']}, "
          f"replica 0 recovers {calm0['recovers']}")
    check(all(r in ("eos", "length") for r in reasons), f"[heal] (c) reasons {reasons}")
    _against("(c) degraded replica", params, cfg, prompts, streams, calm, cases)
    print(f"[heal] (c) free-running fleet of two: replica 1 degraded ({1e3 * delay:.1f} ms a "
          f"tick), its latency_cliff healed by recover_requeue on its own loop (MTTR "
          f"{heals[0]['mttr']:.0f} fleet ticks), replica 0 never recovered; streams equal the "
          f"calm run's")

    # a killed replica walks the dead_replica ladder (cliff detection off:
    # the survivor's replays are planned load, not a cliff to drain it for)
    fleet = make(fleet_lease_ttl=5.0, fleet_suspect_after=2.0)
    snt = _heal_sentinel(clock_of(fleet), cliff_score=1e9)
    server = ServingServer(fleet, max_requeues=6, max_engine_faults=6, sentinel=snt,
                           free_running=True)
    tracer = obs_trace.Tracer(capacity=None)
    healer = Healer(snt, default_ladders(server=server), verify_window=HEAL_VERIFY,
                    cooldown=0.5, tracer=tracer)
    server.attach_healer(healer)
    marks = _heal_marks(snt, obs_sentinel.DEAD_REPLICA)
    with obs_trace.installed(tracer):
        handles = [server.submit(p, n, rng_seed=i) for i, p in enumerate(prompts + prompts)]
        server.start()
        try:
            deadline = time.monotonic() + 60
            while fleet.replicas[1].tick_count < 3 and time.monotonic() < deadline:
                time.sleep(0.001)
            fleet.fleet.inject(faults.KIND_REPLICA_KILL, 1)  # its streams are running
            killed_at = fleet.replicas[1].tick_count
            out = [h.result(timeout=300) for h in handles]
            deadline = time.monotonic() + 60
            while len(fleet.replicas) < 3 and time.monotonic() < deadline:
                time.sleep(0.01)  # the chained add settles after the heal
        finally:
            server.stop()
    applied = [e["args"]["action"] for e in tracer.snapshot()
               if e["name"] == "healer/transition" and e["args"]["reason"] == "apply"]
    added = [e["args"] for e in tracer.snapshot()
             if e["name"] == "serve/reconfig" and e["args"].get("action") == "add"]
    heal = next((h for h in healer.heal_log if h["kind"] == obs_sentinel.DEAD_REPLICA), {})
    check(applied[:2] == ["recover_requeue", "replica_excise"]
          and heal.get("action") == "replica_excise" and heal.get("replica") == 1
          and fleet.fleet.state(1) == fl.EXCISED and fleet.active_replicas == [0, 2]
          and added and all(a.get("initiator") == "healer" for a in added),
          f"[heal] (c) applied {applied}, heal {heal}, states {fleet.fleet.states()}, "
          f"active {fleet.active_replicas}, adds {added}")
    both = prompts + prompts
    check(all(r in ("eos", "length") for _, r in out), f"[heal] (c) kill reasons")
    _against("(c) killed replica", params, cfg, both, [[int(t) for t in o[0]] for o in out],
             calm + calm, cases)
    ticks, ms = _fire_to_resolve(marks, "(c) dead_replica")
    print(f"[heal] (c) replica 1 killed at its tick {killed_at} while serving: dead_replica "
          f"fired at DEAD, the ladder applied {applied} (recover on the dead loop, then a "
          f"proof-gated excise; the heal credited to {heal['action']}), fire->resolve "
          f"{ticks:.0f} fleet ticks = {ms:.1f} ms; the chained replica_add (initiator "
          f"{added[0]['initiator']}) made the fleet {fleet.active_replicas}; {len(both)} "
          f"streams, the displaced ones replayed on the survivor, equal the calm run's")
    return {"c_kill_ticks": ticks, "c_kill_ms": ms}


def phase_heal():
    """Phase 29: the self-healing ladder at GPT-Small width (phase 24's
    model, phase 28's requests), then bench_heal and chaos_smoke on the
    card. No flash kernel launches in (a)-(c)."""
    import torch

    from gradaccum_tpu_torch.examples import bench_heal, chaos_smoke
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(HEAL_DIR, exist_ok=True)
    smi = _smi()
    print(f"[heal] on {smi}")
    cfg, params = _serve_model()
    n = RECOVER_TRACE["new"]
    prompts = _recover_prompts(cfg, 40)
    fa.reset_launch_counts()
    calm = _reconfig_run(Engine(params, cfg, num_blocks=RECONFIG_BLOCKS, **HEAL_ENGINE),
                         prompts, n)[0]
    marks = [("model and calm run", time.perf_counter())]
    cases = []
    lock = _heal_lockstep(params, cfg, prompts, calm, n, cases)
    marks.append(("(a)+(b)", time.perf_counter()))
    _heal_fleet(params, cfg, prompts, calm, n, cases)
    marks.append(("(c)", time.perf_counter()))
    counts = fa.launch_counts()
    check(not any(counts.values()), f"[heal] flash kernels launched in (a)-(c): {counts}")
    print(f"[heal] flash launches in (a)-(c): {dict(counts)}; {len(cases)} near ties")
    heal = bench_heal.main(["--fast", "--device", "cuda", "--json",
                            os.path.join(HEAL_DIR, "bench_heal.json")])
    chaos = chaos_smoke.main(["--device", "cuda", "--json",
                              os.path.join(HEAL_DIR, "chaos_smoke.json")])
    check(heal["acceptance"]["passed"], f"[heal] (d) bench_heal: ratio {heal['mttr_ratio']}, "
                                        f"flap {heal['flap']}")
    check(chaos["acceptance"]["passed"], "[heal] (d) chaos_smoke failed: "
          + str({k: v for k, v in chaos["detail"].items() if k == "failed"}))
    print(f"[heal] (d) bench_heal --fast on {smi}: MTTR healer "
          f"{heal['healer']['mean_mttr_ticks']} against operator stub "
          f"{heal['operator_stub']['mean_mttr_ticks']} ticks = ratio {heal['mttr_ratio']} "
          f"(JAX's gate {bench_heal.GATE}), flap leg terminal {heal['flap']['terminal']} "
          f"({heal['flap']['frozen_reason']}); chaos_smoke seed {chaos['seed']} acceptance "
          f"{chaos['acceptance']['passed']}, ops leg's slow ticks scored "
          f"{chaos['detail']['ops']['serve']['cliff_score']['fired']} against "
          f"{chaos['detail']['ops']['serve']['cliff_score']['threshold']} (phases "
          + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in chaos["detail"].items()
                      if isinstance(v, dict) and "seconds" in v) + ")")
    marks.append(("(d)", time.perf_counter()))
    prev, parts = t0, []
    for name, at in marks:
        parts.append(f"{name} {at - prev:.1f} s")
        prev = at
    print(f"[heal] phase 29 took {time.perf_counter() - t0:.1f} s ({', '.join(parts)}); "
          f"(a) fire->resolve {lock['a']['ticks']:.0f} ticks = {lock['a']['ms']:.1f} ms, (b) "
          f"pool grow {lock['b']['grow_ms']:.1f} ms")


# --------------------------------------------------------------------------
# phase 30: the serving mesh
# --------------------------------------------------------------------------

MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_serving_mesh")
MESH_TP = 2
# nanoGPT's padded GPT-2 vocabulary: the model axis must divide it (JAX's
# Engine(mesh=) refuses 50257, which is odd); prompts draw ids below 50257
MESH_VOCAB, MESH_IDS = 50304, 50257
MESH_ENGINE = dict(num_slots=8, max_len=256, decode_block=4)
MESH_PAGE = dict(page_size=16)  # 128 blocks of 16: the fixed pool's bytes
MESH_SEED = 30  # the SimulationDriver trace's seed
MESH_TRACE = dict(n_requests=6, arrival_rate=1.0, prompt_len=(16, 96), max_new=(8, 16))
MESH_SPEC_K = 4
MESH_SPEC_N, MESH_SPEC_NEW = 3, 8  # the speculative leg: the trace's first 3
                                   # requests, at most 8 new tokens each
MESH_NEW = 12   # (b), (c): new tokens of each of 4 requests (prompts 32-96)
MESH_AT = 1     # (b): the tick of the fault, the preemption and the grow
MESH_GROW = 160  # (b): blocks after the grow
MESH_TICKS = 4  # the timing windows: ticks with 8 slots decoding
# what the parent writes for the ranks: (b)'s checkpoint is saved, so the
# legs may start; serving_smoke, bench_serving and the one-process runs
# (all beside the ranks' start-up and legs) are done, so the timing windows
# have the card to themselves
MESH_LEGS, MESH_TIMING = "legs_go", "timing_go"


def _mesh_model():
    """GPT-Small (L-4 H-512 A-8, FFN 2048, 512 positions) at the padded
    vocabulary, float32, random weights from SERVE_SEED, as the decode tree."""
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    cfg = GPTConfig.small(vocab_size=MESH_VOCAB, dropout=0.0)
    return cfg, params_tree(gpt_lm_bundle(cfg).init(SERVE_SEED, "cuda"))


def _mesh_prompts():
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED + 30)
    return [rng.integers(0, MESH_IDS, int(rng.integers(32, 97))).astype(np.int32)
            for _ in range(4)]


def _mesh_records(engine, tag, n=None, cap=None):
    """The seeded trace (its first ``n`` requests, at most ``cap`` new
    tokens each) through SimulationDriver: ``(trace, streams, request ids)``,
    every request done and one tick signature."""
    import dataclasses

    from gradaccum_tpu_torch.serving import SimulationDriver

    driver = SimulationDriver(engine, seed=MESH_SEED)
    trace = driver.make_trace(vocab_size=MESH_IDS, **dict(MESH_TRACE, n_requests=n or
                                                          MESH_TRACE["n_requests"]))
    if cap is not None:
        trace = [dataclasses.replace(item, max_new_tokens=min(item.max_new_tokens, cap))
                 for item in trace]
    records = driver.run(trace)
    for rec in records:
        check(rec["status"] == "done", f"[mesh] {tag}: request {rec['request_id']} ended "
                                       f"{rec['status']}")
    for e in getattr(engine, "replicas", [engine]):
        check(e.decode_compile_count() == 1,
              f"[mesh] {tag}: {e.decode_compile_count()} tick signatures")
    return (trace, [[int(t) for t in rec["tokens"]] for rec in records],
            [int(rec["request_id"]) for rec in records])


def _mesh_drive(engine, prompts, n, actions=None):
    """``prompts`` submitted at once (``n`` new, seed = index), run to idle;
    ``actions[tick](engine)`` runs (timed) before that tick, and a crash is
    recovered and its requests resubmitted. Returns the streams, ``{tick:
    (result, ms)}`` and the seeds recovered."""
    import torch

    from gradaccum_tpu_torch.resilience import faults

    rids = {i: engine.submit(p, n, rng_seed=i) for i, p in enumerate(prompts)}
    actions, done, failed = dict(actions or {}), {}, []
    while not engine.idle:
        act = actions.pop(engine.tick_count, None)
        if act is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = act(engine)
            torch.cuda.synchronize()
            done[engine.tick_count] = (result, 1e3 * (time.perf_counter() - t0))
        try:
            engine.step()
        except faults.InjectedCrash:
            for req in engine.recover():
                failed.append(req.rng_seed)
                rids[req.rng_seed] = engine.submit(req.prompt, req.max_new_tokens,
                                                   rng_seed=req.rng_seed)
    check(not actions, f"[mesh] the actions at ticks {sorted(actions)} never ran")
    streams = []
    for i in range(len(prompts)):
        tokens, status = engine.pop_result(rids[i])
        check(status == "done", f"[mesh] request {i} ended {status}")
        streams.append([int(t) for t in tokens])
    return streams, done, failed


class _GlooTimer:
    """Host seconds inside gloo's all-reduce and all-gather while entered,
    the card synchronized before each (gloo copies a CUDA tensor to the
    host after the kernels queued before it, which are not its time)."""

    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self._saved = (dist.all_reduce, dist.all_gather)

        def timed(fn):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.seconds += time.perf_counter() - t0
            return call

        dist.all_reduce, dist.all_gather = (timed(f) for f in self._saved)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.all_gather = self._saved


def _card_events(fn):
    """Run ``fn`` under torch.profiler tracing the card alone (no host
    ops: a tick makes thousands, and summing them takes seconds); the
    device events as ``(key, device_us, count)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _mesh_timing(engine, profile=True):
    """8 slots decoding (prompts of 64, 180 new): MESH_TICKS ticks timed
    (wall, and gloo's host time on a mesh), then MESH_TICKS more under the
    profiler when ``profile`` (card-busy and copy ms), else just stepped
    (the other rank keeps pace). Also the collectives per micro-step and
    the pool's bytes on this rank."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SERVE_SEED + 31)
    for i in range(8):
        engine.submit(rng.integers(0, MESH_IDS, 64).astype(np.int32), 180, rng_seed=i)
    engine.step()  # admits all 8
    engine.step()  # one warm tick
    if engine.mesh is not None:
        engine.mesh.reset_calls()
    with _GlooTimer() as gloo:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_TICKS):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = MESH_TICKS * engine.decode_block
    calls = dict(engine.mesh.calls) if engine.mesh is not None else {}
    out = {"ms_per_tick": 1e3 * wall / MESH_TICKS,
           "gloo_ms_per_tick": 1e3 * gloo.seconds / MESH_TICKS,
           "collectives_per_micro_step": (calls.get("model/all_reduce", 0)
                                          + calls.get("model/all_gather", 0)) / steps,
           "pool_bytes": sum(t.numel() * t.element_size() for t in (engine.pool.k,
                                                                   engine.pool.v))}
    if profile:
        events = _card_events(lambda: [engine.step() for _ in range(MESH_TICKS)])
        busy = sum(t for _, t, _ in events) / 1e3 / MESH_TICKS
        check(busy > 0, "[mesh] the profiler saw no device time")
        out["busy_ms_per_tick"] = busy
        out["copy_ms_per_tick"] = sum(t for k, t, _ in events
                                      if "memcpy" in k.lower()) / 1e3 / MESH_TICKS
    else:
        for _ in range(MESH_TICKS):
            engine.step()
    return out


def _wait_for(outdir, name, deadline_s=240):
    """Block until the parent writes ``name`` (MESH_LEGS, MESH_TIMING);
    fail if it wrote that its part failed, or never wrote it."""
    path = os.path.join(outdir, name)
    deadline = time.monotonic() + deadline_s
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f"[mesh] the parent never wrote {name}")
        time.sleep(0.05)
    with open(path) as f:
        check(f.read() == "go", f"[mesh] the parent's part before {name} failed")


def _signal(name, ok):
    with open(os.path.join(MESH_DIR, name), "w") as f:
        f.write("go" if ok else "failed")


def _serving_mesh_rank(outdir):
    """One rank of phase 30 (``--serving-mesh-rank``): gloo on the shared
    card. Once (b)'s checkpoint is saved (MESH_LEGS) both ranks run the
    tp=2 legs (a)-(c); once serving_smoke, bench_serving and the parent's
    one-process runs are done (MESH_TIMING) rank 0 times tp=1 alone (rank 1
    waits) and both time tp=2. Each rank writes what it saw and how long
    each part took."""
    import torch
    import torch.distributed as dist

    from gradaccum_tpu_torch.models.gpt_decode import truncate_draft_params
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, ReplicatedEngine, reconfig

    info = mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    rank = info["process_index"]
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"marks": []}

    def mark(name, t=[time.perf_counter()]):  # noqa: B006 — the last mark's time
        now = time.perf_counter()
        out["marks"].append([name, now - t[0]])
        t[0] = now

    try:
        with torch.no_grad():
            cfg, params = _mesh_model()
            fa.reset_launch_counts()
            if rank == 0:  # the profiler's start-up, paid here rather than in a window
                _card_events(lambda: torch.ones(1, device="cuda").add_(1))
            _wait_for(outdir, MESH_LEGS)
            mark("start-up and model")

            def engine(**kw):
                return Engine(params, cfg, mesh=mesh_lib.serving_mesh(MESH_TP), **kw)

            # (a) greedy on the paged pool, sampled on the fixed one, k = 4
            out["greedy"] = _mesh_records(engine(**MESH_ENGINE, **MESH_PAGE), "greedy")[1]
            out["sampled"] = _mesh_records(engine(**MESH_ENGINE, **SERVE_SAMPLING),
                                           "sampled")[1]
            draft, dcfg = truncate_draft_params(params, cfg, 1)
            spec = dict(num_slots=8, max_len=256, speculate_k=MESH_SPEC_K, draft_params=draft,
                        draft_cfg=dcfg, **MESH_PAGE)
            out["spec"] = _mesh_records(engine(**spec), "spec k=4", MESH_SPEC_N,
                                        MESH_SPEC_NEW)[1]
            e = engine(**spec)
            for i, p in enumerate(_mesh_prompts()[:2]):
                e.submit(p, MESH_NEW, rng_seed=i)
            e.step()
            e.mesh.reset_calls()
            e.step()
            out["cycle_calls"] = dict(e.mesh.calls)
            mark("(a)")
            # (b) a seeded crash, a host-swap preemption, a grow and a swap
            prompts = _mesh_prompts()
            e = engine(**MESH_ENGINE, **MESH_PAGE)
            injector = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(
                faults.MID_DECODE_TICK, at=MESH_AT, kind=faults.KIND_CRASH)]))
            with faults.installed(injector):
                streams, _, failed = _mesh_drive(e, prompts, MESH_NEW)
            out["recover"] = dict(streams=streams, failed=failed, fired=len(injector.fired),
                                  allocated=e.pool.allocated_blocks)
            e = engine(swap="host", **MESH_ENGINE, **MESH_PAGE)
            streams, done, _ = _mesh_drive(e, prompts, MESH_NEW,
                                           {MESH_AT: lambda x: x.preempt(0)})
            m = e.metrics.summary()
            out["swap"] = dict(streams=streams, preempted=done[MESH_AT][0],
                               ms=done[MESH_AT][1], bytes_out=m["swap_bytes_out"],
                               swap_ins=e.metrics.swap_ins)
            e = engine(**MESH_ENGINE, **MESH_PAGE)
            streams, done, _ = _mesh_drive(e, prompts, MESH_NEW, {
                MESH_AT: lambda x: x.reconfigure(reconfig.pool_resize(MESH_GROW)).to_dict(),
                MESH_AT + 1: lambda x: x.reconfigure(reconfig.checkpoint_swap(
                    checkpoint=os.path.join(outdir, "ckpt"))).to_dict()})
            out["reconfig"] = dict(streams=streams, grow=done[MESH_AT][0],
                                   grow_ms=done[MESH_AT][1], swap=done[MESH_AT + 1][0],
                                   swap_ms=done[MESH_AT + 1][1], swap_ins=e.metrics.swap_ins,
                                   blocks=list(e.pool.k.shape)[1] - 1)
            mark("(b)")
            # (c) two replicas of tp=2, lockstep on the trace, then drained
            fleet = ReplicatedEngine(params, cfg, replicas=2, tp=MESH_TP, **MESH_ENGINE,
                                     **MESH_PAGE)
            _, out["fleet"], out["fleet_ids"] = _mesh_records(fleet, "fleet")
            out["fleet_mesh"] = [fleet.manifest()["mesh"], fleet.manifest()["tp"]]
            fleet.close()
            fleet = ReplicatedEngine(params, cfg, replicas=2, tp=MESH_TP, **MESH_ENGINE,
                                     **MESH_PAGE)
            rids = [fleet.submit(p, MESH_NEW, rng_seed=i) for i, p in enumerate(prompts)]
            fleet.drain()
            out["drain"] = [[int(t) for t in fleet.pop_result(r)[0]] for r in rids]
            out["drain_spread"] = sorted({r % 2 for r in rids})
            fleet.close()
            mark("(c)")
            _wait_for(outdir, MESH_TIMING)
            mark("waiting for serving_smoke, bench_serving and the calm runs")
            dist.barrier()
            if rank == 0:
                out["tp1"] = _mesh_timing(Engine(params, cfg, **MESH_ENGINE, **MESH_PAGE))
            dist.barrier()
            out["tp2"] = _mesh_timing(engine(**MESH_ENGINE, **MESH_PAGE), profile=rank == 0)
            mark("tp=1 and tp=2 timing")
            out["flash"] = fa.launch_counts()
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _near_tie_sampled(tag, params, cfg, item, got, want, cases):
    """A sampled stream against its reference: a first difference passes
    only where the sampler's two best perturbed scores (the top-k masked
    logits over T plus the request's Gumbel noise at that token) of the
    reference are closer than NEAR_TIE."""
    import torch

    from gradaccum_tpu_torch.models.gpt_decode import _top_k_mask, prefill
    from gradaccum_tpu_torch.utils import prng

    if got == want:
        return
    pos = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    ids = torch.tensor([list(item.prompt) + list(want[:pos])], device="cuda")
    _, logits = prefill(params, cfg, ids, ids.shape[1])
    t = torch.full((), SERVE_SAMPLING["temperature"], device="cuda")
    masked = torch.div(_top_k_mask(logits[0], SERVE_SAMPLING["top_k"]), t)
    key = prng.fold_in(prng.PRNGKey(item.rng_seed).to("cuda"), pos)
    top2 = torch.topk(prng.gumbel(key, masked.shape) + masked, 2).values
    gap = float(top2[0] - top2[1])
    if gap >= NEAR_TIE:
        raise SmokeError(f"[mesh] {tag}: request {item.rng_seed} first differs at token {pos}: "
                         f"{got[pos]} against {want[pos]}, the reference's top-2 perturbed "
                         f"score gap {gap:.3e}")
    cases.append((tag, pos, gap))
    print(f"[mesh]   {tag}: near tie at token {pos} (perturbed gap {gap:.3e})")


def phase_serving_mesh():
    """Phase 30: the serving mesh at GPT-Small width on the padded vocabulary,
    two gloo ranks on the card against one process, with serving_smoke
    --mesh and bench_serving --mesh on the card beside them. No flash
    kernel launches."""
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt
    from gradaccum_tpu_torch.examples.common import spawn_ranks
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    smi = _smi()
    print(f"[mesh] on {smi}")
    # serving_smoke, bench_serving and the one-process runs go on beside the
    # ranks' start-up and legs; the timing windows come last, alone
    bench_out = os.path.join(MESH_DIR, "bench_serving_mp.json")
    procs = {"serving_smoke": subprocess.Popen(
        [sys.executable, "-m", "gradaccum_tpu_torch.examples.serving_smoke", "--device",
         "cuda", "--paged", "--mesh", "dp,tp"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), "bench_serving": subprocess.Popen(
        [sys.executable, "-m", "gradaccum_tpu_torch.examples.bench_serving", "--mesh",
         "--fast", "--device", "cuda", "--out", bench_out], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    ranks_done = _in_background(lambda: spawn_ranks(
        "chip_smoke", ["--serving-mesh-rank", MESH_DIR], MESH_TP, "cuda", deadline_s=300))
    signalled, logs = [], {}
    try:
        cfg, params = _mesh_model()
        fa.reset_launch_counts()
        ckpt.save(os.path.join(MESH_DIR, "ckpt"), {"params": params, "step": 1}, step=1)
        _signal(MESH_LEGS, True)
        signalled.append(MESH_LEGS)
        trace, greedy, _ = _mesh_records(Engine(params, cfg, **MESH_ENGINE, **MESH_PAGE),
                                         "tp=1 greedy")
        _, sampled, _ = _mesh_records(Engine(params, cfg, **MESH_ENGINE, **SERVE_SAMPLING),
                                      "tp=1 sampled")
        prompts = _mesh_prompts()
        calm = _mesh_drive(Engine(params, cfg, **MESH_ENGINE, **MESH_PAGE), prompts,
                           MESH_NEW)[0]
        marks = [("checkpoint and calm runs", time.perf_counter())]
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=300)[0]
            check(proc.returncode == 0, f"[mesh] (d) {name} failed:\n{logs[name][-3000:]}")
        with open(bench_out) as f:
            bench = json.load(f)
        _signal(MESH_TIMING, True)
        signalled.append(MESH_TIMING)
        marks.append(("serving_smoke and bench_serving", time.perf_counter()))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if len(signalled) < 2:
            for name in (MESH_LEGS, MESH_TIMING):
                if name not in signalled:
                    _signal(name, False)
            try:
                ranks_done()
            except Exception:  # noqa: BLE001 — the parent's own error is the one to report
                pass
    try:
        ranks_done()
    except RuntimeError as e:
        raise SmokeError(f"[mesh] the two ranks: {e}") from None
    marks.append(("the ranks' timing", time.perf_counter()))
    ranks = []
    for r in range(MESH_TP):
        with open(os.path.join(MESH_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for key in ("greedy", "sampled", "spec", "cycle_calls", "recover", "fleet", "fleet_ids",
                "fleet_mesh", "drain", "drain_spread", "flash"):
        check(ranks[0][key] == ranks[1][key], f"[mesh] the ranks disagree on {key}")
    for key in ("streams", "preempted", "bytes_out", "swap_ins"):
        check(ranks[0]["swap"][key] == ranks[1]["swap"][key], f"[mesh] the ranks disagree on "
                                                              f"swap {key}")
    got = ranks[0]
    cases = []
    prompts_a = [item.prompt for item in trace]
    _against("[mesh] (a) greedy tp=2", params, cfg, prompts_a, got["greedy"], greedy, cases)
    for item, g, w in zip(trace, got["sampled"], sampled):
        _near_tie_sampled("(a) sampled tp=2", params, cfg, item, g, w, cases)
    _against("[mesh] (a) spec k=4 tp=2", params, cfg, prompts_a[:MESH_SPEC_N], got["spec"],
             [g[:MESH_SPEC_NEW] for g in greedy[:MESH_SPEC_N]], cases)
    layers = cfg.num_layers
    want_cycle = (MESH_SPEC_K + 1) * (2 * 1 + 2) + (2 * layers + 2)
    cycle = got["cycle_calls"]
    check(cycle.get("model/all_reduce", 0) + cycle.get("model/all_gather", 0) == want_cycle,
          f"[mesh] collectives of a k={MESH_SPEC_K} cycle {cycle}, want {want_cycle}")
    one, two = got["tp1"], got["tp2"]
    check(two["collectives_per_micro_step"] == 2 * layers + 2,
          f"[mesh] {two['collectives_per_micro_step']} collectives per micro-step, want "
          f"{2 * layers + 2}")
    check(two["pool_bytes"] * MESH_TP == one["pool_bytes"],
          f"[mesh] pool bytes per rank {two['pool_bytes']} against tp=1's {one['pool_bytes']}")
    rec, swap, rc = got["recover"], got["swap"], got["reconfig"]
    check(rec["fired"] == 1 and rec["failed"] and rec["allocated"] == 0,
          f"[mesh] (b) recover: {rec['fired']} fired, {rec['failed']} recovered")
    _against("[mesh] (b) recovered tp=2", params, cfg, prompts, rec["streams"], calm, cases)
    check(swap["preempted"] is True and swap["swap_ins"] == 1 and swap["bytes_out"] > 0,
          f"[mesh] (b) swap: {swap}")
    _against("[mesh] (b) swapped tp=2", params, cfg, prompts, swap["streams"], calm, cases)
    check(rc["grow"]["ok"] and rc["grow"]["preempted"] == 0 and rc["blocks"] == MESH_GROW
          and rc["swap"]["ok"] and rc["swap"]["detail"]["weights_unchanged"],
          f"[mesh] (b) reconfig: {rc['grow']} {rc['swap']}")
    _against("[mesh] (b) grown and swapped tp=2", params, cfg, prompts, rc["streams"], calm,
             cases)
    _against("[mesh] (c) fleet tp=2", params, cfg, prompts_a, got["fleet"], greedy, cases)
    check({r % 2 for r in got["fleet_ids"]} == {0, 1} and got["fleet_mesh"] == [
        {"model": MESH_TP}, MESH_TP], f"[mesh] (c) fleet ids {got['fleet_ids']}, manifest "
                                      f"{got['fleet_mesh']}")
    _against("[mesh] (c) fleet drained", params, cfg, prompts, got["drain"], calm, cases)
    check(got["drain_spread"] == [0, 1], f"[mesh] (c) drain used replicas {got['drain_spread']}")
    print(f"[mesh] (a) GPT-Small f32 at vocab {MESH_VOCAB}, tp=2 on {smi}: greedy (paged), "
          f"sampled T 0.8 top-k 50 (fixed) and spec k={MESH_SPEC_K} streams of "
          f"{len(trace)}, {len(trace)} and {MESH_SPEC_N} requests equal the one process's, both "
          f"ranks identical; "
          f"{len(cases)} near ties")
    print(f"[mesh] (a) 8 slots decoding, block {MESH_ENGINE['decode_block']}: tp=1 "
          f"{one['ms_per_tick']:.2f} ms/tick wall, card busy {one['busy_ms_per_tick']:.2f} "
          f"(copies {one['copy_ms_per_tick']:.3f}); tp=2 {two['ms_per_tick']:.2f} ms/tick "
          f"wall (rank 0; rank 1 {ranks[1]['tp2']['ms_per_tick']:.2f}), card busy "
          f"{two['busy_ms_per_tick']:.2f} (copies {two['copy_ms_per_tick']:.3f}) on rank 0, "
          f"gloo host {two['gloo_ms_per_tick']:.2f} ms/tick = "
          f"{two['gloo_ms_per_tick'] / two['ms_per_tick']:.3f} of the tick; "
          f"{two['collectives_per_micro_step']:.0f} collectives per micro-step, "
          f"{want_cycle} per spec cycle; pool {two['pool_bytes'] / 2 ** 20:.2f} MiB per rank "
          f"against {one['pool_bytes'] / 2 ** 20:.2f} MiB at tp=1")
    print(f"[mesh] (b) crash at tick {MESH_AT} recovered ({len(rec['failed'])} requeued); "
          f"preempt + host swap {swap['ms']:.2f} ms ({swap['bytes_out'] / 2 ** 20:.2f} MiB out "
          f"per rank); grow to {MESH_GROW} blocks {rc['grow_ms']:.2f} ms; checkpoint swap "
          f"(the one process's weights: weights_unchanged, so the whole tree's params_digest "
          f"on each rank is tp=1's; {rc['swap_ins']} swap-ins) {rc['swap_ms']:.1f} ms (all "
          f"ms beside serving_smoke, bench_serving and the calm runs); every stream the calm "
          f"run's")
    print(f"[mesh] (c) ReplicatedEngine(replicas=2, tp=2): the trace lockstep (ids "
          f"{sorted(got['fleet_ids'])}) and drain() streams equal the one process's")
    print("[mesh] rank 0: " + ", ".join(f"{n} {t:.1f} s" for n, t in got["marks"]))
    check(bench["tp"]["parity"] is True and bench["tp"]["decode_programs"] == 1
          and all(all(c <= 1 for c in s["decode_programs_per_replica"])
                  for s in bench["scaling"]),
          f"[mesh] (d) bench_serving --mesh: {bench['tp']} {bench['scaling']}")
    print(f"[mesh] (d) bench_serving --mesh --fast on {smi}: {bench['headline']}; dp 1->2 "
          f"{bench['dp_speedup_at_2']:.3f}x (host threads on one card; JAX's 1.5x term "
          f"reads passed={bench['acceptance']['passed']}), tp=2 {bench['tp']['tokens_per_s']:.1f}"
          f" tokens/s (beside serving_smoke, the ranks and the calm runs); serving_smoke "
          f"--paged --mesh dp,tp {logs['serving_smoke'].strip().splitlines()[-1]}")
    counts = fa.launch_counts()
    check(not any(counts.values()) and not any(got["flash"].values()),
          f"[mesh] flash kernels launched: here {counts}, rank 0 {got['flash']}")
    prev, parts = t0, []
    for name, at in marks:
        parts.append(f"{name} {at - prev:.1f} s")
        prev = at
    print(f"[mesh] flash launches {dict(counts)} here and on the ranks; phase 30 took "
          f"{time.perf_counter() - t0:.1f} s ({', '.join(parts)})")
    return dict(params=params, cfg=cfg, trace=trace, greedy=greedy, sampled=sampled,
                prompts=prompts, calm=calm, tp2_ms=two["ms_per_tick"])


# --------------------------------------------------------------------------
# phase 31: the server over the serving mesh, and the operator tools
# --------------------------------------------------------------------------

SERVER_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh_server")
TOOLS_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke_tools")  # the tools' artifacts
SERVER_CLIENTS = 6
SERVER_WAIT = 240  # seconds a handle may take
SERVER_GO = "timing_go"  # the tools are done: the timing window has the card


def _mesh_trace():
    """Phase 30's seeded trace (SimulationDriver's draws need no engine)."""
    import types

    from gradaccum_tpu_torch.serving import SimulationDriver

    return SimulationDriver.make_trace(types.SimpleNamespace(seed=MESH_SEED),
                                       vocab_size=MESH_IDS, **MESH_TRACE)


def _clients(server, jobs):
    """``jobs`` of ``(prompt, max_new, rng_seed)`` submitted by
    SERVER_CLIENTS threads; the streams in job order."""
    import threading

    out, errors = [None] * len(jobs), []

    def work(k):
        try:
            hs = [(i, server.submit(jobs[i][0], jobs[i][1], rng_seed=jobs[i][2]))
                  for i in range(k, len(jobs), SERVER_CLIENTS)]
            for i, h in hs:
                tokens, reason = h.result(timeout=SERVER_WAIT)
                check(reason == "length", f"[server] request {i} ended {reason}")
                out[i] = [int(t) for t in tokens]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(SERVER_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def _served(server, rank, body):
    """Rank 0 starts ``server`` and returns ``body(server)``; rank 1 follows
    until rank 0 stops it."""
    if rank != 0:
        server.follow()
        return None
    server.start()
    try:
        return body(server)
    finally:
        server.stop()


def _server_timing(server, engine):
    """8 slots decoding (prompts of 64, 180 new) through the running
    server: the wall ms per tick over MESH_TICKS ticks after the admission
    and one warm tick, from the starts of the loop's ``step`` calls (each
    tick's control exchange is inside the period)."""
    import numpy as np

    starts, step = [], engine.step

    def timed():
        starts.append(time.perf_counter())
        return step()

    engine.step = timed
    rng = np.random.default_rng(SERVE_SEED + 31)
    for i in range(8):
        server.submit(rng.integers(0, MESH_IDS, 64).astype(np.int32), 180, rng_seed=i)
    deadline = time.monotonic() + SERVER_WAIT
    while len(starts) < MESH_TICKS + 3:
        check(time.monotonic() < deadline, "[server] the timing window never filled")
        time.sleep(0.01)
    engine.step = step
    return 1e3 * (starts[MESH_TICKS + 2] - starts[2]) / MESH_TICKS


def _mesh_server_rank(outdir):
    """One rank of phase 31 (``--mesh-server-rank``): rank 0 serves, rank 1
    follows. Legs (a)-(c) run beside the tools; the timing window waits for
    SERVER_GO. Each rank writes what it saw."""
    import torch

    from gradaccum_tpu_torch.obs import flight as obs_flight
    from gradaccum_tpu_torch.obs import trace as obs_trace
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, ReplicatedEngine, ServingServer, reconfig

    info = mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    rank = info["process_index"]
    torch.backends.cuda.matmul.allow_tf32 = False
    out, t = {"marks": []}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        out["marks"].append([name, now - t[0]])
        t[0] = now

    try:
        with torch.no_grad():
            cfg, params = _mesh_model()
            fa.reset_launch_counts()
            mark("start-up and model")
            trace = _mesh_trace()
            jobs = [(item.prompt, item.max_new_tokens, item.rng_seed) for item in trace]
            control = []

            def engine(**kw):
                return Engine(params, cfg, mesh=mesh_lib.serving_mesh(MESH_TP), **kw)

            def lockstep(e, jobs=jobs, **kw):
                server = ServingServer(e, **kw)
                got = _served(server, rank, lambda s: _clients(s, jobs))
                control.append(server.control_stats())
                return got

            # (a) greedy (paged) and sampled (fixed pool) through the lockstep server
            out["greedy"] = lockstep(engine(**MESH_ENGINE, **MESH_PAGE))
            out["sampled"] = lockstep(engine(**MESH_ENGINE, **SERVE_SAMPLING))
            mark("(a)")
            # (b) a seeded crash and a pool grow through one traced server
            prompts = _mesh_prompts()
            e = engine(**MESH_ENGINE, **MESH_PAGE)
            tracer = obs_trace.Tracer(capacity=None)
            server = ServingServer(e, max_requeues=1,
                                   flight=obs_flight.FlightRecorder(TOOLS_DIR, tracer=tracer)
                                   if rank == 0 else None)
            injector = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(
                faults.MID_DECODE_TICK, at=MESH_AT, kind=faults.KIND_CRASH)]))

            def faulted(s):
                handles = [s.submit(p, MESH_NEW, rng_seed=i) for i, p in enumerate(prompts)]
                grow = s.reconfigure(reconfig.pool_resize(MESH_GROW), timeout=SERVER_WAIT)
                streams = []
                for h in handles:
                    tokens, reason = h.result(timeout=SERVER_WAIT)
                    check(reason == "length", f"[server] (b) a request ended {reason}")
                    streams.append([int(x) for x in tokens])
                return dict(streams=streams, grow=grow.to_dict())

            with faults.installed(injector), obs_trace.installed(tracer):
                out["faulted"] = _served(server, rank, faulted)
            control.append(server.control_stats())
            out["fired"] = len(injector.fired)
            out["blocks"] = e.num_blocks
            if rank == 0:
                tracer.export(os.path.join(TOOLS_DIR, "mesh_server_trace.json"))
            mark("(b)")
            # (c) the free-running fleet of two tp=2 replicas
            fleet = ReplicatedEngine(params, cfg, replicas=2, tp=MESH_TP, **MESH_ENGINE,
                                     **MESH_PAGE)
            server = ServingServer(fleet, free_running=True)
            out["free"] = _served(server, rank, lambda s: _clients(s, jobs))
            control.append(server.control_stats())
            out["free_left"] = sum(len(r.results) for r in fleet.replicas)
            fleet.close()
            mark("(c)")
            _wait_for(outdir, SERVER_GO)
            mark("waiting for the tools")
            e = engine(**MESH_ENGINE, **MESH_PAGE)
            server = ServingServer(e)
            out["server_ms_per_tick"] = _served(server, rank,
                                                lambda s: _server_timing(s, e))
            mark("timing through the server")
            if rank == 0:
                out["control"] = {k: sum(c[k] for c in control)
                                  for k in ("exchanges", "commands", "host_s")}
            out["flash"] = fa.launch_counts()
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _mesh_refs():
    """Phase 30's one-process references, for phase 31 run alone."""
    import torch

    from gradaccum_tpu_torch.serving import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        cfg, params = _mesh_model()
        trace, greedy, _ = _mesh_records(Engine(params, cfg, **MESH_ENGINE, **MESH_PAGE),
                                         "tp=1 greedy")
        _, sampled, _ = _mesh_records(Engine(params, cfg, **MESH_ENGINE, **SERVE_SAMPLING),
                                      "tp=1 sampled")
        prompts = _mesh_prompts()
        calm = _mesh_drive(Engine(params, cfg, **MESH_ENGINE, **MESH_PAGE), prompts,
                           MESH_NEW)[0]
    return dict(params=params, cfg=cfg, trace=trace, greedy=greedy, sampled=sampled,
                prompts=prompts, calm=calm, tp2_ms=None)


def phase_mesh_server(refs=None):
    """Phase 31: the server over a multi-rank serving mesh on the card,
    against phase 30's one-process streams (``refs``, computed here when
    the phase runs alone), and the operator tools beside it."""
    from gradaccum_tpu_torch.examples import bench_trend, obs_report
    from gradaccum_tpu_torch.examples.common import spawn_ranks
    from gradaccum_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    shutil.rmtree(SERVER_DIR, ignore_errors=True)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(SERVER_DIR)
    os.makedirs(TOOLS_DIR)
    smi = _smi()
    print(f"[server] on {smi}")
    # the tools run beside the ranks' start-up and legs; the timing window
    # waits for them
    tools = {
        "bench_mixed": [sys.executable, "-m", "gradaccum_tpu_torch.examples.bench_mixed",
                        "--device", "cuda", "--steps", "8",
                        "--out", os.path.join(TOOLS_DIR, "BENCH_mixed.json")],
        "bench_obs": [sys.executable, "-m", "gradaccum_tpu_torch.examples.bench_obs",
                      "--device", "cuda", "--repeats", "3", "--requests", "48",
                      "--train-steps", "100", "--json", os.path.join(TOOLS_DIR, "BENCH_obs.json")],
    }
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in tools.items()}
    ranks_done = _in_background(lambda: spawn_ranks(
        "chip_smoke", ["--mesh-server-rank", SERVER_DIR], MESH_TP, "cuda", deadline_s=300))
    logs, signalled = {}, False
    try:
        if refs is None:
            refs = _mesh_refs()
        marks = [("references", time.perf_counter())]
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=300)[0]
        marks.append(("bench_mixed and bench_obs", time.perf_counter()))
        _signal_in(SERVER_DIR, SERVER_GO, True)
        signalled = True
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if not signalled:
            _signal_in(SERVER_DIR, SERVER_GO, False)
            try:
                ranks_done()
            except Exception:  # noqa: BLE001 — the parent's own error is the one to report
                pass
    try:
        ranks_done()
    except RuntimeError as e:
        raise SmokeError(f"[server] the two ranks: {e}") from None
    marks.append(("the ranks", time.perf_counter()))
    ranks = []
    for r in range(MESH_TP):
        with open(os.path.join(SERVER_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got, follower = ranks
    params, cfg, trace = refs["params"], refs["cfg"], refs["trace"]
    cases = []
    prompts_a = [item.prompt for item in trace]
    _against("[server] (a) greedy", params, cfg, prompts_a, got["greedy"], refs["greedy"], cases)
    for item, g, w in zip(trace, got["sampled"], refs["sampled"]):
        _near_tie_sampled("(a) sampled through the server", params, cfg, item, g, w, cases)
    b = got["faulted"]
    check(got["fired"] == follower["fired"] == 1, f"[server] (b) the crash fired "
                                                  f"{got['fired']}/{follower['fired']} times")
    check(b["grow"]["ok"] and b["grow"]["preempted"] == 0
          and got["blocks"] == follower["blocks"] == MESH_GROW,
          f"[server] (b) grow {b['grow']}, blocks {got['blocks']}/{follower['blocks']}")
    _against("[server] (b) recovered and grown", params, cfg, refs["prompts"], b["streams"],
             refs["calm"], cases)
    _against("[server] (c) free-running fleet", params, cfg, prompts_a, got["free"],
             refs["greedy"], cases)
    check(got["free_left"] == follower["free_left"] == 0,
          f"[server] (c) results left {got['free_left']}/{follower['free_left']}")
    check(not any(got["flash"].values()) and not any(follower["flash"].values())
          and not any(fa.launch_counts().values()), "[server] flash kernels launched")
    ctl = got["control"]
    per_exchange_ms = 1e3 * ctl["host_s"] / ctl["exchanges"]
    print(f"[server] (a)-(c) GPT-Small f32 at vocab {MESH_VOCAB}, tp=2 over two gloo ranks on "
          f"{smi}: {SERVER_CLIENTS} client threads, greedy {len(trace)} and sampled "
          f"{len(trace)} through the lockstep server, {len(refs['prompts'])} through a crash "
          f"at tick {MESH_AT} and a grow to {MESH_GROW} blocks, {len(trace)} through the "
          f"free-running fleet of two: every stream the one process's, {len(cases)} near "
          f"ties; both ranks stopped")
    alone = refs["tp2_ms"]
    print(f"[server] on {smi}: tp=2 through the server {got['server_ms_per_tick']:.2f} ms/tick "
          f"wall (8 slots, block {MESH_ENGINE['decode_block']}) against "
          + (f"{alone:.2f} for the engine alone (phase 30)" if alone is not None
             else "the engine alone: phase 30 not run")
          + f"; {ctl['commands'] / ctl['exchanges']:.2f} commands per exchange over "
          f"{ctl['exchanges']} exchanges, {per_exchange_ms:.3f} host ms each")
    for name, log in logs.items():
        check(procs[name].returncode == 0, f"[server] (d) {name} failed:\n{log[-3000:]}")
    with open(os.path.join(TOOLS_DIR, "BENCH_mixed.json")) as f:
        mixed = json.load(f)
    with open(os.path.join(TOOLS_DIR, "BENCH_obs.json")) as f:
        obs = json.load(f)
    steps = ", ".join(f"{r['config']} {r['opt_plus_accum_bytes_per_param']:g} B/param "
                      f"{r['step_time_ms_median']} ms" for r in mixed["rows"])
    print(f"[server] (d) bench_mixed on {smi}: {mixed['headline']}; {steps} (beside the "
          f"ranks); acceptance passed={mixed['acceptance']['passed']}")
    print(f"[server] (d) bench_obs on {smi}: {obs['headline']}; serve "
          f"{1e3 * obs['serve']['baseline_s_per_tick']:.3f} ms/tick, train "
          f"{1e3 * obs['train']['baseline_s_per_step']:.3f} ms/step (beside the ranks); "
          f"acceptance passed={obs['acceptance']['passed']}")
    rc = obs_report.main([TOOLS_DIR])
    events, n_files = obs_report.collect(TOOLS_DIR)
    rep = obs_report.report(events)
    check(rc == 0 and rep["faults"], f"[server] (d) obs_report exit {rc}, faults {rep['faults']}")
    effects = [(fx["effect"] or {}).get("name") for fx in rep["faults"]]
    print(f"[server] (d) obs_report over {n_files} files: {rep['events']} events, "
          f"{rep['serving']['ticks']} ticks, faults -> {effects}")
    rc = bench_trend.main(["--dir", TOOLS_DIR])
    check(rc == 0, f"[server] (d) bench_trend --dir exited {rc}")
    prev, parts = t0, []
    for name, at in marks:
        parts.append(f"{name} {at - prev:.1f} s")
        prev = at
    print("[server] rank 0: " + ", ".join(f"{n} {t:.1f} s" for n, t in got["marks"]))
    print(f"[server] phase 31 took {time.perf_counter() - t0:.1f} s on {smi} "
          f"({', '.join(parts)})")


def _signal_in(outdir, name, ok):
    with open(os.path.join(outdir, name), "w") as f:
        f.write("go" if ok else "failed")


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def kernels_line(counts, worst, timing, timing_f32, timing_gpt, timing_gpt_f32,
                 timing_gpt_lm, ladder, gpt_lm_runs, bert_f32_counts, long):
    """The ``{"kernels": [...]}`` entries: each kernel in bfloat16 and in
    float32, with its launches, largest error against the plain version,
    and its card, plain, bound and library times (phase_timing's tuples)
    with the method behind each time (``ms_from``);
    the bfloat16 entries also at the long-context shapes of phase 23, with
    the flash leg's launches per step."""
    lm_per_update = 4 * gpt_lm_runs["scan"]["accum_k"]  # gpt_lm's layers x K
    lm_counts = gpt_lm_runs["scan"]["launches"]

    def at(timed, name, per_update=None):
        t_ms, t_plain, t_library, t_bounds, t_from = timed
        out = {"ms": t_ms[name], "plain_ms": t_plain[name], "bound_ms": t_bounds[name][0],
               "bound_by": t_bounds[name][1], "library_ms": t_library[name],
               "ms_from": t_from[name]}
        if per_update is not None:
            out["launches_per_update"] = per_update
        return out

    kernels = []
    for name in REPLACES:
        # bfloat16 (tc): launches from the main path, times at its shape
        # (BERT-Small, padded mask) and at GPT-Small's causal [8, 8, 512, 64]
        kernels.append({
            "name": name, "dtype": "bfloat16", "route": "cuda",
            "source": SOURCES["torch.bfloat16"], "replaces": REPLACES[name],
            "launches": counts[name], "max_abs_err": worst[(name, "torch.bfloat16")],
            **at(timing, name),
            "gpt_causal": at(timing_gpt, name, ladder[1]["launches_per_update"]),
            "longcontext": {
                "x".join(map(str, shape)): at(long["timing"][shape], name,
                                              long["launches"][shape[2]][name])
                for shape in LONG_SHAPES},
            "longcontext_max_abs_err": long["worst"][(name, "torch.bfloat16")]})
    for name in REPLACES:
        # float32 (route tf32x3): launches from gpt_lm --flash in scan mode,
        # the float32 path whose counts were zeroed before it, and from
        # bert_finetune at its float32 default; times at the BERT shape in
        # float32, GPT-Small's and gpt_lm's
        kernels.append({
            "name": f"{name}_f32", "dtype": "float32", "route": "cuda",
            "source": SOURCES["torch.float32"], "replaces": REPLACES[name],
            "launches": lm_counts[name], "launches_from": "gpt_lm --flash --mode scan",
            "launches_bert_f32": bert_f32_counts[name],
            "max_abs_err": worst[(name, "torch.float32")],
            **at(timing_f32, name),
            "gpt_causal": at(timing_gpt_f32, name, ladder[0]["launches_per_update"]),
            "gpt_lm_causal": at(timing_gpt_lm, name, lm_per_update)})
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("[chip_smoke] torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke test needs one card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"[chip_smoke] {PACKAGE}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    t_start = time.perf_counter()
    export_job = None
    try:
        phase_build()  # every other phase needs the kernels
        worst = phase_kernels()
        timing = phase_timing()
        timing_f32 = phase_timing(dtype=torch.float32)  # bert_finetune's default dtype
        timing_gpt = phase_timing(GPT_SHAPE, masked=False, causal=True, label="gpt")
        timing_gpt_f32 = phase_timing(GPT_SHAPE, masked=False, causal=True, label="gpt",
                                      dtype=torch.float32)
        timing_gpt_lm = phase_timing(GPT_LM_SHAPE, masked=False, causal=True,
                                     label="gpt_lm", dtype=torch.float32)
        phase_agree()
        counts, scan_result = phase_main(UPDATES)
        phase_profile()
        streaming = phase_streaming()
        print(f"[streaming] seq/s streaming {streaming['seq/s']:.1f} (mfu "
              f"{streaming['mfu']:.4f}) against scan {scan_result['seq/s']:.1f} (mfu "
              f"{scan_result['mfu']:.4f}) in this run")
        phase_profile(mode="streaming")
        phase_stream_scan()
        phase_guard()
        phase_small_models()
        phase_xla_bwd()
        phase_warm_start()
        phase_remat()
        phase_sparse_embed()
        phase_profile(extra=["--sparse-embed-grad"])
        phase_moe()
        ladder = phase_gpt_ladder()
        phase_gpt_profile()
        phase_gpt_profile(f32=True)
        phase_gpt_guard()
        gpt_lm_runs = phase_gpt_lm()
        bert_f32_counts = phase_bert_f32()
        phase_dp()
        export_job = phase_export()  # its loader process runs beside phase 20
        phase_resilience()
        phase_export_check(export_job)
        phase_mp()
        long = phase_sp_pp()
        serving = phase_serving()
        phase_prefix_spec(serving)
        phase_admission(serving)
        phase_recovery()
        phase_reconfig()
        phase_heal()
        phase_mesh_server(phase_serving_mesh())
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if export_job is not None and export_job["loader"].poll() is None:
            export_job["loader"].kill()  # a phase failed before the loader was read
            export_job["loader"].wait()
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = kernels_line(counts, worst, timing, timing_f32, timing_gpt, timing_gpt_f32,
                           timing_gpt_lm, ladder, gpt_lm_runs, bert_f32_counts, long)
    print(_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 19, spawned by phase_dp
        sys.path.insert(0, ROOT)
        sys.exit(_dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--mp-rank"]:  # a rank of phase 22, spawned by phase_mp
        sys.path.insert(0, ROOT)
        sys.exit(_mp_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--sppp-rank"]:  # a rank of phase 23, spawned by phase_sp_pp
        sys.path.insert(0, ROOT)
        sys.exit(_sppp_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--longctx-timing"]:  # phase 23 (e)'s kernel timing
        sys.path.insert(0, ROOT)
        sys.exit(_longctx_timing(sys.argv[2]))
    if sys.argv[1:2] == ["--p2p-rank"]:  # a rank of phase 23's point-to-point probe
        sys.path.insert(0, ROOT)
        sys.exit(_p2p_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--serving-profile"]:  # phase 24 (e)'s profile window
        sys.path.insert(0, ROOT)
        sys.exit(_serving_profile_main())
    if sys.argv[1:2] == ["--spec-profile"]:  # phase 25 (d)'s profile window
        sys.path.insert(0, ROOT)
        sys.exit(_spec_profile_main())
    if sys.argv[1:2] == ["--overlap-profile"]:  # phase 26 (d)'s profile window
        sys.path.insert(0, ROOT)
        sys.exit(_overlap_profile_main())
    if sys.argv[1:2] == ["--serving-mesh-rank"]:  # a rank of phase 30
        sys.path.insert(0, ROOT)
        sys.exit(_serving_mesh_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-server-rank"]:  # a rank of phase 31
        sys.path.insert(0, ROOT)
        sys.exit(_mesh_server_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--drain-rank"]:  # a rank of phase 20 (d)
        sys.path.insert(0, ROOT)
        sys.exit(_drain_rank(sys.argv[2]))
    sys.exit(main())
