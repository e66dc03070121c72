#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root (it imports ``src/repro_torch``; it imports
nothing of JAX or of the JAX package) and needs one CUDA device and
``nvcc``.  Every comparison on the card runs with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together): K1 from
   ``paged_attention.cu``, K2, K3 and K4 from ``lns_matmul.cu``, K5 from
   ``fp8_elementwise.cu``, K6 from ``flash_attention.cu``; and checks with
   ``cuobjdump`` that every instantiation of K2, of K3 and of K6's bf16
   body holds HMMA (tensor-core) instructions;
3. holds kernel K1 (LNS paged decode attention, one launch per call that
   reads only the admissible pages and combines on the chip) against its
   plain PyTorch version (the per-page partials and their combine) at the
   attention geometries of qwen2-0.5b (KV 2, G 7, hd 64), gemma3-12b (KV
   8, G 2, hd 256), gemma2-27b (KV 16, G 2, hd 128), qwen3-14b (KV 8,
   G 5, hd 128) and granite-moe-3b-a800m (KV 8, G 3, hd 64), each with B=8, page 16, up to 64 pages per slot, ragged
   lengths, masked lanes, fresh-page rows, e5m2 pages, stochastic writes
   (and, past qwen2's, window 32 with softcap 50): new pages and scales
   bitwise, output within
   rtol = atol = 1e-4 (float32 sums over hd, page rows and pages in
   another order, and the card's ``expf``), fused == unfused bitwise;
   slots of length 0 and a window that skips leading pages against the
   plain version, pages outside every slot's admissible range poisoned
   (output finite and bitwise unchanged), two calls bitwise equal; then
   times the kernel and the plain version beside the function's bound
   (its bytes in, and the attention written once);
4. holds K1's float instance against its plain version on the same
   geometries with float pages (bf16, float32, and bf16 with window 32 and
   softcap 50; a float32 query; the new rows in the pages' dtype): new
   pages bitwise, scales unchanged, output within rtol = atol = 1e-4,
   fused == unfused bitwise, and the cases of 3 on bf16 and float32
   pages; then times it on bf16 pages beside its byte bound (2-byte page
   elements) and the plain version;
5. serves requests of mixed prompt lengths through the full-width
   qwen2-0.5b Engine (its first 6 of 24 layers, cut for time, as in 7, 9
   and 21; policy serve_fp8_paged, continuous scheduler, random
   weights from a seed, a pool that never preempts) with fused decode on
   and off: every request must finish with finite logits, the K1 launch
   count must equal n_layers x sub-steps, and the token streams of the two
   runs must be bitwise equal; a float32 copy of the model must give the
   same first-step logits (rtol = atol = 1e-3) through K1 and through the
   plain attention;
6. traces a short window of that path with ``torch.profiler`` (card
   busy share, launches per sub-step, the kernels that take the time;
   every traced window of the script at depth 6 since PR 26, cut for
   time);
7. the same under the default policy (the serve CLI's default: float KV
   pages of the model's dtype, bf16): the same 8 requests fused on and
   off, bitwise equal streams, K1's float instance launched n_layers x
   sub-steps times and its LNS instance never, the float32 copy's
   logits through K1 and through the plain attention;
8. traces that path as in 6;
9. preemption at full width and depth 6 (cut for time), under
   serve_fp8_paged and under the default
   policy: the same 8 requests on weights redrawn at std 0.5 from a seed
   (so that greedy streams follow the context), once with a worst-case
   pool and once with 15 pages, where the scheduler spills slots to the
   host and restores them into fresh pages (at least one preemption and
   one restore): the token streams must be bitwise equal;
10. the main path: full-width gemma3-12b (48 layers, 5 local layers
    of window 1,024 to each global one, qk-norm, hd 256, about 23.6 GB of
    bf16 weights at full depth; its first 6 layers, one whole 5:1
    period, cut for time to make room for 17b and 17c, 4.7 GB with the
    tied embedding (16's count), drawn on the card and redrawn as in 9,
    the embedding at 0.5 / sqrt(d_model), the sandwich norms' output
    gains 16 times larger so that the layers, not the last token's own
    row, lead the tied LM head) served by a 4-slot Engine, page 16,
    worst-case pool: 8 requests of one shared 64-token prefix and their
    own tails, 16 generated tokens, under serve_fp8_paged and the default
    policy (its first 6 layers since PR 26, cut for time), twice each
    (prefix cache off and on, fused decode; unfused decode runs in 11,
    cut for time): the two token streams bitwise equal,
    every stream varied (at least two distinct tokens), at least 256
    prefix hit tokens with the cache on, K1 launched n_layers x sub-steps
    times and its other instance never (after 17, a short traced window
    of this path at depth 6, cut for time, as in 6);
11. preemption while shared: the same requests at depth 6 (the main
    path's first 6 layers), prefix on, both policies, with a worst-case
    pool and with 18 pages, where spilled slots keep their registered
    prefix pages under pins (at least one spill pins a page), and with a
    worst-case pool and unfused decode; the pool's invariants after every
    step, the three token streams bitwise equal and varied;
12. fault-tolerant serving (``runtime.fault.run_serving``): the same 8
    requests at full width and depth 6 (cut for time, as 11) on FP8 pages
    (serve_fp8_paged, stochastic KV writes), prefix on, a pool of 18
    pages, under a seeded fault plan (page exhaustion, preemption storms,
    refcount-corruption drills, watchdog overruns) with a snapshot every
    8 steps, deadlines and a bounded queue, and one kill at step 28,
    restored into a freshly built engine from the snapshot of step 24,
    which holds a PREEMPTED request: every fault kind injected, one
    restart, every FINISHED stream bitwise equal to 11's and varied, the
    shed and expired requests terminal, the pool clean after the
    seizures' release, K1 launched n_layers x the sub-steps of both
    engines, the successor's first K1 calls (on restored pages) within
    rtol = atol = 1e-4 of the plain version; then on bf16 pages a
    snapshot round trip while a request is PREEMPTED (every cache and
    spill tensor bitwise equal after a load into a fresh engine) and the
    same chaos run, its survivors bitwise equal to 11's; printed: the
    snapshot's bytes on disk, save and restore seconds, the chaos run's
    wall against the fault-free run's, the fault and terminal counts and
    the peak memory;
13. tensor-parallel serving (``mesh_path``): a (1, 2)
    mesh of two ranks, spawned processes that share this one card over
    gloo (NCCL refuses two ranks on one device; a correctness run, not a
    speed-up claim), each serving gemma3-12b at full width on its shard
    (16/8 heads split 8/4, d_ff 7,680 a rank, the embedding's vocab rows
    halved; the main path's weights handed over by CUDA IPC and cut), the
    8 requests of 10 with the prefix cache on, on FP8 and on bf16 pages at
    depth 6 (FP8 at full depth until PR 26).  Every process of the script runs
    cuBLAS without split-K workspaces (``CUBLAS_WORKSPACE_CONFIG=:0:0``,
    set at its start by ``launch.mesh.require_column_stable_cublas``, as
    every card engine requires), so the ranks are held to this process's
    own runs: 11's worst-case pools under both policies.
    Gates: each rank's streams bitwise equal to those runs', a digest of
    the whole cache gathered over the ranks equal to theirs, K1 launched
    n_layers x sub-steps by each rank at 4 KV heads, each rank's first
    n_layers K1 calls within rtol = atol = 1e-4 of the plain version;
    then K1's partials mode on each rank, both instances: one shard's
    (M, l, o) normalised against ``paged_attend``, and each slot's pages
    split between the ranks and merged by ``combine_partials_psum``
    against ``paged_attend`` on the whole table, within rtol 2e-5 / atol
    2e-6.  Before the run, K1 at the shard's geometry is timed in both
    modes and both instances; the ranks then run in the background while
    this process runs 14 and 15 (``mesh_start``), so their walls are not
    a speed.  Printed beside the card's name and power limit: the
    transport, each rank's peak memory, the wall and decode tokens/s;
14. the bucketed scheduler at full width: gemma3-12b on the main path's
    weights, the same 8 requests on 4 slots, under serve_fp8_paged and
    the default policy, all at depth 6 (cut for time), 16 generated
    tokens: on the dense cache (its bytes from its layout) and on the
    paged cache (each batched prefill's rows spliced into pages: a page's
    pow2 scale from its whole content, the codes rescaled by the paper's
    integer-add multiply) fused, unfused and fused again with every K1
    call held to its plain version on the same inputs (rtol = atol =
    1e-4); with the prefix cache on (every admission prefills its
    tail through ``tail_prefill``) and off, and on FP8 pages a continuous
    and a bucketed run with deterministic KV writes.  Bitwise, on varied
    streams: fused == unfused == the second run, and prefix on == 11's
    continuous streams; printed: the share of equal tokens and the first
    divergence of dense vs paged, prefix on vs off, and continuous vs
    bucketed; K1 launched n_layers x sub-steps, never on the dense cache;
15. the logits behind 14's printed agreements, at depth 6 in float32:
    the first decode step after a bucketed prefill on the dense cache,
    after one on the paged cache and after a continuous (sub-step)
    prefill, within rtol = atol = 1e-3 on float32 pages, printed on FP8
    pages;
16. static FP8 weights at full width, depth 6 (cut for time from full
    depth): ``Engine(static_weights=True)`` under serve_fp8_paged,
    continuous, on the main path's weights
    as E4M3 codes (each matmul decodes its weight to bf16 first), against
    an Engine on the decoded bf16 weights: token streams bitwise equal
    and varied; the weight bytes on the card, the peak memory, both walls
    and the card time of decoding one layer's weights;
17. static weights through K2 and K3 (depth 6, policies with every
    matmul quantized to E4M3 under ``fused_dequant`` and ``lns``), under
    the bucketed scheduler and, for K2, the continuous one, on varied
    streams: every K2/K3 call within 2 sqrt(K) 2^-24 sum|products| of its
    plain version on the model's own codes (the rounding of two float32
    sums of the same products), 7 x n_layers launches per model call of
    the kernel under test and none of the other; each kernel's card time on one
    layer's weights at M = 4 (decode) and M = 32 (the bucketed prefill)
    beside the bound, the plain version and, for K2, ``torch.matmul`` on
    decoded bf16;
17a. the MoE family on the main path (``moe_path``): granite-moe-3b-a800m
    at full width (32 layers, 24/8 heads, hd 64, every layer 40 experts
    top-8 of d_ff 512, sorted capacity dispatch, ~6.6 GB of bf16 weights
    drawn on the card and redrawn as in 9), the 8 requests of 10 on 4
    slots, at depth 2 (cut for time, from full depth for FP8 prefix off
    and from depth 6 for the rest): FP8 pages prefix on fused,
    on unfused and off fused (streams bitwise equal and varied, >= 256
    prefix hit tokens, K1 at G 3 launched n_layers x sub-steps, each run's
    first n_layers K1 calls within rtol = atol = 1e-4 of the plain
    version), bf16 pages prefix on, and a bucketed run (the pairs its
    prefills drop by capacity printed); the
    float32 first-step logits at depth 2 through K1 and through the plain
    attention as in 19; TP=2 at depth 2 on both page kinds as in 13
    (started once the weights are drawn, beside the rest of the phase),
    held to this process's depth-2 prefix-on runs.  Printed: K1's time at
    granite's geometry, the walls, decode tokens/s and peak memory, the
    busiest expert's share of its layer's routed pairs; then a short
    traced window of granite's FP8 serving path at depth 6, as in 6;
17b. MLA with MoE on the main path (``mla_path``): deepseek-v2-lite-16b
    at full width (27 layers: a dense first layer of d_ff 10,944, then 64
    experts top-6 of d_ff 1,408 and 2 shared experts in each; MLA with a
    512-wide latent; ~31.4 GB of bf16 weights drawn on the card and
    redrawn as in 9), the 8 requests of 10 on 4 slots: at depth 3 (the
    dense layer and two MoE layers; cut for time from full depth, to make
    room for 17c) one
    FP8-latent run (E5M2 codes at scale 1, dense per-slot rows beside the
    page pool; K1 never launched), every stream varied; at depth 2 (the
    dense layer and one MoE layer), on FP8 and on bf16 latents, a rerun,
    a preempting pool, a snapshot round trip while PREEMPTED and the
    bucketed scheduler on the paged and the dense cache, all bitwise
    (continuous vs bucketed printed); float32 first-step logits on the
    card within rtol = atol = 1e-3 of the port's CPU engine on the same
    weights; static weights bitwise equal to their decoded bf16 weights,
    and through K2 (4 prompts of 8 tokens, cut for time) 6 x n_layers
    launches a sub-step, each call within
    2 sqrt(K) 2^-24 sum|products| of its plain version, with K2's time on
    one MoE layer's six products at M = 4.  Printed: the full-depth wall,
    decode tokens/s, peak memory and the busiest expert's share; then a
    short traced window at depth 6, as in 6;
17c. the SSM family on the main path (``ssm_path``): mamba2-780m at full
    width (48 SSD layers, d_model 1536, d_inner 3072, 48 heads of 64,
    d_state 128; ~1.5 GB of bf16 weights drawn on the card and redrawn
    as in 9, with Mamba2's published ranges for the decays and steps), the
    8 requests of 10 on 4 slots, at depth 12 (cut for time from full
    depth, which 28g trains) under the CLI's default
    policy and serve_fp8_paged (every stream varied, the two bitwise
    equal: an SSM reads no KV setting; K1 never launched; each SSD layer's
    conv inputs and state are dense per-slot leaves of the paged cache);
    at depth 2 a rerun, a preempting pool, fused vs unfused, the
    bucketed scheduler on the paged and the dense cache, all bitwise, and
    a snapshot round trip while PREEMPTED; float32 first-step logits on
    the card within rtol = atol = 1e-3 of the port's CPU engine; static
    weights bitwise equal to their decoded bf16 weights; the codes
    through K2 (continuous) and K3 (bucketed) on 4 prompts of 8 tokens
    (cut for time), 6 x n_layers launches a model call, each call within
    2 sqrt(K) 2^-24 sum|products| of its plain version; then a traced
    window at full depth, as in 6, and
    (``check_ssm_kernels``) K2 and K3 at the six static products' shapes
    (N 3,072, 128 and 48, K 1,536 and 3,072) at M = 4 and 95 against the
    plain version, and their card time on one layer's six products at
    M = 4;
17d. the hybrid family (``hybrid_path``): jamba-v0.1-52b at full width
    and depth 8 (one period: 7 SSD layers and one GQA layer of 32/8 heads
    at hd 128, 4 MoE layers of 16 experts top-2 and 4 MLPs; ~13.3 B
    parameters, 26.5 GB of bf16 drawn once on the card and redrawn as in
    17c, the one weight set of the phase), the 8 requests of 10 under
    serve_fp8_paged and the default policy (every stream varied; K1 at G
    4 launched once a sub-step, each run's first 8 sub-steps' calls
    within rtol = atol = 1e-4 of its plain version); on 4 prompts of 8
    tokens (page 4) a rerun, unfused decode and a preempting pool bitwise
    equal to the fused run, a snapshot round trip while PREEMPTED (pages,
    scales and SSD leaves), the bucketed scheduler on both caches
    (printed); static weights bitwise equal to their decoded bf16
    weights, the codes through K2 (continuous) and K3 (bucketed), 58
    launches a model call (the experts decoded first, as in the
    reference), the first model call's each within 2 sqrt(K) 2^-24
    sum|products| of its plain version; float32 first-step logits
    through K1 against the plain attention, on both page kinds (within
    1e-3 on float32 pages); then a traced window at depth 8, as in 6;
18. windows on the model path: gemma3-12b at full width, depth 6,
    float32, on FP8 and on float32 pages: a 1,040-token prompt, its first
    1,023 tokens prefilled in one batched call (spliced into pages), the
    rest through K1 (every K1 call held to its plain version on the
    model's own inputs at rtol = atol = 1e-4), then from
    that cache the last prompt token (the local window of 1,024 skips
    page 0) and one decode step through K1 and through the plain
    attention: logits within rtol = atol = 1e-3 on float32 pages, printed
    on FP8 pages (``_gate_logits``: there a code at a rounding boundary
    flips on a ~1e-6 difference and moves the logits by ~1e-3);
19. gemma2-27b (one local and one global layer: softcaps 50 and 30) and
    qwen3-14b at full width, depth 2: float32 logits through K1 (each K1
    call held to its plain version as in 18) and the plain attention, as
    in 18 on both page kinds, and 4 requests on bf16 pages with fused
    decode on and off, bitwise equal;
20. K5 (the paper's six FP8 operations): every one of the 69 supported
    (format, op, mode) cells over all 256 codes or 65,536 code pairs
    bitwise against the plain version, and the paper's claim on the card:
    on the exact rounding oracle's valid domain K5's codes are correctly
    rounded (faithful for ``faithful``) in 69/69 cells; random codes at
    the serving (8 x 4864) and training (8 x 128 x 4864) gate shapes and
    a misaligned ragged view, bitwise; card time of e5m2 mul at both
    shapes beside the bytes bound, the plain version and the compiled
    instruction count (SASS);
21. serves full-width qwen2-0.5b (depth 6) again with the SwiGLU gate product
    through K5 (serve_fp8_paged with elementwise e5m2; 4 requests, fused
    on and off): K5 launches = K1 launches = n_layers x sub-steps, fused
    == unfused token streams; a float32 copy's first-step logits through
    K5 and through the plain version bitwise equal; a profile of that
    path (launches per sub-step);
22. K3 (the paper's LNS matmul): all 65,536 products of every (format,
    mode) pair bitwise equal to the plain version (NaN as NaN); then K3
    (e4m3 RNE, and e5m2 ``ru``, whose planes carry x's sign) and K2 (e5m2
    x e4m3, bf16 and float32 compute) against their plain versions at the
    training path's shapes (M = 1024 tokens, every (K, N) of a qwen2-0.5b
    layer), each element within the float32 summation bound 2 K 2^-24
    sum|products|; then their card times per layer (the seven quantized
    matmuls of one layer's forward) beside the bound, the plain version
    and, for K2, ``torch.matmul`` on pre-decoded bf16 operands; K2's and
    K3's time and TFLOP/s at each shape (K3's both of the function, 2 M K
    N, and of its R planes), and beside K3 the same-shape bf16
    ``torch.matmul`` [M, R K] x [R K, N] as a yardstick of the GEMM's
    shape (no PyTorch call computes LNS products, so K3 has no library
    time).  K3's bound is the function's, whatever implements it: the
    larger of its bytes over the memory rate and its 2 M K N operations
    over the dense 8-bit tensor rate; the integer route's floor and the
    plane GEMM's dense bf16 time are printed beside it;
23. trains full-width qwen2-0.5b through the port's CLI
    (``launch.train.main``, ``--quant fp8_lns_pallas``, batch 8 x seq 128,
    6 steps, checkpoints every 3): finite losses, 0 restarts, and K3
    launches = 2 (forward and checkpointed recompute) x 7 matmuls x 24
    layers x 6 steps; then 3 steps under policy ``train_fp8`` with the K2
    count derived the same way; then the first step's loss and gradient
    norm of a float32 2-layer model through the kernels and through their
    plain versions (loss rtol 1e-4, gradient norm rtol 1e-3), for K3 and
    K2; then one profiled train step under each of the two policies
    (wall, card-busy share, K3's and K2's card time);
24. trains 2 full-width steps under train_fp8_lns with the gate through
    K5 in e4m3 (``run_training``): finite losses, 0 restarts, 672 K3 and
    96 K5 launches (forward and recompute); then the first step of a
    float32 2-layer model through K5 and through the plain version (loss
    rtol 1e-4, gradient norm rtol 1e-3); then one profiled train step
    under that policy;
25. K6 (flash attention) against its plain version: the CPU tests' cases
    (float32 at rtol = atol = 1e-4, bfloat16 within one bf16 ulp), the
    rows without an admissible key (sum(v) / padded key length), every
    candidate tiling of ``flash_blocks``, and the attention geometries of
    qwen2-0.5b (B 8 x S 128, also against ``chunked_attention``;
    B 1 x S 8192), gemma2-27b (S 8192, window 4096, cap 50), gemma3-12b
    (S 4096, hd 256, window 1024) and deepseek-v2-lite (S 4096, hd 192,
    dv 128) at full width, each in float32 and in bfloat16 (bfloat16:
    one ulp, or 1e-5 near 0); then K6's times at qwen2-0.5b
    B 1 x S 8192 bf16 beside its bound, the plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never calls),
    the same geometry in float32 and gemma2-27b's windowed geometry in
    bf16, each with its TFLOP/s and the FLOP of the tiles it visits;
26. K6's path: ``flash_attention`` with no tiling through the autotuner
    on a fresh cache file (qwen2-0.5b geometry, S 2048, bf16): measured
    in bf16, cached under the card's name and ``bf16``, a ``measured``
    gauge; a second call answers
    ``cached``, launches once and is bitwise equal to the pinned tiling
    and within tolerance of the plain version;
27. K4 (the seed LNS matmul) bitwise against its plain version at 512^3
    and at the seven matmul shapes of one qwen2-0.5b layer at M = 1024
    (the narrow ones split over k tiles), two calls bitwise equal; its
    time per layer (its kernel and, where it splits, the launch that adds
    the tiles' sums) beside K3's, the plain version and the bound (K3's:
    both compute one function), its own SASS instructions per product
    (per FFMA), its shared loads per product and the floor they set, and
    K4 / K3 at 512^3;
28. K4's path: 2 full-width train steps under train_fp8_lns with every
    matmul through K4 (``run_training``): finite losses, 0 restarts, 672
    K4 launches and no K3 or K2; then the first step of a float32 2-layer
    model through K4 and through its plain version (loss rtol 1e-4,
    gradient norm rtol 1e-3);
28a. K3 and K2 over a batch of expert products (``check_moe_kernels``):
    granite-moe-3b-a800m's three expert products at batch 8 x seq 128
    ([40, 256, 1536] x [40, 1536, 512], [40, 256, 512] x [40, 512,
    1536]), one launch each over all 40 experts, on codes quantized as
    the STE quantizes them: within 2 K 2^-24 sum|products| of the plain
    version applied expert by expert, each expert's slice bitwise equal to
    the 2-D launch on it at the batch's tile, two calls bitwise; their
    card time per layer beside the bound, the plain version and, for K2,
    ``torch.bmm`` on the decoded bf16 operands;
28b. MoE training (``moe_train_path``): granite-moe-3b-a800m at full
    width and depth 4 (cut for time from 8; full depth does not
    fit the card's memory with the float32 master and moments),
    ``--quant fp8_lns_pallas``, batch 8 x seq 128, 4 steps, a checkpoint
    every 2, through ``run_training`` and ``build_train_step``: finite
    losses and aux terms, 0 restarts, K3 launched 2 x 7 x 4 x 4 times
    (each expert product once over all
    experts) and K2 never; the wall of each step, the peak memory and the
    busiest expert's share; then one profiled train step at that depth;
28c. the first step of a float32, depth-2, full-width granite through K3
    and K2 and through their plain versions (loss rtol 1e-4, gradient
    norm rtol 1e-3), and one MoE layer's forward and backward twice on one
    input under both policies: output and the x, router and expert
    gradients bitwise equal; then one granite train step at depth 2 with
    every matmul through K4, which has no batch axis: 2 x (4 + 3 x 40) x
    2 launches, none of K3 or K2;
28d. deepseek-v2-lite-16b's kernels (``check_mla_kernels``): 28a at its
    routed products (64 experts x 128 rows, [64, 128, 2048] x [64, 2048,
    1408] and [64, 128, 1408] x [64, 1408, 2048]); at M = 1024, K3 on
    ``w_dkv`` (N 576) and on the dense layer's ``w_down`` (K 10,944, a
    partial last k tile) within the sum bound of the plain version, K4
    there bitwise; their card time beside the bound and the plain
    version;
28e. MLA training (``mla_train_path``): deepseek at full width and depth
    2 (the dense layer and one MoE layer; cut for time from 3;
    full depth needs ~470 GB under AdamW), ``--quant fp8_lns_pallas``,
    batch 8 x seq 128, 4 steps, one checkpoint at the last, through
    ``run_training`` and ``build_train_step``: finite loss, ce and aux
    terms at every step, 0 restarts, K3 launched 4 x (8 + 21) times (the
    dense layer's
    products once a step, outside the checkpoints; an MoE layer's twice
    but the shared experts' down product, once, after the checkpoint, as
    the reference's remat drops it from the recompute) and K2 never; the
    step
    walls, the checkpoint's bytes and write time, the peak memory and the
    busiest expert's share; then one profiled train step at that depth;
28f. the first step of a float32, depth-2, full-width deepseek through
    K3 and K2 and through their plain versions (loss rtol 1e-4, gradient
    norm rtol 1e-3; 8 + 21 launches with the kernels, none plain), one
    MLA + MoE layer's forward and backward twice on one input under both
    policies (the output and every gradient bitwise), then one depth-2
    step through K4: 8 + (5 + 3 + 3 x 64) + (5 + 2 + 3 x 64) launches,
    none of K3 or K2;
28g. SSM training: mamba2-780m's six products at M = 1,024 through K3,
    K2 (within the sum bound of the plain version) and K4 (bitwise), and
    their card time (``check_ssm_train_kernels``); mamba2 at full width
    and depth (``ssm_train_path``: 48 SSD layers, the model's own init),
    ``--quant fp8_lns_pallas``, batch 8 x seq 128, 4 steps, one
    checkpoint at the last, through ``run_training``: finite losses and
    gradient norms, 0 restarts, K3 launched 4 x 2 x 6 x 48 times (each
    SSD layer under the checkpoint), K2 never; one more step with A and
    dt at Mamba2's init ranges, where the masked decays' exponents pass
    float32's exp range (the reference's gradient is NaN there): finite,
    every parameter finite after it; a traced step at depth 12; the
    float32 first step at depth 2 through K3 and K2 and through their
    plain versions (loss rtol 1e-4, gradient norm rtol 1e-3); one depth-2
    step through K4 (2 x 6 x 2 launches, none of K3 or K2);
29. prints one JSON line of per-kernel numbers, then the card line again,
    and last ``{"ok": true, "device": {...}}``.

K1's numbers in the ``kernels`` line are those of gemma3-12b's geometry
(KV 8, G 2, hd 256), its launches those of the main path's prefix-on
fused run under serve_fp8_paged (K1's float instance: under the default
policy, at depth 6); qwen2-0.5b's are printed beside them as before.  The
``dequant_matmul_static_weights`` and ``lns_matmul_static_weights``
entries are K2 and K3 on static weights: card time per gemma3-12b layer
(its seven matmuls) at M = 4, launches those of phase 17, the largest
difference from the plain version on the model's codes.
K1's ``ms`` and ``plain_ms`` are card time per call from the profiler
(the kernel alone; all kernels of the plain version, partials and
combine), or from CUDA-graph
replays timed with events where the profiler records no device time; the
comment lines also give the per-call time between CUDA events with the
host's launch overhead included.  The same holds for K1's float instance
(``float_paged_partials``, on bf16 pages).  K2's and K3's numbers are card time per
layer: the sum over one layer's seven matmul shapes at M = 1024.  K5's
are those of e5m2 mul at the training gate shape (4,980,736 codes), its
launches those of the K5 serving run; its ``max_abs_err`` is in code
units (0: bitwise).  K4's numbers are per layer like K3's, its launches
those of its training run, its ``max_abs_err`` 0 (bitwise, checked).
K6 has no model path (no model calls it, as in the reference): its
launches are those of its path through the autotuner (phase 26,
measurement included), its times those of qwen2-0.5b B 1 x S 8192 bf16,
and its ``max_abs_err`` the largest float32 difference from the plain
version in phase 24.

The ``*_paged_partials_granite_moe`` entries are K1 at granite's
geometry (KV 8, G 3, hd 64): card time from 3 and 4, launches those of
17a's prefix-off FP8 run at depth 2 (LNS) and
its depth-2 bf16 run (float), ``max_abs_err`` the larger of 3's (or 4's)
and 17a's shadowed calls.

The ``dequant_matmul_static_weights_deepseek`` entry is K2 on
deepseek-v2-lite-16b's static weights (17b): card time of one MoE layer's
six products at M = 4, launches those of 17b's depth-2 K2 run, the
largest difference from the plain version there.

The ``*_static_weights_mamba2`` entries are K2 and K3 on mamba2-780m's
static weights (17c): card time of one layer's six products at M = 4,
launches those of 17c's depth-2 K2 (continuous) and K3 (bucketed) runs,
the largest difference from the plain version there and at the six
shapes.

The ``*_paged_partials_jamba`` entries are K1 at jamba's geometry (KV
8, G 4, hd 128): card time from 3 and 4, launches those of 17d's
8-request runs (FP8 pages: LNS; bf16 pages: float), ``max_abs_err`` the
larger of 3's (or 4's) and 17d's held calls.  The
``*_static_weights_jamba`` entries are K2 and K3 on jamba's static
weights: card time of one SSD layer's six products at M = 4 (``w_B`` and
``w_C`` at N 16), launches those of 17d's K2 (continuous) and K3
(bucketed) runs, the largest difference from the plain version there.
The ``*_train_mamba2`` entries are K3, K2 and K4 at mamba2's six training
products (28g): card time of the six at M = 1,024, launches those of
28g's training run (K3), its float32 K2 step and its K4 step; the plain
versions' times are of one call between CUDA events (K4's: its checking
call on the host's clock).

The ``lns_matmul_experts`` and ``dequant_matmul_experts`` entries are K3
and K2 over a batch of granite's expert products (28a): card time of a
layer's three expert products (one launch each), the largest difference
from the plain version there; launches those of 28b's training run (K3,
each expert product's launch and the attention products' 2-D launches)
and of 28c's K2 kernel step (2 x 7 x 2).  The ``*_experts_deepseek``
entries are the same at deepseek's routed products (28d), launches those
of 28e's training run (K3) and of 28f's K2 kernel step (8 + 21); the
``lns_loop_matmul_deepseek_w_down`` entry is K4 on the dense layer's
``w_down`` at M = 1024 (28d), launches those of 28f's K4 step.  The plain
versions' times in 28a and 28d are of the call the check makes, between
CUDA events.

The ``*_tp2_shard`` entries are K1 per rank of 13 (``lns`` on FP8 pages,
``float`` on bf16 pages): card time at the shard's geometry (KV 4, G 2,
hd 256), launches those of rank 0's run, ``max_abs_err`` the largest
difference of the shadowed calls over both ranks.  The
``*_partials_mode`` entries are K1's partials mode at that geometry, its
bound counting (M, l, o) out and its plain version the page partials
and their un-normalised combine; launches those of rank 0 in 13's
partials check, ``max_abs_err`` the largest difference there from
``paged_attend``.

Any failed check raises, so the script exits non-zero and prints no result
line; it also exits non-zero without a GPU, or when run outside the repo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNEL_SOURCES = ("paged_attention", "lns_matmul", "fp8_elementwise",
                  "flash_attention")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Wall time per call between CUDA events: includes the host's
    launch overhead when the host, not the card, is the limit."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_call(fn):
    """(``fn()``, its wall in ms between CUDA events): one call, no
    warm-up, as ``cuda_ms(fn, iters=1, warmup=0)``, keeping the result."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, launches: int = 50, replays: int = 10) -> float:
    """Time per call between CUDA events over replays of a CUDA graph of
    ``launches`` calls: no host launch overhead between the kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def _device_rows(prof) -> list:
    """(name, device us, count) of every kernel, copy and set a
    ``torch.profiler`` trace recorded on the card, summed by name.  Read
    from the trace's raw events: ``key_averages`` first builds an event
    object for every launch and the host calls around it, seconds for a
    plain version's 10^4-10^5 launches; where this PyTorch keeps no raw
    events, from ``key_averages``' device rows."""
    from torch.autograd import DeviceType

    rows = {}
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                us, n = rows.get(e.name(), (0.0, 0))
                rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    except AttributeError:
        return [(e.key, getattr(e, "self_device_time_total", None)
                 or e.self_cuda_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    return [(name, us, n) for name, (us, n) in rows.items()]


def device_ms(fn, iters: int, only: str = "", warmup: int = 3):
    """Card time per call: the summed device time of the CUDA kernels
    (whose names contain ``only``, if given) that ``iters`` calls ran,
    from ``torch.profiler``; where the profiler records no device time,
    or, when ``only`` picks kernels, a count of them that is no multiple
    of ``iters`` (late in a long process it has reported a tenth of a
    kernel's time, as if it had dropped launches), the CUDA-graph event
    timing of :func:`graph_ms`.  Returns (ms, how)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    seen = [(us, n) for name, us, n in _device_rows(prof)
            if only in name and us > 0]
    us = sum(u for u, _ in seen)
    if us > 0 and not (only and sum(n for _, n in seen) % iters):
        return us / iters / 1e3, "profiler"
    return graph_ms(fn), "cuda-graph events"


# K1's attention geometries: (model, KV heads, query heads a KV head, hd).
# qwen2-0.5b's is the one of PRs 11-21; gemma3-12b's is this slice's main
# path's, at which K1 is timed for the kernels line.
K1_GEOMETRIES = (("qwen2-0.5b", 2, 7, 64), ("gemma3-12b", 8, 2, 256),
                 ("gemma2-27b", 16, 2, 128), ("qwen3-14b", 8, 5, 128),
                 ("granite-moe-3b-a800m", 8, 3, 64),
                 ("jamba-v0.1-52b", 8, 4, 128))
K1_TIMED = ("qwen2-0.5b", "gemma3-12b", "granite-moe-3b-a800m",
            "jamba-v0.1-52b")
K1_MAIN = "gemma3-12b"
MOE_ARCH = "granite-moe-3b-a800m"
HYBRID_ARCH = "jamba-v0.1-52b"


def k1_inputs(dev, seed: int = 0, KV: int = 2, G: int = 7, hd: int = 64,
              fp8_pages: bool = True):
    """One decode sub-step of attention: 8 slots, page 16, up to 64 pages
    a slot, at the geometry (KV, G, hd) (qwen2-0.5b's by default).  The
    pages are drawn on the host and encoded on ``dev``; with ``fp8_pages``
    False they stay float32 on ``dev`` (the same draw)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.quant import encode
    from repro_torch.serving.page_pool import kv_noise

    g = torch.Generator(device="cpu").manual_seed(seed)
    B, page, maxp = 8, 16, 64
    P = B * maxp + 1
    bt = (torch.randperm(P - 1, generator=g) + 1).reshape(B, maxp)
    # ragged pre-write lengths: short, long, page-aligned (fresh-page
    # writes into row 0), the last row of the last page
    lengths = torch.tensor([0, 5, 16, 100, 255, 512, 777, maxp * page - 1])
    mask = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    kf = torch.randn((P, page, KV, hd), generator=g)
    vf = torch.randn((P, page, KV, hd), generator=g)
    keys = prng.fold_in(prng.split(prng.prng_key(seed), 2)[:, None, :],
                        lengths[None, :])                   # [2, B, 2]
    noise = kv_noise(keys, (KV, hd), "e5m2")

    def _pages(x):
        return encode(x, "e5m2") if fp8_pages else x

    return dict(
        q=torch.randn((B, 1, KV * G, hd), generator=g).to(dev),
        k_new=(torch.randn((B, KV, hd), generator=g) * 3).to(dev),
        v_new=(torch.randn((B, KV, hd), generator=g) * 3).to(dev),
        kp=_pages(kf.to(dev)), vp=_pages(vf.to(dev)),
        ks=(2.0 ** torch.randint(-2, 3, (P,), generator=g)).float().to(dev),
        vs=(2.0 ** torch.randint(-2, 3, (P,), generator=g)).float().to(dev),
        bt=bt.to(torch.int32).to(dev), lengths=lengths.to(torch.int32).to(dev),
        mask=mask.to(dev), k_noise=noise[0].to(dev), v_noise=noise[1].to(dev),
        KV=KV, G=G, hd=hd, page=page, maxp=maxp, B=B, fmt="e5m2")


def k1_float_inputs(dev, pdt, seed: int = 0, **geo):
    """``k1_inputs``' geometry, lengths and mask with float pages of
    ``pdt`` and the new K/V rows in that dtype (as the model writes them);
    the query stays float32, and float pages draw no noise."""
    import torch

    c = k1_inputs(dev, seed, fp8_pages=False, **geo)
    g = torch.Generator(device="cpu").manual_seed(seed + 7)
    for name in ("kp", "vp"):
        c[name] = torch.randn(c[name].shape, generator=g).to(dev, pdt)
    for name in ("k_new", "v_new"):
        c[name] = c[name].to(pdt)
    c.update(fmt=None, k_noise=None, v_noise=None)
    return c


def fused(c, impl, window=0, cap=0.0):
    from repro_torch.kernels.paged_attention import fused_decode_write_attend

    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    return fused_decode_write_attend(
        c["q"], c["k_new"], c["v_new"], kp, vp, ks, vs, c["bt"],
        c["lengths"], fmt=c["fmt"], n_kv_heads=c["KV"], kv_mode="stochastic",
        k_noise=c["k_noise"], v_noise=c["v_noise"], write_mask=c["mask"],
        window=window, cap=cap, impl=impl)


def unfused(c, window=0, cap=0.0):
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.serving.page_pool import write_token_page

    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
    write_token_page(kp, ks, c["k_new"], pids, rows, fmt=c["fmt"],
                     noise=c["k_noise"], write_mask=c["mask"])
    write_token_page(vp, vs, c["v_new"], pids, rows, fmt=c["fmt"],
                     noise=c["v_noise"], write_mask=c["mask"])
    out = paged_decode_attention(c["q"], kp, vp, ks, vs, c["bt"],
                                 c["lengths"] + 1, fmt=c["fmt"],
                                 n_kv_heads=c["KV"], window=window, cap=cap)
    return out, kp, ks, vp, vs


def _partials_note(bytes_in, B, maxp, KV, G, dv) -> str:
    """The bound a design that writes per-page partials would have had
    (the parent's): information only, never the bound."""
    partials = 4 * B * maxp * KV * G * (2 + dv)      # m, l, o per page
    return (f"with per-page partials written ({partials} B) it would read "
            f"{(bytes_in + partials) / HBM_BYTES_PER_S * 1e3:.6f} ms "
            "(information, not the bound)")


def check_k1_edges(c, label: str) -> float:
    """The cases that reading only the admissible pages must get right,
    through ``paged_decode_attention`` on ``c``'s pool (FP8 or float
    pages), each call one launch: slots of length 0 (the reference reads
    every page with every position masked: the mean of all V rows) and a
    window of 32 that skips leading pages, against the plain version at
    rtol = atol = 1e-4; pages outside every slot's admissible range
    poisoned (NaN on float pages, random codes on FP8 pages, NaN/inf codes
    among them), with and without the window: a finite output bitwise
    equal to the clean pool's, so those pages are not read; and two calls
    on the same inputs bitwise equal.  Returns the largest |kernel -
    plain|."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    fmt, KV, page, maxp = c["fmt"], c["KV"], c["page"], c["maxp"]
    ln = c["lengths"] + 1                     # the attended lengths
    zero = ln.clone()
    zero[0] = zero[3] = 0
    count = "launches" if fmt else "float_launches"

    def attend(kp, vp, lengths, window, impl="auto"):
        return pa.paged_decode_attention(
            c["q"], kp, vp, c["ks"], c["vs"], c["bt"], lengths, fmt=fmt,
            n_kv_heads=KV, window=window, impl=impl)

    err = 0.0
    for lengths, window, what in ((zero, 0, "two slots of length 0"),
                                  (ln, 32, "window 32")):
        before = getattr(pa.paged_attend, count)
        got = attend(c["kp"], c["vp"], lengths, window)
        again = attend(c["kp"], c["vp"], lengths, window)
        want = attend(c["kp"], c["vp"], lengths, window, impl="ref")
        torch.cuda.synchronize()
        if getattr(pa.paged_attend, count) != before + 2:
            raise AssertionError(f"{label}: {what}: not one launch a call")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: {what}: non-finite output")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: {what}: two calls differ")
        err = max(err, float((got - want).abs().max()))
    g = torch.Generator(device="cpu").manual_seed(11)
    bt, lens = c["bt"].cpu(), ln.cpu()
    for window in (0, 32):
        kp, vp = c["kp"].clone(), c["vp"].clone()
        pids = []
        for b in range(bt.shape[0]):
            first, last = pa.admissible_pages(int(lens[b]), window, page,
                                              maxp)
            pids += [int(bt[b, j]) for j in range(maxp)
                     if not first <= j <= last]
        for t in (kp, vp):
            if fmt is None:
                t[pids] = float("nan")
            else:
                t[pids] = torch.randint(0, 256, t[pids].shape, generator=g,
                                        dtype=torch.uint8).to(t.device)
        clean = attend(c["kp"], c["vp"], ln, window)
        dirty = attend(kp, vp, ln, window)
        if not (torch.isfinite(dirty).all() and torch.equal(clean, dirty)):
            raise AssertionError(f"{label}: window {window}: poisoned pages "
                                 "outside the admissible range changed "
                                 "the output")
        print(f"# {label}: {len(pids)} pages outside the admissible ranges "
              f"poisoned (window {window}): output finite and unchanged",
              flush=True)
    print(f"# {label}: two slots of length 0 and window 32 within rtol = "
          f"atol = 1e-4 of the plain version (max |err| {err:.3e}), two "
          "calls bitwise equal", flush=True)
    return err


def _k1_fused_gates(c, label: str, window: int = 0, cap: float = 0.0):
    """K1's fused form against the plain version on ``c`` (FP8 pages):
    new pages and scales bitwise, output within rtol = atol = 1e-4, fused
    == unfused bitwise.  Returns the largest |kernel - plain|."""
    import torch

    act = c["mask"]
    kern, plain = fused(c, "auto", window, cap), fused(c, "ref", window, cap)
    torch.cuda.synchronize()
    for i, name in ((1, "k_pages"), (2, "k_scale"), (3, "v_pages"),
                    (4, "v_scale")):
        if not torch.equal(kern[i][1:], plain[i][1:]):
            raise AssertionError(f"{label}: new {name} differ from the "
                                 "plain version")
    out_k, out_p = kern[0][act], plain[0][act]
    if not torch.isfinite(out_k).all():
        raise AssertionError(f"{label}: non-finite attention output")
    err = float((out_k - out_p).abs().max())
    torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
    unf = unfused(c, window, cap)
    if not torch.equal(kern[0][act], unf[0][act]):
        raise AssertionError(f"{label}: fused != unfused attention output")
    for i in (1, 2, 3, 4):
        if not torch.equal(kern[i][1:], unf[i][1:]):
            raise AssertionError(f"{label}: fused != unfused cache update")
    print(f"# {label} vs plain (window {window}, cap {cap}): pages/scales "
          f"bitwise, max |out err| {err:.3e}, fused == unfused bitwise",
          flush=True)
    return err


def _k1_bound(c, el: int, lns: bool, partials: bool = False):
    """K1's bound on ``c``'s inputs, the function's whatever computes it:
    the bytes it must move (each input read once: the query, the pages the
    lengths reach, their scales on FP8 pages, the block tables, lengths
    and inserted rows; its output, the attention [B, KV*G, dv] float32,
    or in the partials mode (M, l, o) [B, KV, G(, dv)], written once)
    against its operations (per head and valid token: hd products and
    their sum, and dv p*v multiply-adds) at the float32 rate.  ``el``:
    bytes of a page element.  Returns (ms, what bounds it, bytes in and
    out, operations, bytes in)."""
    B, KV, G, hd, page, maxp = (c[n] for n in
                                ("B", "KV", "G", "hd", "page", "maxp"))
    ln = c["lengths"] + 1
    pages_needed = int(((ln + page - 1) // page).sum())
    tokens = int(ln.sum())
    dv = c["vp"].shape[-1]
    if lns:
        q_bytes = B * KV * G * hd + 4 * B          # q codes, q scales
        extra = pages_needed * 4 * 2 + 2 * 256 * 2 * 4  # scales, tables
    else:
        q_bytes, extra = 4 * B * KV * G * hd, 0    # the float32 query
    bytes_in = (q_bytes + pages_needed * page * KV * (hd + dv) * el + extra
                + 4 * B * maxp + 4 * B             # block tables, lengths
                + B * KV * (hd + dv) * el + 3 * 4 * B)  # inserted rows
    nbytes = bytes_in + 4 * B * KV * G * (dv + 2 * partials)  # + the out
    ops = 2 * KV * G * tokens * (hd + dv)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_FLOP_PER_S * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations", nbytes,
            ops, bytes_in)


def _time_k1(c, label: str, lns: bool, partials: bool = False) -> dict:
    """Card time of K1 proper on the fused form's inputs as the serving
    path builds them (old pages, new scales, the new rows), of its plain
    version, and the bound; ``partials``: of its partials mode (plain:
    the page partials and their un-normalised combine)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.page_pool import token_row_codes

    ln = c["lengths"] + 1
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    if lns:
        codes, qs = pa.quantize_q(c["q"][:, 0], "e5m2")
        pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
        scales, new_rows = [], []
        for name, new, noise in (("ks", "k_new", "k_noise"),
                                 ("vs", "v_new", "v_noise")):
            s = c[name].clone()
            pid, row, s_new = token_row_codes(s, c[new], pids, rows,
                                              fmt="e5m2", noise=c[noise],
                                              write_mask=c["mask"])
            s.index_put_((pid,), s_new)
            scales.append(s)
            new_rows.append(row)
        args = (codes, qs, c["kp"], c["vp"], *scales, c["bt"], ln)
        kw = dict(fmt="e5m2", mode="rne")
        only = "lns_paged_partials"
    else:
        q, _ = pa.query_operand(c["q"][:, 0], None)
        new_rows = [c["k_new"], c["v_new"]]
        args = (q, None, c["kp"], c["vp"], c["ks"], c["vs"], c["bt"], ln)
        kw = dict(fmt=None, mode="rne")
        only = "float_paged_partials"
    ins = (*new_rows, logical, rows, c["mask"].to(torch.int32))
    kw.update(KV=c["KV"], G=c["G"], inserts=ins)
    k1 = lambda: pa.paged_attend(*args, **kw, partials=partials)  # noqa: E731
    combine = pa._local_combine if partials else pa._combine_partials
    plain = lambda: combine(*pa.page_partials_plain(*args, **kw))  # noqa: E731
    torch.testing.assert_close(k1(), plain(), rtol=1e-4, atol=1e-4)
    ms, how = device_ms(k1, iters=200, only=only)
    plain_ms, plain_how = device_ms(plain, iters=10)
    call_ms, plain_call_ms = cuda_ms(k1, iters=200), cuda_ms(plain, iters=10)
    bound, by, nbytes, ops, bytes_in = _k1_bound(
        c, c["kp"].element_size(), lns, partials)
    dv = c["vp"].shape[-1]
    print(f"# {label} card time ({how}): kernel {ms:.5f} ms; plain "
          f"{plain_ms:.4f} ms ({plain_how}, all its kernels); bound "
          f"{bound:.6f} ms = max({nbytes} B / 3.35 TB/s, {ops} ops / 67 "
          f"TFLOP/s), {ms / bound:.0f}x; per call incl. host: kernel "
          f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; "
          f"{_partials_note(bytes_in, c['B'], c['maxp'], c['KV'], c['G'], dv)}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def check_k1(dev) -> dict:
    """Phase 3: K1 against its plain version at every geometry of
    ``K1_GEOMETRIES`` (and, past qwen2-0.5b's, with window 32 and softcap
    50), the edge cases of :func:`check_k1_edges`, then its timings at the
    ``K1_TIMED`` geometries.  Returns the main path's (gemma3-12b's)
    timings, granite's under ``"moe"``, jamba's under ``"hybrid"``, and the
    largest error over all geometries."""
    err, timed = 0.0, {}
    for name, KV, G, hd in K1_GEOMETRIES:
        c = k1_inputs(dev, KV=KV, G=G, hd=hd)
        label = f"K1 {name} (KV {KV}, G {G}, hd {hd})"
        err = max(err, _k1_fused_gates(c, label))
        if name != "qwen2-0.5b":
            err = max(err, _k1_fused_gates(c, label, window=32, cap=50.0))
        err = max(err, check_k1_edges(c, label))
        if name in K1_TIMED:
            timed[name] = _time_k1(c, label, lns=True)
    return dict(max_abs_err=err, moe=timed[MOE_ARCH],
                hybrid=timed[HYBRID_ARCH], **timed[K1_MAIN])


FLOAT_K1_CASES = (("bfloat16", 0, 0.0), ("float32", 0, 0.0),
                  ("bfloat16", 32, 50.0))     # page dtype, window, softcap


def check_k1_float(dev) -> dict:
    """Phase: K1's float instance against its plain version at every
    geometry of ``K1_GEOMETRIES`` with float pages (bf16 and float32, and
    bf16 with window 32 and softcap 50): new pages bitwise, scales
    unchanged, output within rtol = atol = 1e-4, fused == unfused bitwise;
    then its times on bf16 pages (the serving path's) at the ``K1_TIMED``
    geometries beside the byte bound.  Returns them as :func:`check_k1`
    does."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    err, timed = 0.0, {}
    for name, KV, G, hd in K1_GEOMETRIES:
        geo = dict(KV=KV, G=G, hd=hd)
        for pdt, window, cap in FLOAT_K1_CASES:
            c = k1_float_inputs(dev, getattr(torch, pdt), **geo)
            label = f"K1 float {name} ({pdt} pages)"
            act = c["mask"]
            before = pa.paged_attend.float_launches
            kern, plain = fused(c, "auto", window, cap), fused(c, "ref",
                                                                window, cap)
            torch.cuda.synchronize()
            if pa.paged_attend.float_launches != before + 1:
                raise AssertionError(f"{label}: the fused call did not "
                                     "launch the float instance once")
            for i, page_name in ((1, "k_pages"), (3, "v_pages")):
                if not torch.equal(kern[i][1:], plain[i][1:]):
                    raise AssertionError(f"{label}: new {page_name} differ "
                                         "from the plain version")
            for i, scale in ((2, "ks"), (4, "vs")):
                if not torch.equal(kern[i], c[scale]):
                    raise AssertionError(f"{label}: {scale} changed")
            out_k, out_p = kern[0][act], plain[0][act]
            if not torch.isfinite(out_k).all():
                raise AssertionError(f"{label}: non-finite attention output")
            case_err = float((out_k - out_p).abs().max())
            err = max(err, case_err)
            torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
            unf = unfused(c, window, cap)
            if not torch.equal(kern[0][act], unf[0][act]):
                raise AssertionError(f"{label}: fused != unfused output")
            for i in (1, 2, 3, 4):
                if not torch.equal(kern[i][1:], unf[i][1:]):
                    raise AssertionError(f"{label}: fused != unfused cache "
                                         "update")
            print(f"# {label} vs plain (window {window}, cap {cap}): pages "
                  f"bitwise, scales unchanged, max |out err| {case_err:.3e}, "
                  "fused == unfused bitwise", flush=True)
            if not window:
                err = max(err, check_k1_edges(c, label))
        if name in K1_TIMED:
            c = k1_float_inputs(dev, torch.bfloat16, **geo)
            timed[name] = _time_k1(c, f"K1 float {name} (bf16 pages)",
                                   lns=False)
    return dict(max_abs_err=err, moe=timed[MOE_ARCH],
                hybrid=timed[HYBRID_ARCH], **timed[K1_MAIN])


SERVE_PLENS = (5, 17, 33, 64, 9, 48, 2, 26)   # the serving phases' prompts


def _policy_label(cfg, policy) -> str:
    return cfg.policy.name if policy is not None else "default policy " \
        f"({str(cfg.pdtype).split('.')[-1]} KV pages)"


QWEN_DEPTH = 6     # qwen2-0.5b's serving phases: its first 6 of 24 layers
PROFILE_DEPTH = 6  # every traced window (gemma3-12b: one whole 5:1 period)


def serve_main_path(dev, policy="serve_fp8_paged", plens=SERVE_PLENS,
                    gen=24) -> dict:
    """Phases 5, 7 and 21: the full-width Engine (depth ``QWEN_DEPTH``, cut
    for time) under the continuous scheduler, fused decode on and off.  K1 runs once per layer and
    sub-step, its LNS instance on FP8 pages, its float instance on float
    pages (``policy=None``, the CLI's default), the other instance never;
    K5 runs as often as K1 when the policy quantizes the SwiGLU gate
    product (else never)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import fp8_elementwise as fe
    from repro_torch.launch.serve import Engine

    cfg = dataclasses.replace(get_config("qwen2-0.5b", policy=policy),
                              n_layers=QWEN_DEPTH)
    k5_on = cfg.policy.elementwise.quantized
    label = _policy_label(cfg, policy)
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in plens]
    runs = {}
    for fused_on in (True, False):
        eng = Engine(cfg, slots=8, max_seq=max(plens) + gen, page_size=16,
                     rng_seed=0, fused_decode=fused_on, device=dev)
        fe.fp8_elementwise.launches = 0
        run = _counted_run(eng, queue, gen)
        k5 = fe.fp8_elementwise.launches
        if k5 != (run["launches"] if k5_on else 0):
            raise AssertionError(f"K5 launches {k5}, want "
                                 f"{run['launches'] if k5_on else 0}")
        stats = run["stats"]
        print(f"# serve {label}"
              f"{' + K5 gate' if k5_on else ''} fused={fused_on}: "
              f"{len(queue)} requests finished, {stats['steps']} steps, "
              f"{run['substeps']} sub-steps, {run['lns']} K1 LNS, "
              f"{run['flt']} K1 float and {k5} K5 launches, "
              f"{run['wall']:.3f} s wall, "
              f"{stats['decode_tok_s']:.2f} decode tok/s, cache "
              f"{stats['cache_bytes_per_token']:.0f} B/token", flush=True)
        runs[fused_on] = (run["outputs"], run["launches"], k5)
        del eng
    if runs[True][0] != runs[False][0]:
        raise AssertionError("token streams differ with fused decode on/off")
    print("# token streams bitwise equal with fused decode on and off",
          flush=True)
    return dict(launches=runs[True][1], k5_launches=runs[True][2])


PREEMPT_PAGES = 16   # 15 usable pages against a worst case of 48


LIVELY_POST_GAIN = 16.0   # the sandwich norms' output gains, see _lively


def _lively(eng, seed: int = 0):
    """Redraw every parameter at std 0.5 from a seed, on the card, so that
    greedy tokens follow the context (the seed init's zero gains and 0.02
    weights repeat each prompt's last token), which makes equal token
    streams a sharp test.  Under an embedding scale (gemma) the embedding
    is redrawn at 0.5 / sqrt(d_model), so that it is 0.5 once scaled: at
    0.5 the scaled rows would drown every layer and greedy decoding would
    repeat each prompt's last token again.  Under sandwich norms (gemma)
    the norms' output gains 1 + s are then multiplied by
    ``LIVELY_POST_GAIN``: with gains near 1 the last token's own row (its
    scaled embedding in the residual) still leads the tied LM head at
    gemma3-12b's width, at depth 6 and at depth 48 alike, and most greedy
    streams hold a single token.  With each layer's output 16 times larger
    the embedding's share of the residual falls 16-fold and the layers
    lead; the final norm keeps the logits' scale, so the float32 logit
    gates keep their meaning."""
    import torch

    g = torch.Generator(device=eng.device).manual_seed(seed)

    def redraw(t):  # in place: the card never holds two copies
        if isinstance(t, dict):
            for v in t.values():
                redraw(v)
        elif isinstance(t, list):
            for v in t:
                redraw(v)
        else:
            t.copy_((torch.randn(t.shape, generator=g, device=t.device)
                     * 0.5).to(t.dtype))

    redraw(eng.params)
    if eng.cfg.emb_scale:
        eng.params["embed"] = eng.params["embed"] / eng.cfg.d_model**0.5
    if eng.cfg.sandwich_norm:
        for layer in eng.params["blocks"]:
            for name in ("ln1_post", "ln2_post"):
                gain = (1.0 + layer[name].float()) * LIVELY_POST_GAIN
                layer[name] = (gain - 1.0).to(layer[name].dtype)
    return eng


def _shallow(params, depth: int):
    """The first ``depth`` layers of the main path's weights (the leading
    dense ``prefix`` layers kept, then the first body layers)."""
    return dict(params, blocks=params["blocks"][
        :depth - len(params.get("prefix", ()))])


def _require_varied(outputs: dict, what: str,
                    constant_share: float = 0.0) -> list:
    """Equal token streams are a sharp test only when the streams follow
    their context.  Every stream must change token at least once (at most
    a share ``constant_share`` of them may hold a single token), and the
    streams must hold at least two distinct tokens each on average.  The
    main path's 16-token full-depth streams take the strict rule; shorter
    or shallower runs allow a quarter, since a stream may hold one token
    for its first 8 and turn later (gemma3-12b's bucketed FP8 streams:
    [8, 8, 5, 1, 8, 7, 6, 8] distinct tokens at 8 generated, [15, 14, 13,
    8, 11, 14, 12, 16] at 16).  Returns the distinct tokens per stream."""
    distinct = [len(set(o)) for o in outputs.values()]
    constant = sum(d == 1 for d in distinct)
    if (constant > constant_share * len(distinct)
            or sum(distinct) < 2 * len(distinct)):
        raise AssertionError(f"{what}: degenerate token streams, distinct "
                             f"tokens per stream {distinct}: the check "
                             "would be weak")
    return distinct


def preemption_path(dev, policy) -> dict:
    """Phase: preemption at full width, depth ``QWEN_DEPTH`` (cut for
    time; the scheduler's choices do not depend on depth).  The serving
    phases' 8 requests on lively weights, fused decode, once with a
    worst-case pool and once
    with ``PREEMPT_PAGES`` pages: the small pool makes the scheduler spill
    slots to the host and restore them into fresh pages; every request
    finishes and the token streams equal the worst-case run's bit for
    bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = dataclasses.replace(get_config("qwen2-0.5b", policy=policy),
                              n_layers=QWEN_DEPTH)
    label = _policy_label(cfg, policy)
    gen = 24
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in SERVE_PLENS]
    runs = []
    for pages in (None, PREEMPT_PAGES):
        eng = _lively(Engine(cfg, slots=8, max_seq=max(SERVE_PLENS) + gen,
                             page_size=16, num_pages=pages, rng_seed=0,
                             device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs, stats = run_continuous(eng, queue, gen=gen, chunk=4,
                                        quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if stats["terminal"] != {"finished": len(queue)}:
            raise AssertionError(f"preemption run ({label}, {pages} pages): "
                                 f"{stats['statuses']}")
        eng.pool.assert_invariants()
        print(f"# preemption run {label}, pool "
              f"{eng.pool.num_pages - 1} pages: {stats['steps']} steps, "
              f"{stats['preemptions']} preemptions, {stats['restores']} "
              f"restores, {wall:.3f} s wall", flush=True)
        runs.append((outputs, stats))
        del eng
    (full, s_full), (small, s_small) = runs
    if s_full["preemptions"] or s_small["preemptions"] < 1 \
            or s_small["restores"] < 1:
        raise AssertionError(f"preemptions {s_full['preemptions']} / "
                             f"{s_small['preemptions']}, restores "
                             f"{s_small['restores']}: want 0, then >= 1")
    if not any(len(set(o)) > 1 for o in full.values()):
        raise AssertionError("degenerate token streams: the check would "
                             "be weak")
    if small != full:
        raise AssertionError(f"{label}: token streams differ with "
                             "preemption")
    print(f"# preempt/restore == uninterrupted ({label}): token streams "
          "bitwise equal", flush=True)
    return dict(preemptions=s_small["preemptions"],
                restores=s_small["restores"])


def _first_step_logits(dev, cfg, params=None):
    """A prefill chunk and one decode step of a 2-slot Engine (on
    ``params`` when given, else on its own seed-3 draw): logits."""
    import numpy as np
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 4)).astype(np.int32)
    eng = Engine(cfg, slots=2, max_seq=16, page_size=16, rng_seed=3,
                 device=dev)
    if params is not None:
        eng.params = params
    eng.pool.ensure_capacity_batch(np.asarray([4, 3]))
    first = eng.step_chunk(toks, np.zeros(2, np.int32),
                           np.asarray([4, 3], np.int32))
    second = eng.step_chunk(toks[:, :1], np.asarray([4, 3], np.int32),
                            np.asarray([1, 1], np.int32))
    return np.stack([first, second])


def check_against_plain_engine(dev, policy="serve_fp8_paged") -> None:
    """Float32 copy of the model: first-step logits through K1 and through
    the plain attention (policy attention_qk impl="ref") agree; FP8 pages
    under serve_fp8_paged, float32 pages under the default policy."""
    import numpy as np
    from repro_torch.configs import get_config

    base = get_config("qwen2-0.5b", policy=policy)
    cfg = dataclasses.replace(base, param_dtype="float32")
    ref_pol = base.policy.replace(attention_qk=dataclasses.replace(
        base.policy.attention_qk, impl="ref"))
    logits = [_first_step_logits(dev, c) for c in
              (cfg, dataclasses.replace(cfg, numerics=ref_pol))]
    np.testing.assert_allclose(logits[0], logits[1], rtol=1e-3, atol=1e-3)
    print(f"# float32 engine ({_policy_label(base, policy)}): K1 vs "
          f"plain-attention logits max diff "
          f"{np.abs(logits[0] - logits[1]).max():.3e}", flush=True)


def profile_main_path(dev, policy="serve_fp8_paged",
                      arch="qwen2-0.5b", depth=None) -> None:
    """A short traced window of a serving path (8 requests, 4-token
    prompts, 4 generated tokens, after a warm-up run; ``arch`` at full
    width, its first ``depth`` layers when given): the card's busy share
    of the window's wall time, the launches per sub-step and the kernels
    that take the time.  CUDA activity only, so the host pays little for
    the tracing."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = get_config(arch, policy=policy)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    eng = Engine(cfg, slots=8, max_seq=16, page_size=16, rng_seed=0,
                 device=dev)
    rng = np.random.default_rng(2)
    run_continuous(eng, [rng.integers(0, cfg.vocab, size=4)
                         for _ in range(8)], gen=2, quiet=True)
    queue = [rng.integers(0, cfg.vocab, size=4) for _ in range(8)]
    sub0 = eng.tel.counter_value("serve_substeps_total")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_continuous(eng, queue, gen=4, quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    substeps = int(eng.tel.counter_value("serve_substeps_total") - sub0)
    rows = _device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e6
    if busy <= 0:
        print(f"# profile of {arch}'s serving path: {substeps} sub-steps in "
              f"{wall:.4f} s wall; the profiler recorded no device time "
              "(busy share and launches not measured)", flush=True)
        return
    k1 = sum(us for k, us, _ in rows if "paged_partials" in k) / 1e6
    k5 = sum(us for k, us, _ in rows if "fp8_elementwise_kernel" in k) / 1e6
    n_kernels = sum(n for _, _, n in rows)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    ew = cfg.policy.elementwise
    label = _policy_label(cfg, policy) + (f", elementwise {ew.fmt}"
                                          if ew.quantized else "")
    print(f"# profile of {arch}'s serving path (depth {cfg.n_layers}, "
          f"{label}): {substeps} "
          f"sub-steps in "
          f"{wall:.4f} s wall; card busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}% of the wall), {n_kernels} kernel "
          f"launches ({n_kernels / max(substeps, 1):.0f} per sub-step); "
          f"K1 {k1:.5f} s ({100 * k1 / busy:.2f}% of busy), K5 {k5:.5f} s "
          f"({100 * k5 / busy:.2f}%)", flush=True)
    for key, us, n in top:
        print(f"#   {us / 1e3:10.3f} ms  x{n:<6d} {key[:90]}", flush=True)

# --------------------------------------------------------------------------- #
# The dense GQA family and prefix caching: gemma3-12b's main path, and
# gemma2-27b and qwen3-14b
# --------------------------------------------------------------------------- #
MAIN_DEPTH = 6     # gemma3-12b's FP8 main path: one whole 5:1 period
# (cut for time from 48, to pay for deepseek's and mamba2's phases)
PREFIX_SHARED = 64                            # 4 full pages of 16
PREFIX_TAILS = (5, 17, 9, 2, 26, 12, 31, 7)   # each request's own tail
PREFIX_GEN = 16
PREFIX_SLOTS = 4
PREFIX_PREEMPT_DEPTH = 6                      # one whole 5:1 period
PREFIX_PREEMPT_PAGES = 19                     # 18 usable pages of 28


def _prefix_queue(cfg):
    """The 8 requests: one shared 64-token prefix, then each one's tail."""
    import numpy as np

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, size=PREFIX_SHARED)
    return [np.concatenate([shared, rng.integers(0, cfg.vocab, size=t)])
            for t in PREFIX_TAILS]


def _prefix_engine(dev, cfg, params, **kw):
    """A 4-slot Engine of the prefix phases on ``params`` (its own seed-0
    draw is dropped), or on its own draw when ``params`` is None."""
    from repro_torch.launch.serve import Engine

    eng = Engine(cfg, slots=PREFIX_SLOTS,
                 max_seq=PREFIX_SHARED + max(PREFIX_TAILS) + PREFIX_GEN,
                 page_size=16, rng_seed=0, device=dev, **kw)
    if params is not None:
        eng.params = params
    return eng


@contextlib.contextmanager
def _invariant_checks():
    """``REPRO_CHECK_INVARIANTS=1`` within the block: the scheduler checks
    the pool's invariants after every step."""
    saved = os.environ.get("REPRO_CHECK_INVARIANTS")
    os.environ["REPRO_CHECK_INVARIANTS"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("REPRO_CHECK_INVARIANTS", None)
        else:
            os.environ["REPRO_CHECK_INVARIANTS"] = saved


def _counted_run(eng, queue, gen: int, scheduler: str = "continuous") -> dict:
    """``run`` under ``scheduler`` with every K1 count set to 0 just before
    and read just after; every step's logits checked finite and of the
    vocabulary's width.  Returns the run's outputs, stats, wall, sub-steps
    and K1 launches of each instance (none on a dense cache; one a
    sub-step for each attention layer, every layer of a GQA stack, one in
    eight of jamba's)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import run
    from repro_torch.models.model import attention_layers

    sync, vocab = eng.sync_logits, eng.cfg.vocab

    def checked(logits):
        host = sync(logits)
        if host.shape[-1] != vocab or not np.isfinite(host).all():
            raise AssertionError("non-finite or misshapen logits")
        return host

    eng.sync_logits = checked
    torch.cuda.synchronize()
    pa.paged_attend.launches = 0
    pa.paged_attend.float_launches = 0
    t0 = time.perf_counter()
    outputs, stats = run(eng, queue, gen=gen, chunk=4, quiet=True,
                         scheduler=scheduler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(outputs=outputs, stats=stats, wall=wall,
               substeps=int(eng.tel.counter_value("serve_substeps_total")),
               lns=pa.paged_attend.launches,
               flt=pa.paged_attend.float_launches)
    if stats["terminal"] != {"finished": len(queue)}:
        raise AssertionError(f"requests not all finished: "
                             f"{stats['statuses']}")
    if sorted(outputs) != list(range(len(queue))) or any(
            len(o) != gen for o in outputs.values()):
        raise AssertionError("missing or short token streams")
    fp8 = eng.cfg.policy.kv_quantized
    launches, other = ((run["lns"], run["flt"]) if fp8
                       else (run["flt"], run["lns"]))
    if eng.cache_impl == "dense" or eng.cfg.attn_impl != "gqa":
        if launches or other:
            raise AssertionError(f"K1 launched {launches} + {other} times "
                                 "on a cache without pages")
        run["launches"] = 0
        return run
    n_attn = len(attention_layers(eng.cfg))
    if launches != n_attn * run["substeps"] or other:
        raise AssertionError(
            f"K1 {'LNS' if fp8 else 'float'} launches {launches} != "
            f"attention layers {n_attn} x sub-steps {run['substeps']}, or "
            f"{other} launches of the other instance")
    run["launches"] = launches
    return run


def _cache_digest(cache) -> str:
    """SHA-256 of a paged cache's bytes (kp, vp, ks, vs in that order, or
    MLA's ckv, kpe), the cache's fingerprint for a bitwise comparison
    across processes."""
    import hashlib
    import torch

    h = hashlib.sha256()
    for name in [n for n in ("kp", "vp", "ks", "vs", "ckv", "kpe")
                 if n in cache]:
        t = cache[name].contiguous()
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def prefix_main_path(dev, policy, params=None, depth=None) -> dict:
    """This slice's main path: full-width gemma3-12b (48 layers, 5 local
    layers of window 1,024 to each global one, hd 256; its first
    ``depth`` layers when given: ``MAIN_DEPTH`` on FP8 pages and 6 on
    bf16 pages, cut for time) served through the
    Engine with the prefix cache, 4 slots, page 16, a worst-case pool; 8
    requests of a shared 64-token prefix and their own
    tails, 16 generated tokens each, chunk 4.  Two runs, fused decode:
    prefix off and prefix on (unfused decode runs at depth 6 in
    :func:`preempt_shared_path`, cut for time).
    Gates: the two token streams bitwise equal and each stream varied
    (:func:`_require_varied`), at least 256 prefix hit tokens with the
    cache on (the second wave maps the 4 prefix pages), K1 launched
    n_layers x sub-steps times in every run and its other instance never.
    Weights: drawn on the card from seed 0, redrawn by :func:`_lively`
    (shared by both policies' runs; returned)."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-12b", policy=policy)
    served = params
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
        served = None if params is None else _shallow(params, depth)
    label = _policy_label(cfg, policy)
    queue = _prefix_queue(cfg)
    runs = {}
    for prefix_on, fused_on in ((False, True), (True, True)):
        eng = _prefix_engine(dev, cfg, served, prefix_cache=prefix_on,
                             fused_decode=fused_on)
        if served is None:
            params = served = _lively(eng).params
        run = _counted_run(eng, queue, PREFIX_GEN)
        run["digest"] = _cache_digest(eng.cache)
        hits = run["stats"]["prefix_hit_tokens"]
        print(f"# gemma3-12b depth {cfg.n_layers} serve {label}, prefix "
              f"{'on' if prefix_on else 'off'}, fused={fused_on}: "
              f"{len(queue)} requests, {run['stats']['steps']} steps, "
              f"{run['substeps']} sub-steps, {run['lns']} K1 LNS and "
              f"{run['flt']} K1 float launches, {hits} prefix hit tokens "
              f"(prefix stats {run['stats']['prefix']}), {run['wall']:.3f} s "
              f"wall, {run['stats']['decode_tok_s']:.2f} decode tok/s",
              flush=True)
        if (hits >= 4 * PREFIX_SHARED) != prefix_on:
            raise AssertionError(f"prefix {'on' if prefix_on else 'off'}: "
                                 f"{hits} prefix hit tokens")
        runs[prefix_on, fused_on] = run
        del eng
        torch.cuda.empty_cache()
    streams = [r["outputs"] for r in runs.values()]
    distinct = _require_varied(streams[0], f"gemma3-12b {label}",
                               0.0 if depth is None else 0.25)
    if streams[1] != streams[0]:
        raise AssertionError(f"gemma3-12b {label}: token streams differ with "
                             "the prefix cache on/off")
    print(f"# gemma3-12b {label}: token streams bitwise equal with the "
          f"prefix cache off and on; distinct tokens per stream {distinct}",
          flush=True)
    return dict(launches=runs[True, True]["launches"], params=params,
                outputs=streams[0], wall=runs[True, True]["wall"],
                digest=runs[True, True]["digest"])


def preempt_shared_path(dev, policy, params) -> dict:
    """Preemption while shared: the prefix phase's requests at full width
    and depth 6 (one whole 5:1 period; the main path's weights, their
    first 6 layers), prefix on, once with a worst-case pool and once with
    ``PREFIX_PREEMPT_PAGES`` pages, under which the scheduler spills slots
    that map registered prefix pages: those stay resident under a pin
    (at least one spill must pin a page); then the worst-case pool with
    unfused decode (the main path's third run until it was cut for time).  ``assert_invariants`` runs after
    every step (``REPRO_CHECK_INVARIANTS=1``); the token streams equal the
    worst-case pool's bit for bit, and vary (:func:`_require_varied`, at
    most a quarter of them on one token).  Returns the worst-case pool's
    streams too: :func:`bucketed_path` holds its depth-6 runs to them."""
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("gemma3-12b", policy=policy),
                              n_layers=PREFIX_PREEMPT_DEPTH)
    label = _policy_label(cfg, policy)
    shallow = _shallow(params, PREFIX_PREEMPT_DEPTH)
    queue = _prefix_queue(cfg)
    runs = []
    with _invariant_checks():
        for pages, fused_on in ((None, True), (PREFIX_PREEMPT_PAGES, True),
                                (None, False)):
            eng = _prefix_engine(dev, cfg, shallow, prefix_cache=True,
                                 num_pages=pages, fused_decode=fused_on)
            pinned = []
            spill = eng.pool.spill_slot

            def counted_spill(slot, spill=spill, pinned=pinned):
                out = spill(slot)
                pinned.append(len(out[1]))
                return out

            eng.pool.spill_slot = counted_spill
            run = _counted_run(eng, queue, PREFIX_GEN)
            run["digest"] = _cache_digest(eng.cache)
            eng.pool.assert_invariants()
            st = run["stats"]
            print(f"# gemma3-12b depth {cfg.n_layers} prefix on {label}, "
                  f"fused={fused_on}, pool "
                  f"{eng.pool.num_pages - 1} pages: {st['steps']} steps, "
                  f"{st['preemptions']} preemptions, {st['restores']} "
                  f"restores, {sum(1 for n in pinned if n)} spills pinning "
                  f"{sum(pinned)} prefix pages, {st['prefix_hit_tokens']} "
                  f"prefix hit tokens, {run['wall']:.3f} s wall", flush=True)
            runs.append((run, pinned))
            del eng
            torch.cuda.empty_cache()
    (full, _), (small, pinned), (unfused, _) = runs
    if full["stats"]["preemptions"] or small["stats"]["preemptions"] < 1 \
            or small["stats"]["restores"] < 1 or not any(pinned):
        raise AssertionError(
            f"preemptions {full['stats']['preemptions']} / "
            f"{small['stats']['preemptions']}, restores "
            f"{small['stats']['restores']}, pinned pages per spill {pinned}: "
            "want 0, then >= 1 with a pinned spill")
    distinct = _require_varied(full["outputs"], f"preempt-while-shared "
                               f"{label}", constant_share=0.25)
    if small["outputs"] != full["outputs"]:
        raise AssertionError(f"{label}: token streams differ with "
                             "preemption while shared")
    if unfused["outputs"] != full["outputs"] or unfused["stats"][
            "preemptions"]:
        raise AssertionError(f"{label}: token streams differ with unfused "
                             "decode")
    print(f"# preempt-while-shared == worst-case pool == unfused decode "
          f"(gemma3-12b, {label}): token streams bitwise equal; distinct "
          f"tokens per stream {distinct}", flush=True)
    return dict(preemptions=small["stats"]["preemptions"],
                restores=small["stats"]["restores"], pinned=sum(pinned),
                outputs=full["outputs"], wall=full["wall"],
                digest=full["digest"])


# --------------------------------------------------------------------------- #
# Fault-tolerant serving: the chaos harness, crash snapshots, a kill and a
# restore through ``runtime.fault.run_serving``
# --------------------------------------------------------------------------- #
CHAOS_PAGES = PREFIX_PREEMPT_PAGES   # 18 usable pages of the worst case's 28
# BENCH_5's fault rates (benchmarks/run.py::serve_chaos); a CPU rehearsal
# at smoke size (the scheduler's choices do not depend on width) puts the
# kill after the snapshot of step 24, which holds a PREEMPTED request
CHAOS_PLAN = dict(seed=1, pool_exhaustion=0.25, exhaustion_pages=2,
                  exhaustion_hold=3, preemption_storm=0.15, corruption=0.15,
                  overrun=0.2, kill_at_step=28)
CHAOS_SNAPSHOT_EVERY = 8
# the 8 requests arrive together on 4 slots: a queue of 7 sheds the newest;
# 80 steps lie past the fault-free run's 57 and short of the last admitted
# request's finish under chaos, which expires
CHAOS_MAX_QUEUE = 7
CHAOS_DEADLINE_STEPS = 80
CHAOS_DEPTH = 6       # both page kinds: one whole 5:1 period


def _latest_snapshot(ckpt) -> dict:
    """The latest snapshot under ``ckpt``: its step, bytes on disk and
    PREEMPTED requests, and the snapshots on disk."""
    import pathlib
    from repro_torch.checkpoint import store

    step = store.latest_step(ckpt)
    d = pathlib.Path(ckpt) / f"step-{step}"
    sched = json.loads((d / "manifest.json").read_text())[
        "data_state"]["scheduler"]
    return dict(step=step, bytes=sum(f.stat().st_size for f in d.iterdir()),
                preempted=len(sched["preempted"]),
                on_disk=len(list(pathlib.Path(ckpt).glob("step-*"))))


def _chaos_run(dev, cfg, policy, params, base: dict) -> None:
    """The prefix phase's 8 requests through ``run_serving`` under
    ``CHAOS_PLAN`` (page exhaustion, preemption storms, refcount-corruption
    drills, watchdog overruns and one kill), prefix cache on, a pool of
    ``CHAOS_PAGES``, a snapshot every ``CHAOS_SNAPSHOT_EVERY`` steps, the
    deadlines and queue bound above, pool invariants after every step.
    Gates: every fault kind injected; one restart, from a snapshot with at
    least two on disk and a PREEMPTED request in it; every FINISHED stream
    bitwise equal to ``base["outputs"]`` (the same requests fault-free,
    in ``base["wall"]`` seconds) and varied;
    every other request in a terminal state, at least one shed or
    expired; the pool clean after the seizures' release; K1 launched
    n_layers x the sub-steps of the killed engine and its successor, its
    other instance never; the successor's first K1 calls (its first step,
    on the restored pages) within rtol = atol = 1e-4 of the plain version
    (:class:`_ShadowK1`); every step's logits finite."""
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.fault import run_serving
    from repro_torch.serving import FINISHED, TERMINAL_STATES, FaultPlan

    label = f"gemma3-12b depth {cfg.n_layers} {_policy_label(cfg, policy)}"
    queue = _prefix_queue(cfg)
    engines, restored, shadows, substeps, logs = [], {}, [], [0], []

    def make_engine():
        # drop the killed engine (its wrapped methods form cycles) before
        # its successor draws its own weights
        successor = bool(engines)
        engines.clear()
        gc.collect()
        if successor:
            restored.update(_latest_snapshot(ckpt))
        eng = _prefix_engine(dev, cfg, params, prefix_cache=True,
                             num_pages=CHAOS_PAGES)
        step_chunk, sync = eng.step_chunk, eng.sync_logits

        def counted(tokens, *args, **kw):
            substeps[0] += np.asarray(tokens).shape[1]
            if successor and not shadows:
                with _ShadowK1() as shadow:
                    out = step_chunk(tokens, *args, **kw)
                shadows.append(shadow)
                return out
            return step_chunk(tokens, *args, **kw)

        def checked(logits):
            host = sync(logits)
            if host.shape[-1] != cfg.vocab or not np.isfinite(host).all():
                raise AssertionError("non-finite or misshapen logits")
            return host

        eng.step_chunk, eng.sync_logits = counted, checked
        engines.append(eng)
        return eng

    with _invariant_checks(), tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pa.paged_attend.launches = 0
        pa.paged_attend.float_launches = 0
        t0 = time.perf_counter()
        out, stats = run_serving(
            make_engine, queue, gen=PREFIX_GEN, chunk=4,
            deadline_steps=CHAOS_DEADLINE_STEPS, max_queue=CHAOS_MAX_QUEUE,
            chaos=FaultPlan(**CHAOS_PLAN), ckpt_dir=ckpt,
            snapshot_every=CHAOS_SNAPSHOT_EVERY, step_deadline_s=3600.0,
            log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lns, flt = pa.paged_attend.launches, pa.paged_attend.float_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = engines[0]
    for line in logs:
        if "overran" not in line:
            print(f"# {line}", flush=True)
    tel, counts = stats["telemetry"], stats["chaos"]
    save_h = tel.histogram("snapshot_save_seconds")
    restore_h = tel.histogram("snapshot_restore_seconds")
    print(f"# {label} chaos: {stats['steps']} steps, {substeps[0]} sub-steps "
          f"over both engines, {lns} K1 LNS and {flt} K1 float launches, "
          f"{stats['preemptions']} preemptions, faults {counts}, "
          f"{stats['watchdog_overruns']} watchdog overruns survived, "
          f"{stats['restarts']} restart from the snapshot of step "
          f"{stats['restored_from']} ({restored.get('bytes')} B on disk, "
          f"{restored.get('preempted')} PREEMPTED requests in it, "
          f"{restored.get('on_disk')} snapshots on disk), "
          f"{stats['snapshots']} snapshots taken; save "
          f"{save_h.sum / max(save_h.count, 1):.4f} s mean over "
          f"{save_h.count}, restore {restore_h.sum:.4f} s; terminal "
          f"{stats['terminal']}; {wall:.3f} s wall against the fault-free "
          f"run's {base['wall']:.3f} s; peak {peak:.2f} GiB", flush=True)
    for rid, (state, reason) in sorted(stats["statuses"].items()):
        if state != FINISHED:
            print(f"#   request {rid}: {state} ({reason})", flush=True)
    kinds = ("exhaustion", "storm", "corruption", "overrun", "killed")
    if (any(counts[k] < 1 for k in kinds) or stats["restarts"] != 1
            or stats["restored_from"] is None
            or restored.get("step", 0) < 2 * CHAOS_SNAPSHOT_EVERY
            or restored.get("preempted", 0) < 1):
        raise AssertionError(f"{label}: faults {counts}, restarts "
                             f"{stats['restarts']}, restored {restored}")
    terminal = stats["terminal"]
    if (not set(terminal) <= {"finished", "timed_out", "rejected"}
            or terminal.get("finished", 0) < 1
            or terminal.get("finished", 0) == len(queue)
            or any(s not in TERMINAL_STATES
                   for s, _ in stats["statuses"].values())):
        raise AssertionError(f"{label}: terminal {terminal}, "
                             f"statuses {stats['statuses']}")
    if any(out[rid] != base["outputs"][rid] for rid in out):
        raise AssertionError(f"{label}: a survivor's tokens differ from the "
                             "fault-free run's")
    # full-depth 16-token streams take the strict rule, shallower a quarter
    distinct = _require_varied(out, f"{label} chaos survivors",
                               constant_share=0.25 * (cfg.n_layers < 48))
    if eng.pool.free_pages != eng.pool.num_pages - 1:
        raise AssertionError(f"{label}: {eng.pool.free_pages} free pages of "
                             f"{eng.pool.num_pages - 1} after the run")
    eng.pool.assert_invariants()
    launches, other = (lns, flt) if cfg.policy.kv_quantized else (flt, lns)
    if launches != cfg.n_layers * substeps[0] or other:
        raise AssertionError(f"{label}: K1 launches {launches} != n_layers "
                             f"{cfg.n_layers} x sub-steps {substeps[0]}, or "
                             f"{other} of the other instance")
    shadow = shadows[0]
    print(f"# {label} chaos: {len(out)} survivors bitwise equal to the "
          f"fault-free streams (distinct tokens per stream {distinct}); the "
          f"successor's first {shadow.calls} K1 calls within "
          f"{shadow.err:.3e} of the plain version", flush=True)
    engines.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _snapshot_roundtrip(dev, cfg, params) -> None:
    """Save while a request sits PREEMPTED (the chaos pool makes the
    scheduler spill), load into a freshly built engine: every cache tensor
    and every spill tensor bitwise equal (``torch.equal``), the pool's
    state equal."""
    import tempfile
    import torch
    from repro_torch.serving import (ContinuousScheduler, Request,
                                     load_snapshot, save_snapshot)

    def build():
        eng = _prefix_engine(dev, cfg, params, prefix_cache=True,
                             num_pages=CHAOS_PAGES)
        return eng, ContinuousScheduler(eng, chunk=4)

    eng, sched = build()
    for i, prompt in enumerate(_prefix_queue(cfg)):
        sched.add(Request(rid=i, prompt=prompt, gen=PREFIX_GEN))
    while not sched.preempted:
        if not sched.pending():
            raise AssertionError("the pool never forced a preemption")
        sched.step()
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        save_snapshot(ckpt, eng, sched)
        t1 = time.perf_counter()
        eng2, sched2 = build()
        t2 = time.perf_counter()
        step = load_snapshot(ckpt, eng2, sched2)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        size = _latest_snapshot(ckpt)["bytes"]
    spills = [(r.spill["state"], r2.spill["state"])
              for r, r2 in zip(sched.preempted, sched2.preempted)]
    if (step != sched.steps or len(spills) != len(sched.preempted)
            or eng2.pool.state_dict() != eng.pool.state_dict()
            or any(not torch.equal(eng2.cache[k], t)
                   for k, t in eng.cache.items())
            or any(a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])
                   for a, b in spills for k in a)):
        raise AssertionError("snapshot round trip: restored state differs")
    print(f"# gemma3-12b depth {cfg.n_layers} {eng.cache['kp'].dtype} pages: "
          f"snapshot at step {step} with {len(spills)} PREEMPTED requests "
          f"({sum(r.spill['n_pages'] for r in sched.preempted)} spilled "
          f"pages), {size} B on disk, saved in {t1 - t0:.4f} s, loaded into "
          f"a fresh engine in {t3 - t2:.4f} s: every cache and spill tensor "
          "bitwise equal", flush=True)
    del eng, eng2, sched, sched2, spills
    torch.cuda.empty_cache()


def chaos_path(dev, params, fp8_base: dict, bf16_base: dict) -> None:
    """Phase: fault-tolerant serving (:func:`_chaos_run`) at gemma3-12b's
    full width, depth ``CHAOS_DEPTH`` (the main path's first layers, cut
    for time as :func:`preempt_shared_path`), on
    FP8 pages (serve_fp8_paged, stochastic KV writes), its survivors held
    to :func:`preempt_shared_path`'s streams under that policy
    (``fp8_base``); then on the CLI's default bf16 pages: a snapshot round
    trip (:func:`_snapshot_roundtrip`) and the same chaos run, its
    survivors held to :func:`preempt_shared_path`'s default-policy streams
    (``bf16_base``)."""
    from repro_torch.configs import get_config

    shallow = _shallow(params, CHAOS_DEPTH)
    cfg = dataclasses.replace(get_config("gemma3-12b",
                                         policy="serve_fp8_paged"),
                              n_layers=CHAOS_DEPTH)
    _chaos_run(dev, cfg, "serve_fp8_paged", shallow, fp8_base)
    cfg = dataclasses.replace(get_config("gemma3-12b"), n_layers=CHAOS_DEPTH)
    _snapshot_roundtrip(dev, cfg, shallow)
    _chaos_run(dev, cfg, None, shallow, bf16_base)


# --------------------------------------------------------------------------- #
# Tensor-parallel serving: two ranks of a mesh on one card
# --------------------------------------------------------------------------- #
MESH_TP = 2
MESH_DEPTH = 6             # both page kinds: one whole 5:1 period, as in 11
MESH_BACKEND = "gloo"      # NCCL refuses two ranks on one device
MESH_TIMEOUT_S = 600.0     # the whole two-rank run, spawn to join
MESH_K1 = dict(KV=8 // MESH_TP, G=2, hd=256)   # gemma3-12b's K1 per shard


def _mesh_serve(mesh, device, policy, depth: int, params,
                arch: str = K1_MAIN) -> dict:
    """One rank's serving run (in its own process): the prefix phase's
    ``arch`` engine on ``mesh`` (prefix on, fused decode, a worst-case
    pool), its own draw replaced by its cut of ``params`` (the parent's
    tensors, by CUDA IPC: the replicated leaves are shared, the sharded
    ones copied), the 8 requests through :func:`_counted_run` (K1
    launched n_layers x sub-steps by this rank, at its KV heads), its
    first n_layers K1 calls held to the plain version
    (:class:`_ShadowK1`); then the whole cache, gathered over the ranks,
    as a digest."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(get_config(arch, policy=policy),
                              n_layers=depth)
    eng = _prefix_engine(device, cfg, None, prefix_cache=True, mesh=mesh)
    eng.params = None          # the engine's own draw, before the cut
    torch.cuda.empty_cache()
    eng.params = sharding.shard_params(cfg, params, mesh, cfg.policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _ShadowK1(limit=cfg.n_layers) as shadow:
        run = _counted_run(eng, _prefix_queue(cfg), PREFIX_GEN)
    peak = torch.cuda.max_memory_allocated()
    digest = _cache_digest(eng.gather_cache())
    out = dict(outputs=run["outputs"], substeps=run["substeps"],
               launches=run["launches"], wall=run["wall"],
               decode_tok_s=run["stats"]["decode_tok_s"],
               hits=run["stats"]["prefix_hit_tokens"], digest=digest,
               peak=peak, shadow_calls=shadow.calls, shadow_err=shadow.err,
               kv_heads=int(eng.cache["kp"].shape[3]))
    del eng
    gc.collect()  # _counted_run's wrapped methods hold the engine in a cycle
    torch.cuda.empty_cache()
    return out


def _mesh_partials(mesh) -> dict:
    """K1's partials mode on the card, per rank, both instances at
    gemma3-12b's per-shard geometry (``MESH_K1``; FP8 and bf16 pages):
    one shard's (M, l, o) normalised against ``paged_attend`` on the same
    table, and the two halves of every slot's pages, one a rank, merged
    across the ranks by ``combine_partials_psum`` against ``paged_attend``
    on the whole table, both within the reference's rtol 2e-5 / atol 2e-6
    (``tests/test_serving_distributed.py``)."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    dev = mesh.device
    errs = {}
    for lns in (True, False):
        c = (k1_inputs(dev, **MESH_K1) if lns
             else k1_float_inputs(dev, torch.bfloat16, **MESH_K1))
        q_op = pa.query_operand(c["q"][:, 0], c["fmt"])
        ln = c["lengths"] + 1
        pages = (c["kp"], c["vp"], c["ks"], c["vs"])
        kw = dict(fmt=c["fmt"], mode="rne", KV=c["KV"], G=c["G"])
        whole = pa.paged_attend(*q_op, *pages, c["bt"], ln, **kw)
        m, l, o = pa.paged_attention_partials(q_op, *pages, c["bt"], ln,
                                              page_size=c["page"], **kw)
        norm = (o / torch.clamp_min(l, 1e-37)[..., None]).reshape(whole.shape)
        torch.testing.assert_close(norm, whole, rtol=2e-5, atol=2e-6)
        half, page, r = c["maxp"] // mesh.tp, c["page"], mesh.rank
        bt = c["bt"][:, r * half:(r + 1) * half].contiguous()
        ln_r = torch.clamp(ln - r * half * page, 0, half * page).to(ln.dtype)
        split = pa.combine_partials_psum(
            *pa.paged_attention_partials(q_op, *pages, bt, ln_r,
                                         page_size=page, **kw), mesh)
        torch.testing.assert_close(split, whole, rtol=2e-5, atol=2e-6)
        errs["lns" if lns else "float"] = max(
            float((norm - whole).abs().max()),
            float((split - whole).abs().max()))
    torch.cuda.synchronize()
    return dict(errs=errs, launches=pa.paged_attend.partials_launches,
                float_launches=pa.paged_attend.float_partials_launches)


def _mesh_rank(mesh, params, arch: str = K1_MAIN, partials: bool = True
               ) -> dict:
    """The body of each rank of :func:`mesh_path` and :func:`moe_path`:
    ``arch`` on FP8 pages and on bf16 pages at the depth of ``params``,
    then, when asked, K1's partials mode.  The process inherits the parent's
    ``CUBLAS_WORKSPACE_CONFIG`` (no split-K, set at the script's start),
    which its engines require."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    depth = len(params["blocks"])
    fp8 = _mesh_serve(mesh, mesh.device, "serve_fp8_paged", depth, params,
                      arch)
    bf16 = _mesh_serve(mesh, mesh.device, None, depth, params, arch)
    return dict(rank=mesh.rank, transport=mesh.transport, fp8=fp8,
                bf16=bf16, partials=_mesh_partials(mesh) if partials else None)


def _spawn_ranks(dev, *args) -> tuple:
    """``_mesh_rank(mesh, *args)`` on ``MESH_TP`` spawned ranks sharing
    this card over ``MESH_BACKEND``; returns (the ranks' results,
    spawn-to-join seconds)."""
    import tempfile
    from repro_torch.launch.mesh import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(_mesh_rank, MESH_TP,
                          init_file=os.path.join(tmp, "store"),
                          backend=MESH_BACKEND, device=dev,
                          args=args, timeout=MESH_TIMEOUT_S, threads=2)
    return ranks, time.perf_counter() - t0


class _Background:
    """``fn(*args)`` on a thread of this process while the caller goes on:
    :meth:`join` returns its result or raises its error.  For
    :func:`_spawn_ranks`, whose thread waits on the ranks' queue (the
    ranks are processes of their own), so that this process's next
    phases run meanwhile; the caller keeps the tensors it handed over
    alive until the join."""

    def __init__(self, fn, *args):
        import threading

        self._box = {}

        def run():
            try:
                self._box["out"] = fn(*args)
            except BaseException as err:   # re-raised by join()
                self._box["err"] = err

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()
        if "err" in self._box:
            raise self._box["err"]
        return self._box["out"]


def _gate_ranks(ranks, key: str, base: dict, label: str, kv_heads: int,
                depth: int, card: str) -> None:
    """Every rank's run ``key`` against the TP=1 run ``base`` of this
    process: streams and the digest of the cache gathered over the ranks
    equal, K1 at ``kv_heads`` KV heads, at least ``depth`` K1 calls
    shadowed."""
    for r in ranks:
        got = r[key]
        if got["outputs"] != base["outputs"]:
            raise AssertionError(f"{label}: rank {r['rank']}'s streams "
                                 "differ from the TP=1 streams")
        if got["digest"] != base["digest"]:
            raise AssertionError(f"{label}: rank {r['rank']}'s gathered "
                                 "cache differs from the TP=1 cache")
        if got["kv_heads"] != kv_heads or got["shadow_calls"] < depth:
            raise AssertionError(f"{label}: rank {r['rank']}: "
                                 f"{got['kv_heads']} KV heads, "
                                 f"{got['shadow_calls']} K1 calls shadowed")
        print(f"# {label}, rank {r['rank']} ({r['transport']}): "
              f"{got['substeps']} sub-steps, {got['launches']} K1 "
              f"launches at {got['kv_heads']} KV heads, "
              f"{got['hits']} prefix hit tokens, {got['wall']:.3f} s "
              f"wall, {got['decode_tok_s']:.2f} decode tok/s, peak "
              f"{got['peak'] / 2**30:.2f} GiB of its own; first "
              f"{got['shadow_calls']} K1 calls within "
              f"{got['shadow_err']:.3e} of plain; [{card}]", flush=True)
    print(f"# {label}: streams of both ranks bitwise equal to this "
          f"process's TP=1 run, whole cache digest {base['digest'][:16]} "
          f"equal (TP=1 wall {base['wall']:.3f} s); [{card}]", flush=True)


def mesh_start(dev, params) -> dict:
    """Phase: K1 timed at the shard's geometry in both modes and both
    instances, then :func:`mesh_path`'s two ranks started in the
    background (:class:`_Background`) on the first ``MESH_DEPTH`` layers
    of ``params``; the phases up to :func:`mesh_path` run meanwhile and
    must not free ``params``."""
    import torch

    timed = {}
    for lns, mode in ((True, False), (True, True), (False, False),
                      (False, True)):
        c = (k1_inputs(dev, **MESH_K1) if lns
             else k1_float_inputs(dev, torch.bfloat16, **MESH_K1))
        what = (f"K1 {'LNS' if lns else 'float (bf16 pages)'} gemma3-12b "
                f"TP={MESH_TP} shard (KV {MESH_K1['KV']}, G {MESH_K1['G']}, "
                f"hd {MESH_K1['hd']}){' partials mode' if mode else ''}")
        timed[lns, mode] = _time_k1(c, what, lns=lns, partials=mode)
        del c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the ranks draw their own cut first
    shard = _shallow(params, MESH_DEPTH)
    return dict(timed=timed, shard=shard,
                job=_Background(_spawn_ranks, dev, shard))


def mesh_path(dev, started: dict, fp8_base: dict, bf16_base: dict) -> dict:
    """Phase: tensor-parallel serving, two ranks of a (1, 2) mesh on this
    one card (one process each, ``MESH_BACKEND`` between them: a
    correctness run, not a speed-up claim).  Each rank serves
    gemma3-12b at full width (16/8 heads split 8/4, d_ff 7,680 a rank, the
    embedding's vocab rows halved) on the main path's weights, their
    first ``MESH_DEPTH`` layers (cut for time since PR 26): the 8
    shared-prefix requests, prefix on, fused decode, on FP8 and on bf16
    pages.  The TP=1 runs they are held to are this process's own, 11's
    worst-case pools (``fp8_base``, ``bf16_base``); every process of the
    script runs cuBLAS without split-K (``CUBLAS_WORKSPACE_CONFIG=:0:0``,
    set at its start).
    Gates: every rank's streams bitwise equal to the TP=1 runs', the
    digest of the whole cache gathered over the ranks equal to theirs,
    K1 launched n_layers x sub-steps by every rank at 4 KV heads, each
    rank's first n_layers K1 calls within rtol = atol = 1e-4 of the plain
    version; then K1's partials mode (:func:`_mesh_partials`).  The ranks
    were started by :func:`mesh_start` (``started``), which timed K1 at
    the shard's geometry first, and ran beside this process's phases
    since: their walls are not a speed.  Prints the transport, each
    rank's peak memory, the run's wall and decode tokens/s, beside the
    card's name and power limit."""
    card = card_line()
    timed = started["timed"]
    ranks, spawn_wall = started.pop("job").join()
    del started["shard"]
    for key, base in (("fp8", fp8_base), ("bf16", bf16_base)):
        label = (f"gemma3-12b depth {MESH_DEPTH} "
                 f"{'serve_fp8_paged' if key == 'fp8' else 'bf16 pages'} "
                 f"TP={MESH_TP} on one card (correctness only)")
        _gate_ranks(ranks, key, base, label, MESH_K1["KV"], MESH_DEPTH, card)
    for r in ranks:
        p = r["partials"]
        print(f"# K1 partials mode on rank {r['rank']} (KV {MESH_K1['KV']}, "
              f"G {MESH_K1['G']}, hd {MESH_K1['hd']}): normalised shard and "
              f"cross-rank combine of page halves within rtol 2e-5 / atol "
              f"2e-6 of paged_attend, max |diff| LNS {p['errs']['lns']:.3e}, "
              f"float {p['errs']['float']:.3e}; {p['launches']} LNS and "
              f"{p['float_launches']} float partials launches", flush=True)
    print(f"# mesh run: {MESH_TP} ranks, spawn to join {spawn_wall:.1f} s; "
          f"[{card}]", flush=True)
    first = ranks[0]
    return dict(
        timed=timed, fp8=first["fp8"], bf16=first["bf16"],
        fp8_err=max(r["fp8"]["shadow_err"] for r in ranks),
        bf16_err=max(r["bf16"]["shadow_err"] for r in ranks),
        partials=first["partials"],
        partials_err={k: max(r["partials"]["errs"][k] for r in ranks)
                      for k in ("lns", "float")})


# --------------------------------------------------------------------------- #
# The MoE family: granite-moe-3b-a800m on the main path
# --------------------------------------------------------------------------- #
MOE_SHALLOW_DEPTH = 2   # every run: the contracts, bf16, bucketed, TP=2
# (cut from full depth and 6 to make time for the training phases)
MOE_LOGIT_DEPTH = 2


class _MoeStats:
    """Within the block, the routing of every MoE layer call is counted on
    the card: the (token, expert) pairs each expert of each layer receives
    (idle slots' rows included; the stack calls its layers in order, so
    call ``i`` is layer ``i mod n_layers``), and, in calls whose groups
    hold more than one token (a bucketed prefill), the pairs dropped by
    capacity out of all pairs.  ``call_max`` is the largest share of one
    call's routed pairs that one expert took (a training step's layers
    run again in reverse order in the recompute, which the layer count
    of :meth:`busiest` does not follow)."""

    def __init__(self, cfg):
        self.L, self.E = cfg.n_layers, cfg.n_experts

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self.moe, self.real = moe, (moe.route, moe.dispatch)
        self.calls, self.load, self.call_max = 0, None, 0.0
        self.dropped = self.pairs = 0

        def route(router, xg, k):
            out = self.real[0](router, xg, k)
            ids = out[3]
            if self.load is None:
                self.load = torch.zeros((self.L, self.E), dtype=torch.int64,
                                        device=ids.device)
            load = (ids.reshape(-1, 1)
                    == torch.arange(self.E, device=ids.device)).sum(0)
            self.load[self.calls % self.L] += load
            self.call_max = torch.maximum(
                torch.as_tensor(self.call_max, device=ids.device),
                load.max() / load.sum())
            self.calls += 1
            return out

        def dispatch(ids, E, C):
            d = self.real[1](ids, E, C)
            if ids.shape[1] > 1:
                self.dropped = self.dropped + (~d["keep"]).sum()
                self.pairs += d["keep"].numel()
            return d

        moe.route, moe.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch = self.real
        return False

    def busiest(self) -> tuple:
        """(the largest share of a layer's routed pairs that one expert
        took, its layer, its expert)."""
        load = self.load.to(float)
        share = load / load.sum(1, keepdim=True)
        i = int(share.argmax())
        return float(share.max()), i // self.E, i % self.E


def _logits_through_k1(dev, arch: str, depth: int) -> None:
    """``arch`` at full width, depth ``depth``, float32 parameters: the
    first-step logits (a prefill chunk and a decode step) through K1
    (n_attn x 5 calls), every K1 call held to its plain version on the
    same inputs, and
    through the plain attention, on both page kinds
    (:func:`_gate_logits`: within rtol = atol = 1e-3 on float32 pages,
    printed on FP8 pages)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import attention_layers

    for policy in ("serve_fp8_paged", None):
        base = dataclasses.replace(get_config(arch, policy=policy),
                                   n_layers=depth)
        cfg = dataclasses.replace(base, param_dtype="float32")
        n_attn = len(attention_layers(cfg))
        with _ShadowK1() as shadow:
            kern = _first_step_logits(dev, cfg)
        gc.collect()              # one float32 engine on the card at a time
        torch.cuda.empty_cache()
        plain = _first_step_logits(dev, dataclasses.replace(
            cfg, numerics=_plain_attention_policy(base.policy)))
        gc.collect()
        torch.cuda.empty_cache()
        if shadow.calls != n_attn * 5:     # 4 prompt + 1 decode
            raise AssertionError(f"{shadow.calls} K1 calls, want "
                                 f"{n_attn * 5}")
        _gate_logits(kern, plain, f"{arch} depth {depth}, float32, "
                     f"{_policy_label(cfg, policy)} ({shadow.calls} K1 "
                     f"calls each within {shadow.err:.3e} of the plain "
                     "version)", cfg.policy.kv_quantized)


def moe_path(dev, k1: dict, k1f: dict) -> dict:
    """Phase: granite-moe-3b-a800m (32 layers, d_model 1536, 24/8 heads,
    hd 64, every layer 40 experts top-8 of d_ff 512, ~3.3 B parameters)
    served on the main path at full width, on weights drawn on the card
    from seed 0 and redrawn by :func:`_lively`: the 8 shared-prefix
    requests of :func:`prefix_main_path`, 4 slots, page 16, chunk 4.
    Cut for time to depth ``MOE_SHALLOW_DEPTH`` (from full depth for the
    FP8 prefix-off run and from 6 for the rest): FP8 pages prefix
    off fused, prefix on fused (TP=2's baseline) and prefix on unfused,
    bf16 pages prefix on fused, and a bucketed run on FP8 pages (its
    prefills route whole prompts, so capacity drops pairs).  Gates: every
    stream varied, the FP8 streams bitwise equal (fused == unfused,
    prefix on == off; the two prefix-on caches' digests equal), >= 256
    prefix hit tokens with the cache on, K1 launched n_layers x sub-steps
    in every run (its other instance never), each run's first n_layers K1 calls
    within rtol = atol = 1e-4 of the plain version; the float32
    first-step logits at depth ``MOE_LOGIT_DEPTH``
    (:func:`_logits_through_k1`); TP=2, two ranks on this card
    (:func:`_mesh_rank` at depth ``MOE_SHALLOW_DEPTH`` on both page
    kinds), streams and gathered cache digest equal to this process's
    prefix-on runs.  Prints K1's time at granite's geometry (``k1``,
    ``k1f``: :func:`check_k1` and :func:`check_k1_float`), every run's
    wall, decode tokens/s and peak memory above what the process held
    before it, the busiest expert's share of a layer's routed pairs in
    the prefix-off run, and the pairs the bucketed prefills dropped,
    beside the card's name and power limit."""
    import torch
    from repro_torch.configs import get_config

    card = card_line()
    for what, t in (("LNS (FP8 pages)", k1), ("float (bf16 pages)", k1f)):
        print(f"# K1 {what} at granite's geometry (KV 8, G 3, hd 64): "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}; "
              f"{t['ms'] / t['bound_ms']:.0f}x); [{card}]", flush=True)
    full = get_config(MOE_ARCH, policy="serve_fp8_paged")
    queue = _prefix_queue(full)
    params, runs = None, {}

    def serve(key, policy=None, depth=MOE_SHALLOW_DEPTH, scheduler=None,
              **kw):
        nonlocal params
        cfg = dataclasses.replace(get_config(MOE_ARCH, policy=policy),
                                  n_layers=depth)
        eng = _prefix_engine(dev, cfg, None if params is None
                             else _shallow(params, depth), **kw)
        if params is None:
            params = _lively(eng).params
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _ShadowK1(limit=depth) as shadow:
            run = _counted_run(eng, queue, PREFIX_GEN,
                               scheduler=scheduler or "continuous")
        peak = torch.cuda.max_memory_allocated() - held
        run.update(digest=_cache_digest(eng.cache), err=shadow.err)
        del eng
        torch.cuda.empty_cache()
        hits = run["stats"]["prefix_hit_tokens"]
        label = f"{MOE_ARCH} depth {depth} {_policy_label(cfg, policy)}, {key}"
        if (hits >= 4 * PREFIX_SHARED) != kw.get("prefix_cache", False):
            raise AssertionError(f"{label}: {hits} prefix hit tokens")
        if shadow.calls < min(depth, run["launches"]):
            raise AssertionError(f"{label}: {shadow.calls} K1 calls "
                                 "shadowed")
        print(f"# {label}: {run['stats']['steps']} steps, "
              f"{run['substeps']} sub-steps, {run['lns']} K1 LNS and "
              f"{run['flt']} K1 float launches, {hits} prefix hit tokens, "
              f"{run['wall']:.3f} s wall, "
              f"{run['stats']['decode_tok_s']:.2f} decode tok/s, peak "
              f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held "
              f"before; first {shadow.calls} K1 calls within "
              f"{shadow.err:.3e} of plain; [{card}]", flush=True)
        runs[key] = run
        return run

    shallow = dataclasses.replace(full, n_layers=MOE_SHALLOW_DEPTH)
    with _MoeStats(shallow) as stats:
        off = serve("fp8 prefix off, fused", "serve_fp8_paged")
    # the TP=2 ranks on these weights run beside the rest of this phase
    shard = _shallow(params, MOE_SHALLOW_DEPTH)
    mesh_job = _Background(_spawn_ranks, dev, shard, MOE_ARCH, False)
    share, layer, expert = stats.busiest()
    print(f"# {MOE_ARCH}: the busiest expert (layer {layer}, expert "
          f"{expert}) took {100 * share:.2f}% of its layer's routed pairs "
          f"(uniform {100 / full.n_experts:.2f}%) in the prefix-off run "
          f"({stats.calls} MoE calls)", flush=True)

    base = {"fp8": serve("fp8 prefix on, fused", "serve_fp8_paged",
                         prefix_cache=True),
            "bf16": serve("bf16 prefix on, fused", prefix_cache=True)}
    unfused = serve("fp8 prefix on, unfused", "serve_fp8_paged",
                    prefix_cache=True, fused_decode=False)
    for key, run in base.items():
        _require_varied(run["outputs"], f"{MOE_ARCH} depth "
                        f"{MOE_SHALLOW_DEPTH} {key}", constant_share=0.25)
    if (unfused["outputs"], unfused["digest"]) != (
            base["fp8"]["outputs"], base["fp8"]["digest"]) \
            or off["outputs"] != base["fp8"]["outputs"]:
        raise AssertionError(f"{MOE_ARCH} depth {MOE_SHALLOW_DEPTH}: token "
                             "streams differ with fused decode on/off or "
                             "the prefix cache on/off")
    print(f"# {MOE_ARCH} depth {MOE_SHALLOW_DEPTH} serve_fp8_paged: token "
          "streams bitwise equal with fused decode on and off and the "
          "prefix cache on and off, the prefix-on caches bitwise equal",
          flush=True)
    with _MoeStats(dataclasses.replace(full, n_layers=MOE_SHALLOW_DEPTH)
                   ) as drops:
        serve("bucketed", "serve_fp8_paged", scheduler="bucketed")
    print(f"# {MOE_ARCH} depth {MOE_SHALLOW_DEPTH} serve_fp8_paged, "
          f"bucketed: its prefills dropped {int(drops.dropped)} of "
          f"{drops.pairs} routed pairs by capacity (factor "
          f"{full.capacity_factor})", flush=True)

    _logits_through_k1(dev, MOE_ARCH, MOE_LOGIT_DEPTH)

    ranks, spawn_wall = mesh_job.join()
    del shard
    for key in ("fp8", "bf16"):
        label = (f"{MOE_ARCH} depth {MOE_SHALLOW_DEPTH} "
                 f"{'serve_fp8_paged' if key == 'fp8' else 'bf16 pages'} "
                 f"TP={MESH_TP} on one card (correctness only)")
        _gate_ranks(ranks, key, base[key], label, full.n_kv_heads // MESH_TP,
                    MOE_SHALLOW_DEPTH, card)
    print(f"# {MOE_ARCH} mesh run: {MESH_TP} ranks, spawn to join "
          f"{spawn_wall:.1f} s; [{card}]", flush=True)
    del params
    torch.cuda.empty_cache()
    return dict(fp8=runs["fp8 prefix off, fused"], bf16=base["bf16"],
                fp8_err=max(r["err"] for r in runs.values() if r["lns"]),
                bf16_err=base["bf16"]["err"])


# --------------------------------------------------------------------------- #
# MLA with MoE: deepseek-v2-lite-16b
# --------------------------------------------------------------------------- #
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_MAIN_DEPTH = 3        # the FP8-latent run (cut for time from 27)
MLA_SHALLOW_DEPTH = 2     # the dense layer and one MoE layer
MLA_K2_PER_LAYER = 6      # wq, w_dkv, wo and the prefix MLP's or the
# shared experts' three; w_uk, w_uv, the routed experts and the unembed
# are decoded before their products, as in the reference


def _mla_layer_mats(layer) -> list:
    """An MLA layer's static weights that multiply as codes (K2 under a
    quantized matmul): attention's wq, w_dkv, wo, then the prefix MLP's or
    the shared experts' three."""
    ffn = layer["ffn"].get("shared", layer["ffn"])
    return [layer["attn"][n] for n in ("wq", "w_dkv", "wo")] + \
        [ffn[n] for n in ("w_gate", "w_up", "w_down")]


def _slot_snapshot_roundtrip(dev, arch: str, cfg, params, card,
                             leaves, make=None, queue=None,
                             gen: int = PREFIX_GEN) -> None:
    """Save while a request sits PREEMPTED (its rows of the dense per-slot
    leaves ``leaves`` spilled to the host: MLA's latents, SSD's conv
    inputs and states; a hybrid stack's pages and scales beside them),
    load into a freshly built engine: every cache leaf and spill tensor
    ``torch.equal``, the pool's state equal.  ``make()``: the engine
    (default: the prefix phases' with ``CHAOS_PAGES`` pages), serving
    ``queue`` (default: :func:`_prefix_queue`) for ``gen`` tokens."""
    import tempfile
    import torch
    from repro_torch.serving import (ContinuousScheduler, Request,
                                     load_snapshot, save_snapshot)

    def build():
        eng = (make() if make is not None else
               _prefix_engine(dev, cfg, params, num_pages=CHAOS_PAGES))
        return eng, ContinuousScheduler(eng, chunk=4)

    eng, sched = build()
    for i, prompt in enumerate(queue if queue is not None
                               else _prefix_queue(cfg)):
        sched.add(Request(rid=i, prompt=prompt, gen=gen))
    while not sched.preempted:
        if not sched.pending():
            raise AssertionError("the pool never forced a preemption")
        sched.step()
    with tempfile.TemporaryDirectory() as ckpt:
        save_snapshot(ckpt, eng, sched)
        eng2, sched2 = build()
        step = load_snapshot(ckpt, eng2, sched2)
        size = _latest_snapshot(ckpt)["bytes"]
    spills = [(r.spill["state"], r2.spill["state"])
              for r, r2 in zip(sched.preempted, sched2.preempted)]
    if (step != sched.steps or len(spills) != len(sched.preempted)
            or set(eng.cache) != set(leaves)
            or eng2.pool.state_dict() != eng.pool.state_dict()
            or any(not torch.equal(eng2.cache[k], t)
                   for k, t in eng.cache.items())
            or any(set(a) != set(leaves) for a, _ in spills)
            or any(a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])
                   for a, b in spills for k in a)):
        raise AssertionError(f"{arch} snapshot round trip: restored state "
                             "differs")
    kinds = ", ".join(f"{k} {eng.cache[k].dtype}" for k in leaves)
    print(f"# {arch} depth {cfg.n_layers} ({kinds}): snapshot at step "
          f"{step} with {len(spills)} PREEMPTED requests, {size} B on disk, "
          f"loaded into a fresh engine: every cache leaf and spill tensor "
          f"bitwise equal; [{card}]", flush=True)
    del eng, eng2, sched, sched2, spills
    torch.cuda.empty_cache()


def mla_path(dev) -> dict:
    """Phase: deepseek-v2-lite-16b (27 layers: one dense layer of d_ff
    10,944, then 26 MoE layers of 64 experts top-6 of d_ff 1,408 and 2
    shared; MLA with a 512-wide latent and 64 RoPE dims, 16 heads of qk
    128 + 64 and v 128; ~15.7 B parameters, ~31.4 GB of bf16 at full depth)
    served on the main path at full width, on weights drawn on the card
    from seed 0 and
    redrawn by :func:`_lively`, the 8 shared-prefix requests of
    :func:`prefix_main_path`, 4 slots, page 16, chunk 4.  MLA keeps its
    latents as dense per-slot rows beside the page pool and makes no
    kernel call (the reference has none for it): K1 is launched never.

    At depth ``MLA_MAIN_DEPTH`` (the dense layer and two MoE layers; cut
    for time from full depth to pay for :func:`ssm_path`): one FP8-latent
    run (serve_fp8_paged: E5M2 codes at scale 1, RNE), continuous
    scheduler, every stream varied (at most a quarter on one token);
    printed: the wall, decode tokens/s, peak memory and the busiest
    expert's share of its layer's routed pairs.  At depth ``MLA_SHALLOW_DEPTH`` (the dense
    layer and one MoE layer), on both latent kinds (FP8, and bf16 as the
    CLI's default): a rerun bitwise; a pool of ``PREFIX_PREEMPT_PAGES``
    that preempts (each spilled slot's rows restored verbatim) bitwise
    equal to the worst-case pool; a snapshot round trip while a request
    sits PREEMPTED; the bucketed scheduler on the paged and on the dense
    cache, bitwise equal; continuous against bucketed printed (share of
    equal tokens, first divergence).  Float32 latents and parameters: the
    first-step logits on the card within rtol = atol = 1e-3 of the port's
    CPU engine on the same weights and tokens (no plain kernel version
    exists for MLA, so this holds the path on the card).  Static weights:
    streams bitwise equal to those of the bf16 weights decoded from the
    same codes (serve_fp8_paged); under a policy whose matmuls take the
    codes through K2 (``k_static_policy("fused_dequant")``) on the 4
    prompts of 8 tokens of :func:`_kernel_queue` (cut for time from the 8
    requests), ``MLA_K2_PER_LAYER`` x n_layers K2 launches a sub-step,
    none of K3,
    every call within 2 sqrt(K) 2^-24 sum|products| of its plain version
    (:class:`_ShadowMatmul`); then K2's card time on one MoE layer's six
    products at M = 4 beside its bound, the plain version and
    ``torch.matmul`` on the decoded bf16 weights."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.quantize import quantize_params

    card = card_line()
    full = dataclasses.replace(get_config(MLA_ARCH, policy="serve_fp8_paged"),
                               n_layers=MLA_MAIN_DEPTH)
    queue = _prefix_queue(full)
    eng = _prefix_engine(dev, full, None)
    params = _lively(eng).params
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    moe_layers = dataclasses.replace(full,
                                     n_layers=full.n_layers - full.first_dense)
    with _MoeStats(moe_layers) as stats:
        run = _counted_run(eng, queue, PREFIX_GEN)
    peak = torch.cuda.max_memory_allocated()
    distinct = _require_varied(run["outputs"],
                               f"{MLA_ARCH} depth {full.n_layers}",
                               constant_share=0.25)
    share, layer, expert = stats.busiest()
    print(f"# {MLA_ARCH} depth {full.n_layers} serve_fp8_paged "
          f"(E5M2 latents): {len(queue)} requests, {run['stats']['steps']} "
          f"steps, {run['substeps']} sub-steps, {run['wall']:.3f} s wall, "
          f"{run['stats']['decode_tok_s']:.2f} decode tok/s, "
          f"{run['wall'] / run['substeps'] * 1e3:.2f} ms a sub-step; "
          f"{held / 2**30:.2f} GiB allocated before the run (the weights and "
          f"what earlier phases hold), peak {peak / 2**30:.2f} GiB; latent "
          f"cache {eng.kv_cache_bytes()} B "
          f"({run['stats']['cache_bytes_per_token']:.0f} B a token); the "
          f"busiest expert (MoE layer {layer}, expert {expert}) took "
          f"{100 * share:.2f}% of its layer's routed pairs (uniform "
          f"{100 / full.n_experts:.2f}%); distinct tokens per stream "
          f"{distinct}; [{card}]", flush=True)
    del eng
    params = _shallow(params, MLA_SHALLOW_DEPTH)   # the rest freed
    torch.cuda.empty_cache()
    out = dict(full_wall=run["wall"], full_substeps=run["substeps"],
               peak=peak, busiest=share)

    def serve(policy, scheduler="continuous", served=None, **kw):
        cfg = dataclasses.replace(get_config(MLA_ARCH, policy=policy),
                                  n_layers=MLA_SHALLOW_DEPTH)
        eng = _prefix_engine(dev, cfg, params if served is None else served,
                             **kw)
        r = _counted_run(eng, queue, PREFIX_GEN, scheduler=scheduler)
        label = (f"{MLA_ARCH} depth {MLA_SHALLOW_DEPTH} "
                 f"{_policy_label(cfg, policy)}, {scheduler}, "
                 f"{eng.cache_impl} cache"
                 + (f", {kw['num_pages'] - 1} pages" if "num_pages" in kw
                    else ""))
        print(f"# {label}: {r['stats']['steps']} steps, {r['substeps']} "
              f"sub-steps, {r['stats'].get('preemptions', 0)} preemptions, "
              f"{r['wall']:.3f} s wall", flush=True)
        del eng
        torch.cuda.empty_cache()
        return r

    for policy, kind in (("serve_fp8_paged", "fp8"), (None, "bf16")):
        base = serve(policy)
        _require_varied(base["outputs"], f"{MLA_ARCH} depth "
                        f"{MLA_SHALLOW_DEPTH} {kind}", constant_share=0.25)
        again = serve(policy)
        small = serve(policy, num_pages=PREFIX_PREEMPT_PAGES)
        if small["stats"]["preemptions"] < 1 or \
                small["stats"]["restores"] < 1:
            raise AssertionError(f"{kind}: the small pool never preempted")
        paged = serve(policy, "bucketed")
        dense = serve(policy, "bucketed", cache_impl="dense")
        for what, r in (("a rerun", again), ("preemption", small),
                        ("the bucketed dense cache", dense)):
            want = paged if r is dense else base
            if r["outputs"] != want["outputs"]:
                raise AssertionError(f"{MLA_ARCH} {kind}: token streams "
                                     f"differ with {what}")
        same, first = _agreement(base["outputs"], paged["outputs"])
        print(f"# {MLA_ARCH} depth {MLA_SHALLOW_DEPTH} {kind} latents: "
              "token streams bitwise equal on a rerun, under preemption "
              f"({small['stats']['preemptions']} preemptions, "
              f"{small['stats']['restores']} restores) and bucketed on the "
              f"paged and the dense cache; continuous vs bucketed "
              f"{100 * same:.1f} % of tokens equal, first divergence "
              f"{first}", flush=True)
        cfg = dataclasses.replace(get_config(MLA_ARCH, policy=policy),
                                  n_layers=MLA_SHALLOW_DEPTH)
        _slot_snapshot_roundtrip(dev, MLA_ARCH, cfg, params, card,
                                 ("ckv", "kpe"))

    # float32 latents and parameters: the card against the port's CPU run
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_SHALLOW_DEPTH,
                              param_dtype="float32")
    own = _prefix_engine(dev, cfg, None).params

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    kern = _first_step_logits(dev, cfg, own)
    host = _first_step_logits("cpu", cfg, to(own, "cpu"))
    del own
    torch.cuda.empty_cache()
    np.testing.assert_allclose(kern, host, rtol=1e-3, atol=1e-3)
    print(f"# {MLA_ARCH} depth {MLA_SHALLOW_DEPTH}, float32 latents and "
          f"parameters: first-step logits on the card within "
          f"{np.abs(kern - host).max():.3e} of the CPU engine's (max |logit| "
          f"{np.abs(host).max():.3f}); [{card}]", flush=True)

    # static weights: decoded == bf16 of the same codes; codes through K2
    fp8 = dataclasses.replace(full, n_layers=MLA_SHALLOW_DEPTH)
    codes = quantize_params(params, fp8.policy,
                            period=fp8.layer_pattern_period)
    static = serve("serve_fp8_paged", served=codes, static_weights=True)
    plain = serve("serve_fp8_paged", served=_decoded(codes))
    _require_varied(static["outputs"], "deepseek static weights",
                    constant_share=0.25)
    if static["outputs"] != plain["outputs"]:
        raise AssertionError(f"{MLA_ARCH} static weights: token streams "
                             "differ from the bf16 weights decoded from the "
                             "same codes")
    k2cfg = dataclasses.replace(
        get_config(MLA_ARCH), numerics=k_static_policy("fused_dequant"),
        n_layers=MLA_SHALLOW_DEPTH)
    eng = _prefix_engine(dev, k2cfg, codes)
    _reset_matmul_counts()
    with _ShadowMatmul("dequant_matmul") as shadow:
        r = _counted_run(eng, _kernel_queue(k2cfg), KERNEL_GEN)
    k3, k2 = _matmul_counts()
    want = MLA_K2_PER_LAYER * MLA_SHALLOW_DEPTH * r["substeps"]
    print(f"# {MLA_ARCH} depth {MLA_SHALLOW_DEPTH} static weights through "
          f"K2 (fused_dequant), continuous: {r['substeps']} sub-steps, {k2} "
          f"K2 launches ({MLA_K2_PER_LAYER} x {MLA_SHALLOW_DEPTH} layers x "
          f"sub-steps = {want}), {k3} K3; {shadow.calls} calls each within "
          f"{shadow.err:.3e} of the plain version (at most "
          f"{shadow.of_limit:.4f} of the limit {SHADOW_SUM_LIMIT} sqrt(K) "
          f"2^-24 sum|products|) at (M, K, N) {sorted(shadow.shapes)}; "
          f"{r['wall']:.3f} s wall; streams bitwise equal static vs decoded "
          f"bf16 ({static['wall']:.3f} s, {plain['wall']:.3f} s)", flush=True)
    if k2 != want or k3 or shadow.calls != want:
        raise AssertionError(f"K2 on deepseek's static weights: {k2} "
                             f"launches ({k3} of K3, {shadow.calls} calls), "
                             f"want {want}")
    _require_varied(r["outputs"], "deepseek static weights through K2",
                    constant_share=0.25)
    del eng
    torch.cuda.empty_cache()
    timed = _static_layer_ms(dev, _mla_layer_mats(codes["blocks"][0]),
                             "fused_dequant", PREFIX_SLOTS,
                             label=f"one {MLA_ARCH} MoE layer (6 products)")
    del codes, params
    torch.cuda.empty_cache()
    out.update(k2_launches=k2, k2_err=shadow.err, k2=timed)
    return out


# --------------------------------------------------------------------------- #
# The SSM family: mamba2-780m
# --------------------------------------------------------------------------- #
SSM_ARCH = "mamba2-780m"
SSM_MAIN_DEPTH = 12       # both policies' 8 requests (cut for time from
# 48: ssm_train_path runs full depth on the card)
SSM_SHALLOW_DEPTH = 2     # the contracts, the float32 logits, K2 and K3
SSM_K_PER_LAYER = 6       # w_z, w_x, w_B, w_C, w_dt, out_proj: all as codes
SSM_LEAVES = ("conv", "state")
# a layer's six static products, (K, N); at decode M = the 4 slots
SSM_MATMULS = {"w_z": (1536, 3072), "w_x": (1536, 3072), "w_B": (1536, 128),
               "w_C": (1536, 128), "w_dt": (1536, 48),
               "out_proj": (3072, 1536)}
# the main path's longest bucketed prefill: one 95-token prompt (every
# prompt of the queue has a length of its own), M = 95
SSM_PREFILL_M = PREFIX_SHARED + max(PREFIX_TAILS)


def _lively_ssm(eng, seed: int = 0):
    """:func:`_lively`, then each SSD layer's decay and step leaves as
    Mamba2's published init draws them (A in [1, 16] through ``A_log``, dt
    log-uniform in [0.001, 0.1] through ``dt_bias``, softplus' inverse),
    and ``w_dt`` scaled by 1 / sqrt(d_model), so that its projection is of
    order 1: at std 0.5 that projection is ~20, dt as large, and every
    state forgets its past within one token, so a state spilled or
    restored wrongly would not show in the streams."""
    _lively(eng, seed)
    _mamba2_ranges(eng.params["blocks"], seed + 1)
    for layer in eng.params["blocks"]:
        if "mamba" in layer:
            layer["mamba"]["w_dt"].mul_(eng.cfg.d_model ** -0.5)
    return eng


def _mamba2_ranges(layers, seed: int) -> float:
    """Each SSD layer's decays and steps (its other layers skipped) as
    Mamba2's published init draws them, in place: A uniform in [1, 16]
    through ``A_log``, dt log-uniform in [0.001, 0.1] through
    ``dt_bias`` (softplus' inverse).  Returns the largest A dt, the
    decay a token of one head at its bias."""
    import torch

    lo, hi = math.log(1e-3), math.log(1e-1)
    top, g = 0.0, None
    for layer in layers:
        if "mamba" not in layer:
            continue
        m = layer["mamba"]
        dev, nh = m["A_log"].device, m["A_log"].shape[0]
        if g is None:
            g = torch.Generator(device=dev).manual_seed(seed)
        A = 1.0 + 15.0 * torch.rand(nh, generator=g, device=dev)
        dt = torch.exp(lo + (hi - lo) * torch.rand(nh, generator=g,
                                                    device=dev))
        m["A_log"].copy_(torch.log(A))
        m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
        top = max(top, float((A * dt).max()))
    return top


def _decoded(tree):
    """A parameter tree with every static ``QTensor`` decoded to bf16."""
    from repro_torch.core.quant import QTensor
    from repro_torch.models.quantize import resolve_weight

    if isinstance(tree, dict):
        return {k: _decoded(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decoded(v) for v in tree]
    return resolve_weight(tree) if isinstance(tree, QTensor) else tree


def ssm_path(dev) -> dict:
    """Phase: mamba2-780m (48 SSD layers, d_model 1536, d_inner 3072, 48
    heads of 64, d_state 128, conv width 4, vocab 50,280 tied; no
    attention, no FFN; ~1.5 GB of bf16 weights) served at full width on
    weights drawn on the card from seed 0 and redrawn by
    :func:`_lively_ssm`, the 8 shared-prefix requests of
    :func:`prefix_main_path`, 4 slots, page 16, chunk 4.  Each SSD layer
    keeps its conv inputs and its state as dense per-slot leaves of the
    paged cache (zeroed at each admission, spilled and restored by slot);
    no kernel serves the mixer (the reference has none), so K1 is launched
    never.

    At depth ``SSM_MAIN_DEPTH``, the serve CLI's default policy and
    serve_fp8_paged, the continuous scheduler: every stream varied (the
    strict rule), both policies' streams bitwise equal (an
    SSM stack reads none of the KV settings); printed: the wall,
    sub-steps, the wall a sub-step, decode tokens/s, the cache's bytes
    and the peak memory.  At depth
    ``SSM_SHALLOW_DEPTH``, the default policy: a rerun, a pool of
    ``PREFIX_PREEMPT_PAGES`` that preempts, unfused decode, and the
    bucketed scheduler on the paged and the dense cache, each bitwise
    equal to its pair (continuous vs bucketed printed); a snapshot round
    trip while a request sits PREEMPTED.  Float32 parameters: the
    first-step logits on the card within rtol = atol = 1e-3 of the port's
    CPU engine on the same weights.  Static weights (serve_fp8_paged):
    streams bitwise equal to those of the bf16 weights decoded from the
    same codes; under :func:`k_static_policy` the codes through K2
    (continuous, every matmul at M = 4) and K3 (bucketed: one prefill at
    M = 32, its plain version being slow), both on the 4 prompts of 8
    tokens of :func:`_kernel_queue` (cut for time from the 8 requests),
    each
    ``SSM_K_PER_LAYER`` x n_layers launches a model call and none of the
    other, every call within 2 sqrt(K) 2^-24 sum|products| of its plain
    version (:class:`_ShadowMatmul`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models.quantize import quantize_params

    card = card_line()
    queue = _prefix_queue(get_config(SSM_ARCH))
    params, full = None, {}
    for policy in (None, "serve_fp8_paged"):
        cfg = dataclasses.replace(get_config(SSM_ARCH, policy=policy),
                                  n_layers=SSM_MAIN_DEPTH)
        label = policy or "default policy"
        eng = _prefix_engine(dev, cfg, params)
        if params is None:
            params = _lively_ssm(eng).params
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = _counted_run(eng, queue, PREFIX_GEN)
        peak = torch.cuda.max_memory_allocated()
        distinct = _require_varied(run["outputs"],
                                   f"{SSM_ARCH} depth {cfg.n_layers} {label}")
        print(f"# {SSM_ARCH} depth {cfg.n_layers} {label}: "
              f"{len(queue)} requests, {run['stats']['steps']} steps, "
              f"{run['substeps']} sub-steps, {run['wall']:.3f} s wall, "
              f"{run['wall'] / run['substeps'] * 1e3:.3f} ms a sub-step, "
              f"{run['stats']['decode_tok_s']:.2f} decode tok/s; "
              f"{held / 2**30:.2f} GiB allocated before the run, peak "
              f"{peak / 2**30:.2f} GiB; conv and state cache "
              f"{eng.kv_cache_bytes()} B ({eng.kv_cache_bytes() // PREFIX_SLOTS}"
              f" B a slot); distinct tokens per stream {distinct}; [{card}]",
              flush=True)
        full[label] = dict(wall=run["wall"], substeps=run["substeps"],
                           outputs=run["outputs"], peak=peak)
        del eng
        torch.cuda.empty_cache()
    streams = [r["outputs"] for r in full.values()]
    if streams[0] != streams[1]:
        raise AssertionError(f"{SSM_ARCH}: the default policy's and "
                             "serve_fp8_paged's streams differ, though an "
                             "SSM stack reads no KV setting")
    params = _shallow(params, SSM_SHALLOW_DEPTH)   # the rest freed
    torch.cuda.empty_cache()
    out = dict(full=full)

    def serve(policy=None, scheduler="continuous", served=None, **kw):
        cfg = dataclasses.replace(get_config(SSM_ARCH, policy=policy),
                                  n_layers=SSM_SHALLOW_DEPTH)
        eng = _prefix_engine(dev, cfg, params if served is None else served,
                             **kw)
        r = _counted_run(eng, queue, PREFIX_GEN, scheduler=scheduler)
        label = (f"{SSM_ARCH} depth {SSM_SHALLOW_DEPTH} "
                 f"{policy or 'default policy'}, {scheduler}, "
                 f"{eng.cache_impl} cache"
                 + (f", {kw['num_pages'] - 1} pages" if "num_pages" in kw
                    else "")
                 + (", unfused" if kw.get("fused_decode") is False else ""))
        print(f"# {label}: {r['stats']['steps']} steps, {r['substeps']} "
              f"sub-steps, {r['stats'].get('preemptions', 0)} preemptions, "
              f"{r['wall']:.3f} s wall", flush=True)
        del eng
        torch.cuda.empty_cache()
        return r

    base = serve()
    _require_varied(base["outputs"], f"{SSM_ARCH} depth {SSM_SHALLOW_DEPTH}",
                    constant_share=0.25)
    again = serve()
    small = serve(num_pages=PREFIX_PREEMPT_PAGES)
    if small["stats"]["preemptions"] < 1 or small["stats"]["restores"] < 1:
        raise AssertionError(f"{SSM_ARCH}: the small pool never preempted")
    unfused = serve(fused_decode=False)
    paged = serve(scheduler="bucketed")
    dense = serve(scheduler="bucketed", cache_impl="dense")
    for what, r in (("a rerun", again), ("preemption", small),
                    ("unfused decode", unfused),
                    ("the bucketed dense cache", dense)):
        want = paged if r is dense else base
        if r["outputs"] != want["outputs"]:
            raise AssertionError(f"{SSM_ARCH}: token streams differ with "
                                 f"{what}")
    same, first = _agreement(base["outputs"], paged["outputs"])
    print(f"# {SSM_ARCH} depth {SSM_SHALLOW_DEPTH}: token streams bitwise "
          f"equal on a rerun, under preemption "
          f"({small['stats']['preemptions']} preemptions, "
          f"{small['stats']['restores']} restores), fused vs unfused and "
          f"bucketed on the paged and the dense cache; continuous vs "
          f"bucketed {100 * same:.1f} % of tokens equal, first divergence "
          f"{first}", flush=True)
    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              n_layers=SSM_SHALLOW_DEPTH)
    _slot_snapshot_roundtrip(dev, SSM_ARCH, cfg, params, card, SSM_LEAVES)

    # float32 parameters: the card against the port's CPU run
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_SHALLOW_DEPTH,
                              param_dtype="float32")
    own = _lively_ssm(_prefix_engine(dev, cfg, None)).params

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    kern = _first_step_logits(dev, cfg, own)
    host = _first_step_logits("cpu", cfg, to(own, "cpu"))
    del own
    torch.cuda.empty_cache()
    np.testing.assert_allclose(kern, host, rtol=1e-3, atol=1e-3)
    print(f"# {SSM_ARCH} depth {SSM_SHALLOW_DEPTH}, float32 parameters and "
          f"states: first-step logits on the card within "
          f"{np.abs(kern - host).max():.3e} of the CPU engine's (max |logit| "
          f"{np.abs(host).max():.3f}); [{card}]", flush=True)

    # static weights: decoded == bf16 of the same codes; codes through K2/K3
    fp8 = dataclasses.replace(get_config(SSM_ARCH, policy="serve_fp8_paged"),
                              n_layers=SSM_SHALLOW_DEPTH)
    codes = quantize_params(params, fp8.policy,
                            period=fp8.layer_pattern_period)
    static = serve("serve_fp8_paged", served=codes, static_weights=True)
    plain = serve("serve_fp8_paged", served=_decoded(codes))
    _require_varied(static["outputs"], f"{SSM_ARCH} static weights",
                    constant_share=0.25)
    if static["outputs"] != plain["outputs"]:
        raise AssertionError(f"{SSM_ARCH} static weights: token streams "
                             "differ from the bf16 weights decoded from the "
                             "same codes")
    short = _kernel_queue(fp8)
    for impl, which, scheduler in (
            ("fused_dequant", "dequant_matmul", "continuous"),
            ("lns", "lns_product_matmul", "bucketed")):
        kcfg = dataclasses.replace(
            get_config(SSM_ARCH), numerics=k_static_policy(impl),
            n_layers=SSM_SHALLOW_DEPTH)
        eng = Engine(kcfg, slots=PREFIX_SLOTS,
                     max_seq=KERNEL_PLEN + KERNEL_GEN, page_size=16,
                     rng_seed=0, device=dev)
        eng.params = codes
        prefills = []
        real_prefill = eng.prefill_batch

        def counted(prompts, slots, real=real_prefill, seen=prefills):
            seen.append(len(prompts) * len(prompts[0]))
            return real(prompts, slots)

        eng.prefill_batch = counted
        _reset_matmul_counts()
        with _ShadowMatmul(which) as shadow:
            r = _counted_run(eng, short, KERNEL_GEN, scheduler)
        k3, k2 = _matmul_counts()
        got, other = (k2, k3) if impl == "fused_dequant" else (k3, k2)
        calls = r["substeps"] + len(prefills)
        want = SSM_K_PER_LAYER * SSM_SHALLOW_DEPTH * calls
        kname = "K2" if impl == "fused_dequant" else "K3"
        print(f"# {SSM_ARCH} depth {SSM_SHALLOW_DEPTH} static weights "
              f"through {kname} ({impl}), {scheduler}: {r['substeps']} "
              f"sub-steps and {len(prefills)} batched prefills (M "
              f"{prefills}), {got} {kname} launches ({SSM_K_PER_LAYER} x "
              f"{SSM_SHALLOW_DEPTH} layers x model calls = {want}), {other} "
              f"of the other; {shadow.calls} calls each within "
              f"{shadow.err:.3e} of the plain version (at most "
              f"{shadow.of_limit:.4f} of the limit {SHADOW_SUM_LIMIT} "
              f"sqrt(K) 2^-24 sum|products|) at (M, K, N) "
              f"{sorted(shadow.shapes)}; {r['wall']:.3f} s wall; "
              f"[{card}]", flush=True)
        if got != want or other or shadow.calls != want:
            raise AssertionError(f"{kname} on {SSM_ARCH}'s static weights: "
                                 f"{got} launches ({other} of the other, "
                                 f"{shadow.calls} calls), want {want}")
        if scheduler == "bucketed" and prefills != [
                PREFIX_SLOTS * KERNEL_PLEN]:
            raise AssertionError(f"bucketed prefills {prefills}")
        _require_varied(r["outputs"], f"{SSM_ARCH} static weights through "
                        f"{kname}", constant_share=0.25)
        out[impl] = dict(launches=got, err=shadow.err)
        del eng
        torch.cuda.empty_cache()
    out.update(static_wall=static["wall"], decoded_wall=plain["wall"])
    del codes, params
    torch.cuda.empty_cache()
    return out


def check_ssm_kernels(dev) -> dict:
    """Phase: K3 and K2 at mamba2-780m's six static products
    (``SSM_MATMULS``: ``w_z``/``w_x`` N 3,072, ``w_B``/``w_C`` N 128,
    ``w_dt`` N 48, a partial tile of every K3 tile (128, 64, 32) and of
    K2's 64, and ``out_proj`` K 3,072), each at M = 4 (decode, the 4
    slots) and M = ``SSM_PREFILL_M`` (the main path's longest bucketed
    prefill, a partial row tile), then each kernel's card time on one
    layer's six products at M = 4 (:func:`_ssm_kernel_checks`)."""
    return _ssm_kernel_checks(dev, (PREFIX_SLOTS, SSM_PREFILL_M),
                              PREFIX_SLOTS, "static", seed=30)


def _ssm_kernel_checks(dev, rows, time_m: int, what: str,
                       seed: int) -> dict:
    """K3 and K2 at mamba2-780m's six products (``SSM_MATMULS``) at each M
    of ``rows``, on E4M3 codes of random activations times a per-tensor
    E4M3 weight: every element within 2 sqrt(K) 2^-24 sum|products| of
    the plain version (:class:`_ShadowMatmul`'s limit) and two calls
    bitwise.  Then each kernel's card time on one layer's six products at
    M = ``time_m`` beside its bound, the plain version and, for K2,
    ``torch.matmul`` on the decoded bf16 weights
    (:func:`_static_layer_ms`)."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import lns_matmul as lm

    card = card_line()
    g = torch.Generator(device=dev).manual_seed(seed)
    mats, res = [], {"fused_dequant": {"err": 0.0}, "lns": {"err": 0.0}}
    routes = {"fused_dequant": (
        "K2", lambda x, w: lm.dequant_matmul(
            x, w, fmt="e4m3", w_fmt="e4m3", compute_dtype=torch.float32),
        lambda x, w: lm.dequant_matmul_plain(
            x, w, fmt="e4m3", w_fmt="e4m3", compute_dtype=torch.float32)),
        "lns": ("K3", lambda x, w: lm.lns_product_matmul(
            x, w, fmt="e4m3", mode="rne"),
            lambda x, w: lm.lns_matmul_plain(x, w, fmt="e4m3", mode="rne"))}
    for name, (K, N) in SSM_MATMULS.items():
        q = quantize(torch.randn((K, N), generator=g, device=dev) * 0.02,
                     "e4m3")
        mats.append(q)
        for M in rows:
            x = quantize(torch.randn((M, K), generator=g, device=dev),
                         "e4m3").codes
            for impl, (kname, kernel, plain) in routes.items():
                got, again = kernel(x, q.codes), kernel(x, q.codes)
                want = plain(x, q.codes)
                absum = plain(x & 0x7F, q.codes & 0x7F)
                limit = SHADOW_SUM_LIMIT * K ** 0.5 * 2.0**-24 * absum
                diff = (got - want).abs()
                if not torch.isfinite(got).all() or bool(
                        (diff > limit).any()):
                    raise AssertionError(f"{kname} differs from its plain "
                                         f"version at {SSM_ARCH} {name} "
                                         f"{M}x{K}x{N}")
                if not torch.equal(got.view(torch.int32),
                                   again.view(torch.int32)):
                    raise AssertionError(f"two {kname} calls differ at "
                                         f"{M}x{K}x{N}")
                err = float(diff.max())
                res[impl]["err"] = max(res[impl]["err"], err)
                print(f"# {kname} {SSM_ARCH} {name} {M}x{K}x{N} (e4m3, "
                      f"RNE): max |err| {err:.3e}, at most "
                      f"{float((diff / limit.clamp_min(1e-38)).max()):.4f} "
                      f"of {SHADOW_SUM_LIMIT} sqrt(K) 2^-24 sum|products| "
                      "of its plain version; two calls bitwise", flush=True)
    for impl in routes:
        res[impl].update(_static_layer_ms(
            dev, mats, impl, time_m,
            label=f"one {SSM_ARCH} layer (6 {what} products)"))
    print(f"# {SSM_ARCH}'s {what} kernel shapes checked; [{card}]",
          flush=True)
    return res


# --------------------------------------------------------------------------- #
# Hybrid SSD + GQA + MoE: jamba-v0.1-52b
# --------------------------------------------------------------------------- #
# Full depth (32 layers, ~52 B parameters, ~104 GB in bf16) does not fit
# one card; depth 8 is one period of the pattern (the floor: layer_specs
# asserts body % period == 0), 7 SSD layers and 1 attention layer, 4 MoE
# and 4 MLP FFNs, ~13.3 B parameters, ~26.5 GB in bf16.
HYBRID_DEPTH = 8
HYBRID_PAGE = 4           # the short queue's pages: 3 a request of 12 tokens
HYBRID_SHORT_PAGES = 10   # 9 usable pages against the short queue's 12
HYBRID_LEAVES = ("kp", "vp", "ks", "vs", "conv", "state")
HYBRID_SHADOWED = 8       # each run's first sub-steps' K1 calls held
# the static products of one model call at depth 8 through K2/K3: 7 SSD
# layers' six, the attention layer's four, the 4 MLPs' three (static
# expert weights are decoded before their products, as in the reference)
HYBRID_PRODUCTS = 7 * SSM_K_PER_LAYER + 4 + 3 * (HYBRID_DEPTH // 2)
# one SSD layer's six products, (K, N): w_B and w_C at N 16, a partial
# tile of every tile
HYBRID_SSD_MATMULS = {"w_z": (4096, 8192), "w_x": (4096, 8192),
                      "w_B": (4096, 16), "w_C": (4096, 16),
                      "w_dt": (4096, 128), "out_proj": (8192, 4096)}


@contextlib.contextmanager
def _given_params(params):
    """Within the block, a new ``Engine`` takes ``params`` as its weights
    instead of drawing its own: at jamba's width a second draw would hold
    another 26.5 GB on the card.  The tree enters as it is (the leaf hook
    is not run): a static-weight engine is handed the codes of
    ``quantize_params``, the function its own hook calls leaf by leaf."""
    from repro_torch.models.model import Model

    real = Model.init
    Model.init = lambda self, generator, leaf=None: params
    try:
        yield
    finally:
        Model.init = real


def _hybrid_engine(dev, cfg, params, short: bool = False, **kw):
    """A jamba Engine on ``params`` (on its own draw when None): the
    prefix phases' geometry (4 slots, page 16), or with ``short`` the
    short queue's (4 slots of ``KERNEL_PLEN`` + ``KERNEL_GEN`` tokens,
    page ``HYBRID_PAGE``)."""
    from repro_torch.launch.serve import Engine

    given = (contextlib.nullcontext() if params is None
             else _given_params(params))
    if not short:
        with given:
            return _prefix_engine(dev, cfg, None, **kw)
    with given:
        return Engine(cfg, slots=PREFIX_SLOTS,
                      max_seq=KERNEL_PLEN + KERNEL_GEN,
                      page_size=HYBRID_PAGE, rng_seed=0, device=dev, **kw)


def hybrid_path(dev, k1=None, k1f=None) -> dict:
    """Phase: jamba-v0.1-52b (d_model 4096; attention at layer i % 8 == 4,
    GQA of 32/8 heads at hd 128; 16 experts top-2 of d_ff 14,336 on odd
    layers, an MLP of 14,336 on even ones; SSD mixers of d_state 16, 128
    heads of 64, d_inner 8,192; vocab 65,536 untied) served at full width
    and depth ``HYBRID_DEPTH`` (one period) on one weight set drawn on the
    card from seed 0 and redrawn by :func:`_lively_ssm`, kept for the
    phase (each engine takes it: :func:`_given_params`).  The attention
    layer keeps its KV in pages (K1 at G 4, hd 128), the SSD layers their
    ``{conv, state}`` as dense per-slot leaves of the same paged cache.

    The 8 shared-prefix requests of :func:`prefix_main_path` (4 slots,
    page 16, chunk 4) under serve_fp8_paged and the default policy (bf16
    pages): every stream varied (the strict rule); K1 launched n_attn x sub-steps, each
    run's first ``HYBRID_SHADOWED`` sub-steps' calls within rtol = atol =
    1e-4 of plain; printed:
    the parameter count, wall, sub-steps, decode tokens/s, peak memory,
    the cache's bytes a slot and a token.  Short queues of 4 prompts of 8
    tokens (:func:`_kernel_queue`, page ``HYBRID_PAGE``), serve_fp8_paged:
    a rerun, unfused decode and a ``HYBRID_SHORT_PAGES``-page pool that
    preempts, each bitwise equal to the fused run; a snapshot while a
    request sits PREEMPTED (pages, scales and SSD leaves ``torch.equal``
    after a load); the bucketed scheduler on the paged and the dense cache
    (printed, as for gemma3).  Static weights (serve_fp8_paged): streams
    bitwise equal to those of the bf16 weights decoded from the same
    codes; the codes through K2 (continuous) and K3 (bucketed) under
    :func:`k_static_policy`, ``HYBRID_PRODUCTS`` launches a model call
    (the experts' weights are decoded first, as in the reference), the
    first model call's each within 2 sqrt(K) 2^-24 sum|products| of
    its plain version.  ``Engine(static_weights=True)`` on its own draw
    (its leaf hook encoding each weight as it is drawn): as many codes and
    bytes as ``quantize_params``, finite logits on the short queue, its
    peak memory printed.  Then, the bf16 set freed, float32 parameters:
    the first-step logits through K1 against the plain attention
    (:func:`_logits_through_k1`: within 1e-3 on float32 pages).  ``k1``,
    ``k1f``: :func:`check_k1`'s and :func:`check_k1_float`'s times at
    jamba's geometry (measured here when not given)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import attention_layers
    from repro_torch.models.quantize import quantize_params
    from repro_torch.optim.adamw import tree_leaves

    card = card_line()
    if k1 is None:      # run alone: K1's times at jamba's geometry here
        geo = dict(KV=8, G=4, hd=128)
        k1 = _time_k1(k1_inputs(dev, **geo), "K1 jamba", lns=True)
        k1f = _time_k1(k1_float_inputs(dev, torch.bfloat16, **geo),
                       "K1 float jamba (bf16 pages)", lns=False)
    for what, t in (("LNS (FP8 pages)", k1), ("float (bf16 pages)", k1f)):
        print(f"# K1 {what} at jamba's geometry (KV 8, G 4, hd 128): "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}; "
              f"{t['ms'] / t['bound_ms']:.0f}x); [{card}]", flush=True)

    def config(policy=None, **kw):
        return dataclasses.replace(get_config(HYBRID_ARCH, policy=policy),
                                   n_layers=HYBRID_DEPTH, **kw)

    n_attn = len(attention_layers(config()))
    held_k1 = HYBRID_SHADOWED * n_attn     # each run's first K1 calls
    queue = _prefix_queue(config())
    params, out, errs = None, {}, []
    for policy in ("serve_fp8_paged", None):
        cfg = config(policy)
        label = f"{HYBRID_ARCH} depth {HYBRID_DEPTH} {_policy_label(cfg, policy)}"
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if params is None:
            t0 = time.perf_counter()
            eng = _prefix_engine(dev, cfg, None)
            params = _lively_ssm(eng).params
            n_params = sum(t.numel() for t in tree_leaves(params))
            print(f"# {HYBRID_ARCH} depth {HYBRID_DEPTH}: {n_params} "
                  f"parameters ({n_params / 1e9:.3f} B, "
                  f"{_weight_bytes(params) / 1e9:.2f} GB of bf16), drawn "
                  f"and redrawn in {time.perf_counter() - t0:.2f} s",
                  flush=True)
        else:
            eng = _hybrid_engine(dev, cfg, params)
        with _ShadowK1(limit=held_k1) as shadow:
            run = _counted_run(eng, queue, PREFIX_GEN)
        peak = torch.cuda.max_memory_allocated()
        distinct = _require_varied(run["outputs"], label)
        if shadow.calls != held_k1:
            raise AssertionError(f"{label}: {shadow.calls} K1 calls held")
        errs.append(shadow.err)
        slot_bytes = sum(eng.cache[k][:, 0].numel()
                         * eng.cache[k].element_size()
                         for k in ("conv", "state"))
        token_bytes = (2 * n_attn * cfg.n_kv_heads * cfg.hd
                       * eng.cache["kp"].element_size())
        print(f"# {label}: {len(queue)} requests, {run['stats']['steps']} "
              f"steps, {run['substeps']} sub-steps, {run['launches']} K1 "
              f"launches ({n_attn} x sub-steps; first {shadow.calls} within "
              f"{shadow.err:.3e} of plain), {run['wall']:.3f} s wall, "
              f"{run['wall'] / run['substeps'] * 1e3:.3f} ms a sub-step, "
              f"{run['stats']['decode_tok_s']:.2f} decode tok/s; "
              f"{held / 2**30:.2f} GiB allocated before the run, peak "
              f"{peak / 2**30:.2f} GiB; SSD leaves {slot_bytes} B a slot, "
              f"KV {token_bytes} B a token; distinct tokens per stream "
              f"{distinct}; [{card}]", flush=True)
        out["fp8" if policy else "bf16"] = dict(
            launches=run["launches"], wall=run["wall"],
            substeps=run["substeps"], peak=peak)
        del eng
        torch.cuda.empty_cache()

    short = _kernel_queue(config())

    def serve(policy="serve_fp8_paged", scheduler="continuous",
              served=None, **kw):
        cfg = config(policy)
        eng = _hybrid_engine(dev, cfg, params if served is None else served,
                             short=True, **kw)
        with _ShadowK1(limit=held_k1) as shadow:
            r = _counted_run(eng, short, KERNEL_GEN, scheduler=scheduler)
        if shadow.calls != min(held_k1, r["launches"]):
            raise AssertionError(f"{shadow.calls} K1 calls held")
        errs.append(shadow.err)
        print(f"# {HYBRID_ARCH} depth {HYBRID_DEPTH} "
              f"{policy or 'default policy'}, short queue, {scheduler}, "
              f"{eng.cache_impl} cache"
              + (f", {kw['num_pages'] - 1} pages" if "num_pages" in kw
                 else "")
              + (", unfused" if kw.get("fused_decode") is False else "")
              + f": {r['substeps']} sub-steps, {r['launches']} K1 "
              f"launches, {r['stats'].get('preemptions', 0)} preemptions, "
              f"{r['wall']:.3f} s wall", flush=True)
        del eng
        torch.cuda.empty_cache()
        return r

    base = serve()
    _require_varied(base["outputs"], f"{HYBRID_ARCH} short queue",
                    constant_share=0.25)
    again = serve()
    unfused = serve(fused_decode=False)
    small = serve(num_pages=HYBRID_SHORT_PAGES)
    if small["stats"]["preemptions"] < 1 or small["stats"]["restores"] < 1:
        raise AssertionError(f"{HYBRID_ARCH}: the small pool never "
                             "preempted")
    for what, r in (("a rerun", again), ("unfused decode", unfused),
                    ("preemption", small)):
        if r["outputs"] != base["outputs"]:
            raise AssertionError(f"{HYBRID_ARCH}: token streams differ "
                                 f"with {what}")
    paged = serve(scheduler="bucketed")
    dense = serve(scheduler="bucketed", cache_impl="dense")
    same, first = _agreement(paged["outputs"], dense["outputs"])
    same_c, first_c = _agreement(base["outputs"], paged["outputs"])
    print(f"# {HYBRID_ARCH} depth {HYBRID_DEPTH} serve_fp8_paged, short "
          f"queue: token streams bitwise equal on a rerun, with unfused "
          f"decode and under preemption ({small['stats']['preemptions']} "
          f"preemptions, {small['stats']['restores']} restores); bucketed "
          f"paged vs dense {100 * same:.1f} % of tokens equal, first "
          f"divergence {first}; continuous vs bucketed {100 * same_c:.1f} "
          f"%, first divergence {first_c}", flush=True)
    fp8 = config("serve_fp8_paged")
    _slot_snapshot_roundtrip(
        dev, HYBRID_ARCH, fp8, params, card, HYBRID_LEAVES,
        make=lambda: _hybrid_engine(dev, fp8, params, short=True,
                                    num_pages=HYBRID_SHORT_PAGES),
        queue=short, gen=KERNEL_GEN)

    # static weights: decoded == bf16 of the same codes; codes through K2/K3
    codes = quantize_params(params, fp8.policy,
                            period=fp8.layer_pattern_period)
    params = None                       # the bf16 set freed, the codes kept
    gc.collect()
    torch.cuda.empty_cache()
    static = serve(served=codes, static_weights=True)
    decoded = _decoded(codes)
    plain = serve(served=decoded)
    del decoded
    torch.cuda.empty_cache()
    _require_varied(static["outputs"], f"{HYBRID_ARCH} static weights",
                    constant_share=0.25)
    if static["outputs"] != plain["outputs"]:
        raise AssertionError(f"{HYBRID_ARCH} static weights: token streams "
                             "differ from the bf16 weights decoded from the "
                             "same codes")
    for impl, which, scheduler in (
            ("fused_dequant", "dequant_matmul", "continuous"),
            ("lns", "lns_product_matmul", "bucketed")):
        kcfg = config(numerics=k_static_policy(impl))
        eng = _hybrid_engine(dev, kcfg, codes, short=True)
        prefills = []
        real_prefill = eng.prefill_batch

        def counted(prompts, slots, real=real_prefill, seen=prefills):
            seen.append(len(prompts) * len(prompts[0]))
            return real(prompts, slots)

        eng.prefill_batch = counted
        _reset_matmul_counts()
        with _ShadowMatmul(which, limit=HYBRID_PRODUCTS) as shadow, \
                _ShadowK1(limit=held_k1) as k1_shadow:
            r = _counted_run(eng, short, KERNEL_GEN, scheduler)
        k3, k2 = _matmul_counts()
        got, other = (k2, k3) if impl == "fused_dequant" else (k3, k2)
        calls = r["substeps"] + len(prefills)
        want = HYBRID_PRODUCTS * calls
        kname = "K2" if impl == "fused_dequant" else "K3"
        errs.append(k1_shadow.err)
        print(f"# {HYBRID_ARCH} depth {HYBRID_DEPTH} static weights through "
              f"{kname} ({impl}), {scheduler}: {r['substeps']} sub-steps and "
              f"{len(prefills)} batched prefills (M {prefills}), {got} "
              f"{kname} launches ({HYBRID_PRODUCTS} a model call = {want}), "
              f"{other} of the other; the first model call's {shadow.calls} "
              f"calls each within {shadow.err:.3e} of the plain version (at "
              f"most {shadow.of_limit:.4f} of the limit {SHADOW_SUM_LIMIT} "
              f"sqrt(K) 2^-24 sum|products|) at (M, K, N) "
              f"{sorted(shadow.shapes)}; {r['wall']:.3f} s wall; [{card}]",
              flush=True)
        if got != want or other or shadow.calls != HYBRID_PRODUCTS:
            raise AssertionError(f"{kname} on {HYBRID_ARCH}'s static "
                                 f"weights: {got} launches ({other} of the "
                                 f"other, {shadow.calls} calls held), want "
                                 f"{want}")
        if scheduler == "bucketed" and prefills != [
                PREFIX_SLOTS * KERNEL_PLEN]:
            raise AssertionError(f"bucketed prefills {prefills}")
        _require_varied(r["outputs"], f"{HYBRID_ARCH} static weights "
                        f"through {kname}", constant_share=0.25)
        out[impl] = dict(launches=got, err=shadow.err)
        # the wrapped prefill is a bound method: it holds the engine
        del eng, counted, real_prefill
        torch.cuda.empty_cache()
    ssd = next(layer["mamba"] for layer in codes["blocks"]
               if "mamba" in layer)
    mats = [ssd[name] for name in HYBRID_SSD_MATMULS]
    if [tuple(q.codes.shape) for q in mats] != list(
            HYBRID_SSD_MATMULS.values()):
        raise AssertionError(f"jamba's SSD products {mats}")
    for impl in ("fused_dequant", "lns"):
        out[impl].update(_static_layer_ms(
            dev, mats, impl, PREFIX_SLOTS,
            label=f"one {HYBRID_ARCH} SSD layer (6 products, w_B/w_C N 16)"))
    n_codes, code_bytes = _qtensor_count(codes), _weight_bytes(codes)
    del codes, ssd, mats
    gc.collect()      # the counted engines' cycles still hold the codes
    torch.cuda.empty_cache()

    # Engine(static_weights=True) on its own draw: each weight encoded by
    # the engine's leaf hook as it is drawn, never the bf16 set at once
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = _hybrid_engine(dev, fp8, None, short=True, static_weights=True)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    own, own_bytes = _qtensor_count(eng.params), _weight_bytes(eng.params)
    r = _counted_run(eng, short, KERNEL_GEN)
    peak = torch.cuda.max_memory_allocated()
    print(f"# {HYBRID_ARCH} depth {HYBRID_DEPTH} Engine(static_weights="
          f"True) on its own draw: {own} weights as codes "
          f"({own_bytes / 1e9:.3f} GB of weights, {code_bytes / 1e9:.3f} GB "
          f"through quantize_params), built in {built:.2f} s; "
          f"{r['substeps']} "
          f"sub-steps, finite logits; {before / 2**30:.2f} GiB allocated "
          f"before, peak {peak / 2**30:.2f} GiB; [{card}]", flush=True)
    if own != n_codes or own_bytes != code_bytes:
        raise AssertionError(f"{HYBRID_ARCH}: the engine's own static draw "
                             f"holds {own} codes ({own_bytes} B), "
                             f"quantize_params {n_codes} ({code_bytes} B)")
    out["own_draw"] = dict(peak=peak, weight_bytes=own_bytes)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # float32 parameters (~53 GB): K1 against the plain attention
    _logits_through_k1(dev, HYBRID_ARCH, HYBRID_DEPTH)
    out["k1_err"] = max(errs)
    return out


def _plain_attention_policy(pol):
    return pol.replace(attention_qk=dataclasses.replace(pol.attention_qk,
                                                        impl="ref"))


class _ShadowK1:
    """Within the block, every K1 call (the first ``limit``, when given)
    is also computed by its plain version (``page_partials_plain`` and
    the combine) on the very same inputs, the model's own, and held to
    K1's gate, rtol = atol = 1e-4; the kernel's output is what the model
    goes on with.  Counts the calls held and keeps the largest
    difference.  The launch counters stay ``paged_attend``'s."""

    def __init__(self, limit=None):
        self.limit = limit

    def __enter__(self):
        import torch
        from repro_torch.kernels import paged_attention as pa

        self.pa, self.real = pa, pa.paged_attend
        self.calls, self.err = 0, 0.0

        def shadowed(*args, **kw):
            out = self.real(*args, **kw)
            if self.limit is not None and self.calls >= self.limit:
                return out
            want = pa._combine_partials(*pa.page_partials_plain(*args, **kw))
            torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
            self.err = max(self.err, float((out - want).abs().max()))
            self.calls += 1
            return out

        self.counts = {n: getattr(self.real, n) for n in _K1_COUNTERS}
        for n, v in self.counts.items():
            setattr(shadowed, n, v)
        pa.paged_attend = shadowed
        return self

    def __exit__(self, *exc):
        # the kernel's wrapper counts its launches on the module's
        # ``paged_attend``, which is ``shadowed`` within the block
        shadowed = self.pa.paged_attend
        for n, v in self.counts.items():
            setattr(self.real, n, getattr(self.real, n)
                    + getattr(shadowed, n) - v)
        self.pa.paged_attend = self.real
        return False


# K1's launch counters: each instance, and each in its partials mode
_K1_COUNTERS = ("launches", "float_launches", "partials_launches",
                "float_partials_launches")


def _launch_counts():
    from repro_torch.kernels import paged_attention as pa

    return pa.paged_attend.launches, pa.paged_attend.float_launches


def _gate_logits(kern, plain, label: str, fp8: bool,
                 what: str = "K1 vs plain-attention logits") -> float:
    """K1's and the plain attention's logits: within rtol = atol = 1e-3 on
    float pages; printed on FP8 pages, where they are no gate.  There the
    query codes (RNE) and the KV writes (stochastic rounding) of every
    layer past the first quantize activations that already differ by the
    float32 sums' order (~1e-6): a code that sits at a rounding boundary
    flips, and one flipped code moves the logits by ~1e-3 (full width:
    qwen3-14b 21 logits past 1e-3 after two steps; gemma3-12b 7 % past it
    after 1,040 sub-steps).  Every K1 call on the way is held to its
    plain version on identical inputs instead (:class:`_ShadowK1`)."""
    import numpy as np

    diff = float(np.abs(kern - plain).max())
    if not fp8:
        np.testing.assert_allclose(kern, plain, rtol=1e-3, atol=1e-3)
    print(f"# {label}: {what} max diff {diff:.3e} "
          f"({'printed, not gated: FP8 codes' if fp8 else 'within 1e-3'})",
          flush=True)
    return diff


WINDOW_PROMPT = 1040    # the local layers' window of 1,024 skips page 0
WINDOW_DEPTH = 6


def window_path(dev) -> None:
    """Windows on the model path: gemma3-12b at full width, depth 6 (5
    local layers and the global one), float32 parameters, on FP8 pages
    (serve_fp8_paged) and on float32 pages (the default policy).  One
    slot prefills the first 1,023 tokens of a 1,040-token prompt (those
    the window leaves whole) in one batched call spliced into pages, then
    the next 16 through K1 (where the window starts to mask), every K1
    call held to its plain version on the same inputs
    (:class:`_ShadowK1`); then, from that cache, the last prompt token and
    one decode step (the local layers' window of 1,024 skips page 0) run
    once through K1 and once through the plain attention: their logits
    within rtol = atol = 1e-3 on float32 pages (:func:`_gate_logits`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(4)
    for policy in ("serve_fp8_paged", None):
        base = get_config("gemma3-12b", policy=policy)
        cfg = dataclasses.replace(base, n_layers=WINDOW_DEPTH,
                                  param_dtype="float32")
        plain_cfg = dataclasses.replace(
            cfg, numerics=_plain_attention_policy(base.policy))
        fp8 = cfg.policy.kv_quantized
        prompt = rng.integers(0, cfg.vocab, size=(1, WINDOW_PROMPT))
        n = WINDOW_PROMPT - 1
        early = cfg.window - 1  # sub-steps whose reads the window leaves whole
        eng = Engine(cfg, slots=1, max_seq=WINDOW_PROMPT + 1, page_size=16,
                     rng_seed=3, device=dev)

        def tail():
            last = prompt[:, -1:]
            first = eng.step_chunk(last, np.asarray([n]), np.ones(1, np.int32))
            second = eng.step_chunk(last, np.asarray([n + 1]),
                                    np.ones(1, np.int32))
            return np.stack([first, second])

        t0 = time.perf_counter()
        before = _launch_counts()
        # the tokens the window leaves whole: one batched prefill spliced
        # into pages (no K1 call), then sub-steps through K1
        eng.prefill_batch([prompt[0, :early]], [0])
        eng.pool.ensure_capacity_batch(np.asarray([WINDOW_PROMPT + 1]))
        with _ShadowK1() as shadow:
            eng.step_chunk(prompt[:, early:n], np.asarray([early], np.int32),
                           np.asarray([n - early], np.int32))
            saved = {k: v.clone() for k, v in eng.cache.items()}
            kern = tail()
        launched = [a - b for a, b in zip(_launch_counts(), before)]
        t1 = time.perf_counter()
        for k, v in saved.items():
            eng.cache[k].copy_(v)
        eng.model.cfg = eng.cfg = plain_cfg
        before = _launch_counts()
        plain = tail()
        none = [a - b for a, b in zip(_launch_counts(), before)]
        del eng, saved
        torch.cuda.empty_cache()
        want = WINDOW_DEPTH * (WINDOW_PROMPT + 1 - early)
        got = launched[0] if fp8 else launched[1]
        if (got != want or sum(launched) != want or any(none)
                or shadow.calls != want):
            raise AssertionError(f"K1 launches {launched} (plain run {none}, "
                                 f"shadowed calls {shadow.calls}), want "
                                 f"{want} of one instance, each shadowed")
        label = (f"gemma3-12b depth {WINDOW_DEPTH}, float32, "
                 f"{_policy_label(cfg, policy)}, {WINDOW_PROMPT}-token "
                 f"prompt (window {cfg.window} skips page 0 on the local "
                 "layers)")
        print(f"# {label}: {got} K1 launches, the {shadow.calls} past "
              f"{early} tokens each within {shadow.err:.3e} of "
              f"its plain version on the same inputs; K1 path "
              f"{t1 - t0:.1f} s wall", flush=True)
        _gate_logits(kern, plain, label + ", last prompt position and one "
                     "decode step", fp8)


DENSE_DEPTH = 2     # gemma2-27b: one local and one global layer


def dense_family_path(dev, arch: str) -> None:
    """gemma2-27b or qwen3-14b at full width, depth 2: float32 logits of a
    prefill chunk and a decode step through K1 (every K1 call held to its
    plain version on the same inputs) and through the plain attention, on
    both page kinds (:func:`_gate_logits`: within rtol = atol = 1e-3 on
    float32 pages; for gemma2 the attention softcap of 50 and the final
    softcap of 30), then 4 requests served on bf16 pages (the CLI's
    default) with fused decode on and off: token streams bitwise equal,
    K1's float instance launched n_layers x sub-steps times."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    _logits_through_k1(dev, arch, DENSE_DEPTH)
    cfg = dataclasses.replace(get_config(arch), n_layers=DENSE_DEPTH)
    plens, gen = SERVE_PLENS[:4], 8
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in plens]
    runs, params = [], None
    for fused_on in (True, False):
        eng = Engine(cfg, slots=4, max_seq=max(plens) + gen, page_size=16,
                     rng_seed=0, fused_decode=fused_on, device=dev)
        if params is None:
            params = _lively(eng).params
        else:
            eng.params = params
        run = _counted_run(eng, queue, gen)
        print(f"# {arch} depth {DENSE_DEPTH} serve "
              f"{_policy_label(cfg, None)} fused={fused_on}: "
              f"{run['substeps']} sub-steps, {run['flt']} K1 float "
              f"launches, {run['wall']:.3f} s wall, distinct tokens per "
              f"stream {[len(set(o)) for o in run['outputs'].values()]}",
              flush=True)
        runs.append(run["outputs"])
        del eng
    del params
    torch.cuda.empty_cache()
    if runs[0] != runs[1]:
        raise AssertionError(f"{arch}: token streams differ with fused "
                             "decode on/off")
    print(f"# {arch}: token streams bitwise equal with fused decode on and "
          "off", flush=True)


# --------------------------------------------------------------------------- #
# The bucketed scheduler, the dense cache and the prefill splice; static FP8
# weights, decoded before each product or multiplied as codes by K2 and K3
# --------------------------------------------------------------------------- #
BUCKET_LOGIT_DEPTH = 6     # one whole 5:1 period, float32 parameters
STATIC_PLENS = (5, 17, 9, 2)        # the static-weight phase's 4 requests
STATIC_GEN = 8
STATIC_DEPTH = 6           # one whole 5:1 period (cut for time from 48)
KERNEL_DEPTH = 6           # one whole 5:1 period
# K3's runs: its plain version, which every call is held to, takes ~0.15 s
# a layer at M = 4, so K3 runs under the bucketed scheduler alone (its
# decode steps at M = 4, its prefill at M = 32); K2 under both
KERNEL_SCHEDULERS = {"fused_dequant": ("continuous", "bucketed"),
                     "lns": ("bucketed",)}
KERNEL_PLEN = 8            # 4 prompts of one length: one prefill, M = 32
KERNEL_GEN = 4


def _kernel_queue(cfg, seed: int = 7) -> list:
    """The kernel runs' ``PREFIX_SLOTS`` prompts of ``KERNEL_PLEN`` random
    tokens: every decode sub-step at M = the slots, and a bucketed run's
    one prefill at M = ``PREFIX_SLOTS`` x ``KERNEL_PLEN``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=KERNEL_PLEN)
            for _ in range(PREFIX_SLOTS)]
BUCKET_SHALLOW_DEPTH = 6   # the bucketed runs set against continuous ones
# one gemma3-12b layer's seven static-weight matmuls: (K, N) -> count
# (wq; wk and wv; wo; w_gate and w_up; w_down)
G3_LAYER_MATMULS = {(3840, 4096): 1, (3840, 2048): 2, (4096, 3840): 1,
                    (3840, 15360): 2, (15360, 3840): 1}


def _agreement(a: dict, b: dict) -> tuple:
    """Share of equal tokens of two runs' streams, and the first
    divergence as (request, token index), or None."""
    same = total = 0
    first = None
    for rid in sorted(a):
        x, y = a[rid], b.get(rid, [])
        for i, t in enumerate(x):
            total += 1
            if i < len(y) and y[i] == t:
                same += 1
            elif first is None:
                first = (rid, i)
    return same / max(total, 1), first


def _dense_cache_bytes(cfg, slots: int, max_seq: int) -> int:
    """The dense cache's bytes from its layout: K and V rows of every
    layer, ``min(max_seq, window)`` of them for a local layer."""
    item = 1 if cfg.policy.kv_quantized else 2
    rows = sum(min(max_seq, cfg.window)
               if cfg.window and not cfg.is_global_attn_layer(i) else max_seq
               for i in range(cfg.n_layers))
    return 2 * rows * slots * cfg.n_kv_heads * cfg.hd * item


def _bucketed_first_decode_logits(dev, cfg, params, impl: str):
    """Two prompts (lengths 9 and 5) prefilled then one decode step of the
    same tokens, under the bucketed scheduler's calls on the ``impl``
    cache (``prefill_batch`` then ``decode`` / ``decode_paged``) or under
    the continuous scheduler's (``step_chunk`` sub-steps; ``impl``
    "continuous"): the decode step's float32 logits."""
    import numpy as np
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (9, 5)]
    nxt = rng.integers(0, cfg.vocab, size=2)
    eng = Engine(cfg, slots=2, max_seq=16, page_size=16, rng_seed=3,
                 cache_impl="dense" if impl == "dense" else "paged",
                 stochastic_kv=False, device=dev)
    eng.params = params
    pos = np.asarray([9, 5])
    if impl == "continuous":
        toks = np.zeros((2, 9), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        eng.pool.ensure_capacity_batch(pos)
        eng.step_chunk(toks, np.zeros(2, np.int32), pos.astype(np.int32))
        eng.pool.ensure_capacity_batch(pos + 1)
        return eng.step_chunk(nxt[:, None], pos.astype(np.int32),
                              np.ones(2, np.int32))
    for i, p in enumerate(prompts):
        eng.prefill_batch([p], [i])
    if impl == "dense":
        return eng.decode(nxt, pos)
    return eng.decode_paged(nxt, pos)


def bucketed_logits_path(dev, policy, params) -> None:
    """The gate behind the bucketed phase's printed token agreement: at
    depth 6 (the main path's first 6 layers, float32), the first decode
    step's logits after a bucketed prefill on the dense cache, after one
    on the paged cache (the splice), and after a continuous (sub-step)
    prefill: dense vs paged and continuous vs bucketed within rtol = atol
    = 1e-3 on float32 pages (:func:`_gate_logits`; printed on FP8 pages,
    where a ~1e-6 difference flips a code at a rounding boundary)."""
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("gemma3-12b", policy=policy),
                              n_layers=BUCKET_LOGIT_DEPTH,
                              param_dtype="float32")
    shallow = {k: v.float() for k, v in params.items() if k != "blocks"}
    shallow["blocks"] = [{k: (v.float() if isinstance(v, torch.Tensor)
                              else {n: t.float() for n, t in v.items()})
                          for k, v in layer.items()}
                         for layer in params["blocks"][:BUCKET_LOGIT_DEPTH]]
    got = {impl: _bucketed_first_decode_logits(dev, cfg, shallow, impl)
           for impl in ("dense", "paged", "continuous")}
    del shallow
    torch.cuda.empty_cache()
    fp8 = cfg.policy.kv_quantized
    label = (f"gemma3-12b depth {BUCKET_LOGIT_DEPTH}, float32, "
             f"{_policy_label(cfg, policy)}, first decode step")
    _gate_logits(got["dense"], got["paged"], label, fp8,
                 what="bucketed dense vs paged cache logits")
    _gate_logits(got["continuous"], got["paged"], label, fp8,
                 what="continuous vs bucketed (paged) logits")


def bucketed_path(dev, policy, params, continuous) -> dict:
    """The bucketed scheduler at full width: gemma3-12b on the main path's
    weights (their first 6 layers, one 5:1 period, ``BUCKET_SHALLOW_DEPTH``:
    cut for time) and its 8 prefix-phase requests on 4 slots, page 16, 16
    generated tokens as the prefix phases: on the dense cache; on the
    paged cache (the batched prefill's rows spliced into pages) fused,
    unfused, and fused again with every K1 call held to its plain version
    on the same inputs (:class:`_ShadowK1`); with the prefix cache on
    (every admission prefills its uncached tail through ``tail_prefill``)
    and off; on FP8 pages also a continuous and a bucketed run with
    deterministic KV writes.  These stand beside ``continuous``:
    :func:`preempt_shared_path`'s worst-case-pool streams of the same
    policy (depth 6, prefix on, continuous).

    Bitwise gates, on streams that vary (:func:`_require_varied`): paged
    fused == unfused == the shadowed run; the prefix cache on ==
    ``continuous``: both prefill through single-token sub-steps whose KV
    rounding is addressed by position, and a slot's numerics do not
    depend on the batch's other rows.  Also: K1 launched n_layers x
    sub-steps and never on the dense cache; the dense cache's bytes from
    its layout.  Printed, as the reference promises no more at this width
    (the splice sets a page's scale from the whole page, chunked prefill
    from its first token, and a full-sequence prefill sums in another
    order, so a greedy token can flip): the token agreement of dense vs
    paged, of the prefix cache on vs off (splice), and of continuous vs
    bucketed (deterministic KV writes on FP8 pages; on float pages the
    writes are casts), whose logits :func:`bucketed_logits_path`
    gates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cache_bytes

    cfg = get_config("gemma3-12b", policy=policy)
    label = _policy_label(cfg, policy)
    fp8 = cfg.policy.kv_quantized
    queue = _prefix_queue(cfg)
    shallow_cfg = dataclasses.replace(cfg, n_layers=BUCKET_SHALLOW_DEPTH)
    shallow = _shallow(params, BUCKET_SHALLOW_DEPTH)
    # (name, Engine keywords, scheduler, shadowed); every run at depth 6,
    # cut for time (``BUCKET_SHALLOW_DEPTH``)
    plans = [("dense", dict(cache_impl="dense"), "bucketed", False),
             ("fused", dict(), "bucketed", False),
             ("unfused", dict(fused_decode=False), "bucketed", False),
             ("shadowed", dict(), "bucketed", True),
             ("prefix", dict(prefix_cache=True), "bucketed", False),
             ("off", dict(), "bucketed", False)]
    if fp8:
        plans += [("bucketed_rne", dict(stochastic_kv=False), "bucketed",
                   False),
                  ("continuous_rne", dict(stochastic_kv=False),
                   "continuous", False)]
    runs, shadow = {}, None
    gen = PREFIX_GEN
    for name, kw, scheduler, shadowed in plans:
        eng = _prefix_engine(dev, shallow_cfg, shallow, **kw)
        if shadowed:
            with _ShadowK1() as shadow:
                run = _counted_run(eng, queue, gen, scheduler)
        else:
            run = _counted_run(eng, queue, gen, scheduler)
        st = run["stats"]
        extra = ""
        if name == "dense":
            want = _dense_cache_bytes(eng.cfg, PREFIX_SLOTS, eng.max_seq)
            got = eng.kv_cache_bytes()
            if got != want or cache_bytes(eng.cache) != want:
                raise AssertionError(f"dense cache {got} B, want {want}")
            extra = f", dense cache {got} B (= its layout's)"
        print(f"# gemma3-12b depth {eng.cfg.n_layers} {scheduler} {label}, "
              f"{name}: {len(queue)} requests, {gen} generated, "
              f"{st['steps']} steps, {run['substeps']} sub-steps, "
              f"{run['lns']} K1 LNS and {run['flt']} K1 float launches, "
              f"{st['prefix_hit_tokens']} prefix hit tokens, "
              f"{run['wall']:.3f} s wall, {st['decode_tok_s']:.2f} decode "
              f"tok/s{extra}", flush=True)
        if (st["prefix_hit_tokens"] >= 4 * PREFIX_SHARED) != (name ==
                                                              "prefix"):
            raise AssertionError(f"{name}: {st['prefix_hit_tokens']} prefix "
                                 "hit tokens")
        runs[name] = run
        del eng
        torch.cuda.empty_cache()
    out = {k: r["outputs"] for k, r in runs.items()}
    distinct = _require_varied(out["fused"], f"gemma3-12b bucketed {label}",
                               constant_share=0.25)
    if out["unfused"] != out["fused"] or out["shadowed"] != out["fused"]:
        raise AssertionError(f"gemma3-12b bucketed {label}: token streams "
                             "differ fused/unfused or between two runs")
    print(f"# gemma3-12b bucketed {label}: paged fused == unfused == a "
          f"second run bitwise (distinct tokens per stream {distinct}); its "
          f"{shadow.calls} K1 calls each within {shadow.err:.3e} of the "
          "plain version", flush=True)
    _require_varied(out["prefix"], f"gemma3-12b bucketed prefix on {label}",
                    constant_share=0.25)
    if out["prefix"] != continuous:
        raise AssertionError(f"gemma3-12b {label}: bucketed token streams "
                             "with the prefix cache on differ from the "
                             "continuous scheduler's")
    hits = runs["prefix"]["stats"]["prefix_hit_tokens"]
    print(f"# gemma3-12b depth {BUCKET_SHALLOW_DEPTH} {label}: bucketed with "
          f"the prefix cache on ({hits} hit tokens, tail_prefill) == "
          "continuous, token streams bitwise", flush=True)
    pairs = [("dense vs paged (bucketed)", out["dense"], out["fused"]),
             (f"depth {BUCKET_SHALLOW_DEPTH}, bucketed prefix cache on vs off",
              out["prefix"], out["off"])]
    if fp8:
        pairs.append((f"depth {BUCKET_SHALLOW_DEPTH}, continuous vs "
                      "bucketed, deterministic KV writes",
                      out["continuous_rne"], out["bucketed_rne"]))
    else:
        pairs.append((f"depth {BUCKET_SHALLOW_DEPTH}, continuous vs "
                      "bucketed", continuous, out["off"]))
    for what, a, b in pairs:
        share, first = _agreement(a, b)
        print(f"# gemma3-12b {label}, {what}: {100 * share:.1f} % of tokens "
              f"equal, first divergence (request, token) {first}; distinct "
              f"tokens per stream {[len(set(o)) for o in b.values()]}",
              flush=True)
    return dict(launches=runs["fused"]["launches"],
                substeps=runs["fused"]["substeps"], k1_calls=shadow.calls,
                k1_err=shadow.err)


def _qtensor_count(params) -> int:
    """The ``QTensor`` leaves of a parameter tree."""
    from repro_torch.core.quant import QTensor

    if isinstance(params, dict):
        return sum(_qtensor_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(_qtensor_count(v) for v in params)
    return int(isinstance(params, QTensor))


def _weight_bytes(params) -> int:
    from repro_torch.core.quant import QTensor

    def walk(t):
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, list):
            return sum(walk(v) for v in t)
        if isinstance(t, QTensor):
            return walk(t.codes) + walk(t.scale)
        return t.numel() * t.element_size()

    return walk(params)


def static_weights_path(dev, params) -> dict:
    """Static FP8 weights at full width and depth ``STATIC_DEPTH`` (cut for
    time): gemma3-12b under
    serve_fp8_paged, continuous scheduler, prefix off, 4 requests of 5-17
    tokens, 8 generated.  ``Engine(static_weights=True)`` serves the main
    path's weights quantized (``quantize_params``: E4M3 codes, one scale a
    tensor), each matmul decoding its weight to bf16 first (the
    reference's route when matmuls are unquantized); an Engine with plain
    bf16 weights set to ``resolve_weight`` of the same codes serves the
    same requests.  Gate: token streams bitwise equal (the same bf16
    product in the same order) and varied (:func:`_require_varied`).
    Printed: the weight bytes on the card, the peak memory, both walls,
    and the card time of decoding one layer's weights.  Consumes
    ``params`` (its bf16 weights are dropped once quantized); returns the
    codes for :func:`static_kernel_path`."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QTensor
    from repro_torch.launch.serve import Engine
    from repro_torch.models.quantize import quantize_params, resolve_weight

    full = get_config("gemma3-12b", policy="serve_fp8_paged")
    cfg = dataclasses.replace(full, n_layers=STATIC_DEPTH)
    rng = np.random.default_rng(6)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in STATIC_PLENS]
    shallow = _shallow(params, STATIC_DEPTH)
    bf16_bytes = _weight_bytes(shallow)
    codes = quantize_params(shallow, cfg.policy,
                            period=cfg.layer_pattern_period)
    del shallow
    params.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kw = dict(slots=PREFIX_SLOTS, max_seq=max(STATIC_PLENS) + STATIC_GEN,
              page_size=16, rng_seed=0, device=dev)
    eng = Engine(cfg, static_weights=True, **kw)
    own = eng.params["blocks"][0]["attn"]["wq"]
    if not isinstance(own, QTensor) or own.codes.dtype != torch.uint8:
        raise AssertionError("Engine(static_weights=True) holds no codes")
    eng.params = codes
    torch.cuda.empty_cache()
    static = _counted_run(eng, queue, STATIC_GEN)
    peak = torch.cuda.max_memory_allocated(dev)
    del eng
    torch.cuda.empty_cache()
    plain_params = {k: resolve_weight(v) if isinstance(v, QTensor) else v
                    for k, v in codes.items() if k != "blocks"}
    plain_params["blocks"] = [
        {k: ({n: resolve_weight(t) for n, t in v.items()}
             if isinstance(v, dict) else v) for k, v in layer.items()}
        for layer in codes["blocks"]]
    eng = Engine(cfg, **kw)
    eng.params = plain_params
    plain = _counted_run(eng, queue, STATIC_GEN)
    del eng, plain_params
    torch.cuda.empty_cache()
    distinct = _require_varied(static["outputs"], "static weights",
                               constant_share=0.25)
    if static["outputs"] != plain["outputs"]:
        raise AssertionError("static weights: token streams differ from the "
                             "plain bf16 engine on the decoded codes")
    mats = _gqa_mats(codes["blocks"][0])
    decode_ms, how = device_ms(lambda: [resolve_weight(q) for q in mats],
                               iters=10)
    qbytes = _weight_bytes(codes)
    print(f"# gemma3-12b depth {cfg.n_layers} static weights "
          f"(serve_fp8_paged, continuous, "
          f"{len(queue)} requests, {static['substeps']} sub-steps): weights "
          f"on the card {qbytes / 1e9:.3f} GB as codes against "
          f"{bf16_bytes / 1e9:.3f} GB of bf16; peak memory "
          f"{peak / 2**30:.1f} GiB; wall {static['wall']:.3f} s static "
          f"against {plain['wall']:.3f} s on the decoded bf16 weights; "
          f"token streams bitwise equal (distinct tokens per stream "
          f"{distinct}); decoding one layer's 7 weights "
          f"{decode_ms:.4f} ms of card time ({how}), "
          f"{full.n_layers * decode_ms:.2f} ms a full-depth sub-step",
          flush=True)
    return dict(codes=codes, decode_ms=decode_ms, wall=static["wall"],
                plain_wall=plain["wall"], weight_bytes=qbytes,
                bf16_bytes=bf16_bytes, peak=peak)


def k_static_policy(impl: str):
    """serve_fp8_paged with every matmul quantized: E4M3 activations times
    the stored E4M3 weight codes through ``impl`` (``fused_dequant``: K2;
    ``lns``: K3), float32 sums."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("serve_fp8_paged").replace(matmul=OpPolicy(
        fmt="e4m3", mode="rne", impl=impl, accum="f32"))


SHADOW_SUM_LIMIT = 2.0   # x sqrt(K) 2^-24 sum|products|, see _ShadowMatmul


class _ShadowMatmul:
    """Within the block, every call of K2 (``dequant_matmul``) or K3
    (``lns_product_matmul``) is also computed by its plain version on the
    very same codes and held to its gate, element by element:
    |kernel - plain| <= ``SHADOW_SUM_LIMIT`` sqrt(K) 2^-24 sum|products|.
    Both sum the same exact products (K3's products themselves are held
    bitwise by :func:`check_k3_products`) in float32 in another order; the
    rounding of each sum grows like sqrt(K) u sum|products| (u = 2^-24;
    the worst case 2 K u sum|products| of :func:`_sum_bound` is sqrt(K),
    62 to 124 times, looser at these K), while one product left out or
    counted twice is an error of the order of sum|products| / K, which
    this limit catches at every K the model has.  The kernel's output is
    what the model goes on with.  Counts the calls, their shapes, the
    largest difference, its largest share of the limit and of the call's
    largest |plain|; the launch counters stay the wrapper's.  ``limit``:
    hold the first ``limit`` calls only.  A batch of expert products [E,
    M, K] x [E, K, N] is held expert by expert."""

    def __init__(self, which: str, limit=None):
        self.which, self.limit = which, limit

    def __enter__(self):
        import torch
        from repro_torch.kernels import lns_matmul as lm

        self.lm, self.real = lm, getattr(lm, self.which)
        plain2d = (lm.dequant_matmul_plain
                   if self.which == "dequant_matmul" else lm.lns_matmul_plain)

        def plain(x, w, **kw):
            if x.ndim == 3:
                return torch.stack([plain2d(a, b, **kw)
                                    for a, b in zip(x, w)])
            return plain2d(x, w, **kw)

        self.calls, self.err, self.shapes = 0, 0.0, {}
        self.of_limit, self.rel = 0.0, 0.0

        def shadowed(x, w, **kw):
            out = self.real(x, w, **kw)
            if self.limit is not None and self.calls >= self.limit:
                return out
            want = plain(x, w, **kw)
            absum = plain(x & 0x7F, w & 0x7F, **kw)
            diff = (out - want).abs()
            limit = SHADOW_SUM_LIMIT * x.shape[-1] ** 0.5 * 2.0**-24 * absum
            if not torch.isfinite(out).all() or bool((diff > limit).any()):
                raise AssertionError(f"{self.which} differs from its plain "
                                     f"version at {tuple(x.shape)} x "
                                     f"{tuple(w.shape)} beyond "
                                     f"{SHADOW_SUM_LIMIT} sqrt(K) 2^-24 "
                                     "sum|products|")
            self.err = max(self.err, float(diff.max()))
            self.of_limit = max(self.of_limit, float(
                (diff / limit.clamp_min(torch.finfo(torch.float32).tiny))
                .max()))
            self.rel = max(self.rel, float(diff.max())
                           / max(float(want.abs().max()), 1e-30))
            self.calls += 1
            key = (x.shape[-2],) + tuple(w.shape)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return out

        self.start = self.real.launches
        shadowed.launches = self.start
        setattr(lm, self.which, shadowed)
        return self

    def __exit__(self, *exc):
        shadowed = getattr(self.lm, self.which)
        self.real.launches += shadowed.launches - self.start
        setattr(self.lm, self.which, self.real)
        return False


def _gqa_mats(layer) -> list:
    """A GQA layer's seven static weights (attention, then the MLP)."""
    return [layer["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [layer["ffn"][n] for n in ("w_gate", "w_up", "w_down")]


PLAIN_EVENTS_M = 1024   # a plain K3's rows from which CUDA events time it


def _static_layer_ms(dev, mats, impl: str, M: int,
                     label: str = "one gemma3-12b layer (7 matmuls)") -> dict:
    """Card time of one layer's static-weight matmuls ``mats`` (QTensors;
    gemma3-12b's seven, :func:`_gqa_mats`) at M rows (E4M3 codes of
    random activations times the layer's stored codes): the kernel, its
    plain version and, for K2, ``torch.matmul`` on the decoded bf16
    operands; the function's bound (its bytes: the weight
    codes, x's codes and the float32 out, once each, over the memory rate;
    against its 2 M K N operations at the card's dense rate, bf16 for K2's
    float products, 8-bit for K3's) and, for K3, its R-fold plane work
    beside it.  A plain K3 at M >= ``PLAIN_EVENTS_M`` is timed once
    between CUDA events (host included, :func:`cuda_ms`), not by the
    profiler, whose record of its launches takes tens of seconds to
    read there."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.kernels.common import code_to_f32, lns_plane_tables

    g = torch.Generator(device=dev).manual_seed(M)
    xs = [quantize(torch.randn((M, q.codes.shape[0]), generator=g,
                               device=dev), "e4m3").codes for q in mats]
    if impl == "fused_dequant":
        def kern(i):
            return lm.dequant_matmul(xs[i], mats[i].codes, fmt="e4m3",
                                     w_fmt="e4m3",
                                     compute_dtype=torch.float32)

        def plain(i):
            return lm.dequant_matmul_plain(xs[i], mats[i].codes, fmt="e4m3",
                                           w_fmt="e4m3",
                                           compute_dtype=torch.float32)
        only = "dequant_matmul_kernel"
    else:
        def kern(i):
            return lm.lns_product_matmul(xs[i], mats[i].codes, fmt="e4m3",
                                         mode="rne")

        def plain(i):
            return lm.lns_matmul_plain(xs[i], mats[i].codes, fmt="e4m3",
                                       mode="rne")
        only = "lns_matmul_kernel"
    n = len(mats)
    ms, how = device_ms(lambda: [kern(i) for i in range(n)], iters=20,
                        only=only)
    plain_events = impl == "lns" and M >= PLAIN_EVENTS_M
    if plain_events:
        plain_ms = cuda_ms(lambda: [plain(i) for i in range(n)], iters=1,
                           warmup=0)
    else:
        plain_ms, _ = device_ms(lambda: [plain(i) for i in range(n)],
                                iters=1 if impl == "lns" else 10, warmup=1)
    res = dict(ms=ms, plain_ms=plain_ms, how=how, library_ms=None)
    if impl == "fused_dequant":
        dec = [(code_to_f32(x, "e4m3").to(torch.bfloat16),
                code_to_f32(q.codes, "e4m3").to(torch.bfloat16))
               for x, q in zip(xs, mats)]
        res["library_ms"], _ = device_ms(
            lambda: [torch.matmul(a, b) for a, b in dec], iters=20)
    prods = sum(M * q.codes.shape[0] * q.codes.shape[1] for q in mats)
    nbytes = sum(q.codes.numel() + M * q.codes.shape[0]
                 + 4 * M * q.codes.shape[1] for q in mats)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOP_PER_S if impl == "fused_dequant" else INT8_OPS_PER_S
    b_ops = 2 * prods / rate * 1e3
    res.update(bound_ms=max(b_bytes, b_ops),
               bound_by="bytes" if b_bytes >= b_ops else "operations",
               nbytes=nbytes, prods=prods)
    note = ""
    if impl == "lns":
        R = lns_plane_tables("e4m3", "rne").R
        note = (f"; the design's own work beside it (never the bound): "
                f"{R} x {2 * prods} plane FLOP = "
                f"{R * 2 * prods / BF16_FLOP_PER_S * 1e3:.5f} ms at 989 "
                "TFLOP/s")
    lib = ("" if res["library_ms"] is None else
           f", torch.matmul on decoded bf16 {res['library_ms']:.5f} ms")
    print(f"# {'K2' if impl == 'fused_dequant' else 'K3'} static weights, "
          f"{label} at M = {M}: kernel {ms:.5f} ms "
          f"({how}), plain {plain_ms:.4f} ms"
          f"{' (CUDA events, host included)' if plain_events else ''}"
          f"{lib}; bound "
          f"{res['bound_ms']:.5f} ms = max({nbytes} B / 3.35 TB/s = "
          f"{b_bytes:.5f} ms, {2 * prods} operations = {b_ops:.5f} ms) -> "
          f"{res['bound_by']} (kernel / bound "
          f"{ms / res['bound_ms']:.1f}){note}", flush=True)
    return res


def static_kernel_path(dev, codes) -> dict:
    """Static weights through K2 and K3: gemma3-12b at full width, depth 6
    (the static phase's codes, first 6 layers), under
    :func:`k_static_policy` for ``fused_dequant`` (K2) and ``lns`` (K3): 4
    requests of 8 tokens, 4 generated, under the continuous scheduler
    (every matmul at M = 4 slots; K2 only, ``KERNEL_SCHEDULERS``) and the
    bucketed one (one batched prefill at M = 4 x 8 = 32, then decode at
    M = 4), every K2/K3 call held to its plain version on the model's own
    codes (:class:`_ShadowMatmul`).  Launches: 7 x n_layers per model
    call (a sub-step or a batched prefill) of the kernel under test, none
    of the other; the tied LM head stays a bf16 product on the embedding.
    The streams must vary (:func:`_require_varied`, at most a quarter of
    them on one token), so that the kernels see the model's own
    activations.  Then each kernel alone on one layer's weights at M = 4
    and M = 32 beside its bound (:func:`_static_layer_ms`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(7)
    res = {}
    shallow = _shallow(codes, KERNEL_DEPTH)
    for impl, which in (("fused_dequant", "dequant_matmul"),
                        ("lns", "lns_product_matmul")):
        cfg = dataclasses.replace(
            get_config("gemma3-12b"), numerics=k_static_policy(impl),
            n_layers=KERNEL_DEPTH)
        queue = [rng.integers(0, cfg.vocab, size=KERNEL_PLEN)
                 for _ in range(PREFIX_SLOTS)]
        streams, launches = {}, 0
        for scheduler in KERNEL_SCHEDULERS[impl]:
            eng = Engine(cfg, slots=PREFIX_SLOTS,
                         max_seq=KERNEL_PLEN + KERNEL_GEN, page_size=16,
                         rng_seed=0, device=dev)
            eng.params = shallow
            prefills = []
            real_prefill = eng.prefill_batch

            def counted(prompts, slots, real=real_prefill, seen=prefills):
                seen.append(len(prompts) * len(prompts[0]))
                return real(prompts, slots)

            eng.prefill_batch = counted
            _reset_matmul_counts()
            with _ShadowMatmul(which) as shadow:
                run = _counted_run(eng, queue, KERNEL_GEN, scheduler)
            k3, k2 = _matmul_counts()
            got, other = (k2, k3) if impl == "fused_dequant" else (k3, k2)
            calls = run["substeps"] + len(prefills)
            want = 7 * KERNEL_DEPTH * calls
            print(f"# gemma3-12b depth {KERNEL_DEPTH} static weights, "
                  f"matmul {impl}, {scheduler}: {run['substeps']} sub-steps "
                  f"and {len(prefills)} batched prefills (M {prefills}), "
                  f"{got} launches of the kernel under test ({other} of the "
                  f"other), {shadow.calls} calls each within "
                  f"{shadow.err:.3e} of the plain version ({shadow.rel:.2e} "
                  f"of the call's max |plain|; at most {shadow.of_limit:.4f} "
                  f"of the limit {SHADOW_SUM_LIMIT} sqrt(K) 2^-24 "
                  f"sum|products|), at (M, K, N) "
                  f"{sorted(shadow.shapes)}; {run['wall']:.3f} s wall",
                  flush=True)
            if got != want or other or shadow.calls != want:
                raise AssertionError(f"{impl}: {got} launches ({other} of "
                                     f"the other kernel, {shadow.calls} "
                                     f"calls), want {want}")
            if scheduler == "bucketed" and prefills != [
                    PREFIX_SLOTS * KERNEL_PLEN]:
                raise AssertionError(f"bucketed prefills {prefills}")
            _require_varied(run["outputs"], f"static weights through {impl}, "
                            f"{scheduler}", constant_share=0.25)
            streams[scheduler] = run["outputs"]
            launches += got
            mine = res.setdefault(impl, dict(err=0.0, rel=0.0, of_limit=0.0))
            for k in mine:
                mine[k] = max(mine[k], getattr(shadow, k))
            del eng
            torch.cuda.empty_cache()
        if "continuous" in streams:
            share, first = _agreement(streams["continuous"],
                                      streams["bucketed"])
            print(f"# static weights through {impl}: continuous vs bucketed "
                  f"{100 * share:.1f} % of tokens equal, first divergence "
                  f"{first}; distinct tokens per stream "
                  f"{[len(set(o)) for o in streams['bucketed'].values()]}",
                  flush=True)
        res[impl]["launches"] = launches
        for M in (PREFIX_SLOTS, PREFIX_SLOTS * KERNEL_PLEN):
            res[impl][M] = _static_layer_ms(
                dev, _gqa_mats(codes["blocks"][0]), impl, M)
    return res


# --------------------------------------------------------------------------- #
# K5: the paper's six FP8 operations, through the SwiGLU gate
# --------------------------------------------------------------------------- #
K5_SERVE_SHAPE = (8, 4864)         # one decode sub-step's gate product
K5_TRAIN_SHAPE = (8, 128, 4864)    # batch 8 x seq 128 tokens
# A lower count of K5's work than its compiled instruction stream: three
# 32-bit integer operations per element (the paper's add with its
# constant, the carry-in, the saturation); the instruction stream as
# compiled is printed beside it (SASS), for PERF.md.
K5_MIN_OPS_PER_ELEMENT = 3


def k5_serve_policy():
    """serve_fp8_paged with the gate product through K5 in e5m2 (the
    reference's legacy mapping of QuantConfig(elementwise=True): act_fmt)."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("serve_fp8_paged").replace(elementwise=OpPolicy(
        fmt="e5m2", mode="rne", impl="auto", accum="f32"))


def k5_train_policy():
    """train_fp8_lns with the gate product through K5 in e4m3 (the legacy
    mapping coerces act_fmt to the weight format under lns)."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("train_fp8_lns").replace(elementwise=OpPolicy(
        fmt="e4m3", mode="rne", impl="auto", accum="f32"))


def _k5_operands(op, dev):
    import torch

    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    if op in ("mul", "div"):
        X, Y = torch.meshgrid(codes, codes, indexing="ij")
        return X.reshape(-1).contiguous(), Y.reshape(-1).contiguous()
    return codes, None


def check_k5_cells(dev) -> dict:
    """Phase: every supported (format, op, mode) cell of Tables 2/3
    through K5, over all 256 codes or 65,536 code pairs, bitwise against
    the plain version; then the paper's claim on the card: on the exact
    rounding oracle's valid domain, K5's codes are correctly rounded
    (faithful for ``faithful``) in all 69 cells."""
    import torch
    from repro_torch.core.carry_ins import CARRY_INS
    from repro_torch.core.formats import FORMATS
    from repro_torch.core.rounding import Oracle
    from repro_torch.kernels import fp8_elementwise as fe

    cells = passed = checked = 0
    for (fmt, op), modes in sorted(CARRY_INS.items()):
        x, y = _k5_operands(op, dev)
        expected, valid = Oracle(FORMATS[fmt]).quantize_all(
            op, x.cpu().numpy(), None if y is None else y.cpu().numpy())
        for mode, spec in modes.items():
            if spec is None:
                continue
            got = fe.fp8_elementwise(op, x, y, fmt=fmt, mode=mode)
            want = fe.fp8_elementwise_plain(op, x, y, fmt=fmt, mode=mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K5 differs from its plain version "
                                     f"in cell {fmt}/{op}/{mode}")
            checked += got.numel()
            got = got.cpu().numpy()
            if mode == "faithful":
                ok = (got == expected["rd"]) | (got == expected["ru"])
            else:
                ok = got == expected[mode]
            cells += 1
            passed += int((~ok & valid).sum()) == 0
    print(f"# K5 cells: {cells} (format, op, mode) cells, {checked} codes, "
          "bitwise equal to the plain version", flush=True)
    print(f"# Tables 2/3 through K5 on the card: {passed}/{cells} cells "
          "correctly rounded (faithful for faithful) on the oracle's valid "
          "domain", flush=True)
    if (passed, cells) != (69, 69):
        raise AssertionError(f"Tables 2/3 through K5: {passed}/{cells}")
    return dict(cells=cells, passed=passed)


def check_k5_shapes(dev) -> dict:
    """Phase: K5 against its plain version on random codes at the main
    paths' shapes (e5m2 and e4m3 mul) and on a ragged, misaligned view;
    then the card time of e5m2 mul at both shapes beside its bound."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import fp8_elementwise as fe

    g = torch.Generator(device=dev).manual_seed(13)

    def codes(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    ops, err = {}, 0
    for label, shape in (("serve", K5_SERVE_SHAPE), ("train", K5_TRAIN_SHAPE)):
        x, y = codes(shape), codes(shape)
        for fmt in ("e5m2", "e4m3"):
            got = fe.fp8_elementwise("mul", x, y, fmt=fmt, mode="rne")
            want = fe.fp8_elementwise_plain("mul", x, y, fmt=fmt,
                                            mode="rne")
            torch.cuda.synchronize()
            err = max(err, int((got.int() - want.int()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"K5 {fmt} mul differs from its plain "
                                     f"version at {shape}")
        ops[label] = (x, y)
    buf = codes((3 * 4099 + 8,))
    x, y = buf[1:4100], buf[4105:4105 + 4099]   # misaligned, ragged
    for op in ("mul", "div", "rsqrt"):
        got = fe.fp8_elementwise(op, x, None if op == "rsqrt" else y,
                                 fmt="e5m2", mode="rne")
        want = fe.fp8_elementwise_plain(op, x, None if op == "rsqrt" else y,
                                        fmt="e5m2", mode="rne")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {op} differs on a misaligned view")
    print("# K5 mul at the serving and training shapes (e5m2, e4m3) and "
          "mul/div/rsqrt on a misaligned 4,099-code view: bitwise equal to "
          "the plain version", flush=True)

    mix = sass_loop_mix(cuda_build.build(["fp8_elementwise"])[0],
                        "fp8_elementwise_kernelILi0E", per="STG.E.128")
    res = dict(max_abs_err=float(err))  # in code units; 0 = bitwise
    for label, (x, y) in ops.items():
        n, shape = x.numel(), tuple(x.shape)
        k5 = lambda: fe.fp8_elementwise("mul", x, y, fmt="e5m2")  # noqa: E731
        plain = lambda: fe.fp8_elementwise_plain(  # noqa: E731
            "mul", x, y, fmt="e5m2", mode="rne")
        ms, how = device_ms(k5, iters=200, only="fp8_elementwise_kernel")
        plain_ms, _ = device_ms(plain, iters=20)
        call_ms = cuda_ms(k5, iters=200)
        b_bytes = 3 * n / HBM_BYTES_PER_S * 1e3
        b_ops = K5_MIN_OPS_PER_ELEMENT * n / INT32_PER_S * 1e3
        sass_int = mix["int32_per_product"] * n / 16 / INT32_PER_S * 1e3
        res[label] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(b_bytes, b_ops),
                          bound_by="bytes" if b_bytes >= b_ops
                          else "operations")
        print(f"# K5 e5m2 mul at {shape} ({n} codes; card time, {how}): "
              f"kernel {ms:.5f} ms; plain {plain_ms:.4f} ms; bound "
              f"{res[label]['bound_ms']:.5f} ms = max({3 * n} B / 3.35 "
              f"TB/s, {K5_MIN_OPS_PER_ELEMENT} x {n} int32 ops at "
              f"{INT32_PER_S:.4g}/s); the compiled integer stream alone "
              f"{sass_int:.5f} ms; per call incl. host {call_ms:.4f} ms",
              flush=True)
    print("# K5 vector loop (SASS), instructions per 16 codes: "
          + ", ".join(f"{op} {c:.2f}" for op, c in mix["mix"].items())
          + f"; {mix['per_product']:.2f} in all, "
          f"{mix['int32_per_product']:.2f} on the 32-bit integer pipe "
          f"({mix['int32_per_product'] / 16:.2f} per code; "
          f"{(mix['int32_per_product'] + mix['mix'].get('PRMT', 0)) / 16:.2f}"
          " with the byte permutes)", flush=True)
    return res


def check_k5_engine_against_plain(dev) -> None:
    """Phase: a float32 copy of the model under the K5 serving policy:
    the first steps' logits with the gate product through K5 (impl
    "auto") and through the plain version (impl "ref") are bitwise equal,
    since K5's codes are."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import fp8_elementwise as fe

    pol = k5_serve_policy()
    cfg = dataclasses.replace(get_config("qwen2-0.5b", policy=pol),
                              param_dtype="float32")
    ref_pol = pol.replace(elementwise=pol.elementwise.replace(impl="ref"))
    logits, used = [], []
    for c in (cfg, dataclasses.replace(cfg, numerics=ref_pol)):
        before = fe.fp8_elementwise.launches
        logits.append(_first_step_logits(dev, c))
        used.append(fe.fp8_elementwise.launches - before)
    want = 5 * cfg.n_layers  # 4 + 1 sub-steps
    if used != [want, 0]:
        raise AssertionError(f"K5 launches {used}, want [{want}, 0]")
    if not np.array_equal(logits[0], logits[1]):
        raise AssertionError("float32 engine logits through K5 differ from "
                             "those through the plain version: max diff "
                             f"{np.abs(logits[0] - logits[1]).max():.3e}")
    print(f"# float32 engine (K5 serving policy): first-step logits through "
          f"K5 ({used[0]} launches) and through the plain version bitwise "
          "equal", flush=True)


# --------------------------------------------------------------------------- #
# K2 and K3: the quantized matmuls of the training path
# --------------------------------------------------------------------------- #
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12   # H100 SXM fp8 and int8 tensor cores, dense
# One transformer layer's seven quantized matmuls at qwen2-0.5b widths:
# (K, N) -> how many of the layer's matmuls have that shape (wq/wo, wk/wv,
# w_gate/w_up, w_down).
LAYER_MATMULS = {(896, 896): 2, (896, 128): 2, (896, 4864): 2,
                 (4864, 896): 1}
MATMULS_PER_LAYER = 7      # STE matmuls per layer (the tied unembed is not)
SMOKE_M = 1024             # batch 8 x seq 128 tokens
# Instruction rates of the data sheet's card (132 SMs at 1.98 GHz): the
# 67 TFLOP/s float32 rate is 128 FMA lanes per SM, an FMA counted as two
# operations, so an SM issues at most 128 thread-instructions per clock;
# 32-bit integer add, multiply-add, shift, compare and logic run on 64
# lanes per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0).
ISSUE_PER_S = F32_FLOP_PER_S / 2
INT32_PER_S = F32_FLOP_PER_S / 4
SM_CLOCK_HZ = 1.98e9       # the data sheet's boost clock
SHARED_LANES_PER_CLOCK = 32  # one 32-bank wavefront per SM a clock
INT32_OPCODES = {"IADD3", "IADD", "VIADD", "IMAD", "LOP3", "SHF", "ISETP",
                 "LEA", "IMNMX", "VIMNMX", "IABS"}


_SASS = {}   # library path -> its functions' SASS: one cuobjdump each


def _sass_functions(lib) -> dict:
    """Each function's SASS in the built library ``lib`` (``cuobjdump``,
    once a library), by mangled name."""
    import re
    import shutil
    from repro_torch.kernels import cuda_build

    if str(lib) not in _SASS:
        tool = shutil.which("cuobjdump") or os.path.join(
            os.path.dirname(cuda_build._nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        _SASS[str(lib)] = {f.split(None, 1)[0]: f for f in
                           re.split(r"\n\s*Function : ", sass)[1:]}
    return _SASS[str(lib)]


def sass_loop_mix(lib, kernel: str, per: str) -> dict:
    """Instructions per product in ``kernel``'s innermost loop that holds
    the instruction ``per`` (one per product: K3's float add of each
    product; an opcode such as ``FADD``, or a full mnemonic such as
    ``STG.E.128``): all of them, and those of the 32-bit integer pipe.
    Read from the SASS of the built library (``cuobjdump``);
    uniform-datapath (U*) instructions run on another pipe and are not
    counted."""
    import collections
    import re

    (body,) = [f for name, f in _sass_functions(lib).items()
               if kernel in name]
    ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", b.strip()).split()[0])
           for a, b in re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*);", body)]
    targets = re.findall(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?BRA\s+"
                         r"0x([0-9a-f]+)", body)
    loops = sorted(((int(t, 16), int(a, 16)) for a, t in targets
                    if int(t, 16) <= int(a, 16)), key=lambda lh: lh[1] - lh[0])
    for lo, hi in loops:
        body_ins = [m for a, m in ins if lo <= a <= hi]
        ops = collections.Counter(m.split(".")[0] for m in body_ins)
        n = sum(m == per or m.split(".")[0] == per for m in body_ins)
        if n:
            total = sum(c for op, c in ops.items() if not op.startswith("U"))
            return dict(per_product=total / n,
                        int32_per_product=sum(ops[o] for o in INT32_OPCODES)
                        / n, mix={op: c / n for op, c in ops.most_common()})
    raise AssertionError(f"no loop with {per} in the SASS of {kernel}")


def sass_opcode_counts(lib, kernel: str, opcode: str) -> dict:
    """How many ``opcode`` instructions (``HMMA``: the tensor cores'
    warp-level product) the SASS of each function of the built library
    ``lib`` whose name contains ``kernel`` holds (``cuobjdump``)."""
    import re

    return {name: sum(
        re.sub(r"^@!?U?P\w+\s+", "", b.strip()).split()[0].split(".")[0]
        == opcode for b in re.findall(r"/\*[0-9a-f]+\*/\s+([^;]*);", f))
        for name, f in _sass_functions(lib).items() if kernel in name}


def check_tensor_cores() -> None:
    """Phase: K2 (every instantiation of ``dequant_matmul_kernel``), K3
    (of ``lns_matmul_kernel``) and K6's bf16 body (of
    ``flash_attention_bf16_kernel``) run their products on the tensor
    cores: cuobjdump finds HMMA in each."""
    from repro_torch.kernels import cuda_build

    for source, kernel in (("lns_matmul", "dequant_matmul_kernel"),
                           ("lns_matmul", "lns_matmul_kernel"),
                           ("flash_attention", "flash_attention_bf16_kernel")):
        counts = sass_opcode_counts(cuda_build.build([source])[0], kernel,
                                    "HMMA")
        if not counts or not all(counts.values()):
            raise AssertionError(f"no HMMA in the SASS of {kernel}: {counts}")
        print(f"# SASS: HMMA in all {len(counts)} instantiations of {kernel} "
              f"({source}.cu): " + ", ".join(str(c) for c in counts.values()),
              flush=True)


def _nan_aware_bitwise(a, b) -> bool:
    """Equal bit patterns, except that any NaN equals any NaN (the card's
    float add returns its canonical NaN, the CPU keeps the operand's)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    keep = ~na
    return torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def check_k3_products(dev) -> int:
    """Phase: every product of the paper's LNS multiply through K3, per
    format and mode: codes [256, 1] x [1, 256] against the plain version,
    bit for bit.  Returns the number of products checked."""
    import torch
    from repro_torch.core.carry_ins import FACTORED_MUL
    from repro_torch.kernels import lns_matmul as lm

    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    x, w = codes[:, None].contiguous(), codes[None, :].contiguous()
    n = 0
    for fmt, mode in sorted(FACTORED_MUL):
        got = lm.lns_product_matmul(x, w, fmt=fmt, mode=mode)
        want = lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
        torch.cuda.synchronize()
        if not _nan_aware_bitwise(got, want):
            raise AssertionError(f"K3 products differ from the plain "
                                 f"version for {fmt}/{mode}")
        n += got.numel()
    print(f"# K3 products: {n} = {len(FACTORED_MUL)} (format, mode) pairs "
          "x 65536, bitwise equal to the plain version (NaN as NaN)",
          flush=True)
    return n


def _n_sm(dev) -> int:
    import torch

    return torch.cuda.get_device_properties(dev).multi_processor_count


def _layer_codes(dev, seed: int, act_fmt: str, w_fmt: str):
    """FP8 codes of the slice's matmul operands: activations [M, K] and
    weights [K, N] for each shape of LAYER_MATMULS, quantized as the STE
    matmul quantizes them (per-tensor / per-output-channel scales)."""
    import torch
    from repro_torch.core.quant import quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for K, N in LAYER_MATMULS:
        x = torch.randn((SMOKE_M, K), generator=g, device=dev)
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        out[K, N] = (quantize(x, act_fmt).codes,
                     quantize(w, w_fmt, axis=-1).codes)
    return out


def _sum_bound(K, absum):
    """Float32 summation error bound of a K-term sum: 2 K 2^-24 sum|p|."""
    return 2 * K * 2.0 ** -24 * absum


def lns_function_bound() -> dict:
    """The least time of one layer's seven LNS matmuls at M = SMOKE_M
    (K3's function, which K4 computes too), whatever implements them: the
    larger of the bytes they must move (codes in, float32 out) over the
    memory rate and their operations (a multiply and an add of two 8-bit
    operands per product) over the card's fastest dense 8-bit rate."""
    prods = sum(c * SMOKE_M * K * N for (K, N), c in LAYER_MATMULS.items())
    nbytes = sum(c * (SMOKE_M * K + K * N + 4 * SMOKE_M * N)
                 for (K, N), c in LAYER_MATMULS.items())
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 2 * prods / INT8_OPS_PER_S * 1e3
    return dict(ms=max(b_bytes, b_ops), prods=prods, nbytes=nbytes,
                bytes_ms=b_bytes, ops_ms=b_ops,
                bound_by="bytes" if b_bytes >= b_ops else "operations")


def _per_layer_ms(fn_of_shape, only, iters, warmup=2):
    """Card time of one layer's seven matmuls: per-shape card time of
    ``fn_of_shape(shape)`` times each shape's count in LAYER_MATMULS."""
    total, hows = 0.0, []
    for shape, count in LAYER_MATMULS.items():
        ms, how = device_ms(lambda: fn_of_shape(shape), iters=iters,
                            only=only, warmup=warmup)
        total += count * ms
        hows.append(how)
    return total, " / ".join(sorted(set(hows)))


def check_matmul_kernels(dev) -> dict:
    """Phase: K3 (e4m3 RNE, and e5m2 RU) and K2 against their plain
    versions at the training path's shapes (M = 1024, every (K, N) of a
    qwen2-0.5b layer), then their timings per layer (the seven matmuls of
    one layer's forward) beside the bounds."""
    import torch
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.kernels.common import code_to_f32, lns_plane_tables

    res = {}
    # K3: e4m3 x e4m3, RNE carry-in (--quant fp8_lns_pallas); then e5m2
    # RU, whose carry-in reads the signs (8 planes: mantissa and sign)
    k3_codes = _layer_codes(dev, 10, "e4m3", "e4m3")
    err = {}
    for fmt, mode, cases in (
            ("e4m3", "rne", k3_codes),
            ("e5m2", "ru", _layer_codes(dev, 12, "e5m2", "e5m2"))):
        for (K, N), (x, w) in cases.items():
            got = lm.lns_product_matmul(x, w, fmt=fmt, mode=mode)
            want = lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
            absum = lm.lns_matmul_plain(x & 0x7F, w & 0x7F, fmt=fmt,
                                        mode=mode)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if not torch.isfinite(got).all() or bool(
                    (diff > _sum_bound(K, absum)).any()):
                raise AssertionError(f"K3 differs from its plain version at "
                                     f"{SMOKE_M}x{K}x{N} ({fmt} {mode})")
            err[fmt, mode] = max(err.get((fmt, mode), 0.0),
                                 float(diff.max()))
            print(f"# K3 {fmt} {mode} {SMOKE_M}x{K}x{N} (tile "
                  f"{lm.lns_tile(SMOKE_M, N, _n_sm(dev))}) vs plain: max "
                  f"|err| {float(diff.max()):.3e} within 2 K 2^-24 "
                  f"sum|products| (max bound "
                  f"{float(_sum_bound(K, absum).max()):.3e})", flush=True)
    res["k3_err"] = err["e4m3", "rne"]     # the training path's cell
    # K2: e5m2 activations x e4m3 weights (train_fp8), bf16 and f32 compute
    k2_codes = _layer_codes(dev, 11, "e5m2", "e4m3")
    err = 0.0
    for cd in (torch.bfloat16, torch.float32):
        for (K, N), (x, w) in k2_codes.items():
            kw = dict(fmt="e5m2", w_fmt="e4m3", compute_dtype=cd)
            got = lm.dequant_matmul(x, w, **kw)
            want = lm.dequant_matmul_plain(x, w, **kw)
            absum = lm.dequant_matmul_plain(x & 0x7F, w & 0x7F, **kw)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if not torch.isfinite(got).all() or bool(
                    (diff > _sum_bound(K, absum)).any()):
                raise AssertionError(f"K2 differs from its plain version at "
                                     f"{SMOKE_M}x{K}x{N} ({cd})")
            err = max(err, float(diff.max()))
        print(f"# K2 {cd} vs plain, all four shapes: max |err| {err:.3e} "
              "within 2 K 2^-24 sum|products|", flush=True)
    res["k2_err"] = err

    # timings: one layer's seven matmuls at M = 1024
    def k3(shape):
        return lm.lns_product_matmul(*k3_codes[shape], fmt="e4m3", mode="rne")

    def k3_plain(shape):
        return lm.lns_matmul_plain(*k3_codes[shape], fmt="e4m3", mode="rne")

    def k2(shape):
        return lm.dequant_matmul(*k2_codes[shape], fmt="e5m2", w_fmt="e4m3",
                                 compute_dtype=torch.bfloat16)

    def k2_plain(shape):
        return lm.dequant_matmul_plain(*k2_codes[shape], fmt="e5m2",
                                       w_fmt="e4m3",
                                       compute_dtype=torch.bfloat16)

    decoded = {s: (code_to_f32(x, "e5m2").to(torch.bfloat16),
                   code_to_f32(w, "e4m3").to(torch.bfloat16))
               for s, (x, w) in k2_codes.items()}

    def k2_library(shape):
        return torch.matmul(*decoded[shape])

    # K3's GEMM shape as one bf16 product, [M, R K] x [R K, N]: its planes
    # expanded beforehand (a yardstick of the shape, not of the function)
    pt = lns_plane_tables("e4m3", "rne")
    B = pt.B.to(dev)
    A = pt.A.to(dev).to(torch.bfloat16)
    cls = pt.cls.to(dev)

    def planes(shape):
        x, w = k3_codes[shape]
        xi, wi = x.long(), w.long()
        xp = torch.zeros((SMOKE_M, shape[0], pt.R), dtype=torch.bfloat16,
                         device=dev)
        xp.scatter_(2, cls[xi][..., None], A[xi][..., None])
        return (xp.reshape(SMOKE_M, -1),
                B[:, wi].permute(1, 0, 2).reshape(-1, shape[1]))

    expanded = {s: planes(s) for s in LAYER_MATMULS}

    def k3_yardstick(shape):
        return torch.matmul(*expanded[shape])

    res["k3_ms"], how = _per_layer_ms(k3, "lns_matmul_kernel", iters=20)
    res["k3_plain_ms"], _ = _per_layer_ms(k3_plain, "", iters=1, warmup=1)
    yard_ms, _ = _per_layer_ms(k3_yardstick, "", iters=20)
    k3_shape = {(K, N): device_ms(lambda: k3((K, N)), iters=20,
                                  only="lns_matmul_kernel")[0]
                for K, N in LAYER_MATMULS}
    print(f"# K3 per shape (e4m3 RNE, R = {pt.R} planes, card time): "
          + ", ".join(
              f"{SMOKE_M}x{K}x{N} tile {lm.lns_tile(SMOKE_M, N, _n_sm(dev))}"
              f" {ms:.4f} ms = {2 * SMOKE_M * K * N / ms / 1e9:.1f} TFLOP/s "
              f"of the function, {pt.R * 2 * SMOKE_M * K * N / ms / 1e9:.1f}"
              " of planes" for (K, N), ms in k3_shape.items()), flush=True)
    res["k2_ms"], _ = _per_layer_ms(k2, "dequant_matmul_kernel", iters=20)
    res["k2_plain_ms"], _ = _per_layer_ms(k2_plain, "", iters=10)
    res["k2_library_ms"], _ = _per_layer_ms(k2_library, "", iters=50)
    per_shape = {(K, N): device_ms(lambda: k2((K, N)), iters=20,
                                   only="dequant_matmul_kernel")[0]
                 for K, N in LAYER_MATMULS}
    print("# K2 per shape (bf16 compute, card time): " + ", ".join(
        f"{SMOKE_M}x{K}x{N} {ms:.4f} ms = "
        f"{2 * SMOKE_M * K * N / ms / 1e9:.1f} TFLOP/s"
        for (K, N), ms in per_shape.items()), flush=True)

    # least time of one layer's seven matmuls
    fb = lns_function_bound()
    prods, nbytes, b_bytes = fb["prods"], fb["nbytes"], fb["bytes_ms"]
    # beside K3's bound, never as it: the integer route's floor (two issue
    # slots per product) and the plane GEMM's dense bf16 time
    b_int = 2 * prods / ISSUE_PER_S * 1e3
    b_planes = pt.R * 2 * prods / BF16_FLOP_PER_S * 1e3
    # K2: a multiply-add per product at the bf16 tensor-core rate
    b_k2 = 2 * prods / BF16_FLOP_PER_S * 1e3
    res["k3_bound"] = fb["ms"]
    res["k3_bound_by"] = fb["bound_by"]
    res["k2_bound"] = max(b_bytes, b_k2)
    res["k2_bound_by"] = "bytes" if b_bytes >= b_k2 else "operations"
    print(f"# K3 per layer (7 matmuls, M={SMOKE_M}; card time, {how}): "
          f"kernel {res['k3_ms']:.4f} ms = "
          f"{2 * prods / res['k3_ms'] / 1e9:.1f} TFLOP/s of the function, "
          f"{pt.R * 2 * prods / res['k3_ms'] / 1e9:.1f} of planes; plain "
          f"{res['k3_plain_ms']:.3f} ms; bound {res['k3_bound']:.5f} ms = "
          f"max({nbytes} B / 3.35 TB/s = {b_bytes:.5f} ms, {2 * prods} "
          f"operations / 1979 TOP/s = {fb['ops_ms']:.5f} ms) -> "
          f"{res['k3_bound_by']} (kernel / bound "
          f"{res['k3_ms'] / res['k3_bound']:.2f}); beside it: the integer "
          f"route's floor {b_int:.4f} ms (2 issue slots per product at "
          f"{ISSUE_PER_S:.4g}/s), the plane GEMM's dense bf16 time "
          f"{b_planes:.4f} ms ({pt.R} x {2 * prods} FLOP / 989 TFLOP/s); "
          f"yardstick (not K3's library time): bf16 torch.matmul "
          f"[M, {pt.R} K] x [{pt.R} K, N] {yard_ms:.4f} ms", flush=True)
    print(f"# K2 per layer (7 matmuls, M={SMOKE_M}, bf16 compute): kernel "
          f"{res['k2_ms']:.4f} ms = {2 * prods / res['k2_ms'] / 1e9:.1f} "
          f"TFLOP/s; plain {res['k2_plain_ms']:.4f} ms; "
          f"torch.matmul on pre-decoded bf16 {res['k2_library_ms']:.4f} ms; "
          f"bound {res['k2_bound']:.4f} ms = max({nbytes} B / 3.35 TB/s, "
          f"{2 * prods} FLOP / 989 TFLOP/s)", flush=True)
    return res


def _reset_matmul_counts():
    from repro_torch.kernels import lns_matmul as lm

    lm.lns_product_matmul.launches = 0
    lm.dequant_matmul.launches = 0


def _matmul_counts():
    from repro_torch.kernels import lns_matmul as lm

    return lm.lns_product_matmul.launches, lm.dequant_matmul.launches


def train_main_path(dev) -> dict:
    """Phase: the training main path, full-width qwen2-0.5b under
    ``--quant fp8_lns_pallas`` through the port's CLI: 6 steps of batch
    8 x seq 128, checkpoints every 3 steps.  Every STE matmul runs K3 once
    forward and once in the checkpointed recompute of its layer."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config("qwen2-0.5b", quant="fp8_lns_pallas")
    n_steps = 6
    want = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        _reset_matmul_counts()
        t0 = time.perf_counter()
        history = train.main([
            "--arch", "qwen2-0.5b", "--quant", "fp8_lns_pallas",
            "--batch", "8", "--seq", "128", "--steps", str(n_steps),
            "--data", "arith", "--ckpt-every", "3", "--ckpt-dir", tmp,
            "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3, k2 = _matmul_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in history]
    if [h["step"] for h in history] != [3, 6]:
        raise AssertionError(f"unexpected log points {history}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if history[-1]["restarts"] != 0:
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if k3 != want or k2 != 0:
        raise AssertionError(f"K3 launches {k3} (want 2 x 7 x "
                             f"{cfg.n_layers} layers x {n_steps} steps = "
                             f"{want}), K2 launches {k2} (want 0)")
    print(f"# train fp8_lns_pallas: {n_steps} full-width steps, losses "
          f"{losses} at steps 3 and 6, 0 restarts, {k3} K3 launches = 2 x 7 "
          f"x {cfg.n_layers} x {n_steps}, 0 K2; {wall:.2f} s wall "
          f"({wall / n_steps:.3f} s per step, init and checkpoints "
          "included)", flush=True)
    return dict(launches=k3)


def _train_setup(dev, cfg, seed: int = 0, batch: int = 8, seq: int = 128):
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    model = Model(cfg, max_seq=seq)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = steps.make_train_state(model, gen)
    step = steps.build_train_step(model, adamw.OptConfig(
        lr=1e-3, warmup_steps=10, total_steps=100))
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=batch, seed=seed, kind="arith"))

    def batch_of(i):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in data.batch(i).items()}

    return state, step, batch_of


def train_k2_path(dev) -> dict:
    """Phase: 3 full-width train steps under policy train_fp8 (e5m2
    activations x e4m3 weights, impl auto -> fused_dequant on the card):
    K2 once forward and once in the recompute of every STE matmul."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-0.5b", policy="train_fp8")
    state, step, batch_of = _train_setup(dev, cfg)
    n_steps = 3
    want = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    torch.cuda.synchronize()
    _reset_matmul_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, metrics = step(state, batch_of(i))
        losses.append(float(metrics["loss"]))
    wall = time.perf_counter() - t0
    k3, k2 = _matmul_counts()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train_fp8 loss {losses}")
    if k2 != want or k3 != 0:
        raise AssertionError(f"K2 launches {k2} (want {want}), K3 {k3}")
    print(f"# train train_fp8: {n_steps} full-width steps, losses {losses}, "
          f"{k2} K2 launches = 2 x 7 x {cfg.n_layers} x {n_steps}, 0 K3; "
          f"{wall / n_steps:.3f} s per step", flush=True)
    return dict(launches=k2)


def train_k5_path(dev) -> dict:
    """Phase: 2 full-width train steps (batch 8 x seq 128, ``arith``)
    under train_fp8_lns with the gate product through K5 in e4m3, through
    ``run_training``: K3 once forward and once in the recompute of every
    STE matmul, K5 once forward and once in the recompute of every
    layer's gate (K5 has no backward kernel: the codes carry no gradient)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.kernels import fp8_elementwise as fe
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault, steps

    cfg = get_config("qwen2-0.5b", policy=k5_train_policy())
    n_steps = 2
    want_k3 = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    want_k5 = 2 * cfg.n_layers * n_steps
    model = Model(cfg, max_seq=128)
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                              seed=0, kind="arith"))

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps.make_train_state(model, gen)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_k5_")
    try:
        torch.cuda.synchronize()
        _reset_matmul_counts()
        fe.fp8_elementwise.launches = 0
        t0 = time.perf_counter()
        _, history = fault.run_training(
            train_step=steps.build_train_step(model, adamw.OptConfig(
                lr=1e-3, warmup_steps=10, total_steps=100)),
            init_state=init_state, dataset=data, max_steps=n_steps,
            ckpt_dir=tmp, ckpt_every=n_steps,
            to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()},
            log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (k3, k2), k5 = _matmul_counts(), fe.fp8_elementwise.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if history[-1]["restarts"] != 0:
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if (k3, k2, k5) != (want_k3, 0, want_k5):
        raise AssertionError(f"launches K3 {k3} (want {want_k3}), K2 {k2} "
                             f"(want 0), K5 {k5} (want {want_k5})")
    print(f"# train train_fp8_lns + K5 gate (e4m3): {n_steps} full-width "
          f"steps, loss {losses} at step {n_steps}, 0 restarts, {k3} K3 "
          f"launches = 2 x 7 x {cfg.n_layers} x {n_steps}, {k5} K5 launches "
          f"= 2 x {cfg.n_layers} x {n_steps}; {wall:.2f} s wall (init and a "
          "checkpoint included)", flush=True)
    return dict(launches=k5)


def check_train_k5_against_plain(dev) -> None:
    """Phase: the first step's loss and gradient global norm of a float32,
    2-layer, full-width qwen2-0.5b under the K5 training policy, with the
    gate product through K5 (impl "auto") and through the plain version
    (impl "ref"); K3 runs in both.  Tolerance: loss rtol 1e-4, gradient
    norm rtol 1e-3, as for K2/K3 (the codes are equal; the float32 sums
    around them run on the card in the same order, so the two agree far
    inside it)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fp8_elementwise as fe

    pol = k5_train_policy()
    out = []
    for impl in ("auto", "ref"):
        p = pol.replace(elementwise=pol.elementwise.replace(impl=impl))
        cfg = dataclasses.replace(get_config("qwen2-0.5b", policy=p),
                                  n_layers=2, param_dtype="float32")
        state, step, batch_of = _train_setup(dev, cfg, seed=5)
        before = fe.fp8_elementwise.launches
        _, metrics = step(state, batch_of(0))
        torch.cuda.synchronize()
        used = fe.fp8_elementwise.launches - before
        if used != (2 * cfg.n_layers if impl == "auto" else 0):
            raise AssertionError(f"K5 launches {used} with impl={impl}")
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    (lk, gk), (lp, gp) = out
    if not (math.isclose(lk, lp, rel_tol=1e-4)
            and math.isclose(gk, gp, rel_tol=1e-3)):
        raise AssertionError(f"K5: kernel {out[0]} vs plain {out[1]}")
    print(f"# K5 train_fp8_lns, 2 layers float32, first step: loss "
          f"{lk:.7f} (K5) vs {lp:.7f} (plain), grad norm {gk:.6f} vs "
          f"{gp:.6f}", flush=True)


def profile_train_step(dev, policy=None, depth=None,
                       arch="qwen2-0.5b") -> None:
    """One profiled full-width train step of ``arch`` (after a warm-up
    step) under ``--quant fp8_lns_pallas``, or under ``policy``, of the
    first ``depth`` layers when given: wall time, card-busy share,
    launches, the kernels that take the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config

    if policy is None:
        cfg, label = get_config(arch, quant="fp8_lns_pallas"), \
            "fp8_lns_pallas"
    else:
        cfg = get_config(arch, policy=policy)
        label = policy.name + (" + K5 gate" if policy.elementwise.quantized
                               else "")
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    state, step, batch_of = _train_setup(dev, cfg)
    state, _ = step(state, batch_of(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch_of(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e6
    if busy <= 0:
        print(f"# profiled train step: {wall:.4f} s wall; the profiler "
              "recorded no device time (busy share not measured)", flush=True)
        return
    k3 = sum(us for k, us, _ in rows if "lns_matmul_kernel" in k) / 1e6
    k2 = sum(us for k, us, _ in rows if "dequant_matmul_kernel" in k) / 1e6
    k5 = sum(us for k, us, _ in rows if "fp8_elementwise_kernel" in k) / 1e6
    print(f"# profiled train step ({arch} {label}, full width, depth "
          f"{cfg.n_layers}, batch 8 x seq 128): {wall:.4f} s wall; card busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}% of the wall); K3 {k3:.4f} s "
          f"({100 * k3 / busy:.2f}% of busy); K2 {k2:.4f} s "
          f"({100 * k2 / busy:.2f}%); K5 {k5:.5f} s; "
          f"{sum(n for _, _, n in rows)} kernel launches", flush=True)
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"#   {us / 1e3:10.3f} ms  x{n:<6d} {key[:90]}", flush=True)
    del state, step
    torch.cuda.empty_cache()


class _plain_matmuls:
    """Within the block, the K2/K3 wrappers run their plain versions on
    the card (for the end-to-end comparison only; the package itself
    never does this)."""

    def __enter__(self):
        from repro_torch.kernels import lns_matmul as lm

        self.saved = (lm.lns_product_matmul, lm.dequant_matmul,
                      lm.lns_loop_matmul)
        lm.lns_product_matmul = lambda x, w, *, fmt, mode="rne": \
            lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
        lm.dequant_matmul = lambda x, w, **kw: lm.dequant_matmul_plain(x, w,
                                                                       **kw)
        lm.lns_loop_matmul = lambda x, w, *, fmt, mode="rne": \
            lm.lns_loop_matmul_plain(x, w, fmt=fmt, mode=mode)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import lns_matmul as lm

        (lm.lns_product_matmul, lm.dequant_matmul,
         lm.lns_loop_matmul) = self.saved
        return False


def check_train_against_plain(dev) -> None:
    """Phase: the first step's loss and gradient global norm of a
    float32, 2-layer, full-width qwen2-0.5b, through the kernels and
    through their plain versions, for K3 (fp8_lns_pallas) and K2
    (train_fp8).  Tolerance: loss rtol 1e-4, gradient norm rtol 1e-3 --
    the float32 sums run in other orders, and a last-bit difference can
    move an activation code across a rounding boundary."""
    import torch
    from repro_torch.configs import get_config

    for label, kw in (("K3 fp8_lns_pallas", dict(quant="fp8_lns_pallas")),
                      ("K2 train_fp8", dict(policy="train_fp8"))):
        cfg = dataclasses.replace(get_config("qwen2-0.5b", **kw),
                                  n_layers=2, param_dtype="float32")
        out = []
        for plain in (False, True):
            state, step, batch_of = _train_setup(dev, cfg, seed=5)
            before = _matmul_counts()
            if plain:
                with _plain_matmuls():
                    _, metrics = step(state, batch_of(0))
            else:
                _, metrics = step(state, batch_of(0))
            torch.cuda.synchronize()
            used = [a - b for a, b in zip(_matmul_counts(), before)]
            if (sum(used) == 0) != plain:
                raise AssertionError(f"{label}: kernel launches {used} with "
                                     f"plain={plain}")
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        (lk, gk), (lp, gp) = out
        if not (math.isclose(lk, lp, rel_tol=1e-4)
                and math.isclose(gk, gp, rel_tol=1e-3)):
            raise AssertionError(f"{label}: kernels {out[0]} vs plain "
                                 f"{out[1]}")
        print(f"# {label}, 2 layers float32, first step: loss {lk:.7f} "
              f"(kernels) vs {lp:.7f} (plain), grad norm {gk:.6f} vs "
              f"{gp:.6f}", flush=True)


# --------------------------------------------------------------------------- #
# K6: flash attention, through its entry point and the autotuner
# --------------------------------------------------------------------------- #
# Attention geometries of the repo's models at full width (only these are
# used; the configurations themselves are not ported):
# (label, B, S, H, KV, hd, dv, causal, window, cap), each run in float32
# and in bfloat16
K6_GEOMETRIES = (
    ("qwen2-0.5b", 8, 128, 14, 2, 64, 64, True, 0, 0.0),
    ("qwen2-0.5b", 1, 8192, 14, 2, 64, 64, True, 0, 0.0),
    ("gemma2-27b", 1, 8192, 32, 16, 128, 128, True, 4096, 50.0),
    ("gemma3-12b", 1, 4096, 16, 8, 256, 256, True, 1024, 0.0),
    ("deepseek-v2-lite", 1, 4096, 16, 16, 192, 128, True, 0, 0.0),
)
# bfloat16 outputs: at most one bf16 ulp apart, or at most this far where
# an output lies so close to 0 that a bf16 ulp is finer than the float32
# gap of two summation orders (a float32 max |err| of 4.8e-7 at full
# width on the H100)
K6_BF16_NEAR_ZERO = 1e-5
K6_TIMED = (1, 8192, 14, 2, 64, 64)   # qwen2-0.5b: B, S, H, KV, hd, dv
# The CPU tests' cases at bq = bk = 32:
# (B, Sq, Sk, H, KV, hd, dv, causal, window, cap)
K6_SMALL = (
    (1, 128, 128, 4, 4, 32, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0),
    (1, 128, 128, 2, 1, 64, 64, True, 32, 0.0),
    (1, 64, 64, 2, 2, 32, 32, True, 0, 30.0),
    (2, 96, 96, 4, 2, 32, 32, True, 0, 0.0),
    (1, 64, 128, 2, 2, 32, 32, False, 0, 0.0),
    (2, 64, 64, 4, 2, 48, 32, True, 0, 0.0),
    (2, 37, 37, 4, 2, 32, 32, True, 0, 0.0),
    (1, 96, 30, 2, 1, 16, 16, False, 16, 0.0),   # rows without a key
)


def _k6_qkv(dev, B, Sq, Sk, H, KV, hd, dv, dtype, seed=0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, dv))]


def _bf16_ulps(a, b):
    """Distance in bf16 ulps of two bfloat16 tensors (+0 == -0)."""
    import torch

    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


def _k6_compare(got, want, what) -> float:
    """K6 against its plain version: float32 at rtol = atol = 1e-4;
    bfloat16 at most one bf16 ulp apart, or at most ``K6_BF16_NEAR_ZERO``
    apart (printed when any output needs it).  Returns the max
    |difference|."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"K6 {what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K6 {what}: non-finite output")
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        over = _bf16_ulps(got, want) > 1
        if bool(over.any()):
            d, val = diff[over], want.float().abs()[over]
            print(f"# K6 {what}: {int(over.sum())} of {got.numel()} bf16 "
                  f"outputs more than one ulp apart, max |diff| "
                  f"{float(d.max()):.3g} at |value| up to "
                  f"{float(val.max()):.3g}", flush=True)
            if float(d.max()) > K6_BF16_NEAR_ZERO:
                raise AssertionError(f"K6 {what}: bf16 outputs more than "
                                     "one ulp and more than "
                                     f"{K6_BF16_NEAR_ZERO} apart")
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=f"K6 {what}")
    return float(diff.max())


def check_k6(dev) -> dict:
    """Phase: K6 against its plain version on the card: the CPU tests'
    cases (float32 and bfloat16), the rows without an admissible key,
    every candidate tiling of ``flash_blocks``, and the attention
    geometries of the repo's models at full width (qwen2-0.5b also
    against the port's ``chunked_attention``), each in float32 and in
    bfloat16.  All at pinned tilings: these launches are comparisons,
    not K6's path.  Returns the max |kernel - plain| over all of them;
    the float32 comparisons' own maximum is printed."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    err = err32 = 0.0     # max |kernel - plain|: all; float32 only
    for i, (B, Sq, Sk, H, KV, hd, dv, causal, window, cap) in \
            enumerate(K6_SMALL):
        kw = dict(causal=causal, window=window, cap=cap)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _k6_qkv(dev, B, Sq, Sk, H, KV, hd, dv, dtype, seed=i)
            got = fa.flash_attention(q, k, v, bq=32, bk=32, **kw)
            bq, bk = fa.clamp_blocks(Sq, Sk, 32, 32)
            want = fa.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
            e = _k6_compare(got, want, f"case {i} {dtype}")
            err = max(err, e)
            if dtype == torch.float32:
                err32 = max(err32, e)
                if Sk == 30:   # the corner: sum(v) / 32 from row 47 on
                    corner = (v[0, :, 0].sum(0) / 32).expand(Sq - 47, dv)
                    torch.testing.assert_close(got[0, 47:, 0], corner,
                                               rtol=1e-5, atol=1e-6)
    print(f"# K6 vs plain, the {len(K6_SMALL)} CPU-test cases at bq = bk = 32 "
          "(float32 and bfloat16): within tolerance; rows without an "
          "admissible key = sum(v) / padded key length", flush=True)

    q, k, v = _k6_qkv(dev, 1, 600, 600, 14, 2, 64, 64, torch.float32)
    for bq in (64, 128, 256):
        for bk in (64, 128, 256):
            got = fa.flash_attention(q, k, v, bq=bq, bk=bk)
            want = fa.flash_attention_plain(q, k, v, causal=True, bq=bq,
                                            bk=bk)
            e = _k6_compare(got, want, f"tiling {bq}x{bk}")
            err, err32 = max(err, e), max(err32, e)
    print("# K6 vs plain, every flash_blocks candidate tiling (bq, bk in "
          "64/128/256) at 1 x 600 x 14 heads: within tolerance", flush=True)

    for i, (label, B, S, H, KV, hd, dv, causal, window, cap) in \
            enumerate(K6_GEOMETRIES):
        kw = dict(causal=causal, window=window, cap=cap, bq=128, bk=128)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _k6_qkv(dev, B, S, S, H, KV, hd, dv, dtype, seed=S)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            what = f"{label} B{B} S{S} {str(dtype)[6:]}"
            e = _k6_compare(got, want, what)
            err = max(err, e)
            if dtype == torch.float32:
                err32 = max(err32, e)
            if dtype == torch.float32 and i == 0:
                chunked = layers.chunked_attention(q, k, v, causal=causal,
                                                   window=window, cap=cap)
                _k6_compare(got, chunked, f"{label} vs chunked_attention")
            print(f"# K6 {label} (H {H}, KV {KV}, hd {hd}, dv {dv}, window "
                  f"{window}, cap {cap:g}) B {B} x S {S} {str(dtype)[6:]}, "
                  f"tiling 128 x 128: max |diff| {e:.3g}, within tolerance "
                  "of the plain version"
                  + (" and of chunked_attention"
                     if dtype == torch.float32 and i == 0 else ""),
                  flush=True)
            del q, k, v, got, want
    print(f"# K6 max |kernel - plain|: {err32:.3g} over the float32 "
          f"comparisons, {err:.3g} over all", flush=True)
    return dict(max_abs_err=err)


def _k6_pairs(B, S, H, causal, window, bq, bk):
    """(admissible (query, key) pairs, pairs in the key tiles K6 visits) of
    self-attention over S tokens: the kernel takes the query rows 64 at a
    time and visits ``key_tile_range``'s tiles for each group."""
    from repro_torch.kernels import flash_attention as fa

    if not causal:
        admissible = S * (min(S, window) if window else S)
    elif window:
        w = min(window, S)
        admissible = w * (w + 1) // 2 + (S - w) * w
    else:
        admissible = S * (S + 1) // 2
    nk = -(-S // bk)
    visited = 0
    for q0 in range(0, -(-S // bq) * bq, bq):
        for g0 in range(q0, q0 + bq, 64):
            rows = min(64, q0 + bq - g0)
            first, last = fa.key_tile_range(g0, rows, S, S, bk, nk, causal,
                                            window)
            visited += (last - first) * bk * 64
    return B * H * admissible, B * H * visited


def time_k6(dev) -> dict:
    """Phase: K6 times at qwen2-0.5b B 1 x S 8192 in bfloat16 (tiling
    128 x 128): the kernel alone (CUDA-graph replays), the wrapper call
    between CUDA events, the plain
    version, the bound, and as a yardstick ``scaled_dot_product_attention``
    on the same tensors in its own layout (transposes outside the timing;
    the port never calls it).  Then the same geometry in float32 (the
    CUDA-core body) and gemma2-27b's windowed, soft-capped geometry in
    bfloat16, each with its rate on the admissible FLOP and the FLOP of
    the tiles the kernel visits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    B, S, H, KV, hd, dv = K6_TIMED
    q, k, v = _k6_qkv(dev, B, S, S, H, KV, hd, dv, torch.bfloat16, seed=1)
    kw = dict(causal=True, bq=128, bk=128)
    k6 = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    # one kernel per call: CUDA-graph replays time it without the host
    # (the profiler has under-reported late in this process)
    ms = graph_ms(k6, launches=20, replays=5)
    call_ms = cuda_ms(k6, iters=10)
    plain_ms, _ = device_ms(plain, iters=3, warmup=1)
    pairs, visited = _k6_pairs(B, S, H, True, 0, 128, 128)
    flops = 2 * (hd + dv) * pairs
    computed = 2 * (hd + dv) * visited
    nbytes = 2 * (B * S * H * hd + B * S * KV * (hd + dv) + B * S * H * dv)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / BF16_FLOP_PER_S * 1e3
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    try:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_ms, _ = device_ms(sdpa, iters=20)
        lib_note = "scaled_dot_product_attention(is_causal, enable_gqa)"
    except TypeError as exc:    # a torch without enable_gqa
        lib_ms, lib_note = None, f"not measured: {exc}"
    print(f"# K6 qwen2-0.5b B {B} x S {S} bf16 causal (card time, "
          f"CUDA-graph events): kernel {ms:.4f} ms = "
          f"{flops / ms / 1e9:.1f} TFLOP/s on the admissible FLOP; wrapper "
          f"call {call_ms:.4f} ms between CUDA events, host included "
          f"({call_ms / ms:.3f}x the kernel); plain {plain_ms:.3f} ms; bound "
          f"{max(b_bytes, b_ops):.5f} ms = max({nbytes} B / 3.35 TB/s, "
          f"{flops:.4g} FLOP ({pairs} admissible pairs x 2 (hd + dv)) / 989 "
          f"TFLOP/s) -> {'bytes' if b_bytes >= b_ops else 'operations'}; "
          f"the tiles it visits hold {computed:.4g} FLOP "
          f"({computed / flops:.3f}x the admissible; the P split adds "
          f"{2 * dv * visited:.4g} more on the tensor cores); library "
          f"{lib_note}: "
          + (f"{lib_ms:.4f} ms" if lib_ms is not None else "null"),
          flush=True)
    del q, k, v, qt, kt, vt

    q, k, v = _k6_qkv(dev, B, S, S, H, KV, hd, dv, torch.float32, seed=1)
    f32_ms = graph_ms(lambda: fa.flash_attention(q, k, v, **kw),
                      launches=5, replays=2)
    print(f"# K6 qwen2-0.5b B {B} x S {S} float32 causal (CUDA-core body, "
          f"card time, CUDA-graph events): {f32_ms:.4f} ms = "
          f"{flops / f32_ms / 1e9:.2f} TFLOP/s on the admissible FLOP, "
          f"{computed / f32_ms / 1e9:.2f} on the visited tiles' (67 TFLOP/s "
          f"float32 peak)", flush=True)
    del q, k, v

    label, gB, gS, gH, gKV, ghd, gdv, causal, window, cap = K6_GEOMETRIES[2]
    q, k, v = _k6_qkv(dev, gB, gS, gS, gH, gKV, ghd, gdv, torch.bfloat16,
                      seed=1)
    gkw = dict(causal=causal, window=window, cap=cap, bq=128, bk=128)
    g_ms = graph_ms(lambda: fa.flash_attention(q, k, v, **gkw),
                    launches=10, replays=3)
    gpairs, gvisited = _k6_pairs(gB, gS, gH, causal, window, 128, 128)
    gflops = 2 * (ghd + gdv) * gpairs
    full = 2 * (ghd + gdv) * gB * gH * gS * gS
    print(f"# K6 {label} B {gB} x S {gS} bf16 (H {gH}, KV {gKV}, hd {ghd}, "
          f"window {window}, cap {cap:g}), tiling 128 x 128 (card time, "
          f"CUDA-graph events): {g_ms:.4f} ms = {gflops / g_ms / 1e9:.1f} "
          f"TFLOP/s on the "
          f"admissible {gflops:.4g} FLOP; the visited tiles hold "
          f"{2 * (ghd + gdv) * gvisited:.4g} FLOP, "
          f"{gvisited / (gB * gH * gS * gS):.3f} of every tile's "
          f"{full:.4g}; bound {gflops / BF16_FLOP_PER_S * 1e3:.5f} ms",
          flush=True)
    del q, k, v
    return dict(ms=ms, plain_ms=plain_ms,
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=lib_ms, call_ms=call_ms, f32_ms=f32_ms,
                gemma2_ms=g_ms)


def k6_autotune_path(dev) -> dict:
    """Phase: K6's path, the entry point with the autotuner behind it.
    A fresh cache file; ``flash_attention`` with no tiling at qwen2-0.5b
    geometry, S 2048, bf16: the tuner measures the candidates with K6 on
    bf16 operands (the tensor-core body the call runs), caches the
    fastest under the card's name and ``bf16`` and publishes a ``measured``
    gauge; a second call answers ``cached``, launches K6 once and equals
    a call with that tiling pinned, bit for bit.  K6's launch count is
    read over the two calls (measurement included)."""
    import tempfile

    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.telemetry import default_registry

    S, H, KV, hd = 2048, 14, 2, 64
    q, k, v = _k6_qkv(dev, 1, S, S, H, KV, hd, hd, torch.bfloat16, seed=2)
    saved = {n: os.environ.get(n) for n in ("REPRO_AUTOTUNE",
                                            "REPRO_AUTOTUNE_CACHE")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    path = os.path.join(tmp, "autotune.json")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.clear_memory_cache()
    try:
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        first = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        tuned_s = time.perf_counter() - t0
        measured = fa.flash_attention.launches
        second = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        with open(path) as f:
            cache = json.load(f)
        tail = f"{S}x{S}x{hd}x{hd}"
        key = (f"flash|torch-{dev.type}|{autotune._device_kind(dev)}|bf16|"
               f"{tail}")
        cands = [[a, b] for a in (64, 128, 256) for b in (64, 128, 256)]
        if list(cache) != [key] or cache[key] not in cands:
            raise AssertionError(f"autotune cache {cache}, want one {key} "
                                 "entry holding a candidate")
        bq, bk = cache[key]
        config = f"{bq}x{bk}"
        reg = default_registry()
        best_us = reg.gauge_value("autotune_block_us", kernel="flash",
                                  site=tail, config=config, source="measured")
        cached = reg.gauge_value("autotune_block_us", kernel="flash",
                                 site=tail, config=config, source="cached")
        if not best_us > 0 or cached != -1.0:
            raise AssertionError(f"autotune gauges: measured {best_us}, "
                                 f"cached {cached}")
        if launches != measured + 1:
            raise AssertionError(f"the cached call launched K6 "
                                 f"{launches - measured} times, want 1")
        pinned = fa.flash_attention(q, k, v, bq=bq, bk=bk)
        torch.cuda.synchronize()
        if not (torch.equal(second, pinned) and torch.equal(first, second)):
            raise AssertionError("autotuned K6 output differs from the "
                                 "pinned tiling's")
        cbq, cbk = fa.clamp_blocks(S, S, bq, bk)
        err = _k6_compare(second, fa.flash_attention_plain(
            q, k, v, causal=True, bq=cbq, bk=cbk), f"autotuned path S {S}")
    finally:
        for n, val in saved.items():
            if val is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = val
        autotune.clear_memory_cache()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"# K6 through the autotuner (qwen2-0.5b S {S} bf16, fresh cache): "
          f"measured 9 candidates in {tuned_s:.3f} s ({measured} launches), "
          f"cached {key} = {config} (best {best_us:.1f} us per call); second "
          f"call answered 'cached' with 1 launch, bitwise equal to the pinned "
          f"tiling and within tolerance of the plain version (max |diff| "
          f"{err:.3g}); {launches} K6 launches on this path", flush=True)
    return dict(launches=launches, max_abs_err=err)


# --------------------------------------------------------------------------- #
# K4: the seed LNS matmul
# --------------------------------------------------------------------------- #
def k4_train_policy():
    """train_fp8_lns with every STE matmul through K4 (impl lns_loop), as
    the reference builds such a policy: no preset, flag or --quant."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("train_fp8_lns").replace(matmul=OpPolicy(
        fmt="e4m3", mode="rne", impl="lns_loop", accum="bf16"))


def check_k4(dev, k3_layer_ms: float, k3_bound: float) -> dict:
    """Phase: K4 bitwise against its plain version (NaN as NaN) at BENCH_1's
    512 x 512 x 512 (e4m3, RNE) and at the seven matmul shapes of one
    qwen2-0.5b layer at M = 1024 (the codes K3 was timed on); then its
    card time per layer beside K3's, the plain version's (its checking
    calls, one a shape between CUDA events, host included) and the bound,
    and K4 / K3 at 512^3.  K4 computes K3's function (the same products
    and sums), so its bound is ``k3_bound``, the function's
    (:func:`lns_function_bound`) per layer.  K4's own compiled
    instructions per product (per FFMA), their time at the issue and
    integer rates, and the time of its shared loads at one a lane a clock
    are printed beside it; two calls must agree bit for bit."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import lns_matmul as lm

    g = torch.Generator(device=dev).manual_seed(14)
    x512 = torch.randint(0, 256, (512, 512), generator=g, device=dev,
                         dtype=torch.uint8)
    w512 = torch.randint(0, 256, (512, 512), generator=g, device=dev,
                         dtype=torch.uint8)
    cases = {(512, 512, 512): (x512, w512)}
    for (K, N), xw in _layer_codes(dev, 10, "e4m3", "e4m3").items():
        cases[SMOKE_M, K, N] = xw
    plain_one = {}
    for shape, (x, w) in cases.items():
        got = lm.lns_loop_matmul(x, w, fmt="e4m3", mode="rne")
        again = lm.lns_loop_matmul(x, w, fmt="e4m3", mode="rne")
        # the plain version's ~10^5 small launches a call: this one call
        # between CUDA events (the profiler's own cost is seconds)
        want, plain_one[shape[1:]] = timed_call(
            lambda: lm.lns_loop_matmul_plain(x, w, fmt="e4m3", mode="rne"))
        if not _nan_aware_bitwise(got, want):
            raise AssertionError(f"K4 differs from its plain version at "
                                 f"{shape}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"two K4 calls differ at {shape}")
    splits = {s: lm.loop_split(s[0], s[2], s[1], _n_sm(dev)) for s in cases}
    print(f"# K4 vs plain at {', '.join('x'.join(map(str, s)) for s in cases)}"
          " (e4m3, RNE; 512^3 with every code, NaN included): bitwise "
          "(NaN as NaN), two calls bitwise equal; (splits, tiles a split) "
          + ", ".join(f"{'x'.join(map(str, s))} {v}"
                      for s, v in splits.items()), flush=True)

    layer = {s[1:]: xw for s, xw in cases.items() if s[0] == SMOKE_M}

    def k4(shape):
        return lm.lns_loop_matmul(*layer[shape], fmt="e4m3", mode="rne")

    # "lns_loop_matmul": the kernel and the launch that adds split sums
    ms, how = _per_layer_ms(k4, "lns_loop_matmul", iters=10)
    plain_ms = sum(count * plain_one[shape]
                   for shape, count in LAYER_MATMULS.items())
    k4_512, _ = device_ms(lambda: lm.lns_loop_matmul(x512, w512, fmt="e4m3"),
                          iters=10, only="lns_loop_matmul")
    k3_512, _ = device_ms(lambda: lm.lns_product_matmul(x512, w512,
                                                        fmt="e4m3"),
                          iters=10, only="lns_matmul_kernel")
    fb = lns_function_bound()
    prods, nbytes = fb["prods"], fb["nbytes"]
    mix = sass_loop_mix(cuda_build.build(["lns_matmul"])[0],
                        "lns_loop_matmul_kernel", per="FFMA")
    b_issue = mix["per_product"] * prods / ISSUE_PER_S * 1e3
    b_int = mix["int32_per_product"] * prods / INT32_PER_S * 1e3
    b_own = max(b_issue, b_int)           # K4's own instruction stream
    lds = mix["mix"].get("LDS", 0.0)
    b_shared = (lds * prods / (_n_sm(dev) * SHARED_LANES_PER_CLOCK
                               * SM_CLOCK_HZ) * 1e3)
    bound = k3_bound
    print("# K4 k loop (SASS), instructions per product (per FFMA): "
          + ", ".join(f"{op} {c:.3f}" for op, c in mix["mix"].items())
          + f"; {mix['per_product']:.3f} in all ({b_issue:.4f} ms per layer "
          f"at {ISSUE_PER_S:.4g}/s), {mix['int32_per_product']:.3f} on the "
          f"32-bit integer pipe ({b_int:.4f} ms at {INT32_PER_S:.4g}/s); "
          f"{lds:.3f} shared loads per product: {b_shared:.4f} ms per layer "
          f"at one 32-lane load per SM a clock ({_n_sm(dev)} SMs, "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz)", flush=True)
    print(f"# K4 per layer (7 matmuls, M={SMOKE_M}; card time, {how}): "
          f"kernel {ms:.4f} ms (K3 {k3_layer_ms:.4f} ms, K4/K3 "
          f"{ms / k3_layer_ms:.3f}); plain {plain_ms:.3f} ms (CUDA events, "
          f"host included); bound "
          f"{bound:.5f} ms, K3's (the function's: max({nbytes} B / 3.35 "
          f"TB/s, {2 * prods} operations / 1979 TOP/s; an in-order sum "
          f"cannot use the 8-bit tensor rate)) (kernel / bound "
          f"{ms / bound:.1f}); K4's own instructions {b_own:.4f} ms and "
          f"shared loads {b_shared:.4f} ms (kernel / the larger "
          f"{ms / max(b_own, b_shared):.3f}); at 512^3: "
          f"K4 {k4_512:.4f} ms, K3 {k3_512:.4f} ms, K4/K3 "
          f"{k4_512 / k3_512:.3f}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=fb["bound_by"], ratio_512=k4_512 / k3_512)


def train_k4_path(dev) -> dict:
    """Phase: K4's path, 2 full-width qwen2-0.5b train steps (batch 8 x seq
    128, ``arith``) under the lns_loop policy through ``run_training``:
    K4 once forward and once in the recompute of every STE matmul, K3 and
    K2 never."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault, steps

    cfg = get_config("qwen2-0.5b", policy=k4_train_policy())
    n_steps = 2
    want = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    model = Model(cfg, max_seq=128)
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                              seed=0, kind="arith"))

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps.make_train_state(model, gen)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_k4_")
    try:
        torch.cuda.synchronize()
        _reset_matmul_counts()
        lm.lns_loop_matmul.launches = 0
        t0 = time.perf_counter()
        _, history = fault.run_training(
            train_step=steps.build_train_step(model, adamw.OptConfig(
                lr=1e-3, warmup_steps=10, total_steps=100)),
            init_state=init_state, dataset=data, max_steps=n_steps,
            ckpt_dir=tmp, ckpt_every=n_steps,
            to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()},
            log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (k3, k2), k4 = _matmul_counts(), lm.lns_loop_matmul.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if history[-1]["restarts"] != 0:
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if (k4, k3, k2) != (want, 0, 0):
        raise AssertionError(f"launches K4 {k4} (want {want}), K3 {k3}, K2 "
                             f"{k2} (want 0)")
    print(f"# train train_fp8_lns + matmul lns_loop (K4): {n_steps} "
          f"full-width steps, loss {losses} at step {n_steps}, 0 restarts, "
          f"{k4} K4 launches = 2 x 7 x {cfg.n_layers} x {n_steps}, 0 K3, 0 "
          f"K2; {wall:.2f} s wall (init and a checkpoint included)",
          flush=True)
    return dict(launches=k4)


def check_train_k4_against_plain(dev) -> None:
    """Phase: the first step's loss and gradient global norm of a float32,
    2-layer, full-width qwen2-0.5b under the lns_loop policy, through K4
    and through its plain version.  Tolerance as for K2/K3: loss rtol
    1e-4, gradient norm rtol 1e-3 (K4 is bitwise equal to its plain
    version; the sums around it may run in other orders)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import lns_matmul as lm

    cfg = dataclasses.replace(get_config("qwen2-0.5b",
                                         policy=k4_train_policy()),
                              n_layers=2, param_dtype="float32")
    out = []
    for plain in (False, True):
        state, step, batch_of = _train_setup(dev, cfg, seed=5)
        before = lm.lns_loop_matmul.launches
        if plain:
            with _plain_matmuls():
                _, metrics = step(state, batch_of(0))
        else:
            _, metrics = step(state, batch_of(0))
        torch.cuda.synchronize()
        used = lm.lns_loop_matmul.launches - before
        if used != (0 if plain else 2 * MATMULS_PER_LAYER * cfg.n_layers):
            raise AssertionError(f"K4 launches {used} with plain={plain}")
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    (lk, gk), (lp, gp) = out
    if not (math.isclose(lk, lp, rel_tol=1e-4)
            and math.isclose(gk, gp, rel_tol=1e-3)):
        raise AssertionError(f"K4: kernel {out[0]} vs plain {out[1]}")
    print(f"# K4 lns_loop policy, 2 layers float32, first step: loss "
          f"{lk:.7f} (K4) vs {lp:.7f} (plain), grad norm {gk:.6f} vs "
          f"{gp:.6f}", flush=True)


# --------------------------------------------------------------------------- #
# MoE training: granite-moe-3b-a800m through the batched expert products
# --------------------------------------------------------------------------- #
# Full depth (3.30 B parameters) needs ~100 GB at the AdamW update's peak
# (float32 master, two moments, float32 gradients, the bf16 compute copy
# and the update's new tensors: ~30 B a parameter); depth 8 (0.88 B) fits.
MOE_TRAIN_DEPTH = 8
MOE_TRAIN_STEPS = 4
MOE_CHECK_DEPTH = 2        # the float32 comparisons and the K4 route
# An expert layer's three products at batch 8 x seq 128 under grouped
# dispatch: 8 groups of 128 tokens, capacity(128, 8, 40, 1.25) = 32 rows
# an expert a group, so 256 rows an expert; (K, N) -> products of that
# shape in a layer (w_gate and w_up, w_down).
MOE_ROWS = 256
MOE_EXPERT_MATMULS = {(1536, 512): 2, (512, 1536): 1}


def _moe_train_config(depth: int, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(MOE_ARCH, **kw), n_layers=depth)
    C = moe.capacity(128, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    if 8 * C != MOE_ROWS:
        raise AssertionError(f"{MOE_ARCH}: capacity {C}, want "
                             f"{MOE_ROWS // 8} rows a group")
    return cfg


def moe_train_path(dev) -> dict:
    """Phase: MoE training, granite-moe-3b-a800m at full width (d_model
    1536, 40 experts top-8 of d_ff 512, vocab 49,155 padded to 51,200,
    tied) and depth ``MOE_TRAIN_DEPTH`` (cut for memory), under ``--quant
    fp8_lns_pallas``: ``MOE_TRAIN_STEPS`` steps of batch 8 x seq 128
    (``arith``), a checkpoint every 2, through ``runtime.fault.run_training``
    and ``steps.build_train_step`` (the training CLI's own pieces; the CLI
    has no depth flag).  Every STE product runs K3 once forward and once in
    the checkpointed recompute: the four attention products one launch
    each, the three expert products one launch each over all 40 experts.
    Gates: finite losses and aux terms at steps 2 and 4, 0 restarts, K3
    launches 2 x 7 x depth x steps, K2 none.  Prints the wall of every
    step, the peak memory and the busiest expert's share of a layer's
    routed pairs, beside the card's name and power limit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import fault, steps

    cfg = _moe_train_config(MOE_TRAIN_DEPTH, quant="fp8_lns_pallas")
    n_steps = MOE_TRAIN_STEPS
    want = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    model = Model(cfg, max_seq=128)
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                              seed=0, kind="arith"))
    marks = []

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps.make_train_state(model, gen)

    def mark(step):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_matmul_counts()
        with _MoeStats(cfg) as stats:
            t0 = time.perf_counter()
            state, history = fault.run_training(
                train_step=steps.build_train_step(model, adamw.OptConfig(
                    lr=1e-3, warmup_steps=10, total_steps=100)),
                init_state=init_state, dataset=data, max_steps=n_steps,
                ckpt_dir=tmp, ckpt_every=2, fault_hook=mark,
                to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                     for k, v in b.items()},
                log=lambda *a: None)
            torch.cuda.synchronize()
            end = time.perf_counter()
        k3, k2 = _matmul_counts()
        peak = torch.cuda.max_memory_allocated() - held
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    if [h["step"] for h in history] != [2, n_steps]:
        raise AssertionError(f"unexpected log points {history}")
    terms = [(h["loss"], h["ce"], h["moe_lb"], h["moe_z"]) for h in history]
    if not all(math.isfinite(v) for t in terms for v in t):
        raise AssertionError(f"non-finite loss or aux terms {terms}")
    if any(h["restarts"] for h in history):
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if k3 != want or k2 != 0:
        raise AssertionError(f"K3 launches {k3} (want 2 x 7 x "
                             f"{cfg.n_layers} x {n_steps} = {want}), K2 "
                             f"launches {k2} (want 0)")
    walls = [b - a for a, b in zip(marks, marks[1:] + [end])]
    share = float(stats.call_max)
    print(f"# train {MOE_ARCH} fp8_lns_pallas: full width, depth "
          f"{cfg.n_layers} ({n_params / 1e9:.3f} B parameters), batch 8 x "
          f"seq 128, {n_steps} steps; (loss, ce, moe_lb, moe_z) at steps 2 "
          f"and {n_steps}: {terms}; 0 restarts; {k3} K3 launches = 2 x 7 x "
          f"{cfg.n_layers} x {n_steps} (each expert product one launch over "
          f"{cfg.n_experts} experts), 0 K2; step walls "
          f"{', '.join(f'{w:.3f}' for w in walls)} s (the first is the "
          f"process's first granite step; the checkpoints of steps 2 and 4 "
          f"are written while the next steps run, the last one waited for); "
          f"{end - t0:.2f} s wall with init; peak {peak / 2**30:.2f} GiB "
          f"above the "
          f"{held / 2**30:.2f} GiB held before; the busiest expert took "
          f"{100 * share:.2f}% of a layer's routed pairs in one call "
          f"(uniform {100 / cfg.n_experts:.2f}%); [{card_line()}]",
          flush=True)
    return dict(launches=k3, walls=walls, peak=peak)


def _expert_geometry(arch: str):
    """(experts, groups, rows an expert, {(K, N): products a layer}) of
    ``arch``'s routed expert products at batch 8 x seq 128."""
    if arch == MLA_ARCH:
        return 64, 8, MLA_ROWS, MLA_EXPERT_MATMULS
    return 40, 8, MOE_ROWS, MOE_EXPERT_MATMULS


def _moe_codes(dev, seed: int, act_fmt: str, w_fmt: str, arch=MOE_ARCH):
    """FP8 codes of ``arch``'s expert products at batch 8 x seq 128, for
    each shape of its expert matmuls (granite: activations [40, 256, K],
    quantized per (group, expert) block of 32 rows; deepseek: [64, 128,
    K], blocks of 16), and weights [E, K, N] per expert and output
    channel, as ``layers.ste_expert_matmul`` quantizes them."""
    import torch
    from repro_torch.core.quant import quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    E, G, rows, matmuls = _expert_geometry(arch)
    out = {}
    for K, N in matmuls:
        x = torch.randn((E, G, rows // G, K), generator=g, device=dev)
        w = torch.randn((E, K, N), generator=g, device=dev) * 0.02
        out[K, N] = (quantize(x, act_fmt, axis=(0, 1)).codes
                     .view(E, rows, K),
                     quantize(w, w_fmt, axis=(0, 2)).codes)
    return out


def check_moe_kernels(dev, arch=MOE_ARCH) -> dict:
    """Phase: K3 (e4m3 RNE, ``fp8_lns_pallas``) and K2 (e5m2 x e4m3, bf16
    compute, ``train_fp8``) over a batch of ``arch``'s expert products,
    one launch each, at the training shapes (granite: [40, 256, 1536] x
    [40, 1536, 512] and [40, 256, 512] x [40, 512, 1536]; deepseek: [64,
    128, 2048] x [64, 2048, 1408] and [64, 128, 1408] x [64, 1408, 2048])
    on codes quantized as the STE quantizes them: every element within 2
    K 2^-24 sum|products| of the plain version applied expert by expert;
    each expert's slice bitwise equal to the 2-D launch on that expert at
    the batch's tile; two calls bitwise.  Then card time of a layer's
    three expert products (one launch each) beside the bound (the larger
    of the bytes at 3.35 TB/s and the operations at the dense 8-bit rate
    for K3, the bf16 rate for K2), the plain version and ``torch.bmm`` on
    the decoded bf16 operands (the library time of K2; a yardstick of
    the shape only for K3, whose products no PyTorch call computes)."""
    import torch
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.kernels.common import code_to_f32

    n_sm = _n_sm(dev)
    card = card_line()
    E_all, _, rows, matmuls = _expert_geometry(arch)
    res = {}
    for name, fmt, w_fmt, kw, kernel, plain, tiles, rate, only in (
            ("K3", "e4m3", "e4m3", dict(fmt="e4m3", mode="rne"),
             lm.lns_product_matmul, lm.lns_matmul_plain, lm.lns_tile,
             INT8_OPS_PER_S, "lns_matmul_kernel"),
            ("K2", "e5m2", "e4m3", dict(fmt="e5m2", w_fmt="e4m3",
                                        compute_dtype=torch.bfloat16),
             lm.dequant_matmul, lm.dequant_matmul_plain, lm.dequant_tile,
             BF16_FLOP_PER_S, "dequant_matmul_kernel")):
        codes = _moe_codes(dev, 20 if name == "K3" else 21, fmt, w_fmt,
                           arch)
        err, plain_one = 0.0, {}
        for (K, N), (x, w) in codes.items():
            E, M = x.shape[:2]
            tile = tiles(M, N, n_sm, E)
            before = kernel.launches
            got = kernel(x, w, **kw)
            again = kernel(x, w, **kw)
            if kernel.launches != before + 2:
                raise AssertionError(f"{name}: {kernel.launches - before} "
                                     "launches for two batched calls")
            # the plain version's ~40,000 small launches a call: this one
            # call between CUDA events (the profiler's own cost is seconds)
            want, plain_one[K, N] = timed_call(lambda: plain(x, w, **kw))
            absum = plain(x & 0x7F, w & 0x7F, **kw)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if not torch.isfinite(got).all() or bool(
                    (diff > _sum_bound(K, absum)).any()):
                raise AssertionError(f"batched {name} differs from its plain "
                                     f"version at {E}x{M}x{K}x{N}")
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"two batched {name} calls differ")
            for e in range(E):
                one = kernel(x[e], w[e], tile=tile, **kw)
                if not torch.equal(got[e].view(torch.int32),
                                   one.view(torch.int32)):
                    raise AssertionError(f"batched {name} expert {e} differs "
                                         "from the 2-D launch at tile "
                                         f"{tile}")
            err = max(err, float(diff.max()))
            print(f"# batched {name} {E}x{M}x{K}x{N} (tile {tile}, one "
                  f"launch): max |err| {float(diff.max()):.3e} vs the plain "
                  "version expert by expert, within 2 K 2^-24 sum|products|; "
                  f"each of the {E} experts bitwise its 2-D launch; two "
                  "calls bitwise", flush=True)

        def layer_ms(fn, iters, warmup=2, only_=only):
            total, hows = 0.0, set()
            for shape, count in matmuls.items():
                ms, how = device_ms(lambda: fn(*codes[shape]), iters=iters,
                                    only=only_, warmup=warmup)
                total += count * ms
                hows.add(how)
            return total, " / ".join(sorted(hows))

        ms, how = layer_ms(lambda x, w: kernel(x, w, **kw), 20)
        plain_ms = sum(count * plain_one[shape]
                       for shape, count in matmuls.items())
        prods = sum(c * E_all * rows * K * N for (K, N), c in matmuls.items())
        nbytes = sum(c * E_all * (rows * K + K * N + 4 * rows * N)
                     for (K, N), c in matmuls.items())
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = 2 * prods / rate * 1e3
        decoded = {s: (code_to_f32(x, fmt).to(torch.bfloat16),
                       code_to_f32(w, w_fmt).to(torch.bfloat16))
                   for s, (x, w) in codes.items()}
        # graph replays between CUDA events: the profiler has counted a
        # fraction of these kernels late in the process
        bmm = sum(count * graph_ms(lambda: torch.bmm(*decoded[shape]))
                  for shape, count in matmuls.items())
        del decoded
        library = bmm if name == "K2" else None
        res[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=max(b_bytes, b_ops),
                         bound_by="bytes" if b_bytes >= b_ops
                         else "operations", library_ms=library, bmm_ms=bmm)
        print(f"# batched {name}, {arch}'s three expert products a layer "
              f"({E_all} experts x {rows} rows, 3 launches; card time, "
              f"{how}): kernel {ms:.4f} ms = {2 * prods / ms / 1e9:.1f} "
              f"TFLOP/s; plain {plain_ms:.3f} ms (CUDA events); bound "
              f"{res[name]['bound_ms']:.5f} ms = max({nbytes} B / 3.35 TB/s "
              f"= {b_bytes:.5f} ms, {2 * prods} operations / "
              f"{rate / 1e12:.0f} T/s = {b_ops:.5f} ms) -> "
              f"{res[name]['bound_by']} (kernel / bound "
              f"{ms / res[name]['bound_ms']:.1f})"
              + f"; torch.bmm on decoded bf16 {bmm:.4f} ms (CUDA-graph "
              "events" + ("" if library is not None else
                          ", a yardstick of the shape only") + ")"
              + f"; [{card}]", flush=True)
    return res


def _moe_layer_twice(dev, policy_kw: dict) -> None:
    """One granite MoE layer (bf16, full width, batch 8 x seq 128) forward
    and backward twice on one input: the output and the gradients of x,
    the router and the three expert weights must be bitwise equal."""
    import torch
    from repro_torch.models import moe

    cfg = _moe_train_config(1, **policy_kw)
    g = torch.Generator(device=dev).manual_seed(7)
    p = moe.moe_init(g, cfg)
    x = torch.randn((8, 128, cfg.d_model), generator=g,
                    device=dev).to(cfg.pdtype)
    probe = torch.randn((8, 128, cfg.d_model), generator=g, device=dev)

    def run():
        pp = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
        xx = x.detach().clone().requires_grad_(True)
        out, aux = moe.moe_ffn(pp, xx, cfg)
        loss = ((out.float() * probe).sum() + 0.01 * aux["moe_lb"]
                + 1e-3 * aux["moe_z"])
        loss.backward()
        return [out, xx.grad] + [pp[k].grad for k in
                                 ("router", "w_gate", "w_up", "w_down")]

    first, second = run(), run()
    torch.cuda.synchronize()
    names = ("output", "x grad", "router grad", "w_gate grad", "w_up grad",
             "w_down grad")
    for name, a, b in zip(names, first, second):
        if a is None or not torch.equal(a.view(torch.int16 if a.dtype ==
                                               torch.bfloat16 else
                                               torch.int32),
                                        b.view(torch.int16 if b.dtype ==
                                               torch.bfloat16 else
                                               torch.int32)):
            raise AssertionError(f"{MOE_ARCH} MoE layer: the {name} differs "
                                 "between two runs on one input")
        if not torch.isfinite(a).all() or not bool(a.abs().max() > 0):
            raise AssertionError(f"{MOE_ARCH} MoE layer: the {name} is zero "
                                 "or not finite")


def check_moe_train_against_plain(dev) -> dict:
    """Phase: the first step's loss and gradient global norm of a float32,
    depth-2, full-width granite-moe-3b-a800m, through the kernels and
    through their plain versions, for K3 (fp8_lns_pallas) and K2
    (train_fp8): loss rtol 1e-4, gradient norm rtol 1e-3, as
    :func:`check_train_against_plain` (the kernel runs launch 2 x 7 x 2
    times, the plain runs none).  Then one granite MoE layer's forward and
    backward twice on one input under each policy: bitwise equal (routing,
    dispatch, combine and the pair gradients' sums in fixed orders).
    Returns K2's launches in its kernel run."""
    import torch

    launches = {}
    for label, kw in (("K3 fp8_lns_pallas", dict(quant="fp8_lns_pallas")),
                      ("K2 train_fp8", dict(policy="train_fp8"))):
        cfg = dataclasses.replace(
            _moe_train_config(MOE_CHECK_DEPTH, **kw),
            param_dtype="float32")
        want = 2 * MATMULS_PER_LAYER * cfg.n_layers
        out = []
        for plain in (False, True):
            state, step, batch_of = _train_setup(dev, cfg, seed=5)
            before = _matmul_counts()
            if plain:
                with _plain_matmuls():
                    _, metrics = step(state, batch_of(0))
            else:
                _, metrics = step(state, batch_of(0))
            torch.cuda.synchronize()
            used = [a - b for a, b in zip(_matmul_counts(), before)]
            if sorted(used) != ([0, 0] if plain else [0, want]):
                raise AssertionError(f"{label}: kernel launches {used} with "
                                     f"plain={plain}, want {want} of one")
            if not plain:
                launches[label[:2]] = max(used)
            out.append(tuple(float(metrics[k]) for k in
                             ("loss", "grad_norm", "moe_lb", "moe_z")))
            del state, step
            torch.cuda.empty_cache()
        (lk, gk, *ak), (lp, gp, *ap) = out
        if not (math.isclose(lk, lp, rel_tol=1e-4)
                and math.isclose(gk, gp, rel_tol=1e-3)
                and all(math.isfinite(v) for v in ak + ap)):
            raise AssertionError(f"{MOE_ARCH} {label}: kernels {out[0]} vs "
                                 f"plain {out[1]}")
        print(f"# {MOE_ARCH} {label}, depth {MOE_CHECK_DEPTH} float32, full "
              f"width, first step: loss {lk:.7f} (kernels) vs {lp:.7f} "
              f"(plain), grad norm {gk:.6f} vs {gp:.6f}, (moe_lb, moe_z) "
              f"{tuple(round(v, 6) for v in ak)} vs "
              f"{tuple(round(v, 6) for v in ap)}", flush=True)
    for kw in (dict(quant="fp8_lns_pallas"), dict(policy="train_fp8")):
        _moe_layer_twice(dev, kw)
    print(f"# {MOE_ARCH} MoE layer (bf16, batch 8 x seq 128), "
          "fp8_lns_pallas and train_fp8: output and the x, router and "
          "expert gradients bitwise equal on a repeat", flush=True)
    return dict(k2_launches=launches["K2"])


def train_k4_moe_path(dev) -> None:
    """Phase: one full-width granite train step at depth 2 under the
    lns_loop policy (:func:`k4_train_policy`): K4 has no batch axis, so
    each expert product launches it once per expert: 2 x (4 + 3 x 40) x 2
    launches (forward and recompute), K3 and K2 none; finite loss and aux
    terms."""
    import torch
    from repro_torch.kernels import lns_matmul as lm

    cfg = _moe_train_config(MOE_CHECK_DEPTH, policy=k4_train_policy())
    want = 2 * (4 + 3 * cfg.n_experts) * cfg.n_layers
    state, step, batch_of = _train_setup(dev, cfg)
    before = _matmul_counts() + (lm.lns_loop_matmul.launches,)
    t0 = time.perf_counter()
    _, metrics = step(state, batch_of(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k2, k4 = [a - b for a, b in zip(
        _matmul_counts() + (lm.lns_loop_matmul.launches,), before)]
    terms = [float(metrics[k]) for k in ("loss", "moe_lb", "moe_z")]
    del state, step
    torch.cuda.empty_cache()
    if (k4, k3, k2) != (want, 0, 0) or not all(map(math.isfinite, terms)):
        raise AssertionError(f"{MOE_ARCH} lns_loop: K4 {k4} (want {want}), "
                             f"K3 {k3}, K2 {k2}, (loss, moe_lb, moe_z) "
                             f"{terms}")
    print(f"# train {MOE_ARCH} lns_loop (K4), depth {cfg.n_layers}, one step: "
          f"(loss, moe_lb, moe_z) {terms}; {k4} K4 launches = 2 x (4 + 3 x "
          f"{cfg.n_experts}) x {cfg.n_layers} (one a product per expert), 0 "
          f"K3, 0 K2; {wall:.2f} s wall", flush=True)


# --------------------------------------------------------------------------- #
# MLA training: deepseek-v2-lite-16b through the STE products
# --------------------------------------------------------------------------- #
# Full depth (15.7 B parameters) needs ~470 GB under AdamW (~30 B a
# parameter, as for granite); depth 3, the dense layer and two MoE layers
# (1.670 B), fits one card.
MLA_TRAIN_DEPTH = 3
MLA_TRAIN_STEPS = 4
MLA_CHECK_DEPTH = 2        # the float32 comparisons, the layer, K4
MLA_PLAIN_BATCH = 8        # the float32 comparison's batch (x seq 128)
MLA_PREFIX_STE = 8         # the dense layer's STE products: MLA 5, FFN 3
MLA_MOE_STE = 11           # an MoE layer's: MLA 5, shared 3, routed 3
MLA_MOE_RECOMPUTE = 10     # all but the shared experts' down product
# An MoE layer's routed products at batch 8 x seq 128 under grouped
# dispatch: 8 groups of 128 tokens, capacity(128, 6, 64, 1.25) = 16 rows
# an expert a group, so 128 rows an expert; (K, N) -> products of that
# shape in a layer (w_gate and w_up, w_down).
MLA_ROWS = 128
MLA_EXPERT_MATMULS = {(2048, 1408): 2, (1408, 2048): 1}
# 2-D products at M = 1024 that no earlier path reaches: w_dkv's N = 576
# (4.5 tiles of 128) and the dense layer's w_down, K = 10,944 (85.5 k
# tiles of 128: the last one partial)
MLA_DENSE_MATMULS = {"w_dkv": (2048, 576), "w_down": (10944, 2048)}


def _mla_train_config(depth: int, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(MLA_ARCH, **kw), n_layers=depth)
    C = moe.capacity(128, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    if 8 * C != MLA_ROWS:
        raise AssertionError(f"{MLA_ARCH}: capacity {C}, want "
                             f"{MLA_ROWS // 8} rows a group")
    return cfg


def _mla_k3_per_step(cfg) -> int:
    """K3 (or K2) launches of one train step: the leading dense layer's
    products once (outside the checkpoints), each MoE layer's forward and
    its recompute but the shared experts' down product (after the
    checkpoint: the reference's remat drops it), each routed product one
    launch over all experts: 8 + 21 (n_layers - 1)."""
    return MLA_PREFIX_STE + (MLA_MOE_STE + MLA_MOE_RECOMPUTE) * (
        cfg.n_layers - cfg.first_dense)


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def mla_train_path(dev) -> dict:
    """Phase: MLA training, deepseek-v2-lite-16b at full width (d_model
    2048, MLA latent 512 + 64, 16 heads of qk 192 and v 128, 64 experts
    top-6 of d_ff 1,408 and 2 shared, a dense first layer of d_ff 10,944,
    vocab 102,400 untied) and depth ``MLA_TRAIN_DEPTH`` (cut for memory),
    under ``--quant fp8_lns_pallas``: ``MLA_TRAIN_STEPS`` steps of batch 8
    x seq 128 (``arith``) through ``runtime.fault.run_training`` and
    ``steps.build_train_step`` (the training CLI's own pieces; the CLI has
    no depth flag), one checkpoint, at the last step.  The dense layer's 8
    STE products run K3 once (it is outside the checkpoints, as in the
    reference); each MoE layer's 11 (MLA 5, shared 3, routed 3, each
    routed product one launch over all 64 experts) twice but the shared
    down product, once.  Gates: finite loss, ce, moe_lb and moe_z at
    every step, 0 restarts, K3 launches ``MLA_TRAIN_STEPS`` x (8 + 21 x
    (depth - 1)), K2 none.  Prints the
    wall of every step, the checkpoint's bytes and write time, the peak
    memory, the parameter count and the busiest expert's share of a
    layer's routed pairs, beside the card's name and power limit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import fault, steps

    cfg = _mla_train_config(MLA_TRAIN_DEPTH, quant="fp8_lns_pallas")
    n_steps = MLA_TRAIN_STEPS
    want = n_steps * _mla_k3_per_step(cfg)
    model = Model(cfg, max_seq=128)
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                              seed=0, kind="arith"))
    marks, terms, saves = [], [], []
    step_fn = steps.build_train_step(model, adamw.OptConfig(
        lr=1e-3, warmup_steps=10, total_steps=100))

    def train_step(state, batch):
        state, metrics = step_fn(state, batch)
        terms.append(tuple(float(metrics[k])
                           for k in ("loss", "ce", "moe_lb", "moe_z")))
        return state, metrics

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps.make_train_state(model, gen)

    def mark(step):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    real_save = fault.store.save

    def timed_save(*a, **kw):
        t = time.perf_counter()
        pending = real_save(*a, **kw)
        copied = time.perf_counter()
        pending.add_done_callback(
            lambda _: saves.append((copied - t, time.perf_counter() - t)))
        return pending

    moe_layers = dataclasses.replace(cfg,
                                     n_layers=cfg.n_layers - cfg.first_dense)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mla_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_matmul_counts()
        fault.store.save = timed_save
        with _MoeStats(moe_layers) as stats:
            t0 = time.perf_counter()
            state, history = fault.run_training(
                train_step=train_step, init_state=init_state, dataset=data,
                max_steps=n_steps, ckpt_dir=tmp, ckpt_every=n_steps,
                fault_hook=mark,
                to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                     for k, v in b.items()},
                log=lambda *a: None)
            torch.cuda.synchronize()
            end = time.perf_counter()
        k3, k2 = _matmul_counts()
        peak = torch.cuda.max_memory_allocated() - held
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        ckpt_bytes = _dir_bytes(os.path.join(tmp, f"step-{n_steps}"))
        del state
    finally:
        fault.store.save = real_save
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    if [h["step"] for h in history] != [n_steps] or len(terms) != n_steps:
        raise AssertionError(f"unexpected log points {history}, {terms}")
    if not all(math.isfinite(v) for t in terms for v in t):
        raise AssertionError(f"non-finite loss or aux terms {terms}")
    if any(h["restarts"] for h in history):
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if k3 != want or k2 != 0:
        raise AssertionError(f"K3 launches {k3} (want {n_steps} x (8 + 21 x "
                             f"{cfg.n_layers - cfg.first_dense}) = {want}), "
                             f"K2 launches {k2} (want 0)")
    if len(saves) != 1 or ckpt_bytes <= 0:
        raise AssertionError(f"checkpoints {saves}, {ckpt_bytes} B")
    walls = [b - a for a, b in zip(marks, marks[1:] + [end])]
    share = float(stats.call_max)
    print(f"# train {MLA_ARCH} fp8_lns_pallas: full width, depth "
          f"{cfg.n_layers} (the dense layer and "
          f"{cfg.n_layers - cfg.first_dense} MoE layers; "
          f"{n_params / 1e9:.3f} B parameters), batch 8 x seq 128, {n_steps} "
          f"steps; (loss, ce, moe_lb, moe_z) at every step: {terms}; 0 "
          f"restarts; {k3} K3 launches = {n_steps} x (8 + 21 x "
          f"{cfg.n_layers - cfg.first_dense}) (the dense layer's products "
          f"once a step, each routed product one launch over "
          f"{cfg.n_experts} experts), 0 K2; step walls "
          f"{', '.join(f'{w:.3f}' for w in walls)} s (the first is the "
          f"process's first deepseek step; the last includes the "
          f"checkpoint's host copy and waits for its write); checkpoint "
          f"{ckpt_bytes} B, host copy {saves[0][0]:.2f} s, on disk after "
          f"{saves[0][1]:.2f} s; {end - t0:.2f} s wall with init; peak "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held "
          f"before; the busiest expert took {100 * share:.2f}% of a layer's "
          f"routed pairs in one call (uniform {100 / cfg.n_experts:.2f}%); "
          f"[{card_line()}]", flush=True)
    return dict(launches=k3, walls=walls, peak=peak)


def _mla_layer_twice(dev, policy_kw: dict) -> None:
    """One deepseek MLA + MoE layer (bf16, full width, batch 8 x seq 128)
    forward and backward twice on one input: the output and the gradients
    of x and of every leaf (MLA's six, the router, the routed and the
    shared experts') must be bitwise equal."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.transformer import sublayer_forward
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = _mla_train_config(MLA_CHECK_DEPTH, **policy_kw)
    g = torch.Generator(device=dev).manual_seed(7)
    p = Model(cfg).init(g)["blocks"][0]
    x = torch.randn((8, 128, cfg.d_model), generator=g,
                    device=dev).to(cfg.pdtype)
    probe = torch.randn((8, 128, cfg.d_model), generator=g, device=dev)
    positions = torch.arange(128, device=dev).expand(8, 128)

    def run():
        pp = tree_map(lambda v: v.detach().clone().requires_grad_(True), p)
        xx = x.detach().clone().requires_grad_(True)
        out, lb, z = sublayer_forward(pp, xx, cfg, positions=positions,
                                      ffn="moe", site="blocks.0",
                                      want_aux=True)
        ((out.float() * probe).sum() + 0.01 * lb + 1e-3 * z).backward()
        return [out, xx.grad] + [t.grad for t in tree_leaves(pp)]

    first, second = run(), run()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        if not torch.equal(a.view(view), b.view(view)):
            raise AssertionError(f"{MLA_ARCH} MLA + MoE layer: tensor {i} "
                                 "(output, x grad, then the leaves' grads) "
                                 "differs between two runs on one input")
        if not torch.isfinite(a).all() or not bool(a.abs().max() > 0):
            raise AssertionError(f"{MLA_ARCH} MLA + MoE layer: tensor {i} is "
                                 "zero or not finite")


def check_mla_train_against_plain(dev) -> dict:
    """Phase: the first step's loss and gradient global norm of a float32,
    depth-2 (the dense layer and one MoE layer), full-width
    deepseek-v2-lite-16b at batch ``MLA_PLAIN_BATCH`` x seq 128, through
    the kernels and through their plain versions, for K3 (fp8_lns_pallas)
    and K2 (train_fp8): loss rtol 1e-4, gradient norm rtol 1e-3, as
    :func:`check_train_against_plain` (the kernel runs launch 8 + 21
    times, the plain runs none).  Then one MLA + MoE layer's forward and
    backward twice on one input under each policy: bitwise equal.  Returns
    K2's launches in its kernel run."""
    import torch

    launches = {}
    for label, kw in (("K3 fp8_lns_pallas", dict(quant="fp8_lns_pallas")),
                      ("K2 train_fp8", dict(policy="train_fp8"))):
        cfg = dataclasses.replace(
            _mla_train_config(MLA_CHECK_DEPTH, **kw), param_dtype="float32")
        want = _mla_k3_per_step(cfg)
        out, walls = [], []
        for plain in (False, True):
            state, step, batch_of = _train_setup(dev, cfg, seed=5,
                                                 batch=MLA_PLAIN_BATCH)
            before = _matmul_counts()
            t0 = time.perf_counter()
            if plain:
                with _plain_matmuls():
                    _, metrics = step(state, batch_of(0))
            else:
                _, metrics = step(state, batch_of(0))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            used = [a - b for a, b in zip(_matmul_counts(), before)]
            if sorted(used) != ([0, 0] if plain else [0, want]):
                raise AssertionError(f"{label}: kernel launches {used} with "
                                     f"plain={plain}, want {want} of one")
            if not plain:
                launches[label[:2]] = max(used)
            out.append(tuple(float(metrics[k]) for k in
                             ("loss", "grad_norm", "moe_lb", "moe_z")))
            del state, step
            torch.cuda.empty_cache()
        (lk, gk, *ak), (lp, gp, *ap) = out
        if not (math.isclose(lk, lp, rel_tol=1e-4)
                and math.isclose(gk, gp, rel_tol=1e-3)
                and all(math.isfinite(v) for v in ak + ap)):
            raise AssertionError(f"{MLA_ARCH} {label}: kernels {out[0]} vs "
                                 f"plain {out[1]}")
        print(f"# {MLA_ARCH} {label}, depth {MLA_CHECK_DEPTH} float32, full "
              f"width, batch {MLA_PLAIN_BATCH} x seq 128, first step: loss "
              f"{lk:.7f} (kernels, {want} launches) vs {lp:.7f} (plain), "
              f"grad norm {gk:.6f} vs {gp:.6f}, (moe_lb, moe_z) "
              f"{tuple(round(v, 6) for v in ak)} vs "
              f"{tuple(round(v, 6) for v in ap)}; walls {walls[0]:.2f} s vs "
              f"{walls[1]:.2f} s", flush=True)
    for kw in (dict(quant="fp8_lns_pallas"), dict(policy="train_fp8")):
        _mla_layer_twice(dev, kw)
    print(f"# {MLA_ARCH} MLA + MoE layer (bf16, batch 8 x seq 128), "
          "fp8_lns_pallas and train_fp8: output and the gradients of x and "
          "of every leaf bitwise equal on a repeat", flush=True)
    return dict(k2_launches=launches["K2"])


def train_k4_mla_path(dev) -> dict:
    """Phase: one full-width deepseek train step at depth 2 under the
    lns_loop policy (:func:`k4_train_policy`): K4 has no batch axis, so
    each routed product launches it once per expert: 8 + (5 + 3 + 3 x 64)
    + (5 + 2 + 3 x 64) launches (the dense layer once, the MoE layer
    forward and recompute, the shared down product once), K3 and K2 none;
    finite loss and aux terms."""
    import torch
    from repro_torch.kernels import lns_matmul as lm

    cfg = _mla_train_config(MLA_CHECK_DEPTH, policy=k4_train_policy())
    moe_layers = cfg.n_layers - cfg.first_dense
    want = MLA_PREFIX_STE + ((5 + 3 + 3 * cfg.n_experts)
                             + (5 + 2 + 3 * cfg.n_experts)) * moe_layers
    state, step, batch_of = _train_setup(dev, cfg)
    before = _matmul_counts() + (lm.lns_loop_matmul.launches,)
    t0 = time.perf_counter()
    _, metrics = step(state, batch_of(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k2, k4 = [a - b for a, b in zip(
        _matmul_counts() + (lm.lns_loop_matmul.launches,), before)]
    terms = [float(metrics[k]) for k in ("loss", "ce", "moe_lb", "moe_z")]
    del state, step
    torch.cuda.empty_cache()
    if (k4, k3, k2) != (want, 0, 0) or not all(map(math.isfinite, terms)):
        raise AssertionError(f"{MLA_ARCH} lns_loop: K4 {k4} (want {want}), "
                             f"K3 {k3}, K2 {k2}, (loss, ce, moe_lb, moe_z) "
                             f"{terms}")
    print(f"# train {MLA_ARCH} lns_loop (K4), depth {cfg.n_layers}, one "
          f"step: (loss, ce, moe_lb, moe_z) {terms}; {k4} K4 launches = 8 + "
          f"((5 + 3 + 3 x {cfg.n_experts}) + (5 + 2 + 3 x {cfg.n_experts})) "
          f"x {moe_layers} (one a product "
          f"per expert), 0 K3, 0 K2; {wall:.2f} s wall", flush=True)
    return dict(launches=k4)


def check_mla_kernels(dev) -> dict:
    """Phase: the kernels at deepseek's new shapes.  K3 and K2 over one
    MoE layer's three routed products, 64 experts of 128 rows
    (:func:`check_moe_kernels`); then at M = 1024 on codes quantized as
    the STE quantizes them (``MLA_DENSE_MATMULS``): K3 on ``w_dkv`` (N =
    576, a half tile of 128 at the edge) and on the dense layer's
    ``w_down`` (K = 10,944, a partial last k tile), each within 2 K 2^-24
    sum|products| of its plain version and two calls bitwise; K4 on
    ``w_down``, bitwise its plain version (NaN as NaN) and two calls
    bitwise.  Card times beside the function's bound (codes in, float32
    out at 3.35 TB/s, or two 8-bit operations a product at the dense
    8-bit rate), the plain versions and ``torch.matmul`` on the decoded
    bf16 operands (a yardstick of the shape only)."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.kernels.common import code_to_f32

    res = {"experts": check_moe_kernels(dev, MLA_ARCH)}
    card = card_line()
    g = torch.Generator(device=dev).manual_seed(22)
    M = SMOKE_M
    for name, (K, N) in MLA_DENSE_MATMULS.items():
        x = quantize(torch.randn((M, K), generator=g, device=dev),
                     "e4m3").codes
        w = quantize(torch.randn((K, N), generator=g, device=dev) * 0.02,
                     "e4m3", axis=-1).codes
        nbytes = M * K + K * N + 4 * M * N
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = 2 * M * K * N / INT8_OPS_PER_S * 1e3
        bound = max(b_bytes, b_ops)
        bound_by = "bytes" if b_bytes >= b_ops else "operations"
        routes = [("K3", lm.lns_product_matmul, lm.lns_matmul_plain,
                   "lns_matmul_kernel")]
        if name == "w_down":
            routes.append(("K4", lm.lns_loop_matmul, lm.lns_loop_matmul_plain,
                           "lns_loop_matmul"))
        decoded = (code_to_f32(x, "e4m3").to(torch.bfloat16),
                   code_to_f32(w, "e4m3").to(torch.bfloat16))
        mm = graph_ms(lambda: torch.matmul(*decoded))
        for kname, kernel, plain, only in routes:
            got = kernel(x, w, fmt="e4m3", mode="rne")
            again = kernel(x, w, fmt="e4m3", mode="rne")
            want, plain_ms = timed_call(lambda: plain(x, w, fmt="e4m3",
                                                      mode="rne"))
            if kname == "K4":
                if not _nan_aware_bitwise(got, want):
                    raise AssertionError(f"K4 differs from its plain version "
                                         f"at {M}x{K}x{N}")
                err = 0.0
            else:
                absum = plain(x & 0x7F, w & 0x7F, fmt="e4m3", mode="rne")
                diff = (got - want).abs()
                if not torch.isfinite(got).all() or bool(
                        (diff > _sum_bound(K, absum)).any()):
                    raise AssertionError(f"K3 differs from its plain version "
                                         f"at {M}x{K}x{N}")
                err = float(diff.max())
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"two {kname} calls differ at "
                                     f"{M}x{K}x{N}")
            ms, how = device_ms(lambda: kernel(x, w, fmt="e4m3", mode="rne"),
                                iters=10, only=only)
            res[kname, name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound, bound_by=bound_by,
                                    matmul_ms=mm)
            print(f"# {kname} {MLA_ARCH} {name} {M}x{K}x{N} (e4m3, RNE): "
                  + ("bitwise its plain version (NaN as NaN)"
                     if kname == "K4" else
                     f"max |err| {err:.3e} within 2 K 2^-24 sum|products| "
                     "of its plain version")
                  + f", two calls bitwise; kernel {ms:.4f} ms ({how}); plain "
                  f"{plain_ms:.3f} ms (CUDA events); bound {bound:.5f} ms = "
                  f"max({nbytes} B / 3.35 TB/s = {b_bytes:.5f} ms, "
                  f"{2 * M * K * N} operations / 1979 T/s = {b_ops:.5f} ms) "
                  f"-> {bound_by} (kernel / bound {ms / bound:.1f}); "
                  f"torch.matmul on decoded bf16 {mm:.4f} ms (CUDA-graph "
                  f"events, a yardstick of the shape only); [{card}]",
                  flush=True)
        del decoded
    return res


# --------------------------------------------------------------------------- #
# SSM training: mamba2-780m through the STE products
# --------------------------------------------------------------------------- #
# Full depth (48 layers, ~780 M parameters: ~14 GB of float32 master
# weights, AdamW moments and gradients, then activations) fits one card.
SSM_TRAIN_STEPS = 4
SSM_CHECK_DEPTH = 2        # the float32 comparisons and the K4 route
SSM_PLAIN_BATCH = 8        # the float32 comparison's batch (x seq 128)
SSM_TRAIN_M = 1024         # batch 8 x seq 128: the rows of every product
EXP_LIMIT = math.log(3.4028234663852886e38)   # 88.72: float32 exp's range


def _ssm_k3_per_step(cfg) -> int:
    """K3 (or K2, K4) launches of one mamba2 train step: each SSD layer's
    six STE products, forward and in the layer's checkpointed recompute:
    2 x 6 x n_layers."""
    return 2 * SSM_K_PER_LAYER * cfg.n_layers


class _DecayRange:
    """Within the block, the largest exponent that ``ssd_forward``'s
    within-chunk decays mask out (the sum of dt |A| over a chunk's rows,
    above the diagonal): past ``EXP_LIMIT`` the reference's ``where(mask,
    exp(diff), 0)`` gives a NaN gradient."""

    def __enter__(self):
        import torch
        from repro_torch.models import mamba2

        self.mod, self.real, self.top = mamba2, mamba2.masked_decay, None

        def recorded(diff, mask):
            with torch.no_grad():   # outside the graph the checkpoint checks
                top = diff.detach().amax()
                self.top = top if self.top is None else self.top.maximum(top)
            return self.real(diff, mask)

        mamba2.masked_decay = recorded
        return self

    def __exit__(self, *exc):
        self.mod.masked_decay = self.real
        return False


def ssm_train_path(dev) -> dict:
    """Phase: SSM training, mamba2-780m at full width and full depth (48
    SSD layers, d_model 1536, d_inner 3072, 48 heads of 64, d_state 128,
    vocab 50,280 tied; no FFN) under ``--quant fp8_lns_pallas``, the
    model's own init: ``SSM_TRAIN_STEPS`` steps of batch 8 x seq 128
    (``arith``) through ``runtime.fault.run_training`` and
    ``steps.build_train_step`` (the training CLI's own pieces), one
    checkpoint, at the last step.  Each SSD layer runs under the
    checkpoint, so its six STE products run K3 twice a step.  Then one
    more step with every layer's A and dt at Mamba2's init ranges
    (:func:`_mamba2_ranges`), where the masked decays' exponents pass
    float32's exp range (measured by :class:`_DecayRange`; the
    reference's gradient is NaN there).  Gates: finite losses and
    gradient norms at every step (the port's masked exponent), 0
    restarts, K3 launches ``SSM_TRAIN_STEPS`` x 2 x 6 x 48, K2 none, the
    decays' largest exponent past ``EXP_LIMIT`` in the last step and
    every parameter finite after it.  Prints the step walls, the
    checkpoint, the peak memory and the parameter count, beside the
    card's name and power limit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import fault, steps

    cfg = get_config(SSM_ARCH, quant="fp8_lns_pallas")
    n_steps = SSM_TRAIN_STEPS
    per_step = _ssm_k3_per_step(cfg)
    model = Model(cfg, max_seq=128)
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                              seed=0, kind="arith"))
    marks, terms, saves = [], [], []
    step_fn = steps.build_train_step(model, adamw.OptConfig(
        lr=1e-3, warmup_steps=10, total_steps=100))

    def train_step(state, batch):
        state, metrics = step_fn(state, batch)
        terms.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        return state, metrics

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps.make_train_state(model, gen)

    def mark(step):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    real_save = fault.store.save

    def timed_save(*a, **kw):
        t = time.perf_counter()
        pending = real_save(*a, **kw)
        copied = time.perf_counter()
        pending.add_done_callback(
            lambda _: saves.append((copied - t, time.perf_counter() - t)))
        return pending

    def to_device(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssm_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_matmul_counts()
        fault.store.save = timed_save
        t0 = time.perf_counter()
        state, history = fault.run_training(
            train_step=train_step, init_state=init_state, dataset=data,
            max_steps=n_steps, ckpt_dir=tmp, ckpt_every=n_steps,
            fault_hook=mark, to_device=to_device, log=lambda *a: None)
        torch.cuda.synchronize()
        end = time.perf_counter()
        k3, k2 = _matmul_counts()
        peak = torch.cuda.max_memory_allocated() - held
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        ckpt_bytes = _dir_bytes(os.path.join(tmp, f"step-{n_steps}"))
    finally:
        fault.store.save = real_save
        shutil.rmtree(tmp, ignore_errors=True)
    # one more step at Mamba2's init ranges
    top_ad = _mamba2_ranges(state["params"]["blocks"], seed=11)
    with _DecayRange() as decay:
        t1 = time.perf_counter()
        state, metrics = step_fn(state, to_device(data.batch(n_steps)))
        torch.cuda.synchronize()
        ranged_wall = time.perf_counter() - t1
    ranged = (float(metrics["loss"]), float(metrics["grad_norm"]))
    top = float(decay.top)
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(state["params"]))
    del state
    torch.cuda.empty_cache()
    if [h["step"] for h in history] != [n_steps] or len(terms) != n_steps:
        raise AssertionError(f"unexpected log points {history}, {terms}")
    if not all(math.isfinite(v) for t in terms + [ranged] for v in t):
        raise AssertionError(f"non-finite loss or gradient norm {terms}, "
                             f"at Mamba2's ranges {ranged}")
    if any(h["restarts"] for h in history):
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if k3 != n_steps * per_step or k2 != 0:
        raise AssertionError(f"K3 launches {k3} (want {n_steps} x 2 x "
                             f"{SSM_K_PER_LAYER} x {cfg.n_layers} = "
                             f"{n_steps * per_step}), K2 launches {k2}")
    if len(saves) != 1 or ckpt_bytes <= 0:
        raise AssertionError(f"checkpoints {saves}, {ckpt_bytes} B")
    if not top > EXP_LIMIT or not finite:
        raise AssertionError(f"at Mamba2's ranges: the decays' largest "
                             f"exponent {top} (want past {EXP_LIMIT:.2f}), "
                             f"parameters finite: {finite}")
    walls = [b - a for a, b in zip(marks, marks[1:] + [end])]
    print(f"# train {SSM_ARCH} fp8_lns_pallas: full width, full depth "
          f"({cfg.n_layers} SSD layers; {n_params / 1e6:.2f} M parameters), "
          f"batch 8 x seq 128, {n_steps} steps from the model's init; "
          f"(loss, grad norm) at every step: {terms}; 0 restarts; {k3} K3 "
          f"launches = {n_steps} x 2 x {SSM_K_PER_LAYER} x {cfg.n_layers} "
          f"(forward and the checkpointed recompute), 0 K2; step walls "
          f"{', '.join(f'{w:.3f}' for w in walls)} s (the first is the "
          f"process's first mamba2 step; the last includes the checkpoint's "
          f"host copy and waits for its write); checkpoint {ckpt_bytes} B, "
          f"host copy {saves[0][0]:.2f} s, on disk after "
          f"{saves[0][1]:.2f} s; {end - t0:.2f} s wall with init; peak "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held "
          f"before; [{card_line()}]", flush=True)
    print(f"# train {SSM_ARCH}: one step with A and dt at Mamba2's init "
          f"ranges (largest A dt {top_ad:.4f}): the masked decays' largest "
          f"exponent {top:.2f}, past float32's exp range {EXP_LIMIT:.2f} "
          f"(the reference's where(mask, exp(diff), 0) gives NaN gradients "
          f"there); loss {ranged[0]:.6f}, grad norm {ranged[1]:.6f}, every "
          f"parameter finite; {ranged_wall:.3f} s wall", flush=True)
    return dict(launches=k3, walls=walls, peak=peak, top=top)


def check_ssm_train_against_plain(dev) -> dict:
    """Phase: the first step's loss and gradient global norm of a float32,
    depth-``SSM_CHECK_DEPTH``, full-width mamba2-780m at batch
    ``SSM_PLAIN_BATCH`` x seq 128, through the kernels and through their
    plain versions, for K3 (fp8_lns_pallas) and K2 (train_fp8): loss rtol
    1e-4, gradient norm rtol 1e-3, as :func:`check_train_against_plain`
    (the kernel runs launch 2 x 6 x depth times, the plain runs none).
    Returns K2's launches in its kernel run."""
    import torch

    launches = {}
    for label, kw in (("K3 fp8_lns_pallas", dict(quant="fp8_lns_pallas")),
                      ("K2 train_fp8", dict(policy="train_fp8"))):
        from repro_torch.configs import get_config

        cfg = dataclasses.replace(get_config(SSM_ARCH, **kw),
                                  n_layers=SSM_CHECK_DEPTH,
                                  param_dtype="float32")
        want = _ssm_k3_per_step(cfg)
        out, walls = [], []
        for plain in (False, True):
            state, step, batch_of = _train_setup(dev, cfg, seed=5,
                                                 batch=SSM_PLAIN_BATCH)
            before = _matmul_counts()
            t0 = time.perf_counter()
            if plain:
                with _plain_matmuls():
                    _, metrics = step(state, batch_of(0))
            else:
                _, metrics = step(state, batch_of(0))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            used = [a - b for a, b in zip(_matmul_counts(), before)]
            if sorted(used) != ([0, 0] if plain else [0, want]):
                raise AssertionError(f"{label}: kernel launches {used} with "
                                     f"plain={plain}, want {want} of one")
            if not plain:
                launches[label[:2]] = max(used)
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
            del state, step
            torch.cuda.empty_cache()
        (lk, gk), (lp, gp) = out
        if not (math.isclose(lk, lp, rel_tol=1e-4)
                and math.isclose(gk, gp, rel_tol=1e-3)):
            raise AssertionError(f"{SSM_ARCH} {label}: kernels {out[0]} vs "
                                 f"plain {out[1]}")
        print(f"# {SSM_ARCH} {label}, depth {SSM_CHECK_DEPTH} float32, full "
              f"width, batch {SSM_PLAIN_BATCH} x seq 128, first step: loss "
              f"{lk:.7f} (kernels, {want} launches) vs {lp:.7f} (plain), "
              f"grad norm {gk:.6f} vs {gp:.6f}; walls {walls[0]:.2f} s vs "
              f"{walls[1]:.2f} s", flush=True)
    return dict(k2_launches=launches["K2"])


def train_k4_ssm_path(dev) -> dict:
    """Phase: one full-width mamba2-780m train step at depth
    ``SSM_CHECK_DEPTH`` under the lns_loop policy
    (:func:`k4_train_policy`): K4 2 x 6 x depth launches (every product
    2-D, forward and recompute), K3 and K2 none; finite loss and gradient
    norm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import lns_matmul as lm

    cfg = dataclasses.replace(get_config(SSM_ARCH, policy=k4_train_policy()),
                              n_layers=SSM_CHECK_DEPTH)
    want = _ssm_k3_per_step(cfg)
    state, step, batch_of = _train_setup(dev, cfg)
    before = _matmul_counts() + (lm.lns_loop_matmul.launches,)
    t0 = time.perf_counter()
    _, metrics = step(state, batch_of(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k2, k4 = [a - b for a, b in zip(
        _matmul_counts() + (lm.lns_loop_matmul.launches,), before)]
    terms = [float(metrics[k]) for k in ("loss", "grad_norm")]
    del state, step
    torch.cuda.empty_cache()
    if (k4, k3, k2) != (want, 0, 0) or not all(map(math.isfinite, terms)):
        raise AssertionError(f"{SSM_ARCH} lns_loop: K4 {k4} (want {want}), "
                             f"K3 {k3}, K2 {k2}, (loss, grad norm) {terms}")
    print(f"# train {SSM_ARCH} lns_loop (K4), depth {cfg.n_layers}, one "
          f"step: (loss, grad norm) {terms}; {k4} K4 launches = 2 x "
          f"{SSM_K_PER_LAYER} x {cfg.n_layers}, 0 K3, 0 K2; {wall:.2f} s "
          "wall", flush=True)
    return dict(launches=k4)


def check_ssm_train_kernels(dev) -> dict:
    """Phase: K3, K2 and K4 at mamba2-780m's six training products
    (``SSM_MATMULS`` at M = ``SSM_TRAIN_M``: N 3,072, 128, 48, 1,536; N
    48 a partial tile of every tile): K3 and K2 within 2 sqrt(K) 2^-24
    sum|products| of their plain versions and two calls bitwise
    (:func:`_ssm_kernel_checks`), K4 bitwise its plain version (NaN as
    NaN) and two calls bitwise; each kernel's card time on the layer's
    six products beside the function's bound, its plain version and, for
    K2, ``torch.matmul`` on the decoded bf16 operands."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import lns_matmul as lm

    res = _ssm_kernel_checks(dev, (SSM_TRAIN_M,), SSM_TRAIN_M,
                             "training", seed=31)
    g = torch.Generator(device=dev).manual_seed(32)
    mats = [quantize(torch.randn(kn, generator=g, device=dev) * 0.02,
                     "e4m3") for kn in SSM_MATMULS.values()]
    xs = [quantize(torch.randn((SSM_TRAIN_M, q.codes.shape[0]), generator=g,
                               device=dev), "e4m3").codes for q in mats]

    def k4():
        return [lm.lns_loop_matmul(x, q.codes, fmt="e4m3", mode="rne")
                for x, q in zip(xs, mats)]

    def plain():
        return [lm.lns_loop_matmul_plain(x, q.codes, fmt="e4m3", mode="rne")
                for x, q in zip(xs, mats)]

    got, again = k4(), k4()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for (name, (K, N)), a, b, c in zip(SSM_MATMULS.items(), got, again,
                                       want):
        if not (_nan_aware_bitwise(a, c) and _nan_aware_bitwise(a, b)):
            raise AssertionError(f"K4 at {SSM_ARCH} {name} "
                                 f"{SSM_TRAIN_M}x{K}x{N}: not bitwise its "
                                 "plain version, or two calls differ")
    ms, how = device_ms(k4, iters=5, only="lns_loop_matmul")
    bound = res["lns"]
    res["lns_loop"] = dict(ms=ms, plain_ms=plain_ms, err=0.0,
                           bound_ms=bound["bound_ms"],
                           bound_by=bound["bound_by"], library_ms=None)
    print(f"# K4 {SSM_ARCH} training, one layer's six products at M = "
          f"{SSM_TRAIN_M}: bitwise its plain version, two calls bitwise; "
          f"kernel {ms:.5f} ms ({how}), plain {plain_ms:.4f} ms (its "
          f"checking call, host clock, host included), bound "
          f"{bound['bound_ms']:.5f} ms (K3's: the function's; "
          f"{ms / bound['bound_ms']:.1f}x); [{card_line()}]", flush=True)
    return res


def _phase(fn, *args, **kw):
    """Run one phase of :func:`main` and print its wall time."""
    t = time.perf_counter()
    out = fn(*args, **kw)
    print(f"# phase {fn.__name__}: {time.perf_counter() - t:.1f} s",
          flush=True)
    return out


def main() -> int:
    import torch

    from repro_torch.numerics import get_policy
    from repro_torch.kernels import cuda_build  # fails outside the repo

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # before any phase touches the card, as the serve CLI does: cuBLAS
    # without split-K in this process and the ranks it spawns
    from repro_torch.launch.mesh import require_column_stable_cublas

    require_column_stable_cublas("cuda")
    # full float32 products in every comparison on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    cuda_build.build(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        log = cuda_build.ptxas_log(name).strip()
        if log:
            print(f"# nvcc {name}.cu:\n" + "\n".join(
                "#   " + line for line in log.splitlines()), flush=True)
    print(f"# built {len(KERNEL_SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _phase(check_tensor_cores)
    k1 = _phase(check_k1, dev)
    k1f = _phase(check_k1_float, dev)
    _phase(serve_main_path, dev)
    _phase(check_against_plain_engine, dev)
    _phase(profile_main_path, dev, depth=PROFILE_DEPTH)
    _phase(serve_main_path, dev, policy=None)
    _phase(check_against_plain_engine, dev, policy=None)
    _phase(profile_main_path, dev, policy=None, depth=PROFILE_DEPTH)
    _phase(preemption_path, dev, "serve_fp8_paged")
    _phase(preemption_path, dev, None)
    served_prefix = _phase(prefix_main_path, dev, "serve_fp8_paged", None,
                           MAIN_DEPTH)
    params = served_prefix.pop("params")
    served_prefix_float = _phase(prefix_main_path, dev, None, params,
                                 PREFIX_PREEMPT_DEPTH)
    served_prefix_float.pop("params")
    shared = _phase(preempt_shared_path, dev, "serve_fp8_paged", params)
    shared_float = _phase(preempt_shared_path, dev, None, params)
    _phase(chaos_path, dev, params, shared, shared_float)
    mesh_run = _phase(mesh_start, dev, params)   # the ranks run meanwhile
    _phase(bucketed_path, dev, "serve_fp8_paged", params, shared["outputs"])
    _phase(bucketed_path, dev, None, params, shared_float["outputs"])
    _phase(bucketed_logits_path, dev, "serve_fp8_paged", params)
    _phase(bucketed_logits_path, dev, None, params)
    meshed = _phase(mesh_path, dev, mesh_run, shared, shared_float)
    static = _phase(static_weights_path, dev, params)  # drops the bf16
    del params
    static_k = _phase(static_kernel_path, dev, static.pop("codes"))
    torch.cuda.empty_cache()
    moe = _phase(moe_path, dev, k1["moe"], k1f["moe"])
    _phase(profile_main_path, dev, arch=MOE_ARCH, depth=PROFILE_DEPTH)
    mla = _phase(mla_path, dev)
    _phase(profile_main_path, dev, arch=MLA_ARCH, depth=PROFILE_DEPTH)
    ssm = _phase(ssm_path, dev)
    _phase(profile_main_path, dev, policy=None, arch=SSM_ARCH)
    ssm_k = _phase(check_ssm_kernels, dev)
    hybrid = _phase(hybrid_path, dev, k1["hybrid"], k1f["hybrid"])
    _phase(profile_main_path, dev, arch=HYBRID_ARCH, depth=HYBRID_DEPTH)
    _phase(profile_main_path, dev, arch="gemma3-12b", depth=PROFILE_DEPTH)
    _phase(profile_main_path, dev, policy=None, arch="gemma3-12b",
           depth=PROFILE_DEPTH)
    _phase(window_path, dev)
    _phase(dense_family_path, dev, "gemma2-27b")
    _phase(dense_family_path, dev, "qwen3-14b")
    _phase(check_k5_cells, dev)
    k5 = _phase(check_k5_shapes, dev)
    served_k5 = _phase(serve_main_path, dev, policy=k5_serve_policy(),
                       plens=(5, 17, 9, 2), gen=8)
    _phase(check_k5_engine_against_plain, dev)
    _phase(profile_main_path, dev, policy=k5_serve_policy(),
           depth=PROFILE_DEPTH)
    _phase(check_k3_products, dev)
    mm = _phase(check_matmul_kernels, dev)
    trained = _phase(train_main_path, dev)
    trained_k2 = _phase(train_k2_path, dev)
    _phase(check_train_against_plain, dev)
    _phase(profile_train_step, dev, depth=PROFILE_DEPTH)
    _phase(profile_train_step, dev, policy=get_policy("train_fp8"),
           depth=PROFILE_DEPTH)
    _phase(train_k5_path, dev)
    _phase(check_train_k5_against_plain, dev)
    _phase(profile_train_step, dev, policy=k5_train_policy(),
           depth=PROFILE_DEPTH)
    k6 = _phase(check_k6, dev)
    k6.update(_phase(time_k6, dev))
    tuned = _phase(k6_autotune_path, dev)
    k4 = _phase(check_k4, dev, mm["k3_ms"], mm["k3_bound"])
    trained_k4 = _phase(train_k4_path, dev)
    _phase(check_train_k4_against_plain, dev)
    moe_k = _phase(check_moe_kernels, dev)
    moe_trained = _phase(moe_train_path, dev)
    _phase(profile_train_step, dev, depth=MOE_TRAIN_DEPTH, arch=MOE_ARCH)
    moe_plain = _phase(check_moe_train_against_plain, dev)
    _phase(train_k4_moe_path, dev)
    mla_k = _phase(check_mla_kernels, dev)
    mla_trained = _phase(mla_train_path, dev)
    _phase(profile_train_step, dev, depth=MLA_TRAIN_DEPTH, arch=MLA_ARCH)
    mla_plain = _phase(check_mla_train_against_plain, dev)
    mla_k4 = _phase(train_k4_mla_path, dev)
    ssm_train_k = _phase(check_ssm_train_kernels, dev)
    ssm_trained = _phase(ssm_train_path, dev)
    _phase(profile_train_step, dev, depth=SSM_MAIN_DEPTH, arch=SSM_ARCH)
    ssm_plain = _phase(check_ssm_train_against_plain, dev)
    ssm_k4 = _phase(train_k4_ssm_path, dev)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name="lns_paged_partials", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:400",
             launches=served_prefix["launches"],
             max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="lns_matmul", route="cuda", source=src + "lns_matmul.cu",
             replaces="src/repro/kernels/lns_matmul.py:62",
             launches=trained["launches"], max_abs_err=mm["k3_err"],
             ms=mm["k3_ms"], plain_ms=mm["k3_plain_ms"],
             bound_ms=mm["k3_bound"], bound_by=mm["k3_bound_by"],
             library_ms=None),
        dict(name="dequant_matmul", route="cuda",
             source=src + "lns_matmul.cu",
             replaces="src/repro/kernels/lns_matmul.py:110",
             launches=trained_k2["launches"], max_abs_err=mm["k2_err"],
             ms=mm["k2_ms"], plain_ms=mm["k2_plain_ms"],
             bound_ms=mm["k2_bound"], bound_by=mm["k2_bound_by"],
             library_ms=mm["k2_library_ms"]),
        dict(name="fp8_elementwise", route="cuda",
             source=src + "fp8_elementwise.cu",
             replaces="src/repro/kernels/fp8_elementwise.py:29",
             launches=served_k5["k5_launches"],
             max_abs_err=k5["max_abs_err"],
             ms=k5["train"]["ms"], plain_ms=k5["train"]["plain_ms"],
             bound_ms=k5["train"]["bound_ms"],
             bound_by=k5["train"]["bound_by"], library_ms=None),
        dict(name="lns_loop_matmul", route="cuda",
             source=src + "lns_matmul.cu",
             replaces="src/repro/kernels/lns_matmul.py:91",
             launches=trained_k4["launches"], max_abs_err=0.0,
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None),
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:31",
             launches=tuned["launches"],
             max_abs_err=max(k6["max_abs_err"], tuned["max_abs_err"]),
             ms=k6["ms"], plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"],
             bound_by=k6["bound_by"], library_ms=k6["library_ms"]),
        dict(name="float_paged_partials", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:400",
             launches=served_prefix_float["launches"],
             max_abs_err=k1f["max_abs_err"], ms=k1f["ms"],
             plain_ms=k1f["plain_ms"], bound_ms=k1f["bound_ms"],
             bound_by=k1f["bound_by"], library_ms=None),
    ]
    for lns, mode in ((True, False), (False, False), (True, True),
                      (False, True)):
        t = meshed["timed"][lns, mode]
        run = meshed["fp8" if lns else "bf16"]
        inst = "lns" if lns else "float"
        kernels.append(dict(
            name=(f"{inst}_paged_partials"
                  + ("_partials_mode" if mode else f"_tp{MESH_TP}_shard")),
            route="cuda", source=src + "paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:400",
            launches=(meshed["partials"]["launches" if lns
                                         else "float_launches"] if mode
                      else run["launches"]),
            max_abs_err=(meshed["partials_err"][inst] if mode
                         else meshed[f"{'fp8' if lns else 'bf16'}_err"]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    for lns in (True, False):
        t, inst = (k1, "lns") if lns else (k1f, "float")
        kernels.append(dict(
            name=f"{inst}_paged_partials_granite_moe", route="cuda",
            source=src + "paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:400",
            launches=moe["fp8" if lns else "bf16"]["launches"],
            max_abs_err=max(t["max_abs_err"],
                            moe["fp8_err" if lns else "bf16_err"]),
            ms=t["moe"]["ms"], plain_ms=t["moe"]["plain_ms"],
            bound_ms=t["moe"]["bound_ms"], bound_by=t["moe"]["bound_by"],
            library_ms=None))
    for impl, name, line in (("fused_dequant", "dequant_matmul", 110),
                             ("lns", "lns_matmul", 62)):
        k = static_k[impl]
        m4 = k[PREFIX_SLOTS]
        kernels.append(dict(
            name=f"{name}_static_weights", route="cuda",
            source=src + "lns_matmul.cu",
            replaces=f"src/repro/kernels/lns_matmul.py:{line}",
            launches=k["launches"], max_abs_err=k["err"], ms=m4["ms"],
            plain_ms=m4["plain_ms"], bound_ms=m4["bound_ms"],
            bound_by=m4["bound_by"], library_ms=m4["library_ms"]))
    k = mla["k2"]
    kernels.append(dict(
        name="dequant_matmul_static_weights_deepseek", route="cuda",
        source=src + "lns_matmul.cu",
        replaces="src/repro/kernels/lns_matmul.py:110",
        launches=mla["k2_launches"], max_abs_err=mla["k2_err"], ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=k["library_ms"]))
    for impl, name, line in (("fused_dequant", "dequant_matmul", 110),
                             ("lns", "lns_matmul", 62)):
        k = ssm_k[impl]
        kernels.append(dict(
            name=f"{name}_static_weights_mamba2", route="cuda",
            source=src + "lns_matmul.cu",
            replaces=f"src/repro/kernels/lns_matmul.py:{line}",
            launches=ssm[impl]["launches"],
            max_abs_err=max(k["err"], ssm[impl]["err"]), ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    for name, key, line, launches in (
            ("lns_matmul_experts", "K3", 62, moe_trained["launches"]),
            ("dequant_matmul_experts", "K2", 110, moe_plain["k2_launches"])):
        k = moe_k[key]
        kernels.append(dict(
            name=name, route="cuda", source=src + "lns_matmul.cu",
            replaces=f"src/repro/kernels/lns_matmul.py:{line}",
            launches=launches, max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    for name, key, line, launches in (
            ("lns_matmul_experts_deepseek", "K3", 62, mla_trained["launches"]),
            ("dequant_matmul_experts_deepseek", "K2", 110,
             mla_plain["k2_launches"])):
        k = mla_k["experts"][key]
        kernels.append(dict(
            name=name, route="cuda", source=src + "lns_matmul.cu",
            replaces=f"src/repro/kernels/lns_matmul.py:{line}",
            launches=launches, max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    k = mla_k["K4", "w_down"]
    kernels.append(dict(
        name="lns_loop_matmul_deepseek_w_down", route="cuda",
        source=src + "lns_matmul.cu",
        replaces="src/repro/kernels/lns_matmul.py:91",
        launches=mla_k4["launches"], max_abs_err=k["err"], ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None))
    for lns in (True, False):
        t, inst = (k1, "lns") if lns else (k1f, "float")
        kernels.append(dict(
            name=f"{inst}_paged_partials_jamba", route="cuda",
            source=src + "paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:400",
            launches=hybrid["fp8" if lns else "bf16"]["launches"],
            max_abs_err=max(t["max_abs_err"], hybrid["k1_err"]),
            ms=t["hybrid"]["ms"], plain_ms=t["hybrid"]["plain_ms"],
            bound_ms=t["hybrid"]["bound_ms"],
            bound_by=t["hybrid"]["bound_by"], library_ms=None))
    for impl, name, line in (("fused_dequant", "dequant_matmul", 110),
                             ("lns", "lns_matmul", 62)):
        k = hybrid[impl]
        kernels.append(dict(
            name=f"{name}_static_weights_jamba", route="cuda",
            source=src + "lns_matmul.cu",
            replaces=f"src/repro/kernels/lns_matmul.py:{line}",
            launches=k["launches"], max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    for impl, name, line, launches in (
            ("lns", "lns_matmul", 62, ssm_trained["launches"]),
            ("fused_dequant", "dequant_matmul", 110,
             ssm_plain["k2_launches"]),
            ("lns_loop", "lns_loop_matmul", 91, ssm_k4["launches"])):
        k = ssm_train_k[impl]
        kernels.append(dict(
            name=f"{name}_train_mamba2", route="cuda",
            source=src + "lns_matmul.cu",
            replaces=f"src/repro/kernels/lns_matmul.py:{line}",
            launches=launches, max_abs_err=k["err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
