#!/usr/bin/env python3
"""Build and run the PyTorch port of ECORE (``src/repro_torch``) on one
NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   started together);
3. the Canny kernel against its plain PyTorch version on the card, exact
   equality, on the geometries of the JAX package's Canny tests, frames
   one pixel past one tile, a >4096-wide frame, the gateway's batches
   (32, 64, 256) and Figs. 6-8's whole streams (250, 300) of 64x64
   frames, 1080p, 4K and a ragged batch (frames that fit one tile among
   them);
4. the Sobel kernel against its plain version: magnitude within 1e-5 and
   at least 99.9 % of directions equal (the unequal ones counted), on both
   its 16-byte and its scalar path, ragged widths and heights down to 1;
5. the detection gateway's main path through ``Gateway.process_stream``
   on 256 scenes, scanned closed loop and batched open loop, with every
   kernel launch count set to 0 just before each path and read just after;
6. the same 64-scene scanned episode on the GPU and on the CPU: equal
   decisions and pair histograms;
7. kernel and plain-version times (CUDA events: the median of 20 samples,
   each 10 back-to-back calls), and each kernel's device time from the
   profiler (Sobel's also as a share of its byte bound);
8. the flash-attention kernel against its plain version (atol 2e-5 in f32,
   2e-2 in bf16, rtol 1e-2; bf16 also against the plain version in f32
   within the output's rounding, 2^-8 relative, plus 1e-4): MQA, GQA and
   MHA, D = 32, 64, 128 and 256 (recurrentgemma-2b's 10 heads over one KV
   head), f32 (CUDA cores) and bf16 (tensor cores), no mask beyond
   causal, window 64, softcap 30 and both, ragged S, granite-moe-1b-
   a400m's prefill in phase 30 (8, 16, 8, 256, 64), every attention
   model of the default pool at the serve driver's prompts (S = 32, 48),
   and phases 33-35's prefills with their own options: gemma2-9b's (1,
   16, 8, 6144, 256) with softcap 50, windowed 4096 and not, deepseek-7b's
   (8, 32, 32, 1024, 128), llama3-8b-swa's (1, 32, 8, 12288, 128) with
   window 4096, and phase 40's llava-next-34b (4, 56, 8, 3904, 128) over
   its prefix and text (the plain version one KV head's group at a time
   where its scores would pass 4 GiB); then without the causal mask:
   phase 42's whisper-small (8, 12, 12, S, 64) over its 1500 frames
   (encoder: S = 1500; cross-attention: S = 128) beside its causal
   decoder self-attention, and GQA, D = 32, 64, 128 and 256, ragged S and
   T, S < T and S > T, window and softcap;
9. the flash-decode kernel against its plain version at the same bar, with
   lengths 1, T and random, T not a multiple of 256, groups up to 10 at
   D = 256, granite-moe-1b-a400m's (8, 16, 8) at D = 64 over phase 30's
   272-row caches, every attention model of the default pool over the
   serve driver's caches (32 and 48 prompt rows plus 8), and phases
   33-35's: gemma2-9b's (2, 16, 8) at D = 256 over its 4096-row ring and
   6160 global rows with softcap 50, deepseek-7b's (8, 32, 32) at D = 128
   over 1040 rows, llama3-8b-swa's (1, 32, 8) over its 4096-row ring,
   llava-next-34b's (4, 56, 8), G = 7, over 3920 rows, and whisper-small's
   (8, 12, 12) at D = 64 over its 1500 frames (cross-attention) and its
   144-row self cache;
10. the LLM face's main path at full published width and half depth
    (both serve at full depth in phase 31): ``EcoreService``
    over ``PoolPolicy(ServingPool(δ=10))`` with qwen2.5-3b and llama3-8b
    backends (seeded random weights, bf16), 8 requests of 256 tokens and 8
    of 1024, 16 new tokens each, with both attention kernels' launch
    counts set to 0 just before and read just after; then, outside that
    run, where each backend's device time goes (profiler), and its decode
    step per token with the decode kernel's cache split and in one piece;
11. a two-layer llama3-8b at full width in f32 on the GPU (the kernels)
    and on the CPU (their plain versions), same parameters: logits within
    1e-3 and equal tokens;
12. attention kernel, plain-version and ``scaled_dot_product_attention``
    times at the main path's shapes (llama3-8b's, qwen2.5-3b's,
    recurrentgemma-2b's, granite-moe-1b-a400m's, and phases 33-35's:
    gemma2-9b's (2, 16, 8, 6144, 256) local layers and its decode over the
    ring and the global rows, where the library has no softcap,
    deepseek-7b's, llama3-8b-swa's at 12288 tokens under window 4096, its
    flash bound reckoned from the windowed keys, phase 40's
    llava-next-34b (4, 56, 8, 3904, 128) and its decode over 3920 rows,
    and phase 42's whisper-small: flash without the causal mask over its
    1500 frames from 1500 and from 128 query rows, its causal 128-row
    prompt, the library unmasked or ``is_causal`` alike, and the decode
    kernel over all 1500 frames),
    flash's achieved TFLOP/s beside the library's, flash's device time at
    llama3-8b's, deepseek-7b's and llava-next-34b's shapes with K/V laid
    out as the model's prefill passes them (views of [B, S, KV, D]), the
    decode kernel's split sizing (its blocks against the SMs) against one
    piece and against splits sized from the whole cache, the decode
    wrapper's and the library's host microseconds a call (200
    back-to-back calls without a sync) and the library's device time
    beside its call time, and both kernels against their plain versions
    computed in f32 (within the bf16 rounding of the output, 2^-8
    relative, plus 1e-4);
13. the SSD scan kernel against its plain version: at the JAX tests'
    shapes and chunks and a ragged S, y and the final state within atol
    2e-4, rtol 1e-3 in f32 (CUDA cores), and in bf16 (tensor cores) y
    within the bf16 bar below; at mamba2-370m's (8, 500, 32, 64, 128),
    chunk 256,
    the f32 kernel and the f32 plain version against the plain version in
    f64 (the kernel's error at most twice the plain version's own), and
    the bf16 kernel within one bf16 ulp of the f32 plain version plus
    that f32 bar;
14. the LLM face's main path with the ssm family: ``EcoreService`` over
    ``PoolPolicy(ServingPool(δ=18.5))`` with qwen2.5-3b, llama3-8b and
    mamba2-370m backends at full width and half depth (both serve at full
    depth in phases 30 and 31), 8 requests of 500 tokens (to mamba2-370m)
    and 8 of 1024 (to qwen2.5-3b), 16 new tokens each, with all three LLM
    kernels' launch counts set to 0 just before and read just after (one
    SSD launch per layer per mamba2 batch);
15. a two-layer mamba2-370m at full width in f32 on the GPU and on the
    CPU, same parameters, a 500-token prompt: logits within 1e-3 and equal
    tokens;
16. SSD kernel and plain-version times at mamba2-370m's prefill shape
    against the kernel's bound, with the device time of each of its three
    bf16 passes (no PyTorch call computes the scan);
17. the RG-LRU scan kernel against its plain version: at the JAX tests'
    shapes (1, 16, 128) and (2, 33, 256) and at W = 200 and 1000, with and
    without h0, within atol 1e-5; at recurrentgemma-2b's (8, 1024, 2560) in
    f32, with a and b drawn by the gates (Lambda from lam in [0.9, 0.999]),
    the kernel's error against the plain version in f64 at most twice the
    f32 plain version's own;
18. the LLM face's main path with the hybrid family: ``EcoreService`` over
    ``PoolPolicy(ServingPool(δ=10))`` with qwen2.5-3b, llama3-8b,
    mamba2-370m and recurrentgemma-2b backends at full width and half
    depth (all four serve at full depth in phase 31), 8 requests
    of 256 tokens (to qwen2.5-3b) and 8 of 1024 (to recurrentgemma-2b), 16
    new tokens each, with every LLM kernel's launch count set to 0 just
    before and read just after (one RG-LRU launch per recurrent layer per
    batch, one flash per attention layer, global or local, one decode per
    attention layer per step); then where recurrentgemma-2b's device time
    goes (profiler; qwen2.5-3b's 8 x 256 batch is phase 10's);
19. recurrentgemma-2b cut to five layers (one block and the trailing pair)
    at full width in f32 on the GPU and on the CPU, same parameters, a
    1024-token prompt: logits within 1e-3 and equal tokens;
20. RG-LRU kernel and plain-version times at recurrentgemma-2b's prefill
    shape against the kernel's bound (no PyTorch call computes the
    recurrence);
21. the paper's routing comparison on the card: one
    ``Gateway.process_stream`` over phase 5's detectors and 256 scenes
    (open loop, the thermal drift, δ = 5, batches of 32) for each of
    {ED, SF, OB, GT} x {Algorithm 1, ``WeightedRouter``, ``ParetoRouter``}
    and RR, Rnd (seed 0), LE, LI, HM, HMG and the oracle, with the Canny
    launch count set to 0 just before each row and read just after (every
    ED row launches it), SF's detector and the profile state on the card,
    every histogram summing to 256; the first 64 scenes of every row again
    on the CPU with equal decisions (SF's may differ only on a frame where
    its detector's objectness crosses 0.5 between the two, OB's on the
    frame after one where a backend's does; the objectness itself within
    atol 1e-6 + rtol 1e-5); SF's call and device time on 32 frames;
22. ``EcoreService(max_wait_ms=5)`` with its flusher thread on the real
    clock over detector backends on the card: 24 requests in groups of 3
    (max_batch 8) all served by deadline flushes, their pairs equal and
    their detections within the detector tests' bar of the same 24 served
    at once; then the same through ``AsyncEcoreService`` under
    ``asyncio.run``; every wait bounded by 10 s;
23. the fault storm of ``tests/test_faults.py`` (errors at rate 0.4,
    10 s stalls at 0.3, a crash window over a fifth of the uids, on
    orin_nano) over 400 requests to faulty detector backends on the card:
    ``ResilientService`` (deadline 500 ms, 3 retries, oracle routing at
    δ = 2, a fake clock) serves >= 99 % within the deadline and fails
    none, the bare ``EcoreService`` < 50 %, and every uid's outcome (pair,
    attempts, exception) equals the same storm on the CPU;
24. the cluster plane: ``select_pods`` on the card equal to the scalar
    reference over bench_cluster's 2048 uids (4 and 6 pods, both shard
    modes, with and without pod 1 dead) and the µs a request of both; an
    ``EcoreCluster`` of 4 pods (ED and Algorithm 1 at δ = 5 in each,
    phase 5's detectors, ``max_batch`` 8) over the 256 scenes through
    ``submit_batch`` in each shard mode, with the Canny launch count set
    to 0 just before and read just after (one launch per pod with a
    shard), every uid's pod the reference's pick and the first 64 scenes'
    (pod, pair, estimate) equal to the same cluster on the CPU;
    degradation (3 pinned pods, ``pod_fail_after=2``, pod 0's device down):
    at most one failure, pod 0 masked, requests resubmitted, uid-keyed
    observations in the pods that served; and, a finding without a bar,
    the requests per second at 1, 2 and 4 pods with the real detectors
    and in bench_cluster's setting (48 requests, ``realtime_scale=1``);
25. the traffic plane: ``BENCH_gateway.json`` entry [9] (bench_load's
    four open-loop runs on the manual clock through a 2-to-6-pod cluster)
    replayed through the port and equal to the file (integers exactly,
    floats within 1e-12 relative); then a 1 s flash crowd of rendered
    scenes whose autoscaled pods run ED per request and the detectors on
    the card: one Canny launch per request (counted), none failed, and
    the SLO summary, window records and autoscaler events equal to the
    same replay on the CPU; its wall time and the device's busy share;
26. the trained testbed: the eight detectors trained on the card,
    ``TRAIN_STEPS`` AdamW steps of 16 fresh scenes (half the reference's
    run)
    into a fresh
    directory under ``chiprun_out/`` (cuDNN's deterministic algorithms,
    so the testbed repeats run to run; ``tools/training_probe.py``
    measures that, a step's device time and the host's share), every loss
    falling, saved in the JAX package's checkpoint layout and loaded back
    through ``train_all`` (raw heads bit-equal); ``adamw_update`` on the
    card equal to the CPU's bit for bit on yolov8_m's parameters and on
    phase 44's models' trees (reduced) with the LM step's decay rule
    (``ADAMW_LM_ARCHS``);
    ``profile_pairs`` over ``TESTBED_PAIRS`` on the card and on the CPU
    (time and energy equal, mAP equal but where a frame of the group puts
    an objectness within atol 1e-6 + rtol 1e-5 of 0.5); the paper's router
    matrix (Orc, RR, Rnd, LE, LI, HM, HMG, ED, SF, OB) at δ = 5 over Figs.
    6-8's datasets and the oracle at δ = 0, 10, 100, one CSV row each, the
    Canny launches of the ED rows counted, each row's first 64 scenes
    equal to the CPU's under phase 21's rule, ``tests/test_system.py``'s
    relations held, and ED's savings against HMG printed as a finding;
27. the Canny kernel against its plain version, exact equality, at every
    (shape, ragged or not, thresholds) at which phases 5 and 21-26
    launched it, on the input that launch was given (the first of each);
28. granite-moe-1b-a400m cut to two layers at full width in f32 on the GPU
    and on the CPU, same parameters, a 256-token prompt: logits within
    1e-3 and equal tokens (the card's MoE form against the CPU's);
29. one granite MoE layer at full width on the card in bf16 against the
    same layer in f32, on one input, at T = 2048 and T = 8: the same
    experts, the largest per-token relative error within 2^-6; the layer's
    time beside the sorted form's;
30. the completed default pool: all five models of ``DEFAULT_POOL`` built
    at full width with seeded bf16 weights in one process, then
    ``EcoreService`` over ``PoolPolicy(ServingPool(δ=23))``: 8 requests
    of 256 tokens (to granite-moe-1b-a400m) and 8 of 1024 (to
    mamba2-370m), 16 new tokens each, every LLM kernel's launch count set
    to 0 just before and read just after (24 flash launches per granite
    batch, 24 decode launches per step); then granite's serve_batch under
    the profiler (its MoE layers' share of the device time), the host
    syncs of one of its decode steps and its prefill with every MoE layer
    on each form in turns;
31. the serve driver, ``repro_torch.launch.serve.main(argv)`` with
    ``--device cuda`` at full published width (prompts capped at 48, 8
    new tokens), nine runs, every LLM kernel's launch count set to 0 just
    before each and read just after, device memory printed before and
    after each: (a) 24 requests at δ = 5 (llama3-8b, recurrentgemma-2b);
    (b) ``--adapt --profile-out`` at δ = 23, 48 requests in batches of up
    to 4 (granite-moe-1b-a400m, mamba2-370m): the profile read back, finite,
    and an arch's entries moved exactly when one of its batches ran slower
    than the fastest earlier batch of its shape; (c) ``--pods 4`` at δ = 5
    in each shard mode: every uid served once, the shards summing to 24,
    one parameter set per arch shared by the pods and the peak within one
    copy of the weights plus 4 GiB; (d) ``--async`` at δ = 18.5
    (mamba2-370m, qwen2.5-3b); (e) ``--rate 20 --duration 2 --pattern
    flash --pods 2 --max-wait-ms 25`` at δ = 10 (qwen2.5-3b,
    recurrentgemma-2b): window records and summary equal to the same argv
    with ``--device cpu --reduced`` (integers exactly, floats within 1e-12
    relative), the card's measured lines beside them; (f) ``--archs
    deepseek-7b gemma2-9b-swa --requests 16`` at δ = 5 (bucket 4 to
    gemma2-9b-swa, the rest to deepseek-7b); (g) ``--archs
    deepseek-v2-lite-16b llama3-8b --requests 16`` at δ = 12.4 (bucket 0
    to deepseek-v2-lite-16b, the rest to llama3-8b); (h) ``--archs
    whisper-small llama3-8b --requests 16`` at δ = 25.8 (bucket 0 to
    whisper-small, the rest to llama3-8b).  In (a) and (c)-(h) every
    decision equals the same policy's on the CPU; the runs serve all five
    models of the default pool and both of (f), (g) and (h), launch all
    four LLM kernels, and leave device memory within 1 GiB of its level
    before the phase;
32. the examples through their ``main(argv)`` on the card: ``quickstart``
    and ``video_stream`` over phase 26's testbed (its checkpoints and
    profile), every histogram summing to its scenes, the ED rows' Canny
    launches counted and held to the plain version on their inputs, bit
    for bit; ``service_quickstart`` at full width (qwen2.5-3b and
    mamba2-370m) with routes equal to the CPU policy's; ``async_cluster``
    and ``load_test`` printing what they print with ``--device cpu``
    (``serve_pool`` is the driver of phase 31);
33. gemma2-9b cut to two layers (one local, one global: post-norms, both
    softcaps) and deepseek-7b cut to two layers, at full width in f32 on
    the GPU and on the CPU, same parameters, a 256-token prompt and 8
    decode steps: logits within 1e-3 and equal tokens;
34. the sliding-window ring on the card: llama3-8b-swa cut to two layers
    at full width in f32, a 4608-token prompt into rings of 4096 rows and
    16 decode steps (the ring wraps in prefill and again in decode), each
    step's logits within 1e-3 of ``forward`` over the sequence so far on
    the card (its windowed flash reads the same key set), argmax equal;
35. the rest of the dense family in one service: deepseek-7b, gemma2-9b
    and llama3-8b-swa built at full width (~48 GB of bf16 weights) after
    phase 32 released its memory, ``EcoreService`` over
    ``PoolPolicy(ServingPool(δ=0.02))``: 8 x 1024 tokens to deepseek-7b
    (complexity 512), 2 x 6144 to gemma2-9b (its window bites in prefill
    and its rings wrap), 1 x 12288 to llama3-8b-swa at max_seq 4096
    (complexity 40 000; a prompt three times its rings), 16 new tokens
    each, every LLM kernel's launch count set to 0 just before and read
    just after; then llama3-8b-swa's cache bytes beside a position-ordered
    cache's;
36. deepseek-v2-lite-16b (MLA, 64 experts top-6) cut to two layers at
    full width in f32 on the GPU and on the CPU, same parameters, 2 x 256
    tokens and 8 decode steps: logits within 1e-3 and equal tokens (MLA
    and the MoE run in plain PyTorch: no kernel launch);
37. one MoE layer at full width in bf16, deepseek-v2-lite-16b's at T =
    8192, 8, 256 and 512 and granite-moe-1b-a400m's at 2048, 8 and 8192:
    the every-expert
    form against the sorted form (grouped products, no host read), times,
    the form ``moe_ragged`` takes, both within 2^-6 of the f32 layer;
38. deepseek-v2-lite-16b at full depth (~30 GiB of bf16 weights) beside
    llama3-8b in one service at δ = 12.4: 8 x 1024 tokens to each
    (complexities 512 and 1024), 16 new tokens, routes equal to the CPU
    policy's, launches counted (llama3-8b's only), the peak device memory,
    the host syncs of one deepseek-v2-lite decode step, its prefill with
    every MoE layer on each form in turns, device memory back within 1 GiB
    after;
39. llava-next-34b cut to two layers at full width in f32 on the GPU and
    on the CPU, same parameters, one prompt of 2880 prefix embeddings
    (``modality_inputs``, seeded) and 32 tokens, 4 decode steps: logits
    within 1e-3, equal tokens, flash and decode launches counted;
40. llava-next-34b at full depth (~63 GiB of bf16 weights) beside
    mamba2-370m in one service at δ = 20: 4 x 1024 text tokens to llava
    (complexity 1024), each behind its 2880 prefix embeddings (max_seq
    3920), 8 x 512 to mamba2-370m (complexity 512), 16 new tokens, routes
    equal to the CPU policy's, 60 flash and 60 x 15 decode launches for
    llava's batch, the peak device memory under the card's, device memory
    back within 1 GiB after;
41. whisper-small cut to two encoder and two decoder layers at full width
    in f32 on the GPU and on the CPU, same parameters, 1500 frames
    (``modality_inputs``, seeded), 2 x 32 tokens and 8 decode steps:
    logits within 1e-4, equal tokens, the flash launches without the
    causal mask counted (one per encoder layer, one per decoder layer's
    cross-attention);
42. whisper-small at full depth (0.44 GiB of bf16 weights) beside
    llama3-8b in one service at δ = 25.8: 8 x 128 tokens to whisper-small
    (complexity 512), each with its 1500 frames, 8 x 1024 to llama3-8b
    (complexity 1024), 16 new tokens, routes equal to the CPU policy's,
    the peak device memory; then whisper-small's batch again with the
    counts at 0 (36 flash launches: 12 encoder, 12 self, 12 cross; 360
    decode: 12 self and 12 cross a step), its prefill's encoder and
    decoder apart, and the host syncs of both backends' decode steps;
    device memory back within 1 GiB after.  The serve driver's run (h), ``--archs
    whisper-small llama3-8b --delta 25.8 --requests 16``, is phase 31's;
43. the flash backward kernel (``csrc/flash_attention_bwd.cu``) against
    its plain backward computed in f64 on the card (``FLASH_BWD``:
    qwen2.5-3b's training batch in bf16 and f32, llama3-8b's prefill,
    gemma2-9b's windowed softcapped D = 256 layer, whisper-small's encoder
    and cross-attention, D = 64 at G = 1 with a ragged S in f32 and bf16,
    D = 32 in bf16, recurrentgemma-2b's local layer over a 4096-token
    training sequence, G = 10): within four times the f32 plain backward's
    own error
    (plus bf16's rounding), equal bits in two calls, and the kernel's (the
    dQ and dK/dV kernels' device times apart), the plain backward's and
    ``scaled_dot_product_attention``'s backward times beside the bound;
44. one training step on the card against the CPU, f32 activations, TF32
    off, from the same f32 masters: qwen2.5-3b cut to two layers and
    whisper-small to 2 + 2 (2 x 32 tokens), mamba2-370m cut to two layers
    (2 x 288 tokens: the gradient crosses a chunk boundary into a ragged
    chunk), recurrentgemma-2b to its trailing (rec, rec) pair,
    granite-moe-1b-a400m, deepseek-v2-lite-16b (MLA and MoE) and
    llava-next-34b (its prefix cut to ``LLAVA_TRAIN_PREFIX`` embeddings)
    to two layers (2 x 32 tokens), at full width: the loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest |value|, the
    MoE cuts' expert ids equal (the card's every-expert form, the CPU's
    sorted form), each kernel's forward and backward launches counted by
    layer kind (flash a attention layer, SSD an ssm layer, RG-LRU a rec
    layer; the published configs' ``remat`` runs each forward twice, its
    recompute inside the backward, but whisper-small's), and
    ``make_train_step``'s metrics, moments and updated
    parameters at the same bars (the CPU step's update applied on the card
    to a copy of its masters; phase 26 holds that update equal to the
    CPU's bit for bit on these models' trees); qwen2.5-3b again over 4 x
    32 tokens in two micro-batches; then granite-moe-1b-a400m's two layers
    in bf16 over 2 x 2048 tokens, the sorted MoE form and its grouped
    products' backward on the card, the CPU on the card's experts, at the
    bf16 gradient bar (``moe_bf16_train_step``);
45. ``launch/train.py`` on qwen2.5-3b at full width and depth (``--full
    --steps 10 --batch 8 --seq 128 --device cuda``, as a user calls it):
    every loss finite, the mean of the last five below the first five's,
    72 flash forward (each layer's, and its recompute under remat) and 36
    backward launches a step (the counts at 0 just before the run and
    read just after), the step time, tokens/s, the peak device memory and
    the host syncs of each step;
46. the SSD and RG-LRU backward kernels (``csrc/ssd_scan_bwd.cu``,
    ``rglru_scan_backward`` in ``csrc/rglru_scan.cu``) against their plain
    backwards computed in f64 on the card (``SSD_BWD``: mamba2-370m's
    training shape in bf16 and f32, a ragged S with a nonzero final-state
    gradient, the JAX tests' shapes at chunks 8 and 16, column views at
    an odd offset; ``LRU_BWD``: recurrentgemma-2b's width with and
    without h0, a width that is not a multiple of 64) at phase 43's bar,
    equal bits in two calls, the RG-LRU kernel equal to its f32 plain
    backward, the SSD's dA (d a_cum's f64 sums of T) nearer f64 than the
    f32 plain backward's at the 256-row chunks in bf16 and f32; each
    kernel's call and device time (the SSD's six kernels apart), the
    plain backward's time and the bound at the training shape;
47. ``launch/train.py`` at full width and depth on mamba2-370m (``--steps
    10 --batch 8 --seq 512``) and then, its memory released,
    recurrentgemma-2b (``--steps 10 --batch 8 --seq 128``): every loss
    finite and falling, each kernel's backward launches one per layer of
    its kind a step and its forward two (remat), the step time, tokens/s,
    the peak device memory and the host syncs of each step;
48. the dry run on the card (``repro_torch.launch.dryrun.main``,
    ``DRYRUN_CALLS``): the five models of the default pool at full width
    and depth at ``prefill_32k`` (batch 1) and ``decode_32k`` (the batch
    that fits 3/4 of the card), mamba2-370m at ``train_4k`` and
    ``long_500k``, granite-moe-1b-a400m, whisper-small, qwen2.5-3b and
    recurrentgemma-2b at ``train_4k`` (a training row runs the
    reference's 4, 8 or 16 micro-batches of one sequence, rematerialised
    but whisper-small's, its peak within 2 % + 0.5 GiB of the skip rule's
    count, the step's peak on the meta device),
    llama3-8b's ``long_500k`` skip row; each
    kernel's launches counted per call and held to the rows' layers
    (the warm-up, which is counted, and ``DRYRUN_REPS`` = 1 timed step a
    row, a
    training row's once a
    micro-batch, twice in the forward under remat); one line a row
    (batch, counted
    operations and bytes, each roofline term, t_step, the measured step
    and their ratio, at most ``ROOFLINE_SHARE_MAX``, peak memory,
    energy); each kernel held to its plain version at every shape and
    option its rows launched it at (``MainPathShapes``: flash at 32 768
    rows, decode over 32 768 cache rows, the SSD at 4096 and 32 768
    tokens, the RG-LRU at 32 768 and 4096), and the flash, SSD and RG-LRU
    backward kernels at every shape the training rows launched them at
    (granite's and qwen2.5-3b's 4096 rows, recurrentgemma-2b's windowed
    4096 rows and its RG-LRU over 4096 tokens, whisper-small's 4096
    decoder rows, its encoder's 1500 frames and the cross-attention over
    them, mamba2-370m's 4096 tokens) at phases 43's and 46's bars, on
    seeded inputs, the plain versions
    run by pieces (``flash_plain_rows``, the SSD a group of heads at a
    time);
    the counts of seven reduced combinations (``DRYRUN_SAME``: prefill,
    decode and training, two training steps under remat) equal on the
    card and the CPU.  Then
    phase 31's run (i): the serve driver on phase 48's rows
    (``--dryrun-mesh 1x1 --requests 24 --delta 5``), over the 5 backends,
    its routes equal to the CPU policy's over the same rows and printed
    beside run (a)'s on the analytic profile;
49. ``launch/train.py`` on granite-moe-1b-a400m at full width and depth
    (``MOE_TRAIN_ARGV``: 10 steps of 8 x 512 tokens, so every MoE layer
    runs the sorted form and its backward): the checks of phases 45 and
    47 (48 flash forward and 24 backward launches a step), the sorted
    form 480 times (forward and recompute) and 1440 grouped products under
    autograd on the card; the flash kernel and its backward held to their
    plain versions at the run's shapes (``MainPathShapes``, phase 43's bar
    for the backward); then one loss and gradient at that size with and
    without remat from the same masters (``moe_remat_against_kept``):
    expert ids equal in the forward, its recompute and the kept run, the
    gradients bit for bit or within ``REMAT_BAR`` (3.5e-2 of a leaf's
    largest |value|: the head's chunks against one product).
50. The production mesh of the dense family (``mesh_phase``): (a) the
    1x1 mesh over NCCL bit for bit against the unsharded path
    (llama3-8b's prefill and 8 decode steps at full width and depth,
    qwen2.5-3b's training step at phase 45's 8 x 128; the kernels at the
    shapes these mesh runs launched them at against their plain
    versions); (b) llama3-8b's
    decode_32k cache of a card in 16 sequence shards through the decode
    kernel with its softmax statistics, merged by the reference's
    formula, against one call over the whole, and the statistics against
    ``ref.py``'s; (d) the dry run's mesh rows in processes of their own,
    side by side, under the fake process group: the train_4k rows of the
    five dense archs one card skips and llama3-8b's prefill_32k and
    decode_32k at 16 x 16, llama3-8b's prefill_32k at 2 x 16 x 16, each
    ``ok`` with its collective term and rank 0's peak under 3/4 of the
    card, its flash and decode launches (counted in its process, forward
    and backward) equal to its layers times its steps, read back by the
    pool table's default mesh; (c) the flash kernel and its backward, and
    the decode kernel with its statistics, at every shape (d)'s rows
    launched them at (recorded in their processes: rank 0's heads of a
    16-way 'model' axis, e.g. llama3-8b 2 over 1 KV head, gemma2-9b 1 over
    1 at D 256, window 4096, softcap 50, and its sequence shard of the
    decode cache) against the plain versions.

Phases 10, 14, 18, 30, 35, 38, 40 and 42 also hold every route to the
same policy's decision on the CPU.  It then prints one JSON line with
every kernel (the LLM kernels' launches summed over the services of
phases 10, 14, 18, 30, 31, 35, 38, 40 and 42, the training runs of
phases 45, 47 and 49, the dry run of phase 48, phase 50 (a)'s mesh
runs and (d)'s rows; the backward kernels' from phases 45, 47, 48, 49 and
50 (d)), the card
line, and last ``{"ok": true, "device": {...}}``.
It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
T_START = time.perf_counter()

#: the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s and
#: f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

#: dense bf16 tensor-core FLOP/s of the same data sheet
BF16_FLOP_PER_S = 989e12

#: the dense members of launch/serve.py's default pool, and dispatch settings
LLM_ARCHS = ("qwen2.5-3b", "llama3-8b")
MAX_BATCH, MAX_SEQ, MAX_NEW = 8, 1280, 16
#: prompt length -> the backend Algorithm 1 picks at δ = 10: in bucket 0
#: qwen2.5-3b's capability 62.33 is within 10 of llama3-8b's capped 72.0;
#: in bucket 1 llama3-8b's 72.86 is not
ROUTES = {256: "qwen2.5-3b", 1024: "llama3-8b"}
#: the default pool up to its first unported member, and the routes at
#: δ = 18.5: mamba2-370m's 54.0 is within δ of bucket 0's 72.0, not of
#: bucket 1's 72.86, where qwen2.5-3b is the cheapest within δ
SSM_ARCHS = LLM_ARCHS + ("mamba2-370m",)
SSM_DELTA = 18.5
SSM_ROUTES = {500: "mamba2-370m", 1024: "qwen2.5-3b"}
#: the SSD scan at mamba2-370m's prefill: (batch, S, heads, head dim,
#: state) and its chunk
SSD_SHAPE, SSD_CHUNK = (MAX_BATCH, 500, 32, 64, 128), 256
#: the default pool without its only unported member, and the routes at
#: δ = 10: in bucket 0 qwen2.5-3b (62.33) is the cheapest within 10 of
#: llama3-8b's capped 72.0; in bucket 1 it misses 72.86 by 0.53 and
#: recurrentgemma-2b (63.31) is the cheapest within δ
HYBRID_ARCHS = SSM_ARCHS + ("recurrentgemma-2b",)
HYBRID_ROUTES = {256: "qwen2.5-3b", 1024: "recurrentgemma-2b"}
#: the RG-LRU scan at recurrentgemma-2b's prefill: (batch, S, lru width)
LRU_SHAPE = (MAX_BATCH, 1024, 2560)
#: the completed default pool (launch/serve.py's DEFAULT_POOL) and the
#: routes at δ = 23: granite-moe-1b-a400m's 49.58 is within δ of bucket 0's
#: capped 72.0 and the cheapest there; in bucket 1 it misses 72.86 by more
#: than δ and mamba2-370m (54.03) is the cheapest within δ
GRANITE = "granite-moe-1b-a400m"
POOL_DELTA = 23.0
POOL_ROUTES = {256: GRANITE, 1024: "mamba2-370m"}
#: the serve driver's prompts (its PROMPT_CAP and the shorter length its
#: workload draws) and its default new tokens
DRIVER_PROMPTS, DRIVER_NEW = (32, 48), 8
#: phase 35: three of the rest of the dense family and the routes at
#: δ = 0.02.  Bucket 0 is capped at 72.0 for all three, so deepseek-7b, the
#: cheapest, takes it; in buckets 1-3 gemma2-9b's 72.90 is the best and
#: llama3-8b-swa's 72.86 misses it by 0.041, so gemma2-9b is the only pick
#: within δ; in bucket 4 llama3-8b-swa, sub-quadratic, keeps 72.86 where
#: the others lose 6.  Each complexity -> (prompt tokens, batch): routing
#: sees the complexity, the backend the prompt (deepseek-7b's bucket-0
#: requests carry 1024 tokens; llama3-8b-swa's 40 000-token request is
#: capped at 12 288, three times its 4096-row ring)
DENSE_ARCHS = ("deepseek-7b", "gemma2-9b", "llama3-8b-swa")
DENSE_DELTA = 0.02
DENSE_ROUTES = {512: "deepseek-7b", 6144: "gemma2-9b",
                40_000: "llama3-8b-swa"}
DENSE_BATCHES = {512: (1024, 8), 6144: (6144, 2), 40_000: (12_288, 1)}
#: each backend's max_seq: the global layers' prompt + 16 new tokens;
#: llama3-8b-swa's 4096 sizes its rings at the window
DENSE_MAX_SEQ = {"deepseek-7b": 1040, "gemma2-9b": 6160,
                 "llama3-8b-swa": 4096}
#: (B, H, KV, S, D) and the options of the flash kernel on phases 33-35's
#: and 40's path (gemma2-9b's local and global layers, deepseek-7b,
#: llama3-8b-swa, llava-next-34b's prefix and text), then the decode
#: kernel's over their caches: gemma2-9b's ring of 4096 rows (no window:
#: every ring row is in the key set) and its global rows, deepseek-7b's,
#: llama3-8b-swa's ring, llava-next-34b's (56 heads over 8 KV heads: G = 7)
DENSE_FLASH = (((1, 16, 8, 6144, 256), {"window": 4096, "softcap": 50.0}),
               ((1, 16, 8, 6144, 256), {"softcap": 50.0}),
               ((8, 32, 32, 1024, 128), {}),
               ((1, 32, 8, 12_288, 128), {"window": 4096}),
               ((4, 56, 8, 2880 + 1024, 128), {}))
DENSE_DECODE = (((2, 16, 8, 4096, 256), {"softcap": 50.0}),
                ((2, 16, 8, 6160, 256), {"softcap": 50.0}),
                ((8, 32, 32, 1040, 128), {}),
                ((1, 32, 8, 4096, 128), {}),
                ((4, 56, 8, 3920, 128), {}))
#: phase 38: deepseek-v2-lite-16b (MLA, 64 experts top-6) beside
#: llama3-8b at δ = 12.4.  deepseek-v2-lite's capability is 60.05 in
#: buckets 0-3; bucket 0 is capped at 72.0, so it is within δ there and the
#: cheaper; in bucket 1 llama3-8b's 72.86 is not within δ of it.  Each
#: complexity -> (prompt tokens, batch), as phase 35 splits them
DSV2 = "deepseek-v2-lite-16b"
MLA_ARCHS, MLA_DELTA = (DSV2, "llama3-8b"), 12.4
MLA_ROUTES = {512: DSV2, 1024: "llama3-8b"}
MLA_BATCHES = {512: (1024, 8), 1024: (1024, 8)}
#: phase 40: llava-next-34b beside mamba2-370m at δ = 20: mamba2-370m's
#: 54.03 is within δ of bucket 0's capped 72.0, not of llava's 78.0 in
#: bucket 1.  llava takes 4 x 1024 text tokens, each behind its 2880 prefix
#: embeddings, and a cache of 2880 + 1024 + 16 rows
LLAVA = "llava-next-34b"
VLM_ARCHS, VLM_DELTA = (LLAVA, "mamba2-370m"), 20.0
VLM_ROUTES = {512: "mamba2-370m", 1024: LLAVA}
VLM_BATCHES = {512: (512, 8), 1024: (1024, 4)}
VLM_MAX_SEQ = 2880 + 1024 + 16
#: phase 42: whisper-small beside llama3-8b at δ = 25.8: whisper-small's
#: 46.58 in buckets 0-3 is within δ of bucket 0's capped 72.0, not of
#: llama3-8b's 72.86 in bucket 1.  Each complexity -> (prompt tokens,
#: batch), as phase 35 splits them; whisper's cache holds the prompt and
#: the new tokens (its 1500 frames feed the encoder)
WHISPER = "whisper-small"
ENCDEC_ARCHS, ENCDEC_DELTA = (WHISPER, "llama3-8b"), 25.8
ENCDEC_ROUTES = {512: WHISPER, 1024: "llama3-8b"}
ENCDEC_BATCHES = {512: (128, 8), 1024: (1024, 8)}
#: (B, H, KV, S, T, D) and the options of the flash kernel on phase 42's
#: path: whisper-small's encoder over its 1500 frames, its prompt's
#: cross-attention over them (not causal) and its causal self-attention;
#: then the kernel's other cases without the causal mask: GQA, D = 32, 64,
#: 128 and 256, ragged S and T, S < T and S > T, window and softcap (every
#: row keeps some column)
ENCDEC_FLASH = (((MAX_BATCH, 12, 12, 1500, 1500, 64), {"causal": False}),
                ((MAX_BATCH, 12, 12, 128, 1500, 64), {"causal": False}),
                ((MAX_BATCH, 12, 12, 128, 128, 64), {}))
NONCAUSAL_FLASH = (((2, 8, 2, 100, 300, 128), {}),
                   ((2, 4, 4, 37, 1500, 32), {}),
                   ((1, 10, 1, 300, 191, 256), {}),
                   ((2, 16, 8, 256, 200, 64), {"window": 96}),
                   ((2, 8, 2, 64, 500, 128), {"softcap": 30.0}),
                   ((2, 8, 8, 129, 130, 64), {"window": 64,
                                              "softcap": 30.0}))

#: phase 43: the flash backward kernel, (label, (B, H, KV, S, T, D), dtype,
#: options): qwen2.5-3b's training batch (phase 45: 8 x 128 tokens) in bf16
#: and f32, llama3-8b's prefill shape, gemma2-9b's windowed softcapped
#: D = 256 layer at 2 x 6144, whisper-small's encoder over its 1500 frames
#: and its prompt's cross-attention over them (not causal), and D = 64 at
#: G = 1 with a ragged S (f32 and bf16), D = 32 (bf16, padded to 64
#: columns in the tensor-core kernels), and recurrentgemma-2b's local
#: layer over a 4096-token training sequence (10 heads on one KV head: a
#: dK/dV sum over 10 x 4096 rows)
FLASH_BWD = (("qwen2.5-3b", (8, 16, 2, 128, 128, 128), "bfloat16", {}),
             ("qwen2.5-3b", (8, 16, 2, 128, 128, 128), "float32", {}),
             ("llama3-8b", (2, 32, 8, 1024, 1024, 128), "bfloat16", {}),
             ("gemma2-9b", (2, 16, 8, 6144, 6144, 256), "bfloat16",
              {"window": 4096, "softcap": 50.0}),
             (f"{WHISPER} encoder", (8, 12, 12, 1500, 1500, 64), "bfloat16",
              {"causal": False}),
             (f"{WHISPER} cross", (8, 12, 12, 128, 1500, 64), "bfloat16",
              {"causal": False}),
             ("D 64, G 1, ragged S", (2, 8, 8, 777, 777, 64), "float32", {}),
             ("D 64, G 1, ragged S", (2, 8, 8, 777, 777, 64), "bfloat16", {}),
             ("D 32", (4, 16, 4, 512, 512, 32), "bfloat16", {}),
             ("recurrentgemma-2b train_4k", (1, 10, 1, 4096, 4096, 256),
              "bfloat16", {"window": 2048}))
#: phase 45: launch/train.py at full width and depth, as a user calls it;
#: 10 steps (the training phases' steps were cut from 20 when remat and
#: phase 48's two new rows brought the script to 949 s of its 1200)
TRAIN_ARGV = ["--arch", "qwen2.5-3b", "--full", "--steps", "10", "--batch",
              "8", "--seq", "128", "--device", "cuda"]
#: phase 49: the same for the MoE family: 8 x 512 = 4096 tokens a
#: forward, so T E d ff (6.87e10) reaches ``moe.SORTED_MIN_MACS`` and
#: granite's MoE layers run the sorted form and its backward (at 8 x 128
#: they would run the every-expert form)
MOE_TRAIN_ARGV = ["--arch", GRANITE, "--full", "--steps", "10", "--batch",
                  "8", "--seq", "512", "--device", "cuda"]
#: phase 49's bar on remat against kept, of each gradient leaf's largest
#: |value|: the gap is the head's chunks against one product over every
#: row (the layers' recompute is bit-exact; ``tools/remat_head_probe.py``
#: measured 2.97e-2 at ``blocks/s0/0/norm1`` on an H100 80GB HBM3, 700 W),
#: with a margin of a sixth; the bf16 bar it replaces was 6.25e-2
REMAT_BAR = 3.5e-2
#: phase 44's bf16 MoE step: 2 x 2048 tokens, the sorted form on the card
MOE_BF16_BATCH = (2, 2048)
#: phase 44's llava-next-34b prefix: 64 embeddings in place of 2880 (two
#: f32 layers over 2 x 2912 rows at d 7168 take minutes on the CPU side)
LLAVA_TRAIN_PREFIX = 64
#: phase 47: the same for the two state-space families
SCAN_TRAIN_ARGV = (["--arch", "mamba2-370m", "--full", "--steps", "10",
                    "--batch", "8", "--seq", "512", "--device", "cuda"],
                   ["--arch", "recurrentgemma-2b", "--full", "--steps", "10",
                    "--batch", "8", "--seq", "128", "--device", "cuda"])
#: phase 46: the SSD backward kernel, (label, (b, s, h, p, n), chunk, dtype,
#: options): mamba2-370m's training batch (phase 47: 8 x 512 tokens) in
#: bf16 and f32 with its A (-linspace(1, 16)), a ragged S with a nonzero
#: gradient of the final state, the JAX tests' shape and decays at chunks
#: 8 and 16, and x, B and C as column views at an odd element offset
SSD_BWD = (("mamba2-370m", (8, 512, 32, 64, 128), 256, "bfloat16", {}),
           ("mamba2-370m", (8, 512, 32, 64, 128), 256, "float32", {}),
           ("ragged, d_state", (2, 300, 4, 64, 128), 256, "float32",
            {"d_state": True}),
           ("ragged, d_state", (2, 300, 4, 64, 128), 256, "bfloat16",
            {"d_state": True}),
           ("JAX tests", (2, 64, 4, 16, 8), 8, "float32", {"jax": True}),
           ("JAX tests", (2, 64, 4, 16, 8), 16, "float32", {"jax": True}),
           ("JAX tests", (2, 64, 4, 16, 8), 16, "bfloat16", {"jax": True}),
           ("odd offset", (2, 130, 4, 64, 128), 64, "bfloat16",
            {"offset": 1}),
           ("odd offset", (2, 130, 4, 64, 128), 64, "float32",
            {"offset": 1}))
#: phase 46: the RG-LRU backward kernel, (shape, h0): recurrentgemma-2b's
#: training batch (phase 47: 8 x 128 tokens) and 8 x 256, with and without
#: h0, and W = 1000
LRU_BWD = (((8, 128, 2560), False), ((8, 256, 2560), False),
           ((8, 256, 2560), True), ((3, 77, 1000), True),
           ((3, 77, 1000), False))

#: f32 operations per pixel, counted from the plain versions: blur 2 x (5
#: mul + 4 add); Sobel 2 x (2 mul + 4 add/sub), magnitude 2 mul + 1 add +
#: sqrt, direction atan2 + div + round (one each); NMS thin 1 mul
SOBEL_OPS_PER_PX = 12 + 4 + 3
#: phase 4: 4 columns a lane from the gateway's batch up (vector loads),
#: 2 below; the scalar paths at widths that the vectors do not divide (63,
#: 1917), rows and columns down to 1, segments of 8, 16 and 32 lanes, and a
#: batch of 3-row frames large enough that the launcher picks strips of 32
#: rows (H < R)
SOBEL_SHAPES = [(1, 32, 32), (3, 64, 64), (256, 64, 64), (8, 1080, 1920),
                (1, 2160, 3840), (1, 48, 63), (1, 48, 65), (2, 37, 41),
                (1, 1, 7), (1, 5, 1), (1, 3, 130), (64, 64, 64),
                (64, 64, 63), (2, 1080, 1917), (16384, 3, 64)]
CANNY_OPS_PER_PX = 18 + SOBEL_OPS_PER_PX + 1


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: ok ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rand(shape, seed):
    import numpy as np
    return np.random.default_rng(seed).random(shape, np.float32)


def median_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` samples of the CUDA-event time of ``inner``
    back-to-back calls, per call, after a warm-up call.  Back to back, the
    host's wrapper overhead hides behind the device's queue whenever the
    kernel is the slower of the two."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, kernel: str, reps: int = 10, per_call: int = 1,
              parts=None):
    """Device time per call of the ``per_call`` kernels whose names contain
    ``kernel``: the sum of each one's mean time a launch in the profiler's
    trace of ``reps`` calls (None when the trace holds none of one of
    them); ``parts``, a dict, receives each one's mean by name.  The calls
    run twice, a warm-up step that the profiler traces and discards, then
    the traced step: short traces on the H100 machine lose kernels at
    random (up to all five flash-attention calls of one window, one of
    five in many), so a trace that lost some is kept with the mean of the
    launches it holds, and one that lost a kernel entirely is taken
    again, up to three times."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost a kernel is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages() if kernel in e.key]
        found = sum(e.count for e in events)
        if found != reps * per_call:
            print(f"profiler: {found} {kernel!r} kernels in the trace of "
                  f"{reps} calls of {per_call}")
        if len(events) == per_call:
            if parts is not None:
                parts.update({re.search(rf"\w*{kernel}\w*", e.key).group(0):
                              e.self_device_time_total / e.count / 1e3
                              for e in events})
            return sum(e.self_device_time_total / e.count
                       for e in events) / 1e3
    print("device time not measured")
    return None


def device_total_ms(fn, reps: int = 10):
    """Device time of one call of ``fn``: every kernel it launches, summed
    over the profiler's trace of ``reps`` calls (after a warm-up call),
    over ``reps``; None when the trace holds no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / reps / 1e3 if total else None


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``n`` back-to-back calls of ``fn``,
    without a device sync between them (after a warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def synced(fn):
    """(result, host seconds) of ``fn()`` ending in a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(n_px: int, bytes_per_px: int, ops_per_px: int):
    t_bytes = n_px * bytes_per_px / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * ops_per_px / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_close_f32(name: str, got, want32) -> float:
    """Max |got - want32| of a bf16 kernel output against the plain
    version computed in f32; fails unless every element is within the
    output's rounding to bf16 (2^-8 relative) plus 1e-4.  A kernel that
    drops one K tile or one cache split misses it by far more."""
    err = (got.float() - want32).abs()
    if not bool((err <= 1e-4 + 2 ** -8 * want32.abs()).all()):
        fail(f"{name}: kernel and f32 plain version differ by up to "
             f"{float(err.max())} (bar 1e-4 + 2^-8 |want|)")
    return float(err.max())


def attention_close(name: str, got, want) -> float:
    """Max |got - want|; fails unless every element is within the JAX
    kernel tests' bar (atol 2e-5 in f32 or 2e-2 in bf16, rtol 1e-2)."""
    import torch
    atol = 2e-2 if want.dtype == torch.bfloat16 else 2e-5
    err = (got.float() - want.float()).abs()
    if not bool((err <= atol + 1e-2 * want.float().abs()).all()):
        fail(f"{name}: kernel and plain version differ by up to "
             f"{float(err.max())} (atol {atol}, rtol 1e-2)")
    return float(err.max())


def flash_plain(q, k, v, **kw):
    """The flash kernel's plain version, one KV head's group of heads at a
    time where the f32 scores of all heads would pass 4 GiB."""
    import torch
    from repro_torch.kernels.flash_attention import ref as fl_ref
    b, h, s, _ = q.shape
    kv, t = k.shape[1], k.shape[2]
    if b * h * s * t * 4 <= 2**32:
        return fl_ref.mha_reference(q, k, v, **kw)
    g = h // kv
    return torch.cat([fl_ref.mha_reference(
        q[:, i * g:(i + 1) * g], k[:, i:i + 1], v[:, i:i + 1], **kw)
        for i in range(kv)], 1)


def causal_keys(s: int, window=None) -> int:
    """Keys a causal prompt of ``s`` rows attends, summed over its rows:
    row i sees min(i + 1, window) of them."""
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def randn(shapes, dtype, seed, dev):
    """Standard normal tensors of ``shapes`` drawn on ``dev`` from one
    seeded generator (drawing the larger ones on the host takes seconds)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in shapes]


def pool_heads():
    """(heads, KV heads, head dim) of every attention model of the default
    pool."""
    from repro_torch.configs import get_config
    from repro_torch.serving.pool import DEFAULT_POOL
    return sorted({(c.num_heads, c.num_kv_heads, c.head_dim)
                   for c in map(get_config, DEFAULT_POOL)
                   if {"attn", "local"} & set(c.layer_kinds)})


def attention_grids(dev) -> None:
    """Phases 8 and 9: both attention kernels against their plain
    versions over the JAX tests' grid and the shapes that grid misses."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.flash_attention import ref as fl_ref
    dtypes = (torch.float32, torch.bfloat16)
    t0 = time.perf_counter()
    errs = {dt: 0.0 for dt in dtypes}
    n = 0
    # MQA, GQA, MHA d=128 (tests/test_kernels.py), then a ragged S and d=32
    # ... and granite-moe-1b-a400m's prefill in phase 30 (8 x 256 tokens)
    # ... and every attention model of the pool at the serve driver's
    # capped prompts (phase 31)
    for shape in [(1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 4, 4, 128, 128),
                  (2, 8, 2, 300, 128), (1, 4, 2, 37, 32),
                  (1, 10, 1, 128, 256), (2, 10, 1, 300, 256),
                  (MAX_BATCH, 16, 8, 256, 64)] + [
                      (MAX_BATCH, h, kv, s, d) for h, kv, d in pool_heads()
                      for s in DRIVER_PROMPTS]:
        b, h, kv, s, d = shape
        for dt in dtypes:
            q, k, v = randn([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
                            dt, sum(shape), dev)
            for kw in ({}, {"window": 64}, {"softcap": 30.0},
                       {"window": 64, "softcap": 30.0}):
                got = fl_ops.attention(q, k, v, **kw)
                errs[dt] = max(errs[dt], attention_close(
                    f"flash {shape} {dt} {kw}", got,
                    fl_ref.mha_reference(q, k, v, **kw)))
                if dt == torch.bfloat16:
                    attention_close_f32(f"flash {shape} {kw}", got,
                                        fl_ref.mha_reference(
                                            q.float(), k.float(), v.float(),
                                            **kw))
                n += 1
    # the rest of the dense family at its main path's shapes (phases
    # 33-35), with its own options
    for shape, kw in DENSE_FLASH:
        b, h, kv, s, d = shape
        for dt in dtypes:
            q, k, v = randn([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
                            dt, sum(shape), dev)
            got = fl_ops.attention(q, k, v, **kw)
            errs[dt] = max(errs[dt], attention_close(
                f"flash {shape} {dt} {kw}", got, flash_plain(q, k, v, **kw)))
            if dt == torch.bfloat16:
                attention_close_f32(f"flash {shape} {kw}", got, flash_plain(
                    q.float(), k.float(), v.float(), **kw))
            n += 1
            del q, k, v, got
    # phase 42's whisper-small, then the other cases without the causal mask
    for shape, kw in ENCDEC_FLASH + tuple(
            (sh, {"causal": False, **kw}) for sh, kw in NONCAUSAL_FLASH):
        b, h, kv, s, t, d = shape
        for dt in dtypes:
            q, k, v = randn([(b, h, s, d), (b, kv, t, d), (b, kv, t, d)],
                            dt, sum(shape), dev)
            got = fl_ops.attention(q, k, v, **kw)
            errs[dt] = max(errs[dt], attention_close(
                f"flash {shape} {dt} {kw}", got, flash_plain(q, k, v, **kw)))
            if dt == torch.bfloat16:
                attention_close_f32(f"flash {shape} {kw}", got, flash_plain(
                    q.float(), k.float(), v.float(), **kw))
            n += 1
            del q, k, v, got
    q, cache = randn([(2, 100, 8, 128), (2, 2, 160, 128)], torch.bfloat16, 1,
                     dev)
    got = fl_ops.attention(q.transpose(1, 2), cache[:, :, :100],
                           cache[:, :, :100])
    attention_close("flash on strided views", got, fl_ref.mha_reference(
        q.transpose(1, 2), cache[:, :, :100], cache[:, :, :100]))
    print(f"flash attention: kernel == plain version within tolerance on "
          f"{n} cases + strided views; max err f32 {errs[dtypes[0]]:.3g}, "
          f"bf16 {errs[dtypes[1]]:.3g}")
    phase("8 flash attention kernel", t0)

    t0 = time.perf_counter()
    errs = {dt: 0.0 for dt in dtypes}
    n = 0
    rng = np.random.default_rng(3)
    # then granite-moe-1b-a400m's decode over phase 30's caches, every
    # attention model of the pool over the serve driver's (phase 31),
    # phases 33-40's, and whisper-small's over its frames and its self
    # cache (phase 42)
    for shape in [(2, 4, 2, 256, 64), (1, 8, 1, 512, 128),
                  (3, 8, 2, 1000, 128), (2, 4, 4, 70, 32),
                  (2, 10, 1, 256, 256), (3, 10, 1, 1000, 256),
                  (2, 20, 2, 300, 256), (MAX_BATCH, 16, 8, 256 + MAX_NEW, 64)
                  ] + [(MAX_BATCH, h, kv, s + DRIVER_NEW, d)
                       for h, kv, d in pool_heads() for s in DRIVER_PROMPTS
                       ] + [shape for shape, _ in DENSE_DECODE] + [
                           (MAX_BATCH, 12, 12, 1500, 64),
                           (MAX_BATCH, 12, 12, ENCDEC_BATCHES[512][0]
                            + MAX_NEW, 64)]:
        b, h, kv, t, d = shape
        dense = [kw for sh, kw in DENSE_DECODE if sh == shape]
        for dt in dtypes:
            q, k, v = randn([(b, h, d), (b, kv, t, d), (b, kv, t, d)], dt,
                            sum(shape), dev)
            for kw in dense or ({}, {"window": 128}, {"softcap": 25.0}):
                for lengths in (rng.integers(1, t + 1, b), np.ones(b),
                                np.full(b, t)):
                    lens = torch.tensor(lengths, dtype=torch.int32,
                                        device=dev)
                    errs[dt] = max(errs[dt], attention_close(
                        f"decode {shape} {dt} {kw} {lengths}",
                        dec_ops.decode(q, k, v, lens, **kw),
                        dec_ref.decode_reference(q, k, v, lens, **kw)))
                    n += 1
    print(f"flash decode: kernel == plain version within tolerance on {n} "
          f"cases; max err f32 {errs[dtypes[0]]:.3g}, bf16 "
          f"{errs[dtypes[1]]:.3g}")
    phase("9 flash decode kernel", t0)


def llm_service(archs, delta, routes, name, build_all=False, halved=False,
                batches=None, max_seq=None):
    """Phases 10, 14, 18, 30 and 35: the LLM face's main path at full
    width, over a pool of ``archs`` at ``delta``, 8 prompts of each length
    in ``routes``, every decision equal to the same policy's on the CPU.
    ``batches`` maps a complexity of ``routes`` to (prompt tokens, batch)
    where they differ from (the complexity, 8), and each backend's
    ``max_batch`` is its batch; ``max_seq`` maps an arch to its backend's
    (default ``MAX_SEQ``).  The service builds the backends it routes to;
    ``build_all`` builds every member of the pool first; ``halved`` builds
    each at half its blocks.  Returns the LLM kernels' launches of the
    counted run and the backends."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PoolPolicy, RouteRequest
    from repro_torch.serving.engine import Backend
    from repro_torch.serving.pool import ServingPool, synthetic_pool_table
    from repro_torch.serving.service import EcoreService

    t0 = time.perf_counter()
    backends = {}
    batches = {n: (batches or {}).get(n, (n, MAX_BATCH)) for n in routes}
    sizes = {arch: batches[n][1] for n, arch in routes.items()}

    def build(arch):
        if arch not in backends:
            cfg = get_config(arch)
            if halved:
                cfg = dataclasses.replace(cfg, num_layers=(
                    cfg.n_blocks // 2 * len(cfg.block_layout)
                    + len(cfg.trailing_layout)))
            backends[arch] = Backend(
                arch, cfg, max_batch=sizes.get(arch, MAX_BATCH),
                max_seq=(max_seq or {}).get(arch, MAX_SEQ),
                seed=archs.index(arch))
        return backends[arch]

    if build_all:
        for arch in archs:
            build(arch)
        torch.cuda.synchronize()
        print(f"built all {len(archs)} of {list(archs)} at full width with "
              f"seeded bf16 weights in {time.perf_counter() - t0:.1f} s; "
              f"device memory {torch.cuda.memory_allocated() / 2**30:.1f} "
              f"GiB")

    pool = ServingPool(synthetic_pool_table(archs), delta=delta)
    routed = {n: pool.route(n).arch for n in routes}
    if routed != routes:
        fail(f"the pool at δ = {delta} routes {routed}, not {routes}")
    policy = PoolPolicy(pool)
    rng = np.random.default_rng(13)

    def requests(uid0, lens, max_new):
        return [RouteRequest(uid=uid0 + i, payload=rng.integers(
            0, 100_000, batches[n][0]), complexity=n, max_new_tokens=max_new)
                for i, n in enumerate(lens)]

    # warm-up (not counted): builds the backends, loads the kernels, warms
    # cuBLAS and the allocator
    with EcoreService(policy, lambda d: build(d.backend)) as svc:
        svc.submit_batch(requests(1000, [n for n in routes for _ in "ab"], 2))
    torch.cuda.synchronize()
    print(f"built {sorted(backends)} at full width with seeded weights and "
          f"warmed up in {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    lens = [n for n in routes for _ in range(batches[n][1])]
    kernel_ops = llm_kernel_ops()
    for ops in kernel_ops.values():
        ops.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with EcoreService(policy, lambda d: build(d.backend)) as svc:
        futs = svc.submit_batch(requests(0, lens, MAX_NEW))
        served = [f.result() for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {k: ops.launches for k, ops in kernel_ops.items()}
    print(f"LLM service at δ = {delta}: {len(served)} requests in "
          f"{wall:.3f} s; launches {launches}")
    cpu_policy = PoolPolicy(ServingPool(synthetic_pool_table(
        archs, device="cpu"), delta=delta))
    on_cpu = {d.uid: d.pair for d in cpu_policy.decide_batch(
        [RouteRequest(uid=sv.request.uid, complexity=sv.request.complexity)
         for sv in served])}
    if {sv.request.uid: sv.decision.pair for sv in served} != on_cpu:
        fail(f"the service's routes differ from the policy's on the CPU: "
             f"{on_cpu}")
    print(f"  routes (equal to the CPU's): " + ", ".join(
        f"{batches[n][1]} x {batches[n][0]} tokens (complexity {n}) -> "
        f"{arch}" for n, arch in routes.items()))
    for sv in served:
        n = sv.request.complexity
        tok = sv.result.tokens
        if sv.decision.backend != routes[n]:
            fail(f"a request of complexity {n} went to "
                 f"{sv.decision.backend}")
        vocab = get_config(sv.decision.backend).vocab_size
        if tok.shape != (MAX_NEW,) or tok.min() < 0 or tok.max() >= vocab:
            fail(f"request {sv.request.uid} returned tokens {tok}")
    # one serve_batch per backend: one flash launch per attention layer
    # (global or local) and one decode launch per attention layer per step,
    # one SSD launch per Mamba-2 layer, one RG-LRU launch per recurrent layer
    expect = kernel_launches([k for a in routes.values()
                              for k in launch_kinds(backends[a].cfg)],
                             MAX_NEW - 1)
    if launches != expect:
        fail(f"the service's kernel launches {launches} are not one flash "
             f"per attention layer per batch, one decode per attention "
             f"layer per step, one SSD scan per Mamba-2 layer and one "
             f"RG-LRU scan per recurrent layer per batch ({expect})")
    for n, arch in routes.items():
        r = next(sv.result for sv in served if sv.decision.backend == arch)
        if r.batch_size != batches[n][1]:
            fail(f"{arch} served a batch of {r.batch_size}, not "
                 f"{batches[n][1]}")
        print(f"  {arch}: batch {r.batch_size} x {batches[n][0]} tokens: "
              f"prefill {r.prefill_s * 1e3:.2f} ms, decode "
              f"{r.decode_s / (MAX_NEW - 1) * 1e3:.3f} ms per step, "
              f"{r.batch_size * MAX_NEW / (r.prefill_s + r.decode_s):.0f} "
              f"generated tokens/s")
    phase(name, t0)
    return launches, backends


def llm_kernel_ops():
    """The LLM face's kernel wrappers by kernel name."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fl_ops, "decode_attention": dec_ops,
            "ssd_scan": ssd_ops, "rglru_scan": lru_ops}


def launch_kinds(cfg):
    """The layer kinds of ``cfg`` as the kernels see them: an MLA layer
    (plain PyTorch, no kernel) is ``"mla"``, not ``"attn"``; an encdec
    model's encoder layers are ``"enc"`` (flash, not causal, once a
    batch) and each decoder layer an ``"attn"`` and a ``"cross"``
    (cross-attention: flash, not causal, once a batch, and the decode
    kernel once a step)."""
    if cfg.family == "encdec":
        return ["enc"] * cfg.enc_layers + ["attn", "cross"] * cfg.dec_layers
    return ["mla" if kind == "attn" and cfg.use_mla else kind
            for kind in cfg.layer_kinds]


def kernel_launches(kinds, steps):
    """The LLM kernels' launches of one prefill and ``steps`` decode steps
    over layers of these kinds."""
    cached = sum(k in ("attn", "local", "cross") for k in kinds)
    return {"flash_attention": cached + kinds.count("enc"),
            "decode_attention": cached * steps,
            "ssd_scan": kinds.count("ssm"), "rglru_scan": kinds.count("rec")}


class NonCausalFlash:
    """While entered, counts the flash kernel's launches without the
    causal mask (``attention(..., causal=False)`` on CUDA tensors)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fl_ops
        self.count, self._ops, real = 0, fl_ops, fl_ops.attention

        def attention(q, k, v, *, causal=True, **kw):
            self.count += not causal and q.is_cuda
            return real(q, k, v, causal=causal, **kw)
        fl_ops.attention, self._real = attention, real
        return self

    def __exit__(self, *exc):
        self._ops.attention = self._real


def in_range(label, fn):
    """``fn`` run inside a profiler range named ``label``."""
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return run


def llm_profile(backends, routes, ranges=None) -> None:
    """Where one serve_batch's device time goes, per backend (outside the
    counted run).  ``ranges`` maps a label to (module, function name): for
    the profiled run that function runs inside a profiler range of that
    name, and the device time of the kernels launched inside each range is
    printed beside the busy time."""
    import contextlib
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(17)
    names = ("flash_kernel", "decode_kernel", "ssd_kernel", "rglru_kernel")
    ranges = ranges or {}
    for n, arch in routes.items():
        t0 = time.perf_counter()
        reqs = [Request(uid=i, prompt=rng.integers(0, 100_000, n),
                        max_new_tokens=MAX_NEW) for i in range(MAX_BATCH)]
        with contextlib.ExitStack() as undo:
            for label, (module, attr) in ranges.items():
                undo.callback(setattr, module, attr, getattr(module, attr))
                setattr(module, attr, in_range(label, getattr(module, attr)))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                (res, *_), wall = synced(
                    lambda: backends[arch].serve_batch(reqs))
        averages = prof.key_averages()
        # the ranges' own GPU-side spans are not kernels
        kernels = [e for e in averages if e.device_type == DeviceType.CUDA
                   and e.key not in ranges]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        ours = sum(e.self_device_time_total for e in kernels
                   if any(k in e.key for k in names)) / 1e6
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        per = {name: [(e.self_device_time_total / e.count / 1e3, e.count)
                      for e in kernels if name in e.key]
               for name in names}
        print(f"profile {arch} serve_batch ({wall * 1e3:.1f} ms under "
              f"the profiler; prefill {res.prefill_s * 1e3:.1f} ms, "
              f"decode {res.decode_s * 1e3:.1f} ms): "
              f"{sum(e.count for e in kernels)} device ops, per "
              f"kernel launch (ms, count) {per}; device busy "
              f"{busy * 1e3:.1f} ms = {busy / wall:.1%}, the port's "
              f"kernels {ours * 1e3:.1f} ms = {ours / busy:.1%} of busy;"
              f" top: " + "; ".join(
                  f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
                  f"x{e.count}" for e in top))
        inside = {label: sum(e.device_time_total for e in averages
                             if e.key == label
                             and e.device_type == DeviceType.CPU) / 1e6
                  for label in ranges}
        if inside:
            print(f"  {arch}: device time of the kernels launched inside " +
                  ", ".join(f"{label} {t * 1e3:.1f} ms = {t / busy:.1%} of "
                            f"busy" for label, t in inside.items()))
        print(f"  ({arch}'s profile and its analysis took "
              f"{time.perf_counter() - t0:.1f} s)")


def decode_syncs(backend, prompt_len) -> None:
    """The host syncs of the first two decode steps of ``backend`` at batch
    8 after a ``prompt_len``-token prompt (torch's sync debug mode warns at
    every device-to-host read and every copy the host waits for), by line
    (outside the counted run).  The first step also builds the decode
    kernel's launch plans for caches of these strides; the second shows a
    step's own syncs."""
    import collections
    import warnings
    import numpy as np
    import torch
    from repro_torch.data.tokens import modality_inputs
    from repro_torch.models import decode_step, prefill
    rng = np.random.default_rng(41)
    tokens = torch.from_numpy(rng.integers(
        0, backend.cfg.vocab_size, (MAX_BATCH, prompt_len))).cuda()
    # an encdec model's frames (they feed its encoder, not the cache)
    frames = (modality_inputs(backend.cfg, MAX_BATCH, rng, device="cuda")
              ["prefix_embeds"] if backend.cfg.family == "encdec" else None)
    with torch.inference_mode():
        logits, cache = prefill(backend.params, backend.cfg, tokens, frames,
                                max_seq=MAX_SEQ)
        nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        for step in ("first", "second"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    logits, cache = decode_step(backend.params, backend.cfg,
                                                nxt, cache)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            nxt = logits.argmax(-1)
            by_line = collections.Counter(
                f"{Path(w.filename).name}:{w.lineno}" for w in caught)
            in_moe = sum(c for line, c in by_line.items()
                         if line.startswith("moe.py"))
            print(f"host syncs in the {step} {backend.name} decode step: "
                  f"{sum(by_line.values())} ({in_moe} in the MoE layers), "
                  f"by line {dict(by_line)}")


def moe_form_ab(backend, prompt_len) -> None:
    """The prefill of one ``serve_batch`` of 8 prompts of ``prompt_len``
    tokens with every MoE layer on the sorted form and with every one on
    the every-expert form, in turns (sorted, every, every, sorted; outside
    the counted run): which form serves the model's prefill faster end to
    end, host included."""
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(47)
    reqs = [Request(uid=i, prompt=rng.integers(0, 100_000, prompt_len),
                    max_new_tokens=2) for i in range(MAX_BATCH)]
    default = moe.SORTED_MIN_MACS
    ms = {"sorted": [], "every": []}
    backend.serve_batch(reqs)   # warm-up
    try:
        for form in ("sorted", "every", "every", "sorted"):
            moe.SORTED_MIN_MACS = 0.0 if form == "sorted" else float("inf")
            ms[form].append(backend.serve_batch(reqs)[0].prefill_s * 1e3)
    finally:
        moe.SORTED_MIN_MACS = default
    cfg = backend.cfg
    macs = MAX_BATCH * prompt_len * cfg.num_experts * cfg.d_model \
        * cfg.moe_d_ff
    print(f"{backend.name} prefill of {MAX_BATCH} x {prompt_len} tokens, "
          f"every MoE layer on one form: sorted {ms['sorted']} ms, "
          f"every-expert {ms['every']} ms (by size, moe_ragged takes the "
          f"{'sorted' if macs >= default else 'every-expert'} form)")


def decode_splits_ab(backends) -> None:
    """The decode step per token of each backend with the decode kernel's
    cache cut into splits (the wrapper's sizing) and in one piece per
    (batch, KV head) (``BLOCKS_PER_SM = 0``), alternated one, split,
    split, one (outside the counted run)."""
    import numpy as np
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(37)
    default = dec_ops.BLOCKS_PER_SM
    for n, arch in ROUTES.items():
        reqs = [Request(uid=i, prompt=rng.integers(0, 100_000, n),
                        max_new_tokens=MAX_NEW) for i in range(MAX_BATCH)]
        ms = {"one": [], "split": []}
        try:
            for mode in ("one", "split", "split", "one"):
                dec_ops.BLOCKS_PER_SM = default if mode == "split" else 0
                res = backends[arch].serve_batch(reqs)[0]
                ms[mode].append(res.decode_s / (MAX_NEW - 1) * 1e3)
        finally:
            dec_ops.BLOCKS_PER_SM = default
        print(f"decode step per token, {arch} batch {MAX_BATCH} x {n}: "
              f"split cache {ms['split']} ms, one piece {ms['one']} ms")


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def llm_cuda_vs_cpu(arch, prompt_len, name, num_layers=2, new=4,
                    batch=2, tol=1e-3) -> None:
    """Phases 11, 15, 19, 28, 33, 36, 39 and 41: ``arch`` cut to
    ``num_layers`` layers (an encdec model's halves encoder and half
    decoder layers) at full width in f32, on the GPU through the kernels
    and on the CPU through their plain versions, a batch of ``batch``
    prompts of ``prompt_len`` tokens (after the config's prefix embeddings,
    or with its frames, drawn by ``modality_inputs`` from a fixed seed) and
    ``new`` new tokens: logits within ``tol``, tokens equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import modality_inputs
    from repro_torch.models import decode_step, init_params, prefill
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), num_layers=num_layers,
                              activ_dtype="float32")
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, enc_layers=num_layers // 2,
                                  dec_layers=num_layers // 2)
    params = {"cuda": init_params(cfg, seed=7, device="cuda")}
    params["cpu"] = to_device(params["cuda"], "cpu")
    prompt = np.random.default_rng(19).integers(0, cfg.vocab_size,
                                                (batch, prompt_len))
    prefix = modality_inputs(cfg, batch, np.random.default_rng(37),
                             device="cpu").get("prefix_embeds")
    n_prefix = (0 if prefix is None or cfg.family == "encdec"
                else prefix.shape[1])
    logits, tokens = {}, {}
    kernel_ops = llm_kernel_ops()
    before = {k: ops.launches for k, ops in kernel_ops.items()}
    with NonCausalFlash() as noncausal:
        for dev, p in params.items():
            lg, cache = prefill(p, cfg, torch.from_numpy(prompt).to(dev),
                                None if prefix is None else prefix.to(dev),
                                max_seq=n_prefix + prompt_len + new)
            outs, toks = [lg.cpu()], [lg.argmax(-1)]
            for _ in range(new - 1):
                lg, cache = decode_step(p, cfg, toks[-1], cache)
                outs.append(lg.cpu())
                toks.append(lg.argmax(-1))
            logits[dev], tokens[dev] = outs, torch.cat(toks, 1).cpu()
    ran = {k: ops.launches - before[k] for k, ops in kernel_ops.items()}
    kinds = launch_kinds(cfg)
    want = kernel_launches(kinds, new - 1)
    # one flash launch without the causal mask per encoder layer and per
    # cross-attention: none outside the encdec family
    unmasked = kinds.count("enc") + kinds.count("cross")
    if ran != want or noncausal.count != unmasked:
        fail(f"the GPU run of the {num_layers}-layer model launched {ran}, "
             f"{noncausal.count} flash without the causal mask, not {want}, "
             f"{unmasked}")
    err = max(float((a - b).abs().max())
              for a, b in zip(logits["cuda"], logits["cpu"]))
    frames = (f"{prefix.shape[1]} frames, " if cfg.family == "encdec"
              else f"{n_prefix} prefix embeddings + ")
    print(f"{arch}, {num_layers} layers {kinds}, f32, batch "
          f"{batch}, {frames}{prompt_len}-token prompt, {new} new tokens: "
          f"cuda vs cpu logits max err {err:.3g} (tolerance {tol:g}); "
          f"flash launches {ran['flash_attention']}, {noncausal.count} "
          f"without the causal mask; tokens {tokens['cuda'].tolist()} (cpu "
          f"equal: {torch.equal(tokens['cuda'], tokens['cpu'])})")
    if err > tol or not torch.equal(tokens["cuda"], tokens["cpu"]):
        fail(f"the {num_layers}-layer {arch} differs between cuda and cpu")
    phase(name, t0)


def flash_bwd_plain(q, k, v, do, **kw):
    """The flash kernel's plain backward, in the inputs' precision (f32 for
    bf16 and f32, f64 for f64), one KV head's group of heads at a time
    where the scores of all heads would pass 4 GiB."""
    import torch
    from repro_torch.kernels.flash_attention import ref as fl_ref
    b, h, s, _ = q.shape
    kv, t = k.shape[1], k.shape[2]
    if b * h * s * t * q.element_size() <= 2**32:
        return fl_ref.mha_backward_reference(q, k, v, do, **kw)
    g = h // kv
    parts = [fl_ref.mha_backward_reference(
        q[:, i * g:(i + 1) * g], k[:, i:i + 1], v[:, i:i + 1],
        do[:, i * g:(i + 1) * g], **kw) for i in range(kv)]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def flash_bwd_check(where, shape, dtype, kw, seed, dev):
    """The flash backward kernel at ``shape`` (B, H, KV, S, T, D),
    ``dtype`` and options ``kw`` on inputs drawn from ``seed``, against
    its plain backward: phase 43's bar (below) and equal bits in two
    calls.  Returns the inputs (q, k, v, dO), each gradient's largest error
    against f64 and a note of each."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fl_ops
    b, h, kv, s, t, d = shape
    q, k, v, do = randn([(b, h, s, d), (b, kv, t, d), (b, kv, t, d),
                         (b, h, s, d)], dtype, seed, dev)
    opts = (kw.get("causal", True), kw.get("window"), kw.get("softcap"))
    runs = [fl_ops._launch_backward(q, k, v, do, *opts) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(*runs)):
        fail(f"{where}: two flash backward calls at {shape} differ")
    want = flash_bwd_plain(*(x.double() for x in (q, k, v, do)), **kw)
    plain32 = flash_bwd_plain(*(x.float() for x in (q, k, v, do)), **kw)
    rel = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    errs, notes = [], []
    for part, got, w, p in zip("qkv", runs[0], want, plain32):
        e32 = float((p.double() - w).abs().max())
        err = (got.double() - w).abs()
        if not bool((err <= 4 * e32 + 1e-7 + rel * w.abs()).all()):
            fail(f"{where}: flash backward d{part} at {shape} {dtype} {kw} "
                 f"off by up to {float(err.max())} (the f32 plain "
                 f"backward's own error {e32})")
        errs.append(float(err.max()))
        notes.append(f"d{part} {errs[-1]:.3g} (plain f32 {e32:.3g})")
    return (q, k, v, do), errs, notes


def flash_backward(dev):
    """Phase 43: the flash backward kernel against its plain backward on
    the card at ``FLASH_BWD``'s shapes.  Bar: the plain backward computed
    in f64 from the same inputs; the kernel within four times the f32
    plain backward's own largest error against it (plus 1e-7), and for
    bf16 also the rounding of each output to bf16 (2^-8 of it).  Two calls
    give equal bits.  Times (CUDA events): the kernel (one backward call,
    its two launches), the plain backward, and the library's backward
    (``scaled_dot_product_attention`` with ``enable_gqa``: its forward
    once, then its backward alone, the graph kept; none under a softcap or
    a window).  Bound: 2.5 times the forward's operations (the visible
    (row, column) pairs) at the inputs' peak, or the bytes of q, k, v, dO
    read and dq, dk, dv written.  Device time (profiler) of the dQ and the
    dK/dV kernel apart.  Returns the JSON fields of the first shape, phase
    45's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fl_ops
    t0 = time.perf_counter()
    row = None
    for label, shape, dt, kw in FLASH_BWD:
        b, h, kv, s, t, d = shape
        dtype = getattr(torch, dt)
        causal, window = kw.get("causal", True), kw.get("window")
        opts = (causal, window, kw.get("softcap"))
        (q, k, v, do), errs, notes = flash_bwd_check(
            "phase 43", shape, dtype, kw, 43 + s, dev)
        kern = median_ms(lambda: fl_ops._launch_backward(q, k, v, do, *opts),
                         reps=5, inner=2)
        parts = {}
        device_ms(lambda: fl_ops._launch_backward(q, k, v, do, *opts),
                  "flash_bwd", reps=3, per_call=2, parts=parts)
        plain = median_ms(lambda: flash_bwd_plain(q, k, v, do, **kw),
                          reps=3, inner=1)
        lib = None
        if "softcap" not in kw and window is None:
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
            out = F.scaled_dot_product_attention(qq, kk, vv,
                                                 is_causal=causal,
                                                 enable_gqa=True)
            lib = median_ms(lambda: torch.autograd.grad(
                out, (qq, kk, vv), do, retain_graph=True), reps=5, inner=2)
            del out, qq, kk, vv
        pairs = b * h * (causal_keys(s, window) if causal else s * t)
        flops = 2.5 * 4 * d * pairs
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        t_ops = flops / peak * 1e3
        t_bytes = q.element_size() * 2 * (2 * b * h * s * d
                                          + 2 * b * kv * t * d) \
            / HBM_BYTES_PER_S * 1e3
        bnd, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                   else (t_ops, "operations"))
        library = "none" if lib is None else f"{lib:.4f} ms"
        print(f"time flash backward {label} {shape} {dt} {kw}: kernel "
              f"{kern:.4f} ms ({flops / kern / 1e9:.1f} TFLOP/s of the "
              f"backward's {flops / 1e9:.1f} GFLOP; device "
              + (", ".join(f"{n} {ms:.4f} ms" for n, ms in parts.items())
                 or "not measured")
              + f"), plain {plain:.4f} ms, "
              f"library backward {library}, bound {bnd:.5f} ms ({by}); "
              f"max err against f64: " + ", ".join(notes)
              + "; equal bits in two calls")
        if row is None:
            row = (kern, plain, bnd, by, lib, max(errs))
        del q, k, v, do
        torch.cuda.empty_cache()
    phase("43 flash backward kernel", t0)
    return row


def scan_bwd_close(name, got, want, plain, dtype,
                   parts=("dx", "ddt", "dA", "dB", "dC", "dD")):
    """Each of ``got`` (named ``parts``) within four times the f32 plain
    backward's (``plain``) own largest error against ``want`` (f64), plus
    1e-7, plus 2^-8 of each value for bf16; returns the largest error and
    a note of each."""
    import torch
    rel = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    worst, notes = 0.0, []
    for part, g, w, p in zip(parts, got, want, plain):
        e32 = float((p.double() - w).abs().max())
        err = (g.double() - w).abs()
        if not bool((err <= 4 * e32 + 1e-7 + rel * w.abs()).all()):
            fail(f"{name} {part} off by up to {float(err.max())} "
                 f"(the f32 plain backward's own error {e32})")
        worst = max(worst, float(err.max()))
        notes.append(f"{part} {float(err.max()):.3g} (plain f32 {e32:.3g})")
    return worst, ", ".join(notes)


def ssd_bwd_bound(shape, chunk, dtype, with_state):
    """(ms, "bytes" or "operations") of the SSD backward at ``shape``: x
    and dy [b, s, h, p] read and dx written, B and C [b, s, n] read and dB
    and dC written, in ``dtype``; dt read and ddt written, A and D read
    and dA and dD written, in f32 (and d_state read); the operations this
    input needs: per (batch, chunk) C_i . B_j over the causal pairs, per head
    dy_i . xd_j, dC, dB and dxd over them; per row and head the chunk's
    own state and state gradient, the entering state's term after the
    first chunk, the state terms before the last chunk (or every chunk
    with d_state).  Peak: the inputs' type's."""
    b, s, h, p, n = shape
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * (3 * b * s * h * p + 4 * b * s * n) \
        + 4 * 2 * b * s * h + 4 * 4 * h + (4 * b * h * p * n
                                           if with_state else 0)
    q = min(chunk, s)
    rows = [min(q, s - c0) for c0 in range(0, s, q)]
    tri = sum(r * (r + 1) // 2 for r in rows)
    later = s - rows[0]
    earlier = s if with_state else s - rows[-1]
    flops = 2 * b * (tri * (n + h * (2 * p + 2 * n))
                     + h * p * n * (2 * s + later + 2 * earlier))
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops
    return t_ops, "operations", nbytes, flops


def ssd_bwd_check(where, label, shape, chunk, dtype, kw, seed, dev):
    """The SSD backward kernel at ``shape`` (b, s, h, p, n), ``chunk`` and
    ``dtype`` on inputs drawn from ``seed`` as phase 46 draws them
    (``kw``: ``jax``, the JAX tests' decays; ``offset``, x, B and C at an
    odd element offset; ``d_state``, a gradient of the final state),
    against its plain backward: phase 46's bar (``scan_bwd_close``) and
    equal bits in two calls.  Returns the inputs ((x, dt, A, B, C, D), dy,
    d_state, the chunk's rows), the largest error, a note of each output,
    and (the kernel's outputs, the f64 and the f32 plain backward's)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    args = ssd_inputs(shape, seed, dev, dtype, not kw.get("jax"),
                      kw.get("offset", 0))
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    dy = torch.randn(args[0].shape, generator=gen, device=dev).to(dtype)
    ds = (torch.randn(shape[0], shape[2], shape[3], shape[4], generator=gen,
                      device=dev) if kw.get("d_state") else None)
    q = min(chunk, shape[1])
    runs = [ssd_ops._launch_backward(*args, dy, ds, q) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(*runs)):
        fail(f"{where}: two SSD backward calls at {shape} {dtype} differ")
    want, plain32 = (ssd_ref.ssd_backward_reference(
        *(t.to(f) for t in args + (dy,)), chunk=chunk,
        d_state=None if ds is None else ds.to(f))
        for f in (torch.float64, torch.float32))
    err, notes = scan_bwd_close(f"{where}: SSD {label} {shape} {dtype}",
                                runs[0], want, plain32, dtype)
    return (args, dy, ds, q), err, notes, (runs[0], want, plain32)


def lru_bwd_check(where, shape, with_h0, seed, dev):
    """The RG-LRU backward kernel at ``shape`` (b, s, w), with or without
    h0, on phase 17's gate inputs drawn from ``seed`` and a normal
    cotangent: equal bits in two calls, equal to its f32 plain backward
    bit for bit, and phase 43's bar against the plain backward in f64
    (``scan_bwd_close``).  Returns the inputs (a, b, h, dh, h0), the
    largest error against f64 and a note of each output."""
    import numpy as np
    import torch
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    a, b = lru_gate_inputs(shape, seed, dev)
    rng = np.random.default_rng(sum(shape))
    dh = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
    h0 = (torch.from_numpy(rng.standard_normal(
        (shape[0], shape[2]), np.float32)).to(dev) if with_h0 else None)
    h = lru_ops.linear_scan(a, b, h0)
    runs = [lru_ops._launch_backward(a, h, dh, h0) for _ in range(2)]
    torch.cuda.synchronize()
    runs = [[t for t in r if t is not None] for r in runs]
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        fail(f"{where}: two RG-LRU backward calls at {shape} differ")
    plain32 = [t for t in lru_ref.linear_scan_backward_reference(
        a, h, dh, h0) if t is not None]
    if not all(torch.equal(x, y) for x, y in zip(runs[0], plain32)):
        fail(f"{where}: the RG-LRU backward kernel at {shape} h0="
             f"{with_h0} differs from its f32 plain backward")
    h64 = lru_ref.linear_scan(a.double(), b.double(),
                              None if h0 is None else h0.double())
    want = [t for t in lru_ref.linear_scan_backward_reference(
        a.double(), h64, dh.double(),
        None if h0 is None else h0.double()) if t is not None]
    err, notes = scan_bwd_close(f"{where}: RG-LRU {shape}", runs[0], want,
                                plain32, torch.float32, ("da", "db", "dh0"))
    return (a, b, h, dh, h0), err, notes


def scan_backward(dev):
    """Phase 46: the SSD backward kernel at ``SSD_BWD``'s shapes and the
    RG-LRU backward kernel at ``LRU_BWD``'s against their plain backwards
    on the card.  Bar: phase 43's, the plain backward computed in f64 from
    the same inputs; the kernel within four times the f32 plain backward's
    own largest error against it (plus 1e-7), and for bf16 also each
    output's rounding to bf16 (2^-8 of it); two calls give equal bits; the
    RG-LRU kernel equals its f32 plain backward bit for bit.  Times at the
    training shapes of phase 47 (CUDA events): the kernel's call, its
    device time (profiler; the SSD's six kernels apart), the plain
    backward's; the bound; library: none.  Returns the JSON fields of
    each kernel at phase 47's shape."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    t0 = time.perf_counter()
    rows = {}
    for label, shape, chunk, dt, kw in SSD_BWD:
        (args, dy, ds, q), err, notes, (got, want, plain32) = ssd_bwd_check(
            "phase 46", label, shape, chunk, getattr(torch, dt), kw,
            46 + sum(shape), dev)
        line = (f"ssd backward {label} {shape} chunk {chunk} {dt}"
                f"{' with d_state' if ds is not None else ''}: max err "
                f"against f64: {notes}; equal bits in two calls")
        if shape[3:] == (64, 128) and chunk == 256:
            # d a_cum's row and column sums of T nearly cancel over a
            # 256-row chunk: added in f64, dA lies nearer f64 than the f32
            # plain backward's
            e_da, e32_da = (float((g[2].double() - want[2]).abs().max())
                            for g in (got, plain32))
            if not e_da < e32_da:
                fail(f"phase 46: SSD {label} {shape} {dt} dA off by {e_da}, "
                     f"the f32 plain backward's by {e32_da}")
            line += f"; dA nearer f64 than the f32 plain's"
        del got, want, plain32
        if label == "mamba2-370m":
            def kernel():
                return ssd_ops._launch_backward(*args, dy, ds, q)
            kern = median_ms(kernel, reps=10, inner=3)
            parts = {}
            dev_ms = device_ms(kernel, "ssd_bwd", reps=3, per_call=6,
                               parts=parts)
            plain = median_ms(lambda: ssd_ref.ssd_backward_reference(
                *args, dy, chunk=chunk), reps=3, inner=1)
            bnd, by, nbytes, flops = ssd_bwd_bound(shape, chunk, dt, False)
            line += (f"; kernel {kern:.4f} ms (device "
                     + (f"{dev_ms:.4f} ms: " + ", ".join(
                         f"{k} {v:.4f}" for k, v in parts.items())
                        if dev_ms else "not measured")
                     + f"; {flops / kern / 1e9:.2f} TFLOP/s of "
                     f"{flops / 1e9:.2f} GFLOP), plain {plain:.4f} ms, bound "
                     f"{bnd:.5f} ms ({by}: {nbytes / 1e6:.1f} MB; "
                     f"{flops / 1e9:.2f} GFLOP at the {dt} peak), "
                     f"{bnd / (dev_ms or kern):.1%} of the bound; library: "
                     f"none (no PyTorch call computes the SSD scan's "
                     f"gradient)")
            rows.setdefault("ssd_scan_bwd", (kern, plain, bnd, by, err))
        print(line)
        del dy, ds, args
        torch.cuda.empty_cache()

    for shape, with_h0 in LRU_BWD:
        (a, b, h, dh, h0), err, notes = lru_bwd_check(
            "phase 46", shape, with_h0, 46 + sum(shape), dev)
        line = (f"rglru backward {shape} h0={with_h0}: equal to the f32 plain "
                f"backward bit for bit and in two calls; max err against "
                f"f64: {notes}")
        if shape == (8, 128, 2560) and not with_h0:
            def kernel():
                return lru_ops._launch_backward(a, h, dh, None)
            kern = median_ms(kernel, reps=10, inner=5)
            dev_ms = device_ms(kernel, "rglru_bwd_kernel", reps=5)
            plain = median_ms(lambda: lru_ref.linear_scan_backward_reference(
                a, h, dh), reps=3, inner=1)
            # a, h and dh read and da and db written in f32; one add and
            # two multiplies a step on the CUDA cores
            nbytes = 20 * a.numel()
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 3 * a.numel() / F32_FLOP_PER_S * 1e3
            bnd, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                       else (t_ops, "operations"))
            line += (f"; kernel {kern:.4f} ms (device "
                     + (f"{dev_ms:.4f} ms" if dev_ms else "not measured")
                     + f"), plain {plain:.4f} ms, bound {bnd:.5f} ms ({by}: "
                     f"{nbytes / 1e6:.1f} MB; {t_ops:.5f} ms at the f32 "
                     f"peak), {bnd / (dev_ms or kern):.1%} of the bound; "
                     f"library: none (no PyTorch call computes the "
                     f"recurrence's gradient)")
            rows["rglru_scan_bwd"] = (kern, plain, bnd, by, err)
        print(line)
    print(f"phase 46 on {card_line()}")
    phase("46 scan backward kernels", t0)
    return rows


def leaf_error(a, w):
    """(max |a - w|, the largest |w| or 1), in f64 on ``a``'s device: the
    card's, where a 655 M-element leaf takes a second and not the CPU's
    ten."""
    import torch
    w = w.to(a.device, torch.float64)
    return (float((a.double() - w).abs().max()),
            float(w.abs().max()) or 1.0)


def leaves_close(label, got, want, bar=1e-4):
    """Each leaf of ``got`` (a list) within ``bar`` of the largest |value|
    of its leaf in ``want`` ((paths, leaves)); returns the worst ratio."""
    worst = 0.0
    for path, a, w in zip(want[0], got, want[1]):
        err, scale = leaf_error(a, w)
        worst = max(worst, err / scale)
        if err > bar * scale:
            fail(f"phase 44: {label} {path} differs by {err} (bar {bar} of "
                 f"its largest |value| {scale})")
    return worst


def first_step_spread(m, opt, bar=1e-4):
    """How far Adam's first step can move each parameter apart, over lr,
    between two runs whose gradients agree to ``bar`` of the leaf's
    largest |value|: the step is lr (u(g) + weight decay p), u(x) = x /
    (|x| + eps) of the clipped gradient g (the first moment ``m`` over 1 -
    b1), and u moves by at most the larger of |u(g +- gamma) - u(g)|, gamma
    = ``bar`` max |g| (nearly 2 where g lies within gamma of zero, where
    the two steps may take opposite signs)."""
    import torch
    g = m.double() / (1 - opt.b1)
    gamma = bar * float(g.abs().max())
    u = lambda x: x / (x.abs() + opt.eps)
    return torch.maximum(u(g + gamma) - u(g), u(g) - u(g - gamma)).float()


#: the leaves whose gradient runs through the SSD's d a_cum (a Mamba-2
#: layer's decay A_log and its dt_bias, through A da): a difference of
#: row and column sums that nearly cancel, so that an f32 run of it (the
#: CPU's plain autograd too) lands up to about 1e-4 of the leaf's largest
#: |value| from the exact gradient, and two f32 runs as far apart
DECAY_LEAVES = ("ssm/A_log", "ssm/dt_bias")


def decay_reference(cfg, master, batch, grads, opt):
    """The reference of ``DECAY_LEAVES`` in phase 44: {leaf index: (the
    f64 gradient (the model and the plain versions in f64 on the CPU, from
    the same f32 masters), the first moment and the parameter after
    ``adamw_update``'s first step from the CPU's gradients with these
    leaves' taken from it)}; {} where ``master`` has no such leaf.  Prints
    each leaf's ratios to its largest |value|: the card's gradient against
    the f64 one and the CPU's, and the CPU's own against the f64 one."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import decays_as_stacked
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import (adamw_update, init_opt_state,
                                         tree_leaves, tree_paths,
                                         tree_unflatten)
    paths = tree_paths(master)
    idx = [i for i, path in enumerate(paths) if path.endswith(DECAY_LEAVES)]
    if not idx:
        return {}
    cfg64 = dataclasses.replace(cfg, activ_dtype="float64",
                                param_dtype="float64")
    leaves = [x.double().requires_grad_() for x in tree_leaves(master)]
    loss, _ = loss_fn(tree_unflatten(master, leaves), cfg64, batch)
    g64 = torch.autograd.grad(loss, leaves)
    ref = list(grads["cpu"])
    for i in idx:
        ref[i] = g64[i].float()
        card, own = (leaf_error(grads[d][i], g64[i]) for d in ("cuda", "cpu"))
        err, scale = leaf_error(grads["cuda"][i], grads["cpu"][i])
        print(f"  {cfg.name} gradient {paths[i]}, of its largest |value|: "
              f"card against f64 {card[0] / card[1]:.3g}, against cpu "
              f"{err / scale:.3g}; cpu against f64 {own[0] / own[1]:.3g}")
    copy = tree_unflatten(master, [x.clone() for x in tree_leaves(master)])
    p, state, _ = adamw_update(opt, copy, tree_unflatten(copy, ref),
                               init_opt_state(copy),
                               decays=decays_as_stacked)
    mu, p = tree_leaves(state.mu), tree_leaves(p)
    return {i: (g64[i], mu[i], p[i]) for i in idx}


def kernel_counts(mods):
    """{name: (forward, backward launches)} of the wrapper modules
    ``mods`` ({name: module})."""
    return {k: (m.launches, getattr(m, "backward_launches", 0))
            for k, m in mods.items()}


def zero_counts(mods) -> None:
    for m in mods.values():
        m.launches = 0
        if hasattr(m, "backward_launches"):
            m.backward_launches = 0


def recomputes(cfg) -> int:
    """How often a training step of ``cfg`` runs each layer's forward: twice
    under ``cfg.remat`` (the forward, then its recompute in the backward),
    except in the encdec family, whose blocks the model, as the reference,
    does not checkpoint; once without."""
    return 2 if cfg.remat and cfg.family != "encdec" else 1


def trained_kernels(cfg):
    """{name: wrapper module} of the kernels with a backward, and {name:
    (forward, backward) launches of a training step of ``cfg`` on one
    micro-batch}: each kernel once a layer of its kind (flash an attention
    layer, an encdec model's encoder, self- and cross-attention; SSD an
    ssm layer; RG-LRU a rec layer) in the backward, and ``recomputes``
    times in the forward."""
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    kinds = launch_kinds(cfg)
    mods = {"flash_attention": fl_ops, "ssd_scan": ssd_ops,
            "rglru_scan": lru_ops}
    layers = {"flash_attention": sum(k in ("attn", "local", "enc", "cross")
                                     for k in kinds),
              "ssd_scan": kinds.count("ssm"),
              "rglru_scan": kinds.count("rec")}
    per = {k: (n * recomputes(cfg), n) for k, n in layers.items()}
    return mods, per


class Routes:
    """While entered, records the expert ids [T, k] of every
    ``route_topk`` call, on the host, in call order.  Given ``ids`` (a list
    of [T, k] in call order: another run's record), each call takes the
    next of them in place of its own top-k instead, with weights from its
    own router probabilities renormalised over them, and ``moved`` counts
    the tokens whose own top-k holds other experts.  Under ``cfg.remat``
    a step routes each MoE layer twice, in the forward in layer order and
    in the backward's recompute in reverse: two runs of one config make
    their calls in the same order, so a record and its replay stay
    aligned, and the recompute replays the forward's ids."""

    def __init__(self, ids=None):
        self.replay = None if ids is None else list(ids)
        self.ids, self.moved = [], 0

    def __enter__(self):
        from repro_torch.models import moe
        self._mod, self._real = moe, moe.route_topk
        replay = None if self.replay is None else iter(self.replay)

        def routed(router_w, x_flat, top_k):
            weights, own, probs = self._real(router_w, x_flat, top_k)
            if replay is None:
                self.ids.append(own.detach().cpu())
                return weights, own, probs
            ids = next(replay).to(x_flat.device)
            self.moved += int((own.sort(dim=-1).values
                               != ids.sort(dim=-1).values).any(-1).sum())
            w = probs.gather(1, ids)
            return w / w.sum(dim=-1, keepdim=True), ids, probs
        moe.route_topk = routed
        return self

    def __exit__(self, *exc):
        self._mod.route_topk = self._real


class StepGradients:
    """While entered, keeps the gradients (``tree_leaves`` order) each
    ``make_train_step`` hands to its AdamW update.  With ``params`` (a
    tree on the card), the update runs there on them and the state the
    step was given, from the gradients moved to the card: AdamW's
    arithmetic is the same on both devices (phase 26 holds it bit for bit
    on these models' trees with the step's decay rule,
    ``ADAMW_LM_ARCHS``), and a CPU update of a G-parameter cut takes half
    a minute."""

    def __init__(self, params=None):
        self.params = params

    def __enter__(self):
        from repro_torch.launch import steps
        from repro_torch.optim.adamw import tree_leaves, tree_unflatten
        self.grads, self._mod, self._real = None, steps, steps.adamw_update

        def recorded(opt, params, grads, state, **kwargs):
            self.grads = tree_leaves(grads)
            if self.params is not None:
                params = self.params
                grads = tree_unflatten(params, [
                    g.to(x.device) for g, x in zip(self.grads,
                                                   tree_leaves(params))])
            return self._real(opt, params, grads, state, **kwargs)
        steps.adamw_update = recorded
        return self

    def __exit__(self, *exc):
        self._mod.adamw_update = self._real


class MoeForms:
    """While entered, counts the calls of each MoE form
    (``moe._experts_sorted``, ``moe._experts_all``) and the grouped
    products (``torch._grouped_mm``) whose output autograd records on the
    card: each such product's backward (``GroupedMmBackward0``) runs in
    the step's backward."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.sorted = self.every = self.grouped = 0
        self._real = [(moe, "_experts_sorted"), (moe, "_experts_all"),
                      (torch, "_grouped_mm")]
        self._real = [(m, name, getattr(m, name)) for m, name in self._real]
        (_, _, srt), (_, _, every), (_, _, grouped) = self._real

        def sorted_form(*args):
            self.sorted += 1
            return srt(*args)

        def every_form(*args):
            self.every += 1
            return every(*args)

        def grouped_mm(*args, **kwargs):
            out = grouped(*args, **kwargs)
            self.grouped += int(out.is_cuda and out.requires_grad)
            return out
        moe._experts_sorted, moe._experts_all = sorted_form, every_form
        torch._grouped_mm = grouped_mm
        return self

    def __exit__(self, *exc):
        for m, name, fn in self._real:
            setattr(m, name, fn)


def train_step_cuda_vs_cpu(arch, num_layers, name, seq=32, batch=2,
                           microbatches=1, prefix=None) -> None:
    """Phase 44: one training step of ``arch`` cut to ``num_layers``
    layers (an encdec model's halves encoder and half decoder layers; a
    vlm's prefix cut to ``prefix`` embeddings) at full width, f32
    activations, TF32 off, on the card (the kernels and their backwards)
    and on the CPU (the plain versions), from the same f32 masters, a
    batch of ``batch`` x ``seq`` tokens (and the family's frames or prefix
    embeddings), one ``make_train_step`` (``microbatches`` micro-batches)
    on each, its gradients taken where it hands them to AdamW
    (``StepGradients``; the CPU's are applied on the card, to a copy of
    the masters): the loss within 1e-5 relative, each gradient
    leaf within 1e-4 of its largest |value|; a MoE model's expert ids of
    every ``route_topk`` equal on both (the card runs the every-expert
    form in f32, the CPU the sorted form: equal ids make the two one
    function); the step's metrics within 1e-5 relative, the first moments
    within 1e-4, and the updated parameters within 1e-4 of each leaf's
    largest |value| plus
    the gradient bar carried through Adam's first step
    (``first_step_spread``: the step moves a parameter by about lr times
    its gradient's sign, so a gradient near zero or near eps moves it by
    up to 2 lr).  The card is held to the CPU's run, except in
    ``DECAY_LEAVES``: there the CPU's f32 gradient is itself ~1e-4 from
    the exact one, and the card is held at the same bars to the f64
    gradient and to the step taken from it (``decay_reference``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import modality_inputs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                         tree_leaves, tree_paths,
                                         tree_unflatten)
    t0 = time.perf_counter()
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    cfg = dataclasses.replace(get_config(arch), num_layers=num_layers,
                              activ_dtype="float32")
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, enc_layers=num_layers // 2,
                                  dec_layers=num_layers // 2)
    if prefix is not None:
        cfg = dataclasses.replace(cfg, num_prefix_embeds=prefix)
    # drawn on the card, where a G-parameter cut takes a second, not the
    # CPU generator's ten or more
    masters = {"cuda": init_params(cfg, seed=13, device="cuda",
                                   keep_f32=True)}
    masters["cpu"] = to_device(masters["cuda"], "cpu")
    t_setup = time.perf_counter() - t0
    rng = np.random.default_rng(44)
    data = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, seq))),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (batch, seq)))}
    data.update(modality_inputs(cfg, batch, rng, device="cpu"))
    mods, per = trained_kernels(cfg)
    paths = tree_paths(masters["cpu"])
    # the CPU's step updates a copy of the masters on the card from its
    # gradients (``StepGradients``), made before the card's step updates
    # the card's masters; the CPU's masters stay as drawn
    update = {"cuda": None, "cpu": tree_unflatten(masters["cuda"], [
        x.clone() for x in tree_leaves(masters["cuda"])])}
    out, losses, grads, launches, secs, ids, forms = ({} for _ in range(7))
    for dev, p in masters.items():
        t1 = time.perf_counter()
        zero_counts(mods)
        with Routes() as rec, MoeForms() as form, \
                StepGradients(update[dev]) as step:
            out[dev] = make_train_step(
                cfg, opt, num_microbatches=microbatches)(
                    p, init_opt_state(update[dev] or p),
                    to_device(data, dev))
        grads[dev], ids[dev] = step.grads, rec.ids
        forms[dev] = (form.sorted, form.every)
        launches[dev] = kernel_counts(mods)
        losses[dev] = float(out[dev][2]["loss"])
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t1
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if rel > 1e-5:
        fail(f"phase 44: {arch} loss {losses['cuda']} on the card, "
             f"{losses['cpu']} on the cpu")
    moe_calls = (len(cfg.layer_kinds) if cfg.num_experts else 0) \
        * microbatches * recomputes(cfg)
    if cfg.num_experts and (
            len(ids["cuda"]) != moe_calls or forms["cuda"] != (
                0, moe_calls) or forms["cpu"] != (moe_calls, 0)
            or not all(map(torch.equal, ids["cuda"], ids["cpu"]))):
        fail(f"phase 44: {arch}'s expert ids differ between the card and "
             f"the cpu, or a form other than the size rule's ran: (sorted, "
             f"every-expert) calls {forms}")
    exact = decay_reference(cfg, masters["cpu"], data, grads, opt)
    want_g = [exact[i][0] if i in exact else g
              for i, g in enumerate(grads["cpu"])]
    worst = leaves_close(f"{arch} gradient", grads["cuda"], (paths, want_g))
    want = {k: (f * microbatches, b * microbatches)
            for k, (f, b) in per.items()}
    if launches["cuda"] != want or any(
            c != (0, 0) for c in launches["cpu"].values()):
        fail(f"phase 44: {arch} launched (forward, backward) "
             f"{launches}, not {want} on the card and none on the cpu")
    for k in out["cpu"][2]:
        a, w = float(out["cuda"][2][k]), float(out["cpu"][2][k])
        if abs(a - w) > 1e-5 * abs(w):
            fail(f"phase 44: {arch} step metric {k} {a} on the card, {w} "
                 f"on the cpu")
    mu = [exact[i][1] if i in exact else m
          for i, m in enumerate(tree_leaves(out["cpu"][1].mu))]
    worst_mu = leaves_close(f"{arch} first moment",
                            tree_leaves(out["cuda"][1].mu), (paths, mu))
    want_p = [exact[i][2] if i in exact else w
              for i, w in enumerate(tree_leaves(out["cpu"][0]))]
    lr, loose = float(out["cpu"][2]["lr"]), 0
    for path, a, w, m in zip(paths, tree_leaves(out["cuda"][0]), want_p,
                             mu):
        # on the card: the same IEEE operations, in a second, not minutes
        w = w.to(a.device)
        err = (a - w).abs()
        bar = 1e-4 * float(w.abs().max())
        moved = lr * first_step_spread(m.to(a.device), opt)
        loose += int((err > bar).sum())
        if not bool((err <= bar + moved).all()):
            fail(f"phase 44: {arch} updated {path} differs by "
                 f"{float(err.max())} (bar {bar} + the gradient bar "
                 f"carried through the step)")
    extra = (f"{prefix} prefix embeddings + " if prefix is not None
             else "")
    print(f"{arch}, {num_layers} layers, f32, {batch} x {extra}{seq} "
          f"tokens: loss "
          f"{losses['cuda']:.6f} on the card, {losses['cpu']:.6f} on the "
          f"cpu (rel {rel:.2e}, tolerance 1e-5); gradients within "
          f"{worst:.2e} of each leaf's largest |value| (tolerance 1e-4"
          + (f"; {len(exact)} decay leaves against f64" if exact else "")
          + "), "
          + (f"expert ids of {moe_calls} MoE layer calls equal (the "
             f"card's every-expert form, the cpu's sorted form), "
             if cfg.num_experts else "")
          + f"first moments {worst_mu:.2e}; (forward, backward) launches "
          f"{ {k: c for k, c in launches['cuda'].items() if any(c)} }; one "
          f"step ({microbatches} micro-batch"
          f"{'es' if microbatches > 1 else ''}): metrics within 1e-5, "
          f"parameters within the bar ({loose} "
          f"elements past 1e-4 of their leaf's largest |value|, each "
          f"within the gradient bar carried through the step); the step "
          f"{secs['cuda']:.1f} s on the card, {secs['cpu']:.1f} s "
          f"on the cpu, the f32 masters' init and copy {t_setup:.1f} s, the "
          f"comparisons the rest of the phase's "
          f"{time.perf_counter() - t0:.1f} s (host clock)")
    del masters, grads, out
    torch.cuda.empty_cache()
    phase(name, t0)


def moe_bf16_train_step(dev) -> None:
    """Phase 44's bf16 case: granite-moe-1b-a400m cut to two layers at full
    width, its layers in bf16 from the same f32 masters on the card and
    the CPU, ``MOE_BF16_BATCH`` tokens: T E d ff = 6.87e10 reaches
    ``SORTED_MIN_MACS``, so the card runs the sorted form (grouped
    products, their backward ``GroupedMmBackward0`` and the gathers of
    ``_add_in_order``), as the CPU does.  The CPU routes each token to the
    experts the card chose (``Routes``): the random router's
    probabilities lie so close together that bf16 rounding upstream moves
    a fifth of the tokens to other experts (158 and 792 of 4096 in the
    two layers, NVIDIA H100 80GB HBM3, 700 W), and each run then lands as
    far from the f32 run as from the other (0.24-0.29 of a leaf's largest
    |value|); the routing itself is held in the f32 cases.  Bars: the loss
    within the bf16 logits' bar (6.25e-2 + 3e-2 relative) and each
    gradient leaf within 6.25e-2 of its largest |value|
    (``tests/test_torch_lm_bf16_moe.py``'s bar); the grouped products
    autograd records counted on the card (3 a layer, twice under remat:
    the forward and its recompute in the backward, whose routes the CPU
    replays in the same call order); the card's host
    syncs in the loss and its gradient, by line; the tokens whose own
    top-k differs on the CPU, printed."""
    import collections
    import dataclasses
    import warnings
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.moe import SORTED_MIN_MACS
    from repro_torch.optim.adamw import tree_leaves, tree_paths
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(GRANITE), num_layers=2)
    b, s = MOE_BF16_BATCH
    if b * s * cfg.num_experts * cfg.d_model * cfg.moe_d_ff < SORTED_MIN_MACS:
        fail(f"phase 44: {b} x {s} tokens do not reach SORTED_MIN_MACS")
    masters = {"cuda": init_params(cfg, seed=13, device="cuda",
                                   keep_f32=True)}
    masters["cpu"] = to_device(masters["cuda"], "cpu")
    rng = np.random.default_rng(44)
    data = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
            for k in ("tokens", "labels")}
    losses, grads, secs, forms = {}, {}, {}, {}
    syncs = collections.Counter()
    for d, p in masters.items():
        t1 = time.perf_counter()
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        routes = Routes(None if d == "cuda" else card_ids)
        with routes, MoeForms() as form, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if d == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                loss, _ = loss_fn(p, cfg, to_device(data, d))
                grads[d] = torch.autograd.grad(loss, leaves)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if d == "cuda":
            card_ids = routes.ids
            syncs.update(f"{Path(w.filename).name}:{w.lineno}"
                         for w in caught
                         if "synchroniz" in str(w.message))
        for x in leaves:
            x.requires_grad_(False)
        forms[d] = (form.sorted, form.every, form.grouped)
        losses[d] = float(loss.detach())
        torch.cuda.synchronize()
        secs[d] = time.perf_counter() - t1
    calls = 2 * recomputes(cfg)
    if forms["cuda"] != (calls, 0, 3 * calls) or \
            forms["cpu"][:2] != (calls, 0):
        fail(f"phase 44: bf16 {GRANITE} ran (sorted, every-expert, grouped "
             f"products recorded on the card) {forms}, not the sorted form "
             f"{calls} times on both with {3 * calls} grouped products on "
             f"the card")
    if abs(losses["cuda"] - losses["cpu"]) > 6.25e-2 + 3e-2 * abs(
            losses["cpu"]):
        fail(f"phase 44: bf16 {GRANITE} loss {losses['cuda']} on the card, "
             f"{losses['cpu']} on the cpu")
    worst = leaves_close(f"bf16 {GRANITE} gradient", grads["cuda"],
                         (tree_paths(masters["cpu"]), grads["cpu"]),
                         bar=6.25e-2)
    print(f"{GRANITE}, 2 layers, bf16 layers, f32 masters, {b} x {s} "
          f"tokens, the sorted form on both (grouped products recorded "
          f"on the card: {forms['cuda'][2]}), the cpu on the card's "
          f"experts (its own top-k differs for {routes.moved} of "
          f"{calls * b * s} tokens over the two layers' {calls} calls): "
          f"loss "
          f"{losses['cuda']:.6f} on the card, {losses['cpu']:.6f} on the "
          f"cpu (tolerance 6.25e-2 + 3e-2 relative); gradients within "
          f"{worst:.2e} of each leaf's largest |value| (tolerance "
          f"6.25e-2); host syncs in the card's loss and gradient "
          f"{sum(syncs.values())}, by line {dict(syncs)}; "
          f"{secs['cuda']:.1f} s on the card, {secs['cpu']:.1f} s on the "
          f"cpu (host clock)")
    del masters, grads
    torch.cuda.empty_cache()
    phase(f"44 {GRANITE} bf16 train step, the sorted form", t0)


def train_main(argv, where):
    """``launch/train.py`` through its ``main`` at ``argv`` on the card
    (full width and depth: f32 masters, bf16 layers).  Every step's loss
    finite, the mean of the last 5 below that of the first 5; each kernel's
    forward and backward launches (``trained_kernels``), counted from 0
    around the run, per layer of its kind a step once in the backward and
    ``recomputes`` times in the forward; each step's host
    syncs (torch's sync debug mode, inside the train step).  An earlier
    phase's models are freed first, so that the run's peak memory is its
    own.  ``where`` names the phase in failures.  Returns {kernel:
    (forward, backward launches)}."""
    import collections
    import contextlib
    import gc
    import io
    import math
    import re
    import warnings
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    arch = argv[argv.index("--arch") + 1]
    steps = int(argv[argv.index("--steps") + 1])
    mods, per = trained_kernels(get_config(arch))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{arch}: device memory before the run "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    losses, syncs = [], collections.Counter()
    make = train.make_train_step

    def recorded(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = step(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.update(f"{Path(w.filename).name}:{w.lineno}"
                         for w in caught)
            losses.append(out[2]["loss"])
            return out
        return run

    train.make_train_step = recorded
    buf = io.StringIO()
    zero_counts(mods)
    try:
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv)
    finally:
        train.make_train_step = make
    launches = kernel_counts(mods)
    out = buf.getvalue()
    print(out.rstrip())
    vals = [float(x) for x in losses]
    if rc != 0 or len(vals) != steps or not all(map(math.isfinite, vals)):
        fail(f"{where}: train.main returned {rc} with losses {vals}")
    first, last = sum(vals[:5]) / 5, sum(vals[-5:]) / 5
    if not last < first:
        fail(f"{where}: {arch}'s loss did not fall: {vals}")
    want = {k: (f * steps, b * steps) for k, (f, b) in per.items()}
    if launches != want:
        fail(f"{where}: {arch} launched (forward, backward) {launches}, "
             f"not {want}: per layer of the kernel's kind a step, the "
             f"backward once, the forward once, or twice under remat")
    peak = re.search(r"peak device memory: ([\d.]+) GiB", out)
    rate = re.search(r"step time: ([\d.]+) ms .*?; (\d+) tokens/s", out)
    print(f"train.py {arch} full, {steps} steps: losses "
          f"{[round(x, 4) for x in vals]}; mean of the first 5 {first:.4f}, "
          f"of the last 5 {last:.4f}; (forward, backward) launches "
          f"{ {k: c for k, c in launches.items() if any(c)} } (per layer "
          f"of its kind a step: the forward {recomputes(get_config(arch))} "
          f"time(s), the backward once); step time "
          f"{rate.group(1) if rate else '?'} ms, "
          f"{rate.group(2) if rate else '?'} tokens/s; host syncs in the "
          f"train step {sum(syncs.values()) / steps:.1f} a step, by line "
          f"{dict(syncs)}; peak {peak.group(1) if peak else '?'} GiB on "
          f"{card_line()}")
    return launches


def train_lm_full(dev):
    """Phase 45: ``train_main`` at ``TRAIN_ARGV``: qwen2.5-3b at full
    width and depth, 10 steps of 8 x 128 tokens, its flash kernel's
    forward and backward.  Returns the flash launches."""
    t0 = time.perf_counter()
    launches = train_main(TRAIN_ARGV, "phase 45")
    phase("45 train.py, qwen2.5-3b at full width", t0)
    return launches["flash_attention"]


def train_scans_full(dev):
    """Phase 47: ``train_main`` at each of ``SCAN_TRAIN_ARGV``, mamba2-370m
    (the SSD kernel and its backward) and then, the first run's memory
    released, recurrentgemma-2b (the RG-LRU kernel and its backward, and
    the flash kernel's in its local layers).  Returns the launches summed
    over both runs."""
    t0 = time.perf_counter()
    total = {}
    for argv in SCAN_TRAIN_ARGV:
        for k, (f, b) in train_main(argv, "phase 47").items():
            f0, b0 = total.get(k, (0, 0))
            total[k] = (f0 + f, b0 + b)
    phase("47 train.py, mamba2-370m and recurrentgemma-2b at full width",
          t0)
    return total


def train_moe_full(dev):
    """Phase 49: ``train_main`` at ``MOE_TRAIN_ARGV``: granite-moe-1b-a400m
    at full width and depth, 10 steps of 8 x 512 tokens.  Beside
    ``train_main``'s checks (48 flash forward and 24 backward launches a
    step), every MoE layer of every step runs the sorted form twice (the
    forward and its recompute: 48 a step, no every-expert call), each time
    with its three grouped products on the card under autograd, the
    forward's backward run in the step; the flash kernel and its backward
    held to their plain versions at the shapes the run gave them
    (``MainPathShapes``); ``moe_remat_against_kept``.  Returns the flash
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fl_ops
    t0 = time.perf_counter()
    steps = int(MOE_TRAIN_ARGV[MOE_TRAIN_ARGV.index("--steps") + 1])
    layers = get_config(GRANITE).num_layers
    with MoeForms() as forms, MainPathShapes(
            {"flash_attention": fl_ops},
            trained=("flash_attention",)) as shapes_seen:
        launches = train_main(MOE_TRAIN_ARGV, "phase 49")
    calls = layers * steps * recomputes(get_config(GRANITE))
    want = (calls, 0, 3 * calls)
    got = (forms.sorted, forms.every, forms.grouped)
    if got != want:
        fail(f"phase 49: {GRANITE} ran (sorted, every-expert, grouped "
             f"products under autograd) {got}, not {want}")
    print(f"phase 49: {GRANITE}'s MoE layers ran the sorted form "
          f"{got[0]} times (forward and recompute), the every-expert form "
          f"0, grouped products under autograd {got[2]} (the forward's "
          f"backward in each step)")
    print(f"phase 49: the flash kernel and its backward at the "
          f"{len(shapes_seen.seen)} (shape, options) the run launched them "
          f"at, on seeded inputs, against their plain versions:")
    shapes_seen.check(dev)
    moe_remat_against_kept()
    phase(f"49 train.py, {GRANITE} at full width", t0)
    return launches["flash_attention"]


def moe_remat_against_kept() -> None:
    """Phase 49's remat check: one loss and gradient of granite-moe-1b-a400m
    at full width and depth, bf16 layers, f32 masters, ``MOE_TRAIN_ARGV``'s
    8 x 512 tokens, with ``cfg.remat`` and without, from the same masters
    and batch.  Each MoE layer's expert ids equal in the forward and in
    its recompute (``Routes``: the forward's calls in layer order, then
    the backward's in reverse) and in the kept run; the gradients bit for
    bit, else each leaf within ``REMAT_BAR`` of its largest |value| (the
    leaves that differ and the largest difference printed); each run's
    time and peak memory."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim.adamw import tree_leaves, tree_paths
    cfg = get_config(GRANITE)
    b = int(MOE_TRAIN_ARGV[MOE_TRAIN_ARGV.index("--batch") + 1])
    s = int(MOE_TRAIN_ARGV[MOE_TRAIN_ARGV.index("--seq") + 1])
    masters = init_params(cfg, seed=49, device="cuda", keep_f32=True)
    leaves = tree_leaves(masters)
    rng = np.random.default_rng(49)
    data = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
            for k in ("tokens", "labels")}
    runs = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for x in leaves:
            x.requires_grad_(True)
        t1 = time.perf_counter()
        with Routes() as routes:
            loss, _ = loss_fn(masters, c, data)
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        for x in leaves:
            x.requires_grad_(False)
        peak = torch.cuda.max_memory_allocated() - base
        runs[remat] = (float(loss), grads, routes.ids, secs, peak)
    (l1, g1, ids1, s1, p1), (l0, g0, ids0, s0, p0) = runs[True], runs[False]
    n = cfg.num_layers
    fwd, again = ids1[:n], ids1[n:][::-1]
    if len(ids1) != 2 * n or len(ids0) != n or not all(
            torch.equal(a, x) and torch.equal(a, k)
            for a, x, k in zip(fwd, again, ids0)):
        fail(f"phase 49: {GRANITE}'s expert ids differ between the forward, "
             f"its recompute and the kept run ({len(ids1)} and {len(ids0)} "
             f"route calls)")
    paths = tree_paths(masters)
    differ, worst = [], 0.0
    for path, a, w in zip(paths, g1, g0):
        if torch.equal(a, w):
            continue
        err, scale = leaf_error(a, w)
        differ.append(path)
        worst = max(worst, err / scale)
        if err > REMAT_BAR * scale:
            fail(f"phase 49: {GRANITE}'s remat gradient {path} differs by "
                 f"{err} from the kept run's (bar {REMAT_BAR} of {scale})")
    print(f"phase 49: {GRANITE} at full depth, bf16 layers, {b} x {s} "
          f"tokens, remat against kept: loss {l1:.6f} / {l0:.6f}; expert "
          f"ids of {n} MoE layers equal in the forward, its recompute and "
          f"the kept run; gradients bit-equal in {len(paths) - len(differ)} "
          f"of {len(paths)} leaves, the rest within {worst:.2e} of their "
          f"largest |value| (bar {REMAT_BAR}; the first that differ: "
          f"{differ[:4]}); loss and gradient {s1:.2f} s / {s0:.2f} s, peak "
          f"{p1 / 2**30:.2f} / {p0 / 2**30:.2f} GiB over the masters (host "
          f"clock, {card_line()})")
    del masters, leaves, runs, g1, g0
    torch.cuda.empty_cache()


#: phase 50 (d)'s training rows at 16 x 16: the dense family's rows that
#: one card skips ("state")
MESH_TRAIN_ARCHS = ("deepseek-7b", "gemma2-9b", "gemma2-9b-swa",
                    "llama3-8b", "llama3-8b-swa")
#: phase 50 (d)'s dry runs, one process each, side by side: (archs,
#: shapes, mesh)
MESH_ROWS = ([((arch,), ("train_4k",), "16x16") for arch in MESH_TRAIN_ARCHS]
             + [(("llama3-8b",), ("prefill_32k", "decode_32k"), "16x16"),
                (("llama3-8b",), ("prefill_32k",), "2x16x16")])
#: the kernels a dense mesh row launches, and those with a backward
MESH_KERNELS = ("flash_attention", "decode_attention")
MESH_TRAINED = ("flash_attention",)
#: phase 50 (b): llama3-8b's decode_32k cache a card at 16 x 16 (8 rows of
#: the 128), cut into the 16 sequence shards of the 'model' axis
SEQ_DECODE = (8, 32, 8, 32768, 128, 16)
#: phase 50 (c): (name, (B, H, KV, S, T, D), options) of flash launches on
#: one rank's heads of a 16-way 'model' axis at train_4k (2 sequences a
#: micro-batch a card) that (d)'s rows must have made
LOCAL_FLASH = [("llama3-8b", (2, 2, 1, 4096, 4096, 128), {}),
               ("gemma2-9b", (2, 1, 1, 4096, 4096, 256),
                {"window": 4096, "softcap": 50.0})]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_mesh_equal(dev):
    """Phase 50 (a): the 1x1 mesh over NCCL (``make_host_mesh``) against
    the unsharded path, bit for bit: llama3-8b at full width and depth, a
    prefill of 2 x 256 tokens and 8 decode steps of fixed tokens (every
    logit equal, the flash kernel launched once a layer, the decode kernel
    once a layer a step on the mesh run), then one qwen2.5-3b training step
    at phase 45's 8 x 128 tokens from the same f32 masters (the metrics
    equal, and every updated parameter and moment, by a 64-bit sum of its
    32-bit words a leaf); the flash kernel and its backward, and the
    decode kernel, at every shape the mesh runs launched them at against
    their plain versions (``MainPathShapes``).  Returns the mesh runs'
    (flash, decode) launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.model import shard_params
    from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                         tree_leaves)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        cfg = get_config("llama3-8b")
        params = init_params(cfg, seed=50, device=dev)
        gen = torch.Generator(device=dev).manual_seed(50)
        prompt = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                               device=dev)
        nxt = torch.randint(0, cfg.vocab_size, (8, 2, 1), generator=gen,
                            device=dev)

        def serve(p):
            with torch.no_grad():
                logits, cache = prefill(p, cfg, prompt, max_seq=264)
                outs = [logits]
                for tok in nxt:
                    logits, cache = decode_step(p, cfg, tok, cache)
                    outs.append(logits)
            return outs
        plain = serve(params)
        fl_ops.launches = dec_ops.launches = 0
        shapes = MainPathShapes({"flash_attention": fl_ops,
                                 "decode_attention": dec_ops},
                                trained=MESH_TRAINED)
        with shapes, st.on_mesh(mesh, "serve"):
            meshed = serve(shard_params(cfg, params, mesh, "serve"))
        launches = (fl_ops.launches, dec_ops.launches)
        torch.cuda.synchronize()
        if launches != (cfg.num_layers, 8 * cfg.num_layers):
            fail(f"phase 50 (a): the 1x1 mesh's llama3-8b run launched "
                 f"(flash, decode) {launches}")
        if not all(torch.equal(a, b) for a, b in zip(plain, meshed)):
            fail("phase 50 (a): llama3-8b's logits on the 1x1 mesh differ "
                 "from the unsharded path's")
        del params, plain, meshed
        torch.cuda.empty_cache()
        cfg = get_config("qwen2.5-3b")
        batch = {k: torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                                  device=dev) for k in ("tokens", "labels")}

        def train(on):
            masters = init_params(cfg, seed=50, device=dev, keep_f32=True)
            step = st.make_train_step(cfg, AdamWConfig(), mesh=on)
            p, o, m = step(masters, init_opt_state(masters), batch)
            words = torch.stack([x.view(torch.int32).sum(dtype=torch.int64)
                                 for x in tree_leaves((p, o.mu, o.nu))])
            return words, {k: v.clone() for k, v in m.items()}
        w0, m0 = train(None)
        torch.cuda.empty_cache()
        with shapes:
            w1, m1 = train(mesh)
        torch.cuda.empty_cache()
        if not torch.equal(w0, w1) or not all(torch.equal(m0[k], m1[k])
                                              for k in m0):
            fail(f"phase 50 (a): qwen2.5-3b's step on the 1x1 mesh differs "
                 f"from the unsharded step's: loss {float(m1['loss'])} / "
                 f"{float(m0['loss'])}, {int((w0 != w1).sum())} leaves")
        print(f"phase 50 (a): the 1x1 mesh over NCCL == the unsharded path, "
              f"bit for bit: llama3-8b's prefill of 2 x 256 tokens and 8 "
              f"decode steps ({launches[0]} flash, {launches[1]} decode "
              f"launches), qwen2.5-3b's training step at 8 x 128 (loss "
              f"{float(m1['loss']):.6f}, {len(w0)} leaves of parameters "
              f"and moments); each kernel at the {len(shapes.seen)} (shape,"
              f" options) the mesh runs launched it at, against its plain "
              f"version:")
        shapes.check(dev)
        return launches
    finally:
        dist.destroy_process_group()


def decode_stats_close(where, got, want) -> None:
    """The decode kernel's softmax statistics (out, m, l) against
    ``ref.py``'s: m within 1e-3 + 1e-3 |m|, l within 1e-3 relative."""
    (_, m, ll), (_, wm, wl) = got, want
    if not bool(((m - wm).abs() <= 1e-3 + 1e-3 * wm.abs()).all()) or \
            not bool(((ll - wl).abs() <= 1e-3 * wl.abs()).all()):
        fail(f"{where}: the decode kernel's statistics differ from "
             f"ref.py's: m by {float((m - wm).abs().max())}, l by "
             f"{float(((ll - wl) / wl).abs().max())} relative")


def seq_decode_merge(dev) -> float:
    """Phase 50 (b): ``SEQ_DECODE``, llama3-8b's decode_32k cache of a
    card, in bf16: the decode kernel over each of 16 sequence shards with
    its softmax statistics, merged by the reference's formula (the max of
    the shards' maxima m, then the sums of l e^(m - max) and of the
    outputs scaled by it), against one call over the whole cache and
    against the f32 plain version at the decode bar (``attention_close``:
    each shard's output is rounded to bf16 before the merge); the
    statistics against ``ref.py``'s (m
    within 1e-3 + 1e-3 |m|, l within 1e-3 relative), from the kernel's
    split merge, from its one split (``BLOCKS_PER_SM`` 0) and from the f32
    kernel.  Returns the largest error of the merged output."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    b, h, kv, t, d, n = SEQ_DECODE
    q, k, v = randn([(b, h, d), (b, kv, t, d), (b, kv, t, d)],
                    torch.bfloat16, 50, dev)
    full = lambda rows: torch.full((b,), rows, dtype=torch.int32,
                                   device=dev)
    whole = dec_ops.decode(q, k, v, full(t))
    rows = t // n
    parts = [dec_ops.decode(q, k[:, :, i * rows:(i + 1) * rows],
                            v[:, :, i * rows:(i + 1) * rows], full(rows),
                            stats=True) for i in range(n)]
    top = torch.stack([m for _, m, _ in parts]).amax(0)
    w = [ll * torch.exp(m - top) for _, m, ll in parts]
    merged = sum(o.float() * x[..., None] for (o, _, _), x in
                 zip(parts, w)) / torch.clamp(sum(w), min=1e-30)[..., None]
    err = attention_close("phase 50 (b) merged against one call", merged,
                          whole)
    want32 = dec_ref.decode_reference(q.float(), k.float(), v.float(),
                                      full(t))
    err32 = attention_close("phase 50 (b) merged against f32 plain",
                            merged, want32.to(torch.bfloat16))

    def stats_close(where, got, want):
        decode_stats_close(f"phase 50 (b) {where}", got, want)
    sk, sv = k[:, :, :rows], v[:, :, :rows]
    want = dec_ref.decode_reference(q.float(), sk.float(), sv.float(),
                                    full(rows), stats=True)
    stats_close("(bf16, split)", parts[0], want)
    saved = dec_ops.BLOCKS_PER_SM
    dec_ops.BLOCKS_PER_SM = 0
    try:
        stats_close("(bf16, one split)", dec_ops.decode(
            q, sk, sv, full(rows), stats=True), want)
        stats_close("(f32, one split)", dec_ops.decode(
            q.float(), sk.float(), sv.float(), full(rows), stats=True), want)
    finally:
        dec_ops.BLOCKS_PER_SM = saved
    stats_close("(f32, split)", dec_ops.decode(
        q.float(), sk.float(), sv.float(), full(rows), stats=True), want)
    print(f"phase 50 (b): llama3-8b's decode_32k cache ({b}, {h}, {kv}, "
          f"{t}, {d}) in {n} sequence shards through the kernel, merged: "
          f"max |err| {err:.3g} against one call (atol 2e-2, rtol 1e-2), "
          f"{err32:.3g} against the f32 plain version (the same bar);"
          f" statistics == ref.py's (bf16 and f32, split and one split)")
    return err


def mesh_rows_child(index: int, out: Path) -> None:
    """Phase 50 (d)'s child process (``chip_smoke.py --mesh-rows I OUT``):
    ``MESH_ROWS[I]`` through ``dryrun.main`` into ``OUT``, one call a
    shape, ``DRYRUN_REPS`` timed steps a row; each kernel's (forward,
    backward) launches set to 0 before a call and read after it, and every
    (shape, options) the kernels were launched at (``MainPathShapes``, the
    decode kernel's lengths with them), written to ``OUT``/kernels.json
    for the parent's checks.  Exits with ``dryrun.main``'s code."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun
    archs, shapes, mesh = MESH_ROWS[index]
    mods = {k: m for k, m in llm_kernel_ops().items() if k in MESH_KERNELS}
    seen = MainPathShapes(mods, trained=MESH_TRAINED)
    calls, rc = [], 0
    with seen:
        for arch in archs:
            for shape in shapes:
                zero_counts(mods)
                rc |= dryrun.main(["--arch", arch, "--shape", shape,
                                   "--mesh", mesh, "--reps",
                                   str(DRYRUN_REPS), "--out", str(out)])
                calls.append({"arch": arch, "shape": shape,
                              "launches": kernel_counts(mods)})

    def plain(x):
        if isinstance(x, tuple):
            return [plain(v) for v in x]
        return str(x) if isinstance(x, torch.dtype) else x
    (out / "kernels.json").write_text(json.dumps({"calls": calls, "seen": [
        [name, bwd, plain(key), None if n is None else n.tolist()]
        for (name, bwd, key), n in seen.seen.items()]}))
    sys.exit(rc)


def launch_key(x):
    """A ``MainPathShapes`` key from its json form (``mesh_rows_child``)."""
    import torch
    if isinstance(x, list):
        return tuple(launch_key(v) for v in x)
    if isinstance(x, str) and x.startswith("torch."):
        return getattr(torch, x[len("torch."):])
    return x


def mesh_dry_run(dev):
    """Phase 50 (d): the dry run's mesh rows, each in a process of its own
    (``mesh_rows_child``) under the fake process group (rank 0's step on
    the card), the processes side by side (``MESH_ROWS``):
    ``MESH_TRAIN_ARCHS``' train_4k and llama3-8b's prefill_32k and
    decode_32k at 16 x 16, llama3-8b's prefill_32k at 2 x 16 x 16.  Every
    row ``ok`` with 256 or 512 chips, a collective term above 0 and rank
    0's peak (its own process's) under 3/4 of the card; each row's flash
    and decode launches, forward and backward, equal to its layers times
    its steps (``dryrun_launches``: a training row's per micro-batch,
    twice in the forward under remat); the serve driver's pool table reads
    the 16 x 16 rows with its default mesh.  The processes share the card
    and the host, so the rows' measured steps here are not rank 0's alone
    (``PERF.md``'s come from the rows run one at a time).  Returns the
    launch keys the rows recorded ({(name, backward, key): lengths}) and
    the rows' launches ({name: (forward, backward)})."""
    import os
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.serving.pool import pool_table_from_dryrun
    torch.cuda.empty_cache()   # the card for the rows' processes
    out = ROOT / "chiprun_out" / "dryrun-mesh"
    out.mkdir(parents=True, exist_ok=True)
    artifact = out / "dryrun.jsonl"
    artifact.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t1 = time.perf_counter()
    procs = []
    try:
        for i, (archs, shapes, mesh) in enumerate(MESH_ROWS):
            sub = out / f"rows-{i}"
            sub.mkdir(exist_ok=True)
            for name in ("dryrun.jsonl", "kernels.json"):
                (sub / name).unlink(missing_ok=True)
            log = open(out / f"log-{i}-{mesh}-{shapes[0]}.txt", "w")
            procs.append((archs, shapes, mesh, sub, log, subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rows",
                 str(i), str(sub)], env=env, stdout=log,
                stderr=subprocess.STDOUT)))
        for archs, shapes, mesh, sub, log, proc in procs:
            rc = proc.wait(timeout=max(1.0, 900 - (time.perf_counter()
                                                  - t1)))
            log.close()
            print(f"phase 50 (d): {mesh} rows of {', '.join(archs)} at "
                  f"{', '.join(shapes)}: exit {rc} at "
                  f"{time.perf_counter() - t1:.1f} s")
            if rc:
                fail(f"phase 50 (d): the {mesh} dry run of {archs} failed:"
                     f"\n{Path(log.name).read_text()[-3000:]}")
    finally:
        for *_, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    seen, total = {}, {k: (0, 0) for k in MESH_KERNELS}
    with open(artifact, "w") as f:
        for *_, sub, _, _ in procs:
            f.write((sub / "dryrun.jsonl").read_text())
            made = json.loads((sub / "kernels.json").read_text())
            for r, call in zip((json.loads(x) for x in (
                    sub / "dryrun.jsonl").read_text().splitlines()),
                    made["calls"]):
                cfg = get_config(r["arch"])
                shape = dryrun.INPUT_SHAPES[r["shape"]]
                fwd, bwd = dryrun_launches(cfg, shape.kind, 1 + DRYRUN_REPS,
                                           dryrun.microbatches(cfg, shape))
                want = {k: (fwd[k], bwd.get(k, 0)) for k in MESH_KERNELS}
                got = {k: tuple(v) for k, v in call["launches"].items()}
                if (r["arch"], r["shape"]) != (call["arch"], call["shape"]) \
                        or got != want:
                    fail(f"phase 50 (d): row {r['arch']} {r['shape']} "
                         f"{r['mesh']} launched (forward, backward) {got}, "
                         f"not {want}")
                print(f"  {r['arch']} {r['shape']} {r['mesh']}: launches "
                      f"(forward, backward) {got} == its layers x steps")
                total = {k: (total[k][0] + got[k][0], total[k][1] + got[k][1])
                         for k in total}
            for name, bwd, key, lengths in made["seen"]:
                seen.setdefault((name, bwd, launch_key(key)), None if
                                lengths is None else torch.tensor(
                                    lengths, dtype=torch.int32, device=dev))
    rows = [json.loads(ln) for ln in artifact.read_text().splitlines()]
    want = {(a, s, m) for archs, shapes, m in MESH_ROWS for a in archs
            for s in shapes}
    got = {(r["arch"], r["shape"], r["mesh"]) for r in rows}
    room = 0.75 * torch.cuda.get_device_properties(0).total_memory / 2**30
    for r in rows:
        chips = {"16x16": 256, "2x16x16": 512}[r["mesh"]]
        if r["status"] != "ok" or r["chips"] != chips or not \
                r["t_collective_s"] > 0 or not r["peak_memory_gb"] < room:
            fail(f"phase 50 (d): row {r}")
        print(f"mesh row {r['arch']} {r['shape']} {r['mesh']}: flops/chip "
              f"{r['flops_per_chip']:.4e}, bytes/chip "
              f"{r['bytes_per_chip']:.4e}, collective {r['coll_by_kind']};"
              f" compute {r['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{r['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{r['t_collective_s'] * 1e3:.3f} ms; rank 0 measured "
              f"{r['measured_step_s'] * 1e3:.3f} ms beside the other rows' "
              f"processes, peak {r['peak_memory_gb']:.2f} GiB "
              f"({card_line()})")
    if got != want or len(rows) != len(want):
        fail(f"phase 50 (d): rows {sorted(got)}, not {sorted(want)}")
    table = pool_table_from_dryrun(str(artifact), device="cpu")
    if not any(e.model == "llama3-8b" for e in table.entries):
        fail("phase 50 (d): the pool table read no 16x16 row")
    return seen, total


def mesh_kernels(dev, seen) -> None:
    """Phase 50 (c): the flash kernel and its backward, and the decode
    kernel, at every (shape, options) (d)'s rows launched them at (rank
    0's heads of a 16-way 'model' axis and its batch rows; the decode
    kernel over a sequence shard of the cache, with its statistics), on
    seeded inputs, against their plain versions (``MainPathShapes.check``:
    the forward at the JAX tests' bar and the f32 plain version's, the
    backward at phase 43's, the statistics at phase 50 (b)'s); among them
    ``LOCAL_FLASH``'s shapes, forward and backward."""
    import torch
    mods = {k: m for k, m in llm_kernel_ops().items() if k in MESH_KERNELS}
    for name, (b, h, kv, s, t, d), kw in LOCAL_FLASH:
        key = ((b, h, s, d), (b, kv, t, d), torch.bfloat16, True,
               kw.get("window"), kw.get("softcap"))
        if not all(("flash_attention", bwd, key) in seen
                   for bwd in (False, True)):
            fail(f"phase 50 (c): (d)'s rows made no flash launch, forward "
                 f"and backward, on {name}'s heads of one rank {key}")
    checks = MainPathShapes(mods, trained=MESH_TRAINED)
    checks.seen = seen
    print(f"phase 50 (c): each kernel at the {len(seen)} (shape, options) "
          f"(d)'s rows launched it at, on seeded inputs, against its plain "
          f"version:")
    checks.check(dev)


def mesh_phase(dev):
    """Phase 50: the production mesh of the dense family (``host_mesh_equal``,
    ``seq_decode_merge``, ``mesh_dry_run``, ``mesh_kernels``).  Returns the
    flash and decode launches ({name: (forward, backward)}) of (a)'s mesh
    runs and (d)'s rows."""
    t0 = time.perf_counter()
    flash, decode = host_mesh_equal(dev)
    seq_decode_merge(dev)
    seen, launches = mesh_dry_run(dev)
    mesh_kernels(dev, seen)
    phase("50 the production mesh of the dense family", t0)
    f, b = launches["flash_attention"]
    launches["flash_attention"] = (f + flash, b)
    f, b = launches["decode_attention"]
    launches["decode_attention"] = (f + decode, b)
    return launches


def moe_layer_check(dev) -> None:
    """Phase 29: one granite-moe-1b-a400m MoE layer at full width on the
    card in bf16 against the same layer in f32 (the bf16 weights widened),
    on one input drawn in bf16 and widened for the f32 layer, at phase 30's
    prefill (8 x 256 tokens) and decode (8 tokens): the same experts, and
    the largest per-token relative error (L2 over the model width) within
    2^-6.  Then, findings without a bar: the bf16 layer's call and device
    time (``moe_ragged``'s form by size, phase 37), and the sorted form's
    on the same input."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    t0 = time.perf_counter()
    cfg = get_config(GRANITE)
    gen = torch.Generator(device=dev).manual_seed(29)
    p16 = moe.init_moe(gen, cfg, torch.bfloat16, dev)
    p32 = {n: w.float() for n, w in p16.items()}
    for t in (MAX_BATCH * 256, MAX_BATCH):
        x16 = torch.randn((t, cfg.d_model), generator=gen,
                          device=dev).bfloat16()
        x32 = x16.float()
        _, ids16, _ = moe.route_topk(p16["router"], x16, cfg.moe_top_k)
        _, ids32, _ = moe.route_topk(p32["router"], x32, cfg.moe_top_k)
        y32, _ = moe.moe_ragged(p32, cfg, x32, aux=False)

        def layer():
            return moe.moe_ragged(p16, cfg, x16, aux=False)[0]

        def sorted_form():
            tok, w, _, sizes, _ = moe._dispatch(cfg, p16["router"], x16)
            return moe._experts_sorted(p16, x16, tok, w, sizes)

        def rel(y):
            return float(((y.float() - y32).norm(dim=1)
                          / y32.norm(dim=1)).max())

        err, err_sorted = rel(layer()), rel(sorted_form())
        same = torch.equal(ids16, ids32)
        print(f"{GRANITE} MoE layer, T = {t}, bf16 against f32: largest "
              f"per-token relative error {err:.6f} (bar {2 ** -6:.5f}), "
              f"|y|max {float(y32.abs().max()):.1f}, expert ids equal: "
              f"{same}; bf16 layer {median_ms(layer, reps=10, inner=5):.4f}"
              f" ms a call, device time {device_total_ms(layer)} ms; the "
              f"sorted form {median_ms(sorted_form, reps=5, inner=2):.4f} "
              f"ms a call, device time {device_total_ms(sorted_form)} ms, "
              f"error {err_sorted:.6f}")
        if not same or err > 2 ** -6:
            fail(f"the bf16 MoE layer at T = {t} is not the f32 layer's "
                 f"within 2^-6 (error {err}, same experts: {same})")
    phase("29 granite MoE layer, bf16 against f32", t0)


def moe_forms(dev) -> None:
    """Phase 37: one MoE layer at full width in bf16 on the card,
    deepseek-v2-lite-16b's (64 experts, top-6, d_ff 1408) at phase 38's
    prefill (T = 8 x 1024) and decode (T = 8) and at T = 256 and 512,
    then granite-moe-1b-a400m's at phase 30's 8 x 256 and 8 and at 8192:
    the every-expert form against the sorted
    form (grouped products, group ends on the card), each one's call time
    (CUDA events, in turns: every, sorted, sorted, every) and device time,
    the form ``moe_ragged`` takes, and each form's largest per-token
    relative error (L2 over the model width) against the f32 layer (the
    bf16 weights widened), within phase 29's 2^-6; the two forms' expert
    ids are the same routing."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    t0 = time.perf_counter()
    # phase 38's and 30's prefill and decode, and on both sides of
    # SORTED_MIN_MACS
    for arch, sizes in ((DSV2, (MAX_BATCH * 1024, MAX_BATCH, 256, 512)),
                        (GRANITE, (MAX_BATCH * 256, MAX_BATCH, 8192))):
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(37)
        p16 = moe.init_moe(gen, cfg, torch.bfloat16, dev)
        p16.pop("shared", None)     # apply_moe adds it outside both forms
        p32 = {n: w.float() for n, w in p16.items()}
        for t in sizes:
            x16 = torch.randn((t, cfg.d_model), generator=gen,
                              device=dev).bfloat16()
            w32, ids32, _ = moe.route_topk(p32["router"], x16.float(),
                                           cfg.moe_top_k)
            y32 = moe._experts_all(p32, x16.float(), w32, ids32)

            def every():
                w, ids, _ = moe.route_topk(p16["router"], x16,
                                           cfg.moe_top_k)
                return moe._experts_all(p16, x16, w, ids)

            def sorted_form():
                tok, w, _, sizes_, _ = moe._dispatch(cfg, p16["router"], x16)
                return moe._experts_sorted(p16, x16, tok, w, sizes_)

            def rel(y):
                return float(((y.float() - y32).norm(dim=1)
                              / y32.norm(dim=1)).max())

            errs = {"every": rel(every()), "sorted": rel(sorted_form())}
            ms = {"every": [], "sorted": []}
            for form in ("every", "sorted", "sorted", "every"):
                fn = every if form == "every" else sorted_form
                ms[form].append(median_ms(fn, reps=10, inner=3))
            dev_ms = {"every": device_total_ms(every),
                      "sorted": device_total_ms(sorted_form)}
            macs = t * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
            takes = "sorted" if macs >= moe.SORTED_MIN_MACS else "every"
            print(f"{arch} MoE layer, T = {t}, bf16: every-expert "
                  f"{ms['every']} ms a call (device time "
                  f"{dev_ms['every']} ms), sorted {ms['sorted']} ms a call "
                  f"(device time {dev_ms['sorted']} ms); moe_ragged takes "
                  f"the {takes} form ({macs:.3g} multiply-adds a product "
                  f"every-expert); largest per-token relative error "
                  f"against f32: every {errs['every']:.6f}, sorted "
                  f"{errs['sorted']:.6f} (bar {2 ** -6:.5f})")
            if max(errs.values()) > 2 ** -6:
                fail(f"a {arch} MoE form at T = {t} is not the f32 layer's "
                     f"within 2^-6: {errs}")
            del x16, y32
        del p16, p32
        torch.cuda.empty_cache()
    phase("37 the MoE forms at deepseek-v2-lite's and granite's widths", t0)


def served_phase(archs, delta, routes, name, batches, max_seq=None):
    """Phases 38, 40 and 42: ``archs`` built at full width and full depth
    in one service (phase 30's path), the peak device memory of the phase,
    and the device memory back within 1 GiB of its level before it.
    Returns the launches of the counted run and the backends."""
    import torch
    start = device_memory("cuda")
    torch.cuda.reset_peak_memory_stats()
    launches, backends = llm_service(archs, delta, routes, name,
                                     build_all=True, batches=batches,
                                     max_seq=max_seq)
    weights = sum(tree_bytes(be.params) for be in backends.values())
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  {name}: weights {gib(weights)}, peak device memory "
          f"{gib(peak)} of the card's {gib(total)}")
    if peak > total - 2**30:
        fail(f"{name} peaked at {gib(peak)}, within 1 GiB of the card's "
             f"{gib(total)}")
    return launches, backends, start


def encdec_service():
    """Phase 42: whisper-small at full depth beside llama3-8b in one
    service (phase 38's path), then, outside the counted run,
    whisper-small's batch again with every count at 0 (36 flash launches,
    24 of them without the causal mask, and 360 decode launches), its
    prefill's encoder and decoder apart, and the host syncs of both
    backends' decode steps.  Returns the launches of the counted run."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import modality_inputs
    from repro_torch.models import prefill
    from repro_torch.models.model import encode
    from repro_torch.serving.engine import Request
    name = f"42 {WHISPER} beside llama3-8b"
    launches, backends, start = served_phase(
        ENCDEC_ARCHS, ENCDEC_DELTA, ENCDEC_ROUTES, name, ENCDEC_BATCHES,
        {ENCDEC_ROUTES[n]: tokens + MAX_NEW
         for n, (tokens, _) in ENCDEC_BATCHES.items()})
    be = backends[WHISPER]
    prompt_len = ENCDEC_BATCHES[512][0]
    rng = np.random.default_rng(53)
    reqs = [Request(uid=i, prompt=rng.integers(0, 100_000, prompt_len),
                    max_new_tokens=MAX_NEW) for i in range(MAX_BATCH)]
    kernel_ops = llm_kernel_ops()
    for ops in kernel_ops.values():
        ops.launches = 0
    with NonCausalFlash() as noncausal:
        res = be.serve_batch(reqs)[0]
    ran = {k: ops.launches for k, ops in kernel_ops.items()}
    print(f"  {WHISPER}'s batch of {MAX_BATCH} x {prompt_len} tokens, "
          f"{be.cfg.enc_seq} frames each, alone: launches {ran}, "
          f"{noncausal.count} flash without the causal mask")
    if (ran["flash_attention"], ran["decode_attention"],
            noncausal.count) != (36, 360, 24) or ran != kernel_launches(
                launch_kinds(be.cfg), MAX_NEW - 1):
        fail(f"{WHISPER}'s batch launched {ran} with {noncausal.count} "
             "unmasked flash, not 36 flash (24 unmasked) and 360 decode")
    frames = modality_inputs(be.cfg, MAX_BATCH, rng,
                             device="cuda")["prefix_embeds"]
    tokens = torch.from_numpy(rng.integers(
        0, be.cfg.vocab_size, (MAX_BATCH, prompt_len))).cuda()
    with torch.inference_mode():
        enc = min(synced(lambda: encode(be.params, be.cfg, frames))[1]
                  for _ in range(3))
        pre = min(synced(lambda: prefill(
            be.params, be.cfg, tokens, frames,
            max_seq=be.max_seq))[1] for _ in range(3))
    print(f"  {WHISPER} prefill (best of 3): {pre * 1e3:.2f} ms = encoder "
          f"{enc * 1e3:.2f} ms + decoder {(pre - enc) * 1e3:.2f} ms; the "
          f"served batch: prefill {res.prefill_s * 1e3:.2f} ms, decode "
          f"{res.decode_s / (MAX_NEW - 1) * 1e3:.3f} ms per step")
    decode_syncs(be, prompt_len)
    decode_syncs(backends["llama3-8b"], ENCDEC_BATCHES[1024][0])
    del backends, be
    released("phase 42", start)
    return launches


def released(name, start) -> None:
    """Fails unless device memory came back within 1 GiB of ``start``."""
    after = device_memory("cuda")
    print(f"  {name}: device memory {gib(start)} before, {gib(after)} "
          "after the models were released")
    if after - start > 2**30:
        fail(f"{name} left {gib(after - start)} of device memory behind")


def ring_on_card(dev) -> None:
    """Phase 34: llama3-8b-swa cut to two layers at full width in f32 on
    the card, a 4608-token prompt into rings of 4096 rows (they wrap in
    prefill) and 16 decode steps (they wrap again); the logits of the
    prefill and of every step held to ``forward`` over the whole sequence
    on the card, whose windowed flash reads the same key set: within 1e-3,
    argmax equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params, prefill
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama3-8b-swa"), num_layers=2,
                              activ_dtype="float32")
    params = init_params(cfg, seed=11, device=dev)
    prompt_len, steps = 4608, 16
    toks = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, prompt_len))).to(dev)
    kernel_ops = llm_kernel_ops()
    before = {k: ops.launches for k, ops in kernel_ops.items()}
    logits, cache = prefill(params, cfg, toks, max_seq=4096)
    got = [logits]
    for _ in range(steps):
        toks = torch.cat([toks, logits.argmax(-1)], 1)
        logits, cache = decode_step(params, cfg, toks[:, -1:], cache)
        got.append(logits)
    ran = {k: ops.launches - before[k] for k, ops in kernel_ops.items()}
    rows = [entry.k.shape[2] for entry in cache["blocks"]["s0"]]
    got = torch.cat(got, 1)
    want = forward(params, cfg, toks)[:, prompt_len - 1:]
    err = float((got - want).abs().max())
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    print(f"llama3-8b-swa, 2 layers, f32, a {prompt_len}-token prompt and "
          f"{steps} decode steps on rings of {rows} rows: logits against "
          f"forward over the {toks.shape[1]} tokens max err {err:.3g} "
          f"(tolerance 1e-3), argmax equal: {same}; launches {ran}")
    if rows != [4096, 4096]:
        fail(f"llama3-8b-swa's local caches hold {rows} rows, not 4096")
    if ran != kernel_launches(list(cfg.layer_kinds), steps):
        fail(f"the ring's run launched {ran}")
    if err > 1e-3 or not same:
        fail("llama3-8b-swa's decode on the ring differs from forward")
    phase("34 the sliding-window ring on the card", t0)


def dense_service():
    """Phase 35: deepseek-7b, gemma2-9b and llama3-8b-swa at full width in
    one service (phase 30's path, with each backend's batch and max_seq),
    then llama3-8b-swa's cache after its 12 288-token prompt beside what a
    position-ordered cache of the prompt and 16 new tokens would hold, and
    the phase's peak device memory.  Returns the launches of the counted
    run."""
    import numpy as np
    import torch
    from repro_torch.models import prefill
    torch.cuda.reset_peak_memory_stats()
    launches, backends = llm_service(
        DENSE_ARCHS, DENSE_DELTA, DENSE_ROUTES,
        "35 the rest of the dense family", build_all=True,
        batches=DENSE_BATCHES, max_seq=DENSE_MAX_SEQ)
    be = backends["llama3-8b-swa"]
    prompt_len, _ = DENSE_BATCHES[40_000]
    toks = torch.from_numpy(np.random.default_rng(43).integers(
        0, be.cfg.vocab_size, (1, prompt_len))).cuda()
    with torch.inference_mode():
        _, cache = prefill(be.params, be.cfg, toks, max_seq=be.max_seq)
    ring = tree_bytes(cache["blocks"])
    rows = {e.k.shape[2] for e in cache["blocks"]["s0"]}
    ordered = ring // 4096 * (prompt_len + MAX_NEW)
    print(f"  llama3-8b-swa after a {prompt_len}-token prompt: rings of "
          f"{sorted(rows)} rows, {gib(ring)} of K/V; a position-ordered "
          f"cache of {prompt_len + MAX_NEW} rows would hold {gib(ordered)}; "
          f"the phase's peak device memory "
          f"{gib(torch.cuda.max_memory_allocated())}")
    if rows != {4096}:
        fail(f"llama3-8b-swa's rings hold {rows} rows, not 4096")
    del cache, backends, be
    torch.cuda.empty_cache()
    return launches


def attention_timing(dev):
    """Phase 12: both attention kernels at the main path's shapes, those of
    phases 33-35 and 40 too.  Returns the JSON fields of the llama3-8b
    shapes (the larger backend of phase 10).  ``scaled_dot_product_attention`` has no
    softcap: at gemma2-9b's shapes the library column is empty."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.flash_attention import ref as fl_ref
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    rows = {}

    def bound(flops, nbytes):
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    # recurrentgemma-2b's local layers pass window 2048, wider than the
    # 1024-token prompt: causal attention is the same function there.  A
    # shape of five is (B, H, KV, S, D) over T = S rows, of six (B, H, KV,
    # S, T, D)
    for arch, shape, kw in (("llama3-8b", (8, 32, 8, 1024, 128), {}),
                            ("qwen2.5-3b", (8, 16, 2, 256, 128), {}),
                            ("recurrentgemma-2b", (8, 10, 1, 1024, 256),
                             {"window": 2048}),
                            (GRANITE, (8, 16, 8, 256, 64), {}),
                            ("gemma2-9b", (2, 16, 8, 6144, 256),
                             {"window": 4096, "softcap": 50.0}),
                            ("deepseek-7b", (8, 32, 32, 1024, 128), {}),
                            ("llama3-8b-swa", (1, 32, 8, 12_288, 128),
                             {"window": 4096}),
                            (LLAVA, DENSE_FLASH[-1][0], {}),
                            (f"{WHISPER} encoder", ENCDEC_FLASH[0][0],
                             {"causal": False}),
                            (f"{WHISPER} cross", ENCDEC_FLASH[1][0],
                             {"causal": False}),
                            (f"{WHISPER} decoder", ENCDEC_FLASH[2][0], {})):
        b, h, kv, s, t, d = shape if len(shape) == 6 else shape[:4] + \
            shape[3:]
        causal = kw.get("causal", True)
        q, k, v = randn([(b, h, s, d), (b, kv, t, d), (b, kv, t, d)], bf16,
                        23, dev)
        got = fl_ops.attention(q, k, v, **kw)
        err = attention_close(f"flash at {shape}", got,
                              flash_plain(q, k, v, **kw))
        err32 = attention_close_f32(f"flash at {shape}", got, flash_plain(
            q.float(), k.float(), v.float(), **kw))
        del got
        kern = median_ms(lambda: fl_ops.attention(q, k, v, **kw), reps=10,
                         inner=5)
        dk = device_ms(lambda: fl_ops.attention(q, k, v, **kw),
                       "flash_kernel", reps=5)
        layout = ""
        if arch in ("llama3-8b", "deepseek-7b", LLAVA):
            # the model's prefill passes K/V as views of its [B, S, KV, D]
            # projections, not of a [B, KV, T, D] cache: the same call
            # with that layout
            kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (k, v))
            attention_close(f"flash at {shape}, K/V [B, S, KV, D]",
                            fl_ops.attention(q, kt, vt, **kw),
                            flash_plain(q, k, v, **kw))
            dk_t = device_ms(lambda: fl_ops.attention(q, kt, vt, **kw),
                             "flash_kernel", reps=5)
            layout = f", {dk_t} ms with K/V as [B, S, KV, D] views"
            del kt, vt
        plain = median_ms(lambda: flash_plain(q, k, v, **kw),
                          reps=5, inner=2)
        window = kw.get("window")
        lib = None
        if "softcap" not in kw:
            rows_, cols = (torch.arange(s, device=dev)[:, None],
                           torch.arange(s, device=dev)[None, :])
            mask = (None if window is None or window >= s else
                    (cols <= rows_) & (cols > rows_ - window))
            lib = median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True), reps=10, inner=5)
        # causal, row i sees min(i + 1, window) columns, else all T (these
        # shapes pass no window then); 4 flops per (row, col, d)
        flops = 4 * b * h * d * (causal_keys(s, window) if causal else s * t)
        bnd, by = bound(flops, 2 * (2 * b * h * s * d + 2 * b * kv * t * d))
        rate = flops / (dk or kern) / 1e9
        library = ("none (softcap)" if lib is None else
                   f"{lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s)")
        print(f"time flash {arch} prefill {shape} bf16 {kw}: kernel "
              f"{kern:.4f} ms "
              f"(device time {dk} ms, {rate:.1f} TFLOP/s{layout}), plain "
              f"{plain:.4f} ms, scaled_dot_product_attention {library}, "
              f"bound {bnd:.5f} ms "
              f"({by}: {flops / 1e9:.1f} GFLOP); max err {err:.3g} (bf16 "
              f"plain), {err32:.3g} (f32 plain)")
        rows.setdefault("flash_attention", (kern, plain, bnd, by, lib, err))
        del q, k, v

    rng = np.random.default_rng(29)
    # recurrentgemma-2b's ring: 1281 rows at MAX_SEQ 1280 (< its window),
    # of which a 1024-token prompt fills the first lengths; the rings of
    # gemma2-9b and llama3-8b-swa are full (lo None: every length the
    # ring's 4096 rows), and read with no window; whisper-small's
    # cross-attention reads all 1500 frames (lo None too)
    for arch, shape, lo, kw in (
            ("llama3-8b", (8, 32, 8, MAX_SEQ, 128), 1024, {}),
            ("qwen2.5-3b", (8, 16, 2, MAX_SEQ, 128), 256, {}),
            ("recurrentgemma-2b", (8, 10, 1, MAX_SEQ + 1, 256), 1024, {}),
            (GRANITE, (8, 16, 8, MAX_SEQ, 64), 256, {}),
            ("gemma2-9b", (2, 16, 8, 4096, 256), None, {"softcap": 50.0}),
            ("gemma2-9b", (2, 16, 8, 6160, 256), 6144, {"softcap": 50.0}),
            ("deepseek-7b", (8, 32, 32, 1040, 128), 1024, {}),
            ("llama3-8b-swa", (1, 32, 8, 4096, 128), None, {}),
            (LLAVA, DENSE_DECODE[-1][0], VLM_MAX_SEQ - MAX_NEW, {}),
            (WHISPER, (MAX_BATCH, 12, 12, 1500, 64), None, {})):
        b, h, kv, t_max, d = shape
        q, ck, cv = randn([(b, h, d), (b, kv, t_max, d), (b, kv, t_max, d)],
                          bf16, 31, dev)
        # the main path's decode lengths (pos + 1 after a lo-token prompt,
        # or a full ring's rows), and its view of the cache: the first
        # max(lengths) rows
        lens = torch.tensor(rng.integers(lo + 1, lo + MAX_NEW, b)
                            if lo else np.full(b, t_max),
                            dtype=torch.int32, device=dev)
        t = int(lens.max())
        k, v = ck[:, :, :t], cv[:, :, :t]
        got = dec_ops.decode(q, k, v, lens, **kw)
        err = attention_close(f"decode at {shape}", got,
                              dec_ref.decode_reference(q, k, v, lens, **kw))
        want32 = dec_ref.decode_reference(q.float(), k.float(), v.float(),
                                          lens, **kw)
        err32 = attention_close_f32(f"decode at {shape}", got, want32)
        kern = median_ms(lambda: dec_ops.decode(q, k, v, lens, **kw),
                         reps=10, inner=5)
        dk = device_ms(lambda: dec_ops.decode(q, k, v, lens, **kw),
                       "decode_kernel", reps=5)
        # the same work against every attention layer's cache in turn, as
        # the service reads it (this layer's K/V not left in L2 by the last
        # call)
        n_layers = sum(kind in ("attn", "local")
                       for kind in launch_kinds(get_config(arch)))
        caches = torch.empty((n_layers, 2) + ck.shape, dtype=bf16, device=dev)
        caches[:] = torch.stack([ck, cv])
        layer = iter(range(10 ** 6))

        def cold(rows):
            def run():
                kc, vc = caches[next(layer) % n_layers, :, :, :, :rows]
                return dec_ops.decode(q, kc, vc, lens, **kw)
            return run

        dk_cold = device_ms(cold(t), "decode_kernel", reps=n_layers)
        # the splits sized from the lengths, against one piece per (batch,
        # KV head) and against splits sized from the whole cache
        per_sm = dec_ops.blocks_per_sm(torch.cuda.current_device(), d,
                                       h // kv, True)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit = dec_ops.splits(b, kv, t, n_sm, per_sm,
                                dec_ops.BLOCK_K_BF16[d])
        host = host_us(lambda: dec_ops.decode(q, k, v, lens, **kw))
        default = dec_ops.BLOCKS_PER_SM
        try:
            dec_ops.BLOCKS_PER_SM = 0
            attention_close_f32(f"decode at {shape} in one piece",
                                dec_ops.decode(q, k, v, lens, **kw), want32)
            dk_one = device_ms(cold(t), "decode_kernel", reps=n_layers)
        finally:
            dec_ops.BLOCKS_PER_SM = default
        dk_full = device_ms(cold(t_max), "decode_kernel", reps=n_layers)
        del caches
        plain = median_ms(lambda: dec_ref.decode_reference(q, k, v, lens,
                                                           **kw),
                          reps=5, inner=2)
        cols = torch.arange(t, device=dev)[None, :]
        mask = (cols < lens[:, None]) & (
            cols >= lens[:, None] - kw.get("window", t))
        mask = mask[:, None, None, :]
        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)

        lib = lib_dev = lib_host = None
        library = "none (softcap)"
        if "softcap" not in kw:
            lib = median_ms(sdpa, reps=10, inner=5)
            lib_dev = device_total_ms(sdpa)
            lib_host = host_us(sdpa)
            library = (f"{lib:.4f} ms a call (device time {lib_dev} ms, "
                       f"host {lib_host:.1f} us a call)")
        n_keys = int(torch.minimum(lens, torch.tensor(
            kw.get("window", t), device=dev)).sum())
        flops = 4 * h * d * n_keys
        bnd, by = bound(flops, 2 * (2 * kv * d * n_keys + 2 * b * h * d)
                        + 4 * b)
        print(f"time decode {arch} {shape[:3]} bf16 {kw}, the cache's first "
              f"{t} of {t_max} rows, lengths {lens.tolist()}: kernel "
              f"{kern:.4f} ms a call, host {host:.1f} us a call (device "
              f"time {dk} ms; over {n_layers} "
              f"layers' caches, {per_sm} blocks per SM: {dk_cold} ms in "
              f"{nsplit[0]} splits of "
              f"{nsplit[1]} rows = {b * kv * nsplit[0]} blocks for {n_sm} "
              f"SMs, {dk_one} ms in one piece, {dk_full} ms "
              f"split from all {t_max} rows), plain {plain:.4f} ms, "
              f"scaled_dot_product_attention {library}, bound "
              f"{bnd:.5f} ms ({by}: {(2 * kv * d * n_keys * 2) / 1e6:.1f} MB "
              f"of K/V); max err {err:.3g} (bf16 plain), {err32:.3g} (f32 "
              f"plain)")
        rows.setdefault("decode_attention", (kern, plain, bnd, by, lib, err))
    phase("12 attention timing", t0)
    return rows


def ssd_inputs(shape, seed, dev, dtype, mamba_decays=True, offset=0):
    """x, dt, A, B, C, D of the SSD scan at ``shape`` (b, s, h, p, n).  x,
    B and C are column views of one [b, s, offset + h*p + 2n] tensor in
    ``dtype`` from column ``offset``, as the Mamba-2 block passes its conv
    output; dt = softplus(normal) in f32; A = -linspace(1, 16, h),
    mamba2-370m's A_log init (a_cum then reaches thousands within a
    256-row chunk), or -exp(normal) as in the JAX tests; D normal."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)

    def normal(*size):
        return torch.from_numpy(rng.standard_normal(size, np.float32)).to(dev)

    xbc = normal(b, s, offset + h * p + 2 * n).to(dtype)[..., offset:]
    dt = F.softplus(normal(b, s, h))
    A = (-torch.linspace(1.0, 16.0, h, device=dev) if mamba_decays
         else -torch.exp(normal(h)))
    return (xbc[..., :h * p].reshape(b, s, h, p), dt, A,
            xbc[..., h * p:h * p + n], xbc[..., h * p + n:], normal(h))


def ssd_check(dev):
    """Phase 13: the SSD kernel against its plain version.  Returns the
    bf16 kernel's max error at mamba2-370m's shape against the f32 plain
    version rounded to bf16."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    t0 = time.perf_counter()
    worst = 0.0
    cases = [((1, 32, 2, 8, 4), 8), ((1, 32, 2, 8, 4), 16),
             ((2, 64, 4, 16, 8), 8), ((2, 64, 4, 16, 8), 16),
             ((2, 37, 3, 8, 4), 16), ((2, 37, 3, 8, 4), 256),
             ((2, 250, 3, 16, 16), 100)]
    for i, (shape, chunk) in enumerate(cases):
        args = ssd_inputs(shape, 50 + i, dev, torch.float32,
                          mamba_decays=False)
        got = ssd_ops.ssd(*args, chunk=chunk, return_final_state=True)
        want = ssd_ref.ssd_chunked(*args, chunk=chunk,
                                   return_final_state=True)
        for what, g, w in zip(("y", "final state"), got, want):
            err = (g - w).abs()
            if not bool((err <= 2e-4 + 1e-3 * w.abs()).all()):
                fail(f"ssd {shape} chunk {chunk}: the kernel's {what} "
                     f"differs from the plain version's by up to "
                     f"{float(err.max())} (atol 2e-4, rtol 1e-3)")
            worst = max(worst, float(err.max()))
    print(f"ssd scan: kernel == plain version on {len(cases)} f32 cases "
          f"(the JAX tests' shapes and chunks, a ragged S, a chunk of "
          f"100 rows; y and final "
          f"state within atol 2e-4, rtol 1e-3): max err {worst:.3g}")

    def max_err(a, b):
        return float((a.double() - b.double()).abs().max())

    def bf16_bar(args, chunk):
        """(the bf16 kernel's y, its max error against the f32 plain
        version rounded to bf16, the largest share of its bar an element
        takes, the f32 bar); fails unless every element is within one
        bf16 ulp of |want| plus twice the f32 plain version's own error
        against f64."""
        y16 = ssd_ops.ssd(*args, chunk=chunk)
        f32 = [a.float() for a in args]
        want = ssd_ref.ssd_chunked(*f32, chunk=chunk)
        bar32 = 2 * max_err(want, ssd_ref.ssd_chunked(
            *(a.double() for a in f32), chunk=chunk))
        _, e = torch.frexp(want.abs())
        ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want),
                                                      e - 8))
        err = (y16.float() - want.bfloat16().float()).abs()
        if not bool((err <= ulp + bar32).all()):
            fail(f"ssd at {tuple(args[0].shape)} chunk {chunk}: the bf16 "
                 f"kernel misses its bar")
        return y16, float(err.max()), float((err / (ulp + bar32)).max()), \
            bar32

    used = 0.0
    for i, (shape, chunk) in enumerate(cases):
        args = ssd_inputs(shape, 50 + i, dev, torch.bfloat16,
                          mamba_decays=False)
        used = max(used, bf16_bar(args, chunk)[2])
    print(f"ssd scan: bf16 kernel on the same {len(cases)} cases within one "
          f"bf16 ulp plus twice the f32 plain version's error against f64: "
          f"the largest share of its bar an element takes {used:.3g}")

    args = ssd_inputs(SSD_SHAPE, 41, dev, torch.float32)
    y, st = ssd_ops.ssd(*args, chunk=SSD_CHUNK, return_final_state=True)
    y32, st32 = ssd_ref.ssd_chunked(*args, chunk=SSD_CHUNK,
                                    return_final_state=True)
    y64, st64 = ssd_ref.ssd_chunked(*(a.double() for a in args),
                                    chunk=SSD_CHUNK, return_final_state=True)
    for what, got, plain, ref in (("y", y, y32, y64),
                                  ("final state", st, st32, st64)):
        own, err = max_err(plain, ref), max_err(got, ref)
        print(f"ssd {SSD_SHAPE} chunk {SSD_CHUNK} f32 {what}, against the "
              f"plain version in f64: kernel max err {err:.4g}, bar 2 x "
              f"the f32 plain version's {own:.4g} (max |{what}| "
              f"{float(ref.abs().max()):.4g})")
        if err > 2 * own:
            fail(f"ssd at {SSD_SHAPE}: the f32 kernel's {what} misses its "
                 f"bar")
    del y, st, y32, st32, y64, st64

    args = ssd_inputs(SSD_SHAPE, 41, dev, torch.bfloat16)
    y16, err, used, bar32 = bf16_bar(args, SSD_CHUNK)
    plain16 = max_err(y16, ssd_ref.ssd_chunked(*args, chunk=SSD_CHUNK))
    print(f"ssd {SSD_SHAPE} chunk {SSD_CHUNK} bf16 y, against the f32 "
          f"plain version rounded to bf16: max err {err:.4g}, bar one bf16 "
          f"ulp of |want| + {bar32:.4g} (the largest share of its bar an "
          f"element takes: {used:.3g}); against the bf16 plain version: "
          f"{plain16:.4g}")
    phase("13 SSD kernel", t0)
    return err


def ssd_timing(dev):
    """Phase 16: the SSD kernel at mamba2-370m's prefill shape, bf16, on
    column views of one conv output, with the final state.  Returns its
    JSON fields (without the launches and the error)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    t0 = time.perf_counter()
    b, s, h, p, n = SSD_SHAPE
    args = ssd_inputs(SSD_SHAPE, 43, dev, torch.bfloat16)

    def kernel():
        return ssd_ops.ssd(*args, chunk=SSD_CHUNK, return_final_state=True)

    kern = median_ms(kernel, reps=10, inner=5)
    passes = {}
    dk = device_ms(kernel, "ssd_kernel", reps=5, per_call=3, parts=passes)
    plain = median_ms(lambda: ssd_ref.ssd_chunked(
        *args, chunk=SSD_CHUNK, return_final_state=True), reps=5, inner=2)
    # bytes: x, B, C read and y written in bf16, dt read and the final
    # state written in f32, A and D read in f32
    nbytes = 2 * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h \
        + 4 * b * h * p * n + 8 * h
    # operations this input needs: per (batch, chunk) the C B^T scores on
    # and below the diagonal; per head the decayed scores times x dt, the
    # carried state's term for chunks after the first, and the state
    # update over every row
    q = min(SSD_CHUNK, s)
    rows = [min(q, s - c0) for c0 in range(0, s, q)]
    tri = sum(r * (r + 1) // 2 for r in rows)
    flops = 2 * b * (tri * n + h * tri * p + h * (s - rows[0]) * p * n
                     + h * s * p * n)
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    print(f"time ssd {SSD_SHAPE} chunk {SSD_CHUNK} bf16 on the conv "
          f"output's column views, with the final state: kernel {kern:.4f} "
          f"ms (device time {dk} ms: {passes}), plain {plain:.4f} ms, "
          f"bound "
          f"{bnd:.5f} ms ({by}: {nbytes / 1e6:.1f} MB, {t_bytes:.5f} ms; "
          f"{flops / 1e9:.2f} GFLOP at the bf16 tensor-core peak, "
          f"{t_ops:.5f} ms); library: none (no PyTorch call computes the "
          f"SSD scan)")
    phase("16 SSD timing", t0)
    return kern, plain, bnd, by


def lru_gate_inputs(shape, seed, dev):
    """a, b of the RG-LRU scan at ``shape`` (b, s, w) in f32, drawn as the
    recurrent block's gates draw them: x normal, W_a and W_x at the fan-in
    scale, zero biases, Lambda from lam uniform in [0.9, 0.999]."""
    import numpy as np
    import torch
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    b, s, w = shape
    rng = np.random.default_rng(seed)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    lam = rng.uniform(0.9, 0.999, w)
    x = tensor(rng.standard_normal((b, s, w), np.float32))
    w_a, w_x = (tensor(rng.standard_normal((w, w), np.float32) / np.sqrt(w))
                for _ in range(2))
    zero = torch.zeros(w, device=dev)
    log_lambda = tensor(np.log(np.expm1(-np.log(lam) / lru_ref.RGLRU_C)))
    return lru_ref.rglru_gates(x, w_a, zero, w_x, zero, log_lambda)


def lru_check(dev):
    """Phase 17: the RG-LRU kernel against its plain version.  Returns its
    max error at recurrentgemma-2b's shape against the f32 plain
    version."""
    import numpy as np
    import torch
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    t0 = time.perf_counter()
    worst, exact, n = 0.0, True, 0
    for shape in [(1, 16, 128), (2, 33, 256), (2, 33, 200), (3, 70, 1000)]:
        rng = np.random.default_rng(sum(shape))
        a = torch.from_numpy(rng.uniform(0.3, 0.999, shape).astype(
            np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
        h0 = torch.from_numpy(rng.standard_normal(
            (shape[0], shape[2]), np.float32)).to(dev)
        for init in (h0, None):
            got = lru_ops.linear_scan(a, b, init)
            want = lru_ref.linear_scan(a, b, init)
            err = float((got - want).abs().max())
            if err > 1e-5:
                fail(f"rglru {shape} h0={init is not None}: kernel and "
                     f"plain version differ by up to {err} (atol 1e-5)")
            worst, exact, n = max(worst, err), exact and torch.equal(
                got, want), n + 1
    print(f"rglru scan: kernel == plain version on {n} f32 cases (the JAX "
          f"tests' shapes, W = 200 and 1000, with and without h0; atol "
          f"1e-5): max err {worst:.3g}, bit-identical: {exact}")
    a, b = lru_gate_inputs(LRU_SHAPE, 47, dev)
    got = lru_ops.linear_scan(a, b)
    plain = lru_ref.linear_scan(a, b)
    ref = lru_ref.linear_scan(a.double(), b.double())
    own = float((plain.double() - ref).abs().max())
    err = float((got.double() - ref).abs().max())
    main_err = float((got - plain).abs().max())
    print(f"rglru {LRU_SHAPE} f32, a and b from the gates (a in "
          f"[{float(a.min()):.4g}, {float(a.max()):.4g}]), against the plain "
          f"version in f64: kernel max err {err:.4g}, bar 2 x the f32 plain "
          f"version's {own:.4g} (max |h| {float(ref.abs().max()):.4g}); "
          f"against the f32 plain version: {main_err:.4g}")
    if err > 2 * own:
        fail(f"rglru at {LRU_SHAPE}: the kernel misses its bar")
    phase("17 RG-LRU kernel", t0)
    return main_err


def lru_timing(dev):
    """Phase 20: the RG-LRU kernel at recurrentgemma-2b's prefill shape.
    Returns its JSON fields (without the launches and the error)."""
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    t0 = time.perf_counter()
    a, b = lru_gate_inputs(LRU_SHAPE, 53, dev)
    kern = median_ms(lambda: lru_ops.linear_scan(a, b), reps=10, inner=5)
    dk = device_ms(lambda: lru_ops.linear_scan(a, b), "rglru_kernel", reps=5)
    plain = median_ms(lambda: lru_ref.linear_scan(a, b), reps=3, inner=1)
    # a and b read and h written in f32; one multiply and one add per
    # element on the CUDA cores
    nbytes = 12 * a.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * a.numel() / F32_FLOP_PER_S * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    print(f"time rglru {LRU_SHAPE} f32: kernel {kern:.4f} ms (device time "
          f"{dk} ms), plain {plain:.4f} ms, bound {bnd:.5f} ms ({by}: "
          f"{nbytes / 1e6:.1f} MB, {t_bytes:.5f} ms; {t_ops:.5f} ms at the "
          f"f32 peak); library: none (no PyTorch call computes the "
          f"recurrence)")
    phase("20 RG-LRU timing", t0)
    return kern, plain, bnd, by


#: phase 21's rows: (estimator, router); None = no estimator
ROUTING_ROWS = ([(e, r) for e in ("ED", "SF", "OB", "GT")
                 for r in ("greedy", "Wgt", "Par")]
                + [(None, r) for r in ("RR", "Rnd", "LE", "LI", "HM", "HMG")]
                + [("GT", "Orc")])
#: a raw objectness score this close to the 0.5 threshold may land on
#: either side on the card and on the CPU
SCORE_EDGE = 1e-5
#: every wait on a future in phases 22 and 23, seconds
WAIT_S = 10.0


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


class CannyLaunches:
    """The Canny kernel's launches while the recorder is entered, by
    (shape, ragged or not, thresholds), each key's first launch kept with
    its input and edge map: ``check`` holds the kernel to its plain
    version at every shape the main path gave it, on the very input it
    was given."""

    def __init__(self, ops):
        self.ops, self.first = ops, {}
        self._launch = ops._launch

    def __enter__(self):
        def launch(img, dims, lo, hi):
            out = self._launch(img, dims, lo, hi)
            key = (tuple(img.shape), dims is not None, lo, hi)
            if key not in self.first:
                self.first[key] = (img.clone(), None if dims is None
                                   else dims.clone(), out.clone())
            return out
        self.ops._launch = launch
        return self

    def __exit__(self, *exc):
        self.ops._launch = self._launch

    def check(self, ref) -> None:
        import torch
        for key, (img, dims, out) in self.first.items():
            if dims is None:
                bad = int((out != ref.canny_edge(img, key[2], key[3])).sum())
            else:
                bad = 0
                for j, (h, w) in enumerate(dims.tolist()):
                    want = torch.zeros_like(out[j])
                    want[:h, :w] = ref.canny_edge(
                        img[j:j + 1, :h, :w].contiguous(), key[2], key[3])[0]
                    bad += int((out[j] != want).sum())
            if bad:
                fail(f"canny kernel differs from its plain version at the "
                     f"main path's launch {key}: {bad} pixels")
        print(f"canny: kernel == plain version at every one of the main "
              f"path's {len(self.first)} launch shapes (shape, ragged, "
              f"thresholds), on the input each was given (tolerance: exact "
              f"equality): {sorted(self.first)}")


def log_decisions(gw, log) -> None:
    """Every decision of ``gw``'s policy lands in ``log`` by uid as
    (pair, estimated complexity)."""
    decide, decide_batch = gw.policy.decide, gw.policy.decide_batch

    def keep(d):
        log[d.uid] = (d.pair, d.est_complexity)
        return d

    gw.policy.decide = lambda req: keep(decide(req))
    gw.policy.decide_batch = lambda reqs: [keep(d) for d in
                                           decide_batch(reqs)]


def routing_episode(est_name, router_name, stream, params, dev, log,
                    sf_calls=None):
    """One ``Gateway.process_stream`` of the paper's comparison on ``dev``
    (open loop, the thermal drift on the fleet, δ = 5, batches of 32);
    every decision lands in ``log`` by uid, and every SF detector launch
    adds one to ``sf_calls[0]``."""
    from repro_torch.core import estimators as est_mod
    from repro_torch.core import router as rt
    from repro_torch.core.gateway import Gateway
    from repro_torch.detection.devices import (drift_scenario,
                                               nominal_profile_table)
    table = nominal_profile_table(device=dev)
    est = {"ED": lambda: est_mod.EdgeDetectionEstimator(device=dev),
           "SF": lambda: est_mod.SSDFrontEndEstimator(
               params["ssd_v1"], "ssd_v1", device=dev),
           "OB": est_mod.OutputBasedEstimator,
           "GT": est_mod.OracleEstimator, None: lambda: None}[est_name]()
    cls = {"greedy": rt.GreedyEstimateRouter, "Wgt": rt.WeightedRouter,
           "Par": rt.ParetoRouter, "RR": rt.RoundRobinRouter,
           "Rnd": rt.RandomRouter, "LE": rt.LowestEnergyRouter,
           "LI": rt.LowestInferenceRouter, "HM": rt.HighestMAPRouter,
           "HMG": rt.HighestMAPPerGroupRouter,
           "Orc": rt.OracleRouter}[router_name]
    gw = Gateway(cls(table, 5.0), table, params, est,
                 fleet=drift_scenario("thermal"), max_batch=32, device=dev)
    log_decisions(gw, log)
    if est_name == "SF" and sf_calls is not None:
        for name in ("estimate", "estimate_batch"):
            def counted(*a, _f=getattr(est, name)):
                sf_calls[0] += 1
                return _f(*a)
            setattr(est, name, counted)
    return gw, est, gw.process_stream(stream)


def objectness(model, images, dev):
    """The detector's raw objectness scores [B, 8, 8] on ``dev``, the
    sigmoid taken on the host as ``decode_detections`` takes it."""
    import numpy as np
    import torch
    x = torch.as_tensor(images, device=dev)[..., None]
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        raw = model.to(dev)(x)[..., 0].cpu().numpy()
    return 1 / (1 + np.exp(-raw))


def score_edges(params, cpu_params, images, dev, edge=SCORE_EDGE):
    """Each detector's objectness on ``images`` on ``dev`` and on the CPU,
    held within atol 1e-6 + rtol 1e-5 of each other.  Returns, by model,
    the frames with a score within ``edge`` of 0.5 in either run and the
    frames where a score lands on the other side of 0.5 (within the bar,
    so within ``edge`` of it), and the worst ratio to the bar."""
    import numpy as np
    import torch
    near, flips, worst = {}, {}, 0.0
    for m in params:
        a = objectness(params[m], images, dev)
        b = objectness(cpu_params[m], images, torch.device("cpu"))
        ratio = float((np.abs(a - b) / (1e-6 + 1e-5 * np.abs(b))).max())
        worst = max(worst, ratio)
        if ratio > 1:
            fail(f"{m}'s objectness differs between {dev} and cpu beyond "
                 f"atol 1e-6 + rtol 1e-5: {ratio:.3g} x the bar")
        close = (np.abs(a - 0.5) <= edge) | (np.abs(b - 0.5) <= edge)
        near[m] = set(np.nonzero(close.any(axis=(1, 2)))[0].tolist())
        flips[m] = set(np.nonzero(((a >= 0.5) != (b >= 0.5))
                                  .any(axis=(1, 2)))[0].tolist())
    return near, flips, worst


def allowed_diffs(flips):
    """Phase 21's rule: SF's count can move only where its detector's
    score crossed 0.5 between the card and the CPU; OB's estimate only on
    the frame after one where a backend's score did."""
    return {"SF": flips["ssd_v1"],
            "OB": {u + 1 for f in flips.values() for u in f}}


def routing_comparison(params, scenes, dev, canny_ops):
    """Phase 21: every row of the paper's routing comparison on ``dev``,
    its first 64 scenes again on the CPU.  Returns the Canny launches of
    the ED rows."""
    import copy
    import numpy as np
    import torch
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_params = {m: copy.deepcopy(p).to(cpu) for m, p in params.items()}
    n_cpu = 64
    images = np.stack([s.image for s in scenes[:n_cpu]])
    near, flips, worst = score_edges(params, cpu_params, images, dev)
    print(f"routing: objectness {dev} vs cpu over {n_cpu} scenes x "
          f"{len(params)} detectors within {worst:.3f} of the bar (atol "
          f"1e-6 + rtol 1e-5); frames with a score within {SCORE_EDGE} of "
          f"0.5: {len(set().union(*near.values()))}; frames where a score "
          f"crosses 0.5: { {m: sorted(f) for m, f in flips.items()} }")
    allowed = allowed_diffs(flips)
    canny_launches = 0
    for est_name, rname in ROUTING_ROWS:
        log, cpu_log, sf_calls = {}, {}, [0]
        canny_ops.launches = 0
        sync(dev)
        t1 = time.perf_counter()
        gw, est, st = routing_episode(est_name, rname, scenes, params, dev,
                                      log, sf_calls)
        sync(dev)
        wall = time.perf_counter() - t1
        n_canny = canny_ops.launches
        canny_launches += n_canny
        row = f"{est_name or '-'}/{rname}"
        if sum(st.pair_histogram.values()) != len(scenes):
            fail(f"routing row {row} served {st.pair_histogram}")
        if est_name == "ED" and dev.type == "cuda" and n_canny < 1:
            fail(f"routing row {row} never launched the canny kernel")
        state_dev = gw.table.as_state().map_pct.device
        if state_dev.type != dev.type:
            fail(f"routing row {row}'s profile state is on {state_dev}")
        extra = ""
        if est_name == "SF":
            where = next(est.detector.parameters()).device
            if where.type != dev.type:
                fail(f"SF's detector is on {where}")
            extra = f", SF detector launches {sf_calls[0]} (on {where})"
        routing_episode(est_name, rname, scenes[:n_cpu], cpu_params, cpu,
                        cpu_log)
        diff = {u for u in range(n_cpu) if log[u] != cpu_log[u]}
        if diff - allowed.get(est_name, set()):
            fail(f"routing row {row}: {dev} and cpu decide differently on "
                 f"scenes {sorted(diff)}")
        print(f"routing {row}: {wall:.3f} s wall, backend "
              f"{st.backend_energy_mwh:.4f} mWh / {st.backend_time_ms:.1f} "
              f"ms, mAP {st.map_pct:.2f}, gateway "
              f"{st.gateway_energy_mwh:.6f} mWh, canny launches {n_canny}"
              f"{extra}; {dev} == cpu on {n_cpu - len(diff)}/{n_cpu} "
              f"decisions; pairs {st.pair_histogram}")
    # SF's gateway cost: one detector launch per batch of 32 frames
    from repro_torch.core.estimators import SSDFrontEndEstimator
    sf = SSDFrontEndEstimator(params["ssd_v1"], "ssd_v1", device=dev)
    batch = np.stack([s.image for s in scenes[:32]])
    if dev.type == "cuda":
        call = median_ms(lambda: sf.estimate_batch(batch), reps=10, inner=3)
        busy = device_total_ms(lambda: sf.estimate_batch(batch))
        print(f"SF at the gateway, 32 frames: {call:.4f} ms a call, device "
              f"time {busy} ms")
    phase("21 routing comparison", t0)
    return canny_launches


def served_equal(name, got, want) -> None:
    """Same pair and the detections within the detector tests' bar
    (boxes atol 1e-4, scores atol 1e-6, rtol 1e-5; classes equal)."""
    import numpy as np
    for uid, w in want.items():
        g = got.get(uid)
        if g is None or g.decision.pair != w.decision.pair:
            fail(f"{name}: uid {uid} served {g and g.decision.pair}, "
                 f"{w.decision.pair} in full batches")
        (b1, s1, c1), (b2, s2, c2) = g.result.detections, w.result.detections
        if not (b1.shape == b2.shape and np.allclose(b1, b2, 1e-5, 1e-4)
                and np.allclose(s1, s2, 1e-5, 1e-6)
                and np.array_equal(c1, c2)):
            fail(f"{name}: uid {uid}'s detections differ from full batches")


def deadline_flushing(params, scenes, dev):
    """Phase 22: ``EcoreService`` with ``max_wait_ms=5`` and its flusher
    thread on the real clock, then ``AsyncEcoreService``: 24 requests in
    groups of 3 (max_batch 8) against the same 24 served at once."""
    import asyncio
    import concurrent.futures
    import numpy as np
    from repro_torch.core.policy import RouteRequest
    from repro_torch.serving.aio import AsyncEcoreService
    from repro_torch.serving.service import EcoreService
    t0 = time.perf_counter()
    reqs = [RouteRequest(uid=i, payload=s.image, true_complexity=s.count)
            for i, s in enumerate(scenes[:24])]
    factory = detector_factory(params, dev, 8)

    def policy():
        return ed_policy(dev)

    def result(fut):
        try:
            return fut.result(timeout=WAIT_S)
        except concurrent.futures.TimeoutError:
            fail(f"phase 22: a request waited past {WAIT_S} s")

    ref = EcoreService(policy(), factory)
    futs = ref.submit_batch(reqs)
    ref.drain()
    want = {s.request.uid: s for s in map(result, futs)}
    ref.close()

    def report(name, got, flushes, stats, wall):
        waits = np.asarray(stats["queue_wait_ms"])
        if len(got) != len(reqs) or flushes < 1:
            fail(f"{name}: {len(got)} served, {flushes} deadline flushes")
        served_equal(name, got, want)
        print(f"{name}: 24 requests in groups of 3 in {wall:.3f} s, "
              f"{stats['serve_calls']} serve_batch calls, {flushes} "
              f"deadline flushes; queue wait p50 "
              f"{np.percentile(waits, 50):.3f} ms, p99 "
              f"{np.percentile(waits, 99):.3f} ms; pairs and detections "
              f"== the same 24 served at once")

    svc = EcoreService(policy(), factory, max_wait_ms=5.0)
    got = {}
    t1 = time.perf_counter()
    for g in range(0, len(reqs), 3):
        for s in map(result, [svc.submit(r) for r in reqs[g:g + 3]]):
            got[s.request.uid] = s
    wall = time.perf_counter() - t1
    report("deadline flusher", got, svc.deadline_flushes, svc.stats(), wall)
    svc.close()

    async def drive():
        asvc = AsyncEcoreService(policy(), factory, max_wait_ms=5.0)
        out = {}
        try:
            for g in range(0, len(reqs), 3):
                futs = [asvc.submit_nowait(r) for r in reqs[g:g + 3]]
                for s in await asyncio.wait_for(asyncio.gather(*futs),
                                                WAIT_S):
                    out[s.request.uid] = s
            return out, asvc.deadline_flushes, asvc.stats()
        finally:
            await asyncio.wait_for(asvc.close(), WAIT_S)

    t1 = time.perf_counter()
    try:
        got, flushes, stats = asyncio.run(drive())
    except asyncio.TimeoutError:
        fail(f"phase 22: an awaited request waited past {WAIT_S} s")
    report("async facade", got, flushes, stats, time.perf_counter() - t1)
    phase("22 deadline flushing and the async facade", t0)


class SeenBackend:
    """Counts each uid's appearances in ``serve_batch`` calls (its
    attempts) in front of a backend."""

    def __init__(self, inner, seen):
        self.inner, self.seen = inner, seen
        self.name, self.max_batch = inner.name, inner.max_batch

    def serve_batch(self, requests):
        for r in requests:
            self.seen[r.uid] = self.seen.get(r.uid, 0) + 1
        return self.inner.serve_batch(requests)

    def profile_row(self):
        return self.inner.profile_row()


def storm_run(params, stream, dev, resilient):
    """The fault storm of ``tests/test_faults.py`` on orin_nano over
    ``stream``: per uid (served pair, attempts, exception type, served
    within the 500 ms deadline), and the service's counters."""
    import numpy as np
    from repro_torch.core.policy import DetectionPolicy, RouteRequest
    from repro_torch.core.router import OracleRouter
    from repro_torch.detection.devices import nominal_profile_table
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.faults import FaultSpec, InjectedFault
    from repro_torch.serving.resilience import ResilientService, RetryPolicy
    from repro_torch.serving.service import EcoreService
    n, deadline = len(stream), 500.0
    storm = {"orin_nano": [
        FaultSpec("error", rate=0.4, seed=3),
        FaultSpec("stall", rate=0.3, seed=5, stall_ms=10_000.0),
        FaultSpec("crash_window", start=n // 2, end=n // 2 + n // 5)]}
    seen = {}
    table = nominal_profile_table(device=dev)
    pol = DetectionPolicy(OracleRouter(table, 2.0), table)

    def factory(d):
        model, edge = d.pair
        return SeenBackend(make_backend(
            "faulty:detector", model, edge, params[model], max_batch=4,
            faults=storm.get(edge, []), device=dev), seen)

    reqs = [RouteRequest(uid=u, payload=s.image, true_complexity=s.count)
            for u, s in enumerate(stream)]
    clock = lambda: 0.0   # noqa: E731  (the injectable fake clock)
    futs = []
    if resilient:
        svc = ResilientService(pol, factory, clock=clock,
                               retry=RetryPolicy(deadline_ms=deadline,
                                                 max_retries=3))
        futs = [svc.submit(r) for r in reqs]
        svc.drain()
    else:
        svc = EcoreService(pol, factory, clock=clock, retain_results=False,
                           buffer_errors=False)
        for r in reqs:
            try:
                futs.append(svc.submit(r))
            except InjectedFault:   # an inline flush's error
                pass
        try:
            svc.drain()
        except InjectedFault:       # a partial batch's error, re-raised
            pass
    stats = svc.stats()
    svc.close()
    out = []
    for f in futs:
        exc = f.exception(timeout=WAIT_S)
        res = None if exc is not None else f.result().result
        uid = getattr(exc, "uid", None) if exc is not None else res.uid
        ok = (res is not None and np.isfinite(res.time_ms)
              and res.time_ms <= deadline)
        out.append((uid, None if exc is not None else
                    f.result().decision.pair, seen.get(uid, 0),
                    None if exc is None else type(exc).__name__, ok))
    return out, stats


def fault_storm(params, dev):
    """Phase 23: ``ResilientService`` over faulty detector backends on
    ``dev`` (real detectors, 64x64 scenes) under the storm; the bare
    service under the same storm; each uid's outcome against the CPU's."""
    import copy
    import torch
    from repro_torch.detection import scenes as sc
    t0 = time.perf_counter()
    stream = sc.drifting_dataset(400, seed=6)
    sync(dev)
    t1 = time.perf_counter()
    got, stats = storm_run(params, stream, dev, resilient=True)
    sync(dev)
    wall = time.perf_counter() - t1
    good = sum(o[-1] for o in got) / len(got)
    bare, _ = storm_run(params, stream, dev, resilient=False)
    bare_good = sum(o[-1] for o in bare) / len(stream)
    cpu = torch.device("cpu")
    cpu_params = {m: copy.deepcopy(p).to(cpu) for m, p in params.items()}
    want, _ = storm_run(cpu_params, stream, cpu, resilient=True)
    print(f"fault storm ({len(stream)} requests, deadline 500 ms, 3 "
          f"retries): resilient goodput {good:.4f} in {wall:.3f} s wall, "
          f"retries {stats['retries']}, hedges {stats['hedges']}, deadline "
          f"misses {stats['deadline_misses']}, failed {stats['failed']}; "
          f"bare goodput {bare_good:.4f}")
    if good < 0.99 or stats["failed"] != 0 or bare_good >= 0.5:
        fail(f"fault storm: goodput {good} (failed {stats['failed']}), "
             f"bare {bare_good}")
    diff = [a[0] for a, b in zip(got, want) if a != b]
    if diff:
        fail(f"fault storm: {dev} and cpu differ on uids {diff[:10]}")
    print(f"fault storm: every uid's outcome (pair, attempts, exception) on "
          f"{dev} == cpu")
    phase("23 fault storm", t0)


#: phase 24's shard-selection inputs: bench_cluster's 2048 uids
SHARD_UIDS = 2048
#: the tolerance of a float that two replays sum in another order (a
#: cluster drain completes the pods' last batches from several threads)
REPLAY_RTOL = 1e-12


def replay_close(got, want, where):
    """Integers, strings and structure equal; floats bit-equal or within
    ``REPLAY_RTOL`` relative; fails naming the quantity that differs."""
    import math
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            fail(f"{where}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            replay_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            fail(f"{where}: {len(got)} items != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            replay_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        if not (isinstance(got, float) and (got == want or math.isclose(
                got, want, rel_tol=REPLAY_RTOL, abs_tol=0.0))):
            fail(f"{where}: {got!r} != {want!r} beyond {REPLAY_RTOL} "
                 "relative")
    elif type(got) is not type(want) or got != want:
        fail(f"{where}: {got!r} != {want!r}")


class PinnedPolicy:
    """A pod's policy that routes every request to one pair; ``observed``
    keeps the uids of the observations folded into it."""
    batchable = True

    def __init__(self, pair):
        self.pair, self.observed = pair, []

    def decide(self, req):
        from repro_torch.core.policy import RouteDecision
        return RouteDecision(uid=req.uid, pair=self.pair, group=0)

    def decide_batch(self, reqs):
        return [self.decide(r) for r in reqs]

    def observe(self, obs):
        self.observed.append(obs.uid)


def ed_policy(dev):
    """ED and Algorithm 1 at δ = 5 over the nominal profile on ``dev``."""
    from repro_torch.core.estimators import EdgeDetectionEstimator
    from repro_torch.core.policy import DetectionPolicy
    from repro_torch.core.router import GreedyEstimateRouter
    from repro_torch.detection.devices import nominal_profile_table
    table = nominal_profile_table(device=dev)
    return DetectionPolicy(GreedyEstimateRouter(table, 5.0), table,
                           EdgeDetectionEstimator(device=dev))


def detector_factory(params, dev, max_batch):
    """Backends of the seeded detectors on ``dev``."""
    from repro_torch.serving.backend import DetectorBackend
    return lambda d: DetectorBackend(*d.pair, params[d.pair[0]],
                                     max_batch=max_batch, device=dev)


def ed_cluster(params, scenes, dev, pods, shard):
    """Phase 24's cluster: ``pods`` ED pods over detector backends
    (max_batch 8) on ``dev``, ``scenes`` through ``submit_batch`` and
    ``drain``; per uid (pod, pair, estimated count), the pair histogram
    and the wall seconds."""
    import collections
    from repro_torch.core.policy import RouteRequest
    from repro_torch.serving.cluster import EcoreCluster
    reqs = [RouteRequest(uid=u, payload=s.image, true_complexity=s.count)
            for u, s in enumerate(scenes)]
    with EcoreCluster(lambda i: ed_policy(dev),
                      detector_factory(params, dev, 8), pods=pods,
                      shard=shard, device=dev) as cl:
        sync(dev)
        t0 = time.perf_counter()
        futs = cl.submit_batch(reqs)
        cl.drain()
        served = [f.result(timeout=WAIT_S) for f in futs]
        sync(dev)
        wall = time.perf_counter() - t0
        per_uid = {s.request.uid: (cl.owner_of(s.request.uid),
                                   s.decision.pair,
                                   s.decision.est_complexity)
                   for s in served}
    hist = collections.Counter(p for _, p, _ in per_uid.values())
    return per_uid, hist, wall


def shard_selection(dev):
    """Phase 24's shard selection: the picks on ``dev`` against the scalar
    reference, and the µs per request of both (each a call with the copy
    back)."""
    import numpy as np
    from repro_torch.serving.cluster import (select_pods,
                                             select_pods_reference)
    uids = np.random.default_rng(1).integers(0, 2**31, size=SHARD_UIDS)
    for pods in (4, 6):
        depths = np.random.default_rng(pods).integers(0, 9, size=pods)
        for mode in ("least_loaded", "rendezvous"):
            for dead in (None, 1):
                alive = None if dead is None else np.arange(pods) != dead
                got = select_pods(uids, depths, mode, alive, device=dev)
                t0 = time.perf_counter()
                for _ in range(20):
                    got = select_pods(uids, depths, mode, alive, device=dev)
                us = (time.perf_counter() - t0) / 20 / SHARD_UIDS * 1e6
                t0 = time.perf_counter()
                want = select_pods_reference(uids, depths, mode, alive)
                ref_us = (time.perf_counter() - t0) / SHARD_UIDS * 1e6
                if not np.array_equal(got, want):
                    fail(f"select_pods on {dev} differs from the reference "
                         f"({pods} pods, {mode}, pod {dead} dead) at "
                         f"{int(np.sum(got != want))} of {SHARD_UIDS} uids")
                print(f"shard selection, {SHARD_UIDS} uids, {pods} pods, "
                      f"{mode}, dead pod {dead}: picks == reference; "
                      f"{us:.3f} µs a request on {dev} (20 calls, copy back "
                      f"included), reference {ref_us:.3f} µs")


def degradation(params, scenes, dev):
    """Phase 24's degradation: 3 pinned pods, ``pod_fail_after=2``, pod 0's
    pair served by a detector whose device is down from uid 0."""
    from repro_torch.core.policy import Observation, RouteRequest
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.cluster import EcoreCluster
    from repro_torch.serving.faults import FaultSpec
    pairs = [("ssd_v1", "orin_nano"), ("ssd_lite", "pi5"),
             ("yolov8_n", "pi5_tpu")]
    pols = [PinnedPolicy(p) for p in pairs]

    def factory(d):
        faults = [FaultSpec("crash_window", start=0)] if d.pair == pairs[0] \
            else []
        return make_backend("faulty:detector", *d.pair, params[d.pair[0]],
                            max_batch=1, faults=faults, device=dev)

    n = 40
    cl = EcoreCluster(lambda i: pols[i], factory, pods=3, pod_fail_after=2,
                      device=dev)
    try:
        futs = cl.submit_batch([RouteRequest(uid=u, payload=s.image)
                                for u, s in enumerate(scenes[:n])])
        cl.drain()
        served = [f.result(timeout=WAIT_S) for f in futs
                  if f.exception(timeout=WAIT_S) is None]
        for s in served:
            cl.observe(Observation(pair=s.decision.pair, uid=s.request.uid,
                                   time_ms=s.result.time_ms))
        stats = cl.stats()
    finally:
        cl.close()
    by_pod = [{s.request.uid for s in served
               if s.result.backend == "@".join(p)} for p in pairs]
    print(f"degradation: {n} requests, {n - len(served)} failed, alive "
          f"{stats['alive']}, resubmitted {stats['resubmitted']}, served "
          f"by pod {[len(b) for b in by_pod]}, stale observations "
          f"{stats['stale_observations']}")
    if (n - len(served) > 1 or stats["alive"] != [False, True, True]
            or stats["resubmitted"] < 1 or by_pod[0]
            or stats["stale_observations"] != 0 or pols[0].observed
            or any(set(pols[i].observed) != by_pod[i] for i in (1, 2))):
        fail("degradation outside its bounds")


def scaling(params, scenes, dev):
    """Phase 24's finding (no bar): requests per second at 1, 2 and 4 pods,
    with the real detectors over the 256 scenes, and in bench_cluster's
    setting (48 requests, null detectors, ``realtime_scale=1``)."""
    import numpy as np
    from repro_torch.core.policy import DetectionPolicy, RouteRequest
    from repro_torch.core.router import OracleRouter
    from repro_torch.detection.devices import nominal_profile_table
    from repro_torch.serving.backend import make_backend, null_run
    from repro_torch.serving.cluster import EcoreCluster
    counts = np.random.default_rng(0).integers(0, 9, size=48)
    frame = np.zeros((8, 8), np.float32)

    def oracle(i):
        table = nominal_profile_table(device=dev)
        return DetectionPolicy(OracleRouter(table, 5.0), table)

    def sleeper(d):
        return make_backend("detector", *d.pair, None, max_batch=4,
                            run_fn=null_run, realtime_scale=1.0, device=dev)

    real, modeled = {}, {}
    for pods in (1, 2, 4):
        real[pods] = len(scenes) / ed_cluster(params, scenes, dev, pods,
                                              "least_loaded")[2]
        with EcoreCluster(oracle, sleeper, pods=pods, device=dev) as cl:
            reqs = [RouteRequest(uid=i, payload=frame, true_complexity=int(c))
                    for i, c in enumerate(counts)]
            t0 = time.perf_counter()
            futs = cl.submit_batch(reqs)
            cl.drain()
            for f in futs:
                f.result(timeout=WAIT_S)
            modeled[pods] = len(reqs) / (time.perf_counter() - t0)
    if dev.type == "cuda":
        for pods in (1, 4):
            print(f"scaling, real detectors, {pods} pods under the profiler: "
                  + busy_share(lambda: ed_cluster(params, scenes, dev, pods,
                                                  "least_loaded")))
    for name, rps in (("real detectors, 256 scenes", real),
                      ("bench_cluster (48, null_run, realtime_scale=1)",
                       modeled)):
        print(f"scaling, {name}: " + ", ".join(
            f"{p} pods {v:.1f} req/s" for p, v in rps.items())
            + f"; 2 pods {rps[2] / rps[1]:.3f}x, 4 pods "
            f"{rps[4] / rps[1]:.3f}x of 1 pod")


def busy_share(fn) -> str:
    """``fn()`` once under the profiler: its wall seconds and the device's
    busy time and share of them (every kernel of every thread)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced(fn)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return (f"{wall:.3f} s, device busy {busy_us / 1e3:.2f} ms = "
            f"{busy_us / 1e6 / wall:.2%} of the wall time")


def cluster_plane(params, scenes, dev, canny_ops):
    """Phase 24: shard selection, the 4-pod ED cluster over 256 scenes in
    both shard modes (its first 64 scenes again on the CPU), degradation
    and the scaling finding.  Returns the Canny launches of the counted
    runs."""
    import copy
    import numpy as np
    import torch
    from repro_torch.serving.cluster import select_pods_reference
    t0 = time.perf_counter()
    shard_selection(dev)
    cpu = torch.device("cpu")
    cpu_params = {m: copy.deepcopy(p).to(cpu) for m, p in params.items()}
    ed_cluster(params, scenes[:32], dev, 4, "least_loaded")  # warm-up
    launches = 0
    for shard in ("least_loaded", "rendezvous"):
        canny_ops.launches = 0
        per_uid, hist, wall = ed_cluster(params, scenes, dev, 4, shard)
        n_canny = canny_ops.launches
        launches += n_canny
        pods = [per_uid[u][0] for u in range(len(scenes))]
        want = select_pods_reference(range(len(scenes)), np.zeros(4, int),
                                     shard)
        print(f"cluster, 4 pods, {shard}: {len(scenes)} scenes in {wall:.3f} "
              f"s; canny launches {n_canny}; shards "
              f"{np.bincount(pods, minlength=4).tolist()}; pairs "
              f"{dict(hist)}")
        if pods != want.tolist():
            fail(f"cluster ({shard}): a uid's pod differs from the "
                 "reference's pick")
        if dev.type == "cuda" and n_canny != len(set(pods)):
            fail(f"cluster ({shard}): {n_canny} canny launches for "
                 f"{len(set(pods))} pods with a shard")
        if sum(hist.values()) != len(scenes):
            fail(f"cluster ({shard}) served {dict(hist)}")
        cpu_uid, _, _ = ed_cluster(cpu_params, scenes[:64], cpu, 4, shard)
        diff = sorted(u for u in cpu_uid if cpu_uid[u] != per_uid[u])
        if diff:
            fail(f"cluster ({shard}): {dev} and cpu differ on uids {diff}")
        print(f"cluster, 4 pods, {shard}: (pod, pair, estimate) on {dev} == "
              f"cpu on 64/64 uids")
    degradation(params, scenes, dev)
    scaling(params, scenes, dev)
    phase("24 cluster plane", t0)
    return launches


def load_settings(dev):
    """bench_load's steady rate and deadline: the nominal profile's mean
    service time over 256 draws of ``COUNT_PROBS`` (seed 0)."""
    import numpy as np
    from repro_torch.core.router import greedy_route
    from repro_torch.detection import scenes as sc
    from repro_torch.detection.devices import nominal_profile_table
    table = nominal_profile_table(device=dev)
    mix = np.random.default_rng(0).choice(len(sc.COUNT_PROBS),
                                          p=sc.COUNT_PROBS, size=256)
    mean_ms = float(np.mean([greedy_route(int(c), table, 5.0).time_ms
                             for c in mix]))
    return 0.5 * 2 * 1e3 / mean_ms, 4.0 * (20.0 + mean_ms)


def load_replay(policy_for, backend_for, dev, pattern, autoscale,
                duration_s, window_s, scene_images=False):
    """One bench_load episode through the port: 2 pods (up to 6 under the
    autoscaler: watermarks 10 and 1, cooldown 0.5 s), ``max_wait_ms`` 20,
    arrivals seed 7, tenant seed 1, on a manual clock; the SLO summary,
    window records, autoscaler events and request count."""
    import repro_torch.traffic as tr
    from repro_torch.serving.cluster import Autoscaler, EcoreCluster
    steady_hz, deadline_ms = load_settings(dev)
    clock = tr.ManualClock()
    cl = EcoreCluster(policy_for, backend_for, pods=2, max_pods=6,
                      max_wait_ms=20.0, clock=clock, retain_results=False,
                      flusher=False, device=dev)
    auto = Autoscaler(cl, clock, min_pods=2, max_pods=6,
                      high_backlog_per_pod=10.0, low_backlog_per_pod=1.0,
                      cooldown_s=0.5) if autoscale else None
    work = tr.merge_tenants([tr.detector_tenant(
        "cams", tr.make_arrivals(pattern, steady_hz, duration_s, seed=7),
        seed=1, deadline_ms=deadline_ms, scene_images=scene_images)])
    driver = tr.LoadDriver(cl, clock, autoscaler=auto, window_s=window_s)
    try:
        driver.run(work)
    finally:
        cl.close()
    return {"summary": driver.slo.summary(),
            "windows": driver.slo.window_records(),
            "autoscaler_events": auto.events if auto else [],
            "requests": len(work)}


def traffic_plane(params, dev, canny_ops):
    """Phase 25: BENCH_gateway.json entry [9] replayed through the port,
    then a 1 s flash crowd of rendered scenes whose pods run ED per
    request and the detectors on ``dev``, against the same replay on the
    CPU.  Returns the Canny launches of the counted replay."""
    import copy
    import torch
    from repro_torch.core.policy import DetectionPolicy
    from repro_torch.core.router import OracleRouter
    from repro_torch.detection.devices import nominal_profile_table
    from repro_torch.serving.backend import make_backend, null_run
    t0 = time.perf_counter()
    entry = json.loads((ROOT / "BENCH_gateway.json").read_text())[9]["load"]
    steady_hz, deadline_ms = load_settings(dev)
    replay_close([steady_hz, deadline_ms], [entry["settings"]["steady_hz"],
                                            entry["settings"]["deadline_ms"]],
                 "entry9.settings")

    def oracle(i):
        table = nominal_profile_table(device=dev)
        return DetectionPolicy(OracleRouter(table, 5.0), table)

    def null_backend(d):
        return make_backend("detector", *d.pair, None, max_batch=4,
                            run_fn=null_run, device=dev)

    runs = {}
    for pattern in ("poisson", "flash"):
        for fleet in ("fixed", "autoscaled"):
            t1 = time.perf_counter()
            r = load_replay(oracle, null_backend, dev, pattern,
                            fleet == "autoscaled", 12.0, 2.0)
            cell = f"{pattern}_{fleet}"
            replay_close(r, entry["runs"][cell], f"entry9.{cell}")
            runs[cell] = s = r["summary"]
            print(f"entry [9] {cell}: {r['requests']} requests, goodput "
                  f"{s['goodput_fraction']:.4f}, p50 {s['p50_ms']:.1f}, p95 "
                  f"{s['p95_ms']:.1f}, p99 {s['p99_ms']:.1f} ms, "
                  f"{s['joules_per_request']:.6f} J/request, "
                  f"{len(r['autoscaler_events'])} scale events == "
                  f"BENCH_gateway.json ({time.perf_counter() - t1:.2f} s)")
    fixed, auto = runs["flash_fixed"], runs["flash_autoscaled"]
    if not (auto["p99_ms"] < fixed["p99_ms"]
            and auto["goodput_fraction"] > fixed["goodput_fraction"]):
        fail("entry [9]: the autoscaled flash crowd does not beat the fixed "
             "fleet")

    def real(dev_, params_):
        return load_replay(lambda i: ed_policy(dev_),
                           detector_factory(params_, dev_, 4), dev_,
                           "flash", True, 1.0, 0.25, scene_images=True)

    cpu = torch.device("cpu")
    cpu_params = {m: copy.deepcopy(p).to(cpu) for m, p in params.items()}
    canny_ops.launches = 0
    sync(dev)
    t1 = time.perf_counter()
    got = real(dev, params)
    sync(dev)
    wall = time.perf_counter() - t1
    n_canny = canny_ops.launches
    s = got["summary"]
    print(f"real-work replay: {got['requests']} requests (1 s virtual, "
          f"flash crowd of 64x64 scenes) in {wall:.3f} s wall = "
          f"{got['requests'] / wall:.1f} requests a wall second; canny "
          f"launches {n_canny}; goodput {s['goodput_fraction']:.4f}, p99 "
          f"{s['p99_ms']:.1f} ms, failed {s['failed']}; scale events "
          f"{[(e['action'], e['pod']) for e in got['autoscaler_events']]}")
    if dev.type == "cuda" and n_canny != got["requests"]:
        fail(f"real-work replay: {n_canny} canny launches for "
             f"{got['requests']} requests")
    if s["completions"] != got["requests"] or s["failed"]:
        fail(f"real-work replay: {s['completions']} completions, "
             f"{s['failed']} failed of {got['requests']}")
    replay_close(got, real(cpu, cpu_params), "real-work replay vs cpu")
    print(f"real-work replay: summary, {len(got['windows'])} window records "
          f"and autoscaler events on {dev} == cpu")
    if dev.type == "cuda":
        print(f"real-work replay under the profiler: "
              f"{busy_share(lambda: real(dev, params))}")
    phase("25 traffic plane", t0)
    return n_canny


#: phase 26: half the reference's training run (700 steps a detector; cut
#: for phase 50's time: the relations held at 350), and the paper's
#: router matrix (benchmarks/common.py's router_matrix) over Figs. 6-8's
#: datasets
TRAIN_STEPS = 350
PAPER_ROWS = ("Orc", "RR", "Rnd", "LE", "LI", "HM", "HMG", "ED", "SF", "OB")
FIGURES = (("fig6", "full_dataset", dict(n=300, seed=31)),
           ("fig7", "balanced_sorted_dataset", dict(per_group=50, seed=32)),
           ("fig8", "video_dataset", dict(n_frames=300, seed=33)))
#: an objectness within atol 1e-6 + rtol 1e-5 of 0.5
HALF_EDGE = 1e-6 + 1e-5 * 0.5


def train_testbed(dev):
    """Phase 26, part one: the eight detectors trained on ``dev`` at the
    reference's settings into a fresh directory, saved as the JAX package
    saves them and loaded back through ``train_all``'s cache."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.detection.detectors import (DETECTOR_CONFIGS,
                                                 init_detector, params_to_jax)
    from repro_torch.detection.train import fit_detector, train_all
    out = ROOT / "chiprun_out" / f"detectors-{time.strftime('%H%M%S')}"
    shutil.rmtree(out, ignore_errors=True)
    trained = {}
    sync(dev)
    t_train = time.perf_counter()
    for name, cfg in DETECTOR_CONFIGS.items():
        model = init_detector(cfg, 0).to(dev)
        t1 = time.perf_counter()
        # cuDNN's deterministic algorithms: the testbed, and so every row
        # below, repeats run to run (tools/training_probe.py measures both)
        torch.backends.cudnn.deterministic = True
        try:
            losses = fit_detector(model, steps=TRAIN_STEPS)
        finally:
            torch.backends.cudnn.deterministic = False
        secs = time.perf_counter() - t1
        ckpt.save(str(out / f"{name}.npz"), params_to_jax(model))
        print(f"train {name}: {TRAIN_STEPS} steps in {secs:.2f} s, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {losses.min():.4f})")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"training {name} did not lower its loss: {losses[0]} -> "
                 f"{losses[-1]}")
        trained[name] = model
    t_train = time.perf_counter() - t_train
    print(f"training: {len(trained)} detectors in {t_train:.2f} s on {dev}")
    if dev.type == "cuda":
        adamw_card_vs_cpu(dev)
    loaded = train_all(str(out), device=dev)
    x = torch.from_numpy(rand((32, 64, 64, 1), 26)).to(dev)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        for name, model in trained.items():
            if loaded[name].cfg != DETECTOR_CONFIGS[name] or not torch.equal(
                    loaded[name](x), model(x)):
                fail(f"{name} loaded from its checkpoint differs from the "
                     "trained model")
    print(f"checkpoints: {len(loaded)} detectors saved under "
          f"{out.relative_to(ROOT)} and loaded back through train_all, raw "
          "heads bit-equal to the trained models'")
    return loaded, out


#: phase 26's AdamW check on LM trees: phase 44's models, whose CPU step
#: applies its update on the card (``StepGradients``)
ADAMW_LM_ARCHS = ("qwen2.5-3b", WHISPER, "mamba2-370m", "recurrentgemma-2b",
                  GRANITE, DSV2, LLAVA)


def adamw_card_vs_cpu(dev) -> None:
    """``adamw_update`` on the card equals the CPU's bit for bit (the
    parameters and both moments) over 30 unclipped steps of seeded
    gradients: on yolov8_m's parameters at the detectors' settings, and on
    the f32 masters of each of ``ADAMW_LM_ARCHS`` (reduced) at the LM
    step's weight decay and decay rule (``decays_as_stacked``: every leaf
    of a layer, its norms and biases too, and the expert and shared
    leaves), so that phase 44 may apply the CPU step's update on the
    card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.detection.detectors import DETECTOR_CONFIGS, init_detector
    from repro_torch.launch.steps import decays_as_stacked
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import (AdamWConfig, _walk, adamw_update,
                                         decays_matrices, init_opt_state,
                                         tree_leaves, tree_paths,
                                         tree_unflatten)
    model = init_detector(DETECTOR_CONFIGS["yolov8_m"], 0)
    trees = [("yolov8_m", {k: v.detach() for k, v in
                           model.named_parameters()},
              AdamWConfig(peak_lr=5e-3, warmup_steps=20, total_steps=30,
                          weight_decay=1e-4, clip_norm=None), None)]
    trees += [(arch, init_params(get_config(arch).reduced(), seed=26,
                                 device="cpu", keep_f32=True),
               AdamWConfig(peak_lr=1e-3, warmup_steps=20, total_steps=30,
                           clip_norm=None), decays_as_stacked)
              for arch in ADAMW_LM_ARCHS]
    notes = []
    for name, tree, cfg, decays in trees:
        kw = {} if decays is None else {"decays": decays}
        out = {}
        for where in (dev, torch.device("cpu")):
            gen = torch.Generator().manual_seed(0)
            p = tree_unflatten(tree, [x.clone().to(where)
                                      for x in tree_leaves(tree)])
            opt = init_opt_state(p)
            for _ in range(30):
                g = tree_unflatten(p, [
                    (torch.randn(x.shape, generator=gen) * 1e-2).to(where)
                    for x in tree_leaves(p)])
                p, opt, _ = adamw_update(cfg, p, g, opt, **kw)
            out[where.type] = [x.cpu() for t in (p, opt.mu, opt.nu)
                               for x in tree_leaves(t)]
        paths = tree_paths(tree)
        bad = [paths[i % len(paths)] for i, (a, c) in enumerate(
            zip(out[dev.type], out["cpu"])) if not torch.equal(a, c)]
        if bad:
            fail(f"adamw_update on {dev} differs from the cpu's on {name} "
                 f"in {bad}")
        decayed = sum((decays or decays_matrices)(q, x)
                      for q, x in _walk(tree))
        notes.append(f"{name} ({len(paths)} leaves, {decayed} decayed)")
    print(f"adamw: 30 steps on {dev} == cpu bit for bit (parameters and "
          f"moments) over " + ", ".join(notes))


def paper_gateway(row, table, params, dev, delta=5.0):
    """``benchmarks/common.py``'s router-matrix entry ``row`` as a Gateway
    on ``dev`` (open loop, batches of 32)."""
    from repro_torch.core import estimators as est_mod
    from repro_torch.core import router as rt
    from repro_torch.core.gateway import Gateway
    cls = {"Orc": rt.OracleRouter, "RR": rt.RoundRobinRouter,
           "Rnd": rt.RandomRouter, "LE": rt.LowestEnergyRouter,
           "LI": rt.LowestInferenceRouter, "HM": rt.HighestMAPRouter,
           "HMG": rt.HighestMAPPerGroupRouter}.get(row,
                                                   rt.GreedyEstimateRouter)
    est = {"Orc": est_mod.OracleEstimator,
           "ED": lambda: est_mod.EdgeDetectionEstimator(device=dev),
           "SF": lambda: est_mod.SSDFrontEndEstimator(
               params["ssd_v1"], "ssd_v1", device=dev),
           "OB": est_mod.OutputBasedEstimator}.get(row, lambda: None)()
    router = cls(table, delta)
    router.name = row
    return Gateway(router, table, params, est, max_batch=32, device=dev)


def profile_on_both(params, dev):
    """Phase 26, part two: ``profile_pairs`` over ``TESTBED_PAIRS`` and
    ``full_dataset(250, seed=99)`` on ``dev`` and on the CPU from the same
    weights; returns the card's table and the CPU's copies of the
    detectors."""
    import copy
    import numpy as np
    import torch
    from repro_torch.core.groups import group_of
    from repro_torch.detection import scenes as sc
    from repro_torch.detection.devices import TESTBED_PAIRS
    from repro_torch.detection.train import profile_pairs
    cpu = torch.device("cpu")
    cpu_params = {m: copy.deepcopy(p).to(cpu) for m, p in params.items()}
    t1 = time.perf_counter()
    table = profile_pairs(params, TESTBED_PAIRS, device=dev)
    t_card = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu_table = profile_pairs(cpu_params, TESTBED_PAIRS, device=cpu)
    t_cpu = time.perf_counter() - t1
    val = sc.full_dataset(250, seed=99)
    models = sorted({m for m, _ in TESTBED_PAIRS})
    near, _, worst = score_edges({m: params[m] for m in models},
                                 {m: cpu_params[m] for m in models},
                                 np.stack([s.image for s in val]), dev,
                                 edge=HALF_EDGE)
    near_groups = {m: {group_of(val[u].count) for u in near[m]}
                   for m in models}
    for a, b in zip(table.entries, cpu_table.entries):
        if (a.model, a.device, a.group, a.time_ms, a.energy_mwh) != (
                b.model, b.device, b.group, b.time_ms, b.energy_mwh):
            fail(f"profile rows differ between {dev} and cpu: {a} / {b}")
        if a.map_pct != b.map_pct and a.group not in near_groups[a.model]:
            fail(f"profile mAP of {a.pair_name} group {a.group} differs "
                 f"between {dev} ({a.map_pct}) and cpu ({b.map_pct}) with no "
                 "objectness near 0.5")
    print(f"profile: {len(table.entries)} rows on {dev} in {t_card:.2f} s, "
          f"on cpu in {t_cpu:.2f} s; time and energy equal, mAP equal "
          f"except near 0.5; objectness within {worst:.3f} of the bar; "
          f"frames with a score within {HALF_EDGE:.1e} of 0.5: "
          f"{ {m: len(f) for m, f in near.items()} }")
    groups = sorted({e.group for e in table.entries})
    picks = {g: max(table.for_group(g), key=lambda e: e.map_pct).pair_name
             for g in groups}
    by_model = {(e.model, e.group): e.map_pct for e in table.entries}
    for m in models:
        print(f"profile {m}: mAP by group " + ", ".join(
            f"{by_model[(m, g)]:.2f}" for g in groups))
    flat = len(set(picks.values())) < 2
    print(f"profile: HMG's pick by group {picks}" + (
        "; training at these settings gave a flat table (one pick in every "
        "group)" if flat else ""))
    return table, cpu_params


def figure_rows(table, params, cpu_params, dev, canny_ops):
    """Phase 26, part three: the paper's router matrix at δ = 5 over Figs.
    6-8's datasets on ``dev``, each row's first 64 scenes again on the CPU;
    the δ sweep of the oracle on Fig. 6's.  Returns the Canny launches of
    the ED rows and the rows' stats by (figure, row)."""
    import numpy as np
    import torch
    from repro_torch.core.profiles import ProfileTable
    from repro_torch.detection import scenes as sc
    cpu = torch.device("cpu")
    cpu_table = ProfileTable(table.entries, device=cpu)
    n_cpu, launches, stats = 64, 0, {}
    print("csv: figure,router,mAP,total_energy_mWh,total_time_ms,"
          "gateway_energy_mWh,gateway_time_ms,wall_s,cpu_equal,pairs")
    for fig, name, kw in FIGURES:
        scenes = getattr(sc, name)(**kw)
        images = np.stack([s.image for s in scenes[:n_cpu]])
        _, flips, _ = score_edges(params, cpu_params, images, dev)
        allowed = allowed_diffs(flips)
        rows = [(r, 5.0) for r in PAPER_ROWS]
        if fig == "fig6":
            rows += [("Orc", d) for d in (0.0, 10.0, 100.0)]
        for row, delta in rows:
            log, cpu_log = {}, {}
            gw = paper_gateway(row, table, params, dev, delta)
            log_decisions(gw, log)
            canny_ops.launches = 0
            sync(dev)
            t1 = time.perf_counter()
            st = gw.process_stream(scenes)
            sync(dev)
            wall = time.perf_counter() - t1
            n_canny = canny_ops.launches
            launches += n_canny
            if row == "ED" and dev.type == "cuda" and n_canny < 1:
                fail(f"{fig} ED never launched the canny kernel")
            if sum(st.pair_histogram.values()) != len(scenes):
                fail(f"{fig} {row} served {st.pair_histogram}")
            gw_cpu = paper_gateway(row, cpu_table, cpu_params, cpu, delta)
            log_decisions(gw_cpu, cpu_log)
            gw_cpu.process_stream(scenes[:n_cpu])
            diff = {u for u in range(n_cpu) if log[u] != cpu_log[u]}
            if diff - allowed.get(row, set()):
                fail(f"{fig} {row}: {dev} and cpu decide differently on "
                     f"scenes {sorted(diff)}")
            key = row if delta == 5.0 else f"{row}@{delta:g}"
            stats[(fig, key)] = st
            pairs = ";".join(f"{p}={n}" for p, n in
                             sorted(st.pair_histogram.items()))
            print(f"csv: {fig},{key},{st.map_pct:.4f},"
                  f"{st.total_energy_mwh:.6f},{st.total_time_ms:.3f},"
                  f"{st.gateway_energy_mwh:.6f},{st.gateway_time_ms:.4f},"
                  f"{wall:.3f},{n_cpu - len(diff)}/{n_cpu},{pairs}"
                  + (f",canny launches {n_canny}" if row == "ED" else ""))
    return launches, stats


def paper_relations(stats) -> None:
    """``tests/test_system.py``'s relations on the card's rows; then ED's
    savings against HMG, the paper's headline, as a finding."""
    for fig, _, _ in FIGURES:
        s = {k: v for (f, k), v in stats.items() if f == fig}
        if not (s["LE"].backend_energy_mwh <= s["Orc"].backend_energy_mwh
                <= s["HMG"].backend_energy_mwh + 1e-9):
            fail(f"{fig}: LE <= Orc <= HMG in backend energy does not hold")
        if not s["ED"].gateway_energy_mwh > s["Orc"].gateway_energy_mwh:
            fail(f"{fig}: ED's gateway energy is not above Orc's")
        if not (s["SF"].map_pct > 0 and s["SF"].gateway_energy_mwh > 0):
            fail(f"{fig}: SF's mAP or gateway energy is 0")
        hmg, ed = s["HMG"], s["ED"]
        print(f"paper {fig}: ED against HMG saves "
              f"{1 - ed.total_energy_mwh / hmg.total_energy_mwh:.1%} of the "
              f"energy and {1 - ed.total_time_ms / hmg.total_time_ms:.1%} of "
              f"the time at a mAP loss of {hmg.map_pct - ed.map_pct:.2f} "
              f"points (paper: 35 %, 49 %, 2 %)")
    f6 = {k: v for (f, k), v in stats.items() if f == "fig6"}
    if not f6["HMG"].map_pct >= f6["LE"].map_pct - 2.0:
        fail("fig6: HMG's mAP is below LE's - 2")
    if not f6["ED"].map_pct >= f6["Orc"].map_pct - 10.0:
        fail("fig6: ED's mAP is below Orc's - 10")
    energies = [f6[k].backend_energy_mwh for k in ("Orc@0", "Orc@10",
                                                   "Orc@100")]
    if not energies[0] >= energies[1] >= energies[2]:
        fail(f"fig6: Orc's backend energy rises over δ = 0, 10, 100: "
             f"{energies}")
    if not abs(f6["Orc@0"].map_pct - f6["HMG"].map_pct) < 5.0:
        fail("fig6: Orc at δ = 0 is not within 5 mAP of HMG")
    f8 = {k: v for (f, k), v in stats.items() if f == "fig8"}
    if not (f8["OB"].gateway_energy_mwh < f8["ED"].gateway_energy_mwh
            and f8["OB"].map_pct > 0):
        fail("fig8: OB is not cheaper than ED at the gateway, or its mAP "
             "is 0")
    print("paper: tests/test_system.py's relations hold on the card")


def paper_comparison(dev, canny_ops):
    """Phase 26: train, profile, and the paper's comparison (Figs. 6-8) on
    the trained testbed.  Returns the Canny launches of its ED rows and the
    testbed's directory: the checkpoints and the card's profile
    (``profile_table.json``), as ``default_testbed`` reads them."""
    t0 = time.perf_counter()
    params, out = train_testbed(dev)
    table, cpu_params = profile_on_both(params, dev)
    table.to_json(str(out / "profile_table.json"))
    launches, stats = figure_rows(table, params, cpu_params, dev, canny_ops)
    paper_relations(stats)
    phase("26 trained testbed and the paper's comparison", t0)
    return launches, out


# 31-32 ---------------------------------------- the serve driver, examples

#: the serve driver's runs of phase 31: (label, argv, the archs it serves).
#: Over synthetic_pool_table(DEFAULT_POOL) the buckets route: δ = 5,
#: buckets 0-3 to llama3-8b, 4 to recurrentgemma-2b; δ = 10, bucket 0 to
#: qwen2.5-3b, 1-4 to recurrentgemma-2b; δ = 18.5, 0 and 4 to mamba2-370m,
#: 1-3 to qwen2.5-3b; δ = 23, 0 to granite-moe-1b-a400m, 1-4 to mamba2-370m.
#: (b) serves 48 requests in batches of up to 4 so that batch shapes repeat:
#: --adapt moves the profile only when a batch runs slower than the fastest
#: earlier batch of its shape.  (f) serves two of the rest of the dense
#: family: over their own table at δ = 5, bucket 4 (the two 40 000-token
#: requests of seed 0) goes to gemma2-9b-swa (sub-quadratic, 72.90 against
#: deepseek-7b's 66.32), every other bucket to deepseek-7b.  (g) serves
#: deepseek-v2-lite-16b (bucket 0) beside llama3-8b (the rest) at δ = 12.4.
#: (h) serves whisper-small (bucket 0, each batch with its 1500 frames)
#: beside llama3-8b (the rest) at δ = 25.8.
SERVE_RUNS = (
    ("a", ["--requests", "24", "--delta", "5"],
     {"llama3-8b", "recurrentgemma-2b"}),
    ("b", ["--delta", "23", "--adapt", "--requests", "48", "--max-batch", "4"],
     {GRANITE, "mamba2-370m"}),
    ("c least_loaded", ["--requests", "24", "--delta", "5", "--pods", "4",
                        "--shard", "least_loaded"], {"llama3-8b", "recurrentgemma-2b"}),
    ("c rendezvous", ["--requests", "24", "--delta", "5", "--pods", "4",
                      "--shard", "rendezvous"], {"llama3-8b", "recurrentgemma-2b"}),
    ("d", ["--async", "--delta", "18.5"], {"mamba2-370m", "qwen2.5-3b"}),
    ("e", ["--rate", "20", "--duration", "2", "--pattern", "flash", "--pods",
           "2", "--max-wait-ms", "25", "--delta", "10"],
     {"qwen2.5-3b", "recurrentgemma-2b"}),
    ("f", ["--archs", "deepseek-7b", "gemma2-9b-swa", "--requests", "16",
           "--delta", "5"], {"deepseek-7b", "gemma2-9b-swa"}),
    ("g", ["--archs", DSV2, "llama3-8b", "--delta", "12.4", "--requests",
           "16"], {DSV2, "llama3-8b"}),
    ("h", ["--archs", WHISPER, "llama3-8b", "--delta", "25.8", "--requests",
           "16"], {WHISPER, "llama3-8b"}),
)
#: device memory a run may hold beyond one copy of its archs' weights
#: (caches of 96 rows, activations of up to 4 pods' batches of 8)
SERVE_SLACK_GIB = 4.0


class DriverRecorder:
    """While entered, the serve driver builds recording subclasses of its
    ``Backend``, ``ServingPool``, ``EcoreCluster`` and ``LoadDriver``:
    ``batches`` has (arch, batch size, prompt length, prefill s, decode s)
    of every ``serve_batch`` in serve order, ``decisions`` (prompt length,
    arch, bucket) of every routing decision; ``backends``, ``clusters``
    and ``drivers`` the objects built."""

    def __init__(self):
        self.backends, self.batches, self.decisions = [], [], []
        self.clusters, self.drivers = [], []

    def __enter__(self):
        from repro_torch import traffic
        from repro_torch.launch import serve
        rec = self

        class Backend(serve.Backend):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                rec.backends.append(self)

            def serve_batch(self, requests):
                out = super().serve_batch(requests)
                rec.batches.append((self.name, len(requests),
                                    len(requests[0].prompt),
                                    out[0].prefill_s, out[0].decode_s))
                return out

        class ServingPool(serve.ServingPool):
            def route(self, prompt_len):
                d = super().route(prompt_len)
                rec.decisions.append((prompt_len, d.arch, d.bucket))
                return d

            def route_batch(self, prompt_lens):
                ds = super().route_batch(prompt_lens)
                rec.decisions.extend((n, d.arch, d.bucket)
                                     for n, d in zip(prompt_lens, ds))
                return ds

        class EcoreCluster(serve.EcoreCluster):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                rec.clusters.append(self)

        class LoadDriver(traffic.LoadDriver):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                rec.drivers.append(self)

        self._saved = [(serve, "Backend", serve.Backend),
                       (serve, "ServingPool", serve.ServingPool),
                       (serve, "EcoreCluster", serve.EcoreCluster),
                       (traffic, "LoadDriver", traffic.LoadDriver)]
        serve.Backend, serve.ServingPool = Backend, ServingPool
        serve.EcoreCluster, traffic.LoadDriver = EcoreCluster, LoadDriver
        return self

    def __exit__(self, *exc):
        for module, name, value in self._saved:
            setattr(module, name, value)


def gib(n_bytes) -> str:
    return f"{n_bytes / 2**30:.2f} GiB"


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def device_memory(device) -> int:
    """Allocated device memory after a collection, 0 on the CPU."""
    import gc
    import torch
    gc.collect()
    if device != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def shared_weights(label, backends) -> int:
    """The bytes of the backends' weights; fails unless every backend of
    an arch holds the same parameter set, whatever the number of pods."""
    params = {}
    for be in backends:
        if params.setdefault(be.name, be.params) is not be.params:
            fail(f"run ({label}): two {be.name} backends hold two "
                 "parameter sets")
    return sum(tree_bytes(p) for p in params.values())


def serve_run(label, argv, device, extra, out_dir):
    """One run of ``repro_torch.launch.serve.main`` on ``device`` (with
    ``extra`` flags), every LLM kernel's launch count set to 0 just before
    and read just after.  Its output goes to ``out_dir/run-<label>.txt``;
    the lines other than the per-request ones are echoed.  Returns the
    output's lines, the launches, the recorder's batches and decisions,
    the clusters' shard counts, the replay's completions and numbers, and
    the weights' bytes, device memory before, at the peak and after; the
    run's backends, services and drivers are released before the last."""
    import contextlib
    import io
    import types
    import torch
    from repro_torch.launch import serve
    kernel_ops = llm_kernel_ops()
    before = device_memory(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for ops in kernel_ops.values():
        ops.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with DriverRecorder() as rec, contextlib.redirect_stdout(buf):
        rc = serve.main(argv + ["--device", device, "--dryrun-artifact",
                                str(out_dir / "no-dryrun.jsonl"), *extra])
    wall = time.perf_counter() - t0
    launches = {k: ops.launches for k, ops in kernel_ops.items()}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    weights = shared_weights(label, rec.backends)
    run = types.SimpleNamespace(
        batches=rec.batches, decisions=rec.decisions,
        shards=[c.stats()["shard_counts"] for c in rec.clusters],
        done=[len(d.completions) for d in rec.drivers],
        replay=[{"windows": d.slo.window_records(),
                 "summary": d.slo.summary()} for d in rec.drivers])
    del rec
    after = device_memory(device)
    text = buf.getvalue()
    (out_dir / f"run-{label.replace(' ', '-')}.txt").write_text(text)
    lines = text.splitlines()
    shown = [ln for ln in lines if not ln.startswith("req ")]
    print(f"serve run ({label}) on {device}: {' '.join(argv + list(extra))}"
          f"\n  rc {rc}, {wall:.2f} s, {len(lines) - len(shown)} request "
          f"lines, {len(run.batches)} serve_batch calls; launches "
          f"{launches}; weights {gib(weights)}, device memory before "
          f"{gib(before)}, peak {gib(peak)}, after {gib(after)}\n  " +
          "\n  ".join(ln for ln in shown if ln))
    if rc != 0:
        fail(f"the serve driver's run ({label}) returned {rc}")
    run.lines, run.launches = lines, launches
    run.memory = (weights, before, peak, after)
    return run


def route_check(label, run, delta, n_requests, archs):
    """Every decision of a run equals the same PoolPolicy's on the CPU,
    over the profile of ``archs``."""
    from repro_torch.core.policy import PoolPolicy, RouteRequest
    from repro_torch.serving.pool import ServingPool, synthetic_pool_table
    if len(run.decisions) != n_requests:
        fail(f"run ({label}) made {len(run.decisions)} routing decisions "
             f"for {n_requests} requests")
    cpu = PoolPolicy(ServingPool(synthetic_pool_table(archs, device="cpu"),
                                 delta=delta))
    want = [(d.backend, d.group) for d in cpu.decide_batch(
        [RouteRequest(uid=i, complexity=n)
         for i, (n, _, _) in enumerate(run.decisions)])]
    got = [(arch, bucket) for _, arch, bucket in run.decisions]
    if got != want:
        fail(f"run ({label}): routes differ from the policy's on the CPU: "
             f"{got} / {want}")


def served_uids(lines):
    return sorted(int(ln.split()[1]) for ln in lines if ln.startswith("req "))


def adapt_check(run, path):
    """Run (b)'s profile: read back, finite, the pristine profile's pairs;
    an arch's entries moved exactly when one of its batches ran slower
    than the fastest earlier batch of its shape (the driver's rule,
    replayed from the batches served)."""
    import math
    from repro_torch.core.profiles import ProfileTable
    from repro_torch.launch.serve import PROMPT_CAP
    from repro_torch.serving.pool import DEFAULT_POOL, synthetic_pool_table
    table = ProfileTable.from_json(str(path), device="cpu")
    pristine = synthetic_pool_table(DEFAULT_POOL, device="cpu")
    slower, baselines = {}, {}
    for arch, b, n, pre, dec in run.batches:
        key = (arch, b, min(n, PROMPT_CAP))
        local = (pre + dec) * 1e3 / b
        baselines[key] = min(baselines.get(key, local), local)
        slower[arch] = slower.get(arch, 0) + (local > baselines[key])
    moved = {}
    for e, p in zip(table.entries, pristine.entries):
        if (e.model, e.device, e.group, e.map_pct) != (
                p.model, p.device, p.group, p.map_pct):
            fail(f"run (b)'s profile has {e}, the pristine one {p}")
        if not all(map(math.isfinite, (e.time_ms, e.energy_mwh))):
            fail(f"run (b)'s profile holds a non-finite value: {e}")
        rel = max(abs(e.time_ms / p.time_ms - 1),
                  abs(e.energy_mwh / p.energy_mwh - 1))
        moved[e.model] = max(moved.get(e.model, 0.0), rel)
    for arch in DEFAULT_POOL:
        if (moved[arch] > 1e-9) != (slower.get(arch, 0) > 0):
            fail(f"run (b): {arch}'s profile moved by {moved[arch]:.3g} "
                 f"relative after {slower.get(arch, 0)} slower batches")
    print(f"  run (b)'s profile ({path.name}) read back through "
          f"ProfileTable.from_json, every value finite; batches slower "
          f"than the fastest of their shape {slower}; entries moved from "
          f"the pristine profile by (largest relative) " + ", ".join(
              f"{a} {moved[a]:.4g}" for a in DEFAULT_POOL))


def serve_driver(device="cuda", extra=()):
    """Phase 31: the serve driver's nine runs on ``device`` (``extra``:
    more flags, e.g. ``--reduced`` for a rehearsal on the CPU), then run
    (e) again with ``--device cpu --reduced``.  Returns the LLM kernels'
    launches summed over the runs and run (a)'s decisions (run (i), on
    phase 48's rows, comes after phase 48)."""
    import itertools
    from repro_torch.serving.pool import DEFAULT_POOL
    t0 = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / f"serve-{time.strftime('%H%M%S')}"
    out_dir.mkdir(parents=True, exist_ok=True)
    start = device_memory(device)
    total, served = {}, set()
    for label, argv, archs in SERVE_RUNS:
        delta = float(argv[argv.index("--delta") + 1])
        pool = DEFAULT_POOL   # the run's --archs, in order
        if "--archs" in argv:
            pool = tuple(itertools.takewhile(
                lambda a: not a.startswith("--"),
                argv[argv.index("--archs") + 1:]))
        if label == "b":
            argv = argv + ["--profile-out", str(out_dir / "profile.json")]
        run = serve_run(label, argv, device, extra, out_dir)
        weights, before, peak, after = run.memory
        for k, n in run.launches.items():
            total[k] = total.get(k, 0) + n
        got = {b[0] for b in run.batches}
        if got != archs:
            fail(f"run ({label}) served {sorted(got)}, not {sorted(archs)}")
        served |= got
        if after - start > 2**30:
            fail(f"run ({label}) left {gib(after - start)} of device memory "
                 "behind")
        if label == "a":
            synthetic = run.decisions
        if label == "b":
            adapt_check(run, out_dir / "profile.json")
            continue
        if label == "e":
            n, = run.done
            route_check(label, run, delta, n, pool)
            cpu_run = serve_run("e cpu", argv, "cpu", ["--reduced"], out_dir)
            replay_close(run.replay, cpu_run.replay, "run (e) card / cpu")
            print(f"  run (e): {n} requests; window records and summary "
                  f"on {device} == on the cpu with --reduced (integers "
                  f"exactly, floats within {REPLAY_RTOL} relative)")
            continue
        n = (int(argv[argv.index("--requests") + 1])
             if "--requests" in argv else 24)   # the driver's default
        route_check(label, run, delta, n, pool)
        if served_uids(run.lines) != list(range(n)):
            fail(f"run ({label}) served uids {served_uids(run.lines)}")
        if label.startswith("c"):
            counts, = run.shards
            if sum(counts) != 24:
                fail(f"run ({label})'s shards {counts} do not sum to 24")
            if device == "cuda" and peak - before > weights + \
                    SERVE_SLACK_GIB * 2**30:
                fail(f"run ({label}) peaked at {gib(peak - before)} over "
                     f"its start with {gib(weights)} of weights")
            print(f"  run ({label}): every uid served once, shard counts "
                  f"{counts}; peak {gib(peak - before)} over the run's "
                  f"start for {gib(weights)} of weights, one set per arch")
    want = set(DEFAULT_POOL).union(*(archs for *_, archs in SERVE_RUNS))
    if served != want:
        fail(f"the driver served {sorted(served)}, not all of "
             f"{sorted(want)}")
    if device == "cuda" and min(total.values()) < 1:
        fail(f"an LLM kernel was not launched by the driver: {total}")
    print(f"serve driver: all {len(DEFAULT_POOL)} models of the default "
          f"pool and {sorted(want - set(DEFAULT_POOL))} served; LLM kernel "
          f"launches over the runs {total}; device "
          f"memory {gib(start)} before the phase, "
          f"{gib(device_memory(device))} after")
    phase("31 the serve driver at full width", t0)
    return total, synthetic


def example_run(module, argv):
    """``module.main(argv)``'s output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return buf.getvalue()


def examples_on_card(testbed, canny_ops, canny_ref, device="cuda",
                     extra=()):
    """Phase 32: the examples through their ``main(argv)`` on ``device``:
    the detection examples over phase 26's testbed (``testbed``: its
    directory), ``service_quickstart`` at full width (``extra``: more of
    its flags, e.g. ``--reduced`` for a rehearsal on the CPU),
    ``async_cluster`` and ``load_test`` against their runs on the CPU.
    Returns the Canny launches of the ED rows."""
    import importlib
    from repro_torch.core.policy import PoolPolicy, RouteRequest
    from repro_torch.serving.pool import ServingPool, synthetic_pool_table
    t0 = time.perf_counter()
    recorder = CannyLaunches(canny_ops)
    canny = 0
    for name, n_scenes in (("quickstart", 60), ("video_stream", 150)):
        module = importlib.import_module(f"repro_torch.examples.{name}")
        stats = []
        gateway = module.Gateway

        class Spied(gateway):
            def process_stream(self, stream):
                out = super().process_stream(stream)
                stats.append((self.estimator, out))
                return out

        module.Gateway = Spied
        canny_ops.launches = 0
        try:
            with recorder:
                text = example_run(module, [
                    "--device", device, "--cache-dir", str(testbed),
                    "--profile", str(testbed / "profile_table.json")])
        finally:
            module.Gateway = gateway
        canny += canny_ops.launches
        print(f"example {name} on {device}: {canny_ops.launches} Canny "
              f"launches\n  " + "\n  ".join(
                  ln for ln in text.splitlines() if ln.strip()))
        for est, st in stats:
            if sum(st.pair_histogram.values()) != n_scenes:
                fail(f"example {name}: {st.router} served "
                     f"{st.pair_histogram} for {n_scenes} scenes")
        if device == "cuda" and canny_ops.launches < sum(
                type(est).__name__ == "EdgeDetectionEstimator"
                for est, _ in stats):
            fail(f"example {name}'s ED rows did not launch Canny")
    recorder.check(canny_ref)

    from repro_torch.examples import service_quickstart
    text = example_run(service_quickstart, ["--device", device, *extra])
    cpu = PoolPolicy(ServingPool(synthetic_pool_table(
        ["qwen2.5-3b", "mamba2-370m"], device="cpu"), delta=5.0))
    routes = [ln.split() for ln in text.splitlines() if ln.startswith("req ")]
    want = [(f"{d.pair[0]}@{d.pair[1]}", f"bucket={d.group}")
            for d in cpu.decide_batch([RouteRequest(
                uid=int(r[1]), complexity=int(r[3].rstrip(")")))
                for r in routes])]
    if len(routes) != 6 or [(r[5], r[6]) for r in routes] != want:
        fail(f"example service_quickstart's routes differ from the CPU "
             f"policy's: {text}")
    print(f"example service_quickstart on {device} (full width), routes "
          f"equal to the CPU policy's:\n  " + "\n  ".join(
              text.splitlines()))
    device_memory(device)

    for name in ("async_cluster", "load_test"):
        module = importlib.import_module(f"repro_torch.examples.{name}")
        t1 = time.perf_counter()
        text = example_run(module, ["--device", device])
        t_dev = time.perf_counter() - t1
        if text != example_run(module, ["--device", "cpu"]):
            fail(f"example {name} on {device} differs from its cpu run")
        print(f"example {name} on {device} in {t_dev:.2f} s, output equal "
              f"to its cpu run:\n  " + "\n  ".join(text.splitlines()))
    phase("32 the examples", t0)
    return canny


#: phase 48's rows: the default pool at the two serving shapes, then
#: mamba2-370m's training and 500k-token rows, the training rows of
#: granite-moe-1b-a400m, whisper-small, qwen2.5-3b and recurrentgemma-2b
#: (the last two fit under remat), and llama3-8b's skip row
#: the timed steps a row of phases 48 and 50 after its warm-up (which is
#: counted): one, not the dry run's ``REPS`` (3), for the script's time
#: limit
DRYRUN_REPS = 1
DRYRUN_CALLS = (("pool", None, ("prefill_32k", "decode_32k")),
                ("mamba2", ("mamba2-370m",), ("train_4k", "long_500k")),
                ("train", (GRANITE, WHISPER, "qwen2.5-3b",
                           "recurrentgemma-2b"), ("train_4k",)),
                ("skip", ("llama3-8b",), ("long_500k",)))
#: phase 48's rows: 5 x 2 of the pool, 2 of mamba2-370m, 4 training rows
#: and the skip row
DRYRUN_ROWS = 17
#: the reduced combinations whose counts must be equal on the card and the
#: CPU, (arch, kind, tokens, remat): a dense prefill (the flash kernel),
#: its decode (the decode kernel), an ssm prefill (the SSD kernel), and a
#: training step of each (the backward kernels on the card, autograd
#: through the plain versions on the CPU), with and without remat (the
#: recompute inside the backward)
DRYRUN_SAME = (("llama3-8b", "prefill", 48, False),
               ("llama3-8b", "decode", 48, False),
               ("mamba2-370m", "prefill", 300, False),
               ("llama3-8b", "train", 48, False),
               ("mamba2-370m", "train", 300, False),
               ("llama3-8b", "train", 48, True),
               ("mamba2-370m", "train", 300, True))
#: a dry-run row's roofline share (t_step / measured step) may pass 1 by
#: the timer's spread, not more: a larger share means the counts are wrong
ROOFLINE_SHARE_MAX = 1.05
#: bytes of f32 scores (of f64 decays, for the SSD) that a plain version
#: holds at once in phase 48's kernel checks
PLAIN_PIECE_BYTES = 2**31


class MainPathShapes:
    """While entered, records the LLM kernels' launches on the card by
    shape, dtype and options (the decode kernel's with its first
    ``lengths``), and the backward launches of the kernels named in
    ``trained``, so that ``check`` holds each kernel, and each of those
    backwards, to its plain version at every shape the main path gave it,
    on seeded inputs of those shapes.  Calls on the meta device (the dry
    run's memory count) launch nothing and are not recorded."""

    def __init__(self, mods, trained=()):
        self.mods, self.trained, self.seen, self._real = mods, trained, {}, {}

    @staticmethod
    def key(name, args):
        """The launch's shapes, dtype and options; the same key for a
        forward launch and a backward one."""
        if name == "flash_attention":
            q, k = args[:2]
            return (tuple(q.shape), tuple(k.shape), q.dtype, *args[-3:])
        if name == "decode_attention":
            q, k, _, _, window, softcap = args[:6]
            return (tuple(q.shape), tuple(k.shape), q.dtype, window, softcap,
                    len(args) > 6 and bool(args[6]))
        if name == "ssd_scan":
            x, B = args[0], args[3]
            if len(args) == 7:                        # forward: the chunk
                return tuple(x.shape), B.shape[-1], x.dtype, args[6]
            return (tuple(x.shape), B.shape[-1], x.dtype, args[8],
                    args[7] is not None)
        a, h0 = args[0], args[-1]
        return tuple(a.shape), a.dtype, h0 is not None

    def __enter__(self):
        for name, m in self.mods.items():
            for attr in ("_launch", "_launch_backward")[
                    :2 if name in self.trained else 1]:
                self._real[name, attr] = getattr(m, attr)
                setattr(m, attr, self._recording(
                    name, attr == "_launch_backward", getattr(m, attr)))
        return self

    def _recording(self, name, backward, launch):
        def recorded(*args):
            key = (name, backward, self.key(name, args))
            if not args[0].is_meta and key not in self.seen:
                self.seen[key] = (args[3].clone() if name == "decode_attention"
                                  else None)
            return launch(*args)
        return recorded

    def __exit__(self, *exc):
        for (name, attr), fn in self._real.items():
            setattr(self.mods[name], attr, fn)

    def check(self, dev) -> None:
        import torch
        missing = ({(n, False) for n in self.mods}
                   | {(n, True) for n in self.trained}) \
            - {(name, bwd) for name, bwd, _ in self.seen}
        if missing:
            fail(f"no launch of (kernel, backward) {sorted(missing)} "
                 f"recorded on the main path")
        checks = {("flash_attention", False): flash_at,
                  ("flash_attention", True): flash_bwd_at,
                  ("decode_attention", False): decode_at,
                  ("ssd_scan", False): ssd_at, ("ssd_scan", True): ssd_bwd_at,
                  ("rglru_scan", False): lru_at,
                  ("rglru_scan", True): lru_bwd_at}
        for (name, backward, key), lengths in self.seen.items():
            t0 = time.perf_counter()
            what = checks[name, backward](dev, key, lengths)
            print(f"  {name}{' backward' if backward else ''} {what} "
                  f"({time.perf_counter() - t0:.1f} s)")
            torch.cuda.empty_cache()


def flash_plain_rows(q, k, v, *, causal=True, window=None, softcap=None):
    """The flash kernel's plain version (``ref.mha_reference``'s
    arithmetic) in f32, a block of query rows at a time against only the
    key columns the block can see, each block's scores within
    ``PLAIN_PIECE_BYTES``: phase 48's 32 768-row prompts."""
    import torch
    from repro_torch.kernels.flash_attention import ref as fl_ref
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    rows = max(1, PLAIN_PIECE_BYTES // (4 * b * h * t))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        lo = 0 if window is None else max(0, r0 - window + 1)
        hi = min(t, r1) if causal else t
        qg = q[:, :, r0:r1].float().reshape(b, kv, h // kv, r1 - r0, d)
        scores = torch.einsum("bkgsd,bktd->bkgst", qg,
                              k[:, :, lo:hi].float()) * d ** -0.5
        if softcap is not None:
            scores = torch.tanh(scores / softcap) * softcap
        i = torch.arange(r0, r1, device=q.device)[:, None]
        j = torch.arange(lo, hi, device=q.device)[None, :]
        ok = j <= i if causal else j < hi
        if window is not None:
            ok = ok & (j > i - window)
        p = torch.softmax(torch.where(ok, scores, fl_ref.NEG_INF), dim=-1)
        out[:, :, r0:r1] = torch.einsum(
            "bkgst,bktd->bkgsd", p, v[:, :, lo:hi].float()).reshape(
                b, h, r1 - r0, d)
    return out


def flash_at(dev, key, _):
    """The flash kernel at a main-path launch's shapes and options on
    seeded inputs, against ``flash_plain_rows``: the JAX tests' bar
    against the plain version in the inputs' dtype and, in bf16, 2^-8
    relative + 1e-4 against it in f32."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fl_ops
    qs, ks, dtype, causal, window, softcap = key
    q, k, v = randn([qs, ks, ks], dtype, 48, dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fl_ops.attention(q, k, v, **kw)
    want32 = flash_plain_rows(q, k, v, **kw)
    err = attention_close(f"flash at {qs} over {ks}", got,
                          want32.to(dtype))
    err32 = (attention_close_f32(f"flash at {qs} over {ks}", got, want32)
             if dtype == torch.bfloat16 else err)
    return (f"{qs} over {ks} {dtype} causal {causal} window {window} "
            f"softcap {softcap}: max err {err:.3g} (plain in {dtype}), "
            f"{err32:.3g} (f32)")


def flash_bwd_at(dev, key, _):
    """The flash backward kernel at a main-path launch's shapes and
    options on seeded inputs, against its plain backward at phase 43's
    bar (``flash_bwd_check``)."""
    (b, h, s, d), (_, kv, t, _), dtype, causal, window, softcap = key
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, _, notes = flash_bwd_check("main path", (b, h, kv, s, t, d), dtype,
                                  kw, 48, dev)
    return (f"{(b, h, s, d)} over {(b, kv, t, d)} {dtype} causal {causal} "
            f"window {window} softcap {softcap}: max err against f64: "
            + ", ".join(notes) + " (phase 43's bar); equal bits in two calls")


def ssd_bwd_at(dev, key, _):
    """The SSD backward kernel at a main-path launch's shape, state size,
    dtype and chunk on seeded inputs (mamba2-370m's decays), against its
    plain backward at phase 46's bar (``ssd_bwd_check``)."""
    (b, s, h, p), n, dtype, chunk, with_state = key
    _, _, notes, _ = ssd_bwd_check("main path", "", (b, s, h, p, n), chunk,
                                   dtype, {"d_state": with_state}, 48, dev)
    return (f"{(b, s, h, p)} state {n} {dtype} chunk {chunk}"
            f"{' with d_state' if with_state else ''}: max err against f64: "
            f"{notes} (phase 46's bar); equal bits in two calls")


def lru_bwd_at(dev, key, _):
    """The RG-LRU backward kernel at a main-path launch's shape, with or
    without h0, on phase 17's gate inputs, against its plain backward
    (``lru_bwd_check``: bit for bit in f32, phase 43's bar against
    f64)."""
    shape, _, with_h0 = key
    _, _, notes = lru_bwd_check("main path", shape, with_h0, 48, dev)
    return (f"{shape} h0 {with_h0}: equal to the f32 plain backward bit for "
            f"bit and in two calls; max err against f64: {notes} (phase "
            f"43's bar)")


def decode_at(dev, key, lengths):
    """The decode kernel at a main-path launch's shapes, options and
    lengths on seeded inputs, against its plain version: the JAX tests'
    bar and, in bf16, the f32 plain version's; where the launch returned
    the softmax statistics, those against ``ref.py``'s
    (``decode_stats_close``)."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    qs, ks, dtype, window, softcap, stats = key
    q, k, v = randn([qs, ks, ks], dtype, 48, dev)
    kw = dict(window=window, softcap=softcap)
    got = dec_ops.decode(q, k, v, lengths, stats=stats, **kw)
    if stats:
        decode_stats_close(f"decode at {qs} over {ks}", got,
                           dec_ref.decode_reference(
                               q.float(), k.float(), v.float(), lengths,
                               stats=True, **kw))
        got = got[0]
    err = attention_close(f"decode at {qs} over {ks}", got,
                          dec_ref.decode_reference(q, k, v, lengths, **kw))
    err32 = err
    if dtype == torch.bfloat16:
        err32 = attention_close_f32(
            f"decode at {qs} over {ks}", got, dec_ref.decode_reference(
                q.float(), k.float(), v.float(), lengths, **kw))
    lens = sorted(set(lengths.tolist()))
    return (f"{qs} over {ks} {dtype} lengths {lens[0]}..{lens[-1]} window "
            f"{window} softcap {softcap}: max err {err:.3g} (plain in "
            f"{dtype}), {err32:.3g} (f32)"
            + ("; statistics == ref.py's" if stats else ""))


def ssd_at(dev, key, _):
    """The SSD kernel at a main-path launch's shape, state size, dtype and
    chunk, on inputs drawn as phase 13 draws them (mamba2-370m's decays;
    x, B and C column views of one tensor) but on the card, against its
    plain version run a group of heads at a time: in f32, y within twice
    the f32 plain version's own error against f64; in bf16, within one
    bf16 ulp of the f32 plain version plus that (phase 13's bars)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    (b, s, h, p), n, dtype, chunk = key
    gen = torch.Generator(device=dev).manual_seed(48)
    xbc = torch.randn((b, s, h * p + 2 * n), generator=gen,
                      device=dev).to(dtype)
    x, B, C = (xbc[..., :h * p].view(b, s, h, p), xbc[..., h * p:h * p + n],
               xbc[..., h * p + n:])
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    D = torch.randn(h, generator=gen, device=dev)
    y = ssd_ops.ssd(x, dt, A, B, C, D, chunk=chunk)
    q = min(chunk, s)
    heads = max(1, min(h, PLAIN_PIECE_BYTES // (8 * b * -(-s // q) * q * q)))
    own, err, pieces = 0.0, 0.0, []
    for i in range(0, h, heads):
        g = slice(i, i + heads)

        def plain(f):
            return ssd_ref.ssd_chunked(
                x[:, :, g].to(f), dt[:, :, g].to(f), A[g].to(f), B.to(f),
                C.to(f), D[g].to(f), chunk=chunk)
        y32, y64 = plain(torch.float32), plain(torch.float64)
        own = max(own, float((y32.double() - y64).abs().max()))
        err = max(err, float((y[:, :, g].double() - y64).abs().max()))
        pieces.append(y32)
        del y64
    if dtype == torch.float32:
        if err > 2 * own:
            fail(f"ssd at {key}: the kernel's y is {err:.4g} from f64, over "
                 f"twice the f32 plain version's {own:.4g}")
        return (f"{(b, s, h, p)} state {n} f32 chunk {chunk}: max err "
                f"against f64 {err:.4g}, bar 2 x {own:.4g}")
    want = torch.cat(pieces, dim=2)
    del pieces
    _, e = torch.frexp(want.abs())
    ulp = torch.where(want == 0, 0.0,
                      torch.ldexp(torch.ones_like(want), e - 8))
    del e
    miss = (y.float() - want.bfloat16().float()).abs() - ulp - 2 * own
    worst = float(miss.max())
    if worst > 0:
        fail(f"ssd at {key}: the bf16 kernel misses one bf16 ulp + "
             f"{2 * own:.4g} by up to {worst:.4g}")
    return (f"{(b, s, h, p)} state {n} bf16 chunk {chunk} ({-(-s // q)} "
            f"chunks, plain {heads} heads at a time): within one bf16 ulp "
            f"of the f32 plain version + {2 * own:.4g} (twice its error "
            f"against f64); max err against f64 {err:.4g}")


def lru_at(dev, key, _):
    """The RG-LRU kernel at a main-path launch's shape on phase 17's gate
    inputs, against its plain version: within twice the f32 plain
    version's own error against f64."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan import ref as lru_ref
    shape, dtype, with_h0 = key
    a, b = (t.to(dtype) for t in lru_gate_inputs(shape, 48, dev))
    h0 = (randn([(shape[0], shape[2])], dtype, 48, dev)[0] if with_h0
          else None)
    got = lru_ops.linear_scan(a, b, h0)
    plain = lru_ref.linear_scan(a, b, h0)
    ref = lru_ref.linear_scan(a.double(), b.double(),
                              None if h0 is None else h0.double())
    own = float((plain.double() - ref).abs().max())
    err = float((got.double() - ref).abs().max())
    if err > 2 * own:
        fail(f"rglru at {key}: the kernel is {err:.4g} from f64, over twice "
             f"the f32 plain version's {own:.4g}")
    return (f"{shape} {dtype} h0 {with_h0}: max err against f64 {err:.4g}, "
            f"bar 2 x {own:.4g}; against the plain version "
            f"{float((got - plain).abs().max()):.4g}")


def dryrun_counts_on_both(dev) -> None:
    """The step cost counter of the reduced combinations of
    ``DRYRUN_SAME``, bf16, on the card and on the CPU: operations and bytes
    equal, and every kind of aten op and kernel counted alike."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import StepCost
    from repro_torch.models import init_params
    from repro_torch.models.base import InputShape
    bad = []
    for arch, kind, seq, remat in DRYRUN_SAME:
        cfg = get_config(arch).reduced(num_layers=2, remat=remat)
        shape = InputShape(kind, seq, 2, kind)
        counts = []
        for device in (dev, torch.device("cpu")):
            run, _ = dryrun._step(cfg, shape, 2, init_params(
                cfg, dryrun.SEED, device, keep_f32=kind == "train"), device)
            with StepCost() as cost:
                run()
            counts.append(cost)
        card, cpu = counts
        if (card.flops, card.bytes) != (cpu.flops, cpu.bytes) or \
                card.by_kind != cpu.by_kind or \
                card.bytes_by_kind != cpu.bytes_by_kind:
            diff = {k: (card.by_kind[k], cpu.by_kind[k],
                        card.bytes_by_kind[k], cpu.bytes_by_kind[k])
                    for k in set(card.by_kind) | set(cpu.by_kind)
                    if (card.by_kind[k], card.bytes_by_kind[k])
                    != (cpu.by_kind[k], cpu.bytes_by_kind[k])}
            bad.append(f"reduced {arch} {kind} remat {remat}: card "
                       f"{card.flops:.6e} ops "
                       f"{card.bytes:.6e} B, cpu {cpu.flops:.6e} ops "
                       f"{cpu.bytes:.6e} B; by kind (card ops, cpu ops, "
                       f"card bytes, cpu bytes) {diff}")
            continue
        print(f"dry run counts, reduced {arch} {kind} (2 x {seq}, bf16, "
              f"remat {remat}): "
              f"{card.flops:.6e} ops, {card.bytes:.6e} B on the card == "
              f"on the cpu ({len(card.by_kind)} kinds equal)")
    if bad:
        fail("dry run counts differ between the card and the cpu: "
             + "; ".join(bad))


def dryrun_launches(cfg, kind, steps, batch):
    """(forward, backward) launches of each LLM kernel over ``steps``
    steps of one dry-run row of ``cfg`` at ``batch``: a prefill launches
    flash once an attention layer (an encdec model's encoder, self- and
    cross-attention) and the scans once a layer; a decode step the decode
    kernel once a cached attention layer; a training step the backward
    kernels once a layer each and the forward kernels ``recomputes``
    times, a micro-batch (``batch`` of them)."""
    kinds = launch_kinds(cfg)
    fwd = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
           "rglru_scan": 0}
    if kind == "decode":
        fwd["decode_attention"] = steps * sum(
            k in ("attn", "local", "cross") for k in kinds)
    else:
        n = steps * (batch if kind == "train" else 1)
        fwd.update(flash_attention=n * sum(
            k in ("attn", "local", "enc", "cross") for k in kinds),
                   ssd_scan=kinds.count("ssm") * n,
                   rglru_scan=kinds.count("rec") * n)
    bwd = {k: (n if kind == "train" else 0) for k, n in fwd.items()
           if k != "decode_attention"}
    if kind == "train":
        fwd = {k: n * recomputes(cfg) for k, n in fwd.items()}
    return fwd, bwd


def train_row_memory(r, base) -> None:
    """A dry-run training row: ``MICROBATCHES[arch]`` micro-batches ran,
    and its peak over ``base`` (the bytes allocated before its call, which
    the peak counts too) agrees with the skip rule's count, the step's
    peak on the meta device (``train_step_bytes``), within 2 % + 0.5 GiB
    (the libraries' workspaces, the allocator's rounding)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    rule = dryrun.train_step_bytes(get_config(r["arch"]),
                                   dryrun.INPUT_SHAPES["train_4k"])
    state = dryrun.TRAIN_BYTES_PER_PARAM * r["params_total"]
    own = r["peak_memory_gb"] * 2**30 - base
    if r["global_batch"] != dryrun.MICROBATCHES[r["arch"]] or \
            abs(own - rule) > 0.02 * rule + 2**29:
        fail(f"dry run row {r['arch']} train_4k ran {r['global_batch']} "
             f"micro-batches (not {dryrun.MICROBATCHES[r['arch']]}), or its "
             f"peak {own / 2**30:.2f} GiB over what its call found "
             f"allocated disagrees with the skip rule's "
             f"{rule / 2**30:.2f} GiB")
    print(f"  {r['arch']} train_4k: {r['global_batch']} micro-batches of "
          f"one sequence; peak {own / 2**30:.2f} GiB over the "
          f"{base / 2**30:.2f} GiB its call found allocated, the skip "
          f"rule's count on the meta device {rule / 2**30:.2f} GiB (of "
          f"which {state / 2**30:.2f} GiB of masters, gradients and "
          f"moments: {dryrun.TRAIN_BYTES_PER_PARAM} B a parameter)")


def dry_run(dev):
    """Phase 48: ``repro_torch.launch.dryrun.main`` on the card over
    ``DRYRUN_CALLS`` (``DRYRUN_ROWS`` rows), each kernel's launches set to
    0 before a call and held to the rows' layers (a training row's per
    micro-batch) after it; one line a row, its roofline share within
    ``ROOFLINE_SHARE_MAX``; a training row's micro-batches and memory
    (``train_row_memory``); each kernel, and the flash and SSD backward
    kernels, held to its plain version at every shape the rows launched it
    at (``MainPathShapes``); the counts of
    ``DRYRUN_SAME`` equal on the card and the CPU.  Returns the artifact's
    path and the launches ({name: (forward, backward)})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.serving.pool import DEFAULT_POOL
    t0 = time.perf_counter()
    mods = llm_kernel_ops()
    out_dir = ROOT / "chiprun_out" / f"dryrun-{time.strftime('%H%M%S')}"
    steps = 1 + DRYRUN_REPS   # the warm-up, which is counted, and timed
    total = {k: (0, 0) for k in mods}
    rows, bases = [], []
    shapes_seen = MainPathShapes(mods, trained=("flash_attention",
                                                "ssd_scan", "rglru_scan"))
    for label, archs, shapes in DRYRUN_CALLS:
        archs = archs or DEFAULT_POOL
        for m in mods.values():
            m.launches = 0
            if hasattr(m, "backward_launches"):
                m.backward_launches = 0
        t1 = time.perf_counter()
        base = torch.cuda.memory_allocated()
        with shapes_seen:
            rc = dryrun.main(["--arch", *archs, "--shape", *shapes, "--reps",
                              str(DRYRUN_REPS), "--out", str(out_dir)])
        got = {k: (m.launches, getattr(m, "backward_launches", 0))
               for k, m in mods.items()}
        lines = (out_dir / "dryrun.jsonl").read_text().splitlines()
        new = [json.loads(x) for x in lines[len(rows):]]
        rows += new
        bases += [base] * len(new)
        want = {k: (0, 0) for k in mods}
        for r in new:
            if r["status"] != "ok":
                continue
            fwd, bwd = dryrun_launches(get_config(r["arch"]),
                                       dryrun.INPUT_SHAPES[r["shape"]].kind,
                                       steps, r["global_batch"])
            want = {k: (want[k][0] + fwd[k], want[k][1] + bwd.get(k, 0))
                    for k in want}
        print(f"dry run ({label}): rc {rc}, {len(new)} rows in "
              f"{time.perf_counter() - t1:.1f} s; launches (forward, "
              f"backward) {got}")
        if rc != 0 or got != want:
            fail(f"dry run ({label}): rc {rc}; launches {got}, expected "
                 f"{want}")
        total = {k: (total[k][0] + got[k][0], total[k][1] + got[k][1])
                 for k in total}
    card = torch.cuda.get_device_name(0)
    for r, base in zip(rows, bases):
        if r["status"] != "ok":
            print(f"  {r['arch']} {r['shape']}: {r['status']} ({r['reason']})")
            continue
        share = r["t_step_s"] / r["measured_step_s"]
        peak = ("not measured" if r["peak_memory_gb"] is None
                else f"{r['peak_memory_gb']:.2f} GiB")
        print(f"  {r['arch']} {r['shape']} on {r['device']}: batch "
              f"{r['global_batch']}; counted {r['flops_per_chip']:.4e} ops, "
              f"{r['bytes_per_chip']:.4e} B; compute {r['t_compute_s']:.6f} "
              f"s, memory {r['t_memory_s']:.6f} s, collective "
              f"{r['t_collective_s']} s ({r['bottleneck']}); t_step "
              f"{r['t_step_s']:.6f} s, measured {r['measured_step_s']:.6f} "
              f"s: roofline share {share:.1%}; peak {peak}; energy "
              f"{r['energy_j']:.4f} J; useful flops "
              f"{r['useful_flops_ratio']:.3f}")
        if not (r["mesh"] == "1x1" and r["chips"] == 1 and card in
                r["device"] and r["measured_step_s"] > 0 and 0 < share):
            fail(f"dry run row {r['arch']} {r['shape']} is malformed: {r}")
        if share > ROOFLINE_SHARE_MAX:
            fail(f"dry run row {r['arch']} {r['shape']}: t_step "
                 f"{r['t_step_s']} s over the measured "
                 f"{r['measured_step_s']} s ({share:.1%}): the counts are "
                 f"too large (its largest kinds are printed above)")
        if r["shape"] == "train_4k":
            train_row_memory(r, base)
    status = {(r["arch"], r["shape"]): r["status"] for r in rows}
    if len(rows) != DRYRUN_ROWS or status.pop(
            ("llama3-8b", "long_500k")) != "skip" \
            or set(status.values()) != {"ok"}:
        fail(f"dry run: rows {status}")
    print(f"dry run: each kernel at the {len(shapes_seen.seen)} (shape, "
          f"options) its rows launched it at, on seeded inputs, against "
          f"its plain version:")
    shapes_seen.check(dev)
    dryrun_counts_on_both(dev)
    device_memory("cuda")
    phase("48 the dry run on the card", t0)
    return out_dir / "dryrun.jsonl", total


def serve_on_dryrun(artifact, synthetic, device="cuda", extra=()):
    """Phase 31's run (i), after phase 48: the serve driver routing on the
    card's own rows (``--dryrun-mesh 1x1``) on ``device`` (``extra``: more
    flags, e.g. ``--reduced`` for a rehearsal on the CPU), its routes
    equal to the CPU policy's over the same rows and printed beside run
    (a)'s on the analytic profile (``synthetic``: its decisions).  Returns
    its launches."""
    from repro_torch.core.policy import PoolPolicy, RouteRequest
    from repro_torch.serving.pool import (DEFAULT_POOL, ServingPool,
                                          pool_table_from_dryrun)
    t0 = time.perf_counter()
    argv = ["--requests", "24", "--delta", "5"]
    run = serve_run("i", argv, device, ["--dryrun-artifact", str(artifact),
                                        "--dryrun-mesh", "1x1", *extra],
                    artifact.parent)
    if run.lines[0] != f"pool profile from {artifact}: 5 backends":
        fail(f"run (i)'s first line: {run.lines[0]}")
    cpu = PoolPolicy(ServingPool(pool_table_from_dryrun(
        str(artifact), mesh="1x1", device="cpu"), delta=5.0))
    want = [(d.backend, d.group) for d in cpu.decide_batch(
        [RouteRequest(uid=i, complexity=n)
         for i, (n, _, _) in enumerate(run.decisions)])]
    got = [(arch, bucket) for _, arch, bucket in run.decisions]
    if len(got) != 24 or got != want:
        fail(f"run (i): routes differ from the policy's on the CPU: {got} "
             f"/ {want}")
    if served_uids(run.lines) != list(range(24)):
        fail(f"run (i) served uids {served_uids(run.lines)}")
    print("run (i) on the card's rows beside run (a) on the analytic "
          "profile (prompt length: (i) / (a)):\n  " + "\n  ".join(
              f"{n}: {arch}@{b} / {a_arch}@{a_b}" for (n, arch, b),
              (_, a_arch, a_b) in zip(run.decisions, synthetic)))
    served = {a for a, *_ in run.batches}
    if not served <= set(DEFAULT_POOL):
        fail(f"run (i) served {served}")
    phase("31 (i) the serve driver on the dry run's rows", t0)
    return run.launches


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.canny_fused import ops as canny_ops
    from repro_torch.kernels.canny_fused import ref as canny_ref
    from repro_torch.kernels.sobel import ops as sobel_ops
    from repro_torch.kernels.sobel import ref as sobel_ref

    # 1 -------------------------------------------------------------- card
    t0 = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase("1 card", t0)

    # 2 ------------------------------------------------------------- build
    t0 = time.perf_counter()
    seconds = _build.build()
    for name, s in seconds.items():
        log = (_build.BUILD_DIR / f"lib{name}.log").read_text()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built lib{name}.so in {s:.1f} s: {' | '.join(usage)}")
    phase("2 build", t0)
    dev = torch.device("cuda")

    # 3 ----------------------------------------------- Canny kernel vs plain
    t0 = time.perf_counter()
    shapes = [(1, 32, 32), (3, 64, 64), (1, 96, 64), (2, 40, 56),
              (1, 37, 41), (1, 64, 200), (2, 80, 600), (1, 48, 31),
              (1, 48, 65), (1, 48, 63), (1, 48, 64), (1, 65, 64),
              (1, 64, 65), (2, 130, 129),
              (1, 24, 4224), (32, 64, 64), (64, 64, 64), (250, 64, 64),
              (256, 64, 64), (300, 64, 64), (8, 1080, 1920),
              (1, 2160, 3840)]
    for shape in shapes:
        x = torch.from_numpy(rand(shape, sum(shape))).to(dev)
        for lo, hi in ((0.6, 1.0), (0.2, 0.5)):
            got = canny_ops.canny_edge(x, lo, hi)
            want = canny_ref.canny_edge(x, lo, hi)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            if bad:
                fail(f"canny kernel differs from its plain version at "
                     f"{shape} lo={lo} hi={hi}: {bad} pixels")
    print(f"canny: kernel == plain version on {len(shapes)} shapes x 2 "
          f"thresholds (tolerance: exact equality)")
    frames = [rand((1080, 1920), 1), rand((720, 1280), 2), rand((64, 64), 3),
              rand((1080, 1920), 4), rand((37, 50), 5), rand((64, 100), 6)]
    got = canny_ops.canny_edge_batch(frames)
    for f, g in zip(frames, got):
        want = canny_ref.canny_edge(torch.from_numpy(f)[None].to(dev))[0]
        if g.shape != f.shape or not np.array_equal(g, want.cpu().numpy()):
            fail(f"ragged canny_edge_batch differs at frame {f.shape}")
    print("canny: ragged 1080p/720p/64x64/37x50/64x100 batch == plain "
          "version per frame")
    phase("3 canny kernel", t0)

    # 4 ----------------------------------------------- Sobel kernel vs plain
    t0 = time.perf_counter()
    sobel_err = 0.0
    for shape in SOBEL_SHAPES:
        x = torch.from_numpy(rand(shape, 7)).to(dev)
        m1, d1 = sobel_ops.sobel_grad(x)
        m2, d2 = sobel_ref.sobel_grad(x)
        err = float((m1 - m2).abs().max())
        unequal = int((d1 != d2).sum())
        same = 1 - unequal / d1.numel()
        print(f"sobel {shape}: max |mag err| {err:.3g} (tolerance 1e-5), "
              f"directions equal {same:.6f} ({unequal} unequal; tolerance "
              f">= 0.999)")
        if err > 1e-5 or same < 0.999 or d1.dtype != torch.int32:
            fail(f"sobel kernel disagrees with its plain version at {shape}")
        sobel_err = max(sobel_err, err)
    phase("4 sobel kernel", t0)

    # 5 ------------------------------------------------ the gateway, on cuda
    from repro_torch.core.estimators import EdgeDetectionEstimator
    from repro_torch.core.gateway import Gateway
    from repro_torch.core.router import GreedyEstimateRouter
    from repro_torch.detection import scenes as sc
    from repro_torch.detection.detectors import DETECTOR_CONFIGS, init_detector
    from repro_torch.detection.devices import (drift_scenario,
                                               nominal_profile_table)

    models = ("ssd_v1", "ssd_lite", "yolov8_n", "yolov8_s")
    params = {m: init_detector(DETECTOR_CONFIGS[m], seed=i)
              for i, m in enumerate(models)}
    scenes = sc.drifting_dataset(256, seed=4)

    def episode(adapt, stream, device, delta=5.0, drifting="orin_nano"):
        table = nominal_profile_table(device=device)
        gw = Gateway(GreedyEstimateRouter(table, delta), table, params,
                     EdgeDetectionEstimator(device=device), adapt=adapt,
                     fleet=drift_scenario("thermal", drifting),
                     max_batch=32, device=device)
        return gw, gw.process_stream(stream)

    t0 = time.perf_counter()
    episode(True, scenes[:32], "cuda")        # warm-up: cuDNN, allocator
    main_launches = {"canny_fused": 0, "sobel": 0}
    main_canny = CannyLaunches(canny_ops)
    for adapt, name in ((True, "scanned closed loop"),
                        (False, "batched open loop")):
        canny_ops.launches = 0
        sobel_ops.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with main_canny:
            gw, stats = episode(adapt, scenes, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n_canny, n_sobel = canny_ops.launches, sobel_ops.launches
        main_launches["canny_fused"] += n_canny
        main_launches["sobel"] += n_sobel
        state_dev = gw.table.as_state().map_pct.device
        print(f"gateway {name}: {len(scenes)} scenes in {wall:.3f} s; "
              f"canny launches {n_canny}, sobel launches {n_sobel}; "
              f"profile state on {state_dev}")
        print(f"  {stats}")
        if n_canny < 1:
            fail(f"the {name} never launched the canny kernel")
        if state_dev.type != "cuda":
            fail(f"the {name}'s profile state is on {state_dev}")
        if sum(stats.pair_histogram.values()) != len(scenes):
            fail(f"the {name} served {stats.pair_histogram}")
        if not all(np.isfinite(v) for v in (
                stats.map_pct, stats.backend_energy_mwh,
                stats.backend_time_ms, stats.gateway_energy_mwh)):
            fail(f"the {name} produced non-finite stats: {stats}")
    # where the scanned episode's time goes, stage by stage (outside the
    # counted main-path runs)
    from repro_torch.core.closed_loop import measurements_from_fleet
    from repro_torch.detection.canny import _label_count
    from repro_torch.detection.train import run_detector
    images = np.stack([s.image for s in scenes])
    edges, t_canny = synced(lambda: canny_ops.canny_edge(images).cpu())
    counts, t_count = synced(lambda: [_label_count(e)
                                      for e in edges.numpy()])
    table = nominal_profile_table()
    arrays = table.as_arrays()
    meas = measurements_from_fleet(arrays.pairs, len(scenes),
                                   drift_scenario("thermal"))
    from repro_torch.core.closed_loop import scan_stream
    _, t_scan = synced(lambda: scan_stream(
        arrays.state, counts, meas, arrays=arrays, delta=5.0))
    _, t_det = synced(lambda: [run_detector(params["yolov8_n"],
                                            images[i:i + 32])
                               for i in range(0, len(images), 32)])
    print(f"breakdown of the scanned episode ({len(scenes)} scenes): canny "
          f"launch + copies {t_canny * 1e3:.2f} ms, host component count "
          f"{t_count * 1e3:.1f} ms, scan_stream {t_scan * 1e3:.1f} ms, "
          f"detector batches {t_det * 1e3:.1f} ms")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t_prof = synced(lambda: episode(True, scenes, "cuda"))
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profiler (scanned episode, {t_prof:.3f} s under the "
          f"profiler): device busy {busy_us / 1e3:.2f} ms = "
          f"{busy_us / 1e6 / t_prof:.2%} of the wall time, "
          f"{sum(e.count for e in kernels)} device ops; top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top))
    phase("5 gateway", t0)

    # 6 ------------------------------------ the same episode on cuda and cpu
    t0 = time.perf_counter()
    from repro_torch.core.policy import DetectionPolicy, RouteRequest
    short = scenes[:64]
    reqs = [RouteRequest(uid=i, payload=s.image, true_complexity=s.count)
            for i, s in enumerate(short)]
    # delta 10 with drift on the pair the router favours: traffic moves
    for delta, drifting in ((5.0, "orin_nano"), (10.0, "pi5_tpu")):
        traces, hists = {}, {}
        for device in ("cuda", "cpu"):
            table = nominal_profile_table(device=device)
            policy = DetectionPolicy(
                GreedyEstimateRouter(table, delta), table,
                EdgeDetectionEstimator(device=device), adapt=True)
            meas = measurements_from_fleet(table.as_arrays().pairs,
                                           len(reqs),
                                           drift_scenario("thermal", drifting))
            traces[device] = [(d.pair, d.est_complexity)
                              for d in policy.decide_scan(reqs, meas)]
            hists[device] = episode(True, short, device, delta,
                                    drifting)[1].pair_histogram
        if traces["cuda"] != traces["cpu"] or hists["cuda"] != hists["cpu"]:
            fail(f"delta={delta}: the scanned episode differs between cuda "
                 f"and cpu: {hists}")
        print(f"delta={delta}: cuda == cpu over {len(reqs)} decisions; "
              f"pairs {hists['cuda']}")
    phase("6 cuda vs cpu", t0)

    # 7 ------------------------------------------------------------ timing
    t0 = time.perf_counter()
    for shape in [(256, 64, 64), (32, 64, 64), (8, 1080, 1920),
                  (1, 2160, 3840)]:
        x = torch.from_numpy(rand(shape, 11)).to(dev)
        n_px = x.numel()
        k = median_ms(lambda: canny_ops.canny_edge(x))
        p = median_ms(lambda: canny_ref.canny_edge(x))
        b, by = bound_ms(n_px, 5, CANNY_OPS_PER_PX)
        dk = device_ms(lambda: canny_ops.canny_edge(x), "canny_kernel")
        print(f"time canny {shape}: kernel {k:.4f} ms (device time "
              f"{dk} ms), plain {p:.4f} ms, bound {b:.4f} ms ({by})")
        ks = median_ms(lambda: sobel_ops.sobel_grad(x))
        ps = median_ms(lambda: sobel_ref.sobel_grad(x))
        bs, bys = bound_ms(n_px, 12, SOBEL_OPS_PER_PX)
        ds = device_ms(lambda: sobel_ops.sobel_grad(x), "sobel_kernel")
        share = f"{bs / ds:.1%}" if ds else "not measured"
        print(f"time sobel {shape}: kernel {ks:.4f} ms (device time "
              f"{ds} ms), plain {ps:.4f} ms, bound {bs:.4f} ms ({bys}), "
              f"{share} of the bound")
        if shape == (256, 64, 64):   # the gateway's batch on the main path
            x_main = x
            rows = {"canny": (k, p, b, by), "sobel": (ks, ps, bs, bys)}
    canny_err = int((canny_ops.canny_edge(x_main)
                     != canny_ref.canny_edge(x_main)).sum())
    m1, _ = sobel_ops.sobel_grad(x_main)
    m2, _ = sobel_ref.sobel_grad(x_main)
    sobel_err = max(sobel_err, float((m1 - m2).abs().max()))
    if canny_err or sobel_err > 1e-5:
        fail(f"kernels disagree at the main path's shape: canny {canny_err} "
             f"pixels, sobel {sobel_err}")
    phase("7 timing", t0)

    attention_grids(dev)
    # phases 10, 14 and 18 at half depth, for the time of phases 33-35:
    # their models serve at full depth in phases 30 and 31
    llm_launches, backends = llm_service(LLM_ARCHS, 10.0, ROUTES,
                                         "10 LLM service", halved=True)
    llm_profile(backends, ROUTES)
    decode_splits_ab(backends)
    del backends
    torch.cuda.empty_cache()
    llm_cuda_vs_cpu("llama3-8b", 64, "11 LLM cuda vs cpu")
    attn_rows = attention_timing(dev)

    ssd_err = ssd_check(dev)
    # qwen2.5-3b is profiled after phase 10 and the SSD kernel timed alone
    # in phase 16
    ssm_launches, backends = llm_service(SSM_ARCHS, SSM_DELTA, SSM_ROUTES,
                                         "14 LLM service with mamba2",
                                         halved=True)
    del backends
    torch.cuda.empty_cache()
    llm_cuda_vs_cpu("mamba2-370m", 500, "15 mamba2 cuda vs cpu")
    ssd_row = ssd_timing(dev)

    lru_err = lru_check(dev)
    hybrid_launches, backends = llm_service(
        HYBRID_ARCHS, 10.0, HYBRID_ROUTES,
        "18 LLM service with recurrentgemma-2b", halved=True)
    # qwen2.5-3b's 8 x 256 batch was profiled after phase 10 (each profile
    # costs ~20-30 s of analysis)
    llm_profile(backends, {1024: "recurrentgemma-2b"})
    del backends
    torch.cuda.empty_cache()
    llm_cuda_vs_cpu("recurrentgemma-2b", 1024,
                    "19 recurrentgemma-2b cuda vs cpu", num_layers=5)
    lru_row = lru_timing(dev)

    with main_canny:
        main_launches["canny_fused"] += routing_comparison(
            params, scenes, dev, canny_ops)
        deadline_flushing(params, scenes, dev)
        fault_storm(params, dev)
        main_launches["canny_fused"] += cluster_plane(params, scenes, dev,
                                                      canny_ops)
        main_launches["canny_fused"] += traffic_plane(params, dev, canny_ops)
        launches, testbed = paper_comparison(dev, canny_ops)
        main_launches["canny_fused"] += launches

    # 27 ------------------------- Canny at the main path's shapes vs plain
    t0 = time.perf_counter()
    main_canny.check(canny_ref)
    phase("27 canny at the main path's launch shapes", t0)

    # 28-30 ------------------------------- the MoE family, the default pool
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.pool import DEFAULT_POOL
    llm_cuda_vs_cpu(GRANITE, 256, f"28 {GRANITE} cuda vs cpu")
    moe_layer_check(dev)
    pool_launches, backends = llm_service(
        DEFAULT_POOL, POOL_DELTA, POOL_ROUTES,
        "30 the completed default pool", build_all=True)
    llm_profile(backends, {256: GRANITE}, ranges={
        "moe layer": (model_mod, "apply_moe"),
        "moe routing": (moe_mod, "route_topk"),
        "moe experts, every": (moe_mod, "_experts_all"),
        "moe experts, sorted": (moe_mod, "_experts_sorted")})
    decode_syncs(backends[GRANITE], 256)
    moe_form_ab(backends[GRANITE], 256)
    del backends
    torch.cuda.empty_cache()

    # 31-32 ------------------------------- the serve driver, the examples
    driver_launches, synthetic_routes = serve_driver()
    main_launches["canny_fused"] += examples_on_card(testbed, canny_ops,
                                                     canny_ref)

    # 33-35 ---------------------------------- the rest of the dense family
    llm_cuda_vs_cpu("gemma2-9b", 256, "33 gemma2-9b cuda vs cpu", new=9)
    llm_cuda_vs_cpu("deepseek-7b", 256, "33 deepseek-7b cuda vs cpu", new=9)
    ring_on_card(dev)
    dense_launches = dense_service()

    # 36-40 ---------------------------- MLA and the vlm family, full depth
    llm_cuda_vs_cpu(DSV2, 256, f"36 {DSV2} cuda vs cpu", new=9)
    moe_forms(dev)
    mla_launches, backends, start = served_phase(
        MLA_ARCHS, MLA_DELTA, MLA_ROUTES, f"38 {DSV2} beside llama3-8b",
        MLA_BATCHES, {arch: 1024 + MAX_NEW for arch in MLA_ARCHS})
    decode_syncs(backends[DSV2], 1024)
    moe_form_ab(backends[DSV2], 1024)
    del backends
    released("phase 38", start)
    llm_cuda_vs_cpu(LLAVA, 32, f"39 {LLAVA} cuda vs cpu", new=5, batch=1)
    vlm_launches, backends, start = served_phase(
        VLM_ARCHS, VLM_DELTA, VLM_ROUTES, f"40 {LLAVA} beside mamba2-370m",
        VLM_BATCHES, {LLAVA: VLM_MAX_SEQ})
    del backends
    released("phase 40", start)

    # 41-42 ------------------------------------ the encdec family, whisper
    llm_cuda_vs_cpu(WHISPER, 32, f"41 {WHISPER} cuda vs cpu", num_layers=4,
                    new=9, tol=1e-4)
    encdec_launches = encdec_service()
    served_launches = {k: sum(run[k] for run in (
        llm_launches, ssm_launches, hybrid_launches, pool_launches,
        driver_launches, dense_launches, mla_launches, vlm_launches,
        encdec_launches))
        for k in llm_launches}

    # 43-45 ----------------------------------------------- LM training
    bwd_row = flash_backward(dev)
    train_step_cuda_vs_cpu("qwen2.5-3b", 2, "44 qwen2.5-3b train step cuda "
                           "vs cpu")
    train_step_cuda_vs_cpu(WHISPER, 4, f"44 {WHISPER} train step cuda vs "
                           "cpu")
    train_step_cuda_vs_cpu("mamba2-370m", 2, "44 mamba2-370m train step "
                           "cuda vs cpu", seq=288)
    train_step_cuda_vs_cpu("recurrentgemma-2b", 2, "44 recurrentgemma-2b "
                           "train step cuda vs cpu")
    for arch, extra in ((GRANITE, {}), (DSV2, {}),
                        (LLAVA, {"prefix": LLAVA_TRAIN_PREFIX})):
        train_step_cuda_vs_cpu(arch, 2, f"44 {arch} train step cuda vs cpu",
                               **extra)
    moe_bf16_train_step(dev)
    train_step_cuda_vs_cpu("qwen2.5-3b", 2, "44 qwen2.5-3b two micro-batches "
                           "cuda vs cpu", batch=4, microbatches=2)
    fwd_launches, bwd_launches = train_lm_full(dev)
    served_launches["flash_attention"] += fwd_launches

    # 46-47 ------------------------- the state-space families' training
    scan_rows = scan_backward(dev)
    scan_launches = train_scans_full(dev)
    trained_bwd = {"flash_attention": bwd_launches}
    for k, (f, b) in scan_launches.items():
        served_launches[k] += f
        trained_bwd[k] = trained_bwd.get(k, 0) + b

    # 48 -------------------------------------- the dry run on the card
    artifact, dry_launches = dry_run(dev)
    for k, (f, b) in dry_launches.items():
        served_launches[k] += f
        if b:
            trained_bwd[k] = trained_bwd.get(k, 0) + b
    for k, n in serve_on_dryrun(artifact, synthetic_routes).items():
        served_launches[k] += n

    # 49 ------------------------------ the MoE family's training, full
    moe_fwd, moe_bwd = train_moe_full(dev)
    served_launches["flash_attention"] += moe_fwd
    trained_bwd["flash_attention"] += moe_bwd

    # 50 ----------------------- the production mesh of the dense family
    for k, (f, b) in mesh_phase(dev).items():
        served_launches[k] += f
        if b:
            trained_bwd[k] = trained_bwd.get(k, 0) + b

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        fail(f"imported the JAX package or JAX: {leaked}")
    kernels = [
        {"name": "canny_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/canny_fused.cu",
         "replaces": "src/repro/kernels/canny_fused/canny_fused.py:271",
         "launches": main_launches["canny_fused"],
         "max_abs_err": canny_err, "ms": rows["canny"][0],
         "plain_ms": rows["canny"][1], "bound_ms": rows["canny"][2],
         "bound_by": rows["canny"][3], "library_ms": None},
        {"name": "sobel", "route": "cuda",
         "source": "src/repro_torch/csrc/sobel.cu",
         "replaces": "src/repro/kernels/sobel/sobel.py:43",
         "launches": main_launches["sobel"],
         "max_abs_err": sobel_err, "ms": rows["sobel"][0],
         "plain_ms": rows["sobel"][1], "bound_ms": rows["sobel"][2],
         "bound_by": rows["sobel"][3], "library_ms": None},
    ]
    for name, line in (("flash_attention", 102), ("decode_attention", 92)):
        kern, plain, bnd, by, lib, err = attn_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}/{name}.py:{line}",
            "launches": served_launches[name], "max_abs_err": err, "ms": kern,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib})
    kern, plain, bnd, by, lib, err = bwd_row
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:102",
        "launches": trained_bwd["flash_attention"], "max_abs_err": err,
        "ms": kern, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib})
    kern, plain, bnd, by = ssd_row
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:78",
        "launches": served_launches["ssd_scan"], "max_abs_err": ssd_err,
        "ms": kern, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None})
    kern, plain, bnd, by = lru_row
    kernels.append({
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:44",
        "launches": served_launches["rglru_scan"], "max_abs_err": lru_err,
        "ms": kern, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None})
    for name, source, line in (
            ("ssd_scan", "ssd_scan_bwd.cu", "ssd_scan/ssd_scan.py:78"),
            ("rglru_scan", "rglru_scan.cu", "rglru_scan/rglru_scan.py:44")):
        kern, plain, bnd, by, err = scan_rows[f"{name}_bwd"]
        kernels.append({
            "name": f"{name}_bwd", "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": trained_bwd[name], "max_abs_err": err, "ms": kern,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
    print(f"all phases: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rows"]:
        mesh_rows_child(int(sys.argv[2]), Path(sys.argv[3]))
    main()
