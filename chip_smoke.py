#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

It fails (non-zero exit, no result line) when no CUDA device is visible or
the package is missing. Phases, each fatal on failure:

1. device and build: the card's name and power limit; the kernels built
   from ``src/repro_torch/kernels/csrc`` (build seconds, then every kernel
   instance's registers and spill bytes from ptxas, one JSON line each;
   a decode kernel instance or a tensor-core instance of the flash
   backward that spills fails); the time of an empty
   kernel launch, the floor under every latency-bound kernel;
2. every kernel against its plain version on the card at the main path's
   shapes, bf16 and fp32 (RMSNorm in its three forms: plain at the
   llama3.2-3b and mamba2-780m widths, the residual form at llama's and
   the gated form at mamba's gate width, at 8 and 512 rows, the residual
   sum equal to the eager add; fp32: rmsnorm 1e-5, attention and decode
   stats 1e-4 for the other summation order; bf16 outputs 2e-2 against the plain
   version in bf16, one bf16 ulp at 4 being 1.6e-2, and atol 4e-3 plus
   rtol 8e-3, a few bf16 ulps of |out|, against the plain version in fp32
   on the same bf16 inputs, since the kernels compute in fp32; the SSD
   scan's fp32 outputs max |y - y_ref| / max |y_ref| < 1e-4 and max |h -
   h_ref| / max |h_ref| < 1e-4 at the mamba2-780m prefill shapes, S = 512, 300 and 2048,
   and one G = 2, N = 64 case; its bound is the bytes or the chunked
   form's split tensor-core multiply-adds, whichever is longer, the
   recurrence on the CUDA cores kept beside it), each timed with CUDA
   events on a cold L2 beside its plain version, a PyTorch library call where one computes the
   same function (timed here only; the port never calls it), and its
   bound (flash: bf16 runs the wgmma kernel, fp32 the CUDA-core one;
   SDPA timed beside each causal case, S = 137, 512 and 2048); decode
   scores and decode stats at llama3.2-3b's decode shape (B = 8, KV = 8,
   G = 3, D = 128, L = 1024, positions 64-576) and at (G, D) = (1, 64),
   (4, 120), (5, 128), (8, 128), (2, 256), their bounds counting only the
   K and V rows and the accumulation's scores of kept slots (masked scores held exactly NEG_INF, a fully
   masked row 0, two calls bitwise equal), and the decode-attention pair
   (scores, accumulate, o / l) beside one SDPA call on the same inputs
   with the position mask (the library yardstick, timed here only); both
   decode kernels on each of the 4 shards of a 32,768-slot llama3.2-3b
   cache (B = 1, 8,192 slots a shard, bf16) at positions 3,000, 11,000 and
   20,000, so that a shard keeps all its slots, part of them or none,
   with no mask, a window and a chunk, against their plain versions (a
   shard with no slot kept exactly m = NEG_INF, o = 0, l = 0; the unmasked
   cases timed with their bounds); and the kernels at phase 7's per-rank
   shapes: both decode kernels on B = 2 rows (bf16 and fp32) and 1 row
   (fp32) of a 2,048-slot llama3.2-3b cache at positions of phase 7's
   trace, and RMSNorm, plain and residual, 3,072 wide, on 1 and 2 rows and
   on the trace's shortest and longest prefills (135 and 1,459 rows), in
   bf16 and fp32, at the tolerances above, timed with their bounds; and
   the decode pair at phase 9's model-rank shapes (llama3.2-3b's 8 KV
   heads over 2: KV = 4, G = 3, D = 128, bf16): B = 2 rows of a
   2,048-slot cache at positions of phase 7's trace and a B = 1 shard of
   8,192 slots of a 32,768-slot cache at each shard's offset, at
   positions 3,000 and 11,000, each kernel against its plain version and
   timed with its bound, the pair beside one SDPA call masked to the kept
   slots; the decode pair on a ring shard at phase 9v's model-rank shapes
   (gemma2-9b's KV = 4, G = 2, D = 256, cap 50 and h2o-danube-3-4b's KV =
   4, G = 4, D = 120, bf16): a B = 1 shard of 1,024 slots of a 4,096-slot
   ring at each of the 4 offsets, at positions 2,000, 4,090 and 4,100 (a
   shard keeps none, part or all of its slots), and B = 2 rows over a
   whole ring past its wrap, each kernel against its plain version and
   timed with its bound, the pair beside SDPA with a boolean mask where
   there is no cap; and the serving kernels at qwen2-moe-a2.7b's shapes
   (phase 4m, ``moe_kernel_cases``: RMSNorm plain and residual 2,048 wide at 8 and
   512 rows beside ``F.rms_norm``, flash at S = 137 and 512 with 16 q and
   16 KV heads of 128 beside SDPA, the decode pair at 8 rows of 1,024
   slots, KV = 16, G = 1, beside SDPA; bf16, the tolerances above), and
   at a model rank's 8/8 heads of phase 9e (flash at S = 512, the decode
   kernels on 2 rows of an 8,192-slot cache, the pair on 8 rows);
2b. the DMA allgather on the card: each of bruck, ring, multilane and
   locality_bruck on three cases (the FSDP parameter gather of one
   llama3.2-3b decoder layer over 16 = 4 x 4 ranks and over 12 = 3 x 4
   ranks in bf16, and the paper's small-message regime, 64 = 8 x 8 ranks of
   1 KiB fp32 shards), the p ranks as p slices of one allocation; each equal
   (torch.equal) to its plain version and to the shards broadcast, timed
   beside the plain version, the library call that computes the same
   function (``x.unsqueeze(0).expand(p, ...).contiguous()``, timed here
   only) and its bound, its launches per gather (1: one cooperative
   kernel runs every round), spill slots and the peak device memory one
   gather adds; then the slice's main path, one ``dma_locality_allgather``
   at the 16-rank FSDP size, with its launch count (1);
2c. the training path's kernels against their plain versions: the flash
   forward with lse (o and lse against the plain forward) and the flash
   backward (dq, dk, dv; fp32 within 1e-4 of the plain backward, bf16
   within atol 1e-3 plus rtol 1e-2 of the plain backward in fp32 on the
   same bf16 inputs, the gradients' mean sizes printed beside) at 8a's
   shape (B = 4, S = 1,024, 24/8 heads of 128; causal, window and chunk,
   bf16 and fp32), at one rank's of 8c (B = 1, causal, bf16), of 8e and
   of 10b (B = 1, 16/16 heads; the RMSNorm backward 2,048 wide) and at the
   tensor-core pair's tile edges (``FLASH_BWD_EDGES``: S = 63, 65, 129,
   G = 1, 2, 3, 8, D = 32, 64, 128, 256, window, chunk and cap; gemma2's
   heads at B = 1, whose dk/dv splits over a cluster), at 8v's
   (``VARIANT_FLASH_BWD``: h2o-danube's step, 32/8 heads of 120, and at
   6,000 tokens where its 4,096 window bites; gemma2's, 16/8 heads of 256
   with cap 50; cap 50 at 8a's shape; fp32 at D = 120 with window and
   cap; with a cap there is no library, and SDPA's uncapped backward is
   printed as a yardstick), at a model rank's of 8ev
   (``TIER_VARIANT_FLASH_BWD``: gemma2's 8/4 heads of 256 with cap 50 and
   uncapped, h2o-danube's 16/4 of 120; B = 1, the forward with lse too),
   at a model rank's of 10c (qwen2-moe-a2.7b's 8/8 heads of 128 over
   1,024 tokens, ``MOE_TIER_RANK_FLASH``),
   each naming the instance that served it by its
   launch counter (bf16 the tensor cores at every D, fp32 the CUDA cores)
   and failing on another; and the
   RMSNorm backward, plain and residual (dx and dscale), on 8a's 4,096 rows
   (bf16, fp32) and 8c's 1,024 (bf16), 3,072 wide, one launch a call; each
   two calls bitwise equal, timed beside its plain version, the library's
   backward (SDPA's with the mask as a boolean ``attn_mask`` where it is
   not causal alone, ``F.rms_norm``'s; timed here only; and SDPA's forward
   beside the flash forward at the training shapes) and its bound; the
   times before the redesign are printed on lines of their own, quoted
   from PERF.md (``QUOTED_PR19_MS``, and ``QUOTED_D256_CUDA_CORES_MS`` for
   gemma2's D = 256 pair on the CUDA cores; not measured in the run);
   and mamba2-780m's: the SSD backward at 8d's shape (B = 4, S = 1,024, 48
   heads of P = 64, N = 128, G = 1; bf16 and fp32), at G = 2, N = 64 and
   at S = 1,000 (bf16), timed, and at the card tests' shapes
   (``ssd.checks.BWD_CASES``, bf16 and fp32, untimed), as the training
   path calls it (the backward recomputes the states before the chunks),
   each gradient's max |err| / max |ref| against the plain backward in
   fp32 on the same inputs within ``ssd.checks.BWD_REL`` (bf16 dx, dB, dC
   within ``BWD_BF16_REL``), two calls bitwise equal, ``BWD_KERNELS``
   launches a call; the times before its redesign printed on lines of
   their own, quoted from PERF.md (``QUOTED_SSD_BWD_MS``); the SSD
   forward alone at 8d's shape (bf16, fp32), timed beside its bound and
   plain version; and the gated RMSNorm backward over 8d's 4,096 rows of
   3,072, z a column slice of in_proj's 6,448 (bf16, fp32; dy and fp32 dz
   1e-5, dscale 1e-4, bf16 2e-2), beside ``F.rms_norm``'s backward on the
   gated product alone as a partial yardstick (no PyTorch call computes
   either function: their library time is null); and the Mamba2 mixer at
   one model rank's shapes (``tier_gated_cases``, ``SSM_TIER_SSD``): the
   gated RMSNorm split over a tier of 2 (bf16, fp32) and 4 (bf16) on 1,024
   rows of the rank's 1,536 or 768 columns, forward (the rows' partial
   sums of squares, then the finish) and backward (the rows' partial dot
   products, then the finish), the tier's sums emulated over every rank's
   columns, against the unsplit plain forward and backward at the
   tolerances of the unsplit cases, each launch against its plain version,
   timed beside the plain versions and ``F.rms_norm`` on the gated product
   alone; the SSD forward and backward at 24 and 12 heads of one group
   (one sequence of 1,024, bf16) against their plain versions;
3. a reduced llama3.2-3b (fp32, 4 layers) and a reduced mamba2-780m
   (fp32, 3 layers), each with the same parameters on the CPU (plain
   versions) and on the card (kernels): logits after prefill and 8 decode
   steps within 1e-3, equal greedy tokens, equal engine tokens (the card's
   engine replaying its decode graph);
4. llama3.2-3b at full width (28 layers, d_model 3072, vocab 128256) with
   random bf16 weights from seed 0: an Engine(batch=8, cache_len=1024)
   drains 16 requests (64-512 prompt tokens, 16-64 new), each decode step
   one replay of the decode forward captured in a CUDA graph; every
   kernel's launch count must be what the path implies, a replay counting
   the launches its capture recorded (rmsnorm 57 per forward: 29 plain and
   28 residual, the add before each ln2 fused into it; flash 28 per
   prefill, decode scores and decode stats 28 each per decode step, ssd 0)
   and every step's logits finite; each step's host time and the device
   span of its replay (CUDA events recorded around it, no profiler), and
   the share of the steps' host time outside those spans, the device's
   idle share (an upper bound on its busy time, so a lower bound on idle);
   then torch.profiler over two 512-token
   prefills, over 5 decode steps (graph replays) with 8 live rows and over
   5 eager decode forwards on a copy of that cache (device busy time, idle
   share, the kernels that take the time);
5. the same for mamba2-780m at full width (48 layers, d_model 1536, 48 SSD
   heads of P = 64, N = 128, vocab 50280): rmsnorm 97 per forward (49
   plain, 48 gated: the mixer's gate fused into its norm), ssd 48
   per prefill, flash and the decode kernels 0;
4m. the same for qwen2-moe-a2.7b at full width and depth (24 layers,
   d_model 2,048, 16/16 heads, 64 routed experts of 1,408 at top-4 and 4
   shared, an untied 151,936-row head; 15.1 B parameters, ~30.3 GB of
   bf16 weights drawn on the card from seed 0): rmsnorm 49 per forward
   (25 plain, 24 residual), flash 24 per prefill, the decode kernels 24
   each per step, the MoE's own work plain torch inside the graph; then
   ``moe_decode_checks``: the 16 requests again with the scheduler's graph
   set aside, every token equal to the replayed run's, and the bytes a
   decode step must read (at S = 1 each row has K slots in every expert,
   so every expert's weights are read: 26.6 GB a step) at 3.35 TB/s
   beside the step's time;
4v. the dense variants at full width and depth, one line each through the
   same ``serve_full_width``: yi-6b (32 layers, kv 4, untied head) on the
   16 requests at ``cache_len`` 1,024; h2o-danube-3-4b (24 layers, every
   one a 4,096-token window, head dim 120) and gemma2-9b (42 layers,
   window and full layers alternating, softcaps 50 and 30, sandwich
   norms, GeGLU, scaled embeddings, head dim 256) at ``cache_len`` 8,192
   with the 16 requests and two long ones, a 6,000-token prompt whose
   prefill rolls the ring and a 4,000-token prompt with 200 new tokens
   whose decode crosses the wrap at slot 4,096 (``VARIANT_RUNS``); launch
   counts and RMSNorm forms as the path implies (a sandwich layer's two
   post-norms plain), flash at D = 120 and the ring decode pair counted
   apart (``VARIANT_KERNELS``); then ``graph_eager_checks``: 6 decode
   steps, a long request's crossing the ring's wrap, the replay's logits
   and cache bitwise the eager forward's on a copy. Before them the
   kernels at their shapes (``variant_kernel_cases``: flash at S = 512
   and 6,000, the decode pair over a wrapped 4,096-slot ring; SDPA beside
   them where it computes the same function, none with a softcap); after
   them ``variant_exact_check``: h2o-danube and gemma2 at full width, 2
   layers, fp32, a 4,090-token prompt decoded across the ring's wrap in
   the engine, its 12 logits within ``VARIANT_EXACT_TOL`` of a plain
   full-sequence forward with no ring and its tokens equal;
4l. llama4-scout-17b-a16e at full width (d_model 5,120, 40/8 heads of
   128, 16 routed experts at sigmoid top-1 and a shared expert of 8,192,
   vocabulary 202,048, untied head) cut to 8 of 48 layers, two iRoPE
   periods of three chunked-local layers (chunk 8,192, qk-norm, RoPE)
   and one global NoPE layer (~19.7 B parameters, bf16),
   ``serve_llama4``: batch 4, 16,384 slots (the chunked layers' rings
   8,192), four requests, a 9,000-token prompt whose prefill rolls the
   rings and three of 8,185-8,190 tokens whose decode crosses the chunk
   boundary, one CUDA graph a decode step; launch counts, RMSNorm forms
   (qk-norm's two plain norms a layer) and the chunked-ring decode
   instances as the path implies; the graph's tokens against eager
   decoding (``moe_decode_checks``); a profiled prefill and decode window.
   Before it, the kernels at its shapes (``llama4_kernel_cases``: flash
   with the chunk at S = 9,000 beside SDPA with the boolean mask; the
   decode pair on an 8,192-slot chunked ring before and after the
   boundary and on the first two 2,048-slot shards at position 8,300, one
   keeping part, one none, beside SDPA masked to the kept slots; RMSNorm
   at qk-norm's rows beside ``F.rms_norm``); after it
   ``llama4_exact_check``: the reduced fp32 llama4 (chunk 64, 10/2 heads
   of 128, a capacity factor that drops no token) served past the chunk
   boundary and past two chunks at prefill, its logits within
   ``VARIANT_EXACT_TOL`` of a plain full-sequence forward and its tokens
   equal;
6. sequence-parallel serving, ``serve_seq_parallel``: 6 spawned ranks on
   this one card, joined in one gloo group (``launch.serve.run_ranks``).
   First a reduced llama3.2-3b (2 layers, fp32, full width, a 6,144-slot
   cache) on 2 x 2 and 3 x 2 ranks, in the three layouts below: its 16
   greedy tokens a request must equal the one-rank engine's exactly. Then llama3.2-3b at
   full width (bf16, random weights from seed 0) with
   ``ServeSpec(batch=1, cache_len=32768)`` on 2 x 2 of the ranks, three
   requests of 3,000 and 11,000 prompt tokens and 4 new tokens,
   submitted together and served one at a time, in three layouts:
   "locality" and "xla" over ("pod", "data") (8,192 slots a rank) and
   "locality" over ("data",) (16,384). Every rank prefills the whole
   prompt and keeps its slots; each decode step runs eagerly, 28 combines.
   Against a one-rank engine (combine "none") on the same prompts: the
   prefill logits (expected bitwise equal) and each request's first
   decode logits within 5% of the largest |logit| (the bf16 reasoning at
   ``SEQ_LOGIT_REL``), every rank's tokens equal, the share of greedy
   tokens equal to the one-rank engine's, each rank's launches exactly
   what the path implies (decode scores and stats 28 each per step);
   prefill and decode-step host ms, the combine's host and exchange ms, the
   per-step non-local messages and bytes and staged bytes of each rank,
   and each process's peak memory. Times are of 4 ranks sharing one H100.
7. batch-sharded serving, ``serve_batch_sharded``: 6 spawned ranks again.
   First a reduced llama3.2-3b (2 layers, fp32, full width) serving the
   phase's 16 requests with ``ServeSpec(batch=B, cache_len=2048,
   page_len=16, migrate=alg)`` on 2 x 2 (B = 8) and 3 x 2 (B = 6, where
   2,048 slots do not divide over 6 ranks and the donor span narrows to
   ("data",)) for each of ``locality_bruck``, ``multilane`` and ``xla``:
   tokens exactly equal to a one-rank engine's of the same batch, and on
   2 x 2 the migrations ``BATCH_MIGRATIONS``, the count that the JAX
   engine and the port's scheduler give for the same trace at a reduced
   size in tests/test_torch_serve_batch.py. Then llama3.2-3b at full width
   (bf16, random weights from seed 0), B = 8 on 2 x 2, 2 rows a rank:
   16 requests of 128-1,536 prompt tokens and 16-32 new (seeded), all
   arriving at 0 and homed in pod 0, so pod 0's two ranks prefill every
   request, its rows fill locally and the rest migrate to pod 1 (the
   explicit donor move, then one ``cache_migrate`` per K and V slab);
   every rank decodes its 2 rows by graph replay. Against a one-rank
   engine (B = 8) on the same requests: each request's prefill logits
   bitwise equal, its first decode logits within 5% of the largest
   |logit| (``SEQ_LOGIT_REL``), every rank's results equal, the
   migrations ``BATCH_MIGRATIONS``, each rank's prefills (16 in pod 0, 0
   in pod 1) and launches exactly what the path implies, and per
   migration the collective's non-local messages on each rank equal to
   the schedule oracle's (``schedules.locality_bruck`` / ``multilane``,
   two slabs) or, for ``xla``, the recorder's own model of one library
   all-gather (the call the port's route makes, so on the card this holds
   only the number of gathers; the CPU test holds the model against the
   JAX HLO); reported: the share of greedy tokens equal to the one-rank
   engine's, prefill ms per request on the ranks that ran it, migration
   ms split into the donor move (on a rank of pod 1 it includes the wait
   for pod 0's prefill), the collective and the insert, decode step ms
   (the graph replay and a sync, host clock), bytes and non-local messages
   and bytes per migration of the collective and of the donor move,
   staged bytes and each process's peak memory.
8. FSDP training. 8a, ``train_one_rank``: llama3.2-3b at full width and
   depth (fp32 master weights from seed 0, bf16 compute) trains 3 steps of
   4 x 1,024 tokens (``SyntheticLM(seed=0)``, ``AdamW(lr=3e-4)``) through
   ``Trainer`` on one rank: finite losses and grad norms, every kernel's
   launches exactly what the path implies (per step with remat: flash
   forward 56, each backward kernel 28, all on the tensor cores, RMSNorm 57
   plain and 56 residual, its backward 57, 29 plain and 28 residual); step
   ms, tokens/s, peak memory and a profiled step, with the device ms of the
   flash backward, the flash forward and the RMSNorm backward in it.
   8b, ``train_parity``: a
   reduced fp32 llama3.2-3b (2 layers) from the same parameters and
   batches, 2 steps of 12 x 64: the card's one-rank step against the CPU's
   (plain versions), and 6 spawned gloo ranks on 2 x 2 and 3 x 2 (where
   every leaf shards over "data" only) with ``locality`` + FSDP, eager and
   with ``prefetch_depth=1``, and ``xla`` + FSDP against the card's one
   rank: losses and grad norms within 1e-5 relative, every parameter
   within 1e-4 and all but 1 in 10,000 within 1e-5 (the card's limit,
   ``PARITY_PARAM_ATOL``; the elements beyond 1e-5 printed with their
   gradient's size), the prefetch bitwise the eager step. 8c,
   ``train_fsdp``: llama3.2-3b at full width on 2 x 2 of those ranks
   sharing the card, depth cut to 1 layer (the gloo host transport; 4
   before the run grew past 1,000 s, 2 before phase 9v), one 1,024-token
   sequence a rank, 2
   steps of each variant:
   losses equal on every rank and between eager and prefetch, launches
   exact on every rank, and per step and rank the recorder's non-local
   messages and bytes of the parameter gathers and of the gradient
   reduce-scatters equal to the schedule oracle's (``locality_bruck`` and
   its transpose) times the gathers the path implies, or for ``xla`` the
   recorder's model of the library calls; step ms, gather, reduce-scatter
   and sync host ms, staged bytes and peak memory a process. 8b's mamba2
   part, ``train_parity_ssm``: the smoke config at 2 layers in fp32 on the
   same batches, the card's one rank against the CPU's and 2 x 2 of the
   ranks (locality + FSDP, eager and ``prefetch_depth=1``) against the
   card's one rank at the 8b limits, the prefetch bitwise the eager step,
   every rank's launches exact, and per step and rank the gathers' and
   reduce-scatters' non-local messages and bytes equal to the schedule
   oracle's for the Mamba2 leaves (in_proj and out_proj a layer, and the
   embedding). 8f, ``train_ssm_tp_on_ranks`` (after phase 9): mamba2-780m
   at full width split by SSD heads over a model tier, 8 spawned ranks as
   2 x 2 x 2 sharing the card, depth cut to 2 layers (the gloo
   transport; 8 before phase 4v, 4 before phase 9v), one 1,024-token
   sequence a DP rank, 2
   steps each of
   locality + FSDP, ``seq_shard`` and xla + FSDP: metrics equal on every
   rank, the first loss within ``SSM_TP_LOSS_REL`` of the card's one rank
   at the same depth, launches exact (the gated norm split: 4 launches
   forward and 2 backward a layer and step with remat), each rank's
   non-local gather and reduce-scatter messages and bytes the oracle's for
   its lane rank (``in_proj``, ``in_proj_bc`` and ``out_proj`` a layer),
   the tier inside its pod; step ms, tokens/s, peak memory, the tier's
   calls, host ms and staged bytes. 8d, ``train_one_rank_ssm``:
   mamba2-780m at full width and
   depth (48 layers, d_model 1,536), fp32 master weights from seed 0 and
   bf16 compute, 3 steps of 4 x 1,024 tokens through ``Trainer``: finite
   losses and grad norms, launches exactly what the path implies (per
   step with remat: SSD forward 96 and its backward 48, gated RMSNorm 96
   and its backward 48, RMSNorm plain 97 and its backward 49); step ms,
   tokens/s, peak memory and a profiled step (the SSD forward's and
   backward's device ms, the gated backward's, the idle share).
   8v, the dense variants trained (after 8d): ``train_variant_h2o``,
   h2o-danube-3-4b at full width and depth (24 layers, 32/8 heads of 120,
   every layer a 4,096-token window, inert at 1,024 tokens), and
   ``train_variant_gemma2``, gemma2-9b at full width and 8 layers (four
   window / full periods; softcaps 50 / 30, sandwich norms, GeGLU, the
   scaled tied embedding; its 42 layers would not fit the card with fp32
   master weights, gradients and AdamW moments), each 3 steps of 4 x 1,024
   tokens through ``Trainer`` as 8a: finite losses and grad norms, launches
   exactly as the path implies (the flash backward at D = 120 on the
   tensor cores, ``flash_attention_bwd_d120`` counting it; gemma2's at
   D = 256 on the CUDA cores, so ``flash_attention_bwd_wgmma`` stays 0;
   the sandwich's two plain norms a layer, twice forward under remat and
   once backward), step ms, tokens/s, peak memory and a profiled step with
   the flash backward's device ms. ``train_variant_exact``: the reduced
   fp32 variants with their real head dims (gemma2 at head dim 256, caps
   50 / 30, 3 layers: slot0, slot1 and a ``rest`` layer; h2o-danube at
   120, 2 layers; window 64), 2 steps of 4 x 128 tokens so that the window
   bites, the card's one-rank step against the CPU's at 8b's limits
   (the elements whose gradient is below ``NOISE_BAND`` at some step
   held to ``NOISE_BAND_ATOL``, the most two AdamW steps can part them).
   8ev, the dense variants on a model tier (in 8e's 8 spawned ranks, 2 x
   2 x 2, ``train_tp_on_ranks``): ``train_parity_tp_variant``, the same
   reduced fp32 variants and batches in locality + FSDP, eager and with
   ``prefetch_depth=1``, ``seq_shard`` and xla + FSDP against the card's
   one rank of ``train_variant_exact`` at 8b's limits (the elements in
   the noise band held to ``TIER_NOISE_BAND_ATOL``), the prefetch bitwise
   the eager step, launches exact, the tier inside each pod;
   ``train_tp_variants``, gemma2-9b at full width, 8/4 heads of 256 a
   model rank, cut to one window / full pair of layers (the gloo
   transport), one 1,024-token sequence a DP rank, ``TP_VARIANT_STEPS``
   step of locality + FSDP (2 until the run's time needed it): metrics equal on every rank and finite, launches exact, each
   rank's non-local gather and reduce-scatter messages and bytes the
   oracle's for its lane rank, the tier inside its pod; step ms, peak
   memory a rank, the tier's calls, host ms and staged bytes.
   10c, the MoE family on a model tier (in 8e's 8 spawned ranks, 2 x 2 x
   2): ``train_parity_moe_tp``, 10a's reduced fp32 qwen2-moe (4 experts
   and 32 shared-expert columns a model rank, the router whole) on 8b's
   batches in locality + FSDP, eager and with ``prefetch_depth=1``,
   ``seq_shard``, xla + FSDP and expert-parallel "locality" (over each
   model lane) against the card's one rank at 8b's limits, the aux loss
   too (the lane's 4 DP ranks' rows as 4 microbatches; for "xla" the
   whole batch as one: the JAX GSPMD step's aux loss is the global
   batch's), the prefetch bitwise the eager step, launches exact, the
   tier inside each pod; ``train_moe_tp``, qwen2-moe-a2.7b at full width
   (32 of 64 experts, 8/8 heads of 128 and 2,816 shared columns a model
   rank) cut to 1 of 24 layers (the gloo transport), one 1,024-token
   sequence a DP rank, one step of locality + FSDP: metrics equal on
   every rank and finite, launches exact, each rank's non-local gather
   and reduce-scatter messages and bytes the oracle's for its lane rank,
   the tier inside its pod; step ms, peak memory a rank, the tier's
   calls, host ms and staged bytes.
10. MoE expert-parallel training, ``train_moe_on_ranks``: 6 spawned
   ranks. 10a: the reduced fp32 qwen2-moe (2 layers, 8 experts at top-4)
   on 2 x 2 and, with 12 experts, on 3 x 2, ``moe_dispatch`` "locality"
   (the tokens transport), "xla" (slots) and "none" (every expert on
   every rank, FSDP-gathered) with FSDP, against the card's
   one rank running the ranks' rows as p microbatches (each rank's
   auxiliary loss is its own rows'), at 8b's limits, and the card's one
   rank against the CPU's; 10b: qwen2-moe-a2.7b at full width on 2 x 2
   of the ranks, depth cut to 1 layer (2 before phase 4v needed the
   run's time), one 1,024-token sequence a rank,
   locality + FSDP with the dispatch "locality" (2 steps) and "xla" (1
   step; "none" too until phase 8ev needed the run's time, in 10a
   since): the tokens
   and slots transports' first losses bitwise equal; every rank's launches
   exact and, per step, its all-to-all's non-local messages and bytes the
   oracle's (``schedules.locality_all_to_all``, ``xla_all_to_all``) times
   its calls (``a2a_check``); step ms, the all-to-all's, the tokens
   gathers', the parameter gathers' and reduce-scatters' host ms, staged
   bytes and peak memory a process.
9. serving on a ("pod", "data", "model") grid, ``serve_tier``: 8 spawned
   ranks sharing the card as 2 x 2 x 2, llama3.2-3b split over a model
   tier of 2 (12 q and 4 KV heads a rank, its MLP columns and vocabulary
   rows, cut from the seed-0 weights as they are drawn). 9a: phase 7's
   ServeSpec and home pod on the first 8 requests of its trace, their
   budgets cut to ``TIER_MAX_NEW`` (``TIER_MIGRATIONS`` = 4 migrations, the count the JAX engine and the
   port give for it at a reduced size in tests/test_torch_serve_tp.py),
   for ``locality_bruck`` and ``xla``; 9b: phase 6's 32,768-slot cache
   split over ("pod", "data") on each model lane, a prompt of 3,000
   tokens at full width (of 562 and 2,062 reduced), 4 new each,
   ``combine="locality"`` and ``"xla"``. Each
   first with a reduced fp32 llama (2 layers) whose tokens must equal a
   one-rank engine's; then at full width and depth (bf16) against
   one-rank engines in this process: every rank's results alike, prefill
   logits (the tier's columns put together) and first decode logits
   within ``SEQ_LOGIT_REL`` of the largest |logit| (a first token that
   differs must lie within twice the prefill's difference of the one
   rank's maximum, and its decode logits are not compared), launches
   exact, each rank's non-local migration and combine messages and bytes
   the oracle's (``migrate_oracle``, ``migrate_bytes_oracle``,
   ``combine_oracle``) and its bytes 1/m of phase 7's or 6's for its lane
   rank, every tier inside one pod and no tier message across a pod, and
   every decode step eager by the scheduler's rule; per rank it prints
   decode step ms, prefill ms per request, tokens/s, peak memory, the
   tier's calls, host ms and staged bytes, and the migrations' and
   combines' messages and bytes.
9m. mamba2-780m on the model tier, ``serve_tier_ssm`` (after 8f): 8
   spawned ranks as 2 x 2 x 2, 24 SSD heads a rank and their state, the
   weights cut from seed 0's as they are drawn, at full width and depth
   (48 layers), phase 9a's ServeSpec, trace and home pod with
   ``migrate="locality_bruck"``: first in fp32 with each request's budget
   cut to ``SSM_TIER_FP32_NEW`` tokens, every token equal to a one-rank
   engine's; then in bf16 on 9a's trace against a one-rank engine by
   phase 9's rule (logits within ``SEQ_LOGIT_REL``, near ties), the share
   of equal tokens printed; in both every rank's results alike, 2 L + 2
   tier calls a forward (the gated norm's statistic and ``out_proj`` a
   layer, the embedding, the greedy token), none across a pod, the
   trace's 8 prefills on each rank of pod 0 and none in pod 1,
   ``TIER_MIGRATIONS`` migrations,
   launches exact; decode step ms, prefill ms, tokens/s, the tier's calls,
   host ms and staged bytes, the migrations' bytes.
9v. the dense variants on the model tier, ``serve_tier_variants`` (after
   9m): 8 spawned ranks as 2 x 2 x 2 in phase 9's order. First
   gemma2-9b and h2o-danube-3-4b reduced (2 layers, d_model 128, their
   real head dims 256 and 120, window 64, fp32) in 9a's batch-sharded
   layout (both schedules) and 9b's split cache (both combines) on a
   128-slot cache, every token equal to a one-rank engine's and each
   K/V stack split by its own length; then gemma2-9b at full width cut
   to 8 of 42 layers (4 window, 4 full; bf16; an 8,192-slot cache):
   9v-a, 8 requests of 3,900-4,300 tokens homed in pod 0, 8 new each,
   ``TIER_MIGRATIONS`` migrations with ``locality_bruck`` and ``xla``;
   9v-b, one 4,090-token prompt, 8 new, split over ("pod", "data")
   (2,048 full and 1,024 ring slots a rank, the decode crossing slot
   4,096) with ``combine="locality"`` and ``"xla"``; held by phase 9's
   rule against one-rank engines of the same 8 layers, with phase 9's
   checks: migration and combine messages and bytes the oracle's with
   each ring leaf at its own span, 2 L + 2 tier calls a forward, the
   decode graph rule, launches exact (the ring instances too); decode
   step ms, prefill ms, the combine's and the migration's host ms and
   peak memory a rank.
9e. the MoE family on the model tier, ``serve_moe_tier`` (in 9v's 8
   spawned ranks, after 9v): each model rank holds E/m routed experts, its
   shared-expert columns, its q and KV heads and vocabulary rows, the
   router whole. First 9l's reduced fp32 llama4 and qwen2-moe on 9l's
   128-slot cache and traces, batch-sharded (both schedules) and split
   (both combines), every token equal to a one-rank engine's, each rank
   holding E/m experts; then qwen2-moe-a2.7b at full width (32 experts,
   8/8 heads and 2,816 shared columns a rank; 9v's 8,192-slot cache and
   traces): 9e-a with ``locality_bruck`` (``TIER_MIGRATIONS``
   migrations), 9e-b split over ("pod", "data") with the locality
   combine, first in fp32 at 2 layers, held by phase 9's rule against
   one-rank engines of the same layers at ``MOE_TIER_EXACT_REL``, then in
   bf16 at 8 of 24 layers, where the rule's differences are printed and
   not held (bf16 routing near-ties, ``MOE_TIER_LAYERS``' comment); both
   with phase 9's other checks (2 L + 2 tier calls a forward, migration
   and combine messages and bytes the oracle's, every tier inside one
   pod, the decode eager, launches exact); decode step ms, prefill ms,
   the tier's calls, host ms (a forward's too) and staged bytes, and peak
   memory a rank.
9l. the MoE family on (pod, data) grids, ``serve_moe_grids`` (after 9e):
   4 spawned ranks as 2 x 2, every rank holding every expert. First the
   reduced fp32 llama4 of 4l's exactness check and the reduced fp32
   qwen2-moe-a2.7b (2 layers) on a 128-slot cache: 9l-a batch-sharded, 8
   rows, 12 requests homed in pod 0 (later ones migrate,
   ``locality_bruck``); 9l-b one B = 1 split cache with the locality
   combine, a request crossing llama4's chunk boundary; every token equal
   to a one-rank engine's, each split stack in its own shards, every
   decode step combining in every layer. Then llama4-scout at full width
   cut to 2 layers (both chunked, ~12.9 GB a rank), 16,384 slots: 9l-a
   four requests homed in pod 0 (``MOE_GRID_MIGRATIONS`` migrate), 9l-b
   one 8,300-token prompt whose 8,192-slot rings keep slots in the first
   2,048-slot shard alone; held by phase 9's rule against one-rank
   engines of the same 2 layers; decode step ms, prefill ms, migration
   and combine host ms and peak memory a rank. Last the whole run's wall
   time.

Every kernel's launches are counted from 0 just before each main path
(the DMA gather, phases 4, 5, 4m and 4l, each engine of phases 6, 7, 9,
9m, 9v, 9e and 9l in its own process, the trainers of 8a and 8d, each run
of 8c, 8e, 8ev, 10c, 8f, 10b and of 8b's mamba2 ranks in its own process)
and read just after it.

The last lines: the kernels' JSON line, the card's name and power limit as
nvidia-smi gives them, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean device ms per call with CUDA events, L2 flushed before each.

    A sleep kernel holds the stream while the host enqueues every call, so
    the events bracket device time only, not the host's launch overhead
    (which :meth:`host_ms` measures on its own).
    """

    def __init__(self):
        self.flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                                 device="cuda")
        self(lambda: None, iters=2)             # first sleep/flush/events

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)          # ~50 ms of device time
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    @staticmethod
    def host_ms(fn, iters: int = 50) -> float:
        """Mean host time to issue one call (no synchronisation inside)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return t


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def err_of(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def np_err(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(out - ref).max())


def close(out, ref, tol: float, what: str, rtol: float | None = None
          ) -> float:
    err = err_of(out, ref)
    rtol = tol if rtol is None else rtol
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=rtol)
    check(ok, f"{what}: kernel and plain version differ, max abs err {err} "
              f"(atol {tol}, rtol {rtol})")
    return err


# bf16 kernel output against the plain version run in fp32 on the same bf16
# inputs: the kernels compute in fp32 and round once, so they sit within a
# few bf16 ulps of |out| of it.
BF16_VS_FP32 = dict(tol=4e-3, rtol=8e-3)


def close_fp32(out, plain, args, what: str) -> float | None:
    """For a bf16 ``out``, hold it against ``plain`` on ``args`` upcast to
    fp32; None for an fp32 ``out`` (already held against fp32)."""
    if out.dtype != torch.bfloat16:
        return None
    ref = plain(*(a.float() if a.dtype == torch.bfloat16 else a
                  for a in args))
    return close(out, ref, what=what + " vs fp32 plain", **BF16_VS_FP32)


# ---------------------------------------------------------------------------
# phase 2: kernels against plain versions
# ---------------------------------------------------------------------------
def kernel_cases(timer: Timer) -> dict[str, list[dict]]:
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    cases: dict[str, list[dict]] = {"rmsnorm": [], "flash_attention": [],
                                    "decode_scores": [], "decode_stats": []}

    for dtype in (torch.bfloat16, torch.float32):
        tol = 2e-2 if dtype == torch.bfloat16 else None
        for form, shapes in RMS_FORMS.items():
            for rows, d in shapes:
                cases["rmsnorm"].append(rmsnorm_case(timer, randn, form, rows,
                                                     d, dtype, tol))

        flash = [(S, 24, 8, 128, dict(causal=True)) for S in (137, 512, 2048)]
        flash += [(300, 8, 2, 64, m) for m in (dict(causal=True, window=64),
                                               dict(causal=True, chunk=128),
                                               dict(causal=True, cap=50.0))]
        for S, H, KV, D, mask in flash:
            cases["flash_attention"].append(flash_case(
                timer, randn, S, H, KV, D, mask, dtype, tol))

        for name, rows in decode_cases(timer, g, dtype, tol).items():
            cases[name] += rows
    cases["decode_attention"] = [decode_pair(timer, g)]
    cases["decode_offset"] = decode_offset_cases(timer, g)
    rms, cases["decode_batch"] = batch_sharded_cases(timer)
    cases["rmsnorm"] += rms
    cases["decode_tier"] = tier_decode_cases(timer)
    cases["decode_ring_shard"] = ring_shard_decode_cases(timer)
    return cases


def flash_case(timer, randn, S, H, KV, D, mask, dtype, tol) -> dict:
    """The flash forward at (1, S, H, KV, D) against its plain version:
    errors, times, bound; SDPA timed beside a causal case."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    q = randn(1, S, H, D).to(dtype)
    k, v = randn(1, S, KV, D).to(dtype), randn(1, S, KV, D).to(dtype)
    out, what = (flash_ops.flash_attention(q, k, v, **mask),
                 f"flash {dtype} S={S} H={H} KV={KV} D={D} {mask}")
    err = close(out, flash_ops.attention_ref(q, k, v, **mask),
                tol or 1e-4, what)
    err32 = close_fp32(out, lambda *a: flash_ops.attention_ref(
        *a, **mask), (q, k, v), what)
    qp, kp = torch.arange(S)[:, None], torch.arange(S)[None, :]
    allowed = qp >= kp
    if mask.get("window"):
        allowed &= (qp - kp) < mask["window"]
    if mask.get("chunk"):
        allowed &= (qp // mask["chunk"]) == (kp // mask["chunk"])
    pairs = int(allowed.sum())
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel())
                       * q.element_size(), 4 * H * D * pairs, dtype)
    lib_ms = None
    if list(mask) == ["causal"]:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    return dict(
        shape=[1, S, H, KV, D], mask=mask, dtype=str(dtype),
        max_abs_err=err, tolerance=tol or 1e-4,
        max_abs_err_vs_fp32_plain=err32,
        ms=timer(lambda: flash_ops.flash_attention(q, k, v, **mask)),
        host_ms=timer.host_ms(
            lambda: flash_ops.flash_attention(q, k, v, **mask)),
        plain_ms=timer(lambda: flash_ops.attention_ref(q, k, v, **mask)),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


# the serving path's kernels at qwen2-moe-a2.7b's shapes (phase 4m):
# d_model 2,048, 16 q and 16 KV heads of 128 (G = 1); RMSNorm plain and
# residual at 8 and 512 rows, flash at S = 137 and 512, the decode pair at
# phase 4's batch and cache (8 rows of 1,024 slots); then at a model rank's
# 8/8 heads (phase 9e); bf16, the tolerances of phase 2
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_D, MOE_HEADS, MOE_HEAD_DIM = 2048, 16, 128


def moe_kernel_cases(timer) -> dict[str, list[dict]]:
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf16, tol = torch.bfloat16, 2e-2
    out = {"rmsnorm": [rmsnorm_case(timer, randn, form, rows, MOE_D, bf16,
                                    tol)
                       for form in ("plain", "residual") for rows in (8, 512)],
           "flash_attention": [flash_case(
               timer, randn, S, MOE_HEADS, MOE_HEADS, MOE_HEAD_DIM,
               dict(causal=True), bf16, tol) for S in (137, 512)]}
    out.update(decode_cases(timer, g, bf16, tol, shapes=[(1, MOE_HEAD_DIM)],
                            KV=MOE_HEADS))
    out["decode_attention"] = [decode_pair(timer, g, KV=MOE_HEADS, G=1,
                                           D=MOE_HEAD_DIM)]
    for rows in out.values():
        for r in rows:
            r["path"] = "serve_full_width_moe"
    # a model rank of phase 9e (m = 2: 8 q and 8 KV heads of 128): flash at
    # a 512-token prefill, the decode kernels on 9e-a's 2 rows of an
    # 8,192-slot cache, the pair on 8 rows of 1,024
    h = MOE_HEADS // TIER_M
    tier = {"flash_attention": [flash_case(
        timer, randn, 512, h, h, MOE_HEAD_DIM, dict(causal=True), bf16,
        tol)]}
    tier.update(decode_cases(timer, g, bf16, tol, shapes=[(1, MOE_HEAD_DIM)],
                             B=2, KV=h, L=VARIANT_TIER_CACHE))
    tier["decode_attention"] = [decode_pair(timer, g, KV=h, G=1,
                                            D=MOE_HEAD_DIM)]
    for name, rows in tier.items():
        for r in rows:
            r["path"] = "serve_moe_tier"
        out[name] += rows
    return out


# phase 4v's kernels: flash at h2o-danube-3-4b's prefill (32/8 heads of
# 120, window 4,096) and gemma2-9b's (16/8 heads of 256, softcap 50, window
# 4,096), at S = 512 and at the 6,000-token prompt that the window masks;
# the decode pair over a 4,096-slot ring past its wrap at each one's decode
# shape (8 rows); bf16, phase 2's tolerances. SDPA is the library where it
# computes the same function (no softcap): causal, or a boolean mask of
# the kept pairs or slots
VARIANT_FLASH = (("h2o-danube-3-4b", 512, 32, 8, 120, 0.0),
                 ("h2o-danube-3-4b", 6000, 32, 8, 120, 0.0),
                 ("gemma2-9b", 512, 16, 8, 256, 50.0),
                 ("gemma2-9b", 6000, 16, 8, 256, 50.0))
VARIANT_DECODE = (("h2o-danube-3-4b", 4, 120, 0.0), ("gemma2-9b", 2, 256, 50.0))
VARIANT_WINDOW, VARIANT_B, VARIANT_KV = 4096, 8, 8


def variant_kernel_cases(timer) -> dict[str, list[dict]]:
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(9)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf16, tol = torch.bfloat16, 2e-2
    out = {"flash_attention": [], "decode_scores": [], "decode_stats": [],
           "decode_attention": []}
    for arch, S, H, KV, D, cap in VARIANT_FLASH:
        mask = dict(causal=True, window=VARIANT_WINDOW,
                    **({"cap": cap} if cap else {}))
        row = flash_case(timer, randn, S, H, KV, D, mask, bf16, tol)
        if not cap:                     # SDPA: no softcap
            q, k, v = (randn(1, S, n, D).to(bf16).transpose(1, 2)
                       for n in (H, KV, KV))
            pos = torch.arange(S, device="cuda")
            seen = (pos[:, None] >= pos[None]) & \
                (pos[:, None] - pos[None] < VARIANT_WINDOW)
            kw = (dict(is_causal=True) if S <= VARIANT_WINDOW
                  else dict(attn_mask=seen))
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **kw))
            row["library"] = "sdpa, " + ("is_causal" if S <= VARIANT_WINDOW
                                         else "boolean mask")
            del q, k, v, seen
        out["flash_attention"].append(dict(row, model=arch))
        torch.cuda.empty_cache()
    for arch, G, D, cap in VARIANT_DECODE:
        for name, row in ring_decode_case(timer, g, G, D, cap).items():
            out[name].append(dict(row, model=arch))
    for rows in out.values():
        for r in rows:
            r["path"] = "serve_full_width_variants"
    return out


def ring_decode_case(timer, g, G: int, D: int, cap: float,
                     B: int = VARIANT_B, KV: int = VARIANT_KV,
                     L: int = VARIANT_WINDOW) -> dict[str, dict]:
    """The decode pair over an L-slot ring (window L) at positions past
    its wrap, every slot kept: each kernel against its plain version, the
    pair against SDPA with the kept slots as a boolean mask where there is
    no softcap; bounds as :func:`decode_cases` counts them."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_stats import ops as stats_ops
    from repro_torch.models.attention import NEG_INF, decode_attention
    bf16, tol = torch.bfloat16, 2e-2
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    pos = torch.randint(L, 3 * L, (B,), generator=g, device="cuda")
    q, k, v = (rn(B, 1, KV * G, D).to(bf16), rn(B, L, KV, D).to(bf16),
               rn(B, L, KV, D).to(bf16))
    mask = dict(window=L, ring=True)
    what = f"ring decode G={G} D={D} cap={cap}"
    s, m = stats_ops.decode_scores(q, k, pos, cap=cap, **mask)
    rs, rm = stats_ops.decode_scores_ref(q, k, pos, cap=cap, **mask)
    kept = rs[:, 0, 0] != NEG_INF
    check(torch.equal(s == NEG_INF, rs == NEG_INF),
          f"{what}: masked slots differ")
    check(bool(kept.all()), f"{what}: past the wrap every slot is kept")
    slots = int(kept.sum())
    err = max(close(s, rs, tol, what + " s"), close(m, rm, tol, what + " m"))
    es = q.element_size()
    b_ms, b_by = bound(q.numel() * es + slots * KV * D * es
                       + (s.numel() + m.numel()) * 4,
                       2 * slots * KV * G * D, bf16)
    rows = {"decode_scores": dict(
        shape=[B, KV, G, L, D], dtype=str(bf16), cap=cap, ring=True,
        positions=pos.tolist(), kept_slots=slots, max_abs_err=err,
        tolerance=tol,
        ms=timer(lambda: stats_ops.decode_scores(q, k, pos, cap=cap, **mask)),
        host_ms=timer.host_ms(lambda: stats_ops.decode_scores(
            q, k, pos, cap=cap, **mask)),
        plain_ms=timer(lambda: stats_ops.decode_scores_ref(
            q, k, pos, cap=cap, **mask)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)}
    o, l = stats_ops.accumulate(s, m, v, pos=pos, **mask)
    ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
    err = max(close(o, ro, tol, what + " o"), close(l, rl, tol, what + " l"))
    b_ms, b_by = bound((m.numel() + o.numel() + l.numel()) * 4
                       + slots * KV * D * es + slots * KV * G * 4,
                       2 * G * D * KV * slots, bf16)
    rows["decode_stats"] = dict(
        shape=[B, KV, G, L, D], dtype=str(bf16), ring=True,
        positions=pos.tolist(), max_abs_err=err, tolerance=tol,
        ms=timer(lambda: stats_ops.accumulate(s, m, v, pos=pos, **mask)),
        host_ms=timer.host_ms(lambda: stats_ops.accumulate(s, m, v, pos=pos,
                                                           **mask)),
        plain_ms=timer(lambda: stats_ops.decode_stats_accumulate_ref(s, m,
                                                                     v)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    pair = lambda: decode_attention(q, k, v, pos, cap=cap, **mask)
    out = pair()
    lib_ms, err = None, None
    if not cap:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=kept[:, None, None], enable_gqa=True)
        err = close(out, sdpa().transpose(1, 2), tol,
                    what + " pair vs SDPA")
        lib_ms = timer(sdpa)
    b_ms, b_by = bound((q.numel() + out.numel() + 2 * slots * KV * D) * es,
                       4 * slots * KV * G * D, bf16)
    rows["decode_attention"] = dict(
        shape=[B, KV, G, L, D], dtype=str(bf16), cap=cap, ring=True,
        max_abs_err_vs_sdpa=err, ms=timer(pair), host_ms=timer.host_ms(pair),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    return rows


# the decode kernels on one rank's shard of a sequence-parallel cache: a
# 32,768-slot llama3.2-3b cache (B = 1, KV = 8, G = 3, D = 128, bf16) over
# 4 shards of 8,192, at the phase 6 prompts' positions, so that a shard
# keeps all its slots, part of them or none; with no mask, a window and a
# chunk that the shards' offsets do not divide
OFFSET_TOTAL, OFFSET_SHARDS = 32768, 4
OFFSET_POSITIONS = (3000, 11000, 20000)
OFFSET_MASKS = ({}, dict(window=4096), dict(chunk=6000))


def decode_offset_cases(timer, g) -> list[dict]:
    """Both decode kernels at every shard's slot offset against their plain
    versions (the scores' masked slots exactly NEG_INF, a shard with no
    kept slot m = NEG_INF, o = 0 and l = 0 exactly); the unmasked cases
    timed beside their plain versions, with their bounds (the kept slots'
    K and V rows and scores only, as in ``decode_cases``)."""
    from repro_torch.kernels.decode_stats import ops as stats_ops
    from repro_torch.models.attention import NEG_INF
    KV, (G, D) = DECODE_KV, DECODE_SHAPES[0]
    L = OFFSET_TOTAL // OFFSET_SHARDS
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dt = torch.bfloat16
    q = rn(1, 1, KV * G, D).to(dt)
    k, v = rn(1, OFFSET_TOTAL, KV, D).to(dt), rn(1, OFFSET_TOTAL, KV, D).to(dt)
    rows = []
    for p_ in OFFSET_POSITIONS:
        pos = torch.tensor(p_, device="cuda")
        for mask in OFFSET_MASKS:
            hint = dict(window=mask.get("window", 0),
                        chunk=mask.get("chunk", 0))
            for shard in range(OFFSET_SHARDS):
                off = shard * L
                ks, vs = k[:, off:off + L], v[:, off:off + L]    # views
                kw = dict(slot_offset=off, **mask)
                s, m = stats_ops.decode_scores(q, ks, pos, **kw)
                rs, rm = stats_ops.decode_scores_ref(q, ks, pos, **kw)
                what = f"decode at offset {off} pos {p_} {mask}"
                check(torch.equal(s == NEG_INF, rs == NEG_INF),
                      f"{what}: masked slots differ")
                err = max(close(s, rs, 2e-2, what + " s"),
                          close(m, rm, 2e-2, what + " m"))
                o, l = stats_ops.accumulate(s, m, vs, pos=pos,
                                            slot_offset=off, **hint)
                ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, vs)
                err_o = max(close(o, ro, 2e-2, what + " o"),
                            close(l, rl, 2e-2, what + " l"))
                kept = int((rs[0, 0, 0] > NEG_INF).sum())
                state = ("none" if kept == 0 else
                         "all" if kept == L else "part")
                if kept == 0:
                    check(bool((m == NEG_INF).all())
                          and float(o.abs().max()) == 0.0
                          and float(l.abs().max()) == 0.0,
                          f"{what}: a shard with no slot kept is not "
                          "(NEG_INF, 0, 0)")
                row = dict(shape=[1, KV, G, L, D], dtype=str(dt),
                           slot_offset=off, position=p_, mask=mask,
                           kept_slots=kept, state=state,
                           max_abs_err_scores=err, max_abs_err_stats=err_o,
                           tolerance=2e-2)
                if not mask:
                    es = q.element_size()
                    sb, sby = bound(q.numel() * es + kept * KV * D * es
                                    + (s.numel() + m.numel()) * 4,
                                    2 * kept * KV * G * D, dt)
                    ab, aby = bound(kept * KV * (G * 4 + D * es)
                                    + (m.numel() + o.numel() + l.numel()) * 4,
                                    2 * kept * KV * G * D, dt)
                    row.update(
                        scores_ms=timer(lambda: stats_ops.decode_scores(
                            q, ks, pos, **kw)),
                        scores_plain_ms=timer(
                            lambda: stats_ops.decode_scores_ref(q, ks, pos,
                                                                **kw)),
                        scores_bound_ms=sb, scores_bound_by=sby,
                        stats_ms=timer(lambda: stats_ops.accumulate(
                            s, m, vs, pos=pos, slot_offset=off)),
                        stats_plain_ms=timer(
                            lambda: stats_ops.decode_stats_accumulate_ref(
                                s, m, vs)),
                        stats_bound_ms=ab, stats_bound_by=aby)
                rows.append(row)
    states = {r["state"] for r in rows}
    check(states == {"all", "part", "none"},
          f"decode offset cases: shard states {states}")
    del q, k, v
    torch.cuda.empty_cache()
    return rows


# the kernels at the shapes phase 7 gives them on a rank: the decode pair on
# B_loc rows of llama3.2-3b (KV = 8, G = 3, D = 128) over the 2,048-slot
# cache, 2 rows a rank on 2 x 2 (bf16 at full width, fp32 reduced) and 1 on
# the reduced 3 x 2 (fp32); RMSNorm, plain and residual, 3,072 wide, on
# those decode rows and on the trace's shortest and longest prefills
BATCH_DECODE = ((2, torch.bfloat16), (2, torch.float32), (1, torch.float32))
BATCH_DECODE_DRAWS = 3


def batch_positions(rng, rows: int, draw: int) -> list[int]:
    """Decode positions of phase 7's trace: request i decodes at slots
    len_i .. len_i + max_new_i - 2. Draw 0 takes the trace's extremes (the
    shortest prompt's first step, the longest reach's last), the others a
    seeded request and step a row."""
    span = [(len(t), len(t) + m - 2) for t, m in batch_requests(2)]
    if draw == 0:
        return [min(a for a, _ in span), max(b for _, b in span)][-rows:]
    picks = rng.integers(0, len(span), rows)
    return [int(rng.integers(span[i][0], span[i][1] + 1)) for i in picks]


def batch_sharded_cases(timer) -> tuple[list[dict], list[dict]]:
    """(RMSNorm rows, decode rows) at phase 7's per-rank shapes against
    their plain versions at the tolerances of ``decode_cases`` and
    ``rmsnorm_case``, with times and bounds counted as there."""
    from repro_torch.kernels.decode_stats import ops as stats_ops
    from repro_torch.models.attention import NEG_INF
    g = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    rng = np.random.default_rng(1)
    d = 3072
    lens = [len(t) for t, _ in batch_requests(2)]
    rms = [rmsnorm_case(timer, randn, form, rows, d, dtype,
                        2e-2 if dtype == torch.bfloat16 else None)
           for dtype in (torch.bfloat16, torch.float32)
           for rows in (1, 2, min(lens), max(lens))
           for form in ("plain", "residual")]
    for row in rms:
        row["path"] = "serve_batch_sharded"
    KV, (G, D), L = DECODE_KV, DECODE_SHAPES[0], BATCH_CACHE
    rows = []
    for B, dtype in BATCH_DECODE:
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        q, k, v = (randn(B, 1, KV * G, D).to(dtype),
                   randn(B, L, KV, D).to(dtype), randn(B, L, KV, D).to(dtype))
        es = q.element_size()
        for draw in range(BATCH_DECODE_DRAWS):
            at = batch_positions(rng, B, draw)
            pos = torch.tensor(at, device="cuda")
            slots = sum(a + 1 for a in at)
            what = f"decode B={B} {dtype} L={L} positions {at}"
            s, m = stats_ops.decode_scores(q, k, pos)
            rs, rm = stats_ops.decode_scores_ref(q, k, pos)
            check(torch.equal(s == NEG_INF, rs == NEG_INF),
                  f"{what}: masked slots differ")
            err = max(close(s, rs, tol, what + " s"),
                      close(m, rm, tol, what + " m"))
            o, l = stats_ops.accumulate(s, m, v, pos=pos)
            ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
            err_o = max(close(o, ro, tol, what + " o"),
                        close(l, rl, tol, what + " l"))
            sb, sby = bound(q.numel() * es + slots * KV * D * es
                            + (s.numel() + m.numel()) * 4,
                            2 * slots * KV * G * D, dtype)
            ab, aby = bound((m.numel() + o.numel() + l.numel()) * 4
                            + slots * KV * (G * 4 + D * es),
                            2 * slots * KV * G * D, dtype)
            rows.append(dict(
                shape=[B, KV, G, L, D], dtype=str(dtype), positions=at,
                kept_slots=slots, max_abs_err_scores=err,
                max_abs_err_stats=err_o, tolerance=tol,
                scores_ms=timer(lambda: stats_ops.decode_scores(q, k, pos)),
                scores_plain_ms=timer(
                    lambda: stats_ops.decode_scores_ref(q, k, pos)),
                scores_bound_ms=sb, scores_bound_by=sby,
                stats_ms=timer(lambda: stats_ops.accumulate(s, m, v,
                                                            pos=pos)),
                stats_plain_ms=timer(
                    lambda: stats_ops.decode_stats_accumulate_ref(s, m, v)),
                stats_bound_ms=ab, stats_bound_by=aby))
        del q, k, v
    torch.cuda.empty_cache()
    return rms, rows


# the decode pair at the shapes phase 9 gives a model rank (llama3.2-3b's 8 KV
# heads over m = 2: KV = 4, G = 3, D = 128, bf16): 9a's B_loc = 2 rows of the
# 2,048-slot cache at positions of phase 7's trace, and 9b's B = 1 shard of
# 8,192 slots of a 32,768-slot cache at every shard's offset, at positions
# 3,000 and 11,000 (phase 6's prompts: a shard keeps all its slots, part
# of them or none)
TIER_M = 2
TIER_KV = 8 // TIER_M
TIER_POSITIONS = OFFSET_POSITIONS[:2]


def tier_decode_cases(timer) -> list[dict]:
    """Both decode kernels at a model rank's shapes against their plain
    versions (the tolerances of ``decode_cases``), each timed with its
    bound, and the pair (scores, accumulate, o / l) beside one SDPA call
    on the same inputs, masked to the kept slots (the library yardstick,
    timed here only; none for a shard that keeps no slot)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_stats import ops as stats_ops
    from repro_torch.models.attention import NEG_INF
    g = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    KV, (G, D), dt = TIER_KV, DECODE_SHAPES[0], torch.bfloat16
    es = 2
    rng = np.random.default_rng(3)
    runs = []                  # (what, q, k, v, pos, offset or None)
    B, L = BATCH_ROWS // 4, BATCH_CACHE
    q, k, v = (randn(B, 1, KV * G, D).to(dt), randn(B, L, KV, D).to(dt),
               randn(B, L, KV, D).to(dt))
    for draw in range(BATCH_DECODE_DRAWS):
        pos = torch.tensor(batch_positions(rng, B, draw), device="cuda")
        runs.append(("9a", q, k, v, pos, None))
    L = OFFSET_TOTAL // OFFSET_SHARDS
    q1 = randn(1, 1, KV * G, D).to(dt)
    k1 = randn(1, OFFSET_TOTAL, KV, D).to(dt)
    v1 = randn(1, OFFSET_TOTAL, KV, D).to(dt)
    for p_ in TIER_POSITIONS:
        for shard in range(OFFSET_SHARDS):
            off = shard * L
            runs.append(("9b", q1, k1[:, off:off + L], v1[:, off:off + L],
                         torch.tensor(p_, device="cuda"), off))
    rows = []
    for what, q, k, v, pos, off in runs:
        kw = {} if off is None else dict(slot_offset=off)
        B, L = k.shape[:2]
        name = f"tier decode {what} B={B} L={L} offset {off} pos " \
               f"{pos.tolist()}"
        s, m = stats_ops.decode_scores(q, k, pos, **kw)
        rs, rm = stats_ops.decode_scores_ref(q, k, pos, **kw)
        check(torch.equal(s == NEG_INF, rs == NEG_INF),
              f"{name}: masked slots differ")
        err = max(close(s, rs, 2e-2, name + " s"),
                  close(m, rm, 2e-2, name + " m"))
        o, l = stats_ops.accumulate(s, m, v, pos=pos, **kw)
        ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
        err_o = max(close(o, ro, 2e-2, name + " o"),
                    close(l, rl, 2e-2, name + " l"))
        kept = int((rs[:, 0, 0] > NEG_INF).sum())

        def pair():
            s_, m_ = stats_ops.decode_scores(q, k, pos, **kw)
            o_, l_ = stats_ops.accumulate(s_, m_, v, pos=pos, **kw)
            return (o_ / l_[..., None]).to(dt)

        row = dict(
            path="serve_tier", run=what, shape=[B, KV, G, L, D],
            dtype=str(dt), positions=pos.tolist(), slot_offset=off,
            kept_slots=kept, max_abs_err_scores=err, max_abs_err_stats=err_o,
            tolerance=2e-2,
            state=("none" if kept == 0 else "all" if kept == B * L
                   else "part"),
            scores_ms=timer(lambda: stats_ops.decode_scores(q, k, pos, **kw)),
            scores_plain_ms=timer(lambda: stats_ops.decode_scores_ref(
                q, k, pos, **kw)),
            stats_ms=timer(lambda: stats_ops.accumulate(s, m, v, pos=pos,
                                                        **kw)),
            stats_plain_ms=timer(lambda: stats_ops.decode_stats_accumulate_ref(
                s, m, v)),
            pair_ms=timer(pair), library_ms=None, max_abs_err_vs_sdpa=None)
        sb, sby = bound(q.numel() * es + kept * KV * D * es
                        + (s.numel() + m.numel()) * 4,
                        2 * kept * KV * G * D, dt)
        ab, aby = bound(kept * KV * (G * 4 + D * es)
                        + (m.numel() + o.numel() + l.numel()) * 4,
                        2 * kept * KV * G * D, dt)
        pb, pby = bound((q.numel() + o.numel() + 2 * kept * KV * D) * es,
                        4 * kept * KV * G * D, dt)
        row.update(scores_bound_ms=sb, scores_bound_by=sby,
                   stats_bound_ms=ab, stats_bound_by=aby,
                   pair_bound_ms=pb, pair_bound_by=pby)
        if kept:
            slot = torch.arange(L, device="cuda") + (off or 0)
            p2 = pos.reshape(-1, 1)
            mask = (slot[None] <= p2)[:, None, None]
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            row["max_abs_err_vs_sdpa"] = close(
                pair(), sdpa().transpose(1, 2), 2e-2, name + " vs SDPA")
            row["library_ms"] = timer(sdpa)
        rows.append(row)
    check({r["state"] for r in rows if r["run"] == "9b"}
          == {"all", "part", "none"}, "tier decode: 9b shard states")
    del q, k, v, q1, k1, v1
    torch.cuda.empty_cache()
    return rows


# the decode pair at the shapes phase 9v gives a model rank of the dense
# variants (KV = 4 of 8 heads over m = 2): gemma2-9b's (G = 2, D = 256, cap
# 50) and h2o-danube-3-4b's (G = 4, D = 120), bf16. 9v-b's B = 1 shard of
# 1,024 slots of a 4,096-slot ring at every shard's offset, at positions
# 2,000 (a shard keeps none, part or all of its slots), 4,090 (the ring not
# yet wrapped) and 4,100 (wrapped: every slot kept); 9v-a's B_loc = 2 rows
# over a whole ring past its wrap
RING_SHARD_ARCHS = (("gemma2-9b", 2, 256, 50.0),
                    ("h2o-danube-3-4b", 4, 120, 0.0))
RING_SHARD_T, RING_SHARD_N = 4096, 4
RING_SHARD_POSITIONS = (2000, 4090, 4100)


def ring_shard_decode_cases(timer) -> list[dict]:
    """Both decode kernels on a ring shard (``slot_offset``, ``total_len``,
    ``ring``) against their plain versions at phase 2's tolerances, each
    timed with its bound (the kept slots' K and V rows), and the pair beside
    one SDPA call with the kept slots as a boolean mask where there is no
    softcap (no library call computes the capped function)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_stats import ops as stats_ops
    from repro_torch.models.attention import NEG_INF
    g = torch.Generator(device="cuda").manual_seed(4)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dt, es, tol, T = torch.bfloat16, 2, 2e-2, RING_SHARD_T
    KV = TIER_KV
    Lloc = T // RING_SHARD_N
    rows = []
    for arch, G, D, cap in RING_SHARD_ARCHS:
        runs = []              # (what, q, k, v, pos, offset, total)
        q1 = randn(1, 1, KV * G, D).to(dt)
        k1, v1 = randn(1, T, KV, D).to(dt), randn(1, T, KV, D).to(dt)
        for p_ in RING_SHARD_POSITIONS:
            for shard in range(RING_SHARD_N):
                off = shard * Lloc
                runs.append(("9v-b", q1, k1[:, off:off + Lloc],
                             v1[:, off:off + Lloc],
                             torch.tensor(p_, device="cuda"), off))
        B = 2
        runs.append(("9v-a", randn(B, 1, KV * G, D).to(dt),
                     randn(B, T, KV, D).to(dt), randn(B, T, KV, D).to(dt),
                     torch.randint(T, T + 320, (B,), generator=g,
                                   device="cuda"), 0))
        for what, q, k, v, pos, off in runs:
            kw = dict(slot_offset=off, total_len=T, window=T, ring=True)
            B, L = k.shape[:2]
            name = (f"ring shard decode {arch} {what} B={B} L={L} offset "
                    f"{off} pos {pos.tolist()}")
            s, m = stats_ops.decode_scores(q, k, pos, cap=cap, **kw)
            rs, rm = stats_ops.decode_scores_ref(q, k, pos, cap=cap, **kw)
            check(torch.equal(s == NEG_INF, rs == NEG_INF),
                  f"{name}: masked slots differ")
            err = max(close(s, rs, tol, name + " s"),
                      close(m, rm, tol, name + " m"))
            o, l = stats_ops.accumulate(s, m, v, pos=pos, **kw)
            ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
            err_o = max(close(o, ro, tol, name + " o"),
                        close(l, rl, tol, name + " l"))
            kept_mask = rs[:, 0, 0] > NEG_INF                  # (B, L)
            kept = int(kept_mask.sum())
            if kept == 0:
                check(bool((m == NEG_INF).all())
                      and float(o.abs().max()) == 0.0
                      and float(l.abs().max()) == 0.0,
                      f"{name}: a shard with no slot kept is not "
                      "(NEG_INF, 0, 0)")

            def pair():
                s_, m_ = stats_ops.decode_scores(q, k, pos, cap=cap, **kw)
                o_, l_ = stats_ops.accumulate(s_, m_, v, pos=pos, **kw)
                return (o_ / l_[..., None]).to(dt)

            row = dict(
                path="serve_tier_variants", model=arch, run=what,
                shape=[B, KV, G, L, D], dtype=str(dt), cap=cap,
                positions=pos.tolist(), slot_offset=off, total_len=T,
                kept_slots=kept, max_abs_err_scores=err,
                max_abs_err_stats=err_o, tolerance=tol,
                state=("none" if kept == 0 else "all" if kept == B * L
                       else "part"),
                scores_ms=timer(lambda: stats_ops.decode_scores(
                    q, k, pos, cap=cap, **kw)),
                scores_plain_ms=timer(lambda: stats_ops.decode_scores_ref(
                    q, k, pos, cap=cap, **kw)),
                stats_ms=timer(lambda: stats_ops.accumulate(s, m, v, pos=pos,
                                                            **kw)),
                stats_plain_ms=timer(
                    lambda: stats_ops.decode_stats_accumulate_ref(s, m, v)),
                pair_ms=timer(pair), library_ms=None,
                max_abs_err_vs_sdpa=None)
            sb, sby = bound(q.numel() * es + kept * KV * D * es
                            + (s.numel() + m.numel()) * 4,
                            2 * kept * KV * G * D, dt)
            ab, aby = bound(kept * KV * (G * 4 + D * es)
                            + (m.numel() + o.numel() + l.numel()) * 4,
                            2 * kept * KV * G * D, dt)
            pb, pby = bound((q.numel() + o.numel() + 2 * kept * KV * D) * es,
                            4 * kept * KV * G * D, dt)
            row.update(scores_bound_ms=sb, scores_bound_by=sby,
                       stats_bound_ms=ab, stats_bound_by=aby,
                       pair_bound_ms=pb, pair_bound_by=pby)
            if kept and not cap:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                mask = kept_mask[:, None, None]
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
                row["max_abs_err_vs_sdpa"] = close(
                    pair(), sdpa().transpose(1, 2), tol, name + " vs SDPA")
                row["library_ms"] = timer(sdpa)
            rows.append(row)
        del q1, k1, v1, runs
        torch.cuda.empty_cache()
    check({r["state"] for r in rows if r["run"] == "9v-b"}
          == {"all", "part", "none"}, "ring shard decode: 9v-b shard states")
    return rows


# decode attention at llama3.2-3b's decode shape (B = 8 rows, KV = 8, G = 3,
# D = 128, a 1,024-slot cache) and at the head counts and dims of the queued
# archs (G, D): (1, 64), (4, 120), (5, 128), (8, 128), (2, 256)
DECODE_SHAPES = [(3, 128), (1, 64), (4, 120), (5, 128), (8, 128), (2, 256)]
DECODE_B, DECODE_KV, DECODE_L = 8, 8, 1024


def decode_positions(g, B: int = DECODE_B) -> torch.Tensor:
    """Per-row positions 64..576: rows mid-request, as in phase 4."""
    return torch.randint(64, 577, (B,), generator=g, device="cuda")


def decode_cases(timer, g, dtype, tol, shapes=DECODE_SHAPES, B=DECODE_B,
                 KV=DECODE_KV, L=DECODE_L) -> dict[str, list[dict]]:
    """The two decode kernels against their plain versions at every
    (G, D) of ``shapes`` (B rows of an L-slot cache of KV heads): errors,
    times and bounds (the bytes: each input read once, each output written
    once, K, V and the accumulation's scores only where a slot is kept;
    the scores' s written whole)."""
    from repro_torch.kernels.decode_stats import ops as stats_ops
    from repro_torch.models.attention import NEG_INF
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    rows = {"decode_scores": [], "decode_stats": []}
    for G, D in shapes:
        pos = decode_positions(g, B)
        slots = int((pos + 1).sum())                   # slots the mask keeps
        q, k, v = (rn(B, 1, KV * G, D).to(dtype), rn(B, L, KV, D).to(dtype),
                   rn(B, L, KV, D).to(dtype))
        es = q.element_size()
        what = f"decode_scores {dtype} G={G} D={D}"
        s, m = stats_ops.decode_scores(q, k, pos)
        rs, rm = stats_ops.decode_scores_ref(q, k, pos)
        check(torch.equal(s == NEG_INF, rs == NEG_INF),
              f"{what}: masked slots differ")
        err = max(close(s, rs, tol or 1e-4, what + " s"),
                  close(m, rm, tol or 1e-4, what + " m"))
        nbytes = q.numel() * es + slots * KV * D * es + (s.numel()
                                                         + m.numel()) * 4
        b_ms, b_by = bound(nbytes, 2 * slots * KV * G * D, dtype)
        rows["decode_scores"].append(dict(
            shape=[B, KV, G, L, D], dtype=str(dtype), max_abs_err=err,
            tolerance=tol or 1e-4, positions=pos.tolist(), kept_slots=slots,
            ms=timer(lambda: stats_ops.decode_scores(q, k, pos)),
            host_ms=timer.host_ms(lambda: stats_ops.decode_scores(q, k, pos)),
            plain_ms=timer(lambda: stats_ops.decode_scores_ref(q, k, pos)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))

        s, _ = stats_ops.decode_scores_ref(q.float(), k.float(), pos)
        s[0] = NEG_INF                                 # a fully masked row
        m = s.amax(-1)
        # as the decode path calls it: with the position s was masked with
        o, l = stats_ops.accumulate(s, m, v, pos=pos)
        ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
        what = f"decode_stats {dtype} G={G} D={D}"
        err = max(close(o, ro, tol or 1e-4, what + " o"),
                  close(l, rl, tol or 1e-4, what + " l"))
        err32 = None
        if dtype == torch.bfloat16:       # o and l are fp32 outputs already
            ro32, rl32 = stats_ops.decode_stats_accumulate_ref(s, m, v.float())
            err32 = max(close(o, ro32, what=what + " o vs fp32 plain",
                              **BF16_VS_FP32),
                        close(l, rl32, what=what + " l vs fp32 plain",
                              **BF16_VS_FP32))
        check(float(o[0].abs().max()) == 0.0 and float(l[0].abs().max()) == 0,
              f"{what}: the fully masked row is not 0")
        o2, l2 = stats_ops.accumulate(s, m, v, pos=pos)
        check(torch.equal(o, o2) and torch.equal(l, l2),
              f"{what}: two calls differ")
        o2, l2 = stats_ops.accumulate(s, m, v)         # every slot may count
        err = max(err, close(o2, ro, tol or 1e-4, what + " o, no positions"),
                  close(l2, rl, tol or 1e-4, what + " l, no positions"))
        live = int((pos[1:] + 1).sum())                # V rows the data needs
        # the scores read: the kept slots given the positions, all of s
        # without them
        rest = (m.numel() + o.numel() + l.numel()) * 4 \
            + live * KV * D * v.element_size()
        b_ms, b_by = bound(rest + slots * KV * G * 4, 2 * G * D * KV * live,
                           dtype)
        b0_ms, _ = bound(rest + s.numel() * 4, 2 * G * D * KV * live, dtype)
        rows["decode_stats"].append(dict(
            shape=[B, KV, G, L, D], dtype=str(dtype), max_abs_err=err,
            tolerance=tol or 1e-4, max_abs_err_vs_fp32_plain=err32,
            positions=pos.tolist(),
            ms=timer(lambda: stats_ops.accumulate(s, m, v, pos=pos)),
            ms_without_positions=timer(lambda: stats_ops.accumulate(s, m, v)),
            bound_without_positions_ms=b0_ms,
            host_ms=timer.host_ms(lambda: stats_ops.accumulate(s, m, v,
                                                               pos=pos)),
            plain_ms=timer(lambda: stats_ops.decode_stats_accumulate_ref(
                s, m, v)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del q, k, v, s, m, o, l
    return rows


def decode_pair(timer, g, KV=DECODE_KV, G=DECODE_SHAPES[0][0],
                D=DECODE_SHAPES[0][1]) -> dict:
    """The decode-attention pair (scores kernel, accumulate kernel, o / l)
    at a decode shape in bf16 (llama3.2-3b's by default), beside one
    ``F.scaled_dot_product_attention`` call on the same inputs (the
    library yardstick, timed here only; the port never calls it): q as
    (B,H,1,D) against K and V as (B,KV,L,D), transposed before the timing,
    with the boolean position mask and ``enable_gqa``."""
    import torch.nn.functional as F
    from repro_torch.models.attention import decode_attention
    B, L = DECODE_B, DECODE_L
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    pos = decode_positions(g)
    q, k, v = (rn(B, 1, KV * G, D).to(torch.bfloat16),
               rn(B, L, KV, D).to(torch.bfloat16),
               rn(B, L, KV, D).to(torch.bfloat16))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = (torch.arange(L, device="cuda")[None] <= pos[:, None])[:, None,
                                                                    None]
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    out = decode_attention(q, k, v, pos)
    err = close(out, sdpa().transpose(1, 2), 2e-2,
                "decode attention pair vs SDPA")
    slots = int((pos + 1).sum())
    b_ms, b_by = bound((q.numel() + out.numel() + 2 * slots * KV * D)
                       * q.element_size(), 4 * slots * KV * G * D,
                       torch.bfloat16)
    return dict(shape=[B, KV, G, L, D], dtype=str(torch.bfloat16),
                positions=pos.tolist(), max_abs_err_vs_sdpa=err,
                tolerance=2e-2,
                ms=timer(lambda: decode_attention(q, k, v, pos)),
                host_ms=timer.host_ms(lambda: decode_attention(q, k, v, pos)),
                library_ms=timer(sdpa), bound_ms=b_ms, bound_by=b_by)


# RMSNorm's forms at the serving paths' shapes: (rows, d) at decode (8 rows)
# and prefill (512); llama3.2-3b's d = 3072, mamba2-780m's layer norm 1536
# and gate 3072 (its z a slice of the 6448-wide input projection)
RMS_FORMS = {"plain": [(8, 3072), (512, 3072), (8, 1536), (512, 1536)],
             "residual": [(8, 3072), (512, 3072)],
             "gated": [(8, 3072), (512, 3072)]}
MAMBA_PROJ = 6448


def rmsnorm_case(timer, randn, form, rows, d, dtype, tol) -> dict:
    """One RMSNorm form against its plain version: errors, times, bound
    (each input read once, each output written once; a few flops a value)."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    sc = (randn(d) * 0.2).to(dtype)
    es, what = torch.tensor([], dtype=dtype).element_size(), \
        f"rmsnorm {form} {dtype} ({rows},{d})"
    lib = None
    if form == "plain":
        args = (randn(rows, d).to(dtype), sc)
        fn, plain = rms_ops.rmsnorm, rms_ops.rmsnorm_ref
        nbytes, flops = 2 * rows * d * es, 4 * rows * d
        w = 1.0 + sc
        lib = lambda: F.rms_norm(args[0], (d,), w, 1e-5)
    elif form == "residual":
        args = ((randn(rows, d) * 3).to(dtype), randn(rows, d).to(dtype), sc)
        fn, plain = rms_ops.rmsnorm_residual, rms_ops.rmsnorm_residual_ref
        nbytes, flops = 4 * rows * d * es, 5 * rows * d
    else:
        z = (randn(rows, MAMBA_PROJ) * 2).to(dtype)[:, :d]
        args = (randn(rows, d), z, sc)
        fn, plain = rms_ops.rmsnorm_gated, rms_ops.rmsnorm_gated_ref
        nbytes, flops = rows * d * (4 + 2 * es), 10 * rows * d
    out, ref = fn(*args), plain(*args)
    if form == "residual":
        check(torch.equal(out[0], ref[0]), f"{what}: the sum differs from "
                                           f"the eager add")
        out, ref = out[1], ref[1]
    err = close(out, ref, tol or 1e-5, what)
    err32 = close_fp32(out, plain, args, what) if form == "plain" else None
    b_ms, b_by = bound(nbytes + d * es, flops, dtype)
    return dict(form=form, shape=[rows, d], dtype=str(dtype),
                max_abs_err=err, tolerance=tol or 1e-5,
                max_abs_err_vs_fp32_plain=err32,
                ms=timer(lambda: fn(*args)),
                host_ms=timer.host_ms(lambda: fn(*args)),
                plain_ms=timer(lambda: plain(*args)),
                library_ms=timer(lib) if lib else None,
                bound_ms=b_ms, bound_by=b_by)


# SSD: fp32 outputs whatever the input dtype, held against the plain version
# on the same inputs; the kernel chunks by 64 tokens and the plain version by
# Q, so the bound is the chunk-invariance one of tests/test_kernels.py
SSD_Y_REL_TOL = 1e-4           # max |y - y_ref| / max |y_ref|
SSD_H_REL_TOL = 1e-4           # max |h - h_ref| / max |h_ref|
# (S, H, P, G, N): mamba2-780m prefills (Q = 256: S = 512 two chunks, S = 300
# one ragged chunk, S = 2048 eight) and one G = 2, N = 64 case
SSD_CASES = [(512, 48, 64, 1, 128), (300, 48, 64, 1, 128),
             (2048, 48, 64, 1, 128), (512, 48, 64, 2, 64)]


def ssd_inputs(S, H, P, G, N, dtype, seed=0, batch=1, with_dy=False):
    """Inputs with the model's statistics: dt = softplus(raw + dt_bias)
    with dt_bias from dt in [1e-3, 1e-1], A = -exp(A_log) in [-16, -1];
    with ``with_dy`` an fp32 output gradient after them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    u = lambda n: torch.rand((n,), generator=g, device="cuda")
    dt0 = torch.exp(u(H) * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(rn(batch, S, H) * 0.5 + dt_bias)
    A = -torch.log(1.0 + u(H) * 15.0).exp()
    out = (rn(batch, S, H, P).to(dtype), dt.contiguous(), A.contiguous(),
           (rn(batch, S, G, N) * 0.5).to(dtype),
           (rn(batch, S, G, N) * 0.5).to(dtype))
    return out + (rn(batch, S, H, P),) if with_dy else out


def ssd_cases(timer: Timer) -> list[dict]:
    """The SSD forward at the serving shapes (``SSD_CASES``, one sequence)
    and at 8d's training shape (``TRAIN_SSD``: the forward alone, as the
    training path calls it), bf16 and fp32; last, at one model rank's
    heads of 8f's sequence (``SSM_TIER_SSD``: 24 and 12 heads, bf16)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    rows = []
    shapes = [(1, *c) for c in SSD_CASES]
    for dtype, (Bt, S, H, P, G, N) in [
            (d, c) for d in (torch.bfloat16, torch.float32) for c in shapes
    ] + [(d, TRAIN_SSD) for d in (torch.bfloat16, torch.float32)] + [
            (torch.bfloat16, c) for c in SSM_TIER_SSD]:
        ins = ssd_inputs(S, H, P, G, N, dtype, batch=Bt)
        what = f"ssd {dtype} Bt={Bt} S={S} H={H} P={P} G={G} N={N}"
        y, h = ssd_ops.ssd(*ins, Q=256)
        ry, rh = ssd_ops.ssd_ref(*ins, Q=256)
        y_abs = err_of(y, ry)
        y_rel = y_abs / float(ry.abs().max())
        h_err = err_of(h, rh)
        h_rel = h_err / float(rh.abs().max())
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              f"{what}: non-finite output")
        check(y_rel < SSD_Y_REL_TOL, f"{what}: y rel err {y_rel}")
        check(h_rel < SSD_H_REL_TOL, f"{what}: h rel err {h_rel}")
        del y, h, ry, rh
        es = ins[0].element_size()
        nbytes = Bt * ((S * H * P + 2 * S * G * N) * es + S * H * 4
                       + (S * H * P + H * N * P) * 4) + H * 4
        b_ms, b_by = bound(nbytes, 2 * Bt * ssd_split_macs(
            S, H, P, G, N, dtype), torch.bfloat16)
        # the recurrence (one multiply-add per state element for the
        # update and one for C.h) at the fp32 CUDA-core rate: the bound
        # of the CUDA-core design before this one
        cc_ms, _ = bound(nbytes, 4 * N * P * S * H * Bt, torch.float32)
        rows.append(dict(
            shape=[Bt, S, H, P, G, N], dtype=str(dtype), Q=256,
            path="ssm_tier" if H < SSM_HEADS else
            "serve_full_width_ssm" if Bt == 1 else "train_one_rank_ssm",
            max_abs_err=y_abs, y_rel_err=y_rel, h_abs_err=h_err,
            h_rel_err=h_rel,
            tolerance={"y_rel": SSD_Y_REL_TOL, "h_rel": SSD_H_REL_TOL},
            ms=timer(lambda: ssd_ops.ssd(*ins, Q=256)),
            host_ms=timer.host_ms(lambda: ssd_ops.ssd(*ins, Q=256)),
            plain_ms=timer(lambda: ssd_ops.ssd_ref(*ins, Q=256), iters=3,
                           warmup=1),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            bound_cuda_core_ms=cc_ms,
            split_tensor_core_gflop=2 * Bt * ssd_split_macs(
                S, H, P, G, N, dtype) / 1e9))
        del ins
    torch.cuda.empty_cache()
    return rows


def ssd_split_macs(S, H, P, G, N, dtype) -> int:
    """Multiply-adds of the chunked form in the kernel's 64-token chunks,
    each times its split terms: per chunk the score's causal half once per
    group, and per head L x's causal half, C h and B^T (w x). bf16 inputs
    enter exactly (the score 1 term, the others 2: one fp32 operand split
    into hi and lo); fp32 inputs take 3 terms everywhere."""
    Q = 64
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    one, two = (1, 2) if dtype == torch.bfloat16 else (3, 3)
    return nc * (G * tri * N * one + H * (tri * P + 2 * Q * N * P) * two)


# ---------------------------------------------------------------------------
# phase 2b: the DMA allgather on the card
# ---------------------------------------------------------------------------
DMA_ALGORITHMS = ("bruck", "ring", "multilane", "locality_bruck")


def dma_cases_of(cfg) -> list[tuple[str, int, int, int, torch.dtype]]:
    """(case, q, pl, shard elements, dtype): one decoder layer of ``cfg``
    (q, k, v, o, gate, up, down and the two norms) sharded over p ranks,
    and 1 KiB fp32 shards over 64 ranks."""
    d, hd = cfg.d_model, cfg.head_dim_
    layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + cfg.n_heads * hd * d + 3 * d * cfg.d_ff + 2 * d)
    return [("fsdp_layer_p16", 4, 4, layer // 16, torch.bfloat16),
            ("fsdp_layer_p12", 3, 4, layer // 12, torch.bfloat16),
            ("small_p64", 8, 8, 256, torch.float32)]


def dma_allgather_cases(timer: Timer, cases) -> list[dict]:
    from repro_torch.kernels.dma_allgather import ops as dma_ops
    rows = []
    for case, q, pl, n, dtype in cases:
        p = q * pl
        g = torch.Generator(device="cuda").manual_seed(p)
        x = torch.randn((p, n), generator=g, device="cuda").to(dtype)
        for alg in DMA_ALGORITHMS:
            sched = dma_ops.build_schedule(
                alg, p, None if alg in ("bruck", "ring") else pl)
            what = f"dma_allgather {alg} {case}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held, before = torch.cuda.memory_allocated(), dma_ops.LAUNCHES
            out = dma_ops.dma_allgather(x, sched)
            torch.cuda.synchronize()
            launches = dma_ops.LAUNCHES - before
            peak = torch.cuda.max_memory_allocated() - held
            check(launches == 1, f"{what}: {launches} launches per gather")
            plain = dma_ops.dma_allgather_ref(x, sched)
            check(torch.equal(out, plain), f"{what}: kernel != plain version")
            del plain                   # equal, so the max abs error is 0
            check(torch.equal(out, x.unsqueeze(0).expand(p, p, n)),
                  f"{what}: not every shard on every rank")
            del out
            b_ms, b_by = bound((p * n + p * p * n) * x.element_size(), 0,
                               dtype)
            rows.append(dict(
                case=case, algorithm=alg, shape=[p, n], q=q, pl=pl,
                dtype=str(dtype), rounds=len(sched.sizes),
                launches_per_gather=launches, capacity=sched.capacity,
                spill_slots=sched.spill, peak_bytes_per_gather=peak,
                out_bytes=p * p * n * x.element_size(),
                max_abs_err=0.0, tolerance=0.0,
                ms=timer(lambda: dma_ops.dma_allgather(x, sched)),
                host_ms=timer.host_ms(lambda: dma_ops.dma_allgather(x, sched),
                                      iters=10),
                plain_ms=timer(lambda: dma_ops.dma_allgather_ref(x, sched),
                               iters=3, warmup=1),
                library_ms=timer(lambda: x.unsqueeze(0).expand(
                    (p,) + x.shape).contiguous()),
                bound_ms=b_ms, bound_by=b_by))
        del x
        torch.cuda.empty_cache()
    return rows


def dma_main_path(case) -> int:
    """The slice's main path once: the FSDP gather of one decoder layer
    over 16 ranks through ``dma_locality_allgather``; its launches."""
    from repro_torch.kernels.dma_allgather import ops as dma_ops
    _, q, pl, n, dtype = case
    p = q * pl
    x = torch.randn((p, n), generator=torch.Generator(device="cuda")
                    .manual_seed(1), device="cuda").to(dtype)
    dma_ops.LAUNCHES = 0
    out = dma_ops.dma_locality_allgather(x, q, pl)
    torch.cuda.synchronize()
    launches = dma_ops.LAUNCHES
    check(launches == 1, f"dma main path: {launches} launches, the path "
                         f"implies 1 (one cooperative kernel per gather)")
    check(torch.equal(out, x.unsqueeze(0).expand(p, p, n)),
          "dma main path: not every shard on every rank")
    del out, x
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "dma_main_path", "q": q, "pl": pl, "shard": n,
                      "dtype": str(dtype), "launches": launches}))
    return launches


# ---------------------------------------------------------------------------
# phase 3: the reduced model on the CPU (plain) and on the card (kernels)
# ---------------------------------------------------------------------------
def small_end_to_end(arch: str, n_layers: int) -> None:
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.serve import Engine, Request, ServeSpec, StepClock

    cfg = dataclasses.replace(configs.get_smoke(arch), n_layers=n_layers,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu, gpu = Transformer(cfg, params, "cpu"), Transformer(cfg, params, "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    lc, cc = cpu(toks, mode="prefill", cache_len=64)
    lg, cg = gpu(toks.cuda(), mode="prefill", cache_len=64)
    worst = 0.0
    for step in range(9):
        worst = max(worst, close(lg.cpu(), lc, 1e-3, f"small model step {step}"))
        nxt_c = lc[:, -1].argmax(-1)
        check(torch.equal(nxt_c, lg[:, -1].argmax(-1).cpu()),
              f"small model: greedy tokens differ at step {step}")
        if step < 8:
            lc, cc = cpu(nxt_c[:, None], mode="decode", cache=cc)
            lg, cg = gpu(nxt_c[:, None].cuda(), mode="decode", cache=cg)

    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, n), m)
            for n, m in [(9, 6), (30, 4), (17, 8), (5, 5), (21, 3)]]
    out = []
    for device in ("cpu", "cuda"):
        eng = Engine(cfg, params, ServeSpec(batch=3, cache_len=64),
                     device=device, clock=StepClock())
        for t, m in reqs:
            eng.submit(Request(tokens=t, max_new=m))
        out.append({rid: r.tokens.tolist() for rid, r in eng.drain().items()})
    check(out[0] == out[1], f"small engine tokens differ: {out}")
    print(json.dumps({"phase": "small_end_to_end", "model": cfg.name,
                      "layers": cfg.n_layers,
                      "max_abs_logit_err": worst, "decode_steps": 8,
                      "engine_requests": len(reqs), "tokens_equal": True}))


# ---------------------------------------------------------------------------
# phases 4 and 5: llama3.2-3b and mamba2-780m at full width
# ---------------------------------------------------------------------------
# the kernels the serving paths run, by their names in
# ``repro_torch.kernels.launch_counts``
PATH_KERNELS = ("rmsnorm", "flash_attention", "decode_scores", "decode_stats",
                "ssd")


def _tier_split(cfg, st: dict) -> bool:
    """Whether the engine whose stats are ``st`` splits the gated norm over
    a model tier (the ssm family on a tier: two launches a norm)."""
    return cfg.family == "ssm" and "tier_calls" in st


def _sandwich(cfg) -> int:
    """The plain post-norms a forward runs for the sandwich (2 a layer)
    and for qk-norm (q and k of every attention layer)."""
    attn = sum(s.mixer == "attn" for s in cfg.layer_plan())
    return ((2 * cfg.n_layers if cfg.sandwich_norm else 0)
            + (2 * attn if cfg.qk_norm else 0))


def launches_implied(cfg, st: dict) -> dict[str, int]:
    """What the serving path must launch for the engine's counts: rmsnorm
    2 per layer + the final norm per forward (a Mamba2 layer's gated norm
    split over a model tier 2 launches; a sandwich layer's two post-norms
    2 more, qk-norm's q and k 2 more); per attention layer flash once per
    prefill, decode scores and
    decode stats once per decode step (each step one replay of the
    captured decode graph); per Mamba2 layer ssd once per prefill."""
    attn = sum(s.mixer == "attn" for s in cfg.layer_plan())
    mamba = sum(s.mixer == "mamba2" for s in cfg.layer_plan())
    split = mamba if _tier_split(cfg, st) else 0
    return {"rmsnorm": (2 * cfg.n_layers + 1 + split + _sandwich(cfg))
            * (st["prefills"] + st["decode_steps"]),
            "flash_attention": attn * st["prefills"],
            "decode_scores": attn * st["decode_steps"],
            "decode_stats": attn * st["decode_steps"],
            "ssd": mamba * st["prefills"]}


RMS_FORM_NAMES = ("plain", "residual", "gated", "gated_rowsq",
                  "gated_finish")
# the dense variants' and llama4's instances, inside the counts of
# PATH_KERNELS: flash at head dim 120, the decode pair over a ring cache
# (a window or a chunked layer's)
VARIANT_KERNELS = ("flash_attention_d120", "decode_scores_ring",
                   "decode_stats_ring")


def variant_launches_implied(cfg, st: dict) -> dict[str, int]:
    """Of the path's launches, flash at D = 120 once per attention layer
    and prefill (h2o-danube), the decode pair over a ring once per window
    or chunked layer and decode step."""
    from repro_torch.models.transformer import ring_cache_len
    plan = cfg.layer_plan()
    attn = sum(s.mixer == "attn" for s in plan)
    ring = sum(ring_cache_len(cfg, s) is not None for s in plan)
    return {"flash_attention_d120":
            attn * st["prefills"] if cfg.head_dim_ == 120 else 0,
            "decode_scores_ring": ring * st["decode_steps"],
            "decode_stats_ring": ring * st["decode_steps"]}


def rmsnorm_forms_implied(cfg, st: dict) -> dict[str, int]:
    """Per forward: ln1 of every layer and the final norm plain (and a
    sandwich layer's two post-norms, an attention layer's qk-norm of q and
    k); ln2 of an attention layer fused with
    the residual add before it; a Mamba2 layer's gated norm fused with its
    gate (on a model tier split over it: the rows' partial sums of squares
    and the finish)."""
    attn = sum(s.mixer == "attn" for s in cfg.layer_plan())
    mamba = sum(s.mixer == "mamba2" for s in cfg.layer_plan())
    fwd = st["prefills"] + st["decode_steps"]
    split = _tier_split(cfg, st)
    return {"plain": (cfg.n_layers + 1 + _sandwich(cfg)) * fwd,
            "residual": attn * fwd,
            "gated": 0 if split else mamba * fwd,
            "gated_rowsq": mamba * fwd if split else 0,
            "gated_finish": mamba * fwd if split else 0}


def serve_full_width(smi: str, arch: str, phase: str, cache_len: int = 1024,
                     extra: tuple = (), layers: int | None = None,
                     batch: int = 8, n_random: int = 16) -> dict[str, int]:
    """Serve ``n_random`` requests on ``arch`` at its published size (its
    first ``layers`` layers where given), and the ``extra`` (prompt
    length, new tokens) requests after them, at ``batch`` rows and
    ``cache_len`` slots; returns the path's launches per kernel (and its
    ring instances)."""
    from repro_torch import configs, kernels
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec

    cfg = configs.get(arch)
    depth = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eng = Engine(cfg, params, ServeSpec(batch=batch, cache_len=cache_len))
    del params
    n_params = sum(p.numel() for p in eng.model.parameters())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # prefills run the forward; each decode step replays the decode graph
    forward, decode, calls = eng.model.forward, eng.scheduler._decode, []
    graph, spans = eng.scheduler._graph, []

    def timed_replay():          # events on the stream around the replay
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        logits = type(graph).replay(graph)
        b.record()
        spans.append((a, b))
        return logits

    def timed_forward(tokens, mode="prefill", **kw):
        a = time.perf_counter()
        logits, cache = forward(tokens, mode=mode, **kw)
        finite = bool(torch.isfinite(logits).all())      # synchronises
        calls.append((mode, time.perf_counter() - a, finite))
        return logits, cache

    def timed_decode():
        a = time.perf_counter()
        logits = decode()
        finite = bool(torch.isfinite(logits).all())      # synchronises
        calls.append(("decode", time.perf_counter() - a, finite))
        return logits

    eng.model.forward = timed_forward
    eng.scheduler._decode = timed_decode
    graph.replay = timed_replay
    rng = np.random.default_rng(0)
    warm = Request(tokens=rng.integers(0, cfg.vocab_size, 64), max_new=4)
    eng.submit(warm)                                     # cuBLAS, allocator
    eng.drain()
    base, calls[:], spans[:] = eng.stats(), [], []

    lens = rng.integers(64, 513, n_random)
    budgets = rng.integers(16, 65, n_random)
    if extra:
        lens = np.concatenate([lens, [n for n, _ in extra]])
        budgets = np.concatenate([budgets, [m for _, m in extra]])
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n), max_new=int(m))
            for n, m in zip(lens, budgets)]
    kernels.add_launch_counts(kernels.launch_counts(), -1)   # all to 0
    t0 = time.perf_counter()
    rids = [eng.submit(r) for r in reqs]
    results = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()       # serving's, before checks
    counts = kernels.launch_counts()
    launches = {name: counts[name] for name in PATH_KERNELS}
    by_form = {form: counts[f"rmsnorm.{form}"]
               for form in RMS_FORM_NAMES}
    variant = {name: counts[name] for name in VARIANT_KERNELS}

    st = {k: v - base[k] for k, v in eng.stats().items()
          if k in ("decode_steps", "prefills", "prefill_tokens",
                   "decode_tokens")}
    for rid, r in zip(rids, reqs):
        res = results[rid]
        check(res.n_tokens == r.max_new, f"request {rid}: {res.n_tokens} "
                                         f"tokens, budget {r.max_new}")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
              f"request {rid}: token out of range")
    check(all(f for _, _, f in calls), "non-finite logits in a step")
    want = launches_implied(cfg, st)
    check(launches == want, f"{phase}: launch counts {launches}, the path "
                            f"implies {want}")
    want_forms = rmsnorm_forms_implied(cfg, st)
    check(by_form == want_forms, f"{phase}: rmsnorm forms {by_form}, the "
                                 f"path implies {want_forms}")
    want_variant = variant_launches_implied(cfg, st)
    check(variant == want_variant, f"{phase}: variant instances {variant}, "
                                   f"the path implies {want_variant}")
    check(st["prefills"] == len(reqs)
          and st["prefill_tokens"] == int(lens.sum())
          and st["decode_tokens"] == int((budgets - 1).sum()),
          f"engine stats {st}")

    eng.model.forward, eng.scheduler._decode = forward, decode
    del graph.replay
    check(len(spans) == st["decode_steps"], f"{phase}: {len(spans)} replays "
                                            f"timed, {st['decode_steps']} steps")
    replay_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    ring_len = eng.model.ring_len(cache_len)
    checks = {}
    if cfg.family == "moe":
        checks = moe_decode_checks(eng, reqs, [results[r] for r in rids],
                                   cfg, phase)
    elif cfg.family == "dense" and arch != "llama3.2-3b":
        checks = graph_eager_checks(eng, cfg, phase, ring_len or cache_len,
                                    bool(ring_len))
    if ring_len:              # which requests rolled or crossed the ring
        checks["ring_len"] = ring_len
        checks["long_requests"] = [
            {"prompt": int(n), "new": int(m), "last_position": int(n + m - 2),
             "prefill_rolled": bool(n > ring_len),
             "decode_crossed_wrap": bool(n <= ring_len <= n + m - 2)}
            for n, m in extra]
        check(any(r["prefill_rolled"] for r in checks["long_requests"])
              and any(r["decode_crossed_wrap"]
                      for r in checks["long_requests"]),
              f"{phase}: no request rolled or crossed the {ring_len}-slot "
              "ring")
    profile_serving(eng, reqs, phase, cache_len=cache_len)
    prefill_s = sum(t for mode, t, _ in calls if mode == "prefill")
    decode_s = sum(t for mode, t, _ in calls if mode == "decode")
    print(json.dumps({
        "phase": phase, "model": cfg.name, "params": n_params,
        "layers": cfg.n_layers,
        **({"reduced": f"depth {depth} -> {cfg.n_layers} layers (card "
                       "memory)"} if layers else {}),
        "batch": batch, "cache_len": cache_len, "requests": len(reqs),
        "prompt_tokens": st["prefill_tokens"],
        "generated_tokens": int(budgets.sum()),
        "decode_steps": st["decode_steps"], "decode": "cuda_graph",
        "graph_launches_per_step": eng.scheduler._graph.launches,
        "wall_s": wall,
        "setup_s": setup_s,
        "prefill_tok_s": st["prefill_tokens"] / prefill_s,
        "decode_tok_s": st["decode_tokens"] / decode_s,
        "decode_step_ms_mean": decode_s / st["decode_steps"] * 1e3,
        "decode_replay_device_ms_mean": replay_s / st["decode_steps"] * 1e3,
        "decode_device_idle_share": 1 - replay_s / decode_s,
        "prefill_ms_mean": prefill_s / st["prefills"] * 1e3,
        "prefill_ms_in_order": [t * 1e3 for mode, t, _ in calls
                                if mode == "prefill"],
        "max_memory_allocated": peak,
        "launches": launches, "rmsnorm_forms": by_form,
        **({"variant_instances": variant} if any(variant.values()) else {}),
        **checks, "card": smi}))
    return launches | variant


GRAPH_EAGER_STEPS = 6
# phase 4v: (arch, phase, cache_len, extra (prompt, new) requests)
VARIANT_LONG = ((6000, 16), (4000, 200))
VARIANT_RUNS = (("yi-6b", "serve_full_width_yi", 1024, ()),
                ("h2o-danube-3-4b", "serve_full_width_danube", 8192,
                 VARIANT_LONG),
                ("gemma2-9b", "serve_full_width_gemma2", 8192, VARIANT_LONG))


def graph_eager_checks(eng, cfg, phase: str, limit: int, ring: bool,
                       steps: int = GRAPH_EAGER_STEPS) -> dict:
    """The decode graph against eager decoding over ``steps`` steps that
    take a long request across a ring's wrap (``ring``: its prompt
    ``limit`` - 3 tokens, ``limit`` the ring's slots; else up to the
    ``limit``-slot cache's end) beside 7 short ones: before each replay the
    eager forward runs on a copy of the cache, and the logits and every
    cache leaf must be bitwise equal, so the tokens are too."""
    from repro_torch.serve import Request
    sched = eng.scheduler
    rng = np.random.default_rng(5)
    rids = [eng.submit(Request(tokens=rng.integers(0, cfg.vocab_size, n),
                               max_new=steps + 1))
            for n in [limit - 3 if ring else limit - steps - 1] + [16] * 7]
    replay, positions = sched._decode, []

    def checked():
        cache = {name: t.clone() for name, t in sched._cache.items()}
        positions.append(int(cache["pos"][sched.active[rids[0]].row]))
        tok = torch.from_numpy(sched._tok).to(eng.model.device)
        want, _ = eng.model(tok, mode="decode", cache=cache)
        got = replay()
        check(torch.equal(got, want), f"{phase}: the graph's logits differ "
                                      f"from the eager step's at step "
                                      f"{len(positions)}")
        for name, t in cache.items():
            check(torch.equal(sched._cache[name], t),
                  f"{phase}: the graph's cache leaf {name} differs")
        del cache
        return got

    sched._decode = checked
    try:
        eng.drain()
    finally:
        sched._decode = replay
    check(len(positions) == steps, f"{phase}: {len(positions)} checked "
                                   f"steps, want {steps}")
    crossed = ring and positions[0] < limit <= positions[-1]
    check(crossed or not ring, f"{phase}: the checked steps did not cross "
                               f"the {limit}-slot ring's wrap: {positions}")
    return {"graph_tokens_equal_eager": True, "graph_eager_steps": steps,
            "graph_eager_long_positions": positions,
            "graph_eager_crossed_wrap": crossed}


# phase 4v's exactness check: h2o-danube-3-4b and gemma2-9b at full width,
# 2 layers, fp32; one request whose decode crosses the window's 4,096-slot
# ring in the engine (kernels, ring cache, decode graph), its logits held
# against a plain full-sequence forward on the card with no ring (the whole
# sequence, the window mask, the kernels' plain versions)
VARIANT_EXACT = ("h2o-danube-3-4b", "gemma2-9b")
VARIANT_EXACT_REQUEST = (4090, 12)   # prompt, new tokens: positions to 4100
VARIANT_EXACT_TOL = 1e-3             # max |logit - plain logit|, fp32


def plain_full_forward(model, tokens: torch.Tensor, first: int
                       ) -> torch.Tensor:
    """``model``'s logits at positions ``first``.. of ``tokens`` (1, S)
    from one full-sequence pass of the plain versions: RMSNorm's
    ``rmsnorm_ref`` forms (qk-norm's too), ``attention_ref`` with each
    layer's window, chunk and cap over the whole sequence (no rotary
    embedding on a NoPE layer), a MoE layer's experts as the engine runs
    them; no cache, no ring, no kernel."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_ref,
                                                 rmsnorm_residual_ref)
    from repro_torch.models.layers import rope_angles, softcap
    from repro_torch.models.transformer import attn_qkv, out_mlp, out_moe
    cfg = model.cfg
    S = tokens.shape[1]
    x = model.embed[tokens]
    if model.embed_scale is not None:
        x = x * model.embed_scale
    cos, sin = rope_angles(torch.arange(S, device=tokens.device)[None],
                           cfg.head_dim_, cfg.rope_theta)
    for layer in model.layers:
        w = layer._parameters
        q, k, v = attn_qkv(x, w, cos, sin, cfg, norm=rmsnorm_ref,
                           rope=layer.rope)
        o = attention_ref(q, k, v, causal=True, window=layer.meta["window"],
                          chunk=layer.meta["chunk"], cap=layer.meta["cap"])
        if layer.moe:
            x = out_moe(x, o, w, cfg, norm_residual=rmsnorm_residual_ref)[0]
        else:
            x = out_mlp(x, o, w, cfg, norm_residual=rmsnorm_residual_ref,
                        norm=rmsnorm_ref)
    x = rmsnorm_ref(x[:, first:], model.final_norm, eps=cfg.norm_eps)
    head = model.embed.T if model.head is None else model.head
    return softcap(x @ head, cfg.final_softcap)


def variant_exact_check(smi: str, arch: str) -> None:
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec
    cfg = dataclasses.replace(configs.get(arch), n_layers=2,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eng = Engine(cfg, params, ServeSpec(batch=2, cache_len=8192))
    del params
    n, new = VARIANT_EXACT_REQUEST
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, n)
    sched, seen = eng.scheduler, []
    pick = sched._next_token

    def record(logits):
        seen.append(logits[:, -1].clone())
        return pick(logits)

    sched._next_token = record
    rid = eng.submit(Request(tokens=prompt, max_new=new))
    res = eng.drain()[rid]
    sched._next_token = pick
    st = eng.stats()
    ring = eng.model.ring_len(8192)
    check(st["decode_graph"] and len(seen) == new,
          f"{arch} exact: {len(seen)} logits recorded, graph "
          f"{st['decode_graph']}")
    got = torch.stack([seen[0][0]] + [t[res.slot] for t in seen[1:]])
    full = np.concatenate([prompt, res.tokens[:-1]])
    want = plain_full_forward(eng.model, torch.from_numpy(full)[None].to(
        "cuda"), n - 1)[0]
    err = float((got - want).abs().max())
    plain_tok = torch.clamp(want.argmax(-1), max=cfg.vocab_size - 1)
    same = plain_tok.cpu().numpy().tolist() == res.tokens.tolist()
    check(err <= VARIANT_EXACT_TOL, f"{arch} exact: engine logits {err} "
                                    f"from the plain forward's")
    check(same, f"{arch} exact: engine tokens {res.tokens.tolist()}, plain "
                f"{plain_tok.tolist()}")
    print(json.dumps({
        "phase": "serve_variant_exact", "model": cfg.name, "layers": 2,
        "d_model": cfg.d_model, "dtype": "float32", "prompt": n, "new": new,
        "ring_len": ring, "positions": [n - 1, n + new - 2],
        "crossed_wrap": n - 1 < ring <= n + new - 2,
        "decode_graph": st["decode_graph"], "max_abs_logit_err": err,
        "tolerance": VARIANT_EXACT_TOL, "tokens_equal": same,
        "card": smi}))
    del eng


def moe_decode_checks(eng, reqs, results, cfg, phase: str) -> dict:
    """The MoE engine's decode graph against eager decoding: the same
    requests again with the scheduler's graph set aside, every token equal
    to the replayed run's; and what a decode step must read: at S = 1 each
    row has K slots in every expert (capacity K), so the batched expert
    products read every expert's weights each step, with the attention,
    shared experts, router and head: the bound at the card's memory rate."""
    from repro_torch.models.moe import d_expert, d_shared
    from repro_torch.serve import Request
    sched = eng.scheduler
    graph, sched._graph = sched._graph, None
    base = eng.stats()["decode_steps"]
    t0 = time.perf_counter()
    rids = [eng.submit(Request(tokens=r.tokens, max_new=r.max_new))
            for r in reqs]
    eager = eng.drain()
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    steps = eng.stats()["decode_steps"] - base
    sched._graph = graph
    same = [bool(np.array_equal(eager[rid].tokens, res.tokens))
            for rid, res in zip(rids, results)]
    check(all(same), f"{phase}: the graph's tokens differ from the eager "
                     f"decode's in requests "
                     f"{[i for i, ok in enumerate(same) if not ok]}")
    d, L, E = cfg.d_model, cfg.n_layers, cfg.n_experts
    es = torch.empty((), dtype=cfg.dtype).element_size()
    hq = cfg.n_heads * cfg.head_dim_
    hkv = cfg.n_kv_heads * cfg.head_dim_
    experts = L * E * 3 * d * d_expert(cfg) * es
    rest = L * ((2 * d * hq + 2 * d * hkv) + 3 * d * d_shared(cfg)
                + d * E) * es + d * cfg.padded_vocab * es
    return {"graph_tokens_equal_eager": True,
            "eager_decode_wall_s": eager_s, "eager_decode_steps": steps,
            "expert_bytes_per_decode_step": experts,
            "expert_read_bound_ms": experts / HBM_BYTES_PER_S * 1e3,
            "weight_bytes_per_decode_step": experts + rest,
            "weight_read_bound_ms": (experts + rest) / HBM_BYTES_PER_S * 1e3,
            "capacity_decode": cfg.top_k, "slots_per_row": E * cfg.top_k}


# ---------------------------------------------------------------------------
# phase 4l: llama4-scout-17b-a16e at full width on one H100
# ---------------------------------------------------------------------------
# d_model 5,120, 40/8 heads of 128, 16 routed experts at sigmoid top-1 and
# one shared expert of 8,192, vocabulary 202,048, untied head; cut to 8 of
# its 48 layers, two iRoPE periods (three chunked-local layers, chunk
# 8,192, then one global NoPE layer): ~19.7 B parameters, ~39.4 GB in
# bf16 (48 layers would hold ~216 GB). 16,384 slots: the NoPE layers' full
# cache, the chunked layers' rings of 8,192. Four requests: one 9,000-token
# prompt, which rolls the rings at prefill, and three that end a few tokens
# before 8,192, whose decode crosses the chunk boundary (the rings then
# keep the new chunk's slots alone)
LLAMA4 = "llama4-scout-17b-a16e"
LLAMA4_LAYERS, LLAMA4_CACHE, LLAMA4_BATCH = 8, 16384, 4
LLAMA4_REQUESTS = ((9000, 12), (8185, 12), (8188, 10), (8190, 8))
LLAMA4_CHUNK = 8192
# the reduced fp32 llama4 of the exactness check and of phase 9l: the
# reduced config (chunk 64, 8 experts, d_model 128) at the real head dim
# and G = 5 (10/2 heads of 128), 4 layers (3 chunked, 1 NoPE); a capacity
# factor of 64, so that no expert drops a token in the engine's prefill
# and decode or in the plain full-sequence forward (whose capacity comes
# from the whole sequence)
LLAMA4_EXACT_REQUESTS = ((60, 12), (150, 8))  # across 64; past 128, rolled
# phase 4l's kernel cases: flash at the 9,000-token prefill with the chunk
# (SDPA with the boolean mask of the kept pairs); the decode pair at 4l's
# decode (4 rows, KV = 8, G = 5, D = 128) on an 8,192-slot chunked ring
# before and after the boundary, and a B = 1 ring's first two 2,048-slot
# shards at 9l's position 8,300 (part kept, none kept); RMSNorm at
# qk-norm's rows: 9,000 tokens x 40 and x 8 heads, and 4 rows x 40 and x 8
LLAMA4_FLASH = (9000, 40, 8, 128)
LLAMA4_DECODE = (8, 5, 128)
LLAMA4_DECODE_POS = {"before": (8180, 8192), "after": (8192, 8210)}
LLAMA4_SHARD_POS, LLAMA4_SHARDS = 8300, 4
LLAMA4_RMS_ROWS = (9000 * 40, 9000 * 8, 4 * 40, 4 * 8)


def llama4_reduced(n_layers: int = 4):
    """The reduced fp32 llama4 (chunk 64) at head dim 128 with 10/2 heads
    (G = 5) and a capacity factor of 64."""
    from repro_torch import configs
    from repro_torch.configs import reduced
    return dataclasses.replace(
        reduced(configs.get(LLAMA4), head_dim=128, n_heads=10, n_kv_heads=2,
                capacity_factor=64.0),
        n_layers=n_layers, dtype=torch.float32)


def llama4_kernel_cases(timer) -> dict[str, list[dict]]:
    """Phase 4l's kernel cases (above), bf16, phase 2's tolerances; SDPA
    where it computes the same function, ``F.rms_norm`` beside RMSNorm."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(13)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf16, tol = torch.bfloat16, 2e-2
    S, H, KV, D = LLAMA4_FLASH
    mask = dict(causal=True, chunk=LLAMA4_CHUNK)
    row = flash_case(timer, randn, S, H, KV, D, mask, bf16, tol)
    q, k, v = (randn(1, S, n, D).to(bf16).transpose(1, 2)
               for n in (H, KV, KV))
    pos = torch.arange(S, device="cuda")
    seen = (pos[:, None] >= pos[None]) & \
        (pos[:, None] // LLAMA4_CHUNK == pos[None] // LLAMA4_CHUNK)
    row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=seen, enable_gqa=True))
    row["library"] = "sdpa, boolean mask"
    del q, k, v, seen
    torch.cuda.empty_cache()
    out = {"flash_attention": [dict(row, model=LLAMA4)],
           "rmsnorm": [dict(rmsnorm_case(timer, randn, "plain", rows, D,
                                         bf16, tol), model=LLAMA4,
                            use="qk-norm")
                       for rows in LLAMA4_RMS_ROWS],
           "decode_scores": [], "decode_stats": [], "decode_attention": []}
    for r in chunk_ring_decode_cases(timer, g):
        for name in ("decode_scores", "decode_stats", "decode_attention"):
            out[name].append(r[name])
    for rows in out.values():
        for r in rows:
            r["path"] = "serve_llama4"
    return out


def chunk_ring_decode_cases(timer, g) -> list[dict[str, dict]]:
    """Both decode kernels on llama4's chunked ring against their plain
    versions (phase 2's tolerances; the masked slots exactly NEG_INF, a
    shard that keeps none (NEG_INF, 0, 0)); each timed with its bound (the
    kept slots' K and V rows), the pair beside SDPA with the kept slots as
    a boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_stats import ops as stats_ops
    from repro_torch.models.attention import NEG_INF
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dt, es, tol, T = torch.bfloat16, 2, 2e-2, LLAMA4_CHUNK
    KV, G, D = LLAMA4_DECODE
    B = LLAMA4_BATCH
    runs = [(f"ring {state}", rn(B, 1, KV * G, D).to(dt),
             rn(B, T, KV, D).to(dt), rn(B, T, KV, D).to(dt),
             torch.randint(lo, hi, (B,), generator=g, device="cuda"), 0)
            for state, (lo, hi) in LLAMA4_DECODE_POS.items()]
    L = T // LLAMA4_SHARDS
    q1, k1, v1 = (rn(1, 1, KV * G, D).to(dt), rn(1, T, KV, D).to(dt),
                  rn(1, T, KV, D).to(dt))
    runs += [(f"shard {i}", q1, k1[:, i * L:(i + 1) * L],
              v1[:, i * L:(i + 1) * L],
              torch.tensor(LLAMA4_SHARD_POS, device="cuda"), i * L)
             for i in range(2)]
    rows = []
    for what, q, k, v, pos, off in runs:
        kw = dict(slot_offset=off, total_len=T, chunk=LLAMA4_CHUNK,
                  ring=True)
        Bq, Lk = k.shape[:2]
        name = f"chunked ring decode {what} B={Bq} L={Lk} pos {pos.tolist()}"
        s, m = stats_ops.decode_scores(q, k, pos, **kw)
        rs, rm = stats_ops.decode_scores_ref(q, k, pos, **kw)
        check(torch.equal(s == NEG_INF, rs == NEG_INF),
              f"{name}: masked slots differ")
        err_s = max(close(s, rs, tol, name + " s"),
                    close(m, rm, tol, name + " m"))
        o, l = stats_ops.accumulate(s, m, v, pos=pos, **kw)
        ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
        err_o = max(close(o, ro, tol, name + " o"),
                    close(l, rl, tol, name + " l"))
        kept_mask = rs[:, 0, 0] > NEG_INF                 # (B, L)
        kept = int(kept_mask.sum())
        want = sum(min(max(int(p_) % LLAMA4_CHUNK - off + 1, 0), Lk)
                   for p_ in pos.reshape(-1).tolist() * (Bq // pos.numel()))
        check(kept == want, f"{name}: {kept} slots kept, the chunk's "
                            f"{want}")
        if kept == 0:
            check(bool((m == NEG_INF).all()) and float(o.abs().max()) == 0
                  and float(l.abs().max()) == 0,
                  f"{name}: a shard with no slot kept is not (NEG_INF, 0, 0)")

        def pair():
            s_, m_ = stats_ops.decode_scores(q, k, pos, **kw)
            o_, l_ = stats_ops.accumulate(s_, m_, v, pos=pos, **kw)
            return o_, l_

        sb, sby = bound(q.numel() * es + kept * KV * D * es
                        + (s.numel() + m.numel()) * 4,
                        2 * kept * KV * G * D, dt)
        ab, aby = bound(kept * KV * (G * 4 + D * es)
                        + (m.numel() + o.numel() + l.numel()) * 4,
                        2 * kept * KV * G * D, dt)
        pb, pby = bound((q.numel() + o.numel()) * es + 2 * kept * KV * D
                        * es, 4 * kept * KV * G * D, dt)
        meta = dict(shape=[Bq, KV, G, Lk, D], dtype=str(dt), run=what,
                    positions=pos.reshape(-1).tolist(), slot_offset=off,
                    total_len=T, chunk=LLAMA4_CHUNK, kept_slots=kept,
                    state=("none" if kept == 0 else "all"
                           if kept == Bq * Lk else "part"), tolerance=tol,
                    model=LLAMA4)
        row = {"decode_scores": dict(
            meta, max_abs_err=err_s,
            ms=timer(lambda: stats_ops.decode_scores(q, k, pos, **kw)),
            host_ms=timer.host_ms(lambda: stats_ops.decode_scores(
                q, k, pos, **kw)),
            plain_ms=timer(lambda: stats_ops.decode_scores_ref(q, k, pos,
                                                               **kw)),
            library_ms=None, bound_ms=sb, bound_by=sby)}
        row["decode_stats"] = dict(
            meta, max_abs_err=err_o,
            ms=timer(lambda: stats_ops.accumulate(s, m, v, pos=pos, **kw)),
            host_ms=timer.host_ms(lambda: stats_ops.accumulate(
                s, m, v, pos=pos, **kw)),
            plain_ms=timer(lambda: stats_ops.decode_stats_accumulate_ref(
                s, m, v)),
            library_ms=None, bound_ms=ab, bound_by=aby)
        lib_ms = err_pair = None
        if kept:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            amask = kept_mask[:, None, None]
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask, enable_gqa=True)
            o_, l_ = pair()
            err_pair = close((o_ / l_[..., None]).to(dt),
                             sdpa().transpose(1, 2), tol, name + " vs SDPA")
            lib_ms = timer(sdpa)
        row["decode_attention"] = dict(
            meta, ms=timer(pair), max_abs_err_vs_sdpa=err_pair,
            library_ms=lib_ms, bound_ms=pb, bound_by=pby)
        rows.append(row)
    check({r["decode_scores"]["state"] for r in rows}
          >= {"part", "none"}, "chunked ring decode: the states "
          f"{[r['decode_scores']['state'] for r in rows]}")
    return rows


def serve_llama4(smi: str) -> dict[str, int]:
    """Phase 4l: llama4-scout at full width, 8 layers, through
    ``serve_full_width`` with the four requests above alone: launches
    checked against the path (its chunked rings the ring instances), the
    graph's tokens against eager decoding (``moe_decode_checks``), a
    profiled prefill and decode window. Returns the path's launches per
    kernel and its ring instances."""
    return serve_full_width(smi, LLAMA4, "serve_llama4", LLAMA4_CACHE,
                            LLAMA4_REQUESTS, layers=LLAMA4_LAYERS,
                            batch=LLAMA4_BATCH, n_random=0)


def llama4_exact_check(smi: str) -> None:
    """The reduced fp32 llama4 (``llama4_reduced``) served on the card
    (kernels, chunked rings, decode graph) past the chunk boundary and past
    two chunks at prefill, each request's logits held against the plain
    full-sequence forward on the card (no cache, no ring, no kernel)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec
    cfg = llama4_reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    cache = 256
    eng = Engine(cfg, params, ServeSpec(batch=2, cache_len=cache))
    del params
    sched, pick, rows = eng.scheduler, eng.scheduler._next_token, []
    rng = np.random.default_rng(7)
    for n, new in LLAMA4_EXACT_REQUESTS:
        seen = []

        def record(logits):
            seen.append(logits[:, -1].clone())
            return pick(logits)

        sched._next_token = record
        prompt = rng.integers(0, cfg.vocab_size, n)
        rid = eng.submit(Request(tokens=prompt, max_new=new))
        res = eng.drain()[rid]
        sched._next_token = pick
        check(eng.stats()["decode_graph"] and len(seen) == new,
              f"llama4 exact: {len(seen)} logits recorded")
        got = torch.stack([seen[0][0]] + [t[res.slot] for t in seen[1:]])
        full = np.concatenate([prompt, res.tokens[:-1]])
        want = plain_full_forward(eng.model, torch.from_numpy(full)[None]
                                  .to("cuda"), n - 1)[0]
        err = float((got - want).abs().max())
        plain_tok = torch.clamp(want.argmax(-1), max=cfg.vocab_size - 1)
        same = plain_tok.cpu().numpy().tolist() == res.tokens.tolist()
        check(err <= VARIANT_EXACT_TOL, f"llama4 exact {n}: engine logits "
                                        f"{err} from the plain forward's")
        check(same, f"llama4 exact {n}: engine tokens "
                    f"{res.tokens.tolist()}, plain {plain_tok.tolist()}")
        rows.append({"prompt": n, "new": new,
                     "positions": [n - 1, n + new - 2],
                     "crossed_chunk": any(
                         n - 1 < c <= n + new - 2 for c in (64, 128)),
                     "prefill_rolled": n > cfg.chunk,
                     "max_abs_logit_err": err, "tokens_equal": same})
    check(any(r["crossed_chunk"] for r in rows) and any(
        r["prefill_rolled"] for r in rows), "llama4 exact: no request "
                                            "crossed the chunk or rolled")
    print(json.dumps({
        "phase": "serve_llama4_exact", "model": cfg.name,
        "layers": cfg.n_layers, "chunk": cfg.chunk,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim_,
        "dtype": "float32", "cache_len": cache,
        "capacity_factor": cfg.capacity_factor, "requests": rows,
        "tolerance": VARIANT_EXACT_TOL, "card": smi}))
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def profile_window(label: str, phase: str, fn, calls: int,
                   sums: dict[str, str] | None = None, **meta) -> None:
    """torch.profiler over ``calls`` calls of ``fn`` (warm already): device
    busy time per call, the idle share of the wall time, device ops per
    call and the kernels that take the device time; for each (label,
    substring) of ``sums``, the device ms per call of the kernels whose
    name holds the substring."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    out = {"phase": label, "of": phase, "calls": calls, **meta,
           "wall_ms_per_call": wall / calls * 1e3}
    if busy_us <= 0:
        out["device_ms_per_call"] = "not measured (no device time traced)"
    else:
        out.update({
            "device_ms_per_call": busy_us / calls / 1e3,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "device_ops_per_call": sum(e.count for e in dev) / calls,
            "top_device": [[e.key[:70], e.self_device_time_total / calls / 1e3,
                            e.count // calls] for e in top]})
        for name, part in (sums or {}).items():
            hit = [e for e in dev if part in e.key]
            out[f"{name}_device_ms_per_call"] = sum(
                e.self_device_time_total for e in hit) / calls / 1e3
            out[f"{name}_launches_per_call"] = sum(
                e.count for e in hit) / calls
    print(json.dumps(out))


def profile_serving(eng, reqs, phase: str, steps: int = 5,
                    cache_len: int = 1024) -> None:
    """Profile one 512-token prefill (twice) and ``steps`` decode steps
    with min(8, batch) live rows."""
    from repro_torch.serve import Request
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, eng.cfg.vocab_size, (1, 512))).to(eng.model.device)
    prefill = lambda: eng.model(toks, mode="prefill", cache_len=cache_len)
    prefill()
    profile_window("profile_prefill", phase, prefill, 2, prompt_tokens=512)
    live = min(8, eng.spec.batch)
    for r in reqs[:live]:
        eng.submit(Request(tokens=r.tokens[:64], max_new=steps + 4))
    eng.step()
    eng.step()
    profile_window("profile_decode", phase, eng.step, steps, live_rows=live,
                   decode="cuda_graph")
    # the same step eagerly: the forward called directly on a copy of the
    # cache, so that the graph's share of the change reads apart from the
    # kernels'
    cache = {name: t.clone() for name, t in eng.scheduler._cache.items()}
    tok = eng.scheduler._tok_dev.clone()
    eager = lambda: eng.model(tok, mode="decode", cache=cache)
    eager()
    profile_window("profile_decode_eager", phase, eager, steps,
                   live_rows=live,
                   decode="eager")
    del cache
    eng.drain()


# ---------------------------------------------------------------------------
# phase 6: sequence-parallel serving over gloo ranks sharing the card
# ---------------------------------------------------------------------------
# new tokens a request: the reduced fp32 run holds every one of them to
# the one-rank engine's exactly; the full-width run holds its prefill and
# first decode logits and reports the greedy share, its later steps time
# the decode (about 0.25-0.8 s a step over gloo in each of 3 layouts);
# 16 and 4 (32 and 16 before phase 4v needed the run's time, 8 before
# phase 8ev did); the full-width prompts 3,000 and 11,000 (a 20,000-token
# third before phases 4l and 9l needed the run's time)
SEQ_CACHE, SEQ_NEW, SEQ_NEW_FULL = 32768, 16, 4
SEQ_PROMPTS = (3000, 11000)
SEQ_LAYOUTS = (("pod_locality", dict(combine="locality")),
               ("pod_xla", dict(combine="xla")),
               ("data_locality", dict(combine="locality",
                                      seq_axes=("data",))))
# the reduced run: 2 layers in fp32; a cache that divides over 4 and 6
# ranks, and prompts at the same shares of it as SEQ_PROMPTS of SEQ_CACHE
SEQ_REDUCED_CACHE = 6144
SEQ_REDUCED_PROMPTS = (562, 2062, 3750)
SEQ_GRIDS = ((2, 2), (3, 2))
# first-decode logits against the one-rank engine, bf16: the combine sums
# the shards' fp32 partial o and l in another order and rescales them on
# the host, so a layer's bf16 attention output may round one ulp (2^-8 of
# it) the other way in a few elements, and 28 layers carry that on; held
# within 5% of the largest |logit| (about 13 bf16 ulps of it)
SEQ_LOGIT_REL = 5e-2


def seq_requests(vocab: int, lens, new: int = SEQ_NEW
                 ) -> list[tuple[np.ndarray, int]]:
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, n), new) for n in lens]


def serve_on_card(cfg, params, spec, requests, grid=None, home_pod=None
                  ) -> dict:
    """Serve ``requests`` ((prompt, max_new)), all arriving at 0 and homed
    in ``home_pod``, through an Engine on the card (on ``grid``, or one
    rank; phases 6 and 7). Per request id: the logits of its prefill where
    this rank ran it and of its first decode step where this rank holds
    its row (fp32 numpy arrays, which a spawned rank returns by value), the
    prefill's host ms; every decode step's host ms (the step and a sync);
    the launches per kernel, counted from 0 around the drain and checked
    against the path; the results, stats and layout."""
    from repro_torch import kernels
    from repro_torch.serve import Engine, Request, StepClock
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, spec, grid=grid, clock=StepClock())
    sched = eng.scheduler
    forward, decode, start = eng.model.forward, sched._decode, sched._start
    rec = {"prefill_ms": {}, "decode_ms": [], "prefill_logits": {},
           "decode_logits": {}}
    current = {}

    def timed_start(req, row):
        current["rid"] = req.rid
        return start(req, row)

    def timed_forward(tokens, mode="prefill", **kw):
        if mode != "prefill":
            return forward(tokens, mode=mode, **kw)
        t = time.perf_counter()
        logits, cache = forward(tokens, mode=mode, **kw)
        check(bool(torch.isfinite(logits).all()), "non-finite prefill")
        rid = current["rid"]
        rec["prefill_ms"][rid] = (time.perf_counter() - t) * 1e3
        rec["prefill_logits"][rid] = logits[0, -1].float().cpu().numpy()
        return logits, cache

    def timed_decode():
        t = time.perf_counter()
        logits = decode()
        check(bool(torch.isfinite(logits).all()), "non-finite decode")
        rec["decode_ms"].append((time.perf_counter() - t) * 1e3)
        for rid, st in sched.active.items():      # rows at their first step
            if st.owned and st.n == 1:
                rec["decode_logits"][rid] = logits[
                    st.row - sched.rows_lo, -1].float().cpu().numpy()
        return logits

    eng.model.forward, sched._decode = timed_forward, timed_decode
    sched._start = timed_start
    kernels.add_launch_counts(kernels.launch_counts(), -1)    # all to 0
    rids = [eng.submit(Request(tokens=t, max_new=m, home_pod=home_pod,
                               arrival_s=0.0)) for t, m in requests]
    t_drain = time.perf_counter()
    results = eng.drain()
    torch.cuda.synchronize()
    rec["drain_s"] = time.perf_counter() - t_drain
    counts = kernels.launch_counts()
    st = eng.stats()
    want = launches_implied(cfg, st)
    got = {name: counts[name] for name in PATH_KERNELS}
    check(got == want, f"serve: launches {got}, the path implies {want}")
    forms = {f: counts[f"rmsnorm.{f}"] for f in RMS_FORM_NAMES}
    want = rmsnorm_forms_implied(cfg, st)
    check(forms == want, f"serve: rmsnorm forms {forms}, the path implies "
                         f"{want}")
    out = dict(rec, stats=st, launches=got | tier_form_launches(counts),
               variant_launches={k: counts[k] for k in VARIANT_KERNELS},
               rmsnorm_forms=forms,
               tokens={rid: results[rid].tokens.tolist() for rid in rids},
               results={rid: (results[rid].tokens.tolist(),
                              results[rid].slot, results[rid].migrated,
                              results[rid].started_s,
                              results[rid].finished_s) for rid in rids},
               peak_bytes=torch.cuda.max_memory_allocated(),
               rows=(eng.rows_lo, eng.local_batch),
               span=(sched.migrate.span if sched.migrate else None),
               cache_len=eng.cache_len, cache_offset=eng.cache_offset,
               shards={"/".join(n): (sh.offset, sh.length, sh.total)
                       for n, sh in eng.shards.items()},
               spans={"/".join(n): sp
                      for n, sp in eng.resolved.spans.items()},
               combine=dataclasses.asdict(eng.combine))
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seq_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phase 6 (every rank shares the one card): the reduced
    fp32 run on 2 x 2 (ranks 0-3) and 3 x 2, then llama3.2-3b at full
    width in the three layouts on 2 x 2; ranks outside a grid wait at the
    barrier that follows each run. Logits come back from rank 0 only."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grids = {shape: RankGrid.build(*shape) for shape in SEQ_GRIDS}
    out = {"rank": rank, "reduced": {}, "full": {}}
    full = configs.get("llama3.2-3b")
    cfg = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    for shape, grid in grids.items():
        for name, kw in SEQ_LAYOUTS:
            if grid is not None:
                res = serve_on_card(cfg, params, ServeSpec(
                    batch=1, cache_len=SEQ_REDUCED_CACHE, **kw),
                    plan["reduced"], grid)
                out["reduced"][f"{shape[0]}x{shape[1]}|{name}"] = {
                    k: res[k] for k in ("tokens", "combine", "cache_len")}
            dist.barrier()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    grid = grids[(2, 2)]
    params = None if grid is None else init_params(
        full, torch.Generator(device="cuda").manual_seed(0), "cuda")
    for name, kw in SEQ_LAYOUTS:
        if grid is not None:
            res = serve_on_card(full, params, ServeSpec(
                batch=1, cache_len=SEQ_CACHE, **kw), plan["full"], grid)
            if rank:
                res.pop("prefill_logits")
                res.pop("decode_logits")
            out["full"][name] = res
        dist.barrier()
    return out


def serve_seq_parallel(smi: str) -> dict[str, int]:
    """Phase 6: the one-rank references in this process, then 6 spawned
    ranks (``seq_rank``); checks and prints each layout; returns the
    launches per kernel of the full-width runs, summed over the ranks, and
    each layout's per-rank engine stats (phase 9 halves their bytes)."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec

    full = configs.get("llama3.2-3b")
    reduced = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    plan = {"reduced": seq_requests(full.vocab_size, SEQ_REDUCED_PROMPTS),
            "full": seq_requests(full.vocab_size, SEQ_PROMPTS,
                                 SEQ_NEW_FULL)}
    refs = {}
    for key, cfg, cache_len in (("reduced", reduced, SEQ_REDUCED_CACHE),
                                ("full", full, SEQ_CACHE)):
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        refs[key] = serve_on_card(cfg, params, ServeSpec(
            batch=1, cache_len=cache_len), plan[key])
        del params
        gc.collect()
        torch.cuda.empty_cache()
    ref = refs["full"]
    t0 = time.perf_counter()
    ranks = run_ranks(6, seq_rank, plan, timeout=900.0)
    ranks_s = time.perf_counter() - t0

    want = refs["reduced"]["tokens"]
    for key in [f"{q}x{pl}|{name}" for q, pl in SEQ_GRIDS
                for name, _ in SEQ_LAYOUTS]:
        q, pl = map(int, key.split("|")[0].split("x"))
        for r in range(q * pl):
            got = ranks[r]["reduced"][key]["tokens"]
            check(got == want, f"reduced fp32 {key} rank {r}: tokens {got} "
                               f"!= one rank's {want}")
    print(json.dumps({
        "phase": "serve_seq_parallel_reduced", "model": reduced.name,
        "layers": 2, "dtype": "float32", "cache_len": SEQ_REDUCED_CACHE,
        "prompts": list(SEQ_REDUCED_PROMPTS), "new_tokens": SEQ_NEW,
        "grids": ["2x2", "3x2"], "layouts": [n for n, _ in SEQ_LAYOUTS],
        "tokens_equal_to_one_rank": True}))

    total = {name: 0 for name in PATH_KERNELS}
    for name, _ in SEQ_LAYOUTS:
        res = [ranks[r]["full"][name] for r in range(4)]
        for r in range(1, 4):
            check(res[r]["tokens"] == res[0]["tokens"],
                  f"{name}: rank {r}'s tokens differ from rank 0's")
        r0 = res[0]
        rids = sorted(ref["tokens"])
        check(sorted(r0["prefill_logits"]) == sorted(r0["decode_logits"])
              == rids, f"{name}: a request without its prefill or first "
                       "decode")
        d_pre = [np_err(r0["prefill_logits"][i], ref["prefill_logits"][i])
                 for i in rids]
        d_dec = [np_err(r0["decode_logits"][i], ref["decode_logits"][i])
                 for i in rids]
        scale = max(float(np.abs(t).max())
                    for t in ref["decode_logits"].values())
        check(max(d_pre + d_dec) <= SEQ_LOGIT_REL * scale,
              f"{name}: logits differ from the one-rank engine's by "
              f"{max(d_pre + d_dec)} (limit {SEQ_LOGIT_REL * scale})")
        same = sum(a == b for i in rids
                   for a, b in zip(r0["tokens"][i], ref["tokens"][i]))
        steps = r0["stats"]["decode_steps"]
        per_step = {k: [x["launches"][k] / steps for x in res]
                    for k in ("decode_scores", "decode_stats")}
        for x in res:
            for k, n in x["launches"].items():
                total[k] = total.get(k, 0) + n
        print(json.dumps({
            "phase": "serve_seq_parallel", "layout": name,
            "shared": "4 ranks sharing one H100 over gloo",
            "model": full.name, "layers": full.n_layers, "dtype": "bfloat16",
            "cache_len": SEQ_CACHE, "slots_per_rank": r0["cache_len"],
            "combine": r0["combine"], "prompts": list(SEQ_PROMPTS),
            "new_tokens": SEQ_NEW_FULL, "decode_steps": steps,
            "prefill_ms": {f"rank{r}": [x["prefill_ms"][i] for i in rids]
                           for r, x in enumerate(res)},
            "prefill_ms_one_rank": [ref["prefill_ms"][i] for i in rids],
            "decode_step_ms_mean": float(np.mean(r0["decode_ms"])),
            "decode_step_ms_mean_by_rank": [float(np.mean(x["decode_ms"]))
                                            for x in res],
            "decode_step_ms_mean_one_rank": float(np.mean(ref["decode_ms"])),
            "combine_host_ms_per_step": [x["stats"]["combine_host_s"]
                                         / steps * 1e3 for x in res],
            "combine_exchange_ms_per_step": [
                x["stats"]["combine_exchange_s"] / steps * 1e3 for x in res],
            "nonlocal_msgs_per_step": [x["stats"]["nonlocal_msgs"] / steps
                                       for x in res],
            "nonlocal_bytes_per_step": [x["stats"]["nonlocal_bytes"] / steps
                                        for x in res],
            "combine_bytes_per_step": [x["stats"]["combine_bytes"] / steps
                                       for x in res],
            "staging_bytes_per_step": [x["stats"]["staging_bytes"] / steps
                                       for x in res],
            "decode_kernel_launches_per_step": per_step,
            "launches_rank0": r0["launches"],
            "prefill_tokens_per_rank": r0["stats"]["prefill_tokens"],
            "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
            "peak_bytes_one_rank": ref["peak_bytes"],
            "max_abs_dlogit_prefill": d_pre,
            "prefill_bitwise_equal": all(d == 0 for d in d_pre),
            "max_abs_dlogit_first_decode": d_dec,
            "logit_tolerance": SEQ_LOGIT_REL * scale,
            "greedy_equal_share": same / sum(map(len,
                                                 ref["tokens"].values())),
            "ranks_wall_s": ranks_s, "card": smi}))
    return total, {name: [ranks[r]["full"][name]["stats"] for r in range(4)]
                   for name, _ in SEQ_LAYOUTS}


# ---------------------------------------------------------------------------
# phase 7: batch-sharded serving over gloo ranks sharing the card
# ---------------------------------------------------------------------------
# ServeSpec(batch=8, cache_len=2048, page_len=16) on 2 x 2 ranks, 2 rows a
# rank; 16 requests, all arriving at 0 and homed in pod 0, so pod 0's rows
# fill from its own prefills and the rest migrate to pod 1
BATCH_ROWS, BATCH_CACHE, BATCH_PAGE = 8, 2048, 16
BATCH_GRID = (2, 2)
BATCH_HOME_POD = 0
BATCH_N = 16
# what the JAX engine and the port's scheduler decide for this trace (both
# held to it at a reduced size in tests/test_torch_serve_batch.py)
BATCH_MIGRATIONS = 8
BATCH_ALGS = ("locality_bruck", "multilane", "xla")
BATCH_REDUCED_GRIDS = ((2, 2), (3, 2))
# the reduced run's batch on 3 x 2: one that divides over 6 ranks
BATCH_REDUCED_ROWS = {(2, 2): 8, (3, 2): 6}


def batch_requests(vocab: int) -> list[tuple[np.ndarray, int]]:
    """(prompt, max_new): 128-1,536 prompt tokens, 16-32 new (32-64
    before phases 4l and 9l needed the run's time), seeded; the lengths
    do not depend on ``vocab``."""
    rng = np.random.default_rng(7)
    lens = rng.integers(128, 1537, BATCH_N)
    news = rng.integers(16, 33, BATCH_N)
    return [(rng.integers(0, vocab, int(n)), int(m))
            for n, m in zip(lens, news)]


def batch_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phase 7 (every rank shares the one card): the reduced
    fp32 run on 2 x 2 (ranks 0-3) and 3 x 2 for each migration schedule,
    then llama3.2-3b at full width on 2 x 2 for each; ranks outside a grid
    wait at the barrier that follows each run."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grids = {shape: RankGrid.build(*shape) for shape in BATCH_REDUCED_GRIDS}
    out = {"rank": rank, "reduced": {}, "full": {}}
    full = configs.get("llama3.2-3b")
    cfg = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    for shape, grid in grids.items():
        for alg in BATCH_ALGS:
            if grid is not None:
                res = serve_on_card(cfg, params, ServeSpec(
                    batch=BATCH_REDUCED_ROWS[shape], cache_len=BATCH_CACHE,
                    page_len=BATCH_PAGE, migrate=alg), plan["requests"],
                    grid, BATCH_HOME_POD)
                out["reduced"][f"{shape[0]}x{shape[1]}|{alg}"] = {
                    "tokens": res["tokens"], "span": res["span"],
                    "migrations": res["stats"]["migrations"]}
            dist.barrier()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    grid = grids[BATCH_GRID]
    params = None if grid is None else init_params(
        full, torch.Generator(device="cuda").manual_seed(0), "cuda")
    for alg in BATCH_ALGS:
        if grid is not None:
            out["full"][alg] = serve_on_card(full, params, ServeSpec(
                batch=BATCH_ROWS, cache_len=BATCH_CACHE, page_len=BATCH_PAGE,
                migrate=alg), plan["requests"], grid, BATCH_HOME_POD)
        dist.barrier()
    return out


def migrate_oracle(alg: str, q: int, pl: int, leaf_bytes: int) -> list[int]:
    """Non-local messages a rank of one migration's collective, its two
    leaves (K and V): the schedule oracle's for the Bruck schedules. For
    "xla" it is the recorder's own model of one library all-gather, the
    call the port's xla route makes, so on the card that check holds only
    the number of gathers; tests/test_torch_serve_batch.py holds the model
    against the JAX HLO's collective_stats."""
    from repro_torch.core import schedules as TS
    from repro_torch.core.comm_record import CommRecorder
    from repro_torch.core.topology import RegionMap
    p = q * pl
    if alg != "xla":
        stats = TS.ALGORITHMS[alg](p, pl).per_rank_stats(RegionMap(p, pl))
        return [2 * stats[r][2] for r in range(p)]
    out = []
    for r in range(p):
        rec = CommRecorder(pl)
        rec.group("all-gather", tuple(range(p)), r, leaf_bytes)
        out.append(2 * rec.stats.nonlocal_msgs)
    return out


def serve_batch_sharded(smi: str) -> dict[str, int]:
    """Phase 7: the one-rank references in this process, then 6 spawned
    ranks (``batch_rank``); checks and prints each schedule; returns the
    launches per kernel of the full-width runs, summed over the ranks and
    schedules, and each schedule's per-rank engine stats."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec

    full = configs.get("llama3.2-3b")
    reduced = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    reqs = batch_requests(full.vocab_size)
    refs = {}
    for key, cfg, rows in (("reduced8", reduced, 8), ("reduced6", reduced, 6),
                           ("full", full, BATCH_ROWS)):
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        refs[key] = serve_on_card(cfg, params, ServeSpec(
            batch=rows, cache_len=BATCH_CACHE, page_len=BATCH_PAGE), reqs,
            home_pod=BATCH_HOME_POD)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(6, batch_rank, {"requests": reqs}, timeout=900.0)
    ranks_s = time.perf_counter() - t0

    for (q, pl), rows in BATCH_REDUCED_ROWS.items():
        want = refs[f"reduced{rows}"]["tokens"]
        for alg in BATCH_ALGS:
            key = f"{q}x{pl}|{alg}"
            for r in range(q * pl):
                got = ranks[r]["reduced"][key]
                check(got["tokens"] == want, f"reduced fp32 {key} rank {r}: "
                                             "tokens differ from one rank's")
                if (q, pl) == BATCH_GRID:
                    check(got["migrations"] == BATCH_MIGRATIONS,
                          f"reduced {key}: {got['migrations']} migrations, "
                          f"the CPU test's trace {BATCH_MIGRATIONS}")
    print(json.dumps({
        "phase": "serve_batch_sharded_reduced", "model": reduced.name,
        "layers": 2, "dtype": "float32", "cache_len": BATCH_CACHE,
        "grids": {f"{q}x{pl}": {"batch": rows, "span": ranks[0]["reduced"][
            f"{q}x{pl}|{BATCH_ALGS[0]}"]["span"]}
            for (q, pl), rows in BATCH_REDUCED_ROWS.items()},
        "schedules": list(BATCH_ALGS), "requests": len(reqs),
        "migrations_2x2": BATCH_MIGRATIONS,
        "tokens_equal_to_one_rank": True}))

    ref = refs["full"]
    scale = max(float(np.abs(t).max()) for t in ref["decode_logits"].values())
    q, pl = BATCH_GRID
    p = q * pl
    leaf = (full.n_layers * BATCH_CACHE * full.n_kv_heads * full.head_dim_
            * 2)                                    # one bf16 K or V slab
    total = {name: 0 for name in PATH_KERNELS}
    for alg in BATCH_ALGS:
        res = [ranks[r]["full"][alg] for r in range(p)]
        for r in range(1, p):
            check(res[r]["results"] == res[0]["results"],
                  f"{alg}: rank {r}'s results differ from rank 0's")
        mig = res[0]["stats"]["migrations"]
        check(mig == BATCH_MIGRATIONS, f"{alg}: {mig} migrations, the CPU "
                                       f"test's trace {BATCH_MIGRATIONS}")
        pre = {rid: l for x in res for rid, l in x["prefill_logits"].items()}
        dec = {rid: l for x in res for rid, l in x["decode_logits"].items()}
        check(sorted(pre) == sorted(ref["prefill_logits"])
              and sorted(dec) == sorted(ref["decode_logits"]),
              f"{alg}: a request without its prefill or first decode")
        d_pre = [np_err(pre[rid], ref["prefill_logits"][rid])
                 for rid in sorted(pre)]
        d_dec = [np_err(dec[rid], ref["decode_logits"][rid])
                 for rid in sorted(dec)]
        check(max(d_pre) == 0, f"{alg}: prefill logits differ from the "
                               f"one-rank engine's by {max(d_pre)}")
        check(max(d_dec) <= SEQ_LOGIT_REL * scale,
              f"{alg}: first decode logits differ from the one-rank "
              f"engine's by {max(d_dec)} (limit {SEQ_LOGIT_REL * scale})")
        # each rank prefills the requests homed in its pod, all of them
        for r, x in enumerate(res):
            want = len(reqs) if r // pl == BATCH_HOME_POD else 0
            check(x["stats"]["prefills"] == want,
                  f"{alg}: rank {r} ran {x['stats']['prefills']} prefills, "
                  f"the path {want}")
        oracle = migrate_oracle(alg, q, pl, leaf)
        per_mig = lambda k: [x["stats"][k] / mig for x in res]
        check(per_mig("migrate_nonlocal_msgs") == oracle,
              f"{alg}: non-local messages a migration "
              f"{per_mig('migrate_nonlocal_msgs')}, the schedule {oracle}")
        same = sum(a == b for rid, toks in res[0]["tokens"].items()
                   for a, b in zip(toks, ref["tokens"][rid]))
        n_tok = sum(map(len, ref["tokens"].values()))
        for x in res:
            for k, n in x["launches"].items():
                total[k] = total.get(k, 0) + n
        steps = res[0]["stats"]["decode_steps"]
        print(json.dumps({
            "phase": "serve_batch_sharded", "migrate": alg,
            "shared": "4 ranks sharing one H100 over gloo",
            "model": full.name, "layers": full.n_layers, "dtype": "bfloat16",
            "batch": BATCH_ROWS, "rows_per_rank": res[0]["rows"][1],
            "cache_len": BATCH_CACHE, "page_len": BATCH_PAGE,
            "requests": len(reqs), "home_pod": BATCH_HOME_POD,
            "prompt_lens": [len(t) for t, _ in reqs],
            "new_tokens": [m for _, m in reqs], "donor_span": res[0]["span"],
            "migrations": mig, "decode_steps": steps,
            "prefill_ms_by_rank": [
                [x["prefill_ms"][rid] for rid in sorted(x["prefill_ms"])]
                for x in res],
            "prefill_ms_one_rank": [ref["prefill_ms"][rid]
                                    for rid in sorted(ref["prefill_ms"])],
            "migration_ms": {part: [x["stats"][f"migrate_{part}_s"] / mig
                                    * 1e3 for x in res]
                             for part in ("donor", "collective", "insert")},
            "migration_host_ms": [x["stats"]["migrate_host_s"] / mig * 1e3
                                  for x in res],
            "decode_step_ms_mean_by_rank": [float(np.mean(x["decode_ms"]))
                                            for x in res],
            "decode_step_ms_mean_one_rank": float(np.mean(ref["decode_ms"])),
            "decode_steps_one_rank": ref["stats"]["decode_steps"],
            "migrate_bytes_per_migration": per_mig("migrate_bytes"),
            "migrate_nonlocal_msgs_per_migration":
                per_mig("migrate_nonlocal_msgs"),
            "migrate_nonlocal_bytes_per_migration":
                per_mig("migrate_nonlocal_bytes"),
            "schedule_nonlocal_msgs": oracle,
            "donor_bytes_per_migration": per_mig("donor_bytes"),
            "donor_nonlocal_msgs_per_migration":
                per_mig("donor_nonlocal_msgs"),
            "staging_bytes": [x["stats"]["staging_bytes"] for x in res],
            "prefills_by_rank": [x["stats"]["prefills"] for x in res],
            "launches_by_rank": [x["launches"] for x in res],
            "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
            "peak_bytes_one_rank": ref["peak_bytes"],
            "prefill_bitwise_equal": True,
            "max_abs_dlogit_first_decode": max(d_dec),
            "logit_tolerance": SEQ_LOGIT_REL * scale,
            "greedy_equal_share": same / n_tok,
            "ranks_wall_s": ranks_s, "card": smi}))
    return total, {alg: [ranks[r]["full"][alg]["stats"] for r in range(p)]
                   for alg in BATCH_ALGS}


# ---------------------------------------------------------------------------
# phase 9: serving on a ("pod", "data", "model") grid of gloo ranks
# ---------------------------------------------------------------------------
# 2 x 2 x 2 ranks sharing the card: 9a is phase 7's batch-sharded run (its
# ServeSpec and home pod) on the first 8 requests of its trace, 9b phase 6's
# split cache over ("pod", "data") on each model lane with its first
# prompt (3,000 tokens, 4 new; the reduced run two), both schedules or
# combines; each first at the reduced size (2 layers, fp32), tokens equal
# to one rank's. Cut to keep the phase near 3 minutes: every eager decode
# step makes 57 tier allreduces through gloo, ~0.3 s a step at full width
# (PR 24's chip runs: 16 requests and 16 new tokens took 4.5 minutes)
TIER_GRID = (2, 2, TIER_M)
TIER_ALGS = ("locality_bruck", "xla")
TIER_BATCH_N = 8
# what the JAX engine and the port decide for 9a's trace on (2, 2, 2): the
# first 8 requests fill the 8 rows, pod 1's 4 by migration (both held to
# it at a reduced size in tests/test_torch_serve_tp.py)
TIER_MIGRATIONS = 4
TIER_SEQ_LAYOUTS = SEQ_LAYOUTS[:2]
# 9b's full-width prompt: 3,000 tokens (and 11,000 before phase 4v needed
# the run's time; phase 6 keeps all three)
TIER_SEQ_PROMPTS = SEQ_PROMPTS[:1]
TIER_SEQ_REDUCED_PROMPTS = SEQ_REDUCED_PROMPTS[:2]
# 9b's new tokens: 4 (8 before phase 8ev needed the run's time: a split
# decode step of ~1.2 s over gloo on an H100)
TIER_NEW = 4
# 9a's and 9m's budgets are cut to 8 new tokens (phase 7's 32-64 before
# phase 4v needed the run's time, 16 before phase 8ev did): the 8
# requests still fill the 8 rows at once, so the migrations are the same
TIER_MAX_NEW = 8


def tier_batch_requests(vocab: int) -> list[tuple[np.ndarray, int]]:
    """9a's trace: the first ``TIER_BATCH_N`` requests of phase 7's, their
    budgets cut to ``TIER_MAX_NEW``."""
    return [(t, min(m, TIER_MAX_NEW))
            for t, m in batch_requests(vocab)[:TIER_BATCH_N]]


def tier_runs(plan: dict, key: str) -> list[tuple[str, dict, list, int]]:
    """(name, ServeSpec keywords, requests, home pod) of phase 9's runs at
    ``key``, "reduced" or "full"; a home pod of None: the row's own."""
    cache = SEQ_REDUCED_CACHE if key == "reduced" else SEQ_CACHE
    return ([(f"9a|{alg}", dict(batch=BATCH_ROWS, cache_len=BATCH_CACHE,
                                page_len=BATCH_PAGE, migrate=alg),
              plan["batch"], BATCH_HOME_POD) for alg in TIER_ALGS]
            + [(f"9b|{name}", dict(batch=1, cache_len=cache, **kw),
                plan[f"seq_{key}"], None) for name, kw in TIER_SEQ_LAYOUTS])


def tier_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phase 9 (all eight share the one card): each run of
    ``tier_runs`` at the reduced size, then at full width, with this
    rank's part of the weights drawn from seed 0 (``init_params(...,
    part=)``: the one-rank engine's weights, cut)."""
    entered = time.time() - plan["spawned_at"]
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    from repro_torch.models.tp import TensorParallel
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    grid = RankGrid.build(*TIER_GRID)
    setup = {"entered_s": entered,
             "started_s": time.time() - plan["spawned_at"],
             "grid_s": time.perf_counter() - t0}
    out = {"rank": rank, "reduced": {}, "full": {}, "setup": setup,
           "coords": dict(rank=grid.rank, t=grid.t, grid_rank=grid.grid_rank,
                          tier=list(grid.model.members))}
    full = configs.get("llama3.2-3b")
    for key, cfg in (("reduced", dataclasses.replace(
            full, n_layers=2, dtype=torch.float32)), ("full", full)):
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda",
                             part=TensorParallel.build(cfg, grid).part)
        torch.cuda.synchronize()
        setup[f"init_{key}_s"] = time.perf_counter() - t0
        for name, kw, reqs, home in tier_runs(plan, key):
            t0 = time.perf_counter()
            res = serve_on_card(cfg, params, ServeSpec(**kw), reqs, grid,
                                home)
            out[key][name] = res if key == "full" else {
                k: res[k] for k in ("tokens", "results")}
            dist.barrier()
            if rank == 0:          # where phase 9's time goes, as it goes
                print(json.dumps({"phase": "serve_tier_run", "size": key,
                                  "run": name, "seconds":
                                  time.perf_counter() - t0}), flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    setup["done_at"] = time.time()
    return out


def migrate_bytes_oracle(alg: str, q: int, pl: int, leaf_bytes: int
                         ) -> list[float]:
    """Non-local bytes a rank of one migration's collective, its two
    leaves: the schedule oracle's blocks times a block (``leaf_bytes`` /
    p) for the Bruck schedules, the recorder's model of the library
    all-gather for "xla" (``migrate_oracle``)."""
    from repro_torch.core import schedules as TS
    from repro_torch.core.comm_record import CommRecorder
    from repro_torch.core.topology import RegionMap
    p = q * pl
    if alg != "xla":
        stats = TS.ALGORITHMS[alg](p, pl).per_rank_stats(RegionMap(p, pl))
        return [2 * stats[r][3] * leaf_bytes / p for r in range(p)]
    out = []
    for r in range(p):
        rec = CommRecorder(pl)
        rec.group("all-gather", tuple(range(p)), r, leaf_bytes)
        out.append(2 * rec.stats.nonlocal_bytes)
    return out


def combine_oracle(alg: str, q: int, pl: int, max_bytes: int,
                   sum_bytes: int) -> list[tuple[float, float]]:
    """(non-local messages, bytes) a rank of one decode combine over a
    q x pl lane: "locality", for q a power of two, the max by recursive
    doubling over the pods (``rd_rounds(q)`` rounds of the ``max_bytes``
    maxima) and the sum by recursive halving, then a Bruck gather, over
    the pods on the rank's 1/pl slice of the packed fp32 [o, l]
    (``sum_bytes``), padded to a multiple of q (log2 q rounds each, (q -
    1)/q of the slice each), after the pod's local reduce-scatter; "xla",
    the recorder's model of the two library allreduces."""
    from repro_torch.core.comm_record import CommRecorder
    from repro_torch.core.topology import is_power_of, rd_rounds
    p = q * pl
    if alg == "locality":
        check(is_power_of(2, q), f"combine oracle: {q} pods")
        rounds = rd_rounds(q)
        part = -(-sum_bytes // 4 // pl) // -q * -q          # fp32 elements
        return [(3 * rounds, max_bytes * rounds
                 + 2 * 4 * part * (q - 1) / q)] * p
    out = []
    for r in range(p):
        rec = CommRecorder(pl)
        for nbytes in (max_bytes, sum_bytes):
            rec.group("all-reduce", tuple(range(p)), r, nbytes)
        out.append((rec.stats.nonlocal_msgs, rec.stats.nonlocal_bytes))
    return out


def _tier_logits(res: list, coords: list, which: str, m: int) -> dict:
    """The full vocabulary's logits of each request, its tier ranks'
    columns put together (``which``: "prefill_logits" or
    "decode_logits")."""
    parts = {}
    for x, c in zip(res, coords):
        for rid, lg in x[which].items():
            parts.setdefault(rid, {})[c["t"]] = lg
    return {rid: np.concatenate([by_t[t] for t in range(m)])
            for rid, by_t in parts.items() if len(by_t) == m}


def serve_tier(smi: str, base: dict) -> dict[str, int]:
    """Phase 9: one-rank references in this process, then 8 spawned ranks
    (``tier_rank``) on 2 x 2 x 2; checks and prints each run; returns the
    launches per kernel of the full-width runs, summed over the ranks.
    ``base`` holds phases 6's and 7's per-rank stats, whose collective
    bytes a model rank halves."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec

    full = configs.get("llama3.2-3b")
    reduced = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    vocab = full.vocab_size
    plan = {"batch": tier_batch_requests(vocab),
            "seq_reduced": seq_requests(vocab, TIER_SEQ_REDUCED_PROMPTS,
                                        TIER_NEW),
            "seq_full": seq_requests(vocab, TIER_SEQ_PROMPTS, TIER_NEW)}
    refs = {}
    for key, cfg in (("reduced", reduced), ("full", full)):
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        for name, kw, reqs, home in tier_runs(plan, key)[::2]:
            one = {k: v for k, v in kw.items()
                   if k not in ("migrate", "combine")}
            refs[key, name[:2]] = serve_on_card(cfg, params, ServeSpec(**one),
                                                reqs, home_pod=home)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    q, pl, m = TIER_GRID
    n, p = q * pl * m, q * pl
    t0 = time.perf_counter()
    plan["spawned_at"] = time.time()
    ranks = run_ranks(n, tier_rank, plan, timeout=900.0)
    ranks_s = time.perf_counter() - t0
    done = time.time()
    for x in ranks:
        x["setup"]["exited_s"] = done - x["setup"].pop("done_at")
    print(json.dumps({"phase": "serve_tier_setup", "ranks_wall_s": ranks_s,
                      "by_rank": [x["setup"] for x in ranks]}))
    coords = [x["coords"] for x in ranks]
    check([c["grid_rank"] for c in coords] == list(range(n)),
          "serve_tier: grid ranks are not the spawned ranks' order")
    pod_of = lambda g: g // m // pl
    for r, c in enumerate(coords):
        check({pod_of(g) for g in c["tier"]} == {pod_of(r)},
              f"serve_tier: rank {r}'s tier {c['tier']} spans pods")
    names = [name for name, *_ in tier_runs(plan, "full")]
    for name in names:
        want = refs["reduced", name[:2]]["tokens"]
        for r, x in enumerate(ranks):
            got = x["reduced"][name]["tokens"]
            check(got == want, f"serve_tier reduced fp32 {name} rank {r}: "
                               f"tokens {got} != one rank's {want}")
    print(json.dumps({
        "phase": "serve_tier_reduced", "model": reduced.name, "layers": 2,
        "dtype": "float32", "grid": "2 x 2 x 2 (pod, data, model)",
        "runs": names, "seq_cache_len": SEQ_REDUCED_CACHE,
        "seq_prompts": list(TIER_SEQ_REDUCED_PROMPTS),
        "tokens_equal_to_one_rank": True}))

    total = {k: 0 for k in PATH_KERNELS}
    lane = [c["rank"] for c in coords]
    KV_loc = full.n_kv_heads // m
    H_loc = full.n_heads // m
    for name in names:
        res = [x["full"][name] for x in ranks]
        ref = refs["full", name[:2]]
        for r, x in enumerate(res):
            check(x["results"] == res[0]["results"],
                  f"serve_tier {name}: rank {r}'s results differ")
            st = x["stats"]
            check(st["tier_calls"] > 0 and st["tier_msgs"] > 0
                  and st["tier_nonlocal_msgs"] == 0,
                  f"serve_tier {name} rank {r}: tier calls "
                  f"{st['tier_calls']}, messages {st['tier_msgs']}, "
                  f"non-local {st['tier_nonlocal_msgs']}")
            check(not st["decode_graph"] and "model tier" in
                  st["decode_graph_rule"], f"serve_tier {name}: decode "
                  f"graph {st['decode_graph']} ({st['decode_graph_rule']})")
            for k, c in x["launches"].items():
                total[k] = total.get(k, 0) + c
        scale = max(float(np.abs(t).max())
                    for t in ref["decode_logits"].values())
        limit = SEQ_LOGIT_REL * scale
        toks = res[0]["tokens"]
        got = {w: _tier_logits(res, coords, w, m)
               for w in ("prefill_logits", "decode_logits")}
        for w, lg in got.items():
            check(sorted(lg) == sorted(ref[w]), f"serve_tier {name}: {w} "
                  f"of {sorted(lg)}, one rank {sorted(ref[w])}")
        # the tier sums the row-parallel products in another order, so its
        # bf16 prefill logits are the one rank's within the limit; where
        # that flips a near-tie, the first token differs, and so does the
        # first decode's input: the tier's pick must then lie within twice
        # the prefill's difference of the one rank's maximum (x'_j >= x'_i
        # with |x' - x| <= d gives x_i - x_j <= 2d), and the first decode
        # logits are compared where the first tokens agree
        dl = {"prefill_logits": {}, "decode_logits": {}, "near_ties": {}}
        for rid in sorted(ref["prefill_logits"]):
            pre = ref["prefill_logits"][rid]
            d = dl["prefill_logits"][rid] = np_err(
                got["prefill_logits"][rid], pre)
            check(d <= limit, f"serve_tier {name}: request {rid}'s prefill "
                  f"logits differ from the one-rank engine's by {d} (limit "
                  f"{limit})")
            one, tier = ref["tokens"][rid][0], toks[rid][0]
            if one == tier:
                d = dl["decode_logits"][rid] = np_err(
                    got["decode_logits"][rid], ref["decode_logits"][rid])
                check(d <= limit, f"serve_tier {name}: request {rid}'s "
                      f"first decode logits differ from the one-rank "
                      f"engine's by {d} (limit {limit})")
            else:
                gap = float(pre[one] - pre[tier])
                dl["near_ties"][rid] = gap
                check(gap <= 2 * dl["prefill_logits"][rid],
                      f"serve_tier {name}: request {rid}'s first token "
                      f"{tier}, one rank's {one}, {gap} below its maximum "
                      f"(more than twice the prefill difference)")
        same = sum(a == b for rid, tk in toks.items()
                   for a, b in zip(tk, ref["tokens"][rid]))
        n_tok = sum(map(len, ref["tokens"].values()))
        steps = res[0]["stats"]["decode_steps"]
        row = {"phase": "serve_tier", "run": name,
               "shared": "8 ranks sharing one H100 over gloo",
               "grid": "2 x 2 x 2 (pod, data, model)", "model": full.name,
               "layers": full.n_layers, "dtype": "bfloat16",
               "kv_heads_per_rank": KV_loc, "q_heads_per_rank": H_loc,
               "decode_steps": steps,
               "decode_step_ms_mean_by_rank": [
                   float(np.mean(x["decode_ms"])) for x in res],
               "decode_step_ms_mean_one_rank": float(np.mean(
                   ref["decode_ms"])),
               "prefill_ms_by_rank": [
                   [x["prefill_ms"][rid] for rid in sorted(x["prefill_ms"])]
                   for x in res],
               "prefill_ms_one_rank": [ref["prefill_ms"][rid]
                                       for rid in sorted(ref["prefill_ms"])],
               "tokens_per_s_by_rank": [n_tok / x["drain_s"] for x in res],
               "tokens_per_s_one_rank": n_tok / ref["drain_s"],
               "tier_calls_by_rank": [x["stats"]["tier_calls"] for x in res],
               "tier_host_ms_by_rank": [x["stats"]["tier_host_s"] * 1e3
                                        for x in res],
               "tier_staged_bytes_by_rank": [x["stats"]["tier_staged_bytes"]
                                             for x in res],
               "tier_msgs_by_rank": [x["stats"]["tier_msgs"] for x in res],
               "tier_nonlocal_msgs": 0,
               "staging_bytes_by_rank": [x["stats"]["staging_bytes"]
                                         for x in res],
               "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
               "peak_bytes_one_rank": ref["peak_bytes"],
               "max_abs_dlogit_prefill": dl["prefill_logits"],
               "max_abs_dlogit_first_decode": dl["decode_logits"],
               "first_token_near_ties": dl["near_ties"],
               "logit_tolerance": limit,
               "greedy_equal_share": same / n_tok,
               "ranks_wall_s": ranks_s, "card": smi}
        if name.startswith("9a"):
            alg = name.split("|")[1]
            mig = res[0]["stats"]["migrations"]
            check(mig == TIER_MIGRATIONS, f"serve_tier {name}: {mig} "
                  f"migrations, the CPU test's trace {TIER_MIGRATIONS}")
            for r, x in enumerate(res):
                want = len(plan["batch"]) if r // m // pl == BATCH_HOME_POD \
                    else 0
                check(x["stats"]["prefills"] == want,
                      f"serve_tier {name}: rank {r} ran "
                      f"{x['stats']['prefills']} prefills, the path {want}")
            leaf = (full.n_layers * BATCH_CACHE * KV_loc * full.head_dim_
                    * 2)                       # one rank's bf16 K or V slab
            msgs = migrate_oracle(alg, q, pl, leaf)
            nbytes = migrate_bytes_oracle(alg, q, pl, leaf)
            per_mig = lambda k: [x["stats"][k] / mig for x in res]
            check(per_mig("migrate_nonlocal_msgs") == [msgs[i] for i in lane]
                  and per_mig("migrate_nonlocal_bytes")
                  == [nbytes[i] for i in lane],
                  f"serve_tier {name}: non-local messages and bytes a "
                  f"migration {per_mig('migrate_nonlocal_msgs')} "
                  f"{per_mig('migrate_nonlocal_bytes')}, the oracle "
                  f"{msgs} {nbytes}")
            phase7 = [b["migrate_nonlocal_bytes"] / b["migrations"]
                      for b in base["serve_batch_sharded"][alg]]
            check(per_mig("migrate_nonlocal_bytes")
                  == [phase7[i] / m for i in lane],
                  f"serve_tier {name}: non-local bytes a migration, not "
                  f"1/{m} of phase 7's {phase7}")
            row.update(
                migrate=alg, migrations=mig,
                migrate_nonlocal_msgs_per_migration=per_mig(
                    "migrate_nonlocal_msgs"),
                migrate_nonlocal_bytes_per_migration=per_mig(
                    "migrate_nonlocal_bytes"),
                migrate_bytes_per_migration=per_mig("migrate_bytes"),
                phase7_nonlocal_bytes_per_migration=phase7,
                migration_host_ms=[x["stats"]["migrate_host_s"] / mig * 1e3
                                   for x in res],
                donor_bytes_per_migration=per_mig("donor_bytes"),
                prefills_by_rank=[x["stats"]["prefills"] for x in res])
        else:
            layout = name.split("|")[1]
            alg = res[0]["combine"]["algorithm"]
            oracle = combine_oracle(alg, q, pl, H_loc * 4,
                                    H_loc * (full.head_dim_ + 1) * 4)
            layers = full.n_layers
            per_step = lambda k: [x["stats"][k] / steps / layers
                                  for x in res]
            check(per_step("nonlocal_msgs") == [oracle[i][0] for i in lane]
                  and per_step("nonlocal_bytes")
                  == [oracle[i][1] for i in lane],
                  f"serve_tier {name}: non-local messages and bytes a "
                  f"combine {per_step('nonlocal_msgs')} "
                  f"{per_step('nonlocal_bytes')}, the oracle {oracle}")
            phase6 = [b["nonlocal_bytes"] / b["decode_steps"] / layers
                      for b in base["serve_seq_parallel"][layout]]
            check(per_step("nonlocal_bytes") == [phase6[i] / m for i in lane],
                  f"serve_tier {name}: non-local bytes a combine, not "
                  f"1/{m} of phase 6's {phase6}")
            row.update(
                combine=res[0]["combine"], cache_len=SEQ_CACHE,
                slots_per_rank=res[0]["cache_len"],
                prompts=list(TIER_SEQ_PROMPTS), new_tokens=TIER_NEW,
                nonlocal_msgs_per_combine=per_step("nonlocal_msgs"),
                nonlocal_bytes_per_combine=per_step("nonlocal_bytes"),
                combine_bytes_per_step=[x["stats"]["combine_bytes"] / steps
                                        for x in res],
                phase6_nonlocal_bytes_per_combine=phase6,
                combine_host_ms_per_step=[x["stats"]["combine_host_s"]
                                          / steps * 1e3 for x in res])
        print(json.dumps(row))
    return total


# ---------------------------------------------------------------------------
# phase 9m: mamba2-780m served on the model tier
# ---------------------------------------------------------------------------
# mamba2-780m at full width and depth (48 layers) on 2 x 2 x 2 ranks, 24
# SSD heads a rank, phase 9a's
# ServeSpec, trace and home pod, migrate
# "locality_bruck"; first in fp32 with each request's budget cut to
# SSM_TIER_FP32_NEW tokens, whose tokens must equal a one-rank engine's,
# then in bf16 (the published dtype) on the whole trace
SSM_TIER_ARCH, SSM_TIER_LAYERS = "mamba2-780m", 48
SSM_TIER_ALG = "locality_bruck"
SSM_TIER_FP32_NEW = 4


def _ssm_tier_config():
    """9m's config: mamba2-780m at full width, ``SSM_TIER_LAYERS`` deep."""
    from repro_torch import configs
    return dataclasses.replace(configs.get(SSM_TIER_ARCH),
                               n_layers=SSM_TIER_LAYERS)


def _ssm_tier_runs(plan: dict) -> list[tuple[str, object, list]]:
    """(name, config, requests) of phase 9m's runs: fp32 on the short
    budgets, then the published bf16 on the trace."""
    from repro_torch import configs
    full = _ssm_tier_config()
    return [("fp32", dataclasses.replace(full, dtype=torch.float32),
             plan["short"]), ("bf16", full, plan["batch"])]


def tier_ssm_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phase 9m (all eight share the one card): each of
    ``_ssm_tier_runs``, with this rank's part of the weights drawn from
    seed 0 (``init_params(..., part=)``)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    from repro_torch.models.tp import TensorParallel
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = RankGrid.build(*TIER_GRID)
    out = {"rank": rank, "coords": dict(rank=grid.rank, t=grid.t,
                                        grid_rank=grid.grid_rank,
                                        tier=list(grid.model.members))}
    spec = ServeSpec(batch=BATCH_ROWS, cache_len=BATCH_CACHE,
                     page_len=BATCH_PAGE, migrate=SSM_TIER_ALG)
    for key, cfg, reqs in _ssm_tier_runs(plan):
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda",
                             part=TensorParallel.build(cfg, grid).part)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        res = serve_on_card(cfg, params, spec, reqs, grid, BATCH_HOME_POD)
        res["init_s"] = init_s
        out[key] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def serve_tier_ssm(smi: str) -> dict[str, int]:
    """Phase 9m: one-rank references in this process, then 8 spawned ranks
    (``tier_ssm_rank``) on 2 x 2 x 2; checks and prints; returns the
    launches per kernel of both runs, summed over the ranks. The fp32
    run's tokens must equal the one rank's; in bf16 the tier rounds each
    layer's output and the gated norm's output from sums taken in another
    order than one rank's, and 24 layers carry those roundings to the
    logits, so the tokens are held as phase 9 holds them (prefill and
    first decode logits within ``SEQ_LOGIT_REL`` of the largest |logit|, a
    first token that differs within twice the prefill's difference of the
    one rank's maximum), and the share of equal tokens is printed."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec
    full = _ssm_tier_config()
    batch = tier_batch_requests(full.vocab_size)
    plan = {"batch": batch,
            "short": [(t, SSM_TIER_FP32_NEW) for t, _ in batch]}
    refs = {}
    one_spec = ServeSpec(batch=BATCH_ROWS, cache_len=BATCH_CACHE,
                         page_len=BATCH_PAGE)
    for key, cfg, reqs in _ssm_tier_runs(plan):
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        refs[key] = serve_on_card(cfg, params, one_spec, reqs,
                                  home_pod=BATCH_HOME_POD)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    q, pl, m = TIER_GRID
    n = q * pl * m
    t0 = time.perf_counter()
    ranks = run_ranks(n, tier_ssm_rank, plan, timeout=900.0)
    ranks_s = time.perf_counter() - t0
    coords = [x["coords"] for x in ranks]
    check([c["grid_rank"] for c in coords] == list(range(n)),
          "serve_tier_ssm: grid ranks are not the spawned ranks' order")
    pod_of = lambda g: g // m // pl
    for r, c in enumerate(coords):
        check({pod_of(g) for g in c["tier"]} == {pod_of(r)},
              f"serve_tier_ssm: rank {r}'s tier {c['tier']} spans pods")
    for r, x in enumerate(ranks):
        check(x["fp32"]["tokens"] == refs["fp32"]["tokens"],
              f"serve_tier_ssm fp32 rank {r}: tokens {x['fp32']['tokens']} "
              f"!= one rank's {refs['fp32']['tokens']}")
    total = {}
    L = full.n_layers
    for key, _, _ in _ssm_tier_runs(plan):
        for r, x in enumerate(ranks):
            x = x[key]
            check(x["results"] == ranks[0][key]["results"],
                  f"serve_tier_ssm {key}: rank {r}'s results differ")
            st = x["stats"]
            fwd = st["prefills"] + st["decode_steps"]
            check(st["tier_calls"] == (2 * L + 2) * fwd
                  and st["tier_msgs"] > 0 and st["tier_nonlocal_msgs"] == 0,
                  f"serve_tier_ssm {key} rank {r}: tier calls "
                  f"{st['tier_calls']} for {fwd} forwards (the path: "
                  f"{2 * L + 2} a forward), non-local "
                  f"{st['tier_nonlocal_msgs']}")
            check(not st["decode_graph"] and "model tier" in
                  st["decode_graph_rule"], f"serve_tier_ssm: decode graph "
                  f"{st['decode_graph']} ({st['decode_graph_rule']})")
            want = len(batch) if r // m // pl == BATCH_HOME_POD else 0
            check(st["prefills"] == want, f"serve_tier_ssm {key}: rank {r} "
                  f"ran {st['prefills']} prefills, the path {want}")
            for k, c in x["launches"].items():
                total[k] = total.get(k, 0) + c
    res = [x["bf16"] for x in ranks]
    ref = refs["bf16"]
    mig = res[0]["stats"]["migrations"]
    check(mig == TIER_MIGRATIONS, f"serve_tier_ssm: {mig} migrations, the "
          f"trace's {TIER_MIGRATIONS}")
    scale = max(float(np.abs(t).max()) for t in ref["decode_logits"].values())
    limit = SEQ_LOGIT_REL * scale
    toks = res[0]["tokens"]
    got = {w: _tier_logits(res, coords, w, m)
           for w in ("prefill_logits", "decode_logits")}
    dl = {"prefill_logits": {}, "decode_logits": {}, "near_ties": {}}
    for rid in sorted(ref["prefill_logits"]):
        pre = ref["prefill_logits"][rid]
        d = dl["prefill_logits"][rid] = np_err(got["prefill_logits"][rid], pre)
        check(d <= limit, f"serve_tier_ssm: request {rid}'s prefill logits "
              f"differ from the one-rank engine's by {d} (limit {limit})")
        one, tier = ref["tokens"][rid][0], toks[rid][0]
        if one == tier:
            d = dl["decode_logits"][rid] = np_err(
                got["decode_logits"][rid], ref["decode_logits"][rid])
            check(d <= limit, f"serve_tier_ssm: request {rid}'s first decode "
                  f"logits differ from the one-rank engine's by {d} (limit "
                  f"{limit})")
        else:
            gap = float(pre[one] - pre[tier])
            dl["near_ties"][rid] = gap
            check(gap <= 2 * dl["prefill_logits"][rid],
                  f"serve_tier_ssm: request {rid}'s first token {tier}, one "
                  f"rank's {one}, {gap} below its maximum")
    same = sum(a == b for rid, tk in toks.items()
               for a, b in zip(tk, ref["tokens"][rid]))
    n_tok = sum(map(len, ref["tokens"].values()))
    steps = res[0]["stats"]["decode_steps"]
    per_mig = lambda k: [x["stats"][k] / mig for x in res]
    print(json.dumps({
        "phase": "serve_tier_ssm", "shared": "8 ranks sharing one H100 over "
        "gloo", "grid": "2 x 2 x 2 (pod, data, model)", "model": full.name,
        "layers": L, "reduced": f"depth 48 -> {L} layers (gloo host "
                                 "transport)", "dtype": "bfloat16",
        "ssd_heads_per_rank": ssm_dims(full)[1] // m,
        "migrate": SSM_TIER_ALG,
        "fp32_tokens_equal_to_one_rank": True,
        "fp32_new_tokens_a_request": SSM_TIER_FP32_NEW,
        "fp32_decode_step_ms_mean_by_rank": [
            float(np.mean(x["fp32"]["decode_ms"])) for x in ranks],
        "decode_steps": steps,
        "decode_step_ms_mean_by_rank": [float(np.mean(x["decode_ms"]))
                                        for x in res],
        "decode_step_ms_mean_one_rank": float(np.mean(ref["decode_ms"])),
        "prefill_ms_by_rank": [[x["prefill_ms"][rid]
                                for rid in sorted(x["prefill_ms"])]
                               for x in res],
        "prefill_ms_one_rank": [ref["prefill_ms"][rid]
                                for rid in sorted(ref["prefill_ms"])],
        "tokens_per_s_by_rank": [n_tok / x["drain_s"] for x in res],
        "tokens_per_s_one_rank": n_tok / ref["drain_s"],
        "tier_calls_per_forward": 2 * L + 2,
        "tier_allreduces_per_decode_step": 2 * L + 1,
        "tier_calls_by_rank": [x["stats"]["tier_calls"] for x in res],
        "tier_host_ms_by_rank": [x["stats"]["tier_host_s"] * 1e3
                                 for x in res],
        "tier_staged_bytes_by_rank": [x["stats"]["tier_staged_bytes"]
                                      for x in res],
        "tier_msgs_by_rank": [x["stats"]["tier_msgs"] for x in res],
        "tier_nonlocal_msgs": 0, "migrations": mig,
        "migrate_bytes_per_migration": per_mig("migrate_bytes"),
        "donor_bytes_per_migration": per_mig("donor_bytes"),
        "donor_nonlocal_bytes_per_migration": per_mig("donor_nonlocal_bytes"),
        "migration_host_ms": [x["stats"]["migrate_host_s"] / mig * 1e3
                              for x in res],
        "staging_bytes_by_rank": [x["stats"]["staging_bytes"] for x in res],
        "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
        "peak_bytes_one_rank": ref["peak_bytes"],
        "init_s_by_rank": [x["init_s"] for x in res],
        "tier_staged_bytes_fp32_by_rank": [
            x["fp32"]["stats"]["tier_staged_bytes"] for x in ranks],
        "max_abs_dlogit_prefill": dl["prefill_logits"],
        "max_abs_dlogit_first_decode": dl["decode_logits"],
        "first_token_near_ties": dl["near_ties"], "logit_tolerance": limit,
        "greedy_equal_share": same / n_tok, "ranks_wall_s": ranks_s,
        "card": smi}))
    return total


# ---------------------------------------------------------------------------
# phase 9v: the dense variants served on the ("pod", "data", "model") grid
# ---------------------------------------------------------------------------
# 2 x 2 x 2 ranks sharing the card, phase 9's order: first gemma2-9b and
# h2o-danube-3-4b reduced (d_model 128, 4/2 heads of their real head dims
# 256 and 120, window 64, 2 layers, fp32) in 9v-a's and 9v-b's layouts on a
# 128-slot cache, tokens equal to the one-rank engine's; then gemma2-9b at
# full width (d_model 3,584, 16/8 heads of 256, d_ff 14,336, vocab 256,000,
# window 4,096, caps 50/30) cut to 8 of its 42 layers (4 window, 4 full:
# at 42 layers its 8 ranks' parts, 9.24 GB a rank, would not fit one card
# beside the one-rank reference and 8 CUDA contexts; 16 until phase 8ev
# needed the run's time), bf16, an 8,192-slot
# cache: each rank holds 2,048 full slots and 1,024 ring slots of a B = 1
# cache, 4 of the 8 KV heads. 9v-a: 8 requests homed in pod 0 (prompts of
# 3,900-4,300 tokens, one over the ring and one crossing its wrap while
# decoding, forced), 8 new tokens each (16 before phase 8ev needed the
# run's time), migrating with both schedules;
# 9v-b: one 4,090-token prompt, 8 new tokens, split over ("pod", "data")
# with the locality and the library combine, the decode crossing slot
# 4,096
VARIANT_TIER_ARCHS = (("gemma2-9b", 256), ("h2o-danube-3-4b", 120))
VARIANT_TIER_LAYERS = 8
VARIANT_TIER_CACHE, VARIANT_TIER_NEW = 8192, 8
VARIANT_TIER_PROMPTS = (3900, 4300)
VARIANT_TIER_FORCED = (4200, 4090)           # over the ring; across its wrap
VARIANT_TIER_SEQ_PROMPT = 4090
VARIANT_TIER_REDUCED_CACHE = 128
VARIANT_TIER_REDUCED = ((70, 5), (60, 8))     # past, and across, 64 slots


def variant_tier_requests(vocab: int) -> dict[str, list]:
    """9v's traces: "batch" (8 requests, 3,900-4,300 tokens drawn from seed
    12, the second and third forced to ``VARIANT_TIER_FORCED``: 4,200
    tokens, over the ring, and 4,090, crossing its wrap in decode), "seq"
    (one 4,090-token prompt),
    each with ``VARIANT_TIER_NEW`` new tokens, and the reduced run's
    ("reduced_batch": the first 8 of the CPU test's trace shape, prompts
    of 70 and 60 tokens; "reduced_seq": two prompts)."""
    rng = np.random.default_rng(12)
    lens = rng.integers(VARIANT_TIER_PROMPTS[0], VARIANT_TIER_PROMPTS[1] + 1,
                        TIER_BATCH_N)
    lens[1:3] = VARIANT_TIER_FORCED
    draw = lambda n: rng.integers(0, vocab, int(n))
    return {"batch": [(draw(n), VARIANT_TIER_NEW) for n in lens],
            "seq": [(draw(VARIANT_TIER_SEQ_PROMPT), VARIANT_TIER_NEW)],
            "reduced_batch": [(draw((70, 60)[i % 2]), 2 + i % 5)
                              for i in range(TIER_BATCH_N)],
            "reduced_seq": [(draw(n), m) for n, m in VARIANT_TIER_REDUCED]}


def _variant_tier_configs(key: str) -> list:
    """(arch, config) of 9v's runs at ``key``: both variants reduced in
    fp32 at their real head dims, or gemma2-9b at full width cut to
    ``VARIANT_TIER_LAYERS``."""
    from repro_torch import configs
    from repro_torch.configs import reduced
    if key == "reduced":
        return [(arch, dataclasses.replace(
            reduced(configs.get(arch), head_dim=hd), n_layers=2,
            dtype=torch.float32)) for arch, hd in VARIANT_TIER_ARCHS]
    return [("gemma2-9b", dataclasses.replace(
        configs.get("gemma2-9b"), n_layers=VARIANT_TIER_LAYERS))]


def variant_tier_runs(plan: dict, key: str, vocab: int
                      ) -> list[tuple[str, dict, list, int | None]]:
    """(name, ServeSpec keywords, requests, home pod) of 9v's runs at
    ``key``, "reduced" or "full"; ``vocab`` the config's (the reduced
    traces are redrawn below it)."""
    if key == "reduced":
        cache = VARIANT_TIER_REDUCED_CACHE
        batch = [(t % vocab, m) for t, m in plan["reduced_batch"]]
        seq = [(t % vocab, m) for t, m in plan["reduced_seq"]]
    else:
        cache, batch, seq = VARIANT_TIER_CACHE, plan["batch"], plan["seq"]
    return ([(f"9v-a|{alg}", dict(batch=BATCH_ROWS, cache_len=cache,
                                  page_len=BATCH_PAGE, migrate=alg),
              batch, BATCH_HOME_POD) for alg in TIER_ALGS]
            + [(f"9v-b|{name}", dict(batch=1, cache_len=cache, **kw), seq,
                None) for name, kw in TIER_SEQ_LAYOUTS])


# phase 9e: the MoE family on the same ranks, after 9v. Each model rank
# holds E/m routed experts, its columns of the shared experts and its q and
# KV heads and vocabulary rows, the router whole (``models/tp.moe_tp``).
# First 9l's reduced fp32 llama4 and qwen2-moe on 9l's 128-slot cache and
# traces: 9e-a batch-sharded (8 rows, 12 requests homed in pod 0) with both
# migration schedules, 9e-b one B = 1 split cache with both combines, every
# token equal to the card's one-rank engine. Then qwen2-moe-a2.7b at full
# width (d_model 2,048, 16/16 heads of 128, 64 experts of 1,408 at top-4,
# the shared experts' 5,632 columns; a rank: 32 experts, 8/8 heads, 2,816
# shared columns) cut to 8 of its 24 layers (24 on four model lanes would
# hold ~121 GB of bf16 weights; 8 hold ~5.5 GB a rank), bf16, 9v's 8,192-
# slot cache and traces (below its vocabulary): 9e-a with locality_bruck,
# 9e-b with the locality combine. Held against one-rank engines of the same
# layers first in fp32 at 2 layers ("exact": logits within
# MOE_TIER_EXACT_REL of the largest |logit|; read on an H100: 3e-6), then
# timed in bf16 at 8, where phase 9's rule does not hold and is reported:
# bf16 router logits keep 8 bits, so a rounding that the tier's partial
# sums move by an ulp flips a top-k choice among near-ties, and a flipped
# expert moves its token's output by its gate's share (0.3-1.5 of logits
# near 4.5 in a prefill of ~4,000 tokens; fp32 at the same width: 1e-5)
MOE_TIER_LAYERS, MOE_TIER_EXACT_LAYERS = 8, 2
MOE_TIER_EXACT_REL = 1e-4
MOE_TIER_FULL_RUNS = ("9e-a|locality_bruck", "9e-b|pod_locality")


def _moe_tier_configs(key: str) -> list:
    """(arch, config) of 9e's runs at ``key``: "reduced", 9l's two reduced
    fp32 MoE models; "exact", qwen2-moe-a2.7b at full width in fp32 cut to
    ``MOE_TIER_EXACT_LAYERS``; "full", in bf16 cut to
    ``MOE_TIER_LAYERS``."""
    from repro_torch import configs
    if key == "reduced":
        return _moe_grid_configs("reduced")
    full = configs.get(MOE_ARCH)
    if key == "exact":
        return [(MOE_ARCH, dataclasses.replace(
            full, n_layers=MOE_TIER_EXACT_LAYERS, dtype=torch.float32))]
    return [(MOE_ARCH, dataclasses.replace(full, n_layers=MOE_TIER_LAYERS))]


def moe_tier_runs(plan: dict, key: str, vocab: int
                  ) -> list[tuple[str, dict, list, int | None]]:
    """(name, ServeSpec keywords, requests, home pod) of 9e's runs at
    ``key``: reduced, 9l's traces and cache with both schedules and both
    combines; exact and full, 9v's traces and cache (tokens below
    ``vocab``) with ``MOE_TIER_FULL_RUNS``."""
    if key == "reduced":
        cache, rows = MOE_GRID_REDUCED_CACHE, MOE_GRID_REDUCED_ROWS
        batch, seq = plan["moe"]["reduced_batch"], plan["moe"]["reduced_seq"]
    else:
        cache, rows = VARIANT_TIER_CACHE, BATCH_ROWS
        batch, seq = plan["batch"], plan["seq"]
    batch = [(t % vocab, m) for t, m in batch]
    seq = [(t % vocab, m) for t, m in seq]
    runs = ([(f"9e-a|{alg}", dict(batch=rows, cache_len=cache,
                                  page_len=BATCH_PAGE, migrate=alg),
              batch, BATCH_HOME_POD) for alg in TIER_ALGS]
            + [(f"9e-b|{name}", dict(batch=1, cache_len=cache, **kw), seq,
                None) for name, kw in TIER_SEQ_LAYOUTS])
    return runs if key == "reduced" else [
        r for r in runs if r[0] in MOE_TIER_FULL_RUNS]


# 9v's and 9e's runs on the shared ranks, in order: (the phase's name,
# its configs, its runs, its sizes; each full-width size with the
# logits' limit of phase 9's rule, a share of the largest |logit|, None
# where it is reported and not held)
TIER_SERVE_SETS = (("serve_tier_variants", _variant_tier_configs,
                    variant_tier_runs, {"full": SEQ_LOGIT_REL}),
                   ("serve_moe_tier", _moe_tier_configs, moe_tier_runs,
                    {"exact": MOE_TIER_EXACT_REL, "full": None}))


def tier_variant_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phases 9v and 9e (all eight share the one card): each
    run of 9v's, then of 9e's, at the reduced size, then at full width,
    with this rank's part of the weights drawn from seed 0
    (``init_params(..., part=)``: the one-rank engine's weights, cut)."""
    import torch.distributed as dist
    from repro_torch.core.topology import RankGrid
    from repro_torch.models.tp import TensorParallel
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = RankGrid.build(*TIER_GRID)
    out = {"rank": rank, "reduced": {}, "full": {}, "init_s": {},
           "coords": dict(rank=grid.rank, t=grid.t, grid_rank=grid.grid_rank,
                          tier=list(grid.model.members))}
    for phase, configs_of, runs_of, rels in TIER_SERVE_SETS:
        for key in ("reduced", *rels):
            for arch, cfg in configs_of(key):
                t0 = time.perf_counter()
                params = init_params(
                    cfg, torch.Generator(device="cuda").manual_seed(0),
                    "cuda",
                    part=TensorParallel.build(cfg, grid, use="serve").part)
                torch.cuda.synchronize()
                out["init_s"][f"{key}|{arch}"] = time.perf_counter() - t0
                out.setdefault("layer0", {})[f"{key}|{arch}"] = {
                    n.rsplit(".", 1)[1]: list(t.shape)
                    for n, t in params.items() if n.startswith("layers.0.")}
                for name, kw, reqs, home in runs_of(plan, key,
                                                    cfg.vocab_size):
                    t0 = time.perf_counter()
                    res = serve_on_card(cfg, params, ServeSpec(**kw), reqs,
                                        grid, home)
                    out.setdefault(key, {})[f"{arch}|{name}"] = (
                        res if key != "reduced" else {
                            k: res[k] for k in ("tokens", "results", "stats",
                                                "shards")})
                    dist.barrier()
                    if rank == 0:
                        print(json.dumps({"phase": f"{phase}_run",
                                          "size": key, "model": arch,
                                          "run": name, "seconds":
                                          time.perf_counter() - t0}),
                              flush=True)
                del params
                gc.collect()
                torch.cuda.empty_cache()
    return out


def serve_tier_variants(smi: str) -> dict[str, dict[str, int]]:
    """Phases 9v and 9e: one-rank references in this process, then 8
    spawned ranks (``tier_variant_rank``) on 2 x 2 x 2; phase 9's checks,
    each K/V stack at its own span; prints each run; returns each phase's
    launches per kernel of its full-width runs, summed over the ranks."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec

    full = _variant_tier_configs("full")[0][1]
    plan = variant_tier_requests(full.vocab_size)
    plan["moe"] = moe_grid_requests(configs.get(LLAMA4).vocab_size)
    refs = {}
    for _, configs_of, runs_of, rels in TIER_SERVE_SETS:
        for key in ("reduced", *rels):
            for arch, cfg in configs_of(key):
                params = init_params(cfg, torch.Generator(device="cuda")
                                     .manual_seed(0), "cuda")
                for name, kw, reqs, home in runs_of(plan, key,
                                                    cfg.vocab_size):
                    if (key, arch, name[:4]) in refs:
                        continue
                    one = {k: v for k, v in kw.items()
                           if k not in ("migrate", "combine")}
                    refs[key, arch, name[:4]] = serve_on_card(
                        cfg, params, ServeSpec(**one), reqs, home_pod=home)
                del params
                gc.collect()
                torch.cuda.empty_cache()
    q, pl, m = TIER_GRID
    n = q * pl * m
    t0 = time.perf_counter()
    ranks = run_ranks(n, tier_variant_rank, plan, timeout=900.0)
    ranks_s = time.perf_counter() - t0
    coords = [x["coords"] for x in ranks]
    check([c["grid_rank"] for c in coords] == list(range(n)),
          "serve_tier_variants: grid ranks are not the spawned ranks' order")
    out = {}
    for phase, configs_of, runs_of, rels in TIER_SERVE_SETS:
        _tier_reduced(phase, ranks, refs, plan, configs_of, runs_of,
                      ranks_s)
        out[phase] = {}
        for key, rel in rels.items():
            for arch, cfg in configs_of(key):
                for k, c in _tier_full_width(
                        smi, phase, ranks, refs, plan, key, rel, arch, cfg,
                        runs_of, ranks_s).items():
                    out[phase][k] = out[phase].get(k, 0) + c
    return out


def _stack_totals(cfg, cache: int) -> dict[str, int]:
    """The slots of each K/V stack of ``cfg`` in a ``cache``-slot cache, by
    its leaves' names: the full-length layers' ``k/v`` and the window or
    chunked layers' rings."""
    from repro_torch.models.transformer import ring_cache_len
    lens = {ring_cache_len(cfg, s) for s in cfg.layer_plan()
            if s.mixer == "attn"}
    out = {"k/v": cache} if None in lens else {}
    rings = lens - {None}
    if rings:
        out["k_ring/v_ring"] = min(cache, rings.pop())
    return out


def _tier_reduced(phase: str, ranks: list, refs: dict, plan: dict,
                  configs_of, runs_of, ranks_s: float) -> None:
    """The reduced runs of 9v or 9e: every rank's results alike, tokens
    equal to the one-rank engine's, 2 L + 2 tier calls a forward, none
    across a pod, the decode eager, each split stack over its own span;
    9e's ranks each hold E/m routed experts."""
    q, pl, m = TIER_GRID
    lane = [x["coords"]["rank"] for x in ranks]
    for arch, cfg in configs_of("reduced"):
        L = cfg.n_layers
        if cfg.family == "moe":
            for r, x in enumerate(ranks):
                shapes = x["layer0"][f"reduced|{arch}"]
                check(shapes["gate"][0] == cfg.n_experts // m
                      and shapes["router"] == [cfg.d_model, cfg.n_experts],
                      f"{phase} {arch} rank {r}: experts {shapes['gate']}, "
                      f"router {shapes['router']}")
        for name, *_ in runs_of(plan, "reduced", cfg.vocab_size):
            ref = refs["reduced", arch, name[:4]]
            res = [x["reduced"][f"{arch}|{name}"] for x in ranks]
            what = f"{phase} reduced {arch} {name}"
            for r, x in enumerate(res):
                check(x["results"] == res[0]["results"],
                      f"{what}: rank {r}'s results differ")
                check(x["tokens"] == ref["tokens"],
                      f"{what} rank {r}: tokens {x['tokens']} != "
                      f"one rank's {ref['tokens']}")
                st = x["stats"]
                fwd = st["prefills"] + st["decode_steps"]
                check(st["tier_calls"] == (2 * L + 2) * fwd
                      and st["tier_msgs"] > 0
                      and st["tier_nonlocal_msgs"] == 0,
                      f"{what} rank {r}: tier calls {st['tier_calls']} "
                      f"for {fwd} forwards (the path: {2 * L + 2} a "
                      f"forward), non-local {st['tier_nonlocal_msgs']}")
                check(not st["decode_graph"] and "model tier" in
                      st["decode_graph_rule"], f"{what}: decode graph "
                      f"{st['decode_graph']} ({st['decode_graph_rule']})")
                totals = _stack_totals(cfg, ref["cache_len"])
                want = {names: (lane[r] * t // (q * pl), t // (q * pl), t)
                        for names, t in totals.items()} \
                    if name[3] == "b" else {}
                check(x["shards"] == want, f"{what} rank {r}: shards "
                      f"{x['shards']}, each stack over its own span {want}")
    print(json.dumps({
        "phase": f"{phase}_reduced", "dtype": "float32",
        "grid": "2 x 2 x 2 (pod, data, model)",
        "models": [f"{a}: {c.n_layers} layers, {c.n_heads}/{c.n_kv_heads} "
                   f"heads of {c.head_dim_}" + (
                       f", {c.n_experts} experts at top-{c.top_k}"
                       if c.n_experts else f", window {c.window}")
                   for a, c in configs_of("reduced")],
        "runs": [name for name, *_ in runs_of(plan, "reduced", 512)],
        "tokens_equal_to_one_rank": True, "ranks_wall_s": ranks_s}))


def _tier_full_width(smi: str, phase: str, ranks: list, refs: dict,
                     plan: dict, key: str, rel: float | None, arch: str,
                     full, runs_of, ranks_s: float) -> dict[str, int]:
    """The full-width runs at ``key`` of 9v (gemma2-9b) or 9e
    (qwen2-moe-a2.7b): phase 9's rule against the one-rank engine (logits
    within ``rel`` of the largest |logit|, a differing first token a near
    tie; with ``rel`` None the differences are reported, held to nothing),
    launches exact (the ring instances too), 2 L + 2 tier calls a forward,
    migration and combine messages and bytes the oracle's with each stack
    at its own span, the decode eager; prints a line a run; returns the
    launches per kernel, summed over the ranks."""
    from repro_torch import configs
    q, pl, m = TIER_GRID
    coords = [x["coords"] for x in ranks]
    lane = [c["rank"] for c in coords]
    total = {k: 0 for k in PATH_KERNELS + VARIANT_KERNELS}
    KV_loc, H_loc, D = full.n_kv_heads // m, full.n_heads // m, full.head_dim_
    L = full.n_layers
    ring = _stack_totals(full, VARIANT_TIER_CACHE).get("k_ring/v_ring")
    n_ring = sum(s.attn in ("window", "chunked") for s in full.layer_plan())
    for name, kw, reqs, home in runs_of(plan, key, full.vocab_size):
        res = [x[key][f"{arch}|{name}"] for x in ranks]
        ref = refs[key, arch, name[:4]]
        what = f"{phase} {name}"
        for r, x in enumerate(res):
            for k, c in x["launches"].items():
                total[k] = total.get(k, 0) + c
            want = variant_launches_implied(full, x["stats"])
            check(x["variant_launches"] == want, f"{what}: ring launches "
                  f"{x['variant_launches']}, the path {want}")
            for k, c in x["variant_launches"].items():
                total[k] += c
            st = x["stats"]
            fwd = st["prefills"] + st["decode_steps"]
            check(st["tier_calls"] == (2 * L + 2) * fwd
                  and st["tier_nonlocal_msgs"] == 0
                  and not st["decode_graph"],
                  f"{what} rank {r}: tier calls {st['tier_calls']} for "
                  f"{fwd} forwards, non-local {st['tier_nonlocal_msgs']}, "
                  f"decode graph {st['decode_graph']}")
        scale = max(float(np.abs(t).max())
                    for t in ref["decode_logits"].values())
        limit = (rel or SEQ_LOGIT_REL) * scale
        hold = check if rel is not None else lambda ok, what: None
        toks = res[0]["tokens"]
        got = {w: _tier_logits(res, coords, w, m)
               for w in ("prefill_logits", "decode_logits")}
        for w, lg in got.items():
            check(sorted(lg) == sorted(ref[w]), f"{what}: {w} of "
                  f"{sorted(lg)}, one rank {sorted(ref[w])}")
        # phase 9's rule: logits within the limit, a first token that
        # differs within twice the prefill's difference of the maximum
        dl = {"prefill_logits": {}, "decode_logits": {}, "near_ties": {}}
        for rid in sorted(ref["prefill_logits"]):
            pre = ref["prefill_logits"][rid]
            d = dl["prefill_logits"][rid] = np_err(
                got["prefill_logits"][rid], pre)
            hold(d <= limit, f"{what}: request {rid}'s prefill logits "
                 f"differ from the one-rank engine's by {d} (limit "
                 f"{limit})")
            one, tier = ref["tokens"][rid][0], toks[rid][0]
            if one == tier:
                d = dl["decode_logits"][rid] = np_err(
                    got["decode_logits"][rid], ref["decode_logits"][rid])
                hold(d <= limit, f"{what}: request {rid}'s first decode "
                     f"logits differ from the one-rank engine's by {d} "
                     f"(limit {limit})")
            else:
                gap = float(pre[one] - pre[tier])
                dl["near_ties"][rid] = gap
                hold(gap <= 2 * dl["prefill_logits"][rid],
                     f"{what}: request {rid}'s first token {tier}, one "
                     f"rank's {one}, {gap} below its maximum")
        same = sum(a == b for rid, tk in toks.items()
                   for a, b in zip(tk, ref["tokens"][rid]))
        n_tok = sum(map(len, ref["tokens"].values()))
        steps = res[0]["stats"]["decode_steps"]
        lens = [len(t) for t, _ in reqs]
        row = {"phase": phase, "run": name,
               "shared": "8 ranks sharing one H100 over gloo",
               "grid": "2 x 2 x 2 (pod, data, model)", "model": full.name,
               "layers": L, "ring_layers": n_ring,
               "reduced": f"depth {configs.get(arch).n_layers} -> {L} "
                          f"layers" + (f" ({n_ring} window, {L - n_ring} "
                                       "full)" if n_ring else ""),
               "dtype": str(full.dtype).split(".")[1],
               "cache_len": VARIANT_TIER_CACHE,
               "prompts": lens, "new_tokens": VARIANT_TIER_NEW,
               "kv_heads_per_rank": KV_loc, "q_heads_per_rank": H_loc,
               "decode_steps": steps,
               "decode_step_ms_mean_by_rank": [
                   float(np.mean(x["decode_ms"])) for x in res],
               "decode_step_ms_mean_one_rank": float(np.mean(
                   ref["decode_ms"])),
               "prefill_ms_by_rank": [
                   [x["prefill_ms"][rid] for rid in sorted(x["prefill_ms"])]
                   for x in res],
               "prefill_ms_one_rank": [ref["prefill_ms"][rid]
                                       for rid in sorted(ref["prefill_ms"])],
               "tokens_per_s_by_rank": [n_tok / x["drain_s"] for x in res],
               "tokens_per_s_one_rank": n_tok / ref["drain_s"],
               "tier_calls_per_forward": 2 * L + 2,
               "tier_calls_by_rank": [x["stats"]["tier_calls"] for x in res],
               "tier_host_ms_by_rank": [x["stats"]["tier_host_s"] * 1e3
                                        for x in res],
               "tier_host_ms_per_forward_by_rank": [
                   x["stats"]["tier_host_s"] * 1e3 * (2 * L + 2)
                   / x["stats"]["tier_calls"] for x in res],
               "tier_staged_bytes_by_rank": [x["stats"]["tier_staged_bytes"]
                                             for x in res],
               "staging_bytes_by_rank": [x["stats"]["staging_bytes"]
                                         for x in res],
               "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
               "peak_bytes_one_rank": ref["peak_bytes"],
               "ring_launches_summed": {k: sum(x["variant_launches"][k]
                                               for x in res)
                                        for k in VARIANT_KERNELS},
               "max_abs_dlogit_prefill": dl["prefill_logits"],
               "max_abs_dlogit_first_decode": dl["decode_logits"],
               "first_token_near_ties": dl["near_ties"],
               "logit_tolerance": limit if rel is not None else None,
               "phase9_rule_held": rel is not None,
               "greedy_equal_share": same / n_tok,
               "ranks_wall_s": ranks_s, "card": smi}
        if full.family == "moe":
            shapes = ranks[0]["layer0"][f"{key}|{arch}"]
            row.update(experts_per_rank=shapes["gate"][0],
                       shared_columns_per_rank=shapes["shared_gate"][1])
            check(shapes["gate"][0] == full.n_experts // m
                  and shapes["shared_gate"][1] * m
                  == full.d_shared_expert, f"{what}: a rank's experts "
                  f"{shapes['gate']}, shared {shapes['shared_gate']}")
        if name[3] == "a":
            alg = name.split("|")[1]
            if ring:
                check(max(lens) > ring and any(
                    n <= ring < n + VARIANT_TIER_NEW - 1 for n in lens),
                    f"{what}: no prompt rolls the ring, or none crosses it")
            mig = res[0]["stats"]["migrations"]
            check(mig == TIER_MIGRATIONS, f"{what}: {mig} migrations, the "
                  f"trace's {TIER_MIGRATIONS}")
            for r, x in enumerate(res):
                want = len(reqs) if r // m // pl == BATCH_HOME_POD else 0
                check(x["stats"]["prefills"] == want, f"{what}: rank {r} "
                      f"ran {x['stats']['prefills']} prefills, the path "
                      f"{want}")
            dp = ("pod", "data")
            want_spans = {"k/v": dp} | ({"k_ring/v_ring": dp} if ring
                                        else {})
            check(res[0]["spans"] == want_spans,
                  f"{what}: donor spans {res[0]['spans']}")
            # each stack's K or V slab of a rank's KV heads, bf16, each
            # over ("pod", "data"): the full-length cache's slots and the
            # ring's
            es = full.dtype.itemsize
            leaves = [(L - n_ring) * VARIANT_TIER_CACHE * KV_loc * D * es]
            if ring:
                leaves.append(n_ring * ring * KV_loc * D * es)
            msgs = [sum(v) for v in zip(*(migrate_oracle(alg, q, pl, b)
                                          for b in leaves))]
            nbytes = [sum(v) for v in zip(*(migrate_bytes_oracle(
                alg, q, pl, b) for b in leaves))]
            per_mig = lambda k: [x["stats"][k] / mig for x in res]
            check(per_mig("migrate_nonlocal_msgs") == [msgs[i] for i in lane]
                  and per_mig("migrate_nonlocal_bytes")
                  == [nbytes[i] for i in lane],
                  f"{what}: non-local messages and bytes a migration "
                  f"{per_mig('migrate_nonlocal_msgs')} "
                  f"{per_mig('migrate_nonlocal_bytes')}, the oracle "
                  f"{msgs} {nbytes}")
            row.update(
                migrate=alg, migrations=mig, leaf_bytes=leaves,
                migrate_nonlocal_msgs_per_migration=per_mig(
                    "migrate_nonlocal_msgs"),
                migrate_nonlocal_bytes_per_migration=per_mig(
                    "migrate_nonlocal_bytes"),
                migrate_bytes_per_migration=per_mig("migrate_bytes"),
                migration_host_ms=[x["stats"]["migrate_host_s"] / mig * 1e3
                                   for x in res],
                donor_bytes_per_migration=per_mig("donor_bytes"),
                prefills_by_rank=[x["stats"]["prefills"] for x in res])
        else:
            alg = res[0]["combine"]["algorithm"]
            if ring:
                check(lens[0] < ring < lens[0] + VARIANT_TIER_NEW - 1,
                      f"{what}: the decode does not cross the ring's wrap")
            oracle = combine_oracle(alg, q, pl, H_loc * 4,
                                    H_loc * (D + 1) * 4)
            per_step = lambda k: [x["stats"][k] / steps / L for x in res]
            check(res[0]["stats"]["combine_layers"] == steps * L,
                  f"{what}: {res[0]['stats']['combine_layers']} combines, "
                  f"the path {steps * L}")
            check(per_step("nonlocal_msgs") == [oracle[i][0] for i in lane]
                  and per_step("nonlocal_bytes")
                  == [oracle[i][1] for i in lane],
                  f"{what}: non-local messages and bytes a combine "
                  f"{per_step('nonlocal_msgs')} {per_step('nonlocal_bytes')}"
                  f", the oracle {oracle}")
            row.update(
                combine=res[0]["combine"], shards=res[0]["shards"],
                nonlocal_msgs_per_combine=per_step("nonlocal_msgs"),
                nonlocal_bytes_per_combine=per_step("nonlocal_bytes"),
                combine_bytes_per_step=[x["stats"]["combine_bytes"] / steps
                                        for x in res],
                combine_host_ms_per_step=[x["stats"]["combine_host_s"]
                                          / steps * 1e3 for x in res])
        print(json.dumps(row))
    return total


# ---------------------------------------------------------------------------
# phase 9l: the MoE family on (pod, data) serving grids
# ---------------------------------------------------------------------------
# 4 gloo ranks sharing the card, 2 x 2 (pod, data), every rank holding
# every expert. First the reduced fp32 llama4 (``llama4_reduced``) and the
# reduced fp32 qwen2-moe (2 layers), each held to the card's one-rank
# engine token for token: 9l-a batch-sharded (8 rows, 12 requests of 70
# and 60 tokens homed in pod 0, so that later ones migrate), 9l-b one B = 1
# split cache with the locality combine (two requests, one crossing
# llama4's chunk boundary at 64). Then llama4-scout at full width cut to 2
# layers (both chunked: ~12.9 GB a rank, ~52 GB in all), 16,384 slots:
# 9l-a four requests homed in pod 0 (two of them migrate), 9l-b one 8,300-
# token prompt, its 8,192-slot rings in 2,048-slot shards of which only
# the first keeps slots (pos mod 8,192 < 2,048); held to the one-rank
# engine's logits as phase 9 holds bf16 runs
MOE_GRID = (2, 2)
MOE_GRID_REDUCED_CACHE, MOE_GRID_REDUCED_ROWS = 128, 8
MOE_GRID_REDUCED_SEQ = ((70, 5), (60, 8))
MOE_GRID_LAYERS = 2
MOE_GRID_ROWS = 4
MOE_GRID_BATCH = ((8185, 8), (8300, 8), (3000, 8), (8190, 8))
MOE_GRID_SEQ = ((8300, 8),)
MOE_GRID_MIGRATIONS = 2


def _moe_grid_configs(key: str) -> list:
    """(arch, config) of 9l's runs at ``key``: "reduced", the two reduced
    fp32 MoE models; "full", llama4-scout at full width, 2 layers."""
    from repro_torch import configs
    if key == "reduced":
        return [(LLAMA4, llama4_reduced()),
                (MOE_ARCH, dataclasses.replace(
                    configs.get_smoke(MOE_ARCH), n_layers=2,
                    dtype=torch.float32))]
    return [(LLAMA4, dataclasses.replace(configs.get(LLAMA4),
                                         n_layers=MOE_GRID_LAYERS))]


def moe_grid_requests(vocab: int) -> dict[str, list]:
    """9l's traces (prompt, new tokens), drawn from seed 14 below
    ``vocab`` (the full config's; the reduced traces are redrawn below
    theirs)."""
    rng = np.random.default_rng(14)
    draw = lambda n: rng.integers(0, vocab, int(n))
    news = [4, 7, 3, 6, 2, 5]
    return {"reduced_batch": [(draw((70, 60)[i % 2]), news[i % 6])
                              for i in range(12)],
            "reduced_seq": [(draw(n), m) for n, m in MOE_GRID_REDUCED_SEQ],
            "batch": [(draw(n), m) for n, m in MOE_GRID_BATCH],
            "seq": [(draw(n), m) for n, m in MOE_GRID_SEQ]}


def moe_grid_runs(plan: dict, key: str, vocab: int
                  ) -> list[tuple[str, dict, list, int | None]]:
    """(name, ServeSpec keywords, requests, home pod) of 9l's runs."""
    if key == "reduced":
        cache, rows = MOE_GRID_REDUCED_CACHE, MOE_GRID_REDUCED_ROWS
        batch = [(t % vocab, m) for t, m in plan["reduced_batch"]]
        seq = [(t % vocab, m) for t, m in plan["reduced_seq"]]
    else:
        cache, rows = LLAMA4_CACHE, MOE_GRID_ROWS
        batch, seq = plan["batch"], plan["seq"]
    return [("9l-a|locality_bruck",
             dict(batch=rows, cache_len=cache, page_len=BATCH_PAGE,
                  migrate="locality_bruck"), batch, BATCH_HOME_POD),
            ("9l-b|locality", dict(batch=1, cache_len=cache,
                                   combine="locality"), seq, None)]


def moe_grid_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phase 9l (all four share the one card): each run of
    ``moe_grid_runs`` for both reduced models, then at full width, every
    rank drawing the whole model from seed 0 (the one-rank engine's
    weights)."""
    import torch.distributed as dist
    from repro_torch.core.topology import RankGrid
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = RankGrid.build(*MOE_GRID)
    out = {"rank": rank, "reduced": {}, "full": {}, "init_s": {},
           "coords": dict(rank=grid.rank, grid_rank=grid.grid_rank)}
    for key in ("reduced", "full"):
        for arch, cfg in _moe_grid_configs(key):
            t0 = time.perf_counter()
            params = init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            torch.cuda.synchronize()
            out["init_s"][f"{key}|{arch}"] = time.perf_counter() - t0
            for name, kw, reqs, home in moe_grid_runs(plan, key,
                                                      cfg.vocab_size):
                t0 = time.perf_counter()
                res = serve_on_card(cfg, params, ServeSpec(**kw), reqs, grid,
                                    home)
                out[key][f"{arch}|{name}"] = res if key == "full" else {
                    k: res[k] for k in ("tokens", "results", "stats",
                                        "shards", "launches",
                                        "variant_launches")}
                dist.barrier()
                if rank == 0:
                    print(json.dumps({"phase": "serve_moe_grid_run",
                                      "size": key, "model": arch,
                                      "run": name, "seconds":
                                      time.perf_counter() - t0}), flush=True)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return out


def serve_moe_grids(smi: str) -> dict[str, int]:
    """Phase 9l: one-rank references in this process, then 4 spawned
    ranks (``moe_grid_rank``) on 2 x 2; the reduced runs' tokens equal one
    rank's, the full-width runs' logits within phase 9's limit of one
    rank's; each split stack's shards, the combines and the migrations
    checked; returns the launches per kernel of every run, summed over the
    ranks."""
    from repro_torch.launch.serve import run_ranks
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeSpec

    full = _moe_grid_configs("full")[0][1]
    plan = moe_grid_requests(full.vocab_size)
    refs = {}
    for key in ("reduced", "full"):
        for arch, cfg in _moe_grid_configs(key):
            params = init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0), "cuda")
            for name, kw, reqs, home in moe_grid_runs(plan, key,
                                                      cfg.vocab_size):
                one = {k: v for k, v in kw.items()
                       if k not in ("migrate", "combine")}
                refs[key, arch, name] = serve_on_card(
                    cfg, params, ServeSpec(**one), reqs, home_pod=home)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    q, pl = MOE_GRID
    n = q * pl
    t0 = time.perf_counter()
    ranks = run_ranks(n, moe_grid_rank, plan, timeout=900.0)
    ranks_s = time.perf_counter() - t0
    check([x["coords"]["grid_rank"] for x in ranks] == list(range(n)),
          "serve_moe_grids: grid ranks are not the spawned ranks' order")
    total = {k: 0 for k in PATH_KERNELS + VARIANT_KERNELS}
    for key in ("reduced", "full"):
        for arch, cfg in _moe_grid_configs(key):
            L = cfg.n_layers
            cache = LLAMA4_CACHE if key == "full" else MOE_GRID_REDUCED_CACHE
            chunked = sum(s.attn == "chunked" for s in cfg.layer_plan())
            for name, kw, reqs, home in moe_grid_runs(plan, key,
                                                      cfg.vocab_size):
                ref = refs[key, arch, name]
                res = [x[key][f"{arch}|{name}"] for x in ranks]
                what = f"serve_moe_grids {key} {arch} {name}"
                steps = res[0]["stats"]["decode_steps"]
                for r, x in enumerate(res):
                    check(x["results"] == res[0]["results"],
                          f"{what}: rank {r}'s results differ")
                    if key == "reduced":
                        check(x["tokens"] == ref["tokens"],
                              f"{what} rank {r}: tokens {x['tokens']} != "
                              f"one rank's {ref['tokens']}")
                    for k, c in (x["launches"] | x["variant_launches"]
                                 ).items():
                        if k in total:
                            total[k] += c
                    want = variant_launches_implied(cfg, x["stats"])
                    check(x["variant_launches"] == want, f"{what} rank {r}: "
                          f"ring launches {x['variant_launches']}, the path "
                          f"{want}")
                    st = x["stats"]
                    if name.startswith("9l-a"):
                        home_pod = r // pl == BATCH_HOME_POD
                        check(st["prefills"] == (len(reqs) if home_pod
                                                 else 0),
                              f"{what} rank {r}: {st['prefills']} prefills")
                        check(x["shards"] == {}, f"{what}: shards "
                                                 f"{x['shards']}")
                    else:
                        totals = {"k/v": cache}
                        if chunked:
                            totals["k_ring/v_ring"] = min(cache, cfg.chunk)
                        if chunked == L:
                            totals.pop("k/v")
                        want = {nm: (r * t // n, t // n, t)
                                for nm, t in totals.items()}
                        check(x["shards"] == want, f"{what} rank {r}: "
                              f"shards {x['shards']}, want {want}")
                        check(st["combine_layers"] == st["decode_steps"] * L
                              and st["decode_steps"] > 0, f"{what} rank "
                              f"{r}: {st['combine_layers']} combines")
                if name.startswith("9l-a"):
                    mig = res[0]["stats"]["migrations"]
                    check(mig > 0, f"{what}: no migration")
                    if key == "full":
                        check(mig == MOE_GRID_MIGRATIONS, f"{what}: {mig} "
                              f"migrations, the trace's "
                              f"{MOE_GRID_MIGRATIONS}")
                if key == "reduced":
                    continue
                # phase 9's rule for bf16 runs: logits within the limit, a
                # first token that differs within twice the prefill's
                # difference of the maximum
                coords = [x["coords"] for x in ranks]
                got = {w: _tier_logits(res, [dict(c, t=0) for c in coords],
                                       w, 1)
                       for w in ("prefill_logits", "decode_logits")}
                scale = max(float(np.abs(t).max())
                            for t in ref["decode_logits"].values())
                limit = SEQ_LOGIT_REL * scale
                toks = res[0]["tokens"]
                dl = {"prefill": {}, "decode": {}, "near_ties": {}}
                for rid in sorted(ref["prefill_logits"]):
                    pre = ref["prefill_logits"][rid]
                    d = dl["prefill"][rid] = np_err(
                        got["prefill_logits"][rid], pre)
                    check(d <= limit, f"{what}: request {rid}'s prefill "
                          f"logits differ by {d} (limit {limit})")
                    one, grid_tok = ref["tokens"][rid][0], toks[rid][0]
                    if one == grid_tok:
                        d = dl["decode"][rid] = np_err(
                            got["decode_logits"][rid],
                            ref["decode_logits"][rid])
                        check(d <= limit, f"{what}: request {rid}'s first "
                              f"decode logits differ by {d} (limit {limit})")
                    else:
                        gap = float(pre[one] - pre[grid_tok])
                        dl["near_ties"][rid] = gap
                        check(gap <= 2 * dl["prefill"][rid],
                              f"{what}: request {rid}'s first token "
                              f"{grid_tok}, one rank's {one}, {gap} below "
                              "its maximum")
                same = sum(a == b for rid, tk in toks.items()
                           for a, b in zip(tk, ref["tokens"][rid]))
                n_tok = sum(map(len, ref["tokens"].values()))
                lens = [len(t) for t, _ in reqs]
                row = {"phase": "serve_moe_grids", "run": name,
                       "shared": "4 ranks sharing one H100 over gloo",
                       "grid": "2 x 2 (pod, data)", "model": cfg.name,
                       "layers": L,
                       "reduced": f"depth 48 -> {L} layers (both chunked)",
                       "dtype": "bfloat16", "cache_len": cache,
                       "chunk": cfg.chunk, "prompts": lens,
                       "new_tokens": [m for _, m in reqs],
                       "decode_steps": steps,
                       "decode_step_ms_mean_by_rank": [
                           float(np.mean(x["decode_ms"])) for x in res],
                       "decode_step_ms_mean_one_rank": float(np.mean(
                           ref["decode_ms"])),
                       "prefill_ms_by_rank": [
                           [x["prefill_ms"][i] for i in sorted(
                               x["prefill_ms"])] for x in res],
                       "prefill_ms_one_rank": [
                           ref["prefill_ms"][i]
                           for i in sorted(ref["prefill_ms"])],
                       "staging_bytes_by_rank": [x["stats"]["staging_bytes"]
                                                 for x in res],
                       "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
                       "peak_bytes_one_rank": ref["peak_bytes"],
                       "init_s_by_rank": [x["init_s"][f"full|{arch}"]
                                          for x in ranks],
                       "ring_launches_summed": {
                           k: sum(x["variant_launches"][k] for x in res)
                           for k in VARIANT_KERNELS},
                       "max_abs_dlogit_prefill": dl["prefill"],
                       "max_abs_dlogit_first_decode": dl["decode"],
                       "first_token_near_ties": dl["near_ties"],
                       "logit_tolerance": limit,
                       "greedy_equal_share": same / n_tok,
                       "ranks_wall_s": ranks_s, "card": smi}
                if name.startswith("9l-a"):
                    mig = res[0]["stats"]["migrations"]
                    row.update(
                        migrations=mig,
                        migrate_bytes_per_migration=[
                            x["stats"]["migrate_bytes"] / mig for x in res],
                        migrate_nonlocal_msgs_per_migration=[
                            x["stats"]["migrate_nonlocal_msgs"] / mig
                            for x in res],
                        migration_host_ms=[x["stats"]["migrate_host_s"]
                                           / mig * 1e3 for x in res],
                        prefills_by_rank=[x["stats"]["prefills"]
                                          for x in res])
                else:
                    kept = [(lens[0] % cfg.chunk) >= r * (cfg.chunk // n)
                            for r in range(n)]
                    check(kept == [True] + [False] * (n - 1),
                          f"{what}: the prompt leaves shards {kept} with "
                          "kept slots, want the first alone")
                    row.update(
                        combine=res[0]["combine"], shards=res[0]["shards"],
                        shards_with_kept_slots=kept,
                        combine_host_ms_per_step=[
                            x["stats"]["combine_host_s"] / steps * 1e3
                            for x in res],
                        nonlocal_msgs_per_step=[
                            x["stats"]["nonlocal_msgs"] / steps
                            for x in res])
                print(json.dumps(row))
    print(json.dumps({
        "phase": "serve_moe_grids_reduced", "grid": "2 x 2 (pod, data)",
        "dtype": "float32",
        "models": [f"{a} ({c.n_layers} layers, head dim {c.head_dim_}, "
                   f"chunk {c.chunk})" for a, c in
                   _moe_grid_configs("reduced")],
        "runs": [name for name, *_ in moe_grid_runs(plan, "reduced", 512)],
        "cache_len": MOE_GRID_REDUCED_CACHE,
        "tokens_equal_to_one_rank": True, "ranks_wall_s": ranks_s}))
    return total


# ---------------------------------------------------------------------------
# phase 2c: the training path's backward kernels against their plain versions
# ---------------------------------------------------------------------------
# the training step's attention (llama3.2-3b, B = 4 sequences of 1,024
# tokens, 24/8 heads of 128) causal, and the same with a window and a chunk;
# RMSNorm over its 4,096 rows of 3,072
TRAIN_FLASH = (4, 1024, 24, 8, 128)
TRAIN_FLASH_MASKS = (dict(causal=True), dict(causal=True, window=256),
                     dict(causal=True, chunk=256))
TRAIN_RMS = (4096, 3072)
# one rank of phase 8c (bf16): one sequence of 1,024 tokens, so attention at
# B = 1 and RMSNorm over 1,024 rows
FSDP_RANK_FLASH = (1, 1024, 24, 8, 128)
FSDP_RANK_RMS = (1024, 3072)
# one rank of phase 8e (bf16): a model rank's 12 q and 4 KV heads of one
# sequence, and the residual RMSNorm over its 1,024 rows, or 512 when the
# residual stream is split over the sequence (seq_shard, m = 2)
TP_RANK_FLASH = (1, 1024, 12, 4, 128)
TP_RANK_RMS = ((1024, 3072), (512, 3072))
# one rank of phase 10b (bf16): qwen2-moe-a2.7b's 16 q and 16 KV heads of
# 128 over one 1,024-token sequence, its norms 2,048 wide
MOE_RANK_FLASH = (1, 1024, 16, 16, 128)
MOE_RANK_RMS = (1024, 2048)
# one rank of phase 10c: 10b's sequence over a model rank's 8/8 heads
MOE_TIER_RANK_FLASH = (1, 1024, 8, 8, 128)
# the flash backward's tolerances, as tests/test_torch_cuda.py states them:
# fp32 against the plain backward; bf16 against the plain backward in fp32
# on the same bf16 inputs, mostly relative (the kernel sums in fp32 and
# rounds once, so a gradient is within a bf16 ulp of its own size)
FLASH_BWD_TOL = {torch.float32: dict(tol=1e-4),
                 torch.bfloat16: dict(tol=1e-3, rtol=1e-2)}
# the forward's lse against the plain version's (fp32 sums either way)
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


# the backward kernels' times before their redesign (the CUDA-core flash
# backward, the RMSNorm backward in two kernels), quoted from PERF.md's
# kernel table (PR 19's chip run, NVIDIA H100 80GB HBM3, 700.00 W) on
# lines of their own, never in the kernels' line:
# (kind, shape, mask or form) -> {the pair or the backward, each kernel}
QUOTED_PR19_MS = {
    ("flash", (4, 1024, 24, 8, 128), "causal"):
        dict(pair=5.638, dq=2.542, dkdv=3.113),
    ("flash", (1, 1024, 24, 8, 128), "causal"):
        dict(pair=2.165, dq=0.769, dkdv=1.403),
    ("rmsnorm", (4096, 3072), "plain"):
        dict(pair=0.0540, rows=0.0464, sums=0.0151),
    ("rmsnorm", (4096, 3072), "residual"): dict(pair=0.0646),
    ("rmsnorm", (1024, 3072), "plain"):
        dict(pair=0.0366, rows=0.0329, sums=0.00796),
    ("rmsnorm", (1024, 3072), "residual"): dict(pair=0.0442),
}
# gemma2-9b's bf16 D = 256 pair on the CUDA cores, before the tensor-core
# instance took it, quoted from PERF.md's kernel table (NVIDIA H100 80GB
# HBM3, 700.00 W) on a line of its own, never in the kernels' line:
# (shape, mask) -> {the pair, each kernel}
QUOTED_D256_CUDA_CORES_MS = {
    ((4, 1024, 16, 8, 256), "causal+cap=50.0"):
        dict(pair=12.44, dq=5.99, dkdv=6.47),
}
# the tensor-core pair's tile edges (B, S, H, KV, D, mask): S at 63, 65 and
# 129, G = 1, 2, 3 and 8, D = 32, 64, 128 and 256, window, chunk and cap;
# at D = 256 gemma2's heads at B = 1 (128 (kv head, key tile) blocks:
# dk/dv splits its G = 2 over a cluster of two) and one block a kv head;
# bf16, held against the plain backward and timed beside it
FLASH_BWD_EDGES = ((1, 65, 8, 8, 128, dict(causal=True)),
                   (4, 129, 24, 8, 128, dict(causal=True, window=64)),
                   (2, 63, 8, 1, 64, dict(causal=True)),
                   (2, 1024, 16, 2, 64, dict(causal=True, chunk=256)),
                   (4, 1024, 12, 4, 32, dict(causal=True)),
                   (1, 1024, 16, 8, 256, dict(causal=True, cap=50.0)),
                   (1, 1024, 16, 8, 256, dict(causal=True)),
                   (2, 129, 8, 1, 256, dict(causal=True, window=64)),
                   (1, 65, 4, 4, 256, dict(causal=False)),
                   (4, 257, 16, 8, 256, dict(causal=True, chunk=128,
                                             cap=30.0)))


# phase 8v's flash backward (B, S, H, KV, D, mask, with the forward): the
# training steps of h2o-danube-3-4b (32/8 heads of 120, its 4,096 window
# inert at 1,024 tokens; library SDPA's causal backward) and gemma2-9b
# (16/8 heads of 256, cap 50: the tensor-core pair's two-warpgroup
# instance; no library, SDPA's uncapped backward printed as a yardstick),
# gemma2's heads uncapped (beside SDPA's backward of the same function),
# h2o-danube at 6,000 tokens where the window bites (SDPA with a boolean
# mask), and cap 50 on the tensor cores at D = 128 (llama's heads)
VARIANT_FLASH_BWD = (
    (4, 1024, 32, 8, 120, dict(causal=True, window=4096), True),
    (4, 1024, 16, 8, 256, dict(causal=True, cap=50.0), True),
    (4, 1024, 16, 8, 256, dict(causal=True), False),
    (1, 6000, 32, 8, 120, dict(causal=True, window=4096), False),
    (4, 1024, 24, 8, 128, dict(causal=True, cap=50.0), False))

# phase 8ev's flash at a model rank's heads (B, S, H, KV, D, mask), bf16, one
# 1,024-token sequence: gemma2-9b on m = 2, 8/4 heads of 256 (the
# two-warpgroup instance) with cap 50 (no library) and uncapped beside
# SDPA; h2o-danube-3-4b on m = 2, 16/4 heads of 120 (the D = 128
# instance), its 4,096 window inert at 1,024 tokens, beside SDPA's causal
# backward
TIER_VARIANT_FLASH_BWD = ((1, 1024, 8, 4, 256, dict(causal=True, cap=50.0)),
                          (1, 1024, 8, 4, 256, dict(causal=True)),
                          (1, 1024, 16, 4, 120, dict(causal=True,
                                                     window=4096)))


def _mask_name(mask: dict) -> str:
    return "+".join(k if v is True else f"{k}={v}" for k, v in mask.items())


def _visible(S: int, mask: dict, device="cpu") -> torch.Tensor:
    """(S, S) bool: the pairs the mask keeps (the kernels' masks)."""
    from repro_torch.kernels.flash_attention.ref import visible
    return visible(S, S, causal=mask["causal"],
                   window=mask.get("window", 0), chunk=mask.get("chunk", 0),
                   device=device)


def _pairs(S: int, mask: dict) -> int:
    return int(_visible(S, mask).sum())


def flash_bwd_launch(q, k, v, o, do, lse, delta, out, mask, which: str):
    """One backward kernel alone, through the C entry point of the instance
    the wrapper picks, with the wrapper's arguments (to time each of the two
    apart)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    tail = (B, S, T, H, KV, D, float(D ** -0.5), int(mask["causal"]),
            int(mask.get("window", 0)), int(mask.get("chunk", 0)),
            float(mask.get("cap", 0.0)))
    lib = _build.lib()
    if flash_ops.bwd_on_tensor_cores(q.dtype, D):
        tail, sfx = (*tail, _build.stream_of(q)), "_wgmma"
    else:
        tail, sfx = (*tail, _build.dtype_code(q.dtype),
                     _build.stream_of(q)), ""
    if which == "dq":
        err = getattr(lib, "repro_flash_bwd_dq" + sfx)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            out[0].data_ptr(), *tail)
    else:
        err = getattr(lib, "repro_flash_bwd_dkdv" + sfx)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), *tail)
    _build.check(err, f"flash_attention_bwd ({which})")


def flash_bwd_case(timer, g, dtype, mask, shape=TRAIN_FLASH,
                   path="train_one_rank", full: bool = True) -> dict:
    """The flash backward at a training shape (``path``'s): dq, dk, dv
    against the plain backward on the same (o, lse), two calls bitwise
    equal, the instance that served it (by its launch counter); each kernel
    and the pair timed beside the plain version and SDPA's backward (the
    library yardstick, timed here only: ``is_causal`` for the causal mask,
    else the mask as a boolean ``attn_mask``). With
    ``full``, also the forward's o and lse against the plain forward, and
    the forward timed with and without lse."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    B, S, H, KV, D = shape
    rn = lambda *shape: torch.randn(shape, generator=g,
                                    device="cuda").to(dtype)
    q, k, v, do = rn(B, S, H, D), rn(B, S, KV, D), rn(B, S, KV, D), \
        rn(B, S, H, D)
    o, lse = flash_ops.flash_attention_lse(q, k, v, **mask)
    what = f"flash {dtype} {shape} {mask}"
    extra = {}
    if full:
        check(torch.equal(o, flash_ops.flash_attention(q, k, v, **mask)),
              f"{what}: the lse instance's o differs")
        ref_o, ref_lse = flash_ops.attention_lse_ref(q, k, v, **mask)
        extra.update(
            max_abs_err_forward_o=close(
                o, ref_o, 2e-2 if dtype == torch.bfloat16 else 1e-4,
                f"{what} forward o"),
            max_abs_err_forward_lse=close(lse, ref_lse, LSE_TOL[dtype],
                                          f"{what} forward lse"))
        del ref_o, ref_lse
    bwd = lambda: flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    n_wgmma = flash_ops.BWD_WGMMA_LAUNCHES
    got = bwd()
    instance = ("tensor_cores" if flash_ops.BWD_WGMMA_LAUNCHES - n_wgmma == 2
                else "cuda_cores")
    check(instance == ("tensor_cores" if flash_ops.bwd_on_tensor_cores(
        dtype, D) else "cuda_cores"), f"{what}: served by {instance}")
    check(all(torch.equal(a, b) for a, b in zip(got, bwd())),
          f"{what} backward: two calls differ")
    up = lambda t: t.float()
    ref = flash_ops.attention_bwd_ref(up(q), up(k), up(v), up(o), up(do),
                                      lse, **mask)
    errs = [close(a, b, what=f"{what} backward d{n} vs fp32 plain",
                  **FLASH_BWD_TOL[dtype]) for a, b, n in zip(got, ref, "qkv")]
    typical = [float(b.abs().mean()) for b in ref]
    del ref
    pairs = B * _pairs(S, mask)
    es = q.element_size()
    big, small = q.numel() * es, k.numel() * es
    stats = 2 * B * H * S * 4                       # lse and delta, fp32
    delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    outs = tuple(torch.empty_like(t) for t in (q, k, v))
    flash_bwd_launch(q, k, v, o, do, lse, delta, outs, mask, "dq")
    rows = {}
    for which, macs, nbytes in (
            ("dq", 3, 4 * big + 2 * small + stats),
            ("dkdv", 4, 2 * big + 4 * small + stats)):
        b_ms, b_by = bound(nbytes, 2 * macs * D * H * pairs, dtype)
        rows[which] = dict(
            ms=timer(lambda: flash_bwd_launch(q, k, v, o, do, lse, delta,
                                              outs, mask, which)),
            bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(4 * big + 4 * small + stats, 10 * D * H * pairs,
                       dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    window = mask.get("window", 0)        # inert from S keys on
    causal_only = mask["causal"] and not mask.get("chunk") \
        and (not window or window >= S)
    band = (dict(is_causal=True) if causal_only else
            dict(attn_mask=_visible(S, mask, device="cuda")))
    out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **band)
    dot = do.transpose(1, 2).contiguous()
    sdpa_ms = timer(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                retain_graph=True))
    # SDPA has no softcap: with a cap there is no library call, and SDPA's
    # uncapped backward is printed beside it as a yardstick only
    lib_ms = None if mask.get("cap") else sdpa_ms
    if mask.get("cap"):
        extra["sdpa_uncapped_yardstick_ms"] = sdpa_ms
    if full:                # SDPA's forward on the same inputs (no grad)
        with torch.no_grad():
            fwd_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **band))
        extra["forward_library_ms"] = None if mask.get("cap") else fwd_ms
        if mask.get("cap"):
            extra["forward_sdpa_uncapped_yardstick_ms"] = fwd_ms
    del out, qt, kt, vt, dot
    if full:
        fwd = lambda: flash_ops.flash_attention(q, k, v, **mask)
        fwd_lse = lambda: flash_ops.flash_attention_lse(q, k, v, **mask)
        fb_ms, fb_by = bound((2 * big + 2 * small) * 1.0, 4 * D * H * pairs,
                             dtype)
        extra.update(forward_ms=timer(fwd), forward_lse_ms=timer(fwd_lse),
                     forward_bound_ms=fb_ms, forward_bound_by=fb_by)
    ms = timer(bwd)
    return dict(shape=[B, S, H, KV, D], mask=mask, dtype=str(dtype),
                path=path, instance=instance, max_abs_err=max(errs),
                max_abs_err_dq_dk_dv=errs, mean_abs_dq_dk_dv=typical,
                tolerance=FLASH_BWD_TOL[dtype], ms=ms,
                tflops_7d=14 * D * H * pairs / ms / 1e9,
                host_ms=timer.host_ms(bwd),
                plain_ms=timer(lambda: flash_ops.attention_bwd_ref(
                    q, k, v, o, do, lse, **mask), iters=3),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                dq=rows["dq"], dkdv=rows["dkdv"], **extra)


def rmsnorm_bwd_case(timer, g, dtype, residual: bool, shape=TRAIN_RMS,
                     path="train_one_rank") -> dict:
    """RMSNorm's backward at a training path's rows (plain, and the residual
    form with the sum's own gradient): dx and dscale against the plain
    backward, two calls bitwise equal, one launch a call (the rows and the
    dscale sums), timed beside the plain version and ``F.rms_norm``'s
    autograd backward (the library yardstick, timed here only)."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    rows, d = shape
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    x, dy = (rn(rows, d) * 2).to(dtype), rn(rows, d).to(dtype)
    sc = (rn(d) * 0.2).to(dtype)
    ds = rn(rows, d).to(dtype) if residual else None
    fn = lambda: rms_ops.rmsnorm_bwd(x, sc, dy, ds=ds)
    n = rms_ops.BWD_LAUNCHES
    dx, dsc = fn()
    dx2, dsc2 = fn()
    form = "residual" if residual else "plain"
    what = f"rmsnorm backward {form} {dtype} {shape}"
    check(rms_ops.BWD_LAUNCHES - n == 2, f"{what}: not one launch a call")
    from repro_torch.kernels import _build
    blocks = _build.lib().repro_rmsnorm_bwd_last_blocks()
    check(torch.equal(dx, dx2) and torch.equal(dsc, dsc2),
          f"{what}: two calls differ")
    rdx, rdsc = rms_ops.rmsnorm_bwd_ref(x, sc, dy, ds=ds)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = close(dx, rdx, tol, f"{what} dx")
    err_sc = close(dsc, rdsc, 1e-4 if dtype == torch.float32 else tol,
                   f"{what} dscale")
    es = x.element_size()
    n_in = 3 if residual else 2
    b_ms, b_by = bound((n_in + 1) * rows * d * es + 2 * d * es, 8 * rows * d,
                       dtype)
    xl = x.clone().requires_grad_(True)
    wl = (1.0 + sc).requires_grad_(True)
    y = F.rms_norm(xl, (d,), wl, 1e-5)
    lib_ms = timer(lambda: torch.autograd.grad(y, (xl, wl), dy,
                                               retain_graph=True))
    del y
    return dict(form=form, shape=[rows, d], dtype=str(dtype), path=path,
                blocks=blocks, max_abs_err=err, max_abs_err_dscale=err_sc,
                tolerance=tol,
                ms=timer(fn), host_ms=timer.host_ms(fn),
                plain_ms=timer(lambda: rms_ops.rmsnorm_bwd_ref(x, sc, dy,
                                                               ds=ds)),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


# the mamba2-780m training step's SSD (B = 4 sequences of 1,024 tokens, 48
# heads of P = 64, N = 128, G = 1; bf16 and fp32), a G = 2, N = 64 case and
# an S that is not a multiple of 64 (bf16); the gated RMSNorm over its 4,096
# rows of 3,072, z the first 3,072 of in_proj's 6,448 columns
TRAIN_SSD = (4, 1024, 48, 64, 1, 128)
SSD_BWD_EXTRA = ((1, 1024, 48, 64, 2, 64), (1, 1000, 48, 64, 1, 128))
# the card tests' SSD backward shapes (``checks.BWD_CASES``: the forward's
# edges, the training shape at one sequence, the mamba2 widths at a ragged
# S with all 48 heads in one group, P = 80), held against the plain
# backward in bf16 and fp32, untimed
# the SSD backward's times before this design (the fp32 CUDA-core kernels,
# given the forward's chunk states), quoted from PERF.md's kernel table (in
# brackets there; NVIDIA H100 80GB HBM3, 700.00 W) on lines of their own,
# never in the kernels' line: (shape, dtype) -> ms
QUOTED_SSD_BWD_MS = {
    (TRAIN_SSD, "torch.bfloat16"): 1.598, (TRAIN_SSD, "torch.float32"): 1.526,
    (SSD_BWD_EXTRA[0], "torch.bfloat16"): 0.245,
    (SSD_BWD_EXTRA[1], "torch.bfloat16"): 0.424}
TRAIN_GATED = (4096, 3072, 6448)
def ssd_bwd_macs(Bt, S, H, P, G, N) -> int:
    """Multiply-adds of the chunked backward in 64-token chunks, the states
    before the chunks recomputed (the forward keeps none): per chunk and
    head its contributions to the states, B^T (w x), and to their gradient,
    C^T (exp(cum) dy), and B Dh, dy h^T and x Dh^T (5 Q N P; the inter-chunk
    term of dcum, exp(cum_i) C_i . (dy h^T)_i, takes no product of its
    own), and the causal halves of dy x^T and M^T dy (P wide); per chunk
    and group the causal halves of C B^T, (sum_h G_h) B and (sum_h G_h)^T
    C (N wide: B and C are the group's, so G is summed over its heads
    first, :func:`ssd_bwd_adds`)."""
    Q = 64
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    return Bt * nc * (H * (5 * Q * N * P + 2 * tri * P) + 3 * G * tri * N)


def ssd_bwd_adds(Bt, S, H, P, G, N) -> int:
    """The additions of sum_h G_h over the heads of each group: the causal
    half of a 64 x 64 tile a chunk and head."""
    Q = 64
    return Bt * -(-S // Q) * H * Q * (Q + 1) // 2


def ssd_bwd_split_macs(Bt, S, H, P, G, N, dtype) -> int:
    """:func:`ssd_bwd_macs`' products, each times its split-bf16 terms, as
    :func:`ssd_split_macs` counts the forward's: bf16 inputs (x, B, C)
    enter exactly, an fp32 operand (dy, h, Dh, M, the summed G, w x,
    exp(cum) dy) is split into hi and lo; so with bf16 inputs C B^T takes 1
    term, dy h^T and M^T dy (both operands fp32) 3, the others 2; fp32
    inputs take 3 everywhere."""
    Q = 64
    nc, tri = -(-S // Q), Q * (Q + 1) // 2
    if dtype != torch.bfloat16:
        return 3 * ssd_bwd_macs(Bt, S, H, P, G, N)
    return Bt * nc * (H * (11 * Q * N * P + 5 * tri * P) + 5 * G * tri * N)


def ssd_bwd_case(timer, shape, dtype, path="train_one_rank_ssm",
                 timed=True) -> dict:
    """The SSD backward at a training shape as the training path calls it:
    dx, ddt, dA, dB, dC against the plain backward (fp32 on the same
    inputs), two calls bitwise equal, its ``BWD_KERNELS`` launches counted
    a call, timed beside the plain version (``timed``); no PyTorch call
    computes it (library null). The bound is the forward's: the split-bf16
    products (the states' recompute included) at the tensor cores' bf16
    rate, or the bytes of the inputs and outputs, the larger; the fp32
    products on the CUDA cores (the design before this one) apart."""
    from repro_torch.kernels.ssd import checks as ssd_checks
    from repro_torch.kernels.ssd import ops as ssd_ops
    Bt, S, H, P, G, N = shape
    *ins, dy = ssd_inputs(S, H, P, G, N, dtype, seed=3, batch=Bt,
                          with_dy=True)
    fn = lambda: ssd_ops.ssd_bwd(*ins, dy)
    n = ssd_ops.BWD_LAUNCHES
    got = fn()
    again = fn()
    what = f"ssd backward {dtype} {shape}"
    check(ssd_ops.BWD_LAUNCHES - n == 2 * ssd_ops.BWD_KERNELS,
          f"{what}: not {ssd_ops.BWD_KERNELS} launches a call")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two calls differ")
    del again
    up = [t.float() if t.dtype == torch.bfloat16 else t for t in ins]
    want = ssd_ops.ssd_bwd_ref(*up, dy, Q=256)
    rel = {}
    for name, a, b in zip(ssd_checks.BWD_REL, got, want):
        rel[name] = (float((a.float() - b).abs().max())
                     / max(float(b.abs().max()), 1e-30))
        tol = ssd_checks.bwd_limit(name, dtype == torch.bfloat16)
        check(rel[name] < tol and bool(torch.isfinite(a).all()),
              f"{what}: {name} rel err {rel[name]} (limit {tol})")
    err = max(float((a.float() - b).abs().max()) for a, b in zip(got, want))
    del got, want, up
    if not timed:
        return dict(shape=list(shape), dtype=str(dtype), rel_err=rel)
    # each input read once and each output written once; the kernel's own
    # scratch (the states, their gradients, dA's shares) is its design's
    es = ins[0].element_size()
    nbytes = (2 * Bt * S * H * P * es + Bt * S * H * P * 4     # x, dx; dy
              + 4 * Bt * S * G * N * es + 2 * Bt * S * H * 4   # B C dB dC
              + 2 * H * 4)                                     # dt ddt; A dA
    split = ssd_bwd_split_macs(*shape, dtype)
    # the sum over heads on the CUDA cores before the products that take it
    adds_ms = ssd_bwd_adds(*shape) / PEAK_FLOPS[torch.float32] * 1e3
    ops_ms = 2 * split / PEAK_FLOPS[torch.bfloat16] * 1e3 + adds_ms
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                  else (ops_ms, "operations"))
    cc_ms, _ = bound(nbytes, 2 * ssd_bwd_macs(*shape) + ssd_bwd_adds(*shape),
                     torch.float32)
    # each of its kernels' device time (the scans, dB and dC, dx, dA's
    # sum), at the training shape
    if path == "train_one_rank_ssm":
        profile_window("profile_ssd_bwd", path, fn, 5,
                       sums={k: f"ssd_bwd_{k}" for k in ("scan", "dbdc",
                                                         "dx", "da")},
                       shape=list(shape), dtype=str(dtype))
    return dict(form="scan", shape=list(shape), dtype=str(dtype), path=path,
                max_abs_err=err, rel_err=rel,
                tolerance={"fp32": ssd_checks.BWD_REL, "bf16_dx_dB_dC":
                           ssd_checks.BWD_BF16_REL},
                ms=timer(fn, iters=5), host_ms=timer.host_ms(fn, iters=5),
                plain_ms=timer(lambda: ssd_ops.ssd_bwd_ref(*ins, dy, Q=256),
                               iters=2, warmup=1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bound_cuda_core_ms=cc_ms, bytes=nbytes,
                split_tensor_core_gflop=2 * split / 1e9,
                fp32_gflop=2 * ssd_bwd_macs(*shape) / 1e9)


def gated_bwd_case(timer, g, dtype, shape=TRAIN_GATED,
                   path="train_one_rank_ssm") -> dict:
    """The gated RMSNorm backward over a training step's rows, z a column
    slice of in_proj's output: dy, dz and dscale against the plain
    backward, two calls bitwise equal, one launch a call, timed beside the
    plain version. No PyTorch call computes it (library null); the partial
    yardstick beside it is ``F.rms_norm``'s autograd backward on the gated
    product alone (the norm without the gate), timed here only."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    rows, d, width = shape
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    y = rn(rows, d) * 2
    z = (rn(rows, width) * 2).to(dtype)[:, :d]
    sc = (rn(d) * 0.2).to(dtype)
    dout = rn(rows, d).to(dtype)
    fn = lambda: rms_ops.rmsnorm_gated_bwd(y, z, sc, dout)
    n = rms_ops.FORM_BWD_LAUNCHES["gated"]
    got, again = fn(), fn()
    what = f"rmsnorm backward gated {dtype} {shape}"
    check(rms_ops.FORM_BWD_LAUNCHES["gated"] - n == 2,
          f"{what}: not one launch a call")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two calls differ")
    want = rms_ops.rmsnorm_gated_bwd_ref(y, z, sc, dout)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    errs = [close(got[0], want[0], 1e-5, f"{what} dy"),
            close(got[1], want[1], tol, f"{what} dz"),
            close(got[2], want[2], 1e-4 if dtype == torch.float32 else tol,
                  f"{what} dscale")]
    es = z.element_size()
    b_ms, b_by = bound(rows * d * (4 + es + es + 4 + es) + 2 * d * es,
                       20 * rows * d, dtype)
    gp = (y.to(dtype) * F.silu(z)).requires_grad_(True)   # the product
    wl = (1.0 + sc).requires_grad_(True)
    out = F.rms_norm(gp, (d,), wl, 1e-5)
    partial_ms = timer(lambda: torch.autograd.grad(out, (gp, wl), dout,
                                                   retain_graph=True))
    del out, gp
    return dict(form="gated", shape=[rows, d], z_width=width,
                dtype=str(dtype), path=path, max_abs_err=max(errs),
                max_abs_err_dy_dz_dscale=errs, tolerance=tol,
                ms=timer(fn), host_ms=timer.host_ms(fn),
                plain_ms=timer(lambda: rms_ops.rmsnorm_gated_bwd_ref(
                    y, z, sc, dout)),
                library_ms=None,
                partial_yardstick_ms=partial_ms,
                partial_yardstick="F.rms_norm autograd backward on the "
                                  "gated product alone (no gate)",
                bound_ms=b_ms, bound_by=b_by)


# the Mamba2 mixer on a model tier (phases 8f and 9m): one rank's shapes of
# mamba2-780m's d_inner of 3,072 split by SSD heads over m = 2 (1,536
# columns, 24 heads) and m = 4 (768, 12), at 8f's 1,024 rows (one sequence
# a DP rank), z a column slice of the rank's in_proj output (2 d_inner / m
# + 2GN + H / m wide: its z, x, B, C and dt)
SSM_TIER_MS = (2, 4)
SSM_TIER_ROWS = 1024
SSM_D_INNER, SSM_GN, SSM_HEADS = 3072, 256, 48
SSM_TIER_SSD = tuple((1, 1024, SSM_HEADS // m, 64, 1, 128)
                     for m in SSM_TIER_MS)


def tier_gated_cases(timer, g, dtype, m: int, rows: int = SSM_TIER_ROWS,
                     path: str = "ssm_tier") -> tuple[dict, dict]:
    """The gated RMSNorm split over a model tier of m, on one rank's
    columns: forward (the rows' partial sums of squares, then the finish)
    and backward (the partial row dot products, then the finish). The
    tier's sums are emulated by running the first launch on every rank's
    columns of the same rows and summing. Held against the unsplit plain
    forward and backward on the whole rows (this rank's columns: out, dy,
    dz, dscale), and each launch against its own plain version; the
    finishes two calls bitwise equal; one launch each. Timed on one rank:
    the forward's two launches and the backward's two (the tier's sum
    between them is the host's), beside their plain versions and
    ``F.rms_norm``'s forward and autograd backward on the gated product
    alone (a partial yardstick: no PyTorch call computes the function, so
    the library time is null); the bound is the bytes of one rank's
    function, each input read once and each output written once."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as R
    D, d = SSM_D_INNER, SSM_D_INNER // m
    width = 2 * d + SSM_GN + SSM_HEADS // m
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    ys = [rn(rows, d) * 2 for _ in range(m)]
    zs = [(rn(rows, width) * 2).to(dtype)[:, :d] for _ in range(m)]
    scs = [(rn(d) * 0.2).to(dtype) for _ in range(m)]
    douts = [rn(rows, d).to(dtype) for _ in range(m)]
    full = [torch.cat(t, -1).contiguous() for t in (ys, zs, scs, douts)]
    y, z, sc, dout = ys[0], zs[0], scs[0], douts[0]
    what = f"rmsnorm gated over a tier of {m} {dtype} ({rows},{d})"
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    n_f = dict(R.FORM_LAUNCHES)
    n_b = dict(R.FORM_BWD_LAUNCHES)
    ss_parts = [R.rmsnorm_gated_rowsq(a, b) for a, b in zip(ys, zs)]
    check(R.FORM_LAUNCHES["gated_rowsq"] - n_f["gated_rowsq"] == m,
          f"{what}: not one launch a partial sum")
    ss = torch.stack(ss_parts).sum(0)
    err_ss = close(ss_parts[0], R.rmsnorm_gated_rowsq_ref(y, z), 1e-5,
                   f"{what} rows' sums of squares", rtol=1e-5)
    fin = lambda: R.rmsnorm_gated_finish(y, z, sc, ss, d_norm=D)
    out, again = fin(), fin()
    check(R.FORM_LAUNCHES["gated_finish"] - n_f["gated_finish"] == 2,
          f"{what}: not one launch a finish")
    check(torch.equal(out, again), f"{what}: two finishes differ")
    close(out, R.rmsnorm_gated_finish_ref(y, z, sc, ss, d_norm=D), tol,
          f"{what} finish")
    err_f = close(out, R.rmsnorm_gated_ref(*full[:3])[:, :d], tol,
                  f"{what} vs the unsplit plain forward")
    dot_parts = [R.rmsnorm_gated_rowdot(*a) for a in zip(ys, zs, scs, douts)]
    check(R.FORM_BWD_LAUNCHES["gated_rowdot"] - n_b["gated_rowdot"] == m,
          f"{what}: not one launch a partial dot product")
    dot = torch.stack(dot_parts).sum(0)
    err_dot = close(dot_parts[0], R.rmsnorm_gated_rowdot_ref(y, z, sc, dout),
                    1e-4, f"{what} rows' dot products", rtol=1e-4)
    bwd = lambda: R.rmsnorm_gated_bwd(y, z, sc, dout, row_ss=ss,
                                      row_dot=dot, d_norm=D)
    got, again = bwd(), bwd()
    check(R.FORM_BWD_LAUNCHES["gated_finish"] - n_b["gated_finish"] == 2,
          f"{what}: not one launch a backward finish")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two backward finishes differ")
    want = R.rmsnorm_gated_bwd_ref(*full)
    errs_b = [close(got[0], want[0][:, :d], 1e-5, f"{what} dy"),
              close(got[1], want[1][:, :d], tol, f"{what} dz"),
              close(got[2], want[2][:d], 1e-4 if dtype == torch.float32
                    else tol, f"{what} dscale")]
    del again, want
    es = z.element_size()
    fwd_b = bound(rows * d * (4 + 2 * es) + d * es, 10 * rows * d, dtype)
    bwd_b = bound(rows * d * (4 + es + es + 4 + es) + 2 * d * es,
                  20 * rows * d, dtype)
    fwd = lambda: R.rmsnorm_gated_finish(y, z, sc, R.rmsnorm_gated_rowsq(
        y, z), d_norm=D)
    bwd2 = lambda: R.rmsnorm_gated_bwd(y, z, sc, dout, row_ss=ss,
                                       row_dot=R.rmsnorm_gated_rowdot(
                                           y, z, sc, dout), d_norm=D)
    plain_f = lambda: R.rmsnorm_gated_finish_ref(
        y, z, sc, R.rmsnorm_gated_rowsq_ref(y, z), d_norm=D)
    plain_b = lambda: R.rmsnorm_gated_bwd_ref(
        y, z, sc, dout, row_ss=ss,
        row_dot=R.rmsnorm_gated_rowdot_ref(y, z, sc, dout), d_norm=D)
    gp = (y.to(dtype) * F.silu(z)).requires_grad_(True)
    wl = (1.0 + sc).requires_grad_(True)
    yard_f = timer(lambda: F.rms_norm(gp, (d,), wl, 1e-5))
    o = F.rms_norm(gp, (d,), wl, 1e-5)
    yard_b = timer(lambda: torch.autograd.grad(o, (gp, wl), dout,
                                               retain_graph=True))
    del o, gp
    common = dict(shape=[rows, d], z_width=width, m=m, d_norm=D,
                  dtype=str(dtype), path=path, tolerance=tol,
                  library_ms=None,
                  partial_yardstick="F.rms_norm on the gated product alone "
                                    "(no gate, no tier)")
    fwd_row = dict(common, form="gated_tier", max_abs_err=err_f,
                   max_abs_err_rows_sumsq=err_ss, ms=timer(fwd),
                   host_ms=timer.host_ms(fwd), plain_ms=timer(plain_f),
                   partial_yardstick_ms=yard_f, bound_ms=fwd_b[0],
                   bound_by=fwd_b[1])
    bwd_row = dict(common, form="gated_tier", max_abs_err=max(errs_b),
                   max_abs_err_dy_dz_dscale=errs_b,
                   max_abs_err_rows_dot=err_dot, ms=timer(bwd2),
                   host_ms=timer.host_ms(bwd2), plain_ms=timer(plain_b),
                   partial_yardstick_ms=yard_b, bound_ms=bwd_b[0],
                   bound_by=bwd_b[1])
    return fwd_row, bwd_row


def backward_kernel_rows(bwd: dict) -> dict[str, list[dict]]:
    """Per kernel rows of phase 2c for the kernels' line: each kernel's own
    time and bound (the flash pair's two kernels apart; RMSNorm's backward
    is one kernel); the plain version's and the library's time are of the
    whole backward, as is ``pair_ms``."""
    out: dict[str, list[dict]] = {}
    parts = {"flash_attention_bwd": (("flash_attention_bwd_dq", "dq"),
                                     ("flash_attention_bwd_dkdv", "dkdv")),
             "rmsnorm_bwd": (("rmsnorm_bwd", None),),
             "ssd_bwd": (("ssd_bwd", None),),
             "rmsnorm_bwd_gated": (("rmsnorm_bwd_gated", None),),
             "rmsnorm_gated_tier": (("rmsnorm_gated_tier", None),),
             "rmsnorm_bwd_gated_tier": (("rmsnorm_bwd_gated_tier", None),)}
    for name, rows in bwd.items():
        for r in rows:
            for kernel, key in parts[name]:
                own = r[key] if key else r
                out.setdefault(kernel, []).append(dict(
                    shape=r["shape"], dtype=r["dtype"], path=r["path"],
                    mask_or_form=r.get("mask", r.get("form")),
                    instance=r.get("instance", "cuda"),
                    max_abs_err=r["max_abs_err"], ms=own["ms"],
                    bound_ms=own["bound_ms"], bound_by=own["bound_by"],
                    plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                    host_ms=r["host_ms"], pair_ms=r["ms"],
                    pair_bound_ms=r["bound_ms"],
                    sdpa_uncapped_yardstick_ms=r.get(
                        "sdpa_uncapped_yardstick_ms")))
    return out


def backward_cases(timer) -> dict[str, list[dict]]:
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {"flash_attention_bwd": [], "rmsnorm_bwd": []}
    for dtype in (torch.bfloat16, torch.float32):
        for mask in TRAIN_FLASH_MASKS:
            out["flash_attention_bwd"].append(flash_bwd_case(timer, g, dtype,
                                                             mask))
            gc.collect()
            torch.cuda.empty_cache()
        for residual in (False, True):
            out["rmsnorm_bwd"].append(rmsnorm_bwd_case(timer, g, dtype,
                                                       residual))
    # one rank of phase 8c, bf16, causal as llama3.2-3b trains
    out["flash_attention_bwd"].append(flash_bwd_case(
        timer, g, torch.bfloat16, dict(causal=True), FSDP_RANK_FLASH,
        "train_fsdp"))
    for residual in (False, True):
        out["rmsnorm_bwd"].append(rmsnorm_bwd_case(
            timer, g, torch.bfloat16, residual, FSDP_RANK_RMS, "train_fsdp"))
    # one rank of phase 8e, bf16
    out["flash_attention_bwd"].append(flash_bwd_case(
        timer, g, torch.bfloat16, dict(causal=True), TP_RANK_FLASH,
        "train_tp"))
    for shape in TP_RANK_RMS:
        out["rmsnorm_bwd"].append(rmsnorm_bwd_case(
            timer, g, torch.bfloat16, True, shape, "train_tp"))
    # one rank of phase 10b (qwen2-moe-a2.7b: 16 q and 16 KV heads), bf16
    out["flash_attention_bwd"].append(flash_bwd_case(
        timer, g, torch.bfloat16, dict(causal=True), MOE_RANK_FLASH,
        "train_moe"))
    for residual in (False, True):
        out["rmsnorm_bwd"].append(rmsnorm_bwd_case(
            timer, g, torch.bfloat16, residual, MOE_RANK_RMS, "train_moe"))
    # a model rank of phase 10c (qwen2-moe-a2.7b over m = 2: 8 q and 8 KV
    # heads), bf16; its norms are 10b's
    out["flash_attention_bwd"].append(flash_bwd_case(
        timer, g, torch.bfloat16, dict(causal=True), MOE_TIER_RANK_FLASH,
        "train_moe_tier"))
    # phase 8v's shapes (bf16): h2o-danube's and gemma2's training steps,
    # h2o-danube where its window bites, and the cap on the tensor cores
    for *shape, mask, full in VARIANT_FLASH_BWD:
        out["flash_attention_bwd"].append(flash_bwd_case(
            timer, g, torch.bfloat16, mask, tuple(shape), "train_variants",
            full=full))
        gc.collect()
        torch.cuda.empty_cache()
    out["flash_attention_bwd"].append(flash_bwd_case(
        timer, g, torch.float32, dict(causal=True, window=512, cap=50.0),
        (1, 1024, 32, 8, 120), "train_variants", full=False))
    # a model rank of phase 8ev (bf16), the forward with lse and the pair
    for *shape, mask in TIER_VARIANT_FLASH_BWD:
        out["flash_attention_bwd"].append(flash_bwd_case(
            timer, g, torch.bfloat16, mask, tuple(shape),
            "train_tier_variants"))
    # the tensor-core pair at its tile edges (no path of its own)
    for *shape, mask in FLASH_BWD_EDGES:
        out["flash_attention_bwd"].append(flash_bwd_case(
            timer, g, torch.bfloat16, mask, tuple(shape), "edges",
            full=False))
    # mamba2-780m's backward kernels (8d's shapes first: the kernels' line
    # reports the first row)
    out["ssd_bwd"] = [ssd_bwd_case(timer, TRAIN_SSD, dtype)
                      for dtype in (torch.bfloat16, torch.float32)]
    out["ssd_bwd"] += [ssd_bwd_case(timer, shape, torch.bfloat16, "edges")
                       for shape in SSD_BWD_EXTRA]
    # one model rank's heads of a group (8f: 24 of 48 over m = 2, 12 over 4)
    out["ssd_bwd"] += [ssd_bwd_case(timer, shape, torch.bfloat16, "ssm_tier")
                       for shape in SSM_TIER_SSD]
    from repro_torch.kernels.ssd.checks import BWD_CASES
    checked = [ssd_bwd_case(timer, shape, dtype, timed=False)
               for shape in BWD_CASES
               for dtype in (torch.bfloat16, torch.float32)]
    print(json.dumps({"kernel": "ssd_bwd", "checked_cases": checked}))
    gc.collect()
    torch.cuda.empty_cache()
    out["rmsnorm_bwd_gated"] = [gated_bwd_case(timer, g, dtype)
                                for dtype in (torch.bfloat16, torch.float32)]
    # the gated norm split over the tier (8f's rank first: the kernels'
    # line reports the first row)
    out["rmsnorm_gated_tier"], out["rmsnorm_bwd_gated_tier"] = [], []
    for m, dtype in ((2, torch.bfloat16), (2, torch.float32),
                     (4, torch.bfloat16)):
        f, b = tier_gated_cases(timer, g, dtype, m)
        out["rmsnorm_gated_tier"].append(f)
        out["rmsnorm_bwd_gated_tier"].append(b)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: FSDP training
# ---------------------------------------------------------------------------
# 8a: llama3.2-3b at full width and depth on one rank, 3 steps of 4 x 1,024
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 4, 1024
# the kernels the training paths run, by their names in launch_counts
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_wgmma", "ssd", "ssd_bwd")
# the kernels whose device time 8a's profiled step sums, by name
TRAIN_PROFILE_SUMS = {"flash_bwd": "flash_bwd", "flash_fwd": "flash_wgmma",
                      "rmsnorm_bwd": "rmsnorm_bwd"}
# 8d's: the SSD forward, its backward's four kernels, the gated backward
TRAIN_PROFILE_SUMS_SSM = {"ssd_fwd": "ssd_fwd", "ssd_bwd": "ssd_bwd",
                          "rmsnorm_gated_bwd": "rmsnorm_gated_bwd",
                          "rmsnorm_bwd": "rmsnorm_bwd"}
# 8b: the reduced fp32 model (the smoke config at 2 layers), 2 steps of
# 12 x 64 tokens, on one rank (CPU and card) and on 2 x 2 and 3 x 2 ranks
PARITY_STEPS, PARITY_BATCH, PARITY_SEQ, PARITY_LAYERS = 2, 12, 64, 2
PARITY_GRIDS = ((2, 2), (3, 2))
# losses and grad norms within PARITY_REL relative (tests/test_torch_train.py's
# limit); every parameter within PARITY_PARAM_ATOL, all but PARITY_FAR_SHARE
# of them within PARITY_PARAM_CLOSE. The card's own limit: on an H100 the
# card read 3.1e-5 against the CPU, and the ranks 3.3e-5 against one rank,
# where the CPU test, against JAX, holds 3e-5; so a third of one AdamW
# update (lr 3e-4). The elements beyond PARITY_PARAM_CLOSE are printed
# with the size of their gradient (``_beyond``).
PARITY_REL, PARITY_PARAM_ATOL = 1e-5, 1e-4
PARITY_PARAM_CLOSE, PARITY_FAR_SHARE = 1e-5, 1e-4
# 8v's exactness check adds a noise band: an element whose gradient is
# below NOISE_BAND (ten times AdamW's eps) in either run at some step takes
# an update g / (|g| + eps) that the gradient's rounding sets, up to a sign
# (on an H100 the reduced h2o-danube's embed[468, 92], whose token first
# comes in step 2, read +1.49e-8 on the CPU and -9.28e-9 on the card:
# 2.0e-4 apart after the step, 0.67 of lr 3e-4); such elements are held to
# NOISE_BAND_ATOL, the most two AdamW steps of either run can move them
# apart (2 steps x 2 runs x lr), and listed; every other element at the
# PARITY_* limits
NOISE_BAND, NOISE_BAND_ATOL = 1e-7, 4 * 3e-4
# 8b's reduced mamba2-780m (the smoke config at 2 layers, fp32) on the same
# batches: the card's one rank against the CPU's, and 2 x 2 ranks (locality
# + FSDP, eager and prefetch 1) against the card's one rank, at the PARITY_*
# limits. The card's SSD forward takes its products from split-bf16
# operands (within ~2^-16 of each |a||b| sum) where the CPU's are fp32: on
# an H100 that gave losses and grad norms 7.7e-8 and 9.1e-8 relative and
# parameters 2.0e-5 apart (one element, whose first gradient, 1e-9, is
# below Adam's eps), inside the llama limits, which it keeps.
SSM_PARITY_GRID = (2, 2)
SSM_VARIANTS = (("locality", dict(fsdp=True)),
                ("locality_prefetch", dict(fsdp=True, prefetch_depth=1)))
# 8c: llama3.2-3b at full width on 2 x 2 ranks, depth cut to 1 layer (4
# until the run neared its time limit, 2 until phase 9v needed its time),
# one 1,024-token sequence a rank, 2 steps a variant; 8e runs the same depth
FSDP_GRID, FSDP_LAYERS, FSDP_STEPS = (2, 2), 1, 2
# 8v: (arch, phase, depth: None for the config's) trained as 8a
VARIANT_TRAIN_RUNS = (("h2o-danube-3-4b", "train_variant_h2o", None),
                      ("gemma2-9b", "train_variant_gemma2", 8))
# 8v's exactness check: (arch, layers, head dim) reduced in fp32, window 64,
# 2 steps of 4 x 128 tokens, the card against the CPU at 8b's limits
VARIANT_EXACT_TRAIN = (("gemma2-9b", 3, 256), ("h2o-danube-3-4b", 2, 120))
VARIANT_EXACT_STEPS, VARIANT_EXACT_BATCH, VARIANT_EXACT_SEQ = 2, 4, 128
TRAIN_VARIANTS = (("locality", dict(fsdp=True)),
                  ("locality_prefetch", dict(fsdp=True, prefetch_depth=1)),
                  ("xla", dict(fsdp=True, grad_sync="xla")))


def train_launches_implied(n_layers: int, steps: int,
                           family: str = "dense", m: int = 1, cfg=None
                           ) -> dict[str, int]:
    """What a training step launches, per kernel and RMSNorm form: with
    remat every block's forward runs twice (the forward and its recompute),
    the final norm once; the backward once per norm (one kernel) and per
    mixer. A dense layer: ln1 (plain) and ln2 (residual), attention (its
    backward two kernels, of the tensor-core instance for bf16 at every
    head dim, at D = 256 its two-warpgroup form, else of the CUDA-core one;
    head dim 120 counted apart too); with
    ``cfg``'s sandwich norms two more plain norms a layer. A Mamba2 layer:
    ln (plain), the SSD scan and the gated norm (the SSD backward
    ``BWD_KERNELS`` kernels a call); on a model tier of m > 1 the gated
    norm split over it, two launches forward and two backward."""
    from repro_torch.kernels.flash_attention.ops import bwd_on_tensor_cores
    from repro_torch.kernels.ssd.ops import BWD_KERNELS
    L = n_layers
    D = cfg.head_dim_ if cfg is not None else 128
    post = 2 if cfg is not None and cfg.sandwich_norm else 0
    want = {k: 0 for k in ("decode_scores", "decode_stats", "dma_allgather",
                           "ssd", "ssd_bwd", "rmsnorm.gated",
                           "rmsnorm.residual", "rmsnorm_bwd.gated",
                           "rmsnorm_bwd.residual", "flash_attention",
                           "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkdv",
                           "flash_attention_bwd_wgmma",
                           "rmsnorm.gated_rowsq", "rmsnorm.gated_finish",
                           "rmsnorm_bwd.gated_rowdot",
                           "rmsnorm_bwd.gated_finish", "flash_attention_d120",
                           "flash_attention_bwd_d120")}
    want.update({"rmsnorm": 4 * L + 1, "rmsnorm.plain": 2 * L + 1,
                 "rmsnorm_bwd": 2 * L + 1, "rmsnorm_bwd.plain": L + 1})
    if family == "ssm" and m > 1:
        want.update({"rmsnorm": 6 * L + 1, "rmsnorm.gated_rowsq": 2 * L,
                     "rmsnorm.gated_finish": 2 * L, "rmsnorm_bwd": 3 * L + 1,
                     "rmsnorm_bwd.gated_rowdot": L,
                     "rmsnorm_bwd.gated_finish": L,
                     "ssd": 2 * L, "ssd_bwd": BWD_KERNELS * L})
    elif family == "ssm":
        want.update({"rmsnorm.gated": 2 * L, "rmsnorm_bwd.gated": L,
                     "ssd": 2 * L, "ssd_bwd": BWD_KERNELS * L})
    else:
        want.update({"rmsnorm": (4 + 2 * post) * L + 1,
                     "rmsnorm.plain": (2 + 2 * post) * L + 1,
                     "rmsnorm_bwd": (2 + post) * L + 1,
                     "rmsnorm_bwd.plain": (1 + post) * L + 1,
                     "rmsnorm.residual": 2 * L, "rmsnorm_bwd.residual": L,
                     "flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkdv": L,
                     "flash_attention_bwd_wgmma":
                         2 * L * bwd_on_tensor_cores(torch.bfloat16, D),
                     "flash_attention_d120": 2 * L * (D == 120),
                     "flash_attention_bwd_d120": 2 * L * (D == 120)})
    return {k: n * steps for k, n in want.items()}


def path_launches(counts: dict[str, int]) -> dict[str, int]:
    """A training path's launches by the kernels' line's names: the
    ``TRAIN_KERNELS`` counters, the gated RMSNorm backward's form and the
    gated form split over a model tier (forward and backward, two launches
    each)."""
    return {**{k: counts[k] for k in TRAIN_KERNELS},
            "rmsnorm_bwd_gated": counts["rmsnorm_bwd.gated"],
            **tier_form_launches(counts)}


def tier_form_launches(counts: dict[str, int]) -> dict[str, int]:
    """The launches of the gated RMSNorm split over a model tier, by the
    kernels' line's names."""
    return {"rmsnorm_gated_tier": counts["rmsnorm.gated_rowsq"]
            + counts["rmsnorm.gated_finish"],
            "rmsnorm_bwd_gated_tier": counts["rmsnorm_bwd.gated_rowdot"]
            + counts["rmsnorm_bwd.gated_finish"]}


def _zero_counts() -> None:
    from repro_torch import kernels
    kernels.add_launch_counts(kernels.launch_counts(), -1)


def train_one_rank(smi: str, arch: str = "llama3.2-3b",
                   phase: str = "train_one_rank", layers: int | None = None
                   ) -> dict[str, int]:
    """Phase 8a (llama3.2-3b), 8d (mamba2-780m) or 8v (the dense variants):
    the model at full width and depth (``layers``: cut to that many)
    through ``Trainer`` on one rank; returns the path's launches per
    kernel."""
    from repro_torch import configs, kernels
    from repro_torch.train import Trainer, TrainerConfig
    cfg = configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, None, TrainerConfig(
        steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        lr=3e-4, seed=0), device="cuda", log=lambda _: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _zero_counts()
    tr.run()
    counts = kernels.launch_counts()
    want = train_launches_implied(cfg.n_layers, TRAIN_STEPS, cfg.family,
                                  cfg=cfg)
    got = {k: counts[k] for k in want}
    check(got == want, f"{phase}: launches {got}, the path implies {want}")
    hist = tr.metrics_history
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), f"{phase}: non-finite metrics {hist}")
    peak = torch.cuda.max_memory_allocated()
    dts = [h["dt"] for h in hist]
    steady = float(np.mean(dts[1:]))
    batch = tr.data.batch(TRAIN_STEPS)
    profile_window("profile_train_step", phase,
                   lambda: tr.artifacts.step_fn(tr.state, batch), 1,
                   sums=(TRAIN_PROFILE_SUMS_SSM if cfg.family == "ssm"
                         else TRAIN_PROFILE_SUMS),
                   tokens=TRAIN_BATCH * TRAIN_SEQ)
    n_params = sum(t.numel() for t in _leaves(tr.state.params))
    print(json.dumps({
        "phase": phase, "model": cfg.name, "params": n_params,
        "layers": cfg.n_layers,
        "reduced": (f"depth {configs.get(arch).n_layers} -> {cfg.n_layers} "
                    "layers (card memory)" if layers else None),
        "dtype": "bfloat16 compute, fp32 master",
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": TRAIN_STEPS,
        "losses": [h["loss"] for h in hist],
        "grad_norms": [h["grad_norm"] for h in hist],
        "step_ms": [t * 1e3 for t in dts], "step_ms_steady": steady * 1e3,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
        "setup_s": setup_s, "max_memory_allocated": peak,
        "launches": got, "card": smi}))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return path_launches(counts)


def _variant_exact_cfg(arch: str, layers: int, head_dim: int):
    """One of ``VARIANT_EXACT_TRAIN``'s reduced fp32 configs."""
    from repro_torch import configs
    from repro_torch.configs import reduced
    return dataclasses.replace(reduced(configs.get(arch), head_dim=head_dim),
                               n_layers=layers, dtype=torch.float32)


def variant_train_exact(smi: str) -> dict[str, tuple[dict, dict]]:
    """Phase 8v's exactness check: each of ``VARIANT_EXACT_TRAIN`` reduced
    in fp32 with its real head dim (gemma2: 256, its caps, slot0, slot1 and
    a ``rest`` layer; h2o-danube: 120), window 64, trains 2 steps of 4 x
    128 tokens on the CPU (the plain versions) and on the card (the
    kernels: the fp32 flash forward and backward on the CUDA cores) from
    the same parameters and batches; held at 8b's ``PARITY_*`` limits but
    for the elements in the gradient noise band (``NOISE_BAND``). Returns
    {arch: (the parameters as {path: array}, the card's run: metrics,
    params, grads)}, 8ev's one-rank references."""
    from repro_torch.models import transformer as T
    refs = {}
    for arch, layers, head_dim in VARIANT_EXACT_TRAIN:
        cfg = _variant_exact_cfg(arch, layers, head_dim)
        params = T.init_train_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        flat = dict(zip(["/".join(p) for p in _paths(params)],
                        (t.numpy() for t in _leaves(params))))
        runs = {device: train_run(cfg, None, _tree(flat), {},
                                  VARIANT_EXACT_BATCH, VARIANT_EXACT_SEQ,
                                  VARIANT_EXACT_STEPS, device, grads=True)
                for device in ("cpu", "cuda")}
        one = {d: dict(metrics=r["metrics"], params=r["shards"],
                       grads=r["grads"]) for d, r in runs.items()}
        report = _parity(one["cuda"], one["cpu"],
                         f"train_variant_exact {arch}: card vs CPU",
                         band_atol=NOISE_BAND_ATOL)
        print(json.dumps({
            "phase": "train_variant_exact", "model": cfg.name,
            "layers": layers, "head_dim": head_dim, "window": cfg.window,
            "caps": [cfg.attn_softcap, cfg.final_softcap],
            "tree": {"slots": sorted(params["blocks"]),
                     "rest": len(params["rest"])},
            "dtype": "float32",
            "batch": [VARIANT_EXACT_BATCH, VARIANT_EXACT_SEQ],
            "steps": VARIANT_EXACT_STEPS, "card_vs_cpu": report,
            "loss_rel_limit": PARITY_REL,
            "param_abs_limit": PARITY_PARAM_ATOL,
            "noise_band": NOISE_BAND, "noise_band_atol": NOISE_BAND_ATOL,
            "losses_card": [m["loss"] for m in one["cuda"]["metrics"]],
            "launches_card": {k: runs["cuda"]["launches"][k] for k in (
                "flash_attention", "flash_attention_bwd_dq",
                "flash_attention_bwd_d120", "flash_attention_bwd_wgmma",
                "rmsnorm", "rmsnorm_bwd")},
            "card": smi}))
        refs[arch] = (flat, one["cuda"])
    return refs


def train_variants(smi: str) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 8v: ``VARIANT_TRAIN_RUNS`` through ``train_one_rank``, then
    the exactness check; returns each run's launches per kernel and the
    check's card references (:func:`variant_train_exact`)."""
    out = {}
    for arch, phase, layers in VARIANT_TRAIN_RUNS:
        out[phase] = train_one_rank(smi, arch, phase, layers)
    refs = variant_train_exact(smi)
    gc.collect()
    torch.cuda.empty_cache()
    return out, refs


def _leaves(tree):
    from repro_torch.optim.adamw import leaves
    return leaves(tree)


def train_run(cfg, grid, params, kw: dict, batch: int, seq: int, steps: int,
              device, grads: bool = False) -> dict:
    """``make_train_step(**kw)`` for ``steps`` steps of ``SyntheticLM``
    (this rank's rows) from ``params`` (None: drawn from seed 0 on the
    device): per-step metrics, host ms and meter records; this rank's
    shards with their FSDP dims and axes; launches and peak memory; with
    ``grads``, the (clipped) gradient AdamW took at each step, read back
    from its first moment: g_t = (mu_t - b1 mu_(t-1)) / (1 - b1)."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM, host_shard
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.sharding import (fsdp_param_axes, fsdp_param_dims,
                                            model_param_dims)
    art = make_train_step(cfg, grid, device=device, **kw)
    state = init_state(cfg, art, params=params, seed=0)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=0)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    art.meter.take()
    out = {"metrics": [], "step_ms": [], "meter": []}
    mus = [[torch.zeros_like(t) for t in _leaves(state.mu)]] if grads else []
    for step in range(steps):
        b = data.batch(step)
        if grid is not None:
            b = host_shard(b, grid.rank, grid.p)
        t0 = time.perf_counter()
        state, m = art.step_fn(state, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if device == "cuda":
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        mt = art.meter.take()
        out["meter"].append(dict(
            gathers=mt.gathers, reduce_scatters=mt.reduce_scatters,
            gather_ms=mt.gather_s * 1e3,
            reduce_scatter_ms=mt.reduce_scatter_s * 1e3,
            sync_ms=mt.sync_s * 1e3, staged_bytes=mt.staged_bytes,
            model_calls=mt.model_calls, model_ms=mt.model_s * 1e3,
            model_staged_bytes=mt.model_staged_bytes,
            gather=mt.gather_stats.edge_counts(),
            reduce_scatter=mt.reduce_scatter_stats.edge_counts(),
            model=mt.model_stats.edge_counts(),
            a2a_calls=mt.a2a_calls, a2a_bytes=mt.a2a_bytes,
            a2a_ms=mt.a2a_s * 1e3, a2a=mt.a2a_stats.edge_counts(),
            moe_gathers=mt.moe_gathers, moe_gather_ms=mt.moe_gather_s * 1e3,
            moe_gather=mt.moe_gather_stats.edge_counts()))
        if grads:
            mus.append([t.clone() for t in _leaves(state.mu)])
    out["launches"] = dict(kernels.launch_counts())
    out["moe"] = (art.moe_dispatch, art.moe_transport)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if device == "cuda" else 0)
    paths = ["/".join(p) for p in _paths(art.pspecs)]
    out["shards"] = dict(zip(paths, (t.cpu().numpy().copy()
                                     for t in _leaves(state.params))))
    if grads:
        from repro_torch.optim.adamw import AdamW
        b1 = AdamW().b1
        out["grads"] = {path: np.stack([
            ((mus[t + 1][j] - b1 * mus[t][j]) / (1 - b1)).cpu().numpy()
            for t in range(steps)]) for j, path in enumerate(paths)}
    out["dims"] = dict(zip(paths, _leaves(fsdp_param_dims(art.pspecs))))
    out["axes"] = dict(zip(paths, _leaves(fsdp_param_axes(art.pspecs))))
    out["mdims"] = dict(zip(paths, _leaves(model_param_dims(art.pspecs))))
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [p for i, x in enumerate(tree)
                for p in _paths(x, path + (str(i),))]
    return [path]


def _tree(flat: dict):
    """A parameter tree from {"a/b": array} (``rest/<r>/...``: the list of
    the remainder's layers)."""
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(a, dtype=np.float32))
    rest = tree.get("rest", {})
    tree["rest"] = [rest[str(r)] for r in range(len(rest))]
    return tree


def _assemble(results: list, pl: int) -> dict:
    """Whole leaves from the ranks' shards (grid order for ("pod","data"),
    pod 0's for "data", rank 0's for replicated)."""
    first = results[0]
    out = {}
    for path, k in first["dims"].items():
        if k < 0:
            out[path] = first["shards"][path]
            continue
        ranks = results if "pod" in first["axes"][path] else results[:pl]
        out[path] = np.concatenate([r["shards"][path] for r in ranks], k)
    return out


def _assemble_tp(results: list, pl: int, m: int) -> dict:
    """Whole leaves from the shards of a grid with a model tier (results in
    grid-rank order): each model lane's assembled over FSDP, then the lanes'
    concatenated along the leaf's model dim (lane 0's where it has none)."""
    lanes = [_assemble(results[t::m], pl) for t in range(m)]
    mdims = results[0]["mdims"]
    return {path: (lanes[0][path] if mdims[path] < 0 else np.concatenate(
        [lane[path] for lane in lanes], mdims[path])) for path in lanes[0]}


def _beyond(got: dict, want: dict, worst: int = 8) -> dict:
    """The parameters of ``got`` beyond PARITY_PARAM_CLOSE of ``want``'s,
    with the gradient AdamW took there at each step in each run that kept
    them (``train_run(grads=True)``), and the share of all elements whose
    first-step |gradient| in ``want``'s run is below 1e-7, ten times
    Adam's eps: there the first update g / (|g| + eps) is no longer +-1,
    and the gradient's last bits move it by a share of lr."""
    paths = list(want["params"])
    diff = np.concatenate([np.abs(got["params"][p] - want["params"][p])
                           .ravel() for p in paths])
    offs = np.cumsum([0] + [want["params"][p].size for p in paths])
    idx = np.flatnonzero(diff > PARITY_PARAM_CLOSE)
    listed = []
    for i in idx[np.argsort(-diff[idx])][:worst]:
        j = int(np.searchsorted(offs, i, side="right") - 1)
        row = dict(leaf=paths[j], index=int(i - offs[j]), diff=float(diff[i]))
        for side, run in (("want", want), ("got", got)):
            if "grads" in run:
                g = run["grads"][paths[j]]
                row[f"grads_{side}"] = [float(x) for x in
                                        g.reshape(len(g), -1)[:, i - offs[j]]]
        listed.append(row)
    g1 = np.concatenate([np.abs(want["grads"][p][0]).ravel() for p in paths])
    return dict(count=int(idx.size),
                share_all_first_grad_below_1e7=float(np.mean(g1 < 1e-7)),
                first_grad_median_all=float(np.median(g1)), worst=listed)


def _parity(got: dict, want: dict, what: str,
            band_atol: float | None = None) -> dict:
    """Losses, grad norms and MoE aux losses within PARITY_REL, parameters
    within
    PARITY_PARAM_ATOL; returns the largest differences and, where ``want``
    holds its gradients, the elements beyond PARITY_PARAM_CLOSE
    (``_beyond``). With ``band_atol`` (both runs' gradients given), an
    element whose gradient is below ``NOISE_BAND`` in either run at some
    step (and not 0 in both) is held to ``band_atol`` instead: there
    AdamW's update
    g / (|g| + eps) is set by the gradient's last bits, not by the
    function (phase 8v's and 8ev's checks; 8b keeps every element at the
    limit)."""
    d_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(got["metrics"], want["metrics"]))
    d_norm = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                 for a, b in zip(got["metrics"], want["metrics"]))
    # a MoE model's aux loss, where both report it
    d_aux = max((abs(a["moe_aux"] - b["moe_aux"]) / abs(b["moe_aux"])
                 for a, b in zip(got["metrics"], want["metrics"])
                 if "moe_aux" in a and "moe_aux" in b), default=0.0)
    paths = list(want["params"])
    diff = np.concatenate([np.abs(got["params"][p] - want["params"][p])
                           .ravel() for p in paths])
    far = float(np.mean(diff > PARITY_PARAM_CLOSE))
    noisy = np.zeros_like(diff, dtype=bool)
    if band_atol is not None:   # a gradient exactly 0 in both moves nothing
        band = lambda a, b: ((np.minimum(a, b) < NOISE_BAND)
                             & (np.maximum(a, b) > 0))
        noisy = np.concatenate([
            band(np.abs(got["grads"][p]), np.abs(want["grads"][p]))
            .reshape(len(want["grads"][p]), -1).any(0) for p in paths])
    d_par = float(diff[~noisy].max())
    d_noisy = float(diff[noisy].max()) if noisy.any() else 0.0
    out = dict(loss_rel=d_loss, grad_norm_rel=d_norm, param_abs=d_par,
               param_share_beyond_1e5=far, moe_aux_rel=d_aux)
    if band_atol is not None:
        out.update(noise_band_elements=int(noisy.sum()),
                   noise_band_param_abs=d_noisy)
    if "grads" in want:
        out["beyond_1e5"] = _beyond(got, want)
    check(d_loss <= PARITY_REL and d_norm <= PARITY_REL
          and d_aux <= PARITY_REL
          and d_par <= PARITY_PARAM_ATOL and far <= PARITY_FAR_SHARE
          and d_noisy <= (band_atol or 0.0),
          f"{what}: losses {d_loss}, grad norms {d_norm}, aux losses "
          f"{d_aux} (relative, limit "
          f"{PARITY_REL}), parameters {d_par} (limit {PARITY_PARAM_ATOL}; "
          f"{d_noisy} in the gradient noise band, limit {band_atol}), "
          f"share beyond {PARITY_PARAM_CLOSE} {far} (limit "
          f"{PARITY_FAR_SHARE}); beyond {PARITY_PARAM_CLOSE}: "
          f"{json.dumps(out.get('beyond_1e5'))}")
    return out


def _received(sched, region) -> dict[int, tuple[int, int]]:
    """Non-local (messages, blocks) each rank receives in a schedule: what
    it sends in the transpose, the reduce-scatter."""
    out = {r: [0, 0] for r in range(sched.p)}
    for rnd in sched.rounds:
        for s in rnd.sends:
            if not region.is_local(s.src, s.dst):
                out[s.dst][0] += 1
                out[s.dst][1] += len(s.blocks)
    return {r: tuple(v) for r, v in out.items()}


def fsdp_oracle(cfg, q: int, pl: int, alg: str, prefetch: bool, m: int = 1
                ) -> list[dict[str, float]]:
    """Per rank and step, the non-local messages and bytes the parameter
    gathers and the gradient reduce-scatters must send: the schedule
    oracle's (``schedules.locality_bruck``, and its transpose) times the
    gathers the path implies (each layer leaf twice with remat, once with
    the prefetch, the embedding and an untied head once; each
    reduce-scatter once; a slot's leaf once a rep, a ``rest`` layer's as it
    is), for shards of each leaf in ``cfg.dtype``: llama's seven leaves a
    layer, or
    Mamba2's two (in_proj, out_proj; the rest replicated). On a model tier
    of m the gathers run over each model lane (the q·pl ranks listed, by
    lane rank) on 1/m of each leaf the tier shards, the step's tree
    (``transformer.train_layout``: a Mamba2 layer adds ``in_proj_bc``,
    whole on the tier). For "xla" it
    is the recorder's own model of the
    library's all-gather and reduce-scatter, the calls the port makes (on
    the card this holds the number of calls; tests/test_torch_train.py
    holds the Bruck schedules against the JAX HLO)."""
    from repro_torch.core import schedules as TS
    from repro_torch.core.comm_record import CommRecorder
    from repro_torch.core.topology import RegionMap
    from repro_torch.models import transformer as T
    from repro_torch.train.sharding import (fsdp_param_axes,
                                            fsdp_param_dims,
                                            model_param_dims, param_specs)
    p = q * pl
    es = torch.empty((), dtype=cfg.dtype).element_size()
    shapes = T.train_param_shapes(cfg, m)
    axes = {"pod": q, "data": pl} | ({"model": m} if m > 1 else {})
    specs = param_specs(shapes, axes, fsdp=True)
    units = []                              # (shard bytes, gathers, rs)
    for path, t, k, ax, mk in zip(_paths(shapes), _leaves(shapes),
                                  _leaves(fsdp_param_dims(specs)),
                                  _leaves(fsdp_param_axes(specs)),
                                  _leaves(model_param_dims(specs))):
        if k < 0:
            continue
        check(ax == "pod,data", f"{path}: sharded over {ax}")
        layer = path[0] in ("blocks", "rest")
        n = t.shape[0] if path[0] == "blocks" else 1     # a slot's reps
        tp = m if mk >= 0 else 1
        per = t.numel() // n // p // tp * es    # one layer's shard, cfg.dtype
        units.append((per, n * (1 if prefetch or not layer else 2), n))
    out = []
    for r in range(p):
        if alg == "xla":
            rec = CommRecorder(pl)
            for per, ng, nrs in units:
                for _ in range(ng):
                    rec.group("all-gather", tuple(range(p)), r, per * p)
                for _ in range(nrs):
                    rec.group("reduce-scatter", tuple(range(p)), r, per)
            st = rec.stats
            out.append(dict(msgs=st.group_msgs_nonlocal,
                            bytes=st.group_bytes_nonlocal))
            continue
        region = RegionMap(p, pl)
        sched = TS.locality_bruck(p, pl)
        send = sched.per_rank_stats(region)[r]
        recv = _received(sched, region)[r]
        out.append(dict(
            gather_msgs=sum(ng * send[2] for _, ng, _ in units),
            gather_bytes=sum(ng * send[3] * per for per, ng, _ in units),
            rs_msgs=sum(nrs * recv[0] for _, _, nrs in units),
            rs_bytes=sum(nrs * recv[1] * per for per, _, nrs in units)))
    return out


def train_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phases 8b and 8c (every rank shares the one card): the
    reduced fp32 llama on 2 x 2 (ranks 0-3) and 3 x 2 in each variant, the
    reduced fp32 mamba2 on 2 x 2 eager and with the prefetch, then
    llama3.2-3b at full width, ``FSDP_LAYERS`` layers, on 2 x 2 in each;
    ranks outside a grid wait at the barrier that follows each run."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grids = {shape: RankGrid.build(*shape) for shape in PARITY_GRIDS}
    out = {"rank": rank, "parity": {}, "full": {}, "ssm": {}}
    small = dataclasses.replace(configs.get_smoke("llama3.2-3b"),
                                n_layers=PARITY_LAYERS, dtype=torch.float32)
    for shape, grid in grids.items():
        for name, kw in TRAIN_VARIANTS:
            if grid is not None:
                res = train_run(small, grid, _tree(plan["params"]), kw,
                                PARITY_BATCH, PARITY_SEQ, PARITY_STEPS,
                                "cuda")
                out["parity"][f"{shape[0]}x{shape[1]}|{name}"] = {
                    k: res[k] for k in ("metrics", "shards", "dims", "axes")}
            dist.barrier()
    ssm = _ssm_small()
    grid = grids[SSM_PARITY_GRID]
    for name, kw in SSM_VARIANTS:
        if grid is not None:
            res = train_run(ssm, grid, _tree(plan["ssm_params"]), kw,
                            PARITY_BATCH, PARITY_SEQ, PARITY_STEPS, "cuda")
            out["ssm"][name] = {k: res[k] for k in (
                "metrics", "shards", "dims", "axes", "meter", "launches")}
        dist.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    full = dataclasses.replace(configs.get("llama3.2-3b"),
                               n_layers=FSDP_LAYERS)
    grid = grids[FSDP_GRID]
    for name, kw in TRAIN_VARIANTS:
        if grid is not None:
            res = train_run(full, grid, None, kw, FSDP_GRID[0] * FSDP_GRID[1],
                            TRAIN_SEQ, FSDP_STEPS, "cuda")
            res.pop("shards")
            out["full"][name] = res
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _one_rank_refs(cfg, kw: dict | None = None) -> tuple[dict, dict]:
    """8b's one-rank runs of ``cfg`` (``make_train_step(**kw)``) on the CPU
    and the card from the same parameters (``init_train_params``, seed 0)
    and batches: (the parameters as {path: array}, {device: metrics,
    params, grads})."""
    from repro_torch.models import transformer as T
    params = T.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = dict(zip(["/".join(p) for p in _paths(params)],
                    (t.numpy() for t in _leaves(params))))
    one = {}
    for device in ("cpu", "cuda"):
        res = train_run(cfg, None, _tree(flat), kw or {}, PARITY_BATCH,
                        PARITY_SEQ, PARITY_STEPS, device, grads=True)
        one[device] = dict(metrics=res["metrics"], params=res["shards"],
                           grads=res["grads"])
    return flat, one


def ssm_parity(smi: str, ranks: list, one: dict, d_card: dict
               ) -> dict[str, int]:
    """8b's mamba2 part: 2 x 2 ranks against the card's one rank, the
    prefetch bitwise the eager step, each rank's launches and its gathers'
    and reduce-scatters' non-local messages and bytes per step equal to the
    schedule oracle's for the Mamba2 leaves; prints the phase's line and
    returns the ranks' launches per kernel, summed."""
    small = _ssm_small()
    q, pl = SSM_PARITY_GRID
    want_launches = train_launches_implied(PARITY_LAYERS, PARITY_STEPS, "ssm")
    report, total = {}, {}
    for name, kw in SSM_VARIANTS:
        res = [ranks[r]["ssm"][name] for r in range(q * pl)]
        for r in range(1, q * pl):
            check(res[r]["metrics"] == res[0]["metrics"],
                  f"train_parity_ssm {name}: rank {r}'s metrics differ")
        got = dict(metrics=res[0]["metrics"], params=_assemble(res, pl))
        report[name] = _parity(got, one["cuda"], f"train_parity_ssm {name}")
        report[name]["axes"] = sorted(set(res[0]["axes"].values()))
        oracle = fsdp_oracle(small, q, pl, "locality",
                             bool(kw.get("prefetch_depth")))
        for r, x in enumerate(res):
            got_l = {k: x["launches"][k] for k in want_launches}
            check(got_l == want_launches, f"train_parity_ssm {name} rank "
                  f"{r}: launches {got_l}, the path implies {want_launches}")
            for k, n in path_launches(x["launches"]).items():
                total[k] = total.get(k, 0) + n
            for step, m in enumerate(x["meter"]):
                nonlocal_ = dict(
                    gather_msgs=m["gather"]["permute_edges_nonlocal"],
                    gather_bytes=m["gather"]["permute_bytes_nonlocal"],
                    rs_msgs=m["reduce_scatter"]["permute_edges_nonlocal"],
                    rs_bytes=m["reduce_scatter"]["permute_bytes_nonlocal"])
                check(nonlocal_ == oracle[r], f"train_parity_ssm {name} rank "
                      f"{r} step {step}: non-local {nonlocal_}, the oracle "
                      f"{oracle[r]}")
        report[name]["nonlocal_per_step_by_rank"] = oracle
    eager = [ranks[r]["ssm"]["locality"] for r in range(q * pl)]
    pf = [ranks[r]["ssm"]["locality_prefetch"] for r in range(q * pl)]
    check(all(a["metrics"] == b["metrics"] and all(
        np.array_equal(a["shards"][k], b["shards"][k]) for k in a["shards"])
        for a, b in zip(eager, pf)),
        "train_parity_ssm: the prefetch step is not bitwise the eager one")
    print(json.dumps({
        "phase": "train_parity_ssm", "model": small.name,
        "layers": PARITY_LAYERS, "dtype": "float32",
        "batch": [PARITY_BATCH, PARITY_SEQ], "steps": PARITY_STEPS,
        "card_vs_cpu": d_card, "ranks_vs_one_rank": report,
        "prefetch_bitwise_eager": True,
        "loss_rel_limit": PARITY_REL, "param_abs_limit": PARITY_PARAM_ATOL,
        "launches_per_rank": want_launches,
        "gathers_per_step": [x["meter"][0]["gathers"] for x in eager[:1]
                             + pf[:1]],
        "losses_one_rank": [m["loss"] for m in one["cuda"]["metrics"]],
        "losses_cpu": [m["loss"] for m in one["cpu"]["metrics"]],
        "card": smi}))
    return total


def _ssm_small():
    """8b's reduced mamba2-780m: the smoke config at 2 layers, fp32."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke("mamba2-780m"),
                               n_layers=PARITY_LAYERS, dtype=torch.float32)


def train_on_ranks(smi: str) -> tuple[dict[str, dict[str, int]], tuple]:
    """Phases 8b and 8c: the one-rank references here (CPU and card), then
    6 spawned ranks (``train_rank``); checks and prints each; returns the
    launches per kernel of 8c's runs and of 8b's mamba2 ranks, each summed
    over the ranks and variants, and the reduced llama's parameters and
    one-rank runs (``_one_rank_refs``) for :func:`train_tp_on_ranks`."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    small = dataclasses.replace(configs.get_smoke("llama3.2-3b"),
                                n_layers=PARITY_LAYERS, dtype=torch.float32)
    flat, one = _one_rank_refs(small)
    d_card = _parity(one["cuda"], one["cpu"], "train_parity: card vs CPU")
    ssm_flat, ssm_one = _one_rank_refs(_ssm_small())
    ssm_card = _parity(ssm_one["cuda"], ssm_one["cpu"],
                       "train_parity_ssm: card vs CPU")
    t0 = time.perf_counter()
    ranks = run_ranks(6, train_rank, {"params": flat,
                                      "ssm_params": ssm_flat}, timeout=900.0)
    ranks_s = time.perf_counter() - t0
    ssm_total = ssm_parity(smi, ranks, ssm_one, ssm_card)

    report = {}
    for q, pl in PARITY_GRIDS:
        for name, _ in TRAIN_VARIANTS:
            key = f"{q}x{pl}|{name}"
            res = [ranks[r]["parity"][key] for r in range(q * pl)]
            for r in range(1, q * pl):
                check(res[r]["metrics"] == res[0]["metrics"],
                      f"train_parity {key}: rank {r}'s metrics differ")
            got = dict(metrics=res[0]["metrics"],
                       params=_assemble(res, pl))
            report[key] = _parity(got, one["cuda"], f"train_parity {key}")
            report[key]["axes"] = sorted(set(res[0]["axes"].values()))
        eager = [ranks[r]["parity"][f"{q}x{pl}|locality"]
                 for r in range(q * pl)]
        pf = [ranks[r]["parity"][f"{q}x{pl}|locality_prefetch"]
              for r in range(q * pl)]
        check(all(a["metrics"] == b["metrics"] and all(
            np.array_equal(a["shards"][k], b["shards"][k])
            for k in a["shards"]) for a, b in zip(eager, pf)),
            f"train_parity {q}x{pl}: the prefetch step is not bitwise the "
            "eager one")
    print(json.dumps({
        "phase": "train_parity", "model": small.name,
        "layers": PARITY_LAYERS, "dtype": "float32",
        "batch": [PARITY_BATCH, PARITY_SEQ], "steps": PARITY_STEPS,
        "card_vs_cpu": d_card, "ranks_vs_one_rank": report,
        "prefetch_bitwise_eager": True, "loss_rel_limit": PARITY_REL,
        "param_abs_limit": PARITY_PARAM_ATOL,
        "param_share_beyond_1e5_limit": PARITY_FAR_SHARE,
        "losses_one_rank": [m["loss"] for m in one["cuda"]["metrics"]]}))

    full = dataclasses.replace(configs.get("llama3.2-3b"),
                               n_layers=FSDP_LAYERS)
    q, pl = FSDP_GRID
    total = {}
    losses = {}
    want_launches = train_launches_implied(FSDP_LAYERS, FSDP_STEPS)
    for name, kw in TRAIN_VARIANTS:
        res = [ranks[r]["full"][name] for r in range(q * pl)]
        for r in range(1, q * pl):
            check(res[r]["metrics"] == res[0]["metrics"],
                  f"train_fsdp {name}: rank {r}'s metrics differ")
        check(all(np.isfinite(m["loss"]) for m in res[0]["metrics"]),
              f"train_fsdp {name}: non-finite loss")
        losses[name] = [m["loss"] for m in res[0]["metrics"]]
        alg = kw.get("grad_sync", "locality")
        oracle = fsdp_oracle(full, q, pl, "xla" if alg == "xla" else alg,
                             bool(kw.get("prefetch_depth")))
        for r, x in enumerate(res):
            got_l = {k: x["launches"][k] for k in want_launches}
            check(got_l == want_launches, f"train_fsdp {name} rank {r}: "
                  f"launches {got_l}, the path implies {want_launches}")
            for k, n in path_launches(x["launches"]).items():
                total[k] = total.get(k, 0) + n
            for step, m in enumerate(x["meter"]):
                if alg == "xla":
                    got = dict(msgs=m["gather"]["group_msgs_nonlocal"]
                               + m["reduce_scatter"]["group_msgs_nonlocal"],
                               bytes=m["gather"]["group_bytes_nonlocal"]
                               + m["reduce_scatter"]["group_bytes_nonlocal"])
                else:
                    got = dict(
                        gather_msgs=m["gather"]["permute_edges_nonlocal"],
                        gather_bytes=m["gather"]["permute_bytes_nonlocal"],
                        rs_msgs=m["reduce_scatter"]["permute_edges_nonlocal"],
                        rs_bytes=m["reduce_scatter"]
                        ["permute_bytes_nonlocal"])
                check(got == oracle[r], f"train_fsdp {name} rank {r} step "
                      f"{step}: non-local {got}, the oracle {oracle[r]}")
        mean = lambda f: [float(np.mean([m[f] for m in x["meter"]]))
                          for x in res]
        print(json.dumps({
            "phase": "train_fsdp", "variant": name,
            "shared": "4 ranks sharing one H100 over gloo",
            "model": full.name, "layers": FSDP_LAYERS,
            "reduced": f"depth 28 -> {FSDP_LAYERS} layers (gloo host "
                       "transport)",
            "dtype": "bfloat16 compute, fp32 master",
            "batch": [q * pl, TRAIN_SEQ], "steps": FSDP_STEPS,
            "losses": losses[name],
            "grad_norms": [m["grad_norm"] for m in res[0]["metrics"]],
            "step_ms_by_rank": [x["step_ms"] for x in res],
            "gather_host_ms_per_step": mean("gather_ms"),
            "reduce_scatter_host_ms_per_step": mean("reduce_scatter_ms"),
            "sync_host_ms_per_step": mean("sync_ms"),
            "gathers_per_step": res[0]["meter"][0]["gathers"],
            "reduce_scatters_per_step": res[0]["meter"][0]["reduce_scatters"],
            "nonlocal_per_step_by_rank": oracle,
            "nonlocal_equal_to_oracle": True,
            "staged_bytes_per_step": mean("staged_bytes"),
            "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
            "launches_rank0": {k: res[0]["launches"][k]
                               for k in TRAIN_KERNELS},
            "ranks_wall_s": ranks_s, "card": smi}))
    check(losses["locality"] == losses["locality_prefetch"],
          f"train_fsdp: prefetch losses {losses['locality_prefetch']} differ "
          f"from eager {losses['locality']}")
    return {"train_fsdp": total, "train_parity_ssm": ssm_total}, (flat, one)


# 8b's tensor-parallel part: the reduced fp32 llama on 2 x 2 x 2 ranks
# ("pod", "data", "model"), against the card's one rank at the PARITY_*
# limits, in four variants
TP_GRID = (2, 2, 2)
TP_PARITY_VARIANTS = (("locality", dict(fsdp=True)),
                      ("locality_prefetch", dict(fsdp=True,
                                                 prefetch_depth=1)),
                      ("seq_shard", dict(fsdp=True, seq_shard=True)),
                      ("xla", dict(fsdp=True, grad_sync="xla")))
# 8e: llama3.2-3b at full width on 2 x 2 x 2 ranks, depth cut as 8c's,
# one 1,024-token sequence a DP rank, 2 steps a variant
TP_STEPS = 2
TP_VARIANTS = (("locality", dict(fsdp=True)),
               ("seq_shard", dict(fsdp=True, seq_shard=True)),
               ("xla", dict(fsdp=True, grad_sync="xla")))
# 8ev: the dense variants on the same ranks. (a) 8v's reduced fp32 models
# (``VARIANT_EXACT_TRAIN``: gemma2 at 3 layers, slot0, slot1 and a ``rest``
# layer, 4/2 heads of 256 and caps; h2o-danube at 2, heads of 120; window
# 64) on 8v's 4 x 128 tokens, 2 steps, in each of ``TP_PARITY_VARIANTS``,
# against 8v's one-rank run on the card at 8b's limits, 8v's noise band's
# elements held to TIER_NOISE_BAND_ATOL; (b) gemma2-9b at full width
# (d_model 3,584, 16/8 heads of 256, d_ff 14,336, vocab 256,000, window
# 4,096, caps 50/30), 8/4 heads a model rank, cut to one window / full pair
# of its 42 layers (the gloo host transport; 1.31 B parameters, ~2 GB of
# fp32 state and moments a rank), one 1,024-token sequence a DP rank, one
# step a mode (2 until the run's time needed it: the second step took
# 17.4-34.2 s over gloo on an H100, as long as the first)
TP_VARIANT_ARCH, TP_VARIANT_LAYERS = "gemma2-9b", 2
TP_VARIANT_MODES = (("locality", dict(fsdp=True)),)
TP_VARIANT_STEPS = 1
# 8ev-a's noise band against the card's one rank (both runs on the card):
# 2 x lr, what one AdamW step whose update flips its sign parts an element
# by, half what two such steps reach (NOISE_BAND_ATOL). On an H100 the
# band's elements read 1.4e-5 (gemma2, 2,145 of them) and 1.75e-4
# (h2o-danube, 347)
TIER_NOISE_BAND_ATOL = 2 * 3e-4
# 10c: the MoE family on the same ranks. (a) 10a's reduced fp32 qwen2-moe
# (2 layers, 8 experts at top-4, 2 shared: 4 experts and 32 shared columns
# a model rank) on 8b's batches, 2 steps, in each mode below, against the
# card's one rank at 8b's limits: the lane's 4 DP ranks' rows as 4
# microbatches (each DP rank's aux loss is its own rows'), or, for "xla",
# the whole batch as one (the JAX GSPMD step's aux loss is the global
# batch's); the aux loss within PARITY_REL too. (b) qwen2-moe-a2.7b at full
# width (32 of 64 experts, 8/8 heads of 128 and 2,816 shared columns a
# model rank), cut to 1 of its 24 layers (the gloo host transport), one
# 1,024-token sequence a DP rank, one step of locality + FSDP
MOE_TP_PARITY_VARIANTS = TP_PARITY_VARIANTS + (
    ("ep_locality", dict(fsdp=True, moe_dispatch="locality",
                         global_batch=PARITY_BATCH)),)
MOE_TP_LAYERS, MOE_TP_STEPS = 1, 1
MOE_TP_MODES = (("locality", dict(fsdp=True)),)


def train_tp_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of 8b's TP part, 8e, 8ev and 10c (all eight share the one
    card): the reduced fp32 llama in each of ``TP_PARITY_VARIANTS``, 8ev's
    reduced variants in each too, 10c's reduced qwen2-moe in each of
    ``MOE_TP_PARITY_VARIANTS``, then llama3.2-3b at full width,
    ``FSDP_LAYERS`` layers, in each of ``TP_VARIANTS``, gemma2-9b at full
    width, ``TP_VARIANT_LAYERS`` layers, in each of ``TP_VARIANT_MODES``,
    and qwen2-moe-a2.7b at full width, ``MOE_TP_LAYERS`` layer, in each of
    ``MOE_TP_MODES``."""
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = RankGrid.build(*TP_GRID)
    out = {"rank": rank, "parity": {}, "full": {}, "variants": {},
           "variant_full": {}, "moe": {}, "moe_full": {},
           "coords": dict(rank=grid.rank, t=grid.t,
                          grid_rank=grid.grid_rank)}
    small = dataclasses.replace(configs.get_smoke("llama3.2-3b"),
                                n_layers=PARITY_LAYERS, dtype=torch.float32)
    keep = ("metrics", "shards", "dims", "axes", "mdims", "meter",
            "launches")
    for name, kw in TP_PARITY_VARIANTS:
        res = train_run(small, grid, _tree(plan["params"]), kw,
                        PARITY_BATCH, PARITY_SEQ, PARITY_STEPS, "cuda")
        out["parity"][name] = {k: res[k] for k in keep}
    for arch, layers, head_dim in VARIANT_EXACT_TRAIN:
        cfg = _variant_exact_cfg(arch, layers, head_dim)
        out["variants"][arch] = {}
        for name, kw in TP_PARITY_VARIANTS:
            res = train_run(cfg, grid, _tree(plan["variants"][arch]), kw,
                            VARIANT_EXACT_BATCH, VARIANT_EXACT_SEQ,
                            VARIANT_EXACT_STEPS, "cuda", grads=True)
            out["variants"][arch][name] = {k: res[k]
                                           for k in keep + ("grads",)}
    for name, kw in MOE_TP_PARITY_VARIANTS:
        res = train_run(_moe_small(), grid, _tree(plan["moe"]), kw,
                        PARITY_BATCH, PARITY_SEQ, PARITY_STEPS, "cuda")
        out["moe"][name] = {k: res[k] for k in keep + ("moe",)}
    gc.collect()
    torch.cuda.empty_cache()
    for cfg, modes, key, steps in (
            (dataclasses.replace(configs.get("llama3.2-3b"),
                                 n_layers=FSDP_LAYERS), TP_VARIANTS, "full",
             TP_STEPS),
            (dataclasses.replace(configs.get(TP_VARIANT_ARCH),
                                 n_layers=TP_VARIANT_LAYERS),
             TP_VARIANT_MODES, "variant_full", TP_VARIANT_STEPS),
            (dataclasses.replace(configs.get(MOE_ARCH),
                                 n_layers=MOE_TP_LAYERS),
             MOE_TP_MODES, "moe_full", MOE_TP_STEPS)):
        for name, kw in modes:
            res = train_run(cfg, grid, None, kw, TP_GRID[0] * TP_GRID[1],
                            TRAIN_SEQ, steps, "cuda")
            res.pop("shards")
            out[key][name] = res
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _nonlocal(mt: dict, alg: str) -> dict:
    """A step's non-local messages and bytes of the parameter gathers and
    reduce-scatters from its meter record, as :func:`fsdp_oracle` gives
    them for ``alg``."""
    if alg == "xla":
        return dict(msgs=mt["gather"]["group_msgs_nonlocal"]
                    + mt["reduce_scatter"]["group_msgs_nonlocal"],
                    bytes=mt["gather"]["group_bytes_nonlocal"]
                    + mt["reduce_scatter"]["group_bytes_nonlocal"])
    return dict(gather_msgs=mt["gather"]["permute_edges_nonlocal"],
                gather_bytes=mt["gather"]["permute_bytes_nonlocal"],
                rs_msgs=mt["reduce_scatter"]["permute_edges_nonlocal"],
                rs_bytes=mt["reduce_scatter"]["permute_bytes_nonlocal"])


def _tier_local(name: str, rank: int, step: int, mt: dict) -> None:
    """The model tier's collectives ran, and none crossed a pod."""
    check(mt["model_calls"] > 0 and mt["model"]["group_msgs_local"] > 0
          and mt["model"]["group_msgs_nonlocal"] == 0
          and mt["model"]["permute_edges_nonlocal"] == 0,
          f"{name} rank {rank} step {step}: model tier {mt['model_calls']} "
          f"calls, messages {mt['model']}")


def train_tp_on_ranks(smi: str, flat: dict, one: dict, variant_refs: dict
                      ) -> dict[str, dict[str, int]]:
    """8b's TP part, phase 8e and phase 8ev: 8 spawned ranks
    (``train_tp_rank``) on 2 x 2 x 2; checks and prints each; returns 8e's
    and 8ev's full-width launches per kernel, each summed over the ranks
    and modes. ``flat`` and ``one`` are 8b's reduced llama parameters and
    one-rank runs, ``variant_refs`` 8v's reduced variants' parameters and
    card runs (:func:`variant_train_exact`)."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    q, pl, m = TP_GRID
    n = q * pl * m
    t0 = time.perf_counter()
    moe_flat, moe_accum = _moe_one_rank(q * pl)
    moe_whole = _moe_one_rank(1)[1]
    ranks = run_ranks(n, train_tp_rank, {
        "params": flat, "moe": moe_flat,
        "variants": {a: f for a, (f, _) in variant_refs.items()}},
        timeout=900.0)
    ranks_s = time.perf_counter() - t0
    lane_rank = [r["coords"]["rank"] for r in ranks]
    check([r["coords"]["grid_rank"] for r in ranks] == list(range(n)),
          "train_tp: grid ranks are not the spawned ranks' order")

    small = dataclasses.replace(configs.get_smoke("llama3.2-3b"),
                                n_layers=PARITY_LAYERS, dtype=torch.float32)
    # fp32: the flash backward runs the CUDA-core pair
    want_small = dict(train_launches_implied(PARITY_LAYERS, PARITY_STEPS),
                      flash_attention_bwd_wgmma=0)
    report = _tp_parity([r["parity"] for r in ranks], one["cuda"],
                        want_small, "train_parity_tp")
    print(json.dumps({
        "phase": "train_parity_tp", "model": small.name,
        "grid": "2 x 2 x 2 (pod, data, model)", "layers": PARITY_LAYERS,
        "dtype": "float32", "batch": [PARITY_BATCH, PARITY_SEQ],
        "steps": PARITY_STEPS, "ranks_vs_one_rank": report,
        "prefetch_bitwise_eager": True, "loss_rel_limit": PARITY_REL,
        "param_abs_limit": PARITY_PARAM_ATOL,
        "param_share_beyond_1e5_limit": PARITY_FAR_SHARE,
        "launches_per_rank": want_small,
        "losses_one_rank": [x["loss"] for x in one["cuda"]["metrics"]],
        "card": smi}))
    for arch, layers, head_dim in VARIANT_EXACT_TRAIN:
        cfg = _variant_exact_cfg(arch, layers, head_dim)
        ref = variant_refs[arch][1]
        want = dict(train_launches_implied(layers, VARIANT_EXACT_STEPS,
                                           cfg=cfg),
                    flash_attention_bwd_wgmma=0)
        report = _tp_parity([r["variants"][arch] for r in ranks], ref,
                            want, f"train_parity_tp_variant {arch}",
                            band_atol=TIER_NOISE_BAND_ATOL)
        print(json.dumps({
            "phase": "train_parity_tp_variant", "model": cfg.name,
            "grid": "2 x 2 x 2 (pod, data, model)", "layers": layers,
            "head_dim": head_dim, "window": cfg.window,
            "caps": [cfg.attn_softcap, cfg.final_softcap],
            "dtype": "float32",
            "batch": [VARIANT_EXACT_BATCH, VARIANT_EXACT_SEQ],
            "steps": VARIANT_EXACT_STEPS, "ranks_vs_one_rank": report,
            "prefetch_bitwise_eager": True, "loss_rel_limit": PARITY_REL,
            "param_abs_limit": PARITY_PARAM_ATOL,
            "param_share_beyond_1e5_limit": PARITY_FAR_SHARE,
            "noise_band": NOISE_BAND, "noise_band_atol": TIER_NOISE_BAND_ATOL,
            "launches_per_rank": want,
            "losses_one_rank": [x["loss"] for x in ref["metrics"]],
            "card": smi}))

    moe = _moe_small()
    res = [r["moe"]["ep_locality"] for r in ranks]
    check(all(x["moe"] == ("locality", "tokens") for x in res),
          f"train_parity_moe_tp: EP resolved {res[0]['moe']}")
    report = _tp_parity(
        [r["moe"] for r in ranks], None, want_small, "train_parity_moe_tp",
        modes=MOE_TP_PARITY_VARIANTS,
        ref_of=lambda name: (moe_whole if name == "xla" else moe_accum)[
            "cuda"])
    print(json.dumps({
        "phase": "train_parity_moe_tp", "model": moe.name,
        "grid": "2 x 2 x 2 (pod, data, model)", "layers": PARITY_LAYERS,
        "dtype": "float32", "experts_per_model_rank": moe.n_experts // m,
        "batch": [PARITY_BATCH, PARITY_SEQ], "steps": PARITY_STEPS,
        "ranks_vs_one_rank": report, "prefetch_bitwise_eager": True,
        "one_rank": f"{q * pl} microbatches; the whole batch for xla",
        "loss_rel_limit": PARITY_REL, "param_abs_limit": PARITY_PARAM_ATOL,
        "param_share_beyond_1e5_limit": PARITY_FAR_SHARE,
        "launches_per_rank": want_small,
        "losses_one_rank": [x["loss"] for x in moe_accum["cuda"]["metrics"]],
        "moe_aux_one_rank": {k: [x["moe_aux"] for x in v["cuda"]["metrics"]]
                             for k, v in (("microbatches", moe_accum),
                                          ("whole", moe_whole))},
        "card": smi}))

    out = {}
    for arch, layers, modes, steps, key, phase in (
            ("llama3.2-3b", FSDP_LAYERS, TP_VARIANTS, TP_STEPS, "full",
             "train_tp"),
            (TP_VARIANT_ARCH, TP_VARIANT_LAYERS, TP_VARIANT_MODES,
             TP_VARIANT_STEPS, "variant_full", "train_tp_variants"),
            (MOE_ARCH, MOE_TP_LAYERS, MOE_TP_MODES, MOE_TP_STEPS,
             "moe_full", "train_moe_tp")):
        out[phase] = _tp_full_width(smi, [r[key] for r in ranks], arch,
                                    layers, modes, steps, phase, lane_rank,
                                    ranks_s)
    return out


def _tp_parity(res_by_rank: list, ref: dict | None, want: dict, what: str,
               band_atol: float | None = None, modes=TP_PARITY_VARIANTS,
               ref_of=None) -> dict:
    """A reduced model's runs on 2 x 2 x 2 (``res_by_rank``: each rank's
    {mode: run}, the ``modes``) against one rank's (``ref``, or
    ``ref_of(mode)``: metrics, params, and grads with ``band_atol``) at
    8b's limits, the noise band's elements at ``band_atol`` where it is
    given; each rank's launches ``want``, the tier's collectives inside
    each pod, the prefetch bitwise the eager step. Returns the report by
    mode."""
    q, pl, m = TP_GRID
    report = {}
    for name, _ in modes:
        if ref_of is not None:
            ref = ref_of(name)
        res = [r[name] for r in res_by_rank]
        for r in range(1, len(res)):
            check(res[r]["metrics"] == res[0]["metrics"],
                  f"{what} {name}: rank {r}'s metrics differ")
        got = dict(metrics=res[0]["metrics"],
                   params=_assemble_tp(res, pl, m))
        if band_atol is not None:    # each step's gradient, assembled
            steps = len(res[0]["metrics"])
            per = [_assemble_tp([dict(x, shards={p: g[s] for p, g in
                                                 x["grads"].items()})
                                 for x in res], pl, m)
                   for s in range(steps)]
            got["grads"] = {p: np.stack([g[p] for g in per])
                            for p in per[0]}
        report[name] = _parity(got, ref, f"{what} {name}",
                               band_atol=band_atol)
        for r, x in enumerate(res):
            got_l = {k: x["launches"][k] for k in want}
            check(got_l == want, f"{what} {name} rank {r}: launches "
                  f"{got_l}, the path implies {want}")
            for step, mt in enumerate(x["meter"]):
                _tier_local(f"{what} {name}", r, step, mt)
    eager = [r["locality"] for r in res_by_rank]
    pf = [r["locality_prefetch"] for r in res_by_rank]
    check(all(a["metrics"] == b["metrics"] and all(
        np.array_equal(a["shards"][k], b["shards"][k]) for k in a["shards"])
        for a, b in zip(eager, pf)),
        f"{what}: the prefetch step is not bitwise the eager one")
    return report


def _tp_full_width(smi: str, res_by_rank: list, arch: str, layers: int,
                   modes, steps: int, phase: str, lane_rank: list,
                   ranks_s: float) -> dict[str, int]:
    """8e's or 8ev's runs of ``arch`` at full width, cut to ``layers``, of
    ``steps`` steps (``res_by_rank``: each rank's {mode: run}): metrics equal on every rank and finite, each rank's launches
    the path's, its gathers' and reduce-scatters' non-local messages and
    bytes a step :func:`fsdp_oracle`'s, the tier's collectives inside each
    pod; prints a line a mode and returns the launches per kernel, summed
    over the ranks and modes."""
    from repro_torch import configs
    q, pl, m = TP_GRID
    n = q * pl * m
    published = configs.get(arch)
    full = dataclasses.replace(published, n_layers=layers)
    want = train_launches_implied(layers, steps, cfg=full)
    total = {}
    for name, kw in modes:
        res = [r[name] for r in res_by_rank]
        for r in range(1, n):
            check(res[r]["metrics"] == res[0]["metrics"],
                  f"{phase} {name}: rank {r}'s metrics differ")
        check(all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                  for x in res[0]["metrics"]),
              f"{phase} {name}: non-finite metrics")
        alg = kw.get("grad_sync", "locality")
        oracle = fsdp_oracle(full, q, pl, alg, False, m)
        for r, x in enumerate(res):
            got_l = {k: x["launches"][k] for k in want}
            check(got_l == want, f"{phase} {name} rank {r}: launches "
                  f"{got_l}, the path implies {want}")
            for k, c in path_launches(x["launches"]).items():
                total[k] = total.get(k, 0) + c
            for step, mt in enumerate(x["meter"]):
                got = _nonlocal(mt, alg)
                check(got == oracle[lane_rank[r]],
                      f"{phase} {name} rank {r} step {step}: non-local "
                      f"{got}, the oracle {oracle[lane_rank[r]]}")
                _tier_local(f"{phase} {name}", r, step, mt)
        per_rank = lambda f: [[x_[f] for x_ in x["meter"]] for x in res]
        print(json.dumps({
            "phase": phase, "variant": name,
            "shared": "8 ranks sharing one H100 over gloo",
            "grid": "2 x 2 x 2 (pod, data, model)",
            "model": full.name, "layers": full.n_layers,
            "heads_per_model_rank": [full.n_heads // m,
                                     full.n_kv_heads // m],
            "reduced": f"depth {published.n_layers} -> {layers} layers "
                       "(gloo host transport)",
            "dtype": "bfloat16 compute, fp32 master",
            "batch": [q * pl, TRAIN_SEQ], "steps": steps,
            "losses": [x["loss"] for x in res[0]["metrics"]],
            "grad_norms": [x["grad_norm"] for x in res[0]["metrics"]],
            "step_ms_by_rank": [x["step_ms"] for x in res],
            "gather_host_ms_by_rank": per_rank("gather_ms"),
            "reduce_scatter_host_ms_by_rank": per_rank("reduce_scatter_ms"),
            "model_tier_host_ms_by_rank": per_rank("model_ms"),
            "sync_host_ms_by_rank": per_rank("sync_ms"),
            "staged_bytes_by_rank": per_rank("staged_bytes"),
            "model_tier_staged_bytes_by_rank": per_rank("model_staged_bytes"),
            "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
            "peak_gb_max": max(x["peak_bytes"] for x in res) / 1e9,
            "gathers_per_step": res[0]["meter"][0]["gathers"],
            "reduce_scatters_per_step": res[0]["meter"][0]["reduce_scatters"],
            "model_tier_calls_per_step": res[0]["meter"][0]["model_calls"],
            "model_tier_msgs_per_step_rank0": res[0]["meter"][0]["model"],
            "nonlocal_per_step_by_lane_rank": oracle,
            "nonlocal_equal_to_oracle": True,
            "model_tier_nonlocal": 0,
            "launches_rank0": {k: res[0]["launches"][k]
                               for k in TRAIN_KERNELS},
            "ranks_wall_s": ranks_s, "card": smi}))
    return total


# ---------------------------------------------------------------------------
# phase 8f: mamba2-780m split by SSD heads over the model tier
# ---------------------------------------------------------------------------
# mamba2-780m at full width (d_model 1,536, 48 SSD heads of 64, N = 128) on
# 2 x 2 x 2 ranks, depth cut to 2 layers (the gloo host transport; 8
# before phase 4v needed the run's time, 4 before phase 9v did), one
# 1,024-token sequence a DP rank (4 x 1,024 a step), 2 steps a variant; the
# first step's loss against the card's one rank at the same depth on the
# same 4 x 1,024 tokens, within SSM_TP_LOSS_REL: bf16 compute, and the tier
# sums out_proj's bf16 partial products and the gated norm's row
# statistics in another order than one rank's products (the bf16 loss
# limit phase 10b held its "none" dispatch to)
SSM_TP_LAYERS, SSM_TP_STEPS = 2, 2
SSM_TP_VARIANTS = TP_VARIANTS
SSM_TP_LOSS_REL = 1e-2


def train_ssm_tp_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of 8f (all eight share the one card): mamba2-780m at full
    width, ``SSM_TP_LAYERS`` layers, in each of ``SSM_TP_VARIANTS``."""
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = RankGrid.build(*TP_GRID)
    out = {"rank": rank, "full": {},
           "coords": dict(rank=grid.rank, t=grid.t,
                          grid_rank=grid.grid_rank)}
    full = dataclasses.replace(configs.get("mamba2-780m"),
                               n_layers=SSM_TP_LAYERS)
    for name, kw in SSM_TP_VARIANTS:
        res = train_run(full, grid, None, kw, TP_GRID[0] * TP_GRID[1],
                        TRAIN_SEQ, SSM_TP_STEPS, "cuda")
        res.pop("shards")
        out["full"][name] = res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_ssm_tp_on_ranks(smi: str) -> dict[str, dict[str, int]]:
    """Phase 8f: the one-rank reference here, then 8 spawned ranks
    (``train_ssm_tp_rank``) on 2 x 2 x 2; checks and prints each variant;
    returns the launches per kernel, summed over the ranks and variants."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    from repro_torch.models.ssm import ssm_dims
    q, pl, m = TP_GRID
    n = q * pl * m
    full = dataclasses.replace(configs.get("mamba2-780m"),
                               n_layers=SSM_TP_LAYERS)
    one = train_run(full, None, None, {}, q * pl, TRAIN_SEQ, 1, "cuda")
    one_loss = one["metrics"][0]["loss"]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(n, train_ssm_tp_rank, {}, timeout=900.0)
    ranks_s = time.perf_counter() - t0
    lane_rank = [r["coords"]["rank"] for r in ranks]
    check([r["coords"]["grid_rank"] for r in ranks] == list(range(n)),
          "train_ssm_tp: grid ranks are not the spawned ranks' order")
    want = train_launches_implied(SSM_TP_LAYERS, SSM_TP_STEPS, "ssm", m)
    total = {}
    for name, kw in SSM_TP_VARIANTS:
        res = [r["full"][name] for r in ranks]
        for r in range(1, n):
            check(res[r]["metrics"] == res[0]["metrics"],
                  f"train_ssm_tp {name}: rank {r}'s metrics differ")
        check(all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                  for x in res[0]["metrics"]),
              f"train_ssm_tp {name}: non-finite metrics")
        loss0 = res[0]["metrics"][0]["loss"]
        d_loss = abs(loss0 / one_loss - 1)
        check(d_loss <= SSM_TP_LOSS_REL, f"train_ssm_tp {name}: first loss "
              f"{loss0}, one rank's {one_loss} ({d_loss} relative, limit "
              f"{SSM_TP_LOSS_REL})")
        alg = kw.get("grad_sync", "locality")
        oracle = fsdp_oracle(full, q, pl, alg, False, m)
        for r, x in enumerate(res):
            got_l = {k: x["launches"][k] for k in want}
            check(got_l == want, f"train_ssm_tp {name} rank {r}: launches "
                  f"{got_l}, the path implies {want}")
            for k, c in path_launches(x["launches"]).items():
                total[k] = total.get(k, 0) + c
            for step, mt in enumerate(x["meter"]):
                check(_nonlocal(mt, alg) == oracle[lane_rank[r]],
                      f"train_ssm_tp {name} rank {r} step {step}: non-local "
                      f"{_nonlocal(mt, alg)}, the oracle "
                      f"{oracle[lane_rank[r]]}")
                _tier_local(f"train_ssm_tp {name}", r, step, mt)
        per_rank = lambda f: [[x_[f] for x_ in x["meter"]] for x in res]
        steady = [float(np.mean(x["step_ms"][1:])) for x in res]
        print(json.dumps({
            "phase": "train_ssm_tp", "variant": name,
            "shared": "8 ranks sharing one H100 over gloo",
            "grid": "2 x 2 x 2 (pod, data, model)",
            "model": full.name, "layers": SSM_TP_LAYERS,
            "reduced": f"depth 48 -> {SSM_TP_LAYERS} layers (gloo host "
                       "transport)",
            "heads_per_rank": ssm_dims(full)[1] // m,
            "dtype": "bfloat16 compute, fp32 master",
            "batch": [q * pl, TRAIN_SEQ], "steps": SSM_TP_STEPS,
            "losses": [x["loss"] for x in res[0]["metrics"]],
            "grad_norms": [x["grad_norm"] for x in res[0]["metrics"]],
            "first_loss_one_rank": one_loss,
            "first_loss_rel_diff": d_loss, "loss_rel_limit": SSM_TP_LOSS_REL,
            "step_ms_by_rank": [x["step_ms"] for x in res],
            "tokens_per_s": q * pl * TRAIN_SEQ / (max(steady) / 1e3),
            "gather_host_ms_by_rank": per_rank("gather_ms"),
            "reduce_scatter_host_ms_by_rank": per_rank("reduce_scatter_ms"),
            "model_tier_host_ms_by_rank": per_rank("model_ms"),
            "sync_host_ms_by_rank": per_rank("sync_ms"),
            "staged_bytes_by_rank": per_rank("staged_bytes"),
            "model_tier_staged_bytes_by_rank": per_rank("model_staged_bytes"),
            "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
            "gathers_per_step": res[0]["meter"][0]["gathers"],
            "reduce_scatters_per_step": res[0]["meter"][0]["reduce_scatters"],
            "model_tier_calls_per_step": res[0]["meter"][0]["model_calls"],
            "model_tier_msgs_per_step_rank0": res[0]["meter"][0]["model"],
            "nonlocal_per_step_by_lane_rank": oracle,
            "nonlocal_equal_to_oracle": True, "model_tier_nonlocal": 0,
            "launches_rank0": {k: res[0]["launches"][k] for k in want},
            "ranks_wall_s": ranks_s, "card": smi}))
    return {"train_ssm_tp": total}


# ---------------------------------------------------------------------------
# phase 10: MoE expert-parallel training on gloo ranks sharing the card
# ---------------------------------------------------------------------------
# 10a: the reduced fp32 qwen2-moe (the smoke config at 2 layers: 8 experts
# at top-4, 2 shared) on 2 x 2 ranks, and with 12 experts on 3 x 2, with
# the locality and the xla dispatch (+ FSDP), against the card's one rank
# at the PARITY_* limits, and with "none" (every rank holds every expert,
# FSDP-gathered: the launcher's and Trainer's default). Each rank's
# auxiliary loss is its own rows' (the JAX step's under its DP shard_map),
# a function of the split: the one rank runs the p ranks' rows as p
# microbatches (``grad_accum=p``), which averages the same p losses and
# gradients. 10b: qwen2-moe-a2.7b at full
# width on 2 x 2 of the ranks, depth cut to 1 layer (the gloo host
# transport; 2 until phase 4v needed the run's time), one 1,024-token
# sequence a rank, locality + FSDP with
# moe_dispatch "locality" (the tokens transport: 2 pods < K·cf = 5) and
# "xla" (slots): both deliver the same slot values to the same expert
# products, so their first losses must be bitwise equal. "none" (~50 s a
# step over gloo at full width) ran here too, its first loss within 1e-2
# of theirs, until phase 8ev needed the run's time; it runs in 10a since.
MOE_PARITY_GRIDS = {(2, 2): {}, (3, 2): {"n_experts": 12}}
MOE_PARITY_VARIANTS = (("locality", dict(fsdp=True, moe_dispatch="locality")),
                       ("xla", dict(fsdp=True, moe_dispatch="xla")),
                       ("none", dict(fsdp=True, moe_dispatch="none")))
MOE_GRID, MOE_LAYERS, MOE_TRAIN_SEQ = (2, 2), 1, 1024
# (dispatch, steps): the locality dispatch two steps (a steady one), xla
# one, the loss agreement's
MOE_DISPATCHES = (("locality", 2), ("xla", 1))


def _moe_small(**over):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(MOE_ARCH),
                               n_layers=PARITY_LAYERS, dtype=torch.float32,
                               **over)


@functools.lru_cache(maxsize=None)
def _moe_one_rank(grad_accum: int, n_experts: int = 0) -> tuple[dict, dict]:
    """:func:`_one_rank_refs` of the reduced qwen2-moe (``n_experts`` in
    place of its 8 where given) with ``grad_accum`` microbatches, run once
    for phases 10c and 10a."""
    over = {"n_experts": n_experts} if n_experts else {}
    return _one_rank_refs(_moe_small(**over), {"grad_accum": grad_accum})


def train_moe_rank(rank: int, world: int, plan: dict) -> dict:
    """One rank of phase 10 (every rank shares the one card): 10a's reduced
    runs on 2 x 2 (ranks 0-3) and 3 x 2, then 10b's full-width runs on 2 x
    2; ranks outside a grid wait at the barrier after each run."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.topology import RankGrid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grids = {shape: RankGrid.build(*shape) for shape in MOE_PARITY_GRIDS}
    out = {"rank": rank, "parity": {}, "full": {}}
    for shape, over in MOE_PARITY_GRIDS.items():
        grid = grids[shape]
        small = _moe_small(**over)
        for name, kw in MOE_PARITY_VARIANTS:
            if grid is not None:
                res = train_run(small, grid,
                                _tree(plan["params"][str(shape)]), kw,
                                PARITY_BATCH, PARITY_SEQ, PARITY_STEPS,
                                "cuda")
                out["parity"][f"{shape[0]}x{shape[1]}|{name}"] = {
                    k: res[k] for k in ("metrics", "shards", "dims", "axes",
                                        "meter", "moe")}
            dist.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    full = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_LAYERS)
    grid = grids[MOE_GRID]
    for name, steps in MOE_DISPATCHES:
        if grid is not None:
            res = train_run(full, grid, None,
                            dict(fsdp=True, moe_dispatch=name,
                                 global_batch=MOE_GRID[0] * MOE_GRID[1]),
                            MOE_GRID[0] * MOE_GRID[1], MOE_TRAIN_SEQ, steps,
                            "cuda")
            res.pop("shards")
            out["full"][name] = res
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def a2a_check(res: list, q: int, pl: int, what: str) -> dict:
    """Each rank's all-to-all record a step against the oracle
    (``schedules.locality_all_to_all`` / ``xla_all_to_all``): non-local
    messages its calls times the oracle's, bytes the oracle's blocks times
    the summed block bytes (``a2a_bytes`` / p); returns rank 0's per step."""
    from repro_torch.core import schedules as TS
    from repro_torch.core.topology import RegionMap
    p = q * pl
    alg = res[0]["moe"][0]
    oracle = TS.ALL_TO_ALL_SCHEDULES[alg](p, pl).per_rank_stats(
        RegionMap(p, pl))
    for r, x in enumerate(res):
        _, _, n_nl, s_nl = oracle[r]
        for step, m in enumerate(x["meter"]):
            st = m["a2a"]
            got = (st["permute_edges_nonlocal"] + st["group_msgs_nonlocal"],
                   st["permute_bytes_nonlocal"] + st["group_bytes_nonlocal"])
            want = (m["a2a_calls"] * n_nl, s_nl * m["a2a_bytes"] / p)
            check(m["a2a_calls"] > 0 and got[0] == want[0]
                  and abs(got[1] - want[1]) <= 1e-6 * max(1.0, want[1]),
                  f"{what} rank {r} step {step}: all-to-all non-local "
                  f"{got}, the oracle {want}")
    return {"oracle_nonlocal_msgs_a_call_by_rank":
            [oracle[r][2] for r in range(p)],
            "calls_per_step": [m["a2a_calls"] for m in res[0]["meter"]]}


def train_moe_on_ranks(smi: str) -> dict[str, dict[str, int]]:
    """Phase 10: the one-rank references here (CPU and card) for 10a, then
    6 spawned ranks (``train_moe_rank``); checks and prints each; returns
    10b's launches per kernel, summed over the ranks and dispatches."""
    from repro_torch import configs
    from repro_torch.launch.serve import run_ranks
    flats, ones, card = {}, {}, {}
    for shape, over in MOE_PARITY_GRIDS.items():
        flats[str(shape)], ones[shape] = _moe_one_rank(
            shape[0] * shape[1], over.get("n_experts", 0))
        card[f"{shape[0]}x{shape[1]}"] = _parity(
            ones[shape]["cuda"], ones[shape]["cpu"],
            f"train_parity_moe {over or 'E=8'}: card vs CPU")
    t0 = time.perf_counter()
    ranks = run_ranks(6, train_moe_rank, {"params": flats}, timeout=900.0)
    ranks_s = time.perf_counter() - t0

    report = {}
    for (q, pl), over in MOE_PARITY_GRIDS.items():
        for name, kw in MOE_PARITY_VARIANTS:
            key = f"{q}x{pl}|{name}"
            res = [ranks[r]["parity"][key] for r in range(q * pl)]
            for r in range(1, q * pl):
                check(res[r]["metrics"] == res[0]["metrics"],
                      f"train_parity_moe {key}: rank {r}'s metrics differ")
            check(res[0]["moe"][0] == name, f"train_parity_moe {key}: "
                  f"dispatch {res[0]['moe']}")
            got = dict(metrics=res[0]["metrics"], params=_assemble(res, pl))
            report[key] = _parity(got, ones[q, pl]["cuda"],
                                  f"train_parity_moe {key}")
            report[key]["transport"] = res[0]["moe"][1]
            if name == "none":           # every expert here: no all-to-all
                check(all(m["a2a_calls"] == 0 for x in res
                          for m in x["meter"]),
                      f"train_parity_moe {key}: all-to-alls ran")
                continue
            report[key]["a2a"] = a2a_check(res, q, pl,
                                           f"train_parity_moe {key}")
    print(json.dumps({
        "phase": "train_parity_moe", "model": _moe_small().name,
        "layers": PARITY_LAYERS, "dtype": "float32",
        "batch": [PARITY_BATCH, PARITY_SEQ], "steps": PARITY_STEPS,
        "experts": {f"{q}x{pl}": _moe_small(**o).n_experts
                    for (q, pl), o in MOE_PARITY_GRIDS.items()},
        "card_vs_cpu": card, "ranks_vs_one_rank": report,
        "loss_rel_limit": PARITY_REL, "param_abs_limit": PARITY_PARAM_ATOL,
        "losses_one_rank": {f"{q}x{pl}": [m["loss"] for m in
                                          ones[q, pl]["cuda"]["metrics"]]
                            for q, pl in MOE_PARITY_GRIDS}, "card": smi}))

    full = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_LAYERS)
    q, pl = MOE_GRID
    total, losses = {}, {}
    for name, steps in MOE_DISPATCHES:
        res = [ranks[r]["full"][name] for r in range(q * pl)]
        for r in range(1, q * pl):
            check(res[r]["metrics"] == res[0]["metrics"],
                  f"train_moe {name}: rank {r}'s metrics differ")
        check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                  for m in res[0]["metrics"]),
              f"train_moe {name}: non-finite metrics")
        losses[name] = [m["loss"] for m in res[0]["metrics"]]
        want_launches = train_launches_implied(MOE_LAYERS, steps)
        for r, x in enumerate(res):
            got_l = {k: x["launches"][k] for k in want_launches}
            check(got_l == want_launches, f"train_moe {name} rank {r}: "
                  f"launches {got_l}, the path implies {want_launches}")
            for k, n in path_launches(x["launches"]).items():
                total[k] = total.get(k, 0) + n
        transport = res[0]["moe"]
        a2a = a2a_check(res, q, pl, f"train_moe {name}")
        want_t = {"locality": "tokens", "xla": "slots"}[name]
        check(transport == (name, want_t),
              f"train_moe {name}: resolved {transport}")
        mean = lambda f: [float(np.mean([m[f] for m in x["meter"]]))
                          for x in res]
        print(json.dumps({
            "phase": "train_moe", "dispatch": name, "transport": transport[1],
            "shared": "4 ranks sharing one H100 over gloo",
            "model": full.name, "layers": MOE_LAYERS,
            "reduced": f"depth 24 -> {MOE_LAYERS} (gloo host transport)",
            "dtype": "bfloat16 compute, fp32 master",
            "batch": [q * pl, MOE_TRAIN_SEQ], "steps": steps,
            "losses": losses[name],
            "moe_aux": [m["moe_aux"] for m in res[0]["metrics"]],
            "grad_norms": [m["grad_norm"] for m in res[0]["metrics"]],
            "step_ms_by_rank": [x["step_ms"] for x in res],
            "a2a_host_ms_per_step": mean("a2a_ms"),
            "moe_gather_host_ms_per_step": mean("moe_gather_ms"),
            "gather_host_ms_per_step": mean("gather_ms"),
            "reduce_scatter_host_ms_per_step": mean("reduce_scatter_ms"),
            "sync_host_ms_per_step": mean("sync_ms"),
            "gathers_per_step": res[0]["meter"][0]["gathers"],
            "a2a": a2a,
            "a2a_nonlocal_msgs_per_step_by_rank": [
                x["meter"][0]["a2a"]["permute_edges_nonlocal"]
                + x["meter"][0]["a2a"]["group_msgs_nonlocal"] for x in res],
            "a2a_nonlocal_bytes_per_step_by_rank": [
                x["meter"][0]["a2a"]["permute_bytes_nonlocal"]
                + x["meter"][0]["a2a"]["group_bytes_nonlocal"] for x in res],
            "staged_bytes_per_step": mean("staged_bytes"),
            "peak_bytes_by_rank": [x["peak_bytes"] for x in res],
            "launches_rank0": {k: res[0]["launches"][k]
                               for k in TRAIN_KERNELS},
            "ranks_wall_s": ranks_s, "card": smi}))
    check(losses["locality"][0] == losses["xla"][0],
          f"train_moe: the tokens and slots transports' first losses "
          f"{losses['locality'][0]} and {losses['xla'][0]} differ")
    print(json.dumps({"phase": "train_moe_agreement",
                      "first_loss_locality_equals_xla": True,
                      "card": smi}))
    return {"train_moe": total}


def ptxas_usage(log: str) -> list[dict]:
    """Registers and spill bytes of every kernel instance in ``build.log``
    (``-Xptxas -v``), names demangled where ``c++filt`` is found."""
    rows, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            rows.append({"kernel": name})
        elif name and "spill stores" in line:
            w = line.replace(",", " ").split()
            rows[-1]["spill_stores"] = int(w[w.index("spill") - 2])
            rows[-1]["spill_loads"] = int(w[w.index("loads") - 3])
        elif name and "Used" in line and "registers" in line:
            w = line.replace(",", " ").split()
            rows[-1]["registers"] = int(w[w.index("registers") - 1])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, demangled in zip(rows, names):
                r["kernel"] = demangled
    except OSError:
        pass
    return rows


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # the seconds since the start after each phase (where the run's time
    # goes, and what to cut when it grows)
    clock = lambda after: print(json.dumps({
        "phase": "clock", "after": after,
        "seconds": time.perf_counter() - t_run}), flush=True)
    info = _build.build()
    _build.lib()
    print(f"kernels built in {info.seconds:.1f} s into {info.path.parent}")
    usage = ptxas_usage(info.log)
    for row in usage:
        print(json.dumps({"phase": "build", **row}))
    # the decode kernels and the flash backward's tensor-core instances
    # must not spill
    spilled = [r["kernel"] for r in usage
               if ("decode_s" in r["kernel"] or "wgmma" in r["kernel"]
                   and "flash_bwd" in r["kernel"])
               and (r.get("spill_stores") or r.get("spill_loads"))]
    check(not spilled, f"kernel instances spill: {spilled}")
    for line in info.log.splitlines():
        if "warning" in line.lower():
            print("  " + line.strip())

    timer = Timer()
    stream = _build.stream_of(timer.flush)
    empty = lambda: _build.check(_build.lib().repro_empty(stream), "empty")
    print(json.dumps({"phase": "launch_floor", "empty_kernel_ms": timer(empty),
                      "host_ms": timer.host_ms(empty), "card": smi}))
    cases = kernel_cases(timer)
    for name, rows in cases.items():
        for row in rows:
            print(json.dumps({"kernel": name, **row}))
    pair = cases.pop("decode_attention")[0]
    offset_rows = cases.pop("decode_offset")
    batch_rows = cases.pop("decode_batch")
    tier_rows = cases.pop("decode_tier")
    ring_rows = cases.pop("decode_ring_shard")
    from repro_torch import configs
    dma = dma_cases_of(configs.get("llama3.2-3b"))
    cases["dma_allgather"] = dma_allgather_cases(timer, dma)
    for row in cases["dma_allgather"]:
        print(json.dumps({"kernel": "dma_allgather", **row}))
    cases["ssd"] = ssd_cases(timer)
    for row in cases["ssd"]:
        print(json.dumps({"kernel": "ssd", **row}))
    clock("forward_kernels")
    bwd = backward_cases(timer)
    clock("backward_kernels")
    for name, rows in bwd.items():
        for row in rows:
            print(json.dumps({"kernel": name, **row}))
            quoted = QUOTED_PR19_MS.get((
                name.split("_")[0], tuple(row["shape"]),
                _mask_name(row["mask"]) if "mask" in row else row["form"]))
            if name == "ssd_bwd":
                quoted = QUOTED_SSD_BWD_MS.get((tuple(row["shape"]),
                                                row["dtype"]))
                if quoted:
                    print(json.dumps({
                        "kernel": name, "shape": row["shape"],
                        "dtype": row["dtype"],
                        "quoted_from": "PERF.md's kernel table, the CUDA-"
                                       "core design's time, NVIDIA H100 "
                                       "80GB HBM3, 700.00 W; not measured "
                                       "here",
                        "quoted_ms": quoted, "ms_this_run": row["ms"]}))
            if quoted and row["dtype"] == "torch.bfloat16":
                print(json.dumps({
                    "kernel": name, "shape": row["shape"],
                    "mask_or_form": row.get("mask", row.get("form")),
                    "quoted_from": "PERF.md, PR 19's chip run, NVIDIA H100 "
                                   "80GB HBM3, 700.00 W; not measured here",
                    "pr19_ms": quoted, "ms_this_run": row["ms"]}))
            quoted = QUOTED_D256_CUDA_CORES_MS.get((
                tuple(row["shape"]), _mask_name(row.get("mask", {})))) \
                if name == "flash_attention_bwd" else None
            if quoted and row["dtype"] == "torch.bfloat16":
                print(json.dumps({
                    "kernel": name, "shape": row["shape"],
                    "mask": row["mask"],
                    "quoted_from": "PERF.md's kernel table, the CUDA-core "
                                   "pair's time, NVIDIA H100 80GB HBM3, "
                                   "700.00 W; not measured here",
                    "cuda_cores_ms": quoted, "ms_this_run": row["ms"],
                    "dq_ms_this_run": row["dq"]["ms"],
                    "dkdv_ms_this_run": row["dkdv"]["ms"]}))
    cases.update(backward_kernel_rows(bwd))
    by_path = {"dma_main_path": {"dma_allgather": dma_main_path(dma[0])}}
    small_end_to_end("llama3.2-3b", 4)
    small_end_to_end("mamba2-780m", 3)
    clock("small_end_to_end")
    moe_cases = moe_kernel_cases(timer)
    for name, rows in moe_cases.items():
        for row in rows:
            print(json.dumps({"kernel": name, **row}))
    clock("moe_kernels")
    variant_cases = variant_kernel_cases(timer)
    for name, rows in variant_cases.items():
        for row in rows:
            print(json.dumps({"kernel": name, **row}))
    clock("variant_kernels")
    for arch, phase in (("llama3.2-3b", "serve_full_width"),
                        ("mamba2-780m", "serve_full_width_ssm"),
                        (MOE_ARCH, "serve_full_width_moe")):
        by_path[phase] = serve_full_width(smi, arch, phase)
        gc.collect()
        torch.cuda.empty_cache()
        clock(phase)
    for arch, phase, cache_len, extra in VARIANT_RUNS:
        by_path[phase] = serve_full_width(smi, arch, phase, cache_len, extra)
        gc.collect()
        torch.cuda.empty_cache()
        clock(phase)
    for arch in VARIANT_EXACT:
        variant_exact_check(smi, arch)
        gc.collect()
        torch.cuda.empty_cache()
    clock("serve_variant_exact")
    llama4_cases = llama4_kernel_cases(timer)
    for name, rows in llama4_cases.items():
        for row in rows:
            print(json.dumps({"kernel": name, **row}))
    clock("llama4_kernels")
    by_path["serve_llama4"] = serve_llama4(smi)
    clock("serve_llama4")
    llama4_exact_check(smi)
    clock("serve_llama4_exact")
    base = {}
    by_path["serve_seq_parallel"], base["serve_seq_parallel"] = \
        serve_seq_parallel(smi)
    clock("serve_seq_parallel")
    by_path["serve_batch_sharded"], base["serve_batch_sharded"] = \
        serve_batch_sharded(smi)
    clock("serve_batch_sharded")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train_one_rank"] = train_one_rank(smi)
    clock("train_one_rank")
    by_path["train_one_rank_ssm"] = train_one_rank(smi, "mamba2-780m",
                                                   "train_one_rank_ssm")
    clock("train_one_rank_ssm")
    paths, variant_refs = train_variants(smi)
    by_path.update(paths)
    clock("train_variants")
    paths, (flat, one) = train_on_ranks(smi)
    by_path.update(paths)
    clock("train_on_ranks")
    by_path.update(train_tp_on_ranks(smi, flat, one, variant_refs))
    clock("train_tp_on_ranks")
    by_path.update(train_moe_on_ranks(smi))
    clock("train_moe_on_ranks")
    by_path["serve_tier"] = serve_tier(smi, base)
    clock("serve_tier")
    by_path.update(train_ssm_tp_on_ranks(smi))
    clock("train_ssm_tp_on_ranks")
    by_path["serve_tier_ssm"] = serve_tier_ssm(smi)
    clock("serve_tier_ssm")
    by_path.update(serve_tier_variants(smi))
    clock("serve_tier_variants")
    by_path["serve_moe_grids"] = serve_moe_grids(smi)
    clock("serve_moe_grids")

    meta = {
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/rmsnorm.py:17", 0),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash.py:32", 1),
        "decode_scores": ("src/repro_torch/kernels/csrc/decode_scores.cu",
                          "src/repro/models/attention.py:126", 0),
        "decode_stats": ("src/repro_torch/kernels/csrc/decode_stats.cu",
                         "src/repro/kernels/decode_stats/stats.py:35", 0),
        "dma_allgather": ("src/repro_torch/kernels/csrc/dma_allgather.cu",
                          "src/repro/kernels/dma_allgather/dma_ag.py:33",
                          DMA_ALGORITHMS.index("locality_bruck")),
        "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
                "src/repro/kernels/ssd/ssd.py:30", 0),
        # the training path's backward kernels: the JAX package has no
        # backward kernel (XLA differentiates plain jnp); each is the
        # backward of the port's kernel for the TPU kernel named
        "flash_attention_bwd_dq": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/flash.py:32 (its backward)",
            0),
        "flash_attention_bwd_dkdv": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/flash.py:32 (its backward)",
            0),
        "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                        "src/repro/kernels/rmsnorm/rmsnorm.py:17 (its "
                        "backward)", 0),
        "ssd_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd.cu",
                    "src/repro/kernels/ssd/ssd.py:30 (its backward)", 0),
        "rmsnorm_bwd_gated": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                              "src/repro/kernels/rmsnorm/rmsnorm.py:17 (the "
                              "backward of its gated form)", 0),
        # the gated form with the row statistic summed over a model tier:
        # two launches forward (rows' sums of squares, finish), two
        # backward (rows' dot products, finish)
        "rmsnorm_gated_tier": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                               "src/repro/kernels/rmsnorm/rmsnorm.py:17 (its "
                               "gated form split over a model tier)", 0),
        "rmsnorm_bwd_gated_tier": (
            "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
            "src/repro/kernels/rmsnorm/rmsnorm.py:17 (the backward of its "
            "gated form split over a model tier)", 0),
    }
    kernels = []
    for name, (source, replaces, headline) in meta.items():
        row = cases[name][headline]                      # bf16, main path
        per_path = {path: counts[name] for path, counts in by_path.items()
                    if counts.get(name)}
        check(bool(per_path), f"{name}: launched on no main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "host_ms": row["host_ms"],
            "shape": row["shape"],
            "dtype": row["dtype"]})
    forms = {r["form"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "max_abs_err")}
             for r in cases["rmsnorm"][::-1] if r["shape"] == [8, 3072]
             and r["dtype"] == "torch.bfloat16"}
    kernels[0]["forms_8x3072_bf16"] = forms
    bwd_kernels = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv",
                   "rmsnorm_bwd")
    for row in kernels:        # the backward pair's, and the lse forward's
        if row["name"] in bwd_kernels:
            src = cases[row["name"]][0]
            row["pair"] = {k: src[k] for k in ("pair_ms", "pair_bound_ms",
                                               "mask_or_form", "instance")}
    train = bwd["flash_attention_bwd"][0]
    kernels[1]["training_shape"] = {
        k: train[k] for k in ("shape", "forward_ms", "forward_lse_ms",
                              "forward_bound_ms", "forward_library_ms",
                              "max_abs_err_forward_o",
                              "max_abs_err_forward_lse")}
    for path, key in (("train_fsdp", "fsdp_rank_cases"),
                      ("train_tp", "tp_rank_cases"),
                      ("train_moe", "moe_rank_cases"),
                      ("train_moe_tier", "moe_tier_rank_cases"),
                      ("train_tier_variants", "tier_variant_rank_cases")):
        rank_rows = [r for r in bwd["flash_attention_bwd"]
                     if r["path"] == path]
        kernels[1][key] = {
            k: [r.get(k) for r in rank_rows]
            for k in ("shape", "mask", "forward_ms", "forward_lse_ms",
                      "forward_bound_ms", "forward_library_ms",
                      "forward_sdpa_uncapped_yardstick_ms",
                      "max_abs_err_forward_o", "max_abs_err_forward_lse")}
    for row in kernels:        # the backward kernels at 8c's, 8e's and edge
        if row["name"] in bwd_kernels:                   # shapes
            for path in ("train_fsdp", "train_tp", "train_moe",
                         "train_moe_tier", "train_variants",
                         "train_tier_variants", "edges"):
                sel = [r for r in cases[row["name"]] if r["path"] == path]
                if not sel:
                    continue
                row[f"{path}_cases"] = {
                    "cases": len(sel),
                    "max_abs_err": max(r["max_abs_err"] for r in sel),
                    **{f: [r.get(f) for r in sel]
                       for f in ("ms", "plain_ms", "bound_ms",
                                 "library_ms", "shape", "mask_or_form",
                                 "instance", "dtype", "pair_ms",
                                 "pair_bound_ms",
                                 "sdpa_uncapped_yardstick_ms")}}
    for row in kernels:        # every case of mamba2's backward kernels
        if row["name"] in ("ssd_bwd", "rmsnorm_bwd_gated",
                           "rmsnorm_gated_tier", "rmsnorm_bwd_gated_tier"):
            rows = bwd[row["name"]]
            row["cases"] = {f: [r[f] for r in rows] for f in (
                "shape", "dtype", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "path")}
            if row["name"] == "ssd_bwd":
                for f in ("rel_err", "bound_cuda_core_ms"):
                    row["cases"][f] = [r[f] for r in rows]
                row["bound_cuda_core_ms"] = rows[0]["bound_cuda_core_ms"]
            else:
                row["cases"]["partial_yardstick_ms"] = [
                    r["partial_yardstick_ms"] for r in rows]
                row["partial_yardstick"] = rows[0]["partial_yardstick"]
    tier_ssd = [r for r in cases["ssd"] if r["path"] == "ssm_tier"]
    kernels[5]["ssm_tier_cases"] = {
        f: [r[f] for r in tier_ssd] for f in (
            "shape", "dtype", "max_abs_err", "y_rel_err", "ms", "plain_ms",
            "bound_ms", "bound_by")}
    phase7 = [r for r in cases["rmsnorm"]
              if r.get("path") == "serve_batch_sharded"]
    kernels[0]["batch_sharded_cases"] = {
        "cases": len(phase7),
        "max_abs_err": max(r["max_abs_err"] for r in phase7),
        **{f: [r[f] for r in phase7] for f in ("ms", "plain_ms", "bound_ms")},
        "forms": [r["form"] for r in phase7],
        "shapes": [r["shape"] for r in phase7]}
    for row in kernels:        # the serving kernels at qwen2-moe's shapes
        rows = moe_cases.get(row["name"])
        if rows:
            row["serve_moe_cases"] = {
                "cases": len(rows),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{f: [r.get(f) for r in rows]
                   for f in ("path", "ms", "plain_ms", "library_ms",
                             "bound_ms", "shape")}}
            if row["name"].startswith("decode_s"):
                row["serve_moe_cases"]["decode_attention_pair"] = {
                    k: [r[k] for r in moe_cases["decode_attention"]]
                    for k in ("path", "ms", "library_ms", "bound_ms",
                              "shape")}
    for row in kernels:        # the dense variants' serving cases (4v)
        rows = variant_cases.get(row["name"])
        if rows:
            row["serve_variant_cases"] = {
                "cases": len(rows),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{f: [r.get(f) for r in rows]
                   for f in ("model", "ms", "plain_ms", "library_ms",
                             "bound_ms", "bound_by", "shape", "mask")}}
            if row["name"].startswith("decode_s"):
                row["serve_variant_cases"]["decode_attention_pair"] = {
                    f: [r[f] for r in variant_cases["decode_attention"]]
                    for f in ("model", "ms", "library_ms", "bound_ms",
                              "shape")}
    for row in kernels:        # llama4-scout's serving cases (4l)
        rows = llama4_cases.get(row["name"])
        if rows:
            row["serve_llama4_cases"] = {
                "cases": len(rows),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{f: [r.get(f) for r in rows]
                   for f in ("run", "use", "ms", "plain_ms", "library_ms",
                             "bound_ms", "bound_by", "shape", "mask",
                             "positions", "slot_offset", "kept_slots",
                             "state")}}
            if row["name"].startswith("decode_s"):
                row["serve_llama4_cases"]["decode_attention_pair"] = {
                    f: [r.get(f) for r in llama4_cases["decode_attention"]]
                    for f in ("run", "ms", "library_ms", "bound_ms",
                              "shape", "state", "max_abs_err_vs_sdpa")}
                row["chunk_ring_launches_by_path"] = {
                    path: by_path[path][f"{row['name']}_ring"]
                    for path in ("serve_llama4", "serve_moe_grids")}
                check(all(row["chunk_ring_launches_by_path"].values()),
                      f"{row['name']}: no chunked-ring launch on a main "
                      "path")
    for row in kernels:        # the pair (scores, accumulate, o / l) and SDPA
        if row["name"].startswith("decode_s"):
            row["decode_attention_pair"] = {
                k: pair[k] for k in ("ms", "library_ms", "bound_ms")}
            key = row["name"].split("_")[1]        # scores | stats
            timed = [r for r in offset_rows if f"{key}_ms" in r]
            row["slot_offset_cases"] = {
                "cases": len(offset_rows),
                "max_abs_err": max(r[f"max_abs_err_{key}"]
                                   for r in offset_rows),
                "ms": [r[f"{key}_ms"] for r in timed],
                "plain_ms": [r[f"{key}_plain_ms"] for r in timed],
                "bound_ms": [r[f"{key}_bound_ms"] for r in timed],
                "states": [r["state"] for r in timed]}
            row["batch_sharded_cases"] = {
                "cases": len(batch_rows),
                "max_abs_err": max(r[f"max_abs_err_{key}"]
                                   for r in batch_rows),
                **{f: [r[f"{key}_{f}"] for r in batch_rows]
                   for f in ("ms", "plain_ms", "bound_ms")},
                "shapes": [r["shape"] for r in batch_rows]}
            row["tier_rank_cases"] = {
                "cases": len(tier_rows),
                "max_abs_err": max(r[f"max_abs_err_{key}"]
                                   for r in tier_rows),
                **{f: [r[f"{key}_{f}"] for r in tier_rows]
                   for f in ("ms", "plain_ms", "bound_ms")},
                **{f: [r[f] for r in tier_rows]
                   for f in ("shape", "slot_offset", "state", "pair_ms",
                             "pair_bound_ms", "library_ms")}}
            row["ring_shard_cases"] = {
                "cases": len(ring_rows),
                "max_abs_err": max(r[f"max_abs_err_{key}"]
                                   for r in ring_rows),
                **{f: [r[f"{key}_{f}"] for r in ring_rows]
                   for f in ("ms", "plain_ms", "bound_ms")},
                **{f: [r[f] for r in ring_rows]
                   for f in ("model", "run", "shape", "slot_offset",
                             "positions", "state", "kept_slots", "pair_ms",
                             "pair_bound_ms", "library_ms")}}
    print(json.dumps({"phase": "wall", "seconds": time.perf_counter() - t_run,
                      "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
