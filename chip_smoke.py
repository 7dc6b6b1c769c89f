#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them.
2. build   — compiles every CUDA kernel of the serve path from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
3. check   — each kernel against its plain PyTorch version on seeded
   inputs at the serve and train paths' shapes, with its stated bound,
   its time, the plain version's time and a yardstick PyTorch call's
   time (CUDA events around back-to-back calls queued behind a spin on
   the device, so that a wrapper's host cost does not hide its kernel; in
   turns plain, kernel, kernel, plain), the kernels' own device time per
   call as the profiler sees it (``device_ms``, over up to 20 calls; null
   where it caught no kernel) and
   the host's time to enqueue one call (``host_ms``), and the
   least time the card could take (the larger of FLOPs / 989 TFLOP/s, or
   / 1979 TFLOP/s for the fp8/int8 GEMM, and bytes / 3.35 TB/s).  The
   windowed flash checks, forward and backward, and the paged decode
   also show that their bound sees a window (or a history) one key
   short; the quantized GEMM, that it sees a quantization grid of
   bk = 128 in place of 256.  The GEMMs
   are checked too at the two operand layouts the training backward
   hands them (an M-contiguous A for dW, a K-major B for dX), at the
   refine_ab unembed's forward and backward (K = 262144 for dX, N = 262144
   for the table's gradient and the forward) and at rwkv6-7b's refine_ab
   decode unembed (4 x 4096 against its 65536 x 4096 f32 table).
4. serve   — gemma3-1b at full width and depth (random weights from a
   seeded generator) behind the continuous-batching engine on the
   kernel routes: 8 requests of 16-700 prompt tokens, 32 new tokens
   each, 4 slots, 1024-token context.  Every request must finish and
   every kernel must have launched during this phase; one prompt's
   prefill logits are held against the same engine on the ``torch``
   reference routes (bound and greedy token), and two faulty reference
   runs, fp8 MLPs and a window one key short, must land outside it.
5. serve_paged — the same model, requests and slots from a paged KV
   cache (8-row pages): (a) bf16 pages on the serve policy, whose tokens
   must equal the dense serve's for every request and which must hand
   every page back; (b) int8 pages with fp8x3 MLPs
   (``ExecutionPolicy(default="bf16", mlp="fp8x3", logits="refine_ab")``),
   where every request must finish, the paged decode and the quantized
   GEMM kernels must both launch, and one prompt's prefill logits are held
   against the bf16-MLP kernel routes, with the single-pass fp8 MLP on the
   same routes as the control above the bound.
6. profile — a 700-token prefill and one 4-slot decode tick, dense and
   paged (bf16 and int8 pages): host wall time against the CUDA kernels'
   time (torch.profiler), the device's idle share, and the kernels that
   take the most of it.
7. train   — gemma3-1b at full width and depth trains 3 AdamW steps
   (batch 2 x 1024 tokens, past the 512 window; remat on; warmup 1)
   through ``TrainLoop`` on the kernel routes, every kernel of the path
   launched during it: loss and grad norm per step, median step time,
   tokens/s, peak memory, and one profiled step.  Before it, step 0's
   loss and five gradient leaves on the kernel routes are held against
   the ``torch`` routes on the same params and batch, and a faulty
   ``torch``-route control (the window one key short) must land outside
   those bounds.
8. serve_moe — Mixtral 8x7B at full width, depth cut to 4 layers (random
   f32 weights from a seeded generator, 24 GB), behind the same engine on
   the kernel routes with the grouped experts on ``cuda_grouped``: the
   same 8 prompt lengths (ids within its 32000 vocabulary), 32 new tokens
   each, 4 slots, 1024-token context.  Every request must finish and every
   kernel of the path launch; one prompt's prefill logits are held against
   the ``torch`` routes at a dropless capacity (capacity_factor = E / k),
   with the same greedy token, and the same reference with one layer's
   expert stack rolled by one (a wrong expert per group) must land above
   the bound.  Then a profile of a 700-token prefill and a 4-slot decode
   tick (``profile_moe``), and ``serve_moe_paged``: the same requests from
   8-row bf16 pages, whose tokens must equal the dense run's and which
   must hand every page back.  Neither path may run a grouped call on the
   WMMA tile: their decode calls run the split-K weight stream (``splitk``;
   the profiled decode ticks' grouped calls all of them), their 64/128-row
   prefills the wgmma mainloop (``sm90``).
9. train_moe — Mixtral at full width, depth 2, trains 3 AdamW steps
   (batch 1 x 1024, remat, warmup 1) on the kernel routes, the grouped
   forward, dx and dW kernels included; step 0's per-token loss, aux loss
   and five gradient leaves are held against the ``torch`` routes
   (dropless capacity), with the rolled-experts control above the bounds.
Phases 10 and 11 run right after 6, while gemma3's params are loaded;
12 runs after 9, once Mixtral is freed, and 13 to 27 after 12, each once
the model before it is freed.

10. serve_naive — gemma3-1b again (full width and depth, the serve
   phase's params, requests, slots and context) on the paper's unstaged
   GEMM: ``gemm=cuda_naive, attention=cuda_fused`` with the serve policy,
   so the refine_ab unembed runs as four naive bf16 passes.  Every request
   must finish; the naive GEMM and both flash kernels must launch and the
   tiled and refined GEMMs must not; one prompt's prefill logits are held
   against the ``torch`` routes (the serve phase's bound, same greedy
   token); a decode tick is profiled.
11. batched — the paper's Fig. 7 path through its entry point,
   ``kernels.ops.gemm_batched``, at n = 16 and G = 256, 1024, 4096 and
   16384 on ``torch``, ``cuda`` (packed) and ``cuda_naive`` (a warp per
   matrix), beside f32 ``torch.bmm`` with TF32 off (the paper's batched
   SGEMM): ms and TFLOP/s per backend, each kernel output held against
   ``torch``.
12. serve_rwkv — RWKV-6 7B at full width and depth (32 layers, d_model
   4096, 64 heads of 64, d_ff 14336, vocab 65536; random f32 weights from a
   seeded generator, 30.2 GB) behind the same engine on ``gemm=cuda`` with
   the serve policy: the same 8 prompt lengths (ids within 65536), 32 new
   tokens each, 4 slots.  Every request must finish and the tiled and
   refined GEMMs launch.  On the prompt whose last token sits earliest in
   its 64-step WKV chunk, every layer at the serve policy (the same input
   on both routes) and the prefill logits at f32 activations on the
   refine_ab rung are held against the ``torch`` routes (the serve
   policy's logits, which this random 32-layer stack scatters by ~1 from
   any summation order, are not checked), each with a faulty reference (the
   WKV state reset at every chunk boundary) above its bound.  The ``wkv6``
   kernel, which the model does
   not call (as in the JAX package), is driven through its own entry point
   on each prompt's first-layer r/k/v/logw/u (the ``wkv6`` path) and held
   against the model's chunked form at f32; its check row takes the
   665-token prompt's.  Then a profiled prefill and decode tick.
13. serve_zamba2 — zamba2-7b at full width and depth, nothing cut (81
   mixers: 68 Mamba-2 layers and 13 occurrences of one shared attention
   block, hd 112, 32 heads on 32 kv heads; random f32 weights from a
   seeded generator, 22.95 GB) behind the same engine on ``gemm=cuda,
   attention=cuda_fused`` with the serve policy: the same 8 prompt lengths
   (ids within 32000), 32 new tokens each, 4 slots.  Every request must
   finish and every kernel of the serve path launch.  On the prompt past
   the first 256-step SSD chunk whose last token sits earliest in its
   chunk, and on a copy of the stack whose SSD state decays slowly (the
   random init's decays within a few steps, so a state fault hides under
   rounding; for the bf16 layers a second copy with the D skip at 0, the
   mixer's output all SSD), the serve policy's prefill
   logits, the prefill logits at f32 activations on the refine_ab rung and
   every sublayer at the serve policy (at bf16 and at f32 activations) are
   held against the ``torch`` routes, with the SSD state reset at every
   chunk boundary as the faulty reference above each bound.  Then ``serve_zamba2_paged``: the same requests from 8-row
   bf16 pages (a pool per shared-block occurrence), whose tokens must equal
   the dense run's, which must hand every page back and launch the paged
   decode; then a profiled prefill and decode tick.
14. serve_nemotron — nemotron-4-340b at full width (d 18432, 96 heads of
   192 on 8 kv heads, d_ff 73728, vocab 256000), depth cut to 2 (65.4 GB
   of f32 weights), the same engine, policy and requests (ids within
   256000).  Every request must finish and every kernel launch; one
   prompt's prefill logits are held against the ``torch`` routes (bound
   and greedy token; the reference's refine_ab unembed over vocab chunks),
   with fp8 MLPs on the kernel routes as the control above the bound; then
   a profiled prefill and decode tick.
15. serve_whisper — whisper-medium whole, nothing cut (24 encoder and 24
   decoder layers, d 1024, 16 heads of 64, vocab 51865 tied, learned
   positional tables; random f32 weights from a seeded generator, 3.2 GB)
   behind the same engine, policy and requests (ids within 51865); each
   prefill encodes 1500 zero frames, as ``repro``'s engine does, and keeps
   each decoder layer's cross-attention K/V (1500 rows, never padded or
   paged).  Every request must finish and every kernel of the serve path
   launch.  On seeded random frames, one prompt's prefill logits (bound and
   greedy token) and the encoder's hidden states are held against the
   ``torch`` routes, with the reference's encoder run causal as the control
   above each bound.  Then ``serve_whisper_paged`` (8-row bf16 pages for the
   self-attention, the cross caches dense beside them; tokens equal to the
   dense run's, every page handed back) and a profiled prefill and decode
   tick.
16. serve_internvl2 — internvl2-76b at full width (d 8192, 64 heads of 128
   on 8 kv heads, d_ff 28672, vocab 128256), depth cut to 8 of 80 (36 GB of
   f32 weights), the same engine, policy and requests (ids within 128256),
   each after 256 image rows (zero embeddings in the engine, as in
   ``repro``): at most 256 + 700 + 32 rows of the 1024-row context.  Every
   request must finish and every kernel launch; one prompt's prefill logits
   on seeded random image embeddings are held against the ``torch`` routes
   (bound and greedy token), with the image rows rolled by one position as
   the control above the bound; then ``serve_internvl2_paged`` (tokens equal
   to the dense run's) and a profiled prefill and decode tick.
17. train_rwkv — rwkv6-7b at full width, depth 4 of 32 (1.41 B params),
   trains 3 AdamW steps (batch 1 x 1024, remat, warmup 1) through
   ``TrainLoop`` on ``gemm=cuda`` with phase 7's policy, the tiled and
   refined GEMMs launched; before it, step 0's per-token loss and five
   gradient leaves (the embedding, a time-mix LoRA, the channel-mix key, a
   time-mix output, the unembed) on the kernel routes are held against the
   ``torch`` routes at phase 7's bounds, on a copy whose WKV state decays
   slowly (the random init forgets it within a chunk), with the state reset
   at every 64-step chunk boundary as the control above both bounds; then
   one profiled step.
18. train_zamba2 — zamba2-7b at full width, two periods of [5 mamba2 +
   shared_attn] (12 mixers, the shared block applied twice), the same way:
   batch 1 x 1024, every kernel of the train path launched (the flash
   forward and backward at hd 112 on ``sm90``); the leaves include the
   shared block's ``wq`` and MLP ``wo`` and an ``in_proj``; slow-decay copy,
   the SSD state reset at every 256-step chunk boundary as the control.
19. train_whisper — whisper-medium whole (24 + 24 layers), batch 2 x 448
   decoder tokens against 1500 random frames: the encoder's flash forward
   and backward without a mask, the cross-attention's at Sq 448 against
   1500 keys, the tied table's gradient through the lookup and the unembed;
   the leaves include an encoder ``wq``, a cross ``wk`` and the tied table;
   the control runs the encoder causal.
20. train_internvl2 — internvl2-76b at full width, depth 1 of 80 (2.96 B
   params, 47 GB with AdamW state; depth 2 peaked at 80 GB), batch 1 x
   (256 image rows + 256 text
   tokens), the loss on the text rows: the flash backward at 64 heads on 8
   kv (G = 8); the control rolls the image rows by one position.
21. precision — the paper's Fig. 8 protocol (``core/error.py``) on card
   tensors: A, B ~ U[-1, 1] and U[-16, 16] at N = 1024, 4096 and 8192
   (``random_operands``), every ``gemm`` rung on the ``cuda`` route (bf16,
   refine_a, bf16x3, refine_ab, bf16x6, f32, fp8x3, int8x3) and on the
   ``torch`` route, and cuBLAS (bf16 with an f32 output, f32 SGEMM with
   TF32 off and on): each row's max-norm error against the f64 product
   formed on the card and against the f32 product, its relative Frobenius
   error and its ms.  Held at every point: the ladder order of
   ``tests/test_precision.py``, each ``cuda`` rung within twice the
   ``torch`` route's error, and the rung each refined rung refines (one
   refinement dropped) above that bound.
22. serve_stack — the serve stack (``repro_torch.serve``) over gemma3-1b
   at full width and depth, fresh params from phase 4's seed, phase 4's
   policy, 4 slots a replica, 1024-token context: (a) phase 4's 8
   requests through ``ReplicaPool`` at 1 and at 2 replicas sharing one
   params tree, every request's tokens equal to phase 4's, every page
   handed back, and one profiled pool step with both replicas' slots busy;
   (b) ``run_sweep`` at 2 replicas, ``max_queue`` 8, 16
   open-loop Poisson requests (lognormal prompts, median 256, up to 900;
   outputs median 32, up to 96) at 0.1, 0.2 and 0.4 requests a tick (p50 /
   p99 TTFT and end-to-end latency in ticks, goodput in tokens a tick,
   rejection rate, wall tok/s and seconds, peak memory), the 0.4 point
   queueing or rejecting, and 0.4 again under the autoscaler (1 to 3
   replicas, starting at 1), which must scale; (c) the fault plan ``7:crash@6,hang@14x4``
   at 0.2 on 8-row bf16 pages, every completed stream token-exact against
   a single-slot reference engine (a rehomed stream resumes by replaying
   its held tokens through decode steps), a recovery, no page outstanding,
   and a
   re-admission with a forged last token raising ``RecoveryMismatch`` and
   freeing its pages; (d) the HTTP gateway on 127.0.0.1: 4 of phase 4's
   prompts streamed at once (tokens equal to the pool's in (a)), a submit
   past the in-flight watermark answered 429 with Retry-After,
   ``/metrics``' ``serve_tokens`` total equal to the tokens streamed, a
   client that leaves mid-stream freeing its slot, ``/healthz`` ok.  The
   tiled and refined GEMMs, the flash forward, the decode and the paged
   decode must all launch.
23. audit — the static auditor (``repro_torch.analysis``) on this card:
   ``audit_all`` (every registered surface, traced by ``make_fx`` on fake
   CUDA tensors, and the Python and CUDA source sweeps) and
   ``audit_execution_policy`` for the policy of each serve and train
   phase above (gemma3 serve, paged bf16 and int8 KV, the naive GEMM and
   train, each with its refine_ab unembed; Mixtral serve and train,
   rwkv6, zamba2).  No unsuppressed finding, every kernel counter and
   ``torch.cuda.memory_allocated()`` unchanged by the phase, and each of
   the 11 registry-reachable kernel entry points traced at least once
   (the line counts the kernel sites each showed).  The line also times
   one decode-shape ``gemm_tiled`` call's enqueue (tracing off: the
   entry point's one flag test is all the trace hook costs it) and the
   flag test alone.
24. mesh — the port's mesh layer (``core.ops.shard``, ``runtime.world``)
   on this card: four ranks share it over gloo (NCCL takes one rank a
   card; where there are as many cards as ranks the phase uses NCCL, one
   rank a card), started after phase 2 built every library, each running
   ``runtime.mesh_checks``' workers.  (a) The parity matrix on the kernel
   routes (``mesh_checks.parity_cases("card")``: column- and row-parallel
   GEMM at dp=2,tp=2, the vocab-TP refine_ab logits at tp=4, the flash
   forward and decode at dp=2,tp=2, the grouped GEMM at ep=2 and
   ep=2,tp=2, prefill and decode sizes), every rank's result against the
   same call on one device in this process: the ranks agree, each case
   is within its bound and the line names the bit-equal ones.  (b)
   gemma3-1b at full width and depth trained at dp=2,tp=2 (FSDP over
   ``data`` by the ``Sharder``) for 2 steps on phase 7's policy and
   batch: step 0's per-token losses and the five gradients against phase
   7's one-device step 0 on the same kernel routes, held at phase 7's
   bounds and at tighter ones of its own, with two faulty controls (every
   data rank taking rank 0's rows; every sharded GEMM row-parallel with
   its partials reduced in bf16) above them; then the saved step-2
   checkpoint resumed elastically on two ranks (``--mesh auto``: dp=2)
   for 1 more step.  (c) Mixtral 8x7B at full width, depth 2, served at
   ep=2,tp=2: serve_moe's 8 requests, 32 tokens each, the same greedy
   tokens as one device, prompt 0's prefill logits within serve_moe's
   bound.  The lines give every rank's peak memory and times beside the
   one-device phases', the share of wall time in collectives, the
   transport and which collectives went through host memory.
25. serve_dbrx — dbrx-132b at full width (d 6144, 48 heads of 128 on 8 kv
   heads, 16 experts top-4 of 6144 -> 10752, vocab 100352), depth cut to 2
   of 40 (31 GB of f32 weights), on serve_moe's policy (the experts on
   ``cuda_grouped``): phase 4's 8 prompt lengths (ids within the
   vocabulary), 32 new tokens each, 4 slots, 1024-token context.  Every
   request must finish and every kernel of the path launch, the grouped
   GEMM on both ``sm90`` (prefill) and ``splitk`` (decode) and never the
   WMMA tile; one prompt's prefill logits are held against the ``torch``
   routes at a dropless capacity (serve_moe's bound, same greedy token),
   with one layer's experts rolled by one as the control above the bound.
   Then ``serve_dbrx_paged`` (8-row bf16 pages on the grouped route: tokens
   equal to the dense run's, every page handed back) and a profiled
   prefill and decode tick.
26. serve_starcoder2 — starcoder2-15b whole, nothing cut (40 layers, d
   6144, 48 heads of 128 on 4 kv heads, a GELU MLP of 24576, vocab 49152;
   63.8 GB of f32 weights), every QKV and MLP bias seeded non-zero on the
   card (init makes them zero), the serve policy, the same requests.  The
   prefill logits are held at gemma3's bound against the ``torch`` routes,
   with the same stack's biases zeroed as the control above it; then the
   paged twin and a profiled prefill and tick.
27. serve_command_r — command-r-35b at full width (d 8192, 64 heads of 128
   on 8 kv heads, d_ff 22528, vocab 256000, RoPE theta 8e6), depth cut to 4
   of 40 (28.1 GB), the same way; the reference's refine_ab unembed runs
   over vocab chunks, and fp8 MLPs on the kernel routes are the control.
   Each of 25-27 gives its params, weights, init, peak memory, tok/s,
   TTFT, launches and seconds.
28. kernels — a ``mainloops`` line (which mainloop each ``gemm_tiled``,
   ``gemm_refined``, ``gemm_lowp``, ``grouped_gemm``, ``grouped_gemm_dw``,
   ``flash_attention``, ``flash_attention_bwd_dq`` and
   ``flash_attention_bwd_dkv`` check ran: every M > 16 shape, every
   64/128-row bf16 grouped shape, the bf16 dW and every bf16 flash forward
   and backward must run the wgmma one, ``sm90``, and every M <= 16
   ``gemm_tiled``, ``gemm_refined`` and ``gemm_lowp`` shape the split-K
   weight stream or, for ``gemm_lowp``, its fused decode kernel, and every
   16-row bf16 or refined ``grouped_gemm`` shape the split-K stream's
   group-rows mode, all ``splitk``; each check asserts it), then one line
   listing each kernel's
   launches (per path, and per mainloop for those eight; every path's bf16
   forward, backward and dW launches must all have run ``sm90``, no path's
   ``gemm_tiled``, ``gemm_refined`` or ``gemm_lowp`` launch may have run
   ``wmma``, and
   every path's dense and paged decode launches must have split their KV
   walk, ``split_launches_by_path``), error and times.  The decode rows
   record the KV splits the host picked (``splits``).  The flash
   backward's causal rows time SDPA's backward with the boolean mask and
   with ``is_causal=True``, and name the backend SDPA picked for each.

The ``check`` phase also holds the flash kernels at Mixtral's head shape
(hd 128, 32 heads on 8 kv heads) and the grouped GEMMs at its widths: the
forward at the prefill's wi and wo (T*k = 1400) at bf16 and refine_ab, the
decode (T*k = 8, 16-row tiles on the split-K weight stream, given the real
counts) at wi bf16 and refine_ab and wo bf16, and wi bf16 again with the 8
rows on one expert and on all eight (``grouped_decode_live_experts``: the
one-expert row streams an eighth of the weights), the backward's dx
(``trans_w``, T*k = 2048) and dW, with group sizes from a seeded skewed
draw and a faulty control (every group against its neighbouring expert;
for dW, run boundaries moved by one tile) above the bound.

The ``check`` phase also holds one rung that the flash and grouped kernels
carry from f32 tiles per kernel (flash bf16x6 forward and backward, int8x3
decode, fp8x3 paged decode, fp8x3 grouped forward, int8x3 dW), the
forward's bf16x6 and the grouped fp8x3 also against the ``torch`` route at
that rung, and the grouped forward at alignments 128 and 64 (the wgmma
mainloop's two row tiles).

The ``check`` phase also holds the kernels at zamba2-7b's and
nemotron-4-340b's shapes: the flash forward (S = 700, causal) and decode
(B = 4, linear 1024) at hd 112 (32 heads on 32 kv) and hd 192 (96 on 8,
G = 12), the paged decode at hd 112, ``gemm_tiled`` at Mamba-2's in_proj
(3584 -> 14576, a partial 64-column tile; M = 4 and 700), the SSD's batched
C.B^T (three 256-step chunks) and nemotron's decode MLP (4 x 18432 x 73728
and back), and ``gemm_refined`` at nemotron's refine_ab decode unembed
(4 x 18432 against its 256000 x 18432 f32 table; the plain version over
vocab chunks).  The hd 192 forward holds its query rows with 64 keys or
more at the attention bound and its first 64 rows in units of each
output's softmax-weighted |v| (see FEW_KEYS).

The ``check`` phase also holds the kernels at whisper-medium's and
internvl2-76b's shapes: the flash forward at hd 64 (16 heads on 16 kv)
over the encoder's 1500 frames without a mask, and as cross-attention at a
700-row prefill and a one-row decode (B = 4) against 1500 keys; the dense
and paged decode at hd 64, G = 1 and the decode at hd 128, G = 8; the
refine_ab decode unembeds onto 51865 columns (whisper's tied table, its
25-column tail checked apart) and 128256 columns (d 8192); ``gemm_tiled``
at the cross K/V projection (1500 x 1024 x 1024) and internvl2's decode
MLP (4 x 8192 x 28672 and back).

The ``check`` phase also holds the flash backward (dq and dk/dv) at the
training shapes of phases 17-20: whisper's encoder (B = 2, 1500 frames,
no mask, hd 64), its cross-attention (B = 2, Sq 448 against 1500 keys),
zamba2's shared block (S = 1024 causal, hd 112, 32 on 32 kv) and
internvl2's heads (S = 512 causal, 64 on 8 kv, hd 128), each with SDPA's
backward as its yardstick and the mask flipped as its control, and
``gemm_refined`` at whisper's train unembed dX (896 x 51865 x 1024,
refine_ab).

The ``check`` phase also holds the paper's naive GEMM at gemma3's prefill
MLP and decode unembed and at a square 4096^3 point (Fig. 6, with the
tiled kernel checked there too, bf16 cuBLAS and f32 SGEMM beside it), both batched kernels
at n = 16 (G = 256 and 16384) and n = 8, 32, 64 (G = 4096) with the B
batch rolled by one matrix as their control (``torch.bmm`` with an f32
output as the library call, the bf16-out call beside it), and ``wkv6`` at
B = 4, S = 1024, H = 64 on the JAX test's input recipe, against its
chunked plain version and the sequential recurrence, with the state reset
at every chunk boundary and its own arithmetic on one TF32 pass as its
controls (its operations bound at 3xTF32 on the tensor cores).

The ``check`` phase also holds the kernels at the shapes of phases 25-27:
the grouped forward at dbrx's experts (E = 16, top-4, 6144 -> 10752) at a
decode tick (4 rows x top-4, 16-row tiles on the split-K weight stream,
given the real counts) and at a 700-token prefill (T*k = 2800, 128-row
tiles, wgmma), the flash forward (S = 700, causal) and decode (B = 4,
linear 1024) at starcoder2's 48 heads on 4 kv heads (G = 12, hd 128), and
``gemm_refined`` at command-r's refine_ab decode unembed (4 x 8192 against
its 256000 x 8192 f32 table; the plain version over vocab chunks).

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; without a GPU, or without ``src/repro_torch`` beside
this file, nothing is measured and the script exits 1.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_LOWP_OPS = 1979e12       # H100 SXM dense fp8 / int8 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 rate on the CUDA cores (no tensor cores)
PEAK_TF32_FLOPS = 495e12      # H100 SXM dense TF32 tensor-core rate

# kernel-vs-plain bounds (max |kernel - plain|): same bf16 terms, exact
# products, f32 sums in another order; for attention also expf ulps and
# a probability that may round to the neighbouring bf16 value.
GEMM_BOUND = 1e-3
ATTN_BOUND = 2e-3
# serve prefill logits (|logits| <= 4.64), kernel routes vs torch
# reference routes: 0.0887 on the H100 in every run (the flash kernels
# round probabilities against a 32-row running max, the reference
# against its chunk's, so bf16 activations round apart now and then).
# Two faulty controls on the reference routes read 0.148 (a window one
# key short) and 0.581 (fp8 MLPs); every run checks that both land above.
LOGITS_BOUND = 0.12
# flash backward kernels vs their plain versions at the train shapes
# (max |kernel - plain|; |dO| ~ 1e-2): the same bf16 terms with f32 sums
# in another order.  dq (rms 1.7e-2) and dk/dv (rms 2.2e-3 to 2.5e-3)
# each have a bound of their own.  Measured on the H100 at window 512:
# dq 1.0e-4, dk/dv 6.6e-6; the plain version at window 511 reads 0.041
# (dq) and 0.0023 (dk/dv), and every run requires it above the bound.
ATTN_BWD_DQ_BOUND = 1e-3
ATTN_BWD_DKV_BOUND = 1e-4
# dk/dv at Mixtral's head shape (hd 128, 32 heads on 8 kv, 1 x 1024
# causal; rms 2.1e-3 and 2.5e-3): 1.15e-4 on the H100, above the gemma3
# bound: the first causal rows put probabilities near 1 on few keys, so a
# p that rounds to the neighbouring bf16 value in one version moves dv by
# up to 2^-8 |dO|.  Set after that reading; the plain version at window
# 512 (half the keys of the later rows) is the control every run requires
# above it, for dq (ATTN_BWD_DQ_BOUND) as for dk/dv.
MIXTRAL_ATTN_BWD_DKV_BOUND = 5e-4
# step 0 on full-size gemma3-1b (2 x 1024 tokens), kernel routes vs torch
# routes: the largest difference of one token's loss, and the largest
# ||g_kernel - g_torch|| / ||g_torch|| over five gradient leaves.  The mean
# loss cannot tell the two routes from the faulty control (window one key
# short): 3.9e-4 against 4.3e-4 on the H100.  The gradients read at most
# 0.030 (kernel routes) against 0.041-0.10 (control).
STEP0_TOKEN_LOSS_BOUND = 0.1
STEP0_GRAD_BOUND = 5e-2
# quantized GEMM vs its plain version (|C| <= ~6 at these shapes): int8
# sums exact integers and dequantizes in the plain version's order of
# roundings; e4m3 partial sums round in f32 in another order.  On the H100:
# int8x3 0 (bit-equal), fp8x3 4.8e-7 and 9.5e-7; the control, the plain
# version on a grid of bk = 128, reads 3.7e-4 and 6.7e-4 (int8x3), 5.3e-3
# and 6.6e-3 (fp8x3), and every run requires it above the bound.
LOWP_BOUND = 2e-5
# the flash kernels' quantized x3 rungs vs their plain versions (one check
# each: int8x3 decode, fp8x3 paged decode; |out| rms 0.12-0.14): the same
# tiles and pow2 scales, so they differ only where a sum in another order
# moves a probability across a quantization step, and the lo term makes up
# all but its own step (2^-13 for int8).  The H100 read 1.5e-4 (int8x3)
# and 1.2e-7 (fp8x3) before this bound was set.  Control: the plain
# version at the one-pass rung (the third pass dropped), 0.014 and 0.045
# there, which every run requires above it.  The grouped kernels'
# quantized rows keep GEMM_BOUND (their terms are bit-equal: nothing
# derived is quantized; one-pass controls 0.21 and 0.051).
QUANT_ATTN_BOUND = 1e-3
# serve_paged (b): prefill logits with fp8x3 MLPs on the kernel routes
# against the bf16-MLP kernel routes (|logits| <= 4.64).  Set after reading
# them on the H100: fp8x3 0.0778, and 0.576 for the single-pass fp8 MLP on
# the same routes, the control that every run requires above the bound.
FP8X3_LOGITS_BOUND = 0.2
# serve_moe: Mixtral (depth 4) prefill logits (|logits| <= 4.48), kernel
# routes vs torch routes at a dropless capacity: 0.052 on the H100, the
# rolled-experts control 2.86, which every run requires above the bound
# (gemma3's, kept).
MOE_LOGITS_BOUND = 0.12
# train_moe step 0 (1 x 1024 tokens, depth 2), kernel routes vs torch
# routes, both on the experts the kernel routes picked (the torch routes
# replay those ids and gate with their own probabilities, so a top-2 that
# rounding would flip between the routes is taken out of the comparison;
# the line counts such tokens): one token's loss and the five gradient
# leaves (relative) are held to gemma3's step-0 bounds, and the aux loss
# to its own.  The rolled-experts control, on the same picks, must read
# above the first two (its first MoE layer routes the same input, so the
# aux loss need not move).  On the H100: token loss 0.026, gradients
# 0.012-0.014, aux 4.4e-4; the control 3.66 and 1.31-1.38.
MOE_STEP0_TOKEN_LOSS_BOUND = STEP0_TOKEN_LOSS_BOUND
MOE_STEP0_AUX_BOUND = 1e-2
MOE_STEP0_GRAD_BOUND = STEP0_GRAD_BOUND


# 24 mesh.  Four ranks (two for the elastic resume) share the one card
# over gloo, whose collectives stage CUDA tensors through host memory;
# each world has MESH_TIMEOUT seconds.  (a) Each parity case carries its
# bound (``mesh_checks.parity_cases("card")``).  A rank plans its block's
# splits as one device plans the whole problem (``kernels.gemm_tiled.
# SM_SHARE``), so every case cut on whole tiles is held bit-equal; the
# row-parallel GEMM sums K in two halves, held at ROW_F32_BOUND's 1e-5
# (4.77e-7 on the H100).  (b) Step 0 at dp=2,tp=2 against
# the one-device step 0 on the same kernel routes, held at phase 7's
# bounds and at MESH_STEP0_*, each set after the H100's reading: every
# token's loss bit-equal (0.0), the five gradients 6.1e-8 (the unembed
# table) to 0.016 relative (the four leaves below it).  The tp cut alone
# gives those 1-2%: ``tools/mesh_phase.py --witness`` reads the same
# 0.0106-0.0160 at tp=2, while dp=2 is bit-equal to one device at 2
# microbatches (which reads 6e-8 against the whole batch).  In the
# backward a column-parallel GEMM's dX is the f32 sum of the tp ranks'
# partial products, an order one device never takes, and the bf16
# backward carries it down the layers.  The controls, each on its
# forward's per-token losses: every sharded GEMM row-parallel with its
# partials reduced in bf16 (0.084; its gradients read 0.022-0.041 in a
# run that took them) and every data rank on rank 0's rows (4.37; 1.0);
# both must land above MESH_STEP0_TOKEN_LOSS_BOUND, the latter above
# phase 7's too (the bf16 epilogue stays within that one).
# (c) Mixtral's prefill logits at ep=2,tp=2: 0.0 on the H100, held at
# MOE_LOGITS_BOUND, and every greedy token equal to one device's.
MESH_RANKS = 4
MESH_RESUME_RANKS = 2
MESH_TRAIN = "dp=2,tp=2"
MESH_RESUME_STEPS = 1
MESH_SERVE = "ep=2,tp=2"
MESH_SERVE_DEPTH = 2
MESH_TIMEOUT = 600
MESH_STEP0_TOKEN_LOSS_BOUND = 1e-3
MESH_STEP0_GRAD_BOUND = 2.5e-2
MESH_CONTROLS = ("rows_repeated", "bf16_row_epilogue")
MESH_KERNELS = ("gemm_tiled", "gemm_refined", "flash_attention", "flash_decode",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "grouped_gemm")


# batched small GEMMs vs their plain versions (n <= 64, |terms| ~ 1): the
# same exact bf16 products, f32 sums in another order.
BATCHED_BOUND = 1e-4
# wkv6 vs its chunked plain version and the sequential recurrence: f32
# elementwise work, products at 3xTF32 (~21 significand bits), sums in
# other orders and exp ulps (TestWKV6Kernel's 1e-4).  Absolute on the JAX
# test's input recipe; on the model's layer inputs, relative to the
# largest |out| (and |state|) of the plain version.  The kernel's own
# arithmetic on one TF32 pass (``wkv6_scan_plain(passes=1)``) must land
# above it.
WKV_BOUND = 1e-4
# serve_rwkv.  This random full-size stack amplifies a rounding difference
# some 300-fold over its 32 layers: on the H100 the serve policy's two
# routes, each running on its own outputs, part by one bf16 ulp (0.125 at
# |x| 30) after layer 0 and by 43 (at |x| 173) after layer 31, and their
# prefill logits by 1.04 (0.60 at f32 activations) with another greedy
# token, each route 2.0 from the f32 model (PERF.md records these
# readings); so the serve policy's logits cannot tell a fault from a
# summation order, and are not checked.  Gated, each with the
# chunk-reset control above it: (a) every layer at the serve policy on the
# same input on both routes, max |kernel - torch| over the layer's max
# |out| (one layer read 0.004-0.009); (b) the prefill logits on f32
# activations at the refine_ab rung (every projection, WKV contraction and
# the unembed on gemm_refined), against the torch routes at that rung, with
# the same greedy token.  On the H100: (a) 0.0029-0.0072 over the 32
# layers, every layer's control 0.13-0.68; (b) 0.0024, the control 6.3.
RWKV_LAYER_BOUND = 2 ** -5
RWKV_LOGITS_BOUND = 2e-2
# the flash forward at nemotron's head shape (S = 700 causal, 96 heads on 8
# kv heads, hd 192): kernel and plain version part where a probability
# rounds to the neighbouring bf16 value in one of them, which moves an
# output by up to 2^-8 |v| / l, largest in the early causal rows (few keys,
# l near 1).  96 heads give that many chances: over 40 seeded draws on the
# H100 (tools/flash_flip_tails.py) the whole output read 0.0005-0.0039, 8
# draws above ATTN_BOUND, every one at a query row with under 40 keys.  So
# the rows with FEW_KEYS keys or more are held at ATTN_BOUND like every
# other flash row, and the first FEW_KEYS rows in units of the row's
# softmax-weighted |v| (sum_j w_j |v_j| per output element): each side's
# weights sit within 2^-7 of their own (a P and the normalizer rounded),
# so the two part by at most 2^-6 of it.  A missing or extra key moves
# such a row by 1 / (keys + 1) of it or more.  Over the 40 draws the rows
# with 64+ keys read at most 0.0012 and the first rows at most 0.0039 of
# their weighted |v|.
FEW_KEYS = 64
FEW_KEYS_SCALED_BOUND = 2 ** -6
# serve_zamba2 (81 mixers, the SSD state carried over 256-step chunks),
# kernel routes vs torch routes on the prompt past the first chunk whose
# last token sits earliest in its chunk (545 tokens), the chunk-reset
# fault (the SSD state reset at every chunk boundary) as the control.  The
# random init's SSD state decays within a few steps (per-step decay
# e^(-dt a), a from 1 to 8, dt ~ 0.7), so a reset moved little: on the H100
# the serve policy's logits parted by 0.196 with the control at 0.141, and
# at bf16 a layer's reset hid under a rounding.  So the comparisons run on
# copies of the stack whose SSD state decays slowly (ZAMBA2_SLOW_A, dt_bias
# ZAMBA2_SLOW_DT_BIAS: dt ~ 0.13, e^(-0.0013..-0.013) a step, a chunk keeps
# 4%-72% of its input state), the weights shared with the served stack.
# Held, each with its control above: (a) the serve policy's prefill
# logits; (b) the prefill logits at f32 activations on the refine_ab rung;
# (c) every sublayer at the serve policy on the same input, at f32
# activations max |kernel - torch| over the layer's max |out - in|; on the
# H100 (a) 0.211 (control 4.07), (b) 2.2e-4 (4.20), (c) 0.00057-0.0018
# (0.139-0.387).  And (d) every sublayer at bf16 activations, max |kernel -
# torch| over the layer's max |out|, on a second copy whose D skip is 0
# (the mixer's output all SSD): with the skip at 1 a deep layer's reset
# moved its bf16 output by only 0.014 of max |out|, under 2^-5; at 0, 0.051
# or more (the errors 0.0021-0.0082).  The all-SSD stack is not used for
# (a)-(c): over 81 mixers it carries rounding further (the serve policy's
# logits 1.42 apart, the f32 ones 0.0031, an f32 layer 0.0035).
ZAMBA2_SLOW_A = (0.01, 0.1)
ZAMBA2_SLOW_DT_BIAS = -2.0
ZAMBA2_LOGITS_BOUND = 0.5
ZAMBA2_F32_LOGITS_BOUND = 2e-3
ZAMBA2_LAYER_BOUND = RWKV_LAYER_BOUND
ZAMBA2_F32_LAYER_BOUND = 3e-3
# serve_nemotron (depth 2 of 96: 65.4 GB of f32 weights), kernel routes vs
# torch routes (|logits| <= 5.14): 0.038 on the H100, the control (fp8
# MLPs on the kernel routes) 0.335, which every run requires above gemma3's
# bound.
NEMOTRON_DEPTH = 2
NEMOTRON_LOGITS_BOUND = LOGITS_BOUND
# phases 25-27: dbrx-132b at depth DBRX_DEPTH of 40 (31 GB of f32 weights),
# starcoder2-15b whole (63.8 GB) and command-r-35b at depth COMMAND_R_DEPTH of
# 40 (28.1 GB), each at full width; prefill logits, kernel routes vs torch
# routes, at serve_moe's and gemma3's bounds, each with its control above
# (dbrx: one layer's experts rolled; starcoder2: every bias zeroed, the biases
# seeded at STARCODER2_BIAS_SCALE since init makes them zero; command-r: fp8
# MLPs on the kernel routes).
DBRX_DEPTH = 2
COMMAND_R_DEPTH = 4
STARCODER2_BIAS_SCALE = 0.1
# serve_whisper (whole, 0.79 B params): prefill logits on seeded random
# frames, kernel routes vs torch routes, and the encoder's hidden states
# (final-normed, 1500 x 1024) the same way, each at gemma3's bound; the
# reference with its encoder run causal is the control above both.
WHISPER_LOGITS_BOUND = LOGITS_BOUND
WHISPER_ENCODER_BOUND = LOGITS_BOUND
# serve_internvl2 (depth 8 of 80 at full width: 36 GB of f32 weights):
# prefill logits on seeded random image embeddings, kernel routes vs torch
# routes, at gemma3's bound; the reference with the image rows rolled by one
# position is the control above it.
INTERNVL2_DEPTH = 8
INTERNVL2_LOGITS_BOUND = LOGITS_BOUND
# train_whisper: whisper's decoder tokens per row against its 1500 frames
WHISPER_TRAIN_SEQ = 448


TRAIN_STEPS = 3
# phase 24 trains the mesh MESH_TRAIN_STEPS steps, then resumes it for
# MESH_RESUME_STEPS (every check of the phase is on step 0 or the resume's
# start)
MESH_TRAIN_STEPS = 2
# phases 17-20: the depth cuts (every width full) and the slow-decay copies'
# RWKV-6 decay bias (log decay -exp(-4) = -0.018 a step: a 64-step chunk
# keeps 0.31 of its input state, where the init's -0.7 keeps 1e-14)
TRAIN_RWKV_DEPTH = 4
TRAIN_ZAMBA2_PERIODS = 2
# internvl2 at depth 2 peaked at 80.06 GB on the H100 (AdamW's per-leaf
# temporaries over the two 128256 x 8192 tables), past ~75 GB: depth 1
TRAIN_INTERNVL2_DEPTH = 1
RWKV_SLOW_W0 = -4.0
# phase 21 (Fig. 8): matrix sizes, input ranges, the rungs on the cuda and
# torch routes, the factor each cuda rung is held to (its bound: the factor
# times the torch route's max-norm error for the rung on the same inputs),
# and the controls: for each rung, the rung it refines (one refinement
# dropped), whose error must land above the rung's bound.  refine_a has
# none: it refines A alone, so bf16 reads only ~1.3-1.5x its error
# (tests/test_torch_precision_error.py's readings on the torch route),
# inside the factor; the strict order refine_a < bf16 holds it.  A control
# is held where the torch route's own lower rung lands above the bound (so
# the bound can tell the two rungs apart); from N = 4096 the torch route's
# bf16x3 lies within twice its bf16x6 (both stand on SGEMM's accumulation),
# and there the strict order bf16x6 < refine_ab holds the top rung.  Each
# control must be held at one point at least; the order and the bounds at
# every point.
PRECISION_N = (1024, 4096, 8192)
PRECISION_RANGES = (1.0, 16.0)
PRECISION_RUNGS = ("bf16", "refine_a", "bf16x3", "refine_ab", "bf16x6", "f32", "fp8x3",
                   "int8x3")
PRECISION_ROUTE_FACTOR = 2.0
PRECISION_CONTROLS = {"bf16x3": "refine_a", "refine_ab": "refine_a", "bf16x6": "bf16x3",
                      "fp8x3": "fp8", "int8x3": "int8"}
# phase 22 (serve_stack): gemma3-1b behind the port's replica pool, at
# phase 4's slots (4 a replica) and context.  The sweep's workload (ids
# within the vocabulary, lengths lognormal, Poisson arrivals per tick), its
# rates (8 slots at ~32 tokens a request sustain ~0.25 a tick, so the last
# point must queue or reject), the fault plan of the chaos point (8-row bf16
# pages) and the gateway's streams.
STACK_SPEC = dict(n_requests=16, prompt_median=256, prompt_sigma=0.8, max_prompt=900,
                  out_median=32, out_sigma=0.5, max_out=96, seed=0)
STACK_RATES = (0.1, 0.2, 0.4)
STACK_MAX_QUEUE = 8
STACK_CHAOS = "7:crash@6,hang@14x4"
STACK_CHAOS_RATE = 0.2
STACK_KERNELS = ("gemm_tiled", "gemm_refined", "flash_attention", "flash_decode",
                 "flash_paged_decode")
# kernel -> (source under src/repro_torch/csrc, the TPU kernel it replaces)
KERNELS = {
    "gemm_tiled": ("gemm_tiled.cu", "src/repro/kernels/gemm_tiled.py:31"),
    "gemm_refined": ("gemm_refined.cu", "src/repro/kernels/gemm_refined.py:50"),
    "flash_attention": ("attention_fused.cu", "src/repro/kernels/attention_fused.py:167"),
    "flash_decode": ("attention_fused.cu", "src/repro/kernels/attention_fused.py:485"),
    "flash_attention_bwd_dq": ("attention_bwd.cu", "src/repro/kernels/attention_fused.py:272"),
    "flash_attention_bwd_dkv": ("attention_bwd.cu", "src/repro/kernels/attention_fused.py:302"),
    "flash_paged_decode": ("attention_paged.cu", "src/repro/kernels/attention_paged.py:44"),
    "gemm_lowp": ("gemm_lowp.cu", "src/repro/kernels/gemm_lowp.py:65"),
    "grouped_gemm": ("gemm_grouped.cu", "src/repro/kernels/gemm_grouped.py:131"),
    "grouped_gemm_dw": ("gemm_grouped_dw.cu", "src/repro/kernels/gemm_grouped.py:194"),
    "gemm_naive": ("gemm_naive.cu", "src/repro/kernels/gemm_naive.py:29"),
    "batched_gemm": ("batched_gemm.cu", "src/repro/kernels/batched_gemm.py:42"),
    "batched_gemm_naive": ("batched_gemm.cu", "src/repro/kernels/batched_gemm.py:105"),
    "wkv6": ("wkv6.cu", "src/repro/kernels/wkv6.py:37"),
}
SERVE_KERNELS = ("gemm_tiled", "gemm_refined", "flash_attention", "flash_decode")
PAGED_KERNELS = ("gemm_tiled", "gemm_refined", "flash_attention", "flash_paged_decode")
PAGED_INT8_KERNELS = PAGED_KERNELS + ("gemm_lowp",)
TRAIN_KERNELS = ("gemm_tiled", "gemm_refined", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
TRAIN_ONLY = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
SERVE_MOE_KERNELS = SERVE_KERNELS + ("grouped_gemm",)
SERVE_MOE_PAGED_KERNELS = PAGED_KERNELS + ("grouped_gemm",)
TRAIN_MOE_KERNELS = TRAIN_KERNELS + ("grouped_gemm", "grouped_gemm_dw")
MOE_SERVE_DEPTH, MOE_TRAIN_DEPTH = 4, 2
SERVE_NAIVE_KERNELS = ("gemm_naive", "flash_attention", "flash_decode")
BATCHED_KERNELS = ("batched_gemm", "batched_gemm_naive")
SERVE_RWKV_KERNELS = ("gemm_tiled", "gemm_refined")
TRAIN_RWKV_KERNELS = ("gemm_tiled", "gemm_refined")
PRECISION_KERNELS = ("gemm_tiled", "gemm_refined", "gemm_lowp")


# The kernels with two mainloops: their wrappers' per-mainloop counts
# (LAUNCHES_BY_LOOP dicts), filled in main() once the port is imported.
LOOP_COUNTS: dict[str, dict] = {}
# kernels whose bf16 launches on a path must all run the wgmma mainloop
SM90_ON_EVERY_PATH = ("flash_attention", "grouped_gemm_dw", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")
# The decode kernels' modules, whose SPLIT_LAUNCHES count the launches
# that ran their KV walk split over CTAs (every bf16 launch at B = 4);
# filled in main().
SPLIT_COUNTS: dict[str, object] = {}


def zero_launches(mods) -> None:
    """mods: the kernel modules by kernel name (a dict of counts for the
    module that holds several kernels); the per-mainloop counts too."""
    for name, mod in mods.items():
        if isinstance(mod.LAUNCHES, dict):
            mod.LAUNCHES[name] = 0
        else:
            mod.LAUNCHES = 0
    for counts in LOOP_COUNTS.values():
        for loop in counts:
            counts[loop] = 0
    for name, mod in SPLIT_COUNTS.items():
        if isinstance(mod.SPLIT_LAUNCHES, dict):
            mod.SPLIT_LAUNCHES[name] = 0
        else:
            mod.SPLIT_LAUNCHES = 0


def read_launches(mods) -> dict:
    """Launches by kernel, then by kernel and mainloop ("name.loop"), then
    the decode kernels' split launches ("name.split")."""
    out = {name: (mod.LAUNCHES[name] if isinstance(mod.LAUNCHES, dict) else mod.LAUNCHES)
           for name, mod in mods.items()}
    out.update({f"{name}.{loop}": n for name, counts in LOOP_COUNTS.items()
                for loop, n in counts.items()})
    out.update({f"{name}.split": (mod.SPLIT_LAUNCHES[name] if isinstance(mod.SPLIT_LAUNCHES, dict)
                                  else mod.SPLIT_LAUNCHES) for name, mod in SPLIT_COUNTS.items()})
    return out


def grouped_loops_ok(ls: dict, path: str) -> None:
    """A serve path's grouped calls: none on the WMMA tile, its decode calls
    (16-row tiles) on the split-K weight stream, its 64/128-row prefills on
    the wgmma mainloop."""
    by_loop = {loop: ls[f"grouped_gemm.{loop}"] for loop in LOOP_COUNTS["grouped_gemm"]}
    if by_loop["wmma"] or not by_loop["splitk"] or not by_loop["sm90"]:
        fail(f"{path}: grouped launches by mainloop {by_loop}: expected no wmma, splitk "
             f"(decode) and sm90 (prefill)")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.monotonic()


def emit(**obj) -> None:
    """One JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.monotonic() - _T0, 1)}), flush=True)


def split_chunks(fn, seq, size, *rest, **kw):
    """``fn`` (a chunked WKV or SSD scan) on each ``size``-step slice of the
    sequence tensors ``seq`` (B, S, ...) alone, ``rest`` and ``kw`` after
    them: the state reset at every chunk boundary, the faulty control of
    the recurrent paths.  Returns (outputs concatenated, the last state)."""
    import torch
    parts = [fn(*(t[:, c0:c0 + size] for t in seq), *rest, **kw)
             for c0 in range(0, seq[0].shape[1], size)]
    return torch.cat([o for o, _ in parts], 1), parts[-1][1]


def slow_decay(p: dict, **extra) -> dict:
    """A copy of a recurrent stack's params whose state decays slowly (the
    weights shared): RWKV-6's decay bias at RWKV_SLOW_W0, Mamba-2's A and
    dt_bias at ZAMBA2_SLOW_A / ZAMBA2_SLOW_DT_BIAS, ``extra`` replacing more
    of each Mamba-2 layer's fields."""
    import torch
    layers = []
    for lp in p["layers"]:
        if "w0" in lp:
            lp = {**lp, "w0": torch.full_like(lp["w0"], RWKV_SLOW_W0)}
        if "a_log" in lp:
            nh, dev = lp["a_log"].shape[0], lp["a_log"].device
            lp = {**lp, "a_log": torch.log(torch.linspace(*ZAMBA2_SLOW_A, nh, device=dev)),
                  "dt_bias": torch.full((nh,), ZAMBA2_SLOW_DT_BIAS, device=dev), **extra}
        layers.append(lp)
    return {**p, "layers": layers}


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


async def http_open(port: int, method: str, path: str, body=None):
    """A loopback HTTP/1.1 request to the gateway; returns (reader, writer)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(data)}"
                 f"\r\n\r\n".encode() + data)
    await writer.drain()
    return reader, writer


async def http_call(port: int, method: str, path: str, body=None) -> str:
    """The whole response (the gateway closes every connection)."""
    reader, writer = await http_open(port, method, path, body)
    try:
        return (await asyncio.wait_for(reader.read(-1), timeout=300)).decode()
    finally:
        writer.close()


async def next_line(reader) -> dict:
    """The next ndjson object of a chunked token stream."""
    while True:
        line = await asyncio.wait_for(reader.readline(), timeout=300)
        if not line:
            raise EOFError("the gateway closed the stream")
        if line.startswith(b"{"):
            return json.loads(line)


def prompt_lens(rng):
    """Phase 4's eight prompt lengths from ``rng`` (two past the 512
    window); serve_moe and the mesh phase reuse them."""
    lens = rng.integers(16, 701, size=8)
    lens[:2] = rng.integers(513, 701, size=2)     # two prompts past the 512 window
    return lens


def train_setup(cfg, dev, batch, seq):
    """Phase 7's kernel-route policy and ``TrainLoop`` (the mesh phase's
    one-device reference)."""
    from repro_torch.configs.base import execution_policy_for
    from repro_torch.core import ops
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import adamw
    tpolicy = execution_policy_for(
        cfg, default="bf16", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"},
        require={fam: ("vjp",) for fam in ops.families()})
    loop = TrainLoop(cfg, policy=tpolicy,
                     opt_cfg=adamw.AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS),
                     data_cfg=DataConfig(global_batch=batch, seq_len=seq,
                                         vocab_size=cfg.vocab_size),
                     remat=True, device=dev)
    return tpolicy, loop


def moe_setup(mcfg_full, lens):
    """serve_moe's Mixtral at a depth (full width), its kernel routes and
    policy, and its requests (``lens`` long, tokens from seed 1)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import Segment
    from repro_torch.core import ops
    from repro_torch.launch.serve import Request

    def mixtral(depth):
        return dataclasses.replace(mcfg_full, num_layers=depth,
                                   segments=(Segment(("attn_local", "moe"), depth),))

    moe_backends = {"gemm": "cuda", "attention": "cuda_fused", "grouped": "cuda_grouped"}
    mpolicy = ops.ExecutionPolicy(default="bf16", logits="refine_ab", backends=moe_backends,
                                  require={"attention": ("decode",)})
    mrng = np.random.default_rng(1)
    mreqs = [Request(rid=i, prompt=mrng.integers(2, mcfg_full.vocab_size, int(n))
                     .astype(np.int32), max_new_tokens=32) for i, n in enumerate(lens)]
    return mixtral, moe_backends, mpolicy, mreqs


def mesh_phase(dev, cfg, loop, tpolicy, train_peak_gb, train_step_s, mixtral, mpolicy,
               moe_backends, mreqs) -> dict:
    """24 mesh (see the module docstring): the one-device references
    first, then one world of MESH_RANKS ranks for (a), (b) and (c) in
    turn, then the resume world.  Returns the path's launches (the train
    run, the resume and the served requests), summed over every rank."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import api
    from repro_torch.runtime import mesh_checks, serve_step, world

    share = torch.cuda.device_count() < MESH_RANKS
    faults: list[str] = []
    total: dict[str, int] = {}
    parent_gb: list[dict] = []      # this process's device memory at each spawn

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    def spawn(n, jobs):
        gc.collect()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info(dev)
        parent_gb.append({"reserved_gb": round(torch.cuda.memory_reserved(dev) / 1e9, 3),
                          "card_free_gb": round(free / 1e9, 3)})
        t0 = time.monotonic()
        out = world.spawn(mesh_checks.jobs_worker, n, args=(jobs,), device="cuda",
                          share_card=share, timeout=MESH_TIMEOUT)
        return out, time.monotonic() - t0

    def share_of(r):
        return r["collective_s"] / r["wall_s"] if r["wall_s"] else None

    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        # one-device references: (a) every parity case on this card
        cases = mesh_checks.parity_cases("card")
        ref = {c["name"]: {k: v.float().cpu() for k, v in mesh_checks.run_case(c, dev).items()}
               for c in cases}
        # (b) phase 7's step 0 on its routes, params and batch
        torch.save(mesh_checks.step0_reference(loop, tpolicy), f"{tmp}/step0.pt")
        gc.collect()
        torch.cuda.empty_cache()
        # (c) Mixtral at depth MESH_SERVE_DEPTH on one device: tokens, prefill logits
        scfg = mixtral(MESH_SERVE_DEPTH)
        sparams = api.init_params(scfg, torch.Generator(device=dev).manual_seed(0), dev)
        eng = ServeEngine(scfg, batch_size=4, max_ctx=1024, policy=mpolicy, device=dev)
        eng.load(sparams)
        eng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
        sreqs = [Request(rid=i, prompt=r.prompt, max_new_tokens=32) for i, r in enumerate(mreqs)]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        eng.run(sreqs)
        torch.cuda.synchronize(dev)
        one_wall, one_peak = time.monotonic() - t0, torch.cuda.max_memory_allocated(dev) / 1e9
        prompt0 = {"tokens": torch.as_tensor(sreqs[0].prompt, device=dev)[None].long()}
        logits0, _ = serve_step.make_prefill(scfg, mpolicy, s_ctx=1024)(sparams, prompt0)
        torch.save(logits0.cpu(), f"{tmp}/logits0.pt")
        one_tokens = [r.out_tokens for r in sreqs]
        del eng, sparams, logits0

        tjob = dict(device="cuda", arch="gemma3-1b", mesh=MESH_TRAIN,
                    batch=loop.data_cfg.global_batch, seq=loop.data_cfg.seq_len,
                    run_to=MESH_TRAIN_STEPS,
                    schedule_steps=MESH_TRAIN_STEPS + MESH_RESUME_STEPS,
                    ckpt=f"{tmp}/ckpt", ref=f"{tmp}/step0.pt", controls=MESH_CONTROLS)
        sjob = dict(device="cuda", arch="mixtral-8x7b", depth=MESH_SERVE_DEPTH,
                    pattern=["attn_local", "moe"], mesh=MESH_SERVE, backends=moe_backends,
                    slots=4, max_ctx=1024, max_new=32,
                    prompts=[r.prompt.tolist() for r in sreqs], ref=f"{tmp}/logits0.pt")
        ranks, world_s = spawn(MESH_RANKS, [("parity", cases), ("train", tjob),
                                            ("serve", sjob)])
        rjob = dict(tjob, mesh="auto", run_to=MESH_TRAIN_STEPS + MESH_RESUME_STEPS, ref=None,
                    controls=())
        rranks, resume_s = spawn(MESH_RESUME_RANKS, [("train", rjob)])

    # (a) the parity matrix: every rank against one device
    pranks = [r["parity"] for r in ranks]
    rows = []
    for c in cases:
        held = [r["results"][c["name"]] for r in pranks if c["name"] in r["results"]]
        err = max((torch.from_numpy(held[0][k][1]) - ref[c["name"]][k]).abs().max().item()
                  for k in held[0])
        agree = all(len({h[k][0] for h in held}) == 1 for k in held[0])
        rows.append({"case": c["name"], "mesh": c["mesh"], "ranks": len(held),
                     "max_abs_err": err, "bit_equal": err == 0.0, "bound": c["expect"],
                     "ranks_agree": agree, "collective_s": pranks[0]["seconds"].get(c["name"])})
        if not (agree and mesh_checks.within(err, c["expect"])):
            faults.append(f"parity {c['name']}: err {err} (bound {c['expect']}), "
                          f"ranks agree {agree}")
    emit(phase="mesh_parity", ranks=MESH_RANKS, ranks_share_card=share,
         transport=pranks[0]["transport"], host_staged=host_staged(pranks[0]["transport"]),
         rows=rows, bit_equal=[r["case"] for r in rows if r["bit_equal"]],
         within_bound=[r["case"] for r in rows if not r["bit_equal"]],
         launches_by_rank=[{k: n for k, n in r["launches"].items() if n and "." not in k}
                           for r in pranks])

    # (b) gemma3-1b over dp=2,tp=2, step 0 against one device; the elastic resume
    tranks, rranks = [r["train"] for r in ranks], [r["train"] for r in rranks]
    s0, ctrl = tranks[0]["step0"], tranks[0]["controls"]
    if not (s0["finite"] and s0["token_loss_max_err"] <= STEP0_TOKEN_LOSS_BOUND
            and max(s0["grad_rel_err"].values()) <= STEP0_GRAD_BOUND):
        faults.append(f"train step 0 outside phase 7's bounds: {s0}")
    if not (s0["token_loss_max_err"] <= MESH_STEP0_TOKEN_LOSS_BOUND
            and max(s0["grad_rel_err"].values()) <= MESH_STEP0_GRAD_BOUND):
        faults.append(f"train step 0 outside the mesh bounds: {s0}")
    for name, c in ctrl.items():
        if not c["token_loss_max_err"] > MESH_STEP0_TOKEN_LOSS_BOUND:
            faults.append(f"control {name} lands within the mesh bound: {c}")
    rr = ctrl["rows_repeated"]
    if not rr["token_loss_max_err"] > STEP0_TOKEN_LOSS_BOUND:
        faults.append(f"control rows_repeated lands within phase 7's bound: {rr}")
    losses = [r["losses"] for r in tranks]
    if not (all(x == losses[0] for x in losses) and len(losses[0]) == MESH_TRAIN_STEPS
            and all(math.isfinite(x) for x in losses[0])):
        faults.append(f"train losses: {losses}")
    res = rranks[0]
    if not (res["mesh"] == "dp=2,tp=1,ep=1" and res["start"] == MESH_TRAIN_STEPS
            and len(res["losses"]) == MESH_RESUME_STEPS
            and all(math.isfinite(x) for x in res["losses"])
            and all(r["losses"] == res["losses"] for r in rranks)):
        faults.append(f"elastic resume: {[(r['mesh'], r['start'], r['losses']) for r in rranks]}")
    emit(phase="mesh_train", arch=cfg.name, mesh=tranks[0]["mesh"], ranks=MESH_RANKS,
         ranks_share_card=share, transport=tranks[0]["transport"],
         host_staged=host_staged(tranks[0]["transport"]), step0=s0, controls=ctrl,
         token_loss_bound=STEP0_TOKEN_LOSS_BOUND, grad_bound=STEP0_GRAD_BOUND,
         mesh_token_loss_bound=MESH_STEP0_TOKEN_LOSS_BOUND,
         mesh_grad_bound=MESH_STEP0_GRAD_BOUND, losses=losses[0],
         step_s_by_rank=[r["step_s"] for r in tranks],
         median_step_s=sorted(tranks[0]["step_s"])[len(tranks[0]["step_s"]) // 2],
         one_device_median_step_s=train_step_s,
         peak_mem_gb_by_rank=[r["peak_mem_gb"] for r in tranks],
         one_device_peak_mem_gb=train_peak_gb,
         collective_share_by_rank=[share_of(r) for r in tranks],
         collective_calls=tranks[0]["collective_calls"], collective_gb=tranks[0]["collective_gb"],
         step0_forward_s=tranks[0].get("step0_forward_s"), checks_s=tranks[0].get("checks_s"),
         train_wall_s=tranks[0]["wall_s"],
         check_launches_by_rank=[{k: n for k, n in r["check_launches"].items()
                                  if n and "." not in k} for r in tranks],
         resume={"mesh": res["mesh"], "ranks": MESH_RESUME_RANKS, "start": res["start"],
                 "losses": res["losses"], "step_s": res["step_s"],
                 "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in rranks],
                 "collective_share_by_rank": [share_of(r) for r in rranks],
                 "world_s": resume_s})

    # (c) Mixtral at full width, depth MESH_SERVE_DEPTH, served at ep=2,tp=2
    sranks = [r["serve"] for r in ranks]
    sv = sranks[0]
    same = [r["tokens"] == one_tokens for r in sranks]
    if not (all(same) and sv["done"] and sv["logits_finite"]
            and sv["logits_max_err"] <= MOE_LOGITS_BOUND):
        faults.append(f"serve at {MESH_SERVE}: tokens equal by rank {same}, logits err "
                      f"{sv['logits_max_err']}")
    emit(phase="mesh_serve", arch=scfg.name, depth=MESH_SERVE_DEPTH, mesh=MESH_SERVE,
         ranks=MESH_RANKS, ranks_share_card=share, transport=sv["transport"],
         host_staged=host_staged(sv["transport"]), requests=len(sreqs),
         tokens_equal_by_rank=same, logits_max_err=sv["logits_max_err"],
         logits_bound=MOE_LOGITS_BOUND, wall_s=sv["wall_s"], one_device_wall_s=one_wall,
         tok_per_s=sv["tok_per_s"], peak_mem_gb_by_rank=[r["peak_mem_gb"] for r in sranks],
         one_device_peak_mem_gb=one_peak,
         collective_share_by_rank=[share_of(r) for r in sranks],
         collective_calls=sv["collective_calls"])

    # the path: the train run, its elastic resume and the served requests
    # on every rank; the parity matrix's and the step-0 checks' launches
    # are on the mesh_parity and mesh_train lines
    for r in ranks:
        add(r["train"]["launches"])
        add(r["serve"]["launches"])
    for r in rranks:
        add(r["launches"])
    missing = [k for k in MESH_KERNELS if not total.get(k)]
    emit(phase="mesh", launches={k: n for k, n in total.items() if n and "." not in k},
         world_s=world_s, resume_world_s=resume_s, missing=missing, faults=faults,
         parent_at_spawns=parent_gb)
    if missing:
        faults.append(f"a kernel of the path never launched on the ranks: {missing}")
    if faults:
        fail("mesh: " + "; ".join(faults))
    return total


def host_staged(transport: str) -> str:
    """Which of the phase's collectives went through host memory."""
    if transport.startswith("gloo"):
        return ("all of them: gloo stages every CUDA all-reduce and all-gather through host "
                "memory itself; core.ops.shard stages none of its own")
    return "none"


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")

    from repro_torch.configs import get_config
    from repro_torch.core import error as error_mod
    from repro_torch.core import ops
    from repro_torch.core.precision import num_passes
    from repro_torch.kernels import _build
    from repro_torch.core.ops import paged
    from repro_torch.core.ops.registry import LADDER_BOUNDS
    from repro_torch.kernels import attention_fused as af
    from repro_torch.kernels import attention_paged as ap
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import gemm_grouped as gg
    from repro_torch.kernels import gemm_lowp as gl
    from repro_torch.kernels import gemm_naive as gn
    from repro_torch.kernels import gemm_refined as gr
    from repro_torch.kernels import gemm_tiled as gt
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.configs.base import Segment, execution_policy_for, layer_kinds
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import adamw
    from repro_torch.models import api, transformer
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime import serve_step
    from repro_torch.runtime.device import resolve_device
    from repro_torch.launch.serve import RecoveryMismatch
    from repro_torch.serve import loadgen
    from repro_torch.serve.autoscale import Autoscaler, AutoscalePolicy
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.metrics import MetricsRegistry
    from repro_torch.serve.pool import ReplicaPool

    mods = {"gemm_tiled": gt, "gemm_refined": gr, **{k: af for k in af.LAUNCHES},
            "flash_paged_decode": ap, "gemm_lowp": gl, **{k: gg for k in gg.LAUNCHES},
            "gemm_naive": gn, **{k: bg for k in bg.LAUNCHES}, "wkv6": wk}
    LOOP_COUNTS.update({"gemm_tiled": gt.LAUNCHES_BY_LOOP, "gemm_refined": gr.LAUNCHES_BY_LOOP,
                        "gemm_lowp": gl.LAUNCHES_BY_LOOP,
                        "grouped_gemm": gg.LAUNCHES_BY_LOOP,
                        "flash_attention": af.LAUNCHES_BY_LOOP,
                        "grouped_gemm_dw": gg.LAUNCHES_BY_LOOP_DW,
                        "flash_attention_bwd_dq": af.LAUNCHES_BY_LOOP_DQ,
                        "flash_attention_bwd_dkv": af.LAUNCHES_BY_LOOP_DKV})
    SPLIT_COUNTS.update({"flash_decode": af, "flash_paged_decode": ap})

    # ------------------------------------------------------------ 1 device
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(dev.index)],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(dev)
    emit(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ------------------------------------------------------------- 2 build
    t0 = time.monotonic()
    built = _build.build_all()
    build_s = time.monotonic() - t0
    log = _build.BUILD_DIR / "nvcc.log"
    log.write_text("\n".join(f"=== {k}\n{v['log']}" for k, v in built.items()))
    emit(phase="build", seconds=round(build_s, 3),
         sources={k: {"cached": v["cached"], "seconds": round(v["seconds"], 1)}
                  for k, v in built.items()},
         log=str(log.relative_to(ROOT)))

    # ------------------------------------------------------------- 3 check
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, scale=1.0, dtype=torch.float32, generator=None):
        return (scale * torch.randn(shape, generator=generator or gen, device=dev)).to(dtype)

    def timed(fn) -> float:
        """ms per call: warm up, then CUDA events around enough calls,
        queued behind a spin on the device (``torch.cuda._sleep``: 1 ms
        more than 1.5x the host's time to enqueue them, at most 50 ms) so
        that the host has enqueued them before the first starts: the events
        time the calls' kernels back to back, not the host's launches."""
        fn()
        torch.cuda.synchronize(dev)
        t = time.monotonic()
        fn()
        host_s = time.monotonic() - t
        torch.cuda.synchronize(dev)
        iters = int(min(50, max(3, 0.1 / max(time.monotonic() - t, 1e-6))))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        spin_s = min(0.05, 1.5 * iters * host_s + 1e-3)
        torch.cuda._sleep(int(spin_s * 2e9))   # cycles, at a clock of at most 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters

    def in_turns(plain, kernel) -> tuple[float, float]:
        p1, k1, k2, p2 = timed(plain), timed(kernel), timed(kernel), timed(plain)
        return (k1 + k2) / 2, (p1 + p2) / 2

    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa_backend(q, k, v, **kw) -> str:
        """The backend SDPA's own dispatch picks for these inputs."""
        return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name

    def sdpa_math(q, k, v, **kw):
        """SDPA on its math backend (its matmuls keep TF32 off)."""
        with sdpa_kernel(SDPBackend.MATH):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)

    # A window's host clock against the CUDA kernels' own time
    # (torch.profiler, summed by name; one stream, so they do not overlap).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_window(fn) -> dict:
        torch.cuda.synchronize(dev)
        t = time.monotonic()
        fn()
        torch.cuda.synchronize(dev)
        plain_wall = time.monotonic() - t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        per_kernel: dict[str, float] = {}
        for e in prof.key_averages():
            # device-side kernel events only: a PyTorch op's CPU event and
            # an autograd.Function's annotation range carry the time of
            # the kernels they launched as well
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            us = e.self_device_time_total
            if us > 0:
                per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
        device_ms = sum(per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        return {"wall_ms": plain_wall * 1e3, "device_ms": device_ms,
                "idle_share": 1.0 - device_ms / (plain_wall * 1e3),
                "top_kernels_ms": [[name[:90], ms] for name, ms in top]}

    checks: dict[str, list[dict]] = {name: [] for name in KERNELS}

    def refined_flops(a, b, m, n, k, policy="refine_ab") -> float:
        """A refined GEMM's tensor-core work: 2mnk for each term the kernel
        multiplies (``gemm_refined.kept_terms``).  A bf16 operand's lo term
        is identically zero and not multiplied, so refine_ab on a bf16 A
        (the decode unembeds, dTable, the forward) counts 2 passes, not 4:
        the bound is the work the kernel must do, and no row reads above it."""
        kept = gr.kept_terms(policy, a.dtype == torch.bfloat16, b.dtype == torch.bfloat16)
        return len(kept) * 2 * m * n * k

    def refined_extra(m, n, k) -> dict:
        """The split count the host picks for a refined row."""
        return {"splits": gr.refined_splits(1, m, n, k, gt.sm_count(dev.index))}

    def max_err(outs, refs) -> float:
        return max((o - r).abs().max().item() for o, r in zip(outs, refs))

    loop_rows: list[dict] = []

    def check(name, what, kernel, plain, library, err_bound, flops, nbytes, control=None,
              peak=PEAK_BF16_FLOPS, library_call=None, extra=None, loop=None,
              rung_control=None):
        """``control``: a plain version with a deliberate fault, which
        must land outside ``err_bound`` of the kernel; ``rung_control``:
        the plain version at a wrong rung (one pass for an x3 rung), which
        must land outside it as well.  A kernel may
        return a tuple of tensors; the error is the largest over them.
        ``extra``: more fields for the row.  ``loop``: the mainloop the
        kernel's first call must run (``sm90``: wgmma; ``wmma``; ``splitk``:
        gemm_tiled's weight stream at M <= 16); the row records which ran."""
        loops0 = read_launches({})
        out = kernel()
        loops1 = read_launches({})
        ran = sorted({k.split(".")[1] for k in loops1
                      if k.split(".")[1] in gt.MAINLOOPS and loops1[k] > loops0[k]})
        if name in LOOP_COUNTS:
            loop_rows.append({"kernel": name, "what": what, "mainloop": ran})
            if loop is not None and ran != [loop]:
                fail(f"{name} {what}: ran the {ran} mainloop, expected {loop}")
            extra = {**(extra or {}), "mainloop": ran}
        ref = plain()
        torch.cuda.synchronize(dev)
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(out, ref):
            if o.shape != r.shape or not torch.isfinite(o).all():
                fail(f"{name} {what}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
        err = max_err(out, ref)
        ref_rms = [r.float().square().mean().sqrt().item() for r in ref]
        control_err = rung_err = None
        if control:
            c = control()
            control_err = max_err(out, c if isinstance(c, tuple) else (c,))
        if rung_control:
            c = rung_control()
            rung_err = max_err(out, c if isinstance(c, tuple) else (c,))
        del out, ref
        ms, plain_ms = in_turns(plain, kernel)
        lib_ms = timed(library) if library is not None else None
        b_ms, b_by = bound(flops, nbytes, peak)
        # device_ms: the kernels' own time per call as the profiler sees it
        # (over n calls; null where it caught no kernel), beside ms; host_ms:
        # the host's time to enqueue one call, which bounds a serve tick
        # where it exceeds the kernel's
        n = max(1, min(20, int(2.0 / max(ms, 1e-3))))
        device_ms = profile_window(lambda: [kernel() for _ in range(n)])["device_ms"] / n or None
        torch.cuda.synchronize(dev)
        t = time.monotonic()
        for _ in range(n):
            kernel()
        host_ms = (time.monotonic() - t) * 1e3 / n
        torch.cuda.synchronize(dev)
        row = dict(what=what, max_abs_err=err, err_bound=err_bound, ref_rms=ref_rms, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   device_ms=device_ms, host_ms=host_ms)
        if library_call:
            row["library_call"] = library_call
        if extra:
            row.update(extra)
        if control:
            row["control_err"] = control_err
        if rung_control:
            row["rung_control_err"] = rung_err
        emit(phase="check", kernel=name, **row)
        if not err <= err_bound:
            fail(f"{name} {what}: max |kernel - plain| {err} > {err_bound}")
        if control and not control_err > err_bound:
            fail(f"{name} {what}: the faulty control is within the bound ({control_err})")
        if rung_control and not rung_err > err_bound:
            fail(f"{name} {what}: the wrong-rung control is within the bound ({rung_err})")
        checks[name].append(row)

    cfg = get_config("gemma3-1b")
    d, ff, vocab, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.head_dim
    heads, kvh, grp = cfg.num_heads, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads

    # gemm_tiled at the prefill MLP: (700 x 1152) bf16 activations x (1152 x 6912) f32
    m = 700
    x = randn((m, d), dtype=torch.bfloat16)
    w = randn((d, ff), d ** -0.5)
    w16 = w.to(torch.bfloat16)
    check("gemm_tiled", f"prefill mlp {m}x{d}x{ff}", lambda: gt.gemm_tiled(x, w),
          lambda: gt.gemm_tiled_plain(x, w), lambda: torch.matmul(x, w16), GEMM_BOUND,
          2 * m * d * ff, x.numel() * 2 + w.numel() * 4 + m * ff * 4, loop="sm90")
    del w, w16

    # gemm_tiled at the decode linears (M = 4 slots): the MLP's up and down
    # projections, bf16 activations x f32 weights
    x4 = randn((4, d), dtype=torch.bfloat16)
    h4 = randn((4, ff), dtype=torch.bfloat16)
    for a4, kk, nn in ((x4, d, ff), (h4, ff, d)):
        w = randn((kk, nn), kk ** -0.5)
        w16 = w.to(torch.bfloat16)
        check("gemm_tiled", f"decode mlp 4x{kk}x{nn}",
              lambda a4=a4, w=w: gt.gemm_tiled(a4, w),
              lambda a4=a4, w=w: gt.gemm_tiled_plain(a4, w),
              lambda a4=a4, w16=w16: torch.matmul(a4, w16), GEMM_BOUND,
              2 * 4 * kk * nn, a4.numel() * 2 + w.numel() * 4 + 4 * nn * 4, loop="splitk")
    del w, w16

    # the decode unembed: (4 x 1152) bf16 against the (262144 x 1152) f32 table, NT
    xb = randn((4, d), dtype=torch.bfloat16)
    table = randn((vocab, d), d ** -0.5)
    table16 = table.to(torch.bfloat16)
    unembed_bytes = xb.numel() * 2 + table.numel() * 4 + 4 * vocab * 4
    check("gemm_tiled", f"decode unembed 4x{d}x{vocab} NT", lambda: gt.gemm_tiled(xb, table.t()),
          lambda: gt.gemm_tiled_plain(xb, table.t()), lambda: torch.matmul(xb, table16.t()),
          GEMM_BOUND, 2 * 4 * d * vocab, unembed_bytes, loop="splitk")
    # library: one f32 SGEMM (TF32 is off), the function refine_ab approximates
    check("gemm_refined", f"decode unembed refine_ab 4x{d}x{vocab} NT",
          lambda: gr.gemm_refined(xb, table.t(), policy="refine_ab"),
          lambda: gr.gemm_refined_plain(xb, table.t(), "refine_ab"),
          lambda: torch.matmul(xb.float(), table.t()), GEMM_BOUND,
          refined_flops(xb, table, 4, vocab, d), unembed_bytes, loop="splitk",
          extra=refined_extra(4, vocab, d))
    del table, table16
    # rwkv6-7b's decode unembed: (4 x 4096) bf16 against its (65536 x 4096) f32 table, NT
    rcfg0 = get_config("rwkv6-7b")
    r_d, r_vocab = rcfg0.d_model, rcfg0.vocab_size
    xr = randn((4, r_d), dtype=torch.bfloat16)
    table = randn((r_vocab, r_d), r_d ** -0.5)
    check("gemm_refined", f"rwkv6 decode unembed refine_ab 4x{r_d}x{r_vocab} NT",
          lambda: gr.gemm_refined(xr, table.t(), policy="refine_ab"),
          lambda: gr.gemm_refined_plain(xr, table.t(), "refine_ab"),
          lambda: torch.matmul(xr.float(), table.t()), GEMM_BOUND,
          refined_flops(xr, table, 4, r_vocab, r_d),
          xr.numel() * 2 + table.numel() * 4 + 4 * r_vocab * 4, loop="splitk",
          extra=refined_extra(4, r_vocab, r_d))
    del table, xr

    # flash forward: prefill of 700 tokens, 4 heads on 1 kv head, hd 256, bf16
    s = 700
    q = randn((1, s, kvh, grp, hd), hd ** -0.5, torch.bfloat16)
    k, v = randn((1, s, kvh, hd), dtype=torch.bfloat16), randn((1, s, kvh, hd), dtype=torch.bfloat16)
    qh = q.reshape(1, s, heads, hd).transpose(1, 2)
    kh, vh = k.transpose(1, 2).expand(1, heads, s, hd), v.transpose(1, 2).expand(1, heads, s, hd)
    for window in (None, cfg.window):
        rows = torch.arange(s, device=dev)
        keep = rows[None, :] <= rows[:, None]
        if window is not None:
            keep &= rows[None, :] > rows[:, None] - window
        pairs = int(keep.sum())
        sdpa = lambda keep=keep: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=keep, scale=1.0)
        check("flash_attention", f"prefill S={s} H={heads} Kv={kvh} hd={hd} "
              + ("causal" if window is None else f"window {window}"),
              lambda w=window: af.flash_attention(q, k, v, causal=True, window=w),
              lambda w=window: af.flash_attention_plain(q, k, v, causal=True, window=w)[0],
              sdpa, ATTN_BOUND, 4 * pairs * hd * heads,
              (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4,
              control=None if window is None else (
                  lambda w=window: af.flash_attention_plain(q, k, v, causal=True,
                                                            window=w - 1)[0]),
              loop="sm90")
    # one carried rung through the forward: bf16x6 (the 3-way split, six
    # passes from f32 tiles) against its plain version, its distance to the
    # torch route's bf16x6 recorded and held to the rung's ladder bound (the
    # route on f32 copies of the bf16 inputs: on bf16 inputs it returns bf16)
    torch_x6 = ops.attention_forward(q.float(), k.float(), v.float(), causal=True,
                                     window=cfg.window, policy=ops.Route("bf16x6"))
    # yardstick: SDPA's forward in f32 (the function bf16x6 stands for) on
    # f32 copies, its math backend
    qh32, kh32, vh32 = qh.float(), kh.float(), vh.float()
    check("flash_attention", f"prefill S={s} H={heads} Kv={kvh} hd={hd} window {cfg.window} "
          f"bf16x6", lambda: af.flash_attention(q, k, v, causal=True, window=cfg.window,
                                                precision="bf16x6"),
          lambda: af.flash_attention_plain(q, k, v, causal=True, window=cfg.window,
                                           precision="bf16x6")[0],
          lambda: sdpa_math(qh32, kh32, vh32, attn_mask=keep, scale=1.0),
          ATTN_BOUND, num_passes("bf16x6") * 4 * pairs * hd * heads,
          (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4, loop="wmma",
          library_call="scaled_dot_product_attention on f32 copies, math backend (TF32 off)",
          extra={"torch_route_err": max_err(
              (af.flash_attention(q, k, v, causal=True, window=cfg.window, precision="bf16x6"),),
              (torch_x6,))})
    if not checks["flash_attention"][-1]["torch_route_err"] <= LADDER_BOUNDS["bf16x6"]:
        fail("flash_attention bf16x6: farther from the torch route than the rung's bound")
    del torch_x6, qh32, kh32, vh32

    # flash decode: 4 rows, a 512-slot ring (local layers) and a 1024-row
    # linear cache (global layers), positions below and above the window;
    # each bf16 row records the KV splits the host picked for it, and the
    # linear cache is read once more at the first positions [0, 5, 31, 32]
    # (one or two live tiles: most splits walk none)
    sms = gt.sm_count(dev.index)
    pos = torch.tensor([40, 300, 611, 1000], dtype=torch.int32, device=dev)
    pos_early = torch.tensor([0, 5, 31, 32], dtype=torch.int32, device=dev)
    qd = randn((4, 1, kvh, grp, hd), hd ** -0.5, torch.bfloat16)
    for s_cache, window in ((cfg.window, cfg.window), (1024, None)):
        kc = randn((4, s_cache, kvh, hd), dtype=torch.bfloat16)
        vc = randn((4, s_cache, kvh, hd), dtype=torch.bfloat16)
        col = torch.arange(s_cache, device=dev)[None, :]
        p64 = pos.long()[:, None]
        live = (p64 - torch.remainder(p64 - col, s_cache) >= 0) if window else (col <= p64)
        n_live = int(live.sum())
        dmask = live[:, None, None, :].expand(4, heads, 1, s_cache)
        sdpa_d = lambda kc=kc, vc=vc, dmask=dmask: (  # noqa: E731
            torch.nn.functional.scaled_dot_product_attention(
                qd.reshape(4, 1, heads, hd).transpose(1, 2),
                kc.transpose(1, 2).expand(4, heads, s_cache, hd),
                vc.transpose(1, 2).expand(4, heads, s_cache, hd),
                attn_mask=dmask, scale=1.0))
        splits = {"splits": af.decode_splits(4, kvh, s_cache, sms)}
        check("flash_decode", f"decode B=4 {'ring' if window else 'linear'} {s_cache}",
              lambda kc=kc, vc=vc, w=window: af.flash_decode(qd, kc, vc, pos, window=w),
              lambda kc=kc, vc=vc, w=window: af.flash_decode_plain(qd, kc, vc, pos, window=w),
              sdpa_d, ATTN_BOUND, 4 * n_live * grp * hd * kvh,
              qd.numel() * 2 + 2 * n_live * kvh * hd * 2 + qd.numel() * 4, extra=splits)
        if window is None:   # the first positions
            live_e = col <= pos_early.long()[:, None]
            n_early = int(live_e.sum())
            dmask_e = live_e[:, None, None, :].expand(4, heads, 1, s_cache)
            check("flash_decode", f"decode B=4 linear {s_cache} pos [0, 5, 31, 32]",
                  lambda kc=kc, vc=vc: af.flash_decode(qd, kc, vc, pos_early),
                  lambda kc=kc, vc=vc: af.flash_decode_plain(qd, kc, vc, pos_early),
                  lambda kc=kc, vc=vc: torch.nn.functional.scaled_dot_product_attention(
                      qd.reshape(4, 1, heads, hd).transpose(1, 2),
                      kc.transpose(1, 2).expand(4, heads, s_cache, hd),
                      vc.transpose(1, 2).expand(4, heads, s_cache, hd),
                      attn_mask=dmask_e, scale=1.0),
                  ATTN_BOUND, 4 * n_early * grp * hd * kvh,
                  qd.numel() * 2 + 2 * n_early * kvh * hd * 2 + qd.numel() * 4,
                  control=lambda kc=kc, vc=vc: af.flash_decode_plain(
                      qd, kc, vc, torch.clamp(pos_early - 1, min=0)),
                  extra=splits)
        if window is None:   # one quantized rung: int8x3, scales per tile
            check("flash_decode", f"decode B=4 linear {s_cache} int8x3",
                  lambda kc=kc, vc=vc: af.flash_decode(qd, kc, vc, pos, precision="int8x3"),
                  lambda kc=kc, vc=vc: af.flash_decode_plain(qd, kc, vc, pos,
                                                             precision="int8x3"),
                  sdpa_d, QUANT_ATTN_BOUND, num_passes("int8x3") * 4 * n_live * grp * hd * kvh,
                  qd.numel() * 2 + 2 * n_live * kvh * hd * 2 + qd.numel() * 4,
                  control=lambda kc=kc, vc=vc: af.flash_decode_plain(qd, kc, vc, pos - 1,
                                                                     precision="int8x3"),
                  rung_control=lambda kc=kc, vc=vc: af.flash_decode_plain(qd, kc, vc, pos,
                                                                          precision="int8"),
                  extra={"splits": af.decode_splits(4, kvh, s_cache, sms, "int8x3")})
    del q, k, v, qh, kh, vh, kc, vc

    # paged decode at the same rows and positions: 8-row pages behind a
    # shuffled page table, logical pages past a row's history on the trash
    # page (as the engine allocates them), bf16 pages and int8 pages with
    # per-row scales.  Yardstick: SDPA on the cache gathered dense
    # beforehand (the gather is not timed).  Control: the plain version
    # one key short (each row's newest key dropped, pos - 1; it moves the
    # rows whose ring has not wrapped and every linear row).
    ps = 8
    for s_cache, window in ((cfg.window, cfg.window), (1024, None)):
        n_log = paged.num_logical_pages(s_cache, ps)
        table = (1 + torch.randperm(4 * n_log, generator=gen, device=dev)).reshape(4, n_log)
        hist = torch.clamp(pos.long(), max=s_cache - 1)[:, None]
        table = torch.where(torch.arange(n_log, device=dev)[None, :] * ps <= hist, table,
                            torch.zeros_like(table)).to(torch.int32)
        n_pages = int((table > 0).sum())
        col = torch.arange(s_cache, device=dev)[None, :]
        p64 = pos.long()[:, None]
        live = (p64 - torch.remainder(p64 - col, s_cache) >= 0) if window else (col <= p64)
        n_live = int(live.sum())
        dmask = live[:, None, None, :].expand(4, heads, 1, s_cache)
        for quant in (None, "int8"):
            cache = paged.init_paged(4, s_cache, kvh, hd, page_size=ps,
                                     num_pages=1 + 4 * n_log, quant=quant, device=dev)
            cache.page_table = table
            rows_k = randn((1 + 4 * n_log, ps, kvh, hd))
            rows_v = randn((1 + 4 * n_log, ps, kvh, hd))
            if quant:
                cache.k_pages, cache.k_scale = paged.quantize_rows(rows_k)
                cache.v_pages, cache.v_scale = paged.quantize_rows(rows_v)
            else:
                cache.k_pages, cache.v_pages = rows_k.to(torch.bfloat16), rows_v.to(torch.bfloat16)
            del rows_k, rows_v
            kd, vd = (x.to(torch.bfloat16) for x in paged.gather_dense(cache))
            sdpa_p = lambda kd=kd, vd=vd, dmask=dmask, n=s_cache: (  # noqa: E731
                torch.nn.functional.scaled_dot_product_attention(
                    qd.reshape(4, 1, heads, hd).transpose(1, 2),
                    kd.transpose(1, 2).expand(4, heads, n, hd),
                    vd.transpose(1, 2).expand(4, heads, n, hd), attn_mask=dmask, scale=1.0))
            row_bytes = kvh * hd * (1 if quant else 2) + (kvh * 4 if quant else 0)
            check("flash_paged_decode",
                  f"paged decode B=4 {'ring' if window else 'linear'} {s_cache} page {ps} "
                  f"{quant or 'bf16'} pages",
                  lambda c=cache, w=window: ap.flash_paged_decode(qd, c, pos, window=w),
                  lambda c=cache, w=window: ap.flash_paged_decode_plain(qd, c, pos, window=w),
                  sdpa_p, ATTN_BOUND, 4 * n_live * grp * hd * kvh,
                  qd.numel() * 2 + 2 * n_live * row_bytes + n_pages * 4 + qd.numel() * 4,
                  control=lambda c=cache, w=window: ap.flash_paged_decode_plain(
                      qd, c, pos - 1, window=w),
                  library_call="scaled_dot_product_attention on the cache gathered dense "
                               "(bf16), gather not timed",
                  extra={"splits": af.decode_splits(4, kvh, s_cache, sms)})
            if quant is None and window:   # one quantized rung: fp8x3, scales per tile
                check("flash_paged_decode", f"paged decode B=4 ring {s_cache} page {ps} "
                      f"bf16 pages fp8x3",
                      lambda c=cache: ap.flash_paged_decode(qd, c, pos, window=window,
                                                            precision="fp8x3"),
                      lambda c=cache: ap.flash_paged_decode_plain(qd, c, pos, window=window,
                                                                  precision="fp8x3"),
                      sdpa_p, QUANT_ATTN_BOUND,
                      num_passes("fp8x3") * 4 * n_live * grp * hd * kvh,
                      qd.numel() * 2 + 2 * n_live * row_bytes + n_pages * 4 + qd.numel() * 4,
                      control=lambda c=cache: ap.flash_paged_decode_plain(
                          qd, c, pos // 2, window=window, precision="fp8x3"),
                      rung_control=lambda c=cache: ap.flash_paged_decode_plain(
                          qd, c, pos, window=window, precision="fp8"),
                      extra={"splits": af.decode_splits(4, kvh, s_cache, sms, "fp8x3")})
            del cache, kd, vd
    del qd

    # the quantized GEMM at the MLP's up projection, decode (M = 4 slots)
    # and prefill (700 tokens), and its decode down projection: bf16
    # activations x f32 weights, fp8x3 and int8x3, on repro's grid
    # (TileConfig(256, 256, 256) clamped).  M <= 16 runs the fused decode
    # kernel (splitk), above the quantize pass and the wgmma mainloop
    # (sm90).  No PyTorch call computes per-tile scales: the yardstick is
    # one torch._scaled_mm pass on e4m3 copies with tensor-wise scales (M
    # padded to 16 rows, which it requires; the casts are not timed).
    # Control: the plain version on a grid of bk = 128.  The prefill rows
    # also record each of the call's kernels' own time (the quantize pass
    # and the mainloop, profiler).
    for m, kk, nn in ((4, d, ff), (700, d, ff), (4, ff, d)):
        x = randn((m, kk), dtype=torch.bfloat16)
        w = randn((kk, nn), kk ** -0.5)
        t = ops.tile_for("cuda", m, nn, kk).clamp(m, nn, kk)
        m16 = -(-m // 16) * 16
        x8 = torch.nn.functional.pad(x.float(), (0, 0, 0, m16 - m)).to(torch.float8_e4m3fn)
        w8 = w.t().contiguous().to(torch.float8_e4m3fn).t()
        one = torch.ones((), device=dev)
        scaled_mm = lambda x8=x8, w8=w8, one=one: torch._scaled_mm(  # noqa: E731
            x8, w8, scale_a=one, scale_b=one, out_dtype=torch.bfloat16)
        for rung in ("fp8x3", "int8x3"):
            call = (lambda x=x, w=w, t=t, r=rung: gl.gemm_lowp(x, w, policy=r, bm=t.bm, bn=t.bn,
                                                                bk=t.bk))
            extra = None
            if m > 16:
                prof = profile_window(lambda call=call: [call() for _ in range(10)])
                extra = {"kernels_ms": [[name, ms / 10] for name, ms in prof["top_kernels_ms"]]}
            what = ("decode mlp" if kk == d else "decode mlp down") if m == 4 else "prefill mlp"
            check("gemm_lowp", f"{what} {rung} {m}x{kk}x{nn} grid {t.bm}x{t.bn}x{t.bk}", call,
                  lambda x=x, w=w, t=t, r=rung: gl.gemm_lowp_plain(x, w, r, t.bm, t.bn, t.bk),
                  scaled_mm, LOWP_BOUND, num_passes(rung) * 2 * m * kk * nn,
                  x.numel() * 2 + w.numel() * 4 + m * nn * 4,
                  control=lambda x=x, w=w, t=t, r=rung: gl.gemm_lowp_plain(x, w, r, t.bm,
                                                                           t.bn, 128),
                  peak=PEAK_LOWP_OPS,
                  library_call="torch._scaled_mm, one e4m3 pass, tensor-wise scales, "
                               "M padded to 16",
                  loop="splitk" if m <= 16 else "sm90", extra=extra)
        del x, w, x8, w8

    # flash backward at the train shapes: B=2, S=1024, 4 heads on 1 kv
    # head, hd 256, bf16 inputs, on the forward kernel's own out and lse.
    # Yardstick: SDPA's backward with the same mask through autograd; for
    # the causal rows also with is_causal=True (a boolean mask keeps SDPA
    # off its flash backend).  Each row names the backends that ran.
    bt, st = 2, 1024
    q = randn((bt, st, kvh, grp, hd), hd ** -0.5, torch.bfloat16)
    k, v = randn((bt, st, kvh, hd), dtype=torch.bfloat16), randn((bt, st, kvh, hd), dtype=torch.bfloat16)
    do = randn((bt, st, kvh, grp, hd), 1e-2)
    rows = torch.arange(st, device=dev)
    for window in (cfg.window, None):
        kw = dict(causal=True, window=window)
        out, lse = af.flash_attention_fwd(q, k, v, **kw)
        di = af.bwd_delta(out, do)
        keep = rows[None, :] <= rows[:, None]
        if window is not None:
            keep &= rows[None, :] > rows[:, None] - window
        pairs = int(keep.sum()) * bt * heads
        qh = q.reshape(bt, st, heads, hd).transpose(1, 2).detach().requires_grad_(True)
        kl = k.transpose(1, 2).detach().requires_grad_(True)
        vl = v.transpose(1, 2).detach().requires_grad_(True)
        kle, vle = kl.expand(bt, heads, st, hd), vl.expand(bt, heads, st, hd)
        sd_out = torch.nn.functional.scaled_dot_product_attention(
            qh, kle, vle, attn_mask=keep, scale=1.0)
        do_h = do.reshape(bt, st, heads, hd).transpose(1, 2).to(torch.bfloat16)
        lib = {"library_backend": sdpa_backend(qh, kle, vle, attn_mask=keep, scale=1.0)}
        if window is None:
            sd_causal = torch.nn.functional.scaled_dot_product_attention(
                qh, kle, vle, is_causal=True, scale=1.0)
            lib.update(library_is_causal_backend=sdpa_backend(qh, kle, vle, is_causal=True,
                                                              scale=1.0),
                       library_is_causal_ms=timed(lambda: torch.autograd.grad(
                           sd_causal, (qh, kl, vl), do_h, retain_graph=True)))
            del sd_causal
        in_bytes = (q.numel() + k.numel() + v.numel()) * 2 + do.numel() * 4 + 2 * lse.numel() * 4
        tag = f"train S={st} B={bt} H={heads} Kv={kvh} hd={hd} " + (
            "causal" if window is None else f"window {window}")
        short = dict(causal=True, window=cfg.window - 1)
        check("flash_attention_bwd_dq", tag,
              lambda kw=kw, lse=lse, di=di: af.flash_attention_bwd_dq(q, k, v, do, lse, di, **kw),
              lambda kw=kw, lse=lse, di=di: af.flash_attention_bwd_dq_plain(
                  q, k, v, do, lse, di, **kw),
              lambda sd_out=sd_out, qh=qh, do_h=do_h: torch.autograd.grad(
                  sd_out, (qh,), do_h, retain_graph=True),
              ATTN_BWD_DQ_BOUND, 6 * pairs * hd, in_bytes + q.numel() * 4,
              control=lambda lse=lse, di=di, short=short: af.flash_attention_bwd_dq_plain(
                  q, k, v, do, lse, di, **short), extra=lib, loop="sm90")
        check("flash_attention_bwd_dkv", tag,
              lambda kw=kw, lse=lse, di=di: af.flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw),
              lambda kw=kw, lse=lse, di=di: af.flash_attention_bwd_dkv_plain(
                  q, k, v, do, lse, di, **kw),
              lambda sd_out=sd_out, kl=kl, vl=vl, do_h=do_h: torch.autograd.grad(
                  sd_out, (kl, vl), do_h, retain_graph=True),
              ATTN_BWD_DKV_BOUND, 8 * pairs * hd, in_bytes + 2 * k.numel() * 4,
              control=lambda lse=lse, di=di, short=short: af.flash_attention_bwd_dkv_plain(
                  q, k, v, do, lse, di, **short), extra=lib, loop="sm90")
        if window is not None:   # one carried rung through the backward: bf16x6
            kx6 = dict(kw, precision="bf16x6")
            out6, lse6 = af.flash_attention_fwd(q, k, v, **kx6)
            di6 = af.bwd_delta(out6, do)
            # yardstick: SDPA's backward in f32 (the function bf16x6 stands
            # for), its math backend, whose matmuls keep TF32 off
            q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (qh, kl, vl))
            sd32 = sdpa_math(q32, k32.expand(bt, heads, st, hd), v32.expand(bt, heads, st, hd),
                             attn_mask=keep, scale=1.0)
            do32 = do_h.float()
            for name, kern, plain, b_err, fl, by, wrt in (
                    ("flash_attention_bwd_dq", af.flash_attention_bwd_dq,
                     af.flash_attention_bwd_dq_plain, ATTN_BWD_DQ_BOUND, 6 * pairs * hd,
                     in_bytes + q.numel() * 4, (q32,)),
                    ("flash_attention_bwd_dkv", af.flash_attention_bwd_dkv,
                     af.flash_attention_bwd_dkv_plain, ATTN_BWD_DKV_BOUND, 8 * pairs * hd,
                     in_bytes + 2 * k.numel() * 4, (k32, v32))):
                check(name, tag + " bf16x6",
                      lambda f=kern: f(q, k, v, do, lse6, di6, **kx6),
                      lambda f=plain: f(q, k, v, do, lse6, di6, **kx6),
                      lambda wrt=wrt: torch.autograd.grad(sd32, wrt, do32, retain_graph=True),
                      b_err, num_passes("bf16x6") * fl, by,
                      library_call="SDPA backward through autograd on f32 copies, math "
                                   "backend (TF32 off)", loop="wmma")
            del out6, lse6, di6, sd32, q32, k32, v32, do32
        del sd_out, qh, kl, vl, kle, vle
    del q, k, v, do, out, lse, di

    # the GEMM layouts of the training backward (2048 = 2 x 1024 tokens),
    # library: one torch.matmul on the same layout (TF32 off), on bf16
    # copies for the bf16 rung and on the f32 operands for refine_ab
    m = bt * st
    g_down = randn((m, d), d ** -0.5)                  # grad of the down projection's output
    w_down = randn((ff, d), ff ** -0.5)
    check("gemm_tiled", f"train dX mlp down {m}x{d}x{ff} K-major B",
          lambda: gt.gemm_tiled(g_down, w_down.t()),
          lambda: gt.gemm_tiled_plain(g_down, w_down.t()),
          lambda g16=g_down.to(torch.bfloat16), w16=w_down.to(torch.bfloat16): torch.matmul(
              g16, w16.t()),
          GEMM_BOUND, 2 * m * d * ff, (g_down.numel() + w_down.numel() + m * ff) * 4, loop="sm90")
    x_up = randn((m, d), dtype=torch.bfloat16)
    g_up = randn((m, ff), m ** -0.5)
    check("gemm_tiled", f"train dW mlp up {d}x{m}x{ff} M-contiguous A",
          lambda: gt.gemm_tiled(x_up.t(), g_up),
          lambda: gt.gemm_tiled_plain(x_up.t(), g_up),
          lambda g16=g_up.to(torch.bfloat16): torch.matmul(x_up.t(), g16),
          GEMM_BOUND, 2 * d * m * ff, x_up.numel() * 2 + (g_up.numel() + d * ff) * 4, loop="sm90")
    del g_down, w_down, x_up, g_up
    torch.cuda.empty_cache()
    g_log = randn((m, vocab), vocab ** -0.5)            # grad of the logits
    table = randn((vocab, d), d ** -0.5)
    x_fin = randn((m, d), dtype=torch.bfloat16)
    check("gemm_refined", f"train unembed dX refine_ab {m}x{vocab}x{d}",
          lambda: gr.gemm_refined(g_log, table, policy="refine_ab"),
          lambda: gr.gemm_refined_plain(g_log, table, "refine_ab"),
          lambda: torch.matmul(g_log, table),
          GEMM_BOUND, refined_flops(g_log, table, m, d, vocab),
          (g_log.numel() + table.numel() + m * d) * 4, loop="sm90",
          extra=refined_extra(m, d, vocab))
    check("gemm_refined", f"train unembed dTable refine_ab {d}x{m}x{vocab} M-contiguous A",
          lambda: gr.gemm_refined(x_fin.t(), g_log, policy="refine_ab"),
          lambda: gr.gemm_refined_plain(x_fin.t(), g_log, "refine_ab"),
          lambda: torch.matmul(x_fin.t().float(), g_log),
          GEMM_BOUND, refined_flops(x_fin, g_log, d, vocab, m),
          x_fin.numel() * 2 + (g_log.numel() + d * vocab) * 4, loop="sm90",
          extra=refined_extra(d, vocab, m))
    del g_log
    torch.cuda.empty_cache()
    # the forward's unembed: (2048 x 1152) bf16 against the f32 table, NT;
    # library: one f32 SGEMM on an f32 copy of x
    check("gemm_refined", f"train unembed forward refine_ab {m}x{d}x{vocab} NT",
          lambda: gr.gemm_refined(x_fin, table.t(), policy="refine_ab"),
          lambda: gr.gemm_refined_plain(x_fin, table.t(), "refine_ab"),
          lambda xf=x_fin.float(): torch.matmul(xf, table.t()),
          GEMM_BOUND, refined_flops(x_fin, table, m, vocab, d),
          x_fin.numel() * 2 + table.numel() * 4 + m * vocab * 4, loop="sm90",
          extra=refined_extra(m, vocab, d))
    del table, x_fin
    torch.cuda.empty_cache()

    # ---- Mixtral's head shape: hd 128, 32 heads on 8 kv heads (G = 4).
    # Its window (4096) exceeds every length here, so the prefill and the
    # train shape are causal and the decode reads a 1024-row ring.
    mcfg_full = get_config("mixtral-8x7b")
    m_heads, m_kvh, m_hd = mcfg_full.num_heads, mcfg_full.num_kv_heads, mcfg_full.head_dim
    m_grp = m_heads // m_kvh
    s = 700
    q = randn((1, s, m_kvh, m_grp, m_hd), m_hd ** -0.5, torch.bfloat16)
    k = randn((1, s, m_kvh, m_hd), dtype=torch.bfloat16)
    v = randn((1, s, m_kvh, m_hd), dtype=torch.bfloat16)
    rows = torch.arange(s, device=dev)
    keep = rows[None, :] <= rows[:, None]
    qh = q.reshape(1, s, m_heads, m_hd).transpose(1, 2)
    kr, vr = (c.transpose(1, 2).repeat_interleave(m_grp, 1) for c in (k, v))
    check("flash_attention", f"prefill S={s} H={m_heads} Kv={m_kvh} hd={m_hd} causal",
          lambda: af.flash_attention(q, k, v, causal=True, window=mcfg_full.window),
          lambda: af.flash_attention_plain(q, k, v, causal=True, window=mcfg_full.window)[0],
          lambda: torch.nn.functional.scaled_dot_product_attention(
              qh, kr, vr, attn_mask=keep, scale=1.0),
          ATTN_BOUND, 4 * int(keep.sum()) * m_hd * m_heads,
          (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4,
          library_call="scaled_dot_product_attention, kv heads repeated (not timed)",
          loop="sm90")
    del q, k, v, qh, kr, vr
    qd = randn((4, 1, m_kvh, m_grp, m_hd), m_hd ** -0.5, torch.bfloat16)
    s_cache = 1024
    kc = randn((4, s_cache, m_kvh, m_hd), dtype=torch.bfloat16)
    vc = randn((4, s_cache, m_kvh, m_hd), dtype=torch.bfloat16)
    col = torch.arange(s_cache, device=dev)[None, :]
    p64 = pos.long()[:, None]
    live = p64 - torch.remainder(p64 - col, s_cache) >= 0
    live &= p64 - torch.remainder(p64 - col, s_cache) > p64 - mcfg_full.window
    dmask = live[:, None, None, :].expand(4, m_heads, 1, s_cache)
    kr, vr = (c.transpose(1, 2).repeat_interleave(m_grp, 1) for c in (kc, vc))
    check("flash_decode", f"decode B=4 ring {s_cache} window {mcfg_full.window} "
          f"H={m_heads} Kv={m_kvh} hd={m_hd}",
          lambda: af.flash_decode(qd, kc, vc, pos, window=mcfg_full.window),
          lambda: af.flash_decode_plain(qd, kc, vc, pos, window=mcfg_full.window),
          lambda: torch.nn.functional.scaled_dot_product_attention(
              qd.reshape(4, 1, m_heads, m_hd).transpose(1, 2), kr, vr, attn_mask=dmask,
              scale=1.0),
          ATTN_BOUND, 4 * int(live.sum()) * m_grp * m_hd * m_kvh,
          qd.numel() * 2 + 2 * int(live.sum()) * m_kvh * m_hd * 2 + qd.numel() * 4,
          library_call="scaled_dot_product_attention, kv heads repeated (not timed)",
          extra={"splits": af.decode_splits(4, m_kvh, s_cache, sms)})
    del qd, kc, vc, kr, vr
    bt_m, st_m = 1, 1024
    q = randn((bt_m, st_m, m_kvh, m_grp, m_hd), m_hd ** -0.5, torch.bfloat16)
    k = randn((bt_m, st_m, m_kvh, m_hd), dtype=torch.bfloat16)
    v = randn((bt_m, st_m, m_kvh, m_hd), dtype=torch.bfloat16)
    do = randn((bt_m, st_m, m_kvh, m_grp, m_hd), 1e-2)
    kw = dict(causal=True, window=mcfg_full.window)
    out, lse = af.flash_attention_fwd(q, k, v, **kw)
    di = af.bwd_delta(out, do)
    rows = torch.arange(st_m, device=dev)
    keep = rows[None, :] <= rows[:, None]
    pairs = int(keep.sum()) * bt_m * m_heads
    qh = q.reshape(bt_m, st_m, m_heads, m_hd).transpose(1, 2).detach().requires_grad_(True)
    kl = k.transpose(1, 2).repeat_interleave(m_grp, 1).detach().requires_grad_(True)
    vl = v.transpose(1, 2).repeat_interleave(m_grp, 1).detach().requires_grad_(True)
    sd_out = torch.nn.functional.scaled_dot_product_attention(qh, kl, vl, attn_mask=keep,
                                                              scale=1.0)
    do_h = do.reshape(bt_m, st_m, m_heads, m_hd).transpose(1, 2).to(torch.bfloat16)
    sd_causal = torch.nn.functional.scaled_dot_product_attention(qh, kl, vl, is_causal=True,
                                                                 scale=1.0)
    lib = {"library_backend": sdpa_backend(qh, kl, vl, attn_mask=keep, scale=1.0),
           "library_is_causal_backend": sdpa_backend(qh, kl, vl, is_causal=True, scale=1.0),
           "library_is_causal_ms": timed(lambda: torch.autograd.grad(
               sd_causal, (qh, kl, vl), do_h, retain_graph=True))}
    del sd_causal
    in_bytes = (q.numel() + k.numel() + v.numel()) * 2 + do.numel() * 4 + 2 * lse.numel() * 4
    tag = f"train S={st_m} B={bt_m} H={m_heads} Kv={m_kvh} hd={m_hd} causal"
    lib_bwd = "SDPA backward through autograd, kv heads repeated"
    half = dict(causal=True, window=st_m // 2)
    check("flash_attention_bwd_dq", tag,
          lambda: af.flash_attention_bwd_dq(q, k, v, do, lse, di, **kw),
          lambda: af.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **kw),
          lambda: torch.autograd.grad(sd_out, (qh,), do_h, retain_graph=True),
          ATTN_BWD_DQ_BOUND, 6 * pairs * m_hd, in_bytes + q.numel() * 4,
          control=lambda: af.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **half),
          library_call=lib_bwd, extra=lib, loop="sm90")
    check("flash_attention_bwd_dkv", tag,
          lambda: af.flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw),
          lambda: af.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw),
          lambda: torch.autograd.grad(sd_out, (kl, vl), do_h, retain_graph=True),
          MIXTRAL_ATTN_BWD_DKV_BOUND, 8 * pairs * m_hd, in_bytes + 2 * k.numel() * 4,
          control=lambda: af.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **half),
          library_call=lib_bwd, extra=lib, loop="sm90")
    del q, k, v, do, out, lse, di, sd_out, qh, kl, vl
    torch.cuda.empty_cache()

    # ---- the grouped GEMMs at Mixtral's widths (8 experts, 4096 x 14336,
    # f32 expert stacks, bf16 activations).  Group sizes from a seeded
    # skewed draw; each run aligned to the bm the MoE dispatcher picks
    # (grouped_tiles), padding rows zero.  Control: the plain version with
    # every group against its neighbouring expert (for dW: the runs'
    # boundaries moved by one tile).  Bound: the bytes the function needs
    # (the real rows, the weights of the experts that have rows, the whole
    # output) or its operations on the real rows, whichever is larger.
    # Yardstick: torch._grouped_mm on bf16 copies (casts not timed) with
    # the groups' aligned ends as offs, f32 out.
    n_exp, d_m, ff_m = mcfg_full.num_experts, mcfg_full.d_model, mcfg_full.d_ff
    grouped_route = ops.Route("bf16", {"grouped": "cuda_grouped"})
    lrng = np.random.default_rng(14)
    # the alignment rows (128 and 64) draw from their own generators, so
    # every other check keeps the inputs it had before they were added
    align_rng = np.random.default_rng(16)
    align_gen = torch.Generator(device=dev).manual_seed(16)

    def group_layout(tk, width, zero_width=None, bm=None, rng=None, generator=None):
        """counts (skewed draw), the alignment (the dispatcher's, unless
        given), offsets and a bf16 buffer."""
        rng = rng or lrng
        share = rng.dirichlet(np.full(n_exp, 0.6))
        counts = rng.multinomial(tk, share)
        bm = bm or ops.grouped_tiles(grouped_route, tk, ff_m, d_m).bm
        aligned = ops.align_group_counts(counts, bm)
        if zero_width is not None:          # the public contract allows it
            aligned[zero_width + 1] += aligned[zero_width]
            counts[zero_width + 1] += counts[zero_width]
            aligned[zero_width] = counts[zero_width] = 0
        offsets = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
        n_buf = ops.round_up(tk, bm) + n_exp * bm
        valid = torch.zeros(n_buf, dtype=torch.bool, device=dev)
        for g in range(n_exp):
            valid[int(offsets[g]):int(offsets[g]) + int(counts[g])] = True
        x = randn((n_buf, width), dtype=torch.bfloat16, generator=generator) * valid[:, None]
        return counts, bm, torch.from_numpy(offsets).to(dev), x

    def grouped_mm_library(a, b, offs, what):
        """torch._grouped_mm on bf16 copies (f32 out where this build
        takes it, else bf16 out), or a per-group matmul loop where it has
        no grouped_mm; returns (call, its name)."""
        errors = []
        for out_dtype in (torch.float32, None):
            try:
                torch._grouped_mm(a, b, offs=offs, out_dtype=out_dtype)
                return (lambda o=out_dtype: torch._grouped_mm(a, b, offs=offs, out_dtype=o),
                        f"torch._grouped_mm bf16 {what}, offs = aligned group ends, "
                        f"{'f32' if out_dtype else 'bf16'} out")
            except (AttributeError, RuntimeError, TypeError) as e:
                errors.append(str(e))
        ends = [0, *offs.tolist()]
        name = f"per-group torch.matmul loop (torch._grouped_mm refused: {errors[-1]})"[:200]
        if a.dim() == 2 and b.dim() == 2:
            return lambda: [a[:, i:j] @ b[i:j] for i, j in zip(ends, ends[1:])], name
        return lambda: [a[i:j] @ b[g] for g, (i, j) in enumerate(zip(ends, ends[1:]))], name

    w_in = randn((n_exp, d_m, ff_m), d_m ** -0.5)
    w_in16 = w_in.to(torch.bfloat16)
    w_in_rolled = w_in.roll(-1, 0)
    # the prefill at the dispatcher's alignment and at 128 and 64 (the
    # wgmma mainloop's two CTA row tiles), the decode at 16 (the split-K
    # weight stream, given the real counts as the MoE FFN gives them: only
    # the experts with rows are read, and the bound counts only their
    # weights); one quantized rung (fp8x3, its scales per tile) against its
    # plain version at GEMM_BOUND with the one-pass fp8 as its wrong-rung
    # control, its error against the torch route's fp8x3 (per-tensor
    # scales) recorded and held to the rung's ladder bound.
    for tk, phase, bm_at in ((1400, "prefill", None), (1400, "prefill", 128),
                             (1400, "prefill", 64), (8, "decode", None)):
        counts, bm, off, x = (group_layout(tk, d_m, bm=bm_at, rng=align_rng, generator=align_gen)
                              if bm_at else group_layout(tk, d_m))
        cnt = torch.from_numpy(counts).to(dev, torch.int32) if phase == "decode" else None
        live_w = int((counts > 0).sum()) * d_m * ff_m * 4
        lib, lib_name = grouped_mm_library(x, w_in16, off[1:], "forward")
        rungs = ("bf16", "refine_ab") if bm_at is None else ("bf16",)
        for rung in rungs:
            cta = gg.cta_rows(bm, rung)
            check("grouped_gemm", f"{phase} wi {rung} T*k={tk} {d_m}->{ff_m} E={n_exp} bm={bm} "
                  f"counts {counts.tolist()}",
                  lambda x=x, off=off, bm=bm, r=rung, c=cnt: gg.grouped_gemm(
                      x, w_in, off, bm=bm, policy=r, group_counts=c),
                  lambda x=x, off=off, r=rung, bm=bm: gg.grouped_gemm_plain(x, w_in, off,
                                                                            policy=r, bm=bm),
                  lib, GEMM_BOUND, num_passes(rung) * 2 * tk * d_m * ff_m,
                  tk * d_m * 2 + live_w + x.shape[0] * ff_m * 4,
                  control=lambda x=x, off=off, r=rung, bm=bm: gg.grouped_gemm_plain(
                      x, w_in_rolled, off, policy=r, bm=bm),
                  library_call=lib_name,
                  loop="splitk" if cta == 16 else "sm90" if rung == "bf16" else "wmma",
                  extra={"splits": gg.grouped_splits(x.shape[0], ff_m, d_m, gt.sm_count(
                      dev.index))} if cta == 16 else None)
        if phase == "decode":
            decode = (counts, bm, off, x, cnt)
        if bm_at is None and phase == "prefill":
            route_fp8 = ops.grouped_matmul(x, w_in, off, bm=bm, policy=ops.Route("fp8x3"))
            check("grouped_gemm", f"{phase} wi fp8x3 T*k={tk} {d_m}->{ff_m} E={n_exp} bm={bm}",
                  lambda x=x, off=off, bm=bm: gg.grouped_gemm(x, w_in, off, bm=bm,
                                                              policy="fp8x3"),
                  lambda x=x, off=off, bm=bm: gg.grouped_gemm_plain(x, w_in, off,
                                                                    policy="fp8x3", bm=bm),
                  lib, GEMM_BOUND, num_passes("fp8x3") * 2 * tk * d_m * ff_m,
                  tk * d_m * 2 + live_w + x.shape[0] * ff_m * 4,
                  control=lambda x=x, off=off, bm=bm: gg.grouped_gemm_plain(
                      x, w_in_rolled, off, policy="fp8x3", bm=bm),
                  rung_control=lambda x=x, off=off, bm=bm: gg.grouped_gemm_plain(
                      x, w_in, off, policy="fp8", bm=bm),
                  library_call=lib_name, loop="wmma",
                  extra={"torch_route_err": max_err(
                      (gg.grouped_gemm(x, w_in, off, bm=bm, policy="fp8x3"),), (route_fp8,))})
            if not checks["grouped_gemm"][-1]["torch_route_err"] <= LADDER_BOUNDS["fp8x3"]:
                fail("grouped_gemm fp8x3: farther from the torch route than the rung's bound")
            del route_fp8
        del x
    # prefill wo: the activated hidden rows against the down projections
    w_out = randn((n_exp, ff_m, d_m), ff_m ** -0.5)
    counts, bm, off, h = group_layout(1400, ff_m)
    lib, lib_name = grouped_mm_library(h, w_out.to(torch.bfloat16), off[1:], "forward")
    w_out_rolled = w_out.roll(-1, 0)
    check("grouped_gemm", f"prefill wo bf16 T*k=1400 {ff_m}->{d_m} E={n_exp} bm={bm} "
          f"counts {counts.tolist()}",
          lambda: gg.grouped_gemm(h, w_out, off, bm=bm),
          lambda: gg.grouped_gemm_plain(h, w_out, off, bm=bm),
          lib, GEMM_BOUND, 2 * 1400 * ff_m * d_m,
          1400 * ff_m * 2 + int((counts > 0).sum()) * ff_m * d_m * 4 + h.shape[0] * d_m * 4,
          control=lambda: gg.grouped_gemm_plain(h, w_out_rolled, off, bm=bm),
          library_call=lib_name, loop="sm90")
    del h, lib
    # the decode's wo and its live-expert rows (their inputs from their own
    # generator, so every other check keeps the inputs it had): wo on the
    # activated hidden rows of the decode's counts against the down
    # projections
    counts, bm, off, x, cnt = decode
    tk = int(counts.sum())
    dec_gen = torch.Generator(device=dev).manual_seed(23)
    h = randn((x.shape[0], ff_m), dtype=torch.bfloat16, generator=dec_gen) * (x[:, :1] != 0)
    h_lib, h_lib_name = grouped_mm_library(h, w_out.to(torch.bfloat16), off[1:],
                                           "forward")
    check("grouped_gemm", f"decode wo bf16 T*k={tk} {ff_m}->{d_m} E={n_exp} bm={bm} "
          f"counts {counts.tolist()}",
          lambda: gg.grouped_gemm(h, w_out, off, bm=bm, group_counts=cnt),
          lambda: gg.grouped_gemm_plain(h, w_out, off, bm=bm),
          h_lib, GEMM_BOUND, 2 * tk * ff_m * d_m,
          tk * ff_m * 2 + int((counts > 0).sum()) * ff_m * d_m * 4 + h.shape[0] * d_m * 4,
          control=lambda: gg.grouped_gemm_plain(h, w_out_rolled, off, bm=bm),
          library_call=h_lib_name, loop="splitk",
          extra={"splits": gg.grouped_splits(h.shape[0], d_m, ff_m,
                                             gt.sm_count(dev.index))})
    del h, h_lib
    # only the experts with rows are streamed: the same 8 rows on
    # one expert, then one row on each of the 8
    stream_rows = {}
    for label, one in (("one expert", [tk] + [0] * (n_exp - 1)), ("eight experts",
                                                                  [1] * n_exp)):
        one = np.asarray(one)
        aligned = ops.align_group_counts(one, bm)
        o_off = torch.from_numpy(np.concatenate([[0], np.cumsum(aligned)]).astype(
            np.int32)).to(dev)
        valid = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
        for g in range(n_exp):
            valid[int(o_off[g]):int(o_off[g]) + int(one[g])] = True
        xo = randn((x.shape[0], d_m), dtype=torch.bfloat16, generator=dec_gen) * valid[:, None]
        o_cnt = torch.from_numpy(one).to(dev, torch.int32)
        o_lib, o_lib_name = grouped_mm_library(xo, w_in16, o_off[1:], "forward")
        check("grouped_gemm", f"decode wi bf16 T*k={tk} {d_m}->{ff_m} E={n_exp} "
              f"bm={bm} {label} counts {one.tolist()}",
              lambda xo=xo, o=o_off, c=o_cnt: gg.grouped_gemm(xo, w_in, o, bm=bm,
                                                              group_counts=c),
              lambda xo=xo, o=o_off: gg.grouped_gemm_plain(xo, w_in, o, bm=bm),
              o_lib, GEMM_BOUND, 2 * tk * d_m * ff_m,
              tk * d_m * 2 + int((one > 0).sum()) * d_m * ff_m * 4
              + xo.shape[0] * ff_m * 4,
              control=lambda xo=xo, o=o_off: gg.grouped_gemm_plain(xo, w_in_rolled, o,
                                                                   bm=bm),
              library_call=o_lib_name, loop="splitk")
        stream_rows[label] = checks["grouped_gemm"][-1]["ms"]
        del xo, o_lib
    emit(phase="grouped_decode_live_experts", ms=stream_rows,
         one_over_eight=stream_rows["one expert"] / stream_rows["eight experts"])
    del w_out, w_out_rolled, x, decode
    torch.cuda.empty_cache()
    # the train backward at 1 x 1024 tokens (T*k = 2048): dx of the up
    # projection (dy against w^T, read through swapped strides) and dW
    zw = n_exp // 2                       # the zero-width group of the dW check
    counts, bm, off, x = group_layout(2048, d_m, zero_width=zw)
    dy = randn((x.shape[0], ff_m), 2048 ** -0.5) * (x[:, :1] != 0)
    lib, lib_name = grouped_mm_library(dy.to(torch.bfloat16), w_in16.transpose(1, 2), off[1:],
                                       "dx (w transposed view)")
    live_w = int((counts > 0).sum()) * d_m * ff_m * 4
    check("grouped_gemm", f"train dx trans_w bf16 T*k=2048 {ff_m}->{d_m} E={n_exp} bm={bm} "
          f"counts {counts.tolist()}",
          lambda: gg.grouped_gemm(dy, w_in, off, bm=bm, trans_w=True),
          lambda: gg.grouped_gemm_plain(dy, w_in, off, trans_w=True, bm=bm),
          lib, GEMM_BOUND, 2 * 2048 * ff_m * d_m,
          2048 * ff_m * 4 + live_w + x.shape[0] * d_m * 4,
          control=lambda: gg.grouped_gemm_plain(dy, w_in_rolled, off, trans_w=True, bm=bm),
          library_call=lib_name, loop="sm90")
    del w_in, w_in16, w_in_rolled, lib
    torch.cuda.empty_cache()
    off_moved = off.clone()
    off_moved[1:-1] += bm
    lib, lib_name = grouped_mm_library(x.t(), dy.to(torch.bfloat16), off[1:], "dW (x^T view)")
    dw_zero_exact = []

    def dw_kernel():
        dw = gg.grouped_gemm_dw(x, dy, off)
        dw_zero_exact.append(bool((dw[zw] == 0).all()))
        return dw

    check("grouped_gemm_dw", f"train dW bf16 T*k=2048 {d_m}x{ff_m} E={n_exp} bm={bm} "
          f"counts {counts.tolist()} (group {zw} zero-width)",
          dw_kernel, lambda: gg.grouped_gemm_dw_plain(x, dy, off),
          lib, GEMM_BOUND, 2 * 2048 * d_m * ff_m,
          2048 * (d_m * 2 + ff_m * 4) + n_exp * d_m * ff_m * 4,
          control=lambda: gg.grouped_gemm_dw_plain(x, dy, off_moved),
          library_call=lib_name, loop="sm90")
    if not all(dw_zero_exact):
        fail("grouped_gemm_dw: the zero-width group's block is not exactly 0")
    # one quantized rung through dW: int8x3, its scales per 64 x 32 tile of
    # x^T and 32 x 128 tile of dy (the quantize pass, whose scales are held
    # bit for bit to its plain twin and whose bf16 terms the WMMA kernel
    # stages), held to GEMM_BOUND (bit-equal terms), the one-pass int8
    # its wrong-rung control; whether it beats its plain version (ROADMAP
    # C4) is recorded, not gated (a time, not a correctness check)
    scales = gg.grouped_dw_scales(x, dy, off, policy="int8x3")
    scale_pass = {"scale_pass_bit_equal": bool(torch.equal(
        scales, gg.grouped_dw_scales_plain(x, dy, off, policy="int8x3"))),
        "scale_pass_ms": timed(lambda: gg.grouped_dw_scales(x, dy, off, policy="int8x3"))}
    del scales
    if not scale_pass["scale_pass_bit_equal"]:
        fail("grouped_dw_scales int8x3: the quantize pass's scales differ from its plain twin")
    check("grouped_gemm_dw", f"train dW int8x3 T*k=2048 {d_m}x{ff_m} E={n_exp} bm={bm}",
          lambda: gg.grouped_gemm_dw(x, dy, off, policy="int8x3"),
          lambda: gg.grouped_gemm_dw_plain(x, dy, off, policy="int8x3"),
          lib, GEMM_BOUND, num_passes("int8x3") * 2 * 2048 * d_m * ff_m,
          2048 * (d_m * 2 + ff_m * 4) + n_exp * d_m * ff_m * 4,
          control=lambda: gg.grouped_gemm_dw_plain(x, dy, off_moved, policy="int8x3"),
          rung_control=lambda: gg.grouped_gemm_dw_plain(x, dy, off, policy="int8"),
          library_call=lib_name, loop="wmma", extra=scale_pass)
    emit(phase="c4", kernel="grouped_gemm_dw", what="train dW int8x3",
         faster_than_plain=checks["grouped_gemm_dw"][-1]["ms"]
         < checks["grouped_gemm_dw"][-1]["plain_ms"])
    del x, dy, lib
    torch.cuda.empty_cache()

    # ---- the paper's naive GEMM (Listing 1: a warp per 16 x 16 tile, no
    # shared memory) at the shapes serve_naive hands it: gemma3's prefill
    # MLP and decode unembed, f32 weights rounded to a bf16 copy per call.
    # Then one square point of Fig. 6 on bf16 operands, with the tiled
    # kernel (the CUTLASS column), bf16 cuBLAS (the library column) and f32
    # SGEMM with TF32 off beside it.
    m = 700
    x = randn((m, d), dtype=torch.bfloat16)
    w = randn((d, ff), d ** -0.5)
    w16 = w.to(torch.bfloat16)
    check("gemm_naive", f"prefill mlp {m}x{d}x{ff}", lambda: gn.gemm_naive(x, w),
          lambda: gn.gemm_naive_plain(x, w), lambda: torch.matmul(x, w16), GEMM_BOUND,
          2 * m * d * ff, x.numel() * 2 + w.numel() * 4 + m * ff * 4)
    del w, w16
    table = randn((vocab, d), d ** -0.5)
    table16 = table.to(torch.bfloat16)
    check("gemm_naive", f"decode unembed 4x{d}x{vocab} NT", lambda: gn.gemm_naive(xb, table.t()),
          lambda: gn.gemm_naive_plain(xb, table.t()), lambda: torch.matmul(xb, table16.t()),
          GEMM_BOUND, 2 * 4 * d * vocab, unembed_bytes)
    del table, table16
    torch.cuda.empty_cache()
    sq = 4096
    a_sq = randn((sq, sq), dtype=torch.bfloat16)
    b_sq = randn((sq, sq), sq ** -0.5, torch.bfloat16)
    a_sq32, b_sq32 = a_sq.float(), b_sq.float()
    fig6 = {"sgemm_f32_ms": timed(lambda: torch.matmul(a_sq32, b_sq32))}
    check("gemm_tiled", f"square {sq}x{sq}x{sq} bf16 operands (Fig. 6)",
          lambda: gt.gemm_tiled(a_sq, b_sq), lambda: gt.gemm_tiled_plain(a_sq, b_sq),
          lambda: torch.matmul(a_sq, b_sq), GEMM_BOUND, 2 * sq ** 3, 2 * sq * sq * 2 + sq * sq * 4,
          library_call="torch.matmul bf16 (cuBLAS); sgemm_f32_ms: torch.matmul f32, TF32 off",
          extra=fig6, loop="sm90")
    fig6["tiled_ms"] = checks["gemm_tiled"][-1]["ms"]
    check("gemm_naive", f"square {sq}x{sq}x{sq} bf16 operands (Fig. 6)",
          lambda: gn.gemm_naive(a_sq, b_sq), lambda: gn.gemm_naive_plain(a_sq, b_sq),
          lambda: torch.matmul(a_sq, b_sq), GEMM_BOUND, 2 * sq ** 3, 2 * sq * sq * 2 + sq * sq * 4,
          library_call="torch.matmul bf16 (cuBLAS); tiled_ms: gemm_tiled; sgemm_f32_ms: "
                       "torch.matmul f32, TF32 off", extra=fig6)
    del a_sq, b_sq, a_sq32, b_sq32

    # ---- the batched small GEMMs (Fig. 7): bf16 operands, f32 out, n = 16
    # at G = 256 and 16384, n = 8, 32 and 64 at G = 4096.  Yardstick: the
    # same function in one call, torch.bmm on the bf16 operands with an f32
    # output (``out_dtype``), and beside it the bf16-out call (6 bytes an
    # element where the kernels move 8).  Control: the plain version on the
    # B batch rolled by one matrix.
    for n_b, g_b in ((16, 256), (16, 16384), (8, 4096), (32, 4096), (64, 4096)):
        a_b = randn((g_b, n_b, n_b), dtype=torch.bfloat16)
        b_b = randn((g_b, n_b, n_b), dtype=torch.bfloat16)
        b_roll = b_b.roll(1, 0)
        try:
            torch.bmm(a_b, b_b, out_dtype=torch.float32)
            bmm_f32, bmm_call = (lambda a=a_b, b=b_b: torch.bmm(a, b, out_dtype=torch.float32),
                                 "torch.bmm(out_dtype=torch.float32) on the bf16 operands")
        except (RuntimeError, TypeError) as e:
            bmm_f32, bmm_call = None, f"none: torch.bmm(out_dtype=torch.float32) raised {e}"[:200]
        bmm_bf16 = {"library_bf16_out_call": "torch.bmm bf16 (bf16 out)",
                    "library_bf16_out_ms": timed(lambda a=a_b, b=b_b: torch.bmm(a, b))}
        for name, kern, plain in (
                ("batched_gemm", bg.batched_gemm, bg.batched_gemm_plain),
                ("batched_gemm_naive", bg.batched_gemm_naive, bg.batched_gemm_naive_plain)):
            check(name, f"G={g_b} n={n_b} bf16", lambda a=a_b, b=b_b, f=kern: f(a, b),
                  lambda a=a_b, b=b_b, f=plain: f(a, b), bmm_f32,
                  BATCHED_BOUND, 2 * g_b * n_b ** 3, g_b * n_b * n_b * (2 + 2 + 4),
                  control=lambda a=a_b, b=b_roll, f=plain: f(a, b),
                  library_call=bmm_call, extra=bmm_bf16)
    del a_b, b_b, b_roll

    # ---- wkv6 at a full grid: B = 4, S = 1024, H = 64 (256 blocks), K = 64,
    # chunk 64, inputs by tests/test_kernels.py's TestWKV6Kernel recipe,
    # against the chunked plain version and the sequential recurrence
    # (absolute).  No PyTorch call computes WKV6.  Control: the plain
    # version with the state reset at every chunk boundary.
    def wkv_reset_each_chunk(r, k, v, logw, u, chunk):
        """wkv6_plain with the state reset at every chunk boundary (a fault)."""
        return split_chunks(wk.wkv6_plain, (r, k, v, logw), chunk, u, chunk=chunk)

    def wkv_cost(b, s, h, kd, chunk):
        """(operations, bytes, extra) of the chunked form at the rung that
        holds WKV_BOUND: per (b, h) and chunk the products (the state read
        and update, 2 C K^2 each; the strictly-lower scores and their
        product with v, C(C-1) K each) on three TF32 passes, as operations
        at PEAK_TF32_FLOPS; r, k, v, logw read once, u, out and the final
        state.  ``extra``: the old bound of the whole chunked form (its
        exp terms too) on the f32 CUDA cores, and the bytes of the chunk
        states the design writes and reads (B H (S/C) K^2 f32 each way)."""
        pairs = chunk * (chunk - 1) // 2
        chunks = b * h * (s // chunk)
        products = chunks * (4 * chunk * kd * kd + 4 * pairs * kd)
        f32_form = chunks * (4 * chunk * kd * kd + pairs * kd * 4 + 2 * pairs * kd
                             + 3 * chunk * kd)
        extra = {"ops_bound_f32_cuda_cores_ms": f32_form / PEAK_F32_FLOPS * 1e3,
                 "chunk_state_bytes": 2 * 4 * chunks * kd * kd}
        return (3 * products, 4 * (5 * b * s * h * kd + h * kd + b * h * kd * kd), extra)

    def wkv_recipe(b, s, h, kd):
        r, k, v = (randn((b, s, h, kd), 0.5) for _ in range(3))
        return r, k, v, -torch.exp(randn((b, s, h, kd), 0.5) - 0.7), randn((h, kd), 0.1)

    wkv_in = wkv_recipe(4, 1024, 64, 64)
    o_k, s_k = wk.wkv6(*wkv_in, chunk=64)
    o_r, s_r = kref.wkv6_ref(*wkv_in)
    wkv_ref_err = max((o_k - o_r).abs().max().item(), (s_k - s_r).abs().max().item())
    del o_k, s_k, o_r, s_r
    w_flops, w_bytes, w_extra = wkv_cost(4, 1024, 64, 64, 64)
    check("wkv6", "recipe B=4 S=1024 H=64 K=64 chunk 64", lambda: wk.wkv6(*wkv_in, chunk=64),
          lambda: wk.wkv6_plain(*wkv_in, chunk=64), None, WKV_BOUND, w_flops, w_bytes,
          control=lambda: wkv_reset_each_chunk(*wkv_in, 64),
          rung_control=lambda: wk.wkv6_scan_plain(*wkv_in, chunk=64, passes=1),
          peak=PEAK_TF32_FLOPS, library_call="none",
          extra={"sequential_ref_err": wkv_ref_err, **w_extra})
    if not wkv_ref_err <= WKV_BOUND:
        fail(f"wkv6: max |kernel - sequential recurrence| {wkv_ref_err} > {WKV_BOUND}")
    del wkv_in
    torch.cuda.empty_cache()

    # ---- zamba2-7b's and nemotron-4-340b's shapes.  zamba2-7b: hd 112
    # (two 64-column blocks, the second half out of bounds), 32 heads on 32
    # kv heads; Mamba-2's in_proj 3584 -> 14576 (a partial 64-column N tile)
    # at decode and prefill; the SSD's batched C.B^T (a 700-token prompt's
    # three 256-step chunks, f32 operands, B as a K-major view, as the model
    # calls it).  nemotron-4-340b: hd 192 (three column blocks), 96 heads on
    # 8 kv heads (G = 12); the 18432-wide decode MLP (K = 73728 on the down
    # projection) and the refine_ab decode unembed against its 256000 x
    # 18432 f32 table, whose plain version (each logit one row's product)
    # runs over vocab chunks: its whole-table hi/lo split would take ~47 GB
    # more.  Attention controls: the forward's plain version at window S / 2,
    # the decodes' one key short (pos - 1).
    def vocab_chunked(fn, table, rows=32768):
        """``fn`` over ``table``'s row blocks, concatenated on the last dim."""
        return torch.cat([fn(table[v0:v0 + rows]) for v0 in range(0, table.shape[0], rows)], -1)

    def causal_prefill_row(acfg, s, r0=0):
        """The flash forward at ``acfg``'s head shape over one causal
        ``s``-row prompt against its plain version, the control at window
        s / 2.  With ``r0`` > 0 the query rows with r0 keys or more are held
        at ATTN_BOUND and the first r0 rows in units of their
        softmax-weighted |v| (see FEW_KEYS)."""
        a_heads, a_kvh, a_hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
        a_grp = a_heads // a_kvh
        shape = f"H={a_heads} Kv={a_kvh} hd={a_hd} ({acfg.name})"
        rows = torch.arange(s, device=dev)
        keep = rows[None, :] <= rows[:, None]
        q = randn((1, s, a_kvh, a_grp, a_hd), a_hd ** -0.5, torch.bfloat16)
        k, v = (randn((1, s, a_kvh, a_hd), dtype=torch.bfloat16) for _ in range(2))
        qh = q.reshape(1, s, a_heads, a_hd).transpose(1, 2)
        kr, vr = (c.transpose(1, 2).repeat_interleave(a_grp, 1) for c in (k, v))
        few = {}
        if r0:
            o_k = af.flash_attention(q, k, v, causal=True)[0, :r0]
            o_p = af.flash_attention_plain(q, k, v, causal=True)[0][0, :r0]
            sc = torch.einsum("tkgd,jkd->kgtj", q[0, :r0].float(), k[0, :r0].float())
            sc = sc.masked_fill(~keep[:r0, :r0], float("-inf"))
            wv = torch.einsum("kgtj,jkd->tkgd", torch.softmax(sc, -1), v[0, :r0].float().abs())
            few = {"rows_held": f"query rows {r0}-{s - 1} ({r0}+ keys)",
                   "first_rows_scaled_err": ((o_k - o_p).abs() / wv).max().item(),
                   "first_rows_abs_err": (o_k - o_p).abs().max().item(),
                   "first_rows_scaled_bound": FEW_KEYS_SCALED_BOUND}
            del o_k, o_p, sc, wv
        check("flash_attention", f"prefill S={s} {shape} causal",
              lambda: af.flash_attention(q, k, v, causal=True)[:, r0:],
              lambda: af.flash_attention_plain(q, k, v, causal=True)[0][:, r0:],
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qh, kr, vr, attn_mask=keep, scale=1.0),
              ATTN_BOUND, 4 * int(keep.sum()) * a_hd * a_heads,
              (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4,
              control=lambda: af.flash_attention_plain(
                  q, k, v, causal=True, window=s // 2)[0][:, r0:],
              library_call="scaled_dot_product_attention"
                           + (", kv heads repeated (not timed)" if a_grp > 1 else ""),
              loop="sm90", extra=few)
        if few and not few["first_rows_scaled_err"] <= FEW_KEYS_SCALED_BOUND:
            fail(f"flash_attention prefill {shape}: the first {r0} rows part by "
                 f"{few['first_rows_scaled_err']} of their weighted |v| > "
                 f"{FEW_KEYS_SCALED_BOUND}")

    zcfg_full, ncfg_full = get_config("zamba2-7b"), get_config("nemotron-4-340b")
    s_cache = 1024
    live = torch.arange(s_cache, device=dev)[None, :] <= pos.long()[:, None]
    n_live = int(live.sum())
    for acfg in (zcfg_full, ncfg_full):
        a_heads, a_kvh, a_hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
        a_grp = a_heads // a_kvh
        shape = f"H={a_heads} Kv={a_kvh} hd={a_hd} ({acfg.name})"
        # nemotron's row holds its first FEW_KEYS rows scaled (see FEW_KEYS)
        causal_prefill_row(acfg, 700, FEW_KEYS if acfg is ncfg_full else 0)
        qd = randn((4, 1, a_kvh, a_grp, a_hd), a_hd ** -0.5, torch.bfloat16)
        qdh = qd.reshape(4, 1, a_heads, a_hd).transpose(1, 2)
        dmask = live[:, None, None, :].expand(4, a_heads, 1, s_cache)
        kc, vc = (randn((4, s_cache, a_kvh, a_hd), dtype=torch.bfloat16) for _ in range(2))
        kr, vr = (c.transpose(1, 2).repeat_interleave(a_grp, 1) for c in (kc, vc))
        splits = {"splits": af.decode_splits(4, a_kvh, s_cache, sms)}
        check("flash_decode", f"decode B=4 linear {s_cache} {shape}",
              lambda: af.flash_decode(qd, kc, vc, pos),
              lambda: af.flash_decode_plain(qd, kc, vc, pos),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qdh, kr, vr, attn_mask=dmask, scale=1.0),
              ATTN_BOUND, 4 * n_live * a_grp * a_hd * a_kvh,
              qd.numel() * 2 + 2 * n_live * a_kvh * a_hd * 2 + qd.numel() * 4,
              control=lambda: af.flash_decode_plain(qd, kc, vc, pos - 1),
              library_call="scaled_dot_product_attention, kv heads repeated (not timed)",
              extra=splits)
        del kc, vc, kr, vr
        if acfg is zcfg_full:
            # zamba2's paged run: 8-row bf16 pages behind a shuffled table
            n_log = paged.num_logical_pages(s_cache, ps)
            table_p = (1 + torch.randperm(4 * n_log, generator=gen, device=dev)
                       ).reshape(4, n_log)
            table_p = torch.where(torch.arange(n_log, device=dev)[None, :] * ps
                                  <= pos.long()[:, None], table_p,
                                  torch.zeros_like(table_p)).to(torch.int32)
            n_pages = int((table_p > 0).sum())
            pcache = paged.init_paged(4, s_cache, a_kvh, a_hd, page_size=ps,
                                      num_pages=1 + 4 * n_log, device=dev)
            pcache.page_table = table_p
            pcache.k_pages, pcache.v_pages = (
                randn((1 + 4 * n_log, ps, a_kvh, a_hd), dtype=torch.bfloat16) for _ in range(2))
            kr, vr = (x.to(torch.bfloat16).transpose(1, 2).repeat_interleave(a_grp, 1)
                      for x in paged.gather_dense(pcache))
            check("flash_paged_decode", f"paged decode B=4 linear {s_cache} page {ps} bf16 "
                  f"pages {shape}",
                  lambda: ap.flash_paged_decode(qd, pcache, pos),
                  lambda: ap.flash_paged_decode_plain(qd, pcache, pos),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      qdh, kr, vr, attn_mask=dmask, scale=1.0),
                  ATTN_BOUND, 4 * n_live * a_grp * a_hd * a_kvh,
                  qd.numel() * 2 + 2 * n_live * a_kvh * a_hd * 2 + n_pages * 4
                  + qd.numel() * 4,
                  control=lambda: ap.flash_paged_decode_plain(qd, pcache, pos - 1),
                  library_call="scaled_dot_product_attention on the cache gathered dense "
                               "(bf16), gather not timed", extra=splits)
            del pcache, kr, vr
        del qd, qdh
    z_d = zcfg_full.d_model
    z_inner, z_nh, z_conv = ssm_mod._dims(z_d, zcfg_full.ssm_head_dim, zcfg_full.ssm_state)
    z_n = z_inner + z_conv + z_nh
    w = randn((z_d, z_n), z_d ** -0.5)
    w16 = w.to(torch.bfloat16)
    for m, loop in ((4, "splitk"), (700, "sm90")):
        x = randn((m, z_d), dtype=torch.bfloat16)
        phase_name = "decode" if m == 4 else "prefill"
        check("gemm_tiled", f"{phase_name} mamba2 in_proj {m}x{z_d}x{z_n} ({zcfg_full.name})",
              lambda x=x: gt.gemm_tiled(x, w),
              lambda x=x: gt.gemm_tiled_plain(x, w), lambda x=x: torch.matmul(x, w16),
              GEMM_BOUND, 2 * m * z_d * z_n, x.numel() * 2 + w.numel() * 4 + m * z_n * 4,
              loop=loop)
    del w, w16
    n_ch, chunk, z_state = 3, zcfg_full.ssm_chunk, zcfg_full.ssm_state
    cc, bc = (randn((n_ch, chunk, z_state)) for _ in range(2))
    check("gemm_tiled", f"SSD C.B^T batched {n_ch}x{chunk}x{z_state}x{chunk}, K-major B "
          f"({zcfg_full.name})", lambda: gt.gemm_tiled(cc, bc.transpose(1, 2)),
          lambda: gt.gemm_tiled_plain(cc, bc.transpose(1, 2)),
          lambda c16=cc.to(torch.bfloat16), b16=bc.to(torch.bfloat16): torch.matmul(
              c16, b16.transpose(1, 2)),
          GEMM_BOUND, 2 * n_ch * chunk * chunk * z_state,
          (cc.numel() + bc.numel() + n_ch * chunk * chunk) * 4, loop="sm90")
    del cc, bc
    n_d, n_ff, n_vocab = ncfg_full.d_model, ncfg_full.d_ff, ncfg_full.vocab_size
    for kk, nn in ((n_d, n_ff), (n_ff, n_d)):
        a4 = randn((4, kk), dtype=torch.bfloat16)
        w = randn((kk, nn), kk ** -0.5)
        w16 = w.to(torch.bfloat16)
        check("gemm_tiled", f"decode mlp {'up' if kk == n_d else 'down'} 4x{kk}x{nn} "
              f"({ncfg_full.name})", lambda: gt.gemm_tiled(a4, w),
              lambda: gt.gemm_tiled_plain(a4, w), lambda: torch.matmul(a4, w16), GEMM_BOUND,
              2 * 4 * kk * nn, a4.numel() * 2 + w.numel() * 4 + 4 * nn * 4, loop="splitk")
        del w, w16
    torch.cuda.empty_cache()
    xn4 = randn((4, n_d), dtype=torch.bfloat16)
    table = randn((n_vocab, n_d), n_d ** -0.5)
    check("gemm_refined", f"decode unembed refine_ab 4x{n_d}x{n_vocab} NT ({ncfg_full.name})",
          lambda: gr.gemm_refined(xn4, table.t(), policy="refine_ab"),
          lambda: vocab_chunked(lambda t: gr.gemm_refined_plain(xn4, t.t(), "refine_ab"), table),
          lambda: torch.matmul(xn4.float(), table.t()), GEMM_BOUND,
          refined_flops(xn4, table, 4, n_vocab, n_d),
          xn4.numel() * 2 + table.numel() * 4 + 4 * n_vocab * 4, loop="splitk",
          extra={**refined_extra(4, n_vocab, n_d),
                 "plain": "gemm_refined_plain over 32768-row vocab chunks"})
    del table, xn4
    torch.cuda.empty_cache()

    # ---- whisper-medium's and internvl2-76b's shapes.  whisper: hd 64 (one
    # 64-column block), 16 heads on 16 kv heads; the encoder's bidirectional
    # attention over 1500 frames (a 28-row KV tail past 23 stages of 64);
    # cross-attention, the flash forward with Sq != Skv and no mask, at a
    # prefill (700 prompt rows against 1500 keys) and at a decode tick (one
    # query row per slot against 1500 keys, grid (1, 16, 4)); the decoder's
    # decode, dense and paged, at G = 1; the tied refine_ab unembed onto 51865
    # = 64 * 810 + 25 columns (a 207460-byte logits row); the cross K/V
    # projection (1500 x 1024 x 1024).  internvl2: the decode at 64 heads on 8
    # kv (G = 8, hd 128), the refine_ab unembed onto 128256 columns at d 8192
    # and the decode MLP (4 x 8192 x 28672 and back).  Both decoders' causal
    # prefill: whisper's self-attention over a 700-token prompt, internvl2's
    # over 256 image rows and a 700-token prompt (956 rows; its 64 heads
    # hold the first FEW_KEYS rows scaled, as nemotron's 96 do).  Controls:
    # the encoder's plain version run causal, the cross rows' plain version
    # over the first 1499 keys, the causal prefills' at window S / 2, the
    # decodes' one key short (pos - 1).
    wcfg_full, icfg_full = get_config("whisper-medium"), get_config("internvl2-76b")
    w_heads, w_kvh, w_hd = wcfg_full.num_heads, wcfg_full.num_kv_heads, wcfg_full.head_dim
    w_seq, w_d = wcfg_full.encoder_seq, wcfg_full.d_model
    wshape = f"H={w_heads} Kv={w_kvh} hd={w_hd} ({wcfg_full.name})"
    q = randn((1, w_seq, w_kvh, 1, w_hd), w_hd ** -0.5, torch.bfloat16)
    k, v = (randn((1, w_seq, w_kvh, w_hd), dtype=torch.bfloat16) for _ in range(2))
    qh, kh, vh = (c.reshape(1, w_seq, w_heads, w_hd).transpose(1, 2) for c in (q, k, v))
    check("flash_attention", f"encoder S={w_seq} non-causal {wshape}",
          lambda: af.flash_attention(q, k, v, causal=False),
          lambda: af.flash_attention_plain(q, k, v, causal=False)[0],
          lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0),
          ATTN_BOUND, 4 * w_seq * w_seq * w_hd * w_heads,
          (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4,
          control=lambda: af.flash_attention_plain(q, k, v, causal=True)[0],
          library_call="scaled_dot_product_attention, no mask", loop="sm90")
    for b_x, s_x in ((1, 700), (4, 1)):
        qx = randn((b_x, s_x, w_kvh, 1, w_hd), w_hd ** -0.5, torch.bfloat16)
        kx, vx = (randn((b_x, w_seq, w_kvh, w_hd), dtype=torch.bfloat16) for _ in range(2))
        qxh = qx.reshape(b_x, s_x, w_heads, w_hd).transpose(1, 2)
        kxh, vxh = (c.transpose(1, 2) for c in (kx, vx))
        check("flash_attention",
              f"cross {'prefill' if s_x > 1 else 'decode'} B={b_x} Sq={s_x} Skv={w_seq} "
              f"{wshape}",
              lambda qx=qx, kx=kx, vx=vx: af.flash_attention(qx, kx, vx, causal=False),
              lambda qx=qx, kx=kx, vx=vx: af.flash_attention_plain(qx, kx, vx, causal=False)[0],
              lambda qxh=qxh, kxh=kxh, vxh=vxh: torch.nn.functional.scaled_dot_product_attention(
                  qxh, kxh, vxh, scale=1.0),
              ATTN_BOUND, 4 * b_x * s_x * w_seq * w_hd * w_heads,
              (qx.numel() + kx.numel() + vx.numel()) * 2 + qx.numel() * 4,
              control=lambda qx=qx, kx=kx, vx=vx: af.flash_attention_plain(
                  qx, kx[:, :-1], vx[:, :-1], causal=False)[0],
              library_call="scaled_dot_product_attention, no mask", loop="sm90",
              extra={"grid": [-(-s_x // af.BQ), w_heads, b_x]})
        del qx, kx, vx, qxh, kxh, vxh
    del q, k, v, qh, kh, vh
    causal_prefill_row(wcfg_full, 700)
    causal_prefill_row(icfg_full, icfg_full.num_image_tokens + 700, FEW_KEYS)
    for acfg in (wcfg_full, icfg_full):
        a_heads, a_kvh, a_hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
        a_grp = a_heads // a_kvh
        shape = f"H={a_heads} Kv={a_kvh} hd={a_hd} G={a_grp} ({acfg.name})"
        qd = randn((4, 1, a_kvh, a_grp, a_hd), a_hd ** -0.5, torch.bfloat16)
        qdh = qd.reshape(4, 1, a_heads, a_hd).transpose(1, 2)
        dmask = live[:, None, None, :].expand(4, a_heads, 1, s_cache)
        kc, vc = (randn((4, s_cache, a_kvh, a_hd), dtype=torch.bfloat16) for _ in range(2))
        kr, vr = (c.transpose(1, 2).repeat_interleave(a_grp, 1) for c in (kc, vc))
        splits = {"splits": af.decode_splits(4, a_kvh, s_cache, sms)}
        check("flash_decode", f"decode B=4 linear {s_cache} {shape}",
              lambda: af.flash_decode(qd, kc, vc, pos),
              lambda: af.flash_decode_plain(qd, kc, vc, pos),
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  qdh, kr, vr, attn_mask=dmask, scale=1.0),
              ATTN_BOUND, 4 * n_live * a_grp * a_hd * a_kvh,
              qd.numel() * 2 + 2 * n_live * a_kvh * a_hd * 2 + qd.numel() * 4,
              control=lambda: af.flash_decode_plain(qd, kc, vc, pos - 1),
              library_call="scaled_dot_product_attention, kv heads repeated (not timed)",
              extra=splits)
        del kc, vc, kr, vr
        if acfg is wcfg_full:
            # whisper's paged decode: 8-row bf16 pages behind a shuffled table
            n_log = paged.num_logical_pages(s_cache, ps)
            table_p = (1 + torch.randperm(4 * n_log, generator=gen, device=dev)
                       ).reshape(4, n_log)
            table_p = torch.where(torch.arange(n_log, device=dev)[None, :] * ps
                                  <= pos.long()[:, None], table_p,
                                  torch.zeros_like(table_p)).to(torch.int32)
            n_pages = int((table_p > 0).sum())
            pcache = paged.init_paged(4, s_cache, a_kvh, a_hd, page_size=ps,
                                      num_pages=1 + 4 * n_log, device=dev)
            pcache.page_table = table_p
            pcache.k_pages, pcache.v_pages = (
                randn((1 + 4 * n_log, ps, a_kvh, a_hd), dtype=torch.bfloat16) for _ in range(2))
            kr, vr = (x.to(torch.bfloat16).transpose(1, 2).repeat_interleave(a_grp, 1)
                      for x in paged.gather_dense(pcache))
            check("flash_paged_decode", f"paged decode B=4 linear {s_cache} page {ps} bf16 "
                  f"pages {shape}",
                  lambda: ap.flash_paged_decode(qd, pcache, pos),
                  lambda: ap.flash_paged_decode_plain(qd, pcache, pos),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      qdh, kr, vr, attn_mask=dmask, scale=1.0),
                  ATTN_BOUND, 4 * n_live * a_grp * a_hd * a_kvh,
                  qd.numel() * 2 + 2 * n_live * a_kvh * a_hd * 2 + n_pages * 4
                  + qd.numel() * 4,
                  control=lambda: ap.flash_paged_decode_plain(qd, pcache, pos - 1),
                  library_call="scaled_dot_product_attention on the cache gathered dense "
                               "(bf16), gather not timed", extra=splits)
            del pcache, kr, vr
        del qd, qdh
    # whisper's cross K/V projection of the encoder's output (sm90)
    x = randn((w_seq, w_d), dtype=torch.bfloat16)
    w = randn((w_d, w_d), w_d ** -0.5)
    w16 = w.to(torch.bfloat16)
    check("gemm_tiled", f"cross K/V projection {w_seq}x{w_d}x{w_d} ({wcfg_full.name})",
          lambda: gt.gemm_tiled(x, w), lambda: gt.gemm_tiled_plain(x, w),
          lambda: torch.matmul(x, w16), GEMM_BOUND, 2 * w_seq * w_d * w_d,
          x.numel() * 2 + w.numel() * 4 + w_seq * w_d * 4, loop="sm90")
    del x, w, w16
    # internvl2's decode MLP: up (wi, wg) and down
    i_d, i_ff = icfg_full.d_model, icfg_full.d_ff
    for kk, nn in ((i_d, i_ff), (i_ff, i_d)):
        a4 = randn((4, kk), dtype=torch.bfloat16)
        w = randn((kk, nn), kk ** -0.5)
        w16 = w.to(torch.bfloat16)
        check("gemm_tiled", f"decode mlp {'up' if kk == i_d else 'down'} 4x{kk}x{nn} "
              f"({icfg_full.name})", lambda: gt.gemm_tiled(a4, w),
              lambda: gt.gemm_tiled_plain(a4, w), lambda: torch.matmul(a4, w16), GEMM_BOUND,
              2 * 4 * kk * nn, a4.numel() * 2 + w.numel() * 4 + 4 * nn * 4, loop="splitk")
        del w, w16
    # the refine_ab decode unembeds: whisper's tied 51865-row table (the last
    # 25 columns are a partial tile; their error is recorded apart) and
    # internvl2's 128256 x 8192 table, f32, NT
    for acfg in (wcfg_full, icfg_full):
        a_d, a_vocab = acfg.d_model, acfg.vocab_size
        xn4 = randn((4, a_d), dtype=torch.bfloat16)
        table = randn((a_vocab, a_d), a_d ** -0.5)
        tail = a_vocab % 64
        tail_err = (gr.gemm_refined(xn4, table.t(), policy="refine_ab")[:, -tail:]
                    - gr.gemm_refined_plain(xn4, table[-tail:].t(), "refine_ab")
                    ).abs().max().item() if tail else None
        check("gemm_refined", f"decode unembed refine_ab 4x{a_d}x{a_vocab} NT ({acfg.name})",
              lambda: gr.gemm_refined(xn4, table.t(), policy="refine_ab"),
              lambda: gr.gemm_refined_plain(xn4, table.t(), "refine_ab"),
              lambda: torch.matmul(xn4.float(), table.t()), GEMM_BOUND,
              refined_flops(xn4, table, 4, a_vocab, a_d),
              xn4.numel() * 2 + table.numel() * 4 + 4 * a_vocab * 4, loop="splitk",
              extra={**refined_extra(4, a_vocab, a_d),
                     **({"tail_cols": tail, "tail_cols_err": tail_err} if tail else {})})
        if tail and not tail_err <= GEMM_BOUND:
            fail(f"gemm_refined {acfg.name} unembed: the last {tail} columns part by "
                 f"{tail_err} > {GEMM_BOUND}")
        del table, xn4
    torch.cuda.empty_cache()

    # ---- the flash backward at the shapes the trainings of phases 17-20 give
    # it: whisper's encoder (B = 2, 1500 frames, no mask, hd 64, 16 heads on
    # 16 kv), its cross-attention (Sq 448 against Skv 1500: dk/dv summed over
    # seven 64-row query tiles), zamba2's shared block (S = 1024 causal, hd
    # 112: a 48-column tail past one 64-column block, 32 heads on 32 kv) and
    # internvl2's 64 heads on 8 kv (G = 8, hd 128, S = 512 causal), on the
    # forward kernel's own out and lse; dO ~ 1e-2 as on gemma3's rows.
    # Yardstick: SDPA's backward through autograd (kv heads repeated for G >
    # 1, so it also computes dk/dv per query head; the repeat is outside the
    # timed call).  Control: the plain version with the mask flipped (causal
    # for the unmasked shapes).  Then whisper's train unembed dX at refine_ab
    # onto its 51865-row tied table (K = 51865).
    def train_bwd_rows(acfg, b, sq, skv, causal, what):
        a_heads, a_kvh, a_hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
        a_grp = a_heads // a_kvh
        q = randn((b, sq, a_kvh, a_grp, a_hd), a_hd ** -0.5, torch.bfloat16)
        k, v = (randn((b, skv, a_kvh, a_hd), dtype=torch.bfloat16) for _ in range(2))
        do = randn((b, sq, a_kvh, a_grp, a_hd), 1e-2)
        out, lse = af.flash_attention_fwd(q, k, v, causal=causal)
        di = af.bwd_delta(out, do)
        pairs = (sq * (sq + 1) // 2 if causal else sq * skv) * b * a_heads
        qh = q.reshape(b, sq, a_heads, a_hd).transpose(1, 2).detach().requires_grad_(True)
        kr, vr = (c.transpose(1, 2).repeat_interleave(a_grp, 1).detach().requires_grad_(True)
                  for c in (k, v))
        sd_out = torch.nn.functional.scaled_dot_product_attention(qh, kr, vr, is_causal=causal,
                                                                  scale=1.0)
        do_h = do.reshape(b, sq, a_heads, a_hd).transpose(1, 2).to(torch.bfloat16)
        lib = {"library_backend": sdpa_backend(qh, kr, vr, is_causal=causal, scale=1.0)}
        in_bytes = (q.numel() + k.numel() + v.numel()) * 2 + do.numel() * 4 + 2 * lse.numel() * 4
        tag = (f"{what} B={b} Sq={sq} Skv={skv} H={a_heads} Kv={a_kvh} hd={a_hd} "
               f"{'causal' if causal else 'no mask'} ({acfg.name})")
        lib_call = ("SDPA backward through autograd" + (
            ", kv heads repeated (dk/dv per query head)" if a_grp > 1 else ""))
        check("flash_attention_bwd_dq", tag,
              lambda: af.flash_attention_bwd_dq(q, k, v, do, lse, di, causal=causal),
              lambda: af.flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal=causal),
              lambda: torch.autograd.grad(sd_out, (qh,), do_h, retain_graph=True),
              ATTN_BWD_DQ_BOUND, 6 * pairs * a_hd, in_bytes + q.numel() * 4,
              control=lambda: af.flash_attention_bwd_dq_plain(q, k, v, do, lse, di,
                                                              causal=not causal),
              extra=lib, loop="sm90", library_call=lib_call)
        check("flash_attention_bwd_dkv", tag,
              lambda: af.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal=causal),
              lambda: af.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal=causal),
              lambda: torch.autograd.grad(sd_out, (kr, vr), do_h, retain_graph=True),
              ATTN_BWD_DKV_BOUND, 8 * pairs * a_hd, in_bytes + 2 * k.numel() * 4,
              control=lambda: af.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di,
                                                               causal=not causal),
              extra={**lib, "dkv_per_head": af._dkv_per_head(b, skv, a_kvh, a_grp, dev.index)},
              loop="sm90", library_call=lib_call)
        del q, k, v, do, out, lse, di, qh, kr, vr, sd_out, do_h

    zcfg_full = get_config("zamba2-7b")
    train_bwd_rows(wcfg_full, 2, w_seq, w_seq, False, "encoder train")
    train_bwd_rows(wcfg_full, 2, WHISPER_TRAIN_SEQ, w_seq, False, "cross train")
    train_bwd_rows(zcfg_full, 1, 1024, 1024, True, "shared block train")
    train_bwd_rows(icfg_full, 1, 512, 512, True, "train")
    torch.cuda.empty_cache()
    m_w = 2 * WHISPER_TRAIN_SEQ
    g_log = randn((m_w, wcfg_full.vocab_size), wcfg_full.vocab_size ** -0.5)
    table = randn((wcfg_full.vocab_size, w_d), w_d ** -0.5)
    check("gemm_refined", f"train unembed dX refine_ab {m_w}x{wcfg_full.vocab_size}x{w_d} "
          f"({wcfg_full.name})",
          lambda: gr.gemm_refined(g_log, table, policy="refine_ab"),
          lambda: gr.gemm_refined_plain(g_log, table, "refine_ab"),
          lambda: torch.matmul(g_log, table), GEMM_BOUND,
          refined_flops(g_log, table, m_w, w_d, wcfg_full.vocab_size),
          (g_log.numel() + table.numel() + m_w * w_d) * 4, loop="sm90",
          extra=refined_extra(m_w, w_d, wcfg_full.vocab_size))
    del g_log, table
    torch.cuda.empty_cache()

    # ---- the shapes of phases 25-27.  dbrx-132b: the grouped wi at 16
    # experts, top-4 (6144 -> 10752), at a decode tick (4 rows x top-4 =
    # 16, 16-row tiles on the split-K weight stream, given the real counts:
    # the bound counts only the live experts' weights) and at a 700-token
    # prefill (T*k = 2800, 128-row tiles on the wgmma mainloop), group sizes
    # from a seeded skewed draw over the 16, padding rows zero, the
    # neighbouring expert's weights as the control.  starcoder2-15b: the flash
    # forward and decode at 48 heads on 4 kv heads (G = 12, hd 128).
    # command-r-35b: the refine_ab decode unembed, 4 x 8192 against its
    # 256000 x 8192 f32 table (the plain version over vocab chunks).
    dcfg_full = get_config("dbrx-132b")
    d_exp, d_dm, d_ff = dcfg_full.num_experts, dcfg_full.d_model, dcfg_full.d_ff
    d_rng = np.random.default_rng(25)
    d_gen = torch.Generator(device=dev).manual_seed(25)
    w_in = randn((d_exp, d_dm, d_ff), d_dm ** -0.5, generator=d_gen)
    w_in_rolled = w_in.roll(-1, 0)
    w_in16 = w_in.to(torch.bfloat16)
    for tk, phase, bm_at in ((dcfg_full.top_k * 4, "decode", None), (700 * dcfg_full.top_k,
                                                                     "prefill", 128)):
        picked_bm = ops.grouped_tiles(grouped_route, tk, d_ff, d_dm).bm
        bm = bm_at or picked_bm
        counts = d_rng.multinomial(tk, d_rng.dirichlet(np.full(d_exp, 0.6)))
        aligned = ops.align_group_counts(counts, bm)
        off = torch.from_numpy(np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)).to(dev)
        valid = torch.zeros(ops.round_up(tk, bm) + d_exp * bm, dtype=torch.bool, device=dev)
        for g in range(d_exp):
            valid[int(off[g]):int(off[g]) + int(counts[g])] = True
        x = randn((valid.shape[0], d_dm), dtype=torch.bfloat16, generator=d_gen) * valid[:, None]
        cnt = torch.from_numpy(counts).to(dev, torch.int32) if phase == "decode" else None
        lib, lib_name = grouped_mm_library(x, w_in16, off[1:], "forward")
        check("grouped_gemm", f"{phase} wi bf16 T*k={tk} {d_dm}->{d_ff} E={d_exp} bm={bm} "
              f"counts {counts.tolist()} ({dcfg_full.name})",
              lambda x=x, off=off, bm=bm, c=cnt: gg.grouped_gemm(x, w_in, off, bm=bm,
                                                                 group_counts=c),
              lambda x=x, off=off, bm=bm: gg.grouped_gemm_plain(x, w_in, off, bm=bm),
              lib, GEMM_BOUND, 2 * tk * d_dm * d_ff,
              tk * d_dm * 2 + int((counts > 0).sum()) * d_dm * d_ff * 4 + x.shape[0] * d_ff * 4,
              control=lambda x=x, off=off, bm=bm: gg.grouped_gemm_plain(x, w_in_rolled, off,
                                                                        bm=bm),
              library_call=lib_name, loop="splitk" if phase == "decode" else "sm90",
              extra={"live_experts": int((counts > 0).sum()), "dispatcher_bm": picked_bm,
                     "buffer_rows": int(x.shape[0]),
                     **({"splits": gg.grouped_splits(x.shape[0], d_ff, d_dm, sms)}
                        if phase == "decode" else {})})
        del x, lib
    del w_in, w_in_rolled, w_in16
    torch.cuda.empty_cache()
    scfg_full = get_config("starcoder2-15b")
    causal_prefill_row(scfg_full, 700)
    a_heads, a_kvh, a_hd = scfg_full.num_heads, scfg_full.num_kv_heads, scfg_full.head_dim
    a_grp = a_heads // a_kvh
    qd = randn((4, 1, a_kvh, a_grp, a_hd), a_hd ** -0.5, torch.bfloat16)
    kc, vc = (randn((4, s_cache, a_kvh, a_hd), dtype=torch.bfloat16) for _ in range(2))
    kr, vr = (c.transpose(1, 2).repeat_interleave(a_grp, 1) for c in (kc, vc))
    check("flash_decode", f"decode B=4 linear {s_cache} H={a_heads} Kv={a_kvh} hd={a_hd} "
          f"({scfg_full.name})",
          lambda: af.flash_decode(qd, kc, vc, pos), lambda: af.flash_decode_plain(qd, kc, vc, pos),
          lambda: torch.nn.functional.scaled_dot_product_attention(
              qd.reshape(4, 1, a_heads, a_hd).transpose(1, 2), kr, vr,
              attn_mask=live[:, None, None, :].expand(4, a_heads, 1, s_cache), scale=1.0),
          ATTN_BOUND, 4 * n_live * a_grp * a_hd * a_kvh,
          qd.numel() * 2 + 2 * n_live * a_kvh * a_hd * 2 + qd.numel() * 4,
          control=lambda: af.flash_decode_plain(qd, kc, vc, pos - 1),
          library_call="scaled_dot_product_attention, kv heads repeated (not timed)",
          extra={"splits": af.decode_splits(4, a_kvh, s_cache, sms)})
    del qd, kc, vc, kr, vr
    ccfg_full = get_config("command-r-35b")
    c_d, c_vocab = ccfg_full.d_model, ccfg_full.vocab_size
    xc4 = randn((4, c_d), dtype=torch.bfloat16)
    table = randn((c_vocab, c_d), c_d ** -0.5)
    check("gemm_refined", f"decode unembed refine_ab 4x{c_d}x{c_vocab} NT ({ccfg_full.name})",
          lambda: gr.gemm_refined(xc4, table.t(), policy="refine_ab"),
          lambda: vocab_chunked(lambda t: gr.gemm_refined_plain(xc4, t.t(), "refine_ab"), table),
          lambda: torch.matmul(xc4.float(), table.t()), GEMM_BOUND,
          refined_flops(xc4, table, 4, c_vocab, c_d),
          xc4.numel() * 2 + table.numel() * 4 + 4 * c_vocab * 4, loop="splitk",
          library_call="f32 SGEMM on an f32 copy of x (TF32 off)",
          extra={**refined_extra(4, c_vocab, c_d),
                 "plain": "gemm_refined_plain over 32768-row vocab chunks"})
    del table, xc4
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 4 serve
    policy = ops.ExecutionPolicy(
        default="bf16", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"},
        require={"attention": ("decode",)})
    t0 = time.monotonic()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    n_params = sum(t.numel() for t in leaves(params))
    init_s = time.monotonic() - t0
    eng = ServeEngine(cfg, batch_size=4, max_ctx=1024, policy=policy, device=dev)
    eng.load(params)
    eng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])

    rng = np.random.default_rng(0)
    lens = prompt_lens(rng)
    reqs = [Request(rid=i, prompt=rng.integers(2, vocab, int(n)).astype(np.int32),
                    max_new_tokens=32) for i, n in enumerate(lens)]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    stats = eng.run(reqs)
    launches = read_launches(mods)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(r.done and len(r.out_tokens) == 32 for r in reqs):
        fail(f"not every request finished with 32 tokens: "
             f"{[(r.rid, r.done, len(r.out_tokens)) for r in reqs]}")
    if any(not 0 <= t < vocab for r in reqs for t in r.out_tokens):
        fail("a token outside the vocabulary")
    if not all(launches[n] > 0 for n in SERVE_KERNELS):
        fail(f"a kernel of the serve path never launched: {launches}")

    # one prompt's prefill logits: kernel routes vs torch reference routes
    prompt = {"tokens": torch.as_tensor(reqs[0].prompt, device=dev)[None].long()}
    ref_policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab")
    with torch.no_grad():
        lk, _ = serve_step.make_prefill(cfg, policy, s_ctx=1024)(params, prompt)
        lr, _ = serve_step.make_prefill(cfg, ref_policy, s_ctx=1024)(params, prompt)
    torch.cuda.synchronize(dev)
    if lk.shape != (1, 1, vocab) or not torch.isfinite(lk).all():
        fail(f"prefill logits shape {tuple(lk.shape)} or non-finite")
    logit_err = (lk - lr).abs().max().item()
    # faulty controls on the torch routes, which the bound must see: a
    # rung fault (fp8 MLPs) and a mask fault (a window one key short)
    with torch.no_grad():
        l_fp8, _ = serve_step.make_prefill(
            cfg, ops.ExecutionPolicy(default="bf16", mlp="fp8", logits="refine_ab"),
            s_ctx=1024)(params, prompt)
        l_win, _ = serve_step.make_prefill(
            dataclasses.replace(cfg, window=cfg.window - 1), ref_policy,
            s_ctx=1024)(params, prompt)
    fp8_err = (l_fp8 - lr).abs().max().item()
    window_err = (l_win - lr).abs().max().item()
    top2 = lr.flatten().topk(2).values
    emit(phase="serve", arch=cfg.name, params=n_params, weights_gb=n_params * 4 / 1e9,
         init_s=init_s, requests=stats["requests"], prompt_lens=[int(n) for n in lens],
         tokens=stats["tokens"], ticks=stats["ticks"], wall_s=stats["wall_s"],
         tok_per_s=stats["tok_per_s"], ttft_mean_s=stats["ttft_mean_s"],
         latency_mean_s=stats["latency_mean_s"], peak_mem_gb=peak_gb,
         launches=launches, prefill_logits_max_abs_err=logit_err,
         prefill_logits_bound=LOGITS_BOUND,
         prefill_argmax_agrees=bool(lk.argmax() == lr.argmax()),
         reference_top2_gap=(top2[0] - top2[1]).item(),
         control_fp8_mlp_err=fp8_err, control_window_short_err=window_err,
         logits_absmax=lr.abs().max().item())
    if not logit_err <= LOGITS_BOUND:
        fail(f"prefill logits: kernel routes vs torch routes {logit_err} > {LOGITS_BOUND}")
    if lk.argmax() != lr.argmax():
        fail("prefill logits: the kernel routes pick another greedy token than the torch routes")
    for control, err in (("fp8-MLP", fp8_err), ("short-window", window_err)):
        if not err > LOGITS_BOUND:
            fail(f"prefill logits: the {control} control ({err}) is within {LOGITS_BOUND}")

    # ------------------------------------------------------- 5 serve_paged
    # The same model, requests and slots from a paged KV cache: (a) bf16
    # pages on the serve policy, token for token the dense engine's; (b)
    # int8 pages with fp8x3 MLPs, every request finished.
    def serve_paged(pol, quant):
        e = ServeEngine(cfg, batch_size=4, max_ctx=1024, policy=pol, device=dev,
                        kv_layout="paged", kv_page_size=8, kv_quant=quant)
        e.load(params)
        e.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
        rs = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=32) for r in reqs]
        zero_launches(mods)
        torch.cuda.reset_peak_memory_stats(dev)
        st = e.run(rs)
        run_launches = read_launches(mods)
        tables_clear = all(not bool(t.any()) for t in e._tables.values())
        return e, rs, st, run_launches, {
            "requests": st["requests"], "tokens": st["tokens"], "ticks": st["ticks"],
            "wall_s": st["wall_s"], "tok_per_s": st["tok_per_s"],
            "ttft_mean_s": st["ttft_mean_s"], "latency_mean_s": st["latency_mean_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "pages_outstanding": e.pages_outstanding(), "tables_clear": tables_clear,
            "launches": run_launches}

    paged_policy = ops.ExecutionPolicy(
        default="bf16", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"},
        require={"attention": ("decode", "paged_decode")})
    eng_pa, reqs_a, _, launches_pa, line_a = serve_paged(paged_policy, None)
    tokens_equal = [r.out_tokens for r in reqs_a] == [r.out_tokens for r in reqs]
    int8_policy = ops.ExecutionPolicy(
        default="bf16", mlp="fp8x3", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"},
        require={"attention": ("decode", "paged_decode")})
    eng_pb, reqs_b, _, launches_pb, line_b = serve_paged(int8_policy, "int8")
    # one prompt's prefill logits with fp8x3 MLPs against the bf16-MLP
    # kernel routes (lk), and the single-pass fp8 control on the same routes
    fp8_kernel_policy = ops.ExecutionPolicy(
        default="bf16", mlp="fp8", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"})
    with torch.no_grad():
        l_x3, _ = serve_step.make_prefill(cfg, int8_policy, s_ctx=1024)(params, prompt)
        l_f8, _ = serve_step.make_prefill(cfg, fp8_kernel_policy, s_ctx=1024)(params, prompt)
    torch.cuda.synchronize(dev)
    x3_err = (l_x3 - lk).abs().max().item()
    f8_err = (l_f8 - lk).abs().max().item()
    emit(phase="serve_paged", page_size=8,
         bf16_pages=dict(line_a, policy="default=bf16 logits=refine_ab",
                         tokens_equal_dense=tokens_equal),
         int8_pages=dict(line_b, policy="default=bf16 mlp=fp8x3 logits=refine_ab",
                         finished=[len(r.out_tokens) for r in reqs_b],
                         prefill_logits_fp8x3_err=x3_err,
                         prefill_logits_bound=FP8X3_LOGITS_BOUND,
                         prefill_argmax_agrees=bool(l_x3.argmax() == lk.argmax()),
                         control_fp8_mlp_err=f8_err))
    if not tokens_equal:
        fail("serve_paged (a): the paged engine's tokens differ from the dense engine's: "
             f"{[(r.rid, r.out_tokens[:4]) for r in reqs_a]}")
    for tag, line, need in (("a", line_a, PAGED_KERNELS), ("b", line_b, PAGED_INT8_KERNELS)):
        if line["pages_outstanding"] or not line["tables_clear"]:
            fail(f"serve_paged ({tag}): pages still held after the run: {line}")
        if not all(line["launches"][n] > 0 for n in need):
            fail(f"serve_paged ({tag}): a kernel of the path never launched: {line['launches']}")
    if not all(r.done and len(r.out_tokens) == 32 for r in reqs_b):
        fail(f"serve_paged (b): not every request finished with 32 tokens: "
             f"{[(r.rid, r.done, len(r.out_tokens)) for r in reqs_b]}")
    if any(not 0 <= t < vocab for r in reqs_b for t in r.out_tokens):
        fail("serve_paged (b): a token outside the vocabulary")
    if not (math.isfinite(x3_err) and x3_err <= FP8X3_LOGITS_BOUND < f8_err):
        fail(f"serve_paged (b): fp8x3 prefill logits {x3_err} against the bound "
             f"{FP8X3_LOGITS_BOUND}, whose fp8 control reads {f8_err}")

    # ----------------------------------------------------------- 6 profile
    # Where a 700-token prefill and a 4-slot decode tick spend their time
    # (profile_window, defined with the timers).
    long_prompt = {"tokens": torch.as_tensor(reqs[1].prompt, device=dev)[None].long()}
    with torch.no_grad():
        prefill_prof = profile_window(lambda: eng._prefill(params, long_prompt))

    def tick_profile(e):
        for i in range(4):
            e.submit(Request(rid=100 + i, prompt=reqs[i].prompt, max_new_tokens=16))
        e.step()                                 # admit (prefill) all four
        prof = profile_window(e.tick)
        e.run([])
        return prof

    emit(phase="profile", prefill_tokens=int(long_prompt["tokens"].shape[1]),
         prefill=prefill_prof, decode_tick=tick_profile(eng),
         paged_decode_tick=tick_profile(eng_pa), paged_int8_fp8x3_decode_tick=tick_profile(eng_pb))
    del eng_pa, eng_pb

    # ------------------------------------------------------ 10 serve_naive
    # The same model, requests, slots and context on the paper's unstaged
    # GEMM (gemm=cuda_naive; the refine_ab unembed as four naive bf16
    # passes summed at the router).  No tiled or refined GEMM may launch.
    naive_policy = ops.ExecutionPolicy(
        default="bf16", logits="refine_ab",
        backends={"gemm": "cuda_naive", "attention": "cuda_fused"},
        require={"attention": ("decode",)})
    eng_n = ServeEngine(cfg, batch_size=4, max_ctx=1024, policy=naive_policy, device=dev)
    eng_n.load(params)
    eng_n.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    reqs_n = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=32) for r in reqs]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    stats_n = eng_n.run(reqs_n)
    launches_n = read_launches(mods)
    naive_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    with torch.no_grad():
        l_naive, _ = serve_step.make_prefill(cfg, naive_policy, s_ctx=1024)(params, prompt)
    torch.cuda.synchronize(dev)
    naive_err = (l_naive - lr).abs().max().item()
    emit(phase="serve_naive", arch=cfg.name, policy="default=bf16 logits=refine_ab",
         backends=dict(naive_policy.backends), requests=stats_n["requests"],
         tokens=stats_n["tokens"], ticks=stats_n["ticks"], wall_s=stats_n["wall_s"],
         tok_per_s=stats_n["tok_per_s"], ttft_mean_s=stats_n["ttft_mean_s"],
         latency_mean_s=stats_n["latency_mean_s"], peak_mem_gb=naive_peak_gb,
         launches=launches_n, finished=[len(r.out_tokens) for r in reqs_n],
         requests_with_the_serve_phases_tokens=sum(
             a.out_tokens == b.out_tokens for a, b in zip(reqs_n, reqs)),
         prefill_logits_max_abs_err=naive_err, prefill_logits_bound=LOGITS_BOUND,
         prefill_argmax_agrees=bool(l_naive.argmax() == lr.argmax()),
         decode_tick=tick_profile(eng_n))
    if not all(r.done and len(r.out_tokens) == 32 for r in reqs_n):
        fail(f"serve_naive: not every request finished with 32 tokens: "
             f"{[(r.rid, r.done, len(r.out_tokens)) for r in reqs_n]}")
    if any(not 0 <= t < vocab for r in reqs_n for t in r.out_tokens):
        fail("serve_naive: a token outside the vocabulary")
    if not all(launches_n[k] > 0 for k in SERVE_NAIVE_KERNELS):
        fail(f"serve_naive: a kernel of the path never launched: {launches_n}")
    if launches_n["gemm_tiled"] or launches_n["gemm_refined"]:
        fail(f"serve_naive: a tiled or refined GEMM launched on the naive route: {launches_n}")
    if not naive_err <= LOGITS_BOUND or l_naive.argmax() != lr.argmax():
        fail(f"serve_naive: prefill logits {naive_err} against {LOGITS_BOUND}, or another "
             f"greedy token than the torch routes")
    del eng, eng_n, params, l_naive
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 11 batched
    # The Fig. 7 path through its entry point, kernels.ops.gemm_batched, at
    # n = 16 on torch (one bmm), cuda (packed) and cuda_naive (a warp per
    # matrix), beside f32 torch.bmm with TF32 off (the paper's batched
    # SGEMM).  One call per (G, backend) is the path's run; then the timings.
    batched_in = {g_b: (randn((g_b, 16, 16), dtype=torch.bfloat16),
                        randn((g_b, 16, 16), dtype=torch.bfloat16))
                  for g_b in (256, 1024, 4096, 16384)}
    zero_launches(mods)
    batched_out = {g_b: {be: kops.gemm_batched(a_b, b_b, backend=be)
                         for be in ("torch", "cuda", "cuda_naive")}
                   for g_b, (a_b, b_b) in batched_in.items()}
    torch.cuda.synchronize(dev)
    launches_bt = read_launches(mods)
    batched_rows = []
    for g_b, (a_b, b_b) in batched_in.items():
        outs = batched_out[g_b]
        a32, b32 = a_b.float(), b_b.float()
        ms = {be: timed(lambda be=be: kops.gemm_batched(a_b, b_b, backend=be))
              for be in ("torch", "cuda", "cuda_naive")}
        ms["sgemm_f32_bmm"] = timed(lambda: torch.bmm(a32, b32))
        flops_b = 2 * g_b * 16 ** 3
        batched_rows.append({
            "G": g_b, "n": 16, "ms": ms,
            "tflops": {be: flops_b / (t * 1e-3) / 1e12 for be, t in ms.items()},
            "max_abs_err_vs_torch": {be: (outs[be] - outs["torch"]).abs().max().item()
                                     for be in ("cuda", "cuda_naive")}})
    # ms: CUDA events around back-to-back calls queued behind a spin on the
    # device (``timed``), so the kernels' time and not the host's launches
    emit(phase="batched", n=16, rows=batched_rows, launches=launches_bt, bound=BATCHED_BOUND)
    if not all(launches_bt[k] > 0 for k in BATCHED_KERNELS):
        fail(f"batched: a kernel of the path never launched: {launches_bt}")
    if not all(e <= BATCHED_BOUND for r in batched_rows
               for e in r["max_abs_err_vs_torch"].values()):
        fail(f"batched: a kernel output differs from torch beyond {BATCHED_BOUND}")
    del batched_in, batched_out
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 7 train
    tpolicy, loop = train_setup(cfg, dev, bt, st)

    # step 0: kernel routes vs torch routes on the same params and batch,
    # and a faulty torch-route control (a window one key short)
    tparams, _, _ = loop.init_or_restore(0)
    batch0 = loop.batch(SyntheticLMDataset(loop.data_cfg), 0)
    five = {"embed": tparams["embed"]["table"],
            "local_attn_q": tparams["layers"][0]["wq"]["w"],
            "global_attn_q": tparams["layers"][10]["wq"]["w"],
            "mlp_down": tparams["layers"][1]["wo"]["w"],
            "unembed": tparams["unembed"]["table"]}

    def loss_and_grads(c, pol):
        """(loss, per-token losses, gradients of the five leaves) of one
        forward, as ``lm_loss`` reckons them: f32 logsumexp minus the
        label logit."""
        logits, _, _ = transformer.forward(tparams, batch0["tokens"], c, policy=pol,
                                           mode="train", remat=True)
        logits = logits.float()
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(
            -1, batch0["labels"].long()[..., None])[..., 0]
        del logits
        loss = nll.mean()
        grads = torch.autograd.grad(loss, list(five.values()))
        return loss.item(), nll.detach(), grads

    ref_policy_t = ops.ExecutionPolicy(default="bf16", logits="refine_ab")
    loss_k, nll_k, grads_k = loss_and_grads(cfg, tpolicy)
    loss_t, nll_t, grads_t = loss_and_grads(cfg, ref_policy_t)
    loss_c, nll_c, grads_c = loss_and_grads(dataclasses.replace(cfg, window=cfg.window - 1),
                                            ref_policy_t)

    def rel(a, b):
        return {k: ((x - y).norm() / y.norm()).item() for k, x, y in zip(five, a, b)}

    step0 = {"loss_kernel": loss_k, "loss_torch": loss_t, "loss_err": abs(loss_k - loss_t),
             "token_loss_max_err": (nll_k - nll_t).abs().max().item(),
             "grad_rel_err": rel(grads_k, grads_t),
             "control_window_short_loss_err": abs(loss_c - loss_t),
             "control_window_short_token_loss_max_err": (nll_c - nll_t).abs().max().item(),
             "control_window_short_grad_rel_err": rel(grads_c, grads_t),
             "token_loss_bound": STEP0_TOKEN_LOSS_BOUND, "grad_bound": STEP0_GRAD_BOUND}
    del tparams, five, grads_k, grads_t, grads_c, nll_k, nll_t, nll_c
    torch.cuda.empty_cache()
    emit(phase="train_step0", **step0)
    # read after the train phase, so that one run reports both
    step0_faults = []
    if not (math.isfinite(loss_k) and step0["token_loss_max_err"] <= STEP0_TOKEN_LOSS_BOUND
            and max(step0["grad_rel_err"].values()) <= STEP0_GRAD_BOUND):
        step0_faults.append("kernel routes vs torch routes out of bounds")
    if not (step0["control_window_short_token_loss_max_err"] > STEP0_TOKEN_LOSS_BOUND
            and max(step0["control_window_short_grad_rel_err"].values()) > STEP0_GRAD_BOUND):
        step0_faults.append("the short-window control lands within the bounds")

    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    tparams, topt, history = loop.run(TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize(dev)
    train_wall = time.monotonic() - t0
    train_launches = read_launches(mods)
    train_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_s = sorted(r["step_s"] for r in loop.log)[len(loop.log) // 2]
    ds = SyntheticLMDataset(loop.data_cfg)
    train_prof = profile_window(
        lambda: loop.step_fn(tparams, topt, loop.batch(ds, TRAIN_STEPS))[2]["loss"].item())
    emit(phase="train", arch=cfg.name, steps=TRAIN_STEPS, batch=bt, seq=st, remat=True,
         policy="default=bf16 logits=refine_ab", loss=history,
         grad_norm=[r["grad_norm"] for r in loop.log], lr=[r["lr"] for r in loop.log],
         step_s=[r["step_s"] for r in loop.log], median_step_s=step_s,
         tok_per_s=bt * st / step_s, wall_s=train_wall, peak_mem_gb=train_peak_gb,
         launches=train_launches, profile_step=train_prof)
    if not all(train_launches[n] > 0 for n in TRAIN_KERNELS):
        fail(f"a kernel of the train path never launched: {train_launches}")
    if not all(math.isfinite(x) for r in loop.log for x in (r["loss"], r["grad_norm"])):
        fail(f"non-finite loss or grad norm: {loop.log}")
    if step0_faults:
        fail(f"step 0: {'; '.join(step0_faults)}: {step0}")
    del tparams, topt

    # ---------------------------------------------------------- 8 serve_moe
    # Mixtral at full width, depth cut to MOE_SERVE_DEPTH layers (the 32
    # of the full model take 186 GB in f32), on the kernel routes with the
    # experts on cuda_grouped.
    mixtral, moe_backends, mpolicy, mreqs = moe_setup(mcfg_full, lens)

    def rolled_experts(p, layer):
        """A shallow copy of ``p`` whose layer ``layer`` routes every
        group to the neighbouring expert's weights."""
        q = dict(p, layers=list(p["layers"]))
        q["layers"][layer] = dict(q["layers"][layer], **{
            k: {"w": w.detach().roll(-1, 0).requires_grad_(w.requires_grad)}
            for k, w in ((k, q["layers"][layer][k]["w"]) for k in ("wi", "wg", "wo"))})
        return q

    moe_faults = []
    mcfg = mixtral(MOE_SERVE_DEPTH)
    mvocab = mcfg.vocab_size
    # the reference drops nothing: capacity = T (capacity_factor = E / k)
    mcfg_dropless = dataclasses.replace(mcfg, capacity_factor=mcfg.num_experts / mcfg.top_k)
    t0 = time.monotonic()
    mparams = api.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    m_init_s = time.monotonic() - t0
    m_n_params = sum(t.numel() for t in leaves(mparams))
    meng = ServeEngine(mcfg, batch_size=4, max_ctx=1024, policy=mpolicy, device=dev)
    meng.load(mparams)
    meng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    mstats = meng.run(mreqs)
    launches_ms = read_launches(mods)
    m_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(r.done and len(r.out_tokens) == 32 for r in mreqs):
        fail(f"serve_moe: not every request finished with 32 tokens: "
             f"{[(r.rid, r.done, len(r.out_tokens)) for r in mreqs]}")
    if any(not 0 <= t < mvocab for r in mreqs for t in r.out_tokens):
        fail("serve_moe: a token outside the vocabulary")
    if not all(launches_ms[n] > 0 for n in SERVE_MOE_KERNELS):
        fail(f"serve_moe: a kernel of the path never launched: {launches_ms}")
    grouped_loops_ok(launches_ms, "serve_moe")

    # one prompt's prefill logits: kernel routes vs torch routes (dropless),
    # and the rolled-experts control; the experts each token of the first
    # MoE layer picks, counted during the kernel-route prefill
    mprompt = {"tokens": torch.as_tensor(mreqs[0].prompt, device=dev)[None].long()}
    top_k_fn = moe_mod._top_k

    def recording_top_k(store):
        """moe's top-k, each call's expert ids appended to ``store``."""
        def top_k(probs, k):
            vals, idx = top_k_fn(probs, k)
            store.append(idx.detach())
            return vals, idx
        return top_k

    picked = []
    mref_policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab")
    moe_mod._top_k = recording_top_k(picked)
    try:
        with torch.no_grad():
            mlk, _ = serve_step.make_prefill(mcfg, mpolicy, s_ctx=1024)(mparams, mprompt)
    finally:
        moe_mod._top_k = top_k_fn
    first_counts = torch.bincount(picked[0].flatten(), minlength=mcfg.num_experts).tolist()
    with torch.no_grad():
        mlr, _ = serve_step.make_prefill(mcfg_dropless, mref_policy, s_ctx=1024)(mparams, mprompt)
        mlc, _ = serve_step.make_prefill(mcfg_dropless, mref_policy, s_ctx=1024)(
            rolled_experts(mparams, 1), mprompt)
    torch.cuda.synchronize(dev)
    if mlk.shape != (1, 1, mvocab) or not torch.isfinite(mlk).all():
        fail(f"serve_moe: prefill logits shape {tuple(mlk.shape)} or non-finite")
    m_err = (mlk - mlr).abs().max().item()
    m_ctrl = (mlc - mlr).abs().max().item()
    mtop2 = mlr.flatten().topk(2).values
    emit(phase="serve_moe", arch=mcfg.name, depth=MOE_SERVE_DEPTH, params=m_n_params,
         weights_gb=m_n_params * 4 / 1e9, init_s=m_init_s, requests=mstats["requests"],
         prompt_lens=[int(n) for n in lens], tokens=mstats["tokens"], ticks=mstats["ticks"],
         wall_s=mstats["wall_s"], tok_per_s=mstats["tok_per_s"],
         ttft_mean_s=mstats["ttft_mean_s"], latency_mean_s=mstats["latency_mean_s"],
         peak_mem_gb=m_peak_gb, launches=launches_ms,
         prefill_tokens=int(mprompt["tokens"].shape[1]),
         prefill_expert_counts_first_moe_layer=first_counts,
         prefill_logits_max_abs_err=m_err, prefill_logits_bound=MOE_LOGITS_BOUND,
         prefill_argmax_agrees=bool(mlk.argmax() == mlr.argmax()),
         reference_top2_gap=(mtop2[0] - mtop2[1]).item(),
         control_rolled_experts_err=m_ctrl, logits_absmax=mlr.abs().max().item())
    if not m_err <= MOE_LOGITS_BOUND:
        moe_faults.append(f"serve_moe prefill logits {m_err} > {MOE_LOGITS_BOUND}")
    if mlk.argmax() != mlr.argmax():
        moe_faults.append("serve_moe: the kernel routes pick another greedy token")
    if not m_ctrl > MOE_LOGITS_BOUND:
        moe_faults.append(f"serve_moe: the rolled-experts control ({m_ctrl}) is within "
                          f"{MOE_LOGITS_BOUND}")

    long_mprompt = {"tokens": torch.as_tensor(mreqs[1].prompt, device=dev)[None].long()}
    with torch.no_grad():
        m_prefill_prof = profile_window(lambda: meng._prefill(mparams, long_mprompt))
    for i in range(4):
        meng.submit(Request(rid=100 + i, prompt=mreqs[i].prompt, max_new_tokens=16))
    meng.step()                                 # admit (prefill) all four
    zero_launches(mods)
    m_tick_prof = profile_window(meng.tick)
    tick_grouped = {loop: gg.LAUNCHES_BY_LOOP[loop] for loop in gt.MAINLOOPS}
    meng.run([])
    emit(phase="profile_moe", arch=mcfg.name, depth=MOE_SERVE_DEPTH,
         prefill_tokens=int(long_mprompt["tokens"].shape[1]), prefill=m_prefill_prof,
         decode_tick=m_tick_prof, decode_ticks_grouped_by_loop=tick_grouped)
    # the two decode ticks' grouped calls (wi, wg, wo a layer) all ran the
    # split-K weight stream
    if tick_grouped["splitk"] != 2 * 3 * MOE_SERVE_DEPTH or sum(tick_grouped.values()) != \
            tick_grouped["splitk"]:
        fail(f"profile_moe: the decode ticks' grouped calls ran {tick_grouped}, expected "
             f"{2 * 3 * MOE_SERVE_DEPTH} splitk")
    del meng

    # ---- serve_moe_paged: the same params, requests and slots from 8-row
    # bf16 pages (the attention sublayers paged, the MoE sublayers holding
    # nothing): every request's tokens must equal the dense serve_moe's
    # and every page must come back.
    moe_paged_policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab",
                                           backends=moe_backends,
                                           require={"attention": ("decode", "paged_decode")})
    peng = ServeEngine(mcfg, batch_size=4, max_ctx=1024, device=dev, kv_layout="paged",
                       kv_page_size=8, policy=moe_paged_policy)
    peng.load(mparams)
    preqs = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=32) for r in mreqs]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    pmstats = peng.run(preqs)
    launches_pm = read_launches(mods)
    emit(phase="serve_moe_paged", arch=mcfg.name, depth=MOE_SERVE_DEPTH, page_size=8,
         requests=pmstats["requests"], tokens=pmstats["tokens"], ticks=pmstats["ticks"],
         wall_s=pmstats["wall_s"], tok_per_s=pmstats["tok_per_s"],
         ttft_mean_s=pmstats["ttft_mean_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, launches=launches_pm,
         tokens_equal_dense=[r.out_tokens == d.out_tokens for r, d in zip(preqs, mreqs)],
         pages_outstanding=peng.pages_outstanding())
    if not all(r.out_tokens == d.out_tokens for r, d in zip(preqs, mreqs)):
        fail("serve_moe_paged: tokens differ from the dense serve_moe's")
    if peng.pages_outstanding():
        fail("serve_moe_paged: pages still held after every request finished")
    if not all(launches_pm[n] > 0 for n in SERVE_MOE_PAGED_KERNELS):
        fail(f"serve_moe_paged: a kernel of the path never launched: {launches_pm}")
    grouped_loops_ok(launches_pm, "serve_moe_paged")
    del peng, mparams, mlk, mlr, mlc
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 9 train_moe
    tmcfg = mixtral(MOE_TRAIN_DEPTH)
    tmcfg_dropless = dataclasses.replace(tmcfg, capacity_factor=tmcfg.num_experts / tmcfg.top_k)
    mt_policy = execution_policy_for(
        tmcfg, default="bf16", logits="refine_ab", backends=moe_backends,
        require={fam: ("vjp",) for fam in ops.families()})
    mloop = TrainLoop(tmcfg, policy=mt_policy,
                      opt_cfg=adamw.AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS),
                      data_cfg=DataConfig(global_batch=1, seq_len=1024, vocab_size=mvocab),
                      remat=True, device=dev)
    mtparams, _, _ = mloop.init_or_restore(0)
    mbatch0 = mloop.batch(SyntheticLMDataset(mloop.data_cfg), 0)
    mfive = ("router", "wi", "wg", "wo", "attn_q")

    def moe_leaves(p):
        return [p["layers"][1][k]["w"] for k in ("router", "wi", "wg", "wo")] + [
            p["layers"][0]["wq"]["w"]]

    def pinned_top_k(picks, own):
        """moe's top-k replaying ``picks`` (one per call, in call order):
        the experts come from ``picks``, the gates are this route's own
        probabilities there; the ids this route would pick itself are
        appended to ``own``."""
        calls = iter(picks)

        def top_k(probs, k):
            own.append(top_k_fn(probs, k)[1].detach())
            idx = next(calls)
            return probs.gather(-1, idx), idx
        return top_k

    def moe_loss_and_grads(c, pol, p, top_k):
        """(per-token losses, aux loss, gradients of the five leaves of the
        total loss lm + AUX_LOSS_WEIGHT aux) of one forward, with ``top_k``
        as moe's router."""
        moe_mod._top_k = top_k
        try:
            logits, _, aux = transformer.forward(p, mbatch0["tokens"], c, policy=pol,
                                                 mode="train", remat=True)
            logits = logits.float()
            nll = torch.logsumexp(logits, dim=-1) - logits.gather(
                -1, mbatch0["labels"].long()[..., None])[..., 0]
            del logits
            grads = torch.autograd.grad(nll.mean() + api.AUX_LOSS_WEIGHT * aux,
                                        moe_leaves(p))
        finally:
            moe_mod._top_k = top_k_fn
        return nll.detach(), aux.item(), grads

    def flipped(a, b):
        """Tokens routed to another expert set, per MoE layer."""
        return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum()) for x, y in zip(a, b)]

    # the kernel routes' picks: each MoE layer's forward, then the remat
    # recompute in the backward (last layer first), which must repeat them
    mp_k, mp_t = [], []
    mnll_k, maux_k, mg_k = moe_loss_and_grads(tmcfg, mt_policy, mtparams, recording_top_k(mp_k))
    remat_same = (len(mp_k) == 2 * MOE_TRAIN_DEPTH
                  and flipped(mp_k[:MOE_TRAIN_DEPTH], mp_k[MOE_TRAIN_DEPTH:][::-1])
                  == [0] * MOE_TRAIN_DEPTH)
    mnll_t, maux_t, mg_t = moe_loss_and_grads(tmcfg_dropless, mref_policy, mtparams,
                                              pinned_top_k(mp_k, mp_t))
    mnll_c, maux_c, mg_c = moe_loss_and_grads(tmcfg_dropless, mref_policy,
                                              rolled_experts(mtparams, 1),
                                              pinned_top_k(mp_k, []))

    def mrel(a, b):
        return {k: ((x - y).norm() / y.norm()).item() for k, x, y in zip(mfive, a, b)}

    mstep0 = {"loss_kernel": mnll_k.mean().item(), "loss_torch": mnll_t.mean().item(),
              "aux_kernel": maux_k, "aux_torch": maux_t, "aux_err": abs(maux_k - maux_t),
              "token_loss_max_err": (mnll_k - mnll_t).abs().max().item(),
              "grad_rel_err": mrel(mg_k, mg_t),
              "remat_recompute_routes_same": remat_same,
              "tokens_torch_routes_would_route_apart_per_layer": flipped(
                  mp_k[:MOE_TRAIN_DEPTH], mp_t[:MOE_TRAIN_DEPTH]),
              "control_rolled_experts_aux_err": abs(maux_c - maux_t),
              "control_rolled_experts_token_loss_max_err": (mnll_c - mnll_t).abs().max().item(),
              "control_rolled_experts_grad_rel_err": mrel(mg_c, mg_t),
              "token_loss_bound": MOE_STEP0_TOKEN_LOSS_BOUND, "aux_bound": MOE_STEP0_AUX_BOUND,
              "grad_bound": MOE_STEP0_GRAD_BOUND}
    del mtparams, mg_k, mg_t, mg_c, mnll_k, mnll_t, mnll_c, mp_k, mp_t
    torch.cuda.empty_cache()
    emit(phase="train_moe_step0", arch=tmcfg.name, depth=MOE_TRAIN_DEPTH, **mstep0)
    if not (math.isfinite(mstep0["loss_kernel"]) and remat_same
            and mstep0["token_loss_max_err"] <= MOE_STEP0_TOKEN_LOSS_BOUND
            and mstep0["aux_err"] <= MOE_STEP0_AUX_BOUND
            and max(mstep0["grad_rel_err"].values()) <= MOE_STEP0_GRAD_BOUND):
        moe_faults.append("train_moe step 0: kernel routes vs torch routes out of bounds")
    if not (mstep0["control_rolled_experts_token_loss_max_err"] > MOE_STEP0_TOKEN_LOSS_BOUND
            and max(mstep0["control_rolled_experts_grad_rel_err"].values())
            > MOE_STEP0_GRAD_BOUND):
        moe_faults.append("train_moe step 0: the rolled-experts control lands within the bounds")

    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    _, _, mhistory = mloop.run(TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize(dev)
    mtrain_wall = time.monotonic() - t0
    launches_mt = read_launches(mods)
    mt_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    mstep_s = sorted(r["step_s"] for r in mloop.log)[len(mloop.log) // 2]
    emit(phase="train_moe", arch=tmcfg.name, depth=MOE_TRAIN_DEPTH, steps=TRAIN_STEPS, batch=1,
         seq=1024, remat=True, policy="default=bf16 logits=refine_ab", loss=mhistory,
         aux_loss=[r["aux_loss"] for r in mloop.log],
         grad_norm=[r["grad_norm"] for r in mloop.log], lr=[r["lr"] for r in mloop.log],
         step_s=[r["step_s"] for r in mloop.log], median_step_s=mstep_s,
         tok_per_s=1024 / mstep_s, wall_s=mtrain_wall, peak_mem_gb=mt_peak_gb,
         launches=launches_mt)
    if not all(launches_mt[n] > 0 for n in TRAIN_MOE_KERNELS):
        fail(f"train_moe: a kernel of the path never launched: {launches_mt}")
    if not all(math.isfinite(x) for r in mloop.log
               for x in (r["loss"], r["aux_loss"], r["grad_norm"])):
        fail(f"train_moe: non-finite loss or grad norm: {mloop.log}")
    if moe_faults:
        fail("; ".join(moe_faults) + f": {mstep0}")
    # free Mixtral (the training loop's last optimizer state is bound to _)
    _ = None
    del mloop, mbatch0
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 12 serve_rwkv
    # RWKV-6 7B at full width and depth on gemm=cuda with the serve policy.
    rcfg = get_config("rwkv6-7b")
    rvocab, rchunk, rhd = rcfg.vocab_size, rcfg.rwkv_chunk, rcfg.rwkv_head_dim
    rpolicy = ops.ExecutionPolicy(default="bf16", logits="refine_ab", backends={"gemm": "cuda"})
    rref_policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab")
    mem_before_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.monotonic()
    rparams = api.init_params(rcfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    r_init_s = time.monotonic() - t0
    r_n_params = sum(t.numel() for t in leaves(rparams))
    reng = ServeEngine(rcfg, batch_size=4, max_ctx=1024, policy=rpolicy, device=dev)
    reng.load(rparams)
    reng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    rrng = np.random.default_rng(2)
    rreqs = [Request(rid=i, prompt=rrng.integers(2, rvocab, int(n)).astype(np.int32),
                     max_new_tokens=32) for i, n in enumerate(lens)]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    rstats = reng.run(rreqs)
    launches_rw = read_launches(mods)
    r_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rwkv_faults = []
    if not all(r.done and len(r.out_tokens) == 32 for r in rreqs):
        rwkv_faults.append(f"not every request finished with 32 tokens: "
                           f"{[(r.rid, r.done, len(r.out_tokens)) for r in rreqs]}")
    if any(not 0 <= t < rvocab for r in rreqs for t in r.out_tokens):
        rwkv_faults.append("a token outside the vocabulary")
    if not all(launches_rw[k] > 0 for k in SERVE_RWKV_KERNELS):
        rwkv_faults.append(f"a kernel of the path never launched: {launches_rw}")

    # the comparisons with the torch routes take the prompt (past the first
    # chunk) whose last token sits earliest in its WKV chunk: there the
    # carried state weighs most, so the chunk-reset control shows
    pick = min((i for i, n in enumerate(lens) if n > rchunk), key=lambda i: (lens[i] - 1) % rchunk)
    rprompt = {"tokens": torch.as_tensor(rreqs[pick].prompt, device=dev)[None].long()}
    real_chunked = rwkv_mod._wkv_chunked

    def chunked_reset_each_chunk(r, k, v, logw, u, chunk, policy="bf16"):
        """The model's chunked WKV with the state reset at every chunk
        boundary (a fault)."""
        return split_chunks(real_chunked, (r, k, v, logw), chunk, u, chunk, policy=policy)

    def prefill_logits(c, pol, reset=False):
        rwkv_mod._wkv_chunked = chunked_reset_each_chunk if reset else real_chunked
        try:
            with torch.no_grad():
                return serve_step.make_prefill(c, pol, s_ctx=1024)(rparams, rprompt)[0]
        finally:
            rwkv_mod._wkv_chunked = real_chunked

    # (b) f32 activations, the refine_ab rung on every contraction
    rcfg32 = dataclasses.replace(rcfg, activation_dtype="float32")
    ab_kernel = ops.ExecutionPolicy(default="refine_ab", backends={"gemm": "cuda"})
    ab_torch = ops.ExecutionPolicy(default="refine_ab")
    rlk = prefill_logits(rcfg32, ab_kernel)
    rlr = prefill_logits(rcfg32, ab_torch)
    rlc = prefill_logits(rcfg32, ab_torch, reset=True)
    if rlk.shape != (1, 1, rvocab) or not torch.isfinite(rlk).all():
        rwkv_faults.append(f"prefill logits shape {tuple(rlk.shape)} or non-finite")
    r_err = (rlk - rlr).abs().max().item()
    r_ctrl = (rlc - rlr).abs().max().item()
    if not r_err <= RWKV_LOGITS_BOUND:
        rwkv_faults.append(f"refine_ab prefill logits {r_err} > {RWKV_LOGITS_BOUND}")
    if rlk.argmax() != rlr.argmax():
        rwkv_faults.append("the kernel routes pick another greedy token at refine_ab")
    if not r_ctrl > RWKV_LOGITS_BOUND:
        rwkv_faults.append(f"the chunk-reset control ({r_ctrl}) is within {RWKV_LOGITS_BOUND}")
    # (a) every layer at the serve policy, both routes (and the control) on
    # the torch route's input to that layer
    layer_errs, layer_ctrl = [], []
    kw = dict(head_dim=rhd, chunk=rchunk, norm_eps=rcfg.norm_eps)
    with torch.no_grad():
        x = layers_mod.embed(rparams["embed"], rprompt["tokens"],
                             getattr(torch, rcfg.activation_dtype))
        for p in rparams["layers"]:
            x_in = x
            out_k = rwkv_mod.rwkv6_layer(p, x_in, policy=rpolicy.for_("mlp"), **kw)[0].float()
            x = rwkv_mod.rwkv6_layer(p, x_in, policy=rref_policy.for_("mlp"), **kw)[0]
            rwkv_mod._wkv_chunked = chunked_reset_each_chunk
            try:
                out_c = rwkv_mod.rwkv6_layer(p, x_in, policy=rref_policy.for_("mlp"),
                                             **kw)[0].float()
            finally:
                rwkv_mod._wkv_chunked = real_chunked
            scale = x.float().abs().max()
            layer_errs.append(((out_k - x.float()).abs().max() / scale).item())
            layer_ctrl.append(((out_c - x.float()).abs().max() / scale).item())
        del x, x_in, out_k, out_c
    if not max(layer_errs) <= RWKV_LAYER_BOUND:
        rwkv_faults.append(f"a layer on the kernel routes {max(layer_errs)} > {RWKV_LAYER_BOUND}")
    if not min(layer_ctrl) > RWKV_LAYER_BOUND:
        rwkv_faults.append(f"the chunk-reset control of a layer ({min(layer_ctrl)}) is within "
                           f"{RWKV_LAYER_BOUND}")

    # the wkv6 kernel on the model's first-layer r/k/v/logw/u, padded to the
    # chunk with identity steps as _wkv_chunked pads
    def layer0_wkv_inputs(prompt_ids):
        toks = torch.as_tensor(prompt_ids, device=dev)[None].long()
        x0 = layers_mod.embed(rparams["embed"], toks, getattr(torch, rcfg.activation_dtype))
        p0 = rparams["layers"][0]
        xn = layers_mod.rmsnorm(p0["norm_tm"], x0, rcfg.norm_eps)
        prev = torch.nn.functional.pad(xn, (0, 0, 1, 0))[:, :-1]
        r, k, v, _, logw, u = rwkv_mod.time_mix_inputs(p0, xn, prev, head_dim=rhd,
                                                       policy=rpolicy.for_("mlp"))
        pad = (0, 0, 0, 0, 0, -r.shape[1] % rchunk)
        return [torch.nn.functional.pad(t, pad) for t in (r, k, v, logw)] + [u]

    def rel_err(outs, refs, scales):
        return max(((o - q).abs().max() / sc).item() for o, q, sc in zip(outs, refs, scales))

    with torch.no_grad():
        # the wkv6 path: the kernel's own entry point on every prompt's layer 0
        wkv_inputs = [layer0_wkv_inputs(r.prompt) for r in rreqs]
        zero_launches(mods)
        wkv_outs = [wk.wkv6(*xs, chunk=rchunk) for xs in wkv_inputs]
        torch.cuda.synchronize(dev)
        launches_wkv = read_launches(mods)
        wkv_path_err = []
        for r, xs, (o, st) in zip(rreqs, wkv_inputs, wkv_outs):
            n = len(r.prompt)
            oc, sc = real_chunked(*(t[:, :n] for t in xs[:4]), xs[4], rchunk, policy="f32")
            wkv_path_err.append(rel_err((o[:, :n], st), (oc, sc),
                                        (oc.abs().max(), sc.abs().max())))
        del wkv_outs
        if not all(launches_wkv["wkv6"] == len(rreqs) and e <= WKV_BOUND
                   for e in wkv_path_err):
            rwkv_faults.append(f"wkv6 path: launches {launches_wkv['wkv6']}, errors relative "
                               f"to the model's chunked form at f32 {wkv_path_err}")
        # the check row: the 665-token prompt (B=1, H=64, K=64, padded to 704)
        long_i = int(np.argmax(lens))
        xs = wkv_inputs[long_i]
        n_long = int(lens[long_i])
        o_p, s_p = wk.wkv6_plain(*xs, chunk=rchunk)
        scales = (o_p.abs().max(), s_p.abs().max())
        o_r, s_r = kref.wkv6_ref(*xs)
        o_c, s_c = real_chunked(*(t[:, :n_long] for t in xs[:4]), xs[4], rchunk, policy="f32")
        o_k, s_k = wk.wkv6(*xs, chunk=rchunk)
        model_errs = {"sequential_ref_rel_err": rel_err((o_k, s_k), (o_r, s_r), scales),
                      "model_chunked_f32_rel_err": rel_err((o_k[:, :n_long], s_k), (o_c, s_c),
                                                           scales)}
        del o_p, s_p, o_r, s_r, o_c, s_c, o_k, s_k

        def scaled(res):
            return tuple(t / sc for t, sc in zip(res, scales))

        check("wkv6", f"rwkv6-7b layer 0, {n_long}-token prompt padded to {xs[0].shape[1]}: "
              f"B=1 H={xs[0].shape[2]} K={rhd} chunk {rchunk}, errors relative to max|out|, "
              f"max|state|",
              lambda: scaled(wk.wkv6(*xs, chunk=rchunk)),
              lambda: scaled(wk.wkv6_plain(*xs, chunk=rchunk)), None, WKV_BOUND,
              *wkv_cost(1, xs[0].shape[1], xs[0].shape[2], rhd, rchunk)[:2],
              control=lambda: scaled(wkv_reset_each_chunk(*xs, rchunk)),
              rung_control=lambda: scaled(wk.wkv6_scan_plain(*xs, chunk=rchunk, passes=1)),
              peak=PEAK_TF32_FLOPS, library_call="none",
              extra={**model_errs, **wkv_cost(1, xs[0].shape[1], xs[0].shape[2], rhd,
                                              rchunk)[2]})
        if not max(model_errs.values()) <= WKV_BOUND:
            rwkv_faults.append(f"wkv6 on the model's inputs: {model_errs}")
    del wkv_inputs, xs

    long_rprompt = {"tokens": torch.as_tensor(rreqs[long_i].prompt, device=dev)[None].long()}
    with torch.no_grad():
        r_prefill_prof = profile_window(lambda: reng._prefill(rparams, long_rprompt))
    for i in range(4):
        reng.submit(Request(rid=100 + i, prompt=rreqs[i].prompt, max_new_tokens=16))
    reng.step()                                 # admit (prefill) all four
    r_tick_prof = profile_window(reng.tick)
    reng.run([])
    rtop2 = rlr.flatten().topk(2).values
    emit(phase="serve_rwkv", arch=rcfg.name, layers=len(rparams["layers"]), params=r_n_params,
         weights_gb=r_n_params * 4 / 1e9, mem_before_load_gb=mem_before_gb, init_s=r_init_s,
         requests=rstats["requests"], prompt_lens=[int(n) for n in lens],
         tokens=rstats["tokens"], ticks=rstats["ticks"], wall_s=rstats["wall_s"],
         tok_per_s=rstats["tok_per_s"], ttft_mean_s=rstats["ttft_mean_s"],
         latency_mean_s=rstats["latency_mean_s"], peak_mem_gb=r_peak_gb,
         launches=launches_rw, logits_prompt_len=int(lens[pick]),
         prefill_logits_policy="f32 activations, default=refine_ab",
         prefill_logits_max_abs_err=r_err, prefill_logits_bound=RWKV_LOGITS_BOUND,
         prefill_argmax_agrees=bool(rlk.argmax() == rlr.argmax()),
         reference_top2_gap=(rtop2[0] - rtop2[1]).item(),
         control_chunk_reset_err=r_ctrl, logits_absmax=rlr.abs().max().item(),
         layer_rel_err=layer_errs, layer_bound=RWKV_LAYER_BOUND,
         layer_control_rel_err=layer_ctrl,
         wkv6_path_launches=launches_wkv["wkv6"], wkv6_path_rel_err=wkv_path_err,
         prefill_tokens=int(long_rprompt["tokens"].shape[1]), prefill=r_prefill_prof,
         decode_tick=r_tick_prof)
    if rwkv_faults:
        fail("serve_rwkv: " + "; ".join(rwkv_faults))
    del reng, rparams, rlk, rlr, rlc
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------- 13 serve_zamba2
    # zamba2-7b at full width and depth (81 mixers: 68 Mamba-2 + 13
    # occurrences of the one shared attention block) on the kernel routes
    # with the serve policy; then its paged run and a profile.
    zcfg = get_config("zamba2-7b")
    zvocab, zchunk = zcfg.vocab_size, zcfg.ssm_chunk
    zpolicy = ops.ExecutionPolicy(
        default="bf16", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"},
        require={"attention": ("decode",)})
    zref_policy = ops.ExecutionPolicy(default="bf16", logits="refine_ab")
    mem_before_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.monotonic()
    zparams = api.init_params(zcfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    z_init_s = time.monotonic() - t0
    z_n_params = sum(t.numel() for t in leaves(zparams))
    zeng = ServeEngine(zcfg, batch_size=4, max_ctx=1024, policy=zpolicy, device=dev)
    zeng.load(zparams)
    zeng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    zrng = np.random.default_rng(3)
    zreqs = [Request(rid=i, prompt=zrng.integers(2, zvocab, int(n)).astype(np.int32),
                     max_new_tokens=32) for i, n in enumerate(lens)]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    zstats = zeng.run(zreqs)
    launches_z = read_launches(mods)
    z_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    zamba_faults = []
    if not all(r.done and len(r.out_tokens) == 32 for r in zreqs):
        zamba_faults.append(f"not every request finished with 32 tokens: "
                            f"{[(r.rid, r.done, len(r.out_tokens)) for r in zreqs]}")
    if any(not 0 <= t < zvocab for r in zreqs for t in r.out_tokens):
        zamba_faults.append("a token outside the vocabulary")
    if not all(launches_z[k] > 0 for k in SERVE_KERNELS):
        zamba_faults.append(f"a kernel of the path never launched: {launches_z}")

    # the comparisons take the prompt (past the first SSD chunk) whose last
    # token sits earliest in its chunk: there the carried state weighs most;
    # they run on slowly decaying copies of the stack (ZAMBA2_SLOW_A), the
    # bf16 layers on the one whose D skip is 0
    zkinds = layer_kinds(zcfg)
    z_nh = zparams["layers"][0]["a_log"].shape[0]
    zslow = slow_decay(zparams)
    zslow_ssd = slow_decay(zparams, d_skip=torch.zeros(z_nh, device=dev))
    zpick = min((i for i, n in enumerate(lens) if n > zchunk),
                key=lambda i: (lens[i] - 1) % zchunk)
    zprompt = {"tokens": torch.as_tensor(zreqs[zpick].prompt, device=dev)[None].long()}
    real_ssd = ssm_mod._ssd_chunked

    def ssd_reset_each_chunk(x, bmat, cmat, rel, dt, chunk, policy):
        """The model's chunked SSD scan with the state reset at every chunk
        boundary (a fault)."""
        return split_chunks(real_ssd, (x, bmat, cmat, rel, dt), chunk, chunk, policy)

    def zamba_prefill(c, pol, reset=False):
        ssm_mod._ssd_chunked = ssd_reset_each_chunk if reset else real_ssd
        try:
            with torch.no_grad():
                return serve_step.make_prefill(c, pol, s_ctx=1024)(zslow, zprompt)[0]
        finally:
            ssm_mod._ssd_chunked = real_ssd

    # (a) the serve policy's prefill logits, kernel routes vs torch routes
    zlk = zamba_prefill(zcfg, zpolicy)
    zlr = zamba_prefill(zcfg, zref_policy)
    zlc = zamba_prefill(zcfg, zref_policy, reset=True)
    if zlk.shape != (1, 1, zvocab) or not torch.isfinite(zlk).all():
        zamba_faults.append(f"prefill logits shape {tuple(zlk.shape)} or non-finite")
    z_err = (zlk - zlr).abs().max().item()
    z_ctrl = (zlc - zlr).abs().max().item()
    # (b) f32 activations, the refine_ab rung on every contraction
    zcfg32 = dataclasses.replace(zcfg, activation_dtype="float32")
    zab_kernel = ops.ExecutionPolicy(default="refine_ab",
                                     backends={"gemm": "cuda", "attention": "cuda_fused"})
    zab_torch = ops.ExecutionPolicy(default="refine_ab")
    zlk32 = zamba_prefill(zcfg32, zab_kernel)
    zlr32 = zamba_prefill(zcfg32, zab_torch)
    zlc32 = zamba_prefill(zcfg32, zab_torch, reset=True)
    z32_err = (zlk32 - zlr32).abs().max().item()
    z32_ctrl = (zlc32 - zlr32).abs().max().item()
    # (c) every sublayer at the serve policy, both routes (and, for the
    # Mamba-2 layers, the chunk-reset control) on the torch route's input:
    # at bf16 activations, max |kernel - torch| over the layer's max |out|;
    # at f32 activations, over its max |out - in| (what the layer adds)
    def layer_errors(params, act_dtype, relative_to_delta):
        errs, ctrls = [], []
        with torch.no_grad():
            x = layers_mod.embed(params["embed"], zprompt["tokens"], act_dtype)
            for kind, p in zip(zkinds, params["layers"]):
                x_in = x

                def sub(pol, x_in=x_in, kind=kind, p=p):
                    return transformer._sublayer(kind, p, x_in, cfg=zcfg, policy=pol,
                                                 mode="prefill", cache=None, pos=None,
                                                 shared=params["shared"])[0].float()

                out_k = sub(zpolicy)
                x = sub(zref_policy).to(act_dtype)
                ref = x.float()
                scale = ((ref - x_in.float()) if relative_to_delta else ref).abs().max()
                errs.append(((out_k - ref).abs().max() / scale).item())
                if kind == "mamba2":
                    ssm_mod._ssd_chunked = ssd_reset_each_chunk
                    try:
                        out_c = sub(zref_policy)
                    finally:
                        ssm_mod._ssd_chunked = real_ssd
                    ctrls.append(((out_c - ref).abs().max() / scale).item())
        return errs, ctrls

    zlayer_errs, zlayer_ctrl = layer_errors(zslow_ssd, getattr(torch, zcfg.activation_dtype),
                                            False)
    zl32_errs, zl32_ctrl = layer_errors(zslow, torch.float32, True)
    ztop2 = zlr.flatten().topk(2).values
    ztop2_32 = zlr32.flatten().topk(2).values
    zline = dict(
        arch=zcfg.name, layers=len(zparams["layers"]), mamba2_layers=zkinds.count("mamba2"),
        shared_attn_occurrences=zkinds.count("shared_attn"), params=z_n_params,
        weights_gb=z_n_params * 4 / 1e9, mem_before_load_gb=mem_before_gb, init_s=z_init_s,
        requests=zstats["requests"], prompt_lens=[int(n) for n in lens],
        tokens=zstats["tokens"], ticks=zstats["ticks"], wall_s=zstats["wall_s"],
        tok_per_s=zstats["tok_per_s"], ttft_mean_s=zstats["ttft_mean_s"],
        latency_mean_s=zstats["latency_mean_s"], peak_mem_gb=z_peak_gb, launches=launches_z,
        logits_prompt_len=int(lens[zpick]), compared_on="slow-decay copy",
        slow_a=list(ZAMBA2_SLOW_A), slow_dt_bias=ZAMBA2_SLOW_DT_BIAS,
        bf16_layers_d_skip=0.0,
        prefill_logits_max_abs_err=z_err, prefill_logits_bound=ZAMBA2_LOGITS_BOUND,
        prefill_argmax_agrees=bool(zlk.argmax() == zlr.argmax()),
        reference_top2_gap=(ztop2[0] - ztop2[1]).item(), control_chunk_reset_err=z_ctrl,
        logits_absmax=zlr.abs().max().item(),
        f32_refine_ab_logits_err=z32_err, f32_refine_ab_bound=ZAMBA2_F32_LOGITS_BOUND,
        f32_refine_ab_argmax_agrees=bool(zlk32.argmax() == zlr32.argmax()),
        f32_refine_ab_top2_gap=(ztop2_32[0] - ztop2_32[1]).item(),
        f32_refine_ab_control_err=z32_ctrl,
        layer_rel_err=zlayer_errs, layer_bound=ZAMBA2_LAYER_BOUND,
        mamba2_layer_control_rel_err=zlayer_ctrl,
        f32_layer_delta_rel_err=zl32_errs, f32_layer_bound=ZAMBA2_F32_LAYER_BOUND,
        f32_mamba2_layer_control_delta_rel_err=zl32_ctrl)
    del zlk32, zlr32, zlc32, zslow, zslow_ssd
    # (a), (b) and (c) at both activation dtypes, each with the same greedy
    # token where it has one and the chunk-reset control above its bound
    for what, err, lim, ctrl, same in (
            ("serve-policy prefill logits", z_err, ZAMBA2_LOGITS_BOUND, z_ctrl,
             zline["prefill_argmax_agrees"]),
            ("f32 refine_ab prefill logits", z32_err, ZAMBA2_F32_LOGITS_BOUND, z32_ctrl,
             zline["f32_refine_ab_argmax_agrees"]),
            ("every sublayer at bf16", max(zlayer_errs), ZAMBA2_LAYER_BOUND, min(zlayer_ctrl),
             True),
            ("every sublayer at f32", max(zl32_errs), ZAMBA2_F32_LAYER_BOUND, min(zl32_ctrl),
             True)):
        if not err <= lim:
            zamba_faults.append(f"{what}: kernel routes vs torch routes {err} > {lim}")
        if not same:
            zamba_faults.append(f"{what}: the kernel routes pick another greedy token")
        if not ctrl > lim:
            zamba_faults.append(f"{what}: the chunk-reset control ({ctrl}) is within {lim}")

    # serve_zamba2_paged: the same requests and slots from 8-row bf16 pages
    # (one pool per shared-block occurrence), token for token the dense run
    zpaged_policy = ops.ExecutionPolicy(
        default="bf16", logits="refine_ab",
        backends={"gemm": "cuda", "attention": "cuda_fused"},
        require={"attention": ("decode", "paged_decode")})
    zeng_p = ServeEngine(zcfg, batch_size=4, max_ctx=1024, policy=zpaged_policy, device=dev,
                         kv_layout="paged", kv_page_size=8)
    zeng_p.load(zparams)
    zeng_p.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    zreqs_p = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=32) for r in zreqs]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    zstats_p = zeng_p.run(zreqs_p)
    launches_zp = read_launches(mods)
    zp_tokens_equal = [r.out_tokens for r in zreqs_p] == [r.out_tokens for r in zreqs]
    zp_line = dict(
        page_size=8, pools=sum(isinstance(c, paged.PagedKVCache) for c in zeng_p.cache),
        requests=zstats_p["requests"], tokens=zstats_p["tokens"], ticks=zstats_p["ticks"],
        wall_s=zstats_p["wall_s"], tok_per_s=zstats_p["tok_per_s"],
        ttft_mean_s=zstats_p["ttft_mean_s"], latency_mean_s=zstats_p["latency_mean_s"],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        pages_outstanding=zeng_p.pages_outstanding(),
        tables_clear=all(not bool(t.any()) for t in zeng_p._tables.values()),
        tokens_equal_dense=zp_tokens_equal, launches=launches_zp)
    if not zp_tokens_equal:
        zamba_faults.append("paged: tokens differ from the dense run's: "
                            f"{[(r.rid, r.out_tokens[:4]) for r in zreqs_p]}")
    if zp_line["pages_outstanding"] or not zp_line["tables_clear"]:
        zamba_faults.append(f"paged: pages still held after the run: {zp_line}")
    if not all(launches_zp[n] > 0 for n in PAGED_KERNELS):
        zamba_faults.append(f"paged: a kernel of the path never launched: {launches_zp}")

    # profile: the longest prompt's prefill and one 4-slot decode tick, dense
    zlong = int(np.argmax(lens))
    zlong_prompt = {"tokens": torch.as_tensor(zreqs[zlong].prompt, device=dev)[None].long()}
    with torch.no_grad():
        z_prefill_prof = profile_window(lambda: zeng._prefill(zparams, zlong_prompt))
    for i in range(4):
        zeng.submit(Request(rid=100 + i, prompt=zreqs[i].prompt, max_new_tokens=16))
    zeng.step()                                 # admit (prefill) all four
    z_tick_prof = profile_window(zeng.tick)
    zeng.run([])
    emit(phase="serve_zamba2", **zline, prefill_tokens=int(lens[zlong]),
         prefill=z_prefill_prof, decode_tick=z_tick_prof)
    emit(phase="serve_zamba2_paged", **zp_line)
    if zamba_faults:
        fail("serve_zamba2: " + "; ".join(zamba_faults))
    del zeng, zeng_p, zparams, zlk, zlr, zlc
    gc.collect()
    torch.cuda.empty_cache()

    # Phases 14-16 and 25-27 share these: serve requests on an engine (and
    # on a paged engine beside it), hold the prefill logits of one prompt
    # against the torch routes with a faulty control, and profile a prefill
    # and a tick.  A reference whose refine_ab unembed would not fit beside
    # the params (its whole table's hi/lo split) runs it over vocab chunks;
    # each logit is one row's product either way.
    def served(reqs_, vocab_, launches_, faults, kernels=SERVE_KERNELS):
        """Every request finished (32 tokens, or EOS sooner), in the
        vocabulary, every kernel of the path launched."""
        if not all(r.done and (len(r.out_tokens) == 32 or r.out_tokens[-1] == 1)
                   for r in reqs_):
            faults.append(f"not every request finished: "
                          f"{[(r.rid, r.done, len(r.out_tokens)) for r in reqs_]}")
        if any(not 0 <= t < vocab_ for r in reqs_ for t in r.out_tokens):
            faults.append("a token outside the vocabulary")
        if not all(launches_[k] > 0 for k in kernels):
            faults.append(f"a kernel of the path never launched: {launches_}")

    def serve_paged_twin(c, prm, dense_reqs, faults, pol=paged_policy, kernels=PAGED_KERNELS):
        """The same requests and slots from 8-row bf16 pages: token for token
        the dense run's, every page handed back, every kernel of the paged
        path (``kernels``) launched."""
        e = ServeEngine(c, batch_size=4, max_ctx=1024, policy=pol, device=dev,
                        kv_layout="paged", kv_page_size=8)
        e.load(prm)
        e.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
        preqs = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=32) for r in dense_reqs]
        zero_launches(mods)
        torch.cuda.reset_peak_memory_stats(dev)
        st = e.run(preqs)
        ls = read_launches(mods)
        equal = [r.out_tokens for r in preqs] == [r.out_tokens for r in dense_reqs]
        line = dict(
            page_size=8, pools=sum(isinstance(x, paged.PagedKVCache) for x in e.cache),
            dense_caches=sum(isinstance(x, tuple) for x in e.cache),
            requests=st["requests"], tokens=st["tokens"], ticks=st["ticks"],
            wall_s=st["wall_s"], tok_per_s=st["tok_per_s"], ttft_mean_s=st["ttft_mean_s"],
            latency_mean_s=st["latency_mean_s"],
            peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            pages_outstanding=e.pages_outstanding(),
            tables_clear=all(not bool(t.any()) for t in e._tables.values()),
            tokens_equal_dense=equal, launches=ls)
        if not equal:
            faults.append("paged: tokens differ from the dense run's: "
                          f"{[(r.rid, r.out_tokens[:4]) for r in preqs]}")
        if line["pages_outstanding"] or not line["tables_clear"]:
            faults.append(f"paged: pages still held after the run: {line}")
        if not all(ls[n] > 0 for n in kernels):
            faults.append(f"paged: a kernel of the path never launched: {ls}")
        del e
        return line, ls

    def profiled(e, prm, batch, dense_reqs):
        """A prefill of ``batch`` and one 4-slot decode tick, profiled.  The
        four requests stay in flight: every caller drops ``e`` next."""
        with torch.no_grad():
            pre = profile_window(lambda: e._prefill(prm, batch))
        for i in range(4):
            e.submit(Request(rid=100 + i, prompt=dense_reqs[i].prompt, max_new_tokens=16))
        e.step()                                # admit (prefill) all four
        tick = profile_window(e.tick)
        return pre, tick

    def held(what, err, lim, ctrl, ctrl_name, same, faults):
        if not err <= lim:
            faults.append(f"{what}: kernel routes vs torch routes {err} > {lim}")
        if same is False:
            faults.append(f"{what}: the kernel routes pick another greedy token")
        if not ctrl > lim:
            faults.append(f"{what}: the {ctrl_name} control ({ctrl}) is within {lim}")

    real_unembed = layers_mod.unembed

    def unembed_by_vocab_chunks(p, x, pol):
        return vocab_chunked(lambda t: real_unembed({"table": t}, x, pol), p["table"])

    # Phases 14 and 25-27 serve a large config at full width (depth cut
    # where its f32 weights would not fit), params from a device generator
    # seeded 0: phase 4's prompt lengths (ids within the vocabulary), 32 new
    # tokens each, 4 slots, 1024-token context.
    def prompt_of(r):
        return {"tokens": torch.as_tensor(r.prompt, device=dev)[None].long()}

    def giant_config(name, depth):
        full = get_config(name)
        return dataclasses.replace(full, num_layers=depth,
                                   segments=(Segment(full.segments[0].pattern, depth),))

    def giant_prefill(c, prm, pol, batch, chunked=False):
        """Prefill logits; ``chunked``: the refine_ab unembed over vocab
        chunks (the reference's, whose whole-table hi/lo split would not
        fit beside the params)."""
        layers_mod.unembed = unembed_by_vocab_chunks if chunked else real_unembed
        try:
            with torch.no_grad():
                return serve_step.make_prefill(c, pol, s_ctx=1024)(prm, batch)[0]
        finally:
            layers_mod.unembed = real_unembed

    def serve_giant(c, pol, seed, kernels, prep=None):
        """Init, ``prep`` on the params (its fields go on the line), then
        the requests (tokens from ``seed``) through the engine: (params,
        engine, requests, launches, faults, line)."""
        mem_before = torch.cuda.memory_allocated(dev) / 1e9
        t0 = time.monotonic()
        prm = api.init_params(c, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize(dev)
        init_s = time.monotonic() - t0
        line = prep(prm) if prep else {}
        n = sum(t.numel() for t in leaves(prm))
        e = ServeEngine(c, batch_size=4, max_ctx=1024, policy=pol, device=dev)
        e.load(prm)
        e.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
        grng = np.random.default_rng(seed)
        rs = [Request(rid=i, prompt=grng.integers(2, c.vocab_size, int(k)).astype(np.int32),
                      max_new_tokens=32) for i, k in enumerate(lens)]
        zero_launches(mods)
        torch.cuda.reset_peak_memory_stats(dev)
        st = e.run(rs)
        ls = read_launches(mods)
        faults: list[str] = []
        served(rs, c.vocab_size, ls, faults, kernels)
        line = dict(arch=c.name, layers=len(prm["layers"]), params=n, weights_gb=n * 4 / 1e9,
                    mem_before_load_gb=mem_before, init_s=init_s, **line,
                    requests=st["requests"], prompt_lens=[int(k) for k in lens],
                    tokens=st["tokens"], ticks=st["ticks"], wall_s=st["wall_s"],
                    tok_per_s=st["tok_per_s"], ttft_mean_s=st["ttft_mean_s"],
                    latency_mean_s=st["latency_mean_s"],
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, launches=ls)
        return prm, e, rs, ls, faults, line

    def held_logits(lk, lr, lc, vocab_, lim, ctrl_name, faults) -> dict:
        """The prefill logits held (shape, bound, greedy token, control)."""
        if lk.shape != (1, 1, vocab_) or not torch.isfinite(lk).all():
            faults.append(f"prefill logits shape {tuple(lk.shape)} or non-finite")
        err, ctrl = (lk - lr).abs().max().item(), (lc - lr).abs().max().item()
        same = bool(lk.argmax() == lr.argmax())
        held("prefill logits", err, lim, ctrl, ctrl_name, same, faults)
        top2 = lr.flatten().topk(2).values
        return {"logits_prompt_len": int(lens[0]), "prefill_logits_max_abs_err": err,
                "prefill_logits_bound": lim, "prefill_argmax_agrees": same,
                "reference_top2_gap": (top2[0] - top2[1]).item(),
                f"control_{ctrl_name.replace('-', '_').lower()}_err": ctrl,
                "logits_absmax": lr.abs().max().item()}

    def emit_giant(phase, prm, e, rs, line, t_phase, paged_line=None):
        """The profiled prefill and tick, then the phase's line (and its
        paged twin's)."""
        pre, tick = profiled(e, prm, prompt_of(rs[zlong]), rs)
        emit(phase=phase, **line, prefill_tokens=int(lens[zlong]), prefill=pre,
             decode_tick=tick, phase_s=time.monotonic() - t_phase)
        if paged_line is not None:
            emit(phase=f"{phase}_paged", arch=line["arch"], **paged_line)

    # --------------------------------------------------- 14 serve_nemotron
    # nemotron-4-340b at full width, depth NEMOTRON_DEPTH, on the kernel
    # routes with the serve policy; the reference's unembed over vocab
    # chunks; fp8 MLPs on the kernel routes as the control (gemm_lowp's
    # quantize pass reads the f32 weights in place).
    t_phase = time.monotonic()
    ncfg = giant_config("nemotron-4-340b", NEMOTRON_DEPTH)
    nparams, neng, nreqs, launches_nm, nemo_faults, nline = serve_giant(
        ncfg, policy, 4, SERVE_KERNELS)
    nprompt = prompt_of(nreqs[0])
    nlk = giant_prefill(ncfg, nparams, policy, nprompt)
    nlr = giant_prefill(ncfg, nparams, ref_policy, nprompt, chunked=True)
    nl8 = giant_prefill(ncfg, nparams, fp8_kernel_policy, nprompt)
    nline.update(depth=NEMOTRON_DEPTH, **held_logits(nlk, nlr, nl8, ncfg.vocab_size,
                                                     NEMOTRON_LOGITS_BOUND, "fp8-MLP",
                                                     nemo_faults))
    del nlk, nlr, nl8
    emit_giant("serve_nemotron", nparams, neng, nreqs, nline, t_phase)
    if nemo_faults:
        fail("serve_nemotron: " + "; ".join(nemo_faults))
    del neng, nparams
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 15 serve_whisper
    # whisper-medium whole (24 encoder + 24 decoder layers, tied 51865-row
    # embedding) on the kernel routes with the serve policy.  The engine's
    # prefill encodes zero frames, as repro's does; the held comparisons run
    # api.prefill and the encoder on seeded random frames.
    wcfg = get_config("whisper-medium")
    wvocab = wcfg.vocab_size
    mem_before_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.monotonic()
    wparams = api.init_params(wcfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    w_init_s = time.monotonic() - t0
    w_n_params = sum(t.numel() for t in leaves(wparams))
    weng = ServeEngine(wcfg, batch_size=4, max_ctx=1024, policy=policy, device=dev)
    weng.load(wparams)
    weng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    wrng = np.random.default_rng(5)
    wreqs = [Request(rid=i, prompt=wrng.integers(2, wvocab, int(n)).astype(np.int32),
                     max_new_tokens=32) for i, n in enumerate(lens)]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    wstats = weng.run(wreqs)
    launches_w = read_launches(mods)
    w_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    whisper_faults: list[str] = []
    served(wreqs, wvocab, launches_w, whisper_faults)
    wframes = randn((1, wcfg.encoder_seq, wcfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(15))
    wbatch = {"tokens": torch.as_tensor(wreqs[0].prompt, device=dev)[None].long(),
              "frames": wframes}
    real_attention = transformer.attention

    def causal_encoder(*a, **kw):
        """The encoder's attention run causal: the fault a dropped
        ``causal=False`` would be."""
        return real_attention(*a, **({**kw, "causal": True} if kw.get("mode") == "encode"
                                     else kw))

    def whisper_runs(pol, fault=False):
        """(prefill logits, encoder states) on ``wbatch`` under ``pol``."""
        transformer.attention = causal_encoder if fault else real_attention
        try:
            with torch.no_grad():
                logits = serve_step.make_prefill(wcfg, pol, s_ctx=1024)(wparams, wbatch)[0]
                states = encdec_mod.encode(wparams, wframes, wcfg, policy=pol).float()
            return logits, states
        finally:
            transformer.attention = real_attention

    (wlk, wek), (wlr, wer), (wlc, wec) = (whisper_runs(policy), whisper_runs(ref_policy),
                                          whisper_runs(ref_policy, fault=True))
    torch.cuda.synchronize(dev)
    if wlk.shape != (1, 1, wvocab) or not torch.isfinite(wlk).all():
        whisper_faults.append(f"prefill logits shape {tuple(wlk.shape)} or non-finite")
    if wek.shape != (1, wcfg.encoder_seq, wcfg.d_model) or not torch.isfinite(wek).all():
        whisper_faults.append(f"encoder states shape {tuple(wek.shape)} or non-finite")
    w_err, w_ctrl = ((wlk - wlr).abs().max().item(), (wlc - wlr).abs().max().item())
    we_err, we_ctrl = ((wek - wer).abs().max().item(), (wec - wer).abs().max().item())
    held("prefill logits", w_err, WHISPER_LOGITS_BOUND, w_ctrl, "causal-encoder",
         bool(wlk.argmax() == wlr.argmax()), whisper_faults)
    held("encoder states", we_err, WHISPER_ENCODER_BOUND, we_ctrl, "causal-encoder", None,
         whisper_faults)
    wtop2 = wlr.flatten().topk(2).values
    wline = dict(
        arch=wcfg.name, encoder_layers=len(wparams["enc_layers"]),
        decoder_sublayers=len(wparams["layers"]), encoder_seq=wcfg.encoder_seq,
        params=w_n_params, weights_gb=w_n_params * 4 / 1e9, mem_before_load_gb=mem_before_gb,
        init_s=w_init_s, requests=wstats["requests"], prompt_lens=[int(n) for n in lens],
        tokens=wstats["tokens"], ticks=wstats["ticks"], wall_s=wstats["wall_s"],
        tok_per_s=wstats["tok_per_s"], ttft_mean_s=wstats["ttft_mean_s"],
        latency_mean_s=wstats["latency_mean_s"], peak_mem_gb=w_peak_gb, launches=launches_w,
        cross_caches=[tuple(c.k.shape) for c, kd in zip(weng.cache, layer_kinds(wcfg))
                      if kd == "cross_attn"][:1],
        logits_prompt_len=int(lens[0]), compared_on="seeded random frames",
        prefill_logits_max_abs_err=w_err, prefill_logits_bound=WHISPER_LOGITS_BOUND,
        prefill_argmax_agrees=bool(wlk.argmax() == wlr.argmax()),
        reference_top2_gap=(wtop2[0] - wtop2[1]).item(), control_causal_encoder_err=w_ctrl,
        logits_absmax=wlr.abs().max().item(), encoder_states_max_abs_err=we_err,
        encoder_states_bound=WHISPER_ENCODER_BOUND, encoder_control_causal_err=we_ctrl,
        encoder_states_absmax=wer.abs().max().item())
    del wlk, wek, wlr, wer, wlc, wec
    wp_line, launches_wp = serve_paged_twin(wcfg, wparams, wreqs, whisper_faults)
    wlong = int(np.argmax(lens))
    wlong_batch = {"tokens": torch.as_tensor(wreqs[wlong].prompt, device=dev)[None].long(),
                   "frames": torch.zeros_like(wframes)}
    w_prefill_prof, w_tick_prof = profiled(weng, wparams, wlong_batch, wreqs)
    emit(phase="serve_whisper", **wline, prefill_tokens=int(lens[wlong]),
         prefill=w_prefill_prof, decode_tick=w_tick_prof)
    emit(phase="serve_whisper_paged", arch=wcfg.name, **wp_line)
    if whisper_faults:
        fail("serve_whisper: " + "; ".join(whisper_faults))
    del weng, wparams, wframes, wbatch, wlong_batch
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------- 16 serve_internvl2
    # internvl2-76b at full width, depth INTERNVL2_DEPTH, on the kernel
    # routes with the serve policy; every prompt follows 256 image rows (zero
    # embeddings in the engine, as in repro; seeded random ones, at the token
    # embeddings' scale, in the held comparison).
    full_i = get_config("internvl2-76b")
    icfg = dataclasses.replace(full_i, num_layers=INTERNVL2_DEPTH,
                               segments=(Segment(("attn", "mlp"), INTERNVL2_DEPTH),))
    ivocab, n_img = icfg.vocab_size, icfg.num_image_tokens
    mem_before_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.monotonic()
    iparams = api.init_params(icfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    i_init_s = time.monotonic() - t0
    i_n_params = sum(t.numel() for t in leaves(iparams))
    ieng = ServeEngine(icfg, batch_size=4, max_ctx=1024, policy=policy, device=dev)
    ieng.load(iparams)
    ieng.run([Request(rid=-1, prompt=np.arange(2, 18, dtype=np.int32), max_new_tokens=2)])
    irng = np.random.default_rng(6)
    ireqs = [Request(rid=i, prompt=irng.integers(2, ivocab, int(n)).astype(np.int32),
                     max_new_tokens=32) for i, n in enumerate(lens)]
    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    istats = ieng.run(ireqs)
    launches_i = read_launches(mods)
    i_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    ivl_faults: list[str] = []
    served(ireqs, ivocab, launches_i, ivl_faults)
    img = randn((1, n_img, icfg.d_model), icfg.d_model ** -0.5,
                generator=torch.Generator(device=dev).manual_seed(16))
    itoks = torch.as_tensor(ireqs[0].prompt, device=dev)[None].long()

    def internvl2_prefill(pol, image):
        with torch.no_grad():
            return serve_step.make_prefill(icfg, pol, s_ctx=1024)(
                iparams, {"tokens": itoks, "image_embeds": image})[0]

    ilk = internvl2_prefill(policy, img)
    ilr = internvl2_prefill(ref_policy, img)
    ilc = internvl2_prefill(ref_policy, img.roll(1, dims=1))    # faulty: rows rolled by one
    if ilk.shape != (1, 1, ivocab) or not torch.isfinite(ilk).all():
        ivl_faults.append(f"prefill logits shape {tuple(ilk.shape)} or non-finite")
    i_err, i_ctrl = (ilk - ilr).abs().max().item(), (ilc - ilr).abs().max().item()
    held("prefill logits", i_err, INTERNVL2_LOGITS_BOUND, i_ctrl, "rolled-image",
         bool(ilk.argmax() == ilr.argmax()), ivl_faults)
    itop2 = ilr.flatten().topk(2).values
    iline = dict(
        arch=icfg.name, depth=INTERNVL2_DEPTH, layers=len(iparams["layers"]),
        image_tokens=n_img, params=i_n_params, weights_gb=i_n_params * 4 / 1e9,
        mem_before_load_gb=mem_before_gb, init_s=i_init_s, requests=istats["requests"],
        prompt_lens=[int(n) for n in lens], rows_at_most=n_img + int(max(lens)) + 32,
        tokens=istats["tokens"], ticks=istats["ticks"], wall_s=istats["wall_s"],
        tok_per_s=istats["tok_per_s"], ttft_mean_s=istats["ttft_mean_s"],
        latency_mean_s=istats["latency_mean_s"], peak_mem_gb=i_peak_gb, launches=launches_i,
        logits_prompt_len=int(lens[0]), compared_on="seeded random image embeddings",
        prefill_logits_max_abs_err=i_err, prefill_logits_bound=INTERNVL2_LOGITS_BOUND,
        prefill_argmax_agrees=bool(ilk.argmax() == ilr.argmax()),
        reference_top2_gap=(itop2[0] - itop2[1]).item(), control_rolled_image_err=i_ctrl,
        logits_absmax=ilr.abs().max().item())
    del ilk, ilr, ilc
    ip_line, launches_ip = serve_paged_twin(icfg, iparams, ireqs, ivl_faults)
    ilong_batch = {"tokens": torch.as_tensor(ireqs[wlong].prompt, device=dev)[None].long(),
                   "image_embeds": torch.zeros_like(img)}
    i_prefill_prof, i_tick_prof = profiled(ieng, iparams, ilong_batch, ireqs)
    emit(phase="serve_internvl2", **iline, prefill_tokens=n_img + int(lens[wlong]),
         prefill=i_prefill_prof, decode_tick=i_tick_prof)
    emit(phase="serve_internvl2_paged", arch=icfg.name, **ip_line)
    if ivl_faults:
        fail("serve_internvl2: " + "; ".join(ivl_faults))
    del ieng, iparams, img, itoks, ilong_batch
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------ 17-20 train the other families
    # rwkv6-7b (depth TRAIN_RWKV_DEPTH of 32), zamba2-7b (TRAIN_ZAMBA2_PERIODS
    # periods of [5 mamba2 + shared_attn]), whisper-medium whole and
    # internvl2-76b (depth TRAIN_INTERNVL2_DEPTH of 80), each at full width
    # through TrainLoop on the kernel routes, as phase 7 trains gemma3.  Step
    # 0: per-token loss and five gradient leaves on the kernel routes against
    # the torch routes on the same params and batch, and a faulty torch-route
    # control; the recurrent stacks compare on slow-decay copies (their random
    # init forgets the state within a chunk), the control the state reset at
    # every chunk boundary; whisper's control runs its encoder causal,
    # internvl2's rolls the image rows by one.  Then TRAIN_STEPS steps, their
    # launches, and one profiled step.
    from repro_torch.launch.train import data_config
    from repro_torch.models import vlm as vlm_mod

    def token_nll(p, b, c, pol):
        """Per-token losses of the train forward (remat on): f32 logsumexp
        minus the label logit, on the text rows."""
        if c.family == "audio":
            logits = encdec_mod.forward(p, b["tokens"], b["frames"], c, policy=pol,
                                        mode="train", remat=True)[0]
        elif c.family == "vlm":
            logits = vlm_mod.forward(p, b["tokens"], b["image_embeds"], c, policy=pol,
                                     mode="train", remat=True)[0][:, c.num_image_tokens:]
        else:
            logits = transformer.forward(p, b["tokens"], c, policy=pol, mode="train",
                                         remat=True)[0]
        logits = logits.float()
        return torch.logsumexp(logits, dim=-1) - logits.gather(
            -1, b["labels"].long()[..., None])[..., 0]

    @contextlib.contextmanager
    def chunk_reset(fault):
        """serve_rwkv's and serve_zamba2's chunk-reset faults while ``fault``
        holds (the backward's remat recompute included)."""
        if fault:
            rwkv_mod._wkv_chunked = chunked_reset_each_chunk
            ssm_mod._ssd_chunked = ssd_reset_each_chunk
        try:
            yield
        finally:
            rwkv_mod._wkv_chunked, ssm_mod._ssd_chunked = real_chunked, real_ssd

    @contextlib.contextmanager
    def causal_encoder_ctx(fault):
        """serve_whisper's causal-encoder fault while ``fault`` holds."""
        transformer.attention = causal_encoder if fault else real_attention
        try:
            yield
        finally:
            transformer.attention = real_attention

    def train_family(phase, c, b_rows, seq, five_fn, fault_ctx, kernels, *, slow=False,
                     roll_image=False, **line):
        """Step 0 against the torch routes with its control, then TRAIN_STEPS
        steps through TrainLoop and one profiled step.  Returns the steps'
        launches."""
        t_phase = time.monotonic()
        tpol = execution_policy_for(c, default="bf16", logits="refine_ab",
                                    backends={"gemm": "cuda", "attention": "cuda_fused"},
                                    require={fam: ("vjp",) for fam in ops.families()})
        tloop = TrainLoop(c, policy=tpol,
                          opt_cfg=adamw.AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS),
                          data_cfg=data_config(c, batch=b_rows, seq=seq), remat=True,
                          device=dev)
        p0, _, _ = tloop.init_or_restore(0)
        n_params = sum(t.numel() for t in leaves(p0))
        cp = slow_decay(p0) if slow else p0
        b0 = tloop.batch(SyntheticLMDataset(tloop.data_cfg), 0)
        five = five_fn(cp)
        ref_pol = ops.ExecutionPolicy(default="bf16", logits="refine_ab")

        def run(pol, fault=False):
            b = b0
            if fault and roll_image:
                b = {**b0, "image_embeds": b0["image_embeds"].roll(1, dims=1)}
            with fault_ctx(fault):
                nll = token_nll(cp, b, c, pol)
                grads = torch.autograd.grad(nll.mean(), list(five.values()))
            return nll.detach(), grads

        (nll_k, g_k), (nll_t, g_t), (nll_c, g_c) = run(tpol), run(ref_pol), run(ref_pol, True)

        def rel(a, b):
            return {k: ((x - y).norm() / y.norm()).item() for k, x, y in zip(five, a, b)}

        step0 = {"loss_kernel": nll_k.mean().item(), "loss_torch": nll_t.mean().item(),
                 "token_loss_max_err": (nll_k - nll_t).abs().max().item(),
                 "grad_rel_err": rel(g_k, g_t),
                 "control_token_loss_max_err": (nll_c - nll_t).abs().max().item(),
                 "control_grad_rel_err": rel(g_c, g_t),
                 "compared_on": "slow-decay copy" if slow else "the initial params",
                 "token_loss_bound": STEP0_TOKEN_LOSS_BOUND, "grad_bound": STEP0_GRAD_BOUND}
        del p0, cp, five, g_k, g_t, g_c, nll_k, nll_t, nll_c, b0
        gc.collect()
        torch.cuda.empty_cache()
        faults = []
        if not (math.isfinite(step0["loss_kernel"])
                and step0["token_loss_max_err"] <= STEP0_TOKEN_LOSS_BOUND
                and max(step0["grad_rel_err"].values()) <= STEP0_GRAD_BOUND):
            faults.append("step 0: kernel routes vs torch routes out of bounds")
        if not (step0["control_token_loss_max_err"] > STEP0_TOKEN_LOSS_BOUND
                and max(step0["control_grad_rel_err"].values()) > STEP0_GRAD_BOUND):
            faults.append("step 0: the control lands within the bounds")

        zero_launches(mods)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        tp, topt, hist = tloop.run(TRAIN_STEPS, log_every=0)
        torch.cuda.synchronize(dev)
        wall = time.monotonic() - t0
        ls = read_launches(mods)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        step_s = sorted(r["step_s"] for r in tloop.log)[len(tloop.log) // 2]
        prof = profile_window(lambda: tloop.step_fn(tp, topt, tloop.batch(
            SyntheticLMDataset(tloop.data_cfg), TRAIN_STEPS))[2]["loss"].item())
        emit(phase=phase, arch=c.name, **line, params=n_params, steps=TRAIN_STEPS,
             batch=b_rows, seq=seq, remat=True, policy="default=bf16 logits=refine_ab",
             step0=step0, loss=hist, grad_norm=[r["grad_norm"] for r in tloop.log],
             lr=[r["lr"] for r in tloop.log], step_s=[r["step_s"] for r in tloop.log],
             median_step_s=step_s, tok_per_s=b_rows * seq / step_s, wall_s=wall,
             peak_mem_gb=peak_gb, launches=ls, profile_step=prof,
             phase_s=time.monotonic() - t_phase)
        if not all(ls[n] > 0 for n in kernels):
            faults.append(f"a kernel of the path never launched: {ls}")
        if not all(math.isfinite(x) for r in tloop.log for x in (r["loss"], r["grad_norm"])):
            faults.append(f"non-finite loss or grad norm: {tloop.log}")
        if faults:
            fail(f"{phase}: {'; '.join(faults)}: {step0}")
        del tp, topt, tloop
        gc.collect()
        torch.cuda.empty_cache()
        return ls

    # 17 train_rwkv
    rcfg_t = dataclasses.replace(get_config("rwkv6-7b"), num_layers=TRAIN_RWKV_DEPTH,
                                 segments=(Segment(("rwkv6",), TRAIN_RWKV_DEPTH),))
    launches_trw = train_family(
        "train_rwkv", rcfg_t, 1, 1024,
        lambda p: {"embed": p["embed"]["table"], "lora_w_a": p["layers"][0]["lora_w"]["a"]["w"],
                   "ffn_k": p["layers"][1]["ffn_k"]["w"], "wo": p["layers"][3]["wo"]["w"],
                   "unembed": p["unembed"]["table"]},
        chunk_reset, TRAIN_RWKV_KERNELS, slow=True, depth=TRAIN_RWKV_DEPTH)
    # 18 train_zamba2
    zcfg_t = dataclasses.replace(
        zcfg_full, num_layers=6 * TRAIN_ZAMBA2_PERIODS,
        segments=(Segment(("mamba2",) * 5 + ("shared_attn",), TRAIN_ZAMBA2_PERIODS),))
    launches_tz = train_family(
        "train_zamba2", zcfg_t, 1, 1024,
        lambda p: {"embed": p["embed"]["table"], "in_proj": p["layers"][0]["in_proj"]["w"],
                   "shared_wq": p["shared"]["attn"]["wq"]["w"],
                   "shared_mlp_wo": p["shared"]["mlp"]["wo"]["w"],
                   "unembed": p["unembed"]["table"]},
        chunk_reset, TRAIN_KERNELS, slow=True, periods=TRAIN_ZAMBA2_PERIODS,
        shared_applications=TRAIN_ZAMBA2_PERIODS)
    # 19 train_whisper
    launches_tw = train_family(
        "train_whisper", wcfg_full, 2, WHISPER_TRAIN_SEQ,
        lambda p: {"tied_table": p["embed"]["table"], "enc_wq": p["enc_layers"][0]["wq"]["w"],
                   "cross_wk": p["layers"][1]["wk"]["w"], "dec_wq": p["layers"][0]["wq"]["w"],
                   "enc_mlp_wi": p["enc_layers"][1]["wi"]["w"]},
        causal_encoder_ctx, TRAIN_KERNELS, encoder_seq=wcfg_full.encoder_seq)
    # 20 train_internvl2
    icfg_t = dataclasses.replace(full_i, num_layers=TRAIN_INTERNVL2_DEPTH,
                                 segments=(Segment(("attn", "mlp"), TRAIN_INTERNVL2_DEPTH),))
    launches_ti = train_family(
        "train_internvl2", icfg_t, 1, 256,
        lambda p: {"embed": p["embed"]["table"], "wq": p["layers"][0]["wq"]["w"],
                   "mlp_wo": p["layers"][1]["wo"]["w"],
                   "wk": p["layers"][2 * TRAIN_INTERNVL2_DEPTH - 2]["wk"]["w"],
                   "unembed": p["unembed"]["table"]},
        lambda fault: contextlib.nullcontext(), TRAIN_KERNELS, roll_image=True,
        depth=TRAIN_INTERNVL2_DEPTH, image_rows=full_i.num_image_tokens)

    # ----------------------------------------------------------- 21 precision
    # The paper's Fig. 8 protocol (core/error.py) on card tensors: A, B ~
    # U[-r, r]^(N x N) from random_operands, every gemm rung on the cuda
    # route and the same rung on the torch route, cuBLAS's bf16 GEMM (f32
    # out) and f32 SGEMM with TF32 off and on, against the f64 product formed
    # on the card.  Held at every N and range: each cuda rung within its
    # bound (PRECISION_ROUTE_FACTOR times the torch route's max-norm error
    # for the rung), the ladder order of tests/test_precision.py, and each
    # PRECISION_CONTROLS rung's error above the bound of the rung it refines
    # wherever the torch route tells the two apart.
    zero_launches(mods)
    fig8_rows, prec_faults, held_controls = [], [], set()
    t_prec = time.monotonic()
    for n_p in PRECISION_N:
        for r_p in PRECISION_RANGES:
            a_p, b_p = error_mod.random_operands(n_p, value_range=r_p, seed=n_p, device=dev)
            calls = {f"cuda:{rung}": (lambda rung=rung: ops.gemm(a_p, b_p, policy=rung,
                                                                backend="cuda"))
                     for rung in PRECISION_RUNGS}
            a16, b16 = a_p.to(torch.bfloat16), b_p.to(torch.bfloat16)
            calls["cublas:bf16"] = lambda: torch.mm(a16, b16, out_dtype=torch.float32)
            calls["cublas:f32"] = lambda: torch.mm(a_p, b_p)

            def tf32_mm():
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    return torch.mm(a_p, b_p)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            calls["cublas:f32_tf32"] = tf32_mm
            results = {name: fn() for name, fn in calls.items()}
            results.update({f"torch:{rung}": ops.gemm(a_p, b_p, policy=rung, backend="torch")
                            for rung in PRECISION_RUNGS})
            results.update({f"{route}:{below}": ops.gemm(a_p, b_p, policy=below, backend=route)
                            for below in PRECISION_CONTROLS.values() for route in ("cuda", "torch")
                            if f"{route}:{below}" not in results})
            torch.cuda.synchronize(dev)
            rep = error_mod.error_report(a_p, b_p, results)
            del results
            for name, fn in calls.items():
                fig8_rows.append({"n": n_p, "range": r_p, "row": name, **rep[name],
                                  "ms": timed(fn)})
            err_k = {rung: rep[f"cuda:{rung}"]["max_vs_f64"] for rung in PRECISION_RUNGS}
            err_t = {rung: rep[f"torch:{rung}"]["max_vs_f64"] for rung in PRECISION_RUNGS}
            bound_of = {rung: PRECISION_ROUTE_FACTOR * err_t[rung] for rung in PRECISION_RUNGS}
            where = f"N={n_p} U[-{r_p}, {r_p}]"
            # (smaller, larger, factor): test_precision's order, every pair held
            pairs = [("refine_a", "bf16", 1), ("bf16x3", "refine_a", 1),
                     ("refine_ab", "refine_a", 0.5), ("bf16x6", "refine_ab", 1),
                     ("f32", "bf16", 1 / 50), ("refine_ab", "bf16", 1 / 8)]
            order = {f"{lo} < {f:g} {hi}": err_k[lo] < f * err_k[hi] for lo, hi, f in pairs}
            if not all(order.values()):
                prec_faults.append(f"{where}: the ladder order fails ({order}): {err_k}")
            for rung in PRECISION_RUNGS:
                if not err_k[rung] <= bound_of[rung]:
                    prec_faults.append(f"{where}: cuda {rung} {err_k[rung]} > its bound "
                                       f"{bound_of[rung]} (torch {err_t[rung]})")
            controls = {}
            for rung, below in PRECISION_CONTROLS.items():
                lower = rep[f"cuda:{below}"]["max_vs_f64"]
                apart = rep[f"torch:{below}"]["max_vs_f64"] > bound_of[rung]
                controls[f"{below} over {rung}"] = {"err": lower, "bound": bound_of[rung],
                                                    "held": apart}
                if apart:
                    held_controls.add(rung)
                    if not lower > bound_of[rung]:
                        prec_faults.append(f"{where}: the control {below} ({lower}) lands "
                                           f"within {rung}'s bound {bound_of[rung]}")
            emit(phase="precision_point", n=n_p, range=r_p, max_vs_f64=err_k,
                 torch_max_vs_f64=err_t, bounds=bound_of, order=order, controls_held=controls,
                 cublas={k.split(":")[1]: rep[k] for k in rep if k.startswith("cublas:")})
            del a_p, b_p, a16, b16, calls
            torch.cuda.empty_cache()
    launches_pr = read_launches(mods)
    emit(phase="precision", rows=fig8_rows, route_factor=PRECISION_ROUTE_FACTOR,
         controls=PRECISION_CONTROLS, launches=launches_pr,
         phase_s=time.monotonic() - t_prec)
    if held_controls != set(PRECISION_CONTROLS):
        prec_faults.append(f"controls never held: {set(PRECISION_CONTROLS) - held_controls}")
    if not all(launches_pr[n] > 0 for n in PRECISION_KERNELS):
        prec_faults.append(f"a kernel of the path never launched: {launches_pr}")
    if prec_faults:
        fail("precision: " + "; ".join(prec_faults))

    # ---------------------------------------------------------- 22 serve_stack
    # The serve stack (repro_torch.serve) over gemma3-1b at full size, fresh
    # params from phase 4's seed, phase 4's policy, 4 slots a replica and a
    # 1024-token context: (a) phase 4's requests through the replica pool at
    # 1 and 2 replicas (one params tree); (b) open-loop Poisson sweeps at 2
    # replicas, and the last rate again under the autoscaler; (c) the chaos
    # point on 8-row bf16 pages, every completed stream against a single-slot
    # reference engine, and the RecoveryMismatch control; (d) the HTTP
    # gateway over loopback.
    t_stack = time.monotonic()
    stack_faults: list[str] = []
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    zero_launches(mods)

    def phase4_requests(n=None, max_new=32):
        return [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=max_new) for r in reqs[:n]]

    # (a) replica-count invariance
    invariance = {}
    pool_tokens = {}
    for n_rep in (1, 2):
        pool_a = ReplicaPool(cfg, params, replicas=n_rep, batch_size=4, max_ctx=1024,
                             policy=policy)
        ra = phase4_requests()
        st = pool_a.run(ra)
        pool_tokens[n_rep] = [r.out_tokens for r in ra]
        invariance[n_rep] = {
            "wall_s": st["wall_s"], "tok_per_s": st["tok_per_s"], "tokens": st["tokens"],
            "tokens_by_replica": [rep.engine.tokens_generated for rep in pool_a.replicas],
            "shared_params": all(rep.engine.params is params for rep in pool_a.replicas),
            "pages_outstanding": pool_a.pages_outstanding(),
            "tokens_equal_phase4": pool_tokens[n_rep] == [r.out_tokens for r in reqs]}
        if not invariance[n_rep]["tokens_equal_phase4"]:
            stack_faults.append(f"(a) {n_rep} replica(s): tokens differ from phase 4's: "
                                f"{[(r.rid, r.out_tokens[:4]) for r in ra]}")
        if invariance[n_rep]["pages_outstanding"] or not invariance[n_rep]["shared_params"] \
                or not all(invariance[n_rep]["tokens_by_replica"]):
            stack_faults.append(f"(a) {n_rep} replica(s): {invariance[n_rep]}")
        del pool_a
    # one pool step with both replicas' 4 slots busy (after the step that
    # admits them): host wall time against the kernels' (idle share)
    pool_p = ReplicaPool(cfg, params, replicas=2, batch_size=4, max_ctx=1024, policy=policy)
    for r in phase4_requests(max_new=16):
        pool_p.submit(r)
    pool_p.step()
    pool_step_profile = profile_window(pool_p.step)
    pool_p.run([])
    del pool_p
    torch.cuda.empty_cache()

    # (b) the load sweep, then its last rate under the autoscaler, which
    # starts at its least replica count
    spec = loadgen.LoadSpec(**STACK_SPEC)
    sweep = loadgen.run_sweep(cfg, params, rates=STACK_RATES, spec=spec, replicas=2,
                              batch_size=4, max_ctx=1024, policy=policy,
                              max_queue=STACK_MAX_QUEUE)
    scaled = loadgen.run_sweep(cfg, params, rates=STACK_RATES[-1:], spec=spec, replicas=1,
                               batch_size=4, max_ctx=1024, policy=policy,
                               max_queue=STACK_MAX_QUEUE,
                               autoscale=AutoscalePolicy(min_replicas=1, max_replicas=3))
    points = sweep["points"]
    top = points[-1]
    if len(points) != len(STACK_RATES) or any(p["completed"] + p["rejected"] != spec.n_requests
                                              for p in points):
        stack_faults.append(f"(b) the sweep lost requests: {points}")
    if not (top["rejected"] or top["p99_ttft_ticks"] > 1):
        stack_faults.append(f"(b) rate {top['arrival_rate']} neither queued nor rejected: {top}")
    if scaled["points"][0]["scale_events"] < 1:
        stack_faults.append(f"(b) the autoscaled point never scaled: {scaled['points'][0]}")
    torch.cuda.empty_cache()

    # (c) chaos on 8-row bf16 pages: the pool under the fault plan, the
    # autoscaler repairing, each completed stream against one single-slot
    # reference engine (memoized per prompt and budget)
    plan = FaultPlan.parse(STACK_CHAOS)

    def paged_engine(idx, pol, batch=4):
        e = ServeEngine(cfg, batch_size=batch, max_ctx=1024, policy=pol, eos_id=-1,
                        max_queue=STACK_MAX_QUEUE, replica=str(idx), device=dev,
                        kv_layout="paged", kv_page_size=8)
        e.load(params)
        return e

    pool_c = ReplicaPool(cfg, params, replicas=2, batch_size=4, max_ctx=1024,
                         policy=paged_policy, max_queue=STACK_MAX_QUEUE, eos_id=-1,
                         engine_factory=plan.wrap_factory(paged_engine, n_replicas=2))
    ref_eng = paged_engine("ref", paged_policy, batch=1)
    ref_tokens: dict = {}

    def reference(prompt, max_new):
        key = (bytes(np.asarray(prompt, np.int32)), max_new)
        if key not in ref_tokens:
            rq = Request(rid=0, prompt=prompt, max_new_tokens=max_new)
            ref_eng.run([rq])
            ref_tokens[key] = list(rq.out_tokens)
        return ref_tokens[key]

    work = loadgen.sample_workload(spec, STACK_CHAOS_RATE, vocab)
    torch.cuda.reset_peak_memory_stats(dev)
    chaos_point = loadgen.run_point(
        pool_c, spec, STACK_CHAOS_RATE, vocab=vocab, chaos=plan, reference=reference, work=work,
        autoscaler=Autoscaler(pool_c, AutoscalePolicy(min_replicas=2, max_replicas=2)))
    chaos_point["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    completed = [r for _, r in work if r.done and not (r.expired or r.cancelled)]
    chaos_point["completed_token_exact"] = all(
        r.out_tokens == reference(r.prompt, r.max_new_tokens) for r in completed)
    chaos_point["fired"] = [getattr(rep.engine, "fired", None) for rep in pool_c.replicas]
    if not (chaos_point["completed_token_exact"] and chaos_point["recovered_token_exact"]
            and chaos_point["requests_recovered"] >= 1 and chaos_point["leaked_pages"] == 0
            and chaos_point["replica_deaths"] >= 1 and len(completed) == spec.n_requests
            - chaos_point["rejected"]):
        stack_faults.append(f"(c) chaos: {chaos_point}")
    # control: a recovery re-admission whose last emitted token was changed
    # must raise RecoveryMismatch and hand back the pages it reserved
    victim = completed[0]
    forged = Request(rid=-2, prompt=victim.prompt, max_new_tokens=victim.max_new_tokens,
                     out_tokens=list(victim.out_tokens[:5]))
    forged.out_tokens[-1] = (forged.out_tokens[-1] + 1) % vocab
    try:
        ref_eng.admit(forged)
        mismatch = None
    except RecoveryMismatch as e:
        mismatch = {"rid": e.rid, "index": e.index, "expected": e.expected, "got": e.got}
    control = {"raised": mismatch, "pages_outstanding_after": ref_eng.pages_outstanding(),
               "slot_free": ref_eng.slot_req == [None]}
    if mismatch is None or control["pages_outstanding_after"] or not control["slot_free"]:
        stack_faults.append(f"(c) the RecoveryMismatch control did not fire cleanly: {control}")
    del pool_c, ref_eng
    torch.cuda.empty_cache()

    # (d) the gateway over loopback: 4 of phase 4's prompts streamed at once
    # (tokens equal to pool.run's in (a)), a submit past the in-flight
    # watermark (429 + Retry-After), /metrics, then a client that leaves
    # mid-stream (its slot freed) and /healthz
    reg = MetricsRegistry()
    pool_d = ReplicaPool(cfg, params, replicas=2, batch_size=4, max_ctx=1024, policy=policy,
                         max_queue=STACK_MAX_QUEUE, metrics=reg)

    async def gateway_run():
        gw = Gateway(pool_d, host="127.0.0.1", port=0, metrics=reg, max_inflight=4)
        await gw.start()
        try:
            opened = [await http_open(gw.port, "POST", "/v1/generate",
                                      {"prompt": r.prompt.tolist(), "max_new_tokens": 32})
                      for r in reqs[:4]]
            firsts = [await next_line(rd) for rd, _ in opened]
            over = await http_call(gw.port, "POST", "/v1/generate",
                                   {"prompt": reqs[4].prompt.tolist(), "max_new_tokens": 4})
            streams = []
            for (rd, wr), first in zip(opened, firsts):
                lines = [first]
                while "done" not in lines[-1]:
                    lines.append(await next_line(rd))
                wr.close()
                streams.append(lines)
            metrics_text = await http_call(gw.port, "GET", "/metrics")
            rd, wr = await http_open(gw.port, "POST", "/v1/generate",
                                     {"prompt": reqs[5].prompt.tolist(), "max_new_tokens": 96})
            await next_line(rd)
            await next_line(rd)
            wr.close()
            for _ in range(3000):
                if pool_d.idle and not gw._inflight:
                    break
                await asyncio.sleep(0.01)
            health = await http_call(gw.port, "GET", "/healthz")
            return streams, over, metrics_text, health
        finally:
            await gw.stop()

    streams, over, metrics_text, health = asyncio.run(asyncio.wait_for(gateway_run(), 600))
    streamed = [[ln["token"] for ln in lines[:-1]] for lines in streams]
    metrics_tokens = sum(float(ln.split()[-1]) for ln in metrics_text.splitlines()
                         if ln.startswith("serve_tokens_total{"))
    health_obj = json.loads(health.split("\r\n\r\n", 1)[1])
    cancelled = reg.counter("serve_requests_cancelled")
    gateway = {
        "streams_equal_pool_run": streamed == pool_tokens[2][:4],
        "streamed_tokens": sum(map(len, streamed)),
        "metrics_serve_tokens": metrics_tokens,
        "over_watermark_status": int(over.split(" ", 2)[1]),
        "retry_after": "Retry-After: " in over,
        "disconnect_cancelled": sum(cancelled.value(replica=str(i)) for i in range(2)),
        "gateway_disconnects": reg.counter("gateway_disconnects").value(),
        "slots_free": all(r is None for rep in pool_d.replicas for r in rep.engine.slot_req),
        "healthz": health_obj}
    if not (gateway["streams_equal_pool_run"] and metrics_tokens == gateway["streamed_tokens"]
            and gateway["over_watermark_status"] == 429 and gateway["retry_after"]
            and gateway["disconnect_cancelled"] == 1 and gateway["gateway_disconnects"] == 1
            and gateway["slots_free"] and health_obj.get("ok") is True):
        stack_faults.append(f"(d) gateway: {gateway}")
    del pool_d, params
    torch.cuda.empty_cache()

    launches_ss = read_launches(mods)
    if not all(launches_ss[n] > 0 for n in STACK_KERNELS):
        stack_faults.append(f"a kernel of the path never launched: {launches_ss}")
    emit(phase="serve_stack", arch=cfg.name, slots_per_replica=4, max_ctx=1024,
         invariance=invariance, pool_step_profile=pool_step_profile,
         sweep_spec=STACK_SPEC, max_queue=STACK_MAX_QUEUE,
         sweep=points, autoscaled=scaled["points"][0], chaos=chaos_point,
         recovery_mismatch_control=control, gateway=gateway, launches=launches_ss,
         phase_s=time.monotonic() - t_stack)
    if stack_faults:
        fail("serve_stack: " + "; ".join(stack_faults))

    # ------------------------------------------------------------- 23 audit
    from repro_torch import analysis
    from repro_torch.kernels import _trace
    audit_policies = {"serve": policy, "serve_paged_bf16": paged_policy,
                      "serve_paged_int8_fp8x3": int8_policy, "serve_naive": naive_policy,
                      "train": tpolicy, "serve_moe": mpolicy, "train_moe": mt_policy,
                      "serve_rwkv": rpolicy, "serve_zamba2": zpolicy,
                      # phases 25-27: dbrx on serve_moe's policies, dense and paged;
                      # starcoder2 and command-r on phase 4's and phase 5's
                      "serve_dbrx": mpolicy, "serve_dbrx_paged": moe_paged_policy,
                      "serve_starcoder2": policy, "serve_starcoder2_paged": paged_policy,
                      "serve_command_r": policy, "serve_command_r_paged": paged_policy}
    # earlier phases' garbage is collected first: a collection during the
    # audit would free their tensors and move the reading
    gc.collect()
    torch.cuda.synchronize(dev)
    counts0, mem0 = read_launches(mods), torch.cuda.memory_allocated(dev)
    t_audit = time.monotonic()
    sites_seen: dict[str, int] = {}
    traced_launch = _trace.launch

    def counting_launch(site, *inputs):
        sites_seen[site.kernel] = sites_seen.get(site.kernel, 0) + 1
        return traced_launch(site, *inputs)

    _trace.launch = counting_launch
    try:
        findings = analysis.audit_all(device="cuda")
        for pol in {id(p): p for p in audit_policies.values()}.values():   # each once
            findings += analysis.audit_execution_policy(pol, device="cuda")
    finally:
        _trace.launch = traced_launch
    audit_s = time.monotonic() - t_audit
    gc.collect()
    torch.cuda.synchronize(dev)
    verdict = analysis.apply_baseline(findings, analysis.load_baseline(None))
    counts1, mem1 = read_launches(mods), torch.cuda.memory_allocated(dev)
    registry_kernels = ("gemm_tiled", "gemm_refined", "gemm_lowp", "gemm_naive",
                        "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                        "flash_decode", "flash_paged_decode", "grouped_gemm", "grouped_gemm_dw")
    # the eager path's cost of the hook: one decode-shape gemm_tiled call's
    # enqueue (gemma3's MLP in, 4 x 1152 against its f32 6912-wide weight),
    # queued behind a device spin so the host never waits on the card, and
    # the flag test alone
    xa, wa = randn((4, 1152), dtype=torch.bfloat16), randn((1152, 6912), 0.03)
    gt.gemm_tiled(xa, wa)
    torch.cuda.synchronize(dev)
    n_enq = 200
    torch.cuda._sleep(int(0.05 * 2e9))
    t = time.monotonic()
    for _ in range(n_enq):
        gt.gemm_tiled(xa, wa)
    enqueue_ms = (time.monotonic() - t) * 1e3 / n_enq
    torch.cuda.synchronize(dev)
    t = time.monotonic()
    for _ in range(100000):
        if _trace.ACTIVE:
            break
    flag_ns = (time.monotonic() - t) * 1e9 / 100000
    del xa, wa
    emit(phase="audit", targets=["registry", "python_sources", "cuda_sources",
                                 *(f"policy:{k}" for k in audit_policies)],
         findings=len(findings), unsuppressed=[str(f) for f in verdict.unsuppressed],
         suppressed=len(verdict.suppressed), stale=list(verdict.stale_keys),
         kernel_sites=dict(sorted(sites_seen.items())), seconds=audit_s,
         launches_changed={k: counts1[k] - counts0[k] for k in counts0
                           if counts1[k] != counts0[k]},
         memory_allocated=[mem0, mem1], gemm_tiled_decode_enqueue_ms=enqueue_ms,
         trace_flag_test_ns=flag_ns)
    if verdict.unsuppressed or verdict.stale_keys:
        fail(f"audit: {len(verdict.unsuppressed)} unsuppressed finding(s), "
             f"{len(verdict.stale_keys)} stale suppression(s)")
    if counts1 != counts0 or mem1 != mem0:
        fail(f"audit: kernel counters or device memory moved ({mem0} -> {mem1} bytes)")
    missing = [k for k in registry_kernels if not sites_seen.get(k)]
    if missing:
        fail(f"audit: no kernel site traced for {missing}")

    # -------------------------------------------------------------- 24 mesh
    mesh_launches = mesh_phase(dev, cfg, loop, tpolicy, train_peak_gb, step_s, mixtral,
                               mpolicy, moe_backends, mreqs)

    # ----------------------------------------- 25-27 serve dbrx, starcoder2, command-r
    # Each served as phase 14 is (the giant helpers above), then its paged
    # twin; one prompt's prefill logits against the torch routes with a
    # faulty control above the bound.

    # ---- 25 serve_dbrx: dbrx-132b at depth DBRX_DEPTH on serve_moe's
    # policy (the grouped experts on cuda_grouped); the reference dropless
    # (capacity_factor = E / k); one MoE layer's experts rolled by one as
    # the control
    t_phase = time.monotonic()
    dcfg = giant_config("dbrx-132b", DBRX_DEPTH)
    dparams, deng, dreqs, launches_db, dbrx_faults, dline = serve_giant(
        dcfg, mpolicy, 25, SERVE_MOE_KERNELS)
    grouped_loops_ok(launches_db, "serve_dbrx")
    dcfg_dropless = dataclasses.replace(dcfg, capacity_factor=dcfg.num_experts / dcfg.top_k)
    dprompt = prompt_of(dreqs[0])
    dlk = giant_prefill(dcfg, dparams, mpolicy, dprompt)
    dlr = giant_prefill(dcfg_dropless, dparams, mref_policy, dprompt)
    dlc = giant_prefill(dcfg_dropless, rolled_experts(dparams, 1), mref_policy, dprompt)
    dline.update(depth=DBRX_DEPTH, experts=dcfg.num_experts, top_k=dcfg.top_k,
                 **held_logits(dlk, dlr, dlc, dcfg.vocab_size, MOE_LOGITS_BOUND,
                               "rolled-experts", dbrx_faults))
    del dlk, dlr, dlc
    dpline, launches_dbp = serve_paged_twin(dcfg, dparams, dreqs, dbrx_faults,
                                            moe_paged_policy, SERVE_MOE_PAGED_KERNELS)
    emit_giant("serve_dbrx", dparams, deng, dreqs, dline, t_phase, dpline)
    grouped_loops_ok(launches_dbp, "serve_dbrx_paged")
    if dbrx_faults:
        fail("serve_dbrx: " + "; ".join(dbrx_faults))
    del deng, dparams
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 26 serve_starcoder2: starcoder2-15b whole on the serve policy,
    # every QKV and MLP bias seeded at STARCODER2_BIAS_SCALE on the device
    # (init makes them zero); the same stack with every bias zeroed as the
    # control
    def seed_biases(prm):
        bgen = torch.Generator(device=dev).manual_seed(26)
        n_b = 0
        for lp in prm["layers"]:
            for sub in lp.values():
                if isinstance(sub, dict) and "b" in sub:
                    sub["b"].normal_(0.0, STARCODER2_BIAS_SCALE, generator=bgen)
                    n_b += 1
        return {"bias_scale": STARCODER2_BIAS_SCALE, "bias_leaves": n_b}

    def zero_biases(prm):
        return {**prm, "layers": [
            {k: ({**v, "b": torch.zeros_like(v["b"])} if isinstance(v, dict) and "b" in v
                 else v) for k, v in lp.items()} for lp in prm["layers"]]}

    t_phase = time.monotonic()
    scfg = get_config("starcoder2-15b")
    sparams, seng, sreqs, launches_sc, sc_faults, sline = serve_giant(
        scfg, policy, 26, SERVE_KERNELS, prep=seed_biases)
    sprompt = prompt_of(sreqs[0])
    slk = giant_prefill(scfg, sparams, policy, sprompt)
    slr = giant_prefill(scfg, sparams, ref_policy, sprompt)
    slc = giant_prefill(scfg, zero_biases(sparams), ref_policy, sprompt)
    sline.update(depth=scfg.num_layers, **held_logits(slk, slr, slc, scfg.vocab_size,
                                                      LOGITS_BOUND, "zero-bias", sc_faults))
    del slk, slr, slc
    spline, launches_scp = serve_paged_twin(scfg, sparams, sreqs, sc_faults)
    emit_giant("serve_starcoder2", sparams, seng, sreqs, sline, t_phase, spline)
    if sc_faults:
        fail("serve_starcoder2: " + "; ".join(sc_faults))
    del seng, sparams
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 27 serve_command_r: command-r-35b at depth COMMAND_R_DEPTH on the
    # serve policy; the reference's refine_ab unembed over vocab chunks;
    # fp8 MLPs on the kernel routes as the control (nemotron's)
    t_phase = time.monotonic()
    ccfg = giant_config("command-r-35b", COMMAND_R_DEPTH)
    cparams, ceng, creqs, launches_cr, cr_faults, cline = serve_giant(
        ccfg, policy, 27, SERVE_KERNELS)
    cprompt = prompt_of(creqs[0])
    clk = giant_prefill(ccfg, cparams, policy, cprompt)
    clr = giant_prefill(ccfg, cparams, ref_policy, cprompt, chunked=True)
    clc = giant_prefill(ccfg, cparams, fp8_kernel_policy, cprompt)
    cline.update(depth=COMMAND_R_DEPTH, **held_logits(clk, clr, clc, ccfg.vocab_size,
                                                      LOGITS_BOUND, "fp8-MLP", cr_faults))
    del clk, clr, clc
    cpline, launches_crp = serve_paged_twin(ccfg, cparams, creqs, cr_faults)
    emit_giant("serve_command_r", cparams, ceng, creqs, cline, t_phase, cpline)
    if cr_faults:
        fail("serve_command_r: " + "; ".join(cr_faults))
    del ceng, cparams
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 28 kernels
    rows = []
    by_path = {"serve": launches, "serve_paged_bf16": launches_pa,
               "serve_paged_int8_fp8x3": launches_pb, "train": train_launches,
               "serve_moe": launches_ms, "serve_moe_paged": launches_pm,
               "train_moe": launches_mt, "serve_naive": launches_n,
               "batched": launches_bt, "serve_rwkv": launches_rw, "wkv6": launches_wkv,
               "serve_zamba2": launches_z, "serve_zamba2_paged": launches_zp,
               "serve_nemotron": launches_nm, "serve_whisper": launches_w,
               "serve_whisper_paged": launches_wp, "serve_internvl2": launches_i,
               "serve_internvl2_paged": launches_ip, "train_rwkv": launches_trw,
               "train_zamba2": launches_tz, "train_whisper": launches_tw,
               "train_internvl2": launches_ti, "precision": launches_pr,
               "serve_stack": launches_ss, "mesh": mesh_launches, "serve_dbrx": launches_db,
               "serve_dbrx_paged": launches_dbp, "serve_starcoder2": launches_sc,
               "serve_starcoder2_paged": launches_scp, "serve_command_r": launches_cr,
               "serve_command_r_paged": launches_crp}
    # every bf16 flash forward and dW launch of every path ran the wgmma
    # kernel; no gemm_tiled (the bf16 rung) or gemm_refined launch ran the
    # WMMA tile, so each one at M <= 16 ran the split-K loop and each above
    # the wgmma mainloop; every decode launch (all bf16 at B = 4 slots) ran
    # its KV walk split
    for path, ls in by_path.items():
        for name in SM90_ON_EVERY_PATH:
            if ls[name] and ls[f"{name}.sm90"] != ls[name]:
                fail(f"{path}: {name} ran {ls[f'{name}.sm90']} of its {ls[name]} launches on "
                     f"the wgmma kernel")
        for name in ("gemm_tiled", "gemm_refined", "gemm_lowp"):
            if ls[f"{name}.wmma"]:
                fail(f"{path}: {name} ran the WMMA tile {ls[f'{name}.wmma']} times")
        for name in SPLIT_COUNTS:
            if ls[f"{name}.split"] != ls[name]:
                fail(f"{path}: {name} split {ls[f'{name}.split']} of its {ls[name]} launches")
    for name, (src, replaces) in KERNELS.items():
        # the row's headline check: gemma3's windowed (local-layer) case for
        # the flash forward, the model's inputs for wkv6, the path's first
        # shape otherwise
        first = checks[name][{"flash_attention": 1, "wkv6": -1}.get(name, 0)]
        if name in TRAIN_ONLY:
            path_launches = train_launches[name]
        elif name == "flash_paged_decode":
            path_launches = (launches_pa[name] + launches_pb[name] + launches_pm[name]
                             + launches_zp[name] + launches_wp[name] + launches_ip[name]
                             + launches_dbp[name] + launches_scp[name] + launches_crp[name])
        elif name == "gemm_lowp":
            path_launches = launches_pb[name]
        elif name == "grouped_gemm":
            path_launches = (launches_ms[name] + launches_pm[name] + launches_mt[name]
                             + launches_db[name] + launches_dbp[name])
        elif name == "grouped_gemm_dw":
            path_launches = launches_mt[name]
        elif name == "gemm_naive":
            path_launches = launches_n[name]
        elif name in BATCHED_KERNELS:
            path_launches = launches_bt[name]
        elif name == "wkv6":
            path_launches = launches_wkv[name]
        else:
            path_launches = launches[name]
        rows.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                     "replaces": replaces, "launches": path_launches,
                     "launches_by_path": {p: ls[name] for p, ls in by_path.items()},
                     **({"launches_by_loop": {
                         p: {loop: ls[f"{name}.{loop}"] for loop in LOOP_COUNTS[name]}
                         for p, ls in by_path.items() if ls[name]}}
                        if name in LOOP_COUNTS else {}),
                     **({"split_launches_by_path": {p: ls[f"{name}.split"]
                                                    for p, ls in by_path.items() if ls[name]}}
                        if name in SPLIT_COUNTS else {}),
                     "max_abs_err": max(c["max_abs_err"] for c in checks[name]),
                     "ms": first["ms"], "device_ms": first["device_ms"],
                     "host_ms": first["host_ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"], "shape": first["what"],
                     **({"library_call": first["library_call"]} if "library_call" in first else {}),
                     "checks": checks[name]})
    # which mainloop each GEMM check ran (every M > 16 gemm_tiled shape and
    # every 64/128-row bf16 grouped shape must run sm90, each check says so)
    emit(phase="mainloops", rows=loop_rows,
         **{f"{loop}_rows": sum(r["mainloop"] == [loop] for r in loop_rows)
            for loop in gt.MAINLOOPS},
         gemm_tiled_wmma_launches={p: ls["gemm_tiled.wmma"] for p, ls in by_path.items()},
         gemm_refined_wmma_launches={p: ls["gemm_refined.wmma"] for p, ls in by_path.items()},
         gemm_lowp_wmma_launches={p: ls["gemm_lowp.wmma"] for p, ls in by_path.items()},
         grouped_gemm_wmma_launches={p: ls["grouped_gemm.wmma"] for p, ls in by_path.items()})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
