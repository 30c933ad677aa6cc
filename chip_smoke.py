#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch_kernels``), holds each kernel against its plain
PyTorch version on the card, and drives these paths (training last):

* the single-device segmentation path on 512x512 synthetic slices (K = 2,
  then K = 3, then K = 9 labels on the three-phase image, which runs the
  tick's runtime-K variant), planned and solved through the session API
  (one ``fused_em_tick`` launch and one flag read per MAP iteration, on
  the bucket's ``TickWorkspace``);
* slice stacks: 16 K = 2 and 4 K = 3 slices of 512x512 through
  ``Segmenter.segment_stack(batch="always")``, one ``run_em_batched`` per
  stack (per lockstep MAP iteration one launch of the tick's lane axis for
  every running lane, on the bucket's ``BatchTickWorkspace``);
* serving: 24 K = 2 requests (512x512 slices) through
  ``SegmentationEngine(max_batch=8)``, with ``tick_iters=4`` and
  ``"auto"``: per micro-step one launch of the tick's pool entry
  (``PoolTickWorkspace``), every lane at its own MAP iteration, and
  between ticks admission into freed slots; then a mixed-K pool (4 K = 2
  and 4 K = 3 requests, K = 3 pool of 4 slots) and a chaos stream (a
  ``bad_init``, a ``nan_data`` and a ``never_converge`` request among 8);
  then the same stream and mixed-K pool in modes ``static`` and
  ``faithful`` on the mode's pool (``DppPoolWorkspace``: per micro-step
  one flat DPP step over every live lane);
* the modes ``static`` and ``faithful``, the paper's primitive sequence:
  the K = 2, 3 and 9 slices' plans through
  ``Segmenter(ExecutionConfig(mode=m))`` (per MAP iteration counts,
  energies, the per-element minimum by an axis-min or by SortByKey and
  ``segment_reduce`` ``min``, hood sums by its ordered ``add``, votes;
  per EM iteration three ordered M-step sums), and at K = 2, 3 the same
  on the sharded route over the one-rank NCCL group; then the modes'
  stacks: the stack phase's 16 K = 2 and 4 K = 3 slices in each mode
  through ``segment_stack(batch="always")`` and ``submit``/``drain``, one
  ``run_em_batched`` per stack on the bucket's ``DppBatchWorkspace`` (per
  lockstep MAP iteration one flat DPP step over every lane, whose
  launches are ``segment_reduce``'s); the K = 2 slice in all three modes
  against the port's NumPy oracle (``reference.golden_em``); then the
  fallback phase: ``FallbackPolicy`` under the chaos harness's compile
  and execute faults, on one solve and on a mode's stack;
* the sharded route: ``run_em_sharded`` on the same plans over a
  one-rank NCCL process group made in this process, on the rank's
  ``MapStepWorkspace`` (per MAP iteration one ``fused_map_step`` launch,
  one all-reduce of its hood sums and votes, one flag read and, past the
  window, the AND of the flag word);
* planning (before serving): the calibrated cost model
  (``repro_torch.planning``) and its consumers: (a) the checked-in table
  is the card's (``meta.platform`` ``"gpu"``, ``model_for`` calibrated,
  ``--refit`` reproduces its bytes; its card beside the running one); (b)
  the K = 2 slice in all three modes, ``Plan.predicted_optimize_s``
  beside the measured warm ``optimize_s`` (best and median of 5), the
  model's ranking of the modes the measurements'; (c) the 16-slice K = 2
  stack through ``segment_stack(batch="auto")``: ``choose_batch``'s
  decision, the route taken (by launch count), every slice bit for bit
  ``"always"`` and ``"never"``, and the chosen route's measured
  ``optimize_s`` per slice at most 10 % above the other's; (e)
  ``launch.segment --shards auto --slices 1`` in a subprocess; (f) the
  budget ledger's snapshot, ``expect("cold_compile")``,
  ``expect("warm_execute")`` and ``expect("warm_tick")`` around the
  session's and the engine's calls.  (d), in the serve phase: each
  stream's tick-cost prior from the model beside the engine's fitted
  ``(a, b)``;
* analysis (after planning, before serving; ``repro_torch.analysis``):
  (a) the op and host-read census of the warm K = 2 slice in each of
  the three modes (``execute``, ``run_em``) and of the 16-slice K = 2
  stack in each mode (``submit``/``drain``, ``run_em_batched``), each
  equal scope by scope (MAP iteration, EM boundary) to the CPU's counts
  in ``src/repro_torch/analysis/ANALYSIS.json``, with the profiler's
  kernels per MAP iteration beside the census's launches; (b) the kernel
  pass: the cases of every exported entry that launches a kernel under
  ``compute-sanitizer`` (memcheck, racecheck, synccheck, initcheck) or,
  where the sanitizer cannot run on the card, its guard fallback (a
  guarding allocator under two poison bytes) and the barrier and
  broadcast lints, with no finding, and each known-bad fixture caught
  exactly once; the phase's seconds beside the card's name and power
  limit; each kernel of the ``kernels`` line gains ``sanitizer`` (errors
  by tool), ``sanitizer_via`` and ``sanitizer_cases``;
* LM serving: ``qwen2-1.5b`` at full width and depth (28 layers, bf16,
  random weights from a ``torch.Generator`` seeded 0) behind
  ``ServingEngine(max_batch=4, max_seq=2048)``, greedy, 8 requests (4
  prompts of 512 tokens, 4 of 1024, from ``numpy.random.default_rng(0)``)
  of 32 new tokens each: one ``flash_attention`` launch per layer and
  prefilled request, 224 in all, every one on the bf16 tensor-core
  kernel (``flash_attention.launches_tc``);
* LM-MoE serving, the same traffic twice per model (``LM_MOE``):
  ``deepseek-v2-lite-16b`` whole (27 layers, MLA, 64 experts top-6 and 2
  shared; bf16, 0 kernel launches: its attention is the plain MLA latent
  scan, as the reference's) and ``qwen3-moe-235b-a22b`` at full width with
  its depth cut to 4 layers (128 experts top-8; 32 ``flash_attention``
  launches, all on the tensor-core kernel, at (1, 64, 4, S, 128), group
  16).  ``lm_moe_serve`` lines: parameters, init seconds, peak memory,
  tok/s, TTFT, prefill ms by length, the share of (token, choice) lanes
  the capacity dropped per dispatch size from ``moe.logged``, launches,
  and the second run's tokens bit for bit the first's.
  ``lm_moe_kernel_vs_plain`` (qwen3-moe): the dense family's limits (a)
  and (b) below, with the tokens whose expert set differs between the
  paths and the plain path's k-th minus (k+1)-th router logit.
  ``lm_moe_card_vs_cpu``: one float32 ``moe_ffn`` per model at full width
  over 1024 tokens on the card and on the CPU (expert sets equal apart
  from router near-ties within 1e-5, keep masks and dropped counts equal,
  outputs within 1e-4), and for deepseek one ``mla_attn`` (1e-4).
  ``lm_moe_seconds`` lines: each model's and the phase's seconds beside
  the card's name and power limit.
* LM families ``ssm``, ``hybrid`` and ``vlm``, the same traffic twice per
  model (``LM_FAMILIES``): ``mamba2-130m`` whole (24 layers of Mamba2's
  chunked SSD, plain PyTorch as the reference's: 0 kernel launches),
  ``zamba2-2.7b`` whole (54 Mamba2 layers and 9 applications of its one
  shared attention block: 72 ``flash_attention`` launches at (1, 32, 32,
  S, 80), all on the CUDA-core kernel, D = 80) and ``llava-next-34b`` at
  full width with its depth cut to 8 layers (2880 patch embeddings, rows
  of its own embedding table at ids from ``default_rng(1)``, in front of
  each prompt: S = 3392 and 3904, ``max_seq`` 4096; 64 launches at (1,
  56, 8, S, 128), group 7, all on the tensor-core kernel).
  ``lm_families_serve`` lines as ``lm_moe_serve``'s.
  ``lm_families_kernel_vs_plain`` (zamba2, llava): (a) float32 at full
  width, zamba2 12 layers (2 applications), llava 2 layers: greedy tokens
  equal, logits within 1e-4 of their largest magnitude (the element-wise
  rtol 1e-4 / atol 1e-5 printed too); (b) the bf16 models: first token
  equal on at least 7 of 8 (a miss at a bf16 tie not counted), cosine at
  least 0.99.  ``lm_families_card_vs_cpu``: one float32 ``ssd_forward``
  with its states at mamba2's and zamba2's full width over 1024 tokens (8
  chunks) and 8 ``ssd_decode`` steps from them, card against CPU within
  1e-4 of their largest magnitude; mamba2-130m whole in float32: prefill
  logits within 1e-4 of theirs and the greedy tokens of 8 decode steps
  equal.  ``lm_families_vlm_splice``: llava's prefill with patches equal
  to its own embedding rows of the prompt's first 2880 ids equals the
  prefill without them, bit for bit.  ``lm_families_seconds`` lines
  beside the card's name and power limit.
* LM family ``encdec`` in the same phase and on the same traffic:
  ``whisper-large-v3`` whole (32 encoder and 32 decoder layers, d_model
  1280, 20 heads of 64), each request with its own frame embeddings
  (1500, 1280) from ``default_rng(2)``: per prefilled request 32
  bidirectional ``flash_attention`` launches at (1, 20, 20, 1500, 64),
  whose last tile holds 28 of 64 rows, and 32 causal ones at (1, 20, 20,
  S, 64), all on the tensor-core kernel (512 a run); cross-attention and
  decode are the plain ``chunked_attention``, as the reference's.
  ``lm_families_kernel_vs_plain``: (a) float32 at 4 + 4 layers, (b) the
  bf16 model, the limits above.  Before the phase, ``flash_ragged_check``
  holds the tensor-core kernel at the encoder's shape and at (2, 4, 2,
  200, 64), causal and not, on peaked scores: each row within
  ``ROW_TOL`` of its largest value (the last q tile's rows reported
  apart), with NaN in the memory after q, k and v (keys past S in the
  last K/V stage must be masked) and a sentinel after the output that
  must stay (rows past S must not be stored).
* training (``run_train``, the last phase, after serving): (a)
  ``qwen2-1.5b`` whole (28 layers, bf16 parameters, float32 master and
  moments, remat ``dots``) through ``launch.train.build`` and
  ``run_training`` for 8 steps of 8 sequences of 512 tokens from
  ``training.data``, with a checkpoint directory under ``build/``: per
  step 56 ``flash_attention`` launches (28 forward, 28 in the remat
  recompute), all on the tensor-core kernel; every loss finite, step 0's
  within (0.5, 2.5)·ln V, the last three steps' mean below the first
  three's; then every layer's wq, wk and wv get a non-zero gradient
  (``train_model``, ``train_run`` lines: the memory reckoned beforehand,
  ms per step, tokens/s, peak GB, the checkpoint's bytes).  (b)
  ``flash_attention`` under autograd at (8, 12, 2, 512, 128) causal and
  (1, 20, 20, 1500, 64) non-causal: the kernel route's dq, dk, dv equal
  autograd through the plain version bit for bit
  (``train_flash_autograd``).  (c) qwen2-1.5b at full width, 4 layers,
  float32, 2 steps on the kernel route and on ``backend="torch"``: losses
  and grad norms within 1e-4 relative (``train_kernel_vs_plain``).  (d)
  every family's reduced config, float32, 2 steps from one CPU-built
  state on the card and on the CPU, losses within 1e-4 relative
  (``train_card_vs_cpu``).  (e) 4 layers at full width: 4 uninterrupted
  steps against a run that crashes after step 3 (checkpoints every 2)
  and its restart, which resumes from step 2 and repeats the losses and
  the final state bit for bit (``train_resume``).  (d) and (e) run under
  ``torch.use_deterministic_algorithms(True)``.  Then a flash ``timing``
  line at the training call, and ``train_seconds``.

For each path it sets the launch counts to 0 just before and reads them
just after, checks that the path went through its kernels, and holds it
against its own plain path (``backend="torch"``, which must launch no
kernel) and, for the sharded route, against the single-device route.  It
prints its findings as one JSON object per line.  The last three lines
are: the ``kernels`` line, which lists every kernel with its launches on
its path, its largest error against its plain version, its times and its
bound; then the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them; then
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that last line.  It also exits non-zero
when CUDA is absent or the package is not beside it.  ``--profile`` adds
device-time breakdowns from ``torch.profiler`` (each kernel alone, one
K = 2 solve of each segmentation path after 10 timed warm solves, one
LM prefill at S = 1024 and one decode step, with their device idle
shares, the tick's pool launch, a warm served stream, and one training
step with the flash forward's device time against its plain-recompute
backward's).  A
``profiler_lead`` line counts the traces by the lead records the
profiler lost (``device_profile``).  Float32 products run in full
float32 (TF32 off, the defaults, set explicitly).  After the build a ``ptxas`` line gives the registers
and spills of the tensor-core flash kernels (any spill in the flash
library fails the run); the
``flash_attention`` timing lines give the model shapes (qwen2-1.5b's and
qwen3-moe's) with their device
times (``torch.profiler``), ``scaled_dot_product_attention`` beside them
and the share of the bound; the ``kernels`` line adds the count of
``HGMMA`` instructions in the flash library's SASS where ``cuobjdump``
exists.

Tolerances (kernel against plain version, same inputs, on the card):

* segment_reduce: integer-valued ``add`` and every ``min`` exact; random
  float ``add`` within 1e-5 of the segment's sum of magnitudes (+ 1e-6):
  the plain version sums with atomics in an order that changes from run to
  run, the kernel on a fixed-point grid.  Float ``add`` is order-free: at
  24,784 and 10**6 shuffled values into 1555 and 10**5 segments, and at
  the solve's and the plan's real calls, 20 calls and a permutation of the
  elements give the first call's bits, and the kernel equals the numpy
  model of its arithmetic (``repro_torch.testing.segsum``) bit for bit.
  With NaN and infinities (NaN in ``add`` and ``min``, +inf with -inf in
  ``add``) it equals the plain version exactly, NaN equal to NaN.
* fused_em_tick at f32: labels, votes and the convergence flag exact;
  hood energies and M-step sums within rtol 1e-5 (atol 1e-4) of the plain
  tick on the card, which adds by atomics.  At bf16: at least 95 % label
  agreement and sums within 2 %.  K = 2, 3, 5 and the runtime-K variant at
  9, 16, 33 on synthetic operands; K = 2 and 9 at the slices' operands.
  The kernel sums each hood in element order and the M-step sums in
  vertex order at every K, so at f32 it also equals the plain tick on the
  CPU (where ``index_add_`` adds in element order) bit for bit in every
  output (``cpu_allowed`` is empty); at bf16 that equality is reported.
* The MAP step (``TickWorkspace.step``, the main path's entry of the
  tick) at the K = 2, 3 and 9 slices' real state (MAP iteration WINDOW+2,
  computed on the CPU): against the plain MAP iteration on the card in the
  tiers above, flag words equal at f32; bit for bit equal to the
  JAX-signature entry of the same kernel and, by ``cpu_allowed``'s rule,
  to the plain MAP iteration on the CPU.  Whole solves: at every launch of
  the K = 2, 3 and 9 slices' f32 solves (``TickLockstep``) the kernel's
  labels, hood sums, votes, flag word and ring equal bit for bit those of
  the plain MAP iteration run on the CPU from the kernel's state (the
  CPU step takes the card's ``log`` of each sigma, which may differ from
  the host's in the last bit; the launches where it does are counted),
  at the launches that stop a MAP loop the M-step sums too, and the solve
  gives the main path's trajectory and labels.  Repeat check: 20 steps
  from one state (labels, ring, head restored) give the same bits.
  Profiler check: 20
  steps with their flag reads issue exactly 20 kernels, all the tick, no
  memset and at most 20 device-to-host copies (the flag goes to mapped
  pinned memory, so none), once for steps that do not stop the MAP loop
  and once for launches that stop it.  Printed: ms per MAP step (step and
  flag), ms per back-to-back step, device us per step and per stopping
  launch, the bound, the device operations of one warm K = 2 solve, and
  the tick's ``ptxas`` registers and spills.
* Stacks: the tick launches of ``segment_stack`` are all the batched
  entry's and equal the stack's lockstep MAP iterations (its solve run
  again on the bucket's executable gives the count); every lane equals
  bit for bit (labels, mu, sigma, iteration counts, status) its slice's
  serial ``execute`` in the stack's joint bucket and in its own, and the
  plain batched path on the CPU; a second, warm ``segment_stack`` builds
  no workspace.  The batched entry at B = 1, 3 and 16 lanes of the K = 2
  stack, every fourth lane from lane 1 inactive, over WINDOW + 2 steps
  from the quantile init (the last with the cap bit): each step's views
  (labels, votes, hood sums, ring, M-step sums, active words) and the
  running lanes' flag words bit for bit the plain batched step on the
  CPU at f32, each running lane bit for bit the single-lane entry at f32
  and bf16, and the inactive lanes' views untouched.  Printed: mean
  ``optimize_s`` per slice batched and serial (best and median of 5
  drains), launches, the batched launch's ms and device us at B = 16
  against its bound; with ``--profile`` the stack solve's device
  operations and idle share.
* Serving: every completion of the 24-request stream (both tick
  policies) equals bit for bit (labels, mu, sigma, iteration counts,
  status) its serial ``execute``, and so do the lanes of
  ``segment_stack(batch="always")`` over the same slices; the tick's
  launches are all the pool entry's, one per micro-step; no workspace is
  built after the pool's set-up.  Mixed K: each request equals its serial
  ``execute`` in its own K's session (a K = 2 lane's real labels, and its
  padded label at the inert mu).  Chaos: the ``bad_init`` and ``nan_data``
  lanes retire ``diverged``, as their serial runs on the same corrupted
  inputs do, the ``never_converge`` lane is evicted, and the healthy lanes
  are bit for bit their serial results.  ``pool_tick_check`` (B = 1, 3, 8
  lanes of the stream, lane b starting its MAP loop at launch b mod 3 and
  stopping at its cap of 6 or by convergence, every fourth lane from lane
  1 never started): every launch bit for bit the plain pool step on the
  CPU from the kernel's state (``PoolLockstep``: labels, votes, hood sums,
  ring, M-step sums, MAP counters, active and flag words), each running
  lane bit for bit the single-lane entry, the idle lanes untouched, and a
  write to one slot leaving every other slot's buffers as they were.
  ``serve_cpu_check``: every launch of a 6-request stream through 3 slots
  (``tick_iters=3``, so lanes are admitted mid-stream) held the same way.
  Printed: ticks, micro-steps, pool launches, occupancy, steps saved by
  the early exit, requests/s, p50/p99 latency, the stack's and the serial
  solve times; the pool launch at B = 8 (ms back to back, ms per
  micro-step as the driver runs it, the plain step, the bound: the 8
  lanes' MAP-step bytes).  With ``--profile``: its device us, that a
  micro-step in which no lane stops is one kernel, no memset and no copy,
  and the idle share of a warm served stream.
* The plan: a second ``Segmenter.plan`` of the K = 2 slice's image on the
  card equals the first bit for bit (the label map and every ``Hoods``
  array); whether it equals the plan the plain path makes on the CPU is
  printed, not held.
* The sharded MAP step (``MapStepWorkspace.step``, the route's entry of
  ``fused_map_step``), step by step over whole sharded solves of the
  K = 2, 3 and 9 slices (``LockstepWorkspace``): from the kernel's state
  at every launch, the plain workspace on the CPU gives the same labels,
  flag word, ring, hood sums and votes bit for bit, and at the launch that
  stops a MAP loop the same M-step sums (the CPU step takes the card's
  ``log`` of each sigma, as above);
  the plain workspace on the card the same labels, flag words, ring and
  votes, the hood sums within rtol 1e-5 (atol 1e-4); the JAX-signature
  entry on the counts of the same labels the step's votes bit for bit and
  its hood sums within rtol 1e-5 (atol 1e-4): its elements come in any
  order, so its sums are order-free and rounded once, the step's in
  element order.  Each solve's status, iteration counts and labels equal
  the route's plain path's on the CPU and the single-device route's.
  Profiler check: 20 MAP iterations as the driver runs them (step, flag
  AND, flag read, all-reduce) issue 20 map-step kernels and no memset, no
  copy and no other kernel than NCCL's (counted apart).  Printed: ms per
  MAP iteration, ms per step back to back, device us per step, the plain
  step's ms, the bound.
* fused_map_step's JAX-signature entry (at the slices' quantile-init
  operands, and on hoods of 100 and 300 elements): min_e, arg and votes
  exact; hood energies within
  rtol 1e-5 (atol 1e-4): the kernel rounds a fixed-point sum once, the
  plain version sums in element order.  On the long hoods 20 calls give
  the first call's hood sums bit for bit, the numpy model's.  The votes
  of the four element blocks of ``partition_hoods(hoods, 4)`` add up to
  the whole problem's exactly.
* mrf_min_energy (the K = 2 slice's operands, n1 = label-1 counts; n = 1,
  3, 4,097; every input at storage offset 1; inputs at different offsets;
  and 512 copies of the slice, the hood elements of the paper's 512^3
  volume), ``beta`` a float and a CUDA tensor: min_e and arg bit for bit.
  20 calls with a float ``beta`` issue 20 kernels, no copy and no memset.
  At the volume the kernel must reach half of its bound on the device.
* flash_attention: the reference tests' shapes (B, Hq, Hkv, S, D) =
  (1,2,2,128,32), (2,4,2,256,64), (1,8,1,128,16), (1,2,1,512,64) and a
  ragged (1,4,2,200,32), causal and not, within 2e-4 (rtol and atol) at
  f32 and 2e-2 at bf16, the tiers of ``tests/test_kernels.py``; the
  model's (1,12,2,S,128) at S = 512 and 1024, bf16, causal, within 2e-2;
  and, for the tensor-core kernel off the model's shapes, (2,4,2,200,128),
  (1,2,1,33,64) and (2,4,2,200,64) in bf16, causal and not, within 2e-2;
  whisper's encoder shape (1,20,20,1500,64) non-causal and decoder shapes
  (1,20,20,S,64) causal, bf16, within 2e-2, on the tensor cores.  The
  CUDA-core kernel (float32, and bf16 at D other than 64 and 128) computes in
  float32 and differs in the order of the sums; the tensor-core kernel
  (bf16 at D = 64, 128) also rounds the probabilities to bf16 before the
  value product, as the JAX reference does.  Each case names the kernel
  the C entry point reported it ran.  Those inputs give an almost flat
  softmax, so the tensor-core kernel is also held on peaked scores
  (``repro_torch.testing.flash_cases.PEAKED_CASES``: the model's shapes
  with q scaled by 10, 30 and 1000, and (2,4,2,256,64) by 30, causal and
  not): each output row within ``ROW_TOL`` = 4 * 2^-8 of the row's
  largest |value|.  A kernel that does not rescale its accumulator when
  the running max grows, or does not subtract the max, fails it.
* The slice: kernel path against plain path at least 99.5 % pixel
  agreement, and kernel-path accuracy no more than 0.01 below; at every K
  also the status and EM and MAP iteration counts of the plain path on
  the CPU, which sums in element order as the tick does (on the card the
  plain path's ``index_add_`` adds by atomics, and its counts moved by
  one MAP iteration between runs at K = 9).  The sharded route is held to
  the same limits against the single-device route and against its own
  plain path; its ``sharded_slice`` line counts
  its collectives (all-reduces per solve: one per MAP iteration, the flag
  ANDs, the EM window's ANDs and three per solve), and its
  ``fused_map_step`` launches must be its MAP iterations plus one per EM
  iteration (the launch that stops the MAP loop, which also takes the
  M-step sums) and its
  ``segment_reduce`` launches one (the neighbourhood sizes; neither the
  label counts nor the M-step go through it).
* The modes (``modes``, ``modes_sharded``, ``ordered_add_check``,
  ``dpp_profile`` and ``fallback`` lines): per solve no ``fused_em_tick``
  or ``fused_map_step`` launch and ``segment_reduce`` launched as the
  route implies (per MAP iteration two order-free ``add``, one ordered
  ``add`` and in ``faithful`` one ``min``; per EM iteration three ordered
  ``add``); each solve's status, iteration counts, labels, mu and sigma
  bit for bit the plain path's on the CPU, the two modes equal; at K = 2
  and 3 every MAP iteration's labels, hood sums and flag and every
  M-step's sums bit for bit the CPU step's from the card's state
  (``DppLockstep``; the CPU takes the card's ``log`` of each sigma).  At
  K = 9 only the whole solve is compared: its CPU lockstep would sort
  9 x 50,485 lanes per iteration, and the script keeps within its time
  limit.  Sharded over one rank: the single-device solve bit for bit and
  the same lockstep.  The ordered ``add``: bit for bit ``ref.keyed_sum``
  on the CPU at every ordered and ``min`` call of a faithful K = 2 solve
  and at random shapes (NaN equal to NaN: the card gives its canonical
  NaN); its ms, device us and bound at the solve's hood-sum and M-step
  calls.  Printed: warm ``optimize_s`` (best and median of 10 solves),
  launches per solve, the profiled faithful solve's DPP totals, and with
  ``--profile`` each warm solve's device operations and idle share.
  Fallback: under a compile fault of the kernel route the default policy
  raises ``FallbackError`` and builds and launches nothing, and
  ``FallbackPolicy(backend="torch")`` gives the plain route's counts with
  one event and one warning and no kernel; one transient execute fault
  (``static-pallas`` and ``faithful``) and one on an engine tick give the
  clean solve bit for bit.
* The modes' stacks and served requests (``modes_stack``, ``modes_serve``
  lines; ``oracle`` line): no ``fused_em_tick`` or ``fused_map_step``
  launch; one flat step per lockstep MAP iteration (per micro-step in a
  pool) and ``segment_reduce`` launches exactly ``modes_flat_expected``'s:
  per step a serial MAP iteration's (two order-free ``add``, one ordered
  ``add``, in ``faithful`` one ``min``) whatever the lanes, B = 4 and 16
  alike, plus three ordered ``add`` per read of the M-step sums (one per
  EM iteration of a stack, one per micro-step in which a pool lane
  stopped); every lane and every completion bit for bit its serial
  ``execute`` in the same mode (mixed K: in its own K's session); no
  workspace built by a warm drain or after a pool's set-up.  At K = 2 a
  ``FLAT_LOCKSTEP_LANES`` = 3 lane stack on a ``FlatLockstep``: every
  step's labels, ring, hood sums, flag and active words and every
  M-step's sums bit for bit the CPU flat step's from the card's state
  (the CPU takes the card's ``log``).  ``segment_reduce`` at the flat
  step's B = 16 calls: each bit for bit the CPU, timed beside its plain
  version, ``index_add_`` / ``scatter_reduce_`` and its bound.  Oracle:
  each mode's K = 2 solve at least ``ORACLE_AGREEMENT`` = 99.5 % of
  ``golden_em``'s pixels and its accuracy within 0.01 (exact equality of
  labels, counts, mu and sigma reported).  Printed: lockstep iterations,
  launches per solve and per lockstep iteration, ``optimize_s`` per slice
  batched and serial (best and median of 5), requests/s, p50/p99,
  micro-steps; with ``--profile`` the idle shares.
* LM serving: every request completes with 32 tokens in the vocabulary.
  Kernel path against plain path on the same weights: (a) a 2-layer f32
  variant at full width (d_model 1536, vocab 151,936) gives identical
  greedy tokens for every request and last-position prefill logits
  within rtol 1e-4 (atol 1e-5); (b) the 28-layer bf16 model gives the
  same first token on at least 7 of 8 requests and prefill logits with
  cosine similarity at least 0.99 (bf16 rounds the attention output
  differently in the two paths, and 28 layers carry it on).  Beside (b)
  each request's top-1 minus top-2 logit on the plain path is printed, so
  that a differing first token reads as a near-tie or as an error.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate

SLICE = dict(size=512, grid=32, seed=0)
# The LM serving path: qwen2-1.5b at full width and depth, random weights.
LM = dict(arch="qwen2-1.5b", max_batch=4, max_seq=2048, lengths=(512, 1024), per_length=4,
          max_new=32, seed=0)
# The MoE families on LM's traffic: deepseek-v2-lite whole; qwen3-moe at
# full width, its 94 layers (470 GB of bf16) cut to 4 to fit one card.
LM_MOE = (("deepseek-v2-lite-16b", None), ("qwen3-moe-235b-a22b", 4))
MOE_CHECK_TOKENS = 1024  # tokens of the card-against-CPU dispatch check
MOE_TIE = 1e-5  # router logits closer than this may order differently on the card and the CPU
# The ssm, hybrid and vlm families on LM's traffic: mamba2-130m and
# zamba2-2.7b whole; llava-next-34b at full width, its 60 layers (about 67
# GB of bf16 with caches) cut to 8.
# whisper-large-v3 (encdec) whole: 32 encoder and 32 decoder layers.
LM_FAMILIES = (("mamba2-130m", None), ("zamba2-2.7b", None), ("llava-next-34b", 8), ("whisper-large-v3", None))
# check (a): 2 shared applications; 2 layers; 4 encoder and 4 decoder layers
FAMILY_F32_LAYERS = {"zamba2-2.7b": 12, "llava-next-34b": 2, "whisper-large-v3": 4}
VLM_MAX_SEQ = 4096  # llava: 2880 patches, 512 or 1024 prompt tokens, 32 new
SSD_CHECK_TOKENS = 1024  # the card-against-CPU SSD check: 8 chunks of 128
SSD_DECODE_STEPS = 8
# flash_attention checks: (B, Hq, Hkv, S, D).  The reference tests' shapes
# and a ragged S, f32 and bf16, causal and not; the model's shape, bf16 causal.
FLASH_REF_SHAPES = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 16),
                    (1, 2, 1, 512, 64), (1, 4, 2, 200, 32)]
FLASH_MODEL_SHAPES = [(1, 12, 2, 512, 128), (1, 12, 2, 1024, 128)]
# qwen3-moe's prefill calls: 64 q heads on 4 kv heads (group 16).
FLASH_MOE_SHAPES = [(1, 64, 4, 512, 128), (1, 64, 4, 1024, 128)]
# Shapes that reach the bf16 tensor-core kernel off the model's path: a
# ragged S with B = 2 at D = 128 and at D = 64 (4 tiles, the last of 8
# rows), and S shorter than one 64-row tile at D = 64.
FLASH_TC_SHAPES = [(2, 4, 2, 200, 128), (1, 2, 1, 33, 64), (2, 4, 2, 200, 64)]
# whisper-large-v3's prefill calls: the encoder's (bidirectional, S = 1500
# = 23 * 64 + 28) and the decoder's (causal) at 20 heads of 64.
FLASH_WHISPER_ENCODER = (1, 20, 20, 1500, 64)
FLASH_WHISPER_DECODER = [(1, 20, 20, 512, 64), (1, 20, 20, 1024, 64)]
# The ragged tensor-core cases held on peaked scores with poisoned tails:
# (shape, causal).  q is scaled by FLASH_RAGGED_Q_SCALE (scores spread by
# several units), and GUARD_ROWS rows of NaN follow q, k and v.
FLASH_RAGGED_CASES = [(FLASH_WHISPER_ENCODER, False), ((2, 4, 2, 200, 64), False), ((2, 4, 2, 200, 64), True)]
FLASH_RAGGED_Q_SCALE = 10.0
GUARD_ROWS = 64
# zamba2's shared-block prefill (32 heads of 80: the CUDA-core kernel) and
# llava's (56 q heads on 8 kv heads, group 7; S = 3900 ends in a ragged tile).
FLASH_ZAMBA_SHAPES = [(1, 32, 32, 512, 80), (1, 32, 32, 1024, 80)]
FLASH_LLAVA_SHAPES = [(1, 56, 8, 3392, 128), (1, 56, 8, 3900, 128)]
FLASH_LLAVA_TIMED = (1, 56, 8, 3904, 128)
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DEVICE = "cuda"
REPEATS = 20  # calls of an order-free kernel that must agree bit for bit
SOLVES = 10   # warm solves timed under --profile (min, median, max)
TICK_LABELS = (2, 3, 5, 9, 16, 33)  # synthetic tick checks; K >= 9 is the runtime-K variant
MAP_STEPS = 20  # MAP steps of the repeat and profiler checks
MRF_VOLUME_SLICES = 512  # mrf_min_energy at the paper's 512^3 volume: 512 slices of hood elements
PROFILE_ATTEMPTS = 3  # profiles of MAP_STEPS steps, for the records the profiler drops
PROFILER_SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's clock, before each traced window
PROFILER_LEAD_RECORDS = 32  # short spins after it: the profiler may lose a trace's first records
PROFILER_LEAD_CYCLES = 10_000  # about 5 us each
PROFILE_LEAD_LOST: dict = {}  # traces by the number of their spin records the profiler lost
STACK = ((2, 16), (3, 4))  # (K, slices) of the stack phase: 512x512 slices, batch="always"
BATCHED_CHECK_SIZES = (1, 3, 16)  # lanes at which the batched entry is held to its plain version
STACK_REPEATS = 5  # timed drains of the K = 2 stack, batched and serial
SERVE_REQUESTS, SERVE_SLOTS, SERVE_TICK = 24, 8, 4  # the serve phase's K = 2 stream and engine
SERVE_MIXED = 4  # K = 2 and as many K = 3 requests in the mixed-K pool
SERVE_CPU_REQUESTS, SERVE_CPU_SLOTS, SERVE_CPU_TICK = 6, 3, 3  # serve_cpu_check's stream
POOL_CHECK_SIZES = (1, 3, 8)  # slots at which the pool entry is held to its plain version
POOL_CHECK_MAP_ITERS = 6  # the pool check's MAP cap: every lane reaches it inside the check
NEVER_STOP = 1 << 30  # MAP cap of the timing pool (with tolerance 0 its lanes never stop)
MODES = ("static", "faithful")  # the modes phase: the paper's primitive sequence
MODES_LOCKSTEP_K = (2, 3)  # slices whose modes solves are held to the CPU at every MAP iteration
FLAT_LOCKSTEP_LANES = 3  # lanes of the modes' stack held to the CPU at every flat step
ORACLE_AGREEMENT = 0.995  # pixel agreement of each mode's K = 2 solve with golden_em
FALLBACK_STACK_LANES = 4  # lanes of the K = 2 stack in the fallback phase's mode stacks
PLAN_REPEATS = 5  # warm solves (or stack solves) per mode or route in the planning phase
PLAN_ROUTE_TOLERANCE = 0.10  # the autotuned stack route may be at most this much slower
# The training path: qwen2-1.5b whole through launch.train.build and
# run_training (bf16 parameters, float32 master and moments, the config's
# remat "dots"), 8 sequences of 512 tokens a step from training.data.
TRAIN = dict(arch="qwen2-1.5b", batch=8, seq=512, steps=8, seed=0, lr=3e-4)
TRAIN_TIMED_STEPS = slice(2, None)  # steps 3-8: the median step time
TRAIN_CHECK_LAYERS = 4  # (c) kernel against plain and (e) resume: full width, depth cut to 4
TRAIN_CHECK_STEPS = 2  # steps of (c) and (d)
TRAIN_RESUME = dict(steps=4, ckpt_every=2, crash_at_step=3)  # (e)
TRAIN_FAMILY_ARCHS = ("qwen2-1.5b", "llava-next-34b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
                      "mamba2-130m", "zamba2-2.7b", "whisper-large-v3")  # (d): one per family, reduced
TRAIN_FAMILY_SHAPE = dict(batch=2, seq=32)
TRAIN_FLASH_SHAPE = (8, 12, 2, 512, 128)  # qwen2-1.5b's training call (causal)
TRAIN_TOL = 1e-4  # (c) and (d): relative
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"
# The parallel path (parallel/, the sharded train step, EP, SP decode) on a
# one-rank NCCL DeviceMesh: (a) qwen2-1.5b whole through the mesh branch,
# held to the single-device step from the same seed bit for bit; (b) the
# codecs at (pod=1, data=1, model=1) within the reference's bounds
# (tests/_distributed_runner.py: loss 1e-3, grad norm 2 % bf16, 5 % int8);
# (c) qwen3-moe at full width, 2 layers, through the EP branch bit for bit;
# (d) SP decode within the reference's 2e-4 at qwen2's attention width and
# deepseek-v2-lite's latent width (float32); (e) (a)'s state saved with
# its specs and restored under the mesh bit for bit.
PARALLEL = dict(arch="qwen2-1.5b", batch=8, seq=512, steps=3, seed=0,
                optimizer=dict(lr=3e-4, warmup_steps=1, total_steps=3))
PARALLEL_CODEC_BOUNDS = {"bf16": 0.02, "int8": 0.05}  # grad norm, relative; the loss within 1e-3
PARALLEL_EP = dict(arch="qwen3-moe-235b-a22b", n_layers=2, batch=4, seq=256)
PARALLEL_SP = dict(batch=4, max_seq=1024, t=1023, tol=2e-4)
PARALLEL_MULTI = dict(n_layers=2, steps=2, tol=1e-3)  # (f) on 2 NCCL ranks: (a) at 2 layers, (c), (d)
PARALLEL_CKPT_DIR = ROOT / "build" / "parallel_ckpt"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spread(values: list) -> dict:
    """Min, median and max of repeated measurements."""
    v = sorted(values)
    return {"n": len(v), "min": v[0], "median": v[len(v) // 2], "max": v[-1]}


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    """Least time (ms) for the work: bytes over HBM rate vs ops over the
    card's peak for their type (default float32 outside the tensor cores);
    returns (ms, "bytes" | "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_profile(torch, fn, match: tuple = ()) -> dict:
    """Run ``fn`` under ``torch.profiler`` and sum the device time of every
    kernel, memset and copy it launched: total busy microseconds and the
    largest contributors by name, and every kernel of the order-free keyed
    reductions (``segsum::``: ``segment_reduce``'s passes and
    ``fused_map_step``'s hood sums).  Only device-side events count (a host
    op's own entry repeats the time of the kernels it launched).
    ``host_top`` lists the host ops with the most self time on the CPU,
    where a host-bound solve spends its time (the profiler's own cost
    included).  ``device_ops`` counts the device operations, split into
    ``kernels``, ``memsets`` and ``memcpys``.

    On the H100 the tracing may lose the first device records of a trace,
    and it is their number, not their length, that counts: behind one
    long spin it can lose the spin and ``fn``'s first kernel, behind
    several short spins only spins.  So each trace first spins the card
    for about 10 ms and then ``PROFILER_LEAD_RECORDS`` times for about 5 us
    (``torch.cuda._sleep``, kernel ``spin_kernel``), all left out; it spins
    10 ms after ``fn`` too.  ``spins_seen`` counts the spin records the
    trace kept, of ``PROFILER_LEAD_RECORDS + 2``; ``PROFILE_LEAD_LOST``
    tallies the traces by how many they lost (the ``profiler_lead``
    line).  ``matched`` sums, for each substring in ``match``, the device
    time and count of the kernels whose names hold it."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc.collect()  # no pinned host memory freed by the collector inside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILER_SPIN_CYCLES)
        for _ in range(PROFILER_LEAD_RECORDS):
            torch.cuda._sleep(PROFILER_LEAD_CYCLES)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(PROFILER_SPIN_CYCLES)
        torch.cuda.synchronize()
    by_name, host, spins = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            host.append((float(e.self_cpu_time_total), e.key, e.count))
            continue
        if "spin_kernel" in e.key:
            spins += e.count
            continue
        us = float(e.self_device_time_total)
        if us > 0.0:
            by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + us, e.count)
    lost = PROFILER_LEAD_RECORDS + 2 - spins
    PROFILE_LEAD_LOST[lost] = PROFILE_LEAD_LOST.get(lost, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    kinds = {"kernels": 0, "memsets": 0, "memcpys": 0}
    for k, (_, n) in by_name.items():
        kinds["memsets" if k.startswith("Memset") else "memcpys" if k.startswith("Memcpy") else "kernels"] += n
    return {
        "device_busy_us": sum(us for us, _ in by_name.values()),
        "device_ops": sum(kinds.values()), **kinds,
        "top": [{"name": k[:80], "us": us, "count": n} for k, (us, n) in top],
        "segsum": [{"name": k[:80], "us": us, "count": n} for k, (us, n) in by_name.items()
                   if k.startswith(("segsum::", "void segsum::"))],
        "host_top": [{"name": k[:60], "self_us": us, "count": n}
                     for us, k, n in sorted(host, reverse=True)[:10]],
        "allreduces": sum(n for _, k, n in host if k == "c10d::allreduce_"),
        "spins_seen": spins,
        "matched": {m: {"us": sum(us for k, (us, _) in by_name.items() if m in k),
                        "count": sum(n for k, (_, n) in by_name.items() if m in k)} for m in match},
    }


def profile_solve(torch, what: str, solve) -> dict:
    """``optimize_s`` of ``SOLVES`` warm calls of ``solve`` (min, median,
    max), then one more under ``device_profile``: its device operations,
    all-reduces and the device's idle share against the best unprofiled
    solve."""
    walls = spread([solve().optimize_seconds for _ in range(SOLVES)])
    prof = device_profile(torch, solve)
    out = {"phase": "profile", "what": what, "optimize_s_unprofiled": walls["min"],
           "optimize_s_spread": walls,
           "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / walls["min"], **prof}
    emit(out)
    return out


def check_segment_reduce(torch, ops, dev) -> float:
    """Kernel against plain version: 7, 24,784 (about a 512x512 slice's hood elements)
    and 10**6 elements into 1, 1555 and 10**5 segments, with padding ids."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for n in (7, 24_784, 1_000_000):
        for segs in (1, 1555, 100_000):
            ids = rng.integers(-2, segs + segs // 10 + 2, n).astype(np.int32)
            ids[::13] = 2**30  # padding ids
            ids_t = torch.from_numpy(ids).to(dev)
            for kind, vals in (
                ("int", rng.integers(0, 3, n).astype(np.float32)),
                ("float", rng.normal(0.0, 1.0, n).astype(np.float32)),
            ):
                v = torch.from_numpy(vals).to(dev)
                for op in ("add", "min"):
                    k = ops.segment_reduce(v, ids_t, segs, op)
                    p = ops.segment_reduce(v, ids_t, segs, op, backend="torch")
                    torch.cuda.synchronize()
                    err = (k - p).abs().nan_to_num(0.0).max().item()
                    exact = kind == "int" or op == "min"
                    if exact:
                        if not torch.equal(k, p):
                            fail(f"segment_reduce {op} {kind} n={n} segs={segs}: not exact (err {err})")
                    else:
                        mag = ops.segment_reduce(v.abs(), ids_t, segs, "add", backend="torch")
                        if not bool(((k - p).abs() <= 1e-5 * mag + 1e-6).all()):
                            fail(f"segment_reduce add float n={n} segs={segs}: err {err}")
                    worst = max(worst, err)
    emit({"phase": "segment_reduce_check", "ok": True, "max_abs_err": worst})
    return worst


def random_add_cases() -> list:
    """Float ``add`` cases for the order-free checks: 24,784 and 10**6
    normal values into 1555 and 10**5 segments, ids shuffled, with the
    padding ids of ``check_segment_reduce``."""
    rng = np.random.default_rng(1)
    cases = []
    for n in (24_784, 1_000_000):
        for segs in (1555, 100_000):
            ids = rng.integers(-2, segs + segs // 10 + 2, n).astype(np.int32)
            ids[::13] = 2**30
            cases.append((f"random n={n} segs={segs}", rng.normal(0.0, 1.0, n).astype(np.float32),
                          ids, segs))
    return cases


def bits(t) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def check_segment_reduce_order_free(torch, ops, dev, cases) -> list:
    """Float ``add`` on each ``(what, values, ids, segments)`` case: 20
    calls bitwise equal to the first, a permutation of the elements too;
    equal bit for bit to the numpy model of the kernel's arithmetic
    (``repro_torch.testing.segsum``); within 1e-5 of each segment's sum of
    magnitudes (+ 1e-6) of the plain version.  Returns one row per case."""
    from repro_torch.testing import segsum

    rows = []
    for what, vals, ids, segs in cases:
        v, i = torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev)
        first = bits(ops.segment_reduce(v, i, segs, "add"))
        repeats_equal = all(np.array_equal(bits(ops.segment_reduce(v, i, segs, "add")), first)
                            for _ in range(REPEATS - 1))
        perm = torch.randperm(len(vals), generator=torch.Generator().manual_seed(0)).to(dev)
        permuted_equal = np.array_equal(bits(ops.segment_reduce(v[perm], i[perm], segs, "add")), first)
        model_equal = np.array_equal(segsum.segment_sum(vals, ids, segs).view(np.uint32), first)
        p = ops.segment_reduce(v, i, segs, "add", backend="torch")
        mag = ops.segment_reduce(v.abs(), i, segs, "add", backend="torch")
        k = torch.from_numpy(first.view(np.float32)).to(dev)
        err = (k - p).abs().max().item() if segs else 0.0
        row = {"case": what, "n": len(vals), "segments": segs, "repeats": REPEATS,
               "repeats_bitwise_equal": repeats_equal, "permuted_bitwise_equal": permuted_equal,
               "model_bitwise_equal": model_equal, "max_abs_err_vs_plain": err}
        rows.append(row)
        if not (repeats_equal and permuted_equal and model_equal):
            fail(f"segment_reduce add {what}: not order-free or not the model's result: {row}")
        if not bool(((k - p).abs() <= 1e-5 * mag + 1e-6).all()):
            fail(f"segment_reduce add {what}: err {err} against the plain version")
    emit({"phase": "segment_reduce_order_free_check", "ok": True, "cases": rows})
    return rows


def check_segment_reduce_nonfinite(torch, ops, dev) -> None:
    """NaN in ``add`` and ``min``, +inf with -inf in ``add``: the kernel
    equals the plain version exactly on every non-finite result and every
    minimum (NaN equal to NaN; finite sums within the float tier) and the
    numpy model bit for bit.  A small hand-made case and 24,784 values with
    NaN and infinities scattered over 1555 segments."""
    from repro_torch.testing import segsum

    rng = np.random.default_rng(2)
    big = rng.normal(0.0, 1.0, 24_784).astype(np.float32)
    big[rng.integers(0, big.size, 40)] = np.nan
    big[rng.integers(0, big.size, 60)] = np.inf
    big[rng.integers(0, big.size, 60)] = -np.inf
    cases = [
        ("hand-made", np.array([1, np.nan, 3, -np.inf, np.inf, 2, np.inf, 5, -np.inf, np.nan, -7,
                                -np.inf], np.float32),
         np.array([0, 0, 1, 2, 2, 3, 5, 5, 6, 6, 2**30, 7], np.int32), 9),
        ("scattered", big, rng.integers(0, 1555, big.size).astype(np.int32), 1555),
    ]
    rows = []
    for what, vals, ids, segs in cases:
        v, i = torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev)
        for op, model in (("add", segsum.segment_sum), ("min", segsum.segment_min)):
            k = ops.segment_reduce(v, i, segs, op)
            p = ops.segment_reduce(v, i, segs, op, backend="torch")
            same = (k == p) | (k.isnan() & p.isnan())
            finite = k.isfinite() & p.isfinite()
            if op == "add":  # finite sums: the float tier of check_segment_reduce
                mag = ops.segment_reduce(v.abs().nan_to_num(0.0, 0.0, 0.0), i, segs, "add", backend="torch")
                same |= finite & ((k - p).abs() <= 1e-5 * mag + 1e-6)
            equal = bool(same.all())
            model_equal = np.array_equal(bits(k), model(vals, ids, segs).view(np.uint32))
            row = {"case": what, "op": op, "nan_segments": int(k.isnan().sum()),
                   "inf_segments": int(k.isinf().sum()), "equal_plain": equal,
                   "model_bitwise_equal": model_equal}
            rows.append(row)
            if not (equal and model_equal):
                fail(f"segment_reduce {op} non-finite {what}: {row}")
    emit({"phase": "segment_reduce_nonfinite_check", "ok": True, "cases": rows})


def compare_tick(torch, k, p, precision: str, what: str) -> float:
    """Hold a kernel tick ``k`` against the plain tick ``p``; returns the
    largest absolute error over the float outputs."""
    labels_k, hood_k, votes_k, conv_k = k[:4]
    labels_p, hood_p, votes_p, conv_p = p[:4]
    floats = [(hood_k, hood_p)] + list(zip(k[4:], p[4:]))
    err = max((a - b).abs().max().item() if a.numel() else 0.0 for a, b in floats)
    if precision == "f32":
        if not torch.equal(labels_k, labels_p):
            fail(f"{what}: labels differ")
        if not torch.equal(votes_k, votes_p):
            fail(f"{what}: votes differ")
        if bool(conv_k) != bool(conv_p):
            fail(f"{what}: conv differs")
        for a, b in floats:
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
                fail(f"{what}: sums differ beyond rtol 1e-5 (err {err})")
    else:
        agree = (labels_k == labels_p).float().mean().item()
        if agree < 0.95:
            fail(f"{what}: label agreement {agree}")
        for a, b in floats:
            if not torch.allclose(a, b, rtol=0.02, atol=1e-3):
                fail(f"{what}: bf16 sums drift beyond 2% (err {err})")
    return err


def same_bits(torch, a, b) -> bool:
    """Two tensors equal bit for bit (floats by their bits)."""
    as_bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return torch.equal(as_bits(a), as_bits(b))


def same_bits_or_nan(torch, a, b) -> bool:
    """Two float tensors equal bit for bit where neither is NaN, and NaN at
    the same places: the card's arithmetic gives its canonical NaN, the
    CPU's keeps an operand's payload or its sign."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and same_bits(torch, a[~nan], b[~nan])


def check_tick_synthetic(torch, ops, dev) -> None:
    from repro_torch.testing.tick_problems import sorted_tick_problem

    for n_labels in TICK_LABELS:
        arrays, offsets = sorted_tick_problem(n_labels, n_labels, 1554, 1025, 24_784)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        off = torch.from_numpy(offsets).to(dev)
        for precision in ("f32", "bf16"):
            kw = dict(n_hoods=1554, n_vertices=1025, precision=precision)
            k = ops.fused_em_tick(*args, 0.75, offsets=off, **kw)
            p = ops.fused_em_tick(*args, 0.75, backend="torch", **kw)
            torch.cuda.synchronize()
            err = compare_tick(torch, k, p, precision, f"fused_em_tick K={n_labels} {precision}")
            row = {"phase": "fused_em_tick_check", "operands": "synthetic", "K": n_labels,
                   "precision": precision, "ok": True, "max_abs_err": err}
            row.update(check_tick_against_cpu(
                torch, ops, k, [*args, 0.75], dict(n_hoods=1554, n_vertices=1025), precision,
                f"synthetic K={n_labels}"))
            emit(row)


TICK_OUTPUTS = ("labels", "hood_e", "votes", "conv", "sum_w", "sum_wy", "sum_wyy")


def cpu_allowed(n_labels: int) -> set:
    """Tick outputs that may differ from the plain tick on the CPU at f32:
    none, at every K (hood sums in element order, M-step sums in vertex
    order)."""
    return set()


def check_tick_against_cpu(torch, ops, k, args, kw, precision: str, what: str) -> dict:
    """The tick sums each hood in the plain version's element order (and
    from K = 9 the M-step sums too), so at f32 it equals bit for bit the
    plain tick on the CPU, where ``index_add_`` adds in element order (on
    the card it adds by atomics), in every output but ``cpu_allowed``'s.
    At f32 the plain tick takes the card's ``log`` of sigma (the host's
    may differ in the last bit; ``log_sigma_equal_cpu`` says whether it
    does).  At bf16 the equality is reported.  Returns the flags."""
    from repro_torch.testing.tick_problems import FIELDS

    host = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    sigma = args[FIELDS.index("sigma")]
    log_sigma = torch.log(sigma).cpu()
    p = ops.ref.fused_em_tick(*host, precision=precision, **kw,
                              log_sigma=log_sigma if precision == "f32" else None)
    same_log = torch.equal(log_sigma, torch.log(sigma.cpu()))
    unequal = [n for n, a, b in zip(TICK_OUTPUTS, k, p) if not same_bits(torch, a.cpu(), b)]
    out = {"bitwise_equal_plain_cpu": not unequal, "log_sigma_equal_cpu": same_log}
    if unequal:
        out["unequal"] = unequal
    if precision == "f32" and not set(unequal) <= cpu_allowed(int(sigma.shape[0])):
        fail(f"fused_em_tick {what} f32: {unequal} not bitwise equal to the plain tick on the CPU")
    return out


def real_map_state(torch, plan, E, em_mod):
    """The single-device MAP loop's state at iteration WINDOW+2 of the
    plan's solve (quantile init), so that the history ring holds real
    energies: computed on the plain path with the problem copied to the
    CPU (element-order sums, the same bits in every run), then moved to
    the card.  ``cpu`` holds the CPU copies (problem, state)."""
    from repro_torch.core.pmrf import convert, pipeline
    from repro_torch.kernels import ref

    prob = plan.problem
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    d = {f: getattr(prob.hoods, f) for f in convert.HOODS_ARRAYS + convert.HOODS_SIZES}
    d.update({f: getattr(prob.model, f) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu0, sigma0=sigma0)
    hoods, model, labels, mu, sigma = convert.problem_from_numpy(d, device="cpu")
    sctx = E.make_static_context(hoods, model, backend="torch")
    sig = torch.maximum(sigma, model.sigma_min)
    ws = ref.PlainTickWorkspace(ref.TickShape.of(hoods, model), device="cpu",
                                conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW)
    ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels)
    ws.begin_em(mu, sig)
    for _ in range(em_mod.WINDOW + 1):
        ws.step(False)
    cpu = dict(hoods=hoods, model=model, elements=(sctx.y, sctx.w, sctx.nall_e, sctx.validf),
               labels=ws.labels, ring=ws.ring.clone(), head=ws.head, mu=mu, sig=sig)
    dev = prob.hoods.vertex.device
    on = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in cpu.items()
          if k not in ("hoods", "model")}
    on["elements"] = tuple(t.to(dev) for t in cpu["elements"])
    return {**on, "cpu": cpu}


def newest_first(ring, head: int):
    """The ring's rows newest first, as the JAX kernel's ``hist``."""
    rows = int(ring.shape[0])
    return ring[[(head + r) % rows for r in range(rows)]].contiguous()


def real_tick_operands(torch, plan, E, em_mod):
    """The fused tick's operands (the JAX kernel's signature) at the state
    of ``real_map_state``."""
    st = real_map_state(torch, plan, E, em_mod)
    hoods, model = plan.problem.hoods, plan.problem.model
    y, w, nall_e, validf = st["elements"]
    xf = st["labels"][hoods.vertex.long()].float() * validf
    args = (y, w, nall_e, xf, validf, hoods.hood_id, hoods.vertex, model.region_mean,
            model.region_weight, newest_first(st["ring"], st["head"]), st["mu"], st["sig"],
            model.beta)
    kw = dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1)
    return args, kw


def check_time_tick(torch, ops, E, em_mod, plan, profile: bool) -> dict:
    """The tick at a slice plan's real operands (``real_tick_operands``):
    held against its plain version at f32 and bf16, then timed (CUDA
    events; device time under ``--profile``) beside its plain version and
    its bound.  Returns the figures for the ``kernels`` line."""
    args, kw = real_tick_operands(torch, plan, E, em_mod)
    hoods = plan.problem.hoods
    n_labels = plan.problem.model.n_labels
    out = {"K": n_labels}
    for precision in ("f32", "bf16"):
        k = ops.fused_em_tick(*args, offsets=hoods.offsets, precision=precision, **kw)
        p = ops.fused_em_tick(*args, precision=precision, backend="torch", **kw)
        torch.cuda.synchronize()
        err = compare_tick(torch, k, p, precision, f"fused_em_tick slice K={n_labels} {precision}")
        if precision == "f32":
            out["max_abs_err"] = err
        row = {"phase": "fused_em_tick_check", "operands": "512x512 slice", "K": n_labels,
               "precision": precision, "ok": True, "max_abs_err": err, "conv": bool(p[3])}
        row.update(check_tick_against_cpu(torch, ops, k, args, kw, precision, f"slice K={n_labels}"))
        emit(row)
    kern = lambda: ops.fused_em_tick(*args, offsets=hoods.offsets, **kw)
    out["ms"] = time_ms(kern)
    out["plain_ms"] = time_ms(lambda: ops.fused_em_tick(*args, backend="torch", **kw))
    n_run = int(hoods.offsets[-1] - hoods.offsets[0])
    nh, nv = hoods.n_hoods, hoods.n_regions + 1
    n_bytes = (n_run * 6 * 4 + (nh + 1) * 4 + 2 * nv * 4 + (em_mod.WINDOW + 1) * nh * 4
               + 2 * n_labels * 4 + 4                       # inputs
               + nv * 4 + nh * 4 + n_labels * nv * 4 + 3 * n_labels * 4 + 4)  # outputs
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_run * n_labels * 16 + nv * 6)
    out["bytes"] = n_bytes
    if profile:
        prof = device_profile(torch, lambda: [kern() for _ in range(20)])
        emit({"phase": "profile", "what": f"20 fused_em_tick calls (K={n_labels})", **prof})
        out["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
    emit({"phase": "timing", "what": f"fused_em_tick K={n_labels}", **out})
    return out


def map_step_workspace(ops, em_mod, hoods, model, st, precision="f32", backend=None):
    """A MAP-iteration workspace (the kernel's on the card, the plain one
    with ``backend="torch"`` or on the CPU) holding the state ``st`` of
    ``real_map_state`` (or its ``cpu`` part)."""
    ws = ops.tick_workspace(ops.TickShape.of(hoods, model), device=hoods.vertex.device,
                            precision=precision, conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW,
                            backend=backend)
    ws.start(hoods, model, *st["elements"], st["labels"])
    ws.begin_em(st["mu"], st["sig"])
    load_state(ws, st)
    return ws


def load_state(ws, st) -> None:
    """Put the labels, the ring and its head of ``st`` back into ``ws``."""
    ws.labels.copy_(st["labels"])
    ws.ring.copy_(st["ring"])
    ws.head = st["head"]


def map_step(ws) -> tuple:
    """One gated MAP step that stops the loop (the cap bit: it takes the
    M-step sums) and its flag: ``(labels, hood_e, votes, flag, sum_w,
    sum_wy, sum_wyy)``, copied out of the workspace."""
    ws.step(True, True)
    flag = ws.flag()
    return (ws.labels.clone(), ws.hood_e.clone(), ws.votes.clone(), flag, *ws.stats.clone())


def check_map_iteration(torch, ops, E, em_mod, plan) -> dict:
    """The main path's entry (``TickWorkspace.step``) at a slice plan's real
    state, f32 and bf16: held to the plain MAP iteration on the card in
    ``compare_tick``'s tiers (flag words equal at f32), to the JAX-signature
    entry of the same kernel bit for bit, and to the plain MAP iteration on
    the CPU bit for bit at f32 (``cpu_allowed``'s rule; reported at bf16)."""
    st = real_map_state(torch, plan, E, em_mod)
    hoods, model = plan.problem.hoods, plan.problem.model
    n_labels = model.n_labels
    y, w, nall_e, validf = st["elements"]
    xf = st["labels"][hoods.vertex.long()].float() * validf
    entry_args = (y, w, nall_e, xf, validf, hoods.hood_id, hoods.vertex, model.region_mean,
                  model.region_weight, newest_first(st["ring"], st["head"]), st["mu"], st["sig"],
                  model.beta)
    kw = dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1, offsets=hoods.offsets)
    out = {"K": n_labels}
    for precision in ("f32", "bf16"):
        what = f"MAP iteration slice K={n_labels} {precision}"
        k = map_step(map_step_workspace(ops, em_mod, hoods, model, st, precision))
        p = map_step(map_step_workspace(ops, em_mod, hoods, model, st, precision, backend="torch"))
        err = compare_tick(torch, k, p, precision, what)
        if precision == "f32" and k[3] != p[3]:
            fail(f"{what}: flag word {k[3]}, plain {p[3]}")
        e = ops.fused_em_tick(*entry_args, precision=precision, **kw)
        same_entry = (bool(e[3]) == bool(k[3] & ops.FLAG_CONVERGED) and
                      all(same_bits(torch, a, b) for a, b in zip(k[:3] + k[4:], e[:3] + e[4:])))
        if not same_entry:
            fail(f"{what}: the workspace step and the JAX-signature entry of the same kernel differ")
        row = {"phase": "map_iteration_check", "operands": "512x512 slice", "K": n_labels,
               "precision": precision, "ok": True, "max_abs_err": err, "flag": k[3],
               "plain_flag": p[3], "equal_jax_signature_entry": same_entry}
        cpu = st["cpu"]
        cws = map_step_workspace(ops, em_mod, cpu["hoods"], cpu["model"], cpu, precision)
        log_sigma = torch.log(st["sig"]).cpu()
        if precision == "f32":  # the card's log of sigma
            cws.begin_em(cpu["mu"], cpu["sig"], log_sigma=log_sigma)
            load_state(cws, cpu)
        c = map_step(cws)
        same_log = torch.equal(log_sigma, torch.log(cpu["sig"]))
        unequal = [n for n, a, b in zip(TICK_OUTPUTS, k, c)
                   if (a != b if n == "conv" else not same_bits(torch, a.cpu(), b))]
        row.update(bitwise_equal_plain_cpu=not unequal, log_sigma_equal_cpu=same_log)
        if unequal:
            row["unequal"] = unequal
        if precision == "f32" and not set(unequal) <= cpu_allowed(n_labels):
            fail(f"{what}: {unequal} not bitwise equal to the plain MAP iteration on the CPU")
        if precision == "f32":
            out["max_abs_err"] = err
        emit(row)
    return out


def tick_step_bytes(hoods, n_labels: int, n_run: int = None) -> int:
    """Bytes a MAP step must move (each input read once, each output written
    once): the hood runs' elements, the labels gathered once, the offsets,
    the region arrays, the ring's rows, the parameters; the ring row,
    hood_e, labels, votes and the cleared votes, the sums and flag words."""
    if n_run is None:
        n_run = int(hoods.offsets[-1] - hoods.offsets[0])
    nh, nv, rows = hoods.n_hoods, hoods.n_regions + 1, 4
    return (n_run * 5 * 4 + nv * 4 + (nh + 1) * 4 + 2 * nv * 4 + (rows - 1) * nh * 4
            + 2 * n_labels * 4 + 4
            + nh * 4 + nh * 4 + nv * 4 + 2 * n_labels * nv * 4
            + 3 * n_labels * 4 + 2 * 4)


def tick_step_ops(hoods, n_labels: int, n_run: int = None) -> int:
    """Float operations of a MAP step: 16 per element and label, 6 per vertex."""
    if n_run is None:
        n_run = int(hoods.offsets[-1] - hoods.offsets[0])
    return n_run * n_labels * 16 + (hoods.n_regions + 1) * 6


def profile_tick_steps(torch, ops, step, reset, what: str, kernel: str = "tick_kernel") -> dict:
    """``MAP_STEPS`` calls of ``step`` (each one tick launch and its flag
    read) under the profiler, after ``reset``: exactly one
    ``kernel`` each, no memset, at most one copy each.  The profiler has
    dropped a kernel's record (19 of 20 in one run): an attempt that shows
    fewer tick kernels than steps and nothing else is made again, up to
    PROFILE_ATTEMPTS times; any attempt that shows another kernel, a
    memset or more copies than steps fails at once."""
    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        reset()
        before = ops.launch_counts()["fused_em_tick"]
        prof = device_profile(torch, lambda: [step() for _ in range(MAP_STEPS)])
        ticks = sum(t["count"] for t in prof["top"] if kernel in t["name"])
        a = {"launches": ops.launch_counts()["fused_em_tick"] - before, "kernels": prof["kernels"],
             "tick_kernels": ticks, "memsets": prof["memsets"], "memcpys": prof["memcpys"],
             "device_us_per_step": prof["device_busy_us"] / max(ticks, 1)}
        attempts.append(a)
        if (a["launches"] != MAP_STEPS or a["kernels"] != ticks or ticks > MAP_STEPS
                or a["memsets"] or a["memcpys"] > MAP_STEPS):
            fail(f"{what}: {MAP_STEPS} steps issued {a}")
        if ticks == MAP_STEPS:
            return {**a, "attempts": len(attempts)}
    fail(f"{what}: no profile of {MAP_STEPS} steps saw all of them: {attempts}")


def check_tick_step(torch, ops, E, em_mod, plan) -> dict:
    """The main path's MAP step at a slice plan's real state (f32):

    * repeat: ``MAP_STEPS`` steps, each from the same labels, ring and
      head, give the same bits (labels, hood_e, votes, sums, ring, flag),
      so the kernel resets its ticket, its vote buffer and its flag
      accumulator itself;
    * profiler: ``MAP_STEPS`` steps (gate closed: none stops the loop) and
      ``MAP_STEPS`` launches that stop it (the cap bit: each takes the
      M-step sums) issue exactly one kernel each (the tick), no memset and
      at most one device-to-host copy each;
    * times: ms per MAP step (step and flag, host clock, what the driver
      pays), ms per step back to back (CUDA events), device us per step
      and per stopping launch (profiler), the plain MAP iteration's ms,
      and the bound.
    """
    st = real_map_state(torch, plan, E, em_mod)
    hoods, model = plan.problem.hoods, plan.problem.model
    n_labels = model.n_labels
    ws = map_step_workspace(ops, em_mod, hoods, model, st)
    first = None
    for _ in range(MAP_STEPS):
        load_state(ws, st)
        got = map_step(ws) + (ws.ring.clone(),)
        first = first or got
        if not all(a == b if isinstance(a, int) else same_bits(torch, a, b) for a, b in zip(got, first)):
            fail(f"MAP step K={n_labels}: {MAP_STEPS} steps from one state differ")
    emit({"phase": "map_step_repeat_check", "K": n_labels, "steps": MAP_STEPS, "ok": True,
          "flag": first[3]})

    # A step with the gate closed never stops the MAP loop (no M-step); with
    # the cap bit every step stops it and takes the M-step sums.
    row = profile_tick_steps(torch, ops, lambda: (ws.step(False), ws.flag()), lambda: load_state(ws, st),
                             f"MAP step K={n_labels}")
    emit({"phase": "map_step_profile_check", "K": n_labels, "steps": MAP_STEPS, **row})
    stop = profile_tick_steps(torch, ops, lambda: (ws.step(True, True), ws.flag()),
                              lambda: load_state(ws, st),
                              f"stopping launch K={n_labels}")
    emit({"phase": "map_step_profile_check", "K": n_labels, "steps": MAP_STEPS,
          "what": "launches that stop the MAP loop (cap bit: M-step sums)", **stop})

    load_state(ws, st)
    n = 10 * MAP_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        ws.step(False)
        ws.flag()
    out = {"K": n_labels, "ms_per_map_step": (time.perf_counter() - t0) / n * 1e3,
           "ms": time_ms(lambda: ws.step(False)), "device_ms": row["device_us_per_step"] * 1e-3,
           "stopping_launch": {"ms": time_ms(lambda: ws.step(True, True)),
                               "device_ms": stop["device_us_per_step"] * 1e-3}}
    plain = map_step_workspace(ops, em_mod, hoods, model, st, backend="torch")
    out["plain_ms"] = time_ms(lambda: plain.step(False))
    n_bytes = tick_step_bytes(hoods, n_labels)
    out["bound_ms"], out["bound_by"] = bound(n_bytes, tick_step_ops(hoods, n_labels))
    out["bytes"] = n_bytes
    emit({"phase": "timing", "what": f"MAP step (TickWorkspace) K={n_labels}", **out})
    return out


class TickLockstep:
    """A kernel ``TickWorkspace`` that, at every launch of a solve, copies
    its state (labels, history ring and head, and the EM iteration's
    parameters) to the CPU, runs the plain MAP iteration there
    (``ref.PlainTickWorkspace``: element-order sums) from that state and
    holds the kernel to it bit for bit: labels, hood sums, votes, flag word
    and ring (``cpu_step_unequal``).  The CPU step takes the card's ``log``
    of each sigma, which may differ from the host's in the last bit
    (``log_unequal`` counts the launches where it does).  At a launch that
    stops the MAP loop (its flag word set, or the cap) the M-step sums are
    held too (``stopping_launches`` counts them); the other launches do not
    take them.  Everything else is the kernel workspace's."""

    def __init__(self, torch, kern, cpu):
        self.torch, self.kern, self.cpu = torch, kern, cpu
        self.launches = self.stopping_launches = self.log_unequal = self.equal_launches = 0

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def start(self, hoods, model, y, w, nall_e, valid, labels0):
        self.kern.start(hoods, model, y, w, nall_e, valid, labels0)
        self.cpu.start(self.cpu.cpu_hoods, self.cpu.cpu_model,
                       *(t.cpu() for t in (y, w, nall_e, valid, labels0)))

    def begin_em(self, mu, sigma):
        self.kern.begin_em(mu, sigma)
        log_sigma = self.torch.log(sigma).cpu()
        self.cpu.begin_em(mu.cpu(), sigma.cpu(),
                          log_sigma=log_sigma if self.kern.precision == "f32" else None)
        self.same_log = self.torch.equal(log_sigma, self.torch.log(sigma.cpu()))

    def step(self, gate, cap=False):
        torch, k, c = self.torch, self.kern, self.cpu
        c.labels = k.labels.cpu()
        c.ring.copy_(k.ring)
        c.head = k.head
        k.step(gate, cap)
        c.step(gate, cap)
        self.launches += 1
        self.log_unequal += not self.same_log
        what = f"MAP step K={k.n_labels} launch {self.launches}"
        pairs = [("flag", k.flag(), c.flag()), ("labels", k.labels, c.labels),
                 ("hood_e", k.hood_e, c.hood_e), ("votes", k.votes, c.votes),
                 ("ring", k.ring, c.ring)]
        if k.flag() or cap:
            self.stopping_launches += 1
            pairs.append(("stats", k.stats, c.stats))
        self.equal_launches += not cpu_step_unequal(torch, pairs, what)


def check_tick_solve_against_cpu(torch, ops, em_mod, pipeline, sl) -> dict:
    """A whole single-device solve of a slice's plan (f32) on a
    ``TickLockstep``: every launch bit for bit the plain MAP iteration on
    the CPU from the kernel's state; the solve gives the main path's
    status, iteration counts and labels."""
    plan, config = sl["plan"], sl["config"]
    prob = plan.problem
    cfg = config.em_config()
    hoods_c, model_c, *_ = problem_on_cpu(plan, config, SLICE["seed"])
    cpu = ops.tick_workspace(ops.TickShape.of(hoods_c, model_c), device="cpu",
                             precision=cfg.precision, conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW)
    cpu.cpu_hoods, cpu.cpu_model = hoods_c, model_c
    kern = em_mod.make_workspace(ops.TickShape.of(prob.hoods, prob.model), cfg,
                                 device=prob.hoods.vertex.device)
    ws = TickLockstep(torch, kern, cpu)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, SLICE["seed"], config.init)
    res = em_mod.run_em(prob.hoods, prob.model, labels0, mu0, sigma0, cfg, workspace=ws)
    single = sl["result"]
    trajectory = [em_mod.STATUS_NAMES.get(res.status, "running"), res.em_iters, res.map_iters]
    row = {"phase": "tick_solve_cpu_check", "K": sl["K"], "ok": True, "launches": ws.launches,
           "bitwise_equal_plain_cpu_launches": ws.equal_launches,
           "launches_log_sigma_unequal_cpu": ws.log_unequal,
           "stopping_launches_stats_held": ws.stopping_launches, "trajectory": trajectory,
           "main_path": [single.status, single.em_iters, single.map_iters],
           "labels_equal_main_path": bool(np.array_equal(
               res.labels.cpu().numpy()[: prob.graph.n_regions], single.region_labels))}
    emit(row)
    if ws.launches != res.map_iters:
        fail(f"K={sl['K']} solve: {ws.launches} tick launches for {res.map_iters} MAP iterations")
    if trajectory != row["main_path"] or not row["labels_equal_main_path"]:
        fail(f"K={sl['K']} solve on the lockstep workspace: {trajectory}, the main path "
             f"{row['main_path']}, labels equal {row['labels_equal_main_path']}")
    return row


def warm_solve_ops(torch, api, plan, config) -> dict:
    """Device operations of one warm single-device solve of ``plan`` (the
    workspace built by an earlier solve), from ``torch.profiler``."""
    seg = api.Segmenter(config, device=plan.problem.hoods.vertex.device)
    wall = seg.execute(plan, seed=SLICE["seed"]).optimize_seconds
    prof = device_profile(torch, lambda: seg.execute(plan, seed=SLICE["seed"]))
    out = {"phase": "warm_solve_device_ops", "K": config.n_labels, "optimize_s_unprofiled": wall,
           **{k: prof[k] for k in ("device_ops", "kernels", "memsets", "memcpys", "device_busy_us")},
           "top": prof["top"]}
    emit(out)
    return out


def real_add_cases(torch, oversegment, sl) -> list:
    """The main path's float ``add`` calls at a slice, as order-free cases:
    the solve's neighbourhood sizes (``energy.make_static_context``: hood
    validity by hood id into n_hoods + 1, ids hood-sorted) and the plan's
    region intensity sums (``graph.region_stats``: the pixels by SLIC
    superpixel into n_regions, raster order)."""
    hoods, config = sl["plan"].problem.hoods, sl["config"]
    image = sl["image"].to(torch.float32)
    labels_px = oversegment.slic(image, grid=config.overseg_grid, iters=config.overseg_iters,
                                 device=image.device)
    n_regions = config.overseg_grid[0] * config.overseg_grid[1]
    np_ = lambda t: t.reshape(-1).cpu().numpy()
    return [
        ("solve: neighbourhood sizes", np_(hoods.valid.float()), np_(hoods.hood_id), hoods.n_hoods + 1),
        ("plan: region intensity sums", np_(image), np_(labels_px.to(torch.int32)), n_regions),
    ]


def segment_reduce_timing(torch, ops, hoods, profile: bool) -> dict:
    """``segment_reduce`` timed at the solve's call (``add`` of the hoods'
    validity into n_hoods + 1 segments) and, for ``min``, at the shape of
    the faithful mode's per-element minimum (``repro/core/pmrf/energy.py``
    min over K = 2 label energies: 2 x capacity values by hood-element lane,
    sorted, into capacity + 1 segments; normal values from a seed).  Each
    beside its plain version, one library call (``index_add_``;
    ``scatter_reduce_(..., "amin")``) and its bound; device time under
    ``--profile``."""
    dev = hoods.hood_id.device
    validf = hoods.valid.float()
    n_seg = hoods.n_hoods + 1
    ids_long = hoods.hood_id.long()
    lib_out = torch.zeros(n_seg, device=dev)
    add = lambda: ops.segment_reduce(validf, hoods.hood_id, n_seg, "add")
    if not torch.equal(add(), lib_out.index_add_(0, ids_long, validf)):
        fail("segment_reduce and index_add_ disagree on the neighbourhood sizes")
    n = hoods.capacity
    out = {"ms": time_ms(add),
           "plain_ms": time_ms(lambda: ops.segment_reduce(validf, hoods.hood_id, n_seg, "add",
                                                          backend="torch")),
           "library_ms": time_ms(lambda: lib_out.zero_().index_add_(0, ids_long, validf)),
           "shape": [n, n_seg]}
    out["bound_ms"], out["bound_by"] = bound(n * 8 + n_seg * 4, n)

    lane = torch.arange(n, dtype=torch.int32, device=dev)
    min_ids = torch.where(hoods.valid, lane, n).repeat(2).sort().values.contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    min_vals = torch.randn(2 * n, generator=gen, device=dev)
    min_ids_long = min_ids.long()
    inf_out = torch.full((n + 1,), float("inf"), device=dev)
    mn = lambda: ops.segment_reduce(min_vals, min_ids, n + 1, "min")
    lib_min = lambda: inf_out.fill_(float("inf")).scatter_reduce_(0, min_ids_long, min_vals, "amin")
    if not torch.equal(mn(), lib_min()):
        fail("segment_reduce min and scatter_reduce_ amin disagree")
    mins = {"ms": time_ms(mn),
            "plain_ms": time_ms(lambda: ops.segment_reduce(min_vals, min_ids, n + 1, "min",
                                                           backend="torch")),
            "library_ms": time_ms(lib_min), "shape": [2 * n, n + 1]}
    mins["bound_ms"], mins["bound_by"] = bound(2 * n * 8 + (n + 1) * 4, 2 * n)
    if profile:
        for what, fn, row in (("add at the solve's call", add, out), ("min, faithful shape", mn, mins)):
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            emit({"phase": "profile", "what": f"20 segment_reduce calls ({what})", **prof})
            row["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
        for what, fn, row in (("index_add_", lambda: lib_out.zero_().index_add_(0, ids_long, validf), out),
                              ("scatter_reduce_ amin", lib_min, mins)):
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            row["library_device_ms"] = prof["device_busy_us"] / 20 * 1e-3
    out["min"] = mins
    emit({"phase": "timing", "what": "segment_reduce", **out})
    return out


def problem_on_cpu(plan, config, seed: int):
    """The plan's problem (hoods, model, initial labels and parameters, the
    same as on the card) copied to the CPU."""
    from repro_torch.core.pmrf import convert, pipeline

    prob = plan.problem
    labels0, mu0, sigma0 = pipeline.initial_params(prob, seed, config.init)
    d = {f: getattr(prob.hoods, f) for f in convert.HOODS_ARRAYS + convert.HOODS_SIZES}
    d.update({f: getattr(prob.model, f) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu0, sigma0=sigma0)
    return convert.problem_from_numpy(d, device="cpu")


def plain_solve_on_cpu(plan, config, seed: int):
    """The plan's solve on the plain path with the problem copied to the
    CPU, where the keyed sums add in element order (the JAX package's
    order); the same initial parameters as on the card."""
    from repro_torch.core.pmrf import em as em_mod, pipeline

    t0 = time.perf_counter()
    res = em_mod.run_em(*problem_on_cpu(plan, config, seed), config.with_(backend="torch").em_config())
    return pipeline.assemble_result(plan.problem, res, plan.init_seconds, time.perf_counter() - t0)


def run_slice(torch, api, metrics, synthetic, ops, dev, n_labels: int, n_phases: int = 0) -> dict:
    """The main path: a 512x512 slice planned and solved through the
    session API, with the launch counts reset just before and read just
    after; then the same plan solved on the plain path for comparison.
    The image has ``n_phases`` phases (default ``n_labels``).  The solve
    must give the status and iteration counts of the plain path on the
    CPU, which sums in element order (``plain_solve_on_cpu``; the card's
    plain path adds by atomics): K = 2 7 EM / 32 MAP iterations, K = 3
    10 / 46, K = 9 on the three-phase image (the tick's runtime-K variant,
    which sums in element order too) 17 / 99."""
    size, grid, seed = SLICE["size"], SLICE["grid"], SLICE["seed"]
    n_phases = n_phases or n_labels
    if n_phases == 2:
        vol = synthetic.make_synthetic_volume(seed=seed, n_slices=1, shape=(size, size), device=dev)
    else:
        vol = synthetic.make_kary_volume(seed=seed, n_slices=1, shape=(size, size), n_phases=n_phases, device=dev)
    config = api.ExecutionConfig(
        mode="static-pallas", n_labels=n_labels, overseg_grid=(grid, grid), init="quantile"
    )
    seg = api.Segmenter(config, device=dev)

    ops.reset_launch_counts()
    plan = seg.plan(vol.images[0])
    res = seg.execute(plan, seed=seed)
    launches = ops.launch_counts()

    hoods = plan.problem.hoods
    sizes = {"n_regions": hoods.n_regions, "n_hoods": hoods.n_hoods,
             "n_elements": hoods.n_elements, "capacity": hoods.capacity}
    emit({"phase": "problem_sizes", "K": n_labels, "phases": n_phases, **sizes})

    gt = vol.ground_truth[0]

    def accuracy(r):
        if n_labels == 2:
            return metrics.evaluate(r.segmentation, gt).accuracy
        return metrics.multiclass_accuracy(r.segmentation, gt, n_labels)

    plain = api.Segmenter(config.with_(backend="torch"), device=dev)
    before = ops.launch_counts()
    res_p = plain.execute(plan, seed=seed)
    if ops.launch_counts() != before:
        fail("the plain path (backend='torch') launched a kernel")

    acc, acc_p = accuracy(res), accuracy(res_p)
    agree = float((res.segmentation == res_p.segmentation).mean())
    out = {
        "phase": "slice", "K": n_labels, "phases": n_phases, "size": size, "grid": grid,
        "plan_s": plan.init_seconds, "optimize_s": res.optimize_seconds,
        "em_iters": res.em_iters, "map_iters": res.map_iters, "status": res.status,
        "accuracy": acc, "launches": launches,
        "plain_optimize_s": res_p.optimize_seconds, "plain_em_iters": res_p.em_iters,
        "plain_map_iters": res_p.map_iters, "plain_status": res_p.status,
        "plain_accuracy": acc_p, "pixel_agreement": agree,
    }
    emit(out)
    if launches["fused_em_tick"] != res.map_iters:
        fail(f"fused_em_tick launched {launches['fused_em_tick']} times for {res.map_iters} MAP iterations")
    if launches["segment_reduce"] < 1:
        fail("segment_reduce never launched on the main path")
    if res.status not in ("converged", "max_iters"):
        fail(f"slice status {res.status}")
    if agree < 0.995:
        fail(f"kernel path and plain path agree on {agree:.4f} of the pixels")
    if acc < acc_p - 0.01:
        fail(f"kernel-path accuracy {acc} more than 0.01 below the plain path's {acc_p}")
    cpu = plain_solve_on_cpu(plan, config, seed)
    emit({"phase": "slice_plain_cpu", "K": n_labels, "status": cpu.status,
          "em_iters": cpu.em_iters, "map_iters": cpu.map_iters, "accuracy": accuracy(cpu),
          "pixel_agreement": float((res.segmentation == cpu.segmentation).mean())})
    trajectory = lambda r: (r.status, r.em_iters, r.map_iters)
    if trajectory(res) != trajectory(cpu):
        fail(f"K={n_labels} solve: status and iterations {trajectory(res)}, "
             f"plain path on the CPU {trajectory(cpu)}")
    out.update(plan=plan, config=config, result=res, accuracy_of=accuracy, image=vol.images[0])
    return out


def stack_volume(synthetic, dev, n_labels: int, n_slices: int):
    """``n_slices`` 512x512 slices of the synthetic volume (K = 2) or of the
    K-phase volume, seed 0."""
    size, seed = SLICE["size"], SLICE["seed"]
    if n_labels == 2:
        return synthetic.make_synthetic_volume(seed=seed, n_slices=n_slices, shape=(size, size), device=dev)
    return synthetic.make_kary_volume(seed=seed, n_slices=n_slices, shape=(size, size),
                                      n_phases=n_labels, device=dev)


def result_bits(r) -> tuple:
    """What a slice's result must repeat bit for bit: labels, mu, sigma,
    iteration counts and status."""
    return (np.asarray(r.region_labels).tobytes(), np.asarray(r.mu).tobytes(),
            np.asarray(r.sigma).tobytes(), r.em_iters, r.map_iters, r.status)


def inputs_on_cpu(inputs):
    """A stack's solve inputs (``Segmenter.stacked_inputs``) copied to the CPU."""
    import dataclasses

    import torch

    hoods, model, *rest = inputs
    hoods = dataclasses.replace(hoods, **{f.name: getattr(hoods, f.name).cpu()
                                          for f in dataclasses.fields(hoods)
                                          if isinstance(getattr(hoods, f.name), torch.Tensor)})
    return (hoods, type(model)(*(t.cpu() for t in model)), *(t.cpu() for t in rest))


def lane_inputs(inputs, b: int):
    """Lane ``b`` of a stack's solve inputs, as one problem's."""
    import dataclasses

    import torch

    hoods, model, *rest = inputs
    hoods = dataclasses.replace(hoods, **{f.name: getattr(hoods, f.name)[b]
                                          for f in dataclasses.fields(hoods)
                                          if isinstance(getattr(hoods, f.name), torch.Tensor)})
    return (hoods, type(model)(*(t[b] for t in model)), *(t[b] for t in rest))


def batch_state(ws) -> dict:
    """The views of a batched workspace a step writes, copied to the CPU."""
    return {"labels": ws.labels.cpu(), "votes": ws.votes.cpu(), "hood_e": ws.hood_e.cpu(),
            "ring": ws.ring.cpu(), "stats": ws.stats.cpu(), "active": ws.active.cpu().bool()}


def check_batched_entry(torch, ops, E, em_mod, seg, plans, joint, batch: int) -> dict:
    """The batched entry (``BatchTickWorkspace.step``) at ``batch`` lanes of
    the stack's padded problems, from the quantile init, with every fourth
    lane (from lane 1) marked inactive: ``WINDOW + 2`` steps, the last with
    the cap bit.  After every step, at f32, each view (labels, votes, hood
    sums, ring, M-step sums, active words) and each running lane's flag word
    equals bit for bit the plain batched step on the CPU
    (``ref.PlainBatchTickWorkspace``, given the card's ``log`` of each
    sigma); at f32 and bf16, each running lane equals the single-lane
    entry (``TickWorkspace``) on that lane's problem bit for bit; the
    inactive lanes' views stay as they were (the M-step sums start at -1
    on both sides, so a stray write shows)."""
    seed = SLICE["seed"]
    inputs = seg.stacked_inputs(plans[:batch], bucket=joint, seeds=[seed] * batch)
    hoods, model, labels0, mu0, sigma0 = inputs
    shape = ops.TickShape.of(hoods, model)
    active = [batch == 1 or b % 4 != 1 for b in range(batch)]
    steps = em_mod.WINDOW + 2
    sig = torch.maximum(sigma0, model.sigma_min[:, None])
    sctx = E.make_static_context_batched(hoods, model)
    cpu_in = inputs_on_cpu(inputs)
    csctx = E.make_static_context_batched(cpu_in[0], cpu_in[1])
    row = {"phase": "batched_tick_check", "B": batch, "inactive_lanes": active.count(False),
           "steps": steps, "ok": True}
    worst = 0.0
    for precision in ("f32", "bf16"):
        kw = dict(precision=precision, conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW)
        kern = ops.tick_workspace(shape, device=hoods.vertex.device, batch=batch, **kw)
        kern.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
        kern.stats.fill_(-1.0)
        kern.begin_em(mu0, sig, active)
        singles = {}
        for b in range(batch):
            if active[b]:
                h1, m1, l1, _, _ = lane_inputs(inputs, b)
                one = ops.tick_workspace(shape, device=hoods.vertex.device, **kw)
                s1 = E.make_static_context(h1, m1)
                one.start(h1, m1, s1.y, s1.w, s1.nall_e, s1.validf, l1)
                one.begin_em(mu0[b].contiguous(), sig[b].contiguous())
                singles[b] = one
        cpu = None
        if precision == "f32":
            cpu = ops.tick_workspace(shape, device="cpu", batch=batch, **kw)
            cpu.start(cpu_in[0], cpu_in[1], csctx.y, csctx.w, csctx.nall_e, csctx.validf, cpu_in[2])
            cpu.stats.fill_(-1.0)
            cpu.begin_em(mu0.cpu(), sig.cpu(), active, log_sigma=torch.log(sig).cpu())
        frozen = batch_state(kern)
        running = list(active)
        for i in range(1, steps + 1):
            gate, cap = i > em_mod.WINDOW, i == steps
            kern.step(gate, cap)
            flags = kern.flags()
            got = batch_state(kern)
            what = f"batched tick B={batch} {precision} step {i}"
            if cpu is not None:
                cpu.step(gate, cap)
                want = batch_state(cpu)
                cflags = cpu.flags()
                for name in want:
                    if not same_bits(torch, got[name], want[name]):
                        fail(f"{what}: {name} not bit for bit the plain batched step on the CPU")
                if [f for f, r in zip(flags, running) if r] != [f for f, r in zip(cflags, running) if r]:
                    fail(f"{what}: flag words {flags}, plain on the CPU {cflags}")
                worst = max(worst, float((got["hood_e"] - want["hood_e"]).abs().max()))
            for b, one in singles.items():
                if not running[b]:
                    continue
                one.step(gate, cap)
                if one.flag() != flags[b]:
                    fail(f"{what}: lane {b} flag {flags[b]}, single-lane entry {one.flag()}")
                pairs = [(got["labels"][b], one.labels), (got["votes"][b], one.votes),
                         (got["hood_e"][b], one.hood_e), (got["ring"][b], one.ring)]
                if flags[b] or cap:
                    pairs.append((got["stats"][b], one.stats))
                if not all(same_bits(torch, a, c.cpu()) for a, c in pairs):
                    fail(f"{what}: lane {b} differs from the single-lane entry")
            for b in range(batch):
                if not active[b] and not all(same_bits(torch, got[n][b], frozen[n][b])
                                             for n in ("labels", "votes", "hood_e", "ring", "stats")):
                    fail(f"{what}: inactive lane {b} was written")
                running[b] = running[b] and not (flags[b] or cap)
            if got["active"].tolist() != running:
                fail(f"{what}: active words {got['active'].tolist()}, expected {running}")
    row["max_abs_err"] = worst
    emit(row)
    return row


def run_stack(torch, api, synthetic, ops, E, em_mod, dev, n_labels: int, n_slices: int,
              profile: bool, timed: bool) -> dict:
    """The stack path: ``n_slices`` 512x512 slices at K = ``n_labels``
    through ``Segmenter.segment_stack(batch="always")``, launch counts reset
    just before and read just after.  Held: the fused_em_tick launches are
    all the batched entry's and equal the lockstep MAP iterations of the
    stack's solve (one launch per MAP iteration, run again on the bucket's
    executable); every lane equals bit for bit that slice's serial
    ``execute`` on the card, in the stack's joint bucket and in its own,
    and the plain batched path on the CPU (labels, mu, sigma, iteration
    counts, status); a second, warm ``segment_stack`` builds no workspace
    and repeats the bits.  With ``timed``: mean ``optimize_s`` per slice
    of the batched and the serial solve over ``STACK_REPEATS`` drains of
    the planned slices (best and median), batched launches against the
    serial ones, and the batched launch's ms and device time at B =
    ``n_slices`` against its bound; with ``profile`` also the device
    operations and idle share of one warm stack solve."""
    from repro_torch.kernels import em_tick

    seed = SLICE["seed"]
    vol = stack_volume(synthetic, dev, n_labels, n_slices)
    config = api.ExecutionConfig(n_labels=n_labels, overseg_grid=(SLICE["grid"],) * 2, init="quantile")
    seg = api.Segmenter(config, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results, mean_opt = seg.segment_stack(vol.images, seed=seed, batch="always")
    wall = time.perf_counter() - t0
    launches, batched_launches = ops.launch_counts(), em_tick.launches_batched

    plans = [seg.plan(img) for img in vol.images]
    joint = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
    exe = seg.compile(joint, batch=n_slices)
    inputs = seg.stacked_inputs(plans, bucket=joint, seeds=[seed] * n_slices)
    ops.reset_launch_counts()
    again = exe(*inputs)
    if ops.launch_counts()["fused_em_tick"] != again.steps or em_tick.launches_batched != again.steps:
        fail(f"stack K={n_labels}: {ops.launch_counts()['fused_em_tick']} tick launches for "
             f"{again.steps} lockstep MAP iterations")
    if launches["fused_em_tick"] != batched_launches or batched_launches != again.steps:
        fail(f"stack K={n_labels}: segment_stack made {launches['fused_em_tick']} tick launches "
             f"({batched_launches} batched) for {again.steps} lockstep MAP iterations")
    if launches["segment_reduce"] < 1:
        fail(f"stack K={n_labels}: segment_reduce never launched")

    ops.reset_launch_counts()
    serial_own = [seg.execute(p, seed=seed) for p in plans]
    serial_launches = ops.launch_counts()["fused_em_tick"]
    serial_joint = [seg.execute(p, seed=seed, bucket=joint) for p in plans]
    cpu = em_mod.run_em_batched(*inputs_on_cpu(inputs), config.em_config())
    n_regions = [p.problem.graph.n_regions for p in plans]
    for i, r in enumerate(results):
        lane = cpu.lane(i)
        cpu_bits = (lane.labels.numpy()[: n_regions[i]].tobytes(), lane.mu.numpy().tobytes(),
                    lane.sigma.numpy().tobytes(), lane.em_iters, lane.map_iters,
                    em_mod.STATUS_NAMES[lane.status])
        for what, other in (("serial execute in the joint bucket", result_bits(serial_joint[i])),
                            ("serial execute in its own bucket", result_bits(serial_own[i])),
                            ("the plain batched path on the CPU", cpu_bits)):
            if result_bits(r) != other:
                fail(f"stack K={n_labels} lane {i}: not bit for bit {what}")
        if r.status not in ("converged", "max_iters"):
            fail(f"stack K={n_labels} lane {i}: status {r.status}")

    builds = ops.WORKSPACE_BUILDS
    warm, _ = seg.segment_stack(vol.images, seed=seed, batch="always")
    warm_builds = ops.WORKSPACE_BUILDS - builds
    if warm_builds or [result_bits(r) for r in warm] != [result_bits(r) for r in results]:
        fail(f"stack K={n_labels}: the warm segment_stack built {warm_builds} workspaces or "
             "changed a result")
    gt = vol.ground_truth
    acc = [metrics_accuracy(r, gt[i], n_labels) for i, r in enumerate(results)]
    out = {"phase": "stack", "K": n_labels, "slices": n_slices, "batch": "always",
           "bucket": list(joint), "own_buckets": sorted({tuple(p.bucket) for p in plans}),
           "wall_s": wall, "mean_optimize_s": mean_opt,
           "plan_s_mean": float(np.mean([p.init_seconds for p in plans])),
           "launches": launches, "batched_launches": batched_launches,
           "lockstep_map_iterations": again.steps, "serial_launches": serial_launches,
           "em_iters": [r.em_iters for r in results], "map_iters": [r.map_iters for r in results],
           "status": sorted({r.status for r in results}), "mean_accuracy": float(np.mean(acc)),
           "lanes_equal_serial_and_cpu": True, "warm_workspace_builds": warm_builds,
           "cache": seg.stats.as_dict()}
    if timed:
        def drain():
            for p in plans:
                seg.submit(p, seed=seed, bucket=joint)
            return seg.drain()

        batched = [float(np.mean([r.optimize_seconds for r in drain()])) for _ in range(STACK_REPEATS)]
        serial = [float(np.mean([seg.execute(p, seed=seed).optimize_seconds for p in plans]))
                  for _ in range(STACK_REPEATS)]
        out["optimize_s_per_slice"] = {"batched": spread(batched), "serial": spread(serial)}
        out["batched_step"] = time_batched_step(torch, ops, E, em_mod, exe, inputs, plans)
        if profile:
            walls = spread([float(np.sum([r.optimize_seconds for r in drain()])) for _ in range(SOLVES)])
            prof = device_profile(torch, drain)
            out["profile"] = {"stack_optimize_s_unprofiled": walls,
                              "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / walls["min"],
                              **{k: prof[k] for k in ("device_ops", "kernels", "memsets", "memcpys",
                                                      "device_busy_us", "top")}}
    emit(out)
    out.update(seg=seg, plans=plans, joint=joint, images=vol.images)
    return out


def metrics_accuracy(r, gt, n_labels: int) -> float:
    from repro_torch.core import metrics

    if n_labels == 2:
        return metrics.evaluate(r.segmentation, gt).accuracy
    return metrics.multiclass_accuracy(r.segmentation, gt, n_labels)


def time_batched_step(torch, ops, E, em_mod, exe, inputs, plans) -> dict:
    """The batched entry at every lane of a stack, from the quantile init
    with the gate closed (no lane stops): ms per launch back to back (CUDA
    events), device us per launch (profiler, ``profile_tick_steps``), the
    plain batched step's ms on the card, and the bound: the lanes' MAP-step
    bytes and operations (``tick_step_bytes``, ``tick_step_ops``, each lane
    at its own hood runs) at the card's rates."""
    hoods, model, labels0, mu0, sigma0 = inputs
    batch = int(labels0.shape[0])
    sig = torch.maximum(sigma0, model.sigma_min[:, None])
    sctx = E.make_static_context_batched(hoods, model)
    ws = exe.workspace
    ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    reset = lambda: ws.begin_em(mu0, sig, [True] * batch)
    prof = profile_tick_steps(torch, ops, lambda: (ws.step(False), ws.flags()), reset,
                              f"batched tick B={batch}", kernel="tick_kernel_batched")
    reset()
    out = {"B": batch, "ms": time_ms(lambda: ws.step(False)), "device_ms": prof["device_us_per_step"] * 1e-3,
           "profile": prof}
    plain = ops.tick_workspace(ws.shape, device=ws.device, batch=batch, precision=ws.precision,
                               conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW, backend="torch")
    plain.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    plain.begin_em(mu0, sig, [True] * batch)
    out["plain_ms"] = time_ms(lambda: plain.step(False), iters=5, warmup=1)
    n_bytes = n_ops = 0
    for p in plans:
        h = p.problem.hoods
        n_bytes += tick_step_bytes(h, model.n_labels)
        n_ops += tick_step_ops(h, model.n_labels)
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_ops)
    out["bytes"] = n_bytes
    emit({"phase": "timing", "what": f"batched fused_em_tick B={batch} K={model.n_labels}", **out})
    return out


POOL_VIEWS = ("labels", "votes", "hood_e", "ring", "stats", "map_i", "mu", "sigma", "y", "w", "nall",
              "valid", "vertex", "offsets", "region_mean", "region_weight", "beta")


def pool_state(ws) -> dict:
    """Every buffer of a pool workspace (``PoolTickWorkspace`` or its plain
    version) a launch or a slot write may change, copied to the CPU; the
    active words as booleans."""
    out = {n: getattr(ws, n).to("cpu", copy=True) for n in POOL_VIEWS if hasattr(ws, n)}
    out["active"] = ws.active.to("cpu", copy=True).bool()
    return out


class PoolLockstep:
    """A kernel ``PoolTickWorkspace`` that, at every launch, copies its state
    (every lane's inputs, labels, ring, MAP counter, active word, and the
    card's ``log`` of each sigma) to a plain pool on the CPU
    (``ref.PlainPoolTickWorkspace``), steps both, and holds the launch to the
    plain step bit for bit: labels, votes, hood sums, ring, M-step sums,
    MAP counters, active words, and the flag words of the lanes that ran.
    ``launches`` counts the launches held, ``stopping`` the lanes whose MAP
    loop a launch stopped (their M-step sums held).  Everything else is the
    kernel pool's."""

    def __init__(self, torch, kern, cpu):
        self.torch, self.kern, self.cpu = torch, kern, cpu
        self.launches = self.stopping = 0
        self.max_abs_err = 0.0
        self.owner = None

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def admit(self, slot, hoods, model, y, w, nall_e, valid, labels0):
        self.kern.admit(slot, hoods, model, y, w, nall_e, valid, labels0)
        self.cpu.hood_id[slot] = hoods.hood_id.cpu()

    def step(self):
        torch, k, c = self.torch, self.kern, self.cpu
        before = pool_state(k)
        for name, t in before.items():
            if name != "offsets":
                getattr(c, name).copy_(t)
        c.log_sigma = torch.log(k.sigma).cpu()
        k.step()
        c.step()
        flags, cflags = k.flags(), c.flags()
        after = pool_state(k)
        ran = before["active"].tolist()
        self.launches += 1
        self.stopping += sum(r and not a for r, a in zip(ran, after["active"].tolist()))
        what = f"pool launch {self.launches}"
        cpu_step_unequal(torch, [(n, after[n], getattr(c, n)) for n in
                                 ("labels", "votes", "hood_e", "ring", "stats", "map_i", "active")], what)
        if [f for f, r in zip(flags, ran) if r] != [f for f, r in zip(cflags, ran) if r]:
            fail(f"{what}: flag words {flags}, the plain pool on the CPU {cflags}")
        self.max_abs_err = max(self.max_abs_err, float((after["hood_e"] - c.hood_e).abs().max()))


def pool_workspaces(torch, ops, em_mod, shape, dev, batch: int, max_map_iters: int):
    """A kernel pool on the card wrapped in a ``PoolLockstep`` with its plain
    pool on the CPU, both of ``batch`` slots."""
    kw = dict(batch=batch, pool=True, max_map_iters=max_map_iters, conv_tol=em_mod.CONV_TOL,
              window=em_mod.WINDOW)
    return PoolLockstep(torch, ops.tick_workspace(shape, device=dev, **kw),
                        ops.tick_workspace(shape, device="cpu", **kw))


def check_pool_entry(torch, ops, em_mod, seg, plans, bucket, batch: int) -> dict:
    """The pool entry (``PoolTickWorkspace.step``) at ``batch`` slots of the
    serve stream's padded problems: lane b starts its MAP loop at launch b
    mod 3 (so the lanes of one launch sit at different MAP iterations, and
    each reaches its cap of ``POOL_CHECK_MAP_ITERS`` at its own launch);
    every fourth lane from lane 1 never starts.  Every launch is held to
    the plain pool step on the CPU (``PoolLockstep``); each running lane
    bit for bit to the single-lane entry (``TickWorkspace``) stepped with
    the lane's own gate and cap; the idle lanes' buffers stay as admitted.
    Then a slot write (admit, begin, retire) into one slot leaves every
    other slot's buffers bit for bit as they were."""
    seed = SLICE["seed"]
    lanes = [seg.lane_state(p, bucket=bucket, seed=seed) for p in plans[:batch]]
    hoods, model = lanes[0][0], lanes[0][1]
    shape, dev = ops.TickShape.of(hoods, model), hoods.vertex.device
    ws = pool_workspaces(torch, ops, em_mod, shape, dev, batch, POOL_CHECK_MAP_ITERS)
    for b, (h, m, lab0, _, _, sctx) in enumerate(lanes):
        ws.admit(b, h, m, sctx.y, sctx.w, sctx.nall_e, sctx.validf, lab0)
    ws.kern.stats.fill_(-1.0)
    idle = [batch > 1 and b % 4 == 1 for b in range(batch)]
    frozen = pool_state(ws.kern)
    singles = {}
    launches = POOL_CHECK_MAP_ITERS + 2
    for s in range(launches):
        start = [b for b in range(batch) if not idle[b] and b % 3 == s]
        if start:
            mu = torch.stack([lanes[b][3] for b in start])
            sig = torch.stack([torch.maximum(lanes[b][4], lanes[b][1].sigma_min) for b in start])
            ws.begin_lanes(start, mu, sig)
            for j, b in enumerate(start):
                h, m, lab0, _, _, sctx = lanes[b]
                one = ops.tick_workspace(shape, device=dev, conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW)
                one.start(h, m, sctx.y, sctx.w, sctx.nall_e, sctx.validf, lab0)
                one.begin_em(mu[j].contiguous(), sig[j].contiguous())
                singles[b] = [one, 0]
        running = ws.kern.active.cpu().bool().tolist()
        ws.step()
        flags = ws.flags()
        got = pool_state(ws.kern)
        what = f"pool entry B={batch} launch {s + 1}"
        for b, entry in singles.items():
            if not running[b]:
                continue
            one = entry[0]
            entry[1] += 1
            cap = entry[1] == POOL_CHECK_MAP_ITERS
            one.step(entry[1] > em_mod.WINDOW, cap)
            if one.flag() != flags[b]:
                fail(f"{what}: lane {b} flag {flags[b]}, single-lane entry {one.flag()}")
            pairs = [(got["labels"][b], one.labels), (got["votes"][b], one.votes),
                     (got["hood_e"][b], one.hood_e), (got["ring"][b], one.ring)]
            if flags[b] or cap:
                pairs.append((got["stats"][b], one.stats))
            if not all(same_bits(torch, a, c.cpu()) for a, c in pairs):
                fail(f"{what}: lane {b} differs from the single-lane entry")
            if int(got["map_i"][b]) != entry[1]:
                fail(f"{what}: lane {b} MAP counter {int(got['map_i'][b])}, expected {entry[1]}")
        for b in range(batch):
            if idle[b] and not all(same_bits(torch, got[n][b], frozen[n][b]) for n in got):
                fail(f"{what}: idle lane {b} was written")
    if any(ws.kern.active.cpu().tolist()):
        fail(f"pool entry B={batch}: lanes still active after their caps")
    slot_ok = True
    if batch > 1:
        target = batch - 1
        before = pool_state(ws.kern)
        h, m, lab0, mu0, sig0, sctx = lanes[0]
        ws.admit(target, h, m, sctx.y, sctx.w, sctx.nall_e, sctx.validf, lab0)
        ws.begin_lanes([target], mu0[None], torch.maximum(sig0, m.sigma_min)[None])
        ws.retire(target)
        after = pool_state(ws.kern)
        slot_ok = all(same_bits(torch, after[n][b], before[n][b])
                      for n in after for b in range(batch) if b != target)
        if not slot_ok:
            fail(f"pool entry B={batch}: a write to slot {target} moved another slot's buffers")
    row = {"phase": "pool_tick_check", "B": batch, "idle_lanes": idle.count(True),
           "launches": ws.launches, "stopping_lanes_held": ws.stopping,
           "launches_bitwise_plain_cpu": ws.launches, "lanes_bitwise_single_entry": len(singles),
           "slot_writes_touch_one_slot": slot_ok, "max_abs_err": ws.max_abs_err, "ok": True}
    emit(row)
    return row


def completion_bits(c) -> tuple:
    return result_bits(c.result) + (c.status,)


def serve_stream(torch, ops, seg, plans, bucket, tick_iters, max_batch: int, **engine_kw) -> dict:
    """One engine run over ``plans`` (pool compiled, its workspace built,
    before the counts are reset): completions by rid, the launch counts
    (``segment_reduce``'s by variant, and the flat steps of a mode's pool),
    the reads of a mode pool's M-step sums, the workspace builds during the
    run, the wall time and the engine."""
    from repro_torch.kernels import em_tick
    from repro_torch.serving import SegmentationEngine
    from repro_torch.serving.engine import DEFAULT_TICK_LADDER

    for t in DEFAULT_TICK_LADDER if tick_iters == "auto" else (tick_iters,):
        seg.compile_ticked(bucket, batch=max_batch, tick_iters=t)
    engine = SegmentationEngine(seg, max_batch=max_batch, tick_iters=tick_iters, bucket=bucket,
                                **engine_kw)
    builds = ops.WORKSPACE_BUILDS
    pool_ws = seg.ticked_pool(bucket, batch=max_batch).workspace
    m0 = getattr(pool_ws, "m_steps", 0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, p in enumerate(plans):
        engine.submit(p, rid=rid, seed=SLICE["seed"])
    comps = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"completions": {c.rid: c for c in comps}, "launches": ops.launch_counts(),
            "pool_launches": em_tick.launches_pool, "builds": ops.WORKSPACE_BUILDS - builds,
            "wall_s": wall, "engine": engine, "lane_steps": ops.LANE_STEPS,
            "segment_reduce": ops.segment_reduce_launches(),
            "m_steps": getattr(pool_ws, "m_steps", 0) - m0}


def serve_row(what: str, run: dict, serial: list) -> dict:
    """The ``serve`` line of one run; fails unless every completion equals
    its serial ``execute`` bit for bit, the pool launches are the run's
    micro-steps, and the run built no workspace."""
    comps, engine = run["completions"], run["engine"]
    st = engine.stats()
    for rid, want in enumerate(serial):
        if rid not in comps or completion_bits(comps[rid]) != result_bits(want) + (want.status,):
            fail(f"serve {what}: request {rid} not bit for bit its serial execute")
    if not (run["pool_launches"] == run["launches"]["fused_em_tick"] == st["total_steps"]):
        fail(f"serve {what}: {run['launches']['fused_em_tick']} tick launches "
             f"({run['pool_launches']} pool) for {st['total_steps']} micro-steps")
    if run["builds"]:
        fail(f"serve {what}: {run['builds']} workspaces built after the pool was set up")
    lat = sorted(c.latency_s for c in comps.values())
    row = {"phase": "serve", "what": what, "requests": len(comps), "ticks": st["ticks"],
           "micro_steps": st["total_steps"], "pool_launches": run["pool_launches"],
           "occupancy": st["occupancy"], "steps_saved_early_exit": st["steps_saved_early_exit"],
           "tick_switches": st["tick_switches"], "workspace_builds_after_setup": run["builds"],
           "wall_s": run["wall_s"], "requests_per_s": len(comps) / run["wall_s"],
           "latency_p50_s": float(np.percentile(lat, 50)), "latency_p99_s": float(np.percentile(lat, 99)),
           "residence_p50_s": float(np.percentile([c.residence_s for c in comps.values()], 50)),
           "lane_map_iters": sum(r.map_iters for r in serial), "launches": run["launches"],
           "statuses": sorted({c.status for c in comps.values()}), "bitwise_serial": True,
           "tick_cost": st["tick_cost"]}
    emit(row)
    return row


def time_pool_step(torch, ops, em_mod, seg, plans, bucket, batch: int, profile: bool) -> dict:
    """The pool entry at ``batch`` lanes of the serve stream, on a pool that
    no lane can leave (convergence tolerance 0 and a MAP cap of
    ``NEVER_STOP``, the same arithmetic and bytes as the served pool's): ms
    per launch back to back (CUDA events), ms per micro-step as
    ``run_em_ticked`` runs it (launch, flag read and the host's
    bookkeeping; host clock), the plain pool step's ms on the card, and the
    bound: the lanes' MAP-step bytes and operations.  With ``profile``:
    the device us per launch and the device operations of ``MAP_STEPS``
    micro-steps (one kernel each, no memset, no copy); a trace that shows
    fewer tick kernels and nothing else is made again, up to
    ``PROFILE_ATTEMPTS`` times, and one that shows another kernel, a
    memset or a copy fails at once."""
    cfg = seg.config.em_config()._replace(max_map_iters=NEVER_STOP)
    lanes = [seg.lane_state(p, bucket=bucket, seed=SLICE["seed"]) for p in plans[:batch]]
    shape, dev = ops.TickShape.of(lanes[0][0], lanes[0][1]), lanes[0][0].vertex.device

    def fresh(backend=None):
        ws = ops.tick_workspace(shape, device=dev, batch=batch, pool=True, max_map_iters=NEVER_STOP,
                                conv_tol=0.0, window=em_mod.WINDOW, backend=backend)
        state = em_mod.blank_tick_state(ws)

        def reset():
            for b, lane in enumerate(lanes):
                em_mod.init_tick_lane(state, b, *lane)
        reset()
        return state, reset

    state, reset = fresh()
    micro = lambda: em_mod._tick_micro(state, cfg)  # noqa: E731
    n = 10 * MAP_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        micro()
    out = {"B": batch, "ms_per_micro_step": (time.perf_counter() - t0) / n * 1e3,
           "ms": time_ms(state.workspace.step)}
    if any(state.done):
        fail(f"pool timing B={batch}: a lane stopped")
    if profile:
        attempts = []
        steps = MAP_STEPS
        for _ in range(PROFILE_ATTEMPTS):
            reset()
            before = ops.launch_counts()["fused_em_tick"]
            prof = device_profile(torch, lambda: [micro() for _ in range(steps)])
            ticks = sum(t["count"] for t in prof["top"] if "tick_kernel_batched" in t["name"])
            a = {"micro_steps": steps, "launches": ops.launch_counts()["fused_em_tick"] - before,
                 "tick_kernels": ticks, **{k2: prof[k2] for k2 in ("kernels", "memsets", "memcpys")},
                 "device_us_per_launch": prof["device_busy_us"] / max(ticks, 1)}
            attempts.append(a)
            if a["launches"] != steps or a["kernels"] != ticks or ticks > steps or a["memsets"] or a["memcpys"]:
                fail(f"pool micro-steps B={batch}: {steps} micro-steps issued {a}")
            if ticks == steps:
                break
        else:
            fail(f"pool micro-steps B={batch}: no profile saw every launch: {attempts}")
        out["device_ms"] = a["device_us_per_launch"] * 1e-3
        out["profile"] = {"attempts": attempts, "per_micro_step": {"kernels": 1, "memsets": 0, "memcpys": 0}}
    plain, _ = fresh("torch")
    out["plain_ms"] = time_ms(plain.workspace.step, iters=3, warmup=1)
    n_bytes = sum(tick_step_bytes(p.problem.hoods, shape.n_labels) for p in plans[:batch])
    n_ops = sum(tick_step_ops(p.problem.hoods, shape.n_labels) for p in plans[:batch])
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_ops)
    out["bytes"] = n_bytes
    emit({"phase": "timing", "what": f"fused_em_tick pool entry B={batch} K={shape.n_labels}", **out})
    return out


def serve_mixed_k(torch, api, synthetic, ops, em_mod, dev, config, plans, serial) -> dict:
    """``SERVE_MIXED`` K = 2 requests of the serve stream and as many K = 3
    slices of the three-phase volume in one K = 3 pool, in ``config``'s
    mode: each completion equals its serial ``execute`` in its own K's
    session (a K = 2 lane's real labels, with its padded label at the inert
    mu).  A mode's pool launches no fused kernel and ``segment_reduce`` as
    its flat steps imply."""
    seed = SLICE["seed"]
    vol3 = stack_volume(synthetic, dev, 3, SERVE_MIXED)
    seg3 = api.Segmenter(config.with_(n_labels=3), device=dev)
    plans3 = [seg3.plan(img) for img in vol3.images]
    mixed = plans[:SERVE_MIXED] + plans3
    bucket3 = api.BucketKey(*(max(p.bucket[d] for p in mixed) for d in range(3)))
    run = serve_stream(torch, ops, seg3, mixed, bucket3, SERVE_TICK, len(mixed) // 2)
    for rid, p in enumerate(mixed):
        c = run["completions"][rid]
        if rid < SERVE_MIXED:
            want = serial[rid]
            got = c.result
            same = (got.region_labels.tobytes() == want.region_labels.tobytes()
                    and got.mu[:2].tobytes() == want.mu.tobytes()
                    and got.sigma[:2].tobytes() == want.sigma.tobytes()
                    and (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                                       want.status)
                    and got.mu[2] == em_mod.INERT_MU)
        else:
            same = result_bits(c.result) == result_bits(seg3.execute(p, seed=seed))
        if not same:
            fail(f"serve mixed K: request {rid} (K={2 if rid < SERVE_MIXED else 3}) not bit for bit "
                 "its serial execute in its own K's session")
    mode = config.mode
    row = {"phase": "serve" if mode == "static-pallas" else "modes_serve", "mode": mode,
           "what": "mixed K (4 K=2, 4 K=3, K=3 pool of 4)", "requests": len(mixed),
           "micro_steps": run["engine"].total_steps, "pool_launches": run["pool_launches"],
           "bucket": list(bucket3), "workspace_builds_after_setup": run["builds"],
           "bitwise_serial_own_k": True}
    if mode != "static-pallas":
        check_modes_serve_launches(f"serve mixed K {mode}", mode, run)
        row.update(flat_steps=run["lane_steps"], m_steps=run["m_steps"],
                   segment_reduce=run["segment_reduce"])
    emit(row)
    return row


def check_modes_serve_launches(what: str, mode: str, run: dict) -> None:
    """A mode's served run: no fused kernel launched, one flat step per
    micro-step, ``segment_reduce`` as ``modes_flat_expected`` says, and no
    workspace built."""
    steps = run["engine"].total_steps
    if any(run["launches"][f] for f in ("fused_em_tick", "fused_map_step")):
        fail(f"{what}: a fused kernel launched: {run['launches']}")
    want = modes_flat_expected(mode, steps, run["m_steps"])
    if run["lane_steps"] != steps or run["segment_reduce"] != want:
        fail(f"{what}: {run['lane_steps']} flat steps for {steps} micro-steps, segment_reduce "
             f"{run['segment_reduce']} where the steps imply {want}")
    if run["builds"]:
        fail(f"{what}: {run['builds']} workspaces built after the pool was set up")


def run_modes_serve(torch, api, synthetic, ops, em_mod, dev, config, plans, bucket,
                    profile: bool) -> dict:
    """The modes' serve path: the serve stream in modes ``static`` and
    ``faithful`` through ``SegmentationEngine(max_batch=SERVE_SLOTS)`` on
    the mode's pool (``DppPoolWorkspace``), with ``tick_iters=SERVE_TICK``
    and ``"auto"``, launch counts reset just before and read just after:
    every completion bit for bit its serial ``execute`` in the same mode,
    no fused kernel, one flat step per micro-step, ``segment_reduce`` as
    the steps imply, no workspace built after the pool's set-up.  Then the
    mixed-K pool in the mode; with ``profile``, the idle share of a warm
    served stream."""
    out = {}
    for mode in MODES:
        cfg = config.with_(mode=mode)
        seg = api.Segmenter(cfg, device=dev)
        serial = [seg.execute(p, seed=SLICE["seed"]) for p in plans]
        for tick in (SERVE_TICK, "auto"):
            what = f"{mode} K=2 tick_iters={tick}"
            run = serve_stream(torch, ops, seg, plans, bucket, tick, SERVE_SLOTS)
            comps, st = run["completions"], run["engine"].stats()
            for rid, want in enumerate(serial):
                if rid not in comps or completion_bits(comps[rid]) != result_bits(want) + (want.status,):
                    fail(f"modes serve {what}: request {rid} not bit for bit its serial execute")
            check_modes_serve_launches(f"modes serve {what}", mode, run)
            lat = sorted(c.latency_s for c in comps.values())
            row = {"phase": "modes_serve", "mode": mode, "what": what, "requests": len(comps),
                   "ticks": st["ticks"], "micro_steps": st["total_steps"],
                   "flat_steps": run["lane_steps"], "m_steps": run["m_steps"],
                   "occupancy": st["occupancy"], "steps_saved_early_exit": st["steps_saved_early_exit"],
                   "workspace_builds_after_setup": run["builds"], "wall_s": run["wall_s"],
                   "requests_per_s": len(comps) / run["wall_s"],
                   "latency_p50_s": float(np.percentile(lat, 50)),
                   "latency_p99_s": float(np.percentile(lat, 99)),
                   "serial_execute_solve_s": float(sum(r.optimize_seconds for r in serial)),
                   "lane_map_iters": sum(r.map_iters for r in serial), "launches": run["launches"],
                   "segment_reduce": run["segment_reduce"],
                   "segment_reduce_per_micro_step": {v: n / st["total_steps"]
                                                     for v, n in run["segment_reduce"].items()},
                   "statuses": sorted({c.status for c in comps.values()}), "bitwise_serial": True}
            emit(row)
            out[(mode, tick)] = row
        out[(mode, "mixed")] = serve_mixed_k(torch, api, synthetic, ops, em_mod, dev, cfg, plans, serial)
        if profile:
            serve_profile(torch, ops, seg, plans, bucket, f"{mode} ")
    return out


def serve_chaos(torch, ops, em_mod, seg, plans, bucket, serial) -> None:
    """A ``bad_init``, a ``nan_data`` and a ``never_converge`` request among
    8 of the serve stream: the first two retire ``diverged``, as their
    serial runs on the same corrupted inputs do, the third is evicted, and
    every healthy lane is bit for bit its serial ``execute``."""
    from repro_torch.testing import chaos

    seed, config = SLICE["seed"], seg.config
    faults = {1: "bad_init", 4: "nan_data", 6: "never_converge"}
    cfg = chaos.ChaosConfig(seed=seed, **{f"{f}_rids": (r,) for r, f in faults.items()})
    with chaos.inject(cfg):
        run = serve_stream(torch, ops, seg, plans[:8], bucket, SERVE_TICK, SERVE_SLOTS // 2,
                           max_ticks_resident=15)
    statuses = {rid: c.status for rid, c in run["completions"].items()}
    for rid, fault in faults.items():
        want = "evicted" if fault == "never_converge" else "diverged"
        if fault != "never_converge":
            h, m, lab0, mu0, sig0 = seg.lane_inputs(plans[rid], bucket=bucket, seed=seed)
            m, lab0, mu0, sig0 = chaos.ChaosMonkey(cfg).on_admit(rid, m, lab0, mu0, sig0)
            ser = em_mod.STATUS_NAMES[em_mod.run_em(h, m, lab0, mu0, sig0, config.em_config()).status]
            if ser != want:
                fail(f"serve chaos: {fault} request {rid}'s serial run is {ser}, not {want}")
        if statuses.get(rid) != want:
            fail(f"serve chaos: {fault} request {rid} completed {statuses.get(rid)}, want {want}")
    for rid in range(8):
        if rid not in faults and completion_bits(run["completions"][rid]) != result_bits(serial[rid]) + (
                serial[rid].status,):
            fail(f"serve chaos: healthy request {rid} not bit for bit its serial execute")
    emit({"phase": "serve", "what": "chaos (bad_init, nan_data, never_converge among 8)",
          "statuses": {str(r): s for r, s in sorted(statuses.items())},
          "micro_steps": run["engine"].total_steps, "evicted": run["engine"].evicted,
          "healthy_bitwise_serial": True})


def serve_cpu_check(torch, ops, em_mod, seg, plans, bucket, serial) -> None:
    """Every pool launch of a ``SERVE_CPU_REQUESTS``-request stream through
    ``SERVE_CPU_SLOTS`` slots (so lanes are admitted mid-stream) held bit for
    bit to the plain pool step on the CPU (``PoolLockstep``, installed as
    the session's pool workspace for the run), M-step sums included."""
    slots = SERVE_CPU_SLOTS
    shape = ops.TickShape(bucket.capacity, bucket.n_hoods, bucket.n_regions + 1, 2)
    lock = pool_workspaces(torch, ops, em_mod, shape, seg.device, slots, seg.config.max_map_iters)
    key = seg._key_for(bucket, slots)
    seg._pools[key] = lock
    try:
        run = serve_stream(torch, ops, seg, plans[:SERVE_CPU_REQUESTS], bucket, SERVE_CPU_TICK, slots)
    finally:
        del seg._pools[key]
        seg._cache.pop(key._replace(tick_iters=SERVE_CPU_TICK), None)
    for rid in range(SERVE_CPU_REQUESTS):
        if completion_bits(run["completions"][rid]) != result_bits(serial[rid]) + (serial[rid].status,):
            fail(f"serve_cpu_check: request {rid} not bit for bit its serial execute")
    if lock.launches != run["engine"].total_steps:
        fail(f"serve_cpu_check: {lock.launches} launches held for {run['engine'].total_steps} micro-steps")
    emit({"phase": "serve_cpu_check", "requests": SERVE_CPU_REQUESTS, "slots": slots,
          "tick_iters": SERVE_CPU_TICK, "launches_bitwise_plain_cpu": lock.launches,
          "stopping_lanes_stats_held": lock.stopping, "admitted_mid_stream": SERVE_CPU_REQUESTS - slots,
          "max_abs_err": lock.max_abs_err, "ok": True})


def serve_plans(api, synthetic, dev):
    """The serve stream: ``SERVE_REQUESTS`` 512x512 K = 2 slices of the
    synthetic volume planned in a quantile-init session, their joint
    bucket, and each one's serial ``execute``."""
    vol = stack_volume(synthetic, dev, 2, SERVE_REQUESTS)
    config = api.ExecutionConfig(n_labels=2, overseg_grid=(SLICE["grid"],) * 2, init="quantile")
    seg = api.Segmenter(config, device=dev)
    plans = [seg.plan(img) for img in vol.images]
    bucket = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
    serial = [seg.execute(p, seed=SLICE["seed"]) for p in plans]
    return vol, config, seg, plans, bucket, serial


def serve_profile(torch, ops, seg, plans, bucket, mode: str = "") -> None:
    """The device's idle share of a warm served stream (``SOLVES``
    unprofiled runs, then one traced); ``mode`` prefixes its name."""
    stream = lambda: serve_stream(torch, ops, seg, plans, bucket, SERVE_TICK, SERVE_SLOTS)["wall_s"]  # noqa: E731
    walls = spread([stream() for _ in range(SOLVES)])
    prof = device_profile(torch, stream)
    emit({"phase": "profile", "what": f"warm {mode}served stream ({SERVE_REQUESTS} K=2 requests, "
                                      f"{SERVE_SLOTS} slots, tick_iters={SERVE_TICK})",
          "wall_s_unprofiled": walls, "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / walls["min"],
          **{k: prof[k] for k in ("device_ops", "kernels", "memsets", "memcpys", "device_busy_us", "top")}})


def run_serve(torch, api, synthetic, ops, em_mod, dev, profile: bool) -> dict:
    """The serve path: the ``serve_plans`` stream through
    ``SegmentationEngine(max_batch=SERVE_SLOTS)``, once with
    ``tick_iters=SERVE_TICK`` and cold admissions (launch counts reset just
    before, read just after: every fused_em_tick launch the pool entry's,
    one per micro-step, and the static contexts' segment_reduce at
    admission), then warm with ``SERVE_TICK`` and with ``"auto"``; every
    completion bit for bit its serial ``execute``, no workspace built after
    the pool's set-up.  Beside it the same slices through
    ``segment_stack(batch="always")`` and serially.  Then the pool entry
    held to its plain version (``check_pool_entry`` at ``POOL_CHECK_SIZES``
    slots), a mixed-K pool, a chaos stream, every launch of a small stream
    held to the plain pool on the CPU (``serve_cpu_check``), and the pool
    launch's times (``time_pool_step``); with ``profile``, the pool launch's
    device time and ``serve_profile``.  Last, the modes' serve path
    (``run_modes_serve``)."""
    seed = SLICE["seed"]
    vol, config, seg, plans, bucket, serial = serve_plans(api, synthetic, dev)
    out = {}
    # Cold: each admission pads its plan into the pool's bucket and builds
    # the lane's element arrays (one segment_reduce each), memoised on the
    # plan; the warm runs that follow admit with device copies alone.
    cold = serve_stream(torch, ops, seg, plans, bucket, SERVE_TICK, SERVE_SLOTS)
    if cold["launches"]["segment_reduce"] < 1:
        fail("serve: segment_reduce never launched (the lanes' static contexts)")
    out["cold"] = serve_row(f"K=2 tick_iters={SERVE_TICK}, cold admissions", cold, serial)
    fixed = serve_stream(torch, ops, seg, plans, bucket, SERVE_TICK, SERVE_SLOTS)
    out["fixed"] = serve_row(f"K=2 tick_iters={SERVE_TICK}", fixed, serial)
    auto = serve_stream(torch, ops, seg, plans, bucket, "auto", SERVE_SLOTS)
    out["auto"] = serve_row("K=2 tick_iters=auto", auto, serial)
    planning_tick_prior(f"K=2 tick_iters={SERVE_TICK}", fixed)
    planning_tick_prior("K=2 tick_iters=auto", auto)
    stack, stack_mean = seg.segment_stack(vol.images, seed=seed, batch="always")
    if [result_bits(r) for r in stack] != [result_bits(r) for r in serial]:
        fail("serve: segment_stack's lanes are not bit for bit the serial results")
    emit({"phase": "serve_compare", "requests": SERVE_REQUESTS,
          "engine_wall_s": {"cold": cold["wall_s"], "fixed": fixed["wall_s"], "auto": auto["wall_s"]},
          "segment_stack_solve_s": stack_mean * SERVE_REQUESTS,
          "serial_execute_solve_s": float(sum(r.optimize_seconds for r in serial)),
          "map_iters": [r.map_iters for r in serial], "em_iters": [r.em_iters for r in serial]})
    out["check"] = {b: check_pool_entry(torch, ops, em_mod, seg, plans, bucket, b)
                    for b in POOL_CHECK_SIZES}

    serve_mixed_k(torch, api, synthetic, ops, em_mod, dev, config, plans, serial)
    serve_chaos(torch, ops, em_mod, seg, plans, bucket, serial)
    serve_cpu_check(torch, ops, em_mod, seg, plans, bucket, serial)
    out["timing"] = time_pool_step(torch, ops, em_mod, seg, plans, bucket, SERVE_SLOTS, profile)
    if profile:
        serve_profile(torch, ops, seg, plans, bucket)
    out["modes"] = run_modes_serve(torch, api, synthetic, ops, em_mod, dev, config, plans, bucket,
                                   profile)
    return out


def check_table(planning) -> dict:
    """Planning (a): the checked-in table is the card's: ``meta.platform``
    ``"gpu"``, ``model_for(device="cuda")`` calibrated, and the refit from
    its stored observations gives its bytes."""
    from repro_torch.planning import calibrate

    path = planning.default_table_path()
    table = planning.load_table()
    meta = table["meta"]
    if meta.get("platform") != "gpu":
        fail(f"planning: the checked-in table's platform is {meta.get('platform')!r}, not 'gpu'")
    planning.reset_models()
    model = planning.model_for(device="cuda")
    if not model.calibrated:
        fail("planning: model_for(device='cuda') is not calibrated")
    if calibrate.refit(path) != path.read_text():
        fail("planning: the table's refit from its stored observations differs from its bytes")
    card = calibrate.card_meta("cuda")
    emit({"phase": "planning", "part": "table", "table_card": meta.get("nvidia_smi"),
          "table_torch": meta.get("torch"), "running_card": card["nvidia_smi"],
          "observations": len(table["observations"]), "shard_counts": meta["grid"]["shard_counts"],
          "priors": table["priors"], "width": table["width"], "sharding": table["sharding"],
          "refit_identical": True, "calibrated": True})
    return table


def planning_modes(torch, api, sl) -> dict:
    """Planning (b): the K = 2 slice planned and solved in each mode;
    ``Plan.predicted_optimize_s`` beside the measured warm ``optimize_s``
    (best and median of ``PLAN_REPEATS``).  The model must rank the modes
    as the measurements do: every pair the measurements separate (each
    solve of one faster than every solve of the other) in that order.  A
    pair whose measured ranges overlap is not ranked by the measurements
    (``static`` and ``faithful`` lie within 15-30 % of each other at this
    size), so it constrains nothing."""
    rows = {}
    for mode in ("static-pallas", "static", "faithful"):
        seg = api.Segmenter(sl["config"].with_(mode=mode), device=torch.device(DEVICE))
        plan = seg.plan(sl["image"])
        seg.execute(plan, seed=SLICE["seed"])
        times = spread([seg.execute(plan, seed=SLICE["seed"]).optimize_seconds
                        for _ in range(PLAN_REPEATS)])
        rows[mode] = {"predicted_optimize_s": plan.predicted_optimize_s, "optimize_s": times}
    predicted = sorted(rows, key=lambda m: rows[m]["predicted_optimize_s"])
    measured = sorted(rows, key=lambda m: rows[m]["optimize_s"]["min"])
    separated = [(a, b) for a in rows for b in rows
                 if rows[a]["optimize_s"]["max"] < rows[b]["optimize_s"]["min"]]
    wrong = [(a, b) for a, b in separated
             if not rows[a]["predicted_optimize_s"] < rows[b]["predicted_optimize_s"]]
    emit({"phase": "planning", "part": "modes", "K": 2, "bucket": list(plan.bucket), **rows,
          "predicted_order": predicted, "measured_order": measured,
          "measured_separated": [list(pair) for pair in separated],
          "ranked_as_measured": not wrong})
    if wrong:
        fail(f"planning: the measurements put {wrong} in that order (faster first), the model "
             f"does not: predicted order {predicted}")
    return rows


def planning_stack(torch, api, ops, st) -> dict:
    """Planning (c): the stack phase's 16 K = 2 slices through
    ``segment_stack(batch="auto")`` on a fresh session: the route the
    launch counts show is ``choose_batch``'s, every slice bit for bit
    ``"always"`` and ``"never"``, and the chosen route's measured mean
    ``optimize_s`` per slice (best of ``PLAN_REPEATS`` stack solves) at
    most ``PLAN_ROUTE_TOLERANCE`` above the other route's."""
    from repro_torch.kernels import em_tick

    seed = SLICE["seed"]
    seg = api.Segmenter(st["seg"].config, device=torch.device(DEVICE))
    plans = [seg.plan(img) for img in st["images"]]
    decision = seg.choose_batch(plans)
    ops.reset_launch_counts()
    auto, _ = seg.segment_stack(st["images"], seed=seed, batch="auto")
    ticks, batched = ops.launch_counts()["fused_em_tick"], em_tick.launches_batched
    took_batch = batched > 0
    if ticks < 1 or (took_batch and batched != ticks):
        fail(f"planning: segment_stack(batch='auto') made {ticks} tick launches, {batched} batched")
    if took_batch != decision.use_batch:
        fail(f"planning: choose_batch says use_batch={decision.use_batch}, the launches show "
             f"{'batched' if took_batch else 'serial'}")
    for other in ("always", "never"):
        res, _ = seg.segment_stack(st["images"], seed=seed, batch=other)
        if [result_bits(r) for r in res] != [result_bits(r) for r in auto]:
            fail(f"planning: segment_stack(batch='auto') is not bit for bit batch='{other}'")

    def drain():
        for p in plans:
            seg.submit(p, seed=seed, bucket=st["joint"])
        return float(np.mean([r.optimize_seconds for r in seg.drain()]))

    measured = {"batched": spread([drain() for _ in range(PLAN_REPEATS)]),
                "serial": spread([float(np.mean([seg.execute(p, seed=seed).optimize_seconds
                                                 for p in plans])) for _ in range(PLAN_REPEATS)])}
    chosen, other = ("batched", "serial") if decision.use_batch else ("serial", "batched")
    ratio = measured[chosen]["min"] / measured[other]["min"]
    emit({"phase": "planning", "part": "stack", "K": 2, "slices": len(plans),
          "decision": decision.as_dict(), "took": chosen, "tick_launches": ticks,
          "batched_launches": batched, "bitwise_always_never": True,
          "optimize_s_per_slice": measured, "chosen_over_other": ratio})
    if ratio > 1.0 + PLAN_ROUTE_TOLERANCE:
        fail(f"planning: the chosen route ({chosen}) is {ratio:.3f}x the other's per slice")
    return {"decision": decision, "measured": measured}


def planning_shards_auto() -> dict:
    """Planning (e): ``launch.segment --shards auto --slices 1`` in a
    subprocess on the card: a ``shards_auto`` line, then a solve on the
    count it chose (1 on a one-card host)."""
    import torch

    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.segment", "--shards", "auto",
                           "--slices", "1"], capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=600)
    if proc.returncode != 0:
        fail(f"planning: launch.segment --shards auto exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    auto = [ln["shards_auto"] for ln in lines if "shards_auto" in ln]
    rows = [ln for ln in lines if "slice" in ln]
    if len(auto) != 1 or len(rows) != 1:
        fail(f"planning: launch.segment --shards auto printed {len(auto)} decisions, {len(rows)} slices")
    want = 1 if torch.cuda.device_count() == 1 else auto[0]["shards"]
    if auto[0]["shards"] != want or rows[0]["shards"] != want or rows[0]["status"] not in (
            "converged", "max_iters"):
        fail(f"planning: --shards auto chose {auto[0]['shards']}, solved on {rows[0]['shards']} "
             f"({rows[0]['status']})")
    emit({"phase": "planning", "part": "shards_auto", "decision": auto[0],
          **{k: rows[0][k] for k in ("shards", "status", "em_iters", "map_iters", "accuracy",
                                     "optimize_s")}})
    return auto[0]


def planning_ledger(torch, api, sl) -> dict:
    """Planning (f): the budget ledger around the session's and the engine's
    calls: a cold compile builds at most one workspace, a warm execute and a
    warm engine tick none; the snapshot printed."""
    from repro_torch.analysis import budget
    from repro_torch.serving import SegmentationEngine

    seed, plan = SLICE["seed"], sl["plan"]
    seg = api.Segmenter(sl["config"], device=torch.device(DEVICE))
    with budget.expect("cold_compile"):
        seg.compile(plan)
    seg.execute(plan, seed=seed)
    with budget.expect("warm_execute"):
        seg.execute(plan, seed=seed)
    engine = SegmentationEngine(seg, max_batch=2, tick_iters=4)
    for rid in range(3):
        engine.submit(plan, rid=rid, seed=seed)
    engine.step()   # the pool's bring-up
    with budget.expect("warm_tick"):
        engine.step()
    engine.run()
    snap = budget.LEDGER.snapshot()
    emit({"phase": "planning", "part": "ledger", "snapshot": snap,
          "budgets": {b.phase: b.max_delta for b in budget.BUDGETS}, "within_budgets": True})
    return snap


def run_planning(torch, api, ops, sl, st) -> dict:
    """The planning phase, (a)-(c), (e), (f) (``check_table``,
    ``planning_modes``, ``planning_stack``, ``planning_shards_auto``,
    ``planning_ledger``); (d) is in the serve phase."""
    from repro_torch import planning

    out = {"table": check_table(planning)}
    out["modes"] = planning_modes(torch, api, sl)
    out["stack"] = planning_stack(torch, api, ops, st)
    out["shards_auto"] = planning_shards_auto()
    out["ledger"] = planning_ledger(torch, api, sl)
    return out


def planning_tick_prior(what: str, run: dict) -> None:
    """Planning (d): the engine's tick-cost prior (the model's
    ``tick_cost_prior`` for its pool, calibrated) beside its fitted
    ``(a, b)`` after the stream."""
    engine = run["engine"]
    cfg = engine.session.config
    model = engine.session.cost_model()
    want = model.tick_cost_prior(mode=cfg.mode, bucket=engine.bucket, width=engine.max_batch,
                                 n_labels=cfg.n_labels, precision=cfg.precision)
    prior = engine._tick_cost_default()
    if prior != want or not model.calibrated:
        fail(f"planning: the engine's tick-cost prior {prior} is not the calibrated model's {want}")
    st = engine.stats()
    emit({"phase": "planning", "part": "tick_cost", "what": what, "prior": list(prior),
          "fitted": list(engine.cost_model()), "ticks": st["ticks"],
          "micro_steps": st["total_steps"], "wall_s": run["wall_s"]})


def map_step_operands(torch, plan, E, em_mod, hoods):
    """The ``fused_map_step`` call of the first MAP iteration of a sharded
    solve of ``plan`` on ``hoods`` (the plan's or a partition of them):
    ``cnt_e`` counts the quantile-init labels in each hood."""
    prob = plan.problem
    sctx = E.make_static_context(hoods, prob.model, backend="torch")
    labels, mu, sigma = em_mod.quantile_init(prob.graph.region_mean, prob.graph.n_regions, prob.model.n_labels)
    return E.map_step_operands(hoods, prob.model, sctx, labels, mu, sigma, backend="torch")


def compare_map_step(torch, k, p, what: str) -> float:
    """Hold a kernel MAP step ``k`` against the plain one ``p``; returns the
    largest absolute error over the four outputs."""
    names = ("min_e", "arg", "hood_e", "votes")
    err = max((a.float() - b.float()).abs().max().item() if a.numel() else 0.0 for a, b in zip(k, p))
    for name, a, b in zip(names, k, p):
        if name == "hood_e":
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
                fail(f"{what}: hood_e differs beyond rtol 1e-5 (err {err})")
        elif not torch.equal(a, b):
            fail(f"{what}: {name} differs")
    return err


def check_map_step(torch, ops, D, E, em_mod, plan, n_labels: int):
    """fused_map_step at the slice's operands against its plain version,
    then on each element block of a four-way partition: the blocks' votes
    must add up to the whole problem's exactly.  Returns ``(err, args,
    kw)``."""
    hoods = plan.problem.hoods
    args, kw = map_step_operands(torch, plan, E, em_mod, hoods)
    k = ops.fused_map_step(*args, **kw)
    p = ops.fused_map_step(*args, **kw, backend="torch")
    torch.cuda.synchronize()
    err = compare_map_step(torch, k, p, f"fused_map_step K={n_labels}")

    parts = D.partition_hoods(hoods, 4)
    (y, w, cnt, nall, xf, valid, hid, vtx, mu, sig, beta), pkw = map_step_operands(torch, plan, E, em_mod, parts)
    block = parts.capacity // 4
    votes = torch.zeros_like(k[3])
    hood_e = torch.zeros_like(k[2])
    for s in range(4):
        sl = slice(s * block, (s + 1) * block)
        kb = ops.fused_map_step(y[sl], w[sl], cnt[:, sl].contiguous(), nall[sl], xf[sl], valid[sl],
                                hid[sl], vtx[sl], mu, sig, beta, **pkw)
        pb = ops.fused_map_step(y[sl], w[sl], cnt[:, sl].contiguous(), nall[sl], xf[sl], valid[sl],
                                hid[sl], vtx[sl], mu, sig, beta, **pkw, backend="torch")
        err = max(err, compare_map_step(torch, kb, pb, f"fused_map_step K={n_labels} block {s}"))
        votes += kb[3]
        hood_e += kb[2]
    torch.cuda.synchronize()
    if not torch.equal(votes, k[3]):
        fail(f"fused_map_step K={n_labels}: the four blocks' votes do not add up to the whole")
    if not torch.allclose(hood_e, k[2], rtol=1e-5, atol=1e-4):
        fail(f"fused_map_step K={n_labels}: the four blocks' hood sums differ from the whole")
    # The route's plurality vote takes the first maximum; check it on these votes.
    best, first = k[3][0].clone(), torch.zeros(k[3].shape[1], dtype=torch.int64, device=k[3].device)
    for l in range(1, n_labels):
        take = k[3][l] > best
        best = torch.where(take, k[3][l], best)
        first = torch.where(take, l, first)
    if not torch.equal(torch.argmax(k[3], dim=0), first):
        fail(f"fused_map_step K={n_labels}: argmax over the votes does not take the first maximum")
    top2 = k[3].topk(2, dim=0).values
    tied = int(((top2[0] == top2[1]) & (top2[0] > 0)).sum().item())
    emit({"phase": "fused_map_step_check", "operands": "512x512 slice, quantile-init counts",
          "K": n_labels, "ok": True, "max_abs_err": err, "blocks": 4, "block": block,
          "votes_cast": int(k[3].sum().item()), "tied_vertices": tied})
    return err, args, kw


def check_map_step_long_hoods(torch, ops, dev) -> float:
    """fused_map_step on hoods of 100 and 300 elements, each spanning 4 to
    11 warps (``tick_problems.long_hood_map_step_problem``), K = 2 and 3:
    20 calls give bitwise equal hood sums, equal bit for bit to the numpy
    model of the order-free sum over the kernel's ``min_e * valid``; against
    the plain version the tiers of ``compare_map_step``.  Returns the
    largest error against the plain version."""
    from repro_torch.testing import segsum
    from repro_torch.testing.tick_problems import long_hood_map_step_problem

    worst, rows = 0.0, []
    for n_labels in (2, 3):
        arrays, kw = long_hood_map_step_problem(n_labels, n_labels)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        k = ops.fused_map_step(*args, 0.75, **kw)
        p = ops.fused_map_step(*args, 0.75, **kw, backend="torch")
        torch.cuda.synchronize()
        worst = max(worst, compare_map_step(torch, k, p, f"fused_map_step long hoods K={n_labels}"))
        first = bits(k[2])
        repeats_equal = all(np.array_equal(bits(ops.fused_map_step(*args, 0.75, **kw)[2]), first)
                            for _ in range(REPEATS - 1))
        valid, hood_id = arrays[5], arrays[6]
        part = k[0].cpu().numpy() * valid
        keys = np.where(valid > 0, hood_id, -1).astype(np.int32)
        model_equal = np.array_equal(segsum.segment_sum(part, keys, kw["n_hoods"]).view(np.uint32), first)
        row = {"K": n_labels, "hood_sizes": [100, 300], "elements": len(valid), "repeats": REPEATS,
               "hood_e_repeats_bitwise_equal": repeats_equal, "hood_e_model_bitwise_equal": model_equal}
        rows.append(row)
        if not (repeats_equal and model_equal):
            fail(f"fused_map_step long hoods: hood_e not order-fixed or not the model's: {row}")
    emit({"phase": "fused_map_step_long_hood_check", "ok": True, "max_abs_err": worst, "cases": rows})
    return worst


def mrf_cases(torch, margs) -> list:
    """``(name, elements)`` cases of mrf_min_energy from the K = 2 slice's
    operands (y, w, n1, nall, xf): the slice itself; n = 1, whose device
    time is the floor of one launch; n = 3 and 4,097 (ragged); every input
    a view with storage offset 1 (a scalar head aligns them); views at
    different offsets (the scalar loop throughout); and the hood elements
    of the paper's 512^3 volume, 512 copies of the slice's, where the
    bytes bound the kernel."""
    elems = margs[:5]
    y, w, n1, nall, xf = elems
    return [
        ("slice", elems),
        ("n=1", [t[:1] for t in elems]),
        ("n=3", [t[:3] for t in elems]),
        ("n=4097", [t[:4097] for t in elems]),
        ("offset 1", [t[1:] for t in elems]),
        ("mixed offsets", [y[1:], w[:-1], n1[1:], nall[:-1], xf[1:]]),
        ("volume", [t.repeat(MRF_VOLUME_SLICES) for t in elems]),
    ]


def check_time_mrf_energy(torch, ops, margs) -> dict:
    """mrf_min_energy against its plain version bit for bit at every case
    of ``mrf_cases``, with ``beta`` a Python float (passed by value) and a
    CUDA tensor (read by the kernel); 20 calls with a float ``beta`` issue
    20 kernels and no copy or memset.  Timed at the slice, n = 1 and the
    volume: ms per call (CUDA events, float ``beta``; at the slice also a
    tensor ``beta``, as older checkouts time it), device us per call
    (profiler, 20 calls), the plain version's ms, the bound and the share
    of it.  Returns the slice's figures for the ``kernels`` line, the
    others under ``by_shape``."""
    mu, sig, beta_t = margs[5:]
    beta = float(beta_t)
    worst, rows, timed = 0.0, [], {}
    for name, elems in mrf_cases(torch, margs):
        n = int(elems[0].shape[0])
        p = ops.mrf_min_energy(*elems, mu, sig, beta, backend="torch")
        for form, b in (("float", beta), ("tensor", beta_t)):
            k = ops.mrf_min_energy(*elems, mu, sig, b)
            torch.cuda.synchronize()
            if not (same_bits(torch, k[0], p[0]) and torch.equal(k[1], p[1])):
                fail(f"mrf_min_energy {name} (beta a {form}): not bit for bit the plain version's")
            worst = max(worst, (k[0] - p[0]).abs().max().item())
        rows.append({"case": name, "n": n, "offsets": [t.storage_offset() for t in elems],
                     "label1_share": k[1].float().mean().item()})
        if name not in ("slice", "n=1", "volume"):
            continue
        kern = lambda: ops.mrf_min_energy(*elems, mu, sig, beta)
        # The profiler may drop a record: an attempt that sees fewer than
        # 20 kernels and nothing else is made again (PROFILE_ATTEMPTS).
        for _ in range(PROFILE_ATTEMPTS):
            prof = device_profile(torch, lambda: [kern() for _ in range(20)])
            if prof["kernels"] > 20 or prof["memcpys"] or prof["memsets"]:
                fail(f"mrf_min_energy {name}: 20 calls with a float beta issued {prof['kernels']} "
                     f"kernels, {prof['memcpys']} copies and {prof['memsets']} memsets")
            if prof["kernels"] == 20:
                break
        else:
            fail(f"mrf_min_energy {name}: no profile of 20 calls saw 20 kernels")
        n_bytes = n * 5 * 4 + 2 * 2 * 4 + 4 + n * 8   # y w n1 nall xf, mu sigma, beta; min_e arg
        bound_ms, by = bound(n_bytes, n * 32)
        t = {"n": n, "ms": time_ms(kern), "device_ms": prof["device_busy_us"] / 20 * 1e-3,
             "plain_ms": time_ms(lambda: ops.mrf_min_energy(*elems, mu, sig, beta, backend="torch")),
             "bound_ms": bound_ms, "bound_by": by, "bytes": n_bytes, "memcpys_per_20_calls": 0}
        t["share_of_bound"] = bound_ms / t["ms"]
        t["device_share_of_bound"] = bound_ms / t["device_ms"]
        if name == "slice":
            t["ms_tensor_beta"] = time_ms(lambda: ops.mrf_min_energy(*elems, mu, sig, beta_t))
        timed[name] = t
        emit({"phase": "timing", "what": f"mrf_min_energy {name}", **t})
    emit({"phase": "mrf_min_energy_check", "ok": True, "max_abs_err": worst, "cases": rows})
    vol = timed["volume"]
    if vol["device_share_of_bound"] < 0.5:
        fail(f"mrf_min_energy at volume scale: {vol['device_ms'] * 1e3:.1f} us on the device, "
             f"under half of its bound ({vol['bound_ms'] * 1e3:.1f} us)")
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "device_share_of_bound")
    return {**{k: timed["slice"][k] for k in keys}, "max_abs_err": worst,
            "launch_floor_device_ms": timed["n=1"]["device_ms"],
            "by_shape": {str(t["n"]): {k: t[k] for k in keys} for t in timed.values()}}


class CollectiveCount:
    """While active, counts ``torch.distributed.all_reduce`` calls (every
    collective of the sharded route is one) and, among them, the sharded
    driver's all-reduces of a step's buffer (``ReduceCtx.psum``) and ANDs of
    the flag word (``ReduceCtx.and_flags``)."""

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.core.pmrf import collectives

        self.n = {"all_reduce": 0, "psum": 0, "and_flags": 0}
        self._saved = [(dist, "all_reduce", dist.all_reduce)]
        self._saved += [(collectives.ReduceCtx, m, getattr(collectives.ReduceCtx, m))
                        for m in ("psum", "and_flags")]
        for owner, name, fn in self._saved:
            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)
            setattr(owner, name, counted)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


# ---------------------------------------------------------------------------
# The modes static and faithful: the paper's primitive sequence
# ---------------------------------------------------------------------------


def modes_expected_launches(mode: str, res) -> dict:
    """``segment_reduce``'s launches in one solve of mode ``static`` or
    ``faithful``, by variant: per MAP iteration the label counts and the
    hood sizes (order-free ``add``), the hood sums (ordered ``add``) and,
    in ``faithful``, the per-element minimum (``min``); per EM iteration
    the M-step's three sums (ordered ``add``)."""
    return {"add": 2 * res.map_iters, "ordered_add": res.map_iters + 3 * res.em_iters,
            "min": res.map_iters if mode == "faithful" else 0}


class DppLockstep:
    """While active, every MAP iteration of a solve in mode ``static`` or
    ``faithful`` (``em.map_step``) and every M-step's sums
    (``energy.m_step_sums``) run again on the CPU from the card's state, and
    the card is held to them bit for bit: each MAP iteration's labels, hood
    sums and flag word (the window test on a ring of its hood sums, gated
    past the window, and finiteness), each M-step's three per-label sums.
    The CPU step takes the card's ``log`` of each sigma (``log_unequal``
    counts the launches where the host's differs) and runs under the local
    context: over one rank an all-reduce is the identity."""

    def __init__(self, torch, em_mod, E, max_map_iters: int):
        self.torch, self.em, self.E = torch, em_mod, E
        self.max_map_iters = max_map_iters
        self.launches = self.equal_launches = self.m_steps = self.log_unequal = 0
        self._copies = {}
        self._i = 0

    def __enter__(self):
        self._map_step, self._sums = self.em.map_step, self.E.m_step_sums
        self.em.map_step, self.E.m_step_sums = self.map_step, self.m_step_sums
        return self

    def __exit__(self, *exc):
        self.em.map_step, self.E.m_step_sums = self._map_step, self._sums
        return False

    def _cpu(self, obj):
        """``obj`` (a ``Hoods`` or an ``EnergyModel``) copied to the CPU once."""
        import dataclasses

        torch = self.torch
        if id(obj) not in self._copies:
            if dataclasses.is_dataclass(obj):
                copy = dataclasses.replace(obj, **{
                    f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
                    if isinstance(getattr(obj, f.name), torch.Tensor)})
            else:
                copy = type(obj)(*(t.cpu() for t in obj))
            self._copies[id(obj)] = (obj, copy)  # the original kept alive: its id stays its own
        return self._copies[id(obj)][1]

    def _flag(self, ring, hood_e) -> int:
        torch, em = self.torch, self.em
        conv = self._i > em.WINDOW and bool(torch.all(em._window_converged(ring)))
        div = not bool(torch.all(torch.isfinite(hood_e)))
        return int(conv) * em.kops.FLAG_CONVERGED | int(div) * em.kops.FLAG_DIVERGED

    def map_step(self, hoods, model, mode, labels, mu, sigma, *, backend=None, ctx=None,
                 log_sigma=None):
        torch = self.torch
        kw = {} if ctx is None else {"ctx": ctx}
        new, hood_e = self._map_step(hoods, model, mode, labels, mu, sigma, backend=backend, **kw)
        n_labels = int(mu.shape[0])
        sig = torch.maximum(sigma, model.sigma_min)
        log_card = torch.stack([torch.log(sig[l]) for l in range(n_labels)]).cpu()
        sig_host = sig.cpu()
        self.log_unequal += not torch.equal(
            log_card, torch.stack([torch.log(sig_host[l]) for l in range(n_labels)]))
        new_c, hood_c = self._map_step(self._cpu(hoods), self._cpu(model), mode, labels.cpu(),
                                       mu.cpu(), sigma.cpu(), log_sigma=log_card)
        if self._i == 0:
            rows = (self.em.WINDOW + 1, int(hood_e.shape[0]))
            self._ring = torch.zeros(rows, dtype=torch.float32, device=hood_e.device)
            self._ring_c = torch.zeros(rows, dtype=torch.float32)
        self._i += 1
        self._ring = torch.cat([hood_e[None], self._ring[:-1]])
        self._ring_c = torch.cat([hood_c[None], self._ring_c[:-1]])
        flag, flag_c = self._flag(self._ring, hood_e), self._flag(self._ring_c, hood_c)
        self.launches += 1
        what = f"{mode} MAP iteration K={n_labels} number {self.launches}"
        self.equal_launches += not cpu_step_unequal(
            torch, [("flag", flag, flag_c), ("labels", new, new_c), ("hood_e", hood_e, hood_c)], what)
        if flag or self._i == self.max_map_iters:
            self._i = 0
        return new, hood_e

    def m_step_sums(self, model, labels, mode, *, backend=None):
        sums = self._sums(model, labels, mode, backend=backend)
        sums_c = self._sums(self._cpu(model), labels.cpu(), mode)
        self.m_steps += 1
        self._i = 0
        cpu_step_unequal(self.torch, list(zip(("sum_w", "sum_wy", "sum_wyy"), sums, sums_c)),
                         f"{mode} M-step {self.m_steps}")
        return sums


def run_modes(torch, api, ops, em_mod, E, slices, profile: bool) -> dict:
    """The modes phase: each slice's plan (K = 2, 3, 9; the slice phase's)
    through ``Segmenter(ExecutionConfig(mode=m))`` for m in ``MODES``, with
    the launch counts reset just before and read just after each execute:
    no ``fused_em_tick`` and no ``fused_map_step`` launch, ``segment_reduce``
    launches as ``modes_expected_launches`` says.  Every solve gives the
    status, iteration counts, labels, mu and sigma of the plain path on the
    CPU bit for bit; at ``MODES_LOCKSTEP_K`` every MAP iteration and
    M-step of a whole solve is held to the CPU on a ``DppLockstep`` (at
    K = 9 the whole-solve comparison alone keeps the script inside its time
    limit: its CPU lockstep would sort 9 x 50,485 lanes per iteration); the
    two modes give equal labels and iteration counts.  Printed per solve:
    launches by variant, warm ``optimize_s`` (best and median of
    ``SOLVES``), and with ``profile`` the device operations and idle share
    of one warm solve; once, one profiled faithful K = 2 solve's
    ``DppProfile`` totals per primitive (the paper's section 4.3.2)."""
    from repro_torch.core import dpp

    seed = SLICE["seed"]
    out = {}
    for sl in slices:
        k, plan, config = sl["K"], sl["plan"], sl["config"]
        dev = plan.problem.hoods.vertex.device
        results = {}
        for mode in MODES:
            cfg = config.with_(mode=mode)
            seg = api.Segmenter(cfg, device=dev)
            ops.reset_launch_counts()
            res = seg.execute(plan, seed=seed)
            launches = ops.launch_counts()
            by_variant = ops.segment_reduce_launches()
            want = modes_expected_launches(mode, res)
            cpu = plain_solve_on_cpu(plan, cfg, seed)
            row = {"phase": "modes", "K": k, "mode": mode, "status": res.status,
                   "em_iters": res.em_iters, "map_iters": res.map_iters,
                   "accuracy": sl["accuracy_of"](res), "launches": launches,
                   "segment_reduce": by_variant, "segment_reduce_expected": want,
                   "cpu_plain": [cpu.status, cpu.em_iters, cpu.map_iters],
                   "bits_equal_cpu_plain": result_bits(res) == result_bits(cpu),
                   "equal_fused_route": result_bits(res) == result_bits(sl["result"])}
            if any(launches[n] for n in ("fused_em_tick", "fused_map_step", "mrf_min_energy",
                                         "flash_attention")):
                fail(f"K={k} {mode}: a fused kernel launched in the modes phase: {launches}")
            if by_variant != want or launches["segment_reduce"] != sum(want.values()):
                fail(f"K={k} {mode}: segment_reduce launches {by_variant}, the route implies {want}")
            if not row["bits_equal_cpu_plain"]:
                fail(f"K={k} {mode}: status, iterations, labels, mu or sigma "
                     f"{[res.status, res.em_iters, res.map_iters]} differ from the CPU plain path's "
                     f"{row['cpu_plain']}")
            if k in MODES_LOCKSTEP_K:
                with DppLockstep(torch, em_mod, E, cfg.max_map_iters) as ls:
                    got = em_mod.run_em(*seg.lane_inputs(plan, seed=seed), cfg.em_config())
                row.update(lockstep_launches=ls.launches, lockstep_equal_launches=ls.equal_launches,
                           lockstep_m_steps=ls.m_steps, launches_log_sigma_unequal_cpu=ls.log_unequal)
                trajectory = [em_mod.STATUS_NAMES[got.status], got.em_iters, got.map_iters]
                if (ls.launches, ls.m_steps) != (res.map_iters, res.em_iters) or trajectory != [
                        res.status, res.em_iters, res.map_iters] or not np.array_equal(
                        got.labels.cpu().numpy()[: plan.n_regions], res.region_labels):
                    fail(f"K={k} {mode}: the lockstep solve {trajectory} ({ls.launches} MAP "
                         f"iterations, {ls.m_steps} M-steps) is not the main path's")
            walls = spread([seg.execute(plan, seed=seed).optimize_seconds for _ in range(SOLVES)])
            row.update(optimize_s_best=walls["min"], optimize_s_median=walls["median"],
                       optimize_s_spread=walls)
            emit(row)
            row["result"] = res
            if profile:
                profile_solve(torch, f"K={k} {mode} solve (execute)",
                              lambda: seg.execute(plan, seed=seed))
            if k == 2 and mode == "faithful":
                with dpp.profiled() as prof:
                    seg.execute(plan, seed=seed)
                emit({"phase": "dpp_profile", "K": k, "mode": mode,
                      "seconds": prof.totals(), "calls": prof.counts()})
            results[mode] = res
            out[(k, mode)] = row
        s, f = results["static"], results["faithful"]
        if not (np.array_equal(s.region_labels, f.region_labels)
                and (s.em_iters, s.map_iters, s.status) == (f.em_iters, f.map_iters, f.status)):
            fail(f"K={k}: modes static and faithful give different labels or iteration counts")
    return out


# ---------------------------------------------------------------------------
# The modes' stacks and served requests: one flat DPP step over every lane
# ---------------------------------------------------------------------------


def modes_flat_expected(mode: str, steps: int, m_steps: int) -> dict:
    """``segment_reduce``'s launches over ``steps`` flat steps of a mode's
    DPP workspace (lockstep MAP iterations of a stack, micro-steps of a
    pool) and ``m_steps`` reads of its M-step sums: per step a serial MAP
    iteration's (two order-free ``add``, one ordered ``add``, in
    ``faithful`` one ``min``), whatever the lanes; per read three ordered
    ``add`` for every lane that stopped since the last one (one read per
    EM iteration of a stack, one per micro-step in which a pool lane
    stopped)."""
    return {"add": 2 * steps, "ordered_add": steps + 3 * m_steps,
            "min": steps if mode == "faithful" else 0}


class FlatLockstep:
    """A mode's ``DppBatchWorkspace`` on the card (``card``) run beside one
    on the CPU (``cpu``): before every step and every read of the M-step
    sums the CPU workspace takes the card's state (labels, ring, hood
    sums, active words, the lanes whose sums are pending and the sums
    taken so far), both run, and the card is held to the CPU bit for bit:
    each step's labels, ring, hood sums, flag and active words, each
    read's M-step sums.  The CPU step takes the card's ``log`` of each
    clamped sigma (``log_unequal`` counts the EM iterations where the
    host's differs in some bit)."""

    def __init__(self, torch, card, cpu):
        self.torch, self.card, self.cpu = torch, card, cpu
        self.steps = self.equal_steps = self.m_steps = self.log_unequal = 0

    def __getattr__(self, name):
        return getattr(self.card, name)

    def start(self, hoods, model, labels0):
        hoods_c, model_c, labels_c = inputs_on_cpu((hoods, model, labels0))
        self.card.start(hoods, model, labels0)
        self.cpu.start(hoods_c, model_c, labels_c)

    def begin_em(self, mu, sigma, active):
        torch = self.torch
        self.card.begin_em(mu, sigma, active)
        sig = torch.maximum(sigma, self.card._model.sigma_min[:, None])
        log_card = torch.log(sig).cpu()
        self.log_unequal += not torch.equal(log_card, torch.log(sig.cpu()))
        self.cpu.begin_em(mu.cpu(), sigma.cpu(), active, log_sigma=log_card)

    def _load(self):
        for name in ("labels", "ring", "hood_e", "active", "_stopped", "_stats"):
            setattr(self.cpu, name, getattr(self.card, name).cpu())
        self.cpu._stale = self.card._stale

    def step(self, gate, cap=False):
        self._load()
        self.card.step(gate, cap)
        self.cpu.step(gate, cap)
        self.steps += 1
        pairs = [(n, getattr(self.card, n), getattr(self.cpu, n))
                 for n in ("labels", "ring", "hood_e", "active", "_flags")]
        self.equal_steps += not cpu_step_unequal(self.torch, pairs, f"flat step {self.steps}")

    def flags(self):
        return self.card.flags()

    @property
    def stats(self):
        stale = self.card._stale
        self._load()
        card, cpu = self.card.stats, self.cpu.stats
        if stale:
            self.m_steps += 1
            cpu_step_unequal(self.torch, [("stats", card, cpu)], f"flat M-step {self.m_steps}")
        return card


def flat_lockstep_check(torch, api, em_mod, seg, plans, joint, mode: str, want: list) -> dict:
    """A ``FLAT_LOCKSTEP_LANES``-lane stack of the K = 2 plans on a
    ``FlatLockstep``: every step and every M-step of the whole solve bit
    for bit the CPU's from the card's state, and each lane its serial
    ``execute`` (``want``)."""
    from repro_torch.kernels.ref import TickShape

    n = FLAT_LOCKSTEP_LANES
    cfg = seg.config.em_config()
    inputs = seg.stacked_inputs(plans[:n], bucket=joint, seeds=[SLICE["seed"]] * n)
    shape = TickShape.of(inputs[0], inputs[1])
    ls = FlatLockstep(torch, em_mod.make_workspace(shape, cfg, device=inputs[0].vertex.device, batch=n),
                      em_mod.make_workspace(shape, cfg, device="cpu", batch=n))
    got = em_mod.run_em_batched(*inputs, cfg, workspace=ls)
    from repro_torch.core.pmrf import pipeline

    for b in range(n):
        r = pipeline.assemble_result(plans[b].problem, got.lane(b), 0.0, 0.0)
        if result_bits(r) != result_bits(want[b]):
            fail(f"{mode} flat lockstep lane {b}: not bit for bit its serial execute")
    if (ls.steps, ls.m_steps) != (got.steps, max(got.em_iters)):
        fail(f"{mode} flat lockstep: {ls.steps} steps and {ls.m_steps} M-steps for {got.steps} "
             f"lockstep MAP iterations and {max(got.em_iters)} EM iterations")
    return {"B": n, "steps": ls.steps, "equal_steps": ls.equal_steps, "m_steps": ls.m_steps,
            "em_iterations_log_sigma_unequal_cpu": ls.log_unequal}


def run_modes_stack(torch, api, ops, em_mod, stacks, profile: bool) -> dict:
    """The modes' stack path: each ``STACK`` stack's plans (the stack
    phase's 512x512 slices) in modes ``static`` and ``faithful``, first
    through ``Segmenter.segment_stack(batch="always")`` on the images, then
    warm through ``submit``/``drain``, launch counts reset just before and
    read just after.  Held: no ``fused_em_tick`` and no ``fused_map_step``
    launch; the workspace's flat steps are the stack's lockstep MAP
    iterations (its solve run again on the bucket's executable gives the
    count) and ``segment_reduce``'s launches by variant are
    ``modes_flat_expected``'s (per lockstep iteration a serial MAP
    iteration's, at B = 4 and 16 alike); one read of the M-step sums per EM
    iteration; every lane bit for bit its slice's serial ``execute`` in the
    same mode; the warm drain builds no workspace.  Printed besides: mean
    ``optimize_s`` per slice batched and serial (best and median of
    ``STACK_REPEATS``), and at K = 2 the ``flat_lockstep_check``; with
    ``profile`` the device operations and idle share of one warm stack
    solve."""
    seed = SLICE["seed"]
    out = {}
    for k, st in stacks.items():
        plans, joint, n = st["plans"], st["joint"], len(st["plans"])
        dev = plans[0].problem.hoods.vertex.device
        for mode in MODES:
            cfg = api.ExecutionConfig(mode=mode, n_labels=k, overseg_grid=(SLICE["grid"],) * 2,
                                      init="quantile")
            seg = api.Segmenter(cfg, device=dev)
            ops.reset_launch_counts()
            cold, _ = seg.segment_stack(st["images"], seed=seed, batch="always")
            cold_launches = ops.launch_counts()
            exe = seg.compile(joint, batch=n)

            def drain():
                for p in plans:
                    seg.submit(p, seed=seed, bucket=joint)
                return seg.drain()

            builds, m0 = ops.WORKSPACE_BUILDS, exe.workspace.m_steps
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            results = drain()
            launches, by_variant = ops.launch_counts(), ops.segment_reduce_launches()
            steps, m_steps = ops.LANE_STEPS, exe.workspace.m_steps - m0
            warm_builds = ops.WORKSPACE_BUILDS - builds
            again = exe(*seg.stacked_inputs(plans, bucket=joint, seeds=[seed] * n))
            want = modes_flat_expected(mode, steps, m_steps)
            what = f"modes stack K={k} {mode}"
            if any(cold_launches[f] or launches[f] for f in ("fused_em_tick", "fused_map_step")):
                fail(f"{what}: a fused kernel launched: {cold_launches}, {launches}")
            if steps != again.steps or m_steps != max(again.em_iters):
                fail(f"{what}: {steps} flat steps and {m_steps} M-steps for {again.steps} lockstep "
                     f"MAP iterations and {max(again.em_iters)} EM iterations")
            if by_variant != want or launches["segment_reduce"] != sum(want.values()):
                fail(f"{what}: segment_reduce launches {by_variant}, the flat steps imply {want}")
            if warm_builds:
                fail(f"{what}: the warm drain built {warm_builds} workspaces")
            serial_s, serial = [], None
            for _ in range(STACK_REPEATS):
                rs = [seg.execute(p, seed=seed) for p in plans]
                serial = serial or rs
                serial_s.append(float(np.mean([r.optimize_seconds for r in rs])))
            for i, r in enumerate(results):
                if result_bits(r) != result_bits(serial[i]) or result_bits(cold[i]) != result_bits(r):
                    fail(f"{what} lane {i}: not bit for bit its serial execute")
            batched_s = [float(np.mean([r.optimize_seconds for r in drain()]))
                         for _ in range(STACK_REPEATS)]
            row = {"phase": "modes_stack", "K": k, "mode": mode, "slices": n, "bucket": list(joint),
                   "lockstep_map_iterations": steps, "em_iterations": m_steps,
                   "em_iters": [r.em_iters for r in results],
                   "map_iters": [r.map_iters for r in results],
                   "statuses": sorted({r.status for r in results}), "launches": launches,
                   "segment_reduce": by_variant, "segment_reduce_expected": want,
                   "segment_reduce_per_lockstep_iteration": {
                       "add": by_variant["add"] / steps,
                       "ordered_add_hood_sums": (by_variant["ordered_add"] - 3 * m_steps) / steps,
                       "min": by_variant["min"] / steps, "ordered_add_per_em_iteration": 3},
                   "segment_reduce_per_solve": by_variant,
                   "serial_segment_reduce_per_lane_mean": {
                       v: float(np.mean([modes_expected_launches(mode, r)[v] for r in serial]))
                       for v in ("add", "ordered_add", "min")},
                   "lanes_bitwise_serial_execute": True, "warm_workspace_builds": warm_builds,
                   "optimize_s_per_slice": {"batched": spread(batched_s), "serial": spread(serial_s)}}
            if k == 2:
                row["flat_lockstep_check"] = flat_lockstep_check(torch, api, em_mod, seg, plans,
                                                                 joint, mode, serial)
            if profile:
                walls = spread([float(np.sum([r.optimize_seconds for r in drain()]))
                                for _ in range(SOLVES)])
                prof = device_profile(torch, drain)
                row["profile"] = {"stack_optimize_s_unprofiled": walls,
                                  "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / walls["min"],
                                  **{f: prof[f] for f in ("device_ops", "kernels", "memsets", "memcpys",
                                                          "device_busy_us")}}
            emit(row)
            out[(k, mode)] = row
    return out


def flat_segment_reduce_timing(torch, ops, api, em_mod, st, profile: bool) -> dict:
    """``segment_reduce`` at the flat step's calls of the B = 16 K = 2 stack
    in mode ``faithful`` (one step from the quantile init, recorded): the
    counts' order-free ``add`` (B x capacity values), the hood sums'
    ordered ``add`` and the per-element ``min`` (B x 2 x capacity values).
    Each call bit for bit its plain version on the CPU; timed beside its
    plain version on the card, one library call (``index_add_``,
    ``scatter_reduce_(..., "amin")``) and its bound; device time under
    ``profile``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr_mod
    from repro_torch.kernels.ref import TickShape

    plans, joint, n = st["plans"], st["joint"], len(st["plans"])
    cfg = api.ExecutionConfig(mode="faithful", n_labels=2, overseg_grid=(SLICE["grid"],) * 2,
                              init="quantile")
    seg = api.Segmenter(cfg, device=plans[0].problem.hoods.vertex.device)
    hoods, model, lab0, mu0, sig0 = seg.stacked_inputs(plans, bucket=joint, seeds=[SLICE["seed"]] * n)
    ws = em_mod.make_workspace(TickShape.of(hoods, model), cfg.em_config(), device=lab0.device, batch=n)
    ws.start(hoods, model, lab0)
    ws.begin_em(mu0, torch.maximum(sig0, model.sigma_min[:, None]), [True] * n)
    calls, launch = [], sr_mod.segment_reduce_cuda

    def record(values, ids, num, op="add", *, ordered=False):
        calls.append((op, ordered, values.clone(), ids.clone(), num))
        return launch(values, ids, num, op, ordered=ordered)

    sr_mod.segment_reduce_cuda = record
    try:
        ws.step(False)
    finally:
        sr_mod.segment_reduce_cuda = launch
    rows = {}
    for op, ordered, v, ids, num in calls:
        what = "min" if op == "min" else ("ordered_add" if ordered else "add")
        if what in rows and rows[what]["shape"][1] >= num:
            continue  # the counts' larger call stands for the order-free add
        got = ops.segment_reduce(v, ids, num, op, ordered=ordered).cpu()
        if not same_bits_or_nan(torch, got, ref.segment_reduce(v.cpu(), ids.cpu(), num, op)):
            fail(f"segment_reduce {what} at the flat step's call: not bit for bit the CPU's")
        ids_long = ids.long().clamp(0, num)
        if op == "min":
            lib_out = torch.full((num + 1,), float("inf"), device=v.device)
            lib = lambda: lib_out.fill_(float("inf")).scatter_reduce_(0, ids_long, v, "amin")  # noqa: E731
        else:
            lib_out = torch.zeros(num + 1, device=v.device)
            lib = lambda: lib_out.zero_().index_add_(0, ids_long, v)  # noqa: E731
        fn = lambda: ops.segment_reduce(v, ids, num, op, ordered=ordered)  # noqa: E731
        row = {"shape": [int(v.numel()), num], "ms": time_ms(fn),
               "plain_ms": time_ms(lambda: ops.segment_reduce(v, ids, num, op, backend="torch")),
               "library_ms": time_ms(lib),
               "library": "scatter_reduce_ amin" if op == "min" else "index_add_"}
        row["bound_ms"], row["bound_by"] = bound(v.numel() * 8 + num * 4, v.numel())
        if profile:
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            row["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
        rows[what] = row
    out = {"phase": "timing", "what": f"segment_reduce at the flat step's calls (B = {n}, K = 2, "
                                      "faithful)", "calls_per_step": len(calls), **rows}
    emit(out)
    return out


def run_oracle(torch, sl, modes: dict) -> dict:
    """The K = 2 slice's plan against the port's NumPy oracle
    (``reference.golden_em``, its float32 transcription of the static mode)
    from the same initial labels and parameters: the solve in each of the
    three modes must agree with it on ``ORACLE_AGREEMENT`` of the pixels
    and come within 0.01 of its accuracy; where labels, mu, sigma and the
    iteration counts are exactly equal is reported (the oracle takes its
    ``log`` in float64)."""
    import types

    from repro_torch.core.pmrf import pipeline, reference

    plan, config = sl["plan"], sl["config"]
    p = plan.problem
    init = pipeline.initial_params(p, SLICE["seed"], config.init)
    t0 = time.perf_counter()
    gold = reference.golden_em(p.hoods, p.model, *init, max_em_iters=config.max_em_iters,
                               max_map_iters=config.max_map_iters)
    gold_s = time.perf_counter() - t0
    labels = gold.labels[: p.graph.n_regions]
    gold_seg = labels[np.asarray(p.labels_px)]
    acc_gold = sl["accuracy_of"](types.SimpleNamespace(segmentation=gold_seg))
    row = {"phase": "oracle", "K": sl["K"], "oracle": "reference.golden_em", "oracle_s": gold_s,
           "oracle_iters": [gold.em_iters, gold.map_iters], "oracle_accuracy": acc_gold, "modes": {}}
    for mode, res in (("static-pallas", sl["result"]),
                      *((m, modes[(sl["K"], m)]["result"]) for m in MODES)):
        agree = float((res.segmentation == gold_seg).mean())
        acc = sl["accuracy_of"](res)
        row["modes"][mode] = {
            "pixel_agreement": agree, "accuracy": acc, "iters": [res.em_iters, res.map_iters],
            "labels_equal": bool(np.array_equal(res.region_labels, labels)),
            "counts_equal": (res.em_iters, res.map_iters) == (gold.em_iters, gold.map_iters),
            "mu_sigma_equal": bool(np.array_equal(res.mu, gold.mu) and np.array_equal(res.sigma, gold.sigma))}
        if agree < ORACLE_AGREEMENT or abs(acc - acc_gold) > 0.01:
            fail(f"oracle: mode {mode} agrees with golden_em on {agree:.4f} of the pixels, accuracy "
                 f"{acc} against {acc_gold}")
    emit(row)
    return row


def ordered_add_cases() -> list:
    """Ordered ``add`` cases at random shapes: ids in runs (the hood sums'
    layout) with zeros, ids in any order over few segments (the M-step's
    labels), and NaN, infinities and signed zeros."""
    rng = np.random.default_rng(2)
    cases = []
    for n, segs, runs in ((50_485, 1_579, True), (1_000_000, 100_000, True), (1_025, 9, False),
                          (1_025, 2, False)):
        ids = rng.integers(-1, segs + 1, n)
        ids = np.sort(ids) if runs else ids
        vals = rng.normal(0.0, 10.0, n).astype(np.float32)
        vals[rng.random(n) < 0.2] = 0.0
        vals[rng.random(n) < 0.05] = -0.0
        cases.append((f"random n={n} segs={segs} runs={runs}", vals, ids.astype(np.int32), segs))
    special = np.array([np.nan, 1.0, np.inf, -np.inf, -0.0, 0.0, 2.0, -0.0, 1e30, -1e30, 3.0],
                       np.float32)
    cases.append(("special values", special,
                  np.array([0, 0, 1, 1, 2, 2, 3, 4, 5, 5, 5], np.int32), 7))
    return cases


def check_ordered_add(torch, ops, api, plan, config, profile: bool) -> dict:
    """``segment_reduce``'s ordered ``add`` against its plain version on the
    CPU (``ref.keyed_sum``: element order), bit for bit (NaN equal to NaN,
    ``same_bits_or_nan``): at every ordered
    call of one faithful K = 2 solve (its hood sums and M-step sums, as the
    solve made them) and at ``ordered_add_cases``; the solve's ``min`` calls
    (the per-element minimum) the same way.  Timed at the solve's hood-sum
    call and its M-step call: ms per call (CUDA events), the plain version
    on the card (``index_add_``, by atomics), ``index_add_`` as the library
    call, the bound, and device us under ``profile``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr_mod

    dev = plan.problem.hoods.vertex.device
    calls = []
    launch = sr_mod.segment_reduce_cuda

    def record(values, ids, n, op="add", *, ordered=False):
        out = launch(values, ids, n, op, ordered=ordered)
        if ordered or op == "min":
            calls.append((op, values.clone(), ids.clone(), n, out.clone()))
        return out

    seg = api.Segmenter(config.with_(mode="faithful"), device=dev)
    sr_mod.segment_reduce_cuda = record
    try:
        seg.execute(plan, seed=SLICE["seed"])
    finally:
        sr_mod.segment_reduce_cuda = launch
    checked = {"ordered_add": 0, "min": 0}
    worst = 0.0

    def err(got, want) -> float:
        both = ~(got.isnan() | want.isnan())
        return float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0

    for op, v, ids, n, out in calls:
        want = ref.segment_reduce(v.cpu(), ids.cpu(), n, op)
        worst = max(worst, err(out.cpu(), want))
        if not same_bits_or_nan(torch, out.cpu(), want):
            fail(f"segment_reduce {op} at a faithful solve's call (n={v.numel()}, segments={n}): "
                 "not bit for bit the plain version on the CPU")
        checked["ordered_add" if op == "add" else "min"] += 1
    for what, vals, ids, n in ordered_add_cases():
        got = ops.segment_reduce(torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev), n,
                                 ordered=True).cpu()
        want = ref.keyed_sum(torch.from_numpy(vals), torch.from_numpy(ids), n)
        worst = max(worst, err(got, want))
        if not same_bits_or_nan(torch, got, want):
            fail(f"segment_reduce ordered add, {what}: not bit for bit the plain version on the CPU")
    adds = [c for c in calls if c[0] == "add"]
    hood_call = max(adds, key=lambda c: c[1].numel())
    m_call = next(c for c in adds if c[3] == plan.problem.model.n_labels)
    rows = {}
    for what, (_, v, ids, n, _) in (("hood_sums", hood_call), ("m_step", m_call)):
        ids_long = ids.long().clamp(0, n)
        lib_out = torch.zeros(n + 1, device=dev)
        fn = lambda: ops.segment_reduce(v, ids, n, ordered=True)
        row = {"shape": [int(v.numel()), n], "ms": time_ms(fn),
               "plain_ms": time_ms(lambda: ops.segment_reduce(v, ids, n, backend="torch")),
               "library_ms": time_ms(lambda: lib_out.zero_().index_add_(0, ids_long, v))}
        row["bound_ms"], row["bound_by"] = bound(v.numel() * 8 + n * 4, v.numel())
        if profile:
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            emit({"phase": "profile", "what": f"20 ordered segment_reduce calls ({what})", **prof})
            row["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
        rows[what] = row
    out = {"phase": "ordered_add_check", "ok": True, "solve_calls_checked": checked,
           "random_cases": len(ordered_add_cases()), "max_abs_err": worst, **rows}
    emit(out)
    return out


def run_modes_sharded(torch, D, ops, em_mod, E, pipeline, sl, single: dict) -> dict:
    """The modes on the sharded route over the one-rank group: for each
    mode, ``run_em_sharded`` on the plan's partition (launch counts and
    collectives reset just before, read just after; no fused kernel,
    ``segment_reduce`` as on one device), equal bit for bit to the
    single-device modes phase's solve of the same plan; then the same solve
    on a ``DppLockstep``, every MAP iteration and M-step held to the CPU."""
    plan, config = sl["plan"], sl["config"]
    prob = plan.problem
    seed = SLICE["seed"]
    labels0, mu0, sigma0 = pipeline.initial_params(prob, seed, config.init)
    parts = D.partition_hoods(prob.hoods, 1)
    out = {}
    for mode in MODES:
        cfg = config.with_(mode=mode)

        def solve():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=cfg.em_config())
            torch.cuda.synchronize()
            return pipeline.assemble_result(prob, res, plan.init_seconds, time.perf_counter() - t0)

        ops.reset_launch_counts()
        with CollectiveCount() as coll:
            res = solve()
        launches, by_variant = ops.launch_counts(), ops.segment_reduce_launches()
        want = modes_expected_launches(mode, res)
        with DppLockstep(torch, em_mod, E, cfg.max_map_iters) as ls:
            again = solve()
        row = {"phase": "modes_sharded", "K": sl["K"], "mode": mode, "ranks": 1,
               "status": res.status, "em_iters": res.em_iters, "map_iters": res.map_iters,
               "optimize_s": res.optimize_seconds, "launches": launches,
               "segment_reduce": by_variant, "allreduces": coll.n["all_reduce"],
               "bits_equal_single_device":
                   result_bits(res) == result_bits(single[(sl["K"], mode)]["result"]),
               "lockstep_launches": ls.launches, "lockstep_equal_launches": ls.equal_launches,
               "lockstep_m_steps": ls.m_steps, "launches_log_sigma_unequal_cpu": ls.log_unequal}
        emit(row)
        if launches["fused_em_tick"] or launches["fused_map_step"]:
            fail(f"sharded K={sl['K']} {mode}: a fused kernel launched: {launches}")
        if by_variant != want:
            fail(f"sharded K={sl['K']} {mode}: segment_reduce launches {by_variant}, the route "
                 f"implies {want}")
        if not row["bits_equal_single_device"] or result_bits(again) != result_bits(res):
            fail(f"sharded K={sl['K']} {mode}: not bit for bit the single-device solve")
        if (ls.launches, ls.m_steps) != (res.map_iters, res.em_iters):
            fail(f"sharded K={sl['K']} {mode}: the lockstep saw {ls.launches} MAP iterations and "
                 f"{ls.m_steps} M-steps")
        out[mode] = row
    return out


def run_fallback(torch, api, ops, sl, stack) -> dict:
    """The fallback phase on the K = 2 slice's plan.  Under a compile
    failure of the kernel route (``chaos.ChaosConfig(compile_fail_backends=
    ("cuda",))``) the default ``FallbackPolicy`` raises ``FallbackError``
    after its retry and builds and launches nothing, and
    ``FallbackPolicy(backend="torch")`` gives the plain route's solve with
    one event, a ``RuntimeWarning`` and a redirect (no kernel launched).
    One transient execute failure under the default policy gives the clean
    kernel-route solve bit for bit (static-pallas and faithful), and so
    does an engine tick replayed after one.  The modes' stacks
    (``FALLBACK_STACK_LANES`` lanes of the K = 2 stack, ``drain``): under a
    compile fault the default policy raises ``FallbackError`` with nothing
    launched and the requests queued again, ``FallbackPolicy(backend=
    "torch")`` gives the plain route's stack (one event, one warning, no
    kernel; each lane's status that of the plain session's stack and at
    least 99.5 % of its pixels), and a transient execute fault gives the
    clean kernel-route stack bit for bit."""
    import warnings

    from repro_torch.serving import SegmentationEngine
    from repro_torch.testing import chaos

    plan, config = sl["plan"], sl["config"]
    seed, dev = SLICE["seed"], plan.problem.hoods.vertex.device
    clean = {m: api.Segmenter(config.with_(mode=m), device=dev).execute(plan, seed=seed)
             for m in ("static-pallas", "faithful")}
    plain = api.Segmenter(config.with_(backend="torch"), device=dev).execute(plan, seed=seed)
    out = {"phase": "fallback"}

    seg = api.Segmenter(config, device=dev)
    ops.reset_launch_counts()
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))) as monkey:
        try:
            seg.execute(plan, seed=seed)
            fail("fallback: the default policy did not raise on a failing compile")
        except api.FallbackError as e:
            if not isinstance(e.__cause__, chaos.ChaosError):
                fail(f"fallback: FallbackError without the injected cause: {e!r}")
    if any(ops.launch_counts().values()) or seg.cache_keys or seg.fallback_events:
        fail("fallback: the default policy built or launched something after a failing compile")
    out["default_policy"] = {"raised": "FallbackError", "compile_attempts": len(monkey.events)}

    seg_t = api.Segmenter(config.with_(fallback=api.FallbackPolicy(backend="torch")), device=dev)
    ops.reset_launch_counts()
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = seg_t.execute(plan, seed=seed)
        again = seg_t.execute(plan, seed=seed)
    launches = ops.launch_counts()
    agree = float((res.segmentation == plain.segmentation).mean())
    out["torch_policy"] = {
        "events": seg_t.fallback_events, "warnings": sum(w.category is RuntimeWarning for w in caught),
        "keys": [k.backend for k in seg_t.cache_keys], "launches": launches,
        "iters": [res.em_iters, res.map_iters], "plain_iters": [plain.em_iters, plain.map_iters],
        "pixel_agreement_plain": agree, "bits_equal_plain": result_bits(res) == result_bits(plain)}
    if any(launches.values()):
        fail(f"fallback: the plain route launched kernels: {launches}")
    if len(seg_t.fallback_events) != 1 or out["torch_policy"]["warnings"] != 1 or \
            out["torch_policy"]["keys"] != ["torch"]:
        fail(f"fallback: backend='torch' gave {out['torch_policy']}")
    if (res.status, res.em_iters, res.map_iters) != (plain.status, plain.em_iters, plain.map_iters) \
            or agree < 0.995 or again.map_iters != res.map_iters:
        fail("fallback: the plain route's solve differs from the plain session's")

    transient = {}
    for mode in ("static-pallas", "faithful"):
        seg_d = api.Segmenter(config.with_(mode=mode), device=dev)
        seg_d.execute(plan, seed=seed)
        ops.reset_launch_counts()
        with chaos.inject(chaos.ChaosConfig(transient_exec_failures=1)) as monkey:
            res = seg_d.execute(plan, seed=seed)
        launches = ops.launch_counts()
        transient[mode] = {"events": [e["kind"] for e in monkey.events], "launches": launches,
                           "bits_equal_clean": result_bits(res) == result_bits(clean[mode])}
        if not transient[mode]["bits_equal_clean"] or seg_d.fallback_events:
            fail(f"fallback: a transient execute failure ({mode}) did not give the clean solve")
        if mode == "static-pallas" and launches["fused_em_tick"] != res.map_iters:
            fail(f"fallback: the retried solve launched {launches['fused_em_tick']} ticks for "
                 f"{res.map_iters} MAP iterations")
    out["transient_execute"] = transient

    engine = SegmentationEngine(api.Segmenter(config, device=dev), max_batch=2, tick_iters=4)
    with chaos.inject(chaos.ChaosConfig(transient_exec_failures=1)) as monkey:
        for rid in range(2):
            engine.submit(plan, rid=rid, seed=seed)
        comps = engine.run()
    equal = [result_bits(c.result) == result_bits(clean["static-pallas"]) for c in comps]
    out["engine_tick"] = {"events": [e["kind"] for e in monkey.events], "completions": len(comps),
                          "bits_equal_serial": equal, "tick_retries": engine.stats()["tick_retries"]}
    if len(comps) != 2 or not all(equal) or engine.stats()["tick_retries"] != 1:
        fail(f"fallback: the replayed engine tick gave {out['engine_tick']}")
    out["modes_stack"] = {m: fallback_mode_stack(torch, api, ops, stack, m) for m in MODES}
    emit(out)
    return out


def fallback_mode_stack(torch, api, ops, stack, mode: str) -> dict:
    """``run_fallback``'s cases for a mode's stack (its docstring)."""
    import warnings

    from repro_torch.testing import chaos

    plans, joint = stack["plans"][:FALLBACK_STACK_LANES], stack["joint"]
    dev = plans[0].problem.hoods.vertex.device
    config = api.ExecutionConfig(mode=mode, n_labels=2, overseg_grid=(SLICE["grid"],) * 2,
                                 init="quantile")

    def drain(seg):
        for p in plans:
            seg.submit(p, seed=SLICE["seed"], bucket=joint)
        return seg.drain()

    clean, plain = drain(api.Segmenter(config, device=dev)), drain(
        api.Segmenter(config.with_(backend="torch"), device=dev))
    out = {}
    seg = api.Segmenter(config, device=dev)
    ops.reset_launch_counts()
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))):
        try:
            drain(seg)
            fail(f"fallback {mode} stack: the default policy did not raise on a failing compile")
        except api.FallbackError as e:
            if not isinstance(e.__cause__, chaos.ChaosError):
                fail(f"fallback {mode} stack: FallbackError without the injected cause: {e!r}")
    if any(ops.launch_counts().values()) or ops.LANE_STEPS or seg.pending() != len(plans):
        fail(f"fallback {mode} stack: the default policy launched something or dropped a request")
    out["default_policy"] = {"raised": "FallbackError", "requeued": seg.pending()}

    seg_t = api.Segmenter(config.with_(fallback=api.FallbackPolicy(backend="torch")), device=dev)
    ops.reset_launch_counts()
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = drain(seg_t)
    launches = ops.launch_counts()
    agree = [float((g.segmentation == w.segmentation).mean()) for g, w in zip(got, plain)]
    out["torch_policy"] = {
        "events": len(seg_t.fallback_events), "warnings": sum(w.category is RuntimeWarning for w in caught),
        "keys": [(k.backend, k.batch) for k in seg_t.cache_keys], "launches": launches,
        "pixel_agreement_plain": agree,
        "iters_equal_plain": [(g.em_iters, g.map_iters) == (w.em_iters, w.map_iters)
                              for g, w in zip(got, plain)]}
    if any(launches.values()) or len(seg_t.fallback_events) != 1 or \
            out["torch_policy"]["warnings"] != 1 or out["torch_policy"]["keys"] != [("torch", len(plans))]:
        fail(f"fallback {mode} stack: backend='torch' gave {out['torch_policy']}")
    if min(agree) < 0.995 or [g.status for g in got] != [w.status for w in plain]:
        fail(f"fallback {mode} stack: the plain route's stack differs from the plain session's")

    seg_d = api.Segmenter(config, device=dev)
    drain(seg_d)
    with chaos.inject(chaos.ChaosConfig(transient_exec_failures=1)) as monkey:
        got = drain(seg_d)
    out["transient_execute"] = {"events": [e["kind"] for e in monkey.events],
                                "bits_equal_clean": [result_bits(g) for g in got] ==
                                [result_bits(c) for c in clean]}
    if not out["transient_execute"]["bits_equal_clean"] or seg_d.fallback_events:
        fail(f"fallback {mode} stack: a transient execute failure did not give the clean stack")
    return out


def run_sharded(torch, D, pipeline, ops, em_mod, sl) -> dict:
    """The sharded route on a slice's plan over the one-rank group, on the
    rank's workspace built beforehand (as the session builds it, outside
    the timed region): launch counts and collectives reset just before and
    read just after; then its plain path.  Both are held to the
    single-device result of the same plan.  Per MAP iteration the route
    makes one ``fused_map_step`` launch, one all-reduce and, past the
    window, the AND of the flag word, and per EM iteration one launch
    more (the one that stops the MAP loop, which also takes the M-step
    sums); its label counts and its M-step sums do not go through
    ``segment_reduce``, which
    runs once, for the neighbourhood sizes.  Its labels, iteration counts
    and status must equal the single-device route's (both sum in a fixed
    order); against its plain path on the card, which adds by atomics, the
    pixel and accuracy limits hold."""
    plan, config, single, accuracy = sl["plan"], sl["config"], sl["result"], sl["accuracy_of"]
    prob = plan.problem
    labels0, mu0, sigma0 = pipeline.initial_params(prob, SLICE["seed"], config.init)
    parts = D.partition_hoods(prob.hoods, 1)
    configs = {b: config.with_(backend=b).em_config() for b in ("auto", "torch")}
    workspaces = {b: D.make_workspace(parts, prob.model, c) for b, c in configs.items()}

    def solve(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=configs[backend],
                               workspace=workspaces[backend])
        torch.cuda.synchronize()
        return pipeline.assemble_result(prob, res, plan.init_seconds, time.perf_counter() - t0)

    ops.reset_launch_counts()
    with CollectiveCount() as coll:
        res = solve("auto")
    launches = ops.launch_counts()
    before = ops.launch_counts()
    res_p = solve("torch")
    if ops.launch_counts() != before:
        fail("the sharded plain path (backend='torch') launched a kernel")

    n_labels = sl["K"]
    acc, acc_p, acc_1 = accuracy(res), accuracy(res_p), sl["accuracy"]
    agree_1 = float((res.segmentation == single.segmentation).mean())
    agree_p = float((res.segmentation == res_p.segmentation).mean())
    iters = lambda r: (r.em_iters, r.map_iters)
    em_ands = max(res.em_iters - em_mod.WINDOW, 0)
    out = {
        "phase": "sharded_slice", "K": n_labels, "ranks": 1, "optimize_s": res.optimize_seconds,
        "em_iters": res.em_iters, "map_iters": res.map_iters, "status": res.status,
        "accuracy": acc, "launches": launches,
        "allreduces": coll.n["all_reduce"], "step_allreduces": coll.n["psum"],
        "flag_ands": coll.n["and_flags"], "em_ands": em_ands,
        "single_device_accuracy": acc_1, "pixel_agreement_single": agree_1,
        "labels_equal_single": bool(np.array_equal(res.region_labels, single.region_labels)),
        "iters_equal_single": iters(res) == iters(single),
        "status_equal_single": res.status == single.status,
        "plain_optimize_s": res_p.optimize_seconds, "plain_accuracy": acc_p,
        "plain_em_iters": res_p.em_iters, "plain_map_iters": res_p.map_iters,
        "pixel_agreement_plain": agree_p,
        "labels_equal_plain": bool(np.array_equal(res.region_labels, res_p.region_labels)),
        "iters_equal_plain": iters(res) == iters(res_p),
    }
    emit(out)
    if launches["fused_map_step"] != res.map_iters + res.em_iters:
        fail(f"fused_map_step launched {launches['fused_map_step']} times for {res.map_iters} MAP "
             f"and {res.em_iters} EM iterations")
    if launches["fused_em_tick"] != 0:
        fail("the sharded route ran the single-device tick")
    if launches["segment_reduce"] != 1:
        fail(f"segment_reduce launched {launches['segment_reduce']} times on the sharded route, "
             f"not once for the neighbourhood sizes: the label counts or the M-step went through it")
    # One all-reduce per MAP iteration, the flag ANDs, the EM window's ANDs,
    # the neighbourhood sizes and the two of the problem's fingerprint.
    if coll.n["psum"] != res.map_iters or coll.n["all_reduce"] != (
            coll.n["psum"] + coll.n["and_flags"] + em_ands + 3):
        fail(f"sharded K={n_labels} solve: collectives {coll.n} for {res.map_iters} MAP iterations")
    if res.status not in ("converged", "max_iters"):
        fail(f"sharded slice status {res.status}")
    if not (out["labels_equal_single"] and out["iters_equal_single"] and out["status_equal_single"]):
        fail(f"sharded K={n_labels} solve: labels, iterations or status differ from the single-device "
             f"route's on the same plan")
    for what, agree, ref_acc in (("single-device route", agree_1, acc_1), ("sharded plain path", agree_p, acc_p)):
        if agree < 0.995:
            fail(f"sharded route and {what} agree on {agree:.4f} of the pixels")
        if acc < ref_acc - 0.01:
            fail(f"sharded-route accuracy {acc} more than 0.01 below the {what}'s {ref_acc}")
    out["solve"] = lambda: solve("auto")
    return out


def cpu_step_unequal(torch, pairs, what: str) -> list:
    """Fails unless the bits of every ``(name, card, cpu)`` pair are equal
    (ints compared as ints); returns the names of those that differ."""
    unequal = [n for n, a, b in pairs
               if (a != b if isinstance(a, int) else not same_bits(torch, a.cpu(), b))]
    if unequal:
        fail(f"{what}: {unequal} not bit for bit the plain step's on the CPU")
    return unequal


class LockstepWorkspace:
    """A kernel ``MapStepWorkspace`` that, at every launch, also steps two
    plain ones from the same state: on the card (``backend="torch"``,
    which sums by atomics) and on the CPU (element order, the route's plain
    path).  Against the CPU the head's labels, the flag word, the ring and
    the step's hood sums and votes must be equal bit for bit
    (``cpu_step_unequal``; the CPU step takes the card's ``log`` of each
    sigma, which may differ from the host's in the last bit); against the
    card's plain workspace the hood sums within rtol 1e-5 (atol 1e-4) and
    the rest exactly.  The JAX-signature entry (``ops.fused_map_step``,
    elements in any order, order-free hood sums) on the counts of the same
    labels gives the step's votes bit for bit and its hood sums within the
    same tier.  The M-step sums of a launch that stops the MAP loop are
    held the same way: bit for bit the CPU's, the card's plain version's
    within rtol 1e-5.  Everything else is the kernel workspace's."""

    def __init__(self, torch, ops, kern, plain, cpu, hoods, model):
        self.torch, self.ops, self.kern, self.plain, self.cpu = torch, ops, kern, plain, cpu
        self.hoods, self.model = hoods, model
        self.launches = self.steps = self.log_unequal = self.m_steps = self.equal_launches = 0
        self.worst = self.entry_worst = self.stats_worst = 0.0

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def start(self, y, w, nall_e, valid, labels0):
        for ws in (self.kern, self.plain):
            ws.start(y, w, nall_e, valid, labels0)
        self.cpu.start(*(t.cpu() for t in (y, w, nall_e, valid, labels0)))
        self.elements = (y, w, nall_e, valid)

    def begin_em(self, mu, sigma):
        torch = self.torch
        for ws in (self.kern, self.plain):
            ws.begin_em(mu, sigma)
        log_sigma = torch.log(sigma).cpu()
        self.cpu.begin_em(mu.cpu(), sigma.cpu(), log_sigma=log_sigma)
        self.params = (mu, sigma)
        self.same_log = torch.equal(log_sigma, torch.log(sigma.cpu()))

    def step(self, gate, step=True):
        torch, k, p, c = self.torch, self.kern, self.plain, self.cpu
        for ws in (p, c):
            ws._labels.copy_(k.labels)
            ws._buffers.copy_(k._buffers)
            ws.ring.copy_(k.ring)
            ws.rot, ws.head, ws.first = k.rot, k.head, k.first
        k.step(gate, step)
        p.step(gate, step)
        c.step(gate, step)
        self.launches += 1
        self.log_unequal += not self.same_log
        what = f"sharded MAP step K={k.n_labels} launch {self.launches}"
        fk, fp = k.flag(), p.flag()
        if fk != fp or not torch.equal(k.labels, p.labels) or not same_bits(torch, k.ring, p.ring):
            fail(f"{what}: flag {fk} / plain {fp}, or the labels or the ring differ")
        nh = k.n_hoods
        kb, pb = k.buffer, p.buffer
        pairs = [("flag", fk, c.flag()), ("labels", k.labels, c.labels), ("ring", k.ring, c.ring)]
        if step:
            pairs += [("hood_e", kb[:nh], c.buffer[:nh]), ("votes", kb[nh:], c.buffer[nh:])]
        if fk or not step:  # the launch stops the MAP loop: its M-step sums
            pairs.append(("stats", k.stats, c.stats))
            self.m_steps += 1
            self.stats_worst = max(self.stats_worst, (k.stats - p.stats).abs().max().item())
            if not torch.allclose(k.stats, p.stats, rtol=1e-5, atol=1e-4):
                fail(f"{what}: the M-step sums differ from the plain version's on the card "
                     f"beyond rtol 1e-5")
        self.equal_launches += not cpu_step_unequal(torch, pairs, what)
        if not step:
            return
        self.steps += 1
        if not torch.equal(kb[nh:], pb[nh:]):
            fail(f"{what}: votes differ from the plain step's")
        self.worst = max(self.worst, (kb[:nh] - pb[:nh]).abs().max().item())
        if not torch.allclose(kb[:nh], pb[:nh], rtol=1e-5, atol=1e-4):
            fail(f"{what}: hood_e differs from the plain step's beyond rtol 1e-5")
        # The JAX-signature entry on the counts of the labels this step used.
        h, n_labels = self.hoods, k.n_labels
        y, w, nall_e, valid = self.elements
        x = p.labels[h.vertex.long()]
        seg = torch.where(h.valid, h.hood_id.long(), nh)
        counts = self.ops.ref.keyed_sum(valid, seg * n_labels + x.long(), (nh + 1) * n_labels)
        cnt_e = counts.reshape(nh + 1, n_labels)[h.hood_id.long()].T.contiguous()
        e = self.ops.fused_map_step(y, w, cnt_e, nall_e, x.float() * valid, valid, h.hood_id,
                                    h.vertex, *self.params, self.model.beta, n_hoods=nh,
                                    n_vertices=k.n_vertices)
        self.entry_worst = max(self.entry_worst, (e[2] - kb[:nh]).abs().max().item())
        if not (torch.equal(e[3].reshape(-1), kb[nh:])
                and torch.allclose(e[2], kb[:nh], rtol=1e-5, atol=1e-4)):
            fail(f"{what}: votes differ from the JAX-signature entry's, or hood_e beyond rtol 1e-5")


def check_sharded_map_step(torch, ops, D, pipeline, em_mod, sl, cpu_group) -> dict:
    """The sharded route's workspace kernel held step by step over a whole
    sharded solve of the slice's plan (one rank, ``LockstepWorkspace``:
    bit for bit to the plain step on the CPU from the kernel's state at
    every launch).  Beside it, the route's plain path run alone with the
    problem copied to the CPU (``cpu_group``: a gloo group of the one
    rank), which sums in element order: the solve's status and iteration
    counts must equal it and the single-device route's.  Returns the
    kernel workspace (its state is that of the solve's end) and the
    figures."""
    plan, config = sl["plan"], sl["config"]
    prob = plan.problem
    parts = D.partition_hoods(prob.hoods, 1)
    cfg, plain_cfg = config.em_config(), config.with_(backend="torch").em_config()
    hoods_c, model_c, *init_c = problem_on_cpu(plan, config, SLICE["seed"])
    parts_c = D.partition_hoods(hoods_c, 1)
    kern = D.make_workspace(parts, prob.model, cfg)
    plain = D.make_workspace(parts, prob.model, plain_cfg)
    ws = LockstepWorkspace(torch, ops, kern, plain, D.make_workspace(parts_c, model_c, plain_cfg),
                           parts, prob.model)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, SLICE["seed"], config.init)
    res = D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=cfg, workspace=ws)
    cpu = D.run_em_sharded(parts_c, model_c, *init_c, config=plain_cfg, group=cpu_group)
    single = sl["result"]
    name = lambda r: em_mod.STATUS_NAMES.get(r.status, "running")
    trajectory = lambda r: [name(r), r.em_iters, r.map_iters]
    row = {"phase": "sharded_map_step_check", "K": sl["K"], "ok": True, "launches": ws.launches,
           "steps": ws.steps, "bitwise_equal_plain_cpu_launches": ws.equal_launches,
           "launches_log_sigma_unequal_cpu": ws.log_unequal, "max_abs_err": ws.worst,
           "entry_hood_e_max_abs_err": ws.entry_worst, "m_steps_bitwise_equal_plain_cpu": ws.m_steps,
           "m_step_max_abs_err": ws.stats_worst,
           "status": name(res), "em_iters": res.em_iters, "map_iters": res.map_iters,
           "single_device": [single.status, single.em_iters, single.map_iters],
           "labels_equal_single": bool(np.array_equal(
               res.labels.cpu().numpy()[: prob.graph.n_regions], single.region_labels)),
           "plain_cpu": trajectory(cpu),
           "labels_equal_plain_cpu": bool(torch.equal(res.labels.cpu(), cpu.labels))}
    emit(row)
    if ws.launches != res.map_iters + res.em_iters or ws.m_steps != res.em_iters:
        fail(f"sharded K={sl['K']}: {ws.launches} launches, {ws.m_steps} of them with M-step sums, "
             f"for {res.map_iters} MAP and {res.em_iters} EM iterations")
    if trajectory(res) != trajectory(cpu) or not row["labels_equal_plain_cpu"]:
        fail(f"sharded K={sl['K']}: status and iterations {trajectory(res)}, the route's plain path "
             f"on the CPU {trajectory(cpu)}, labels equal {row['labels_equal_plain_cpu']}")
    if [single.status, single.em_iters, single.map_iters] != trajectory(res) or not row["labels_equal_single"]:
        fail(f"sharded K={sl['K']}: status and iterations {trajectory(res)}, the single-device "
             f"route {row['single_device']}, labels equal {row['labels_equal_single']}")
    return {"workspace": kern, "plain": plain, "max_abs_err": ws.worst, "parts": parts}


def check_sharded_step(torch, ops, collectives, checked, profile: bool) -> dict:
    """The sharded MAP iteration as the driver runs it (``step``, the AND of
    the flag word, the flag read, the all-reduce of the step's buffer) from
    the state a ``check_sharded_map_step`` solve ended in, K = 2:

    * profiler: ``MAP_STEPS`` iterations issue exactly one map-step kernel
      each, no memset, no copy, and no other kernel but NCCL's (counted
      apart);
    * times: ms per MAP iteration (host clock, what the driver pays; also
      without the flag AND, and without both collectives), ms per step
      back to back (CUDA events), device us per step (profiler), the plain
      workspace's step, and the bound; and the launch that stops a MAP loop
      without a step (the head, then the M-step sums): ms, device ms and
      its bound (``stopping_launch``).
    """
    import torch.distributed as dist

    ws, plain, parts = checked["workspace"], checked["plain"], checked["parts"]
    ctx = collectives.ReduceCtx(group=dist.group.WORLD)
    n_labels = ws.n_labels

    # The gate stays closed: at the state the solve ended in the window
    # test holds, so an open gate would set the flag word, and a launch
    # whose word is set also takes the M-step sums, as only the launch
    # that stops a MAP loop does (timed apart below).
    def iteration():
        ws.step(False)
        ctx.and_flags(ws.flag_word)
        ws.flag()
        ctx.psum(ws.buffer)

    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        before = ops.launch_counts()["fused_map_step"]
        prof = device_profile(torch, lambda: [iteration() for _ in range(MAP_STEPS)])
        steps = sum(t["count"] for t in prof["top"] if "map_iteration_kernel" in t["name"])
        nccl = sum(t["count"] for t in prof["top"] if "nccl" in t["name"].lower())
        step_us = sum(t["us"] for t in prof["top"] if "map_iteration_kernel" in t["name"])
        a = {"launches": ops.launch_counts()["fused_map_step"] - before, "kernels": prof["kernels"],
             "map_step_kernels": steps, "nccl_kernels": nccl, "memsets": prof["memsets"],
             "memcpys": prof["memcpys"], "device_us_per_step": step_us / max(steps, 1)}
        attempts.append(a)
        if (a["launches"] != MAP_STEPS or a["kernels"] != steps + nccl or steps > MAP_STEPS
                or a["memsets"] or a["memcpys"]):
            fail(f"sharded MAP iteration K={n_labels}: {MAP_STEPS} iterations issued {a}")
        if steps == MAP_STEPS:
            break
    row = {"phase": "sharded_step_profile_check", "K": n_labels, "steps": MAP_STEPS, **a,
           "attempts": len(attempts)}
    emit(row)
    if steps != MAP_STEPS:
        fail(f"sharded MAP iteration K={n_labels}: no profile of {MAP_STEPS} steps saw all of them: {attempts}")

    def host_ms(fn, n=10 * MAP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    # The iteration and its parts: the step with its flag read, then with
    # the all-reduce of the step, then the whole (with the flag AND).
    out = {"K": n_labels, "ms_per_map_iteration": host_ms(iteration),
           "ms_step_and_flag": host_ms(lambda: (ws.step(False), ws.flag())),
           "ms_step_flag_allreduce": host_ms(lambda: (ws.step(False), ws.flag(), ctx.psum(ws.buffer))),
           "ms": time_ms(lambda: ws.step(False)), "device_ms": row["device_us_per_step"] * 1e-3,
           "plain_ms": time_ms(lambda: plain.step(False))}
    from repro_torch.kernels import map_step

    ranges = map_step.hood_runs(parts, 0, 1)[0]
    # Each input byte once: y, w, nall and valid (f32) of the rank's own
    # elements; vertex (i32) and valid (bool) of the whole runs it counts,
    # which hold its own elements.
    n_run = int((ranges[:, 3] - ranges[:, 2]).sum())      # this rank's elements
    n_count = int((ranges[:, 1] - ranges[:, 0]).sum())    # the whole runs it counts
    nh, nv, rows = ws.n_hoods, ws.n_vertices, ws.ring.shape[0]
    n_bytes = (n_run * 4 * 4 + n_count * 5 + ranges.size * 4 + 2 * n_labels * 4 + 4  # elements, runs
               + nh * 4 + n_labels * nv * 4 + (rows - 1) * nh * 4                   # previous step, ring
               + nh * 4 + nv * 4                                                     # ring row, labels
               + nh * 4 + 2 * n_labels * nv * 4 + 4)                                 # step, cleared votes, flag
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_run * n_labels * 16 + (n_count + nv) * n_labels)
    out["bytes"] = n_bytes
    # A launch that stops a MAP loop without a step (one per EM iteration
    # of a solve): the head, then the M-step sums in the last block.
    stop = lambda: ws.step(True, step=False)
    stop_prof = device_profile(torch, lambda: [stop() for _ in range(20)])
    stop_bytes = (nh * 4 + n_labels * nv * 4 + (rows - 1) * nh * 4   # previous step, ring
                  + nh * 4 + nv * 4 + n_labels * nv * 4 + 4          # ring row, labels, cleared votes, flag
                  + 2 * nv * 4 + 3 * n_labels * 4)                   # region terms, M-step sums
    stop_bound, stop_by = bound(stop_bytes, nv * n_labels * 2 + nv * 3)
    out["stopping_launch"] = {"ms": time_ms(stop), "device_ms": stop_prof["device_busy_us"] / max(stop_prof["kernels"], 1) * 1e-3,
                              "kernels_per_20": stop_prof["kernels"], "bound_ms": stop_bound,
                              "bound_by": stop_by, "bytes": stop_bytes}
    if profile:
        out["profile_top"] = prof["top"]
    emit({"phase": "timing", "what": f"sharded MAP step (MapStepWorkspace) K={n_labels}", **out})
    return out


def check_plan_repeat(torch, api, sl) -> dict:
    """A second plan of the slice's image on the card equals the first (the
    main path's) bit for bit: the label map and every ``Hoods`` array
    (SLIC's centroid sums are ``segment_reduce``'s order-free ``add``).
    Also whether the card's plan equals the plain path's on the CPU,
    reported and not held: the image's normalisation reduces in another
    order there."""
    from repro_torch.core.pmrf import convert

    image, config, first = sl["image"], sl["config"], sl["plan"]
    again = api.Segmenter(config, device=image.device).plan(image)
    on_cpu = api.Segmenter(config, device="cpu").plan(image.cpu())

    def unequal(a, b):
        out = [] if np.array_equal(a.problem.labels_px, b.problem.labels_px) else ["labels_px"]
        ha, hb = a.problem.hoods, b.problem.hoods
        for f in convert.HOODS_ARRAYS:
            x, y = getattr(ha, f).cpu(), getattr(hb, f).cpu()
            if x.shape != y.shape or not torch.equal(x, y):
                out.append(f)
        return out + [f for f in convert.HOODS_SIZES if getattr(ha, f) != getattr(hb, f)]

    repeat, vs_cpu = unequal(first, again), unequal(first, on_cpu)
    emit({"phase": "plan_repeat_check", "K": sl["K"], "plans": 2, "ok": not repeat,
          "unequal": repeat, "plan_s": [first.init_seconds, again.init_seconds],
          "equal_cpu_plain_plan": not vs_cpu, "unequal_cpu_plain_plan": vs_cpu,
          "cpu_plan_s": on_cpu.init_seconds})
    if repeat:
        fail(f"two plans of one image differ in {repeat}")
    return {"equal_cpu_plain_plan": not vs_cpu}


def flash_inputs(torch, shape, dtype: str, dev, seed: int) -> tuple:
    """q, k, v for a (B, Hq, Hkv, S, D) case, made with numpy from ``seed``
    (the scales of ``tests/test_kernels.py``)."""
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    arrays = ((rng.standard_normal((b, hq, s, d)) * 0.3), (rng.standard_normal((b, hkv, s, d)) * 0.3),
              rng.standard_normal((b, hkv, s, d)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev, getattr(torch, dtype)) for a in arrays)


def flash_launch(ops, q, k, v, causal: bool) -> tuple:
    """One launch of the flash kernel; returns the output and the kernel
    the C entry point reported it ran (``flash_attention.launches_tc``)."""
    from repro_torch.kernels import flash_attention

    before = flash_attention.launches_tc
    out = ops.flash_attention(q, k, v, causal=causal)
    return out, "tensor_cores" if flash_attention.launches_tc > before else "cuda_cores"


def check_flash(torch, ops, dev) -> float:
    """flash_attention kernel against its plain version on the card: the
    reference tests' shapes and a ragged S in f32 and bf16, causal and not,
    the models' shapes (qwen2-1.5b's, qwen3-moe's, zamba2's at D = 80,
    which must go to the CUDA-core kernel, llava's and whisper's decoder's,
    which must go to the tensor cores) in bf16 causal, whisper's encoder's
    in bf16 non-causal (tensor cores), and three more shapes of the bf16
    tensor-core kernel.  Each case names the kernel it went to.  Returns
    the largest error."""
    cases = [(sh, dt, c) for sh in FLASH_REF_SHAPES for dt in FLASH_TOL for c in (False, True)]
    cases += [(sh, "bfloat16", True) for sh in FLASH_MODEL_SHAPES + FLASH_MOE_SHAPES]
    cases += [(sh, "bfloat16", True) for sh in FLASH_ZAMBA_SHAPES + FLASH_LLAVA_SHAPES + FLASH_WHISPER_DECODER]
    cases += [(FLASH_WHISPER_ENCODER, "bfloat16", False)]
    cases += [(sh, "bfloat16", c) for sh in FLASH_TC_SHAPES for c in (False, True)]
    worst, rows = 0.0, []
    for i, (shape, dtype, causal) in enumerate(cases):
        q, k, v = flash_inputs(torch, shape, dtype, dev, seed=i)
        kern, variant = flash_launch(ops, q, k, v, causal)
        plain = ops.flash_attention(q, k, v, causal=causal, backend="torch")
        torch.cuda.synchronize()
        what = f"flash_attention {shape} {dtype} causal={causal}"
        if kern.dtype != q.dtype or kern.shape != q.shape:
            fail(f"{what}: output {kern.dtype} {tuple(kern.shape)}")
        if not bool(torch.isfinite(kern.float()).all()):
            fail(f"{what}: non-finite output")
        err = (kern.float() - plain.float()).abs().max().item()
        tol = FLASH_TOL[dtype]
        if not torch.allclose(kern.float(), plain.float(), rtol=tol, atol=tol):
            fail(f"{what}: differs from the plain version beyond {tol} (err {err})")
        want = {**{sh: "cuda_cores" for sh in FLASH_ZAMBA_SHAPES},
                **{sh: "tensor_cores" for sh in FLASH_LLAVA_SHAPES + FLASH_WHISPER_DECODER},
                FLASH_WHISPER_ENCODER: "tensor_cores"}.get(shape, variant)
        if variant != want:
            fail(f"{what}: went to the {variant} kernel, not the {want} one")
        del kern, plain, q, k, v
        worst = max(worst, err)
        rows.append({"shape": list(shape), "dtype": dtype, "causal": causal, "max_abs_err": err,
                     "variant": variant})
    emit({"phase": "flash_attention_check", "ok": True, "max_abs_err": worst, "cases": rows})
    return worst


def check_flash_peaked(torch, ops, dev) -> float:
    """The bf16 tensor-core kernel against its plain version where the
    softmax is peaked (``repro_torch.testing.flash_cases``): q scaled by 10
    to 1000, so the running max moves from tile to tile and, in one case,
    ``exp`` overflows unless the max is subtracted.  Each output row's
    error over its largest |value| must stay within ``ROW_TOL``; every case
    must reach the tensor-core kernel.  Returns the largest such error."""
    from repro_torch.testing import flash_cases as fc

    worst, rows = 0.0, []
    for i, (shape, q_scale, causal) in enumerate(fc.PEAKED_CASES):
        arrays = fc.peaked_inputs(shape, q_scale, seed=100 + i)
        spread = fc.score_spread(*arrays[:2], causal)
        what = f"flash_attention peaked {shape} q x{q_scale} causal={causal}"
        if spread < fc.MIN_SPREAD:
            fail(f"{what}: scores spread by {spread}, less than {fc.MIN_SPREAD}")
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in arrays)
        kern, variant = flash_launch(ops, q, k, v, causal)
        plain = ops.flash_attention(q, k, v, causal=causal, backend="torch")
        torch.cuda.synchronize()
        if variant != "tensor_cores":
            fail(f"{what}: went to the {variant} kernel")
        err = fc.row_relative_error(kern.float().cpu().numpy(), plain.float().cpu().numpy())
        if not err <= fc.ROW_TOL:
            fail(f"{what}: a row differs from the plain version by {err} of its largest value, "
                 f"beyond {fc.ROW_TOL}")
        worst = max(worst, err)
        rows.append({"shape": list(shape), "q_scale": q_scale, "causal": causal, "score_spread": spread,
                     "row_relative_err": err,
                     "max_abs_err": (kern.float() - plain.float()).abs().max().item()})
    emit({"phase": "flash_attention_peaked_check", "ok": True, "row_tol": fc.ROW_TOL,
          "row_relative_err": worst, "cases": rows})
    return worst


def guarded(torch, n: int, guard: int, fill: float, dev):
    """A bf16 buffer of ``n + guard`` elements filled with ``fill``; returns
    it and the view of its first ``n``, whose last element the guard
    follows in memory."""
    buf = torch.full((n + guard,), fill, dtype=torch.bfloat16, device=dev)
    return buf, buf[:n]


def check_flash_ragged(torch, dev) -> float:
    """The bf16 tensor-core kernel where S ends in a partial 64-row tile
    (``FLASH_RAGGED_CASES``: whisper's encoder call, S = 1500 = 23 * 64 +
    28, and (2, 4, 2, 200, 64), 4 tiles of which the last holds 8 rows),
    on peaked scores (q scaled by ``FLASH_RAGGED_Q_SCALE``), launched
    through the C entry point on buffers of its own: ``GUARD_ROWS`` rows of
    NaN follow q, k and v in memory (the last head's rows past S, which
    the TMA box of the last tile spans: a key past S that reached the
    softmax or the value product would make its rows NaN), and a sentinel
    follows the output (a row past S that was stored would overwrite it).
    Each output row within ``flash_cases.ROW_TOL`` of its largest value
    against ``ref.flash_attention`` on the card, the last q tile's rows
    reported apart; the guard unchanged.  Returns the largest row error."""
    import ctypes

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.testing import flash_cases as fc

    kernel = flash_attention._bind()
    worst, rows = 0.0, []
    for i, (shape, causal) in enumerate(FLASH_RAGGED_CASES):
        b, hq, hkv, s, d = shape
        what = f"flash_attention ragged {shape} causal={causal}"
        arrays = fc.peaked_inputs(shape, FLASH_RAGGED_Q_SCALE, seed=200 + i)
        tensors = []
        for a in arrays:
            _, view = guarded(torch, a.size, GUARD_ROWS * d, float("nan"), dev)
            view.copy_(torch.from_numpy(a.reshape(-1)).to(dev, torch.bfloat16))
            tensors.append(view.view(a.shape))
        q, k, v = tensors
        sentinel = 3.0
        out_buf, out_flat = guarded(torch, q.numel(), GUARD_ROWS * d, sentinel, dev)
        tc = ctypes.c_int(0)
        kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out_flat.data_ptr(), b, hq, hkv, s, d,
               float(d ** -0.5), int(causal), flash_attention._DTYPES[torch.bfloat16],
               torch.cuda.current_stream().cuda_stream, ctypes.byref(tc))  # raises on a CUDA error
        torch.cuda.synchronize()
        if tc.value != 1:
            fail(f"{what}: the C entry did not run the tensor-core kernel")
        kern = out_flat.view(q.shape).float().cpu().numpy()
        plain = ref.flash_attention(q, k, v, causal=causal).float().cpu().numpy()
        guard_kept = bool((out_buf[q.numel():] == sentinel).all())
        last0 = (s - 1) // 64 * 64
        err = fc.row_relative_error(kern, plain)
        err_last = fc.row_relative_error(kern[..., last0:, :], plain[..., last0:, :])
        row = {"shape": list(shape), "causal": causal, "q_scale": FLASH_RAGGED_Q_SCALE,
               "score_spread": fc.score_spread(arrays[0][:1, :1], arrays[1][:1, :1], causal),
               "last_tile_rows": s - last0, "row_relative_err": err, "last_tile_row_relative_err": err_last,
               "max_abs_err": float(np.abs(kern - plain).max()), "output_guard_kept": guard_kept}
        rows.append(row)
        if not guard_kept:
            fail(f"{what}: the kernel wrote past the output's last row")
        if not err <= fc.ROW_TOL:
            fail(f"{what}: a row differs from the plain version by {err} of its largest value, beyond {fc.ROW_TOL}")
        worst = max(worst, err)
        del q, k, v, tensors, out_buf, out_flat
    emit({"phase": "flash_ragged_check", "ok": True, "row_tol": fc.ROW_TOL, "guard_rows": GUARD_ROWS,
          "row_relative_err": worst, "cases": rows})
    return worst


def lm_prompts(cfg) -> list:
    """The LM path's prompts: ``per_length`` of each length, from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(LM["seed"])
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LM["lengths"] for _ in range(LM["per_length"])]


def serve(torch, serving, cfg, params, prompts, dev, backend: str, max_new: int = 0, max_seq: int = 0,
          extras: list = None) -> dict:
    """Drive ``ServingEngine`` (greedy) over ``prompts``, all submitted at
    the start, request ``r`` with ``extras[r]`` where given.  Each
    request's prefill time (its ``_insert``: one prefill and the first
    token's read, which waits for the card) and the moment its first token
    is known are recorded beside the completions.  ``max_new`` and
    ``max_seq`` default to the LM path's."""

    class TimedEngine(serving.ServingEngine):
        def _insert(self, slot, req):
            t0 = time.perf_counter()
            super()._insert(slot, req)
            t1 = time.perf_counter()
            prefill_s[req.rid], first_at[req.rid] = t1 - t0, t1

    prefill_s, first_at = {}, {}
    engine = TimedEngine(cfg, params, max_batch=LM["max_batch"], max_seq=max_seq or LM["max_seq"],
                         sampler=serving.SamplerConfig(temperature=0.0), seed=LM["seed"],
                         device=dev, backend=backend)
    for rid, p in enumerate(prompts):
        engine.submit(serving.Request(rid=rid, prompt=p, max_new_tokens=max_new or LM["max_new"],
                                      extras=extras[rid] if extras else {}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"completions": {c.rid: c for c in comps}, "wall_s": wall, "ticks": engine.ticks,
            "prefill_s": prefill_s, "ttft_s": {r: t - t0 for r, t in first_at.items()}}


def prefill_last_logits(torch, api, cfg, params, prompts, dev, backend: str, extras: list = None) -> list:
    """Last-position prefill logits (V,) float32 of each prompt (with its
    ``extras``, given a batch axis, where given)."""
    out = []
    with torch.inference_mode():
        for r, p in enumerate(prompts):
            tokens = torch.from_numpy(p.astype(np.int64))[None].to(dev)
            batch = {"tokens": tokens, **{k: v[None] for k, v in (extras[r] if extras else {}).items()}}
            logits, _ = api.prefill(params, batch, cfg, backend=backend)
            out.append(logits[0, -1])
    torch.cuda.synchronize()
    return out


def logits_compare_a(torch, kern: list, plain: list) -> dict:
    """Check (a)'s figures, kernel path against plain path: the largest
    logits error beside the largest plain logit (within 1e-4 of it: the
    form held on the MoE and later families) and the element-wise rtol
    1e-4 / atol 1e-5."""
    err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    scale = max(b.abs().max().item() for b in plain)
    return {"logits_max_abs_err": err, "logits_max_abs": scale,
            "logits_err_within_1e-4_of_max_abs": err <= 1e-4 * scale,
            "logits_within_rtol_1e-4": all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                                                    for a, b in zip(kern, plain)),
            "logits_err_by_request": [(a - b).abs().max().item() for a, b in zip(kern, plain)]}


def logits_compare_b(torch, kern: list, plain: list) -> dict:
    """Check (b)'s figures: first token equal by request, the misses where
    the plain logits of the two tokens lie within one bf16 spacing (a
    tie), cosine, and each request's plain top-1 minus top-2 logit (a
    first token that differs at a small margin is a near-tie, at a large
    one an error)."""
    equal = [int(a.argmax() == b.argmax()) for a, b in zip(kern, plain)]
    at_tie = [r for r, (a, b) in enumerate(zip(kern, plain))
              if not equal[r] and (b.max() - b[a.argmax()]).item() <= bf16_ulp(b.max().item())]
    cos = [torch.nn.functional.cosine_similarity(a, b, dim=0).item() for a, b in zip(kern, plain)]
    top2 = [b.float().topk(2).values for b in plain]
    return {"first_token_equal": sum(equal), "of": len(equal), "first_token_equal_by_request": equal,
            "misses_at_a_bf16_tie": at_tie, "plain_top1_minus_top2": [(t[0] - t[1]).item() for t in top2],
            "min_cosine": min(cos), "cosine": cos,
            "logits_max_abs_err": max((a - b).abs().max().item() for a, b in zip(kern, plain))}


def check_kernel_vs_plain(who: str, res_a: dict, res_b: dict) -> None:
    """The limits held on the MoE and later families (``PERF.md`` §6): (a)
    greedy tokens equal and logits within 1e-4 of their largest
    magnitude; (b) first token equal on all but one request, a miss at a
    bf16 tie not counted, and cosine at least 0.99."""
    if not res_a["greedy_tokens_equal"]:
        fail(f"{who}f32 model: greedy tokens differ between the kernel and plain paths")
    if not res_a["logits_err_within_1e-4_of_max_abs"]:
        fail(f"{who}f32 model: prefill logits differ by {res_a['logits_max_abs_err']}, "
             f"beyond 1e-4 of {res_a['logits_max_abs']}")
    if res_b["first_token_equal"] + len(res_b["misses_at_a_bf16_tie"]) < res_b["of"] - 1:
        fail(f"{who}bf16 model: first token equal on {res_b['first_token_equal']} of {res_b['of']} requests, "
             f"{len(res_b['misses_at_a_bf16_tie'])} more at a bf16 tie")
    if res_b["min_cosine"] < 0.99:
        fail(f"{who}bf16 model: prefill logits cosine {res_b['min_cosine']} below 0.99")


def profile_lm(torch, api, cfg, params, prompts, dev, max_seq: int = 0, extras: dict = None) -> None:
    """``profile`` lines of one prefill of the last (longest) prompt (with
    its ``extras``, where given) and one decode step at B = ``max_batch``,
    t = its length: wall time (best of 3) and the device's idle share
    against it.  ``max_seq`` defaults to the LM path's.  For ``encdec``
    also the cross caches' padding copy of one decode step
    (``cross_cache_pad``)."""
    long_prompt = torch.from_numpy(prompts[-1].astype(np.int64))[None].to(dev)
    t = len(prompts[-1])
    batch = {"tokens": long_prompt, **{k: v[None] for k, v in (extras or {}).items()}}

    def prefill():
        with torch.inference_mode():
            api.prefill(params, batch, cfg)

    cache = api.init_cache(cfg, LM["max_batch"], max_seq or LM["max_seq"], device=dev)
    cache["t"] = torch.tensor(t, dtype=torch.int32)
    last = torch.zeros((LM["max_batch"], 1), dtype=torch.int64, device=dev)

    def decode():
        with torch.inference_mode():
            api.decode_step(params, dict(cache), {"tokens": last}, cfg)

    for what, fn in ((f"prefill S={t}", prefill), (f"decode step B={LM['max_batch']} t={t}", decode)):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prof = device_profile(torch, fn)
        emit({"phase": "profile", "what": f"LM {what}, {cfg.name} {cfg.n_layers} layers {cfg.param_dtype}",
              "wall_s_unprofiled": min(walls),
              "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / min(walls), **prof})
    if cfg.family == "encdec":
        cross_cache_pad(torch, cfg, cache, prof["device_busy_us"])


def cross_cache_pad(torch, cfg, cache, step_busy_us: float) -> None:
    """The copy ``chunked_attention`` makes of every layer's cross K/V in
    one decode step: ``encoder_seq`` keys padded to a multiple of
    ``min(attn_chunk, encoder_seq)`` (1500 -> 2048), both caches, every
    layer, at the step's batch.  Its time per step (CUDA events), bytes
    (the caches read once, the padded copies written once) and share of
    the profiled decode step's device time."""
    import torch.nn.functional as F

    sk = cfg.encoder_seq
    pad = (-sk) % min(cfg.attn_chunk, sk)

    def copies():
        for name in ("xk", "xv"):
            for i in range(cfg.n_layers):
                F.pad(cache[name][i], (0, 0, 0, pad))

    with torch.inference_mode():
        ms = time_ms(copies, iters=10, warmup=2)
    per = cache["xk"][0].numel() * cache["xk"].element_size()
    n_bytes = 2 * cfg.n_layers * per * (2 * sk + pad) // sk
    emit({"phase": "profile", "what": f"cross_cache_pad: one decode step's padding copy, {cfg.name}",
          "keys": sk, "padded_to": sk + pad, "batch": int(cache["xk"].shape[1]), "layers": cfg.n_layers,
          "ms_per_step": ms, "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
          "share_of_decode_step_device_time": ms * 1e3 / step_busy_us if step_busy_us else None})


def run_lm(torch, ops, dev, profile: bool) -> dict:
    """The LM serving path at qwen2-1.5b's full width and depth, then the
    kernel path held against the plain path: (a) a 2-layer f32 variant at
    full width, (b) the 28-layer bf16 model."""
    import dataclasses

    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_api

    cfg = get_config(LM["arch"])
    api = get_api(cfg)
    prompts = lm_prompts(cfg)
    n_req = len(prompts)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "lm_model", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.param_dtype,
          "params": n_params, "init_s": time.perf_counter() - t0})

    # Warm-up (cuBLAS handles and heuristics at these shapes): one request
    # of each length, outside the counted run.
    serve(torch, serving, cfg, params, [prompts[0], prompts[-1]], dev, "auto", max_new=2)

    from repro_torch.kernels import flash_attention

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    main = serve(torch, serving, cfg, params, prompts, dev, "auto")
    launches = ops.launch_counts()
    launches_tc = flash_attention.launches_tc
    comps = main["completions"]
    generated = sum(len(c.tokens) for c in comps.values())
    by_len = {n: [r for r, p in enumerate(prompts) if len(p) == n] for n in LM["lengths"]}
    out = {
        "phase": "lm_serve", "arch": cfg.name, "requests": n_req, "prompt_lengths": list(LM["lengths"]),
        "max_new_tokens": LM["max_new"], "max_batch": LM["max_batch"], "max_seq": LM["max_seq"],
        "launches": launches, "flash_attention_tensor_core_launches": launches_tc,
        "completed": len(comps), "generated_tokens": generated,
        "ticks": main["ticks"], "wall_s": main["wall_s"], "tok_per_s": generated / main["wall_s"],
        "ttft_s": [main["ttft_s"][r] for r in range(n_req)],
        "prefill_ms": {str(n): [main["prefill_s"][r] * 1e3 for r in rids] for n, rids in by_len.items()},
        "mean_prefill_ms": {str(n): float(np.mean([main["prefill_s"][r] for r in rids])) * 1e3
                            for n, rids in by_len.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    want = cfg.n_layers * n_req
    if launches["flash_attention"] != want:
        fail(f"flash_attention launched {launches['flash_attention']} times on the LM path, not {want}")
    if launches_tc != want:
        fail(f"{launches_tc} of the LM path's {want} flash_attention launches went to the tensor-core kernel")
    if any(n for name, n in launches.items() if name != "flash_attention"):
        fail(f"the LM path launched a segmentation kernel: {launches}")
    if sorted(comps) != list(range(n_req)):
        fail(f"LM path completed {sorted(comps)} of {n_req} requests")
    for rid, c in comps.items():
        if len(c.tokens) != LM["max_new"] or c.finish_reason != "length":
            fail(f"request {rid}: {len(c.tokens)} tokens, finish {c.finish_reason}")
        if not bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()):
            fail(f"request {rid}: token ids outside the vocabulary")

    # (a) 2 layers at full width in float32: kernel path against plain path.
    cfg_a = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", compute_dtype="float32")
    params_a = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg_a)
    ops.reset_launch_counts()
    kern_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "auto")
    launches_a = ops.launch_counts()["flash_attention"]
    plain_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "torch")
    logits_k = prefill_last_logits(torch, api, cfg_a, params_a, prompts, dev, "auto")
    before = ops.launch_counts()
    logits_p = prefill_last_logits(torch, api, cfg_a, params_a, prompts, dev, "torch")
    if ops.launch_counts() != before or launches_a != cfg_a.n_layers * n_req:
        fail(f"f32 check: plain path launched a kernel, or the kernel path launched {launches_a}")
    tokens_equal = all(np.array_equal(kern_a["completions"][r].tokens, plain_a["completions"][r].tokens)
                       for r in range(n_req))
    res_a = {"layers": 2, "dtype": "float32", "greedy_tokens_equal": tokens_equal,
             **logits_compare_a(torch, logits_k, logits_p),
             "wall_s": kern_a["wall_s"], "plain_wall_s": plain_a["wall_s"]}

    # (b) the 28-layer bf16 model: first generated token and logits cosine.
    logits_k = prefill_last_logits(torch, api, cfg, params, prompts, dev, "auto")
    before = ops.launch_counts()
    logits_p = prefill_last_logits(torch, api, cfg, params, prompts, dev, "torch")
    if ops.launch_counts() != before:
        fail("bf16 check: the plain path launched a kernel")
    engine_first = sum(int(comps[r].tokens[0] == int(logits_k[r].argmax())) for r in range(n_req))
    res_b = {"layers": cfg.n_layers, "dtype": cfg.param_dtype, **logits_compare_b(torch, logits_k, logits_p),
             "engine_first_token_equal_kernel_prefill": engine_first}
    emit({"phase": "lm_kernel_vs_plain", "f32_2_layers": res_a, "bf16_28_layers": res_b})
    if not tokens_equal:
        fail("f32 2-layer model: greedy tokens differ between the kernel and plain paths")
    if not res_a["logits_within_rtol_1e-4"]:
        fail(f"f32 2-layer model: prefill logits differ beyond rtol 1e-4 (err {res_a['logits_max_abs_err']})")
    if res_b["first_token_equal"] < n_req - 1:
        fail(f"bf16 model: first token equal on {res_b['first_token_equal']} of {n_req} requests")
    if res_b["min_cosine"] < 0.99:
        fail(f"bf16 model: prefill logits cosine {res_b['min_cosine']} below 0.99")
    del params_a

    if profile:
        profile_lm(torch, api, cfg, params, prompts, dev)
    return {"launches": launches["flash_attention"], "launches_tc": launches_tc, "serve": out}


def time_flash(torch, ops, dev, profile: bool, shapes=None, causal: bool = True) -> dict:
    """The flash kernel at the LM path's two calls (``shapes``, by default
    qwen2-1.5b's at S = 512 and 1024, bf16, ``causal``; S(S+1)/2 causal
    (q, k) pairs, else S^2): its time per call (CUDA events over back-to-back calls, the
    host's share included) and on the device (``torch.profiler``), the
    plain version's time, one library call's (``scaled_dot_product_attention``,
    per call and on the device), and the bound from the call's bytes and
    operations, with the kernel's share of it.  Returns the S = 1024
    numbers for the ``kernels`` line, the S = 512 ones under ``by_shape``."""
    import torch.nn.functional as F

    rows = []
    for shape in shapes or FLASH_MODEL_SHAPES:
        b, hq, hkv, s, d = shape
        q, k, v = flash_inputs(torch, shape, "bfloat16", dev, seed=99)
        kern = lambda: ops.flash_attention(q, k, v, causal=causal)
        plain = lambda: ops.flash_attention(q, k, v, causal=causal, backend="torch")
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        lib_err = (lib().float() - plain().float()).abs().max().item()
        if lib_err > FLASH_TOL["bfloat16"]:
            fail(f"scaled_dot_product_attention differs from the plain version by {lib_err}")
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        prof = device_profile(torch, lambda: [kern() for _ in range(20)])
        lib_prof = device_profile(torch, lambda: [lib() for _ in range(20)])
        n_bytes = (2 * b * hq + 2 * b * hkv) * s * d * q.element_size()   # q, k, v in; out
        pairs = s * (s + 1) // 2 if causal else s * s                     # (q, k) pairs
        n_ops = 4 * b * hq * d * pairs                                    # QK^T and PV, 2 ops per MAC
        bound_ms, by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        device_ms = prof["device_busy_us"] / 20 * 1e-3
        row = {"shape": list(shape), "causal": causal, "variant": flash_launch(ops, q, k, v, causal)[1],
               "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_device_ms": lib_prof["device_busy_us"] / 20 * 1e-3,
               "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / ms,
               "device_share_of_bound": bound_ms / device_ms if device_ms else None,
               "bytes": n_bytes, "ops": n_ops, "achieved_tflops": n_ops / (ms * 1e-3) / 1e12,
               "device_tflops": n_ops / (device_ms * 1e-3) / 1e12 if device_ms else None,
               "sdpa_max_abs_err_vs_plain": lib_err}
        mask = "causal" if causal else "non-causal"
        emit({"phase": "timing", "what": f"flash_attention bf16 {mask}", **row})
        if profile:
            emit({"phase": "profile", "what": f"20 flash_attention calls (S={s} bf16 {mask})", **prof})
            emit({"phase": "profile", "what": f"20 scaled_dot_product_attention calls (S={s})", **lib_prof})
        rows.append(row)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms", "bound_by")
    return {**{k: rows[-1][k] for k in keys},
            "by_shape": {str(r["shape"][3]): {k: r[k] for k in keys} for r in rows}}


def expert_set_diffs(torch, kern: list, plain: list, k: int, per_call: int) -> dict:
    """Tokens whose expert set differs between two runs' dispatches (same
    calls in the same order), with the plain run's k-th minus (k+1)-th
    router logit for each; ``by_request`` counts them per ``per_call``
    dispatches (one prefill)."""
    margins, by_request = [], []
    for i, (dk, dp) in enumerate(zip(kern, plain)):
        if i % per_call == 0:
            by_request.append(0)
        diff = (dk.experts.sort(dim=1).values != dp.experts.sort(dim=1).values).any(dim=1)
        n = int(diff.sum())
        if n:
            top = dp.logits.topk(k + 1, dim=-1).values
            margins += (top[:, k - 1] - top[:, k])[diff].tolist()
            by_request[-1] += n
    return {"tokens": len(margins), "by_request": by_request,
            "plain_kth_minus_next": sorted(margins)[:16]}


def moe_card_vs_cpu(torch, cfg, dev) -> dict:
    """The dispatch, which no kernel holds: one ``moe_ffn`` of a random
    float32 layer at full width over 1 x ``MOE_CHECK_TOKENS`` tokens (numpy
    seed 0) on the card and on the CPU.  Expert sets must agree on every
    token whose top-(k+1) router logits are more than ``MOE_TIE`` apart,
    keep masks and dropped counts everywhere, outputs within rtol/atol
    1e-4 on the tokens whose sets agree.  For MLA, one ``mla_attn`` over
    the same tokens within 1e-4."""
    import copy
    import dataclasses

    from repro_torch.models import attention as A
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    k = cfg.moe_top_k
    x_np = np.random.default_rng(0).standard_normal((1, MOE_CHECK_TOKENS, cfg.d_model)).astype(np.float32)
    p = M.moe_init(torch.Generator(device=dev).manual_seed(1), cfg, torch.float32)
    p_cpu = copy.deepcopy(p).cpu()
    x, x_cpu = torch.from_numpy(x_np).to(dev), torch.from_numpy(x_np)
    with torch.inference_mode():
        out, out_cpu = M.moe_ffn(p, x, cfg).cpu(), M.moe_ffn(p_cpu, x_cpu, cfg)
        d, d_cpu = M.dispatch(p, x[0], cfg), M.dispatch(p_cpu, x_cpu[0], cfg)
    top = d_cpu.logits.topk(k + 1, dim=-1).values
    tied = ((top[:, :-1] - top[:, 1:]) <= MOE_TIE).any(dim=1)
    agree = (d.experts.cpu().sort(dim=1).values == d_cpu.experts.sort(dim=1).values).all(dim=1)
    keep_equal = bool((d.keep_by_lane().cpu() == d_cpu.keep_by_lane()).all())
    dropped = [int(dd.local.sum() - dd.keep.sum()) for dd in (d, d_cpu)]
    err = (out[0][agree] - out_cpu[0][agree]).abs().max().item()
    row = {"phase": "lm_moe_card_vs_cpu", "arch": cfg.name, "tokens": MOE_CHECK_TOKENS, "dtype": "float32",
           "capacity": d.cap, "near_ties": int(tied.sum()), "sets_differ": int((~agree).sum()),
           "sets_differ_apart_from_near_ties": int((~agree & ~tied).sum()), "keep_equal": keep_equal,
           "dropped_card": dropped[0], "dropped_cpu": dropped[1], "moe_ffn_max_abs_err": err,
           "moe_ffn_within_1e-4": bool(torch.allclose(out[0][agree], out_cpu[0][agree], rtol=1e-4, atol=1e-4))}
    del p, p_cpu
    if cfg.family == "mla_moe":
        a = A.mla_init(torch.Generator(device=dev).manual_seed(2), cfg, torch.float32)
        with torch.inference_mode():
            att, att_cpu = A.mla_attn(a, x, cfg).cpu(), A.mla_attn(copy.deepcopy(a).cpu(), x_cpu, cfg)
        row["mla_attn_max_abs_err"] = (att - att_cpu).abs().max().item()
        row["mla_attn_within_1e-4"] = bool(torch.allclose(att, att_cpu, rtol=1e-4, atol=1e-4))
    emit(row)
    if row["sets_differ_apart_from_near_ties"] or not keep_equal or dropped[0] != dropped[1]:
        fail(f"{cfg.name}: the card's dispatch differs from the CPU's: {row}")
    if not row["moe_ffn_within_1e-4"] or not row.get("mla_attn_within_1e-4", True):
        fail(f"{cfg.name}: the card's moe_ffn or mla_attn differs from the CPU's beyond 1e-4: {row}")
    return row


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers (8 significant bits) at ``x``."""
    return 2.0 ** (math.frexp(abs(x))[1] - 8) if x else 2.0 ** -133


def moe_kernel_vs_plain(torch, ops, serving, api, cfg, params, prompts, dev) -> dict:
    """qwen3-moe's kernel path (flash prefill) against its plain path, with
    the dense family's limits, each reported as such: (a) a 2-layer
    float32 variant at full width, greedy tokens equal and prefill logits
    within rtol 1e-4 / atol 1e-5; (b) the bf16 model, first token equal on
    all but one request and logits cosine >= 0.99.  Each part reports the
    tokens whose expert set differs between the paths at any layer.

    Two limits are held in the form the measurement supports (PERF.md
    §6, PR 27): (a)'s logits within 1e-4 of their largest magnitude (the
    f32 kernel's own rounding, about 1e-6 on the attention output, grows
    to about 1e-5 on the logits over two layers in either family, at the
    element-wise limit's atol); (b)'s first-token misses count against
    the limit only where the plain path's logits of the two tokens are
    more than one bfloat16 spacing apart (a tie at the logits' resolution
    is the near-tie the routing lines show)."""
    import dataclasses

    from repro_torch.models import moe as M

    n_req, k = len(prompts), cfg.moe_top_k

    def logits_and_dispatches(c, p, backend):
        with M.logged() as log:
            out = prefill_last_logits(torch, api, c, p, prompts, dev, backend)
        return out, log.dispatches

    cfg_a = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", compute_dtype="float32")
    params_a = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg_a)
    ops.reset_launch_counts()
    kern_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "auto")
    launches_a = ops.launch_counts()["flash_attention"]
    plain_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "torch")
    logits_k, disp_k = logits_and_dispatches(cfg_a, params_a, "auto")
    before = ops.launch_counts()
    logits_p, disp_p = logits_and_dispatches(cfg_a, params_a, "torch")
    if ops.launch_counts() != before or launches_a != cfg_a.n_layers * n_req:
        fail(f"{cfg.name} f32 check: plain path launched a kernel, or the kernel path launched {launches_a}")
    tokens_equal = all(np.array_equal(kern_a["completions"][r].tokens, plain_a["completions"][r].tokens)
                       for r in range(n_req))
    res_a = {"layers": 2, "dtype": "float32", "greedy_tokens_equal": tokens_equal,
             **logits_compare_a(torch, logits_k, logits_p),
             "expert_sets_differ": expert_set_diffs(torch, disp_k, disp_p, k, cfg_a.n_layers),
             "wall_s": kern_a["wall_s"], "plain_wall_s": plain_a["wall_s"]}
    del params_a, kern_a, plain_a, disp_k, disp_p
    gc_cuda(torch)

    logits_k, disp_k = logits_and_dispatches(cfg, params, "auto")
    before = ops.launch_counts()
    logits_p, disp_p = logits_and_dispatches(cfg, params, "torch")
    if ops.launch_counts() != before:
        fail(f"{cfg.name} bf16 check: the plain path launched a kernel")
    res_b = {"layers": cfg.n_layers, "dtype": cfg.param_dtype, **logits_compare_b(torch, logits_k, logits_p),
             "expert_sets_differ": expert_set_diffs(torch, disp_k, disp_p, k, cfg.n_layers)}
    emit({"phase": "lm_moe_kernel_vs_plain", "arch": cfg.name, "f32_2_layers": res_a,
          f"bf16_{cfg.n_layers}_layers": res_b})
    check_kernel_vs_plain(f"{cfg.name} ", res_a, res_b)
    return {"f32_2_layers": res_a, "bf16": res_b}


def gc_cuda(torch) -> None:
    """Free what Python no longer references, and the allocator's cache."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def run_lm_moe(torch, ops, dev, profile: bool, smi_line: str) -> dict:
    """The MoE families on the LM path's traffic (``LM_MOE``): each model
    serves the 8 requests twice (the second run must repeat the tokens bit
    for bit: no atomic in the dispatch or the combine), with the share of
    lanes its capacity dropped per prefill length from the port's own
    dispatch (``moe.logged``); qwen3-moe's kernel path against its plain
    path; the dispatch (and MLA) card against CPU.  Returns the flash
    launches of qwen3-moe's run for the ``kernels`` line."""
    import dataclasses

    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import moe as M
    from repro_torch.models.registry import get_api

    t_phase = time.perf_counter()
    flash_launches = {}
    for arch, n_layers in LM_MOE:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        api = get_api(cfg)
        prompts = lm_prompts(cfg)
        n_req = len(prompts)
        gc_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9  # float32 draws of the largest tensor included
        n_params = sum(p.numel() for p in params.parameters())
        serve(torch, serving, cfg, params, [prompts[0], prompts[-1]], dev, "auto", max_new=2)  # warm-up
        torch.cuda.reset_peak_memory_stats()

        runs = []
        for _ in range(2):
            ops.reset_launch_counts()
            tc0 = flash_attention.launches_tc
            with M.logged() as log:
                run = serve(torch, serving, cfg, params, prompts, dev, "auto")
            run["launches"] = ops.launch_counts()
            run["launches_tc"] = flash_attention.launches_tc - tc0
            run["dispatch"] = log.summary()
            runs.append(run)
        main = runs[0]
        comps = main["completions"]
        generated = sum(len(c.tokens) for c in comps.values())
        by_len = {n: [r for r, p in enumerate(prompts) if len(p) == n] for n in LM["lengths"]}
        repeat_equal = all(np.array_equal(comps[r].tokens, runs[1]["completions"][r].tokens) for r in comps)
        launches = main["launches"]
        want = cfg.n_layers * n_req if cfg.family == "moe" else 0
        out = {
            "phase": "lm_moe_serve", "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
            "full_depth": get_config(arch).n_layers, "d_model": cfg.d_model, "experts": cfg.moe_num_experts,
            "top_k": cfg.moe_top_k, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
            "init_peak_mem_gb": init_peak,
            "requests": n_req, "max_new_tokens": LM["max_new"], "max_batch": LM["max_batch"],
            "max_seq": LM["max_seq"], "launches": launches, "flash_attention_tensor_core_launches":
            main["launches_tc"], "attention": "flash_attention (GQA prefill)" if cfg.family == "moe"
            else "plain MLA latent scan (chunked_attention, float32), as the reference: no kernel",
            "completed": len(comps), "generated_tokens": generated, "ticks": main["ticks"],
            "wall_s": main["wall_s"], "tok_per_s": generated / main["wall_s"],
            "ttft_s": [main["ttft_s"][r] for r in range(n_req)],
            "mean_prefill_ms": {str(n): float(np.mean([main["prefill_s"][r] for r in rids])) * 1e3
                                for n, rids in by_len.items()},
            "prefill_ms": {str(n): [main["prefill_s"][r] * 1e3 for r in rids] for n, rids in by_len.items()},
            "dropped_share_by_tokens": {str(t): row["dropped_share"] for t, row in main["dispatch"].items()},
            "dispatch_by_tokens": {str(t): row for t, row in main["dispatch"].items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "repeat_tokens_equal": repeat_equal, "repeat_wall_s": runs[1]["wall_s"],
            "repeat_dispatch_equal": runs[1]["dispatch"] == main["dispatch"],
        }
        emit(out)
        if launches["flash_attention"] != want or main["launches_tc"] != want:
            fail(f"{cfg.name}: flash_attention launched {launches['flash_attention']} times "
                 f"({main['launches_tc']} on the tensor cores), not {want}")
        if any(n for name, n in launches.items() if name != "flash_attention"):
            fail(f"{cfg.name}: the LM path launched a segmentation kernel: {launches}")
        if sorted(comps) != list(range(n_req)):
            fail(f"{cfg.name}: completed {sorted(comps)} of {n_req} requests")
        for rid, c in comps.items():
            if len(c.tokens) != LM["max_new"] or c.finish_reason != "length":
                fail(f"{cfg.name} request {rid}: {len(c.tokens)} tokens, finish {c.finish_reason}")
            if not bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()):
                fail(f"{cfg.name} request {rid}: token ids outside the vocabulary")
        if not repeat_equal or not out["repeat_dispatch_equal"]:
            fail(f"{cfg.name}: the second run's tokens or dispatch counts differ from the first's")
        del runs, main, comps
        if cfg.family == "moe":
            flash_launches = {"arch": cfg.name, "n_layers": cfg.n_layers, "launches": launches["flash_attention"],
                              "launches_tensor_cores": out["flash_attention_tensor_core_launches"]}
            moe_kernel_vs_plain(torch, ops, serving, api, cfg, params, prompts, dev)
        if profile:
            profile_lm(torch, api, cfg, params, prompts, dev)
        del params
        gc_cuda(torch)
        moe_card_vs_cpu(torch, cfg, dev)
        gc_cuda(torch)
        emit({"phase": "lm_moe_seconds", "arch": cfg.name, "seconds": time.perf_counter() - t_arch,
              "nvidia_smi": smi_line})
    emit({"phase": "lm_moe_seconds", "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line})
    return flash_launches


def flash_per_prefill(cfg) -> int:
    """``flash_attention`` launches per prefilled request: one per layer of
    a GQA decoder, one per shared-block application of a hybrid, one per
    encoder and decoder layer of an encoder-decoder, none for Mamba2 (or
    MLA)."""
    if cfg.family == "ssm" or cfg.family == "mla_moe":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + cfg.n_layers
    return cfg.n_layers


def family_prompts(torch, cfg, params, dev) -> tuple:
    """LM's prompts for ``cfg`` and each request's extras (``None`` but for
    ``vlm`` and ``encdec``).  A vlm prompt carries ``vision_patches`` ids
    from ``numpy.random.default_rng(1)`` in front, and its
    ``vision_embeds`` (P, D) are those ids' rows of the model's own
    embedding table, on the card: the model's scale, and a prefill equal
    to the one without them (``vlm_splice_check``).  An encdec request
    carries its own frames (encoder_seq, D), standard normal float32 from
    ``numpy.random.default_rng(2)``, on the card."""
    prompts = lm_prompts(cfg)
    if cfg.family == "encdec":
        rng = np.random.default_rng(2)
        frames = [rng.standard_normal((cfg.encoder_seq, cfg.d_model), dtype=np.float32) for _ in prompts]
        return prompts, [{"frames": torch.from_numpy(f).to(dev)} for f in frames]
    if cfg.family != "vlm":
        return prompts, None
    rng = np.random.default_rng(1)
    ids = [rng.integers(0, cfg.vocab_size, cfg.vision_patches).astype(np.int32) for _ in prompts]
    with torch.inference_mode():
        extras = [{"vision_embeds": params.embed[torch.from_numpy(i.astype(np.int64)).to(dev)]} for i in ids]
    return [np.concatenate([i, p]) for i, p in zip(ids, prompts)], extras


def family_kernel_vs_plain(torch, ops, serving, api, cfg, params, dev, max_seq: int) -> dict:
    """The kernel path (flash prefill) against the plain path
    (``backend="torch"``): (b) the served bf16 model, first token equal on
    all but one request (a miss where the plain logits of the two tokens
    lie within one bf16 spacing is a tie and does not count) and cosine at
    least 0.99; (a) a float32 variant at full width,
    ``FAMILY_F32_LAYERS`` deep, through the engine: greedy tokens equal
    and prefill logits within 1e-4 of their largest magnitude (the MoE
    families' form; the element-wise rtol 1e-4 / atol 1e-5 reported too)."""
    import dataclasses

    n_req = LM["per_length"] * len(LM["lengths"])
    prompts, extras = family_prompts(torch, cfg, params, dev)
    logits_k = prefill_last_logits(torch, api, cfg, params, prompts, dev, "auto", extras)
    before = ops.launch_counts()
    logits_p = prefill_last_logits(torch, api, cfg, params, prompts, dev, "torch", extras)
    if ops.launch_counts() != before:
        fail(f"{cfg.name} bf16 check: the plain path launched a kernel")
    res_b = {"layers": cfg.n_layers, "dtype": cfg.param_dtype, **logits_compare_b(torch, logits_k, logits_p)}
    del logits_k, logits_p, extras
    gc_cuda(torch)

    depth = {"n_layers": FAMILY_F32_LAYERS[cfg.name]}
    if cfg.family == "encdec":
        depth["encoder_layers"] = depth["n_layers"]
    cfg_a = dataclasses.replace(cfg, **depth, param_dtype="float32", compute_dtype="float32")
    params_a = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg_a)
    prompts, extras = family_prompts(torch, cfg_a, params_a, dev)
    ops.reset_launch_counts()
    kern_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "auto", max_seq=max_seq, extras=extras)
    launches_a = ops.launch_counts()["flash_attention"]
    plain_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "torch", max_seq=max_seq, extras=extras)
    logits_k = prefill_last_logits(torch, api, cfg_a, params_a, prompts, dev, "auto", extras)
    before = ops.launch_counts()
    logits_p = prefill_last_logits(torch, api, cfg_a, params_a, prompts, dev, "torch", extras)
    if ops.launch_counts() != before or launches_a != flash_per_prefill(cfg_a) * n_req:
        fail(f"{cfg.name} f32 check: plain path launched a kernel, or the kernel path launched {launches_a}")
    tokens_equal = all(np.array_equal(kern_a["completions"][r].tokens, plain_a["completions"][r].tokens)
                       for r in range(n_req))
    res_a = {"layers": cfg_a.n_layers, "encoder_layers": cfg_a.encoder_layers, "dtype": "float32",
             "flash_launches": launches_a,
             "greedy_tokens_equal": tokens_equal, **logits_compare_a(torch, logits_k, logits_p),
             "wall_s": kern_a["wall_s"], "plain_wall_s": plain_a["wall_s"]}
    del params_a, extras, kern_a, plain_a, logits_k, logits_p
    gc_cuda(torch)
    emit({"phase": "lm_families_kernel_vs_plain", "arch": cfg.name, f"f32_{res_a['layers']}_layers": res_a,
          f"bf16_{cfg.n_layers}_layers": res_b})
    check_kernel_vs_plain(f"{cfg.name} ", res_a, res_b)
    return {"f32": res_a, "bf16": res_b}


def vlm_splice_check(torch, api, cfg, params, prompts, extras, dev) -> dict:
    """(d) llava's prefill of the first and the last request with
    ``vision_embeds`` (its own embedding rows of the prompt's first
    ``vision_patches`` ids) equals the prefill without them, logits and
    caches bit for bit, on the card."""
    rows = []
    with torch.inference_mode():
        for r in (0, len(prompts) - 1):
            tokens = torch.from_numpy(prompts[r].astype(np.int64))[None].to(dev)
            l0, c0 = api.prefill(params, {"tokens": tokens}, cfg)
            l1, c1 = api.prefill(params, {"tokens": tokens, "vision_embeds": extras[r]["vision_embeds"][None]}, cfg)
            rows.append({"request": r, "tokens": len(prompts[r]), "logits_equal": bool(torch.equal(l0, l1)),
                         "caches_equal": all(bool(torch.equal(c0[n], c1[n])) for n in c0)})
            del c0, c1
    out = {"phase": "lm_families_vlm_splice", "arch": cfg.name, "patches": cfg.vision_patches,
           "ok": all(r["logits_equal"] and r["caches_equal"] for r in rows), "requests": rows}
    emit(out)
    if not out["ok"]:
        fail(f"{cfg.name}: the prefill with its own embedding rows as patches differs from the one without")
    return out


def close_to_max(torch, got, want) -> dict:
    """Largest error of ``got`` (any device) against ``want`` (CPU), beside
    want's largest magnitude."""
    err = (got.cpu().float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return {"max_abs_err": err, "max_abs": scale, "within_1e-4_of_max_abs": err <= 1e-4 * scale}


def ssd_card_vs_cpu(torch, cfg, dev) -> dict:
    """(c) One float32 ``ssd_forward(return_state=True)`` of a random block
    at ``cfg``'s full width over ``SSD_CHECK_TOKENS`` tokens (numpy seed
    0), on the card and on the CPU, then ``SSD_DECODE_STEPS``
    ``ssd_decode`` steps, each side from its own states: the output, conv
    ring and SSM state of every call within 1e-4 of their largest
    magnitude."""
    import copy
    import dataclasses

    from repro_torch.models import ssm as S

    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    p = S.mamba2_init(torch.Generator(device=dev).manual_seed(1), cfg, torch.float32)
    p_cpu = copy.deepcopy(p).cpu()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, SSD_CHECK_TOKENS, cfg.d_model)).astype(np.float32)
    names = ("out", "conv_state", "ssm_state")
    with torch.inference_mode():
        card = S.ssd_forward(p, torch.from_numpy(x).to(dev), cfg, return_state=True)
        cpu = S.ssd_forward(p_cpu, torch.from_numpy(x), cfg, return_state=True)
        forward = {n: close_to_max(torch, a, b) for n, a, b in zip(names, card, cpu)}
        (_, conv, ssm), (_, conv_c, ssm_c) = card, cpu
        steps = []
        for _ in range(SSD_DECODE_STEPS):
            xt = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
            o, conv, ssm = S.ssd_decode(p, torch.from_numpy(xt).to(dev), cfg, conv, ssm)
            oc, conv_c, ssm_c = S.ssd_decode(p_cpu, torch.from_numpy(xt), cfg, conv_c, ssm_c)
            steps.append({n: close_to_max(torch, a, b) for n, a, b in zip(names, (o, conv, ssm), (oc, conv_c, ssm_c))})
    ok = all(r["within_1e-4_of_max_abs"] for row in [forward] + steps for r in row.values())
    out = {"phase": "lm_families_card_vs_cpu", "what": "ssd_forward + ssd_decode", "arch": cfg.name,
           "d_model": cfg.d_model, "heads": cfg.ssm_heads, "state": cfg.ssm_state, "tokens": SSD_CHECK_TOKENS,
           "chunks": SSD_CHECK_TOKENS // cfg.ssm_chunk, "dtype": "float32", "ok": ok, "forward": forward,
           "decode_max_err_of_max_abs": max(r["max_abs_err"] / r["max_abs"] for row in steps for r in row.values()),
           "decode_steps": steps}
    emit(out)
    if not ok:
        fail(f"{cfg.name}: the card's SSD differs from the CPU's beyond 1e-4 of the largest magnitude")
    return out


def mamba_card_vs_cpu(torch, api, cfg, dev, prompt) -> dict:
    """(c) mamba2 whole in float32 on the card and on the CPU (one set of
    random weights): prefill logits of ``prompt`` within 1e-4 of their
    largest magnitude, and the greedy tokens of the prefill and 8 decode
    steps equal (the CPU's top-1 minus top-2 beside each)."""
    import copy
    import dataclasses

    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg)
    params_cpu = copy.deepcopy(params).cpu()
    tokens = torch.from_numpy(prompt.astype(np.int64))[None]
    toks, toks_cpu, margins, errs = [], [], [], []
    with torch.inference_mode():
        logits, cache = api.prefill(params, {"tokens": tokens.to(dev)}, cfg)
        logits_c, cache_c = api.prefill(params_cpu, {"tokens": tokens}, cfg)
        prefill = close_to_max(torch, logits, logits_c)
        for step in range(SSD_DECODE_STEPS + 1):
            if step:
                errs.append(close_to_max(torch, logits, logits_c)["max_abs_err"])
            toks.append(int(logits[0, -1].argmax()))
            toks_cpu.append(int(logits_c[0, -1].argmax()))
            top2 = logits_c[0, -1].topk(2).values
            margins.append((top2[0] - top2[1]).item())
            if step == SSD_DECODE_STEPS:
                break
            logits, cache = api.decode_step(params, cache, {"tokens": torch.tensor([[toks[-1]]], device=dev)}, cfg)
            logits_c, cache_c = api.decode_step(params_cpu, cache_c, {"tokens": torch.tensor([[toks_cpu[-1]]])}, cfg)
    out = {"phase": "lm_families_card_vs_cpu", "what": "mamba2 whole, prefill and decode", "arch": cfg.name,
           "n_layers": cfg.n_layers, "dtype": "float32", "prompt_tokens": len(prompt), "prefill_logits": prefill,
           "greedy_tokens_equal": toks == toks_cpu, "tokens": toks, "tokens_cpu": toks_cpu,
           "cpu_top1_minus_top2": margins, "decode_logits_max_abs_err": errs}
    emit(out)
    if not prefill["within_1e-4_of_max_abs"]:
        fail(f"{cfg.name}: the card's prefill logits differ from the CPU's by {prefill['max_abs_err']}")
    if toks != toks_cpu:
        fail(f"{cfg.name}: greedy tokens on the card {toks} differ from the CPU's {toks_cpu}")
    return out


def run_lm_families(torch, ops, dev, profile: bool, smi_line: str) -> dict:
    """The ssm, hybrid, vlm and encdec families on the LM path's traffic
    (``LM_FAMILIES``): each model serves the 8 requests twice (the second
    run's tokens bit for bit the first's); zamba2's, llava's and whisper's
    kernel path against their plain path; llava's splice; the SSD, and
    mamba2 whole, card against CPU.  Each model is freed before the next is built.
    Returns each model's flash launches for the ``kernels`` line."""
    import dataclasses

    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models.registry import get_api

    t_phase = time.perf_counter()
    flash_launches = {}
    for arch, n_layers in LM_FAMILIES:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        api = get_api(cfg)
        max_seq = VLM_MAX_SEQ if cfg.family == "vlm" else LM["max_seq"]
        gc_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(p.numel() for p in params.parameters())
        prompts, extras = family_prompts(torch, cfg, params, dev)
        n_req = len(prompts)
        serve(torch, serving, cfg, params, [prompts[0], prompts[-1]], dev, "auto", max_new=2, max_seq=max_seq,
              extras=[extras[0], extras[-1]] if extras else None)  # warm-up
        torch.cuda.reset_peak_memory_stats()

        runs = []
        for _ in range(2):
            ops.reset_launch_counts()
            tc0 = flash_attention.launches_tc
            run = serve(torch, serving, cfg, params, prompts, dev, "auto", max_seq=max_seq, extras=extras)
            run["launches"] = ops.launch_counts()
            run["launches_tc"] = flash_attention.launches_tc - tc0
            runs.append(run)
        main = runs[0]
        comps = main["completions"]
        generated = sum(len(c.tokens) for c in comps.values())
        by_len = {n: [r for r, p in enumerate(prompts) if len(p) == n] for n in sorted({len(p) for p in prompts})}
        repeat_equal = all(np.array_equal(comps[r].tokens, runs[1]["completions"][r].tokens) for r in comps)
        launches = main["launches"]
        want = flash_per_prefill(cfg) * n_req
        want_tc = want if cfg.family in ("vlm", "encdec") else 0
        out = {
            "phase": "lm_families_serve", "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
            "full_depth": get_config(arch).n_layers, "d_model": cfg.d_model, "dtype": cfg.param_dtype,
            "encoder_layers": cfg.encoder_layers, "encoder_seq": cfg.encoder_seq,
            "params": n_params, "init_s": init_s, "init_peak_mem_gb": init_peak, "requests": n_req,
            "prompt_lengths": list(by_len), "patches": cfg.vision_patches if extras else 0,
            "max_new_tokens": LM["max_new"], "max_batch": LM["max_batch"], "max_seq": max_seq,
            "launches": launches, "flash_attention_tensor_core_launches": main["launches_tc"],
            "attention": {"ssm": "none: chunked SSD, plain PyTorch as the reference's",
                          "hybrid": "flash_attention (shared block, D = 80: CUDA-core kernel)",
                          "vlm": "flash_attention (GQA prefill, group 7: tensor-core kernel)",
                          "encdec": "flash_attention (encoder bidirectional at S = 1500 and decoder prefill "
                                    "causal, D = 64: tensor-core kernel); cross-attention and decode: plain "
                                    "chunked_attention, as the reference"}[cfg.family],
            "completed": len(comps), "generated_tokens": generated, "ticks": main["ticks"],
            "wall_s": main["wall_s"], "tok_per_s": generated / main["wall_s"],
            "ttft_s": [main["ttft_s"][r] for r in range(n_req)],
            "mean_prefill_ms": {str(n): float(np.mean([main["prefill_s"][r] for r in rids])) * 1e3
                                for n, rids in by_len.items()},
            "prefill_ms": {str(n): [main["prefill_s"][r] * 1e3 for r in rids] for n, rids in by_len.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "repeat_tokens_equal": repeat_equal, "repeat_wall_s": runs[1]["wall_s"],
            "repeat_tok_per_s": generated / runs[1]["wall_s"],
        }
        emit(out)
        if launches["flash_attention"] != want or main["launches_tc"] != want_tc:
            fail(f"{cfg.name}: flash_attention launched {launches['flash_attention']} times "
                 f"({main['launches_tc']} on the tensor cores), not {want} ({want_tc})")
        if any(n for name, n in launches.items() if name != "flash_attention"):
            fail(f"{cfg.name}: the LM path launched a segmentation kernel: {launches}")
        if sorted(comps) != list(range(n_req)):
            fail(f"{cfg.name}: completed {sorted(comps)} of {n_req} requests")
        for rid, c in comps.items():
            if len(c.tokens) != LM["max_new"] or c.finish_reason != "length":
                fail(f"{cfg.name} request {rid}: {len(c.tokens)} tokens, finish {c.finish_reason}")
            if not bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()):
                fail(f"{cfg.name} request {rid}: token ids outside the vocabulary")
        if not repeat_equal:
            fail(f"{cfg.name}: the second run's tokens differ from the first's")
        flash_launches[cfg.name] = {"n_layers": cfg.n_layers, "launches": launches["flash_attention"],
                                    "launches_tensor_cores": main["launches_tc"]}
        if cfg.family == "encdec":
            flash_launches[cfg.name]["encoder_layers"] = cfg.encoder_layers
        del runs, main, comps
        if cfg.family == "vlm":
            vlm_splice_check(torch, api, cfg, params, prompts, extras, dev)
        if cfg.family != "ssm":
            family_kernel_vs_plain(torch, ops, serving, api, cfg, params, dev, max_seq)
        if profile:
            profile_lm(torch, api, cfg, params, prompts, dev, max_seq, extras[-1] if extras else None)
        del params, extras
        gc_cuda(torch)
        if cfg.family in ("ssm", "hybrid"):
            ssd_card_vs_cpu(torch, cfg, dev)
        if cfg.family == "ssm":
            mamba_card_vs_cpu(torch, api, cfg, dev, prompts[-1])
        gc_cuda(torch)
        emit({"phase": "lm_families_seconds", "arch": cfg.name, "seconds": time.perf_counter() - t_arch,
              "nvidia_smi": smi_line})
    emit({"phase": "lm_families_seconds", "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi_line})
    return flash_launches


def train_memory(cfg, n_params: int, batch: int, seq: int) -> dict:
    """The train state's memory reckoned before the run (GB): bf16
    parameters, float32 master, m and v, gradients in the parameters'
    dtype (and the float32 copy of the largest one the update makes), the
    float32 logits of one loss chunk, and the activations the ``dots``
    remat keeps: per layer its input and the matrix products' outputs
    (q, k, v, the attention projection, gate, up, down), in the compute
    dtype."""
    elt = 2 if cfg.param_dtype == "bfloat16" else 4
    tokens = batch * seq
    chunk = min(cfg.logit_chunk, seq)
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
    per_layer = tokens * (d + cfg.n_heads * cfg.head_dim + 2 * kv + d + 2 * cfg.d_ff + d) * elt
    gb = lambda b: b / 1e9
    out = {"params_gb": gb(n_params * elt), "master_m_v_gb": gb(n_params * 12),
           "grads_gb": gb(n_params * elt), "logits_chunk_gb": gb(batch * chunk * cfg.vocab_size * 4),
           "activations_gb": gb(per_layer * cfg.n_layers)}
    out["total_gb"] = sum(out.values())
    return out


def train_state_to(torch, state, dev):
    """A train state built on the CPU, moved to ``dev`` (the model in place)."""
    from repro_torch.training.optimizer import AdamWState

    o = state["opt"]
    move = lambda d: None if d is None else {n: t.to(dev) for n, t in d.items()}
    return {"params": state["params"].to(dev), "opt": AdamWState(o.step, move(o.m), move(o.v), move(o.master))}


def recording(step_fn, last: dict):
    """``step_fn`` that keeps the newest state in ``last["state"]``
    (``run_training`` does not return it)."""
    def step(state, batch):
        last["state"], metrics = step_fn(state, batch)
        return last["state"], metrics

    return step


def projection_grads(torch, api, cfg, params, batch) -> dict:
    """One loss and backward pass: the layers whose wq, wk and wv all have
    a non-zero gradient."""
    loss = api.loss(params, batch, cfg)
    loss.backward()
    ok = sum(all(lp.attn[w].grad is not None and bool(lp.attn[w].grad.abs().sum() > 0) for w in ("wq", "wk", "wv"))
             for lp in params.layers)
    for p in params.parameters():
        p.grad = None
    return {"layers": len(params.layers), "layers_with_wq_wk_wv_grads": ok}


def train_whole(torch, ops, dev, profile: bool, smi_line: str) -> dict:
    """(a) qwen2-1.5b whole: ``launch.train.build`` and ``run_training``
    for ``TRAIN["steps"]`` steps with a checkpoint directory under
    ``build/``.  Returns the flash launches for the ``kernels`` line."""
    import shutil

    from repro_torch.kernels import flash_attention
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_api
    from repro_torch.training.fault import run_training

    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    t0 = time.perf_counter()
    cfg, state, step_fn, make_batch = launch_train.build(TRAIN["arch"], reduced=False, batch=b, seq=s, steps=steps,
                                                         lr=TRAIN["lr"], seed=TRAIN["seed"], device=dev)
    torch.cuda.synchronize()
    api = get_api(cfg)
    params = state["params"]
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "train_model", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": n_params, "param_dtype": cfg.param_dtype,
          "remat_policy": cfg.remat_policy, "batch": b, "seq": s, "tokens_per_step": b * s,
          "init_s": time.perf_counter() - t0, "reckoned": train_memory(cfg, n_params, b, s),
          "allocated_after_init_gb": torch.cuda.memory_allocated() / 1e9})

    # the flash launches of one forward pass, then the run
    ops.reset_launch_counts()
    loss = api.loss(params, make_batch(0), cfg)
    forward = ops.launch_counts()["flash_attention"]
    del loss
    ckpt = TRAIN_CKPT_DIR / "a"
    shutil.rmtree(ckpt, ignore_errors=True)
    last = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = run_training(step_fn=recording(step_fn, last), state=state, make_batch=make_batch, num_steps=steps,
                          ckpt_dir=str(ckpt), ckpt_every=steps, log_every=0, log_fn=lambda line: None)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    tc = flash_attention.launches_tc
    peak = torch.cuda.max_memory_allocated() / 1e9
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    timed = report.step_seconds[TRAIN_TIMED_STEPS]
    med = spread(timed)
    losses = report.losses
    ln_v = math.log(cfg.vocab_size)
    per_step = launches["flash_attention"] / steps
    want_per_step = forward * (1 if cfg.remat_policy == "none" else 2)
    out = {"phase": "train_run", "arch": cfg.name, "steps": steps, "losses": losses,
           "step_ms": [t * 1e3 for t in report.step_seconds],
           "step_ms_median_3_to_8": med["median"] * 1e3, "step_ms_spread_3_to_8": {k: v * 1e3 if k != "n" else v
                                                                                  for k, v in med.items()},
           "tokens_per_s": b * s / med["median"], "peak_gb": peak,
           "flash_launches": launches["flash_attention"], "flash_launches_per_step": per_step,
           "flash_forward_per_step": forward, "flash_remat_recompute_per_step": per_step - forward,
           "flash_tensor_core_launches": tc, "other_kernel_launches": {k: n for k, n in launches.items()
                                                                        if k != "flash_attention"},
           "checkpoint": {"dir": str(ckpt.relative_to(ROOT)), "committed_step": report.last_step,
                          "bytes": ckpt_bytes, "outside_steps_s": wall - sum(report.step_seconds),
                          "saves": report.checkpoints},
           "wall_s": wall, "nvidia_smi": smi_line}
    emit(out)
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: a loss is not finite: {losses}")
    if not 0.5 * ln_v < losses[0] < 2.5 * ln_v:
        fail(f"train: step 0's loss {losses[0]} outside (0.5, 2.5) * ln V = ({0.5 * ln_v}, {2.5 * ln_v})")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"train: the loss did not fall over {steps} steps: {losses}")
    if per_step != want_per_step or forward != cfg.n_layers:
        fail(f"train: {per_step} flash launches a step ({forward} forward), not {want_per_step}")
    if tc != launches["flash_attention"]:
        fail(f"train: {tc} of {launches['flash_attention']} flash launches on the tensor cores")
    if any(out["other_kernel_launches"].values()):
        fail(f"train: the training path launched a segmentation kernel: {launches}")
    if report.last_step != steps or not ckpt_bytes:
        fail(f"train: run_training stopped at {report.last_step}, checkpoint of {ckpt_bytes} bytes")

    grads = projection_grads(torch, api, cfg, params, make_batch(0))
    if grads["layers_with_wq_wk_wv_grads"] != grads["layers"]:
        fail(f"train: wq, wk, wv have gradients in {grads['layers_with_wq_wk_wv_grads']} of {grads['layers']} layers")
    result = {"launches": launches["flash_attention"], "launches_tc": tc, "per_step": per_step,
              "forward_per_step": forward, "projection_grads": grads, "run": out}
    if profile:
        batch = make_batch(steps)
        state = last["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        step_s = time.perf_counter() - t0
        prof = device_profile(torch, lambda: float(step_fn(state, batch)[1]["loss"]), match=("flash_attention",))
        emit({"phase": "profile", "what": "one qwen2-1.5b training step (B=8, S=512)", "step_s_unprofiled": step_s,
              "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / step_s, **prof})
        result["profile"] = {"device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / step_s,
                             "flash_forward_device_us": prof["matched"]["flash_attention"]}
        # the optimizer alone: one adamw_update of the whole state (zero gradients)
        from repro_torch.training.optimizer import AdamWConfig, adamw_update

        zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
        update = lambda: adamw_update(zeros, state["opt"], params, AdamWConfig())
        update()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t0
        oprof = device_profile(torch, update)
        emit({"phase": "profile", "what": "one adamw_update of qwen2-1.5b's state", "update_s_unprofiled": opt_s,
              "device_idle_share": 1.0 - oprof["device_busy_us"] * 1e-6 / opt_s, **oprof})
        result["profile"]["optimizer_s"] = opt_s
        result["profile"]["optimizer_device_us"] = oprof["device_busy_us"]
        del zeros
    del state, params, last
    shutil.rmtree(ckpt, ignore_errors=True)
    gc_cuda(torch)
    return result


def train_flash_autograd(torch, ops, dev, profile: bool) -> dict:
    """(b) ``flash_attention`` under autograd at training's two shapes: the
    kernel route's dq, dk, dv against autograd through the plain version
    on the same inputs and output gradient (bit for bit: the backward is
    the same plain recompute), and the forward against the plain forward.
    With ``profile``: the device time of the kernel forward against the
    plain-recompute backward, per call."""
    from repro_torch.kernels import ref

    rows = []
    for shape, causal in ((TRAIN_FLASH_SHAPE, True), (FLASH_WHISPER_ENCODER, False)):
        q, k, v = (t.requires_grad_(True) for t in flash_inputs(torch, shape, "bfloat16", dev, seed=7))
        rng = np.random.default_rng(8)
        d_out = torch.from_numpy(rng.standard_normal(tuple(q.shape), dtype=np.float32)).to(dev, torch.bfloat16)
        ops.reset_launch_counts()
        out = ops.flash_attention(q, k, v, causal=causal)
        got = torch.autograd.grad(out, (q, k, v), d_out)
        launched = ops.launch_counts()["flash_attention"]
        plain_out = ref.flash_attention(q, k, v, causal=causal)
        want = torch.autograd.grad(plain_out, (q, k, v), d_out)
        diffs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
        row = {"phase": "train_flash_autograd", "shape": list(shape), "causal": causal,
               "grads_bit_equal": all(torch.equal(a, w) for a, w in zip(got, want)),
               "max_abs_diff_dq_dk_dv": diffs, "forward_launches": launched,
               "forward_max_abs_err": (out.float() - plain_out.float()).abs().max().item()}
        if profile:
            fwd = device_profile(torch, lambda: [ops.flash_attention(q.detach(), k.detach(), v.detach(),
                                                                     causal=causal) for _ in range(10)])
            again = ops.flash_attention(q, k, v, causal=causal)
            bwd = device_profile(torch, lambda: [torch.autograd.grad(again, (q, k, v), d_out, retain_graph=True)
                                                 for _ in range(10)])
            del again
            row["forward_device_ms"] = fwd["device_busy_us"] / 10 * 1e-3
            row["backward_device_ms"] = bwd["device_busy_us"] / 10 * 1e-3
        emit(row)
        rows.append(row)
        if launched != 1:
            fail(f"flash under autograd at {shape}: {launched} kernel launches in the forward, not 1")
        if not row["grads_bit_equal"]:
            fail(f"flash under autograd at {shape}: dq, dk, dv differ from the plain version's by {diffs}")
        if row["forward_max_abs_err"] > FLASH_TOL["bfloat16"]:
            fail(f"flash under autograd at {shape}: forward err {row['forward_max_abs_err']}")
        del q, k, v, out, got, want, plain_out
    return {"shapes": rows}


def train_steps(torch, step_fn, state, make_batch, n: int) -> tuple:
    """``n`` steps: (losses, grad norms, state)."""
    losses, norms = [], []
    for i in range(n):
        state, metrics = step_fn(state, make_batch(i))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, state


def rel_diff(a: list, b: list) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def train_kernel_vs_plain(torch, ops, dev) -> dict:
    """(c) qwen2-1.5b at full width, 4 layers, float32: ``TRAIN_CHECK_STEPS``
    steps on the kernel route and on the plain route (``backend="torch"``)
    from the same state: losses and grad norms within ``TRAIN_TOL``."""
    from repro_torch.launch import train as launch_train

    runs = {}
    for route, backend in (("kernel", None), ("plain", "torch")):
        cfg, state, step_fn, make_batch = launch_train.build(
            TRAIN["arch"], reduced=False, n_layers=TRAIN_CHECK_LAYERS, batch=TRAIN["batch"], seq=TRAIN["seq"],
            steps=TRAIN_CHECK_STEPS, seed=TRAIN["seed"], device=dev, backend=backend,
            param_dtype="float32", compute_dtype="float32")
        ops.reset_launch_counts()
        losses, norms, state = train_steps(torch, step_fn, state, make_batch, TRAIN_CHECK_STEPS)
        runs[route] = {"losses": losses, "grad_norms": norms,
                       "flash_launches": ops.launch_counts()["flash_attention"]}
        del state
        gc_cuda(torch)
    out = {"phase": "train_kernel_vs_plain", "layers": TRAIN_CHECK_LAYERS, "dtype": "float32", **runs,
           "loss_rel_diff": rel_diff(runs["kernel"]["losses"], runs["plain"]["losses"]),
           "grad_norm_rel_diff": rel_diff(runs["kernel"]["grad_norms"], runs["plain"]["grad_norms"])}
    emit(out)
    want = TRAIN_CHECK_STEPS * 2 * TRAIN_CHECK_LAYERS
    if runs["kernel"]["flash_launches"] != want or runs["plain"]["flash_launches"]:
        fail(f"train (c): flash launches {runs['kernel']['flash_launches']} (kernel route, want {want}), "
             f"{runs['plain']['flash_launches']} (plain route, want 0)")
    if out["loss_rel_diff"] > TRAIN_TOL or out["grad_norm_rel_diff"] > TRAIN_TOL:
        fail(f"train (c): kernel and plain routes differ: losses {out['loss_rel_diff']}, "
             f"grad norms {out['grad_norm_rel_diff']}")
    return out


def train_card_vs_cpu(torch, dev) -> dict:
    """(d) every family's reduced config, float32: ``TRAIN_CHECK_STEPS``
    steps from one state built on the CPU, on the card and on the CPU:
    losses within ``TRAIN_TOL`` (relative), all finite."""
    from repro_torch.launch import train as launch_train

    rows = {}
    for arch in TRAIN_FAMILY_ARCHS:
        mk = lambda: launch_train.build(arch, reduced=True, steps=TRAIN_CHECK_STEPS, seed=TRAIN["seed"],
                                        device="cpu", **TRAIN_FAMILY_SHAPE)
        cfg, cpu_state, step_fn, cpu_batch = mk()
        card_state = train_state_to(torch, mk()[1], dev)
        card_batch = lambda i: {k: t.to(dev) for k, t in cpu_batch(i).items()}
        cpu = train_steps(torch, step_fn, cpu_state, cpu_batch, TRAIN_CHECK_STEPS)[0]
        card = train_steps(torch, step_fn, card_state, card_batch, TRAIN_CHECK_STEPS)[0]
        rows[arch] = {"family": cfg.family, "card": card, "cpu": cpu, "rel_diff": rel_diff(card, cpu)}
    emit({"phase": "train_card_vs_cpu", "dtype": "float32", "families": rows})
    for arch, row in rows.items():
        if not all(math.isfinite(x) for x in row["card"] + row["cpu"]) or row["rel_diff"] > TRAIN_TOL:
            fail(f"train (d) {arch}: card {row['card']} against CPU {row['cpu']}")
    return rows


def train_resume(torch, dev) -> dict:
    """(e) qwen2-1.5b at full width, 4 layers (bf16): ``TRAIN_RESUME["steps"]``
    uninterrupted steps, then a run in a fresh checkpoint directory that
    crashes after step ``crash_at_step`` (checkpoints every ``ckpt_every``)
    and its restart: the restart resumes from the last commit, and its
    losses and final state equal the uninterrupted run's bit for bit."""
    import shutil

    from repro_torch.launch import train as launch_train
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.fault import run_training

    r = TRAIN_RESUME
    mk = lambda: launch_train.build(TRAIN["arch"], reduced=False, n_layers=TRAIN_CHECK_LAYERS, batch=TRAIN["batch"],
                                    seq=TRAIN["seq"], steps=r["steps"], seed=TRAIN["seed"], device=dev)
    quiet = {"log_every": 0, "log_fn": lambda line: None}
    _, state, step_fn, make_batch = mk()
    ref_last = {}
    ref = run_training(step_fn=recording(step_fn, ref_last), state=state, make_batch=make_batch,
                       num_steps=r["steps"], **quiet)
    ckpt = TRAIN_CKPT_DIR / "e"
    shutil.rmtree(ckpt, ignore_errors=True)
    _, state, step_fn, make_batch = mk()
    try:
        run_training(step_fn=step_fn, state=state, make_batch=make_batch, num_steps=r["steps"], ckpt_dir=str(ckpt),
                     ckpt_every=r["ckpt_every"], crash_at_step=r["crash_at_step"], **quiet)
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    else:
        fail("train (e): the injected crash did not happen")
    del state
    gc_cuda(torch)
    committed = CK.latest_step(ckpt)
    _, state, step_fn, make_batch = mk()
    last = {}
    t0 = time.perf_counter()
    rep = run_training(step_fn=recording(step_fn, last), state=state, make_batch=make_batch, num_steps=r["steps"],
                       ckpt_dir=str(ckpt), ckpt_every=r["ckpt_every"], **quiet)
    restart_s = time.perf_counter() - t0
    a, b = CK.state_leaves(last["state"]), CK.state_leaves(ref_last["state"])
    state_equal = [n for n, _ in a] == [n for n, _ in b] and all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    out = {"phase": "train_resume", "layers": TRAIN_CHECK_LAYERS, **r, "committed_before_restart": committed,
           "resumed_from": rep.resumed_from, "losses_uninterrupted": ref.losses, "losses_restart": rep.losses,
           "losses_bit_equal": rep.losses == ref.losses[committed:] if committed is not None else False,
           "final_state_bit_equal": state_equal, "restart_s": restart_s,
           "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}
    emit(out)
    shutil.rmtree(ckpt, ignore_errors=True)
    if committed != r["crash_at_step"] - 1 or rep.resumed_from != committed:
        fail(f"train (e): committed {committed}, resumed from {rep.resumed_from}")
    if not out["losses_bit_equal"] or not state_equal:
        fail(f"train (e): the restart's losses {rep.losses} or state differ from {ref.losses}")
    return out


def run_train(torch, ops, dev, profile: bool, smi_line: str) -> dict:
    """The training path: (a) qwen2-1.5b whole, (b) flash under autograd,
    (c) kernel against plain at full width, (d) card against CPU for every
    family, (e) crash and resume.  (d) and (e) run under
    ``torch.use_deterministic_algorithms(True)``: the backward passes of
    the embedding gather and of the MoE dispatch's gathers accumulate by
    atomics otherwise."""
    t0 = time.perf_counter()
    whole = train_whole(torch, ops, dev, profile, smi_line)
    autograd = train_flash_autograd(torch, ops, dev, profile)
    gc_cuda(torch)
    kvp = train_kernel_vs_plain(torch, ops, dev)
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        card_cpu = train_card_vs_cpu(torch, dev)
        resume = train_resume(torch, dev)
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    gc_cuda(torch)
    seconds = time.perf_counter() - t0
    emit({"phase": "train_seconds", "seconds": seconds, "nvidia_smi": smi_line})
    return {"whole": whole, "autograd": autograd, "kernel_vs_plain": kvp, "card_vs_cpu": card_cpu,
            "resume": resume, "seconds": seconds}


def synced_ms(torch, fn) -> float:
    """Host ms of ``fn()`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def parallel_train(torch, ops, dev, mesh_mod, PC, profile: bool) -> dict:
    """(a) qwen2-1.5b whole: ``PARALLEL["steps"]`` steps on one device, then
    the same through the mesh branch at (data=1, model=1) from the same
    seed, launch counts and peak memory of the mesh run alone; losses,
    grad norms and every parameter bit for bit.  Then the mesh layer's
    own parts alone (with ``profile``, also traced).  Returns the mesh
    state for (e)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainStepConfig

    cfg = get_config(PARALLEL["arch"])
    ts = TrainStepConfig(optimizer=AdamWConfig(**PARALLEL["optimizer"]), seed=PARALLEL["seed"])
    batches = PC.batches(cfg, PARALLEL["batch"], PARALLEL["seq"], PARALLEL["steps"], dev)
    gc_cuda(torch)
    single = PC.train_run(cfg, None, ts, batches, dev)
    whole = {n: p.detach().to("cpu", copy=True) for n, p in PC.param_blocks(single["state"]).items()}
    del single["state"]
    gc_cuda(torch)
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    meshed = PC.train_run(cfg, mesh, ts, batches, dev)
    launches = ops.launch_counts()
    tc = flash_attention.launches_tc
    peak = torch.cuda.max_memory_allocated() / 1e9
    blocks = PC.param_blocks(meshed["state"])
    unequal = [n for n, b in blocks.items() if not torch.equal(b.to("cpu"), whole[n])]
    # the mesh layer's own parts, alone: the gather of every block into the
    # work model, and the reduction of a whole set of work gradients
    sp = meshed["state"]["params"]
    grads = {n: p.detach().clone() for n, p in sp.model.named_parameters()}
    overhead = {"gather_ms": [synced_ms(torch, sp.gather) for _ in range(3)],
                "reduce_grads_ms": [synced_ms(torch, lambda: sp.reduce_grads(grads)) for _ in range(3)]}
    if profile:
        for what, fn in (("gather", sp.gather), ("reduce_grads", lambda: sp.reduce_grads(grads))):
            prof = device_profile(torch, fn)
            emit({"phase": "profile", "what": f"the mesh layer's {what} of qwen2-1.5b (one rank)", **prof})
            overhead[f"{what}_device_us"] = prof["device_busy_us"]
    del grads, sp
    per_step = launches["flash_attention"] / PARALLEL["steps"]
    out = {"phase": "parallel_train", "arch": cfg.name, "mesh": {"data": 1, "model": 1}, "n_layers": cfg.n_layers,
           "batch": PARALLEL["batch"], "seq": PARALLEL["seq"], "steps": PARALLEL["steps"],
           "single": {k: single[k] for k in ("losses", "grad_norms", "step_ms")},
           "mesh_run": {k: meshed[k] for k in ("losses", "grad_norms", "step_ms")},
           "losses_bit_equal": meshed["losses"] == single["losses"],
           "grad_norms_bit_equal": meshed["grad_norms"] == single["grad_norms"],
           "params": len(blocks), "params_not_bit_equal": unequal, "peak_gb_mesh_run": peak, **overhead,
           "flash_launches": launches["flash_attention"], "flash_launches_per_step": per_step,
           "flash_tensor_core_launches": tc,
           "other_kernel_launches": {k: n for k, n in launches.items() if k != "flash_attention"},
           "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}
    emit(out)
    if not (out["losses_bit_equal"] and out["grad_norms_bit_equal"]) or unequal:
        fail(f"parallel (a): the mesh step differs from the single-device step: {out['mesh_run']} against "
             f"{out['single']}, parameters {unequal[:5]}")
    if per_step != 2 * cfg.n_layers or tc != launches["flash_attention"] or any(out["other_kernel_launches"].values()):
        fail(f"parallel (a): {launches} launches ({tc} on the tensor cores), want {2 * cfg.n_layers} flash a step")
    return {"row": out, "state": meshed["state"], "specs": meshed["specs"], "mesh": mesh, "cfg": cfg, "ts": ts,
            "launches": launches["flash_attention"], "launches_tc": tc, "per_step": per_step}


def parallel_checkpoint(torch, dev, a: dict) -> dict:
    """(e) (a)'s state saved with its specs under the mesh, restored into
    a state built from another seed: every block, moment and master bit
    for bit, the manifest's spec strings ``state_specs``'."""
    import dataclasses
    import json
    import shutil

    from repro_torch.training import checkpoint as CK
    from repro_torch.training.train_step import make_sharded_train_state, state_specs

    shutil.rmtree(PARALLEL_CKPT_DIR, ignore_errors=True)
    state, mesh = a["state"], a["mesh"]
    t0 = time.perf_counter()
    final = CK.save_checkpoint(PARALLEL_CKPT_DIR, PARALLEL["steps"], state, specs=a["specs"], mesh=mesh)
    save_s = time.perf_counter() - t0
    like, _ = make_sharded_train_state(a["cfg"], mesh, dataclasses.replace(a["ts"], seed=PARALLEL["seed"] + 1),
                                       device=dev)
    t0 = time.perf_counter()
    step, restored, _ = CK.restore_checkpoint(PARALLEL_CKPT_DIR, like)
    restore_s = time.perf_counter() - t0
    pairs = [("params", state["params"].blocks, restored["params"].blocks)]
    pairs += [(f, getattr(state["opt"], f), getattr(restored["opt"], f)) for f in ("m", "v", "master")]
    unequal = [f"{f}:{n}" for f, want, got in pairs for n in want if not torch.equal(want[n], got[n])]
    manifest = json.loads((final / "manifest.json").read_text())
    specs = {e["name"]: e["spec"] for e in manifest["leaves"]}
    want_specs = CK.spec_strings(state_specs(a["cfg"], a["ts"].optimizer, mesh))
    out = {"phase": "parallel_checkpoint", "step": step, "save_s": save_s, "restore_s": restore_s,
           "bytes": sum(f.stat().st_size for f in final.iterdir()), "leaves": len(specs),
           "mesh_shape": manifest["mesh_shape"], "not_bit_equal": unequal[:10],
           "spec_strings_equal": specs == want_specs, "spec_example": specs.get("params_layers_attn_wq")}
    emit(out)
    del like, restored
    shutil.rmtree(PARALLEL_CKPT_DIR, ignore_errors=True)
    if unequal or step != PARALLEL["steps"] or not out["spec_strings_equal"]:
        fail(f"parallel (e): restored step {step}, {len(unequal)} leaves differ, spec strings equal: "
             f"{out['spec_strings_equal']}")
    return out


def parallel_codecs(torch, dev, mesh_mod, PC, a: dict) -> dict:
    """(b) one step through each codec at (pod=1, data=1, model=1) from
    (a)'s seed, against (a)'s first step (no codec): the loss within 1e-3,
    the grad norm within ``PARALLEL_CODEC_BOUNDS``."""
    import dataclasses

    mesh = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"))
    batch = PC.batches(a["cfg"], PARALLEL["batch"], PARALLEL["seq"], 1, dev)
    none = {"loss": a["row"]["mesh_run"]["losses"][0], "grad_norm": a["row"]["mesh_run"]["grad_norms"][0]}
    rows = {}
    for codec, bound in PARALLEL_CODEC_BOUNDS.items():
        gc_cuda(torch)
        run = PC.train_run(a["cfg"], mesh, dataclasses.replace(a["ts"], grad_codec=codec), batch, dev)
        del run["state"]
        rows[codec] = {"loss": run["losses"][0], "grad_norm": run["grad_norms"][0], "step_ms": run["step_ms"][0],
                       "loss_abs_diff": abs(run["losses"][0] - none["loss"]),
                       "grad_norm_rel_diff": abs(run["grad_norms"][0] - none["grad_norm"]) / none["grad_norm"],
                       "bound": bound}
    gc_cuda(torch)
    out = {"phase": "parallel_codecs", "mesh": {"pod": 1, "data": 1, "model": 1}, "none": none, **rows}
    emit(out)
    for codec, row in rows.items():
        if row["loss_abs_diff"] >= 1e-3 or row["grad_norm_rel_diff"] >= row["bound"]:
            fail(f"parallel (b) {codec}: {row} against {none}")
    return out


def parallel_ep(torch, dev, mesh_mod, PC) -> dict:
    """(c) qwen3-moe at full width, ``PARALLEL_EP["n_layers"]`` layers: the
    loss and every gradient through the EP branch at (data=1, model=1)
    against the model without a mesh, bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config

    gc_cuda(torch)
    cfg = dataclasses.replace(get_config(PARALLEL_EP["arch"]), n_layers=PARALLEL_EP["n_layers"])
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
    batch = PC.batches(cfg, PARALLEL_EP["batch"], PARALLEL_EP["seq"], 1, dev)[0]
    res = PC.ep_check(cfg, mesh, dev, batch, seed=PARALLEL["seed"])
    out = {"phase": "parallel_ep", "arch": cfg.name, "n_layers": cfg.n_layers, "experts": cfg.moe_num_experts,
           "batch": PARALLEL_EP["batch"], "seq": PARALLEL_EP["seq"], **res}
    emit(out)
    gc_cuda(torch)
    if not res["loss_bit_equal"] or res["grads_bit_equal"] != res["grads"] or not res["expert_leaves_cut"]:
        fail(f"parallel (c): the EP branch differs from the path without a mesh: {res}")
    return out


def parallel_sp(torch, dev, mesh_mod, PC) -> dict:
    """(d) SP decode on a (model=1) mesh against the decode without one, at
    qwen2-1.5b's attention width and deepseek-v2-lite's latent width in
    float32: outputs within ``PARALLEL_SP["tol"]``, caches bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config

    f32 = lambda name: dataclasses.replace(get_config(name), param_dtype="float32", compute_dtype="float32")
    mesh = mesh_mod.make_mesh((1,), ("model",))
    res = PC.sp_check(f32("qwen2-1.5b"), f32("deepseek-v2-lite-16b"), mesh, dev, batch=PARALLEL_SP["batch"],
                      max_seq=PARALLEL_SP["max_seq"], t=PARALLEL_SP["t"])
    out = {"phase": "parallel_sp", **{k: PARALLEL_SP[k] for k in ("batch", "max_seq", "t", "tol")}, **res}
    emit(out)
    for kind in ("gqa", "mla"):
        if res[kind]["max_abs_err"] > PARALLEL_SP["tol"] or res[kind]["cache_max_abs_err"] != 0.0:
            fail(f"parallel (d) {kind}: {res[kind]}")
    return out


def parallel_multi_card(torch) -> dict:
    """(f) with two or more cards, (a) at ``PARALLEL_MULTI["n_layers"]``
    layers on (data=2), (c) and (d) on (model=2), over 2 NCCL ranks: each
    rank's mesh run within ``PARALLEL_MULTI["tol"]`` of its single-device
    run, SP within ``PARALLEL_SP["tol"]``.  Otherwise one line saying so."""
    import shutil

    from repro_torch.testing import ranks

    count = torch.cuda.device_count()
    if count < 2:
        out = {"parallel_multi_card": "not run", "count": count}
        emit(out)
        return out
    payload = {"train": {"arch": PARALLEL["arch"], "n_layers": PARALLEL_MULTI["n_layers"], "batch": PARALLEL["batch"],
                         "seq": PARALLEL["seq"], "steps": PARALLEL_MULTI["steps"], "optimizer": PARALLEL["optimizer"]},
               "ep": PARALLEL_EP, "sp": {k: PARALLEL_SP[k] for k in ("batch", "max_seq", "t")}}
    workdir = ROOT / "build" / "parallel_ranks"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    res = ranks.run_ranks(ranks.parallel_card, 2, workdir, payload, timeout=600, backend="nccl")
    out = {"phase": "parallel_multi_card", "count": count, "ranks": res}
    emit(out)
    for rank, r in enumerate(res):
        tr, ep = r["train"], r["ep"]
        if max(tr["loss_rel_diff"], tr["grad_norm_rel_diff"]) > PARALLEL_MULTI["tol"]:
            fail(f"parallel (f) rank {rank}: the (data=2) step against one device: {tr}")
        if abs(ep["loss_ep"] - ep["loss"]) > PARALLEL_MULTI["tol"] * abs(ep["loss"]):
            fail(f"parallel (f) rank {rank}: EP over 2 ranks: {ep}")
        if max(r["sp"][k]["max_abs_err"] for k in ("gqa", "mla")) > PARALLEL_SP["tol"]:
            fail(f"parallel (f) rank {rank}: SP over 2 ranks: {r['sp']}")
    return out


def run_parallel(torch, ops, dev, profile: bool, smi_line: str) -> dict:
    """The parallel path over a one-rank NCCL group: (a), (e), (b), (c),
    (d) under ``torch.use_deterministic_algorithms(True)``, as the train
    phase's (d) and (e) are; then (f)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.testing import parallel_checks as PC

    t0 = time.perf_counter()
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        a = parallel_train(torch, ops, dev, mesh_mod, PC, profile)
        e = parallel_checkpoint(torch, dev, a)
        b = parallel_codecs(torch, dev, mesh_mod, PC, a)
        a_row = a["row"]
        counts = {k: a[k] for k in ("launches", "launches_tc", "per_step")}
        del a
        c = parallel_ep(torch, dev, mesh_mod, PC)
        d = parallel_sp(torch, dev, mesh_mod, PC)
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    gc_cuda(torch)
    f = parallel_multi_card(torch)
    seconds = time.perf_counter() - t0
    emit({"phase": "parallel_seconds", "seconds": seconds, "nvidia_smi": smi_line})
    return {"train": a_row, "checkpoint": e, "codecs": b, "ep": c, "sp": d, "multi_card": f, "seconds": seconds,
            **counts}


def flash_sass_hgmma() -> dict:
    """Count ``HGMMA`` (wgmma) instructions in the built flash_attention
    library's SASS with ``cuobjdump``; empty where the tool is absent."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._target("flash_attention"))],
                          capture_output=True, text=True, timeout=120).stdout
    return {"hgmma_in_sass": sum(line.count("HGMMA") for line in sass.splitlines())}


def ptxas_report(name: str) -> dict:
    """Registers, stack and spills of each kernel in ``csrc/<name>.cu``
    from the ``-Xptxas=-v`` report kept beside its library."""
    import re

    from repro_torch.kernels import _build

    log = _build._target(name).with_suffix(".log").read_text()
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"kernel": m.group(1)}
            out.append(current)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return {"library": _build._target(name).name, "kernels": out,
            "spill_bytes": sum(k.get("spill_stores", 0) + k.get("spill_loads", 0) for k in out)}


#: chip_smoke's kernel names to their sources under kernels/csrc.
KERNEL_SOURCES = {"fused_em_tick": "em_tick", "segment_reduce": "segment_reduce",
                  "fused_map_step": "map_step", "mrf_min_energy": "mrf_energy",
                  "flash_attention": "flash_attention"}
ANALYSIS_BASELINE = SRC / "repro_torch" / "analysis" / "ANALYSIS.json"
ANALYSIS_MODES = ("static-pallas", "static", "faithful")


def census_row(torch, census, baseline, driver: str, mode: str, what: str, solve) -> dict:
    """The census of one warm ``solve`` on the card against the CPU's counts
    of the same driver and mode at K = 2 in the committed baseline
    (``analysis/ANALYSIS.json``), scope by scope (each count's maximum and
    minimum over the scope's instances); beside it the profiler's device
    operations of the same solve over its MAP iterations (the census's
    MAP-iteration instances: a stack's lockstep iterations).  Fails on any
    difference."""
    solve()
    with census.take() as cen:
        solve()
    card = cen.summary()
    (entry,) = [e for e in baseline["census"] if (e["driver"], e["mode"], e["k"]) == (driver, mode, 2)]
    cpu = entry["census"]
    diff = [scope for scope in census.SCOPES
            if (card[scope]["max"], card[scope]["min"]) != (cpu[scope]["max"], cpu[scope]["min"])]
    prof = device_profile(torch, solve)
    em_iters, map_iters = (card[s]["instances"] for s in (census.EM_BOUNDARY, census.MAP_ITERATION))
    row = {"phase": "analysis", "part": "census", "what": what, "driver": driver, "mode": mode,
           "K": 2, "equal_cpu": not diff,
           "card": {s: {"instances": card[s]["instances"], "max": card[s]["max"]}
                    for s in census.SCOPES},
           "em_iterations": em_iters, "map_iterations": map_iters,
           "census_launches_per_map_iteration": card["map_iteration"]["max"]["launches"],
           "census_device_ops_per_map_iteration": card["map_iteration"]["max"]["device_ops"],
           "profiler_per_solve": {k: prof[k] for k in ("kernels", "memsets", "memcpys")},
           "profiler_kernels_per_map_iteration": prof["kernels"] / max(map_iters, 1)}
    emit(row)
    if diff:
        for scope in diff:
            emit({"phase": "analysis", "part": "census_diff", "what": what, "scope": scope,
                  "card": card[scope], "cpu": cpu[scope], "by_op": dict(cen.by_op[scope])})
        fail(f"{what}: the card's census differs from the CPU's in {diff}")
    return row


def run_analysis(torch, api, sl, st, smi_line: str) -> dict:
    """The analysis phase (``repro_torch.analysis``), before serving: (a)
    the census of the warm K = 2 slice in each mode (``Segmenter.execute``,
    ``run_em``) and of the 16-slice K = 2 stack in each mode
    (``submit``/``drain``, one ``run_em_batched``), each equal to the CPU's
    counts scope by scope; (b) the kernel pass on the card
    (``kernel_check.audit_card``: the cases of every launching entry under
    ``compute-sanitizer``'s four tools, or, where the sanitizer cannot run
    here, its guard fallback and the lints), which must report no finding
    and catch each known-bad fixture exactly once.  Returns the kernel
    pass's report for the ``kernels`` line; prints the phase's seconds."""
    from repro_torch.analysis import census, kernel_check

    t0 = time.perf_counter()
    seed, dev = SLICE["seed"], torch.device(DEVICE)
    baseline = json.loads(ANALYSIS_BASELINE.read_text())
    rows = []
    for mode in ANALYSIS_MODES:
        seg = api.Segmenter(sl["config"].with_(mode=mode), device=dev)
        rows.append(census_row(torch, census, baseline, "run_em", mode, f"K=2 slice {mode}",
                               lambda seg=seg: seg.execute(sl["plan"], seed=seed)))
    plans, joint = st["plans"], st["joint"]
    for mode in ANALYSIS_MODES:
        seg = api.Segmenter(st["seg"].config.with_(mode=mode), device=dev)

        def drain(seg=seg):
            for p in plans:
                seg.submit(p, seed=seed, bucket=joint)
            return seg.drain()

        rows.append(census_row(torch, census, baseline, "run_em_batched", mode,
                               f"{len(plans)}-slice K=2 stack {mode}", drain))
    t_census = time.perf_counter() - t0
    found, report = kernel_check.audit_card(
        log=lambda m: emit({"phase": "analysis", "part": "kernel_pass_log", "msg": m}))
    emit({"phase": "analysis", "part": "kernel_pass", "route": report["route"],
          "sanitizer": report["sanitizer"], "sanitizer_version": report["sanitizer_version"],
          "via": report["via"],
          "per_kernel": report["per_kernel"], "fixtures": report["fixtures"],
          "findings": [f.as_dict() for f in found]})
    if found:
        fail(f"kernel pass: {[(f.code, f.site, f.message) for f in found]}")
    emit({"phase": "analysis", "part": "seconds", "census_s": t_census,
          "kernel_pass_s": time.perf_counter() - t0 - t_census,
          "total_s": time.perf_counter() - t0, "card": smi_line})
    return report


def analysis_entry(report: dict, name: str) -> dict:
    """The ``kernels`` line's sanitizer keys of one kernel."""
    src = KERNEL_SOURCES[name]
    return {"sanitizer": report["per_kernel"][src], "sanitizer_via": report["via"],
            "sanitizer_cases": report["cases"][src]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--profile", action="store_true",
                    help="also trace device time with torch.profiler (kernels alone and one solve)")
    profile = ap.parse_args(argv).profile
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch package is not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch import api
    from repro_torch.core import metrics, oversegment, synthetic
    from repro_torch.core.pmrf import em as em_mod
    from repro_torch.core.pmrf import energy as E
    from repro_torch.kernels import _build, ops

    dev = torch.device(DEVICE)
    # float32 products in full float32 (the defaults, stated): the plain
    # versions the kernels are held to must not drop to TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    emit({"device": {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line,
                     "torch": torch.__version__, "cuda": torch.version.cuda}})

    from repro_torch.analysis import kernel_check

    # The kernels, and the kernel pass's fixtures and guard allocator, one
    # nvcc each, all started together.
    emit({"phase": "build", "build_s": _build.build_all(_build.CSRC, kernel_check.FIXTURES,
                                                        kernel_check.GUARD_SRC),
          "dir": str(_build.BUILD_DIR)})
    tick_ptxas = ptxas_report("em_tick")
    emit({"phase": "ptxas", **tick_ptxas})
    step_ptxas = ptxas_report("map_step")
    emit({"phase": "ptxas", **step_ptxas})
    ptxas = ptxas_report("flash_attention")
    emit({"phase": "ptxas", **ptxas,
          "kernels": [k for k in ptxas["kernels"] if "flash_attention_tc_kernel" in k["kernel"]]})
    if ptxas["spill_bytes"]:
        fail(f"flash_attention spills {ptxas['spill_bytes']} bytes (ptxas)")

    sr_err = check_segment_reduce(torch, ops, dev)
    check_segment_reduce_order_free(torch, ops, dev, random_add_cases())
    check_segment_reduce_nonfinite(torch, ops, dev)
    check_tick_synthetic(torch, ops, dev)
    flash_err = check_flash(torch, ops, dev)
    check_flash_peaked(torch, ops, dev)
    ragged_err = check_flash_ragged(torch, dev)

    slice2 = run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=2)
    plan = slice2["plan"]
    check_plan_repeat(torch, api, slice2)

    hoods = plan.problem.hoods
    check_segment_reduce_order_free(torch, ops, dev, real_add_cases(torch, oversegment, slice2))
    tick2 = check_time_tick(torch, ops, E, em_mod, plan, profile)
    step2 = {**check_map_iteration(torch, ops, E, em_mod, plan),
             **check_tick_step(torch, ops, E, em_mod, plan)}
    solve_ops = warm_solve_ops(torch, api, plan, slice2["config"])

    # segment_reduce at the solve's call (neighbourhood sizes), and its min
    # at the shape of the faithful mode's per-element minimum.
    sr = segment_reduce_timing(torch, ops, hoods, profile)
    if profile:
        solve = api.Segmenter(
            api.ExecutionConfig(n_labels=2, overseg_grid=(SLICE["grid"],) * 2, init="quantile"), device=dev
        )
        profile_solve(torch, "K=2 slice solve (execute)", lambda: solve.execute(plan, seed=SLICE["seed"]))

    slice3 = run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=3)
    # K = 9 on the three-phase image: the tick's runtime-K variant on the main path.
    slice9 = run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=9, n_phases=3)
    # Every launch of whole K = 2, 3 and 9 solves against the plain MAP
    # iteration on the CPU, bit for bit (hood sums in element order).
    from repro_torch.core.pmrf import pipeline

    for sl in (slice2, slice3, slice9):
        check_tick_solve_against_cpu(torch, ops, em_mod, pipeline, sl)
    tick9 = check_time_tick(torch, ops, E, em_mod, slice9["plan"], profile)
    check_map_iteration(torch, ops, E, em_mod, slice3["plan"])
    step9 = {**check_map_iteration(torch, ops, E, em_mod, slice9["plan"]),
             **check_tick_step(torch, ops, E, em_mod, slice9["plan"])}

    # Second path: slice stacks through segment_stack(batch="always"), one
    # batched tick launch per MAP iteration for every running lane; then
    # the batched entry against its plain version at B = 1, 3 and 16.
    stacks = {k: run_stack(torch, api, synthetic, ops, E, em_mod, dev, k, n, profile, timed=k == 2)
              for k, n in STACK}
    st2 = stacks[2]
    batched_err = max(check_batched_entry(torch, ops, E, em_mod, st2["seg"], st2["plans"],
                                          st2["joint"], b)["max_abs_err"]
                      for b in BATCHED_CHECK_SIZES)

    # Third path: the sharded route's kernels at the slices' operands.
    from repro_torch.core.pmrf import collectives
    from repro_torch.core.pmrf import distributed as D

    ms_err, ms_args, ms_kw = check_map_step(torch, ops, D, E, em_mod, plan, 2)
    ms_err = max(ms_err, check_map_step(torch, ops, D, E, em_mod, slice3["plan"], 3)[0])
    ms_err = max(ms_err, check_map_step_long_hoods(torch, ops, dev))

    # Sixth path: the modes static and faithful (the paper's primitive
    # sequence) on the K = 2, 3, 9 plans; the ordered add against the CPU;
    # the fallback policy under the chaos harness's faults.
    modes = run_modes(torch, api, ops, em_mod, E, (slice2, slice3, slice9), profile)
    # The modes' stacks: one flat DPP step over every lane per lockstep MAP
    # iteration; segment_reduce at the flat step's sizes; the NumPy oracle.
    modes_stack = run_modes_stack(torch, api, ops, em_mod, stacks, profile)
    flat_sr = flat_segment_reduce_timing(torch, ops, api, em_mod, stacks[2], profile)
    run_oracle(torch, slice2, modes)
    ordered = check_ordered_add(torch, ops, api, plan, slice2["config"], profile)
    run_fallback(torch, api, ops, slice2, stacks[2])

    # The sharded route end to end, over a one-rank NCCL group.
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        sharded = {sl["K"]: run_sharded(torch, D, pipeline, ops, em_mod, sl) for sl in (slice2, slice3)}
        # The route's workspace kernel against the plain step on the CPU
        # (bit for bit), on the card and the JAX-signature entry, step by
        # step over whole K = 2, 3 and 9 solves, and the solves against the
        # route's plain path on the CPU and the single-device route.
        cpu_group = dist.new_group(backend="gloo")
        checked = {sl["K"]: check_sharded_map_step(torch, ops, D, pipeline, em_mod, sl, cpu_group)
                   for sl in (slice2, slice3, slice9)}
        sstep = check_sharded_step(torch, ops, collectives, checked[2], profile)
        # The modes on the sharded route, held to the single device and the CPU.
        for sl in (slice2, slice3):
            run_modes_sharded(torch, D, ops, em_mod, E, pipeline, sl, modes)
        if profile:
            for n_labels in (2, 3):
                profile_solve(torch, f"K={n_labels} sharded solve (run_em_sharded on its workspace, 1 rank)",
                              sharded[n_labels]["solve"])
            # The entry that partitions and builds the workspace in each call,
            # as earlier checkouts of this script profiled it.
            cfg2 = slice2["config"].em_config()
            init2 = pipeline.initial_params(plan.problem, SLICE["seed"], slice2["config"].init)

            def entry_solve():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = D.distributed_em(hoods, plan.problem.model, *init2, config=cfg2)
                torch.cuda.synchronize()
                return pipeline.assemble_result(plan.problem, res, plan.init_seconds, time.perf_counter() - t0)

            profile_solve(torch, "K=2 sharded solve (distributed_em, 1 rank)", entry_solve)
    finally:
        dist.destroy_process_group()

    # Timing of the JAX-signature map step at the K = 2 slice's operands.
    ms_ms = time_ms(lambda: ops.fused_map_step(*ms_args, **ms_kw))
    ms_plain_ms = time_ms(lambda: ops.fused_map_step(*ms_args, **ms_kw, backend="torch"))
    h = int(ms_args[0].shape[0])
    nh, nv, k2 = ms_kw["n_hoods"], ms_kw["n_vertices"], 2
    ms_bytes = (h * (7 * 4 + k2 * 4) + 2 * k2 * 4 + 4      # inputs: 7 element arrays, cnt_e, mu, sigma, beta
                + h * 8 + nh * 4 + k2 * nv * 4)            # outputs: min_e, arg, hood_e, votes
    ms_bound, ms_by = bound(ms_bytes, h * (2 + 15 * k2))
    ms_entry = {"ms": ms_ms, "plain_ms": ms_plain_ms, "bound_ms": ms_bound, "bound_by": ms_by}
    if profile:
        prof = device_profile(torch, lambda: [ops.fused_map_step(*ms_args, **ms_kw) for _ in range(20)])
        emit({"phase": "profile", "what": "20 fused_map_step calls (JAX-signature entry)", **prof})
        ms_entry["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
    emit({"phase": "timing", "fused_map_step_ms": ms_ms, "fused_map_step_plain_ms": ms_plain_ms,
          "fused_map_step_bytes": ms_bytes, "elements": h})

    # mrf_min_energy (on no path): the K = 2 slice's operands with n1 the
    # label-1 counts, ragged cases, and the 512^3 volume's hood elements.
    y, w, cnt, nall, xf, _valid, _hid, _vtx, mu, sig, beta = ms_args
    mrf_args = (y, w, cnt[1].contiguous(), nall, xf, mu, sig, beta)
    mrf = check_time_mrf_energy(torch, ops, mrf_args)

    # Fourth path: LM serving at qwen2-1.5b's full width and depth.
    lm = run_lm(torch, ops, dev, profile)
    flash = time_flash(torch, ops, dev, profile)
    # The MoE families on the same traffic: deepseek-v2-lite whole (MLA, no
    # kernel), qwen3-moe at full width, 4 layers (flash prefill, group 16).
    gc_cuda(torch)
    lm_moe = run_lm_moe(torch, ops, dev, profile, smi_line)
    flash_moe = time_flash(torch, ops, dev, profile, FLASH_MOE_SHAPES)
    # The ssm, hybrid, vlm and encdec families on the same traffic:
    # mamba2-130m and zamba2-2.7b whole (flash at D = 80 on the CUDA cores),
    # llava-next-34b at full width, 8 layers (flash at group 7, S up to
    # 3904), whisper-large-v3 whole (flash at D = 64, the encoder's
    # bidirectional at S = 1500).
    gc_cuda(torch)
    lm_families = run_lm_families(torch, ops, dev, profile, smi_line)
    flash_zamba = time_flash(torch, ops, dev, profile, FLASH_ZAMBA_SHAPES[-1:])
    flash_llava = time_flash(torch, ops, dev, profile, [FLASH_LLAVA_TIMED])
    flash_whisper = time_flash(torch, ops, dev, profile, [FLASH_WHISPER_ENCODER], causal=False)

    # The planning layer: the card's calibrated table, the modes ranked,
    # segment_stack(batch="auto") routed by the model, --shards auto, the
    # budget ledger.
    run_planning(torch, api, ops, slice2, st2)

    # The auditor: the census of the slice and the stack in every mode held
    # to the CPU's, and the kernel pass on the card.
    kpass = run_analysis(torch, api, slice2, st2, smi_line)

    # Fifth path: a request stream through the continuous-batching engine,
    # one launch of the tick's pool entry per micro-step, each lane at its
    # own MAP iteration; the pool entry against its plain version.
    served = run_serve(torch, api, synthetic, ops, em_mod, dev, profile)

    # Seventh path, the last: training.  qwen2-1.5b whole through
    # launch.train and run_training (every GQA forward on the flash kernel,
    # again in the remat recompute), flash under autograd, the kernel route
    # against the plain one, every family card against CPU, crash and
    # resume; then the kernel at its training call.  Last, because under
    # --profile its traces would leave the serve phase's profiler checks
    # fewer lead records than they need (device_profile).
    gc_cuda(torch)
    train = run_train(torch, ops, dev, profile, smi_line)
    flash_train = time_flash(torch, ops, dev, profile, [TRAIN_FLASH_SHAPE])

    # Eighth path: parallel/ on a one-rank NCCL DeviceMesh — qwen2-1.5b
    # whole through the sharded train step (its flash launches counted
    # from zero just before the mesh run), the checkpoint with its specs,
    # the codecs, EP, SP decode; with two cards, the same over 2 ranks.
    gc_cuda(torch)
    parallel = run_parallel(torch, ops, dev, profile, smi_line)

    launches = slice2["launches"]
    sharded_launches = sharded[2]["launches"]
    tick_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
    step_keys = tick_keys + ("ms_per_map_step", "stopping_launch")
    bstep = st2["batched_step"]
    ptime = served["timing"]
    emit({"phase": "profiler_lead", "lead_records": PROFILER_LEAD_RECORDS + 2,
          "traces_by_records_lost": {str(k): n for k, n in sorted(PROFILE_LEAD_LOST.items())}})
    emit({"kernels": [
        {"name": "fused_em_tick", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/em_tick.cu",
         "replaces": "src/repro/kernels/em_tick.py:253",
         "launches": launches["fused_em_tick"], **{k: step2[k] for k in step_keys},
         **analysis_entry(kpass, "fused_em_tick"),
         "library_ms": None, "device_ops_per_warm_solve": solve_ops["device_ops"],
         "ptxas": {"spill_bytes": tick_ptxas["spill_bytes"],
                   "registers": {k["kernel"]: k.get("registers") for k in tick_ptxas["kernels"]}},
         "jax_signature_entry": {k: tick2[k] for k in tick_keys if k in tick2},
         "K9": {"launches": slice9["launches"]["fused_em_tick"], **{k: step9[k] for k in step_keys},
                "jax_signature_entry": {k: tick9[k] for k in tick_keys if k in tick9}},
         "batched_entry": {"launches": st2["batched_launches"], "B": bstep["B"],
                           "max_abs_err": batched_err,
                           **{k: bstep[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "device_ms")},
                           "library_ms": None},
         "pool_entry": {"launches": served["cold"]["pool_launches"], "B": ptime["B"],
                        "max_abs_err": max(c["max_abs_err"] for c in served["check"].values()),
                        **{k: ptime[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "ms_per_micro_step") + ("device_ms",) * profile},
                        "library_ms": None}},
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
         "replaces": "src/repro/kernels/segment_reduce.py:71",
         "launches": launches["segment_reduce"], "max_abs_err": sr_err, **sr,
         **analysis_entry(kpass, "segment_reduce"),
         "modes_launches_per_solve": {f"K={k} {m}": row["segment_reduce"]
                                      for (k, m), row in modes.items()},
         "modes_stack_launches_per_solve": {
             f"K={k} {m} B={row['slices']}": {"lockstep_iterations": row["lockstep_map_iterations"],
                                             "em_iterations": row["em_iterations"],
                                             **row["segment_reduce"]}
             for (k, m), row in modes_stack.items()},
         "modes_serve_launches": {
             f"{m} tick_iters={t}": {"micro_steps": row["micro_steps"], **row["segment_reduce"]}
             for (m, t), row in served["modes"].items() if t != "mixed"},
         "flat_step_calls": {w: flat_sr[w] for w in ("add", "ordered_add", "min")},
         "ordered_add": {"max_abs_err": ordered["max_abs_err"],
                         "solve_calls_checked": ordered["solve_calls_checked"],
                         **{w: ordered[w] for w in ("hood_sums", "m_step")}, "library": "index_add_"}},
        {"name": "fused_map_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/map_step.cu",
         "replaces": "src/repro/kernels/map_step.py:148",
         "launches": sharded_launches["fused_map_step"], **analysis_entry(kpass, "fused_map_step"),
         "max_abs_err": max([ms_err] + [c["max_abs_err"] for c in checked.values()]),
         **{k: sstep[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                  "ms_per_map_iteration", "stopping_launch")},
         "library_ms": None, "allreduces_per_solve": sharded[2]["allreduces"],
         "ptxas": {"spill_bytes": step_ptxas["spill_bytes"],
                   "registers": {k["kernel"]: k.get("registers") for k in step_ptxas["kernels"]}},
         "jax_signature_entry": ms_entry},
        {"name": "mrf_min_energy", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mrf_energy.cu",
         "replaces": "src/repro/kernels/mrf_energy.py:62",
         "launches": sharded_launches["mrf_min_energy"], **mrf, "library_ms": None,
         **analysis_entry(kpass, "mrf_min_energy")},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83",
         "launches": lm["launches"], "launches_tensor_cores": lm["launches_tc"],
         "max_abs_err": flash_err, **flash, **flash_sass_hgmma(),
         "lm_moe": {**lm_moe, "at_model_shape": {"shape": list(FLASH_MOE_SHAPES[-1]), **flash_moe}},
         "lm_families": {**lm_families,
                         "at_zamba_shape": {"shape": list(FLASH_ZAMBA_SHAPES[-1]), **flash_zamba},
                         "at_llava_shape": {"shape": list(FLASH_LLAVA_TIMED), **flash_llava},
                         "at_whisper_encoder_shape": {"shape": list(FLASH_WHISPER_ENCODER), "causal": False,
                                                      **flash_whisper}},
         "train": {"launches": train["whole"]["launches"], "launches_tensor_cores": train["whole"]["launches_tc"],
                   "per_step": train["whole"]["per_step"], "forward_per_step": train["whole"]["forward_per_step"],
                   "backward": "plain recompute (kernels.ops.FlashAttention)",
                   "at_train_shape": {"shape": list(TRAIN_FLASH_SHAPE), "causal": True, **flash_train}},
         "parallel": {"launches": parallel["launches"], "launches_tensor_cores": parallel["launches_tc"],
                      "per_step": parallel["per_step"], "mesh": {"data": 1, "model": 1},
                      "steps": PARALLEL["steps"], "shape": list(TRAIN_FLASH_SHAPE), "causal": True},
         "ragged_row_relative_err": ragged_err,
         **analysis_entry(kpass, "flash_attention")},
    ]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
