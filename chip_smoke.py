"""Drive the PyTorch port once on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero and prints no result):

1. device  — the card's name and power limit (nvidia-smi) and torch's view;
2. build   — nvcc builds every kernel (paged attention's two; flash-
   attention forward; its dq and dk/dv backward; the int8 product;
   GroupNorm forward and backward) from the sources in
   this checkout (sm_90a) into the git-ignored build directory, one nvcc
   per source, all started together, and logs each kernel's registers,
   spills and shared memory; the SASS of the flash forward and backward
   must hold wgmma (HGMMA) in each bf16 kernel, and the int8 product's
   integer wgmma (IGMMA) in each of its kernels, with no mma.sync (IMMA)
   left;
3. kernels — the paged kernel (a call is two launches, split over the
   keys) against its plain PyTorch version on the card (float32 with
   TF32 off, and bf16) at the shapes gpt_small serving gives it and at
   head_dim 16 (h=2) and 96, max_len 4096 at b=8 and 32768 at b=1
   (t=2), at the chunk shape (1, 16) at cursors 16 and 32, at the
   verify shape (n, 5) of every ladder width, at the int8 KV path's
   dense view behind an identity table (decode (8, 2), prefill
   (1, 128)), at a 32-token tail prefill from mid-page (cursor 101), and
   at head_dim 256 (3 heads; decode and prefill), with its time, the
   plain version's time, one PyTorch library call's time for the same
   function, and its bound from this run's data;
4. engine  — the serving path: GenerationEngine(gpt_small) in bf16 on the
   card with seeded random weights, paged (page_size 16), 8 slots,
   prefill buckets (32, 128), first 20 bursts of 8 requests of 32 new
   tokens submitted at once (each burst's tokens/s, time a model call
   and longest gap), then three windows of 128 requests of 16-128
   prompt tokens and 64 new tokens each, 8 in flight (a closed loop):
   tokens/s a window and their spread, TTFT, the longest gap between two
   token emissions and the garbage collector's time in each window (each
   collection's generation, start and length, and ``gc.get_stats()``,
   logged after the window);
   every declared shape (2 buckets, 4 ladder widths) is captured as a
   CUDA graph in the constructor (the capture time is in ``setup_s``,
   the graphs' memory in ``graph_pool_bytes``) and only replayed after:
   the compiles count must not move under traffic; the paged kernel's
   launch count (one a layer a replay) is zeroed just before and read
   just after;
5. greedy  — in float32 with TF32 off, the engine's greedy tokens for two
   prompts equal the argmax of the port's full forward (plain attention,
   no kernel) re-run over each growing prefix, for gpt_small and for
   gpt_tiny (head_dim 16);
6. profile — a separate run of the serving path under torch.profiler
   (32 requests of 100 prompt tokens and 16 new tokens, 8 in flight):
   the device's busy share, its time by kernel, and the kernels each
   model call (a graph replay) puts on the device; the paged kernels in
   the trace must be two for each paged call counted;
7. flash   — the three training flash kernels (forward, dq, dk/dv)
   against their plain versions as in phase 3, at the training shape
   [8, 2048, 12, 64] causal, at phase 22's one-shot batch
   [4, 128, 12, 64] causal, at two small shapes and at phase 28 (d)'s
   MoE classifier [16, 256, 12, 64] non-causal;
8. train   — the training path: CausalLM at GPT-2-small widths (vocab
   50304, 12 layers x 12 heads x 768, mlp 3072, max_len 2048,
   attention="flash"), bf16 compute with float32 parameters, seeded
   weights, make_train_step(masked_lm, adamw(1e-3), accuracy) on one
   seeded batch of 8 x 2048 next-token labels: 1 warm-up and 4 timed
   steps, the flash kernels' launch counts zeroed just before and read
   just after (12 launches of each a step); then two witnesses of those
   losses: the same 5 steps through attention="full" (plain autograd
   attention, no kernel), whose losses must agree with the kernels' on
   steps 1-4 to 1e-3 relative, and the same 5 steps through the kernels
   at adamw(1e-4), whose last loss must be below its first (at 1e-3 with
   no warm-up on one repeated batch both paths overshoot on the 5th
   step, so phase 8 itself checks that the loss falls below the first
   step's within the run);
9. train profile — one more step of phase 8 under torch.profiler;
10. train identity — float32 with TF32 off, gpt_small widths at 2 layers,
   b=2, t=256: attention="flash" (the kernels) against attention="full"
   (plain autograd) in loss, every parameter's gradient and the
   parameters after one SGD step;
11. int8    — the int8 kernel against its plain version, bitwise, at the
   four products of a GPT-2-small block at 8 x 2048 rows (qkv, out, fc1,
   fc2; bf16 output) and of a BERT-base block at config 4's 32 x 128
   rows, with its time, the plain version's,
   ``torch._int_mm`` plus the scale multiply, its bound and its time over
   the bound, and its schedule (the C entry's, which must equal
   ``int8_matmul.plan``);
12. int8 train — path A: phase 8's configuration with precision="int8"
   (overflow_guard(adamw(1e-3))), 1 warm-up and 4 timed steps, the int8
   kernel launched 48 times a step and each flash kernel 12; a traced
   step (48 int8 kernels in it, their device ms); witnesses: the same
   steps through the plain int8 product (step 1 equal, steps 2-5 within
   1e-4), the guard's scale 16 with no step
   skipped, step 1 under precision="bf16" within 2e-2 of int8's and not
   equal, and block 0's qkv product at least 4x as far from float32
   under int8 as under bf16;
13. groupnorm — the GroupNorm forward and backward kernels against their
   plain versions at ResNet-50 b=128 shapes (stem, stage-0 norm3, stage-3
   norm3; G=32) in bf16 and float32, with times, plain versions',
   ``F.group_norm``'s (forward, autograd backward) and bounds;
14. resnet train — path B: resnet50() (GroupNorm) in bf16 with float32
   parameters on 128 seeded uint8 224^2 images, one-hot 1000 classes,
   adamw(1e-3): 1 warm-up and 4 timed steps, 53 GroupNorm forward and 53
   backward launches a step; a traced step; witness: the same steps
   through the plain GroupNorm (steps 1-4 within 1e-3); the float32
   identity (TF32 off in matmuls and cuDNN, cuDNN deterministic) at b=2:
   kernels against plain GroupNorm in loss, gradients and parameters
   after one SGD step;
15. nf      — resnet50_nf() in bf16 at b=128, 2 steps: finite losses and
   the step time (no kernel of the port on this path);
16. rect    — phase 4's engine and traffic on the default rectangular
   pool (``page_size=None``: no paged kernel, plain attention over each
   full-context row), a traced run for its busy share, and phase 5's
   float32 greedy check on that pool;
17. sampled — ``sampling=True, temperature=0.7`` in bf16 on both pools:
   seed 321 twice gives identical streams, seed 322 another, every token
   in the vocabulary;
18. chunked — paged with ``prefill_chunk=16``: phase 5's float32 greedy
   check (the 40-token prompt in three chunks; the chunk shares the
   16-token bucket's graph); then phase 4's traffic in bf16 with
   ``prefill_chunk=32`` (the 32-token bucket's graph);
19. prefix  — ``prefix_cache_bytes`` (4 GiB of host RAM) on the paged
   pool: 8 system prompts of 96 tokens served alone (each parked), then
   128 requests of a system prompt and a seeded 8-32-token tail, 64 new
   tokens each, 8 in flight, with the cache on and off, in float32 (TF32
   off: the greedy tokens must be equal) and in bf16: hit rate, full
   hits, pages swapped, TTFT, tokens/s and the host seconds in the
   cache's calls; the swap graphs' round trip over 64 pages of the bf16
   engine must be bitwise; 8 graphs (the swap pair) and none under
   traffic; one paged launch a layer a model call;
20. int8    — ``kv_dtype="int8"``: in float32 gpt_small's greedy tokens
   for prompts of 9 and 40 tokens equal those of the same engine with the
   paged kernel swapped for its plain version; then phase 4's traffic in
   bf16 on the int8 pool (tokens/s, launches), and the pool's bytes
   against native bf16 pages;
21. spec    — ``draft=``/``spec_k=4``: in float32 gpt_small's greedy
   tokens for 4 prompts that repeat a seeded 16-token phrase, 24 new
   tokens, equal the plain engine's with an ``NgramDraft`` and with a
   2-layer ``ModelDraft`` (gpt_small's vocab, max_len and widths); then
   in bf16 128 such requests, 64 new tokens, 8 in flight, with the
   n-gram draft and without: accept rate, tokens/s, TTFT; 10 graphs (4
   verify widths) and none under traffic;
22. wire    — the serving front end: one ``ServingServer`` on 127.0.0.1
   with a token and a ``RolloutController`` (canary: every batch
   mirrored, threshold 0) fronting phase 4's ``GenerationEngine`` (bf16,
   paged) and a ``ServingEngine`` over gpt_small with
   ``attention="flash"`` (bf16, 128-token int32 rows, buckets (1, 4));
   the generation engine holds two weight banks and the one-shot engine
   one, every graph captured in its constructor. (a) Phase 4's long window (128 requests, 64 new tokens)
   through 8 client threads, each with its own ``ServingClient``, as a
   closed loop: tokens/s and TTFT (send to first stream frame) beside
   phase 4's in-process figures of this run; every request's stream
   frames must equal its final blob; one paged launch a layer a model
   call. (b) When request 64 is submitted, ``put_weights`` of v1 (v0
   plus seeded noise, as flax-layout leaves), staged, scored by the
   canary and promoted on both engines under traffic:
   ``serving.compiles`` (2) and ``serving.decode.compiles`` (6) must
   not move; ``rollout.swap_s`` and the live versions are logged. (c) In
   float32 (TF32 off) at 4 layers of gpt_small's widths, over the wire:
   4 requests in flight on v0, ``put_weights`` v1, 4 more admitted, then
   ``put_weights`` v2 while v0 is pinned, which must wait until v0
   retires; the first 4 give the tokens of an engine built on v0, the
   next 4 those of one built on v1. (d) 4 ``infer`` rows over the wire
   agree with the plain forward of the same bf16 weights
   (``attention="full"``, eager) within 2e-2 * max|ref| (phase 7's bf16
   bound) and equal ``shadow_forward`` under the live weights bitwise,
   one flash forward launch a layer a batch; ``stage(v2)`` -> canary -> promote,
   then ``rollback``: ``infer`` bit-identical to before the promotion;
23. fleet   — a ``FleetRouter`` over several replicas in this process on
   the card, each a ``GenerationEngine`` of phase 4's shapes with 256 MiB
   of prefix cache behind its own generation-only ``ServingServer`` on
   127.0.0.1 (a token; every graph captured in its constructor). (a) bf16
   gpt_small, roles (prefill, decode), 8 prompts of 16-128 tokens x 32
   new tokens one at a time: the router's tokens equal one engine's
   local prefill and decode on the same weights, ``handoffs`` 8 and 8
   prefix hits on the decode replica; a ``"torn"`` ``fleet.kv_handoff``:
   the same tokens, ``handoff_failures`` 1, no new import; the status op
   carries the router's digest; each handoff's time and bytes. (b)
   float32 (TF32 off), three ``both`` replicas: a warm pass of 12
   prompts, then 48 requests, 8 in flight; the replica holding the most
   cache entries is killed (``srv.stop()``, then ``shutdown(drain=False,
   timeout=10)``) while its first stream is held after its first token:
   every request completes with the tokens one engine gives alone,
   ``evictions`` and ``requeued`` >= 1, the victim is out of the digest
   and its engine freed its graphs, banks and pool (allocated memory
   before and after the kill). (c) ``push_weights`` of seeded new
   weights to the live replicas: every reply ok, ``version_skew`` 0,
   ``model_version`` 1 on each, and the tokens that follow equal an
   engine's loaded with them. (d) bf16, two ``both`` replicas, the first
   64 requests of phase 4's window through the router from 8 client
   threads (affinity routing)
   with a ``MetricStore`` and the default SLO specs installed: tokens/s,
   TTFT p50/p99, longest gap, affinity hit rate, one paged launch a
   layer a model call (``launches_fleet`` in the kernels' line); the
   ``series`` op returns ``serving.decode.*`` rows and ``status`` carries
   ``alerts``.

24. train-core — the training core through the public trainer API
   (``distkeras_tpu_torch.trainers``, the substrate's replica loop,
   the strategies), one ``[train-core]`` line a part. (a) ``bench.py``'s
   configuration: ``ADAG(resnet50_nf(), worker_optimizer="sgd",
   learning_rate=0.05, num_workers=1, batch_size=128,
   communication_window=16, metrics=())`` over 3 rounds of seeded uint8
   224^2 images (1,000 classes) streamed with ``staging_rounds=1``
   (pinned buffers, side-stream copies, the prefetch thread): each
   round's wall time, samples/s over rounds 2-3, the median local step
   (CUDA events), peak memory and a round against 16 x phase 15's step;
   finite losses and a center that moved. (b) K = 4 replicas of
   resnet50_nf() on the card (``parallelism_factor=4``, batch 32, window
   4, one round): the new center within 1e-6 (relative to each leaf's
   largest magnitude) of the start plus the sum of every worker's
   ``(w - c) / window`` taken in float64 on the card, the replicas apart
   before the pull, peak memory. (c) The flow of
   ``examples/mnist_mlp.py`` (``synthetic_mnist(n=8192)``, its
   ``Pipeline``, momentum at lr 0.3, batch 64, 3 epochs, window 4) with
   K = 4 for every trainer of the zoo, then ``ModelClassifier`` and
   ``AccuracyEvaluator``: each accuracy and wall time. EAMSGD takes no
   worker optimizer (both packages refuse one); DOWNPOUR, DynSGD, AEASGD
   and EAMSGD do not converge at K = 4 with these kwargs (nor do the JAX
   package's: the example runs one worker on a one-chip host), so they
   also run at a window of 1 (DOWNPOUR, DynSGD) and rho 0.5 (AEASGD,
   EAMSGD); accuracy above 0.5 is asserted for Single, Averaging,
   Ensemble, ADAG and those four; ADAG's and EAMSGD's (rho 0.5)
   first-epoch loss histories within 1e-3 relative of the same runs on
   the host's CPU (TF32 off). (d) ``ADAG(resnet50())`` (GroupNorm) in
   bf16, K = 2, batch 32, window 2, one round: the GroupNorm forward and
   backward kernels launched 53 x K x window times each
   (``launches_train_core`` in the kernels' line), finite losses.
25. measure — the measurement plane (``observability``, ``profiling``,
   ``bench_torch.py``): ``calibrate_peak`` at 16384^2, 8192^2 and 4096^2
   (the first inside ``observability.CAL_BAND``); ``count_flops`` of one
   call on the card equal to the same call's on the host's CPU (the
   kernels report their formulas, the plain versions run as aten ops)
   for a 2-layer gpt_small-width flash step (rows 1-3), its int8 step
   (row 5), a resnet50() GroupNorm step at b=2 (rows 6-7) and a paged
   decode call (row 4); ``capture_op_times`` over two calls and
   ``build_report`` (op inventory against its source view: coverage) of
   phase 8's step, phase 12's, phase 14's, and a round of phase 24 (a)'s
   configuration at a window of 4 steps (one round), with phase 6's
   capture of a graphed
   window of phase 4's engine (graph replays dispatch no op: no
   roofline): busy share, top kernels, top roofline rows, and each
   path's hand-written kernels named in its trace;
   ``bench_torch.run`` at 2 rounds with its MFU;
26. checkpoint — ``ADAG(resnet50_nf())`` with K = 2 replicas (momentum),
   batch 32, window 2, 2 epochs of one round: the run that saves epoch 0
   and the run resumed from it end on the uninterrupted run's
   parameters bit for bit (cuDNN deterministic, TF32 off);
27. async — the true-async plane (``mode="host_async"``, worker threads
   against a live parameter server): (a) ``ADAG(resnet50_nf())`` at
   bench.py's configuration (sgd 0.05, batch 128, window 16, uint8
   224^2) with K = 1 and 2 threads, three windows a worker: samples/s
   over the steady windows beside phase 24 (a)'s, staleness mean/p95/max,
   the median window, pull and commit times from telemetry, peak memory;
   the loss falls, every scheduled window commits; (b) the fold witness:
   K = 4 DynSGD threads (batch 32, window 4), every fold's
   ``(delta, weight)`` accumulated in float64 as it lands, the final
   center within 1e-6 of it; (c) a K = 1 MNIST-MLP run on the card and on
   the host's CPU, centers within 1e-5; (d) ``codec="int8"`` with
   ``comms_overlap=True`` (ADAG K = 2, batch 128, window 8, 2 windows a
   worker): bytes a commit raw and int8,
   every window commits; (e) ``ADAG(resnet50())`` GroupNorm K = 2: the
   GroupNorm kernels launched 53 x K x window x windows times, plus 53
   by the runner's one-row FLOPs count on the first round a worker
   trains (``launches_async`` in the kernels' line); (f) DynSGD over a 2-shard
   fleet with a standby on loopback, the coordinator chaos-killed mid-run:
   zero lost windows, one promotion, the kill-to-promotion time, the
   fleet's clock the run's; (g) ``checkpoint_folds`` snapshots, then
   ``resume=True`` from the snapshot's center (bitwise) and clock; (h)
   the staleness-vs-wall-clock twin at a small grid.
28. encoders — the encoder families at full width, TF32 off. (a)
   ``python -m distkeras_tpu_torch.benchmarks 4 --full``'s configuration
   through the runner (BERT-base MLM under DynSGD, adam 1e-4, window 2,
   batch 32 x 128 int16 ids, 3 epochs of 2,048 rows, one worker):
   samples/s, steps, MFU against the bf16 peak, the timed run's loss
   falling. (b) ``bert_base(precision="int8")`` with
   ``overflow_guard(adamw(1e-4))``, 3 steps on config 4's batch: the int8
   kernel launched 49 times a step (12 x 4 + ``mlm_dense``), losses within
   2e-2 relative of the bf16 model's from the same weights and not equal
   at step 1 (phase 12's witness bound). (c) ``vit_base()`` at 224^2,
   b=64 uint8 images, adamw(1e-4), bf16, 5 steps: images/s, the loss
   falling. (d) ``MoEClassifier`` (4 layers, 12 heads, 8 experts, mlp
   3072, capacity 2.0, ``attention="flash"``) on [16, 256, 768] bf16
   features, 4 adamw(1e-4) steps: each flash kernel launched 4 times a
   step (``launches_encoders``), the sown aux term > 0 and in the
   objective; the same steps through ``attention="xla"``. (e) Remat:
   phase 8's GPT step (gpt_small widths, [8, 2048], flash) and (c)'s ViT
   step under ``"blocks"`` against ``"none"``: gradients (bitwise or
   not, reported) within 1e-3 of each leaf's largest magnitude, lower
   peak memory, and the flash forward launched 24 times instead of 12
   (``launches_remat``).
29. pjit    — the one-process workers x model mesh, TF32 off, meshes that
   repeat ``cuda:0``. (a) BASELINE config 5 (``vit-pjit``) through the
   runner at full width (``vit_base()``, 224^2 uint8, 1,000 classes,
   n=512, batch 64, adamw 1e-3, 8 epochs, one worker): samples/s, MFU
   against the bf16 peak, the timed run's loss falling. (b)
   ``PjitTrainer(bert_base(), precision="int8")`` with the model built
   at its default precision (``apply_to_model`` re-stamps it), config 4's
   MLM data, adam 1e-4, 4 steps, on ``Mesh(["cuda:0"] * 2,
   model_parallelism=2)`` and on ``[cuda:0]``: 49 int8 launches a step
   in each (``launches_pjit``), bitwise equal losses, every sharded
   parameter's shards half its bytes, adam's moments on the shards. (c)
   ``PjitTrainer(MoEClassifier(attention="flash"),
   partition_rules=ep_partition_rules())`` (phase 28 (d)'s model and
   rows) at workers 2 x model 2 on ``["cuda:0"] * 4``, 4 adam(1e-4) steps
   of 16 rows: each flash kernel launched 4 times a step
   (``launches_pjit``), the 16 expert tensors sharded on their stacked
   axis, losses finite and within 1e-3 relative of the workers 1 x
   model 1 run's at steps 1-2 (bitwise reported). (d) ``ServingEngine(mesh=Mesh(["cuda:0"] *
   2))`` with phase 22's one-shot shapes (gpt_small, flash, bf16,
   128-token rows) and buckets (2, 4): rows within 2e-2 * max|ref| of
   the ``mesh=None`` engine's, 4 graphs (buckets x shards) all captured
   in ``__init__``, none under traffic, 12 x 2 flash forward launches a
   batch counted per replay (``launches_mesh_serving``). (e)
   ``ModelPredictor(mesh=...)`` at float32 within 1e-5 * max|ref| of
   ``mesh=None``'s. (f) The native batcher built by g++ from the port's
   copy: available, a gather bitwise NumPy's, config 5's 512-image
   shuffle in rows/s. (g) A one-job ``Punchcard`` (``SingleTrainer``,
   MLP) through ``LocalLauncher`` in a fresh interpreter on the card,
   its results read back.
30. seqpipe — sequence and pipeline parallelism in one process, TF32
   off, meshes that repeat ``cuda:0``. (a) ``gpt_small(attention=
   "ring")`` in bf16 through ``parallel.sequence.build_sp_train_step`` on
   workers 1 x seq 4, global T = 1,024 (its ``max_len``), b = 8,
   adamw(1e-3), 4 steps: step 1's loss within 1e-3 relative of the same
   weights under ``attention="full"`` through the single-device step
   (``engine.make_train_step``), the loss falling, the median step,
   tokens/s, peak memory against the full step's. (b) Workers 2 x seq 2
   against 1 x 4 on (a)'s weights and batch in float32, one sgd(0.1)
   step: the loss and the parameters within 1e-5 relative (only the
   fold's order differs); bf16 step 1 on 2 x 2 against (a)'s, reported.
   (c) Long context: gpt_small's widths at ``max_len=8192``, b = 1 on
   seq 8, ``remat="blocks"``, 2 adamw steps: finite losses, peak memory
   and step times (every shard's folds live on the one card: no memory
   gain is claimed). (d) ``PipelinedLM`` at gpt_small's config in bf16,
   12 layers over 4 stages of 3, M = 4 microbatches of 2 at T = 1,024:
   one sgd(0.1) step's loss within 1e-6 relative and parameters within
   1e-6 of each leaf's largest magnitude of ``reference_apply`` over
   the same microbatches on the same stacked weights (the whole batch in
   one call reported); then 4 adamw steps, ms a step. (e)
   ``GenericPipeline`` over ``resnet50()`` (GroupNorm) cut into stem, its
   four stages and head (6 stages), b = 32 at 224^2, M = 4, bf16 hops:
   the loss within 1e-6 relative of the sequential oracle over the same
   microbatches, and both GroupNorm kernels launched 53 x M times over
   the step (``launches_pipeline`` in the kernels' line).
31. data    — the one-process data plane at full width: ``ADAG(
   resnet50_nf())``, sgd 0.05, b = 128, uint8 224^2 images, 1,000-way
   one-hot labels, K = 2, window 4, no kernel of the table on the path.
   (a) Streaming with a dead worker: a ``DataCoordinator`` over 4,096
   seeded rows in ranges of 512 (one round each), 2 epochs, served on
   loopback; a bare client (worker 99) leases 3 ranges, acks one and
   vanishes; ``mode="host_async"`` with ``data_service=`` and a
   ``checkpoint_dir`` trains from the wire. The cursor ends at ``[2,
   num_ranges]``, exactly 2 re-leases, 0 stale acks, (2 x 8 - 1) x 4 =
   60 landed steps, the last snapshot's ``data_cursor`` the final
   cursor, finite losses; samples/s beside phase 27 (a)'s staged K = 2
   rate, the median fetch and lease round trips, and the longest
   interval between a live worker's lease calls against the lease. (b)
   ``GlobalShards`` over 8 seeded ``.npy`` shard pairs of 512 rows:
   ``data_layout="host_sharded"``, 2 epochs, sync and ``host_async``:
   ``epoch_dataset`` re-resolved each epoch with the rows' order
   changed, 16 commits in ``host_async``, finite losses, samples/s. (c)
   ``run_with_retries``: the MNIST MLP crashes after epoch 0's
   checkpoint and resumes: parameters within rtol 1e-6 / atol 1e-7 of a
   clean run on the card (TF32 off).
32. multiprocess — the multi-process plane: two ranks of this script
   (``chip_smoke.py --mp-child RANK PORT DIR``) on ``cuda:0`` join a
   two-process gloo group; each has a hard timeout and is killed in a
   ``finally``, and a rank that fails fails the phase. Phase 31's
   ``ADAG(resnet50_nf())`` at b = 128, window 4, one worker a process
   (K = 2), on phase 31 (b)'s 8-file pool, TF32 off and cuDNN
   deterministic. The fold backend must be gloo (two ranks, one card);
   each rank's peak memory is printed. (a) Sync over ``GlobalShards``
   (``host_sharded``, 2 epochs): both ranks' centers and losses equal,
   and the center equal to the one-process K = 2 run in this process
   (bitwise, or within rtol 1e-5 / atol 1e-6, the CPU test's bound);
   samples/s and the fold's seconds a round. (b) ``mode="host_async"``
   with process 0's live center: both ranks' results equal, 16 commits,
   staleness > 0, samples/s beside phase 27 (a)'s K = 2. (c) The same
   with ``ps_shards=2, ps_placement="spread"`` (one epoch, 8 commits).
   (d) Process 0's service cannot bind its port: rank 1 raises
   ``RuntimeError`` within 5 s. (e) Each rank scores its half of 512
   seeded images with (a)'s center; the ``across_processes`` accuracy
   equals this process's scoring of all of them, the loss within 1e-5
   relative, the predictions within 1e-5 of the largest.
33. lint — the port's dktlint over this checkout, in child interpreters:
   ``python -m distkeras_tpu_torch.analysis --list-rules`` names the ten
   rules; ``--root <checkout> --format json`` exits 0 with no finding and
   nothing baselined over at least 150 files; the same run through
   ``main`` in a ``-c`` wrapper loads no torch, jax, flax or
   ``distkeras_tpu`` module. One line gives the files, findings,
   suppressed findings and seconds.

34. axes — the model, sequence and pipeline axes over processes: two
   ranks of this script (``--axes-child``) on ``cuda:0`` join a gloo
   group (TF32 off, cuDNN deterministic) and run, each layout as a row a
   process (each rank two devices) and as one row over both ranks (each
   one device): (a) phase 29 (b)'s ``PjitTrainer(bert_base(),
   precision="int8")`` (the int8 product's kernel; a quantizing precision
   takes the global batch's step on every rank), ranks equal, losses
   bitwise or within rtol 1e-5 / atol 1e-6 of phase 29 (b)'s, 49 int8
   launches a step a rank, each rank holding half the sharded bytes on
   the spanning row; (b) phase 29 (c)'s MoE under the EP rules at workers
   2 x model 2 (the three flash kernels, 4 launches a step a rank),
   bitwise phase 29 (c); (c) ``gpt_small(attention="ring")`` bf16 at
   b=8, T=1,024, workers 2 x seq 2 and 1 x 2, step 1's loss within
   phase 30 (a)'s bound of its full-attention loss, ranks equal; (d)
   phase 30 (d)'s PipelinedLM (stages 0-1 and 2-3) and (e)'s
   GenericPipeline(resnet50()) (stem to stage 2 and stage 3 to head),
   bitwise phase 30's losses, 212 launches of each GroupNorm kernel over
   the two ranks. Each run logs samples/s or tokens/s, ms a step, the
   seconds in cross-process moves, the bytes at rest and the peak memory
   a rank; the two ranks time-slice one card, so their rates are not two
   cards'.
35. cards — the cards of one host (N = ``torch.cuda.device_count()``, up
   to 4; on a host with one card the phase says that it needs two and
   runs nothing), TF32 off, cuDNN deterministic, each card's name and
   power limit logged: (a) rows 1-7 of the kernel table on every card,
   ``cuda:0`` first, each against its plain version (``card_rows``: a
   kernel opts into its shared memory once a card); (b) one process over
   the N cards, each run beside its one-card twin on ``cuda:0``:
   ``ADAG(resnet50_nf())`` sync with one worker a card (``make_mesh()``)
   against K = N replicas on one card (the center bitwise, or within
   rtol 1e-5 / atol 1e-6), in float32, and one round of it in phase 24's
   bf16 recipe, ``mode="host_async"`` with one thread a card,
   ``ModelPredictor`` over the cards' mesh, ``PjitTrainer(bert_base(),
   precision="int8")`` at workers N/2 x model 2, ``gpt_small(attention=
   "ring")`` bf16 at 1 x N (a replica of the weights a card: step 1's
   loss bitwise, later steps within the bound, the replicas' gradients
   summed in another order), ``PipelinedLM`` and ``GenericPipeline(
   resnet50())`` with a stage a card, and a ``GenerationEngine(
   page_size=16)`` on the last card (its graphs captured there, its
   tokens those of the same engine on ``cuda:0``); samples/s or tokens/s,
   ms a step and peak memory a card; (c) N ranks of this script
   (``--cards-child``), one card each: the PipelinedLM a stage a rank
   first on the fresh group (its first NCCL call a hop between two
   ranks), the fold backend then reading ``"nccl"`` on every rank, then
   the sync fold in float32 and one round in bf16, the BERT row over two
   ranks, the ring at 1 x N and GenericPipeline a stage a rank, every
   rank equal and each within rtol 1e-5 / atol 1e-6 of (b) (NCCL's ring
   order reassociates sums for N >= 3; the bf16 round's center too, the
   workers' round being the same on both layouts so that only the
   fold's float32 sums can differ), and the moves alone: the NCCL
   fold of resnet50_nf's 102 MB, its all-gather of 253 MiB a rank and a
   hop, beside the same bytes staged through the host over gloo. These
   are N cards' rates, not time slices of one. Run it alone (phases 1,
   2 and 35) with ``python -c "import sys, chip_smoke;
   sys.exit(chip_smoke.cards_alone())"``.

The last three lines of standard output are the kernels' JSON, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Details are
also written to ``chiprun_out/chip_smoke.json``.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

#: operand type -> the peak-table column of ``observability.PEAK_FLOPS``
PEAK_COLUMNS = {torch.bfloat16: "bf16", torch.float32: "f32",
                torch.int8: "int8"}


def peak_flops(dtype) -> float:
    """The card's published dense peak for an operand type
    (``observability.device_peak_flops``, NVIDIA's data sheet)."""
    from distkeras_tpu_torch import observability

    peak = observability.device_peak_flops(torch.device("cuda", 0),
                                           PEAK_COLUMNS[dtype])
    assert peak is not None, "the peak table does not know this card"
    return peak


def hbm_bytes_per_s() -> float:
    """The card's published HBM rate (``roofline.HBM_BANDWIDTH``)."""
    from distkeras_tpu_torch.profiling import roofline

    rate = roofline.device_hbm_bandwidth(torch.device("cuda", 0))
    assert rate is not None, "the bandwidth table does not know this card"
    return rate

#: the decode scheduler's model-call counters (prefills and steps)
DECODE_CALLS = ("serving.decode.prefills", "serving.decode.steps")

# gpt_small paged serving geometry (the engine phase uses the same)
H, D, PAGE, PMAX, SLOTS = 12, 64, 16, 64, 8
NUM_PAGES = SLOTS * PMAX        # + 1 scratch page
BOUNDS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: the paged kernel in bf16 is also held within this share of its plain
#: version's largest output (2 to 4 bf16 ulps of it)
PAGED_BF16_REL = 2 ** -6


def log(*args):
    print(*args, flush=True)


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    torch.set_float32_matmul_precision("high" if enabled else "highest")


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds a call over ``iters`` back-to-back calls,
    measured with CUDA events after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: card cycles of the spin that ``device_ms`` queues ahead of the timed
#: calls (~0.1 s at the H100's 1,980 MHz): longer than the host takes to
#: enqueue them
_SPIN_CYCLES = 200_000_000


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds a call: ``iters`` calls enqueued behind a
    spin of the card, so that they run back to back whatever the host's
    pace, between two CUDA events (the host's own time per call is not in
    it). One untimed call runs first. torch.profiler's kernel records
    were not used: they dropped some calls of the GroupNorm kernels, so
    that a call read 2/5 or 3/5 of its events time, one above what the
    card's memory rate allows."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi),
    logged beside the long measurements."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else ""


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": smi_line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[device] {json.dumps(info)}")
    assert info["capability"][0] >= 9, "the kernels are built for sm_90a"
    return info


# -- phase 2 -----------------------------------------------------------------

def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from distkeras_tpu_torch.ops.kernels import _build
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    from distkeras_tpu_torch.ops.kernels import groupnorm as gn
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    loaders = {"paged_attention": fa._kernel_lib,
               "flash_attention_fwd": lambda: fa._flash_lib("fwd"),
               "flash_attention_bwd": lambda: fa._flash_lib("bwd"),
               "int8_matmul": i8._kernel_lib,
               "groupnorm": gn._kernel_lib}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()
    wall = time.perf_counter() - t0
    info = {"wall_s": wall}
    log(f"[build] {len(loaders)} libraries in parallel in {wall:.2f} s")
    for name in loaders:
        info[name] = dict(_build.build_info[name])
        log(f"[build] {name}: nvcc {info[name]['seconds']:.2f} s -> "
            f"{info[name]['path']}")
        for line in info[name]["log"].splitlines():
            if "Compiling entry function" in line:
                log(f"[build]   {line.split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")
    info["groupnorm_kernels"] = _ptxas_table(info["groupnorm"]["log"])
    for name, k in info["groupnorm_kernels"].items():
        log(f"[build] groupnorm {name}: {k['registers']} registers, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spilled "
            f"(stores + loads), {k['smem']} bytes static shared memory "
            f"(the tiles are dynamic: phase 13 gives each plan's)")
    # the bf16 kernels (two forward, four backward: "sm90" in their
    # names) must multiply on the tensor cores
    for lib, n in (("flash_attention_fwd", 2), ("flash_attention_bwd", 4)):
        counts = _sass_counts(info[lib]["path"])
        info[f"{lib}_sass"] = counts
        sm90 = [c for name, c in counts.items() if "sm90" in name]
        assert len(sm90) == n and all(c["HGMMA"] > 0 for c in sm90), counts
    # the int8 product (float32 and bf16 output) on integer wgmma, with no
    # warp-level mma.sync left in the library
    counts = _sass_counts(info["int8_matmul"]["path"], ("IGMMA", "IMMA"))
    info["int8_matmul_sass"] = counts
    assert len(counts) == 2 and all(
        c["IGMMA"] > 0 and c["IMMA"] == 0 for c in counts.values()), counts
    return info


def _ptxas_table(build_log) -> dict:
    """Per kernel of a build's ``-Xptxas=-v`` output: registers, spilled
    bytes and static shared memory, keyed by the kernel's template
    (``gn_fwd_kernel<float, 4>``)."""
    import re

    table, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kernel = re.search(r"\d+(gn_\w+?_kernel)I", mangled)
            ty = "bf16" if "nv_bfloat16" in mangled else "float"
            vec = re.search(r"Li(\d+)E", mangled)
            name = (f"{kernel.group(1)}<{ty}, {vec.group(1)}>"
                    if kernel and vec else mangled)
            table[name] = {"registers": 0, "spill_stores": 0,
                           "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            table[name]["spill_stores"] = int(m.group(1))
            table[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            table[name]["smem"] = int(m.group(1))
    return table


def _sass_counts(lib_path, ops=("HGMMA", "FFMA")) -> dict:
    """Per kernel of a built library, its count of each of ``ops`` in the
    SASS (cuobjdump): by default bf16 wgmma (HGMMA) and float32 FMA
    (FFMA)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                counts[name][op] += f" {op}." in line or f" {op} " in line
    for name, c in counts.items():  # from the kernel's own name on
        start = max(name.rfind("flash_"), name.rfind("int8_"), 0)
        log(f"[build]   sass {name[start:][:48]}: "
            + ", ".join(f"{c[op]} {op}" for op in ops))
    return counts


# -- phase 3 -----------------------------------------------------------------

def _paged_inputs(b, t, dtype, rng, dev, h=H, d=D, pmax=PMAX, ci=None,
                  view=False):
    """q, k_pages, v_pages, page_table, cache_index at a pool of ``pmax``
    pages a row of ``b`` rows (the engine's geometry by default): tables
    drawn from every page INCLUDING the scratch page, cursors random with
    room for the block unless ``ci`` gives them. ``view``: the int8 KV
    path's call instead, the dense ``[b, max_len]`` view as ``b * pmax``
    pages behind the identity table."""
    num_pages = b * pmax if pmax != PMAX or view else NUM_PAGES
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q = mk(b, t, h, d)
    extra = 0 if view else 1
    k = mk(num_pages + extra, PAGE, h, d)
    v = mk(num_pages + extra, PAGE, h, d)
    table = (np.arange(b * pmax).reshape(b, pmax) if view else
             rng.permutation(num_pages + 1)[:b * pmax].reshape(b, pmax))
    ci = (rng.integers(0, pmax * PAGE - t + 1, size=b) if ci is None
          else np.full(b, ci))
    return (q, k, v, torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(ci.astype(np.int32)).to(dev))


def _bound(b, t, dtype, ci, h=H, d=D, pmax=PMAX):
    """Least time for this call on this data: each visible K/V cell, q,
    out, the table and the cursors moved once; 4*d flops per visible
    (query, key) pair at the operand type's peak. Also the bytes of the
    full fixed-length contraction (every table slot), for reference."""
    item = torch.finfo(dtype).bits // 8
    max_len = pmax * PAGE
    keys = [min(max_len, int(c) + t) for c in ci]
    pairs = sum(min(max_len, int(c) + i + 1) for c in ci for i in range(t))
    kv_bytes = 2 * sum(keys) * h * d * item
    io_bytes = 2 * b * t * h * d * item + b * pmax * 4 + b * 4
    flops = 4 * d * h * pairs
    t_bytes = (kv_bytes + io_bytes) / hbm_bytes_per_s() * 1e3
    t_ops = flops / peak_flops(dtype) * 1e3
    full_bytes = 2 * b * pmax * PAGE * h * d * item + io_bytes
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": kv_bytes + io_bytes, "flops": flops,
            "bound_full_pool_ms": full_bytes / hbm_bytes_per_s() * 1e3}


#: the speculative phase's verify width (spec_k) and ladder
SPEC_K = 4
LADDER = (1, 2, 4, 8)

#: phase 3's cases: (b, t, heads, head_dim, pages a row[, cursor[,
#: view]]). gpt_small's serving geometry (decode at b=1 and 8, a
#: 128-token prefill), then shapes the first kernel refused: gpt_tiny's
#: head_dim 16, head_dim 96, and 4096- and 32768-key contexts; then the
#: chunk calls of a 40-token prompt under prefill_chunk=16 (its second
#: and third chunks, at cursors 16 and 32); then the inputs of the
#: prefix, int8 and speculative options: the verify call (n, SPEC_K + 1)
#: at every ladder width, the int8 path's dense view behind the identity
#: table at decode (8, 2) and prefill (1, 128), a 32-token tail prefill
#: after a prefix hit at a cursor mid-page (101), and head_dim 256 (3
#: heads: gpt_small's width) at decode and prefill
PAGED_CASES = (((1, 2, H, D, PMAX), (8, 2, H, D, PMAX), (1, 128, H, D, PMAX)),
               ((8, 2, 2, 16, PMAX), (8, 2, 8, 96, PMAX), (8, 2, H, D, 256),
                (1, 2, H, D, 2048)),
               ((1, 16, H, D, PMAX, 16), (1, 16, H, D, PMAX, 32)),
               tuple((n, SPEC_K + 1, H, D, PMAX) for n in LADDER)
               + ((8, 2, H, D, PMAX, None, True),
                  (1, 128, H, D, PMAX, 0, True),
                  (1, 32, H, D, PMAX, 101),
                  (8, 2, 3, 256, PMAX), (1, 128, 3, 256, PMAX)))


def phase_kernels(dev) -> list:
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(0)
    cases = []
    # gpt_small's cases first, in both dtypes, so that they draw the same
    # inputs as in earlier versions of this script
    runs = [(dtype, case) for group in PAGED_CASES
            for dtype in (torch.float32, torch.bfloat16) for case in group]
    set_tf32(False)
    for dtype, (b, t, h, d, pmax, *extra) in runs:
        cursor = [] if not extra or extra[0] is None else [extra[0]]
        view = len(extra) > 1 and extra[1]
        q, k, v, table, ci = _paged_inputs(b, t, dtype, rng, dev, h, d,
                                           pmax, *cursor or [None],
                                           view=view)
        args = (q, k, v, table, ci)
        got = fa.paged_flash_attention(*args)
        want = fa.paged_flash_attention_reference(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape == q.shape
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        # bf16 also within a few ulps of the largest output, which over
        # tens of thousands of keys is a few hundredths
        scale = want.float().abs().max().item()
        bound = BOUNDS[dtype]
        if dtype == torch.bfloat16:
            bound = min(bound, PAGED_BF16_REL * scale)
        # rotate over copies of the pool so timed calls find K/V
        # outside the 50 MB L2, as a 12-layer decode step does
        copies = max(1, math.ceil(120e6 / (2 * k.numel() * k.element_size())))
        pools = [(k, v)] + [(k.clone(), v.clone())
                            for _ in range(copies - 1)]
        pick = lambda i: pools[i % len(pools)]
        kernel = lambda i: fa.paged_flash_attention(q, *pick(i), table,
                                                    ci)
        plain = lambda i: fa.paged_flash_attention_reference(
            q, *pick(i), table, ci)
        # the library yardstick: SDPA over the dense gather, same mask
        max_len = pmax * PAGE
        dense = [(kk[table.long()].reshape(b, max_len, h, d).transpose(1, 2),
                  vv[table.long()].reshape(b, max_len, h, d).transpose(1, 2))
                 for kk, vv in pools]
        pos = ci.long()[:, None] + torch.arange(t, device=dev)[None, :]
        mask = (torch.arange(max_len, device=dev)[None, None, None, :]
                <= pos[:, None, :, None])
        qt = q.transpose(1, 2)
        lib_out = F.scaled_dot_product_attention(qt, *dense[0],
                                                 attn_mask=mask)
        lib_err = (lib_out.transpose(1, 2).float()
                   - want.float()).abs().max().item()
        library = lambda i: F.scaled_dot_product_attention(
            qt, *dense[i % len(dense)], attn_mask=mask)
        # device time (calls queued behind a spin), and the events
        # time of back-to-back calls, which includes the host
        times = {}
        for name, fn in (("ms", kernel), ("plain_ms", plain),
                         ("library_ms", library)):
            times[name], times[name.replace("ms", "call_ms")], \
                times[name.replace("ms", "ms_source")] = _timed(fn, 30)
        ms, plain_ms, library_ms = (times["ms"], times["plain_ms"],
                                    times["library_ms"])
        del dense, pools
        torch.cuda.empty_cache()
        case = {"b": b, "t": t, "h": h, "d": d, "max_len": max_len,
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "max_abs_ref": scale, "bound": bound,
                **times, "split": fa.split_keys(max_len, b * h),
                "library_max_abs_err": lib_err,
                **({"cache_index": cursor[0]} if cursor else {}),
                **({"int8_view": True} if view else {}),
                **_bound(b, t, dtype, ci.tolist(), h, d, pmax)}
        cases.append(case)
        at = f" cache_index={cursor[0]}" if cursor else ""
        at += " (int8 path's view, identity table)" if view else ""
        log(f"[kernels] paged_flash_attention b={b} t={t} h={h} d={d} "
            f"max_len={max_len}{at} {case['dtype']}: max_abs_err {err:.3e} "
            f"(bound {bound:.3g}), kernel {ms:.4f} ms (split "
            f"{case['split']}), plain {plain_ms:.4f} ms, "
            f"sdpa-over-gather {library_ms:.4f} ms (device, "
            f"{times['ms_source']}; per call with the host: "
            f"{times['call_ms']:.4f} / {times['plain_call_ms']:.4f} / "
            f"{times['library_call_ms']:.4f} ms), bound "
            f"{case['bound_ms']:.4f} ms ({case['bound_by']})")
        assert err <= bound, case
    return cases


# -- phase 4 -----------------------------------------------------------------

#: the serving engine's declared shapes at gpt_small (phases 4, 6, 16-18)
ENGINE_KW = dict(num_slots=SLOTS, prefill_buckets=(32, 128),
                 queue_capacity=64)


#: phase 4's traffic (also phases 16 and 18's): SERVE_REQUESTS requests
#: of 16-128 prompt tokens and SERVE_NEW new tokens each, SLOTS of them
#: in flight (a closed loop: a request is submitted as one completes),
#: served SERVE_WINDOWS times over on one engine. At ~3,500 tokens/s a
#: window lasts ~2.3 s, the eager engine's ~11 s.
SERVE_REQUESTS = 128
SERVE_NEW = 64
SERVE_WINDOWS = 3
#: before the windows, BURSTS bursts of SLOTS requests of BURST_NEW new
#: tokens each, submitted at once (~0.07 s each on graphs): how much a
#: run that short varies, and whether a slow one stalled (its longest
#: gap) or ran slow throughout (its time a model call)
BURSTS = 20
BURST_NEW = 32


def _serving_prompts():
    """Phase 4's prompts: SERVE_REQUESTS of 16-128 tokens."""
    rng = np.random.default_rng(1)
    return [rng.integers(1, 50304, int(k)).tolist()
            for k in rng.integers(16, 129, size=SERVE_REQUESTS)]


def _gpt_small_bf16():
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params

    return init_params(gpt_small(dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0))


def _serve_window(eng, prompts, new, tokens=None) -> dict:
    """Serve ``prompts`` through ``eng`` with ``new`` new tokens each,
    SLOTS requests in flight: tokens/s, TTFT (submission to first token),
    and what would show a stall: the longest gap between two of the
    scheduler's token emissions, with its start from the window's, beside
    the window's mean time a model call, and the time Python's garbage
    collector ran in the window. ``tokens``, a dict, receives each
    request's tokens by its index."""
    import gc
    import threading

    from distkeras_tpu_torch import telemetry

    prefill = ("serving.decode.chunk.steps"
               if "prefill_chunk" in eng.compiled_executables
               else "serving.decode.prefills")
    calls = lambda: sum(telemetry.counter(name).value
                        for name in (prefill, "serving.decode.steps"))
    free = threading.Semaphore(SLOTS)
    submit, first, emits, gc_runs, collections = {}, {}, [], [], []
    t0 = time.perf_counter()

    def on_token(i):
        def stream(tok):
            now = time.perf_counter()
            emits.append(now)
            first.setdefault(i, now)
        return stream

    def on_gc(phase, info):
        gc_runs.append(time.perf_counter())
        if phase == "stop":
            collections.append({"generation": info["generation"],
                                "collected": info["collected"],
                                "at_s": gc_runs[-2] - t0,
                                "ms": (gc_runs[-1] - gc_runs[-2]) * 1e3})

    calls0 = calls()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            assert free.acquire(timeout=600), "no request completed"
            submit[i] = time.perf_counter()
            futs.append(eng.generate(p, max_new_tokens=new,
                                     stream=on_token(i)))
            futs[-1].add_done_callback(lambda f: free.release())
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    n_calls = calls() - calls0
    # each collection's generation, read after the window (logging inside
    # the callback would add to the stalls it looks for)
    gc_stats = gc.get_stats()
    if collections:
        log(f"[gc] {len(collections)} collections in the window: " + ", ".join(
            f"gen {c['generation']} at {c['at_s']:.2f} s {c['ms']:.1f} ms "
            f"({c['collected']} freed)" for c in collections)
            + f"; gc.get_stats() {gc_stats}")
    assert all(r.reason == "length" and r.tokens.size == new
               for r in results), results
    if tokens is not None:
        tokens.update((i, r.tokens.tolist()) for i, r in enumerate(results))
    assert all(0 <= int(tok) < 50304 for r in results for tok in r.tokens)
    tokens = sum(r.tokens.size for r in results)
    ttft = sorted(first[i] - submit[i] for i in range(len(prompts)))
    gaps = np.diff([t0] + emits)
    at = int(np.argmax(gaps))
    return {"requests": len(prompts), "new_tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
            "model_calls": n_calls, "ms_per_call": wall / n_calls * 1e3,
            "max_gap_ms": float(gaps[at]) * 1e3,
            "max_gap_at_s": ([t0] + emits)[at] - t0,
            "gc_s": sum(b - a for a, b in zip(gc_runs[::2], gc_runs[1::2])),
            "gc_runs": len(gc_runs) // 2, "gc_collections": collections,
            "gc_stats": gc_stats}


def _serve_windows(eng) -> dict:
    """SERVE_WINDOWS windows of phase 4's traffic back to back on ``eng``:
    each window's numbers, the median and spread of their tokens/s, and
    the paged kernel's launches (zeroed just before the first window,
    read just after the last) beside the model calls of all of them."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    prompts = _serving_prompts()
    fa.paged_flash_attention.launches = 0
    runs = [_serve_window(eng, prompts, SERVE_NEW)
            for _ in range(SERVE_WINDOWS)]
    launches = fa.paged_flash_attention.launches
    rates = [r["tokens_per_s"] for r in runs]
    return {"windows": runs, "tokens_per_s": statistics.median(rates),
            "tokens_per_s_min": min(rates), "tokens_per_s_max": max(rates),
            "ttft_p50_s": statistics.median(r["ttft_p50_s"] for r in runs),
            "ttft_max_s": max(r["ttft_max_s"] for r in runs),
            "max_gap_ms": max(r["max_gap_ms"] for r in runs),
            "launches": launches,
            "model_calls": sum(r["model_calls"] for r in runs)}


def _engine_run(dev, model, power_line, tag, **kw) -> dict:
    """Build ``GenerationEngine(model, **ENGINE_KW, **kw)`` (every shape
    captured as a CUDA graph in the constructor: ``setup_s``) and serve
    phase 4's traffic (:func:`_serve_windows`). Asserts that the compiles
    count and ``compiled_executables`` do not move under traffic."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.serving import GenerationEngine

    set_tf32(False)
    compiles = telemetry.counter("serving.decode.compiles")
    compiles0 = compiles.value
    t0 = time.perf_counter()
    eng = GenerationEngine(model, device=dev, **ENGINE_KW, **kw)
    setup_s = time.perf_counter() - t0
    captured = compiles.value - compiles0
    declared = eng.compiled_executables
    try:
        bursts = [_serve_window(eng, _serving_prompts()[:SLOTS], BURST_NEW)
                  for _ in range(BURSTS)]
        info = _serve_windows(eng)
        assert compiles.value - compiles0 == captured, "captured late"
        assert eng.compiled_executables == declared
    finally:
        eng.shutdown()
    info.update(setup_s=setup_s, compiles=captured,
                compiled_executables=declared,
                graph_pool_bytes=eng.graph_pool_bytes, card=power_line,
                bursts=bursts)
    rates = [b["tokens_per_s"] for b in bursts]
    slow = bursts[int(np.argmin(rates))]
    log(f"[{tag}] {BURSTS} bursts of {SLOTS} requests x {BURST_NEW} new "
        f"tokens at once: tokens/s min {min(rates):.1f}, median "
        f"{statistics.median(rates):.1f}, max {max(rates):.1f} (first "
        f"{rates[0]:.1f}); the slowest: {slow['ms_per_call']:.3f} ms a "
        f"model call, longest gap {slow['max_gap_ms']:.1f} ms at "
        f"{slow['max_gap_at_s']:.3f} s, gc {slow['gc_s'] * 1e3:.1f} ms")
    for k, w in enumerate(info["windows"]):
        log(f"[{tag}] window {k}: {w['requests']} requests x {SERVE_NEW} "
            f"new tokens, {SLOTS} in flight: {w['tokens_per_s']:.1f} "
            f"tokens/s in {w['wall_s']:.3f} s, TTFT p50 "
            f"{w['ttft_p50_s'] * 1e3:.1f} ms (max "
            f"{w['ttft_max_s'] * 1e3:.1f} ms), {w['model_calls']} model "
            f"calls ({w['ms_per_call']:.3f} ms a call), longest gap "
            f"{w['max_gap_ms']:.1f} ms at {w['max_gap_at_s']:.3f} s, gc "
            f"{w['gc_s'] * 1e3:.1f} ms in {w['gc_runs']} runs")
    log(f"[{tag}] gpt_small bf16: median {info['tokens_per_s']:.1f} "
        f"tokens/s (min {info['tokens_per_s_min']:.1f}, max "
        f"{info['tokens_per_s_max']:.1f}) over {len(info['windows'])} "
        f"windows, setup {setup_s:.2f} s for {captured} CUDA graphs "
        f"{declared} holding {eng.graph_pool_bytes / 2**20:.1f} MiB, "
        f"{info['model_calls']} model calls, paged kernel launches "
        f"{info['launches']} [{power_line}]")
    return info


def phase_engine(dev, power_line) -> dict:
    """The main path: the paged engine (page_size 16) through its CUDA
    graphs, one launch of the paged kernel per layer per model call."""
    model = _gpt_small_bf16()
    info = _engine_run(dev, model, power_line, "engine", page_size=PAGE)
    # one launch per layer per prefill or decode call, none elsewhere
    assert info["launches"] == model.num_layers * info["model_calls"] > 0, (
        info["launches"], info["model_calls"])
    assert info["compiles"] == 6, info["compiled_executables"]
    del model
    torch.cuda.empty_cache()
    return info


# -- phase 5 -----------------------------------------------------------------

def _greedy(dev, model, seed, **kw) -> dict:
    """The engine's greedy tokens for two prompts of 9 and 40 tokens
    (float32, TF32 off) against the argmax of the model's full forward
    (plain attention, no kernel) re-run over each growing prefix. Paged
    (page_size 16) unless ``kw`` says otherwise."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import GenerationEngine

    set_tf32(False)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, model.vocab_size, n).tolist()
               for n in (9, 40)]
    new = 12
    kw = {"page_size": PAGE, **kw}
    fa.paged_flash_attention.launches = 0
    with GenerationEngine(model, device=dev, num_slots=2,
                          prefill_buckets=(16, 64), **kw) as eng:
        results = [f.result(timeout=600) for f in
                   [eng.generate(p, max_new_tokens=new) for p in prompts]]
    launches = fa.paged_flash_attention.launches
    if kw["page_size"] is not None:
        assert launches > 0, "the engine did not reach the paged kernel"
    else:
        assert launches == 0, "the rectangular pool runs no paged kernel"
    checked = 0
    margins = []
    with torch.no_grad():
        for p, r in zip(prompts, results):
            seq = list(p)
            for tok in r.tokens.tolist():
                logits = model(torch.tensor([seq], device=dev))[0, -1]
                assert torch.isfinite(logits).all()
                top2 = torch.topk(logits, 2).values
                margins.append((top2[0] - top2[1]).item())
                want = int(torch.argmax(logits))
                assert tok == want, (seq, tok, want)
                seq.append(tok)
                checked += 1
    return {"prompts": len(prompts), "tokens_checked": checked,
            "min_top2_margin": min(margins), "paged_launches": launches}


def phase_greedy(dev, tag="greedy", **kw) -> dict:
    """gpt_small (head_dim 64) and gpt_tiny (head_dim 16, which the first
    paged kernel refused) served greedily in float32 on the card."""
    from distkeras_tpu_torch.models.gpt import (gpt_small, gpt_tiny,
                                                init_params)

    info = {}
    for name, make, seed in (("gpt_small", gpt_small, 2),
                             ("gpt_tiny", gpt_tiny, 6)):
        model = init_params(make(dtype=torch.float32),
                            torch.Generator().manual_seed(seed))
        info[name] = _greedy(dev, model, seed + 1, **kw)
        log(f"[{tag}] {name} (head_dim {model.width // model.num_heads}) "
            f"f32 engine tokens == full-forward argmax on "
            f"{info[name]['tokens_checked']}/{info[name]['tokens_checked']} "
            f"positions (min top-2 margin "
            f"{info[name]['min_top2_margin']:.3e}; paged kernel calls "
            f"{info[name]['paged_launches']})")
        del model
    return info


# -- phase 6 -----------------------------------------------------------------

#: the traced run's traffic (phases 6 and 16): TRACE_REQUESTS requests of
#: 100 prompt tokens and TRACE_NEW new tokens each, SLOTS in flight
TRACE_REQUESTS = 32
TRACE_NEW = 16


def _traced_serve(eng, tag) -> dict:
    """The traced run's traffic under torch.profiler
    (``profiling.capture_op_times``): the device's busy share, its time
    by kernel, and the kernels a model call (a graph replay) put on the
    device: all of them, and the paged kernel's two, beside the paged
    calls the wrapper counted (zeroed just before, read just after)."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.profiling import capture_op_times

    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 50304, 100).tolist()
               for _ in range(TRACE_REQUESTS)]
    fa.paged_flash_attention.launches = 0
    served = {}
    table = capture_op_times(
        lambda: served.update(_serve_window(eng, prompts, TRACE_NEW)),
        steps=1)
    assert table.available, table.note
    counted = fa.paged_flash_attention.launches
    n_calls = served["model_calls"]
    wall, busy_s = table.wall_s, table.total()
    launches = int(sum(table.counts.values()))
    paged = int(sum(n for k, n in table.counts.items()
                    if "paged_logits_kernel" in k
                    or "paged_values_kernel" in k))
    info = {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": table.busy_share,
            "wrapper_ms": {k: v * 1e3 for k, v in table.kernels().items()},
            "kernel_launches": launches,
            "model_calls": n_calls, "paged_calls_counted": counted,
            "paged_kernels_traced": paged,
            "kernels_per_call": launches / n_calls,
            "paged_kernels_per_call": paged / n_calls,
            "top_kernels": [{"name": k[:90], "count": int(n),
                             "device_ms": sec * 1e3}
                            for k, sec, n in table.top(10)]}
    log(f"[{tag}] traced serving run: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_s * 1e3:.1f} ms ({100 * info['device_busy_share']:.1f}%), "
        f"{info['kernel_launches']} kernels on the device in {n_calls} "
        f"model calls ({info['kernels_per_call']:.1f} a call), paged "
        f"kernels {paged} ({info['paged_kernels_per_call']:.1f} a call) "
        f"for {counted} counted paged calls")
    for k in info["top_kernels"]:
        log(f"[{tag}]   {k['device_ms']:9.3f} ms  x{k['count']:<5d} "
            f"{k['name']}")
    return info


def phase_profile(dev) -> dict:
    """A separate traced run of the main path (bf16, the traced run's
    traffic): device busy share and device time by kernel. Phase 4's
    numbers are taken with the profiler off."""
    from distkeras_tpu_torch.serving import GenerationEngine

    model = _gpt_small_bf16()
    with GenerationEngine(model, device=dev, page_size=PAGE,
                          **ENGINE_KW) as eng:
        info = _traced_serve(eng, "profile")
    # every replay launched its layers' paged calls, and the trace holds
    # their kernels, two a call: the count a replay adds is the count the
    # card ran
    assert info["paged_calls_counted"] == (
        model.num_layers * info["model_calls"]) > 0, info
    assert info["paged_kernels_traced"] == 2 * info["paged_calls_counted"], (
        info)
    del model
    torch.cuda.empty_cache()
    return info


# -- phase 7 -----------------------------------------------------------------

#: training shape of the main path, phase 22's one-shot batch (bucket 4
#: of 128-token rows), the small shapes also checked, and phase 28 (d)'s
#: MoE classifier (non-causal)
FLASH_CASES = (((8, 2048, 12, 64), True), ((4, 128, 12, 64), True),
               ((1, 128, 12, 64), True), ((2, 256, 12, 64), False),
               ((16, 256, 12, 64), False))


def _flash_bound(name, shape, causal, dtype):
    """Least time for one call on the card: each input read once and
    each output written once at the HBM rate, against its products at
    the rate of their operand types, counting visible (query, key) pairs
    only. Products of input-dtype operands (q k^T, dout v^T, and p v in
    the forward, which takes p in the input dtype) run at that dtype's
    peak. Those with a float32 operand (ds k, p^T dout, ds^T q): for
    float32 inputs at the float32 peak; for bf16 inputs as three bf16
    tensor-core products (the float32 operand split into three bf16
    terms, the fastest float32-accurate route on this card), three times
    their flops at the bf16 peak."""
    b, t, h, d = shape
    item = torch.finfo(dtype).bits // 8
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor, rows = b * t * h * d * item, b * h * t * 4
    moved = {"fwd": 4 * tensor + rows,            # q, k, v -> o, lse
             "dq": 5 * tensor + 2 * rows,         # q, k, v, dout, lse, delta -> dq
             "dkv": 6 * tensor + 2 * rows}[name]  # ... -> dk, dv
    in_ops, f32_ops = {"fwd": (4 * d, 0), "dq": (4 * d, 2 * d),
                       "dkv": (4 * d, 4 * d)}[name]
    split = 3 if dtype == torch.bfloat16 and f32_ops else 0
    t_bytes = moved / hbm_bytes_per_s() * 1e3
    if split:
        t_ops = (in_ops + split * f32_ops) * pairs / peak_flops(dtype) * 1e3
    else:
        t_ops = (in_ops * pairs / peak_flops(dtype)
                 + f32_ops * pairs / peak_flops(torch.float32)) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "flops": (in_ops + f32_ops) * pairs,
            "pairs": pairs, "split_terms": split}


def _timed(fn, iters):
    """(device ms a call, events queued behind a spin; events ms a call
    with the host; source)."""
    call = cuda_ms(fn, iters=iters, warmup=1)
    return device_ms(fn, iters=iters), call, "queued events"


def phase_flash_kernels(dev) -> list:
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    set_tf32(False)
    cases = []
    log(f"[flash] card before: {smi_sample()} (SM clock, power, temp)")
    for (shape, causal) in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(sum(shape))
            q, k, v, dout = (torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
                for _ in range(4))
            o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
            delta = fa.flash_attention_delta(o_ref, dout)
            args = (q, k, v, dout, lse_ref, delta, causal)
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            dq = fa.flash_attention_bwd_dq(*args)
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            dq_ref = fa.flash_attention_bwd_dq_reference(*args)
            dk_ref, dv_ref = fa.flash_attention_bwd_dkv_reference(*args)
            torch.cuda.synchronize()
            errs, ok = {}, True
            for name, got, want, grad in (
                    ("o", o, o_ref, False), ("lse", lse, lse_ref, False),
                    ("dq", dq, dq_ref, True), ("dk", dk, dk_ref, True),
                    ("dv", dv, dv_ref, True)):
                assert torch.isfinite(got).all(), name
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                if dtype == torch.float32:
                    bound = 1e-4 * scale + 1e-5 if grad else 1e-5
                else:
                    bound = 2e-2 * scale if grad else 2e-2
                errs[name] = {"max_abs_err": err, "bound": bound,
                              "max_abs_ref": scale}
                ok &= err <= bound
            del o, lse, dq, dk, dv, dq_ref, dk_ref, dv_ref
            iters = 10 if shape[1] >= 2048 else 30
            # library yardstick: SDPA on [b, h, t, d] copies (copies not
            # timed), its forward and its backward (dq, dk, dv together)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            dot = dout.transpose(1, 2).contiguous()
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
            lib_err = (sdpa_out.detach().transpose(1, 2).float()
                       - o_ref.float()).abs().max().item()
            timings = {
                "fwd": (lambda i: fa.flash_attention_fwd(q, k, v, causal),
                        lambda i: fa.flash_attention_reference(q, k, v,
                                                               causal)),
                "dq": (lambda i: fa.flash_attention_bwd_dq(*args),
                       lambda i: fa.flash_attention_bwd_dq_reference(*args)),
                "dkv": (lambda i: fa.flash_attention_bwd_dkv(*args),
                        lambda i: fa.flash_attention_bwd_dkv_reference(
                            *args)),
            }
            kernels = {}
            for name, (kernel, plain) in timings.items():
                ms, call_ms, source = _timed(kernel, iters)
                plain_ms, plain_call_ms, _ = _timed(plain, max(2, iters // 3))
                kernels[name] = {"ms": ms, "call_ms": call_ms,
                                 "ms_source": source, "plain_ms": plain_ms,
                                 "plain_call_ms": plain_call_ms,
                                 **_flash_bound(name, shape, causal, dtype)}
            lib_fwd = _timed(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters)
            lib_bwd = _timed(lambda i: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True), iters)
            kernels["fwd"]["library_ms"] = lib_fwd[0]
            for name in ("dq", "dkv"):
                kernels[name]["library_ms"] = None
                kernels[name]["library_bwd_ms"] = lib_bwd[0]
            case = {"shape": list(shape), "causal": causal,
                    "dtype": str(dtype).split(".")[-1], "errors": errs,
                    "library_fwd_max_abs_err": lib_err, "kernels": kernels}
            cases.append(case)
            del qt, kt, vt, dot, sdpa_out
            torch.cuda.empty_cache()
            err_line = ", ".join(f"{n} {e['max_abs_err']:.3e} (bound "
                                 f"{e['bound']:.3e})" for n, e in errs.items())
            log(f"[flash] {tuple(shape)} causal={causal} {case['dtype']}: "
                f"{err_line}")
            for name, kk in kernels.items():
                lib = (f"sdpa fwd {kk['library_ms']:.4f}" if name == "fwd"
                       else f"sdpa bwd (dq+dk+dv) {kk['library_bwd_ms']:.4f}")
                log(f"[flash]   {name}: kernel {kk['ms']:.4f} ms, plain "
                    f"{kk['plain_ms']:.4f} ms, {lib} ms (device, "
                    f"{kk['ms_source']}; with the host {kk['call_ms']:.4f} / "
                    f"{kk['plain_call_ms']:.4f} ms), bound "
                    f"{kk['bound_ms']:.4f} ms ({kk['bound_by']})")
            assert ok, errs
    log(f"[flash] card after: {smi_sample()}")
    return cases


# -- phase 8 -----------------------------------------------------------------

TRAIN_B, TRAIN_T = 8, 2048


def _train_model(num_layers, attention, dtype, seed, precision=None,
                 remat="none"):
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params

    model = CausalLM(vocab_size=50304, max_len=2048, num_layers=num_layers,
                     num_heads=12, width=768, mlp_dim=3072, dtype=dtype,
                     attention=attention, precision=precision, remat=remat)
    return init_params(model, torch.Generator().manual_seed(seed))


def _lm_batch(b, t, seed):
    """Seeded tokens with next-token labels (last position -1)."""
    x = np.random.default_rng(seed).integers(1, 50304, (b, t))
    y = np.concatenate([x[:, 1:], np.full((b, 1), -1)], axis=1)
    return {"features": x.astype(np.int32), "labels": y.astype(np.int32)}


def phase_train(dev, power_line) -> tuple:
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    set_tf32(False)
    model = _train_model(12, "flash", torch.bfloat16, seed=0)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tx = optimizers.get("adamw", 1e-3)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "masked_lm", tx,
                                  metrics=("accuracy",))
    batch = engine.to_device(_lm_batch(TRAIN_B, TRAIN_T, seed=1), dev)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    metrics, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in out.items()})
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in metrics]
    median_s = statistics.median(times[1:])
    info = {"steps": len(times), "step_s": times, "median_step_s": median_s,
            "tokens_per_s": TRAIN_B * TRAIN_T / median_s,
            "peak_bytes": peak, "metrics": metrics, "launches": launches,
            "tf32": torch.backends.cuda.matmul.allow_tf32, "card": power_line,
            "card_after": smi_sample()}
    log(f"[train] gpt-2-small widths, seq {TRAIN_T}, batch {TRAIN_B}, bf16 "
        f"compute, f32 params, adamw(1e-3): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; median step "
        f"{median_s * 1e3:.1f} ms of 4 timed (warm-up "
        f"{times[0] * 1e3:.1f} ms), {info['tokens_per_s']:.0f} tokens/s, "
        f"peak {peak / 2**30:.2f} GiB, TF32 {info['tf32']}, flash launches "
        f"{launches} [{power_line}; after: {info['card_after']}]")
    assert all(math.isfinite(x) for x in losses), losses
    assert min(losses[1:]) < losses[0], losses
    assert all(n == 12 * len(times) for n in launches.values()), launches
    return info, (state, step, batch)


def _train_losses(dev, attention, lr, steps) -> list:
    """Phase 8's configuration and batch from the same seeded weights,
    ``steps`` adamw(``lr``) steps through ``attention``: the losses."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers

    set_tf32(False)
    model = _train_model(12, attention, torch.bfloat16, seed=0)
    tx = optimizers.get("adamw", lr)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "masked_lm", tx)
    batch = engine.to_device(_lm_batch(TRAIN_B, TRAIN_T, seed=1), dev)
    losses = []
    for _ in range(steps):
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
    del model, state, step
    torch.cuda.empty_cache()
    return losses


def phase_train_witness(dev, flash_losses) -> dict:
    """Two witnesses of phase 8's losses. The same steps through
    attention="full" (plain autograd attention, no kernel) must agree
    with the kernels' on the first four steps to 1e-3 relative (bf16
    compute; the 5th step's overshoot amplifies rounding differences).
    The same steps through the kernels at adamw(1e-4) must end below
    their first loss: the 5th step's rise at 1e-3 is the learning rate's,
    not the kernels'."""
    full = _train_losses(dev, "full", 1e-3, len(flash_losses))
    diff = [abs(a - b) / b for a, b in zip(flash_losses, full)]
    low_lr = _train_losses(dev, "flash", 1e-4, len(flash_losses))
    log(f"[train-witness] the same steps through attention='full': losses "
        f"{', '.join(f'{x:.4f}' for x in full)} (flash: "
        f"{', '.join(f'{x:.4f}' for x in flash_losses)}; relative "
        f"differences {', '.join(f'{x:.2e}' for x in diff)}, steps 1-4 "
        f"bound 1e-3); through the kernels at adamw(1e-4): "
        f"{', '.join(f'{x:.4f}' for x in low_lr)}")
    info = {"full_losses": full, "flash_losses": flash_losses,
            "rel_diff": diff, "flash_losses_lr_1e-4": low_lr}
    assert max(diff[:4]) <= 1e-3, info
    assert all(math.isfinite(x) for x in low_lr) and low_lr[-1] < low_lr[0], \
        info
    return info


# -- phase 9 -----------------------------------------------------------------

def phase_train_profile(state, step, batch, tag="train-profile") -> dict:
    """One more train step (a train phase's state and batch) under
    torch.profiler (``profiling.capture_op_times``): device busy share and
    device time by kernel."""
    from distkeras_tpu_torch.profiling import capture_op_times

    table = capture_op_times(lambda: step(state, batch)[1], steps=1)
    assert table.available, table.note
    wall, busy_s = table.wall_s, table.total()

    def part(*names):
        keys = [k for k in table.seconds if any(n in k for n in names)]
        return (sum(table.seconds[k] for k in keys) * 1e3,
                int(sum(table.counts[k] for k in keys)))

    gn_ms, gn_n = part("gn_fwd_kernel", "gn_bwd_kernel")
    int8_ms, int8_n = part("int8_matmul")
    info = {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": table.busy_share,
            "kernel_launches": int(sum(table.counts.values())),
            "groupnorm_device_ms": gn_ms,
            "groupnorm_kernel_launches": gn_n,
            "int8_device_ms": int8_ms,
            "int8_kernel_launches": int8_n,
            "top_kernels": [{"name": k[:90], "count": int(n),
                             "device_ms": sec * 1e3}
                            for k, sec, n in table.top(25)]}
    log(f"[{tag}] one traced step: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy_s * 1e3:.1f} ms ({100 * info['device_busy_share']:.1f}%)"
        f", {info['kernel_launches']} kernel launches")
    if gn_n:
        log(f"[{tag}] GroupNorm kernels: {info['groupnorm_device_ms']:.3f} "
            f"device ms over {info['groupnorm_kernel_launches']} launches "
            f"({100 * info['groupnorm_device_ms'] / 1e3 / busy_s:.1f}% of "
            f"the busy time)")
    if int8_n:
        log(f"[{tag}] int8 product: {info['int8_device_ms']:.3f} device ms "
            f"over {info['int8_kernel_launches']} launches")
    for k in info["top_kernels"]:
        log(f"[{tag}]   {k['device_ms']:9.3f} ms  x{k['count']:<5d} "
            f"{k['name']}")
    return info


# -- phase 10 ----------------------------------------------------------------

def phase_train_identity(dev) -> dict:
    """f32, TF32 off: the flash kernels against plain autograd attention
    in the loss, every gradient, and the parameters after one SGD step."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers

    set_tf32(False)
    batch = engine.to_device(_lm_batch(2, 256, seed=5), dev)
    models = {a: _train_model(2, a, torch.float32, seed=7).to(dev)
              for a in ("flash", "full")}
    got = {}
    for attention, model in models.items():
        (loss, _), grads = engine.make_grad_fn(model, "masked_lm")(batch)
        got[attention] = (loss.item(), grads)
    loss_rel = abs(got["flash"][0] - got["full"][0]) / abs(got["full"][0])
    grad_rel = {n: ((g - got["full"][1][n]).norm()
                    / got["full"][1][n].norm().clamp(min=1e-30)).item()
                for n, g in got["flash"][1].items()}
    tx = optimizers.get("sgd", 0.1)
    for attention, model in models.items():
        state = engine.create_train_state(model, tx, device=dev)
        engine.make_train_step(model, "masked_lm", tx)(state, batch)
    param_err = max((pf - pr).abs().max().item() for pf, pr in zip(
        models["flash"].parameters(), models["full"].parameters()))
    worst = max(grad_rel, key=grad_rel.get)
    info = {"loss_flash": got["flash"][0], "loss_full": got["full"][0],
            "loss_rel": loss_rel, "max_grad_rel": grad_rel[worst],
            "worst_grad": worst, "sgd_param_max_abs_err": param_err}
    log(f"[identity] f32 flash vs full, 2 layers b=2 t=256: loss "
        f"{got['flash'][0]:.6f} vs {got['full'][0]:.6f} (rel {loss_rel:.2e}, "
        f"bound 1e-5), worst grad rel {grad_rel[worst]:.2e} ({worst}, bound "
        f"1e-4), params after one SGD step {param_err:.2e} (bound 1e-6)")
    assert loss_rel <= 1e-5 and grad_rel[worst] <= 1e-4 \
        and param_err <= 1e-6, info
    return info


# -- phase 11 ----------------------------------------------------------------

#: the four int8 products of a GPT-2-small block at batch 8 x 2048 (M
#: rows): (name, K, N)
INT8_CASES = (("qkv", 768, 2304), ("out", 768, 768), ("fc1", 768, 3072),
              ("fc2", 3072, 768))
INT8_M = 16384
#: BERT-base's four products at config 4's 32 x 128 tokens (phase 28 (b))
INT8_BERT_CASES = (("bert_qkv", 768, 2304), ("bert_out", 768, 768),
                   ("bert_fc1", 768, 3072), ("bert_fc2", 3072, 768))
INT8_BERT_M = 4096


def _int8_bound(m, k, n, out_dtype):
    """Least time for one product: qx, qw read once and the output
    written once at the HBM rate, against 2*M*N*K int8 operations at the
    int8 tensor-core peak."""
    out_item = torch.finfo(out_dtype).bits // 8
    moved = m * k + n * k + m * n * out_item + 4
    t_bytes = moved / hbm_bytes_per_s() * 1e3
    t_ops = 2 * m * n * k / peak_flops(torch.int8) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "ops": 2 * m * n * k}


def phase_int8_kernel(dev) -> list:
    """The int8 kernel against its plain version at the four products
    of the int8 train path (bf16 output, as the path writes it) and at
    BERT-base's four at 4,096 rows, bitwise; with its time, the plain
    version's, ``torch._int_mm`` plus the scale multiply (the library
    yardstick) and the bound."""
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for name, k, n, m in ([(*c, INT8_M) for c in INT8_CASES]
                          + [(*c, INT8_BERT_M) for c in INT8_BERT_CASES]):
        rng = np.random.default_rng(k + n)
        qx = torch.from_numpy(rng.integers(-127, 128, (m, k))
                              .astype(np.int8)).to(dev)
        qw = torch.from_numpy(rng.integers(-127, 128, (n, k))
                              .astype(np.int8)).to(dev)
        sxw = torch.tensor(rng.uniform(1e-4, 1e-2), dtype=torch.float32,
                           device=dev)
        out_dtype = torch.bfloat16
        got = i8.int8_matmul_dequant(qx, qw, sxw, out_dtype)
        want = i8.int8_matmul_dequant_reference(qx, qw, sxw, out_dtype)
        lib = (torch._int_mm(qx, qw.t()).float() * sxw).to(out_dtype)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.float() - want.float()).abs().max().item()
        plan = i8.kernel_plan(m, n, k, out_dtype, dev)
        assert plan == i8.plan(m, n, k, out_dtype, sms), plan
        ms, call_ms, source = _timed(
            lambda i: i8.int8_matmul_dequant(qx, qw, sxw, out_dtype), 30)
        plain_ms, _, _ = _timed(
            lambda i: i8.int8_matmul_dequant_reference(qx, qw, sxw,
                                                       out_dtype), 6)
        lib_ms, _, _ = _timed(lambda i: (torch._int_mm(qx, qw.t()).float()
                                         * sxw).to(out_dtype), 30)
        case = {"name": name, "m": m, "k": k, "n": n,
                "out_dtype": "bfloat16", "bitwise_equal": torch.equal(
                    got, want), "max_abs_err": err,
                "library_max_abs_err": lib_err, "ms": ms, "call_ms": call_ms,
                "ms_source": source, "plain_ms": plain_ms,
                "library_ms": lib_ms, **_int8_bound(m, k, n, out_dtype),
                "plan": plan._asdict()}
        case["x_bound"] = ms / case["bound_ms"]
        cases.append(case)
        log(f"[int8] {name} [{m}, {k}] x [{n}, {k}] -> bf16: bitwise "
            f"{case['bitwise_equal']} (max abs err {err:.3e}; _int_mm "
            f"{lib_err:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"_int_mm + scale {lib_ms:.4f} ms ({source}; with the host "
            f"{call_ms:.4f} ms), bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']}), {case['x_bound']:.2f}x the bound; plan "
            f"{tuple(plan)}")
        assert case["bitwise_equal"], case
        del qx, qw, got, want, lib
    torch.cuda.empty_cache()
    return cases


# -- phase 12 ----------------------------------------------------------------

def _int8_train_run(dev, precision, steps, timed=False):
    """Phase 8's configuration under ``precision``: adamw(1e-3), wrapped
    in overflow_guard where the policy scales the loss, ``steps`` steps
    on the seeded batch. Returns (losses, state, step, batch, info)."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch import precision as precision_lib
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    set_tf32(False)
    model = _train_model(12, "flash", torch.bfloat16, seed=0,
                         precision=precision)
    policy = precision_lib.get_policy(precision)
    tx = optimizers.get("adamw", 1e-3)
    if policy.loss_scale != 1.0:
        tx = precision_lib.overflow_guard(tx, policy)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "masked_lm", tx,
                                  precision=precision)
    batch = engine.to_device(_lm_batch(TRAIN_B, TRAIN_T, seed=1), dev)
    kernels = (i8.int8_matmul_dequant, fa.flash_attention_fwd,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
    info = {"launches": {k.__name__: k.launches for k in kernels},
            "step_s": times, "peak_bytes": torch.cuda.max_memory_allocated(
                dev)}
    return losses, state, step, batch, info


def phase_int8_train(dev, power_line) -> tuple:
    """Path A: step_probe's gpt configuration with precision="int8" on
    the card, 1 warm-up and 4 timed steps; every block Dense through the
    int8 kernel (48 launches a step), attention through the flash kernels
    (12 of each a step)."""
    losses, state, step, batch, run = _int8_train_run(dev, "int8", 5)
    guard = state.opt_state
    median_s = statistics.median(run["step_s"][1:])
    info = {"losses": losses, "step_s": run["step_s"],
            "median_step_s": median_s,
            "tokens_per_s": TRAIN_B * TRAIN_T / median_s,
            "peak_bytes": run["peak_bytes"], "launches": run["launches"],
            "loss_scale": guard.scale, "good_steps": guard.good_steps,
            "card": power_line, "card_after": smi_sample()}
    log(f"[int8-train] gpt-2-small widths, seq {TRAIN_T}, batch {TRAIN_B}, "
        f"precision='int8', overflow_guard(adamw(1e-3)): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; median step "
        f"{median_s * 1e3:.1f} ms of 4 timed (warm-up "
        f"{run['step_s'][0] * 1e3:.1f} ms), {info['tokens_per_s']:.0f} "
        f"tokens/s, peak {run['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{run['launches']}, loss scale {guard.scale} after "
        f"{guard.good_steps} clean steps [{power_line}; after: "
        f"{info['card_after']}]")
    assert all(math.isfinite(x) for x in losses), losses
    steps = len(losses)
    # witness (ii): the guard's scale is still the policy's 16, no step
    # skipped
    assert guard.scale == 16.0 and guard.good_steps == steps, info
    assert run["launches"]["int8_matmul_dequant"] == 48 * steps, run
    assert all(run["launches"][k] == 12 * steps for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")), run
    return info, (state, step, batch)


def _qkv_errors(dev) -> tuple:
    """Relative errors (norm of the difference over the norm) of the
    first block's qkv product on phase 12's batch, under int8 and under
    a bf16 product, each against the float32 product of the same bf16
    operands: int8 rounds every operand to one of 255 codes, bf16 only
    the output, so the first is an order of magnitude above the second."""
    import torch.nn.functional as F

    model = _train_model(1, "flash", torch.bfloat16, seed=0,
                         precision="int8").to(dev)
    qkv = model.layers[0].attn.qkv
    seen = []
    hook = qkv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    ids = torch.from_numpy(_lm_batch(TRAIN_B, TRAIN_T, seed=1)["features"])
    with torch.no_grad():
        model(ids.to(dev))
        hook.remove()
        x = seen[0]
        w, b = qkv.weight.to(x.dtype), qkv.bias.to(x.dtype)
        want = F.linear(x.float(), w.float(), b.float())
        errors = tuple(((y.float() - want).norm() / want.norm()).item()
                       for y in (qkv(x), F.linear(x, w, b)))
    del model, seen, x, want
    torch.cuda.empty_cache()
    return errors


def phase_int8_witness(dev, int8_losses) -> dict:
    """Witnesses (i) and (iii) of phase 12 ((ii), the guard's scale 16
    with no step skipped, is asserted there): (i) the same steps with the
    int8 product swapped for its plain version (in this script only):
    step 1's loss equal, steps 2-5 within 1e-4 relative; (iii) step 1
    under precision="bf16" within 2e-2 relative of int8's and not equal
    to it, and, since a loss cannot tell int8 from bf16 rounding, the
    first block's qkv product on the same batch under int8 at least 4x
    as far from float32 as under bf16 (quantization ran)."""
    from unittest import mock

    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    with mock.patch.object(i8, "int8_matmul_dequant",
                           i8.int8_matmul_dequant_reference):
        plain, *_ = _int8_train_run(dev, "int8", len(int8_losses))
    torch.cuda.empty_cache()
    bf16, *_ = _int8_train_run(dev, "bf16", 1)
    torch.cuda.empty_cache()
    qkv_int8, qkv_bf16 = _qkv_errors(dev)
    diff = [abs(a - b) / abs(b) for a, b in zip(int8_losses, plain)]
    bf16_rel = abs(bf16[0] - int8_losses[0]) / abs(bf16[0])
    info = {"plain_int8_losses": plain, "rel_diff": diff,
            "bf16_step1_loss": bf16[0], "bf16_step1_rel": bf16_rel,
            "qkv_rel_err_int8": qkv_int8, "qkv_rel_err_bf16": qkv_bf16}
    log(f"[int8-witness] plain int8 product: losses "
        f"{', '.join(f'{x:.6f}' for x in plain)} (kernel "
        f"{', '.join(f'{x:.6f}' for x in int8_losses)}; relative "
        f"differences {', '.join(f'{x:.2e}' for x in diff)}, step 1 must be "
        f"equal, steps 2-5 within 1e-4); bf16 step 1 {bf16[0]:.6f} "
        f"(relative {bf16_rel:.2e} from int8's, bound 2e-2, must differ); "
        f"block 0 qkv against float32: int8 {qkv_int8:.3e}, bf16 "
        f"{qkv_bf16:.3e} (int8 must be at least 4x bf16)")
    assert plain[0] == int8_losses[0], info
    assert max(diff[1:]) <= 1e-4, info
    assert 0 < bf16_rel <= 2e-2, info
    assert qkv_int8 >= 4 * qkv_bf16 and qkv_int8 <= 5e-2, info
    return info


# -- phase 13 ----------------------------------------------------------------

#: ResNet-50 at b=128, 224^2: one norm of each C/G class (2: the stem,
#: 4, 8: stage-0 norm3, 16, 32, 64: stage-3 norm3), all on the cluster
#: path
GN_CASES = ((128, 12544, 64), (128, 784, 128), (128, 3136, 256),
            (128, 784, 512), (128, 196, 1024), (128, 49, 2048))
#: a 512^2 stem in float32: the streaming path, forward and backward
GN_STREAM_CASE = (2, 65536, 64)
GN_GROUPS = 32


def _gn_bound(shape, dtype, backward):
    """Least time for one call: each input read once and each output
    written once at the HBM rate (x -> y plus gamma, beta, stats forward;
    x, dy, gamma, stats -> dx plus the per-sample partials backward)."""
    b, hw, c = shape
    item = torch.finfo(dtype).bits // 8
    tensor = b * hw * c * item
    stats = b * 2 * GN_GROUPS * 4
    moved = (3 * tensor + c * 4 + stats + 2 * b * c * 4 if backward
             else 2 * tensor + 2 * c * 4 + stats)
    return {"bound_ms": moved / hbm_bytes_per_s() * 1e3, "bound_by": "bytes",
            "bytes": moved}


def _gn_errors(got, want):
    """y, dx and the partials bitwise; the stats within one float32 ulp
    (a float64 sum rounded once, csrc/groupnorm.cu); with each output's
    largest error."""
    errs, ok = {}, True
    for name in ("y", "stats", "dx", "dgamma_p", "dbeta_p"):
        g, w = got[name], want[name]
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - w.float()).abs().max().item()
        if name == "stats":
            ulp = torch.nextafter(w.abs(), torch.full_like(w, math.inf)) \
                - w.abs()
            good = bool(((g - w).abs() <= ulp).all())
        else:
            good = torch.equal(g, w)
        errs[name] = {"max_abs_err": err, "bitwise": torch.equal(g, w),
                      "max_abs_ref": w.float().abs().max().item()}
        ok &= good
    return errs, ok


def phase_gn_kernels(dev) -> list:
    """The GroupNorm kernels against their plain versions at one
    ResNet-50 b=128 norm of each C/G class, bf16 and float32 (TF32 off),
    and at the streaming case: bitwise (stats within one ulp), with each
    call's plan, the kernels' times, their bounds and ``F.group_norm``'s
    (forward) and its autograd backward on the same tensors viewed as
    NCHW; the plain versions' times at the stem."""
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    set_tf32(False)
    cases = []
    runs = [(shape, dtype) for shape in GN_CASES
            for dtype in (torch.bfloat16, torch.float32)]
    runs.append((GN_STREAM_CASE, torch.float32))
    for shape, dtype in runs:
        b, hw, c = shape
        side = int(round(math.sqrt(hw)))
        rng = np.random.default_rng(hw + c)
        mk = lambda *s: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev)
        x, dy = mk(*shape).to(dtype), mk(*shape).to(dtype)
        gamma, beta = 1.0 + 0.1 * mk(c), 0.1 * mk(c)
        y, stats = gn.group_norm_fwd(x, gamma, beta, GN_GROUPS)
        y_ref, stats_ref = gn.group_norm_fwd_reference(
            x, gamma, beta, GN_GROUPS, 1e-6)
        dx, dgp, dbp = gn.group_norm_bwd(x, gamma, stats_ref, dy, GN_GROUPS)
        dx_ref, dgp_ref, dbp_ref = gn.group_norm_bwd_reference(
            x, gamma, stats_ref, dy, GN_GROUPS)
        torch.cuda.synchronize()
        errs, ok = _gn_errors(
            {"y": y, "stats": stats, "dx": dx, "dgamma_p": dgp,
             "dbeta_p": dbp},
            {"y": y_ref, "stats": stats_ref, "dx": dx_ref,
             "dgamma_p": dgp_ref, "dbeta_p": dbp_ref})
        del y, y_ref, dx, dx_ref
        # library yardstick: F.group_norm over the NCHW view
        # (channels_last memory) of the same tensor
        xt = x.view(b, side, side, c).permute(0, 3, 1, 2)
        dyt = dy.view(b, side, side, c).permute(0, 3, 1, 2)
        xg = xt.detach().requires_grad_()
        gg, bg = (gamma.to(dtype).requires_grad_(),
                  beta.to(dtype).requires_grad_())
        lib_out = F.group_norm(xg, GN_GROUPS, gg, bg, 1e-6)
        iters = 10 if b * hw * c > 5e7 else 30
        plain = shape == GN_CASES[0]
        kernels = {}
        for part, backward in (("fwd", False), ("bwd", True)):
            if backward:
                call = lambda i: gn.group_norm_bwd(x, gamma, stats_ref, dy,
                                                   GN_GROUPS)
                ref = lambda i: gn.group_norm_bwd_reference(
                    x, gamma, stats_ref, dy, GN_GROUPS)
                lib = lambda i: torch.autograd.grad(
                    lib_out, (xg, gg, bg), dyt, retain_graph=True)
            else:
                call = lambda i: gn.group_norm_fwd(x, gamma, beta, GN_GROUPS)
                ref = lambda i: gn.group_norm_fwd_reference(
                    x, gamma, beta, GN_GROUPS, 1e-6)
                lib = lambda i: F.group_norm(xt, GN_GROUPS, gamma.to(dtype),
                                             beta.to(dtype), 1e-6)
            ms, call_ms, source = _timed(call, iters)
            kernels[part] = {
                "ms": ms, "call_ms": call_ms, "ms_source": source,
                "plain_ms": (_timed(ref, max(2, iters // 3))[0] if plain
                             else None),
                "library_ms": _timed(lib, iters)[0],
                "plan": gn.plan(shape, GN_GROUPS, dtype, backward)._asdict(),
                **_gn_bound(shape, dtype, backward)}
        case = {"shape": list(shape), "groups": GN_GROUPS,
                "dtype": str(dtype).split(".")[-1], "errors": errs,
                "kernels": kernels}
        cases.append(case)
        del xg, gg, bg, lib_out, x, dy
        torch.cuda.empty_cache()
        err_line = ", ".join(
            f"{n} {e['max_abs_err']:.3e}{' (bitwise)' if e['bitwise'] else ''}"
            for n, e in errs.items())
        log(f"[groupnorm] {tuple(shape)} G={GN_GROUPS} C/G={c // GN_GROUPS} "
            f"{case['dtype']}: {err_line}")
        for name, kk in kernels.items():
            p = kk["plan"]
            plain_txt = (f", plain {kk['plain_ms']:.4f} ms"
                         if kk["plain_ms"] is not None else "")
            log(f"[groupnorm]   {name}: kernel {kk['ms']:.4f} ms{plain_txt}, "
                f"F.group_norm {kk['library_ms']:.4f} ms ({kk['ms_source']};"
                f" with the host {kk['call_ms']:.4f} ms), bound "
                f"{kk['bound_ms']:.4f} ms ({kk['bound_by']}); plan "
                f"{p['path']}: {p['cols']} channels x {p['rows']} rows, "
                f"{p['tiles']} tiles, cluster {p['cluster']}, vec "
                f"{p['vec']}, {p['threads']} threads and {p['smem']} B "
                f"shared memory a CTA")
        assert ok, errs
    for d in ("fwd", "bwd"):
        assert any(c["kernels"][d]["plan"]["path"] == "stream"
                   for c in cases), f"no streaming case in {d}"
    return cases


# -- phase 14 ----------------------------------------------------------------

RESNET_B = 128


def _resnet_model(norm, dtype, seed):
    from distkeras_tpu_torch.models.resnet import init_params, resnet50

    return init_params(resnet50(dtype=dtype, norm=norm),
                       torch.Generator().manual_seed(seed))


def _image_batch(b, seed):
    """Seeded uint8 NHWC images and one-hot labels over 1000 classes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    return {"features": x, "labels": y}


def _resnet_run(dev, norm, steps):
    """resnet50(norm) in bf16 with float32 parameters,
    categorical_crossentropy, adamw(1e-3), ``steps`` steps on one seeded
    batch: (losses, state, step, batch, info)."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    set_tf32(False)
    model = _resnet_model(norm, torch.bfloat16, seed=0)
    tx = optimizers.get("adamw", 1e-3)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "categorical_crossentropy", tx,
                                  metrics=("accuracy",))
    batch = engine.to_device(_image_batch(RESNET_B, seed=1), dev)
    kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
    info = {"launches": {k.__name__: k.launches for k in kernels},
            "step_s": times,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    return losses, state, step, batch, info


def phase_resnet_train(dev, power_line) -> tuple:
    """Path B: resnet50() (GroupNorm) in bf16, batch 128 of seeded uint8
    224^2 images, adamw(1e-3): 1 warm-up and 4 timed steps, 53 GroupNorm
    forward and 53 backward launches a step."""
    losses, state, step, batch, run = _resnet_run(dev, "gn", 5)
    median_s = statistics.median(run["step_s"][1:])
    info = {"losses": losses, "step_s": run["step_s"],
            "median_step_s": median_s,
            "images_per_s": RESNET_B / median_s,
            "peak_bytes": run["peak_bytes"], "launches": run["launches"],
            "card": power_line, "card_after": smi_sample()}
    log(f"[resnet-train] resnet50() GroupNorm, batch {RESNET_B} x 224^2 "
        f"uint8, bf16 compute, f32 params, adamw(1e-3): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; median step "
        f"{median_s * 1e3:.1f} ms of 4 timed (warm-up "
        f"{run['step_s'][0] * 1e3:.1f} ms), {info['images_per_s']:.1f} "
        f"images/s, peak {run['peak_bytes'] / 2**30:.2f} GiB, GroupNorm "
        f"launches {run['launches']} [{power_line}; after: "
        f"{info['card_after']}]")
    assert all(math.isfinite(x) for x in losses), losses
    assert all(n == 53 * len(losses) for n in run["launches"].values()), run
    return info, (state, step, batch)


def phase_resnet_witness(dev, losses) -> dict:
    """The same steps with the GroupNorm kernels swapped for their plain
    versions (in this script only): steps 1-4 within 1e-3 relative."""
    from unittest import mock

    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    with mock.patch.object(gn, "group_norm_fwd",
                           gn.group_norm_fwd_reference), \
            mock.patch.object(gn, "group_norm_bwd",
                              gn.group_norm_bwd_reference):
        plain, *_ = _resnet_run(dev, "gn", len(losses))
    torch.cuda.empty_cache()
    diff = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    info = {"plain_losses": plain, "kernel_losses": losses,
            "rel_diff": diff}
    log(f"[resnet-witness] plain GroupNorm: losses "
        f"{', '.join(f'{x:.5f}' for x in plain)} (kernels "
        f"{', '.join(f'{x:.5f}' for x in losses)}; relative differences "
        f"{', '.join(f'{x:.2e}' for x in diff)}, steps 1-4 bound 1e-3)")
    assert max(diff[:4]) <= 1e-3, info
    return info


def phase_resnet_identity(dev) -> dict:
    """float32 with TF32 off in matmuls AND cuDNN convolutions, and
    cuDNN's deterministic algorithms (its float32 backward otherwise sums
    in an order that changes from run to run, which is not what this
    compares): resnet50() at b=2, its norm scales and biases drawn at
    random (so that no branch is hidden behind a zero-init scale), the
    GroupNorm kernels against their plain versions in the loss, every
    gradient, and the parameters after one SGD step."""
    import copy
    from unittest import mock

    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    set_tf32(False)
    model = _resnet_model("gn", torch.float32, seed=7)
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, gn.GroupNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape,
                                                       generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    models = {"kernel": model.to(dev), "plain": copy.deepcopy(model).to(dev)}
    batch = engine.to_device(_image_batch(2, seed=9), dev)
    plain_gn = (mock.patch.object(gn, "group_norm_fwd",
                                  gn.group_norm_fwd_reference),
                mock.patch.object(gn, "group_norm_bwd",
                                  gn.group_norm_bwd_reference))
    tx = optimizers.get("sgd", 0.1)
    got = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for name, m in models.items():
        patches = plain_gn if name == "plain" else ()
        for p in patches:
            p.start()
        try:
            (loss, _), grads = engine.make_grad_fn(
                m, "categorical_crossentropy")(batch)
            got[name] = (loss.item(), grads)
            state = engine.create_train_state(m, tx, device=dev)
            engine.make_train_step(m, "categorical_crossentropy", tx)(
                state, batch)
        finally:
            for p in patches:
                p.stop()
    torch.backends.cudnn.deterministic = deterministic
    loss_rel = abs(got["kernel"][0] - got["plain"][0]) / abs(got["plain"][0])
    grad_rel = {n: ((g - got["plain"][1][n]).norm()
                    / got["plain"][1][n].norm().clamp(min=1e-30)).item()
                for n, g in got["kernel"][1].items()}
    param_err = max((a - b).abs().max().item() for a, b in zip(
        models["kernel"].parameters(), models["plain"].parameters()))
    worst = max(grad_rel, key=grad_rel.get)
    info = {"loss_kernel": got["kernel"][0], "loss_plain": got["plain"][0],
            "loss_rel": loss_rel, "max_grad_rel": grad_rel[worst],
            "worst_grad": worst, "sgd_param_max_abs_err": param_err,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32]}
    log(f"[resnet-identity] f32 (TF32 off: matmul, cuDNN; deterministic "
        f"cuDNN) resnet50() b=2, "
        f"GroupNorm kernels vs plain: loss {got['kernel'][0]:.6f} vs "
        f"{got['plain'][0]:.6f} (rel {loss_rel:.2e}, bound 1e-5), worst "
        f"grad rel {grad_rel[worst]:.2e} ({worst}, bound 1e-4), params "
        f"after one SGD step {param_err:.2e} (bound 1e-6)")
    assert not any(info["tf32"])
    assert loss_rel <= 1e-5 and grad_rel[worst] <= 1e-4 \
        and param_err <= 1e-6, info
    del models, model
    torch.cuda.empty_cache()
    return info


def phase_nf(dev, power_line) -> dict:
    """The NF recipe's first card run: resnet50_nf() in bf16, batch 128,
    2 adamw steps; finite losses and the step time (no kernel of the
    port runs: Scaled-WS convolutions on cuDNN)."""
    losses, _, _, _, run = _resnet_run(dev, "nf", 2)
    info = {"losses": losses, "step_s": run["step_s"],
            "peak_bytes": run["peak_bytes"], "card": power_line}
    log(f"[nf] resnet50_nf() bf16 batch {RESNET_B}: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, steps "
        f"{', '.join(f'{x * 1e3:.1f}' for x in run['step_s'])} ms (the "
        f"first includes warm-up), peak {run['peak_bytes'] / 2**30:.2f} GiB")
    assert all(math.isfinite(x) for x in losses), losses
    assert all(n == 0 for n in run["launches"].values()), run
    torch.cuda.empty_cache()
    return info


# -- phases 16-18 -------------------------------------------------------------

def phase_rect(dev, power_line) -> dict:
    """The engine's default pool (``page_size=None``: one full-context
    row a slot, plain attention over it) on phase 4's traffic, a traced
    run for its busy share, and phase 5's float32 greedy check."""
    from distkeras_tpu_torch.serving import GenerationEngine

    model = _gpt_small_bf16()
    info = _engine_run(dev, model, power_line, "rect")
    assert info["launches"] == 0 and info["compiles"] == 6, info
    with GenerationEngine(model, device=dev, **ENGINE_KW) as eng:
        info["profile"] = _traced_serve(eng, "rect-profile")
    assert info["profile"]["paged_kernels_traced"] == 0, info["profile"]
    del model
    torch.cuda.empty_cache()
    info["greedy"] = phase_greedy(dev, tag="rect-greedy", page_size=None)
    return info


def phase_sampled(dev) -> dict:
    """``sampling=True, temperature=0.7`` in bf16 on both pools: two
    engines fed the same requests in the same order give the same
    streams, another seed another stream, every token in the vocabulary."""
    from distkeras_tpu_torch.serving import GenerationEngine

    model = _gpt_small_bf16()
    prompts = _serving_prompts()[:4]
    info = {}
    for pool, page_size in (("paged", PAGE), ("rect", None)):
        streams = []
        for seed in (321, 321, 322):
            with GenerationEngine(model, device=dev, page_size=page_size,
                                  sampling=True, temperature=0.7,
                                  seed=seed, **ENGINE_KW) as eng:
                streams.append([f.result(timeout=600).tokens.tolist()
                                for f in [eng.generate(p, max_new_tokens=16)
                                          for p in prompts]])
        assert streams[0] == streams[1], (pool, streams[:2])
        assert streams[0] != streams[2], pool
        assert all(0 <= t < model.vocab_size for s in streams for r in s
                   for t in r)
        info[pool] = {"seed_321": streams[0], "seed_322": streams[2]}
        log(f"[sampled] {pool}: seed 321 twice gives the same "
            f"{sum(map(len, streams[0]))} tokens, seed 322 another stream")
    del model
    torch.cuda.empty_cache()
    return info


def phase_chunked(dev, power_line) -> dict:
    """Chunked prefill on the paged pool: phase 5's float32 greedy check
    with ``prefill_chunk=16`` (the 40-token prompt in three chunks, at
    cursors 0, 16 and 32; the chunk shares the 16-token bucket's graph),
    then phase 4's traffic in bf16 with ``prefill_chunk=32`` (the
    32-token bucket's graph)."""
    info = {"greedy": phase_greedy(dev, tag="chunked-greedy",
                                   page_size=PAGE, prefill_chunk=16)}
    model = _gpt_small_bf16()
    info.update(_engine_run(dev, model, power_line, "chunked",
                            page_size=PAGE, prefill_chunk=32))
    assert info["compiled_executables"]["prefill_chunk"] == (32,)
    assert info["compiles"] == 6, info["compiled_executables"]
    assert info["launches"] == model.num_layers * info["model_calls"] > 0
    del model
    torch.cuda.empty_cache()
    return info


# -- phases 19-21 -------------------------------------------------------------

#: phase 19's traffic: PREFIX_SYSTEMS system prompts of PREFIX_SYSTEM_LEN
#: tokens, each served alone first (parked in the prefix cache), then
#: SERVE_REQUESTS requests of a system prompt and a seeded tail of 8-32
#: tokens, SERVE_NEW new tokens each, SLOTS in flight
PREFIX_SYSTEMS = 8
PREFIX_SYSTEM_LEN = 96
#: host RAM the prefix cache may hold
PREFIX_BUDGET = 4 << 30


def _prefix_traffic(vocab):
    rng = np.random.default_rng(19)
    systems = [rng.integers(1, vocab, PREFIX_SYSTEM_LEN).tolist()
               for _ in range(PREFIX_SYSTEMS)]
    requests = [systems[int(rng.integers(PREFIX_SYSTEMS))]
                + rng.integers(1, vocab, int(rng.integers(8, 33))).tolist()
                for _ in range(SERVE_REQUESTS)]
    return systems, requests


def _counted(eng, prompts, new, tag) -> dict:
    """One closed-loop window (:func:`_serve_window`) of ``prompts`` on
    ``eng`` with the paged kernel's count zeroed just before and read
    just after: its numbers, the tokens, and the launches beside the
    model calls (each launches the kernel once a layer)."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    tokens = {}
    calls = lambda: sum(telemetry.counter(n).value for n in DECODE_CALLS)
    calls0 = calls()
    fa.paged_flash_attention.launches = 0
    info = _serve_window(eng, prompts, new, tokens)
    info["launches"] = fa.paged_flash_attention.launches
    info["paged_calls"] = calls() - calls0
    info["tokens"] = [tokens[i] for i in range(len(prompts))]
    assert info["launches"] == eng.model.num_layers * info["paged_calls"], (
        tag, info["launches"], info["paged_calls"])
    return info


def _swap_round_trip(eng) -> dict:
    """The engine's swap pair on its graphs, over a full slot's worth of
    pages (pages 0..pmax-1): gathered into pinned host memory, zeroed
    in the pool, scattered back: every leaf bitwise; then each step's
    host time at 8 pages and at 64."""
    from distkeras_tpu_torch.serving.kv_cache import tree_leaves

    pmax = eng.pool.pages_per_slot
    ids = np.arange(pmax, dtype=np.int32)
    torch.cuda.synchronize()
    before = [x.clone() for x in tree_leaves(eng.pool.pool)]
    t0 = time.perf_counter()
    eng._swap_runs["out"](page_ids=ids)
    parked = eng._swap_runs["out"].fetch_rows(pmax)
    out_s = time.perf_counter() - t0
    with torch.cuda.stream(eng.stream):
        for leaf in tree_leaves(eng.pool.pool):
            leaf[:pmax] = 0
    t0 = time.perf_counter()
    eng._swap_runs["in"](page_ids=ids, **{
        f"leaf{i}": x for i, x in enumerate(parked)})
    eng.stream.synchronize()
    in_s = time.perf_counter() - t0
    same = all(torch.equal(a, b)
               for a, b in zip(tree_leaves(eng.pool.pool), before))
    nbytes = sum(x.nbytes for x in parked)
    assert same, "swap out and back in changed the pool"
    # the swap pair's steps apart, for a prefill's 8 pages and for 64: the
    # gather graph, the copy into pinned host memory, the swap-in
    run = eng._swap_runs["out"]
    steps = {}
    for n in (8, pmax):
        t0 = time.perf_counter()
        run(page_ids=ids)
        eng.stream.synchronize()
        t1 = time.perf_counter()
        rows = run.fetch_rows(n)
        t2 = time.perf_counter()
        eng._swap_runs["in"](page_ids=ids, **{
            f"leaf{i}": x for i, x in enumerate(rows)})
        eng.stream.synchronize()
        steps[n] = {"gather_s": t1 - t0, "fetch_rows_s": t2 - t1,
                    "swap_in_s": time.perf_counter() - t2}
    return {"pages": pmax, "bytes": nbytes, "swap_out_s": out_s,
            "swap_in_s": in_s, "bitwise": same,
            "parked_pinned": parked[0].is_pinned(), "steps": steps}


def _host_seconds(obj, names) -> dict:
    """Wrap methods ``names`` of ``obj`` (an instance) to add up their
    calls and host seconds into the returned dict, read after traffic."""
    spent = {name: {"calls": 0, "s": 0.0} for name in names}
    for name in names:
        def timed(*a, _fn=getattr(obj, name), _rec=spent[name], **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                _rec["calls"] += 1
                _rec["s"] += time.perf_counter() - t0
        setattr(obj, name, timed)
    return spent


def phase_prefix(dev, power_line) -> dict:
    """The prefix cache with host swap: in float32 (TF32 off) the same
    traffic with the cache on and off gives the same greedy tokens; in
    bf16 the same traffic's TTFT and tokens/s with the cache on and off;
    the swap pair's round trip on the bf16 engine is bitwise."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.serving import GenerationEngine

    set_tf32(False)
    info = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_params(gpt_small(dtype=dtype),
                            torch.Generator().manual_seed(0))
        systems, requests = _prefix_traffic(model.vocab_size)
        name = str(dtype).split(".")[-1]
        for cache in (True, False):
            tag = f"prefix-{name}-{'on' if cache else 'off'}"
            telemetry.reset()
            kw = dict(prefix_cache_bytes=PREFIX_BUDGET) if cache else {}
            with GenerationEngine(model, device=dev, page_size=PAGE,
                                  **ENGINE_KW, **kw) as eng:
                declared = eng.compiled_executables
                compiles = telemetry.counter("serving.decode.compiles").value
                warm = _counted(eng, systems, SERVE_NEW, tag)
                host = _host_seconds(eng, ("_prefill_paged", "_emit",
                                           "_decode_step"))
                if cache:
                    host.update(_host_seconds(eng, ("_capture_prefix",
                                                    "_swap_in_entry")))
                    host.update(_host_seconds(eng._prefix, ("lookup",
                                                            "insert")))
                    host.update(_host_seconds(eng._swap_runs["out"],
                                              ("fetch_rows",)))
                run = _counted(eng, requests, SERVE_NEW, tag)
                run["host_seconds"] = host
                assert eng.compiled_executables == declared
                assert telemetry.counter(
                    "serving.decode.compiles").value == compiles
                if cache and dtype == torch.bfloat16:
                    run["swap_round_trip"] = _swap_round_trip(eng)
            count = lambda n: telemetry.counter(n).value  # noqa: E731
            run.update(systems_tokens=warm.pop("tokens"), card=power_line,
                       compiled_executables=declared, compiles=compiles,
                       hits=count("serving.decode.prefix.hits"),
                       misses=count("serving.decode.prefix.misses"),
                       full_hits=count("serving.decode.prefix.full_hits"),
                       swapped_in=count("serving.decode.paged.swapped_in"),
                       swapped_out=count(
                           "serving.decode.paged.swapped_out"),
                       evictions=count("serving.decode.prefix.evictions"),
                       prefix_bytes=telemetry.gauge(
                           "serving.decode.prefix.bytes").value)
            lookups = run["hits"] + run["misses"]
            run["hit_rate"] = run["hits"] / lookups if lookups else 0.0
            if cache:
                assert declared["swap"] == ("in", "out") and compiles == 8
                assert run["hits"] >= SERVE_REQUESTS, run["hits"]
            info[tag] = run
            log(f"[{tag}] {len(requests)} requests x {SERVE_NEW} new "
                f"tokens after {len(systems)} system prompts, {SLOTS} in "
                f"flight: {run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                f"{run['ttft_p50_s'] * 1e3:.2f} ms (max "
                f"{run['ttft_max_s'] * 1e3:.2f} ms), prefix hits "
                f"{run['hits']}/{lookups} ({100 * run['hit_rate']:.1f}%), "
                f"full hits {run['full_hits']}, pages swapped in "
                f"{run['swapped_in']} / out {run['swapped_out']}, "
                f"evictions {run['evictions']}, {run['paged_calls']} paged "
                f"calls, {run['launches']} kernel launches [{power_line}]")
            log(f"[{tag}] host seconds in the window: " + ", ".join(
                f"{k} {v['s']:.3f} s / {v['calls']} calls"
                for k, v in run["host_seconds"].items()))
        on, off = info[f"prefix-{name}-on"], info[f"prefix-{name}-off"]
        if dtype == torch.float32:
            assert on["tokens"] == off["tokens"], "cache changed the tokens"
            assert on["systems_tokens"] == off["systems_tokens"]
            log(f"[prefix] float32: the {len(requests)} requests' greedy "
                f"tokens with the cache equal those without it")
        else:
            rt = on["swap_round_trip"]
            log(f"[prefix] bf16 swap round trip over {rt['pages']} pages "
                f"({rt['bytes'] / 2**20:.1f} MiB): bitwise; out "
                f"{rt['swap_out_s'] * 1e3:.2f} ms, in "
                f"{rt['swap_in_s'] * 1e3:.2f} ms (host clock); parked "
                f"data pinned: {rt['parked_pinned']} [{power_line}]")
            for n, st in rt["steps"].items():
                log(f"[prefix] {n} pages, host clock: gather graph "
                    f"{st['gather_s'] * 1e3:.3f} ms, into pinned host "
                    f"memory {st['fetch_rows_s'] * 1e3:.3f} ms, swap-in "
                    f"{st['swap_in_s'] * 1e3:.3f} ms [{power_line}]")
        for run in (on, off):
            run.pop("tokens")
        del model
        torch.cuda.empty_cache()
    return info


def _plain_paged():
    """A stand-in for the paged kernel's wrapper that runs its plain
    version (counting nothing)."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    plain = lambda *a: fa.paged_flash_attention_reference(*a)  # noqa: E731
    plain.launches = plain.captured = 0
    return plain


def _engine_tokens(dev, model, prompts, new, **kw) -> list:
    from distkeras_tpu_torch.serving import GenerationEngine

    with GenerationEngine(model, device=dev, num_slots=2,
                          prefill_buckets=(16, 64), **kw) as eng:
        return [f.result(timeout=600).tokens.tolist() for f in
                [eng.generate(p, max_new_tokens=new) for p in prompts]]


def phase_int8(dev, power_line) -> dict:
    """int8 KV pages: in float32 (TF32 off) gpt_small's greedy tokens on
    the int8 pool equal those of the same engine with the paged kernel
    swapped for its plain version; then phase 4's windows in bf16 on the
    int8 pool: tokens/s, and the pool's bytes against native pages."""
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving.kv_cache import PagedKVCachePool

    set_tf32(False)
    model = init_params(gpt_small(dtype=torch.float32),
                        torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, model.vocab_size, n).tolist()
               for n in (9, 40)]
    fa.paged_flash_attention.launches = 0
    got = _engine_tokens(dev, model, prompts, 12, page_size=PAGE,
                         kv_dtype="int8")
    launches = fa.paged_flash_attention.launches
    assert launches > 0, "the int8 engine did not reach the paged kernel"
    kernel = fa.paged_flash_attention
    fa.paged_flash_attention = _plain_paged()
    try:
        want = _engine_tokens(dev, model, prompts, 12, page_size=PAGE,
                              kv_dtype="int8")
    finally:
        fa.paged_flash_attention = kernel
    assert got == want, (got, want)
    log(f"[int8] gpt_small float32 int8-KV engine tokens == the same "
        f"engine through the plain attention on {sum(map(len, got))} "
        f"tokens ({launches} paged kernel calls)")
    del model
    model = _gpt_small_bf16()
    info = {"greedy_tokens_checked": sum(map(len, got)),
            "greedy_paged_launches": launches}
    info.update(_engine_run(dev, model, power_line, "int8", page_size=PAGE,
                            kv_dtype="int8"))
    assert info["launches"] == model.num_layers * info["model_calls"] > 0
    assert info["compiles"] == 6, info["compiled_executables"]
    native = PagedKVCachePool(model, SLOTS, page_size=PAGE, device="meta")
    int8 = PagedKVCachePool(model, SLOTS, page_size=PAGE, device="meta",
                            kv_dtype="int8")
    info.update(pool_bytes=int8.cache_bytes,
                native_pool_bytes=native.cache_bytes,
                kv_quant_bytes_saved=int8.kv_quant_bytes_saved)
    log(f"[int8] pool {int8.cache_bytes / 2**20:.2f} MiB against "
        f"{native.cache_bytes / 2**20:.2f} MiB native bf16 "
        f"({int8.cache_bytes / native.cache_bytes:.3f}x) at {SLOTS} slots "
        f"x {PMAX} pages [{power_line}]")
    del model
    torch.cuda.empty_cache()
    return info


def _spec_prompts(vocab, n, seed):
    """Prompts that repeat a seeded 16-token phrase (2 or 3 times), then
    a seeded tail of 0-8 tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        phrase = rng.integers(1, vocab, 16).tolist()
        out.append(phrase * int(rng.integers(2, 4))
                   + rng.integers(1, vocab, int(rng.integers(0, 9)))
                   .tolist())
    return out


def _draft_model(dtype):
    """The 2-layer draft: gpt_small's vocab, max_len and widths."""
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params

    return init_params(CausalLM(vocab_size=50304, max_len=1024,
                                num_layers=2, num_heads=12, width=768,
                                mlp_dim=3072, dtype=dtype),
                       torch.Generator().manual_seed(5))


def phase_spec(dev, power_line) -> dict:
    """Speculative decoding: in float32 (TF32 off) gpt_small's greedy
    tokens with an NgramDraft (spec_k=4) and with a 2-layer ModelDraft
    equal its plain greedy tokens; then in bf16 128 requests on the
    n-gram draft (closed loop, 8 in flight): accept rate and tokens/s,
    beside the same traffic with no draft."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.serving import (GenerationEngine, ModelDraft,
                                             NgramDraft)

    set_tf32(False)
    model = init_params(gpt_small(dtype=torch.float32),
                        torch.Generator().manual_seed(2))
    prompts = _spec_prompts(model.vocab_size, 4, seed=21)
    kw = dict(page_size=PAGE)
    plain = _engine_tokens(dev, model, prompts, 24, **kw)
    info = {}
    for name, make in (("ngram", NgramDraft),
                       ("model", lambda: ModelDraft(
                           _draft_model(torch.float32)))):
        telemetry.reset()
        got = _engine_tokens(dev, model, prompts, 24, draft=make(),
                             spec_k=SPEC_K, **kw)
        assert got == plain, (name, got, plain)
        acc = telemetry.counter("serving.decode.spec.accepted").value
        prop = telemetry.counter("serving.decode.spec.proposed").value
        info[f"greedy_{name}"] = {"tokens": sum(map(len, got)),
                                  "accepted": acc, "proposed": prop}
        log(f"[spec] gpt_small float32 spec tokens ({name} draft, spec_k "
            f"{SPEC_K}) == plain greedy tokens on {sum(map(len, got))} "
            f"tokens; accepted {acc}/{prop}")
    del model
    model = _gpt_small_bf16()
    traffic = _spec_prompts(model.vocab_size, SERVE_REQUESTS, seed=22)
    for name, extra in (("off", {}), ("ngram", dict(draft=NgramDraft(),
                                                   spec_k=SPEC_K))):
        telemetry.reset()
        with GenerationEngine(model, device=dev, page_size=PAGE,
                              **ENGINE_KW, **extra) as eng:
            declared = eng.compiled_executables
            compiles = telemetry.counter("serving.decode.compiles").value
            run = _counted(eng, traffic, SERVE_NEW, f"spec-{name}")
            assert eng.compiled_executables == declared
            assert telemetry.counter("serving.decode.compiles").value \
                == compiles
        run.pop("tokens")
        acc = telemetry.counter("serving.decode.spec.accepted").value
        prop = telemetry.counter("serving.decode.spec.proposed").value
        run.update(compiled_executables=declared, compiles=compiles,
                   accepted=acc, proposed=prop,
                   accept_rate=acc / prop if prop else 0.0,
                   iterations=telemetry.counter(
                       "serving.decode.spec.iterations").value,
                   card=power_line)
        if extra:
            assert declared["verify"] == LADDER and compiles == 10
            assert run["iterations"] > 0
        info[f"bf16_{name}"] = run
        log(f"[spec-{name}] gpt_small bf16 {len(traffic)} requests x "
            f"{SERVE_NEW} new tokens, {SLOTS} in flight: "
            f"{run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{run['ttft_p50_s'] * 1e3:.2f} ms, {run['paged_calls']} model "
            f"calls, accept rate {100 * run['accept_rate']:.1f}% "
            f"({acc}/{prop}) [{power_line}]")
    del model
    torch.cuda.empty_cache()
    return info


# -- phase 22 ----------------------------------------------------------------

#: phase 22's wire traffic: phase 4's long window (SERVE_REQUESTS requests
#: of 16-128 prompt tokens, SERVE_NEW new tokens) through WIRE_CLIENTS
#: client threads, each with its own connection (a closed loop); the swap
#: lands when request WIRE_SWAP_AT is submitted
WIRE_CLIENTS = 8
WIRE_SWAP_AT = 64
#: the float32 version-identity check's depth (gpt_small's widths) and
#: traffic: WIRE_PINNED requests in flight on v0, WIRE_AFTER admitted on
#: v1, WIRE_IDENTITY_NEW new tokens each
WIRE_IDENTITY_LAYERS = 4
WIRE_PINNED = 4
WIRE_AFTER = 4
WIRE_PINNED_NEW = 400
WIRE_IDENTITY_NEW = 48
#: seconds each v0 token's stream callback sleeps until v2 is pending
WIRE_HOLD_S = 0.005
#: the one-shot engine's rows: 128 tokens, the flash forward's smallest
#: length
WIRE_ROW = 128
WIRE_TOKEN = "chip-smoke"
#: gpt_small's widths (phase 22's models; depth set by each)
WIRE_LM = dict(vocab_size=50304, max_len=1024, num_heads=12, width=768,
               mlp_dim=3072)


def _perturbed(state, seed, scale=1e-2):
    """``state`` plus seeded noise of ``scale`` times each tensor's own
    standard deviation (1e-2 of 1 for a constant tensor): a new version
    of the same model, as float32 CPU tensors."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in state.items():
        t = t.detach().float().cpu()
        std = float(t.std()) if t.numel() > 1 and float(t.std()) > 0 else 1.0
        out[name] = t + scale * std * torch.randn(t.shape, generator=gen)
    return out


def _flash_lm(dtype, seed=0, num_layers=12):
    """gpt_small's widths with ``attention="flash"`` (the one-shot
    engine's model)."""
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params

    return init_params(CausalLM(num_layers=num_layers, dtype=dtype,
                                attention="flash", **WIRE_LM),
                       torch.Generator().manual_seed(seed))


def _wire_window(address, prompts, new, swap=None) -> dict:
    """Serve ``prompts`` over the wire: WIRE_CLIENTS threads, each with
    its own ServingClient, take the next request as theirs completes.
    Every request's stream frames must concatenate to its final blob (the
    client raises otherwise; the frames are also collected here). When
    request ``WIRE_SWAP_AT`` is submitted, ``swap()`` runs on the calling
    thread while the clients go on. Tokens/s, TTFT (send to first frame)
    p50 and max."""
    import threading

    from distkeras_tpu_torch.serving import ServingClient

    lock = threading.Lock()
    state = {"next": 0}
    at_swap = threading.Event()
    ttft, results, errors = {}, {}, []

    def client_loop():
        cli = ServingClient(address, token=WIRE_TOKEN, timeout=600)
        try:
            while True:
                with lock:
                    i = state["next"]
                    if i >= len(prompts):
                        return
                    state["next"] = i + 1
                if i == WIRE_SWAP_AT:
                    at_swap.set()
                frames = []
                t0 = time.perf_counter()

                def on_token(tok, frames=frames, i=i, t0=t0):
                    if not frames:
                        ttft[i] = time.perf_counter() - t0
                    frames.append(tok)

                res = cli.generate(prompts[i], max_new_tokens=new,
                                   on_token=on_token)
                assert frames == res.tokens.tolist(), (i, frames, res)
                results[i] = res
        except Exception as e:  # surfaced by the caller
            errors.append(e)
            at_swap.set()
        finally:
            cli.close()

    threads = [threading.Thread(target=client_loop, daemon=True)
               for _ in range(WIRE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    swap_info = None
    if swap is not None:
        assert at_swap.wait(600), "the swap's request never came"
        swap_info = swap()
    for t in threads:
        t.join(timeout=900)
        assert not t.is_alive(), "a wire client hung"
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert len(results) == len(prompts)
    assert all(r.reason == "length" and r.tokens.size == new
               for r in results.values())
    tokens = sum(r.tokens.size for r in results.values())
    lat = sorted(ttft.values())
    return {"requests": len(prompts), "new_tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_p50_s": statistics.median(lat), "ttft_max_s": lat[-1],
            "swap": swap_info}


def _wire_identity(dev, power_line) -> dict:
    """(c) In float32 (TF32 off) at WIRE_IDENTITY_LAYERS layers, over the
    wire to a server fronting the engine: admit WIRE_PINNED requests and
    wait until each streamed a token; ``put_weights`` v1; admit
    WIRE_AFTER more and wait likewise; then ``put_weights`` v2 while v0 is
    still pinned: it must wait (v0 still live once the swap is pending)
    and return, within its timeout, only after every v0 request retired.
    Until v2 is pending, each v0 token's stream callback sleeps
    WIRE_HOLD_S on the scheduler thread, so that v0 is still decoding
    however long the transfers take. The first requests' tokens must
    equal those of an engine built on v0 alone, the later ones those of
    an engine built on v1. No capture anywhere."""
    import threading

    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params
    from distkeras_tpu_torch.serving import (GenerationEngine, ServingClient,
                                             ServingEngine, ServingServer)
    from distkeras_tpu_torch.utils import bridge

    set_tf32(False)

    def lm(state=None):
        m = CausalLM(num_layers=WIRE_IDENTITY_LAYERS, dtype=torch.float32,
                     **WIRE_LM)
        init_params(m, torch.Generator().manual_seed(3))
        if state is not None:
            m.load_state_dict(state)
        return m

    kw = dict(page_size=PAGE, num_slots=SLOTS, prefill_buckets=(32,))
    v0 = {k: v.clone() for k, v in lm().state_dict().items()}
    v1, v2 = _perturbed(v0, 31, 0.5), _perturbed(v0, 32, 0.5)
    rng = np.random.default_rng(33)
    prompts = [rng.integers(1, 50304, int(n)).tolist()
               for n in rng.integers(8, 33, WIRE_PINNED + WIRE_AFTER)]
    first, later = prompts[:WIRE_PINNED], prompts[WIRE_PINNED:]
    news = (WIRE_PINNED_NEW, WIRE_IDENTITY_NEW)
    refs = {}
    for name, state, ps, new in (("v0", v0, first, news[0]),
                                 ("v1", v1, later, news[1])):
        with GenerationEngine(lm(state), device=dev, **kw) as ref:
            refs[name] = [f.result(timeout=600).tokens.tolist() for f in
                          [ref.generate(p, max_new_tokens=new) for p in ps]]
    gen = GenerationEngine(lm(v0), device=dev, **kw)
    one = ServingEngine(_flash_lm(torch.float32, 3, WIRE_IDENTITY_LAYERS),
                        (WIRE_ROW,), input_dtype=np.int32, buckets=(1,),
                        device=dev)
    srv = ServingServer(one, host="127.0.0.1", token=WIRE_TOKEN,
                        generator=gen)
    srv.start()
    address = f"127.0.0.1:{srv.port}"
    cli = ServingClient(address, token=WIRE_TOKEN, timeout=600)
    compiles = (telemetry.counter("serving.compiles").value,
                telemetry.counter("serving.decode.compiles").value)
    hold = threading.Event()
    hold.set()
    put_errors = []
    try:
        def admit(ps, new, slow):
            started = [threading.Event() for _ in ps]

            def stream(tok, e):
                e.set()
                if slow and hold.is_set():
                    time.sleep(WIRE_HOLD_S)

            futs = [gen.generate(p, max_new_tokens=new,
                                 stream=lambda t, e=e: stream(t, e))
                    for p, e in zip(ps, started)]
            assert all(e.wait(600) for e in started), "not admitted"
            return futs

        pinned = admit(first, news[0], True)
        cli.put_weights(bridge.state_dict_to_flax(v1), 1, target="generation")
        live_after_v1 = sorted(gen._versions)
        after = admit(later, news[1], False)

        def put_v2():
            c2 = ServingClient(address, token=WIRE_TOKEN, timeout=600)
            try:
                c2.put_weights(bridge.state_dict_to_flax(v2), 2,
                               target="generation")
            except Exception as e:  # surfaced below
                put_errors.append(e)
            finally:
                c2.close()

        t0 = time.perf_counter()
        putter = threading.Thread(target=put_v2, daemon=True)
        putter.start()
        deadline = time.monotonic() + 120
        while gen._pending_swap is None and putter.is_alive():
            assert time.monotonic() < deadline, "v2 never reached the engine"
            time.sleep(0.005)
        v0_live_while_pending = 0 in gen._versions and not all(
            f.done() for f in pinned)
        hold.clear()
        putter.join(timeout=120)
        third_s = time.perf_counter() - t0
        assert not putter.is_alive(), "the v2 put did not return"
        if put_errors:
            raise put_errors[0]
        assert all(f.done() for f in pinned), "v2 installed while v0 pinned"
        got_first = [f.result(timeout=600).tokens.tolist() for f in pinned]
        got_later = [f.result(timeout=600).tokens.tolist() for f in after]
        version = cli.version()
    finally:
        hold.clear()
        cli.close()
        srv.stop()
        one.shutdown()
        gen.shutdown()
    assert v0_live_while_pending, "v0 retired before v2 was pending"
    assert got_first == refs["v0"], (got_first, refs["v0"])
    assert got_later == refs["v1"], (got_later, refs["v1"])
    assert live_after_v1 == [0, 1], live_after_v1
    assert version["decode_model_version"] == 2
    assert (telemetry.counter("serving.compiles").value,
            telemetry.counter("serving.decode.compiles").value) == compiles
    info = {"layers": WIRE_IDENTITY_LAYERS, "pinned": len(first),
            "after": len(later), "tokens_checked": sum(
                map(len, got_first + got_later)),
            "live_after_v1": live_after_v1, "third_put_s": third_s,
            "decode_live_versions": version["decode_live_versions"]}
    log(f"[wire] float32 ({WIRE_IDENTITY_LAYERS} layers): {len(first)} "
        f"requests in flight on v0 and {len(later)} admitted after the swap "
        f"to v1 give the tokens of engines built on v0 and on v1 "
        f"({info['tokens_checked']} tokens); live versions {live_after_v1} "
        f"after the swap; the put of v2 waited while v0 was pinned and "
        f"returned after {third_s:.3f} s, once v0 retired [{power_line}]")
    return info


def _one_shot_plain(one, rows, live) -> dict:
    """The one-shot engine's served rows (``live``, flash forward in its
    bucket graph) against the plain forward of the same weights: a copy
    of its bank with ``attention="full"``, run eagerly. bf16 within
    phase 7's bound for bf16 outputs of any scale, 2e-2 * max|ref|."""
    import copy

    from distkeras_tpu_torch.models.gpt import CausalSelfAttention

    plain = copy.deepcopy(one._bank).eval()
    for m in plain.modules():
        if isinstance(m, CausalSelfAttention):
            m.attention = "full"
    with torch.no_grad():
        want = plain(torch.from_numpy(rows).to(one.device)).float().cpu()
    del plain
    err = float(np.abs(live - want.numpy()).max())
    scale = float(want.abs().max())
    assert err <= 2e-2 * scale, ("one-shot vs plain", err, scale)
    log(f"[wire] the one-shot engine's {len(rows)} x {WIRE_ROW} rows agree "
        f"with the plain forward (attention='full', eager) of the same bf16 bank: "
        f"max |err| {err:.4e} <= 2e-2 x max |ref| {scale:.4f}")
    return {"max_abs_err": err, "max_abs_ref": scale,
            "bound": 2e-2 * scale}


def phase_wire(dev, power_line, engine_info) -> dict:
    """Phase 22: rollout and server (module docstring)."""
    import threading

    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import (CanaryConfig, GenerationEngine,
                                             RolloutController,
                                             ServingClient, ServingEngine,
                                             ServingServer)
    from distkeras_tpu_torch.utils import bridge

    set_tf32(False)
    telemetry.reset()
    t_setup = time.perf_counter()
    gen = GenerationEngine(_gpt_small_bf16(), device=dev, page_size=PAGE,
                           **ENGINE_KW)
    one = ServingEngine(_flash_lm(torch.bfloat16), (WIRE_ROW,),
                        input_dtype=np.int32, buckets=(1, 4),
                        max_wait_ms=50.0, device=dev)
    ctl = RolloutController(engine=one, generator=gen, canary=CanaryConfig(
        fraction=1.0, min_rows=4, threshold=0.0))
    srv = ServingServer(one, host="127.0.0.1", token=WIRE_TOKEN,
                        generator=gen, rollout=ctl)
    srv.start()
    address = f"127.0.0.1:{srv.port}"
    setup_s = time.perf_counter() - t_setup
    compiles = telemetry.counter("serving.compiles")
    dcompiles = telemetry.counter("serving.decode.compiles")
    assert compiles.value == 2 and dcompiles.value == 6, (
        compiles.value, dcompiles.value)
    v0 = {k: v.detach().float().cpu() for k, v in gen._params.items()}
    v1, v2 = _perturbed(v0, 41), _perturbed(v0, 42)
    rng = np.random.default_rng(43)
    rows = rng.integers(1, 50304, (4, WIRE_ROW)).astype(np.int32)
    info = {"setup_s": setup_s, "card": power_line}
    control = ServingClient(address, token=WIRE_TOKEN, timeout=600)
    try:
        # (a) + (b): phase 4's window over the wire, the swap at request 64
        def swap():
            t0 = time.perf_counter()
            put = control.put_weights(bridge.state_dict_to_flax(v1), 1,
                                      target="both")
            put_s = time.perf_counter() - t0
            assert put["ok"] and put["staged"], put
            score = ctl.evaluate_canary(rows)
            assert ctl.current_version == 1, ctl.status()
            return {"put_s": put_s, "total_s": time.perf_counter() - t0,
                    "agreement": score,
                    "live_versions": sorted(gen._versions)}

        fa.paged_flash_attention.launches = 0
        fa.flash_attention_fwd.launches = 0
        calls0 = sum(telemetry.counter(k).value for k in DECODE_CALLS)
        batches0 = telemetry.counter("serving.batches").value
        info["window"] = _wire_window(address, _serving_prompts(),
                                      SERVE_NEW, swap=swap)
        calls = sum(telemetry.counter(k).value
                    for k in DECODE_CALLS) - calls0
        paged = fa.paged_flash_attention.launches
        assert paged == gen.model.num_layers * calls > 0, (paged, calls)
        assert compiles.value == 2 and dcompiles.value == 6, "captured late"
        swap_h = telemetry.histogram("rollout.swap_s", engine="generation")
        info["window"].update(
            model_calls=calls, paged_launches=paged,
            swap_s={"generation": swap_h.stats(),
                    "serving": telemetry.histogram(
                        "rollout.swap_s", engine="serving").stats()},
            flash_fwd_shadow_launches=fa.flash_attention_fwd.launches,
            shadow_batches=telemetry.counter("serving.batches").value
            - batches0)
        w = info["window"]
        log(f"[wire] {w['requests']} requests x {SERVE_NEW} new tokens over "
            f"the wire, {WIRE_CLIENTS} clients: {w['tokens_per_s']:.1f} "
            f"tokens/s, TTFT p50 {w['ttft_p50_s'] * 1e3:.1f} ms (max "
            f"{w['ttft_max_s'] * 1e3:.1f} ms) in {w['wall_s']:.3f} s; phase "
            f"4 in process (this run): {engine_info['tokens_per_s']:.1f} "
            f"tokens/s, TTFT p50 {engine_info['ttft_p50_s'] * 1e3:.1f} ms "
            f"(max {engine_info['ttft_max_s'] * 1e3:.1f} ms); stream frames "
            f"== final blob for every request; paged launches {paged} = "
            f"{gen.model.num_layers} x {calls} model calls [{power_line}]")
        s = w["swap"]
        log(f"[wire] swap to v1 at request {WIRE_SWAP_AT}: put_weights "
            f"{s['put_s']:.3f} s (staged), canary agreement "
            f"{s['agreement']:.3f} then promote, {s['total_s']:.3f} s in "
            f"all; rollout.swap_s generation "
            f"{w['swap_s']['generation'].get('p50', 0):.4f} s, serving "
            f"{w['swap_s']['serving'].get('p50', 0):.4f} s; live versions "
            f"{s['live_versions']}; serving.compiles 2 and "
            f"serving.decode.compiles 6 unmoved [{power_line}]")

        # (d) the one-shot path: infer over the wire against shadow_forward
        fa.flash_attention_fwd.launches = 0
        batches0 = telemetry.counter("serving.batches").value
        live = control.infer(rows)
        batches = telemetry.counter("serving.batches").value - batches0
        flash = fa.flash_attention_fwd.launches
        assert flash == one.model.num_layers * batches > 0, (flash, batches)
        assert live.shape == (4, WIRE_ROW, 50304) and np.isfinite(live).all()
        info["plain"] = _one_shot_plain(one, rows, live)
        shadow = one.shadow_forward(one.params, rows)
        assert np.array_equal(live, shadow), "infer != shadow_forward"
        assert ctl.stage(2, v2), ctl.status()
        score = ctl.evaluate_canary(rows)
        assert ctl.current_version == 2 and one.model_version == 2
        promoted = control.infer(rows)
        assert not np.array_equal(promoted, live)
        assert ctl.rollback() and one.model_version == 1
        restored = control.infer(rows)
        assert np.array_equal(restored, live), "rollback not bit-identical"
        assert compiles.value == 2 and dcompiles.value == 6
        # where a swap's time goes: the float32 masters to the card, then
        # their cast into the bank (timed on the installed masters, so
        # the live weights keep their bits)
        t0 = time.perf_counter()
        staged = one._stage(v2)
        stage_s = time.perf_counter() - t0
        del staged
        staged = one._stage(one.params)
        bank_bytes = sum(t.numel() * t.element_size()
                         for t in one._bank.state_dict().values())
        with one._run_lock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one._load(staged)
            load_s = time.perf_counter() - t0
        staged_bytes = sum(t.numel() * 4 for t in staged.values())
        del staged
        info["bank"] = {"bank_bytes": bank_bytes,
                        "staged_bytes": staged_bytes, "stage_s": stage_s,
                        "load_s": load_s}
        log(f"[wire] a swap's parts on the one-shot engine: "
            f"{staged_bytes / 2**20:.1f} MiB of float32 masters to the "
            f"card in {stage_s * 1e3:.2f} ms, cast into a "
            f"{bank_bytes / 2**20:.1f} MiB bank in {load_s * 1e3:.3f} ms "
            f"[{power_line}]")
        info["one_shot"] = {"rows": len(rows), "batches": batches,
                            "flash_fwd_launches": flash,
                            "canary_agreement": score,
                            "max_abs_promoted_vs_live": float(
                                np.abs(promoted - live).max())}
        log(f"[wire] infer of {len(rows)} x {WIRE_ROW} tokens over the wire "
            f"== shadow_forward bitwise; flash forward launches {flash} = "
            f"{one.model.num_layers} x {batches} batches; stage(v2) -> canary {score:.3f} -> "
            f"promote (max |v2 - v1| {info['one_shot']['max_abs_promoted_vs_live']:.3e}) "
            f"-> rollback: infer bit-identical to before the promotion "
            f"[{power_line}]")
    finally:
        control.close()
        srv.stop()
        one.shutdown()
        gen.shutdown()
    del gen, one, ctl
    torch.cuda.empty_cache()
    info["identity"] = _wire_identity(dev, power_line)
    torch.cuda.empty_cache()
    return info



# -- phase 23 ----------------------------------------------------------------

#: phase 23's replicas: phase 4's engine (page 16, 8 slots, buckets
#: (32, 128), the decode ladder) with 256 MiB of host memory for its
#: prefix cache, ~54 prompts of 128 tokens at ~36.9 KB a token in bf16
FLEET_PREFIX_BYTES = 256 << 20
FLEET_TOKEN = "chip-smoke-fleet"
#: (a) prompts sent one at a time through a prefill and a decode replica
#: (one more goes through a torn handoff), new tokens each
FLEET_DISAGG = 8
FLEET_DISAGG_NEW = 32
#: (b) float32: a warm pass over FLEET_KILL_PROMPTS prompts, then a storm
#: of FLEET_STORM requests (each prompt in turn), FLEET_CLIENTS in flight
FLEET_KILL_PROMPTS = 12
FLEET_STORM = 48
FLEET_KILL_NEW = 32
FLEET_CLIENTS = 8
#: (d) the first half of phase 4's window through the router
FLEET_RATE_REQUESTS = 64
#: (c) prompts served after the weight push, new tokens each
FLEET_PUSH_PROMPTS = 4


def _fleet_prompts(n, seed):
    """``n`` seeded prompts of 16-128 tokens in gpt_small's vocabulary."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 50304, int(k)).tolist()
            for k in rng.integers(16, 129, size=n)]


class _Fleet:
    """Replicas of one model on ``dev`` behind the port's FleetRouter,
    in this process: each a GenerationEngine (phase 4's shapes, a prefix
    cache, every graph captured in its constructor) behind its own
    generation-only ServingServer on 127.0.0.1:0. Each replica's setup
    seconds, graph pool and device memory (allocated before and after its
    construction) are kept."""

    def __init__(self, dev, make_model, roles, **router_kw):
        from distkeras_tpu_torch.serving import (FleetRouter,
                                                 GenerationEngine,
                                                 ServingServer)

        self.router = FleetRouter(token=FLEET_TOKEN, **router_kw)
        self.replicas = []
        try:
            for role in roles:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                gen = GenerationEngine(
                    make_model(), device=dev, page_size=PAGE,
                    prefix_cache_bytes=FLEET_PREFIX_BYTES, **ENGINE_KW)
                setup_s = time.perf_counter() - t0
                assert gen.device == dev, gen.device
                srv = ServingServer(None, host="127.0.0.1",
                                    token=FLEET_TOKEN, generator=gen,
                                    router=self.router)
                torch.cuda.synchronize()
                rep = {"gen": gen, "srv": srv, "role": role,
                       "setup_s": setup_s,
                       "graph_pool_bytes": gen.graph_pool_bytes,
                       "allocated_bytes": torch.cuda.memory_allocated()
                       - before}
                self.replicas.append(rep)
                srv.start()
                rep["rid"] = self.router.add_replica(
                    f"127.0.0.1:{srv.port}", role=role)
        except BaseException:
            self.close()
            raise

    def address(self, i) -> str:
        return f"127.0.0.1:{self.replicas[i]['srv'].port}"

    def memory(self) -> list:
        return [{k: rep[k] for k in ("role", "setup_s", "graph_pool_bytes",
                                     "allocated_bytes")}
                for rep in self.replicas]

    def close(self):
        self.router.close()
        for rep in self.replicas:
            rep["srv"].stop()
            rep["gen"].shutdown(drain=False, timeout=30)


def _fleet_reference(dev, make_model, prompts, new, state=None) -> list:
    """Each prompt's tokens from one engine of the replicas' shapes on
    ``make_model()`` (with ``state`` loaded), served one at a time."""
    from distkeras_tpu_torch.serving import GenerationEngine

    model = make_model()
    if state is not None:
        model.load_state_dict(state)
    with GenerationEngine(model, device=dev, page_size=PAGE,
                          **ENGINE_KW) as ref:
        return [ref.generate(p, max_new_tokens=new).result(
            timeout=600).tokens.tolist() for p in prompts]


def _fleet_disagg(dev, power_line) -> dict:
    """(a) bf16, roles (prefill, decode), one request at a time."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.serving import ServingClient
    from distkeras_tpu_torch.utils import fault

    prompts = _fleet_prompts(FLEET_DISAGG + 1, 61)
    want = _fleet_reference(dev, _gpt_small_bf16, prompts, FLEET_DISAGG_NEW)
    fleet = _Fleet(dev, _gpt_small_bf16, ("prefill", "decode"))
    router = fleet.router
    try:
        src = router._replicas[fleet.replicas[0]["rid"]].client
        export, shipped, handoff_s = src.kv_export, [], []

        def counted_export(tokens):
            header, blobs = export(tokens)
            shipped.append(sum(len(b) for b in blobs))
            return header, blobs

        disagg = router._maybe_disaggregate

        def timed_disagg(*args):
            t0 = time.perf_counter()
            disagg(*args)
            handoff_s.append(time.perf_counter() - t0)

        src.kv_export = counted_export
        router._maybe_disaggregate = timed_disagg
        imports = telemetry.counter("serving.decode.prefix.imports")
        got, wall = [], []
        for p in prompts[:FLEET_DISAGG]:
            t0 = time.perf_counter()
            got.append(router.generate(
                p, max_new_tokens=FLEET_DISAGG_NEW).tokens.tolist())
            wall.append(time.perf_counter() - t0)
        d = router.status_digest()
        hits = fleet.replicas[1]["gen"].health_status()["prefix_cache"][
            "hits"]
        assert got == want[:FLEET_DISAGG], "disaggregated tokens differ"
        assert d["handoffs"] == FLEET_DISAGG, d
        assert d["handoff_failures"] == 0 and hits == FLEET_DISAGG, (d, hits)
        n_imports = imports.value
        fault.inject_chaos("fleet.kv_handoff", "torn")
        try:
            torn = router.generate(prompts[-1],
                                   max_new_tokens=FLEET_DISAGG_NEW)
        finally:
            fault.clear_chaos()
        d = router.status_digest()
        assert torn.tokens.tolist() == want[-1], "torn handoff tokens differ"
        assert d["handoffs"] == FLEET_DISAGG, d
        assert d["handoff_failures"] == 1 and imports.value == n_imports, d
        cli = ServingClient(fleet.address(1), token=FLEET_TOKEN, timeout=600)
        try:
            status = cli.status()
        finally:
            cli.close()
        assert status["fleet"]["handoffs"] == FLEET_DISAGG, status["fleet"]
        assert set(status["fleet"]["replicas"]) == {"0", "1"}
        memory = fleet.memory()
    finally:
        fleet.close()
    info = {"requests": FLEET_DISAGG, "new_tokens": FLEET_DISAGG_NEW,
            "prompt_tokens": [len(p) for p in prompts[:FLEET_DISAGG]],
            "handoff_bytes": shipped[:FLEET_DISAGG],
            "handoff_s": handoff_s[:FLEET_DISAGG], "request_s": wall,
            "decode_prefix_hits": hits, "memory": memory,
            "card": power_line}
    n_tok = sum(info["prompt_tokens"])
    log(f"[fleet] (a) bf16 prefill -> decode, {FLEET_DISAGG} requests of "
        f"16-128 prompt tokens x {FLEET_DISAGG_NEW} new, one at a time: "
        f"tokens == one engine's local prefill and decode; handoffs "
        f"{FLEET_DISAGG}, the decode replica's prefix hits {hits}; a torn "
        f"handoff: the same tokens, handoff_failures 1, no new import; the "
        f"status op carries the digest. A handoff (generate of 1 token on "
        f"the prefill replica, kv_export, kv_handoff): median "
        f"{statistics.median(info['handoff_s']) * 1e3:.1f} ms, "
        f"{sum(shipped[:FLEET_DISAGG]) / n_tok / 1e3:.1f} KB a prompt "
        f"token ({statistics.median(shipped[:FLEET_DISAGG]) / 2**20:.2f} "
        f"MiB median); a request end to end median "
        f"{statistics.median(wall) * 1e3:.1f} ms [{power_line}]")
    for rep in memory:
        log(f"[fleet] (a) {rep['role']} replica: setup {rep['setup_s']:.2f} "
            f"s, graph pool {rep['graph_pool_bytes'] / 2**20:.1f} MiB, "
            f"{rep['allocated_bytes'] / 2**20:.1f} MiB allocated")
    return info


def _fleet_kill(dev, power_line) -> dict:
    """(b) float32 with TF32 off: three ``both`` replicas, a warm pass, a
    storm with the replica holding the most cache entries killed while
    its first stream is held after its first token; then (c) a weight
    push to the survivors."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from distkeras_tpu_torch.models.gpt import gpt_small, init_params

    set_tf32(False)

    def make():
        return init_params(gpt_small(dtype=torch.float32),
                           torch.Generator().manual_seed(7))

    prompts = _fleet_prompts(FLEET_KILL_PROMPTS, 71)
    want = _fleet_reference(dev, make, prompts, FLEET_KILL_NEW)
    fleet = _Fleet(dev, make, ("both", "both", "both"))
    router = fleet.router
    info = {"card": power_line}
    try:
        for p, w in zip(prompts, want):
            assert router.generate(p, max_new_tokens=FLEET_KILL_NEW
                                   ).tokens.tolist() == w, "warm pass"
        entries = [rep["gen"].health_status()["prefix_cache"]["entries"]
                   for rep in fleet.replicas]
        victim = int(np.argmax(entries))
        gen = fleet.replicas[victim]["gen"]
        streaming, resume = threading.Event(), threading.Event()
        generate = gen.generate

        def held(prompt, stream=None, **kw):
            def on_token(tok):
                if not streaming.is_set():
                    streaming.set()  # the victim's first stream
                    assert resume.wait(600)
                stream(tok)
            return generate(prompt, stream=on_token, **kw)

        gen.generate = held
        evict, evicted_at = router._evict, []

        def timed_evict(rep, reason):
            evicted_at.append(time.perf_counter())
            evict(rep, reason)

        router._evict = timed_evict
        sent = [prompts[i % len(prompts)] for i in range(FLEET_STORM)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=FLEET_CLIENTS) as pool:
            futs = [pool.submit(router.generate, p,
                                max_new_tokens=FLEET_KILL_NEW) for p in sent]
            assert streaming.wait(600), "no stream reached the victim"
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            t_kill = time.perf_counter()
            fleet.replicas[victim]["srv"].stop()
            killer = threading.Thread(target=gen.shutdown, kwargs=dict(
                drain=False, timeout=10))
            killer.start()
            deadline = time.monotonic() + 60
            while not gen._closed:
                assert time.monotonic() < deadline, "the kill did not land"
                time.sleep(0.001)
            resume.set()
            killer.join(timeout=60)
            assert not killer.is_alive(), "the victim's scheduler hung"
            kill_s = time.perf_counter() - t_kill
            torch.cuda.synchronize()
            mem_after = torch.cuda.memory_allocated()
            results = [f.result(timeout=900) for f in futs]
        storm_s = time.perf_counter() - t0
        t_done = time.perf_counter()
        got = [r.tokens.tolist() for r in results]
        wrong = [i for i, (g, p) in enumerate(zip(got, sent))
                 if g != want[prompts.index(p)]]
        if wrong:
            i = wrong[0]
            w = want[prompts.index(sent[i])]
            at = next(k for k, (a, b) in enumerate(zip(got[i], w)) if a != b)
            model = make().to(dev).eval()
            with torch.no_grad():
                logits = model(torch.tensor([sent[i] + w[:at]],
                                            device=dev))[0, -1]
            top2 = torch.topk(logits, 2)
            log(f"[fleet] (b) request {i} differs at token {at}: got "
                f"{got[i][at]}, one replica alone {w[at]}; full-forward "
                f"top-2 {top2.indices.tolist()} margin "
                f"{float(top2.values[0] - top2.values[1]):.3e}")
            raise AssertionError(f"{len(wrong)} requests differ: {wrong}")
        d = router.status_digest()
        assert d["evictions"] >= 1 and d["requeued"] >= 1, d
        assert str(fleet.replicas[victim]["rid"]) not in d["replicas"], d
        assert gen.released and gen.pool.pool is None
        assert all(run._graph is None and not run._static
                   for run in gen._runners())
        assert all(bank.model is None for bank in gen._banks)
        torch.cuda.empty_cache()
        info["kill"] = {
            "victim": victim, "entries": entries,
            "requests": FLEET_STORM, "failed": 0, "lost": 0,
            "evictions": d["evictions"], "requeued": d["requeued"],
            "kill_s": kill_s,
            "kill_to_evict_s": evicted_at[0] - t_kill if evicted_at else None,
            "kill_to_done_s": t_done - t_kill, "storm_s": storm_s,
            "allocated_before_kill": mem_before,
            "allocated_after_kill": mem_after,
            "reserved_after_empty_cache": torch.cuda.memory_reserved(),
            "memory": fleet.memory()}
        k = info["kill"]
        log(f"[fleet] (b) float32: {FLEET_STORM} requests x "
            f"{FLEET_KILL_NEW} new tokens, {FLEET_CLIENTS} in flight over 3 "
            f"replicas; replica {victim} (cache entries {entries}) killed "
            f"with a stream in flight: 0 failed, 0 lost, every request's "
            f"tokens == one replica alone; evictions {d['evictions']}, "
            f"requeued {d['requeued']}; the kill took {kill_s * 1e3:.1f} ms, "
            f"the router evicted "
            f"{(k['kill_to_evict_s'] or 0) * 1e3:.1f} ms after it, the storm "
            f"ended {k['kill_to_done_s']:.3f} s after it ({storm_s:.3f} s in "
            f"all); allocated {mem_before / 2**20:.1f} MiB before the kill, "
            f"{mem_after / 2**20:.1f} MiB after (the victim's graphs, banks "
            f"and pool freed) [{power_line}]")

        # (c) a push of new weights to every live replica
        survivor = next(rep["gen"] for i, rep in enumerate(fleet.replicas)
                        if i != victim)
        v1 = _perturbed(survivor._params, 81)
        t0 = time.perf_counter()
        out = router.push_weights(v1, version=1, target="generation")
        push_s = time.perf_counter() - t0
        assert len(out) == 2 and all(r.get("ok") for r in out.values()), out
        d = router.status_digest()
        assert d["version_skew"] == 0, d
        assert [r["model_version"] for r in d["replicas"].values()] == [1, 1]
        after = _fleet_prompts(FLEET_PUSH_PROMPTS, 91)
        got = [router.generate(p, max_new_tokens=FLEET_KILL_NEW
                               ).tokens.tolist() for p in after]
    finally:
        fleet.close()
    assert got == _fleet_reference(dev, make, after, FLEET_KILL_NEW,
                                   state=v1), "tokens after the push"
    info["push"] = {"replies": {str(k): v for k, v in out.items()},
                    "push_s": push_s, "version_skew": 0,
                    "prompts_checked": len(after)}
    log(f"[fleet] (c) push_weights v1 to the 2 live replicas in "
        f"{push_s:.3f} s: every reply ok, version_skew 0, model_version 1 "
        f"on each; {len(after)} prompts after it == an engine loaded with "
        f"v1 [{power_line}]")
    return info


def _fleet_window(router, prompts, new) -> dict:
    """Phase 4's closed loop through ``router``: FLEET_CLIENTS threads
    take the next request as theirs completes. Tokens/s, TTFT (call to
    first token) p50 and p99, and the longest gap between two tokens
    arriving at any client."""
    import threading

    lock = threading.Lock()
    state = {"next": 0}
    ttft, results, errors, arrivals = {}, {}, [], []

    def client_loop():
        try:
            while True:
                with lock:
                    i = state["next"]
                    if i >= len(prompts):
                        return
                    state["next"] = i + 1
                t0 = time.perf_counter()

                def on_token(tok, i=i, t0=t0):
                    now = time.perf_counter()
                    arrivals.append(now)
                    ttft.setdefault(i, now - t0)

                results[i] = router.generate(prompts[i], max_new_tokens=new,
                                             on_token=on_token)
        except Exception as e:  # surfaced by the caller
            errors.append(e)

    threads = [threading.Thread(target=client_loop, daemon=True)
               for _ in range(FLEET_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        assert not t.is_alive(), "a fleet client hung"
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert len(results) == len(prompts)
    assert all(r.reason == "length" and r.tokens.size == new
               for r in results.values())
    tokens = sum(r.tokens.size for r in results.values())
    lat = sorted(ttft.values())
    gaps = np.diff([t0] + sorted(arrivals))
    return {"requests": len(prompts), "new_tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_p50_s": statistics.median(lat),
            "ttft_p99_s": float(np.percentile(lat, 99)),
            "max_gap_ms": float(gaps.max()) * 1e3}


def _fleet_rates(dev, power_line, wire_info, engine_info) -> dict:
    """(d) bf16: half of phase 4's window (FLEET_RATE_REQUESTS requests)
    through the router over two ``both``
    replicas with affinity routing, a MetricStore and the default SLO
    specs installed; the paged launches counted per replay."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.health import slo, timeseries
    from distkeras_tpu_torch.health.endpoints import HealthClient
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import ServingClient

    fleet = _Fleet(dev, _gpt_small_bf16, ("both", "both"))
    router = fleet.router
    store = timeseries.install_store(timeseries.MetricStore(interval_s=0.5))
    judge = slo.install_engine(slo.SloEngine(slo.default_specs()))
    try:
        store.start()
        judge.start(interval=0.5)
        calls = lambda: sum(  # noqa: E731
            telemetry.counter(k).value for k in DECODE_CALLS)
        fa.paged_flash_attention.launches = 0
        calls0 = calls()
        window = _fleet_window(
            router, _serving_prompts()[:FLEET_RATE_REQUESTS], SERVE_NEW)
        launches = fa.paged_flash_attention.launches
        n_calls = calls() - calls0
        layers = fleet.replicas[0]["gen"].model.num_layers
        assert launches == layers * n_calls > 0, (launches, n_calls)
        store.stop()
        judge.stop()
        store.collect()
        judge.evaluate_once()
        with HealthClient(fleet.address(0), token=FLEET_TOKEN) as hc:
            names = sorted({r["name"] for r in hc.series(max_points=4)})
        decode = [n for n in names if n.startswith("serving.decode.")]
        assert decode, names
        cli = ServingClient(fleet.address(1), token=FLEET_TOKEN, timeout=600)
        try:
            status = cli.status()
        finally:
            cli.close()
        assert isinstance(status.get("alerts"), list), sorted(status)
        d = router.status_digest()
        memory = fleet.memory()
    finally:
        store.stop()
        judge.stop()
        timeseries.install_store(None)
        slo.install_engine(None)
        fleet.close()
    window.update(paged_launches=launches, model_calls=n_calls,
                  affinity=d["affinity"], requests_routed=d["requests"],
                  series_decode=decode, alerts=status["alerts"],
                  memory=memory, card=power_line)
    w = window
    log(f"[fleet] (d) bf16: {w['requests']} requests x {SERVE_NEW} new "
        f"tokens through the router over 2 replicas, {FLEET_CLIENTS} "
        f"clients: {w['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{w['ttft_p50_s'] * 1e3:.1f} ms, p99 {w['ttft_p99_s'] * 1e3:.1f} "
        f"ms, longest gap {w['max_gap_ms']:.1f} ms, affinity hit rate "
        f"{d['affinity']['hit_rate']:.3f}; paged launches {launches} = "
        f"{layers} x {n_calls} model calls; phase 22 over the wire (this "
        f"run): {wire_info['window']['tokens_per_s']:.1f} tokens/s, phase 4 "
        f"in process: {engine_info['tokens_per_s']:.1f}; series op: "
        f"{len(decode)} serving.decode.* series; status alerts "
        f"{[a['slo'] for a in status['alerts']]} [{power_line}]")
    return window


def phase_fleet(dev, power_line, wire_info, engine_info) -> dict:
    """Phase 23: the serving fleet (module docstring)."""
    from distkeras_tpu_torch import telemetry

    telemetry.reset()
    info = {"disagg": _fleet_disagg(dev, power_line)}
    torch.cuda.empty_cache()
    info.update(_fleet_kill(dev, power_line))
    torch.cuda.empty_cache()
    info["rates"] = _fleet_rates(dev, power_line, wire_info, engine_info)
    torch.cuda.empty_cache()
    return info


# -- phase 24 -----------------------------------------------------------------

CORE_B, CORE_WINDOW, CORE_ROUNDS = 128, 16, 3
CORE_K_B, CORE_K_WINDOW, CORE_K = 32, 4, 4
CORE_GN_B, CORE_GN_WINDOW, CORE_GN_K = 32, 2, 2
MNIST_N, MNIST_K = 8192, 4


def _images(rows, seed):
    """Seeded uint8 NHWC 224^2 images and one-hot labels over 1000
    classes, as a port ``Dataset`` (made in bulk: one draw of bytes)."""
    from distkeras_tpu_torch.data.dataset import Dataset

    rng = np.random.default_rng(seed)
    x = np.frombuffer(rng.bytes(rows * 224 * 224 * 3), np.uint8).reshape(
        rows, 224, 224, 3)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, rows)]
    return Dataset.from_arrays(features=x, label=y)


def _nf_model(seed):
    from distkeras_tpu_torch.models.resnet import init_params, resnet50_nf

    return init_params(resnet50_nf(), torch.Generator().manual_seed(seed))


class _RoundClock:
    """Wraps a trainer's epoch function and its strategy's local step:
    the wall time of each epoch call (one round a call under
    ``staging_rounds=1``, synchronized) and each local step's device
    time between CUDA events (read after the run)."""

    def __init__(self, trainer):
        from distkeras_tpu_torch.parallel import substrate

        self.calls, self.steps = [], []
        orig_build, orig_step = substrate.build_epoch_fn, \
            trainer.strategy.local_step

        def build(*args, **kwargs):
            fn = orig_build(*args, **kwargs)

            def timed(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                self.calls.append(time.perf_counter() - t0)
                return out

            return timed

        def step(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig_step(*args, **kwargs)
            end.record()
            self.steps.append((start, end))
            return out

        self._restore = (substrate, orig_build)
        substrate.build_epoch_fn = build
        trainer.strategy.local_step = step

    def close(self):
        substrate, orig_build = self._restore
        substrate.build_epoch_fn = orig_build

    def step_ms(self):
        return [a.elapsed_time(b) for a, b in self.steps]


def _core_bench(dev, power_line, nf_info) -> dict:
    """(a) bench.py's configuration through the public trainer: ADAG over
    resnet50_nf() at full width, sgd(0.05), batch 128, window 16, one
    worker, 3 rounds of seeded uint8 224^2 images streamed with
    ``staging_rounds=1`` (pinned buffers, side-stream copies, prefetch)."""
    from distkeras_tpu_torch import ADAG

    ds = _images(CORE_ROUNDS * CORE_WINDOW * CORE_B, seed=11)
    trainer = ADAG(_nf_model(seed=10), worker_optimizer="sgd",
                   learning_rate=0.05, num_workers=1, batch_size=CORE_B,
                   communication_window=CORE_WINDOW, metrics=(),
                   staging_rounds=1)
    start = {n: p.detach().to(dev, copy=True)
             for n, p in trainer.model.named_parameters()}
    clock = _RoundClock(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        params = trainer.train(ds)
    finally:
        clock.close()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in trainer.get_history()]
    rounds = clock.calls
    steps = clock.step_ms()
    steady = rounds[1:]
    per_step = nf_info["step_s"][-1]
    info = {"round_s": rounds, "wall_s": wall,
            "samples_per_s": CORE_WINDOW * CORE_B * len(steady) / sum(steady),
            "median_step_ms": statistics.median(steps),
            "step_ms": steps, "peak_bytes": peak, "losses": losses,
            "round_over_phase15": statistics.median(steady)
            / (CORE_WINDOW * per_step),
            "phase15_step_s": per_step,
            "center_moved": max((params[n].float() - start[n].float())
                                .abs().max().item() for n in start),
            "card": power_line, "card_after": smi_sample()}
    log(f"[train-core] (a) ADAG(resnet50_nf(), sgd 0.05, batch {CORE_B}, "
        f"window {CORE_WINDOW}, 1 worker) over {CORE_ROUNDS} rounds of "
        f"uint8 224^2 streamed one round a chunk: rounds "
        f"{', '.join(f'{x:.3f}' for x in rounds)} s, "
        f"{info['samples_per_s']:.1f} samples/s over rounds 2-3, median "
        f"local step {info['median_step_ms']:.1f} ms (device events), a "
        f"round {info['round_over_phase15']:.2f}x 16 x phase 15's step "
        f"({per_step * 1e3:.1f} ms), peak {peak / 2**30:.2f} GiB, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, center moved "
        f"{info['center_moved']:.3e} [{power_line}; after: "
        f"{info['card_after']}]")
    assert len(losses) == CORE_ROUNDS * CORE_WINDOW
    assert all(math.isfinite(x) for x in losses), losses
    assert info["center_moved"] > 0, info
    del trainer, params, start, ds
    torch.cuda.empty_cache()
    return info


def _core_fold(dev, power_line) -> dict:
    """(b) K = 4 replicas of resnet50_nf() on one card: one ADAG round,
    batch 32, window 4; the new center against the start plus the sum of
    each worker's (w - c) / window taken in float64."""
    from distkeras_tpu_torch import ADAG

    ds = _images(CORE_K * CORE_K_WINDOW * CORE_K_B, seed=12)
    trainer = ADAG(_nf_model(seed=13), worker_optimizer="sgd",
                   learning_rate=0.05, num_workers=1,
                   parallelism_factor=CORE_K, batch_size=CORE_K_B,
                   communication_window=CORE_K_WINDOW, metrics=())
    # the float64 reference, accumulated as the commits come: start +
    # sum_k (w_k - c) / window (one float64 copy of the model on the card)
    ref, heads, orig_commit = {}, [], trainer.strategy.commit

    def commit(carry, center, window):
        with torch.no_grad():
            for n, w in carry.params.items():
                c = center[n].double()
                ref.setdefault(n, c.clone()).add_((w.double() - c) / window)
        heads.append(carry.params["head.weight"].detach().clone())
        return orig_commit(carry, center, window)

    trainer.strategy.commit = commit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = trainer.train(ds)
    peak = torch.cuda.max_memory_allocated(dev)
    assert len(heads) == CORE_K, len(heads)
    worst = max((params[n].double() - r).abs().max().item()
                / max(r.abs().max().item(), 1e-30) for n, r in ref.items())
    apart = min((heads[i] - heads[j]).abs().max().item()
                for i in range(CORE_K) for j in range(i + 1, CORE_K))
    n_params = sum(p.numel() for p in params.values())
    losses = [h["loss"] for h in trainer.get_history()]
    info = {"max_rel_err": worst, "min_replica_gap": apart,
            "peak_bytes": peak, "params": n_params, "losses": losses,
            "card": power_line}
    log(f"[train-core] (b) ADAG K={CORE_K} replicas of resnet50_nf() on "
        f"one card (batch {CORE_K_B}, window {CORE_K_WINDOW}, one round): "
        f"new center vs float64 start + sum (w_k - c) / window: max "
        f"relative error {worst:.2e} (bound 1e-6); replicas apart before "
        f"the pull (min max|w_i - w_j| of the head {apart:.3e}); peak "
        f"{peak / 2**30:.2f} GiB for {CORE_K} x {n_params / 1e6:.1f} M "
        f"float32 params ({CORE_K * n_params * 4 / 2**30:.2f} GiB; the "
        f"peak includes the check's float64 copy, "
        f"{n_params * 8 / 2**30:.2f} GiB) [{power_line}]")
    assert worst <= 1e-6, info
    assert apart > 0, info
    assert all(math.isfinite(x) for x in losses), losses
    del trainer, params, ref, heads, ds
    torch.cuda.empty_cache()
    return info


def _mnist_data():
    from distkeras_tpu_torch import (MinMaxTransformer, OneHotTransformer,
                                     Pipeline, synthetic_mnist)

    return Pipeline([
        MinMaxTransformer(o_min=-1.0, o_max=1.0),
        OneHotTransformer(10, input_col="label_index", output_col="label"),
    ]).transform(synthetic_mnist(n=MNIST_N))


#: (label, trainer, kwargs over the example's): the example's own kwargs
#: for every trainer (EAMSGD refuses worker_optimizer, in both
#: packages), then the four exchanging trainers that do not converge at
#: K = 4 with them, at a window of 1 (DOWNPOUR, DynSGD) or rho 0.5
#: (AEASGD, EAMSGD)
MNIST_RUNS = (
    ("single", "SingleTrainer", {}), ("averaging", "AveragingTrainer", {}),
    ("ensemble", "EnsembleTrainer", {}), ("downpour", "DOWNPOUR", {}),
    ("adag", "ADAG", {}), ("dynsgd", "DynSGD", {}), ("aeasgd", "AEASGD", {}),
    ("eamsgd", "EAMSGD", {"worker_optimizer": None}),
    ("downpour_w1", "DOWNPOUR", {"communication_window": 1}),
    ("dynsgd_w1", "DynSGD", {"communication_window": 1}),
    ("aeasgd_rho0.5", "AEASGD", {"rho": 0.5}),
    ("eamsgd_rho0.5", "EAMSGD", {"rho": 0.5, "worker_optimizer": None}),
)
#: runs whose accuracy must exceed 0.5
MNIST_CONVERGE = ("single", "averaging", "ensemble", "adag", "downpour_w1",
                  "dynsgd_w1", "aeasgd_rho0.5", "eamsgd_rho0.5")


def _mnist_run(name, over, device, num_epoch, data, start):
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import mnist_mlp

    kw = dict(worker_optimizer="momentum", learning_rate=0.3, batch_size=64,
              num_epoch=num_epoch, device=device)
    if name != "SingleTrainer":
        kw.update(num_workers=1, parallelism_factor=MNIST_K,
                  communication_window=4)
    kw.update(over)
    if kw["worker_optimizer"] is None:
        del kw["worker_optimizer"]
    model = mnist_mlp()
    model.load_state_dict(start)
    trainer = getattr(dk, name)(model, **kw)
    t0 = time.perf_counter()
    params = trainer.train(data, shuffle=True)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if name == "EnsembleTrainer":
        params = params[0]
    scored = dk.ModelClassifier(model, params, batch_size=512,
                                device=device).predict(data)
    acc = dk.AccuracyEvaluator("prediction", "label_index").evaluate(scored)
    return acc, wall, [h["loss"] for h in trainer.get_history()]


def _core_mnist(dev, power_line) -> dict:
    """(c) the twin of examples/mnist_mlp.py on the card: every trainer
    of the zoo, K = 4 replicas, then ModelClassifier + AccuracyEvaluator;
    ADAG's and EAMSGD's (rho 0.5) first-epoch losses against the same run
    on the host's CPU (TF32 off)."""
    from distkeras_tpu_torch.models import mnist_mlp
    from distkeras_tpu_torch.models.mlp import init_params

    set_tf32(False)
    data = _mnist_data()
    start = init_params(mnist_mlp(),
                        torch.Generator().manual_seed(16)).state_dict()
    runs = {}
    for label, name, over in MNIST_RUNS:
        acc, wall, losses = _mnist_run(name, over, dev, 3, data, start)
        runs[label] = {"accuracy": acc, "wall_s": wall,
                       "last_loss": losses[-1]}
    witness = {}
    for label, name, over in (("adag", "ADAG", {}),
                              ("eamsgd_rho0.5", "EAMSGD",
                               {"rho": 0.5, "worker_optimizer": None})):
        _, _, card = _mnist_run(name, over, dev, 1, data, start)
        _, _, host = _mnist_run(name, over, "cpu", 1, data, start)
        witness[label] = {"steps": len(card), "max_rel": max(
            abs(a - b) / abs(b) for a, b in zip(card, host))}
        assert len(card) == len(host) > 0, witness
    info = {"runs": runs, "witness": witness, "card": power_line}
    log(f"[train-core] (c) the mnist_mlp example's flow, {MNIST_N} rows, "
        f"K={MNIST_K}, 3 epochs (accuracy, wall s): "
        + "; ".join(f"{k} {v['accuracy']:.4f} {v['wall_s']:.2f}"
                    for k, v in runs.items())
        + "; first-epoch losses card vs host CPU, max relative difference: "
        + ", ".join(f"{k} {v['max_rel']:.2e} over {v['steps']} steps"
                    for k, v in witness.items()) + " (bound 1e-3)")
    assert all(w["max_rel"] <= 1e-3 for w in witness.values()), witness
    for label in MNIST_CONVERGE:
        assert runs[label]["accuracy"] > 0.5, (label, runs[label])
    return info


def _core_groupnorm(dev, power_line) -> dict:
    """(d) the GroupNorm kernels under a trainer: ADAG over resnet50()
    (GroupNorm) in bf16, K = 2 replicas, batch 32, window 2, one round;
    53 forward and 53 backward launches a local step."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    ds = _images(CORE_GN_K * CORE_GN_WINDOW * CORE_GN_B, seed=14)
    trainer = ADAG(_resnet_model("gn", torch.bfloat16, seed=15),
                   worker_optimizer="sgd", learning_rate=0.05,
                   num_workers=1, parallelism_factor=CORE_GN_K,
                   batch_size=CORE_GN_B, communication_window=CORE_GN_WINDOW,
                   metrics=())
    kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
    for kernel in kernels:
        kernel.launches = 0
    trainer.train(ds)
    launches = {k.__name__: k.launches for k in kernels}
    losses = [h["loss"] for h in trainer.get_history()]
    want = 53 * CORE_GN_K * CORE_GN_WINDOW
    info = {"launches": launches, "expected": want, "losses": losses,
            "card": power_line}
    log(f"[train-core] (d) ADAG(resnet50() GroupNorm, bf16, K="
        f"{CORE_GN_K}, batch {CORE_GN_B}, window {CORE_GN_WINDOW}): "
        f"GroupNorm launches {launches} (53 x K x window = {want}), losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}")
    assert all(n == want for n in launches.values()), info
    assert all(math.isfinite(x) for x in losses), losses
    del trainer, ds
    torch.cuda.empty_cache()
    return info


def phase_train_core(dev, power_line, nf_info) -> dict:
    """Phase 24: the training core on the card (module docstring)."""
    info = {"bench": _core_bench(dev, power_line, nf_info),
            "fold": _core_fold(dev, power_line),
            "mnist": _core_mnist(dev, power_line),
            "groupnorm": _core_groupnorm(dev, power_line)}
    return info


# -- phase 25 -----------------------------------------------------------------

#: calibration shapes (chained [n, n] bf16 products by an identity)
CAL_SIZES = (16384, 8192, 4096)
#: count-parity shapes: gpt_small widths at 2 layers, batch x seq; the
#: GroupNorm resnet50() batch at 224^2
PARITY_LAYERS, PARITY_B, PARITY_T, PARITY_GN_B = 2, 2, 128, 2
#: steps a traced capture covers
MEASURE_STEPS = 2
#: local steps of the traced training-core round (phase 24 (a) takes
#: CORE_WINDOW): the profiler's processing of a round grows with it
MEASURE_CORE_WINDOW = 4
#: rounds of bench_torch's configuration in phase 25 (1 warm-up, 2 timed)
MEASURE_BENCH_ROUNDS = 2


def _calibration_sweep(power_line) -> list:
    """``observability.calibrate_peak`` at each CAL_SIZES shape; the
    default shape's ratio must land in ``CAL_BAND``."""
    from distkeras_tpu_torch import observability

    rows = []
    for size in CAL_SIZES:
        cal = observability.calibrate_peak(size=size)
        rows.append({"size": size, **cal})
        log(f"[measure] calibration {size}^2 bf16 x 64 chained: "
            f"{cal['achieved'] / 1e12:.2f} TFLOP/s = {cal['ratio']:.4f} of "
            f"{cal['peak'] / 1e12:.0f} [{power_line}]")
    band = observability.CAL_BAND
    assert band[0] <= rows[0]["ratio"] <= band[1], (rows[0], band)
    return rows


def _grad_step(model, loss, batch):
    """One forward and backward of ``model`` on ``batch`` (a closure)."""
    from distkeras_tpu_torch import engine

    grad_fn = engine.make_grad_fn(model, loss, precision=model.precision)
    return lambda: grad_fn(batch)


def _count_pair(dev, tag, make, make_inputs) -> dict:
    """``count_flops`` of one call on the card (the kernels report their
    formulas) and on the host's CPU (their plain versions run as aten
    ops): the two must be equal."""
    from distkeras_tpu_torch import observability
    from distkeras_tpu_torch.ops.kernels import accounting

    out = {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        fn = make(where, make_inputs(where))
        kernels = {}
        with accounting.listen(lambda c: kernels.__setitem__(
                c.name, kernels.get(c.name, 0) + 1)):
            out[str(where.type)] = observability.count_flops(fn)
        out[f"{where.type}_kernel_calls"] = kernels
        out[f"{where.type}_s"] = time.perf_counter() - t0
    log(f"[measure] count parity {tag}: card {out['cuda']:.6g} FLOPs "
        f"(kernels {out['cuda_kernel_calls']}), CPU {out['cpu']:.6g} "
        f"(plain versions); {out['cuda_s']:.1f} s on the card, "
        f"{out['cpu_s']:.1f} s on the CPU")
    assert out["cuda"] == out["cpu"] > 0, out
    assert out["cuda_kernel_calls"] and not out["cpu_kernel_calls"], out
    return out


def _count_parity(dev) -> dict:
    """Each kernel path's FLOPs at a short size, card against CPU."""
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    set_tf32(False)

    def lm(precision):
        def make(where, batch):
            model = init_params(CausalLM(
                vocab_size=50304, max_len=2048, num_layers=PARITY_LAYERS,
                num_heads=12, width=768, mlp_dim=3072, dtype=torch.bfloat16,
                attention="flash", precision=precision),
                torch.Generator().manual_seed(0)).to(where)
            return _grad_step(model, "masked_lm", batch)
        return make

    lm_batch = lambda where: {k: torch.from_numpy(v).to(where) for k, v in
                              _lm_batch(PARITY_B, PARITY_T, 1).items()}

    def gn(where, batch):
        # float32: the count is the shapes', and the host's CPU runs a
        # float32 ResNet-50 faster than a bf16 one
        model = _resnet_model("gn", torch.float32, 0).to(where)
        return _grad_step(model, "categorical_crossentropy", batch)

    gn_batch = lambda where: {k: torch.from_numpy(v).to(where) for k, v in
                              _image_batch(PARITY_GN_B, 1).items()}
    paged_in = lambda where: [x.to(where) for x in _paged_inputs(
        8, 2, torch.bfloat16, np.random.default_rng(0), "cpu")]
    out = {"flash": _count_pair(dev, "gpt_small x2 flash (rows 1-3)",
                                lm(None), lm_batch),
           "int8": _count_pair(dev, "gpt_small x2 int8 (row 5)",
                               lm("int8"), lm_batch),
           "groupnorm": _count_pair(dev, "resnet50() b=2 (rows 6-7)", gn,
                                    gn_batch),
           "paged": _count_pair(dev, "paged decode b=8 t=2 (row 4)",
                                lambda where, x: lambda:
                                fa.paged_flash_attention(*x), paged_in)}
    assert set(out["flash"]["cuda_kernel_calls"]) == {
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"}, out["flash"]
    assert "int8_matmul_dequant" in out["int8"]["cuda_kernel_calls"], out
    assert set(out["groupnorm"]["cuda_kernel_calls"]) == {
        "group_norm_fwd", "group_norm_bwd"}, out["groupnorm"]
    torch.cuda.empty_cache()
    return out


def _measure_path(dev, tag, step_fn, expect, dtype="bf16",
                  steps=MEASURE_STEPS, warm=True) -> dict:
    """``capture_op_times`` over MEASURE_STEPS calls of ``step_fn`` (warmed
    up), the op inventory and its source view of one more call, and
    ``build_report``: busy share, top five rows, coverage. The capture
    must name each wrapper of ``expect``."""
    from distkeras_tpu_torch.profiling import (build_report, capture_op_times,
                                               op_inventory,
                                               source_inventory)

    t0 = time.perf_counter()
    if warm:
        step_fn()
    table = capture_op_times(step_fn, steps=steps)
    t_capture = time.perf_counter() - t0
    assert table.available, table.note
    kernels = table.kernels()
    info = {"busy_share": table.busy_share, "wall_s": table.wall_s,
            "device_s": table.total(),
            "kernels_ms": {k: v * 1e3 for k, v in kernels.items()},
            "top_kernels": [{"name": k[:90], "device_ms": sec * 1e3,
                             "count": n} for k, sec, n in table.top(5)]}
    if expect is not None:
        inventory = op_inventory(step_fn)
        # with no kernel launched the source view is the inventory itself
        source = source_inventory(step_fn) if any(
            r.opcode == "kernel" for r in inventory.rows) else inventory
        report = build_report(inventory, dtype=dtype, device=dev,
                              measured=table.measured(),
                              modeled_flops=source.total_flops)
        assert report.available, report.note
        info.update(coverage=report.coverage,
                    inventory_s=time.perf_counter() - t0 - t_capture,
                    inventory_flops=inventory.total_flops,
                    source_flops=source.total_flops,
                    kernel_rows=sum(r.opcode == "kernel"
                                    for r in inventory.rows),
                    measured_share=report.measured_share,
                    report=[r.to_row() for r in report.top()[:5]])
    log(f"[measure] {tag}: {steps} traced calls, device busy "
        f"{100 * table.busy_share:.1f}% of {table.wall_s * 1e3:.1f} ms a "
        f"call; hand-written kernels (device ms a call) "
        f"{ {k: round(v, 4) for k, v in info['kernels_ms'].items()} }"
        + (f"; coverage {info['coverage']:.6f} ({info['kernel_rows']} "
           f"kernel rows, {info['inventory_flops']:.6g} of "
           f"{info['source_flops']:.6g} FLOPs), measured share "
           f"{info['measured_share']:.3f}" if "coverage" in info else "")
        + f"; capture {t_capture:.1f} s"
        + (f", inventories {info['inventory_s']:.1f} s"
           if "inventory_s" in info else ""))
    for k in info["top_kernels"]:
        log(f"[measure]   {k['device_ms']:9.3f} ms  x{k['count']:<7.1f} "
            f"{k['name']}")
    for r in info.get("report", ()):
        log(f"[measure]   roofline {r['op'][:48]:<48} {r['bound']:>8} "
            f"share {r['share']:.4f} {r['flops'] / 1e9:9.2f} GFLOP "
            f"{r['bytes'] / 1e6:9.2f} MB {'*' if r['measured'] else ' '}"
            f"{r['fix']}")
    for name in expect or ():
        assert name in kernels, (tag, name, sorted(table.seconds))
    return info


def _measure_paths(dev, serving_profile) -> dict:
    """Phase 8's GPT step, phase 12's int8 step and phase 14's GroupNorm
    step (MEASURE_STEPS steps each) and a round of phase 24 (a)'s
    configuration at MEASURE_CORE_WINDOW steps,
    each captured and reported; the graphed serving window is phase 6's
    capture (``serving_profile``)."""
    import bench_torch
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers

    out = {}
    t0 = time.perf_counter()
    mark = lambda what: log(f"[measure] {what} at "
                            f"{time.perf_counter() - t0:.1f} s")
    set_tf32(False)
    model = _train_model(12, "flash", torch.bfloat16, seed=0)
    tx = optimizers.get("adamw", 1e-3)
    box = [engine.create_train_state(model, tx, device=dev)]
    step = engine.make_train_step(model, "masked_lm", tx)
    batch = engine.to_device(_lm_batch(TRAIN_B, TRAIN_T, seed=1), dev)

    def train_step():
        box[0], metrics = step(box[0], batch)
        return metrics

    mark("gpt step built")
    out["gpt"] = _measure_path(dev, "gpt bf16 step (phase 8)", train_step,
                               ("flash_attention_fwd",
                                "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkv"))
    del model, box, step
    torch.cuda.empty_cache()
    _, state, step, batch, _ = _int8_train_run(dev, "int8", 1)
    box = [state]

    def int8_step():
        box[0], metrics = step(box[0], batch)
        return metrics

    mark("int8 step built")
    out["int8"] = _measure_path(dev, "gpt int8 step (phase 12)", int8_step,
                                ("int8_matmul_dequant",
                                 "flash_attention_fwd"))
    del state, box, step
    torch.cuda.empty_cache()
    _, state, step, batch, _ = _resnet_run(dev, "gn", 1)
    box = [state]

    def gn_step():
        box[0], metrics = step(box[0], batch)
        return metrics

    mark("groupnorm step built")
    out["groupnorm"] = _measure_path(dev, "resnet50() GroupNorm step "
                                     "(phase 14)", gn_step,
                                     ("group_norm_fwd", "group_norm_bwd"))
    del state, box, step
    torch.cuda.empty_cache()
    # the graphed serving window: phase 6's capture of phase 4's engine
    # (a second trace of a 128-request window costs ~65 s of the
    # profiler's own processing)
    out["serving"] = {
        "busy_share": serving_profile["device_busy_share"],
        "wall_s": serving_profile["wall_s"],
        "kernels_ms": serving_profile["wrapper_ms"],
        "top_kernels": serving_profile["top_kernels"][:5]}
    serving = out["serving"]
    log(f"[measure] graphed serving window (phase 6's capture of phase 4's "
        f"engine): device busy {100 * serving['busy_share']:.1f}%; "
        f"hand-written kernels (device ms) "
        f"{ {k: round(v, 4) for k, v in serving['kernels_ms'].items()} }")
    assert "paged_flash_attention" in serving["kernels_ms"], serving
    b = bench_torch.build(batch_size=CORE_B, image_side=224,
                          window=MEASURE_CORE_WINDOW, rounds=1,
                          num_classes=1000,
                          tiny=False, device=dev)
    cell = {"center": b["center"], "carries": b["carries"], "round": 0}

    def core_round():
        cell["center"], cell["carries"], metrics = b["epoch_fn"](
            cell["center"], cell["carries"], b["data"], cell["round"])
        cell["round"] += 1
        return metrics

    mark("round built")
    out["core"] = _measure_path(dev, f"ADAG(resnet50_nf()) round (phase 24 "
                                f"(a) at window {MEASURE_CORE_WINDOW})",
                                core_round, (), steps=1)
    del b, cell
    torch.cuda.empty_cache()
    return out


def phase_measure(dev, power_line, serving_profile) -> dict:
    """Phase 25, the measurement plane: the calibration sweep, count
    parity card against CPU on each kernel path, captures and roofline
    reports of the kernel paths and the training core, and
    ``bench_torch.run`` at MEASURE_BENCH_ROUNDS rounds with its MFU."""
    import bench_torch
    from distkeras_tpu_torch import observability

    t0 = time.perf_counter()
    info = {"calibration": _calibration_sweep(power_line)}
    log(f"[measure] calibration done at {time.perf_counter() - t0:.1f} s")
    info["counts"] = _count_parity(dev)
    log(f"[measure] count parity done at {time.perf_counter() - t0:.1f} s")
    info["paths"] = _measure_paths(dev, serving_profile)
    log(f"[measure] captures done at {time.perf_counter() - t0:.1f} s")
    bench = bench_torch.run(**dict(bench_torch.CONFIGS[0],
                                   rounds=MEASURE_BENCH_ROUNDS),
                            device=dev, warmup=1, timed=2)
    info["bench"] = bench
    log(f"[measure] bench_torch.run at {MEASURE_BENCH_ROUNDS} rounds: "
        f"{bench['samples_per_sec']:.1f} samples/s, MFU {bench['mfu']:.4f} "
        f"of the bf16 peak ({bench['flops_per_call']:.6g} FLOPs a call; "
        f"calls {', '.join(f'{t:.3f}' for t in bench['call_s'])} s; "
        f"calibration {info['calibration'][0]['ratio']:.4f} in "
        f"{observability.CAL_BAND}) [{power_line}]")
    assert bench["mfu"] is not None and 0 < bench["mfu"] < 1, bench
    torch.cuda.empty_cache()
    info["seconds"] = time.perf_counter() - t0
    log(f"[measure] phase 25 took {info['seconds']:.1f} s")
    return info


# -- phase 26 -----------------------------------------------------------------

CKPT_B, CKPT_WINDOW, CKPT_K = 32, 2, 2


def phase_checkpoint(dev, power_line) -> dict:
    """Phase 26: ``ADAG(resnet50_nf())`` with K = 2 replicas on the card
    (momentum, so each carry holds optimizer state), 2 epochs of one round
    each: the run that saves epoch 0 and the run resumed from it end on
    the uninterrupted run's parameters, bit for bit (cuDNN deterministic,
    TF32 off)."""
    import tempfile

    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.checkpoint import Checkpointer

    t0 = time.perf_counter()
    set_tf32(False)
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ds = _images(CKPT_K * CKPT_WINDOW * CKPT_B, seed=21)
    os.makedirs(OUT_DIR, exist_ok=True)

    def trainer(epochs, directory):
        return ADAG(_nf_model(seed=20), worker_optimizer="momentum",
                    learning_rate=0.05, parallelism_factor=CKPT_K,
                    batch_size=CKPT_B, communication_window=CKPT_WINDOW,
                    num_epoch=epochs, metrics=(), checkpoint_dir=directory)

    try:
        full = trainer(2, None).train(ds)
        with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
            t0 = time.perf_counter()
            trainer(1, d).train(ds)
            save_s = time.perf_counter() - t0
            ckpt = Checkpointer(d, items=("state", "carries"))
            steps, items = ckpt.all_steps(), ckpt.step_items()
            size = sum(os.path.getsize(os.path.join(d, "0", n))
                       for n in os.listdir(os.path.join(d, "0")))
            resumed_t = trainer(2, d)
            resumed = resumed_t.train(ds, resume=True)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    diff = max((full[n].float() - resumed[n].float()).abs().max().item()
               for n in full)
    equal = all(torch.equal(full[n], resumed[n]) for n in full)
    info = {"steps": steps, "items": items, "step_bytes": size,
            "first_run_s": save_s, "resumed_history": len(
                resumed_t.get_history()), "bitwise": equal,
            "max_abs_diff": diff, "card": power_line,
            "seconds": time.perf_counter() - t0}
    log(f"[checkpoint] ADAG(resnet50_nf()) K={CKPT_K}, batch {CKPT_B}, "
        f"window {CKPT_WINDOW}, momentum: epoch 0 saved as steps {steps} "
        f"(items {items}, {size / 2**20:.1f} MiB), the first run "
        f"{save_s:.2f} s; resumed at epoch 1 ({info['resumed_history']} "
        f"steps): bitwise {equal}, max |diff| {diff:.3e} against the "
        f"uninterrupted run; phase 26 took {info['seconds']:.1f} s "
        f"[{power_line}]")
    assert steps == [0] and items == ["carries", "state"], info
    assert equal, info
    del full, resumed, resumed_t, ds
    torch.cuda.empty_cache()
    return info


# -- phase 27 -----------------------------------------------------------------

#: (a) bench.py's configuration under mode="host_async"
ASYNC_B, ASYNC_WINDOW, ASYNC_WINDOWS = 128, 16, 3
ASYNC_KS = (1, 2)
#: (b) the fold witness; (d) the int8 wire; (e) GroupNorm; (f) the
#: fleet; (g) snapshots: (workers, batch, window, windows a worker)
WITNESS = (4, 32, 4, 2)
WIRE = (2, 128, 8, 2)
ASYNC_GN = (2, 32, 2, 1)
FLEET = (2, 32, 4, 12)
SNAP = (2, 32, 2, 2)
#: (f)'s coordinator lease (s) and the op the chaos kill lands on
FLEET_LEASE_S, FLEET_KILL_AFTER = 1.0, 6
#: (c) the MNIST MLP, card against the CPU
ASYNC_MNIST_N, ASYNC_MNIST_B = 2048, 64
#: (h) the staleness twin's grid
TWIN = dict(strategies=["adag", "dynsgd"], windows=[1, 4], workers=[2],
            n_train=4096, n_heldout=1024, batch_size=32, epochs=2)


def _learnable_images(rows, seed, side=224):
    """Seeded uint8 NHWC images whose brightness encodes one of ten
    classes (the first ten of 1000 one-hot labels), so that a few windows
    of SGD lower the loss."""
    from distkeras_tpu_torch.data.dataset import Dataset

    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 10, rows)
    noise = np.frombuffer(rng.bytes(rows * side * side * 3), np.uint8)
    x = (noise.reshape(rows, side, side, 3) // 4
         + (cls * 19).astype(np.uint8)[:, None, None, None])
    y = np.zeros((rows, 1000), np.float32)
    y[np.arange(rows), cls] = 1.0
    return Dataset.from_arrays(features=x, label=y)


class _WindowClock:
    """Records ``perf_counter`` at every window's heartbeat (one a
    committed window, after its fold) while installed."""

    def __init__(self):
        from distkeras_tpu_torch.health import heartbeat

        self.marks = []
        self._cls = heartbeat.HeartbeatPublisher
        self._orig = self._cls.publish
        marks = self.marks

        def publish(pub, worker, clock, staleness, window_s):
            marks.append((time.perf_counter(), int(worker)))
            return self._orig(pub, worker, clock, staleness, window_s)

        self._cls.publish = publish

    def close(self):
        self._cls.publish = self._orig

    def steady_rate(self, samples_a_window) -> float:
        """Samples/s over the windows each worker committed after its
        first: from the last first-window mark to the last mark."""
        firsts = {}
        for t, w in self.marks:
            firsts.setdefault(w, t)
        t0 = max(firsts.values())
        later = [t for t, _ in self.marks if t > t0]
        return samples_a_window * len(later) / (max(later) - t0)


def _hist_p50(name, workers) -> list:
    from distkeras_tpu_torch import telemetry

    return [telemetry.histogram(name, worker=w).stats()["p50"]
            for w in range(workers)]


def _async_trainer(cls_name, model, k, b, window, dev, **kw):
    import distkeras_tpu_torch as dk

    return getattr(dk, cls_name)(
        model, mode="host_async", num_workers=k, worker_optimizer="sgd",
        learning_rate=0.05, batch_size=b, communication_window=window,
        metrics=(), device=dev, **kw)


def _async_bench(dev, power_line, core_info) -> dict:
    """(a) ``ADAG(resnet50_nf())`` in ``mode="host_async"`` at bench.py's
    configuration, K = 1 and 2 threads, three windows a worker."""
    from distkeras_tpu_torch import telemetry

    out = {}
    for k in ASYNC_KS:
        ds = _learnable_images(k * ASYNC_WINDOWS * ASYNC_WINDOW * ASYNC_B,
                               seed=30 + k)
        trainer = _async_trainer("ADAG", _nf_model(seed=10), k, ASYNC_B,
                                 ASYNC_WINDOW, dev)
        telemetry.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        clock = _WindowClock()
        t0 = time.perf_counter()
        try:
            trainer.train(ds)
        finally:
            clock.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [h["loss"] for h in trainer.get_history()]
        stal = np.asarray(trainer.staleness_history, np.float64)
        info = {
            "workers": k, "wall_s": wall,
            "samples_per_s": clock.steady_rate(ASYNC_WINDOW * ASYNC_B),
            "commits": trainer.num_updates,
            "windows_scheduled": k * ASYNC_WINDOWS,
            "staleness": {"mean": float(stal.mean()),
                          "p95": float(np.percentile(stal, 95)),
                          "max": float(stal.max())},
            "window_s_p50": _hist_p50("host_async.window_s", k),
            "pull_s_p50": _hist_p50("host_async.pull_s", k),
            "commit_s_p50": _hist_p50("host_async.commit_s", k),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "first_loss": losses[0],
            "last_window_loss": float(np.mean(losses[-ASYNC_WINDOW:])),
            "card": power_line}
        log(f"[async] (a) ADAG(resnet50_nf()) host_async K={k} (sgd 0.05, "
            f"batch {ASYNC_B}, window {ASYNC_WINDOW}, {ASYNC_WINDOWS} windows "
            f"a worker): {info['samples_per_s']:.1f} samples/s over the "
            f"steady windows (phase 24 (a), sync K=1: "
            f"{core_info['samples_per_s']:.1f}); staleness mean "
            f"{info['staleness']['mean']:.2f} p95 "
            f"{info['staleness']['p95']:.2f} max "
            f"{info['staleness']['max']:.0f}; median window "
            f"{statistics.median(info['window_s_p50']):.3f} s, pull "
            f"{statistics.median(info['pull_s_p50']) * 1e3:.2f} ms, commit "
            f"{statistics.median(info['commit_s_p50']) * 1e3:.2f} ms; "
            f"commits {info['commits']} of {info['windows_scheduled']}; peak "
            f"{info['peak_bytes'] / 2**30:.2f} GiB; loss "
            f"{info['first_loss']:.4f} -> {info['last_window_loss']:.4f} "
            f"[{power_line}]")
        assert all(math.isfinite(x) for x in losses), losses
        assert info["last_window_loss"] < info["first_loss"], info
        assert info["commits"] == info["windows_scheduled"], info
        out[f"k{k}"] = info
        del trainer, ds
        torch.cuda.empty_cache()
    return out


def _async_witness(dev, power_line) -> dict:
    """(b) K = 4 DynSGD threads over ``resnet50_nf()``: every fold's
    ``(delta, weight)`` accumulated in float64 on the card as it lands
    (under one lock, so in fold order); the final center against it."""
    import threading

    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import host_async, strategies

    k, b, window, windows = WITNESS
    model = _nf_model(seed=13).to(dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    strategy = strategies.get("dynsgd", learning_rate=0.05)
    ps = host_async.server_for(strategy, {n: x.clone()
                                          for n, x in start.items()})
    ref = {n: x.double() for n, x in start.items()}
    lock, log_, orig = threading.Lock(), [], ps.commit_ex

    def commit_ex(delta, last_update=0, weight=None):
        with lock:
            at_fold, w = orig(delta, last_update=last_update, weight=weight)
            w32 = float(np.float32(w))
            with torch.no_grad():
                for n, r in ref.items():
                    r.add_(delta[n].double(), alpha=w32)
            log_.append((at_fold, w))
        return at_fold, w

    ps.commit_ex = commit_ex
    ds = _learnable_images(k * windows * window * b, seed=33)
    shards = host_async.stage_worker_shards(ds.repartition(k), "features",
                                            "label", b, window)
    runner = host_async.HostAsyncRunner(
        model, "categorical_crossentropy", optimizers.get("sgd", 0.05),
        strategy, window, devices=[dev])
    center, _, stal, clock = runner.run(start, [shards], ps=ps)
    worst = max((center[n].double() - r).abs().max().item()
                / max(r.abs().max().item(), 1e-30) for n, r in ref.items())
    weights = sorted({w for _, w in log_})
    info = {"folds": len(log_), "clock": clock, "max_rel_err": worst,
            "weights": weights, "staleness": stal, "card": power_line}
    log(f"[async] (b) DynSGD K={k} threads over resnet50_nf() (batch {b}, "
        f"window {window}, {windows} windows a worker): {len(log_)} folds "
        f"at weights {', '.join(f'{w:.4f}' for w in weights)}; final center "
        f"vs the float64 replay of the logged (delta, weight): max relative "
        f"error {worst:.2e} (bound 1e-6) [{power_line}]")
    assert [a for a, _ in log_] == list(range(k * windows)), log_
    assert clock == k * windows, info
    assert worst <= 1e-6, info
    del runner, center, ref, start, model, ps
    torch.cuda.empty_cache()
    return info


def _async_card_vs_cpu(dev, power_line) -> dict:
    """(c) a K = 1 host_async MNIST-MLP run on the card and on the host
    from the same seed (TF32 off): the centers within 1e-5."""
    from distkeras_tpu_torch import synthetic_mnist
    from distkeras_tpu_torch.models import mnist_mlp
    from distkeras_tpu_torch.models.mlp import init_params

    set_tf32(False)
    start = init_params(mnist_mlp(),
                        torch.Generator().manual_seed(17)).state_dict()
    ds = synthetic_mnist(n=ASYNC_MNIST_N)
    runs = []
    for where in (dev, torch.device("cpu")):
        model = mnist_mlp()
        model.load_state_dict(start)
        t = _async_trainer("ADAG", model, 1, ASYNC_MNIST_B, 4, where)
        runs.append((t.train(ds), t.num_updates))
    (card, n_card), (cpu, n_cpu) = runs
    diff = max((card[n].cpu() - cpu[n]).abs().max().item() for n in cpu)
    info = {"max_abs_diff": diff, "commits": n_card, "card": power_line}
    log(f"[async] (c) ADAG(mnist_mlp()) host_async K=1, {ASYNC_MNIST_N} "
        f"rows, batch {ASYNC_MNIST_B}, window 4: card vs host CPU centers "
        f"max |diff| {diff:.3e} (bound 1e-5) after {n_card} commits")
    assert n_card == n_cpu > 0 and diff <= 1e-5, info
    return info


def _async_wire(dev, power_line) -> dict:
    """(d) ``codec="int8"`` with ``comms_overlap=True``: ADAG K = 2 over
    ``resnet50_nf()``; the bytes a commit, raw against int8, read from
    the codec's own compression histogram over the run's commits."""
    from distkeras_tpu_torch import telemetry

    k, b, window, windows = WIRE
    ds = _learnable_images(k * windows * window * b, seed=34)
    trainer = _async_trainer("ADAG", _nf_model(seed=10), k, b, window, dev,
                             codec="int8", comms_overlap=True)
    raw = sum(p.numel() * p.element_size()
              for p in trainer.model.parameters())
    telemetry.reset()
    t0 = time.perf_counter()
    trainer.train(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ratio = telemetry.histogram("comms.compress_ratio", op="commit",
                                path="local").stats()
    losses = [h["loss"] for h in trainer.get_history()]
    info = {"commits": trainer.num_updates,
            "windows_scheduled": k * windows, "raw_bytes": raw,
            "int8_bytes": raw / (ratio["sum"] / ratio["count"]),
            "ratio_commits": ratio["count"], "wall_s": wall,
            "staleness": trainer.staleness_history, "card": power_line}
    log(f"[async] (d) ADAG(resnet50_nf()) K={k}, codec int8, comms overlap "
        f"(batch {b}, window {window}, {windows} windows a worker): a commit "
        f"{raw / 2**20:.2f} MiB raw, {info['int8_bytes'] / 2**20:.2f} MiB "
        f"int8 ({info['ratio_commits']} commits encoded); commits "
        f"{info['commits']} of {info['windows_scheduled']}; staleness "
        f"{info['staleness']}; {wall:.2f} s [{power_line}]")
    assert info["commits"] == info["windows_scheduled"], info
    assert info["ratio_commits"] == info["commits"], info
    assert all(math.isfinite(x) for x in losses), losses
    del trainer, ds
    torch.cuda.empty_cache()
    return info


def _async_groupnorm(dev, power_line) -> dict:
    """(e) ``ADAG(resnet50())`` (GroupNorm, bf16) host_async K = 2: the
    GroupNorm kernels launched 53 x K x window x windows times each by
    the workers, plus 53 each by the runner's one-row FLOPs count for the
    per-window MFU series (a forward and backward on the first round a
    worker trains); that count equals the same count made alone, so no
    sibling's launch reached it."""
    from distkeras_tpu_torch import observability
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn
    from distkeras_tpu_torch.utils.transfer import to_device

    k, b, window, windows = ASYNC_GN
    ds = _learnable_images(k * windows * window * b, seed=35)
    trainer = _async_trainer("ADAG", _resnet_model("gn", torch.bfloat16,
                                                   seed=15),
                             k, b, window, dev)
    kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
    for kernel in kernels:
        kernel.launches = 0
    trainer.train(ds)
    launches = {kk.__name__: kk.launches for kk in kernels}
    want = 53 * k * window * windows + 53
    losses = [h["loss"] for h in trainer.get_history()]
    runner = trainer._async_runner
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in trainer.model.named_parameters()}
    row = to_device({"features": np.asarray(ds["features"][:1]),
                     "labels": np.asarray(ds["label"][:1])}, dev)
    alone = observability.count_flops(runner.window_fn.grad_fn, params,
                                      row, None) * b * window
    info = {"launches": launches, "expected": want, "losses": losses,
            "commits": trainer.num_updates,
            "window_flops": runner._window_flops,
            "window_flops_alone": alone, "card": power_line}
    log(f"[async] (e) ADAG(resnet50() GroupNorm, bf16) host_async K={k}, "
        f"batch {b}, window {window}: GroupNorm launches {launches} (53 x K "
        f"x window x windows + 53 for the MFU count = {want}), commits "
        f"{info['commits']}; a window's FLOPs {runner._window_flops:.6g} "
        f"counted in a worker, {alone:.6g} alone")
    assert all(n == want for n in launches.values()), info
    assert runner._window_flops == alone, info
    assert all(math.isfinite(x) for x in losses), losses
    del trainer, ds
    torch.cuda.empty_cache()
    return info


def _async_fleet(dev, power_line) -> dict:
    """(f) DynSGD K = 2 over ``make_ps_fleet(..., 2, standby=True)`` and a
    ``ShardedRemoteParameterServer`` on loopback, the centers'
    shards on the card; the coordinator chaos-killed mid-run (the JAX
    package's ``tests/test_failover.py:314`` scenario): zero lost
    windows, one promotion, the fleet's clock the run's."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.comms import RetryPolicy
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import elastic, failover, host_async
    from distkeras_tpu_torch.parallel import strategies
    from distkeras_tpu_torch.parameter_servers import DynSGDParameterServer
    from distkeras_tpu_torch.utils import fault

    k, b, window, windows = FLEET
    model = _nf_model(seed=13).to(dev)
    like = {n: p.detach().clone() for n, p in model.named_parameters()}
    telemetry.reset()
    services = elastic.make_ps_fleet(
        lambda part: DynSGDParameterServer([x.clone() for x in part]),
        like, 2, host="127.0.0.1", standby=True,
        coord_lease_s=FLEET_LEASE_S)
    marks = {}
    orig_kill = services[0].kill

    def kill(reason="chaos"):
        marks.setdefault("kill", time.perf_counter())
        orig_kill(reason)

    services[0].kill = kill
    standby = services[-1].standby
    orig_promote = standby._promote_locked

    def promote(reason):
        marks.setdefault("promote", time.perf_counter())
        orig_promote(reason)

    standby._promote_locked = promote
    fleet = elastic.ShardedRemoteParameterServer(
        [s.advertised for s in services if not s.is_standby], like,
        standby=services[-1].advertised,
        retry=RetryPolicy(max_retries=2, base_s=0.01, max_s=0.05),
        op_timeout=30.0)
    ds = _learnable_images(k * windows * window * b, seed=36)
    shards = host_async.stage_worker_shards(ds.repartition(k), "features",
                                            "label", b, window)
    runner = host_async.HostAsyncRunner(
        model, "categorical_crossentropy", optimizers.get("sgd", 0.05),
        strategies.get("dynsgd", learning_rate=0.05), window, devices=[dev],
        max_degraded_windows=windows)
    fault.inject_chaos("remote_ps.server.handle", "kill",
                       after=FLEET_KILL_AFTER, count=1, shard=0)

    def counter(name):
        snap = telemetry.get_registry().snapshot()["counters"]
        return sum(v for key, v in snap.items()
                   if key.split("{", 1)[0] == name)

    try:
        t0 = time.perf_counter()
        _, hist, stal, clock = runner.run(like, [shards], ps=fleet)
        wall = time.perf_counter() - t0
        fleet_clock = fleet.num_updates
        info = {"windows": len(runner.merged_windows),
                "windows_scheduled": k * windows, "clock": clock,
                "fleet_clock": fleet_clock,
                "promotions": counter("elastic.failover.promotions"),
                "kills": counter("elastic.failover.kills"),
                "resolves": counter("elastic.failover.resolves"),
                "degraded_windows": counter("host_async.degraded_windows"),
                "kill_to_promotion_s": (marks["promote"] - marks["kill"]
                                        if len(marks) == 2 else None),
                "gaps": standby.gaps, "wall_s": wall,
                "lease_s": FLEET_LEASE_S, "card": power_line}
    finally:
        fault.clear_chaos()
        fleet.close()
        for svc in services:
            if svc.replicator is not None:
                svc.replicator.close(timeout=0.5)
            svc.stop()
    log(f"[async] (f) DynSGD K={k} over a 2-shard fleet + standby on "
        f"loopback (resnet50_nf(), batch {b}, window {window}, {windows} "
        f"windows a worker), coordinator chaos-killed at its op "
        f"{FLEET_KILL_AFTER + 1}: windows {info['windows']} of "
        f"{info['windows_scheduled']}, promotions {info['promotions']}, "
        f"kill -> promotion {info['kill_to_promotion_s']} s (lease "
        f"{FLEET_LEASE_S} s), degraded windows {info['degraded_windows']}, "
        f"replay gaps {info['gaps']}, clock {clock} (fleet {fleet_clock}), "
        f"{wall:.2f} s [{power_line}]")
    assert info["windows"] == info["windows_scheduled"], info
    assert info["promotions"] == 1 and info["kills"] == 1, info
    assert marks["kill"] < marks["promote"], info
    assert fleet_clock == clock, info
    assert all(math.isfinite(h["loss"]) for h in hist), hist
    assert failover.DEFAULT_COORD_LEASE_S > FLEET_LEASE_S
    del runner, model, like
    torch.cuda.empty_cache()
    return info


def _async_snapshots(dev, power_line) -> dict:
    """(g) ``checkpoint_folds=K`` with ``checkpoint_dir``, then
    ``resume=True``: the resumed run starts from the snapshot's center
    (bitwise) and clock, and continues the clock."""
    import tempfile

    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.parallel import host_async

    k, b, window, windows = SNAP
    ds = _learnable_images(k * windows * window * b, seed=37)
    os.makedirs(OUT_DIR, exist_ok=True)
    seen = {}
    orig = host_async.HostAsyncRunner.run

    def spy(runner, init_params, *a, **kw):
        seen["center"] = {n: x.detach().clone()
                          for n, x in init_params.items()}
        seen["start_clock"] = kw.get("start_clock")
        return orig(runner, init_params, *a, **kw)

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        first = _async_trainer("DynSGD", _nf_model(seed=20), k, b, window,
                               dev, checkpoint_dir=d, checkpoint_folds=k)
        first.train(ds)
        ckpt = Checkpointer(d)
        steps = ckpt.all_steps()
        step = ckpt.latest_step()
        snap = ckpt.restore(step=step)
        host_async.HostAsyncRunner.run = spy
        try:
            resumed = _async_trainer("DynSGD", _nf_model(seed=21), k, b,
                                     window, dev, checkpoint_dir=d,
                                     checkpoint_folds=k)
            resumed.train(ds, resume=True)
        finally:
            host_async.HostAsyncRunner.run = orig
        bitwise = all(torch.equal(seen["center"][n].cpu(),
                                  torch.as_tensor(np.array(x)))
                      for n, x in snap["center"].items())
        info = {"steps": steps, "snapshot_clock": int(snap["clock"][0]),
                "first_clock": first.num_updates,
                "resumed_start_clock": seen["start_clock"],
                "resumed_clock": resumed.num_updates,
                "latest_after": ckpt.latest_step(), "bitwise": bitwise,
                "card": power_line}
    log(f"[async] (g) DynSGD(resnet50_nf()) K={k} with checkpoint_folds={k}: "
        f"snapshots at clocks {steps}; resume=True started at clock "
        f"{seen['start_clock']} from the snapshot's center (bitwise "
        f"{bitwise}) and ended at {info['resumed_clock']} (latest snapshot "
        f"{info['latest_after']})")
    assert info["snapshot_clock"] == step == info["first_clock"], info
    assert info["resumed_start_clock"] == step, info
    assert info["resumed_clock"] == step + k * windows, info
    assert bitwise, info
    return info


def _async_twin(dev, power_line) -> dict:
    """(h) the staleness-vs-wall-clock twin at a small grid."""
    from distkeras_tpu_torch.benchmarks import staleness_tradeoff

    result = staleness_tradeoff.sweep(device=dev, **TWIN)
    for p in result["points"]:
        log(f"[async] (h) {p['mode']:10s} {p['strategy']:6s} "
            f"K={p['num_workers']} w={p['window']}: staleness mean "
            f"{p['staleness_mean']} p95 {p['staleness_p95']} max "
            f"{p['staleness_max']}, {p['samples_per_sec']} samples/s, "
            f"held-out loss {p['curve'][0]['heldout_loss']} -> "
            f"{p['final_heldout_loss']}, {p['total_wall_s']} s")
        if p["mode"] == "sync":
            k = p["num_workers"]
            assert p["staleness_mean"] == (k - 1) / 2, p
        assert p["commits"] == p["epochs"] * p["rounds_per_epoch"] * \
            p["num_workers"], p
        assert math.isfinite(p["final_heldout_loss"]), p
    result["card"] = power_line
    return result


def phase_async(dev, power_line, core_info) -> dict:
    """Phase 27: the true-async plane on the card (module docstring)."""
    t0 = time.perf_counter()
    info = {"bench": _async_bench(dev, power_line, core_info),
            "witness": _async_witness(dev, power_line),
            "card_vs_cpu": _async_card_vs_cpu(dev, power_line),
            "wire": _async_wire(dev, power_line),
            "groupnorm": _async_groupnorm(dev, power_line),
            "fleet": _async_fleet(dev, power_line),
            "snapshots": _async_snapshots(dev, power_line),
            "twin": _async_twin(dev, power_line)}
    info["seconds"] = time.perf_counter() - t0
    log(f"[async] phase 27 took {info['seconds']:.1f} s [{power_line}]")
    return info


# -- phase 28 ----------------------------------------------------------------

#: config 4's batch and sequence (BERT-base MLM)
ENC_B, ENC_T = 32, 128
ENC_STEPS = 3
VIT_B = 64
MOE_SHAPE = (16, 256, 768)
MOE_STEPS = 4


def _bert_batch(vocab, seed):
    """Config 4's staging: int16 ids, 15% of positions labelled with
    their own id, the rest -1."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (ENC_B, ENC_T)).astype(np.int16)
    labels = np.where(rng.random((ENC_B, ENC_T)) < 0.15, ids, -1)
    return {"features": ids, "labels": labels.astype(np.int16)}


def _vit_batch(seed):
    rng = np.random.default_rng(seed)
    x = np.frombuffer(rng.bytes(VIT_B * 224 * 224 * 3), np.uint8).reshape(
        VIT_B, 224, 224, 3).copy()  # writable, for torch.as_tensor
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, VIT_B)]
    return {"features": x, "labels": y}


def _moe_batch(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(MOE_SHAPE).astype(
        np.float32)).to(torch.bfloat16)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, MOE_SHAPE[0])]
    return {"features": x, "labels": y}


def _enc_model(name, seed=0, **kw):
    from distkeras_tpu_torch.models import bert, moe, transformer, vit

    make = {"bert": bert.bert_base, "vit": vit.vit_base,
            "moe": lambda **k: moe.MoEClassifier(
                10, num_layers=4, num_heads=12, num_experts=8, mlp_dim=3072,
                capacity_factor=2.0, width=768, **k)}[name]
    return transformer.init_params(make(**kw),
                                   torch.Generator().manual_seed(seed))


def _enc_steps(dev, model, batch, loss, steps, lr=1e-4, precision=None,
               kernels=()):
    """``steps`` adamw(``lr``) steps of the step engine on one batch
    (``overflow_guard`` where the policy scales the loss): losses, each
    step's wall (ending in a sync), the kernels' launches (zeroed just
    before the first step, read just after the last) and peak memory."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch import precision as precision_lib
    from distkeras_tpu_torch.ops import optimizers

    tx = optimizers.get("adamw", lr)
    policy = precision_lib.get_policy(precision)
    if policy is not None and policy.loss_scale != 1.0:
        tx = precision_lib.overflow_guard(tx, policy)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, loss, tx, precision=precision)
    batch = engine.to_device(batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
    info = {"losses": losses, "step_s": times,
            "launches": {k.__name__: k.launches for k in kernels},
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del state, step
    return info


def _enc_config4(dev, power_line) -> dict:
    """(a) ``python -m distkeras_tpu_torch.benchmarks 4 --full``'s
    configuration through the runner: BERT-base MLM under DynSGD
    (adam 1e-4, window 2, batch 32 x 128 int16 ids, 3 epochs of 2,048
    rows, one worker)."""
    from distkeras_tpu_torch.benchmarks import run_config

    set_tf32(False)
    t0 = time.perf_counter()
    out = run_config.config_4(True, device=dev)
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = power_line
    log(f"[encoders] (a) config 4 (bert-base MLM, DynSGD, batch 32 x 128, "
        f"3 epochs of 2048): {out['samples_per_sec']} samples/s over "
        f"{out['steps']} steps in {out['wall_s']} s, MFU {out.get('mfu')} "
        f"(bf16 peak), loss {out['first_loss']} -> {out['final_loss']} "
        f"({out['phase_s']:.1f} s with the warm-up run) [{power_line}]")
    assert "mfu" in out and out["mfu"] > 0, out
    assert out["steps"] == 3 * 2048 // 32, out
    assert math.isfinite(out["final_loss"]) and \
        out["final_loss"] < out["first_loss"], out
    return out


def _enc_int8(dev, power_line) -> dict:
    """(b) ``bert_base(precision="int8")``: ENC_STEPS steps, every encoder
    Dense and ``mlm_dense`` through the int8 kernel (12 x 4 + 1 launches a
    step); the bf16 model from the same weights within phase 12's witness
    bound (2e-2 relative) and not equal at step 1."""
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    set_tf32(False)
    batch = _bert_batch(30592, seed=4)
    run = _enc_steps(dev, _enc_model("bert", precision="int8"), batch,
                     "masked_lm", ENC_STEPS, precision="int8",
                     kernels=(i8.int8_matmul_dequant,))
    torch.cuda.empty_cache()
    bf16 = _enc_steps(dev, _enc_model("bert"), batch, "masked_lm",
                      ENC_STEPS)
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                               bf16["losses"])]
    info = {"int8": run, "bf16": bf16, "rel_diff": rel,
            "card": power_line}
    log(f"[encoders] (b) bert-base int8: losses "
        f"{', '.join(f'{x:.5f}' for x in run['losses'])}, steps "
        f"{', '.join(f'{x * 1e3:.1f}' for x in run['step_s'])} ms, launches "
        f"{run['launches']}; bf16 from the same weights "
        f"{', '.join(f'{x:.5f}' for x in bf16['losses'])} (steps "
        f"{', '.join(f'{x * 1e3:.1f}' for x in bf16['step_s'])} ms); "
        f"relative {', '.join(f'{x:.2e}' for x in rel)} (bound 2e-2, step 1 "
        f"must differ)")
    assert all(math.isfinite(x) for x in run["losses"]), info
    assert run["launches"]["int8_matmul_dequant"] == 49 * ENC_STEPS, info
    assert max(rel) <= 2e-2 and rel[0] > 0, info
    return info


def _enc_vit(dev, power_line) -> dict:
    """(c) ``vit_base()`` at 224^2, b=64, adamw(1e-4), bf16: 5 steps of
    the step engine on one batch of uint8 images (normalized on the
    device); the loss falls below the first step's."""
    set_tf32(False)
    run = _enc_steps(dev, _enc_model("vit"), _vit_batch(5),
                     "categorical_crossentropy", 5)
    torch.cuda.empty_cache()
    median_s = statistics.median(run["step_s"][1:])
    run.update(images_per_s=VIT_B / median_s, median_step_s=median_s,
               card=power_line)
    log(f"[encoders] (c) vit-base b={VIT_B} 224^2 uint8, adamw(1e-4): "
        f"losses {', '.join(f'{x:.4f}' for x in run['losses'])}; median "
        f"step {median_s * 1e3:.1f} ms ({run['images_per_s']:.0f} images/s), "
        f"peak {run['peak_bytes'] / 2**30:.2f} GiB")
    assert all(math.isfinite(x) for x in run["losses"]), run
    assert min(run["losses"][1:]) < run["losses"][0], run
    return run


def _enc_moe(dev, power_line) -> dict:
    """(d) The MoE classifier (4 layers, 12 heads, 8 experts, mlp 3072,
    capacity 2.0, attention="flash") on [16, 256, 768] bf16 features:
    MOE_STEPS adamw(1e-4) steps with rows 1-3 launched 4 times each a
    step; the sown aux term > 0 and in the objective; the same steps
    with attention="xla" within phase 8's 1e-3 relative."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.models import aux_losses
    from distkeras_tpu_torch.ops import losses as losses_lib
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    set_tf32(False)
    batch = _moe_batch(6)
    model = _enc_model("moe", attention="flash").to(dev)
    on_dev = engine.to_device(batch, dev)
    with torch.no_grad():
        with aux_losses.collect() as terms:
            logits = model(on_dev["features"])
        objective, _ = engine.make_loss_fn(
            model, "categorical_crossentropy")(on_dev)
        bare = losses_lib.get("categorical_crossentropy")(logits,
                                                          on_dev["labels"])
    aux = float(sum(terms))
    in_objective = float(objective) - float(bare)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    run = _enc_steps(dev, model, batch, "categorical_crossentropy",
                     MOE_STEPS, kernels=kernels)
    del model, logits, on_dev
    torch.cuda.empty_cache()
    xla = _enc_steps(dev, _enc_model("moe", attention="xla"), batch,
                     "categorical_crossentropy", MOE_STEPS)
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                               xla["losses"])]
    info = {"flash": run, "xla": xla, "rel_diff": rel, "aux": aux,
            "aux_in_objective": in_objective, "aux_terms": len(terms),
            "card": power_line}
    log(f"[encoders] (d) moe classifier flash: losses "
        f"{', '.join(f'{x:.5f}' for x in run['losses'])}, steps "
        f"{', '.join(f'{x * 1e3:.1f}' for x in run['step_s'])} ms, launches "
        f"{run['launches']}; xla {', '.join(f'{x:.5f}' for x in xla['losses'])}"
        f" (steps {', '.join(f'{x * 1e3:.1f}' for x in xla['step_s'])} ms), "
        f"relative {', '.join(f'{x:.2e}' for x in rel)} (bound 1e-3); aux "
        f"{aux:.6f} over {len(terms)} blocks, objective - loss "
        f"{in_objective:.6f}")
    assert all(n == 4 * MOE_STEPS for n in run["launches"].values()), info
    assert len(terms) == 4 and aux > 0, info
    assert abs(in_objective - aux) <= 1e-3 * max(1.0, aux), info
    assert max(rel) <= 1e-3, info
    return info


def _grad_run(dev, model, batch, loss, kernels):
    """One forward and backward of ``engine.make_grad_fn`` after one
    untimed warm-up call: loss, gradients (moved to the host), the
    kernels' launches, the wall time, peak memory and the memory
    allocated before the call."""
    from distkeras_tpu_torch import engine

    model.to(dev)
    batch = engine.to_device(batch, dev)
    grad_fn = engine.make_grad_fn(model, loss)
    grad_fn(batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    (value, _), grads = grad_fn(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"loss": float(value), "wall_s": wall, "peak_bytes": peak,
           "activation_bytes": peak - base,
           "launches": {k.__name__: k.launches for k in kernels}}
    host = {k: g.float().cpu() for k, g in grads.items()}
    del grads, grad_fn, batch
    model.cpu()
    torch.cuda.empty_cache()
    return out, host


def _remat_pair(dev, make, batch, loss, kernels) -> dict:
    runs, grads = {}, {}
    for policy in ("none", "blocks"):
        runs[policy], grads[policy] = _grad_run(dev, make(policy), batch,
                                                loss, kernels)
    rel = max(((grads["blocks"][k] - g).abs().max()
               / g.abs().max().clamp(min=1e-30)).item()
              for k, g in grads["none"].items())
    return {**runs, "bitwise": all(torch.equal(grads["blocks"][k], g)
                                   for k, g in grads["none"].items()),
            "max_rel_grad_diff": rel,
            "activation_ratio": runs["blocks"]["activation_bytes"]
            / runs["none"]["activation_bytes"],
            "peak_ratio": runs["blocks"]["peak_bytes"]
            / runs["none"]["peak_bytes"]}


def _enc_remat(dev, power_line) -> dict:
    """(e) ``remat="blocks"`` against ``"none"`` on phase 8's GPT step
    (gpt_small widths, 12 layers, [8, 2048], flash, bf16) and (c)'s ViT
    step: gradients bitwise where they are (reported), else within phase
    8's 1e-3 relative of each leaf's largest magnitude; peak memory lower
    under ``"blocks"``; the flash forward launched 24 times a step
    instead of 12 (the backward kernels 12 either way)."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    set_tf32(False)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    gpt = _remat_pair(
        dev, lambda r: _train_model(12, "flash", torch.bfloat16, seed=0,
                                    remat=r),
        _lm_batch(TRAIN_B, TRAIN_T, seed=1), "masked_lm", kernels)
    vit = _remat_pair(dev, lambda r: _enc_model("vit", remat=r),
                      _vit_batch(5), "categorical_crossentropy", ())
    info = {"gpt": gpt, "vit": vit, "card": power_line}
    for name, pair in (("gpt", gpt), ("vit", vit)):
        log(f"[encoders] (e) remat {name}: loss {pair['none']['loss']:.6f} / "
            f"{pair['blocks']['loss']:.6f} (none / blocks), grads bitwise "
            f"{pair['bitwise']} (max relative {pair['max_rel_grad_diff']:.2e}"
            f", bound 1e-3), peak {pair['none']['peak_bytes'] / 2**30:.2f} / "
            f"{pair['blocks']['peak_bytes'] / 2**30:.2f} GiB (activations "
            f"{pair['activation_ratio']:.3f}x, peak {pair['peak_ratio']:.3f}x)"
            f", fwd+bwd {pair['none']['wall_s'] * 1e3:.1f} / "
            f"{pair['blocks']['wall_s'] * 1e3:.1f} ms, launches "
            f"{pair['none']['launches']} / {pair['blocks']['launches']}")
        assert pair["max_rel_grad_diff"] <= 1e-3, info
        assert pair["blocks"]["peak_bytes"] < pair["none"]["peak_bytes"], info
    assert gpt["none"]["loss"] == gpt["blocks"]["loss"], info
    assert gpt["none"]["launches"] == {
        "flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
        "flash_attention_bwd_dkv": 12}, info
    assert gpt["blocks"]["launches"]["flash_attention_fwd"] == 24, info
    return info


def phase_encoders(dev, power_line) -> dict:
    t0 = time.perf_counter()
    out = {"config4": _enc_config4(dev, power_line)}
    torch.cuda.empty_cache()
    out["int8"] = _enc_int8(dev, power_line)
    out["vit"] = _enc_vit(dev, power_line)
    out["moe"] = _enc_moe(dev, power_line)
    out["remat"] = _enc_remat(dev, power_line)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[encoders] phase 28 in {out['phase_s']:.1f} s")
    return out


# -- phase 29: the one-process (workers x model) mesh --------------------------

PJIT_STEPS = 4
PJIT_B = 32            # config 4's batch (BERT) and rows a step
PJIT_MOE_B = 16        # phase 28 (d)'s batch, split over 2 workers
MESH_BUCKETS = (2, 4)  # phase 22's (1, 4) cannot split over 2 workers
PREDICT_ROWS = 8


def _pjit_run(dev, model, ds, mesh, loss, kernels, **kw):
    """One ``PjitTrainer`` epoch on ``mesh`` (``kw`` its optimizer and
    rules): losses, each kernel's launches (zeroed just before
    ``train()``, read just after), the wall time and the trainer."""
    from distkeras_tpu_torch import PjitTrainer

    trainer = PjitTrainer(model, loss=loss, metrics=(), mesh=mesh, **kw)
    torch.cuda.synchronize()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    trainer.train(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"losses": [h["loss"] for h in trainer.history], "wall_s": wall,
            "launches": {k.__name__: k.launches for k in kernels}}, trainer


def _shard_report(trainer) -> dict:
    """Each sharded parameter's shards against its whole bytes, and where
    its optimizer state lives."""
    from distkeras_tpu_torch import precision as precision_lib
    from distkeras_tpu_torch.parallel import tensor

    opt = trainer.state.opt_state
    inner = opt.inner if isinstance(
        opt, precision_lib.OverflowGuardState) else opt
    sharded, on_shards = {}, True
    for name, p in trainer.state.params.items():
        if not isinstance(p, tensor.Sharded):
            continue
        whole = math.prod(p.shape) * p.shards[0].element_size()
        sharded[name] = [s.nbytes / whole for s in p.shards]
        for s in p.shards:
            moments = [v for v in inner.state[s].values()
                       if torch.is_tensor(v) and v.dim() > 0]
            on_shards &= bool(moments) and all(
                v.shape == s.shape and v.device == s.device
                for v in moments)
    return {"sharded": sharded, "state_on_shards": on_shards}


def _pjit_config5(dev, power_line) -> dict:
    """(a) BASELINE config 5 (``vit-pjit``) through the runner at full
    width: ``vit_base()`` at 224^2 uint8, 1,000 classes, n=512, batch 64,
    adamw 1e-3, 8 epochs, one worker (the card count)."""
    from distkeras_tpu_torch.benchmarks import run_config

    set_tf32(False)
    t0 = time.perf_counter()
    out = run_config.config_5(True, device=dev)
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = power_line
    log(f"[pjit] (a) config 5 (vit-base, PjitTrainer, batch 64, 8 epochs of "
        f"512 uint8 224^2 images): {out['samples_per_sec']} samples/s over "
        f"{out['steps']} steps in {out['wall_s']} s, MFU {out.get('mfu')} "
        f"(bf16 peak), loss {out['first_loss']} -> {out['final_loss']} "
        f"({out['phase_s']:.1f} s with the warm-up run) [{power_line}]")
    assert "mfu" in out and out["mfu"] > 0, out
    assert out["steps"] == 8 * 512 // 64, out
    assert math.isfinite(out["final_loss"]) and \
        out["final_loss"] < out["first_loss"], out
    return out


def _pjit_int8(dev, power_line) -> dict:
    """(b) ``PjitTrainer(bert_base(), precision="int8")``: the model is
    built at its default precision, so ``apply_to_model`` re-stamps it;
    config 4's MLM data, adam 1e-4, PJIT_STEPS steps of batch 32 on
    ``Mesh(["cuda:0"] * 2, model_parallelism=2)`` and on ``[cuda:0]``:
    49 int8 launches a step, bitwise equal losses, each sharded
    parameter's shards half its bytes, adam's state on the shards."""
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8
    from distkeras_tpu_torch.parallel.mesh import Mesh

    set_tf32(False)
    rows = [_bert_batch(30592, seed=40 + i) for i in range(PJIT_STEPS)]
    ds = Dataset.from_arrays(
        features=np.concatenate([r["features"] for r in rows]),
        label=np.concatenate([r["labels"] for r in rows]))
    runs, reports = {}, {}
    # model 2, model 1, then model 2 again warm: the third run's wall
    # against the second's is the sharding's cost
    for key, m in (("model2", 2), ("model1", 1), ("model2_warm", 2)):
        model = _enc_model("bert")
        assert model.precision is None
        runs[key], trainer = _pjit_run(
            dev, model, ds, Mesh([dev] * m, model_parallelism=m),
            "masked_lm", (i8.int8_matmul_dequant,), precision="int8",
            worker_optimizer="adam", learning_rate=1e-4, batch_size=PJIT_B)
        assert trainer.model.precision == "int8" and \
            trainer.model is not model
        reports[key] = _shard_report(trainer)
        del trainer, model
        torch.cuda.empty_cache()
    halves = [f for fs in reports["model2"]["sharded"].values() for f in fs]
    info = {**runs, "shards": reports["model2"], "card": power_line,
            "bitwise": runs["model2"]["losses"] == runs["model1"]["losses"]
            == runs["model2_warm"]["losses"],
            "wall_ratio": runs["model2_warm"]["wall_s"]
            / runs["model1"]["wall_s"]}
    log(f"[pjit] (b) bert-base re-stamped to int8 under PjitTrainer: "
        f"model 2 losses "
        f"{', '.join(f'{x:.6f}' for x in runs['model2']['losses'])}, model 1 "
        f"{', '.join(f'{x:.6f}' for x in runs['model1']['losses'])}, "
        f"bitwise {info['bitwise']} (a second model-2 run too); walls "
        f"{runs['model2']['wall_s']:.3f} / {runs['model1']['wall_s']:.3f} / "
        f"{runs['model2_warm']['wall_s']:.3f} s for {PJIT_STEPS} steps "
        f"(model 2, 1, 2 warm: {info['wall_ratio']:.2f}x); int8 launches "
        f"{runs['model2']['launches']} / {runs['model1']['launches']}; "
        f"{len(reports['model2']['sharded'])} parameters sharded, each "
        f"shard {min(halves):.3f}-{max(halves):.3f} of its bytes, adam "
        f"state on the shards {reports['model2']['state_on_shards']}")
    for run in runs.values():
        assert run["launches"]["int8_matmul_dequant"] == \
            49 * PJIT_STEPS, info
        assert all(math.isfinite(x) for x in run["losses"]), info
    assert info["bitwise"], info
    assert reports["model2"]["sharded"] and all(f == 0.5 for f in halves), \
        info
    assert reports["model2"]["state_on_shards"], info
    assert not reports["model1"]["sharded"], info
    return info


def _pjit_moe(dev, power_line) -> dict:
    """(c) ``PjitTrainer(MoEClassifier(attention="flash"),
    partition_rules=ep_partition_rules())`` at workers 2 x model 2 on
    ``["cuda:0"] * 4``, phase 28 (d)'s model and rows, PJIT_STEPS
    adam(1e-4) steps of 16 rows: each flash kernel launched 4 times a
    step (the classifier's four blocks over the global batch), the
    expert tensors sharded on their stacked axis, finite losses within
    1e-3 relative of workers 1 x model 1's at steps 1-2 (phase 28 (d)'s
    bound for a top-1 route; bitwise reported), later steps reported."""
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models.moe import ep_partition_rules
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.parallel import tensor
    from distkeras_tpu_torch.parallel.mesh import Mesh

    set_tf32(False)
    rng = np.random.default_rng(6)
    n = PJIT_MOE_B * PJIT_STEPS
    x = rng.standard_normal((n,) + MOE_SHAPE[1:]).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    ds = Dataset.from_arrays(features=x, label=y)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    runs, experts = {}, None
    for key, (w, m) in (("w2m2", (2, 2)), ("w1m1", (1, 1))):
        runs[key], trainer = _pjit_run(
            dev, _enc_model("moe", attention="flash"), ds,
            Mesh([dev] * (w * m), model_parallelism=m),
            "categorical_crossentropy", kernels,
            partition_rules=ep_partition_rules(), worker_optimizer="adam",
            learning_rate=1e-4, batch_size=PJIT_MOE_B)
        if m == 2:
            experts = {name: (p.dim, [tuple(s.shape) for s in p.shards])
                       for name, p in trainer.state.params.items()
                       if ".experts." in name
                       and isinstance(p, tensor.Sharded)}
        del trainer
        torch.cuda.empty_cache()

    info = {**runs, "experts": experts, "card": power_line,
            "rel": [abs(u - v) / abs(v) for u, v in zip(
                runs["w2m2"]["losses"], runs["w1m1"]["losses"])],
            "bitwise": runs["w2m2"]["losses"] == runs["w1m1"]["losses"]}

    def fmt(values, spec):
        return ", ".join(format(v, spec) for v in values)

    log(f"[pjit] (c) moe classifier flash under ep_partition_rules: workers "
        f"2 x model 2 losses {fmt(runs['w2m2']['losses'], '.5f')} "
        f"({runs['w2m2']['wall_s']:.2f} s, launches "
        f"{runs['w2m2']['launches']}); workers 1 x model 1 "
        f"{fmt(runs['w1m1']['losses'], '.5f')} "
        f"({runs['w1m1']['wall_s']:.2f} s, launches "
        f"{runs['w1m1']['launches']}), relative {fmt(info['rel'], '.2e')}"
        f" (bound 1e-3 at steps 1-2), bitwise {info['bitwise']}; "
        f"{len(experts)} expert tensors sharded, e.g. "
        f"{next(iter(experts.items()))}")
    assert all(math.isfinite(x) for run in runs.values()
               for x in run["losses"]), info
    for run in runs.values():
        assert all(v == 4 * PJIT_STEPS
                   for v in run["launches"].values()), info
    assert len(experts) == 4 * 4 and all(
        d == 0 and [s[0] for s in shapes] == [4, 4]
        for d, shapes in experts.values()), info
    assert max(info["rel"][:2]) <= 1e-3, info
    return info


def _pjit_serving(dev, power_line) -> dict:
    """(d) ``ServingEngine(mesh=Mesh(["cuda:0"] * 2))`` with phase 22's
    one-shot shapes (gpt_small, flash, bf16, 128-token rows), buckets
    (2, 4): rows within 2e-2 * max|ref| of the ``mesh=None`` engine's on
    the same rows, buckets x shards captures, all in ``__init__``, and
    the flash forward counted per replay (layers x shards a batch)."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.parallel.mesh import Mesh
    from distkeras_tpu_torch.serving import ServingEngine

    set_tf32(False)
    telemetry.reset()
    rows = np.random.default_rng(29).integers(
        0, WIRE_LM["vocab_size"], (7, WIRE_ROW)).astype(np.int32)
    kw = dict(input_dtype=np.int32, buckets=MESH_BUCKETS, max_wait_ms=50.0)
    fa.flash_attention_fwd.captured = 0
    t0 = time.perf_counter()
    eng = ServingEngine(_flash_lm(torch.bfloat16), (WIRE_ROW,),
                        mesh=Mesh([dev] * 2), **kw)
    setup_s = time.perf_counter() - t0
    captured = fa.flash_attention_fwd.captured
    compiles = telemetry.counter("serving.compiles").value
    try:
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        got = np.stack([f.result(timeout=120)
                        for f in eng.submit_many(rows)]).astype(np.float32)
        serve_s = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches
        batches = int(telemetry.counter("serving.batches").value)
        assert fa.flash_attention_fwd.captured == captured
        assert telemetry.counter("serving.compiles").value == compiles
        captures = eng.captures
    finally:
        eng.shutdown()
    one = ServingEngine(_flash_lm(torch.bfloat16), (WIRE_ROW,), device=dev,
                        **kw)
    try:
        want = np.stack([one.submit(r).result(timeout=120)
                         for r in rows]).astype(np.float32)
    finally:
        one.shutdown()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    info = {"captures": captures, "captured_flash": captured,
            "compiles": compiles, "launches": launches, "batches": batches,
            "max_abs_err": err, "max_abs_ref": scale, "setup_s": setup_s,
            "serve_s": serve_s, "card": power_line}
    log(f"[pjit] (d) ServingEngine over Mesh([cuda:0] x 2), gpt_small flash "
        f"bf16, buckets {MESH_BUCKETS}: {captures} graphs captured in "
        f"__init__ ({setup_s:.2f} s; {captured} flash calls recorded, "
        f"compiles {compiles}), none under traffic; {len(rows)} rows in "
        f"{batches} batches, {launches} flash forward launches "
        f"(12 layers x 2 shards a batch); max |mesh - mesh=None| {err:.4e} "
        f"<= 2e-2 x max |ref| {scale:.3f}")
    assert captures == len(MESH_BUCKETS) * 2 == compiles, info
    assert captured == 12 * captures, info
    assert launches == 12 * 2 * batches and batches >= 2, info
    assert err <= 2e-2 * scale, info
    return info


def _pjit_predictor(dev, power_line) -> dict:
    """(e) ``ModelPredictor(mesh=Mesh(["cuda:0"] * 2))`` at float32 (TF32
    off; the flash kernels' float32 path) against ``mesh=None``: within
    phase 7's float32 bound, 1e-5 * max|ref|."""
    from distkeras_tpu_torch import Dataset, ModelPredictor
    from distkeras_tpu_torch.parallel.mesh import Mesh

    set_tf32(False)
    model = _flash_lm(torch.float32, seed=5, num_layers=4)
    ds = Dataset.from_arrays(features=np.random.default_rng(7).integers(
        0, WIRE_LM["vocab_size"], (PREDICT_ROWS + 1, WIRE_ROW)).astype(
        np.int32))
    t0 = time.perf_counter()
    got = ModelPredictor(model, mesh=Mesh([dev] * 2), batch_size=2).predict(
        ds)["prediction"]
    mesh_s = time.perf_counter() - t0
    want = ModelPredictor(model, device=dev, batch_size=2).predict(
        ds)["prediction"]
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    info = {"max_abs_err": err, "max_abs_ref": scale, "mesh_s": mesh_s,
            "rows": len(ds), "card": power_line}
    log(f"[pjit] (e) ModelPredictor over Mesh([cuda:0] x 2), 4-layer "
        f"gpt_small widths float32 flash, {len(ds)} rows (a padded tail): "
        f"max |mesh - mesh=None| {err:.3e} <= 1e-5 x max |ref| {scale:.3f}")
    assert got.shape == want.shape == (len(ds), WIRE_ROW,
                                       WIRE_LM["vocab_size"]), info
    assert err <= 1e-5 * scale, info
    return info


def _pjit_native(dev, power_line) -> dict:
    """(f) The native batcher, built by g++ from the port's copy of its
    source: available, a gather bitwise equal to NumPy's, and rows/s of
    config 5's 512-image shuffle (uint8 224^2) native and NumPy."""
    from distkeras_tpu_torch.data import native
    from distkeras_tpu_torch.data.dataset import Dataset

    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    assert ok, "the native batcher did not build or load"
    rng = np.random.default_rng(8)
    x = np.frombuffer(rng.bytes(512 * 224 * 224 * 3), np.uint8).reshape(
        512, 224, 224, 3)
    idx = rng.integers(0, 512, 4096).astype(np.int64)
    assert np.array_equal(native.gather_rows(x, idx), x[idx])
    ds = Dataset.from_arrays(features=x, label=np.zeros((512, 1000),
                                                         np.float32))
    times = []
    for seed in range(5):
        t0 = time.perf_counter()
        ds.shuffle(seed)
        times.append(time.perf_counter() - t0)
    perm = np.random.default_rng(0).permutation(512)
    np_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        x[perm]
        np_times.append(time.perf_counter() - t0)
    info = {"available": ok, "build_s": build_s,
            "shuffle_rows_per_s": 512 / statistics.median(times),
            "numpy_gather_rows_per_s": 512 / statistics.median(np_times),
            "card": power_line}
    log(f"[pjit] (f) native batcher available ({build_s:.2f} s; g++ builds "
        f"it at its first use, an earlier phase's shuffle in a full run): "
        f"gather bitwise equal to NumPy's; config 5's 512-image shuffle "
        f"{info['shuffle_rows_per_s']:.0f} rows/s (median of 5, both "
        f"columns), NumPy's gather of the images "
        f"{info['numpy_gather_rows_per_s']:.0f} rows/s (host, warm)")
    return info


def _pjit_job(dev, power_line) -> dict:
    """(g) A ``Punchcard`` of one ``SingleTrainer`` MLP job saved as a
    bundle and run by ``LocalLauncher`` in a fresh interpreter (no
    ``device`` kwarg: the trainer's default ``cuda:0``), its results read
    back."""
    import tempfile

    from distkeras_tpu_torch.job_deployment import (Job, LocalLauncher,
                                                    Punchcard)

    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        card = Punchcard(jobs=[Job(
            "chip-mlp", "SingleTrainer",
            model="distkeras_tpu_torch.models.mlp:mnist_mlp",
            data="distkeras_tpu_torch.data.dataset:synthetic_mnist",
            batch_size=128, num_epoch=1)])
        bundle = card.save_bundle(os.path.join(tmp, "bundle"))
        t0 = time.perf_counter()
        handle = LocalLauncher().submit(bundle)
        try:
            status = handle.wait(timeout=300)
        finally:
            if handle._proc.poll() is None:  # stop what this phase started
                handle._proc.kill()
                handle._proc.wait()
        wall = time.perf_counter() - t0
        log_path = handle.log_path if os.path.exists(handle.log_path) \
            else handle._log_tmp
        tail = open(log_path).read()[-2000:] if os.path.exists(log_path) \
            else ""
        assert status == "SUCCEEDED", (status, tail)
        results = handle.results()
    info = {"status": status, "results": results, "wall_s": wall,
            "card": power_line}
    log(f"[pjit] (g) LocalLauncher ran a one-job Punchcard (SingleTrainer, "
        f"mnist_mlp, synthetic_mnist, batch 128) in a fresh interpreter on "
        f"the card: {status} in {wall:.1f} s, results {results}")
    assert len(results) == 1 and results[0]["job_name"] == "chip-mlp", info
    assert results[0]["training_time"] > 0, info
    return info


def phase_pjit(dev, power_line) -> dict:
    """Phase 29: the one-process (workers x model) mesh (module
    docstring)."""
    t0 = time.perf_counter()
    out = {"config5": _pjit_config5(dev, power_line)}
    torch.cuda.empty_cache()
    out["int8"] = _pjit_int8(dev, power_line)
    out["moe"] = _pjit_moe(dev, power_line)
    out["serving"] = _pjit_serving(dev, power_line)
    torch.cuda.empty_cache()
    out["predictor"] = _pjit_predictor(dev, power_line)
    torch.cuda.empty_cache()
    out["native"] = _pjit_native(dev, power_line)
    out["job"] = _pjit_job(dev, power_line)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[pjit] phase 29 in {out['phase_s']:.1f} s")
    return out


# -- phase 30 -----------------------------------------------------------------

#: (a) sequence parallelism at gpt_small's widths: the (workers, seq)
#: mesh, the global batch x T (gpt_small's max_len), adamw(1e-3) steps
SP_MESH, SP_B, SP_T, SP_STEPS = (1, 4), 8, 1024, 4
#: (a)'s bound on step 1's loss against attention="full" through the
#: single-device step, relative: the plain attention rounds its softmax
#: weights to bf16 (2^-9) before p.v where the ring keeps them float32;
#: through 12 bf16 layers that moved the loss by 7e-6-2e-5 in a CPU
#: rehearsal at gpt_small widths, so 1e-3 holds it with margin
SP_FULL_REL = 1e-3
#: (b) the other mesh, float32, one sgd(0.1) step: loss and parameters
#: within 1e-5 relative (only the fold's order differs). At bf16 the
#: fold's float32 differences flip bf16 roundings of the attention
#: output: 1.1e-5-1.5e-5 in the same CPU rehearsal, reported, not gated
SP_MESH_B, SP_MESH_REL, SP_SGD_LR = (2, 2), 1e-5, 0.1
#: gpt_small's widths ((c) takes another max_len)
GPT_SMALL_WIDTHS = dict(vocab_size=50304, num_layers=12, num_heads=12,
                        width=768, mlp_dim=3072)
#: (c) long context: gpt_small's widths at max_len 8192, b=1 on seq 8,
#: remat="blocks", adamw(1e-3)
LONG_T, LONG_SEQ, LONG_STEPS = 8192, 8, 2
#: (d) PipelinedLM at gpt_small's config: stages, microbatches, batch, T
PP_LM = dict(GPT_SMALL_WIDTHS, max_len=1024)
PP_STAGES, PP_M, PP_B, PP_T, PP_STEPS = 4, 4, 8, 1024, 4
#: (d)'s bounds against reference_apply over the schedule's microbatches
#: (the same ops on the same shapes, so the forward is expected bitwise;
#: the gradients differ only in the order autograd sums a parameter's
#: M = 4 uses, a few float32 ulps, and an SGD update rounds at the
#: parameter's scale): loss 1e-6 relative, parameters 1e-6 of each
#: leaf's largest magnitude
PP_LOSS_REL, PP_PARAM_REL = 1e-6, 1e-6
#: (e) GenericPipeline over resnet50(): batch, image side, microbatches;
#: the loss against the sequential oracle (the same kernels on the same
#: shapes and layouts: expected bitwise), relative
GP_B, GP_SIDE, GP_M, GP_LOSS_REL = 32, 224, 4, 1e-6


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_rel(got: dict, want: dict) -> float:
    """Largest ``max|got - want| / max|want|`` over the leaves."""
    worst = 0.0
    for name, w in want.items():
        diff = (got[name].float() - w.float()).abs().max().item()
        worst = max(worst, diff / max(w.float().abs().max().item(), 1e-30))
    return worst


def _sp_batch(b, t, seed):
    from distkeras_tpu_torch.parallel.sequence import shift_labels

    ids = np.random.default_rng(seed).integers(1, 50304, (b, t)).astype(
        np.int32)
    return {"input_ids": ids, "labels": shift_labels(ids)}


def _peak_over(dev, base) -> tuple:
    """(peak bytes, peak less ``base``, what was allocated when the run
    started: earlier phases' leftovers and the run's weights)."""
    peak = torch.cuda.max_memory_allocated(dev)
    return peak, peak - base


def _sp_steps(dev, model, mesh_shape, batch, tx, steps, devices=None):
    """``steps`` of ``build_sp_train_step`` over a (workers, seq) mesh
    repeating ``dev`` (``devices``: this process's, in a process group):
    losses, step seconds, (peak bytes, the run's own peak bytes)."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.parallel import sequence

    mesh = sequence.make_sp_mesh(*mesh_shape, devices=devices or [dev] * (
        mesh_shape[0] * mesh_shape[1]))
    step_fn, place_state, place_batch = sequence.build_sp_train_step(
        model, tx, mesh)
    state = place_state(engine.TrainState(0, model, tx(model.parameters())))
    placed = place_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, ms = step_fn(state, placed)
        losses.append(float(ms["loss"]))
        times.append(time.perf_counter() - t0)
    return losses, times, _peak_over(dev, base)


def _seq_ring(dev, power_line, start) -> dict:
    """(a) gpt_small(attention="ring") in bf16 through
    build_sp_train_step on workers 1 x seq 4, T = 1,024, b = 8, adamw:
    step 1's loss against attention="full" through the single-device
    step from the same weights."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.models.gpt import gpt_small
    from distkeras_tpu_torch.ops import optimizers

    tx = optimizers.get("adamw", 1e-3)
    batch = _sp_batch(SP_B, SP_T, seed=40)
    full = gpt_small(attention="full")
    full.load_state_dict(start)
    state = engine.create_train_state(full, tx, device=dev)
    step = engine.make_train_step(full, "masked_lm", tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    _, ms = step(state, {"features": batch["input_ids"],
                         "labels": batch["labels"]})
    full_loss = float(ms["loss"])
    full_s = time.perf_counter() - t0
    full_peak = _peak_over(dev, base)
    del full, state, step
    torch.cuda.empty_cache()
    ring = gpt_small(attention="ring")
    ring.load_state_dict(start)
    ring.to(dev)
    losses, times, peak = _sp_steps(dev, ring, SP_MESH, batch, tx, SP_STEPS)
    median_s = statistics.median(times[1:])
    info = {"mesh": list(SP_MESH), "losses": losses, "step_s": times,
            "median_step_s": median_s,
            "tokens_per_s": SP_B * SP_T / median_s, "peak_bytes": peak[0],
            "own_peak_bytes": peak[1], "full_loss": full_loss,
            "full_step_s": full_s, "full_peak_bytes": full_peak[0],
            "full_own_peak_bytes": full_peak[1],
            "rel_vs_full": _rel(losses[0], full_loss), "card": power_line}
    log(f"[seqpipe] (a) gpt_small ring, bf16, workers {SP_MESH[0]} x seq "
        f"{SP_MESH[1]}, b={SP_B}, T={SP_T}, adamw(1e-3): losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; step 1 against "
        f"attention='full' through the single-device step {full_loss:.5f}: "
        f"relative {info['rel_vs_full']:.3e} (bound {SP_FULL_REL}); median "
        f"step {median_s * 1e3:.1f} ms, {info['tokens_per_s']:.0f} tokens/s; "
        f"peak {peak[0] / 2**30:.2f} GiB (+{peak[1] / 2**30:.2f} over its "
        f"start) "
        f"against the full step's {full_peak[0] / 2**30:.2f} GiB "
        f"(+{full_peak[1] / 2**30:.2f}) [{power_line}]")
    assert all(math.isfinite(x) for x in losses), losses
    assert info["rel_vs_full"] <= SP_FULL_REL, info
    assert min(losses[1:]) < losses[0], losses
    del ring
    torch.cuda.empty_cache()
    return info


def _seq_meshes(dev, power_line, start, bf16_loss) -> dict:
    """(b) workers 2 x seq 2 against workers 1 x seq 4 on (a)'s weights
    and batch: float32 (gated), one sgd step each; and bf16 step 1 on
    2 x 2 against (a)'s (reported)."""
    from distkeras_tpu_torch.models.gpt import gpt_small
    from distkeras_tpu_torch.ops import optimizers

    batch = _sp_batch(SP_B, SP_T, seed=40)
    tx = optimizers.get("sgd", SP_SGD_LR)
    runs = {}
    for shape in (SP_MESH, SP_MESH_B):
        model = gpt_small(attention="ring", dtype=torch.float32)
        model.load_state_dict(start)
        model.to(dev)
        losses, times, _ = _sp_steps(dev, model, shape, batch, tx, 1)
        runs[shape] = (losses[0], {n: p.detach().clone() for n, p in
                                   model.named_parameters()})
        del model
        torch.cuda.empty_cache()
    (loss_a, params_a), (loss_b, params_b) = runs[SP_MESH], runs[SP_MESH_B]
    start_dev = {n: t.to(dev) for n, t in start.items()}
    upd = lambda p: {n: t - start_dev[n] for n, t in p.items()}
    model = gpt_small(attention="ring")
    model.load_state_dict(start)
    model.to(dev)
    bf16, _, _ = _sp_steps(dev, model, SP_MESH_B, batch,
                           optimizers.get("sgd", 0.0), 1)
    del model
    info = {"meshes": [list(SP_MESH), list(SP_MESH_B)],
            "losses_f32": [loss_a, loss_b],
            "loss_rel": _rel(loss_b, loss_a),
            "param_rel": _leaf_rel(params_b, params_a),
            "update_rel": _leaf_rel(upd(params_b), upd(params_a)),
            "bf16_loss_2x2": bf16[0], "bf16_rel": _rel(bf16[0], bf16_loss),
            "card": power_line}
    log(f"[seqpipe] (b) float32, one sgd({SP_SGD_LR}) step, workers "
        f"{SP_MESH_B[0]} x seq {SP_MESH_B[1]} against {SP_MESH[0]} x "
        f"{SP_MESH[1]}: losses {loss_b:.7f} / {loss_a:.7f} (relative "
        f"{info['loss_rel']:.3e}), parameters {info['param_rel']:.3e} of "
        f"each leaf's largest (bound {SP_MESH_REL}), updates "
        f"{info['update_rel']:.3e} of the largest update; bf16 step 1 on "
        f"2 x 2 {bf16[0]:.5f} against (a)'s {bf16_loss:.5f}: relative "
        f"{info['bf16_rel']:.3e} (reported) [{power_line}]")
    assert info["loss_rel"] <= SP_MESH_REL, info
    assert info["param_rel"] <= SP_MESH_REL, info
    del params_a, params_b, start_dev
    torch.cuda.empty_cache()
    return info


def _seq_long(dev, power_line) -> dict:
    """(c) gpt_small's widths at max_len 8,192: b = 1 on seq 8 under
    remat="blocks", adamw(1e-3), LONG_STEPS steps; every shard's folds
    live on the one card, so no memory gain is claimed."""
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params
    from distkeras_tpu_torch.ops import optimizers

    model = init_params(CausalLM(**GPT_SMALL_WIDTHS, max_len=LONG_T,
                                 attention="ring", remat="blocks"),
                        torch.Generator().manual_seed(41))
    model.to(dev)
    losses, times, peak = _sp_steps(dev, model, (1, LONG_SEQ),
                                    _sp_batch(1, LONG_T, seed=42),
                                    optimizers.get("adamw", 1e-3),
                                    LONG_STEPS)
    info = {"T": LONG_T, "seq": LONG_SEQ, "losses": losses, "step_s": times,
            "peak_bytes": peak[0], "own_peak_bytes": peak[1],
            "tokens_per_s": LONG_T / times[-1], "card": power_line}
    log(f"[seqpipe] (c) long context: gpt_small widths, max_len {LONG_T}, "
        f"b=1 on seq {LONG_SEQ} (t={LONG_T // LONG_SEQ} a shard), remat "
        f"blocks, bf16: losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"steps {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; peak "
        f"{peak[0] / 2**30:.2f} GiB (+{peak[1] / 2**30:.2f} over its start; "
        f"all 8 shards' folds on one card) [{power_line}]")
    assert all(math.isfinite(x) for x in losses), losses
    del model
    torch.cuda.empty_cache()
    return info


def _pipe_lm(dev, power_line) -> dict:
    """(d) PipelinedLM at gpt_small's config in bf16, 12 layers over 4
    stages of 3, M = 4 microbatches of 2 at T = 1,024: one sgd step
    against reference_apply over the same microbatches, then adamw
    steps."""
    from distkeras_tpu_torch.ops import losses as losses_lib
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import pipeline

    model = pipeline.PipelinedLM(**PP_LM, num_stages=PP_STAGES,
                                 dtype=torch.bfloat16, device=dev).init(43)
    mesh = pipeline.make_pp_mesh(PP_STAGES, devices=[dev] * PP_STAGES)
    batch = _sp_batch(PP_B, PP_T, seed=44)
    ids = torch.from_numpy(batch["input_ids"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)
    mb = PP_B // PP_M
    # the oracle: reference_apply over the schedule's microbatches
    nll = count = 0.0
    for m in range(PP_M):
        terms = losses_lib.masked_lm_terms(
            model.reference_apply(ids[m * mb:(m + 1) * mb]),
            labels[m * mb:(m + 1) * mb])
        nll, count = nll + terms[0], count + terms[2]
    ref_loss = nll / torch.clamp(count, min=1.0)
    ref_loss.backward()
    ref_loss = ref_loss.item()
    expect = {n: torch.add(p.detach(), p.grad, alpha=-SP_SGD_LR)
              for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    with torch.no_grad():  # the whole batch in one call (reported)
        whole = losses_lib.masked_lm(model.reference_apply(ids), labels)
    step_fn, place_params, place_batch = model.build_train_step(
        optimizers.get("sgd", SP_SGD_LR), mesh, PP_M)
    state, ms = step_fn(place_params(), place_batch(batch))
    got = {n: p.detach() for n, p in model.named_parameters()}
    info = {"stages": PP_STAGES, "microbatches": PP_M,
            "loss": float(ms["loss"]), "ref_loss": ref_loss,
            "whole_batch_loss": float(whole),
            "loss_rel": _rel(float(ms["loss"]), ref_loss),
            "loss_bitwise": float(ms["loss"]) == ref_loss,
            "param_rel": _leaf_rel(got, expect)}
    del expect, got
    step_fn, place_params, _ = model.build_train_step(
        optimizers.get("adamw", 1e-3), mesh, PP_M)
    state = place_params()
    placed = place_batch(batch)
    losses, times = [], []
    for _ in range(PP_STEPS):
        t0 = time.perf_counter()
        state, ms = step_fn(state, placed)
        losses.append(float(ms["loss"]))
        times.append(time.perf_counter() - t0)
    info.update(losses=losses, step_s=times,
                median_step_s=statistics.median(times[1:]),
                tokens_per_s=PP_B * PP_T / statistics.median(times[1:]),
                card=power_line)
    log(f"[seqpipe] (d) PipelinedLM gpt_small config, bf16, {PP_STAGES} "
        f"stages x {PP_LM['num_layers'] // PP_STAGES} layers, M={PP_M} x "
        f"{mb} at T={PP_T}: one sgd step "
        f"loss {info['loss']:.6f} against reference_apply over the same "
        f"microbatches {info['ref_loss']:.6f} (relative "
        f"{info['loss_rel']:.3e}, bitwise {info['loss_bitwise']}; the "
        f"whole batch in one call {info['whole_batch_loss']:.6f}), "
        f"parameters {info['param_rel']:.3e} of each leaf's largest "
        f"(bounds {PP_LOSS_REL}, {PP_PARAM_REL}); adamw(1e-3) losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}, median step "
        f"{info['median_step_s'] * 1e3:.1f} ms, "
        f"{info['tokens_per_s']:.0f} tokens/s [{power_line}]")
    assert info["loss_rel"] <= PP_LOSS_REL, info
    assert info["param_rel"] <= PP_PARAM_REL, info
    assert all(math.isfinite(x) for x in losses), losses
    assert min(losses[1:]) < losses[0], losses
    del model, state
    torch.cuda.empty_cache()
    return info


def _resnet_pipeline_stages(model) -> list:
    """resnet50()'s forward cut into a stem, its four stages and the
    head, as modules (NHWC float images in, float32 logits out; each
    stage takes its input back to channels_last, the layout a hop's flat
    buffer loses)."""
    from torch import nn
    from torch.nn import functional as F

    class Stem(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv_stem, self.norm_stem = model.conv_stem, model.norm_stem

        def forward(self, x):
            x = self.conv_stem(x.to(model.dtype).permute(0, 3, 1, 2))
            x = self.norm_stem(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            return F.max_pool2d(F.relu(x), 3, stride=2, padding=1)

    class Stage(nn.Module):
        def __init__(self, names):
            super().__init__()
            self.blocks = nn.ModuleList(getattr(model, n) for n in names)

        def forward(self, x):
            x = x.contiguous(memory_format=torch.channels_last)
            for block in self.blocks:
                x = block(x)
            return x

    class Head(nn.Module):
        def __init__(self):
            super().__init__()
            self.head = model.head

        def forward(self, x):
            return self.head(x.mean(dim=(2, 3)).float())

    stages = [[n for n in model._blocks if n.startswith(f"stage{i}_")]
              for i in range(len(model.stage_sizes))]
    return [Stem()] + [Stage(s) for s in stages] + [Head()]


def _pipe_generic(dev, power_line) -> dict:
    """(e) GenericPipeline over resnet50() (GroupNorm) cut into stem /
    four stages / head, b = 32 at 224^2, M = 4: the loss against the
    sequential oracle over the same microbatches; both GroupNorm
    kernels' launches over the step."""
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn
    from distkeras_tpu_torch.parallel import pipeline

    model = _resnet_model("gn", torch.bfloat16, seed=45)
    parts = _resnet_pipeline_stages(model)
    pipe = pipeline.GenericPipeline(parts, num_microbatches=GP_M,
                                    dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(46)
    feats = rng.standard_normal((GP_B, GP_SIDE, GP_SIDE, 3)).astype(
        np.float32)
    labels = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, GP_B)]
    mb = GP_B // GP_M
    pipe.init(feats[:mb])
    mesh = pipeline.make_pp_mesh(len(parts), devices=[dev] * len(parts))
    step_fn, place_params, place_batch = pipe.build_train_step(
        optimizers.get("adamw", 1e-3), mesh)
    state = place_params()
    placed = place_batch({"features": feats, "labels": labels})
    with torch.no_grad():
        oracle = sum(pipe.loss_fn(pipe.reference_apply(
            placed["features"][m * mb:(m + 1) * mb]).float(),
            placed["labels"][m * mb:(m + 1) * mb])
            for m in range(GP_M)) / GP_M
    kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
    torch.cuda.synchronize()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    state, ms = step_fn(state, placed)
    loss = float(ms["loss"])
    step_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    info = {"stages": len(parts), "microbatches": GP_M,
            "shapes": [list(s) for s in pipe._shapes], "loss": loss,
            "oracle_loss": float(oracle),
            "loss_rel": _rel(loss, float(oracle)),
            "loss_bitwise": loss == float(oracle), "step_s": step_s,
            "launches": launches, "card": power_line}
    log(f"[seqpipe] (e) GenericPipeline over resnet50() (GroupNorm), "
        f"{len(parts)} stages (stem, 4 stages, head), b={GP_B} at "
        f"{GP_SIDE}^2, "
        f"M={GP_M}, bf16 hops: loss {loss:.6f} against the sequential "
        f"oracle {info['oracle_loss']:.6f} (relative {info['loss_rel']:.3e}, "
        f"bitwise {info['loss_bitwise']}; bound {GP_LOSS_REL}); step "
        f"{step_s * 1e3:.1f} ms; GroupNorm launches {launches} (53 x M = "
        f"{53 * GP_M} each) [{power_line}]")
    assert info["loss_rel"] <= GP_LOSS_REL, info
    assert all(n == 53 * GP_M for n in launches.values()), launches
    del pipe, parts, model, state, placed
    torch.cuda.empty_cache()
    return info


def phase_sequence_pipeline(dev, power_line) -> dict:
    """Phase 30: sequence and pipeline parallelism in one process on
    meshes that repeat ``cuda:0`` (module docstring), TF32 off."""
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params

    set_tf32(False)
    t0 = time.perf_counter()
    start = init_params(gpt_small(), torch.Generator().manual_seed(39)) \
        .state_dict()
    out = {"ring": _seq_ring(dev, power_line, start)}
    out["meshes"] = _seq_meshes(dev, power_line, start,
                                out["ring"]["losses"][0])
    del start
    out["long"] = _seq_long(dev, power_line)
    # cuDNN's deterministic choice, as phase 34's ranks make it: their
    # pipelines are held to these bit for bit
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        out["pipelined_lm"] = _pipe_lm(dev, power_line)
        out["generic"] = _pipe_generic(dev, power_line)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    out["phase_s"] = time.perf_counter() - t0
    log(f"[seqpipe] phase 30 in {out['phase_s']:.1f} s [{power_line}]")
    return out


# -- phase 31 ----------------------------------------------------------------

#: (a) and (b): rows, rows a range or a shard file (one round: batch x
#: window), batch, window, workers, epochs
DATA_ROWS, DATA_RANGE = 4096, 512
DATA_B, DATA_WINDOW, DATA_K, DATA_EPOCHS = 128, 4, 2, 2
#: (a)'s lease (s): about four times the longest hold between a live
#: worker's lease calls measured on a slow host (5.15 s; printed beside
#: it), and the tail of epoch 0 waits it out once for the dead worker's
#: two ranges
DATA_LEASE_S = 20.0
#: (a)'s snapshot cadence (commits)
DATA_FOLDS = 8
#: (c) the MNIST MLP: rows, batch, epochs
RETRY_N, RETRY_B, RETRY_EPOCHS = 4096, 64, 3


def _data_trainer(mode, dev, **kw):
    import distkeras_tpu_torch as dk

    place = dict(num_workers=DATA_K) if mode == "host_async" else \
        dict(num_workers=1, parallelism_factor=DATA_K)
    return dk.ADAG(_nf_model(seed=40), mode=mode, worker_optimizer="sgd",
                   learning_rate=0.05, batch_size=DATA_B,
                   communication_window=DATA_WINDOW, metrics=(),
                   device=dev, **place, **kw)


def _counter_total(name) -> float:
    from distkeras_tpu_torch import telemetry

    return sum(v for k, v in telemetry.get_registry().snapshot()[
        "counters"].items() if k.split("{")[0] == name)


def _data_stream(dev, power_line, staged_rate) -> dict:
    """(a) host_async from a data service, with a worker that died
    holding two leased ranges before the trainer started."""
    import tempfile

    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.data import service

    ds = _learnable_images(DATA_ROWS, seed=41)
    coord = service.DataCoordinator(dataset=ds, range_size=DATA_RANGE,
                                    seed=42, num_epochs=DATA_EPOCHS,
                                    lease_s=DATA_LEASE_S)
    lease_calls = []  # (perf_counter, worker) of every lease call
    orig_lease = service.DataServiceClient.lease

    def lease(client, *a, **kw):
        lease_calls.append((time.perf_counter(), client.worker))
        return orig_lease(client, *a, **kw)

    os.makedirs(OUT_DIR, exist_ok=True)
    telemetry.reset()
    coord.start()
    try:
        releases0 = _counter_total("data.service.releases")
        stale0 = _counter_total("data.service.stale_acks")
        dead = service.DataServiceClient(coord.address, worker=99)
        dead.register()
        grant = dead.lease(max_ranges=3)
        pos, start, stop = grant["ranges"][0]
        dead.fetch(start, stop)
        dead.ack(grant["epoch"], [pos])
        dead.close()  # no deregister: a killed worker
        with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
            trainer = _data_trainer("host_async", dev, data_service=coord,
                                    checkpoint_dir=d,
                                    checkpoint_folds=DATA_FOLDS)
            service.DataServiceClient.lease = lease
            clock = _WindowClock()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                trainer.train(None)
            finally:
                clock.close()
                service.DataServiceClient.lease = orig_lease
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ckpt = Checkpointer(d)
            last = ckpt.latest_step()
            snap_cursor = [int(v) for v in np.asarray(
                ckpt.restore(step=last)["data_cursor"]).ravel()]
        cursor = [int(v) for v in coord.cursor_carry()]
        releases = _counter_total("data.service.releases") - releases0
        stale = _counter_total("data.service.stale_acks") - stale0
    finally:
        coord.stop()
    holds = {}
    for w in range(DATA_K):
        ts = [t for t, ww in lease_calls if ww == w]
        holds[w] = max(b - a for a, b in zip(ts, ts[1:])) \
            if len(ts) > 1 else 0.0
    marks = sorted(t for t, _ in clock.marks)
    gaps = [b - a for a, b in zip(marks, marks[1:])]
    samples = DATA_WINDOW * DATA_B
    losses = [h["loss"] for h in trainer.get_history()]
    rtt = {op: telemetry.histogram("data.service.client.rtt_s",
                                   op=op).stats()["p50"]
           for op in ("data_fetch", "data_lease")}
    want_steps = (DATA_EPOCHS * coord.num_ranges - 1) * \
        (DATA_RANGE // DATA_B)
    info = {
        "wall_s": wall, "cursor": cursor, "num_ranges": coord.num_ranges,
        "releases": releases, "stale_acks": stale, "steps": len(losses),
        "expected_steps": want_steps, "commits": trainer.num_updates,
        "snapshot_step": last, "snapshot_cursor": snap_cursor,
        "samples_per_s": clock.steady_rate(samples),
        # the same windows with the longest pause between two commits
        # (the epoch tail's wait for the dead worker's lease) taken out
        "samples_per_s_busy": samples * (len(marks) - 1)
        / (marks[-1] - marks[0] - max(gaps)),
        "staged_k2_samples_per_s": staged_rate,
        "rtt_p50_s": rtt, "longest_hold_s": holds,
        "lease_s": DATA_LEASE_S, "first_loss": losses[0],
        "last_window_loss": float(np.mean(losses[-DATA_WINDOW:])),
        "card": power_line}
    log(f"[data] (a) ADAG(resnet50_nf()) host_async K={DATA_K} from a data "
        f"service ({DATA_ROWS} rows, ranges of {DATA_RANGE}, "
        f"{DATA_EPOCHS} epochs, batch {DATA_B}, window {DATA_WINDOW}) with "
        f"worker 99 dead holding 2 ranges: cursor {cursor}, re-leases "
        f"{releases:.0f}, stale acks {stale:.0f}, steps {len(losses)} "
        f"(expected {want_steps}), snapshot {last} cursor {snap_cursor}; "
        f"{info['samples_per_s']:.1f} samples/s over the steady windows "
        f"({info['samples_per_s_busy']:.1f} without the longest pause, "
        f"{max(gaps):.2f} s; phase 27 (a) staged K=2 at window "
        f"{ASYNC_WINDOW}: {staged_rate:.1f}); median round trip fetch "
        f"{rtt['data_fetch'] * 1e3:.1f} ms, lease "
        f"{rtt['data_lease'] * 1e3:.2f} ms; longest interval between a "
        f"live worker's lease calls {max(holds.values()):.2f} s against "
        f"the {DATA_LEASE_S:.0f} s lease; loss {info['first_loss']:.4f} -> "
        f"{info['last_window_loss']:.4f}; {wall:.1f} s [{power_line}]")
    assert cursor == [DATA_EPOCHS, coord.num_ranges], info
    assert releases == 2 and stale == 0, info
    assert len(losses) == want_steps, info
    assert snap_cursor == cursor, info
    assert all(math.isfinite(x) for x in losses), losses
    del trainer, ds
    torch.cuda.empty_cache()
    return info


def _write_shards(directory) -> dict:
    """``DATA_ROWS // DATA_RANGE`` seeded ``.npy`` shard pairs."""
    paths = {"features": [], "label": []}
    for i in range(DATA_ROWS // DATA_RANGE):
        part = _learnable_images(DATA_RANGE, seed=50 + i)
        for col in paths:
            path = os.path.join(directory, f"{col}{i}.npy")
            np.save(path, np.asarray(part[col]))
            paths[col].append(path)
    return paths


def _data_shards(dev, power_line) -> dict:
    """(b) A ``GlobalShards`` pool under ``data_layout="host_sharded"``,
    sync and host_async, each pool's ``epoch_dataset`` recorded."""
    import tempfile

    from distkeras_tpu_torch.data import GlobalShards

    out = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        paths = _write_shards(d)
        for mode in ("sync", "host_async"):
            pool = GlobalShards(paths, seed=43)
            seen = []
            orig = pool.epoch_dataset

            def recording(epoch, *a, _orig=orig, _seen=seen, **kw):
                view = _orig(epoch, *a, **kw)
                _seen.append((epoch, np.asarray(view["label"][
                    ::DATA_RANGE]).argmax(-1).tolist()))
                return view

            pool.epoch_dataset = recording
            trainer = _data_trainer(mode, dev, num_epoch=DATA_EPOCHS,
                                    data_layout="host_sharded")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(pool)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses = [h["loss"] for h in trainer.get_history()]
            orders = {}
            for e, first_labels in seen:
                orders.setdefault(e, first_labels)
            info = {"wall_s": wall,
                    "samples_per_s": DATA_EPOCHS * DATA_ROWS / wall,
                    "resolved_epochs": [e for e, _ in seen],
                    "shard_first_labels": orders,
                    "commits": trainer.num_updates, "steps": len(losses),
                    "first_loss": losses[0], "last_loss": losses[-1],
                    "card": power_line}
            log(f"[data] (b) ADAG(resnet50_nf()) {mode} K={DATA_K} over "
                f"GlobalShards ({DATA_ROWS // DATA_RANGE} files of "
                f"{DATA_RANGE} rows, host_sharded, {DATA_EPOCHS} epochs): "
                f"epoch_dataset resolved for epochs "
                f"{info['resolved_epochs']}, first label of each shard by "
                f"epoch {orders}; {info['samples_per_s']:.1f} samples/s "
                f"({wall:.1f} s, staging included), commits "
                f"{trainer.num_updates}, loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f} [{power_line}]")
            assert set(range(DATA_EPOCHS)) <= set(info["resolved_epochs"]), \
                info
            assert orders[0] != orders[1], info  # re-dealt between epochs
            if mode == "host_async":
                assert trainer.num_updates == DATA_EPOCHS * DATA_K * \
                    DATA_ROWS // (DATA_K * DATA_RANGE), info
            assert all(math.isfinite(x) for x in losses), losses
            out[mode] = info
            del trainer
            torch.cuda.empty_cache()
    return out


def _data_retries(dev, power_line) -> dict:
    """(c) ``run_with_retries`` on the card: a crash after epoch 0's
    checkpoint, then a resume, against a clean run (TF32 off)."""
    import tempfile

    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models.mlp import MLP, init_params
    from distkeras_tpu_torch.utils.fault import run_with_retries

    class Crashing(dk.SingleTrainer):
        crashes = 0

        def train(self, dataset, shuffle=False, resume=False):
            if not resume and not self.crashes:
                epochs, self.num_epoch = self.num_epoch, 1
                super().train(dataset, shuffle=shuffle)
                self.num_epoch = epochs
                self.crashes += 1
                raise RuntimeError("injected failure after epoch 0")
            return super().train(dataset, shuffle=shuffle, resume=resume)

    def model():
        return init_params(MLP(), torch.Generator().manual_seed(44))

    set_tf32(False)
    ds = dk.synthetic_mnist(n=RETRY_N, seed=45)
    kw = dict(worker_optimizer="sgd", learning_rate=0.05,
              batch_size=RETRY_B, num_epoch=RETRY_EPOCHS, seed=5,
              device=dev)
    clean = dk.SingleTrainer(model(), **kw).train(ds)
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        crashy = Crashing(model(), checkpoint_dir=d, **kw)
        retried = run_with_retries(crashy, ds, max_restarts=2,
                                   backoff_s=0.0)
    worst = max(float(((retried[n] - want).abs()
                       / (1e-7 + 1e-6 * want.abs())).max())
                for n, want in clean.items())
    bitwise = all(torch.equal(retried[n], want) for n, want in clean.items())
    info = {"crashes": crashy.crashes, "worst_ratio_to_bound": worst,
            "bitwise": bitwise, "card": power_line}
    log(f"[data] (c) run_with_retries: MLP on {dev}, {RETRY_EPOCHS} epochs "
        f"of {RETRY_N} rows at batch {RETRY_B}, {crashy.crashes} crash after "
        f"epoch 0's checkpoint, resumed: parameters against the clean run "
        f"at {worst:.3g} of the rtol 1e-6 / atol 1e-7 bound (bitwise "
        f"{bitwise}) [{power_line}]")
    assert crashy.crashes == 1, info
    for n, want in clean.items():
        torch.testing.assert_close(retried[n], want, rtol=1e-6, atol=1e-7)
    return info


def phase_data(dev, power_line, staged_rate) -> dict:
    """Phase 31: the one-process data plane on the card (module
    docstring)."""
    t0 = time.perf_counter()
    out = {"stream": _data_stream(dev, power_line, staged_rate),
           "shards": _data_shards(dev, power_line),
           "retries": _data_retries(dev, power_line)}
    out["phase_s"] = time.perf_counter() - t0
    log(f"[data] phase 31 in {out['phase_s']:.1f} s [{power_line}]")
    return out


# -- phase 32: the multi-process plane ----------------------------------------

#: each rank's hard limit (s): a rank that hangs fails the phase
MP_CHILD_TIMEOUT_S = 600
#: (c)'s epochs (the spread fleet) and (e)'s scored rows (two halves)
MP_SPREAD_EPOCHS, MP_EVAL_ROWS = 1, 512
#: (a)'s fold bound against the one-process K = 2 run when not bitwise:
#: the CPU test's (tests/test_torch_multiprocess.py), rtol / atol
MP_FOLD_RTOL, MP_FOLD_ATOL = 1e-5, 1e-6


def _digest(params, *extra) -> str:
    """sha256 of a name -> tensor dict's bytes (names sorted) and of
    ``extra`` (JSON): equal digests, equal bits."""
    import hashlib

    h = hashlib.sha256()
    for n in sorted(params):
        h.update(n.encode())
        h.update(np.ascontiguousarray(
            torch.as_tensor(params[n]).detach().cpu().numpy()).tobytes())
    h.update(json.dumps(extra).encode())
    return h.hexdigest()


def _scoring_model(center):
    """(e)'s model: ``resnet50_nf()`` holding (a)'s trained center."""
    model = _nf_model(seed=40)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(center[n])
    return model


def _mp_adag(dev, **kw):
    """``bench.py``'s ``ADAG(resnet50_nf())`` at phase 31's widths; in a
    two-process group the default mesh is one worker a process."""
    import distkeras_tpu_torch as dk

    return dk.ADAG(_nf_model(seed=40), worker_optimizer="sgd",
                   learning_rate=0.05, batch_size=DATA_B,
                   communication_window=DATA_WINDOW, metrics=(),
                   device=dev, **kw)


def _mp_child(rank: int, port: str, work: str) -> int:
    """One rank of phase 32 (``chip_smoke.py --mp-child RANK PORT DIR``):
    (a)-(e) in order on ``cuda:0``, the results written to
    ``DIR/rank{RANK}.json``."""
    from distkeras_tpu_torch.data import GlobalShards
    from distkeras_tpu_torch.evaluators import (AccuracyEvaluator,
                                                LossEvaluator)
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import (collectives, distributed,
                                              host_async, strategies)
    from distkeras_tpu_torch.predictors import ModelPredictor

    dev = torch.device("cuda:0")
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank,
                           local_device_ids=[0], timeout_s=300)
    _, backend = distributed.fold_group(dev)
    with open(os.path.join(work, "paths.json")) as f:
        paths = json.load(f)
    out = {"rank": rank, "fold_backend": backend}

    def timed_run(trainer, **kw):
        distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = trainer.train(GlobalShards(paths, seed=43), **kw)
        torch.cuda.synchronize()
        return params, time.perf_counter() - t0

    # (a) the sync fold, each round's fold timed
    fold_s = []
    cross = collectives.cross_process_sum

    def timed_fold(tree, bucket_bytes=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cross(tree, bucket_bytes)
        torch.cuda.synchronize()
        fold_s.append(time.perf_counter() - t0)
        return got

    collectives.cross_process_sum = timed_fold
    try:
        trainer = _mp_adag(dev, num_epoch=DATA_EPOCHS,
                           data_layout="host_sharded")
        params, wall = timed_run(trainer)
    finally:
        collectives.cross_process_sum = cross
    losses = [h["loss"] for h in trainer.history]
    out["sync"] = {
        "wall_s": wall, "samples_per_s": DATA_EPOCHS * DATA_ROWS / wall,
        "fold_s_median": statistics.median(fold_s), "folds": len(fold_s),
        "owners": trainer.mesh.owners, "steps": len(losses),
        "commits": trainer.num_updates, "first_loss": losses[0],
        "last_loss": losses[-1], "digest": _digest(params, losses)}
    center = {n: t.cpu() for n, t in params.items()}
    if rank == 0:
        torch.save(center, os.path.join(work, "sync_center.pt"))
    del trainer, params
    torch.cuda.empty_cache()

    # (b) the live center on process 0, (c) a spread two-shard fleet
    for key, epochs, kw in (
            ("async", DATA_EPOCHS, {}),
            ("spread", MP_SPREAD_EPOCHS,
             dict(ps_shards=2, ps_placement="spread"))):
        trainer = _mp_adag(dev, mode="host_async", num_workers=DATA_K,
                           num_epoch=epochs, data_layout="host_sharded",
                           **kw)
        params, wall = timed_run(trainer)
        losses = [h["loss"] for h in trainer.history]
        out[key] = {
            "wall_s": wall, "samples_per_s": epochs * DATA_ROWS / wall,
            "commits": trainer.num_updates, "steps": len(losses),
            "staleness_sum": float(sum(trainer.staleness_history)),
            "first_loss": losses[0], "last_loss": losses[-1],
            "finite": all(math.isfinite(x) for x in losses),
            "digest": _digest(params, losses, trainer.staleness_history,
                              trainer.num_updates)}
        del trainer, params
        torch.cuda.empty_cache()

    # (d) process 0's service cannot bind its port
    import socket

    runner = host_async.HostAsyncRunner(
        _nf_model(seed=40), "categorical_crossentropy",
        optimizers.get("sgd", 0.05),
        strategies.get("adag", learning_rate=0.05), DATA_WINDOW,
        device=dev)
    blocker, port0 = None, 0
    if rank == 0:
        blocker = socket.socket()
        blocker.bind(("0.0.0.0", 0))
        blocker.listen(1)
        port0 = blocker.getsockname()[1]
    distributed.barrier()
    t0 = time.perf_counter()
    raised = None
    try:
        host_async.run_cross_process(
            runner, {n: p.detach() for n, p in
                     runner.model.named_parameters()}, [[[]]],
            worker_offset=rank, service_port=port0)
    except (RuntimeError, OSError) as e:
        raised = type(e).__name__
    finally:
        if blocker is not None:
            blocker.close()
    out["failed_start"] = {"raised": raised,
                           "seconds": time.perf_counter() - t0}
    del runner

    # (e) host-sharded scoring, across_processes evaluators
    ds = _learnable_images(MP_EVAL_ROWS, seed=60)
    half = MP_EVAL_ROWS // 2
    mine = ds.__class__({c: np.asarray(ds[c])[rank * half:(rank + 1) * half]
                         for c in ds.columns})
    scored = ModelPredictor(_scoring_model(center), batch_size=DATA_B,
                            device=dev).predict(mine)
    np.save(os.path.join(work, f"pred{rank}.npy"),
            np.asarray(scored["prediction"]))
    out["eval"] = {
        "accuracy": AccuracyEvaluator(across_processes=True).evaluate(
            scored),
        "loss": LossEvaluator(across_processes=True).evaluate(scored),
        "local_accuracy": AccuracyEvaluator().evaluate(scored)}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_multiprocess(dev, power_line, async_k2_rate) -> dict:
    """Phase 32: the multi-process plane, two ranks of this script on
    ``cuda:0`` (module docstring)."""
    import socket
    import tempfile

    from distkeras_tpu_torch.data import GlobalShards
    from distkeras_tpu_torch.evaluators import (AccuracyEvaluator,
                                                LossEvaluator)
    from distkeras_tpu_torch.predictors import ModelPredictor

    t_phase = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as work:
        paths = _write_shards(work)
        with open(os.path.join(work, "paths.json"), "w") as f:
            json.dump(paths, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-child",
             str(r), port, work], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=HERE)
            for r in (0, 1)]
        try:
            outs = [p.communicate(timeout=MP_CHILD_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            for line in text.strip().splitlines()[-12:]:
                log(f"[multiprocess] rank {r}: {line}")
            assert p.returncode == 0, f"rank {r} exited {p.returncode}"
        ranks = []
        for r in (0, 1):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        got = torch.load(os.path.join(work, "sync_center.pt"))
        preds = [np.load(os.path.join(work, f"pred{r}.npy"))
                 for r in (0, 1)]
        a, b = ranks
        # the one-process K = 2 run on the same seeds (two stacked
        # replicas, the same pool seen by one process)
        set_tf32(False)
        prev = (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            ref_trainer = _data_trainer("sync", dev, num_epoch=DATA_EPOCHS,
                                        data_layout="host_sharded")
            ref = ref_trainer.train(GlobalShards(paths, seed=43))
            ref_losses = [h["loss"] for h in ref_trainer.history]
            del ref_trainer
            ds = _learnable_images(MP_EVAL_ROWS, seed=60)
            scored = ModelPredictor(_scoring_model(got), batch_size=DATA_B,
                                    device=dev).predict(ds)
            ref_pred = np.asarray(scored["prediction"])
            ref_acc = AccuracyEvaluator().evaluate(scored)
            ref_loss = LossEvaluator().evaluate(scored)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = prev
    bitwise = all(torch.equal(got[n], ref[n].cpu()) for n in ref)
    worst = max(float(((got[n] - ref[n].cpu()).abs()
                       / (MP_FOLD_ATOL + MP_FOLD_RTOL
                          * ref[n].cpu().abs())).max()) for n in ref)
    pred_err = float(np.max(np.abs(np.concatenate(preds) - ref_pred)))
    info = {
        "fold_backend": a["fold_backend"],
        "peak_bytes": [a["peak_bytes"], b["peak_bytes"]],
        "sync": {**a["sync"], "bitwise_one_process": bitwise,
                 "worst_ratio_to_bound": worst,
                 "one_process_last_loss": ref_losses[-1]},
        "async": a["async"], "spread": a["spread"],
        "failed_start": [a["failed_start"], b["failed_start"]],
        "eval": {**a["eval"], "one_process_accuracy": ref_acc,
                 "one_process_loss": ref_loss,
                 "max_abs_pred_err": pred_err},
        "async_k2_staged_samples_per_s": async_k2_rate,
        "card": power_line}
    log(f"[multiprocess] fold backend {a['fold_backend']} (two ranks on "
        f"one card); peak memory rank 0 {a['peak_bytes'] / 2**30:.2f} GiB, "
        f"rank 1 {b['peak_bytes'] / 2**30:.2f} GiB [{power_line}]")
    log(f"[multiprocess] (a) ADAG(resnet50_nf()) sync over 2 processes "
        f"(one worker each, owners {a['sync']['owners']}), GlobalShards "
        f"host_sharded, {DATA_EPOCHS} epochs, b={DATA_B}, window "
        f"{DATA_WINDOW}: {a['sync']['samples_per_s']:.1f} samples/s, "
        f"the fold {a['sync']['fold_s_median'] * 1e3:.1f} ms a round "
        f"(median of {a['sync']['folds']}), ranks equal "
        f"{a['sync']['digest'] == b['sync']['digest']}, center against "
        f"the one-process K=2 run: bitwise {bitwise}, {worst:.3g} of the "
        f"rtol {MP_FOLD_RTOL} / atol {MP_FOLD_ATOL} bound; loss "
        f"{a['sync']['first_loss']:.4f} -> {a['sync']['last_loss']:.4f} "
        f"[{power_line}]")
    log(f"[multiprocess] (b) host_async over 2 processes, process 0's "
        f"live center: {a['async']['samples_per_s']:.1f} samples/s (phase "
        f"27 (a) one-process K=2 at window {ASYNC_WINDOW}: "
        f"{async_k2_rate:.1f}), {a['async']['commits']} commits, "
        f"staleness sum {a['async']['staleness_sum']:.0f}, ranks equal "
        f"{a['async']['digest'] == b['async']['digest']} [{power_line}]")
    log(f"[multiprocess] (c) spread two-shard fleet: "
        f"{a['spread']['samples_per_s']:.1f} samples/s, "
        f"{a['spread']['commits']} commits, ranks equal "
        f"{a['spread']['digest'] == b['spread']['digest']}; (d) process "
        f"0's service failed to start ({a['failed_start']['raised']}), "
        f"rank 1 raised {b['failed_start']['raised']} after "
        f"{b['failed_start']['seconds'] * 1e3:.1f} ms; (e) across_processes"
        f" accuracy {a['eval']['accuracy']:.6f} (one process "
        f"{ref_acc:.6f}), loss {a['eval']['loss']:.6f} (one process "
        f"{ref_loss:.6f}), predictions {pred_err:.3g} max abs from one "
        f"process's [{power_line}]")
    assert a["fold_backend"] == b["fold_backend"] == "gloo", info
    assert a["sync"]["digest"] == b["sync"]["digest"], info
    assert a["sync"]["owners"] == [0, 1], info
    assert bitwise or worst <= 1.0, info
    assert a["sync"]["steps"] == len(ref_losses), info
    for key, epochs in (("async", DATA_EPOCHS), ("spread", MP_SPREAD_EPOCHS)):
        assert a[key]["digest"] == b[key]["digest"], info
        assert a[key]["commits"] == epochs * DATA_ROWS // (
            DATA_B * DATA_WINDOW), info
        assert a[key]["finite"], info
    assert a["async"]["staleness_sum"] > 0, info
    assert b["failed_start"]["raised"] == "RuntimeError", info
    assert b["failed_start"]["seconds"] < 5.0, info
    assert a["eval"]["accuracy"] == b["eval"]["accuracy"] == ref_acc, info
    assert abs(a["eval"]["loss"] - ref_loss) <= 1e-5 * abs(ref_loss), info
    assert a["eval"]["loss"] == b["eval"]["loss"], info
    assert pred_err <= 1e-5 * float(np.max(np.abs(ref_pred))), info
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[multiprocess] phase 32 in {info['phase_s']:.1f} s "
        f"[{power_line}]")
    return info


# -- phase 33 ----------------------------------------------------------------

#: the lint gate's corpus floor (tests/test_torch_lint_clean.py)
LINT_MIN_FILES = 150
#: every rule of the port's dktlint (``--list-rules``)
LINT_RULES = ("lock-blocking-call", "lock-order-cycle", "wire-unhandled-op",
              "wire-unreferenced-op", "wire-error-kind-drift",
              "telemetry-undeclared-name", "telemetry-kind-mismatch",
              "telemetry-unknown-consumer-name", "precision-f32-pin",
              "layer-forbidden-import")
#: runs the CLI's main in a child, then names the framework modules that
#: the run loaded (the suite reads source: it needs neither torch nor JAX)
_LINT_WRAPPER = (
    "import json, sys\n"
    "from distkeras_tpu_torch.analysis.__main__ import main\n"
    "rc = main(['--root', sys.argv[1], '--format', 'json'])\n"
    "loaded = sorted(m for m in sys.modules if m.split('.')[0] in\n"
    "                ('torch', 'jax', 'flax', 'distkeras_tpu'))\n"
    "print(json.dumps({'rc': rc, 'loaded': loaded}))\n")


def _lint_child(*args) -> tuple:
    """One child interpreter from the checkout's root, which must exit 0
    (dktlint's code for no finding): (stdout, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=HERE, timeout=300)
    assert proc.returncode == 0, (args, proc.returncode,
                                  proc.stdout[-4000:], proc.stderr[-4000:])
    return proc.stdout, time.perf_counter() - t0


def phase_lint(power_line) -> dict:
    """Phase 33: the port's dktlint over this checkout (module
    docstring)."""
    t_phase = time.perf_counter()
    out, _ = _lint_child("-m", "distkeras_tpu_torch.analysis",
                         "--list-rules")
    rules = sorted(ln.split(": ", 1)[1] for ln in out.splitlines()
                   if ln.strip() and not ln.startswith("#"))
    assert rules == sorted(LINT_RULES), rules
    out, lint_s = _lint_child("-m", "distkeras_tpu_torch.analysis",
                              "--root", HERE, "--format", "json")
    report = json.loads(out)
    assert report["findings"] == [], report
    assert report["baselined"] == 0, report
    assert report["checked_files"] >= LINT_MIN_FILES, report
    out, wrapped_s = _lint_child("-c", _LINT_WRAPPER, HERE)
    head, _, tail = out.rpartition("\n{")
    child = json.loads("{" + tail)
    assert child == {"rc": 0, "loaded": []}, child
    assert json.loads(head) == report
    info = {"files": report["checked_files"],
            "findings": len(report["findings"]),
            "suppressed": report["suppressed"], "rules": rules,
            "lint_s": lint_s, "wrapped_s": wrapped_s, "card": power_line,
            "phase_s": time.perf_counter() - t_phase}
    log(f"[lint] phase 33: {info['files']} files, {info['findings']} "
        f"findings, {info['suppressed']} suppressed, {lint_s:.2f} s "
        f"(no torch/jax loaded: {wrapped_s:.2f} s) [{power_line}]")
    return info


# -- phase 34: the model, sequence and pipeline axes over processes -----------

#: each rank's hard limit (s): a rank that hangs fails the phase
AX_CHILD_TIMEOUT_S = 600
#: (a)'s bound against phase 29 (b)'s one-process losses when not
#: bitwise, rtol / atol
AX_RTOL, AX_ATOL = 1e-5, 1e-6
#: (c)'s adamw steps a layout (phase 30 (a) runs SP_STEPS)
AX_SP_STEPS = 2


class _Moves:
    """Seconds spent in the cross-process moves (the shard all-gather,
    the folds, the hops' sends and receives, the batch gather),
    counted by wrapping them."""

    def __init__(self):
        from distkeras_tpu_torch.parallel import collectives, distributed

        self.seconds, self.calls = 0.0, 0
        for mod, name in ((collectives, "all_gather_flat"),
                          (collectives, "cross_process_sum"),
                          (collectives, "_exchange"),
                          (distributed, "process_allgather"),
                          (distributed, "broadcast_one_to_all")):
            setattr(mod, name, self._timed(getattr(mod, name)))

    def _timed(self, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return run

    def reset(self) -> None:
        self.seconds, self.calls = 0.0, 0


def _ax_warmup(dev) -> float:
    """This rank's first CUDA work, before any timed run: the context,
    cuBLAS, cuDNN and each kernel library's load and first launch, on
    small inputs (each path zeroes its launch counts before it runs).
    Returns the seconds it took."""
    from torch.nn import functional as F

    from distkeras_tpu_torch import precision as precision_lib
    from distkeras_tpu_torch.ops.attention import apply_attention
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen).to(dev, dtype) \
            .requires_grad_()

    precision_lib.scaled_int8_matmul(
        rand(64, 768), rand(256, 768, dtype=torch.float32)).float() \
        .sum().backward()
    q = rand(2, 128, 12, 64)
    apply_attention(q, q, q, causal=False, attention="flash").float() \
        .sum().backward()
    x = rand(2, 784, 128)
    gn.group_norm(x, torch.ones(128, device=dev, requires_grad=True),
                  torch.zeros(128, device=dev, requires_grad=True),
                  GN_GROUPS).float().sum().backward()
    F.conv2d(rand(2, 64, 28, 28).contiguous(
        memory_format=torch.channels_last), rand(64, 64, 3, 3),
        padding=1).float().sum().backward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _ax_run(dev, moves, run) -> dict:
    """``run()`` timed from a barrier to a sync, with the moves' seconds
    and the peak memory over it (this rank's)."""
    from distkeras_tpu_torch.parallel import distributed

    distributed.barrier()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    moves.reset()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0, move_s=moves.seconds,
               moves=moves.calls,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    return out


def _held_bytes(trainer) -> dict:
    """This rank's bytes at rest of a PjitTrainer's state: parameters
    (its shards and the replicated tensors) and optimizer state."""
    from distkeras_tpu_torch import precision as precision_lib
    from distkeras_tpu_torch.parallel import tensor

    opt = trainer.state.opt_state
    inner = opt.inner if isinstance(
        opt, precision_lib.OverflowGuardState) else opt
    out = {"params": 0, "opt": 0, "sharded_held": 0, "sharded_whole": 0}
    for p in trainer.state.params.values():
        parts = p.shards if isinstance(p, tensor.Sharded) else [p]
        out["params"] += sum(t.nbytes for t in parts)
        out["opt"] += sum(v.nbytes for t in parts
                          for v in inner.state.get(t, {}).values()
                          if torch.is_tensor(v))
        if isinstance(p, tensor.Sharded):
            out["sharded_held"] += sum(t.nbytes for t in parts)
            out["sharded_whole"] += math.prod(p.shape) * \
                parts[0].element_size()
    return out


def _ax_pjit(dev, moves, layouts, build, kernels, **kw) -> dict:
    """(a)/(b): one PjitTrainer epoch a layout (``layouts``: name ->
    this process's devices and the model axis, or the workers and model
    sizes) on ``build()``'s (model, dataset)."""
    from distkeras_tpu_torch.parallel import distributed

    out = {}
    for name, (workers, model_size, devices) in layouts.items():
        mesh = distributed.multihost_mesh(
            num_workers=workers, model_parallelism=model_size,
            devices=devices)
        model, ds, loss = build()

        def run():
            info, trainer = _pjit_run(dev, model, ds, mesh, loss, kernels,
                                      **kw)
            info["held"] = _held_bytes(trainer)
            info["digest"] = _digest(trainer.params, info["losses"])
            info["owners"] = mesh.device_owners
            return info

        out[name] = _ax_run(dev, moves, run)
        del model, ds
        torch.cuda.empty_cache()
    return out


def _axes_child(rank: int, port: str, work: str) -> int:
    """One rank of phase 34 (``chip_smoke.py --axes-child RANK PORT
    DIR``): (a)-(d) in order on ``cuda:0``, the results written to
    ``DIR/rank{RANK}.json``."""
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.models.moe import ep_partition_rules
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8
    from distkeras_tpu_torch.parallel import distributed, pipeline

    dev = torch.device("cuda:0")
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank,
                           local_device_ids=[0], timeout_s=300)
    _, backend = distributed.fold_group(dev)
    moves = _Moves()
    out = {"rank": rank, "fold_backend": backend,
           "warmup_s": _ax_warmup(dev)}
    layouts = {"rows": (2, 2, [dev] * 2), "span": (1, 2, [dev])}

    # (a) config 4's BERT-base rows, re-stamped to int8 (phase 29 (b))
    rows = [_bert_batch(30592, seed=40 + i) for i in range(PJIT_STEPS)]
    bert_ds = Dataset.from_arrays(
        features=np.concatenate([r["features"] for r in rows]),
        label=np.concatenate([r["labels"] for r in rows]))
    out["int8"] = _ax_pjit(
        dev, moves, layouts, lambda: (_enc_model("bert"), bert_ds,
                                      "masked_lm"),
        (i8.int8_matmul_dequant,), precision="int8",
        worker_optimizer="adam", learning_rate=1e-4, batch_size=PJIT_B)

    # (b) phase 28 (d)'s MoE under the EP rules (phase 29 (c)'s rows)
    rng = np.random.default_rng(6)
    n = PJIT_MOE_B * PJIT_STEPS
    x = rng.standard_normal((n,) + MOE_SHAPE[1:]).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    moe_ds = Dataset.from_arrays(features=x, label=y)
    flash = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv)
    out["moe"] = _ax_pjit(
        dev, moves, {"rows": layouts["rows"]},
        lambda: (_enc_model("moe", attention="flash"), moe_ds,
                 "categorical_crossentropy"), flash,
        partition_rules=ep_partition_rules(), worker_optimizer="adam",
        learning_rate=1e-4, batch_size=PJIT_MOE_B)
    del bert_ds, moe_ds

    # (c) gpt_small(attention="ring") bf16 on phase 30's weights and batch
    start = init_params(gpt_small(), torch.Generator().manual_seed(39)) \
        .state_dict()
    batch = _sp_batch(SP_B, SP_T, seed=40)
    out["ring"] = {}
    for name, (workers, seq, devices) in layouts.items():
        ring = gpt_small(attention="ring")
        ring.load_state_dict(start)
        ring.to(dev)

        def run():
            losses, times, _ = _sp_steps(
                dev, ring, (workers, seq), batch,
                optimizers.get("adamw", 1e-3), AX_SP_STEPS, devices=devices)
            return {"losses": losses, "step_s": times,
                    "param_bytes": sum(p.nbytes for p in ring.parameters())}

        out["ring"][name] = _ax_run(dev, moves, run)
        del ring
        torch.cuda.empty_cache()
    del start

    # (d) phase 30 (d)'s PipelinedLM and (e)'s GenericPipeline(resnet50()),
    # stages split over the two ranks
    def pipelined_lm():
        model = pipeline.PipelinedLM(**PP_LM, num_stages=PP_STAGES,
                                     dtype=torch.bfloat16,
                                     device=dev).init(43)
        mesh = pipeline.make_pp_mesh(PP_STAGES, devices=[dev] * 2)
        lm_batch = _sp_batch(PP_B, PP_T, seed=44)
        step_fn, place_params, place_batch = model.build_train_step(
            optimizers.get("sgd", SP_SGD_LR), mesh, PP_M)
        _, ms = step_fn(place_params(), place_batch(lm_batch))
        info = {"loss": float(ms["loss"]), "owners": mesh.device_owners}
        step_fn, place_params, _ = model.build_train_step(
            optimizers.get("adamw", 1e-3), mesh, PP_M)
        state, placed = place_params(), place_batch(lm_batch)
        losses, times = [], []
        for _ in range(PP_STEPS):
            t0 = time.perf_counter()
            state, ms = step_fn(state, placed)
            losses.append(float(ms["loss"]))
            times.append(time.perf_counter() - t0)
        info.update(losses=losses, step_s=times, param_bytes=sum(
            p.nbytes for p in model.parameters() if not p.is_meta))
        return info

    out["pipelined_lm"] = _ax_run(dev, moves, pipelined_lm)
    torch.cuda.empty_cache()

    def generic():
        model = _resnet_model("gn", torch.bfloat16, seed=45)
        parts = _resnet_pipeline_stages(model)
        pipe = pipeline.GenericPipeline(parts, num_microbatches=GP_M,
                                        dtype=torch.bfloat16, device=dev)
        rng = np.random.default_rng(46)
        feats = rng.standard_normal((GP_B, GP_SIDE, GP_SIDE, 3)).astype(
            np.float32)
        labels = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, GP_B)]
        pipe.init(feats[:GP_B // GP_M])
        mesh = pipeline.make_pp_mesh(len(parts), devices=[dev] * 3)
        step_fn, place_params, place_batch = pipe.build_train_step(
            optimizers.get("adamw", 1e-3), mesh)
        state = place_params()
        placed = place_batch({"features": feats, "labels": labels})
        kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
        distributed.barrier()
        torch.cuda.synchronize()
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        _, ms = step_fn(state, placed)
        loss = float(ms["loss"])
        return {"loss": loss, "step_s": time.perf_counter() - t0,
                "launches": {k.__name__: k.launches for k in kernels},
                "owners": mesh.device_owners,
                "param_bytes": sum(p.nbytes for p in pipe.stages.parameters()
                                   if not p.is_meta)}

    out["generic"] = _ax_run(dev, moves, generic)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_axes(dev, power_line, report) -> dict:
    """Phase 34: the model, sequence and pipeline axes over processes,
    two ranks of this script on ``cuda:0`` (module docstring), against
    phases 29 and 30's one-process runs in ``report``."""
    import socket
    import tempfile

    t_phase = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as work:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--axes-child",
             str(r), port, work], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=HERE)
            for r in (0, 1)]
        try:
            outs = [p.communicate(timeout=AX_CHILD_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            for line in text.strip().splitlines()[-12:]:
                log(f"[axes] rank {r}: {line}")
            assert p.returncode == 0, f"rank {r} exited {p.returncode}"
        ranks = []
        for r in (0, 1):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    a, b = ranks
    pjit, seq = report["pjit"], report["seqpipe"]
    one_int8 = pjit["int8"]["model2"]["losses"]
    one_moe = pjit["moe"]["w2m2"]["losses"]

    def close(got, want) -> bool:
        return all(abs(u - v) <= AX_ATOL + AX_RTOL * abs(v)
                   for u, v in zip(got, want)) and len(got) == len(want)

    def launches(part, layout=None):
        runs = [r[part] if layout is None else r[part][layout]
                for r in ranks]
        return {k: sum(run["launches"][k] for run in runs)
                for k in runs[0]["launches"]}

    info = {"fold_backend": a["fold_backend"], "card": power_line,
            "ranks": ranks, "time_sliced": "two ranks share one card"}
    log(f"[axes] two ranks on one card over {a['fold_backend']}: their "
        f"rates time-slice one card, not two cards'; each rank's first "
        f"CUDA work (warm-up, untimed) {a['warmup_s']:.1f} / "
        f"{b['warmup_s']:.1f} s [{power_line}]")
    for name in ("rows", "span"):
        ra, rb = a["int8"][name], b["int8"][name]
        steps = len(ra["losses"])
        info[f"int8_{name}"] = {
            "bitwise_one_process": ra["losses"] == one_int8,
            "close_one_process": close(ra["losses"], one_int8),
            "samples_per_s": steps * PJIT_B / ra["wall_s"],
            "tokens_per_s": steps * PJIT_B * ENC_T / ra["wall_s"],
            "ms_a_step": 1e3 * ra["wall_s"] / steps,
            "launches": launches("int8", name)}
        log(f"[axes] (a) bert-base int8 PjitTrainer {name} "
            f"{ra['owners']}: losses "
            f"{', '.join(f'{x:.6f}' for x in ra['losses'])} (phase 29 (b) "
            f"{', '.join(f'{x:.6f}' for x in one_int8)}: bitwise "
            f"{info[f'int8_{name}']['bitwise_one_process']}), ranks equal "
            f"{ra['digest'] == rb['digest']}; "
            f"{info[f'int8_{name}']['samples_per_s']:.1f} samples/s, "
            f"{info[f'int8_{name}']['tokens_per_s']:.0f} tokens/s, "
            f"{info[f'int8_{name}']['ms_a_step']:.1f} ms a step, moves "
            f"{ra['move_s']:.3f} / {rb['move_s']:.3f} s; at rest params "
            f"{ra['held']['params'] / 2**20:.1f} / "
            f"{rb['held']['params'] / 2**20:.1f} MiB, optimizer "
            f"{ra['held']['opt'] / 2**20:.1f} / "
            f"{rb['held']['opt'] / 2**20:.1f} MiB, sharded "
            f"{ra['held']['sharded_held'] / 2**20:.1f} of "
            f"{ra['held']['sharded_whole'] / 2**20:.1f} MiB; peak "
            f"{ra['peak_bytes'] / 2**30:.2f} / {rb['peak_bytes'] / 2**30:.2f}"
            f" GiB; int8 launches {info[f'int8_{name}']['launches']} "
            f"[{power_line}]")
        assert ra["digest"] == rb["digest"], info
        assert info[f"int8_{name}"]["close_one_process"], info
        assert all(run["launches"]["int8_matmul_dequant"] == 49 * steps
                   for run in (ra, rb)), info
    span_a, span_b = a["int8"]["span"]["held"], b["int8"]["span"]["held"]
    assert span_a["sharded_whole"] == 2 * span_a["sharded_held"] == \
        2 * span_b["sharded_held"] > 0, info
    assert a["int8"]["rows"]["held"]["sharded_held"] == \
        span_a["sharded_whole"], info
    ma, mb_ = a["moe"]["rows"], b["moe"]["rows"]
    info["moe"] = {"bitwise_one_process": ma["losses"] == one_moe,
                   "launches": launches("moe", "rows"),
                   "samples_per_s": len(ma["losses"]) * PJIT_MOE_B
                   / ma["wall_s"],
                   "ms_a_step": 1e3 * ma["wall_s"] / len(ma["losses"])}
    log(f"[axes] (b) moe classifier flash, EP rules, rows {ma['owners']}: "
        f"losses {', '.join(f'{x:.5f}' for x in ma['losses'])} (phase 29 "
        f"(c) {', '.join(f'{x:.5f}' for x in one_moe)}: bitwise "
        f"{info['moe']['bitwise_one_process']}), ranks equal "
        f"{ma['digest'] == mb_['digest']}, "
        f"{info['moe']['samples_per_s']:.1f} samples/s, "
        f"{info['moe']['ms_a_step']:.1f} ms a step, moves "
        f"{ma['move_s']:.3f} s, peak {ma['peak_bytes'] / 2**30:.2f} / "
        f"{mb_['peak_bytes'] / 2**30:.2f} GiB; flash launches "
        f"{info['moe']['launches']} [{power_line}]")
    assert ma["digest"] == mb_["digest"], info
    assert info["moe"]["bitwise_one_process"], info
    assert all(v == 4 * PJIT_STEPS for run in (ma, mb_)
               for v in run["launches"].values()), info
    full_loss = seq["ring"]["full_loss"]
    for name in ("rows", "span"):
        ra, rb = a["ring"][name], b["ring"][name]
        med = statistics.median(ra["step_s"])
        info[f"ring_{name}"] = {
            "rel_vs_full": _rel(ra["losses"][0], full_loss),
            "rel_vs_phase30": _rel(ra["losses"][0],
                                   seq["ring"]["losses"][0]),
            "tokens_per_s": SP_B * SP_T / med, "ms_a_step": 1e3 * med}
        log(f"[axes] (c) gpt_small ring bf16 {name}, b={SP_B}, T={SP_T}: "
            f"losses {', '.join(f'{x:.5f}' for x in ra['losses'])}, step 1 "
            f"against attention='full' (phase 30 (a)) "
            f"{info[f'ring_{name}']['rel_vs_full']:.3e} (bound "
            f"{SP_FULL_REL}), against phase 30 (a)'s ring "
            f"{info[f'ring_{name}']['rel_vs_phase30']:.3e}; ranks equal "
            f"{ra['losses'] == rb['losses']}; "
            f"{info[f'ring_{name}']['tokens_per_s']:.0f} tokens/s, "
            f"{info[f'ring_{name}']['ms_a_step']:.1f} ms a step (median), "
            f"moves {ra['move_s']:.3f} s over {len(ra['losses'])} steps; "
            f"params {ra['param_bytes'] / 2**20:.1f} MiB a rank; peak "
            f"{ra['peak_bytes'] / 2**30:.2f} / {rb['peak_bytes'] / 2**30:.2f}"
            f" GiB [{power_line}]")
        assert ra["losses"] == rb["losses"], info
        assert all(math.isfinite(x) for x in ra["losses"]), info
        assert info[f"ring_{name}"]["rel_vs_full"] <= SP_FULL_REL, info
    la, lb = a["pipelined_lm"], b["pipelined_lm"]
    want = [seq["pipelined_lm"]["loss"]] + seq["pipelined_lm"]["losses"]
    med = statistics.median(la["step_s"][1:])
    info["pipelined_lm"] = {
        "bitwise_phase30": [la["loss"]] + la["losses"] == want,
        "tokens_per_s": PP_B * PP_T / med, "ms_a_step": 1e3 * med}
    log(f"[axes] (d) PipelinedLM {PP_STAGES} stages {la['owners']}, M="
        f"{PP_M}: sgd step loss {la['loss']:.6f}, adamw "
        f"{', '.join(f'{x:.5f}' for x in la['losses'])} (phase 30 (d) "
        f"{', '.join(f'{x:.5f}' for x in want)}: bitwise "
        f"{info['pipelined_lm']['bitwise_phase30']}), ranks equal "
        f"{[la['loss']] + la['losses'] == [lb['loss']] + lb['losses']}; "
        f"{info['pipelined_lm']['tokens_per_s']:.0f} tokens/s, "
        f"{info['pipelined_lm']['ms_a_step']:.1f} ms a step (median), hops "
        f"{la['move_s']:.3f} / {lb['move_s']:.3f} s over "
        f"{1 + len(la['losses'])} steps; params "
        f"{la['param_bytes'] / 2**20:.1f} / {lb['param_bytes'] / 2**20:.1f}"
        f" MiB; peak {la['peak_bytes'] / 2**30:.2f} / "
        f"{lb['peak_bytes'] / 2**30:.2f} GiB [{power_line}]")
    assert [la["loss"]] + la["losses"] == [lb["loss"]] + lb["losses"], info
    assert info["pipelined_lm"]["bitwise_phase30"], info
    ga, gb = a["generic"], b["generic"]
    info["generic"] = {"bitwise_phase30": ga["loss"] ==
                       seq["generic"]["loss"],
                       "launches": launches("generic"),
                       "samples_per_s": GP_B / ga["step_s"],
                       "ms_a_step": 1e3 * ga["step_s"]}
    log(f"[axes] (d) GenericPipeline(resnet50()) {ga['owners']}, b={GP_B} "
        f"at {GP_SIDE}^2, M={GP_M}: loss {ga['loss']:.6f} (phase 30 (e) "
        f"{seq['generic']['loss']:.6f}: bitwise "
        f"{info['generic']['bitwise_phase30']}), ranks equal "
        f"{ga['loss'] == gb['loss']}; {info['generic']['samples_per_s']:.1f}"
        f" samples/s, {info['generic']['ms_a_step']:.1f} ms a step, hops "
        f"{ga['move_s']:.3f} / {gb['move_s']:.3f} s; params "
        f"{ga['param_bytes'] / 2**20:.1f} / {gb['param_bytes'] / 2**20:.1f}"
        f" MiB; peak {ga['peak_bytes'] / 2**30:.2f} / "
        f"{gb['peak_bytes'] / 2**30:.2f} GiB; GroupNorm launches "
        f"{ga['launches']} + {gb['launches']} = "
        f"{info['generic']['launches']} [{power_line}]")
    assert ga["loss"] == gb["loss"], info
    assert info["generic"]["bitwise_phase30"], info
    assert all(v == 53 * GP_M for v in info["generic"]["launches"].values()), \
        info
    assert a["fold_backend"] == b["fold_backend"] == "gloo", info
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[axes] phase 34 in {info['phase_s']:.1f} s [{power_line}]")
    return info


# -- phase 35: the cards of one host -------------------------------------------

#: (b)/(c): resnet50_nf ADAG rows a step, window and rounds, one worker a
#: card (phase 24 (b)'s batch and window); the bf16 run takes one round
CARDS_B, CARDS_WINDOW, CARDS_ROUNDS = 32, 4, 2
#: the bound where a run is not bitwise its one-card twin (the gradient
#: sums of the ring's replicas, NCCL's ring order for three ranks or more),
#: relative / absolute
CARDS_RTOL, CARDS_ATOL = 1e-5, 1e-6
#: (b)/(c): the ring's and the pipelines' adamw steps after the first
#: (rates from the steps after the first)
CARDS_STEPS = 3
#: (b): rows each card's ModelPredictor scores
CARDS_PREDICT = 256
#: (b): the engine's prompts and new tokens on the last card and on cuda:0
CARDS_PROMPTS, CARDS_NEW = 8, 32
#: (c): each rank's hard limit (s); the moves' repeats and bytes: the fold
#: of resnet50_nf's float32 parameters (phase 32's 102 MB), the
#: all-gather of 253 MiB a rank (phase 34's), a PipelinedLM hop
CARDS_CHILD_TIMEOUT_S = 420
CARDS_MOVE_REPS = 5
CARDS_GATHER_BYTES = 253 << 20
CARDS_HOP_SHAPE = (PP_B // PP_M, PP_T, 768)
#: (c): the fold backend every rank must read (one card a rank)
CARDS_BACKEND = "nccl"


def _cards_nf_model(seed):
    """(b)/(c)'s ``resnet50_nf()``, computing in float32 (TF32 off): a
    fold over NCCL reassociates the center's float32 sums, and in bf16
    compute the next round's roundings of the activations then flip, so
    two rounds would drift past the bound by rounding alone. Phase 24's
    bf16 recipe (``_nf_model``) runs one round, where only the fold can
    differ."""
    from distkeras_tpu_torch.models.resnet import init_params, resnet50_nf

    return init_params(resnet50_nf(dtype=torch.float32),
                       torch.Generator().manual_seed(seed))


def _sync(cards) -> None:
    for card in cards:
        torch.cuda.synchronize(card)


def _peaks(cards) -> list:
    return [torch.cuda.max_memory_allocated(c) for c in cards]


def _reset_peaks(cards) -> None:
    _sync(cards)
    torch.cuda.empty_cache()
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)


def _close(got, want) -> bool:
    """Two lists of numbers, or two name -> array dicts, within
    CARDS_RTOL / CARDS_ATOL."""
    if isinstance(want, dict):
        return sorted(got) == sorted(want) and all(
            np.allclose(np.asarray(got[n], np.float64),
                        np.asarray(want[n], np.float64), rtol=CARDS_RTOL,
                        atol=CARDS_ATOL) for n in want)
    return len(got) == len(want) and all(
        abs(u - v) <= CARDS_ATOL + CARDS_RTOL * abs(v)
        for u, v in zip(got, want))


def card_rows(dev) -> list:
    """Rows 1-7 of the kernel table on ``dev``, each held against its
    plain version on the same inputs at phase 3, 7, 11 and 13's bounds:
    the paged kernel at gpt_small's bf16 decode (8, 2), the three flash
    kernels at [4, 128, 12, 64] causal bf16, the int8 product at BERT-base's
    qkv over 4,096 rows (bitwise) and GroupNorm at [32, 3136, 256] bf16
    (bitwise, the stats within one ulp). Returns one dict a row."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    rows = []
    with torch.cuda.device(dev):
        rng = np.random.default_rng(35)
        q, k, v, table, ci = _paged_inputs(8, 2, torch.bfloat16, rng, dev)
        got = fa.paged_flash_attention(q, k, v, table, ci)
        want = fa.paged_flash_attention_reference(q, k, v, table, ci)
        err = (got.float() - want.float()).abs().max().item()
        bound = min(BOUNDS[torch.bfloat16],
                    PAGED_BF16_REL * want.float().abs().max().item())
        rows.append({"name": "paged_flash_attention", "max_abs_err": err,
                     "ok": err <= bound and bool(torch.isfinite(got).all())})
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(
            (4, 128, 12, 64)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(4))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True)
        delta = fa.flash_attention_delta(o_ref, dout)
        args = (q, k, v, dout, lse_ref, delta, True)
        pairs = {"flash_attention_fwd": zip(
                     fa.flash_attention_fwd(q, k, v, True), (o_ref, lse_ref),
                     (False, False)),
                 "flash_attention_bwd_dq": [(
                     fa.flash_attention_bwd_dq(*args),
                     fa.flash_attention_bwd_dq_reference(*args), True)],
                 "flash_attention_bwd_dkv": zip(
                     fa.flash_attention_bwd_dkv(*args),
                     fa.flash_attention_bwd_dkv_reference(*args),
                     (True, True))}
        for name, outs in pairs.items():
            ok, worst = True, 0.0
            for g, w, grad in outs:
                # phase 7's bf16 bounds: outputs 2e-2, gradients 2e-2 of
                # their largest magnitude
                err = (g.float() - w.float()).abs().max().item()
                bound = 2e-2 * w.float().abs().max().item() if grad \
                    else 2e-2
                ok &= err <= bound and bool(torch.isfinite(g).all())
                worst = max(worst, err)
            rows.append({"name": name, "max_abs_err": worst, "ok": ok})
        qx = torch.from_numpy(rng.integers(-127, 128, (4096, 768)).astype(
            np.int8)).to(dev)
        qw = torch.from_numpy(rng.integers(-127, 128, (2304, 768)).astype(
            np.int8)).to(dev)
        sxw = torch.tensor(3e-3, dtype=torch.float32, device=dev)
        got = i8.int8_matmul_dequant(qx, qw, sxw, torch.bfloat16)
        want = i8.int8_matmul_dequant_reference(qx, qw, sxw, torch.bfloat16)
        rows.append({"name": "int8_matmul_dequant", "max_abs_err": (
            got.float() - want.float()).abs().max().item(),
            "ok": torch.equal(got, want)})
        mk = lambda *s: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev)
        x, dy = (mk(32, 3136, 256).to(torch.bfloat16) for _ in range(2))
        gamma, beta = 1.0 + 0.1 * mk(256), 0.1 * mk(256)
        names = ("y", "stats", "dx", "dgamma_p", "dbeta_p")
        got = (*gn.group_norm_fwd(x, gamma, beta, GN_GROUPS),)
        want = gn.group_norm_fwd_reference(x, gamma, beta, GN_GROUPS, 1e-6)
        got += gn.group_norm_bwd(x, gamma, want[1], dy, GN_GROUPS)
        want += gn.group_norm_bwd_reference(x, gamma, want[1], dy, GN_GROUPS)
        # y, dx and the partials bitwise, the stats within one ulp
        errs, ok = _gn_errors(dict(zip(names, got)), dict(zip(names, want)))
        for name, outs in (("group_norm_fwd", ("y", "stats")),
                           ("group_norm_bwd", ("dx", "dgamma_p",
                                               "dbeta_p"))):
            rows.append({"name": name, "ok": ok, "max_abs_err": max(
                errs[o]["max_abs_err"] for o in outs)})
        torch.cuda.synchronize(dev)
    return rows


def _cards_kernels(cards, power_line) -> dict:
    """(a) rows 1-7 on every card, cuda:0 first."""
    out = {}
    for card in cards:
        t0 = time.perf_counter()
        rows = card_rows(card)
        out[str(card)] = rows
        log(f"[cards] (a) {card}: "
            + ", ".join(f"{r['name']} {r['max_abs_err']:.3g} "
                        f"{'ok' if r['ok'] else 'FAILED'}" for r in rows)
            + f" ({time.perf_counter() - t0:.1f} s) [{power_line}]")
        assert all(r["ok"] for r in rows), rows
    return out


def _cards_adag(cards, power_line) -> dict:
    """(b) ADAG(resnet50_nf()) sync, one worker a card (``make_mesh()``:
    every card) against K = N replicas on cuda:0, the same rows, then one
    round of it in phase 24's bf16 recipe (``_nf_model``); and
    ``mode="host_async"`` with one thread a card against N threads on
    cuda:0; then ``ModelPredictor`` over the cards' mesh against
    ``mesh=None`` on the sync run's center."""
    from distkeras_tpu_torch import ADAG, ModelPredictor
    from distkeras_tpu_torch.parallel import mesh as mesh_lib

    n = len(cards)
    ds = _images(n * CARDS_ROUNDS * CARDS_WINDOW * CARDS_B, seed=70)
    out = {}

    def train(key, rows=ds, make=_cards_nf_model, **kw):
        trainer = ADAG(make(seed=71), worker_optimizer="sgd",
                       learning_rate=0.05, batch_size=CARDS_B,
                       communication_window=CARDS_WINDOW, metrics=(), **kw)
        _reset_peaks(cards)
        t0 = time.perf_counter()
        params = trainer.train(rows)
        _sync(cards)
        wall = time.perf_counter() - t0
        losses = [h["loss"] for h in trainer.history]
        out[key] = {"wall_s": wall, "rows": len(rows),
                    "samples_per_s": len(rows) / wall,
                    "losses": losses, "peak_bytes": _peaks(cards),
                    "commits": trainer.num_updates,
                    "digest": _digest(params, losses)}
        assert all(math.isfinite(x) for x in losses), (key, losses)
        return {k: v.detach().cpu() for k, v in params.items()}

    # one round on every card first, untimed: the first training run's
    # set-up (cuDNN's plans a card and shape, the staging's buffers)
    train("warmup", rows=_images(n * CARDS_WINDOW * CARDS_B, seed=69),
          mesh=mesh_lib.make_mesh(n))
    one = train("sync_one_card", mesh=mesh_lib.Mesh([cards[0]]),
                parallelism_factor=n)
    center = train("sync_cards", mesh=mesh_lib.make_mesh(n))
    out["sync_bitwise"] = out["sync_cards"]["digest"] == \
        out["sync_one_card"]["digest"]
    out["sync_close"] = _close(center, one) and _close(
        out["sync_cards"]["losses"], out["sync_one_card"]["losses"])
    out["center"] = center
    # phase 24's bf16 recipe for one round (its center held against (c)'s)
    out["center_bf16"] = train(
        "sync_cards_bf16", rows=_images(n * CARDS_WINDOW * CARDS_B, seed=73),
        make=_nf_model, mesh=mesh_lib.make_mesh(n))
    train("async_one_card", mode="host_async", num_workers=n,
          devices=[cards[0]])
    train("async_cards", mode="host_async", num_workers=n)
    model = _scoring_model(center).eval()
    rows = _images(CARDS_PREDICT, seed=72)
    _reset_peaks(cards)
    t0 = time.perf_counter()
    mesh_pred = ModelPredictor(model, mesh=mesh_lib.make_mesh(n),
                               batch_size=CARDS_B).predict(rows)
    _sync(cards)
    mesh_s = time.perf_counter() - t0
    alone = ModelPredictor(_scoring_model(center).eval(),
                           batch_size=CARDS_B,
                           device=cards[0]).predict(rows)
    got, want = (np.asarray(p["prediction"]) for p in (mesh_pred, alone))
    out["predict"] = {"rows": CARDS_PREDICT, "mesh_s": mesh_s,
                      "bitwise": bool(np.array_equal(got, want)),
                      "max_rel": float(np.abs(got - want).max()
                                       / max(np.abs(want).max(), 1e-30))}
    for key in ("sync_one_card", "sync_cards", "sync_cards_bf16",
                "async_one_card", "async_cards"):
        r = out[key]
        log(f"[cards] (b) ADAG resnet50_nf {key} (b={CARDS_B}, window "
            f"{CARDS_WINDOW}, {n} workers): {r['samples_per_s']:.1f} "
            f"samples/s over {r['rows']} rows in {r['wall_s']:.2f} s, "
            f"{r['commits']} commits, losses {r['losses'][0]:.4f} -> "
            f"{r['losses'][-1]:.4f}, peak a card "
            f"{[round(p / 2**30, 2) for p in r['peak_bytes']]} GiB "
            f"[{power_line}]")
    log(f"[cards] (b) sync center over {n} cards bitwise the one-card K={n}"
        f" run: {out['sync_bitwise']} (within rtol {CARDS_RTOL}: "
        f"{out['sync_close']}); ModelPredictor over the {n}-card mesh vs "
        f"mesh=None: bitwise {out['predict']['bitwise']}, max relative "
        f"{out['predict']['max_rel']:.2e} [{power_line}]")
    assert out["sync_close"], out
    assert out["async_cards"]["commits"] == n * CARDS_ROUNDS, out
    assert out["predict"]["max_rel"] <= 1e-5, out
    return out


def _cards_pjit(cards, power_line) -> dict:
    """(b) ``PjitTrainer(bert_base(), precision="int8")`` at workers N/2 x
    model 2 over the cards against the same shape on cuda:0 repeated
    (phase 29 (b)'s rows and optimizer)."""
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8
    from distkeras_tpu_torch.parallel import mesh as mesh_lib

    n = len(cards)
    rows = [_bert_batch(30592, seed=40 + i) for i in range(PJIT_STEPS)]
    ds = Dataset.from_arrays(
        features=np.concatenate([r["features"] for r in rows]),
        label=np.concatenate([r["labels"] for r in rows]))
    out = {}
    for key, mesh in (("one_card", mesh_lib.Mesh([cards[0]] * n,
                                                 model_parallelism=2)),
                      ("cards", mesh_lib.make_mesh(
                          n // 2, model_parallelism=2))):
        _reset_peaks(cards)
        info, trainer = _pjit_run(cards[0], _enc_model("bert"), ds, mesh,
                                  "masked_lm", (i8.int8_matmul_dequant,),
                                  precision="int8", worker_optimizer="adam",
                                  learning_rate=1e-4, batch_size=PJIT_B)
        _sync(cards)
        info.update(peak_bytes=_peaks(cards), mesh=repr(mesh),
                    samples_per_s=len(ds) / info["wall_s"])
        out[key] = info
        del trainer
    out["bitwise"] = out["cards"]["losses"] == out["one_card"]["losses"]
    log(f"[cards] (b) bert-base int8 PjitTrainer {n // 2} x 2 over "
        f"{out['cards']['mesh']}: losses "
        f"{', '.join(f'{x:.6f}' for x in out['cards']['losses'])}, bitwise "
        f"the one-card mesh's {out['bitwise']}; "
        f"{out['cards']['samples_per_s']:.1f} vs "
        f"{out['one_card']['samples_per_s']:.1f} samples/s on one card; "
        f"int8 launches {out['cards']['launches']}; peak a card "
        f"{[round(p / 2**30, 2) for p in out['cards']['peak_bytes']]} GiB "
        f"[{power_line}]")
    assert out["bitwise"] or _close(out["cards"]["losses"],
                                    out["one_card"]["losses"]), out
    for key in ("one_card", "cards"):  # the global batch's step
        assert out[key]["launches"]["int8_matmul_dequant"] == \
            49 * len(out[key]["losses"]), out
    return out


def _cards_ring(cards, power_line, start) -> dict:
    """(b) gpt_small(attention="ring") bf16 at workers 1 x seq N over the
    cards (a replica of the weights a card) against 1 x N on cuda:0."""
    from distkeras_tpu_torch.models.gpt import gpt_small
    from distkeras_tpu_torch.ops import optimizers

    batch = _sp_batch(SP_B, SP_T, seed=40)
    out = {}
    for key, devices in (("one_card", [cards[0]] * len(cards)),
                         ("cards", list(cards))):
        ring = gpt_small(attention="ring")
        ring.load_state_dict(start)
        ring.to(cards[0])
        _reset_peaks(cards)
        losses, times, _ = _sp_steps(
            cards[0], ring, (1, len(cards)), batch,
            optimizers.get("adamw", 1e-3), CARDS_STEPS, devices=devices)
        _sync(cards)
        med = statistics.median(times[1:])
        out[key] = {"losses": losses, "step_s": times,
                    "tokens_per_s": SP_B * SP_T / med,
                    "peak_bytes": _peaks(cards)}
        del ring
    a, b = out["cards"]["losses"], out["one_card"]["losses"]
    out["step1_bitwise"] = a[0] == b[0]
    out["bitwise"] = a == b
    out["close"] = _close(a, b)
    log(f"[cards] (b) gpt_small ring bf16 1 x {len(cards)} over the cards: "
        f"losses {', '.join(f'{x:.6f}' for x in a)} against one card's "
        f"{', '.join(f'{x:.6f}' for x in b)} (step 1 bitwise "
        f"{out['step1_bitwise']}, all bitwise {out['bitwise']}; later steps "
        f"differ only by the order in which the replicas' gradients are "
        f"summed); {out['cards']['tokens_per_s']:.0f} vs "
        f"{out['one_card']['tokens_per_s']:.0f} tokens/s; peak a card "
        f"{[round(p / 2**30, 2) for p in out['cards']['peak_bytes']]} GiB "
        f"[{power_line}]")
    assert out["step1_bitwise"] and out["close"], out
    return out


def _pp_lm_steps(dev, devices):
    """Phase 30 (d)'s PipelinedLM with one stage a device of ``devices``
    (this process's; every process's end to end in a group): one sgd
    step, then CARDS_STEPS adamw steps: ``{"losses", "step_s"}``."""
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.parallel import mesh as mesh_lib
    from distkeras_tpu_torch.parallel import pipeline

    stages = len(mesh_lib.global_devices(devices)[0])
    model = pipeline.PipelinedLM(**PP_LM, num_stages=stages,
                                 dtype=torch.bfloat16, device=dev).init(43)
    mesh = pipeline.make_pp_mesh(stages, devices=devices)
    batch = _sp_batch(PP_B, PP_T, seed=44)
    losses, times = [], []
    for tx, steps in ((optimizers.get("sgd", SP_SGD_LR), 1),
                      (optimizers.get("adamw", 1e-3), CARDS_STEPS)):
        step_fn, place_params, place_batch = model.build_train_step(
            tx, mesh, PP_M)
        state, placed = place_params(), place_batch(batch)
        for _ in range(steps):
            t0 = time.perf_counter()
            state, ms = step_fn(state, placed)
            losses.append(float(ms["loss"]))
            times.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": times, "stages": stages,
            "owners": mesh.device_owners}


def _resnet_stages(parts, n) -> list:
    """The six stages of :func:`_resnet_pipeline_stages` joined into ``n``
    consecutive stages."""
    from torch import nn

    cuts = np.array_split(np.arange(len(parts)), n)
    return [nn.Sequential(*[parts[i] for i in c]) for c in cuts]


def _generic_step(dev, devices, n):
    """Phase 30 (e)'s GenericPipeline(resnet50()) in ``n`` stages, one a
    device of ``devices`` (this process's, in a group): one adamw step,
    the loss and both GroupNorm kernels' launches over it."""
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn
    from distkeras_tpu_torch.parallel import pipeline

    model = _resnet_model("gn", torch.bfloat16, seed=45)
    parts = _resnet_stages(_resnet_pipeline_stages(model), n)
    pipe = pipeline.GenericPipeline(parts, num_microbatches=GP_M,
                                    dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(46)
    feats = rng.standard_normal((GP_B, GP_SIDE, GP_SIDE, 3)).astype(
        np.float32)
    labels = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, GP_B)]
    pipe.init(feats[:GP_B // GP_M])
    mesh = pipeline.make_pp_mesh(n, devices=devices)
    step_fn, place_params, place_batch = pipe.build_train_step(
        optimizers.get("adamw", 1e-3), mesh)
    state = place_params()
    placed = place_batch({"features": feats, "labels": labels})
    kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
    for card in {torch.device(d) for d in devices}:
        torch.cuda.synchronize(card)
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    _, ms = step_fn(state, placed)
    loss = float(ms["loss"])
    return {"loss": loss, "step_s": time.perf_counter() - t0,
            "launches": {k.__name__: k.launches for k in kernels},
            "owners": mesh.device_owners}


def _cards_pipelines(cards, power_line) -> dict:
    """(b) PipelinedLM (12 layers in N stages) and GenericPipeline(
    resnet50()) in N stages, a stage a card, against the same stages on
    cuda:0 repeated."""
    n = len(cards)
    out = {"lm": {}, "generic": {}}
    for key, devices in (("one_card", [cards[0]] * n), ("cards", cards)):
        _reset_peaks(cards)
        out["lm"][key] = _pp_lm_steps(cards[0], devices)
        _sync(cards)
        out["lm"][key]["peak_bytes"] = _peaks(cards)
        _reset_peaks(cards)
        out["generic"][key] = _generic_step(cards[0], devices, n)
        _sync(cards)
        out["generic"][key]["peak_bytes"] = _peaks(cards)
    lm, gen = out["lm"], out["generic"]
    out["lm_bitwise"] = lm["cards"]["losses"] == lm["one_card"]["losses"]
    out["generic_bitwise"] = gen["cards"]["loss"] == gen["one_card"]["loss"]
    med = statistics.median(lm["cards"]["step_s"][1:])
    med1 = statistics.median(lm["one_card"]["step_s"][1:])
    log(f"[cards] (b) PipelinedLM gpt_small config {n} stages a card: "
        f"losses {', '.join(f'{x:.6f}' for x in lm['cards']['losses'])} "
        f"(one card {', '.join(f'{x:.6f}' for x in lm['one_card']['losses'])}"
        f": bitwise {out['lm_bitwise']}); {PP_B * PP_T / med:.0f} vs "
        f"{PP_B * PP_T / med1:.0f} tokens/s, {med * 1e3:.1f} vs "
        f"{med1 * 1e3:.1f} ms a step; GenericPipeline(resnet50()) {n} "
        f"stages: loss {gen['cards']['loss']:.6f} (one card "
        f"{gen['one_card']['loss']:.6f}: bitwise {out['generic_bitwise']}), "
        f"{gen['cards']['step_s'] * 1e3:.1f} vs "
        f"{gen['one_card']['step_s'] * 1e3:.1f} ms a step, GroupNorm "
        f"launches {gen['cards']['launches']} [{power_line}]")
    assert out["lm_bitwise"] or _close(lm["cards"]["losses"],
                                       lm["one_card"]["losses"]), out
    assert out["generic_bitwise"] or _close(
        [gen["cards"]["loss"]], [gen["one_card"]["loss"]]), out
    assert all(v == 53 * GP_M for v in gen["cards"]["launches"].values()), \
        out
    return out


def _cards_engine(cards, power_line) -> dict:
    """(b) ``GenerationEngine(page_size=16)`` on the last card (its graphs
    captured there) against the same engine on cuda:0: bf16 greedy
    tokens for CARDS_PROMPTS prompts, equal; the paged launches on the
    last card (zeroed before, read after)."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import GenerationEngine

    prompts = _serving_prompts()[:CARDS_PROMPTS]
    compiles = telemetry.counter("serving.decode.compiles")
    out = {}
    for key, card in (("cuda0", cards[0]), ("last", cards[-1])):
        c0 = compiles.value
        t0 = time.perf_counter()
        eng = GenerationEngine(_gpt_small_bf16(), device=card, page_size=PAGE,
                               **ENGINE_KW)
        setup_s = time.perf_counter() - t0
        captured = compiles.value - c0
        try:
            fa.paged_flash_attention.launches = 0
            t0 = time.perf_counter()
            tokens = [f.result(timeout=600).tokens.tolist() for f in
                      [eng.generate(p, max_new_tokens=CARDS_NEW)
                       for p in prompts]]
            wall = time.perf_counter() - t0
            launches = fa.paged_flash_attention.launches
            assert compiles.value - c0 == captured, "captured late"
        finally:
            eng.shutdown()
        out[key] = {"card": str(card), "tokens": tokens, "setup_s": setup_s,
                    "graphs": captured, "launches": launches,
                    "tokens_per_s": CARDS_PROMPTS * CARDS_NEW / wall}
        del eng
    out["equal"] = out["last"]["tokens"] == out["cuda0"]["tokens"]
    log(f"[cards] (b) GenerationEngine(page_size={PAGE}) bf16 on "
        f"{out['last']['card']}: {out['last']['graphs']} graphs captured "
        f"there in {out['last']['setup_s']:.2f} s, {CARDS_PROMPTS} prompts "
        f"x {CARDS_NEW} new tokens, tokens equal cuda:0's {out['equal']}, "
        f"{out['last']['tokens_per_s']:.1f} tokens/s, paged launches "
        f"{out['last']['launches']} [{power_line}]")
    assert out["equal"], out
    assert out["last"]["launches"] > 0 and out["last"]["graphs"] > 0, out
    return out


def _cards_one_process(cards, power_line) -> dict:
    """(b) one process over the cards."""
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params

    out = {"adag": _cards_adag(cards, power_line)}
    out["pjit"] = _cards_pjit(cards, power_line)
    start = init_params(gpt_small(), torch.Generator().manual_seed(39)) \
        .state_dict()
    out["ring"] = _cards_ring(cards, power_line, start)
    out["pipelines"] = _cards_pipelines(cards, power_line)
    out["engine"] = _cards_engine(cards, power_line)
    return out


def _timed_moves(dev, count) -> dict:
    """(c) the moves alone, CARDS_MOVE_REPS times each after one warm-up,
    timed from a barrier to a sync: the fold of resnet50_nf's float32
    parameters, the all-gather of CARDS_GATHER_BYTES a rank and a hop of
    CARDS_HOP_SHAPE bf16 to the next rank and back, over the fold group
    (NCCL); and the same fold and all-gather host-staged over the gloo
    default group (phases 32 and 34's path)."""
    from distkeras_tpu_torch.parallel import collectives, distributed

    me = distributed.process_index()
    tree = {n: p.detach() for n, p in _cards_nf_model(seed=71).to(
        dev).named_parameters()}
    fold_bytes = sum(t.nbytes for t in tree.values())
    gather = torch.full((CARDS_GATHER_BYTES // 4,), float(me),
                        device=dev)
    act = torch.full(CARDS_HOP_SHAPE, float(me), dtype=torch.bfloat16,
                     device=dev, requires_grad=True)
    nxt, prv = (me + 1) % count, (me - 1) % count

    def hop():
        _, (got,) = collectives.hop(
            [(act, nxt)], [(prv, CARDS_HOP_SHAPE, torch.bfloat16, dev)])
        got.float().sum().backward()
        collectives.flush_hops()

    def staged(flat):  # cross_process_sum's gloo path
        host = collectives._staging(flat.numel(), flat.dtype)
        host.copy_(flat)
        torch.distributed.all_reduce(host)
        flat.copy_(host)

    def staged_gather():  # all_gather_flat's gloo path
        host = collectives._staging(gather.numel(), gather.dtype)
        host.copy_(gather)
        parts = [torch.empty_like(host) for _ in range(count)]
        torch.distributed.all_gather(parts, host)
        return [p.to(dev) for p in parts]

    flat = torch.cat([t.reshape(-1) for t in tree.values()])
    moves = {"fold": lambda: collectives.cross_process_sum(tree),
             "all_gather": lambda: collectives.all_gather_flat([gather]),
             "hop": hop,
             "fold_gloo_staged": lambda: staged(flat),
             "all_gather_gloo_staged": staged_gather}
    out = {"fold_bytes": fold_bytes, "gather_bytes": CARDS_GATHER_BYTES,
           "hop_bytes": 2 * math.prod(CARDS_HOP_SHAPE)}
    for name, fn in moves.items():
        times = []
        for rep in range(CARDS_MOVE_REPS + 1):
            distributed.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            if rep:
                times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times)
    return out


def _cards_child(rank: int, count: int, port: str, work: str) -> int:
    """One rank of phase 35 (c) (``chip_smoke.py --cards-child RANK N PORT
    DIR``) on ``cuda:RANK``: the PipelinedLM first on the fresh group, the
    sync fold (float32, then one bf16 round), the row over processes, the
    ring, GenericPipeline and the moves, written to
    ``DIR/rank{RANK}.json``."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8
    from distkeras_tpu_torch.parallel import distributed

    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=count, process_id=rank,
                           local_device_ids=[rank], timeout_s=300)
    dev = torch.device("cuda", torch.cuda.current_device())  # initialize's
    out = {"rank": rank, "card": str(dev),
           "uuid": distributed.card_uuid(dev.index),
           "warmup_s": _ax_warmup(dev)}

    def run(fn):
        distributed.barrier()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(dev)
        got.update(wall_s=time.perf_counter() - t0,
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        return got

    # first on the fresh group: the PipelinedLM, a stage a rank, whose
    # first NCCL call is a hop between two ranks (fold_group forms the
    # group with every rank before it); its wall time includes that
    out["lm"] = run(lambda: _pp_lm_steps(dev, [dev]))
    out["fold_backend"] = distributed.fold_group(dev)[1]

    # the sync fold: one worker a rank, (b)'s rows, after one untimed
    # round (as (b) warms up)
    ds = _images(count * CARDS_ROUNDS * CARDS_WINDOW * CARDS_B, seed=70)

    def sync(rows=ds, make=_cards_nf_model, name="center"):
        trainer = ADAG(make(seed=71), worker_optimizer="sgd",
                       learning_rate=0.05, batch_size=CARDS_B,
                       communication_window=CARDS_WINDOW, metrics=(),
                       device=dev)
        params = trainer.train(rows)
        losses = [h["loss"] for h in trainer.history]
        if rank == 0:
            np.savez(os.path.join(work, f"{name}.npz"),
                     **{n: p.detach().cpu().numpy()
                        for n, p in params.items()})
        return {"losses": losses, "commits": trainer.num_updates,
                "owners": trainer.mesh.owners,
                "digest": _digest(params, losses)}

    sync(_images(count * CARDS_WINDOW * CARDS_B, seed=69))
    out["sync"] = run(sync)
    del ds
    out["sync_bf16"] = run(lambda: sync(
        _images(count * CARDS_WINDOW * CARDS_B, seed=73), _nf_model,
        "center_bf16"))

    # phase 34 (a)'s row over processes: workers N/2 x model 2, a row
    # over two ranks
    rows = [_bert_batch(30592, seed=40 + i) for i in range(PJIT_STEPS)]
    bert_ds = Dataset.from_arrays(
        features=np.concatenate([r["features"] for r in rows]),
        label=np.concatenate([r["labels"] for r in rows]))

    def pjit():
        mesh = distributed.multihost_mesh(count // 2, model_parallelism=2,
                                          devices=[dev])
        info, trainer = _pjit_run(dev, _enc_model("bert"), bert_ds, mesh,
                                  "masked_lm", (i8.int8_matmul_dequant,),
                                  precision="int8", worker_optimizer="adam",
                                  learning_rate=1e-4, batch_size=PJIT_B)
        info.update(owners=mesh.device_owners,
                    digest=_digest(trainer.params, info["losses"]))
        assert info["launches"]["int8_matmul_dequant"] == \
            49 * len(info["losses"]), info
        return info

    out["pjit"] = run(pjit)
    del bert_ds

    # the ring at 1 x N, a shard a rank
    start = init_params(gpt_small(), torch.Generator().manual_seed(39)) \
        .state_dict()

    def ring():
        model = gpt_small(attention="ring")
        model.load_state_dict(start)
        model.to(dev)
        losses, times, _ = _sp_steps(dev, model, (1, count),
                                     _sp_batch(SP_B, SP_T, seed=40),
                                     optimizers.get("adamw", 1e-3),
                                     CARDS_STEPS, devices=[dev])
        return {"losses": losses, "step_s": times}

    out["ring"] = run(ring)
    del start
    out["generic"] = run(lambda: _generic_step(dev, [dev], count))
    out["moves"] = _timed_moves(dev, count)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _cards_ranks(count, power_line, one) -> dict:
    """(c) ``count`` ranks of this script, one card each, over NCCL,
    against (b)'s one-process runs in ``one``."""
    import socket
    import tempfile

    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as work:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cards-child",
             str(r), str(count), port, work], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=HERE)
            for r in range(count)]
        try:
            outs = [p.communicate(timeout=CARDS_CHILD_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            for line in text.strip().splitlines()[-12:]:
                log(f"[cards] rank {r}: {line}")
            assert p.returncode == 0, f"rank {r} exited {p.returncode}"
        ranks = []
        for r in range(count):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        center, center_bf16 = (
            dict(np.load(os.path.join(work, f"{name}.npz")))
            for name in ("center", "center_bf16"))
    a = ranks[0]
    adag, pjit = one["adag"], one["pjit"]
    want = {n: t.numpy() for n, t in adag["center"].items()}
    want_bf16 = {n: t.numpy() for n, t in adag["center_bf16"].items()}
    max_abs = lambda got, ref: max(float(np.abs(
        got[n].astype(np.float64) - ref[n]).max()) for n in ref)
    ring, pipes = one["ring"], one["pipelines"]
    same = lambda part, key: all(r[part][key] == a[part][key] for r in ranks)
    info = {
        "backends": [r["fold_backend"] for r in ranks],
        "uuids_distinct": len({r["uuid"] for r in ranks}) == count,
        "ranks_equal": {
            "sync": same("sync", "digest"),
            "sync_bf16": same("sync_bf16", "digest"),
            "pjit": same("pjit", "digest"),
            "ring": same("ring", "losses"), "lm": same("lm", "losses"),
            "generic": same("generic", "loss")},
        "vs_one_process": {
            "sync_center": _close(center, want),
            "sync_losses": _close(a["sync"]["losses"],
                                  adag["sync_cards"]["losses"]),
            "sync_bf16_center": _close(center_bf16, want_bf16),
            "pjit": _close(a["pjit"]["losses"], pjit["cards"]["losses"]),
            "ring": _close(a["ring"]["losses"], ring["cards"]["losses"]),
            "lm": _close(a["lm"]["losses"], pipes["lm"]["cards"]["losses"]),
            "generic": _close([a["generic"]["loss"]],
                              [pipes["generic"]["cards"]["loss"]])},
        "bitwise_one_process": {
            "sync": a["sync"]["losses"] == adag["sync_cards"]["losses"],
            "sync_bf16": a["sync_bf16"]["losses"]
            == adag["sync_cards_bf16"]["losses"],
            "pjit": a["pjit"]["losses"] == pjit["cards"]["losses"],
            "ring": a["ring"]["losses"] == ring["cards"]["losses"],
            "lm": a["lm"]["losses"] == pipes["lm"]["cards"]["losses"],
            "generic": a["generic"]["loss"]
            == pipes["generic"]["cards"]["loss"]},
        "sync_center_max_abs": max_abs(center, want),
        "sync_bf16_center_max_abs": max_abs(center_bf16, want_bf16),
        "moves": [r["moves"] for r in ranks],
        "peak_bytes": {k: [r[k]["peak_bytes"] for r in ranks]
                       for k in ("sync", "sync_bf16", "pjit", "ring", "lm",
                                 "generic")},
        "launches": {
            "int8_matmul_dequant": sum(
                r["pjit"]["launches"]["int8_matmul_dequant"] for r in ranks),
            **{k: sum(r["generic"]["launches"][k] for r in ranks)
               for k in a["generic"]["launches"]}},
        "wall_s": {k: a[k]["wall_s"] for k in ("sync", "pjit", "ring", "lm",
                                               "generic")},
        "ranks": ranks}
    mv = a["moves"]
    n_rows = count * CARDS_ROUNDS * CARDS_WINDOW * CARDS_B
    log(f"[cards] (c) {count} ranks, one card each, fold backends "
        f"{info['backends']}, card UUIDs distinct {info['uuids_distinct']};"
        f" ranks equal {info['ranks_equal']}; against (b): within rtol "
        f"{CARDS_RTOL} {info['vs_one_process']}, bitwise "
        f"{info['bitwise_one_process']}; the center's largest difference "
        f"{info['sync_center_max_abs']:.3e} (float32, {CARDS_ROUNDS} rounds)"
        f", {info['sync_bf16_center_max_abs']:.3e} (bf16, one round) "
        f"[{power_line}]")
    log(f"[cards] (c) sync ADAG {n_rows / a['sync']['wall_s']:.1f} "
        f"samples/s ((b) one process {adag['sync_cards']['samples_per_s']:.1f}"
        f"), bert int8 rows over ranks "
        f"{len(a['pjit']['losses']) * PJIT_B * (count // 2) / a['pjit']['wall_s']:.1f}"
        f" samples/s, ring {a['ring']['wall_s']:.2f} s, PipelinedLM "
        f"{a['lm']['wall_s']:.2f} s (forming the NCCL group included), "
        f"GenericPipeline "
        f"{a['generic']['wall_s']:.2f} s; peak a rank "
        f"{ {k: [round(p / 2**30, 2) for p in v] for k, v in info['peak_bytes'].items()} } GiB "
        f"[{power_line}]")
    wire = a["fold_backend"]
    log(f"[cards] (c) moves (median of {CARDS_MOVE_REPS}, rank 0): {wire} "
        f"fold of {mv['fold_bytes'] / 1e6:.1f} MB {mv['fold'] * 1e3:.2f} ms, "
        f"gloo host-staged {mv['fold_gloo_staged'] * 1e3:.2f} ms; {wire} "
        f"all-gather of {mv['gather_bytes'] / 2**20:.0f} MiB a rank "
        f"{mv['all_gather'] * 1e3:.2f} ms, gloo host-staged "
        f"{mv['all_gather_gloo_staged'] * 1e3:.2f} ms; {wire} hop of "
        f"{mv['hop_bytes'] / 2**20:.1f} MiB there and back "
        f"{mv['hop'] * 1e3:.2f} ms ({count} cards' rates, not time slices "
        f"of one card) [{power_line}]")
    assert all(info["launches"][k] == 53 * GP_M
               for k in a["generic"]["launches"]), info["launches"]
    assert info["backends"] == [CARDS_BACKEND] * count, info["backends"]
    assert info["uuids_distinct"], info
    assert all(info["ranks_equal"].values()), info["ranks_equal"]
    assert all(info["vs_one_process"].values()), info["vs_one_process"]
    return info


def _smi_cards() -> list:
    """``name, power.limit`` of every card, one line each (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()


def phase_cards(power_line) -> dict:
    """Phase 35: the cards of one host (module docstring). On a host with
    one card it runs nothing and says so."""
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[cards] phase 35 needs two cards or more; this host has "
            f"{count}: ran nothing [{power_line}]")
        return {"cards": count, "ran": False}
    count = min(count, 4)
    cards = [torch.device("cuda", i) for i in range(count)]
    set_tf32(False)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    smi = _smi_cards()
    for line in smi:
        log(f"[cards] card: {line}")
    try:
        info = {"cards": count, "ran": True, "smi": smi,
                "kernels": _cards_kernels(cards, power_line)}
        # each card's first CUDA work (cuBLAS, cuDNN, the kernels' first
        # launches) before the timed runs, untimed
        info["warmup_s"] = []
        for card in cards:
            with torch.cuda.device(card):
                info["warmup_s"].append(_ax_warmup(card))
        info["one"] = _cards_one_process(cards, power_line)
        torch.cuda.empty_cache()
        info["ranks"] = _cards_ranks(count, power_line, info["one"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    info["one"]["adag"].pop("center")
    info["one"]["adag"].pop("center_bf16")
    info["phase_s"] = time.perf_counter() - t0
    log(f"[cards] phase 35 on {count} cards in {info['phase_s']:.1f} s: "
        f"{'; '.join(smi)}")
    return info


def cards_alone() -> int:
    """Phases 1, 2 and 35 alone (``python -c "import sys, chip_smoke;
    sys.exit(chip_smoke.cards_alone())"``): the four-card run without the
    one-card phases. Writes ``chiprun_out/chip_smoke_cards.json``."""
    report = {}
    try:
        report["device"] = _run_phase("device", phase_device)
        import distkeras_tpu_torch  # noqa: F401 — fails outside a checkout

        report["build"] = _run_phase("build", phase_build)
        report["cards"] = _run_phase("cards", phase_cards,
                                     report["device"]["nvidia_smi"])
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        log("[chip_smoke] FAILED")
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_cards.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(json.dumps({"cards_ok": report["cards"].get("ran", False)}))
    return 0


#: seconds each phase took, in run order (logged and in the report)
PHASE_SECONDS = {}


def _run_phase(name, phase, *args, **kwargs):
    """Run one phase and log its wall time (the run's budget is read
    from these lines)."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"[chip_smoke] {name} took {PHASE_SECONDS[name]:.1f} s")
    return out


def main() -> int:
    report = {}
    t = _run_phase
    try:
        report["device"] = t("device", phase_device)
        import distkeras_tpu_torch  # noqa: F401 — fails outside a checkout

        dev = torch.device("cuda:0")
        card = report["device"]["nvidia_smi"]
        report["build"] = t("build", phase_build)
        report["kernel_cases"] = t("kernel_cases", phase_kernels, dev)
        report["engine"] = t("engine", phase_engine, dev, card)
        report["greedy"] = t("greedy", phase_greedy, dev)
        report["profile"] = t("profile", phase_profile, dev)
        report["flash_cases"] = t("flash_cases", phase_flash_kernels, dev)
        report["train"], train_run = t("train", phase_train, dev, card)
        report["train_profile"] = t("train_profile", phase_train_profile,
                                    *train_run)
        del train_run
        torch.cuda.empty_cache()
        report["train_witness"] = t(
            "train_witness", phase_train_witness, dev,
            [m["loss"] for m in report["train"]["metrics"]])
        report["train_identity"] = t("train_identity", phase_train_identity,
                                     dev)
        report["int8_cases"] = t("int8_cases", phase_int8_kernel, dev)
        report["int8_train"], int8_run = t("int8_train", phase_int8_train,
                                           dev, card)
        report["int8_train_profile"] = t(
            "int8_train_profile", phase_train_profile, *int8_run,
            tag="int8-profile")
        assert report["int8_train_profile"]["int8_kernel_launches"] == 48
        del int8_run
        torch.cuda.empty_cache()
        report["int8_witness"] = t("int8_witness", phase_int8_witness, dev,
                                   report["int8_train"]["losses"])
        report["gn_cases"] = t("gn_cases", phase_gn_kernels, dev)
        report["resnet_train"], resnet_run = t(
            "resnet_train", phase_resnet_train, dev, card)
        report["resnet_train_profile"] = t(
            "resnet_train_profile", phase_train_profile, *resnet_run,
            tag="resnet-profile")
        del resnet_run
        torch.cuda.empty_cache()
        report["resnet_witness"] = t("resnet_witness", phase_resnet_witness,
                                     dev, report["resnet_train"]["losses"])
        report["resnet_identity"] = t("resnet_identity",
                                      phase_resnet_identity, dev)
        report["nf"] = t("nf", phase_nf, dev, card)
        report["rect"] = t("rect", phase_rect, dev, card)
        report["sampled"] = t("sampled", phase_sampled, dev)
        report["chunked"] = t("chunked", phase_chunked, dev, card)
        report["prefix"] = t("prefix", phase_prefix, dev, card)
        report["int8_kv"] = t("int8_kv", phase_int8, dev, card)
        report["spec"] = t("spec", phase_spec, dev, card)
        report["wire"] = t("wire", phase_wire, dev, card, report["engine"])
        report["fleet"] = t("fleet", phase_fleet, dev, card, report["wire"],
                            report["engine"])
        report["train_core"] = t("train_core", phase_train_core, dev, card,
                                 report["nf"])
        report["measure"] = t("measure", phase_measure, dev, card,
                              report["profile"])
        report["checkpoint"] = t("checkpoint", phase_checkpoint, dev, card)
        report["async"] = t("async", phase_async, dev, card,
                            report["train_core"]["bench"])
        report["encoders"] = t("encoders", phase_encoders, dev, card)
        report["pjit"] = t("pjit", phase_pjit, dev, card)
        report["seqpipe"] = t("seqpipe", phase_sequence_pipeline, dev,
                              card)
        report["data"] = t("data", phase_data, dev, card,
                           report["async"]["bench"]["k2"]["samples_per_s"])
        report["multiprocess"] = t(
            "multiprocess", phase_multiprocess, dev, card,
            report["async"]["bench"]["k2"]["samples_per_s"])
        report["lint"] = t("lint", phase_lint, card)
        report["axes"] = t("axes", phase_axes, dev, card, report)
        report["cards"] = t("cards", phase_cards, card)
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        log("[chip_smoke] FAILED")
        return 1
    main_case = next(c for c in report["kernel_cases"]
                     if (c["b"], c["t"], c["h"], c["d"], c["max_len"],
                         c["dtype"]) == (8, 2, H, D, PMAX * PAGE,
                                         "bfloat16"))
    rows = [{
        "name": "paged_flash_attention",
        "route": "cuda",
        "source": "distkeras_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:435",
        "launches": report["engine"]["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "ms_source": main_case["ms_source"],
        "shape": "decode b=8 t=2 h=12 d=64 page_size=16 pmax=64 bf16",
        # phase 22's wire window (zeroed before it, read after it)
        "launches_wire": report["wire"]["window"]["paged_launches"],
        # phase 23's routed window (zeroed before it, read after it)
        "launches_fleet": report["fleet"]["rates"]["paged_launches"],
    }]
    train_case = next(c for c in report["flash_cases"]
                      if c["shape"] == [8, 2048, 12, 64]
                      and c["dtype"] == "bfloat16")
    flash_rows = (
        ("flash_attention_fwd", "fwd", ("o", "lse"), "flash_attention_fwd.cu",
         131),
        ("flash_attention_bwd_dq", "dq", ("dq",), "flash_attention_bwd.cu",
         237),
        ("flash_attention_bwd_dkv", "dkv", ("dk", "dv"),
         "flash_attention_bwd.cu", 283))
    for name, part, outs, src, line in flash_rows:
        kk = train_case["kernels"][part]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distkeras_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": f"distkeras_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": report["train"]["launches"][name],
            "max_abs_err": max(train_case["errors"][o]["max_abs_err"]
                               for o in outs),
            "ms": kk["ms"], "plain_ms": kk["plain_ms"],
            "bound_ms": kk["bound_ms"], "bound_by": kk["bound_by"],
            "library_ms": kk["library_ms"],
            **({"library_bwd_ms": kk["library_bwd_ms"]}
               if "library_bwd_ms" in kk else {}),
            "split_terms": kk["split_terms"],
            "ms_source": kk["ms_source"],
            "shape": "b=8 t=2048 h=12 d=64 causal bf16",
        })
        if name == "flash_attention_fwd":
            # phase 22's one-shot infer (zeroed before it, read after it)
            rows[-1]["launches_wire"] = report["wire"]["one_shot"][
                "flash_fwd_launches"]
        # phase 28 (d): the MoE classifier's steps, non-causal; (e): phase
        # 8's step under remat="blocks" (each zeroed before, read after)
        enc = report["encoders"]
        rows[-1]["launches_encoders"] = enc["moe"]["flash"]["launches"][name]
        rows[-1]["launches_remat"] = enc["remat"]["gpt"]["blocks"][
            "launches"][name]
        # phase 29 (c): PjitTrainer over the MoE classifier at workers 2 x
        # model 2; (d): the mesh ServingEngine's traffic (each zeroed
        # before, read after)
        rows[-1]["launches_pjit"] = report["pjit"]["moe"]["w2m2"][
            "launches"][name]
        # phase 34 (b): the MoE at workers 2 x model 2 over two ranks
        # (each zeroed before its run, read after; both ranks' sum)
        rows[-1]["launches_axes"] = report["axes"]["moe"]["launches"][name]
        if name == "flash_attention_fwd":
            rows[-1]["launches_mesh_serving"] = report["pjit"]["serving"][
                "launches"]
    qkv = next(c for c in report["int8_cases"] if c["name"] == "qkv")
    rows.append({
        "name": "int8_matmul_dequant", "route": "cuda",
        "source": "distkeras_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
        "replaces": "distkeras_tpu/ops/pallas/int8_matmul.py:68",
        "launches": report["int8_train"]["launches"]["int8_matmul_dequant"],
        "max_abs_err": max(c["max_abs_err"] for c in report["int8_cases"]),
        "ms": qkv["ms"], "plain_ms": qkv["plain_ms"],
        "bound_ms": qkv["bound_ms"], "bound_by": qkv["bound_by"],
        "library_ms": qkv["library_ms"], "ms_source": qkv["ms_source"],
        "x_bound": qkv["x_bound"],
        "shape": "qkv: int8 [16384, 768] x [2304, 768] -> bf16",
        # phase 28 (b): bert_base(precision="int8") steps (zeroed before,
        # read after)
        "launches_encoders": report["encoders"]["int8"]["int8"]["launches"][
            "int8_matmul_dequant"],
        # phase 29 (b): PjitTrainer over bert_base re-stamped to int8 at
        # model 2 (zeroed before, read after)
        "launches_pjit": report["pjit"]["int8"]["model2"]["launches"][
            "int8_matmul_dequant"],
        # phase 34 (a): the same over two ranks, a row each and a row
        # over both (each zeroed before its run, read after; both ranks'
        # sum over both layouts)
        "launches_axes": sum(report["axes"][f"int8_{k}"]["launches"][
            "int8_matmul_dequant"] for k in ("rows", "span")),
    })
    stem = next(c for c in report["gn_cases"]
                if c["shape"] == [128, 12544, 64]
                and c["dtype"] == "bfloat16")
    for name, part, outs, line in (
            ("group_norm_fwd", "fwd", ("y", "stats"), 60),
            ("group_norm_bwd", "bwd", ("dx", "dgamma_p", "dbeta_p"), 87)):
        kk = stem["kernels"][part]
        rows.append({
            "name": name, "route": "cuda",
            "source": "distkeras_tpu_torch/ops/kernels/csrc/groupnorm.cu",
            "replaces": f"distkeras_tpu/ops/pallas/groupnorm.py:{line}",
            "launches": report["resnet_train"]["launches"][name],
            "max_abs_err": max(stem["errors"][o]["max_abs_err"]
                               for o in outs),
            "ms": kk["ms"], "plain_ms": kk["plain_ms"],
            "bound_ms": kk["bound_ms"], "bound_by": kk["bound_by"],
            "library_ms": kk["library_ms"], "ms_source": kk["ms_source"],
            "shape": "ResNet-50 stem [128, 12544, 64] G=32 bf16",
            # phase 24 (d): resnet50() under ADAG (zeroed before, read
            # after)
            "launches_train_core": report["train_core"]["groupnorm"][
                "launches"][name],
            # phase 27 (e): resnet50() under host_async K = 2 (zeroed
            # before, read after)
            "launches_async": report["async"]["groupnorm"]["launches"][name],
            # phase 30 (e): GenericPipeline over resnet50() (zeroed
            # before its step, read after)
            "launches_pipeline": report["seqpipe"]["generic"]["launches"][
                name],
            # phase 34 (d): the same pipeline's stages over two ranks
            # (each zeroed before its step, read after; both ranks' sum)
            "launches_axes": report["axes"]["generic"]["launches"][name],
        })
    cards = report["cards"]
    if cards["ran"]:  # phase 35 (b) and (c): zeroed before, read after
        one, ranks = cards["one"], cards["ranks"]["launches"]
        lc = {"paged_flash_attention": one["engine"]["last"]["launches"],
              "int8_matmul_dequant": one["pjit"]["cards"]["launches"][
                  "int8_matmul_dequant"] + ranks["int8_matmul_dequant"]}
        for name in ("group_norm_fwd", "group_norm_bwd"):
            lc[name] = one["pipelines"]["generic"]["cards"]["launches"][
                name] + ranks[name]
        for row in rows:
            # (a): the cards on which the row matched its plain version
            row["cards_checked"] = sum(
                r["ok"] for card in cards["kernels"].values() for r in card
                if r["name"] == row["name"])
            row["launches_cards"] = lc.get(row["name"], 0)
    kernels = {"kernels": rows}
    report["phase_seconds"] = PHASE_SECONDS
    log(f"[chip_smoke] phases took {sum(PHASE_SECONDS.values()):.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({**report, **kernels}, f, indent=1, default=str)
    log(json.dumps(kernels))
    log(report["device"]["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["device"]["kind"],
        "count": report["device"]["count"]}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-child"]:
        sys.exit(_mp_child(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--axes-child"]:
        sys.exit(_axes_child(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--cards-child"]:
        sys.exit(_cards_child(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5]))
    sys.exit(main())
