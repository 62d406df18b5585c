#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, int8 inference, NCF,
Wide & Deep and session recommendation, checkpoint/resume,
input-pipeline, serving data-plane and control-plane paths, the
runtime context, file and set data tiers and TextClassifier,
multi-rank training, the analysis tier, and the layer library with the
MobileNets, on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build and kernel checks only
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns
                                     # (phase 5b's arms too)
    python3 chip_smoke.py --parent _archive/parent   # plus the parent's
                                     # K1-K6, timed beside this tree's

Phases, each fatal on failure (no result line is printed then):

1. device: the card's name and power limit, torch/CUDA versions; TF32 off
   for matmuls and cuDNN so the f32 checks compare f32 arithmetic.
2. build: compile every kernel in ``analytics_zoo_tpu_torch/csrc`` with
   nvcc (one process per source, all at once), timed; print ptxas'
   registers and spills per kernel, and check from ``cuobjdump -sass``
   that the bf16 K1, K3 and K4 run on wgmma (HGMMA) fed by TMA (UTMALDG)
   and that every instance of K5's and K6's GEMMs runs on the int8 tensor
   cores (IMMA for mma.sync, IGMMA for K5's wgmma, no IDP: __dp4a only in
   K6's Cin <= 4 kernel).
3. kernels: K1 (flash forward, out + LSE), K2 (paged attention, q_len 1,
   4 and 16, with a zero-length slot; bf16 also at pages of 8 and 32; then
   q_len 1, 16, 17, 48, 64 and 128, and at q_len 1, 17 and 64 head dims
   16, 32, 96 and the WIDE_D ones 4, 12, 20, 100, 264, 384 and 512; then
   the serving features' q_len 256, 512 and 1024, q_len 128 on a chunk's
   wide table of pages_per_slot + 8 entries, the extra ones scratch, and
   q_len 1024 with lengths past pages_per_slot * page_size, the suffix
   prefill of a prefix hit), K3
   (flash backward dQ) and K4 (flash backward dK/dV; D in {64, 128}, T in
   {16, 100, 1024} and at the 64-row tile edges {1, 63, 64, 65, 127, 129},
   causal and not; then the head dims 8, 16, 32, 96, 160 and 256 and the
   WIDE_D ones at the tile edges, K1 too) against their plain PyTorch
   versions on the card, f32 within 1e-4 and bf16 within 2e-2 (K3/K4 at B
   1 and 2, and K1, K3 and K4 again at the training shapes B=2 and B=4,
   T=2048, H=16, D=64, and at B=2 with D=128, causal, bf16, where K3 and
   K4 called twice must give the same bits); bf16 K1, K3 and K4 run on
   wgmma fed by TMA, bf16 K2 on mma.sync (split across the context), f32
   on FMA kernels, head dims above 256 (and K2's bf16 ones off the 8 grid)
   on the wide FMA kernels. Timed with CUDA
   events (median of 30 launches, 20 for K3/K4, after warm-up, L2 flushed
   before each): the kernel, its plain version, one library call
   computing the same function (a yardstick the port never calls; for
   K3/K4 SDPA's backward, which computes dQ, dK and dV in one call), and
   the bound — the larger of bytes over 3.35 TB/s and operations over the
   peak rate of the inputs' type. K1/K2 are timed at the serving shapes
   (K2 also at q_len 16 and 64 and on 8 full-length slots), K1 also at
   the training micro-batch (under ``training_shape``), K3/K4 at the
   training micro-batch (B=2, the shape the main path launches them at;
   the kernels line), the whole batch (B=4, under ``whole_batch``) and
   D=128 (``head_dim_128``), each with the wrapper's host microseconds a
   call; with ``--parent`` the parent's K1-K4 beside them (``parent_ms``,
   ``parent_device_ms``, ``parent_host_us``; K1 at the training shape
   and K3/K4 in turns parent, change, change, parent). Device-only times
   (``device_ms``: torch.profiler's device time of the kernels a call
   launches, the L2 flush's own kernel left out, over 20 calls) for K1
   and SDPA's forward at the serving shape and the training micro-batch,
   K3, K4 and SDPA's backward, and K2 and SDPA over its pre-gathered K/V
   (``library_device_ms``) at every timed K2 shape: decode, q_len 16 and
   64, full context and the serving features' shapes below. K2 is
   also timed at the serving features' shapes: a verify step (q_len 4 on
   the half-full ladder), a chunk (q_len 128 on one slot with 512 cached,
   the wide table) and a suffix (q_len 1024 on one slot after a 480-token
   hit, lengths past the table). The wide
   kernels of K1, K3, K4 (B=1 T=1024 H=16 causal) and K2 (decode) are
   timed at D=264 and 512 in bf16 (``wide_head``). The sampling kernel
   (threefry bits,
   Gumbel transform and row argmax fused) must draw its plain version's
   tokens exactly, at the decode step's (8, 32000) logits.
4. parity: the full-width f32 model on the card (kernels) against the same
   seeded model on the CPU (plain versions): a 128-token prefill and 8
   decode steps teacher-forced with the CPU's tokens, logits within 1e-3
   (12 layers and another summation order grow the f32 error).
5. serving: the full-width model in bf16 under ContinuousBatcher(n_slots=8,
   page_size=16, max_seq_len=1024): 16 requests with seeded prompt lengths
   in 8..700, 32 new tokens each, 12 greedy and 4 at temperature 0.8. Every
   stream must end ok with 32 tokens, the launch counts of both kernels
   (set to 0 just before) must show one K1 launch per prefill and layer and
   one K2 launch per decode step and layer, the sampling kernel at least
   once, and greedy tokens must be the argmax of a full forward over the
   emitted sequence.
5b. serving features: the same model and batcher geometry, one fresh
   batcher an arm: plain, spec_k=4, prefill_chunk_tokens=128,
   prefix_cache_pages=256 and all three. Traffic: 4 tenants with a
   480-token shared prefix each; 4 users a tenant with a unique 8..64-token
   suffix and 32 new tokens (12 greedy, 4 at temperature 0.8); one greedy
   1000-token request on tenant 0's prefix with 16 new tokens (its suffix
   bucket of 1024 reaches past the page table); after a warm-up of one
   prefix + [1, 2, 3] request a tenant. Every stream ends ok with its
   token count; K2 launches = 12 x (decode + verify + chunk + prefill_from
   dispatches) and K1 = 12 x whole-prompt prefills, from the batcher's
   counters (launch counts set to 0 before each arm); spec arms take a
   verify step and >= 1 token a slot-step; chunked arms one chunk shape;
   prefix arms 17 hits and 17 x 480 tokens saved, the pool conserved after
   close; greedy argmax margins <= 0.1 for three streams, the 1000-token
   one among them. Prints each arm's tokens/s, TTFT, ITL, steps,
   acceptance, chunks, tokens saved, peak pages and how many greedy
   streams equal the plain arm's (bf16 rounds a verify step unlike a
   decode step, so they may differ).
6. training parity: the full-width f32 model on the card (K1, K3, K4)
   against the same seeded model on the CPU on one (1, 256) batch: loss
   within 1e-4 relative, every gradient leaf's max |d| within 1e-3 of that
   leaf's max |g|, and the loss after one Estimator Adam step on each side
   within 1e-3.
7. training (the slice's main path): the full-width model through
   ``compile``/``fit`` in bf16 with f32 masters, remat "flash", Adam,
   global-norm clipping 1.0, grad_accum_steps 2: 8 seeded sequences of
   2048+1 ids, batch 4, 4 epochs = 8 optimizer steps, 16 micro-steps. Every
   loss finite, the last below the first, and K1 = K3 = K4 = 12 x 16
   launches (set to 0 just before), so remat never re-ran K1. Prints the
   median step time, tokens/s, peak device memory and the losses.

8. int8 serving (the int8 slice's main path): InferenceModel(
   supported_concurrent_num=4, max_batch_size=32) over full-width
   ResNet-50 (224x224x3, 1000 classes, weights from seed 0,
   BatchNormalization's statistics calibrated on 4 seeded images): float
   predicts timed at f32 and bf16, then quantize_int8 and warm_up, then a
   burst of requests of 1, 5, 32 and 40 images from 4 threads: rows finite
   and summing to 1, equal rows for equal images, K6 = 53 and K5 = 1
   launches per dispatched chunk (counts set to 0 just before); then int8
   timed at f32 and bf16 (images/s at batch 32, batch-1 p50) and the peak
   device memory.
9. int8 MLP: serving_bench.py's model (Dense 4096 relu x 2, Dense 128
   softmax; seed 0) at batch 2048 through InferenceModel: K5 = 3 per
   predict, the output within 1e-5 of the plain route on the card, predict
   ms float and int8 at f32 and bf16.
10. int8 parity: that ResNet-50, quantized, on the card (K5, K6) against
   the same model on the CPU (plain versions) at batch 2: max |d prob| <=
   1e-3 and the same top-1 wherever the CPU's top-2 margin is above 1e-3.
11. example: examples/transformer_lm.py's model (vocab 256, hidden 64, 2
   blocks, 4 heads, so head dim 16; seed 0) on the card against the same
   seeded model on the CPU: 4 greedy requests and a prompt pair (20
   tokens, then 60 sharing one 16-token block) through ContinuousBatcher
   in four arms (plain; spec_k=3; prefix_cache_pages=8, whose suffix
   bucket passes the page and position tables; prefill_chunk_tokens=32
   with prefix_cache_pages=8) give the CPU's token streams, every arm the
   plain arm's (K1 prefill, K2 decode, counted), and one Estimator Adam
   step (K1, K3, K4) gives the CPU's loss within 1e-4 and its next loss
   within 1e-3.
12. NCF (the NCF slice's main path; no kernel of its own): bench.py's
   MovieLens-1M recipe on the synthetic ML-1M (1,000,209 ratings, seed
   0; leave-one-out: the first 1000 users' last ratings held out, 1
   positive + 99 unseen negatives each) through ``compile``/``fit``/
   ``predict``. For explicit ``NeuralCF(6040, 3706, 5)`` (Adam 1e-3,
   sparse CE) and then ``ImplicitNCF(6040, 3706, n_negatives=4)`` (Adam
   2.5e-3, BCE, negatives drawn on the card each step), default widths,
   batch 8192, device-cached epochs: the first 8 steps in f32 (the first
   8 x 8192 training pairs) on the card twice and on the CPU, losses
   within 1e-5 relative and the implicit negatives bit for bit the CPU's
   (whether the two card runs' losses are bit-identical is printed); then
   4 epochs in bf16 on the card (the first a warm-up), printing samples/s
   over epochs 2-4, the median step ms (the Estimator's per-epoch window),
   HR@10 and NDCG@10 (expected rating, or probability), the final loss
   and the peak device memory above what the phase found allocated,
   beside the card's name and power limit
   (``--profile``: one more epoch traced, the device's busy share); the
   card's HR@10 after epoch 1 within 0.03 of a one-epoch CPU run of the
   same recipe, both and the card's final HR@10 above the 0.10 random
   floor; ``recommend_for_user`` on 20 users in (-prediction,
   -probability) order.
13. checkpoint and resume (the eleventh slice), in a temp directory whose
   free space is checked first (5 x the ~3.06 GB checkpoint) and which is
   deleted at the end: (a) phase 7's training with ``checkpoint_dir`` and
   ``checkpoint_every_n_iters=3``: leg 1 runs 2 epochs (an async trigger
   save at iteration 3, durable epoch-end saves at 2 and 4), equal to
   phase 7's steps 1-4; a model from seed 1 resumes to epoch 4: its
   losses and gradient norms equal phase 7's steps 5-8 bit for bit, the
   state it loaded equals leg 1's final state bit for bit, K1 = K3 = K4 =
   12 x 8 (counts set to 0 just before); prints the checkpoint's GB, each
   save's cost to the loop, the snapshot, write and load+verify ms and
   MB/s. (b) phase 12's explicit recipe, 2 epochs with a trigger every 61
   iterations (each 121-step block crosses one: an async save, then the
   epoch's durable one), then a model from seed 1 resumed to epoch 4:
   final loss, HR@10 and NDCG@10 equal phase 12's bit for bit. (c) a
   child process at phase 11's example width, one step an epoch, slowed
   0.2 s a step by a chaos delay, SIGTERM'd after its first checkpoint:
   exit 143 with a final checkpoint; a resume 3 epochs on equals an
   uninterrupted run bit for bit. (d) at that width, 4 steps an epoch,
   checkpoints every 3: a step raising twice at iteration 7 ends at
   iteration 14, epoch 3 (``tests/test_fault_injection.py``'s counts);
   twice at iteration 8 ends on the uninterrupted run's losses bit for
   bit. (e) phase 7's first step under remat "dots" and "flash": K1 = K3
   = K4 = 12 x 2 each, loss and gradient norm the same bits as phase
   7's; the peak memory of each.

14. recommenders and the input pipeline (the twelfth slice; no kernel of
   its own, and none of K1-K6 launches: their counts are printed before
   and after). (a) Wide & Deep, ``wide_n_deep``, on the synthetic ML-1M
   (1,000,209 ratings, seed 0) with the reference app's columns (wide
   occupation 21, gender 3, the age-gender cross in 100 hash buckets;
   indicators genres 19, gender 3; userId 6040 -> 64 and itemId 3706 ->
   64 embeddings; age continuous; side columns drawn from
   ``default_rng(1)``), hidden 40-20-10, 5 classes, an 80/20
   ``train_test_split_by_user``, batch 8192, Adam 1e-3, bf16 with f32
   masters, streaming at ``prefetch_depth=2``, 4 epochs: the numpy
   features equal ``rows_to_batch`` on the first 10,000 rows; the first 8
   steps in f32 card vs CPU within 1e-5 relative; epoch 1 at depth 0 and
   a second card run at depth 2 bit-identical to the first run's epoch 1;
   ``evaluate``'s Top-1 accuracy equal to ``predict``'s argmax on the
   20%. (b) SessionRecommender (3706 items, item_embed 64, GRUs 40-20,
   MLP 40-20, session and history 10) on each user's ratings cut into
   windows of 11, the first 1000 users' last windows held out, batch
   1024, bf16, depth 2, 2 epochs: the f32 parity of 8 steps, two card
   runs bit-identical, ``recommend_for_session(10)`` of the trained
   weights in f32 on the card giving the CPU's items on the held-out
   sessions without ties (probabilities within 1e-5), the top-10 hit
   rate. (c) ``bench.py::run_data_pipeline``'s recipe (1024 byte records
   of 8192 float32s, the sort + matmul decoder, batch 128, Dense 768 relu
   x3 -> Dense 1, SGD at 1e-6, MSE, 3 epochs after a warm-up) at depth 0
   and 2: the async stream byte-identical to the sync one, the losses
   finite and bit-identical. Prints samples/s, step ms, DataWaitMs a step, accuracy,
   hit rate and peak memory (``[rec-wnd]``, ``[rec-session]``,
   ``[rec-pipeline]``), and the wall by part; ``--profile`` adds launches
   a step, the largest kernels, the H2D copies and their overlap with
   kernels, and one GRU time step's launches (``[profile-rec]``).

15. the serving remainder (the thirteenth slice), on phase 5's model (bf16,
   8 slots, page 16, max_seq_len 1024; rebuilt from seed 0) and phase 8's
   int8 ResNet-50, counts of K1, K2, K5 and K6 set to 0 just before each
   path, ``zoo_gen_*`` telemetry reset at the start. (a) 8 bulk streams
   (phase 5's first 8 prompts, 32 greedy tokens) fill the slots; at bulk
   0's fourth token 2 critical and 4 normal requests arrive (one with a
   deadline already past, one generous, one cancelled by uri while queued)
   and at its sixth bulk 1 is cancelled by uri: bulk streams equal an
   uninterrupted run (bulk 1's a prefix of it), both criticals end before
   the two bulk streams they preempted, nothing stays parked, the pool sums back, outcomes shed
   (retry_after_s >= 0.05) and cancelled, one ``admission.generation`` shed
   record on the flight recorder, K1 = 12 x prefills and K2 = 12 x decode
   steps; TTFT p50 by priority. (b) phase 5's burst under
   ``admit_policy="batch"`` and ``"continuous"`` in turns (b, c, c, b):
   identical streams, tokens/s and their ratio printed. (c) phase 5b's
   tenant traffic with prefix_cache_pages=256; after 64 emitted tokens
   another thread swaps to the weights x 1.01 (f32, cast to bf16) with
   spec k 4: every stream reaches its length, swaps 1, version "v2", the
   prefix index invalidated, ``host_params()`` the new weights bit for bit,
   a request after the swap equal to a fresh spec_k=4 batcher's; the time
   from ``swap_params`` to the first frame under the new weights. (d) 4
   threads predict fixed batches of 32 on the int8 ResNet-50 while
   ``swap_params`` re-packs the float params x 1.01: every output equals
   the old or the new model's bit for bit (computed beforehand),
   ``last_served_version`` moves, K5/K6 launch after the swap, no plain
   version runs; stage and gate-hold ms, images/s before, during and
   after (windows of 4 s before and after the swap, each predict's
   images counted by its overlap with the window, the predicts each window
   overlaps printed); phase 14b's SessionRecommender packed weight-only at
   min_elements 100000 (its two item tables) within 2e-2 of float, within
   1e-6 of the output's scale of a float model loaded with the tables'
   ``q * scale`` (a numpy quantization written out here), and holding the
   tables as int8 codes and scales alone. (e) a
   chaos kill of the decode loop at its 20th pass during phase 5's burst:
   one respawn, streams equal to (b)'s; NeuralCF at ML-1M's width served
   by InferenceModel, 100 user rows published by ``save_row_delta`` over a
   port checkpoint, read back and applied: untouched users bit-identical,
   all predictions equal a full swap's, the delta smaller than the base, a
   quantized model refusing it. (f) the registry's Prometheus text parses
   and its request, preemption, shed and swap counters equal phase 15's
   batchers' ``stats()``.
16. the serving data plane (the fourteenth slice), on a broker of the port
   started in this process, phase 8's calibrated ResNet-50 and phase 5's
   LM geometry. (a) ``ClusterServing`` over the int8 ResNet-50
   (``int8=True``, batch_size 32, concurrent_num 4, warmup_shape
   224x224x3): 4 client threads enqueue 256 seeded 224x224x3 f32 images
   (602 KB each, over the shm ring), 16 in flight a thread, and query them
   back: every uri answered once, no error record, each answer bit for bit
   the direct ``predict`` of its image (made in batches of 32: K5 and K6
   quantize per row), shm bytes > 0, K6 = 53 and K5 = 1 per batch the
   engine dispatched (counts set to 0 just before); images/s, latency p50
   and p99. (b) ``FrontEndApp``: 64 ``/predict`` requests of one image in
   queue mode and 64 in direct mode (``MicroBatcher``) from 4 threads each,
   every answer equal to (a)'s; ``/metrics`` parses and carries the
   zoo_broker_*, zoo_http_* and zoo_infer_* families; requests/s and p50.
   (c) ``ModelPublisher`` announces a checkpoint of the float weights x
   1.01 written by ``engine/checkpoint.py``; the engine's ``ModelSwapper``
   re-packs it and stages it on the card in one copy, probes the packed
   tensors (K5, K6) and flips them in while 4 threads keep enqueueing: every
   answer carries one version and equals that version's direct predict bit
   for bit, none begun after the flip is old; a NaN checkpoint is then
   rejected (``model_rejections`` gets a record) and the new version keeps
   answering; stage, probe and flip ms, images/s before, during and after
   (2 s windows of >= 30 requests). (d) ``GenerationEngine`` over phase 5's
   bf16 LM (8 slots, page 16, max_seq_len 1024) and phase 5's 16-request
   burst through ``GenerationClient``: every stream ok with 32 tokens,
   greedy streams equal to phase 5's direct ones (or argmax margin <= 0.1
   where one differs), K1 = 12 x prefills and K2 = 12 x decode steps
   (counts set to 0 just before); tokens/s, TTFT p50, ITL p50 and p95
   beside phase 5's. Prints the wall by part (``[data-plane]`` lines).
17. the serving control plane (the fifteenth slice), each part on a broker
   of its own, phase 16's 256 images and the int8 ResNet-50 replica config
   (batch 32, concurrency 4). (a) two thread replicas behind the
   ``ReplicaRouter`` (``FleetSupervisor``), phase 16a's burst,
   ``kill_replica("r0")`` once a third is answered: every uri answered once,
   bit for bit the direct predict, ``requeued > 0``, the fleet back to 2
   eligible, K6 = 53 and K5 = 1 per predict the replicas ran (counts set
   to 0 once both heartbeat). (c) on the same fleet under a 4-client
   load, ``ModelPublisher`` announces the weights x 1.01 (the canary
   swaps, validates, the rollout promotes) and then NaN weights (the
   canary refuses them, the rollout rolls back, one ``model_rejections``
   record); every answer equals its version's direct predict bit for bit.
   (b) two replica processes on the card (``fleet_spawn: process``,
   ``--device cuda``) load a bundle this phase wrote
   (``ImageClassifier.save_model``, ``InferenceModel.load_zoo``, int8 from
   the YAML config): the burst (images/s, p50, p99 beside 16a's), a
   rolling restart under load with every answer bit for bit, ``cli
   fleet-status`` and ``cli drain --replica r1``, spawn-to-first-heartbeat
   seconds. (e) the autoscaler grows a one-replica fleet to 2 under the
   burst and drains it back to 1 when idle, zero loss; two stand-in host
   agents as subprocesses (``--demo --device cuda``), one whole host
   killed mid-burst: zero loss, one ``fleet.host_failed`` event. (f)
   ``python -m analytics_zoo_tpu_torch.serving.stack --model <bundle>
   --int8 --replicas 2``: ``/readyz`` 200, ``/predict`` bit for bit,
   ``cli info`` and ``cli events``, SIGTERM with a request in flight
   answers it and exits 0. (d) two ``GenerationEngine`` replicas over
   phase 5's LM behind a round-robin router with an ITL objective: phase
   5's burst, greedy streams as in 16d, K1 = 12 x prefills and K2 = 12 x
   decode steps over both, ``itl_target_s`` set, ``/debug/slo`` listing
   the objective; tokens/s, TTFT, ITL beside 16d's. (g) ``HostRowCache``
   over a 1,000,000 x 64 f32 table with 65,536 hot rows on the card and
   48 Zipf(1.1) batches of 8192 ids: every gather byte-exact; hit rate,
   misses, evictions, gather ms. Prints the wall by part
   (``[control-plane]`` lines).
18. files and sets to the card (``[files-sets]`` lines). (a)
   ``init_zoo_context()`` on the card: one device, process 0 of 1, every
   mesh axis 1; then a ``ClusterLauncher`` of 2 CPU workers on gloo
   (``python -m analytics_zoo_tpu_torch.common.cluster``, logging to
   files) passes a barrier as ranks 0 and 1 of 2 and exits 0. (b) phase
   7's LM cell (bf16 with f32 masters, remat "flash", accumulation 2)
   trained 2 optimizer steps from two TFRecord shards that
   ``write_records``/``encode_example`` wrote, read by
   ``FeatureSet.from_tfrecord`` under ``profile_steps`` (a Chrome trace
   that must name the K1, K3 and K4 kernels) with one checkpoint and the
   TensorBoard summaries, then from an ``XShards`` of the same tokens in 4
   partitions (``FeatureSet.from_xshards``): each run's losses bit-identical
   to the same batches fed as arrays from the same initial weights, K1 = K3
   = K4 = 12 x 4 micro-steps a run (counts set to 0 before each), and the
   training metrics (steps, checkpoints, snapshot and write times, summary
   events, data batches, waits, log points, first dispatches, rollbacks,
   SIGTERM exits) at this run's counts. (c) ``TransformerLayer(1024, 16,
   causal, dropout=0.1)`` in training on (1, 256, 1024) f32, card vs CPU
   within 1e-4, the dropout masks bit-identical (and a ``Dropout``
   layer's). (d) ``TextClassifier`` at the news20 app's widths (sequence
   500, embedding 200, cnn encoder of 256 filters, 20 classes, a
   20000-word index) on 4096 seeded documents through ``TextSet``
   (tokenize, normalize, word index, shape) and ``fit(TextSet)``, 2
   epochs at batch 128: samples/s, step ms, peak memory, final loss; the
   first 5 losses within 1e-4 of the same run on the CPU in f32; the
   predictions after ``save_model`` and ``InferenceModel.load_zoo`` bit for
   bit. (e) 64 seeded 300x300 images (near the channel means, each with
   its own colour shift and gradient, so the softmax does not saturate
   and the classes differ) as an ``ImageSet`` through
   ``ImagenetConfig.preprocessing()`` into ``predict_image_set`` on the
   ResNet-50 cell's float model: the preprocessed arrays within 1e-3 of
   a plain resize (``F.interpolate``), centre crop and mean subtraction
   written here; every top-5 probability within 5e-4 of the CPU model's
   on those plain arrays, each top-5 class among the CPU's top classes
   and the top-1 equal wherever the CPU's top-2 margin exceeds 1e-3; no
   top-1 probability above 0.999 and more than one top-1 class across
   the images; top-5 lists equal to ``predict`` on the set's own arrays.
   Prints the wall by part.
19. multi-rank training (``[multi-rank]`` lines), on 4 rank processes
   sharing the card (``parallel/comm.py::RankPool``, gloo with CUDA
   tensors staged through pinned host buffers: NCCL refuses ranks on one
   card), spawned once, after the kernels were built. (a)
   ring, zigzag and Ulysses attention over sp=4, causal, at the LM cell's
   shape (B=2, T=2048, H=16, D=64), bf16, and the ring in f32: output and
   dq/dk/dv against the one-rank flash forward and K3/K4 backward on the
   same inputs within 2e-2 (bf16) and 1e-4 (f32, gradients relative to
   max(1, max|ref|)); K1 = K3 = K4 launches summed over the ranks 10
   (ring: idx + 1 a rank, future blocks skipped, each rank checked), 36
   (zigzag: 2n + 1 a rank) and 4 (Ulysses). (b) phase 7's model and
   precision (bf16, f32 masters, remat "flash", Adam, clipping 1.0),
   batch 4, 2 steps, over dp=4 with ``update_sharding="flat"`` and over
   sp=4 with ``attn_strategy="ring"``: per-step losses and every final
   parameter (rank 0's, against the saved one-rank run's) within 2e-2 of
   the one-rank run on this process; K1 = K3 = K4 = 96 (dp) and 240 (sp)
   over the ranks; the dp run's collectives: a reduce-scatter and an
   all-gather a step plus the comm probe's rounds, two all-reduces a step.
   (c) NCF at phase 12's width, its fused table row-sharded over dp=4
   against replicated, 8 f32 Adam steps of 8192 seeded pairs: losses
   within 1e-5, each rank holding 1/4 of the rows. (d)
   ``MoE(1024, 8 experts, top 2)`` in f32 on (2, 2048, 1024) at ep=4
   against ep=1, output and input gradient within 1e-4; the
   ``PipelinedTransformerLM`` of the LM cell's 12 blocks over pp=4 with 4
   micro-batches in bf16, logits within 2e-2 of the sequential
   ``TransformerLM`` with the same weights, K1 = 84 (3 blocks x 7 steps a
   rank). (e) an NCCL group at world size 1: one flat update exchange
   (its reduce-scatter, norm all-reduce and all-gather on NCCL) gives the
   plain Estimator step's parameters bit for bit. (f-h) (b)'s recipe
   with the JAX rules (``make_param_sharding``) placing the leaves:
   fsdp=4 and tp=4 on the 4 ranks, dp=2 x fsdp=2 x tp=2 with update
   sharding on 8 ranks of a second pool; each held to
   (b)'s one-rank reference (losses within 2e-2, the f32 masters gathered
   whole through the Estimator's ``_full`` within (b)'s Δ limit on every
   rank, (b)'s controls), its per-rank parameter elements (80,846,336,
   54,818,816 and 63,454,208), K1 = K3 = K4 = 12 x 2 a rank (96, 96, 192)
   and the (B, T, heads, D) shape every K1/K3/K4 call saw (a tp rank's
   16/tp heads). Prints each cell's wall, per-rank peak memory and
   collectives beside the card's name and power limit.
20. the analysis tier (``[analysis]`` lines), in a fresh interpreter (so
   the witness measures the phase's own device memory, not earlier
   phases' module caches), the allocator's peak restarted before each
   cell, the memory witness on (``ZOO_TPU_MEM_WITNESS``) for 20a-20c. (a) phase
   5's model (bf16, 8 slots, page 16): a ``ContinuousBatcher`` with
   ``hbm_budget_bytes`` of 1 MiB raises ``GraphLintError`` naming
   ``hbm-budget`` (before the witness starts); then batchers with
   ``graph_checks="raise"`` and the card's memory as budget (plain,
   ``spec_k=4``, ``prefill_chunk_tokens=128``) pass and launch nothing;
   the decode trace holds 12 K2 sites and the sampler, the verify trace
   12 K2, the chunk's 12 K2; 4 of phase 5's prompts x 16 tokens served
   through the checked batcher (K2 = 12 x decode steps, K1 = 12 x
   prefills, counts taken just before) give the tokens of a batcher built
   with ``graph_checks="off"``. (b) phase 8's ResNet-50, int8, at
   ``max_batch_size=1``: ``warm_up(sample, graph_checks="raise")`` (its
   one predict launches K6 53 times and K5 once; its checks launch
   nothing), the census 53 K6 and 1 K5 sites with no quantize op or int8
   tensor outside them, the static peak printed beside one batch-1
   predict's measured peak. (c) phase 7's cell (bf16, f32 masters, remat
   "flash", accumulation 2) with ``graph_checks="raise"`` and the card's
   memory as ``hbm_budget_mb``: the fit-start check alone leaves the
   parameters, optimizer state, step, key and ``zoo_train_*`` counters bit
   for bit and launches nothing; ``fit`` then trains 2 steps with K1 = K3
   = K4 = 12 x 4 micro-steps; ``donate_state=False`` under "warn" adds one
   ``donation-missed`` to ``zoo_analysis_findings_total``. (d) ``python -m
   analytics_zoo_tpu_torch.analysis --mem-witness`` on the dumped witness
   exits 0, with no ``hbm-budget`` or ``mem-witness-divergence`` finding,
   and the sites ``serving.decode``, ``inference.dispatch`` and
   ``estimator.step`` printed with their measured and static bytes. (e)
   ``python -m analytics_zoo_tpu_torch.analysis`` on the package exits 0.
   Each check's wall ms is printed beside the card's name and power limit.
21. the layer library (``[layers]`` lines). (a) ``ImageClassifier(
   "mobilenet")`` at full width (alpha 1.0, 224x224x3, 1000 classes; the
   MobileNet v1 of Howard et al., arXiv:1704.04861), seed 0,
   ``fit_image_set`` on a seeded ImageSet of 64 uint8 256x256 images
   (ImagenetConfig's preprocessing), SGD 0.01, batch 32, f32, 4 steps,
   BatchNormalization in training mode; the same fit for 2 steps on the
   CPU and on the card from weights each moved one ulp: step 1's loss and
   moving statistics within 1e-4 relative of the CPU's, step 2's within 4x
   the card's own one-ulp spread (at least 1e-4; the network at
   initialisation amplifies an update's rounding). (b) the trained model
   through ``InferenceModel(max_batch_size=32)``: the float predict within
   1e-4 of the CPU's on the same weights; ``quantize_int8`` (12 of the 13
   pointwise convs and the head packed; the stem, the first pointwise and
   the depthwise convs stay float) and a predict of 32 images: K6 = 12 and
   K5 = 1 (counts set to 0 just before), each launch's output bit for bit
   its plain version's on the card on the same inputs, each distinct shape
   timed device-only beside its bound; the top-1 agreement of int8 with
   float. (c) MobileNetV2 at full width, BN calibrated on 4 seeded images:
   a float predict of 8 images card vs CPU within 1e-4. (d) a Sequential of
   ResizeBilinear, DepthwiseConv2D, SeparableConvolution2D, LRN2D,
   ConvLSTM2D, an L2-regularized Dense and a CRF, trained 2 SGD steps on
   the CRF's NLL, card vs CPU: losses within 1e-4 relative, every
   parameter within 1e-4 of its leaf's largest. Prints the wall by part.

Phase 3 also holds the int8 kernels to their plain versions bit for bit
(``torch.equal``), f32 and bf16: the quantize pass both launch (codes and
scales against ``quantize_rows_plain``), K5 (the MLP's shapes with
block_k 512, a ragged M = 1000, groups off the 32 grid, a 3-D x, the
ResNet head on the lax route) and K6 (every one of ResNet-50's 20
distinct conv shapes at batch 2 and, f32, at batch 32, with Cin 48, a
3x3 at stride 2 on the lax route, VALID and a Cin <= 4 3x3 beside). It
times them beside their bounds at 1979 TOP/s int8 and a labelled library
call (``torch._int_mm``, the int8 product alone, Timer and device-only:
for K6's 3x3 over the im2col matrix of int8 codes; ``F.conv2d`` in bf16,
a float conv, beside it): K5 at the MLP's layers and the
ResNet head, K6 at the 3x3/1 64->64 and 1x1/1 256->64 at 56 px, the
1x1/2 512->1024 at 28 px and the 7x7/2 stem, device-only with ``--parent``
in turns parent, change, change, parent; and K6 device-only at each of
the 20 shapes at batch 32, times its launches a predict, summed
(``resnet50_device_ms_per_predict``; ``--profile`` prints the profiled
predict's K6 total beside).

The kernels line's ``launches`` are each kernel's count on its path (K1's
on training, with ``launches_by_path`` for serving and training, and
K1's, K3's and K4's for phase 13's resumed leg and remat "dots"; K2's on
phase 5's serving, with ``launches_by_path`` for serving and phase 5b's
spec, chunked, prefix and all arms; the
sampling kernel's on serving; K5's and K6's on the int8 serving burst,
with K5's per MLP predict beside it; K1's, K2's, K5's and K6's on phase
15 as ``launches_by_path["serving_remainder"]``, on phase 16 as
``launches_by_path["data_plane"]`` and on phase 17 as
``launches_by_path["control_plane"]``; K1's, K3's and K4's on phase 18b's
TFRecord- and XShards-fed runs as
``launches_by_path["training_from_files"]``; K1's, K3's and K4's summed
over phase 19's ranks and cells as ``launches_by_path["multi_rank"]``;
every kernel's on phase 20 (20a's checked serve, 20b's warm-up, 20c's
fit) as ``launches_by_path["analysis"]``; K5's and K6's on phase 21b's
int8 MobileNet predict as ``launches_by_path["mobilenet_predict"]``, with
each launch's shape, device ms and bound as ``mobilenet_head`` and
``mobilenet_shapes``).
The last three lines of standard output are the card's name and power
limit, the per-kernel JSON, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the repo's documented serving model (docs/programming-guide/generation.md)
VOCAB, HIDDEN, N_BLOCK, N_HEAD, SEQ_LEN = 32000, 1024, 12, 16, 2048
N_SLOTS, PAGE, MAX_SEQ = 8, 16, 1024
# the training phase: micro-batches of TRAIN_BATCH // GRAD_ACCUM sequences
TRAIN_BATCH, GRAD_ACCUM, TRAIN_SEQS, TRAIN_EPOCHS = 4, 2, 8, 4
HBM_BYTES_PER_S = 3.35e12
# H100 SXM dense peaks; int8 counts 2·M·N·K operations on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# sequence lengths at and around the flash kernels' 64-row tiles
EDGE_T = (1, 63, 64, 65, 127, 129)
# head dims besides 64 and 128 (examples/transformer_lm.py has 16, bench.py's
# small LMs 32), and K2's q_len and head-dim grids (the JAX package chunks
# prefill at 48, 64 and 128)
MORE_D = (8, 16, 32, 96, 160, 256)
# head dims off the 8 grid (bf16 K1/K3/K4 through one zero-padded copy, K2
# on its wide kernel) and past the compile-time tiles (the wide kernels)
WIDE_D = (4, 12, 20, 100, 264, 384, 512)
# the wide kernels' timed head dims
WIDE_TIMED = (264, 512)
K2_QLEN = (1, 16, 17, 48, 64, 128)
# K2's q_len on the serving features' paths past 128: chunks and the pow2
# suffix bucket of a prefix hit (up to max_seq_len)
K2_FEATURE_QLEN = (256, 512, 1024)
K2_D = (16, 32, 96)
# phase 5b: the serving features on the phase-5 model (tenants' shared
# prefixes as bench.py's prefix workload, bench.py:1644; the reference's
# widest documented chunk, bench.py:1812)
FEATURE_TENANTS, FEATURE_USERS, FEATURE_PREFIX = 4, 4, 480
FEATURE_ARMS = (
    ("plain", {}), ("spec", {"spec_k": 4}),
    ("chunked", {"prefill_chunk_tokens": 128}),
    ("prefix", {"prefix_cache_pages": 256}),
    ("all", {"spec_k": 4, "prefill_chunk_tokens": 128,
             "prefix_cache_pages": 256}))
# the int8 slice: ResNet-50 (ImageClassifier's default backbone) served by
# InferenceModel, and the int8 MLP of serving_bench.py (Dense 4096 relu,
# Dense 4096 relu, Dense 128 softmax at batch 2048)
IMG, CLASSES, IMG_BATCH, IMG_THREADS = 224, 1000, 32, 4
MLP_HIDDEN, MLP_CLASSES, MLP_BATCH = 4096, 128, 2048
# the NCF slice: bench.py's MovieLens-1M recipe (global batch 8192, 1000
# leave-one-out users), 4 epochs, the first 8 steps held to the CPU in f32
NCF_BATCH, NCF_EPOCHS, NCF_EVAL_USERS, NCF_PARITY_STEPS = 8192, 4, 1000, 8


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median CUDA-event time of ``fn`` over ``n`` launches after warm-up,
    with the L2 cache flushed (a 128 MiB write) before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, n: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


class DeviceTimer:
    """Device-only ms per call of ``fn``: torch.profiler's device time of
    the kernels ``n`` calls launch, after warm-up, with the L2 cache
    flushed before each call (the flush's own kernel left out), over
    ``n`` (a kernel whose trace lost one event counts the mean of the
    others). Unlike the Timer, no host work of the wrapper is in it."""

    def __init__(self, torch, flush):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.flush = torch, flush
        self.profile = lambda: profile(activities=[ProfilerActivity.CUDA])
        with self.profile() as prof:
            flush.zero_()
            torch.cuda.synchronize()
        self.skip = {key for key, _, _ in _device_rows(prof)[0]}

    def __call__(self, fn, n: int = 20) -> float:
        for _ in range(3):
            fn()
        # a trace now and then comes back without one of a kernel's
        # events (seen with K2 at decode: 19 of 20 launches): each call
        # launches the same kernels, k of each, so a kernel seen c times
        # counts its mean launch k = round(c / n) times a call, where c is
        # within one of k n; otherwise try again
        seen = []
        for _ in range(5):
            self.torch.cuda.synchronize()
            with self.profile() as prof:
                for _ in range(n):
                    self.flush.zero_()
                    fn()
                self.torch.cuda.synchronize()
            rows = [r for r in _device_rows(prof)[0] if r[0] not in self.skip]
            per_call = 0.0
            for _, c, ms in rows:
                k = round(c / n)
                if k == 0 or abs(c - k * n) > 1:
                    break
                per_call += ms / c * k
            else:
                if rows:
                    return per_call
            seen.append([(name[:60], c) for name, c, _ in rows])
        raise AssertionError(f"the profiler saw no whole trace of {n} calls:"
                             f" kernels and counts seen {seen}")


def maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------- phases

def phase_device(torch):
    smi = smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32} -> both set False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def load_parent(path):
    """``--parent DIR``: the port package of another checkout (the parent
    commit, unpacked with ``git archive``), imported as ``parent_port``
    beside this one, so that its K1-K6 are timed in the same process,
    on the same inputs, by the same Timer. Its kernels build from its own
    sources into its own ``_build/``."""
    import importlib
    import importlib.util
    import types

    pkg = Path(path).resolve() / "analytics_zoo_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(
        root=str(pkg.parent),
        build=importlib.import_module("parent_port.ops._build"),
        flash=importlib.import_module("parent_port.ops.flash_attention"),
        paged=importlib.import_module("parent_port.ops.paged_attention"),
        int8=importlib.import_module("parent_port.ops.int8_fused"))


def phase_build(parent=None):
    from analytics_zoo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    errors = []
    if parent is not None:
        # the parent's K1-K6 sources build beside this checkout's
        def build_parent():
            try:
                parent.build.build(["flash_fwd", "flash_bwd",
                                    "paged_attention", "int8_matmul",
                                    "int8_conv"])
            except Exception as e:            # raised below
                errors.append(e)

        side = threading.Thread(target=build_parent)
        side.start()
    secs = _build.build()
    if parent is not None:
        side.join()
        if errors:
            raise errors[0]
        log(f"[build] parent {parent.root}: flash_fwd, flash_bwd, "
            f"paged_attention, int8_matmul, int8_conv")
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s into {_build.BUILD_DIR}")
    for name, text in _build.BUILD_LOG.items():
        entry = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = _kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {entry}: {line.strip()}")
    for lib, kernels in (("flash_fwd", ("flash_fwd_wgmma_kernel",)),
                         ("flash_bwd", ("flash_bwd_dq_wgmma_kernel",
                                        "flash_bwd_dkv_wgmma_kernel"))):
        check_wgmma_sass(_build, lib, kernels)
    check_imma_sass(_build)


def _sass_functions(_build, lib: str):
    """(mangled name, SASS text) of every function in a built library, from
    ``cuobjdump -sass``."""
    cuobjdump = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return [(part.split("\n", 1)[0].strip(), part)
            for part in sass.split("Function : ")[1:]]


def check_wgmma_sass(_build, lib: str, kernels):
    """The bf16 K1, K3 and K4 must run on wgmma (HGMMA) fed by TMA
    (UTMALDG): read from ``cuobjdump -sass`` of the built library, every
    compiled instance of each of ``kernels``."""
    found = {k: [] for k in kernels}
    for name, part in _sass_functions(_build, lib):
        for k in kernels:
            if k in name:
                found[k].append((part.count("HGMMA"), part.count("UTMALDG")))
    log(f"[build] {lib} SASS (HGMMA, UTMALDG) per instance: {found}")
    for k, counts in found.items():
        if not counts or not all(a and b for a, b in counts):
            raise AssertionError(f"{k} does not run on HGMMA fed by UTMALDG")


def check_imma_sass(_build):
    """K5's and K6's products must run on the int8 tensor cores: every
    compiled instance of ``gemm_kernel`` (mma.sync) in both libraries
    holds IMMA, every one of K5's ``matmul_wgmma_kernel`` IGMMA, and none
    IDP (__dp4a). K6's Cin <= 4 kernel (``conv_dp4a_kernel``) is the one
    __dp4a loop, and is listed beside."""
    kinds = (("wgmma_kernel", "IGMMA"), ("gemm_kernel", "IMMA"),
             ("dp4a_kernel", "IDP"))
    for lib in ("int8_matmul", "int8_conv"):
        counts = []
        for name, part in _sass_functions(_build, lib):
            for kind, op in kinds:
                if kind in name:
                    counts.append((kind, op, part.count(op),
                                   part.count("IDP")))
                    break
        log(f"[build] {lib} SASS (kernel, op, op count, IDP) per instance: "
            f"{counts}")
        gemms = [c for c in counts if c[0] != "dp4a_kernel"]
        if not gemms or not all(n and not idp for _, _, n, idp in gemms):
            raise AssertionError(f"{lib}: a GEMM instance does not run on "
                                 f"the int8 tensor cores alone")


def _kernel_label(mangled: str) -> str:
    """'flash_bwd_dq_kernel<f32,64>' (or 'gumbel_max_kernel', not a
    template) from a mangled entry name."""
    m = re.search(r"([a-z][a-z_]*_kernel)(I?)", mangled)
    if m and not m.group(2):
        return m.group(1)
    d = re.search(r"Li(\d+)E", mangled)
    dt = "bf16" if "bfloat16" in mangled else "f32"
    return (f"{m.group(1)}<{dt},{d.group(1) if d else '?'}>" if m
            else mangled[:40])


def check_k1(torch, timer, dtimer, parent=None):
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    dts = ("float32", "bfloat16")
    cases = [(t, 64, dt, True) for t in (16, 100, 1024) for dt in dts]
    cases += [(100, 128, dt, True) for dt in dts]
    cases += [(t, d, dt, causal) for t in EDGE_T
              for d in (64, 128) + MORE_D + WIDE_D
              for dt in dts for causal in (False, True)]
    for t, d, dt, causal in cases:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((1, t, N_HEAD, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        e_out, e_lse = maxerr(out, ref), maxerr(lse, ref_lse)
        ok = e_out <= TOL[dt] and e_lse <= TOL[dt]
        log(f"[K1] T={t} D={d} {dt} causal={causal}: max|d out| "
            f"{e_out:.3g} max|d lse| {e_lse:.3g} (tol {TOL[dt]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"T={t} D={d} {dt} causal={causal}")
    # timed at the longest prefill bucket of the serving path, in bf16
    t, d, dt = 1024, 64, "bfloat16"
    q, k, v = (torch.randn((1, t, N_HEAD, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out, lse = flash_attention_fwd(q, k, v, True)
    ref, ref_lse = flash_attention_plain(q, k, v, True)
    worst = max(maxerr(out, ref), maxerr(lse, ref_lse))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = timer(lambda: flash_attention_fwd(q, k, v, True))
    plain = timer(lambda: flash_attention_plain(q, k, v, True))
    lib = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    lib_dev = dtimer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    fns = [lambda: flash_attention_fwd(q, k, v, True)]
    parent_ms = parent_hus = None
    if parent is not None:
        pk = parent.flash.flash_attention_fwd
        parent_ms = timer(lambda: pk(q, k, v, True))
        fns.append(lambda: pk(q, k, v, True))
    hus, *rest = host_us(fns)
    dev_s = dtimer(fns[0])
    parent_dev_s = None
    if rest:
        parent_hus = rest[0]
        parent_dev_s = dtimer(fns[1])
    elt = 2
    nbytes = 4 * t * N_HEAD * d * elt + N_HEAD * t * 4
    flops = 4 * N_HEAD * d * (t * (t + 1) // 2)
    bms, by = bound_ms(nbytes, flops, dt)
    log(f"[K1] B=1 T={t} H={N_HEAD} D={d} causal {dt} (serving): {ms:.4f} "
        f"ms, device {dev_s:.4f} (parent {parent_ms}, device {parent_dev_s};"
        f" plain {plain:.4f}, bound {bms:.5f} by {by}), SDPA {lib:.4f} ms, "
        f"device {lib_dev:.4f} ms; wrapper host {hus:.1f} us (parent "
        f"{parent_hus})")
    # and at the training micro-batch, q/k/v strided out of one fused QKV
    # tensor as the model hands them over
    b, t = TRAIN_BATCH // GRAD_ACCUM, SEQ_LEN
    qkv = torch.randn((b, t, 3, N_HEAD, d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out, lse = flash_attention_fwd(q, k, v, True)
    ref, ref_lse = flash_attention_plain(q, k, v, True)
    e_train = max(maxerr(out, ref), maxerr(lse, ref_lse))
    del out, lse, ref, ref_lse
    if e_train > TOL[dt]:
        raise AssertionError(f"K1 disagrees with its plain version at the "
                             f"training shape: {e_train:.3g}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    tt = in_turns(timer, dtimer, lambda: flash_attention_fwd(q, k, v, True),
                  parent and (lambda: parent.flash.flash_attention_fwd(
                      q, k, v, True)))
    plain_t = timer(lambda: flash_attention_plain(q, k, v, True), n=5)
    lib_t = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True))
    lib_dev_t = dtimer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    b_t, by_t = bound_ms(4 * b * t * N_HEAD * d * elt + b * N_HEAD * t * 4,
                         4 * b * N_HEAD * d * (t * (t + 1) // 2), dt)
    label = f"B={b} T={t} H={N_HEAD} D={d}"
    log(f"[K1] {label} causal {dt} (training shape): {tt['ms']:.4f} ms, "
        f"device {tt['device_ms']:.4f} ms (turns {tt['device_ms_turns']}; "
        f"parent {tt['parent_ms']}, device {tt['parent_device_ms']} (turns "
        f"{tt['parent_device_ms_turns']}); plain {plain_t:.4f}, bound "
        f"{b_t:.5f} by {by_t}), SDPA forward {lib_t:.4f} ms, device "
        f"{lib_dev_t:.4f} ms; max err {e_train:.3g}")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "analytics_zoo_tpu/ops/flash_attention.py:46",
            "cuda_kernels": ("bf16: flash_fwd_wgmma_kernel (wgmma, TMA); "
                             "f32: flash_fwd_kernel"),
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "library_device_ms": lib_dev,
            "device_ms": dev_s, "parent_ms": parent_ms,
            "parent_device_ms": parent_dev_s, "host_us": hus,
            "parent_host_us": parent_hus,
            "shape": f"B=1 T=1024 H={N_HEAD} D={d} causal", "dtype": dt,
            "training_shape": {
                "max_abs_err": e_train, **tt, "plain_ms": plain_t,
                "bound_ms": b_t, "bound_by": by_t, "library_ms": lib_t,
                "library_device_ms": lib_dev_t,
                "shape": f"{label} causal", "dtype": dt}}


def in_turns(timer, dtimer, fn, parent_fn=None, n: int = 30):
    """``fn`` timed device-only (``dtimer``) and in the Timer (``n``
    launches); with ``parent_fn``, in turns parent, change, change, parent
    on the same card in one process. Returns the medians and each turn's
    device time."""
    turns = [("change", fn)]
    if parent_fn is not None:
        turns = [("parent", parent_fn)] + turns * 2 + [("parent", parent_fn)]
    dev = {"change": [], "parent": []}
    tim = {"change": [], "parent": []}
    for who, f in turns:
        dev[who].append(dtimer(f))
        tim[who].append(timer(f, n=n))
    med = lambda xs: statistics.median(xs) if xs else None  # noqa: E731
    return {"ms": med(tim["change"]), "device_ms": med(dev["change"]),
            "device_ms_turns": dev["change"], "parent_ms": med(tim["parent"]),
            "parent_device_ms": med(dev["parent"]),
            "parent_device_ms_turns": dev["parent"]}


def _k2_case(torch, gen, lengths, q_len, page=PAGE, dtype="bfloat16",
             d=HIDDEN // N_HEAD):
    from analytics_zoo_tpu_torch.ops.paged_attention import \
        synthetic_paged_case

    return synthetic_paged_case(
        N_SLOTS, MAX_SEQ // page, page, N_HEAD, d, q_len=q_len,
        dtype=getattr(torch, dtype), lengths=lengths, device="cuda",
        generator=gen)


def host_us(fns, n: int = 200, rounds: int = 5):
    """Host microseconds per call of each of ``fns``, enqueue only (no
    sync inside the window): the wrapper's Python and launch work, which
    a Timer window holds wherever it outlasts the L2 flush on the device.
    The median of ``rounds`` rounds of ``n`` calls, the functions in
    turns, so that a slow spell of the host falls on both."""
    import torch

    times = [[] for _ in fns]
    for fn in fns:
        fn()
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return [statistics.median(t) for t in times]


def _k2_feature_case(torch, gen, q_len, kind, dtype):
    """K2's inputs as the serving features hand them over: ``"ladder"``,
    slots at 0 and at least q_len (a long chunk or suffix bucket);
    ``"wide"``, a chunk's table (``pages_per_slot`` + 8 entries, the extra
    ones scratch) with lengths reaching into the scratch entries, as the
    chunk's padding rows do; ``"past"``, the suffix prefill of a prefix
    hit, whose lengths (start + bucket) pass ``pages_per_slot *
    page_size``, so the kernel clamps the span to the table."""
    cap = MAX_SEQ
    want = {"ladder": [0, 37, 130, 255, 400, 600, 777, 1024],
            "wide": [0, 128, 300, 640, 1000, 1024, 1100, 1152],
            "past": [0, 1024, 1100, 1504, 1504, 2047, 1030, 1200]}[kind]
    want = [max(n, q_len) if n else 0 for n in want]
    q, kp, vp, table, lens = _k2_case(torch, gen, [min(n, cap) for n in want],
                                      q_len, dtype=dtype)
    if kind == "wide":
        table = torch.cat([table, torch.zeros_like(table[:, :8])], 1) \
            .contiguous()
    lens = torch.tensor(want, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, lens


def _k2_one_slot(torch, gen, q_len, length, extra_pages=0):
    """One slot of ``length`` valid positions (q_len of them new), bf16,
    on a pool of ``pages_per_slot`` pages (+ ``extra_pages`` scratch table
    entries): the chunk and suffix shapes of the serving features."""
    cap = MAX_SEQ
    q, kp, vp, table, _ = _k2_case(torch, gen, [min(length, cap)] + [0] * 7,
                                   q_len)
    table = table[:1]
    if extra_pages:
        table = torch.cat([table, torch.zeros_like(table[:, :extra_pages])],
                          1)
    lens = torch.tensor([length], dtype=torch.int32, device="cuda")
    return q[:1].contiguous(), kp, vp, table.contiguous(), lens


def _k2_timed(torch, timer, dtimer, label, case, parent=None):
    """K2 at one bf16 shape: the Timer and device-only times beside its
    plain version, SDPA over the K/V gathered beforehand with a length
    mask, the bound from these inputs and (``--parent``, q_len <= 16) the
    parent's kernel; the wrapper's host microseconds."""
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch.ops.kv_cache import paged_read
    from analytics_zoo_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)

    q, kp, vp, table, lens = case
    b, q_len, h, d = q.shape
    out = paged_attention(*case, page_size=PAGE)
    err = maxerr(out, paged_attention_plain(*case, page_size=PAGE))
    if err > TOL["bfloat16"]:
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"the timed {label} shape: {err:.3g}")
    ks, vs = paged_read(kp, table), paged_read(vp, table)
    bound = (lens.long()[:, None] - q_len
             + torch.arange(q_len, device="cuda")[None])      # (B, q_len)
    mask = (torch.arange(ks.shape[1], device="cuda")[None, None, :]
            <= bound[:, :, None])[:, None]                   # (B,1,q,T)
    qt, kt, vt = q.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)
    ms = timer(lambda: paged_attention(*case, page_size=PAGE))
    dev = dtimer(lambda: paged_attention(*case, page_size=PAGE))
    plain = timer(lambda: paged_attention_plain(*case, page_size=PAGE))
    lib = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask))
    lib_dev = dtimer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    fns = [lambda: paged_attention(*case, page_size=PAGE)]
    parent_ms = parent_hus = parent_dev = None
    if parent is not None and q_len <= 16:
        pk = parent.paged.paged_attention
        parent_ms = timer(lambda: pk(*case, page_size=PAGE))
        parent_dev = dtimer(lambda: pk(*case, page_size=PAGE))
        fns.append(lambda: pk(*case, page_size=PAGE))
    hus, *rest = host_us(fns)
    if rest:
        parent_hus = rest[0]
    # what these inputs need: each slot's positions up to its length, at
    # most the table's (the kernel clamps there), each read once
    n_pos = lens.long().clamp(max=table.shape[1] * PAGE)
    pairs = int(torch.minimum((bound + 1).clamp(min=0),
                              n_pos[:, None]).sum())   # (row, position)
    elt = 2
    nbytes = (2 * int(n_pos.sum()) * h * d * elt          # K and V read
              + 2 * b * q_len * h * d * elt               # q in, out
              + int((-(-n_pos // PAGE)).sum()) * 4 + b * 4)
    flops = 4 * h * d * pairs
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"[K2] {label} q_len={q_len} bf16: {ms:.4f} ms, device "
        f"{dev:.4f} ms (parent {parent_ms}, device {parent_dev}; plain "
        f"{plain:.4f}, bound {bms:.5f} by {by}), "
        f"SDPA {lib:.4f} ms, device {lib_dev:.4f} ms; wrapper host "
        f"{hus:.1f} us (parent {parent_hus}); max err {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "library_device_ms": lib_dev,
            "parent_ms": parent_ms,
            "parent_device_ms": parent_dev, "host_us": hus,
            "parent_host_us": parent_hus,
            "shape": (f"slots={b} table={table.shape[1]} pool_pps="
                      f"{MAX_SEQ // PAGE} page={PAGE} H={h} D={d} "
                      f"q_len={q_len} lengths={lens.tolist()}"),
            "dtype": "bfloat16"}


def check_k2(torch, timer, dtimer, parent=None):
    """K2 against its plain version: f32 and bf16 at q_len 1, 4 and 16 on
    a ladder with a zero-length slot, bf16 at pages of 8 and 32 too, then
    at q_len 1, 16, 17, 48, 64 and 128 and at head dims 16, 32 and 96 (a
    live slot at least q_len long, as every caller makes it); then at the
    serving features' q_len and tables: q_len 256, 512 and 1024, q_len 128
    on a chunk's wide table (8 scratch entries past the pool's pages, the
    lengths reaching into them) and q_len 1024 with lengths past the
    table (a prefix hit's suffix; the kernel clamps the span). Then timed
    in bf16 at the decode shape (q_len 1, a half-full ladder: the kernels
    line), at q_len 16 and 64 on the same ladder, on 8 full-length (1024)
    slots, and at the serving features' shapes: the verify step (q_len 4,
    the half-full ladder), a chunk (q_len 128 on one slot with 512 cached,
    the wide table) and a suffix (q_len 1024 on one slot after a 480-token
    hit), each beside its plain version, SDPA over the pre-gathered K/V
    with a length mask, its bound, its device-only time and (``--parent``)
    the parent's kernel (which takes q_len up to 16)."""
    from analytics_zoo_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)

    gen = torch.Generator().manual_seed(2)
    # a zero-length (inactive) slot among a ladder of live lengths
    lengths = [0, 37, 130, 255, 400, 600, 777, 1024]
    checks = [(dt, q_len, PAGE) for dt in ("float32", "bfloat16")
              for q_len in (1, 4, 16)]
    checks += [("bfloat16", q_len, page) for page in (8, 32)
               for q_len in (1, 16)]
    checks = [(dt, q_len, page, HIDDEN // N_HEAD)
              for dt, q_len, page in checks]
    checks += [(dt, q_len, PAGE, d) for dt in ("float32", "bfloat16")
               for q_len, d in [(n, HIDDEN // N_HEAD) for n in K2_QLEN]
               + [(n, d) for d in K2_D + WIDE_D for n in (1, 17, 64)]]
    for dt, q_len, page, d in checks:
        lens = [max(n, q_len) if n else 0 for n in lengths]
        case = _k2_case(torch, gen, lens, q_len, page, dt, d)
        out = paged_attention(*case, page_size=page)
        ref = paged_attention_plain(*case, page_size=page)
        torch.cuda.synchronize()
        e = maxerr(out, ref)
        zero = float(out[0].float().abs().max())
        ok = e <= TOL[dt] and zero == 0.0
        log(f"[K2] slots={N_SLOTS} pps={MAX_SEQ // page} page={page} "
            f"q_len={q_len} D={d} {dt}: max|d| {e:.3g} (tol {TOL[dt]}), "
            f"zero-length slot max|out| {zero} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version "
                                 f"at q_len={q_len} page={page} D={d} {dt}")
    feature = [(dt, q_len, "ladder") for dt in ("float32", "bfloat16")
               for q_len in K2_FEATURE_QLEN]
    feature += [(dt, 128, "wide") for dt in ("float32", "bfloat16")]
    feature += [(dt, 1024, "past") for dt in ("float32", "bfloat16")]
    for dt, q_len, kind in feature:
        case = _k2_feature_case(torch, gen, q_len, kind, dt)
        out = paged_attention(*case, page_size=PAGE)
        ref = paged_attention_plain(*case, page_size=PAGE)
        torch.cuda.synchronize()
        e = maxerr(out, ref)
        zero = float(out[0].float().abs().max())
        finite = bool(torch.isfinite(out).all())
        ok = e <= TOL[dt] and zero == 0.0 and finite
        log(f"[K2] {kind} table={case[3].shape[1]} q_len={q_len} {dt} "
            f"lengths={case[4].tolist()}: max|d| {e:.3g} (tol {TOL[dt]}), "
            f"zero-length slot max|out| {zero} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version on "
                                 f"the {kind} case at q_len={q_len} {dt}")
        del case, out, ref
    timed = {}
    # the decode shape of the serving path (q_len 1, bf16) with a half-full
    # ladder of lengths (the steady serving regime), then q_len 16 and 64
    # on the same ladder, then every slot at the full context; then the
    # serving features' shapes
    for label, q_len, lens_in in (("decode", 1, None), ("q_len16", 16, None),
                                  ("q_len64", 64, None),
                                  ("full_context", 1, [MAX_SEQ] * N_SLOTS),
                                  ("verify_q4", 4, None)):
        timed[label] = _k2_timed(torch, timer, dtimer, label,
                                 _k2_case(torch, gen, lens_in, q_len), parent)
    timed["chunk_q128"] = _k2_timed(
        torch, timer, dtimer, "chunk_q128",
        _k2_one_slot(torch, gen, 128, 512 + 128, extra_pages=128 // PAGE),
        parent)
    timed["suffix_q1024"] = _k2_timed(
        torch, timer, dtimer, "suffix_q1024",
        _k2_one_slot(torch, gen, 1024, 480 + 1024), parent)
    main = timed.pop("decode")
    return {"name": "paged_attention", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "analytics_zoo_tpu/ops/paged_attention.py:113",
            "cuda_kernels": ("bf16: paged_attn_mma_kernel; f32: "
                             "paged_attn_kernel"),
            "launches": None, **main,
            "library_note": ("SDPA with a length mask over K/V gathered "
                             "beforehand (the gather not timed)"),
            **timed}


def _bwd_case(torch, gen, b, t, d, dtype, causal, h=N_HEAD):
    """q, k, v as strided views of one fused (B, T, 3, H, D) tensor (as the
    QKV projection hands them over), K1's out and LSE, a random output
    grad and δ."""
    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_bwd_delta)

    qkv = torch.randn((b, t, 3, h, d), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = flash_attention_fwd(q, k, v, causal)
    g = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, g, lse, flash_bwd_delta(out, g)


def _rel_err(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|): bf16 gradients reach
    magnitudes where one bf16 ulp exceeds the absolute tolerance."""
    return maxerr(got, ref) / max(1.0, float(ref.float().abs().max()))


def _check_bwd_case(torch, case, causal, dt, label):
    """K3 and K4 on one case against their plain versions, each error
    relative; raises on a disagreement. Returns the absolute max errors
    (dq, worst of dk and dv)."""
    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain)

    dq = flash_attention_bwd_dq(*case, causal)
    dk, dv = flash_attention_bwd_dkv(*case, causal)
    rq = flash_attention_bwd_dq_plain(*case, causal)
    e3, a3 = _rel_err(dq, rq), maxerr(dq, rq)
    del dq, rq
    rk, rv = flash_attention_bwd_dkv_plain(*case, causal)
    torch.cuda.synchronize()
    e4 = max(_rel_err(dk, rk), _rel_err(dv, rv))
    a4 = max(maxerr(dk, rk), maxerr(dv, rv))
    ok = e3 <= TOL[dt] and e4 <= TOL[dt]
    log(f"[K3/K4] {label} {dt} causal={causal}: rel max|d dq| {e3:.3g} "
        f"rel max|d dk,dv| {e4:.3g} (tol {TOL[dt]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K3/K4 disagree with their plain versions at "
                             f"{label} {dt} causal={causal}")
    return a3, a4


def _train_shape_bwd(torch, timer, dtimer, gen, b, d=HIDDEN // N_HEAD,
                     parent=None):
    """K1, K3 and K4 at one training shape (B=b, T=2048, H=16, D=d,
    causal, bf16, q/k/v strided out of one fused QKV tensor): held to
    their plain versions with the grid's tolerances, K3 and K4 called
    twice on the same inputs must give the same bits, then K3/K4 timed
    (Timer and device-only; with ``--parent`` in turns with the parent's
    K3 and K4) beside their plain versions, SDPA's backward (also
    device-only), their bounds and each wrapper's host microseconds (and
    the parent's)."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
        flash_attention_fwd, flash_attention_plain)

    t, dt = SEQ_LEN, "bfloat16"
    label = f"B={b} T={t} H={N_HEAD} D={d}"
    case = _bwd_case(torch, gen, b, t, d, torch.bfloat16, True)
    q, k, v, g, lse, delta = case
    out, lse1 = flash_attention_fwd(q, k, v, True)
    ref, ref_lse = flash_attention_plain(q, k, v, True)
    e_out, e_lse = maxerr(out, ref), maxerr(lse1, ref_lse)
    del out, lse1, ref, ref_lse
    ok = e_out <= TOL[dt] and e_lse <= TOL[dt]
    log(f"[K1] {label} {dt} causal (training shape): max|d out| {e_out:.3g} "
        f"max|d lse| {e_lse:.3g} (tol {TOL[dt]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{label} {dt}")
    err3, err4 = _check_bwd_case(torch, case, True, dt,
                                 f"{label} (training shape)")
    k3 = lambda: flash_attention_bwd_dq(*case, True)     # noqa: E731
    k4 = lambda: flash_attention_bwd_dkv(*case, True)    # noqa: E731
    first, again = ((k3(), *k4()) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"K3/K4 gave other bits on a repeated call at "
                             f"{label}")
    del first, again
    p3 = p4 = None
    if parent is not None:
        p3 = lambda: parent.flash.flash_attention_bwd_dq(   # noqa: E731
            *case, True)
        p4 = lambda: parent.flash.flash_attention_bwd_dkv(  # noqa: E731
            *case, True)
    t3 = in_turns(timer, dtimer, k3, p3, n=20)
    t4 = in_turns(timer, dtimer, k4, p4, n=20)
    hus = host_us([k3, k4] + ([p3, p4] if parent else []))
    t3["host_us"], t4["host_us"] = hus[:2]
    t3["parent_host_us"], t4["parent_host_us"] = (hus[2:] if parent
                                                  else (None, None))
    plain3 = timer(lambda: flash_attention_bwd_dq_plain(*case, True), n=5)
    plain4 = timer(lambda: flash_attention_bwd_dkv_plain(*case, True), n=5)
    # the library yardstick: SDPA's backward (dQ, dK and dV in one call),
    # its forward taken outside the timed window
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    go = g.transpose(1, 2)
    lib = timer(lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                            retain_graph=True), n=20)
    lib_dev = dtimer(lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                                 retain_graph=True))
    del o
    pairs = b * N_HEAD * (t * (t + 1) // 2)
    elt = 2
    tens = b * t * N_HEAD * d * elt                 # one (B, T, H, D) tensor
    rows = 2 * b * N_HEAD * t * 4                   # lse and delta, f32
    b3, by3 = bound_ms(5 * tens + rows, 6 * d * pairs, dt)
    b4, by4 = bound_ms(6 * tens + rows, 8 * d * pairs, dt)
    for name, t, plain, bms, by in (("K3", t3, plain3, b3, by3),
                                    ("K4", t4, plain4, b4, by4)):
        log(f"[K3/K4] {label} causal {dt}: {name} {t['ms']:.4f} ms, device "
            f"{t['device_ms']:.4f} (turns {t['device_ms_turns']}; parent "
            f"{t['parent_ms']}, device {t['parent_device_ms']} (turns "
            f"{t['parent_device_ms_turns']}); plain {plain:.4f}, bound "
            f"{bms:.5f} by {by}); wrapper host {t['host_us']:.1f} us "
            f"(parent {t['parent_host_us']})")
    log(f"[K3/K4] {label} causal {dt}: SDPA backward {lib:.4f} ms, device "
        f"{lib_dev:.4f}; K3 + K4 device {t3['device_ms'] + t4['device_ms']:.4f}")
    common = {"library_ms": lib, "library_device_ms": lib_dev,
              "shape": f"{label} causal", "dtype": dt}
    return ({"max_abs_err": err3, **t3, "plain_ms": plain3, "bound_ms": b3,
             "bound_by": by3, **common},
            {"max_abs_err": err4, **t4, "plain_ms": plain4, "bound_ms": b4,
             "bound_by": by4, **common})


def check_k3_k4(torch, timer, dtimer, parent=None):
    """K3 (dQ) and K4 (dK, dV) against their plain versions over the grid
    (and at the head dims of ``MORE_D`` on the tile edges), then at the
    training micro-batch (B=2, the shape the main path launches them at),
    at the whole batch (B=4) and at the micro-batch with D=128, each
    checked and timed; the kernels line carries the micro-batch's numbers.
    Errors are relative to max(1, max|plain|)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    grid = [(b, d, t) for b in (1, 2) for d in (64, 128)
            for t in (16, 100, 1024) + (EDGE_T if b == 2 else ())]
    grid += [(2, d, t) for d in MORE_D + WIDE_D for t in EDGE_T]
    for b, d, t in grid:
        for causal in (False, True):
            for dt in ("float32", "bfloat16"):
                case = _bwd_case(torch, gen, b, t, d, getattr(torch, dt),
                                 causal)
                _check_bwd_case(torch, case, causal, dt,
                                f"B={b} T={t} D={d}")
                del case
    micro = TRAIN_BATCH // GRAD_ACCUM
    k3, k4 = _train_shape_bwd(torch, timer, dtimer, gen, micro,
                              parent=parent)
    w3, w4 = _train_shape_bwd(torch, timer, dtimer, gen, TRAIN_BATCH,
                              parent=parent)
    h3, h4 = _train_shape_bwd(torch, timer, dtimer, gen, micro, d=128,
                              parent=parent)
    lib_note = ("SDPA backward via torch.autograd.grad: dQ, dK and dV in "
                "one call, shared by K3 and K4")
    return [
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "analytics_zoo_tpu/ops/flash_attention.py:191",
         "cuda_kernels": ("bf16: flash_bwd_dq_mma_kernel; f32: "
                          "flash_bwd_dq_kernel"),
         "launches": None, **k3, "library_note": lib_note,
         "whole_batch": w3, "head_dim_128": h3},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "analytics_zoo_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "analytics_zoo_tpu/ops/flash_attention.py:222",
         "cuda_kernels": ("bf16: flash_bwd_dkv_mma_kernel; f32: "
                          "flash_bwd_dkv_kernel"),
         "launches": None, **k4, "library_note": lib_note,
         "whole_batch": w4, "head_dim_128": h4}]


def check_wide(torch, timer, dtimer):
    """The wide-head kernels of K1, K3, K4 and K2 (head dims past the
    compile-time tiles) at WIDE_TIMED head dims, bf16: K1/K3/K4 at the
    serving prefill's B=1 T=1024 H=16 causal, K2 at the decode shape (q_len
    1, a half-full ladder); each held to its plain version and timed
    (Timer and device-only) beside it, its bound and one library call
    (SDPA's forward or backward; for K2 SDPA over the gathered K/V).
    Returns ``{kernel name: {"D=<d>": {...}}}``."""
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.ops.kv_cache import paged_read
    from analytics_zoo_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, t, dt, elt = 1, 1024, "bfloat16", 2
    pairs = b * N_HEAD * (t * (t + 1) // 2)
    found = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {},
             "paged_attention": {}}
    for d in WIDE_TIMED:
        case = _bwd_case(torch, gen, b, t, d, torch.bfloat16, True)
        q, k, v, g, lse, delta = case
        tens = b * t * N_HEAD * d * elt
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        go = g.transpose(1, 2)
        sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
        sdpa_bwd = lambda: torch.autograd.grad(             # noqa: E731
            o, (qt, kt, vt), go, retain_graph=True)
        rows = [
            ("flash_fwd", lambda: fa.flash_attention_fwd(q, k, v, True)[0],
             lambda: fa.flash_attention_plain(q, k, v, True)[0],
             4 * tens, 4 * d * pairs, sdpa_fwd),
            ("flash_bwd_dq", lambda: fa.flash_attention_bwd_dq(*case, True),
             lambda: fa.flash_attention_bwd_dq_plain(*case, True),
             5 * tens, 6 * d * pairs, sdpa_bwd),
            ("flash_bwd_dkv",
             lambda: fa.flash_attention_bwd_dkv(*case, True)[0],
             lambda: fa.flash_attention_bwd_dkv_plain(*case, True)[0],
             6 * tens, 8 * d * pairs, sdpa_bwd)]
        for name, fn, plain_fn, nbytes, flops, lib_fn in rows:
            err = _rel_err(fn(), plain_fn())
            if err > TOL[dt]:
                raise AssertionError(f"{name} (wide) disagrees with its "
                                     f"plain version at D={d}: {err:.3g}")
            bms, by = bound_ms(nbytes + 2 * b * N_HEAD * t * 4, flops, dt)
            found[name][f"D={d}"] = {
                "max_rel_err": err, "ms": timer(fn, n=10),
                "device_ms": dtimer(fn, n=5), "plain_ms": timer(plain_fn, n=3),
                "bound_ms": bms, "bound_by": by,
                "library_ms": timer(lib_fn, n=10),
                "shape": f"B={b} T={t} H={N_HEAD} D={d} causal", "dtype": dt}
        del o, case, q, k, v, g, qt, kt, vt
        kc = _k2_case(torch, torch.Generator().manual_seed(2), None, 1, d=d)
        qp, kp, vp, table, lens = kc
        fn = lambda: paged_attention(*kc, page_size=PAGE)           # noqa
        plain_fn = lambda: paged_attention_plain(*kc, page_size=PAGE)  # noqa
        err = maxerr(fn(), plain_fn())
        if err > TOL[dt]:
            raise AssertionError(f"K2 (wide) disagrees with its plain "
                                 f"version at D={d}: {err:.3g}")
        ks, vs = paged_read(kp, table), paged_read(vp, table)
        mask = (torch.arange(ks.shape[1], device="cuda")[None, None, :]
                < lens.long()[:, None, None])[:, None]
        n_valid = int(lens.sum())
        bms, by = bound_ms(2 * n_valid * N_HEAD * d * elt
                           + 2 * N_SLOTS * N_HEAD * d * elt,
                           4 * N_HEAD * d * n_valid, dt)
        found["paged_attention"][f"D={d}"] = {
            "max_abs_err": err, "ms": timer(fn), "device_ms": dtimer(fn),
            "plain_ms": timer(plain_fn, n=5), "bound_ms": bms,
            "bound_by": by, "library_ms": timer(
                lambda: F.scaled_dot_product_attention(
                    qp.transpose(1, 2), ks.transpose(1, 2),
                    vs.transpose(1, 2), attn_mask=mask)),
            "shape": (f"slots={N_SLOTS} pps={MAX_SEQ // PAGE} page={PAGE} "
                      f"H={N_HEAD} D={d} q_len=1 lengths={lens.tolist()}"),
            "dtype": dt}
    for name, by_d in found.items():
        for key, r in by_d.items():
            log(f"[wide] {name} {key} {r['shape'].split(' lengths')[0]} bf16:"
                f" {r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
                f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} by "
                f"{r['bound_by']}), library {r['library_ms']:.4f} ms")
    return found


# operations per element of the sampling kernel: threefry2x32 (2 + 20 x 3
# + 5 x 3 + 1 integer ops), the uniform (5), two logs and two negations,
# the add and the compare
SAMPLE_OPS = 89


def check_sampler(torch, timer):
    """The fused sampling kernel (threefry bits, Gumbel transform, row
    argmax) against its plain version at the decode step's shape, (8,
    32000) f32 logits with 4 rows at temperature > 0: the same tokens for
    256 (seed, idx) pairs, with and without top-k; then timed."""
    from analytics_zoo_tpu_torch.ops.kv_cache import (NEG_INF, gumbel_max,
                                                      gumbel_max_plain)

    gen = torch.Generator(device="cuda").manual_seed(9)
    hot = [0, 2, 5, 7]
    temps = torch.tensor([0.8, 1.0, 0.8, 1.0, 1.0, 0.5, 1.0, 1.3],
                         device="cuda")
    worst = 0
    for top_k in (0, 40):
        for call in range(32):
            scaled = torch.randn((N_SLOTS, VOCAB), generator=gen,
                                 device="cuda") * 3 / temps[:, None]
            if top_k:
                kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
                scaled = torch.where(scaled >= kth, scaled,
                                     torch.full_like(scaled, NEG_INF))
            seeds = [1000 * call + i for i in hot]
            idx = [17 * call + i for i in hot]
            got = gumbel_max(scaled, hot, seeds, idx)
            want = gumbel_max_plain(scaled, hot, seeds, idx)
            worst = max(worst, int((got - want).abs().max()))
    ok = worst == 0
    log(f"[sampler] rows={N_SLOTS} hot={len(hot)} V={VOCAB}, 256 (seed, idx)"
        f" pairs, top_k 0 and 40: max|d token| {worst} (must be 0) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the sampling kernel draws other tokens than "
                             "its plain version")
    seeds, idx = [7, 8, 9, 10], [100, 101, 102, 103]
    ms = timer(lambda: gumbel_max(scaled, hot, seeds, idx))
    plain = timer(lambda: gumbel_max_plain(scaled, hot, seeds, idx))
    n = len(hot)
    bms, by = bound_ms(n * VOCAB * 4 + n * 3 * 8 + n * 8,
                       n * VOCAB * SAMPLE_OPS, "float32")
    return {"name": "gumbel_max", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/sample.cu",
            "replaces": "analytics_zoo_tpu/ops/kv_cache.py:662",
            "replaces_note": ("no Pallas kernel: the jax.random.categorical "
                              "draw of sample_tokens, fused"),
            "launches": None, "max_abs_err": float(worst), "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"rows={N_SLOTS} hot={n} V={VOCAB}",
            "dtype": "float32"}


def _i8_packed(torch, rng, shape):
    """Random weights packed as a quantized layer passes them: q, scale and
    q kernel-major (``qt``)."""
    from analytics_zoo_tpu_torch.ops.int8 import quantize_weight
    from analytics_zoo_tpu_torch.ops.int8_fused import kernel_major

    packed = {k: torch.from_numpy(v).cuda() for k, v in quantize_weight(
        rng.normal(size=shape).astype("float32")).items()}
    packed["qt"] = kernel_major(packed["q"])
    return packed


def _i8_check(got, ref, dt: str, label: str) -> float:
    """Hold a K5/K6 result (or the quantize pass's codes and scales) to its
    plain version bit for bit; returns max |d| (0.0)."""
    ok = (got.dtype == ref.dtype and got.shape == ref.shape
          and bool(got.equal(ref)))
    e = maxerr(got, ref) if got.shape == ref.shape else float("inf")
    log(f"{label} {dt}: bitwise equal to its plain version: {ok} (max|d| "
        f"{e:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} is not bitwise equal to its plain "
                             f"version in {dt}")
    return e


def _i8_times(torch, timer, dtimer, fn, plain_fn, parent_fn=None):
    """A K5/K6 call timed in the Timer and device-only (in turns with the
    parent's when given), and its plain version in the Timer."""
    t = in_turns(timer, dtimer, fn, parent_fn, n=20)
    t["plain_ms"] = timer(plain_fn, n=5)
    return t


def check_quantize_pass(torch):
    """The kernels' quantize pass (K5's launch of it) against
    ``quantize_rows_plain`` (``quantize_groups`` per group, zero codes to
    the depth): codes and scales bit for bit, at the MLP's rows (g 512),
    the ResNet head's (lax, one group of 2048), groups off the 32 grid
    and a 3-value group, f32 and bf16, with an all-zero row."""
    from analytics_zoo_tpu_torch.ops.int8_fused import (int8_quantize_rows,
                                                         quantize_rows_plain)

    for r, k, g, rule in ((MLP_BATCH, MLP_HIDDEN, 512, "fused"),
                          (IMG_BATCH, 2048, 2048, "lax"),
                          (7, 300, 100, "fused"), (33, 3, 3, "lax"),
                          (9, 200, 40, "fused")):
        for dt in ("float32", "bfloat16"):
            x = (torch.randn((r, k), device="cuda") * 3).to(getattr(torch,
                                                                    dt))
            x[0] = 0
            codes, scales = int8_quantize_rows(x, g, rule)
            want = quantize_rows_plain(x, g, rule)
            tag = f"[quantize] ({r}, {k}) g={g} {rule}"
            _i8_check(codes, want[0], dt, f"{tag} codes")
            _i8_check(scales, want[1], dt, f"{tag} scales")


def check_k5(torch, timer, dtimer, parent=None):
    """K5 against its plain version bit for bit: the MLP's layers with
    block_k 512 (f32 and bf16 x), a ragged M = 1000, groups off the 32 grid
    (g = 100 and a lax K = 200), a 3-D x, and the ResNet head (32, 2048) x
    (2048, 1000) on the lax route (one group of K, ``/ 127``); timed at the
    MLP and head shapes, device-only too, with the parent's in turns when
    given, beside ``torch._int_mm`` (the int8 product alone). The kernels
    line carries the MLP's first layer."""
    from analytics_zoo_tpu_torch.ops.int8_fused import (
        int8_matmul_fused, int8_matmul_fused_plain)

    check_quantize_pass(torch)
    rng = np.random.default_rng(20)
    cases = [("MLP hidden", (MLP_BATCH,), MLP_HIDDEN, MLP_HIDDEN, 512,
              "fused", "float32", True),
             ("MLP hidden", (MLP_BATCH,), MLP_HIDDEN, MLP_HIDDEN, 512,
              "fused", "bfloat16", False),
             ("MLP head", (MLP_BATCH,), MLP_HIDDEN, MLP_CLASSES, 512, "fused",
              "float32", True),
             ("ragged M", (1000,), MLP_HIDDEN, MLP_HIDDEN, 512, "fused",
              "float32", False),
             ("g off the 32 grid", (77,), 300, 50, 100, "fused", "float32",
              False),
             ("lax K off the 32 grid", (13,), 200, 33, 200, "lax",
              "bfloat16", False),
             ("3-d x", (4, 9), 1024, 384, 512, "fused", "bfloat16", False),
             ("ResNet head", (IMG_BATCH,), 2048, CLASSES, 2048, "lax",
              "float32", True)]
    packs = {}
    out = []
    for label, lead, k, n, g, rule, dt, timed in cases:
        packed = packs.setdefault((k, n), _i8_packed(torch, rng, (k, n)))
        x = (torch.randn(lead + (k,), device="cuda") * 3).to(
            getattr(torch, dt))
        m = math.prod(lead)
        tag = f"[K5] {label} {lead + (k,)} x ({k}, {n}) g={g} {rule}"
        err = _i8_check(int8_matmul_fused(x, packed, g, rule),
                        int8_matmul_fused_plain(x, packed, g, rule), dt, tag)
        if not timed:
            continue
        t = _i8_times(
            torch, timer, dtimer,
            lambda: int8_matmul_fused(x, packed, g, rule),
            lambda: int8_matmul_fused_plain(x, packed, g, rule),
            None if parent is None else
            (lambda: parent.int8.int8_matmul_fused(x, packed, g, rule)))
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda")
        lib = timer(lambda: torch._int_mm(a, b))
        lib_dev = dtimer(lambda: torch._int_mm(a, b))
        elt = x.element_size()
        bms, by = bound_ms(m * k * elt + k * n + 4 * n + m * n * elt,
                           2 * m * n * k, "int8")
        log(f"{tag} {dt}: {t['ms']:.4f} ms, device {t['device_ms']:.5f} "
            f"(parent {t['parent_device_ms']}), plain {t['plain_ms']:.4f}, "
            f"bound {bms:.5f} by {by}, torch._int_mm {lib:.4f} device "
            f"{lib_dev:.5f}")
        out.append({"case": label, "shape": f"({m}, {k}) x ({k}, {n})",
                    "block_k": g, "rule": rule, "dtype": dt,
                    "max_abs_err": err, **t, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib,
                    "library_device_ms": lib_dev,
                    "library_note": "torch._int_mm: int8 product only, "
                                    "excludes quantize/rescale"})
    main = out[0]
    return {"name": "int8_matmul", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "analytics_zoo_tpu/ops/int8_fused.py:157",
            "cuda_kernels": "quantize_rows_kernel, then "
                            "matmul_wgmma_kernel (wgmma m64n128k32 s8 fed "
                            "by TMA) where groups are whole 128-byte "
                            "chunks and 128 x 128 tiles fill the SMs, else "
                            "gemm_kernel (mma.sync m16n8k32 s8; "
                            "csrc/int8_tile.cuh)",
            "launches": None, **main, "cases": out}


def resnet50_convs(torch):
    """ResNet-50's conv layers at IMG x IMG: ``[((H, Cin, k, stride,
    Cout), count), ...]`` in first-use order, from pre-hooks on one float
    forward at batch 1 on the card (20 distinct shapes over 53 convs)."""
    from analytics_zoo_tpu_torch.models.image.backbones import resnet50
    from analytics_zoo_tpu_torch.nn.layers import Convolution2D

    model = resnet50((IMG, IMG, 3), CLASSES, device="cuda", seed=0)
    seen = {}

    def hook(mod, args):
        _, h, w, cin = args[0].shape
        assert h == w and mod.padding == "SAME"
        key = (h, cin, mod.kernel_size[0], mod.strides[0], mod.filters)
        seen[key] = seen.get(key, 0) + 1

    hooks = [layer.register_forward_pre_hook(hook) for layer in model.layers
             if isinstance(layer, Convolution2D)]
    with torch.no_grad():
        model(torch.zeros((1, IMG, IMG, 3), device="cuda"))
    for h in hooks:
        h.remove()
    if len(seen) != 20 or sum(seen.values()) != 53:
        raise AssertionError(f"ResNet-50 has {len(seen)} conv shapes over "
                             f"{sum(seen.values())} convs, not 20 over 53")
    return list(seen.items())


def check_k6(torch, timer, dtimer, parent=None):
    """K6 against its plain version bit for bit at every distinct conv
    shape of ResNet-50 (20 over its 53 convs, SAME padding; stride 1 on the
    fused rule, stride 2 on the lax one) at batch 2 in f32 and bf16 and at
    batch 32 in f32, and at shapes ResNet-50 lacks: Cin 48 (off the 32
    grid), a 3x3 at stride 2 on the lax route, VALID with a ragged Cout,
    and a Cin <= 4 3x3. Each shape at batch 32 is timed device-only; times
    launches per predict, the sum is K6's device time a predict (set
    beside the profiled predict's by ``--profile``). The 3x3/1 64->64 and
    1x1/1 256->64 at 56 px, the 1x1/2 512->1024 at 28 px and the 7x7/2 stem
    are also timed in the Timer, device-only in turns with the parent's
    when given, beside their plain versions and F.conv2d in bf16. The
    kernels line carries the 3x3."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.int8_fused import (
        int8_conv2d_fused, int8_conv2d_fused_plain, same_pads)

    rng = np.random.default_rng(21)
    shapes = resnet50_convs(torch)
    extra = [((14, 48, 3, 1, 40), "Cin off the 32 grid"),
             ((15, 64, 3, 2, 96), "3x3 at stride 2, lax"),
             ((17, 3, 3, 1, 130), "Cin <= 4 3x3")]
    for (hw, cin, k, st, cout), _ in shapes + extra:
        packed = _i8_packed(torch, rng, (k, k, cin, cout))
        pads = same_pads((hw, hw), (k, k), (st, st))
        rule = "fused" if st == 1 else "lax"
        x32 = torch.randn((2, hw, hw, cin), device="cuda")
        for dt in ("float32", "bfloat16"):
            x = x32.to(getattr(torch, dt))
            _i8_check(int8_conv2d_fused(x, packed, (st, st), pads, rule),
                      int8_conv2d_fused_plain(x, packed, (st, st), pads,
                                              rule), dt,
                      f"[K6] B=2 {hw}px {k}x{k}/{st} {cin}->{cout} {rule}")
    x = torch.randn((2, 9, 9, 8), device="cuda")
    packed = _i8_packed(torch, rng, (3, 3, 8, 70))
    _i8_check(int8_conv2d_fused(x, packed, (1, 1), ((0, 0), (0, 0))),
              int8_conv2d_fused_plain(x, packed, (1, 1), ((0, 0), (0, 0))),
              "float32", "[K6] B=2 9px 3x3/1 8->70 VALID fused")

    main = {(56, 64, 3, 1, 64): "3x3/1 64->64 @56",
            (56, 256, 1, 1, 64): "1x1/1 256->64 @56",
            (28, 512, 1, 2, 1024): "1x1/2 512->1024 @28",
            (IMG, 3, 7, 2, 64): "stem 7x7/2 3->64 @224"}
    per_shape, out = [], {}
    for (hw, cin, k, st, cout), count in shapes:
        packed = _i8_packed(torch, rng, (k, k, cin, cout))
        pads = same_pads((hw, hw), (k, k), (st, st))
        args = ((st, st), pads, "fused" if st == 1 else "lax")
        x32 = torch.randn((IMG_BATCH, hw, hw, cin), device="cuda")
        label = f"{k}x{k}/{st} {cin}->{cout} @{hw}"
        err = _i8_check(int8_conv2d_fused(x32, packed, *args),
                        int8_conv2d_fused_plain(x32, packed, *args),
                        "float32", f"[K6] B={IMG_BATCH} {label} {args[2]}")
        ho = -(-hw // st)
        # x as far as the conv reads it: all of it but for a window that
        # skips pixels (a 1x1 at stride 2 reads a quarter)
        x_read = min(x32.numel(), IMG_BATCH * ho * ho * k * k * cin)
        bms, by = bound_ms(
            x_read * 4 + k * k * cin * cout + 4 * cout
            + IMG_BATCH * ho * ho * cout * 4,
            2 * IMG_BATCH * ho * ho * cout * k * k * cin, "int8")
        fn = lambda: int8_conv2d_fused(x32, packed, *args)  # noqa: E731
        dev = dtimer(fn)
        per_shape.append({"shape": label, "rule": args[2],
                          "launches_per_predict": count, "device_ms": dev,
                          "device_ms_x_launches": dev * count,
                          "bound_ms": bms, "bound_by": by})
        log(f"[K6] B={IMG_BATCH} {label}: device {dev:.5f} ms x {count} "
            f"= {dev * count:.5f} (bound {bms:.5f} by {by})")
        if (hw, cin, k, st, cout) not in main:
            continue
        t = _i8_times(
            torch, timer, dtimer, fn,
            lambda: int8_conv2d_fused_plain(x32, packed, *args),
            None if parent is None else
            (lambda: parent.int8.int8_conv2d_fused(x32, packed, *args)))
        _i8_check(int8_conv2d_fused(x32.bfloat16(), packed, *args),
                  int8_conv2d_fused_plain(x32.bfloat16(), packed, *args),
                  "bfloat16", f"[K6] B={IMG_BATCH} {label} {args[2]}")
        xc = x32.permute(0, 3, 1, 2).to(torch.bfloat16)
        wc = torch.randn((cout, cin, k, k), device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        conv = timer(lambda: F.conv2d(xc, wc, stride=st, padding=k // 2))
        lib = {"library_ms": conv,
               "library_note": "F.conv2d in bf16 (cuDNN, channels-last): a "
                               "float conv, not the same function"}
        if (k, st) == (3, 1):
            # the int8 product of the same conv, as K5's yardstick: the
            # im2col matrix of int8 codes (made once, outside the timing)
            # times the (k*k*Cin, Cout) codes by torch._int_mm
            codes = torch.randint(-127, 128, (IMG_BATCH, cin, hw, hw),
                                  device="cuda", dtype=torch.float32)
            cols = F.unfold(codes, k, padding=k // 2).transpose(1, 2) \
                .reshape(-1, k * k * cin).to(torch.int8).contiguous()
            del codes
            wq = torch.randint(-127, 128, (k * k * cin, cout),
                               dtype=torch.int8, device="cuda")
            lib = {"library_ms": timer(lambda: torch._int_mm(cols, wq)),
                   "library_device_ms": dtimer(
                       lambda: torch._int_mm(cols, wq)),
                   "library_note": "torch._int_mm over the im2col int8 "
                                   f"matrix ({cols.shape[0]}, "
                                   f"{cols.shape[1]}) x ({k * k * cin}, "
                                   f"{cout}): the int8 product only, as "
                                   "K5's; excludes the quantize pass, the "
                                   "im2col and the rescale",
                   "conv2d_bf16_ms": conv}
            del cols, wq
        log(f"[K6] B={IMG_BATCH} {label} float32: {t['ms']:.4f} ms, device "
            f"{t['device_ms']:.5f} (parent {t['parent_device_ms']}), plain "
            f"{t['plain_ms']:.4f}, bound {bms:.5f} by {by}, F.conv2d bf16 "
            f"{conv:.4f}, library {lib['library_ms']:.4f} device "
            f"{lib.get('library_device_ms')}")
        out[(hw, cin, k, st, cout)] = {
            "case": main[(hw, cin, k, st, cout)],
            "shape": f"B={IMG_BATCH} {hw}x{hw}x{cin} -> {ho}x{ho}x{cout}, "
                     f"{k}x{k}/{st} SAME",
            "rule": args[2], "dtype": "float32", "max_abs_err": err, **t,
            "bound_ms": bms, "bound_by": by, **lib}
    total = sum(r["device_ms_x_launches"] for r in per_shape)
    bound = sum(r["bound_ms"] * r["launches_per_predict"] for r in per_shape)
    log(f"[K6] ResNet-50 at batch {IMG_BATCH}: {len(per_shape)} shapes, "
        f"device ms x launches summed {total:.4f} ms a predict (bound "
        f"{bound:.4f})")
    cases = [out[key] for key in main]
    return {"name": "int8_conv", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/int8_conv.cu",
            "replaces": "analytics_zoo_tpu/ops/int8_fused.py:248",
            "cuda_kernels": "quantize_rows_kernel, then gemm_kernel "
                            "(mma.sync m16n8k32 s8; csrc/int8_tile.cuh), "
                            "or conv_dp4a_kernel at Cin <= 4",
            "launches": None, **cases[0], "cases": cases,
            "resnet50_shapes": per_shape,
            "resnet50_device_ms_per_predict": total,
            "resnet50_bound_ms_per_predict": bound}


def full_model(torch, device):
    from analytics_zoo_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=N_BLOCK,
                         n_head=N_HEAD, seq_len=SEQ_LEN,
                         attn_strategy="flash", device=device, seed=0)


def phase_parity(torch, gpu_model):
    import numpy as np

    from analytics_zoo_tpu_torch.ops.kv_cache import SCRATCH_PAGE

    cpu_model = full_model(torch, "cpu")
    rng = np.random.default_rng(3)
    n_prompt, steps = 128, 8
    prompt = rng.integers(1, VOCAB, size=n_prompt).astype(np.int32)
    caches = {}
    for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
        cfg, cache = m.init_kv_cache(2, page_size=PAGE, max_seq_len=MAX_SEQ,
                                     dtype=torch.float32)
        caches[name] = (cfg, cache)
    cfg = caches["cpu"][0]
    table = np.full((2, cfg.pages_per_slot), SCRATCH_PAGE, np.int32)
    n_pg = -(-(n_prompt + steps) // PAGE)
    table[0, :n_pg] = np.arange(1, n_pg + 1)   # slot 1 stays inactive
    ids = np.zeros((2, n_prompt), np.int32)
    ids[0] = prompt
    lens = np.array([n_prompt, 0], np.int32)
    worst = 0.0
    logits = {}
    for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
        lg, _ = m.prefill(caches[name][1], ids, lens, table, page_size=PAGE)
        logits[name] = lg[0].cpu()
    worst = max(worst, maxerr(logits["cuda"], logits["cpu"]))
    tok = int(logits["cpu"].argmax())
    zeros = np.zeros(2, np.int64)
    for s in range(steps):
        step_ids = np.array([tok, 0], np.int32)
        pos = np.array([n_prompt + s, 0], np.int32)
        for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
            _, lg, _ = m.decode_step(caches[name][1], step_ids, pos, table,
                                     zeros, zeros, np.zeros(2, np.float32),
                                     page_size=PAGE)
            logits[name] = lg[0].cpu()
        assert torch.isfinite(logits["cuda"]).all()
        worst = max(worst, maxerr(logits["cuda"], logits["cpu"]))
        tok = int(logits["cpu"].argmax())      # teacher-forced by the CPU
    ok = worst <= 1e-3
    log(f"[parity] full-width f32 cuda vs cpu, 128-token prefill + {steps} "
        f"decode steps: max|d logits| {worst:.3g} (tol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-width cuda logits disagree with cpu")
    del cpu_model


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def serving_burst():
    """Phase 5's seeded burst: 16 prompts of 8..700 tokens, 32 new tokens
    each, 12 greedy and 4 at temperature 0.8."""
    rng = np.random.default_rng(4)
    lens = rng.integers(8, 701, size=16)
    prompts = [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
               for n in lens]
    return prompts, [0.0] * 12 + [0.8] * 4, 32


def phase_serving(torch, model, smi):
    import numpy as np

    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops.flash_attention import \
        flash_attention_fwd
    from analytics_zoo_tpu_torch.ops.kv_cache import gumbel_max
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    set_policy(compute_dtype="bfloat16")
    model.to(torch.bfloat16)
    prompts, temps, n_new = serving_burst()
    n_req, lens = len(prompts), np.array([len(p) for p in prompts])
    batcher = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                                max_seq_len=MAX_SEQ, device="cuda",
                                autostart=False)
    emits = [[] for _ in range(n_req)]
    try:
        flash_attention_fwd.launches = 0
        paged_attention.launches = 0
        gumbel_max.launches = 0
        t0 = time.perf_counter()
        handles = []
        for i in range(n_req):
            handles.append(batcher.submit(
                prompts[i], max_new_tokens=n_new, temperature=temps[i],
                seed=100 + i,
                on_chunk=lambda toks, final, meta, i=i: emits[i].append(
                    (time.perf_counter(), len(toks), final, meta))))
        batcher.start()
        outs = [h.result(timeout_s=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention_fwd.launches, paged_attention.launches
        ks = gumbel_max.launches
        stats = batcher.stats()
    finally:
        batcher.close()
    finals = [e[-1][3] for e in emits]
    bad = [(i, f.get("outcome"), len(outs[i])) for i, f in enumerate(finals)
           if f.get("outcome") != "ok" or len(outs[i]) != n_new]
    if bad:
        raise AssertionError(f"streams not ok with {n_new} tokens: {bad}")
    steps = stats["steps"]
    log(f"[serving] launches: K1 {k1} (need {n_req} prefills x {N_BLOCK} "
        f"layers = {n_req * N_BLOCK}), K2 {k2} (need {steps} decode steps x "
        f"{N_BLOCK} layers = {steps * N_BLOCK}), sampler {ks} (one per "
        f"decode step with a row at temperature > 0; need >= 1)")
    if k1 < n_req * N_BLOCK or k2 < steps * N_BLOCK or steps < 1 or ks < 1:
        raise AssertionError("the serving path did not go through its "
                             "kernels")
    # greedy streams must be the argmax of a full forward (flash path) over
    # prompt + emitted tokens, up to bf16 rounding: the chosen token's logit
    # within a small margin of the row max
    margins = []
    for i in range(3):
        seq = np.concatenate([prompts[i], np.asarray(outs[i][:-1], np.int32)])
        with torch.no_grad():
            lg = model.apply(torch.as_tensor(seq[None]))[0].float()
        rows = lg[len(prompts[i]) - 1:]
        chosen = rows[torch.arange(n_new), torch.as_tensor(outs[i]).long()]
        margins.append(float((rows.max(dim=-1).values - chosen).max()))
    log(f"[serving] greedy argmax margins vs full forward: "
        f"{[round(m, 4) for m in margins]}")
    if max(margins) > 0.1:
        raise AssertionError("greedy tokens are not the argmax of a full "
                             "forward")
    sample_ms = time_sampling(torch)
    ttft = [f[0][3]["ttft_s"] for f in emits]
    itl = []
    for e in emits:
        ts = [t for t, n, final, _ in e if not final and n]
        itl += [b - a for a, b in zip(ts, ts[1:])]
    n_tok = sum(len(o) for o in outs)
    res = {"requests": n_req, "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "ttft_p50_ms": pct(ttft, 50) * 1e3,
           "itl_p50_ms": pct(itl, 50) * 1e3, "itl_p95_ms": pct(itl, 95) * 1e3,
           "decode_steps": steps, "prompt_tokens": int(lens.sum()),
           "step_ema_ms": stats["step_ema_s"] * 1e3,
           "prefill_buckets": stats["prefill_buckets"],
           "slot_occupancy": stats["slot_occupancy"],
           "sample_tokens_ms": sample_ms, "card": smi}
    log(f"[serving] {json.dumps(res)}")
    return k1, k2, ks, {"outs": outs, "res": res}


def feature_traffic(rng):
    """Phase 5b's seeded traffic: 4 tenants, each with a 480-token shared
    prefix; 4 users a tenant with a unique 8..64-token suffix and 32 new
    tokens (user 3 of each tenant samples at 0.8, the rest are greedy); one
    greedy 1000-token request whose first 480 tokens are tenant 0's
    prefix, 16 new tokens. The warm-up is one ``prefix + [1, 2, 3]``
    request a tenant, 1 new token."""
    prefixes = [rng.integers(1, VOCAB, size=FEATURE_PREFIX).astype(np.int32)
                for _ in range(FEATURE_TENANTS)]
    burst = []
    for t, pre in enumerate(prefixes):
        for u in range(FEATURE_USERS):
            suffix = rng.integers(1, VOCAB, size=int(rng.integers(8, 65)))
            burst.append((np.concatenate([pre, suffix]).astype(np.int32), 32,
                          0.8 if u == FEATURE_USERS - 1 else 0.0,
                          1000 + FEATURE_USERS * t + u))
    tail = rng.integers(1, VOCAB, size=1000 - FEATURE_PREFIX)
    burst.append((np.concatenate([prefixes[0], tail]).astype(np.int32), 16,
                  0.0, 2000))
    warm = [np.concatenate([pre, [1, 2, 3]]).astype(np.int32)
            for pre in prefixes]
    return warm, burst


def _feature_arm(torch, model, opts, warm, burst, trace=None):
    """One arm of phase 5b on a fresh batcher: the warm-up, then the burst
    at once (inside ``trace()``, a profiler context, when given). Returns
    the batcher, the streams, their frames, the wall time, the K1/K2
    launch counts of the arm (set to 0 just before it) and the batcher's
    stats after the warm-up and after the burst."""
    import contextlib

    from analytics_zoo_tpu_torch.ops.flash_attention import \
        flash_attention_fwd
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    flash_attention_fwd.launches = 0
    paged_attention.launches = 0
    b = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                          max_seq_len=MAX_SEQ, device="cuda",
                          autostart=False, **opts)
    emits = [[] for _ in burst]
    try:
        hs = [b.submit(p, max_new_tokens=1, seed=i)
              for i, p in enumerate(warm)]
        b.start()
        for h in hs:
            h.result(timeout_s=600)
        before = b.stats()
        with (trace or contextlib.nullcontext)():
            t0 = time.perf_counter()
            hs = [b.submit(p, max_new_tokens=n, temperature=temp, seed=seed,
                           on_chunk=lambda toks, final, meta, i=i:
                           emits[i].append((time.perf_counter(), len(toks),
                                            final, meta)))
                  for i, (p, n, temp, seed) in enumerate(burst)]
            outs = [h.result(timeout_s=600) for h in hs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k1, k2 = flash_attention_fwd.launches, paged_attention.launches
        after = b.stats()
    finally:
        b.close()
    return b, outs, emits, wall, k1, k2, before, after


def _greedy_margins(torch, model, burst, outs, idx):
    """Phase 5's check on streams ``idx``: the chosen token's logit within
    how much of the row max of a full forward over prompt + emitted."""
    margins = []
    for i in idx:
        prompt, n_new = burst[i][0], len(outs[i])
        seq = np.concatenate([prompt, np.asarray(outs[i][:-1], np.int32)])
        with torch.no_grad():
            lg = model.apply(torch.as_tensor(seq[None]))[0].float()
        rows = lg[len(prompt) - 1:]
        chosen = rows[torch.arange(n_new), torch.as_tensor(outs[i]).long()]
        margins.append(float((rows.max(dim=-1).values - chosen).max()))
    return margins


def phase_serving_features(torch, model, smi):
    """Phase 5b: speculative decode, chunked prefill and the shared-prefix
    cache on phase 5's model (bf16, 8 slots, page 16, max_seq_len 1024),
    one fresh batcher an arm: plain; spec_k=4; prefill_chunk_tokens=128;
    prefix_cache_pages=256; all three. Gates (each fatal): every stream ok
    with its token count; greedy argmax margins vs a full forward <= 0.1
    for three streams, the 1000-token one among them; K2 launches = 12 x
    (decode + verify + chunk + prefill_from dispatches) and K1 = 12 x
    whole-prompt prefills, from the batcher's counters; spec arms take a
    verify step and >= 1 token a slot-step; chunked arms one chunk shape;
    prefix arms 17 hits and 17 x 480 tokens saved over the burst, and the
    pool conserved after close. Printed beside the plain arm's: tokens/s,
    TTFT, ITL, steps, acceptance, chunks, tokens saved, peak pages, and
    how many greedy streams equal the plain arm's (bf16: cuBLAS picks its
    kernel by M, so a verify step rounds unlike a decode step). Returns
    each arm's K2 launches."""
    warm, burst = feature_traffic(np.random.default_rng(5))
    greedy = [i for i, r in enumerate(burst) if r[2] == 0.0]
    k2_by_arm, plain_outs = {}, None
    for name, opts in FEATURE_ARMS:
        b, outs, emits, wall, k1, k2, before, st = _feature_arm(
            torch, model, opts, warm, burst)
        finals = [e[-1][3] for e in emits]
        bad = [(i, f.get("outcome"), len(outs[i]), r[1])
               for i, (f, r) in enumerate(zip(finals, burst))
               if f.get("outcome") != "ok" or len(outs[i]) != r[1]]
        if bad:
            raise AssertionError(f"[{name}] streams not ok with their token "
                                 f"counts: {bad}")
        d = st["dispatches"]
        want_k2 = N_BLOCK * (d["decode"] + d["verify"] + d["chunk"]
                             + d["prefill_from"])
        want_k1 = N_BLOCK * d["prefill"]
        log(f"[features:{name}] launches K1 {k1} (need {want_k1} = "
            f"{N_BLOCK} x {d['prefill']} whole-prompt prefills), K2 {k2} "
            f"(need {want_k2} = {N_BLOCK} x dispatches {d})")
        if k1 != want_k1 or k2 != want_k2 or k2 == 0:
            raise AssertionError(f"[{name}] launch counts do not match the "
                                 f"batcher's dispatches")
        if opts.get("spec_k") and (st["spec"]["steps"] < 1
                                   or st["tokens_per_slot_step"] < 1.0):
            raise AssertionError(f"[{name}] no speculative verify step: "
                                 f"{st.get('spec')}")
        if opts.get("prefill_chunk_tokens") \
                and st["prefill"]["distinct_chunk_shapes"] != 1:
            raise AssertionError(f"[{name}] chunk shapes: {st['prefill']}")
        saved = hits = None
        if opts.get("prefix_cache_pages"):
            hits = st["prefix"]["hits"] - before["prefix"]["hits"]
            saved = (st["prefix"]["tokens_saved"]
                     - before["prefix"]["tokens_saved"])
            held = b.prefix_cache.held_pages()
            b.pool.check_conservation()
            free = b.pool.free_count()
            log(f"[features:{name}] prefix hits {hits} (need 17), tokens "
                f"saved {saved} (need {17 * FEATURE_PREFIX}); after close: "
                f"free {free} == capacity {b.pool.capacity} - held {held}")
            if hits != 17 or saved != 17 * FEATURE_PREFIX \
                    or free != b.pool.capacity - held:
                raise AssertionError(f"[{name}] prefix cache accounting")
        margins = _greedy_margins(torch, model, burst, outs,
                                  greedy[:2] + [len(burst) - 1])
        log(f"[features:{name}] greedy argmax margins vs full forward "
            f"(users 0, 1 and the 1000-token request): "
            f"{[round(m, 4) for m in margins]}")
        if max(margins) > 0.1:
            raise AssertionError(f"[{name}] greedy tokens are not the argmax "
                                 f"of a full forward")
        if plain_outs is None:
            plain_outs = outs
        same = [outs[i] == plain_outs[i] for i in greedy]
        first_diff = [next((j for j, (a, c) in enumerate(zip(outs[i],
                                                            plain_outs[i]))
                            if a != c), None) for i in greedy]
        first_diff = min((j for j in first_diff if j is not None),
                         default=None)
        ttft = [f[0][3]["ttft_s"] for f in emits]
        itl = []
        for e in emits:
            ts = [t for t, n, final, _ in e if not final and n]
            itl += [bb - a for a, bb in zip(ts, ts[1:])]
        n_tok = sum(len(o) for o in outs)
        res = {"arm": name, "opts": opts, "requests": len(burst),
               "tokens": n_tok, "wall_s": wall,
               "tokens_per_s": n_tok / wall,
               "ttft_p50_ms": pct(ttft, 50) * 1e3,
               "itl_p50_ms": pct(itl, 50) * 1e3,
               "itl_p95_ms": pct(itl, 95) * 1e3,
               "decode_steps": st["steps"] - before["steps"],
               "dispatches": d, "launches": {"K1": k1, "K2": k2},
               "acceptance_rate": (st.get("spec") or {}).get(
                   "acceptance_rate"),
               "tokens_per_slot_step": st["tokens_per_slot_step"],
               "chunks": (st.get("prefill") or {}).get("chunks"),
               "prefix_hits": hits, "prefix_tokens_saved": saved,
               "peak_pages_in_use": st["peak_pages_in_use"],
               "greedy_equal_to_plain": f"{sum(same)}/{len(same)}",
               "first_differing_step": first_diff, "margins": margins,
               "card": smi}
        log(f"[features] {json.dumps(res)}")
        k2_by_arm[name] = k2
    return k2_by_arm


def phase_train_parity(torch):
    """The full-width f32 model on the card (K1, K3, K4) against the same
    seeded model on the CPU (plain versions): loss and every gradient leaf
    of one (1, 256) batch, then one Estimator Adam step on each side and a
    second forward."""
    import numpy as np

    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    ids = np.random.default_rng(7).integers(0, VOCAB, size=(1, 257))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)
    models = {"cuda": full_model(torch, "cuda"), "cpu": full_model(torch, "cpu")}
    loss, grads = {}, {}
    for name, m in models.items():
        out = lm_loss(y, m.apply(x))
        params = dict(m.named_parameters())
        g = torch.autograd.grad(out, list(params.values()))
        loss[name] = float(out.detach())
        grads[name] = {n: t.detach().cpu() for n, t in zip(params, g)}
    rel_loss = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    worst = max(maxerr(grads["cuda"][n], g) / max(float(g.abs().max()), 1e-30)
                for n, g in grads["cpu"].items())
    after = {}
    for name, m in models.items():
        est = Estimator(m, optimizer="adam", loss=lm_loss,
                        config=TrainConfig(shuffle=False, log_every_n_steps=1))
        est.fit((x, y), batch_size=1, epochs=1)
        with torch.no_grad():
            after[name] = float(lm_loss(y, m.apply(x)))
    d_after = abs(after["cuda"] - after["cpu"])
    ok = rel_loss <= 1e-4 and worst <= 1e-3 and d_after <= 1e-3
    log(f"[train-parity] full-width f32 cuda vs cpu, B=1 T=256 flash: loss "
        f"{loss['cuda']:.6f} vs {loss['cpu']:.6f} (rel {rel_loss:.3g}, tol "
        f"1e-4), worst grad leaf max|d|/max|g| {worst:.3g} (tol 1e-3), loss "
        f"after one Adam step {after['cuda']:.6f} vs {after['cpu']:.6f} "
        f"(|d| {d_after:.3g}, tol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-width training on the card disagrees "
                             "with the cpu")


def train_model(TransformerLM, lm_loss, TrainConfig, seed: int = 0,
                remat: str = "flash", **cfg):
    """Phase 7's model, compiled with its TrainConfig (``cfg`` adds
    fields): bf16 with f32 masters, Adam, clipping 1.0, accumulation 2."""
    model = TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=N_BLOCK,
                          n_head=N_HEAD, seq_len=SEQ_LEN,
                          attn_strategy="flash", remat=remat,
                          device=DEV["cuda"], seed=seed)
    model.compile(optimizer="adam", loss=lm_loss, config=TrainConfig(
        compute_dtype="bfloat16", gradient_clip_norm=1.0,
        grad_accum_steps=GRAD_ACCUM, shuffle=False, log_every_n_steps=1,
        **cfg))
    return model


def train_ids():
    """Phase 7's seeded token ids: TRAIN_SEQS sequences of SEQ_LEN + 1."""
    return np.random.default_rng(8).integers(
        0, VOCAB, size=(TRAIN_SEQS, SEQ_LEN + 1)).astype(np.int32)


def phase_training(torch, smi, profile: bool = False):
    """The slice's main path: the full-width model trained through
    ``compile``/``fit`` in bf16 with f32 masters, remat="flash", gradient
    accumulation 2: 8 optimizer steps, 16 micro-steps."""
    import numpy as np

    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    set_policy(compute_dtype="float32")
    model = train_model(TransformerLM, lm_loss, TrainConfig, seed=0)
    ids = train_ids()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.flash_attention_fwd.launches = 0
    tfa.flash_attention_bwd_dq.launches = 0
    tfa.flash_attention_bwd_dkv.launches = 0
    t0 = time.perf_counter()
    model.fit(ids[:, :-1], ids[:, 1:], batch_size=TRAIN_BATCH,
              nb_epoch=TRAIN_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = tfa.flash_attention_fwd.launches
    k3 = tfa.flash_attention_bwd_dq.launches
    k4 = tfa.flash_attention_bwd_dkv.launches
    peak = torch.cuda.max_memory_allocated()
    hist = model.estimator.history
    losses = [h["loss"] for h in hist]
    steps_ms = [h["data_ms"] + h["compute_ms"] for h in hist]
    n_steps = TRAIN_SEQS // TRAIN_BATCH * TRAIN_EPOCHS
    micro = n_steps * GRAD_ACCUM
    med = statistics.median(steps_ms)
    res = {"steps": len(hist), "micro_steps": micro,
           "batch": TRAIN_BATCH, "seq_len": SEQ_LEN, "wall_s": wall,
           "step_ms_median": med, "step_ms": steps_ms,
           "tokens_per_s": TRAIN_BATCH * SEQ_LEN / (med / 1e3),
           "max_memory_allocated": peak, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist], "card": smi}
    log(f"[training] {json.dumps(res)}")
    log(f"[training] launches: K1 {k1}, K3 {k3}, K4 {k4} (need {N_BLOCK} "
        f"layers x {micro} micro-steps = {N_BLOCK * micro} each; remat "
        f"'flash' never re-runs K1)")
    if len(losses) != n_steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training losses not finite or missing: "
                             f"{losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    if not k1 == k3 == k4 == N_BLOCK * micro:
        raise AssertionError("the training path did not run K1, K3 and K4 "
                             "once per layer and micro-step")
    if profile:
        profile_training_step(torch, model, ids, smi)
    return k1, k3, k4, hist


def time_sampling(torch):
    """Median CUDA-event time of one ``sample_tokens`` call over the
    decode step's (8, vocab) f32 logits: all rows greedy, and 4 of 8 rows
    at temperature 0.8 (the threefry bits and Gumbel-max)."""
    from analytics_zoo_tpu_torch.ops.kv_cache import sample_tokens

    logits = torch.randn((N_SLOTS, VOCAB), device="cuda")
    seeds, idx = list(range(N_SLOTS)), [7] * N_SLOTS
    out = {}
    for name, hot in (("greedy", 0), ("hot4", 4)):
        temps = [0.8] * hot + [0.0] * (N_SLOTS - hot)
        times = []
        for i in range(23):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sample_tokens(logits, seeds, idx, temps)
            b.record()
            b.synchronize()
            if i >= 3:
                times.append(a.elapsed_time(b))
        out[name] = statistics.median(times)
    return out


def phase_profile(torch, model, smi):
    """Trace one burst of 8 requests (256-token prompts, 32 new tokens,
    greedy) and print the device time by kernel and the device's busy
    share of the traced wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    rng = np.random.default_rng(5)
    batcher = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                                max_seq_len=MAX_SEQ, device="cuda",
                                autostart=False)
    try:
        handles = [batcher.submit(rng.integers(1, VOCAB, size=256),
                                  max_new_tokens=32) for _ in range(N_SLOTS)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            batcher.start()
            for h in handles:
                h.result(timeout_s=600)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        steps = batcher.stats()["steps"]
    finally:
        batcher.close()

    rows, busy = _device_rows(prof)
    log(f"[profile] {smi} | burst of {N_SLOTS} x (256 prompt + 32 new), "
        f"{steps} decode steps, wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.3f} of wall)")
    for key, count, ms in _shown(rows, 15):
        log(f"[profile] {ms:9.3f} ms {count:6d} calls  {key[:100]}")


def profile_feature_arms(torch, model, smi):
    """Trace phase 5b's burst in each arm (after its warm-up, on a fresh
    batcher) and print the device's busy share of the wall and the device
    time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    warm, burst = feature_traffic(np.random.default_rng(5))
    for name, opts in FEATURE_ARMS:
        holder = {}

        def trace():
            holder["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            return holder["prof"]

        _, _, _, wall, _, _, before, st = _feature_arm(
            torch, model, opts, warm, burst, trace=trace)
        rows, busy = _device_rows(holder["prof"])
        wall_ms = wall * 1e3
        log(f"[profile:features:{name}] {smi} | {len(burst)} requests, "
            f"dispatches {st['dispatches']}, wall {wall_ms:.1f} ms, device "
            f"busy {busy:.1f} ms ({busy / wall_ms:.3f} of wall)")
        for key, count, ms in _shown(rows, 8):
            log(f"[profile:features:{name}] {ms:9.3f} ms {count:6d} calls  "
                f"{key[:100]}")


def _shown(rows, n):
    """The n largest rows, then every other row of a kernel in an
    anonymous namespace, where the port's kernels are (a few of PyTorch's
    are too), so that each of the port's kernels shows its device time."""
    return rows[:n] + [r for r in rows[n:] if "(anonymous namespace)" in r[0]]


def _device_rows(prof):
    """(kernel name, calls, device ms) rows of a trace's device events,
    largest first, and their sum."""
    def dev_ms(evt, attr):
        v = getattr(evt, attr.replace("cuda", "device"), None)
        return (v if v is not None else getattr(evt, attr, 0.0)) / 1e3

    from torch.autograd import DeviceType

    # device-side events only: a host op's row also carries the device
    # time of the kernels it launched, which would count them twice
    rows = [(e.key, e.count, dev_ms(e, "self_cuda_time_total"))
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows)


def profile_training_step(torch, model, ids, smi):
    """Trace one optimizer step of the training phase (2 micro-steps of 2
    sequences) and print the device time by kernel and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    est = model.estimator
    batch = est._to_device((ids[:TRAIN_BATCH, :-1], ids[:TRAIN_BATCH, 1:]))
    est._step(batch)                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est._step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, busy = _device_rows(prof)
    log(f"[profile-train] {smi} | one step, batch {TRAIN_BATCH} x "
        f"{SEQ_LEN} in {GRAD_ACCUM} micro-steps, wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms ({busy / wall_ms:.3f} of wall)")
    for key, count, ms in _shown(rows, 20):
        log(f"[profile-train] {ms:9.3f} ms {count:6d} calls  {key[:100]}")


# ------------------------------------------------------------ int8 slice

def _bn_calibrate(torch, model, x) -> None:
    """Set every BatchNormalization's moving statistics to the batch
    statistics of its input over ``x``, in one forward in graph order, so
    that the seeded random network keeps unit-scale activations as a
    trained one does (uncalibrated, its softmax is flat to 1e-5)."""
    from analytics_zoo_tpu_torch.nn.layers import BatchNormalization

    def take_stats(mod, args):
        a = args[0].float()
        mod.moving_mean.copy_(a.mean(dim=(0, 1, 2)))
        mod.moving_var.copy_(a.var(dim=(0, 1, 2), unbiased=False))

    hooks = [layer.register_forward_pre_hook(take_stats)
             for layer in model.layers
             if isinstance(layer, BatchNormalization)]
    try:
        with torch.no_grad():
            model(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()


def resnet_state(torch):
    """Full-width ResNet-50 (224x224x3, 1000 classes), weights from seed 0
    and BN calibrated on 4 seeded images, on the CPU: its state dict."""
    from analytics_zoo_tpu_torch.models.image.backbones import resnet50

    model = resnet50((IMG, IMG, 3), CLASSES, device="cpu", seed=0)
    x = np.random.default_rng(10).normal(size=(4, IMG, IMG, 3)).astype(
        np.float32)
    _bn_calibrate(torch, model, x)
    return {k: v.clone() for k, v in model.state_dict().items()}


def resnet_on(torch, state, device):
    from analytics_zoo_tpu_torch.models.image.backbones import resnet50

    model = resnet50((IMG, IMG, 3), CLASSES, device=device, seed=0)
    model.load_state_dict(state)
    return model


def phase_int8_parity(torch, state):
    """The quantized full-width ResNet-50 on the card (K5, K6) against the
    same model on the CPU (plain versions), at batch 2: max |d prob| <=
    1e-3 and the same top-1 on every image whose CPU top-2 margin is above
    1e-3. Up to the pooling both compute the same int8 arithmetic; upstream
    f32 differences (the pooling's sum order) may flip a rare code."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel

    x = np.random.default_rng(11).normal(size=(2, IMG, IMG, 3)).astype(
        np.float32)
    probs = {}
    for dev in ("cuda", "cpu"):
        im = InferenceModel(max_batch_size=2, device=dev).load(
            resnet_on(torch, state, dev)).quantize_int8()
        probs[dev] = im.predict(x)
        del im
    d = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    top2 = np.sort(probs["cpu"], axis=1)[:, ::-1]
    margin = top2[:, 0] - top2[:, 1]
    same = probs["cuda"].argmax(1) == probs["cpu"].argmax(1)
    ok = d <= 1e-3 and bool(np.all(same | (margin <= 1e-3)))
    log(f"[int8-parity] full-width ResNet-50 int8 cuda vs cpu, batch 2: "
        f"max|d prob| {d:.3g} (tol 1e-3), cpu top-1 "
        f"{probs['cpu'].argmax(1).tolist()} cuda "
        f"{probs['cuda'].argmax(1).tolist()}, cpu top-2 margins "
        f"{[round(float(m), 5) for m in margin]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 ResNet-50 on the card disagrees with "
                             "the cpu")


def _img_timing(im, xb, x1, n: int = 20):
    """Median wall time of ``predict`` (numpy out, so synced) at batch 32
    and at batch 1."""
    out = {}
    for key, x in (("batch32", xb), ("batch1", x1)):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            im.predict(x)
            times.append(time.perf_counter() - t0)
        out[f"{key}_ms_p50"] = statistics.median(times) * 1e3
    out["images_per_s"] = len(xb) / (out["batch32_ms_p50"] / 1e3)
    return out


def phase_int8_serving(torch, state, smi, profile: bool = False):
    """The slice's main path: InferenceModel(supported_concurrent_num=4,
    max_batch_size=32) over the full-width ResNet-50. The float model is
    timed at f32 and bf16 compute, then quantize_int8 and warm_up; a burst
    of requests of 1, 5, 32 and 40 images from 4 threads (40 runs as 32 +
    8) must give finite rows summing to 1, the same rows for the same
    images, and K6 = 53 and K5 = 1 launches per dispatched chunk (counts
    set to 0 just before); then the int8 model is timed at f32 and bf16."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    set_policy(compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(12)
    images = rng.normal(size=(40, IMG, IMG, 3)).astype(np.float32)
    xb, x1 = images[:IMG_BATCH], images[:1]
    im = InferenceModel(supported_concurrent_num=IMG_THREADS,
                        max_batch_size=IMG_BATCH, device="cuda")
    im.load(resnet_on(torch, state, "cuda"))
    res = {}
    for dt in ("float32", "bfloat16"):
        set_policy(compute_dtype=dt)
        im.warm_up(x1)
        res[f"float_{dt}"] = _img_timing(im, xb, x1)
    set_policy(compute_dtype="float32")
    float_top1 = im.predict(xb).argmax(1)
    im.quantize_int8()
    im.warm_up(x1)
    sizes = [1, 5, IMG_BATCH, 40]
    outs, errors = {}, []

    def client(t):
        try:
            for n in sizes[t:] + sizes[:t]:
                outs[(t, n)] = im.predict(images[:n])
        except Exception as e:               # reported below
            errors.append(repr(e))

    f8.int8_matmul_fused.launches = 0
    f8.int8_conv2d_fused.launches = 0
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(IMG_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    burst_s = time.perf_counter() - t0
    k5, k6 = f8.int8_matmul_fused.launches, f8.int8_conv2d_fused.launches
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"burst clients failed: {errors}")
    chunks = IMG_THREADS * sum(-(-n // IMG_BATCH) for n in sizes)
    bad = [(key, y.shape) for key, y in outs.items()
           if y.shape != (key[1], CLASSES) or not np.isfinite(y).all()
           or np.abs(y.sum(1) - 1).max() > 1e-4]
    same = all(np.array_equal(outs[(t, n)], outs[(0, n)])
               for t in range(IMG_THREADS) for n in sizes)
    same = same and np.array_equal(outs[(0, 40)][:IMG_BATCH],
                                   outs[(0, IMG_BATCH)])
    log(f"[int8-serving] burst: {len(outs)} requests of {sizes} images from "
        f"{IMG_THREADS} threads in {burst_s:.3f} s, {chunks} chunks; "
        f"launches K6 {k6} (need 53 x {chunks} = {53 * chunks}), K5 {k5} "
        f"(need {chunks}); borrowed_peak {im.borrowed_peak}; same rows for "
        f"the same images: {same}")
    if bad or not same:
        raise AssertionError(f"burst results wrong: {bad}, same={same}")
    if k6 != 53 * chunks or k5 != chunks:
        raise AssertionError("the int8 serving path did not run K6 on every "
                             "conv and K5 on the head of every chunk")
    res["int8_float32"] = _img_timing(im, xb, x1)
    int8_top1 = im.predict(xb).argmax(1)
    set_policy(compute_dtype="bfloat16")
    im.warm_up(x1)
    res["int8_bfloat16"] = _img_timing(im, xb, x1)
    set_policy(compute_dtype="float32")
    res.update({"int8_vs_float_top1_agreement": float(
                    (int8_top1 == float_top1).mean()),
                "burst_s": burst_s, "compile_stats": im.compile_stats(),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "card": smi})
    log(f"[int8-serving] {json.dumps(res)}")
    if profile:
        profile_int8_predict(torch, im, xb, smi)
    return k5, k6


def phase_int8_mlp(torch, smi):
    """The int8 MLP of serving_bench.py (Dense 4096 relu, Dense 4096 relu,
    Dense 128 softmax; seed 0) at batch 2048 through
    InferenceModel(max_batch_size=2048): K5 three times per predict, every
    layer on the fused route (block_k 512), the output within 1e-5 of the
    plain route on the card; predict ms float and int8, f32 and bf16."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn.layers import Dense
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.nn.topology import Sequential
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    set_policy(compute_dtype="float32")
    model = Sequential([
        Dense(MLP_HIDDEN, activation="relu", input_shape=(MLP_HIDDEN,)),
        Dense(MLP_HIDDEN, activation="relu"),
        Dense(MLP_CLASSES, activation="softmax")], device="cuda", seed=0)
    im = InferenceModel(max_batch_size=MLP_BATCH, device="cuda").load(model)
    x = np.random.default_rng(13).normal(size=(MLP_BATCH, MLP_HIDDEN)).astype(
        np.float32)

    def predict_ms(n: int = 10) -> float:
        im.predict(x)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            im.predict(x)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    res = {}
    for dt in ("float32", "bfloat16"):
        set_policy(compute_dtype=dt)
        res[f"float_{dt}_ms"] = predict_ms()
    set_policy(compute_dtype="float32")
    im.quantize_int8()
    f8.int8_matmul_fused.launches = 0
    y = im.predict(x)
    k5 = f8.int8_matmul_fused.launches
    # the same forward with the plain version on the card
    h = torch.from_numpy(x).cuda()
    with torch.no_grad():
        for layer in model.layers:
            packed = layer.packed_kernel
            k, n = packed["q"].shape
            blocks = f8.resolve_blocks(MLP_BATCH, n, k)
            assert blocks is not None and blocks[2] == 512
            h = layer.activation(f8.int8_matmul_fused_plain(
                h, packed, blocks[2], "fused") + layer.bias)
    ref = h.cpu().numpy()
    e = float(np.abs(y - ref).max()) / max(1.0, float(np.abs(ref).max()))
    ok = k5 == 3 and e <= 1e-5
    log(f"[int8-mlp] launches K5 {k5} per predict (need 3), max|d| vs the "
        f"plain route on the card {e:.3g} (tol 1e-5) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 MLP did not run K5 on every layer or "
                             "disagrees with its plain route")
    for dt in ("float32", "bfloat16"):
        set_policy(compute_dtype=dt)
        res[f"int8_{dt}_ms"] = predict_ms()
    set_policy(compute_dtype="float32")
    res.update({"batch": MLP_BATCH, "hidden": MLP_HIDDEN, "card": smi})
    log(f"[int8-mlp] {json.dumps(res)}")
    return k5


def profile_int8_predict(torch, im, xb, smi):
    """Trace one int8 batch-32 predict and print the device time by kernel
    and the device's busy share of the traced wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a trace can lose its first kernels' events (the predict's first
        # conv went missing so): one small kernel takes that place
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        im.predict(xb)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, busy = _device_rows(prof)
    log(f"[profile-int8] {smi} | one int8 ResNet-50 predict at batch "
        f"{len(xb)}, wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / wall_ms:.3f} of wall)")
    for key, count, ms in _shown(rows, 15):
        log(f"[profile-int8] {ms:9.3f} ms {count:6d} calls  {key[:100]}")
    # K6's kernels carry "Conv" (its gather and row maps) or are
    # conv_dp4a_kernel; K5's carry "Matmul" or are matmul_wgmma_kernel
    for name, marks in (("K6", ("Conv", "conv_dp4a")),
                        ("K5", ("Matmul", "matmul_wgmma"))):
        mine = [(c, ms) for key, c, ms in rows if any(m in key for m in marks)]
        log(f"[profile-int8] {name} total {sum(ms for _, ms in mine):.4f} ms "
            f"device over {sum(c for c, _ in mine)} kernel launches "
            f"({sum(ms for _, ms in mine) / busy:.3f} of busy)")


def phase_example(torch):
    """examples/transformer_lm.py's configuration (vocab 256, hidden 64, 2
    blocks, 4 heads: head dim 16; remat "flash"; seed 0) in f32 on the card
    against the same seeded model on the CPU: 4 greedy requests through
    ContinuousBatcher must give the same token streams (K1 on every prefill
    and layer, K2 on every decode step and layer), then a prompt pair (20
    tokens, then 60 sharing its first 16), in four arms: plain,
    ``spec_k=3``, ``prefix_cache_pages=8`` (the 60-token prompt's 44-token
    suffix takes a 64 bucket at positions 16..79, past the 4-page table and
    the 64-row position table) and ``prefill_chunk_tokens=32`` with
    ``prefix_cache_pages=8`` (chunks at 16..47 and 48..79); on each side
    every arm's streams equal the plain arm's, and the card's the CPU's.
    One Estimator Adam step (K1 = K3 = K4 = 2, one a layer) gives the same
    loss within 1e-4 and the same next loss within 1e-3."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    set_policy(compute_dtype="float32")
    vocab, seq, blocks = 256, 64, 2
    kw = dict(vocab=vocab, hidden_size=64, n_block=blocks, n_head=4,
              seq_len=seq, attn_strategy="flash", remat="flash", seed=0)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32)
               for n in (5, 17, 30, 40)]
    ids = rng.integers(0, vocab, size=(8, seq + 1))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)
    pair_rng = np.random.default_rng(15)
    first = pair_rng.integers(1, vocab, size=20).astype(np.int32)
    pair = [first, np.concatenate([first[:16], pair_rng.integers(
        1, vocab, size=44)]).astype(np.int32)]
    arms = (("plain", {}), ("spec", {"spec_k": 3}),
            ("prefix", {"prefix_cache_pages": 8}),
            ("chunked_prefix", {"prefill_chunk_tokens": 32,
                                "prefix_cache_pages": 8}))
    streams, losses, counts = {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(device=dev, **kw)
        for arm, opts in arms:
            batcher = ContinuousBatcher(model, n_slots=4, page_size=16,
                                        max_seq_len=seq, device=dev,
                                        autostart=False, **opts)
            try:
                tfa.flash_attention_fwd.launches = 0
                paged_attention.launches = 0
                handles = [batcher.submit(p, max_new_tokens=12)
                           for p in prompts]
                batcher.start()
                out = [h.result(timeout_s=300) for h in handles]
                # the pair in turn: the second finds the first's block
                out += [batcher.generate(p, max_new_tokens=3,
                                         timeout_s=300) for p in pair]
                st = batcher.stats()
            finally:
                batcher.close()
            streams[(dev, arm)] = out
            counts[(dev, arm)] = {"K1": tfa.flash_attention_fwd.launches,
                                  "K2": paged_attention.launches,
                                  "steps": st["steps"],
                                  "dispatches": st["dispatches"]}
            if opts.get("prefix_cache_pages") and (
                    st["prefix"]["hits"] < 1
                    or st["dispatches"]["chunk"] + st["dispatches"][
                        "prefill_from"] < 1):
                raise AssertionError(f"[example:{arm}] the pair took no "
                                     f"prefix hit: {st}")
        counts[dev] = counts[(dev, "plain")]
        log(f"[example] {dev}: launches and dispatches by arm "
            f"{ {arm: counts[(dev, arm)] for arm, _ in arms} }")
        with torch.no_grad():
            before = float(lm_loss(y, model.apply(x)))
        est = Estimator(model, optimizer="adam", loss=lm_loss,
                        config=TrainConfig(shuffle=False))
        for f in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                  tfa.flash_attention_bwd_dkv):
            f.launches = 0
        est.fit((x, y), batch_size=len(x), epochs=1)
        counts[dev]["train"] = (tfa.flash_attention_fwd.launches,
                                tfa.flash_attention_bwd_dq.launches,
                                tfa.flash_attention_bwd_dkv.launches)
        with torch.no_grad():
            losses[dev] = (before, float(lm_loss(y, model.apply(x))))
        del model, est
    c = counts["cuda"]
    same = all(streams[("cuda", arm)] == streams[("cpu", arm)]
               for arm, _ in arms)
    arms_same = all(streams[(dev, arm)] == streams[(dev, "plain")]
                    for dev in ("cuda", "cpu") for arm, _ in arms)
    d0 = abs(losses["cuda"][0] - losses["cpu"][0])
    d1 = abs(losses["cuda"][1] - losses["cpu"][1])
    launched = (c["K1"] >= len(prompts) * blocks
                and c["K2"] >= c["steps"] * blocks and c["steps"] >= 1
                and c["train"] == (blocks,) * 3)
    ok = same and arms_same and d0 <= 1e-4 and d1 <= 1e-3 and launched
    log(f"[example] examples/transformer_lm.py config (hidden 64, 4 heads, "
        f"D=16) f32 cuda vs cpu: greedy streams identical {same} (every "
        f"arm equal to plain on both sides: {arms_same}); launches "
        f"{c} (need K1 >= {len(prompts) * blocks}, K2 >= steps x {blocks}, "
        f"train K1 = K3 = K4 = {blocks}); loss {losses['cuda'][0]:.6f} vs "
        f"{losses['cpu'][0]:.6f} (|d| {d0:.3g}, tol 1e-4), after one Adam "
        f"step {losses['cuda'][1]:.6f} vs {losses['cpu'][1]:.6f} (|d| "
        f"{d1:.3g}, tol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the example model on the card disagrees with "
                             "the cpu or skipped its kernels")


# ------------------------------------------------------------- NCF slice

def ncf_data():
    """The synthetic MovieLens-1M (1,000,209 ratings, seed 0) split as
    bench.py's leave-one-out (``bench.py:139-159``): each of the first
    1000 users' last rating held out of training; each of them gets the
    held-out positive and 99 unseen negatives."""
    from analytics_zoo_tpu_torch.data.datasets import (
        ML1M_ITEMS, leave_one_out_eval_sets, movielens_1m)

    pairs, ratings = movielens_1m(seed=0)
    ev = leave_one_out_eval_sets(pairs, ML1M_ITEMS, n_negatives=99,
                                 max_users=NCF_EVAL_USERS)
    users = pairs[:, 0]
    last_row = len(users) - 1 - np.unique(users[::-1], return_index=True)[1]
    drop = last_row[np.isin(np.unique(users), ev[:, 0, 0])]
    mask = np.ones(len(users), dtype=bool)
    mask[drop] = False
    return (np.ascontiguousarray(pairs[mask]),
            np.ascontiguousarray((ratings[mask] - 1).astype(np.int32)), ev)


def _ncf_model(kind, device):
    """``(model, loss, optimizer, labels)`` of one recipe at ML-1M's
    width: explicit NeuralCF (5 rating classes, Adam 1e-3) or ImplicitNCF
    (4 negatives a positive, BCE, Adam 2.5e-3), default widths, seed 0."""
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS, ML1M_USERS
    from analytics_zoo_tpu_torch.models.recommendation import (
        ImplicitNCF, NeuralCF, implicit_bce_loss)
    from analytics_zoo_tpu_torch.nn.optimizers import Adam

    if kind == "explicit":
        return (NeuralCF(ML1M_USERS, ML1M_ITEMS, class_num=5, device=device),
                "sparse_categorical_crossentropy", Adam(lr=1e-3), "ratings")
    return (ImplicitNCF(ML1M_USERS, ML1M_ITEMS, n_negatives=4,
                        device=device),
            implicit_bce_loss, Adam(lr=2.5e-3), "dummy")


def _ncf_labels(which, y):
    return y if which == "ratings" else np.zeros(len(y), np.float32)


def _ncf_rank(torch, model, kind, ev):
    """HR@10 and NDCG@10 over the leave-one-out groups through
    ``nn/metrics.py``: explicit scored by expected rating (``bench.py:
    162-169``), implicit by probability."""
    from analytics_zoo_tpu_torch.nn.metrics import NDCG, HitRate

    probs = model.predict(ev.reshape(-1, 2), batch_size=NCF_BATCH)
    if kind == "explicit":
        probs = probs @ np.arange(1, probs.shape[1] + 1, dtype=np.float32)
    scores = torch.from_numpy(np.ascontiguousarray(
        probs.reshape(ev.shape[0], ev.shape[1])))
    out = []
    for m in (HitRate(10), NDCG(10)):
        out.append(m.result(m.update(m.init(), None, scores)))
    return out


def ncf_parity(torch, kind, x, y):
    """The first 8 steps of the recipe in f32 (device-cached, batch 8192,
    the first 8 x 8192 training pairs), card twice and CPU once: the
    card's per-step losses within 1e-5 relative of the CPU's, and
    (implicit) the negatives drawn on the card bit for bit the CPU's.
    The same steps in bf16 run twice on the card as well. Returns whether
    the two card runs gave the same losses bit for bit, in f32 and in
    bf16."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig

    n = NCF_PARITY_STEPS * NCF_BATCH
    xs = np.ascontiguousarray(x[:n])
    runs = {}
    for run in ("cuda", "cuda_again", "cpu", "bf16", "bf16_again"):
        dev = "cpu" if run == "cpu" else "cuda"
        model, loss, opt, which = _ncf_model(kind, dev)
        negs = []
        if kind == "implicit":
            draw = model.negatives

            def recording(pos, rng, draw=draw, negs=negs):
                out = draw(pos, rng)
                negs.append(out.cpu())
                return out

            model.negatives = recording
        model.compile(optimizer=opt, loss=loss, device=dev,
                      config=TrainConfig(
                          cache_on_device=True, scan_block_steps=1,
                          log_every_n_steps=1,
                          compute_dtype="bfloat16" if run.startswith("bf16")
                          else None))
        model.fit(xs, _ncf_labels(which, y[:n]), batch_size=NCF_BATCH,
                  nb_epoch=1)
        runs[run] = ([h["loss"] for h in model.estimator.history], negs)
        del model
    (lg, ng), (lg2, _), (lc, nc) = runs["cuda"], runs["cuda_again"], \
        runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    same_neg = (len(ng) == len(nc) == NCF_PARITY_STEPS and all(
        torch.equal(a, b) for a, b in zip(ng, nc))) if kind == "implicit" \
        else None
    repeat = {"f32": lg == lg2,
              "bf16": runs["bf16"][0] == runs["bf16_again"][0]}
    ok = (len(lg) == len(lc) == NCF_PARITY_STEPS and rel <= 1e-5
          and same_neg is not False)
    log(f"[ncf-parity] {kind} f32, {NCF_PARITY_STEPS} steps of {NCF_BATCH}"
        f" cached, cuda vs cpu: losses {[round(v, 6) for v in lg]} vs "
        f"{[round(v, 6) for v in lc]} (max rel {rel:.3g}, tol 1e-5); "
        f"negatives bit-identical over {len(ng)} steps: {same_neg}; two "
        f"card runs give the same losses: f32 {repeat['f32']}, bf16 "
        f"{repeat['bf16']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"NCF {kind} training on the card disagrees "
                             f"with the cpu")
    return repeat


def ncf_train(torch, kind, x, y, ev, smi, profile: bool = False):
    """The recipe in bf16 at full ML-1M width on the card: batch 8192,
    device-cached epochs of one block each, 4 epochs (the first a
    warm-up). Returns its numbers with HR@10 after the first epoch, for
    the CPU reference."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig

    model, loss, opt, which = _ncf_model(kind, "cuda")
    labels = _ncf_labels(which, y)
    n_steps = len(x) // NCF_BATCH
    model.compile(optimizer=opt, loss=loss, device="cuda", config=TrainConfig(
        compute_dtype="bfloat16", cache_on_device=True,
        scan_block_steps=n_steps, log_every_n_steps=n_steps))
    # earlier phases' models sit in reference cycles (model.estimator.model)
    # until the collector runs: free them, and count the peak above what
    # is still allocated when the phase starts
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(x, labels, batch_size=NCF_BATCH, nb_epoch=1)
    warm_s = time.perf_counter() - t0
    hr1, ndcg1 = _ncf_rank(torch, model, kind, ev)
    t1 = time.perf_counter()
    model.fit(x, labels, batch_size=NCF_BATCH, nb_epoch=NCF_EPOCHS)
    wall = time.perf_counter() - t1            # fit syncs before it returns
    hr, ndcg = _ncf_rank(torch, model, kind, ev)
    hist = model.estimator.history
    step_ms = [h["compute_ms"] for h in hist]
    res = {"model": kind, "batch": NCF_BATCH, "steps_per_epoch": n_steps,
           "train_pairs": len(x), "epochs": NCF_EPOCHS,
           "warmup_epoch_s": warm_s, "timed_epochs_s": wall,
           "samples_per_s": (NCF_EPOCHS - 1) * n_steps * NCF_BATCH / wall,
           "step_ms_by_epoch": step_ms,
           "step_ms_median": statistics.median(step_ms[1:]),
           "epoch_losses": [h["loss"] for h in hist],
           "final_loss": float(model.estimator.trainer_state.last_loss),
           "hr@10": hr, "ndcg@10": ndcg, "hr@10_epoch1": hr1,
           "ndcg@10_epoch1": ndcg1,
           "peak_memory_above_start": torch.cuda.max_memory_allocated() - base,
           "memory_allocated_at_start": base, "card": smi}
    if profile:
        res["profile"] = profile_ncf_epoch(torch, model, x, labels, smi, kind)
    log(f"[ncf] {json.dumps(res)}")
    finite = all(math.isfinite(v) for v in res["epoch_losses"])
    if not finite or len(res["epoch_losses"]) != NCF_EPOCHS:
        raise AssertionError(f"NCF {kind}: losses not finite or missing: "
                             f"{res['epoch_losses']}")
    return model, res


def profile_ncf_epoch(torch, model, x, labels, smi, kind):
    """Trace one more epoch (torch.profiler, device activity only: host
    ops' events would stretch the epoch and take seconds to fold): the
    device's busy share and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    epoch = model.estimator.trainer_state.epoch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(x, labels, batch_size=NCF_BATCH, nb_epoch=epoch + 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, busy = _device_rows(prof)
    log(f"[profile-ncf] {smi} | {kind}, one epoch of "
        f"{len(x) // NCF_BATCH} steps, wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.3f} of wall)")
    for key, count, ms in rows[:15]:
        log(f"[profile-ncf] {ms:9.3f} ms {count:6d} calls  {key[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms}


def ncf_cpu_reference(torch, kind, x, y, ev):
    """The same bf16 recipe on the CPU for one epoch: HR@10 and NDCG@10
    after it (the card's are read after its first epoch too)."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig

    model, loss, opt, which = _ncf_model(kind, "cpu")
    n_steps = len(x) // NCF_BATCH
    model.compile(optimizer=opt, loss=loss, device="cpu", config=TrainConfig(
        compute_dtype="bfloat16", cache_on_device=True,
        scan_block_steps=n_steps, log_every_n_steps=n_steps))
    t0 = time.perf_counter()
    model.fit(x, _ncf_labels(which, y), batch_size=NCF_BATCH, nb_epoch=1)
    hr, ndcg = _ncf_rank(torch, model, kind, ev)
    return hr, ndcg, time.perf_counter() - t0


def ncf_recommend_gate(model, ev) -> None:
    """``recommend_for_user`` on 20 users' 100 candidates each: 10 items
    a user, users ascending, each list in (-prediction, -probability)
    order, the predictions those of ``predict_user_item_pair``."""
    cands = ev[:20].reshape(-1, 2)
    recs = model.recommend_for_user(cands, max_items=10)
    by_user = {}
    for r in recs:
        by_user.setdefault(r.user_id, []).append(r)
    pred = {(p.user_id, p.item_id): (p.prediction, p.probability)
            for p in model.predict_user_item_pair(cands)}
    keys = {u: [(-r.prediction, -r.probability) for r in rs]
            for u, rs in by_user.items()}
    ok = (list(by_user) == sorted(set(cands[:, 0].tolist()))
          and all(len(k) == 10 and k == sorted(k) for k in keys.values())
          and all(pred[(r.user_id, r.item_id)] == (r.prediction,
                                                   r.probability)
                  for r in recs))
    log(f"[ncf] recommend_for_user: {len(by_user)} users x 10 items, each "
        f"in (-prediction, -probability) order: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("recommend_for_user broke its ordering")


def phase_ncf(torch, smi, profile: bool = False):
    """NCF, the reference's headline workload (``bench.py:228-258``), at
    MovieLens-1M's width through ``compile``/``fit``/``predict``: the f32
    parity of the first 8 steps with the CPU (and the implicit negatives
    bit for bit), then explicit NeuralCF and ImplicitNCF trained in bf16
    for 4 epochs on the card, HR@10 held to a one-epoch CPU run of the
    same recipe, and ``recommend_for_user``'s order."""
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    t0 = time.perf_counter()
    x, y, ev = ncf_data()
    wall = {"data": time.perf_counter() - t0}
    log(f"[ncf] data: {len(x)} training pairs, {ev.shape[0]} eval users x "
        f"{ev.shape[1]} candidates ({wall['data']:.1f} s)")
    out = {}
    for kind in ("explicit", "implicit"):
        t = time.perf_counter()
        repeat = ncf_parity(torch, kind, x, y)
        wall[f"{kind}_parity"] = time.perf_counter() - t
        t = time.perf_counter()
        model, res = ncf_train(torch, kind, x, y, ev, smi, profile)
        wall[f"{kind}_card"] = time.perf_counter() - t
        t = time.perf_counter()
        hr_cpu, ndcg_cpu, cpu_s = ncf_cpu_reference(torch, kind, x, y, ev)
        wall[f"{kind}_cpu_reference"] = time.perf_counter() - t
        gap = abs(res["hr@10_epoch1"] - hr_cpu)
        above = min(res["hr@10_epoch1"], hr_cpu, res["hr@10"]) > 0.10
        ok = gap <= 0.03 and above
        log(f"[ncf] {kind} HR@10 after epoch 1: card {res['hr@10_epoch1']:.4f}"
            f" vs cpu {hr_cpu:.4f} (|d| {gap:.4f}, tol 0.03; NDCG@10 "
            f"{res['ndcg@10_epoch1']:.4f} vs {ndcg_cpu:.4f}; cpu epoch "
            f"{cpu_s:.1f} s); after {NCF_EPOCHS} epochs HR@10 "
            f"{res['hr@10']:.4f}; all above the 0.10 random floor: {above} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"NCF {kind}: the card's HR@10 is off the "
                                 f"cpu's or at the random floor")
        if kind == "explicit":
            ncf_recommend_gate(model, ev)
        res.update(hr_at_10_cpu_epoch1=hr_cpu, card_runs_repeat=repeat)
        out[kind] = res
        del model
        torch.cuda.empty_cache()
    wall["phase"] = time.perf_counter() - t0
    log(f"[ncf] phase wall s: {json.dumps(wall)}")
    return out, (x, y, ev)

# --------------------------------------------------------- checkpoint slice

def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8),
        np.ascontiguousarray(b).reshape(-1).view(np.uint8)))


def _launch_counts(tfa):
    return (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches)


def _zero_launches(tfa) -> None:
    for f in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv):
        f.launches = 0


def _timed_saves(est, record) -> None:
    """Wrap the Estimator's ``_save``: what each save cost the loop."""
    save = est._save

    def timed(directory, durable=False, **kw):
        t0 = time.perf_counter()
        out = save(directory, durable=durable, **kw)
        record.append({"iteration": est.trainer_state.iteration,
                       "durable": durable,
                       "loop_ms": (time.perf_counter() - t0) * 1e3})
        return out

    est._save = timed


def ckpt_lm_resume(torch, smi, base_hist, tmp):
    """13a: phase 7's training checkpointed every 3 iterations; leg 1 runs
    its first 2 epochs (an async trigger save at iteration 3, durable
    epoch-end saves at 2 and 4), then a model from another seed resumes
    from the directory to epoch 4. Its 4 steps' losses and gradient norms
    equal phase 7's steps 5-8 bit for bit, the state it loaded equals leg
    1's final state bit for bit, and K1 = K3 = K4 = 12 x its 8
    micro-steps."""
    import shutil

    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine import checkpoint as tck
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    set_policy(compute_dtype="float32")
    d = os.path.join(tmp, "lm")
    ids = train_ids()
    x, y = ids[:, :-1], ids[:, 1:]

    def model(seed):
        return train_model(TransformerLM, lm_loss, TrainConfig, seed=seed,
                           checkpoint_dir=d, checkpoint_every_n_iters=3)

    m1 = model(0)
    n_params = sum(p.numel() for p in m1.parameters())
    est_bytes = n_params * (2 + 3 * 4)      # bf16 params; masters, mu, nu
    free = shutil.disk_usage(tmp).free
    log(f"[ckpt] {n_params} parameters: a checkpoint of ~{est_bytes / 1e9:.2f}"
        f" GB; {free / 1e9:.1f} GB free under {tmp}")
    if free < 5 * est_bytes:
        raise AssertionError(f"{tmp} has {free / 1e9:.1f} GB free; phase 13 "
                             f"needs {5 * est_bytes / 1e9:.1f} GB")
    saves = []
    _timed_saves(m1.estimator, saves)
    for k in tck.timings.values():
        k.clear()
    t0 = time.perf_counter()
    m1.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=2)
    leg1_s = time.perf_counter() - t0
    writes = list(tck.timings["write"])
    snaps = list(tck.timings["snapshot"])
    leg1 = [(h["loss"], h["grad_norm"]) for h in m1.estimator.history]
    base = [(h["loss"], h["grad_norm"]) for h in base_hist]
    final = tck.snapshot_state(m1.estimator.checkpoint_state()).wait()
    latest = tck.latest_checkpoint(d)
    manifest = tck.read_manifest(latest)
    names = sorted(os.listdir(d))
    del m1
    gc.collect()
    torch.cuda.empty_cache()
    for name in names:             # only the newest is needed from here on
        if os.path.join(d, name) != latest:
            shutil.rmtree(os.path.join(d, name))

    m2 = model(1)
    restore, loaded = m2.estimator._restore, {}

    def restore_and_compare(path):
        t = time.perf_counter()
        meta = restore(path)
        torch.cuda.synchronize()
        loaded["s"] = time.perf_counter() - t
        got = tck.snapshot_state(m2.estimator.checkpoint_state()).wait()
        loaded["same"] = len(got) == len(final) and all(
            _bits_equal(a, b) for a, b in zip(got, final))
        return meta

    m2.estimator._restore = restore_and_compare
    saves2 = []
    _timed_saves(m2.estimator, saves2)
    _zero_launches(tfa)
    t0 = time.perf_counter()
    m2.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=TRAIN_EPOCHS)
    leg2_s = time.perf_counter() - t0
    k1, k3, k4 = _launch_counts(tfa)
    leg2 = [(h["loss"], h["grad_norm"]) for h in m2.estimator.history]
    micro = len(leg2) * GRAD_ACCUM
    gb = manifest["state_bytes"] / 1e9
    res = {"checkpoint_gb": gb, "n_leaves": manifest["n_leaves"],
           "leg1_saves": saves, "leg2_saves": saves2,
           "snapshot_ms": [v * 1e3 for v in snaps],
           "write_ms": [v * 1e3 for v in writes],
           "write_mb_per_s": [manifest["state_bytes"] / v / 1e6
                              for v in writes],
           "load_verify_ms": loaded.get("s", float("nan")) * 1e3,
           "load_mb_per_s": manifest["state_bytes"] / loaded.get(
               "s", float("nan")) / 1e6,
           "leg1_s": leg1_s, "leg2_s": leg2_s, "resumed_from": latest,
           "launches": {"K1": k1, "K3": k3, "K4": k4}, "card": smi}
    log(f"[ckpt] {json.dumps(res)}")
    ok = (leg1 == base[:4] and leg2 == base[4:8] and loaded.get("same")
          and k1 == k3 == k4 == N_BLOCK * micro and micro == 8
          and manifest["iteration"] == 4 and manifest["epoch"] == 2)
    log(f"[ckpt] full-width LM resumed at iteration {manifest['iteration']} "
        f"from a {gb:.3f} GB checkpoint: leg 1 = phase 7's steps 1-4 "
        f"{leg1 == base[:4]}, the resumed steps = phase 7's steps 5-8 bit "
        f"for bit {leg2 == base[4:8]}, loaded state = leg 1's final state "
        f"bit for bit {loaded.get('same')}, K1/K3/K4 {k1}/{k3}/{k4} (need "
        f"{N_BLOCK} x {micro}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the full-width resume is not exact: {leg2} "
                             f"vs {base[4:8]}")
    del m2
    gc.collect()
    torch.cuda.empty_cache()
    return k1, k3, k4


def ckpt_ncf_resume(torch, smi, straight, data, tmp):
    """13b: phase 12's explicit recipe (bf16, device-cached epochs of one
    block) with checkpoints: 2 epochs with a trigger every 61 iterations,
    which the 121-step blocks cross, then a model from another seed
    resumes to epoch 4. Its final loss, HR@10 and NDCG@10 equal phase 12's
    straight 4-epoch run bit for bit."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS, ML1M_USERS
    from analytics_zoo_tpu_torch.engine import checkpoint as tck
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.nn.optimizers import Adam

    set_policy(compute_dtype="float32")
    x, y, ev = data
    n_steps = len(x) // NCF_BATCH
    every = n_steps // 2 + 1
    d = os.path.join(tmp, "ncf")

    def leg(seed, epochs):
        model = NeuralCF(ML1M_USERS, ML1M_ITEMS, class_num=5, device="cuda",
                         seed=seed)
        model.compile(optimizer=Adam(lr=1e-3),
                      loss="sparse_categorical_crossentropy", device="cuda",
                      config=TrainConfig(
                          compute_dtype="bfloat16", cache_on_device=True,
                          scan_block_steps=n_steps, log_every_n_steps=n_steps,
                          checkpoint_dir=d, checkpoint_every_n_iters=every))
        saves = []
        _timed_saves(model.estimator, saves)
        model.fit(x, y, batch_size=NCF_BATCH, nb_epoch=epochs)
        return model, saves

    t0 = time.perf_counter()
    m1, saves = leg(0, 2)
    del m1
    m2, _ = leg(1, NCF_EPOCHS)
    wall = time.perf_counter() - t0
    hr, ndcg = _ncf_rank(torch, m2, "explicit", ev)
    loss = float(m2.estimator.trainer_state.last_loss)
    want = (straight["final_loss"], straight["hr@10"], straight["ndcg@10"])
    # every block crossed a multiple of the trigger: an async save after
    # each, then the epoch's durable one
    kinds = [(s["iteration"], s["durable"]) for s in saves]
    ok = ((loss, hr, ndcg) == want and m2.estimator.trainer_state.epoch
          == NCF_EPOCHS and kinds == [(n_steps, False), (n_steps, True),
                                      (2 * n_steps, False),
                                      (2 * n_steps, True)])
    log(f"[ckpt-ncf] explicit NCF, {n_steps}-step cached blocks, trigger "
        f"every {every}: leg 1's saves (iteration, durable) {kinds}; "
        f"resumed to "
        f"epoch {NCF_EPOCHS}: final loss {loss!r}, HR@10 {hr!r}, NDCG@10 "
        f"{ndcg!r} vs the straight run's {want} (bit for bit); "
        f"{wall:.1f} s, {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the NCF resume differs from the straight run")
    del m2
    torch.cuda.empty_cache()


EXAMPLE_KW = dict(vocab=256, hidden_size=64, n_block=2, n_head=4,
                  seq_len=64, attn_strategy="flash", remat="flash")

SIGTERM_CHILD = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from analytics_zoo_tpu_torch.common.chaos import ChaosSchedule, install_chaos
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.models.transformer import TransformerLM, lm_loss

install_chaos(ChaosSchedule().delay("estimator.step", at=None, seconds=0.2))
ids = np.random.default_rng(16).integers(0, 256, size=(8, 65)).astype(np.int32)
model = TransformerLM(device="cuda", seed=0, **{kw})
model.compile(optimizer="adam", loss=lm_loss, config=TrainConfig(
    checkpoint_dir=sys.argv[1], shuffle=False, log_every_n_steps=1))
model.fit(ids[:, :-1], ids[:, 1:], batch_size=8, nb_epoch=100000)
print("FINISHED", flush=True)
"""


def _example_model(TransformerLM, lm_loss, TrainConfig, seed=0, **cfg):
    """Phase 11's example model on the card, compiled for Adam in f32."""
    model = TransformerLM(device="cuda", seed=seed, **EXAMPLE_KW)
    model.compile(optimizer="adam", loss=lm_loss, config=TrainConfig(
        shuffle=False, log_every_n_steps=1, **cfg))
    return model


def ckpt_sigterm(torch, smi, tmp):
    """13c: a training process at phase 11's example width (one step an
    epoch, every step slowed 0.2 s by a chaos delay) gets SIGTERM after
    its first checkpoint: it saves a final checkpoint and exits 143; a
    model from another seed resumes from it 3 epochs further, and its
    losses equal an uninterrupted run's bit for bit."""
    import signal

    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine import checkpoint as tck
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)

    d = os.path.join(tmp, "sigterm")
    code = SIGTERM_CHILD.replace("{kw}", repr(EXAMPLE_KW))
    proc = subprocess.Popen([sys.executable, "-c", code, d, str(ROOT)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        t0 = time.perf_counter()
        while tck.latest_checkpoint(d) is None:
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError("the child wrote no checkpoint: "
                                     + proc.stderr.read().decode()[-2000:])
            time.sleep(0.05)
        first = tck.read_manifest(tck.latest_checkpoint(d))["iteration"]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    final = tck.verify_checkpoint(tck.latest_checkpoint(d))
    k = final["iteration"]
    ids = np.random.default_rng(16).integers(0, 256, size=(8, 65)).astype(
        np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    straight = _example_model(TransformerLM, lm_loss, TrainConfig)
    straight.fit(x, y, batch_size=8, nb_epoch=k + 3)
    resumed = _example_model(TransformerLM, lm_loss, TrainConfig, seed=1,
                             checkpoint_dir=d)
    resumed.fit(x, y, batch_size=8, nb_epoch=k + 3)
    want = [h["loss"] for h in straight.estimator.history][k:]
    got = [h["loss"] for h in resumed.estimator.history]
    ok = (proc.returncode == 143 and b"FINISHED" not in out and k >= first
          and final["epoch"] == k and got == want and len(got) == 3)
    log(f"[ckpt-sigterm] child exit {proc.returncode} (need 143), first "
        f"checkpoint at {first}, final at {k}; resumed losses {got} vs the "
        f"uninterrupted run's {want} (bit for bit) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("SIGTERM on the card: " + err.decode()[-2000:])


def ckpt_retry(torch, smi, tmp):
    """13d: at the example width, 4 steps an epoch, checkpoints every 3:
    a step that raises twice at iteration 7 rolls back to 6 and replays
    its epoch (iteration 14, epoch 3: tests/test_fault_injection.py's
    counts); one that raises twice at iteration 8, an epoch's first, ends
    on the uninterrupted run's losses bit for bit."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)

    ids = np.random.default_rng(17).integers(0, 256, size=(16, 65)).astype(
        np.int32)
    x, y = ids[:, :-1], ids[:, 1:]

    def run(fail_at, directory):
        m = _example_model(TransformerLM, lm_loss, TrainConfig,
                           checkpoint_dir=directory,
                           checkpoint_every_n_iters=3, retry_times=3)
        est, fails = m.estimator, {"left": 2}
        step = est._step

        def flaky(batch):
            if est.train_state["step"] == fail_at and fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("injected failure")
            return step(batch)

        est._step = flaky
        m.fit(x, y, batch_size=4, nb_epoch=3)
        ts = est.trainer_state
        return (ts.iteration, ts.epoch, fails["left"],
                [h["loss"] for h in est.history])

    clean = _example_model(TransformerLM, lm_loss, TrainConfig)
    clean.fit(x, y, batch_size=4, nb_epoch=3)
    want = [h["loss"] for h in clean.estimator.history]
    a = run(7, os.path.join(tmp, "retry7"))
    b = run(8, os.path.join(tmp, "retry8"))
    ok = (a[:3] == (14, 3, 0) and b[:3] == (12, 3, 0)
          and b[3][-4:] == want[-4:])
    log(f"[ckpt-retry] fail twice at 7: iteration {a[0]}, epoch {a[1]} "
        f"(need 14, 3); fail twice at 8: iteration {b[0]}, epoch {b[1]}, "
        f"last epoch's losses {b[3][-4:]} vs uninterrupted {want[-4:]} (bit "
        f"for bit) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("retry from checkpoint on the card")


def ckpt_remat_dots(torch, smi, base_hist):
    """13e: phase 7's first step (2 micro-steps) under remat "dots" and
    "flash": K1 = K3 = K4 = 12 x 2 each, the loss and gradient norm the
    same bits (and phase 7's first step's); the peak memory of each."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    set_policy(compute_dtype="float32")
    ids = train_ids()[:TRAIN_BATCH]
    out = {}
    for remat in ("flash", "dots"):
        m = train_model(TransformerLM, lm_loss, TrainConfig, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches(tfa)
        m.fit(ids[:, :-1], ids[:, 1:], batch_size=TRAIN_BATCH, nb_epoch=1)
        h = m.estimator.history[0]
        out[remat] = {"loss": h["loss"], "grad_norm": h["grad_norm"],
                      "launches": _launch_counts(tfa),
                      "peak_above_start": torch.cuda.max_memory_allocated()
                      - start, "step_ms": h["data_ms"] + h["compute_ms"]}
        del m
    base = (base_hist[0]["loss"], base_hist[0]["grad_norm"])
    same = all((out[r]["loss"], out[r]["grad_norm"]) == base
               for r in out)
    ok = same and all(out[r]["launches"] == (N_BLOCK * GRAD_ACCUM,) * 3
                      for r in out)
    log(f"[ckpt-remat] {json.dumps({'card': smi, **out})}")
    log(f"[ckpt-remat] one full-width step, remat 'dots' vs 'flash': loss and"
        f" grad norm the same bits (and phase 7's step 1) {same}; peak memory"
        f" above start {out['dots']['peak_above_start'] / 2**30:.2f} GiB vs "
        f"{out['flash']['peak_above_start'] / 2**30:.2f} GiB "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("remat 'dots' differs from 'flash'")
    torch.cuda.empty_cache()
    return out["dots"]["launches"]


def phase_checkpoint(torch, smi, train_hist, ncf_straight, ncf_data_):
    """Phase 13: checkpoint and resume (13a-13e) in a temp directory that
    is deleted at the end."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="zoo-ckpt-")
    t0 = time.perf_counter()
    try:
        launches = ckpt_lm_resume(torch, smi, train_hist, tmp)
        ckpt_ncf_resume(torch, smi, ncf_straight, ncf_data_, tmp)
        ckpt_sigterm(torch, smi, tmp)
        ckpt_retry(torch, smi, tmp)
        dots = ckpt_remat_dots(torch, smi, train_hist)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[ckpt] phase wall s: {time.perf_counter() - t0:.1f}")
    return launches, dots


# ------------------------------------- recommenders and the input pipeline

# phase 14: 14a Wide & Deep on MovieLens-1M (the reference's
# recommendation-wide-n-deep app), 14b SessionRecommender on ML-1M
# sessions, 14c bench.py's input-pipeline recipe (bench.py:491-620)
ML1M_AGES = (1, 18, 25, 35, 45, 50, 56)        # ML-1M's seven age codes
WND_BATCH, WND_EPOCHS, WND_PARITY_STEPS, WND_CHECK_ROWS = 8192, 4, 8, 10_000
SESS_WINDOW, SESS_BATCH, SESS_EPOCHS, SESS_HELD_USERS = 11, 1024, 2, 1000
SESS_PARITY_STEPS = 8
PIPE_RECORDS, PIPE_FLOATS, PIPE_BATCH, PIPE_EPOCHS = 1024, 8192, 128, 3
PIPE_HIDDEN = 768
# SGD's rate in 14c: the decoded features reach ~130, and at sgd's default
# 0.01 (bench.py's) the loss overflows to inf by the fourth step
PIPE_LR = 1e-6
REC_RATINGS = None                     # None: ML-1M's 1,000,209 ratings


def rec_ratings():
    """The synthetic ML-1M of phase 12 (seed 0)."""
    from analytics_zoo_tpu_torch.data.datasets import (ML1M_RATINGS,
                                                       synthetic_movielens)

    return synthetic_movielens(REC_RATINGS or ML1M_RATINGS, seed=0)


def wnd_columns():
    """The reference app's columns (its public notebook): wide base
    occupation 21 and gender 3, the age-gender cross in 100 hash buckets,
    indicators genres 19 and gender 3, userId 6040 -> 64 and itemId 3706
    -> 64 embeddings, age continuous."""
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS, ML1M_USERS
    from analytics_zoo_tpu_torch.models.recommendation import \
        ColumnFeatureInfo

    return ColumnFeatureInfo(
        wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
        wide_cross_cols=["age-gender"], wide_cross_dims=[100],
        indicator_cols=["genres", "gender"], indicator_dims=[19, 3],
        embed_cols=["userId", "itemId"],
        embed_in_dims=[ML1M_USERS, ML1M_ITEMS], embed_out_dims=[64, 64],
        continuous_cols=["age"], label="label")


def wnd_data(pairs, ratings):
    """14a's four inputs and labels over every rating, built with numpy:
    per-user gender (1 F, 2 M), age code and occupation and per-item genre
    from ``default_rng(1)``; the first ``WND_CHECK_ROWS`` rows are held
    to ``rows_to_batch`` over the same rows as mappings."""
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS, ML1M_USERS
    from analytics_zoo_tpu_torch.models.recommendation import (hash_bucket,
                                                               rows_to_batch)

    rng = np.random.default_rng(1)
    gender = rng.integers(1, 3, ML1M_USERS + 1)
    age = np.asarray(ML1M_AGES)[rng.integers(0, 7, ML1M_USERS + 1)]
    occupation = rng.integers(0, 21, ML1M_USERS + 1)
    genre = rng.integers(0, 19, ML1M_ITEMS + 1)
    cross_lut = np.array([[hash_bucket(f"{a}_{g}", 100) if g else 0
                           for g in range(3)] for a in ML1M_AGES])
    u, i = pairs[:, 0], pairs[:, 1]
    g, a = gender[u], age[u]
    cross = cross_lut[np.searchsorted(ML1M_AGES, a), g]
    n, rows = len(u), np.arange(len(u))
    wide = np.zeros((n, 124), np.float32)
    wide[rows, occupation[u]] = 1.0
    wide[rows, 21 + g] = 1.0
    wide[rows, 24 + cross] = 1.0
    ind = np.zeros((n, 22), np.float32)
    ind[rows, genre[i]] = 1.0
    ind[rows, 19 + g] = 1.0
    xs = [wide, ind, np.stack([u, i], 1).astype(np.float32),
          a[:, None].astype(np.float32)]
    y = (ratings - 1).astype(np.int32)
    m = min(WND_CHECK_ROWS, n)
    mapped = [{"occupation": occupation[u[r]], "gender": g[r],
               "age-gender": hash_bucket(f"{a[r]}_{g[r]}", 100),
               "genres": genre[i[r]], "userId": u[r], "itemId": i[r],
               "age": a[r], "label": y[r]} for r in range(m)]
    want, want_y = rows_to_batch(mapped, wnd_columns())
    same = all(np.array_equal(w, x[:m]) for w, x in zip(want, xs)) and \
        np.array_equal(want_y, y[:m].astype(np.float32))
    log(f"[rec] 14a features of {n} ratings built with numpy; the first "
        f"{m} rows equal rows_to_batch's: {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("Wide & Deep features differ from "
                             "rows_to_batch")
    return xs, y


def _rec_train(torch, make, x, y, *, dev, batch, epochs, depth, bf16,
               lr=1e-3, optimizer="adam", loss="sparse_categorical_crossentropy",
               model=None):
    """``compile``/``fit`` a streaming run (``prefetch_depth=depth``,
    shuffled epochs of seed 0); the loss of every step is kept on the
    device and read after the fit, so no step waits for the host. Log
    points fall at each epoch's end (its data and compute ms a step).
    Returns the model and the step losses."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.nn.optimizers import SGD, Adam

    if model is None:
        model = make(dev)
        steps = len(x if y is None else y) // batch
        model.compile(
            optimizer=(Adam(lr=lr) if optimizer == "adam" else SGD(lr=lr)),
            loss=loss, device=dev, config=TrainConfig(
                compute_dtype="bfloat16" if bf16 else None,
                prefetch_depth=depth, log_every_n_steps=steps))
        est = model.estimator
        est.step_losses = []
        step = est._step

        def recording(b):
            out = step(b)
            est.step_losses.append(out[0].detach())
            return out

        est._step = recording
    model.fit(x, y, batch_size=batch,
              nb_epoch=model.estimator.trainer_state.epoch + epochs)
    losses = [float(v) for v in torch.stack(model.estimator.step_losses)
              .float().cpu()]
    return model, losses


def _peak_start(torch):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return base


def _rel(a, b) -> float:
    return max(abs(p - q) / max(abs(q), 1e-12) for p, q in zip(a, b))


def _parity(torch, make, x, y, batch, steps, label):
    """The first ``steps`` steps in f32, streaming at depth 2, on the card
    and on the CPU: per-step losses within 1e-5 relative."""
    n = steps * batch
    xs = [a[:n] for a in x] if isinstance(x, list) else x[:n]
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = _rec_train(torch, make, xs, y[:n], dev=DEV[dev],
                               batch=batch, epochs=1, depth=2, bf16=False)[1]
    rel = _rel(runs["cuda"], runs["cpu"])
    ok = len(runs["cuda"]) == len(runs["cpu"]) == steps and rel <= 1e-5
    log(f"[rec-parity] {label} f32, {steps} steps of {batch}, cuda vs cpu: "
        f"losses {[round(v, 6) for v in runs['cuda']]} vs "
        f"{[round(v, 6) for v in runs['cpu']]} (max rel {rel:.3g}, tol "
        f"1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's f32 losses are off the "
                             f"cpu's")
    return rel


#: phase 14's devices; a rehearsal on a host without a card maps both to
#: the CPU
DEV = {"cuda": "cuda", "cpu": "cpu"}


def _epoch_windows(model):
    """The log points' per-step data and compute ms (one an epoch)."""
    hist = model.estimator.history
    return [h["data_ms"] for h in hist], [h["compute_ms"] for h in hist]


def phase_wide_and_deep(torch, smi, pairs, ratings, profile=False):
    """14a: Wide & Deep (wide_n_deep, hidden 40-20-10, 5 classes) on the
    synthetic ML-1M with the reference app's columns, an 80/20 split,
    batch 8192, Adam 1e-3, bf16 with f32 masters, streaming at depth 2."""
    from analytics_zoo_tpu_torch.data.datasets import \
        train_test_split_by_user
    from analytics_zoo_tpu_torch.models.recommendation import WideAndDeep

    wall = {}
    t = time.perf_counter()
    xs, y = wnd_data(pairs, ratings)
    n = len(y)
    (tr, _), (te, _) = train_test_split_by_user(np.arange(n), np.arange(n),
                                                test_frac=0.2)
    x_tr = [np.ascontiguousarray(a[tr]) for a in xs]
    x_te = [np.ascontiguousarray(a[te]) for a in xs]
    y_tr, y_te = y[tr], y[te]
    del xs
    wall["data"] = time.perf_counter() - t
    ci = wnd_columns()

    def make(dev):
        return WideAndDeep(5, ci, "wide_n_deep", device=dev, seed=0)

    t = time.perf_counter()
    rel = _parity(torch, make, x_tr, y_tr, WND_BATCH, WND_PARITY_STEPS,
                  "14a wide_n_deep")
    wall["parity"] = time.perf_counter() - t
    steps = len(y_tr) // WND_BATCH
    t = time.perf_counter()
    base = _peak_start(torch)
    t0 = time.perf_counter()
    model, first = _rec_train(torch, make, x_tr, y_tr, dev=DEV["cuda"],
                              batch=WND_BATCH, epochs=1, depth=2, bf16=True)
    warm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    model, losses = _rec_train(torch, None, x_tr, y_tr, dev=DEV["cuda"],
                               batch=WND_BATCH, epochs=WND_EPOCHS - 1,
                               depth=2, bf16=True, model=model)
    timed_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    data_ms, compute_ms = _epoch_windows(model)
    wall["card_train"] = time.perf_counter() - t
    t = time.perf_counter()
    metrics = model.evaluate(x_te, y_te, batch_size=WND_BATCH)
    acc = next(iter(metrics.values()))
    probs = model.predict(x_te, batch_size=WND_BATCH)
    acc_pred = float(np.mean(probs.argmax(-1) == y_te))
    wall["evaluate_predict"] = time.perf_counter() - t
    t = time.perf_counter()
    runs = {}
    for name, depth in (("depth0", 0), ("again", 2)):
        m, runs[name] = _rec_train(torch, make, x_tr, y_tr, dev=DEV["cuda"],
                                   batch=WND_BATCH, epochs=1, depth=depth,
                                   bf16=True)
        if name == "depth0":
            data0 = _epoch_windows(m)[0][0]
        del m
    wall["card_reruns"] = time.perf_counter() - t
    d0_same = runs["depth0"] == losses[:steps]
    again_same = runs["again"] == losses[:steps]
    res = {"steps_per_epoch": steps, "train_rows": len(y_tr),
           "test_rows": len(y_te), "epochs": WND_EPOCHS,
           "warmup_epoch_s": warm_s, "timed_epochs_s": timed_s,
           "samples_per_s": (WND_EPOCHS - 1) * steps * WND_BATCH / timed_s,
           "step_ms_by_epoch": compute_ms,
           "data_wait_ms_by_epoch_depth2": data_ms,
           "data_wait_ms_epoch1_depth0": data0,
           "epoch_final_losses": [losses[(e + 1) * steps - 1]
                                  for e in range(WND_EPOCHS)],
           "top1_accuracy": acc, "top1_accuracy_from_predict": acc_pred,
           "peak_memory_above_start": peak, "parity_max_rel": rel,
           "depth0_equals_depth2_epoch1": d0_same,
           "two_card_runs_equal_epoch1": again_same, "card": smi}
    log(f"[rec-wnd] {json.dumps(res)}")
    ok = (d0_same and again_same and abs(acc - acc_pred) <= 1e-6
          and all(math.isfinite(v) for v in losses)
          and probs.shape == (len(y_te), 5) and np.isfinite(probs).all()
          and np.allclose(probs.sum(-1), 1.0, atol=2e-2)
          and acc > 0.2)
    log(f"[rec-wnd] epoch 1 at depth 0 and at depth 2 bit-identical: "
        f"{d0_same}; two card runs bit-identical: {again_same}; evaluate "
        f"accuracy {acc:.4f} = predict's {acc_pred:.4f}; probabilities "
        f"finite, rows sum to 1 {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Wide & Deep on the card failed a gate")
    if profile:
        res["profile"] = profile_rec(torch, model, x_tr, y_tr, WND_BATCH,
                                     smi, "wnd")
    del model
    return res, wall


def session_data(pairs):
    """14b's sessions: each user's ratings in data order cut into
    non-overlapping windows of 11; 10 items predict the 11th (0-based
    label); the 10 items before the window are the history, 0-padded.
    Each of the first 1000 users' last window is held out."""
    users, items = pairs[:, 0], pairs[:, 1]
    order = np.argsort(users, kind="stable")
    it = items[order]
    _, start, count = np.unique(users[order], return_index=True,
                                return_counts=True)
    n_win = count // SESS_WINDOW
    owner = np.repeat(np.arange(len(count)), n_win)
    k = np.arange(n_win.sum()) - np.repeat(np.cumsum(n_win) - n_win, n_win)
    s = start[owner] + k * SESS_WINDOW
    span = np.arange(SESS_WINDOW - 1)
    sess = it[s[:, None] + span].astype(np.float32)
    label = (it[s + SESS_WINDOW - 1] - 1).astype(np.int32)
    hpos = s[:, None] - (SESS_WINDOW - 1) + span
    hist = np.where(hpos >= start[owner][:, None], it[np.maximum(hpos, 0)],
                    0).astype(np.float32)
    held = (owner < SESS_HELD_USERS) & (k == n_win[owner] - 1)
    return sess, hist, label, held


def phase_session(torch, smi, pairs, profile=False):
    """14b: SessionRecommender (3706 items, item_embed 64, GRUs 40-20, MLP
    40-20, session 10, history 10) on ML-1M sessions, batch 1024, Adam
    1e-3, bf16 with f32 masters, streaming at depth 2, 2 epochs."""
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS
    from analytics_zoo_tpu_torch.models.recommendation import \
        SessionRecommender

    wall = {}
    t = time.perf_counter()
    sess, hist, label, held = session_data(pairs)
    x_tr = [np.ascontiguousarray(sess[~held]), np.ascontiguousarray(
        hist[~held])]
    y_tr = label[~held]
    x_ho = [sess[held], hist[held]]
    y_ho = label[held]
    wall["data"] = time.perf_counter() - t

    def make(dev):
        return SessionRecommender(
            ML1M_ITEMS, 64, rnn_hidden_layers=(40, 20),
            session_length=SESS_WINDOW - 1, include_history=True,
            mlp_hidden_layers=(40, 20), history_length=SESS_WINDOW - 1,
            device=dev, seed=0)

    t = time.perf_counter()
    rel = _parity(torch, make, x_tr, y_tr, SESS_BATCH, SESS_PARITY_STEPS,
                  "14b session")
    wall["parity"] = time.perf_counter() - t
    steps = len(y_tr) // SESS_BATCH
    t = time.perf_counter()
    base = _peak_start(torch)
    model, _ = _rec_train(torch, make, x_tr, y_tr, dev=DEV["cuda"],
                          batch=SESS_BATCH, epochs=1, depth=2, bf16=True)
    t1 = time.perf_counter()
    model, losses = _rec_train(torch, None, x_tr, y_tr, dev=DEV["cuda"],
                               batch=SESS_BATCH, epochs=SESS_EPOCHS - 1,
                               depth=2, bf16=True, model=model)
    timed_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    data_ms, compute_ms = _epoch_windows(model)
    wall["card_train"] = time.perf_counter() - t
    t = time.perf_counter()
    again, again_losses = _rec_train(torch, make, x_tr, y_tr,
                                     dev=DEV["cuda"], batch=SESS_BATCH,
                                     epochs=1, depth=2, bf16=True)
    del again
    same = again_losses == losses[:steps]
    wall["card_rerun"] = time.perf_counter() - t
    t = time.perf_counter()
    probs = model.predict(x_ho, batch_size=SESS_BATCH)
    top = np.argsort(-probs, axis=-1)[:, :10]
    hit = float(np.mean((top == y_ho[:, None]).any(-1)))
    # the trained weights in f32 on the card and on the CPU:
    # recommend_for_session's items and probabilities
    weights = {k: v.float().cpu() for k, v in model.state_dict().items()}
    recs = {}
    for dev in ("cuda", "cpu"):
        m = make(DEV[dev])
        m.load_state_dict(weights)
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device=DEV[dev])
        recs[dev] = (m.recommend_for_session(x_ho, max_items=10),
                     m.predict(x_ho, batch_size=SESS_BATCH))
        del m
    p_cpu = recs["cpu"][1]
    top11 = -np.sort(-p_cpu, axis=-1)[:, :11]
    untied = np.diff(-top11, axis=-1).min(axis=-1) > 1e-5
    same_items = [[i for i, _ in a] == [i for i, _ in b]
                  for a, b in zip(recs["cuda"][0], recs["cpu"][0])]
    items_ok = all(s for s, u in zip(same_items, untied) if u)
    prob_gap = float(np.abs(recs["cuda"][1] - p_cpu).max())
    wall["recommend"] = time.perf_counter() - t
    res = {"sessions_train": len(y_tr), "sessions_held": len(y_ho),
           "steps_per_epoch": steps, "epochs": SESS_EPOCHS,
           "timed_epochs_s": timed_s,
           "samples_per_s": (SESS_EPOCHS - 1) * steps * SESS_BATCH / timed_s,
           "step_ms_by_epoch": compute_ms,
           "data_wait_ms_by_epoch": data_ms,
           "epoch_final_losses": [losses[(e + 1) * steps - 1]
                                  for e in range(SESS_EPOCHS)],
           "hit_rate_at_10": hit, "parity_max_rel": rel,
           "two_card_runs_equal_epoch1": same,
           "recommend_untied_sessions": int(untied.sum()),
           "recommend_same_items_untied": items_ok,
           "recommend_same_items_all": int(sum(same_items)),
           "recommend_max_prob_diff": prob_gap,
           "peak_memory_above_start": peak, "card": smi}
    log(f"[rec-session] {json.dumps(res)}")
    ok = (same and items_ok and untied.sum() >= len(y_ho) // 2
          and prob_gap <= 1e-5 and all(math.isfinite(v) for v in losses)
          and np.isfinite(probs).all() and hit > 10 / ML1M_ITEMS)
    log(f"[rec-session] two card runs bit-identical: {same}; "
        f"recommend_for_session(10) on {len(y_ho)} held-out sessions: card "
        f"= cpu items on the {int(untied.sum())} without ties (all "
        f"{int(sum(same_items))}), max |d prob| {prob_gap:.3g} (tol 1e-5); "
        f"hit rate @10 {hit:.4f} (random {10 / ML1M_ITEMS:.4f}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("SessionRecommender on the card failed a gate")
    if profile:
        res["profile"] = profile_rec(torch, model, x_tr, y_tr, SESS_BATCH,
                                     smi, "session")
        res["profile"]["gru_step_launches"] = profile_gru_step(torch, model)
    del model
    return res, wall


def _pipe_recipe():
    """bench.py::run_data_pipeline's records and decoder: 1024 records of
    8192 float32s; a record decodes by a sort and a (90, 90) x (90, 64)
    product to 64 features and a 0/1 label."""
    rng = np.random.default_rng(0)
    side = int(np.sqrt(PIPE_FLOATS))
    records = [rng.normal(size=PIPE_FLOATS).astype(np.float32).tobytes()
               for _ in range(PIPE_RECORDS)]

    def decoder(r):
        a = np.sort(np.frombuffer(r, np.float32))
        m = a[:side * side].reshape(side, side)
        v = (m @ m[:64].T).mean(axis=1)[:64]
        return v.astype(np.float32), np.float32(v[0] > 0)

    return records, decoder


def phase_input_pipeline(torch, smi):
    """14c: the recipe trained at prefetch_depth 0 and then 2 (Dense 768
    relu x3 -> Dense 1, SGD, MSE, batch 128, a warm-up epoch then 3):
    the async stream byte-identical to the sync one, the losses finite
    and bit-identical, DataWaitMs a step and samples/s at each depth."""
    from analytics_zoo_tpu_torch.data import FeatureSet, PrefetchLoader
    from analytics_zoo_tpu_torch.nn import layers as L
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    records, decoder = _pipe_recipe()

    def fs():
        return FeatureSet.from_bytes(records, decoder, seed=7)

    sync = list(fs().batches(PIPE_BATCH, epoch=1))
    with PrefetchLoader(fs(), PIPE_BATCH, epoch=1, depth=2) as loader:
        stream = list(loader)
    same_stream = len(sync) == len(stream) and all(
        a.tobytes() == b.tobytes() and a.dtype == b.dtype
        for s, q in zip(sync, stream) for a, b in zip(s, q))

    def make(dev):
        return Sequential([L.Dense(PIPE_HIDDEN, activation="relu",
                                   input_shape=(64,)),
                           L.Dense(PIPE_HIDDEN, activation="relu"),
                           L.Dense(PIPE_HIDDEN, activation="relu"),
                           L.Dense(1)], device=dev, seed=0)

    steps = PIPE_RECORDS // PIPE_BATCH
    out = {}
    for depth in (0, 2):
        model, _ = _rec_train(torch, make, fs(), None, dev=DEV["cuda"],
                              batch=PIPE_BATCH, epochs=1, depth=depth,
                              bf16=False, lr=PIPE_LR, optimizer="sgd",
                              loss="mse")
        t0 = time.perf_counter()
        model, losses = _rec_train(torch, None, fs(), None, dev=DEV["cuda"],
                                   batch=PIPE_BATCH, epochs=PIPE_EPOCHS,
                                   depth=depth, bf16=False, model=model)
        dt = time.perf_counter() - t0
        data_ms, compute_ms = _epoch_windows(model)
        out[depth] = {"losses": losses,
                      "final_loss": losses[-1],
                      "data_wait_ms_per_step": statistics.mean(data_ms[1:]),
                      "compute_ms_per_step": statistics.mean(compute_ms[1:]),
                      "samples_per_s": PIPE_EPOCHS * steps * PIPE_BATCH / dt}
        del model
    same_losses = out[0]["losses"] == out[2]["losses"]
    res = {"records": PIPE_RECORDS, "record_bytes": PIPE_FLOATS * 4,
           "batch": PIPE_BATCH, "steps_per_epoch": steps,
           "byte_identical_stream": same_stream,
           "losses_bit_identical": same_losses,
           **{f"depth{d}": {k: v for k, v in r.items() if k != "losses"}
              for d, r in out.items()}, "card": smi}
    log(f"[rec-pipeline] {json.dumps(res)}")
    finite = all(math.isfinite(v) for r in out.values() for v in r["losses"])
    ok = same_stream and same_losses and finite
    log(f"[rec-pipeline] async stream byte-identical to the sync one: "
        f"{same_stream}; depth 0 and depth 2 losses bit-identical: "
        f"{same_losses}; losses finite: {finite}; DataWaitMs a step {out[0]['data_wait_ms_per_step']:.3f}"
        f" (depth 0) vs {out[2]['data_wait_ms_per_step']:.3f} (depth 2) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the input pipeline changed the stream or the "
                             "losses")
    return res


def _overlap_share(prof):
    """The share of the traced H2D copies' device time that a kernel ran
    beside, and the copies' count and ms."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    copies = [(e.time_range.start, e.time_range.end) for e in evs
              if "HtoD" in e.name]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if "Memcpy" not in e.name and "Memset" not in e.name)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = sum(b - a for a, b in copies)
    shared = sum(max(0.0, min(b, mb) - max(a, ma))
                 for a, b in copies for ma, mb in merged)
    return len(copies), total / 1e3, (shared / total if total else 0.0)


def profile_rec(torch, model, x, y, batch, smi, label, steps: int = 8):
    """Trace ``steps`` more streaming steps of a trained model (device
    activity): launches a step, the largest kernels, the H2D copies and
    how much of their time a kernel ran beside."""
    from torch.profiler import ProfilerActivity, profile

    n = steps * batch
    xs = [a[:n] for a in x] if isinstance(x, list) else x[:n]
    est = model.estimator
    est.step_losses = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(xs, y[:n], batch_size=batch,
                  nb_epoch=est.trainer_state.epoch + 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, busy = _device_rows(prof)
    launches = sum(c for k, c, _ in rows if "Memcpy" not in k
                   and "Memset" not in k)
    n_copy, copy_ms, share = _overlap_share(prof)
    log(f"[profile-rec] {smi} | {label}, {steps} steps of {batch}, wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms ({busy / wall_ms:.3f}"
        f" of wall), {launches / steps:.0f} kernel launches a step; H2D "
        f"copies {n_copy} ({copy_ms:.3f} ms), {share:.3f} of their time "
        f"beside a kernel")
    for key, count, ms in rows[:15]:
        log(f"[profile-rec] {ms:9.3f} ms {count:6d} calls  {key[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "launches_per_step": launches / steps, "h2d_copies": n_copy,
            "h2d_ms": copy_ms, "h2d_share_beside_kernels": share}


def profile_gru_step(torch, model):
    """Device launches of one GRU time step, forward only, at the
    model's shapes: a step of the training forward launches this many,
    ten time steps a layer."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.nn.layers import GRU

    out = {}
    for gru in (m for m in model.modules() if isinstance(m, GRU)):
        dt = next(model.parameters()).dtype
        h = torch.zeros((SESS_BATCH, gru.output_dim), dtype=dt,
                        device="cuda")
        xw = torch.zeros((SESS_BATCH, 3 * gru.output_dim), dtype=dt,
                         device="cuda")
        u = gru.recurrent_kernel.detach()
        with torch.no_grad():
            gru.step(xw, h, u)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                gru.step(xw, h, u)
                torch.cuda.synchronize()
        out[gru.name] = sum(c for _, c, _ in _device_rows(prof)[0])
    log(f"[profile-rec] one GRU time step's forward launches by layer: "
        f"{out} (x {SESS_WINDOW - 1} steps a layer a forward)")
    return out


# ------------------------------------------------- phase 15: serving remainder

def _finals_by_name(streams):
    """An on_chunk factory recording each named stream's tokens, the time
    and meta of its first frame and of its final one, in ``streams``."""
    def cb_for(name):
        def cb(tokens, final, meta):
            ent = streams.setdefault(name, {"tokens": [], "first": None,
                                        "final": None, "final_t": None})
            ent["tokens"].extend(tokens)
            if ent["first"] is None:
                ent["first"] = dict(meta)
            if final:
                ent["final"] = dict(meta)
                ent["final_t"] = time.perf_counter()
        return cb
    return cb_for


def _serve(torch, model, prompts, temps, n_new, stats_sink, **opts):
    """One fresh batcher on ``model`` serving ``prompts`` at once; returns
    the streams and the wall time, and appends the batcher's stats to
    ``stats_sink``."""
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    b = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                          max_seq_len=MAX_SEQ, device=DEV["cuda"],
                          autostart=False, **opts)
    try:
        hs = [b.submit(p, max_new_tokens=n_new, temperature=t, seed=100 + i)
              for i, (p, t) in enumerate(zip(prompts, temps))]
        t0 = time.perf_counter()
        b.start()
        outs = [h.result(timeout_s=600) for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats_sink.append(b.stats())
    finally:
        b.close()
    return outs, wall


def phase15_priorities(torch, model, smi, stats_sink):
    """15a: 8 bulk streams (phase 5's first 8 prompts, 32 greedy tokens)
    fill the 8 slots; at bulk 0's fourth token (from its callback, on the
    loop thread) 2 critical and 4 normal requests arrive: one with a
    deadline already past, one with a generous one, one cancelled by uri
    while still queued; at its sixth, bulk 1 is cancelled by uri. Gates:
    the bulk streams equal an uninterrupted run (bulk 1's tokens a prefix
    of it), the criticals preempt bulk 7 and 6 and both end before either
    of them, nothing stays
    parked, the pool sums back, shed / cancelled outcomes, one
    ``admission.generation`` shed record, K1 = 12 x prefills and K2 = 12 x
    decode steps."""
    from analytics_zoo_tpu_torch.observability import recorder as rec_mod
    from analytics_zoo_tpu_torch.ops.flash_attention import \
        flash_attention_fwd
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention
    from analytics_zoo_tpu_torch.serving import qos
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    prompts, _, n_new = serving_burst()
    bulk = prompts[:N_SLOTS]
    want, _ = _serve(torch, model, bulk, [0.0] * N_SLOTS, n_new, stats_sink)
    rng = np.random.default_rng(15)
    arrivals = [  # name, prompt length, priority, deadline, new tokens
        ("critical-0", 64, "critical", None, 16),
        ("critical-1", 96, "critical", None, 16),
        ("normal", 48, "normal", None, 16),
        ("shed", 32, "normal", "past", 16),
        ("generous", 40, "normal", "generous", 16),
        ("queued-cancel", 24, "normal", None, 16)]
    arr_prompts = {name: rng.integers(1, VOCAB, size=n).astype(np.int32)
                   for name, n, _, _, _ in arrivals}
    rec = rec_mod.install(capacity=1 << 16)
    b = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                          max_seq_len=MAX_SEQ, device=DEV["cuda"],
                          autostart=False)
    streams = {}
    cb = _finals_by_name(streams)

    def bulk0_cb(tokens, final, meta):
        cb("bulk-0")(tokens, final, meta)
        n_out = len(streams["bulk-0"]["tokens"])
        if n_out == 4 and not final:
            for name, _, prio, dl, n in arrivals:
                deadline = {None: None, "past": time.time() - 1.0,
                            "generous": time.time() + 600.0}[dl]
                b.submit(arr_prompts[name], max_new_tokens=n, uri=name,
                         priority=prio, deadline=deadline,
                         on_chunk=cb(name))
            b.cancel_uri("queued-cancel")
        if n_out == 6 and not final:
            # after both criticals took their slots: an active cancel
            b.cancel_uri("bulk-1")

    try:
        flash_attention_fwd.launches = 0
        paged_attention.launches = 0
        t0 = time.perf_counter()
        for i, p in enumerate(bulk):
            b.submit(p, max_new_tokens=n_new, seed=100 + i, uri=f"bulk-{i}",
                     priority="bulk",
                     on_chunk=bulk0_cb if i == 0 else cb(f"bulk-{i}"))
        b.start()
        names = [f"bulk-{i}" for i in range(N_SLOTS)] + \
            [a[0] for a in arrivals]
        deadline = time.monotonic() + 600
        while not all(streams.get(n, {}).get("final") for n in names):
            if time.monotonic() > deadline:
                raise AssertionError("15a streams did not finish")
            time.sleep(0.01)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention_fwd.launches, paged_attention.launches
        st = b.stats()
        conserved = b.pool.free_count() == b.pool.capacity
    finally:
        b.close()
        rec_mod.uninstall()
    stats_sink.append(st)
    outcome = {n: streams[n]["final"]["outcome"] for n in names}
    expect = {n: "ok" for n in names}
    expect.update({"bulk-1": "cancelled", "queued-cancel": "cancelled",
                   "shed": "shed"})
    same = [streams[f"bulk-{i}"]["tokens"] == want[i]
            for i in range(N_SLOTS) if i != 1]
    prefix1 = want[1][:len(streams["bulk-1"]["tokens"])] == \
        streams["bulk-1"]["tokens"]
    # the least urgent bulk slots (latest submitted) are the victims
    preempted = [f"bulk-{N_SLOTS - 1}", f"bulk-{N_SLOTS - 2}"]
    crit_end = max(streams[n]["final_t"] for n in ("critical-0", "critical-1"))
    order_ok = all(crit_end < streams[n]["final_t"] for n in preempted)
    retry = streams["shed"]["final"].get("retry_after_s", 0.0)
    shed_recs = [r for r in rec.records("admission.generation")
                 if r["decision"]["action"] == "shed"]
    n_prefill = st["dispatches"]["prefill"]
    n_decode = st["dispatches"]["decode"]
    ttft = {}
    for n in names:
        if streams[n]["first"] and "ttft_s" in streams[n]["first"]:
            prio = "bulk" if n.startswith("bulk") else \
                dict((a[0], a[2]) for a in arrivals)[n]
            ttft.setdefault(prio, []).append(streams[n]["first"]["ttft_s"])
    res = {"wall_s": wall, "outcomes": outcome,
           "bulk_identical": sum(same), "bulk1_prefix": prefix1,
           "criticals_first": order_ok, "preempted": preempted,
           "preemptions": st["preemptions"],
           "preempted_parked": st["preempted_parked"],
           "pool_conserved": conserved, "retry_after_s": retry,
           "shed_records": len(shed_recs),
           "ttft_p50_ms_by_priority": {k: pct(v, 50) * 1e3
                                       for k, v in ttft.items()},
           "ttft_n_by_priority": {k: len(v) for k, v in ttft.items()},
           "launches": {"K1": k1, "K2": k2},
           "prefills": n_prefill, "decode_steps": n_decode, "card": smi}
    log_line = json.dumps(res)
    log(f"[serve-qos] 15a {log_line}")
    ok = (outcome == expect and all(same) and prefix1 and order_ok
          and st["preemptions"] == 2 and st["preempted_parked"] == 0
          and conserved and retry >= qos.MIN_RETRY_AFTER_S
          and len(shed_recs) == 1 and k1 == N_BLOCK * n_prefill
          and k2 == N_BLOCK * n_decode and k1 > 0 and k2 > 0)
    if not ok:
        raise AssertionError("15a: priorities, preemption, shedding or "
                             "cancel failed a gate")
    return k1, k2


def phase15_batch_policy(torch, model, smi, stats_sink):
    """15b: phase 5's burst under ``admit_policy="batch"`` and
    ``"continuous"`` in turns (batch, continuous, continuous, batch): the
    streams must be identical; tokens/s of each and their ratio are
    printed (the reference's bench asks for >= 1.5x; not gated)."""
    prompts, temps, n_new = serving_burst()
    runs = {"batch": [], "continuous": []}
    outs0 = None
    for policy in ("batch", "continuous", "continuous", "batch"):
        outs, wall = _serve(torch, model, prompts, temps, n_new, stats_sink,
                            admit_policy=policy)
        if outs0 is None:
            outs0 = outs
        if outs != outs0:
            raise AssertionError(f"15b: {policy} streams differ")
        runs[policy].append(sum(len(o) for o in outs) / wall)
    ratio = statistics.median(runs["continuous"]) / \
        statistics.median(runs["batch"])
    log(f"[serve-qos] 15b " + json.dumps(
        {"tokens_per_s": runs, "continuous_over_batch": ratio,
         "streams_identical": True, "card": smi}))
    return outs0


def phase15_hot_swap(torch, model, smi, stats_sink):
    """15c: phase 5b's tenant traffic on a batcher with
    prefix_cache_pages=256; once the burst has emitted 64 tokens, another
    thread calls ``swap_params(params x 1.01 (f32, cast to bf16),
    version="v2", spec={"k": 4, "max_ngram": 3})``. Gates: every stream
    reaches its length, ``swaps == 1``, ``model_version == "v2"``, the
    prefix index emptied at the flip (``gen.prefix.invalidated``), the new
    k adds one decode shape, ``host_params()`` equals the new params bit
    for bit, and a request after the swap equals a fresh spec_k=4 batcher
    on the new weights. Prints the wall time from ``swap_params`` to its
    return (the staging), to the flip on the loop thread and to the first
    emitted frame under the new weights."""
    from analytics_zoo_tpu_torch.observability import events as ev
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    params2 = {n: (p.float() * 1.01).to(torch.bfloat16).cpu()
               for n, p in old.items()}
    warm, burst = feature_traffic(np.random.default_rng(5))
    ev.reset_events()
    b = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                          max_seq_len=MAX_SEQ, device=DEV["cuda"],
                          prefix_cache_pages=256, autostart=False)
    emitted = [0]
    trigger = threading.Event()
    first_new = []
    streams = {}
    cb = _finals_by_name(streams)

    def counting(i):
        inner = cb(f"s{i}")

        def on_chunk(tokens, final, meta):
            inner(tokens, final, meta)
            emitted[0] += len(tokens)
            if emitted[0] >= 64:
                trigger.set()
            if b.swaps and not first_new and tokens:
                first_new.append(time.perf_counter())
        return on_chunk

    try:
        hs = [b.submit(p, max_new_tokens=1, seed=i)
              for i, p in enumerate(warm)]
        b.start()
        for h in hs:
            h.result(timeout_s=600)
        entries_before = b.prefix_cache.stats()["entries"]
        for i, (p, n, temp, seed) in enumerate(burst):
            b.submit(p, max_new_tokens=n, temperature=temp, seed=seed,
                     on_chunk=counting(i))
        if not trigger.wait(600):
            raise AssertionError("15c: the burst never emitted 64 tokens")
        t_call, wall_call = time.perf_counter(), time.time()
        b.swap_params(params2, version="v2", spec={"k": 4, "max_ngram": 3})
        t_staged = time.perf_counter()
        deadline = time.monotonic() + 600
        while not all(streams.get(f"s{i}", {}).get("final")
                      for i in range(len(burst))):
            if time.monotonic() > deadline:
                raise AssertionError("15c streams did not finish")
            time.sleep(0.01)
        post = np.random.default_rng(16).integers(1, VOCAB, size=200).astype(
            np.int32)
        after = b.generate(post, max_new_tokens=32, timeout_s=600)
        st = b.stats()
        host = b.host_params()
    finally:
        b.close()
    stats_sink.append(st)
    lengths_ok = all(streams[f"s{i}"]["final"]["outcome"] == "ok"
                     and len(streams[f"s{i}"]["tokens"]) == burst[i][1]
                     for i in range(len(burst)))
    inval = ev.events(kind="gen.prefix.invalidated")
    host_same = all(host[n].equal(params2[n]) for n in params2)
    ks = sorted({s[3] for s in b.decode_shapes if len(s) > 3})
    fresh = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                              max_seq_len=MAX_SEQ, device=DEV["cuda"],
                              spec_k=4,
                              spec_ngram=3)
    try:
        fresh_out = fresh.generate(post, max_new_tokens=32, timeout_s=600)
        stats_sink.append(fresh.stats())
    finally:
        fresh.close()
    swap_ms = (first_new[0] - t_call) * 1e3 if first_new else None
    res = {"streams_reach_length": lengths_ok, "swaps": st["swaps"],
           "model_version": st["model_version"],
           "prefix_entries_before": entries_before,
           "invalidated_pages": inval[-1].fields["pages"] if inval else 0,
           "spec_ks": ks, "host_params_equal": host_same,
           "post_swap_equals_fresh": after == fresh_out,
           "swap_params_call_ms": (t_staged - t_call) * 1e3,
           # the flip's event stamps time.time() on the loop thread
           "swap_to_flip_ms": (inval[-1].ts - wall_call) * 1e3
           if inval else None,
           "swap_to_first_new_step_ms": swap_ms, "card": smi}
    log(f"[serve-qos] 15c {json.dumps(res)}")
    with torch.no_grad():       # phase 15's other paths serve the seed
        for n, p in model.named_parameters():
            p.data = old[n]
    if not (lengths_ok and st["swaps"] == 1 and st["model_version"] == "v2"
            and entries_before > 0 and inval
            and inval[-1].fields["pages"] > 0 and ks == [4] and host_same
            and after == fresh_out and swap_ms is not None):
        raise AssertionError("15c: the hot swap failed a gate")


def phase15_chaos(torch, model, smi, stats_sink, want):
    """15e, first half: a ChaosSchedule kills the decode loop at its 20th
    pass through ``serving.generate`` during phase 5's burst; the
    supervisor respawns it once, and every stream equals 15b's (the same
    burst without the kill)."""
    from analytics_zoo_tpu_torch.common.chaos import ChaosSchedule

    prompts, temps, n_new = serving_burst()
    sched = ChaosSchedule(seed=7).kill("serving.generate", at=20)
    with sched:
        outs, wall = _serve(torch, model, prompts, temps, n_new, stats_sink)
    st = stats_sink[-1]
    res = {"loop_respawns": st["loop_respawns"],
           "streams_identical": outs == want,
           "fired": sched.occurrences("serving.generate"), "wall_s": wall,
           "card": smi}
    log(f"[serve-qos] 15e chaos {json.dumps(res)}")
    if st["loop_respawns"] != 1 or outs != want:
        raise AssertionError("15e: the chaos kill changed a stream or did "
                             "not respawn the loop exactly once")


def _count_plain(mod, names):
    """Wrap ``mod``'s functions ``names`` to count their calls; returns
    (counts, restore)."""
    counts = {n: 0 for n in names}
    orig = {n: getattr(mod, n) for n in names}

    def wrap(n):
        def f(*a, **k):
            counts[n] += 1
            return orig[n](*a, **k)
        return f
    for n in names:
        setattr(mod, n, wrap(n))
    return counts, lambda: [setattr(mod, n, f) for n, f in orig.items()]


SWAP_WINDOW_S = 4.0


def _held_bytes(module):
    """Bytes of the storages a module's params and buffers hold (a
    weight-only leaf holds its int8 codes and f32 scales)."""
    seen = {}
    for t in list(module.parameters()) + list(module.buffers()):
        for u in ((t.q, t.scale) if hasattr(t, "q") else (t,)):
            st = u.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _weight_only_reference(w):
    """JAX's weight-only packing written out in numpy (per-output-channel
    symmetric int8, amax floor 1e-8), returned dequantized."""
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = (np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)).astype(
        np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q.astype(np.float32) * scale


def phase15_int8_swap(torch, state, smi):
    """15d: the int8 ResNet-50 of phase 8 swapped under load. 4 threads
    predict fixed batches of 32 in a loop; meanwhile ``swap_params`` flips
    to the float params x 1.01 and re-packs them. Every output equals,
    bit for bit, the old or the new model's output for its batch (both
    computed on the card beforehand), ``last_served_version`` moves, K5/K6
    launch again after the swap and no plain version runs. Images/s over
    ``SWAP_WINDOW_S`` before and after the swap and over the swap call
    itself, each predict counted by the share of its time inside the
    window. Then the weight-only path: phase 14b's SessionRecommender at
    min_elements 100000 (its largest Dense kernel has 74120 elements, so
    none packs to K5; its two 3707 x 64 item tables pack weight-only)
    predicts within 2e-2 of float and within 1e-6 of its output's scale of
    a float model that holds the tables' numpy-quantized ``q * scale``,
    and holds those tables as int8 codes and f32 scales only."""
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.recommendation import \
        SessionRecommender
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    set_policy(compute_dtype="float32")
    rng = np.random.default_rng(17)
    batches = [rng.normal(size=(IMG_BATCH, IMG, IMG, 3)).astype(np.float32)
               for _ in range(IMG_THREADS)]
    model = resnet_on(torch, state, DEV["cuda"])
    pnames = {n for n, _ in model.named_parameters()}
    state2 = {k: (v * 1.01 if k in pnames else v) for k, v in state.items()}
    params2 = {k: state2[k] for k in pnames}
    ref_new = InferenceModel(max_batch_size=IMG_BATCH,
                             device=DEV["cuda"]).load(
        resnet_on(torch, state2, DEV["cuda"])).quantize_int8()
    new = [ref_new.predict(x) for x in batches]
    del ref_new
    im = InferenceModel(supported_concurrent_num=IMG_THREADS,
                        max_batch_size=IMG_BATCH,
                        device=DEV["cuda"]).load(model)
    im.quantize_int8()
    old = [im.predict(x) for x in batches]
    plain, restore = _count_plain(f8, ["int8_matmul_fused_plain",
                                       "int8_conv2d_fused_plain",
                                       "quantize_rows_plain"])
    f8.int8_matmul_fused.launches = 0
    f8.int8_conv2d_fused.launches = 0
    done, stop, errors = [], threading.Event(), []

    def worker(i):
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                y = im.predict(batches[i])
                done.append((t0, time.perf_counter(), i, y,
                             im.last_served_version()))
        except Exception as e:           # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(IMG_THREADS)]
    try:
        for th in threads:
            th.start()
        # "before" starts once every thread has finished its first predict
        # (a thread's first call on the card sets up its library handles)
        t_lim = time.perf_counter() + 120
        while len({j for _, _, j, *_ in list(done)}) < IMG_THREADS \
                and not errors and time.perf_counter() < t_lim:
            time.sleep(0.01)
        t_warm = time.perf_counter()
        time.sleep(SWAP_WINDOW_S)
        t_call = time.perf_counter()
        im.swap_params(params2, version="v2")
        t_done = time.perf_counter()
        at_swap = (f8.int8_matmul_fused.launches,
                   f8.int8_conv2d_fused.launches)
        time.sleep(SWAP_WINDOW_S)
        t_end = time.perf_counter()
        stop.set()
        for th in threads:
            th.join(timeout=600)
    finally:
        stop.set()
        restore()
    k5, k6 = f8.int8_matmul_fused.launches, f8.int8_conv2d_fused.launches
    kinds = {"old": 0, "new": 0, "neither": 0}
    for _, _, i, y, v in done:
        if np.array_equal(y, old[i]) and v is None:
            kinds["old"] += 1
        elif np.array_equal(y, new[i]) and v == "v2":
            kinds["new"] += 1
        else:
            kinds["neither"] += 1

    def window(lo, hi):
        """Images/s over [lo, hi), each predict's batch counted by the
        share of its time inside; the predicts overlapping the window."""
        images, n = 0.0, 0
        for t0, t1, *_ in done:
            inside = min(t1, hi) - max(t0, lo)
            if inside > 0:
                images += IMG_BATCH * inside / (t1 - t0)
                n += 1
        return {"images_per_s": images / (hi - lo), "predicts": n,
                "s": hi - lo}

    res = {"outputs": kinds, "errors": errors,
           "stage_ms": im.swap_timings["stage_ms"],
           "gate_hold_ms": im.swap_timings["gate_ms"],
           "windows": {"before": window(t_warm, t_call),
                       "during": window(t_call, t_done),
                       "after": window(t_done, t_end)},
           "launches": {"K5": k5, "K6": k6, "K5_after_swap": k5 - at_swap[0],
                        "K6_after_swap": k6 - at_swap[1]},
           "plain_calls": plain, "card": smi}
    ok = (not errors and kinds["neither"] == 0 and kinds["new"] > 0
          and kinds["old"] > 0 and k5 > at_swap[0] and k6 > at_swap[1]
          and not any(plain.values()))
    # weight-only packing
    sx = np.random.default_rng(18).integers(1, ML1M_ITEMS + 1, size=(
        256, 10)).astype(np.float32)
    sh = np.random.default_rng(19).integers(0, ML1M_ITEMS + 1, size=(
        256, 10)).astype(np.float32)

    def session(seed_model):
        return SessionRecommender(
            ML1M_ITEMS, 64, rnn_hidden_layers=(40, 20), session_length=10,
            include_history=True, mlp_hidden_layers=(40, 20),
            history_length=10, device=DEV["cuda"], seed=seed_model)

    fim = InferenceModel(max_batch_size=256,
                         device=DEV["cuda"]).load(session(0))
    qim = InferenceModel(max_batch_size=256, device=DEV["cuda"]).load(
        session(0)).quantize_int8(min_elements=100_000)
    y_float, y_packed = fim.predict([sx, sh]), qim.predict([sx, sh])
    d = float(np.abs(y_float - y_packed).max())
    packed = {n: str(p["q"].dtype) for n, p in qim._wo_packed.items()}
    # the plain reference: a float model holding numpy's q * scale where
    # the rule packs (float leaves of >= 2 dims and >= 100000 elements)
    plain_mod = session(0)
    expect = []
    with torch.no_grad():
        for n, p in plain_mod.named_parameters():
            if p.dim() >= 2 and p.numel() >= 100_000:
                expect.append(n)
                w = p.detach().cpu().numpy()
                p.copy_(torch.from_numpy(_weight_only_reference(w)))
    y_plain = InferenceModel(max_batch_size=256, device=DEV["cuda"]).load(
        plain_mod).predict([sx, sh])
    d_plain = float(np.abs(y_plain - y_packed).max())
    scale_out = float(np.abs(y_plain).max())
    float_bytes, packed_bytes = _held_bytes(fim._module), \
        _held_bytes(qim._module)
    want_bytes = float_bytes - sum(
        3 * p["q"].numel() - 4 * p["scale"].numel()
        for p in qim._wo_packed.values())
    res["weight_only"] = {"packed": packed, "native_slots": qim.packed_slots,
                          "max_abs_diff_vs_float": d,
                          "max_abs_diff_vs_plain": d_plain,
                          "plain_max_abs_output": scale_out,
                          "bit_equal_to_plain": bool(
                              np.array_equal(y_plain, y_packed)),
                          "held_bytes": {"float": float_bytes,
                                         "packed": packed_bytes}}
    log(f"[serve-qos] 15d {json.dumps(res)}")
    ok = ok and qim.packed_slots == [] and sorted(packed) == sorted(
        expect) and len(packed) == 2 and all(
        v == "torch.int8" for v in packed.values()) and d <= 2e-2 \
        and d_plain <= 1e-6 * scale_out and packed_bytes == want_bytes
    if not ok:
        raise AssertionError("15d: the int8 swap under load or the "
                             "weight-only packing failed a gate")
    return k5 - at_swap[0], k6 - at_swap[1]


def phase15_row_delta(torch, smi):
    """15e, second half: the explicit NeuralCF at ML-1M's width (seed 0,
    f32) served by InferenceModel; a base checkpoint saved with the port,
    100 user rows of its embedding table perturbed and published with
    ``save_row_delta``, read back with ``read_row_delta`` and applied with
    ``apply_row_delta``. Gates: untouched users' predictions bit-identical,
    touched users' equal a full ``swap_params`` to the perturbed params bit
    for bit, the delta's state.npz smaller than the base's, and a quantized
    model refusing the patch."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.bridge import nest
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS, ML1M_USERS
    from analytics_zoo_tpu_torch.engine import checkpoint as ck
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF

    def ncf():
        return NeuralCF(ML1M_USERS, ML1M_ITEMS, class_num=5,
                        device=DEV["cuda"])

    rng = np.random.default_rng(20)
    x = np.stack([rng.integers(1, ML1M_USERS + 1, size=50_000),
                  rng.integers(1, ML1M_ITEMS + 1, size=50_000)], 1).astype(
        np.int32)
    touched = rng.choice(np.arange(1, ML1M_USERS + 1), size=100,
                         replace=False)
    im = InferenceModel(max_batch_size=8192, device=DEV["cuda"]).load(ncf())
    before = im.predict(x)
    base_params = im.host_params()
    table = "0_fusedpairembedding.embeddings"
    p2 = dict(base_params)
    emb = p2[table].clone()
    emb[torch.as_tensor(touched)] = emb[torch.as_tensor(touched)] * 1.5 \
        + 0.01
    p2[table] = emb
    tmp = tempfile.mkdtemp(prefix="zoo_rowdelta_")
    try:
        base = ck.save_checkpoint(tmp, nest(base_params), iteration=1,
                                  epoch=0)
        delta = ck.save_row_delta(tmp, nest(p2), base, iteration=2)
        base_bytes = os.path.getsize(os.path.join(base, "state.npz"))
        delta_bytes = os.path.getsize(os.path.join(delta, "state.npz"))
        entries, _ = ck.read_row_delta(
            delta, im.load_avals,
            live_version=ck.read_manifest(base)["version"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    im.apply_row_delta(entries, version="delta-2")
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    got = im.predict(x)
    full = InferenceModel(max_batch_size=8192, device=DEV["cuda"]).load(ncf())
    full.swap_params(p2, version="full-2")
    want = full.predict(x)
    hit = np.isin(x[:, 0], touched)
    untouched_same = np.array_equal(got[~hit], before[~hit])
    touched_full = np.array_equal(got, want)
    moved = not np.array_equal(got[hit], before[hit])
    q = InferenceModel(max_batch_size=8192, device=DEV["cuda"]).load(
        ncf()).quantize_int8()
    try:
        q.apply_row_delta(entries)
        refused = False
    except RuntimeError:
        refused = True
    res = {"delta_bytes": delta_bytes, "base_bytes": base_bytes,
           "rows": int(sum(len(i) for _, i, _ in entries if i is not None)),
           "apply_ms": apply_ms, "untouched_bit_identical": untouched_same,
           "equals_full_swap": touched_full, "touched_moved": moved,
           "quantized_refuses": refused, "pairs": len(x),
           "touched_pairs": int(hit.sum()), "card": smi}
    log(f"[serve-qos] 15e row delta {json.dumps(res)}")
    if not (untouched_same and touched_full and moved and refused
            and delta_bytes < base_bytes and res["rows"] == 100):
        raise AssertionError("15e: the row delta failed a gate")


def phase15_telemetry(torch, stats_sink):
    """15f: the port's registry renders Prometheus text that
    ``parse_prometheus`` accepts; ``zoo_gen_requests_total{outcome}``,
    ``zoo_gen_preemptions_total``, ``zoo_gen_shed_total`` and
    ``zoo_gen_swaps_total`` equal the sums of phase 15's batchers'
    ``stats()`` (the registry was reset at the phase's start)."""
    from analytics_zoo_tpu_torch.common import telemetry as tm

    fam = tm.parse_prometheus(tm.render_prometheus())

    def total(name, **labels):
        return sum(v for _, lab, v in fam.get(name, {}).get("samples", [])
                   if all(lab.get(k) == w for k, w in labels.items()))

    want_reqs = {}
    for st in stats_sink:
        for k, v in st["requests"].items():
            want_reqs[k] = want_reqs.get(k, 0) + v
    got_reqs = {lab["outcome"]: v for _, lab, v in
                fam["zoo_gen_requests_total"]["samples"] if v}
    res = {"families": len(fam),
           "requests": got_reqs, "stats_requests": want_reqs,
           "preemptions": total("zoo_gen_preemptions_total"),
           "stats_preemptions": sum(s["preemptions"] for s in stats_sink),
           "shed": total("zoo_gen_shed_total", reason="deadline"),
           "stats_shed": sum(s["requests"].get("shed", 0)
                             for s in stats_sink),
           "swaps": total("zoo_gen_swaps_total"),
           "stats_swaps": sum(s["swaps"] for s in stats_sink)}
    log(f"[serve-qos] 15f {json.dumps(res)}")
    if not (got_reqs == {k: float(v) for k, v in want_reqs.items()}
            and res["preemptions"] == res["stats_preemptions"]
            and res["shed"] == res["stats_shed"]
            and res["swaps"] == res["stats_swaps"]):
        raise AssertionError("15f: telemetry disagrees with the batchers' "
                             "stats")


def phase_serving_remainder(torch, state, smi):
    """Phase 15: priorities, preemption, shedding and cancel (15a),
    run-to-completion against continuous (15b), the hot swap mid-burst
    (15c), the int8 swap under load and weight-only packing (15d), the
    chaos kill and the row delta (15e), telemetry (15f). Returns the
    launch counts of K1, K2 (15a), K5 and K6 (15d, after the swap)."""
    from analytics_zoo_tpu_torch.common import telemetry as tm
    from analytics_zoo_tpu_torch.nn.module import set_policy

    t0 = time.perf_counter()
    tm.reset_telemetry()
    wall = {}
    set_policy(compute_dtype="bfloat16")
    model = full_model(torch, DEV["cuda"]).to(torch.bfloat16)
    model.eval()
    stats_sink = []
    t = time.perf_counter()
    k1, k2 = phase15_priorities(torch, model, smi, stats_sink)
    wall["15a"] = time.perf_counter() - t
    t = time.perf_counter()
    cont = phase15_batch_policy(torch, model, smi, stats_sink)
    wall["15b"] = time.perf_counter() - t
    t = time.perf_counter()
    phase15_hot_swap(torch, model, smi, stats_sink)
    wall["15c"] = time.perf_counter() - t
    t = time.perf_counter()
    phase15_chaos(torch, model, smi, stats_sink, cont)
    wall["15e_chaos"] = time.perf_counter() - t
    del model
    torch.cuda.empty_cache()
    t = time.perf_counter()
    k5, k6 = phase15_int8_swap(torch, state, smi)
    wall["15d"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    phase15_row_delta(torch, smi)
    wall["15e_delta"] = time.perf_counter() - t
    phase15_telemetry(torch, stats_sink)
    wall["phase"] = time.perf_counter() - t0
    log(f"[serve-qos] phase wall s: {json.dumps(wall)}")
    set_policy(compute_dtype="float32")
    return {"K1": k1, "K2": k2, "K5": k5, "K6": k6}


# ------------------------------------------------------------ phase 16

# the data plane: 256 seeded 224x224x3 f32 images (602 KB each, over the
# shm ring) from 4 client threads, 16 in flight a thread; 64 HTTP requests a
# mode; swap windows of 2 s
DP_IMAGES, DP_CLIENTS, DP_WINDOW, DP_HTTP = 256, 4, 16, 64
DP_SWAP_WINDOW_S = 2.0


def _rate_windows(done, bounds):
    """Images/s over each named ``(lo, hi)`` of ``bounds``, every request
    (one image) counted by the share of its time inside; and the requests
    each window overlaps."""
    out = {}
    for name, (lo, hi) in bounds.items():
        images, n = 0.0, 0
        for t0, t1, *_ in done:
            inside = min(t1, hi) - max(t0, lo)
            if inside > 0:
                images += inside / (t1 - t0)
                n += 1
        out[name] = {"images_per_s": images / (hi - lo), "requests": n,
                     "s": hi - lo}
    return out


def _client(port, images, idx, prefix, window, answer, errors, stop=None):
    """One client thread of 16a's burst: enqueues ``images[idx]`` under
    uris ``<prefix>-<i>`` (the broker's own uris when ``prefix`` is None)
    ``window`` at a time and queries them back, calling ``answer(i, y,
    version, latency s)`` for each; with ``stop``, it cycles over ``idx``
    until ``stop`` is set."""
    from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue

    iq, oq = InputQueue(port=port), OutputQueue(port=port)
    try:
        while True:
            for w in range(0, len(idx), window):
                if stop is not None and stop.is_set():
                    return
                sent = []
                for i in idx[w:w + window]:
                    t0 = time.perf_counter()
                    uri = None if prefix is None else f"{prefix}-{i}"
                    sent.append((i, iq.enqueue(uri, input=images[i]), t0))
                for i, uri, t0 in sent:
                    y = oq.query(uri, timeout_s=300)
                    answer(i, y, oq.last_model_version,
                           time.perf_counter() - t0)
            if stop is None:
                return
    except Exception as e:                   # reported by the caller
        errors.append(repr(e))
    finally:
        iq.close()
        oq.close()


def _burst(port, images, prefix, on_answer=None, window=DP_WINDOW):
    """16a's clients: 4 threads, each enqueueing its share of
    ``images`` under uris ``<prefix>-<i>`` ``window`` at a time and
    querying them back. Returns ``({i: (answer, version)}, latencies s,
    wall s, errors)``; ``on_answer(n)`` runs after the n-th answer."""
    n = len(images)
    results, lat, errors = {}, [], []
    lock = threading.Lock()

    def answer(i, y, version, latency):
        with lock:
            lat.append(latency)
            results[i] = (y, version)
            k = len(results)
        if on_answer is not None:
            on_answer(k)

    threads = [threading.Thread(target=_client, args=(
        port, images, list(range(t, n, DP_CLIENTS)), prefix, window, answer,
        errors)) for t in range(DP_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return results, lat, time.perf_counter() - t0, errors


def _answered_again(port, prefix, n) -> int:
    """How many of ``<prefix>-<i>`` still have a result to read: each was
    consumed by its query, so an answer written twice shows here."""
    from analytics_zoo_tpu_torch.serving import OutputQueue

    oq, again = OutputQueue(port=port), 0
    try:
        for i in range(n):
            try:
                oq.query(f"{prefix}-{i}", timeout_s=0)
                again += 1
            except TimeoutError:
                pass
    finally:
        oq.close()
    return again


def phase16_queue(torch, job, im, port, images, smi):
    """16a: the int8 ResNet-50 behind ClusterServing, 256 images from 4
    client threads through the broker. Every uri answered once, no error
    record, each answer bit for bit the direct ``predict`` of its image
    (made beforehand in batches of 32, another batch composition than the
    engine's: K5 and K6 quantize per row), the images over the shm ring,
    K6 = 53 and K5 = 1 per batch the engine dispatched. Returns the direct
    answers and the K5/K6 launches."""
    from analytics_zoo_tpu_torch.ops import int8_fused as f8
    from analytics_zoo_tpu_torch.serving.wire import wire_stats

    direct = np.concatenate([im.predict(images[i:i + IMG_BATCH])
                             for i in range(0, DP_IMAGES, IMG_BATCH)])
    calls, busy, predict = [0], [0.0], im.predict

    def counted(x):
        calls[0] += 1
        t = time.perf_counter()
        y = predict(x)
        busy[0] += time.perf_counter() - t
        return y

    im.predict = counted            # the engine's infer loop calls this
    shm0 = wire_stats()["shm_bytes"]
    served0 = job.served
    f8.int8_matmul_fused.launches = 0
    f8.int8_conv2d_fused.launches = 0
    try:
        results, lat, wall, errors = _burst(port, images[:DP_IMAGES], "img")
    finally:
        del im.predict
    k5, k6 = f8.int8_matmul_fused.launches, f8.int8_conv2d_fused.launches
    shm = wire_stats()["shm_bytes"] - shm0
    # answered once: each result hash was consumed by its query
    again = _answered_again(port, "img", DP_IMAGES)
    t_lim = time.perf_counter() + 30
    while job.served - served0 < DP_IMAGES and time.perf_counter() < t_lim:
        time.sleep(0.01)          # the sink counts just after its write
    served, errs = job.served - served0, job.stats()["errors"]
    exact = sum(np.array_equal(results[i][0], direct[i]) for i in results)
    maxd = max((float(np.abs(results[i][0] - direct[i]).max())
                for i in results), default=float("nan"))
    versions = sorted({v for _, v in results.values()})
    res = {"images": DP_IMAGES, "clients": DP_CLIENTS, "in_flight": DP_WINDOW,
           "wall_s": wall, "images_per_s": DP_IMAGES / wall,
           "latency_p50_ms": pct(lat, 50) * 1e3,
           "latency_p99_ms": pct(lat, 99) * 1e3, "shm_bytes": shm,
           "engine_batches": calls[0],
           "mean_batch": DP_IMAGES / max(1, calls[0]),
           "engine_predict_s": busy[0],
           "engine_predict_ms_mean": busy[0] / max(1, calls[0]) * 1e3,
           "engine_predict_share": busy[0] / wall,
           "launches": {"K5": k5, "K6": k6}, "served": served,
           "error_records": errs, "answered_again": again,
           "bit_equal_direct": f"{exact}/{len(results)}",
           "max_abs_diff_direct": maxd, "versions": versions, "card": smi}
    log(f"[data-plane] 16a queue serving {json.dumps(res)}")
    ok = (not errors and len(results) == DP_IMAGES and served == DP_IMAGES
          and errs == 0 and again == 0 and exact == DP_IMAGES and shm > 0
          and versions == ["initial"] and calls[0] > 0
          and k6 == 53 * calls[0] and k5 == calls[0])
    if not ok:
        raise AssertionError(f"16a: a data-plane gate failed (errors "
                             f"{errors[:3]})")
    return direct, k5, k6, res


def _post_json(port, path, body: bytes, timeout=300):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase16_http(torch, job, im, port, images, direct, smi):
    """16b: the same model through ``FrontEndApp``: 64 ``/predict``
    requests of one image in queue mode (through the broker and 16a's
    engine) and 64 in direct mode (``MicroBatcher`` over the model), from 4
    threads each; every answer equals 16a's for the same image (JSON
    carries each f32 exactly); ``/metrics`` parses with the zoo_broker_*,
    zoo_http_* and zoo_infer_* families."""
    import urllib.request

    from analytics_zoo_tpu_torch.common.telemetry import parse_prometheus
    from analytics_zoo_tpu_torch.serving import FrontEndApp, ServingConfig

    cfg = ServingConfig(queue_port=port, batch_size=IMG_BATCH)
    t = time.perf_counter()
    bodies = [json.dumps({"instances": [{"input": images[i].tolist()}]})
              .encode() for i in range(DP_HTTP)]
    encode_s = time.perf_counter() - t
    apps = {"queue": FrontEndApp(cfg, port=0, engine_stats=job.stats),
            "direct": FrontEndApp(cfg, port=0, model=im, max_batch=IMG_BATCH,
                                  max_delay_ms=5.0)}
    res = {"request_json_mb": len(bodies[0]) / 1e6, "encode_s": encode_s}
    try:
        for mode, app in apps.items():
            app.start()
            got, lat, errors = {}, [], []

            def client(k, app=app, got=got, lat=lat, errors=errors):
                try:
                    for i in range(k, DP_HTTP, DP_CLIENTS):
                        t0 = time.perf_counter()
                        out = _post_json(app.port, "/predict", bodies[i])
                        lat.append(time.perf_counter() - t0)
                        got[i] = np.asarray(out["predictions"][0],
                                            np.float32)
                except Exception as e:           # reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(DP_CLIENTS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
            equal = sum(np.array_equal(got[i], direct[i]) for i in got)
            res[mode] = {"requests": len(got), "wall_s": wall,
                         "requests_per_s": len(got) / wall,
                         "latency_p50_ms": pct(lat, 50) * 1e3,
                         "equal_to_16a": f"{equal}/{DP_HTTP}",
                         "errors": errors[:3]}
            if errors or equal != DP_HTTP:
                raise AssertionError(f"16b {mode}: {errors[:3]}, "
                                     f"{equal}/{DP_HTTP} equal to 16a")
        res["direct"]["batching"] = apps["direct"]._batcher.stats()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{apps['queue'].port}/metrics",
                timeout=60) as r:
            fams = parse_prometheus(r.read().decode())
    finally:
        for app in apps.values():
            app.stop()
    prefixes = ("zoo_broker_", "zoo_http_", "zoo_infer_")
    found = {p: sorted(f for f in fams if f.startswith(p)) for p in prefixes}
    res["metrics_families"] = {p: len(v) for p, v in found.items()}
    res["card"] = smi
    log(f"[data-plane] 16b http {json.dumps(res)}")
    if not all(found.values()):
        raise AssertionError(f"16b: /metrics lacks a family: {found}")


def phase16_swap(torch, job, im, port, state, images, direct, smi):
    """16c: phase 15d's swap through the data plane. ``ModelPublisher``
    announces a checkpoint of the float weights x 1.01 written by
    ``engine/checkpoint.py``; the engine's ``ModelSwapper`` re-packs and
    stages it (one side-stream copy), probes the packed tensors and
    flips them in while 4 threads keep enqueueing one image each and
    querying it back. Every
    answer carries one version and equals that version's direct predict
    bit for bit; no answer begun after the flip is old. Then a checkpoint
    with a NaN is published and rejected, a record lands on
    ``model_rejections`` and the new version keeps answering."""
    import queue as queue_mod
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.bridge import nest
    from analytics_zoo_tpu_torch.engine import checkpoint as ck
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.client import _Conn
    from analytics_zoo_tpu_torch.serving.hotswap import (MODEL_REJECT_STREAM,
                                                         ModelPublisher)

    names = list(im.load_names)
    params2 = {n: state[n] * 1.01 for n in names}
    state2 = {k: params2.get(k, v) for k, v in state.items()}
    ref = InferenceModel(max_batch_size=IMG_BATCH, device=DEV["cuda"]).load(
        resnet_on(torch, state2, DEV["cuda"])).quantize_int8()
    new = ref.predict(images[:DP_CLIENTS])
    del ref
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="zoo-dataplane-")
    swapped = queue_mod.Queue()
    report = job._report_rejection

    def reported(conn, record):
        report(conn, record)
        swapped.put((time.perf_counter(), job._swap_state, job._swap_error,
                     job.model_version, dict(job.swapper.timings),
                     dict(getattr(im, "swap_timings", {}))))

    job._report_rejection = reported
    done, errors, stop = [], [], threading.Event()

    def client(t):
        iq, oq = InputQueue(port=port), OutputQueue(port=port)
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                y = oq.query(iq.enqueue(None, input=images[t]),
                             timeout_s=300)
                done.append((t0, time.perf_counter(), t, y,
                             oq.last_model_version))
        except Exception as e:               # reported below
            errors.append(repr(e))
        finally:
            iq.close()
            oq.close()

    pub = ModelPublisher(port=port)
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(DP_CLIENTS)]
    try:
        good = ck.save_checkpoint(tmp, nest(params2), iteration=1, epoch=0)
        bad_params = dict(params2)
        bad_params[names[0]] = bad_params[names[0]].clone()
        bad_params[names[0]].view(-1)[0] = float("nan")
        bad = ck.save_checkpoint(tmp, nest(bad_params), iteration=2,
                                 epoch=0, keep=5)
        for th in threads:
            th.start()
        t_lim = time.perf_counter() + 120
        while len({j for _, _, j, *_ in list(done)}) < DP_CLIENTS \
                and not errors and time.perf_counter() < t_lim:
            time.sleep(0.01)
        t_warm = time.perf_counter()
        time.sleep(DP_SWAP_WINDOW_S)
        t_pub = time.perf_counter()
        rec = pub.publish(good)
        t_swapped, state_ok, err_ok, ver, sw_ms, im_ms = swapped.get(
            timeout=300)
        time.sleep(DP_SWAP_WINDOW_S)
        t_end = time.perf_counter()
        rec_bad = pub.publish(bad)
        t_rej, state_bad, err_bad, ver_bad, *_ = swapped.get(timeout=300)
        n_before_bad = len(done)
        time.sleep(0.5)
        stop.set()
        for th in threads:
            th.join(timeout=600)
        conn = _Conn("127.0.0.1", port, timeout=60.0)
        try:
            rejected = [p for _, p in conn.call("XREAD", MODEL_REJECT_STREAM,
                                                0, 64, 0)[1]]
        finally:
            conn.close()
    finally:
        stop.set()
        job._report_rejection = report
        pub.close()
        shutil.rmtree(tmp, ignore_errors=True)
    v2 = rec["version"]
    kinds = {"old": 0, "new": 0, "neither": 0, "old_after_flip": 0}
    for t0, t1, i, y, v in done:
        if v == "initial" and np.array_equal(y, direct[i]):
            kinds["old"] += 1
            kinds["old_after_flip"] += t0 > t_swapped
        elif v == v2 and np.array_equal(y, new[i]):
            kinds["new"] += 1
        else:
            kinds["neither"] += 1
    after_bad = [v for t0, _, _, _, v in done[n_before_bad:]]
    # the swapper's stage_ms holds the re-pack and copy (swap_params_ms'
    # stage_ms) and its probe; its flip_ms holds the rollback snapshot
    # and the gate hold (gate_ms)
    res = {"version": v2, "swap": {"state": state_ok, "error": err_ok,
                                   "swapper_ms": sw_ms,
                                   "swap_params_ms": im_ms},
           "answers": kinds, "errors": errors[:3],
           "windows": _rate_windows(done, {
               "before": (t_warm, t_pub), "during": (t_pub, t_swapped),
               "after": (t_swapped, t_end)}),
           "nan_publish": {"version": rec_bad["version"], "state": state_bad,
                           "error": err_bad, "serving": ver_bad,
                           "answers_after": len(after_bad),
                           "rejection_records": len(rejected)},
           "card": smi}
    log(f"[data-plane] 16c hot swap {json.dumps(res)}")
    w = res["windows"]
    ok = (not errors and state_ok == "ok" and ver == v2
          and kinds["neither"] == 0 and kinds["old_after_flip"] == 0
          and kinds["old"] > 0 and kinds["new"] > 0
          and state_bad == "error" and str(err_bad).startswith("nan:")
          and ver_bad == v2 and all(v == v2 for v in after_bad)
          and any(r.get("version") == rec_bad["version"] for r in rejected)
          and w["before"]["requests"] >= 30 and w["after"]["requests"] >= 30)
    if not ok:
        raise AssertionError("16c: the hot swap through the data plane "
                             "failed a gate")


def phase16_generation(torch, port, direct5, smi):
    """16d: ``GenerationEngine`` over phase 5's bf16 LM (rebuilt from seed
    0; gen_slots 8, page 16, max_seq_len 1024) and phase 5's 16-request
    burst through ``GenerationClient`` (submitted in phase 5's order, each
    stream read by its own thread). Every stream ends ok with 32 tokens;
    each greedy stream equals phase 5's direct stream token for token, or
    differs where its argmax margin is <= 0.1; K1 = 12 x prefills and K2 =
    12 x decode steps, counted from 0 before the burst. Returns K1, K2."""
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops.flash_attention import \
        flash_attention_fwd
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention
    from analytics_zoo_tpu_torch.serving import ServingConfig
    from analytics_zoo_tpu_torch.serving.generation import (GenerationClient,
                                                            GenerationEngine)

    set_policy(compute_dtype="bfloat16")
    model = full_model(torch, DEV["cuda"]).to(torch.bfloat16)
    model.eval()
    cfg = ServingConfig(queue_port=port, gen_slots=N_SLOTS,
                        gen_page_size=PAGE, gen_max_seq_len=MAX_SEQ)
    eng = GenerationEngine(model, config=cfg, device=DEV["cuda"]).start()
    prompts, temps, n_new = serving_burst()
    n_req = len(prompts)
    arrivals = [[] for _ in range(n_req)]
    outs, errors = [None] * n_req, []
    sender = GenerationClient(port=port)

    def reader(i, uri, t_sub):
        gc = GenerationClient(port=port)
        try:
            toks = []
            for chunk in gc.stream(uri, timeout_s=600):
                arrivals[i].append(time.perf_counter())
                toks.extend(chunk.tolist())
            outs[i] = toks
        except Exception as e:               # reported below
            errors.append(repr(e))
        finally:
            gc.close()

    try:
        flash_attention_fwd.launches = 0
        paged_attention.launches = 0
        t0 = time.perf_counter()
        subs = []
        for i in range(n_req):
            subs.append((sender.submit(prompts[i], max_new_tokens=n_new,
                                       temperature=temps[i], seed=100 + i),
                         time.perf_counter()))
        threads = [threading.Thread(target=reader, args=(i, u, ts))
                   for i, (u, ts) in enumerate(subs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention_fwd.launches, paged_attention.launches
        stats = eng.batcher.stats()
    finally:
        sender.close()
        eng.stop()
    d = stats["dispatches"]
    if errors or any(o is None or len(o) != n_new for o in outs):
        raise AssertionError(f"16d: streams not ok with {n_new} tokens: "
                             f"{errors[:3]}")
    greedy = [i for i in range(n_req) if temps[i] == 0.0]
    differ = [i for i in greedy if outs[i] != direct5["outs"][i]]
    margins = {}
    for i in differ:
        seq = np.concatenate([prompts[i], np.asarray(outs[i][:-1], np.int32)])
        with torch.no_grad():
            lg = model.apply(torch.as_tensor(seq[None]))[0].float()
        rows = lg[len(prompts[i]) - 1:]
        chosen = rows[torch.arange(n_new), torch.as_tensor(outs[i]).long()]
        margins[i] = float((rows.max(dim=-1).values - chosen).max())
    ttft = [a[0] - ts for a, (_, ts) in zip(arrivals, subs)]
    itl = [b - a for ar in arrivals for a, b in zip(ar, ar[1:])]
    n_tok = sum(len(o) for o in outs)
    res = {"requests": n_req, "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "ttft_p50_ms": pct(ttft, 50) * 1e3,
           "itl_p50_ms": pct(itl, 50) * 1e3, "itl_p95_ms": pct(itl, 95) * 1e3,
           "greedy_equal_to_phase5": f"{len(greedy) - len(differ)}/"
                                     f"{len(greedy)}",
           "differing_margins": margins, "dispatches": d,
           "step_ema_ms": stats["step_ema_s"] * 1e3,
           "launches": {"K1": k1, "K2": k2},
           "phase5_direct": {k: direct5["res"][k] for k in (
               "tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p95_ms",
               "step_ema_ms")},
           "card": smi}
    log(f"[data-plane] 16d generation {json.dumps(res)}")
    del model
    set_policy(compute_dtype="float32")
    ok = (k1 == N_BLOCK * d["prefill"] and d["prefill"] == n_req
          and k2 == N_BLOCK * d["decode"] and d["decode"] > 0
          and all(m <= 0.1 for m in margins.values()))
    if not ok:
        raise AssertionError("16d: the generation data plane failed a gate")
    return k1, k2, res


def phase_data_plane(torch, state, direct5, smi):
    """Phase 16: the serving data plane on the card (16a-16d), on a broker
    of the port started in this process. Returns the data-plane launches
    of K1, K2 (16d), K5 and K6 (16a), and 16a's and 16d's results."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 ServingConfig, start_broker)

    t_phase = time.perf_counter()
    wall = {}
    set_policy(compute_dtype="float32")
    images = np.random.default_rng(30).normal(
        size=(DP_IMAGES, IMG, IMG, 3)).astype(np.float32)
    broker = start_broker()
    try:
        t = time.perf_counter()
        im = InferenceModel(supported_concurrent_num=IMG_THREADS,
                            max_batch_size=IMG_BATCH, device=DEV["cuda"])
        im.load(resnet_on(torch, state, DEV["cuda"]))
        cfg = ServingConfig(queue_port=broker.port, batch_size=IMG_BATCH,
                            concurrent_num=IMG_THREADS, int8=True,
                            warmup_shape=(IMG, IMG, 3))
        job = ClusterServing(im, cfg, group="data-plane").start()
        wall["start"] = time.perf_counter() - t
        try:
            t = time.perf_counter()
            direct, k5, k6, res16a = phase16_queue(torch, job, im,
                                                   broker.port, images, smi)
            wall["16a"] = time.perf_counter() - t
            t = time.perf_counter()
            phase16_http(torch, job, im, broker.port, images, direct, smi)
            wall["16b"] = time.perf_counter() - t
            t = time.perf_counter()
            phase16_swap(torch, job, im, broker.port, state, images, direct,
                         smi)
            wall["16c"] = time.perf_counter() - t
        finally:
            job.stop()
        del im, job
        torch.cuda.empty_cache()
        t = time.perf_counter()
        k1, k2, res16d = phase16_generation(torch, broker.port, direct5,
                                            smi)
        wall["16d"] = time.perf_counter() - t
    finally:
        broker.shutdown()
        broker.server_close()
    torch.cuda.empty_cache()
    wall["phase"] = time.perf_counter() - t_phase
    log(f"[data-plane] phase wall s: {json.dumps(wall)}")
    return {"K1": k1, "K2": k2, "K5": k5, "K6": k6, "16a": res16a,
            "16d": res16d}


# ------------------------------------------------------------ phase 17

# the control plane: phase 16's 256 seeded images (seed 30) through replica
# fleets; 17c's load loops over the first 32 of them; the row cache's
# table (1,000,000 x 64 f32, 256 MB) with 65,536 rows on the card, read by
# Zipf(1.1) batches of 8192 ids
CP_LOAD_IMAGES = 32
CP_FLEET = dict(fleet_heartbeat_s=0.1, fleet_failover_timeout_s=1.0,
                fleet_spawn_grace_s=120.0, breaker_reset_timeout_s=0.3)
CP_ROLLOUT = dict(rollout_window_s=1.5, rollout_min_requests=16,
                  rollout_canary_fraction=0.5, swap_timeout_s=120.0)
ITL_OBJECTIVE = {"name": "gen-itl", "type": "latency", "threshold_ms": 50.0,
                 "target": 0.99}
RC_ROWS, RC_WIDTH, RC_HOT, RC_BATCH, RC_BATCHES = (1_000_000, 64, 65_536,
                                                   8192, 48)


def _cp_cfg(port, **kw):
    """An int8 ResNet-50 replica's config: phase 16's batch 32 and
    concurrency 4, with the fleet's heartbeat and failover timeouts."""
    from analytics_zoo_tpu_torch.serving import ServingConfig

    return ServingConfig(queue_port=port, batch_size=IMG_BATCH,
                         concurrent_num=IMG_THREADS, int8=True,
                         **CP_FLEET, **kw)


def _cp_factory(torch, state, calls):
    """Thread-replica model factory: each replica its own int8 ResNet-50
    ``InferenceModel`` on the card (the engine quantizes it at start), its
    ``predict`` counted in ``calls[0]``."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel

    lock = threading.Lock()

    def make():
        im = InferenceModel(supported_concurrent_num=IMG_THREADS,
                            max_batch_size=IMG_BATCH, device=DEV["cuda"])
        im.load(resnet_on(torch, state, DEV["cuda"]))
        predict = im.predict

        def counted(x):
            with lock:
                calls[0] += 1
            return predict(x)

        im.predict = counted
        return im

    return make


class _Load:
    """Closed-loop clients, a context: 16a's 4 client threads, each with
    one of its share of ``images`` in flight, cycling until the context
    exits; ``done`` holds ``(i, answer, version)``."""

    def __init__(self, port, images):
        self.done, self.errors = [], []
        self._stop = threading.Event()

        def answer(i, y, version, _latency):
            self.done.append((i, y, version))

        self._threads = [threading.Thread(target=_client, args=(
            port, images, list(range(c, len(images), DP_CLIENTS)), None, 1,
            answer, self.errors, self._stop)) for c in range(DP_CLIENTS)]

    def __enter__(self):
        for th in self._threads:
            th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=600)


def _bit_equal(results, direct) -> int:
    return sum(np.array_equal(y, direct[i]) for i, (y, _) in results.items())


def _wait_until(pred, timeout_s: float, poll_s: float = 0.02) -> bool:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return pred()


def phase17_thread_fleet(torch, state, port, images, direct, smi):
    """17a: two int8 ResNet-50 replicas (thread mode) behind the
    ``ReplicaRouter``, phase 16a's burst, ``kill_replica("r0")`` once a
    third of it is answered. Every uri answered once, bit for bit the direct
    predict; ``requeued > 0``; the respawned r0 heartbeats and the fleet is
    back to 2 eligible; K6 = 53 and K5 = 1 per predict the replicas ran
    (their warm-up predicts included), counted from 0 once both replicas
    heartbeat. Returns the running fleet (17c reuses it) and K5, K6."""
    from analytics_zoo_tpu_torch.ops import int8_fused as f8
    from analytics_zoo_tpu_torch.serving import FleetSupervisor

    calls = [0]
    cfg = _cp_cfg(port, replicas=2, warmup_shape=(IMG, IMG, 3), **CP_ROLLOUT)
    t = time.perf_counter()
    fleet = FleetSupervisor(cfg, model_factory=_cp_factory(torch, state,
                                                           calls),
                            device=DEV["cuda"]).start()
    try:
        if not _wait_until(lambda: all(fleet._hb_seen.get(r)
                                       for r in ("r0", "r1")), 120):
            raise AssertionError("17a: the replicas never heartbeat")
        start_s = time.perf_counter() - t
        torch.cuda.synchronize()
        calls[0] = 0
        f8.int8_matmul_fused.launches = 0
        f8.int8_conv2d_fused.launches = 0
        killed = []

        def kill_at(k):
            if k >= len(images) // 3 and not killed:
                killed.append(time.perf_counter())
                fleet.kill_replica("r0")

        results, lat, wall, errors = _burst(port, images, "a", kill_at)
        again = _answered_again(port, "a", len(images))
        back = _wait_until(lambda: fleet.respawns >= 1
                           and fleet._hb_seen.get("r0")
                           and len(fleet.router.eligible_ids()) == 2, 120)
        reconverge_s = time.perf_counter() - killed[0] if killed else None
        torch.cuda.synchronize()
        k5, k6 = f8.int8_matmul_fused.launches, f8.int8_conv2d_fused.launches
        exact = _bit_equal(results, direct)
        res = {"images": len(images), "start_s": start_s, "wall_s": wall,
               "images_per_s": len(images) / wall,
               "latency_p50_ms": pct(lat, 50) * 1e3,
               "latency_p99_ms": pct(lat, 99) * 1e3,
               "killed": "r0", "requeued": fleet.requeued,
               "respawns": fleet.respawns, "reconverged": bool(back),
               "kill_to_two_eligible_s": reconverge_s,
               "eligible": fleet.router.eligible_ids(),
               "answered_again": again,
               "bit_equal_direct": f"{exact}/{len(results)}",
               "predicts": calls[0], "launches": {"K5": k5, "K6": k6},
               "errors": errors[:3], "card": smi}
        log(f"[control-plane] 17a thread fleet {json.dumps(res)}")
        ok = (not errors and len(results) == len(images) and again == 0
              and exact == len(images) and fleet.requeued > 0 and back
              and calls[0] > 0 and k6 == 53 * calls[0] and k5 == calls[0])
        if not ok:
            raise AssertionError("17a: a thread-fleet gate failed")
    except BaseException:
        fleet.stop(drain_s=1.0)
        raise
    return fleet, k5, k6, res


def _spawn_times(fleet, rids, t0, timeout_s):
    """Seconds from ``t0`` to each replica's first heartbeat."""
    seen = {}
    deadline = time.perf_counter() + timeout_s
    while len(seen) < len(rids) and time.perf_counter() < deadline:
        for r in rids:
            if r not in seen and fleet._hb_seen.get(r):
                seen[r] = time.perf_counter() - t0
        time.sleep(0.02)
    return seen


def phase17_process_fleet(torch, state, port, images, direct, tmp, smi,
                          plane16):
    """17b: two replica processes on the one card (``fleet_spawn:
    process``, ``python -m analytics_zoo_tpu_torch.serving.fleet --device
    cuda``) load the int8 ResNet-50 bundle this phase wrote with
    ``ImageClassifier.save_model`` (``InferenceModel.load_zoo``, int8 from
    the YAML config the supervisor hands them). A clean burst (images/s,
    p50, p99 beside 16a's one-interpreter numbers), then a rolling restart
    under a closed-loop load of 4 clients; every answer bit for bit the
    direct predict, every uri answered once; ``cli fleet-status`` and
    ``cli drain --replica r1`` against the live broker; each replica's
    spawn-to-first-heartbeat seconds, cold and on restart. Returns the
    bundle path."""
    import contextlib
    import io

    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.image.classification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.serving import FleetSupervisor, ServingConfig
    from analytics_zoo_tpu_torch.serving import cli as tcli

    t = time.perf_counter()
    bundle = os.path.join(tmp, "resnet50")
    ImageClassifier("resnet-50", (IMG, IMG, 3), CLASSES, device="cpu",
                    model=resnet_on(torch, state, "cpu")).save_model(bundle)
    im = InferenceModel(max_batch_size=IMG_BATCH, device=DEV["cuda"])
    im.load_zoo(bundle).quantize_int8()
    bundle_direct = np.concatenate([im.predict(images[i:i + IMG_BATCH])
                                    for i in range(0, len(images),
                                                   IMG_BATCH)])
    del im
    bundle_equal = bool(np.array_equal(bundle_direct, direct))
    save_s = time.perf_counter() - t
    yaml = os.path.join(tmp, "serving.yaml")
    with open(yaml, "w") as f:
        f.write(f"model:\n  path: {bundle}\n  int8: true\n"
                f"params:\n  batchSize: {IMG_BATCH}\n"
                f"  coreNum: {IMG_THREADS}\n"
                "fleet:\n  replicas: 2\n  spawn: process\n"
                "  heartbeat_s: 0.1\n  failover_timeout_s: 5.0\n"
                "  spawn_grace_s: 120\nhot_swap: false\n")
    cfg = ServingConfig.from_yaml(yaml)
    cfg.queue_port = port
    fleet = FleetSupervisor(cfg, config_path=yaml, device=DEV["cuda"])
    t0 = time.perf_counter()
    fleet.start()
    try:
        cmds = [h.proc.args for h in fleet._handles.values()]
        spawn_cold = _spawn_times(fleet, ("r0", "r1"), t0, 180)
        if len(spawn_cold) != 2 or not fleet.wait_eligible(2, 60):
            raise AssertionError(f"17b: replicas never came up "
                                 f"({spawn_cold})")
        results, lat, wall, errors = _burst(port, images, "b")
        again = _answered_again(port, "b", len(images))
        exact = _bit_equal(results, direct)
        # the rolling restart under a closed-loop load
        with _Load(port, images) as load:
            done = load.done
            _wait_until(lambda: len(done) >= 32, 60)
            t1 = time.perf_counter()
            spawn_restart = {}
            restarted = True
            for rid in ("r0", "r1"):
                t_r = time.perf_counter()
                restarted = fleet.restart_replica(rid, timeout_s=180) \
                    and restarted
                spawn_restart[rid] = time.perf_counter() - t_r
            rolling_s = time.perf_counter() - t1
            n_during = len(done)
            _wait_until(lambda: len(done) >= n_during + 32, 60)
        lerr = load.errors
        rolled_exact = sum(np.array_equal(y, direct[i]) for i, y, _ in done)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_status = tcli.main(["fleet-status", "--port", str(port)])
        status = json.loads(out.getvalue())
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_drain = tcli.main(["drain", "--replica", "r1", "--port",
                                  str(port)])
        drained = fleet.wait_state("r1", "drained", timeout_s=60)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tcli.main(["fleet-status", "--port", str(port)])
        after = json.loads(out.getvalue())
    finally:
        fleet.stop(drain_s=2.0)
    a16 = plane16["16a"]
    res = {"images": len(images), "bundle_save_and_direct_s": save_s,
           "bundle_direct_equals_17a_direct": bundle_equal,
           "replica_cmd": cmds[0][:3] + cmds[0][3:][-2:],
           "spawn_to_first_hb_s": spawn_cold,
           "wall_s": wall, "images_per_s": len(images) / wall,
           "latency_p50_ms": pct(lat, 50) * 1e3,
           "latency_p99_ms": pct(lat, 99) * 1e3,
           "one_interpreter_16a": {k: a16[k] for k in (
               "images_per_s", "latency_p50_ms", "latency_p99_ms")},
           "answered_again": again,
           "bit_equal_direct": f"{exact}/{len(results)}",
           "rolling_restart": {"ok": restarted, "s": rolling_s,
                               "per_replica_s": spawn_restart,
                               "answers": len(done),
                               "answers_during": n_during,
                               "bit_equal_direct":
                                   f"{rolled_exact}/{len(done)}",
                               "requeued": fleet.requeued,
                               "errors": lerr[:3]},
           "cli": {"fleet_status_rc": rc_status,
                   "replicas": sorted(status.get("replicas", {})),
                   "drain_rc": rc_drain, "r1_drained": drained,
                   "r1_state_after": after.get("replicas", {}).get(
                       "r1", {}).get("state")},
           "errors": errors[:3], "card": smi}
    log(f"[control-plane] 17b process fleet {json.dumps(res)}")
    ok = (bundle_equal and not errors and len(results) == len(images)
          and again == 0 and exact == len(images) and restarted
          and not lerr and rolled_exact == len(done) and len(done) > 64
          and rc_status == 0 and status.get("spawn") == "process"
          and sorted(status.get("replicas", {})) == ["r0", "r1"]
          and rc_drain == 0 and drained
          and res["cli"]["r1_state_after"] == "drained"
          and all(c[1:3] == ["-m", "analytics_zoo_tpu_torch.serving.fleet"]
                  for c in cmds))
    if not ok:
        raise AssertionError("17b: a process-fleet gate failed")
    return bundle, res


def phase17_rollout(torch, state, fleet, port, images, direct, tmp, smi):
    """17c: 17a's fleet (its ``RolloutController`` on) under a closed-loop
    load of 4 clients over the first 32 images. ``ModelPublisher``
    announces the float weights x 1.01: the canary swaps, validates and
    the rollout promotes fleet-wide. Then a checkpoint with a NaN: the
    canary refuses it, the rollout rolls back, ``model_rejections`` holds
    one record, the fleet stays on the x 1.01 version. Every answer
    carries a version and equals that version's direct predict bit for
    bit."""
    from analytics_zoo_tpu_torch.bridge import nest
    from analytics_zoo_tpu_torch.engine import checkpoint as ck
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.serving.hotswap import ModelPublisher

    n_load = CP_LOAD_IMAGES
    ref = InferenceModel(max_batch_size=IMG_BATCH, device=DEV["cuda"])
    ref.load(resnet_on(torch, state, DEV["cuda"]))
    names = list(ref.load_names)
    params2 = {n: state[n] * 1.01 for n in names}
    state2 = {k: params2.get(k, v) for k, v in state.items()}
    ref.load(resnet_on(torch, state2, DEV["cuda"])).quantize_int8()
    new = ref.predict(images[:n_load])
    del ref
    torch.cuda.empty_cache()
    good = ck.save_checkpoint(os.path.join(tmp, "ckpt"), nest(params2),
                              iteration=1, epoch=0)
    bad_params = dict(params2)
    bad_params[names[0]] = bad_params[names[0]].clone()
    bad_params[names[0]].view(-1)[0] = float("nan")
    bad = ck.save_checkpoint(os.path.join(tmp, "ckpt"), nest(bad_params),
                             iteration=2, epoch=0, keep=5)
    pub = ModelPublisher(port=port)
    ro = fleet.rollout
    load = _Load(port, images[:n_load])
    done = load.done
    try:
        load.__enter__()
        _wait_until(lambda: len(done) >= 16, 60)
        t = time.perf_counter()
        rec = pub.publish(good)
        v1 = rec["version"]
        promoted = _wait_until(
            lambda: any(v == v1 for v, _ in ro.outcomes)
            and set(fleet.model_versions().values()) == {v1}
            and ro.state()["phase"] == "idle", 180)
        promote_s = time.perf_counter() - t
        t = time.perf_counter()
        rec_bad = pub.publish(bad)
        v2 = rec_bad["version"]
        decided = _wait_until(
            lambda: any(v == v2 for v, _ in ro.outcomes)
            and ro.state()["phase"] == "idle", 180)
        rollback_s = time.perf_counter() - t
        n_at = len(done)
        _wait_until(lambda: len(done) >= n_at + 16, 60)
    finally:
        load.__exit__()
    try:
        rejections = pub.check_rejections()
        versions_after = fleet.model_versions()
    finally:
        pub.close()
    errors = load.errors
    want = {"initial": direct, v1: new}
    kinds = {"initial": 0, v1: 0, "wrong": 0}
    for i, y, v in done:
        if v in want and np.array_equal(y, want[v][i]):
            kinds[v] += 1
        else:
            kinds["wrong"] += 1
    after = [v for _, _, v in done[n_at:]]
    res = {"promote": {"version": v1, "ok": promoted, "s": promote_s},
           "nan_publish": {"version": v2, "decided": decided,
                           "s": rollback_s,
                           "rejections": [(r.get("version"),
                                           r.get("outcome"),
                                           r.get("reason"))
                                          for r in rejections]},
           "outcomes": list(ro.outcomes), "versions_after": versions_after,
           "answers": kinds, "answers_after_rollback": len(after),
           "errors": errors[:3], "card": smi}
    log(f"[control-plane] 17c canary rollout {json.dumps(res)}")
    ok = (promoted and decided and not errors
          and list(ro.outcomes) == [(v1, "promoted"), (v2, "rolled_back")]
          and len(rejections) == 1 and rejections[0].get("version") == v2
          and "nan" in str(rejections[0].get("reason"))
          and set(versions_after.values()) == {v1}
          and kinds["wrong"] == 0 and kinds["initial"] > 0
          and kinds[v1] > 0 and after and all(v == v1 for v in after))
    if not ok:
        raise AssertionError("17c: a canary-rollout gate failed")
    return res


def phase17_generation(torch, port, direct5, plane16, smi):
    """17d: two ``GenerationEngine`` replicas, each over its own copy of
    phase 5's bf16 LM (seed 0; 8 slots, page 16), reading the routed
    streams ``fleet:gen:g0``/``g1`` behind a round-robin ``ReplicaRouter``
    on the generation stream, with an ITL objective declared. Phase 5's
    16-request burst through ``GenerationClient``: every stream ok with 32
    tokens, each greedy stream equal to phase 5's or differing where its
    argmax margin is <= 0.1; K1 = 12 x prefills and K2 = 12 x decode
    steps, summed over both replicas; each engine's ``itl_target_s`` is
    the objective's 50 ms; ``/debug/slo`` of a frontend over the config's
    ``ObservabilityPlane`` lists it. Returns K1, K2."""
    import urllib.request

    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.observability import ObservabilityPlane
    from analytics_zoo_tpu_torch.ops.flash_attention import \
        flash_attention_fwd
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention
    from analytics_zoo_tpu_torch.serving import (FrontEndApp, ReplicaRouter,
                                                 ServingConfig)
    from analytics_zoo_tpu_torch.serving.generation import (GEN_STREAM,
                                                            GenerationClient,
                                                            GenerationEngine)

    set_policy(compute_dtype="bfloat16")
    cfg = ServingConfig(queue_port=port, gen_slots=N_SLOTS,
                        gen_page_size=PAGE, gen_max_seq_len=MAX_SEQ,
                        slo_objectives=(ITL_OBJECTIVE,))
    rids = ("g0", "g1")
    models = [full_model(torch, DEV["cuda"]).to(torch.bfloat16).eval()
              for _ in rids]
    engines = [GenerationEngine(m, config=cfg, group=f"fleet-{rid}",
                                stream="fleet:gen:" + rid,
                                device=DEV["cuda"]).start()
               for m, rid in zip(models, rids)]
    router = ReplicaRouter(cfg, rids, stream=GEN_STREAM, prefix="fleet:gen:",
                           group="gen-router", policy="round_robin",
                           name="genfleet").start()
    plane = ObservabilityPlane.from_config(cfg).start()
    app = FrontEndApp(cfg, port=0, plane=plane).start()
    prompts, temps, n_new = serving_burst()
    n_req = len(prompts)
    arrivals = [[] for _ in range(n_req)]
    outs, errors = [None] * n_req, []
    sender = GenerationClient(port=port)

    def reader(i, uri):
        gc = GenerationClient(port=port)
        try:
            toks = []
            for chunk in gc.stream(uri, timeout_s=600):
                arrivals[i].append(time.perf_counter())
                toks.extend(chunk.tolist())
            outs[i] = toks
        except Exception as e:               # reported below
            errors.append(repr(e))
        finally:
            gc.close()

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{app.port}/debug/slo",
                                    timeout=60) as r:
            slo = json.loads(r.read())
        flash_attention_fwd.launches = 0
        paged_attention.launches = 0
        t0 = time.perf_counter()
        subs = [(sender.submit(prompts[i], max_new_tokens=n_new,
                               temperature=temps[i], seed=100 + i),
                 time.perf_counter()) for i in range(n_req)]
        threads = [threading.Thread(target=reader, args=(i, u))
                   for i, (u, _) in enumerate(subs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention_fwd.launches, paged_attention.launches
        stats = [e.stats() for e in engines]
        routed = router.stats()["replicas"]
    finally:
        sender.close()
        router.stop()
        for e in engines:
            e.stop()
        app.stop()
        plane.stop()
    if errors or any(o is None or len(o) != n_new for o in outs):
        raise AssertionError(f"17d: streams not ok with {n_new} tokens: "
                             f"{errors[:3]}")
    prefills = sum(s["dispatches"]["prefill"] for s in stats)
    decodes = sum(s["dispatches"]["decode"] for s in stats)
    greedy = [i for i in range(n_req) if temps[i] == 0.0]
    differ = [i for i in greedy if outs[i] != direct5["outs"][i]]
    margins = {}
    for i in differ:
        seq = np.concatenate([prompts[i], np.asarray(outs[i][:-1], np.int32)])
        with torch.no_grad():
            lg = models[0].apply(torch.as_tensor(seq[None]))[0].float()
        rows = lg[len(prompts[i]) - 1:]
        chosen = rows[torch.arange(n_new), torch.as_tensor(outs[i]).long()]
        margins[i] = float((rows.max(dim=-1).values - chosen).max())
    ttft = [a[0] - ts for a, (_, ts) in zip(arrivals, subs)]
    itl = [b - a for ar in arrivals for a, b in zip(ar, ar[1:])]
    n_tok = sum(len(o) for o in outs)
    res = {"requests": n_req, "replicas": len(rids), "tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_ms": pct(ttft, 50) * 1e3,
           "itl_p50_ms": pct(itl, 50) * 1e3, "itl_p95_ms": pct(itl, 95) * 1e3,
           "dispatched": {r: routed[r]["dispatched"] for r in rids},
           "greedy_equal_to_phase5": f"{len(greedy) - len(differ)}/"
                                     f"{len(greedy)}",
           "differing_margins": margins,
           "dispatches": {"prefill": prefills, "decode": decodes},
           "itl_target_s": [s["itl_target_s"] for s in stats],
           "debug_slo": [o["name"] for o in slo.get("objectives", [])],
           "launches": {"K1": k1, "K2": k2},
           "one_engine_16d": {k: plane16["16d"][k] for k in (
               "tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p95_ms")},
           "card": smi}
    log(f"[control-plane] 17d routed generation {json.dumps(res)}")
    del models
    set_policy(compute_dtype="float32")
    ok = (k1 == N_BLOCK * prefills and prefills == n_req
          and k2 == N_BLOCK * decodes and decodes > 0
          and all(m <= 0.1 for m in margins.values())
          and all(s == ITL_OBJECTIVE["threshold_ms"] / 1e3
                  for s in res["itl_target_s"])
          and res["debug_slo"] == [ITL_OBJECTIVE["name"]]
          and slo.get("enabled") is True
          and sorted(res["dispatched"].values()) == [n_req // 2, n_req // 2])
    if not ok:
        raise AssertionError("17d: a routed-generation gate failed")
    return k1, k2, res


def phase17_autoscale(torch, state, port, images, direct, smi):
    """17e, first half: a thread fleet of int8 ResNet-50 replicas with the
    queue-driven autoscaler (``min_replicas`` 1, ``max_replicas`` 2, up
    at 8 owed requests a replica sustained 0.3 s, down after 1.5 s idle).
    Phase 16a's burst with 64 requests in flight a client: the fleet
    scales up to 2 and, idle, drains back to 1; every uri answered once,
    bit for bit the direct predict."""
    from analytics_zoo_tpu_torch.serving import FleetSupervisor

    cfg = _cp_cfg(port, replicas=1, autoscale=True, min_replicas=1,
                  max_replicas=2, autoscale_up_depth=8.0,
                  autoscale_sustain_s=0.3, autoscale_idle_s=1.5,
                  autoscale_cooldown_s=0.3, hot_swap=False)
    fleet = FleetSupervisor(cfg, model_factory=_cp_factory(torch, state,
                                                           [0]),
                            device=DEV["cuda"]).start()
    try:
        if not _wait_until(lambda: fleet._hb_seen.get("r0"), 120):
            raise AssertionError("17e: the first replica never heartbeat")
        peak = [1]

        def watch(k):
            peak[0] = max(peak[0], len(fleet._handles))

        results, lat, wall, errors = _burst(port, images, "e", watch,
                                               window=64)
        again = _answered_again(port, "e", len(images))
        t = time.perf_counter()
        down = _wait_until(lambda: len(fleet._handles) == 1
                           and any(e[0] == "down"
                                   for e in fleet.scale_events), 60)
        down_s = time.perf_counter() - t
        events = list(fleet.scale_events)
    finally:
        fleet.stop(drain_s=2.0)
    exact = _bit_equal(results, direct)
    res = {"images": len(images), "wall_s": wall,
           "images_per_s": len(images) / wall, "peak_replicas": peak[0],
           "scale_events": events, "back_to_one": down,
           "idle_to_one_s": down_s, "answered_again": again,
           "bit_equal_direct": f"{exact}/{len(results)}",
           "errors": errors[:3], "card": smi}
    log(f"[control-plane] 17e autoscale {json.dumps(res)}")
    ok = (not errors and len(results) == len(images) and again == 0
          and exact == len(images) and down
          and any(e[0] == "up" for e in events) and peak[0] >= 2)
    if not ok:
        raise AssertionError("17e: an autoscale gate failed")
    return res


def phase17_host_failover(torch, port, bundle, images, direct, tmp, smi):
    """17e, second half: two stand-in host agents as subprocesses
    (``python -m analytics_zoo_tpu_torch.serving.hostagent --config <yaml>
    --device cuda``), each serving one int8 ResNet-50 replica loaded from
    17b's bundle (int8 from the YAML); 16a's burst of 256 images from 4
    clients, and ``kill_host`` of the first replica's host (SIGKILL of its
    agent) once a quarter are answered. Every uri answered once, bit for bit
    the direct predict; exactly one ``fleet.host_failed`` event, naming that
    host; its replica respawned on the surviving agent, heartbeating and
    answering 32 more images bit for bit. Records each replica's
    spawn-to-first-heartbeat seconds and the seconds from the kill to the
    failover and to the respawned replica's first heartbeat."""
    from analytics_zoo_tpu_torch.observability import events as tev
    from analytics_zoo_tpu_torch.serving import (FleetSupervisor,
                                                 ServingConfig)

    yaml = os.path.join(tmp, "hosts.yaml")
    with open(yaml, "w") as f:
        f.write(f"model:\n  path: {bundle}\n  int8: true\n"
                f"params:\n  batchSize: {IMG_BATCH}\n"
                f"  coreNum: {IMG_THREADS}\n"
                "fleet:\n  replicas: 2\n  hosts: 2\n  heartbeat_s: 0.1\n"
                "  failover_timeout_s: 3.0\n  spawn_grace_s: 120\n"
                "hot_swap: false\n")
    cfg = ServingConfig.from_yaml(yaml)
    cfg.queue_port, cfg.breaker_reset_timeout_s = port, 0.3
    tev.reset_events()
    fleet = FleetSupervisor(cfg, config_path=yaml, device=DEV["cuda"])
    t0 = time.perf_counter()
    fleet.start()
    try:
        cmds = [s.proc.args for s in fleet._hosts.values()]
        spawn = _spawn_times(fleet, ("r0", "r1"), t0, 180)
        if len(spawn) != 2 or not fleet.wait_eligible(2, 60):
            raise AssertionError(f"17e: host replicas never came up "
                                 f"({spawn})")
        victim = fleet._handles["r0"].host
        moved = sorted(r for r, h in fleet._handles.items()
                       if h.host == victim)
        marks = {}

        def watch(t_kill):
            # the failover, then the moved replicas' first heartbeats on
            # another host, each in seconds from the kill
            deadline = t_kill + 180
            while "respawn_hb" not in marks and \
                    time.perf_counter() < deadline:
                if "failover" not in marks and fleet.host_failovers >= 1:
                    marks["failover"] = time.perf_counter() - t_kill
                if "failover" in marks and all(
                        fleet._handles[r].host not in (None, victim)
                        and fleet._hb_seen.get(r) for r in moved):
                    marks["respawn_hb"] = time.perf_counter() - t_kill
                time.sleep(0.01)

        watcher = []

        def kill_at(k):
            if k >= len(images) // 4 and not watcher:
                t_kill = time.perf_counter()
                fleet.kill_host(victim)
                watcher.append(threading.Thread(target=watch,
                                                args=(t_kill,)))
                watcher[0].start()

        results, lat, wall, errors = _burst(port, images, "h", kill_at)
        again = _answered_again(port, "h", len(images))
        if watcher:
            watcher[0].join(timeout=200)
        back = fleet.wait_eligible(2, 60)
        respawned_on = {r: fleet._handles[r].host for r in moved}
        after, _, _, errors_after = _burst(port, images[:32], "h2")
        # one decision: no second failover once the dead agent's last
        # heartbeat would have aged out and expired again
        _wait_until(lambda: fleet.host_failovers > 1,
                    2 * cfg.fleet_failover_timeout_s + 1.0)
        events = [e.fields for e in tev.events(kind="fleet.host_failed")]
    finally:
        fleet.stop(drain_s=2.0)
    exact = _bit_equal(results, direct)
    exact_after = _bit_equal(after, direct)
    res = {"images": len(images), "agent_cmd": cmds[0][1:],
           "spawn_to_first_hb_s": spawn, "killed_host": victim,
           "moved": moved, "respawned_on": respawned_on,
           "kill_to_failover_s": marks.get("failover"),
           "kill_to_respawned_hb_s": marks.get("respawn_hb"),
           "wall_s": wall, "images_per_s": len(images) / wall,
           "latency_p50_ms": pct(lat, 50) * 1e3,
           "latency_p99_ms": pct(lat, 99) * 1e3,
           "requeued": fleet.requeued, "host_failovers": fleet.host_failovers,
           "host_failed_events": [{k: e.get(k) for k in (
               "host", "replicas", "respawned", "requeued")}
               for e in events],
           "answered_again": again,
           "bit_equal_direct": f"{exact}/{len(results)}",
           "after_respawn_bit_equal": f"{exact_after}/{len(after)}",
           "errors": (errors + errors_after)[:3], "card": smi}
    log(f"[control-plane] 17e host failover {json.dumps(res)}")
    ok = (not errors and not errors_after and len(results) == len(images)
          and again == 0 and exact == len(images) and back
          and exact_after == len(after) == 32
          and "respawn_hb" in marks and len(events) == 1
          and events[0].get("host") == victim
          and all(h not in (None, victim) for h in respawned_on.values())
          and all(c[1:3] == ["-m", "analytics_zoo_tpu_torch.serving."
                                   "hostagent"] and "--config" in c
                  for c in cmds))
    if not ok:
        raise AssertionError("17e: a host-failover gate failed")
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase17_stack(torch, bundle, images, direct, tmp, smi):
    """17f: ``python -m analytics_zoo_tpu_torch.serving.stack --model
    <17b's bundle> --int8 --replicas 2`` as a subprocess (thread replicas,
    each loading the bundle on the card). ``/readyz`` answers 200; four
    ``/predict`` requests of one image each answer bit for bit the direct
    predict; ``cli info`` and ``cli events`` answer against its broker; a
    SIGTERM sent once a request is inside a replica (owed on its dispatch
    stream) still answers it, and the process exits 0."""
    import contextlib
    import io
    import signal
    import urllib.request

    from analytics_zoo_tpu_torch.serving import cli as tcli
    from analytics_zoo_tpu_torch.serving.client import _Conn

    http_port, broker_port = _free_port(), _free_port()
    log_path = os.path.join(tmp, "stack.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.stack",
             "--model", bundle, "--int8", "--replicas", "2",
             "--device", DEV["cuda"],
             "--http-port", str(http_port), "--broker-port",
             str(broker_port), "--flight-dir", tmp],
            cwd=str(ROOT), stdout=logf, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{http_port}"

    def ready():
        if proc.poll() is not None:
            return True
        try:
            with urllib.request.urlopen(url + "/readyz", timeout=2) as r:
                return r.status == 200
        except OSError:
            return False

    try:
        up = _wait_until(ready, 240) and proc.poll() is None
        ready_s = time.perf_counter() - t0
        if not up:
            with open(log_path) as f:
                raise AssertionError("17f: the stack never became ready: "
                                     + f.read()[-3000:])
        got = [np.asarray(_post_json(http_port, "/predict", json.dumps(
            {"instances": [{"input": images[i].tolist()}]}).encode())[
                "predictions"][0], np.float32) for i in range(4)]
        exact = sum(np.array_equal(g, direct[i]) for i, g in enumerate(got))
        outs = {}
        for verb in (["info"], ["events", "--count", "20"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = tcli.main(verb + ["--port", str(broker_port)])
            outs[verb[0]] = (rc, out.getvalue())
        info = json.loads(outs["info"][1])
        inflight = {}
        body = json.dumps({"instances": [{"input": images[4].tolist()}]}
                          ).encode()

        def request():
            try:
                inflight["y"] = _post_json(http_port, "/predict", body)
            except Exception as e:           # reported below
                inflight["error"] = repr(e)

        # SIGTERM once the request is owed on a replica's dispatch stream:
        # routed there and claimed (or claimed in the next ms), so the
        # ordered shutdown must let it finish
        conn = _Conn("127.0.0.1", broker_port, timeout=30.0)
        seen = []

        def owed_now():
            if sum(int(conn.call("LEN", f"fleet:req:{r}", f"fleet-{r}"))
                   for r in ("r0", "r1")):
                seen.append(time.perf_counter())
            return bool(seen) or not th.is_alive()

        try:
            th = threading.Thread(target=request)
            th.start()
            _wait_until(owed_now, 60, poll_s=0.001)
        finally:
            conn.close()
        owed = bool(seen)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        th.join(timeout=120)
        rc_exit = proc.wait(timeout=120)
        term_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    inflight_ok = "y" in inflight and np.array_equal(
        np.asarray(inflight["y"]["predictions"][0], np.float32), direct[4])
    res = {"ready_s": ready_s, "bit_equal_direct": f"{exact}/4",
           "cli_info_rc": outs["info"][0],
           "cli_info_keys": sorted(info)[:12],
           "cli_events_rc": outs["events"][0],
           "cli_events_lines": len(outs["events"][1].splitlines()),
           "inflight_seen_on_a_replica": bool(owed),
           "inflight_answered_bit_equal": bool(inflight_ok),
           "inflight_error": inflight.get("error"),
           "sigterm_to_exit_s": term_s, "exit_code": rc_exit, "card": smi}
    log(f"[control-plane] 17f stack {json.dumps(res)}")
    ok = (exact == 4 and outs["info"][0] == 0 and outs["events"][0] == 0
          and owed and inflight_ok and rc_exit == 0)
    if not ok:
        raise AssertionError("17f: a serving-stack gate failed")
    return res


def phase17_rowcache(torch, smi):
    """17g: ``HostRowCache`` over a 1,000,000 x 64 f32 table (256 MB, the
    memmap cold tier) with 65,536 hot rows on the card, read by 48 batches
    of 8192 Zipf(1.1) ids (scattered over the table by a seeded
    permutation). Every gather is byte-exact against ``table[ids]``; the
    hit rate, misses, evictions and gather ms are recorded."""
    from analytics_zoo_tpu_torch.serving import rowcache as rc

    rng = np.random.default_rng(32)
    t = time.perf_counter()
    table = rng.standard_normal((RC_ROWS, RC_WIDTH), dtype=np.float32)
    perm = rng.permutation(RC_ROWS)
    batches = [perm[(rng.zipf(1.1, RC_BATCH) - 1) % RC_ROWS]
               for _ in range(RC_BATCHES)]
    data_s = time.perf_counter() - t
    t = time.perf_counter()
    cache = rc.HostRowCache(table, hot_rows=RC_HOT, name="control-plane",
                            device=DEV["cuda"])
    build_s = time.perf_counter() - t
    ms, exact = [], 0
    try:
        for ids in batches:
            t = time.perf_counter()
            got = cache.gather(ids)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            exact += got.cpu().numpy().tobytes() == table[ids].tobytes()
        stats = cache.stats()
    finally:
        with rc._REGISTRY_LOCK:
            rc._REGISTRY.pop("control-plane", None)
        del cache
    res = {"rows": RC_ROWS, "width": RC_WIDTH, "hot_rows": RC_HOT,
           "batch": RC_BATCH, "batches": RC_BATCHES, "data_s": data_s,
           "build_s": build_s, "byte_exact": f"{exact}/{RC_BATCHES}",
           "hit_rate": stats["hit_rate"], "hits": stats["hits"],
           "misses": stats["misses"], "evictions": stats["evictions"],
           "hot_rows_pinned": stats["hot_rows"],
           "gather_ms_first": ms[0], "gather_ms_p50": pct(ms, 50),
           "gather_ms_p50_last_16": pct(ms[-16:], 50),
           "hot_bytes": stats["hot_bytes"],
           "host_bytes": stats["host_bytes"], "card": smi}
    log(f"[control-plane] 17g row cache {json.dumps(res)}")
    if exact != RC_BATCHES or stats["evictions"] == 0:
        raise AssertionError("17g: a row-cache gate failed")
    return res


def phase_control_plane(torch, state, direct5, plane16, smi):
    """Phase 17: the serving control plane on the card (17a-17g), each
    part on a broker of its own. Returns the control-plane launches of K1,
    K2 (17d), K5 and K6 (17a)."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.serving import start_broker

    t_phase = time.perf_counter()
    wall = {}
    set_policy(compute_dtype="float32")
    # spawned replicas, agents and the stack import this checkout's package
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    tmp = tempfile.mkdtemp(prefix="zoo-control-plane-")
    brokers = []

    def broker():
        b = start_broker()
        brokers.append(b)
        return b.port

    try:
        t = time.perf_counter()
        images = np.random.default_rng(30).normal(
            size=(DP_IMAGES, IMG, IMG, 3)).astype(np.float32)
        im = InferenceModel(max_batch_size=IMG_BATCH, device=DEV["cuda"])
        im.load(resnet_on(torch, state, DEV["cuda"])).quantize_int8()
        direct = np.concatenate([im.predict(images[i:i + IMG_BATCH])
                                 for i in range(0, DP_IMAGES, IMG_BATCH)])
        del im
        torch.cuda.empty_cache()
        wall["direct"] = time.perf_counter() - t
        t = time.perf_counter()
        port = broker()
        fleet, k5, k6, _ = phase17_thread_fleet(torch, state, port, images,
                                                direct, smi)
        wall["17a"] = time.perf_counter() - t
        try:
            t = time.perf_counter()
            phase17_rollout(torch, state, fleet, port, images, direct, tmp,
                            smi)
            wall["17c"] = time.perf_counter() - t
        finally:
            fleet.stop(drain_s=2.0)
        del fleet
        torch.cuda.empty_cache()
        t = time.perf_counter()
        bundle, _ = phase17_process_fleet(torch, state, broker(), images,
                                          direct, tmp, smi, plane16)
        wall["17b"] = time.perf_counter() - t
        t = time.perf_counter()
        phase17_autoscale(torch, state, broker(), images, direct, smi)
        wall["17e_autoscale"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        phase17_host_failover(torch, broker(), bundle, images, direct, tmp,
                              smi)
        wall["17e_hosts"] = time.perf_counter() - t
        t = time.perf_counter()
        phase17_stack(torch, bundle, images, direct, tmp, smi)
        wall["17f"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        k1, k2, _ = phase17_generation(torch, broker(), direct5, plane16,
                                       smi)
        wall["17d"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        phase17_rowcache(torch, smi)
        wall["17g"] = time.perf_counter() - t
    finally:
        for b in brokers:
            b.shutdown()
            b.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    wall["phase"] = time.perf_counter() - t_phase
    log(f"[control-plane] phase wall s: {json.dumps(wall)} | {smi}")
    return {"K1": k1, "K2": k2, "K5": k5, "K6": k6}


def kernel_launch_counts():
    """The launch counts of K1-K6 and the sampler."""
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.ops import int8_fused as f8
    from analytics_zoo_tpu_torch.ops.kv_cache import gumbel_max
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention

    return {"K1": tfa.flash_attention_fwd.launches,
            "K2": paged_attention.launches,
            "K3": tfa.flash_attention_bwd_dq.launches,
            "K4": tfa.flash_attention_bwd_dkv.launches,
            "K5": f8.int8_matmul_fused.launches,
            "K6": f8.int8_conv2d_fused.launches,
            "sampler": gumbel_max.launches}


def phase_recommenders(torch, smi, profile: bool = False):
    """Phase 14: 14a, 14b and 14c, and that none of K1-K6 launched."""
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    before = kernel_launch_counts()
    t0 = time.perf_counter()
    pairs, ratings = rec_ratings()
    wall = {"ratings": time.perf_counter() - t0}
    wnd, w = phase_wide_and_deep(torch, smi, pairs, ratings, profile)
    wall.update({f"14a_{k}": v for k, v in w.items()})
    torch.cuda.empty_cache()
    sess, w = phase_session(torch, smi, pairs, profile)
    wall.update({f"14b_{k}": v for k, v in w.items()})
    torch.cuda.empty_cache()
    t = time.perf_counter()
    pipe = phase_input_pipeline(torch, smi)
    wall["14c"] = time.perf_counter() - t
    after = kernel_launch_counts()
    wall["phase"] = time.perf_counter() - t0
    log(f"[rec] launch counts of K1-K6 and the sampler before phase 14 "
        f"{json.dumps(before)}, after {json.dumps(after)}: "
        f"{'none launched ok' if before == after else 'FAIL'}")
    log(f"[rec] phase wall s: {json.dumps(wall)}")
    if before != after:
        raise AssertionError("phase 14 launched a kernel of K1-K6")
    return {"wide_and_deep": wnd, "session": sess, "pipeline": pipe}


# --------------------------------------------------------------- phase 18

# phase 18d: the reference's news20 TextClassifier app (sequence length
# 500, GloVe width 200, a CNN encoder of 256 filters, 20 classes, a
# 20000-word index) on seeded synthetic documents
TC_SEQ, TC_EMBED, TC_FILTERS, TC_CLASSES, TC_VOCAB = 500, 200, 256, 20, 20000
TC_DOCS, TC_BATCH, TC_EPOCHS, TC_PARITY_STEPS = 4096, 128, 2, 5
# phase 18e: ImageSet prediction through ImagenetConfig's preprocessing;
# the images lie near the channel means with N(0, 1) noise (the scale the
# ResNet-50 cell's batch norm is calibrated on), each with its own colour
# shift and linear gradient of up to IS_SHIFT levels (at 2 levels and
# more the softmax saturates on some images)
IS_IMAGES, IS_SIDE, IS_SHIFT = 64, 300, 1.0
IS_PREP_TOL, IS_PROB_TOL, IS_SATURATED = 1e-3, 5e-4, 0.999


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metric_counts(snap) -> dict:
    """``{family: value}``: a counter's value (summed over its children) or
    a histogram's observation count."""
    out = {}
    for name, fam in snap.items():
        total = 0.0
        for v in fam["samples"].values():
            total += v["count"] if isinstance(v, dict) else v
        out[name] = total
    return out


def phase18_context(torch, smi):
    """18a: the runtime context on the card, then a 2-worker gloo job of
    the port's cluster worker on the CPU."""
    from analytics_zoo_tpu_torch.common.cluster import (WORKER_MODULE,
                                                        ClusterLauncher)
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)

    ctx = init_zoo_context()
    try:
        res = {"devices": [str(d) for d in ctx.devices],
               "process": [ctx.process_index, ctx.process_count],
               "mesh": ctx.mesh.shape}
    finally:
        reset_zoo_context()
    log(f"[files-sets] 18a context {json.dumps(res)}")
    if (len(res["devices"]) != 1 or res["process"] != [0, 1]
            or set(res["mesh"].values()) != {1}):
        raise AssertionError(f"18a: the context on one card is not one "
                             f"device, process 0 of 1, every axis 1: {res}")
    t0 = time.perf_counter()
    launcher = ClusterLauncher(
        2, coordinator_port=_free_port(), platform="cpu", collectives="gloo",
        env_extra={"PYTHONPATH": os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p])})
    monitor = launcher.launch()
    rcs = monitor.wait(timeout_s=120)
    wall = time.perf_counter() - t0
    reports = []
    for w in monitor.workers:
        with open(w.log_path) as f:
            lines = [l for l in f.read().splitlines() if l.startswith("{")]
        reports.append(json.loads(lines[-1]) if lines else None)
    job = {"rcs": rcs, "wall_s": wall, "argv": monitor.workers[0].cmd,
           "logs": [w.log_path for w in monitor.workers],
           "reports": reports}
    log(f"[files-sets] 18a cluster {json.dumps(job)}")
    if rcs != {0: 0, 1: 0}:
        raise AssertionError(f"18a: the cluster workers exited {rcs}")
    if any(WORKER_MODULE not in w.cmd or "analytics_zoo_tpu_torch" not in
           " ".join(w.cmd) for w in monitor.workers):
        raise AssertionError("18a: a worker's argv does not name the port")
    if sorted((r or {}).get("rank", -1) for r in reports) != [0, 1] or \
            any((r or {}).get("world") != 2 for r in reports):
        raise AssertionError(f"18a: the workers did not pass the barrier as "
                             f"ranks 0 and 1 of 2: {reports}")
    return {"context": res, "cluster_wall_s": wall}


def phase18_training_from_files(torch, smi):
    """18b: phase 7's LM cell trained 2 optimizer steps from TFRecord
    shards (under profile_steps, with a checkpoint and summaries) and from
    an XShards of 4 partitions, each against the same batches fed as
    arrays from the same initial weights."""
    import tempfile

    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.common.profiling import (TRACE_FILE,
                                                          profile_steps)
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.data.tfrecord import (encode_example,
                                                       write_records)
    from analytics_zoo_tpu_torch.data.xshards import XShards
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    set_policy(compute_dtype="float32")
    ids = train_ids()
    x, y = ids[:, :-1], ids[:, 1:]
    n_steps = TRAIN_SEQS // TRAIN_BATCH
    micro = n_steps * GRAD_ACCUM
    tmp = tempfile.mkdtemp(prefix="zoo_p18_")
    t0 = time.perf_counter()
    shards = []
    per = TRAIN_SEQS // 2
    for s in range(2):
        path = os.path.join(tmp, f"train-{s:05d}-of-00002.tfrecord")
        write_records(path, [encode_example({"x": x[i], "y": y[i]})
                             for i in range(s * per, (s + 1) * per)])
        shards.append(path)
    write_s = time.perf_counter() - t0
    kernels = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
               tfa.flash_attention_bwd_dkv)

    def run(data, **cfg):
        model = train_model(TransformerLM, lm_loss, TrainConfig, seed=0,
                            **cfg)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        tw = time.perf_counter()
        model.fit(*(data if isinstance(data, tuple) else (data,)),
                  batch_size=TRAIN_BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        counts = [k.launches for k in kernels]
        losses = [h["loss"] for h in model.estimator.history]
        est = model.estimator
        del model, est
        gc.collect()
        torch.cuda.empty_cache()
        return losses, counts, wall

    base, base_counts, base_wall = run((x, y))
    # TFRecord shards, traced, with one checkpoint and the summaries
    ckpt_dir, tb_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "tb")
    trace_dir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    fs_tf = FeatureSet.from_tfrecord(shards, feature_cols=["x"],
                                     label_cols=["y"])
    read_s = time.perf_counter() - t0
    model = train_model(TransformerLM, lm_loss, TrainConfig, seed=0,
                        checkpoint_dir=ckpt_dir)
    model.set_tensorboard(tb_dir, "lm")
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    before = _metric_counts(telemetry.snapshot())
    fit_ms = profile_steps(
        lambda: model.fit(fs_tf, batch_size=TRAIN_BATCH, nb_epoch=1),
        [()], trace_dir, warmup=0, steps=1)
    after = _metric_counts(telemetry.snapshot())
    tf_counts = [k.launches for k in kernels]
    tf_losses = [h["loss"] for h in model.estimator.history]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # an XShards of the same tokens in 4 partitions
    xs = XShards.partition({"x": x, "y": y}, num_partitions=4)
    fs_xs = FeatureSet.from_xshards(xs).transform(
        lambda t: (t["x"], t["y"]))
    xs_losses, xs_counts, xs_wall = run(fs_xs)
    delta = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after}
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        trace = f.read()
    names = {n: n in trace for n in ("flash_fwd_wgmma_kernel",
                                     "flash_bwd_dq_wgmma_kernel",
                                     "flash_bwd_dkv_wgmma_kernel")}
    n_summary = n_steps * 5 + 4   # 5 scalars a log point, 4 at the epoch end
    want = {"zoo_train_steps_total": n_steps,
            "zoo_train_checkpoints_total": 1,
            "zoo_train_checkpoint_snapshot_seconds": 1,
            "zoo_train_checkpoint_write_seconds": 1,
            "zoo_summary_events_total": n_summary,
            "zoo_data_batches_total": n_steps,
            "zoo_train_data_wait_seconds": n_steps,
            "zoo_train_grad_norm": n_steps,
            "zoo_train_compute_seconds": n_steps,
            "zoo_train_compiles_total": 1,
            "zoo_train_compile_seconds": 1,
            "zoo_data_prefetch_consumer_wait_seconds": n_steps + 1,
            "zoo_train_rollbacks_total": 0,
            "zoo_train_sigterm_exits_total": 0,
            "zoo_train_comm_seconds": 0}
    got = {k: delta.get(k, 0.0) for k in want}
    res = {"steps": n_steps, "micro_steps": micro,
           "tfrecord": {"shards": len(shards), "write_s": write_s,
                        "read_s": read_s, "fit_ms": fit_ms,
                        "bytes": sum(os.path.getsize(p) for p in shards)},
           "xshards": {"partitions": xs.num_partitions(),
                       "fit_s": xs_wall},
           "arrays_fit_s": base_wall, "losses": base,
           "tfrecord_losses": tf_losses, "xshards_losses": xs_losses,
           "launches": {"arrays": base_counts, "tfrecord": tf_counts,
                        "xshards": xs_counts},
           "trace_kernels": names,
           "trace_mb": len(trace) / 1e6, "metrics": got, "card": smi}
    log(f"[files-sets] 18b {json.dumps(res)}")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    if len(base) != n_steps or not all(math.isfinite(v) for v in base):
        raise AssertionError(f"18b: array-fed losses {base}")
    if tf_losses != base or xs_losses != base:
        raise AssertionError("18b: the losses from TFRecord or XShards are "
                             "not bit-identical to the array-fed run's")
    need = N_BLOCK * micro
    for what, c in (("arrays", base_counts), ("tfrecord", tf_counts),
                    ("xshards", xs_counts)):
        if c != [need] * 3:
            raise AssertionError(f"18b: K1, K3, K4 launches {c} from "
                                 f"{what}, need {need} each")
    if not all(names.values()):
        raise AssertionError(f"18b: the Chrome trace lacks a kernel: "
                             f"{names}")
    if got != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"18b: training metrics {got} != {want}")
    return [tf_counts[i] + xs_counts[i] for i in range(3)]


def phase18_dropout(torch, smi):
    """18c: a TransformerLayer(1024, 16, causal, dropout=0.1) in training
    on (1, 256, 1024) f32, card vs CPU; a Dropout layer's masks."""
    import copy

    from analytics_zoo_tpu_torch.common import prng
    from analytics_zoo_tpu_torch.nn.layers import Dropout
    from analytics_zoo_tpu_torch.nn.layers.attention import TransformerLayer
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    g = torch.Generator().manual_seed(18)
    cpu = TransformerLayer(HIDDEN, N_HEAD, causal=True, dropout=0.1,
                           generator=g, device="cpu").train()
    gpu = copy.deepcopy(cpu).to(DEV["cuda"]).train()
    x = torch.from_numpy(np.random.default_rng(18).normal(
        size=(1, 256, HIDDEN)).astype(np.float32))
    key = prng.fold_in(prng.PRNGKey(18), 7)
    with torch.no_grad():
        want = cpu.apply(x, rng=key)
        got = gpu.apply(x.to(DEV["cuda"]), rng=key)
        ref = gpu.eval().apply(x.to(DEV["cuda"]))
    err = float((got.cpu() - want).abs().max())
    dropped = float((got - ref).abs().max())
    mask_key = prng.fold_in(key, 1)
    m_cpu = prng.bernoulli(mask_key, 0.9, (1, 256, HIDDEN))
    m_gpu = prng.bernoulli(mask_key, 0.9, (1, 256, HIDDEN),
                           device=DEV["cuda"])
    layer = Dropout(0.2).train()
    ones = torch.ones((512, 1024))
    d_cpu = layer(ones, rng=key)
    d_gpu = layer(ones.to(DEV["cuda"]), rng=key)
    res = {"max_abs_err": err, "mask_equal": bool(torch.equal(
        m_cpu, m_gpu.cpu())), "keep_share": float(m_cpu.float().mean()),
        "dropout_layer_equal": bool(torch.equal(d_cpu, d_gpu.cpu())),
        "dropout_layer_keep": float((d_cpu != 0).float().mean()),
        "differs_from_inference": dropped, "card": smi}
    log(f"[files-sets] 18c {json.dumps(res)}")
    if not err <= TOL["float32"]:
        raise AssertionError(f"18c: card vs CPU {err} > 1e-4")
    if not (res["mask_equal"] and res["dropout_layer_equal"]):
        raise AssertionError("18c: dropout masks differ card vs CPU")
    if not dropped > 0:
        raise AssertionError("18c: training mode dropped nothing")
    return res


def _news_texts(n: int, seed: int = 16):
    """Seeded synthetic documents: ~25,000 distinct words, each class
    drawing 60% of a document's words from its own slice of them; mixed
    case and punctuation for the normalizer."""
    rng = np.random.default_rng(seed)
    # letters only: the normalizer keeps a-z
    pool = np.array(["".join(chr(97 + (i // 26 ** p) % 26) for p in range(4))
                     for i in range(25000)])
    labels = rng.integers(0, TC_CLASSES, n)
    texts = []
    for c in labels:
        length = int(rng.integers(80, 700))
        own = rng.integers(c * 1000, c * 1000 + 1000, length)
        other = rng.zipf(1.3, length) % len(pool)
        words = pool[np.where(rng.random(length) < 0.6, own, other)]
        texts.append(" ".join(w.upper() + "," if i % 11 == 0 else w
                              for i, w in enumerate(words.tolist())))
    return texts, labels.astype(np.int32)


def phase18_text_classifier(torch, smi):
    """18d: TextClassifier at the news20 app's widths trained on a TextSet,
    the first steps held to the CPU, then a bundle round trip."""
    import tempfile

    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.data.text import TextSet
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    t0 = time.perf_counter()
    texts, labels = _news_texts(TC_DOCS)
    ts = (TextSet.from_texts(texts, labels.tolist()).tokenize().normalize()
          .word2idx(max_words_num=TC_VOCAB - 1).shape_sequence(TC_SEQ))
    prep_s = time.perf_counter() - t0
    vocab = max(ts.get_word_index().values()) + 1

    def build(device):
        m = TextClassifier(TC_CLASSES, sequence_length=TC_SEQ,
                           encoder="cnn", encoder_output_dim=TC_FILTERS,
                           vocab_size=vocab, embed_dim=TC_EMBED,
                           device=device, seed=0)
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], config=TrainConfig(
                      shuffle=False, log_every_n_steps=1), device=device)
        return m

    model = build(DEV["cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(ts, batch_size=TC_BATCH, nb_epoch=TC_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = model.estimator.history
    losses = [h["loss"] for h in hist]
    step_ms = [h["data_ms"] + h["compute_ms"] for h in hist]
    peak = torch.cuda.max_memory_allocated()
    cpu = build("cpu")
    head = TextSet(ts.features[:TC_BATCH * TC_PARITY_STEPS])
    head.word_index = ts.word_index
    cpu.fit(head, batch_size=TC_BATCH, nb_epoch=1)
    cpu_losses = [h["loss"] for h in cpu.estimator.history]
    diffs = [abs(a - b) for a, b in zip(losses, cpu_losses)]
    x, _ = ts.to_arrays()
    x = x[:256]
    with tempfile.TemporaryDirectory() as d:
        model.save_model(d)
        loaded = InferenceModel(1, TC_BATCH,
                                device=DEV["cuda"]).load_zoo(d)
        direct = InferenceModel(1, TC_BATCH,
                                device=DEV["cuda"]).load(model)
        p_loaded, p_direct = loaded.predict(x), direct.predict(x)
    acc = model.evaluate(ts, batch_size=TC_BATCH)
    med = statistics.median(step_ms)
    res = {"docs": TC_DOCS, "vocab": vocab, "seq_len": TC_SEQ,
           "embed": TC_EMBED, "filters": TC_FILTERS,
           "classes": TC_CLASSES, "steps": len(hist), "prep_s": prep_s,
           "fit_s": wall, "step_ms_median": med,
           "samples_per_s": TC_BATCH / (med / 1e3),
           "samples_per_s_fit": TC_DOCS * TC_EPOCHS / wall,
           "max_memory_allocated": peak, "final_loss": losses[-1],
           "first_losses": losses[:TC_PARITY_STEPS],
           "cpu_losses": cpu_losses, "max_loss_diff": max(diffs),
           "train_accuracy": acc,
           "round_trip_equal": bool(np.array_equal(p_loaded, p_direct)),
           "card": smi}
    log(f"[files-sets] 18d {json.dumps(res)}")
    if len(cpu_losses) != TC_PARITY_STEPS or not max(diffs) <= 1e-4:
        raise AssertionError(f"18d: the first {TC_PARITY_STEPS} losses "
                             f"card vs CPU differ by {max(diffs)} > 1e-4")
    per_epoch = len(losses) // TC_EPOCHS
    first, last = (statistics.mean(losses[:per_epoch]),
                   statistics.mean(losses[-per_epoch:]))
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"18d: losses not finite, or the last epoch's "
                             f"mean {last} not below the first's {first}")
    if not res["round_trip_equal"]:
        raise AssertionError("18d: predictions after save_model/load_zoo "
                             "differ")
    return res


def _imagenet_plain(torch, imgs, crop):
    """ImageNet preprocessing written without the port's stages: torch's
    bilinear resize (half-pixel centres, no antialiasing) to 256/224 of
    the crop, the centre crop, the channel means subtracted."""
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.models.image.classification import \
        ImagenetConfig
    side = crop * 256 // 224
    t = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(side, side), mode="bilinear",
                      align_corners=False)
    o = (side - crop) // 2
    t = t[:, :, o:o + crop, o:o + crop].permute(0, 2, 3, 1)
    return (t.numpy() - np.asarray(ImagenetConfig.MEANS, np.float32)
            ).astype(np.float32)


def _is_images(n, side, shift, seed=19):
    """``n`` seeded ``side`` x ``side`` RGB images near the channel means:
    N(0, 1) noise, a colour shift and a linear gradient of up to ``shift``
    levels each."""
    from analytics_zoo_tpu_torch.models.image.classification import \
        ImagenetConfig
    rng = np.random.default_rng(seed)
    ramp = np.linspace(-1.0, 1.0, side, dtype=np.float32)
    col = rng.uniform(-shift, shift, size=(n, 1, 1, 3))
    gy = rng.uniform(-shift, shift, size=(n, 1, 1, 3))
    gx = rng.uniform(-shift, shift, size=(n, 1, 1, 3))
    imgs = (np.asarray(ImagenetConfig.MEANS) + col
            + gy * ramp[None, :, None, None] + gx * ramp[None, None, :, None]
            + rng.normal(size=(n, side, side, 3)))
    return imgs.astype(np.float32)


def phase18_image_set(torch, state, smi):
    """18e: an ImageSet of seeded 300x300 images through ImagenetConfig's
    preprocessing into predict_image_set on the ResNet-50 cell's float
    model, held against the CPU model on independently preprocessed
    arrays (the module docstring lists the gates)."""
    from analytics_zoo_tpu_torch.data.image import ImageSet
    from analytics_zoo_tpu_torch.models.image.classification import (
        ImageClassifier, ImagenetConfig)
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    imgs = _is_images(IS_IMAGES, IS_SIDE, IS_SHIFT)
    iset = ImageSet.from_arrays(imgs, seed=3)
    clf = ImageClassifier("resnet-50", (IMG, IMG, 3), CLASSES,
                          model=resnet_on(torch, state, DEV["cuda"]))
    t0 = time.perf_counter()
    top = clf.predict_image_set(iset, batch_size=IMG_BATCH)
    set_s = time.perf_counter() - t0
    x, _ = iset.transform(ImagenetConfig.preprocessing(IMG, IMG)).to_arrays()
    probs = clf.predict(x, batch_size=IMG_BATCH)
    order = np.argsort(-probs, axis=1)[:, :5]
    want = [list(zip([int(i) for i in idx], row[idx].tolist()))
            for row, idx in zip(probs, order)]
    # the reference: plain preprocessing, the same weights on the CPU
    plain = _imagenet_plain(torch, imgs, IMG)
    prep_err = float(np.abs(x - plain).max()) if x.shape == plain.shape \
        else float("inf")
    t0 = time.perf_counter()
    cpu = ImageClassifier("resnet-50", (IMG, IMG, 3), CLASSES,
                          model=resnet_on(torch, state, "cpu")).predict(
                              plain, batch_size=16)
    cpu_s = time.perf_counter() - t0
    cpu_sorted = -np.sort(-cpu, axis=1)
    prob_err, misplaced, top1_wrong = 0.0, 0, 0
    for i, pairs in enumerate(top):
        idx = np.asarray([c for c, _ in pairs])
        p = np.asarray([q for _, q in pairs])
        prob_err = max(prob_err, float(np.abs(p - cpu[i, idx]).max()))
        # each class the card ranks k-th is one the CPU ranks as high
        misplaced += int((cpu[i, idx] < cpu_sorted[i, :5]
                          - IS_PROB_TOL).sum())
        if cpu_sorted[i, 0] - cpu_sorted[i, 1] > 2 * IS_PROB_TOL:
            top1_wrong += int(idx[0] != int(np.argmax(cpu[i])))
    top1 = np.argmax(cpu, axis=1)
    res = {"images": IS_IMAGES, "side": IS_SIDE, "input": list(x.shape),
           "predict_image_set_s": set_s, "cpu_predict_s": cpu_s,
           "prep_max_abs_err": prep_err, "prep_tol": IS_PREP_TOL,
           "prob_max_abs_err": prob_err, "prob_tol": IS_PROB_TOL,
           "misplaced": misplaced, "top1_wrong": top1_wrong,
           "top1_classes": len(set(top1.tolist())),
           "top1_prob_min": float(cpu_sorted[:, 0].min()),
           "top1_prob_max": float(cpu_sorted[:, 0].max()),
           "equal_to_predict": top == want, "first": top[0], "card": smi}
    log(f"[files-sets] 18e {json.dumps(res)}")
    if x.shape != (IS_IMAGES, IMG, IMG, 3):
        raise AssertionError(f"18e: preprocessed shape {x.shape}")
    if not prep_err <= IS_PREP_TOL:
        raise AssertionError(f"18e: ImagenetConfig.preprocessing differs "
                             f"from the plain one by {prep_err}")
    if not prob_err <= IS_PROB_TOL or misplaced or top1_wrong:
        raise AssertionError("18e: predict_image_set's top-5 disagrees "
                             "with the CPU model on the plain arrays")
    if res["top1_prob_max"] > IS_SATURATED or res["top1_classes"] < 2:
        raise AssertionError("18e: the softmax saturates or every image "
                             "has the same top-1 class: the comparison "
                             "would not see a mix-up")
    if top != want:
        raise AssertionError("18e: predict_image_set's top-5 lists differ "
                             "from predict's on the same arrays")
    return res


def phase_files_and_sets(torch, state, smi):
    """Phase 18: files and sets to the card (18a-18e); returns the K1, K3
    and K4 launches of 18b's file-fed training."""
    t0 = time.perf_counter()
    wall = {}
    for name, fn in (("18a", lambda: phase18_context(torch, smi)),
                     ("18b", lambda: phase18_training_from_files(torch,
                                                                 smi)),
                     ("18c", lambda: phase18_dropout(torch, smi)),
                     ("18d", lambda: phase18_text_classifier(torch, smi)),
                     ("18e", lambda: phase18_image_set(torch, state, smi))):
        t = time.perf_counter()
        out = fn()
        wall[name] = time.perf_counter() - t
        if name == "18b":
            launches = out
        torch.cuda.empty_cache()
    wall["phase"] = time.perf_counter() - t0
    log(f"[files-sets] phase wall s: {json.dumps(wall)} card {smi}")
    return launches


# ------------------------------------------------------------- phase 19
#: phase 19's rank processes, all on the one card (gloo, CUDA tensors
#: staged through pinned host buffers: NCCL refuses ranks sharing a card)
MR_WORLD = 4
#: 19a's attention shape (the LM cell's), 19b's run (8 sequences, batch 4,
#: 2 steps), 19c's NCF steps, 19d's MoE and pipeline inputs
MR_ATT_B = 2
MR_TRAIN_SEQS, MR_TRAIN_BATCH = 8, 4
MR_NCF_STEPS = 8
MR_MOE_SHAPE = (2, 2048)
MR_PIPE_BATCH, MR_PIPE_MICRO = 4, 4
#: 19f-19h: fsdp=4 and tp=4 on the 4 ranks, dp=2 x fsdp=2 x tp=2 (update
#: sharding on) on 8 ranks of a second pool; 19b's recipe and gates, the
#: JAX rules (make_param_sharding) placing the leaves
MR_WORLD8 = 8
MR_MESHES = {"fsdp": dict(fsdp=4), "tp": dict(tp=4),
             "dp_fsdp_tp": dict(dp=2, fsdp=2, tp=2)}
#: the parameter elements a rank holds under those rules, at the LM cell's
#: width (the JAX model's leaves, each over its spec's axes)
MR_ELEMENTS = {"fsdp": 80_846_336, "tp": 54_818_816,
               "dp_fsdp_tp": 63_454_208}
#: 19b's limit on ||Δ − Δ_ref|| / ||Δ_ref||, the change of the f32 masters
#: over the fit against the one-rank run's. On an H100 the dp run reads
#: 0.015 and the sp run 0.067; a skipped update reads 1 and an update from
#: one rank's gradient alone 1.11
MR_DELTA_TOL = 0.2


def _mr_ctx(**axes):
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)

    reset_zoo_context()
    return init_zoo_context(mesh=MeshConfig(**axes))


def _mr_reset():
    from analytics_zoo_tpu_torch.common.context import reset_zoo_context

    reset_zoo_context()


def _mr_start(torch):
    """Zero the attention kernels' and the collectives' counts and the
    peak memory (after collecting what earlier cells on this rank left in
    reference cycles, such as a model and its Estimator, so the peak is
    this cell's); return the start time."""
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.parallel import comm

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(tfa)
    comm.reset_collective_counts()
    return time.perf_counter()


def _mr_end(torch, t0, out):
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.parallel import comm

    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0,
               launches=list(_launch_counts(tfa)),
               collectives=comm.collective_counts(),
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def mr_attention(strategy, dtype_name):
    """19a, one rank: the strategy's causal forward and backward over sp=4
    on the LM cell's attention shape, against the one-rank flash forward
    and K3/K4 backward on the same inputs (run before the counts are
    zeroed)."""
    import torch

    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.ops.attention import sharded_attention

    ctx = _mr_ctx(sp=MR_WORLD)
    try:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator().manual_seed(19)
        q, k, v, cot = (torch.randn((MR_ATT_B, SEQ_LEN, N_HEAD,
                                     HIDDEN // N_HEAD), generator=g)
                        .to("cuda", dtype) for _ in range(4))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ref = tfa.flash_attention(*leaves, True)
        ref_grads = torch.autograd.grad(ref, leaves, cot)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        t0 = _mr_start(torch)
        out = sharded_attention(*leaves, ctx.mesh, strategy=strategy,
                                causal=True)
        grads = torch.autograd.grad(out, leaves, cot)
        res = _mr_end(torch, t0, {"sp_index": ctx.mesh.coords["sp"]})
        res["max_abs_err"] = float((out.detach().float()
                                    - ref.detach().float()).abs().max())
        res["grad_err"] = max(
            float((a.float() - b.float()).abs().max())
            / max(1.0, float(b.float().abs().max()))
            for a, b in zip(grads, ref_grads))
        return res
    finally:
        _mr_reset()


def _mr_lm(torch, strategy, seed=0, remat="flash"):
    from analytics_zoo_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=N_BLOCK,
                         n_head=N_HEAD, seq_len=SEQ_LEN,
                         attn_strategy=strategy, remat=remat,
                         device="cuda", seed=seed)


def _mr_fit(torch, model, update_sharding=False, rows=None,
            param_sharding=None, compute_dtype="bfloat16"):
    """19b's recipe: phase 7's precision (bf16, f32 masters, Adam,
    clipping 1.0), batch MR_TRAIN_BATCH, no accumulation, 2 steps.
    ``rows``: train on these sequences only, in batches of
    ``MR_TRAIN_BATCH // MR_WORLD`` (one dp rank's share of each step).
    ``param_sharding``: the leaves' placement rule (19f-19h).
    ``compute_dtype`` "float32": the same in f32, the params their own
    masters (``scripts/torch_fsdp_tp_probe.py``)."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.models.transformer import lm_loss

    ids = np.random.default_rng(8).integers(
        0, VOCAB, size=(MR_TRAIN_SEQS, SEQ_LEN + 1)).astype(np.int32)
    batch = MR_TRAIN_BATCH
    if rows is not None:
        ids, batch = ids[rows], MR_TRAIN_BATCH // MR_WORLD
    model.compile(optimizer="adam", loss=lm_loss, config=TrainConfig(
        compute_dtype=compute_dtype, gradient_clip_norm=1.0, shuffle=False,
        log_every_n_steps=1, update_sharding=update_sharding),
        param_sharding=param_sharding)
    model.fit(ids[:, :-1], ids[:, 1:], batch_size=batch, nb_epoch=1)
    return [h["loss"] for h in model.estimator.history]


def _mr_init(model):
    """The model's f32 weights before training (the masters' start), on
    the host."""
    return {n: p.detach().float().cpu()
            for n, p in model.named_parameters()}


def _mr_masters(est):
    """A fit's f32 masters, whole (the JAX layout) and by name on every
    rank: a ZeRO-1 flat shard all-gathered over dp, placed blocks and
    per-leaf update shards through the Estimator's own ``_full``."""
    import torch

    from analytics_zoo_tpu_torch.parallel import comm
    from analytics_zoo_tpu_torch.parallel import update_sharding as upd

    st = est.train_state["opt_state"]
    if getattr(st, "master", None) is None:
        # f32: the params are the masters
        return {n: est._full(n, p.detach())
                for n, p in est.model.named_parameters()}
    if isinstance(st, upd.FlatUpdateState):
        meta = est._flat_meta
        flat = comm.all_gather(st.master, "dp", dim=0, tiled=True)
        return upd.unflatten_tree(flat, meta._replace(
            dtypes=(torch.float32,) * len(meta.names)))
    return {n: est._full(n, t, est._upd_dims.get(n))
            for n, t in st.master.items()}


def _mr_delta(init, master):
    return {n: master[n].float().cpu() - init[n] for n in init}


def _mr_delta_err(delta, ref_delta):
    """||Δ − Δ_ref|| / ||Δ_ref|| over every parameter (f64 sums), Δ the
    f32 masters' change over the fit: a run whose update changed
    nothing reads exactly 1."""
    num = den = 0.0
    for n, d_ref in ref_delta.items():
        num += float((delta[n] - d_ref).double().square().sum())
        den += float(d_ref.double().square().sum())
    return math.sqrt(num / den)


class _MrShapes:
    """Record the (B, T, heads, D) q shape of every K1, K3 and K4 call
    while it is entered. The recording functions stand in the module for
    the wrappers, so each carries its wrapper's launch count (the wrappers
    add to the module's name) and hands it back on exit."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")

    def __init__(self, tfa):
        self.tfa, self.seen, self.orig = tfa, set(), {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.orig[name] = getattr(self.tfa, name)

            def wrapped(q, *a, _fn=fn, _name=name, **kw):
                self.seen.add((_name, tuple(q.shape)))
                return _fn(q, *a, **kw)

            wrapped.launches = fn.launches
            setattr(self.tfa, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            fn.launches = getattr(self.tfa, name).launches
            setattr(self.tfa, name, fn)
        return False


def mr_train(mode, ref_path, compute_dtype="bfloat16", remat="flash"):
    """19b, one rank: the LM cell over dp=4 (flat update sharding) or sp=4
    (ring attention); 19f-19h over fsdp=4, tp=4 or dp=2 x fsdp=2 x tp=2
    (update sharding on) with the JAX rules placing the leaves. Every rank
    holds the change of its f32 masters over the fit (gathered whole) to
    the one-rank run's saved change."""
    import torch

    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    axes = MR_MESHES.get(mode) or ({"dp": MR_WORLD} if mode == "dp"
                                   else {"sp": MR_WORLD})
    ctx = _mr_ctx(**axes)
    try:
        model = _mr_lm(torch, "ring" if mode == "sp" else "flash",
                       remat=remat)
        init = _mr_init(model)
        rules = make_param_sharding(ctx.mesh) if mode in MR_MESHES else None
        us = {"dp": "flat", "dp_fsdp_tp": True}.get(mode, False)
        with _MrShapes(tfa) as shapes:
            t0 = _mr_start(torch)
            losses = _mr_fit(torch, model, us, param_sharding=rules,
                             compute_dtype=compute_dtype)
            res = _mr_end(torch, t0, {"losses": losses,
                                      "rank": ctx.process_index})
        est = model.estimator
        master = getattr(est.train_state["opt_state"], "master", None)
        res["shapes"] = sorted(shapes.seen)
        res["elements"] = sum(p.numel() for p in model.parameters())
        # the masters a rank holds (a flat shard: not by leaf)
        res["master_elements"] = (sum(t.numel() for t in master.values())
                                  if isinstance(master, dict) else None)
        delta = _mr_delta(init, _mr_masters(est))
        del init
        ref_delta = torch.load(ref_path, map_location="cpu")
        res["delta_err"] = _mr_delta_err(delta, ref_delta)
        if ctx.process_index == 0:
            # the control: a run that skipped the update
            res["delta_err_skipped"] = _mr_delta_err(
                {n: torch.zeros_like(d) for n, d in delta.items()},
                ref_delta)
        return res
    finally:
        _mr_reset()


def mr_ncf(shard):
    """19c, one rank: NCF at phase 12's width over dp=4, its fused table
    row-sharded or replicated, 8 f32 Adam steps of batch 8192."""
    import torch

    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.data.datasets import ML1M_ITEMS, ML1M_USERS
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.nn.optimizers import Adam

    ctx = _mr_ctx(dp=MR_WORLD)
    try:
        model = NeuralCF(ML1M_USERS, ML1M_ITEMS, class_num=5, device="cuda")
        rule = model.shard_tables(ctx.mesh) if shard else None
        est = Estimator(model, optimizer=Adam(lr=1e-3),
                        loss="sparse_categorical_crossentropy",
                        param_sharding=rule, device="cuda",
                        config=TrainConfig(shuffle=False, log_every_n_steps=1,
                                           prefetch_depth=0))
        rng = np.random.default_rng(12)
        n = MR_NCF_STEPS * NCF_BATCH
        x = np.stack([rng.integers(1, ML1M_USERS + 1, n),
                      rng.integers(1, ML1M_ITEMS + 1, n)], 1).astype(np.int32)
        y = rng.integers(0, 5, n).astype(np.int32)
        t0 = _mr_start(torch)
        est.fit((x, y), batch_size=NCF_BATCH, epochs=1)
        table = dict(model.named_parameters())[
            next(n for n, _ in model.named_parameters()
                 if n.endswith("embeddings"))]
        return _mr_end(torch, t0, {
            "losses": [h["loss"] for h in est.history],
            "table_rows": int(table.shape[0]), "full_rows": model.table_rows})
    finally:
        _mr_reset()


def mr_moe():
    """19d, one rank: MoE(1024, 8 experts, top 2) in f32 over ep=4 against
    the same layer without a mesh, output and input gradient."""
    import torch

    from analytics_zoo_tpu_torch.nn.layers import MoE

    m = MoE(HIDDEN, n_experts=8, top_k=2)
    m.build((None, None, HIDDEN), torch.Generator().manual_seed(19))
    m.to("cuda")
    g = torch.Generator().manual_seed(20)
    x = torch.randn(MR_MOE_SHAPE + (HIDDEN,), generator=g).to("cuda")
    cot = torch.randn(x.shape, generator=g).to("cuda")
    outs = []
    for ep in (MR_WORLD, 1):
        if ep > 1:
            _mr_ctx(ep=ep)
        try:
            xl = x.clone().requires_grad_(True)
            t0 = _mr_start(torch)
            y = m.apply(xl)
            (gx,) = torch.autograd.grad(y, xl, cot)
            res = _mr_end(torch, t0, {})
            outs.append((y.detach(), gx, res))
        finally:
            _mr_reset()
    (y4, g4, res), (y1, g1, _) = outs
    res["max_abs_err"] = float((y4 - y1).abs().max())
    res["grad_err"] = float((g4 - g1).abs().max()) / max(
        1.0, float(g1.abs().max()))
    return res


def mr_pipeline():
    """19d, one rank: PipelinedTransformerLM at the LM cell's width (12
    blocks) over pp=4 with 4 micro-batches in bf16; rank 0 builds the
    sequential TransformerLM from the same weights and measures the
    logits against it."""
    import torch

    from analytics_zoo_tpu_torch.models.transformer import (
        PipelinedTransformerLM, TransformerLM)
    from analytics_zoo_tpu_torch.nn.module import (cast_params,
                                                   precision_policy)

    ctx = _mr_ctx(pp=MR_WORLD)
    ids = torch.from_numpy(np.random.default_rng(21).integers(
        0, VOCAB, size=(MR_PIPE_BATCH, SEQ_LEN))).to("cuda")
    try:
        m = PipelinedTransformerLM(VOCAB, HIDDEN, N_BLOCK, N_HEAD, SEQ_LEN,
                                   n_microbatches=MR_PIPE_MICRO,
                                   attn_strategy="flash", device="cuda")
        cast_params(m, torch.bfloat16)
        t0 = _mr_start(torch)
        with torch.no_grad(), precision_policy(compute_dtype="bfloat16"):
            logits = m.apply(ids)
        res = _mr_end(torch, t0, {"rank": ctx.process_index})
    finally:
        _mr_reset()
    if ctx.process_index == 0:
        seq = TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=N_BLOCK,
                            n_head=N_HEAD, seq_len=SEQ_LEN,
                            attn_strategy="flash", device="cuda")
        cast_params(seq, torch.bfloat16)
        sd = {n: p for n, p in m.named_parameters()
              if not n.startswith("blocks.")}
        for n, p in m.blocks.named_parameters():
            for j in range(N_BLOCK):
                sd[f"block{j}.{n}"] = p[j]
        seq.load_state_dict(sd)
        with torch.no_grad(), precision_policy(compute_dtype="bfloat16"):
            want = seq.apply(ids)
        res["max_abs_err"] = float((logits.float() - want.float())
                                   .abs().max())
    return res


def phase19_nccl(torch, smi):
    """19e: an NCCL group at world size 1 runs one flat update exchange
    (reduce-scatter, norm all-reduce, all-gather on NCCL) that gives the
    plain Estimator step's parameters bit for bit (f32, Adam: both
    elementwise on the same values)."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.parallel import comm
    from analytics_zoo_tpu_torch.parallel import update_sharding as upd

    ids = np.random.default_rng(22).integers(
        0, EXAMPLE_KW["vocab"], size=(4, EXAMPLE_KW["seq_len"] + 1))
    batch = (torch.from_numpy(ids[:, :-1]).cuda(),
             torch.from_numpy(ids[:, 1:]).cuda())
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        ctx = _mr_ctx()
        ax = ctx.mesh.axis("dp")
        plain = TransformerLM(**EXAMPLE_KW, device="cuda", seed=0)
        flat = TransformerLM(**EXAMPLE_KW, device="cuda", seed=0)
        est_a = Estimator(plain, optimizer="adam", loss=lm_loss,
                          config=TrainConfig())
        est_a._init_state()
        est_a._step(batch)
        est_b = Estimator(flat, optimizer="adam", loss=lm_loss,
                          config=TrainConfig())
        est_b._init_state()
        _, grads = est_b._grads(batch)
        values = {n: p.detach() for n, p in est_b._params().items()}
        meta = upd.flat_meta(values, ax.size)
        state = upd.flat_opt_init(est_b._base_tx, values, meta, False)
        comm.reset_collective_counts()
        new, _, gnorm = upd.flat_exchange(
            values, {n: g.float() for n, g in grads.items()}, state, meta,
            est_b._base_tx, mesh=ctx.mesh)
        torch.cuda.synchronize()
        counts = comm.collective_counts()
        want = dict(plain.named_parameters())
        same = all(torch.equal(new[n], want[n].detach()) for n in new)
        res = {"backend": dist.get_backend(ax.group), "world": ax.size,
               "collectives": counts, "bit_equal": same,
               "grad_norm": float(gnorm), "card": smi}
        log(f"[multi-rank] 19e nccl {json.dumps(res)}")
        if not same or res["backend"] != "nccl" or counts["reduce-scatter"] \
                != 1 or counts["all-gather"] != 1:
            raise AssertionError(f"19e: the NCCL flat step at world size 1 "
                                 f"is not the plain step: {res}")
    finally:
        _mr_reset()
        dist.destroy_process_group()


def _mr_check(label, cond, detail):
    if not cond:
        raise AssertionError(f"{label}: {detail}")


def _mr_rank_kernels(torch, smi):
    """K1, K3 and K4 at the shape each rank of 19f-19h launches them at
    ((B / (dp * fsdp), 2048, 16 / tp, 64), causal, bf16, q/k/v strided
    out of one fused (B, T, 3, H, D) tensor as the QKV projection hands
    them over), held to their plain versions on the same inputs before the
    cells run: K1's out and LSE within TOL["bfloat16"], K3's dQ and K4's
    dK and dV within it relative to max(1, max|plain|), as phase 7 holds
    them. Returns ``{label: errors}``."""
    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(19)
    tol, out_errs = TOL["bfloat16"], {}
    for mode, label in (("fsdp", "19f"), ("tp", "19g"),
                        ("dp_fsdp_tp", "19h")):
        mesh = MR_MESHES[mode]
        rows = MR_TRAIN_BATCH // (mesh.get("dp", 1) * mesh.get("fsdp", 1))
        heads = N_HEAD // mesh.get("tp", 1)
        d = HIDDEN // N_HEAD
        case = _bwd_case(torch, gen, rows, SEQ_LEN, d, torch.bfloat16, True,
                         h=heads)
        q, k, v = case[:3]
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, ref_lse = flash_attention_plain(q, k, v, True)
        torch.cuda.synchronize()
        e_out, e_lse = maxerr(out, ref), maxerr(lse, ref_lse)
        del out, lse, ref, ref_lse
        shape = f"B={rows} T={SEQ_LEN} H={heads} D={d}"
        a3, a4 = _check_bwd_case(torch, case, True, "bfloat16",
                                 f"{label} rank shape {shape}")
        info = {"shape": [rows, SEQ_LEN, heads, d],
                "row_stride": int(q.stride(1)), "k1_out": e_out,
                "k1_lse": e_lse, "k3_dq_abs": a3, "k4_dkv_abs": a4,
                "tol": tol}
        log(f"[multi-rank] {label} rank-shape kernels {json.dumps(info)} "
            f"card {smi}")
        _mr_check(label, e_out <= tol and e_lse <= tol,
                  f"K1 off its plain version at {shape}: {info}")
        out_errs[label] = info
        del case, q, k, v
    torch.cuda.empty_cache()
    return out_errs


def _mr_sharded_cell(pool, mode, world, ref_path, ref_losses,
                     err_unaveraged, wall, smi):
    """19f-19h: one fsdp/tp cell on ``pool``'s ranks, held to 19b's
    one-rank reference (losses within 2e-2, Δ within MR_DELTA_TOL on every
    rank), its per-rank elements to MR_ELEMENTS, its K1/K3/K4 launches to
    12 layers x 2 steps a rank; returns the launches summed over ranks."""
    label = {"fsdp": "19f_fsdp4", "tp": "19g_tp4",
             "dp_fsdp_tp": "19h_dp2_fsdp2_tp2"}[mode]
    t = time.perf_counter()
    res = pool.run(mr_train, mode, ref_path)
    wall[label] = time.perf_counter() - t
    launches = np.sum([r["launches"] for r in res], 0)
    steps = MR_TRAIN_SEQS // MR_TRAIN_BATCH
    per = world * N_BLOCK * steps
    loss_err = max(abs(a - b) for r in res
                   for a, b in zip(r["losses"], ref_losses))
    info = {"mesh": MR_MESHES[mode], "losses": res[0]["losses"],
            "reference": ref_losses, "loss_err": loss_err,
            "delta_err_by_rank": [r["delta_err"] for r in res],
            "delta_err_skipped": res[0]["delta_err_skipped"],
            "delta_err_unaveraged": err_unaveraged,
            "elements": [r["elements"] for r in res],
            "master_elements": [r["master_elements"] for r in res],
            "shapes": res[0]["shapes"], "launches": launches.tolist(),
            "collectives": res[0]["collectives"],
            "rank_wall_s": [r["wall_s"] for r in res],
            "peak_bytes": [r["peak_bytes"] for r in res], "card": smi}
    log(f"[multi-rank] {label} {json.dumps(info)}")
    _mr_check(label, all(len(r["losses"]) == steps for r in res)
              and loss_err <= 2e-2
              and max(info["delta_err_by_rank"]) <= MR_DELTA_TOL,
              f"losses/update off the one-rank run: {info}")
    _mr_check(label, min(info["delta_err_skipped"], err_unaveraged)
              > MR_DELTA_TOL, f"a control passes the update gate: {info}")
    _mr_check(label, info["elements"] == [MR_ELEMENTS[mode]] * world,
              f"per-rank elements {info['elements']}, want "
              f"{MR_ELEMENTS[mode]}")
    if mode != "dp_fsdp_tp":
        # no update sharding: the masters are the placed blocks
        _mr_check(label, info["master_elements"] == info["elements"],
                  f"masters {info['master_elements']} are not the blocks")
    _mr_check(label, list(launches) == [per] * 3,
              f"K1/K3/K4 launches {launches.tolist()}, want {per}")
    heads = N_HEAD // MR_MESHES[mode].get("tp", 1)
    rows = MR_TRAIN_BATCH // (MR_MESHES[mode].get("dp", 1)
                              * MR_MESHES[mode].get("fsdp", 1))
    want = (rows, SEQ_LEN, heads, HIDDEN // N_HEAD)
    _mr_check(label, {shape for _, shape in info["shapes"]} == {want},
              f"K1/K3/K4 saw {info['shapes']}, want {want}")
    return launches


def phase_multi_rank(torch, smi, tmp):
    """Phase 19: multi-rank training on 4 rank processes sharing the card
    (19a-19d, 19f fsdp=4, 19g tp=4), on 8 (19h dp=2 x fsdp=2 x tp=2), and
    NCCL at world size 1 (19e), after K1/K3/K4 are held to their plain
    versions at 19f-19h's rank shapes; returns the K1, K3 and K4 launches
    summed over the ranks of 19a, 19b, 19d and 19f-19h, and those
    checks' errors."""
    from analytics_zoo_tpu_torch.parallel import comm

    t_phase = time.perf_counter()
    wall, sums = {}, np.zeros(3, np.int64)
    n_blk = N_BLOCK
    rank_shapes = _mr_rank_kernels(torch, smi)
    wall["rank_shape_kernels"] = time.perf_counter() - t_phase
    # the one-rank run 19b is held to, on this process: the change of its
    # f32 masters over the fit
    t = time.perf_counter()
    model = _mr_lm(torch, "flash")
    init = _mr_init(model)
    ref_losses = _mr_fit(torch, model)
    ref_delta = _mr_delta(init, _mr_masters(model.estimator))
    ref_path = os.path.join(tmp, "mr_ref_delta.pt")
    torch.save(ref_delta, ref_path)
    del model
    wall["19b_reference"] = time.perf_counter() - t
    # the control: one run on dp rank 0's sequences alone, as a dp run
    # whose gradients were never averaged would update rank 0's shard
    t = time.perf_counter()
    model = _mr_lm(torch, "flash")
    rows = [s * MR_TRAIN_BATCH + j for s in range(MR_TRAIN_SEQS
                                                  // MR_TRAIN_BATCH)
            for j in range(MR_TRAIN_BATCH // MR_WORLD)]
    _mr_fit(torch, model, rows=rows)
    err_unaveraged = _mr_delta_err(
        _mr_delta(init, _mr_masters(model.estimator)), ref_delta)
    del model, init, ref_delta
    torch.cuda.empty_cache()
    wall["19b_control"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = comm.RankPool(MR_WORLD, device="cuda", threads=0, timeout_s=600)
    try:
        pool.run(_mr_reset)
        wall["spawn"] = time.perf_counter() - t
        # 19a: K1/K3/K4 launches a rank: ring idx + 1 (future blocks
        # skipped), zigzag 2n + 1, ulysses 1
        want_sum = {"ring": MR_WORLD * (MR_WORLD + 1) // 2,
                    "zigzag": MR_WORLD * (2 * MR_WORLD + 1),
                    "ulysses": MR_WORLD}
        for strategy, dt, tol in (("ring", "bfloat16", 2e-2),
                                  ("zigzag", "bfloat16", 2e-2),
                                  ("ulysses", "bfloat16", 2e-2),
                                  ("ring", "float32", 1e-4)):
            t = time.perf_counter()
            res = pool.run(mr_attention, strategy, dt)
            label = f"19a_{strategy}_{dt}"
            wall[label] = time.perf_counter() - t
            launches = np.sum([r["launches"] for r in res], 0)
            err = max(r["max_abs_err"] for r in res)
            gerr = max(r["grad_err"] for r in res)
            log(f"[multi-rank] {label} {json.dumps({'launches': launches.tolist(), 'per_rank': [r['launches'] for r in res], 'max_abs_err': err, 'grad_err': gerr, 'rank_wall_s': [r['wall_s'] for r in res], 'peak_bytes': [r['peak_bytes'] for r in res], 'collectives': res[0]['collectives'], 'card': smi})}")
            _mr_check(label, err <= tol and gerr <= tol,
                      f"error {err} / grad {gerr} above {tol}")
            _mr_check(label, list(launches) == [want_sum[strategy]] * 3,
                      f"K1/K3/K4 launches {launches.tolist()}, want "
                      f"{want_sum[strategy]} each")
            if strategy == "ring":
                _mr_check(label, all(
                    r["launches"] == [r["sp_index"] + 1] * 3 for r in res),
                    "the causal ring ran a future block")
            sums += launches
        # 19b: the LM cell over dp=4 (flat) and sp=4 (ring)
        for mode in ("dp", "sp"):
            t = time.perf_counter()
            res = pool.run(mr_train, mode, ref_path)
            label = f"19b_{mode}"
            wall[label] = time.perf_counter() - t
            launches = np.sum([r["launches"] for r in res], 0)
            steps = MR_TRAIN_SEQS // MR_TRAIN_BATCH
            per = (MR_WORLD * n_blk * steps if mode == "dp"
                   else want_sum["ring"] * n_blk * steps)
            loss_err = max(abs(a - b) for r in res
                           for a, b in zip(r["losses"], ref_losses))
            delta_err = max(r["delta_err"] for r in res)
            info = {"losses": res[0]["losses"], "reference": ref_losses,
                    "loss_err": loss_err, "delta_err": delta_err,
                    "delta_err_by_rank": [r["delta_err"] for r in res],
                    "delta_err_skipped": res[0]["delta_err_skipped"],
                    "delta_err_unaveraged": err_unaveraged,
                    "launches": launches.tolist(),
                    "collectives": res[0]["collectives"],
                    "rank_wall_s": [r["wall_s"] for r in res],
                    "peak_bytes": [r["peak_bytes"] for r in res],
                    "card": smi}
            log(f"[multi-rank] {label} {json.dumps(info)}")
            _mr_check(label, all(len(r["losses"]) == steps for r in res)
                      and loss_err <= 2e-2 and delta_err <= MR_DELTA_TOL,
                      f"losses/update off the one-rank run: {info}")
            _mr_check(label, min(info["delta_err_skipped"],
                                 err_unaveraged) > MR_DELTA_TOL,
                      f"a control passes the update gate: {info}")
            _mr_check(label, list(launches) == [per] * 3,
                      f"K1/K3/K4 launches {launches.tolist()}, want {per}")
            if mode == "dp":
                # one exchange a step, and the comm probe's round at each
                # log point (every step) plus its warm-up round
                c = res[0]["collectives"]
                _mr_check(label, c["reduce-scatter"] == 2 * steps + 1 and
                          c["all-gather"] == 2 * steps + 1 and
                          c["all-reduce"] == 2 * steps,
                          f"flat exchange collectives {c}")
            sums += launches
        # 19c: NCF's table row-sharded against replicated
        ncf = {}
        for shard in (True, False):
            t = time.perf_counter()
            ncf[shard] = pool.run(mr_ncf, shard)
            wall[f"19c_{'sharded' if shard else 'replicated'}"] = \
                time.perf_counter() - t
        sh, rep = ncf[True], ncf[False]
        loss_err = max(abs(a - b) for a, b in zip(sh[0]["losses"],
                                                  rep[0]["losses"]))
        info = {"losses_sharded": sh[0]["losses"],
                "losses_replicated": rep[0]["losses"], "loss_err": loss_err,
                "table_rows": [r["table_rows"] for r in sh],
                "full_rows": sh[0]["full_rows"],
                "collectives_sharded": sh[0]["collectives"],
                "peak_bytes_sharded": [r["peak_bytes"] for r in sh],
                "peak_bytes_replicated": [r["peak_bytes"] for r in rep],
                "rank_wall_s": [r["wall_s"] for r in sh], "card": smi}
        log(f"[multi-rank] 19c {json.dumps(info)}")
        _mr_check("19c", len(sh[0]["losses"]) == MR_NCF_STEPS
                  and loss_err <= 1e-5
                  and all(r["table_rows"] * MR_WORLD == r["full_rows"]
                          for r in sh), f"sharded NCF off: {info}")
        # 19d: MoE over ep=4, the pipeline over pp=4
        t = time.perf_counter()
        res = pool.run(mr_moe)
        wall["19d_moe"] = time.perf_counter() - t
        err = max(r["max_abs_err"] for r in res)
        gerr = max(r["grad_err"] for r in res)
        info = {"max_abs_err": err, "grad_err": gerr,
                "collectives": res[0]["collectives"],
                "peak_bytes": [r["peak_bytes"] for r in res], "card": smi}
        log(f"[multi-rank] 19d_moe {json.dumps(info)}")
        _mr_check("19d_moe", err <= 1e-4 and gerr <= 1e-4,
                  f"ep=4 off ep=1: {info}")
        t = time.perf_counter()
        res = pool.run(mr_pipeline)
        wall["19d_pipeline"] = time.perf_counter() - t
        launches = np.sum([r["launches"] for r in res], 0)
        want_k1 = MR_WORLD * (n_blk // MR_WORLD) * (MR_PIPE_MICRO
                                                    + MR_WORLD - 1)
        info = {"max_abs_err": res[0]["max_abs_err"],
                "launches": launches.tolist(),
                "collectives": res[0]["collectives"],
                "rank_wall_s": [r["wall_s"] for r in res],
                "peak_bytes": [r["peak_bytes"] for r in res], "card": smi}
        log(f"[multi-rank] 19d_pipeline {json.dumps(info)}")
        _mr_check("19d_pipeline", res[0]["max_abs_err"] <= 2e-2,
                  f"pipelined logits off the sequential model: {info}")
        _mr_check("19d_pipeline", list(launches) == [want_k1, 0, 0],
                  f"K1 launches {launches.tolist()}, want {want_k1}")
        sums += launches
        # 19f, 19g: fsdp=4 and tp=4 on these 4 ranks
        for mode in ("fsdp", "tp"):
            sums += _mr_sharded_cell(pool, mode, MR_WORLD, ref_path,
                                     ref_losses, err_unaveraged, wall, smi)
    finally:
        pool.close()
    # 19h: dp=2 x fsdp=2 x tp=2 with update sharding, 8 ranks
    t = time.perf_counter()
    pool = comm.RankPool(MR_WORLD8, device="cuda", threads=1, timeout_s=900)
    try:
        pool.run(_mr_reset)
        wall["spawn8"] = time.perf_counter() - t
        sums += _mr_sharded_cell(pool, "dp_fsdp_tp", MR_WORLD8, ref_path,
                                 ref_losses, err_unaveraged, wall, smi)
    finally:
        pool.close()
    os.remove(ref_path)
    t = time.perf_counter()
    phase19_nccl(torch, smi)
    wall["19e"] = time.perf_counter() - t
    wall["phase"] = time.perf_counter() - t_phase
    log(f"[multi-rank] phase wall s: {json.dumps(wall)} card {smi}")
    return [int(n) for n in sums], rank_shapes



# ----------------------------------------------------------------- phase 20
#: phase 20a's requests: phase 5's first prompts, this many new tokens each
AN_REQS, AN_NEW = 4, 16


def _fresh_memory(torch) -> None:
    """Earlier cells' tensors out, the allocator's peak restarted: a
    witness sample's peak is then this cell's."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _kernel_launches():
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    from analytics_zoo_tpu_torch.ops import int8_fused as f8
    from analytics_zoo_tpu_torch.ops.kv_cache import gumbel_max
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention

    return {"K1": tfa.flash_attention_fwd.launches,
            "K2": paged_attention.launches,
            "K3": tfa.flash_attention_bwd_dq.launches,
            "K4": tfa.flash_attention_bwd_dkv.launches,
            "sampler": gumbel_max.launches,
            "K5": f8.int8_matmul_fused.launches,
            "K6": f8.int8_conv2d_fused.launches}


def _findings_count(rule: str) -> float:
    from analytics_zoo_tpu_torch.common import telemetry as ttm

    samples = ttm.snapshot().get("zoo_analysis_findings_total", {}).get(
        "samples", {})
    return sum(v for k, v in samples.items() if k.split(",")[0] == rule)


def phase20_decode(torch, smi, budget: int, witness_on):
    """20a: a batcher with a 1 MiB budget must raise hbm-budget (before
    ``witness_on()``: its static note would become the site's budget);
    then the LM serving cell's decode checks under "raise" with the card's
    memory as budget (decode, spec_k=4, chunks of 128), and 4 requests
    served through the checked batcher and through one built with
    graph_checks="off"."""
    from analytics_zoo_tpu_torch.analysis import GraphLintError
    from analytics_zoo_tpu_torch.analysis.rules.decode import (
        trace_decode, trace_prefill_chunk)
    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    dev = DEV["cuda"]
    set_policy(compute_dtype="bfloat16")
    model = full_model(torch, dev).to(torch.bfloat16)
    geo = dict(n_slots=N_SLOTS, page_size=PAGE, max_seq_len=MAX_SEQ,
               device=dev, autostart=False)
    out = {"check_ms": {}, "sites": {}}
    t0 = time.perf_counter()
    try:
        ContinuousBatcher(model, graph_checks="raise",
                          hbm_budget_bytes=1 << 20, **geo).close()
    except GraphLintError as e:
        rules = sorted({f.rule for f in e.findings})
        if rules != ["hbm-budget"]:
            raise AssertionError(f"1 MiB budget raised {rules}")
    else:
        raise AssertionError("a 1 MiB budget did not raise hbm-budget")
    log(f"[analysis] 20a a 1 MiB budget raised hbm-budget in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    witness_on()
    before = _kernel_launches()
    checked = None
    for arm, kw in (("decode", {}), ("spec", dict(spec_k=4)),
                    ("chunk", dict(prefill_chunk_tokens=128))):
        t0 = time.perf_counter()
        b = ContinuousBatcher(model, graph_checks="raise",
                              hbm_budget_bytes=budget, **geo, **kw)
        out["check_ms"][arm] = (time.perf_counter() - t0) * 1e3
        tr = trace_decode(model, b.cfg, b.cache, top_k=b.top_k,
                          spec_k=b.spec_k)
        out["sites"][arm] = tr.kernel_counts()
        if arm == "chunk":
            out["sites"]["chunk_prefill"] = trace_prefill_chunk(
                model, b.cfg, b.cache, 128).kernel_counts()
        if arm == "decode":
            checked = b
        else:
            b.close()
        del b, tr
    moved = {k: n - before[k] for k, n in _kernel_launches().items()
             if n != before[k]}
    log(f"[analysis] 20a decode checks (graph_checks='raise', budget "
        f"{budget} B): wall ms {json.dumps(out['check_ms'])}; kernel sites "
        f"{json.dumps(out['sites'])}; launches during the checks {moved}")
    if moved:
        raise AssertionError(f"the decode checks launched kernels: {moved}")
    if out["sites"]["decode"] != {"K2": N_BLOCK, "sampler": 1} or \
            out["sites"]["spec"].get("K2") != N_BLOCK or \
            out["sites"]["chunk_prefill"] != {"K2": N_BLOCK}:
        raise AssertionError(f"decode trace sites: {out['sites']}")
    prompts, temps, _ = serving_burst()
    prompts, temps = prompts[:AN_REQS], temps[:AN_REQS - 1] + [0.8]
    streams = {}
    for arm, batcher in (("raise", checked), ("off", None)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if batcher is None:
            batcher = ContinuousBatcher(model, graph_checks="off", **geo)
        try:
            zero = _kernel_launches()
            handles = [batcher.submit(p, max_new_tokens=AN_NEW,
                                      temperature=t, seed=200 + i)
                       for i, (p, t) in enumerate(zip(prompts, temps))]
            batcher.start()
            streams[arm] = [h.result(timeout_s=600) for h in handles]
            torch.cuda.synchronize()
            got = {k: n - zero[k] for k, n in _kernel_launches().items()}
            disp = batcher.stats()["dispatches"]
        finally:
            batcher.close()
        del batcher
        checked = None
        want_k2 = N_BLOCK * disp["decode"]
        want_k1 = N_BLOCK * disp["prefill"]
        log(f"[analysis] 20a serve ({arm}): {AN_REQS} requests x {AN_NEW} "
            f"tokens; dispatches {disp}; K1 {got['K1']} (need {want_k1}), "
            f"K2 {got['K2']} (need {N_BLOCK} x {disp['decode']} decode "
            f"steps = "
            f"{want_k2}), sampler {got['sampler']}")
        if got["K2"] != want_k2 or got["K1"] != want_k1 or \
                disp["decode"] < 1 or any(len(s) != AN_NEW
                                          for s in streams[arm]):
            raise AssertionError(f"20a {arm}: launches or streams wrong")
        if arm == "raise":
            out["launches"] = got
    if streams["raise"] != streams["off"]:
        raise AssertionError("a checked batcher's streams differ from an "
                             "unchecked one's")
    log("[analysis] 20a streams token-identical to graph_checks='off'")
    del model
    return out


def phase20_int8(torch, state, smi):
    """20b: the int8 ResNet-50 warmed up with graph_checks="raise": the
    census (53 K6 and 1 K5 sites, nothing quantized or int8 outside
    them), the checks' launches (none) and the static peak beside one
    batch-1 predict's measured peak."""
    from analytics_zoo_tpu_torch.analysis import profile_trace
    from analytics_zoo_tpu_torch.analysis.rules.fused_int8 import (
        fused_structure_counts, trace_dispatch)
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn.module import set_policy

    dev = DEV["cuda"]
    set_policy(compute_dtype="float32")
    # batch 1 only: the witness's samples then hold what the batch-1 trace
    # estimates
    im = InferenceModel(supported_concurrent_num=1, max_batch_size=1,
                        device=dev)
    im.load(resnet_on(torch, state, dev))
    im.quantize_int8()
    _fresh_memory(torch)
    sample = np.random.default_rng(12).normal(
        size=(1, IMG, IMG, 3)).astype(np.float32)
    zero = _kernel_launches()
    t0 = time.perf_counter()
    im.warm_up(sample, graph_checks="raise")
    warm_ms = (time.perf_counter() - t0) * 1e3
    got = {k: n - zero[k] for k, n in _kernel_launches().items()}
    t0 = time.perf_counter()
    trace = trace_dispatch(im, im._device_inputs(sample))
    census = fused_structure_counts(trace)
    trace_ms = (time.perf_counter() - t0) * 1e3
    static = profile_trace(trace).peak_live_bytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero = _kernel_launches()
    im.predict(sample)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    one = {k: n - zero[k] for k, n in _kernel_launches().items()}
    res = {"warm_up_ms": warm_ms, "trace_ms": trace_ms, "census": census,
           "warm_up_launches": got, "static_peak_bytes": static,
           "predict_peak_bytes": peak, "predict_delta_bytes": peak - base,
           "card": smi}
    log(f"[analysis] 20b {json.dumps(res)}")
    if census["kernels"] != {"K5": 1, "K6": 53} or \
            census["quantize_ops_outside_kernels"] or \
            census["int8_intermediates_outside_kernels"] or \
            not census["fused_invariants_hold"]:
        raise AssertionError(f"int8 census wrong: {census}")
    # warm_up's one bucket predict launches; its two checks must not
    if got["K6"] != 53 or got["K5"] != 1 or one["K6"] != 53:
        raise AssertionError(f"20b launches: warm_up {got}, predict {one}")
    del im
    return got


def phase20_training(torch, smi, budget: int):
    """20c: phase 7's cell trained 2 steps with graph_checks="raise" and
    the card's memory as hbm_budget_mb; the check alone first, whose
    parameters, optimizer state, step, key and zoo_train_* counters must
    come back bit for bit; then donate_state=False under "warn"."""
    from analytics_zoo_tpu_torch.common import telemetry as ttm
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    model = train_model(TransformerLM, lm_loss, TrainConfig, seed=0,
                        graph_checks="raise",
                        hbm_budget_mb=budget / 2 ** 20)
    ids = train_ids()
    x, y = ids[:, :-1], ids[:, 1:]
    est = model.estimator
    est._init_state()
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_before = [t.clone() for t in _tensor_leaves(
        est.train_state["opt_state"])]
    counters = {k: v for k, v in ttm.snapshot().items()
                if k.startswith("zoo_train_")}
    state = (est.train_state["step"], est.train_state["rng"])
    zero = _kernel_launches()
    t0 = time.perf_counter()
    est._run_graph_checks(FeatureSet.from_numpy(x, y), TRAIN_BATCH)
    check_ms = (time.perf_counter() - t0) * 1e3
    moved = {k: n - zero[k] for k, n in _kernel_launches().items()
             if n != zero[k]}
    same = (all(torch.equal(p, before[n])
                for n, p in model.named_parameters())
            and all(torch.equal(a, b) for a, b in zip(
                _tensor_leaves(est.train_state["opt_state"]), opt_before))
            and (est.train_state["step"], est.train_state["rng"]) == state
            and {k: v for k, v in ttm.snapshot().items()
                 if k.startswith("zoo_train_")} == counters)
    del before, opt_before
    model.eval()
    log(f"[analysis] 20c fit-start check alone: {check_ms:.1f} ms, "
        f"launches {moved}, state and counters bit for bit: {same}")
    if moved or not same:
        raise AssertionError("the fit-start check launched kernels or "
                             "changed the training state")
    _fresh_memory(torch)
    zero = _kernel_launches()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: n - zero[k] for k, n in _kernel_launches().items()}
    micro = TRAIN_SEQS // TRAIN_BATCH * GRAD_ACCUM
    losses = [h["loss"] for h in est.history]
    log(f"[analysis] 20c fit (graph_checks='raise', {micro // GRAD_ACCUM} "
        f"steps) in {wall:.2f} s: losses {losses}; K1 {got['K1']}, K3 "
        f"{got['K3']}, K4 {got['K4']} (need {N_BLOCK} x {micro} = "
        f"{N_BLOCK * micro}); peak {torch.cuda.max_memory_allocated()} B")
    if not got["K1"] == got["K3"] == got["K4"] == N_BLOCK * micro or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError("20c did not train through K1, K3 and K4")
    n0 = _findings_count("donation-missed")
    est.config.donate_state = False
    est.config.graph_checks = "warn"
    est._run_graph_checks(FeatureSet.from_numpy(x, y), TRAIN_BATCH)
    added = _findings_count("donation-missed") - n0
    log(f"[analysis] 20c donate_state=False under 'warn': "
        f"{added:g} donation-missed finding(s) counted")
    if added != 1:
        raise AssertionError("donate_state=False did not add one "
                             "donation-missed finding")
    del model, est
    return got


def _tensor_leaves(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if hasattr(t, "untyped_storage")]


def _analysis_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    env.pop("ZOO_TPU_MEM_WITNESS", None)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "analytics_zoo_tpu_torch.analysis", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    return out, (time.perf_counter() - t0) * 1e3


def phase_analysis(torch, state, smi, tmp):
    """Phase 20: the analysis tier on the card (20a-20e), from a clean
    memory state, with the memory witness on for 20a-20c."""
    from analytics_zoo_tpu_torch.common import memwitness as mw

    total = torch.cuda.get_device_properties(0).total_memory
    witness = os.path.join(tmp, "mem_witness.jsonl")
    _fresh_memory(torch)

    def witness_on():
        os.environ["ZOO_TPU_MEM_WITNESS"] = witness
        mw.reset_witness()

    try:
        decode = phase20_decode(torch, smi, total, witness_on)
        _fresh_memory(torch)
        int8 = phase20_int8(torch, state, smi)
        _fresh_memory(torch)
        train = phase20_training(torch, smi, total)
        mw.dump_witness(witness)
    finally:
        os.environ.pop("ZOO_TPU_MEM_WITNESS", None)
        mw.reset_witness()
        _fresh_memory(torch)
    out, cli_ms = _analysis_cli("--mem-witness", witness, "--json")
    if out.returncode != 0:
        raise AssertionError(f"--mem-witness exited {out.returncode}: "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    rep = json.loads(out.stdout)
    sites = ("serving.decode", "inference.dispatch", "estimator.step")
    rows = {s: {"measured_bytes": max(
                rep["mem_sites"][s]["max_live_bytes"],
                rep["mem_sites"][s]["max_bytes_in_use"] or 0),
                "static_bytes": rep["mem_statics"].get(s, {}).get(
                    "peak_bytes"),
                "samples": rep["mem_sites"][s]["n"]} for s in sites}
    bad = [f for f in rep["findings"] if f["rule"] in (
        "hbm-budget", "mem-witness-divergence")]
    log(f"[analysis] 20d witness ({cli_ms:.0f} ms): {json.dumps(rows)}; "
        f"findings {[f['rule'] for f in rep['findings']]}")
    if bad or any(rows[s]["static_bytes"] is None for s in sites):
        raise AssertionError(f"memory witness: {bad}, {rows}")
    out, cli_ms = _analysis_cli()
    log(f"[analysis] 20e `python -m analytics_zoo_tpu_torch.analysis` on "
        f"the package: exit {out.returncode} in {cli_ms:.0f} ms "
        f"({out.stderr.strip().splitlines()[-1] if out.stderr else ''}); "
        f"{smi}")
    if out.returncode != 0:
        raise AssertionError(f"the package lints dirty: {out.stdout[-2000:]}")
    launches = {k: decode["launches"].get(k, 0) + int8.get(k, 0)
                + train.get(k, 0) for k in ("K1", "K2", "K3", "K4",
                                              "sampler", "K5", "K6")}
    return launches


def analysis_child(smi: str, tmp: str) -> int:
    """Phase 20 in this (fresh) interpreter: the witness then measures the
    phase's own device memory, not what earlier phases' module caches keep
    (K2's split scratch grows to ~0.3 GB at phase 3's q_len 1024). Writes
    the launches to ``tmp/launches.json``."""
    import torch

    sys.path.insert(0, str(ROOT))
    try:
        launches = phase_analysis(torch, resnet_state(torch), smi, tmp)
    except Exception:
        traceback.print_exc()
        return 1
    with open(os.path.join(tmp, "launches.json"), "w") as f:
        json.dump(launches, f)
    return 0


def phase_analysis_isolated(smi: str, tmp: str):
    """Phase 20 in a child interpreter (its [analysis] lines on this
    stdout); returns its launches."""
    sys.stdout.flush()
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; "
            f"sys.exit(chip_smoke.analysis_child({smi!r}, {tmp!r}))")
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                        timeout=900).returncode
    log(f"[analysis] phase 20 in a fresh interpreter: exit {rc} in "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError("phase 20 failed")
    with open(os.path.join(tmp, "launches.json")) as f:
        return json.load(f)


# phase 21: the layer library. MobileNet v1 at full width (alpha 1.0,
# 224x224x3, 1000 classes: Howard et al., arXiv:1704.04861, as
# models/image/backbones.py builds it) trained from a seeded ImageSet of
# uint8 images and served in int8; MobileNetV2 at full width; a Sequential
# of the new layers
MB_IMAGES, MB_SIDE, MB_EPOCHS, MB_CHECKED_STEPS, MB_LR = 64, 256, 2, 2, 0.01
MB_V2_IMAGES = 8
LY_ROWS, LY_BATCH, LY_SIDE, LY_T, LY_TAGS = 32, 16, 16, 4, 5


def _rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mb_fit(torch, dev, imgs, labels, epochs, nudge=None):
    """``ImageClassifier("mobilenet").fit_image_set`` from seed 0 on
    ``dev``, SGD, batch IMG_BATCH (``nudge``: first move every weight one
    ulp up or down, the signs from that seed): the classifier, each
    step's loss, the moving statistics after each of the first
    MB_CHECKED_STEPS steps, and the fit's s."""
    from analytics_zoo_tpu_torch.data.image import ImageSet
    from analytics_zoo_tpu_torch.models.image.classification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.nn.optimizers import SGD

    clf = ImageClassifier("mobilenet", (IMG, IMG, 3), CLASSES, device=dev,
                          seed=0)
    if nudge is not None:
        gen = torch.Generator().manual_seed(nudge)
        with torch.no_grad():
            for p in clf.model.parameters():
                up = torch.rand(p.shape, generator=gen) < 0.5
                to = torch.where(up, float("inf"), float("-inf")).to(p)
                p.copy_(torch.nextafter(p, to))
    clf.compile(optimizer=SGD(lr=MB_LR))
    est = clf.model.estimator
    losses, stats, step = [], [], est._step

    def record(batch):
        loss, gnorm = step(batch)
        losses.append(float(loss))
        if len(losses) <= MB_CHECKED_STEPS:
            stats.append(torch.cat([
                v.detach().reshape(-1).cpu() for k, v in
                clf.model.state_dict().items()
                if k.endswith(("moving_mean", "moving_var"))]).numpy())
        return loss, gnorm

    est._step = record
    t0 = time.perf_counter()
    clf.fit_image_set(ImageSet.from_arrays(imgs, labels, seed=2),
                      batch_size=IMG_BATCH, nb_epoch=epochs)
    return clf, losses, stats, time.perf_counter() - t0


def _recording(fn, calls):
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    return wrapper


def _mb_times(torch, timer, dtimer, fn, plain_fn, m, k, n):
    """A K5/K6 call at a MobileNet shape: Timer and device-only ms, its
    plain version's Timer ms, and ``torch._int_mm`` of (m, k) x (k, n)
    int8 codes device-only (the int8 product alone, as phase 3's library
    column); nan on a host without a card."""
    if timer is None:
        return {key: float("nan") for key in ("ms", "device_ms", "plain_ms",
                                              "library_device_ms")}
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda")
    return {"ms": timer(fn, n=20), "device_ms": dtimer(fn),
            "plain_ms": timer(plain_fn, n=5),
            "library_device_ms": dtimer(lambda: torch._int_mm(a, w))}


def phase21_int8(torch, clf, x, smi):
    """21b: the trained MobileNet packed by ``quantize_int8`` and served by
    ``InferenceModel`` on the card: K6 = 12 and K5 = 1 a batch (counts set
    to 0 just before), each launch bit for bit its plain version on the
    card on the same inputs, each distinct shape timed device-only beside
    its bound; the float predict within 1e-4 of the CPU's; the top-1
    agreement of int8 against float."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.image.backbones import mobilenet
    from analytics_zoo_tpu_torch.ops import int8 as i8
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    cpu = mobilenet((IMG, IMG, 3), CLASSES, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         clf.model.state_dict().items()})
    with torch.no_grad():
        want = cpu.apply(torch.from_numpy(x)).numpy()
    im = InferenceModel(max_batch_size=IMG_BATCH, device=DEV["cuda"]).load(
        clf.model)
    floats = im.predict(x)
    d_float = float(np.abs(floats - want).max())
    im.quantize_int8()
    im.warm_up(x[:1])
    calls = {"K5": [], "K6": []}
    orig = (i8.int8_matmul_fused, i8.int8_conv2d_fused)
    i8.int8_matmul_fused = _recording(orig[0], calls["K5"])
    i8.int8_conv2d_fused = _recording(orig[1], calls["K6"])
    f8.int8_matmul_fused.launches = f8.int8_conv2d_fused.launches = 0
    try:
        probs = im.predict(x)
    finally:
        i8.int8_matmul_fused, i8.int8_conv2d_fused = orig
    k5, k6 = f8.int8_matmul_fused.launches, f8.int8_conv2d_fused.launches
    log(f"[layers] 21b int8 predict of {len(x)}: launches K6 {k6} (need "
        f"12), K5 {k5} (need 1); packed slots {len(im.packed_slots)}; "
        f"float cuda vs cpu max|d prob| {d_float:.3g} (tol 1e-4)")
    if (k6, k5) != (12, 1) or len(calls["K6"]) != 12 or \
            len(calls["K5"]) != 1:
        raise AssertionError("the int8 MobileNet did not run K6 on its 12 "
                             "packed convs and K5 on its head")
    if d_float > 1e-4:
        raise AssertionError("the float MobileNet on the card disagrees "
                             "with the cpu")
    if not np.isfinite(probs).all() or np.abs(probs.sum(1) - 1).max() > 1e-4:
        raise AssertionError("int8 MobileNet probabilities are not a "
                             "distribution")
    timer = Timer(torch) if DEV["cuda"] == "cuda" else None
    dtimer = DeviceTimer(torch, timer.flush) if timer is not None else None
    shapes = {}
    for args, kw, out in calls["K6"]:
        xin, packed = args[0], args[1]
        stride, pads, rule = kw["stride"], kw["pads"], kw["rule"]
        _i8_check(out, f8.int8_conv2d_fused_plain(xin, packed, stride, pads,
                                                  rule), "float32",
                  f"[layers] 21b K6 {tuple(xin.shape)} -> "
                  f"{tuple(out.shape)} {rule}")
        b, h, w, cin = xin.shape
        cout = out.shape[-1]
        key = (h, cin, cout)
        if key in shapes:
            shapes[key]["launches_per_predict"] += 1
            continue
        bms, by = bound_ms(xin.numel() * 4 + cin * cout + 4 * cout
                           + out.numel() * 4, 2 * b * h * w * cin * cout,
                           "int8")
        shapes[key] = {"shape": f"B={b} {h}x{w}x{cin} -> {cout}, 1x1/1",
                       "rule": rule, "launches_per_predict": 1,
                       "bound_ms": bms, "bound_by": by, **_mb_times(
                           torch, timer, dtimer,
                           lambda: orig[1](xin, packed, stride, pads, rule),
                           lambda: f8.int8_conv2d_fused_plain(
                               xin, packed, stride, pads, rule),
                           b * h * w, cin, cout)}
    (args, kw, out), = calls["K5"]
    xin, packed = args[0], args[1]
    block_k, rule = kw["block_k"], kw["rule"]
    _i8_check(out, f8.int8_matmul_fused_plain(xin, packed, block_k, rule),
              "float32", f"[layers] 21b K5 {tuple(xin.shape)} x "
                         f"{tuple(packed['q'].shape)} {rule}")
    kk, nn_ = packed["q"].shape
    bms, by = bound_ms(xin.numel() * 4 + kk * nn_ + 4 * nn_ + out.numel() * 4,
                       2 * xin.shape[0] * kk * nn_, "int8")
    head = {"shape": f"({xin.shape[0]}, {kk}) x ({kk}, {nn_}) g={block_k}",
            "rule": rule, "launches_per_predict": 1, "bound_ms": bms,
            "bound_by": by, **_mb_times(
                torch, timer, dtimer,
                lambda: orig[0](xin, packed, block_k, rule),
                lambda: f8.int8_matmul_fused_plain(xin, packed, block_k,
                                                   rule),
                xin.shape[0], kk, nn_)}
    for r in list(shapes.values()) + [head]:
        log(f"[layers] 21b {r['shape']} ({r['rule']}): Timer "
            f"{r['ms']:.5f} ms, device {r['device_ms']:.5f} x "
            f"{r['launches_per_predict']} (bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']}), plain {r['plain_ms']:.4f}, torch._int_mm "
            f"device {r['library_device_ms']:.5f} {smi}")
    agree = float((probs.argmax(1) == floats.argmax(1)).mean())
    k6_total = sum(r["device_ms"] * r["launches_per_predict"]
                   for r in shapes.values())
    log(f"[layers] 21b int8 vs float top-1 agreement {agree:.4f} over "
        f"{len(x)} images; K6 device ms a predict {k6_total:.5f}, K5 "
        f"{head['device_ms']:.5f} {smi}")
    return {"K5": k5, "K6": k6, "k6_shapes": list(shapes.values()),
            "k5_head": head, "top1_agreement": agree,
            "float_max_abs_d": d_float}


def phase21_mobilenet_v2(torch, smi):
    """21c: MobileNetV2 at full width, BN calibrated on 4 seeded images on
    the CPU, the same weights on the card: a float predict of
    MB_V2_IMAGES images within 1e-4 of the CPU's, absolute and relative to
    the largest probability."""
    from analytics_zoo_tpu_torch.models.image.backbones import mobilenet_v2

    x = np.random.default_rng(23).normal(size=(MB_V2_IMAGES, IMG, IMG, 3)
                                         ).astype(np.float32)
    cpu = mobilenet_v2((IMG, IMG, 3), CLASSES, device="cpu", seed=0)
    _bn_calibrate(torch, cpu, x[:4])
    card = mobilenet_v2((IMG, IMG, 3), CLASSES, device=DEV["cuda"], seed=0)
    card.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        want = cpu.apply(torch.from_numpy(x)).numpy()
        got = card.apply(torch.from_numpy(x).to(DEV["cuda"])).cpu().numpy()
    d = float(np.abs(got - want).max())
    rel = d / float(np.abs(want).max())
    log(f"[layers] 21c MobileNetV2 {IMG}x{IMG}x3 -> {CLASSES} float "
        f"cuda vs cpu, {MB_V2_IMAGES} images: max|d prob| {d:.3g} (tol "
        f"1e-4), relative to the largest {rel:.3g} (tol 1e-4), top prob "
        f"{float(want.max()):.4f}, top-1 equal "
        f"{bool(np.array_equal(got.argmax(1), want.argmax(1)))}")
    if d > 1e-4 or rel > 1e-4 or not np.isfinite(got).all():
        raise AssertionError("MobileNetV2 on the card disagrees with the "
                             "cpu")
    return d


def _layers_model(dev):
    """The Sequential of 21d: ResizeBilinear, DepthwiseConv2D,
    SeparableConvolution2D, LRN2D, ConvLSTM2D over row bands, a Dense
    with an L2 regularizer, and a CRF head."""
    from analytics_zoo_tpu_torch.nn import layers as L
    from analytics_zoo_tpu_torch.nn.regularizers import L2
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    side = LY_SIDE * 3 // 2
    half = side // 2
    return Sequential([
        L.ResizeBilinear(side, side, input_shape=(LY_SIDE, LY_SIDE, 3)),
        L.DepthwiseConv2D((3, 3), depth_multiplier=2, subsample=(2, 2)),
        L.SeparableConvolution2D(8, 3, 3, border_mode="same",
                                 activation="relu"),
        L.LRN2D(alpha=1e-2, n=3),
        L.Reshape((LY_T, half // LY_T, half, 8)),
        L.ConvLSTM2D(6, 3, border_mode="same", return_sequences=True),
        L.Reshape((LY_T, -1)),
        L.Dense(LY_TAGS, w_regularizer=L2(0.01)),
        L.CRF(LY_TAGS)], device=dev, seed=0)


def phase21_sequential(torch, smi):
    """21d: the Sequential of new layers trained 2 SGD steps with the CRF's
    NLL as the loss, on the card and on the CPU from the same weights:
    losses within 1e-4 relative, every parameter within 1e-4 of the
    largest of its leaf."""
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.nn.layers import crf_nll_from_packed
    from analytics_zoo_tpu_torch.nn.optimizers import SGD

    rng = np.random.default_rng(24)
    x = rng.normal(size=(LY_ROWS, LY_SIDE, LY_SIDE, 3)).astype(np.float32)
    tags = rng.integers(0, LY_TAGS, (LY_ROWS, LY_T)).astype(np.int64)
    tags[::3, -1] = -1                            # padded last steps
    out = {}
    for dev in (DEV["cuda"], "cpu"):
        m = _layers_model(dev)
        m.compile(optimizer=SGD(lr=0.05),
                  loss=lambda y, yh: crf_nll_from_packed(y, *yh))
        losses, step = [], m.estimator._step

        def record(batch, step=step, losses=losses):
            loss, gnorm = step(batch)
            losses.append(float(loss))
            return loss, gnorm

        m.estimator._step = record
        m.fit(x, tags, batch_size=LY_BATCH, nb_epoch=1)
        out[dev] = (losses, params_to_numpy(m))
    (lc, pc), (lp, pp) = out[DEV["cuda"]], out["cpu"]
    gap = _rel_gap(lc, lp)
    pgap = max(float(np.abs(pc[s][k] - v).max())
               / max(1.0, float(np.abs(v).max()))
               for s, d in pp.items() for k, v in d.items())
    log(f"[layers] 21d Sequential of DepthwiseConv2D, "
        f"SeparableConvolution2D, LRN2D, ResizeBilinear, ConvLSTM2D, a "
        f"regularized Dense and a CRF: {len(lc)} SGD steps, losses cuda "
        f"{[round(v, 6) for v in lc]} cpu {[round(v, 6) for v in lp]}, "
        f"rel gap {gap:.3g} (tol 1e-4), params max gap {pgap:.3g} (tol "
        f"1e-4)")
    if len(lc) != 2 or gap > 1e-4 or pgap > 1e-4 or \
            not np.isfinite(lc).all():
        raise AssertionError("the Sequential of new layers trains otherwise "
                             "on the card than on the cpu")
    return gap, pgap


def phase_layers(torch, smi):
    """Phase 21 (``[layers]`` lines): the layer library on the card. (a)
    ``ImageClassifier("mobilenet")`` at full width, ``fit_image_set`` on a
    seeded ImageSet of MB_IMAGES uint8 MB_SIDE x MB_SIDE images, SGD, batch
    IMG_BATCH, f32, MB_EPOCHS epochs (4 steps), BN in training mode; the
    same fit on the CPU, and on the card from weights moved one ulp, for
    MB_CHECKED_STEPS steps: step 1's loss and moving statistics within
    1e-4 relative of the CPU's, step 2's within 4x the card's own spread
    (at least 1e-4). (b) ``phase21_int8``. (c)
    ``phase21_mobilenet_v2``. (d) ``phase21_sequential``. Returns the K5
    and K6 launches of (b)'s predict and its per-shape rows."""
    from analytics_zoo_tpu_torch.data.image import ImageSet
    from analytics_zoo_tpu_torch.models.image.classification import \
        ImagenetConfig
    from analytics_zoo_tpu_torch.nn.module import set_policy

    set_policy(compute_dtype="float32")
    walls = {}
    t_all = time.perf_counter()
    rng = np.random.default_rng(21)
    imgs = rng.integers(0, 256, (MB_IMAGES, MB_SIDE, MB_SIDE, 3),
                        dtype=np.uint8)
    labels = rng.integers(0, CLASSES, MB_IMAGES).tolist()
    torch.cuda.reset_peak_memory_stats()
    clf, lc, sc, fit_s = _mb_fit(torch, DEV["cuda"], imgs, labels, MB_EPOCHS)
    peak = torch.cuda.max_memory_allocated()
    walls["21a_card_fit"] = fit_s
    t0 = time.perf_counter()
    n = MB_CHECKED_STEPS * IMG_BATCH
    _, lp, sp, _ = _mb_fit(torch, "cpu", imgs[:n], labels[:n], 1)
    walls["21a_cpu_fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ln, sn, _ = _mb_fit(torch, DEV["cuda"], imgs[:n], labels[:n], 1,
                           nudge=7)
    walls["21a_card_nudged_fit"] = time.perf_counter() - t0
    # step 1 runs the same weights on both: its loss and the statistics
    # it moves are held within 1e-4 relative; later steps run weights one
    # update apart, and this network at initialisation amplifies an
    # update's rounding (a BN stack's backward), so the card is held
    # within 4x of its own spread under a one-ulp move of the weights
    # (at least 1e-4 relative)
    gaps = {"loss1": _rel_gap(lc[0], lp[0]), "stats1": _rel_gap(sc[0],
                                                                 sp[0])}
    for i in range(1, MB_CHECKED_STEPS):
        gaps[f"loss{i + 1}"] = abs(lc[i] - lp[i]) / abs(lp[i])
        gaps[f"loss{i + 1}_spread"] = abs(ln[i] - lc[i]) / abs(lp[i])
        gaps[f"stats{i + 1}"] = float(np.linalg.norm(sc[i] - sp[i])
                                      / np.linalg.norm(sp[i]))
        gaps[f"stats{i + 1}_spread"] = float(np.linalg.norm(sn[i] - sc[i])
                                             / np.linalg.norm(sp[i]))
    ok = (gaps["loss1"] <= 1e-4 and gaps["stats1"] <= 1e-4 and all(
        gaps[f"{q}{i + 1}"] <= max(4 * gaps[f"{q}{i + 1}_spread"], 1e-4)
        for q in ("loss", "stats") for i in range(1, MB_CHECKED_STEPS)))
    log(f"[layers] 21a MobileNet v1 alpha 1.0 {IMG}x{IMG}x3 -> {CLASSES}, "
        f"fit_image_set of {MB_IMAGES} uint8 images, batch {IMG_BATCH}, "
        f"f32, SGD {MB_LR}: {len(lc)} steps in {fit_s:.3f} s, losses "
        f"{[round(v, 6) for v in lc]}; the first {MB_CHECKED_STEPS} on the "
        f"cpu {[round(v, 6) for v in lp]}, on the card from weights moved "
        f"one ulp {[round(v, 6) for v in ln]}; relative gaps "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in gaps.items()})} "
        f"(step 1 tol 1e-4; later steps 4x the spread, at least 1e-4) "
        f"{'ok' if ok else 'FAIL'}; peak memory {peak / 2**20:.1f} MiB "
        f"{smi}")
    if len(lc) != MB_EPOCHS * MB_IMAGES // IMG_BATCH or \
            not np.isfinite(lc).all() or not ok:
        raise AssertionError("MobileNet's training on the card disagrees "
                             "with the cpu")
    t0 = time.perf_counter()
    x, _ = ImageSet.from_arrays(imgs[:IMG_BATCH]).transform(
        ImagenetConfig.preprocessing(IMG, IMG)).to_arrays()
    int8 = phase21_int8(torch, clf, np.asarray(x, np.float32), smi)
    walls["21b_int8"] = time.perf_counter() - t0
    del clf
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v2 = phase21_mobilenet_v2(torch, smi)
    walls["21c_mobilenet_v2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = phase21_sequential(torch, smi)
    walls["21d_sequential"] = time.perf_counter() - t0
    walls["total"] = time.perf_counter() - t_all
    log(f"[layers] phase wall s {json.dumps(walls)} {smi}")
    return {**int8, "mobilenet_losses": lc, "fit_gaps": gaps,
            "v2_max_abs_d": v2,
            "sequential_gaps": seq, "walls": walls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel checks only")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, trace one more burst and phase "
                         "5b's burst in each arm, after "
                         "training one more step and after the int8 burst "
                         "one int8 predict, with torch.profiler, and print "
                         "where the device time goes")
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout of the repo (e.g. the parent "
                         "commit from git archive): time its K1-K6 "
                         "beside this one's, in this process")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "analytics_zoo_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no analytics_zoo_tpu_torch package beside "
              f"{__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        smi = phase_device(torch)
        parent = load_parent(args.parent) if args.parent else None
        phase_build(parent)
        timer = Timer(torch)
        dtimer = DeviceTimer(torch, timer.flush)
        kernels = [check_k1(torch, timer, dtimer, parent),
                   check_k2(torch, timer, dtimer, parent),
                   *check_k3_k4(torch, timer, dtimer, parent),
                   check_sampler(torch, timer),
                   check_k5(torch, timer, dtimer, parent),
                   check_k6(torch, timer, dtimer, parent)]
        wide = check_wide(torch, timer, dtimer)
        for k in kernels:
            if k["name"] in wide:
                k["wide_head"] = wide[k["name"]]
        del timer, dtimer
        if not args.quick:
            gpu_model = full_model(torch, "cuda")
            phase_parity(torch, gpu_model)
            k1_serving, k2, ks, direct5 = phase_serving(torch, gpu_model,
                                                        smi)
            k2_features = phase_serving_features(torch, gpu_model, smi)
            if args.profile:
                phase_profile(torch, gpu_model, smi)
                profile_feature_arms(torch, gpu_model, smi)
            del gpu_model
            torch.cuda.empty_cache()
            phase_train_parity(torch)
            torch.cuda.empty_cache()
            k1, k3, k4, train_hist = phase_training(torch, smi,
                                                    profile=args.profile)
            for k, n in zip(kernels, (k1, k2, k3, k4, ks)):
                k["launches"] = n
            kernels[0]["launches_by_path"] = {"serving": k1_serving,
                                              "training": k1}
            kernels[1]["launches_by_path"] = {
                "serving": k2, **{arm: k2_features[arm]
                                  for arm in ("spec", "chunked", "prefix",
                                              "all")}}
            torch.cuda.empty_cache()
            state = resnet_state(torch)
            k5, k6 = phase_int8_serving(torch, state, smi,
                                        profile=args.profile)
            k5_mlp = phase_int8_mlp(torch, smi)
            phase_int8_parity(torch, state)
            kernels[5]["launches"] = k5
            kernels[5]["launches_by_path"] = {"resnet_serving": k5,
                                              "mlp_per_predict": k5_mlp}
            kernels[6]["launches"] = k6
            torch.cuda.empty_cache()
            phase_example(torch)
            torch.cuda.empty_cache()
            ncf, ncf_data_ = phase_ncf(torch, smi, profile=args.profile)
            torch.cuda.empty_cache()
            resume, dots = phase_checkpoint(torch, smi, train_hist,
                                            ncf["explicit"], ncf_data_)
            del ncf_data_
            torch.cuda.empty_cache()
            phase_recommenders(torch, smi, profile=args.profile)
            torch.cuda.empty_cache()
            remainder = phase_serving_remainder(torch, state, smi)
            for k, key in ((kernels[0], "K1"), (kernels[1], "K2"),
                           (kernels[5], "K5"), (kernels[6], "K6")):
                k.setdefault("launches_by_path", {})[
                    "serving_remainder"] = remainder[key]
            for k, n_resume, n_dots in zip(
                    (kernels[0], kernels[2], kernels[3]), resume, dots):
                k.setdefault("launches_by_path", {}).update(
                    training_resumed=n_resume, training_remat_dots=n_dots)
            torch.cuda.empty_cache()
            plane = phase_data_plane(torch, state, direct5, smi)
            for k, key in ((kernels[0], "K1"), (kernels[1], "K2"),
                           (kernels[5], "K5"), (kernels[6], "K6")):
                k["launches_by_path"]["data_plane"] = plane[key]
            torch.cuda.empty_cache()
            control = phase_control_plane(torch, state, direct5, plane, smi)
            for k, key in ((kernels[0], "K1"), (kernels[1], "K2"),
                           (kernels[5], "K5"), (kernels[6], "K6")):
                k["launches_by_path"]["control_plane"] = control[key]
            torch.cuda.empty_cache()
            files = phase_files_and_sets(torch, state, smi)
            for k, n in zip((kernels[0], kernels[2], kernels[3]), files):
                k["launches_by_path"]["training_from_files"] = n
            torch.cuda.empty_cache()
            import tempfile

            with tempfile.TemporaryDirectory(prefix="zoo_mr_") as tmp:
                multi, rank_shapes = phase_multi_rank(torch, smi, tmp)
            for k, n in zip((kernels[0], kernels[2], kernels[3]), multi):
                k["launches_by_path"]["multi_rank"] = n
                k["multi_rank_shapes"] = rank_shapes
            del state
            torch.cuda.empty_cache()
            with tempfile.TemporaryDirectory(prefix="zoo_an_") as tmp:
                analysis = phase_analysis_isolated(smi, tmp)
            for k, key in zip(kernels, ("K1", "K2", "K3", "K4", "sampler",
                                        "K5", "K6")):
                k.setdefault("launches_by_path", {})["analysis"] = \
                    analysis[key]
            torch.cuda.empty_cache()
            layers = phase_layers(torch, smi)
            kernels[5]["launches_by_path"]["mobilenet_predict"] = \
                layers["K5"]
            kernels[5]["mobilenet_head"] = layers["k5_head"]
            kernels[6]["launches_by_path"]["mobilenet_predict"] = \
                layers["K6"]
            kernels[6]["mobilenet_shapes"] = layers["k6_shapes"]
        for k in kernels:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                        "max_abs_err"):
                if k[key] is None and key == "library_ms":
                    continue
                if not math.isfinite(k[key]):
                    raise AssertionError(f"{k['name']}: {key} not finite")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
