#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmt_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py          # from the repository root, one card
  python3 chip_smoke.py --fp32   # the fp32 path alone (``fp32_main``)

Phases, each of which raises (exit code 1, no final line) on failure:

1. Build the CUDA kernels from mmt_tpu_torch/csrc/ with nvcc (sm_90a),
   one nvcc process per source, all at once; then the host libraries of
   the loader's native path (mmt_tpu_torch/native/assembler.cc and
   wordpiece.cc) with $CXX (default g++).
2. Kernel phase: each eval kernel against its plain PyTorch version on
   the card, at the flagship eval shapes (FFN block: video 10,900 x 512
   and text 1,500 x 768 rows with I = 3072, bf16 and fp32, plus a ragged
   row count, and in bf16 a width off the GEMM route, 1,013 x 192 with
   I = 768, which keeps the WMMA kernel; and in bf16 the train CLI's
   eval rows, b32 and its last batch of 8, whole (phase 11) and a DP
   rank's half (phase 14); similarity: 1000 x 1000 with
   M = 7, D = 512, plus a ragged
   37 x 53 case with all-zero weight rows), with the max abs error and
   both times.  Tolerances: FFN fp32 atol 1e-4; FFN bf16 atol 3e-2 and
   mean abs error <= 2e-3; similarity atol 1e-5.  The fp32 cases take the
   fp32 route (the SIMT GEMMs of csrc/ffn_sgemm.cuh), held also to the FMA
   kernel (``tile=-1``, atol 1e-4), every fp32 row tile bitwise equal,
   with their device time, the FMA kernel's time and the fp32 bound.  The bf16 FFN block
   takes the TMA + wgmma GEMM route at these widths: its device time
   under torch.profiler (``device_ms``: the event time of a call under
   ~0.1 ms is the host's) and achieved TFLOP/s,
   the time of its two bf16 ``torch.mm`` products alone (``gemms_ms``, a
   yardstick that does less work), its wrapper's host time a call
   (``host_ms``), every row tile of the route bitwise equal at the video
   and text shapes, and at the video shape the block under autograd
   (kernel forward, the vjp of ``ffn_block_ref``, the XLA reference's
   numerics) against the exact fp64 gradients: each within 2e-2 relative
   L2 (plain autograd's printed beside it).  The similarity also
   through every tile shape it is built for, whose outputs must be
   bitwise equal (and an unknown tile id refused); with K = 3,586 (no
   multiple of 4 or of the slice depth) at 1e-5; and timed at the train
   step's 32 x 32.
3. Rank-kernel phase: the fused similarity-and-rank kernel (B5) against
   its plain version, each case in the t2v and the v2t orientation: (a)
   50,000 x 50,000 unit-norm random embeddings (M = 7, D = 512) with
   all-zero weight rows; (b) 2,000 captions x 1,000 videos with masked
   caption slots, one video with every slot masked and 24 padding
   videos; (c) exact arithmetic with duplicated rows.  Tolerance: the
   same inf positions, every rank within 1, and where there are at least
   10,000 queries on fewer than 1e-3 of them; per call, every query's
   counts may differ only by candidates whose fp64 similarity lies within
   twice the fp32 sum-order noise of the GT (check_counts_witness); (c)
   equal counts with a tie counted.  In (b) and (c)
   the counts must also equal, as integers and in every tile shape, the
   counts taken from the similarity kernel's own matrix (B5 compares
   bitwise B4's values); and one call with K = 3,586 against both.
   Kernel, plain and fp32 torch.mm (numerator only) times and the bound
   of each.
4. Train-kernel phase: the FFN train forward (B2) and backward (B3,
   add_dz on and off) against their plain versions at the b32 train
   shapes (video 6,976 x 512, text 960 x 768, ragged 1,013 x 768, I =
   3072), bf16 and fp32 (fp32 also at b128's 27,904 x 512 and 3,840 x
   768), masks at p = 0.1 from a seeded generator.
   Tolerances: fp32 atol 1e-4 on every output; bf16 fp32 outputs max 3e-2
   and mean 2e-3; bf16 compute-dtype outputs within 2 bf16 ulps of the
   plain version's (the ulp of the larger of the two magnitudes) plus an
   absolute floor for values near zero (CD_ATOL below).  In bf16 these
   widths take the TMA + wgmma GEMM route: its outputs also against the
   WMMA kernel's (``tile=-1``) by the same rules, every row tile bitwise
   equal, and beside the event and plain times its ``device_ms``, the
   WMMA kernel's event and device times, ``host_ms`` and ``gemms_ms``.
   In fp32 they take the fp32 route: against the FMA kernel
   (``tile=-1``) by the same rules, every fp32 row tile bitwise equal, and
   the device time beside the FMA kernel's and the fp32 bound.
5. Reference phase: a tiny fp32 CENet on the card (kernels) against the
   same weights on the CPU (plain versions), sims atol 1e-4.
6. Slice phase (then a profile phase): the full-width flagship CENet
   (bf16, random weights from
   a seed, ``bench.staged_flagship``) embeds 1000 captions and 1000 videos
   in 20 chunks of 50, builds the 1k x 1k similarity and ranks it.  The
   launch counters must read exactly 16 x 20 = 320 FFN launches and at
   least one similarity launch; every output must be finite; the same
   eval with the plain versions must give sims within 2e-2.  Then the
   eval's wall time on both paths, median of 5 runs after a warm-up,
   taken in turns.  The profile phase is ``python -m
   mmt_tpu_torch.profile_eval --mode eval --reps 1`` (its ``main``): the
   same eval built again from its seeds, one run under torch.profiler; it
   launches exactly 320 B1 and 1 B4, and the profiler recorded each
   family's kernels as often (else the session is run again, then the
   run fails); the rows sum to the device total, the idle share lies in
   [0, 1]; the top device activities, the rollup by category, and B1's
   kernels in situ against their kernel-phase time alone times the
   launches.
7. At-scale phase: the same model and videos through bench.py's
   streaming protocol at 10,000 videos (10 salted passes of 1000 in
   chunks of 50; 20,000 until the run's time grew near its limit) and
   the fused eval (``retrieval_eval(fused=True)``, no [Q, V] matrix).
   Exactly 16 x 200 = 3,200 FFN, 0 similarity and 2 rank kernel
   launches; finite metrics; on the same embeddings the kernel
   path's ranks against the plain path's (the rule of phase 3) and
   against the matrix path's (B4 and the matrix ranks), which may differ
   only by the candidates that lie between the two paths' GT values (the
   fused path computes the GT similarity directly); the peak device
   memory of both rankings; B5's time at 10k; the fused eval's wall time
   on both paths, AT_SCALE_TURNS (1, a depth cut from 3) after a warm-up,
   taken in turns.
8. Train-step phase: the full-width flagship in bf16, b32, Adam (lr
   5e-5) on the max-margin loss (margin 0.05, fix_norm).  One step must
   launch exactly 16 B2, 16 B3, >= 1 similarity and 0 eval FFN kernels;
   from the same state and generator seed the plain path's loss and
   gradients must agree (loss within 1e-4 absolute, all gradients
   within 2e-2 relative L2, every parameter's within 0.2, see STEP_*_TOL
   below); 20 steps on one batch must give finite losses and move the
   BatchNorm running statistics.  Then the step time on both paths, b32
   and b128, median of 10 after 3 warm-ups, taken in turns.  The train
   profile phase then runs, at b32, ``python -m mmt_tpu_torch.profile_eval
   --mode train --steps 3`` (bench's b32 step) and, at b128, 3
   kernel-path steps of this phase under ``profile_eval.session``: a
   step launches exactly 16 B2, 16 B3 and 1 B4, recorded as often; device
   time, the device's idle share of the wall, the rollup, B2's and B3's
   kernels in situ against their device time alone times the launches,
   and the top device operations.  Then the step-graph phase, in fp32 and
   in bf16: 5 steps of the full-width flagship at b32 (dropout on, the
   rate changing each step) replayed as one CUDA graph by
   ``train_step`` against the same 5 steps eager, with Adam made
   capturable (and, in fp32, as built); bitwise equal, or the loss
   within 3e-5 relative and each parameter's change within 4e-4 (the b32
   train cells' limits); 1 capture, 4 replays and 1 warm-up, and 16 B2,
   16 B3 and 1 B4 a step on the launch counters either way.
9. Partial-kernel phase: the tensor-parallel halves B6 (eval, video
   10,900 x 512 and text 1,500 x 768 rows, and 1,013 x 192 off the GEMM
   route) and B7 (train forward, video
   6,976 x 512 and text 960 x 768 rows), each also at a ragged 1,013 x
   768, and B3 with add_dz off on B7's residuals, all at I/mp = 1536,
   bf16 and fp32, against their plain versions (B6, B7 and B3 in bf16
   also with their device time, B6's and B7's also by kernel, and, at
   the video and text shapes, every
   row tile bitwise equal, as phases 2 and 4; B6 with ``gemms_ms``).  On
   the GEMM route B7 and B3 also against their WMMA kernels
   (``tile=-1``, the same rules; their event and device times), B7 with
   ``host_ms``, and B7's partial bitwise equal to B6's on the same
   inputs in every row tile.  A
   partial is not normalised, so the rules of phase 4 hold on its fp32
   outputs divided by the plain version's largest magnitude; the
   compute-dtype outputs keep phase 4's ulp rule.  In fp32 B6, B7 and B3
   take the fp32 route: B6 bitwise equal to the FMA kernel, B7 and B3
   against theirs by those rules, B7 bitwise B6 in every fp32 row tile.
10. Tensor-parallel phase: ``parallel.spawn`` starts two ranks that
   share the card over gloo (NCCL refuses two ranks on one device).
   Each builds the flagship from the same seed and keeps its shards.
   The 1k x 1k eval of phase 6: exactly 320 B6 and 0 B1 launches per
   rank, both ranks' sims bitwise equal, within TP_SIMS_TOL (5e-3) of
   phase 6's kernel path, and its ranks against phase 6's
   (check_tp_ranks).  The b32 step
   of phase 8 from its state, batch and dropout seed: exactly 16 B7, 16
   B3 and 0 B1/B2/B6 launches per rank, the loss and the gathered
   gradients within phase 8's tolerances of its kernel step; after 3
   steps every replicated parameter and buffer bitwise equal on both
   ranks.  Wall times (the counted eval, the 2 later steps) are of two
   gloo ranks sharing one card: a correctness path, no claim of speed.
   A failing rank fails the run.
11. Train-CLI phase: ``mmt_tpu_torch.cli`` (the port of train.py) trains
   the flagship config (bf16, b32, the loaders' own num_workers) on a
   synthetic MSRVTT cut-c corpus written by the port's
   ``synthetic.generate`` at the flagship's 7 experts and widths (1,000
   train and 32 val videos, up to 30 feature rows, 3 captions; the
   vocab padded to bert-base-cased's 28,996 entries) through the real
   loader and its CUDA prefetch: 2 epochs of 8 steps with a continuous
   eval of the 1,000 train videos after each (and before the first), a
   restart to 3 epochs, then ``--only_eval --resume`` on the plain
   versions.  Launches exactly 16 B1 per eval batch, 16 B2 and 16 B3 per
   step, one B4 per step and per eval; n_steps 16 then 24; finite
   epoch losses; the checkpoints and artifacts written; the final sims
   within 2e-2 of the plain versions'.  Prints the loop's median
   data-loading, step and total ms (the trainer's timers) against phase
   8's staged b32 step, and each 1,000-video eval's embed / similarity
   / metrics seconds and videos/s against phase 6's staged eval-1k.
   The loader runs its default, native path (the C++ assembler and
   WordPiece fast path): before the runs, one train and one eval batch
   from the same seed (``num_workers=0``) must be bitwise equal on the
   native and the Python path; after them the loop's data loading,
   window mean and median step and eval-1k through the loader are
   printed beside run D, the recorded Python-path run (PERF.md, RUN_D
   below).  The 2-epoch run is
   made twice more, its continuous evals on the 32 val videos, launches
   counted as above: on the Python path
   (``MMT_TPU_NATIVE_ASSEMBLY=0``, ``MMT_TPU_DISABLE_NATIVE=1``) and on
   the native path with ``"async_checkpoint": false``; each run's
   tokenizer must have taken only its own path.  The three runs' loop
   numbers (epoch 2's first three steps among them) are printed side by
   side, with native / Python in this call.
   (d) The pretrained text-tower init: a synthetic asset under HF
   BertForPreTraining names at bert-base-cased's geometry (197 tensors,
   107,719,680 parameters, 431 MB fp32, plus the pooler, position_ids and
   cls.* heads to drop), written as pytorch_model.bin and converted by
   ``python -m mmt_tpu_torch.hf_bert``; then through ``cli.main`` on the
   phase's corpus and config: ``--only_eval --txt_bert_init`` (every
   txt_bert parameter bitwise the asset's; 16 B1 per eval batch, 1 B4),
   one epoch of 2 steps from the init, its continuous evals on the 32
   val videos (finite losses; launches as counted above),
   and ``--only_eval --load_checkpoint <that run's checkpoint>
   --txt_bert_init <a zero asset>`` (every entry the checkpoint's: the
   checkpoint wins).  Prints the asset's load and merge seconds.
   (e) Before the CLI runs, on the card's host alone:
   ``mmt_tpu_torch.bench_loader``'s protocol (the flagship's 7 experts
   at their widths, b32, 30 of up to 40 rows, 200 videos): train and
   eval samples/s at 0, 1, 2 and 8 workers, Python and native path,
   cold and warm record cache (warm over 6 batches after 3, under a
   third of the command's default depth); the tokenizer's texts/s on the corpus's
   captions and on serving's query strings (native ids equal to the
   Python path's); the host's cores and thread pools.
12. Serve phase, in three parts.  (a) Before phase 11's directory is
   removed, ``mmt_tpu_torch.serve.main`` on its trained_model.pth and
   config: --build_index over the eval set (32 videos) with 4 --query
   captions, exact, then --quantize int8 from the saved .npz index;
   launches exactly 4 B1 per video batch of the build, and 12 B1 and 0
   B4 per query batch, exact or int8 (since C7 the exact engine scores
   through the library route, ``prefer_kernel=False``, as the JAX engine
   does); the hits well-formed (ids of the index, ``topk`` of them,
   scores not increasing).  (b) The full-width flagship (bf16, random weights from
   a seed) serving a synthetic index of 100,000 videos x 7 x 512
   (L2-normalised rows, L1 weights; 1.43 GB fp32, 0.36 GB int8), exact
   then int8: the launch counts of a query batch of 1 and of 64; on the
   exact engine the kernel path's top-10 of 64 queries against the
   plain versions' (scores within 2e-2; an id in one top-10 only must
   have a plain score within 2e-2 of the plain 10th); ``serve_http``
   traffic through ``mmt_tpu_torch.bench_serving.measure`` (phase 16
   (c): the command's protocol and ``synthetic_index``; the tokenizer
   over SERVE_WORDS, its traffic's words and four more), interactive
   (200 GETs of 1 query, topk 5) and
   bulk (50 POSTs of 64, topk 10) on one fresh, warmed server: the
   client's percentiles and the server's /statz; one query batch of 1
   and of 64 under
   torch.profiler (wall, device time, idle share, split into B1, B4,
   B4's k-major scratch fill, the top-k and the rest); int8's overlap@10
   with exact; the pinned int8 rule of tests/test_serving.py (R@1/5/10
   identical, top-1 identical on >= 99%, overlap@10 >= 0.95, top-k score
   MAE <= 1e-3) through ``python -m mmt_tpu_torch.int8_quality`` (its
   ``main``) on its planted corpus (512 x 64), and all of it but R@K
   equality on the 10,000 x 1,000 one (the command's default).  (c) B1 at the serving text rows
   (30 and 1,920 x 768; phase 1's bf16 rules, both row tiles bitwise
   equal) and B4 at [1, 1,000], [1, 100,000] and [64, 100,000] (1e-5;
   with its scratch fill's device time) against their plain versions,
   in CUDA-event and device ms, B4 beside the fp32 ``torch.mm`` of its
   numerator; these are the ``serving_shapes`` of the ``ffn_block`` and
   ``moe_similarity`` entries of the kernel line, whose
   ``serving_launches`` are (a)'s counts.
13. Matrix phase (run in phase 11's scope, after 12 (a), on its corpus):
   three configs through ``cli.main`` at the flagship widths, bf16,
   b32, one epoch of 8 steps and the evals on the 32 val videos: (a)
   bertfrz4 over bertftn input, ordr, mnp, vid_wgh emb, Ranger (k 6);
   (b) collaborative gating (vid_inp agg, vid_wgh nrm), bertftnmxp, gem,
   missing modalities dropped; (c) wo2vfrz word vectors (a seeded
   300-wide word2vec text file over the corpus's words) into NetVLAD.
   Each: its first step on the kernel path against the plain path from
   the same weights, batch and dropout seed (phase 8's tolerances; the
   plain path takes the kernel path's max-pool routing, and the share
   of maxima the rounding reorders is printed); the launches of the
   counted run exactly (per step 16 / 12 / 4 B2 and B3 and 1 B4; per
   eval batch 16 / 12 / 4 B1 and per eval 1 B4); the frozen parameters
   bitwise unmoved and without a gradient ((c): the word table the
   file's, rows 0-1 zero); a line with the median step ms, the final
   eval's seconds and the launches.  The launches are the
   ``matrix_launches`` of the kernel line's B1, B2, B3 and B4 entries.
14. Data-parallel phase: two ranks share the card over gloo (a
   correctness path at full width: its times are printed with no claim
   of speed).  (a) After the tensor-parallel phase: B2 and B3 at a rank's
   rows of the b32 step (3,488 x 512 and 480 x 768, bf16) against their
   plain versions by phase 4's rules; then ``parallel.spawn`` starts the
   ranks, each with phase 8's state, batch (its 16 rows) and dropout
   seed: exactly 16 B2, 16 B3, 1 B4 and no other launch per rank; the
   loss and the summed gradients within phase 8's tolerances of its
   kernel step; after 3 steps every parameter and buffer bitwise equal
   on both ranks; the step's wall, one gloo all-reduce of the gradient
   buffer and the gathers of its outputs.  (b) In the same ranks: seeded
   fp32 embeddings of 20,001 videos x 2 captions x 7 x 512 (one pad
   video), every rank holding them on the host, each counting its
   candidate shard with B5 (1 + 2 launches) and all-reducing the counts:
   the t2v and v2t ranks equal to the single-process kernel ranks on the
   same embeddings (else the first differing query's similarities from
   both tiles are printed); each rank's B5 counts against the plain
   version on its staged shard by phase 3's rules; each B5 call's ms.
   (c) In phase 11's scope, after phase 13, on its corpus and config at
   one epoch of 4 b32 steps, the continuous eval of the 32 val videos
   fused and no epoch-0 checkpoint: two ``mmt_tpu_torch.train``
   processes over the MMT_TPU_* variables (``dp_cli_rank``; the shipped
   loader workers, which the group runs at 0) against ``cli.main`` in
   one process (0 workers): per rank and in the one process exactly 16
   x 3 B1, 64 B2 and B3, 5 B4 and 4 B5; the continuous eval
   host-staged; every host
   batch of both ranks the one process's (``recorded_run``'s digests);
   the step losses the same on both ranks, step 1's within phase 8's
   1e-4 of the one process's, every step's gap printed; the epoch loss
   within 1e-3 relative and the final sims within 2e-2 of the one
   process's; one set of artifacts (rank 1's log.p1.txt beside them).
   B1 at a rank's eval rows is held to its plain version in phase 2.
   The launches per rank of (a), (b) and (c) are the ``dp_launches`` of
   the B1-B5 entries.
15. Model-parallel phase, in two parts.  (a) After phase 12 (b), on its
   100,000-video index and model: ``RetrievalEngine(mesh=[card] * 3)``
   (the rows padded to 100,002 and split in three) exact then int8,
   against the unsharded engine: exactly 12 B1 and 0 B4 a query batch
   (C7); for 1 query (topk 5) and 64 (topk 10) the video
   ids equal, the scores within 1e-5 (exact) / 1e-4 (int8), no pad row;
   the int8 shards' codes and scales bitwise the unsharded engine's; the
   p50 of 10 direct searches, sharded and unsharded (no claim of speed).
   Phase 12 (c) also times B4 at the shard shapes [1, 33,334] and [64,
   33,334].  (b) In phase 11's scope after phase 14 (c), on its corpus
   and config with ``model_parallel`` 2: two ``mmt_tpu_torch.train``
   processes (1 data x 2 model ranks, gloo, the card shared) for one
   epoch of 4 b32 steps and the fused, host-staged continuous eval of
   the 32 val videos: per rank exactly 64 B7, 64 B3 (add_dz off), 16 x
   3 B6, 5 B4, 4 B5 and no B1 / B2; every host batch and step 1's
   loss (1e-4) against phase 14 (c)'s one-process run, every later
   step's gap printed, the epoch loss within 1e-2 relative (a bound on
   divergence: TP's bf16 gradients take other roundings, which Adam
   amplifies) and the final sims within 2e-2 of it; the trained_model.pth
   with the one process's entries and shapes; then ``--only_eval
   --load_checkpoint`` of that file in this one process (16 B1, 1 B4)
   within TP_SIMS_TOL of the TP run's final sims; last an fp32 witness,
   the epoch's first 2 steps (no continuous eval) in float32 (the
   kernels' fp32 route) by two TP processes and by one: every host batch equal, every step's loss and
   the epoch loss within 1e-5 relative, the final sims within 1e-4.  The launches are the ``sharded_serving_launches`` of the B1
   and B4 entries and the ``tp_cli_launches`` of every entry.

16. Measurement-command phase, in three parts, after phase 12 (c): the
   port's commands (``python -m mmt_tpu_torch.<name>``) run in this
   process through their own functions.  (a) ``bench_geometry`` at the
   ActivityNet and HowTo100M geometries (2 experts; L 100 and 30; eval
   chunks of 25 and 50 over 1,000 videos; train b32 and b64), bf16, full
   width: ``run_geometry``'s whole run counted exactly (an eval 16 x 40
   = 640 or 16 x 20 = 320 B1 and 1 B4; a step 16 B2, 16 B3 and 1 B4) and
   its line printed; then one eval and one step, each counted in a
   window of its own, the eval's sims kernel vs plain within 2e-2, the
   step's loss and gradients against the plain path by ``check_step``'s
   rules; B1 at each eval's rows (5,075 and 3,150 x 512,
   2,500 and 1,500 x 768), B2 and B3 at each step's (6,496 and 4,032 x
   512, 3,200 and 1,920 x 768) by phases 1's and 4's rules, B4 at 1,000
   x 1,000 and the step's 32 x 32 / 64 x 64 with K 1,024 (1e-5), each
   with its device ms, plain ms and bound (B4 also its fp32 ``torch.mm``):
   the ``geometry_shapes`` and ``geometry_launches`` (the three windows'
   counts) of the B1-B4 entries.  (b) ``bench_sustained.run`` at b32 and b128 (1,024 samples
   each) and b32 with --prestage 4: exactly 16 B2, 16 B3 and 1 B4 a step
   (warm, timed and bare steps), no B1; each line printed, the b32 step
   beside phase 8's staged step and phase 11's window.  (c) Phase 12
   (b)'s HTTP traffic is ``bench_serving.measure``.
17. Bench-settings phase: ``python -m mmt_tpu_torch.bench`` (its
   ``main``) with BENCH_DTYPE=fp32, BENCH_TRAIN_BATCH=128 and
   BENCH_TRAIN_OPT=Ranger, its depth cut to 200 videos in 4 chunks and
   one timed eval: the line's keys; the run's launches exactly (16 B1 a
   chunk of each eval, 16 B2, 16 B3 and 1 B4 a step, 1 B4 an eval); B1
   on the fp32 route (one eval under torch.profiler: only the route's
   kernels); the
   fp32 eval's sims within 1e-4 of the plain path's and its ranks by
   phase 3's rule; B2 and B3 at b128's 27,904 x 512 and 3,840 x 768 by
   phase 4's rules with their times and bound (the ``b128_shapes`` of
   their entries; phase 2's fp32 B1 cases are ``ffn_block``'s
   ``fp32_shapes``).
18. Shipped-config phase (in phase 11's scope, after phase 15 (b), on
   its corpus): ``cli.main`` on configs/eccv20/msrvtt_jsfusion_trainval
   .json as shipped, its compute dtype unset (fp32), only the data,
   splits, epochs and save_dir changed: one epoch of 4 b32 steps and the
   final eval of the 32 val videos.  Exactly 16 B2 and 16 B3 a step, 16
   B1 an eval batch, 1 B4 a step and for the eval; every FFN call on the
   fp32 route (0 on the FMA kernels, from the tile ids the wrappers pass
   C); the model in fp32; finite losses.  Prints the step median and the
   eval's seconds: the ``fp32_cli_launches`` of the B1-B4 entries.
19. User-expert and switches phase (in phase 11's scope, after phase
   18): ``register_expert(ExpertSpec("user_clip", 512, 10,
   feat_width=1.0))`` and its tables drawn by ``data/synthetic.py`` for
   phase 11's videos.  (a) ``cli.main`` on the flagship config (bf16)
   with user_clip as an eighth expert, one epoch of 4 b32 steps and the
   final eval of the 32 val videos: a video sequence of 1 + 8 x 31 = 249
   tokens, ``CENet.video_seq_len`` equal to every sequence the video
   tower took; exactly 16 B2 and 16 B3 a step, 16 B1 an eval batch, 1 B4
   a step and for the eval; the first step's loss and gradients against
   the plain path by ``check_step``'s rules; the step median and the
   eval's seconds; B1 at 7,968 and 12,450 x 512, B2 and B3 at 7,968 x 512
   and B4 at 32 x 32 with K 4,096 against their plain versions, with
   device ms, plain ms and bound (the ``user_expert_shapes`` and
   ``user_expert_cli_launches`` of the B1-B4 entries).  (b) The kernel
   switches: the same CLI for 2 steps (the train loader at 0 workers, so
   that the runs draw the same batches) and the final eval under
   MMT_TPU_PALLAS_FFN=0, under MMT_TPU_PALLAS_SIMILARITY=0 and with both
   unset: exactly the switched family at 0 launches, the other at its
   count; the first steps' losses within 1e-4 of the unswitched run's;
   B5 on its kernel under the similarity switch; ``serve.main`` (an index
   build and one query batch) under MMT_TPU_PALLAS_FFN=0 with 0 B1
   launches (the ``switch_launches`` of the entries).

``--fp32`` runs B1, B2 and B3 in fp32 at the flagship's shapes as the
tree's wrappers route them, then phase 18 without its route check: run
from the roots of two trees (one a ``git archive`` of the other's
parent) in one call, it compares them on one card.

Each phase prints its seconds, and the run its total.  The last two
lines of stdout are one JSON object of kernel results (each kernel's
launches on its main path, worst disagreement, times, bound and library
time) and {"ok": true, "device": {...}}; the card's name and power limit
come on the line before them.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

from mmt_tpu_torch.profile_eval import (PROFILE_TRIES, device_events,
                                        short_kernel_name)

N_VIDEOS, CHUNK = 1000, 50
TEXT_LAYERS, VIDEO_LAYERS = 12, 4   # one FFN block each
FFN_LAYERS = TEXT_LAYERS + VIDEO_LAYERS


def time_ms(torch, fn, reps=20):
  """Mean device time of one call, from CUDA events around ``reps``
  calls after one warm-up call."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def device_split(torch, fn, reps=20):
  """{device activity: its device ms in one call} under torch.profiler
  over ``reps`` calls after a warm-up: each activity's mean time times the
  number of times one call runs it (its count over ``reps``, at least 1).

  On the H100 a session now and then misses device activities: the last
  one of the session (counts such as [20, 20, 20, 19] over 20 calls), or,
  late in a long process, all but those of the first call or two.  The
  mean of the activities recorded is kept whole by that; a sum over the
  session divided by ``reps`` would read low.  A session that recorded no
  device activity at all is run again, up to PROFILE_TRIES times; then
  this raises."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  for _ in range(PROFILE_TRIES):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    events = device_events(prof)
    if events:
      return {e.key: e.self_device_time_total / 1e3 / e.count
              * max(1, round(e.count / reps)) for e in events}
    print("  profiler session recorded no device activity: run again",
          flush=True)
  raise RuntimeError(f"the profiler recorded no device activity in "
                     f"{PROFILE_TRIES} sessions")


def device_ms(torch, fn, reps=20):
  """Mean device time of one call: its kernels' own time under
  torch.profiler over ``reps`` calls after a warm-up.  Unlike
  ``time_ms`` it leaves out the gaps in which the device waits for the
  host, which set the event time of calls that take under ~0.1 ms."""
  return sum(device_split(torch, fn, reps).values())


class CardSampler:
  """While open, nvidia-smi samples the card's SM clock (MHz) and power
  draw (W) every 20 ms; ``summary()`` after.  The card lowers its clock
  under load when it reaches its power limit, which a kernel timed alone
  for a few milliseconds does not show."""

  def __enter__(self):
    self.proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    return self

  def __exit__(self, *exc):
    self.proc.terminate()
    out = self.proc.communicate(timeout=30)[0]
    self.samples = []
    for line in out.splitlines():
      try:
        clock, power = (float(v) for v in line.split(","))
      except ValueError:
        continue
      self.samples.append((clock, power))

  def summary(self):
    if not self.samples:
      return "SM clock and power draw: no samples"
    clocks, powers = zip(*self.samples)
    return (f"SM clock median {statistics.median(clocks):.0f} MHz (min "
            f"{min(clocks):.0f}, max {max(clocks):.0f}), power draw median "
            f"{statistics.median(powers):.1f} W (max {max(powers):.1f}) over "
            f"{len(self.samples)} samples")


# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): bf16 tensor
# cores, fp32 FMA outside the tensor cores, device memory.
H100_BF16, H100_FP32, H100_BYTES = 989e12, 67e12, 3.35e12


def bound(flops, rate, tensors):
  """(ms, what sets it): the least time of the work on the H100, the
  larger of its FLOPs at ``rate`` and its bytes (each tensor read or
  written once) at the memory rate."""
  nbytes = sum(t.numel() * t.element_size() for t in tensors)
  ops_ms, bytes_ms = flops / rate * 1e3, nbytes / H100_BYTES * 1e3
  return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                            "bytes")


def tflops(r, h, i, ms):
  """Achieved TFLOP/s of the block's two products (4 R H I FLOP)."""
  return 4 * r * h * i / ms / 1e9


def gemms_ms(torch, x, w1, w2):
  """Yardstick: the two bf16 ``torch.mm`` products of the block alone
  (no bias, GELU, residual or LayerNorm; the port never calls them)."""
  xb = x.to(torch.bfloat16)
  g = torch.randn(x.shape[0], w1.shape[0], device=x.device).to(
      torch.bfloat16)
  return time_ms(torch, lambda: (torch.mm(xb, w1.T), torch.mm(g, w2.T)))


def as_tuple(out):
  return out if isinstance(out, tuple) else (out,)


def route_tiles(torch, ffn, cd):
  """The row tiles of the route of compute type ``cd``: the bf16 GEMM
  route's or the fp32 route's."""
  return ffn.F32_TILES if cd == torch.float32 else ffn.GEMM_TILES


def on_route(torch, ffn, h, i, cd):
  """True if calls at widths H, I in ``cd`` take a route (bf16's TMA +
  wgmma GEMM route, or the fp32 route), not the WMMA / FMA kernel."""
  return ffn.gemm_route(h, i, cd) or ffn.f32_route(h, i, cd)


def route_label(torch, ffn, r, h, i, cd, dev):
  """The route a call at R x H, I in ``cd`` takes, with its row tile."""
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  if ffn.gemm_route(h, i, cd):
    return f"gemm, {ffn.GEMM_TILES[ffn.pick_gemm_tile(r, h, sms)]}-row tile"
  if ffn.f32_route(h, i, cd):
    return f"f32, {ffn.F32_TILES[ffn.pick_f32_tile(r, h, i, sms)]}-row tile"
  return "wmma/fma"


def check_tiles_equal(torch, ffn, what, kernel, args, kw):
  """Every row tile of the route of the call's compute type gives the
  same bits (the same wgmma chain, or the same fmaf chain, over K) in
  every output; prints each tile's time.  Raises otherwise."""
  tiles = route_tiles(torch, ffn, kw["compute_dtype"])
  outs = [as_tuple(kernel(*args, **kw, tile=t)) for t in range(len(tiles))]
  same = [all(map(torch.equal, outs[0], o)) for o in outs]
  by_tile = {rows: round(time_ms(torch, lambda t=t: kernel(*args, **kw,
                                                           tile=t)), 4)
             for t, rows in enumerate(tiles)}
  print(f"  {what} row tiles {tiles}: outputs bitwise equal {same};"
        f" kernel_ms by tile {by_tile}", flush=True)
  if not all(same):
    raise RuntimeError(f"{what}: a row tile changed the values")


# The FMA kernels (``tile=-1`` at an fp32 route width) are the fp32
# route's witness and what it replaced on the path: their CUDA-event time
# over FMA_REPS calls (each takes milliseconds, so the events time the
# device).
FMA_REPS = 5


# The eval block's gradients under autograd on the kernel path (the vjp of
# ffn_block_ref, the XLA reference's numerics: bias and GELU in bf16)
# against the exact gradient (fp64 autograd of the same math unrounded):
# each within 2e-2 relative L2, the train step's bf16 rule on all
# gradients (STEP_ALL_GRADS_TOL); measured ~5e-3 at 1,000 x 512 on a CPU.
FFN_GRAD_TOL = 2e-2
GRAD_NAMES = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")


def ffn_grad_check(torch, ops, ffn, x, w1, b1, w2, b2, gamma, beta):
  """B1 under autograd at this shape: the kernel launches once, the
  output has a graph, and the gradients of x, the fp32 master weights,
  b1, b2, gamma and beta lie within FFN_GRAD_TOL of the exact ones.
  Prints plain autograd's (bf16, fp32 bias and GELU) beside them."""
  masters = (x, w1.float(), b1, w2.float(), b2, gamma, beta)
  dy = torch.randn(x.shape, device=x.device)

  def run(dtype, cd, plain):
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in masters]
    xl, w1l, b1l, w2l, *rest = leaves
    with ops.plain_versions() if plain else contextlib.nullcontext():
      out = ffn.ffn_block(xl, w1l.to(cd), b1l, w2l.to(cd), *rest, eps=1e-12,
                          compute_dtype=cd)
      if out.grad_fn is None:
        raise RuntimeError("ffn_block under autograd returned no graph")
      return torch.autograd.grad((out * dy.to(dtype)).sum(), leaves)

  before = ffn.ffn_block_cuda.launches
  got = run(torch.float32, torch.bfloat16, False)
  if ffn.ffn_block_cuda.launches != before + 1:
    raise RuntimeError("ffn_block under autograd did not launch B1 once")
  exact = run(torch.float64, torch.float64, True)
  plain = run(torch.float32, torch.bfloat16, True)
  rel = lambda gs: {n: float((g.double() - e).norm() / e.norm())
                    for n, g, e in zip(GRAD_NAMES, gs, exact)}
  got_rel, plain_rel = rel(got), rel(plain)
  for what, r in (("kernel forward, ffn_block_ref's vjp", got_rel),
                  ("plain autograd, bf16", plain_rel)):
    print(f"  ffn_block under autograd ({what}) vs exact (fp64), gradients' "
          "relative L2: " + ", ".join(f"{n} {v:.3e}" for n, v in r.items()),
          flush=True)
  if not all(v <= FFN_GRAD_TOL for v in got_rel.values()):
    raise RuntimeError(f"ffn_block gradients outside {FFN_GRAD_TOL}: "
                       f"{got_rel}")


def host_ms(torch, fn, reps=50, rounds=5):
  """Host time of one call, as text: the median over ``rounds`` of the
  wall of queuing ``reps`` calls without waiting for the device (the
  queue is deep enough not to block), and the rounds' range (the host is
  shared, so one round can read half again as long as the next)."""
  fn()
  torch.cuda.synchronize()
  per_round = []
  for _ in range(rounds):
    tic = time.perf_counter()
    for _ in range(reps):
      fn()
    per_round.append((time.perf_counter() - tic) * 1e3 / reps)
    torch.cuda.synchronize()
  return (f"{statistics.median(per_round):.4f} (rounds {min(per_round):.4f}"
          f"-{max(per_round):.4f})")


def ffn_phase(torch, ops, ffn, dev, gen, card):
  """Each FFN case: kernel vs plain version, at the eval shapes of the
  staged eval-1k and of the train CLI's evals (phase 11, its ragged last
  batch included; and a DP rank's rows of them, phase 14); returns the kernel's line entries (the bf16 cases'
  worst error, and the video-shape bf16 times and bound: no single
  PyTorch call computes the block) and the bf16 kernel time of each
  (rows, H)."""
  cases = [(10900, 512, 3072, torch.bfloat16), (1500, 768, 3072,
                                                torch.bfloat16),
           (1013, 768, 3072, torch.bfloat16),
           (1013, 192, 768, torch.bfloat16),   # off the GEMM route: WMMA
           # The train CLI's evals (phase 11): b32 video and text, and the
           # last batch of 8 of 1,000 videos (64-row tile at H = 512).
           (6976, 512, 3072, torch.bfloat16), (960, 768, 3072,
                                               torch.bfloat16),
           (1744, 512, 3072, torch.bfloat16), (240, 768, 3072,
                                               torch.bfloat16),
           # The same evals under data parallelism (phase 14 (c)): a
           # rank's 16 of each b32 batch and 4 of the last batch of 8.
           (3488, 512, 3072, torch.bfloat16), (480, 768, 3072,
                                               torch.bfloat16),
           (872, 512, 3072, torch.bfloat16), (120, 768, 3072,
                                              torch.bfloat16),
           (10900, 512, 3072, torch.float32), (1500, 768, 3072,
                                               torch.float32),
           (1013, 768, 3072, torch.float32),
           # fp32's smallest calls, where pick_f32_tile takes the 32-row
           # tile: the text rows of an eval's last batch of 8 and of one
           # query.
           (240, 768, 3072, torch.float32), (30, 768, 3072, torch.float32)]
  res, alone = {"max_abs_err": 0.0, "library_ms": None}, {}
  for r, h, i, cd in cases:
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = rand(r, h)
    w1, w2 = (rand(i, h) * 0.02).to(cd), (rand(h, i) * 0.02).to(cd)
    b1, b2 = rand(i) * 0.02, rand(h) * 0.02
    gamma, beta = 1.0 + 0.1 * rand(h), 0.1 * rand(h)
    args = (x, w1, b1, w2, b2, gamma, beta)
    kw = dict(eps=1e-12, compute_dtype=cd)
    got = ffn.ffn_block_cuda(*args, **kw)
    want = ffn.ffn_block_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    ms = time_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw))
    plain_ms = time_ms(torch, lambda: ffn.ffn_block_plain(*args, **kw))
    name = str(cd).replace("torch.", "")
    route = route_label(torch, ffn, r, h, i, cd, dev)
    dev_ms = device_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw))
    print(f"ffn_block R={r} H={h} I={i} {name} ({route} route): max_abs_err="
          f"{max_err:.3e} mean_abs_err={mean_err:.3e} kernel_ms={ms:.4f} "
          f"({tflops(r, h, i, ms):.1f} TFLOP/s) device_ms={dev_ms:.4f} "
          f"({tflops(r, h, i, dev_ms):.1f} TFLOP/s) plain_ms={plain_ms:.4f}",
          flush=True)
    if not bool(torch.isfinite(got).all()):
      raise RuntimeError("ffn_block kernel produced non-finite values")
    if cd == torch.float32:
      if max_err > 1e-4:
        raise RuntimeError(f"ffn_block fp32 error {max_err} > 1e-4")
      # The fp32 route every shipped config's evals run (compute_dtype
      # unset), held to the FMA kernel it replaced by the same rule.
      if not ffn.f32_route(h, i, cd):
        raise RuntimeError(f"ffn_block fp32 at H={h}, I={i} is off the "
                           "fp32 route")
      fma = lambda: ffn.ffn_block_cuda(*args, **kw, tile=-1)
      fma_err = float((got - fma()).abs().max())
      fma_ms = time_ms(torch, fma, FMA_REPS)
      b_ms, b_by = bound(4 * r * h * i, H100_FP32, args + (got,))
      print(f"  vs FMA kernel max_abs_err={fma_err:.3e}; fma_ms={fma_ms:.4f} "
            f"({fma_ms / dev_ms:.2f}x the route's device time); bound "
            f"{b_ms:.4f} ms ({b_by}, fp32 at 67 TFLOP/s), share "
            f"{b_ms / dev_ms:.2%} card: {card}", flush=True)
      if fma_err > 1e-4:
        raise RuntimeError(f"ffn_block fp32 route vs FMA kernel {fma_err} "
                           "> 1e-4")
      if r != 1013:
        check_tiles_equal(torch, ffn, f"ffn_block R={r} H={h} fp32",
                          ffn.ffn_block_cuda, args, kw)
      res.setdefault("fp32_shapes", []).append(
          {"shape": f"{r} x {h}, I {i}", "route": route,
           "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
           "fma_ms": fma_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None})
    if cd == torch.bfloat16:
      if max_err > 3e-2 or mean_err > 2e-3:
        raise RuntimeError(f"ffn_block bf16 error {max_err}/{mean_err} "
                           "exceeds 3e-2 (max) / 2e-3 (mean)")
      res["max_abs_err"] = max(res["max_abs_err"], max_err)
      alone[(r, h)] = (ms, dev_ms)
      b_ms, b_by = bound(4 * r * h * i, H100_BF16, args + (got,))
      yard_ms = gemms_ms(torch, x, w1, w2)
      print(f"  bound {b_ms:.4f} ms ({b_by}); gemms_ms={yard_ms:.4f} (two "
            f"bf16 torch.mm alone, a yardstick of less work) card: {card}",
            flush=True)
      if ffn.gemm_route(h, i, cd) and r != 1013:
        check_tiles_equal(torch, ffn, f"ffn_block R={r} H={h}",
                          ffn.ffn_block_cuda, args, kw)
        call_ms = host_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw))
        print(f"  host_ms={call_ms} (the wrapper's host time a call: "
              "checks, scratch, tensor maps, 4 launches)", flush=True)
      if (r, h) == (10900, 512):
        res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        ffn_grad_check(torch, ops, ffn, *args)
  return res, alone


def sim_inputs(torch, q, v, m, d, dev, gen, zero_rows=False):
  """t [q, m * d], v [v, m * d] weight-scaled unit-norm rows and their
  weights tw [q, m], vw [v, m]."""
  te = torch.randn(q, m, d, generator=gen, device=dev)
  ve = torch.randn(v, m, d, generator=gen, device=dev)
  te, ve = te / te.norm(dim=-1, keepdim=True), ve / ve.norm(dim=-1,
                                                          keepdim=True)
  tw = torch.rand(q, m, generator=gen, device=dev)
  vw = torch.rand(v, m, generator=gen, device=dev)
  tw, vw = tw / tw.sum(-1, keepdim=True), vw / vw.sum(-1, keepdim=True)
  if zero_rows:
    tw[3] = 0.0
    vw[5] = 0.0
    vw[7] = 0.0
  return ((te * tw[:, :, None]).reshape(q, m * d),
          (ve * vw[:, :, None]).reshape(v, m * d), tw, vw)


def sim_phase(torch, similarity, dev, gen, card):
  """Similarity kernel vs plain version; returns the kernel's line
  entries: the worst error, and the 1000 x 1000 times, bound and
  library time (the fp32 ``torch.mm`` of the numerator alone, which
  computes less than the kernel)."""
  res = {"max_abs_err": 0.0}
  tiles = range(len(similarity.TILES))
  for q, v, m, d, zero_rows in ((1000, 1000, 7, 512, False),
                                (37, 53, 7, 512, True)):
    t, vv, tw, vw = sim_inputs(torch, q, v, m, d, dev, gen, zero_rows)
    got = similarity.sim_cuda(t, vv, tw, vw)
    want = similarity.sim_plain(t, vv, tw, vw)
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    ms = time_ms(torch, lambda: similarity.sim_cuda(t, vv, tw, vw))
    plain_ms = time_ms(torch, lambda: similarity.sim_plain(t, vv, tw, vw))
    print(f"moe_similarity Q={q} V={v} M={m} D={d}: max_abs_err="
          f"{max_err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
          flush=True)
    if not bool(torch.isfinite(got).all()) or max_err > 1e-5:
      raise RuntimeError(f"moe_similarity error {max_err} > 1e-5")
    res["max_abs_err"] = max(res["max_abs_err"], max_err)
    # Every tile shape computes the same fmaf chains: the same bits.
    same = [torch.equal(got, similarity.sim_cuda(t, vv, tw, vw, tile=i))
            for i in tiles]
    by_tile = {f"{r}x{c}": round(time_ms(
        torch, lambda i=i: similarity.sim_cuda(t, vv, tw, vw, tile=i)), 4)
               for i, (r, c) in enumerate(similarity.TILES)}
    print(f"  tile shapes {similarity.TILES}: outputs bitwise equal {same}; "
          f"kernel_ms by tile {by_tile}", flush=True)
    if not all(same):
      raise RuntimeError("moe_similarity: a tile shape changed the values")
    if q == 1000:
      lib_ms = time_ms(torch, lambda: torch.mm(t, vv.T))
      b_ms, b_by = bound(2 * q * v * m * (d + 1), H100_FP32,
                         (t, vv, tw, vw, got))
      res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bound_ms=b_ms, bound_by=b_by)
      print(f"  library (torch.mm numerator) {lib_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}) card: {card}", flush=True)
  try:
    similarity.sim_cuda(t, vv, tw, vw, tile=len(similarity.TILES))
  except RuntimeError as e:
    print(f"  unknown tile id refused: {e}", flush=True)
  else:
    raise RuntimeError("moe_similarity accepted an unknown tile id")

  # K = 3,586: no multiple of 4 or of the slice depth (the zero-filled tail).
  # These cases draw from a generator of their own: the phases after this
  # one keep the inputs they had before the cases were added.
  gen = torch.Generator(device=dev).manual_seed(2)
  t, vv, tw, vw = sim_inputs(torch, 130, 260, 2, 1793, dev, gen)
  want = similarity.sim_plain(t, vv, tw, vw)
  for i in tiles:
    err = float((similarity.sim_cuda(t, vv, tw, vw, tile=i) - want)
                .abs().max())
    print(f"moe_similarity Q=130 V=260 K={t.shape[1]} tile "
          f"{similarity.TILES[i]}: max_abs_err={err:.3e}", flush=True)
    if not err <= 1e-5:
      raise RuntimeError(f"moe_similarity K % 4 != 0 error {err} > 1e-5")
    res["max_abs_err"] = max(res["max_abs_err"], err)

  # The train step's shape: one block.
  t, vv, tw, vw = sim_inputs(torch, 32, 32, 7, 512, dev, gen)
  ms = time_ms(torch, lambda: similarity.sim_cuda(t, vv, tw, vw))
  plain_ms = time_ms(torch, lambda: similarity.sim_plain(t, vv, tw, vw))
  lib_ms = time_ms(torch, lambda: torch.mm(t, vv.T))
  b_ms, b_by = bound(2 * 32 * 32 * 7 * 513, H100_FP32,
                     (t, vv, tw, vw, similarity.sim_cuda(t, vv, tw, vw)))
  print(f"moe_similarity Q=32 V=32 M=7 D=512: kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.6f} ({b_by}) "
        f"card: {card}", flush=True)
  return res


TRAIN_SHAPES = ((6976, 512), (960, 768), (1013, 768))   # b32 video, text
# fp32 B2 and B3 also at b128's rows (the fp32 route's largest calls).
TRAIN_F32_B128_SHAPES = ((27904, 512), (3840, 768))
TRAIN_I, TRAIN_P = 3072, 0.1
# bf16 outputs in the compute dtype: within 2 bf16 ulps, plus an absolute
# floor for values near zero, where a small absolute difference is many
# ulps.  Before inter and dz are rounded, kernel and plain version differ
# only by fp32 sum order (tensor-core WMMA against cuBLAS, warp against
# torch reductions): 1e-5.  z and dinter come out of a second product
# whose operand (the GELU output, dffn) was rounded to bf16, and that
# sum-order noise flips such an operand by one ulp now and then; one flip
# moves a sum by ulp(operand) * |weight|, up to ~3e-3 here: 4e-3.
CD_ATOL = {"inter": 1e-5, "z": 4e-3, "dz": 1e-5, "dinter": 4e-3}


def bf16_ulp(torch, got, want):
  """Elementwise bf16 ulp at the larger of the two magnitudes."""
  ref = torch.maximum(got.float().abs(), want.float().abs())
  _, exp = torch.frexp(ref)
  return torch.ldexp(torch.ones_like(ref), exp - 8)


def check_outputs(torch, what, cd, got, want, cd_names):
  """Compare each named output with the plain version's; ``cd_names``
  are the compute-dtype outputs.  Returns the worst max abs error of the
  fp32 outputs.  Raises past the tolerance."""
  worst = 0.0
  for name in got:
    g, w = got[name], want[name]
    if not bool(torch.isfinite(g).all()):
      raise RuntimeError(f"{what}: non-finite {name}")
    err = (g.float() - w.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    msg = f"{name} max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e}"
    if cd == torch.float32:
      bad = max_err > 1e-4
    elif name in cd_names:
      ulp = bf16_ulp(torch, g, w)
      over = err > 2 * ulp
      max_over = float(err[over].max()) if bool(over.any()) else 0.0
      msg += (f" max_ulps={float((err / ulp).max()):.2f} n_over_2ulps="
              f"{int(over.sum())} of {err.numel()} (largest abs diff among "
              f"them {max_over:.3e})")
      bad = bool((err > 2 * ulp + CD_ATOL[name]).any())
    else:
      bad = max_err > 3e-2 or mean_err > 2e-3
    print(f"  {what} {msg}", flush=True)
    if bad:
      raise RuntimeError(f"{what}: {name} outside its tolerance ({msg})")
    if name not in cd_names:
      worst = max(worst, max_err)
  return worst


def train_inputs(torch, dropout, r, h, cd, dev, gen):
  """B2's operands (x, drop, w1, b1, w2, b2, gamma, beta) at R x H with
  I = TRAIN_I and the cotangent dy [R, H], drawn from ``gen``."""
  i = TRAIN_I
  rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
  x = rand(r, h)
  drop = dropout.dropout_mask((r, h), TRAIN_P, gen, dev)
  w1, w2 = (rand(i, h) * 0.02).to(cd), (rand(h, i) * 0.02).to(cd)
  b1, b2 = rand(i) * 0.02, rand(h) * 0.02
  gamma, beta = 1.0 + 0.1 * rand(h), 0.1 * rand(h)
  return (x, drop, w1, b1, w2, b2, gamma, beta), rand(r, h)


TRAIN_OUTS = {"ffn_train_fwd": (("out", "inter", "z"), ("inter", "z")),
              "ffn_train_bwd": (("dx", "dz", "dinter"), ("dz", "dinter"))}


def check_train_kernel(torch, ffn, what, kname, cd, args, kw, i=TRAIN_I,
                       check=check_outputs):
  """B2 or B3 (``kname``) on these operands (width I) against its plain
  version by ``check``'s rules and, on a route (bf16's GEMM route, the
  fp32 route), against the WMMA / FMA kernel (``tile=-1``) by the same
  rules, with every row tile bitwise equal.  Returns the kernel's outputs
  and what ``check`` returns."""
  kernel, plain = (getattr(ffn, f"{kname}_cuda"),
                   getattr(ffn, f"{kname}_plain"))
  names, cd_names = TRAIN_OUTS[kname]
  got = kernel(*args, **kw)
  outs = lambda t: dict(zip(names, t))
  err = check(torch, f"{what} vs plain", cd, outs(got),
              outs(plain(*args, **kw)), cd_names)
  if on_route(torch, ffn, args[0].shape[1], i, cd):
    witness = "FMA" if cd == torch.float32 else "WMMA"
    check(torch, f"{what} vs {witness} kernel", cd, outs(got),
          outs(kernel(*args, **kw, tile=-1)), cd_names)
    check_tiles_equal(torch, ffn, what, kernel, args, kw)
  return got, err


def train_kernel_phase(torch, ffn, dropout, dev, gen, card):
  """B2 and B3 (add_dz on and off) against their plain versions at the
  b32 train shapes (fp32 also at b128's), and on a route (bf16's GEMM
  route, the fp32 route) also against the WMMA / FMA kernel
  (``tile=-1``), timed against both.  Returns each kernel's line entries
  (the worst bf16 error, the video bf16 times and bound: no single
  PyTorch call computes either; every fp32 case's times and bound) and
  the device ms of one bf16 call of each by shape, for the train
  profile."""
  res = {name: {"max_abs_err": 0.0, "library_ms": None}
         for name in ("ffn_train_fwd", "ffn_train_bwd")}
  alone = {}
  i = TRAIN_I
  for cd in (torch.bfloat16, torch.float32):
    shapes = TRAIN_SHAPES + (TRAIN_F32_B128_SHAPES if cd == torch.float32
                             else ())
    for r, h in shapes:
      fargs, dy = train_inputs(torch, dropout, r, h, cd, dev, gen)
      _, drop, w1, _, w2, _, gamma, _ = fargs
      kw = dict(eps=1e-12, compute_dtype=cd)
      tag = f"R={r} H={h} I={i} {str(cd).replace('torch.', '')}"
      route = ffn.gemm_route(h, i, cd)
      if cd == torch.float32 and not ffn.f32_route(h, i, cd):
        raise RuntimeError(f"train kernels fp32 {tag}: off the fp32 route")
      fwd_out, err_f = check_train_kernel(
          torch, ffn, f"ffn_train_fwd {tag}", "ffn_train_fwd", cd, fargs, kw)
      _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
      bargs = (dy, z, inter, drop, w1, w2, gamma)
      err_b = 0.0
      for add_dz in (True, False):
        got, err = check_train_kernel(
            torch, ffn, f"ffn_train_bwd {tag} add_dz={add_dz}",
            "ffn_train_bwd", cd, bargs, dict(kw, add_dz=add_dz))
        err_b = max(err_b, err)
        if add_dz:
          bwd_out = got
      # Both do the two products of the block, 4 R H I FLOP.
      calls = {"ffn_train_fwd": (fargs, kw, fwd_out),
               "ffn_train_bwd": (bargs, dict(kw, add_dz=True), bwd_out)}
      yard = gemms_ms(torch, fargs[0], w1, w2) if route else None
      for kname, err in (("ffn_train_fwd", err_f), ("ffn_train_bwd", err_b)):
        args, kkw, out = calls[kname]
        kernel, plain = (getattr(ffn, f"{kname}_cuda"),
                         getattr(ffn, f"{kname}_plain"))
        ms = time_ms(torch, lambda: kernel(*args, **kkw))
        plain_ms = time_ms(torch, lambda: plain(*args, **kkw))
        rate = H100_FP32 if cd == torch.float32 else H100_BF16
        b_ms, b_by = bound(4 * r * h * i, rate, args + tuple(out))
        line = (f"{kname} {tag} ({route_label(torch, ffn, r, h, i, cd, dev)}"
                f" route): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
        if cd == torch.float32:
          dev_ms = device_ms(torch, lambda: kernel(*args, **kkw))
          fma_ms = time_ms(torch, lambda: kernel(*args, **kkw, tile=-1),
                           FMA_REPS)
          line += (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                   f"TFLOP/s, {b_ms / dev_ms:.2%} of the bound) fma_ms="
                   f"{fma_ms:.4f} ({fma_ms / dev_ms:.2f}x)")
          res[kname].setdefault("fp32_shapes", []).append(
              {"shape": f"{r} x {h}, I {i}",
               "route": route_label(torch, ffn, r, h, i, cd, dev),
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "fma_ms": fma_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None})
        if route:
          dev_ms = device_ms(torch, lambda: kernel(*args, **kkw))
          wmma = lambda: kernel(*args, **kkw, tile=-1)
          line += (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                   f"TFLOP/s) wmma_ms={time_ms(torch, wmma):.4f} "
                   f"wmma_device_ms={device_ms(torch, wmma):.4f} host_ms="
                   f"{host_ms(torch, lambda: kernel(*args, **kkw))} "
                   f"gemms_ms={yard:.4f} (two bf16 torch.mm alone)")
          alone.setdefault((r, h), {})[kname] = dev_ms
        print(f"{line} card: {card}", flush=True)
        if cd == torch.bfloat16:
          res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], err)
          if (r, h) == TRAIN_SHAPES[0]:
            res[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by)
  return res, alone


def reference_phase(torch, flagship, evaluate, dev):
  """Tiny fp32 CENet: card (kernels) vs CPU (plain versions)."""
  arch = flagship.flagship_arch(tiny=True)
  cpu = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                tiny=True, seed=1)
  gpu = flagship.flagship_model(device=dev, compute_dtype=torch.float32,
                                tiny=True, seed=1)
  gpu.load_state_dict(cpu.state_dict())
  raw = [flagship.make_batch(arch["expert_dims"], 8, vocab=512, seed=s)
         for s in (11, 12)]
  want = evaluate.retrieval_eval(
      cpu, [flagship.batch_to_torch(b, "cpu") for b in raw])
  got = evaluate.retrieval_eval(
      gpu, [flagship.batch_to_torch(b, dev) for b in raw])
  err = float((got["sims"].cpu() - want["sims"]).abs().max())
  print(f"reference: tiny fp32 CENet card vs CPU sims max_abs_err={err:.3e}",
        flush=True)
  if err > 1e-4:
    raise RuntimeError(f"card vs CPU sims differ by {err} > 1e-4")


TRAIN_BATCH, TRAIN_BIG_BATCH, TRAIN_LR, TRAIN_STEPS = 32, 128, 5e-5, 20
TIMED_STEPS = 10     # steps timed a path and batch (a depth cut from 20)
# Kernel path vs plain path, one b32 step from the same state and seed.
# The only difference is bf16 rounding: the kernels and the plain versions
# round an element of an intermediate to the neighbouring bf16 value now
# and then (a few per 1e4, train-kernel phase).  That moves the loss by
# ~1e-5 and all gradients together by ~1% (relative L2 over all
# parameters), but a parameter whose gradient is a small sum of cancelling
# terms (the last video layer's LayerNorm bias: 7 of 218 tokens carry
# gradient) moves by up to ~8% of its own norm.  A one-element gradient
# (the MoE heads' biases, Linear(D, 1)) is one such sum and no vector: its
# relative difference is one rounding draw over one cancelled sum, and the
# plain bf16 path alone misses the fp32 step's value by up to 78% there
# (phase 13's witness on an H100).  The one-element gradients are held
# together, as one vector, to STEP_GRAD_TOL.
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_ALL_GRADS_TOL = 1e-4, 0.2, 2e-2
# The same step with the model in float32 on both paths (phase 13): the
# kernels' fp32 instantiations and the plain versions compute the same
# function and part only by summation order.
STEP_FP32_TOLS = (1e-6, 1e-2, 1e-4)


SCALARS = "(one-element gradients)"


def grad_diffs(grads, grads_ref):
  """{name: (|diff|, |ref|)} of each parameter's gradient (L2 norms), the
  one-element parameters together as one vector named SCALARS."""
  diffs, scalars = {}, [0.0, 0.0]
  for n, g in grads_ref.items():
    d = float((grads[n].float() - g.float()).norm())
    ref = float(g.float().norm())
    if g.numel() == 1:
      scalars[0] += d * d
      scalars[1] += ref * ref
    else:
      diffs[n] = (d, ref)
  if scalars[1] > 0:
    diffs[SCALARS] = (scalars[0] ** 0.5, scalars[1] ** 0.5)
  return diffs


def check_step(torch, what, loss, loss_ref, grads, grads_ref,
               tols=(STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_ALL_GRADS_TOL)):
  """One train step against a reference step from the same state and
  seed: the loss within tols[0], each parameter's gradient within tols[1]
  relative L2 (grad_diffs) and all gradients together within tols[2].
  Raises past them."""
  loss_tol, grad_tol, all_tol = tols
  loss_diff = abs(loss - loss_ref)
  # Relative L2 difference per parameter, the denominator floored at 1e-2
  # of the median gradient norm: a gradient that is zero in exact
  # arithmetic is rounding noise on both paths (the attention key biases,
  # which the softmax cancels, and the biases in front of the train-mode
  # BatchNorm, which its batch mean cancels).
  diffs = grad_diffs(grads, grads_ref)
  floor = 1e-2 * statistics.median(ref for _, ref in diffs.values())
  rel = {n: d / max(ref, floor) for n, (d, ref) in diffs.items()}
  worst_name = max(rel, key=rel.get)
  worst = rel[worst_name]
  top = sorted(rel, key=rel.get, reverse=True)[:5]
  overall = (sum(d * d for d, _ in diffs.values())
             / sum(ref * ref for _, ref in diffs.values())) ** 0.5
  print(f"{what}: loss {loss:.6f} vs {loss_ref:.6f} abs_diff="
        f"{loss_diff:.3e}; all grads rel L2 diff={overall:.3e}; worst grad "
        f"rel L2 diff={worst:.3e} ({worst_name}; norm floor {floor:.3e}); "
        "top: " + ", ".join(f"{n} {rel[n]:.3e} (|diff| {diffs[n][0]:.3e}, "
                            f"|grad| {diffs[n][1]:.3e})" for n in top),
        flush=True)
  if (not loss_diff <= loss_tol or not worst <= grad_tol
      or not overall <= all_tol):
    raise RuntimeError(f"{what}: loss diff {loss_diff} (tol {loss_tol}),"
                       f" grad diff {worst} (tol {grad_tol}, "
                       f"{worst_name}), all grads {overall} (tol "
                       f"{all_tol})")


def train_step_phase(torch, flagship, ops, ffn, similarity, dev, card):
  """The b32 train step of the full-width flagship (bf16): launch counts,
  kernel path vs plain path, 20 steps, then step times at b32 and b128.
  Returns the launch counts of the counted step, the kernel path's b32
  step time in ms (for the train-CLI phase), its loss and gradients (on
  the CPU) for the tensor-parallel phase, and ``step(batch_size, seed)``,
  one more kernel-path step of the timed run, for the train profile."""
  from mmt_tpu_torch.train import losses, optim, step

  arch = flagship.flagship_arch()
  model = flagship.flagship_model(device=dev, compute_dtype=torch.bfloat16,
                                  seed=0, train=True)
  spec = {"type": "Adam", "args": {"lr": TRAIN_LR, "weight_decay": 0}}
  loss_fn = losses.max_margin_ranking_loss(0.05, True)

  def make(batch_size, seed):
    return flagship.batch_to_torch(flagship.make_batch(
        arch["expert_dims"], batch_size, seed=seed), dev)

  def run(opt, batch, seed, plain=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    with ops.plain_versions() if plain else contextlib.nullcontext():
      return step.train_step(model, opt, batch, loss_fn=loss_fn,
                             lr=TRAIN_LR, generator=gen)

  batch = make(TRAIN_BATCH, 101)
  state0 = {k: v.clone() for k, v in model.state_dict().items()}

  # 1. One counted step on the kernel path.
  for fn in (ffn.ffn_block_cuda, ffn.ffn_train_fwd_cuda,
             ffn.ffn_train_bwd_cuda, similarity.sim_cuda):
    fn.launches = 0
  loss_k = run(optim.build_optimizer(spec, model.parameters())[0], batch, 7)
  torch.cuda.synchronize()
  launches = {"ffn_block": ffn.ffn_block_cuda.launches,
              "ffn_train_fwd": ffn.ffn_train_fwd_cuda.launches,
              "ffn_train_bwd": ffn.ffn_train_bwd_cuda.launches,
              "moe_similarity": similarity.sim_cuda.launches}
  print(f"train step launches: {launches}", flush=True)
  n_layers = FFN_LAYERS
  if (launches["ffn_train_fwd"] != n_layers
      or launches["ffn_train_bwd"] != n_layers
      or launches["moe_similarity"] < 1 or launches["ffn_block"] != 0):
    raise RuntimeError(f"expected {n_layers} B2, {n_layers} B3, >= 1 B4 and "
                       f"0 B1 launches per train step, got {launches}")
  grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}

  # 2. The same step from the same state and seed on the plain path.
  model.load_state_dict(state0)
  loss_p = run(optim.build_optimizer(spec, model.parameters())[0], batch, 7,
               plain=True)
  torch.cuda.synchronize()
  check_step(torch, "train step kernel vs plain", float(loss_k),
             float(loss_p), grads_k,
             {n: p.grad for n, p in model.named_parameters()})
  loss_k = float(loss_k)
  grads_k = {n: g.cpu() for n, g in grads_k.items()}
  del state0

  # 3. 20 steps on one batch.
  opt = optim.build_optimizer(spec, model.parameters())[0]
  bn = next(iter(model.text_GU.values())).cg.batch_norm
  stats0 = (bn.running_mean.clone(), bn.running_var.clone())
  losses_seen = [float(run(opt, batch, 1000 + i))
                 for i in range(TRAIN_STEPS)]
  print(f"train {TRAIN_STEPS} steps on one batch: first loss "
        f"{losses_seen[0]:.6f} last {losses_seen[-1]:.6f} all: "
        f"{[round(x, 6) for x in losses_seen]}", flush=True)
  if not all(x == x and abs(x) != float("inf") for x in losses_seen):
    raise RuntimeError(f"non-finite train losses: {losses_seen}")
  moved = float((bn.running_mean - stats0[0]).abs().max()
                + (bn.running_var - stats0[1]).abs().max())
  if not moved > 0:
    raise RuntimeError("BatchNorm running statistics did not move")
  print(f"BatchNorm running stats moved by {moved:.3e}", flush=True)

  # 4. Step time, kernel and plain paths in turns.
  times = {}
  batches = {TRAIN_BATCH: batch, TRAIN_BIG_BATCH: make(TRAIN_BIG_BATCH, 202)}
  for batch_size, b in batches.items():
    runs = {False: [], True: []}
    for i in range(3 + TIMED_STEPS):
      for plain in (False, True):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        run(opt, b, 5000 + i, plain=plain)
        torch.cuda.synchronize()
        if i >= 3:
          runs[plain].append(time.perf_counter() - tic)
    k_ms = statistics.median(runs[False]) * 1e3
    p_ms = statistics.median(runs[True]) * 1e3
    times[batch_size] = (k_ms, p_ms)
    print(f"train step b{batch_size} (median of {TIMED_STEPS}): "
          f"kernel_path_ms={k_ms:.3f} plain_path_ms={p_ms:.3f} "
          f"ratio={k_ms / p_ms:.4f} samples_per_s={batch_size * 1e3 / k_ms:.1f}"
          f" card: {card}", flush=True)
    print(f"train step b{batch_size} runs kernel_path_ms="
          f"{[round(x * 1e3, 3) for x in runs[False]]} plain_path_ms="
          f"{[round(x * 1e3, 3) for x in runs[True]]}", flush=True)
  return (launches, times[TRAIN_BATCH][0], loss_k, grads_k,
          lambda batch_size, seed: run(opt, batches[batch_size], seed))


GRAPH_STEPS = 5
# The b32 train cells' limits of ``correct`` (perfbench/workloads/
# msrvtt-train-b32.json): where the graph's step and the eager one are
# not bitwise equal, the loss and the parameters' change within these.
GRAPH_LOSS_GAP, GRAPH_UPDATE_GAP = 3e-5, 4e-4


def graph_vs_eager(torch, flagship, ffn, similarity, dev, compute_dtype,
                   tiny=False, batch_size=TRAIN_BATCH, steps=GRAPH_STEPS):
  """The flagship from one seed on the same batches, dropout on, a rate
  that changes each step, ``steps`` steps three ways: eager with a hook
  on the model (which keeps ``train_step`` eager) and Adam as built
  (``"eager"``, the arithmetic of a step without graphs), the same with
  Adam made capturable (``"eager_capturable"``, the graph's arithmetic),
  and through ``train_step``'s graph path (``"graph"``).  Returns
  {way: {"losses", "params", "exp_avg", "exp_avg_sq", "buffers",
  "launches": per step {family: n}, "kinds": (captures, replays,
  eager_steps) moved}}, tensors on the CPU."""
  from mmt_tpu_torch.train import losses, optim, step

  counters = {"B1": lambda: ffn.ffn_block_cuda,
              "B2": lambda: ffn.ffn_train_fwd_cuda,
              "B3": lambda: ffn.ffn_train_bwd_cuda,
              "B4": lambda: similarity.sim_cuda}
  loss_fn = losses.max_margin_ranking_loss(0.05, True)
  lrs = [TRAIN_LR * (i + 1) / steps for i in range(steps)]

  def run(way):
    model = flagship.flagship_model(device=dev, compute_dtype=compute_dtype,
                                    seed=0, tiny=tiny, train=True)
    batches = [flagship.batch_to_torch(flagship.make_batch(
        model.expert_dims, batch_size, seed=400 + i,
        vocab=model.txt_bert.cfg.vocab_size), dev) for i in range(steps)]
    opt = optim.build_optimizer({"type": "Adam", "args": {
        "lr": TRAIN_LR, "weight_decay": 0}}, model.parameters())[0]
    if way != "graph":
      model.register_forward_pre_hook(lambda module, args: None)
    if way == "eager_capturable":
      step.make_capturable(opt, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    init = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    kinds = lambda: (step.train_step.captures, step.train_step.replays,
                     step.train_step.eager_steps)
    kinds0, seen, launches = kinds(), [], []
    for batch, lr in zip(batches, lrs):
      before = {f: c().launches for f, c in counters.items()}
      seen.append(step.train_step(model, opt, batch, loss_fn=loss_fn, lr=lr,
                                  generator=gen))
      launches.append({f: c().launches - before[f]
                       for f, c in counters.items()})
    torch.cuda.synchronize()
    state = opt.state
    out = {"losses": torch.stack(seen).cpu(),
           "params": {n: p.detach().cpu() for n, p in
                      model.named_parameters()},
           "exp_avg": {n: state[p]["exp_avg"].cpu() for n, p in
                       model.named_parameters() if p in state},
           "exp_avg_sq": {n: state[p]["exp_avg_sq"].cpu() for n, p in
                          model.named_parameters() if p in state},
           "buffers": {n: b.cpu() for n, b in model.named_buffers()
                       if "running" in n or "num_batches" in n},
           "launches": launches,
           "kinds": tuple(b - a for a, b in zip(kinds0, kinds())),
           "init": init}
    del model, opt, batches
    torch.cuda.empty_cache()
    return out

  return {way: run(way) for way in ("eager", "eager_capturable", "graph")}


def graph_gaps(torch, got, ref):
  """How far ``got`` lies from ``ref`` (two runs of ``graph_vs_eager``):
  whether every loss, parameter, moment and buffer is bitwise equal;
  ``loss_gap``, the widest relative gap of a step's loss; ``update_gap``,
  of every parameter the gap of its change from the initial weights over
  the larger of the reference's change and the median parameter's,
  leaving out those whose first moment is under a thousandth of the
  median's (``perfbench/checks.py``'s rule: a bias the softmax or a
  train-mode BatchNorm cancels moves by round-off alone), the widest;
  the same of Adam's moments (their widest gap over the larger of their
  own and the median's largest value); and the widest absolute gap of
  the BatchNorm buffers."""
  def same(a, b):
    return all(torch.equal(a[k], b[k]) for k in b)

  def widest(gaps, sizes, names):
    floor = statistics.median(sizes.values())
    return max(gaps[n] / max(sizes[n], floor, 1e-30) for n in names)

  bitwise = (torch.equal(got["losses"], ref["losses"])
             and all(same(got[k], ref[k]) for k in
                     ("params", "exp_avg", "exp_avg_sq", "buffers")))
  loss_gap = float(((got["losses"] - ref["losses"]).abs()
                    / ref["losses"].abs()).max())
  moment = {n: float(m.norm()) for n, m in ref["exp_avg"].items()}
  floor = statistics.median(moment.values())
  moved = [n for n in moment if moment[n] >= 1e-3 * floor]
  update_gap = widest(
      {n: float((got["params"][n] - ref["params"][n]).norm()) for n in moved},
      {n: float((ref["params"][n] - ref["init"][n]).norm())
       for n in ref["exp_avg"]}, moved)
  moment_gap = max(widest(
      {n: float((got[k][n] - ref[k][n]).abs().max()) for n in ref[k]},
      {n: float(ref[k][n].abs().max()) for n in ref[k]}, ref[k])
      for k in ("exp_avg", "exp_avg_sq"))
  buffer_gap = max(float((got["buffers"][n].double()
                          - ref["buffers"][n].double()).abs().max())
                   for n in ref["buffers"])
  return {"bitwise": bitwise, "loss_gap": loss_gap, "update_gap": update_gap,
          "moment_gap": moment_gap, "buffer_gap": buffer_gap}


def step_graph_phase(torch, flagship, ffn, similarity, dev, card,
                     compute_dtype, tiny=False, batch_size=TRAIN_BATCH):
  """``graph_vs_eager`` at ``compute_dtype``: the graph's steps against
  the capturable eager ones (the same arithmetic) and, in fp32, against
  the eager ones as built; each bitwise equal or within GRAPH_LOSS_GAP
  and GRAPH_UPDATE_GAP.  The graph run takes 1 capture, steps - 1 replays and
  1 eager step (the warm-up), and every step moves the launch counters
  as the eager steps do (at full width 16 B2, 16 B3 and 1 B4).  Returns
  the gaps."""
  runs = graph_vs_eager(torch, flagship, ffn, similarity, dev, compute_dtype,
                        tiny=tiny, batch_size=batch_size)
  graph = runs["graph"]
  gaps = {ref: graph_gaps(torch, graph, runs[ref])
          for ref in ("eager_capturable", "eager")}
  name = str(compute_dtype).replace("torch.", "")
  print(f"step graph {name}: kinds (captures, replays, eager) "
        f"{graph['kinds']}; launches a step {graph['launches']}; gaps "
        f"{json.dumps(gaps)}; losses graph "
        f"{graph['losses'].tolist()} eager "
        f"{runs['eager']['losses'].tolist()} card: {card}", flush=True)
  steps = len(graph["launches"])
  if graph["kinds"] != (1, steps - 1, 1):
    raise RuntimeError(f"step graph {name}: expected 1 capture, {steps - 1}"
                       f" replays and 1 eager step, got {graph['kinds']}")
  for way in ("eager", "eager_capturable"):
    if runs[way]["launches"] != graph["launches"]:
      raise RuntimeError(f"step graph {name}: launches {graph['launches']}"
                         f" against {way} {runs[way]['launches']}")
  if not tiny and any(n != {"B1": 0, "B2": FFN_LAYERS, "B3": FFN_LAYERS,
                            "B4": 1} for n in graph["launches"]):
    raise RuntimeError(f"step graph {name}: launches {graph['launches']}")
  # Against Adam as built the gap is that of capturable Adam's arithmetic,
  # held to the limits in fp32 (the cells' dtype); in bf16 the weights'
  # rounding to the compute dtype carries an ulp of the update into the
  # next steps' values, so there it is printed only.
  held = ("eager_capturable", "eager") if compute_dtype == torch.float32 \
      else ("eager_capturable",)
  for ref in held:
    gap = gaps[ref]
    if not gap["bitwise"] and not (gap["loss_gap"] <= GRAPH_LOSS_GAP
                                   and gap["update_gap"] <= GRAPH_UPDATE_GAP):
      raise RuntimeError(f"step graph {name} against {ref}: {gap}")
  return gaps


# The moonlight caption tower's routed experts (models/moe_text.py, the
# grouped kernels of csrc/moe_grouped.cu) at the published widths of
# Moonlight-16B-A3B and ActivityNet's b32 caption rows: 8 of its 64
# experts held, 6 a token.
MOE_TOKENS, MOE_H, MOE_I = 3200, 2048, 1408
MOE_EXPERTS, MOE_HELD, MOE_TOPK = 64, 8, 6
# Kernel against the plain loop (cuBLAS's products, another order of the
# same fp32 sums over K <= 2,816): the widest gap of each output and
# gradient over its largest value.
MOE_TOL = 1e-5
MOE_REPS = 10
# The captured step against the eager one: the tower at 3 of its 27
# layers (the dense one and two MoE), full widths, b32 x 100 words (a
# depth cut, for the phase's time); 1 warm-up, 1 capture, 2 replays.
MOE_GRAPH_LAYERS, MOE_GRAPH_STEPS = 3, 4
MOE_GRAPH_TOWER = {"num_hidden_layers": MOE_GRAPH_LAYERS,
                   "experts_held": list(range(MOE_HELD))}


def moe_kernel_case(torch, ops, moe_ops, dev, gen, card):
  """The grouped kernels' forward and backward against their plain
  loop, twice bitwise equal to themselves, each output and gradient
  within MOE_TOL; 8 launches a forward and backward.  Returns the case's
  numbers."""
  x = torch.randn(MOE_TOKENS, MOE_H, device=dev, generator=gen)
  scores = torch.rand(MOE_TOKENS, MOE_EXPERTS, device=dev, generator=gen)
  sel = torch.topk(scores, MOE_TOPK, -1).indices
  w = torch.rand(MOE_TOKENS, MOE_TOPK, device=dev, generator=gen)
  w_gu = 0.02 * torch.randn(MOE_HELD, 2 * MOE_I, MOE_H, device=dev,
                            generator=gen)
  w_d = 0.02 * torch.randn(MOE_HELD, MOE_H, MOE_I, device=dev, generator=gen)
  slot_of = torch.full((MOE_EXPERTS,), MOE_HELD, dtype=torch.long,
                       device=dev)
  slot_of[:MOE_HELD] = torch.arange(MOE_HELD, device=dev)
  dout = torch.randn(MOE_TOKENS, MOE_H, device=dev, generator=gen)
  leaves = (x, w, w_gu, w_d)

  def run():
    args = [t.detach().requires_grad_(True) for t in leaves]
    out = moe_ops.grouped_experts(args[0], args[1], sel, args[2], args[3],
                                  slot_of)
    out.backward(dout)
    return [out.detach()] + [a.grad for a in args]

  before = moe_ops.moe_grouped_cuda.launches
  got = run()
  launches = moe_ops.moe_grouped_cuda.launches - before
  again = run()
  with ops.plain_versions("moe"):
    want = run()
  names = ("out", "dx", "dweights", "dw_gate_up", "dw_down")
  gaps = {n: float((g - r).abs().max() / r.abs().max())
          for n, g, r in zip(names, got, want)}
  bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
  rows = int((slot_of[sel] < MOE_HELD).sum())

  def fwd():
    moe_ops.grouped_experts(x, w, sel, w_gu, w_d, slot_of)

  def both():
    run()

  fwd_ms, both_ms = time_ms(torch, fwd, MOE_REPS), time_ms(torch, both,
                                                           MOE_REPS)
  flop = 18 * rows * MOE_H * MOE_I
  res = {"rows": rows, "launches": launches, "gaps": gaps,
         "bitwise_repeat": bitwise, "fwd_ms": fwd_ms,
         "fwd_bwd_ms": both_ms,
         "bound_ms": 1e3 * flop / 67e12, "tflops": flop / both_ms / 1e9}
  print(f"moe grouped kernels (T {MOE_TOKENS}, H {MOE_H}, I {MOE_I}, "
        f"{MOE_HELD} of {MOE_EXPERTS} held, K {MOE_TOPK}): "
        f"{json.dumps(res)} card: {card}", flush=True)
  if launches != 8 or not bitwise or max(gaps.values()) > MOE_TOL:
    raise RuntimeError(f"moe grouped kernels: {res}")
  return res


def moe_graph_case(torch, dev, card):
  """The moonlight CENet at MOE_GRAPH_LAYERS layers, b32 x 100 words, two
  ways from one seed on the same batches, dropout on: eager (a hook on
  the model) with Adam made capturable, and through ``train_step``'s
  graph path, every replayed call under
  ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises).
  Losses, parameters, moments and the routers' correction biases must be
  bitwise equal; the graph run takes 1 warm-up, 1 capture and the rest
  replays.  Returns the graph run's counters."""
  from mmt_tpu_torch.models import moe_text
  from mmt_tpu_torch.models.cenet import CENet
  from mmt_tpu_torch.ops import moe as moe_ops
  from mmt_tpu_torch.train import losses, optim, step

  experts = {"s3d": {"dim": 1024, "idx": 1}, "vggish": {"dim": 128, "idx": 2}}
  vid = {"hidden_size": 512, "num_hidden_layers": 4,
         "num_attention_heads": 4, "intermediate_size": 3072,
         "max_position_embeddings": 102, "type_vocab_size": 19,
         "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}
  tower = MOE_GRAPH_TOWER
  vocab = moe_text.TowerConfig.from_dict(tower).vocab_size
  g = torch.Generator(device=dev).manual_seed(3)
  b, words, rows = TRAIN_BATCH, 100, 100

  def batch():
    ids = torch.randint(0, vocab, (b, 1, words), device=dev, generator=g)
    out = {"token_ids": torch.stack([ids, torch.ones_like(ids)], -1),
           "query_masks": torch.ones(b, 1, device=dev)}
    for key in ("features", "features_t", "features_ind",
                "features_avgpool", "features_maxpool"):
      out[key] = {}
    for m, e in experts.items():
      out["features"][m] = torch.randn(b, rows, e["dim"], device=dev,
                                       generator=g)
      out["features_t"][m] = torch.randint(0, 100, (b, rows), device=dev,
                                           generator=g).float()
      out["features_ind"][m] = torch.ones(b, rows, device=dev)
      out["features_avgpool"][m] = torch.randn(b, e["dim"], device=dev,
                                               generator=g)
      out["features_maxpool"][m] = torch.randn(b, e["dim"], device=dev,
                                               generator=g)
    return out

  batches = [batch() for _ in range(MOE_GRAPH_STEPS)]
  loss_fn = losses.max_margin_ranking_loss(0.05, True)
  lrs = [TRAIN_LR * (i + 1) / MOE_GRAPH_STEPS for i in range(MOE_GRAPH_STEPS)]

  def run(way):
    model = CENet(expert_dims=experts, vid_bert_params=vid,
                  txt_bert_params={"hidden_dropout_prob": 0.1}, same_dim=512,
                  device=dev, txt_agg=moe_text.KIND, text_tower=tower)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    model.train(True)
    opt = optim.build_optimizer({"type": "Adam", "args": {
        "lr": TRAIN_LR, "weight_decay": 0}}, model.parameters())[0]
    if way == "eager":
      model.register_forward_pre_hook(lambda module, args: None)
      step.make_capturable(opt, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    kinds = lambda: (step.train_step.captures, step.train_step.replays,
                     step.train_step.eager_steps)
    kinds0, seen = kinds(), []
    launches0 = moe_ops.moe_grouped_cuda.launches
    for i, (bt, lr) in enumerate(zip(batches, lrs)):
      debug = way == "graph" and i >= 2
      if debug:
        torch.cuda.set_sync_debug_mode("error")
      try:
        seen.append(step.train_step(model, opt, bt, loss_fn=loss_fn, lr=lr,
                                    generator=gen))
      finally:
        if debug:
          torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    state = opt.state
    out = {"losses": torch.stack(seen).cpu(),
           "params": {n: p.detach().cpu() for n, p in
                      model.named_parameters()},
           "exp_avg": {n: state[p]["exp_avg"].cpu() for n, p in
                       model.named_parameters()},
           "buffers": {n: t.cpu() for n, t in model.named_buffers()},
           "kinds": tuple(y - x for x, y in zip(kinds0, kinds())),
           "launches": moe_ops.moe_grouped_cuda.launches - launches0}
    del model, opt
    torch.cuda.empty_cache()
    return out

  eager, graph = run("eager"), run("graph")
  same = lambda a, c: all(torch.equal(a[k], c[k]) for k in c)
  bitwise = {"losses": torch.equal(graph["losses"], eager["losses"]),
             **{k: same(graph[k], eager[k])
                for k in ("params", "exp_avg", "buffers")}}
  moe_layers = tower["num_hidden_layers"] - 1
  res = {"kinds": graph["kinds"], "bitwise": bitwise,
         "launches": (graph["launches"], eager["launches"]),
         "want_launches": 8 * moe_layers * MOE_GRAPH_STEPS,
         "losses": graph["losses"].tolist()}
  print(f"moe step graph ({tower['num_hidden_layers']} layers): "
        f"{json.dumps(res)} "
        f"card: {card}", flush=True)
  if (graph["kinds"] != (1, MOE_GRAPH_STEPS - 1, 1)
      or not all(bitwise.values())
      or res["launches"] != (res["want_launches"],) * 2):
    raise RuntimeError(f"moe step graph: {res}")
  return res


def moe_phase(torch, ops, dev, gen, card):
  """Phase 20: the moonlight tower's grouped kernels at its published
  widths, and its captured train step against the eager one."""
  from mmt_tpu_torch.ops import moe as moe_ops

  return {"kernels": moe_kernel_case(torch, ops, moe_ops, dev, gen, card),
          "graph": moe_graph_case(torch, dev, card)}


# Kernels of B2 and B3 on the GEMM route, as the profiler names them (the
# template GEMMs by their epilogues); the train step launches no B1, whose
# cast and GEMM 1 epilogue would share B2's names.
TRAIN_KERNELS = {
    "ffn_train_fwd": ("ffn_cast_bf16_kernel", "GeluInterEpilogue",
                      "DropResidualEpilogue", "ffn_ln_rows_kernel"),
    "ffn_train_bwd": ("ffn_transpose_bf16_kernel", "ffn_ln_bwd_rows_kernel",
                      "DgeluEpilogue", "AccumulateEpilogue")}
TRAIN_PROFILE_STEPS = 3
VIDEO_TOKENS, TEXT_TOKENS = 218, 30   # rows per sample of each tower's FFN


def train_alone_ms(torch, ffn, dropout, shape, dev, gen):
  """{kernel: (device ms, CUDA-event ms)} of one bf16 B2 and one B3 call
  at ``shape`` (rows, H)."""
  fargs, dy = train_inputs(torch, dropout, *shape, torch.bfloat16, dev, gen)
  kw = dict(eps=1e-12, compute_dtype=torch.bfloat16)
  _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
  bargs = (dy, z, inter, fargs[1], fargs[2], fargs[4], fargs[6])
  calls = {"ffn_train_fwd": lambda: ffn.ffn_train_fwd_cuda(*fargs, **kw),
           "ffn_train_bwd": lambda: ffn.ffn_train_bwd_cuda(*bargs, **kw)}
  return {k: (device_ms(torch, fn), time_ms(torch, fn))
          for k, fn in calls.items()}


def train_profile_phase(torch, ffn, dropout, profile_eval, step, alone, dev,
                        gen, card):
  """At b32 ``python -m mmt_tpu_torch.profile_eval --mode train`` at full
  width (bench's b32 step, TRAIN_PROFILE_STEPS steps traced); at b128
  TRAIN_PROFILE_STEPS kernel-path steps of the train-step phase under
  ``profile_eval.session``.  The card's SM clock and power sampled
  meanwhile; a step launches exactly 16 B2, 16 B3 and 1 B4, which the
  profiler recorded as often (``check_profile``); device time and idle
  share, the rollup, B2's and B3's kernels in situ a step against their
  device time alone (phase 4's at b32; at b128's shapes measured right
  after the window, clock sampled too) times the launches."""
  want = {"B2": FFN_LAYERS, "B3": FFN_LAYERS, "B4": 1}
  with CardSampler() as card_in:
    res = profile_eval.main(["--mode", "train", "--steps",
                            str(TRAIN_PROFILE_STEPS), "--top",
                            str(PROFILE_TOP)])
  reports = {TRAIN_BATCH: (res, card_in)}
  n = TRAIN_PROFILE_STEPS
  step(TRAIN_BIG_BATCH, 6000)                     # warm-up
  with CardSampler() as card_in:
    prof, events, wall_ms, launched = profile_eval.session(
        lambda: [step(TRAIN_BIG_BATCH, 6001 + s) for s in range(n)], dev)
  rows, rollup, total = profile_eval.breakdown(prof, events, dev, n)
  reports[TRAIN_BIG_BATCH] = ({
      "rows": rows, "rollup": rollup, "device_ms": total,
      "wall_ms": wall_ms / n, "idle": 1 - total * n / wall_ms,
      "launches": {f: k / n for f, k in launched.items()}}, card_in)
  for batch_size, (res, card_in) in reports.items():
    check_profile(res, want, f"train profile b{batch_size}")
    video = (batch_size * VIDEO_TOKENS, 512)
    text = (batch_size * TEXT_TOKENS, 768)
    events = {}   # CUDA-event ms alone, where measured here
    with CardSampler() as card_alone:
      for shape in (video, text):
        if shape not in alone:
          both = train_alone_ms(torch, ffn, dropout, shape, dev, gen)
          alone[shape] = {k: d for k, (d, _) in both.items()}
          events[shape] = {k: e for k, (_, e) in both.items()}
    total = res["device_ms"]
    print(f"train profile b{batch_size}: device time {total:.3f} ms a step, "
          f"wall {res['wall_ms']:.3f} ms a step (under the profiler), "
          f"device idle share {res['idle']:.4f}; {card_in.summary()} card: "
          f"{card}", flush=True)
    for kname, names in TRAIN_KERNELS.items():
      mine = [r for r in res["rows"] if any(k in r["key"] for k in names)]
      in_ms = sum(r["ms_per_run"] for r in mine)
      # Per step 4 video and 12 text blocks.
      alone_ms = 4 * alone[video][kname] + 12 * alone[text][kname]
      print(f"train profile b{batch_size}: {kname} in situ {in_ms:.3f} ms a "
            f"step ({in_ms / total:.2%} of device time; "
            f"{sum(r['per_run'] for r in mine):g} kernels a step; "
            f"{in_ms / FFN_LAYERS:.4f} ms a call) against device time alone "
            f"x launches {alone_ms:.3f} ms (in situ / alone "
            f"{in_ms / alone_ms:.4f}; alone: video {alone[video][kname]:.4f}"
            f", text {alone[text][kname]:.4f} ms a call)", flush=True)
      if events:
        # Calls of 0.1 ms and more: their event time is the device's.
        ev_ms = 4 * events[video][kname] + 12 * events[text][kname]
        print(f"  {kname} alone by CUDA events: video "
              f"{events[video][kname]:.4f}, text {events[text][kname]:.4f} "
              f"ms a call; in situ / alone {in_ms / ev_ms:.4f}", flush=True)
      for r in mine:
        print(f"  {kname} kernel {r['ms_per_run']:.3f} ms x{r['per_run']:g} "
              f"{r['name']}", flush=True)
    if batch_size != TRAIN_BATCH:
      print(f"train profile b{batch_size}: while timing B2 and B3 alone "
            f"{card_alone.summary()}", flush=True)
      for r in res["rows"][:PROFILE_TOP]:
        print(f"  top device op {r['ms_per_run']:.3f} ms a step "
              f"({r['share']:.2%}) x{r['per_run']:g} {r['name'][:110]}",
              flush=True)
  return reports[TRAIN_BATCH][0]


# Rank-kernel cases: (name, videos, captions per video).  (a) 50k x 50k
# unit-norm random embeddings with all-zero weight rows; (b) 2,000
# captions x 1,000 videos with masked caption slots, a video whose slots
# are all masked and 24 padding videos; (c) exact arithmetic with
# duplicated rows (ties).
RANK_CASES = (("a", 50_000, 1), ("b", 1_000, 2), ("c", 1_000, 2))
RANK_M, RANK_D, RANK_PAD = 7, 512, 24


def rank_inputs(torch, case, nv, cpv, dev, gen):
  """te, ve, tw, vw, masks, vid_valid of one rank-kernel case."""
  q, m, d = nv * cpv, RANK_M, RANK_D
  masks = torch.ones(nv, cpv, device=dev)
  vid_valid = None
  if case == "c":
    # Values in {0, +-0.5, +-1} and unit weights: every partial sum is a
    # multiple of 0.25 below 2^22, exact in fp32 in any order, so kernel
    # and plain version must count alike.
    rand = lambda *sh: torch.randint(-2, 3, sh, generator=gen,
                                     device=dev).float() / 2
    te, ve = rand(q, m, d), rand(nv, m, d)
    ve[10] = ve[3]          # duplicates of GT rows: ties in t2v
    ve[20:25] = ve[0]
    te[100] = te[41]        # duplicate captions: ties in v2t
    te[7] = te[6]
    return (te, ve, torch.ones(q, m, device=dev), torch.ones(nv, m, device=dev),
            masks, vid_valid)
  te = torch.randn(q, m, d, generator=gen, device=dev)
  ve = torch.randn(nv, m, d, generator=gen, device=dev)
  te, ve = te / te.norm(dim=-1, keepdim=True), ve / ve.norm(dim=-1,
                                                          keepdim=True)
  tw = torch.rand(q, m, generator=gen, device=dev)
  vw = torch.rand(nv, m, generator=gen, device=dev)
  tw, vw = tw / tw.sum(-1, keepdim=True), vw / vw.sum(-1, keepdim=True)
  if case == "a":            # the denominator's 1e-5 guard
    tw[3] = 0.0
    vw[5] = 0.0
    vw[7] = 0.0
  else:
    masks = (torch.rand(nv, cpv, generator=gen, device=dev) > 0.1).float()
    masks[0] = 0.0           # every slot masked: v2t rank inf
    # Padding videos, as a mesh pads them: zero rows, dead in both
    # orientations.
    pad = RANK_PAD
    ve[-pad:], vw[-pad:], masks[-pad:] = 0.0, 0.0, 0.0
    te[-pad * cpv:], tw[-pad * cpv:] = 0.0, 0.0
    vid_valid = torch.ones(nv, device=dev)
    vid_valid[-pad:] = 0.0
  return te, ve, tw, vw, masks, vid_valid


def rank_agreement(torch, got, want):
  """(worst |diff| over ranks finite in both, share of them that differ,
  whether the inf positions agree)."""
  inf_g, inf_w = torch.isinf(got), torch.isinf(want)
  fin = ~inf_g & ~inf_w
  diff = (got[fin] - want[fin]).abs()
  worst = float(diff.max()) if diff.numel() else 0.0
  return worst, float((diff > 0).float().mean()), bool(torch.equal(inf_g,
                                                                   inf_w))


# The JAX package's rule for the fused ranks, every rank within 1 on
# fewer than 1e-3 of the queries, is a rate: it is held where 1e-3 of the
# queries is at least 10 of them.  On fewer queries it would demand that
# no GT have a near tie at all, which depends on the draw; there phase 3
# holds each call instead to the fp64 witness of check_counts_witness.
RANK_SHARE_MIN_QUERIES = 10_000


def check_rank_rule(torch, what, got, want):
  """Same inf positions; finite ranks within 1, and from
  RANK_SHARE_MIN_QUERIES queries on fewer than 1e-3 of them.  Returns
  the worst |diff|."""
  worst, frac, same_inf = rank_agreement(torch, got, want)
  held = got.numel() >= RANK_SHARE_MIN_QUERIES
  print(f"  {what}: worst rank diff {worst} on {frac:.3e} of queries"
        f"{'' if held else ' (share rule from 10,000 queries)'}, same inf "
        f"positions {same_inf}", flush=True)
  if not same_inf or worst > 1 or (held and frac >= 1e-3):
    raise RuntimeError(f"{what}: ranks outside the rule (worst {worst}, "
                       f"share {frac}, same inf {same_inf})")
  return worst


def check_counts_witness(torch, ranking, what, args, got, want,
                         kernel_sims=None):
  """One draw of two fp32 sum orders (kernel and plain version): a query's
  counts may differ only by candidates whose exact similarity lies within
  fp32 sum-order noise of the GT value both compare with.  For each query
  that differs: s64, its fp64 similarities; its noise, the largest
  |s32 - s64| over its live candidates of the fp32 values of the plain
  formula (torch.mm) and of ``kernel_sims`` (B4, whose values are B5's
  bits); its |difference of closer + tied / 2| must not exceed its
  candidates c != gtcol with |s64 - gt| <= 2 noise.  Prints the differing
  queries beside the witness; raises otherwise."""
  queries, cands, qw, cw, gt, gtcol, colbias = args
  diff = ((got[0] + got[1] / 2) - (want[0] + want[1] / 2)).abs()
  rows = torch.nonzero(diff > 0)[:, 0]
  if rows.numel() == 0:
    return
  q, qws = queries[rows].contiguous(), qw[rows].contiguous()
  guard = lambda d: torch.where(d == 0, torch.full_like(
      d, ranking.EPS_ZERO_GUARD), d)
  s64 = (q.double() @ cands.double().T) / guard(qws.double()
                                                @ cw.double().T)
  fp32 = [(q @ cands.T) / guard(qws @ cw.T)]
  if kernel_sims is not None:
    fp32.append(kernel_sims(q, cands, qws, cw))
  live = (colbias == 0)[None, :]
  noise = torch.stack([torch.where(live, (s - s64).abs(), 0.0).amax(1)
                       for s in fp32]).amax(0)
  gap = (s64 + colbias.double() - gt[rows].double()[:, None]).abs()
  own = gtcol[rows].long()
  held = (own >= 0) & (own < cands.shape[0])   # a shard's GT may lie outside
  gap[torch.arange(rows.numel(), device=gap.device)[held],
      own[held]] = float("inf")
  n_near = (gap <= 2 * noise[:, None]).sum(1)
  ok = bool((diff[rows] <= n_near).all())
  print(f"  {what}: {rows.numel()} queries' counts differ (largest by "
        f"{float(diff.max())}); each within its candidates inside twice the "
        f"fp32 sum-order noise of the GT (fp64 witness): {ok}", flush=True)
  for j in range(min(rows.numel(), 4)):
    c = int(gap[j].argmin())
    print(f"    query {int(rows[j])}: differs by {float(diff[rows[j]])}, GT "
          f"{float(gt[rows[j]]):.9e}, nearest candidate {c} at fp64 "
          f"{float(s64[j, c]):.12e} (|s64 - GT| {float(gap[j, c]):.3e}, "
          f"noise {float(noise[j]):.3e}), {int(n_near[j])} within twice the "
          "noise", flush=True)
  if not ok:
    raise RuntimeError(f"{what}: counts differ beyond fp32 sum-order noise "
                       "of the GT")


def counts_bound(torch, args):
  """Bound of one fused-counts call: its FMAs (2 Q C (K + M)) at the fp32
  rate, its operands and two [Q] int32 counts at the memory rate."""
  q, k = args[0].shape
  c, m = args[3].shape
  out = torch.empty(2 * q, dtype=torch.int32, device=args[0].device)
  return bound(2 * q * c * (k + m), H100_FP32, tuple(args) + (out,))


def matrix_counts(torch, similarity, args, tile=None):
  """The (closer, tied) counts of one fused-counts call, taken from the
  similarity kernel's own [Q, C] matrix."""
  queries, cands, qw, cw, gt, gtcol, colbias = args
  sims = similarity.sim_cuda(queries, cands, qw, cw, tile=tile) + colbias[None]
  col = torch.arange(cands.shape[0], device=cands.device)
  valid = col[None, :] != gtcol[:, None]
  return ((valid & (sims > gt[:, None])).sum(1).float(),
          (valid & (sims == gt[:, None])).sum(1).float())


def check_counts_equal_matrix(torch, ranking, similarity, what, args, got):
  """B5 compares bitwise B4's values: its counts, in every tile shape,
  equal those of B4's matrix as integers."""
  want = matrix_counts(torch, similarity, args)
  same = [all(torch.equal(g, w) for g, w in zip(got, want))]
  for i in range(len(similarity.TILES)):
    out = ranking.fused_counts_cuda(*args, tile=i)
    same.append(all(torch.equal(g, w) for g, w in zip(out, want)))
    same.append(all(torch.equal(g, w) for g, w in zip(
        matrix_counts(torch, similarity, args, tile=i), want)))
  print(f"  {what}: counts equal those of the similarity kernel's matrix "
        f"(as called, then each tile shape of B5 and of B4): {same}",
        flush=True)
  if not all(same):
    raise RuntimeError(f"{what}: fused counts differ from the counts of "
                       "the similarity kernel's matrix")


def rank_kernel_phase(torch, ranking, similarity, dev, gen, card):
  """B5 against its plain version on the card, each case in both
  orientations; returns the worst rank disagreement."""
  worst_all = 0.0
  for case, nv, cpv in RANK_CASES:
    te, ve, tw, vw, masks, vid_valid = rank_inputs(torch, case, nv, cpv,
                                                   dev, gen)
    for orient in ("t2v", "v2t"):
      ranks, logs = {}, {}
      for name, fn in (("kernel", ranking.fused_counts_cuda),
                       ("plain", ranking.fused_counts_plain)):
        log = logs[name] = []

        def counted(*a, fn=fn, log=log):
          out = fn(*a)
          log.append((a, out))
          return out

        ranks[name] = (
            ranking._t2v_ranks_from_counts(counted, te, ve, tw, vw, vid_valid)
            if orient == "t2v" else
            ranking._v2t_ranks_from_counts(counted, te, ve, tw, vw, masks))
      torch.cuda.synchronize()
      what = f"fused_ranks case ({case}) {orient} {nv * cpv} x {nv}"
      worst_all = max(worst_all, check_rank_rule(
          torch, f"{what} kernel vs plain", ranks["kernel"], ranks["plain"]))
      for n_call, (k, p) in enumerate(zip(logs["kernel"], logs["plain"])):
        check_counts_witness(torch, ranking, f"{what} call {n_call}", k[0],
                             k[1], p[1], similarity.sim_cuda)
      if case == "c":
        pairs = list(zip(logs["kernel"], logs["plain"]))
        equal = all(torch.equal(k[1][0], p[1][0]) and torch.equal(k[1][1],
                                                                  p[1][1])
                    for k, p in pairs)
        max_tied = max(float(k[1][1].max()) for k, _ in pairs)
        print(f"  exact case: counts equal {equal}, largest tied count "
              f"{max_tied}", flush=True)
        if not equal or not max_tied > 0:
          raise RuntimeError("exact case: kernel and plain counts differ or "
                             "no tie was counted")
      if case in ("b", "c"):
        for n_call, (a, out) in enumerate(logs["kernel"]):
          check_counts_equal_matrix(torch, ranking, similarity,
                                    f"{what} call {n_call}", a, out)
      if case == "b" and orient == "v2t":
        if not (torch.isinf(ranks["kernel"][0])
                and torch.isinf(ranks["plain"][0])):
          raise RuntimeError("a video with every slot masked must rank inf")
      args = logs["kernel"][0][0]
      reps = 3 if nv > 10_000 else 10
      ms = time_ms(torch, lambda: ranking.fused_counts_cuda(*args), reps)
      plain_ms = time_ms(torch, lambda: ranking.fused_counts_plain(*args),
                         reps)
      lib_ms = time_ms(torch, lambda: torch.mm(args[0], args[1].T), reps)
      b_ms, b_by = counts_bound(torch, args)
      print(f"{what} (one counts call, {len(logs['kernel'])} per "
            f"orientation): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (torch.mm of the numerator) "
            f"bound_ms={b_ms:.4f} ({b_by}) card: {card}", flush=True)
    del te, ve, tw, vw
    torch.cuda.empty_cache()

  # K = 3,586 (no multiple of 4 or of the slice depth), ragged Q and C and
  # dead candidates: against the plain version with each query's GT value
  # computed directly, as the ranks do; then with GT values read from the
  # similarity kernel's matrix, so that ties exist, against its counts.
  gen = torch.Generator(device=dev).manual_seed(3)   # see sim_phase
  q, c = 300, 500
  t, cc, tw, cw = sim_inputs(torch, q, c, 2, 1793, dev, gen)
  gtcol = torch.randint(0, c, (q,), generator=gen, device=dev)
  colbias = torch.zeros(c, device=dev)
  colbias[::7] = -ranking.MISSING_VAL
  what = f"fused_ranks {q} x {c} K={t.shape[1]}"
  args = (t, cc, tw, cw, ranking._gt_sims(t, cc, tw, cw, gtcol), gtcol,
          colbias)
  got, want = (fn(*args) for fn in (ranking.fused_counts_cuda,
                                    ranking.fused_counts_plain))
  worst_all = max(worst_all, check_rank_rule(
      torch, f"{what} kernel vs plain", got[0] + got[1] / 2,
      want[0] + want[1] / 2))
  check_counts_witness(torch, ranking, what, args, got, want,
                       similarity.sim_cuda)
  other = torch.randint(0, c, (q, 1), generator=gen, device=dev)
  args = (t, cc, tw, cw,
          similarity.sim_cuda(t, cc, tw, cw).gather(1, other)[:, 0], gtcol,
          colbias)
  got = ranking.fused_counts_cuda(*args)
  check_counts_equal_matrix(torch, ranking, similarity, what, args, got)
  if not float(got[1].sum()) > 0:
    raise RuntimeError(f"{what}: no tie was counted")
  return worst_all


AT_SCALE_VIDEOS = 10_000
AT_SCALE_TURNS = 1   # timed turns a path (a depth cut from 3)


def between_gts(torch, a, g_fused, gtcol):
  """Per row of a [rows, candidates] similarity matrix: the candidates
  other than the GT column whose similarity lies between the fused path's
  GT value and the matrix's (both included)."""
  g_matrix = a.gather(1, gtcol[:, None])[:, 0]
  lo = torch.minimum(g_fused, g_matrix)[:, None]
  hi = torch.maximum(g_fused, g_matrix)[:, None]
  return ((a >= lo) & (a <= hi)).sum(1) - 1


def at_scale_phase(torch, modules, model, staged, dev, card):
  """The fused eval at AT_SCALE_VIDEOS videos (bench.py's streaming
  protocol): launch counts, kernel vs plain and fused vs matrix ranks on
  the same embeddings, peak memory, B5's time at this shape, and the
  eval's wall time on both paths.  Returns the B5 line entries."""
  bench, evaluate, metrics, ops, ffn, similarity, ranking = modules
  n = AT_SCALE_VIDEOS
  vocab = model.txt_bert.cfg.vocab_size
  passes = lambda: bench.salted_passes(staged, n, vocab)

  # 1. The main path, counted.
  for fn in (ffn.ffn_block_cuda, similarity.sim_cuda,
             ranking.fused_counts_cuda):
    fn.launches = 0
  tic = time.perf_counter()
  res = evaluate.retrieval_eval(model, passes(), fused=True)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - tic
  launches = {"ffn_block": ffn.ffn_block_cuda.launches,
              "moe_similarity": similarity.sim_cuda.launches,
              "fused_ranks": ranking.fused_counts_cuda.launches}
  print(f"at-scale: fused eval of {n} videos ({n // CHUNK} chunks of {CHUNK},"
        f" {n // N_VIDEOS} salted passes) in {first_s:.3f} s; launches "
        f"{launches}", flush=True)
  want = {"ffn_block": FFN_LAYERS * (n // CHUNK), "moe_similarity": 0,
          "fused_ranks": 2}       # t2v + one per caption slot (cpv = 1)
  if launches != want:
    raise RuntimeError(f"expected launches {want}, got {launches}")
  if "sims" in res:
    raise RuntimeError("the fused eval returned a sims matrix")
  finite_metrics(res)

  # 2. The same run's embeddings, ranked on the kernel path, the plain
  # path and the matrix path (B4 + the matrix ranks).
  emb = evaluate.embed_corpus(model, passes())
  te, ve, tw, vw, masks = (emb[k] for k in (
      "text_embds", "vid_embds", "text_weights", "vid_weights",
      "query_masks"))
  if masks.shape != (n, 1) or not bool(masks.all()):
    raise RuntimeError("the at-scale corpus has one live caption per video")
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  with torch.inference_mode():
    kern = {"t2v": ranking.fused_t2v_ranks(te, ve, tw, vw),
            "v2t": ranking.fused_v2t_ranks(te, ve, tw, vw, masks)}
    torch.cuda.synchronize()
    peak_fused = torch.cuda.max_memory_allocated() - base
    with ops.plain_versions():
      plain = {"t2v": ranking.fused_t2v_ranks(te, ve, tw, vw),
               "v2t": ranking.fused_v2t_ranks(te, ve, tw, vw, masks)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sims = similarity.moe_similarity(te, ve, tw, vw, merge="indep",
                                     num_caps=1)
    matrix = {"t2v": ranking.t2v_ranks(sims),
              "v2t": ranking.v2t_ranks(sims, masks)}
    torch.cuda.synchronize()
    peak_matrix = torch.cuda.max_memory_allocated() - base
  print(f"at-scale peak device memory above the {base / 2**30:.3f} GiB "
        f"resident (embeddings, inputs, weights): fused ranking "
        f"{peak_fused / 2**30:.3f} GiB, matrix ranking "
        f"{peak_matrix / 2**30:.3f} GiB card: {card}", flush=True)

  worst = 0.0
  t, tws = ranking._scaled_flat(te, tw)
  v, vws = ranking._scaled_flat(ve, vw)
  gtcol = torch.arange(n, device=dev)
  for orient, a, g in (
      ("t2v", sims, ranking._gt_sims(t, v, tws, vws, gtcol)),
      ("v2t", sims.T, ranking._gt_sims(v, t, vws, tws, gtcol))):
    worst = max(worst, check_rank_rule(
        torch, f"at-scale {orient} kernel vs plain", kern[orient],
        plain[orient]))
    # Fused vs matrix: the candidates' values are bitwise equal (one tile
    # code), the GT value is not (computed directly on the fused path, read
    # from the matrix on the other), so a rank may differ by the
    # candidates that lie between the two GT values, and by nothing else.
    m_worst, frac, same_inf = rank_agreement(torch, kern[orient],
                                             matrix[orient])
    slack = between_gts(torch, a, g, gtcol)
    diff = (kern[orient] - matrix[orient]).abs()
    explained = bool((diff <= slack).all())
    g_m = a.gather(1, gtcol[:, None])[:, 0]
    print(f"  at-scale {orient} fused vs matrix: worst rank diff {m_worst} "
          f"on {frac:.3e} of queries (the 1 / 1e-3 rule "
          f"{'met' if m_worst <= 1 and frac < 1e-3 else 'NOT met'}); GT "
          f"values differ on {float((g != g_m).float().mean()):.3e} of "
          f"queries, by at most {float((g - g_m).abs().max()):.3e}; every "
          f"difference within the candidates between the two GT values: "
          f"{explained}; same inf positions {same_inf}", flush=True)
    if not explained or not same_inf:
      raise RuntimeError(f"at-scale {orient}: fused and matrix ranks differ "
                         "beyond the GT's rounding")
  side = {}
  for name, ranks in (("fused kernel", kern), ("fused plain", plain),
                      ("matrix", matrix)):
    side[name] = {o: {k: v for k, v in metrics.cols2metrics(
        ranks[o].cpu().numpy(), n).items() if k in ("R1", "R5", "R10",
                                                     "MedR")}
                  for o in ("t2v", "v2t")}
  print(f"at-scale metrics side by side: {json.dumps(side)}", flush=True)
  same = all(metrics.cols2metrics(kern[o].cpu().numpy(), n) == res[w]
             for o, w in (("t2v", "t2v_metrics"), ("v2t", "v2t_metrics")))
  print(f"at-scale: the counted run's metrics equal these kernel ranks' "
        f"{same}", flush=True)
  del sims, matrix

  # 3. B5 at this shape (t2v operands), against its plain version and
  # the fp32 torch.mm of the numerator.
  args = (t, v, tws, vws, ranking._gt_sims(t, v, tws, vws, gtcol), gtcol,
          torch.zeros(n, device=dev))
  ms = time_ms(torch, lambda: ranking.fused_counts_cuda(*args), 5)
  plain_ms = time_ms(torch, lambda: ranking.fused_counts_plain(*args), 5)
  lib_ms = time_ms(torch, lambda: torch.mm(t, v.T), 5)
  b_ms, b_by = counts_bound(torch, args)
  print(f"fused_ranks {n} x {n} (one counts call): kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms="
        f"{b_ms:.4f} ({b_by}) card: {card}", flush=True)
  del emb, te, ve, tw, vw, t, v, args, kern, plain
  torch.cuda.empty_cache()

  # 4. Wall time of the fused eval, kernel and plain paths in turns.
  def wall(plain_path):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with ops.plain_versions() if plain_path else contextlib.nullcontext():
      evaluate.retrieval_eval(model, passes(), fused=True)
    torch.cuda.synchronize()
    return time.perf_counter() - tic

  wall(False)
  wall(True)
  runs = {False: [], True: []}
  for _ in range(AT_SCALE_TURNS):
    for plain_path in (False, True):
      runs[plain_path].append(wall(plain_path))
  k_s, p_s = statistics.median(runs[False]), statistics.median(runs[True])
  print(f"fused eval {n} videos wall (median of {AT_SCALE_TURNS}): "
        f"kernel_path_s={k_s:.6f} "
        f"plain_path_s={p_s:.6f} ratio={k_s / p_s:.4f} "
        f"videos_per_s={n / k_s:.1f} card: {card}", flush=True)
  print(f"fused eval runs kernel_path_s={[round(x, 6) for x in runs[False]]} "
        f"plain_path_s={[round(x, 6) for x in runs[True]]}", flush=True)
  return {"launches": launches["fused_ranks"], "max_abs_err": worst,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": b_ms, "bound_by": b_by}


TP_SIZE, TP_I = 2, 3072 // 2     # two ranks: each holds I/mp of I = 3072
# B6's (1013, 192) is off the GEMM route: the WMMA kernel.
PARTIAL_SHAPES = {"ffn_partial": ((10900, 512), (1500, 768), (1013, 768),
                                  (1013, 192)),
                  "ffn_train_fwd_partial": ((6976, 512), (960, 768),
                                            (1013, 768))}


def check_partial(torch, what, cd, got, want, cd_names):
  """``check_outputs`` for a partial, which is not normalised: each fp32
  output divided by the plain version's largest magnitude, so that its
  rules hold relative to the partial's scale.  Returns the worst max abs
  error of the fp32 outputs, unscaled."""
  scale = {n: float(want[n].abs().max()) for n in want if n not in cd_names}
  print(f"  {what} scale (max |plain|): "
        + ", ".join(f"{n} {v:.3e}" for n, v in scale.items()), flush=True)
  div = lambda d: {n: t / scale[n] if n in scale else t for n, t in d.items()}
  check_outputs(torch, what, cd, div(got), div(want), cd_names)
  return max(float((got[n] - want[n]).abs().max()) for n in scale)


def check_b7_is_b6(torch, ffn, what, args, kw):
  """B7's partial is B6's, bit for bit, in every row tile of the route
  of the call's compute type: GEMM 1 computes g alike under both
  epilogues and GEMM 2 is the same.  Raises otherwise."""
  tiles = route_tiles(torch, ffn, kw["compute_dtype"])
  same = [torch.equal(ffn.ffn_train_fwd_partial_cuda(*args, **kw,
                                                     tile=t)[0],
                      ffn.ffn_partial_cuda(*args, **kw, tile=t))
          for t in range(len(tiles))]
  print(f"  {what} out bitwise equal to ffn_partial's by row tile "
        f"{tiles}: {same}", flush=True)
  if not all(same):
    raise RuntimeError(f"{what}: B7's partial differs from B6's")


def partial_kernel_phase(torch, ffn, dropout, dev, gen, card):
  """B6 and B7, and B3 with add_dz off on B7's residuals, against their
  plain versions at the two-rank shapes (I/mp = 1536), bf16 and fp32; on
  a route B7 also against its WMMA / FMA kernel (``tile=-1``) and B6, and
  on the fp32 route B6 against the FMA kernel bit for bit (both take each
  output as one ascending-k fmaf chain).  Returns B6's and B7's line
  entries: the worst bf16 error, the video-shape bf16 times and bound (no
  single PyTorch call computes either), and each fp32 case's times."""
  res = {name: {"max_abs_err": 0.0, "library_ms": None}
         for name in PARTIAL_SHAPES}
  i = TP_I
  for cd in (torch.bfloat16, torch.float32):
    for kname, shapes in PARTIAL_SHAPES.items():
      train = kname == "ffn_train_fwd_partial"
      kfn, pfn = getattr(ffn, f"{kname}_cuda"), getattr(ffn, f"{kname}_plain")
      names = ("out", "inter") if train else ("out",)
      outs = lambda t: dict(zip(names, t if train else (t,)))
      for r, h in shapes:
        rand = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
        x = rand(r, h)
        w1, w2 = (rand(i, h) * 0.02).to(cd), (rand(h, i) * 0.02).to(cd)
        args, kw = (x, w1, rand(i) * 0.02, w2), dict(compute_dtype=cd)
        tag = f"R={r} H={h} I={i} {str(cd).replace('torch.', '')}"
        f32 = cd == torch.float32
        route = on_route(torch, ffn, h, i, cd)
        got, want = outs(kfn(*args, **kw)), outs(pfn(*args, **kw))
        torch.cuda.synchronize()
        err = check_partial(torch, f"{kname} {tag}", cd, got, want,
                            ("inter",))
        ms = time_ms(torch, lambda: kfn(*args, **kw))
        plain_ms = time_ms(torch, lambda: pfn(*args, **kw))
        b_ms, b_by = bound(4 * r * h * i, H100_FP32 if f32 else H100_BF16,
                           args + tuple(got.values()))
        split = device_split(torch, lambda: kfn(*args, **kw))
        dev_ms = sum(split.values())
        extra = (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                 "TFLOP/s) by kernel {" + ", ".join(
                     f"{short_kernel_name(k)}: {v:.4f}"
                     for k, v in split.items()) + "}")
        if cd == torch.bfloat16 and not train:
          extra += (f" gemms_ms={gemms_ms(torch, x, w1, w2):.4f} (two bf16 "
                    "torch.mm alone)")
        witness = (kfn(*args, **kw, tile=-1) if route and (f32 or train)
                   else None)
        if route and f32 and not train:
          same = torch.equal(got["out"], witness)
          print(f"  {kname} {tag} out bitwise equal to the FMA kernel's: "
                f"{same}", flush=True)
          if not same:
            raise RuntimeError(f"{kname} {tag}: the fp32 route's partial "
                               "differs from the FMA kernel's")
        if route and train:
          name = "FMA" if f32 else "WMMA"
          check_partial(torch, f"{kname} {tag} vs {name} kernel", cd, got,
                        outs(witness), ("inter",))
          check_b7_is_b6(torch, ffn, f"{kname} {tag}", args, kw)
          if not f32:
            wmma = lambda: kfn(*args, **kw, tile=-1)
            extra += (f" wmma_ms={time_ms(torch, wmma):.4f} wmma_device_ms="
                      f"{device_ms(torch, wmma):.4f} host_ms="
                      f"{host_ms(torch, lambda: kfn(*args, **kw))}")
        fma_ms = None
        if route and f32:
          fma_ms = time_ms(torch, lambda: kfn(*args, **kw, tile=-1), FMA_REPS)
          extra += f" fma_ms={fma_ms:.4f} ({fma_ms / dev_ms:.2f}x)"
        label = route_label(torch, ffn, r, h, i, cd, dev)
        print(f"{kname} {tag} ({label} route): "
              f"kernel_ms={ms:.4f} ({tflops(r, h, i, ms):.1f} TFLOP/s) "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}){extra} "
              f"card: {card}", flush=True)
        if route and r != 1013:
          check_tiles_equal(torch, ffn, f"{kname} {tag}", kfn, args, kw)
        if cd == torch.bfloat16:
          res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], err)
          if (r, h) == shapes[0]:
            res[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, device_ms=dev_ms)
        elif route:
          res[kname].setdefault("fp32_shapes", []).append(
              {"shape": f"{r} x {h}, I {i}", "route": label,
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "fma_ms": fma_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None})
        if not train:
          continue
        # B3 as the tensor-parallel backward runs it, on B7's residuals.
        drop = dropout.dropout_mask((r, h), TRAIN_P, gen, dev)
        z = (want["out"] + x).to(cd)
        bargs = (rand(r, h), z, want["inter"], drop, w1, w2,
                 1.0 + 0.1 * rand(h))
        bkw = dict(eps=1e-12, compute_dtype=cd, add_dz=False)
        got_b, _ = check_train_kernel(
            torch, ffn, f"ffn_train_bwd add_dz=False {tag}", "ffn_train_bwd",
            cd, bargs, bkw, i, check_partial)
        kernel = lambda tile=None: ffn.ffn_train_bwd_cuda(*bargs, **bkw,
                                                          tile=tile)
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch,
                           lambda: ffn.ffn_train_bwd_plain(*bargs, **bkw))
        b_ms, b_by = bound(4 * r * h * i, H100_FP32 if f32 else H100_BF16,
                           bargs + tuple(got_b))
        extra = ""
        if ffn.gemm_route(h, i, cd):
          dev_ms, wmma = device_ms(torch, kernel), lambda: kernel(-1)
          extra = (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                   f"TFLOP/s) wmma_ms={time_ms(torch, wmma):.4f} "
                   f"wmma_device_ms={device_ms(torch, wmma):.4f}")
        elif ffn.f32_route(h, i, cd):
          dev_ms = device_ms(torch, kernel)
          fma_ms = time_ms(torch, lambda: kernel(-1), FMA_REPS)
          extra = (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                   f"TFLOP/s) fma_ms={fma_ms:.4f} ({fma_ms / dev_ms:.2f}x)")
        print(f"ffn_train_bwd add_dz=False {tag}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}){extra} "
              f"card: {card}", flush=True)
  return res


# The walls are the counted eval's and the 2 replication steps' (recorded,
# no gate; cut from 2 more evals and 5 more steps).
TP_EVAL_VIDEOS = N_VIDEOS
TP_TIMEOUT = 900.0
# TP eval sims against the single-device kernel path: only the order of
# the FFN's fp32 sums and one bf16 rounding of the reduced partial differ,
# which moved the sims by 6.8e-4 at most on an H100 (about as far as the
# kernel path is from the plain one); 5e-3 leaves room for that, not for a
# wrong shard, bias or reduce.
TP_SIMS_TOL = 5e-3
# The fp32 all-reduces of the TP path, [rows, H] with the count of each
# per eval (20 chunks of 50: 2 per layer, forward only) and per step (4
# per layer: 2 forward, 2 backward): video then text tower.
TP_REDUCES = {"eval": (((50 * 218, 512), 2 * 4 * 20), ((50 * 30, 768),
                                                       2 * 12 * 20)),
              "step": (((32 * 218, 512), 4 * 4), ((32 * 30, 768), 4 * 12))}
# The launch counters a rank reads, by the names of the kernels line.
COUNTED = {"ffn_block": "ffn_block_cuda", "ffn_partial": "ffn_partial_cuda",
           "ffn_train_fwd": "ffn_train_fwd_cuda",
           "ffn_train_fwd_partial": "ffn_train_fwd_partial_cuda",
           "ffn_train_bwd": "ffn_train_bwd_cuda"}


def tp_rank(tp, device, tiny, videos):
  """One rank of the tensor-parallel phase (run by ``parallel.spawn``):
  the 1k x 1k eval of the slice phase and the b32 step of the train-step
  phase on this rank's shards of the same model.  Returns numpy arrays
  and Python values; the gathered gradients on rank 0 only."""
  import hashlib

  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from mmt_tpu_torch import bench, convert, evaluate, flagship
  from mmt_tpu_torch.ops import ffn, similarity
  from mmt_tpu_torch.train import losses, optim, step

  dev = torch.device(device)
  counters = {n: getattr(ffn, f) for n, f in COUNTED.items()}
  counters["moe_similarity"] = similarity.sim_cuda

  def reset():
    for fn in counters.values():
      fn.launches = 0

  def sync():
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)

  def timed(fn):
    sync()
    tic = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - tic

  out = {}
  model, batches = bench.staged_flagship(dev, tiny=tiny, videos=videos,
                                         tp=tp)
  reset()
  sync()
  tic = time.perf_counter()
  res = evaluate.retrieval_eval(model, batches)
  sync()
  out["eval_wall_s"] = [time.perf_counter() - tic]
  out["eval_launches"] = {n: fn.launches for n, fn in counters.items()}
  out["sims"] = res["sims"].cpu().numpy()
  del model, batches, res

  arch = flagship.flagship_arch(tiny=tiny)
  model = flagship.flagship_model(device=dev, compute_dtype=torch.bfloat16,
                                  seed=0, tiny=tiny, train=True, tp=tp)
  vocab = dict(vocab=bench.TINY_VOCAB) if tiny else {}
  batch = flagship.batch_to_torch(flagship.make_batch(
      arch["expert_dims"], TRAIN_BATCH, seed=101, **vocab), dev)
  opt = optim.build_optimizer({"type": "Adam", "args": {
      "lr": TRAIN_LR, "weight_decay": 0}}, model.parameters())[0]
  loss_fn = losses.max_margin_ranking_loss(0.05, True)

  def run(seed):
    return step.train_step(model, opt, batch, loss_fn=loss_fn, lr=TRAIN_LR,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))

  reset()
  out["loss"] = float(run(7))      # the train-step phase's counted step
  sync()
  out["step_launches"] = {n: fn.launches for n, fn in counters.items()}
  grads = convert.gather_state_dict(
      {n: p.grad for n, p in model.named_parameters()}, tp,
      model.shard_dims)
  out["grads"] = ({n: g.numpy() for n, g in grads.items()} if tp.rank == 0
                  else None)
  del grads
  # Two more steps, timed (no claim of speed), then the replicas.
  out["step_wall_s"] = [timed(lambda s=s: run(s)) for s in (8, 9)]
  out["replicated"] = {
      n: hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
      for n, t in [*model.named_parameters(), *model.named_buffers()]
      if n not in model.shard_dims}
  del model, opt, batch

  # One fp32 all-reduce of each shape the path reduces, mean of 10.
  out["reduce_s"] = {}
  for what, shapes in TP_REDUCES.items():
    for shape, _ in shapes:
      x = torch.ones(shape, device=dev)
      tp.all_reduce(x)
      out["reduce_s"][shape] = sum(timed(lambda: tp.all_reduce(x))
                                   for _ in range(10)) / 10
  return out


def check_tp_launches(results):
  """Per rank: 320 B6 and 0 B1 per eval (>= 1 B4); 16 B7 and 16 B3, 0
  B1, B2 and B6 per step (>= 1 B4)."""
  n_eval = FFN_LAYERS * (TP_EVAL_VIDEOS // CHUNK)
  none = dict(ffn_partial=0, ffn_block=0, ffn_train_fwd=0,
              ffn_train_fwd_partial=0, ffn_train_bwd=0)
  want_ev = dict(none, ffn_partial=n_eval)
  want_st = dict(none, ffn_train_fwd_partial=FFN_LAYERS,
                 ffn_train_bwd=FFN_LAYERS)
  for rank, r in enumerate(results):
    ev, st = r["eval_launches"], r["step_launches"]
    print(f"tp rank {rank} launches: eval {ev}; step {st}", flush=True)
    if (any(ev[n] != v for n, v in want_ev.items())
        or any(st[n] != v for n, v in want_st.items())
        or ev["moe_similarity"] < 1 or st["moe_similarity"] < 1):
      raise RuntimeError(f"tp rank {rank}: expected eval launches {want_ev} "
                         f"and step launches {want_st} (>= 1 B4 each), got "
                         f"{ev} and {st}")


def check_tp_ranks(torch, ranking, sims, ref):
  """The ranks of the tensor-parallel sims against the single-device
  ones.  Prints whether the rank rule of phase 3 holds (every rank within
  1, on < 1e-3 of queries; random weights pack the sims so tightly that
  it is not expected to); raises unless every difference is one that
  sims within TP_SIMS_TOL allow: a candidate can change sides of the GT
  only if their two similarities lie within 2 x TP_SIMS_TOL of each
  other, so a rank may move by at most the number of such candidates."""
  n = sims.shape[0]
  masks = torch.ones(n, 1, device=sims.device)
  d = TP_SIMS_TOL
  gt = torch.arange(n, device=sims.device)
  ranks = {"t2v": lambda a: ranking.t2v_ranks(a),
           "v2t": lambda a: ranking.v2t_ranks(a, masks)}
  for orient, rows in (("t2v", ref), ("v2t", ref.T)):
    got, want = ranks[orient](sims), ranks[orient](ref)
    worst, frac, same_inf = rank_agreement(torch, got, want)
    g = rows.gather(1, gt[:, None])
    slack = ((rows - g).abs() <= 2 * d).sum(1) - 1
    explained = bool(((got - want).abs() <= slack).all())
    print(f"  tp eval {orient} ranks vs single device: worst rank diff "
          f"{worst} on {frac:.3e} of queries (the 1 / 1e-3 rule "
          f"{'met' if worst <= 1 and frac < 1e-3 else 'NOT met'}); every "
          f"difference within the candidates that lie within 2 x {d:.0e} "
          f"of the GT: {explained} (at most "
          f"{int(slack.max())} such candidates); same inf positions "
          f"{same_inf}", flush=True)
    if not explained or not same_inf:
      raise RuntimeError(f"tp eval {orient}: ranks differ beyond the "
                         "rounding of the sims")


def tp_phase(torch, parallel, ranking, ref_sims, step_ref, dev, card):
  """The tensor-parallel eval and train step on two gloo ranks sharing the
  card, against the slice phase's kernel-path sims and the train-step
  phase's kernel step.  Returns the launches of B6 (per eval) and B7 (per
  step) on rank 0."""
  tic = time.perf_counter()
  results = parallel.spawn(tp_rank, TP_SIZE, "cuda", False, TP_EVAL_VIDEOS,
                           timeout=TP_TIMEOUT)
  print(f"tp: {TP_SIZE} gloo ranks sharing one card ran in "
        f"{time.perf_counter() - tic:.1f} s", flush=True)
  check_tp_launches(results)

  sims = [torch.from_numpy(r["sims"]).to(dev) for r in results]
  if not torch.equal(sims[0], sims[1]):
    raise RuntimeError("tp eval: the ranks' sims differ")
  if not bool(torch.isfinite(sims[0]).all()):
    raise RuntimeError("tp eval: non-finite sims")
  diff = float((sims[0] - ref_sims).abs().max())
  print(f"tp eval {TP_EVAL_VIDEOS} x {TP_EVAL_VIDEOS}: sims vs the slice "
        f"phase's kernel path max_abs_diff={diff:.3e} (limit "
        f"{TP_SIMS_TOL:.0e}; the sims' spread: std {float(ref_sims.std()):.3e}"
        f", range {float(ref_sims.max() - ref_sims.min()):.3e})", flush=True)
  if diff > TP_SIMS_TOL:
    raise RuntimeError(f"tp eval sims differ by {diff} > {TP_SIMS_TOL}")
  check_tp_ranks(torch, ranking, sims[0], ref_sims)

  loss_ref, grads_ref = step_ref
  for rank, r in enumerate(results):
    if not abs(r["loss"] - loss_ref) <= STEP_LOSS_TOL:
      raise RuntimeError(f"tp rank {rank} loss {r['loss']} vs {loss_ref}")
  check_step(torch, "tp train step vs single-device kernel step",
             results[0]["loss"], loss_ref,
             {n: torch.from_numpy(g) for n, g in results[0]["grads"].items()},
             grads_ref)
  a, b = (r["replicated"] for r in results)
  same = [n for n in a if a[n] == b.get(n)]
  print(f"tp: after 3 steps {len(same)} of {len(a)} replicated parameters "
        "and buffers bitwise equal on both ranks", flush=True)
  if len(same) != len(a) or set(a) != set(b):
    raise RuntimeError("tp: replicated parameters differ across ranks: "
                       f"{sorted(set(a) - set(same))[:5]}")
  for what in ("eval", "step"):
    runs = [[round(x, 6) for x in r[f"{what}_wall_s"]] for r in results]
    wall = statistics.median(results[0][f"{what}_wall_s"])
    reduce_s = results[0]["reduce_s"]
    in_reduces = sum(n * reduce_s[shape] for shape, n in TP_REDUCES[what])
    print(f"tp {what} wall (two gloo ranks sharing one card, per rank): "
          f"{runs}; median rank 0 {wall:.6f} s, of which its "
          f"{sum(n for _, n in TP_REDUCES[what])} all-reduces take about "
          f"{in_reduces:.6f} s (" + ", ".join(
              f"{n} x {list(shape)} at {reduce_s[shape] * 1e3:.3f} ms"
              for shape, n in TP_REDUCES[what]) + f") card: {card}",
          flush=True)
  return {"ffn_partial": results[0]["eval_launches"]["ffn_partial"],
          "ffn_train_fwd_partial":
              results[0]["step_launches"]["ffn_train_fwd_partial"]}


# Phase 14: data parallelism, two ranks sharing the card over gloo.
DP_SIZE = 2
DP_TIMEOUT = 900.0
# B2 and B3 at a rank's rows of the b32 step: 16 videos x 218 tokens and
# 16 captions x 30 tokens.
DP_SHAPES = ((TRAIN_BATCH // DP_SIZE * 218, 512),
             (TRAIN_BATCH // DP_SIZE * 30, 768))
# (b): seeded fp32 embeddings, an uneven corpus, so one video pads.
DP_RANK_VIDEOS, DP_RANK_CAPS, DP_RANK_SEED = 20_001, 2, 14
# The launch counters a DP rank reads, by the names of the kernels line.
DP_COUNTED = {"ffn_block": ("ffn", "ffn_block_cuda"),
              "ffn_partial": ("ffn", "ffn_partial_cuda"),
              "ffn_train_fwd": ("ffn", "ffn_train_fwd_cuda"),
              "ffn_train_fwd_partial": ("ffn", "ffn_train_fwd_partial_cuda"),
              "ffn_train_bwd": ("ffn", "ffn_train_bwd_cuda"),
              "moe_similarity": ("similarity", "sim_cuda"),
              "fused_ranks": ("ranking", "fused_counts_cuda")}


def dp_counters():
  """{kernels-line name: wrapper} of every counted kernel."""
  from mmt_tpu_torch.ops import ffn, ranking, similarity
  mods = {"ffn": ffn, "similarity": similarity, "ranking": ranking}
  return {n: getattr(mods[m], f) for n, (m, f) in DP_COUNTED.items()}


def dp_kernel_cases(torch, ffn, dropout, dev, gen, card):
  """Phase 14 (a): B2 and B3 (add_dz on) at a DP rank's row counts, bf16,
  against their plain versions (and the WMMA kernel, every row tile
  bitwise equal) by phase 4's rules.  Returns the worst error of each."""
  errs = {"ffn_train_fwd": 0.0, "ffn_train_bwd": 0.0}
  cd, i = torch.bfloat16, TRAIN_I
  for r, h in DP_SHAPES:
    fargs, dy = train_inputs(torch, dropout, r, h, cd, dev, gen)
    _, drop, w1, _, w2, _, gamma, _ = fargs
    kw = dict(eps=1e-12, compute_dtype=cd)
    tag = f"R={r} H={h} I={i} bfloat16 (a DP rank's rows, tile " \
          f"{ffn.pick_gemm_tile(r, h, torch.cuda.get_device_properties(dev).multi_processor_count)})"
    _, err_f = check_train_kernel(torch, ffn, f"dp ffn_train_fwd {tag}",
                                  "ffn_train_fwd", cd, fargs, kw)
    _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
    _, err_b = check_train_kernel(
        torch, ffn, f"dp ffn_train_bwd {tag}", "ffn_train_bwd", cd,
        (dy, z, inter, drop, w1, w2, gamma), dict(kw, add_dz=True))
    errs["ffn_train_fwd"] = max(errs["ffn_train_fwd"], err_f)
    errs["ffn_train_bwd"] = max(errs["ffn_train_bwd"], err_b)
    print(f"dp kernels at {r} x {h}: B2 max_abs_err={err_f:.3e} B3 "
          f"max_abs_err={err_b:.3e} card: {card}", flush=True)
  return errs


def dp_rank_inputs(torch, dev, videos):
  """(b)'s corpus on ``dev`` from DP_RANK_SEED: unit-norm fp32 text [V *
  caps, 7, 512] and video [V, 7, 512] embeddings, L1 weights, and query
  masks with about a fifth of the second caption slots masked."""
  gen = torch.Generator(device=dev).manual_seed(DP_RANK_SEED)
  m, d, caps = 7, 512, DP_RANK_CAPS

  def unit(n):
    x = torch.randn(n, m, d, generator=gen, device=dev)
    return x / x.norm(dim=-1, keepdim=True)

  def weights(n):
    w = torch.rand(n, m, generator=gen, device=dev)
    return w / w.sum(1, keepdim=True)

  te, ve = unit(videos * caps), unit(videos)
  tw, vw = weights(videos * caps), weights(videos)
  masks = (torch.rand(videos, caps, generator=gen, device=dev) > 0.2).float()
  masks[:, 0] = 1.0
  return te, ve, tw, vw, masks


def dp_rank(dp, device, tiny, videos):
  """One rank of phase 14 (run by ``parallel.spawn``): (a) the b32 step of
  the train-step phase from its state, batch and dropout seed on this
  rank's 16 rows, 3 steps, then the step's wall time, one all-reduce of
  the gradients' flat buffer and the gathers of the step's outputs; (b)
  the candidate-sharded fused ranks of ``videos`` seeded videos, then
  this rank's counts against the plain version on its staged shard.
  Returns numpy arrays and Python values (the gradients on rank 0
  only)."""
  import hashlib

  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from mmt_tpu_torch import bench, flagship
  from mmt_tpu_torch.ops import ranking, similarity
  from mmt_tpu_torch.parallel import mesh as mesh_lib
  from mmt_tpu_torch.train import losses, optim, step

  dev = torch.device(device)
  counters = dp_counters()

  def reset():
    for fn in counters.values():
      fn.launches = 0

  def counts():
    return {n: fn.launches for n, fn in counters.items()}

  def sync():
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)

  def timed(fn):
    sync()
    tic = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - tic

  out = {}
  arch = flagship.flagship_arch(tiny=tiny)
  model = flagship.flagship_model(device=dev, compute_dtype=torch.bfloat16,
                                  seed=0, tiny=tiny, train=True)
  vocab = dict(vocab=bench.TINY_VOCAB) if tiny else {}
  batch = flagship.batch_to_torch(mesh_lib.local_rows(flagship.make_batch(
      arch["expert_dims"], TRAIN_BATCH, seed=101, **vocab), dp), dev)
  opt = optim.build_optimizer({"type": "Adam", "args": {
      "lr": TRAIN_LR, "weight_decay": 0}}, model.parameters())[0]
  loss_fn = losses.max_margin_ranking_loss(0.05, True)

  def run(seed):
    return step.train_step(model, opt, batch, loss_fn=loss_fn, lr=TRAIN_LR,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed), dp=dp)

  reset()
  out["loss"] = float(run(7))      # the train-step phase's counted step
  sync()
  out["step_launches"] = counts()
  out["grads"] = ({n: p.grad.cpu().numpy()
                   for n, p in model.named_parameters()}
                  if dp.primary else None)
  # Two more steps, timed (no claim of speed), then the replicas.
  out["step_wall_s"] = [timed(lambda s=s: run(s)) for s in (8, 9)]
  out["state"] = {
      n: hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
      for n, t in [*model.named_parameters(), *model.named_buffers()]}
  with torch.no_grad():
    outputs = model(batch)
  flat = torch.ones(sum(p.numel() for p in model.parameters()), device=dev)
  out["reduce_s"] = min(timed(lambda: dp.reduce_(flat)) for _ in range(3))
  out["gather_s"] = min(timed(lambda: [dp.all_gather(v)
                                       for v in outputs.values()])
                        for _ in range(3))
  out["params"] = flat.numel()
  del model, opt, batch, outputs, flat
  torch.cuda.empty_cache()

  # (b) Every rank holds the whole corpus on the host and counts its
  # candidate shard; B5 timed by CUDA events around each counts call.
  te, ve, tw, vw, masks = (x.cpu().numpy()
                           for x in dp_rank_inputs(torch, dev, videos))
  torch.cuda.empty_cache()
  events, calls = [], []
  plain_counts = ranking.fused_counts

  def timed_counts(*args):
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    res = plain_counts(*args)
    end.record()
    events.append((start, end))
    calls.append((args, res))
    return res

  reset()
  ranking.fused_counts = timed_counts
  try:
    tic = time.perf_counter()
    t2v = ranking.sharded_t2v_ranks(te, ve, tw, vw, dp, dev)
    v2t = ranking.sharded_v2t_ranks(te, ve, tw, vw, masks, dp, dev)
    sync()
    out["ranks_wall_s"] = time.perf_counter() - tic
  finally:
    ranking.fused_counts = plain_counts
  out["rank_launches"] = counts()
  out["b5_ms"] = [s.elapsed_time(e) for s, e in events]
  out["t2v"], out["v2t"] = t2v.cpu().numpy(), v2t.cpu().numpy()
  # This rank's counts against the plain version on the same staged shard
  # (its pad, and GT columns outside the shard), by phase 3's rules.
  out["shard_worst"] = 0.0
  for n_call, (args, got) in enumerate(calls):
    want = ranking.fused_counts_plain(*args)
    what = (f"dp rank {dp.rank} shard counts call {n_call} "
            f"({args[0].shape[0]} x {args[1].shape[0]})")
    out["shard_worst"] = max(out["shard_worst"], check_rank_rule(
        torch, f"{what} kernel vs plain", got[0] + got[1] / 2,
        want[0] + want[1] / 2))
    check_counts_witness(torch, ranking, what, args, got, want,
                         similarity.sim_cuda)
  return out


def check_dp_launches(results):
  """Per rank, (a): exactly 16 B2, 16 B3 and 1 B4, no other kernel; (b):
  1 + caps B5 and no other kernel."""
  none = {n: 0 for n in DP_COUNTED}
  want_st = dict(none, ffn_train_fwd=FFN_LAYERS, ffn_train_bwd=FFN_LAYERS,
                 moe_similarity=1)
  want_rk = dict(none, fused_ranks=1 + DP_RANK_CAPS)
  for rank, r in enumerate(results):
    st, rk = r["step_launches"], r["rank_launches"]
    print(f"dp rank {rank} launches: step {st}; sharded ranks {rk}",
          flush=True)
    if st != want_st or rk != want_rk:
      raise RuntimeError(f"dp rank {rank}: expected step launches {want_st} "
                         f"and sharded-rank launches {want_rk}, got {st} and "
                         f"{rk}")


def first_rank_difference(torch, ranking, similarity, what, got, want,
                          args, shard_cands):
  """Print the first query whose sharded rank differs from the unsharded
  one, with its similarities from the tile of each call (B4 in the tile
  that ``pick_tile`` gives the whole and the shard), then raise."""
  q = int((got != want).nonzero()[0])
  queries, cands, qw, cw, gt = args
  sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
  rows = {}
  for name, nc in (("whole", cands.shape[0]), ("shard", shard_cands)):
    tile = similarity.pick_tile(queries.shape[0], nc, sms)
    rows[name] = similarity.sim_cuda(queries[q:q + 1], cands, qw[q:q + 1],
                                     cw, tile=tile)[0]
  near = ((rows["whole"] - gt[q]).abs() <= 1e-6).nonzero().flatten()[:8]
  print(f"dp {what}: query {q} sharded rank {float(got[q])} vs unsharded "
        f"{float(want[q])}; GT sim {float(gt[q]):.9e}; sims of the two "
        f"tiles max_abs_diff {float((rows['whole'] - rows['shard']).abs().max()):.3e}; "
        f"candidates within 1e-6 of the GT {near.tolist()}: whole "
        f"{rows['whole'][near].tolist()} shard {rows['shard'][near].tolist()}",
        flush=True)
  raise RuntimeError(f"dp {what}: the sharded ranks differ from the "
                     "unsharded kernel ranks")


def dp_phase(torch, parallel, ranking, similarity, step_ref, dev, card):
  """Phase 14 (a) and (b) on two gloo ranks sharing the card, against the
  train-step phase's kernel step and the single-process kernel ranks (and
  each rank's shard counts against the plain version).  Returns the
  launches per rank of (a) and (b), and the worst rank difference of the
  shard counts against the plain version."""
  tic = time.perf_counter()
  results = parallel.spawn(dp_rank, DP_SIZE, dev.type, False,
                           DP_RANK_VIDEOS, timeout=DP_TIMEOUT)
  print(f"dp: {DP_SIZE} gloo ranks sharing one card ran in "
        f"{time.perf_counter() - tic:.1f} s", flush=True)
  check_dp_launches(results)

  # (a) The step against the single-process kernel step.
  loss_ref, grads_ref = step_ref
  for rank, r in enumerate(results):
    if not abs(r["loss"] - loss_ref) <= STEP_LOSS_TOL:
      raise RuntimeError(f"dp rank {rank} loss {r['loss']} vs {loss_ref}")
  check_step(torch, "dp train step vs single-device kernel step",
             results[0]["loss"], loss_ref,
             {n: torch.from_numpy(g) for n, g in results[0]["grads"].items()},
             grads_ref)
  a, b = (r["state"] for r in results)
  same = [n for n in a if a[n] == b.get(n)]
  print(f"dp: after 3 steps {len(same)} of {len(a)} parameters and buffers "
        "bitwise equal on both ranks", flush=True)
  if len(same) != len(a) or set(a) != set(b):
    raise RuntimeError("dp: the replicas differ: "
                       f"{sorted(set(a) - set(same))[:5]}")
  r0 = results[0]
  print(f"dp train step b{TRAIN_BATCH} ({TRAIN_BATCH // DP_SIZE} rows a "
        f"rank; two gloo ranks sharing one card, a correctness path, no "
        f"claim of speed): wall per rank "
        f"{[[round(x * 1e3, 3) for x in r['step_wall_s']] for r in results]}"
        f" ms; rank 0's gloo all-reduce of the {r0['params']:,}-float "
        f"gradient buffer {r0['reduce_s'] * 1e3:.3f} ms, its gathers of the "
        f"4 outputs {r0['gather_s'] * 1e3:.3f} ms card: {card}", flush=True)

  # (b) The sharded ranks against the single-process kernel ranks.
  te, ve, tw, vw, masks = dp_rank_inputs(torch, dev, DP_RANK_VIDEOS)
  want = {"t2v": ranking.fused_t2v_ranks(te, ve, tw, vw),
          "v2t": ranking.fused_v2t_ranks(te, ve, tw, vw, masks)}
  shard = -(-DP_RANK_VIDEOS // DP_SIZE)
  for what, w in want.items():
    for rank, r in enumerate(results):
      got = torch.from_numpy(r[what]).to(dev)
      same = bool(torch.equal(got, w))
      print(f"dp sharded {what} ranks, rank {rank}: equal to the "
            f"single-process kernel ranks: {same} ({w.numel()} queries, "
            f"{int(torch.isinf(w).sum())} inf)", flush=True)
      if not same:
        t, tw_ = ranking._scaled_flat(te, tw)
        v, vw_ = ranking._scaled_flat(ve, vw)
        if what == "t2v":
          gtcol = torch.arange(t.shape[0], device=dev) // DP_RANK_CAPS
          args = (t, v, tw_, vw_, ranking._gt_sims(t, v, tw_, vw_, gtcol))
          first_rank_difference(torch, ranking, similarity, what, got, w,
                                args, shard)
        gtcol = torch.arange(v.shape[0], device=dev) * DP_RANK_CAPS
        args = (v, t, vw_, tw_, ranking._gt_sims(v, t, vw_, tw_, gtcol))
        first_rank_difference(torch, ranking, similarity, what, got, w,
                              args, shard * DP_RANK_CAPS)
  for rank, r in enumerate(results):
    print(f"dp sharded ranks rank {rank}: {len(r['b5_ms'])} B5 launches, "
          f"ms {[round(x, 4) for x in r['b5_ms']]} (the wrapper: k-major "
          f"fill and kernel) on {shard} of {DP_RANK_VIDEOS} videos / "
          f"{shard * DP_RANK_CAPS} caption slots; the whole call with "
          f"staging and all-reduce {r['ranks_wall_s']:.3f} s card: {card}",
          flush=True)
  shard_worst = max(r["shard_worst"] for r in results)
  print(f"dp sharded counts: each rank's B5 calls against the plain version "
        f"on its staged shard, worst rank diff {shard_worst}", flush=True)
  del te, ve, tw, vw, masks, want
  torch.cuda.empty_cache()
  return {"a": r0["step_launches"], "b": r0["rank_launches"]}, shard_worst


# Kernels of the eval block B1 (csrc/ffn_block.cu): the GEMM route's
# cast, two GEMMs and LayerNorm row pass, and the WMMA kernel of other
# widths.  Names as the profiler reports them contain these.
B1_KERNELS = ("ffn_cast_bf16_kernel", "ffn_tn_gemm_kernel",
              "ffn_ln_rows_kernel", "ffn_block_bf16_kernel")
PROFILE_TOP = 10


def check_profile(res, want, what):
  """A ``profile_eval`` breakdown: each family's launches a run equal
  ``want`` (the others 0), its rows sum to its device total, its idle
  share in [0, 1]; prints the rollup."""
  expected = dict.fromkeys(res["launches"], 0)
  expected.update(want)
  rows_ms = sum(r["ms_per_run"] for r in res["rows"])
  print(f"{what}: launches a run {res['launches']} (the counters', each "
        f"family's kernels recorded as often); device {res['device_ms']:.3f}"
        f" ms a run, the rows' sum {rows_ms:.3f}, wall {res['wall_ms']:.3f}"
        f", idle share {res['idle']:.4f}; rollup " + ", ".join(
            f"{cat} {ms:.3f} ms ({ms / res['device_ms']:.2%})"
            for cat, ms in res["rollup"].items()), flush=True)
  if res["launches"] != expected:
    raise RuntimeError(f"{what}: launches a run {res['launches']}, not "
                       f"{expected}")
  if (not math.isclose(rows_ms, res["device_ms"], rel_tol=1e-9)
      or not 0 <= res["idle"] <= 1 or not res["device_ms"] > 0):
    raise RuntimeError(f"{what}: rows {rows_ms} against the device total "
                       f"{res['device_ms']}, idle {res['idle']}")


def profile_phase(profile_eval, alone, card):
  """``python -m mmt_tpu_torch.profile_eval --mode eval`` at full width:
  bench's eval-1k (the slice phase's model and inputs, made again from
  their seeds), one run under torch.profiler.  It launches exactly 320
  B1 and 1 B4, which the profiler recorded as often (``check_profile``);
  B1's kernels in situ against their kernel-phase time alone times the
  launches."""
  res = profile_eval.main(["--mode", "eval", "--reps", "1", "--top",
                          str(PROFILE_TOP)])
  chunks = N_VIDEOS // CHUNK
  check_profile(res, {"B1": FFN_LAYERS * chunks, "B4": 1},
                "profile eval-1k")
  b1 = [r for r in res["rows"] if any(k in r["key"] for k in B1_KERNELS)]
  b1_ms = sum(r["ms_per_run"] for r in b1)
  # 20 chunks: 4 video blocks of 10,900 x 512 and 12 text blocks of
  # 1,500 x 768 each; alone[shape] is (event ms, device ms) of one call.
  alone_ms = [chunks * (4 * alone[(10900, 512)][k]
                        + 12 * alone[(1500, 768)][k]) for k in (0, 1)]
  print(f"profile: B1 in situ {b1_ms:.3f} ms a run ({b1_ms / res['device_ms']:.2%} "
        f"of device time; {sum(r['per_run'] for r in b1):g} kernels a run) "
        f"against the kernel phase's time alone x launches: CUDA events "
        f"{alone_ms[0]:.3f} ms (in situ / alone {b1_ms / alone_ms[0]:.4f}), "
        f"device time {alone_ms[1]:.3f} ms ({b1_ms / alone_ms[1]:.4f}) "
        f"card: {card}", flush=True)
  for r in b1:
    print(f"  B1 kernel {r['ms_per_run']:.3f} ms x{r['per_run']:g} "
          f"{r['name']}", flush=True)
  return res


# Phase 11: the flagship trained through the port's CLI and real loader.
CLI_TRAIN_VIDEOS, CLI_VAL_VIDEOS = 1000, 32   # cut c: train 1,000, val 32
CLI_MAX_FEATS, CLI_CAPTIONS = 30, 3
CLI_VOCAB = 28996                             # bert-base-cased's table
CLI_SAMPLES_PER_EPOCH = 256                   # 8 steps of b32 an epoch
CLI_CORPUS_LIMIT_S = 60.0
FLAGSHIP_CONFIG = "configs/eccv20/msrvtt_jsfusion_trainval.json"
# The pickle layout files these as "<name>_c" (the challenge's experts);
# phase 11 reads them under the flagship's names, so all 7 are read.
CLI_COUNTED = {"ffn_block": "ffn_block_cuda",
               "ffn_train_fwd": "ffn_train_fwd_cuda",
               "ffn_train_bwd": "ffn_train_bwd_cuda"}


# Phase 11 (e) and the real loop against run D, the recorded run of
# phase 11 on the Python path (H100 80GB HBM3, 700.00 W; PERF.md).
RUN_D = {"window_ms": 377.012, "median_ms": 173.112,
         "data_loading_ms": 40.763, "eval_s": 3.8675}
# bench_loader's protocol at under a third of its default depth
# (--batches 20, --warm 10): time for phases 16 and 17.
LOADER_BENCH_ARGV = ["--batches", "6", "--warm", "3"]
LOADER_BENCH_LIMIT_S = 60.0
EPOCH2_STEPS = 3                    # epoch 2's first steps, printed


def loader_bench_phase(card):
  """Phase 11 (e): ``python -m mmt_tpu_torch.bench_loader`` on the card's
  host (no card work).  Returns its result."""
  from mmt_tpu_torch import bench_loader

  tic = time.perf_counter()
  res = bench_loader.run(bench_loader.parse_args(LOADER_BENCH_ARGV),
                         out=lambda line: print(f"{line} card: {card}",
                                                flush=True))
  sec = time.perf_counter() - tic
  rows = {(r["mode"], r["workers"], r["path"]): r for r in res["loader"]}
  for (mode, workers, path), r in sorted(rows.items()):
    if path == "native":
      py = rows[(mode, workers, "python")]
      print(f"loader bench: {mode} workers={workers} native / python: "
            f"cold {r['cold'] / py['cold']:.3f}x, warm "
            f"{r['warm'] / py['warm']:.3f}x card: {card}", flush=True)
  print(f"loader bench: {json.dumps(res)}", flush=True)
  print(f"loader bench: {sec:.1f} s", flush=True)
  if sec > LOADER_BENCH_LIMIT_S:
    print(f"loader bench: took over {LOADER_BENCH_LIMIT_S:.0f} s",
          flush=True)
  return res


def loader_paths_equal(cfg, dims, vocab):
  """One train and one eval batch of the config's loaders from the same
  seed, ``num_workers=0``, on the native and the Python path: every
  array bitwise equal, or raise."""
  import numpy as np

  from mmt_tpu_torch import bench_loader
  from mmt_tpu_torch.data import native_assembler as nasm
  from mmt_tpu_torch.data.loader import ExpertDataLoader

  toks = bench_loader.tokenizers(vocab)
  for key, training in (("train_sets", True),
                        ("continuous_eval_sets", False)):
    args = cfg[key][0]["args"]
    got = {}
    for path in ("python", "native"):
      nasm.set_enabled(path == "native")
      try:
        np.random.seed(0)
        ldr = ExpertDataLoader(mix=args["mix"], num_workers=0,
                               batch_size=args["batch_size"],
                               raw_input_dims=dims, training=training,
                               tokenizer=toks[path], loaded_data={})
        got[path] = next(iter(ldr["loader"]))
      finally:
        nasm.set_enabled(None)
    arrays = 0
    for name, want in got["python"].items():
      have = got["native"][name]
      pairs = ([(f"{name}/{m}", want[m], have[m]) for m in want]
               if isinstance(want, dict) else [(name, want, have)])
      for what, a, b in pairs:
        if isinstance(a, np.ndarray):
          arrays += 1
          if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError(f"train-cli: {key} batch, {what}: the native "
                               "path differs from the Python path")
    print(f"train-cli: {key} first batch (b{args['batch_size']}, "
          f"num_workers 0): native and Python path bitwise equal in all "
          f"{arrays} arrays", flush=True)


def check_tokenizer_path(trainer, native, what):
  """The run's tokenizer took only the path it was meant to."""
  texts = trainer.tokenizer.texts
  if texts["python" if native else "native"] or not sum(texts.values()):
    raise RuntimeError(f"train-cli {what}: the tokenizer's texts by path "
                       f"{texts}")


def loop_summary(seen, step0, eval0, steps, videos):
  """One 2-epoch run's loop numbers from the trainer's timers: its
  ``steps`` step timers from ``step0`` and its 3 continuous evals of
  ``videos`` videos from ``eval0``."""
  ms = {k: [x * 1e3 for x in seen[f"train_batch.{k}"][step0:step0 + steps]]
        for k in ("data_loading", "total")}
  per_epoch = CLI_SAMPLES_PER_EPOCH // 32
  parts = [[seen[k][i] for k in ("valid.embds", "valid.conf_mat",
                                 "valid.metrics")]
           for i in range(eval0, eval0 + 3)]
  eval_s = statistics.median(sum(p) for p in parts)
  embed_sim = statistics.median(p[0] + p[1] for p in parts)
  return {"data_loading_ms": statistics.median(ms["data_loading"]),
          "window_ms": statistics.mean(ms["total"]),
          "median_ms": statistics.median(ms["total"]),
          "epoch2_ms": [round(x, 3) for x in
                        ms["total"][per_epoch:per_epoch + EPOCH2_STEPS]],
          "eval_s": eval_s, "videos_s": videos / embed_sim,
          "videos": videos}


def cli_config(data_dir, save_dir, epochs, compute_dtype="bfloat16"):
  """The flagship config with only the data, splits, compute dtype,
  epochs, samples per epoch and save_dir changed; ``compute_dtype`` None
  leaves the shipped config's (unset: CENet's fp32)."""
  with open(FLAGSHIP_CONFIG) as f:
    cfg = json.load(f)
  if compute_dtype is not None:
    cfg["arch"]["args"]["compute_dtype"] = compute_dtype
  for key, split, caps in (("train_sets", "trainval", None),
                           ("continuous_eval_sets", "train", 1),
                           ("final_eval_sets", "val", 1)):
    entry = cfg[key][0]
    cfg[key] = [entry]
    mix = entry["args"]["mix"][0]
    mix.update(data_dir=str(data_dir), cut_name="c", split_name=split)
    if caps is not None:
      mix["captions_per_video"] = caps
  cfg["trainer"].update(epochs=epochs, save_dir=str(save_dir),
                        max_samples_per_epoch=CLI_SAMPLES_PER_EPOCH)
  return cfg


def val_continuous_eval(cfg):
  """``cfg`` with its continuous eval on the val split's CLI_VAL_VIDEOS
  videos in place of the 1,000 train videos: a depth cut for the runs
  whose continuous evals no measurement reads (the first run's and the
  loop breakdown's keep the 1,000)."""
  cfg["continuous_eval_sets"][0]["args"]["mix"][0]["split_name"] = "val"
  return cfg


def cli_counts(ffn, similarity):
  counts = {k: getattr(ffn, v).launches for k, v in CLI_COUNTED.items()}
  counts["moe_similarity"] = similarity.sim_cuda.launches
  return counts


def cli_run(ffn, similarity, argv, want, what):
  """cli.main(argv) with every counter set to 0 just before and read
  just after; the counts must be ``want``."""
  from mmt_tpu_torch import cli
  for name in list(CLI_COUNTED.values()):
    getattr(ffn, name).launches = 0
  similarity.sim_cuda.launches = 0
  tic = time.perf_counter()
  trainer = cli.main(argv)
  import torch
  torch.cuda.synchronize()
  wall = time.perf_counter() - tic
  got = cli_counts(ffn, similarity)
  print(f"train-cli {what}: {wall:.1f} s, n_steps {trainer.n_steps}, "
        f"launches {got}", flush=True)
  if got != want:
    raise RuntimeError(f"train-cli {what}: expected launches {want}, "
                       f"got {got}")
  return trainer


def cli_loop_breakdown(torch, trainer, card):
  """Where the loop's time goes, after the counted runs: the loaders
  alone (assembly + the CUDA prefetch, no model), then one train epoch
  and one 1,000-video eval of ``trainer`` under torch.profiler (device
  time, the device's idle share of the wall, the top device ops)."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile

  from mmt_tpu_torch.data import loader as loader_lib

  def all_experts_read(batches):
    """The batches, the first checked to hold every expert of the
    config: none read as missing."""
    for j, batch in enumerate(batches):
      if j == 0:
        ind = batch["features_ind"]
        absent = [m for m in ind if not bool(np.asarray(ind[m]).any())]
        if len(ind) != 7 or absent:
          raise RuntimeError(f"train-cli: the loader read {sorted(ind)}; "
                             f"absent from the first batch: {absent}")
      yield batch

  def drain(batches):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    n = sum(1 for _ in loader_lib.device_prefetch(batches, "cuda"))
    torch.cuda.synchronize()
    return n, time.perf_counter() - tic

  entry = trainer.data_loaders["continuous_eval_sets"][0]
  n, sec = drain(all_experts_read(iter(entry["loader"])))
  print(f"train-cli loader alone, eval: {n} batches ({CLI_TRAIN_VIDEOS} "
        f"videos, num_workers {entry['loader'].num_workers}) in {sec:.6f} s, "
        f"{CLI_TRAIN_VIDEOS / sec:.1f} videos/s card: {card}", flush=True)
  entry = trainer.data_loaders["train_sets"][0]
  steps = CLI_SAMPLES_PER_EPOCH // entry.batch_size
  n, sec = drain(itertools.islice(iter(entry["loader"]), steps))
  print(f"train-cli loader alone, train: {n} batches of {entry.batch_size} "
        f"in {sec:.6f} s, {sec * 1e3 / n:.3f} ms a batch card: {card}",
        flush=True)

  epoch = trainer.epochs + 1
  for what, run in (("train epoch", lambda: trainer._train_epoch(epoch)),
                    ("eval-1k", lambda: trainer._valid_epoch(epoch))):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      tic = time.perf_counter()
      run()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - tic) * 1e3
    dev_us = lambda e: e.self_device_time_total
    dev = sorted(device_events(prof), key=dev_us, reverse=True)
    total_ms = sum(map(dev_us, dev)) / 1e3
    if not total_ms > 0:
      raise RuntimeError("the profiler recorded no device time")
    print(f"train-cli profile, {what} through the loader: wall "
          f"{wall_ms:.3f} ms (under the profiler), device time "
          f"{total_ms:.3f} ms in {sum(e.count for e in dev)} device "
          f"activities, device idle share {1 - total_ms / wall_ms:.4f} "
          f"card: {card}", flush=True)
    for e in dev[:5]:
      print(f"  top device op {dev_us(e) / 1e3:.3f} ms "
            f"({dev_us(e) / 1e3 / total_ms:.2%}) x{e.count} {e.key[:110]}",
            flush=True)


def train_cli_phase(torch, ops, ffn, similarity, staged_step_ms,
                    staged_eval_s, card, then=None):
  """``mmt_tpu_torch.cli`` trains the full-width flagship (bf16) on a
  synthetic MSRVTT cut-c corpus at the flagship's 7 experts and real
  widths through the real loader: 2 epochs, then a restart with 3, then
  ``--only_eval --resume`` on the plain versions.  Checks the launches,
  counters, losses and artifacts; prints the loop's timers against the
  staged b32 step (phase 8) and eval-1k (phase 6).  ``then(cfg_path,
  exp)`` runs last, while the corpus, the experiment and the phase's
  environment still exist (phase 12 (a)).  Returns the launch counts of
  the first run, its loop summary (``loop_summary``) and what ``then``
  returned."""
  import numpy as np

  from mmt_tpu_torch import bench_loader
  from mmt_tpu_torch.data import native_assembler as nasm

  with cli_corpus() as (root, data_dir, dims, RecordingMeter):
    exp = root / "exp"
    cfg_path = root / "flagship_c.json"
    cfg_path.write_text(json.dumps(cli_config(data_dir, exp, 2)))
    loader_paths_equal(cli_config(data_dir, exp, 2), dims,
                       root / "vocab.txt")

    per_eval = -(-CLI_TRAIN_VIDEOS // 32)        # 32 batches, the last 8
    final_batches = -(-CLI_VAL_VIDEOS // 32)

    def want(steps, evals, eval_batches):
      return {"ffn_block": FFN_LAYERS * eval_batches,
              "ffn_train_fwd": FFN_LAYERS * steps,
              "ffn_train_bwd": FFN_LAYERS * steps,
              "moe_similarity": steps + evals}

    # 2 epochs: continuous evals at epochs 0, 1, 2 and the final eval.
    steps = 2 * CLI_SAMPLES_PER_EPOCH // 32
    first = want(steps, 4, 3 * per_eval + final_batches)
    trainer = cli_run(ffn, similarity, ["--config", str(cfg_path),
                                        "--device", "cuda"],
                      first, "2 epochs")
    if trainer.n_steps != steps:
      raise RuntimeError(f"train-cli: n_steps {trainer.n_steps} != {steps}")
    for name in ("checkpoint-epoch2.pth", "trained_model.pth",
                 "exp_results.json", "exp_completed_flag.txt",
                 "MSRVTT-val-sims.npy", "perf_log.txt", "config.json"):
      if not (exp / name).exists():
        raise RuntimeError(f"train-cli: {name} missing")

    # Restart with 3 epochs: epoch 3 and its eval, then the final eval.
    cfg = json.loads((exp / "config.json").read_text())
    cfg["trainer"]["epochs"] = 3
    (exp / "config.json").write_text(json.dumps(cfg, indent=4))
    trainer = cli_run(ffn, similarity, ["--resume", str(exp),
                                        "--device", "cuda"],
                      want(steps // 2, 2, per_eval + final_batches),
                      "--resume to 3 epochs")
    if trainer.n_steps != steps * 3 // 2:
      raise RuntimeError(f"train-cli: n_steps {trainer.n_steps} after the "
                         f"restart != {steps * 3 // 2}")
    with open(exp / "perf_log.txt") as f:
      losses = [json.loads(line)["loss"] for line in f]
    print(f"train-cli: epoch losses {losses}", flush=True)
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
      raise RuntimeError(f"train-cli: bad epoch losses {losses}")
    kernel_sims = np.load(exp / "MSRVTT-val-sims.npy",
                          allow_pickle=True)[()]["sims"]
    results = json.loads((exp / "exp_results.json").read_text())["perfs"]
    print(f"train-cli: final eval {json.dumps(results)}", flush=True)
    check_tokenizer_path(trainer, True, "--resume to 3 epochs")
    # The counted runs' timers, before the breakdown adds its own.
    seen = {k: list(v) for k, v in RecordingMeter.seen.items()}
    cli_loop_breakdown(torch, trainer, card)

    with ops.plain_versions():
      cli_run(ffn, similarity, ["--resume", str(exp), "--only_eval",
                                "--device", "cuda"],
              {k: 0 for k in first}, "--only_eval --resume, plain versions")
    plain_sims = np.load(exp / "MSRVTT-val-sims.npy",
                         allow_pickle=True)[()]["sims"]
    diff = float(np.abs(plain_sims - kernel_sims).max())
    print(f"train-cli: final sims kernel vs plain max_abs_diff={diff:.3e} "
          "(limit 2e-2)", flush=True)
    if not np.isfinite(kernel_sims).all() or diff > 2e-2:
      raise RuntimeError(f"train-cli: final sims differ by {diff} > 2e-2")

    ms = lambda key, runs: [round(x * 1e3, 3) for x in runs.get(key, [])]
    for key in ("train_batch.data_loading", "train_batch.step",
                "train_batch.total"):
      vals = seen[key]
      print(f"train-cli loop {key} (trainer timer, {len(vals)} steps): "
            f"median {statistics.median(vals) * 1e3:.3f} ms; all "
            f"{ms(key, seen)}", flush=True)
    # Sustained: the whole window, the stalls that open each epoch (the
    # loader's threads starting cold) included: one epoch in 8 steps here.
    steps_ms = [x * 1e3 for x in seen["train_batch.total"]]
    per_epoch = CLI_SAMPLES_PER_EPOCH // 32
    opening = steps_ms[::per_epoch]
    rest = [x for j, x in enumerate(steps_ms) if j % per_epoch]
    total = sum(steps_ms) / len(steps_ms)
    median = statistics.median(steps_ms)
    print(f"train-cli: sustained b32 step through the loader (whole "
          f"window: {sum(steps_ms):.3f} ms over {len(steps_ms)} steps) "
          f"{total:.3f} ms, samples/s {32e3 / total:.1f}; median "
          f"{median:.3f} ms, samples/s {32e3 / median:.1f}; the "
          f"{len(opening)} steps opening an epoch {statistics.mean(opening):.3f}"
          f" ms on average, the other {len(rest)} "
          f"{statistics.mean(rest):.3f}; against the staged b32 step "
          f"{staged_step_ms:.3f} ms (phase 8): whole window "
          f"{total / staged_step_ms:.4f}x, median "
          f"{median / staged_step_ms:.4f}x card: {card}", flush=True)
    # The eval timers in order: the first run's continuous evals (1,000
    # videos) at epochs 0-2 and its final eval (32), the restart's
    # continuous eval and final eval, the plain --only_eval's final eval.
    evals = [0, 1, 2, 4]
    parts = {k: [seen[k][i] for i in evals]
             for k in ("valid.embds", "valid.conf_mat", "valid.metrics")}
    for i in range(len(evals)):
      e, c, m = (parts[k][i] for k in parts)
      print(f"train-cli eval-1k through the loader #{i}: embed {e:.6f} s, "
            f"similarity {c:.6f} s, metrics {m:.6f} s; "
            f"{CLI_TRAIN_VIDEOS / (e + c):.1f} videos/s (embed + "
            "similarity)", flush=True)
    e, c, m = (statistics.median(parts[k]) for k in parts)
    print(f"train-cli: eval-1k through the loader (median of {len(evals)}) "
          f"embed {e:.6f} + similarity {c:.6f} + metrics {m:.6f} = "
          f"{e + c + m:.6f} s against the staged eval-1k "
          f"{staged_eval_s:.6f} s (phase 6, embed + similarity + ranks); "
          f"videos/s through the loader {CLI_TRAIN_VIDEOS / (e + c):.1f} "
          f"card: {card}", flush=True)
    loading = statistics.median(seen["train_batch.data_loading"]) * 1e3
    print(f"train-cli: the native path against run D (the Python path; "
          f"H100 80GB HBM3, 700.00 W): data_loading median "
          f"{loading:.3f} ms (run D {RUN_D['data_loading_ms']}); b32 step "
          f"window mean {total:.3f} ms (run D {RUN_D['window_ms']}), median "
          f"{median:.3f} (run D {RUN_D['median_ms']}), staged "
          f"{staged_step_ms:.3f}; eval-1k through the loader "
          f"{e + c + m:.6f} s, {CLI_TRAIN_VIDEOS / (e + c):.1f} videos/s "
          f"(run D {RUN_D['eval_s']} s), staged {staged_eval_s:.6f} s "
          f"card: {card}", flush=True)

    # Two more 2-epoch runs in this call, held to the same launches: the
    # Python path (the two switches) and the native path with the
    # checkpoint written inline (A14.3); each summarised as the first.
    runs = {"native path": loop_summary(seen, 0, 0, steps,
                                        CLI_TRAIN_VIDEOS)}
    for what, native, async_ckpt in (
        ("Python path", False, True),
        ("native path, async_checkpoint false", True, False)):
      cfg = val_continuous_eval(cli_config(data_dir, root / "exp_more", 2))
      cfg["trainer"]["async_checkpoint"] = async_ckpt
      (root / "flagship_c_more.json").write_text(json.dumps(cfg))
      at = {k: len(v) for k, v in RecordingMeter.seen.items()}
      path = (contextlib.nullcontext() if native
              else bench_loader.python_path())
      with path:
        if nasm.enabled() != native:
          raise RuntimeError(f"train-cli {what}: the assembler's path")
        more = cli_run(ffn, similarity, ["--config",
                                         str(root / "flagship_c_more.json"),
                                         "--device", "cuda"],
                       want(steps, 4, 4 * final_batches),
                       f"2 epochs, {what}")
      check_tokenizer_path(more, native, what)
      shutil.rmtree(root / "exp_more", ignore_errors=True)
      runs[what] = loop_summary(RecordingMeter.seen, at["train_batch.total"],
                                at["valid.embds"], steps, CLI_VAL_VIDEOS)
    for what, r in runs.items():
      print(f"train-cli loop, {what} (2 epochs, {steps} steps): "
            f"data_loading median {r['data_loading_ms']:.3f} ms; b32 step "
            f"window mean {r['window_ms']:.3f} ms, median "
            f"{r['median_ms']:.3f}; epoch 2's first {EPOCH2_STEPS} steps "
            f"{r['epoch2_ms']} ms; continuous eval of {r['videos']} videos "
            f"through the loader (median of 3) {r['eval_s']:.6f} s, "
            f"{r['videos_s']:.1f} videos/s card: {card}", flush=True)
    nat, py = runs["native path"], runs["Python path"]
    print("train-cli: native path / Python path in this call: "
          + ", ".join(f"{k} {nat[k] / py[k]:.4f}x" for k in
                      ("data_loading_ms", "window_ms", "median_ms"))
          + f" card: {card}", flush=True)
    txt_bert_init_phase(torch, ffn, similarity, root, data_dir, want,
                        per_eval, final_batches, card)
    return (first, runs["native path"],
            then(cfg_path, exp) if then is not None else None)


@contextlib.contextmanager
def cli_corpus():
  """Phase 11's corpus and the environment of its runs: a synthetic
  MSRVTT cut-c corpus at the flagship's 7 experts and widths
  (CLI_TRAIN_VIDEOS train and CLI_VAL_VIDEOS val videos, the vocab padded
  to CLI_VOCAB entries) in a temporary directory, MMT_TPU_BERT_VOCAB set
  to its vocab, the expert files read under the flagship's names, and
  the trainer's timers recorded.  Yields (root, data_dir, dims, the
  meter class, whose ``seen`` maps each timer to every value); restores
  the environment, the trainer's meter and SIGTERM's handler and removes
  the directory on exit."""
  import signal
  import tempfile

  from mmt_tpu_torch import bench_sustained
  from mmt_tpu_torch.data import synthetic
  from mmt_tpu_torch.experts import compute_dims
  from mmt_tpu_torch.train import trainer as trainer_lib
  from mmt_tpu_torch.utils import timing

  class RecordingMeter(timing.AverageMeter):
    """The trainer's timers, also keeping every value (medians)."""
    seen = {}

    def update(self, key, val, n=1):
      super().update(key, val, n)
      RecordingMeter.seen.setdefault(key, []).append(val)

  root = pathlib.Path(tempfile.mkdtemp(prefix="mmt_train_cli_"))
  prev_sigterm = signal.getsignal(signal.SIGTERM)
  prev_meter = trainer_lib.AverageMeter
  prev_vocab = os.environ.get("MMT_TPU_BERT_VOCAB")
  shims = contextlib.ExitStack()
  try:
    with open(FLAGSHIP_CONFIG) as f:
      dims = {m: d["dim"] for m, d in compute_dims(json.load(f)).items()}
    tic = time.perf_counter()
    data_dir = synthetic.generate(
        root, num_videos=CLI_TRAIN_VIDEOS + CLI_VAL_VIDEOS,
        num_test=CLI_VAL_VIDEOS, experts=dims,
        captions_per_video=CLI_CAPTIONS, max_feats=CLI_MAX_FEATS, cut="c")
    vocab = (root / "vocab.txt").read_text().splitlines()
    vocab += [f"[unused{i}]" for i in range(CLI_VOCAB - len(vocab))]
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    corpus_s = time.perf_counter() - tic
    size = sum(p.stat().st_size for p in data_dir.rglob("*")) / 2 ** 30
    print(f"train-cli: corpus of {CLI_TRAIN_VIDEOS + CLI_VAL_VIDEOS} videos "
          f"(cut c, {len(dims)} experts, {sum(dims.values())} floats a "
          f"row, up to {CLI_MAX_FEATS} rows, {CLI_CAPTIONS} captions) "
          f"written in {corpus_s:.1f} s, {size:.2f} GiB; vocab "
          f"{len(vocab)}", flush=True)
    if corpus_s > CLI_CORPUS_LIMIT_S:
      print(f"train-cli: writing the corpus took over "
            f"{CLI_CORPUS_LIMIT_S:.0f} s", flush=True)
    os.environ["MMT_TPU_BERT_VOCAB"] = str(root / "vocab.txt")
    trainer_lib.AverageMeter = RecordingMeter
    shims.enter_context(bench_sustained.flagship_expert_names(dims))
    yield root, data_dir, dims, RecordingMeter
  finally:
    trainer_lib.AverageMeter = prev_meter
    shims.close()
    signal.signal(signal.SIGTERM, prev_sigterm)
    if prev_vocab is None:
      os.environ.pop("MMT_TPU_BERT_VOCAB", None)
    else:
      os.environ["MMT_TPU_BERT_VOCAB"] = prev_vocab
    shutil.rmtree(root, ignore_errors=True)


# Phase 11 (d): the pretrained text-tower init through the CLI.
INIT_SEED = 11


def hf_style_asset(torch, geom, seed=INIT_SEED):
  """Random weights under HF BertForPreTraining names at ``geom`` (a
  config.BertParams): the tower's 5 + 16 x layers tensors, then the
  position_ids buffer, the pooler and the cls.* heads that the conversion
  drops.  Returns (state dict, number of tower tensors)."""
  gen = torch.Generator().manual_seed(seed)
  h, inter = geom.hidden_size, geom.intermediate_size
  sd = {}

  def rand(*shape, scale=0.02, shift=0.0):
    return torch.randn(*shape, generator=gen) * scale + shift

  def lin(name, n_in, n_out):
    sd[f"{name}.weight"] = rand(n_out, n_in)
    sd[f"{name}.bias"] = rand(n_out, scale=0.01)

  def ln(name):
    sd[f"{name}.weight"] = rand(h, scale=0.01, shift=1.0)
    sd[f"{name}.bias"] = rand(h, scale=0.01)

  emb = "bert.embeddings"
  sd[f"{emb}.word_embeddings.weight"] = rand(geom.vocab_size, h)
  sd[f"{emb}.position_embeddings.weight"] = rand(
      geom.max_position_embeddings, h)
  sd[f"{emb}.token_type_embeddings.weight"] = rand(geom.type_vocab_size, h)
  ln(f"{emb}.LayerNorm")
  for layer in range(geom.num_hidden_layers):
    base = f"bert.encoder.layer.{layer}"
    for sub in ("attention.self.query", "attention.self.key",
                "attention.self.value", "attention.output.dense"):
      lin(f"{base}.{sub}", h, h)
    ln(f"{base}.attention.output.LayerNorm")
    lin(f"{base}.intermediate.dense", h, inter)
    lin(f"{base}.output.dense", inter, h)
    ln(f"{base}.output.LayerNorm")
  tower = len(sd)
  sd[f"{emb}.position_ids"] = torch.arange(geom.max_position_embeddings)[None]
  lin("bert.pooler.dense", h, h)
  lin("cls.predictions.transform.dense", h, h)
  ln("cls.predictions.transform.LayerNorm")
  sd["cls.predictions.bias"] = torch.zeros(geom.vocab_size)
  lin("cls.seq_relationship", h, 2)
  return sd, tower


def txt_bert_init_phase(torch, ffn, similarity, root, data_dir, want,
                        per_eval, final_batches, card):
  """Phase 11 (d): a synthetic HF asset at the config's text geometry
  (bert-base-cased), converted by hf_bert, then ``cli.main`` on phase
  11's corpus: --only_eval from the init (the tower bitwise the asset),
  one epoch from it, and --only_eval of that epoch's checkpoint over a
  zero init (the checkpoint wins).  Launches as counted; prints the
  asset's load and merge seconds."""
  import dataclasses

  from mmt_tpu_torch import hf_bert
  from mmt_tpu_torch.config import TEXT_BERT_BASE_CASED
  from mmt_tpu_torch.train import checkpoint as ckpt_lib
  from mmt_tpu_torch.train import trainer as trainer_lib

  start = time.perf_counter()

  def config(name, epochs):
    cfg = cli_config(data_dir, root / name, epochs)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return cfg, path

  cfg, eval_cfg = config("init_eval", 1)
  vocab = len((root / "vocab.txt").read_text().splitlines())
  geom = dataclasses.replace(
      TEXT_BERT_BASE_CASED, **cfg["arch"]["args"].get("text_bert_geometry",
                                                      {}),
      vocab_size=vocab)
  tic = time.perf_counter()
  sd, tower = hf_style_asset(torch, geom)
  hf_dir = root / "hf_bert"
  hf_dir.mkdir()
  torch.save(sd, hf_dir / "pytorch_model.bin")
  written_s = time.perf_counter() - tic
  tic = time.perf_counter()
  asset_path = hf_bert.main(["--hf_dir", str(hf_dir),
                             "--out", str(root / "txt_bert_init.pth")])
  convert_s = time.perf_counter() - tic
  asset = ckpt_lib.load_txt_bert_init(asset_path)
  n_params = sum(t.numel() for t in asset.values())
  print(f"train-cli (d): HF asset of {len(sd)} tensors ({tower} of the "
        f"tower) written in {written_s:.3f} s; hf_bert kept {len(asset)} "
        f"tensors, {n_params:,} parameters, {n_params * 4 / 1e6:.1f} MB "
        f"fp32, in {convert_s:.3f} s", flush=True)
  if len(asset) != tower:
    raise RuntimeError(f"train-cli (d): hf_bert kept {len(asset)} tensors "
                       f"of the {tower} of the tower")
  del sd

  # 1. --only_eval from the init, its load and merge timed.
  seconds = {}
  load, merge = ckpt_lib.load_txt_bert_init, trainer_lib.Trainer._load_txt_bert_init

  def timed_load(path):
    tic = time.perf_counter()
    out = load(path)
    seconds["load"] = time.perf_counter() - tic
    return out

  def timed_merge(self, path):
    tic = time.perf_counter()
    merge(self, path)
    torch.cuda.synchronize()
    seconds["load + merge"] = time.perf_counter() - tic

  ckpt_lib.load_txt_bert_init = timed_load
  trainer_lib.Trainer._load_txt_bert_init = timed_merge
  try:
    trainer = cli_run(ffn, similarity, [
        "--config", str(eval_cfg), "--device", "cuda", "--only_eval",
        "--txt_bert_init", asset_path], want(0, 1, final_batches),
        "(d) --only_eval --txt_bert_init")
  finally:
    ckpt_lib.load_txt_bert_init = load
    trainer_lib.Trainer._load_txt_bert_init = merge
  differ = [n for n, p in trainer.model.txt_bert.named_parameters()
            if not torch.equal(p.detach().cpu(), asset[f"txt_bert.{n}"])]
  n_tower = sum(1 for _ in trainer.model.txt_bert.parameters())
  del trainer
  if differ or n_tower != len(asset):
    raise RuntimeError(f"train-cli (d): {len(differ)} of {n_tower} txt_bert "
                       f"parameters are not the asset's (first: "
                       f"{differ[:1]})")
  merge_s = seconds["load + merge"] - seconds["load"]
  print(f"train-cli (d): txt_bert init of {len(asset)} tensors "
        f"({n_params:,} parameters): load {seconds['load']:.3f} s, merge "
        f"{merge_s:.3f} s, load + merge {seconds['load + merge']:.3f} s; "
        f"every txt_bert parameter bitwise the asset's card: {card}",
        flush=True)

  # 2. One epoch from the init: 2 steps, the continuous eval on val (a
  # depth cut from 8 steps and the 1,000 train videos).
  cfg, train_cfg = config("init_train", 1)
  val_continuous_eval(cfg)["trainer"]["max_samples_per_epoch"] = 2 * 32
  train_cfg.write_text(json.dumps(cfg))
  cli_run(ffn, similarity, ["--config", str(train_cfg), "--device", "cuda",
                            "--txt_bert_init", asset_path],
          want(2, 3, 3 * final_batches), "(d) 1 epoch from the init")
  with open(root / "init_train" / "perf_log.txt") as f:
    losses = [json.loads(line)["loss"] for line in f]
  print(f"train-cli (d): epoch losses from the init {losses}", flush=True)
  if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
    raise RuntimeError(f"train-cli (d): bad epoch losses {losses}")

  # 3. The checkpoint wins over a zero init.
  zero_path = root / "zero_init.pth"
  torch.save({"state_dict": {k: torch.zeros_like(v)
                             for k, v in asset.items()}}, zero_path)
  del asset
  ckpt = root / "init_train" / "trained_model.pth"
  _, warm_cfg = config("init_warm", 1)
  trainer = cli_run(ffn, similarity, [
      "--config", str(warm_cfg), "--device", "cuda", "--only_eval",
      "--load_checkpoint", str(ckpt), "--txt_bert_init", str(zero_path)],
      want(0, 1, final_batches), "(d) a checkpoint over a zero init")
  saved = ckpt_lib.load_checkpoint(ckpt)["state_dict"]
  state = trainer.model.state_dict()
  differ = [k for k, v in state.items()
            if not torch.equal(v.detach().cpu(), saved[k])]
  del trainer
  if differ or set(saved) != set(state):
    raise RuntimeError(f"train-cli (d): {len(differ)} entries differ from "
                       f"the checkpoint's (first: {differ[:1]})")
  print(f"train-cli (d): every entry the checkpoint's; phase 11 (d) "
        f"{time.perf_counter() - start:.1f} s", flush=True)
  for path in (hf_dir / "pytorch_model.bin", pathlib.Path(asset_path),
               zero_path):
    path.unlink()


# Phase 12: serving (mmt_tpu_torch.serving, mmt_tpu_torch.serve).
SERVE_CLI_QUERIES = ("a man is cooking pasta in a kitchen",
                     "a soccer match in the rain",
                     "a dog runs in the park",
                     "a woman sings a song on stage")
SERVE_VIDEOS, SERVE_M, SERVE_D = 100_000, 7, 512   # the flagship's geometry
# Planted corpora (videos, queries): the pinned int8 rule's own, and the
# at-scale one of docs/SERVING.md (scripts/int8_quality.py's defaults).
SERVE_QUALITY_PINNED, SERVE_QUALITY = (512, 64), (10_000, 1_000)
SERVE_TOL = 2e-2                    # kernel path vs plain path, scores
SERVE_FFN_ROWS = (30, 1920)         # text rows of 1 and of 64 queries
# Phase 15 (a): the index sharded three ways on the one card (100,000 is
# no multiple of 3: two pad rows); exact and int8 scores held to the
# unsharded engine's; SERVE_SEARCH_REPS direct search calls a p50.
SERVE_SHARDS = 3
SERVE_SHARD_ROWS = -(-SERVE_VIDEOS // SERVE_SHARDS)   # 33,334
SERVE_SHARD_TOL = {None: 1e-5, "int8": 1e-4}
SERVE_SEARCH_REPS = 10
# Phase 12 (b)'s tokenizer vocabulary and direct queries: bench_serving's
# WORDS (its HTTP traffic's) and four more (bench_loader's QUERY_WORDS).
SERVE_WORDS = ("person cooking pasta kitchen soccer match goal rain city "
               "night dog park guitar song stage car road mountain beach "
               "man woman sings runs").split()
# B4 cases at the serving shapes (queries, videos): kernel cases only.
# Since C7 the exact engine scores through the library route, as the JAX
# engine does (mmt_tpu/serving.py:307-315): 0 B4 per query batch.
SERVE_SIM_CASES = ((1, 1_000), (1, 100_000), (64, 100_000),
                   (1, SERVE_SHARD_ROWS), (64, SERVE_SHARD_ROWS))
SERVE_SPLIT = {"B1": B1_KERNELS, "B4": ("moe_similarity_kernel",),
               "B4 scratch fill": ("k_major_kernel",),
               "top-k": ("topk", "TopK", "radix", "Radix", "sort", "Sort")}


def check_hits(hits, topk, ids, what):
  """Each query's hits: ``topk`` of them, ids of the index, scores not
  increasing, ranks 0, 1, ...; raises otherwise."""
  for q, row in enumerate(hits):
    scores = [h["score"] for h in row]
    if (len(row) != topk or any(h["video_id"] not in ids for h in row)
        or scores != sorted(scores, reverse=True)
        or [h["rank"] for h in row] != list(range(topk))
        or not all(map(math.isfinite, scores))):
      raise RuntimeError(f"serve {what}: malformed hits for query {q}: "
                         f"{row}")


def serve_counted(torch, ffn, similarity, fn, want, what):
  """fn() with the B1 and B4 counters set to 0 just before and read just
  after (``counted_run``); they must read ``want``.  Returns fn()'s
  result."""
  return counted_run(torch, {"ffn_block": ffn.ffn_block_cuda,
                             "moe_similarity": similarity.sim_cuda},
                     fn, want, f"serve {what}")


def serve_cli_phase(torch, ffn, similarity, cfg_path, exp):
  """Phase 12 (a): ``mmt_tpu_torch.serve.main`` on phase 11's
  trained_model.pth and config: --build_index over the config's eval set
  with 4 --query captions (exact), then the same queries --quantize
  int8 from the saved index.  Launches exactly 4 B1 per video batch of
  the build, 12 B1 and 0 B4 per query batch, exact (the library route
  since C7, as the JAX engine scores) or int8; the hits well-formed.
  Returns the two runs' launches."""
  from mmt_tpu_torch import serve, serving

  cfg = json.loads(pathlib.Path(cfg_path).read_text())
  video_batches = -(-CLI_VAL_VIDEOS
                    // cfg["final_eval_sets"][0]["args"]["batch_size"])
  index_path = pathlib.Path(exp) / "serve_index.npz"
  base = ["--config", str(cfg_path), "--checkpoint",
          str(pathlib.Path(exp) / "trained_model.pth"), "--topk", "5",
          "--device", "cuda"]
  for q in SERVE_CLI_QUERIES:
    base += ["--query", q]
  runs = {}
  def quiet_main(argv):
    """serve.main(argv), its stdout (one JSON line a query) checked
    against what it returned and not shown."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
      results = serve.main(argv)
    printed = [json.loads(line) for line in buf.getvalue().splitlines()]
    if printed != results:
      raise RuntimeError(f"serve cli printed {printed}, returned {results}")
    return results

  for what, argv, want in (
      ("cli --build_index + exact query",
       ["--build_index", str(index_path)],
       {"ffn_block": VIDEO_LAYERS * video_batches + TEXT_LAYERS,
        "moe_similarity": 0}),
      ("cli --index --quantize int8 query",
       ["--index", str(index_path), "--quantize", "int8"],
       {"ffn_block": TEXT_LAYERS, "moe_similarity": 0})):
    runs[what] = (serve_counted(torch, ffn, similarity,
                                lambda: quiet_main(base + argv), want, what),
                  want)
  index = serving.RetrievalIndex.load(index_path)
  if len(index) != CLI_VAL_VIDEOS:
    raise RuntimeError(f"serve cli: index of {len(index)} videos")
  ids = set(index.video_ids)
  for what, (results, _) in runs.items():
    if [r["query"] for r in results] != list(SERVE_CLI_QUERIES):
      raise RuntimeError(f"serve {what}: answered {results}")
    check_hits([r["hits"] for r in results], 5, ids, what)
  exact, q8 = (res for res, _ in runs.values())
  same = [[h["video_id"] for h in a["hits"]] == [h["video_id"]
                                                  for h in b["hits"]]
          for a, b in zip(exact, q8)]
  print(f"serve cli: {len(index)} videos indexed ({video_batches} video "
        f"batches); top-5 ids of int8 equal to exact's for {sum(same)} of "
        f"{len(same)} queries; first hits {json.dumps(exact[0]['hits'][:2])}",
        flush=True)
  return {what: want for what, (_, want) in runs.items()}


def serve_http_traffic(bench_serving, engine, rng, what, card):
  """bench_serving.measure on ``engine`` (its protocol: a fresh server,
  warmed, BENCH_REQS GETs of 1 query at topk 5 and BENCH_BULK_REQS
  POSTs of 64 at topk 10, /statz counting exactly those), every reply's
  hits checked; prints the client's and the server's percentiles."""
  ids = set(engine._staged_ids)
  entry = bench_serving.measure(
      engine, rng, bench_serving.N_INTERACTIVE, bench_serving.N_BULK,
      check=lambda body, n, topk: check_hits(body["results"], topk, ids,
                                             what))
  b1, b64, s = entry["batch1_ms"], entry["batch64_ms"], entry["server_statz"]
  print(f"serve {what} over HTTP: client batch 1 (topk 5) p50 "
        f"{b1['p50']:.3f} p90 {b1['p90']:.3f} p99 {b1['p99']:.3f} max "
        f"{b1['max']:.3f} ms; batch 64 (topk 10) p50 {b64['p50']:.3f} p90 "
        f"{b64['p90']:.3f} p99 {b64['p99']:.3f} max {b64['max']:.3f} ms, "
        f"{entry['batch64_qps']:.1f} queries/s; server /statz (every "
        f"request, warm-up included) p50 {s['p50']} p90 {s['p90']} p99 "
        f"{s['p99']} ms card: {card}", flush=True)
  return entry


def serve_profile(torch, ffn, similarity, engine, queries, topk, what,
                  card):
  """One search of ``queries`` under torch.profiler: wall, device time,
  idle share, and the device time split into SERVE_SPLIT's parts and the
  rest.  The counters say how many B1 and B4 launches the search made:
  each kernel of B1 and B4 counts at its mean recorded time times those
  launches (device_split's rule for activities the profiler missed), the
  other activities as recorded.  A session that recorded none of a
  launched kernel's activities is run again."""
  from torch.profiler import ProfilerActivity, profile

  engine.search(queries, topk)
  torch.cuda.synchronize()
  for _ in range(PROFILE_TRIES):
    b1, b4 = ffn.ffn_block_cuda.launches, similarity.sim_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      tic = time.perf_counter()
      engine.search(queries, topk)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - tic) * 1e3
    launches = {"B1": ffn.ffn_block_cuda.launches - b1,
                "B4": similarity.sim_cuda.launches - b4}
    launches["B4 scratch fill"] = launches["B4"]
    dev = device_events(prof)
    part_of = {e.key: next((p for p, names in SERVE_SPLIT.items()
                            if any(k in e.key for k in names)), "rest")
               for e in dev}
    seen = {part_of[e.key] for e in dev}
    if all(n == 0 or p in seen for p, n in launches.items()):
      break
    print(f"  profiler session missed a launched kernel ({launches}, "
          f"recorded {sorted(seen)}): run again", flush=True)
  else:
    raise RuntimeError(f"serve profile {what}: no whole session in "
                       f"{PROFILE_TRIES} tries")
  split = dict.fromkeys(list(SERVE_SPLIT) + ["rest"], 0.0)
  missed = []
  for e in dev:
    part = part_of[e.key]
    ms = e.self_device_time_total / 1e3
    if part in launches:
      if e.count != launches[part]:
        missed.append(f"{short_kernel_name(e.key)} {e.count}/{launches[part]}")
      ms *= launches[part] / e.count
    split[part] += ms
  total = sum(split.values())
  shown = ", ".join(f"{p} {ms:.4f} ({ms / total:.2%})"
                    for p, ms in split.items())
  top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
  print(f"serve profile {what}: wall {wall_ms:.3f} ms, device "
        f"{total:.4f} ms, idle share {1 - total / wall_ms:.4f}; {shown}; "
        f"activities the profiler missed (recorded/launched): "
        f"{missed or 'none'} card: {card}", flush=True)
  for e in top[:4]:
    print(f"  top device op {e.self_device_time_total / 1e3:.4f} ms "
          f"x{e.count} {e.key[:100]}", flush=True)
  return {"wall_ms": wall_ms, "device_ms": total, "split": split}


def check_witness(torch, k_scores, k_idx, p_sims, topk):
  """The kernel path's top-k against the plain path's full scores
  ``p_sims``: the sorted scores within SERVE_TOL, and every id in one
  top-k and not the other with a plain score within SERVE_TOL of the
  plain path's k-th (phase 3's witness rule, applied to ids).  Returns
  the worst score difference."""
  p_scores, p_idx = torch.topk(p_sims, topk)
  diff = float((k_scores - p_scores).abs().max())
  if diff > SERVE_TOL:
    raise RuntimeError(f"serve: top-{topk} scores differ by {diff}")
  kth = p_scores[:, -1]
  for q in range(p_sims.shape[0]):
    moved = set(k_idx[q].tolist()) ^ set(p_idx[q].tolist())
    for v in moved:
      if abs(float(p_sims[q, v] - kth[q])) > SERVE_TOL:
        raise RuntimeError(f"serve: query {q}'s id {v} is in one top-"
                           f"{topk} only, plain score {float(p_sims[q, v])}"
                           f" against the plain {topk}th {float(kth[q])}")
  return diff


def serve_scale_phase(torch, ops, ffn, similarity, flagship, dev, card,
                      clock):
  """Phase 12 (b): the full-width flagship (bf16, random weights from a
  seed) serving a synthetic index of SERVE_VIDEOS videos of the
  flagship's geometry (L2-normalised rows, L1 weights), exact and int8:
  exact launch counts a query batch, the kernel path's top-10 against
  the plain versions' (witness rule), HTTP traffic (interactive and
  bulk) with the server's and the client's percentiles, the device
  split of one query batch, overlap@10 of int8 with exact, and the
  pinned int8 quality rule on its planted corpus (at 10,000 x 1,000 all
  of it but R@K equality)."""
  import tempfile

  import numpy as np

  from mmt_tpu_torch import bench_serving, int8_quality, serving

  root = pathlib.Path(tempfile.mkdtemp(prefix="mmt_serve_"))
  try:
    tok = bench_serving.vocab_tokenizer(root, SERVE_WORDS)
    model = flagship.flagship_model(device=dev, seed=0)
    tic = time.perf_counter()
    index = bench_serving.synthetic_index(SERVE_VIDEOS, SERVE_M, SERVE_D, dev)
    print(f"serve: index of {SERVE_VIDEOS} x {SERVE_M} x {SERVE_D} made in "
          f"{time.perf_counter() - tic:.1f} s "
          f"({index.vid_embds.nbytes / 1e9:.2f} GB fp32)", flush=True)
    rng = np.random.RandomState(7)
    q64 = bench_serving.queries(rng, 64, SERVE_WORDS)
    out, hits = {}, {}
    for quant in (None, "int8"):
      label = quant or "exact"
      torch.cuda.synchronize()
      tic = time.perf_counter()
      engine = serving.RetrievalEngine(model, tok, index, quantize=quant)
      torch.cuda.synchronize()
      print(f"serve {label}: staged in {time.perf_counter() - tic:.1f} s, "
            f"{staged_gb(engine):.3f}"
            f" GB on the card", flush=True)
      for batch, topk in ((1, 5), (64, 10)):
        res = serve_counted(
            torch, ffn, similarity, lambda: engine.search(q64[:batch], topk),
            {"ffn_block": TEXT_LAYERS, "moe_similarity": 0},
            f"{label} query batch of {batch}")
        check_hits(res, topk, set(index.video_ids), label)
      hits[label] = engine.search(q64, 10)
      if quant is None:
        with engine._lock, torch.inference_mode():
          scores = torch.tensor([[h["score"] for h in r] for r in hits[label]],
                                device=dev)
          idx = torch.tensor([[int(h["video_id"][5:]) for h in r]
                              for r in hits[label]], device=dev)
          with ops.plain_versions():
            plain = engine._similarities(q64)
          diff = check_witness(torch, scores, idx, plain, 10)
        print(f"serve exact: kernel path vs plain versions, 64 queries: "
              f"top-10 scores max_abs_diff={diff:.3e} (limit {SERVE_TOL}); "
              f"witness rule held", flush=True)
      out[label] = {
          "http": serve_http_traffic(bench_serving, engine, rng, label, card),
          "profile": {b: serve_profile(torch, ffn, similarity, engine,
                                       q64[:b], k, f"{label} batch {b}",
                                       card)
                      for b, k in ((1, 5), (64, 10))}}
      del engine
      torch.cuda.empty_cache()
    overlap = np.mean([len({h["video_id"] for h in a}
                           & {h["video_id"] for h in b}) / 10
                       for a, b in zip(hits["exact"], hits["int8"])])
    print(f"serve: int8 vs exact at {SERVE_VIDEOS} random rows, 64 queries: "
          f"overlap@10 {overlap:.4f}", flush=True)
    # The pinned rule on its own corpus; at 10,000 x 1,000 all of it but
    # R@K equality, which the JAX package does not meet there either
    # (scripts/int8_quality.py gives the same R@1 and R@10 moves).
    for size in (SERVE_QUALITY_PINNED, SERVE_QUALITY):
      tic = time.perf_counter()
      rep = int8_quality.main(["--videos", str(size[0]), "--queries",
                               str(size[1])])
      faults = int8_quality.faults(rep)
      print(f"serve: python -m mmt_tpu_torch.int8_quality on the planted "
            f"corpus {size} (videos, queries) in "
            f"{time.perf_counter() - tic:.1f} s: faults {faults}", flush=True)
      if rep["backend"] != "cuda" or (rep["videos"], rep["queries"]) != size:
        raise RuntimeError(f"serve: int8_quality ran {rep}")
      if size != SERVE_QUALITY_PINNED:
        faults = [f for f in faults if f not in ("R1", "R5", "R10")]
      if faults:
        raise RuntimeError(f"serve: int8 quality rule broken at {size}: "
                           f"{faults}")
      out[f"int8_quality_{size[0]}"] = rep
    out["overlap@10"] = float(overlap)
    clock.done("serve")
    out["sharded"] = sharded_serve_phase(torch, ffn, similarity, serving,
                                         model, tok, index, q64, card)
    return out
  finally:
    shutil.rmtree(root, ignore_errors=True)


def staged_gb(engine):
  """GB of the index tensors an engine staged, over all its shards."""
  return sum(t.numel() * t.element_size()
             for _, staged, _ in engine._shards for t in staged) / 1e9


def search_p50_ms(engine, queries, topk):
  """The median wall ms of SERVE_SEARCH_REPS direct ``search`` calls
  (each returns host lists: the device work is done), after one more."""
  engine.search(queries, topk)
  times = []
  for _ in range(SERVE_SEARCH_REPS):
    tic = time.perf_counter()
    engine.search(queries, topk)
    times.append(1e3 * (time.perf_counter() - tic))
  return statistics.median(times)


def sharded_serve_phase(torch, ffn, similarity, serving, model, tok, index,
                        queries, card):
  """Phase 15 (a): phase 12 (b)'s index and model through
  ``RetrievalEngine(mesh=[card] * SERVE_SHARDS)`` (padded to a multiple
  of the shards), exact then int8, against the unsharded engine: exactly
  12 B1 and 0 B4 a query batch (C7: each shard's exact product is the
  library route, as in the JAX engine); for 1
  query (topk 5) and 64 (topk 10) the ids equal, the scores within
  SERVE_SHARD_TOL, no pad row; the int8 shards' codes and scales
  bitwise the unsharded engine's; the p50 of direct searches, sharded
  and unsharded (shards sharing one card: a correctness path, no claim
  of speed).  Returns the launch counts and the p50s."""
  dev = next(model.parameters()).device
  ids, n = set(index.video_ids), len(index)
  out = {}
  for quant in (None, "int8"):
    label, tol = quant or "exact", SERVE_SHARD_TOL[quant]
    whole = serving.RetrievalEngine(model, tok, index, quantize=quant)
    sharded = serving.RetrievalEngine(model, tok, index, quantize=quant,
                                      mesh=[dev] * SERVE_SHARDS)
    per = sharded._shard_rows
    rows = [real for _, _, real in sharded._shards]
    print(f"serve sharded {label}: {SERVE_SHARDS} shards of {per} rows on "
          f"{dev} ({rows} real, {per * SERVE_SHARDS - n} pad)", flush=True)
    if quant:
      (_, staged, _), = whole._shards
      for j, what in ((0, "codes"), (1, "scales")):
        cat = torch.cat([st[j][:per] for _, st, _ in sharded._shards])
        if not torch.equal(cat[:n], staged[j][:n]):
          raise RuntimeError(f"serve sharded int8: the shards' {what} are "
                             "not the unsharded engine's")
    want = {"ffn_block": TEXT_LAYERS, "moe_similarity": 0}
    entry = {"launches": want}
    for batch, topk in ((1, 5), (64, 10)):
      got = serve_counted(
          torch, ffn, similarity,
          lambda: sharded.search(queries[:batch], topk), want,
          f"sharded {label} query batch of {batch}")
      check_hits(got, topk, ids, f"sharded {label}")
      ref = whole.search(queries[:batch], topk)
      same = all([h["video_id"] for h in a] == [h["video_id"] for h in b]
                 for a, b in zip(got, ref))
      diff = max(abs(a["score"] - b["score"]) for ra, rb in zip(got, ref)
                 for a, b in zip(ra, rb))
      print(f"serve sharded {label} batch {batch} topk {topk}: ids equal "
            f"the unsharded engine's {same}; scores max_abs_diff={diff:.3e} "
            f"(limit {tol:.0e})", flush=True)
      if not same or diff > tol:
        raise RuntimeError(f"serve sharded {label} batch {batch}: ids "
                           f"equal {same}, scores diff {diff}")
      entry[f"p50_ms_batch{batch}"] = {
          "sharded": search_p50_ms(sharded, queries[:batch], topk),
          "unsharded": search_p50_ms(whole, queries[:batch], topk)}
    print(f"serve sharded {label}: direct search p50 ms (of "
          f"{SERVE_SEARCH_REPS}) {json.dumps(entry)}; {SERVE_SHARDS} shards "
          f"sharing one card, no claim of speed card: {card}", flush=True)
    out[label] = entry
    del whole, sharded
    torch.cuda.empty_cache()
  return out


def eval_ffn_case(torch, ffn, dev, gen, r, h, what, card):
  """B1 at R x H, I 3,072, bf16 on operands from ``gen``, against its
  plain version by phase 1's bf16 rules (max 3e-2, mean 2e-3), every row
  tile bitwise equal; its CUDA-event and device ms, plain ms and bound.
  Returns the case's entry."""
  rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
  i, cd = 3072, torch.bfloat16
  args = (rand(r, h), (rand(i, h) * 0.02).to(cd), rand(i) * 0.02,
          (rand(h, i) * 0.02).to(cd), rand(h) * 0.02, 1.0 + 0.1 * rand(h),
          0.1 * rand(h))
  kw = dict(eps=1e-12, compute_dtype=cd)
  got = ffn.ffn_block_cuda(*args, **kw)
  err = (got - ffn.ffn_block_plain(*args, **kw)).abs()
  max_err, mean_err = float(err.max()), float(err.mean())
  if not bool(torch.isfinite(got).all()) or max_err > 3e-2 or mean_err > 2e-3:
    raise RuntimeError(f"ffn_block R={r} H={h}: error {max_err}/{mean_err} "
                       "exceeds 3e-2 (max) / 2e-3 (mean)")
  check_tiles_equal(torch, ffn, f"ffn_block R={r} H={h} ({what})",
                    ffn.ffn_block_cuda, args, kw)
  b_ms, b_by = bound(4 * r * h * i, H100_BF16, args + (got,))
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  case = {"shape": f"{r} x {h}, I {i}", "max_abs_err": max_err,
          "tile_rows": ffn.GEMM_TILES[ffn.pick_gemm_tile(r, h, sms)],
          "ms": time_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw)),
          "device_ms": device_ms(
              torch, lambda: ffn.ffn_block_cuda(*args, **kw)),
          "plain_ms": time_ms(torch,
                              lambda: ffn.ffn_block_plain(*args, **kw)),
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
  print(f"ffn_block {what} R={r} H={h} I={i} bf16 ({case['tile_rows']}-row "
        f"tile): max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
        f"kernel_ms={case['ms']:.4f} device_ms={case['device_ms']:.4f} "
        f"plain_ms={case['plain_ms']:.4f} bound {b_ms:.6f} ms ({b_by}) card: "
        f"{card}", flush=True)
  return case


def sim_case(torch, similarity, dev, gen, q, v, m, what, card):
  """B4 at [q, v] with K = m x 512 on inputs from ``gen`` against its
  plain version (1e-5), every tile bitwise equal; its CUDA-event and
  device ms (with its k-major scratch fill's), plain ms, the fp32
  ``torch.mm`` of its numerator and its bound.  Returns the case's
  entry."""
  d = SERVE_D
  t, vv, tw, vw = sim_inputs(torch, q, v, m, d, dev, gen)
  call = lambda: similarity.sim_cuda(t, vv, tw, vw)
  got = call()
  max_err = float((got - similarity.sim_plain(t, vv, tw, vw)).abs().max())
  if not bool(torch.isfinite(got).all()) or max_err > 1e-5:
    raise RuntimeError(f"moe_similarity Q={q} V={v} K={m * d}: error "
                       f"{max_err}")
  if not all(torch.equal(got, similarity.sim_cuda(t, vv, tw, vw, tile=i))
             for i in range(len(similarity.TILES))):
    raise RuntimeError(f"moe_similarity Q={q} V={v}: a tile changed the "
                       "values")
  split = device_split(torch, call)
  dev_ms = sum(split.values())
  fill = sum(ms for k, ms in split.items() if "k_major_kernel" in k)
  b_ms, b_by = bound(2 * q * v * m * (d + 1), H100_FP32,
                     (t, vv, tw, vw, got))
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  case = {"shape": f"{q} x {v}, K {m * d}", "max_abs_err": max_err,
          "tile": similarity.TILES[similarity.pick_tile(q, v, sms)],
          "ms": time_ms(torch, call), "device_ms": dev_ms,
          "scratch_fill_device_ms": fill,
          "plain_ms": time_ms(torch,
                              lambda: similarity.sim_plain(t, vv, tw, vw)),
          "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": time_ms(torch, lambda: torch.mm(t, vv.T))}
  print(f"moe_similarity {what} Q={q} V={v} K={m * d} (tile "
        f"{case['tile']}): max_abs_err={max_err:.3e} kernel_ms="
        f"{case['ms']:.4f} device_ms={dev_ms:.4f} (k-major scratch fill "
        f"{fill:.4f}, {fill / dev_ms:.2%}) plain_ms={case['plain_ms']:.4f} "
        f"library_ms={case['library_ms']:.4f} (fp32 torch.mm of the "
        f"numerator) bound {b_ms:.6f} ms ({b_by}) card: {card}", flush=True)
  return case


def serve_kernel_cases(torch, ffn, similarity, dev, card):
  """Phase 12 (c): B1 at the serving path's text rows (SERVE_FFN_ROWS x
  768, I 3,072, bf16; phase 1's bf16 rules, every row tile bitwise
  equal) and B4 at SERVE_SIM_CASES (K 3,584; 1e-5) against their plain
  versions, each in CUDA-event ms and device ms, B4 also beside the fp32
  ``torch.mm`` of its numerator and with the device time of its k-major
  scratch fill.  Returns the further shapes of the ``ffn_block`` and
  ``moe_similarity`` entries (their own generator: the draws of the
  earlier phases are kept)."""
  gen = torch.Generator(device=dev).manual_seed(1212)
  ffn_shapes = [dict(eval_ffn_case(torch, ffn, dev, gen, r, 768, "serving",
                                   card),
                     launches_per_query_batch=TEXT_LAYERS)
                for r in SERVE_FFN_ROWS]
  sim_shapes = [dict(sim_case(torch, similarity, dev, gen, q, v, SERVE_M,
                              "serving", card),
                     launches_per_query_batch=0)
                for q, v in SERVE_SIM_CASES]
  torch.cuda.empty_cache()
  return ffn_shapes, sim_shapes


# Phase 13: the config matrix through the port's CLI on phase 11's corpus.
MATRIX_STEPS = 8     # one epoch of b32 steps a run (a depth cut from 12)
MATRIX_WE_DIM = 300                     # the registry's speech / ocr width
MATRIX_RUNS = {
    # name: (arch.args, optimizer or None, per-step B2 / B3, B1 per eval
    # batch, the frozen parameters' name prefixes)
    "a": ({"txt_agg": "bertfrz4", "txt_inp": "bertftn", "pos_enc": "ordr",
           "out_tok": "mnp", "vid_wgh": "emb"},
          {"type": "Ranger", "args": {"lr": 5e-5, "k": 6}}, 16, 16,
          tuple(f"txt_bert.encoder.layer.{i}." for i in range(4))),
    "b": ({"vid_cont": "coll", "vid_inp": "agg", "vid_wgh": "nrm",
           "txt_agg": "bertftnmxp", "txt_pro": "gem",
           "keep_missing_modalities": False}, None, 12, 12, ()),
    "c": ({"txt_inp": "wo2vfrz", "txt_agg": "vlad"}, None, 4, 4,
          ("word_embeddings.",)),
}


def matrix_config(data_dir, save_dir, name):
  """Phase 11's config for run ``name``: one epoch of MATRIX_STEPS b32
  steps, both evals on the val split, the run's switches."""
  args, optimizer, *_ = MATRIX_RUNS[name]
  cfg = cli_config(data_dir, save_dir, 1)
  mix = cfg["continuous_eval_sets"][0]["args"]["mix"][0]
  mix["split_name"] = "val"
  cfg["arch"]["args"].update(args)
  if optimizer is not None:
    cfg["optimizer"] = optimizer
  cfg["trainer"].update(max_samples_per_epoch=32 * MATRIX_STEPS,
                        skip_first_n_saves=1)
  return cfg


def write_word_vectors(path, data_dir, seed=13):
  """A seeded MATRIX_WE_DIM-wide word2vec text file over the corpus's
  caption words."""
  import numpy as np
  from mmt_tpu_torch.data import synthetic
  words = sorted(set(synthetic.TOPICS + synthetic.FILLER))
  rng = np.random.RandomState(seed)
  vecs = rng.randn(len(words), MATRIX_WE_DIM).astype(np.float32)
  with open(path, "w") as f:
    f.write(f"{len(words)} {MATRIX_WE_DIM}\n")
    for w, v in zip(words, vecs):
      f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")
  return len(words)


def matrix_first_step(torch, ops, cfg_path, card, name):
  """The first train step of run ``name`` on the kernel path against the
  plain path (phase 8's check), from one trainer's initial weights, its
  first batch and one dropout seed.  Then the fp32 witness: the same
  step, state and batch through a float32 model, on the plain path and on
  the kernel path (its fp32 instantiations), held to each other at
  STEP_FP32_TOLS; the bf16 paths' distances from the plain fp32 step are
  printed.  Returns CPU copies of the initial weights of the run's frozen
  parameters and the trainer's tokenizer."""
  import argparse

  from mmt_tpu_torch import cli, config as config_lib
  from mmt_tpu_torch.data import loader as loader_lib
  from mmt_tpu_torch.models.cenet import similarity_from_outputs
  from mmt_tpu_torch.train.trainer import model_batch

  def build(path):
    ns = argparse.Namespace(config=str(path), resume=None,
                            load_checkpoint=None, only_eval=False,
                            txt_bert_init=None)
    return cli.build_trainer(config_lib.from_args(ns), device="cuda")

  trainer = build(cfg_path)
  model = trainer.model.train()
  frozen = MATRIX_RUNS[name][4]
  init = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
          if n.startswith(frozen)}
  entry = trainer.data_loaders["train_sets"][0]
  batch = next(loader_lib.device_prefetch(
      iter([model_batch(next(iter(entry["loader"])))]), trainer.device))
  state0 = {k: v.clone() for k, v in model.state_dict().items()}

  # The max-pools (txt_agg bert*mxp) route each gradient to one token: a
  # bf16 rounding between the paths that reorders two near-equal values
  # moves a whole gradient entry to another token.  The other steps take
  # the kernel path's routing (max values gathered at its indices) so that
  # the checks hold the kernels' arithmetic; the reordered share is shown.
  amax, routes = torch.Tensor.amax, []

  def recording_amax(t, dim, keepdim=False):
    routes.append(t.detach().argmax(dim, keepdim=True))
    return amax(t, dim, keepdim)

  def replaying(replay):
    def replaying_amax(t, dim, keepdim=False):
      idx = next(replay)
      flips[0] += int((t.detach().argmax(dim, keepdim=True) != idx).sum())
      flips[1] += idx.numel()
      out = t.gather(dim, idx)
      return out if keepdim else out.squeeze(dim)
    return replaying_amax

  flips = [0, 0]

  def step(m, plain, record=False):
    m.load_state_dict(state0)
    m.zero_grad(set_to_none=True)
    gen = torch.Generator(device=trainer.device).manual_seed(17)
    torch.Tensor.amax = (recording_amax if record
                         else replaying(iter(list(routes))))
    try:
      with ops.plain_versions() if plain else contextlib.nullcontext():
        out = m(batch, train=True, generator=gen)
        loss = trainer.loss_fn(similarity_from_outputs(out, merge="avg"))
        loss.backward()
    finally:
      torch.Tensor.amax = amax
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                                  m.named_parameters() if p.requires_grad}

  loss_k, grads_k = step(model, False, record=True)
  loss_p, grads_p = step(model, True)
  print(f"matrix {name}: the plain path's own max-pool argmax differs from "
        f"the kernel path's at {flips[0]} of {flips[1]} maxima (routing "
        "held to the kernel path's below)", flush=True)
  check_step(torch, f"matrix {name} first step kernel vs plain", loss_k,
             loss_p, grads_k, grads_p)
  if any(p.grad is not None for n, p in model.named_parameters()
         if not p.requires_grad):
    raise RuntimeError(f"matrix {name}: a frozen parameter holds a gradient")
  tokenizer = trainer.tokenizer

  # The fp32 witness, from the same state and batch.
  cfg32 = json.loads(pathlib.Path(cfg_path).read_text())
  cfg32["arch"]["args"]["compute_dtype"] = "float32"
  path32 = pathlib.Path(cfg_path).with_name(f"{name}_fp32.json")
  path32.write_text(json.dumps(cfg32))
  model32 = build(path32).model.train()
  loss_f, grads_f = step(model32, True)
  loss_kf, grads_kf = step(model32, False)
  check_step(torch, f"matrix {name} first step fp32 kernel vs plain",
             loss_kf, loss_f, grads_kf, grads_f, tols=STEP_FP32_TOLS)

  def off(grads):
    """All gradients' rel L2 distance from the fp32 step's, and the worst
    relative miss of one one-element gradient."""
    diffs = grad_diffs(grads, grads_f)
    scalar = max((abs(float(grads[n]) - float(g)) / abs(float(g))
                  for n, g in grads_f.items() if g.numel() == 1 and g != 0),
                 default=0.0)
    return (sum(d * d for d, _ in diffs.values())
            / sum(ref * ref for _, ref in diffs.values())) ** 0.5, scalar

  (k_all, k_one), (p_all, p_one) = off(grads_k), off(grads_p)
  print(f"matrix {name} bf16 paths vs the fp32 step: all grads rel L2 "
        f"kernel {k_all:.3e}, plain {p_all:.3e}; worst one-element "
        f"gradient's relative miss kernel {k_one:.3e}, plain {p_one:.3e}; "
        f"loss kernel {abs(loss_k - loss_f):.3e}, plain "
        f"{abs(loss_p - loss_f):.3e}", flush=True)
  del trainer, model, model32, batch, state0, grads_k, grads_p, grads_f
  del grads_kf
  torch.cuda.empty_cache()
  return init, tokenizer


def matrix_phase(torch, ops, ffn, similarity, cfg_path, card):
  """Phase 13: three short runs of ``mmt_tpu_torch.cli`` at the flagship
  widths on phase 11's corpus (7 experts, cut c), bf16, b32, one epoch of
  MATRIX_STEPS steps, then the evals: (a) bertfrz4 over bertftn input,
  ordr, mnp, vid_wgh emb, Ranger k 6; (b) collaborative gating over the
  pooled experts (vid_inp agg, vid_wgh nrm), bertftnmxp, gem, missing
  modalities dropped; (c) wo2vfrz word vectors (300 wide) into NetVLAD.
  Each: its first step on the kernel path against the plain path, the
  exact launches of the counted run (set to 0 just before it), the frozen
  parameters bitwise unmoved and without a gradient, and a line with the
  median step ms, the eval seconds and the launches.  Runs inside phase
  11 (its corpus, vocab and expert names).  Returns {run: launches}."""
  import numpy as np

  from mmt_tpu_torch.train import trainer as trainer_lib
  from mmt_tpu_torch.utils import timing

  class RecordingMeter(timing.AverageMeter):
    seen = {}

    def update(self, key, val, n=1):
      super().update(key, val, n)
      RecordingMeter.seen.setdefault(key, []).append(val)

  cfg = json.loads(pathlib.Path(cfg_path).read_text())
  data_dir = cfg["train_sets"][0]["args"]["mix"][0]["data_dir"]
  root = pathlib.Path(cfg_path).parent / "matrix"
  root.mkdir()
  vectors = root / "vectors.txt"
  n_words = write_word_vectors(vectors, data_dir)
  prev_meter = trainer_lib.AverageMeter
  prev_vectors = os.environ.get("MMT_TPU_WORD_VECTORS")
  os.environ["MMT_TPU_WORD_VECTORS"] = str(vectors)
  trainer_lib.AverageMeter = RecordingMeter
  out = {}
  try:
    for name, (_, _, per_step, per_eval_batch, frozen) in \
        MATRIX_RUNS.items():
      tic = time.perf_counter()
      cfg_run = root / f"{name}.json"
      cfg_run.write_text(json.dumps(matrix_config(
          data_dir, root / f"probe_{name}", name)))
      init, tokenizer = matrix_first_step(torch, ops, cfg_run, card, name)
      shutil.rmtree(root / f"probe_{name}", ignore_errors=True)
      exp = root / f"exp_{name}"
      cfg_run.write_text(json.dumps(matrix_config(data_dir, exp, name)))
      eval_bs = cfg["final_eval_sets"][0]["args"]["batch_size"]
      eval_batches = 3 * -(-CLI_VAL_VIDEOS // eval_bs)   # epochs 0, 1, final
      want = {"ffn_block": per_eval_batch * eval_batches,
              "ffn_train_fwd": per_step * MATRIX_STEPS,
              "ffn_train_bwd": per_step * MATRIX_STEPS,
              "moe_similarity": MATRIX_STEPS + 3}
      RecordingMeter.seen = {}
      trainer = cli_run(ffn, similarity, ["--config", str(cfg_run),
                                          "--device", "cuda"],
                        want, f"matrix {name}")
      if trainer.n_steps != MATRIX_STEPS:
        raise RuntimeError(f"matrix {name}: n_steps {trainer.n_steps}")
      params = dict(trainer.model.named_parameters())
      moved = [n for n, t in init.items() if not torch.equal(
          params[n].detach().cpu(), t)]
      held = [n for n in init if params[n].grad is not None
              or params[n].requires_grad]
      if (frozen and not init) or moved or held:
        raise RuntimeError(f"matrix {name}: frozen parameters {len(init)}, "
                           f"moved {moved[:3]}, with a gradient {held[:3]}")
      if name == "c":
        table = params["word_embeddings.word_embeddings.weight"]
        table = table.detach().cpu().numpy()
        if (table.shape != (n_words + 2, MATRIX_WE_DIM)
            or not np.array_equal(table, tokenizer.weights)
            or table[:2].any()):
          raise RuntimeError("matrix c: the word table is not the file's")
      losses = [json.loads(line)["loss"]
                for line in (exp / "perf_log.txt").read_text().splitlines()]
      if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"matrix {name}: epoch losses {losses}")
      results = json.loads((exp / "exp_results.json").read_text())["perfs"]
      finals = [v for d in results.values() for v in d.values()]
      if not all(math.isfinite(v) for v in finals):
        raise RuntimeError(f"matrix {name}: final eval {results}")
      seen = RecordingMeter.seen
      step_ms = statistics.median(seen["train_batch.total"]) * 1e3
      eval_s = sum(seen[k][-1] for k in ("valid.embds", "valid.conf_mat",
                                         "valid.metrics"))
      print(f"matrix {name}: {json.dumps(MATRIX_RUNS[name][0])}; "
            f"{len(init)} frozen parameters unmoved; epoch losses {losses}; "
            f"median step {step_ms:.3f} ms over {MATRIX_STEPS} steps (all "
            f"{[round(x * 1e3, 3) for x in seen['train_batch.total']]}); "
            f"final eval {eval_s:.6f} s; launches {json.dumps(want)}; "
            f"run {time.perf_counter() - tic:.1f} s card: {card}",
            flush=True)
      out[name] = want
      shutil.rmtree(exp, ignore_errors=True)
      del trainer, params
      torch.cuda.empty_cache()
    return out
  finally:
    trainer_lib.AverageMeter = prev_meter
    if prev_vectors is None:
      os.environ.pop("MMT_TPU_WORD_VECTORS", None)
    else:
      os.environ["MMT_TPU_WORD_VECTORS"] = prev_vectors
    shutil.rmtree(root, ignore_errors=True)


class PhaseClock:
  """Seconds of each phase: ``done(name)`` ends the phase that began at
  the last call (or at construction) and prints its seconds."""

  def __init__(self):
    self.start = self.last = time.perf_counter()
    self.seconds = {}

  def done(self, name):
    now = time.perf_counter()
    self.seconds[name] = now - self.last
    self.last = now
    print(f"phase {name}: {self.seconds[name]:.1f} s", flush=True)

  def total(self):
    return time.perf_counter() - self.start


# Phase 14 (c): the CLI over two processes on phase 11's corpus.
DP_CLI_TIMEOUT = 600.0
DP_CLI_LOSS_RTOL, DP_CLI_SIMS_TOL = 1e-3, 2e-2
DP_CLI_STEPS = 4     # b32 steps of the epoch (a depth cut from 8)


def dp_cli_config(data_dir, save_dir, shipped_workers):
  """Phase 11's config for one epoch of DP_CLI_STEPS steps, the
  continuous eval of the val split's CLI_VAL_VIDEOS videos fused (no
  visualizer, which reads the matrix), no checkpoint at epoch 0 (depth
  cuts from 8 steps, the 1,000 train videos and the epoch-0
  checkpoint).  The loaders keep the shipped
  config's worker threads (which a group runs at 0) or, for the one
  process, run at 0: its batches are then the ones a group's ranks
  assemble."""
  cfg = val_continuous_eval(cli_config(data_dir, save_dir, 1))
  cfg.pop("visualizer", None)
  cfg["trainer"].update(fused_eval_from_videos=CLI_VAL_VIDEOS,
                        skip_first_n_saves=1,
                        max_samples_per_epoch=32 * DP_CLI_STEPS)
  if not shipped_workers:
    for key in ("train_sets", "continuous_eval_sets", "final_eval_sets"):
      cfg[key][0]["args"]["num_workers"] = 0
  return cfg


@contextlib.contextmanager
def recorded_run():
  """While a training run lasts, record each step's loss (as
  ``train_step`` returns it; read when the run is over) and a digest of
  every host batch the loaders yield, train and eval alike: yields
  {"losses": [...], "batches": [...]}, filled in on exit."""
  import hashlib

  import numpy as np

  from mmt_tpu_torch.data import loader as loader_lib
  from mmt_tpu_torch.train import trainer as trainer_lib
  rec = {"losses": [], "batches": []}
  step_fn, iter_fn = trainer_lib.train_step, loader_lib.BatchLoader.__iter__

  def step(*args, **kw):
    loss = step_fn(*args, **kw)
    rec["losses"].append(loss.detach())
    return loss

  def digest(x, h):
    if isinstance(x, dict):
      for k in sorted(x):
        h.update(k.encode())
        digest(x[k], h)
    elif isinstance(x, np.ndarray) and x.dtype != object:
      h.update(f"{x.dtype}{x.shape}".encode())
      h.update(np.ascontiguousarray(x).tobytes())
    else:
      h.update(repr(x.tolist() if isinstance(x, np.ndarray) else x).encode())

  def batches(self):
    for batch in iter_fn(self):
      h = hashlib.sha256()
      digest(batch, h)
      rec["batches"].append(h.hexdigest()[:16])
      yield batch

  trainer_lib.train_step = step
  loader_lib.BatchLoader.__iter__ = batches
  try:
    yield rec
  finally:
    trainer_lib.train_step = step_fn
    loader_lib.BatchLoader.__iter__ = iter_fn
    rec["losses"] = [float(x) for x in rec["losses"]]


def dp_cli_rank(argv, out_path):
  """One rank of phase 14 (c), in a process of its own with the
  MMT_TPU_* variables set: ``python -m mmt_tpu_torch.train argv`` (run as
  that module), with phase 11's expert names, then this process's launch
  counts, step losses and batch digests (``recorded_run``) written to
  ``out_path``."""
  import runpy

  from mmt_tpu_torch import bench_sustained

  counters = dp_counters()
  for fn in counters.values():
    fn.launches = 0
  sys.argv = ["mmt_tpu_torch.train", *argv]
  with bench_sustained.flagship_expert_names(), recorded_run() as rec:
    runpy.run_module("mmt_tpu_torch.train", run_name="__main__")
  pathlib.Path(out_path).write_text(json.dumps(
      dict(rec, launches={n: fn.launches for n, fn in counters.items()})))


def cli_ranks(cfg_dir, tag, size):
  """Run ``dp_cli_rank`` on ``cfg_dir/<tag>_two.json`` in ``size``
  processes joined over the MMT_TPU_* variables (the card shared over
  gloo), within DP_CLI_TIMEOUT; every process is stopped by the end.
  Returns each rank's output, its record (``recorded_run``: step losses,
  batch digests) and its launches, and the wall seconds; a rank that
  fails raises with its output."""
  from mmt_tpu_torch.parallel import mesh as mesh_lib

  port = mesh_lib._free_port()
  root = pathlib.Path(__file__).resolve().parent
  procs, logs = [], []
  tic = time.perf_counter()
  argv = ["--config", str(cfg_dir / f"{tag}_two.json"), "--device", "cuda"]
  for rank in range(size):
    env = dict(os.environ, MMT_TPU_COORDINATOR=f"localhost:{port}",
               MMT_TPU_NUM_PROCESSES=str(size),
               MMT_TPU_PROCESS_ID=str(rank))
    logs.append(open(cfg_dir / f"{tag}_rank{rank}.out", "w"))
    code = (f"import chip_smoke; chip_smoke.dp_cli_rank({argv!r}, "
            f"{str(cfg_dir / f'{tag}_run{rank}.json')!r})")
    procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                  env=env, stdout=logs[-1],
                                  stderr=subprocess.STDOUT))
  try:
    for p in procs:
      p.wait(timeout=max(DP_CLI_TIMEOUT - (time.perf_counter() - tic), 1.0))
  except subprocess.TimeoutExpired:
    pass
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
    for f in logs:
      f.close()
  seconds = time.perf_counter() - tic
  outs = [(cfg_dir / f"{tag}_rank{r}.out").read_text() for r in range(size)]
  for rank, (p, out) in enumerate(zip(procs, outs)):
    if p.returncode != 0:
      raise RuntimeError(f"{tag} cli rank {rank} exited {p.returncode}:\n"
                         f"{out[-4000:]}")
  recs = [json.loads((cfg_dir / f"{tag}_run{r}.json").read_text())
          for r in range(size)]
  launches = [rec.pop("launches") for rec in recs]
  return outs, recs, launches, seconds


def dp_cli_phase(torch, cfg_dir, data_dir, card):
  """Phase 14 (c): the flagship config (b32, one epoch of 8 steps, the
  fused host-staged continuous eval of the 1,000 train videos at epochs
  0 and 1, the final eval of 32) through two ``mmt_tpu_torch.train``
  processes sharing the card, and through ``cli.main`` in this process:
  per-rank launches exact, the ranks' host batches the one process's,
  the step losses and their gaps, the epoch loss within 1e-3 relative,
  the final sims within 2e-2, one set of artifacts.  Returns rank 0's
  launches and the one process's run (phase 15 (b)'s reference): its
  step losses and batch digests, epoch losses, final sims and the keys
  and shapes of its trained_model.pth."""
  import numpy as np

  from mmt_tpu_torch import cli

  exps = {n: cfg_dir / f"dp_exp_{n}" for n in ("two", "one")}
  cfgs = {name: dp_cli_config(data_dir, exp, shipped_workers=name == "two")
          for name, exp in exps.items()}
  for name, cfg in cfgs.items():
    (cfg_dir / f"dp_{name}.json").write_text(json.dumps(cfg))
  threaded = sum(cfgs["two"][key][0]["args"]["num_workers"] > 0
                 for key in ("train_sets", "continuous_eval_sets",
                             "final_eval_sets"))
  per_eval = -(-CLI_VAL_VIDEOS // 32)
  steps = DP_CLI_STEPS
  want = {n: 0 for n in DP_COUNTED}
  want.update(ffn_block=FFN_LAYERS * (2 * per_eval + 1),
              ffn_train_fwd=FFN_LAYERS * steps,
              ffn_train_bwd=FFN_LAYERS * steps,
              moe_similarity=steps + 1, fused_ranks=2 * 2)

  outs, recs, launches, two_s = cli_ranks(cfg_dir, "dp", DP_SIZE)
  if "host-staged" not in outs[0]:
    raise RuntimeError("dp cli: the continuous eval did not take the "
                       "host-staged fused path")
  workers = [line for line in outs[0].splitlines() if "-> 0" in line]
  print(f"dp cli rank 0: {len(workers)} of the config's {threaded} loaders "
        f"with worker threads run without them ({workers[:1]})", flush=True)
  if len(workers) != threaded or not threaded:
    raise RuntimeError("dp cli: the shipped config's loader workers were "
                       "not set to 0 in the group")
  for rank, got in enumerate(launches):
    print(f"dp cli rank {rank} launches: {got}", flush=True)
    if got != want:
      raise RuntimeError(f"dp cli rank {rank}: expected launches {want}, "
                         f"got {got}")

  counters = dp_counters()
  for fn in counters.values():
    fn.launches = 0
  tic = time.perf_counter()
  with recorded_run() as one_rec:
    cli.main(["--config", str(cfg_dir / "dp_one.json"), "--device", "cuda"])
  torch.cuda.synchronize()
  one_s = time.perf_counter() - tic
  got = {n: fn.launches for n, fn in counters.items()}
  print(f"dp cli one process launches: {got}", flush=True)
  if got != want:
    raise RuntimeError(f"dp cli one process: expected launches {want}, got "
                       f"{got}")

  # Lockstep: every rank's loaders yielded the one process's batches, in
  # its order.  The step losses: the same on both ranks (one global loss),
  # step 1's within phase 8's tolerance of the one process's (the same
  # weights, batch and masks), then apart by the kernels' bf16 rounding as
  # the runs' weights drift.
  same_batches = [rec["batches"] == one_rec["batches"] for rec in recs]
  print(f"dp cli: {len(one_rec['batches'])} host batches (train and eval); "
        f"each rank's digests equal the one process's: {same_batches}",
        flush=True)
  if not all(same_batches):
    first = next(i for i, (a, b) in enumerate(
        itertools.zip_longest(recs[0]["batches"], one_rec["batches"]))
        if a != b)
    raise RuntimeError(f"dp cli: the ranks' batches are not the one "
                       f"process's (first difference at host batch {first})")
  two_steps, one_steps = recs[0]["losses"], one_rec["losses"]
  gaps = [abs(a - b) / abs(b) for a, b in zip(two_steps, one_steps)]
  print(f"dp cli step losses: two processes {two_steps} one {one_steps}; "
        f"relative gap per step {[f'{g:.3e}' for g in gaps]}; ranks' losses "
        f"equal: {recs[1]['losses'] == two_steps}", flush=True)
  if (len(two_steps) != steps or len(one_steps) != steps
      or recs[1]["losses"] != two_steps
      or not abs(two_steps[0] - one_steps[0]) <= STEP_LOSS_TOL):
    raise RuntimeError("dp cli: step losses out of step (count, the ranks' "
                       f"agreement or step 1 beyond {STEP_LOSS_TOL})")

  losses, sims = {}, {}
  for name, exp in exps.items():
    with open(exp / "perf_log.txt") as f:
      losses[name] = [json.loads(line)["loss"] for line in f]
    sims[name] = np.load(exp / "MSRVTT-val-sims.npy",
                         allow_pickle=True)[()]["sims"]
  rel = abs(losses["two"][-1] - losses["one"][-1]) / abs(losses["one"][-1])
  diff = float(np.abs(sims["two"] - sims["one"]).max())
  results = {n: json.loads((e / "exp_results.json").read_text())["perfs"]
             for n, e in exps.items()}
  print(f"dp cli: epoch losses two processes {losses['two']} one "
        f"{losses['one']} (rel diff {rel:.3e}, limit {DP_CLI_LOSS_RTOL:.0e}); "
        f"final sims max_abs_diff={diff:.3e} (limit {DP_CLI_SIMS_TOL:.0e}); "
        f"final eval two {json.dumps(results['two'])} one "
        f"{json.dumps(results['one'])}", flush=True)
  if not rel <= DP_CLI_LOSS_RTOL or not np.isfinite(sims["two"]).all() \
     or diff > DP_CLI_SIMS_TOL:
    raise RuntimeError(f"dp cli: two processes vs one: loss rel diff {rel},"
                       f" sims diff {diff}")
  listing = lambda exp: sorted(str(p.relative_to(exp))
                               for p in exp.rglob("*") if p.is_file()
                               and "tfevents" not in p.name)
  two, one = listing(exps["two"]), listing(exps["one"])
  # TensorBoard (where tensorboardX is installed) names its files by the
  # second and the host: counted, not named.
  streams = [len(list(exps[n].glob("*tfevents*"))) for n in ("two", "one")]
  print(f"dp cli: artifacts of two processes {two} ({streams[0]} "
        f"TensorBoard streams), of one {one} ({streams[1]}); wall two "
        f"processes {two_s:.1f} s (start-up, loaders and the build's load "
        f"included), one process {one_s:.1f} s; two gloo ranks sharing one "
        f"card, no claim of speed card: {card}", flush=True)
  if ([f for f in two if f != "log.p1.txt"] != one
      or "log.p1.txt" not in two or streams[0] != streams[1]):
    raise RuntimeError("dp cli: two processes did not write one set of "
                       "artifacts")
  ref = dict(one_rec, epoch_losses=losses["one"], sims=sims["one"],
             ckpt=checkpoint_layout(torch, exps["one"] / "trained_model.pth"))
  for exp in exps.values():
    shutil.rmtree(exp, ignore_errors=True)
  return launches[0], ref


def checkpoint_layout(torch, path):
  """{entry: shape} of a .pth's parameters and optimizer state."""
  state = torch.load(path, map_location="cpu", weights_only=True)
  layout = {f"state_dict/{k}": tuple(v.shape)
            for k, v in state["state_dict"].items()}
  for i, entry in state.get("optimizer", {}).get("state", {}).items():
    layout.update({f"optimizer/{i}/{k}": tuple(v.shape)
                   for k, v in entry.items()})
  return layout


# Phase 15 (b): the trainer at model_parallel 2 through the CLI, on phase
# 14 (c)'s corpus and config (1 data x 2 model ranks sharing the card).
# The bf16 run's epoch loss is bounded for divergence only: its gradients
# take TP's roundings, which Adam amplifies (2.0e-3 relative on an NVIDIA
# H100 80GB HBM3 at 700 W); the fp32 witness (step and epoch losses
# relative, final sims absolute) is the precise gate.
TP_CLI_SIZE = 2
TP_CLI_BF16_LOSS_RTOL = 1e-2
TP_CLI_FP32_TOLS = (1e-5, 1e-4)
TP_FP32_STEPS = 2   # the witness's epoch: 2 b32 steps (a depth cut from 4)


def tp_cli_phase(torch, cfg_dir, data_dir, ref, card):
  """Phase 15 (b): phase 14 (c)'s config with ``model_parallel`` 2 through
  two ``mmt_tpu_torch.train`` processes (1 data x 2 model ranks, gloo,
  the card shared; the shipped loader workers, run at 0): per rank
  exactly 16 B7 and 16 B3 (add_dz off) a step, 16 B6 an eval batch, one
  B4 a step and the final eval's, phase 14 (c)'s B5, no B1 or B2; every
  host batch, step 1's loss (STEP_LOSS_TOL), the epoch loss
  (TP_CLI_BF16_LOSS_RTOL) and the final sims (DP_CLI_SIMS_TOL) against
  ``ref``, phase 14 (c)'s one-process run (every later step's gap
  printed); the trained_model.pth in the one-process layout; then
  ``--only_eval --load_checkpoint`` of it in this one process (B1,
  unsharded) within TP_SIMS_TOL of the TP run's final sims; last the
  fp32 witness (``tp_fp32_witness``).  Returns rank 0's launches."""
  import numpy as np

  from mmt_tpu_torch import cli

  exp, eval_exp = cfg_dir / "tp_exp", cfg_dir / "tp_eval_exp"
  cfg = dp_cli_config(data_dir, exp, shipped_workers=True)
  cfg["trainer"]["model_parallel"] = TP_CLI_SIZE
  (cfg_dir / "tp_two.json").write_text(json.dumps(cfg))
  (cfg_dir / "tp_eval.json").write_text(json.dumps(
      dp_cli_config(data_dir, eval_exp, shipped_workers=False)))
  per_eval = -(-CLI_VAL_VIDEOS // 32)
  steps = DP_CLI_STEPS
  want = {n: 0 for n in DP_COUNTED}
  want.update(ffn_partial=FFN_LAYERS * (2 * per_eval + 1),
              ffn_train_fwd_partial=FFN_LAYERS * steps,
              ffn_train_bwd=FFN_LAYERS * steps,
              moe_similarity=steps + 1, fused_ranks=2 * 2)

  outs, recs, launches, tp_s = cli_ranks(cfg_dir, "tp", TP_CLI_SIZE)
  for rank, (out, got) in enumerate(zip(outs, launches)):
    print(f"tp cli rank {rank} launches: {got}", flush=True)
    if f"tensor parallel: model rank {rank} of {TP_CLI_SIZE}" not in out:
      raise RuntimeError(f"tp cli rank {rank}: no tensor-parallel layout "
                         "in its log")
    if got != want:
      raise RuntimeError(f"tp cli rank {rank}: expected launches {want}, "
                         f"got {got}")
  if "host-staged" not in outs[0]:
    raise RuntimeError("tp cli: the continuous eval was not host-staged")
  same = [rec["batches"] == ref["batches"] for rec in recs]
  print(f"tp cli: {len(ref['batches'])} host batches; each rank's digests "
        f"equal phase 14 (c)'s one process's: {same}", flush=True)
  if not all(same):
    raise RuntimeError("tp cli: the ranks' batches are not the one "
                       "process's")
  tp_steps, one_steps = recs[0]["losses"], ref["losses"]
  gaps = [abs(a - b) / abs(b) for a, b in zip(tp_steps, one_steps)]
  print(f"tp cli step losses: two ranks {tp_steps} one process {one_steps}; "
        f"relative gap per step {[f'{g:.3e}' for g in gaps]}; ranks' losses "
        f"equal: {recs[1]['losses'] == tp_steps}", flush=True)
  if (len(tp_steps) != steps or recs[1]["losses"] != tp_steps
      or not abs(tp_steps[0] - one_steps[0]) <= STEP_LOSS_TOL):
    raise RuntimeError("tp cli: step losses out of step (count, the ranks' "
                       f"agreement or step 1 beyond {STEP_LOSS_TOL})")
  with open(exp / "perf_log.txt") as f:
    losses = [json.loads(line)["loss"] for line in f]
  rel = abs(losses[-1] - ref["epoch_losses"][-1]) / abs(
      ref["epoch_losses"][-1])
  sims = np.load(exp / "MSRVTT-val-sims.npy", allow_pickle=True)[()]["sims"]
  diff = float(np.abs(sims - ref["sims"]).max())
  layout = checkpoint_layout(torch, exp / "trained_model.pth")
  print(f"tp cli: epoch losses {losses} one process {ref['epoch_losses']} "
        f"(rel diff {rel:.3e}, bf16 limit {TP_CLI_BF16_LOSS_RTOL:.0e}); "
        f"final sims max_abs_diff={diff:.3e} (limit {DP_CLI_SIMS_TOL:.0e}); "
        f"trained_model.pth has the one process's {len(layout)} entries and "
        f"shapes: {layout == ref['ckpt']}; wall {tp_s:.1f} s (two gloo "
        f"ranks sharing one card, no claim of speed) card: {card}",
        flush=True)
  if (not rel <= TP_CLI_BF16_LOSS_RTOL or not np.isfinite(sims).all()
      or diff > DP_CLI_SIMS_TOL or layout != ref["ckpt"]):
    raise RuntimeError(f"tp cli: against one process: loss rel diff {rel}, "
                       f"sims diff {diff}, checkpoint layout equal "
                       f"{layout == ref['ckpt']}")

  counters = dp_counters()
  for fn in counters.values():
    fn.launches = 0
  cli.main(["--config", str(cfg_dir / "tp_eval.json"), "--only_eval",
            "--load_checkpoint", str(exp / "trained_model.pth"),
            "--device", "cuda"])
  torch.cuda.synchronize()
  got = {n: fn.launches for n, fn in counters.items()}
  eval_want = {n: 0 for n in DP_COUNTED}
  eval_want.update(ffn_block=FFN_LAYERS * -(-CLI_VAL_VIDEOS // 32),
                   moe_similarity=1)
  unsharded = np.load(eval_exp / "MSRVTT-val-sims.npy",
                      allow_pickle=True)[()]["sims"]
  diff = float(np.abs(unsharded - sims).max())
  print(f"tp cli: --only_eval --load_checkpoint of the TP run's "
        f"trained_model.pth in one process: launches {got}; final sims "
        f"max_abs_diff={diff:.3e} from the TP run's (limit {TP_SIMS_TOL})",
        flush=True)
  if got != eval_want or diff > TP_SIMS_TOL:
    raise RuntimeError(f"tp cli unsharded eval: launches {got} (expected "
                       f"{eval_want}), sims diff {diff}")
  for path in (exp, eval_exp):
    shutil.rmtree(path, ignore_errors=True)
  tp_fp32_witness(torch, cfg_dir, data_dir, card)
  return launches[0]


def tp_fp32_witness(torch, cfg_dir, data_dir, card):
  """Phase 15 (b)'s fp32 witness: the first TP_FP32_STEPS steps of the
  same epoch and the final eval (no continuous eval), in float32 (the
  kernels' fp32 instantiations), by two TP processes and by this one
  process: every
  host batch equal, every step's loss, the epoch loss and the final sims
  within TP_CLI_FP32_TOLS.  In bf16 the TP run's gradients take other
  roundings than the one process's (dz rounded before the residual add,
  as the JAX package adds it), which Adam turns into lr-sized moves; in
  fp32 the two runs are the same computation up to fp32 sum order."""
  import numpy as np

  from mmt_tpu_torch import cli

  exps = {n: cfg_dir / f"tp32_exp_{n}" for n in ("two", "one")}
  for name, exp in exps.items():
    cfg = dp_cli_config(data_dir, exp, shipped_workers=name == "two")
    cfg["arch"]["args"]["compute_dtype"] = "float32"
    cfg["continuous_eval_sets"] = []
    cfg["trainer"]["max_samples_per_epoch"] = 32 * TP_FP32_STEPS
    if name == "two":
      cfg["trainer"]["model_parallel"] = TP_CLI_SIZE
    (cfg_dir / f"tp32_{name}.json").write_text(json.dumps(cfg))
  _, recs, _, tp_s = cli_ranks(cfg_dir, "tp32", TP_CLI_SIZE)
  tic = time.perf_counter()
  with recorded_run() as one:
    cli.main(["--config", str(cfg_dir / "tp32_one.json"), "--device",
              "cuda"])
  torch.cuda.synchronize()
  one_s = time.perf_counter() - tic
  loss_tol, sims_tol = TP_CLI_FP32_TOLS
  gaps = [abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"],
                                              one["losses"])]
  epoch = {n: [json.loads(line)["loss"]
               for line in open(e / "perf_log.txt")][-1]
           for n, e in exps.items()}
  rel = abs(epoch["two"] - epoch["one"]) / abs(epoch["one"])
  sims = {n: np.load(e / "MSRVTT-val-sims.npy", allow_pickle=True)[()]["sims"]
          for n, e in exps.items()}
  diff = float(np.abs(sims["two"] - sims["one"]).max())
  same = [rec["batches"] == one["batches"] for rec in recs]
  print(f"tp cli fp32 witness: {len(one['batches'])} host batches equal "
        f"{same}; step gaps {[f'{g:.3e}' for g in gaps]}; epoch loss rel "
        f"diff {rel:.3e} (limit {loss_tol:.0e} each); final sims "
        f"max_abs_diff={diff:.3e} (limit {sims_tol:.0e}); wall two ranks "
        f"{tp_s:.1f} s, one process {one_s:.1f} s card: {card}", flush=True)
  if (not all(same) or len(gaps) != TP_FP32_STEPS
      or not max(gaps + [rel]) <= loss_tol or not diff <= sims_tol):
    raise RuntimeError(f"tp cli fp32 witness: batches equal {same}, step "
                       f"gaps {gaps}, epoch {rel}, sims {diff}")
  for exp in exps.values():
    shutil.rmtree(exp, ignore_errors=True)


# Phase 18: the shipped flagship config as it is (fp32) through the CLI.
FP32_CLI_STEPS = 4   # one epoch of b32 steps


def fp32_cli_config(data_dir, save_dir):
  """The shipped flagship config with its compute dtype left unset
  (CENet's fp32) and only the data, splits, epochs (one, of
  FP32_CLI_STEPS b32 steps) and save_dir changed, as ``cli_config``; no
  continuous eval, so the run's one eval is the final eval of the
  CLI_VAL_VIDEOS val videos."""
  cfg = cli_config(data_dir, save_dir, 1, compute_dtype=None)
  if "compute_dtype" in cfg["arch"]["args"]:
    raise RuntimeError("fp32 cli: the shipped config sets compute_dtype")
  cfg["continuous_eval_sets"] = []
  cfg["trainer"]["max_samples_per_epoch"] = 32 * FP32_CLI_STEPS
  return cfg


@contextlib.contextmanager
def recorded_tiles(ffn):
  """While open, the tile id of every FFN call the wrappers hand the C
  entry points (``ffn._launch``'s last argument; -1 the WMMA / FMA
  kernel), as (entry point, tile) in the yielded list."""
  calls, real = [], ffn._launch

  def recording(lib, name, dev, *args):
    calls.append((name, args[-1]))
    return real(lib, name, dev, *args)

  ffn._launch = recording
  try:
    yield calls
  finally:
    ffn._launch = real


def fp32_cli_phase(torch, ffn, similarity, cfg_dir, data_dir, meter, card,
                   require_route=True):
  """``cli.main`` on the shipped flagship config in fp32
  (``fp32_cli_config``) on phase 11's corpus: exactly 16 B2 and 16 B3 a
  step, 16 B1 an eval batch, one B4 a step and for the eval, and (with
  ``require_route``) every FFN call on the fp32 route: 0 calls of the FMA
  kernels (a step replayed as a CUDA graph makes no call: its capture's
  are its own).  Prints the step median (the trainer's ``train_batch.total``
  timer) and the eval's seconds (``valid.*``).  Returns the launches and
  those two numbers."""
  exp = cfg_dir / "fp32_exp"
  cfg_path = cfg_dir / "fp32.json"
  cfg_path.write_text(json.dumps(fp32_cli_config(data_dir, exp)))
  batches = -(-CLI_VAL_VIDEOS // 32)
  want = {"ffn_block": FFN_LAYERS * batches,
          "ffn_train_fwd": FFN_LAYERS * FP32_CLI_STEPS,
          "ffn_train_bwd": FFN_LAYERS * FP32_CLI_STEPS,
          "moe_similarity": FP32_CLI_STEPS + 1}
  at = {k: len(v) for k, v in meter.seen.items()}
  from mmt_tpu_torch.train import step
  replayed = step.train_step.replays - step.train_step.captures
  with recorded_tiles(ffn) as calls:
    trainer = cli_run(ffn, similarity, ["--config", str(cfg_path),
                                        "--device", "cuda"], want,
                      "fp32 as shipped")
  # A replayed step launches its FFN kernels without calling the wrappers
  # (its capture called them once); the launch counters count them.
  replayed = step.train_step.replays - step.train_step.captures - replayed
  seen = {k: v[at.get(k, 0):] for k, v in meter.seen.items()}
  dtypes = {p.dtype for p in trainer.model.parameters()}
  cd = trainer.model._arch["compute_dtype"]
  steps_ms = [x * 1e3 for x in seen["train_batch.total"]]
  eval_s = sum(seen[k][0] for k in ("valid.embds", "valid.conf_mat",
                                    "valid.metrics"))
  ffn_launches = sum(want[k] for k in CLI_COUNTED)
  if len(calls) + 2 * FFN_LAYERS * replayed != ffn_launches:
    raise RuntimeError(f"fp32 cli: {len(calls)} FFN calls recorded and "
                       f"{replayed} steps replayed, {ffn_launches} launched")
  fma = sum(1 for _, tile in calls if tile < 0)
  by_entry = {n: sum(1 for m, _ in calls if m == n)
              for n in sorted({m for m, _ in calls})}
  with open(exp / "perf_log.txt") as f:
    losses = [json.loads(line)["loss"] for line in f]
  print(f"fp32 cli: compute dtype {cd}, parameters {sorted(map(str, dtypes))}"
        f"; {len(calls)} FFN calls {by_entry}, {fma} of them on the FMA "
        f"kernels; epoch loss {losses}; b32 step median "
        f"{statistics.median(steps_ms):.3f} ms (all {[round(x, 3) for x in steps_ms]}"
        f"); final eval of {CLI_VAL_VIDEOS} videos {eval_s:.6f} s (embed "
        f"{seen['valid.embds'][0]:.6f}) card: {card}", flush=True)
  if cd != torch.float32 or len(steps_ms) != FP32_CLI_STEPS:
    raise RuntimeError(f"fp32 cli: compute dtype {cd}, steps {steps_ms}")
  if not all(math.isfinite(x) for x in losses):
    raise RuntimeError(f"fp32 cli: epoch losses {losses}")
  if require_route and fma:
    raise RuntimeError(f"fp32 cli: {fma} FFN calls took the FMA kernels")
  shutil.rmtree(exp, ignore_errors=True)
  return want, statistics.median(steps_ms), eval_s


# Phase 19: a user-registered expert through the CLI, and the per-family
# kernel switches.
USER_EXPERT, USER_DIM, USER_IDX = "user_clip", 512, 10   # idx 10: unused
USER_CLI_STEPS = 4      # (a): one epoch of b32 steps
SWITCH_CLI_STEPS = 2    # (b): one epoch of b32 steps a run
# (b): the runs, each with its switch set (an empty dict: both unset).
SWITCH_RUNS = (("MMT_TPU_PALLAS_FFN=0", {"MMT_TPU_PALLAS_FFN": "0"}),
               ("MMT_TPU_PALLAS_SIMILARITY=0",
                {"MMT_TPU_PALLAS_SIMILARITY": "0"}),
               ("both unset", {}))


def user_cli_config(data_dir, save_dir, steps):
  """Phase 11's config (bf16) with USER_EXPERT added to the flagship's
  seven modalities, one epoch of ``steps`` b32 steps and no continuous
  eval: the run's one eval is the final eval of the CLI_VAL_VIDEOS val
  videos."""
  cfg = cli_config(data_dir, save_dir, 1)
  cfg["experts"]["modalities"].append(USER_EXPERT)
  cfg["continuous_eval_sets"] = []
  cfg["trainer"]["max_samples_per_epoch"] = 32 * steps
  return cfg


@contextlib.contextmanager
def user_expert(data_dir):
  """Within the block USER_EXPERT is registered (``register_expert``) and
  its three tables lie beside the flagship's in phase 11's corpus: drawn
  by ``data/synthetic.py`` for the same videos (seed 0: the same topics
  and topic directions, its own features).  Both go on exit."""
  from mmt_tpu_torch import experts
  from mmt_tpu_torch.data import synthetic

  data_dir = pathlib.Path(data_dir)
  tmp = data_dir.parent / "user_expert_corpus"
  tic = time.perf_counter()
  synthetic.generate(tmp, num_videos=CLI_TRAIN_VIDEOS + CLI_VAL_VIDEOS,
                     num_test=CLI_VAL_VIDEOS,
                     experts={USER_EXPERT: USER_DIM},
                     captions_per_video=CLI_CAPTIONS,
                     max_feats=CLI_MAX_FEATS, cut="c")
  tables = []
  for src in sorted((tmp / "MSRVTT" / "aggregated_feats").glob(
      f"{USER_EXPERT}-*.pickle")):
    tables.append(data_dir / "aggregated_feats" / src.name)
    shutil.move(str(src), tables[-1])
  shutil.rmtree(tmp, ignore_errors=True)
  print(f"user-expert: {USER_EXPERT} ({USER_DIM} floats a row, idx "
        f"{USER_IDX}) tables {[p.name for p in tables]} written in "
        f"{time.perf_counter() - tic:.1f} s", flush=True)
  experts.register_expert(experts.ExpertSpec(USER_EXPERT, USER_DIM, USER_IDX,
                                             feat_width=1.0))
  try:
    yield
  finally:
    experts.EXPERT_REGISTRY.pop(USER_EXPERT, None)
    for path in tables:
      path.unlink(missing_ok=True)


@contextlib.contextmanager
def video_lengths(torch):
  """While open, the [batch, tokens] of every sequence the video tower
  (``FeatureBert``) takes, in the yielded list."""
  from mmt_tpu_torch.models.bert import FeatureBert
  seen = []

  def hook(module, args):
    if isinstance(module, FeatureBert):
      seen.append(tuple(args[0].shape[:2]))

  handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
  try:
    yield seen
  finally:
    handle.remove()


def first_step_check(torch, ops, cfg_path, dev, what):
  """The first train step of ``cfg_path``'s run on the kernel path
  against the plain path (phase 8's ``check_step``), from one trainer's
  initial weights, its first batch and one dropout seed."""
  import argparse

  from mmt_tpu_torch import cli, config as config_lib
  from mmt_tpu_torch.data import loader as loader_lib
  from mmt_tpu_torch.models.cenet import similarity_from_outputs
  from mmt_tpu_torch.train.trainer import model_batch

  ns = argparse.Namespace(config=str(cfg_path), resume=None,
                          load_checkpoint=None, only_eval=False,
                          txt_bert_init=None)
  trainer = cli.build_trainer(config_lib.from_args(ns), device=dev)
  model = trainer.model.train()
  entry = trainer.data_loaders["train_sets"][0]
  batch = next(loader_lib.device_prefetch(
      iter([model_batch(next(iter(entry["loader"])))]), trainer.device))
  state0 = {k: v.clone() for k, v in model.state_dict().items()}

  def step(plain):
    model.load_state_dict(state0)
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=trainer.device).manual_seed(19)
    with ops.plain_versions() if plain else contextlib.nullcontext():
      out = model(batch, train=True, generator=gen)
      loss = trainer.loss_fn(similarity_from_outputs(out, merge="avg"))
      loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                                  model.named_parameters() if p.requires_grad}

  loss_k, grads_k = step(False)
  loss_p, grads_p = step(True)
  check_step(torch, what, loss_k, loss_p, grads_k, grads_p)
  del trainer, model, batch, state0, grads_k, grads_p
  torch.cuda.empty_cache()
  return loss_k, loss_p


def user_expert_cli_phase(torch, ops, ffn, dropout, similarity, ranking,
                          cfg_dir, data_dir, meter, dev, card):
  """Phase 19, on phase 11's corpus with USER_EXPERT's tables added
  (``user_expert``).  (a) ``cli.main`` on the flagship config with the
  registered expert as an eighth modality (``user_cli_config``, bf16):
  USER_CLI_STEPS b32 steps and the final eval of the val videos, the
  launches exact (16 B2 and 16 B3 a step, 16 B1 an eval batch, one B4 a
  step and for the eval); the model's ``video_seq_len`` equal to every
  sequence the video tower took; the first step against the plain path
  (``first_step_check``); the step median and the eval's seconds; B1,
  B2, B3 and B4 at the run's new shapes against their plain versions.
  (b) The switches: ``cli.main`` for SWITCH_CLI_STEPS steps and the same
  eval under each of SWITCH_RUNS, exactly the switched family at 0
  launches and the other at its count, the first steps' losses within
  STEP_LOSS_TOL of the unswitched run's; B5 under the similarity switch
  still on its kernel; one ``serve.main`` index build and query batch
  under MMT_TPU_PALLAS_FFN=0 with 0 B1 launches.  Returns (a)'s
  launches, (b)'s, and the kernel cases by kernel."""
  from mmt_tpu_torch import serve, serving

  batches = -(-CLI_VAL_VIDEOS // 32)

  def want(steps, plain=()):
    ffn_on, sim_on = "ffn" not in plain, "similarity" not in plain
    return {"ffn_block": FFN_LAYERS * batches * ffn_on,
            "ffn_train_fwd": FFN_LAYERS * steps * ffn_on,
            "ffn_train_bwd": FFN_LAYERS * steps * ffn_on,
            "moe_similarity": (steps + 1) * sim_on}

  out = {"switch_launches": {}}
  with user_expert(data_dir):
    # (a) the eight-expert flagship through the CLI.
    exp = cfg_dir / "user_exp"
    cfg_path = cfg_dir / "user.json"
    cfg = user_cli_config(data_dir, exp, USER_CLI_STEPS)
    cfg_path.write_text(json.dumps(cfg))
    tokens = cfg["train_sets"][0]["args"]["mix"][0]["max_expert_tokens"]
    at = {k: len(v) for k, v in meter.seen.items()}
    with video_lengths(torch) as lengths:
      trainer = cli_run(ffn, similarity, ["--config", str(cfg_path),
                                          "--device", "cuda"],
                        want(USER_CLI_STEPS), "user expert, 8 experts")
    out["launches"] = want(USER_CLI_STEPS)
    model = trainer.model
    seq = model.video_seq_len(tokens)
    mods = model.modalities
    if (len(mods) != 8 or USER_EXPERT not in mods
        or model.expert_dims[USER_EXPERT] != {"dim": USER_DIM,
                                              "idx": USER_IDX}):
      raise RuntimeError("user expert: the model's experts "
                         f"{model.expert_dims}")
    shapes = sorted(set(lengths))
    if seq != 1 + 8 * (1 + tokens) or {t for _, t in shapes} != {seq}:
      raise RuntimeError(f"user expert: video_seq_len {seq}, sequences "
                         f"{shapes}")
    seen = {k: v[at.get(k, 0):] for k, v in meter.seen.items()}
    steps_ms = [x * 1e3 for x in seen["train_batch.total"]]
    eval_s = sum(seen[k][0] for k in ("valid.embds", "valid.conf_mat",
                                      "valid.metrics"))
    with open(exp / "perf_log.txt") as f:
      losses = [json.loads(line)["loss"] for line in f]
    print(f"user expert: {len(mods)} experts {mods}; video_seq_len "
          f"{seq} = every sequence the video tower took ([batch, tokens] "
          f"{shapes}); epoch loss {losses}; b32 step median "
          f"{statistics.median(steps_ms):.3f} ms (all "
          f"{[round(x, 3) for x in steps_ms]}); final eval of "
          f"{CLI_VAL_VIDEOS} videos {eval_s:.6f} s (embed "
          f"{seen['valid.embds'][0]:.6f}) card: {card}", flush=True)
    if len(steps_ms) != USER_CLI_STEPS or not all(map(math.isfinite,
                                                      losses)):
      raise RuntimeError(f"user expert: steps {steps_ms}, losses {losses}")
    out["step_median_ms"], out["eval_s"] = statistics.median(steps_ms), eval_s
    del trainer, model
    torch.cuda.empty_cache()
    first_step_check(torch, ops, cfg_path, dev,
                     "user expert first step kernel vs plain")

    gen = torch.Generator(device=dev).manual_seed(1919)
    rows = 32 * seq
    out["shapes"] = {
        "ffn_block": [eval_ffn_case(torch, ffn, dev, gen, r, 512, what, card)
                      for r, what in ((rows, "user expert eval"),
                                      (50 * seq, "user expert, 50 videos"))],
        **{k: [case] for k, case in train_ffn_cases(
            torch, ffn, dropout, dev, gen, rows, 512, "user expert step",
            card).items()},
        "moe_similarity": [sim_case(torch, similarity, dev, gen, 32, 32, 8,
                                    "user expert step and eval", card)]}
    torch.cuda.empty_cache()

    # (b) the switches, each in a run of its own.
    first_losses = {}
    for what, environ in SWITCH_RUNS:
      plain = ops.switched_families(environ)
      switch_exp = cfg_dir / "switch_exp"
      path = cfg_dir / "switch.json"
      cfg = user_cli_config(data_dir, switch_exp, SWITCH_CLI_STEPS)
      # One loader thread: the three runs draw the same batches (with
      # workers the order of the samples is the threads').
      cfg["train_sets"][0]["args"]["num_workers"] = 0
      path.write_text(json.dumps(cfg))
      prev = {k: os.environ.pop(k, None) for k in ops.SWITCHES.values()}
      os.environ.update(environ)
      try:
        with recorded_run() as rec:
          cli_run(ffn, similarity, ["--config", str(path), "--device",
                                    "cuda"],
                  want(SWITCH_CLI_STEPS, plain), f"switch {what}")
      finally:
        for k, v in prev.items():
          os.environ.pop(k, None)
          if v is not None:
            os.environ[k] = v
      shutil.rmtree(switch_exp, ignore_errors=True)
      out["switch_launches"][what] = want(SWITCH_CLI_STEPS, plain)
      first_losses[what] = rec["losses"][0]
    base = first_losses["both unset"]
    diffs = {w: abs(x - base) for w, x in first_losses.items()}
    print(f"switches: first-step losses {first_losses}; against both "
          f"unset {diffs} (limit {STEP_LOSS_TOL})", flush=True)
    if not all(d <= STEP_LOSS_TOL for d in diffs.values()):
      raise RuntimeError(f"switches: first-step losses {first_losses}")

    # B5 keeps its kernel under the similarity switch, as in JAX.
    cands = torch.randn(64, 8 * 64, generator=gen, device=dev)
    cw = torch.rand(64, 8, generator=gen, device=dev)
    args = (cands[:16], cands, cw[:16], cw, torch.zeros(16, device=dev),
            torch.arange(16, device=dev), torch.zeros(64, device=dev))
    ranking.fused_counts_cuda.launches = 0
    with ops.environment_switches({"MMT_TPU_PALLAS_SIMILARITY": "0"}):
      closer, _ = ranking.fused_counts(*args)
      if ops.use_kernel(cands, "similarity"):
        raise RuntimeError("switches: B4 on its kernel under "
                           "MMT_TPU_PALLAS_SIMILARITY=0")
    torch.cuda.synchronize()
    want_closer, _ = ranking.fused_counts_plain(*args)
    if (ranking.fused_counts_cuda.launches != 1
        or not torch.equal(closer, want_closer)):
      raise RuntimeError("switches: under MMT_TPU_PALLAS_SIMILARITY=0 the "
                         f"fused ranks launched "
                         f"{ranking.fused_counts_cuda.launches} times")
    out["switch_launches"]["fused ranks, MMT_TPU_PALLAS_SIMILARITY=0"] = {
        "fused_ranks": 1}

    # serve: an index build and one query batch with the FFN kernels off.
    index_path = cfg_dir / "user_index.npz"
    argv = ["--config", str(cfg_path), "--checkpoint",
            str(exp / "trained_model.pth"), "--build_index",
            str(index_path), "--topk", "5", "--device", "cuda"]
    for q in SERVE_CLI_QUERIES:
      argv += ["--query", q]
    def quiet_main():
      with contextlib.redirect_stdout(io.StringIO()):
        return serve.main(argv)

    os.environ["MMT_TPU_PALLAS_FFN"] = "0"
    try:
      results = serve_counted(torch, ffn, similarity, quiet_main,
                              {"ffn_block": 0, "moe_similarity": 0},
                              "MMT_TPU_PALLAS_FFN=0, build + query batch")
    finally:
      os.environ.pop("MMT_TPU_PALLAS_FFN", None)
    ids = set(serving.RetrievalIndex.load(index_path).video_ids)
    check_hits([r["hits"] for r in results], 5, ids, "MMT_TPU_PALLAS_FFN=0")
    print(f"switches: serve with MMT_TPU_PALLAS_FFN=0 answered "
          f"{len(results)} queries over {len(ids)} videos, 0 B1 launches; "
          f"first hits {json.dumps(results[0]['hits'][:2])}", flush=True)
    out["switch_launches"]["serve MMT_TPU_PALLAS_FFN=0"] = {"ffn_block": 0}
    shutil.rmtree(exp, ignore_errors=True)
  return out


# Phase 16: the port's measurement commands on the card.
GEOMETRY_REPS = 5         # bench_geometry's BENCH_REPS default
GEOMETRY_TOL = 2e-2       # kernel path vs plain path, eval sims
# bench_sustained's runs: (what, argv); 1,024 samples an epoch each.
SUSTAINED_RUNS = (("b32", ["--batch", "32", "--samples", "1024"]),
                  ("b128", ["--batch", "128", "--samples", "1024"]),
                  ("b32 --prestage 4", ["--batch", "32", "--samples", "1024",
                                        "--prestage", "4"]))


def phase16_counters(ffn, similarity):
  return {"ffn_block": ffn.ffn_block_cuda,
          "ffn_train_fwd": ffn.ffn_train_fwd_cuda,
          "ffn_train_bwd": ffn.ffn_train_bwd_cuda,
          "moe_similarity": similarity.sim_cuda}


def counted_run(torch, counters, fn, want, what):
  """fn() with ``counters`` set to 0 just before and read just after;
  they must read ``want``.  Returns fn()'s result."""
  for c in counters.values():
    c.launches = 0
  out = fn()
  torch.cuda.synchronize()
  got = {k: c.launches for k, c in counters.items()}
  print(f"{what}: launches {got}", flush=True)
  if got != want:
    raise RuntimeError(f"{what}: expected launches {want}, got {got}")
  return out


def train_ffn_cases(torch, ffn, dropout, dev, gen, r, h, what, card):
  """B2 and B3 (add_dz on, as a step runs it) at R x H, I 3,072, bf16,
  masks at p = 0.1, against their plain versions and the WMMA kernel by
  phase 4's rules, every row tile bitwise equal; each one's CUDA-event
  and device ms, plain ms and bound.  Returns {kernel: the case's
  entry}."""
  cd, i = torch.bfloat16, TRAIN_I
  fargs, dy = train_inputs(torch, dropout, r, h, cd, dev, gen)
  _, drop, w1, _, w2, _, gamma, _ = fargs
  kw = dict(eps=1e-12, compute_dtype=cd)
  fwd, err_f = check_train_kernel(torch, ffn, f"ffn_train_fwd {what} R={r} "
                                  f"H={h}", "ffn_train_fwd", cd, fargs, kw)
  _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
  bargs, bkw = (dy, z, inter, drop, w1, w2, gamma), dict(kw, add_dz=True)
  bwd, err_b = check_train_kernel(torch, ffn, f"ffn_train_bwd {what} R={r} "
                                  f"H={h}", "ffn_train_bwd", cd, bargs, bkw)
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  cases = {}
  for kname, args, kkw, out, err in (
      ("ffn_train_fwd", fargs, kw, fwd, err_f),
      ("ffn_train_bwd", bargs, bkw, bwd, err_b)):
    kernel, plain = (getattr(ffn, f"{kname}_cuda"),
                     getattr(ffn, f"{kname}_plain"))
    b_ms, b_by = bound(4 * r * h * i, H100_BF16, args + tuple(out))
    case = {"shape": f"{r} x {h}, I {i}", "max_abs_err": err,
            "tile_rows": ffn.GEMM_TILES[ffn.pick_gemm_tile(r, h, sms)],
            "ms": time_ms(torch, lambda: kernel(*args, **kkw)),
            "device_ms": device_ms(torch, lambda: kernel(*args, **kkw)),
            "plain_ms": time_ms(torch, lambda: plain(*args, **kkw)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"{kname} {what} R={r} H={h} I={i} bf16 ({case['tile_rows']}-row "
          f"tile): kernel_ms={case['ms']:.4f} device_ms="
          f"{case['device_ms']:.4f} plain_ms={case['plain_ms']:.4f} bound "
          f"{b_ms:.6f} ms ({b_by}) card: {card}", flush=True)
    cases[kname] = case
  return cases


def geometry_step_check(torch, ops, bench, bench_geometry, geom, name, dev,
                        counters, per_step):
  """The first train step of the geometry (bench_geometry's step, from
  ``bench.train_stepper``) on the kernel path, its launches counted alone
  (they must read ``per_step``), against the plain path from the same
  state, batch and dropout seed, by ``check_step``'s rules.  Returns the
  step's launches."""
  from mmt_tpu_torch.train import losses, optim, step

  model, batch, _ = bench.train_stepper(
      dev, batch_size=geom["train_batch"], lr=bench_geometry.TRAIN_LR,
      **bench_geometry.keywords(geom))
  spec = {"type": "Adam", "args": {"lr": bench_geometry.TRAIN_LR,
                                   "weight_decay": 0}}
  loss_fn = losses.max_margin_ranking_loss(0.05, True)
  state0 = {k: v.clone() for k, v in model.state_dict().items()}

  def first_step(plain):
    opt = optim.build_optimizer(spec, model.parameters())[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    with ops.plain_versions() if plain else contextlib.nullcontext():
      loss = step.train_step(model, opt, batch, loss_fn=loss_fn,
                             lr=bench_geometry.TRAIN_LR, generator=gen)
    return float(loss), {n: p.grad.clone()
                         for n, p in model.named_parameters()}

  loss_k, grads_k = counted_run(torch, counters, lambda: first_step(False),
                                per_step, f"geometry {name}: one step")
  launches = {k: c.launches for k, c in counters.items()}
  model.load_state_dict(state0)
  loss_p, grads_p = first_step(True)
  check_step(torch, f"geometry {name}: first step kernel vs plain", loss_k,
             loss_p, grads_k, grads_p)
  return launches


def geometry_phase(torch, ops, ffn, dropout, similarity, dev, card):
  """Phase 16 (a): ``bench_geometry.run_geometry`` (the command's run) at
  each geometry, bf16, full width, counted exactly: FFN_LAYERS x chunks
  B1 and 1 B4 an eval, FFN_LAYERS B2 and B3 and 1 B4 a step, the run's
  total; its line.  Then one eval, its launches counted alone, with its
  sims on the kernel path against the plain versions (GEOMETRY_TOL), and
  one step, its launches counted alone, with its loss and gradients
  against the plain path (``check_step``); and B1, B2, B3 and B4 at the
  geometry's shapes against their plain versions (``eval_ffn_case``,
  ``train_ffn_cases``, ``sim_case``).  Returns the lines, the launches
  read in an eval's, a step's and the run's windows, and the kernels'
  cases."""
  from mmt_tpu_torch import bench, bench_geometry

  counters = phase16_counters(ffn, similarity)
  gen = torch.Generator(device=dev).manual_seed(1616)
  out = {"lines": {}, "launches": {}, "shapes": {k: [] for k in counters}}
  for name, geom in bench_geometry.GEOMETRIES.items():
    chunk, n, b = geom["eval_chunk"], geom["n_videos"], geom["train_batch"]
    per_eval = dict.fromkeys(counters, 0)
    per_eval.update(ffn_block=FFN_LAYERS * (n // chunk), moe_similarity=1)
    per_step = dict.fromkeys(counters, 0)
    per_step.update(ffn_train_fwd=FFN_LAYERS, ffn_train_bwd=FFN_LAYERS,
                    moe_similarity=1)
    evals = 1 + GEOMETRY_REPS
    # Two warm-up steps (``bench.chained_step_ms``), then the timed ones.
    steps = 2 + bench.TRAIN_STEPS * max(2, GEOMETRY_REPS // 2)
    line = counted_run(
        torch, counters, lambda: bench_geometry.run_geometry(
            name, dev, False, GEOMETRY_REPS, card),
        {k: evals * per_eval[k] + steps * per_step[k] for k in counters},
        f"geometry {name}: bench_geometry ({evals} evals, {steps} steps)")
    run_total = {k: c.launches for k, c in counters.items()}
    print(json.dumps(line), flush=True)
    out["lines"][name] = line

    model, staged, run = bench_geometry.build_eval(geom, chunk, n, dev)
    res = counted_run(torch, counters, run, per_eval,
                      f"geometry {name}: one eval")
    eval_launches = {k: c.launches for k, c in counters.items()}
    sims = res["sims"]
    if tuple(sims.shape) != (n, n) or not bool(torch.isfinite(sims).all()):
      raise RuntimeError(f"geometry {name}: sims {tuple(sims.shape)}, finite "
                         f"{bool(torch.isfinite(sims).all())}")
    finite_metrics(res)
    with ops.plain_versions():
      plain = run()["sims"]
    diff = float((plain - sims).abs().max())
    print(f"geometry {name}: eval of {n} videos, R@1 t2v "
          f"{res['t2v_metrics']['R1']:.3f}; kernel vs plain sims "
          f"max_abs_diff={diff:.3e} (limit {GEOMETRY_TOL})", flush=True)
    if diff > GEOMETRY_TOL:
      raise RuntimeError(f"geometry {name}: sims differ by {diff}")
    del model, staged, run, res, sims, plain
    torch.cuda.empty_cache()
    step_launches = geometry_step_check(torch, ops, bench, bench_geometry,
                                        geom, name, dev, counters, per_step)
    out["launches"][name] = {"per_eval": eval_launches,
                             "per_step": step_launches,
                             "run_geometry": run_total}
    torch.cuda.empty_cache()

    tokens = bench_geometry.video_tokens(geom)
    words = geom["max_text_words"]
    for r, h in ((chunk * tokens, 512), (chunk * words, 768)):
      out["shapes"]["ffn_block"].append(dict(
          eval_ffn_case(torch, ffn, dev, gen, r, h, f"{name} eval", card),
          geometry=name))
    for r, h in ((b * tokens, 512), (b * words, 768)):
      for kname, case in train_ffn_cases(torch, ffn, dropout, dev, gen, r, h,
                                         f"{name} step", card).items():
        out["shapes"][kname].append(dict(case, geometry=name))
    m = len(geom["modalities"])
    for q, what in ((n, "eval"), (b, "step")):
      out["shapes"]["moe_similarity"].append(dict(
          sim_case(torch, similarity, dev, gen, q, q, m, f"{name} {what}",
                   card), geometry=name))
    torch.cuda.empty_cache()
  return out


def sustained_phase(torch, ffn, similarity, staged_step_ms, cli_window_ms,
                    card):
  """Phase 16 (b): ``bench_sustained.run`` (the command's protocol) for
  each of SUSTAINED_RUNS, counted exactly: FFN_LAYERS B2 and B3 and 1 B4
  a step (the warm epoch, the timed one and, with --prestage, the bare
  steps), no B1; a finite loss; each line printed, and the b32 window
  beside phase 8's staged step and phase 11's window.  Returns the lines
  and the launches a step."""
  import signal

  from mmt_tpu_torch import bench_sustained

  counters = phase16_counters(ffn, similarity)
  per_step = dict.fromkeys(counters, 0)
  per_step.update(ffn_train_fwd=FFN_LAYERS, ffn_train_bwd=FFN_LAYERS,
                  moe_similarity=1)
  lines = {}
  prev_sigterm = signal.getsignal(signal.SIGTERM)
  try:
    for what, argv in SUSTAINED_RUNS:
      args = bench_sustained.parse_args(argv)
      steps = ((1 if args.prestage else 4) + args.samples // args.batch
               + (2 + bench_sustained.BARE_STEPS if args.prestage else 0))
      line = counted_run(
          torch, counters, lambda: bench_sustained.run(args),
          {k: steps * n for k, n in per_step.items()},
          f"sustained {what}: bench_sustained ({steps} steps)")
      print(json.dumps(line), flush=True)
      if not math.isfinite(line["loss"]):
        raise RuntimeError(f"sustained {what}: loss {line['loss']}")
      lines[what] = line
  finally:
    signal.signal(signal.SIGTERM, prev_sigterm)
  step_ms = lines["b32"]["step_ms_implied"]
  print(f"sustained b32 through the trainer and loader "
        f"({lines['b32']['samples']} samples): {step_ms:.3f} ms a step, "
        f"{lines['b32']['samples_per_sec']:.1f} samples/s; against phase "
        f"8's staged b32 step {staged_step_ms:.3f} ms "
        f"({step_ms / staged_step_ms:.4f}x) and phase 11's window mean "
        f"{cli_window_ms:.3f} ms ({step_ms / cli_window_ms:.4f}x); "
        f"--prestage 4 {lines['b32 --prestage 4']['step_ms_implied']:.3f} ms"
        f" a step, bare {lines['b32 --prestage 4']['bare_per_step_dispatch_ms']:.3f}"
        f" card: {card}", flush=True)
  return lines, per_step


# Phase 17 (c): bench.main with bench.py's remaining settings, its depth
# cut (200 videos in 4 chunks of 50, one timed eval; the command's
# defaults are 1,000 and 5).
BENCH_SETTINGS = {"BENCH_DTYPE": "fp32", "BENCH_TRAIN_BATCH": "128",
                  "BENCH_TRAIN_OPT": "Ranger", "BENCH_VIDEOS": "200",
                  "BENCH_REPS": "1"}
BENCH_SETTINGS_KEYS = {"metric", "value", "unit", "latency_s_1kx1k",
                       "backend", "dtype", "kernels", "kernel_families",
                       "card",
                       "train_step_ms_b128",
                       "train_samples_per_sec_per_chip"}
FP32_SIMS_TOL = 1e-4      # phase 5's fp32 rule
# B1's kernels on the fp32 route: its two GEMMs and its LayerNorm pass.
F32_ROUTE_KERNELS = ("ffn_sgemm_kernel<", "ffn_ln_rows_kernel<false, float>")


def bench_settings_phase(torch, ffn, dropout, similarity, ranking,
                         profile_eval, dev, gen, card):
  """``python -m mmt_tpu_torch.bench`` (``bench.main``) with
  BENCH_DTYPE=fp32, BENCH_TRAIN_BATCH=128 and BENCH_TRAIN_OPT=Ranger:
  the line's keys; the whole run's launches exact (16 B1 a chunk of each
  of the 2 evals, 16 B2, 16 B3 and 1 B4 a step of the 21, 1 B4 an eval);
  B1 on the fp32 route (one eval under torch.profiler, its FFN kernels
  the route's SIMT GEMMs and LayerNorm pass only, no FMA kernel);
  the fp32 eval's sims within FP32_SIMS_TOL of the plain path's and its
  ranks by phase 3's rule; B2 and B3 at b128's rows by phase 4's rules
  with their times (``train_ffn_cases``).  Returns those cases and the
  launches."""
  from mmt_tpu_torch import bench, ops

  counters = phase16_counters(ffn, similarity)
  cfg = bench.settings({**os.environ, **BENCH_SETTINGS})
  chunks = cfg["videos"] // cfg["chunk"]
  made, real = [], bench.build_full_eval

  def kept(*args, **kw):
    made.append(real(*args, **kw))
    return made[-1]

  prev = {k: os.environ.get(k) for k in BENCH_SETTINGS}
  os.environ.update(BENCH_SETTINGS)
  bench.build_full_eval = kept
  try:
    line = counted_run(
        torch, counters, lambda: bench.main([]),
        {"ffn_block": FFN_LAYERS * chunks * 2,
         "ffn_train_fwd": FFN_LAYERS * (bench.TRAIN_STEPS + 2),
         "ffn_train_bwd": FFN_LAYERS * (bench.TRAIN_STEPS + 2),
         "moe_similarity": 2 + bench.TRAIN_STEPS + 2},
        "bench fp32 / b128 / Ranger")
  finally:
    bench.build_full_eval = real
    for k, v in prev.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
  if (set(line) != BENCH_SETTINGS_KEYS or line["dtype"] != "fp32"
      or line["kernels"] is not True or line["backend"] != "cuda"):
    raise RuntimeError(f"bench fp32 / b128 / Ranger: the line {line}")
  run_eval, = made
  if not (ffn.f32_route(512, 3072, torch.float32)
          and ffn.f32_route(768, 3072, torch.float32)):
    raise RuntimeError("fp32 is off its route at the flagship's widths")
  # Late in the process the profiler drops a launch now and then, so the
  # kernels' names are read here (device_split's rule) and the launches
  # from the counters above.
  names = {short_kernel_name(k) for k in device_split(torch, run_eval, 1)
           if profile_eval.category(k).startswith("cuda ffn")}
  print(f"bench fp32 eval under the profiler: the FFN kernels "
        f"{sorted(names)}", flush=True)
  if not names or any(not n.startswith(F32_ROUTE_KERNELS) for n in names):
    raise RuntimeError(f"bench fp32 eval: B1 ran {names}")

  got = run_eval()
  with ops.plain_versions():
    want = run_eval()
  diff = float((got["sims"] - want["sims"]).abs().max())
  print(f"bench fp32 eval {tuple(got['sims'].shape)}: kernel vs plain sims "
        f"max_abs_diff={diff:.3e} (limit {FP32_SIMS_TOL:.0e})", flush=True)
  if not bool(torch.isfinite(got["sims"]).all()) or diff > FP32_SIMS_TOL:
    raise RuntimeError(f"bench fp32 eval: sims differ by {diff}")
  masks = torch.ones(got["sims"].shape[0], 1, device=dev)
  for what, rank in (("t2v", lambda a: ranking.t2v_ranks(a)),
                     ("v2t", lambda a: ranking.v2t_ranks(a, masks))):
    check_rank_rule(torch, f"bench fp32 eval {what} kernel vs plain",
                    rank(got["sims"]), rank(want["sims"]))
  print(f"bench fp32 eval wall {line['latency_s_1kx1k']:.6f} s for "
        f"{cfg['videos']} videos ({line['value']:.1f} videos/s); b128 Ranger "
        f"step "
        f"{line['train_step_ms_b128']:.3f} ms "
        f"({line['train_samples_per_sec_per_chip']:.1f} samples/s) card: "
        f"{card}", flush=True)
  cases = {}
  for r, h in ((TRAIN_BIG_BATCH * VIDEO_TOKENS, 512),
               (TRAIN_BIG_BATCH * TEXT_TOKENS, 768)):
    for name, case in train_ffn_cases(torch, ffn, dropout, dev, gen, r, h,
                                      "b128", card).items():
      cases.setdefault(name, []).append(case)
  return cases


def finite_metrics(res):
  for which in ("t2v_metrics", "v2t_metrics"):
    vals = [res[which][k] for k in ("R1", "R5", "R10", "R50", "MedR",
                                    "MeanR", "geometric_mean_R1-R5-R10")]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), vals)):
      raise RuntimeError(f"non-finite {which}: {vals}")


# ``--fp32``: B1 at the eval shapes, B2 and B3 at the b32 and b128 ones.
FP32_ALONE_SHAPES = {"ffn_block": ((10900, 512), (1500, 768)),
                     "ffn_train": TRAIN_SHAPES[:2] + TRAIN_F32_B128_SHAPES}


def fp32_main():
  """``python3 chip_smoke.py --fp32``: the fp32 path alone, to compare two
  trees of the repository on one card (run it from each tree's root).
  B1 at the eval shapes and B2 and B3 (add_dz on) at the b32 and b128
  ones, in fp32, each routed as the tree's wrappers route it: its
  CUDA-event and device ms and the tile id it passed (-1: the FMA
  kernel); then phase 18's CLI run of the shipped config (fp32) on phase
  11's corpus, without its route check.  Prints no final line."""
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke --fp32: no CUDA device; nothing was run",
          file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from mmt_tpu_torch import _build, bench
  from mmt_tpu_torch.ops import dropout, ffn, similarity

  card = bench.card_line()
  print(f"card: {card}", flush=True)
  tic = time.perf_counter()
  _build.load_library()
  print(f"build: {_build.build().name} in {time.perf_counter() - tic:.1f} s",
        flush=True)
  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)
  cd, i = torch.float32, TRAIN_I
  kw = dict(eps=1e-12, compute_dtype=cd)
  calls = []
  for r, h in FP32_ALONE_SHAPES["ffn_block"]:
    fargs, _ = train_inputs(torch, dropout, r, h, cd, dev, gen)
    args = fargs[:1] + fargs[2:]
    calls.append((f"ffn_block R={r} H={h}",
                  lambda a=args: ffn.ffn_block_cuda(*a, **kw)))
  for r, h in FP32_ALONE_SHAPES["ffn_train"]:
    fargs, dy = train_inputs(torch, dropout, r, h, cd, dev, gen)
    _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
    bargs = (dy, z, inter, fargs[1], fargs[2], fargs[4], fargs[6])
    calls.append((f"ffn_train_fwd R={r} H={h}",
                  lambda a=fargs: ffn.ffn_train_fwd_cuda(*a, **kw)))
    calls.append((f"ffn_train_bwd R={r} H={h}",
                  lambda a=bargs: ffn.ffn_train_bwd_cuda(*a, **kw)))
  for what, fn in calls:
    with recorded_tiles(ffn) as tiles:
      fn()
    r, h = (int(v[2:]) for v in what.split()[1:3])
    ms, dev_ms = time_ms(torch, fn, 10), device_ms(torch, fn, 5)
    print(f"{what} I={i} fp32 (tile {tiles[0][1]}): kernel_ms={ms:.4f} "
          f"device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} TFLOP/s) "
          f"card: {card}", flush=True)
  with cli_corpus() as (root, data_dir, _, meter):
    fp32_cli_phase(torch, ffn, similarity, root, data_dir, meter, card,
                   require_route=False)
  return 0


def main():
  import torch

  if sys.argv[1:] == ["--fp32"]:
    return fp32_main()

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from mmt_tpu_torch import (_build, bench, evaluate, flagship, ops, parallel,
                             profile_eval)
  from mmt_tpu_torch.ops import dropout, ffn, ranking, similarity
  from mmt_tpu_torch.train import metrics
  from mmt_tpu_torch.train import trainer as trainer_lib

  clock = PhaseClock()

  card = bench.card_line()
  print(f"card: {card}", flush=True)
  print(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}", flush=True)

  tic = time.perf_counter()
  lib_path = _build.build()
  _build.load_library()
  print(f"build: {lib_path.name} in {time.perf_counter() - tic:.1f} s",
        flush=True)
  for line in (lib_path.parent / "build.log").read_text().splitlines():
    if "Compiling entry function" in line:
      print(f"  ptxas: {line.split(chr(39))[1]}")
    elif "registers" in line or "spill" in line:
      print(f"  ptxas:   {line.strip()}")
  for source in ("assembler.cc", "wordpiece.cc"):
    tic = time.perf_counter()
    host_lib = _build.build_host(source)
    print(f"build: {host_lib.name} (host, {os.environ.get('CXX') or 'g++'}) "
          f"in {time.perf_counter() - tic:.1f} s", flush=True)
  clock.done("build")

  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)
  ffn_entry, alone = ffn_phase(torch, ops, ffn, dev, gen, card)
  entries = {"ffn_block": ffn_entry,
             "moe_similarity": sim_phase(torch, similarity, dev, gen, card)}
  clock.done("kernel")
  rank_err = rank_kernel_phase(torch, ranking, similarity, dev, gen, card)
  clock.done("rank-kernel")
  train_entries, train_alone = train_kernel_phase(torch, ffn, dropout, dev,
                                                  gen, card)
  entries.update(train_entries)
  clock.done("train-kernel")
  entries.update(partial_kernel_phase(torch, ffn, dropout, dev, gen, card))
  clock.done("partial-kernel")
  reference_phase(torch, flagship, evaluate, dev)
  clock.done("reference")

  # ---- slice phase: the full-width flagship, 1k x 1k ----
  tic = time.perf_counter()
  model, batches = bench.staged_flagship(dev)
  torch.cuda.synchronize()
  print(f"slice: flagship CENet bf16, {N_VIDEOS} videos in "
        f"{len(batches)} chunks of {CHUNK} (model and inputs made in "
        f"{time.perf_counter() - tic:.1f} s)", flush=True)

  ffn.ffn_block_cuda.launches = 0
  similarity.sim_cuda.launches = 0
  res = evaluate.retrieval_eval(model, batches)
  torch.cuda.synchronize()
  launches = {"ffn_block": ffn.ffn_block_cuda.launches,
              "moe_similarity": similarity.sim_cuda.launches}
  print(f"slice launches: {launches}", flush=True)
  want_ffn = FFN_LAYERS * (N_VIDEOS // CHUNK)
  if launches["ffn_block"] != want_ffn or launches["moe_similarity"] < 1:
    raise RuntimeError(f"expected {want_ffn} ffn_block and >= 1 "
                       f"moe_similarity launches, got {launches}")
  sims = res["sims"]
  if tuple(sims.shape) != (N_VIDEOS, N_VIDEOS):
    raise RuntimeError(f"sims shape {tuple(sims.shape)}")
  if not bool(torch.isfinite(sims).all()):
    raise RuntimeError("non-finite sims")
  finite_metrics(res)
  for which in ("t2v_metrics", "v2t_metrics"):
    shown = {k: v for k, v in res[which].items() if k != "cols"}
    print(f"slice {which}: {json.dumps(shown)}", flush=True)

  with ops.plain_versions():
    res_plain = evaluate.retrieval_eval(model, batches)
  torch.cuda.synchronize()
  diff = float((res_plain["sims"] - sims).abs().max())
  print(f"slice: kernel vs plain sims max_abs_diff={diff:.3e}", flush=True)
  if diff > 2e-2:
    raise RuntimeError(f"kernel vs plain sims differ by {diff} > 2e-2")
  if ffn.ffn_block_cuda.launches != want_ffn:
    raise RuntimeError("the plain run launched the FFN kernel")

  def wall(plain):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    if plain:
      with ops.plain_versions():
        evaluate.retrieval_eval(model, batches)
    else:
      evaluate.retrieval_eval(model, batches)
    torch.cuda.synchronize()
    return time.perf_counter() - tic

  wall(False)
  wall(True)
  runs = {False: [], True: []}
  for _ in range(5):
    for plain in (False, True):
      runs[plain].append(wall(plain))
  k_s, p_s = statistics.median(runs[False]), statistics.median(runs[True])
  print(f"eval 1k x 1k wall (median of 5): kernel_path_s={k_s:.6f} "
        f"plain_path_s={p_s:.6f} ratio={k_s / p_s:.4f} "
        f"videos_per_s={N_VIDEOS / k_s:.1f} card: {card}", flush=True)
  print(f"eval runs kernel_path_s={[round(x, 6) for x in runs[False]]} "
        f"plain_path_s={[round(x, 6) for x in runs[True]]}", flush=True)
  del res, res_plain
  clock.done("slice")
  profile_phase(profile_eval, alone, card)
  clock.done("profile")

  # ---- at-scale phase: the fused eval at 10k videos, no matrix ----
  entries["fused_ranks"] = at_scale_phase(
      torch, (bench, evaluate, metrics, ops, ffn, similarity, ranking),
      model, batches, dev, card)
  entries["fused_ranks"]["max_abs_err"] = max(
      rank_err, entries["fused_ranks"]["max_abs_err"])
  del model, batches
  torch.cuda.empty_cache()
  clock.done("at-scale")

  train_launches, staged_step_ms, *step_ref, step = train_step_phase(
      torch, flagship, ops, ffn, similarity, dev, card)
  clock.done("train-step")
  train_profile_phase(torch, ffn, dropout, profile_eval, step, train_alone,
                      dev, gen, card)
  del step
  torch.cuda.empty_cache()
  clock.done("train-profile")
  for cd in (torch.float32, torch.bfloat16):
    step_graph_phase(torch, flagship, ffn, similarity, dev, card, cd)
  clock.done("step-graph")
  moe_phase(torch, ops, dev, gen, card)
  torch.cuda.empty_cache()
  clock.done("moe")
  tp_launches = tp_phase(torch, parallel, ranking, sims, step_ref, dev, card)
  del sims
  clock.done("tp")
  dp_errs = dp_kernel_cases(torch, ffn, dropout, dev, gen, card)
  dp_launches, dp_errs["fused_ranks"] = dp_phase(
      torch, parallel, ranking, similarity, step_ref, dev, card)
  del step_ref
  clock.done("dp")

  loader_bench_phase(card)
  clock.done("loader-bench")

  def serve_cli(cfg_path, exp):
    clock.done("train-cli")
    served_cli = serve_cli_phase(torch, ffn, similarity, cfg_path, exp)
    clock.done("serve-cli")
    matrix = matrix_phase(torch, ops, ffn, similarity, cfg_path, card)
    clock.done("matrix")
    torch.cuda.empty_cache()
    data_dir = json.loads(cfg_path.read_text())[
        "train_sets"][0]["args"]["mix"][0]["data_dir"]
    dp_cli, ref = dp_cli_phase(torch, cfg_path.parent, data_dir, card)
    clock.done("dp-cli")
    tp_cli = tp_cli_phase(torch, cfg_path.parent, data_dir, ref, card)
    clock.done("tp-cli")
    fp32_cli = fp32_cli_phase(torch, ffn, similarity, cfg_path.parent,
                              data_dir, trainer_lib.AverageMeter, card)
    clock.done("fp32-cli")
    user_cli = user_expert_cli_phase(
        torch, ops, ffn, dropout, similarity, ranking, cfg_path.parent,
        data_dir, trainer_lib.AverageMeter, dev, card)
    return served_cli, matrix, dp_cli, tp_cli, fp32_cli, user_cli

  cli_launches, cli_loop, (serve_launches, matrix_launches,
                           dp_launches["c"], tp_cli_launches,
                           (fp32_cli_launches, *_), user_cli) = (
      train_cli_phase(torch, ops, ffn, similarity, staged_step_ms, k_s, card,
                      then=serve_cli))
  print(f"train-cli launches (2 epochs): {json.dumps(cli_launches)}",
        flush=True)
  clock.done("user-expert-cli")
  served = serve_scale_phase(torch, ops, ffn, similarity, flagship, dev,
                             card, clock)
  clock.done("serve-sharded")
  ffn_shapes, sim_shapes = serve_kernel_cases(torch, ffn, similarity, dev,
                                              card)
  clock.done("serve-kernels")
  print(f"serve summary: {json.dumps(served)}", flush=True)
  geometry = geometry_phase(torch, ops, ffn, dropout, similarity, dev, card)
  clock.done("geometry")
  _, sustained_per_step = sustained_phase(
      torch, ffn, similarity, staged_step_ms, cli_loop["window_ms"], card)
  clock.done("sustained")
  b128_cases = bench_settings_phase(torch, ffn, dropout, similarity, ranking,
                                    profile_eval, dev, gen, card)
  clock.done("bench-settings")
  entries["ffn_block"]["launches"] = launches["ffn_block"]
  entries["moe_similarity"]["launches"] = launches["moe_similarity"]
  for name in ("ffn_train_fwd", "ffn_train_bwd"):
    entries[name]["launches"] = train_launches[name]
  for name, n in tp_launches.items():
    entries[name]["launches"] = n
  # Phase 14: launches per rank of (a) the DP step, (b) the sharded ranks,
  # (c) the 2-process CLI run; B2 and B3 also checked at a rank's rows.
  for name in ("ffn_block", "ffn_train_fwd", "ffn_train_bwd",
               "moe_similarity", "fused_ranks"):
    entries[name]["dp_launches"] = {
        part: counts[name] for part, counts in dp_launches.items()}
  for name, err in dp_errs.items():
    entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
  # Phase 13: each config-matrix run's launches.
  for name in ("ffn_block", "ffn_train_fwd", "ffn_train_bwd",
               "moe_similarity"):
    entries[name]["matrix_launches"] = {
        run: want[name] for run, want in matrix_launches.items()}
  # Phase 15: the launches per rank of (b) the TP CLI run, and of (a) a
  # query batch of the sharded index (exact and int8).
  for name, n in tp_cli_launches.items():
    entries[name]["tp_cli_launches"] = n
  for name in ("ffn_block", "moe_similarity"):
    entries[name]["sharded_serving_launches"] = {
        label: run["launches"][name]
        for label, run in served["sharded"].items()}
  # Phase 12: the serving path's own launches and shapes.
  for name, shapes in (("ffn_block", ffn_shapes),
                       ("moe_similarity", sim_shapes)):
    entries[name]["serving_launches"] = {
        what: want[name] for what, want in serve_launches.items()}
    entries[name]["serving_shapes"] = shapes
    entries[name]["max_abs_err"] = max(
        [entries[name]["max_abs_err"]] + [c["max_abs_err"] for c in shapes])
  # Phase 16: the launches an eval and a step of each geometry, a step of
  # the sustained runs, and the kernels at the geometries' shapes.
  for name, cases in geometry["shapes"].items():
    entries[name]["geometry_launches"] = {
        g: {k: n[name] for k, n in per.items()}
        for g, per in geometry["launches"].items()}
    entries[name]["geometry_shapes"] = cases
    entries[name]["max_abs_err"] = max(
        [entries[name]["max_abs_err"]] + [c["max_abs_err"] for c in cases])
    entries[name]["sustained_launches_per_step"] = sustained_per_step[name]
  # Phase 18: the shipped config in fp32 through the CLI (its launches).
  for name, n in fp32_cli_launches.items():
    entries[name]["fp32_cli_launches"] = n
  # Phase 19: the user expert's CLI run (its launches and the kernels at
  # its shapes) and the switches' runs.
  for name, n in user_cli["launches"].items():
    entries[name]["user_expert_cli_launches"] = n
  for name, cases in user_cli["shapes"].items():
    entries[name]["user_expert_shapes"] = cases
    entries[name]["max_abs_err"] = max(
        [entries[name]["max_abs_err"]] + [c["max_abs_err"] for c in cases])
  for name in entries:
    runs = {what: counts[name] for what, counts in
            user_cli["switch_launches"].items() if name in counts}
    if runs:
      entries[name]["switch_launches"] = runs
  # Phase 17 (c): B2 and B3 at b128's rows; B1's fp32 cases of phase 2.
  for name, cases in b128_cases.items():
    entries[name]["b128_shapes"] = cases
    entries[name]["max_abs_err"] = max(
        [entries[name]["max_abs_err"]] + [c["max_abs_err"] for c in cases])
  shown = {k: round(v, 1) for k, v in clock.seconds.items()}
  print(f"phases (s): {json.dumps(shown)}; total {clock.total():.1f} s",
        flush=True)

  print(f"card: {card}")
  print(json.dumps({"kernels": [
      {"name": name, "route": "cuda", "source": f"mmt_tpu_torch/csrc/{src}",
       "replaces": replaces, **entries[name]}
      for name, src, replaces in (
          ("ffn_block", "ffn_block.cu", "mmt_tpu/ops/ffn.py:119"),
          ("moe_similarity", "moe_similarity.cu",
           "mmt_tpu/ops/similarity.py:244"),
          ("ffn_train_fwd", "ffn_block.cu", "mmt_tpu/ops/ffn.py:477"),
          ("ffn_train_bwd", "ffn_train_bwd.cu", "mmt_tpu/ops/ffn.py:499"),
          ("fused_ranks", "fused_ranks.cu", "mmt_tpu/ops/ranking.py:101"),
          ("ffn_partial", "ffn_block.cu", "mmt_tpu/ops/ffn.py:369"),
          ("ffn_train_fwd_partial", "ffn_block.cu",
           "mmt_tpu/ops/ffn.py:576"))]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
