#!/usr/bin/env python3
"""On-GPU smoke of the PyTorch/CUDA port (``dwt_tpu_torch``): build, check, train, serve.

Run from the root of a checkout, on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero without the final line:

1. ``env``      — torch/CUDA versions, the card's name and power limit
                  (``nvidia-smi``), both TF32 flags, PIL's version, the
                  host's CPU count and ``g++ --version``.
2. ``build``    — ``nvcc`` builds every ``dwt_tpu_torch/csrc/*.cu`` (in
                  parallel) into ``build/kernels/``, then ``g++`` the data
                  path's native pixel passes (``dwt_tpu_torch/native/``)
                  into ``build/native/``.  ``build_general_kernels``: each
                  general (any group size) kernel's registers, static
                  shared memory and spills from ``-Xptxas -v``; more than
                  ``GROUP_MOST_REGISTERS`` registers or any spill fails.
3. ``parity``   — the whitening-apply kernel against its plain PyTorch
                  version, both on the card, at the three site shapes of a
                  bucket-128 ResNet50 forward at 224² (``x [M, C]``) and at
                  a ragged M = 1000; in its domain-batched form (``x [D, M,
                  C]``, one launch for the D domains) at the three site
                  shapes of a ResNet50 train step (D = 3, 18 images per
                  stream), at D = 1 and at ragged M = 1, 7 and 1000;
                  ``rtol = atol = 1e-5``.  At the train shapes also: in a
                  profiler trace of ten calls the kernel and no other
                  device operation, at most once per call; a second call
                  bitwise equal to the first, and two replays of a CUDA
                  graph that captured a call bitwise equal to it.
4. ``timing``   — per shape: kernel (``device_ms``: its device time in a
                  ``torch.profiler`` trace; ``kernel_ms``: CUDA events
                  around back-to-back wrapper calls, host time included;
                  ``host_us``: the wrapper's host time per call), plain
                  version and one-call library yardstick (``torch.addmm``
                  with the block-diagonal matrix; ``torch.baddbmm`` for D
                  domains) in milliseconds, beside the bound (bytes moved
                  over the card's memory rate), a D2D copy of the same
                  bytes (``copy_ms``, ``copy_device_ms``) and the device
                  time of an empty launch (``launch_floor_ms``, the card's
                  per-launch floor).  Every timing here and in phase 6
                  cycles through distinct input (and output) buffers of
                  ``COLD_BYTES`` (100 MB) or more in all, so that L2 is
                  cold for each call, as in a train step or a forward.
5. ``moments_parity`` — the moments kernel against its plain version on
                  the card and against a float64 two-pass reference of
                  each domain, at the three batched site shapes of a
                  ResNet50 train step (``[3, M, C]``, 18 images per
                  stream, 224²), at D = 1 and D = 2, at a ragged M = 1000
                  and on an input with a channel-mean offset of 4; mean
                  ``rtol = atol = 1e-6``, cov ``rtol = 1e-4, atol = 1e-5``.
                  One launch per call, and one kernel and no other device
                  operation in a profiler trace of a call; a second call
                  is bitwise equal to the first, and at the three train
                  shapes so are two replays of a CUDA graph that captured
                  a call.  At each shape also the apply kernel against its
                  plain version on all domains in one launch, whitening
                  each with its own moments (``rtol = atol = 1e-5`` per
                  element).
6. ``moments_timing`` — per train site: the moments kernel (one launch for
                  the site's 3 domains; also its wrapper's host µs per
                  call), its plain version and the library
                  yardstick ``torch.cov`` once per domain (the full C×C
                  covariance, whose diagonal 4×4 blocks are the kernel's
                  ``cov``), and the apply kernel on the site's 3 domains
                  (one launch), beside their bounds.
7. ``train``    — the port's trainer through its CLI entry
                  (``build_parser``/``run_officehome``): ResNet50-DWT,
                  65 classes, 224², 3 streams × 18 images, 6 steps, an
                  eval every 3, one stat-collection pass and the final
                  eval, on synthetic data from seed 1.  ``--log_interval
                  1`` so that every step's losses are read.  Checks:
                  finite losses and grad norms, every parameter and
                  every whitening site's running cov moved, 11 moments
                  launches and 11 apply launches (one each per site, for
                  its 3 domains) per train step and per collection
                  forward, 11 apply launches per eval forward, an
                  accuracy.
8. ``train_reference`` — one ResNet50 train step through the kernels
                  against the same step with both kernels swapped for
                  their plain versions and against a float64 step of the
                  plain versions, all on the card, from the same weights
                  and batch; then one tiny-model step on the card against
                  the same step on the CPU.  Metrics and stats as a whole,
                  and each parameter's gradient and update on its own
                  (tolerances and their readings at ``TRAIN_TOL``).
9. ``train_throughput`` — steady-state train step time (CUDA events,
                  after 2 warm-up steps), images per second, the time of
                  a stat-collection forward and of an eval forward at the
                  test batch, and peak device memory.
10. ``data_plane`` — on two OfficeHome-shaped image folders written from
                  seed 1 (``Art/`` and ``Clipart/`` under ``build/``, 65
                  classes × 3 JPEGs, sides 300–800 px, quality 90): the
                  source and target streams' batch ids equal the seekable
                  sampler's order across the epoch boundary, a stream
                  opened at cursor 4 yields bitwise the suffix of one
                  opened at 0, 1 and 4 loader threads give bitwise the same
                  batches, and a batch prefetched to the card equals its
                  numpy source bitwise; then images per second of the
                  target stream (both views) and of the source stream at
                  1, 2, 4 and 8 threads, and the host-to-device time of a
                  batch (CUDA events from pinned memory, and wall clock
                  through ``prefetch_to_device``).
11. ``folder_train`` — phase 7 on the folders: ``run_officehome`` through
                  the CLI flags ``--s_dset_path …/Art --t_dset_path
                  …/Clipart --num_workers 4 --num_iters 12
                  --check_acc_step 6 --stat_collection_passes 1
                  --log_interval 1`` (ResNet50, 65 classes, 224², 3 × 18;
                  12 steps cross the 10-batch epoch), with phase 7's
                  checks; phases 7 and 11 also report the median step
                  (batch to batch) and the loop's mean wait for a batch.
                  ``folder_profile``: the card's idle share over a
                  profiled window of folder steps; ``folder_vs_synthetic``
                  sets the two paths' steps side by side.
12. ``serve``   — the port's server on 127.0.0.1 (``build_engine`` from
                  the CLI flags ``--model resnet50 --num_classes 65
                  --image_size 224 --buckets 1,8,32,128 --init_random
                  --seed 0``) answers requests of 1, 5, 32 and 128 images;
                  every response is checked (shape, finite, equal to
                  ``engine.infer``), the kernel must have launched 11
                  times per forward, a bucket-8 forward through the kernel
                  is held to the same forward through the plain apply and
                  a bucket-1 forward to the model on the CPU; then forward
                  time per bucket and peak device memory.
13. ``digits_parity`` / ``digits_timing`` — both kernels at LeNet-DWT's
                  whitened sites (``dn1`` C = 32, ``dn2`` C = 48): the
                  moments kernel against its plain version and a float64
                  two-pass reference at the train shapes ``[2, M, C]`` (32
                  images per stream), the apply kernel against its plain
                  version there (one launch for both domains; also at D =
                  1 and at ragged M = 1, 7 and 1000, and at the train
                  shapes one kernel per call, bitwise repeats and graph
                  replays) and at the eval (test batch 100) and serve
                  (buckets 1 and 128) shapes, tolerances as above; times
                  with L2 cold beside the bound, the plain version, the
                  library yardsticks, the D2D copy and the launch floor.
14. ``digits_train`` — the digits trainer through its CLI entry
                  (``build_parser``/``run_digits``): LeNet-DWT, 32 images per
                  stream, 2 epochs of 8 steps on synthetic data, an eval
                  after each.  Checks: finite losses and grad norms, every
                  parameter and both sites' running covs moved, 2 moments
                  and 2 apply launches per step, 2 apply launches per eval
                  forward, the record sequence, an accuracy.
15. ``digits_reference`` — one LeNet-DWT step through the kernels against
                  the plain-kernel step and a float64 step on the card
                  (limits and readings at ``DIGITS_LEAF_TOL``).
16. ``digits_throughput`` — steady-state digits step and eval forward
                  (batch 100), images per second, peak memory, and the
                  card's idle share from a profiled window of steps.
17. ``digits_serve`` — phase 12 for ``--model lenet`` (2 apply launches
                  per forward).
18. ``ckpt_resume`` — phase 7's run with ``--ckpt_dir`` and
                  ``--ckpt_every_iters 3`` (under ``build/``), saving on
                  the background writer: runs A and A2 uninterrupted, run
                  B cut by its logger after step 4 and rerun, resuming
                  from step 3, and run S with ``--no-async_ckpt``.
                  Checks: each record's launches (none for the checkpoint
                  records), B's resume at step 3 with the data plane at
                  the manifest's exact position, the batch ids of every
                  run equal A's, A2's, S's and B's (from step 4 on)
                  records and final states bitwise equal to A's (all
                  under cuDNN's deterministic algorithms), S's manifests'
                  parameter digests equal to A's, saves at 3 and 6, a
                  checkpoint of the tensors' bytes (≈ 2 × the parameters,
                  the momentum, plus the stats).  Prints each save's loop
                  stall and writer time (async and sync) and the
                  restore's ms; then 20 steps with a background save every
                  10 and no eval, each step's time after the first 2
                  split by whether a write was in flight (``overlap``).
19. ``ckpt_serve`` — the server with ``--ckpt_dir`` on run A
                  (``--model resnet50``, bucket 8) answers 8 test images
                  sent as ``.npy``: ``/healthz`` at A's final step, 11
                  apply launches for the forward, logits within
                  ``FORWARD_TOL`` of the trainer's eval forward of the
                  restored model; the restore-and-warm seconds.
20. ``digits_ckpt`` — phase 14's run with ``--ckpt_dir`` and
                  ``--ckpt_every_epochs 1``: runs U and U2 of 2 epochs, run
                  C of 1 epoch resumed to 2, held as phase 18's; then
                  ``--model lenet`` serving run
                  C (``digits_ckpt_serve``, 2 apply launches).
21. ``convert`` — a reference-scheme ResNet50 archive from seed 1 (all
                  309 keys, the ImageNet ``fc``), ``python -m
                  dwt_tpu_torch.cli.convert`` on it (307 loaded, the head's
                  2 skipped), then one train step from ``--init_ckpt`` on
                  the card: the converted weights at step 0, finite
                  losses, the launches.
22. ``guard``    — phase 18's run (saves every 3) with ``--guard_policy
                  rollback --guard_interval 2`` and a NaN injected after
                  step 4 (``inject.arm``): a ``rollback`` from 4 to the
                  step-3 checkpoint, the last 3 steps on reseeded batches,
                  a finite end; with ``--guard_lr_backoff 0.5`` a
                  ``lr_backoff`` at 4 (an in-memory recovery, the batches
                  unchanged) and ``lr_scale`` 0.5 saved.  The guard's host
                  readbacks per step (``aten::_local_scalar_dense`` in a
                  profiled 6-step run without evals, with and without the
                  guard: 3 in 6 steps) and the state snapshot's ms and
                  device bytes (the guard's and the checkpoint writer's).
23. ``delta``   — phase 18's run with ``--ckpt_format delta``, held
                  bitwise to run A; each save's bytes as written, the
                  manifests' modes (``3`` full, ``6`` delta), the restore
                  through the chain (ms); ``delta_serve``: the delta and
                  the full checkpoint served at bucket 8, the logits
                  bitwise equal, 11 apply launches.
24. ``preempt`` — phase 18's run with a SIGTERM at step 4's boundary
                  (``inject.arm``): the run returns after a final save at
                  4; the rerun resumes there (exact) and ends bitwise
                  equal to A; the time from the SIGTERM to the return.
25. ``chaos_digits`` — the digits trainer through its CLI flags in four
                  subprocesses started together, each with one
                  ``DWT_FAULT_PLAN``: a hang (exit 113, a stack dump under
                  ``ckpt_dir/watchdog/``), a crash in the step-16 save
                  (exit 1, step 8 authoritative), 2 failed save writes
                  (absorbed) and 99 (diagnosed); each child prints its
                  records with both kernels' launch counts.
26. ``dispatch`` — k steps per dispatch, each step a replay of one
                  captured CUDA graph, records through the harvest ring
                  (depth 2): ``dispatch_harness`` (after phase 9 and 16)
                  runs a chunk of ResNet50-DWT (k = 3) and LeNet-DWT (k =
                  4) steps outside the loop and holds the first whitened
                  site's kernels, as the last replay left their inputs and
                  outputs, to their plain versions (tolerances as phases
                  3 and 5); the graph's and the eager step's ms and device
                  busy ms and operations per step, the capture's ms and
                  pool bytes, the kernels' device ms in the replays.
                  ``dispatch_folder`` (in phase 11's folders): 16 steps at
                  k = 1 with harvest depth 0, k = 1 at depth 2 and k = 4
                  at depth 2; step ms over steps 4–12 (CUDA events at
                  each batch or chunk) and the idle share from a trace of
                  the run's last 4 steps (the union of the device's busy
                  intervals).  ``dispatch_digits``: the digits CLI at k =
                  4, harvest depth 2 and 8 eval batches per dispatch
                  against every step eager (depth 0, 1 per dispatch) and
                  every step eager at depth 2, records and batch ids
                  equal, step ms, the idle share (a traced twin of each
                  run), host syncs per step; every boundary at k = 4 (delta saves,
                  background and blocking, the watchdog armed, a SIGTERM
                  mid-chunk, the resume: train records and final
                  parameters equal to the uninterrupted run); then the
                  guard under harvest (a NaN at
                  step 4, rollback, k = 2), on the card and on the CPU
                  with both rings held until they overflow (equal guard
                  events, record steps and batch ids) and on the card as
                  it runs (the detection lag).  ``dispatch_resnet50``: run
                  R (phase 18's flags at k = 3) bitwise equal to run A;
                  step ms at k = 1 (depth 0 and 2) and k = 3 in turns;
                  the eval pass at 1 and
                  8 batches per dispatch (equal counters) and the
                  collection pass.  Phases 7–25 read their records
                  synchronously (``--harvest_depth 0``) and run their
                  evals through the graph (8 batches per dispatch).
27. ``bf16_kernels`` / ``bf16_timing`` — both kernels' bf16 variants
                  (``x`` bf16; ``mean``, ``w`` and the moments f32) at
                  every site shape of the bf16 paths (ResNet50 train
                  ``[3, M, C]``, bucket-128 serve ``[M, C]``, LeNet-DWT
                  train ``[2, M, C]``) and at ragged shapes: one launch
                  each, the moments within the f32 moments tolerances of
                  the plain version and of a float64 two-pass reference,
                  the apply at most one bf16 rounding step (``BF16_STEP``)
                  from its plain version per element (and whether
                  bitwise); at the train shapes one kernel per call,
                  bitwise repeats and graph replays.  Times with L2 cold
                  beside the bound (bf16 bytes), the plain version, the
                  library call (``torch.addmm``/``baddbmm`` in bf16;
                  ``torch.cov`` of the upcast tensor) and the host µs.
28. ``bf16_train`` — the flagship CLI at ``--compute_dtype bf16``, 6
                  steps at 3 steps per dispatch (graph replays, harvested
                  records) with evals and a collection pass: 11 moments
                  and 11 apply launches per step, parameters f32; the bf16
                  and the f32 step ms at k = 3 in turns
                  (``bf16_train_timing``); the digits CLI at bf16
                  (``bf16_digits_train``, 2 and 2 per step).
29. ``whiteners`` — the digits CLI with ``--whitener newton_schulz`` and
                  ``swbn``, and the flagship CLI with ``--whitener swbn
                  --stat_collection_passes 0`` (its skipped
                  ``stat_collection`` record), each with its launch checks.
30. ``bf16_serve`` — phase 12 at ``--serve_dtype bf16``: the bucket-1/8/
                  32/128 forwards' logits against an f32 twin's (the same
                  weights) within ``BF16_SERVE_TOL`` of their scale, the
                  bucket-8 forward through the kernel against the plain
                  version, forward ms of both per bucket.
31. ``remat``   — one ResNet50 step with ``--remat`` against one without
                  (same weights and batch, cuDNN's deterministic
                  algorithms): running stats bitwise equal, losses at
                  ``TRAIN_TOL``, 21 moments and 21 apply launches (11 and
                  10 recomputed) against 11; step ms and peak device
                  memory of 9-step runs with and without, in turns.
32. ``group_kernels`` / ``group_timing`` — both kernels in f32 and bf16
                  at every group size ``g`` of a grid: C = 32, 48 and 64 at
                  every divisor of C, C = 256 at 1, 2, 4, …, 256, each at
                  D = 1 and 3 with 1001 rows: one launch each, ``cov
                  [D, C/g, g, g]``, the moments against the plain version
                  and a float64 two-pass, the apply against the plain
                  version (the f32 one also against float64; the bf16 one
                  bitwise), within the tolerances of phases 3 and 5 (from
                  g = 32 on, failing those, within twice the plain
                  version's own distance from float64, printed beside
                  it), a second call bitwise equal and two graph replays
                  of each bitwise equal.  Then at the flagship's 11 train
                  sites (3 domains) at g = 8, 16 and 64 in both dtypes:
                  the same checks of one call of each kernel against its
                  plain version and float64 (``group_site_parity``), and
                  times, L2 cold, beside the bound (bytes, or FLOPs over
                  the peak of the input's type: f32 outside the tensor
                  cores, bf16 on them), the plain version, the library
                  call (``torch.baddbmm`` with the block-diagonal matrix,
                  ``torch.cov``) and the host µs; each row also the
                  kernel's launch geometry (``plan``).
                  ``group_site_f64``: the site checks' largest distances
                  from float64 per dtype, beside the earlier general
                  bodies' (``GROUP_SITE_F64_BEFORE``).
33. ``group_train`` — the flagship CLI at ``--group_size`` 8, 16 and 64,
                  f32 and bf16, k = 3, with evals and a collection pass:
                  11 moments and 11 apply launches per step, phase 7's
                  checks, the f32 runs at 16 and 64 saving checkpoints;
                  ``group_train_timing``: step ms and peak device memory
                  at g = 4, 16 and 64 in mirrored turns (f32 and bf16).
34. ``group_serve`` — the server on those checkpoints at ``--group_size``
                  16 and 64, f32 and bf16, one request per bucket
                  1/8/32/128: 11 apply launches a forward, logits held to
                  the trainer's eval forward of the restored model.
35. ``group_digits`` — the digits CLI at ``--group_size 16`` (dn1 G = 2,
                  dn2 G = 3) and ``48`` (dn1 clamped to g = 32, dn2 g = 48),
                  phase 14's checks.
36. ``vit_kernels`` / ``vit_timing`` — both kernels at ViT-S/16's
                  whitened token sites (C = 384), f32 and bf16, at g = 4, 16
                  and 64: the train site ``[3, 3528, 384]`` (18 images × 196
                  tokens a domain; phase 32's checks: the plain versions,
                  float64, the bf16 apply bitwise, repeats and graph replays
                  bitwise), and with its target branch's moments and matrix
                  the apply at the eval (test batch 10) and serve (buckets
                  1/8/32/128) sites ``[N·196, 384]``, the same checks.
                  Times with L2 cold beside the bound, the plain version,
                  ``torch.baddbmm``/``torch.cov`` and the host µs: the train
                  site's kernels at every g, the apply at the eval and
                  bucket-1/128 sites at g = 4.
37. ``vit_train`` — ViT-S/16 through the OfficeHome CLI entry with
                  ``--backbone vit_dwt`` (65 classes, 224², 3 × 18, 6 steps,
                  an eval every 3, one collection pass, the final eval), f32
                  and bf16: phase 7's checks with 4 moments and 4 apply
                  launches a step; ``vit_reference``: phase 8's kernel step
                  against the plain and the float64 step (the biases whose
                  exact gradient is zero, ``VIT_ZERO_GRAD_BIASES``, held to be
                  noise); ``vit_train_timing``: step ms and peak memory at k =
                  1 and 3, f32 and bf16.
38. ``vit_serve`` — phase 12 for a ``ServeEngine`` over ViT-S/16 (the
                  server's ``--model`` offers none; the engine's Python API
                  behind the same HTTP front end), f32 and bf16 (against its
                  f32 twin): 4 apply launches a forward.
39. ``visda_train`` / ``visda_serve`` — ``python -m
                  dwt_tpu_torch.cli.visda``'s entry with ``--synthetic``
                  (ResNet101, 12 classes, 224², 3 × 18, 6 steps, one
                  collection pass), phase 7's checks with 11 + 11 launches,
                  a checkpoint at step 6, step ms and peak memory at k = 1
                  and 3 (``visda_train_timing``); the server CLI with
                  ``--model resnet101 --num_classes 12 --ckpt_dir`` on it
                  (phase 19's checks, the bucket-8 forward's ms), and the
                  apply at that forward's 11 site shapes against its plain
                  version, timed as in phase 1.
40. ``resnet152_train`` — 3 steps of ``--backbone resnet152`` through the
                  CLI entry, phase 7's checks (11 + 11), step ms (steps
                  2-3) and peak memory.
41. ``int8_serve`` — the server CLI with ``--quantize_int8`` on run A's
                  checkpoint (phase 18) answers 32 test images as ``.npy``:
                  every resident parameter int8 (bytes by dtype beside the
                  f32 engine's), f32 scales, 11 apply launches for the
                  forward, finite logits whose argmax agrees with the f32
                  server's for at least ``INT8_BAND`` of the images, the
                  bucket-32 forward through the kernel against the plain
                  apply; int8 and f32 forward ms per bucket; the apply at
                  that forward's 11 site shapes against its plain version,
                  timed as in phase 1.
42. ``hot_swap`` — the server with ``--watch`` on a directory holding run
                  A's step-3 checkpoint, under a steady load of 1- and
                  5-image requests while the trainer (phase 18's flags on
                  that directory) resumes and writes step 6: the swap
                  lands, no request fails, every reply names step 3's or
                  6's generation and every batch's access records one
                  version; 11 apply launches per forward of the swapped
                  generation (``serve_swap``).  Then a digest-valid
                  candidate with NaN weights is refused by the canary, and
                  a good one goes live, is made to serve errors and is
                  rolled back.  The apply at the bucket-8 forward's 11
                  site shapes against its plain version, timed as in
                  phase 1.
43. ``adapt_serve`` — the server with ``--adapt_every`` on run A's
                  checkpoint and a seeded ``--canary_fixture``, fed 4
                  requests of 32 images shifted by ``serve_drift_shift``,
                  the adapter's iterations driven one per request: a thin
                  window, then ``adapt_build``/``adapt_canary``/
                  ``adapt_swap``; 11 moments and 11 apply launches per
                  collect batch (``serve_adapt``); each collect batch's
                  stats against the same collect through the plain
                  versions, relative to the batch's update
                  (``COLLECT_SITE_TOL`` at the whitened sites,
                  ``COLLECT_TOL`` elsewhere); the adapted stats bitwise the fold of
                  the collected window; ``/metrics`` valid, its
                  ``dwt_serve_domain_shift`` above 0.
44. ``adapt_kernels`` / ``adapt_timing`` — both kernels, f32 and bf16, at
                  the collect forward's site shapes (``[3, 401,408, 64]``,
                  ``[3, 100,352, 64]``, ``[3, 100,352, 256]``): the plain
                  versions, float64 (phase 5's tolerances; the bf16 apply
                  within one rounding step), one launch each; times with
                  L2 cold beside the bound, the plain version and
                  ``torch.baddbmm``/``torch.cov``, summed per collect batch.
45. ``kernels`` — the contract line: per kernel and path its TPU
                  counterpart, launches on that path's run, error and
                  times (``ms`` is the kernel's device time); each row's
                  ``phase_launches`` counts the launches of phases 18–25
                  on its shapes.  Launches are the kernels made: a graph's
                  capture records its launches and makes none, each
                  replay makes them (``cuda_whitening.count_replay``); the
                  graph paths (``*_graph``) are phase 26's runs, their
                  error and ``ms`` measured inside replays, ``host_us``
                  null.  The bf16 variants' rows (``whiten_apply_bf16``,
                  ``whiten_moments_bf16``) are the paths ``train_bf16``
                  and ``digits_train_bf16`` (phase 28's runs) and
                  ``serve_bf16`` (phase 30's), their errors and times from
                  phase 27; the group-size rows (``group_size``, paths
                  ``train_f32_g{g}``/``train_bf16_g{g}``) phase 33's
                  launches (``launches_from``), with phase 32's errors
                  and times at the train sites; the registry's rows
                  (``backbone_rows``): ``vit_train_*`` and ``vit_serve_*``
                  with phase 36's times (the eval forward's, bucket 1's and
                  g = 16/64's beside them), ``visda_train`` and
                  ``resnet152_train`` with their launches and the ResNet50
                  train rows' errors and times (the same 11 site shapes),
                  ``visda_serve`` with its launches and phase 39's errors
                  and times at its bucket-8 sites; the serving plane's rows
                  (``serving_rows``): ``serve_adapt`` (both kernels, phase
                  43's launches, phase 44's f32 errors and times per collect
                  batch), ``serve_int8`` and ``serve_swap`` (phases 41's and
                  42's launches, errors and times at their bucket-32 and
                  bucket-8 sites), ``serve_fleet`` (phase 47's replicas: the
                  apply launches of the straggler window as the replicas'
                  own counters report them in ``/stats``, the errors and
                  times per forward at the window's bucket mix, timed here
                  after the drain, and the replicas' devices, pids on the
                  card and replies against the in-process engine).
46. ``train_run_plane`` — the digits CLI entry (``usps_mnist.main``) at
                  the full width with phase 26's k = 4 flags and
                  ``--metrics_jsonl``, ``--heartbeat_every 4``,
                  ``--metrics_port 0``, ``--alert_rules`` (``RUN_PLANE_RULES``)
                  and ``--expect_accuracy 101``: exit 1 after the
                  ``accuracy_check`` record, the JSONL's kinds, heartbeats at
                  8, 12 and 16, a ``/metrics`` scrape mid-run valid,
                  ``dwt_train_steps_total`` +16, the harvester's host syncs
                  per step those of phase 26's k = 4 run, 2 + 2 launches a
                  step; then a met ``--expect_accuracy`` exits 0 (runs after
                  ``dispatch_digits``).
47. ``fleet``   — ``python -m dwt_tpu_torch.fleet.balancer`` (``FLEET_FLAGS``:
                  2 replicas, ``--respawn_max 2``, autoscaling 2–3) over run
                  A's checkpoint at 224², f32, buckets 1/8/32, the replicas on
                  CUDA (inside the checkpoint block, after ``adapt_serve``):
                  each replica's ``/healthz`` says ``cuda``, ``nvidia-smi``
                  lists both pids with their memory and not the balancer's;
                  seeded 1- and 8-image requests to each replica through the
                  balancer within ``FORWARD_TOL`` of the in-process engine,
                  argmax equal; under a light open load replica 0 is
                  SIGKILLed: ejected, respawned
                  (``dwt_fleet_respawns_total{rid="0"} 1``), serving again,
                  no request without an answer, the card's memory back; the
                  merged ``/metrics`` valid; spawn-to-ready and respawn
                  seconds.  ``fleet_autoscale``: one replica's sustained rate
                  of 1-image requests (16 closed-loop clients for 5 s), the
                  balancer's p50/p99 against the replica's (one client, 300
                  requests each way, alternating),
                  ``tools/torch_serve_bench.py --ramp`` from 0.5× to 3× it: a
                  ``scale_up`` to 3 (``ramp_scale_lag_s``,
                  ``ramp_lost_total`` 0), the autoscaled replica a straggler
                  (``replica_slow_at``, its replies ≥ half its sleep slower
                  than its peers'; each replica's share of a load at 2×
                  recorded; the window's apply launches, 11 a forward in every
                  replica, counted by the replicas), idle a ``scale_down`` to
                  2 whose ``scale_retired`` rc is 0.  ``fleet_drain``:
                  SIGTERM, every replica and the fleet exit 0, no replica
                  left on the card.  ``fleet_b{bucket}_parity`` /
                  ``_timing``: the apply at the window's buckets' sites.
48. ``train_trace`` — span tracing on the flagship (the last phases,
                  after ``adapt_kernels``): the OfficeHome CLI's config at
                  ``TRACE_FLAGS`` (ResNet50-DWT, 3 × 18 images at 224², 9
                  steps at k = 3, harvest depth 2, one collection pass and
                  the final eval) untraced, then with ``--obs_trace``: the
                  export a valid Chrome trace holding ``TRACE_SPANS``,
                  ``step_dispatch`` 3 spans of ``n`` 3, ``tools/
                  torch_obs_report.py`` accounting for 100% of the loop's wall
                  time (its TOTAL row), both runs' launches (11 + 11 a step,
                  checked record by record) and the harvester's host syncs
                  per step equal; step ms (device clock, the first chunk
                  skipped) of both beside the report's top phases.  The
                  same A/B for the digits CLI at phase 26's k = 4 flags in
                  mirrored turns (untraced, traced, traced, untraced; 2 + 2
                  launches a step, checked at the evals).
49. ``serve_trace`` — the ResNet50-DWT server's own wiring with
                  ``--obs_trace``, buckets 1/8/32 and the adapter: 3 rounds of
                  one ``.npy`` request per bucket, one adapter iteration (one
                  collect batch of 32) after the first: the export valid,
                  ``stage``/``device``/``resolve`` one each per batch carrying
                  the batch's ``req_ids`` (those of the access log's records
                  of that batch), one ``adapt_collect``; 11 apply launches a
                  forward, 11 moments and 11 apply for the collect; each
                  bucket's ``device`` spans (p50) beside the access log's
                  ``device_ms``, the forward alone on the same engine (CUDA
                  events) and the requests' e2e.
50. ``flight_recorder`` — the digits CLI in a subprocess (after
                  ``serve_trace``, alone on the card) with ``DWT_OBS_TRACE=1``,
                  ``hang_at_step`` 4 and ``--watchdog_timeout 8``: exit 113,
                  ``stacks-*`` and a valid ``spans-*`` in ``ckpt_dir/
                  watchdog`` whose spans include ``step_dispatch`` or
                  ``boundary``.

The last two lines are the card's ``nvidia-smi`` name/power limit and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import copy
import functools
import itertools
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

RESNET50_SITES = (  # (site, M at bucket 128 and 224², C, sites per forward)
    ("stem_dn1", 128 * 112 * 112, 64, 1),
    ("stage1_c64", 128 * 56 * 56, 64, 6),
    ("stage1_c256", 128 * 56 * 56, 256, 4),
)
TRAIN_SITES = (  # (site, M per domain at 18 images and 224², C, sites per step)
    ("stem_dn1", 18 * 112 * 112, 64, 1),
    ("stage1_c64", 18 * 56 * 56, 64, 6),
    ("stage1_c256", 18 * 56 * 56, 256, 4),
)
DOMAINS = 3  # domain branches of a train site: one moments and one apply launch
RAGGED_M = 1000
APPLY_RAGGED_M = (1, 7, 1000)  # ragged rows of the batched apply's parity
TRACED_CALLS = 10  # calls in the trace that shows what one call puts on the card
APPLY_KERNELS = ("whiten_apply_f32_kernel",)
APPLY_EXTRA = ("host_us", "copy_device_ms")  # apply timings summed per step
MOMENTS_EXTRA = ("host_us",)  # moments timings summed per step
MOMENTS_KERNELS = ("whiten_moments_f32_kernel",)
# Kernel timings cycle through distinct buffers of at least this many
# bytes in all, more than the H100's 50 MB L2, so no reading comes from L2.
COLD_BYTES = 100_000_000
MEAN_TOL = 1e-6                   # moments: mean rtol = atol
COV_RTOL, COV_ATOL = 1e-4, 1e-5   # moments: cov
# The phases before ``dispatch`` read every train record synchronously
# (``--harvest_depth 0``): their step times run batch to batch, and each
# record's launches are checked when it is logged.  Phase ``dispatch`` runs
# the defaults (harvest depth 2) and k steps per dispatch.
SYNC_RECORDS = ["--harvest_depth", "0"]
TRAIN_BASE_FLAGS = [
    "--synthetic", "--arch", "resnet50", "--num_classes", "65",
    "--img_crop_size", "224", "--source_batch_size", "18", "--num_iters", "6",
    "--check_acc_step", "3", "--stat_collection_passes", "1", "--seed", "1",
    "--log_interval", "1",
]
TRAIN_FLAGS = TRAIN_BASE_FLAGS + SYNC_RECORDS
# The image-folder path: two OfficeHome-shaped folders written from seed 1
# (65 classes of 3 JPEGs per domain, sides drawn from 300-800 px, quality
# 90), trained Art → Clipart through the CLI entry with 4 loader threads;
# 12 steps cross the 10-batch epoch (195 images at 18 per batch).
FOLDER_DOMAINS = ("Art", "Clipart")
FOLDER_CLASSES, FOLDER_PER_CLASS, FOLDER_SIDES = 65, 3, (300, 800)
FOLDER_TRAIN_FLAGS = [
    "--num_workers", "4", "--num_iters", "12", "--check_acc_step", "6",
    "--stat_collection_passes", "1", "--log_interval", "1",
    "--arch", "resnet50", "--num_classes", "65", "--img_crop_size", "224",
    "--source_batch_size", "18", "--seed", "1", "--resnet_path", "",
] + SYNC_RECORDS
WORKER_COUNTS = (1, 2, 4, 8)  # loader threads at which the streams are timed
RATE_BATCHES = 4  # batches per stream and worker count in the image rates
PROFILED_STEPS = 4  # folder steps in the profiled window of the idle share
WHITENED_SITES = 11  # ResNet50-DWT: the stem and the 10 norm sites of stage 1
# The ResNet50 step held to its plain-kernel twin: images per stream, size.
REFERENCE_STEP = (18, 224)
TOL = 1e-5            # kernel vs plain, per element: rtol = atol = 1e-5
FORWARD_TOL = 1e-4    # whole forwards: max |a − b| / max |b|
# Train steps against their references (the kernel step against the plain
# step and against a float64 step, the tiny model's card step against the
# CPU's), by relative error: losses and running stats (max |a − b| /
# max |b| per stat tensor) at TRAIN_TOL, the gradient norm at
# TRAIN_GRAD_TOL, and per parameter (compare_steps) its gradient and its
# update, less one float32 spacing of the stored value per element.
# The per-parameter limits come from tools/torch_step_sensitivity.py on
# the H100 over 5 seeds (PERF.md, PR 2).  A fresh ResNet50-DWT step is
# ill-conditioned in its backbone gradients: moving every input pixel by
# one f32 rounding unit moves the float64 step's backbone gradients by
# 0.08-0.64%, and every backbone leaf of an f32 step (kernels or plain
# versions) sits 0.6-2.8% from float64, the head's ≤ 1.3e-5.  So each
# backbone leaf is held at 5e-2 and the head at 1e-4, and the kernel
# step's gradient over all parameters may be no further from float64
# than F64_RATIO_TOL times the plain step's (readings 0.87-1.04).  The
# tiny model has no such sensitivity (card vs CPU ≤ 2.2e-4 per leaf).
TRAIN_TOL = 5e-4
TRAIN_GRAD_TOL = 2e-3
RESNET50_LEAF_TOL = (5e-2, 1e-4)  # (backbone, head)
F64_RATIO_TOL = 1.25
TINY_LEAF_TOL = 2e-3
STEP_METRICS = ("loss", "cls_loss", "mec_loss", "entropy_loss", "grad_norm")
FP32_PEAK = 67e12     # H100 SXM f32 outside the tensor cores (data sheet)
BF16_PEAK = 989e12    # H100 SXM bf16 on the tensor cores, dense (data sheet)

# The digits slice: LeNet-DWT, 2 domain branches, whitened sites in groups of 4.
DIGITS_SITES = (("dn1", 32, 28 * 28), ("dn2", 48, 14 * 14))  # (site, C, rows per image)
DIGITS_STREAM = 32  # images per stream: the reference recipe
DIGITS_APPLY_BATCHES = (("eval", 100), ("serve_b1", 1), ("serve_b128", 128))
DIGITS_BASE_FLAGS = [
    "--synthetic", "--group_size", "4", "--synthetic_size", "256", "--epochs", "2",
    "--seed", "1", "--log_interval", "1",
]
DIGITS_TRAIN_FLAGS = DIGITS_BASE_FLAGS + SYNC_RECORDS
DIGITS_STEPS_PER_EPOCH = 256 // DIGITS_STREAM
# Biases that feed a normalization site: the batch mean removes them, so
# their exact gradient is zero and every step computes rounding noise,
# which Adam's first step (lr·g/(|g| + 1e-8)) turns into ±lr.  They are
# held to be noise (at most DIGITS_NOISE_TOL of the step's gradient norm)
# instead of leaf by leaf.
DIGITS_NORMALIZED_BIASES = ("conv1.bias", "conv2.bias", "fc3.bias", "fc4.bias",
                            "fc5.bias")
DIGITS_NOISE_TOL = 1e-6  # readings on the H100: 5.6e-8 (f32), 9.2e-17 (float64)
# Every other parameter's gradient and update (beyond rounding) against
# the plain step and the float64 step.  Readings on the H100: gradients
# ≤ 1.1e-6 per parameter, updates ≤ 4.8e-6 (fc3.weight: Adam divides by
# |g| + 1e-8, so its smallest gradients reach the update); loss ≤ 1.6e-7,
# stats ≤ 4.8e-7 (held at TRAIN_TOL).
DIGITS_LEAF_TOL = 1e-4

# Checkpoints: the main train path with a save every 3 steps (runs A and
# A2 uninterrupted; run B cut by its logger at CKPT_CUT's train record,
# then resumed from step 3), and the digits path with a save every epoch.
CKPT_FLAGS = TRAIN_FLAGS + ["--ckpt_every_iters", "3"]
CKPT_CUT = 4
DIGITS_CKPT_FLAGS = DIGITS_TRAIN_FLAGS + ["--ckpt_every_epochs", "1"]
# A resumed run against the uninterrupted one, on the card, by relative
# error (train and eval losses |a − b| / |b|; each parameter and stat
# tensor max |a − b| / max |b|).  With cuDNN's default algorithms two
# uninterrupted ResNet50 runs of one call differ by percents in a train
# loss after 6 steps (tools/torch_resume_spread.py): the backward's sums
# are not repeatable and the first steps amplify the difference.  So the
# compared runs use cuDNN's deterministic algorithms, under which the
# kernels and the rest of the step are bitwise repeatable (phases 3 and
# 5 for the kernels): two uninterrupted runs must be bitwise equal, and
# the resumed run bitwise equal to them.
RESUME_KEYS = ("train_loss", "eval_loss", "params", "stats")
SERVED_IMAGES = 8  # test images sent to a server restored from a checkpoint
# The resilience phases.  The main train path's saves run on the background
# writer (A, A2, B); run S saves on the loop's thread and is held to A
# bitwise.  OVERLAP_FLAGS: 20 steps with a save every 10 and no eval, whose
# steps after the first OVERLAP_WARMUP are timed with and without a write
# in flight (a write lasts ~4 steps, so each kind has several).
OVERLAP_FLAGS = TRAIN_FLAGS + ["--num_iters", "20", "--check_acc_step", "100",
                               "--stat_collection_passes", "0", "--ckpt_every_iters", "10"]
OVERLAP_WARMUP = 2
# guard: a NaN injected after step 4, a check every 2 steps, saves every 3:
# a rollback from 4 to the step-3 checkpoint, then (with --guard_lr_backoff)
# an in-memory recovery at scale 0.5.
GUARD_NAN_STEP = 4
GUARD_FLAGS = CKPT_FLAGS + ["--guard_policy", "rollback", "--guard_interval", "2"]
# Guard syncs: 6 steps without evals, read back only by the guard.
SYNC_FLAGS = TRAIN_FLAGS + ["--check_acc_step", "100", "--stat_collection_passes", "0",
                            "--log_interval", "1000"]
SNAPSHOT_REPEATS = 10
SNAPSHOT_SPIN_CYCLES = 200_000_000  # ~0.1 s of the card's clock: more than the enqueue
DELTA_FLAGS = CKPT_FLAGS + ["--ckpt_format", "delta"]
PREEMPT_STEP = 4  # a SIGTERM at this step's boundary
# chaos_digits: the digits CLI in subprocesses, one fault each (8 steps an
# epoch, a save after each).
CHAOS_DIGITS = {
    "hang": ({"hang_at_step": 10}, ["--epochs", "3", "--watchdog_timeout", "20"],
             {"rc": 113, "steps": [8]}),
    "crash_in_save": ({"crash_in_save": 16}, ["--epochs", "3"],
                      {"rc": 1, "steps": [8], "stderr": "injected crash"}),
    "io_error_transient": ({"io_error_saves": 2}, ["--epochs", "2"],
                           {"rc": 0, "steps": [8, 16]}),
    "io_error_persistent": ({"io_error_saves": 99}, ["--epochs", "2"],
                            {"rc": 1, "steps": [], "stderr": "injected I/O error"}),
}
CKPT_PHASES = {  # the kernels line's path → the checkpoint phases on its shapes
    "train": ("ckpt_resume", "convert", "guard", "delta", "preempt"),
    "serve": ("ckpt_serve", "delta_serve"),
    "digits_train": ("digits_ckpt", "chaos_digits"),
    "digits_serve": ("digits_ckpt_serve",)}


EMITTED = []  # the phase of every row printed, in order


def emit(obj) -> None:
    EMITTED.append(obj.get("phase"))
    print(json.dumps(obj), flush=True)


# The warning of autograd's engine when a leaf's gradient accumulates on a
# stream other than the one that produced it: the smoke fails on it.
STREAM_WARNING = "AccumulateGrad node's stream does not match"


class PhaseWarnings:
    """Every warning shown while inside, with the rows printed just before
    and just after it (the phase that raised it ends with the latter) and
    the Python stack it was raised from; each is still shown as before."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        import traceback
        import warnings

        self.module, self.inner = warnings, warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            self.seen.append({"after": EMITTED[-1] if EMITTED else None,
                              "at_row": len(EMITTED), "category": category.__name__,
                              "message": str(message)[:400], "where": f"{filename}:{lineno}",
                              "stack": [ln.strip() for ln in traceback.format_stack()[-14:-1]]})
            self.inner(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        return self

    def __exit__(self, *exc):
        self.module.showwarning = self.inner

    def rows(self):
        """The warnings with the phase row that followed each."""
        return [{**{k: v for k, v in w.items() if k != "at_row"},
                 "before": EMITTED[w["at_row"]] if w["at_row"] < len(EMITTED) else None}
                for w in self.seen]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    """Bytes/s of the card's memory, from the published table (NVIDIA's
    data sheets), by the device name CUDA reports."""
    table = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))
    for key, rate in table:
        if key in name:
            return rate
    raise RuntimeError(f"no published memory rate for {name!r}")


def cuda_ms(torch, fn, rotation=((),), iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call of ``fn(*rotation[i % len(rotation)])`` by
    CUDA events around back-to-back calls (host time included)."""
    for i in range(warmup):
        fn(*rotation[i % len(rotation)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*rotation[i % len(rotation)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(torch, fn, iters: int = 1, cats=DEVICE_CATS, attempts: int = 3):
    """The events of categories ``cats`` (by default the device's: kernels,
    copies, memsets) of ``iters`` calls of ``fn()`` in a ``torch.profiler``
    trace, in order.  The profiler on the H100's machine now and then
    delivers a trace without a device event: such a trace is taken again,
    up to ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        events = [ev for ev in trace.get("traceEvents", [])
                  if ev.get("cat") in cats and "dur" in ev]
        if any(ev["cat"] in DEVICE_CATS for ev in events):
            break
    return events


def device_ms(torch, fn, names, rotation=((),), iters: int = 20,
              cats=("kernel",)) -> float:
    """Device time per call of the kernels whose names contain one of
    ``names`` (``None``: every kernel; ``cats`` also ``"gpu_memcpy"``:
    copies too), from a ``torch.profiler`` trace of ``iters`` calls of
    ``fn(*rotation[i % len(rotation)])``: the kernels' own time, without
    the host time around them (which exceeds the kernel at the small train
    shapes).  The profiler has been seen to drop some of a trace's device
    events, so per kernel name the mean duration is taken, times its
    launches per call (its count over ``iters``, rounded); a trace without
    any of the kernels is taken again, up to 3 traces in all."""
    for args in rotation:
        fn(*args)
    calls = itertools.count()
    for _ in range(3):
        events = trace_events(
            torch, lambda: fn(*rotation[next(calls) % len(rotation)]), iters)
        by_name = {}
        for ev in events:
            if ev["cat"] in cats and (names is None or any(n in ev["name"] for n in names)):
                by_name.setdefault(ev["name"], []).append(ev["dur"])
        if by_name:
            break
    else:
        raise RuntimeError(f"the profiler recorded no {names} kernel in 3 traces")
    return sum(sum(d) / len(d) * max(1, round(len(d) / iters))
               for d in by_name.values()) / 1e3


def kernel_device_ms(torch, fn, names, rotation, bytes_ms):
    """``device_ms`` of a hand kernel over an L2-cold ``rotation``, traced
    again (3 traces at most) while it reads below ``bytes_ms``, the time
    its bytes take at the memory rate: with L2 cold no kernel moves its
    bytes faster than memory, so such a reading is the profiler's (one
    trace at a 26 MB site has read 0.58 of the bound).  Returns ``(ms,
    traces)``."""
    for traces in range(1, 4):
        ms = device_ms(torch, fn, names, rotation)
        if ms >= bytes_ms:
            break
    return ms, traces


def cold_rotation(torch, tensors, out_like=()):
    """Argument tuples over distinct buffers, so that timing a kernel by
    cycling through them finds L2 cold: ``tensors`` and their copies, with
    fresh ``out_like``-shaped outputs, ``COLD_BYTES`` or more in all and at
    least two sets."""
    per_set = sum(t.numel() * t.element_size() for t in (*tensors, *out_like))
    sets = max(2, -(-COLD_BYTES // per_set))
    first = (*tensors, *(torch.empty_like(t) for t in out_like))
    return [first] + [(*(t.clone() for t in tensors),
                       *(torch.empty_like(t) for t in out_like))
                      for _ in range(sets - 1)]


def norm_err(a, b) -> float:
    """``max |a − b| / max |b|`` (logits of fresh-init stats are large)."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def site_inputs(torch, m, c, gen, cpu_gen, device, d=None):
    """``x [m, c]``, ``mean [c]`` and ``w [c/4, 4, 4]`` of an apply site;
    with ``d``, ``x [d, m, c]``, ``mean [d, c]`` and ``w [d, c/4, 4, 4]``,
    each domain its own draw."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    if d is not None:
        parts = [site_inputs(torch, m, c, gen, cpu_gen, device) for _ in range(d)]
        return tuple(torch.stack(ts) for ts in zip(*parts))
    x = torch.randn(m, c, generator=gen, device=device) * 2.0 + 1.0
    mean = torch.randn(c, generator=gen, device=device) * 0.5
    a = torch.randn(c // 4, 4, 4, dtype=torch.float64, generator=cpu_gen)
    cov = a @ a.transpose(-1, -2) / 4 + 0.5 * torch.eye(4, dtype=torch.float64)
    w = whitening_matrix(_shrink(cov.float(), 1e-3)).to(device).contiguous()
    return x, mean, w


HOST_CALLS = 200  # wrapper calls per host-time reading


def host_us(torch, fn, rotation) -> float:
    """Host microseconds per ``fn`` call, over ``HOST_CALLS`` calls
    through ``rotation`` with no synchronisation inside (the launches
    queue up; the host never waits for the device)."""
    for args in rotation:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(HOST_CALLS):
        fn(*rotation[i % len(rotation)])
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / HOST_CALLS * 1e6


@functools.lru_cache(maxsize=None)
def launch_floor_ms(torch) -> float:
    """Device time of an empty launch (``torch.cuda._sleep(0)``: one
    thread that returns at once), the card's per-launch floor; measured
    once per run."""
    return device_ms(torch, lambda: torch.cuda._sleep(0), None, iters=50)


def time_apply(torch, cw, x, mean, w, rate):
    """Times of the apply kernel on ``x [M, C]`` or, for the D domains of
    a train site, ``x [D, M, C]`` (one launch) with L2 cold: its device
    time (``device_ms``; ``kernel_ms`` by CUDA events, host time
    included), the wrapper's host µs per call, its plain version's time,
    the library yardstick's (``torch.addmm`` with the block-diagonal
    matrix, ``torch.baddbmm`` over the domains; ``library_ms`` by CUDA
    events, ``library_device_ms`` its kernels' device time), a D2D copy's
    of the same bytes (``copy_ms`` by CUDA events, ``copy_device_ms``) and
    the launch floor, beside its bound."""
    batched = x.dim() == 3
    d, (m, c) = (x.shape[0] if batched else 1), x.shape[-2:]
    w3, mean3 = (w, mean) if batched else (w[None], mean[None])
    w_t = torch.stack([torch.block_diag(*wd).t() for wd in w3]).contiguous()
    bias = -(mean3[:, None, :] @ w_t)  # [D, 1, C]
    if batched:
        library = lambda xi, yi: torch.baddbmm(bias, xi, w_t, out=yi)
    else:
        library = lambda xi, yi: torch.addmm(bias[0, 0], xi, w_t[0], out=yi)
    lib_err = float((library(x, torch.empty_like(x))
                     - cw.whiten_apply_plain(x, mean, w)).abs().max())
    nbytes = 4 * d * (2 * m * c + 5 * c)  # read x, mean, w; write y
    flops = d * m * c * 9  # per 4 channels: 4 subtracts + 16 FMAs
    bytes_ms, ops_ms = nbytes / rate * 1e3, flops / FP32_PEAK * 1e3
    cold = cold_rotation(torch, (x,), out_like=(x,))  # (x_i, y_i)
    kernel = lambda xi, yi: cw.whiten_apply(xi, mean, w, out=yi)
    copy = lambda xi, yi: yi.copy_(xi)
    row = {
        "D": d if batched else None, "M": m, "C": c, "bytes": nbytes,
        "rotation_buffers": len(cold),
        "kernel_ms": cuda_ms(torch, kernel, cold),
        **dict(zip(("device_ms", "device_traces"),
                   kernel_device_ms(torch, kernel, APPLY_KERNELS, cold, bytes_ms))),
        "host_us": host_us(torch, kernel, cold),
        "plain_ms": cuda_ms(
            torch, lambda xi, yi: cw.whiten_apply_plain(xi, mean, w, out=yi),
            cold, iters=10),
        "library_ms": cuda_ms(torch, library, cold),
        "library_device_ms": device_ms(torch, library, None, cold),
        "copy_ms": cuda_ms(torch, copy, cold),
        "copy_device_ms": device_ms(torch, copy, None, cold,
                                    cats=("kernel", "gpu_memcpy")),
        "launch_floor_ms": launch_floor_ms(torch),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_max_abs_err": lib_err,
    }
    row["kernel_GBps"] = nbytes / row["device_ms"] / 1e6
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    row["copy_bound_share"] = row["bound_ms"] / row["copy_device_ms"]
    return row


def time_moments(torch, cw, x, rate):
    """Times of the moments kernel on ``x [D, M, C]`` (one launch for its D
    domains) with L2 cold, beside its plain version's, the library
    yardstick's (``torch.cov`` once per domain: the full C×C covariance,
    whose diagonal 4×4 blocks are the kernel's ``cov``) and its bound."""
    d, m, c = x.shape
    groups = c // 4
    cov = cw.whiten_moments(x, 4)[1]
    gi = torch.arange(groups, device=x.device)
    lib = torch.cov(x[0].t(), correction=0).view(groups, 4, groups, 4)[gi, :, gi, :]
    lib_err = float((lib - cov[0]).abs().max())
    nbytes = d * m * c * 4 + d * (c + groups * 16) * 4
    flops = d * m * c * 6  # per 4 channels: 4 adds, 10 FMAs
    bytes_ms, ops_ms = nbytes / rate * 1e3, flops / FP32_PEAK * 1e3
    cold = cold_rotation(torch, (x,))
    kernel = lambda xi: cw.whiten_moments(xi, 4)
    library = lambda xi: [torch.cov(xi[k].t(), correction=0) for k in range(d)]
    row = {
        "D": d, "M": m, "C": c, "bytes": nbytes, "rotation_buffers": len(cold),
        "kernel_ms": cuda_ms(torch, kernel, cold),
        **dict(zip(("device_ms", "device_traces"),
                   kernel_device_ms(torch, kernel, MOMENTS_KERNELS, cold, bytes_ms))),
        "host_us": host_us(torch, kernel, cold),
        "plain_ms": cuda_ms(torch, lambda xi: cw.whiten_moments_plain(xi, 4),
                            cold, iters=10),
        "library_ms": cuda_ms(torch, library, cold, iters=10),
        "library_device_ms": device_ms(torch, library, None, cold, iters=10),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_max_abs_err": lib_err,
    }
    row["kernel_GBps"] = nbytes / row["device_ms"] / 1e6
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    return row


def apply_graph_replays(torch, cw, x, mean, w, eager):
    """Capture one apply launch in a CUDA graph, replay it twice over a
    zeroed output: is every replay bitwise the eager result?"""
    out = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cw.whiten_apply(x, mean, w, out=out)
    same = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(out, eager))
    del graph, out
    return all(same)


def apply_parity(torch, cw, name, x, mean, w, full=False):
    """The apply kernel against its plain version on ``x [M, C]`` or ``x
    [D, M, C]``: one launch, within ``rtol = atol = TOL`` per element.
    With ``full``, also: one kernel per call and no other device operation
    in a profiler trace of calls, a second call bitwise equal to the
    first, and two graph replays bitwise equal to it."""
    before = cw.apply_launches
    y = cw.whiten_apply(x, mean, w)
    launches = cw.apply_launches - before
    ref = cw.whiten_apply_plain(x, mean, w)
    torch.cuda.synchronize()
    diff = (y - ref).abs()
    row = {"shape": name, "D": x.shape[0] if x.dim() == 3 else None,
           "M": x.shape[-2], "C": x.shape[-1], "launches": launches,
           "max_abs_err": float(diff.max()),
           "max_rel_err": float((diff / ref.abs().clamp_min(1e-30)).max()),
           "rtol": TOL, "atol": TOL}
    ok = bool((diff <= TOL + TOL * ref.abs()).all()) and launches == 1
    del ref, diff
    if full:
        again = cw.whiten_apply(x, mean, w)
        torch.cuda.synchronize()
        row["repeat_bitwise"] = torch.equal(again, y)
        del again
        row["graph_replay_bitwise"] = apply_graph_replays(torch, cw, x, mean, w, y)
        # A trace of TRACED_CALLS calls: every device operation in it is the
        # kernel, at most one per call.  (A trace of one short call can
        # come back empty after the serve phase; the profiler drops device
        # events now and then, so fewer than one per call may be recorded.)
        ops = [ev["name"][:80] for ev in trace_events(
            torch, lambda: cw.whiten_apply(x, mean, w), iters=TRACED_CALLS)]
        row["device_ops_per_call"] = sorted(set(ops))
        row["device_ops_in_trace"] = len(ops)
        ok = (ok and row["repeat_bitwise"] and row["graph_replay_bitwise"]
              and 1 <= len(ops) <= TRACED_CALLS
              and all(any(n in op for n in APPLY_KERNELS) for op in ops))
    row["ok"] = ok
    return row


def check_kernel(torch, cw, device, rate):
    """Parity at every shape (serve ``[M, C]``, train ``[D, M, C]``),
    timing at the bucket-128 shapes."""
    gen = torch.Generator(device=device).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    shapes = [(name, None, m, c) for name, m, c, _ in RESNET50_SITES]
    shapes += [("ragged_c64", None, RAGGED_M, 64), ("ragged_c256", None, RAGGED_M, 256)]
    shapes += [(f"train_{name}", DOMAINS, m, c) for name, m, c, _ in TRAIN_SITES]
    shapes += [("train_d1_c256", 1, 18 * 56 * 56, 256)]
    shapes += [(f"train_ragged_m{m}_c{c}", DOMAINS, m, c)
               for m in APPLY_RAGGED_M for c in (64, 256)]
    train_shapes = {f"train_{name}" for name, *_ in TRAIN_SITES}
    parity, timing = [], {}
    for name, d, m, c in shapes:
        x, mean, w = site_inputs(torch, m, c, gen, cpu_gen, device, d)
        row = apply_parity(torch, cw, name, x, mean, w, full=name in train_shapes)
        parity.append(row)
        emit({"phase": "parity", **row})
        if not row["ok"]:
            raise AssertionError(f"kernel disagrees with plain at {name}: {row}")
        if d is not None or m == RAGGED_M:
            continue
        row = {"shape": name, **time_apply(torch, cw, x, mean, w, rate)}
        timing[name] = row
        emit({"phase": "timing", **row})
        del x
        torch.cuda.empty_cache()
    return parity, timing


SERVED = {  # per served model: flags, image shape, classes, whitened
    # sites per forward, and the names of its phases
    "resnet50": dict(
        flags=["--model", "resnet50", "--num_classes", "65", "--image_size", "224"],
        shape=(224, 224, 3), classes=65, sites=11,
        phases=("engine", "serve", "reference", "throughput")),
    "lenet": dict(
        flags=["--model", "lenet"], shape=(28, 28, 1), classes=10, sites=2,
        phases=("digits_engine", "digits_serve", "digits_serve_reference",
                "digits_serve_throughput")),
    # The bf16 forward, held to its f32 twin (same weights) per bucket
    # instead of to a CPU forward.
    "resnet50_bf16": dict(
        flags=["--model", "resnet50", "--num_classes", "65", "--image_size", "224",
               "--serve_dtype", "bf16"],
        shape=(224, 224, 3), classes=65, sites=11, f32_twin=True,
        phases=("bf16_engine", "bf16_serve", "bf16_serve_reference",
                "bf16_serve_throughput")),
    # VisDA's ResNet101 (its checkpoint: phase visda_serve).
    "resnet101": dict(
        flags=["--model", "resnet101", "--num_classes", "12", "--image_size", "224"],
        shape=(224, 224, 3), classes=12, sites=11),
    # ViT-S/16, which the server's --model does not offer: a ServeEngine
    # built through the Python API behind the same front end.
    "vit_dwt": dict(
        flags=["--image_size", "224"], shape=(224, 224, 3), classes=65, sites=4,
        engine=lambda args: vit_engine(args, "f32"),
        phases=("vit_engine", "vit_serve", "vit_serve_reference", "vit_serve_throughput")),
    "vit_dwt_bf16": dict(
        flags=["--image_size", "224"], shape=(224, 224, 3), classes=65, sites=4,
        engine=lambda args: vit_engine(args, "bf16"),
        twin=lambda args: vit_engine(args, "f32"), f32_twin=True,
        phases=("vit_bf16_engine", "vit_bf16_serve", "vit_bf16_serve_reference",
                "vit_bf16_serve_throughput")),
}
# bf16 logits against their f32 twin's, max |a − b| / max |b| per bucket.
BF16_SERVE_TOL = 5e-2


def serve(torch, cw, server, model="resnet50"):
    """A main path: the port's HTTP server on ResNet50-DWT at 224² (or
    LeNet-DWT at 28×28); returns the apply kernel's launches on it."""
    import numpy as np

    spec = SERVED[model]
    shape, classes, sites = spec["shape"], spec["classes"], spec["sites"]
    engine_phase, serve_phase, reference_phase, throughput_phase = spec["phases"]
    args_list = spec["flags"] + [
        "--buckets", "1,8,32,128", "--init_random", "--seed", "0",
        "--host", "127.0.0.1", "--port", "0",
    ]
    args = server.build_parser().parse_args(args_list)
    t0 = time.perf_counter()
    # A model the server's --model does not offer is served through the
    # engine's Python API (spec["engine"]).
    engine = spec["engine"](args) if "engine" in spec else server.build_engine(args)
    build_s = time.perf_counter() - t0
    emit({"phase": engine_phase, "build_s": build_s, "warmup_s": engine.warmup_s,
          "device": str(engine.device),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the engine must run f32 convs/matmuls without TF32")

    rng = np.random.default_rng(0)
    sizes = (1, 5, 32, 128)
    inputs = [rng.normal(size=(n,) + shape).astype(np.float32) for n in sizes]
    client = server.ServeClient(engine, max_batch_delay_ms=args.max_batch_delay_ms,
                                max_queue_items=args.max_queue)
    front = server.HttpFront(client, args.host, args.port)
    http = server.HttpServeClient(args.host, front.port, timeout=300)
    try:
        status, health = http.healthz()
        if status != 200 or not health["ok"]:
            raise AssertionError(f"/healthz: {status} {health}")
        cw.apply_launches = 0
        torch.cuda.reset_peak_memory_stats()
        responses, e2e_ms = [], []
        for x in inputs:
            t = time.perf_counter()
            responses.append(http.infer(x, binary=x.shape[0] >= 32))
            e2e_ms.append((time.perf_counter() - t) * 1e3)
        launches = cw.apply_launches
        batches = client.batches
        stats = http.stats()
    finally:
        http.close()
        front.close()
    forwards = sum(batches.values())
    emit({"phase": serve_phase, "model": model, "requests": list(sizes),
          "e2e_ms": e2e_ms, "batches_by_bucket": batches,
          "apply_launches": launches, "stats": stats})
    if batches != {1: 1, 8: 1, 32: 1, 128: 1}:
        raise AssertionError(f"expected one batch per bucket, got {batches}")
    if launches != sites * forwards:
        raise AssertionError(
            f"{launches} kernel launches for {forwards} forwards, not {sites} each")

    worst = 0.0
    for x, out in zip(inputs, responses):
        if out.shape != (x.shape[0], classes) or not np.isfinite(out).all():
            raise AssertionError(f"bad response {out.shape} for {x.shape[0]} images")
        err = norm_err(torch.from_numpy(out), torch.from_numpy(engine.infer(x)))
        worst = max(worst, err)
    if worst > TOL:
        raise AssertionError(f"HTTP logits differ from engine.infer by {worst}")

    # Kernel vs plain apply in the same bucket-8 forward, both on the card.
    x8 = engine.stage(inputs[1][:5].repeat(2, axis=0)[:8])
    with torch.inference_mode():
        kernel_logits = engine.forward(x8, 8).clone()
        kernel_fn = cw.whiten_apply
        cw.whiten_apply = cw.whiten_apply_plain
        try:
            plain_logits = engine.forward(x8, 8)
        finally:
            cw.whiten_apply = kernel_fn
    kernel_vs_plain = norm_err(kernel_logits, plain_logits)
    if spec.get("f32_twin"):
        # The same weights served in f32: each bucket's bf16 logits against
        # the twin's, relative to their scale.
        twin = (spec["twin"](args) if "twin" in spec else server.build_engine(
            server.build_parser().parse_args(
                [f for f in args_list if f not in ("--serve_dtype", "bf16")])))
        vs_f32 = {x.shape[0]: norm_err(torch.from_numpy(out),
                                       torch.from_numpy(twin.infer(x)))
                  for x, out in zip(inputs, responses)}
        emit({"phase": reference_phase, "http_vs_infer": worst,
              "kernel_vs_plain_bucket8": kernel_vs_plain, "bf16_vs_f32": vs_f32,
              "tolerance": BF16_SERVE_TOL,
              "logits_max_abs": float(np.abs(responses[-1]).max())})
        if kernel_vs_plain > FORWARD_TOL or max(vs_f32.values()) > BF16_SERVE_TOL:
            raise AssertionError("bf16 forward disagrees with its references")
    else:
        # The card's forward vs the same model on the CPU, one image.
        twin = None
        cpu_model = copy.deepcopy(engine.model).cpu()
        with torch.inference_mode():
            cpu_logits = cpu_model(torch.from_numpy(inputs[0]))
        gpu_vs_cpu = norm_err(torch.from_numpy(responses[0]), cpu_logits)
        emit({"phase": reference_phase, "http_vs_infer": worst,
              "kernel_vs_plain_bucket8": kernel_vs_plain,
              "gpu_vs_cpu_bucket1": gpu_vs_cpu, "tolerance": FORWARD_TOL,
              "logits_max_abs": float(np.abs(responses[-1]).max())})
        if kernel_vs_plain > FORWARD_TOL or gpu_vs_cpu > FORWARD_TOL:
            raise AssertionError("forward disagrees with its reference")

    per_bucket = {}
    for b in engine.buckets:
        xb = engine.stage(np.zeros((b,) + shape, np.float32))
        ms = cuda_ms(torch, lambda: engine.forward(xb, b), iters=10, warmup=2)
        per_bucket[b] = {"forward_ms": ms, "imgs_per_s": b / ms * 1e3}
        if twin is not None:  # the f32 twin's, in turn
            per_bucket[b]["f32_twin_forward_ms"] = cuda_ms(
                torch, lambda: twin.forward(xb, b), iters=10, warmup=2)
    emit({"phase": throughput_phase, "per_bucket": per_bucket,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return launches


# ----------------------------------------------------------------- moments


def moments_input(torch, d, m, c, gen, device, offset=0.0):
    """``[d, m, c]``, each domain its own draw: channels correlated within
    a group, spread ~1.5, mean ``offset``."""
    x = torch.randn(d, m, c, generator=gen, device=device) * 1.5
    return x + 0.5 * x.roll(1, dims=2) + offset


def two_pass_f64(torch, x, g=4):
    """Per domain of ``x [D, M, C]``: mean and biased cov of groups of
    ``g`` in float64, the cov from the centred input."""
    xd = x.double()
    mean = xd.mean(dim=1)
    t = (xd - mean[:, None]).view(*x.shape[:2], -1, g)
    return mean, torch.einsum("kmgc,kmgd->kgcd", t, t) / x.shape[1]


def moments_errors(torch, mean, cov, ref_mean, ref_cov):
    dm = (mean.double() - ref_mean.double()).abs()
    dc = (cov.double() - ref_cov.double()).abs()
    ok = bool((dm <= MEAN_TOL + MEAN_TOL * ref_mean.double().abs()).all()
              and (dc <= COV_ATOL + COV_RTOL * ref_cov.double().abs()).all())
    return float(dm.max()), float(dc.max()), ok


def graph_replays(torch, cw, x, eager, g=4):
    """Capture one moments launch (group size ``g``) in a CUDA graph,
    replay it twice over zeroed outputs: is every replay bitwise the eager
    result?  (The arrival counters must be zero again after each
    launch.)"""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cw.whiten_moments(x, g)
    same = []
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(a, b) for a, b in zip(captured, eager)))
    del graph, captured
    return all(same)


def check_moments(torch, cw, device, rate):
    """Moments parity at every shape; moments and apply timing (one
    launch each per site, all domains) at the train shapes."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    gen = torch.Generator(device=device).manual_seed(1)
    shapes = [(name, DOMAINS, m, c, 0.0) for name, m, c, _ in TRAIN_SITES]
    shapes += [("d1_c256", 1, 18 * 56 * 56, 256, 0.0),
               ("d2_c64", 2, 18 * 56 * 56, 64, 0.0),
               ("ragged_c64", DOMAINS, RAGGED_M, 64, 0.0),
               ("ragged_c256", DOMAINS, RAGGED_M, 256, 0.0),
               ("offset_c256", DOMAINS, 18 * 56 * 56, 256, 4.0)]
    train_shapes = {name for name, *_ in TRAIN_SITES}
    parity, timing = [], {}
    for name, d, m, c, offset in shapes:
        x = moments_input(torch, d, m, c, gen, device, offset)
        before = cw.moments_launches
        mean, cov = cw.whiten_moments(x, 4)
        launches = cw.moments_launches - before
        again = cw.whiten_moments(x, 4)
        torch.cuda.synchronize()
        repeat_bitwise = torch.equal(again[0], mean) and torch.equal(again[1], cov)
        replay_bitwise = (graph_replays(torch, cw, x, (mean, cov))
                          if name in train_shapes else None)
        # What one call puts on the device: one kernel, nothing else.
        device_ops = [ev["name"][:80] for ev in
                      trace_events(torch, lambda: cw.whiten_moments(x, 4))]
        p_mean, p_cov = cw.whiten_moments_plain(x, 4)
        r_mean, r_cov = two_pass_f64(torch, x)
        # The apply kernel on all domains in one launch, each whitened with
        # its own moments as a train step whitens it.
        w = whitening_matrix(_shrink(cov, 1e-3))
        a_row = apply_parity(torch, cw, name, x, mean, w)
        a_err, a_ok = a_row["max_abs_err"], a_row["ok"]
        pm, pc, p_ok = moments_errors(torch, mean, cov, p_mean, p_cov)
        rm, rc, r_ok = moments_errors(torch, mean, cov, r_mean, r_cov)
        row = {"shape": name, "D": d, "M": m, "C": c, "mean_offset": offset,
               "launches": launches, "device_ops_per_call": device_ops,
               "repeat_bitwise": repeat_bitwise,
               "graph_replay_bitwise": replay_bitwise,
               "vs_plain": {"mean_max_abs_err": pm, "cov_max_abs_err": pc},
               "vs_f64_two_pass": {"mean_max_abs_err": rm, "cov_max_abs_err": rc},
               "plain_vs_f64_cov_max_abs_err":
                   moments_errors(torch, p_mean, p_cov, r_mean, r_cov)[1],
               "mean_tol": MEAN_TOL, "cov_rtol": COV_RTOL, "cov_atol": COV_ATOL,
               "apply_vs_plain": {"max_abs_err": a_err,
                                  "rtol": TOL, "atol": TOL, "ok": a_ok}}
        one_kernel = (len(device_ops) == 1
                      and any(n in device_ops[0] for n in MOMENTS_KERNELS))
        row["ok"] = (p_ok and r_ok and a_ok and launches == 1 and one_kernel
                     and repeat_bitwise and replay_bitwise is not False)
        parity.append(row)
        emit({"phase": "moments_parity", **row})
        if not row["ok"]:
            raise AssertionError(f"moments or apply kernel disagrees at {name}: {row}")
        if name not in train_shapes:
            continue
        row = {
            "shape": name, "D": d, "M": m, "C": c,
            "moments": {"per": f"one site: {d} domains, one launch",
                        **time_moments(torch, cw, x, rate)},
            "apply": {"per": f"one site: {d} domains, one launch",
                      **time_apply(torch, cw, x, mean, w, rate)},
        }
        timing[name] = row
        emit({"phase": "moments_timing", **row})
        del x
        torch.cuda.empty_cache()
    return parity, timing


# ------------------------------------------------------------------- train


def run_counted(torch, cw, run, phase):
    """Drive a train path: zero both kernels' launch counts, call
    ``run(logger)``, which trains through the loop with ``logger``; every
    record carries the counts at its emission.  Returns ``(result,
    records, launches over the run, seconds)``."""
    records = []

    def logger(kind, step, **fields):
        records.append({"kind": kind, "step": step,
                        "moments_launches": cw.moments_launches,
                        "apply_launches": cw.apply_launches, **fields})

    cw.moments_launches = cw.apply_launches = 0
    t0 = time.perf_counter()
    result = run(logger)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"moments": cw.moments_launches, "apply": cw.apply_launches}
    for r in records:
        emit({"phase": phase, **r})
    return result, records, launches, seconds


# Records logged where every launch before them is accounted for, in a
# harvested run: the ring is drained before each eval and collection pass.
ANCHOR_RECORDS = ("test", "final_test", "stat_collection")


def check_record_launches(records, launches, want, harvested=False):
    """Raise unless the launches between each record and the one before
    are ``want(record)`` (``{"moments": n, "apply": n}``) and no launch
    follows the last record.  The counts are launches made: a replay of a
    CUDA graph counts the launches its capture recorded, and the capture
    none.  ``harvested``: train records reach the logger through the
    harvest ring, after later steps launched, so the launches are checked
    at each record of ``ANCHOR_RECORDS`` against the sum of ``want`` over
    the records since the last check, and at the end."""
    prev = {"moments": 0, "apply": 0}
    owed = dict(prev)
    for r in records:
        owed = {k: owed[k] + want(r)[k] for k in owed}
        if harvested and r["kind"] not in ANCHOR_RECORDS:
            continue
        got = {k: r[f"{k}_launches"] - prev[k] for k in prev}
        prev = {k: r[f"{k}_launches"] for k in prev}
        if got != owed:
            raise AssertionError(f"{r['kind']} at step {r['step']}: launches "
                                 f"{got}, expected {owed}")
        owed = {k: 0 for k in owed}
    if {k: launches[k] - prev[k] for k in prev} != owed:
        raise AssertionError(f"launches after the last record: {launches} vs "
                             f"{prev} and {owed} owed")


# Records of the loops that launch no kernel: checkpoint bookkeeping and the
# run plane's records.
QUIET_RECORDS = ("checkpoint", "best", "resume", "init_ckpt", "params_digest",
                 "divergence", "rollback", "lr_backoff", "lr_recover", "skip_step",
                 "notice_save", "preempt", "heartbeat", "metrics_exporter", "alert_rules",
                 "alert", "accuracy_check")


def officehome_want(r, sites=None, recomputed=0):
    """The launches an OfficeHome record must follow (ResNet50-DWT): one
    moments and one apply launch per whitened site and train step (under
    ``--remat`` also ``recomputed`` of each, the checkpointed blocks'
    sites run again in the backward)."""
    n = r.get("forwards", 1)
    sites = WHITENED_SITES if sites is None else sites
    if r["kind"] in QUIET_RECORDS or r.get("skipped"):
        return {"moments": 0, "apply": 0}
    return {
        "train": {"moments": sites + recomputed, "apply": sites + recomputed},
        "stat_collection": {"moments": sites * n, "apply": sites * n},
        "test": {"moments": 0, "apply": sites * n},
        "final_test": {"moments": 0, "apply": sites * n},
    }[r["kind"]]


def expected_kinds(cfg):
    """The record sequence of ``run_officehome`` under ``cfg`` (at 0
    passes, one skipped collection record)."""
    kinds = []
    for it in range(cfg.num_iters):
        if it % cfg.log_interval == 0:
            kinds.append("train")
        if (it + 1) % cfg.check_acc_step == 0:
            kinds.append("test")
    passes = cfg.stat_collection_passes
    return kinds + ["stat_collection"] * (passes or 1) + ["final_test"]


class TimedBatches:
    """Replaces the trainer's ``prefetch_to_device`` for one run with a
    wrapper that stamps, per train step, the host clock when the loop
    asks for the step's batch and when it gets it.  With ``--log_interval
    1`` the loop reads every step's losses, so the time from one batch to
    the next is a step, the wait for its batch included."""

    def __init__(self, loop):
        self.loop = loop
        self.stamps = []  # (asked, got) per step

    def __enter__(self):
        inner = self.inner = self.loop.prefetch_to_device
        stamps = self.stamps

        def timed(*args, **kwargs):
            it = inner(*args, **kwargs)

            def gen():
                try:
                    while True:
                        asked = time.perf_counter()
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        stamps.append((asked, time.perf_counter()))
                        yield batch
                finally:
                    it.close()

            return gen()

        self.loop.prefetch_to_device = timed
        return self

    def __exit__(self, *exc):
        self.loop.prefetch_to_device = self.inner

    def summary(self):
        """Median step (batch to batch, the steps after the first; an eval
        between two steps lands in one interval and not in the median),
        and the mean wait for a batch of those steps and of the first."""
        import statistics

        got = [g for _, g in self.stamps]
        periods = [(b - a) * 1e3 for a, b in zip(got, got[1:])]
        waits = [(g - a) * 1e3 for a, g in self.stamps]
        return {"step_ms_median": statistics.median(periods) if periods else None,
                "step_ms_all": periods,
                "batch_wait_ms_mean": (statistics.fmean(waits[1:])
                                       if len(waits) > 1 else None),
                "batch_wait_ms_first": waits[0] if waits else None,
                "batch_wait_ms_max": max(waits[1:]) if len(waits) > 1 else None}


def train(torch, cw, officehome, loop, flags=TRAIN_FLAGS, phase="train",
          parser=None, sites=None):
    """A train path through the CLI entry (by default the main synthetic
    one; ``parser``: another entry's, e.g. VisDA's); returns the kernels'
    launches on it and its step timing.  ``sites``: the model's whitened
    sites, one moments and one apply launch each per step.  A run that
    harvests its records (``--harvest_depth`` above 0) has its launches
    checked at the evals and collections."""
    import math

    parser = parser or officehome.build_parser()
    sites = WHITENED_SITES if sites is None else sites
    cfg = officehome.config_from_args(parser.parse_args(flags))
    model = loop.build_model(cfg)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    with TimedBatches(loop) as timed:
        acc, records, launches, seconds = run_counted(
            torch, cw, lambda logger: loop.run_officehome(cfg, logger, model=model),
            f"{phase}_record")

    check_record_launches(records, launches,
                          functools.partial(officehome_want, sites=sites),
                          harvested=cfg.harvest_depth > 0)
    kinds = [r["kind"] for r in records if r["kind"] not in QUIET_RECORDS]
    if kinds != expected_kinds(cfg):
        raise AssertionError(f"unexpected record sequence {kinds}")
    for r in records:
        if r["kind"] == "train":
            bad = [k for k in ("loss", "cls_loss", "mec_loss", "grad_norm")
                   if not math.isfinite(r[k])]
            if bad:
                raise AssertionError(f"non-finite {bad} at step {r['step']}")
    final = [r for r in records if r["kind"] not in QUIET_RECORDS][-1]
    if not (math.isfinite(acc) and 0.0 <= acc <= 100.0 and acc == final["accuracy"]):
        raise AssertionError(f"bad accuracy {acc}")
    state = model.state_dict()
    unmoved = [k for k, p in model.named_parameters()
               if torch.equal(p.detach().cpu(), init[k])]
    covs = [k for k in state if k.endswith(".cov") or k == "dn1.cov"]
    cov_unmoved = [f"{k}[{d}]" for k in covs for d in range(state[k].shape[0])
                   if torch.equal(state[k][d].cpu(), torch.ones_like(init[k][d]))]
    timing = timed.summary()
    emit({"phase": phase, "flags": flags, "seconds": seconds,
          "accuracy": acc, "launches": launches,
          "whitening_sites": len(covs), "unmoved_params": unmoved,
          "unmoved_covs": cov_unmoved,
          "param_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
          "max_memory_allocated": torch.cuda.max_memory_allocated(), **timing})
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("parameters left float32")
    if unmoved or cov_unmoved or len(covs) != sites:
        raise AssertionError("training left parameters or stats unmoved")
    return launches, timing


def synthetic_batch(torch, loop, n, size, classes, seed, device):
    """One train batch (three streams) from the trainer's synthetic data."""
    shape = (size, size, 3)
    arrays = [loop._synthetic_classification_arrays(n, shape, classes, seed + i,
                                                    0.5 * (i > 0))
              for i in range(3)]
    to = lambda a: torch.from_numpy(a).to(device)
    return {"source_x": to(arrays[0][0]), "source_y": to(arrays[0][1]),
            "target_x": to(arrays[1][0]), "target_aug_x": to(arrays[2][0])}


def one_step(torch, cfg, model, batch, device):
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_officehome_train_step

    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    metrics = make_officehome_train_step(model, cfg.lambda_mec_loss)(
        state, {k: v.to(device) for k, v in batch.items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, model


def float64_model(torch, model):
    """``model`` in float64, for a reference step.  The card's float64
    convolutions return NCHW-contiguous activations (and so a ViT's patch
    embed strided tokens); a pre-hook on every norm site gives them the
    channels_last layout (tokens: contiguous) whose domain split is a view
    (``apply_domain_norm`` takes no other)."""
    from dwt_tpu_torch.nn.norms import DomainBatchNorm, DomainWhiten

    def channels_last(_site, args):
        x = args[0]
        if x.dim() == 3:
            return (x.contiguous(),)
        if x.dim() != 4:
            return None
        return (x.contiguous(memory_format=torch.channels_last),)

    for site in model.modules():
        if isinstance(site, (DomainWhiten, DomainBatchNorm)):
            site.register_forward_pre_hook(channels_last)
    return model.double()


def f32_ulp(torch, v):
    """The spacing of float32 values at ``v`` (a float64 tensor)."""
    a = v.float().abs()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


def compare_steps(torch, a, b, init):
    """Two train steps from the same ``init`` state, ``b`` the reference.

    Relative errors of the metrics and of every running stat (max |a − b|
    / max |b| per stat tensor, the worst in ``stats``), and per parameter
    (``by_leaf``), with the worst leaf of each in ``*_worst``:

    * ``grad``: ‖g_a − g_b‖ / ‖g_b‖ of the step's gradient (the optimizer
      keeps it in ``.grad``);
    * ``update``: ‖Δa − Δb‖ / ‖Δb‖ with Δ = post − pre, as stored;
    * ``update_beyond_rounding``: the same after forgiving each element
      one float32 spacing of its stored value, ‖max(|a − b| − ulp, 0)‖ /
      ‖Δb‖.  A step moves a norm's γ ≈ 1 by ~1e-6 at the backbone's lr,
      and storing γ + Δ in float32 rounds Δ by up to 6e-8: percent of Δ
      that no computation of the step can remove.

    ``update`` and ``grad`` are also given over all parameters at once.
    """
    (ma, model_a), (mb, model_b) = a, b
    out = {k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
           for k in STEP_METRICS if k in mb}
    sa, sb = model_a.state_dict(), model_b.state_dict()
    grads_a = {k: p.grad for k, p in model_a.named_parameters()}
    grads_b = {k: p.grad for k, p in model_b.named_parameters()}
    sums = {"update": [0.0, 0.0], "grad": [0.0, 0.0]}
    worst = (0.0, "")
    leaves = {}
    for k, ref in sb.items():
        ref, got = ref.detach().double().cpu(), sa[k].detach().double().cpu()
        if k not in grads_b:
            err = float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))
            worst = max(worst, (err, k))
            continue
        step = float((ref - init[k].double()).norm())
        diff = (got - ref).abs()
        ga, gb = grads_a[k].double().cpu(), grads_b[k].double().cpu()
        g_diff, g_norm = float((ga - gb).norm()), float(gb.norm())
        leaves[k] = {
            "update": float(diff.norm()) / max(step, 1e-300),
            "update_beyond_rounding": float(
                (diff - f32_ulp(torch, ref)).clamp_min(0).norm()) / max(step, 1e-300),
            "grad": g_diff / max(g_norm, 1e-300),
        }
        sums["update"][0] += float(diff.square().sum())
        sums["update"][1] += step ** 2
        sums["grad"][0] += g_diff ** 2
        sums["grad"][1] += g_norm ** 2
    out["stats"], out["stats_worst"] = worst
    for key, (num, den) in sums.items():
        out[key] = (num / den) ** 0.5
    for key in ("update", "update_beyond_rounding", "grad"):
        leaf = max(leaves, key=lambda k: leaves[k][key])
        out[f"{key}_worst"] = {"leaf": leaf, "err": leaves[leaf][key]}
    out["by_leaf"] = leaves
    return out


def leaf_summary(errs):
    """``compare_steps``'s result without its per-leaf table."""
    return {k: v for k, v in errs.items() if k != "by_leaf"}


def checked_worst(errs, skip=()):
    """The largest per-leaf readings that ``check_step`` holds to a limit:
    per part (``head``: ``fc_out.*``; ``backbone``: the rest) and key, the
    worst leaf outside ``skip`` and its error."""
    out = {}
    for leaf, e in errs["by_leaf"].items():
        if leaf in skip:
            continue
        part = out.setdefault("head" if leaf.startswith("fc_out.") else "backbone", {})
        for key in ("grad", "update_beyond_rounding"):
            if key not in part or e[key] > part[key]["err"]:
                part[key] = {"err": e[key], "leaf": leaf}
    return out


def check_step(name, errs, leaf_tol, head_tol=None, skip=()):
    """Raise unless the metrics and stats are within ``TRAIN_TOL`` (the
    grad norm ``TRAIN_GRAD_TOL``) and every parameter's gradient and
    update (beyond rounding) within ``leaf_tol`` — the head's
    (``fc_out.*``) within ``head_tol`` when given; the leaves in ``skip``
    are checked by the caller."""
    tols = {"grad_norm": TRAIN_GRAD_TOL}
    bad = {k: errs[k] for k in (*STEP_METRICS, "stats")
           if k in errs and errs[k] > tols.get(k, TRAIN_TOL)}
    for leaf, e in errs["by_leaf"].items():
        if leaf in skip:
            continue
        tol = head_tol if head_tol is not None and leaf.startswith("fc_out.") else leaf_tol
        for key in ("grad", "update_beyond_rounding"):
            if e[key] > tol:
                bad[f"{leaf} {key}"] = e[key]
    if bad:
        worst = sorted(bad.items(), key=lambda kv: -kv[1])[:8]
        raise AssertionError(f"{name}: {len(bad)} errors over their limits; "
                             f"the largest: {worst}")


def reference_steps(torch, cw, loop, cfg, batch, device, zero_leaves=()):
    """One train step of ``cfg``'s fresh model through the kernels, the
    same step with both kernels swapped for their plain versions, and a
    float64 step of the plain versions, all on the card, from the same
    weights and batch: ``(kernel vs plain, kernel vs float64, plain vs
    float64, the kernel step's (moments, apply) launches, noise)``;
    ``noise``: per step, the ``noise_share`` of ``zero_leaves`` (leaves
    whose exact gradient is zero), ``{}`` without any."""
    base = loop.build_model(cfg)
    init = {k: v.detach().clone() for k, v in base.state_dict().items()}
    kernels = (cw.whiten_moments, cw.whiten_apply)
    before = (cw.moments_launches, cw.apply_launches)
    kernel_step = one_step(torch, cfg, copy.deepcopy(base), batch, device)
    kernel_launches = (cw.moments_launches - before[0],
                       cw.apply_launches - before[1])
    cw.whiten_moments, cw.whiten_apply = cw.whiten_moments_plain, cw.whiten_apply_plain
    try:
        plain_step = one_step(torch, cfg, copy.deepcopy(base), batch, device)
        f64_step = one_step(torch, cfg, float64_model(torch, base), {
            k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}, device)
    finally:
        cw.whiten_moments, cw.whiten_apply = kernels
    vs_plain = compare_steps(torch, kernel_step, plain_step, init)
    vs_f64 = compare_steps(torch, kernel_step, f64_step, init)
    plain_vs_f64 = compare_steps(torch, plain_step, f64_step, init)
    noise = {name: noise_share(torch, st, zero_leaves) for name, st in (
        ("kernels", kernel_step), ("plain", plain_step), ("float64", f64_step))
        } if zero_leaves else {}
    del kernel_step, plain_step, f64_step, base
    torch.cuda.empty_cache()
    return vs_plain, vs_f64, plain_vs_f64, kernel_launches, noise


def train_reference(torch, cw, loop, device):
    from dwt_tpu_torch.config import OfficeHomeConfig

    # Kernels vs their plain versions, both on the card, ResNet50 at 224².
    n, size = REFERENCE_STEP
    cfg = OfficeHomeConfig(seed=2, img_crop_size=size, source_batch_size=n)
    batch = synthetic_batch(torch, loop, n, size, 65, 5, device)
    vs_plain, vs_f64, plain_vs_f64, kernel_launches, _ = reference_steps(
        torch, cw, loop, cfg, batch, device)

    # The tiny model's step on the card vs on the CPU (8 images per
    # stream: fewer make its stage-4 BN ill-conditioned).
    tiny = OfficeHomeConfig(arch="tiny", num_classes=5, img_crop_size=32, seed=3)
    batch = synthetic_batch(torch, loop, 8, 32, 5, 7, torch.device("cpu"))
    base = loop.build_model(tiny)
    init = {k: v.detach().clone() for k, v in base.state_dict().items()}
    card = one_step(torch, tiny, copy.deepcopy(base), batch, device)
    cpu = one_step(torch, tiny, base, batch, torch.device("cpu"))
    vs_cpu = compare_steps(torch, card, cpu, init)
    emit({"phase": "train_reference",
          "kernel_vs_plain_resnet50": leaf_summary(vs_plain),
          "kernel_vs_f64_resnet50": leaf_summary(vs_f64),
          "plain_vs_f64_resnet50": leaf_summary(plain_vs_f64),
          "kernel_launches": kernel_launches,
          "card_vs_cpu_tiny": leaf_summary(vs_cpu),
          "tolerance": TRAIN_TOL, "grad_tolerance": TRAIN_GRAD_TOL,
          "resnet50_leaf_tolerance": dict(zip(("backbone", "head"), RESNET50_LEAF_TOL)),
          "f64_ratio_tolerance": F64_RATIO_TOL,
          "tiny_leaf_tolerance": TINY_LEAF_TOL,
          "why": "sums in other orders (kernel vs plain, f32 vs float64, "
                 "card vs CPU); each stored parameter's own float32 "
                 "rounding is forgiven"})
    if kernel_launches != (WHITENED_SITES, WHITENED_SITES):
        raise AssertionError(f"kernel step launched {kernel_launches}")
    for what, errs in (("kernels vs plain", vs_plain), ("kernels vs float64", vs_f64)):
        check_step(f"{what} (ResNet50)", errs, *RESNET50_LEAF_TOL)
    if vs_f64["grad"] > F64_RATIO_TOL * plain_vs_f64["grad"]:
        raise AssertionError(
            f"the kernel step's gradient is {vs_f64['grad']} from float64, "
            f"over {F64_RATIO_TOL} times the plain step's {plain_vs_f64['grad']}")
    check_step("card vs CPU (tiny)", vs_cpu, TINY_LEAF_TOL)


def train_throughput(torch, loop, device):
    from dwt_tpu_torch.config import OfficeHomeConfig
    from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import (
        eval_counters,
        make_accum_eval_step,
        make_officehome_train_step,
        make_stat_collection_step,
    )

    n, size = REFERENCE_STEP
    cfg = OfficeHomeConfig(seed=4, img_crop_size=size, source_batch_size=n)
    model = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    step = make_officehome_train_step(model, cfg.lambda_mec_loss)
    batch = synthetic_batch(torch, loop, n, size, 65, 11, device)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: step(state, batch), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    x = batch["target_x"][: cfg.test_batch_size]
    y = batch["source_y"][: cfg.test_batch_size]
    mask = torch.ones_like(y, dtype=torch.bool)
    collect = make_stat_collection_step(model, 3)
    collect_ms = cuda_ms(torch, lambda: collect(state, x), iters=5, warmup=1)
    install_whiten_cache(model, make_whiten_cache(model))
    accum = make_accum_eval_step(model)
    counters = eval_counters(device)
    eval_ms = cuda_ms(torch, lambda: accum(counters, {"x": x[None], "y": y[None], "mask": mask[None]}), iters=5, warmup=1)
    install_whiten_cache(model, None)
    images = 3 * cfg.source_batch_size
    row = {"phase": "train_throughput", "images_per_step": images,
           "step_ms": step_ms, "imgs_per_s": images / step_ms * 1e3,
           "stat_collection_forward_ms": collect_ms,
           "eval_forward_ms": eval_ms, "test_batch": cfg.test_batch_size,
           "max_memory_allocated": peak}
    emit(row)
    del model, optimizer, state, batch
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------- the folder path


def folder_flags(root):
    return ["--s_dset_path", os.path.join(root, FOLDER_DOMAINS[0]),
            "--t_dset_path", os.path.join(root, FOLDER_DOMAINS[1]),
            *FOLDER_TRAIN_FLAGS]


def write_folders(root):
    """The two OfficeHome-shaped folders: smooth random images (a coarse
    6×6 draw resized bilinear, plus N(0, 8) noise), all from seed 1.
    Returns the JPEG bytes written."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(1)
    written = 0
    for domain in FOLDER_DOMAINS:
        for k in range(FOLDER_CLASSES):
            d = os.path.join(root, domain, f"class_{k:02d}")
            os.makedirs(d)
            for i in range(FOLDER_PER_CLASS):
                w, h = (int(v) for v in rng.integers(FOLDER_SIDES[0],
                                                     FOLDER_SIDES[1] + 1, size=2))
                coarse = rng.integers(0, 256, size=(6, 6, 3), dtype=np.uint8)
                img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR),
                                 np.float32) + rng.normal(0, 8, size=(h, w, 3))
                path = os.path.join(d, f"{i}.jpg")
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    path, quality=90)
                written += os.path.getsize(path)
    return written


class Indexed:
    """A dataset whose items carry their index as a last field, so that a
    batch names the items it holds."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return (*self.dataset[i], i)


def same_batches(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.asarray(u).dtype == np.asarray(v).dtype
                                 and np.array_equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


def data_plane(torch, officehome, loop, device, root):
    """The data plane on the folders: the streams' batch ids against the
    seekable sampler, a stream opened at cursor 4 against the suffix of
    one opened at 0, 1 against 4 loader threads, a prefetched batch on the
    card against its numpy source (all bitwise); then images per second of
    each stream per thread count and the host-to-device time of a batch."""
    import numpy as np

    from dwt_tpu_torch.data.loader import prefetch_to_device
    from dwt_tpu_torch.data.sampler import SeekableSampler

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        folder_flags(root)))
    source_ds, target_ds, _ = loop._officehome_datasets(cfg)
    bs = cfg.source_batch_size
    data = {"source": Indexed(source_ds), "target": Indexed(target_ds)}
    plane = loop.officehome_plane(cfg, source_ds, target_ds)
    steps = 12  # crosses the epoch boundary at 10
    whole = {}
    for role, ds in data.items():
        pos = plane.streams[role]
        stream = plane.stream(ds, role, bs)
        whole[role] = [next(stream) for _ in range(steps)]
        stream.close()
        order = np.concatenate([SeekableSampler(len(ds), pos.seed, e).positions()[
            : pos.epoch_len * bs] for e in range(2)])
        ids = [b[-1].tolist() for b in whole[role]]
        if ids != [order[k * bs:(k + 1) * bs].tolist() for k in range(steps)]:
            raise AssertionError(f"{role} batch ids differ from the sampler's")
    resumed = loop.officehome_plane(cfg, source_ds, target_ds)
    resumed.seek_step(4)
    stream = resumed.stream(data["target"], "target", bs)
    suffix = [next(stream) for _ in range(steps - 4)]
    stream.close()
    if not same_batches(suffix, whole["target"][4:]):
        raise AssertionError("a stream opened at cursor 4 is not the suffix")
    one = loop.officehome_plane(cfg, source_ds, target_ds)
    one.num_workers = 1
    stream = one.stream(data["target"], "target", bs)
    single = [next(stream) for _ in range(3)]
    stream.close()
    if not same_batches(single, whole["target"][:3]):
        raise AssertionError("1 and 4 loader threads give other batches")
    host = list(loop.officehome_batches(
        loop.officehome_plane(cfg, source_ds, target_ds), source_ds, target_ds,
        bs, 2))
    staged = list(prefetch_to_device(iter(host), device=device))
    torch.cuda.synchronize()
    for a, b in zip(staged, host):
        if not all(a[k].device == device and np.array_equal(a[k].cpu().numpy(), v)
                   for k, v in b.items()):
            raise AssertionError("a prefetched batch differs from its source")

    rates = {}
    epoch = 2
    for workers in WORKER_COUNTS:
        plane.num_workers = workers
        for role, ds in data.items():
            epoch += 1
            t0 = time.perf_counter()
            it = plane.epoch_iterator(ds, role, bs, epoch=epoch, start_batch=0)
            for _ in range(RATE_BATCHES):
                next(it)
            seconds = time.perf_counter() - t0
            it.close()
            views = 2 if role == "target" else 1
            rates[f"{role}_w{workers}"] = {
                "items_per_s": RATE_BATCHES * bs / seconds,
                "images_per_s": RATE_BATCHES * bs * views / seconds}
    # Host-to-device: the batch's bytes from pinned memory on a side stream
    # (CUDA events), and a batch through prefetch_to_device from numpy
    # (host copy into the pinned ring included; wall clock).
    batch = host[0]
    nbytes = sum(v.nbytes for v in batch.values())
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
    dev = {k: torch.empty_like(v, device=device) for k, v in pinned.items()}
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        h2d_ms = cuda_ms(torch, lambda: [dev[k].copy_(v, non_blocking=True)
                                         for k, v in pinned.items()], iters=10, warmup=2)
    reps = 10
    t0 = time.perf_counter()
    for b in prefetch_to_device(iter([batch] * reps), device=device):
        pass
    torch.cuda.synchronize()
    prefetch_ms = (time.perf_counter() - t0) / reps * 1e3
    row = {"phase": "data_plane", "images": {r: len(d) for r, d in data.items()},
           "epoch_len": {r: plane.streams[r].epoch_len for r in data},
           "ids_checked_batches": steps, "suffix_from_cursor": 4,
           "workers_compared": [1, cfg.num_workers], "rates": rates,
           "batch_bytes": nbytes, "h2d_ms_per_batch": h2d_ms,
           "h2d_GBps": nbytes / h2d_ms / 1e6,
           "prefetch_ms_per_batch_wall": prefetch_ms,
           "cpu_count": os.cpu_count()}
    emit(row)
    return row


def folder_profile(torch, officehome, loop, device, root, step_ms):
    """The card's idle share over ``PROFILED_STEPS`` folder steps (after 2
    warm-up steps): device busy time in a profiler trace against the
    traced span, and against the unprofiled step ``step_ms``."""
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_officehome_train_step

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        folder_flags(root)))
    source_ds, target_ds, _ = loop._officehome_datasets(cfg)
    plane = loop.officehome_plane(cfg, source_ds, target_ds)
    model = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    step = make_officehome_train_step(model, cfg.lambda_mec_loss)
    produce = loop.officehome_batches(plane, source_ds, target_ds,
                                      cfg.source_batch_size, 2 + 3 * PROFILED_STEPS)
    batches = loop.prefetch_to_device(produce, device=device)

    def one():
        step(state, next(batches))
        plane.advance(1)

    try:
        for _ in range(2):
            one()
        events = trace_events(torch, one, iters=PROFILED_STEPS)
    finally:
        batches.close()
        produce.close()
    busy = busy_ms(events) / PROFILED_STEPS
    span_ms = (max(ev["ts"] + ev["dur"] for ev in events)
               - min(ev["ts"] for ev in events)) / 1e3 / PROFILED_STEPS
    row = {"phase": "folder_profile", "steps": PROFILED_STEPS,
           "device_ops_per_step": len(events) / PROFILED_STEPS,
           "device_busy_ms_per_step": busy,
           "profiled_span_ms_per_step": span_ms,
           "idle_share_in_profile": 1.0 - busy / span_ms,
           "idle_share": 1.0 - busy / step_ms}
    emit(row)
    del model, optimizer, state
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------------ digits


def check_digits_kernels(torch, cw, device, rate):
    """Both kernels at LeNet-DWT's two whitened sites (``dn1`` C = 32, ``dn2``
    C = 48, groups of 4): parity with the plain versions (the moments also
    with a float64 two-pass reference) and times, L2 cold, at the train
    shapes (``[2, M, C]``, 32 images per stream; the apply in one launch
    for both domains, also at D = 1 and at ragged M), the eval shapes
    (test batch 100) and the serve shapes of buckets 1 and 128."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    gen = torch.Generator(device=device).manual_seed(2)
    cpu_gen = torch.Generator().manual_seed(2)
    apply_errs, moments_errs, timing = {}, {}, {}
    for site, c, hw in DIGITS_SITES:
        m = DIGITS_STREAM * hw
        x = moments_input(torch, 2, m, c, gen, device)
        before = cw.moments_launches
        mean, cov = cw.whiten_moments(x, 4)
        launches = cw.moments_launches - before
        again = cw.whiten_moments(x, 4)
        torch.cuda.synchronize()
        repeat_bitwise = torch.equal(again[0], mean) and torch.equal(again[1], cov)
        pm, pc, p_ok = moments_errors(torch, mean, cov, *cw.whiten_moments_plain(x, 4))
        rm, rc, r_ok = moments_errors(torch, mean, cov, *two_pass_f64(torch, x))
        w = whitening_matrix(_shrink(cov, 1e-3))
        a_row = apply_parity(torch, cw, f"train_{site}", x, mean, w, full=True)
        moments_errs[site] = max(pm, pc)
        apply_errs[("train", site)] = a_row["max_abs_err"]
        row = {"shape": f"train_{site}", "D": 2, "M": m, "C": c,
               "launches": launches, "repeat_bitwise": repeat_bitwise,
               "vs_plain": {"mean_max_abs_err": pm, "cov_max_abs_err": pc},
               "vs_f64_two_pass": {"mean_max_abs_err": rm, "cov_max_abs_err": rc},
               "mean_tol": MEAN_TOL, "cov_rtol": COV_RTOL, "cov_atol": COV_ATOL,
               "apply_vs_plain": a_row,
               "ok": (p_ok and r_ok and a_row["ok"] and launches == 1
                      and repeat_bitwise)}
        emit({"phase": "digits_parity", **row})
        if not row["ok"]:
            raise AssertionError(f"digits kernels disagree at train_{site}: {row}")
        timing[("train", site)] = {"moments": time_moments(torch, cw, x, rate),
                                   "apply": time_apply(torch, cw, x, mean, w, rate)}
        emit({"phase": "digits_timing", "shape": f"train_{site}",
              **timing[("train", site)]})
        del x, again
        # The batched apply at one domain and at ragged M.
        for d, rows in ((1, m), *((2, r) for r in APPLY_RAGGED_M)):
            name = f"train_d{d}_m{rows}_{site}"
            a_row = apply_parity(torch, cw, name,
                                 *site_inputs(torch, rows, c, gen, cpu_gen, device, d))
            apply_errs[("train", name)] = a_row["max_abs_err"]
            emit({"phase": "digits_parity", **a_row})
            if not a_row["ok"]:
                raise AssertionError(f"apply kernel disagrees at {name}: {a_row}")
        for path, n in DIGITS_APPLY_BATCHES:
            xa, ma, wa = site_inputs(torch, n * hw, c, gen, cpu_gen, device)
            a_row = apply_parity(torch, cw, f"{path}_{site}", xa, ma, wa)
            apply_errs[(path, site)] = a_row["max_abs_err"]
            emit({"phase": "digits_parity", **a_row})
            if not a_row["ok"]:
                raise AssertionError(f"apply kernel disagrees at {path}_{site}")
            timing[(path, site)] = {"apply": time_apply(torch, cw, xa, ma, wa, rate)}
            emit({"phase": "digits_timing", "shape": f"{path}_{site}",
                  **timing[(path, site)]})
        torch.cuda.empty_cache()
    return apply_errs, moments_errs, timing


def digits_want(r):
    """The launches a digits record must follow (LeNet-DWT)."""
    sites = len(DIGITS_SITES)
    if r["kind"] in QUIET_RECORDS:
        return {"moments": 0, "apply": 0}
    return {
        "train": {"moments": sites, "apply": sites},
        "test": {"moments": 0, "apply": sites * r.get("forwards", 0)},
    }[r["kind"]]


def digits_train(torch, cw, usps_mnist, loop, flags=DIGITS_TRAIN_FLAGS,
                 phase="digits_train"):
    """The digits main path, through the trainer's CLI entry (by default
    the f32 Cholesky one): LeNet-DWT, 32 images per stream, 2 epochs of 8
    steps, an eval after each; returns the kernels' launches on it."""
    import math

    cfg = usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(flags))
    model = loop.build_digits_model(cfg)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    acc, records, launches, seconds = run_counted(
        torch, cw, lambda logger: loop.run_digits(cfg, logger, model=model),
        f"{phase}_record")
    check_record_launches(records, launches, digits_want)
    kinds = [r["kind"] for r in records]
    if kinds != (["train"] * 8 + ["test"]) * 2 + ["params_digest"]:
        raise AssertionError(f"unexpected record sequence {kinds}")
    for r in records:
        if r["kind"] == "train":
            bad = [k for k in ("loss", "cls_loss", "entropy_loss", "grad_norm")
                   if not math.isfinite(r[k])]
            if bad:
                raise AssertionError(f"non-finite {bad} at step {r['step']}")
        elif r["kind"] == "test" and (r["forwards"] != 2 or r["count"] != 128):
            raise AssertionError(f"eval of {r['count']} images in {r['forwards']} "
                                 "forwards, not 128 in 2")
    if not (math.isfinite(acc) and 0.0 <= acc <= 100.0
            and acc == records[-2]["accuracy"]):
        raise AssertionError(f"bad accuracy {acc}")
    state = model.state_dict()
    unmoved = [k for k, p in model.named_parameters()
               if torch.equal(p.detach().cpu(), init[k])]
    cov_unmoved = [f"{site}.cov[{d}]" for site, _, _ in DIGITS_SITES for d in range(2)
                   if torch.equal(state[f"{site}.cov"][d].cpu(), init[f"{site}.cov"][d])]
    emit({"phase": phase, "flags": flags, "seconds": seconds,
          "accuracy": acc, "launches": launches, "unmoved_params": unmoved,
          "unmoved_covs": cov_unmoved})
    if unmoved or cov_unmoved:
        raise AssertionError("training left parameters or stats unmoved")
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("parameters left float32")
    return launches, acc


def digits_batch(torch, loop, seed, device, dtype=None):
    """One digits train batch (two streams of ``DIGITS_STREAM`` images) from
    the trainer's synthetic data."""
    arrays = [loop._synthetic_classification_arrays(
        DIGITS_STREAM, (28, 28, 1), 10, seed + i, 0.5 * i) for i in range(2)]
    to = lambda a: torch.from_numpy(a).to(device)
    batch = {"source_x": to(arrays[0][0]), "source_y": to(arrays[0][1]),
             "target_x": to(arrays[1][0])}
    if dtype is not None:
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
    return batch


def digits_step(torch, cfg, model, batch, device):
    """One digits train step of ``model`` on ``device``; returns its
    metrics as floats and the model (its ``.grad`` the step's gradient)."""
    from dwt_tpu_torch.train.optim import digits_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_digits_train_step

    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, cfg, DIGITS_STEPS_PER_EPOCH)
    state = TrainState(model, optimizer, schedules)
    metrics = make_digits_train_step(model, cfg.lambda_entropy_loss)(
        state, {k: v.to(device) for k, v in batch.items()})
    torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, model


def noise_share(torch, step, leaves=DIGITS_NORMALIZED_BIASES):
    """The largest gradient of ``leaves`` (parameters whose exact gradient
    is zero, e.g. the biases that feed a normalization site), relative to
    the step's gradient norm."""
    metrics, model = step
    grads = dict((k, p.grad) for k, p in model.named_parameters())
    return max(float(grads[k].norm()) for k in leaves) / metrics["grad_norm"]


def digits_reference(torch, cw, loop, device):
    """One LeNet-DWT step through the kernels against the same step with
    both kernels swapped for their plain versions and against a float64
    step of the plain versions, all on the card, from the same weights and
    batch (tolerances and their readings at ``DIGITS_LEAF_TOL``)."""
    from dwt_tpu_torch.config import DigitsConfig

    cfg = DigitsConfig(seed=2, group_size=4)
    batch = digits_batch(torch, loop, 5, device)
    base = loop.build_digits_model(cfg)
    init = {k: v.detach().clone() for k, v in base.state_dict().items()}
    kernels = (cw.whiten_moments, cw.whiten_apply)
    before = (cw.moments_launches, cw.apply_launches)
    kernel_step = digits_step(torch, cfg, copy.deepcopy(base), batch, device)
    launches = (cw.moments_launches - before[0], cw.apply_launches - before[1])
    cw.whiten_moments, cw.whiten_apply = cw.whiten_moments_plain, cw.whiten_apply_plain
    try:
        plain_step = digits_step(torch, cfg, copy.deepcopy(base), batch, device)
        f64_step = digits_step(torch, cfg, float64_model(torch, base),
                               digits_batch(torch, loop, 5, device, torch.float64),
                               device)
    finally:
        cw.whiten_moments, cw.whiten_apply = kernels
    vs_plain = compare_steps(torch, kernel_step, plain_step, init)
    vs_f64 = compare_steps(torch, kernel_step, f64_step, init)
    plain_vs_f64 = compare_steps(torch, plain_step, f64_step, init)
    noise = {name: noise_share(torch, st) for name, st in (
        ("kernel", kernel_step), ("plain", plain_step), ("float64", f64_step))}
    emit({"phase": "digits_reference",
          "kernel_vs_plain": leaf_summary(vs_plain),
          "kernel_vs_f64": leaf_summary(vs_f64),
          "plain_vs_f64": leaf_summary(plain_vs_f64),
          "kernel_launches": launches,
          "normalized_bias_grad_share": noise,
          "tolerance": TRAIN_TOL, "grad_tolerance": TRAIN_GRAD_TOL,
          "leaf_tolerance": DIGITS_LEAF_TOL, "f64_ratio_tolerance": F64_RATIO_TOL,
          "noise_tolerance": DIGITS_NOISE_TOL,
          "by_leaf_kernel_vs_f64": vs_f64["by_leaf"]})
    if launches != (len(DIGITS_SITES), len(DIGITS_SITES)):
        raise AssertionError(f"kernel step launched {launches}")
    for what, errs in (("kernels vs plain", vs_plain), ("kernels vs float64", vs_f64)):
        check_step(f"{what} (LeNet-DWT)", errs, DIGITS_LEAF_TOL,
                   skip=DIGITS_NORMALIZED_BIASES)
    if vs_f64["grad"] > F64_RATIO_TOL * plain_vs_f64["grad"]:
        raise AssertionError(
            f"the kernel step's gradient is {vs_f64['grad']} from float64, "
            f"over {F64_RATIO_TOL} times the plain step's {plain_vs_f64['grad']}")
    if max(noise.values()) > DIGITS_NOISE_TOL:
        raise AssertionError(f"normalized biases' gradients are not noise: {noise}")


def digits_throughput(torch, loop, device):
    """Steady-state LeNet-DWT train step and eval forward; the card's idle
    share from a profiled window of steps."""
    from dwt_tpu_torch.config import DigitsConfig
    from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
    from dwt_tpu_torch.train.optim import digits_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import (
        eval_counters,
        make_accum_eval_step,
        make_digits_train_step,
    )

    cfg = DigitsConfig(seed=4, group_size=4)
    model = loop.build_digits_model(cfg).to(device, memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, cfg, DIGITS_STEPS_PER_EPOCH)
    state = TrainState(model, optimizer, schedules)
    step = make_digits_train_step(model, cfg.lambda_entropy_loss)
    batch = digits_batch(torch, loop, 11, device)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: step(state, batch), iters=20, warmup=3)
    peak = torch.cuda.max_memory_allocated()
    window = 5
    traced = trace_events(torch, lambda: step(state, batch), iters=window,
                          cats=DEVICE_CATS + ("cpu_op", "cuda_runtime"))
    events = [ev for ev in traced if ev["cat"] in DEVICE_CATS]
    busy = busy_ms(events) / window
    span_ms = (max(ev["ts"] + ev["dur"] for ev in events)
               - min(ev["ts"] for ev in events)) / 1e3 / window
    # Where the host's time goes: the outermost PyTorch operators by host
    # time (profiled, so stretched), and the runtime calls that wait.
    host, ends = {}, {}
    for ev in sorted((ev for ev in traced if ev["cat"] == "cpu_op"),
                     key=lambda ev: (ev.get("tid"), ev["ts"], -ev["dur"])):
        if ev["ts"] >= ends.get(ev.get("tid"), float("-inf")):
            ends[ev.get("tid")] = ev["ts"] + ev["dur"]
            host[ev["name"]] = host.get(ev["name"], 0.0) + ev["dur"] / 1e3 / window
    syncs = [ev["name"] for ev in traced if ev["cat"] == "cuda_runtime"
             and "ynchronize" in ev["name"]]
    by_kernel = {}
    for ev in events:
        name = ev["name"][:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + ev["dur"] / 1e3 / window
    x = torch.cat([batch["target_x"]] * 4)[: cfg.test_batch_size]
    y = torch.cat([batch["source_y"]] * 4)[: cfg.test_batch_size]
    mask = torch.ones_like(y, dtype=torch.bool)
    install_whiten_cache(model, make_whiten_cache(model))
    accum = make_accum_eval_step(model)
    counters = eval_counters(device)
    eval_ms = cuda_ms(torch, lambda: accum(counters, {"x": x[None], "y": y[None], "mask": mask[None]}), iters=20, warmup=2)
    install_whiten_cache(model, None)
    images = 2 * DIGITS_STREAM
    row = {"phase": "digits_throughput", "images_per_step": images,
           "step_ms": step_ms, "imgs_per_s": images / step_ms * 1e3,
           "device_ops_per_step": len(events) / window,
           "device_busy_ms_per_step": busy,
           "idle_share": 1.0 - busy / step_ms,
           "profiled_span_ms_per_step": span_ms,
           "idle_share_in_profile": 1.0 - busy / span_ms,
           "host_top_ops_ms_per_step_profiled": dict(sorted(
               host.items(), key=lambda kv: -kv[1])[:12]),
           "device_top_ms_per_step": dict(sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:12]),
           "host_syncs_per_step": len(syncs) / window,
           "host_sync_calls": sorted(set(syncs)),
           "eval_forward_ms": eval_ms, "test_batch": cfg.test_batch_size,
           "max_memory_allocated": peak}
    emit(row)
    return row


# -------------------------------------------------------------- checkpoints


class BatchIds:
    """For one run, the dataset ids of every batch the data plane's train
    streams build, by stream role (a cut run's prefetch thread may have
    built a few it never trained on)."""

    def __init__(self, loader):
        self.loader, self.ids = loader, {}

    def __enter__(self):
        inner = self.inner = self.loader.batch_iterator
        ids = self.ids

        def recording(*args, **kwargs):
            role = kwargs.get("quarantine_key")
            kwargs.pop("on_batch_ids", None)  # the plane's trail hook (off)
            return inner(*args, on_batch_ids=ids.setdefault(role, []).append,
                         **kwargs)

        self.loader.batch_iterator = recording
        return self

    def __exit__(self, *exc):
        self.loader.batch_iterator = self.inner


class Cut(Exception):
    """Raised by a run's logger to end the run where a crash would."""


def counted_run(torch, cw, loader, run, cfg, phase, want, cut_at=None):
    """``run(cfg, logger)`` (a trainer loop) through ``run_counted``, its
    launches checked record by record against ``want`` (at the anchors
    when the run harvests its records); with ``cut_at`` the logger raises
    ``Cut`` after that step's train record, ending the run.  Returns
    ``(records, launches, batch ids by stream)``."""
    def drive(logger):
        def cutting(kind, step, **fields):
            logger(kind, step, **fields)
            if kind == "train" and step == cut_at:
                raise Cut
        try:
            run(cfg, cutting)
        except Cut:
            return "cut"
        return "ended"

    with BatchIds(loader) as ids:
        how, records, launches, _ = run_counted(torch, cw, drive, phase)
    if how != ("cut" if cut_at else "ended"):
        raise AssertionError(f"{phase}: the run {how}, cut_at={cut_at}")
    check_record_launches(records, launches, want, harvested=cfg.harvest_depth > 0)
    return records, launches, ids.ids


def added(*launches):
    return {k: sum(l[k] for l in launches) for k in launches[0]}


def record_errs(a, b, steps):
    """Relative errors of run ``b``'s records against ``a``'s: the train
    losses at ``steps``, and the eval losses of the last test record (and
    the final test, where there is one)."""
    def rel(x, y):
        return abs(x - y) / abs(y) if y else abs(x - y)

    def pick(records, kind):
        return {r["step"]: r for r in records if r["kind"] == kind}

    ta, tb = pick(a, "train"), pick(b, "train")
    train = max(rel(tb[s][k], ta[s][k]) for s in steps for k in STEP_METRICS
                if k in ta[s])
    evals = [max(pick(a, "test").items())[1], max(pick(b, "test").items())[1]]
    finals = [[r for r in recs if r["kind"] == "final_test"] for recs in (a, b)]
    if finals[0]:
        evals += [finals[0][0], finals[1][0]]
    return {"train_loss": train,
            "eval_loss": max(rel(evals[i + 1]["loss"], evals[i]["loss"])
                             for i in range(0, len(evals), 2)),
            "accuracies": [r["accuracy"] for r in evals]}


def state_errs(torch, model, a_dir, b_dir):
    """The final artifacts of two runs (either format), tensor by tensor:
    the largest relative error of a parameter and of a running stat, and
    whether the BN counts and the optimizer's steps agree."""
    from dwt_tpu_torch.utils import checkpoint as ckpt

    def load(d):
        return ckpt.read_payload(os.path.join(d, str(ckpt.latest_step(d))))[0]

    a, b = load(a_dir), load(b_dir)
    params = {n for n, _ in model.named_parameters()}
    errs = {"params": 0.0, "stats": 0.0}
    exact = a["step"] == b["step"]
    for k, va in a["model"].items():
        vb = b["model"][k]
        if not va.is_floating_point():
            exact = exact and torch.equal(va, vb)
            continue
        key = "params" if k in params else "stats"
        errs[key] = max(errs[key], norm_err(vb, va))
    return {**errs, "steps_and_counts_equal": exact, "step": a["step"]}


def check_resume(name, noise, resumed):
    """Under cuDNN's deterministic algorithms: the second uninterrupted run
    (``noise``: its errors against the first) and the resumed run
    (``resumed``) must both equal the first run bitwise."""
    for what, errs in (("the second uninterrupted run", noise),
                       ("the resumed run", resumed)):
        bad = {k: errs[k] for k in RESUME_KEYS if errs[k] != 0}
        if bad or not errs["steps_and_counts_equal"]:
            raise AssertionError(f"{name}: {what} is off the uninterrupted one "
                                 f"by {bad}, or its step or BN counts differ")


class DeterministicCudnn:
    """cuDNN's deterministic algorithms for the runs inside."""

    def __init__(self, torch):
        self.backends = torch.backends.cudnn

    def __enter__(self):
        self.before = self.backends.deterministic
        self.backends.deterministic = True

    def __exit__(self, *exc):
        self.backends.deterministic = self.before


class WriterSpans:
    """For the runs inside, the host-clock span of every background write
    (``AsyncCheckpointer._run``: the snapshot's copy to the host, the
    digest, the write)."""

    def __enter__(self):
        from dwt_tpu_torch.resilience.async_ckpt import AsyncCheckpointer

        self.cls, self.inner, self.spans = AsyncCheckpointer, AsyncCheckpointer._run, []
        inner, spans = self.inner, self.spans

        def run(acp, *args):
            t0 = time.perf_counter()
            try:
                inner(acp, *args)
            finally:
                spans.append((t0, time.perf_counter()))

        self.cls._run = run
        return self

    def __exit__(self, *exc):
        self.cls._run = self.inner


def manifest_digests(torch, directory):
    """``{step: params_digest}`` of a checkpoint directory's valid steps."""
    from dwt_tpu_torch.utils import checkpoint as ckpt

    out = {}
    for step in ckpt.valid_steps(directory):
        with open(os.path.join(directory, str(step), "manifest.json")) as f:
            out[step] = json.load(f)["params_digest"]
    return out


def save_records(records):
    """The ``checkpoint`` records' stall, writer time and bytes."""
    saves = [r for r in records if r["kind"] == "checkpoint"]
    return {"stall_ms": [r["seconds"] * 1e3 for r in saves],
            "writer_ms": [r["writer_s"] * 1e3 for r in saves],
            "bytes": [r["bytes"] for r in saves],
            "steps": [r["step"] for r in saves], "sync": [r["sync"] for r in saves],
            "dirs": [os.path.basename(r["dir"]) for r in saves]}


def overlap_run(torch, cw, officehome, loop, loader, root):
    """20 steps with a background save every 10 and no eval: each step's
    time (batch to batch) after the first OVERLAP_WARMUP, split by whether
    a write was in flight in it."""
    import statistics

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        OVERLAP_FLAGS + ["--ckpt_dir", os.path.join(root, "overlap")]))
    with DeterministicCudnn(torch), TimedBatches(loop) as timed, WriterSpans() as spans:
        records, launches, _ = counted_run(torch, cw, loader, loop.run_officehome, cfg,
                                           "ckpt_overlap", officehome_want)
    got = [g for _, g in timed.stamps]
    overlapped, free = [], []
    for a, b in list(zip(got, got[1:]))[OVERLAP_WARMUP:]:
        hit = any(s < b and e > a for s, e in spans.spans)
        (overlapped if hit else free).append((b - a) * 1e3)
    med = lambda v: statistics.median(v) if v else None
    return {"step_ms_overlapping_write": overlapped, "step_ms_free": free,
            "median_overlapping_ms": med(overlapped), "median_free_ms": med(free),
            "write_spans_ms": [(e - s) * 1e3 for s, e in spans.spans],
            **{f"save_{k}": v for k, v in save_records(records).items()}}, launches


def ckpt_resume(torch, cw, officehome, loop, loader, root):
    """Phase ``ckpt_resume``: the main train path through the CLI entry
    with ``--ckpt_dir``, saving on the background writer: run A and A2
    uninterrupted, run B cut after step CKPT_CUT and resumed, and run S
    with ``--no-async_ckpt``.  Checks each record's launches, the resume
    (source, exact data position), the batch ids exactly and the records,
    parameters and stats bitwise (``check_resume``), S bitwise equal to A
    with the same manifests' parameter digests.  Reports each save's loop
    stall and writer time, async and sync, and the overlap run's step
    times.  Returns the launches, run A's records, directory and final
    step."""
    from dwt_tpu_torch.utils import checkpoint as ckpt

    def cfg(name, extra=()):
        return officehome.config_from_args(officehome.build_parser().parse_args(
            CKPT_FLAGS + ["--ckpt_dir", os.path.join(root, name), *extra]))

    runs = {}
    with DeterministicCudnn(torch):
        for key, name, cut, extra in (
                ("A", "A", None, ()), ("A2", "A2", None, ()),
                ("B_cut", "B", CKPT_CUT, ()), ("B_resumed", "B", None, ()),
                ("S", "S", None, ("--no-async_ckpt",))):
            runs[key] = counted_run(torch, cw, loader, loop.run_officehome,
                                    cfg(name, extra), f"ckpt_resume_{key}",
                                    officehome_want, cut)
    (a, _, a_ids), (a2, _, a2_ids) = runs["A"], runs["A2"]
    (b1, _, b1_ids), (b2, _, b2_ids) = runs["B_cut"], runs["B_resumed"]
    sync, _, s_ids = runs["S"]
    resume = b2[0]
    if (resume["kind"], resume["step"], resume["source"], resume["data"]) != (
            "resume", CKPT_CUT - 1, "checkpoint", "exact"):
        raise AssertionError(f"run B resumed as {resume}")
    n = cfg("A").num_iters
    for role in ("source", "target"):
        if not (a_ids[role] == a2_ids[role] == s_ids[role] and len(a_ids[role]) == n
                and b1_ids[role][:CKPT_CUT] == a_ids[role][:CKPT_CUT]
                and b2_ids[role] == a_ids[role][CKPT_CUT - 1:]):
            raise AssertionError(f"{role} batch ids differ: A {a_ids[role]}, "
                                 f"B {b1_ids[role]} then {b2_ids[role]}")
    steps = range(CKPT_CUT, n + 1)
    model = loop.build_model(cfg("A"))
    def errs(other, name, steps=steps):
        return {**record_errs(a, other, steps), **state_errs(
            torch, model, os.path.join(root, "A"), os.path.join(root, name))}

    noise, resumed = errs(a2, "A2"), errs(b2, "B")
    sync_errs = errs(sync, "S", range(1, n + 1))
    digests = {name: manifest_digests(torch, os.path.join(root, name))
               for name in ("A", "S")}
    main_dir = os.path.join(root, "A", str(n))
    state_bytes = os.path.getsize(os.path.join(main_dir, ckpt.STATE_FILE))
    tensor_bytes = (2 * sum(p.numel() * 4 for p in model.parameters())
                    + sum(b.numel() * b.element_size() for b in model.buffers()))
    overlap, overlap_launches = overlap_run(torch, cw, officehome, loop, loader, root)
    launches = added(overlap_launches, *(l for _, l, _ in runs.values()))
    a_saves = save_records(a)
    emit({"phase": "ckpt_resume", "flags": CKPT_FLAGS, "cut_at": CKPT_CUT,
          "cudnn_deterministic": True,
          "uninterrupted_vs_uninterrupted": noise, "resumed_vs_uninterrupted": resumed,
          "sync_vs_async": sync_errs, "manifest_digests": digests,
          "save_ms": a_saves["stall_ms"], "save_dirs": a_saves["dirs"],
          "async_saves": a_saves, "sync_saves": save_records(sync),
          "overlap": overlap,
          "restore_ms": resume["restore_s"] * 1e3,
          "checkpoint_bytes": state_bytes, "tensor_bytes": tensor_bytes,
          "steps_saved": ckpt.valid_steps(os.path.join(root, "A")),
          "best_steps": ckpt.valid_steps(os.path.join(root, "A", "best_gr_4")),
          "batch_ids_equal": True, "launches": launches,
          "launches_by_run": {k: l for k, (_, l, _) in runs.items()}})
    check_resume("ResNet50", noise, resumed)
    check_resume("ResNet50 sync saves", sync_errs, sync_errs)
    if digests["A"] != digests["S"]:
        raise AssertionError(f"async and sync manifests differ: {digests}")
    # A's cadence and final saves ran on the writer (its best saves block
    # by design); every one of S's blocked.
    if any(sync_ for sync_, d in zip(a_saves["sync"], a_saves["dirs"]) if d == "A") \
            or not all(save_records(sync)["sync"]):
        raise AssertionError(f"save modes: A {a_saves}, S {save_records(sync)}")
    if ckpt.valid_steps(os.path.join(root, "A")) != [3, n]:
        raise AssertionError("run A did not save at its cadence")
    if not tensor_bytes <= state_bytes <= 1.01 * tensor_bytes:
        raise AssertionError(f"a checkpoint of {state_bytes} bytes for "
                             f"{tensor_bytes} bytes of tensors")
    if not overlap["step_ms_overlapping_write"] or not overlap["step_ms_free"]:
        raise AssertionError(f"no step with or without a write in flight: {overlap}")
    return launches, a, a_ids, os.path.join(root, "A"), n


def served_checkpoint(torch, cw, server, spec, ckpt_dir, images, step, reference,
                      phase, time_forward=False):
    """Serve ``ckpt_dir`` through the CLI flags of ``spec`` (an entry of
    ``SERVED``) over HTTP, send ``images`` as one ``.npy`` request, and
    hold the logits to ``reference`` (the trainer's eval forward of the
    restored model) at ``FORWARD_TOL``; returns the apply launches of the
    request.  ``time_forward``: also the forward's ms at the request's
    bucket (CUDA events)."""
    import numpy as np

    args = server.build_parser().parse_args(spec["flags"] + [
        "--ckpt_dir", ckpt_dir, "--buckets", str(len(images)),
        "--host", "127.0.0.1", "--port", "0"])
    t0 = time.perf_counter()
    engine = server.build_engine(args)
    torch.cuda.synchronize()
    restore_warm_s = time.perf_counter() - t0
    client = server.ServeClient(engine, max_batch_delay_ms=args.max_batch_delay_ms,
                                max_queue_items=args.max_queue)
    front = server.HttpFront(client, args.host, args.port)
    http = server.HttpServeClient(args.host, front.port, timeout=300)
    try:
        status, health = http.healthz()
        cw.apply_launches = 0
        logits = http.infer(images, binary=True)
        launches = cw.apply_launches
        batches = client.batches
    finally:
        http.close()
        front.close()
    err = norm_err(torch.from_numpy(logits), reference)
    timed = {}
    if time_forward:
        xb = engine.stage(np.zeros((len(images),) + images.shape[1:], np.float32))
        timed = {"forward_ms": cuda_ms(torch, lambda: engine.forward(xb, len(images)),
                                       iters=10, warmup=2), "card": nvidia_smi()}
    emit({"phase": phase, "restore_and_warm_s": restore_warm_s, **timed,
          "engine_step": engine.step, "source": engine.source,
          "healthz": health, "images": len(images), "batches_by_bucket": batches,
          "apply_launches": launches, "apply_launches_per_forward":
              launches / max(sum(batches.values()), 1),
          "served_vs_trainer": err, "tolerance": FORWARD_TOL,
          "logits_finite": bool(np.isfinite(logits).all())})
    if status != 200 or health["step"] != step or engine.step != step:
        raise AssertionError(f"/healthz {status} {health}: not step {step}")
    if sum(batches.values()) != 1 or launches != spec["sites"]:
        raise AssertionError(f"{launches} apply launches for {batches}")
    if logits.shape != (len(images), spec["classes"]) or err > FORWARD_TOL:
        raise AssertionError(f"served logits {logits.shape} off the trainer's by {err}")
    return launches


def trainer_eval_logits(torch, model, tx, ckpt_dir, images, device):
    """The trainer's eval forward of ``model`` restored as a resume restores
    it (``restore_state`` into a ``TrainState`` on the card)."""
    from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.utils import checkpoint as ckpt

    model.to(device, memory_format=torch.channels_last)
    state = TrainState(model, *tx(model))
    restored = ckpt.restore_state(ckpt_dir, state)
    model.eval()
    install_whiten_cache(model, make_whiten_cache(model))
    with torch.inference_mode():
        out = model(torch.from_numpy(images).to(device)).cpu()
    install_whiten_cache(model, None)
    return out, restored.step


def ckpt_serve(torch, cw, server, officehome, loop, a_dir, step, device):
    """Phase ``ckpt_serve``: the server with ``--ckpt_dir`` on run A's
    directory answers 8 test images as ``.npy``; returns its launches."""
    from dwt_tpu_torch.train.optim import officehome_tx

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(CKPT_FLAGS))
    images = loop._synthetic_classification_arrays(
        cfg.synthetic_size // 2, (cfg.img_crop_size,) * 2 + (3,), cfg.num_classes,
        cfg.seed + 2, 0.5)[0][:SERVED_IMAGES]
    reference, restored = trainer_eval_logits(
        torch, loop.build_model(cfg), lambda m: officehome_tx(m, cfg), a_dir,
        images, device)
    if restored != step:
        raise AssertionError(f"the trainer restored step {restored}, not {step}")
    return served_checkpoint(torch, cw, server, SERVED["resnet50"], a_dir, images,
                             step, reference, "ckpt_serve")


def digits_ckpt(torch, cw, usps_mnist, loop, loader, server, root, device):
    """Phase ``digits_ckpt``: the digits path through the CLI entry with
    ``--ckpt_dir``: runs U and U2 of 2 epochs, run C of 1 epoch resumed to
    2; checks as ``ckpt_resume``'s, then serves
    run C with ``--model lenet``.  Returns the train and serve launches."""
    from dwt_tpu_torch.train.optim import digits_tx

    def cfg(name, extra=()):
        return usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(
            DIGITS_CKPT_FLAGS + ["--ckpt_dir", os.path.join(root, name), *extra]))

    runs = {}
    with DeterministicCudnn(torch):
        for key, name, extra in (("U", "U", ()), ("U2", "U2", ()),
                                 ("C_epoch1", "C", ("--epochs", "1")),
                                 ("C_resumed", "C", ())):
            runs[key] = counted_run(torch, cw, loader, loop.run_digits,
                                    cfg(name, extra), f"digits_ckpt_{key}",
                                    digits_want)
    (u, _, u_ids), (u2, _, u2_ids) = runs["U"], runs["U2"]
    (c1, _, c1_ids), (c2, _, c2_ids) = runs["C_epoch1"], runs["C_resumed"]
    per_epoch = DIGITS_STEPS_PER_EPOCH
    resume = c2[0]
    if (resume["kind"], resume["step"], resume["data"], resume["cursor"]) != (
            "resume", per_epoch, "exact", 0):
        raise AssertionError(f"run C resumed as {resume}")
    for role in ("source", "target"):
        if not (u_ids[role] == u2_ids[role] and len(u_ids[role]) == 2 * per_epoch
                and c1_ids[role] + c2_ids[role] == u_ids[role]):
            raise AssertionError(f"{role} batch ids differ")
    steps = range(per_epoch + 1, 2 * per_epoch + 1)
    model = loop.build_digits_model(cfg("U"))
    noise = {**record_errs(u, u2, steps),
             **state_errs(torch, model, os.path.join(root, "U"), os.path.join(root, "U2"))}
    resumed = {**record_errs(u, c2, steps),
               **state_errs(torch, model, os.path.join(root, "U"), os.path.join(root, "C"))}
    train_launches = added(*(l for _, l, _ in runs.values()))
    emit({"phase": "digits_ckpt", "flags": DIGITS_CKPT_FLAGS,
          "cudnn_deterministic": True,
          "uninterrupted_vs_uninterrupted": noise, "resumed_vs_uninterrupted": resumed,
          "save_ms": [r["seconds"] * 1e3 for r in u if r["kind"] == "checkpoint"],
          "restore_ms": resume["restore_s"] * 1e3,
          "checkpoint_bytes": os.path.getsize(os.path.join(
              root, "U", str(2 * per_epoch), "state.pt")),
          "batch_ids_equal": True, "launches": train_launches})
    check_resume("LeNet-DWT", noise, resumed)

    c = cfg("C")
    images = loop._synthetic_classification_arrays(
        c.synthetic_size // 2, (28, 28, 1), 10, c.seed + 2, 0.5)[0][:SERVED_IMAGES]
    reference, restored = trainer_eval_logits(
        torch, loop.build_digits_model(c), lambda m: digits_tx(m, c, per_epoch),
        os.path.join(root, "C"), images, device)
    serve_launches = served_checkpoint(
        torch, cw, server, SERVED["lenet"], os.path.join(root, "C"), images,
        2 * per_epoch, reference, "digits_ckpt_serve")
    return train_launches, {"apply": serve_launches}


def guard_syncs(torch, cw, officehome, loop, extra, phase):
    """Host readbacks (``aten::_local_scalar_dense``, what ``.item()`` and
    ``float()`` of a card tensor run) of a 6-step run without evals, in a
    CPU-side profiler trace; returns ``(count, launches)``."""
    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        SYNC_FLAGS + list(extra)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, _, launches, _ = run_counted(
            torch, cw, lambda logger: loop.run_officehome(cfg, logger), phase)
    count = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    return count, launches


def snapshot_cost(torch, loop, officehome, device):
    """The device copy of a ResNet50-DWT train state after one step (its
    momentum exists), as the guard and the checkpoint writer take it: its
    device time (CUDA events around it, enqueued behind a spin of the card
    that outlasts the enqueue), the ms between CUDA events around it on an
    idle card and the host's ms (medians of SNAPSHOT_REPEATS, each into
    the buffers of the last), its device bytes and tensors."""
    import statistics

    from dwt_tpu_torch.resilience.async_ckpt import snapshot_state
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_officehome_train_step

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(TRAIN_FLAGS))
    model = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
    state = TrainState(model, *officehome_tx(model, cfg))
    make_officehome_train_step(model)(state, synthetic_batch(
        torch, loop, cfg.source_batch_size, cfg.img_crop_size, cfg.num_classes, 3,
        device))
    snap, times, device = snapshot_state(state), [], []
    for _ in range(SNAPSHOT_REPEATS):
        # Behind a spin of the card longer than the host's enqueue, the
        # events bracket the copies' device time alone.
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SNAPSHOT_SPIN_CYCLES)
        start.record()
        snap = snapshot_state(state, snap)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    for _ in range(SNAPSHOT_REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        snap = snapshot_state(state, snap)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        times.append((start.elapsed_time(end), host_ms))
    buffers = [b for b in snap.buffers().values() if b.is_cuda]
    return {"device_ms": statistics.median(device),
            "event_ms": statistics.median(t for t, _ in times),
            "host_ms": statistics.median(h for _, h in times),
            "bytes": sum(b.numel() * b.element_size() for b in buffers),
            "tensors": len(buffers)}


def guard_phase(torch, cw, officehome, loop, loader, inject, root, a_ids):
    """Phase ``guard``: the main train path with a NaN injected after step
    GUARD_NAN_STEP (``inject.arm``), a check every 2 steps and saves every
    3, under cuDNN's deterministic algorithms: under ``rollback`` a
    rollback from 4 to the step-3 checkpoint, the rest of the run on
    reseeded batches and a finite end; with ``--guard_lr_backoff 0.5`` an
    in-memory recovery at scale 0.5 and no rollback.  Also the guard's
    host readbacks per step (a profiled 6-step run with and without the
    guard) and the snapshot's cost.  Returns the launches."""
    import math

    guards = []
    make_guard = loop._make_guard
    loop._make_guard = lambda cfg, logger: guards.append(make_guard(cfg, logger)) or guards[-1]
    runs = {}
    try:
        with DeterministicCudnn(torch):
            for key, extra in (("rollback", []), ("lr_backoff", ["--guard_lr_backoff", "0.5"])):
                cfg = officehome.config_from_args(officehome.build_parser().parse_args(
                    GUARD_FLAGS + extra + ["--ckpt_dir", os.path.join(root, f"guard_{key}")]))
                inject.arm(inject.FaultPlan(nan_at_step=GUARD_NAN_STEP))
                runs[key] = counted_run(torch, cw, loader, loop.run_officehome, cfg,
                                        f"guard_{key}", officehome_want)
                inject.disarm()
    finally:
        loop._make_guard = make_guard
        inject.disarm()
    (rb, _, rb_ids), (bo, _, bo_ids) = runs["rollback"], runs["lr_backoff"]
    guard_kinds = ("divergence", "rollback", "lr_backoff", "lr_recover", "skip_step")
    events = {k: [{"kind": r["kind"], "step": r["step"],
                   **{f: r[f] for f in ("from_step", "source", "rollbacks", "scale")
                      if f in r}} for r in recs if r["kind"] in guard_kinds]
              for k, (recs, _, _) in runs.items()}
    train_steps = {k: sum(r["kind"] == "train" for r in recs)
                   for k, (recs, _, _) in runs.items()}
    with_guard, l1 = guard_syncs(torch, cw, officehome, loop,
                                 ["--guard_policy", "rollback", "--guard_interval", "2"],
                                 "guard_syncs_on")
    without, l2 = guard_syncs(torch, cw, officehome, loop, [], "guard_syncs_off")
    steps = officehome.build_parser().parse_args(SYNC_FLAGS).num_iters
    cost = snapshot_cost(torch, loop, officehome, torch.device("cuda", 0))
    from dwt_tpu_torch.utils import checkpoint as ckpt

    final_scale = torch.load(os.path.join(
        root, "guard_lr_backoff", str(ckpt.latest_step(os.path.join(root, "guard_lr_backoff"))),
        ckpt.STATE_FILE), weights_only=True)["lr_scale"]
    launches = added(l1, l2, *(l for _, l, _ in runs.values()))
    emit({"phase": "guard", "flags": GUARD_FLAGS, "nan_at_step": GUARD_NAN_STEP,
          "events": events, "train_records": train_steps,
          "guard_checks": [g.checks for g in guards],
          "checks_per_step": [g.checks / train_steps[k] for g, k in zip(guards, runs)],
          "profiled_readbacks": {"with_guard": with_guard, "without": without,
                                 "steps": steps,
                                 "guard_per_step": (with_guard - without) / steps},
          "snapshot": cost, "final_lr_scale": final_scale,
          "final_losses": {k: [r["loss"] for r in recs if r["kind"] == "final_test"]
                           for k, (recs, _, _) in runs.items()},
          "launches": launches})
    want_rb = [{"kind": "divergence", "step": GUARD_NAN_STEP, "scale": 1.0},
               {"kind": "rollback", "step": GUARD_NAN_STEP - 1,
                "from_step": GUARD_NAN_STEP, "source": "checkpoint", "rollbacks": 1}]
    want_bo = [{"kind": "divergence", "step": GUARD_NAN_STEP, "scale": 1.0},
               {"kind": "lr_backoff", "step": GUARD_NAN_STEP, "scale": 0.5}]
    if events["rollback"] != want_rb or events["lr_backoff"] != want_bo:
        raise AssertionError(f"guard events {events}")
    if final_scale != 0.5:
        raise AssertionError(f"the backed-off run saved lr_scale {final_scale}")
    for k, (recs, _, _) in runs.items():
        final = [r for r in recs if r["kind"] == "final_test"]
        if len(final) != 1 or not math.isfinite(final[0]["loss"]):
            raise AssertionError(f"{k}: no finite end {final}")
    n = 6
    for role in ("source", "target"):
        # The first attempt's prefetch may have built past step 4; the last
        # attempt built exactly steps 4..6, on reseeded streams.
        if rb_ids[role][:GUARD_NAN_STEP] != a_ids[role][:GUARD_NAN_STEP] or \
                rb_ids[role][-(n - 3):] == a_ids[role][3:]:
            raise AssertionError(f"{role}: the rollback did not reseed the batches")
        if bo_ids[role][:n] != a_ids[role][:n]:
            raise AssertionError(f"{role}: the in-memory recovery changed the batches")
    if with_guard - without != steps // 2:
        raise AssertionError(f"the guard read back {with_guard - without} times in "
                             f"{steps} steps, not {steps // 2}")
    return launches


def delta_phase(torch, cw, officehome, loop, loader, server, root, a_records, a_dir,
                device):
    """Phase ``delta``: the main train path with ``--ckpt_format delta``
    under cuDNN's deterministic algorithms, held bitwise to run A (records
    and final state); each save's mode and bytes; the restore through the
    chain; then the delta and the full checkpoint served at bucket 8, the
    logits bitwise equal (``delta_serve``).  Returns the train and serve
    launches."""
    import numpy as np

    from dwt_tpu_torch.ckpt.store import tree_bytes
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.utils import checkpoint as ckpt

    d_dir = os.path.join(root, "D")
    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        DELTA_FLAGS + ["--ckpt_dir", d_dir]))
    with DeterministicCudnn(torch):
        records, launches, _ = counted_run(torch, cw, loader, loop.run_officehome, cfg,
                                           "delta_record", officehome_want)
    n = cfg.num_iters
    model = loop.build_model(cfg)
    errs = {**record_errs(a_records, records, range(1, n + 1)),
            **state_errs(torch, model, a_dir, d_dir)}
    # Each save as its record saw it once written (a later save at the same
    # step replaces the directory), and the tree's manifests at the end.
    saves = [{"step": r["step"], "dir": os.path.basename(r["dir"]), "bytes": r["bytes"],
              "stall_ms": r["seconds"] * 1e3, "writer_ms": r["writer_s"] * 1e3}
             for r in records if r["kind"] == "checkpoint"]
    on_disk = {}
    for directory in (d_dir, os.path.join(d_dir, "best_gr_4")):
        for step in ckpt.valid_steps(directory):
            with open(os.path.join(directory, str(step), "manifest.json")) as f:
                m = json.load(f)
            on_disk[f"{os.path.relpath(directory, d_dir)}/{step}"] = {
                "mode": m["mode"], "leaves_written": len(m["leaves"]),
                "leaf_count": m["leaf_count"], "bytes_written": m["bytes_written"]}
    net = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
    state = TrainState(net, *officehome_tx(net, cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ckpt.restore_state(d_dir, state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(restored.path, "manifest.json")) as f:
        depth = json.load(f).get("delta_depth")
    images = loop._synthetic_classification_arrays(
        cfg.synthetic_size // 2, (cfg.img_crop_size,) * 2 + (3,), cfg.num_classes,
        cfg.seed + 2, 0.5)[0][:SERVED_IMAGES]
    logits, serve_launches = {}, 0
    for name, directory in (("full", a_dir), ("delta", d_dir)):
        args = server.build_parser().parse_args(SERVED["resnet50"]["flags"] + [
            "--ckpt_dir", directory, "--buckets", str(len(images))])
        engine = server.build_engine(args)
        cw.apply_launches = 0
        logits[name] = engine.infer(images)
        if name == "delta":
            serve_launches = cw.apply_launches
    emit({"phase": "delta", "flags": DELTA_FLAGS, "delta_vs_full_run": errs,
          "saves": saves, "manifests": on_disk, "blob_store_bytes": tree_bytes(
              os.path.join(d_dir, "blobs")), "restore_ms": restore_ms,
          "restored_step": restored.step,
          "restored_delta_depth": depth, "launches": launches})
    emit({"phase": "delta_serve", "images": len(images),
          "logits_bitwise_equal": bool(np.array_equal(logits["full"], logits["delta"])),
          "apply_launches": serve_launches})
    check_resume("ResNet50 delta format", errs, errs)
    if not np.array_equal(logits["full"], logits["delta"]) or \
            not np.isfinite(logits["delta"]).all():
        raise AssertionError("the delta checkpoint serves other logits than the full one")
    if serve_launches != SERVED["resnet50"]["sites"]:
        raise AssertionError(f"{serve_launches} apply launches for one forward")
    if {k: m["mode"] for k, m in on_disk.items() if k.startswith("./")} != {
            "./3": "full", f"./{n}": "delta"} or restored.step != n:
        raise AssertionError(f"delta manifests {on_disk}, restored {restored}")
    return launches, {"apply": serve_launches}


def preempt_phase(torch, cw, officehome, loop, loader, inject, root, a_records, a_dir):
    """Phase ``preempt``: the main train path with a SIGTERM delivered at
    step PREEMPT_STEP's boundary (``inject.arm``): the run returns normally
    after its final save there; the rerun resumes from it and ends bitwise
    equal to run A (cuDNN's deterministic algorithms).  Reports the time
    from the SIGTERM to the return.  Returns the launches."""
    p_dir = os.path.join(root, "P")
    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        CKPT_FLAGS + ["--ckpt_dir", p_dir]))
    stamps = {}

    def run(cfg, logger):
        def stamped(kind, step, **fields):
            if kind == "train":
                stamps["last_train"] = time.perf_counter()
            logger(kind, step, **fields)
        out = loop.run_officehome(cfg, stamped)
        stamps["returned"] = time.perf_counter()
        return out

    with DeterministicCudnn(torch):
        inject.arm(inject.FaultPlan(sigterm_at_step=PREEMPT_STEP))
        try:
            first, l1, _ = counted_run(torch, cw, loader, run, cfg, "preempt_stop",
                                       officehome_want)
        finally:
            inject.disarm()
        sigterm_s = stamps["returned"] - stamps["last_train"]
        second, l2, _ = counted_run(torch, cw, loader, loop.run_officehome, cfg,
                                    "preempt_resumed", officehome_want)
    from dwt_tpu_torch.utils import checkpoint as ckpt

    n = cfg.num_iters
    model = loop.build_model(cfg)
    errs = {**record_errs(a_records, second, range(PREEMPT_STEP + 1, n + 1)),
            **state_errs(torch, model, a_dir, p_dir)}
    pre = [r for r in first if r["kind"] == "preempt"]
    resume = second[0]
    launches = added(l1, l2)
    emit({"phase": "preempt", "sigterm_at_step": PREEMPT_STEP,
          "preempt_records": [{"step": r["step"]} for r in pre],
          "sigterm_to_return_s": sigterm_s,
          "final_save": save_records(first), "resume": {
              k: resume.get(k) for k in ("kind", "step", "source", "data")},
          "resumed_vs_uninterrupted": errs, "launches": launches})
    if [r["step"] for r in pre] != [PREEMPT_STEP] or first[-1]["kind"] != "preempt":
        raise AssertionError(f"no preempt exit at {PREEMPT_STEP}: {[r['kind'] for r in first]}")
    if PREEMPT_STEP not in ckpt.valid_steps(p_dir):
        raise AssertionError("no final save at the SIGTERM's step")
    if (resume["kind"], resume["step"], resume["data"]) != ("resume", PREEMPT_STEP, "exact"):
        raise AssertionError(f"resumed as {resume}")
    check_resume("ResNet50 preempted", errs, errs)
    return launches


CHAOS_CHILD = """
import json, sys
from dwt_tpu_torch.cli import usps_mnist
from dwt_tpu_torch.ops import cuda_whitening as cw
from dwt_tpu_torch.train.loop import run_digits

def logger(kind, step, **fields):
    print(json.dumps({"kind": kind, "step": step, "moments": cw.moments_launches,
                      "apply": cw.apply_launches, **fields}), file=sys.stderr, flush=True)

run_digits(usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(sys.argv[1:])),
           logger)
"""


def chaos_digits(torch, root):
    """Phase ``chaos_digits``: the digits trainer through its CLI flags in
    one subprocess per fault (``DWT_FAULT_PLAN``), all started together:
    a hang (the watchdog's exit 113 and its dump), a crash in a save (the
    previous step authoritative), 2 failed save writes (absorbed) and 99
    (diagnosed).  Each child prints its records with both kernels'
    launch counts; returns the launches summed over the children."""
    from dwt_tpu_torch.resilience import inject
    from dwt_tpu_torch.utils import checkpoint as ckpt

    here = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    t0 = time.perf_counter()
    for name, (plan, extra, _) in CHAOS_DIGITS.items():
        env = {**os.environ, inject.ENV_VAR: json.dumps(plan)}
        ck = os.path.join(root, f"chaos_{name}")
        procs[name] = (ck, subprocess.Popen(
            [sys.executable, "-c", CHAOS_CHILD, *DIGITS_CKPT_FLAGS, "--ckpt_dir", ck,
             *extra], cwd=here, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    results, launches = {}, {"moments": 0, "apply": 0}
    try:
        for name, (ck, proc) in procs.items():
            _, err = proc.communicate(timeout=300)
            records = []
            for line in err.splitlines():
                if line.startswith("{"):
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        pass
            last = records[-1] if records else {"moments": 0, "apply": 0}
            for k in launches:
                launches[k] += last[k]
            wd = os.path.join(ck, "watchdog")
            results[name] = {
                "rc": proc.returncode, "valid_steps": ckpt.valid_steps(ck),
                "kinds": [r["kind"] for r in records],
                "dumps": sorted(os.listdir(wd)) if os.path.isdir(wd) else [],
                "stderr_tail": err[-600:], "launches": {k: last[k] for k in launches}}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    emit({"phase": "chaos_digits", "seconds": time.perf_counter() - t0,
          "results": results, "launches": launches})
    for name, (_, _, want) in CHAOS_DIGITS.items():
        got = results[name]
        if got["rc"] != want["rc"] or got["valid_steps"] != want["steps"]:
            raise AssertionError(f"chaos {name}: {got}")
        if "stderr" in want and want["stderr"] not in got["stderr_tail"]:
            raise AssertionError(f"chaos {name}: no {want['stderr']!r} in {got}")
    dump = results["hang"]["dumps"]
    if not dump or not dump[0].startswith("stacks-"):
        raise AssertionError(f"the watchdog left no stack dump: {results['hang']}")
    return launches


RESNET50_STAGES = {  # stage -> (planes, num_blocks, in_channels_of_block0)
    1: (64, 3, 64), 2: (128, 4, 256), 3: (256, 6, 512), 4: (512, 3, 1024)}


def reference_state_dict(torch, seed):
    """Every key of the reference's ``model_best_gr_4.pth.tar`` at its
    shape (the table of ``tests/test_convert_fullsize.py``, the ImageNet
    ``fc`` head included), with values from ``seed`` that train: convs
    at He scale, SPD whitening covariances, positive BN variances."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name] = rng.normal(0, (2.0 / (i * k * k)) ** 0.5, (o, i, k, k))

    def wh_site(prefix, c):
        a = rng.normal(size=(c // 4, 4, 4))
        sd[f"{prefix}.wh.running_mean"] = rng.normal(0, 0.1, (1, c, 1, 1))
        sd[f"{prefix}.wh.running_variance"] = a @ a.transpose(0, 2, 1) / 4 + 0.5 * np.eye(4)
        sd[f"{prefix}.gamma"] = 1 + rng.normal(0, 0.1, (c, 1, 1))
        sd[f"{prefix}.beta"] = rng.normal(0, 0.1, (c, 1, 1))

    def bn_site(prefix, c):
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, c)
        sd[f"{prefix}.weight"] = 1 + rng.normal(0, 0.1, c)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(1000, np.int64)

    conv("conv1.weight", 64, 3, 7)
    wh_site("bn1", 64)
    for stage, (planes, blocks, in0) in RESNET50_STAGES.items():
        site = wh_site if stage == 1 else bn_site
        out = planes * 4
        for b in range(blocks):
            p = f"layer{stage}.{b}"
            conv(f"{p}.conv1.weight", planes, in0 if b == 0 else out, 1)
            conv(f"{p}.conv2.weight", planes, planes, 3)
            conv(f"{p}.conv3.weight", out, planes, 1)
            for k, c in ((1, planes), (2, planes), (3, out)):
                site(f"{p}.bn{k}", c)
        conv(f"layer{stage}.0.downsample.0.weight", out, in0, 1)
        site(f"layer{stage}.0.downsample_bn", out)
    sd["fc.weight"] = rng.normal(0, 0.01, (1000, 2048))
    sd["fc.bias"] = np.zeros(1000)
    return {k: torch.from_numpy(np.asarray(v)).to(
        torch.int64 if k.endswith("num_batches_tracked") else torch.float32)
        for k, v in sd.items()}


def convert_phase(torch, cw, officehome, loop, loader, root):
    """Phase ``convert``: a reference-scheme ResNet50 archive from a seed,
    ``python -m dwt_tpu_torch.cli.convert`` on it, then one train step
    from ``--init_ckpt`` on the card; returns that run's launches."""
    import math

    sd = reference_state_dict(torch, 1)
    archive = os.path.join(root, "model_best_gr_4.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, archive)
    out = os.path.join(root, "init")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dwt_tpu_torch.cli.convert", "--torch_ckpt", archive,
         "--out_dir", out], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600, check=True)
    convert_s = time.perf_counter() - t0
    printed = proc.stdout.strip().splitlines()
    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        TRAIN_FLAGS + ["--num_iters", "1", "--check_acc_step", "1000",
                       "--stat_collection_passes", "0", "--init_ckpt", out]))
    model = loop.build_model(cfg)
    loaded = {}

    def run(cfg, logger):
        def hook(kind, step, **fields):
            if kind == "init_ckpt":  # the converted weights, before step 1
                loaded["conv"] = torch.equal(model.layer3_2.conv2.weight.cpu(),
                                             sd["layer3.2.conv2.weight"])
                loaded["cov"] = all(torch.equal(
                    model.layer1_0.dn1.cov[d].cpu(), sd["layer1.0.bn1.wh.running_variance"])
                    for d in range(3))
            logger(kind, step, **fields)
        return loop.run_officehome(cfg, hook, model=model)

    records, launches, _ = counted_run(torch, cw, loader, run, cfg,
                                       "convert_record", officehome_want)
    emit({"phase": "convert", "keys": len(sd), "report": printed[0],
          "cli_output": printed, "convert_s": convert_s,
          "checkpoint_bytes": os.path.getsize(os.path.join(out, "0", "state.pt")),
          "weights_loaded": loaded, "records": [r["kind"] for r in records],
          "launches": launches})
    if printed != ["loaded=307 unexpected=0 shape_mismatch=2",
                   f"wrote {os.path.join(out, '0')}"]:
        raise AssertionError(f"convert printed {printed}")
    if [(r["kind"], r["step"]) for r in records] != [
            ("init_ckpt", 0), ("train", 1), ("stat_collection", 1), ("final_test", 1),
            ("params_digest", 1)]:
        raise AssertionError(f"records {[(r['kind'], r['step']) for r in records]}")
    if not all(loaded.values()) or len(loaded) != 2:
        raise AssertionError(f"init_ckpt did not load the converted weights: {loaded}")
    bad = [k for k in STEP_METRICS if k in records[1] and not math.isfinite(records[1][k])]
    if bad:
        raise AssertionError(f"non-finite {bad} in the step from the converted state")
    return launches


# ----------------------------------------------------------------- dispatch

# k steps per dispatch: ResNet50-DWT at 3 (the eval and save cadence of 3
# fills every chunk), LeNet-DWT and the folder path at 4.
DISPATCH_K = {"resnet50": 3, "digits": 4, "folder": 4}
# Timed ResNet50 runs: 9 steps without evals or saves; the window leaves out
# the first 3 (the first step's builds, the capture).
TIMED_FLAGS = ["--num_iters", "9", "--check_acc_step", "100", "--stat_collection_passes", "0"]
TIMED_SKIP = 3
# Timed folder runs: 16 steps without evals, the window after the first 4.
FOLDER_TIMED_FLAGS = ["--num_iters", "16", "--check_acc_step", "100",
                      "--stat_collection_passes", "0"]
FOLDER_SKIP = 4
FOLDER_TRACE_FROM = 12  # the last 4 steps traced, out of the step ms
DIGITS_DISPATCH = {  # the digits comparison: every step eager, against chunks of 4
    "k1": (1, ["--steps_per_dispatch", "1", "--harvest_depth", "0",
               "--eval_steps_per_dispatch", "1"]),
    "k1_depth2": (1, ["--steps_per_dispatch", "1", "--harvest_depth", "2",
                      "--eval_steps_per_dispatch", "1"]),
    "k4": (4, ["--steps_per_dispatch", "4", "--harvest_depth", "2",
               "--eval_steps_per_dispatch", "8"]),
}
DIGITS_SKIP = 4  # per epoch: the window after each epoch's first 4 steps
DIGITS_TRACE = {0: DIGITS_SKIP, 1: DIGITS_SKIP}  # a twin run traces those windows
# Guard under harvest: digits, a NaN at step 4 in the chunk (3, 4).
HARVEST_GUARD_FLAGS = DIGITS_BASE_FLAGS + [
    "--guard_policy", "rollback", "--guard_interval", "2", "--harvest_depth", "2",
    "--steps_per_dispatch", "2"]
HARVEST_GUARD_NAN = 4
GUARD_KINDS = ("divergence", "rollback", "lr_backoff", "lr_recover", "skip_step")
# The loop's boundaries at 4 steps per dispatch: delta saves every epoch
# (background in U, blocking in C), the watchdog armed, a SIGTERM at step
# 10 (inside the chunk 9–12: the stop at 12, mid-epoch), C's resume.
BOUNDARY_FLAGS = DIGITS_BASE_FLAGS + [
    "--steps_per_dispatch", "4", "--ckpt_every_epochs", "1", "--ckpt_format", "delta",
    "--watchdog_timeout", "300"]
BOUNDARY_SIGTERM = 10


class DispatchTimer:
    """Replaces the trainer's ``prefetch_to_device`` for the runs inside
    with a wrapper that records a CUDA event on the compute stream each
    time the loop asks for its next batch (``k`` = 1) or chunk, when the
    previous one's work is enqueued, and counts the steps each delivered.
    ``step_ms(skip)`` is the device clock's milliseconds per step over each
    stream's items after its first ``skip`` steps: from the loop asking for
    an item to its asking for the next, the item's steps and boundary.

    ``trace`` (``{stream index: step}``) profiles, in those streams, the
    loop itself from its asking for the item after ``step`` steps to the
    stream's end, where it waits for the card (:class:`WindowTrace`); the
    traced items stay out of ``step_ms``.  ``window()`` sums the windows:
    device busy ms per step (the union of the device events' intervals),
    the traced span per step, device operations per step."""

    def __init__(self, loop, k, trace=None):
        self.loop, self.k, self.streams = loop, k, []
        self.trace, self.windows = trace or {}, []

    def __enter__(self):
        import torch

        inner = self.inner = self.loop.prefetch_to_device
        streams, k, trace, windows = self.streams, self.k, self.trace, self.windows

        def timed(*args, **kwargs):
            it = inner(*args, **kwargs)
            marks = []
            from_step = trace.get(len(streams))
            streams.append(marks)

            def gen():
                window, done = None, 0
                try:
                    while True:
                        if window is None and from_step is not None and done >= from_step:
                            window = WindowTrace(torch)
                            window.__enter__()
                        event = torch.cuda.Event(enable_timing=True)
                        event.record()
                        try:
                            item = next(it)
                        except StopIteration:
                            marks.append((event, 0, window is not None))
                            return
                        n = next(iter(item.values())).shape[0] if k > 1 else 1
                        marks.append((event, n, window is not None))
                        done += n
                        yield item
                finally:
                    if window is not None:
                        window.__exit__(None, None, None)
                        windows.append((window.result, done - from_step))
                    it.close()

            return gen()

        self.loop.prefetch_to_device = timed
        return self

    def __exit__(self, *exc):
        self.loop.prefetch_to_device = self.inner

    def step_ms(self, skip):
        import torch

        torch.cuda.synchronize()
        ms = steps = 0
        for marks in self.streams:
            done = 0
            for (event, n, traced), (following, _, _) in zip(marks, marks[1:]):
                if done >= skip and not traced:
                    ms += event.elapsed_time(following)
                    steps += n
                done += n
        return ms / steps if steps else None

    def window(self):
        got = [(w, n) for w, n in self.windows if w is not None and n]
        steps = sum(n for _, n in got)
        if not steps:
            return {"traced_steps": 0, "device_busy_ms_per_step": None,
                    "span_ms_per_step": None, "device_ops_per_step": None}
        return {"traced_steps": steps,
                "device_busy_ms_per_step": sum(w["busy_ms"] for w, _ in got) / steps,
                "span_ms_per_step": sum(w["span_ms"] for w, _ in got) / steps,
                "device_ops_per_step": sum(w["ops"] for w, _ in got) / steps}


def busy_ms(events, lo=None, hi=None) -> float:
    """Milliseconds in which the card ran any of ``events`` (device events
    of a trace, µs): the union of their intervals, clipped to ``[lo, hi]``,
    so work that overlaps on two streams counts once."""
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in events)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        a, b = max(a, lo if lo is not None else a), min(b, hi if hi is not None else b)
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total / 1e3


class WindowTrace:
    """A ``torch.profiler`` session around part of a loop run, opened and
    closed by the loop's own thread; its end waits for the card.  ``result``
    is ``{"busy_ms", "span_ms", "ops"}``: the device's busy time
    (:func:`busy_ms`) inside the span from the window's start on the host
    to the card's finishing its work (a ``record_function`` range), and
    the device operations in it; None when the trace holds no device
    event (the profiler's dropped traces, PERF.md §7)."""

    NAME = "dispatch_window"

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.result = torch, None
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        self.range = self.torch.profiler.record_function(self.NAME)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f).get("traceEvents", [])
        device = [ev for ev in trace if ev.get("cat") in DEVICE_CATS and "dur" in ev]
        ranges = [ev for ev in trace if ev.get("name") == self.NAME
                  and ev.get("cat") == "user_annotation" and "dur" in ev]
        if not device:
            return
        lo, hi = ((ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]) if ranges else
                  (min(ev["ts"] for ev in device),
                   max(ev["ts"] + ev["dur"] for ev in device)))
        inside = [ev for ev in device if ev["ts"] < hi and ev["ts"] + ev["dur"] > lo]
        self.result = {"busy_ms": busy_ms(inside, lo, hi), "span_ms": (hi - lo) / 1e3,
                       "ops": len(inside)}


class HostSyncs:
    """Counts, for the runs inside, the harvester's blocking rendezvous
    (``AsyncMetricHarvester._wait``, the one countable sync of the record
    path) and the entries each waited for."""

    def __enter__(self):
        from dwt_tpu_torch.train.harvest import AsyncMetricHarvester

        self.cls, self.inner, self.waits = AsyncMetricHarvester, AsyncMetricHarvester._wait, []
        inner, waits = self.inner, self.waits

        def wait(h, entries):
            waits.append(len(entries))
            return inner(h, entries)

        self.cls._wait = wait
        return self

    def __exit__(self, *exc):
        self.cls._wait = self.inner


def graph_harness(torch, cw, loop, officehome, kind, device):
    """A chunk of ``DISPATCH_K[kind]`` train steps through the scanned step
    outside the loop (ResNet50-DWT at 3 × 18 × 224², or LeNet-DWT at 2 ×
    32 × 28²): the first step eager, the capture, the replays.  The first
    whitened site's kernels keep, from the capture, their inputs and
    outputs alive, so the last replay's values stay there: each is held to
    its plain version on the same input (apply ``TOL`` per element;
    moments ``MEAN_TOL``, ``COV_RTOL``/``COV_ATOL``).  Then the graph's and
    the eager step's ms (CUDA events over back-to-back dispatches) and
    device busy ms and operations per step (``torch.profiler``), the
    capture's ms and graph-pool bytes, and the launches it recorded."""
    from dwt_tpu_torch.config import DigitsConfig
    from dwt_tpu_torch.train import steps
    from dwt_tpu_torch.train.optim import digits_tx, officehome_tx
    from dwt_tpu_torch.train.state import TrainState

    k = DISPATCH_K[kind]
    if kind == "resnet50":
        cfg = officehome.config_from_args(officehome.build_parser().parse_args(TRAIN_FLAGS))
        model = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
        optimizer, schedules = officehome_tx(model, cfg)
        step = steps.make_officehome_train_step(model, cfg.lambda_mec_loss)
        batch = synthetic_batch(torch, loop, REFERENCE_STEP[0], REFERENCE_STEP[1],
                                cfg.num_classes, 7, device)
        iters = 2
    else:
        cfg = DigitsConfig(seed=4, group_size=4)
        model = loop.build_digits_model(cfg).to(device, memory_format=torch.channels_last)
        optimizer, schedules = digits_tx(model, cfg, DIGITS_STEPS_PER_EPOCH)
        step = steps.make_digits_train_step(model, cfg.lambda_entropy_loss)
        batch = digits_batch(torch, loop, 11, device)
        iters = 20
    state = TrainState(model, optimizer, schedules)
    chunk = {key: torch.stack([v] * k) for key, v in batch.items()}
    scanned = steps.make_scanned_step(step, k)
    seen, real = {}, (cw.whiten_moments, cw.whiten_apply)

    # The capture's tensors are kept detached: a reference to one with a
    # grad_fn would keep the captured step's autograd graph alive, its
    # AccumulateGrad nodes (made on the capture's side stream) with it, and
    # the eager step timed below would accumulate its gradients across
    # streams.
    def moments(x, group_size):
        out = real[0](x, group_size)
        if torch.cuda.is_current_stream_capturing() and "moments" not in seen:
            seen["moments"] = tuple(t.detach() for t in (x, *out))
        return out

    def apply(x, mean, w, out=None):
        y = real[1](x, mean, w, out=out)
        if torch.cuda.is_current_stream_capturing() and x.dim() == 3 and "apply" not in seen:
            seen["apply"] = tuple(t.detach() for t in (x, mean, w, y))
        return y

    cw.whiten_moments, cw.whiten_apply = moments, apply
    try:
        scanned(state, chunk)
    finally:
        cw.whiten_moments, cw.whiten_apply = real
    torch.cuda.synchronize()
    x, mean, cov = seen["moments"]
    ref_mean, ref_cov = cw.whiten_moments_plain(x, 4)
    dm, dc, moments_ok = moments_errors(torch, mean, cov, ref_mean, ref_cov)
    xa, ma, wa, ya = seen["apply"]
    ref_y = cw.whiten_apply_plain(xa, ma, wa)
    diff = (ya - ref_y).abs()
    apply_ok = bool((diff <= TOL + TOL * ref_y.abs()).all())
    graph = scanned.graph
    row = {"model": kind, "k": k, "site_shape": list(x.shape),
           "in_graph_moments_vs_plain": {"mean_max_abs_err": dm, "cov_max_abs_err": dc,
                                         "ok": moments_ok},
           "in_graph_apply_vs_plain": {"max_abs_err": float(diff.max()), "ok": apply_ok},
           "capture_ms": graph.capture_ms, "graph_pool_bytes": graph.pool_bytes,
           "recorded_launches": graph.recorded}
    del seen, x, mean, cov, xa, ma, wa, ya, ref_y, diff
    row["graph_step_ms"] = cuda_ms(torch, lambda: scanned(state, chunk), iters=iters,
                                   warmup=1) / k
    row["eager_step_ms"] = cuda_ms(torch, lambda: step(state, batch), iters=iters, warmup=1)
    for name, fn, n in (("graph", lambda: scanned(state, chunk), k),
                        ("eager", lambda: step(state, batch), 1)):
        events = trace_events(torch, fn)
        busy = busy_ms(events) / n
        row[f"{name}_device_busy_ms_per_step"] = busy
        row[f"{name}_device_ops_per_step"] = len(events) / n
        row[f"{name}_idle_share"] = 1.0 - busy / row[f"{name}_step_ms"]
        if name == "graph":
            # The kernels' own device time inside the replays, per step.
            row["in_graph_kernel_ms"] = {
                part: sum(ev["dur"] for ev in events
                          if any(m in ev["name"] for m in names)) / 1e3 / n or None
                for part, names in (("apply", APPLY_KERNELS), ("moments", MOMENTS_KERNELS))}
    row["replays"] = graph.replays
    emit({"phase": "dispatch_harness", **row})
    del scanned, state, model, optimizer, chunk, batch
    torch.cuda.empty_cache()
    if not (moments_ok and apply_ok):
        raise AssertionError(f"{kind}: a kernel inside the replayed step is off its "
                             f"plain version: {row}")
    return row


def dispatch_folder(torch, cw, officehome, loop, root):
    """The folder path (``FOLDER_TIMED_FLAGS``, 4 loader threads per
    stream) in three runs: k = 1 with a blocking readback every step
    (harvest depth 0), k = 1 at depth 2 (the default), and k = 4 at depth 2,
    so that the dispatch's and the readback's parts of a gain show apart.
    Each run's step ms over steps ``FOLDER_SKIP``–``FOLDER_TRACE_FROM``;
    from a trace of the same run's last steps, the card's busy ms per step,
    its idle share against the untraced step ms and inside the traced span;
    the launches checked."""
    out = {}
    k4 = DISPATCH_K["folder"]
    for key, k, extra in (("k1_depth0", 1, SYNC_RECORDS),
                          ("k1_depth2", 1, ["--harvest_depth", "2"]),
                          (f"k{k4}_depth2", k4, ["--steps_per_dispatch", str(k4),
                                                 "--harvest_depth", "2"])):
        cfg = officehome.config_from_args(officehome.build_parser().parse_args(
            folder_flags(root) + FOLDER_TIMED_FLAGS + extra))
        with DispatchTimer(loop, k, trace={0: FOLDER_TRACE_FROM}) as timer:
            _, records, launches, seconds = run_counted(
                torch, cw, lambda logger: loop.run_officehome(cfg, logger),
                f"dispatch_folder_{key}")
        check_record_launches(records, launches, officehome_want,
                              harvested=extra != SYNC_RECORDS)
        step_ms = timer.step_ms(FOLDER_SKIP)
        out[key] = {"k": k, "flags": extra, "step_ms": step_ms, "seconds": seconds,
                    "launches": launches, **idle_shares(timer.window(), step_ms)}
    emit({"phase": "dispatch_folder", "flags": FOLDER_TIMED_FLAGS, **out})
    return out


def idle_shares(window, step_ms):
    """A traced window (``DispatchTimer.window``) against the untraced
    ``step_ms``: the card's idle share per step, and inside the traced span
    (where the profiler slows the host)."""
    busy = window["device_busy_ms_per_step"]
    return {"window": window,
            "idle_share": None if busy is None else 1.0 - busy / step_ms,
            "idle_share_in_profile": (None if busy is None
                                      else 1.0 - busy / window["span_ms_per_step"])}


def dispatch_resnet50(torch, cw, officehome, loop, loader, root, a_records, a_dir):
    """ResNet50-DWT at 3 steps per dispatch: run R (``CKPT_FLAGS``, k = 3,
    harvest depth 2, under cuDNN's deterministic algorithms) bitwise equal
    to run A in its records, parameters and stats; the launches checked at
    the evals.  Then step ms (``TIMED_FLAGS``) at k = 1 with harvest depth
    0 and 2 and at k = 3, in turns (each setup twice, the order mirrored),
    and, on R's model, the eval pass ms at 1 and 8
    batches per dispatch (equal counters) and the collection pass ms."""
    from dwt_tpu_torch.train.evalpipe import EvalPipeline
    from dwt_tpu_torch.train.state import TrainState

    k = DISPATCH_K["resnet50"]
    r_dir = os.path.join(root, "R")
    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        CKPT_FLAGS + ["--steps_per_dispatch", str(k), "--harvest_depth", "2",
                      "--ckpt_dir", r_dir]))
    model = loop.build_model(cfg)
    with DeterministicCudnn(torch):
        records, launches, _ = counted_run(
            torch, cw, loader, lambda c, logger: loop.run_officehome(c, logger, model=model),
            cfg, "dispatch_R", officehome_want)
    n = cfg.num_iters
    errs = {**record_errs(a_records, records, range(1, n + 1)),
            **state_errs(torch, model, a_dir, r_dir)}
    plain = lambda recs: [(r["kind"], r["step"]) for r in recs if r["kind"] not in QUIET_RECORDS]
    same_sequence = plain(records) == plain(a_records)
    # Three setups in turns: the blocking readback every step, the default
    # (depth 2), and k steps per dispatch at depth 2.
    setups = {"k1_depth0": (1, SYNC_RECORDS), "k1_depth2": (1, ["--harvest_depth", "2"]),
              f"k{k}_depth2": (k, ["--steps_per_dispatch", str(k), "--harvest_depth", "2"])}
    timed = {key: [] for key in setups}
    for key in (*setups, *reversed(setups)):
        kk, extra = setups[key]
        tcfg = officehome.config_from_args(officehome.build_parser().parse_args(
            TRAIN_BASE_FLAGS + TIMED_FLAGS + extra))
        with DispatchTimer(loop, kk) as timer:
            loop.run_officehome(tcfg, lambda *a, **f: None)
        timed[key].append(timer.step_ms(TIMED_SKIP))
    state = TrainState(model, None, ())
    test_ds = loop._officehome_datasets(cfg)[2]
    device = torch.device("cuda", 0)
    evals, collect_ms = {}, {}
    with DeterministicCudnn(torch):
        for ek in (1, 8):
            pipe = EvalPipeline(cfg.test_batch_size, device, 3, cfg.num_workers, eval_k=ek)
            pipe.evaluate(state, test_ds)  # builds (and at 8 captures) the dispatch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = pipe.evaluate(state, test_ds)
            torch.cuda.synchronize()
            evals[ek] = {"ms": (time.perf_counter() - t0) * 1e3,
                         **{f: result[f] for f in ("loss", "accuracy", "count", "forwards")}}
        for ek in (8, 1):
            pipe = EvalPipeline(cfg.test_batch_size, device, 3, cfg.num_workers, eval_k=ek)
            pipe.collect_stats(state, test_ds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forwards = pipe.collect_stats(state, test_ds)
            torch.cuda.synchronize()
            collect_ms[ek] = {"ms": (time.perf_counter() - t0) * 1e3, "forwards": forwards}
    counters_equal = ({f: evals[1][f] for f in ("loss", "accuracy", "count")}
                      == {f: evals[8][f] for f in ("loss", "accuracy", "count")})
    row = {"k": k, "flags": CKPT_FLAGS, "R_vs_A": errs, "record_sequence_equal": same_sequence,
           "launches": launches, "timed_flags": TIMED_FLAGS,
           "step_ms": timed, "eval_pass": evals, "eval_counters_equal": counters_equal,
           "collection_pass": collect_ms}
    emit({"phase": "dispatch_resnet50", **row})
    del model, state
    torch.cuda.empty_cache()
    check_resume("ResNet50 at k = 3", errs, errs)
    if not (same_sequence and counters_equal):
        raise AssertionError(f"ResNet50 dispatch: records {same_sequence}, counters "
                             f"{counters_equal}: {evals}")
    return row


def digits_boundaries(torch, cw, usps_mnist, loop, loader, inject):
    """``BOUNDARY_FLAGS`` under cuDNN's deterministic algorithms: run U
    uninterrupted; run C with blocking saves and a SIGTERM at step
    ``BOUNDARY_SIGTERM`` (its final save at the chunk's end, a ``preempt``
    record), then C rerun: it resumes there with the exact data position,
    and its train records and final parameters (digest) are U's."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    strip = lambda recs: [{f: v for f, v in r.items() if f not in (
        "moments_launches", "apply_launches")} for r in recs if r["kind"] == "train"]
    digest = lambda recs: [r["sha256"] for r in recs if r["kind"] == "params_digest"]
    with tempfile.TemporaryDirectory(prefix="boundaries-", dir=build) as root, \
            DeterministicCudnn(torch):
        def run(name, key, extra=()):
            cfg = usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(
                BOUNDARY_FLAGS + ["--ckpt_dir", os.path.join(root, name), *extra]))
            return counted_run(torch, cw, loader, loop.run_digits, cfg,
                               f"dispatch_boundaries_{key}", digits_want)[:2]

        u, u_launches = run("U", "U")
        inject.arm(inject.FaultPlan(sigterm_at_step=BOUNDARY_SIGTERM))
        try:
            c1, c1_launches = run("C", "C_cut", ["--no-async_ckpt"])
        finally:
            inject.disarm()
        c2, c2_launches = run("C", "C_resumed")
        from dwt_tpu_torch.utils import checkpoint as ckpt

        modes = {name: [json.load(open(os.path.join(root, name, str(step), "manifest.json")))
                        .get("mode") for step in ckpt.valid_steps(os.path.join(root, name))]
                 for name in ("U", "C")}
    stop = -(-BOUNDARY_SIGTERM // 4) * 4
    row = {"flags": BOUNDARY_FLAGS, "sigterm_at_step": BOUNDARY_SIGTERM,
           "preempt": [(r["kind"], r["step"]) for r in c1 if r["kind"] == "preempt"],
           "resume": {f: c2[0].get(f) for f in ("kind", "step", "data", "cursor")},
           "train_records_equal": strip(c1) + strip(c2) == strip(u),
           "digests_equal": digest(c2) == digest(u) and bool(digest(u)),
           "manifest_modes": modes,
           "launches": added(u_launches, c1_launches, c2_launches)}
    if (row["preempt"] != [("preempt", stop)]
            or (row["resume"]["kind"], row["resume"]["step"], row["resume"]["data"])
            != ("resume", stop, "exact")
            or not (row["train_records_equal"] and row["digests_equal"])):
        raise AssertionError(f"digits boundaries at k = 4: {row}")
    return row


def dispatch_digits(torch, cw, usps_mnist, loop, loader, inject):
    """LeNet-DWT at 4 steps per dispatch (harvest depth 2, eval 8 per
    dispatch) against every step eager (depth 0, eval 1 per dispatch) and
    every step eager at depth 2, under cuDNN's deterministic algorithms:
    records bitwise equal, batch ids equal; step ms, the card's idle share
    (from a traced twin of each run, over the timed windows), host syncs
    per step (the harvester's rendezvous; no guard here); the loop's boundaries at k = 4
    (:func:`digits_boundaries`).  Then the guard under harvest:
    ``HARVEST_GUARD_FLAGS`` with a NaN at step ``HARVEST_GUARD_NAN``, on the
    card and on the CPU with both rings held until they overflow (records,
    guard events and batch ids of the card run against the CPU's), and on
    the card as it runs (the detection lag, at most the depth in
    dispatches)."""
    import math

    from dwt_tpu_torch.train import harvest

    runs = {}
    with DeterministicCudnn(torch):
        for key, (k, extra) in DIGITS_DISPATCH.items():
            cfg = usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(
                DIGITS_BASE_FLAGS + extra))
            with DispatchTimer(loop, k) as timer, HostSyncs() as syncs:
                records, launches, ids = counted_run(
                    torch, cw, loader, loop.run_digits, cfg, f"dispatch_digits_{key}",
                    digits_want)
            steps = sum(r["kind"] == "train" for r in records)
            step_ms = timer.step_ms(DIGITS_SKIP)
            # A twin of the run, traced over the windows the timer timed.
            with DispatchTimer(loop, k, trace=DIGITS_TRACE) as twin:
                loop.run_digits(cfg, lambda *a, **f: None)
            runs[key] = {"records": records, "ids": ids, "launches": launches,
                         "step_ms": step_ms, **idle_shares(twin.window(), step_ms),
                         "host_syncs_per_step": len(syncs.waits) / steps,
                         "rendezvous": syncs.waits}
    strip = lambda recs: [{f: v for f, v in r.items() if f not in (
        "eval_s", "eval_imgs_per_s", "dispatch_ms_p50", "dispatch_ms_p99",
        "moments_launches", "apply_launches")} for r in recs]
    records_equal = all(strip(runs["k1"]["records"]) == strip(v["records"])
                        for v in runs.values())
    ids_equal = all(runs["k1"]["ids"] == v["ids"] for v in runs.values())
    guard = {}
    for key, device_flags, held in (("card_held", [], True), ("cpu_held", ["--device", "cpu"], True),
                                    ("card", [], False)):
        cfg = usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(
            HARVEST_GUARD_FLAGS + device_flags))
        ready = harvest._Entry.ready
        if held:
            harvest._Entry.ready = lambda entry: False
        inject.arm(inject.FaultPlan(nan_at_step=HARVEST_GUARD_NAN))
        try:
            if device_flags:
                recs = []
                with BatchIds(loader) as ids:
                    loop.run_digits(cfg, lambda kind, step, **f: recs.append(
                        {"kind": kind, "step": step, **f}))
                guard[key] = {"records": recs, "ids": ids.ids}
            else:
                recs, launches, ids = counted_run(torch, cw, loader, loop.run_digits, cfg,
                                                  f"dispatch_guard_{key}", digits_want)
                guard[key] = {"records": recs, "ids": ids, "launches": launches}
        finally:
            harvest._Entry.ready = ready
            inject.disarm()
    events = {key: [{f: v for f, v in r.items() if f not in ("moments_launches", "apply_launches")}
                    for r in g["records"] if r["kind"] in GUARD_KINDS]
              for key, g in guard.items()}
    seq = {key: [(r["kind"], r["step"]) for r in g["records"] if r["kind"] in ("train", "test")]
           for key, g in guard.items()}

    def rel(a, b):
        return 0.0 if (math.isnan(a) and math.isnan(b)) else abs(a - b) / max(abs(b), 1e-30)

    pairs = [(a, b) for a, b in zip(guard["card_held"]["records"], guard["cpu_held"]["records"])
             if a["kind"] == b["kind"] == "train"]
    loss_err = max(rel(a[f], b[f]) for a, b in pairs for f in ("cls_loss", "entropy_loss"))
    accs = {key: [r["accuracy"] for r in g["records"] if r["kind"] == "test"]
            for key, g in guard.items()}
    k_guard = 2
    detected = [e for e in events["card"] if e["kind"] == "divergence"]
    bad_hi = -(-HARVEST_GUARD_NAN // k_guard) * k_guard
    lag = {"detected_at": detected[0]["detected_at"] if detected else None,
           "bad_step": detected[0]["step"] if detected else None}
    if detected:
        lag["lag_steps"] = lag["detected_at"] - lag["bad_step"]
        lag["lag_dispatches"] = (lag["detected_at"] - bad_hi) // k_guard
    row = {"flags": DIGITS_BASE_FLAGS,
           "runs": {key: {"flags": DIGITS_DISPATCH[key][1],
                          **{f: v[f] for f in ("step_ms", "idle_share",
                                               "idle_share_in_profile", "window",
                                               "host_syncs_per_step", "rendezvous",
                                               "launches")}}
                    for key, v in runs.items()},
           "records_equal": records_equal, "batch_ids_equal": ids_equal,
           "guard": {"flags": HARVEST_GUARD_FLAGS, "nan_at_step": HARVEST_GUARD_NAN,
                     "events": events, "card_vs_cpu_train_loss_rel_err": loss_err,
                     "accuracies": accs, "detection": lag,
                     "launches": {key: g.get("launches") for key, g in guard.items()}}}
    row["boundaries"] = digits_boundaries(torch, cw, usps_mnist, loop, loader, inject)
    emit({"phase": "dispatch_digits", **row})
    if not (records_equal and ids_equal):
        raise AssertionError(f"digits at k = 4: records equal {records_equal}, "
                             f"batch ids equal {ids_equal}")
    held_equal = (events["card_held"] == events["cpu_held"] and seq["card_held"] == seq["cpu_held"]
                  and guard["card_held"]["ids"] == guard["cpu_held"]["ids"])
    if not held_equal or not events["card_held"] or loss_err > DIGITS_LEAF_TOL * 10:
        raise AssertionError(f"guard under harvest: the card run is off the CPU run: {row['guard']}")
    if any(abs(a - b) > 100.0 / 128 for a, b in zip(accs["card_held"], accs["cpu_held"])):
        raise AssertionError(f"guard under harvest: accuracies {accs}")
    if not detected or not 0 <= lag["lag_dispatches"] <= 2:
        raise AssertionError(f"guard under harvest: detection {lag}")
    return row


# ---------------------------------------------------------- bf16 and numerics

BF16_KERNELS = {"apply": ("whiten_apply_bf16_kernel",),
                "moments": ("whiten_moments_bf16_kernel",)}
# The bf16 variants at every site shape of the paths that run them: (path,
# site, D or None for [M, C], M, C, launches per train step or forward).
BF16_SHAPES = (
    *(("train_bf16", name, DOMAINS, m, c, n) for name, m, c, n in TRAIN_SITES),
    *(("serve_bf16", name, None, m, c, n) for name, m, c, n in RESNET50_SITES),
    *(("digits_train_bf16", name, 2, DIGITS_STREAM * rows, c, 1)
      for name, c, rows in DIGITS_SITES),
)
BF16_RAGGED = ((DOMAINS, RAGGED_M, 64), (1, 7, 32), (1, 1, 256), (2, RAGGED_M, 48))
BF16_STEP = 2.0 ** -8  # one bf16 rounding step, relative to the larger magnitude
BF16_TRAIN_K = 3  # the flagship bf16 run's steps per dispatch
# --remat: the checkpointed stage-1 blocks hold 10 of the 11 whitened sites
# (block 0: dn1-dn3 and the downsample's; blocks 1, 2: dn1-dn3), whose
# moments and apply launch again when the backward recomputes them.
REMAT_RECOMPUTED = 10


def bf16_site(torch, d, m, c, gen, device):
    """A bf16 ``x [d, m, c]`` (``[m, c]`` for ``d=None``): correlated
    channels within a group, mean 1."""
    x = moments_input(torch, d or 1, m, c, gen, device, 1.0).to(torch.bfloat16)
    return x if d else x[0]


def time_bf16(torch, cw, part, x, mean, w, rate):
    """Times of the bf16 ``part`` kernel (``"apply"``: on ``x`` with
    ``mean``, ``w``; ``"moments"``: of ``x``) with L2 cold: its device time
    (``device_ms``; ``kernel_ms`` by CUDA events), the wrapper's host µs, its
    plain version's ms, the library call's (apply: ``torch.addmm`` /
    ``torch.baddbmm`` in bf16 with the block-diagonal matrix; moments:
    ``torch.cov`` of the upcast tensor, once per domain), beside its bound
    (bytes: bf16 ``x`` and ``y``, f32 ``mean``, ``w``, moments)."""
    batched = x.dim() == 3
    d, (m, c) = (x.shape[0] if batched else 1), x.shape[-2:]
    groups = c // 4
    if part == "apply":
        w3, mean3 = (w, mean) if batched else (w[None], mean[None])
        w_t = torch.stack([torch.block_diag(*wd).t() for wd in w3])
        bias = (-(mean3[:, None, :] @ w_t)).to(torch.bfloat16)
        w_t = w_t.to(torch.bfloat16).contiguous()
        library = ((lambda xi, yi: torch.baddbmm(bias, xi, w_t, out=yi)) if batched else
                   (lambda xi, yi: torch.addmm(bias[0, 0], xi, w_t[0], out=yi)))
        nbytes = d * (2 * m * c * 2 + 5 * c * 4)
        flops = d * m * c * 9
        cold = cold_rotation(torch, (x,), out_like=(x,))
        kernel = lambda xi, yi: cw.whiten_apply(xi, mean, w, out=yi)
        plain = lambda xi, yi: cw.whiten_apply_plain(xi, mean, w, out=yi)
    else:
        library = lambda xi: [torch.cov(xi[k].float().t(), correction=0) for k in range(d)]
        nbytes = d * m * c * 2 + d * (c + groups * 16) * 4
        flops = d * m * c * 6
        cold = cold_rotation(torch, (x,))
        kernel = lambda xi: cw.whiten_moments(xi, 4)
        plain = lambda xi: cw.whiten_moments_plain(xi, 4)
    bytes_ms, ops_ms = nbytes / rate * 1e3, flops / FP32_PEAK * 1e3
    row = {"D": d if batched else None, "M": m, "C": c, "bytes": nbytes,
           "rotation_buffers": len(cold),
           "kernel_ms": cuda_ms(torch, kernel, cold),
           **dict(zip(("device_ms", "device_traces"),
                      kernel_device_ms(torch, kernel, BF16_KERNELS[part], cold, bytes_ms))),
           "host_us": host_us(torch, kernel, cold),
           "plain_ms": cuda_ms(torch, plain, cold, iters=5, warmup=1),
           "library_ms": cuda_ms(torch, library, cold, iters=10),
           "library_device_ms": device_ms(torch, library, None, cold, iters=10),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    return row


def bf16_parity(torch, cw, name, x, full=False):
    """Both bf16 kernels against their plain versions on ``x`` (bf16):
    one launch each; the moments (f32) within the f32 moments tolerances
    of the plain version and of a float64 two-pass reference; the apply,
    whitening ``x`` with those moments, at most one bf16 rounding step
    from its plain version per element (and whether bitwise).  With
    ``full``: a second call bitwise equal, two graph replays of each
    bitwise equal, and one kernel and no other device operation in a
    trace of a call.  Returns ``(row, mean, w)``."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    batched = x.dim() == 3
    x3 = x if batched else x[None]
    before = cw.moments_launches, cw.apply_launches
    mean3, cov = cw.whiten_moments(x3, 4)
    w3 = whitening_matrix(_shrink(cov, 1e-3))
    mean, w = (mean3, w3) if batched else (mean3[0], w3[0])
    y = cw.whiten_apply(x, mean, w)
    launches = (cw.moments_launches - before[0], cw.apply_launches - before[1])
    pm, pc, p_ok = moments_errors(torch, mean3, cov, *cw.whiten_moments_plain(x3, 4))
    rm, rc, r_ok = moments_errors(torch, mean3, cov, *two_pass_f64(torch, x3.float()))
    ref = cw.whiten_apply_plain(x, mean, w)
    torch.cuda.synchronize()
    a, b = y.double(), ref.double()
    diff = (a - b).abs()
    steps_ok = bool((diff <= BF16_STEP * torch.maximum(a.abs(), b.abs())).all())
    row = {"shape": name, "D": x.shape[0] if batched else None, "M": x.shape[-2],
           "C": x.shape[-1], "launches": {"moments": launches[0], "apply": launches[1]},
           "y_dtype": str(y.dtype), "moments_dtype": str(cov.dtype),
           "apply_vs_plain": {"max_abs_err": float(diff.max()),
                              "bitwise": torch.equal(y, ref),
                              "within_one_bf16_step": steps_ok},
           "moments_vs_plain": {"mean_max_abs_err": pm, "cov_max_abs_err": pc},
           "moments_vs_f64_two_pass": {"mean_max_abs_err": rm, "cov_max_abs_err": rc},
           "mean_tol": MEAN_TOL, "cov_rtol": COV_RTOL, "cov_atol": COV_ATOL}
    ok = (p_ok and r_ok and steps_ok and launches == (1, 1) and y.dtype == torch.bfloat16
          and cov.dtype == torch.float32)
    del ref, diff, a, b
    if full:
        again_mean, again_cov = cw.whiten_moments(x3, 4)
        again_y = cw.whiten_apply(x, mean, w)
        torch.cuda.synchronize()
        row["repeat_bitwise"] = (torch.equal(again_mean, mean3) and torch.equal(again_cov, cov)
                                 and torch.equal(again_y, y))
        row["graph_replay_bitwise"] = (graph_replays(torch, cw, x3, (mean3, cov))
                                       and apply_graph_replays(torch, cw, x, mean, w, y))
        # A trace of TRACED_CALLS calls each (one call's can come back
        # empty, see apply_parity): every device operation is the kernel, at
        # most one per call.
        ops = {part: [ev["name"][:80] for ev in trace_events(torch, fn, iters=TRACED_CALLS)]
               for part, fn in (("moments", lambda: cw.whiten_moments(x3, 4)),
                                ("apply", lambda: cw.whiten_apply(x, mean, w)))}
        row["device_ops_per_call"] = {p: sorted(set(o)) for p, o in ops.items()}
        row["device_ops_in_trace"] = {p: len(o) for p, o in ops.items()}
        ok = (ok and row["repeat_bitwise"] and row["graph_replay_bitwise"]
              and all(1 <= len(o) <= TRACED_CALLS and all(BF16_KERNELS[p][0] in n for n in o)
                      for p, o in ops.items()))
    row["ok"] = ok
    return row, mean, w


def bf16_kernels(torch, cw, device, rate):
    """Phase ``bf16_kernels``: both bf16 variants against their plain
    versions at every site shape of the bf16 paths (ResNet50 train sites
    ``[3, M, C]``, bucket-128 serve sites ``[M, C]``, LeNet-DWT train
    sites ``[2, M, C]``) and at ragged shapes; times at the path shapes
    (the apply alone at the serve shapes)."""
    gen = torch.Generator(device=device).manual_seed(11)
    parity, timing = [], {}
    shapes = [(path, name, d, m, c) for path, name, d, m, c, _ in BF16_SHAPES]
    shapes += [("ragged", f"ragged_d{d}_m{m}_c{c}", d, m, c) for d, m, c in BF16_RAGGED]
    for path, name, d, m, c in shapes:
        x = bf16_site(torch, d, m, c, gen, device)
        row, mean, w = bf16_parity(torch, cw, name, x, full=path == "train_bf16")
        row["path"] = path
        parity.append(row)
        emit({"phase": "bf16_kernels", **row})
        if not row["ok"]:
            raise AssertionError(f"a bf16 kernel disagrees with its plain version at "
                                 f"{path} {name}: {row}")
        if path == "ragged":
            continue
        parts = ("apply",) if path == "serve_bf16" else ("apply", "moments")
        timing[(path, name)] = t = {part: time_bf16(torch, cw, part, x, mean, w, rate)
                                    for part in parts}
        emit({"phase": "bf16_timing", "path": path, "shape": name, **t})
        del x
        torch.cuda.empty_cache()
    return parity, timing


def bf16_train(torch, cw, officehome, usps_mnist, loop):
    """Phase ``bf16_train``: the flagship CLI at ``--compute_dtype bf16``,
    6 steps at ``BF16_TRAIN_K`` steps per dispatch (harvested records),
    with evals and one collection pass — 11 moments and 11 apply launches
    per step, the train's checks; the bf16 and the f32 step ms in turns
    (``TIMED_FLAGS`` at the same k); the digits CLI at bf16 (2 and 2 per
    step).  Returns the launches of both runs."""
    k = ["--steps_per_dispatch", str(BF16_TRAIN_K)]
    launches, _ = train(torch, cw, officehome, loop,
                        TRAIN_BASE_FLAGS + ["--compute_dtype", "bf16"] + k, "bf16_train")
    step_ms = {"f32": [], "bf16": []}
    for key in ("f32", "bf16", "bf16", "f32"):
        flags = TRAIN_BASE_FLAGS + TIMED_FLAGS + k + (
            ["--compute_dtype", "bf16"] if key == "bf16" else [])
        tcfg = officehome.config_from_args(officehome.build_parser().parse_args(flags))
        with DispatchTimer(loop, BF16_TRAIN_K) as timer:
            loop.run_officehome(tcfg, lambda *a, **f: None)
        step_ms[key].append(timer.step_ms(TIMED_SKIP))
    digits_launches, digits_acc = digits_train(
        torch, cw, usps_mnist, loop, DIGITS_TRAIN_FLAGS + ["--compute_dtype", "bf16"],
        "bf16_digits_train")
    emit({"phase": "bf16_train_timing", "card": nvidia_smi(), "k": BF16_TRAIN_K,
          "timed_flags": TIMED_FLAGS, "step_ms": step_ms,
          "bf16_over_f32": (sum(step_ms["bf16"]) / sum(step_ms["f32"])),
          "digits_accuracy": digits_acc})
    return launches, digits_launches


def whiteners_phase(torch, cw, officehome, usps_mnist, loop):
    """Phase ``whiteners``: the digits CLI with ``--whitener
    newton_schulz`` and ``swbn`` (the digits checks: 2 and 2 launches per
    step, finite losses, moved stats), and the flagship CLI with
    ``--whitener swbn --stat_collection_passes 0`` (its skipped
    ``stat_collection`` record, 11 and 11 per step)."""
    out = {}
    for name in ("newton_schulz", "swbn"):
        out[f"digits_{name}"], acc = digits_train(
            torch, cw, usps_mnist, loop, DIGITS_TRAIN_FLAGS + ["--whitener", name],
            f"whiteners_digits_{name}")
    out["officehome_swbn"], _ = train(
        torch, cw, officehome, loop,
        TRAIN_FLAGS + ["--whitener", "swbn", "--stat_collection_passes", "0"],
        "whiteners_officehome_swbn")
    return out


def remat_phase(torch, cw, officehome, loop, device):
    """Phase ``remat``: from the same weights and batch, one ResNet50 step
    with ``--remat`` against one without (cuDNN's deterministic
    algorithms): running stats bitwise equal, losses and gradient norm;
    launches per step 11 + ``REMAT_RECOMPUTED`` each with remat; then step
    ms and peak device memory of ``TIMED_FLAGS`` runs with and without, in
    turns."""
    cfg = officehome.config_from_args(officehome.build_parser().parse_args(TRAIN_FLAGS))
    batch = synthetic_batch(torch, loop, 18, 224, 65, 5, device)
    results = {}
    with DeterministicCudnn(torch):
        for remat in (False, True):
            cfg.remat = remat
            model = loop.build_model(cfg)
            before = cw.moments_launches, cw.apply_launches
            torch.cuda.reset_peak_memory_stats()
            metrics, model = one_step(torch, cfg, model, batch, device)
            results[remat] = {
                "metrics": metrics, "peak_bytes": torch.cuda.max_memory_allocated(),
                "launches": {"moments": cw.moments_launches - before[0],
                             "apply": cw.apply_launches - before[1]},
                "stats": {k: v.detach().clone() for k, v in model.state_dict().items()
                          if not k.endswith(("weight", "bias", "gamma", "beta"))}}
            del model
            torch.cuda.empty_cache()
    stats_equal = all(torch.equal(v, results[True]["stats"][k])
                      for k, v in results[False]["stats"].items())
    timed = {"plain": [], "remat": []}
    peak = {"plain": [], "remat": []}
    for key in ("plain", "remat", "remat", "plain"):
        flags = TRAIN_BASE_FLAGS + TIMED_FLAGS + (["--remat"] if key == "remat" else [])
        tcfg = officehome.config_from_args(officehome.build_parser().parse_args(flags))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with DispatchTimer(loop, 1) as timer:
            loop.run_officehome(tcfg, lambda *a, **f: None)
        timed[key].append(timer.step_ms(TIMED_SKIP))
        peak[key].append(torch.cuda.max_memory_allocated())
    row = {"card": nvidia_smi(), "stats_equal": stats_equal,
           "one_step": {("remat" if k else "plain"): {f: v[f] for f in
                                                     ("metrics", "peak_bytes", "launches")}
                        for k, v in results.items()},
           "timed_flags": TIMED_FLAGS, "step_ms": timed, "peak_bytes": peak}
    emit({"phase": "remat", **row})
    want = {True: WHITENED_SITES + REMAT_RECOMPUTED, False: WHITENED_SITES}
    bad = [k for k, v in results.items() if v["launches"] != {"moments": want[k],
                                                               "apply": want[k]}]
    close = all(abs(results[True]["metrics"][m] - results[False]["metrics"][m])
                <= TRAIN_TOL * abs(results[False]["metrics"][m])
                for m in ("loss", "cls_loss", "mec_loss"))
    if not stats_equal or bad or not close:
        raise AssertionError(f"remat: stats equal {stats_equal}, launches {bad}, "
                             f"losses close {close}")
    return row


# ------------------------------------------------------------- group sizes

GROUP_CHANNELS = (32, 48, 64, 256)  # the models' whitened site widths
GROUP_SIZES_C256 = (1, 2, 4, 8, 16, 32, 64, 128, 256)
GROUP_DOMAINS = (1, 3)
GROUP_ROWS = 1001  # rows per domain of the grid: ragged against every tile
# From this g on, a check that fails the tolerance above may pass within
# twice the plain version's own largest distance from float64 at that point.
GROUP_WIDE = 32
GROUP_TIMED = (8, 16, 64)  # group sizes timed at the flagship's train sites
GROUP_TIMING_ITERS = 20
GROUP_TRACE_ROUNDS = 3
GROUP_TRACE_AGREE = 0.25  # a kernel's traced device ms against its event ms
GROUP_KERNELS = {"apply": ("whiten_apply_group",),  # the tiled body and the scalar one
                 "moments": ("whiten_moments_group_kernel",)}
# The site checks' largest distances from float64 (mean, cov) of the
# general bodies before their tiled redesign (NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's.
GROUP_SITE_F64_BEFORE = {"float32": (8.6e-8, 7.6e-7), "bfloat16": (6.0e-8, 4.5e-6)}
GROUP_MOST_REGISTERS = 128  # the general kernels' ceiling a thread, no spills


def general_kernel_resources(logs):
    """Registers, static shared memory and spills of each general (any
    group size) kernel, from the ``-Xptxas -v`` lines of the build logs
    ``{source: log}``, keyed by the kernel's name (demangled where the
    toolkit's ``cu++filt`` is found)."""
    import re

    found, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = (re.search(r"Compiling entry function '(\S+)'", ln)
                 or re.search(r"Function properties for (\S+)", ln))
            if m:
                name = m.group(1)
                continue
            if not name or not any(k in name for k in ("whiten_apply_group",
                                                        "whiten_moments_group")):
                continue
            row = found.setdefault(name, {})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            if m:
                row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                row["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                row["static_smem"] = int(m.group(1)) if m else 0
    names = list(found)
    try:
        from dwt_tpu_torch.ops import _build

        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cu++filt")
        out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
        names = [n.replace("(anonymous namespace)::", "") for n in out]
    except (OSError, RuntimeError, subprocess.SubprocessError):
        pass
    return {short: found[raw] for short, raw in zip(names, found)}


def group_grid():
    """``(C, g, D)`` of phase ``group_kernels``: every divisor ``g`` of C
    for C = 32, 48 and 64, the powers of two for C = 256, each at D = 1
    and 3."""
    for c in GROUP_CHANNELS:
        sizes = (GROUP_SIZES_C256 if c == 256
                 else [g for g in range(1, c + 1) if c % g == 0])
        for g in sizes:
            for d in GROUP_DOMAINS:
                yield c, g, d


def apply_f64(torch, x, mean, w):
    """``(x − m)·W_bdᵀ`` per domain of ``x [D, M, C]`` in float64."""
    d, m, c = x.shape
    t = (x.double() - mean.double()[:, None]).view(d, m, -1, w.shape[-1])
    return torch.einsum("kmgc,kgdc->kmgd", t, w.double()).reshape(d, m, c)


def group_check(torch, got, plain, f64, rtol, atol, g):
    """``got`` against its plain version and a float64 reference, per
    element within ``atol + rtol·|ref|``; from ``GROUP_WIDE`` on, failing
    that, within twice the plain version's own largest distance from
    float64.  ``f64=None``: the plain version alone, within the
    tolerance."""
    a = got.double()
    out = {"vs_plain": float((a - plain.double()).abs().max()), "rtol": rtol,
           "atol": atol}
    ok = {"plain": bool(((a - plain.double()).abs()
                         <= atol + rtol * plain.double().abs()).all())}
    if f64 is not None:
        out["vs_f64"] = float((a - f64).abs().max())
        out["plain_vs_f64"] = float((plain.double() - f64).abs().max())
        ok["f64"] = bool(((a - f64).abs() <= atol + rtol * f64.abs()).all())
        wide = g >= GROUP_WIDE
        out["wide_bound"] = 2 * out["plain_vs_f64"] if wide else None
        for key, err in (("plain", out["vs_plain"]), ("f64", out["vs_f64"])):
            if not ok[key] and wide and err <= out["wide_bound"]:
                ok[key] = "within twice the plain version's distance from float64"
    out["ok"] = ok
    return out, all(bool(v) for v in ok.values())


def group_parity(torch, cw, x, g):
    """Both kernels of ``x``'s dtype on ``x [D, M, C]`` at group size
    ``g``, one launch each: the moments against the plain version and a
    float64 two-pass; the apply (with the whitening matrix of those
    moments) against the plain version, the f32 apply also against
    float64, the bf16 apply bitwise.  Returns ``((mean, cov, w, y),
    launches, row)``, ``row["ok"]`` the verdict of these checks."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    d, m, c = x.shape
    before = cw.moments_launches, cw.apply_launches
    mean, cov = cw.whiten_moments(x, g)
    w = whitening_matrix(_shrink(cov, 1e-3))
    y = cw.whiten_apply(x, mean, w)
    launches = (cw.moments_launches - before[0], cw.apply_launches - before[1])
    p_mean, p_cov = cw.whiten_moments_plain(x, g)
    f_mean, f_cov = two_pass_f64(torch, x.float(), g)
    p_y = cw.whiten_apply_plain(x, mean, w)
    bf16 = x.dtype is torch.bfloat16
    m_row, m_ok = group_check(torch, mean, p_mean, f_mean, MEAN_TOL, MEAN_TOL, g)
    c_row, c_ok = group_check(torch, cov, p_cov, f_cov, COV_RTOL, COV_ATOL, g)
    a_row, a_ok = group_check(torch, y, p_y, None if bf16 else apply_f64(torch, x, mean, w),
                              TOL, TOL, g)
    a_row["bitwise"] = torch.equal(y, p_y)
    row = {"C": c, "g": g, "D": d, "M": m, "dtype": str(x.dtype).split(".")[1],
           "cov_shape": list(cov.shape),
           "launches": {"moments": launches[0], "apply": launches[1]},
           "mean": m_row, "cov": c_row, "apply": a_row}
    row["ok"] = (m_ok and c_ok and a_ok and launches == (1, 1)
                 and list(cov.shape) == [d, c // g, g, g]
                 and (a_row["bitwise"] or not bf16))
    return (mean, cov, w, y), launches, row


def group_point(torch, cw, c, g, d, dtype, gen, device, m=GROUP_ROWS, out=None):
    """``group_parity`` at one grid point ``x [d, m, c]``, group size
    ``g``, then a second call of each kernel bitwise equal, and two
    replays of a CUDA graph that captured each.  ``out``: a dict that
    receives the input and the kernels' results."""
    x = moments_input(torch, d, m, c, gen, device, 1.0).to(dtype)
    (mean, cov, w, y), _, row = group_parity(torch, cw, x, g)
    if out is not None:
        out.update(x=x, mean=mean, cov=cov, w=w)
    again = cw.whiten_moments(x, g) + (cw.whiten_apply(x, mean, w),)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(again, (mean, cov, y)))
    replay = (graph_replays(torch, cw, x, (mean, cov), g)
              and apply_graph_replays(torch, cw, x, mean, w, y))
    row.update(repeat_bitwise=repeat, graph_replay_bitwise=replay,
               ok=row["ok"] and repeat and replay)
    return row


def parity_err(row, part):
    """The largest error against the plain version of ``part`` in a
    ``group_parity`` row."""
    return (row["apply"]["vs_plain"] if part == "apply"
            else max(row["mean"]["vs_plain"], row["cov"]["vs_plain"]))


def time_group(torch, cw, part, x, mean, w, g, rate, names=None):
    """Times of the ``part`` kernel at group size ``g`` on ``x [D, M, C]``
    (f32 or bf16; one launch for the D domains) with L2 cold: its device
    time, the wrapper's host µs, the plain version's ms and the library
    call's (apply: ``torch.baddbmm`` with the block-diagonal matrix, in
    ``x``'s dtype; moments: ``torch.cov`` of each domain, upcast), beside
    its bound: the larger of its bytes over the memory rate and its FLOPs
    (apply: g FMAs and a subtraction per element; moments: g(g + 1)/2
    FMAs and g additions per group and row) over the peak rate of ``x``'s
    type (f32 outside the tensor cores, bf16 on them).  A bf16 row also
    keeps its FLOPs over the f32 rate (``f32_fma_ms``): the floor of the
    ordered f32 FMAs that the kernels keep for their precision.  ``names``:
    the kernels the trace reads (by default the general bodies')."""
    names = names or GROUP_KERNELS[part]
    d, m, c = x.shape
    esize = x.element_size()
    if part == "apply":
        w_t = torch.stack([torch.block_diag(*wd).t() for wd in w])
        bias = (-(mean[:, None, :] @ w_t)).to(x.dtype)
        w_t = w_t.to(x.dtype).contiguous()
        library = lambda xi, yi: torch.baddbmm(bias, xi, w_t, out=yi)
        nbytes = d * (2 * m * c * esize + (c + c * g) * 4)
        flops = d * m * c * (2 * g + 1)
        cold = cold_rotation(torch, (x,), out_like=(x,))
        kernel = lambda xi, yi: cw.whiten_apply(xi, mean, w, out=yi)
        plain = lambda xi, yi: cw.whiten_apply_plain(xi, mean, w, out=yi)
    else:
        library = lambda xi: [torch.cov(xi[k].float().t(), correction=0) for k in range(d)]
        nbytes = d * m * c * esize + d * (c + c * g) * 4
        flops = d * m * c * (g + 2)
        cold = cold_rotation(torch, (x,))
        kernel = lambda xi: cw.whiten_moments(xi, g)
        plain = lambda xi: cw.whiten_moments_plain(xi, g)
    peak = BF16_PEAK if x.dtype is torch.bfloat16 else FP32_PEAK
    bytes_ms, ops_ms = nbytes / rate * 1e3, flops / peak * 1e3
    iters = GROUP_TIMING_ITERS

    def traced_ms(fn, names, events_ms=None):
        # The card's profiler now and then returns traces without the
        # kernels (device_ms takes 3), or with some of a kernel's events
        # dropped or doubled: more rounds, until the kernel's device time
        # agrees with its CUDA-event time within GROUP_TRACE_AGREE.
        for attempt in range(GROUP_TRACE_ROUNDS):
            last = attempt == GROUP_TRACE_ROUNDS - 1
            try:
                ms = device_ms(torch, fn, names, cold, iters=iters)
            except RuntimeError:
                if last:
                    raise
                continue
            if events_ms is None or abs(ms - events_ms) <= GROUP_TRACE_AGREE * events_ms or last:
                return ms

    kernel_ms = cuda_ms(torch, kernel, cold, iters=iters, warmup=3)
    row = {"D": d, "M": m, "C": c, "g": g, "dtype": str(x.dtype).split(".")[1],
           "bytes": nbytes, "flops": flops, "rotation_buffers": len(cold),
           "kernel_ms": kernel_ms,
           "device_ms": traced_ms(kernel, names, kernel_ms),
           "host_us": host_us(torch, kernel, cold),
           "plain_ms": cuda_ms(torch, plain, cold, iters=3, warmup=1),
           "library_ms": cuda_ms(torch, library, cold, iters=iters // 2, warmup=2),
           "library_device_ms": traced_ms(library, None),
           "bytes_ms": bytes_ms, "ops_ms": ops_ms, "f32_fma_ms": flops / FP32_PEAK * 1e3,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    row["device_over_events"] = row["device_ms"] / kernel_ms
    if part == "moments" and g != 4:  # (clusters per domain and entry tile, scratch, counters)
        row["plan"] = list(cw._moments_group_plan(x.device.index, d, m, c, g, x.dtype))
    elif g % 4 == 0 and g >= 8:  # the tiled body's geometry
        row["plan"] = dict(zip(("threads", "smem", "blocks", "nt", "kc", "stages",
                                "transposed", "copy_bytes"),
                               cw._apply_group_plan(x.device.index, d, m, c, g, x.dtype)))
    return row


def group_kernels(torch, cw, device, rate, timed=GROUP_TIMED):
    """Phase ``group_kernels``: both kernels in both dtypes over the grid
    of ``group_grid`` (``group_point``; every failing point is printed
    before the phase raises), then at the flagship's 11 train sites (3
    site shapes, 3 domains) at each g of ``GROUP_TIMED``, both dtypes:
    ``group_site_parity`` (``group_parity`` at the shapes the train step
    gives the kernels) and ``group_timing`` (``time_group``, each row with
    its kernel's largest error against the plain version at that site).
    Returns the timing, keyed by ``(part, dtype, g)`` → ``{site: row}``."""
    gen = torch.Generator(device=device).manual_seed(21)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for c, g, d in group_grid():
            row = group_point(torch, cw, c, g, d, dtype, gen, device)
            emit({"phase": "group_kernels", **row})
            if not row["ok"]:
                failed.append((row["dtype"], c, g, d))
    if failed:
        raise AssertionError(f"group_kernels: {len(failed)} grid points fail: {failed}")
    timing, site_f64 = {}, {}
    for g in timed:
        for dtype in (torch.float32, torch.bfloat16):
            for site, m, c, _ in TRAIN_SITES:
                x = moments_input(torch, DOMAINS, m, c, gen, device, 1.0).to(dtype)
                (mean, cov, w, y), _, row = group_parity(torch, cw, x, g)
                emit({"phase": "group_site_parity", "site": site, **row})
                for key in ("mean", "cov"):
                    site_f64.setdefault(row["dtype"], {}).setdefault(key, []).append(
                        row[key]["vs_f64"])
                if not row["ok"]:
                    failed.append((row["dtype"], site, g))
                    continue
                del y
                for part in ("apply", "moments"):
                    t = time_group(torch, cw, part, x, mean, w, g, rate)
                    t["max_abs_err"] = parity_err(row, part)
                    timing.setdefault((part, t["dtype"], g), {})[site] = t
                    emit({"phase": "group_timing", "part": part, "site": site, **t})
                del x, mean, cov, w
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"group_kernels: {len(failed)} train sites fail: {failed}")
    emit({"phase": "group_site_f64", "card": nvidia_smi(),
          "largest": {dt: {"mean": max(site_f64[dt]["mean"]), "cov": max(site_f64[dt]["cov"])}
                      for dt in site_f64},
          "before": {dt: {"mean": v[0], "cov": v[1]}
                     for dt, v in GROUP_SITE_F64_BEFORE.items()}})
    return timing


# The runs of phase group_train: (compute dtype, group size), each (dtype,
# g) that group_timing times; the f32 runs at GROUP_SAVED save checkpoints
# that group_serve serves.
GROUP_TRAIN = tuple((dtype, g) for g in GROUP_TIMED for dtype in ("f32", "bf16"))
GROUP_SAVED = (16, 64)
GROUP_TRAIN_K = 3
# group_train's timed runs in mirrored turns: (dtype, g).
GROUP_TIMED_RUNS = (("f32", 4), ("f32", 16), ("f32", 64), ("f32", 64), ("f32", 16),
                    ("f32", 4), ("bf16", 4), ("bf16", 16), ("bf16", 64), ("bf16", 64),
                    ("bf16", 16), ("bf16", 4))
GROUP_DIGITS = (16, 48)  # dn1 G = 2 and dn2 G = 3; dn1 clamped to g = 32, dn2 G = 1
GROUP_SERVED = ((16, "f32"), (16, "bf16"), (64, "f32"), (64, "bf16"))
GROUP_SERVE_SIZES = (1, 5, 32, 128)  # one request per bucket 1/8/32/128


def group_flags(dtype, g):
    return ["--group_size", str(g), "--compute_dtype", dtype]


def group_train(torch, cw, officehome, loop, root):
    """Phase ``group_train``: the flagship CLI at full width and the
    reference recipe, k = 3, at each ``(dtype, g)`` of ``GROUP_TRAIN``
    (``train``'s checks: 11 moments and 11 apply launches per step, the
    records, moved parameters and stats; the f32 runs at ``GROUP_SAVED``
    save under ``root``); then step ms and peak device memory of
    ``TIMED_FLAGS`` runs at g = 4, 16 and 64 in mirrored turns
    (``GROUP_TIMED_RUNS``).  Returns the launches per run and the
    checkpoints ``{g: (directory, flags)}``."""
    k = ["--steps_per_dispatch", str(GROUP_TRAIN_K)]
    launches, ckpts = {}, {}
    for dtype, g in GROUP_TRAIN:
        flags = TRAIN_BASE_FLAGS + k + group_flags(dtype, g)
        if dtype == "f32" and g in GROUP_SAVED:
            ckpt_dir = os.path.join(root, f"group_g{g}")
            flags = flags + ["--ckpt_dir", ckpt_dir, "--ckpt_every_iters", "3"]
            ckpts[g] = (ckpt_dir, flags)
        launches[(dtype, g)], _ = train(torch, cw, officehome, loop, flags,
                                        f"group_train_{dtype}_g{g}")
    step_ms, peak = {}, {}
    for dtype, g in GROUP_TIMED_RUNS:
        flags = TRAIN_BASE_FLAGS + TIMED_FLAGS + k + group_flags(dtype, g)
        tcfg = officehome.config_from_args(officehome.build_parser().parse_args(flags))
        key = f"{dtype}_g{g}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with DispatchTimer(loop, GROUP_TRAIN_K) as timer:
            loop.run_officehome(tcfg, lambda *a, **f: None)
        step_ms.setdefault(key, []).append(timer.step_ms(TIMED_SKIP))
        peak.setdefault(key, []).append(torch.cuda.max_memory_allocated())
    emit({"phase": "group_train_timing", "card": nvidia_smi(), "k": GROUP_TRAIN_K,
          "timed_flags": TIMED_FLAGS, "step_ms": step_ms, "peak_bytes": peak,
          "over_g4": {key: sum(v) / sum(step_ms[key.split("_")[0] + "_g4"])
                      for key, v in step_ms.items()}})
    return launches, ckpts


def group_digits(torch, cw, usps_mnist, loop):
    """Phase ``group_digits``: the digits CLI at each ``--group_size`` of
    ``GROUP_DIGITS`` (``digits_train``'s checks: 2 moments and 2 apply
    launches per step, an eval after each epoch).  At 48 the eval's cache
    holds dn1 ``[1, 32, 32]`` and dn2 ``[1, 48, 48]``."""
    return {g: digits_train(torch, cw, usps_mnist, loop,
                            DIGITS_TRAIN_FLAGS + ["--group_size", str(g)],
                            f"group_digits_g{g}")[0]
            for g in GROUP_DIGITS}


def group_serve(torch, cw, server, officehome, loop, ckpts, device):
    """Phase ``group_serve``: the server on each checkpoint of
    ``group_train`` (``--group_size`` 16 and 64), f32 and bf16, answers one
    request per bucket 1/8/32/128 over HTTP: 11 apply launches per forward,
    the logits held to the trainer's eval forward of the restored model (f32
    at ``FORWARD_TOL``, bf16 at ``BF16_SERVE_TOL`` of their scale); forward
    ms per bucket.  Returns the apply launches per ``(g, dtype)``."""
    import numpy as np

    from dwt_tpu_torch.train.optim import officehome_tx

    rng = np.random.default_rng(3)
    refs, out = {}, {}
    for g, dtype in GROUP_SERVED:
        ckpt_dir, flags = ckpts[g]
        if g not in refs:
            cfg = officehome.config_from_args(officehome.build_parser().parse_args(flags))
            images = rng.normal(size=(max(GROUP_SERVE_SIZES),) + (cfg.img_crop_size,) * 2
                                + (3,)).astype(np.float32)
            refs[g] = trainer_eval_logits(torch, loop.build_model(cfg),
                                          lambda m: officehome_tx(m, cfg), ckpt_dir,
                                          images, device)
        reference, step = refs[g]
        args = server.build_parser().parse_args(
            SERVED["resnet50"]["flags"] + [
                "--group_size", str(g), "--serve_dtype", dtype, "--ckpt_dir", ckpt_dir,
                "--buckets", "1,8,32,128", "--host", "127.0.0.1", "--port", "0"])
        engine = server.build_engine(args)
        client = server.ServeClient(engine, max_batch_delay_ms=args.max_batch_delay_ms,
                                    max_queue_items=args.max_queue)
        front = server.HttpFront(client, args.host, args.port)
        http = server.HttpServeClient(args.host, front.port, timeout=300)
        try:
            status, health = http.healthz()
            cw.apply_launches = 0
            responses = [http.infer(images[:n], binary=True) for n in GROUP_SERVE_SIZES]
            launches = cw.apply_launches
            batches = client.batches
        finally:
            http.close()
            front.close()
        errs = {n: norm_err(torch.from_numpy(r), reference[:n])
                for n, r in zip(GROUP_SERVE_SIZES, responses)}
        tol = FORWARD_TOL if dtype == "f32" else BF16_SERVE_TOL
        forward_ms = {}
        for b in engine.buckets:
            xb = engine.stage(np.zeros((b,) + images.shape[1:], np.float32))
            forward_ms[b] = cuda_ms(torch, lambda: engine.forward(xb, b), iters=5, warmup=2)
        row = {"g": g, "dtype": dtype, "engine_step": engine.step, "trainer_step": step,
               "healthz": health, "batches_by_bucket": batches, "apply_launches": launches,
               "served_vs_trainer": errs, "tolerance": tol, "forward_ms": forward_ms,
               "logits_finite": all(bool(np.isfinite(r).all()) for r in responses)}
        emit({"phase": "group_serve", **row})
        if (status != 200 or engine.step != step or batches != {1: 1, 8: 1, 32: 1, 128: 1}
                or launches != SERVED["resnet50"]["sites"] * 4 or max(errs.values()) > tol
                or not row["logits_finite"]):
            raise AssertionError(f"group_serve at g = {g}, {dtype}: {row}")
        out[(g, dtype)] = launches
        del engine
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ the backbone registry

# ViT-S/16 (``--backbone vit_dwt``) at 224²: 196 tokens an image, 384 wide;
# its whitened sites are the patch embed and blocks 0-2 (blocks 3-11 end in
# domain BN), each a [3, 18·196, 384] train site (3,528 rows a domain) and
# an [N·196, 384] eval or serve site.
VIT_BACKBONE, VIT_IMAGE = "vit_dwt", 224
VIT_TOKENS = 196
VIT_WIDTH = 384
VIT_SITES = 4
VIT_TRAIN_M = 18 * VIT_TOKENS
VIT_GROUPS = (4, 16, 64)  # 96 groups (the g = 4 kernels), 24 and 6 (tiled bodies)
VIT_APPLY_SHAPES = (("eval", 10), ("serve_b1", 1), ("serve_b8", 8), ("serve_b32", 32),
                    ("serve_b128", 128))  # (path, images) of the apply's [N·196, 384]
VIT_TIMED_APPLY = ("eval", "serve_b1", "serve_b128")  # timed at g = 4
VIT_TRAIN_BASE = TRAIN_BASE_FLAGS + ["--backbone", "vit_dwt"]
VIT_TRAIN_FLAGS = VIT_TRAIN_BASE + SYNC_RECORDS
VIT_TIMED_K = (1, 3)
# Biases whose exact gradient is zero, in every block: attn_k's (a shift of
# every key by one vector moves each query's scores by a constant, which
# the softmax removes) and mlp_fc2's (a per-channel shift of the block's
# output, which its norm site's batch mean removes).  Held to be noise —
# at most VIT_NOISE_TOL of the step's gradient norm — not leaf by leaf.
# Every other leaf's gradient and update (beyond rounding) is held at
# VIT_LEAF_TOL, about 10 times the worst of tools/torch_step_sensitivity.py
# --backbone vit_dwt on the H100 over 5 seeds (PERF.md): backbone leaves
# ≤ 3.2e-6 and head ≤ 1.1e-6 from the plain and the float64 step (both f32
# steps alike from float64: the kernels add nothing), zero-gradient biases
# ≤ 1.6e-9 of the gradient norm.  A fresh ViT-S/16 step is well conditioned,
# unlike ResNet50's (RESNET50_LEAF_TOL).
VIT_ZERO_GRAD_BIASES = ("attn_k", "mlp_fc2")
VIT_NOISE_TOL = 2e-8
VIT_LEAF_TOL = (3e-5, 1e-5)  # (backbone, head)
# VisDA-2017 (BASELINE.json configs[4]) through its own entry point: ResNet101,
# 12 classes (the entry's defaults), the flagship's recipe and shapes; its
# checkpoint at step 6 is served through --model resnet101.
VISDA_BASE = [
    "--synthetic", "--img_crop_size", "224", "--source_batch_size", "18",
    "--num_iters", "6", "--check_acc_step", "3", "--stat_collection_passes", "1",
    "--seed", "1", "--log_interval", "1", "--ckpt_every_iters", "6",
]
VISDA_FLAGS = VISDA_BASE + SYNC_RECORDS
VISDA_TIMED_K = (1, 3)
# The apply's sites in the served ResNet101's forward of its one request
# (SERVED_IMAGES images at that bucket, 224²): ResNet50's 11 site shapes.
VISDA_SERVE_SITES = tuple((name, m * SERVED_IMAGES // 128, c, n)
                          for name, m, c, n in RESNET50_SITES)
RESNET152_FLAGS = TRAIN_BASE_FLAGS + [
    "--backbone", "resnet152", "--num_iters", "3", "--check_acc_step", "100",
    "--stat_collection_passes", "0"] + SYNC_RECORDS


def vit_zero_grad_leaves(depth):
    """The ``VIT_ZERO_GRAD_BIASES`` of every block of a ``depth``-deep ViT."""
    return tuple(f"blk{i}.{leaf}.bias" for i in range(depth)
                 for leaf in VIT_ZERO_GRAD_BIASES)


def vit_engine(args, dtype):
    """A ``ServeEngine`` over a fresh ViT-S/16 (weights from ``--seed``) at
    ``dtype``: the server's ``--model`` offers no ViT, so it is served
    through the engine's Python API, as a user would."""
    from dwt_tpu_torch.config import model_dtype
    from dwt_tpu_torch.nn.registry import build_backbone
    from dwt_tpu_torch.serve.engine import ServeEngine

    model = build_backbone(VIT_BACKBONE, num_classes=65, image_size=VIT_IMAGE,
                           seed=args.seed, dtype=model_dtype(dtype))
    return ServeEngine(model, (VIT_IMAGE, VIT_IMAGE, 3), device=args.device,
                       buckets=[int(b) for b in args.buckets.split(",")])


def vit_apply_point(torch, cw, x, mean, w, g):
    """The apply kernel on an eval or serve site ``x [M, C]``: one launch,
    against its plain version (the f32 one also against float64, the bf16
    one bitwise), a second call bitwise equal, two replays of a CUDA graph
    that captured it bitwise equal."""
    before = cw.apply_launches
    y = cw.whiten_apply(x, mean, w)
    launches = cw.apply_launches - before
    plain = cw.whiten_apply_plain(x, mean, w)
    bf16 = x.dtype is torch.bfloat16
    f64 = None if bf16 else apply_f64(torch, x[None], mean[None], w[None])[0]
    a_row, ok = group_check(torch, y, plain, f64, TOL, TOL, g)
    a_row["bitwise"] = torch.equal(y, plain)
    again = cw.whiten_apply(x, mean, w)
    torch.cuda.synchronize()
    row = {"C": x.shape[1], "g": g, "M": x.shape[0], "dtype": str(x.dtype).split(".")[1],
           "launches": launches, "apply": a_row, "repeat_bitwise": torch.equal(again, y),
           "graph_replay_bitwise": apply_graph_replays(torch, cw, x, mean, w, y)}
    row["ok"] = (ok and launches == 1 and row["repeat_bitwise"]
                 and row["graph_replay_bitwise"] and (a_row["bitwise"] or not bf16))
    return row


def vit_kernels(torch, cw, device, rate):
    """Phase ``vit_kernels`` / ``vit_timing``: both kernels at ViT-S/16's
    token sites, f32 and bf16, at g = 4, 16 and 64.  The train site ``[3,
    3528, 384]`` (``group_point``: against the plain versions and float64,
    the bf16 apply bitwise, repeats and graph replays bitwise); with its
    target branch's moments and matrix, the apply at the eval (test batch
    10) and serve (buckets 1/8/32/128) sites ``[N·196, 384]``
    (``vit_apply_point``).  Times with L2 cold (``time_group``: beside the
    bound, the plain version, ``torch.baddbmm`` and ``torch.cov`` per
    domain, the host µs): the train site's two kernels at every g, the
    apply at the eval and bucket-1/128 sites at g = 4.  Returns ``(parity
    rows, {(dtype, g, path, part): timing row})``."""
    gen = torch.Generator(device=device).manual_seed(31)
    parity, timing, failed = [], {}, []
    for dtype in (torch.float32, torch.bfloat16):
        short = "bf16" if dtype is torch.bfloat16 else "f32"
        for g in VIT_GROUPS:
            site = {}
            row = group_point(torch, cw, VIT_WIDTH, g, DOMAINS, dtype, gen, device,
                              m=VIT_TRAIN_M, out=site)
            row.update(path="train", images=18)
            parity.append(row)
            emit({"phase": "vit_kernels", **row})
            if not row["ok"]:
                failed.append((short, g, "train"))
                continue
            x, mean, w = site["x"], site["mean"], site["w"]
            served = {}
            for path, n in VIT_APPLY_SHAPES:
                x2 = moments_input(torch, 1, n * VIT_TOKENS, VIT_WIDTH, gen, device,
                                   1.0)[0].to(dtype)
                a_row = vit_apply_point(torch, cw, x2, mean[1], w[1], g)
                a_row.update(path=path, images=n)
                parity.append(a_row)
                emit({"phase": "vit_kernels", **a_row})
                if not a_row["ok"]:
                    failed.append((short, g, path))
                served[path] = (x2, a_row["apply"]["vs_plain"])
            for part in ("apply", "moments"):
                t = time_group(torch, cw, part, x, mean, w, g, rate, names=(f"whiten_{part}",))
                t["max_abs_err"] = parity_err(row, part)
                timing[(short, g, "train", part)] = t
                emit({"phase": "vit_timing", "path": "train", "part": part, **t})
            for path in VIT_TIMED_APPLY if g == 4 else ():
                x2, err = served[path]
                t = time_group(torch, cw, "apply", x2[None], mean[1:2], w[1:2], g, rate,
                               names=("whiten_apply",))
                t["max_abs_err"] = err
                timing[(short, g, path, "apply")] = t
                emit({"phase": "vit_timing", "path": path, "part": "apply", **t})
            del x, mean, w, site, served
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"vit_kernels: {len(failed)} points fail: {failed}")
    return parity, timing


def vit_train(torch, cw, officehome, loop, device):
    """Phase ``vit_train``: ViT-S/16 through the OfficeHome CLI entry with
    ``--backbone vit_dwt`` (65 classes, 224², 3 × 18 images, 6 steps, an
    eval every 3, one collection pass, the final eval), f32 and bf16, with
    phase 7's checks at 4 moments and 4 apply launches a step;
    ``vit_reference``: one kernel step against the plain step and a
    float64 step (phase 8's check); ``vit_train_timing``: step ms (CUDA
    events, ``TIMED_FLAGS``) and peak device memory at k = 1 and 3, f32
    and bf16.  Returns the launches per dtype."""
    from dwt_tpu_torch.config import OfficeHomeConfig

    launches = {}
    for dtype in ("f32", "bf16"):
        launches[dtype], _ = train(torch, cw, officehome, loop,
                                   VIT_TRAIN_FLAGS + ["--compute_dtype", dtype],
                                   f"vit_train_{dtype}", sites=VIT_SITES)
    n = REFERENCE_STEP[0]
    cfg = OfficeHomeConfig(backbone=VIT_BACKBONE, seed=2, img_crop_size=VIT_IMAGE,
                           source_batch_size=n)
    batch = synthetic_batch(torch, loop, n, VIT_IMAGE, 65, 5, device)
    zero = vit_zero_grad_leaves(loop.build_model(cfg).depth)
    vs_plain, vs_f64, plain_vs_f64, kernel_launches, noise = reference_steps(
        torch, cw, loop, cfg, batch, device, zero)
    emit({"phase": "vit_reference", "kernel_vs_plain": leaf_summary(vs_plain),
          "kernel_vs_f64": leaf_summary(vs_f64), "plain_vs_f64": leaf_summary(plain_vs_f64),
          "checked_worst": {"kernel_vs_plain": checked_worst(vs_plain, zero),
                            "kernel_vs_f64": checked_worst(vs_f64, zero)},
          "kernel_launches": kernel_launches, "tolerance": TRAIN_TOL,
          "grad_tolerance": TRAIN_GRAD_TOL,
          "leaf_tolerance": dict(zip(("backbone", "head"), VIT_LEAF_TOL)),
          "f64_ratio_tolerance": F64_RATIO_TOL, "zero_grad_bias_share": noise,
          "noise_tolerance": VIT_NOISE_TOL})
    if kernel_launches != (VIT_SITES, VIT_SITES):
        raise AssertionError(f"ViT kernel step launched {kernel_launches}")
    for what, errs in (("kernels vs plain", vs_plain), ("kernels vs float64", vs_f64)):
        check_step(f"{what} (ViT-S/16)", errs, *VIT_LEAF_TOL, skip=zero)
    if max(noise["kernels"], noise["plain"]) > VIT_NOISE_TOL:
        raise AssertionError(f"the zero-gradient biases' gradients are not noise: {noise}")
    if vs_f64["grad"] > F64_RATIO_TOL * plain_vs_f64["grad"]:
        raise AssertionError(
            f"the ViT kernel step's gradient is {vs_f64['grad']} from float64, "
            f"over {F64_RATIO_TOL} times the plain step's {plain_vs_f64['grad']}")
    step_ms, peak = {}, {}
    for dtype in ("f32", "bf16"):
        for k in VIT_TIMED_K:
            flags = VIT_TRAIN_BASE + TIMED_FLAGS + ["--steps_per_dispatch", str(k),
                                                    "--compute_dtype", dtype]
            tcfg = officehome.config_from_args(officehome.build_parser().parse_args(flags))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with DispatchTimer(loop, k) as timer:
                loop.run_officehome(tcfg, lambda *a, **f: None)
            step_ms[f"{dtype}_k{k}"] = timer.step_ms(TIMED_SKIP)
            peak[f"{dtype}_k{k}"] = torch.cuda.max_memory_allocated()
    emit({"phase": "vit_train_timing", "card": nvidia_smi(), "timed_flags": TIMED_FLAGS,
          "images_per_step": 3 * n, "step_ms": step_ms, "peak_bytes": peak,
          "imgs_per_s": {key: 3 * n / ms * 1e3 for key, ms in step_ms.items()}})
    return launches


def visda_train(torch, cw, officehome, visda, loop, root):
    """Phase ``visda_train``: ``dwt_tpu_torch.cli.visda`` (ResNet101, 12
    classes) on synthetic data, phase 7's run and checks (11 moments and
    11 apply launches a step), saving its step-6 checkpoint under
    ``root``; ``visda_train_timing``: step ms (CUDA events,
    ``TIMED_FLAGS``) and peak device memory at k = 1 and 3.  Returns the
    launches and the flags."""
    parser = visda.build_parser()
    flags = VISDA_FLAGS + ["--ckpt_dir", os.path.join(root, "visda")]
    launches, _ = train(torch, cw, officehome, loop, flags, "visda_train", parser=parser)
    step_ms, peak = {}, {}
    for k in VISDA_TIMED_K:
        tcfg = officehome.config_from_args(parser.parse_args(
            VISDA_BASE + TIMED_FLAGS + ["--steps_per_dispatch", str(k)]))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with DispatchTimer(loop, k) as timer:
            loop.run_officehome(tcfg, lambda *a, **f: None)
        step_ms[f"k{k}"] = timer.step_ms(TIMED_SKIP)
        peak[f"k{k}"] = torch.cuda.max_memory_allocated()
    emit({"phase": "visda_train_timing", "card": nvidia_smi(), "timed_flags": TIMED_FLAGS,
          "step_ms": step_ms, "peak_bytes": peak,
          "imgs_per_s": {key: 3 * 18 / ms * 1e3 for key, ms in step_ms.items()}})
    return launches, flags


def visda_serve(torch, cw, server, officehome, visda, loop, flags, device, rate):
    """Phase ``visda_serve``: the server CLI with ``--model resnet101
    --num_classes 12 --ckpt_dir`` on ``visda_train``'s checkpoint answers 8
    images as one ``.npy`` request: 11 apply launches, logits held to the
    trainer's eval forward of the restored model (``served_checkpoint``);
    ``visda_serve_parity`` / ``visda_serve_timing``: the apply at that
    forward's site shapes (``VISDA_SERVE_SITES``) against its plain
    version and timed as phase 1 times bucket 128's.  Returns ``(launches,
    parity rows, {site: timing row})``."""
    from dwt_tpu_torch.train.optim import officehome_tx

    cfg = officehome.config_from_args(visda.build_parser().parse_args(flags))
    images = loop._synthetic_classification_arrays(
        cfg.synthetic_size // 2, (cfg.img_crop_size,) * 2 + (3,), cfg.num_classes,
        cfg.seed + 2, 0.5)[0][:SERVED_IMAGES]
    reference, step = trainer_eval_logits(
        torch, loop.build_model(cfg), lambda m: officehome_tx(m, cfg), cfg.ckpt_dir,
        images, device)
    if step != cfg.num_iters:
        raise AssertionError(f"the VisDA run saved step {step}, not {cfg.num_iters}")
    launches = served_checkpoint(torch, cw, server, SERVED["resnet101"], cfg.ckpt_dir,
                                 images, step, reference, "visda_serve", time_forward=True)
    return (launches, *served_apply_sites(torch, cw, VISDA_SERVE_SITES, 41, device, rate,
                                          "visda_serve"))


def served_apply_sites(torch, cw, sites, seed, device, rate, phase):
    """Phases ``{phase}_parity`` / ``{phase}_timing``: the apply at one
    served forward's site shapes ``sites`` (``(site, M, C, sites per
    forward)``) on inputs from ``seed`` against its plain version, and
    timed as phase 1 times bucket 128's.  Returns ``(parity rows, {site:
    timing row})``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cpu_gen = torch.Generator().manual_seed(seed)
    parity, timing = [], {}
    for name, m, c, _ in sites:
        x, mean, w = site_inputs(torch, m, c, gen, cpu_gen, device)
        row = apply_parity(torch, cw, name, x, mean, w)
        parity.append(row)
        emit({"phase": f"{phase}_parity", **row})
        if not row["ok"]:
            raise AssertionError(f"kernel disagrees with plain at {name}: {row}")
        timing[name] = {"shape": name, **time_apply(torch, cw, x, mean, w, rate)}
        emit({"phase": f"{phase}_timing", **timing[name]})
        del x
    return parity, timing


def served_apply_row(sites, parity, timing, launches, floor, path, per):
    """A kernels-line row of the apply on a served path: ``launches`` from
    the path's run, the largest error and the times summed over one
    forward's ``sites`` from :func:`served_apply_sites`."""
    total = lambda key: sum(timing[s][key] * n for s, _, _, n in sites)
    return {
        "name": "whiten_apply", "route": "cuda",
        "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
        "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
        "launches": launches, "max_abs_err": max(p["max_abs_err"] for p in parity),
        "ms": total("device_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": bound_by(timing.values()),
        "library_ms": total("library_ms"), "library_device_ms": total("library_device_ms"),
        **{k: total(k) for k in APPLY_EXTRA}, "bytes": total("bytes"), **floor,
        "path": path, "per": per}


def resnet152_train(torch, cw, officehome, loop):
    """Phase ``resnet152_train``: 3 steps of ``--backbone resnet152``
    through the CLI entry with phase 7's checks (11 + 11 launches a step);
    its step ms over steps 2-3 (CUDA events at each batch the loop asks
    for) and peak device memory.  Returns the launches."""
    torch.cuda.empty_cache()
    with DispatchTimer(loop, 1) as timer:
        launches, _ = train(torch, cw, officehome, loop, RESNET152_FLAGS,
                            "resnet152_train")
    emit({"phase": "resnet152_train_timing", "card": nvidia_smi(),
          "step_ms": timer.step_ms(1), "steps_timed": 2,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return launches


def backbone_rows(r, floor, rows):
    """The contract line's rows of the registry's paths.  ViT-S/16
    (``vit_train_f32``/``_bf16``: launches of ``vit_train``'s runs, times
    of one step's 4 train sites at g = 4 from ``vit_timing``, the eval
    forward's and the other group sizes' beside them; ``vit_serve_f32``/
    ``_bf16``: launches of ``vit_serve``'s 4 requests, times of one
    bucket-128 forward's 4 sites, bucket 1's beside them).  ResNet101's
    and ResNet152's train steps (``visda_train``, ``resnet152_train``)
    whiten the same 11 site shapes as ResNet50's: their launches, and the
    flagship train rows' errors and times (``carried_from``).
    ``visda_serve``: its request's launches, and the errors and times of
    ``visda_serve``'s own bucket-8 sites."""
    timing = r["vit_timing"]

    def site_times(dtype, g, path, part, n=VIT_SITES):
        t = timing[(dtype, g, path, part)]
        out = {k: t[k] * n for k in ("device_ms", "plain_ms", "bound_ms", "library_ms",
                                     "library_device_ms", "host_us", "bytes")}
        out["ms"] = out.pop("device_ms")
        return {**out, "bound_by": t["bound_by"], "max_abs_err": t["max_abs_err"]}

    out = []
    for dtype in ("f32", "bf16"):
        suffix = "_bf16" if dtype == "bf16" else ""
        for part in ("apply", "moments"):
            row = {
                "name": f"whiten_{part}{suffix}", "route": "cuda",
                "source": f"dwt_tpu_torch/csrc/whiten_{part}.cu",
                "replaces": ("dwt_tpu/ops/pallas_whitening.py:143" if part == "apply"
                             else "dwt_tpu/ops/pallas_whitening.py:68"),
                "launches": r["vit_train_launches"][dtype][part],
                **site_times(dtype, 4, "train", part), **(floor if part == "apply" else {}),
                "path": f"vit_train_{dtype}",
                "per": f"the 4 whitened token sites of one ViT-S/16 train step at "
                       f"--compute_dtype {dtype}, one launch per site for its 3 domains, "
                       f"18 images per stream at 224² (3 × 3,528 rows, C = 384)",
                "group_sizes": {g: site_times(dtype, g, "train", part) for g in VIT_GROUPS
                                if g != 4}}
            if part == "apply":
                row["eval"] = {"per": "one eval forward at the test batch of 10 "
                                      "(1,960 rows a site)",
                               **site_times(dtype, 4, "eval", "apply")}
            out.append(row)
        b128 = site_times(dtype, 4, "serve_b128", "apply")
        out.append({
            "name": f"whiten_apply{suffix}", "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["vit_serve_launches"][dtype],
            **b128,
            "max_abs_err": max(p["apply"]["vs_plain"] for p in r["vit_parity"]
                               if p["path"].startswith("serve") and p["g"] == 4
                               and p["dtype"] == ("bfloat16" if dtype == "bf16" else "float32")),
            **floor, "path": f"vit_serve_{dtype}",
            "per": f"the 4 whitened token sites of one bucket-128 ViT-S/16 forward at 224², "
                   f"{dtype} (25,088 rows a site)",
            "bucket1": {"per": "one bucket-1 forward (196 rows a site)",
                        **site_times(dtype, 4, "serve_b1", "apply")}})
    base = {row["path"] + "/" + row["name"]: row for row in rows}
    for path, carried, launches, per in (
            ("visda_train", "train", r["visda_launches"],
             "the 11 whitened sites of one ResNet101-DWT train step (VisDA-2017, 12 "
             "classes), one launch per site for its 3 domains, 18 images per stream at 224²"),
            ("resnet152_train", "train", r["resnet152_launches"],
             "the 11 whitened sites of one ResNet152-DWT train step, one launch per site "
             "for its 3 domains, 18 images per stream at 224²")):
        for part in ("apply", "moments"):
            out.append({**base[f"{carried}/whiten_{part}"], "launches": launches[part],
                        "path": path, "per": per, "carried_from": carried})
    out.append(served_apply_row(
        VISDA_SERVE_SITES, r["visda_serve_parity"], r["visda_serve_timing"],
        r["visda_serve_launches"], floor, "visda_serve",
        f"the 11 whitened sites of the served ResNet101's bucket-{SERVED_IMAGES} "
        f"forward at 224² (its one request of {SERVED_IMAGES} images)"))
    return out


def group_rows(r, floor):
    """The contract line's rows of the group sizes ``GROUP_TIMED``, per
    kernel, dtype and g: the times summed over one flagship train step's
    11 launches and the largest error against the plain version over
    those sites (``group_timing``), and the launches of the
    ``group_train`` run at that dtype and g."""
    rows = []
    for (part, dtype, g), sites in sorted(r["group_timing"].items(),
                                          key=lambda kv: (kv[0][1], kv[0][2], kv[0][0])):
        timed = [(sites[name], n) for name, _, _, n in TRAIN_SITES]
        total = lambda key: sum(t[key] * n for t, n in timed)
        bf16 = dtype == "bfloat16"
        short = "bf16" if bf16 else "f32"
        bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
        rows.append({
            "name": f"whiten_{part}" + ("_bf16" if bf16 else ""), "route": "cuda",
            "source": f"dwt_tpu_torch/csrc/whiten_{part}.cu",
            "replaces": ("dwt_tpu/ops/pallas_whitening.py:143" if part == "apply"
                         else "dwt_tpu/ops/pallas_whitening.py:68"),
            "group_size": g,
            "launches": r["group_train_launches"][(short, g)][part],
            "launches_from": f"group_train_{short}_g{g}",
            "max_abs_err": max(t["max_abs_err"] for t, _ in timed), "ms": total("device_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "f32_fma_ms": total("f32_fma_ms"),
            "bytes": total("bytes"),
            "library_ms": total("library_ms"),
            "library_device_ms": total("library_device_ms"),
            "host_us": total("host_us"), **(floor if part == "apply" else {}),
            "path": f"train_{short}_g{g}",
            "per": f"the 11 whitened sites of one ResNet50 train step at group size {g}, "
                   f"one launch per site for its 3 domains, 18 images per stream at 224²"})
    return rows


# ---------------------------------------------------- the serving plane


ADAPT_BATCH = 32  # --adapt_batch: images per collect forward, tiled into 3 domains
ADAPT_SITES = tuple((name, ADAPT_BATCH * m // 18, c, n) for name, m, c, n in TRAIN_SITES)
ADAPT_FLAGS = ["--buckets", "1,8,32", "--adapt_every", "0.01", "--adapt_min_samples",
               str(2 * ADAPT_BATCH), "--adapt_batch", str(ADAPT_BATCH),
               "--rollback_decide_s", "600"]
ADAPT_DRIFT = {"at_request": 0, "offset": 0.5, "scale": 1.3}  # serve_drift_shift
ADAPT_REQUESTS = 4  # requests of ADAPT_BATCH shifted images
# The collect forward through the kernels against the same collect through
# their plain versions, per stat tensor: max |kernel − plain| over max
# |plain − input stats|, the error relative to the batch's own update (the
# EMA's momentum does not dilute it).  The whitened sites' mean and cov,
# which the moments kernel computes, and the other stats (the BN sites
# downstream, which see the kernels' rounding through the network), each
# about 10× the worst reading of tools/torch_collect_sensitivity.py over
# seeds 2/12/22/32/42, 3 batches each (1.16e-6 and 3.17e-5).
COLLECT_SITE_TOL = 1e-5
COLLECT_TOL = 3e-4
INT8_BAND = 0.75  # int8 argmax agreement with f32 (tests/test_int8_serve.py)
INT8_IMAGES = 32
INT8_SITES = tuple((name, m * INT8_IMAGES // 128, c, n) for name, m, c, n in RESNET50_SITES)
SWAP_IMAGES = 8  # images per forward of the swapped generation
SWAP_SITES = tuple((name, m * SWAP_IMAGES // 128, c, n) for name, m, c, n in RESNET50_SITES)
SWAP_FLAGS = ["--buckets", "1,8", "--watch", "--reload_poll_s", "0.2",
              "--rollback_min_requests", "8", "--rollback_decide_s", "600",
              # Latency is not this phase's trip: the trainer shares the card
              # with the server while the first swap lands.
              "--rollback_p99_factor", "1000"]
SWAP_WAIT_S = 180


def f32_site_parity(torch, cw, name, x):
    """Both f32 kernels at a collect site ``x [D, M, C]``: one launch
    each, the moments within phase 5's tolerances of the plain version and
    of a float64 two-pass reference, the apply (whitening each domain with
    its own moments) within ``TOL`` of its plain version.  Returns ``(row,
    mean, w)``."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    before = cw.moments_launches
    mean, cov = cw.whiten_moments(x, 4)
    launches = cw.moments_launches - before
    w = whitening_matrix(_shrink(cov, 1e-3))
    pm, pc, p_ok = moments_errors(torch, mean, cov, *cw.whiten_moments_plain(x, 4))
    rm, rc, r_ok = moments_errors(torch, mean, cov, *two_pass_f64(torch, x))
    a_row = apply_parity(torch, cw, name, x, mean, w)
    row = {"shape": name, "D": x.shape[0], "M": x.shape[1], "C": x.shape[2],
           "launches": {"moments": launches, "apply": a_row["launches"]},
           "moments_vs_plain": {"mean_max_abs_err": pm, "cov_max_abs_err": pc},
           "moments_vs_f64_two_pass": {"mean_max_abs_err": rm, "cov_max_abs_err": rc},
           "apply_vs_plain": {"max_abs_err": a_row["max_abs_err"]},
           "mean_tol": MEAN_TOL, "cov_rtol": COV_RTOL, "cov_atol": COV_ATOL, "tol": TOL}
    row["ok"] = p_ok and r_ok and a_row["ok"] and launches == 1
    return row, mean, w


def adapt_kernels(torch, cw, device, rate):
    """Phases ``adapt_kernels`` / ``adapt_timing``: both kernels, f32 and
    bf16, at the 11 site shapes of a collect forward (``--adapt_batch 32``
    tiled into 3 domains at 224²: the stem ``[3, 401,408, 64]``, stage 1
    ``[3, 100,352, 64]`` and ``[3, 100,352, 256]``) against their plain
    versions (and the moments against float64), then timed with L2 cold
    beside the bound, the plain version and the library call."""
    gen = torch.Generator(device=device).manual_seed(21)
    parity, timing = [], {}
    for dtype in ("f32", "bf16"):
        for name, m, c, _ in ADAPT_SITES:
            if dtype == "f32":
                x = moments_input(torch, DOMAINS, m, c, gen, device)
                row, mean, w = f32_site_parity(torch, cw, name, x)
            else:
                x = bf16_site(torch, DOMAINS, m, c, gen, device)
                row, mean, w = bf16_parity(torch, cw, name, x)
            row["dtype"] = dtype
            parity.append(row)
            emit({"phase": "adapt_kernels", **row})
            if not row["ok"]:
                raise AssertionError(f"a kernel disagrees at the collect site {name} "
                                     f"({dtype}): {row}")
            if dtype == "f32":
                t = {"moments": time_moments(torch, cw, x, rate),
                     "apply": time_apply(torch, cw, x, mean, w, rate)}
            else:
                t = {part: time_bf16(torch, cw, part, x, mean, w, rate)
                     for part in ("moments", "apply")}
            timing[(dtype, name)] = t
            emit({"phase": "adapt_timing", "dtype": dtype, "shape": name, **t})
            del x
            torch.cuda.empty_cache()
    per_batch = {
        dtype: {part: {key: sum(timing[(dtype, name)][part][key] * n
                                for name, _, _, n in ADAPT_SITES)
                       for key in ("device_ms", "plain_ms", "bound_ms", "library_ms")}
                for part in ("moments", "apply")}
        for dtype in ("f32", "bf16")}
    emit({"phase": "adapt_timing", "per": "one collect batch: 11 sites, one launch "
          "each per kernel for the 3 domains", "per_batch": per_batch,
          "card": nvidia_smi()})
    return parity, timing


def serving_stack(server, args):
    """The server CLI's own wiring of ``args`` in this process
    (``server.build_stack``: engine, access log, client, deploy
    controller, reloader, adapter, HTTP front; nothing started) and an
    HTTP client of its front."""
    stack = server.build_stack(args)
    return stack, server.HttpServeClient(args.host, stack.front.port, timeout=300)


def served_args(server, *flags):
    return server.build_parser().parse_args(
        SERVED["resnet50"]["flags"] + list(flags) + ["--host", "127.0.0.1", "--port", "0"])


def lifecycle(path):
    """The deploy lifecycle events of an access-log file, in order."""
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["kind"] != "access"]


def single_version_batches(path):
    """Every access record's batch carries one version: ``{batch_seq:
    version}``, raising on a mixed batch."""
    seen = {}
    with open(path) as f:
        for rec in map(json.loads, f):
            if rec["kind"] == "access" and "batch_seq" in rec:
                if seen.setdefault(rec["batch_seq"], rec["version"]) != rec["version"]:
                    raise AssertionError(f"batch {rec['batch_seq']} mixed versions")
    return seen


def int8_serve(torch, cw, server, loop, officehome, a_dir, a_step, device, rate):
    """Phase ``int8_serve``: the server CLI with ``--quantize_int8`` on run
    A's checkpoint answers 32 test images as ``.npy``: 11 apply launches
    for the forward, every resident parameter int8 with an f32 scale,
    finite logits whose argmax agrees with the f32 server's on the same
    checkpoint for at least ``INT8_BAND`` of the images; the bucket-32
    forward through the kernel against the same forward through the plain
    apply; forward ms of the int8 and the f32 engine per bucket, in turns;
    ``int8_serve_parity`` / ``int8_serve_timing``: the apply at that
    bucket-32 forward's site shapes (``INT8_SITES``).  Returns ``(launches,
    parity rows, {site: timing row})``."""
    import numpy as np

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(CKPT_FLAGS))
    images = loop._synthetic_classification_arrays(
        cfg.synthetic_size, (cfg.img_crop_size,) * 2 + (3,), cfg.num_classes,
        cfg.seed + 2, 0.5)[0][:INT8_IMAGES].astype(np.float32)
    flags = ["--ckpt_dir", a_dir, "--buckets", "1,8,32,128"]
    f32 = server.build_engine(served_args(server, *flags))
    args = served_args(server, *flags, "--quantize_int8")
    stack, http = serving_stack(server, args)
    engine = stack.engine
    try:
        cw.apply_launches = 0
        logits = http.infer(images, binary=True)
        launches, batches = cw.apply_launches, stack.client.batches
    finally:
        http.close()
        stack.front.close()
    st = engine.state
    resident = {}
    for t in st.params.values():
        resident[str(t.dtype)] = resident.get(str(t.dtype), 0) + t.numel() * t.element_size()
    ref = f32.infer(images)
    agree = float((logits.argmax(-1) == ref.argmax(-1)).mean())
    x32 = engine.stage(images)
    with torch.inference_mode():
        kernel_logits = engine.forward(x32, 32).clone()
        kernel_fn, cw.whiten_apply = cw.whiten_apply, cw.whiten_apply_plain
        try:
            plain_logits = engine.forward(x32, 32)
        finally:
            cw.whiten_apply = kernel_fn
    kernel_vs_plain = norm_err(kernel_logits, plain_logits)
    per_bucket = {}
    for b in engine.buckets:
        xb = engine.stage(np.zeros((b,) + SERVED["resnet50"]["shape"], np.float32))
        per_bucket[b] = {
            "int8_forward_ms": cuda_ms(torch, lambda: engine.forward(xb, b), iters=10,
                                       warmup=2),
            "f32_forward_ms": cuda_ms(torch, lambda: f32.forward(xb, b), iters=10,
                                      warmup=2)}
    emit({"phase": "int8_serve", "engine_step": engine.step, "quantize": engine.quantize,
          "batches_by_bucket": batches, "apply_launches": launches,
          "resident_param_bytes": resident,
          "f32_param_bytes": sum(t.numel() * t.element_size()
                                 for t in f32.state.params.values()),
          "scale_dtypes": sorted({str(s.dtype) for s in st.scales.values()}),
          "argmax_agreement": agree, "band": INT8_BAND,
          "int8_vs_f32": norm_err(torch.from_numpy(logits), torch.from_numpy(ref)),
          "kernel_vs_plain_bucket32": kernel_vs_plain, "tolerance": FORWARD_TOL,
          "per_bucket": per_bucket, "card": nvidia_smi()})
    if engine.step != a_step or not engine.quantize or set(resident) != {"torch.int8"}:
        raise AssertionError(f"the int8 engine holds {resident} at step {engine.step}")
    if {str(s.dtype) for s in st.scales.values()} != {"torch.float32"}:
        raise AssertionError("int8 scales are not f32")
    if batches != {32: 1} or launches != SERVED["resnet50"]["sites"]:
        raise AssertionError(f"{launches} apply launches for {batches}")
    if not np.isfinite(logits).all() or agree < INT8_BAND or kernel_vs_plain > FORWARD_TOL:
        raise AssertionError(f"int8 serving off its bands: agreement {agree}, kernel vs "
                             f"plain {kernel_vs_plain}")
    del f32, x32, kernel_logits, plain_logits
    torch.cuda.empty_cache()
    return (launches, *served_apply_sites(torch, cw, INT8_SITES, 43, device, rate,
                                          "int8_serve"))


def write_nan_checkpoint(torch, src, dst, step):
    """A digest-valid checkpoint at ``dst/<step>`` with ``src``'s payload
    and NaN parameters (``save_state`` refuses to write one)."""
    from dwt_tpu_torch.utils import checkpoint as ckpt

    payload, _ = ckpt.read_payload(src)
    names = [k for k in payload["model"] if not k.endswith(
        (".mean", ".cov", ".var", ".count", ".w"))]
    for k in names:
        payload["model"][k] = torch.full_like(payload["model"][k], float("nan"))
    payload["step"] = step
    tmp = os.path.join(dst, f".tmp-nan-{step}")
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, ckpt.STATE_FILE))
    ckpt._write_manifest(tmp, step, ckpt.params_digest((n, payload["model"][n]) for n in names),
                         {"format": ckpt.TORCH_FORMAT})
    os.replace(tmp, os.path.join(dst, str(step)))


def wait_for(predicate, what, timeout=SWAP_WAIT_S):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def hot_swap(torch, cw, server, officehome, loop, root, a_dir, device, rate):
    """Phase ``hot_swap``: the server with ``--watch`` on a directory that
    holds run A's step-3 checkpoint, under a steady load of 1- and 5-image
    requests, while the trainer (phase 18's flags on that directory)
    resumes at 3 and writes step 6.  Checks: the watcher swaps 6 in, no
    request fails, every reply names one generation (3's or 6's) and every
    batch's access records carry one version; the swapped generation's
    forwards launch the apply kernel 11 times each.  Then a digest-valid
    checkpoint with NaN weights (step 9) is refused by the canary, and a
    good one (step 12) goes live, is made to serve errors and is rolled
    back to 6.  ``hot_swap_parity`` / ``hot_swap_timing``: the apply at
    the bucket-8 forward's site shapes (``SWAP_SITES``).  Returns
    ``(launches, parity rows, {site: timing row})``."""
    import shutil
    import threading

    import numpy as np

    from dwt_tpu_torch.utils import checkpoint as ckpt

    watched = os.path.join(root, "watched")
    os.makedirs(watched)
    shutil.copytree(os.path.join(a_dir, "3"), os.path.join(watched, "3"))
    log_path = os.path.join(root, "swap_access.jsonl")
    args = served_args(server, "--ckpt_dir", watched, "--access_log", log_path,
                       *SWAP_FLAGS)
    stack, http = serving_stack(server, args)
    engine, access_log, client, controller, reloader, front = (
        stack.engine, stack.access_log, stack.client, stack.controller, stack.reloader,
        stack.front)
    reloader.start()
    v3 = engine.version.label
    rng = np.random.default_rng(3)
    shape = SERVED["resnet50"]["shape"]
    load_inputs = [rng.normal(size=(n,) + shape).astype(np.float32) for n in (1, 5)]
    replies, failures, stop = [], [], threading.Event()

    def load():
        client_http = server.HttpServeClient(args.host, front.port, timeout=300)
        try:
            for i in itertools.count():
                if stop.is_set():
                    return
                x = load_inputs[i % 2]
                try:
                    reply = client_http.infer_reply(x, binary=True)
                    out = np.asarray(reply["logits"], np.float32)
                    if out.shape != (len(x), SERVED["resnet50"]["classes"]) or \
                            not np.isfinite(out).all():
                        failures.append(f"bad reply {out.shape}")
                    replies.append(reply["version"])
                except Exception as e:  # every failure is counted
                    failures.append(f"{type(e).__name__}: {e}")
        finally:
            client_http.close()

    loader = threading.Thread(target=load)
    t0 = time.perf_counter()
    try:
        loader.start()
        cfg = officehome.config_from_args(officehome.build_parser().parse_args(
            CKPT_FLAGS + ["--ckpt_dir", watched]))
        trained = []
        loop.run_officehome(cfg, lambda kind, step, **f: trained.append((kind, step)))
        train_s = time.perf_counter() - t0
        wait_for(lambda: engine.version.step == cfg.num_iters, "the swap to step 6")
        swap_s = time.perf_counter() - t0
        served_before = len(replies)
        wait_for(lambda: len(replies) >= served_before + 10, "requests on step 6")
        stop.set()
        loader.join(60)
        v6 = engine.version.label
        # The swapped generation's forwards, the load stopped.
        x8 = rng.normal(size=(SWAP_IMAGES,) + shape).astype(np.float32)
        cw.apply_launches = 0
        before = dict(client.batches)
        for _ in range(3):
            if http.infer_reply(x8, binary=True)["version"] != v6:
                raise AssertionError("a reply after the swap names another version")
        launches = cw.apply_launches
        forwards = sum(client.batches.values()) - sum(before.values())
        # A candidate with NaN weights: refused by the canary.
        write_nan_checkpoint(torch, os.path.join(watched, str(cfg.num_iters)), watched, 9)
        wait_for(lambda: any(k[0] == 9 for k in reloader.rejected), "the NaN refusal")
        nan_reason = next(v for k, v in reloader.rejected.items() if k[0] == 9)
        version_after_nan = engine.version.label
        # A good candidate that regresses once live: rolled back.
        payload, _ = ckpt.read_payload(os.path.join(watched, str(cfg.num_iters)))
        names = tuple(n for n in payload["model"] if not n.endswith(
            (".mean", ".cov", ".var", ".count", ".w")))
        for n in names:
            payload["model"][n] = payload["model"][n] * (1 + 1e-3)
        ckpt.save_state(watched, 12, ckpt.HostState({**payload, "step": 12}, names))
        wait_for(lambda: engine.version.step == 12, "the swap to step 12")
        v12 = engine.version.label
        for _ in range(args.rollback_min_requests):
            access_log.record("error", 1, version=v12, error="forced post-swap regression")
        wait_for(lambda: controller.rollback_count == 1, "the rollback")
        rolled_to = engine.version.label
    finally:
        stop.set()
        loader.join(60)
        reloader.stop()
        http.close()
        front.close()
        access_log.close()
    events = lifecycle(log_path)
    batch_versions = single_version_batches(log_path)
    kinds = [e["kind"] for e in events]
    emit({"phase": "hot_swap", "versions": {"boot": v3, "trained": v6, "regressed": v12,
                                            "rolled_back_to": rolled_to},
          "train_s": train_s, "swap_after_s": swap_s, "trainer_records": len(trained),
          "replies": len(replies), "replies_by_version": {
              v: replies.count(v) for v in sorted(set(replies))},
          "failures": failures[:5], "batches": len(batch_versions),
          "batch_versions": sorted(set(batch_versions.values())),
          "apply_launches_after_swap": launches, "forwards_after_swap": forwards,
          "nan_refusal": nan_reason, "events": kinds,
          "swap_count": controller.swap_count, "rollback_count": controller.rollback_count})
    if failures or set(replies) != {v3, v6} or set(batch_versions.values()) - {v3, v6, v12}:
        raise AssertionError(f"hot swap under load: {len(failures)} failures, replies on "
                             f"{set(replies)}")
    if launches != SERVED["resnet50"]["sites"] * forwards or forwards != 3:
        raise AssertionError(f"{launches} apply launches for {forwards} forwards")
    if "non-finite" not in nan_reason or version_after_nan != v6:
        raise AssertionError(f"the NaN candidate: {nan_reason}, live {version_after_nan}")
    if rolled_to != v6 or "rollback" not in kinds or kinds.count("swap") != 2:
        raise AssertionError(f"the regressed candidate: live {rolled_to}, events {kinds}")
    return (launches, *served_apply_sites(torch, cw, SWAP_SITES, 44, device, rate,
                                          "hot_swap"))


def worst_collect_errors(errs, sites):
    """The worst of ``collect_errors``'s readings over the whitened sites'
    stats (``sites``: their module names) and over the other stats:
    ``{"whitened": {...}, "other": {...}}``, each its stat and error."""
    out = {}
    for part, keep in (("whitened", True), ("other", False)):
        some = {k: v for k, v in errs.items() if (k.rpartition(".")[0] in sites) == keep}
        k = max(some, key=some.get)
        out[part] = {"stat": k, "err": some[k]}
    return out


def collect_errors(before, got, ref):
    """Per stat tensor of one collect batch: max |got − ref| over max |ref
    − before| (float64), ``got`` the collect through the kernels, ``ref``
    the same collect through their plain versions, ``before`` the stats
    both started from; the error relative to the batch's own update.  A
    tensor the batch does not move must come out equal (0, else inf)."""
    errs = {}
    for k, b in before.items():
        b, g, r = (t.detach().double().cpu() for t in (b, got[k], ref[k]))
        step, diff = float((r - b).abs().max()), float((g - r).abs().max())
        errs[k] = diff / step if step > 0 else (0.0 if diff == 0 else float("inf"))
    return errs


def adapt_serve(torch, cw, server, inject, root, a_dir):
    """Phase ``adapt_serve``: the server with ``--adapt_every`` on run A's
    checkpoint, a seeded canary fixture (``--canary_fixture``, 8 images),
    and 4 requests of 32 images shifted by ``serve_drift_shift``.  The
    phase drives the adapter's iterations itself, one after each request,
    so that each collect batch's launches are read alone.  Checks: the
    lifecycle (a thin window, then ``adapt_build``, ``adapt_canary``,
    ``adapt_swap``), 11 moments and 11 apply launches per collect batch,
    each collect batch's output stats against the same collect (same
    generation, input stats and images) with both kernels swapped for
    their plain versions (``collect_errors``: the whitened sites' stats
    within ``COLLECT_SITE_TOL``, the others within ``COLLECT_TOL``), the
    adapted generation's stats bitwise the fold of the window the kernels
    collected, and ``/metrics`` valid with ``dwt_serve_domain_shift`` > 0."""
    import numpy as np

    from dwt_tpu_torch.nn.norms import whitening_sites
    from dwt_tpu_torch.obs import prom
    from dwt_tpu_torch.serve.adapt import make_collect_fn

    rng = np.random.default_rng(7)
    shape = SERVED["resnet50"]["shape"]
    fixture = os.path.join(root, "canary_fixture.npz")
    np.savez(fixture, x=rng.normal(size=(8,) + shape).astype(np.float32))
    log_path = os.path.join(root, "adapt_access.jsonl")
    args = served_args(server, "--ckpt_dir", a_dir, "--canary_fixture", fixture,
                       "--access_log", log_path, *ADAPT_FLAGS)
    stack, http = serving_stack(server, args)
    engine, adapter = stack.engine, stack.adapter
    base = engine.state
    collected = []
    collect = adapter._collect

    def counted(state, stats, x):
        before = (cw.moments_launches, cw.apply_launches)
        inputs = {k: v.clone() for k, v in stats.items()}
        out = collect(state, stats, x)
        torch.cuda.synchronize()
        collected.append({"moments": cw.moments_launches - before[0],
                          "apply": cw.apply_launches - before[1], "x": x.copy(),
                          "state": state, "in": inputs,
                          "out": {k: v.clone() for k, v in out.items()}})
        return out

    adapter._collect = counted
    inject.arm(inject.FaultPlan.from_spec({"serve_drift_shift": ADAPT_DRIFT}))
    verdicts, finite = [], True
    try:
        cw.moments_launches = cw.apply_launches = 0
        for i in range(ADAPT_REQUESTS):
            x = inject.maybe_shift_request(
                i, rng.normal(size=(ADAPT_BATCH,) + shape).astype(np.float32))
            out = http.infer(x, binary=True)
            finite = finite and bool(np.isfinite(out).all())
            wait_for(lambda: adapter._queue_samples >= ADAPT_BATCH, "the batch hook")
            verdicts.append(adapter.step())
        moments_total = cw.moments_launches
        text = http.metrics()
        stats = http.stats()
    finally:
        inject.disarm()
        http.close()
        stack.front.close()
        stack.access_log.close()
    adapted = engine.state
    # Each collect batch again, both kernels swapped for their plain versions.
    plain_collect = make_collect_fn(engine)
    kernels = (cw.whiten_moments, cw.whiten_apply)
    cw.whiten_moments, cw.whiten_apply = cw.whiten_moments_plain, cw.whiten_apply_plain
    try:
        refs = [plain_collect(c["state"], c["in"], c["x"]) for c in collected]
    finally:
        cw.whiten_moments, cw.whiten_apply = kernels
    sites = set(whitening_sites(base.model))
    per_collect = [worst_collect_errors(collect_errors(c["in"], c["out"], ref), sites)
                   for c, ref in zip(collected, refs)]
    # The fold of the window the kernels collected (2 batches from the
    # base generation's stats), as the adapter folds: float64, cast back.
    m = adapter._effective_momentum()
    fold_diff = 0.0
    for k, live in base.batch_stats.items():
        a = live.cpu().numpy()
        want = (a + m * (collected[1]["out"][k].cpu().numpy().astype(np.float64) - a)
                ).astype(a.dtype)
        fold_diff = max(fold_diff, float(np.abs(
            adapted.batch_stats[k].cpu().numpy().astype(np.float64) - want).max()))
    chained = all(torch.equal(collected[1]["in"][k], collected[0]["out"][k])
                  and torch.equal(collected[0]["in"][k], v)
                  for k, v in base.batch_stats.items())
    problems = prom.validate_exposition(text)
    shift = prom.parse_exposition(text)["dwt_serve_domain_shift"].samples[0][2]
    kinds = [e["kind"] for e in lifecycle(log_path)]
    per_batch = [{k: c[k] for k in ("moments", "apply")} for c in collected]
    worst = {part: max(p[part]["err"] for p in per_collect)
             for part in ("whitened", "other")}
    emit({"phase": "adapt_serve", "verdicts": verdicts, "events": kinds,
          "base_version": base.version.label, "adapted_version": adapted.version.label,
          "collect_batches": len(collected), "launches_per_collect_batch": per_batch,
          "moments_launches": moments_total, "momentum": m,
          "collect_vs_plain": per_collect,
          "collect_tolerance": {"whitened": COLLECT_SITE_TOL, "other": COLLECT_TOL},
          "window_chained": chained, "adapted_vs_fold_max_abs": fold_diff,
          "domain_shift": shift, "metrics_problems": problems[:5],
          "adaptation": stats["adaptation"], "logits_finite": finite})
    if verdicts[:2] != ["thin_window", "swapped"] or adapted is base or \
            adapted.version.label == base.version.label:
        raise AssertionError(f"adaptation verdicts {verdicts}")
    if kinds[:4] != ["adapt_build", "adapt_build", "adapt_canary", "adapt_swap"]:
        raise AssertionError(f"adaptation lifecycle {kinds}")
    want = {"moments": WHITENED_SITES, "apply": WHITENED_SITES}
    if len(collected) != ADAPT_REQUESTS or any(p != want for p in per_batch) \
            or moments_total != WHITENED_SITES * len(collected):
        raise AssertionError(f"collect launches {per_batch}, {moments_total} in all")
    if worst["whitened"] > COLLECT_SITE_TOL or worst["other"] > COLLECT_TOL:
        raise AssertionError(f"a collect batch off its plain twin: {per_collect}")
    if not chained or fold_diff != 0.0:
        raise AssertionError(f"the adapted stats are not the fold of the collected "
                             f"window (chained {chained}, max diff {fold_diff})")
    if problems or not shift > 0 or not finite:
        raise AssertionError(f"metrics {problems}, shift {shift}, finite {finite}")
    return {"moments": moments_total, "apply": sum(p["apply"] for p in per_batch)}, worst


# ------------------------------------------------------------ the fleet

# The fleet phases run one fleet process (``python -m dwt_tpu_torch.fleet.
# balancer``) over run A's checkpoint: two replicas at first, a third when
# the ramp's pressure holds, back to two when idle.  The autoscaled replica
# (rid 2) is the straggler: its dispatcher sleeps FLEET_SLOW_S a batch.
FLEET_BUCKETS = "1,8,32"
FLEET_DEVICE = "cuda"
FLEET_SLOW_RID, FLEET_SLOW_S = 2, 0.3
FLEET_FLAGS = ["--replicas", "2", "--respawn_max", "2", "--respawn_backoff_s", "0.2",
               "--health_interval_s", "0.3", "--min_replicas", "2", "--max_replicas", "3",
               "--scale_interval_s", "0.5", "--scale_pressure", "6",
               "--scale_pressure_for_s", "2", "--scale_idle", "0.1",
               "--scale_idle_for_s", "5", "--scale_cooldown_s", "3"]
FLEET_REQUESTS = (1, 8)  # images per seeded request, to each first replica
FLEET_LOAD = (1.0, 15.0)  # the light open load around the SIGKILL: req/s, seconds
FLEET_KILL_AFTER_S = 2.0
FLEET_MEMORY_SLACK = 1.10  # the card's memory after a respawn, against before
# One replica's sustained rate: its completions per second with
# FLEET_SATURATE_CLIENTS closed-loop clients for FLEET_SATURATE_S.  A request
# waits in the replica's HTTP threads (the JSON decoding), never in its
# batcher's bounded queue, so no offered rate sheds: the rate it sustains with
# shed_rate 0 is the rate it completes when saturated.  12 clients queue at
# most 12 images, 6 a replica over the fleet's 2: never above --scale_pressure
# 6, so the probe cannot scale the fleet up.  (With 16, one run in four did:
# the straggler, replica 2, spawned then, was retired idle before the ramp.)
FLEET_SATURATE_CLIENTS = 12
FLEET_SATURATE_S = 5.0
FLEET_EXTRA_LEVELS = 3  # 3× levels after the ramp while no scale-up has landed
# The balancer against one replica: one client, one request at a time,
# alternately through the balancer and straight to replica 0,
# FLEET_COMPARE_REQUESTS each way (no load to queue behind, no scale event).
FLEET_COMPARE_REQUESTS = 300
FLEET_RAMP_STEP_S = 8.0  # 4 levels: the scale-up lands inside the ramp
FLEET_WAIT_S = 180


def gpu_apps():
    """``{pid: MiB}`` of the processes holding the card, as ``nvidia-smi
    --query-compute-apps`` reports them.  Where the processes run in a pid
    namespace of their own, every one reads as pid 1, so the phases record
    this and hold processes to :func:`cuda_context`."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, mib = (v.strip() for v in line.split(","))
        apps[int(pid)] = float(mib)
    return apps


def cuda_context(pid):
    """Whether process ``pid`` holds a CUDA context: a descriptor open on
    an NVIDIA device node (``/dev/nvidia*``, which a context keeps open)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def gpu_memory_used():
    """MiB in use on the card (``nvidia-smi --query-gpu=memory.used``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def http_json(port, path="/healthz", body=None, timeout=120):
    """One request to ``127.0.0.1:port``: ``(status, parsed body,
    headers)``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        text = data.decode()
        parsed = json.loads(text) if text.startswith("{") else text
        return resp.status, parsed, dict(resp.getheaders())
    finally:
        conn.close()


def serve_bench_tool():
    """``tools/torch_serve_bench.py`` as a module (its ``run_ramp``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_serve_bench", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "tools", "torch_serve_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def saturate(port, shape, seconds=FLEET_SATURATE_S, clients=FLEET_SATURATE_CLIENTS):
    """``clients`` closed-loop clients sending 1-image requests to ``port``
    for ``seconds``: completions per second, their p50/p99 ms, and the
    requests that got another answer than 200 or none (a dropped
    connection: the client opens a new one)."""
    import http.client

    import numpy as np

    # The ramp's payload (``run_ramp``: seeded normal noise): a JSON body's
    # decoding, the replica's cost, grows with the digits of its numbers.
    x = np.random.default_rng(0).normal(size=(1,) + tuple(shape)).astype(np.float32)
    body = json.dumps({"inputs": x.tolist()}).encode()
    deadline = time.perf_counter() + seconds
    done, other, lock = [], [], threading.Lock()

    def client():
        conn = None
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            try:
                conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                conn.request("POST", "/infer", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                status = resp.status
            except (OSError, http.client.HTTPException):
                conn, status = None, None  # a dropped connection: a new one
            with lock:
                (done if status == 200 else other).append(
                    (time.perf_counter(), (time.perf_counter() - t0) * 1e3))
        if conn is not None:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    elapsed = time.perf_counter() - t0
    ms = sorted(v for _, v in done)
    return {"clients": clients, "seconds": elapsed, "completed": len(done),
            "req_per_s": len(done) / elapsed, "not_200_or_dropped": len(other),
            "e2e_ms_p50": ms[len(ms) // 2] if ms else None,
            "e2e_ms_p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))] if ms else None}


def paired_latency(through_port, direct_port, shape, n=FLEET_COMPARE_REQUESTS):
    """One closed-loop client: ``n`` 1-image requests through the balancer
    (``through_port``) and ``n`` straight to a replica (``direct_port``),
    alternating, each on a new connection, the body (``run_ramp``'s seeded
    noise) encoded once.  Each side's p50/p99/mean e2e ms, the median of
    the paired differences (through − direct) and the answers other than
    200."""
    import http.client

    import numpy as np

    x = np.random.default_rng(0).normal(size=(1,) + tuple(shape)).astype(np.float32)
    body = json.dumps({"inputs": x.tolist()}).encode()
    ms = {"through_balancer": [], "direct": []}
    other = 0
    for _ in range(n):
        for side, port in (("through_balancer", through_port), ("direct", direct_port)):
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                conn.request("POST", "/infer", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                other += resp.status != 200
            finally:
                conn.close()
            ms[side].append((time.perf_counter() - t0) * 1e3)
    pct = lambda v, q: sorted(v)[min(len(v) - 1, int(q * len(v)))]
    out = {side: {"p50": pct(v, 0.5), "p99": pct(v, 0.99), "mean": sum(v) / len(v)}
           for side, v in ms.items()}
    diffs = [a - b for a, b in zip(ms["through_balancer"], ms["direct"])]
    return {"requests_a_side": n, **out, "paired_diff_ms_p50": pct(diffs, 0.5),
            "not_200": other}


def replica_counters(replicas):
    """``{rid: (apply launches, moments launches, {bucket: forwards})}``
    from each replica's ``/stats``; a replica retired meanwhile is left
    out."""
    out = {}
    for r in replicas:
        try:
            st = http_json(r["port"], "/stats")[1]
        except OSError:
            continue
        launches = st["kernel_launches"]
        out[str(r["rid"])] = (launches["apply"], launches["moments"],
                              {int(b): n for b, n in st["batches_by_bucket"].items()})
    return out


def ramp_level(bench, port, rate, seconds, shape, seed=0):
    """One open-loop level of ``rate`` 1-image requests a second for
    ``seconds`` against ``port`` through the tool's ``run_ramp``: its
    ``serve_ramp`` record and ``elapsed_s`` (until the last reply)."""
    import argparse

    args = argparse.Namespace(
        target_url=f"http://127.0.0.1:{port}", ramp=f"{rate}:{rate}:{seconds}",
        input_shape=",".join(map(str, shape)), request_n=1, seed=seed, ramp_workers=32)
    t0 = time.perf_counter()
    record = bench.run_ramp(args)
    record["elapsed_s"] = time.perf_counter() - t0
    return record


class FleetEvents:
    """The fleet's stdout after its ready line, read on a thread: the
    autoscaler's ``scale_*`` events and the ``fleet_summary``, each with
    the host clock it arrived at."""

    def __init__(self, proc):
        self.events = []
        self.thread = threading.Thread(target=self._read, args=(proc,), daemon=True)
        self.thread.start()

    def _read(self, proc):
        for line in proc.stdout:
            if line.startswith("{"):
                self.events.append({**json.loads(line), "t": time.perf_counter()})

    def of(self, kind):
        return [e for e in list(self.events) if e["kind"] == kind]


def fleet_sites(bucket):
    """The 11 whitened sites of one ResNet50 forward at ``bucket`` images,
    224² (``RESNET50_SITES`` scaled from bucket 128)."""
    return tuple((name, m * bucket // 128, c, n) for name, m, c, n in RESNET50_SITES)


def fleet_serve_flags(a_dir):
    return (SERVED["resnet50"]["flags"] + ["--ckpt_dir", a_dir, "--buckets", FLEET_BUCKETS,
                                           "--device", FLEET_DEVICE])


def start_fleet(a_dir):
    """The fleet process on run A's checkpoint: ``(proc, ready line,
    events, seconds to the ready line)``.  Its replicas start from its
    environment, with the straggler's plan (``replica_slow_at``)."""
    from dwt_tpu_torch.resilience import inject

    env = dict(os.environ)
    env[inject.ENV_VAR] = json.dumps(
        {"replica_slow_at": {"rid": FLEET_SLOW_RID, "sleep_s": FLEET_SLOW_S}})
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dwt_tpu_torch.fleet.balancer", "--port", "0",
         *FLEET_FLAGS, "--", *fleet_serve_flags(a_dir)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    seconds = time.perf_counter() - t0
    if not line:
        raise AssertionError(f"the fleet exited before ready: {proc.stderr.read()[-3000:]}")
    ready = json.loads(line)
    return proc, ready, FleetEvents(proc), seconds


def fleet_phase(torch, server, a_dir, proc, ready, ready_s, card_before):
    """Phase ``fleet``: the fleet's two replicas on the card (each
    ``/healthz`` reports ``cuda`` and each process holds a CUDA context,
    the balancer none: :func:`cuda_context`; the card's memory in
    ``nvidia-smi`` grew by the replicas', ``card_before`` against after
    the fleet started); seeded 1- and 8-image requests through
    the balancer, to each replica, held to the in-process engine on the
    same checkpoint (``FORWARD_TOL`` of the logits' scale, argmax equal);
    under a light open load (the tool's ramp at ``FLEET_LOAD``) replica 0
    is SIGKILLed: ejected, respawned (``dwt_fleet_respawns_total{rid="0"}
    1``), serving again, no request without an answer, its memory back
    (the card's within ``FLEET_MEMORY_SLACK``); the merged ``/metrics``
    valid.  Returns the row, with the replicas' forwards."""
    import numpy as np

    from dwt_tpu_torch.obs import prom

    port = ready["port"]
    replicas = {r["rid"]: r for r in ready["replicas"]}
    devices = {rid: http_json(r["port"])[1]["device"] for rid, r in replicas.items()}
    apps = gpu_apps()
    contexts = {rid: cuda_context(r["pid"]) for rid, r in replicas.items()}
    balancer_context = cuda_context(proc.pid)
    card_fleet = gpu_memory_used()
    allocator = {rid: http_json(r["port"], "/stats")[1].get("device_memory")
                 for rid, r in replicas.items()}
    if not all(d.startswith(FLEET_DEVICE) for d in devices.values()):
        raise AssertionError(f"fleet replicas not on the card: {devices}")
    if not all(contexts.values()) or balancer_context:
        raise AssertionError(f"CUDA contexts: replicas {contexts}, balancer "
                             f"{balancer_context}")
    args = server.build_parser().parse_args(fleet_serve_flags(a_dir))
    engine = server.build_engine(args)
    shape = SERVED["resnet50"]["shape"]
    rng = np.random.default_rng(15)
    replies, worst, answered = [], 0.0, set()
    for n in FLEET_REQUESTS:
        x = rng.normal(size=(n,) + shape).astype(np.float32)
        body = json.dumps({"inputs": x.tolist()}).encode()
        ref = engine.infer(x)
        for _ in replicas:  # ties break round-robin: one to each replica
            status, reply, headers = http_json(port, "/infer", body, timeout=300)
            got = np.asarray(reply["logits"], np.float32)
            err = norm_err(torch.from_numpy(got), torch.from_numpy(ref))
            same = bool((got.argmax(-1) == ref.argmax(-1)).all())
            rid = headers.get("X-DWT-Replica")
            answered.add(rid)
            replies.append({"images": n, "status": status, "replica": rid,
                            "rel_err": err, "argmax_equal": same})
            worst = max(worst, err)
            if status != 200 or err > FORWARD_TOL or not same:
                raise AssertionError(f"fleet reply off the engine: {replies[-1]}")
    if answered != {str(rid) for rid in replicas}:
        raise AssertionError(f"replies came from {answered}, not every replica")
    del engine
    torch.cuda.empty_cache()

    bench = serve_bench_tool()
    used_before = gpu_memory_used()
    victim = replicas[0]["pid"]
    load = {}
    loader = threading.Thread(target=lambda: load.update(ramp_level(
        bench, port, FLEET_LOAD[0], FLEET_LOAD[1], shape)), daemon=True)
    loader.start()
    time.sleep(FLEET_KILL_AFTER_S)
    t_kill = time.perf_counter()
    os.kill(victim, signal.SIGKILL)

    def respawned():
        h = http_json(port)[1]
        r0 = next(r for r in h["replicas"] if r["rid"] == 0)
        return h["healthy_replicas"] == 2 and r0["respawns"] == 1 and r0["healthy"]

    wait_for(respawned, "the SIGKILLed replica's respawn", FLEET_WAIT_S)
    respawn_s = time.perf_counter() - t_kill
    loader.join(timeout=FLEET_WAIT_S)
    health = http_json(port)[1]
    fresh = next(r for r in health["replicas"] if r["rid"] == 0)
    victim_gone = not os.path.exists(f"/proc/{victim}")
    fresh_context = cuda_context(fresh["pid"])
    used_after = gpu_memory_used()
    one = json.dumps({"inputs": rng.normal(size=(1,) + shape).astype(np.float32).tolist()})
    # Through the balancer (the weighted router may favour the survivor),
    # and to the respawned replica directly.
    again = [http_json(port, "/infer", one.encode()) for _ in range(4)]
    direct = http_json(fresh["port"], "/infer", one.encode())
    text = http_json(port, "/metrics")[1]
    problems = prom.validate_exposition(text)
    row = {"phase": "fleet", "card": nvidia_smi(), "flags": FLEET_FLAGS,
           "serve_flags": fleet_serve_flags("<run A>"), "ready_s": ready_s,
           "spawn_to_ready_s_per_replica": ready_s / len(replicas),
           "devices": devices, "replica_pids": {r: v["pid"] for r, v in replicas.items()},
           "balancer_pid": proc.pid, "replica_cuda_context": contexts,
           "balancer_cuda_context": balancer_context,
           "card_memory_mib_fleet": {"before": card_before, "with_fleet": card_fleet,
                                     "per_replica": (card_fleet - card_before)
                                     / len(replicas)},
           "replica_allocator": allocator, "nvidia_smi_apps": apps,
           "replies": replies, "reply_vs_engine": worst,
           "tolerance": FORWARD_TOL, "load": {k: load.get(k) for k in (
               "requests", "served", "ramp_shed_total", "ramp_lost_total",
               "ramp_e2e_ms_p50", "ramp_e2e_ms_p99", "replica_requests")},
           "respawn_s": respawn_s, "victim_pid": victim, "fresh_pid": fresh["pid"],
           "victim_gone": victim_gone, "fresh_cuda_context": fresh_context,
           "card_memory_mib": {"before_kill": used_before, "after_respawn": used_after},
           "served_after_respawn": [(s, h.get("X-DWT-Replica")) for s, _, h in again],
           "respawned_replica_direct": direct[0],
           "metrics_problems": problems,
           "respawns_total": [ln for ln in text.splitlines()
                              if ln.startswith("dwt_fleet_respawns_total")]}
    emit(row)
    if not load or load["ramp_lost_total"] != 0:
        raise AssertionError(f"requests without an answer around the SIGKILL: {load}")
    if not victim_gone or not fresh_context or fresh["pid"] == victim:
        raise AssertionError(f"the respawn on the card: victim {victim} gone {victim_gone}, "
                             f"fresh {fresh['pid']} context {fresh_context}")
    if used_after > used_before * FLEET_MEMORY_SLACK:
        raise AssertionError(f"card memory {used_before} → {used_after} MiB after a respawn")
    if any(s != 200 for s, _, _ in again) or direct[0] != 200 or not fresh["healthy"]:
        raise AssertionError(f"the respawned replica does not serve: {row}")
    if problems or 'dwt_fleet_respawns_total{rid="0"} 1' not in text:
        raise AssertionError(f"merged /metrics: {problems} {row['respawns_total']}")
    return row


def fleet_autoscale(proc, ready, events):
    """Phase ``fleet_autoscale``: one replica's sustained rate of 1-image
    requests (:func:`saturate` on replica 0 directly); the balancer's
    p50/p99 against replica 0's (:func:`paired_latency`, every answer
    200); ``tools/torch_serve_bench.py --target_url … --ramp`` from 0.5× to
    3× the rate: a ``scale_up`` to 3 (the autoscaled replica is the
    straggler), ``ramp_lost_total`` 0; a load at 2× the rate over three
    replicas: the straggler's median reply (3 idle requests straight to
    each replica) at least half its sleep above every peer's, the
    straggler served and nothing lost, each replica's share of the routed
    requests recorded, and the window's apply launches counted by the
    replicas (their ``/stats``), 11 a forward in each; idle, a
    ``scale_down`` to 2 whose ``scale_retired`` rc is 0."""
    port = ready["port"]
    shape = SERVED["resnet50"]["shape"]
    bench = serve_bench_tool()
    direct = http_json(port)[1]["replicas"]
    r0_port = next(r["port"] for r in direct if r["rid"] == 0)
    probes = saturate(r0_port, shape)
    rate = round(probes["req_per_s"], 1)
    if rate <= 0:
        raise AssertionError(f"one replica saturated: {probes}")
    compare = paired_latency(port, r0_port, shape)
    if compare["not_200"]:
        raise AssertionError(f"the balancer against one replica: {compare}")
    if events.of("scale_up"):
        # The ramp's scale-up must spawn the straggler (FLEET_SLOW_RID).
        raise AssertionError(f"scaled before the ramp: {events.of('scale_up')}")
    lo, hi = rate / 2, 3 * rate
    t_ramp = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "tools/torch_serve_bench.py", "--target_url",
         f"http://127.0.0.1:{port}", "--ramp", f"{lo}:{hi}:{FLEET_RAMP_STEP_S}",
         "--input_shape", ",".join(map(str, shape))],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=FLEET_WAIT_S * 2)
    if out.returncode != 0:
        raise AssertionError(f"torch_serve_bench --ramp: {out.stderr[-3000:]}")
    ramp = json.loads(out.stdout.strip().splitlines()[-1])
    emit({"phase": "fleet_ramp", "saturated": probes, "sustained_rate_req_per_s": rate,
          "balancer_against_direct": compare, **ramp})
    # The probe's rate is an estimate: while the scale-up has not landed,
    # hold the ramp's top level longer (recorded, and lost requests counted).
    extra = []
    while (len(extra) < FLEET_EXTRA_LEVELS and not events.of("scale_up")
           and http_json(port)[1]["target_replicas"] < 3):
        extra.append(ramp_level(bench, port, hi, FLEET_RAMP_STEP_S, shape, seed=2 + len(extra)))
    wait_for(lambda: http_json(port)[1]["target_replicas"] == 3
             and http_json(port)[1]["healthy_replicas"] == 3, "the scale-up to 3",
             FLEET_WAIT_S)
    up = events.of("scale_up")
    # Each replica's reply time on its own, idle: 3 requests straight to it.
    three = http_json(port)[1]["replicas"]
    one = json.dumps({"inputs": [[[[0.0] * shape[2]] * shape[1]] * shape[0]]}).encode()
    e2e_p50 = {}
    for r in three:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            http_json(r["port"], "/infer", one)
            times.append((time.perf_counter() - t0) * 1e3)
        e2e_p50[str(r["rid"])] = sorted(times)[1]
    # The window's kernel launches and forwards, counted by the replicas.
    before = replica_counters(three)
    straggle = ramp_level(bench, port, 2 * rate, FLEET_RAMP_STEP_S, shape, seed=1)
    window_end = time.perf_counter()
    after_window = replica_counters(three)
    shares = {rid: n / max(straggle["served"], 1)
              for rid, n in straggle["replica_requests"].items()}
    window = {}
    for rid, (apply_n, moments_n, batches) in after_window.items():
        apply0, moments0, batches0 = before.get(rid, (0, 0, {}))
        window[rid] = {"apply": apply_n - apply0, "moments": moments_n - moments0,
                       "forwards": {b: n - batches0.get(b, 0) for b, n in batches.items()
                                    if n > batches0.get(b, 0)}}
    forwards_by_bucket = collections.Counter()
    for w in window.values():
        forwards_by_bucket.update(w["forwards"])
    after = lambda kind: [e for e in events.of(kind) if e["t"] >= window_end]
    wait_for(lambda: after("scale_retired"), "the idle scale-down", FLEET_WAIT_S)
    down, retired = events.of("scale_down"), events.of("scale_retired")
    row = {"phase": "fleet_autoscale", "card": nvidia_smi(), "saturated": probes,
           "sustained_rate_req_per_s": rate, "ramp": ramp,
           "extra_levels": [{k: e.get(k) for k in ("ramp", "requests", "served",
                                                  "ramp_lost_total", "ramp_e2e_ms_p99")}
                            for e in extra],
           "ramp_scale_lag_s": ramp.get("ramp_scale_lag_s"),
           "scale_up_after_ramp_start_s": (up[-1]["t"] - t_ramp) if up else None,
           "scale_up": [{k: e[k] for k in e if k != "t"} for e in up],
           "scale_down": [{k: e[k] for k in e if k != "t"} for e in down],
           "scale_retired": [{k: e[k] for k in e if k != "t"} for e in retired],
           "spawn_to_ready_s_autoscaled": [e.get("ready_wait_s") for e in up],
           "balancer_against_direct": compare,
           "straggler": {"rid": FLEET_SLOW_RID, "sleep_s": FLEET_SLOW_S,
                         "rate": 2 * rate, "shares": shares,
                         "replica_direct_ms_median": e2e_p50,
                         "lost": straggle["ramp_lost_total"]},
           "pids_at_three": [r["pid"] for r in three], "window_launches": window,
           "window_forwards_by_bucket": dict(forwards_by_bucket)}
    emit(row)
    lost = ramp["ramp_lost_total"] + sum(e["ramp_lost_total"] for e in extra)
    if not up or up[0]["target"] != 3 or lost:
        raise AssertionError(f"the ramp: scale-up {up}, lost {lost}")
    if (not after("scale_down") or after("scale_down")[0]["target"] != 2
            or any(e["rc"] != 0 for e in retired)):
        raise AssertionError(f"the idle scale-down (after the window): {down} {retired}")
    # The straggler is slower in every reply (its dispatcher sleeps each
    # batch), served through the window and lost nothing.  Its share is
    # recorded, not held below its peers': the router's drain-rate weight
    # (1/gap between completions, the JAX design) grows with the straggler's
    # batches, whose replies land together, so it took from 30% to 59% of
    # the window in four runs on an H100 (PERF.md §6).
    slow_id = str(FLEET_SLOW_RID)
    peer_p50 = [v for k, v in e2e_p50.items() if k != slow_id]
    slower = slow_id in e2e_p50 and e2e_p50[slow_id] >= max(peer_p50) + 500 * FLEET_SLOW_S
    if straggle["ramp_lost_total"] or not slower or shares.get(slow_id, 0.0) <= 0:
        raise AssertionError(f"the straggler: {row['straggler']}")
    # Every replica of the window launched the apply 11 times a forward and
    # the moments never (no --adapt_every), and the window launched some.
    sites = SERVED["resnet50"]["sites"]
    if (len(window) < 2 or not sum(w["apply"] for w in window.values())
            or any(w["apply"] != sites * sum(w["forwards"].values()) or w["moments"]
                   for w in window.values())):
        raise AssertionError(f"the replicas' kernel launches in the window: {window}")
    return row


def drain_fleet_process(proc, events, replica_pids, card_before):
    """SIGTERM the fleet: every replica drains and exits, then the fleet,
    0; the summary reports no unclean drain, no replica process is left
    and the card's memory is back to ``card_before`` (within
    ``FLEET_MEMORY_SLACK``)."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=FLEET_WAIT_S)
    events.thread.join(timeout=10)
    summary = events.of("fleet_summary")
    alive = lambda: sorted(p for p in replica_pids if os.path.exists(f"/proc/{p}"))
    deadline = time.monotonic() + 30
    while alive() and time.monotonic() < deadline:
        time.sleep(0.2)
    left, card_after = alive(), gpu_memory_used()
    emit({"phase": "fleet_drain", "rc": rc, "summary": summary[-1] if summary else None,
          "replicas_left": left, "card_memory_mib": {"before_fleet": card_before,
                                                     "after_drain": card_after}})
    if (rc != 0 or not summary or summary[-1]["unclean_drains"] != 0 or left
            or card_after > card_before * FLEET_MEMORY_SLACK):
        raise AssertionError(f"fleet drain: rc {rc}, {summary}, left {left}, card "
                             f"{card_before} → {card_after} MiB, "
                             f"{proc.stderr.read()[-3000:]}")
    return summary[-1]


def stop_fleet(proc, port):
    """After a failed phase: drain the fleet (SIGTERM) if it still runs,
    kill it if the drain hangs, then kill any replica left behind (a
    killed balancer cannot drain its replicas)."""
    if proc.poll() is None:
        replicas = []
        try:
            replicas = [r["pid"] for r in http_json(port, timeout=10)[1]["replicas"]]
        except Exception:
            pass
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        for pid in replicas:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


def fleet(torch, cw, server, a_dir, device, rate):
    """Phases ``fleet``, ``fleet_autoscale`` and ``fleet_drain`` on one
    fleet process, then, with the card to itself again,
    ``fleet_b{bucket}_parity`` / ``_timing``: the apply at the sites of
    each bucket the straggler window's forwards used.  Returns the
    evidence of the kernels line's ``serve_fleet`` row: the replicas'
    devices and pids on the card, the reply error against the in-process
    engine, the window's apply launches and forwards by bucket as the
    replicas counted them, and those buckets' parity and timing rows."""
    card_before = gpu_memory_used()
    proc, ready, events, ready_s = start_fleet(a_dir)
    try:
        row = fleet_phase(torch, server, a_dir, proc, ready, ready_s, card_before)
        auto = fleet_autoscale(proc, ready, events)
        known = (set(row["replica_pids"].values()) | {row["fresh_pid"]}
                 | set(auto["pids_at_three"]))
        summary = drain_fleet_process(proc, events, known, card_before)
    finally:
        stop_fleet(proc, ready["port"])
    buckets = {}
    for b, forwards in sorted(auto["window_forwards_by_bucket"].items()):
        sites = fleet_sites(b)
        buckets[b] = (forwards, sites, *served_apply_sites(
            torch, cw, sites, 47 + b, device, rate, f"fleet_b{b}"))
    return {"devices": row["devices"], "replica_cuda_context": row["replica_cuda_context"],
            "balancer_cuda_context": row["balancer_cuda_context"],
            "card_memory_mib_per_replica": row["card_memory_mib_fleet"]["per_replica"],
            "replica_pids": row["replica_pids"], "balancer_pid": row["balancer_pid"],
            "reply_vs_engine": row["reply_vs_engine"], "tolerance": FORWARD_TOL,
            "launches": sum(w["apply"] for w in auto["window_launches"].values()),
            "window_launches": auto["window_launches"], "buckets": buckets,
            "ramp_scale_lag_s": auto["ramp_scale_lag_s"],
            "unclean_drains": summary["unclean_drains"]}


# ------------------------------------------------------- the trainers' run plane

RUN_PLANE_RULES = [
    {"name": "train_started", "metric": "dwt_train_steps_total", "op": ">",
     "threshold": 0, "severity": "info"},
    {"name": "loss_diverged", "metric": "dwt_train_loss", "op": ">",
     "threshold": 1e6, "severity": "critical"},
]
RUN_PLANE_HEARTBEAT = 4
RUN_PLANE_KINDS = ("metrics_exporter", "alert_rules", "alert", "train", "heartbeat", "test",
                   "accuracy_check")


def train_run_plane(torch, cw, usps_mnist, root, k4_syncs):
    """Phase ``train_run_plane``: the digits CLI at its full width with the
    dispatch phase's k = 4 flags (harvest depth 2) and the run plane on —
    ``--metrics_jsonl``, ``--heartbeat_every 4``, ``--metrics_port 0``,
    ``--alert_rules`` (``RUN_PLANE_RULES``) — and ``--expect_accuracy
    101``: exit 1 after the ``accuracy_check`` record; the JSONL's kinds
    (``RUN_PLANE_KINDS``); ``heartbeat`` records every 4 steps from the
    first chunk boundary (8, 12, 16); a
    ``/metrics`` scrape during the run valid; ``dwt_train_steps_total``
    moved by the 16 steps run; the harvester's blocking syncs per step
    those of ``dispatch_digits``' k = 4 run (``k4_syncs``), the launches 2 +
    2 a step.  Then the same run with ``--expect_accuracy`` at the first
    run's accuracy: exit 0 (cuDNN's deterministic algorithms: the
    accuracy repeats)."""
    from dwt_tpu_torch.obs import prom
    from dwt_tpu_torch.obs.registry import get_registry

    rules = os.path.join(root, "rules.json")
    with open(rules, "w") as f:
        json.dump(RUN_PLANE_RULES, f)
    jsonl = os.path.join(root, "run.jsonl")
    flags = DIGITS_BASE_FLAGS + DIGITS_DISPATCH["k4"][1] + [
        "--metrics_jsonl", jsonl, "--heartbeat_every", str(RUN_PLANE_HEARTBEAT),
        "--metrics_port", "0", "--alert_rules", rules]
    steps = DIGITS_STEPS_PER_EPOCH * 2
    reg = get_registry()
    steps0 = reg.value("dwt_train_steps_total") or 0.0
    scrapes, done = [], threading.Event()

    def scrape():
        import urllib.request

        while not done.is_set():
            port = prom.exporter_port()
            if port is not None:
                try:
                    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                                  timeout=5).read().decode()
                    if (reg.value("dwt_train_steps_total") or 0.0) > steps0:
                        scrapes.append(text)
                except OSError:
                    pass
            time.sleep(0.05)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    launches0 = (cw.moments_launches, cw.apply_launches)

    def run(extra):
        try:
            usps_mnist.main(flags + extra)
        except SystemExit as e:
            return e.code
        return 0

    try:
        with DeterministicCudnn(torch), HostSyncs() as syncs:
            t0 = time.perf_counter()
            rc_missed = run(["--expect_accuracy", "101"])
            seconds = time.perf_counter() - t0
    finally:
        done.set()
        scraper.join(timeout=10)
    launches = (cw.moments_launches - launches0[0], cw.apply_launches - launches0[1])
    steps_moved = (reg.value("dwt_train_steps_total") or 0.0) - steps0
    with open(jsonl) as f:
        records = [json.loads(line) for line in f]
    check = [r for r in records if r["kind"] == "accuracy_check"]
    acc = [r["accuracy"] for r in records if r["kind"] == "test"][-1]
    with DeterministicCudnn(torch):
        rc_met = run(["--expect_accuracy", str(acc), "--metrics_jsonl",
                      os.path.join(root, "met.jsonl")])
    prom.stop_exporter()
    kinds = sorted({r["kind"] for r in records})
    heartbeats = [r["step"] for r in records if r["kind"] == "heartbeat"]
    syncs_per_step = len(syncs.waits) / steps
    problems = [prom.validate_exposition(t) for t in scrapes[:1] + scrapes[-1:]]
    evals = sum(r.get("forwards", 0) for r in records if r["kind"] == "test")
    row = {"phase": "train_run_plane", "card": nvidia_smi(), "flags": flags,
           "seconds": seconds, "rc_missed": rc_missed, "rc_met": rc_met,
           "kinds": kinds, "records": len(records), "heartbeat_steps": heartbeats,
           "heartbeats": [{k: v for k, v in r.items() if k not in ("kind", "elapsed_s")}
                          for r in records if r["kind"] == "heartbeat"],
           "alerts": [r for r in records if r["kind"] == "alert"],
           "accuracy_check": check, "scrapes": len(scrapes),
           "scrape_problems": problems, "steps_total_moved": steps_moved,
           "host_syncs_per_step": syncs_per_step, "k4_host_syncs_per_step": k4_syncs,
           "launches": {"moments": launches[0], "apply": launches[1]},
           "eval_forwards": evals}
    emit(row)
    # The boundary runs once per chunk of k steps (an epoch's end cuts its
    # last chunk); the first boundary starts the heartbeat's window.
    k, spe = DISPATCH_K["digits"], DIGITS_STEPS_PER_EPOCH
    bounds = [e * spe + min(j + k, spe) for e in range(2) for j in range(0, spe, k)]
    want_hb, last = [], bounds[0]
    for b in bounds[1:]:
        if b - last >= RUN_PLANE_HEARTBEAT:
            want_hb.append(b)
            last = b
    sites = len(DIGITS_SITES)
    if (rc_missed, rc_met) != (1, 0) or not check or check[-1]["ok"]:
        raise AssertionError(f"--expect_accuracy exit codes {rc_missed}, {rc_met}: {check}")
    if set(RUN_PLANE_KINDS) - set(kinds) or heartbeats != want_hb:
        raise AssertionError(f"run plane records: kinds {kinds}, heartbeats {heartbeats}")
    if not scrapes or any(problems) or steps_moved != steps:
        raise AssertionError(f"/metrics during the run: {len(scrapes)} scrapes, "
                             f"{problems}, steps moved {steps_moved}")
    if syncs_per_step != k4_syncs:
        raise AssertionError(f"host syncs per step {syncs_per_step} with the run plane on, "
                             f"{k4_syncs} without")
    if launches != (sites * steps, sites * (steps + evals)):
        raise AssertionError(f"run plane launches {launches}: {sites} + {sites} a step, "
                             f"{evals} eval forwards")
    return row


# ------------------------------------------------------------ span tracing

# The flagship traced: 9 steps at k = 3 (the first chunk captures the
# step's graph and stays out of the step ms), no mid-run eval, one
# collection pass and the final eval.
TRACE_FLAGS = TRAIN_BASE_FLAGS + ["--num_iters", "9", "--check_acc_step", "100",
                                  "--steps_per_dispatch", str(DISPATCH_K["resnet50"]),
                                  "--harvest_depth", "2"]
# The loop, harvest, eval and data spans every traced flagship run holds
# (tests/test_torch_obs_report.py's LOOP_SPANS and the collection pass's);
# whether a drain blocks (metric_host_fetch) depends on when the copies land.
TRACE_SPANS = {"batch_wait", "step_dispatch", "boundary", "metric_copy_start",
               "harvest_drain", "eval_pass", "whiten_cache_build", "eval_batch_wait",
               "eval_dispatch", "eval_host_fetch", "stat_collection", "collect_batch_wait",
               "collect_dispatch", "batch_build", "h2d_stage"}
TRACE_SERVE_SIZES = (1, 8, 32)  # one request per bucket of ADAPT_FLAGS' buckets, a round
TRACE_SERVE_ROUNDS = 3  # the adapter steps after the first
FLIGHT_PLAN = {"hang_at_step": 4}
FLIGHT_FLAGS = DIGITS_CKPT_FLAGS + ["--epochs", "1", "--watchdog_timeout", "8"]


def obs_report_tool():
    """``tools/torch_obs_report.py`` of this checkout, imported."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    sys.path.insert(0, tools)
    try:
        import torch_obs_report
    finally:
        sys.path.remove(tools)
    return torch_obs_report


def trace_spans(path):
    """The complete events of an exported trace, and its problems."""
    from dwt_tpu_torch import obs

    with open(path) as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"] if e["ph"] == "X"], obs.validate_chrome_trace(trace)


def traced_pair(torch, cw, loader, loop, cli, run, flags, want, k, path, phase,
                turns=("untraced", "traced")):
    """``run`` (a trainer loop) on ``cli``'s config of ``flags``, untraced
    and with ``--obs_trace path``, in the order of ``turns``: each run's
    launches (checked record by record against ``want``), step ms (device
    clock, each stream's first ``k`` steps skipped), seconds and the
    harvester's host syncs a step, by arm; every run of both arms must
    launch the same kernels and sync as often."""
    from dwt_tpu_torch import obs

    runs = {"untraced": [], "traced": []}
    for key in turns:
        extra = ["--obs_trace", path] if key == "traced" else []
        cfg = cli.config_from_args(cli.build_parser().parse_args(flags + extra))
        obs.disable()
        try:
            with HostSyncs() as syncs, DispatchTimer(loop, k) as timer:
                t0 = time.perf_counter()
                _, launches, _ = counted_run(torch, cw, loader, run, cfg,
                                             f"{phase}_{key}", want)
                seconds = time.perf_counter() - t0
            step_ms = timer.step_ms(k)
        finally:
            obs.disable()
        steps = cfg.num_iters if hasattr(cfg, "num_iters") else \
            cfg.epochs * DIGITS_STEPS_PER_EPOCH
        runs[key].append({"launches": launches, "step_ms": step_ms, "seconds": seconds,
                          "host_syncs_per_step": len(syncs.waits) / steps, "steps": steps})
    what = {(str(r["launches"]), r["host_syncs_per_step"]) for arm in runs.values() for r in arm}
    if len(what) != 1:
        raise AssertionError(f"{phase}: tracing changed what runs: {runs}")
    return runs


def train_trace(torch, cw, officehome, usps_mnist, loop, loader, root):
    """Phase ``train_trace`` (module docstring, phase 48); returns the
    runs' launches."""
    import contextlib
    import io

    t0 = time.perf_counter()
    k = DISPATCH_K["resnet50"]
    path = os.path.join(root, "train.trace.json")
    runs = traced_pair(torch, cw, loader, loop, officehome, loop.run_officehome, TRACE_FLAGS,
                       officehome_want, k, path, "train_trace")
    kd, digits_flags = DIGITS_DISPATCH["k4"]
    digits = traced_pair(torch, cw, loader, loop, usps_mnist, loop.run_digits,
                         DIGITS_BASE_FLAGS + digits_flags, digits_want, kd,
                         os.path.join(root, "digits.trace.json"), "train_trace_digits",
                         turns=("untraced", "traced", "traced", "untraced"))
    events, problems = trace_spans(path)
    tool = obs_report_tool()
    report = tool.build_report([path], [])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = tool.main([path])
    total = [ln for ln in printed.getvalue().splitlines() if ln.startswith("TOTAL")]
    tb = report["processes"]["0"]["train"]
    loop_tid = next(e["tid"] for e in events if e["name"] == "step_dispatch")
    dispatches = [e for e in events if e["name"] == "step_dispatch" and e["tid"] == loop_tid]
    names = {e["name"] for e in events}
    top = sorted(tb["phases"].items(), key=lambda kv: -kv[1]["share"])[:6]
    steps = runs["traced"][0]["steps"]
    row = {"phase": "train_trace", "card": nvidia_smi(), "seconds": time.perf_counter() - t0,
           "flags": TRACE_FLAGS,
           "runs": runs, "digits_flags": DIGITS_BASE_FLAGS + digits_flags, "digits": digits,
           "spans": len(events), "names": sorted(names),
           "problems": problems[:5], "report_rc": rc, "report_total": total,
           "loop_wall_s": tb["wall_s"], "loop_ms_per_step": tb["wall_s"] * 1e3 / steps,
           "unattributed_share": tb["unattributed_share"],
           "top_phases": {n: {"count": p["count"], "self_s": p["self_s"], "share": p["share"],
                              "ms_per_step": p["self_s"] * 1e3 / steps} for n, p in top},
           "step_dispatch": {"count": len(dispatches),
                             "n": [e["args"].get("n") for e in dispatches]},
           "dropped_spans": report.get("dropped_spans")}
    emit(row)
    shares = sum(p["share"] for p in tb["phases"].values()) + tb["unattributed_share"]
    if problems or rc != 0 or not total or "100.0%" not in total[0] \
            or abs(shares - 1.0) > 1e-4:
        raise AssertionError(f"train trace: problems {problems[:5]}, report rc {rc}, "
                             f"total {total}, shares {shares}")
    if TRACE_SPANS - names:
        raise AssertionError(f"train trace lacks {sorted(TRACE_SPANS - names)}")
    if len(dispatches) * k != steps or sum(e["args"]["n"] for e in dispatches) != steps:
        raise AssertionError(f"step_dispatch spans {row['step_dispatch']} for {steps} "
                             f"steps at k = {k}")
    return {"flagship": runs, "digits": digits}


def serve_trace(torch, cw, server, root):
    """Phase ``serve_trace`` (module docstring, phase 49); returns the
    launches."""
    import numpy as np

    from dwt_tpu_torch import obs

    t0 = time.perf_counter()
    path = os.path.join(root, "serve.trace.json")
    log_path = os.path.join(root, "serve_access.jsonl")
    args = served_args(server, "--init_random", "--seed", "0", "--obs_trace", path,
                       "--access_log", log_path, *ADAPT_FLAGS)
    shape = SERVED["resnet50"]["shape"]
    rng = np.random.default_rng(3)
    obs.disable()
    obs.maybe_enable(args.obs_trace)  # as the server's main, before the stack
    e2e_ms, verdict = {}, None
    try:
        stack, http = serving_stack(server, args)
        engine, adapter = stack.engine, stack.adapter
        try:
            cw.moments_launches = cw.apply_launches = 0
            for rnd in range(TRACE_SERVE_ROUNDS):
                for n in TRACE_SERVE_SIZES:
                    x = rng.normal(size=(n,) + shape).astype(np.float32)
                    t = time.perf_counter()
                    out = http.infer(x, binary=True)
                    e2e_ms.setdefault(n, []).append((time.perf_counter() - t) * 1e3)
                    if out.shape != (n, SERVED["resnet50"]["classes"]) or \
                            not np.isfinite(out).all():
                        raise AssertionError(f"bucket {n}: logits {out.shape}")
                if rnd == 0:
                    wait_for(lambda: adapter._queue_samples >= ADAPT_BATCH, "the batch hook")
                    verdict = adapter.step()
            torch.cuda.synchronize()
            launches = {"moments": cw.moments_launches, "apply": cw.apply_launches}
            batches = dict(stack.client.batches)
        finally:
            http.close()
            stack.front.close()
            stack.access_log.close()
        exported = obs.export()
    finally:
        obs.disable()
    # The forward alone on the same engine (CUDA events, back to back).
    staged = {n: engine.stage(rng.normal(size=(n,) + shape).astype(np.float32))
              for n in TRACE_SERVE_SIZES}
    forward_ms = {n: cuda_ms(torch, lambda n=n: engine.forward(staged[n], n), iters=10,
                             warmup=2) for n in TRACE_SERVE_SIZES}
    events, problems = trace_spans(exported)
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    with open(log_path) as f:
        ok = [r for r in map(json.loads, f) if r["kind"] == "access" and r["status"] == "ok"]
    joined, device = {}, {}
    for name in ("stage", "device", "resolve"):
        for b in TRACE_SERVE_SIZES:
            spans = [e for e in by_name.get(name, []) if e["args"]["bucket"] == b]
            ids = sorted(i for e in spans for i in e["args"]["req_ids"])
            one_batch = all(len({r["batch_seq"] for r in ok if r["req_id"] in e["args"]["req_ids"]})
                            == 1 for e in spans)
            joined[f"{name}_b{b}"] = one_batch and ids == sorted(
                r["req_id"] for r in ok if r["bucket"] == b) != []
    for b in TRACE_SERVE_SIZES:
        durs = sorted(e["dur"] / 1e3 for e in by_name.get("device", [])
                      if e["args"]["bucket"] == b)
        device[b] = {"span_ms": durs, "span_ms_p50": durs[(len(durs) - 1) // 2] if durs else None,
                     "access_device_ms": sorted(r["device_ms"] for r in ok if r["bucket"] == b),
                     "forward_ms": forward_ms[b], "e2e_ms": e2e_ms.get(b)}
    sites = SERVED["resnet50"]["sites"]
    forwards = sum(batches.values())
    collects = by_name.get("adapt_collect", [])
    row = {"phase": "serve_trace", "card": nvidia_smi(), "seconds": time.perf_counter() - t0,
           "spans": len(events),
           "names": sorted(by_name), "problems": problems[:5], "batches": batches,
           "launches": launches, "adapt_verdict": verdict,
           "adapt_collect": [e["args"] for e in collects], "req_ids_joined": joined,
           "device_by_bucket": device}
    emit(row)
    if problems or batches != {n: TRACE_SERVE_ROUNDS for n in TRACE_SERVE_SIZES}:
        raise AssertionError(f"serve trace: problems {problems[:5]}, batches {batches}")
    if not all(joined.values()):
        raise AssertionError(f"serve spans' req_ids against the access log: {joined}")
    if [c["args"]["batches"] for c in collects] != [1]:
        raise AssertionError(f"adapt_collect spans {[c['args'] for c in collects]}")
    if launches != {"moments": sites, "apply": sites * (forwards + 1)}:
        raise AssertionError(f"serve trace launches {launches}: {sites} apply a forward "
                             f"({forwards}), {sites} + {sites} for the collect")
    return launches


def flight_recorder(root):
    """Phase ``flight_recorder`` (module docstring, phase 50): the hung
    child alone on the card, after every timed phase."""
    from dwt_tpu_torch.resilience import WATCHDOG_EXIT_CODE, inject

    t0 = time.perf_counter()
    ck = os.path.join(root, "flight")
    env = {**os.environ, inject.ENV_VAR: json.dumps(FLIGHT_PLAN), "DWT_OBS_TRACE": "1"}
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-c", CHAOS_CHILD, *FLIGHT_FLAGS,
                             "--ckpt_dir", ck], cwd=here, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wd = os.path.join(ck, "watchdog")
    files = sorted(os.listdir(wd)) if os.path.isdir(wd) else []
    dumps = [f for f in files if f.startswith("spans-") and f.endswith(".json")]
    names, problems, reason = set(), ["no spans dump"], None
    if dumps:
        events, problems = trace_spans(os.path.join(wd, dumps[0]))
        names = {e["name"] for e in events}
        with open(os.path.join(wd, dumps[0])) as f:
            reason = json.load(f)["otherData"].get("flight_reason")
    row = {"phase": "flight_recorder", "seconds": time.perf_counter() - t0,
           "rc": proc.returncode, "files": files, "flight_reason": reason,
           "span_names": sorted(names), "problems": problems[:5],
           "stderr_tail": err[-600:]}
    emit(row)
    if proc.returncode != WATCHDOG_EXIT_CODE or not any(f.startswith("stacks-") for f in files):
        raise AssertionError(f"flight recorder: rc {proc.returncode}, files {files}")
    if problems or not {"step_dispatch", "boundary"} & names:
        raise AssertionError(f"flight recorder: problems {problems[:5]}, spans {names}")
    return row


SERVING_PER = {
    "serve_adapt": "the 11 whitened sites of one collect forward: --adapt_batch 32 "
                   "tiled into 3 domains at 224², one launch per site for the 3 "
                   "domains",
    "serve_int8": f"the 11 whitened sites of one bucket-{INT8_IMAGES} ResNet50 forward "
                  f"at 224² over int8-resident weights (int8_serve's request of "
                  f"{INT8_IMAGES} images)",
    "serve_swap": f"the 11 whitened sites of one bucket-{SWAP_IMAGES} ResNet50 forward "
                  f"at 224² of a generation the watcher swapped in (hot_swap's 3 "
                  f"requests of {SWAP_IMAGES} images after the swap)",
    "serve_fleet": f"the 11 whitened sites of one ResNet50 forward at 224² in a fleet "
                   f"replica (python -m dwt_tpu_torch.fleet.balancer over run A's "
                   f"checkpoint, buckets {FLEET_BUCKETS}), averaged over the buckets of "
                   f"the straggler window's forwards; launches: the window's, counted by "
                   f"the replicas' own launch counters (their /stats); errors and times: "
                   f"the apply in this process at those buckets' sites, the fleet drained",
}


def serving_rows(r, floor):
    """The contract line's rows of the serving plane: ``serve_adapt``
    (both kernels: the collect batches' launches in ``adapt_serve``, the
    largest f32 error and the f32 times per collect batch from
    ``adapt_kernels``), ``serve_int8`` and ``serve_swap`` (the apply:
    their phases' launches, the errors and times at their forwards' own
    site shapes, buckets 32 and 8), and ``serve_fleet`` (the apply in the
    fleet's replicas: the launches they counted in the straggler window,
    the errors and the times per forward at the window's bucket mix)."""
    timing = r["adapt_timing"]
    out = []
    for part in ("moments", "apply"):
        sites = [(timing[("f32", name)][part], n) for name, _, _, n in ADAPT_SITES]
        total = lambda key: sum(t[key] * n for t, n in sites)
        errs = [p for p in r["adapt_parity"] if p["dtype"] == "f32"]
        err = (max(p["apply_vs_plain"]["max_abs_err"] for p in errs) if part == "apply"
               else max(max(p["moments_vs_plain"].values()) for p in errs))
        out.append({
            "name": f"whiten_{part}", "route": "cuda",
            "source": f"dwt_tpu_torch/csrc/whiten_{part}.cu",
            "replaces": ("dwt_tpu/ops/pallas_whitening.py:143" if part == "apply"
                         else "dwt_tpu/ops/pallas_whitening.py:68"),
            "launches": r["adapt_launches"][part], "max_abs_err": err,
            "ms": total("device_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"), "bound_by": bound_by([t for t, _ in sites]),
            "library_ms": total("library_ms"),
            "library_device_ms": total("library_device_ms"),
            "host_us": total("host_us"), **(floor if part == "apply" else {}),
            "bf16_ms": sum(timing[("bf16", name)][part]["device_ms"] * n
                           for name, _, _, n in ADAPT_SITES),
            "path": "serve_adapt", "per": SERVING_PER["serve_adapt"],
            "collect_vs_plain": r["adapt_collect_err"],
            "collect_tolerance": {"whitened": COLLECT_SITE_TOL, "other": COLLECT_TOL}})
    for path, key, sites in (("serve_int8", "int8", INT8_SITES),
                             ("serve_swap", "swap", SWAP_SITES)):
        out.append(served_apply_row(sites, r[f"{key}_parity"], r[f"{key}_timing"],
                                    r[f"{key}_launches"], floor, path, SERVING_PER[path]))
    # The fleet's replicas: the launches they counted, and per forward the
    # errors and times at the sites of the window's buckets, weighted by
    # the window's forwards at each, with the replicas' evidence (device,
    # pids on the card, replies against the in-process engine).
    fl = r["fleet"]
    per_bucket = {b: (n, served_apply_row(sites, parity, timing, fl["launches"], floor,
                                          "serve_fleet", SERVING_PER["serve_fleet"]))
                  for b, (n, sites, parity, timing) in fl["buckets"].items()}
    forwards = sum(n for n, _ in per_bucket.values())
    row = dict(next(iter(per_bucket.values()))[1])
    for key in ("ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms",
                *APPLY_EXTRA, "bytes"):
        row[key] = sum(n * b_row[key] for n, b_row in per_bucket.values()) / forwards
    row["max_abs_err"] = max(b_row["max_abs_err"] for _, b_row in per_bucket.values())
    row["bound_by"] = bound_by([b_row for _, b_row in per_bucket.values()])
    out.append({**row, "window_forwards_by_bucket": {b: n for b, (n, _) in
                                                     per_bucket.items()},
                "window_launches_by_replica": fl["window_launches"],
                "replica_devices": fl["devices"],
                "replica_pids": fl["replica_pids"], "balancer_pid": fl["balancer_pid"],
                "replica_cuda_context": fl["replica_cuda_context"],
                "balancer_cuda_context": fl["balancer_cuda_context"],
                "card_memory_mib_per_replica": fl["card_memory_mib_per_replica"],
                "reply_vs_engine": fl["reply_vs_engine"],
                "reply_tolerance": fl["tolerance"]})
    return out


def bound_by(rows):
    return ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations")


def digits_row(timing, path, part):
    """The kernels line's times of ``part`` (``"apply"`` or ``"moments"``)
    on a digits path: the sum over one train step's (or one bucket-128
    forward's) launches, one per site, each site's times from
    ``check_digits_kernels``."""
    rows = [timing[(path, site)][part] for site, _, _ in DIGITS_SITES]
    total = lambda key: sum(r[key] for r in rows)
    keys = ("plain_ms", "bound_ms", "library_ms", "library_device_ms")
    keys += APPLY_EXTRA if part == "apply" else MOMENTS_EXTRA
    return {"ms": total("device_ms"), "bound_by": bound_by(rows),
            **{k: total(k) for k in keys}}


def in_graph(harness, part, row):
    """A graph row's numbers from ``graph_harness``'s replays: the kernel's
    error against its plain version and its device ms per step (the eager
    row's, ``ms_from``, when the trace of the replays held none of its
    launches); no host time."""
    errs = harness[f"in_graph_{part}_vs_plain"]
    ms = harness["in_graph_kernel_ms"][part]
    return {"max_abs_err": (errs["max_abs_err"] if part == "apply"
                            else max(errs["mean_max_abs_err"], errs["cov_max_abs_err"])),
            "ms": row["ms"] if ms is None else ms,
            "ms_from": "eager" if ms is None else "replays",
            "max_abs_err_from": f"dispatch_harness {harness['model']}, site "
                                f"{harness['site_shape']}",
            "host_us": None}


BF16_PER = {
    "train_bf16": "the 11 whitened sites of one ResNet50 train step at --compute_dtype "
                  "bf16, one launch per site for its 3 domains, 18 images per stream "
                  "at 224², each step a replay at 3 steps per dispatch",
    "digits_train_bf16": "the 2 whitened sites of one LeNet-DWT train step at "
                         "--compute_dtype bf16, one launch per site for its 2 domains, "
                         "32 images per stream at 28²",
    "serve_bf16": "the 11 whitened sites of one bucket-128 ResNet50 forward at 224², "
                  "--serve_dtype bf16",
}


def bf16_rows(r, floor):
    """The contract line's rows of the bf16 variants, per path: launches on
    that path's run (``bf16_train``'s flagship and digits runs, the bf16
    server's requests), the largest error against the plain version at
    the path's shapes (``bf16_kernels``), and the times summed over one
    step's (or one bucket-128 forward's) launches, each site's from
    ``bf16_timing``."""
    launches = {"train_bf16": r["bf16_train_launches"],
                "digits_train_bf16": r["bf16_digits_launches"],
                "serve_bf16": {"apply": r["bf16_serve_launches"]}}
    rows = []
    for path, per in BF16_PER.items():
        shapes = [(name, n) for p, name, _, _, _, n in BF16_SHAPES if p == path]
        for part in (("apply",) if path == "serve_bf16" else ("apply", "moments")):
            timed = [(r["bf16_timing"][(path, name)][part], n) for name, n in shapes]
            total = lambda key: sum(t[key] * n for t, n in timed)
            parity = [p for p in r["bf16_parity"] if p["path"] == path]
            err = (max(p["apply_vs_plain"]["max_abs_err"] for p in parity)
                   if part == "apply" else
                   max(max(p["moments_vs_plain"].values()) for p in parity))
            rows.append({
                "name": f"whiten_{part}_bf16", "route": "cuda",
                "source": f"dwt_tpu_torch/csrc/whiten_{part}.cu",
                "replaces": ("dwt_tpu/ops/pallas_whitening.py:143" if part == "apply"
                             else "dwt_tpu/ops/pallas_whitening.py:68"),
                "launches": launches[path][part], "max_abs_err": err,
                "ms": total("device_ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"), "bound_by": bound_by([t for t, _ in timed]),
                "library_ms": total("library_ms"),
                "library_device_ms": total("library_device_ms"),
                "host_us": total("host_us"), **(floor if part == "apply" else {}),
                "path": path, "per": per})
    return rows


def kernels_line(torch, r):
    """The contract line's rows: per kernel and path, its launches on that
    path's run, its largest error against its plain version, and its
    times per serve forward or train step, from the phases' results
    ``r``."""
    timing, m_timing, d_timing = r["timing"], r["m_timing"], r["d_timing"]
    d_apply_errs = r["d_apply_errs"]

    def per_forward(key):  # the 11 sites of one bucket-128 forward
        return sum(timing[s][key] * n for s, _, _, n in RESNET50_SITES)

    def per_step(part, key):  # one train step: 11 sites, one launch each
        return sum(m_timing[s][part][key] * n for s, _, _, n in TRAIN_SITES)

    train_per = {
        "moments": "the 11 whitened sites of one ResNet50 train step, one "
                   "launch per site for its 3 domains, 18 images per stream "
                   "at 224²",
        "apply": "the 11 whitened sites of one ResNet50 train step, one "
                 "launch per site for its 3 domains, 18 images per stream "
                 "at 224²",
    }
    # The apply rows also carry, summed over the same launches, the
    # wrapper's host time and a D2D copy of the same bytes, and the card's
    # per-launch floor (one empty launch).
    floor = {"launch_floor_ms": launch_floor_ms(torch)}
    train_rows = {
        part: {"ms": per_step(part, "device_ms"),
               "plain_ms": per_step(part, "plain_ms"),
               "bound_ms": per_step(part, "bound_ms"),
               "bound_by": bound_by([row[part] for row in m_timing.values()]),
               "library_ms": per_step(part, "library_ms"),
               "library_device_ms": per_step(part, "library_device_ms"),
               "path": "train", "per": train_per[part]}
        for part in ("moments", "apply")
    }
    train_rows["apply"].update(floor, **{k: per_step("apply", k) for k in APPLY_EXTRA})
    train_rows["moments"].update({k: per_step("moments", k) for k in MOMENTS_EXTRA})
    rows = [
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["serve_launches"],
            "max_abs_err": max(p["max_abs_err"] for p in r["parity"]
                               if p["D"] is None),
            "ms": per_forward("device_ms"),
            "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": bound_by(timing.values()),
            "library_ms": per_forward("library_ms"),
            "library_device_ms": per_forward("library_device_ms"),
            **{k: per_forward(k) for k in APPLY_EXTRA}, **floor,
            "path": "serve",
            "per": "the 11 whitened sites of one bucket-128 ResNet50 forward at 224²",
        },
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["train_launches"]["apply"],
            "max_abs_err": max(
                [p["apply_vs_plain"]["max_abs_err"] for p in r["m_parity"]]
                + [p["max_abs_err"] for p in r["parity"] if p["D"] is not None]),
            **train_rows["apply"],
        },
        {
            "name": "whiten_moments",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_moments.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:68",
            "launches": r["train_launches"]["moments"],
            "max_abs_err": max(max(p["vs_plain"].values()) for p in r["m_parity"]),
            **train_rows["moments"],
        },
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["digits_train_launches"]["apply"],
            "max_abs_err": max(e for (path, _), e in d_apply_errs.items()
                               if path == "train"),
            **digits_row(d_timing, "train", "apply"), **floor,
            "path": "digits_train",
            "per": "the 2 whitened sites of one LeNet-DWT train step, one launch "
                   "per site for its 2 domains, 32 images per stream at 28²",
        },
        {
            "name": "whiten_moments",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_moments.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:68",
            "launches": r["digits_train_launches"]["moments"],
            "max_abs_err": max(r["d_moments_errs"].values()),
            **digits_row(d_timing, "train", "moments"),
            "path": "digits_train",
            "per": "the 2 whitened sites of one LeNet-DWT train step, one launch "
                   "per site for its 2 domains, 32 images per stream at 28²",
        },
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["digits_serve_launches"],
            "max_abs_err": max(e for (path, _), e in d_apply_errs.items()
                               if path.startswith("serve")),
            **digits_row(d_timing, "serve_b128", "apply"), **floor,
            "path": "digits_serve",
            "per": "the 2 whitened sites of one bucket-128 LeNet-DWT forward at 28²",
        },
    ]
    # The image-folder path runs the train path's shapes: its launches, the
    # train rows' times.
    folder = [{**row, "launches": r["folder_launches"][row["name"].split("_")[1]],
               "path": "officehome_folder_train",
               "per": row["per"] + ", the images decoded from JPEG folders"}
              for row in rows if row["path"] == "train"]
    # The graph paths (phase dispatch): the same shapes and kernels, each
    # launch captured once and made by every replay; launches = captured
    # launches × replays, plus the eager first step's.  The error and the
    # kernel's ms are measured inside replays (graph_harness: the first
    # whitened site against the plain version; the kernel's device time in
    # a trace of the replays); the wrapper's host time does not apply to a
    # replay; the plain version's, the bound's and the library's times are
    # the eager path's at the same shapes (``carried_from``).
    graphs = [{**row, "launches": r["graph_launches"][path][row["name"].split("_")[1]],
               **in_graph(r["graph_harness"][path], row["name"].split("_")[1], row),
               "path": path, "per": row["per"] + per, "carried_from": base}
              for path, base, per in (
                  ("train_graph", "train", ", each step a replay of one captured "
                   "step at 3 steps per dispatch"),
                  ("officehome_folder_train_graph", "train", ", the images decoded from "
                   "JPEG folders, each step a replay at 4 steps per dispatch"),
                  ("digits_train_graph", "digits_train", ", each step a replay of one "
                   "captured step at 4 steps per dispatch"))
              for row in rows if row["path"] == base]
    rows = (rows[:3] + folder + rows[3:] + graphs + bf16_rows(r, floor)
            + group_rows(r, floor))
    rows += backbone_rows(r, floor, rows)
    rows += serving_rows(r, floor)
    # The checkpoint phases' launches, on the paths whose shapes they run.
    for row in rows:
        part = row["name"].split("_")[1]
        row["phase_launches"] = {
            phase: r["ckpt"][phase][part]
            for phase in CKPT_PHASES.get(row["path"], ())
            if part in r["ckpt"][phase]}
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    from dwt_tpu_torch import native
    from dwt_tpu_torch.cli import officehome, usps_mnist, visda
    from dwt_tpu_torch.data import loader
    from dwt_tpu_torch.ops import _build, cuda_whitening as cw
    from dwt_tpu_torch.resilience import inject
    from dwt_tpu_torch.serve import server
    from dwt_tpu_torch.train import loop

    caught = PhaseWarnings().__enter__()  # for the whole run
    tf32_defaults = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                     "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import PIL

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    props = torch.cuda.get_device_properties(0)
    # Double data rate: clock (kHz) × 2 transfers × bus width in bytes.
    reported = (getattr(props, "memory_clock_rate", 0) * 1e3 * 2
                * getattr(props, "memory_bus_width", 0) / 8) or None
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "memory_rate_Bps": rate,
          "memory_rate_from_clock_Bps": reported,
          "pil": PIL.__version__, "cpu_count": os.cpu_count(),
          "gxx": subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                check=True, timeout=60).stdout.splitlines()[0],
          "tf32_defaults": tf32_defaults,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()
    emit({"phase": "build", "seconds": seconds,
          "native_seconds": time.perf_counter() - t0,
          "native_library": os.path.relpath(native.library_path()),
          "built": sorted(logs),
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
                    for k, v in logs.items()}})
    general = general_kernel_resources(logs)
    emit({"phase": "build_general_kernels", "most_registers": GROUP_MOST_REGISTERS,
          "kernels": general})
    over = {k: v for k, v in general.items()
            if v.get("registers", 0) > GROUP_MOST_REGISTERS or v.get("spill_stores", 0)
            or v.get("spill_loads", 0)}
    if over:
        raise AssertionError(f"general kernels over {GROUP_MOST_REGISTERS} registers "
                             f"or spilling: {over}")

    device = torch.device("cuda", 0)
    r = {}
    r["parity"], r["timing"] = check_kernel(torch, cw, device, rate)
    r["m_parity"], r["m_timing"] = check_moments(torch, cw, device, rate)
    r["train_launches"], synthetic_timing = train(torch, cw, officehome, loop)
    train_reference(torch, cw, loop, device)
    train_throughput(torch, loop, device)
    harness = graph_harness(torch, cw, loop, officehome, "resnet50", device)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="folders-", dir=build) as root:
        emit({"phase": "folders", "jpeg_bytes": write_folders(root)})
        data_plane(torch, officehome, loop, device, root)
        r["folder_launches"], folder_timing = train(
            torch, cw, officehome, loop, folder_flags(root), "folder_train")
        profiled = folder_profile(torch, officehome, loop, device, root,
                                  folder_timing["step_ms_median"])
        folder_dispatch = dispatch_folder(torch, cw, officehome, loop, root)
    emit({"phase": "folder_vs_synthetic",
          "folder_step_ms_median": folder_timing["step_ms_median"],
          "synthetic_step_ms_median": synthetic_timing["step_ms_median"],
          "folder_batch_wait_ms_mean": folder_timing["batch_wait_ms_mean"],
          "synthetic_batch_wait_ms_mean": synthetic_timing["batch_wait_ms_mean"],
          "folder_idle_share": profiled["idle_share"]})
    r["serve_launches"] = serve(torch, cw, server)
    r["d_apply_errs"], r["d_moments_errs"], r["d_timing"] = check_digits_kernels(
        torch, cw, device, rate)
    r["digits_train_launches"], _ = digits_train(torch, cw, usps_mnist, loop)
    digits_reference(torch, cw, loop, device)
    digits_throughput(torch, loop, device)
    digits_harness = graph_harness(torch, cw, loop, officehome, "digits", device)
    digits_dispatch = dispatch_digits(torch, cw, usps_mnist, loop, loader, inject)
    with tempfile.TemporaryDirectory(prefix="runplane-", dir=build) as root:
        r["run_plane"] = train_run_plane(torch, cw, usps_mnist, root,
                                         digits_dispatch["runs"]["k4"]["host_syncs_per_step"])
    r["digits_serve_launches"] = serve(torch, cw, server, "lenet")
    r["bf16_parity"], r["bf16_timing"] = bf16_kernels(torch, cw, device, rate)
    r["bf16_train_launches"], r["bf16_digits_launches"] = bf16_train(
        torch, cw, officehome, usps_mnist, loop)
    r["whiteners"] = whiteners_phase(torch, cw, officehome, usps_mnist, loop)
    r["bf16_serve_launches"] = serve(torch, cw, server, "resnet50_bf16")
    r["remat"] = remat_phase(torch, cw, officehome, loop, device)
    with tempfile.TemporaryDirectory(prefix="ckpt-", dir=build) as root:
        ck = r["ckpt"] = {}
        ck["ckpt_resume"], a_records, a_ids, a_dir, a_step = ckpt_resume(
            torch, cw, officehome, loop, loader, root)
        ck["ckpt_serve"] = {"apply": ckpt_serve(torch, cw, server, officehome, loop,
                                                a_dir, a_step, device)}
        r["int8_launches"], r["int8_parity"], r["int8_timing"] = int8_serve(
            torch, cw, server, loop, officehome, a_dir, a_step, device, rate)
        r["swap_launches"], r["swap_parity"], r["swap_timing"] = hot_swap(
            torch, cw, server, officehome, loop, root, a_dir, device, rate)
        r["adapt_launches"], r["adapt_collect_err"] = adapt_serve(
            torch, cw, server, inject, root, a_dir)
        r["fleet"] = fleet(torch, cw, server, a_dir, device, rate)
        ck["guard"] = guard_phase(torch, cw, officehome, loop, loader, inject, root, a_ids)
        ck["delta"], ck["delta_serve"] = delta_phase(
            torch, cw, officehome, loop, loader, server, root, a_records, a_dir, device)
        ck["preempt"] = preempt_phase(torch, cw, officehome, loop, loader, inject, root,
                                      a_records, a_dir)
        ck["digits_ckpt"], ck["digits_ckpt_serve"] = digits_ckpt(
            torch, cw, usps_mnist, loop, loader, server, root, device)
        ck["convert"] = convert_phase(torch, cw, officehome, loop, loader, root)
        ck["chaos_digits"] = chaos_digits(torch, root)
        resnet_dispatch = dispatch_resnet50(torch, cw, officehome, loop, loader, root,
                                            a_records, a_dir)
    k4 = DISPATCH_K["folder"]
    r["graph_launches"] = {
        "train_graph": resnet_dispatch["launches"],
        "officehome_folder_train_graph": folder_dispatch[f"k{k4}_depth2"]["launches"],
        "digits_train_graph": digits_dispatch["runs"]["k4"]["launches"]}
    r["graph_harness"] = {"train_graph": harness,
                          "officehome_folder_train_graph": harness,
                          "digits_train_graph": digits_harness}
    emit({"phase": "dispatch", "card": smi,
          "digits": {key: {f: v[f] for f in ("step_ms", "idle_share", "idle_share_in_profile",
                                             "host_syncs_per_step")}
                     for key, v in digits_dispatch["runs"].items()},
          "digits_harness": {f: digits_harness[f] for f in (
              "graph_step_ms", "eager_step_ms", "graph_idle_share", "eager_idle_share",
              "graph_device_ops_per_step", "eager_device_ops_per_step", "capture_ms",
              "graph_pool_bytes")},
          "resnet50_step_ms": resnet_dispatch["step_ms"],
          "resnet50_harness": {f: harness[f] for f in (
              "graph_step_ms", "eager_step_ms", "graph_idle_share", "eager_idle_share",
              "graph_device_ops_per_step", "eager_device_ops_per_step", "capture_ms",
              "graph_pool_bytes")},
          "resnet50_eval_pass_ms": {k: v["ms"] for k, v in resnet_dispatch["eval_pass"].items()},
          "resnet50_collection_pass_ms": {k: v["ms"] for k, v in
                                          resnet_dispatch["collection_pass"].items()},
          "folder": {key: {f: v[f] for f in ("step_ms", "idle_share", "idle_share_in_profile")}
                     for key, v in folder_dispatch.items()},
          "guard_detection": digits_dispatch["guard"]["detection"]})
    r["group_timing"] = group_kernels(torch, cw, device, rate)
    with tempfile.TemporaryDirectory(prefix="group-", dir=build) as root:
        r["group_train_launches"], group_ckpts = group_train(torch, cw, officehome, loop,
                                                             root)
        r["group_serve_launches"] = group_serve(torch, cw, server, officehome, loop,
                                                group_ckpts, device)
    r["group_digits_launches"] = group_digits(torch, cw, usps_mnist, loop)
    r["vit_parity"], r["vit_timing"] = vit_kernels(torch, cw, device, rate)
    r["vit_train_launches"] = vit_train(torch, cw, officehome, loop, device)
    r["vit_serve_launches"] = {"f32": serve(torch, cw, server, "vit_dwt"),
                               "bf16": serve(torch, cw, server, "vit_dwt_bf16")}
    with tempfile.TemporaryDirectory(prefix="visda-", dir=build) as root:
        r["visda_launches"], visda_flags = visda_train(torch, cw, officehome, visda, loop,
                                                       root)
        (r["visda_serve_launches"], r["visda_serve_parity"],
         r["visda_serve_timing"]) = visda_serve(torch, cw, server, officehome, visda, loop,
                                                visda_flags, device, rate)
    r["resnet152_launches"] = resnet152_train(torch, cw, officehome, loop)
    r["adapt_parity"], r["adapt_timing"] = adapt_kernels(torch, cw, device, rate)
    with tempfile.TemporaryDirectory(prefix="trace-", dir=build) as root:
        r["train_trace"] = train_trace(torch, cw, officehome, usps_mnist, loop, loader, root)
        r["serve_trace"] = serve_trace(torch, cw, server, root)
        r["flight_recorder"] = flight_recorder(root)
    shown = caught.rows()
    emit({"phase": "warnings", "warnings": shown})
    stream = [w for w in shown if STREAM_WARNING in w["message"]]
    if stream:
        raise AssertionError(f"a gradient accumulated across streams: {stream}")
    emit({"kernels": kernels_line(torch, r)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
