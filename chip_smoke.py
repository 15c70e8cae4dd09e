#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (audiorenderingv2_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu with nvcc (timed);
3. K3, the histogram kernel (its flat-bin entry), against its plain
   version (index_add_) and a float64 reference, on 1M seeded events (30%
   out of range) at 1, 4 and 8 bands; its time a call and on the device
   (20 calls in one CUDA graph), the plain version's and index_add_'s
   alone. After phase 4, on the box render's own events (1,000,064 rays x
   100 bounces at 1, 4 and 8 bands): K3 on their flat bins, and the
   hard-binning stage in one launch (the fused entry) against the PyTorch
   stage (same-ear sum, cross-ear shift), stereo and mono, each against
   a float64 sum of the same deposits (1e-4 a bin, no stray bin); the
   same times;
4. K1, the bounce-round kernel, against its plain version on the card, bit
   for bit in every state column: 100 bounces in one round at 64k rays;
   the export path's round budgets (8, 24, 68) with the alive-first
   partition between rounds, at 64k and at 1M rays, after every round; an
   8-band layout (32 columns) once; at 1M rays each round's times, tests
   and bound;
5. the export path as a user runs it (config.json -> load_context ->
   export_audio) at 1M rays, 100 bounces, a 2 s IR at 16 kHz, with both
   kernels' launch counts read around it; its IR is checked against the CPU
   plain path on 64k shared directions; render and convolve times;
6. the clustered route's kernels on the office scene of
   benchmarks/large_scene.py (19,852 triangles, 621 clusters of 32, 32
   bounces): K1's multi-chunk branch (39 chunks of 512 rows) against its
   plain version after an 8-bounce round at 64k rays, bit for bit; the
   schedule kernel against its plain version at 1M rays, integer for
   integer, on the state after one bounce; K2 against its plain version
   over two clustered rounds (schedule, K2, coherent sort) at 1M rays, the
   chains run apart, every column after each round; the clustered IR
   against K1's over all
   rows on 64k shared directions; times of both kernels and their plain
   versions, and of the sort. Then both kernels on three states of the
   office render (round 1 unsorted, after one bounce and the sort, after
   16 bounces) at 65,536 and 1,000,064 rays, at 1, 4 and 8 bands in
   clusters of 32 and at 1 band in clusters of 128: schedule rows equal to
   the plain rows, K2 bit-identical to its plain version and its per-tile
   warp visits (the (warp, candidate) pairs whose rows a warp tested, its
   cull) equal to the plain version's; the warp-culled test count beside
   the tile union's; their times at the three states beside their bounds
   (K2's on both counts); and a whole 32-round office trace
   at 65,536 rays, the kernels' chain bit-identical to the plain chain
   after every round; one office trace at 1M rays x 32 rounds by stage
   (schedule, K2, keys, sort), CUDA events around each;
7. the office export as a user runs it (config.json -> load_context ->
   export_audio, 1M rays, 32 bounces) with the launch counts read around
   it: the schedule kernel and K2 run, K1 does not; then a renderer given
   explicit options on the same scene (clusters of 128, K5 every round, no
   schedule); render times of both, median of 3, and of K1 over all rows;
8. the posed kernels (K1 and K2 reading one scalar row per pose) at the
   shapes the matrices of phases 10 and 12 give them. K1: the demo's box, 8
   poses x 1,000,064 rays, through the matrix's rounds (8 bounces, the
   per-pose partition, 32 bounces), the kernel's chain and the plain chain
   run apart, bit for bit in every column after each round and each pose's
   segment against a single-pose K1 launch, at 1 band and at 4 bands (24
   state columns). K2: the office, 4 poses x 250,112 rays, one round after
   a bounce and the per-pose sort, bit for bit against the plain version
   (its warp visits too) and against single-pose K2 launches, at 1, 4 and
   8 bands; times of both;
9. K4, the state-initialising kernel with in-kernel Philox directions, at
   1,000,064 rays (1,000,000 real) and 1 and 4 bands against its plain
   version: every exactly rounded column bit-equal (VZ carries the second
   word's 24 bits), VX and VY (through sincosf) within 2e-7; its time a
   call and on the device;
10. the multi-pose path as a user runs it, the configuration of
   examples/demo_6_multipose.py: an 18 x 10 x 14 m box, 2 sources x 4
   listeners, 1,000,000 rays a pair, 40 bounces in rounds (8, 32), a 2 s IR
   at 16 kHz, render_ir_matrix at pair_batch=8 (one launch of 8M rays per
   round) and mix_sources of two 2 s signals, the launch counts read around
   it: the posed K1 and the fused hard-binning entry ran, the single-pose
   K1 and K3 did not; one pair against a single render_ir of that pair;
   the hard-binning stage at the matrix's events (8,000,512 events,
   512,000 flat bins) as in phase 3, K3 on its flat bins beside it; times
   of the fused matrix, of pair_batch=1 and of the mix.
   Then the large-scene form: the office, 1 source x 4 listeners, 250,000
   rays a pair, 32 bounces, fused (schedule + posed K2), against a single
   render, and the stage at its events; the same matrix with default
   options (no
   schedule: one render_ir through K5 per pair) against the fused one, and
   its time beside it;
11. a native_rng render (K4) of the box at 1M rays x 100 bounces through
   AudioRenderer, the launch counts read around it, against renders of
   sampled directions, 8 seeds each: the means of the per-ear energy
   within 5 standard errors, spreads of one size, and the IR summed into
   20 ms bins no further from the sampled ones than twice what they are
   from each other; render times with and without;
12. a banded scene (4 bands, wall absorption 0.1 / 0.25 / 0.4 / 0.6): the
   demo's 2 x 4 x 1M-ray matrix and its mix through the filterbank, with
   the checks of phase 10 (launch counts, one pair against a single
   render, the stage at 4 bands) and the mix on the card against the mix
   on the CPU; the banded office matrix's histogram (1 x 4 x 250,000 rays
   at 4 bands through the posed schedule and K2, then the stage); then a
   banded export as a user runs it (config.json ->
   load_context -> export_audio, 1M rays, 100 bounces; one band-split
   launch), its trace against
   the CPU plain path on 64k shared directions in every (ear, band) and
   its filterbank convolution against the CPU's; times;
13. K3-bwd, the histogram's backward gather, against its plain version and
   against index_select, bit for bit, at the soft stereo IR's shape
   (4,000,256 events, 64,000 bins; 1, 4 and 8 bands; E = 4k + 2 and
   4k + 3; a bins[1:] view, not 16-byte aligned) and the posed
   histogram's (8,000,512 events, 512,000 bins), out-of-range bins among
   them; the autograd Function's gradient against autograd's through
   index_add_; times of the three;
14. K5, the in-kernel cluster traversal, on the office in clusters of 32 and
   of 128: against its plain version at 65,536 rays and at the recorder's
   1,000,064, from the start state, after one bounce and the sort and after
   16 bounces, every column and every tile's visit count bit for bit; at
   1,000,064 rays (the first two states) also against K2 on the same state
   (DIST, energy and the event columns equal; the rays that bounce off
   another triangle at the same distance counted); visits per tile; times;
   then K5 with one scalar row per pose (4 poses x
   250,112 rays) against its plain version and single-pose launches;
15. the path recorder (diff.record_paths_kernels) at 1M rays x 32 bounces on
   the office with the schedule (schedule kernel + K2) and without (K5) and
   on the box (K1 in one-bounce rounds), the launch counts saying which
   kernel ran; its paths against the plain search at 65,536 rays x 8
   bounces (bar 99.5% identical); render_ir_replay of the recorded paths
   against the forward render;
16. the gradient step at full width (benchmarks/grad_bench_clustered.py's
   shape): record, replay and grad times (CUDA events, median of 3), peak
   memory, K3 and K3-bwd launches per step; its gate at 16,384 rays x 8
   bounces: the replay's gradient against the autograd tracer's within 1%
   on the card, and against the replay's on the CPU;
17. a trainer that takes a few steps: diff.fit_scene_parameters(method=
   "replay") on the office at 1M rays, 5 Adam steps on the absorption
   logits from recorded paths, the launch counts read around it (schedule,
   K2, K3, K3-bwd, the replay's forward and backward kernels once a step),
   a falling loss and finite gradients (the inverse demo's own fit runs in
   phase 23).

18. K6, the group-layout kernel: its SASS (cuobjdump -sass: HMMA in every
   "high" kernel and the probe, in no "highest" one); the probe of its
   "high" product (the tensor cores' 48 quantities a group) against the
   float64 sum of the same terms, within 2^-20 of their magnitudes' sum,
   and the plain "high" beside it; then K6 against its plain version on
   the card after an 8-bounce round from the start state: the box at
   65,536 and 1,000,064 rays and 1, 4 and 8 bands, the 320-triangle
   icosphere (40 groups) at 1 and 4 bands and the 1,280-triangle one (160
   groups: the chunked kernel) at 65,536 rays; "highest" bit for bit and
   equal to K1 on the same state, "high" on its bar (PERF.md: at least
   99.9% of the rays on the plain version's path, 99.5% also within 1e-4
   relative in every column, every ray on that path within 1e-2) and
   against K1 (99% on K1's path, within 1e-2); the box through the route's
   rounds (6, 12, 24, 58) at 1,000,064 rays, both precisions beside K1,
   with the partition between them ("high" on the same bar in the rounds
   of 6 and 12, in those of 24 and 58 on the plain "high"'s own spread
   from f32 where that is wider); with one scalar row per pose at the demo matrix's shape (8 x
   1,000,064 rays), both precisions, also against single-pose launches;
   times of K6, K1 and the plain version; then the 2 x 4 x 1M-ray matrix
   through K6 (render_ir_matrix with layout="group"), the launch counts
   read around it, against the rows matrix;
19. K7, the version-1 kernel (K1's kernels over the version-1 layouts),
   against its plain version, bit for bit, through version 1's rounds
   (6, 12, 24, 58; the last on the persistent grid) with the row partition
   between them: the box (128 columns) and the icosphere padded to 512
   columns at 65,536 and 1,000,064 rays, the same icosphere with every
   third valid flag zeroed (invalid columns inside the table) and a
   1,280-triangle icosphere (the block-synchronous branch) at 65,536 rays;
   columns 13-15 zero; columns 0-12 against K1 on the same state; each
   round's times beside K1's;
20. the manual-options path as a user runs it: the CLI's experimentation
   mode on the box config at 1M rays x 100 bounces, --rounds 10, with
   default options, with --layout group (and with --precision high) and
   with --kernel-version 1, the launch counts read around each run and the
   summaries printed; round 0's IR of each manual route against the
   default route's (per-ear energy within 1e-3, relative L1 < 1e-2); then
   a native_rng render with the group layout (K4 then K6) against the same
   render with rows;
21. the reference's default application, the CLI's main mode, as a user
   runs it on the box config (1M rays x 100 bounces, a 2 s IR, the 5 s
   signal, the 9-key half orbit), its full_render_cycle records logged:
   K1 and the hard-binning entry ran, the renders fell at the poses the
   same policy gives on the host alone, the WAV is stereo, 5 s, finite,
   peak 1 within 1e-3; median render and convolve ms; at the first and
   last rendered poses trace_ir(with_stats=True) on 65,536 shared
   directions on the card against the CPU plain path (the IR on
   assert_ir_close(exact=False), the bounce sums within 1e-3 and at most
   0.5% of the sorted counts differing). Then the live duplex path on the
   box and on the office (1M rays x 32 bounces): an AsyncRenderWorker
   re-rendering while a LiveConvolver streams 60 blocks of 512 frames,
   paced at their 32 ms, into the native engine (built with g++ from
   native/), a re-render asked every 20 blocks: every block finite, every
   silenced block all zeros, at least 2 re-renders, underruns within the
   silenced blocks' ticks; block latency median and p99, blocks silenced
   for each re-render; one live block against the CPU on the same IR
   (relative L2 1e-5), and the same for the 4-band box through
   convolve_live_banded; last render_ir(with_stats=True) on the box and
   the office at 1M rays: the bounce sum, rays/s;
22. the multi-GPU path (``parallel/``), the card being one GPU: (a) a
   world of one under NCCL (127.0.0.1, a free port), so that every
   all-reduce and all-gather goes through NCCL: demo 5 as a user runs it
   (``audiorenderingv2_tpu_torch.examples.demo_5_sharded.main``, its scene
   from that module): render_ir_sharded of its room (24 x 12 x 18 m box
   and icosphere, 332 triangles) at its 16,000,000 rays x 8 bounces, a 2 s
   IR at 16 kHz (K1 and the hard-binning entry counted), then
   render_ir_matrix(mesh=) 2 x 2 at its 1M rays a pair (posed K1); the
   office at 1M rays x 32 (the schedule and K2, no K1); each IR and a
   render_ir of rank 0's stream held to the float64 sum of the sharded
   run's deposits on binned_check's bar, times of both (the render's first
   call too) and the peak device memory; one pair of the matrix and
   render_ir_sharded of its pair seed fold_seed(seed, pair) on the same
   bar; convolve_file_sharded of 16 s with the 2 s IR within
   1e-5 relative L2 of convolve_file_stereo; dryrun_multichip(1): a
   finite loss, its gradient within 1e-4 of the unsharded step's. Every
   kernel launch of these product calls is recorded (LaunchRecorder) and
   held to its plain version on its own inputs: K1, the posed K1 and K2
   bit for bit on the first 1,000,064 (K1) or 65,536 (K2) rays of each
   launch, the schedule integer for integer, K3-bwd bit for bit, K3 and
   the hard-binning entry on binned_check's bar; the phase fails unless
   every launch was held. (b) Two gloo
   ranks on the one card as subprocesses (two NCCL ranks on one GPU are
   refused, "Duplicate GPU detected"; gloo's all-reduce takes CUDA
   tensors; an exclusive compute mode fails first):
   trace_directions_sharded of 1,000,064 shared directions on the box,
   both ranks' IRs equal bit for bit and held with a single-process
   trace_ir to the float64 sum of its deposits. (c) ``python -m
   audiorenderingv2_tpu_torch.warmup`` as a subprocess: finite times for
   its three configurations, printed.
23. the repo's seven demos (``audiorenderingv2_tpu_torch/examples/``), each
   ``main()`` on the card at its own size as a user runs it, twice (first
   and warm wall time; demo 4's 200-step fit once, its steps timed; demo
   5's main is phase 22 (a)'s run), every kernel launch of the first run
   counted (the counters set to 0 just before, read just after: a needed
   kernel at 0 fails) and every kernel wrapper call checked to be given
   CUDA tensors; demos 1 and 2 also under LaunchRecorder, each launch held
   to its plain version (K1 bit for bit, the hard-binning entry on
   binned_check's bar); each demo's own checks (demo 3's renders, the IRs
   empty while the receiver is outside its room, its real-time factor;
   demo 4's bars, absorption within 0.08 and the source within 0.5 m; demo
   6's shapes and four finite WAVs; the live duplex's length through the
   native engine); a render's time in CUDA events. Then demos 1, 2, 3, 5
   and 6 against the float64 oracle (core/tracer_ref.py) on the first
   4,096 of their own directions, on the demo's scene and pose (demo 3 its
   first render with the receiver inside the room, demo 6 pair 0): demos 1
   and 2 per bin at rtol 2e-3, atol 1e-8 with each ray's deposit checked
   against the oracle's (a ray whose deposit moved, a near-tangent
   receiver crossing decided the other way in float32, is reported and may
   be at most 0.1% of the rays), demos 3, 5, 6 on assert_ir_close(exact=
   False); the largest relative bin error and the relative L1 printed.
   Last, four paths not run on the card before: one step of demo 4's fit
   at 1M rays by the replay (K1 records) and by the full method, their
   gradients within 1% (phase 16's gate); demo 6's matrix on the office
   with demo 2's four bands (posed schedule and K2, 8M rays x 40 bounces)
   through mix_sources, one pair against a single render_ir, the mix's
   band splits run again under LaunchRecorder and held to the plain
   product; a recording
   and its replay at 100 bounces on the box against the forward render;
   K5 on the 8-band layout against its plain version, bit for bit.
24. tuned.py's constants measured, none changed: renders of 1,000,064 rays
   through render_ir, every render of a group from the same seeded
   directions, each variant's launches counted once (the counters set to 0
   just before, read just after: the route it took) and its renders timed
   with CUDA events, variants interleaved (median, min and max of 7; K1
   over the office's 19,852 rows, ~2 s a render, of 3). The route
   crossover: K1 over every row against the schedule and K2 in clusters of
   32 on icosphere rooms of 320, 1,280 and 5,120 triangles (radius 3,
   absorption 0.2, 32 bounces), demo 5's 332-triangle room (8 bounces) and
   the office (32); cluster sizes 16, 32, 64 and 128 for the schedule and
   K2 on the 5,120-triangle icosphere and the office, K5 at 32 and 128 on
   the office; the box's round budgets (8, 24, 68), (4, 12, 84),
   (12, 36, 52), (8, 92), (6, 12, 24, 58), each round's alive rays and
   bounces made; native_rng on and off on the box and the office;
   pair_batch 16, 1, 4, 8 on demo 6's 2 x 4 x 1M-ray matrix. Each IR held
   to its scene's default variant (tuned.py's choice) on
   assert_ir_close(exact=False), per pair for the matrix, and with
   native_rng (another stream) per-ear energy within 5%; one JSON line a
   group ("tuned_sweep") with the card's name and power limit.
25. the key kernel (csrc/compaction_keys.cu, the clustered route's dir72
   sort keys in a bounds pass and a key pass) against the plain chain
   (raytrace_cuda._compaction_keys) int32 for int32, and the states sorted
   by each bit for bit, on office states at 100 bounces: 1,000,064 rays
   (n_poses 1) and the office matrix's 4 x 250,112 (n_poses 4), each at
   the start, after 1, 16 and 64 bounces (dead and padded rays), at
   cell_bits 3, 5 and 7; its time a call and on the device (20 calls in
   one CUDA graph), the plain chain's, and the bound (44 bytes a ray over
   3.35 TB/s); its calls around one office render at 100 bounces (99
   reorders, two launches each).
26. the replay's kernel pair (csrc/replay.cu: the forward walks each
   depositing ray's recorded path, the backward reduces the absorption
   table's gradient) on recorded office paths, 1,000,064 rays x 100
   bounces, at 1, 4 and 8 bands: replay_events with only the table
   requiring a gradient (the pair, one launch each) against the same call
   with a receiver that requires one (the eager chain): ev_bin and ev_ear
   equal, ev_w within 1e-6 relative; the table's gradient of a weighted
   sum of ev_w from both against the float64 plain backward on the card,
   within REPLAY_GRAD_RTOL of each entry plus REPLAY_GRAD_ATOL of the
   largest (float32 atomics add in their own order); the device time of
   the forward and of the backward (20 calls in one CUDA graph) beside
   their bounds (bytes at 3.35 TB/s), the pair through autograd a call and
   the chain's forward + backward on the absorption alone.
27. the band-split kernel (csrc/band_split.cu: each band's spectrum with
   band_gains' gains computed on the card): a spectrum of ones through it
   against band_gains, float32 bit for bit, at the octave office's edges
   (120,001 and 48,001 bins at 48 kHz), the default 4 bands (40,001 bins
   at 16 kHz) and (500, 2000) (12,001 bins at 8 kHz), any differing gain
   reported with its place and held to one float32 ulp (the card's
   float64 cos against the host's at a float32 rounding boundary);
   on a seeded 5 s, 48 kHz signal at 8 bands, the kernel's band spectra
   against the plain product (band_gains uploaded, the broadcast
   product), each part bit for bit or, where a gain moved by its ulp,
   within 4 x 2^-24 of the spectrum's part, and split_bands' bands against
   the plain path's, bit for bit where the spectra are, summing to the
   signal within 2e-6; its device time (20 calls in one CUDA graph) beside
   its bound ((1 + B) x F x 8 bytes at 3.35 TB/s), the broadcast
   product's with the gains already on the card and that of the same
   gains built from float64 PyTorch operations on the card, the whole
   split a call against the plain path's (the host's numpy included) and
   the PyTorch operations' variant, at 120,001 and 48,001 bins; one launch
   a banded file convolution and a banded live block. The kernels line's
   launches are the banded export's in phase 12 (one, asserted there); the
   demos' launches are held to the plain product under LaunchRecorder.
28. the pose pair (csrc/replay.cu's ar2_replay / ar2_replay_bwd given tan:
   the replay that carries each ray's tangents against the emitter) on
   recorded office paths at 1,000,064 rays x 100 bounces for each of the
   source localization's three receivers: its events and chord equal to
   the absorption kernel's and to the plain version's (chain_events with
   the tangents, on the card) bit for bit, its tangents within
   POSE_TAN_BAR of the plain version's; the emitter's gradient of a
   seeded loss on ev_bin and ev_w against a float64 sum of the kernel's
   own tangents within POSE_GRAD_BAR (relative L2; with and without the
   table's gradient), the chain's autograd gap beside it, and the table's
   gradient within phase 26's bar; the device times of the forward and
   the backward beside the absorption pair's and beside the least bytes'
   bound (perfbench/replay_pose_bytes.py at 3.35 TB/s); the three
   receivers through autograd (three launches of each, none of the
   absorption pair) a call, and their summed device time against the
   bound of one step's three path sets; and the pose pair's own entry
   point, 3 steps of fit_scene_parameters(fit_emitter=True,
   method="replay") over the three receivers, which launch the pose pair
   once a receiver a step and neither the absorption pair nor the eager
   chain (the kernels line's replay_pose launches).

Then one JSON line of the kernels: name, route, source, the TPU kernel it
replaces, "demo_launches" (the launches of its counter in the first runs of
the demos' mains, phase 23 and demo 5's in phase 22 (a)), launches on its
main path (the export of phase 5, whose IR is
the fused hard-binning entry's, and for K3's flat-bin entry the office fit
of phase 17, which bins softly; for K6 and K7
the experimentation runs of phase 20, for the posed K6 the matrix of phase
18; for the
clustered route's kernels that of phase 7; K1, the hard-binning entry, the
schedule and K2 also give the launches of phase 21's runs,
"main_mode_launches" (the main mode) and "live_launches" (the live duplex
runs: the box's for K1, the office's for the schedule and K2, both for the
hard-binning entry); K1, K3, the hard-binning entry, the schedule, K2, the
posed K1 and K3-bwd also "sharded_launches", those of phase 22 (a)'s
product calls; for the posed kernels and the
posed histogram the matrices of phase 10 (for the posed histogram its fused hard-binning entry), for the
4-band posed K1 that of phase 12; for K4 the render of phase 11; for K3-bwd the office fit of phase
17; for K5 the recording without the schedule of phase 15), max abs error,
ms, plain ms (for K1 those of the export's first round, rounds 2 and 3
under "round2" and "round3" with their tests; for the posed K1 those of
the first of its two launches, the 8-bounce round; the 32-bounce round's
under "round2"), the bound (the larger
of bytes moved over 3.35 TB/s and FP32 operations over 67 TFLOP/s, worked
out from this run's inputs; the schedule is bound by its bytes, with the
all-pairs slab-test count under "all_pairs_bound_ms" and its times at the
three states under "states", as K2's; K5 on its visited clusters' triangle
tests and a slab test of each superbox, every box's slab test under
"all_pairs_bound_ms"; K6 is bound on K1's 40 operations a
test ("high": the test's 7 FP32 operations at 67 TFLOP/s plus its
product's 240 at the bf16 rate, 989 TFLOP/s, K1's bound under
"k1_bound_ms"), with what it issues under "issued_bound_ms", K1's time on
the same state under "k1_ms" and the route's four rounds under "rounds";
K7 on
the valid triangles, with its padded columns under "padded_bound_ms"; K7's
budget-6 round of the box, with each of version 1's rounds under
"budgets", the icosphere's under "icosphere_512" and the 1,280-triangle
icosphere's under "multi_chunk", K1's time on the same state beside each),
what bounds it, and the time of one PyTorch call that computes the same function where
there is one (K3: index_add_ over the in-range events; the hard-binning
entry: index_add_ over its deposits, made beforehand). K3, the
hard-binning entry and K4 also give "device_ms", the device time of one
call (20 calls in one CUDA graph); their other shapes stand under
"bands4", "bands8", "box_events", "flat" and "cases". Last, the result
line. With no CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N_RAYS = 1_000_000
SR = 16000
IR_SECONDS = 2
MAX_BOUNCES = 100
ROOM = (14.0, 9.0, 11.0)      # the bench's procedural box, centred at 0
EMITTER = (0.0, 0.0, 0.0)
RECEIVER = (2.5, 1.5, 2.0)    # inside the room
ABSORPTION = 0.3
# The JAX package's large-scene workload (benchmarks/large_scene.py:61-82).
OFFICE_TRIS = 20000
OFFICE_BOUNCES = 32
OFFICE_RECEIVER = (6.0, 1.0, -8.0)


# The multi-pose demo of the JAX package (examples/demo_6_multipose.py).
MULTI_ROOM = (18.0, 10.0, 14.0)
MULTI_ABSORPTION = 0.25
MULTI_BOUNCES = 40
MULTI_BUDGETS = (8, 32)
MULTI_EMITTERS = np.array([[-5.0, 0.0, -4.0], [6.0, 1.0, 5.0]], np.float32)
MULTI_LISTENERS = np.stack([np.linspace(-6.0, 6.0, 4), np.zeros(4),
                            np.linspace(4.0, -4.0, 4)],
                           axis=1).astype(np.float32)
MULTI_YAWS = np.linspace(0.0, 270.0, 4).astype(np.float32)
# Its large-scene form: the office, 1 source x 4 listeners.
OFFICE_LISTENERS = np.array([OFFICE_RECEIVER, (-10.0, 2.0, 5.0),
                             (10.0, -3.0, 15.0), (0.5, 0.0, -1.0)],
                            np.float32)
OFFICE_MATRIX_RAYS = 250_000
# Per-band wall absorption of the banded phases (4 bands, split at the
# filterbank's default 250 / 1000 / 4000 Hz).
BANDED_ABSORPTION = (0.1, 0.25, 0.4, 0.6)
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and FP32 rate outside the tensor cores (an FMA counts as two; the
# kernels are built without FMA contraction, so they can reach half of it).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TRI_TEST_OPS = 40   # FP32 operations of one ray-triangle test (intersect)
SLAB_TEST_OPS = 23  # of one ray-box slab test (tile_schedule)
GROUP_TEST_OPS = 79  # of one ray-triangle test as K6 "highest" issues it:
#                      six quantities of 6 products and 6 adds (the ray's 1
#                      and 0 folded, the packing's zeros included) plus the
#                      test's 7. The function is K1's test, so "highest" is
#                      bound at TRI_TEST_OPS; this count gives
#                      "issued_bound_ms"
# K6 "high": the test's FP32 operations after the quantities (the negation,
# the division, u, v, u + v), and the product's operations on the tensor
# cores: 20 non-zero terms a quantity (240 a test), 24 as issued (288: a
# k16 and a k8 step a quantity).
GROUP_HIGH_FP32_OPS = 7
GROUP_HIGH_MMA_OPS = 240
GROUP_HIGH_MMA_AS_RUN = 288
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores (data sheet)
# K6 "high" against its plain version, whose f32 sums run in index order
# where the tensor cores add in their own (PERF.md): at least
# HIGH_BAR_ON_PATH of the rays on the plain version's path (LTRI, DEPTH,
# DONE, RECVD, EVE equal), at least HIGH_BAR_WITHIN of them also within
# HIGH_BAR_REL (relative to max(|x|, 1)) in every other column, and every
# ray on that path within HIGH_BAR_REL_ALL. In rounds of HIGH_BAR_OWN_FROM
# bounces and more (the route's rounds of 24 and 58), where a ray's
# differences grow bounce by bounce and the plain "high" itself is further
# than that from K1's f32 on the same state, the kernel may be as far from
# the plain "high" as the plain "high" is from f32: the bar there is the
# precision's own spread, no tighter.
HIGH_BAR_ON_PATH = 0.999
HIGH_BAR_WITHIN = 0.995
HIGH_BAR_REL = 1e-4
HIGH_BAR_REL_ALL = 1e-2
HIGH_BAR_OWN_FROM = 24
INIT_RAY_OPS = 150  # integer + FP32 operations of K4 per ray (10 Philox
#                     rounds, the sphere mapping, sinf, cosf)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the FP32
    rate, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def round_tests(before: torch.Tensor, after: torch.Tensor) -> int:
    """Ray-bounces of one K1 round in which the ray searched the triangles:
    every completed bounce, and the last iteration of a ray that ended at
    the receiver or missed. (A ray that ends because it may not continue
    searches nothing; none does in the rounds measured here.)"""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    bounces = (after[rc._C_DEPTH] - before[rc._C_DEPTH]).double().sum()
    ended = ((after[rc._C_DONE] != 0) & (before[rc._C_DONE] == 0)).sum()
    return int(bounces) + int(ended)


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, setup=lambda: ()) -> float:
    """Median CUDA-event time of ``fn(*setup())`` over ``reps`` runs after
    one warm-up; ``setup`` runs outside the timed window."""
    times = []
    for r in range(reps + 1):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in one CUDA
    graph, the replay between two events over ``calls``, median of
    ``reps`` (the host's path into each launch is not in the window)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def index_add_call(bins: torch.Tensor, weights: torch.Tensor, n_bins: int):
    """One ``index_add_`` over the in-range events, the filtering done here,
    outside any timed window: K3's library yardstick."""
    keep = (bins >= 0) & (bins < n_bins)
    idx, w = bins[keep].long(), weights[keep].contiguous()
    out = torch.zeros((n_bins, weights.shape[1]), dtype=torch.float32,
                      device=weights.device)
    return lambda: out.index_add_(0, idx, w)


def unit_dirs(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def assert_columns_close(kern: torch.Tensor, plain: torch.Tensor,
                         what: str) -> None:
    """Every state column of ``kern`` within rtol 1e-5 of ``plain`` (atol
    1e-5 of the column's scale)."""
    for c in range(kern.shape[0]):
        scale = float(plain[c].abs().max()) or 1.0
        assert torch.allclose(kern[c], plain[c], rtol=1e-5,
                              atol=1e-5 * scale), f"{what}, column {c} differs"


def _smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = _smi_line()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    log(smi)
    return name


def phase_build() -> None:
    from audiorenderingv2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{lib_path.relative_to(REPO)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "ptxas info" in line or "spill" in line or line.startswith("#"):
            log(f"  {line.strip()}")


def phase_histogram() -> dict:
    """K3's flat-bin entry on 1M seeded events (30% out of range) at 1, 4
    and 8 bands against its plain version and a float64 sum; returns the
    1-band numbers with the 4- and 8-band ones under "bands4", "bands8"."""
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc

    n_bins = 2 * IR_SECONDS * SR
    n_events = -(-N_RAYS // 128) * 128  # the export path's n_pad
    rng = np.random.default_rng(3)
    bins = rng.integers(0, n_bins, size=n_events)
    out = rng.random(n_events) < 0.3
    bins[out] = np.where(rng.random(out.sum()) < 0.5,
                         -rng.integers(1, 1000, size=out.sum()),
                         n_bins + rng.integers(0, 1000, size=out.sum()))
    bins = bins.astype(np.int32)
    result = {}
    for n_bands in (1, 4, 8):
        w = (rng.random((n_events, n_bands)) * 2e-9).astype(np.float32)
        b_d = torch.from_numpy(bins).cuda()
        w_d = torch.from_numpy(w).cuda()
        kern = hc.histogram_sum_banded(b_d, w_d, n_bins)
        plain = hc.histogram_plain(b_d, w_d, n_bins)
        torch.cuda.synchronize()
        keep = (bins >= 0) & (bins < n_bins)
        ref = np.stack([np.bincount(bins[keep], weights=w[keep, k]
                                    .astype(np.float64), minlength=n_bins)
                        for k in range(n_bands)], axis=1)
        k_np, p_np = kern.cpu().numpy(), plain.cpu().numpy()
        occ = ref > 0
        rel_k = np.abs(k_np[occ] - ref[occ]) / ref[occ]
        rel_p = np.abs(p_np[occ] - ref[occ]) / ref[occ]
        rel_kp = np.abs(k_np[occ] - p_np[occ]) / np.abs(p_np[occ])
        err = float(np.abs(k_np - p_np).max())
        # atomics add in a run-dependent order: a few ulp over ~11 terms
        assert rel_kp.max() < 1e-5, ("K3 vs plain", n_bands, rel_kp.max())
        assert np.median(rel_k) < 1e-6 and np.median(rel_p) < 1e-6, \
            ("K3 vs float64", np.median(rel_k), np.median(rel_p))
        assert not np.any(k_np[~occ]), "K3 wrote a bin no event maps to"
        call = lambda: hc.histogram_sum_banded(b_d, w_d, n_bins)  # noqa: E731
        library = index_add_call(b_d, w_d, n_bins)
        ms, dev_ms = median_ms(call, 20), device_ms(call)
        plain_ms = median_ms(lambda: hc.histogram_plain(b_d, w_d, n_bins),
                             20)
        library_ms = median_ms(library, 20)
        log(f"K3 histogram, {n_events} events x {n_bands} band(s) -> "
            f"{n_bins} bins: kernel {ms:.4f} ms a call, {dev_ms:.4f} ms "
            f"device (CUDA graph of 20), plain {plain_ms:.4f} ms, "
            f"index_add_ alone {library_ms:.4f} ms; max abs err vs plain "
            f"{err:.3e}, median rel err vs float64 {np.median(rel_k):.3e}")
        # Bytes: bins and weights read, the accumulator written; one add
        # per kept event and band.
        result[n_bands] = {
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            **bound(nbytes(b_d, w_d, kern), int(keep.sum()) * n_bands),
            "library_ms": library_ms}
    return {**result[1], "bands4": result[4], "bands8": result[8]}


def _box_scene():
    from audiorenderingv2_tpu_torch import testing

    return testing.scene_from_arrays(*testing.box_room(ROOM), ABSORPTION)


def phase_trace() -> dict:
    from audiorenderingv2_tpu_torch import constants, testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.params import TraceParams
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    params = TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                         base_power=3.62, max_bounces=MAX_BOUNCES,
                         hrtf_absorption_rate=0.9)
    emitter = torch.tensor(EMITTER, device=dev)
    receiver = torch.tensor(RECEIVER, device=dev)

    def box_rows(n_bands):
        absorb = ABSORPTION if n_bands == 1 else np.tile(
            np.linspace(0.1, 0.6, n_bands).astype(np.float32), (12, 1))
        scene = testing.scene_from_arrays(*testing.box_room(ROOM), absorb)
        return rc.pack_tris_rows(tracer.scene_to_arrays(scene, device=dev),
                                 n_bands)

    def start_state(n, n_bands=1):
        e0 = params.base_power / (n * constants.SPHERE_VOLUME)
        d = torch.from_numpy(unit_dirs(n, 11)).to(dev)
        n_pad = -(-n // 128) * 128
        return (rc.init_state(d, emitter, e0, n_pad, n_bands),
                rc.scalars(emitter, receiver, 30.0, e0, params))

    rows = box_rows(1)
    n_valid = int((rows[:, rc._R_VAL] > 0).sum())
    assert rc.k1_branch(rows.shape[0]) == "one_chunk"

    # The IR after 100 bounces in one round, 64k rays.
    state, scal = start_state(65536)
    kern = rc.trace_round(state.clone(), rows, scal, params, MAX_BOUNCES)
    plain = rc.trace_round_plain(state.clone(), rows, scal, params,
                                 MAX_BOUNCES)
    torch.cuda.synchronize()
    _assert_same_bits(kern, plain, "K1, 100 bounces in one round")

    def ir_of(st):
        return tracer._histogram_from_events(
            st[rc._C_EVB], st[rc._C_EVW][:, None].contiguous(),
            st[rc._C_EVE].to(torch.int32), params, False).cpu()

    ir_k = ir_of(kern)
    assert np.all((ir_k > 0).sum(dim=1).numpy() >= 200)
    ms100 = median_ms(lambda s: rc.trace_round(s, rows, scal, params,
                                               MAX_BOUNCES), 5,
                      setup=lambda: (state.clone(),))
    log(f"K1 100 bounces in one round, 65536 rays: bit-identical to the "
        f"plain version in every column; energy {float(ir_k.sum()):.6e}, "
        f"per-ear nonzero bins {(ir_k > 0).sum(dim=1).tolist()}; kernel "
        f"{ms100:.3f} ms")

    # The export path's round budgets with the alive-first partition
    # between rounds, the kernel's chain and the plain chain run apart, at
    # 64k rays and at the export's 1M: bit for bit after every round. At 1M
    # each round's times, tests and bound.
    budgets = tuned.round_budgets_for(MAX_BOUNCES)
    rounds, err = [], 0.0
    for n in (65536, N_RAYS):
        state, scal = start_state(n)
        kern, plain = state.clone(), state.clone()
        for k, budget in enumerate(budgets):
            if k:
                kern = rc._partition_alive_first(kern)
                plain = rc._partition_alive_first(plain)
            before = plain.clone()
            kern = rc.trace_round(kern, rows, scal, params, budget)
            plain = rc.trace_round_plain(plain, rows, scal, params, budget)
            torch.cuda.synchronize()
            what = f"K1 round {k + 1} (budget {budget}), {n} rays"
            err = max(err, _assert_same_bits(kern, plain, what))
            alive = int((kern[rc._C_DONE] == 0.0).sum())
            line = (f"{what}: bit-identical to the plain version in every "
                    f"column; {alive} alive after")
            if n == N_RAYS:
                ms = median_ms(lambda s, b=budget: rc.trace_round(
                    s, rows, scal, params, b), 5, setup=lambda: (
                        before.clone(),))
                plain_ms = median_ms(lambda s, b=budget: rc.trace_round_plain(
                    s, rows, scal, params, b), 1, setup=lambda: (
                        before.clone(),))
                tests = round_tests(before, kern) * n_valid
                rounds.append({"budget": budget, "tests": tests, "ms": ms,
                               "plain_ms": plain_ms,
                               **bound(2 * nbytes(before) + nbytes(rows, scal),
                                       tests * TRI_TEST_OPS)})
                line += (f"; {tests:.4g} ray-triangle tests of the {n_valid} "
                         f"valid rows; kernel {ms:.3f} ms, plain "
                         f"{plain_ms:.3f} ms, bound "
                         f"{rounds[-1]['bound_ms']:.4f} ms by "
                         f"{rounds[-1]['bound_by']}")
            log(line)
        if n == N_RAYS:
            ir_k = ir_of(kern)
            assert np.all((ir_k > 0).sum(dim=1).numpy() >= 200)
    log(f"K1 the render's three rounds, {N_RAYS} rays: "
        f"{sum(r['ms'] for r in rounds):.3f} ms, bound "
        f"{sum(r['bound_ms'] for r in rounds):.4f} ms")

    # An 8-band layout (LB = 8, 32 state columns), once.
    rows8 = box_rows(8)
    state, scal = start_state(65536, 8)
    params8 = dataclasses.replace(params, n_bands=8)
    kern = rc.trace_round(state.clone(), rows8, scal, params8, 8)
    plain = rc.trace_round_plain(state.clone(), rows8, scal, params8, 8)
    torch.cuda.synchronize()
    _assert_same_bits(kern, plain, "K1, 8 bands")
    log(f"K1 8 bands ({kern.shape[0]} state columns), 65536 rays, an "
        f"8-bounce round: bit-identical to the plain version in every column")
    first = rounds[0]
    return {"max_abs_err": err, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "tests": first["tests"], "round2": rounds[1], "round3": rounds[2]}


def _reset_launches() -> None:
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc
    from audiorenderingv2_tpu_torch.ops import group_cuda as gc
    from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc
    from audiorenderingv2_tpu_torch.ops import replay_cuda as rp
    from audiorenderingv2_tpu_torch.ops import v1_cuda as v1
    from audiorenderingv2_tpu_torch.ops import filterbank as fb

    rc.launches = rc.posed_launches = rc.init_launches = hc.launches = 0
    rp.launches = rp.bwd_launches = 0
    rp.pose_launches = rp.pose_bwd_launches = 0
    rc.compaction_keys_launches = 0
    hc.binned_launches = 0
    sc.tile_schedule_launches = sc.trace_round_sched_launches = 0
    sc.trace_round_sched_posed_launches = 0
    hc.bwd_launches = tc.trace_traverse_launches = 0
    gc.trace_round_group_launches = gc.trace_round_group_posed_launches = 0
    v1.trace_round_v1_launches = 0
    fb.band_split_launches = 0


def _read_launches() -> dict:
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc
    from audiorenderingv2_tpu_torch.ops import group_cuda as gc
    from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc
    from audiorenderingv2_tpu_torch.ops import replay_cuda as rp
    from audiorenderingv2_tpu_torch.ops import v1_cuda as v1
    from audiorenderingv2_tpu_torch.ops import filterbank as fb

    return {"trace_round": rc.launches,
            "replay": rp.launches, "replay_bwd": rp.bwd_launches,
            "replay_pose": rp.pose_launches,
            "replay_pose_bwd": rp.pose_bwd_launches,
            "trace_round_posed": rc.posed_launches,
            "init_state": rc.init_launches, "histogram": hc.launches,
            "compaction_keys": rc.compaction_keys_launches,
            "histogram_binned": hc.binned_launches,
            "histogram_bwd": hc.bwd_launches,
            "tile_schedule": sc.tile_schedule_launches,
            "trace_round_sched": sc.trace_round_sched_launches,
            "trace_round_sched_posed": sc.trace_round_sched_posed_launches,
            "trace_traverse": tc.trace_traverse_launches,
            "trace_round_group": gc.trace_round_group_launches,
            "trace_round_group_posed": gc.trace_round_group_posed_launches,
            "trace_round_v1": v1.trace_round_v1_launches,
            "band_split": fb.band_split_launches}


def _write_inputs(tmp: Path, scene_file: str = "room.obj",
                  receiver=RECEIVER, max_bounces: int = MAX_BOUNCES,
                  absorption=ABSORPTION) -> Path:
    """The dry signal and config.json in ``tmp`` for the scene file that
    the caller wrote there; a list of absorptions makes a banded scene."""
    from audiorenderingv2_tpu_torch.io import wav

    rng = np.random.default_rng(7)
    t = np.arange(5 * SR) / SR
    dry = 0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    dry += 0.2 * rng.standard_normal(t.size) * (np.sin(2 * np.pi * t) > 0.7)
    wav.write_wav(tmp / "dry.wav", dry[None, :].astype(np.float32), SR)
    cfg = {
        "renderer_parameters": {"ir_length_in_seconds": IR_SECONDS},
        "scene_parameters": {
            "mono": False, "audio_file_path": "dry.wav",
            "scene_file_path": scene_file,
            "initial_emitter_pos": dict(zip("xyz", EMITTER)),
            "initial_receiver_pos": dict(zip("xyz", receiver))},
        "pathtracer_parameters": {
            "base_power": 3.62, "rays": {"x": 100, "y": 100, "z": 100},
            "ray_energy_threshold": 0.0, "ray_max_bounces": max_bounces,
            "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls", "mat_absorption": absorption}]},
    }
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path


def phase_export() -> dict:
    from audiorenderingv2_tpu_torch import context, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.io import wav

    with tempfile.TemporaryDirectory() as tmp:
        testing.write_box_obj(Path(tmp) / "room.obj", ROOM, material="walls")
        cfg = _write_inputs(Path(tmp))
        out_path = Path(tmp) / "export.wav"
        _reset_launches()
        t0 = time.perf_counter()
        ctx = context.load_context(cfg, device="cuda")
        context.export_audio(ctx, out_path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        log(f"export: {wall:.2f} s wall (first call, scene load included); "
            f"launches {launches}")
        assert launches["trace_round"] > 0, launches
        assert launches["histogram_binned"] > 0, launches
        assert launches["histogram"] == 0, launches
        assert launches["trace_round_posed"] == launches["init_state"] == 0

        audio = wav.read_wav(out_path)
        assert audio.n_channels == 2 and audio.sample_rate == SR, \
            (audio.n_channels, audio.sample_rate)
        assert audio.n_frames == 5 * SR and np.isfinite(audio.samples).all()
        peaks = np.abs(audio.samples).max(axis=1)
        assert np.all(np.abs(peaks - 1.0) < 1e-3), peaks
        r = ctx.renderer
        ir = r.ir
        assert ir.shape == (2, IR_SECONDS * SR) and np.isfinite(ir).all()
        nz = (ir > 0).sum(axis=1)
        assert np.all(nz >= 200), nz
        log(f"export: WAV stereo {SR} Hz, {audio.n_frames} frames, peaks "
            f"{peaks.tolist()}; IR nonzero bins per ear {nz.tolist()}, "
            f"energy {ir.sum(axis=1).tolist()}")

        # The slice on the card against the CPU plain path, 64k directions.
        d = unit_dirs(65536, 5)
        args = (r.emitter_pos, r.receiver_pos, r.receiver_yaw_deg, r.params,
                r.opts)
        ir_gpu = tracer.trace_ir(r.sc, torch.from_numpy(d).cuda(), *args)
        ir_cpu = tracer.trace_ir(tracer.scene_to_arrays(ctx.scene,
                                                        device="cpu"),
                                 torch.from_numpy(d), *args)
        testing.assert_ir_close(ir_gpu.cpu().numpy(), ir_cpu.numpy(),
                                exact=False)
        log("export path, 65536 shared directions: CUDA IR passes "
            "assert_ir_close(exact=False) against the CPU plain path")

        render_ms = median_ms(r.render, 5)
        samples = torch.from_numpy(ctx.audio.mono()).cuda()
        conv_ms = median_ms(lambda: r.convolve_audio_file_device(samples), 5)
        log(f"export path timings ({N_RAYS} rays, {MAX_BOUNCES} bounces, "
            f"{IR_SECONDS} s IR at {SR} Hz, 5 s signal): render "
            f"{render_ms:.3f} ms (median of 5), convolve {conv_ms:.3f} ms")
    return launches


def _office_params(n_bands: int = 1):
    from audiorenderingv2_tpu_torch.core.params import TraceParams

    return TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                       base_power=3.62, max_bounces=OFFICE_BOUNCES,
                       hrtf_absorption_rate=0.9, n_bands=n_bands)


@functools.cache
def _office_clustered():
    """The office scene, Morton-sorted into clusters of 32, on the card:
    (unsorted scene, clustered SceneArrays, packed rows, packed boxes)."""
    from audiorenderingv2_tpu_torch import accel, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    scene = testing.office_scene(OFFICE_TRIS)
    sorted_scene, clusters = accel.prepare_scene(scene, cluster_size=32)
    scc = tracer.scene_to_arrays(sorted_scene, 128, device="cuda",
                                 clusters=clusters)
    return (scene, scc, *rc.pack_tris_clusters(scc))


def k2_work(state: torch.Tensor, sched: torch.Tensor, cs: int) -> int:
    """Ray-triangle tests of one K2 round: every ray of a tile that is not
    done tests the rows of every candidate cluster of its tile."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    alive = (state[rc._C_DONE] == 0).view(-1, 128).sum(dim=1)
    return int((alive.double() * sched[:, 0].double()).sum()) * cs


def k2_warp_work(state: torch.Tensor, sched: torch.Tensor, rows, boxes,
                 scal, params, rays_per_pose=None) -> tuple[int, int]:
    """K2's work under its per-warp cull: (the (warp, candidate) pairs
    whose rows a warp tests, by ``schedule_cuda.k2_search``, the kernel's
    rule; the ray-triangle tests of those pairs, every ray of the warp
    that is not done testing the cluster's rows), the counterpart of
    :func:`k2_work`'s tile-union count."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    tested = sc.k2_search(state, rows, boxes, sched, scal, params,
                          rays_per_pose)[3].double()
    alive = (state[rc._C_DONE] == 0).view(-1, 32).sum(dim=1).double()
    cs = rows.shape[0] // boxes.shape[0]
    return int(tested.sum()), int((alive * tested).sum()) * cs


@functools.cache
def _office_packed(cs: int, n_bands: int):
    """The office in clusters of ``cs`` on the card, packed for ``n_bands``
    bands (its one absorption value in every band): (rows, boxes)."""
    from audiorenderingv2_tpu_torch import accel
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    scene = _office_clustered()[0]
    sorted_scene, clusters = accel.prepare_scene(scene, cluster_size=cs)
    scc = tracer.scene_to_arrays(sorted_scene, 128, device="cuda",
                                 clusters=clusters)
    return rc.pack_tris_clusters(scc, n_bands)


def _office_start(n: int, seed: int, params):
    """The office's start state of ``n`` rays from the emitter (padded to
    128) and its scalar row."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    emitter = torch.tensor(EMITTER, device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    d = torch.from_numpy(unit_dirs(n, seed)).to(dev)
    return (rc.init_state(d, emitter, e0, -(-n // 128) * 128,
                          params.n_bands),
            rc.scalars(emitter, torch.tensor(OFFICE_RECEIVER, device=dev),
                       0.0, e0, params))


def _cluster_rounds(state, rows, boxes, scal, params, k: int):
    """``k`` clustered rounds through the kernels: schedule, K2, sort."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    for _ in range(k):
        state = sc.trace_round_sched(state, rows, boxes,
                                     sc.tile_schedule(state, boxes), scal,
                                     params)
        state = rc._sort_state_by_keys(state, rc.compaction_keys(state))
    return state


def cluster_state_check(n: int, n_bands: int, cs: int,
                        timed: bool = False) -> dict:
    """The schedule kernel against its plain version, integer for integer,
    and K2 against its plain version, bit for bit in every column, on the
    office in clusters of ``cs`` at ``n`` rays and ``n_bands`` bands, on
    three states reached through the kernels: round 1 (the start state,
    unsorted), after one bounce and the sort, and after 16 bounces. With
    ``timed``, both kernels' times at each state beside their bounds:
    K2's by operations (40 a test made), the schedule's by bytes (seven
    state columns read, the boxes read, the rows written), with the
    all-pairs slab-test count (23 operations a ray and box) beside it.
    Returns the times per state."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    params = _office_params(n_bands)
    rows, boxes = _office_packed(cs, n_bands)
    start, scal = _office_start(n, 13, params)
    after1 = _cluster_rounds(start.clone(), rows, boxes, scal, params, 1)
    states = {"round1": start, "after1": after1,
              "after16": _cluster_rounds(after1.clone(), rows, boxes, scal,
                                         params, 15)}
    out = {}
    for name, st in states.items():
        what = (f"office, clusters of {cs}, {n_bands} band(s), "
                f"{st.shape[1]} rays, {name}")
        sk = sc.tile_schedule(st, boxes)
        sp = sc.tile_schedule_plain(st, boxes)
        torch.cuda.synchronize()
        assert torch.equal(sk, sp), f"{what}: schedule rows differ"
        kv, pv = (torch.zeros(sk.shape[0], dtype=torch.int32,
                              device=st.device) for _ in range(2))
        kern = sc.trace_round_sched(st.clone(), rows, boxes, sk, scal,
                                    params, visits=kv)
        plain = sc.trace_round_sched_plain(st.clone(), rows, boxes, sk,
                                           scal, params, visits=pv)
        torch.cuda.synchronize()
        _assert_same_bits(kern, plain, f"{what}: K2")
        assert torch.equal(kv, pv), f"{what}: K2's warp visits differ"
        counts = sk[:, 0].double()
        live = counts > 0
        union_tests = k2_work(st, sk, cs)
        pairs, warp_tests = k2_warp_work(st, sk, rows, boxes, scal, params)
        assert pairs == int(kv.sum())
        line = (f"{what}: schedule rows equal the plain rows, K2 "
                f"bit-identical to its plain version, its warp visits equal "
                f"the plain ones; candidates per live "
                f"tile {float(counts[live].mean()):.2f} (max "
                f"{int(counts.max())}, {int(live.sum())} of {sk.shape[0]} "
                f"tiles live); warps test {pairs} (warp, candidate) pairs "
                f"of the tile union's {4 * int(counts.sum())} "
                f"({100.0 * pairs / max(1, 4 * int(counts.sum())):.1f}%); "
                f"ray-triangle tests {warp_tests} warp-culled, "
                f"{union_tests} tile union")
        if timed:
            n_live = int((st[rc._C_DONE] == 0).sum())
            k2 = {"ms": median_ms(
                lambda s: sc.trace_round_sched(s, rows, boxes, sk, scal,
                                               params), 5,
                setup=lambda: (st.clone(),)),
                  **bound(2 * nbytes(st) + nbytes(sk, rows, scal),
                          union_tests * TRI_TEST_OPS),
                  "warp_bound_ms": bound(
                      2 * nbytes(st) + nbytes(sk, rows, scal),
                      warp_tests * TRI_TEST_OPS)["bound_ms"],
                  "tests": union_tests, "warp_tests": warp_tests,
                  "warp_pairs": pairs}
            sched = {"ms": median_ms(lambda: sc.tile_schedule(st, boxes),
                                     10),
                     **bound(7 * 4 * st.shape[1] + nbytes(boxes, sk), 0),
                     "all_pairs_bound_ms": bound(
                         0, n_live * boxes.shape[0] * SLAB_TEST_OPS)[
                             "bound_ms"]}
            out[name] = {"trace_round_sched": k2, "tile_schedule": sched}
            line += (f"; K2 {k2['ms']:.3f} ms (bound {k2['bound_ms']:.4f}, "
                     f"{k2['ms'] / k2['bound_ms']:.1f}x; on the warp-culled "
                     f"tests {k2['warp_bound_ms']:.4f}, "
                     f"{k2['ms'] / k2['warp_bound_ms']:.1f}x), schedule "
                     f"{sched['ms']:.3f} ms (bytes bound "
                     f"{sched['bound_ms']:.4f}; all-pairs "
                     f"{sched['all_pairs_bound_ms']:.4f})")
        log(line)
    return out


def office_trace_check(n: int = 65536) -> None:
    """A whole office trace (32 one-bounce rounds) at ``n`` rays, the
    kernels' chain (schedule kernel, K2) and the plain chain run apart,
    each sorted by its own keys: bit for bit after every round."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    params = _office_params()
    _, _, rows, boxes = _office_clustered()
    kern, scal = _office_start(n, 16, params)
    plain = kern.clone()
    for k in range(OFFICE_BOUNCES):
        kern = sc.trace_round_sched(kern, rows, boxes,
                                    sc.tile_schedule(kern, boxes), scal,
                                    params)
        plain = sc.trace_round_sched_plain(
            plain, rows, boxes, sc.tile_schedule_plain(plain, boxes), scal,
            params)
        torch.cuda.synchronize()
        _assert_same_bits(kern, plain, f"office trace, round {k + 1}")
        kern = rc._sort_state_by_keys(kern, rc.compaction_keys(kern))
        plain = rc._sort_state_by_keys(plain, rc._compaction_keys(plain))
    alive = int((kern[rc._C_DONE] == 0).sum())
    events = int((kern[rc._C_EVW] != 0).sum())
    log(f"office trace, {n} rays x {OFFICE_BOUNCES} rounds: the kernels' "
        f"chain bit-identical to the plain chain after every round; "
        f"{alive} alive at the end, {events} rays with an event")


def office_stage_breakdown(n: int = N_RAYS) -> None:
    """One clustered office trace at ``n`` rays x 32 one-bounce rounds,
    driven as ``raytrace_cuda._run_rounds`` drives it (schedule, K2, then
    the keys and the sort between rounds), each stage between CUDA events:
    ms per stage summed over the rounds, and the schedule's and K2's ms in
    every round."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    params = _office_params()
    _, _, rows, boxes = _office_clustered()
    stages = ("schedule", "K2", "keys", "sort + gather")
    for attempt in ("warm-up", "timed"):
        state, scal = _office_start(n, 17, params)
        marks = []
        torch.cuda.synchronize()
        for k in range(OFFICE_BOUNCES):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            sched = sc.tile_schedule(state, boxes)
            ev[1].record()
            state = sc.trace_round_sched(state, rows, boxes, sched, scal,
                                         params)
            ev[2].record()
            if k + 1 < OFFICE_BOUNCES:
                keys = rc.compaction_keys(state)
                ev[3].record()
                state = rc._sort_state_by_keys(state, keys)
            else:
                ev[3].record()
            ev[4].record()
            marks.append(ev)
        torch.cuda.synchronize()
    per = np.array([[ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
                    for ev in marks])
    whole = marks[0][0].elapsed_time(marks[-1][4])
    log(f"office trace by stage, {n} rays x {OFFICE_BOUNCES} rounds "
        f"(CUDA events): " + ", ".join(
            f"{name} {t:.2f} ms" for name, t in zip(stages, per.sum(0)))
        + f"; first event to last {whole:.2f} ms")
    log("  schedule ms per round: " + " ".join(f"{t:.3f}" for t in per[:, 0]))
    log("  K2 ms per round: " + " ".join(f"{t:.3f}" for t in per[:, 1]))


def phase_cluster_kernels(n_rays: int = N_RAYS) -> dict:
    """K1's multi-chunk branch, the schedule kernel and K2 against their
    plain versions on the office scene, and the clustered IR against K1's;
    returns the JSON entries' numbers of the two new kernels."""
    from audiorenderingv2_tpu_torch import constants, testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    dev = torch.device("cuda")
    params = _office_params()
    emitter = torch.tensor(EMITTER, device=dev)
    receiver = torch.tensor(OFFICE_RECEIVER, device=dev)
    scene, scc, rows, boxes = _office_clustered()

    def start_state(n, seed):
        e0 = params.base_power / (n * constants.SPHERE_VOLUME)
        d = torch.from_numpy(unit_dirs(n, seed)).to(dev)
        return (rc.init_state(d, emitter, e0, -(-n // 128) * 128),
                rc.scalars(emitter, receiver, 0.0, e0, params))

    # K1 over every row of the unsorted scene: its multi-chunk branch.
    flat = tracer.scene_to_arrays(scene, 128, device=dev)
    rows_flat = rc.pack_tris_rows(flat)
    state, scal = start_state(65536, 12)
    assert rc.k1_branch(rows_flat.shape[0]) == "multi_chunk"
    kern = rc.trace_round(state.clone(), rows_flat, scal, params, 8)
    plain = rc.trace_round_plain(state.clone(), rows_flat, scal, params, 8)
    torch.cuda.synchronize()
    _assert_same_bits(kern, plain, "K1 multi-chunk round")
    k1_ms = median_ms(lambda s: rc.trace_round(s, rows_flat, scal, params,
                                               8), 3,
                      setup=lambda: (state.clone(),))
    log(f"K1 multi-chunk, office scene ({scene.n_triangles} triangles, "
        f"{rows_flat.shape[0]} rows = {-(-rows_flat.shape[0] // 512)} "
        f"chunks of 512), 8-bounce round, 65536 rays: bit-identical to the "
        f"plain version in every column; kernel {k1_ms:.3f} ms")

    log(f"office clustered: {rows.shape[0]} rows, {boxes.shape[0]} "
        f"clusters of {rows.shape[0] // boxes.shape[0]}, schedule width "
        f"{sc.schedule_width(boxes.shape[0])}")

    # The schedule kernel on the state after one bounce (some rays done).
    state, scal = start_state(n_rays, 13)
    st1 = sc.trace_round_sched(state.clone(), rows, boxes,
                               sc.tile_schedule(state, boxes), scal, params)
    st1 = rc._sort_state_by_keys(st1, rc._compaction_keys(st1))
    sched_k = sc.tile_schedule(st1, boxes)
    sched_p = sc.tile_schedule_plain(st1, boxes)
    torch.cuda.synchronize()
    assert torch.equal(sched_k, sched_p), "schedule kernel rows differ"
    counts = sched_k[:, 0].double()
    n_done = int((st1[rc._C_DONE] != 0).sum())
    live = counts > 0
    sched_ms = median_ms(lambda: sc.tile_schedule(st1, boxes), 10)
    sched_plain_ms = median_ms(lambda: sc.tile_schedule_plain(st1, boxes),
                               2)
    sort_ms = median_ms(
        lambda: rc._sort_state_by_keys(st1, rc.compaction_keys(st1)), 10)
    log(f"schedule after one bounce and the sort, {st1.shape[1]} rays "
        f"({n_done} done), {sched_k.shape[0]} tiles: kernel rows equal the "
        f"plain rows; candidates per live tile mean "
        f"{float(counts[live].mean()):.2f}, max {int(counts.max())}; "
        f"triangle tests per ray {float(counts[live].mean()) * 32:.1f}; "
        f"kernel {sched_ms:.3f} ms, plain {sched_plain_ms:.3f} ms; keys + "
        f"sort + gather {sort_ms:.3f} ms")

    # K2 and its plain version, two clustered rounds, the chains apart.
    kern, plain = state.clone(), state.clone()
    k2_err = 0.0
    for k in range(2):
        sk = sc.tile_schedule(kern, boxes)
        sp = sc.tile_schedule_plain(plain, boxes)
        kern = sc.trace_round_sched(kern, rows, boxes, sk, scal, params)
        plain = sc.trace_round_sched_plain(plain, rows, boxes, sp, scal,
                                           params)
        torch.cuda.synchronize()
        assert torch.isfinite(kern).all(), f"K2 round {k + 1} not finite"
        assert_columns_close(kern, plain, f"K2 round {k + 1}")
        k2_err = max(k2_err, float((kern - plain).abs().max()))
        n_eq = int((kern == plain).all(dim=0).sum())
        perm_k = torch.sort(rc.compaction_keys(kern), stable=True).indices
        perm_p = torch.sort(rc._compaction_keys(plain), stable=True).indices
        same = torch.equal(perm_k, perm_p)
        # Both chains take the plain chain's order, so that the columns of
        # the next round compare ray for ray.
        kern = kern.index_select(1, perm_p)
        plain = plain.index_select(1, perm_p)
        log(f"K2 round {k + 1}, {kern.shape[1]} rays: every column within "
            f"rtol 1e-5; {n_eq} rays bit-identical; "
            f"{int((kern[rc._C_DONE] == 0).sum())} alive after; the chains' "
            f"sort orders {'agree' if same else 'DIFFER'}")
    k2_ms = median_ms(lambda s: sc.trace_round_sched(s, rows, boxes, sched_k,
                                                     scal, params), 5,
                      setup=lambda: (st1.clone(),))
    k2_plain_ms = median_ms(
        lambda s: sc.trace_round_sched_plain(s, rows, boxes, sched_k, scal,
                                             params), 2,
        setup=lambda: (st1.clone(),))
    log(f"K2 one round on the state after one bounce, {st1.shape[1]} rays: "
        f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms; max abs err "
        f"over the two rounds {k2_err:.3e}")

    # The clustered IR against K1 over every row, 64k shared directions.
    d = torch.from_numpy(unit_dirs(65536, 14)).to(dev)
    args = (EMITTER, OFFICE_RECEIVER, 0.0, params)
    ir_c = tracer.trace_ir(scc, d, *args, tracer.TracerOptions(
        schedule=True)).cpu().numpy()
    ir_r = tracer.trace_ir(flat, d, *args, tracer.TracerOptions(
        round_budgets=tuned.round_budgets_for(OFFICE_BOUNCES))).cpu().numpy()
    testing.assert_ir_close(ir_c, ir_r, exact=False)
    log(f"office IR, 65536 shared directions, {OFFICE_BOUNCES} bounces: the "
        f"clustered route passes assert_ir_close(exact=False) against K1 "
        f"over every row; energy {float(ir_c.sum()):.6e} / "
        f"{float(ir_r.sum()):.6e}; relative L1 "
        f"{float(np.abs(ir_c - ir_r).sum() / np.abs(ir_r).sum()):.3e}")
    cs = rows.shape[0] // boxes.shape[0]
    k2_bound = bound(2 * nbytes(st1) + nbytes(sched_k, rows, scal),
                     k2_work(st1, sched_k, cs) * TRI_TEST_OPS)
    # The schedule reads positions, directions and the done flag (7
    # columns) and the boxes, and writes its rows: its bound is those
    # bytes. Testing every live ray against every box (23 operations
    # each) is no lower bound on its work since the two-level test skips
    # most boxes; that count stands beside the bound as "all_pairs".
    sched_bound = bound(7 * 4 * st1.shape[1] + nbytes(boxes, sched_k), 0)
    all_pairs = bound(0, (st1.shape[1] - n_done) * boxes.shape[0]
                      * SLAB_TEST_OPS)["bound_ms"]
    log(f"bounds: K2 {k2_bound['bound_ms']:.4f} ms by "
        f"{k2_bound['bound_by']}, schedule {sched_bound['bound_ms']:.4f} ms "
        f"by {sched_bound['bound_by']} (all-pairs slab tests "
        f"{all_pairs:.4f} ms)")

    # Both kernels on three states of the render, at the recorder's and a
    # small ray count, 1, 4 and 8 bands, clusters of 32, and at one band
    # every other cluster size phase 24 times (16, 64, 128); then a whole
    # trace, round by round.
    states = cluster_state_check(n_rays, 1, 32, timed=True)
    cluster_state_check(65536, 1, 32)
    for n_bands, c in ((4, 32), (8, 32), (1, 16), (1, 64), (1, 128)):
        for n in (65536, n_rays):
            cluster_state_check(n, n_bands, c)
    office_trace_check()
    office_stage_breakdown(n_rays)
    return {
        "trace_round_sched": {
            "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
            **k2_bound, "library_ms": None,
            "states": {k: v["trace_round_sched"] for k, v in states.items()}},
        "tile_schedule": {
            "max_abs_err": float((sched_k - sched_p).abs().max()),
            "ms": sched_ms, "plain_ms": sched_plain_ms, **sched_bound,
            "all_pairs_bound_ms": all_pairs, "library_ms": None,
            "states": {k: v["tile_schedule"] for k, v in states.items()}},
    }


def phase_office_export() -> dict:
    """The office export on the clustered route, and render times of both
    routes on the same scene; returns the clustered export's launches."""
    from audiorenderingv2_tpu_torch import context, testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.io import wav
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        testing.write_obj(Path(tmp) / "office.obj",
                          *testing.office_mesh(OFFICE_TRIS))
        cfg = _write_inputs(Path(tmp), "office.obj", OFFICE_RECEIVER,
                            OFFICE_BOUNCES)
        _reset_launches()
        ctx = context.load_context(cfg, device="cuda")
        context.export_audio(ctx, Path(tmp) / "office.wav")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = ctx.renderer
        r_clusters = None if r.boxes is None else r.boxes.shape[0]
        launches = _read_launches()
        log(f"office export: {wall:.2f} s wall (obj written and loaded, "
            f"scene sorted and clustered, first call); {r_clusters} "
            f"clusters; launches {launches}")
        assert launches["trace_round"] == 0, launches
        assert launches["tile_schedule"] == OFFICE_BOUNCES, launches
        assert launches["trace_round_sched"] == OFFICE_BOUNCES, launches
        assert launches["compaction_keys"] == OFFICE_BOUNCES - 1, launches
        assert launches["histogram_binned"] > 0, launches
        assert r.boxes is not None
        audio = wav.read_wav(Path(tmp) / "office.wav")
        assert audio.n_channels == 2 and audio.sample_rate == SR
        assert np.isfinite(audio.samples).all()
        peaks = np.abs(audio.samples).max(axis=1)
        assert np.all(np.abs(peaks - 1.0) < 1e-3), peaks
        ir = r.ir
        assert ir.shape == (2, IR_SECONDS * SR) and np.isfinite(ir).all()
        nz = (ir > 0).sum(axis=1)
        assert np.all(nz >= 200), nz
        log(f"office export: WAV stereo {SR} Hz, peaks {peaks.tolist()}; IR "
            f"nonzero bins per ear {nz.tolist()}, energy "
            f"{ir.sum(axis=1).tolist()}")

        clustered_ms = median_ms(r.render, 3)

        # A renderer given explicit options: clusters of 128, K5.
        manual = AudioRenderer(
            ctx.scene, IR_SECONDS, SR, r.n_rays, base_power=3.62,
            max_bounces=OFFICE_BOUNCES, hrtf_absorption_rate=0.9,
            opts=TracerOptions(), device="cuda")
        manual.set_emitter_pos(r.emitter_pos)
        manual.set_receiver(r.receiver_pos, r.receiver_yaw_deg)
        assert manual.boxes is not None and \
            manual.rows.shape[0] // manual.boxes.shape[0] == 128
        _reset_launches()
        ir_m = manual.render()
        torch.cuda.synchronize()
        ml = _read_launches()
        assert ml["trace_traverse"] == OFFICE_BOUNCES, ml
        assert ml["trace_round"] == ml["tile_schedule"] == 0, ml
        assert ml["trace_round_sched"] == 0, ml
        assert ml["histogram_binned"] == 1 and ml["histogram"] == 0, ml
        assert np.isfinite(ir_m).all() and np.all((ir_m > 0).sum(axis=1)
                                                  >= 200)
        # Its energy against the clustered export's (other directions: the
        # two renderers draw from their own generators, so statistically).
        e_m, e_c = ir_m.sum(axis=1), ir.sum(axis=1)
        assert np.all(np.abs(e_m - e_c) < 0.05 * e_c), (e_m, e_c)

        # K1 over every row of the unsorted scene, the baseline.
        flat = tracer.scene_to_arrays(ctx.scene, 128, device="cuda")
        rows_flat = rc.pack_tris_rows(flat)
        d = torch.from_numpy(unit_dirs(r.n_rays, 15)).cuda()
        rows_opts = TracerOptions(
            round_budgets=tuned.round_budgets_for(OFFICE_BOUNCES))
        manual_ms = median_ms(manual.render, 3)
        rows_ms = median_ms(lambda: tracer.trace_ir(
            flat, d, r.emitter_pos, r.receiver_pos, r.receiver_yaw_deg,
            r.params, rows_opts, rows=rows_flat), 1)
        log(f"office render ({r.n_rays} rays, {OFFICE_BOUNCES} bounces, "
            f"{IR_SECONDS} s IR at {SR} Hz): clustered (32 + schedule + K2) "
            f"{clustered_ms:.3f} ms, explicit options ("
            f"{manual.boxes.shape[0]} clusters of 128, K5; launches {ml}) "
            f"{manual_ms:.3f} ms, medians of 3; K1 over all "
            f"{rows_flat.shape[0]} rows (trace_ir on given directions, one "
            f"run after a warm-up) {rows_ms:.3f} ms; rows / clustered "
            f"{rows_ms / clustered_ms:.2f}")
    return launches


def _multi_poses(dev):
    """The 2 x 4 matrix's eight poses in its pair order: emitters [8, 3],
    listeners [8, 3], yaws [8]."""
    return (torch.from_numpy(np.repeat(MULTI_EMITTERS, 4, axis=0)).to(dev),
            torch.from_numpy(np.tile(MULTI_LISTENERS, (2, 1))).to(dev),
            torch.from_numpy(np.tile(MULTI_YAWS, 2)).to(dev))


def _multi_box(n_bands: int):
    """The multi-pose demo's box; with ``n_bands`` > 1 its walls absorb
    per band."""
    from audiorenderingv2_tpu_torch import testing

    v, t = testing.box_room(MULTI_ROOM)
    absorb = MULTI_ABSORPTION if n_bands == 1 else np.tile(
        np.asarray(BANDED_ABSORPTION[:n_bands], np.float32), (t.shape[0], 1))
    return testing.scene_from_arrays(v, t, absorb)


def _multi_params(n_bands: int = 1):
    from audiorenderingv2_tpu_torch.core.params import TraceParams

    return TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                       base_power=3.62, max_bounces=MULTI_BOUNCES,
                       hrtf_absorption_rate=0.9, n_bands=n_bands)


def _pose_directions(seed: int, p: int, n: int, dev) -> torch.Tensor:
    """[p, n, 3]: the directions render_ir_matrix draws for pairs 0..p-1."""
    from audiorenderingv2_tpu_torch.core import sampling

    return torch.stack([
        sampling.sample_directions(n, sampling.pose_generator(seed, i, dev),
                                   dev) for i in range(p)])


def _assert_same_bits(kern: torch.Tensor, plain: torch.Tensor,
                      what: str) -> float:
    """Every column of ``kern`` bit-equal to ``plain``; returns the largest
    absolute difference found (0.0 when it passes)."""
    assert torch.isfinite(kern).all(), f"{what}: not finite"
    err = float((kern - plain).abs().max())
    n_diff = int((kern != plain).any(dim=0).sum())
    assert n_diff == 0, (f"{what}: {n_diff} of {kern.shape[1]} rays differ "
                         f"from the plain version, max abs err {err:.3e}")
    return err


def posed_rows_check(n_bands: int) -> dict:
    """The posed K1 at the 2 x 4 matrix's own shape (8 poses x 1,000,064
    rays on the demo's box) through the matrix's two rounds, the kernel's
    chain and the plain chain run apart with the per-pose partition between
    the rounds: bit for bit in every column after each round, and every
    pose's segment against a single-pose launch. Returns the JSON entry's
    numbers: those of the first round, the second round's under
    ``round2``."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    p, n_pad = 8, -(-N_RAYS // 128) * 128
    params = _multi_params(n_bands)
    rows = rc.pack_tris_rows(
        tracer.scene_to_arrays(_multi_box(n_bands), 128, device=dev), n_bands)
    n_valid = int((rows[:, rc._R_VAL] > 0).sum())
    em, rcv, yaw = _multi_poses(dev)
    e0 = params.base_power / (N_RAYS * constants.SPHERE_VOLUME)
    kern = rc.init_state(_pose_directions(0, p, N_RAYS, dev), em, e0, n_pad,
                         n_bands)
    scal = rc.scalars(em, rcv, yaw, e0, params)
    plain = kern.clone()
    err, rounds = 0.0, []
    for k, budget in enumerate(MULTI_BUDGETS):
        if k:
            kern = rc._partition_alive_first(kern, p)
            plain = rc._partition_alive_first(plain, p)
        before = kern.clone()
        kern = rc.trace_round(kern, rows, scal, params, budget, n_pad)
        plain = rc.trace_round_plain(plain, rows, scal, params, budget, n_pad)
        torch.cuda.synchronize()
        what = (f"posed K1, {n_bands} band(s), round {k + 1} (budget "
                f"{budget})")
        err = max(err, _assert_same_bits(kern, plain, what))
        for i in range(p):
            seg = slice(i * n_pad, (i + 1) * n_pad)
            one = rc.trace_round(before[:, seg].contiguous(), rows,
                                 scal[i].contiguous(), params, budget)
            assert torch.equal(one, kern[:, seg]), \
                f"{what}, pose {i} differs from a single-pose launch"
        ms = median_ms(lambda s: rc.trace_round(s, rows, scal, params,
                                                budget, n_pad), 3,
                       setup=lambda: (before.clone(),))
        plain_ms = median_ms(
            lambda s: rc.trace_round_plain(s, rows, scal, params, budget,
                                           n_pad), 1,
            setup=lambda: (before.clone(),))
        tests = round_tests(before, kern) * n_valid
        rounds.append({"ms": ms, "plain_ms": plain_ms,
                       **bound(2 * nbytes(before) + nbytes(rows, scal),
                               tests * TRI_TEST_OPS)})
        log(f"K1-pose, rows, {n_bands} band(s), the demo's box, {p} poses x "
            f"{n_pad} rays, round {k + 1} ({budget} bounces), "
            f"{kern.shape[0]} columns: bit-identical to the plain version "
            f"in every column, and every pose's segment to a single-pose "
            f"launch; {int((kern[rc._C_DONE] == 0).sum())} alive after; "
            f"{tests:.4g} tests of {n_valid} valid rows; kernel {ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms, bound "
            f"{rounds[-1]['bound_ms']:.4f} ms by {rounds[-1]['bound_by']}")
    assert int((kern[rc._C_EVW] != 0).sum()) > 1000
    return {"max_abs_err": err, **rounds[0], "library_ms": None,
            "round2": rounds[1]}


def posed_sched_check(n_bands: int) -> dict:
    """The posed K2 at the office matrix's own shape (4 poses x 250,112
    rays, 250,000 real), one round after a bounce and the per-pose sort:
    bit for bit against the plain version in every column and against
    single-pose launches. Returns the JSON entry's numbers."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    dev = torch.device("cuda")
    p, n = 4, OFFICE_MATRIX_RAYS
    n_pad = -(-n // 128) * 128
    params = _office_params(n_bands)
    _, scc, rows, boxes = _office_clustered()
    if n_bands > 1:  # the office's one absorption value in every band
        rows, boxes = rc.pack_tris_clusters(scc, n_bands)
    em = torch.zeros((p, 3), device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    state = rc.init_state(_pose_directions(1, p, n, dev), em, e0, n_pad,
                          n_bands)
    scal = rc.scalars(em, torch.from_numpy(OFFICE_LISTENERS).to(dev),
                      torch.from_numpy(MULTI_YAWS).to(dev), e0, params)
    st1 = sc.trace_round_sched(state.clone(), rows, boxes,
                               sc.tile_schedule(state, boxes), scal, params,
                               n_pad)
    st1 = rc._sort_state_by_keys(st1, rc._compaction_keys(st1, n_poses=p), p)
    sched = sc.tile_schedule(st1, boxes)
    kv, pv = (torch.zeros(sched.shape[0], dtype=torch.int32, device=dev)
              for _ in range(2))
    kern = sc.trace_round_sched(st1.clone(), rows, boxes, sched, scal,
                                params, n_pad, kv)
    plain = sc.trace_round_sched_plain(st1.clone(), rows, boxes, sched, scal,
                                       params, n_pad, pv)
    torch.cuda.synchronize()
    err = _assert_same_bits(kern, plain, f"posed K2, {n_bands} band(s)")
    assert torch.equal(kv, pv), f"posed K2, {n_bands} band(s): warp visits"
    pairs, warp_tests = k2_warp_work(st1, sched, rows, boxes, scal, params,
                                     n_pad)
    tiles = n_pad // 128
    for i in range(p):
        seg = slice(i * n_pad, (i + 1) * n_pad)
        one = sc.trace_round_sched(
            st1[:, seg].contiguous(), rows, boxes,
            sched[i * tiles:(i + 1) * tiles].contiguous(),
            scal[i].contiguous(), params)
        assert torch.equal(one, kern[:, seg]), \
            f"posed K2, pose {i} differs from a single-pose launch"
    counts = sched[:, 0].double()
    sort_ms = median_ms(lambda: rc._sort_state_by_keys(
        st1, rc.compaction_keys(st1, n_poses=p), p), 5)
    ms = median_ms(lambda s: sc.trace_round_sched(s, rows, boxes, sched,
                                                  scal, params, n_pad), 5,
                   setup=lambda: (st1.clone(),))
    plain_ms = median_ms(
        lambda s: sc.trace_round_sched_plain(s, rows, boxes, sched, scal,
                                             params, n_pad), 2,
        setup=lambda: (st1.clone(),))
    cs = rows.shape[0] // boxes.shape[0]
    union_tests = k2_work(st1, sched, cs)
    k2_bound = bound(2 * nbytes(st1) + nbytes(sched, rows, scal),
                     union_tests * TRI_TEST_OPS)
    warp_bound = bound(2 * nbytes(st1) + nbytes(sched, rows, scal),
                       warp_tests * TRI_TEST_OPS)["bound_ms"]
    log(f"K1-pose, schedule, {n_bands} band(s), office, {p} poses x {n_pad} "
        f"rays ({n} real), one round after a bounce and the per-pose sort, "
        f"{kern.shape[0]} columns: K2 bit-identical to the plain version in "
        f"every column, its warp visits equal to the plain ones, and every "
        f"pose's segment to a single-pose launch; "
        f"candidates per live tile mean "
        f"{float(counts[counts > 0].mean()):.2f}; warps test {pairs} "
        f"(warp, candidate) pairs of the tile union's "
        f"{4 * int(counts.sum())}; ray-triangle tests {warp_tests} "
        f"warp-culled, {union_tests} tile union; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {k2_bound['bound_ms']:.4f} ms by "
        f"{k2_bound['bound_by']} (on the warp-culled tests "
        f"{warp_bound:.4f}); per-pose keys + sort + gather "
        f"{sort_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **k2_bound,
            "warp_bound_ms": warp_bound, "tests": union_tests,
            "warp_tests": warp_tests, "warp_pairs": pairs,
            "library_ms": None}


def phase_pose_kernels() -> dict:
    """K1 and K2 with one scalar row per pose, at the shapes the matrices
    of phase 10 and 12 give them, against their plain versions and against
    single-pose launches; returns the JSON entries' numbers."""
    out = {"trace_round_posed": posed_rows_check(1),
           "trace_round_posed_4band": posed_rows_check(4),
           "trace_round_sched_posed": posed_sched_check(1)}
    posed_sched_check(4)
    posed_sched_check(8)
    return out


def phase_init() -> dict:
    """K4 against its plain version on the card."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    n = N_RAYS
    n_pad = -(-n // 128) * 128
    scal = torch.zeros(16, device=dev)
    scal[rc._S_EMX:rc._S_EMZ + 1] = torch.tensor([0.5, -1.0, 2.0])
    scal[rc._S_E0] = 3.62 / (n * 4.18879020478)
    scal[rc._S_PAD14] = 4242421.0
    result = {}
    for n_bands in (1, 4):
        kern = rc.init_state_native(scal, n_pad, n, n_bands)
        plain = rc.init_state_native_plain(scal, n_pad, n, n_bands)
        torch.cuda.synchronize()
        assert kern.shape == plain.shape == (rc.state_ncols(n_bands), n_pad)
        inexact = (rc._C_VX, rc._C_VY)
        for c in range(kern.shape[0]):
            if c not in inexact:
                assert torch.equal(kern[c], plain[c]), \
                    f"K4, {n_bands} band(s), column {c} differs"
        # VZ = 2 u2 - 1 exactly, so its equality is the equality of the
        # second word's 24 bits; VX and VY carry the first word through
        # sinf and cosf.
        err = float((kern - plain).abs().max())
        assert err <= 2e-7, f"K4 directions differ by {err:.3e}"
        same = [int((kern[c] == plain[c]).sum()) for c in inexact]
        norm = kern[rc._C_VX:rc._C_VZ + 1].norm(dim=0)
        assert float((norm - 1).abs().max()) < 1e-6
        call = lambda: rc.init_state_native(scal, n_pad, n, n_bands)  # noqa
        ms, dev_ms = median_ms(call, 20), device_ms(call)
        plain_ms = median_ms(
            lambda: rc.init_state_native_plain(scal, n_pad, n, n_bands), 5)
        k4_bound = bound(nbytes(scal, kern), n_pad * INIT_RAY_OPS)
        log(f"K4 init, {n_pad} rays ({n} real), {n_bands} band(s), "
            f"{kern.shape[0]} columns: every exactly rounded column equals "
            f"the plain version's (VZ: the Philox words agree); VX, VY max "
            f"abs err {err:.3e} (bar 2e-7), {same[0]} and {same[1]} of "
            f"{n_pad} bit-identical; kernel {ms:.4f} ms a call, "
            f"{dev_ms:.4f} ms device (CUDA graph of 20), plain "
            f"{plain_ms:.3f} ms, bound {k4_bound['bound_ms']:.4f} ms by "
            f"{k4_bound['bound_by']}")
        result[n_bands] = {"max_abs_err": err, "ms": ms,
                           "device_ms": dev_ms, "plain_ms": plain_ms,
                           **k4_bound, "library_ms": None}
    return {**result[1], "bands4": result[4]}


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` (which ends on the host) over
    ``reps`` runs after one warm-up."""
    times = []
    for r in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if r:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def binned_deposits64(ev_bin_f, ev_w, ev_ear, params):
    """Every deposit of the hard-binning stage, on the card: (flat row
    int64 [D] of the [P * 2 * ir_length, n_bands] histogram, weight float64
    [D, n_bands]). Same ear at round(bin_f) (half to even), and unless mono
    (1 - hrtf) times the weight at the other ear, ``delay`` bins later or
    at the same bin past the IR's end; inactive and out-of-range events
    deposit nothing."""
    nb, delay = params.ir_length, params.cross_ear_delay
    p = ev_bin_f.shape[0]
    b = torch.round(ev_bin_f)
    keep = (ev_w != 0).any(dim=-1) & (b >= 0) & (b < nb)
    bi = b.long()[keep]
    ear = (ev_ear != 0).long()[keep]
    pose = torch.arange(p, device=ev_bin_f.device)[:, None].expand(
        ev_bin_f.shape)[keep]
    w = ev_w[keep].double()
    rows, weights = [(pose * 2 + ear) * nb + bi], [w]
    if not params.is_mono:
        scale = float(np.float32(1.0 - params.hrtf_absorption_rate))
        rows.append((pose * 2 + 1 - ear) * nb
                    + torch.where(bi + delay < nb, bi + delay, bi))
        weights.append(scale * ev_w[keep].float().double())
    return torch.cat(rows), torch.cat(weights)


def subnormal_counts(rows: torch.Tensor, weights: torch.Tensor,
                     shape) -> torch.Tensor:
    """Per bin of a histogram of ``shape`` [n_rows, n_bands], the count of
    its deposits (``rows`` [D], ``weights`` [D, n_bands]) whose weight is
    a float32 subnormal: the card's f32 atomics (RED.F32.FTZ) flush those
    to zero, so each may be missing from the bin."""
    tiny = float(np.finfo(np.float32).tiny)
    sub = ((weights != 0) & (weights.abs() < tiny)).double()
    return torch.zeros(shape, dtype=torch.float64,
                       device=weights.device).index_add_(0, rows, sub)


def _assert_deposit_bar(got: torch.Tensor, ref: torch.Tensor, n_sub,
                        what: str) -> float:
    """Each bin of ``got`` within 1e-4 of the float64 sum ``ref`` of the
    same deposits, relative, plus float32's smallest normal number for
    each subnormal deposit of the bin (``n_sub``: the late bins of a band
    absorbing 60% a bounce sum weights of 1e-39 after ~100 bounces, which
    the f32 atomics flush); a bin no deposit maps to (ref 0) exactly 0.
    The early bins of an IR sum thousands of events, in an order that
    differs from run to run (atomics). Returns the worst relative error
    over the bins without a subnormal deposit."""
    tiny = float(np.finfo(np.float32).tiny)
    diff = (got.double() - ref).abs()
    bad = int((diff > 1e-4 * ref.abs() + n_sub * tiny).sum())
    assert bad == 0, f"{what}: {bad} bins off the float64 sum"
    assert not got[ref == 0].any(), f"{what}: a bin no deposit maps to"
    normal = (ref != 0) & (n_sub == 0)
    return float((diff[normal] / ref[normal].abs()).max())


def flat_histogram_check(flat, weights, n_bins, what: str) -> dict:
    """K3's flat-bin entry on a render's own flat bins against its plain
    version and a float64 sum (bar 1e-4 a bin); times beside index_add_
    alone, and the events in the 32 busiest bins."""
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc

    kern = hc.histogram_sum_banded(flat, weights, n_bins)
    plain = hc.histogram_plain(flat, weights, n_bins)
    keep = (flat >= 0) & (flat < n_bins)
    rows, w64 = flat[keep].long(), weights[keep].double()
    ref = torch.zeros(kern.shape, dtype=torch.float64, device=kern.device)
    ref.index_add_(0, rows, w64)
    n_sub = subnormal_counts(rows, w64, kern.shape)
    rel_k = _assert_deposit_bar(kern, ref, n_sub, f"K3, {what}")
    rel_p = _assert_deposit_bar(plain, ref, n_sub, f"plain K3, {what}")
    busiest = int(torch.bincount(flat[keep], minlength=n_bins)
                  .topk(32).values.sum())
    call = lambda: hc.histogram_sum_banded(flat, weights, n_bins)  # noqa
    ms, dev_ms = median_ms(call, 20), device_ms(call)
    plain_ms = median_ms(lambda: hc.histogram_plain(flat, weights, n_bins),
                         10)
    library_ms = median_ms(index_add_call(flat, weights, n_bins), 20)
    n_adds = int((keep & (weights != 0).any(dim=1)).sum()) * weights.shape[1]
    k3_bound = bound(nbytes(flat, weights, kern), n_adds)
    err = float((kern - plain).abs().max())
    log(f"K3 flat bins, {what}: {flat.shape[0]} events x "
        f"{weights.shape[1]} band(s) -> {n_bins} bins, {int(keep.sum())} "
        f"in range, {busiest} in the 32 busiest bins: kernel within "
        f"{rel_k:.3e} of the float64 sum per bin, plain {rel_p:.3e} (bar "
        f"1e-4); kernel {ms:.4f} ms a call, {dev_ms:.4f} ms device, plain "
        f"{plain_ms:.4f} ms, index_add_ alone {library_ms:.4f} ms, bound "
        f"{k3_bound['bound_ms']:.4f} ms by {k3_bound['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **k3_bound, "library_ms": library_ms,
            "busiest_32": busiest}


def binned_check(ev_bin_f, ev_w, ev_ear, params, what: str,
                 flat_too: bool = True) -> dict:
    """The hard-binning stage on a render's own events (``ev_*`` [P, E]):
    the fused entry (``histogram_binned``) and the PyTorch stage with
    index_add_ (``histogram_binned_plain``), each against a float64 sum of
    the same deposits (bar 1e-4 a bin, no stray bin); the IRs the tracer
    returns from them; then, with ``flat_too``, K3's flat-bin entry on the
    stage's same-ear flat bins (``flat_histogram_check``). Returns the
    fused entry's numbers (K3's under "flat"). Times: the fused entry a
    call and on the device, the PyTorch stage (its plain version), and
    index_add_ alone over the same deposits (its library yardstick)."""
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc

    stage = (params.ir_length, params.is_mono, params.cross_ear_delay,
             params.hrtf_absorption_rate)
    n_bands = ev_w.shape[-1]
    kern = hc.histogram_binned(ev_bin_f, ev_w, ev_ear, *stage)
    plain = hc.histogram_binned_plain(ev_bin_f, ev_w, ev_ear, *stage)
    rows, w64 = binned_deposits64(ev_bin_f, ev_w, ev_ear, params)
    n_rows = kern.shape[0] * 2 * params.ir_length
    ref = torch.zeros((n_rows, n_bands), dtype=torch.float64,
                      device=kern.device).index_add_(0, rows, w64)
    n_sub = subnormal_counts(rows, w64, ref.shape)
    rel_k = _assert_deposit_bar(kern.reshape(n_rows, n_bands), ref, n_sub,
                                f"fused stage, {what}")
    rel_p = _assert_deposit_bar(plain.reshape(n_rows, n_bands), ref, n_sub,
                                f"PyTorch stage, {what}")
    irs = tracer._histogram_from_events_posed(ev_bin_f, ev_w, ev_ear, params)
    want = plain if n_bands > 1 else plain[..., 0]
    if n_bands > 1:
        want = want.permute(0, 1, 3, 2)
    assert irs.shape == want.shape, (what, irs.shape, want.shape)
    ir_err = float((irs - want).abs().max() / want.abs().max())
    assert ir_err < 1e-4, (what, ir_err)
    call = lambda: hc.histogram_binned(ev_bin_f, ev_w, ev_ear, *stage)  # noqa
    ms, dev_ms = median_ms(call, 20), device_ms(call)
    plain_ms = median_ms(
        lambda: hc.histogram_binned_plain(ev_bin_f, ev_w, ev_ear, *stage), 10)
    library_ms = median_ms(
        index_add_call(rows, w64.float(), n_rows), 20)
    # Bytes: the events read once, the IRs written once; one add a deposit
    # and band.
    k_bound = bound(nbytes(ev_bin_f, ev_w, ev_ear, kern),
                    rows.shape[0] * n_bands)
    err = float((kern - plain).abs().max())
    log(f"hard binning, {what}: {ev_bin_f.numel()} events x {n_bands} "
        f"band(s), {rows.shape[0]} deposits ({int(n_sub.sum())} subnormal, "
        f"in {int((n_sub > 0).sum())} bins) -> {tuple(kern.shape)}: fused "
        f"entry within {rel_k:.3e} of the float64 sum per bin, PyTorch stage "
        f"{rel_p:.3e} (bar 1e-4), no stray bin; the tracer's IRs within "
        f"{ir_err:.3e} of the stage's peak; fused {ms:.4f} ms a call, "
        f"{dev_ms:.4f} ms device (CUDA graph of 20), PyTorch stage "
        f"{plain_ms:.4f} ms, index_add_ of the deposits alone "
        f"{library_ms:.4f} ms, bound {k_bound['bound_ms']:.4f} ms by "
        f"{k_bound['bound_by']}")
    row = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, **k_bound, "library_ms": library_ms}
    if flat_too:
        nb = params.ir_length
        b = torch.round(ev_bin_f).to(torch.int32)
        pose = torch.arange(ev_bin_f.shape[0], dtype=torch.int32,
                            device=b.device)[:, None]
        active = (ev_w != 0).any(dim=-1)
        n_bins = ev_bin_f.shape[0] * 2 * nb
        flat = torch.where(active & (b >= 0) & (b < nb),
                           (pose * 2 + ev_ear.to(torch.int32)) * nb + b,
                           n_bins)
        row["flat"] = flat_histogram_check(
            flat.reshape(-1), ev_w.reshape(-1, n_bands).contiguous(), n_bins,
            what)
    return row


def box_events(n_bands: int):
    """The box render's own events at 1,000,064 rays x 100 bounces (its
    round budgets; walls absorbing per band with ``n_bands`` > 1), as
    ``trace_events`` returns them, with a pose axis: (ev_bin_f [1, E],
    ev_w [1, E, n_bands], ev_ear int32 [1, E]), and its params."""
    from audiorenderingv2_tpu_torch import testing, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    v, t = testing.box_room(ROOM)
    absorb = ABSORPTION if n_bands == 1 else np.tile(
        np.asarray((0.1, 0.25, 0.4, 0.6, 0.2, 0.3, 0.5, 0.7)[:n_bands],
                   np.float32), (t.shape[0], 1))
    sc = tracer.scene_to_arrays(testing.scene_from_arrays(v, t, absorb), 128,
                                device=dev)
    params = _box_params(n_bands)
    rows, _ = rc.pack_scene(sc, n_bands)
    ev = rc.trace_events(
        rows, torch.from_numpy(unit_dirs(N_RAYS, 61)).to(dev),
        torch.tensor(EMITTER, device=dev), torch.tensor(RECEIVER, device=dev),
        0.0, params, round_budgets=tuned.round_budgets_for(MAX_BOUNCES))
    return tuple(x[None] for x in ev), params


def phase_box_events() -> tuple[dict, dict]:
    """K3 and the hard-binning stage on the box render's own events (1, 4
    and 8 bands; stereo and mono). Returns (K3's numbers on those events, the fused
    entry's numbers: 1 band stereo, the other cases under their names)."""
    result, flat = {}, {}
    for n_bands in (1, 4, 8):
        ev, params = box_events(n_bands)
        for mono in (False, True):
            p = dataclasses.replace(params, is_mono=mono)
            name = f"{n_bands} band(s), {'mono' if mono else 'stereo'}"
            row = binned_check(*ev, p, f"box render's events, {name}",
                               flat_too=not mono)
            if not mono:
                flat[n_bands] = row.pop("flat")
            result[name] = row
    k3 = {**flat[1], "bands4": flat[4], "bands8": flat[8]}
    first = result.pop("1 band(s), stereo")
    return k3, {**first, "cases": result}


def _dry_signals():
    """Demo 6's two 2 s dry signals: a click train and a tone burst."""
    from audiorenderingv2_tpu_torch.examples import demo_6_multipose

    return demo_6_multipose.dry_signals()


def box_matrix(n_bands: int):
    """The demo's 2 x 4 x 1M-ray matrix and its mix on the card, the launch
    counts read around them; one pair against a single render_ir of that
    pair; K3 at the matrix's events against its plain version. Returns
    (scene arrays, rows, params, opts, matrix, launches, K3's numbers)."""
    from audiorenderingv2_tpu_torch import multi, testing
    from audiorenderingv2_tpu_torch.core import sampling, tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    sc = tracer.scene_to_arrays(_multi_box(n_bands), 128, device=dev)
    rows, _ = rc.pack_scene(sc, n_bands)
    params = _multi_params(n_bands)
    opts = tracer.TracerOptions(round_budgets=MULTI_BUDGETS)
    signals = _dry_signals()
    band_shape = () if n_bands == 1 else (n_bands,)

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    irs = multi.render_ir_matrix(sc, 0, MULTI_EMITTERS, MULTI_LISTENERS,
                                 MULTI_YAWS, N_RAYS, params, opts,
                                 pair_batch=8, rows=rows)
    out = multi.mix_sources(irs, signals, SR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"multi-pose, {n_bands} band(s): 2 sources x 4 listeners x {N_RAYS} "
        f"rays, {MULTI_BOUNCES} bounces in rounds {MULTI_BUDGETS}, "
        f"pair_batch=8, then the mix: {wall:.3f} s wall (first call); "
        f"launches {launches}; peak device memory {peak:.0f} MiB")
    assert launches["trace_round_posed"] == len(MULTI_BUDGETS), launches
    assert launches["trace_round"] == 0, launches
    assert launches["histogram_binned"] == 1, launches
    assert launches["histogram"] == 0, launches
    assert irs.shape == (2, 4, 2) + band_shape + (IR_SECONDS * SR,)
    assert np.isfinite(irs).all()
    nz = (irs > 0).sum(axis=-1)
    assert nz.min() >= 200, nz
    assert out.shape == (4, 2, 2 * SR) and np.isfinite(out).all()
    assert np.abs(out).max(axis=(1, 2)).min() > 0

    # One pair against a single render_ir of that pair (pair 1 * 4 + 2).
    single = tracer.render_ir(
        sc, sampling.pose_generator(0, 6, dev), N_RAYS, MULTI_EMITTERS[1],
        MULTI_LISTENERS[2], float(MULTI_YAWS[2]), params, opts,
        rows=rows).cpu().numpy()
    pair = irs[1, 2]
    testing.assert_ir_close(pair.reshape(-1, pair.shape[-1]),
                            single.reshape(-1, pair.shape[-1]), exact=False)
    log(f"multi-pose, {n_bands} band(s): pair (1, 2) of the matrix passes "
        f"assert_ir_close(exact=False) against a single render_ir of that "
        f"pair; max abs diff {np.abs(pair - single).max():.3e}, energy "
        f"{pair.sum():.6e} / {single.sum():.6e}; non-zero bins per (pair, "
        f"ear, band) min {nz.min()}, max {nz.max()}")

    em, rcv, yaw = _multi_poses(dev)
    ev = rc.trace_events_pose_batch(
        rows, _pose_directions(0, 8, N_RAYS, dev), em, rcv, yaw, params,
        round_budgets=MULTI_BUDGETS)
    k3 = binned_check(*ev, params, f"2 x 4 matrix, {n_bands} band(s)")
    return sc, rows, params, opts, irs, launches, k3


def phase_multipose() -> tuple[dict, dict]:
    """The multi-pose path at full width, then its large-scene form;
    returns the launches of the posed kernels on it and K3's numbers at
    the matrix's events."""
    from audiorenderingv2_tpu_torch import multi, testing
    from audiorenderingv2_tpu_torch.core import sampling, tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    sc, rows, params, opts, irs, launches, k3 = box_matrix(1)
    signals = _dry_signals()
    args = (sc, 0, MULTI_EMITTERS, MULTI_LISTENERS, MULTI_YAWS, N_RAYS,
            params, opts)
    fused_ms = wall_ms(lambda: multi.render_ir_matrix(
        *args, pair_batch=8, rows=rows), 3)
    loop_ms = wall_ms(lambda: multi.render_ir_matrix(
        *args, pair_batch=1, rows=rows), 3)
    mix_ms = wall_ms(lambda: multi.mix_sources(irs, signals, SR), 5)
    log(f"multi-pose timings, 8 pairs x {N_RAYS} rays, host clock, the "
        f"matrix's copy to the host included: fused (pair_batch=8) "
        f"{fused_ms:.3f} ms, pair_batch=1 {loop_ms:.3f} ms ("
        f"{loop_ms / fused_ms:.2f}x), mix_sources of two 2 s signals at 4 "
        f"listeners {mix_ms:.3f} ms")

    # Where the fused render's time goes: its stages driven by hand, each
    # between two CUDA events.
    def staged(fn):
        ms = median_ms(fn, 1)
        return fn(), ms

    em, rcv, yaw = _multi_poses(dev)
    n_pad = -(-N_RAYS // 128) * 128
    e0 = params.base_power / (N_RAYS * 4.18879020478)
    d, t_sample = staged(lambda: _pose_directions(0, 8, N_RAYS, dev))
    (state, scal), t_init = staged(lambda: (
        rc.init_state(d, em, e0, n_pad),
        rc.scalars(em, rcv, yaw, e0, params)))
    st1, t_r1 = staged(lambda: rc.trace_round(
        state.clone(), rows, scal, params, MULTI_BUDGETS[0], n_pad))
    alive1 = int((st1[rc._C_DONE] == 0).sum())
    st1p, t_part = staged(lambda: rc._partition_alive_first(st1, 8))
    st2, t_r2 = staged(lambda: rc.trace_round(
        st1p.clone(), rows, scal, params, MULTI_BUDGETS[1], n_pad))
    alive2 = int((st2[rc._C_DONE] == 0).sum())
    ev = st2.view(-1, 8, n_pad)
    hist, t_hist = staged(lambda: tracer._histogram_from_events_posed(
        ev[rc._C_EVB].contiguous(),
        ev[rc._C_EVW][..., None].contiguous(),
        ev[rc._C_EVE].to(torch.int32), params))
    _, t_copy = staged(lambda: hist.cpu().numpy())
    log(f"multi-pose stages (8 x {n_pad} rays; each median of 1 after a "
        f"warm-up; rounds include a clone of the state): sampling "
        f"{t_sample:.3f} ms, init + scalars {t_init:.3f} ms, K1 round 1 "
        f"{t_r1:.3f} ms ({alive1} alive after), partition {t_part:.3f} ms, "
        f"K1 round 2 {t_r2:.3f} ms ({alive2} alive after), posed histogram "
        f"{t_hist:.3f} ms, copy to the host {t_copy:.3f} ms")
    del d, state, st1, st1p, st2, ev, hist

    # The large-scene form: the office, 1 source x 4 listeners, fused.
    _, scc, orows, oboxes = _office_clustered()
    oparams = _office_params()
    oopts = tracer.TracerOptions(schedule=True)
    oargs = (scc, 1, np.array([EMITTER], np.float32), OFFICE_LISTENERS,
             MULTI_YAWS, OFFICE_MATRIX_RAYS, oparams, oopts)
    _reset_launches()
    oirs = multi.render_ir_matrix(*oargs, pair_batch=4, rows=orows,
                                  boxes=oboxes)
    torch.cuda.synchronize()
    olaunches = _read_launches()
    log(f"multi-pose, office: 1 source x 4 listeners x {OFFICE_MATRIX_RAYS} "
        f"rays, {OFFICE_BOUNCES} bounces, fused; launches {olaunches}")
    assert olaunches["trace_round_sched_posed"] == OFFICE_BOUNCES, olaunches
    assert olaunches["tile_schedule"] == OFFICE_BOUNCES, olaunches
    assert olaunches["trace_round_sched"] == 0, olaunches
    assert olaunches["trace_round"] == olaunches["trace_round_posed"] == 0
    assert olaunches["histogram_binned"] == 1, olaunches
    assert oirs.shape == (1, 4, 2, IR_SECONDS * SR)
    assert np.isfinite(oirs).all() and (oirs > 0).sum(axis=-1).min() >= 200
    osingle = tracer.render_ir(
        scc, sampling.pose_generator(1, 3, dev), OFFICE_MATRIX_RAYS, EMITTER,
        OFFICE_LISTENERS[3], float(MULTI_YAWS[3]), oparams, oopts,
        rows=orows, boxes=oboxes).cpu().numpy()
    testing.assert_ir_close(oirs[0, 3], osingle, exact=False)
    ofused_ms = wall_ms(lambda: multi.render_ir_matrix(
        *oargs, pair_batch=4, rows=orows, boxes=oboxes), 2)
    oloop_ms = wall_ms(lambda: multi.render_ir_matrix(
        *oargs, pair_batch=1, rows=orows, boxes=oboxes), 2)
    log(f"multi-pose, office: pair (0, 3) passes assert_ir_close("
        f"exact=False) against a single render_ir; max abs diff "
        f"{np.abs(oirs[0, 3] - osingle).max():.3e}; fused {ofused_ms:.3f} "
        f"ms, pair_batch=1 {oloop_ms:.3f} ms ({oloop_ms / ofused_ms:.2f}x)")
    # The same matrix with default options: a clustered scene without the
    # schedule leaves the fused batch, one render_ir (K5) per pair.
    dargs = oargs[:-1] + (tracer.TracerOptions(),)
    _reset_launches()
    dirs_ = multi.render_ir_matrix(*dargs, pair_batch=4, rows=orows,
                                   boxes=oboxes)
    torch.cuda.synchronize()
    dlaunches = _read_launches()
    assert dlaunches["trace_traverse"] == 4 * OFFICE_BOUNCES, dlaunches
    assert dlaunches["trace_round_sched_posed"] == 0, dlaunches
    assert dlaunches["tile_schedule"] == dlaunches["trace_round"] == 0
    assert dlaunches["histogram_binned"] == 4, dlaunches
    testing.assert_ir_close(dirs_[0].reshape(-1, dirs_.shape[-1]),
                            oirs[0].reshape(-1, oirs.shape[-1]), exact=False)
    ddefault_ms = wall_ms(lambda: multi.render_ir_matrix(
        *dargs, pair_batch=4, rows=orows, boxes=oboxes), 2)
    log(f"multi-pose, office, default options (no schedule): launches "
        f"{dlaunches}; passes assert_ir_close(exact=False) against the "
        f"fused matrix, max abs diff {np.abs(dirs_ - oirs).max():.3e}; "
        f"{ddefault_ms:.3f} ms against {ofused_ms:.3f} ms fused with "
        f"schedule=True")
    oev = rc.trace_events_pose_batch(
        orows, _pose_directions(1, 4, OFFICE_MATRIX_RAYS, dev),
        torch.zeros((4, 3), device=dev),
        torch.from_numpy(OFFICE_LISTENERS).to(dev),
        torch.from_numpy(MULTI_YAWS).to(dev), oparams, boxes=oboxes,
        route=rc.Route("sched", "sort"))
    binned_check(*oev, oparams, "office 1 x 4 matrix")
    return ({"trace_round_posed": launches["trace_round_posed"],
             "histogram_posed": launches["histogram_binned"],
             "trace_round_sched_posed": olaunches["trace_round_sched_posed"]},
            k3)


def phase_banded() -> dict:
    """A 4-band scene on the card: the demo's matrix and its mix through
    the filterbank, then a banded export through AudioRenderer. Returns the
    launches of the posed kernels on the banded matrix and of the band-split
    kernel in the export."""
    from audiorenderingv2_tpu_torch import context, multi, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.io import wav
    from audiorenderingv2_tpu_torch.ops import filterbank
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    n_bands = len(BANDED_ABSORPTION)
    sc, rows, params, opts, irs, launches, _ = box_matrix(n_bands)
    signals = _dry_signals()
    # Walls absorb more in every higher band, so the bands' energy falls.
    band_energy = irs.sum(axis=(0, 1, 2, 4))
    assert np.all(np.diff(band_energy) < 0), band_energy
    out = multi.mix_sources(irs, signals, SR)
    out_cpu = multi.mix_sources(irs, signals, SR, device="cpu")
    mix_err = float(np.abs(out - out_cpu).max() / np.abs(out_cpu).max())
    assert mix_err < 1e-4, mix_err
    fused_ms = wall_ms(lambda: multi.render_ir_matrix(
        sc, 0, MULTI_EMITTERS, MULTI_LISTENERS, MULTI_YAWS, N_RAYS, params,
        opts, pair_batch=8, rows=rows), 3)
    mix_ms = wall_ms(lambda: multi.mix_sources(irs, signals, SR), 5)
    log(f"banded multi-pose ({n_bands} bands, absorption "
        f"{BANDED_ABSORPTION}): energy per band {band_energy.tolist()}; the "
        f"mix on the card is within {mix_err:.3e} of its peak of the mix "
        f"on the CPU (bar 1e-4); host clock: fused matrix {fused_ms:.3f} "
        f"ms, mix_sources through the filterbank {mix_ms:.3f} ms")

    with tempfile.TemporaryDirectory() as tmp:
        testing.write_box_obj(Path(tmp) / "room.obj", ROOM, material="walls")
        cfg = _write_inputs(Path(tmp), absorption=list(BANDED_ABSORPTION))
        _reset_launches()
        ctx = context.load_context(cfg, device="cuda")
        context.export_audio(ctx, Path(tmp) / "banded.wav")
        torch.cuda.synchronize()
        xl = _read_launches()
        r = ctx.renderer
        log(f"banded export: launches {xl}")
        assert r.params.n_bands == n_bands and r.boxes is None
        assert xl["trace_round"] == len(r.opts.round_budgets), xl
        assert xl["histogram_binned"] == 1, xl
        assert xl["trace_round_posed"] == 0, xl
        # The export's one banded convolution splits through the kernel.
        assert xl["band_split"] == 1, xl
        audio = wav.read_wav(Path(tmp) / "banded.wav")
        assert audio.n_channels == 2 and audio.sample_rate == SR
        assert audio.n_frames == 5 * SR and np.isfinite(audio.samples).all()
        peaks = np.abs(audio.samples).max(axis=1)
        assert np.all(np.abs(peaks - 1.0) < 1e-3), peaks
        ir = r.ir
        assert ir.shape == (2, n_bands, IR_SECONDS * SR)
        assert np.isfinite(ir).all() and (ir > 0).sum(axis=-1).min() >= 200
        assert np.all(np.diff(ir.sum(axis=(0, 2))) < 0)

        # The banded trace on the card against the CPU plain path.
        d = unit_dirs(65536, 5)
        targs = (r.emitter_pos, r.receiver_pos, r.receiver_yaw_deg, r.params,
                 r.opts)
        ir_gpu = tracer.trace_ir(r.sc, torch.from_numpy(d).cuda(), *targs)
        ir_cpu = tracer.trace_ir(tracer.scene_to_arrays(ctx.scene,
                                                        device="cpu"),
                                 torch.from_numpy(d), *targs)
        nb = IR_SECONDS * SR
        testing.assert_ir_close(ir_gpu.cpu().numpy().reshape(-1, nb),
                                ir_cpu.numpy().reshape(-1, nb), exact=False)
        # The filterbank on the card against the CPU's, on the export's IR.
        samples = torch.from_numpy(ctx.audio.mono())
        wet = r.convolve_audio_file_device(samples.cuda()).cpu()
        wet_cpu = filterbank.convolve_file_banded(
            samples, torch.from_numpy(ir), SR, r.band_edges)
        conv_err = float((wet - wet_cpu).abs().max() / wet_cpu.abs().max())
        assert wet.shape == (2, 5 * SR) and conv_err < 1e-4, conv_err
        render_ms = median_ms(r.render, 5)
        conv_ms = median_ms(
            lambda: r.convolve_audio_file_device(samples.cuda()), 5)
        log(f"banded export ({n_bands} bands, {N_RAYS} rays, {MAX_BOUNCES} "
            f"bounces): WAV stereo {SR} Hz, peaks {peaks.tolist()}; IR "
            f"energy per band {ir.sum(axis=(0, 2)).tolist()}; on 65536 "
            f"shared directions the CUDA IR passes assert_ir_close("
            f"exact=False) against the CPU plain path in every (ear, "
            f"band); the banded convolution on the card is within "
            f"{conv_err:.3e} of its peak of the CPU's (bar 1e-4); render "
            f"{render_ms:.3f} ms (median of 5), banded convolve of the 5 s "
            f"signal {conv_ms:.3f} ms")

    # The banded office matrix's histogram: its 1 x 4 x 250,000 rays
    # through the posed schedule and K2 at 4 bands (the office's one
    # absorption in every band), then the hard-binning stage.
    dev = torch.device("cuda")
    orows, oboxes = _office_packed(32, n_bands)
    oev = rc.trace_events_pose_batch(
        orows, _pose_directions(1, 4, OFFICE_MATRIX_RAYS, dev),
        torch.zeros((4, 3), device=dev),
        torch.from_numpy(OFFICE_LISTENERS).to(dev),
        torch.from_numpy(MULTI_YAWS).to(dev), _office_params(n_bands),
        boxes=oboxes, route=rc.Route("sched", "sort"))
    binned_check(*oev, _office_params(n_bands),
                 f"office 1 x 4 matrix, {n_bands} bands")
    return {"trace_round_posed_4band": launches["trace_round_posed"],
            "band_split_export": xl["band_split"]}


def phase_native_rng() -> int:
    """A native_rng render of the box against renders of sampled
    directions; returns K4's launches in one render."""
    from audiorenderingv2_tpu_torch import tuned
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer

    budgets = tuned.round_budgets_for(MAX_BOUNCES)

    def renderer(native: bool, seed: int) -> AudioRenderer:
        r = AudioRenderer(_box_scene(), IR_SECONDS, SR, N_RAYS,
                          base_power=3.62, max_bounces=MAX_BOUNCES,
                          hrtf_absorption_rate=0.9, seed=seed, device="cuda",
                          opts=TracerOptions(round_budgets=budgets,
                                             native_rng=native))
        r.set_emitter_pos(EMITTER)
        r.set_receiver(RECEIVER, 0.0)
        return r

    def coarse(ir):  # 20 ms bins
        return ir.reshape(2, -1, SR // 50).sum(axis=-1)

    def l1(a, b):
        return float(np.abs(a - b).sum() / np.abs(b).sum())

    n_seeds = 8
    sampled = [renderer(False, s).render().copy() for s in range(n_seeds)]
    native_r = renderer(True, 0)
    _reset_launches()
    native = native_r.render().copy()
    torch.cuda.synchronize()
    launches = _read_launches()
    assert launches["init_state"] == 1, launches
    assert launches["trace_round"] == len(budgets), launches
    assert native.shape == (2, IR_SECONDS * SR) and np.isfinite(native).all()
    assert np.all((native > 0).sum(axis=1) >= 200)
    natives = [native] + [renderer(True, s).render().copy()
                          for s in range(1, n_seeds)]
    # Two samples of n_seeds renders each: the means of the per-ear energy
    # within 5 standard errors of their difference, and spreads of one
    # size (4 renders gave a spread 6 times too small once, by chance).
    es = np.array([ir.sum(axis=1) for ir in sampled], np.float64)
    en = np.array([ir.sum(axis=1) for ir in natives], np.float64)
    ss, sn = es.std(axis=0, ddof=1), en.std(axis=0, ddof=1)
    diff = np.abs(en.mean(axis=0) - es.mean(axis=0))
    sem = np.sqrt((ss ** 2 + sn ** 2) / n_seeds)
    assert np.all(diff < 5 * sem), (diff, sem)
    assert np.all(sn < 3 * ss) and np.all(ss < 3 * sn), (ss, sn)
    among = max(l1(coarse(a), coarse(b)) for i, a in enumerate(sampled)
                for b in sampled[i + 1:])
    to_native = float(np.mean([l1(coarse(native), coarse(b))
                               for b in sampled]))
    assert to_native < 2 * among, (to_native, among)
    native_ms = median_ms(native_r.render, 5)
    sampled_ms = median_ms(renderer(False, 0).render, 5)
    log(f"native_rng render ({N_RAYS} rays, {MAX_BOUNCES} bounces): "
        f"launches {launches}; per-ear energy over {n_seeds} seeds: native "
        f"mean {en.mean(axis=0).tolist()} std {sn.tolist()}, sampled mean "
        f"{es.mean(axis=0).tolist()} std {ss.tolist()}; the means differ "
        f"by {(diff / sem).round(2).tolist()} standard errors (bar 5); "
        f"relative L1 of the IR in 20 ms bins to the sampled renders "
        f"{to_native:.3e}, among them at most {among:.3e} (bar: twice "
        f"that); render {native_ms:.3f} ms with native_rng, "
        f"{sampled_ms:.3f} ms with sampled directions")
    return launches["init_state"]


def phase_histogram_bwd() -> dict:
    """K3-bwd against its plain version, bit for bit, at the shapes the
    gradient path gives it, and the Function's gradient against autograd's
    through ``index_add_``; returns the JSON entry's numbers (those of the
    soft stereo IR at one band)."""
    from audiorenderingv2_tpu_torch.core import binning
    from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc

    n_pad = -(-N_RAYS // 128) * 128
    ir_bins = 2 * IR_SECONDS * SR
    # (what, events, bins, bands, events dropped from the front: a view
    # that starts 4 bytes into its storage)
    shapes = [("soft stereo IR", 4 * n_pad, ir_bins, 1, 0),
              ("soft stereo IR", 4 * n_pad, ir_bins, 4, 0),
              ("soft stereo IR, E = 4k + 3", 4 * n_pad + 3, ir_bins, 1, 0),
              ("soft stereo IR, a bins[1:] view (E = 4k + 1)",
               4 * n_pad + 2, ir_bins, 1, 1),
              ("soft stereo IR, E = 4k + 2", 4 * n_pad + 2, ir_bins, 4, 0),
              ("soft stereo IR, 8 bands", 4 * n_pad, ir_bins, 8, 0),
              ("posed histogram", 8 * n_pad, 8 * ir_bins, 1, 0)]
    rng = np.random.default_rng(17)
    result = None
    for what, n_all, n_bins, n_bands, skip in shapes:
        # A fifth of the bins out of range on either side, the sentinel
        # n_bins (what an inactive deposit carries) among them.
        bins = rng.integers(-n_bins // 8, n_bins + n_bins // 8,
                            size=n_all).astype(np.int32)
        bins[::97] = n_bins
        b_d = torch.from_numpy(bins).cuda()[skip:]
        n_events = b_d.shape[0]
        assert b_d.is_contiguous() and (b_d.data_ptr() % 16 != 0) == (
            skip > 0)
        g = torch.from_numpy(rng.standard_normal(
            (n_bins, n_bands)).astype(np.float32)).cuda()
        kern = hc.histogram_bwd(b_d, g)
        plain = hc.histogram_bwd_plain(b_d, g)
        torch.cuda.synchronize()
        keep = (b_d >= 0) & (b_d < n_bins)
        assert kern.shape == (n_events, n_bands)
        assert torch.equal(kern, plain), f"K3-bwd, {what}: not bit-identical"
        assert not kern[~keep].any() and int((~keep).sum()) > n_events // 10
        # The one PyTorch call for the same function: index_select on the
        # gradient padded with a zero row (set up outside the timing).
        g_pad = torch.cat([g, torch.zeros((1, n_bands), device="cuda")])
        idx = torch.where(keep, b_d, n_bins).long()
        assert torch.equal(g_pad.index_select(0, idx), kern)
        ms = median_ms(lambda: hc.histogram_bwd(b_d, g), 20)
        plain_ms = median_ms(lambda: hc.histogram_bwd_plain(b_d, g), 10)
        lib_ms = median_ms(lambda: g_pad.index_select(0, idx), 20)
        bwd_bound = bound(nbytes(b_d, g, kern), 0)
        log(f"K3-bwd, {what}: {n_events} events x {n_bands} band(s) from "
            f"{n_bins} bins, {int((~keep).sum())} out of range: "
            f"bit-identical to the plain version and to index_select; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
            f"{lib_ms:.4f} ms, bound {bwd_bound['bound_ms']:.4f} ms by "
            f"{bwd_bound['bound_by']}")
        if result is None:
            result = {"max_abs_err": float((kern - plain).abs().max()),
                      "ms": ms, "plain_ms": plain_ms, **bwd_bound,
                      "library_ms": lib_ms}

    # The Function: forward K3, backward K3-bwd, against autograd through
    # index_add_ (which gathers the same rows, so the gradients are equal).
    w = torch.rand((n_events, 1), device="cuda", requires_grad=True)
    _reset_launches()
    hist = binning.histogram_sum_banded(b_d, w, n_bins)
    (hist * g).sum().backward()
    torch.cuda.synchronize()
    fl = _read_launches()
    assert fl["histogram"] == 1 and fl["histogram_bwd"] == 1, fl
    w2 = w.detach().clone().requires_grad_(True)
    h2 = torch.zeros((n_bins, 1), device="cuda").index_add(
        0, b_d[keep].long(), w2[keep])
    (h2 * g).sum().backward()
    assert torch.equal(w.grad, w2.grad), "Function gradient != index_add_'s"
    log(f"histogram Function, {n_events} events: one K3 launch forward, "
        f"one K3-bwd launch backward; d(sum(hist * g))/d(weights) equals "
        f"autograd's through index_add_ bit for bit")
    return result


def k5_work(state: torch.Tensor, visits: torch.Tensor, n_clusters: int,
            cs: int, alive: torch.Tensor) -> tuple[float, float]:
    """FP32 operations of one K5 bounce: a triangle test of every alive ray
    against the rows of every cluster its tile visited, and a slab test of
    every alive ray against each superbox of 32 clusters (the least a
    two-level pass 1 tests); then, beside it, the same with a slab test
    against every box (the all-pairs count of a one-level pass)."""
    per_tile = alive.view(-1, 128).sum(dim=1).double()
    tests = float((per_tile * visits.double()).sum()) * cs * TRI_TEST_OPS
    slab = float(per_tile.sum()) * SLAB_TEST_OPS
    return (tests + slab * -(-n_clusters // 32), tests + slab * n_clusters)


def phase_traverse() -> dict:
    """K5 against its plain version on the office (clusters of 32 and of
    128) and against K2 at full width; returns the JSON entry's numbers."""
    from audiorenderingv2_tpu_torch import accel, constants
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc
    from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc

    dev = torch.device("cuda")
    params = _office_params()
    emitter = torch.tensor(EMITTER, device=dev)
    receiver = torch.tensor(OFFICE_RECEIVER, device=dev)
    scene = _office_clustered()[0]
    event_cols = [rc._C_DIST, rc._C_EN, rc._C_DEPTH, rc._C_DONE, rc._C_EVB,
                  rc._C_EVW, rc._C_EVE, rc._C_RECVD]
    result, errs = None, []
    for cs in (32, 128):
        if cs == 32:
            _, _, rows, boxes = _office_clustered()
        else:
            sorted_scene, clusters = accel.prepare_scene(scene,
                                                         cluster_size=cs)
            rows, boxes = rc.pack_tris_clusters(tracer.scene_to_arrays(
                sorted_scene, 128, device=dev, clusters=clusters))
        n_clusters = boxes.shape[0]
        for n in (65536, -(-N_RAYS // 128) * 128):
            e0 = params.base_power / (n * constants.SPHERE_VOLUME)
            st = rc.init_state(torch.from_numpy(unit_dirs(n, 18)).to(dev),
                               emitter, e0, n)
            scal = rc.scalars(emitter, receiver, 0.0, e0, params)
            # The start state (round 1, unsorted), after one bounce and
            # the sort, after 16 bounces.
            for step in range(3):
                visits = torch.zeros(n // 128, dtype=torch.int32, device=dev)
                kern = tc.trace_traverse(st.clone(), rows, boxes, scal,
                                         params, 1, visits=visits)
                torch.cuda.synchronize()
                assert torch.isfinite(kern).all()
                when = ("start state", "after one bounce and the sort",
                        "after 16 bounces")[step]
                what = (f"K5, office, {n_clusters} clusters of {cs}, {n} "
                        f"rays, {when}")
                line = (f"{what}: visits per tile mean "
                        f"{float(visits.float().mean()):.2f}, max "
                        f"{int(visits.max())}")
                # Against the plain version, at both widths: every column and
                # every tile's visit count, bit for bit. At full width the
                # plain run is also the one that is timed.
                vp = torch.zeros_like(visits)
                t_start = torch.cuda.Event(enable_timing=True)
                t_end = torch.cuda.Event(enable_timing=True)
                plain = st.clone()
                t_start.record()
                tc.trace_traverse_plain(plain, rows, boxes, scal, params, 1,
                                        visits=vp)
                t_end.record()
                torch.cuda.synchronize()
                plain_ms = t_start.elapsed_time(t_end)
                err = _assert_same_bits(kern, plain, what)
                assert torch.equal(visits, vp), f"{what}: visits differ"
                errs.append(err)
                del plain
                line += ("; every column and every tile's visit count "
                         "bit-identical to the plain version")
                if n != 65536 and step < 2:
                    # Against K2 on the same state. Equal distances and
                    # events everywhere; the triangle, and with it the
                    # reflected direction, may differ only where two
                    # triangles tie for the nearest hit (K5 keeps the
                    # cluster visited first, K2 the lowest row).
                    sched = sc.tile_schedule(st, boxes)
                    k2 = sc.trace_round_sched(st.clone(), rows, boxes, sched,
                                              scal, params)
                    torch.cuda.synchronize()
                    assert torch.equal(kern[event_cols], k2[event_cols]), \
                        f"{what}: DIST or an event column differs from K2"
                    tie = kern[rc._C_LTRI] != k2[rc._C_LTRI]
                    assert torch.equal(kern[:, ~tie], k2[:, ~tie]), \
                        f"{what}: a ray with K2's triangle differs from K2"
                    assert int(tie.sum()) <= 64, int(tie.sum())
                    assert (visits <= sched[:, 0]).all()
                    line += (f"; against K2: DIST, energy and the event "
                             f"columns equal bit for bit, {int(tie.sum())} "
                             f"ray(s) bounce off another triangle at the "
                             f"same distance, every other ray equal in "
                             f"every column; candidates per tile mean "
                             f"{float(sched[:, 0].float().mean()):.2f}")
                    if step == 1:
                        alive = (st[rc._C_DONE] == 0)
                        ms = median_ms(lambda s: tc.trace_traverse(
                            s, rows, boxes, scal, params, 1), 5,
                            setup=lambda: (st.clone(),))
                        k2_ms = median_ms(lambda s: sc.trace_round_sched(
                            s, rows, boxes, sc.tile_schedule(s, boxes), scal,
                            params), 5, setup=lambda: (st.clone(),))
                        ops, all_pairs = k5_work(st, visits, n_clusters,
                                                 cs, alive)
                        k5_bound = bound(
                            2 * nbytes(st) + nbytes(rows, boxes, scal), ops)
                        all_pairs = bound(0, all_pairs)["bound_ms"]
                        line += (f"; K5 {ms:.3f} ms, schedule + K2 "
                                 f"{k2_ms:.3f} ms, plain {plain_ms:.3f} ms "
                                 f"(the compared run, after the start "
                                 f"state's as warm-up), bound "
                                 f"{k5_bound['bound_ms']:.4f} ms by "
                                 f"{k5_bound['bound_by']} (with every box "
                                 f"slab-tested {all_pairs:.4f})")
                        if cs == 32:
                            # The recorder's own shape: clusters of 32,
                            # 1,000,064 rays, one bounce a launch.
                            result = {"max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms, **k5_bound,
                                      "all_pairs_bound_ms": all_pairs,
                                      "library_ms": None}
                log(line)
                st = rc._sort_state_by_keys(kern, rc._compaction_keys(kern))
                if step == 1:  # 14 more bounces through the kernel
                    for _ in range(14):
                        st = tc.trace_traverse(st, rows, boxes, scal, params,
                                               1)
                        st = rc._sort_state_by_keys(
                            st, rc._compaction_keys(st))
    assert len(errs) == 12 and max(errs) == 0.0, errs
    posed_traverse_check()
    return result


def posed_traverse_check() -> None:
    """K5 with one scalar row per pose, the launch that no entry point
    makes (a clustered pose batch goes through the schedule) but the
    wrapper takes: the office, 4 poses x 250,112 rays, the start state and
    the state after a bounce and the per-pose sort, bit for bit against the
    plain version in every column and against single-pose launches."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc

    dev = torch.device("cuda")
    p, n = 4, OFFICE_MATRIX_RAYS
    n_pad = -(-n // 128) * 128
    params = _office_params()
    _, _, rows, boxes = _office_clustered()
    em = torch.zeros((p, 3), device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    st = rc.init_state(_pose_directions(1, p, n, dev), em, e0, n_pad)
    scal = rc.scalars(em, torch.from_numpy(OFFICE_LISTENERS).to(dev),
                      torch.from_numpy(MULTI_YAWS).to(dev), e0, params)
    assert scal.shape == (p, 16)
    tiles = n_pad // 128
    for step in range(2):
        what = (f"posed K5, office, {p} poses x {n_pad} rays, "
                + ("start state" if step == 0
                   else "after one bounce and the per-pose sort"))
        visits = torch.zeros(p * tiles, dtype=torch.int32, device=dev)
        vp = torch.zeros_like(visits)
        kern = tc.trace_traverse(st.clone(), rows, boxes, scal, params, 1,
                                 n_pad, visits=visits)
        plain = tc.trace_traverse_plain(st.clone(), rows, boxes, scal,
                                        params, 1, n_pad, visits=vp)
        torch.cuda.synchronize()
        err = _assert_same_bits(kern, plain, what)
        assert torch.equal(visits, vp), f"{what}: visits differ"
        for i in range(p):
            seg = slice(i * n_pad, (i + 1) * n_pad)
            one = tc.trace_traverse(st[:, seg].contiguous(), rows, boxes,
                                    scal[i].contiguous(), params, 1)
            assert torch.equal(one, kern[:, seg]), \
                f"{what}: pose {i} differs from a single-pose launch"
        ms = median_ms(lambda s: tc.trace_traverse(
            s, rows, boxes, scal, params, 1, n_pad), 3,
            setup=lambda: (st.clone(),))
        log(f"{what}: every column and every tile's visit count "
            f"bit-identical to the plain version (max abs err {err}), every "
            f"pose's segment to a single-pose launch; visits per tile mean "
            f"{float(visits.float().mean()):.2f}; kernel {ms:.3f} ms")
        st = rc._sort_state_by_keys(kern, rc._compaction_keys(kern, n_poses=p),
                                    p)
    assert int((kern[rc._C_DONE] == 0).sum()) > 1000


def _grad_params(max_bounces: int = OFFICE_BOUNCES):
    """The gradient benchmark's parameters (benchmarks/
    grad_bench_clustered.py:56-58): the default hrtf absorption rate."""
    from audiorenderingv2_tpu_torch.core.params import TraceParams

    return TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                       base_power=3.62, max_bounces=max_bounces,
                       energy_threshold=0.0)


def phase_recording() -> dict:
    """The path recorder on the card: which kernel each route launches, its
    paths against the plain search, and the replay of recorded paths
    against the forward render. Returns K5's launches on its main path."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.diff import replay

    dev = torch.device("cuda")
    params = _grad_params()
    _, scc, rows, boxes = _office_clustered()
    d = torch.from_numpy(unit_dirs(N_RAYS, 0)).to(dev)
    args = (d, EMITTER, OFFICE_RECEIVER, 0.0, params)
    paths, launches = {}, {}
    for name, opts in (("schedule", tracer.TracerOptions(schedule=True)),
                       ("k5", tracer.TracerOptions())):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths[name] = replay.record_paths_kernels(scc, *args, opts,
                                                  rows=rows, boxes=boxes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = _read_launches()
        log(f"record_paths_kernels, office, {N_RAYS} rays x {OFFICE_BOUNCES}"
            f" bounces, {name}: {wall * 1e3:.1f} ms (first call); launches "
            f"{launches[name]}")
    ls, lk = launches["schedule"], launches["k5"]
    assert ls["tile_schedule"] == ls["trace_round_sched"] == OFFICE_BOUNCES
    assert ls["trace_traverse"] == ls["trace_round"] == 0, ls
    assert lk["trace_traverse"] == OFFICE_BOUNCES, lk
    assert lk["tile_schedule"] == lk["trace_round_sched"] == 0, lk
    assert lk["trace_round"] == 0, lk
    (ids_s, recv_s), (ids_k, recv_k) = paths["schedule"], paths["k5"]
    assert ids_s.shape == (N_RAYS, OFFICE_BOUNCES) and \
        ids_s.dtype == recv_s.dtype == torch.int32
    same = (ids_s == ids_k).all(dim=1) & (recv_s == recv_k)
    hits = int((recv_s >= 0).sum())
    assert hits > 1000 and float(same.float().mean()) >= 0.995
    log(f"recorded paths: {hits} rays reach the receiver; the schedule's "
        f"and K5's recordings agree on {int(same.sum())} of {N_RAYS} rays "
        f"(a tie between two triangles parts the rest)")

    # The box: K1 in one-bounce rounds.
    box = tracer.scene_to_arrays(_box_scene(), 128, device=dev)
    _reset_launches()
    ids_b, recv_b = replay.record_paths_kernels(
        box, d, EMITTER, RECEIVER, 30.0, params)
    torch.cuda.synchronize()
    lb = _read_launches()
    assert lb["trace_round"] == OFFICE_BOUNCES, lb
    assert lb["trace_traverse"] == lb["trace_round_sched"] == 0, lb
    log(f"record_paths_kernels, box, {N_RAYS} rays x {OFFICE_BOUNCES} "
        f"bounces: launches {lb}; {int((recv_b >= 0).sum())} rays reach "
        f"the receiver")

    # Against the plain search, 65,536 rays x 8 bounces on the office.
    p8 = _grad_params(8)
    d8 = d[:65536]
    found = []
    search = replay.record_paths(
        scc, d8, EMITTER, OFFICE_RECEIVER, 0.0, p8,
        tracer.TracerOptions(backend="autograd", tri_chunk=2048))
    for name, opts in (("schedule", tracer.TracerOptions(schedule=True)),
                       ("k5", tracer.TracerOptions())):
        got = replay.record_paths_kernels(scc, d8, EMITTER, OFFICE_RECEIVER,
                                          0.0, p8, opts, rows=rows,
                                          boxes=boxes)
        share = float(((got[0] == search[0]).all(dim=1)
                       & (got[1] == search[1])).float().mean())
        assert share >= 0.995, (name, share)
        found.append(f"{name} {share * 100:.4f}%")
    log(f"recorders against record_paths (plain search), office, 65536 rays "
        f"x 8 bounces, rays with identical paths (bar 99.5%): "
        f"{', '.join(found)}")

    # The replay of the recorded paths against the forward render.
    for name, (ids, recv), sc_, rcv, yaw in (
            ("office (K5's recording)", paths["k5"], scc, OFFICE_RECEIVER,
             0.0),
            ("box (K1's recording)", (ids_b, recv_b), box, RECEIVER, 30.0)):
        with torch.no_grad():
            ir_rep = replay.render_ir_replay(sc_, ids, recv, d, EMITTER, rcv,
                                             yaw, params, soft_binning=False)
        ir_fwd = tracer.trace_ir(sc_, d, EMITTER, rcv, yaw, params,
                                 tracer.TracerOptions(schedule=True))
        testing.assert_ir_close(ir_rep.cpu().numpy(), ir_fwd.cpu().numpy(),
                                exact=False)
        log(f"render_ir_replay(soft_binning=False), {name}, {N_RAYS} rays: "
            f"passes assert_ir_close(exact=False) against the forward "
            f"render of the same directions; energy "
            f"{float(ir_rep.sum()):.6e} / {float(ir_fwd.sum()):.6e}, max "
            f"abs diff {float((ir_rep - ir_fwd).abs().max()):.3e}")
    return {"trace_traverse": lk["trace_traverse"]}


def profile_device(fn, top: int = 8) -> str:
    """One call of ``fn`` under torch.profiler: the device's busy share of
    the wall time and its kernels by total time, as text."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        return "the profiler reported no device time: not measured"
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    head = "; ".join(f"{ms:.1f} ms in {n} x {key[:70]}"
                     for ms, n, key in rows[:top])
    return (f"{wall_ms:.1f} ms of wall under the profiler, the device busy "
            f"{busy:.1f} ms ({100 * busy / wall_ms:.0f}%) in "
            f"{sum(r[1] for r in rows)} kernel launches of {len(rows)} "
            f"kinds; the largest: {head}")


def phase_gradient_step() -> None:
    """The gradient step at full width (benchmarks/grad_bench_clustered.py's
    shape: the office in clusters of 32, 1M rays x 32 bounces, a 2 s IR at
    16 kHz): record, replay, d(loss)/d(absorption logits); then its gate at
    16,384 rays x 8 bounces: the replay's gradient against the autograd
    tracer's on the card, and against the replay's on the CPU."""
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.diff import replay
    from audiorenderingv2_tpu_torch.diff.inverse import \
        with_material_absorption

    dev = torch.device("cuda")
    params = _grad_params()
    _, scc, rows, boxes = _office_clustered()
    mat_ids = torch.zeros(scc.plane_n.shape[0], dtype=torch.long, device=dev)
    d = torch.from_numpy(unit_dirs(N_RAYS, 0)).to(dev)
    sched_opts = tracer.TracerOptions(schedule=True)

    def record(opts):
        return replay.record_paths_kernels(scc, d, EMITTER, OFFICE_RECEIVER,
                                           0.0, params, opts, rows=rows,
                                           boxes=boxes)

    def replay_ir(logits, sc_, ids, recv, dirs, p):
        sc_t = with_material_absorption(sc_, mat_ids.to(logits.device),
                                        torch.sigmoid(logits))
        return replay.render_ir_replay(sc_t, ids, recv, dirs, EMITTER,
                                       OFFICE_RECEIVER, 0.0, p,
                                       soft_binning=False)

    record_ms = median_ms(lambda: record(sched_opts), 3)
    record_k5_ms = median_ms(lambda: record(tracer.TracerOptions()), 3)
    ids, recv = record(sched_opts)
    logits = torch.zeros(1, device=dev, requires_grad=True)
    with torch.no_grad():
        replay_ms = median_ms(
            lambda: replay_ir(logits, scc, ids, recv, d, params), 3)
        target = replay_ir(logits, scc, ids, recv, d, params) * 0.9

    def grad_step():
        logits.grad = None
        ir = replay_ir(logits, scc, ids, recv, d, params)
        (torch.mean((ir - target) ** 2) * 1e12).backward()

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    grad_step()
    torch.cuda.synchronize()
    gl = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    g_big = float(logits.grad)
    assert gl["histogram"] == 1 and gl["histogram_bwd"] == 1, gl
    assert np.isfinite(g_big) and g_big != 0.0
    grad_ms = median_ms(grad_step, 3)

    def forward_only():
        return replay_ir(logits, scc, ids, recv, d, params)

    fwd_graph_ms = median_ms(forward_only, 3)
    log(f"gradient step, one grad under torch.profiler: "
        f"{profile_device(grad_step)}")
    total = record_ms + replay_ms + grad_ms
    log(f"gradient step, office ({boxes.shape[0]} clusters of 32), {N_RAYS} "
        f"rays x {OFFICE_BOUNCES} bounces, {IR_SECONDS} s IR at {SR} Hz, "
        f"CUDA events, medians of 3: record {record_ms:.1f} ms with the "
        f"schedule ({record_k5_ms:.1f} ms with K5), replay {replay_ms:.1f} "
        f"ms, grad (replay + backward) {grad_ms:.1f} ms, of which the "
        f"replay with its graph kept {fwd_graph_ms:.1f} ms; "
        f"{1e3 / total:.3f} steps/s with a recording each step, "
        f"{1e3 / (replay_ms + grad_ms):.3f} without; peak device memory of "
        f"one grad {peak:.0f} MiB; launches per grad {gl}; g = {g_big:.6e}")

    # Why the replay gathers scene rows with index_select: the backward of
    # the two gathers at this step's own shape, one bounce's triangle ids
    # into a per-triangle table.
    table = torch.rand((scc.plane_n.shape[0], 1), device=dev,
                       requires_grad=True)
    ti = ids[:, 0].clamp(min=0).long()
    g_out = torch.rand((ti.shape[0], 1), device=dev)

    def bwd(gather):
        return torch.autograd.grad(gather(), table, g_out)[0]

    g_put = bwd(lambda: table[ti])
    g_add = bwd(lambda: table.index_select(0, ti))
    assert torch.allclose(g_put, g_add, rtol=1e-4, atol=1e-5)
    put_ms = median_ms(lambda: bwd(lambda: table[ti]), 3)
    add_ms = median_ms(lambda: bwd(lambda: table.index_select(0, ti)), 3)
    log(f"gather of {ti.shape[0]} triangle ids from a [{table.shape[0]}, 1] "
        f"table, forward + backward: table[ids] {put_ms:.3f} ms, "
        f"index_select {add_ms:.3f} ms (the replay's choice; 32 such "
        f"gathers of absorption a step)")

    # The gate (grad_bench_clustered.py:120-161).
    n_s, p_s = 16384, _grad_params(8)
    d_s = torch.from_numpy(unit_dirs(n_s, 1)).to(dev)
    ids_s, recv_s = replay.record_paths_kernels(
        scc, d_s, EMITTER, OFFICE_RECEIVER, 0.0, p_s, sched_opts, rows=rows,
        boxes=boxes)
    with torch.no_grad():
        tgt = replay_ir(logits, scc, ids_s, recv_s, d_s, p_s) * 0.9
    full_opts = tracer.TracerOptions(backend="autograd", block_size=2048,
                                     tri_chunk=2048, early_exit=False,
                                     remat=True)

    def g_of(ir_fn, lg):
        (torch.mean((ir_fn(lg) - tgt.to(lg.device)) ** 2) * 1e12).backward()
        return float(lg.grad)

    t0 = time.perf_counter()
    g_full = g_of(lambda lg: tracer.trace_ir(
        with_material_absorption(scc, mat_ids, torch.sigmoid(lg)), d_s,
        EMITTER, OFFICE_RECEIVER, 0.0, p_s, full_opts),
        torch.zeros(1, device=dev, requires_grad=True))
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    g_rep = g_of(lambda lg: replay_ir(lg, scc, ids_s, recv_s, d_s, p_s),
                 torch.zeros(1, device=dev, requires_grad=True))
    scc_cpu = tracer.SceneArrays(*(None if x is None else x.cpu()
                                   for x in scc))
    g_cpu = g_of(lambda lg: replay_ir(lg, scc_cpu, ids_s.cpu(), recv_s.cpu(),
                                      d_s.cpu(), p_s),
                 torch.zeros(1, requires_grad=True))
    rel = abs(g_full - g_rep) / max(abs(g_full), 1e-30)
    rel_cpu = abs(g_cpu - g_rep) / max(abs(g_cpu), 1e-30)
    assert rel < 1e-2, (g_full, g_rep)
    assert rel_cpu < 1e-3, (g_cpu, g_rep)
    log(f"gradient gate, {n_s} rays x 8 bounces on the office: autograd "
        f"tracer {g_full:.6e} (in {full_s:.1f} s), replay {g_rep:.6e}, "
        f"relative difference {rel:.2e} (bar 1e-2); the replay's gradient "
        f"on the CPU from the same paths {g_cpu:.6e}, relative difference "
        f"{rel_cpu:.2e} (bar 1e-3)")


def phase_trainer() -> dict:
    """A trainer that takes a few steps: ``fit_scene_parameters`` at full
    width on the office (5 Adam steps on the absorption logits at 1M rays,
    from recorded paths), the launch counts read around it (the inverse
    demo's own fit runs in phase 23). Returns the launches of the office
    fit."""
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.diff import (fit_scene_parameters,
                                                 record_paths_kernels,
                                                 render_ir_replay)

    dev = torch.device("cuda")
    params = _grad_params()
    scene, scc, rows, boxes = _office_clustered()
    d = torch.from_numpy(unit_dirs(N_RAYS, 2)).to(dev)
    # The target: the soft IR of the scene as it is (absorption 0.3), by
    # the replay of its own recorded paths.
    with torch.no_grad():
        ids, recv = record_paths_kernels(
            scc, d, EMITTER, OFFICE_RECEIVER, 0.0, params,
            tracer.TracerOptions(schedule=True), rows=rows, boxes=boxes)
        target = render_ir_replay(scc, ids, recv, d, EMITTER,
                                  OFFICE_RECEIVER, 0.0, params)
    del ids, recv
    grads = []

    def watch(i, loss, theta):
        g = theta["absorption_logits"].grad
        grads.append(bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0))

    steps = 5
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_scene_parameters(
        scene, target, params, steps=steps, learning_rate=0.1,
        init_absorption=0.5, receiver_pos=OFFICE_RECEIVER, method="replay",
        replay_refresh=25, device="cuda", directions=d, callback=watch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fl = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"trainer, office, {N_RAYS} rays x {OFFICE_BOUNCES} bounces, "
        f"fit_scene_parameters(method='replay'), {steps} Adam steps on the "
        f"absorption logits from 0.5 (true 0.3): {wall:.2f} s; losses "
        f"{[float(f'{x:.6e}') for x in res.losses]}; absorption "
        f"{res.params['absorption'].tolist()}; launches {fl}; peak device "
        f"memory {peak:.0f} MiB")
    assert fl["tile_schedule"] == fl["trace_round_sched"] == OFFICE_BOUNCES
    assert fl["histogram"] == fl["histogram_bwd"] == steps, fl
    assert fl["replay"] == fl["replay_bwd"] == steps, fl
    assert fl["trace_round"] == fl["trace_traverse"] == 0, fl
    assert len(res.losses) == steps and np.isfinite(res.losses).all()
    assert np.all(np.diff(res.losses) < 0), res.losses
    assert len(grads) == steps and all(grads)
    assert 0.3 < float(res.params["absorption"][-1]) < 0.5

    return fl


def _box_params(n_bands: int = 1):
    from audiorenderingv2_tpu_torch.core.params import TraceParams

    return TraceParams(sample_rate=SR, ir_length=IR_SECONDS * SR,
                       base_power=3.62, max_bounces=MAX_BOUNCES,
                       hrtf_absorption_rate=0.9, n_bands=n_bands)


def _start_state(n: int, params, n_bands: int = 1):
    """The box's start state [ncols, n_pad] of ``n`` seeded rays and its
    scalar row."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    emitter = torch.tensor(EMITTER, device=dev)
    receiver = torch.tensor(RECEIVER, device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    d = torch.from_numpy(unit_dirs(n, 11)).to(dev)
    return (rc.init_state(d, emitter, e0, -(-n // 128) * 128, n_bands),
            rc.scalars(emitter, receiver, 30.0, e0, params))


def _scene_arrays(mesh, n_bands: int = 1, pad_to: int | None = None):
    """Scene arrays on the card of a (vertices, triangles) mesh, absorption
    0.3 or the banded phases' per band (8 bands: 0.1 to 0.6); ``pad_to`` appends all-zero padding
    triangles up to that count."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.core import tracer

    per_band = (BANDED_ABSORPTION[:n_bands] if n_bands <= 4
                else np.linspace(0.1, 0.6, n_bands))
    absorb = ABSORPTION if n_bands == 1 else np.tile(
        np.asarray(per_band, np.float32), (mesh[1].shape[0], 1))
    sc = tracer.scene_to_arrays(testing.scene_from_arrays(*mesh, absorb),
                                128, device="cuda")
    if pad_to is not None:
        extra = pad_to - sc.valid.shape[0]
        sc = sc._replace(**{
            k: torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
            for k, x in sc._asdict().items() if x is not None})
    return sc


def _group_bound(precision: str, n_bytes: float, tests: int) -> dict:
    """K6's bound: "highest" on K1's 40 FP32 operations a test; "high" on
    the test's FP32 operations beside the tensor cores (the product at the
    bf16 rate plus the rest at the FP32 rate), or the bytes."""
    if precision == "highest":
        return bound(n_bytes, tests * TRI_TEST_OPS)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = tests * (GROUP_HIGH_FP32_OPS / FP32_OPS_PER_S
                      + GROUP_HIGH_MMA_OPS / BF16_OPS_PER_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _group_issued_ms(precision: str, slots: int) -> float:
    """The bound at what K6 issues: every triangle slot it tests (up to the
    last valid triangle, whole groups with "high"), the product as run."""
    if precision == "highest":
        return slots * GROUP_TEST_OPS / FP32_OPS_PER_S * 1e3
    return slots * (GROUP_HIGH_FP32_OPS / FP32_OPS_PER_S
                    + GROUP_HIGH_MMA_AS_RUN / BF16_OPS_PER_S) * 1e3


def _group_slots(attrs: torch.Tensor, n_bands: int, precision: str) -> int:
    """Triangle slots K6 tests a ray-bounce: up to the last valid triangle,
    rounded up to 4 ("highest") or to its group of 8 ("high")."""
    valid = torch.nonzero(attrs[:, 3 + n_bands] > 0)
    last = int(valid.max()) if valid.numel() else -1
    step = 4 if precision == "highest" else 8
    return (last + step) // step * step


def _path_spread(kern: torch.Tensor, plain: torch.Tensor) -> dict:
    """The share of rays of ``kern`` on ``plain``'s path (LTRI, DEPTH, DONE,
    RECVD, EVE equal), the share also within HIGH_BAR_REL (relative to
    max(|x|, 1)) in every column, the largest relative difference on it."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    flags = [rc._C_LTRI, rc._C_DEPTH, rc._C_DONE, rc._C_RECVD, rc._C_EVE]
    same = (kern[flags] == plain[flags]).all(dim=0)
    rel = (kern - plain).abs() / plain.abs().clamp(min=1.0)
    within = same & (rel <= HIGH_BAR_REL).all(dim=0)
    return {"on_path": float(same.float().mean()),
            "within": float(within.float().mean()),
            "worst_rel": float(rel[:, same].max()) if bool(same.any())
            else math.inf}


def assert_high_bar(kern: torch.Tensor, plain: torch.Tensor, what: str,
                    k1: torch.Tensor, budget: int) -> dict:
    """K6 "high" against its plain version after a round of ``budget``
    bounces, on the bar above; ``k1`` is K1's f32 round on the same state,
    which gives the plain "high"'s own spread."""
    assert torch.isfinite(kern).all(), f"{what}: not finite"
    got = _path_spread(kern, plain)
    own = _path_spread(plain, k1)
    got["plain_vs_f32"] = own
    bar = {"on_path": HIGH_BAR_ON_PATH, "within": HIGH_BAR_WITHIN,
           "worst_rel": HIGH_BAR_REL_ALL}
    if budget >= HIGH_BAR_OWN_FROM:
        bar = {"on_path": min(bar["on_path"], own["on_path"]),
               "within": min(bar["within"], own["within"]),
               "worst_rel": max(bar["worst_rel"], own["worst_rel"])}
    got["bar"] = bar
    assert got["on_path"] >= bar["on_path"], (what, got)
    assert got["within"] >= bar["within"], (what, got)
    assert got["worst_rel"] <= bar["worst_rel"], (what, got)
    return got


def assert_probe_bar(state: torch.Tensor, coeffs: torch.Tensor,
                     what: str) -> dict:
    """The probe: every quantity of K6's tensor-core product, and of the
    plain "high", within 2^-20 of the sum of its 20 terms' magnitudes of
    their float64 sum."""
    from audiorenderingv2_tpu_torch.ops import group_cuda as gc

    kern = gc.products_high(state, coeffs)
    plain = gc.products_plain(state, coeffs)
    ref, mag = gc.high_terms_f64(state, coeffs)
    out = {}
    for who, q in (("kernel", kern), ("plain", plain)):
        err = (q.double() - ref).abs()
        assert bool((err <= 2.0 ** -20 * mag).all()), (what, who)
        out[who] = float((err / mag.clamp(min=1e-300)).max()) * 2.0 ** 20
    out["equal_to_plain"] = float((kern == plain).float().mean())
    return out


def log_group_sass() -> None:
    """`cuobjdump -sass` of the built library: every "high" K6 kernel (and
    the probe) issues HMMA, no "highest" one does."""
    from audiorenderingv2_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.build())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    seen = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"(trace_group_kernel|trace_group_chunks_kernel|"
                         r"group_probe_kernel)(?:ILi(\d)ELb([01])E)?",
                         fn.split("\n", 1)[0])
        if name is None:
            continue
        lines = [line for line in fn.splitlines() if "HMMA" in line]
        ops = sorted({w.rstrip(";") for line in lines for w in line.split()
                      if w.startswith("HMMA")})
        high = name.group(3) != "0"  # the probe, or a "high" kernel
        assert bool(lines) == high, (name.group(0), len(lines))
        key = name.group(1) + (f"<{name.group(2)}, "
                               f"{'high' if high else 'highest'}>"
                               if name.group(2) else "")
        seen[key] = (len(lines), ops)
    assert len(seen) == 13, seen
    log("K6 SASS (cuobjdump -sass): " + "; ".join(
        f"{k} {c} x {'/'.join(o) or '-'}" for k, (c, o) in seen.items()))


def phase_group() -> tuple[dict, dict, dict]:
    """K6 against its plain version and against K1; returns the JSON
    numbers of K6 with one scalar row and with a row per pose, and the
    launches of the posed K6 on the matrix."""
    from audiorenderingv2_tpu_torch import constants, multi, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.ops import group_cuda as gc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    log_group_sass()
    budget = 8
    entry = {"highest": {}, "high": {}}
    ico = testing.icosphere(radius=6.0, subdivisions=2)
    for scene_name, mesh, sizes, bands in (
            ("box", testing.box_room(ROOM), (65536, N_RAYS), (1, 4, 8)),
            ("icosphere (320 triangles, 40 groups)", ico, (65536,), (1, 4)),
            ("icosphere (1,280 triangles, 160 groups: the chunked kernel)",
             testing.icosphere(radius=6.0, subdivisions=3), (65536,), (1,))):
        for n_bands in bands:
            sc = _scene_arrays(mesh, n_bands)
            params = _box_params(n_bands)
            coeffs, attrs = rc.pack_tris_group(sc, n_bands)
            rows = rc.pack_tris_rows(sc, n_bands)
            for n in sizes:
                state, scal = _start_state(n, params, n_bands)
                if n == 65536:
                    probe = assert_probe_bar(state[:, :8192].contiguous(),
                                             coeffs, scene_name)
                    log(f"K6 probe, {scene_name}, {n_bands} band(s), 8,192 "
                        f"rays: the tensor-core product within "
                        f"{probe['kernel']:.3f} x 2^-20, the plain 'high' "
                        f"within {probe['plain']:.3f} x 2^-20 of the sum of "
                        f"the terms' magnitudes of the float64 sum; "
                        f"{probe['equal_to_plain']:.4f} of the quantities "
                        f"equal to the plain version's")
                k1 = rc.trace_round(state.clone(), rows, scal, params, budget)
                for precision in ("highest", "high"):
                    what = (f"K6 {precision}, {scene_name}, {n_bands} "
                            f"band(s), {state.shape[1]} rays")
                    kern = gc.trace_round_group(state.clone(), coeffs, attrs,
                                                scal, params, budget,
                                                precision=precision)
                    plain = gc.trace_round_group_plain(
                        state.clone(), coeffs, attrs, scal, params, budget,
                        precision=precision)
                    torch.cuda.synchronize()
                    differ = int((kern != k1).any(dim=0).sum())
                    if precision == "highest":
                        err = _assert_same_bits(kern, plain, what)
                        # the folded product is K1's arithmetic: its bits
                        assert differ == 0, (what, differ)
                        against = "bit-identical to the plain version"
                    else:
                        bar = assert_high_bar(kern, plain, what, k1,
                                              budget)
                        err = float((kern - plain).abs().max())
                        own = bar["plain_vs_f32"]
                        against = (f"against the plain version "
                                   f"{bar['on_path']:.6f} on its path, "
                                   f"{bar['within']:.6f} within "
                                   f"{HIGH_BAR_REL:g}, the worst on its path "
                                   f"{bar['worst_rel']:.2e} (the plain "
                                   f"'high' against K1: {own['on_path']:.6f}"
                                   f", {own['within']:.6f}, "
                                   f"{own['worst_rel']:.2e})")
                        # the rays whose path is K1's: same triangle,
                        # depth, end, receiver entry and ear
                        flags = [rc._C_LTRI, rc._C_DEPTH, rc._C_DONE,
                                 rc._C_RECVD, rc._C_EVE]
                        same = (kern[flags] == k1[flags]).all(dim=0)
                        frac = float(same.float().mean())
                        rel = float(((kern - k1)[:, same].abs()
                                     / k1[:, same].abs().clamp(min=1.0))
                                    .max())
                        assert frac > 0.99 and rel < 1e-2, (what, frac, rel)
                        against += (f"; {frac:.6f} of the rays on K1's "
                                    f"path, those within {rel:.2e} of K1")
                    log(f"{what}, {budget}-bounce round, "
                        f"{coeffs.shape[0] // 48} group(s): {against}; "
                        f"{differ} rays differ from K1 in some bit")
                    if (scene_name, n_bands, n) == ("box", 1, N_RAYS):
                        entry[precision] = _time_group(
                            precision, state, scal, coeffs, attrs, rows,
                            params, budget, kern, err)
        if scene_name == "box":
            params = _box_params(1)
            sc = _scene_arrays(mesh, 1)
            entry["rounds"] = _group_rounds(
                rc.pack_tris_group(sc), rc.pack_tris_rows(sc), params)

    # One scalar row per pose, at the demo matrix's shape.
    p, n_pad = 8, -(-N_RAYS // 128) * 128
    params = _multi_params()
    sc = tracer.scene_to_arrays(_multi_box(1), 128, device=dev)
    coeffs, attrs = rc.pack_tris_group(sc)
    rows = rc.pack_tris_rows(sc)
    em, rcv, yaw = _multi_poses(dev)
    e0 = params.base_power / (N_RAYS * constants.SPHERE_VOLUME)
    state = rc.init_state(_pose_directions(0, p, N_RAYS, dev), em, e0, n_pad)
    scal = rc.scalars(em, rcv, yaw, e0, params)
    k1 = rc.trace_round(state.clone(), rows, scal, params, budget, n_pad)
    posed = {}
    for precision in ("highest", "high"):
        what = f"posed K6 {precision}"
        kern = gc.trace_round_group(state.clone(), coeffs, attrs, scal,
                                    params, budget, n_pad, precision)
        plain = gc.trace_round_group_plain(state.clone(), coeffs, attrs,
                                           scal, params, budget, n_pad,
                                           precision)
        torch.cuda.synchronize()
        if precision == "highest":
            err = _assert_same_bits(kern, plain, what)
            assert torch.equal(kern, k1), f"{what} differs from K1"
        else:
            bar = assert_high_bar(kern, plain, what, k1, budget)
            err = float((kern - plain).abs().max())
        for i in range(p):
            seg = slice(i * n_pad, (i + 1) * n_pad)
            one = gc.trace_round_group(state[:, seg].contiguous(), coeffs,
                                       attrs, scal[i].contiguous(), params,
                                       budget, precision=precision)
            assert torch.equal(one, kern[:, seg]), \
                f"{what}, pose {i} differs from a single-pose launch"
        posed[precision] = _time_group(precision, state, scal, coeffs, attrs,
                                       rows, params, budget, kern, err,
                                       n_pad, reps=3)
        log(f"K6-pose {precision}, the demo's box, {p} poses x {n_pad} rays, "
            f"scal [8, 16], {budget}-bounce round: "
            + ("bit-identical to the plain version and to K1"
               if precision == "highest" else
               f"against the plain version {bar['within']:.6f} within "
               f"{HIGH_BAR_REL:g}, the worst on its path "
               f"{bar['worst_rel']:.2e}")
            + "; per pose equal to single-pose launches")

    # The matrix through K6 against the matrix through K1.
    opts = tracer.TracerOptions(round_budgets=MULTI_BUDGETS, layout="group")
    _reset_launches()
    irs = multi.render_ir_matrix(sc, 0, MULTI_EMITTERS, MULTI_LISTENERS,
                                 MULTI_YAWS, N_RAYS, params, opts,
                                 pair_batch=8)
    launches = _read_launches()
    assert launches["trace_round_group_posed"] == len(MULTI_BUDGETS), launches
    assert launches["trace_round_posed"] == launches["trace_round"] == 0
    rows_irs = multi.render_ir_matrix(
        sc, 0, MULTI_EMITTERS, MULTI_LISTENERS, MULTI_YAWS, N_RAYS, params,
        tracer.TracerOptions(round_budgets=MULTI_BUDGETS), pair_batch=8)
    assert np.isfinite(irs).all() and (irs > 0).sum(axis=-1).min() >= 200
    testing.assert_ir_close(irs.reshape(-1, irs.shape[-1]),
                            rows_irs.reshape(-1, irs.shape[-1]), exact=False)
    group_ms = wall_ms(lambda: multi.render_ir_matrix(
        sc, 0, MULTI_EMITTERS, MULTI_LISTENERS, MULTI_YAWS, N_RAYS, params,
        opts, pair_batch=8), 3)
    log(f"2 x 4 x {N_RAYS}-ray matrix with layout='group': launches "
        f"{launches}; against the rows matrix max abs diff "
        f"{np.abs(irs - rows_irs).max():.3e} (relative L1 "
        f"{np.abs(irs - rows_irs).sum() / np.abs(rows_irs).sum():.3e}); "
        f"{group_ms:.3f} ms (median of 3, host clock)")
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "k1_ms",
            "issued_bound_ms")
    out = {**entry["highest"], "rounds": entry["rounds"],
           "high": {k: entry["high"][k] for k in keep}}
    posed_out = {**posed["highest"],
                 "high": {k: posed["high"][k] for k in keep}}
    return out, posed_out, launches


def _time_group(precision, state, scal, coeffs, attrs, rows, params, budget,
                kern, err, rays_per_pose=None, reps=5) -> dict:
    """K6's, its plain version's and K1's times on ``state``, with the
    bounds of the round ``kern`` ran."""
    from audiorenderingv2_tpu_torch.ops import group_cuda as gc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    ms = median_ms(lambda s: gc.trace_round_group(
        s, coeffs, attrs, scal, params, budget, rays_per_pose, precision),
        reps, setup=lambda: (state.clone(),))
    plain_ms = median_ms(lambda s: gc.trace_round_group_plain(
        s, coeffs, attrs, scal, params, budget, rays_per_pose, precision),
        1 if rays_per_pose else 2, setup=lambda: (state.clone(),))
    k1_ms = median_ms(lambda s: rc.trace_round(s, rows, scal, params, budget,
                                               rays_per_pose), reps,
                      setup=lambda: (state.clone(),))
    n_bands = params.n_bands
    n_valid = int((attrs[:, 3 + n_bands] > 0).sum())
    searches = round_tests(state, kern)
    b = _group_bound(precision, 2 * nbytes(state)
                     + nbytes(coeffs, attrs, scal), searches * n_valid)
    issued = _group_issued_ms(precision, searches * _group_slots(
        attrs, n_bands, precision))
    log(f"K6 {precision}, {state.shape[1]} rays, {budget}-bounce round: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, K1 on the same state "
        f"{k1_ms:.3f} ms; {searches * n_valid:.4g} tests of {n_valid} valid "
        f"triangles, bound {b['bound_ms']:.4f} ms by {b['bound_by']} (K1's, "
        f"{TRI_TEST_OPS} FP32 operations a test: "
        f"{bound(0, searches * n_valid * TRI_TEST_OPS)['bound_ms']:.4f} ms; "
        f"as issued: {issued:.4f} ms)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "k1_ms": k1_ms,
            "k1_bound_ms": bound(0, searches * n_valid
                                 * TRI_TEST_OPS)["bound_ms"],
            "issued_bound_ms": issued}


def _group_rounds(packed, rows, params) -> dict:
    """The box through the group route's rounds (6, 12, 24, 58: the
    schedule of explicit options) with the alive-first partition between
    them, 1,000,064 rays: each round's K6 times at both precisions beside
    K1's on the same state, "highest" bit-identical to K1 and "high" on the
    bar of its plain version."""
    from audiorenderingv2_tpu_torch.ops import group_cuda as gc
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    coeffs, attrs = packed
    state, scal = _start_state(N_RAYS, params)
    out = {}
    for budget in rc._round_schedule(MAX_BOUNCES):
        row = {"budget": budget}
        k1 = rc.trace_round(state.clone(), rows, scal, params, budget)
        row["k1_ms"] = median_ms(lambda s: rc.trace_round(
            s, rows, scal, params, budget), 5, setup=lambda: (state.clone(),))
        for precision in ("highest", "high"):
            kern = gc.trace_round_group(state.clone(), coeffs, attrs, scal,
                                        params, budget, precision=precision)
            torch.cuda.synchronize()
            if precision == "highest":
                assert torch.equal(kern, k1), f"K6 round {budget} differs"
            else:
                plain = gc.trace_round_group_plain(
                    state.clone(), coeffs, attrs, scal, params, budget,
                    precision="high")
                row["high_bar"] = assert_high_bar(
                    kern, plain, f"K6 high, round {budget}", k1, budget)
            row[precision + "_ms"] = median_ms(
                lambda s: gc.trace_round_group(s, coeffs, attrs, scal, params,
                                               budget, precision=precision),
                5, setup=lambda: (state.clone(),))
        searches = round_tests(state, k1)
        n_valid = int((attrs[:, 4] > 0).sum())
        row["bound_ms"] = bound(0, searches * n_valid
                                * TRI_TEST_OPS)["bound_ms"]
        row["high_bound_ms"] = _group_bound("high", 0,
                                            searches * n_valid)["bound_ms"]
        out[f"budget{budget}"] = row
        log(f"K6 on the box's route, round of {budget} bounces "
            f"({int((state[rc._C_DONE] == 0).sum())} rays alive): highest "
            f"{row['highest_ms']:.3f} ms (bit-identical to K1), high "
            f"{row['high_ms']:.3f} ms ({row['high_bar']['within']:.6f} "
            f"within {HIGH_BAR_REL:g} of its plain version, bar "
            f"{row['high_bar']['bar']['within']:.6f}), K1 "
            f"{row['k1_ms']:.3f} ms; bound {row['bound_ms']:.4f} / "
            f"{row['high_bound_ms']:.4f} ms")
        state = rc._partition_alive_first(k1)
    return out


def phase_v1() -> dict:
    """K7 against its plain version and against K1 through version 1's
    rounds; returns its JSON numbers (the box, 1,000,064 rays, budget 6,
    every round's under "budgets", the icosphere's under "icosphere_512",
    the multi-chunk branch's under "multi_chunk")."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import v1_cuda

    params = _box_params()
    schedule = rc._round_schedule(MAX_BOUNCES)
    assert schedule == [6, 12, 24, 58], schedule
    ico = testing.icosphere(radius=6.0, subdivisions=2)
    ico_sc = _scene_arrays(ico, pad_to=512)
    # The icosphere's table with every third of its valid flags zeroed:
    # invalid columns before the last valid one, not only trailing ones.
    mid_valid = ico_sc.valid.clone()
    mid_valid[:320:3] = 0.0
    entry = None
    times = {"budgets": {}, "icosphere_512": {}, "multi_chunk": {}}
    for scene_name, sc, sizes in (
            ("box", _scene_arrays(testing.box_room(ROOM)), (65536, N_RAYS)),
            ("icosphere (320 triangles)", ico_sc, (65536, N_RAYS)),
            ("icosphere, every third valid flag zeroed",
             ico_sc._replace(valid=mid_valid), (65536,)),
            ("icosphere (1,280 triangles, multi-chunk)",
             _scene_arrays(testing.icosphere(radius=6.0, subdivisions=3)),
             (65536,))):
        tris = rc.pack_tris_v1(sc)
        rows = rc.pack_tris_rows(sc)
        branch = v1_cuda.v1_branch(tris.shape[1])
        assert branch == ("multi_chunk" if "multi" in scene_name
                          else "one_chunk"), (scene_name, branch)
        for n in sizes:
            state, scal = _start_state(n, params)
            state_rows = state.T.contiguous()
            for budget in schedule:
                what = (f"K7, {scene_name}, {tris.shape[1]} columns "
                        f"({branch}), {state.shape[1]} rays, budget {budget}")
                kern = v1_cuda.trace_round_v1(state_rows.clone(), tris, scal,
                                              params, budget)
                plain = v1_cuda.trace_round_v1_plain(
                    state_rows.clone(), tris, scal, params, budget)
                k1 = rc.trace_round(state.clone(), rows, scal, params, budget)
                torch.cuda.synchronize()
                err = _assert_same_bits(kern.T, plain.T, what)
                assert not kern[:, 13:].any(), f"{what}: columns 13-15"
                assert torch.equal(kern[:, :13], k1[:13].T), \
                    f"{what}: columns 0-12 differ from K1's"
                msg = (f"{what}: bit-identical to the plain version; columns "
                       f"13-15 zero; columns 0-12 bit-identical to K1's")
                if n == N_RAYS or "multi" in scene_name:
                    ms = median_ms(lambda s: v1_cuda.trace_round_v1(
                        s, tris, scal, params, budget), 5,
                        setup=lambda: (state_rows.clone(),))
                    k1_ms = median_ms(lambda s: rc.trace_round(
                        s, rows, scal, params, budget), 5,
                        setup=lambda: (state.clone(),))
                    n_valid = int((tris[16] > 0).sum())
                    searches = round_tests(state, k1)
                    b = bound(2 * nbytes(state_rows) + nbytes(tris, scal),
                              searches * n_valid * TRI_TEST_OPS)
                    padded = bound(0, searches * tris.shape[1]
                                   * TRI_TEST_OPS)["bound_ms"]
                    t = {"ms": ms, "k1_ms": k1_ms, **b,
                         "padded_bound_ms": padded,
                         "alive": int((state[rc._C_DONE] == 0).sum())}
                    key = str(budget)
                    if scene_name == "box":
                        times["budgets"][key] = t
                    elif "multi" in scene_name:
                        times["multi_chunk"][key] = t
                    else:
                        times["icosphere_512"][key] = t
                    msg += (f"; kernel {ms:.3f} ms, K1 over {rows.shape[0]} "
                            f"rows {k1_ms:.3f} ms; {searches * n_valid:.4g} "
                            f"tests of the {n_valid} valid triangles, bound "
                            f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
                            f"(over all {tris.shape[1]} columns: "
                            f"{padded:.4f} ms)")
                    if (scene_name, n, budget) == ("box", N_RAYS, 6):
                        plain_ms = median_ms(
                            lambda s: v1_cuda.trace_round_v1_plain(
                                s, tris, scal, params, budget), 2,
                            setup=lambda: (state_rows.clone(),))
                        msg += f"; plain {plain_ms:.3f} ms"
                        entry = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, **b,
                                 "library_ms": None, "k1_ms": k1_ms,
                                 "padded_bound_ms": padded}
                log(msg)
                # the next round starts from this one's state, partitioned
                # alive first as the version-1 rounds do
                state_rows = rc._partition_alive_first(kern, ray_dim=0)
                state = state_rows.T.contiguous()
    return {**entry, **times}


def phase_experimentation() -> dict:
    """The CLI's experimentation mode on the box with default options, with
    the group layout (at both precisions) and with version 1; returns the
    launches of each run."""
    import contextlib
    import io

    from audiorenderingv2_tpu_torch import cli, context, experiment, testing
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer

    rounds = 10
    routes = {"default": ([], None),
              "group": (["--layout", "group"], TracerOptions(layout="group")),
              "group_high": (["--layout", "group", "--precision", "high"],
                             TracerOptions(layout="group", precision="high")),
              "v1": (["--kernel-version", "1"], TracerOptions(version=1))}
    launches, irs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        testing.write_box_obj(Path(tmp) / "room.obj", ROOM, material="walls")
        cfg = _write_inputs(Path(tmp))
        for name, (flags, opts) in routes.items():
            out = io.StringIO()
            _reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc_ = cli.main([str(cfg), "experimentation", "--rounds",
                                str(rounds), *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = _read_launches()
            lines = out.getvalue().strip().splitlines()
            assert rc_ == 0 and len(lines) == 10, out.getvalue()
            assert lines[0] == f"rounds: {rounds}"
            values = [float(x.split(":")[1].split()[0]) for x in lines[1:]]
            assert np.isfinite(values).all() and min(values[:8]) > 0, lines
            log(f"experimentation, {name} options ({N_RAYS} rays, "
                f"{MAX_BOUNCES} bounces, {wall:.2f} s wall); launches "
                f"{launches[name]}:")
            for line in lines:
                log(f"  {line}")
            # Round 0's IR of this route, from the generator the mode gave
            # that round.
            ctx = context.load_context(cfg, opts=opts, device="cuda")
            ctx.renderer.set_receiver(ctx.receiver_pos, ctx.receiver_yaw_deg)
            irs[name] = ctx.renderer.render(
                experiment.round_generator(0, 0, "cuda")).copy()
    renders = rounds + 1  # one warm-up
    d, v = launches["default"], launches["v1"]
    assert d["trace_round"] == 3 * renders, d
    assert d["histogram_binned"] == renders, d
    assert d["trace_round_group"] == d["trace_round_v1"] == 0, d
    # explicit options take the default schedule (6, 12, 24, 58)
    for g in (launches["group"], launches["group_high"]):
        assert g["trace_round_group"] == 4 * renders, g
        assert g["trace_round"] == 0, g
        assert g["histogram_binned"] == renders, g
    assert v["trace_round_v1"] == 4 * renders and v["trace_round"] == 0, v
    assert v["histogram_binned"] == renders
    base = irs["default"]
    assert base.shape == (2, IR_SECONDS * SR) and np.isfinite(base).all()
    assert np.all((base > 0).sum(axis=1) >= 200)
    for name in ("group", "group_high", "v1"):
        testing.assert_ir_close(irs[name], base, exact=False)
        log(f"experimentation, round 0's IR with {name} options against the "
            f"default route's: passes assert_ir_close(exact=False); per-ear "
            f"energy {irs[name].sum(axis=1).tolist()} / "
            f"{base.sum(axis=1).tolist()}, relative L1 "
            f"{np.abs(irs[name] - base).sum() / np.abs(base).sum():.3e}")

    # K4 then K6: a native_rng render with the group layout against the
    # same seed through the rows.
    def native(layout: str) -> AudioRenderer:
        r = AudioRenderer(_box_scene(), IR_SECONDS, SR, N_RAYS,
                          base_power=3.62, max_bounces=MAX_BOUNCES,
                          hrtf_absorption_rate=0.9, seed=0, device="cuda",
                          opts=TracerOptions(native_rng=True, layout=layout))
        r.set_emitter_pos(EMITTER)
        r.set_receiver(RECEIVER, 0.0)
        return r

    _reset_launches()
    ir_g = native("group").render().copy()
    nl = _read_launches()
    assert nl["init_state"] == 1 and nl["trace_round_group"] == 4, nl
    assert nl["trace_round"] == 0, nl
    ir_r = native("rows").render().copy()
    testing.assert_ir_close(ir_g, ir_r, exact=False)
    log(f"native_rng render with the group layout (K4 then K6): launches "
        f"{nl}; against the rows render of the same seed relative L1 "
        f"{np.abs(ir_g - ir_r).sum() / np.abs(ir_r).sum():.3e}")
    return launches


# The live path of phase 21: blocks of 512 frames (32 ms at 16 kHz), paced
# at that period like an audio callback, a re-render requested every 20.
LIVE_BLOCK = 512
LIVE_BLOCKS = 60
LIVE_RERENDER_EVERY = 20
LIVE_BAR = 1e-5          # relative L2 of a live block, card against the CPU
STATS_DIFFER_SHARE = 5e-3  # bounce counts: sorted positions that may differ


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _expected_renders(cfg: Path) -> list:
    """The poses at which the main mode re-renders, from its trajectory and
    policy run on the host alone (both deterministic): the Auralizer's walk
    in 0.25 s chunks of the 5 s signal."""
    from audiorenderingv2_tpu_torch import cli, config, streaming

    c = config.load_config(cfg)
    traj = streaming.ListenerTrajectory(cli.default_trajectory(
        c.scene.initial_receiver_pos, c.scene.initial_emitter_pos, 5.0))
    policy = streaming.ReRenderPolicy(
        distance_threshold=c.renderer.re_render_distance_threshold,
        angle_threshold=c.renderer.re_render_angle_threshold)
    poses = []
    for start in range(0, 5 * SR, int(round(0.25 * SR))):
        pos, yaw = traj.at(start / SR)
        if policy.should_render(start / SR, pos, yaw):  # fires first
            poses.append(([float(x) for x in pos], float(yaw)))
    return poses


def _card_against_cpu(r, scene, receiver, yaw, what: str) -> dict:
    """65,536 shared directions through ``trace_ir(with_stats=True)`` on the
    card and on the CPU plain path at one pose: the IRs on the export's bar
    (assert_ir_close(exact=False)); the bounce counts with sums within 1e-3
    relative and at most STATS_DIFFER_SHARE of the sorted positions
    differing (a grazing hit sends a ray another way, here as between any
    two float orders). Returns the counts' comparison."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.core import tracer

    d = unit_dirs(65536, 21)
    args = (r.emitter_pos, np.asarray(receiver, np.float32), yaw, r.params,
            r.opts)
    ir_gpu, st_gpu = tracer.trace_ir(r.sc, torch.from_numpy(d).cuda(), *args,
                                     with_stats=True)
    ir_cpu, st_cpu = tracer.trace_ir(tracer.scene_to_arrays(scene,
                                                            device="cpu"),
                                     torch.from_numpy(d), *args,
                                     with_stats=True)
    testing.assert_ir_close(ir_gpu.cpu().numpy(), ir_cpu.numpy(),
                            exact=False)
    a = np.sort(st_gpu["bounces"].cpu().numpy())
    b = np.sort(st_cpu["bounces"].numpy())
    differ = int((a != b).sum())
    sums = (float(a.astype(np.float64).sum()), float(b.astype(np.float64)
                                                     .sum()))
    assert a.shape == b.shape == (65536,), (a.shape, b.shape)
    assert abs(sums[0] - sums[1]) <= 1e-3 * sums[1], sums
    assert differ <= STATS_DIFFER_SHARE * a.size, differ
    log(f"{what}: 65536 shared directions, card against the CPU plain path: "
        f"IR passes assert_ir_close(exact=False); bounce sums {sums[0]:.0f} "
        f"/ {sums[1]:.0f}, sorted counts differing at {differ} of 65536 "
        f"positions (bar {STATS_DIFFER_SHARE:.1%}, sums within 1e-3)")
    return {"sum_card": sums[0], "sum_cpu": sums[1], "differ": differ}


def _live_block_check(r, block: np.ndarray, what: str) -> float:
    """One live block through ``convolve_live_input`` on the card against
    ``convolve_live`` (or ``convolve_live_banded``) on the CPU with the same
    IR copied to the host: relative L2 of the interleaved output."""
    from audiorenderingv2_tpu_torch import streaming
    from audiorenderingv2_tpu_torch.ops import convolve, filterbank

    n = r.params.ir_length
    ring = streaming.RingBuffer(2 * n + 1)
    r.convolve_live_input(block, ring)
    got = ring.get_and_reset(2 * n)
    ir = r.ir_device.cpu()
    padded = torch.nn.functional.pad(torch.from_numpy(block),
                                     (0, n - block.shape[0]))
    if ir.dim() == 3:
        out = filterbank.convolve_live_banded(padded, ir, r.params.sample_rate,
                                              r.band_edges)
    else:
        out = convolve.convolve_live(padded, ir)
    want = convolve.interleave_stereo(out[0], out[1]).double().numpy()
    rel = _rel_l2(got, want)
    assert rel <= LIVE_BAR, (what, rel)
    ring2 = streaming.RingBuffer(2 * n + 1)
    ms = median_ms(lambda: r.convolve_live_input(block, ring2), 20)
    log(f"{what}: one {block.shape[0]}-frame live block through "
        f"convolve_live_input on the card against the CPU on the same IR: "
        f"relative L2 {rel:.3e} (bar {LIVE_BAR:.0e}); {ms:.3f} ms a block "
        f"(median of 20, the host copy included)")
    return rel


def _live_duplex(name: str, r, poses, tmp: Path) -> dict:
    """The live path on the card: an AsyncRenderWorker re-rendering while a
    LiveConvolver streams LIVE_BLOCKS blocks into the native engine, paced
    at the block period; a re-render requested every LIVE_RERENDER_EVERY
    blocks. Returns its launches, renders, silenced blocks and latency."""
    from audiorenderingv2_tpu_torch import native, streaming
    from audiorenderingv2_tpu_torch.utils import logging as arlog

    r.render()
    period = LIVE_BLOCK / SR
    mic = (0.1 * np.random.default_rng(3).standard_normal(
        LIVE_BLOCK * LIVE_BLOCKS)).astype(np.float32)
    engine = native.NativeAudioEngine(
        str(tmp / f"{name}.f64"), ring_capacity=1 << 20, sample_rate=SR,
        channels=2, frames_per_buffer=256, realtime=False)
    log_path = tmp / f"{name}_live.jsonl"
    arlog.configure(path=str(log_path))
    worker = streaming.AsyncRenderWorker(r, samples=None)
    conv = streaming.LiveConvolver(r, volume=1.0, render_guard=worker)
    lat, marks, outs = [], [], []
    _reset_launches()
    try:
        t_next = time.perf_counter()
        for i in range(LIVE_BLOCKS):
            if i % LIVE_RERENDER_EVERY == LIVE_RERENDER_EVERY // 2:
                marks.append(conv.silenced_blocks)
                worker.request(*poses[len(marks) % len(poses)])
            before = conv.silenced_blocks
            t0 = time.perf_counter()
            out = conv.process_block(mic[i * LIVE_BLOCK:(i + 1) * LIVE_BLOCK])
            lat.append((time.perf_counter() - t0) * 1e3)
            assert out.shape == (2 * LIVE_BLOCK,) and np.isfinite(out).all()
            if conv.silenced_blocks > before:
                assert not out.any(), "a silenced block carried sound"
            outs.append(out)
            engine.add(out)
            engine.drain_ticks(LIVE_BLOCK // 256)
            t_next += period
            time.sleep(max(0.0, t_next - time.perf_counter()))
        worker.wait_idle(timeout=300)
        torch.cuda.synchronize()
        launches = _read_launches()
        renders = worker.renders
        underruns, streamed = engine.underruns, engine.frames_streamed
    finally:
        worker.close()
        engine.close()
        arlog.configure()
    silenced = np.diff(marks + [conv.silenced_blocks]).tolist()
    inter = np.concatenate(outs)
    assert renders >= 2, renders
    assert (inter != 0).any()
    assert underruns <= conv.silenced_blocks * (LIVE_BLOCK // 256), \
        (underruns, conv.silenced_blocks)
    assert streamed == LIVE_BLOCKS * LIVE_BLOCK, streamed
    recs = [json.loads(x) for x in log_path.read_text().splitlines()]
    render_ms = [x["render_ms"] for x in recs if x["event"] == "live_rerender"]
    assert len(render_ms) == renders, (render_ms, renders)
    log(f"live duplex, {name} ({r.n_rays} rays, {r.params.max_bounces} "
        f"bounces): {LIVE_BLOCKS} blocks of {LIVE_BLOCK} frames paced at "
        f"{period * 1e3:.1f} ms; block latency median "
        f"{np.median(lat):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, max "
        f"{max(lat):.3f} ms against the {period * 1e3:.1f} ms period; "
        f"{renders} re-renders on the worker thread, render_ms {render_ms}; "
        f"blocks silenced for each re-render {silenced}; engine underruns "
        f"{underruns} (<= silenced x {LIVE_BLOCK // 256} ticks), "
        f"{streamed} frames streamed; launches {launches}")
    return {"launches": launches, "renders": renders, "silenced": silenced,
            "lat_median_ms": float(np.median(lat)),
            "lat_p99_ms": float(np.percentile(lat, 99))}


def phase_main_mode() -> dict:
    """The reference's default application on the card: the CLI's main mode
    on the box config, the live duplex path on the box and the office,
    convolve_live_banded, and render_ir(with_stats=True). Returns the
    launches of the main mode and of the two live runs."""
    from audiorenderingv2_tpu_torch import cli, context, testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.io import wav
    from audiorenderingv2_tpu_torch.renderer import AudioRenderer
    from audiorenderingv2_tpu_torch.utils import logging as arlog

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        testing.write_box_obj(tmp / "room.obj", ROOM, material="walls")
        cfg = _write_inputs(tmp)

        # 1. The main mode as a user runs it, its renders logged.
        out_path, log_path = tmp / "main.wav", tmp / "main.jsonl"
        arlog.configure(path=str(log_path))
        _reset_launches()
        t0 = time.perf_counter()
        try:
            code = cli.main([str(cfg), "main", str(out_path), "--device",
                             "cuda"])
            torch.cuda.synchronize()
        finally:
            arlog.configure()
        wall = time.perf_counter() - t0
        launches = result["main"] = _read_launches()
        assert code == 0, code
        assert launches["trace_round"] > 0, launches
        assert launches["histogram_binned"] > 0, launches
        audio = wav.read_wav(out_path)
        assert audio.n_channels == 2 and audio.sample_rate == SR
        assert audio.n_frames == 5 * SR and np.isfinite(audio.samples).all()
        peak = float(np.abs(audio.samples).max())
        assert abs(peak - 1.0) < 1e-3, peak
        cycles = [json.loads(x) for x in log_path.read_text().splitlines()]
        cycles = [x for x in cycles if x["event"] == "full_render_cycle"]
        expected = _expected_renders(cfg)
        got = [(x["receiver"], x["yaw_deg"]) for x in cycles]
        assert len(got) == len(expected), (len(got), len(expected))
        for (gp, gy), (ep, ey) in zip(got, expected):
            assert np.allclose(gp, ep, atol=1e-6) and abs(gy - ey) < 1e-6, \
                (gp, gy, ep, ey)
        assert launches["trace_round"] == 3 * len(cycles), launches
        assert launches["histogram_binned"] == len(cycles), launches
        render_ms = [x["render_ms"] for x in cycles]
        conv_ms = [x["convolve_ms"] for x in cycles]
        log(f"main mode ({N_RAYS} rays, {MAX_BOUNCES} bounces, 5 s signal, "
            f"the 9-key half orbit): {wall:.2f} s wall (scene load and first "
            f"call included); {len(cycles)} renders at the poses the policy "
            f"gives on the host alone; full_render_cycle median render_ms "
            f"{np.median(render_ms):.3f} (all {render_ms}), convolve_ms "
            f"{np.median(conv_ms):.3f}; WAV stereo {SR} Hz, "
            f"{audio.n_frames} frames, peak {peak}; launches {launches}")

        # The card against the CPU at the first and last rendered poses.
        ctx = context.load_context(cfg, device="cuda")
        r = ctx.renderer
        for k, (pos, yaw) in ((0, got[0]), (-1, got[-1])):
            stats = _card_against_cpu(r, ctx.scene, pos, yaw,
                                      f"main mode, render {k % len(got)}")
        result["stats_check"] = stats

        # 2. The live duplex path: the box, then the office.
        box_poses = [(RECEIVER, 0.0), ((-2.5, 1.5, -2.0), 45.0),
                     ((3.0, 0.5, -3.0), 120.0)]
        r.set_receiver(RECEIVER, 0.0)
        r.render()
        block = (0.1 * np.random.default_rng(4).standard_normal(
            LIVE_BLOCK)).astype(np.float32)
        _live_block_check(r, block, "live block, box")
        result["live_box"] = _live_duplex("box", r, box_poses, tmp)
        office = AudioRenderer(
            testing.office_scene(OFFICE_TRIS), IR_SECONDS, SR, N_RAYS,
            base_power=3.62, max_bounces=OFFICE_BOUNCES,
            hrtf_absorption_rate=0.9, device="cuda")
        office.set_emitter_pos(EMITTER)
        office.set_receiver(OFFICE_RECEIVER, 0.0)
        office_poses = [(tuple(p), 30.0 * i)
                        for i, p in enumerate(OFFICE_LISTENERS[:3])]
        result["live_office"] = _live_duplex("office", office, office_poses,
                                             tmp)
        lb, lo = result["live_box"]["launches"], result["live_office"][
            "launches"]
        assert lb["trace_round"] == 3 * result["live_box"]["renders"], lb
        assert lb["histogram_binned"] == result["live_box"]["renders"], lb
        assert lo["trace_round"] == 0, lo
        assert lo["trace_round_sched"] == OFFICE_BOUNCES * \
            result["live_office"]["renders"], lo
        assert lo["tile_schedule"] == lo["trace_round_sched"], lo

        # 3. convolve_live_banded: the 4-band box of phase 12.
        band_dir = tmp / "banded"
        band_dir.mkdir()
        testing.write_box_obj(band_dir / "room.obj", ROOM, material="walls")
        banded = context.load_context(
            _write_inputs(band_dir, absorption=list(BANDED_ABSORPTION)),
            device="cuda").renderer
        assert banded.render().shape == (2, len(BANDED_ABSORPTION),
                                         IR_SECONDS * SR)
        result["banded_rel"] = _live_block_check(
            banded, block, "live block, 4-band box (convolve_live_banded)")

        # 4. render_ir(with_stats=True) at full width, box and office.
        for name, rr in (("box", r), ("office", office)):
            def run(rr=rr):
                return tracer.render_ir(
                    rr.sc, rr.generator, rr.n_rays, rr.emitter_pos,
                    rr.receiver_pos, rr.receiver_yaw_deg, rr.params,
                    rr.opts, rows=rr.rows, boxes=rr.boxes, with_stats=True)
            ir, stats = run()
            b = stats["bounces"]
            assert b.shape[0] == -(-rr.n_rays // 128) * 128, b.shape
            total = float(b.double().sum())
            assert torch.isfinite(ir).all() and total > rr.n_rays
            assert float(b.max()) <= rr.params.max_bounces
            ms = median_ms(run, 3)
            result[f"stats_{name}"] = {"bounces": total, "ms": ms}
            log(f"render_ir(with_stats=True), {name} ({rr.n_rays} rays, "
                f"{rr.params.max_bounces} bounces): bounce sum {total:.0f} "
                f"({total / rr.n_rays:.2f} a ray); {ms:.3f} ms (CUDA events, "
                f"median of 3): {rr.n_rays / ms * 1e3:.4e} rays/s, "
                f"{total / ms * 1e3:.4e} bounces/s")
    return result


# ------------------------------------------------------------ phase 22

SHARDED_SEED = 0
CONV_SECONDS = 16
CONV_BAR = 1e-5         # relative L2, sharded against single-process
DRY_GRAD_BAR = 1e-4     # relative, the sharded step's gradient
GLOO_DIRS = 1_000_064
RANK_TIMEOUT_S = 300
# The rays of a recorded launch that LaunchRecorder keeps to replay on the
# plain version: a K1 launch's first 1,000,064 (the export's ray count; the
# plain version needs [64, N] intermediates a chunk of rows), the
# schedule's and K2's first 65,536 (as office_trace_check).
REPLAY_K1_RAYS = 1_000_064
REPLAY_SCHED_RAYS = 65_536


def _events_bar(irs: dict, ev, params, what: str, pose: int = 0) -> dict:
    """Each IR [2, ir_length] of ``irs`` against the float64 sum of the
    deposits of pose ``pose`` of the events ``ev`` (the hard-binning
    entry's inputs, [P, E], as :class:`LaunchRecorder` kept them), on
    binned_check's bar (1e-4 a bin, the atomics' order; f32's smallest
    normal a subnormal deposit; no stray bin). Returns each IR's worst
    relative error."""
    rows, w64 = binned_deposits64(*(x[pose:pose + 1] for x in ev), params)
    n_rows = 2 * params.ir_length
    ref = torch.zeros((n_rows, 1), dtype=torch.float64,
                      device=w64.device).index_add_(0, rows, w64)
    n_sub = subnormal_counts(rows, w64, ref.shape)
    return {name: _assert_deposit_bar(ir.reshape(n_rows, 1), ref, n_sub,
                                      f"{what}, {name}")
            for name, ir in irs.items()}


def _ray_columns(n_poses: int, rays_per_pose: int, budget: int, device):
    """The first rays of each pose of a launch, at most ``budget`` in all
    (whole tiles of 128 when there are several poses): (the columns, a
    slice or an index tensor; the rays a pose keeps)."""
    if n_poses == 1:
        m = min(rays_per_pose, budget)
        return slice(0, m), m
    m = min(rays_per_pose, budget // n_poses // 128 * 128)
    cols = (torch.arange(n_poses, device=device)[:, None] * rays_per_pose
            + torch.arange(m, device=device)[None, :]).reshape(-1)
    return cols, m


class LaunchRecorder:
    """Inside ``with``, every launch through the wrappers of K1 (and
    K1-pose), the schedule, K2, K3, K3-bwd, the hard-binning entry, the
    key kernel and the band split keeps a copy of its inputs and of its
    result, so that
    :meth:`check` can hold each kernel to its plain version on what the
    product's own launch was given, after the product's run and outside its
    counts. Rays are independent in K1, the schedule and K2, so a launch of
    those keeps the first rays of each pose (REPLAY_K1_RAYS,
    REPLAY_SCHED_RAYS in all); the keys depend on every ray's position, so
    a call of the key kernel keeps the seven columns they read, whole, and
    a band split its spectrum, whole."""

    def __init__(self):
        self.records = []   # (launch counter's name, inputs, result)

    def __enter__(self):
        from audiorenderingv2_tpu_torch.ops import filterbank as fb
        from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
        from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
        from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

        self._patched = [(rc, "trace_round", self._k1),
                         (sc, "tile_schedule", self._schedule),
                         (sc, "trace_round_sched", self._k2),
                         (hc, "histogram_sum_banded", self._k3),
                         (hc, "histogram_bwd", self._k3_bwd),
                         (hc, "histogram_binned", self._binned),
                         (rc, "compaction_keys", self._keys),
                         (fb, "band_spectra", self._band_split)]
        self._orig = {}
        for mod, name, wrap in self._patched:
            self._orig[name] = getattr(mod, name)
            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc) -> bool:
        for mod, name, _ in self._patched:
            setattr(mod, name, self._orig[name])
        return False

    def _k1(self, state, tris, scal, params, budget, rays_per_pose=None):
        from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

        p, rpp = rc.check_poses(state, scal, rays_per_pose)
        cols, m = _ray_columns(p, rpp, REPLAY_K1_RAYS, state.device)
        before = state[:, cols].clone()
        out = self._orig["trace_round"](state, tris, scal, params, budget,
                                        rays_per_pose)
        name = "trace_round_posed" if scal.dim() == 2 else "trace_round"
        self.records.append((name, (before, tris, scal, params, budget,
                                    m if p > 1 else None),
                             out[:, cols].clone()))
        return out

    def _schedule(self, state, boxes):
        m = min(state.shape[1], REPLAY_SCHED_RAYS)
        before = state[:, :m].clone()
        out = self._orig["tile_schedule"](state, boxes)
        self.records.append(("tile_schedule", (before, boxes),
                             out[:m // 128].clone()))
        return out

    def _k2(self, state, rows, boxes, sched, scal, params,
            rays_per_pose=None, visits=None):
        from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

        p, rpp = rc.check_poses(state, scal, rays_per_pose)
        cols, m = _ray_columns(p, rpp, REPLAY_SCHED_RAYS, state.device)
        tiles = (slice(0, m // 128) if p == 1
                 else cols.view(-1, 128)[:, 0] // 128)
        before, sched_part = state[:, cols].clone(), sched[tiles].clone()
        out = self._orig["trace_round_sched"](state, rows, boxes, sched,
                                              scal, params, rays_per_pose,
                                              visits)
        name = ("trace_round_sched_posed" if scal.dim() == 2
                else "trace_round_sched")
        self.records.append((name, (before, rows, boxes, sched_part, scal,
                                    params, m if p > 1 else None),
                             out[:, cols].clone()))
        return out

    def _k3(self, bins, weights, n_bins):
        out = self._orig["histogram_sum_banded"](bins, weights, n_bins)
        self.records.append(("histogram", (bins.clone(),
                                           weights.detach().clone(), n_bins),
                             out.clone()))
        return out

    def _k3_bwd(self, bins, g):
        out = self._orig["histogram_bwd"](bins, g)
        self.records.append(("histogram_bwd", (bins.clone(), g.clone()),
                             out.clone()))
        return out

    def _binned(self, ev_bin_f, ev_w, ev_ear, *stage):
        out = self._orig["histogram_binned"](ev_bin_f, ev_w, ev_ear, *stage)
        self.records.append(("histogram_binned", (
            ev_bin_f.clone(), ev_w.clone(), ev_ear.clone(), *stage),
            out.clone()))
        return out

    def _keys(self, state, cell_bits=None, n_poses=1):
        from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

        cell_bits = rc.CELL_BITS if cell_bits is None else cell_bits
        cols = torch.zeros((16, state.shape[1]), dtype=torch.float32,
                           device=state.device)
        read = [*range(rc._C_PX, rc._C_VZ + 1), rc._C_DONE]
        cols[read] = state[read]
        out = self._orig["compaction_keys"](state, cell_bits, n_poses)
        self.records.append(("compaction_keys", (cols, cell_bits, n_poses),
                             out.clone()))
        return out

    def _band_split(self, spec, sample_rate, edges=None):
        from audiorenderingv2_tpu_torch.ops import filterbank as fb

        edges = fb.DEFAULT_BAND_EDGES if edges is None else tuple(edges)
        out = self._orig["band_spectra"](spec, sample_rate, edges)
        self.records.append(("band_split", (spec.clone(), sample_rate,
                                            edges), out.clone()))
        return out

    def binned_events(self, k: int = -1):
        """The events [P, E] of the ``k``-th hard-binning launch."""
        return [r for r in self.records
                if r[0] == "histogram_binned"][k][1][:3]

    def check(self, what: str) -> dict:
        """Every recorded launch against its plain version on its own
        inputs: K1, K1-pose and K2 bit for bit in every column of the rays
        kept, the schedule and the keys integer for integer, K3-bwd bit for
        bit, the band split by :func:`_assert_band_spectra`; K3 and
        the hard-binning entry each within binned_check's bar of the
        float64 sum of their deposits (the atomics add in their own order),
        and so is the plain version. Returns, per launch counter's name,
        the launches held, the rays or events they covered and the largest
        absolute difference from the plain version."""
        from types import SimpleNamespace

        from audiorenderingv2_tpu_torch.ops import filterbank as fb
        from audiorenderingv2_tpu_torch.ops import histogram_cuda as hc
        from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
        from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

        held = {}
        for k, (name, args, out) in enumerate(self.records):
            where = f"{what}, {name} launch {k + 1}"
            if name.startswith("trace_round_sched"):
                plain = sc.trace_round_sched_plain(args[0].clone(), *args[1:])
            elif name.startswith("trace_round"):
                plain = rc.trace_round_plain(args[0].clone(), *args[1:])
            elif name == "tile_schedule":
                plain = sc.tile_schedule_plain(*args)
            elif name == "compaction_keys":
                plain = rc._compaction_keys(*args)
            elif name == "histogram_bwd":
                plain = hc.histogram_bwd_plain(*args)
            elif name == "band_split":
                plain = _band_spectra_plain(*args)
            elif name == "histogram":
                bins, w, n_bins = args
                plain = hc.histogram_plain(bins, w, n_bins)
                keep = (bins >= 0) & (bins < n_bins)
                rows, w64 = bins[keep].long(), w[keep].double()
                ref = torch.zeros(out.shape, dtype=torch.float64,
                                  device=out.device).index_add_(0, rows, w64)
            else:  # the hard-binning entry
                ev, stage = args[:3], args[3:]
                plain = hc.histogram_binned_plain(*args)
                rows, w64 = binned_deposits64(*ev, SimpleNamespace(
                    ir_length=stage[0], is_mono=stage[1],
                    cross_ear_delay=stage[2],
                    hrtf_absorption_rate=stage[3]))
                out = out.reshape(-1, out.shape[-1])
                plain = plain.reshape(out.shape)
                ref = torch.zeros(out.shape, dtype=torch.float64,
                                  device=out.device).index_add_(0, rows, w64)
            torch.cuda.synchronize()
            if name in ("histogram", "histogram_binned"):
                n_sub = subnormal_counts(rows, w64, ref.shape)
                _assert_deposit_bar(out, ref, n_sub, where)
                _assert_deposit_bar(plain, ref, n_sub, f"{where}, plain")
                size = int(args[0].numel())
            elif name == "band_split":
                _assert_band_spectra(out, plain, args[0], where)
                size = int(args[0].numel())
            elif name in ("tile_schedule", "histogram_bwd",
                          "compaction_keys"):
                assert torch.equal(out, plain), f"{where}: differs from plain"
                size = int(args[0].numel() if name == "histogram_bwd"
                           else args[0].shape[1])
            else:
                _assert_same_bits(out, plain, where)
                size = int(out.shape[1])
            row = held.setdefault(name, {"launches": 0, "size": 0,
                                         "max_abs_err": 0.0})
            row["launches"] += 1
            row["size"] += size
            row["max_abs_err"] = max(row["max_abs_err"], float(
                (out - plain).abs().max() if out.is_complex()
                else (out.float() - plain.float()).abs().max()))
        log(f"{what}: each launch held to its plain version on its own "
            f"inputs (size: the rays kept, or the events): {held}")
        return held


def phase_sharded_nccl() -> dict:
    """Phase 22 (a): the multi-GPU path as a world of one under NCCL, each
    kernel that its product calls launch held to its plain version on the
    launch's own inputs (:class:`LaunchRecorder`). Returns its numbers and
    the launches of its product calls, kernel by kernel."""
    import torch.distributed as dist

    from audiorenderingv2_tpu_torch import dryrun, multi
    from audiorenderingv2_tpu_torch.core import sampling, tracer
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.examples import demo_5_sharded as demo5
    from audiorenderingv2_tpu_torch.ops import convolve
    from audiorenderingv2_tpu_torch.parallel import (convolve_file_sharded,
                                                     make_ray_mesh,
                                                     make_segment_mesh,
                                                     render_ir_sharded)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}",
        world_size=1, rank=0)
    total = dict.fromkeys(_read_launches(), 0)
    held = {}

    def driven(fn, what: str):
        """``fn()`` once, its launches counted (the product's run) and
        recorded, then each launch held to its plain version."""
        before = _read_launches()
        with LaunchRecorder() as rec:
            out = fn()
            torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in _read_launches().items()}
        for k, v in delta.items():
            total[k] += v
        for k, row in rec.check(what).items():
            acc = held.setdefault(k, {"launches": 0, "size": 0,
                                      "max_abs_err": 0.0})
            acc["launches"] += row["launches"]
            acc["size"] += row["size"]
            acc["max_abs_err"] = max(acc["max_abs_err"], row["max_abs_err"])
        return out, delta, rec

    try:
        mesh = make_ray_mesh()
        assert dist.get_backend() == "nccl", dist.get_backend()
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, dev), mesh
        log(f"sharded, NCCL world of 1: process group up in "
            f"{time.perf_counter() - t0:.2f} s; mesh {mesh}")

        # Demo 5 as a user runs it (examples/demo_5_sharded.py's main): its
        # room at its own size, render_ir_sharded of 16M rays x 8 bounces,
        # then the 2 x 2 matrix with mesh= at 1M rays a pair. First the
        # render alone, timed; the peak memory of the timed runs, before
        # any recording.
        sc, rows, params, opts = demo5.setup(dev)
        em, rc_pos, n5 = demo5.EMITTER, demo5.RECEIVER, demo5.total_rays(dev)
        args = (sc, demo5.SEED, n5, em, rc_pos, demo5.YAW, params, opts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        render_ir_sharded(*args, mesh=mesh, rows=rows)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        torch.cuda.reset_peak_memory_stats()
        sharded_ms = median_ms(lambda: render_ir_sharded(
            *args, mesh=mesh, rows=rows), 3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        res5, l5, rec = driven(lambda: demo5.main(dev, mesh=mesh),
                               "demo 5, demo_5_sharded.main")
        n_rounds = len(opts.round_budgets)
        assert l5["trace_round"] == l5["trace_round_posed"] == n_rounds, l5
        assert l5["histogram_binned"] == 2 and l5["histogram"] == 0, l5
        assert (res5["world"], res5["n_rays"]) == (1, n5), res5["n_rays"]
        ir_sh, irs, pair_rays = res5["ir"], res5["irs"], res5["pair_rays"]

        def single_demo5():
            return tracer.render_ir(
                sc, sampling.pose_generator(demo5.SEED, 0, dev), n5, em,
                rc_pos, demo5.YAW, params, opts, n_total_rays=n5, rows=rows)
        single = single_demo5()
        single_ms = median_ms(single_demo5, 3)
        errs = _events_bar({"sharded": ir_sh, "render_ir": single},
                           rec.binned_events(0), params, "demo 5, 16M rays")
        nz = (ir_sh > 0).sum(dim=1).tolist()
        assert min(nz) >= 200, nz
        del single
        log(f"sharded render, demo 5's room ({sc.valid.shape[0]} triangle "
            f"rows), {n5} rays x {params.max_bounces} bounces in rounds "
            f"{opts.round_budgets}, a {IR_SECONDS} s IR at {SR} Hz: first "
            f"call {first_s:.3f} s (host clock), in main {res5['wall_s']:.3f}"
            f" s (recorded); render_ir_sharded {sharded_ms:.3f} ms, "
            f"render_ir of rank 0's stream {single_ms:.3f} ms (CUDA events, "
            f"medians of 3); peak device memory {peak:.0f} MiB; against the "
            f"float64 sum of the sharded run's deposits: {errs} (bar 1e-4); "
            f"nonzero bins per ear {nz}, energy {ir_sh.sum(dim=1).tolist()}")

        # The 2 x 2 matrix of main: posed K1; pair 3 = (source 1, listener
        # 1) against render_ir_sharded of its pair seed on the same mesh.
        assert irs.shape == (2, 2, 2, IR_SECONDS * SR)
        assert np.isfinite(irs).all() and (irs > 0).sum(axis=-1).min() > 200
        margs = (sc, demo5.MATRIX_SEED, demo5.EMITTERS, demo5.LISTENERS,
                 demo5.YAWS, pair_rays, params, opts)
        matrix_ms = wall_ms(lambda: multi.render_ir_matrix(
            *margs, mesh=mesh, rows=rows), 3)
        alone = render_ir_sharded(
            sc, sampling.fold_seed(demo5.MATRIX_SEED, 3), pair_rays,
            demo5.EMITTERS[1], demo5.LISTENERS[1], float(demo5.YAWS[1]),
            params, opts, mesh=mesh, rows=rows)
        errs = _events_bar({"matrix pair (1, 1)": torch.from_numpy(
            irs[1, 1]).to(dev), "render_ir_sharded of its pair seed": alone},
            rec.binned_events(1), params, "2 x 2 matrix", pose=3)
        del rec
        log(f"sharded matrix, 2 x 2 x {pair_rays} rays (mesh=): launches of "
            f"main (render and matrix) {l5}; {matrix_ms:.3f} ms (host "
            f"clock, the copy to the host included, median of 3); pair "
            f"(1, 1) and render_ir_sharded of its pair seed against the "
            f"float64 sum of the matrix's deposits for it: {errs}")
        out = {"demo5": {"sharded_ms": sharded_ms, "render_ir_ms": single_ms,
                         "peak_mib": peak, "first_s": first_s,
                         "wall_s": res5["wall_s"], "launches": l5},
               "matrix_ms": matrix_ms}

        # The office: the schedule and K2 run, K1 does not.
        _, scc, orows, oboxes = _office_clustered()
        oparams = _office_params()
        oopts = TracerOptions(schedule=True)
        oargs = (scc, SHARDED_SEED, N_RAYS, EMITTER, OFFICE_RECEIVER, 0.0,
                 oparams, oopts)
        ir_o, lo, rec = driven(lambda: render_ir_sharded(
            *oargs, mesh=mesh, rows=orows, boxes=oboxes), "office, 1M rays")
        assert lo["tile_schedule"] == OFFICE_BOUNCES, lo
        assert lo["trace_round_sched"] == OFFICE_BOUNCES, lo
        assert lo["trace_round"] == 0 and lo["histogram_binned"] == 1, lo
        office_ms = median_ms(lambda: render_ir_sharded(
            *oargs, mesh=mesh, rows=orows, boxes=oboxes), 3)

        def single_office():
            return tracer.render_ir(
                scc, sampling.pose_generator(SHARDED_SEED, 0, dev), N_RAYS,
                EMITTER, OFFICE_RECEIVER, 0.0, oparams, oopts,
                n_total_rays=N_RAYS, rows=orows, boxes=oboxes)
        errs = _events_bar({"sharded": ir_o, "render_ir": single_office()},
                           rec.binned_events(), oparams, "office, 1M rays")
        office_single_ms = median_ms(single_office, 3)
        del rec
        log(f"sharded render, office ({N_RAYS} rays x {OFFICE_BOUNCES} "
            f"bounces, clusters of 32): launches {lo}; render_ir_sharded "
            f"{office_ms:.3f} ms, render_ir of rank 0's stream "
            f"{office_single_ms:.3f} ms (medians of 3); against the float64 "
            f"sum: {errs}")
        out["office"] = {"sharded_ms": office_ms,
                         "render_ir_ms": office_single_ms}

        # The segment-sharded convolution of 16 s with demo 5's IR.
        sig = np.random.default_rng(3).standard_normal(
            CONV_SECONDS * SR).astype(np.float32) * 0.3
        seg = make_segment_mesh()
        conv, lc, _ = driven(lambda: convolve_file_sharded(
            sig, ir_sh, SR, mesh=seg), "sharded convolution")
        assert not any(lc.values()), lc
        want = convolve.convolve_file_stereo(torch.from_numpy(sig).to(dev),
                                             ir_sh, SR)
        rel = _rel_l2(conv.cpu().numpy(), want.cpu().numpy())
        assert conv.shape == (2, CONV_SECONDS * SR) and rel < CONV_BAR, rel
        conv_ms = median_ms(lambda: convolve_file_sharded(sig, ir_sh, SR,
                                                          mesh=seg), 5)
        single_conv_ms = median_ms(lambda: convolve.convolve_file_stereo(
            torch.from_numpy(sig).to(dev), ir_sh, SR), 5)
        log(f"sharded convolution, {CONV_SECONDS} s at {SR} Hz, a "
            f"{IR_SECONDS} s IR (halo ring and all-gather under NCCL): "
            f"{rel:.3e} relative L2 from convolve_file_stereo (bar "
            f"{CONV_BAR}); {conv_ms:.3f} ms, single-process "
            f"{single_conv_ms:.3f} ms (medians of 5)")
        out["conv"] = {"sharded_ms": conv_ms, "single_ms": single_conv_ms,
                       "rel_l2": rel}

        # The dry run's three steps as a world of one.
        t1 = time.perf_counter()
        dry, ld, _ = driven(lambda: dryrun.dryrun_multichip(1),
                            "dryrun_multichip(1)")
        dry_s = time.perf_counter() - t1
        loss, grad = dryrun.unsharded_train_gradient(1, dev)
        g_rel = float(np.abs(dry["grad"] - grad).max()
                      / np.abs(grad).max())
        assert math.isfinite(dry["loss"]) and g_rel <= DRY_GRAD_BAR, (
            dry, grad)
        assert ld["histogram"] > 0 and ld["histogram_bwd"] > 0, ld
        assert ld["tile_schedule"] > 0 and ld["trace_round_sched"] > 0, ld
        log(f"dryrun_multichip(1): {dry_s:.2f} s, its launches held to "
            f"their plain versions included; loss {dry['loss']:.6e} "
            f"(unsharded {loss:.6e}), gradient {dry['grad'].tolist()} "
            f"against the unsharded step's {grad.tolist()}: {g_rel:.3e} "
            f"relative (bar {DRY_GRAD_BAR}); launches {ld}")
    finally:
        dist.destroy_process_group()
    # Every launch of the product calls was held to its plain version.
    for k, n in total.items():
        assert held.get(k, {"launches": 0})["launches"] == n, (k, n, held)
    out["launches"], out["held"] = total, held
    log(f"phase 22 (a) launches: {total}; held to the plain versions: "
        f"{held}")
    return out


def gloo_rank(rank: str, world: str, port: str, out_dir: str) -> None:
    """One rank of phase 22 (b): trace_directions_sharded of the box's
    GLOO_DIRS seeded directions, its IR saved as ``<out_dir>/<rank>.npy``."""
    import torch.distributed as dist

    from audiorenderingv2_tpu_torch import tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.parallel import (init_distributed,
                                                     make_ray_mesh,
                                                     trace_directions_sharded)

    init_distributed(f"127.0.0.1:{port}", int(world), int(rank),
                     backend="gloo")
    try:
        mesh = make_ray_mesh()
        assert mesh.device == torch.device("cuda", 0), mesh
        sc = tracer.scene_to_arrays(_box_scene(), 128, device=mesh.device)
        opts = TracerOptions(round_budgets=tuned.round_budgets_for(
            MAX_BOUNCES))
        ir = trace_directions_sharded(
            sc, unit_dirs(GLOO_DIRS, 71), EMITTER, RECEIVER, 0.0,
            _box_params(), opts, mesh=mesh)
        np.save(Path(out_dir) / f"{rank}.npy", ir.cpu().numpy())
    finally:
        dist.destroy_process_group()


GLOO_RANK = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
             "chip_smoke.gloo_rank(*sys.argv[2:])")


def phase_sharded_gloo() -> None:
    """Phase 22 (b): two gloo ranks on the one card. Two NCCL ranks on one
    GPU are refused ("Duplicate GPU detected"); gloo's all-reduce takes
    CUDA tensors."""
    from audiorenderingv2_tpu_torch import dryrun, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    if "exclusive" in mode.lower():
        raise RuntimeError(f"compute mode {mode!r}: two processes cannot "
                           f"share the card, phase 22 (b) needs Default")
    with tempfile.TemporaryDirectory() as tmp:
        port = dryrun.free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK, str(REPO), str(r), "2",
             str(port), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"gloo rank {r} failed:\n{out[-4000:]}"
        wall = time.perf_counter() - t0
        a, b = (np.load(Path(tmp) / f"{r}.npy") for r in range(2))
    np.testing.assert_array_equal(a, b)
    dev = torch.device("cuda")
    sc = tracer.scene_to_arrays(_box_scene(), 128, device=dev)
    params = _box_params()
    opts = TracerOptions(round_budgets=tuned.round_budgets_for(MAX_BOUNCES))
    dirs = torch.from_numpy(unit_dirs(GLOO_DIRS, 71)).to(dev)
    single = tracer.trace_ir(sc, dirs, EMITTER, RECEIVER, 0.0, params, opts)
    rows, _ = rc.pack_scene(sc)
    ev = rc.trace_events(rows, dirs, torch.tensor(EMITTER, device=dev),
                         torch.tensor(RECEIVER, device=dev), 0.0, params,
                         round_budgets=opts.round_budgets)
    ev = tuple(x[None] for x in ev)  # one pose
    errs = _events_bar({"2 gloo ranks": torch.from_numpy(a).to(dev),
                        "trace_ir": single}, ev, params,
                       "box, 1,000,064 directions")
    log(f"sharded, 2 gloo ranks on the one card (compute mode {mode}): "
        f"{wall:.2f} s for both processes (start, import, trace); the ranks' "
        f"IRs equal bit for bit; against the float64 sum of the "
        f"single-process trace's deposits: {errs}")


def phase_warmup() -> dict:
    """Phase 22 (c): the warmup entry point as a user runs it."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "warmup.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "audiorenderingv2_tpu_torch.warmup",
             "--out", str(out)], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
        report = json.loads(out.read_text())
    assert report["device"]["platform"] == "gpu", report
    assert set(report["configs"]) == {"small_bench", "large_bench",
                                      "renderer_default"}, report
    for name, row in report["configs"].items():
        for key in ("setup_s", "first_s", "warm_s"):
            assert math.isfinite(row[key]) and row[key] > 0, (name, row)
    log(f"warmup: {wall:.2f} s for the process; {json.dumps(report)}")
    return report


def phase_sharded() -> dict:
    """Phase 22: the multi-GPU path (a) under NCCL as a world of one, (b)
    as two gloo ranks on the card, (c) warmup. Returns (a)'s numbers."""
    t0 = time.perf_counter()
    out = phase_sharded_nccl()
    phase_sharded_gloo()
    phase_warmup()
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------- phase 23

ORACLE_RAYS = 4096
ORACLE_RTOL, ORACLE_ATOL = 2e-3, 1e-8  # tests/test_pallas.py:62's bar
WRAPPERS = (("raytrace_cuda", "trace_round"),
            ("raytrace_cuda", "init_state_native"),
            ("raytrace_cuda", "compaction_keys"),
            ("schedule_cuda", "tile_schedule"),
            ("schedule_cuda", "trace_round_sched"),
            ("traverse_cuda", "trace_traverse"),
            ("histogram_cuda", "histogram_sum_banded"),
            ("histogram_cuda", "histogram_bwd"),
            ("histogram_cuda", "histogram_binned"),
            ("replay_cuda", "replay"),
            ("replay_cuda", "replay_bwd"))


class CudaOnly:
    """Inside ``with``, every call of a kernel wrapper is noted with the
    device of its tensors: a CPU tensor would run the kernel's plain
    version, not the kernel. :meth:`check` fails on any such call."""

    def __enter__(self):
        import importlib

        self.calls, self.cpu = 0, []
        self._orig = []
        for mod_name, name in WRAPPERS:
            mod = importlib.import_module(
                f"audiorenderingv2_tpu_torch.ops.{mod_name}")
            orig = getattr(mod, name)
            self._orig.append((mod, name, orig))
            setattr(mod, name, self._watch(name, orig))
        return self

    def _watch(self, name, orig):
        def call(*args, **kw):
            self.calls += 1
            devs = {a.device.type for a in (*args, *kw.values())
                    if isinstance(a, torch.Tensor)}
            if devs != {"cuda"}:
                self.cpu.append((name, sorted(devs)))
            return orig(*args, **kw)
        return call

    def __exit__(self, *exc) -> bool:
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)
        return False

    def check(self, what: str) -> None:
        assert self.calls > 0, f"{what}: no kernel wrapper was called"
        assert not self.cpu, f"{what}: wrappers given CPU tensors {self.cpu}"


class RenderLog:
    """Inside ``with``, every ``AudioRenderer.render`` is noted: (the
    renderer, the receiver's position and yaw, the IR's energy)."""

    def __enter__(self):
        from audiorenderingv2_tpu_torch import renderer

        self.renders = []
        self._cls, self._orig = renderer.AudioRenderer, \
            renderer.AudioRenderer.render
        orig, renders = self._orig, self.renders

        def render(r, *a, **kw):
            ir = orig(r, *a, **kw)
            renders.append((r, r.receiver_pos.copy(), r.receiver_yaw_deg,
                            float(ir.sum())))
            return ir
        self._cls.render = render
        return self

    def __exit__(self, *exc) -> bool:
        self._cls.render = self._orig
        return False


MOVED_SHARE = 1e-3  # rays whose deposit may differ from the oracle's


def _deposit_entries(ear: int, b: int, w: np.ndarray, params) -> dict:
    """A ray's deposit as the hard-binning rule writes it: {(ear, band,
    bin): weight} for the same ear at bin ``b`` and, unless mono, the other
    ear at ``b + delay`` (``b`` past the IR's end) at (1 - hrtf)."""
    out = {(ear, k, b): float(w[k]) for k in range(len(w))}
    if not params.is_mono:
        cb = (b + params.cross_ear_delay
              if b + params.cross_ear_delay < params.ir_length else b)
        out.update({(1 - ear, k, cb): float(w[k])
                    * (1.0 - params.hrtf_absorption_rate)
                    for k in range(len(w))})
    return out


def per_ray_oracle(what: str, scene, sc, d: torch.Tensor, emitter,
                   receiver, yaw: float, params, opts, rows, card: np.ndarray):
    """The per-bin oracle bar with each ray's deposit accounted for. K1
    works ray by ray, so a trace without the partition (``compact=False``)
    gives each ray's event in its own slot; the oracle traces each ray
    alone. A ray whose deposit differs (another bin or ear, or a weight off
    the bar) took another path: in the demos this is a near-tangent crossing
    of the receiver sphere, its chord t2 - t1 = 2 sqrt(b^2 - c) cancelling
    in float32, which float64 decides the other way. Such rays are
    reported one by one and may be at most MOVED_SHARE of the rays; every
    bin of the IRs without them is held at ORACLE_RTOL / ORACLE_ATOL.
    Returns (the oracle's IR, the rays that moved)."""
    from audiorenderingv2_tpu_torch.core import tracer, tracer_ref
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    n, dev = d.shape[0], d.device
    packed, boxes = tracer.packed_scene(sc, params, rows, None, opts)
    route = tracer.trace_route(opts, params.n_bands, False)
    assert boxes is None and route == rc.ROWS
    em_d, rec_d = (torch.as_tensor(np.asarray(x, np.float32), device=dev)
                   for x in (emitter, receiver))
    ev = rc.trace_events(packed, d, em_d, rec_d, float(yaw), params,
                         route=route._replace(reorder=None),
                         round_budgets=opts.round_budgets)
    # The same IR as the demo's trace: the partition only reorders rays.
    card_ev = tracer._histogram_from_events(*ev, params, False).cpu().numpy()
    np.testing.assert_allclose(card_ev, card, rtol=1e-4, atol=1e-12)
    bins = torch.round(ev[0][:n]).long().cpu().numpy()
    w = ev[1][:n].double().cpu().numpy()
    ears = ev[2][:n].cpu().numpy()
    d_np = d.cpu().numpy()
    ref = np.zeros((2, params.n_bands, params.ir_length))
    kept = np.zeros_like(ref)
    moved = []
    for i in range(n):
        ir_i = tracer_ref.trace_ir_reference(
            scene, d_np[i:i + 1], emitter, receiver, yaw, params,
            n_total_rays=n).reshape(ref.shape)
        ref += ir_i
        nz = np.nonzero(ir_i)
        want = {k: ir_i[k] for k in zip(*nz)}
        active = (w[i] != 0).any() and 0 <= bins[i] < params.ir_length
        got = (_deposit_entries(int(ears[i]), int(bins[i]), w[i], params)
               if active else {})
        got = {k: v for k, v in got.items() if v != 0}
        same = set(got) == set(want) and all(
            abs(got[k] - want[k]) <= ORACLE_ATOL + ORACLE_RTOL * abs(want[k])
            for k in want)
        if same:
            kept += ir_i
            continue
        moved.append(i)

        def band0(dep):
            return sorted((int(k[0]), int(k[2]), float(v))
                          for k, v in dep.items() if k[1] == 0)
        log(f"{what}: ray {i} (direction {d_np[i].tolist()}) moved: the "
            f"oracle deposits {band0(want)}, the card {band0(got)} (ear, "
            f"bin, band-0 weight)")
    assert len(moved) <= max(1, int(MOVED_SHARE * n)), (what, moved)
    w_kept = ev[1].clone()
    w_kept[torch.tensor(moved, dtype=torch.long, device=dev)] = 0.0
    card_kept = tracer._histogram_from_events(ev[0], w_kept, ev[2], params,
                                              False).cpu().numpy()
    card_kept = card_kept.reshape(ref.shape).astype(np.float64)
    bad = ~np.isclose(card_kept, kept, rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
    assert not bad.any(), (what, np.argwhere(bad)[:8].tolist())
    return ref.reshape(card.shape), moved


def oracle_check(what: str, scene, sc, dirs: torch.Tensor, emitter,
                 receiver, yaw: float, params, opts, per_bin: bool,
                 rows=None, boxes=None) -> dict:
    """The first ORACLE_RAYS of ``dirs`` through the kernels on the card
    (``trace_ir`` under the demo's options) and through the float64 oracle
    (``core.tracer_ref.trace_ir_reference``) on the host, on the same scene
    and pose. ``per_bin``: held per bin at ORACLE_RTOL / ORACLE_ATOL, each
    ray's deposit accounted for (:func:`per_ray_oracle`); else on
    ``assert_ir_close(exact=False)``. Returns the largest relative bin error
    and the relative L1 of the whole IRs, and the rays that moved."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.core import tracer, tracer_ref

    d = dirs[:ORACLE_RAYS].contiguous()
    card = tracer.trace_ir(sc, d, emitter, receiver, yaw, params, opts,
                           rows=rows, boxes=boxes).cpu().numpy()
    t0 = time.perf_counter()
    if per_bin:
        ref, moved = per_ray_oracle(what, scene, sc, d, emitter, receiver,
                                    yaw, params, opts, rows, card)
    else:
        ref = tracer_ref.trace_ir_reference(scene, d, emitter, receiver, yaw,
                                            params)
        moved = None
    host_s = time.perf_counter() - t0
    card64 = card.astype(np.float64)
    occ = ref > 0
    assert occ.sum() > 0, f"{what}: the oracle's IR is empty"
    max_rel = float((np.abs(card64 - ref)[occ] / ref[occ]).max())
    l1 = float(np.abs(card64 - ref).sum() / np.abs(ref).sum())
    stray = int(((card != 0) & ~occ).sum())
    line = (f"{what}: {ORACLE_RAYS} of its own directions, the card's IR "
            f"against the float64 oracle ({host_s:.1f} s on the host): "
            f"{int(occ.sum())} occupied bins, largest relative bin error "
            f"{max_rel:.3e}, relative L1 {l1:.3e}, {stray} bins the oracle "
            f"leaves empty")
    if per_bin:
        log(f"{line}; each ray's deposit against the oracle's: "
            f"{len(moved)} moved (bar {MOVED_SHARE:.1%} of the rays), every "
            f"bin of the rest within rtol {ORACLE_RTOL}, atol {ORACLE_ATOL}")
    else:
        testing.assert_ir_close(card64, ref, exact=False)
        log(f"{line}; passes assert_ir_close(exact=False)")
    return {"max_rel": max_rel, "l1": l1, "bins": int(occ.sum()),
            "oracle_s": host_s, "moved": moved}


def run_demo(what: str, fn, warm: bool = True, record: bool = False):
    """``fn()`` (a demo's ``main``) as a user runs it, its launches counted
    (the counters set to 0 just before, read just after) and every wrapper
    call checked to be given CUDA tensors; with ``record``, each launch is
    also kept (LaunchRecorder) and held to its plain version afterwards,
    outside the counts. With ``warm``, ``fn()`` runs once more, uncounted.
    Returns (the first run's result, its launches, the held launches or
    None, the first run's wall seconds, the second's or None)."""
    import contextlib

    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(LaunchRecorder()) if record else None
        watch = stack.enter_context(CudaOnly())
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = _read_launches()
    watch.check(what)
    held = rec.check(what) if record else None
    if record:  # every counted launch of the recorded wrappers was held
        for k in ("trace_round", "trace_round_posed", "histogram",
                  "histogram_binned", "histogram_bwd", "tile_schedule",
                  "trace_round_sched", "trace_round_sched_posed",
                  "band_split"):
            assert held.get(k, {"launches": 0})["launches"] == launches[k], \
                (what, k, launches, held)
    warm_s = None
    if warm:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    counted = {k: v for k, v in launches.items() if v}
    log(f"{what}: first run {first_s:.3f} s, warm run "
        f"{'not repeated' if warm_s is None else f'{warm_s:.3f} s'} (host "
        f"clock); launches of the first run {counted}")
    return out, launches, held, first_s, warm_s


def _expect(what: str, launches: dict, **want) -> None:
    """Each named count equal to its wanted value (an int), or at least 1
    (``True``), or 0 (``False``)."""
    for k, v in want.items():
        ok = (launches[k] > 0 if v is True else launches[k] == 0
              if v is False else launches[k] == v)
        assert ok, (what, k, v, launches)


def demo_oracles_and_checks(tmp: Path) -> dict:
    """Phase 23's demos 1-4 and 6 and the live duplex on the card, each
    as a user runs it, then each against the float64 oracle. Returns each
    demo's numbers and launches."""
    from audiorenderingv2_tpu_torch.core import sampling, tracer, tracer_ref
    from audiorenderingv2_tpu_torch.diff import render_soft_ir
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.examples import (demo_1_sphere,
                                                     demo_2_banded,
                                                     demo_3_realtime,
                                                     demo_4_inverse,
                                                     demo_6_multipose,
                                                     demo_live_duplex,
                                                     seeded_directions)

    dev = torch.device("cuda")
    out = {}

    # Demos 1 and 2: every launch recorded and held to its plain version.
    for name, mod, args, n_bands in (
            ("demo 1", demo_1_sphere, (tmp / "sphere.wav",), 1),
            ("demo 2", demo_2_banded, (), 4)):
        res, launches, held, first_s, warm_s = run_demo(
            f"{name} ({mod.__name__.rsplit('.', 1)[1]}.main)",
            lambda: mod.main(*args, device="cuda"), record=True)
        _expect(name, launches, trace_round=True, histogram_binned=1,
                histogram=False, trace_round_posed=False)
        params = mod.trace_params()
        sc = tracer.scene_to_arrays(mod.scene(), device=dev)
        dirs = seeded_directions(mod.N_RAYS, mod.SEED, dev)
        render_ms = median_ms(lambda: tracer.trace_ir(
            sc, dirs, mod.EMITTER, mod.RECEIVER, mod.YAW, params, mod.OPTS),
            5)
        assert res["ir"].shape == ((2, SR) if n_bands == 1
                                   else (2, n_bands, SR))
        assert np.isfinite(res["ir"]).all() and res["ir"].sum() > 0
        oracle = oracle_check(name, mod.scene(), sc, dirs, mod.EMITTER,
                              mod.RECEIVER, mod.YAW, params, mod.OPTS,
                              per_bin=True)
        log(f"{name}: the trace of its {mod.N_RAYS} rays {render_ms:.3f} ms "
            f"(CUDA events, median of 5)")
        out[name] = {"launches": launches, "held": held, "first_s": first_s,
                     "warm_s": warm_s, "render_ms": render_ms,
                     "oracle": oracle}

    # Demo 3: the walk; the oracle at its first render with the receiver
    # inside the room (the walk starts outside it, ROADMAP Queue 3).
    with RenderLog() as renders:
        res, launches, _, first_s, warm_s = run_demo(
            "demo 3 (demo_3_realtime.main)",
            lambda: demo_3_realtime.main(tmp / "walk.wav", device="cuda"))
    n_runs = res["renders"] + 1  # the warm-up cycle first
    first_renders = renders.renders[:n_runs]
    _expect("demo 3", launches, trace_round=True,
            histogram_binned=n_runs, histogram=False)
    assert res["n_rays"] == demo_3_realtime.n_rays(dev), res["n_rays"]
    assert res["renders"] > 10, res["renders"]
    assert res["out"].shape == (2, SR * demo_3_realtime.SECONDS)
    assert np.isfinite(res["out"]).all() and math.isfinite(res["rtf"])
    half = np.asarray(demo_3_realtime.ROOM) / 2
    outside = [e for _, p, _, e in first_renders if p[1] - 1.0 >= half[1]]
    inside = [e for _, p, _, e in first_renders if np.all(np.abs(p) < half)]
    assert len(outside) >= 8 and inside and min(inside) > 0, (outside,
                                                              inside)
    # With the receiver outside the box only rays that leave it can reach
    # it: a ray that strikes within BOUNCE_EPSILON of an edge is set off
    # the wall past the other one. The first render (the warm-up cycle at
    # the walk's start) is traced again ray by ray, without the partition:
    # each ray that deposits is held to the oracle's trace of that ray.
    r, pos, yaw = next((r, p, y) for r, p, y, _ in first_renders
                       if np.all(np.abs(p) < half))
    d3 = sampling.sample_directions(
        r.n_rays, torch.Generator(device=dev).manual_seed(
            demo_3_realtime.SEED), dev)
    pos0 = first_renders[0][1]
    ev = rc.trace_events(r.rows, d3, torch.zeros(3, device=dev),
                         torch.from_numpy(pos0).to(dev), 0.0, r.params,
                         route=rc.Route("k1", None),
                         round_budgets=r.opts.round_budgets)
    leaks = torch.nonzero(ev[1][:r.n_rays].abs().sum(dim=1)).flatten()
    leaks = leaks.cpu().tolist()
    assert len(leaks) <= 1e-4 * r.n_rays, len(leaks)
    for i in leaks:
        ref = tracer_ref.trace_ir_reference(
            r.scene, d3[i:i + 1], np.zeros(3), pos0, 0.0, r.params,
            n_total_rays=r.n_rays)
        b = int(torch.round(ev[0][i]))
        e = int(ev[2][i])
        w = float(ev[1][i, 0])
        assert abs(ref[e, b] - w) <= 2e-3 * w, (i, b, e, w, np.nonzero(ref))
    in_ir = torch.round(ev[0][:r.n_rays]) < r.params.ir_length
    leak_energy = float((ev[1][:r.n_rays].double().sum(dim=1) * in_ir).sum()
                        * (2.0 - r.params.hrtf_absorption_rate))
    assert abs(leak_energy - first_renders[0][3]) <= 1e-3 * max(
        leak_energy, 1e-30), (leak_energy, first_renders[0][3])
    assert max(outside) <= 1e-3 * float(np.median(inside)), outside
    render_ms = median_ms(r.render, 5)
    log(f"demo 3: {res['renders']} renders of {res['n_rays']} rays over "
        f"{res['audio_s']:.0f} s of audio in {res['wall_s']:.3f} s wall, "
        f"real-time factor {res['rtf']:.4f} (wall over audio); "
        f"{len(outside)} renders with the receiver outside the room, IR "
        f"energies {outside} against the median {np.median(inside):.4e} "
        f"inside; at the walk's start {len(leaks)} of {r.n_rays} rays leave "
        f"the box at an edge and reach the receiver, each deposit the "
        f"oracle's within 2e-3; render {render_ms:.3f} ms (CUDA events, "
        f"median of 5); the oracle at the first pose inside, "
        f"{pos.tolist()}, yaw {yaw:.2f}")
    oracle = oracle_check("demo 3", r.scene, r.sc, d3, r.emitter_pos, pos,
                          yaw, r.params, r.opts, per_bin=False, rows=r.rows,
                          boxes=r.boxes)
    out["demo 3"] = {"launches": launches, "first_s": first_s,
                     "warm_s": warm_s, "render_ms": render_ms,
                     "renders": res["renders"], "rtf": res["rtf"],
                     "leaks": len(leaks), "oracle": oracle}

    # Demo 4 at its own size (200 steps), once: its steps are its repeats.
    fit_s = []
    fit = demo_4_inverse.fit_scene_parameters

    def timed_fit(*a, **kw):
        t0 = time.perf_counter()
        result = fit(*a, **kw)
        fit_s.append(time.perf_counter() - t0)
        return result
    demo_4_inverse.fit_scene_parameters = timed_fit
    try:
        res, launches, _, first_s, _ = run_demo(
            "demo 4 (demo_4_inverse.main)",
            lambda: demo_4_inverse.main(device="cuda"), warm=False)
    finally:
        demo_4_inverse.fit_scene_parameters = fit
    _expect("demo 4", launches, histogram=True, histogram_bwd=True,
            trace_round=False)
    assert abs(res["absorption"] - demo_4_inverse.TRUE_ABSORPTION) < 0.08
    assert res["emitter_err"] < 0.5 and np.isfinite(res["losses"]).all()
    box, p4 = demo_4_inverse.scene(), demo_4_inverse.trace_params()
    render_ms = median_ms(lambda: render_soft_ir(
        box, p4, n_rays=demo_4_inverse.N_RAYS,
        emitter=demo_4_inverse.TRUE_EMITTER,
        receiver_pos=demo_4_inverse.RECEIVERS[0], opts=demo_4_inverse.OPTS,
        seed=demo_4_inverse.SEED, device="cuda"), 5)
    step_ms = fit_s[0] / demo_4_inverse.STEPS * 1e3
    log(f"demo 4: the whole demo {first_s:.2f} s, its {demo_4_inverse.STEPS}"
        f" steps {fit_s[0]:.2f} s ({step_ms:.1f} ms a step, host clock); "
        f"grid best {res['best'].tolist()}; absorption "
        f"{res['absorption']:.4f} (true {demo_4_inverse.TRUE_ABSORPTION}), "
        f"emitter off by {res['emitter_err']:.3f} m (bars 0.08, 0.5 m); a "
        f"soft render of {demo_4_inverse.N_RAYS} rays {render_ms:.3f} ms "
        f"(CUDA events, median of 5)")
    out["demo 4"] = {"launches": launches, "first_s": first_s,
                     "step_ms": step_ms, "render_ms": render_ms,
                     "absorption": res["absorption"],
                     "emitter_err": res["emitter_err"]}

    # Demo 6: the fused matrix and the mix; the oracle on pair 0.
    res, launches, _, first_s, warm_s = run_demo(
        "demo 6 (demo_6_multipose.main)",
        lambda: demo_6_multipose.main(tmp / "multipose", device="cuda"))
    _expect("demo 6", launches, trace_round_posed=2, histogram_binned=1,
            trace_round=False, histogram=False)
    assert res["irs"].shape == (2, 4, 2, 2 * SR) and res["n_rays"] == N_RAYS
    assert np.isfinite(res["irs"]).all() and (res["irs"] > 0).any(axis=-1) \
        .all()
    assert res["out"].shape == (4, 2, 2 * SR) and np.isfinite(
        res["out"]).all()
    assert len(res["paths"]) == 4
    for pth in res["paths"]:
        from audiorenderingv2_tpu_torch.io import wav

        samples = wav.read_wav(pth).samples
        assert samples.shape == (2, 2 * SR) and np.isfinite(samples).all()
    p6 = demo_6_multipose.trace_params()
    sc6 = tracer.scene_to_arrays(demo_6_multipose.scene(), 128, device=dev)
    from audiorenderingv2_tpu_torch import multi

    render_ms = median_ms(lambda: multi.render_ir_matrix(
        sc6, demo_6_multipose.SEED, demo_6_multipose.EMITTERS,
        demo_6_multipose.LISTENERS, demo_6_multipose.YAWS, N_RAYS, p6,
        demo_6_multipose.OPTS, pair_batch=demo_6_multipose.PAIR_BATCH), 3)
    d6 = sampling.sample_directions(
        N_RAYS, sampling.pose_generator(demo_6_multipose.SEED, 0, dev), dev)
    log(f"demo 6: the 2 x 4 x {N_RAYS}-ray matrix {render_ms:.3f} ms (CUDA "
        f"events, the copy to the host included, median of 3); 4 WAVs of "
        f"2 s, finite")
    oracle = oracle_check("demo 6, pair 0", demo_6_multipose.scene(), sc6, d6,
                          demo_6_multipose.EMITTERS[0],
                          demo_6_multipose.LISTENERS[0],
                          float(demo_6_multipose.YAWS[0]), p6,
                          demo_6_multipose.OPTS, per_bin=False)
    out["demo 6"] = {"launches": launches, "first_s": first_s,
                     "warm_s": warm_s, "render_ms": render_ms,
                     "oracle": oracle}

    # The live duplex through the native engine.
    with RenderLog() as renders:
        res, launches, _, first_s, warm_s = run_demo(
            "live duplex (demo_live_duplex.main)",
            lambda: demo_live_duplex.main(tmp / "live.wav", device="cuda"))
    _expect("live duplex", launches, trace_round=True, histogram_binned=1)
    n_frames = (SR * demo_live_duplex.SECONDS // demo_live_duplex.BLOCK
                * demo_live_duplex.BLOCK)
    assert res["frames"] == n_frames and res["native"], res["frames"]
    assert res["frames_streamed"] == n_frames
    assert np.isfinite(res["data"]).all() and np.abs(res["data"]).max() > 0
    render_ms = median_ms(renders.renders[0][0].render, 5)
    log(f"live duplex: {res['blocks']} blocks, {res['frames']} frames "
        f"({res['seconds']:.3f} s) through the native engine, "
        f"{res['underruns']} underruns; render {render_ms:.3f} ms (CUDA "
        f"events, median of 5)")
    out["live"] = {"launches": launches, "first_s": first_s,
                   "warm_s": warm_s, "render_ms": render_ms}
    return out


def demo5_oracle() -> dict:
    """Demo 5's oracle check: its main ran in phase 22 (a). The first
    ORACLE_RAYS directions of rank 0's stream of render_ir_sharded."""
    from audiorenderingv2_tpu_torch.core import sampling
    from audiorenderingv2_tpu_torch.examples import demo_5_sharded as demo5

    dev = torch.device("cuda")
    sc, rows, params, opts = demo5.setup(dev)
    d5 = sampling.sample_directions(
        demo5.total_rays(dev), sampling.pose_generator(demo5.SEED, 0, dev),
        dev)
    return oracle_check("demo 5", demo5.scene(), sc, d5, demo5.EMITTER,
                        demo5.RECEIVER, demo5.YAW, params, opts,
                        per_bin=False, rows=rows)


def fit_step_1m() -> dict:
    """Demo 4's joint fit (absorption and source) at 1M rays: one step of
    ``fit_scene_parameters(method="replay")`` (K1 records the paths, K3 and
    K3-bwd bin them) and one of the full method on the same directions;
    the two gradients held to phase 16's gate, within 1% of each other."""
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.diff import (fit_scene_parameters,
                                                 render_soft_ir)
    from audiorenderingv2_tpu_torch.examples import demo_4_inverse as d4

    dev = torch.device("cuda")
    box, params = d4.scene(), d4.trace_params()
    d = torch.from_numpy(unit_dirs(N_RAYS, 4)).to(dev)
    full = tracer.TracerOptions(block_size=65536, tri_chunk=128)
    target = torch.stack([render_soft_ir(
        box, params, n_rays=N_RAYS, emitter=d4.TRUE_EMITTER, receiver_pos=r,
        opts=full, device="cuda", directions=d) for r in d4.RECEIVERS])
    grads, times, launches = {}, {}, {}
    for method in ("replay", "full"):
        got = []

        def keep(i, loss, theta):
            got.append(torch.cat([theta["absorption_logits"].grad.flatten(),
                                  theta["emitter"].grad.flatten()]).cpu())
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_scene_parameters(
            box, target, params, steps=1, learning_rate=0.03,
            fit_absorption=True, fit_emitter=True, smooth_radius=8,
            init_emitter=(0.0, 0.0, 1.0), receiver_pos=d4.RECEIVERS,
            opts=full, device="cuda", directions=d, method=method,
            callback=keep)
        torch.cuda.synchronize()
        times[method] = time.perf_counter() - t0
        launches[method] = _read_launches()
        grads[method] = got[0].double()
    _expect("fit step, replay", launches["replay"], trace_round=True,
            histogram=True, histogram_bwd=True)
    _expect("fit step, full", launches["full"], trace_round=False,
            histogram=True, histogram_bwd=True)
    launches = {m: {k: v for k, v in ls.items() if v}
                for m, ls in launches.items()}
    g_r, g_f = grads["replay"], grads["full"]
    rel = float((g_r - g_f).norm() / g_f.norm())
    assert torch.isfinite(g_r).all() and rel < 1e-2, (g_r, g_f)
    log(f"demo 4's fit at {N_RAYS} rays (box, 3 receivers, 5 bounces, "
        f"absorption and source): one replay step {times['replay']:.3f} s "
        f"(launches {launches['replay']}), one full step "
        f"{times['full']:.3f} s (launches {launches['full']}), first calls, "
        f"host clock; gradient {g_r.tolist()} against the full method's "
        f"{g_f.tolist()}: {rel:.3e} relative (bar 1e-2, phase 16's gate)")
    return {"replay_s": times["replay"], "full_s": times["full"],
            "rel": rel}


def office_banded_matrix(tmp: Path) -> dict:
    """Demo 6's 2 x 4 matrix on the office with demo 2's four bands, from
    the render (the posed schedule and K2, pair_batch=8, 1M rays a pair,
    40 bounces) through mix_sources (the filterbank); one pair held to a
    single render_ir of that pair on assert_ir_close(exact=False), and
    the mix's band splits, run again under LaunchRecorder, to the plain
    product."""
    from audiorenderingv2_tpu_torch import accel, multi, testing
    from audiorenderingv2_tpu_torch.core import sampling, tracer
    from audiorenderingv2_tpu_torch.examples import demo_2_banded as d2
    from audiorenderingv2_tpu_torch.examples import demo_6_multipose as d6
    from audiorenderingv2_tpu_torch.scene import build_scene

    dev = torch.device("cuda")
    v, t = testing.office_mesh(OFFICE_TRIS)
    scene = build_scene(testing.mesh_from_arrays(v, t),
                        np.tile(d2.BAND_ABSORPTION, (len(t), 1)))
    sorted_scene, clusters = accel.prepare_scene(scene, cluster_size=32)
    sc = tracer.scene_to_arrays(sorted_scene, 128, device=dev,
                                clusters=clusters)
    n_bands = len(d2.BAND_ABSORPTION)
    params = dataclasses.replace(d6.trace_params(), n_bands=n_bands)
    opts = tracer.TracerOptions(schedule=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    irs = multi.render_ir_matrix(sc, 0, d6.EMITTERS, d6.LISTENERS, d6.YAWS,
                                 N_RAYS, params, opts,
                                 pair_batch=d6.PAIR_BATCH)
    mix = multi.mix_sources(irs, d6.dry_signals(), SR, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    _expect("office banded matrix", launches,
            trace_round_sched_posed=params.max_bounces,
            tile_schedule=params.max_bounces, histogram_binned=1,
            trace_round=False, trace_round_sched=False, band_split=True)
    launches = {k: v for k, v in launches.items() if v}
    # The mix once more, outside the counts and the time: each band split
    # held to the plain product on its own spectrum.
    with LaunchRecorder() as rec:
        multi.mix_sources(irs, d6.dry_signals(), SR, device="cuda")
        torch.cuda.synchronize()
    held = rec.check("office banded mix")
    assert held["band_split"]["launches"] == launches["band_split"], held
    assert irs.shape == (2, 4, 2, n_bands, 2 * SR) and np.isfinite(irs).all()
    assert mix.shape == (4, 2, 2 * SR) and np.isfinite(mix).all()
    assert np.abs(mix).max(axis=(1, 2)).min() > 0
    single = tracer.render_ir(
        sc, sampling.pose_generator(0, 5, dev), N_RAYS, d6.EMITTERS[1],
        d6.LISTENERS[1], float(d6.YAWS[1]), params, opts).cpu().numpy()
    pair = irs[1, 1]
    testing.assert_ir_close(pair.reshape(-1, 2 * SR),
                            single.reshape(-1, 2 * SR), exact=False)
    band_energy = irs.sum(axis=(0, 1, 2, 4))
    log(f"office ({sorted_scene.n_triangles} triangles, clusters of 32), "
        f"demo 2's {n_bands} bands, demo 6's 2 x 4 matrix x {N_RAYS} rays, "
        f"{params.max_bounces} bounces, then the mix through the filterbank: "
        f"{wall:.3f} s (first call, host clock); launches {launches}; peak "
        f"device memory {peak:.0f} MiB; energy per band "
        f"{band_energy.tolist()}; pair (1, 1) passes "
        f"assert_ir_close(exact=False) against a single render_ir of it")
    return {"wall_s": wall, "peak_mib": peak, "launches": launches}


def replay_100() -> dict:
    """A recording and its replay at 100 bounces: the box at 1M rays (K1
    in one-bounce rounds), render_ir_replay of the recorded paths against
    the forward render of the same directions (phase 15's bar)."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.diff import replay

    dev = torch.device("cuda")
    params = _box_params()
    box = tracer.scene_to_arrays(_box_scene(), 128, device=dev)
    d = torch.from_numpy(unit_dirs(N_RAYS, 6)).to(dev)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, recv = replay.record_paths_kernels(box, d, EMITTER, RECEIVER, 0.0,
                                            params)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    launches = _read_launches()
    _expect("recording at 100 bounces", launches, trace_round=MAX_BOUNCES,
            **{k: False for k in launches if k != "trace_round"})
    launches = {k: v for k, v in launches.items() if v}
    assert ids.shape == (N_RAYS, MAX_BOUNCES)
    with torch.no_grad():
        replay_ms = median_ms(lambda: replay.render_ir_replay(
            box, ids, recv, d, EMITTER, RECEIVER, 0.0, params,
            soft_binning=False), 3)
        ir_rep = replay.render_ir_replay(box, ids, recv, d, EMITTER,
                                         RECEIVER, 0.0, params,
                                         soft_binning=False)
    ir_fwd = tracer.trace_ir(box, d, EMITTER, RECEIVER, 0.0, params,
                             tracer.TracerOptions(round_budgets=(8, 24, 68)))
    testing.assert_ir_close(ir_rep.cpu().numpy(), ir_fwd.cpu().numpy(),
                            exact=False)
    deep = int((ids[:, MAX_BOUNCES - 1] >= 0).sum())
    log(f"replay at {MAX_BOUNCES} bounces, box, {N_RAYS} rays: record "
        f"{record_s:.3f} s (first call; launches {launches}), "
        f"{int((recv >= 0).sum())} rays reach the receiver, {deep} still "
        f"bouncing at bounce {MAX_BOUNCES}; render_ir_replay "
        f"{replay_ms:.3f} ms (median of 3) passes assert_ir_close("
        f"exact=False) against the forward render; energy "
        f"{float(ir_rep.sum()):.6e} / {float(ir_fwd.sum()):.6e}")
    return {"record_s": record_s, "replay_ms": replay_ms}


def k5_bands8() -> dict:
    """K5 on the 8-band layout (the office in clusters of 128, its
    absorption in all 8 bands): against its plain version at 65,536 and
    1,000,064 rays, from the start state and after one bounce and the
    sort, every column and each tile's visits bit for bit; its time."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import traverse_cuda as tc

    params = _office_params(8)
    rows, boxes = _office_packed(128, 8)
    result = {}
    for n in (65536, N_RAYS):
        st, scal = _office_start(n, 19, params)
        for step in range(2):
            visits = torch.zeros(st.shape[1] // 128, dtype=torch.int32,
                                 device=st.device)
            vp = torch.zeros_like(visits)
            kern = tc.trace_traverse(st.clone(), rows, boxes, scal, params, 1,
                                     visits=visits)
            plain = tc.trace_traverse_plain(st.clone(), rows, boxes, scal,
                                            params, 1, visits=vp)
            torch.cuda.synchronize()
            when = ("start state", "after one bounce and the sort")[step]
            what = (f"K5, 8 bands ({rc.state_ncols(8)} state columns), "
                    f"office in {boxes.shape[0]} clusters of 128, {n} rays, "
                    f"{when}")
            err = _assert_same_bits(kern, plain, what)
            assert torch.equal(visits, vp), f"{what}: visits differ"
            ms = median_ms(lambda s: tc.trace_traverse(
                s, rows, boxes, scal, params, 1), 5,
                setup=lambda: (st.clone(),))
            log(f"{what}: bit-identical to the plain version in every column "
                f"and visit count; {ms:.3f} ms (median of 5), visits per "
                f"tile mean {float(visits.float().mean()):.2f}")
            result[f"{n}_{step}"] = ms
            del plain
            st = rc._sort_state_by_keys(kern, rc._compaction_keys(kern))
    return result


def phase_demos(sharded: dict) -> dict:
    """Phase 23: the repo's seven demos on the card (demo 5's main ran in
    phase 22 (a), ``sharded``), each against the float64 oracle, and the
    four paths ROADMAP listed as ported but not run on the card. Returns
    each demo's launches and numbers."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = demo_oracles_and_checks(Path(tmp))
        out["demo 5"] = {"launches": sharded["demo5"]["launches"],
                         "first_s": sharded["demo5"]["first_s"],
                         "warm_s": sharded["demo5"]["wall_s"],
                         "render_ms": sharded["demo5"]["sharded_ms"],
                         "oracle": demo5_oracle()}
        log(f"demo 5 (its main in phase 22 (a)): first render_ir_sharded "
            f"{out['demo 5']['first_s']:.3f} s, main's render "
            f"{out['demo 5']['warm_s']:.3f} s (host clock, recorded), "
            f"render {out['demo 5']['render_ms']:.3f} ms (CUDA events, "
            f"median of 3)")
        demos_s = time.perf_counter() - t0
        out["fit_step_1m"] = fit_step_1m()
        out["office_banded_matrix"] = office_banded_matrix(Path(tmp))
    out["replay_100"] = replay_100()
    out["k5_bands8"] = k5_bands8()
    total = time.perf_counter() - t0
    table = {k: {m: v[m] for m in ("first_s", "warm_s", "render_ms")
                 if m in v} for k, v in out.items() if k.startswith(("demo",
                                                                      "live"))}
    log(f"phase 23: {total:.1f} s ({demos_s:.1f} s the demos and their "
        f"oracle checks); per demo {json.dumps(table)}")
    return out


# ------------------------------------------------------------------------
# Phase 24: tuned.py's constants measured on the card (changes none).

SWEEP_REPS = 7               # timed renders a variant, variants interleaved
SWEEP_OFFICE_ROWS_REPS = 3   # K1 over every office row takes ~2 s a render
SWEEP_SEED = 3               # every render of a group draws these directions
SWEEP_ICO_SUBDIVISIONS = (2, 3, 4)   # 320, 1,280, 5,120 triangles
SWEEP_ICO_BOUNCES = 32
SWEEP_ICO_EMITTER = (-1.0, 0.3, 0.2)
SWEEP_ICO_RECEIVER = (1.0, -0.2, 0.4)  # its sphere wholly inside radius 3
SWEEP_CLUSTER_SIZES = (32, 16, 64, 128)  # the default first
SWEEP_BUDGETS = ((8, 24, 68), (4, 12, 84), (12, 36, 52), (8, 92),
                 (6, 12, 24, 58))
SWEEP_PAIR_BATCHES = (16, 1, 4, 8)       # multi.py's default first
SWEEP_STREAM_BAR = 0.05  # per-ear energy, two direction streams (phase 7)


@dataclasses.dataclass
class _SweepCase:
    """A scene and pose of the sweep, traced to ``params.max_bounces``."""
    name: str
    scene: object
    params: object
    emitter: tuple
    receiver: tuple
    yaw: float = 0.0


def _sweep_cases() -> dict:
    """The sweep's scenes: three icosphere rooms, demo 5's room, the box
    and the office."""
    from audiorenderingv2_tpu_torch import testing
    from audiorenderingv2_tpu_torch.examples import demo_5_sharded as d5

    ico = dataclasses.replace(_office_params(),
                              max_bounces=SWEEP_ICO_BOUNCES)
    cases = {}
    for s in SWEEP_ICO_SUBDIVISIONS:
        scene = testing.scene_from_arrays(
            *testing.icosphere(3.0, subdivisions=s), 0.2)
        name = f"icosphere_{scene.n_triangles}"
        cases[name] = _SweepCase(name, scene, ico, SWEEP_ICO_EMITTER,
                                 SWEEP_ICO_RECEIVER)
    cases["demo5"] = _SweepCase("demo5", d5.scene(), d5.trace_params(),
                                tuple(d5.EMITTER), tuple(d5.RECEIVER),
                                d5.YAW)
    cases["box"] = _SweepCase("box", _box_scene(), _box_params(), EMITTER,
                              RECEIVER)
    cases["office"] = _SweepCase("office", _office_clustered()[0],
                                 _office_params(), EMITTER, OFFICE_RECEIVER)
    return cases


def _sweep_route(case: _SweepCase, cs: int | None = None,
                 schedule: bool = True, **fields):
    """A render of ``case`` at N_RAYS rays through ``render_ir`` on the
    card, its generator seeded with SWEEP_SEED at every call: the rows
    route (K1 over every row, ``tuned.small_scene_options``) when ``cs`` is
    None, else the scene Morton-sorted into clusters of ``cs`` and traced
    by the schedule and K2 (``tuned.clustered_scene_options``) or, without
    ``schedule``, by K5. ``fields`` replace options (round_budgets,
    native_rng). Returns (render, its options)."""
    from audiorenderingv2_tpu_torch import accel, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.core.tracer import TracerOptions

    if cs is None:
        sc = tracer.scene_to_arrays(case.scene, 128, device="cuda")
        opts = tuned.small_scene_options(case.params.max_bounces)
    else:
        sorted_scene, clusters = accel.prepare_scene(
            case.scene, min_triangles=0, cluster_size=cs)
        sc = tracer.scene_to_arrays(sorted_scene, 128, device="cuda",
                                    clusters=clusters)
        opts = (tuned.clustered_scene_options() if schedule
                else TracerOptions())
    opts = dataclasses.replace(opts, **fields)
    rows, boxes = tracer.packed_scene(sc, case.params, None, None, opts)
    gen = torch.Generator(device="cuda")

    def render():
        gen.manual_seed(SWEEP_SEED)
        return tracer.render_ir(sc, gen, N_RAYS, case.emitter, case.receiver,
                                case.yaw, case.params, opts, rows=rows,
                                boxes=boxes)

    return render, opts


def _sweep_variant(case: str, variant: str, fn, want: dict,
                   reps: int | None = None, default: bool = False) -> dict:
    """A variant of a sweep group: ``fn()`` renders it, ``want`` are the
    launch counts it must show (as ``_expect`` reads them), ``reps`` its
    timed renders (default SWEEP_REPS), ``default`` marks the variant that
    tuned.py's constants pick, which the scene's others are held to."""
    return {"scene": case, "variant": variant, "fn": fn, "want": want,
            "reps": SWEEP_REPS if reps is None else reps,
            "default": default}


def _ir_numbers(ir: np.ndarray, ref: np.ndarray) -> tuple[float, float]:
    """Largest per-ear relative energy difference and the relative L1
    distance of two IRs [..., 2, n] (every pair and ear of a matrix)."""
    ea = ir.reshape(-1, 2, ir.shape[-1]).sum(axis=-1, dtype=np.float64)
    eb = ref.reshape(-1, 2, ref.shape[-1]).sum(axis=-1, dtype=np.float64)
    l1 = float(np.abs(ir - ref).sum(dtype=np.float64)
               / np.abs(ref).sum(dtype=np.float64))
    return float((np.abs(ea - eb) / eb).max()), l1


def _sweep(group: str, variants: list, smi: str, bar: str = "same",
           extra=None) -> list:
    """Render every variant once (counted: the counters set to 0 just
    before, read just after, each wanted count met), then time them, their
    renders interleaved, with CUDA events: median, min and max of each
    variant's ``reps``. Each IR is held to its scene's default variant on
    the same directions by PERF.md section 2's bar (assert_ir_close(exact=
    False): per-ear energy within 1e-3, relative L1 below 1e-2), or with
    ``bar="stream"`` (other directions) per-ear energy within 5%. Prints
    one JSON line for the group; returns the variants' numbers."""
    from audiorenderingv2_tpu_torch import testing

    t0 = time.perf_counter()
    irs = {}
    for v in variants:
        _reset_launches()
        ir = v["fn"]()
        torch.cuda.synchronize()
        launches = _read_launches()
        _expect(f"{group} {v['scene']} {v['variant']}", launches,
                **v["want"])
        v["launches"] = {k: n for k, n in launches.items() if n}
        irs[id(v)] = ir.cpu().numpy() if torch.is_tensor(ir) else ir
        v["times"] = []
    for r in range(max(v["reps"] for v in variants)):
        for v in variants:
            if r >= v["reps"]:
                continue
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            v["fn"]()
            end.record()
            torch.cuda.synchronize()
            v["times"].append(start.elapsed_time(end))
    refs = {v["scene"]: irs[id(v)] for v in variants if v["default"]}
    out = []
    for v in variants:
        ir, ref = irs[id(v)], refs[v["scene"]]
        assert ir.shape == ref.shape and np.isfinite(ir).all(), v["variant"]
        assert (ir > 0).sum() > 0, (group, v["scene"], v["variant"])
        energy, l1 = _ir_numbers(ir, ref)
        what = f"{group}: {v['scene']} {v['variant']}"
        if bar == "stream":
            assert energy < SWEEP_STREAM_BAR, (what, energy)
        else:
            for a, b in zip(ir.reshape(-1, 2, ir.shape[-1]),
                            ref.reshape(-1, 2, ref.shape[-1])):
                testing.assert_ir_close(a, b, exact=False)
        t = np.array(v["times"])
        row = {"scene": v["scene"], "variant": v["variant"],
               "default": v["default"], "renders": len(t),
               "median_ms": float(np.median(t)), "min_ms": float(t.min()),
               "max_ms": float(t.max()), "energy_rel": energy,
               "rel_l1": l1, "launches": v["launches"]}
        if extra is not None:
            row.update(extra(v))
        out.append(row)
    for row in out:
        ref = next(r for r in out if r["default"]
                   and r["scene"] == row["scene"])
        row["vs_default"] = row["median_ms"] / ref["median_ms"]
    log(json.dumps({"tuned_sweep": group, "device": smi, "rays": N_RAYS,
                    "bar": bar, "seconds": time.perf_counter() - t0,
                    "variants": out}))
    return out


def _round_work(fn, budgets: tuple) -> list:
    """One uncounted render with K1's wrapper watched: for each round, the
    rays alive at its start and the bounces they made in it. Fails unless
    the watch saw one round for each of ``budgets``, in order."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    rounds = []
    plain = rc.trace_round

    def watched(state, tris, scal, params, budget, *args, **kw):
        alive = int((state[rc._C_DONE] == 0).sum())
        depth = state[rc._C_DEPTH].double().sum()
        out = plain(state, tris, scal, params, budget, *args, **kw)
        made = int(out[rc._C_DEPTH].double().sum() - depth)
        rounds.append({"budget": budget, "alive": alive, "bounces": made,
                       "lane_use": made / max(alive * budget, 1)})
        return out

    rc.trace_round = watched
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        rc.trace_round = plain
    assert [r["budget"] for r in rounds] == list(budgets), (
        "K1's wrapper was not watched round by round", rounds, budgets)
    return rounds


def phase_tuned_sweep() -> dict:
    """Phase 24: tuned.py's constants (CLUSTER_THRESHOLD, CLUSTER_SIZE,
    MANUAL_CLUSTER_SIZE, SMALL_BUDGET_FRACS) and the native_rng and
    pair_batch defaults, measured at N_RAYS rays a render; no constant is
    changed. Returns each group's rows."""
    from audiorenderingv2_tpu_torch import multi, tuned
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.examples import demo_6_multipose as d6

    t0 = time.perf_counter()
    smi = _smi_line()
    cases = _sweep_cases()
    out = {}

    def rows_want(case):
        n = len(tuned.round_budgets_for(case.params.max_bounces))
        return {"trace_round": n, "trace_round_sched": False,
                "histogram_binned": 1}

    def sched_want(case):
        n = case.params.max_bounces
        return {"tile_schedule": n, "trace_round_sched": n,
                "trace_round": False, "histogram_binned": 1}

    def k5_want(case):
        return {"trace_traverse": case.params.max_bounces,
                "trace_round_sched": False, "histogram_binned": 1}

    # The route crossover: K1 over every row against schedule + K2 in
    # clusters of 32, on each scene; the default is auto_options' route.
    variants = []
    for name in ("icosphere_320", "demo5", "icosphere_1280",
                 "icosphere_5120", "office"):
        case = cases[name]
        rows_default = case.scene.n_triangles < tuned.CLUSTER_THRESHOLD
        variants.append(_sweep_variant(
            name, "rows (K1)", _sweep_route(case)[0], rows_want(case),
            SWEEP_OFFICE_ROWS_REPS if name == "office" else None,
            default=rows_default))
        variants.append(_sweep_variant(
            name, f"clusters of {tuned.CLUSTER_SIZE}, schedule + K2",
            _sweep_route(case, tuned.CLUSTER_SIZE)[0], sched_want(case),
            default=not rows_default))
    out["crossover"] = _sweep(
        "crossover", variants, smi,
        extra=lambda v: {"triangles": cases[v["scene"]].scene.n_triangles,
                         "bounces": cases[v["scene"]].params.max_bounces})

    # Cluster size: schedule + K2 at 16 / 32 / 64 / 128, and K5 (the
    # renderer with explicit options) at 32 and 128.
    variants = []
    for name in ("icosphere_5120", "office"):
        case = cases[name]
        for cs in SWEEP_CLUSTER_SIZES:
            variants.append(_sweep_variant(
                name, f"schedule + K2, clusters of {cs}",
                _sweep_route(case, cs)[0], sched_want(case),
                default=cs == tuned.CLUSTER_SIZE))
    for cs in (tuned.CLUSTER_SIZE, tuned.MANUAL_CLUSTER_SIZE):
        variants.append(_sweep_variant(
            "office", f"K5, clusters of {cs}",
            _sweep_route(cases["office"], cs, schedule=False)[0],
            k5_want(cases["office"])))
    out["cluster_size"] = _sweep("cluster_size", variants, smi)

    # The rows route's budgets on the box at 100 bounces; each round's
    # alive rays and the share of its lanes' bounces made.
    box = cases["box"]
    variants = []
    for b in SWEEP_BUDGETS:
        fn = _sweep_route(box, round_budgets=b)[0]
        v = _sweep_variant("box", f"budgets {b}", fn,
                           {"trace_round": len(b), "histogram_binned": 1},
                           default=b == tuned.round_budgets_for(
                               box.params.max_bounces))
        v["rounds"] = _round_work(fn, b)
        variants.append(v)
    out["budgets"] = _sweep("budgets", variants, smi,
                            extra=lambda v: {"rounds": v["rounds"]})

    # native_rng on and off (K4 makes the directions: another stream).
    variants = []
    for name, cs in (("box", None), ("office", tuned.CLUSTER_SIZE)):
        case = cases[name]
        want = rows_want(case) if cs is None else sched_want(case)
        for native in (False, True):
            variants.append(_sweep_variant(
                name, f"native_rng={native}",
                _sweep_route(case, cs, native_rng=native)[0],
                {**want, "init_state": 1 if native else False},
                default=not native))
    out["native_rng"] = _sweep("native_rng", variants, smi, bar="stream")

    # pair_batch on demo 6's 2 x 4 x 1M-ray matrix (its options, rounds
    # (8, 32)); render_ir_matrix returns on the host.
    sc6 = tracer.scene_to_arrays(d6.scene(), 128, device="cuda")
    p6 = d6.trace_params()
    n6 = d6.n_rays("cuda")
    pairs = len(d6.EMITTERS) * len(d6.LISTENERS)
    variants = []
    for pb in SWEEP_PAIR_BATCHES:
        def matrix(pb=pb):
            return multi.render_ir_matrix(sc6, d6.SEED, d6.EMITTERS,
                                          d6.LISTENERS, d6.YAWS, n6, p6,
                                          d6.OPTS, pair_batch=pb)
        calls = -(-pairs // pb) * len(d6.OPTS.round_budgets)
        want = ({"trace_round": pairs * len(d6.OPTS.round_budgets),
                 "trace_round_posed": False} if pb == 1 else
                {"trace_round_posed": calls, "trace_round": False})
        variants.append(_sweep_variant(
            "demo6_matrix", f"pair_batch={pb}", matrix,
            {**want, "histogram_binned": True},
            default=pb == SWEEP_PAIR_BATCHES[0]))
    out["pair_batch"] = _sweep("pair_batch", variants, smi)
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return out


KEY_BYTES_PER_RAY = 44  # the key kernel: 3 floats read by its bounds
#                        pass, 7 read and an int32 written by its key pass


def _posed_cluster_rounds(state, rows, boxes, scal, params, p: int, k: int):
    """``k`` posed clustered rounds through the kernels: schedule, K2 with a
    scalar row per pose, the per-pose sort."""
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc
    from audiorenderingv2_tpu_torch.ops import schedule_cuda as sc

    for _ in range(k):
        state = sc.trace_round_sched(state, rows, boxes,
                                     sc.tile_schedule(state, boxes), scal,
                                     params, state.shape[1] // p)
        state = rc._sort_state_by_keys(
            state, rc.compaction_keys(state, n_poses=p), p)
    return state


def _key_states(params) -> dict:
    """Office states at ``params``' bounces, keyed (n_poses, name): the
    start state and the states after 1, 16 and 64 bounces, at 1,000,064
    rays (1,000,000 real) and at 4 x 250,112 (250,000 real a pose)."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    dev = torch.device("cuda")
    _, _, rows, boxes = _office_clustered()
    start, scal = _office_start(N_RAYS, 21, params)
    p, n = 4, OFFICE_MATRIX_RAYS
    em = torch.zeros((p, 3), device=dev)
    e0 = params.base_power / (n * constants.SPHERE_VOLUME)
    posed = rc.init_state(_pose_directions(2, p, n, dev), em, e0,
                          -(-n // 128) * 128)
    pscal = rc.scalars(em, torch.from_numpy(OFFICE_LISTENERS).to(dev),
                       torch.from_numpy(MULTI_YAWS).to(dev), e0, params)
    out = {}
    for n_poses, st in ((1, start), (p, posed)):
        done = 0
        for k in (0, 1, 16, 64):
            if n_poses == 1:  # K2 works in place: each state its copy
                st = _cluster_rounds(st.clone(), rows, boxes, scal, params,
                                     k - done)
            else:
                st = _posed_cluster_rounds(st.clone(), rows, boxes, pscal,
                                           params, p, k - done)
            done = k
            out[n_poses, "start" if k == 0 else f"after{k}"] = st
    return out


def phase_keys() -> dict:
    """Phase 25: the key kernel against the plain chain on office states;
    returns its JSON entry's numbers."""
    from audiorenderingv2_tpu_torch import context, testing
    from audiorenderingv2_tpu_torch.ops import raytrace_cuda as rc

    t0 = time.perf_counter()
    params = dataclasses.replace(_office_params(), max_bounces=MAX_BOUNCES)
    states = _key_states(params)
    for (p, name), st in states.items():
        n_done = int((st[rc._C_DONE] != 0).sum())
        for cell_bits in (3, 5, 7):
            what = (f"keys, office, {p} pose(s) x {st.shape[1] // p} rays, "
                    f"{name}, cell_bits {cell_bits}")
            got = rc.compaction_keys(st, cell_bits, p)
            want = rc._compaction_keys(st, cell_bits, p)
            n_diff = int((got != want).sum())
            assert n_diff == 0, f"{what}: {n_diff} keys differ"
            srt_k = rc._sort_state_by_keys(st, got, p)
            srt_p = rc._sort_state_by_keys(st, want, p)
            assert torch.equal(srt_k.view(torch.int32),
                               srt_p.view(torch.int32)), f"{what}: sort"
            log(f"{what}: equal to the plain keys ({len(torch.unique(got))} "
                f"distinct; {n_done} rays done), sorted states bit-identical")
    out = {}
    for p, name in ((1, "after16"), (4, "after16")):
        st = states[p, name]
        ms = median_ms(lambda: rc.compaction_keys(st, n_poses=p), 20)
        dev_ms = device_ms(lambda: rc.compaction_keys(st, n_poses=p))
        plain_ms = median_ms(lambda: rc._compaction_keys(st, n_poses=p), 10)
        reorder_ms = median_ms(lambda: rc._sort_state_by_keys(
            st, rc.compaction_keys(st, n_poses=p), p), 10)
        b = bound(KEY_BYTES_PER_RAY * st.shape[1], 0)
        row = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **b,
               "library_ms": None, "keys_and_sort_ms": reorder_ms,
               "rays": st.shape[1], "n_poses": p}
        log(f"keys, office, {p} pose(s), {st.shape[1]} rays, {name}: a call "
            f"{ms:.4f} ms, device {dev_ms:.4f} ms, plain chain "
            f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms (bytes, "
            f"{dev_ms / b['bound_ms']:.1f}x); keys + sort + gather "
            f"{reorder_ms:.3f} ms")
        out["one_pose" if p == 1 else "four_poses"] = row
    with tempfile.TemporaryDirectory() as tmp:
        testing.write_obj(Path(tmp) / "office.obj",
                          *testing.office_mesh(OFFICE_TRIS))
        cfg = _write_inputs(Path(tmp), "office.obj", OFFICE_RECEIVER,
                            MAX_BOUNCES)
        ctx = context.load_context(cfg, device="cuda")
        _reset_launches()
        ctx.renderer.render()
        torch.cuda.synchronize()
        launches = _read_launches()
    assert launches["compaction_keys"] == MAX_BOUNCES - 1, launches
    assert launches["trace_round_sched"] == MAX_BOUNCES, launches
    log(f"office render at {MAX_BOUNCES} bounces: key kernel called "
        f"{launches['compaction_keys']} times (two launches each); phase "
        f"{time.perf_counter() - t0:.1f} s")
    return {**out.pop("one_pose"), "four_poses": out["four_poses"],
            "launches": launches["compaction_keys"]}


REPLAY_RAYS = 1_000_064  # the fit's 1M rays, padded as the recorder pads
REPLAY_BANDS = (1, 4, 8)
# The kernel pair's gradient against the chain's autograd: both add float32
# values into each table entry in an order the atomics choose (the chain's
# index_add_ ray by ray, the kernel by warp, block and grid), a shell row
# taking some 10^6 terms, so the two sums part by rounding that grows with
# the terms: an entry may differ by GRAD_RTOL of its float64 value plus
# GRAD_ATOL of the table's largest.
REPLAY_GRAD_RTOL = 1e-3
REPLAY_GRAD_ATOL = 1e-6


def _replay_bound(ids, recv, n_bands: int, n_tris: int) -> dict:
    """Bytes of the pair at 3.35 TB/s: the depositing rays' rows of tri_ids
    up to recv_step, the directions and recv_step, the events and chord
    written (forward); the rows, recv_step, chord and g read and the table
    written (backward)."""
    n = ids.shape[0]
    dep = recv[recv > 0]
    rows = 4 * int(dep.double().sum())
    fwd = rows + n * (12 + 4) + n * (4 + 4 * n_bands + 4 + 4)
    bwd = rows + n * (4 + 4 + 4 * n_bands) + 4 * n_tris * n_bands
    return {"fwd": bound(fwd, 0), "bwd": bound(bwd, 0),
            "depositing": int(dep.numel()),
            "mean_recv_step": float(dep.double().mean())}


def phase_replay() -> dict:
    """Phase 26: the replay's kernel pair against the eager chain on
    recorded office paths at 1, 4 and 8 bands; returns its JSON entry's
    numbers."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.diff import replay
    from audiorenderingv2_tpu_torch.ops import replay_cuda as rpc

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    params = _grad_params(MAX_BOUNCES)
    _, scc, rows, boxes = _office_clustered()
    d = torch.from_numpy(unit_dirs(REPLAY_RAYS, 26)).to(dev)
    ids, recv = replay.record_paths_kernels(
        scc, d, EMITTER, OFFICE_RECEIVER, 0.0, params,
        tracer.TracerOptions(schedule=True), rows=rows, boxes=boxes)
    torch.cuda.synchronize()
    log(f"replay: office paths recorded, {REPLAY_RAYS} rays x {MAX_BOUNCES} "
        f"bounces, {int((recv >= 0).sum())} reach the receiver, "
        f"{int((recv == 0).sum())} at step 0, last at step "
        f"{int(recv.max())}")
    e0 = params.base_power / (REPLAY_RAYS * constants.SPHERE_VOLUME)
    bin_rate = params.sample_rate / constants.SPEED_OF_SOUND
    emitter = torch.tensor(EMITTER, device=dev)
    receiver = torch.tensor(OFFICE_RECEIVER, device=dev)
    yaw = torch.deg2rad(torch.tensor(0.0, device=dev))
    sin_y, cos_y = torch.sin(yaw), torch.cos(yaw)
    scal = torch.cat([emitter, receiver, sin_y[None], cos_y[None]])
    gen = torch.Generator(device=dev)
    out = {}
    for nb in REPLAY_BANDS:
        # Each band its own absorption, 0.5 to 1.5 times the scene's.
        a0 = (scc.absorption[:, None]
              * torch.linspace(0.5, 1.5, nb, device=dev)).contiguous()
        p_nb = dataclasses.replace(params, n_bands=nb)
        gen.manual_seed(nb)
        w = torch.rand((REPLAY_RAYS, nb), device=dev, generator=gen) + 0.5
        what = f"replay, office, {REPLAY_RAYS} rays x {MAX_BOUNCES}, {nb} band(s)"

        def run(fixed: bool):
            a = a0.clone().requires_grad_(True)
            rec = receiver.clone().requires_grad_(not fixed)
            ev = replay.replay_events(scc._replace(absorption=a), ids, recv,
                                      d, emitter, rec, 0.0, p_nb)
            (ev[1] * w).sum().backward()
            return ev, a.grad

        _reset_launches()
        ev_k, g_k = run(True)
        torch.cuda.synchronize()
        launches = _read_launches()
        assert launches["replay"] == launches["replay_bwd"] == 1, launches
        ev_c, g_c = run(False)
        torch.cuda.synchronize()
        assert _read_launches()["replay"] == 1, "the chain launched the kernel"
        assert torch.equal(ev_k[0], ev_c[0]), f"{what}: ev_bin differs"
        assert torch.equal(ev_k[2], ev_c[2]), f"{what}: ev_ear differs"
        w_rel = float(((ev_k[1] - ev_c[1]).detach().abs()
                       / ev_c[1].abs().clamp(min=1e-30)).max())
        w_bits = bool(torch.equal(ev_k[1].detach(), ev_c[1].detach()))
        assert w_rel <= 1e-6, f"{what}: ev_w {w_rel:.3e} relative"
        # The same gradient in float64 from the plain backward on the card.
        ch = rpc.replay(ids, recv, d, scal, scc.plane_n, scc.plane_d,
                        scc.normal, a0, e0, bin_rate)[3]
        g_64 = rpc.replay_bwd_plain(ids, recv, ch.double(), w.double(),
                                    a0.double(), e0)
        top = float(g_64.abs().max())

        def gap(g):
            return float(((g.double() - g_64).abs()
                          / (g_64.abs() + top * 1e-30)).max()), \
                float((g.double() - g_64).abs().max() / top)

        (k_rel, k_abs), (c_rel, c_abs) = gap(g_k), gap(g_c)
        tol = REPLAY_GRAD_RTOL * g_64.abs() + REPLAY_GRAD_ATOL * top
        assert bool(((g_k.double() - g_c.double()).abs() <= tol).all()), (
            f"{what}: kernel and chain gradients part beyond the bar")
        assert bool(((g_k.double() - g_64).abs() <= tol).all()), (
            f"{what}: kernel gradient off float64 beyond the bar")
        args = (ids, recv, d, scal, scc.plane_n, scc.plane_d, scc.normal, a0,
                e0, bin_rate)
        fwd_ms = device_ms(lambda: rpc.replay(*args))
        bwd_ms = device_ms(lambda: rpc.replay_bwd(ids, recv, ch, w, a0, e0))

        def pair():
            a = a0.clone().requires_grad_(True)
            ev = rpc.replay_absorption(a, ids, recv, d, scal, scc.plane_n,
                                       scc.plane_d, scc.normal, e0, bin_rate)
            (ev[1] * w).sum().backward()

        def chain():
            a = a0.clone().requires_grad_(True)
            ev = rpc.chain_events(scc.plane_n, scc.plane_d, scc.normal, a,
                                  ids, recv, d, emitter, receiver, sin_y,
                                  cos_y, e0, bin_rate)
            (ev[1] * w).sum().backward()

        pair_ms = median_ms(pair, 5)
        chain_ms = median_ms(chain, 3)
        b = _replay_bound(ids, recv, nb, a0.shape[0])
        n_tris = a0.shape[0]
        path = ("shared" if n_tris * nb * 4 <= torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin else "global")
        row = {"fwd_device_ms": fwd_ms, "bwd_device_ms": bwd_ms,
               "fwd_bound_ms": b["fwd"]["bound_ms"],
               "bwd_bound_ms": b["bwd"]["bound_ms"], "bound_by": "bytes",
               "pair_ms": pair_ms, "chain_ms": chain_ms,
               "ev_w_bit_equal": w_bits, "ev_w_max_rel": w_rel,
               "grad_kernel_vs_f64": [k_rel, k_abs],
               "grad_chain_vs_f64": [c_rel, c_abs],
               "bwd_reduction": path, "depositing": b["depositing"],
               "mean_recv_step": b["mean_recv_step"]}
        log(f"{what}: ev_bin and ev_ear equal to the chain's, ev_w "
            f"{'bit for bit' if w_bits else f'within {w_rel:.2e}'}; the "
            f"table's gradient against float64: kernel {k_rel:.2e} relative "
            f"at worst ({k_abs:.2e} of the largest), chain {c_rel:.2e} "
            f"({c_abs:.2e}); device time forward {fwd_ms:.4f} ms (bound "
            f"{b['fwd']['bound_ms']:.4f}), backward {bwd_ms:.4f} ms (bound "
            f"{b['bwd']['bound_ms']:.4f}, {path} reduction); forward + "
            f"backward through autograd {pair_ms:.3f} ms, the chain's "
            f"{chain_ms:.1f} ms; {b['depositing']} rays deposit after "
            f"{b['mean_recv_step']:.1f} steps on average")
        out[f"bands{nb}"] = row
    log(f"replay phase {time.perf_counter() - t0:.1f} s")
    return out


# The source localization's receivers (perfbench/configs/office_locate.json).
LOCATE_RECEIVERS = (OFFICE_RECEIVER, (-6.0, 4.0, -5.0), (5.0, 4.0, 6.0))
# The pose pair's emitter gradient against its plain version's on the card,
# summed in float64 from the kernel's own tangents: the kernel adds some
# 10^5 float32 terms a receiver by thread, warp, block and grid, so the two
# sums part by rounding, as a relative L2 gap of the [3] gradient. The
# tangents themselves against the plain version's (the same arithmetic in
# the same order): TAN_BAR of each entry's magnitude plus of the column's
# largest, since the card may contract nothing but PyTorch's own kernels
# may order a reduction otherwise.
POSE_GRAD_BAR = 1e-4
POSE_TAN_BAR = 1e-5


def _pose_events(ids, recv, d, scal, scc, a0, e0, bin_rate, what: str):
    """The pose kernel's events against the plain version's on the card:
    the events and chord equal to the absorption kernel's bit for bit, and
    the tangents within the bar. Returns (the kernel's outputs, the
    tangents' largest gap)."""
    from audiorenderingv2_tpu_torch.ops import replay_cuda as rpc

    args = (ids, recv, d, scal, scc.plane_n, scc.plane_d, scc.normal, a0,
            e0, bin_rate)
    got = rpc.replay(*args, pose=True)
    plain = rpc.replay_plain(*args, tangents=True)
    absorb = rpc.replay(*args)
    for k, name in enumerate(("ev_bin", "ev_w", "ev_ear", "chord")):
        assert torch.equal(got[k], absorb[k]), (
            f"{what}: the pose kernel's {name} differs from the absorption "
            f"kernel's")
        assert torch.equal(got[k], plain[k]), (
            f"{what}: the pose kernel's {name} differs from its plain "
            f"version's")
    dep = got[3] != 0
    tk, tp = got[4][dep].double(), plain[4][dep].double()
    top = tp.abs().amax(0)
    gap = float(((tk - tp).abs() / (tp.abs() + top)).max())
    assert gap <= POSE_TAN_BAR, f"{what}: tangents {gap:.2e} off the plain"
    assert bool(torch.isfinite(tk).all()) and not bool(got[4][~dep].any())
    return got, gap


def _pose_fit(scene, scc, d, params, per) -> dict:
    """The pose pair on its own entry point: 3 steps of
    ``fit_scene_parameters(fit_emitter=True, method="replay")`` over the
    source localization's three receivers at full width, to the replayed
    IRs of the true emitter's recorded paths, from 0.64 m off it; asserts
    that each step launches the pose pair once a receiver and neither the
    absorption pair nor the eager chain. Returns the fit's launches."""
    from audiorenderingv2_tpu_torch.diff import (fit_scene_parameters,
                                                 render_ir_replay)
    from audiorenderingv2_tpu_torch.ops import replay_cuda as rpc

    with torch.no_grad():
        target = torch.stack([
            render_ir_replay(scc, ids, recv, d, EMITTER, rec, 0.0, params)
            for _, ids, recv, rec, _ in per])
    steps, chain = 3, []
    chain_events = rpc.chain_events

    def spy(*a, **k):
        chain.append(1)
        return chain_events(*a, **k)

    start = np.asarray(EMITTER, np.float32) + np.float32([0.4, -0.3, 0.4])
    _reset_launches()
    rpc.chain_events = spy
    try:
        t0 = time.perf_counter()
        res = fit_scene_parameters(
            scene, target, params, steps=steps, learning_rate=0.03,
            fit_emitter=True, init_emitter=start,
            receiver_pos=np.asarray(LOCATE_RECEIVERS, np.float32),
            init_absorption=0.5, smooth_radius=8, method="replay",
            replay_refresh=25, device="cuda", directions=d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rpc.chain_events = chain_events
    fl = _read_launches()
    log(f"replay_pose, fit_scene_parameters(fit_emitter=True, "
        f"method='replay') over the three receivers, {REPLAY_RAYS} rays: "
        f"{steps} steps in {wall:.2f} s, losses "
        f"{[float(f'{x:.6e}') for x in res.losses]}, emitter from "
        f"{start.tolist()} to {res.params['emitter'].tolist()}; pose pair "
        f"launches {fl['replay_pose']} forward, {fl['replay_pose_bwd']} "
        f"backward; the absorption pair {fl['replay']}, "
        f"{fl['replay_bwd']}; the chain {len(chain)} calls")
    n = steps * len(LOCATE_RECEIVERS)
    assert fl["replay_pose"] == fl["replay_pose_bwd"] == n, fl
    assert fl["replay"] == fl["replay_bwd"] == 0 and not chain, (fl, chain)
    assert len(res.losses) == steps and np.isfinite(res.losses).all()
    return {"replay_pose": fl["replay_pose"],
            "replay_pose_bwd": fl["replay_pose_bwd"], "steps": steps}


def phase_replay_pose() -> dict:
    """Phase 28: the pose pair (the replay that carries the emitter's
    tangents) against its plain version on recorded office paths at
    1,000,064 rays x 100 bounces, for one receiver and for the source
    localization's three; returns its JSON entry's numbers."""
    from audiorenderingv2_tpu_torch import constants
    from audiorenderingv2_tpu_torch.core import tracer
    from audiorenderingv2_tpu_torch.diff import replay
    from audiorenderingv2_tpu_torch.ops import replay_cuda as rpc
    from perfbench import replay_bytes, replay_pose_bytes

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    params = _grad_params(MAX_BOUNCES)
    scene, scc, rows, boxes = _office_clustered()
    d = torch.from_numpy(unit_dirs(REPLAY_RAYS, 28)).to(dev)
    e0 = params.base_power / (REPLAY_RAYS * constants.SPHERE_VOLUME)
    bin_rate = params.sample_rate / constants.SPEED_OF_SOUND
    emitter = torch.tensor(EMITTER, device=dev)
    a0 = scc.absorption[:, None].contiguous()
    n_tris = a0.shape[0]
    gen = torch.Generator(device=dev)
    per, fwd_ms, bwd_ms, abs_ms = [], [], [], []
    counts = {"deposits": 0, "steps": 0}
    for r, rec in enumerate(LOCATE_RECEIVERS):
        what = f"replay_pose, office, receiver {rec}"
        ids, recv = replay.record_paths_kernels(
            scc, d, EMITTER, rec, 0.0, params,
            tracer.TracerOptions(schedule=True), rows=rows, boxes=boxes)
        receiver = torch.tensor(rec, device=dev)
        scal = torch.cat([emitter, receiver, torch.zeros(1, device=dev),
                          torch.ones(1, device=dev)])
        got, tan_gap = _pose_events(ids, recv, d, scal, scc, a0, e0,
                                    bin_rate, what)
        dep = recv[recv >= 0].long()
        counts["deposits"] += int(dep.numel())
        counts["steps"] += int(dep.sum())
        gen.manual_seed(28 + r)
        g_bin = torch.randn((REPLAY_RAYS,), device=dev, generator=gen)
        g_w = torch.rand((REPLAY_RAYS, 1), device=dev, generator=gen) + 0.5
        ev_w, chord, tan = got[1], got[3], got[4]
        grad_a, grad_e = rpc.replay_bwd(ids, recv, chord, g_w, a0, e0,
                                        pose=(g_bin, ev_w, tan))
        ref_a, ref_e = rpc.replay_bwd_plain(
            ids, recv, chord.double(), g_w.double(), a0.double(), e0,
            pose=(g_bin.double(), ev_w.double(), tan.double()))
        e_gap = float((grad_e.double() - ref_e).norm() / ref_e.norm())
        assert e_gap <= POSE_GRAD_BAR, f"{what}: emitter gradient {e_gap:.2e}"
        top = float(ref_a.abs().max())
        a_gap = float((grad_a.double() - ref_a).abs().max() / top)
        assert a_gap <= REPLAY_GRAD_ATOL + REPLAY_GRAD_RTOL, (
            f"{what}: table gradient {a_gap:.2e} of the largest")
        only_e = rpc.replay_bwd(ids, recv, chord, g_w, a0, e0,
                                pose=(g_bin, ev_w, tan), table=False)
        assert only_e[0] is None
        e_only_gap = float((only_e[1].double() - ref_e).norm() / ref_e.norm())
        assert e_only_gap <= POSE_GRAD_BAR, what
        # The chain's autograd on the card: the same emitter gradient.
        em = emitter.clone().requires_grad_(True)
        ev_c = rpc.chain_events(scc.plane_n, scc.plane_d, scc.normal, a0, ids,
                                recv, d, em, receiver, scal[6], scal[7], e0,
                                bin_rate)
        ((ev_c[0] * g_bin).sum() + (ev_c[1] * g_w).sum()).backward()
        c_gap = float((em.grad.double() - ref_e).norm() / ref_e.norm())
        args = (ids, recv, d, scal, scc.plane_n, scc.plane_d, scc.normal, a0,
                e0, bin_rate)
        f_ms = device_ms(lambda: rpc.replay(*args, pose=True))
        b_ms = device_ms(lambda: rpc.replay_bwd(
            ids, recv, chord, g_w, a0, e0, pose=(g_bin, ev_w, tan)))
        ch = rpc.replay(*args)[3]
        af_ms = device_ms(lambda: rpc.replay(*args))
        ab_ms = device_ms(lambda: rpc.replay_bwd(ids, recv, ch, g_w, a0, e0))
        fwd_ms.append(f_ms)
        bwd_ms.append(b_ms)
        abs_ms.append(af_ms + ab_ms)
        bound = replay_pose_bytes.pair_bound_s(1, n_tris, int(dep.numel()),
                                               int(dep.sum())) * 1e3
        row = {"receiver": list(rec), "depositing": int(dep.numel()),
               "mean_recv_step": float(dep.double().mean()),
               "tan_max_gap": tan_gap, "grad_e_vs_f64": e_gap,
               "grad_e_only_vs_f64": e_only_gap, "grad_e_chain_vs_f64": c_gap,
               "grad_a_vs_f64": a_gap, "fwd_device_ms": f_ms,
               "bwd_device_ms": b_ms, "absorption_pair_device_ms":
               af_ms + ab_ms, "pair_bound_ms": bound,
               "grad_e": grad_e.tolist()}
        log(f"{what}: {row['depositing']} rays deposit after "
            f"{row['mean_recv_step']:.1f} steps; events and chord equal to "
            f"the absorption kernel's and the plain version's bit for bit, "
            f"tangents within {tan_gap:.2e} (bar {POSE_TAN_BAR}); emitter "
            f"gradient {grad_e.tolist()} against float64 {e_gap:.2e} (bar "
            f"{POSE_GRAD_BAR}; without the table {e_only_gap:.2e}; the "
            f"chain's autograd {c_gap:.2e}), table {a_gap:.2e}; device "
            f"forward {f_ms:.4f} ms, backward {b_ms:.4f} ms (the absorption "
            f"pair {af_ms + ab_ms:.4f}), bound {bound:.4f} ms "
            f"(replay_pose_bytes, {(f_ms + b_ms) / bound:.1f}x)")
        per.append((row, ids, recv, receiver, scal))
    # The three receivers through autograd, as a fit step runs them.
    w = torch.rand((REPLAY_RAYS,), device=dev, generator=gen)

    def three():
        a = a0.clone().requires_grad_(True)
        em = emitter.clone().requires_grad_(True)
        loss = 0.0
        for _, ids, recv, _, scal in per:
            ev = rpc.replay_pose_pair(a, em, ids, recv, d, scal[3:], scc.plane_n,
                                      scc.plane_d, scc.normal, e0, bin_rate)
            loss = loss + (ev[0] * w).sum() + (ev[1][:, 0] * w).sum()
        loss.backward()
        return em.grad

    _reset_launches()
    three()
    torch.cuda.synchronize()
    launches = _read_launches()
    assert launches["replay_pose"] == launches["replay_pose_bwd"] == 3, \
        launches
    assert launches["replay"] == launches["replay_bwd"] == 0, launches
    three_ms = median_ms(three, 5)
    fit = _pose_fit(scene, scc, d, params, per)
    bound3 = replay_pose_bytes.pair_bound_s(1, n_tris, counts["deposits"],
                                            counts["steps"]) * 1e3
    abs_bound3 = replay_bytes.pair_bound_s(1, n_tris, counts["deposits"],
                                           counts["steps"]) * 1e3
    dev_ms = sum(fwd_ms) + sum(bwd_ms)
    log(f"replay_pose, three receivers: device {dev_ms:.4f} ms (forward "
        f"{sum(fwd_ms):.4f}, backward {sum(bwd_ms):.4f}; the absorption "
        f"pair {sum(abs_ms):.4f}), bound {bound3:.4f} ms (the absorption "
        f"pair's {abs_bound3:.4f}), {100 * bound3 / dev_ms:.2f}% of it; "
        f"through autograd {three_ms:.3f} ms; phase "
        f"{time.perf_counter() - t0:.1f} s")
    first = per[0][0]
    return {"fit": fit, "fwd_device_ms": first["fwd_device_ms"],
            "bwd_device_ms": first["bwd_device_ms"],
            "bound_ms": first["pair_bound_ms"], "bound_by": "bytes",
            "plain_ms": None, "library_ms": None,
            "receivers": [p[0] for p in per],
            "three": {"device_ms": dev_ms, "bound_ms": bound3,
                      "roofline_pct": 100 * bound3 / dev_ms,
                      "autograd_ms": three_ms, **counts}}


# The octave office's crossovers (perfbench/configs/office_octave.json).
OCTAVE_EDGES = (88.4, 176.8, 353.6, 707.1, 1414.2, 2828.4, 5656.9)
OCTAVE_SR = 48000
# (edges, sample rate, rfft bins) of the gains' check: the octave office's
# 5 s signal and 2 s live block, the default 4 bands over the box's 5 s at
# 16 kHz, two crossovers over 3 s at 8 kHz.
BAND_SPLIT_CASES = ((OCTAVE_EDGES, OCTAVE_SR, 120_001),
                    (OCTAVE_EDGES, OCTAVE_SR, 48_001),
                    ((250.0, 1000.0, 4000.0), 16000, 40_001),
                    ((500.0, 2000.0), 8000, 12_001))


def _gain_differences(got: torch.Tensor, want: torch.Tensor, n: int,
                      rate: int) -> list:
    """Each gain where ``got`` and ``want`` (float32 [B, F] on the host)
    differ in any bit: (band, bin, frequency, got, want, ulps apart)."""
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    freqs = np.linspace(0, rate / 2, n)
    return [(b, i, float(freqs[i]), float(got[b, i]), float(want[b, i]),
             int(gi[b, i]) - int(wi[b, i]))
            for b, i in (gi != wi).nonzero().tolist()]


def _band_spectra_plain(spec: torch.Tensor, sample_rate: int,
                        edges) -> torch.Tensor:
    """The band spectra as the plain split forms them: ``band_gains`` in
    numpy, uploaded, and the broadcast product."""
    from audiorenderingv2_tpu_torch.ops import filterbank as fb

    gains = torch.from_numpy(fb.band_gains(spec.shape[0], sample_rate,
                                           edges)).to(spec.device)
    return spec[None, :] * gains


def _assert_band_spectra(got: torch.Tensor, want: torch.Tensor,
                         spec: torch.Tensor, where: str) -> int:
    """The kernel's band spectra ``got`` [B, F] against the plain ones
    ``want`` on the spectrum ``spec`` [F]: each part equal in every bit, or,
    where the card's float64 cos moved a gain g <= 1 by one float32 ulp
    (at most 2^-24), within 4 x 2^-24 of the spectrum's part (the moved
    gain and each side's rounding of the product). Returns the parts that
    differ in any bit."""
    g, w = torch.view_as_real(got), torch.view_as_real(want)
    s = torch.view_as_real(spec)[None].abs()
    same = g.view(torch.int32) == w.view(torch.int32)
    near = (g - w).abs() <= 4 * 2.0 ** -24 * s
    bad = int((~(same | near)).sum())
    assert bad == 0, (f"{where}: {bad} parts of the band spectra lie more "
                      f"than one gain ulp from the plain product")
    return int((~same).sum())


def band_spectra_torch_ops(spec: torch.Tensor, sample_rate: int,
                           edges) -> torch.Tensor:
    """The band spectra with ``band_gains``' definition built from float64
    PyTorch operations on the spectrum's device (about seven a crossover),
    then the broadcast product: the kernel-less variant the band-split
    kernel is measured against."""
    from audiorenderingv2_tpu_torch.ops import filterbank as fb

    n, nyquist = spec.shape[0], sample_rate / 2
    f = torch.arange(n, dtype=torch.float64, device=spec.device) \
        * (nyquist / (n - 1))
    f[-1:].fill_(nyquist)  # a scalar fill: no host copy, so it captures
    lp = []
    for f0 in edges:
        lo, hi = f0 - f0 * fb.TRANSITION, f0 + f0 * fb.TRANSITION
        ramp = ((f - lo) / max(hi - lo, 1e-9)).clamp_(0.0, 1.0)
        lp.append(0.5 * (1.0 + torch.cos(math.pi * ramp)))
    lp = torch.stack(lp)
    gains = torch.cat([lp[:1], lp[1:] - lp[:-1], 1.0 - lp[-1:]])
    return spec[None, :] * gains.float()


def phase_band_split() -> dict:
    """Phase 27: the band-split kernel against band_gains and the plain
    split on the card, and against the same gains built from PyTorch
    operations on the card; returns its JSON entry's numbers."""
    from audiorenderingv2_tpu_torch.ops import filterbank as fb

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gains_check = {}
    for edges, rate, n in BAND_SPLIT_CASES:
        what = f"band split, {len(edges) + 1} bands at {rate} Hz, {n} bins"
        ones = torch.ones(n, dtype=torch.complex64, device=dev)
        got = fb.band_spectra(ones, rate, edges)
        torch.cuda.synchronize()
        re, im = got.real.cpu(), got.imag.cpu()
        want = torch.from_numpy(fb.band_gains(n, rate, edges))
        assert torch.equal(im.view(torch.int32),
                           torch.zeros_like(im).view(torch.int32)), what
        diff = _gain_differences(re, want, n, rate)
        assert all(abs(d[5]) == 1 for d in diff), (what, diff[:8])
        ops = band_spectra_torch_ops(ones, rate, edges).real.cpu()
        n_ops = int((ops.view(torch.int32) != want.view(torch.int32)).sum())
        log(f"{what}: the kernel's gains on a spectrum of ones "
            + ("equal band_gains' bit for bit" if not diff else
               f"differ from band_gains' in {len(diff)} of {want.numel()} "
               f"(band, bin, Hz, kernel, band_gains, ulps): {diff[:16]}")
            + f"; the PyTorch operations' gains differ in {n_ops}")
        gains_check[f"{len(edges) + 1}x{n}"] = len(diff)

    x = torch.from_numpy(np.random.default_rng(27).uniform(
        -1, 1, 5 * OCTAVE_SR).astype(np.float32)).to(dev)
    spec = torch.fft.rfft(x)
    spec_diff = _assert_band_spectra(
        fb.band_spectra(spec, OCTAVE_SR, OCTAVE_EDGES),
        _band_spectra_plain(spec, OCTAVE_SR, OCTAVE_EDGES), spec,
        "band split, 8 bands, 5 s")
    got = fb.split_bands(x, OCTAVE_SR, OCTAVE_EDGES)
    want = fb._split_bands(x, OCTAVE_SR, OCTAVE_EDGES)
    torch.cuda.synchronize()
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    max_diff = float((got - want).abs().max())
    sum_err = float((got.sum(dim=0) - x).abs().max())
    plain_sum_err = float((want.sum(dim=0) - x).abs().max())
    if spec_diff == 0:  # the same spectra through the same irfft
        assert n_diff == 0, f"equal band spectra, {n_diff} samples differ"
    assert sum_err <= 2e-6, sum_err
    log(f"band split, 8 bands, 5 s at {OCTAVE_SR} Hz: the kernel's band "
        f"spectra equal the plain product's in all but {spec_diff} parts "
        f"(those within one gain ulp); its bands "
        + ("equal the plain path's on the card bit for bit" if not n_diff
           else f"differ from the plain path's in {n_diff} samples, at "
           f"most {max_diff:.3e}")
        + f"; the bands sum to the signal within {sum_err:.2e} (bar 2e-6; "
        f"the plain path's {plain_sum_err:.2e})")

    out = {}
    for n_samples, key in ((5 * OCTAVE_SR, "signal_5s"),
                           (2 * OCTAVE_SR, "block_2s")):
        xs = x[:n_samples].contiguous()
        spec = torch.fft.rfft(xs)
        n = spec.shape[0]
        gains = torch.from_numpy(fb.band_gains(n, OCTAVE_SR,
                                               OCTAVE_EDGES)).to(dev)
        dev_ms = device_ms(lambda: fb.band_spectra(spec, OCTAVE_SR,
                                                   OCTAVE_EDGES))
        product_ms = device_ms(lambda: spec[None, :] * gains)
        ops_dev_ms = device_ms(lambda: band_spectra_torch_ops(
            spec, OCTAVE_SR, OCTAVE_EDGES))
        ms = median_ms(lambda: fb.split_bands(xs, OCTAVE_SR, OCTAVE_EDGES),
                       20)
        ops_ms = median_ms(lambda: torch.fft.irfft(band_spectra_torch_ops(
            torch.fft.rfft(xs), OCTAVE_SR, OCTAVE_EDGES), n=n_samples,
            dim=-1), 20)
        plain_ms = median_ms(lambda: fb._split_bands(xs, OCTAVE_SR,
                                                     OCTAVE_EDGES), 10)
        ops_profile = profile_device(lambda: band_spectra_torch_ops(
            spec, OCTAVE_SR, OCTAVE_EDGES), top=3)
        b = bound((len(OCTAVE_EDGES) + 2) * n * 8, 0)
        out[key] = {"device_ms": dev_ms, "product_device_ms": product_ms,
                    "ms": ms, "plain_ms": plain_ms,
                    "torch_ops_device_ms": ops_dev_ms,
                    "torch_ops_ms": ops_ms, **b, "bins": n,
                    "library_ms": None}
        log(f"band split, 8 bands, {n} bins: kernel device {dev_ms:.4f} ms "
            f"(bound {b['bound_ms']:.4f}, bytes, "
            f"{dev_ms / b['bound_ms']:.1f}x), the broadcast product with "
            f"the gains on the card {product_ms:.4f} ms, the gains from "
            f"PyTorch operations and the product {ops_dev_ms:.4f} ms; the "
            f"split a call {ms:.3f} ms, with the PyTorch operations' gains "
            f"{ops_ms:.3f} ms, the plain path's (band_gains in numpy, the "
            f"upload, the product) {plain_ms:.3f} ms; the PyTorch "
            f"operations' gains and product under the profiler: "
            f"{ops_profile}")

    ir = torch.rand((2, 8, 2 * OCTAVE_SR), device=dev) ** 8 * 1e-3
    _reset_launches()
    wet = fb.convolve_file_banded(x, ir, OCTAVE_SR, OCTAVE_EDGES)
    live = fb.convolve_live_banded(x[:2 * OCTAVE_SR], ir, OCTAVE_SR,
                                   OCTAVE_EDGES)
    torch.cuda.synchronize()
    launches = _read_launches()["band_split"]
    assert launches == 2, launches
    assert bool(torch.isfinite(wet).all() and torch.isfinite(live).all())
    log(f"banded file convolution and live block: {launches} band-split "
        f"launches; phase {time.perf_counter() - t0:.1f} s")
    return {**out.pop("signal_5s"), "block_2s": out["block_2s"],
            "gains_differing": gains_check, "spectra_differing": spec_diff,
            "bands_differing": n_diff, "sum_err": sum_err,
            "file_live_launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # Geometry must not run in TF32 anywhere (trouble spot: matmul bits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    import audiorenderingv2_tpu_torch  # noqa: F401  (fails outside the repo)

    kind = phase_device()
    phase_build()
    k3 = phase_histogram()
    k1 = phase_trace()
    k3_box, binned = phase_box_events()
    k3["box_events"] = k3_box
    launches = phase_export()
    cluster = phase_cluster_kernels()
    office = phase_office_export()
    posed = phase_pose_kernels()
    k4 = phase_init()
    multi_launches, k3_posed = phase_multipose()
    k4_launches = phase_native_rng()
    multi_launches.update(phase_banded())
    k3_bwd = phase_histogram_bwd()
    k5 = phase_traverse()
    k5_launches = phase_recording()
    phase_gradient_step()
    fit_launches = phase_trainer()
    k6, k6_posed, k6_posed_launches = phase_group()
    k7 = phase_v1()
    manual = phase_experimentation()
    live = phase_main_mode()
    sharded_out = phase_sharded()
    sharded = sharded_out["launches"]
    demos = phase_demos(sharded_out)
    phase_tuned_sweep()
    keys = phase_keys()
    replay_k = phase_replay()
    band = phase_band_split()
    replay_pose_k = phase_replay_pose()

    def demo_launches(counter: str | None) -> int:
        """The launches of ``counter`` in the first runs of the demos'
        mains (phase 23; demo 5's in phase 22 (a))."""
        return sum(d["launches"][counter] for k, d in demos.items()
                   if counter and k.startswith(("demo", "live")))

    kernels = [
        {"name": "trace_round", "route": "cuda",
         "demo_launches": demo_launches("trace_round"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_round.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:799",
         "launches": launches["trace_round"],
         "main_mode_launches": live["main"]["trace_round"],
         "live_launches": live["live_box"]["launches"]["trace_round"],
         "sharded_launches": sharded["trace_round"], **k1},
        {"name": "histogram", "route": "cuda",
         "demo_launches": demo_launches("histogram"),
         "source": "audiorenderingv2_tpu_torch/csrc/histogram.cu",
         "replaces": "audiorenderingv2_tpu/ops/histogram_pallas.py:59",
         "launches": fit_launches["histogram"],
         "sharded_launches": sharded["histogram"], **k3},
        {"name": "histogram_binned", "route": "cuda",
         "demo_launches": demo_launches("histogram_binned"),
         "source": "audiorenderingv2_tpu_torch/csrc/histogram.cu",
         "replaces": "audiorenderingv2_tpu/ops/histogram_pallas.py:59",
         "launches": launches["histogram_binned"],
         "main_mode_launches": live["main"]["histogram_binned"],
         "live_launches": (live["live_box"]["launches"]["histogram_binned"]
                           + live["live_office"]["launches"]
                           ["histogram_binned"]),
         "sharded_launches": sharded["histogram_binned"], **binned},
        {"name": "trace_round_sched", "route": "cuda",
         "demo_launches": demo_launches("trace_round_sched"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_sched.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:501",
         "launches": office["trace_round_sched"],
         "live_launches": live["live_office"]["launches"]["trace_round_sched"],
         "sharded_launches": sharded["trace_round_sched"],
         **cluster["trace_round_sched"]},
        {"name": "tile_schedule", "route": "cuda",
         "demo_launches": demo_launches("tile_schedule"),
         "source": "audiorenderingv2_tpu_torch/csrc/tile_schedule.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:1103",
         "launches": office["tile_schedule"],
         "live_launches": live["live_office"]["launches"]["tile_schedule"],
         "sharded_launches": sharded["tile_schedule"],
         **cluster["tile_schedule"]},
        {"name": "trace_round_posed", "route": "cuda",
         "demo_launches": demo_launches("trace_round_posed"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_round.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:887",
         "launches": multi_launches["trace_round_posed"],
         "sharded_launches": sharded["trace_round_posed"],
         **posed["trace_round_posed"]},
        {"name": "trace_round_posed_4band", "route": "cuda",
         "demo_launches": demo_launches(None),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_round.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:887",
         "launches": multi_launches["trace_round_posed_4band"],
         **posed["trace_round_posed_4band"]},
        {"name": "histogram_posed", "route": "cuda",
         "demo_launches": demo_launches(None),
         "source": "audiorenderingv2_tpu_torch/csrc/histogram.cu",
         "replaces": "audiorenderingv2_tpu/ops/histogram_pallas.py:59",
         "launches": multi_launches["histogram_posed"], **k3_posed},
        {"name": "trace_round_sched_posed", "route": "cuda",
         "demo_launches": demo_launches("trace_round_sched_posed"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_sched.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:887",
         "launches": multi_launches["trace_round_sched_posed"],
         **posed["trace_round_sched_posed"]},
        {"name": "init_state_native", "route": "cuda",
         "demo_launches": demo_launches("init_state"),
         "source": "audiorenderingv2_tpu_torch/csrc/init_state.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:284",
         "launches": k4_launches, **k4},
        {"name": "histogram_bwd", "route": "cuda",
         "demo_launches": demo_launches("histogram_bwd"),
         "source": "audiorenderingv2_tpu_torch/csrc/histogram.cu",
         "replaces": "audiorenderingv2_tpu/ops/histogram_pallas.py:124",
         "launches": fit_launches["histogram_bwd"],
         "sharded_launches": sharded["histogram_bwd"], **k3_bwd},
        {"name": "trace_traverse", "route": "cuda",
         "demo_launches": demo_launches("trace_traverse"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_traverse.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:547",
         "launches": k5_launches["trace_traverse"], **k5},
        {"name": "trace_round_group", "route": "cuda",
         "demo_launches": demo_launches("trace_round_group"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_group.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:397",
         "launches": manual["group"]["trace_round_group"], **k6},
        {"name": "trace_round_group_posed", "route": "cuda",
         "demo_launches": demo_launches("trace_round_group_posed"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_group.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas_v2.py:887",
         "launches": k6_posed_launches["trace_round_group_posed"],
         **k6_posed},
        {"name": "trace_round_v1", "route": "cuda",
         "demo_launches": demo_launches("trace_round_v1"),
         "source": "audiorenderingv2_tpu_torch/csrc/trace_round.cu",
         "replaces": "audiorenderingv2_tpu/ops/raytrace_pallas.py:452",
         "launches": manual["v1"]["trace_round_v1"], **k7},
        {"name": "compaction_keys", "route": "cuda",
         "demo_launches": demo_launches("compaction_keys"),
         "source": "audiorenderingv2_tpu_torch/csrc/compaction_keys.cu",
         "fuses": "audiorenderingv2_tpu/ops/raytrace_pallas.py:270",
         **keys},
        {"name": "replay", "route": "cuda",
         "demo_launches": demo_launches("replay"),
         "source": "audiorenderingv2_tpu_torch/csrc/replay.cu",
         "fuses": "audiorenderingv2_tpu/diff/replay.py:223",
         "launches": fit_launches["replay"],
         "bwd_launches": fit_launches["replay_bwd"],
         **replay_k.pop("bands1"), **replay_k},
        {"name": "replay_pose", "route": "cuda",
         "demo_launches": demo_launches("replay_pose"),
         "source": "audiorenderingv2_tpu_torch/csrc/replay.cu",
         "fuses": "audiorenderingv2_tpu/diff/replay.py:223",
         "launches": replay_pose_k["fit"]["replay_pose"],
         "bwd_launches": replay_pose_k["fit"]["replay_pose_bwd"],
         **replay_pose_k},
        {"name": "band_split", "route": "cuda",
         "demo_launches": demo_launches("band_split"),
         "source": "audiorenderingv2_tpu_torch/csrc/band_split.cu",
         "fuses": "audiorenderingv2_tpu/ops/filterbank.py:52",
         "launches": multi_launches["band_split_export"], **band},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
