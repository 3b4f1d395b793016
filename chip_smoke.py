#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``haet_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):

1. The card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build every CUDA kernel from ``haet_torch/csrc/`` (one ``nvcc`` per
   source, in parallel) and print the build time and ``ptxas``' register,
   stack and spill report for every kernel.
3. Each kernel at the ShapeNet-Car serving shapes against its plain PyTorch
   version on the card: max abs/rel error against the stated tolerance, the
   kernel's time (CUDA events over back-to-back launches, and the
   profiler's device time per call), the plain version's time and the bound
   (least time the card could take for the same bytes and float32
   operations; for the slice kernels, whose products run in 3xTF32 on the
   tensor cores, the operations at the faster of that rate and float32's).
   The slice kernels run at serve batch 1, the burst's batch of 4 and the
   training batch (``SLICE_TIMED``: device time with the L2 flushed before
   each call, beside the bound and, as context, the float32-FMA bound)
   and, untimed, at ``SLICE_EDGES`` (G 64 at C 16 and 32, ragged N 1, 255,
   257, G 128 and 600 at C <= 32, and widths of the generic kernels up to
   G*C = 16384 and C = 2048); every slice line prints each kernel's grid
   and shared memory per block, and two calls must give bit-identical
   states, m, s and out. One generic edge with the weights
   unscaled (``SLICE_UNSCALED``: logits past 100, where float32 itself
   loses digits) is held to a float64 reference instead, beside the plain
   version's own distance from it. Each Erwin line prints its launch
   shape (a cluster of K CTAs per cloud, shared memory per CTA). The Erwin
   forward is also checked at the serve burst's 32 clouds (timed on the
   device) and, untimed, at the gate's edges (``ERWIN_EDGES``).
3b. The backwards against their plain versions on the card: the Erwin
   block's backward kernel at both car block shapes (dx, dpos and all 14
   parameter gradients, timed, with its bound) and, untimed, at the gate's
   edges, each shape twice to show the results bit-identical; the slice
   backward kernels (``slice_states_bwd``: dx, dWs, dbs, dWa, dba;
   ``deslice_bwd``: those and dstates; at C <= 32 the per-pass kernels in
   float32 (``slice_bwd_f32``: 16 warps of 16-row tiles a block, both
   windows of 32 slices in one sweep at the Darcy preset's G 64) and the
   fused kernel in bf16, one launch per call, the launches
   per call shown by the profiler and checked; the generic ones wider)
   against ``*_bwd_plain``, each gradient within
   ``KERNEL_RTOL`` of its max but the cancelling biases (dbs, dba:
   ``SLICE_BWD_RTOL``), at the padded car shape ``train_b1`` (timed:
   device us per call with the L2 flushed, the CUDA launches per call, the
   bound, the plain version's time; and a one-pass TF32 control, the plain
   version with TF32 matrix
   products, whose distance the tolerances must tell apart) and, untimed,
   at every ``SLICE_EDGES`` entry, two calls bit-identical (at N = 1 the
   gradients through the softmax's derivative are zero in exact arithmetic
   and are printed, not compared); both against float64 at a
   low-temperature C 32 edge (``SLICE_BWD_UNSCALED``); and the slice
   autograd functions (``SliceStatesFn``, ``DesliceFn``) against autograd
   of the plain versions at ``train_b1``.
4. Serve: the car preset (2 layers, n_hidden 256, G 32, 1,757,190 params,
   seeded random weights) on the card with both kernel flags set, exported
   (``haet_torch.export``) for ``x [32186, 7] f32, fx None`` at batch sizes
   (1, 2, 4) and loaded back behind a ``BatchingServer``. Sequential
   requests (``max_delay_s=0``) and a concurrent burst that forms a batch of
   4. Checks shapes, finiteness, agreement with the plain path on the same
   weights and inputs, that the kernel launch counters rose by exactly 2 +
   2 + 24 per forward, and that nothing was routed to a plain version.
5. Profile one eager batch-1 forward: device time by kernel against the
   wall and the host time (the call's return, before the synchronize).
6. Train: the car preset at full width with both flags set takes 5
   ``Trainer.train_step``s (Adam + OneCycle + clip 1.0, the masked car
   loss, train-mode BatchNorm) on a seeded synthetic sample of 32186 points
   padded to the 32768 bucket: replays of one CUDA graph, the trainer's
   default on the card. Checks that the loss and every parameter stay
   finite, that after step 1 every parameter but ``sigma_att`` has a finite
   gradient, that step 1's gradients match the plain path's (both flags off,
   same weights and batch, stepped op by op) leaf by leaf, that the launch
   counters rose by exactly 2 + 2 (slice forwards) + 2 + 2 (their
   backwards) + 24 + 24 (Erwin) per step of the graph's warm-up and
   capture, with no plain route, and that one replay ran exactly those
   kernel calls on the device (``profile_launches``). Prints the step wall
   time, peak device memory and, from one profiled step, the device time
   by kernel and the busy share.
7. Benchmarks: the drivers of ``haet_torch.bench`` and
   ``haet_torch/benchmarks/``, and the copy kernel they time.
   a. ``copy_scale`` (the fifth kernel) at ``[256, 32]`` against
      ``x * 1.000001``: bit-exact after 1 call and after 1050 chained calls,
      and on an unaligned and a tailed view of 8191 elements (its scalar
      route and its float4 route's tail); its time, the plain version's,
      ``torch.mul``'s (``library_ms``) and its bound. Then at
      ``[4096, 4096]`` (64 MiB each way, its wide route): bit-exact, and
      its device time per call beside ``torch.mul``'s and the bound
      (record keys ``large_*``).
   b. The Erwin forward and backward kernels against the plain block (out,
      dx, dpos, every parameter gradient), timed, at the drivers' block
      shapes: the micro driver's (8 clouds of 32, C 32, 4 heads, SwiGLU
      128) and bench_flags' two (C 32, 4 heads, ball 32, SwiGLU 64; n 16,
      C 64, 8 heads, ball 16, SwiGLU 128), with their device time per call.
      The car uses 8 heads and SwiGLU 4C throughout. Records gain
      ``micro_*``, ``flags_n32_c32_*`` and ``flags_n16_c64_*``.
   c. ``slice_states``/``deslice`` against their plain versions, untimed,
      at ``[1, 8, 2**20, 32]``, the memory probes' size, two calls
      bit-identical.
   d. ``micro_erwin_fused`` with reduced windows: the copy counter rises by
      exactly the chained calls the driver made, the Erwin counters by
      exactly the fused lines' calls, and no block takes the plain route.
   e. ``bench_flags`` with 1 round of 1/3 steps, dispatched and as CUDA
      graphs: per step, exactly 2 + 2 slice launches and 2 + 2 of their
      backwards for ``pallas-tokenizer``, one forward and one backward
      launch per Erwin block (12) for ``pallas-erwin``, none for
      ``baseline``, and no plain route, from the launch counters for the
      dispatched steps and from the profiler for the replayed ones; then
      ``pallas-tokenizer`` alone at ``--slice_num 128`` (G*C 4096), with
      the same counts.
   f. ``haet_torch.bench``, 2 rounds: a finite throughput and MFU, both
      strategies' seconds per step, the better one reported.
   g. One ``mem_sweep`` probe per path at N = 2**20, forward only, each in
      a fresh process: the slice-kernel path's peak memory must be below
      the plain path's, and its probe must count 1 + 1 slice launches.
   h. ``bench_loop_diag`` (dispatched, graph with the input tied to the
      loss, graph with a constant input) at windows of 1 and 3 steps, and
      ``profile_step`` at 1/2 calls: finite windows, a graph wall per line.

8. The car preset's training run.
   a. ``Trainer.fit`` at full width (1,757,190 params, both kernel flags,
      ``shapenet_car_train_config()`` with early stopping armed) over
      ``car_like(n=4, npts=32186, seed=0)``, each sample padded to its
      2048 bucket: 3 for training, 1 held out; 3 epochs, eval every epoch,
      a ``Checkpointer`` in a temporary directory; the steps replay one
      CUDA graph per bucket. Checks finite losses, ``best`` and ``last``
      written, the launch counters risen by exactly 2 + 2 + 2 + 2 + 24 +
      24 per step of each graph's warm-up and capture and 2 + 2 + 24 per
      eval forward, no plain route; ``last`` restored on the CPU equal to
      the card's model; a run stopped by ``stop_event`` after epoch 1 and
      resumed through a fresh ``Trainer`` (its epoch profiled: exactly 2 +
      2 + 2 + 2 + 24 + 24 kernel calls on the device per step and warm-up
      step, 2 + 2 + 24 per eval forward) ends within 1e-5 of each leaf's
      max of the unbroken run (printed: whether bit-identical). Prints the
      per-epoch wall, ``fit``'s wall per step against bare ``train_step``s
      on the same batches (graphs captured before the timed region), and
      the peak device memory.
   b. ``python -m haet_torch.benchmarks.car_train --epochs 2`` at full
      width on the synthetic stand-in, in a subprocess, then
      ``car_eval --which last`` on its checkpoints (2 + 2 + 24 launches
      per forward): every metric finite, ``car_eval`` equal to
      ``car_train``'s final metrics at rtol 1e-5; ``time_per_sample``.

9. The car train step as CUDA graphs against the eager step
   (``Trainer(..., eager=True)``), the car preset at full width with both
   kernel flags, ``cycle_momentum`` on.
   a. Two trainers from the same weights take 6 steps over two buckets in
      turns (30720 and 32768 points, so the graphs switch): at every step
      the metrics, and the lr and beta1 that the step applied, within
      ``GRAPH_RTOL`` = 1e-6 (printed: whether bit-identical); after them
      every parameter, BatchNorm statistic and counter, Adam state, lr and
      beta1 within 1e-6 of its max.
   b. One replay's kernel calls from the profiler: exactly 2 + 2 + 2 + 2
      + 24 + 24, no plain route; the same replay twice from one state
      (restored in place) bit-identical.
   d. The eager trainer's checkpoint of step 3 restored into both (the
      training state keeps its storage), then 3 more steps: equal again,
      and no new graph captured.
   e. Each trainer's step wall (median of 12), device time, kernels per
      step, busy share, and memory: the resident state, the graphs' pool
      and the eager step's temporaries.
   c. ``train_steps`` of 5 batches (one graph of 5 steps) against 5
      graphed ``train_step``s from the same weights: equal metrics and
      state.

10. bf16, as the JAX package runs the car preset on its accelerator.
   a. The four kernels on the path with bf16 ``x_proj`` / ``states`` /
      ``g_out`` (slice, at ``train_b1`` and ``serve_b1``) and bf16 ``x``,
      ``pos``, ``dout`` (Erwin, both car block shapes) against their plain
      versions on the same inputs: bf16 outputs within ``BF16_RTOL`` (one
      bf16 ulp of max), float32 ones (``m``, ``s``, the float32 states
      residual, every parameter gradient) as in phases 3 and 3b, the public
      states the float32 ones rounded, two calls bit-identical, each
      wrapper call running its kernels and no other kernel (no cast); the
      device us per call beside the float32 kernels' on the same values,
      and bounds from the bf16 bytes and the tensor-core passes each
      product's operand types need.
   b. The bf16 car model (phase 4's weights) exported and served as in
      phase 4: 2 + 2 + 24 launches per forward, no plain route, the answer
      the bf16 program's output widened exactly, within
      ``BF16_SERVE_RTOL`` of the float32 model; the eager batch-1
      forward's wall, host and device time beside phase 5's.
   c. Phase 9a, 9b, 9d and 9e with the bf16 model and ``mu_bf16``: graphed
      equal to eager within ``GRAPH_RTOL``, a replay's calls exactly 2 + 2
      + 2 + 2 + 24 + 24 and every one a bf16 instantiation, a restore
      keeping the bf16 first moments' dtype and storage, the walls, device
      time, kernels, busy share and memory beside phase 9e's. The launch
      counters are zeroed just before 10c-d's steps after the restore and
      read just after: exactly 2 + 2 + 2 + 2 + 24 + 24 per eager step (a
      replay counts nothing), the bf16 records' ``launches``.
   d. ``car_train --epochs 1 --bf16 1 --mu_bf16 1`` in a subprocess, then
      ``car_eval --which last``, which evaluates in float32 as the JAX
      driver does: every metric finite and within ``BF16_METRIC_RTOL`` of
      ``car_train``'s bf16 evaluation.

11. The serving path over exported programs, at the car preset's full
   width, on ``last`` of phase 8b's ``car_train`` run.
   a. ``car_eval --export_artifact --export_point_buckets 32768,34816``:
      six programs (batch sizes 1, 2, 4 per bucket), each one's export
      time; then a fresh process (``chip_smoke.py --load-bundle``, no model
      code imported) loads each, binds ``last`` and runs it on a seeded
      input: load and bind time, exactly 2 + 2 + 24 launches and device
      calls (``profile_launches``), no plain route, and the answer within
      ``PROGRAM_RTOL`` of the eager model on the same weights and input.
   b. ``BatchingServer(pad_to_points=True, pipeline_depth=2)``: a ragged
      sample of 32186 points rides the 32768 bucket, is truncated back and
      equals the eager model on the padded input (its deviation from the
      exact-N forward printed, not held: padding is not output-exact); 8
      requests form two batches of 4, bit for bit equal at depth 1 and 2;
      2 + 2 + 24 launches per forward.
   c. ``reload`` of perturbed weights while two clients keep submitting:
      no request fails, the requests after it answer with the new weights,
      a structurally wrong state is refused and the new weights keep
      serving.
   d. ``python -m haet_torch.serve_http --pad_to_points 1`` in a
      subprocess on a free port: ``/healthz``, ``/predict`` equal to the
      in-process server, ``/metrics`` with the latency summary's ``_count``
      and ``_sum``, ``POST /reload``, then SIGTERM while a request waits in
      the batcher: the request is answered and the process exits 0.
   e. ``micro_serving_latency`` and ``micro_serving_server`` (batch sizes
      1 and 4) with short windows (bf16, as on the JAX package's chip):
      every number finite.

12. The structured-mesh PDE slice: the Darcy preset
   (``HAETransolverStructuredMesh2D``, 8 layers, n_hidden 128, 8 heads, G
   64 at C 16, Erwin at d 2 with SwiGLU hidden C) and the PDE drivers.
   a. The Erwin kernels, forward and backward, at the Darcy block shapes
      (``DARCY_ERWIN``: 32 clouds of 64 tokens, C 16, 4 heads, balls of
      32; of 32 tokens, C 32, 8 heads, balls of 16) against the plain
      block: out, dx, dpos and the 14 parameter gradients within
      ``KERNEL_RTOL``, two calls bit-identical, device us per call beside
      the bound at d 2 and the plain version's time; untimed, the same
      shapes at d 3 (``exp_3d``).
   b. The slice kernels and their backwards at ``[4, 8, 7225, 16]`` G 64
      as phases 3 and 3b hold them, timed with the L2 flushed; untimed at
      ``[4, 8, 32768, 16]`` G 64.
   c. The Darcy preset at full width on the synthetic 85 x 85 stand-in
      (batch 4, AdamW + OneCycle, both kernel flags, seeded weights
      perturbed by 0.05 N(0, 1)): the eval forward within ``SERVE_RTOL``
      of the plain path (8 + 8 + 48 launches); two eager steps from one
      state bit-identical; five graphed steps against five eager ones
      within ``GRAPH_RTOL``, 8 + 8 + 48 forward and 8 + 8 + 48 backward
      launches per eager step and per replay (the profiler), no plain
      route; the graphed step's wall, device time, kernels, top kernels
      and the eager step's temporaries; ``use_checkpoint``: gradients
      within ``CHECKPOINT_RTOL`` of the plain step's, the BatchNorm
      statistics equal and updated once, the forward kernels launched
      twice, the temporaries and the graphed step's wall and device time
      beside the plain step's, a graphed checkpointed step equal to the
      eager one; ``accum_steps`` 2 graphed against eager (16 + 16 + 96
      launches each way per step) and its deviation from the full batch
      (printed: batch-coupled); dropout 0.1: a graphed step equal to the
      eager one from one generator state, two replays drawing different
      masks, a replay from the first one's generator state equal to it.
   d. ``exp_darcy`` (the stand-in), ``exp_pipe``, ``exp_airfoil``,
      ``exp_elas`` (the fixtures) and ``exp_3d`` (32^3, ``use_checkpoint``)
      for one epoch at full width: a finite ``rel_err``, every kernel of
      the path launched, no plain route.

13. The time-stepping PDE loops (NS and plasticity), rollout export, and
   the Erwin-only car baseline.
   a. The path kernels at the NS preset's shapes (n_hidden 256, 8 heads, G
      64, batch 2 on 64 x 64): the slice kernels and their backwards at
      ``[2, 8, 4096, 32]`` G 64 as phases 3 and 3b hold them, timed with
      the L2 flushed; the Erwin kernels at ``NS_ERWIN`` (16 clouds of 64
      tokens, C 32, 4 heads, balls of 32; of 32 tokens, C 64, 8 heads,
      balls of 16; d 2) as 12a holds them; then at the plasticity batch's
      64 clouds (the Darcy block shapes) beside 32 clouds of the same
      shapes, with ``cudaOccupancyMaxActiveClusters`` of each kernel: do
      64 clusters of 8 CTAs run in one wave. Untimed, as phases 3, 3b and
      12a hold them, the kernels at the drivers' own shapes of 13c-d
      (``DRIVER_SLICE``: ``exp_ns`` at ``--n-hidden`` 128, batches 2 and
      1; ``exp_plas`` at batches 8 and 3 on 101 x 31; the Darcy block
      shapes at ``DRIVER_CLOUDS`` 16, 8 and 24 clouds), and
      ``micro_rollout``'s bf16 forwards (the slice at ``[1, 8, 4096,
      32]``, ``NS_ERWIN`` on 8 clouds) within ``BF16_RTOL``.
   b. The NS preset at full width on the synthetic stand-in (batch 2, 10
      frames, ``exp_ns``'s teacher-forced rollout, seeded weights
      perturbed by 0.05 N(0, 1), eager steps): two steps from one state
      bit-identical; the per-frame checkpoint's gradients within
      ``CHECKPOINT_RTOL`` of the unchecked step's, the BatchNorm
      statistics equal and updated once per frame; the launches per step
      from the counters (the forward kernels twice under the checkpoint),
      no plain route; with and without the checkpoint, the counted step's
      wall and temporaries; the checkpointed step's device time and
      kernels from a profiled step.
   c. ``micro_rollout`` (bf16, one round, ``MICRO_ROLLOUT_FRAMES``): the
      rollout program within 2e-2 of the per-frame loop, every number
      finite.
   d. ``exp_ns --export_rollout`` (the stand-in) and ``exp_plas`` (the
      stand-in) for one epoch at full width: a finite ``rel_err``, every
      path kernel launched, no plain route; the exported rollout program,
      bound to the run's ``last`` checkpoint, against the eager
      autoregressive loop within ``PROGRAM_RTOL`` (equal bit for bit or
      not, printed), 10 x (8 + 8 + 48) launches per call;
      ``erwin_baseline`` for one epoch at full width on a fold layout of
      the car fixture: finite metrics and 0 Erwin launches (the kernels'
      gate takes clouds of at most 512 points; the baseline's cloud is
      the sample's padded points); two eager training steps of the
      baseline on a stand-in car (``car_like``: ~18-21k points, bucketed
      to a multiple of 2048, padded to one cloud of 32768: the
      ball-grouped neighbour search): finite, no kernel launched, the
      second step's wall and temporaries.
   e. The car preset with ``grouping="morton"``: its eval forward within
      ``SERVE_RTOL`` of its plain path, 2 + 2 + 24 launches.

14. ``use_pallas="auto"``, the sweeps, the utils and the native readers
   (each part's seconds printed; ~90 s in all).
   a. The car preset (float32) with ``use_pallas="auto"`` against the
      explicit ``False`` and ``True`` models of the same weights, at half
      the card's threshold and at it (``auto_threshold``: the first N
      that takes the kernels at G 32): 0 slice launches below and 2 + 2
      forward at it (and with a backward, 2 + 2 backward), by the launch
      counters; the forward equal to the explicit model's bit for bit,
      the gradients within ``AUTO_GRAD_RTOL``.
   b. ``mfu_sweep --ns 32768 262144 --rounds 2`` with its A/B at 262144,
      in this process: every row finite, auto's resolution as the rule's.
   c. ``accum_mem_probe`` at accum 1 and 8, batch 8, at the larger of the
      threshold and 65536 points, each probe in a fresh process (both at
      once): accum 8's peak memory below accum 1's.
   d. ``get_slice_weights`` on the car preset at full width (32186 points,
      both kernel flags): the last block's weights against the plain
      formula on that block's input, block 0's against the plain model's
      capture, within ``VIZ_ATOL``; each slice's weights summing to 1 over
      the points; the capturing forward's output equal to an ordinary
      forward's; 2 + 2 + 24 launches with and without the capture.
   e. Phase 8b's ``last`` weights as a reference-format ``.pt``, then
      ``car_eval --torch_checkpoint`` on the car fixture's fold layout:
      the metrics of ``car_eval`` of the checkpoint itself.
   f. The native VTK reader (``use_native=True``; both libraries are
      built first, so a failed ``g++`` build fails the phase) against the
      numpy parser on the car fixture, and the native ball tree's balls at
      every level against ``ball_groups``' on-device median split of a
      car sample's first 16384 points.

15. Data and head tensor parallelism (``haet_torch.parallel``; each
   part's seconds printed, ~35 s).
   a. A world of one over NCCL: ``init_distributed`` from the ``HAET_*``
      variables in this process, a (1, 1) mesh; the car preset in bf16
      (``mu_bf16``, both kernel flags, ``shard_axes=("dp", "tp")``) takes
      3 graphed steps through ``Trainer(mesh=...)`` against the same steps
      without a mesh: every step's metrics and the whole state bit for
      bit; 2 + 2 + 24 forward and 2 + 2 + 24 backward launches per step
      of the capture (its warm-up steps and itself) and per replay (the
      profiler); the two min/max all-reduces, the output gather and the
      gradient all-reduce of a step made as NCCL calls inside the capture;
      NCCL's share of a replay's device time; both walls.
   b. Two ranks on the one card over gloo (NCCL refuses two ranks on one
      device), spawned: which collectives gloo carries on CUDA tensors
      (all-reduce, all-gather and broadcast, which the port uses, must);
      then dp 2 (a batch of 2 samples of 32186 points) and tp 2 (one
      sample, 4 heads a rank), float32, two eager steps each: the losses
      and gradient norms within ``GLOO_RTOL`` of one rank's steps on the
      same batch and weights in this process, equal on both ranks, the
      first step's gradient (summed over the ranks and clipped) leaf by
      leaf within ``GLOO_GRAD_RTOL``; each rank's launches (2 + 2 + 24
      each way per step) at its local shapes (the slice kernels at ``[1, 8,
      32186, 32]`` and ``[1, 4, 32186, 32]``, Erwin over 8 and 4 clouds);
      its step walls and host time in collectives.
   c. The walls on the record: 15a's graphed step beside phases 10c and
      9e, and 15b's last step per rank with gloo's share of it.

16. The GPipe pipeline and serving over a mesh (``haet_torch.parallel.
   pipeline``, ``mesh=`` exports, ``serve.follow``; each part's seconds
   printed).
   a. A world of one over NCCL, a ``(dp 1, pp 1)`` mesh: the bf16 car
      preset (both kernel flags) as a ``PipelinedModel`` (remat on) takes
      ``PIPE_STEPS`` graphed steps at M 1 against the unpipelined
      trainer's: the losses within ``PIPE_LOSS_RTOL``, the first step's
      gradient leaf by leaf within ``GLOO_GRAD_RTOL`` (phase 15's
      allowance); then at M 2 on a batch of 2 samples of 32186 points,
      16b's reference; the launches of the capture (its warm-up steps and
      itself) per step: each block's forward kernels twice (the
      recompute), ``PIPE_PER_STEP`` per microbatch.
   d. ``micro_pipeline_tax``, 2 rounds: plain, plain with
      ``use_checkpoint`` and pp 1 with remat on and off, each line's
      ms/step, Mpts/s and x vs plain, dispatched and graphed.
   b. Two gloo ranks on the one card, spawned (NCCL refuses two ranks on
      one device): pp 2, one car block a stage, M 2, bf16, ``PIPE_STEPS``
      eager steps: the losses and the first step's gradient (every stage's
      layers gathered) against 16a's M 2 run; each rank's launches, its
      own stage's kernels only. gloo's ``send``/``recv`` take CPU tensors,
      so the stage hop goes through the host.
   c. On the same two ranks: the car preset, float32 and bf16, exported
      as a dp 2 b2 family and a tp 2 b1 program (``data_axis=None``) by
      rank 0, loaded by both, served by rank 0's ``BatchingServer`` with
      rank 1 following: the answers against the single-device programs on
      the same batches (exported and run by rank 1 meanwhile;
      ``PIPE_SERVE_DTYPES``), the launches per forward on each rank.

Then one JSON line of kernel records, seven float32 ones (``launches``
from phase 6's counters, for ``copy_scale`` from the counter after phase
7d's run, ``replay_launches`` from the profiler's count of one replay),
six bf16 ones (``*_bf16``, ``launches`` from 10c-d's eager steps), six at
the Darcy shapes (``*_darcy``, ``launches`` from 12c's eager step) and six
at the NS shapes (``*_ns``, ``launches`` from 13b's checkpointed eager
step), phase 5's, 8's, 9's, 10's, 11's, 12's, 13's, 14's, 15's and 16's
numbers, the card line, and as the last line ``{"ok": true, "device":
{...}}``. Imports nothing of JAX or ``haet_tpu``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()  # the profiler's loss grows with the process's age
N_POINTS = 32186          # a ShapeNet-Car sample's point count
N_PADDED = 32768          # its 2048-point training bucket
N_SURFACE = 3586          # surface points of a ShapeNet-Car sample
TRAIN_STEPS = 5
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside
# the tensor cores (the kernels compute in float32 FMA, no TF32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Tolerances, relative to the plain result's max |value|: float32 with sums
# taken in another order (chunked log-sum-exp merge, per-thread loops).
KERNEL_RTOL = 1e-4
SERVE_RTOL = 1e-4  # a whole 2-layer model, as the CPU parity test holds it
# The slice backwards' bias gradients sum 262,144 points' terms that cancel
# (for b_slice, sum_n dL/dlogit is 0 at a constant temperature), so float32
# sums in two orders differ by more than 1e-4 of the small result (3.6e-4
# on b_slice, H100 run of this script); every other gradient of theirs is
# held to KERNEL_RTOL.
SLICE_BWD_RTOL = 1e-3
# Step 1's gradients, kernels against the plain path: each leaf within
# GRAD_RTOL of its own max |grad|, or GRAD_ATOL of the largest |grad| of the
# model. float32 through a forward and backward of 2 layers and 24 Erwin
# blocks with sums in other orders (a CPU run of the same comparison at
# N = 4096 measured 2.3e-5); the absolute floor is for leaves whose
# gradient is zero up to round-off (biases in front of a train-mode
# BatchNorm: ~1e-8 of the largest |grad|, all noise).
GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-6


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` over ``reps`` launches, timed with CUDA events."""
    import torch

    for _ in range(warmup):
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


def device_us(fn, names=None, reps: int = 50) -> float:
    """The card's time per call of ``fn()``, in microseconds, from a
    ``torch.profiler`` trace of ``reps`` back-to-back calls: the kernels
    whose names contain one of ``names`` (every kernel when None)."""
    from haet_torch.benchmarks.erwin_kernels import kernel_us

    return kernel_us(fn, reps, names)[0]


ERWIN_FWD_KERNELS = ("erwin_block_fwd",)
ERWIN_BWD_KERNELS = ("erwin_block_bwd", "erwin_block_sum_partials")


def erwin_launch_line(n_e, c_e, ball, heads=8, mlp_ratio=4, clouds=8, d=3):
    """The Erwin kernels' launch shape at one block shape: the grid of
    ``clouds`` clusters of ``CLUSTER`` CTAs, and each kernel's dynamic
    shared memory and global scratch per CTA."""
    from haet_torch.ops.kernels import erwin_block as eb

    args = (n_e, c_e, d, mlp_ratio * c_e, heads, min(ball, n_e))
    fwd, bwd = eb.fwd_layout(*args), eb.bwd_layout(*args)
    return (f"grid {clouds * eb.CLUSTER} CTAs = {clouds} clouds x cluster "
            f"K {eb.CLUSTER}, 256 threads; shared memory per CTA fwd "
            f"{fwd.smem} B, bwd {bwd.smem} B; scratch per CTA fwd "
            f"{4 * fwd.scratch} B, bwd {4 * bwd.scratch} B")


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, rtol):
    """Max abs error of ``got`` vs ``want`` against ``rtol * max|want|``."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    tol = rtol * max(scale, 1e-30)
    print(f"  {name}: max_abs_err {err:.3e}  max|plain| {scale:.3e}  "
          f"rel {err / max(scale, 1e-30):.3e}  tol {tol:.3e}", flush=True)
    check(err <= tol, f"{name}: max abs error {err} > tolerance {tol}")
    return err


def print_times(ms, plain_ms, bound):
    print(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
          f"{bound[0] * 1e3:.3f} us ({bound[1]})", flush=True)


def kernel_record(name, source, replaces, err, ms, plain_ms, bound, **extra):
    """One entry of the ``kernels`` JSON line; ``launches`` is filled in
    from the serve phase's counters."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None, **extra}


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version at the car shapes.
# ---------------------------------------------------------------------------

#: the Erwin kernels' gate edges, ``(n, C, ball)`` at 8 heads and SwiGLU
#: 4C: the largest clouds the one-CTA gate admitted at the car's widths,
#: and the edges of the cluster kernels' gate (the JAX gate, n <= 512 and
#: C <= 512), where buffers and weight slices spill to global memory
ERWIN_EDGES = ((128, 32, 32), (64, 64, 16), (512, 32, 32), (512, 64, 16),
               (16, 512, 16))


def erwin_inputs(dev, g, n_e, c_e, ball, heads=8, mlp_ratio=4, clouds=8,
                 d=3):
    """Seeded inputs and weights of one Erwin block shape (``clouds``
    clouds, ``heads`` heads, SwiGLU ``mlp_ratio`` * C, positions of ``d``
    dimensions), drawn from ``g``."""
    import torch

    from haet_torch.models.erwin import ErwinTransformerBlock
    from haet_torch.ops.kernels import erwin_block as eb

    torch.manual_seed(SEED)
    blk = ErwinTransformerBlock(c_e, heads, ball, mlp_ratio,
                                dimensionality=d).to(dev)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g).to(dev))
        blk.BMSA.sigma_att.copy_(
            -1.0 + 0.01 * torch.randn(1, heads, 1, 1, generator=g).to(dev))
    params = dict(blk.named_parameters())
    xe = torch.randn(clouds, n_e, c_e, generator=g).to(dev)
    pe = torch.rand(clouds, n_e, d, generator=g).to(dev)
    check(eb.eligible(n_e, c_e, heads, c_e, mlp_ratio * c_e),
          f"n {n_e} / C {c_e} / {heads} heads is outside the kernel's gate")
    return xe, pe, params, dict(ball_size=ball, num_heads=heads,
                                use_dist_bias=True)


def erwin_work(n_e, c_e, ball, heads=8, mlp_ratio=4, clouds=8, d=3):
    """``(weight elements, forward FLOP)`` of one Erwin block call on
    ``clouds`` clouds of ``n_e`` points (``heads`` heads, SwiGLU
    ``mlp_ratio`` * C, positions of ``d`` dimensions)."""
    hid = mlp_ratio * c_e
    hd = c_e // heads
    w_elems = (c_e + c_e * d + c_e + 3 * c_e * c_e + 3 * c_e + heads
               + c_e * c_e + c_e + c_e + 2 * (hid * c_e + hid)
               + c_e * hid + c_e)
    flops = 2 * clouds * n_e * (d * c_e + 3 * c_e * c_e
                                + heads * ball * hd * 2
                                + c_e * c_e + 3 * hid * c_e)
    return w_elems, flops


def erwin_fwd_bound(n_e, c_e, ball, heads=8, mlp_ratio=4, clouds=8, d=3):
    """Bound of one forward call: reads x, pos and the weights, writes
    out."""
    w_elems, flops = erwin_work(n_e, c_e, ball, heads, mlp_ratio, clouds, d)
    return bound_ms(4 * (2 * clouds * n_e * c_e + clouds * n_e * d
                         + w_elems), flops)


def erwin_bwd_bound(n_e, c_e, ball, heads=8, mlp_ratio=4, clouds=8, d=3):
    """Bound of one backward call: reads x, pos, dout and the weights;
    writes dx, dpos and the gradients of every weight but sigma;
    recomputes the forward and does its two backward products per forward
    product."""
    w_elems, fwd_flops = erwin_work(n_e, c_e, ball, heads, mlp_ratio, clouds,
                                    d)
    nbytes = 4 * (3 * clouds * n_e * c_e + 2 * clouds * n_e * d
                  + 2 * w_elems - heads)
    return bound_ms(nbytes, 3 * fwd_flops)


#: the slice kernels' timed shapes ``tag: (B, H, N, C, G)``: serve batch
#: 1, the serve burst's batch of 4, the padded training batch
#: (``benchmarks/slice_kernels.py:SHAPES``)
SLICE_TIMED = {"serve_b1": (1, 8, N_POINTS, 32, 32),
               "burst_b4": (4, 8, N_POINTS, 32, 32),
               "train_b1": (1, 8, N_PADDED, 32, 32)}
#: untimed: the presets' widest slices (G 64 at C 16 and 32), ragged N
#: around the kernels' 256-row block unit, wide slices at C <= 32 (G 128,
#: ``bench_flags --slice_num 128``; G 600, past what deslice stages at
#: once, and 19 windows of the backwards), and heads wider than 32 (the
#: generic kernels; ``--n_hidden 1024`` over 8 heads is C 128), up to G*C
#: 16384 and to the widest head, C 2048
SLICE_EDGES = {"g64_c16": (1, 8, N_POINTS, 16, 64),
               "g64_c32": (1, 8, N_POINTS, 32, 64),
               "n1": (1, 8, 1, 32, 32), "n255": (1, 8, 255, 32, 32),
               "n257": (1, 8, 257, 32, 32),
               "c13_g20": (1, 8, 3001, 13, 20),
               "generic_c128_g16": (1, 8, 3001, 128, 16),
               "g128_c16": (1, 8, 3001, 16, 128),
               "g128_c32": (1, 8, 3001, 32, 128),
               "g600_c32": (1, 8, 1001, 32, 600),
               "generic_c128_g32": (1, 8, 3001, 128, 32),
               "generic_c128_g128": (1, 8, 1001, 128, 128),
               "generic_c2048_g3": (1, 8, 301, 2048, 3)}
#: the edge ``generic_c128_g16`` with its seed, but ``ws`` 0.3 N(0, 1) and
#: ``wa`` 0.1 N(0, 1) unscaled: most temperatures clamp to 0.1 and logits
#: reach ~120, so two float32 computations differ by ~1e-4 of max |out|
#: (the plain version alone is ~4e-5 from float64 there, on the CPU)
SLICE_UNSCALED = ("generic_c128_g16", SLICE_EDGES["generic_c128_g16"],
                  list(SLICE_EDGES).index("generic_c128_g16"))


def slice_phase(dev, shapes, timed: bool, label: str = "phase 3"):
    """Both slice kernels against their plain versions at ``shapes``
    (``tag: (B, H, N, C, G)``), within ``KERNEL_RTOL`` of each output's
    max, and two calls bit-identical (states, m, s, out). Prints each
    launch's grid and shared memory per block. When ``timed``: the
    profiler's device us per call with the L2 flushed before each call
    (every kernel of the op, named), CUDA-event ms of back-to-back calls,
    the plain version's ms and the bound; returns the two kernel records
    (event and plain times and the bound at the first shape)."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    rec = {k: {"err": 0.0, "us": {}, "bound_us": {}, "f32_bound_us": {},
               "names": set(), "ms": None}
           for k in ("slice_states", "deslice")}
    for i, (tag, shape) in enumerate(shapes.items()):
        b, h, n, c, gs = shape
        print(f"{label}: slice_states / deslice ({tag})  x [{b}, {h}, {n}, "
              f"{c}], G {gs}; {slice_launches(dev, shape)}", flush=True)
        x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 10 + i)
        with torch.inference_mode():
            got = sk.slice_states(x, ws, bs, wa, ba)
            again = sk.slice_states(x, ws, bs, wa, ba)
            want = sk.slice_states_plain(x, ws, bs, wa, ba)
            torch.cuda.synchronize()
            rec["slice_states"]["err"] = max(
                rec["slice_states"]["err"],
                *(compare(nm, a, w, KERNEL_RTOL)
                  for nm, a, w in zip(("states", "m", "s"), got, want)))
            same = all(torch.equal(a, w) for a, w in zip(got, again))
            m_p, s_p = want[1], want[2]
            del got, again, want
            out_k = sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p)
            out_2 = sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p)
            out_p = sk.deslice_plain(x, ws, bs, wa, ba, st, m_p, s_p)
            torch.cuda.synchronize()
            rec["deslice"]["err"] = max(rec["deslice"]["err"],
                                        compare("out", out_k, out_p,
                                                KERNEL_RTOL))
            same = same and torch.equal(out_k, out_2)
            del out_k, out_2, out_p
            print(f"  two calls bit-identical (states, m, s, out): {same}",
                  flush=True)
            check(same, f"slice kernels at {tag} are not deterministic")
            if not timed:
                continue
            fns = {"slice_states": (
                       lambda: sk.slice_states(x, ws, bs, wa, ba),
                       lambda: sk.slice_states_plain(x, ws, bs, wa, ba)),
                   "deslice": (
                       lambda: sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p),
                       lambda: sk.deslice_plain(x, ws, bs, wa, ba, st, m_p,
                                                s_p))}
            for kind, (fn, plain_fn) in fns.items():
                r = rec[kind]
                us, names = sb.flushed_us(fn, 30)
                bound = sb.bound_us(kind, shape)
                f32 = sb.bound_us(kind, shape, float32_only=True)
                r["us"][tag], r["bound_us"][tag] = us, bound[0]
                r["f32_bound_us"][tag] = f32[0]
                r["names"].update(names)
                if r["ms"] is None:
                    r["ms"], r["plain_ms"] = cuda_ms(fn), cuda_ms(plain_fn)
                    r["bound"] = (bound[0] / 1e3, bound[1])
                    print_times(r["ms"], r["plain_ms"], r["bound"])
                print(f"  {kind}: device {us:.2f} us per call (profiler, L2 "
                      f"flushed; {names}); bound {bound[0]:.2f} us "
                      f"({bound[1]}; 3xTF32 tensor cores), {bound[0] / us:.0%}"
                      f" of it; float32-FMA bound {f32[0]:.2f} us ({f32[1]}),"
                      f" context", flush=True)
        del x, st
        torch.cuda.empty_cache()
    if not timed:
        return None
    replaces = {"slice_states": "haet_tpu/ops/pallas/slice_kernels.py:73",
                "deslice": "haet_tpu/ops/pallas/slice_kernels.py:125"}
    return [kernel_record(k, "haet_torch/csrc/slice_kernels.cu", replaces[k],
                          r["err"], r["ms"], r["plain_ms"], r["bound"],
                          device_us_per_call=r["us"],
                          bound_us=r["bound_us"],
                          float32_bound_us=r["f32_bound_us"],
                          kernel_names=sorted(r["names"]))
            for k, r in rec.items()]


def slice_launches(dev, shape, kinds=("slice_states", "deslice"),
                   isz: int = 4) -> str:
    """The slice kernels' route, grid and shared memory per block for
    ``x_proj`` of ``isz`` bytes an element (a bf16 backward at C <= 32: the
    fused kernel's persistent grid, from the card's resident blocks, one
    launch per call)."""
    from haet_torch.ops.kernels import slice_kernels as sk

    b, h, n, c, gs = shape
    fused = isz == 2 and sk.fast_widths(c, gs) is not None
    parts = []
    for kind in kinds:
        if fused and kind.endswith("_sums"):
            continue
        if fused and kind in SLICE_BWD_GRADS:
            per_sm = (sk.fused_blocks(sk._lib(), dev, kind, c)
                      if dev.type == "cuda" else 1)
            geom = sk.fused_geometry(kind, b * h, n, c, gs, sk.sm_count(dev),
                                     per_sm)
            parts.append(f"{kind} fused, one launch: grid {geom.blocks} x "
                         f"256 threads ({per_sm} per SM), {b * h} x "
                         f"{geom.per_cloud} units of {geom.span} rows, "
                         f"{geom.groups} windows of {geom.slices} slices, "
                         f"{geom.smem} B dynamic shared memory")
            continue
        geom = sk.launch_geometry(kind, b * h, n, c, gs, sk.sm_count(dev))
        # a chain: grid z 1, a fast launch per sweep of windows (generic:
        # one, looping over its groups); the rest: grid z the sweeps
        sweeps = -(-geom.groups // geom.sweep)
        chain = kind in SLICE_BWD_GRADS
        z = 1 if chain else sweeps
        launches = sweeps if chain and geom.route == "fast" else 1
        sweep = (f", {geom.sweep} windows a sweep" if geom.route == "fast"
                 else "")
        parts.append(f"{kind} {geom.route}, {launches} x grid "
                     f"({geom.per_cloud}, {b * h}, {z}) x "
                     f"{32 * geom.warps} threads{sweep}, {geom.span} rows "
                     f"per block, {geom.smem} B dynamic shared memory")
    return "; ".join(parts)


def bwd_launches(shape, low: bool):
    """The CUDA launches one call of a slice backward makes at C <= 32: the
    fused kernel's one (bf16), or slice_bwd_f32's first pass, its sum, a
    chain per sweep of windows of 32 slices and their sum (float32); None
    wider."""
    from haet_torch.ops.kernels import slice_kernels as sk

    c, gs = shape[3], shape[4]
    widths = sk.fast_widths(c, gs)
    if widths is None:
        return None
    sweep = sk.bwd_sweep(widths[0], "deslice_bwd", gs)
    return 1 if low else 3 + -(-gs // (sk.BWD_WINDOW * sweep))


def launches_per_call(kind, fn, shape, low: bool = False) -> int:
    """The CUDA launches of one call of the slice backward ``kind``, from
    the profiler, checked against :func:`bwd_launches` at C <= 32."""
    from haet_torch.ops.kernels import profile_launches

    _, counts = profile_launches(fn)
    got = counts["launches"][kind]
    print(f"  {kind}: {got} CUDA launches per call", flush=True)
    want = bwd_launches(shape, low)
    if want is not None:
        check(got == want, f"{kind}: {got} launches per call, not {want}")
    return got


def slice_f64(x, ws, bs, wa, ba, st, m, s, base_temp=0.5, epsilon=1e-6):
    """slice_states ``(states, m, s)`` and deslice's ``out`` (from the
    given ``m``, ``s``) computed in float64 from the float32 inputs."""
    import math

    import torch

    x, ws, bs, wa, ba, st = (t.double() for t in (x, ws, bs, wa, ba, st))
    tau = base_temp + (x @ wa + ba).clamp(-0.4, 0.4)
    z = (x @ ws + bs - math.log(-math.log(epsilon))) / tau
    m64 = z.amax(dim=2)
    e = torch.exp(z - m64[:, :, None])
    s64 = e.sum(dim=2)
    states = torch.einsum("bhng,bhnc->bhgc", e, x) / s64[..., None]
    states = states / (1 + 1e-5)
    w = torch.exp(z - m.double()[:, :, None]) / s.double()[:, :, None]
    return (states, m64, s64), torch.einsum("bhng,bhgc->bhnc", w, st)


def slice_unscaled_phase(dev):
    """``SLICE_UNSCALED``: the generic kernels and the plain version both
    against float64; the kernels within ``KERNEL_RTOL`` of each output's
    max of the float64 value. Prints the plain version's distance from
    float64 (the witness that float32 loses those digits) and the kernels'
    from the plain version."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    tag, shape, index = SLICE_UNSCALED
    b, h, n, c, gs = shape
    print(f"phase 3: slice_states / deslice ({tag}, weights unscaled)  x "
          f"[{b}, {h}, {n}, {c}], G {gs}; {slice_launches(dev, shape)}",
          flush=True)
    x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 10 + index,
                                      scaled=False)
    with torch.inference_mode():
        got = sk.slice_states(x, ws, bs, wa, ba)
        plain = sk.slice_states_plain(x, ws, bs, wa, ba)
        m_p, s_p = plain[1], plain[2]
        out_k = sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p)
        out_p = sk.deslice_plain(x, ws, bs, wa, ba, st, m_p, s_p)
        ref, out_ref = slice_f64(x, ws, bs, wa, ba, st, m_p, s_p)
        torch.cuda.synchronize()
    for name, k, p, r in zip(("states", "m", "s", "out"), (*got, out_k),
                             (*plain, out_p), (*ref, out_ref)):
        scale = float(r.abs().max())
        plain_rel = float((p.double() - r).abs().max()) / scale
        kp_rel = float((k.double() - p.double()).abs().max()) / scale
        print(f"  {name}: plain float32 vs float64 rel {plain_rel:.3e}; "
              f"kernel vs plain rel {kp_rel:.3e}", flush=True)
        compare(f"{name} vs float64", k, r, KERNEL_RTOL)


def kernel_phase(dev):
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    g = torch.Generator().manual_seed(SEED)
    records = slice_phase(dev, SLICE_TIMED, timed=True)
    slice_phase(dev, SLICE_EDGES, timed=False)
    slice_unscaled_phase(dev)

    def erwin_case(n_e, c_e, ball, clouds=8):
        """One block shape's inputs, and the kernel's error against its
        plain version."""
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball,
                                          clouds=clouds)
        with torch.inference_mode():
            o_k = eb.fused_erwin_block(xe, pe, params, **kw)
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            err = compare("out", o_k, o_p, KERNEL_RTOL)
        return xe, pe, params, kw, err

    # The Erwin stage's two block shapes: encoder0/decoder0 (n 32, C 32,
    # ball 32, SwiGLU 128; 16 launches per forward) and the bottleneck
    # (n 16, C 64, ball 16, SwiGLU 256; 8 launches per forward). The event
    # time of back-to-back launches is the host's launch rate at these
    # sizes; the profiler's device time per call is the kernel's.
    errs, times, plain_times, bounds, dev_us = [], [], [], [], {}
    for n_e, c_e, ball, weight in ((32, 32, 32, 16), (16, 64, 16, 8)):
        print(f"phase 3: fused_erwin_block  x [8, {n_e}, {c_e}], 8 heads, "
              f"ball {ball}; {erwin_launch_line(n_e, c_e, ball)}", flush=True)
        xe, pe, params, kw, err = erwin_case(n_e, c_e, ball)
        errs.append(err)
        with torch.inference_mode():
            def fn():
                return eb.fused_erwin_block(xe, pe, params, **kw)
            times.append((cuda_ms(fn), weight))
            dev_us[f"n{n_e}_c{c_e}"] = device_us(fn, ERWIN_FWD_KERNELS)
            plain_times.append((cuda_ms(
                lambda: eb.erwin_block_plain(xe, pe, params, **kw)), weight))
        bounds.append((erwin_fwd_bound(n_e, c_e, ball), weight))
        print_times(times[-1][0], plain_times[-1][0], bounds[-1][0])
        print(f"  device {dev_us[f'n{n_e}_c{c_e}']:.2f} us per call "
              f"(profiler)", flush=True)
    total = sum(w for _, w in times)
    mix = lambda xs: sum(t * w for t, w in xs) / total  # noqa: E731
    bound = (mix([(bd[0], w) for bd, w in bounds]),
             "bytes" if all(bd[1] == "bytes" for bd, _ in bounds)
             else "operations")

    # The serve burst's batch of 4: 32 clouds, 256 CTAs.
    for n_e, c_e, ball in ((32, 32, 32), (16, 64, 16)):
        print(f"phase 3: fused_erwin_block, serve burst  x [32, {n_e}, "
              f"{c_e}], 8 heads, ball {ball}; "
              f"{erwin_launch_line(n_e, c_e, ball, clouds=32)}", flush=True)
        xe, pe, params, kw, err = erwin_case(n_e, c_e, ball, clouds=32)
        errs.append(err)
        with torch.inference_mode():
            dev_us[f"burst_n{n_e}_c{c_e}"] = device_us(
                lambda: eb.fused_erwin_block(xe, pe, params, **kw),
                ERWIN_FWD_KERNELS)
        print(f"  device {dev_us[f'burst_n{n_e}_c{c_e}']:.2f} us per call "
              f"(profiler)", flush=True)
    records.append(kernel_record(
        "fused_erwin_block", "haet_torch/csrc/erwin_block.cu",
        "haet_tpu/ops/pallas/erwin_block.py:163", max(errs), mix(times),
        mix(plain_times), bound,
        per_shape_ms={"n32_c32": times[0][0], "n16_c64": times[1][0]},
        device_us_per_call=dev_us))

    # The gate's edges: they must launch and agree too. Checked only, not
    # timed and not part of the record.
    for n_e, c_e, ball in ERWIN_EDGES:
        print(f"phase 3: fused_erwin_block at a gate edge  x [8, {n_e}, "
              f"{c_e}], 8 heads, ball {ball}, SwiGLU {4 * c_e}; "
              f"{erwin_launch_line(n_e, c_e, ball)}", flush=True)
        erwin_case(n_e, c_e, ball)
    print("  none of the three has a single PyTorch call computing the same "
          "function: library_ms is null", flush=True)
    return records


# ---------------------------------------------------------------------------
# Phase 3b: the backwards against autograd of their plain versions.
# ---------------------------------------------------------------------------

#: the gradients each slice backward returns, in order
SLICE_BWD_GRADS = {"slice_states_bwd": ("dx", "dWs", "dbs", "dWa", "dba"),
                   "deslice_bwd": ("dx", "dWs", "dbs", "dWa", "dba",
                                   "dstates")}
#: zero in exact arithmetic at N = 1: one point's softmax weight is 1
#: whatever its logit, so dL/dlogit is 0 and so is every gradient through
#: it; both versions return rounding noise of the logits' size (up to ~1e-3
#: of the largest gradient), which no relative tolerance can hold
SLICE_BWD_ZERO_AT_N1 = {"slice_states_bwd": ("dWs", "dbs", "dWa", "dba"),
                        "deslice_bwd": ("dx", "dWs", "dbs", "dWa", "dba")}
#: the slice backwards' launch shapes: slice_states' first and second
#: pass, deslice's first and second
SLICE_BWD_KINDS = ("slice_states_bwd_sums", "slice_states_bwd",
                   "deslice_bwd_sums", "deslice_bwd")
#: the cancelling bias gradients, held to ``SLICE_BWD_RTOL``; the others to
#: ``KERNEL_RTOL``
SLICE_BWD_BIASES = ("dbs", "dba")
#: the backwards' low-temperature edge, held to float64: ``tag: (shape,
#: weight factor)``, ``ws`` and ``wa`` of ``slice_kernels.inputs`` times
#: the factor: at C 32 twice the car's spread, logits to ~140 and ~40 % of
#: the rows at the clamp's temperature 0.1, where the residuals' rounding
#: broke the backwards before they normalised their weights by their own
#: sum. (At C 128 unscaled, ``SLICE_UNSCALED``'s spread, float32 itself
#: misses ``d b_slice`` by more than 1e-3 of its max: the plain version
#: by 5.6e-3 in a CPU run.)
SLICE_BWD_UNSCALED = {"c32_g32_x2": ((1, 8, 3001, 32, 32), 2.0)}


def slice_bwd_rtol(name: str) -> float:
    return SLICE_BWD_RTOL if name in SLICE_BWD_BIASES else KERNEL_RTOL


def f64_rel(got, ref) -> float:
    """Max abs distance of ``got`` from the float64 ``ref``, relative to
    max |ref|."""
    return (float((got.double() - ref).abs().max())
            / max(float(ref.abs().max()), 1e-30))


def tf32_control(plain_fn, args, want, kind):
    """The plain version with TF32 matrix products (one tensor-core pass,
    as a kernel without the 3xTF32 split would compute) against the float32
    plain version: each gradient's distance relative to its max, the
    reading that the tolerances must tell apart from the kernels'."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = plain_fn(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    rel = {name: float((a.double() - w.double()).abs().max()
                       / w.double().abs().max())
           for name, a, w in zip(SLICE_BWD_GRADS[kind], got, want)}
    print(f"  {kind} one-pass TF32 control vs float32 plain, rel: "
          + "  ".join(f"{k} {v:.3e}" for k, v in rel.items()), flush=True)
    return rel


def slice_bwd_phase(dev, shapes, timed: bool, label: str = "phase 3b"):
    """Both slice backwards on CUDA tensors (their kernels: the fast ones
    at C <= 32, the generic ones wider) against their plain versions at
    ``shapes``, each gradient within ``slice_bwd_rtol`` of its max, and two
    calls bit-identical. When ``timed``: the one-pass TF32 control, device
    us per call with the L2 flushed (every kernel of the call), CUDA-event
    ms, the plain version's ms and device us, and the bound; returns the
    two kernel records."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    rec = {k: {"err": 0.0, "us": {}, "plain_us": {}, "bound_us": {},
               "f32_bound_us": {}, "names": set(), "ms": None, "rel": {},
               "launches_per_call": {}}
           for k in SLICE_BWD_GRADS}
    fns = {"slice_states_bwd": (sk.slice_states_bwd,
                                sk.slice_states_bwd_plain),
           "deslice_bwd": (sk.deslice_bwd, sk.deslice_bwd_plain)}
    for i, (tag, shape) in enumerate(shapes.items()):
        b, h, n, c, gs = shape
        print(f"{label}: slice_states_bwd / deslice_bwd ({tag})  x [{b}, {h}, "
              f"{n}, {c}], G {gs}; "
              f"{slice_launches(dev, shape, SLICE_BWD_KINDS)}", flush=True)
        x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 10 + i)
        g_st, g_out = sb.grads(shape, dev, SEED + 10 + i)
        with torch.inference_mode():
            states, m, s = sk.slice_states_plain(x, ws, bs, wa, ba)
        args = {"slice_states_bwd": (x, ws, bs, wa, ba, states, m, s, g_st),
                "deslice_bwd": (x, ws, bs, wa, ba, st, m, s, g_out)}
        for kind, (fn, plain_fn) in fns.items():
            a_k = args[kind]
            ref = slice_bwd_f64(kind, x, ws, bs, wa, ba, st, a_k[-1])
            with torch.inference_mode():
                got, again, want = fn(*a_k), fn(*a_k), plain_fn(*a_k)
                torch.cuda.synchronize()
                print(f"  {kind} vs float64, rel (kernel / plain): "
                      + "  ".join(f"{nm} {f64_rel(a, r):.2e} / "
                                  f"{f64_rel(w, r):.2e}" for nm, a, w, r in
                                  zip(SLICE_BWD_GRADS[kind], got, want, ref)),
                      flush=True)
                for name, a, w in zip(SLICE_BWD_GRADS[kind], got, want):
                    if n == 1 and name in SLICE_BWD_ZERO_AT_N1[kind]:
                        check(bool(a.isfinite().all()),
                              f"{kind} {name}: non-finite values")
                        print(f"  {kind} {name}: zero in exact arithmetic "
                              f"at N = 1; max |kernel| "
                              f"{float(a.abs().max()):.3e}, max |plain| "
                              f"{float(w.abs().max()):.3e}", flush=True)
                        continue
                    err = compare(f"{kind} {name}", a, w,
                                  slice_bwd_rtol(name))
                    rec[kind]["err"] = max(rec[kind]["err"], err)
                    rec[kind]["rel"][name] = max(
                        rec[kind]["rel"].get(name, 0.0),
                        err / float(w.double().abs().max()))
                same = all(torch.equal(a, w) for a, w in zip(got, again))
                print(f"  {kind}: two calls bit-identical: {same}",
                      flush=True)
                check(same, f"{kind} at {tag} is not deterministic")
                if timed:
                    rec[kind]["tf32_control_rel"] = tf32_control(
                        plain_fn, a_k, want, kind)
                del got, again, want
                if not timed:
                    continue
                r = rec[kind]
                r["launches_per_call"][tag] = launches_per_call(
                    kind, lambda: fn(*a_k), shape)
                us, names = sb.flushed_us(lambda: fn(*a_k), 30, None)
                plain_us, _ = sb.flushed_us(lambda: plain_fn(*a_k), 10, None)
                bound = sb.bound_us(kind, shape)
                f32 = sb.bound_us(kind, shape, float32_only=True)
                r["us"][tag], r["plain_us"][tag] = us, plain_us
                r["bound_us"][tag], r["f32_bound_us"][tag] = bound[0], f32[0]
                r["names"].update(names)
                if r["ms"] is None:
                    r["ms"] = cuda_ms(lambda: fn(*a_k))
                    r["plain_ms"] = cuda_ms(lambda: plain_fn(*a_k), reps=5)
                    r["bound"] = (bound[0] / 1e3, bound[1])
                    print_times(r["ms"], r["plain_ms"], r["bound"])
                print(f"  {kind}: device {us:.2f} us per call (profiler, L2 "
                      f"flushed; {names}); plain version {plain_us:.2f} us; "
                      f"bound {bound[0]:.2f} us ({bound[1]}; 3xTF32 tensor "
                      f"cores), {bound[0] / us:.0%} of it; float32-FMA "
                      f"bound {f32[0]:.2f} us ({f32[1]}), context",
                      flush=True)
        del x, st, g_out
        torch.cuda.empty_cache()
    for kind, r in rec.items():
        print(f"  {label} {kind}: largest rel error per gradient over these "
              f"shapes: " + "  ".join(f"{k} {v:.3e}"
                                      for k, v in r["rel"].items()),
              flush=True)
    if not timed:
        return None
    replaces = {"slice_states_bwd": "haet_tpu/ops/pallas/slice_kernels.py:327",
                "deslice_bwd": "haet_tpu/ops/pallas/slice_kernels.py:448"}
    return [kernel_record(k, "haet_torch/csrc/slice_kernels.cu", replaces[k],
                          r["err"], r["ms"], r["plain_ms"], r["bound"],
                          device_us_per_call=r["us"],
                          plain_device_us_per_call=r["plain_us"],
                          bound_us=r["bound_us"],
                          float32_bound_us=r["f32_bound_us"],
                          max_rel_err=r["rel"],
                          tf32_control_rel=r["tf32_control_rel"],
                          launches_per_call=r["launches_per_call"],
                          kernel_names=sorted(r["names"]))
            for k, r in rec.items()]


def slice_bwd_f64(kind, x, ws, bs, wa, ba, st, grad, base_temp=0.5,
                  epsilon=1e-6):
    """The backward ``kind`` in float64: autograd of the softmax over the
    points (the function whose derivative the backwards compute; their
    ``(m, s)`` residuals only make its weights cheap) from the float32
    inputs."""
    import math

    import torch

    leaves = [t.double().requires_grad_() for t in (x, ws, bs, wa, ba, st)]
    xd, wsd, bsd, wad, bad, std = leaves
    tau = base_temp + (xd @ wad + bad).clamp(-0.4, 0.4)
    z = (xd @ wsd + bsd - math.log(-math.log(epsilon))) / tau
    w = torch.softmax(z, dim=2)
    if kind == "slice_states_bwd":
        out = (torch.einsum("bhng,bhnc->bhgc", w, xd)
               / (w.sum(dim=2)[..., None] + 1e-5))
        return torch.autograd.grad(out, leaves[:5], grad.double())
    out = torch.einsum("bhng,bhgc->bhnc", w, std)
    return torch.autograd.grad(out, leaves, grad.double())


def slice_bwd_unscaled_phase(dev):
    """``SLICE_BWD_UNSCALED``: both backwards' kernels and their plain
    versions against float64, the kernels within ``slice_bwd_rtol`` of
    each gradient's float64 max; prints the plain version's distance (what
    float32 itself loses there) beside the kernel's."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    for i, (tag, (shape, factor)) in enumerate(SLICE_BWD_UNSCALED.items()):
        b, h, n, c, gs = shape
        print(f"phase 3b: slice_states_bwd / deslice_bwd ({tag}, weights x "
              f"{factor} against float64)  x [{b}, {h}, {n}, {c}], G {gs}; "
              f"{slice_launches(dev, shape, SLICE_BWD_KINDS)}", flush=True)
        x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 40 + i)
        ws, wa = ws * factor, wa * factor
        g_st, g_out = sb.grads(shape, dev, SEED + 40 + i)
        tau = 0.5 + (x @ wa + ba).clamp(-0.4, 0.4)
        print(f"  rows at temperature 0.1: "
              f"{float((tau < 0.1 + 1e-6).float().mean()):.1%}", flush=True)
        with torch.inference_mode():
            states, m, s = sk.slice_states_plain(x, ws, bs, wa, ba)
        cases = {"slice_states_bwd": (sk.slice_states_bwd,
                                      sk.slice_states_bwd_plain,
                                      (x, ws, bs, wa, ba, states, m, s, g_st),
                                      st, g_st),
                 "deslice_bwd": (sk.deslice_bwd, sk.deslice_bwd_plain,
                                 (x, ws, bs, wa, ba, st, m, s, g_out), st,
                                 g_out)}
        for kind, (fn, plain_fn, args, st_in, grad) in cases.items():
            ref = slice_bwd_f64(kind, x, ws, bs, wa, ba, st_in, grad)
            with torch.inference_mode():
                got, plain = fn(*args), plain_fn(*args)
                torch.cuda.synchronize()
            for name, k, p, r in zip(SLICE_BWD_GRADS[kind], got, plain, ref):
                print(f"  {kind} {name}: plain float32 vs float64 rel "
                      f"{f64_rel(p, r):.3e}", flush=True)
                compare(f"{kind} {name} vs float64", k, r,
                        slice_bwd_rtol(name))
        del x, st, g_out
        torch.cuda.empty_cache()


def plain_bwd_ms(xe, pe, dout, params, kw):
    """ms of the plain block's backward alone: autograd of a recorded plain
    forward."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    leaves = [t.detach().requires_grad_()
              for t in (xe, pe, *(params[k] for k in eb.GRAD_NAMES))]
    lp = dict(zip(eb.GRAD_NAMES, leaves[2:]),
              **{"BMSA.sigma_att": params["BMSA.sigma_att"]})
    out = eb.erwin_block_plain(leaves[0], leaves[1], lp, **kw)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                               retain_graph=True))


def backward_phase(dev, records):
    """Checks and times the backwards; adds the backward kernel's record to
    ``records`` and the slice backwards' times to their forwards' records."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb
    from haet_torch.ops.kernels import slice_kernels as sk

    g = torch.Generator().manual_seed(SEED + 2)
    check(len(eb.GRAD_NAMES) == 14, f"{len(eb.GRAD_NAMES)} parameter grads")

    def erwin_bwd_case(n_e, c_e, ball):
        """The backward kernel's largest error against autograd of the plain
        block over dx, dpos and every parameter gradient; a second call on
        the same inputs must give bit-identical results (no atomics: the
        ranks' and the clouds' partials are summed in a fixed order)."""
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball)
        dout = torch.randn(8, n_e, c_e, generator=g).to(dev)
        dx_k, dpos_k, gr_k = eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                      **kw)
        dx_2, dpos_2, gr_2 = eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                      **kw)
        dx_p, dpos_p, gr_p = eb.erwin_block_bwd_plain(xe, pe, dout, params,
                                                      **kw)
        torch.cuda.synchronize()
        errs = [compare("dx", dx_k, dx_p, KERNEL_RTOL),
                compare("dpos", dpos_k, dpos_p, KERNEL_RTOL)]
        errs += [compare(f"d {k}", gr_k[k], gr_p[k], KERNEL_RTOL)
                 for k in eb.GRAD_NAMES]
        same = (torch.equal(dx_k, dx_2) and torch.equal(dpos_k, dpos_2)
                and all(torch.equal(gr_k[k], gr_2[k]) for k in eb.GRAD_NAMES))
        print(f"  two calls bit-identical (dx, dpos, 14 gradients): {same}",
              flush=True)
        check(same, f"backward at n {n_e} / C {c_e} is not deterministic")
        return xe, pe, params, kw, dout, max(errs)

    errs, times, plain_times, bounds, dev_us = [], [], [], [], {}
    for n_e, c_e, ball, weight in ((32, 32, 32, 16), (16, 64, 16, 8)):
        print(f"phase 3b: fused_erwin_block_bwd  x [8, {n_e}, {c_e}], 8 "
              f"heads, ball {ball}; {erwin_launch_line(n_e, c_e, ball)}",
              flush=True)
        xe, pe, params, kw, dout, err = erwin_bwd_case(n_e, c_e, ball)
        errs.append(err)
        def fn():
            return eb.fused_erwin_block_bwd(xe, pe, dout, params, **kw)
        times.append((cuda_ms(fn), weight))
        dev_us[f"n{n_e}_c{c_e}"] = device_us(fn, ERWIN_BWD_KERNELS)
        plain_times.append((plain_bwd_ms(xe, pe, dout, params, kw), weight))
        bounds.append((erwin_bwd_bound(n_e, c_e, ball), weight))
        print_times(times[-1][0], plain_times[-1][0], bounds[-1][0])
        print(f"  device {dev_us[f'n{n_e}_c{c_e}']:.2f} us per call "
              f"(profiler, erwin_block_bwd + erwin_block_sum_partials)",
              flush=True)
    total = sum(w for _, w in times)
    mix = lambda xs: sum(t * w for t, w in xs) / total  # noqa: E731
    records.append(kernel_record(
        "fused_erwin_block_bwd", "haet_torch/csrc/erwin_block.cu",
        "haet_tpu/ops/pallas/erwin_block.py:187", max(errs), mix(times),
        mix(plain_times),
        (mix([(bd[0], w) for bd, w in bounds]),
         "bytes" if all(bd[1] == "bytes" for bd, _ in bounds)
         else "operations"),
        per_shape_ms={"n32_c32": times[0][0], "n16_c64": times[1][0]},
        device_us_per_call=dev_us))
    for n_e, c_e, ball in ERWIN_EDGES:
        layout = eb.bwd_layout(n_e, c_e, 3, 4 * c_e, 8, min(ball, n_e))
        nbuf = len(eb.BWD_BUFFERS)
        spills = [name for (name, _), in_smem in
                  zip(eb.BWD_BUFFERS, layout.ints[nbuf:2 * nbuf])
                  if not in_smem]
        print(f"phase 3b: fused_erwin_block_bwd at a gate edge  x [8, "
              f"{n_e}, {c_e}], ball {ball}; "
              f"{erwin_launch_line(n_e, c_e, ball)}; in global memory "
              f"{spills}", flush=True)
        erwin_bwd_case(n_e, c_e, ball)

    records.extend(slice_bwd_phase(dev, {"train_b1": SLICE_TIMED["train_b1"]},
                                   timed=True))
    slice_bwd_phase(dev, SLICE_EDGES, timed=False)
    slice_bwd_unscaled_phase(dev)

    print(f"phase 3b: SliceStatesFn / DesliceFn backward  x [1, 8, "
          f"{N_PADDED}, 32], G 32, against autograd of the plain versions",
          flush=True)
    b, h, n, c, gs = 1, 8, N_PADDED, 32, 32
    x = torch.randn(b, h, n, c, generator=g).to(dev)
    ws = (0.3 * torch.randn(c, gs, generator=g)).to(dev)
    bs = (0.1 * torch.randn(gs, generator=g)).to(dev)
    wa = (0.1 * torch.randn(c, 1, generator=g)).to(dev)
    ba = torch.zeros(1).to(dev)
    st_in = torch.randn(b, h, gs, c, generator=g).to(dev)
    g_st = torch.randn(b, h, gs, c, generator=g).to(dev)
    g_out = torch.randn(b, h, n, c, generator=g).to(dev)

    def grads(f_states, f_deslice):
        leaves = [t.detach().requires_grad_()
                  for t in (x, ws, bs, wa, ba, st_in)]
        st, m, s = f_states(*leaves[:5])
        out = f_deslice(*leaves[:5], leaves[5], m, s)
        return torch.autograd.grad([st, out], leaves, [g_st, g_out])

    got = grads(sk.slice_states, sk.deslice)
    want = grads(sk.slice_states_plain, sk.deslice_plain)
    torch.cuda.synchronize()
    err = max(compare(f"d {k}", a, w, SLICE_BWD_RTOL if k.startswith("b_")
                      else KERNEL_RTOL)
              for k, a, w in zip(("x", "w_slice", "b_slice", "w_ada", "b_ada",
                                  "states"), got, want))
    for r in records:
        if r["name"] in SLICE_BWD_GRADS:
            r["autograd_max_abs_err"] = err
    print("  no single PyTorch call computes the block's backward or the "
          "slice backwards: library_ms is null", flush=True)


# ---------------------------------------------------------------------------
# Phase 4: serve the car preset through the kernels.
# ---------------------------------------------------------------------------

def serve_samples():
    """The 11 seeded requests of phases 4 and 10b."""
    rng = np.random.RandomState(SEED)
    return [rng.randn(N_POINTS, 7).astype(np.float32) for _ in range(11)]


def serve_phase(dev):
    import torch

    from haet_torch.models import HAETransolverIrregularMesh
    from haet_torch.utils.config import shapenet_car_config

    kwargs = shapenet_car_config().model_kwargs()
    kwargs.update(use_pallas=True)
    model = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=True,
                                       device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 1_757_190, f"car preset has {n_params} params")
    # Perturb the init weights so the Erwin stage moves the output (at init
    # the slice path dominates and would hide a wrong Erwin block).
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
    kwargs.update(use_pallas=False)
    plain = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=False,
                                       device=dev, seed=SEED)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    model.eval()

    samples = serve_samples()
    with torch.inference_mode():  # warm-up: library loads, allocator
        model(torch.from_numpy(samples[0][None]).to(dev))
        torch.cuda.synchronize()

    outs, counts, forwards, _ = drive_server(model, samples, dev)
    # Agreement with the plain path on the same weights and inputs (the
    # burst's batch of 4 is compared as that same batch: outputs depend on
    # the co-batched samples through the global min-max positions).
    compare_served(outs, samples, plain, dev, "plain path", SERVE_RTOL)
    return counts, forwards, model, samples[0]


def export_bundle(model, dev, root):
    """``model``'s batch family (1, 2, 4) for ``x [32186, 7], fx None``
    exported under ``root`` and loaded back (``haet_torch.export``); prints
    the export and load times."""
    from haet_torch.export import ServingBundle
    from haet_torch.serve import export_batch_family

    x1 = np.zeros((1, N_POINTS, 7), np.float32)
    t0 = time.perf_counter()
    export_batch_family(root, model, None, (x1, None), batch_sizes=(1, 2, 4))
    t1 = time.perf_counter()
    bundle = ServingBundle.load(root, device=dev)
    print(f"  exported batch sizes (1, 2, 4) in {t1 - t0:.1f} s, loaded in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    return bundle


def drive_server(model, samples, dev):
    """``model`` exported as a batch family (1, 2, 4) behind a
    ``BatchingServer`` with the counters zeroed: 4 sequential batch-1
    requests, then a burst of 7 that forms a batch of 4. Checks every
    answer's shape and finiteness, exactly 2 + 2 + 24 kernel launches per
    forward and no plain route; prints the batch histograms, latencies and
    throughput. Returns ``(outputs by request, launch counts, forwards,
    bundle)``."""
    import tempfile

    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)
    from haet_torch.serve import BatchingServer

    with tempfile.TemporaryDirectory(prefix="haet_bundle_") as root:
        bundle = export_bundle(model, dev, root)
    variables = model.state_dict()
    reset_launch_counts()
    outs = {}
    lat_seq = []
    with BatchingServer(bundle, variables, max_delay_s=0.0,
                        device=dev) as srv:
        for i in range(4):
            t0 = time.perf_counter()
            outs[i] = srv.predict(samples[i], None, timeout=300)
            lat_seq.append(time.perf_counter() - t0)
        stats_seq = srv.stats.snapshot()
    t_burst = time.perf_counter()
    with BatchingServer(bundle, variables, max_delay_s=2.0,
                        device=dev) as srv:
        futs = {i: srv.submit(samples[i], None) for i in range(4, 11)}
        for i, f in futs.items():
            outs[i] = f.result(timeout=300)
        stats_burst = srv.stats.snapshot()
    t_burst = time.perf_counter() - t_burst
    counts = launch_counts()
    plain_routes = plain_route_counts()
    forwards = stats_seq["dispatches"] + stats_burst["dispatches"]
    print(f"  sequential batch histogram {stats_seq['batch_histogram']}; "
          f"burst batch histogram {stats_burst['batch_histogram']}",
          flush=True)
    check(stats_burst["batch_histogram"].get(4, 0) >= 1,
          "no batch of 4 formed")
    check(len(outs) == 11, "not every request was answered")
    for i, o in outs.items():
        check(o.shape == (N_POINTS, 4), f"request {i}: shape {o.shape}")
        check(bool(np.isfinite(o).all()), f"request {i}: non-finite output")
    want = {"slice_states": 2 * forwards, "deslice": 2 * forwards,
            "slice_states_bwd": 0, "deslice_bwd": 0,
            "fused_erwin_block": 24 * forwards, "fused_erwin_block_bwd": 0,
            "copy_scale": 0}
    print(f"  forwards {forwards}; launches {counts}; expected {want}",
          flush=True)
    check(counts == want, f"launch counts {counts} != {want}")
    print(f"  calls routed to a plain version {plain_routes}", flush=True)
    check(all(v == 0 for v in plain_routes.values()),
          f"some calls left the kernels: {plain_routes}")

    lat_all = stats_seq["latency_p50_s"], stats_burst["latency_p50_s"]
    print(f"  sequential latency per request (s): "
          f"{[round(t, 6) for t in lat_seq]}; p50 {lat_all[0]:.6f}",
          flush=True)
    print(f"  burst: 7 requests in {t_burst:.4f} s (includes the 2 s "
          f"max_delay of the remainder), p50 latency {lat_all[1]:.6f} s",
          flush=True)
    print(f"  sequential throughput {4 / sum(lat_seq):.3f} samples/s",
          flush=True)
    return outs, counts, forwards, bundle


def compare_served(outs, samples, ref_model, dev, what, rtol):
    """The served batch-1 answer (request 0) and the burst's batch of 4
    (requests 4-7, compared as that batch) against ``ref_model`` on the
    same inputs, within ``rtol`` of max |ref|; returns the two relative
    errors."""
    import torch

    with torch.inference_mode():
        ref1 = ref_model(torch.from_numpy(samples[0][None]).to(dev))[0]
        got1 = torch.from_numpy(outs[0]).to(dev)
        e1 = compare(f"serve batch-1 vs {what}", got1, ref1, rtol)
        batch4 = np.stack([samples[i] for i in range(4, 8)])
        ref4 = ref_model(torch.from_numpy(batch4).to(dev))
        got4 = torch.from_numpy(np.stack([outs[i] for i in range(4, 8)])
                                ).to(dev)
        e4 = compare(f"serve batch-4 vs {what}", got4, ref4, rtol)
    return (e1 / float(ref1.double().abs().max()),
            e4 / float(ref4.double().abs().max()))


def profile_phase(model, sample, dev):
    """Where one batch-1 forward's time goes: device time by kernel
    (torch.profiler) against the forward's wall time."""
    import torch

    from haet_torch.utils.profiling import device_trace, kernel_events

    x = torch.from_numpy(sample[None]).to(dev)
    with torch.inference_mode():
        walls, hosts = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            hosts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with device_trace() as prof:
            model(x)
    wall_ms, host_ms = 1e3 * min(walls), 1e3 * min(hosts)
    events = kernel_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  forward wall {wall_ms:.3f} ms, host {host_ms:.3f} ms (the "
          f"call's return, before the synchronize; min of 5); device time "
          f"{device_ms:.3f} ms in {sum(e.count for e in events)} kernels; "
          f"device busy share {device_ms / wall_ms:.3f}", flush=True)
    for e in events[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "host_ms": host_ms, "device_ms": device_ms,
            "kernels": sum(e.count for e in events)}


# ---------------------------------------------------------------------------
# Phase 6: train the car preset through the kernels.
# ---------------------------------------------------------------------------

def train_phase(dev):
    import torch

    from haet_torch.models import HAETransolverIrregularMesh
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)
    from haet_torch.train import Trainer
    from haet_torch.train.graphs import WARMUP
    from haet_torch.data.shapenet_car import CarSample
    from haet_torch.train.car import loss_fn_builder, make_batch
    from haet_torch.utils.config import (shapenet_car_config,
                                         shapenet_car_train_config)
    from haet_torch.utils.profiling import device_trace, kernel_events

    kwargs = shapenet_car_config().model_kwargs()
    cfg = shapenet_car_train_config()
    rng = np.random.RandomState(SEED + 4)
    x = rng.randn(N_POINTS, 7).astype(np.float32)
    y = rng.randn(N_POINTS, 4).astype(np.float32)
    surf = np.zeros(N_POINTS, bool)
    surf[-N_SURFACE:] = True   # surface points come last in a car sample
    batch = make_batch(CarSample(x[:, :3], x, y, surf))
    check(batch["x"].shape == (1, N_PADDED, 7),
          f"padded batch {batch['x'].shape}")

    def build(flags, eager=False):
        kwargs.update(use_pallas=flags)
        model = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=flags,
                                           device=dev, seed=SEED)
        g = torch.Generator().manual_seed(SEED + 3)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
        return model, Trainer(model, loss_fn_builder(0.5), cfg,
                              total_steps=TRAIN_STEPS + 1,
                              batch_args=lambda bt: (bt["x"], None),
                              eager=eager)

    # The plain path (both flags off, step by step) first: step 1's
    # gradients are kept, two more steps are timed, and the plain model is
    # dropped before the kernel run's memory peak.
    plain, trainer = build(False, eager=True)
    torch.cuda.reset_peak_memory_stats()
    m_plain = {k: float(v) for k, v in trainer.train_step(batch).items()}
    want = {k: None if p.grad is None else p.grad.detach().clone()
            for k, p in plain.named_parameters()}
    plain_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        plain_walls.append(time.perf_counter() - t0)
    plain_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    del plain, trainer
    torch.cuda.empty_cache()

    model, trainer = build(True)
    check(sum(p.numel() for p in model.parameters()) == 1_757_190,
          "car preset size")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    walls, losses = [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        check(all(np.isfinite(v) for v in m.values()),
              f"step {step + 1}: non-finite metrics {m}")
        if step == 0:
            check(abs(m["loss"] - m_plain["loss"])
                  <= GRAD_RTOL * abs(m_plain["loss"]),
                  f"step 1 loss {m['loss']} vs plain {m_plain['loss']}")
            print(f"  step 1: kernels {m}; plain path {m_plain}",
                  flush=True)
            gmax = max(float(g.abs().max()) for g in want.values()
                       if g is not None)
            worst, noise = (0.0, ""), 0
            for name, p in model.named_parameters():
                if name.endswith("sigma_att"):
                    check(p.grad is None and want[name] is None,
                          f"{name} has a gradient")
                    continue
                check(p.grad is not None, f"{name} has no gradient")
                check(bool(p.grad.isfinite().all()),
                      f"{name}: non-finite gradient")
                err = float((p.grad - want[name]).abs().max())
                scale = float(want[name].abs().max())
                tol = max(GRAD_RTOL * scale, GRAD_ATOL * gmax)
                check(err <= tol, f"{name}: gradient error {err} > {tol} "
                                  f"(max |plain grad| {scale})")
                if scale >= GRAD_ATOL * gmax:
                    worst = max(worst, (err / scale, name))
                else:
                    noise += 1
            print(f"  step 1 gradients: every leaf within tolerance; largest "
                  f"error relative to its leaf's max |grad| {worst[0]:.3e} "
                  f"({worst[1]}) over the leaves above {GRAD_ATOL:g} of the "
                  f"largest |grad| {gmax:.3e}; {noise} leaves below it (zero "
                  f"up to round-off)", flush=True)
    counts = launch_counts()
    plain_routes = plain_route_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # the steps are replays of one CUDA graph: the counters rose during its
    # warm-up and capture, and not on a replay
    captured = len(trainer.graphs) * (WARMUP + 1)
    want_counts = {k: v * captured for k, v in PER_STEP.items()}
    print(f"  {TRAIN_STEPS} steps, replays of {len(trainer.graphs)} graph "
          f"(captured in {trainer.graphs.capture_s[0]:.3f} s, {WARMUP} "
          f"warm-up steps thrown away); host launch counters {counts}; "
          f"expected {want_counts}", flush=True)
    check(counts == want_counts, f"launch counts {counts} != {want_counts}")
    print(f"  calls routed to a plain version {plain_routes}", flush=True)
    check(all(v == 0 for v in plain_routes.values()),
          f"some calls left the kernels: {plain_routes}")
    for name, p in model.named_parameters():
        check(bool(p.isfinite().all()), f"{name}: non-finite after training")
    print(f"  losses {losses}", flush=True)
    print(f"  step wall (s) {[round(t, 6) for t in walls]}; min "
          f"{min(walls[1:]):.6f} median {float(np.median(walls[1:])):.6f} "
          f"(steps 2-{TRAIN_STEPS}); peak device memory allocated "
          f"{peak_mb:.1f} MiB", flush=True)
    print(f"  plain path (both flags off): step wall (s) "
          f"{[round(t, 6) for t in plain_walls]} (steps 2-3); peak device "
          f"memory allocated {plain_peak_mb:.1f} MiB", flush=True)

    with device_trace() as prof:
        trainer.train_step(batch)
    events = kernel_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = 1e3 * min(walls[1:])
    print(f"  profiled step (a replay): device time {device_ms:.3f} ms in "
          f"{sum(e.count for e in events)} kernels; busy share "
          f"{device_ms / wall_ms:.3f} of the min step wall {wall_ms:.3f} ms",
          flush=True)
    for e in events[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    replay = replay_calls("kernel calls in one replay, from the profiler",
                          trainer.train_step, batch)
    return counts, replay["calls"]


# ---------------------------------------------------------------------------
# Phase 7: the benchmark drivers and the copy kernel.
# ---------------------------------------------------------------------------

COPY_CHAIN = 1050            # the micro driver's hi window
#: the copy kernel's large timed shape: 64 MiB each way, past the 50 MB L2
COPY_LARGE = (4096, 4096)
#: the micro driver's reduced lo/hi windows and rounds
MICRO_REPS = dict(reps_lo=20, reps_hi=220, rounds=2)
#: bench_flags' reduced windows: k_lo/k_hi steps and rounds
FLAGS_STEPS = dict(k_lo=1, k_hi=3, rounds=1)
#: bench_loop_diag's and profile_step's windows, at the car's 32768 points
LOOP_DIAG = dict(ks=(1, 3), rounds=1)
PROFILE_STEP = dict(lo=1, hi=2, rounds=1)
#: bench_flags' --slice_num past the old G*C gate of the slice kernels
FLAGS_WIDE_G = 128
#: the slice kernels' check and the memory probes: ~30x the car's points
N_LARGE = 1 << 20


def copy_phase(dev):
    """7a: ``copy_scale`` bit-exact against its plain version after one
    call and after ``COPY_CHAIN`` chained calls; its record, with the time
    of ``torch.mul`` as the library time."""
    import torch

    from haet_torch.benchmarks.copy_scale import graph_us
    from haet_torch.ops.kernels import copy_kernel as ck

    g = torch.Generator().manual_seed(SEED + 5)
    x = torch.randn(256, 32, generator=g).to(dev)
    print("phase 7a: copy_scale  x [256, 32] f32", flush=True)
    got, want = ck.copy_scale(x), ck.copy_scale_plain(x)
    chained, want_chain = ck.chain_copy(x, COPY_CHAIN), x
    for _ in range(COPY_CHAIN):
        want_chain = ck.copy_scale_plain(want_chain)
    torch.cuda.synchronize()
    err = max(float((got - want).abs().max()),
              float((chained - want_chain).abs().max()))
    print(f"  1 call: bit-exact {torch.equal(got, want)}; {COPY_CHAIN} "
          f"chained calls: bit-exact {torch.equal(chained, want_chain)}",
          flush=True)
    check(torch.equal(got, want), "copy_scale differs from x * 1.000001")
    check(torch.equal(chained, want_chain),
          f"chain_copy differs after {COPY_CHAIN} calls")
    # The kernel's other two routes: an input 4 bytes past a 16-byte
    # boundary (the scalar kernel), and an aligned one of 8191 elements
    # (float4 loads and a scalar tail of 3).
    flat = x.view(-1)
    for what, xs in (("unaligned [8191]", flat[1:]),
                     ("aligned [8191], tail 3", flat[:-1])):
        got_s, want_s = ck.copy_scale(xs), ck.copy_scale_plain(xs)
        torch.cuda.synchronize()
        print(f"  {what}: bit-exact {torch.equal(got_s, want_s)}",
              flush=True)
        check(torch.equal(got_s, want_s),
              f"copy_scale differs from x * 1.000001 on the {what} input")
        err = max(err, float((got_s - want_s).abs().max()))
    ms = cuda_ms(lambda: ck.copy_scale(x), reps=200)
    plain_ms = cuda_ms(lambda: ck.copy_scale_plain(x), reps=200)
    library_ms = cuda_ms(lambda: torch.mul(x, ck.SCALE), reps=200)
    # On the card's own clock: the event times above are the host's launch
    # rate at this size (the ctypes wrapper against torch.mul's dispatch).
    dev = {"copy_scale": device_us(lambda: ck.copy_scale(x), reps=200),
           "torch.mul": device_us(lambda: torch.mul(x, ck.SCALE), reps=200)}
    # and from a CUDA graph of 100 calls: the card's time per call with
    # no host in the way
    graph = {"copy_scale": graph_us(lambda: ck.copy_scale(x)),
             "torch.mul": graph_us(lambda: torch.mul(x, ck.SCALE))}
    bound = bound_ms(2 * 4 * x.numel(), x.numel())
    print_times(ms, plain_ms, bound)
    print(f"  library torch.mul {library_ms:.4f} ms; device us per call "
          f"(profiler): copy_scale {dev['copy_scale']:.3f}, torch.mul "
          f"{dev['torch.mul']:.3f}; in a CUDA graph: copy_scale "
          f"{graph['copy_scale']:.3f}, torch.mul {graph['torch.mul']:.3f}",
          flush=True)
    large = copy_large(ck)
    rec = kernel_record("copy_scale", "haet_torch/csrc/copy_kernel.cu",
                        "benchmarks/micro_erwin_fused.py:70", err, ms,
                        plain_ms, bound,
                        device_us_per_call=dev["copy_scale"],
                        library_device_us_per_call=dev["torch.mul"],
                        graph_us_per_call=graph["copy_scale"],
                        library_graph_us_per_call=graph["torch.mul"],
                        **large)
    rec["library_ms"] = library_ms
    return rec


def copy_large(ck):
    """7a at ``COPY_LARGE`` (64 MiB each way, past the L2): bit-exact,
    then the kernel's and ``torch.mul``'s device time per call (profiler)
    and events time, and the bytes bound."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x = torch.randn(COPY_LARGE, generator=g, device="cuda")
    print(f"phase 7a: copy_scale  x {list(COPY_LARGE)} f32", flush=True)
    got, want = ck.copy_scale(x), ck.copy_scale_plain(x)
    torch.cuda.synchronize()
    print(f"  bit-exact {torch.equal(got, want)}", flush=True)
    check(torch.equal(got, want),
          f"copy_scale differs from x * 1.000001 at {list(COPY_LARGE)}")
    del got, want
    bound = bound_ms(2 * 4 * x.numel(), x.numel())
    ms = cuda_ms(lambda: ck.copy_scale(x), reps=50)
    library_ms = cuda_ms(lambda: torch.mul(x, ck.SCALE), reps=50)
    us = device_us(lambda: ck.copy_scale(x), reps=50)
    library_us = device_us(lambda: torch.mul(x, ck.SCALE), reps=50)
    print(f"  device us per call (profiler): copy_scale {us:.3f}, torch.mul "
          f"{library_us:.3f} (ratio {us / library_us:.4f}); bound "
          f"{bound[0] * 1e3:.3f} us ({bound[1]}), {bound[0] * 1e3 / us:.3f} "
          f"of it; events ms copy_scale {ms:.5f}, torch.mul "
          f"{library_ms:.5f}", flush=True)
    return {"large_shape": list(COPY_LARGE), "large_ms": ms,
            "large_library_ms": library_ms,
            "large_device_us_per_call": us,
            "large_library_device_us_per_call": library_us,
            "large_bound_ms": bound[0]}


#: 7b's Erwin block shapes, ``tag: (n, C, ball, heads, mlp_ratio)``: the
#: micro driver's block, and the two that bench_flags' ``pallas-erwin``
#: model runs (constructor defaults: Erwin mlp_ratio 2, heads 4/8/4)
DRIVER_SHAPES = {"micro": (32, 32, 32, 4, 4),
                 "flags_n32_c32": (32, 32, 32, 4, 2),
                 "flags_n16_c64": (16, 64, 16, 8, 2)}


def driver_shape_phase(dev, records):
    """7b: the Erwin forward and backward kernels at the drivers' block
    shapes (``DRIVER_SHAPES``; 4 heads and SwiGLU 2C are shapes the car
    never uses) against the plain block at phase 3/3b's tolerance: out,
    dx, dpos and every parameter gradient. Their times, bounds and errors
    go into the forward and backward records as ``<tag>_*``."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    g = torch.Generator().manual_seed(SEED + 6)
    for tag, (n_e, c_e, ball, heads, ratio) in DRIVER_SHAPES.items():
        print(f"phase 7b: fused_erwin_block fwd/bwd ({tag})  x [8, {n_e}, "
              f"{c_e}], {heads} heads, ball {ball}, SwiGLU {ratio * c_e}; "
              f"{erwin_launch_line(n_e, c_e, ball, heads, ratio)}",
              flush=True)
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball, heads,
                                          ratio)
        dout = torch.randn(8, n_e, c_e, generator=g).to(dev)
        with torch.inference_mode():
            o_k = eb.fused_erwin_block(xe, pe, params, **kw)
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            err_f = compare("out", o_k, o_p, KERNEL_RTOL)
        dx_k, dpos_k, gr_k = eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                      **kw)
        dx_p, dpos_p, gr_p = eb.erwin_block_bwd_plain(xe, pe, dout, params,
                                                      **kw)
        torch.cuda.synchronize()
        err_b = max([compare("dx", dx_k, dx_p, KERNEL_RTOL),
                     compare("dpos", dpos_k, dpos_p, KERNEL_RTOL)]
                    + [compare(f"d {k}", gr_k[k], gr_p[k], KERNEL_RTOL)
                       for k in eb.GRAD_NAMES])
        with torch.inference_mode():
            fwd = (cuda_ms(lambda: eb.fused_erwin_block(xe, pe, params,
                                                        **kw)),
                   cuda_ms(lambda: eb.erwin_block_plain(xe, pe, params,
                                                        **kw)))
            fwd_us = device_us(lambda: eb.fused_erwin_block(
                xe, pe, params, **kw), ERWIN_FWD_KERNELS)
        bwd = (cuda_ms(lambda: eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                        **kw)),
               plain_bwd_ms(xe, pe, dout, params, kw))
        bwd_us = device_us(lambda: eb.fused_erwin_block_bwd(
            xe, pe, dout, params, **kw), ERWIN_BWD_KERNELS)
        bounds = {"fused_erwin_block": erwin_fwd_bound(n_e, c_e, ball, heads,
                                                       ratio),
                  "fused_erwin_block_bwd": erwin_bwd_bound(n_e, c_e, ball,
                                                           heads, ratio)}
        times = {"fused_erwin_block": (fwd, err_f, fwd_us),
                 "fused_erwin_block_bwd": (bwd, err_b, bwd_us)}
        for r in records:
            if r["name"] in times:
                (ms, plain_ms), err, us = times[r["name"]]
                r.update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms,
                          f"{tag}_bound_ms": bounds[r["name"]][0],
                          f"{tag}_max_abs_err": err})
                r["device_us_per_call"][tag] = us
                print(f"  {r['name']}:", flush=True)
                print_times(ms, plain_ms, bounds[r["name"]])
                print(f"  device {us:.2f} us per call (profiler)",
                      flush=True)


def large_slice_phase(dev):
    """7c: the slice kernels, untimed, at ``N_LARGE`` points, the memory
    probes' size."""
    slice_phase(dev, {"large": (1, 8, N_LARGE, 32, 32)}, timed=False,
                label="phase 7c")


def replay_calls(what, fn, *args) -> dict:
    """``profile_launches(fn, *args)`` of one graph replay, its kernel
    calls held to ``PER_STEP``; returns the trace's counts."""
    from haet_torch.ops.kernels import profile_launches

    _, replay = profile_launches(fn, *args)
    print(f"  the trace's sentinels took the loss of its first "
          f"{replay['lost']} device records, {time.perf_counter() - T0:.0f} "
          f"s into the process", flush=True)
    expect_counts(what, replay["calls"], PER_STEP)
    return replay


def expect_counts(what, counts, want):
    print(f"  {what}: {counts}; expected {want}", flush=True)
    check(counts == want, f"{what}: {counts} != {want}")


def drivers_phase(dev):
    """7d-7g: run each benchmark driver briefly on the card and check from
    the launch counters that its kernel paths went through the kernels.
    Returns the copy kernel's launch count after the micro driver's run
    and each part's seconds."""
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from haet_torch import bench
    from haet_torch.benchmarks import (bench_flags, bench_loop_diag,
                                       mem_sweep, profile_step)
    from haet_torch.benchmarks import micro_erwin_fused as micro
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)

    no_routes = {k: 0 for k in plain_route_counts()}
    marks = [time.perf_counter()]
    print(f"phase 7d: micro_erwin_fused {MICRO_REPS}", flush=True)
    reset_launch_counts()
    res = micro.run(dev, **MICRO_REPS)
    counts, routes = launch_counts(), plain_route_counts()
    calls = res["copy_calls"]   # the driver's chained calls per line
    expect_counts("launches", counts, {
        "slice_states": 0, "deslice": 0, "slice_states_bwd": 0,
        "deslice_bwd": 0, "fused_erwin_block": 2 * calls,
        "fused_erwin_block_bwd": calls, "copy_scale": calls})
    expect_counts("plain routes", routes, no_routes)
    for name in ("copy_scale", "fused block fwd", "fused block fwd+bwd"):
        check(res[name]["device_us"] is not None
              and res[name]["device_us"] > 0, f"{name}: no device time")
    copy_launches = counts["copy_scale"]
    marks.append(time.perf_counter())

    print(f"phase 7e: bench_flags {FLAGS_STEPS}", flush=True)
    reset_launch_counts()
    res = bench_flags.run(dev, **FLAGS_STEPS)
    print(f"phase 7e: bench_flags {FLAGS_STEPS}, pallas-tokenizer at "
          f"--slice_num {FLAGS_WIDE_G} (G*C {32 * FLAGS_WIDE_G})", flush=True)
    wide = bench_flags.run(dev, slice_num=FLAGS_WIDE_G,
                           variants=["pallas-tokenizer"], **FLAGS_STEPS)
    res[f"pallas-tokenizer G {FLAGS_WIDE_G}"] = wide["pallas-tokenizer"]
    for name, r in res.items():
        blocks = r["erwin_blocks"]
        check(blocks == 12, f"{name}: {blocks} Erwin blocks, expected 12 "
                            "(2 layers of depths 2/2/2)")
        check(np.isfinite(r["ms_per_step"]), f"{name}: step time")
        want = {"slice_states": 0, "deslice": 0, "slice_states_bwd": 0,
                "deslice_bwd": 0, "fused_erwin_block": 0,
                "fused_erwin_block_bwd": 0, "copy_scale": 0}
        if name.startswith("pallas-tokenizer"):
            want.update(slice_states=2, deslice=2, slice_states_bwd=2,
                        deslice_bwd=2)
        elif name == "pallas-erwin":
            want.update(fused_erwin_block=blocks,
                        fused_erwin_block_bwd=blocks)
        expect_counts(f"{name} launches per step ({r['steps']} steps)",
                      r["launches_per_step"], want)
        expect_counts(f"{name} plain routes per step",
                      r["plain_routes_per_step"], no_routes)
        check(r["graph_ms_per_step"] is not None
              and np.isfinite(r["graph_ms_per_step"]),
              f"{name}: graph step time {r['graph_ms_per_step']}")
        expect_counts(f"{name} kernel calls per replayed step (profiler)",
                      r["graph_calls_per_step"], want)
        print(f"  {name}: ms per step dispatched {r['ms_per_step']:.3f}, "
              f"graph {r['graph_ms_per_step']:.3f}; device "
              f"{r['device_ms_per_step']:.3f} and "
              f"{r['graph_device_ms_per_step']:.3f}", flush=True)
    marks.append(time.perf_counter())

    print("phase 7f: haet_torch.bench, 2 rounds", flush=True)
    rec = bench.run(dev, budget_s=0.0, rounds=2)
    print(f"  {json.dumps(rec)}", flush=True)
    check(np.isfinite(rec["value"]) and rec["value"] > 0,
          f"bench value {rec['value']}")
    check(rec["mfu"] is not None and 0 < rec["mfu"] < 1,
          f"bench mfu {rec['mfu']}")
    for s in ("dispatch", "graph"):
        check(np.isfinite(rec[f"{s}_sec_per_step"])
              and rec[f"{s}_sec_per_step"] > 0,
              f"bench {s} seconds per step {rec[f'{s}_sec_per_step']}")
    check(rec["sec_per_step"] == min(rec["dispatch_sec_per_step"],
                                     rec["graph_sec_per_step"]),
          "bench does not report the better strategy")
    del rec
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    print(f"phase 7h: bench_loop_diag {LOOP_DIAG}, then profile_step "
          f"{PROFILE_STEP}", flush=True)
    diag = bench_loop_diag.run(dev, points=N_PADDED, **LOOP_DIAG)
    for v, r in diag.items():
        check(all(np.isfinite(t) and t > 0
                  for t in r["ms_per_window"].values()),
              f"bench_loop_diag {v}: windows {r['ms_per_window']}")
    prof = profile_step.run(dev, points=N_PADDED, **PROFILE_STEP)
    for name, r in prof.items():
        check(r["graph_wall_ms"] is not None
              and np.isfinite(r["graph_wall_ms"]),
              f"profile_step {name}: graph wall {r['graph_wall_ms']}")
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    print(f"phase 7g: mem_sweep probes at N = {N_LARGE}, forward only, "
          f"each in a fresh process (both at once: each reads its own "
          f"allocator's peak)", flush=True)
    with ThreadPoolExecutor(2) as pool:
        futs = {pallas: pool.submit(mem_sweep.probe_subprocess, N_LARGE,
                                    pallas) for pallas in (False, True)}
        probes = {pallas: f.result() for pallas, f in futs.items()}
    for pallas, p in probes.items():
        print(f"  {json.dumps(p)}", flush=True)
        check(p.get("ok") is True, f"probe pallas={pallas} failed: {p}")
        n = int(pallas)
        check(p["slice_launches"] == {"slice_states": n, "deslice": n},
              f"probe pallas={pallas}: slice launches {p['slice_launches']}")
    plain_mb, kernel_mb = (probes[False]["peak_memory_mb"],
                           probes[True]["peak_memory_mb"])
    print(f"  peak device memory: plain path {plain_mb:.1f} MiB, slice "
          f"kernels {kernel_mb:.1f} MiB", flush=True)
    check(kernel_mb < plain_mb,
          f"kernel path peak {kernel_mb} MiB is not below plain {plain_mb}")
    marks.append(time.perf_counter())
    laps = {k: b - a for k, a, b in zip(("7d", "7e", "7f", "7h", "7g"),
                                         marks, marks[1:])}
    return copy_launches, laps


# ---------------------------------------------------------------------------
# Phase 8: the car preset's training run (Trainer.fit) and its drivers.
# ---------------------------------------------------------------------------

FIT_EPOCHS = 3
#: car_like samples of a ShapeNet-Car size: 3 for training, 1 held out
FIT_SAMPLES = 4
#: kernel launches per train step and per eval forward of the car preset
PER_STEP = {"slice_states": 2, "deslice": 2, "slice_states_bwd": 2,
            "deslice_bwd": 2, "fused_erwin_block": 24,
            "fused_erwin_block_bwd": 24, "copy_scale": 0}
PER_FORWARD = {"slice_states": 2, "deslice": 2, "slice_states_bwd": 0,
               "deslice_bwd": 0, "fused_erwin_block": 24,
               "fused_erwin_block_bwd": 0, "copy_scale": 0}
RESUME_RTOL = 1e-5
#: rounds of (bare, fit, fit, bare) for fit's overhead per step
WALL_ROUNDS = 3
DRIVER_EPOCHS = 2


def expected_launches(steps: int, forwards: int) -> dict:
    return {k: PER_STEP[k] * steps + PER_FORWARD[k] * forwards
            for k in PER_STEP}


def car_fold():
    """``car_like(n=4, npts=32186, seed=0)`` as normalised ``CarSample``s
    (statistics of the 3 training samples), split 3 / 1."""
    from haet_torch.data import synthetic
    from haet_torch.data.shapenet_car import CarSample, compute_coef_norm
    from haet_torch.train.car import bucket_size

    raw = synthetic.car_like(n=FIT_SAMPLES, npts=N_POINTS, seed=0)
    samples = [CarSample(pos=d["pos"], x=d["x"], y=d["y"], surf=d["surf"],
                         name=f"synthetic/{i}", quads=d["quads"],
                         surf_slice=d["surf_slice"])
               for i, d in enumerate(raw)]
    coef = compute_coef_norm(samples[:3])
    samples = [coef.encode(s) for s in samples]
    print("  samples (points -> bucket): " + ", ".join(
        f"{len(s.pos)} -> {bucket_size(len(s.pos))}" for s in samples),
        flush=True)
    return samples[:3], samples[3:], coef


def state_on_cpu(trainer) -> dict:
    """The trainer's model and Adam tensors, and the rest of its state,
    copied to the host."""
    import torch

    def host(v):
        return v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
    sd = trainer.state_dict()
    return {"model": {k: host(v) for k, v in sd["model"].items()},
            "adam": {(i, k): host(v)
                     for i, st in sd["optimizer"]["state"].items()
                     for k, v in st.items()},
            "groups": sd["optimizer"]["param_groups"],
            "scheduler": sd["scheduler"], "step": sd["step"]}


def compare_states(got: dict, want: dict) -> bool:
    """Every model and Adam tensor within ``RESUME_RTOL`` of its max, the
    rest equal; returns whether every tensor is bit-identical."""
    import torch

    check(got["step"] == want["step"], f"step {got['step']} != "
                                       f"{want['step']}")
    check(got["scheduler"] == want["scheduler"], "OneCycleLR state differs")
    check(got["groups"] == want["groups"], "Adam's param groups differ")
    identical, worst = True, (0.0, "")
    for part in ("model", "adam"):
        check(sorted(map(str, got[part])) == sorted(map(str, want[part])),
              f"{part} keys differ")
        for k, w in want[part].items():
            g = got[part][k]
            if w.is_floating_point():
                err = float((g.double() - w.double()).abs().max())
                tol = RESUME_RTOL * max(float(w.double().abs().max()), 1e-30)
                check(err <= tol, f"resume: {part} {k} differs by {err} > "
                                  f"{tol}")
                worst = max(worst, (err / max(tol / RESUME_RTOL, 1e-30),
                                    f"{part} {k}"))
            identical = identical and torch.equal(g, w)
    print(f"  resumed run against the unbroken one: largest error "
          f"relative to its leaf's max {worst[0]:.3e} ({worst[1]}); "
          f"bit-identical {identical}", flush=True)
    return identical


def fit_phase(dev):
    """8a: ``Trainer.fit`` of the car preset on the card: 3 epochs over 3
    car-sized samples, eval on the fourth every epoch, ``best``/``last``
    checkpoints; exact launch counts, no plain route; a stopped and resumed
    run against the unbroken one; ``last`` restored on the CPU; walls
    beside bare ``train_step``s on the same batches; peak memory."""
    import tempfile
    import threading

    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        profile_launches,
                                        reset_launch_counts)
    from haet_torch.train import Checkpointer, MetricsLogger, Trainer
    from haet_torch.train.car import loss_fn_builder, make_batch
    from haet_torch.train.graphs import WARMUP, signature
    from haet_torch.utils.config import (shapenet_car_config,
                                         shapenet_car_train_config)

    quiet = MetricsLogger(echo=False)   # fit returns its epoch records
    train, val, _ = car_fold()
    batches = [make_batch(s) for s in train]
    evals = [make_batch(s) for s in val]
    cfg = shapenet_car_train_config()
    cfg.epochs = FIT_EPOCHS
    check(cfg.early_stop_patience == 7, "early stopping not armed")
    steps = FIT_EPOCHS * len(train)

    def trainer(dev=dev, seed=SEED):
        model = build_model(shapenet_car_config(), dev, seed=seed)
        return Trainer(model, loss_fn_builder(0.5), cfg, total_steps=steps,
                       batch_args=lambda b: (b["x"], None))

    tmp = tempfile.mkdtemp(prefix="haet_fit_")
    whole = trainer()
    check(whole.num_params() == 1_757_190, "car preset size")
    ck = Checkpointer(f"{tmp}/whole")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs = whole.fit(lambda: iter(batches), lambda: iter(evals),
                     checkpointer=ck, logger=quiet)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, routes = launch_counts(), plain_route_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # fit's steps replay one CUDA graph per training bucket: the host
    # counters rose in each graph's warm-up and capture, and in the eval
    # forwards; the launches of the replays are read from the profiler on
    # the resumed run below
    graphs = len({signature(b) for b in batches})
    check(len(whole.graphs) == graphs,
          f"{len(whole.graphs)} graphs for {graphs} training buckets")
    want = expected_launches(graphs * (WARMUP + 1), FIT_EPOCHS * len(val))
    expect_counts(f"host launch counters over {steps} steps ({graphs} "
                  f"graphs captured) and {FIT_EPOCHS * len(val)} eval "
                  f"forwards", counts, want)
    expect_counts("plain routes", routes, {k: 0 for k in routes})
    check([r["epoch"] for r in recs] == list(range(FIT_EPOCHS)),
          f"epochs {[r['epoch'] for r in recs]}")
    for r in recs:
        for k in ("train/loss", "val/loss", "train/grad_norm"):
            check(np.isfinite(r[k]), f"epoch {r['epoch']}: {k} {r[k]}")
        print(f"  epoch {r['epoch']}: train/loss {r['train/loss']:.6f} "
              f"val/loss {r['val/loss']:.6f} lr "
              f"{r['train/learning_rate']:.3e} wall "
              f"{r['epoch/time_seconds']:.4f} s (host per step "
              f"{r['train/avg_batch_time']:.4f} s)", flush=True)
    for name in ("best", "last"):
        check(ck.restore(name, map_location="cpu") is not None,
              f"no '{name}' checkpoint")
    print(f"  fit: {FIT_EPOCHS} epochs in {fit_s:.3f} s; best (epoch "
          f"{ck.best_epoch}) and last written; peak device memory "
          f"{peak_mb:.1f} MiB", flush=True)
    want_state = state_on_cpu(whole)

    # `last`, written on the card, restored on the CPU
    cpu = trainer(dev="cpu", seed=SEED + 1)
    check(cpu.maybe_restore(Checkpointer(f"{tmp}/whole")), "no last")
    for k, v in cpu.model.state_dict().items():
        check(torch.equal(v, want_state["model"][k]),
              f"{k} differs after a restore on the CPU")
    print("  'last' restored on the CPU: every model tensor equal", flush=True)
    del cpu

    # stopped after epoch 1 (the event set as epoch 2's batches are asked
    # for), then resumed through a fresh Trainer and Checkpointer
    ev = threading.Event()
    passes = []

    def stopping():
        passes.append(1)
        if len(passes) == FIT_EPOCHS:
            ev.set()
        return iter(batches)

    first = trainer()
    first.fit(stopping, lambda: iter(evals), stop_event=ev,
              checkpointer=Checkpointer(f"{tmp}/stopped"), logger=quiet)
    check(first.step == (FIT_EPOCHS - 1) * len(train),
          f"stopped at step {first.step}")
    del first
    resumed = trainer(seed=SEED + 2)
    check(resumed.maybe_restore(Checkpointer(f"{tmp}/stopped")),
          "nothing to resume")
    reset_launch_counts()
    recs2, device = profile_launches(
        lambda: resumed.fit(lambda: iter(batches), lambda: iter(evals),
                            checkpointer=Checkpointer(f"{tmp}/stopped"),
                            logger=quiet))
    # the device ran each graph's warm-up steps and then every step as a
    # replay; the eval forwards are eager
    expect_counts(f"kernel calls on the device over the resumed epoch's "
                  f"{len(batches)} steps and {len(val)} eval forward "
                  f"(profiler)", device["calls"],
                  expected_launches(len(batches) + WARMUP * graphs,
                                    len(val)))
    expect_counts("plain routes", plain_route_counts(),
                  {k: 0 for k in routes})
    check([r["epoch"] for r in recs2] == [FIT_EPOCHS - 1],
          f"resumed epochs {[r['epoch'] for r in recs2]}")
    identical = compare_states(state_on_cpu(resumed), want_state)
    del resumed

    # fit's wall per step against bare train_step's, same batches: a fit
    # with no eval and no checkpoints, and the bare loop, in turns
    walls = {"bare": [], "fit": []}
    for side in ("bare", "fit", "fit", "bare") * WALL_ROUNDS:
        t = trainer()
        for b in batches:   # the captures, outside the timed region
            t.graphs.prepare([b])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == "bare":
            for _ in range(FIT_EPOCHS):
                for b in batches:
                    t.train_step(b)
        else:
            t.fit(lambda: iter(batches), logger=quiet)
        torch.cuda.synchronize()
        walls[side].append((time.perf_counter() - t0) / steps)
        del t
    bare, fitted = (float(np.median(walls[k])) for k in ("bare", "fit"))
    print(f"  wall per step (s), median of {2 * WALL_ROUNDS} runs of {steps} "
          f"steps: bare train_step {bare:.5f}, fit {fitted:.5f} (overhead "
          f"{1e3 * (fitted - bare):.3f} ms per step); mins "
          f"{min(walls['bare']):.5f}, {min(walls['fit']):.5f}; runs "
          f"{ {k: [round(v, 5) for v in w] for k, w in walls.items()} }",
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"epoch_s": [r["epoch/time_seconds"] for r in recs],
            "bare_step_s": bare, "fit_step_s": fitted, "peak_mb": peak_mb,
            "resume_bit_identical": identical}


def drivers_car_phase(dev, epochs: int = DRIVER_EPOCHS, bf16: bool = False,
                      keep: bool = False):
    """8b: ``car_train --epochs 2`` at full width on the synthetic
    stand-in, in a subprocess, then ``car_eval --which last`` on its
    checkpoints; every metric finite, and ``car_eval`` reproduces
    ``car_train``'s final metrics at rtol 1e-5. With ``bf16`` (phase 10d):
    ``car_train --bf16 1 --mu_bf16 1``, and ``car_eval`` (float32, as the
    JAX driver evaluates) within ``BF16_METRIC_RTOL`` of its bf16
    metrics. With ``keep`` the run's directory stays, for phase 11, and
    the result names it (``run_dir``)."""
    import tempfile

    from haet_torch.benchmarks import car_eval
    from haet_torch.ops.kernels import launch_counts, reset_launch_counts

    tmp = tempfile.mkdtemp(prefix="haet_drivers_")
    common = ["--data_dir", f"{tmp}/absent"]
    cmd = [sys.executable, "-m", "haet_torch.benchmarks.car_train",
           "--epochs", str(epochs), "--out_dir", tmp, *common,
           *(["--bf16", "1", "--mu_bf16", "1"] if bf16 else [])]
    print(f"  {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    for ln in proc.stdout.splitlines():
        if ln.startswith(("train ", "nb_parameters", "epoch=", "time:")):
            print(f"    {ln[:240]}", flush=True)
    check(proc.returncode == 0, f"car_train failed:\n{proc.stderr[-3000:]}")
    check("nb_parameters 1757190" in proc.stdout, "car_train model size")
    with open(f"{tmp}/car_metrics.jsonl") as f:
        rec = [json.loads(ln) for ln in f if '"eval/' in ln][-1]
    trained = {k[len("eval/"):]: v for k, v in rec.items()
               if k.startswith("eval/")}
    print(f"  car_train ({wall:.1f} s): {trained}", flush=True)
    reset_launch_counts()
    got = car_eval.main(common + ["--which", "last", "--checkpoint_dir",
                                  f"{tmp}/checkpoints/car"])
    n_val = 2   # the stand-in's validation samples
    expect_counts("car_eval launches", launch_counts(),
                  expected_launches(0, n_val))
    print(f"  car_eval: {got}", flush=True)
    check(sorted(got) == sorted(trained), "metric keys differ")
    rtol = BF16_METRIC_RTOL if bf16 else 1e-5
    gaps = {k: abs(v - trained[k]) / abs(trained[k]) for k, v in got.items()
            if k != "time_per_sample" and trained[k]}
    print(f"  car_eval against car_train, relative: {gaps}; held to {rtol}",
          flush=True)
    for k, v in got.items():
        check(np.isfinite(v) and np.isfinite(trained[k]),
              f"non-finite metric {k}")
        if k != "time_per_sample":
            check(abs(v - trained[k]) <= rtol * abs(trained[k]),
                  f"car_eval {k} {v} != car_train's {trained[k]}")
    print(f"  time_per_sample: car_train {trained['time_per_sample']:.5f} "
          f"s, car_eval {got['time_per_sample']:.5f} s", flush=True)
    if not keep:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"train_time_per_sample": trained["time_per_sample"],
            "eval_time_per_sample": got["time_per_sample"],
            **({"run_dir": tmp} if keep else {})}


# ---------------------------------------------------------------------------
# Phase 9: the train step as CUDA graphs, against the eager step.
# ---------------------------------------------------------------------------

#: two training buckets, so that the graphs switch from step to step
GRAPH_POINTS = (30000, N_POINTS)     # buckets 30720 and 32768
GRAPH_STEPS = 6
#: graphed against eager: each leaf within this of its max
GRAPH_RTOL = 1e-6
SCAN_STEPS = 5
#: replays (and eager steps) timed for the walls
WALL_STEPS = 12


def graph_batches(n, seeds):
    """Car-like batches of ``n`` points (surface last), one per seed."""
    from haet_torch.data.shapenet_car import CarSample
    from haet_torch.train.car import make_batch

    out = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        x = rng.randn(n, 7).astype(np.float32)
        y = rng.randn(n, 4).astype(np.float32)
        surf = np.zeros(n, bool)
        surf[-N_SURFACE:] = True
        out.append(make_batch(CarSample(x[:, :3], x, y, surf)))
    return out


def train_state(trainer, rates: bool = True) -> dict:
    """Every tensor of the training state, by name: parameters, BatchNorm
    buffers (``num_batches_tracked`` too), Adam's state and, with
    ``rates``, the lr and beta1 of the last step."""
    st = {f"model {k}": v for k, v in trainer.model.state_dict().items()}
    for i, p in enumerate(trainer.params):
        for k, v in trainer.optimizer.state[p].items():
            st[f"adam {i} {k}"] = v
    if rates:
        st["lr, beta1"] = trainer.optimizer.hparams
    return st


def hold_states(what, got, want, rates: bool = True) -> bool:
    """Each of ``got``'s tensors within ``GRAPH_RTOL`` of the max of
    ``want``'s; returns whether all are bit-identical."""
    import torch

    got, want = train_state(got, rates), train_state(want, rates)
    check(sorted(got) == sorted(want), f"{what}: state keys differ")
    identical, worst = True, (0.0, "")
    for k, w in want.items():
        g = got[k]
        err = float((g.double() - w.double()).abs().max())
        scale = max(float(w.double().abs().max()), 1e-30)
        check(err <= GRAPH_RTOL * scale,
              f"{what}: {k} differs by {err} > {GRAPH_RTOL} x {scale}")
        worst = max(worst, (err / scale, k))
        identical = identical and torch.equal(g, w)
    print(f"  {what}: {len(want)} tensors, largest error relative to its "
          f"max {worst[0]:.3e} ({worst[1]}); bit-identical {identical}",
          flush=True)
    return identical


def hold_step(what, got, want, rates) -> bool:
    """One step's metrics (and the lr and beta1 it applied: ``rates``, the
    two trainers' ``hparams`` after it) within ``GRAPH_RTOL``."""
    import torch

    identical = True
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        check(abs(g - w) <= GRAPH_RTOL * abs(w), f"{what}: {k} {g} != {w}")
        identical = identical and g == w
    check(torch.equal(*rates), f"{what}: lr, beta1 {rates[0].tolist()} != "
                               f"{rates[1].tolist()}")
    return identical


def graph_phase(dev, bf16: bool = False):
    """9a-9e: the car train step as CUDA graphs (``Trainer.train_step``'s
    default on the card) against the eager step (``eager=True``). With
    ``bf16`` (phase 10c): the car preset in bf16 with ``mu_bf16``, 9a, 9b,
    9d and 9e only, and every kernel of a replay a bf16 instantiation."""
    import copy
    import gc
    import tempfile

    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        profile_launches,
                                        reset_launch_counts)
    from haet_torch.train import Checkpointer, Trainer
    from haet_torch.train.car import bucket_size, loss_fn_builder
    from haet_torch.utils.config import (shapenet_car_config,
                                         shapenet_car_train_config)

    cfg = shapenet_car_train_config()
    cfg.mu_bf16 = bf16
    model_cfg = shapenet_car_config()
    model_cfg.bf16 = bf16
    ph = "phase 10c-" if bf16 else "phase 9"
    check(cfg.cycle_momentum, "cycle_momentum is off")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    pair = [graph_batches(n, [SEED + 20 + i])[0]
            for i, n in enumerate(GRAPH_POINTS)]
    check([b["x"].shape[1] for b in pair]
          == [bucket_size(n) for n in GRAPH_POINTS], "buckets")

    def trainer(eager, seed=SEED, steps=2 * GRAPH_STEPS):
        model = build_model(model_cfg, dev, seed=seed)
        return Trainer(model, loss_fn_builder(0.5), cfg, total_steps=steps,
                       batch_args=lambda b: (b["x"], None), eager=eager)

    print(f"{ph}a: {GRAPH_STEPS} steps, graphed against eager, "
          f"alternating buckets {[b['x'].shape[1] for b in pair]}",
          flush=True)
    graphed, eager = trainer(False), trainer(True)
    check(graphed.graphs is not None and eager.graphs is None, "modes")
    hold_states(f"{ph}a: the two trainers' initial state", graphed, eager)
    tmp = tempfile.mkdtemp(prefix="haet_graphs_")
    ck = Checkpointer(tmp)
    reset_launch_counts()
    same = True
    for i in range(GRAPH_STEPS):
        b = pair[i % 2]
        mg, me = graphed.train_step(b), eager.train_step(b)
        rates = (graphed.optimizer.hparams.cpu(),
                 eager.optimizer.hparams.cpu())
        same = hold_step(f"{ph}a step {i + 1}", mg, me, rates) and same
        print(f"  step {i + 1} ({b['x'].shape[1]} points): loss graphed "
              f"{float(mg['loss']):.8f} eager {float(me['loss']):.8f}; lr, "
              f"beta1 {rates[0].tolist()}", flush=True)
        if i == GRAPH_STEPS // 2 - 1:   # for 9d: a checkpoint mid-run
            ck.save_last(eager.state_dict(), 0)
    print(f"  every step's metrics bit-identical: {same}; "
          f"{len(graphed.graphs)} graphs, captured in "
          f"{[round(t, 3) for t in graphed.graphs.capture_s]} s", flush=True)
    check(len(graphed.graphs) == 2, f"{len(graphed.graphs)} graphs")
    hold_states(f"{ph}a: state after {GRAPH_STEPS} steps", graphed, eager)
    check(all(v == 0 for v in plain_route_counts().values()),
          f"plain routes {plain_route_counts()}")

    print(f"{ph}b: one replay's kernels, from the profiler", flush=True)
    reset_launch_counts()
    replay = replay_calls("kernel calls in one replay", graphed.train_step,
                          pair[1])
    if bf16:   # the slice and Erwin kernels' bf16 instantiations
        f32_only = [nm for nm in replay["names"]
                    if "bfloat16" not in nm and "sum_partials" not in nm]
        print(f"  the port's kernels in the replay: {replay['names']}",
              flush=True)
        check(not f32_only, f"float32 kernels in the bf16 step: {f32_only}")
    expect_counts("plain routes", plain_route_counts(),
                  {k: 0 for k in plain_route_counts()})
    print(f"  CUDA kernels per replay {replay['kernels']} (the port's "
          f"{sum(replay['launches'].values())}: {replay['launches']}) and "
          f"{replay['copies']} copies; device {replay['device_ms']:.3f} ms",
          flush=True)
    # the same replay twice, from the same state: the slice kernels'
    # arrival counters, captured once, are back at zero after each replay
    snapshot = copy.deepcopy(graphed.state_dict())
    first = graphed.train_step(pair[1])
    after = {k: v.clone() for k, v in train_state(graphed).items()}
    graphed.load_state_dict(snapshot)
    second = graphed.train_step(pair[1])
    check(all(torch.equal(first[k], second[k]) for k in first)
          and all(torch.equal(v, after[k])
                  for k, v in train_state(graphed).items()),
          "two replays from one state differ")
    print("  two replays from one state and batch: bit-identical", flush=True)

    print(f"{ph}d: restore step {GRAPH_STEPS // 2}'s eager checkpoint "
          f"into both trainers, then {GRAPH_STEPS // 2} more steps",
          flush=True)
    for t in (graphed, eager):
        ptrs = [v.data_ptr() for v in train_state(t).values()]
        check(t.maybe_restore(ck), "no checkpoint")
        check(ptrs == [v.data_ptr() for v in train_state(t).values()],
              "a restore moved the training state")
        mus = {st["exp_avg"].dtype for st in t.optimizer.state.values()}
        check(mus == {torch.bfloat16 if bf16 else torch.float32},
              f"Adam's first moments are {mus} after the restore")
    # the rates of the last step are no checkpoint's: the graphed trainer
    # took one more step (9b)
    hold_states(f"{ph}d: restored", graphed, eager, rates=False)
    reset_launch_counts()
    for i in range(GRAPH_STEPS // 2):
        b = pair[i % 2]
        mg, me = graphed.train_step(b), eager.train_step(b)
        hold_step(f"{ph}d step {i + 1}", mg, me,
                  (graphed.optimizer.hparams.cpu(),
                   eager.optimizer.hparams.cpu()))
    restored_counts = launch_counts()
    expect_counts(f"{ph}d launches ({GRAPH_STEPS // 2} eager steps; a "
                  f"replay counts none)", restored_counts,
                  expected_launches(GRAPH_STEPS // 2, 0))
    check(len(graphed.graphs) == 2, "a restore captured new graphs")
    hold_states(f"{ph}d: after the restore and the steps", graphed, eager)
    shutil.rmtree(tmp, ignore_errors=True)

    print(f"{ph}e: walls, device time and peak memory ({WALL_STEPS} "
          f"steps each)", flush=True)
    # Memory, from this phase's start: a replay allocates nothing (its
    # temporaries live in the graphs' pool, reserved since the capture), so
    # the graphed step's footprint is the trainers' resident state plus the
    # pool; the eager step's is that state plus its peak of temporaries.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mib = 2**20
    resident = (torch.cuda.memory_allocated() - base[0]) / mib
    pool = (torch.cuda.memory_reserved() - base[1]) / mib - resident
    walls = {}
    for name, t in (("graphed", graphed), ("eager", eager)):
        w = []
        start = torch.cuda.memory_allocated() / mib
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WALL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step(pair[1])
            torch.cuda.synchronize()
            w.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / mib
        _, prof = profile_launches(t.train_step, pair[1])
        wall = float(np.median(w)) * 1e3
        nodes = prof["kernels"] + prof["copies"]
        gaps = prof["span_ms"] - prof["device_ms"]
        walls[name] = {"wall_ms": wall, "min_ms": min(w) * 1e3,
                       "walls_ms": [x * 1e3 for x in w],
                       "device_ms": prof["device_ms"],
                       "span_ms": prof["span_ms"], "gaps_ms": gaps,
                       "busy": prof["device_ms"] / wall,
                       "kernels": prof["kernels"],
                       "copies": prof["copies"],
                       "step_mb": (pool if name == "graphed"
                                   else peak - start)}
        print(f"  {name}: wall median {wall:.3f} ms (min {min(w) * 1e3:.3f}) "
              f"of {WALL_STEPS}; device {prof['device_ms']:.3f} ms in "
              f"{prof['kernels']} kernels and {prof['copies']} copies over a "
              f"span of {prof['span_ms']:.3f} ms (gaps {gaps:.3f} ms, "
              f"{1e3 * gaps / nodes:.2f} us per node); busy "
              f"{prof['device_ms'] / wall:.3f}", flush=True)
    print(f"  memory since {ph.rstrip('-')} began: resident (both trainers' "
          f"state, "
          f"the graphs' static buffers) {resident:.1f} MiB; the graphs' "
          f"pool {pool:.1f} MiB; the eager step's temporaries at peak "
          f"{walls['eager']['step_mb']:.1f} MiB", flush=True)
    del graphed, eager
    walls["restored_launches"] = restored_counts
    if bf16:
        torch.cuda.empty_cache()
        return walls

    print(f"phase 9c: train_steps of {SCAN_STEPS} against {SCAN_STEPS} "
          f"graphed train_steps", flush=True)
    batches = graph_batches(N_POINTS, range(SEED + 30, SEED + 30 + SCAN_STEPS))
    scan, single = trainer(False), trainer(False)
    t0 = time.perf_counter()
    ms = scan.train_steps(batches)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    singles = [single.train_step(b) for b in batches]
    check(scan.step == single.step == SCAN_STEPS, "steps")
    for i, m in enumerate(singles):
        hold_step(f"9c step {i + 1}", {k: v[i] for k, v in ms.items()}, m,
                  (scan.optimizer.hparams.cpu(),
                   single.optimizer.hparams.cpu()))
    print(f"  losses {ms['loss'].tolist()}; one graph of {SCAN_STEPS} steps "
          f"(capture and first replay {scan_s:.3f} s)", flush=True)
    hold_states(f"9c: state after {SCAN_STEPS} steps", scan, single)
    del scan, single
    torch.cuda.empty_cache()
    return walls


# ---------------------------------------------------------------------------
# Phase 10: bf16, as the JAX package runs the car preset on its accelerator.
# ---------------------------------------------------------------------------

#: a bf16 output of a kernel against its plain version on the same bf16
#: inputs: both compute in float32 and round once to bf16 (8 significant
#: bits), so they differ by at most one bf16 ulp where their float32 values
#: straddle a rounding boundary: 2^-7 of each output's max
BF16_RTOL = 2.0 ** -7
#: the bf16 car model served against the float32 model with the same
#: weights, each output within this of max |float32 out|: a CPU rehearsal
#: of this phase at 1900 points measured 1.7e-2 (batch 1) and 3.2e-2 (the
#: batch of 4, whose pseudo-positions are normalised over four clouds)
BF16_SERVE_RTOL = 1e-1
#: ``car_eval`` (float32) of 10d's ``car_train --bf16 1`` checkpoint
#: against ``car_train``'s own bf16 evaluation, each metric relative to
#: itself: a metric averages the bf16 model's rounding over the points;
#: the CPU test of the same comparison (``tests/test_torch_car_driver.py``,
#: smoke model) measured up to 2.5e-4
BF16_METRIC_RTOL = 1e-2
#: the slice records' shapes: the training batch (timed) and serve batch 1
BF16_SLICE = ("train_b1", "serve_b1")
#: the bf16 records' names and the wrapper counter each reads
BF16_RECORDS = {"slice_states_bf16": "slice_states",
                "deslice_bf16": "deslice",
                "slice_states_bwd_bf16": "slice_states_bwd",
                "deslice_bwd_bf16": "deslice_bwd",
                "fused_erwin_block_bf16": "fused_erwin_block",
                "fused_erwin_block_bwd_bf16": "fused_erwin_block_bwd"}


def alone(what, fn, reps: int = 10):
    """``reps`` calls of ``fn()`` under the profiler, after a warm-up: they
    must run the port's kernels and no other kernel (no cast in front of or
    behind them). Counted from the trace's per-kernel totals."""
    import re

    import torch

    from haet_torch.ops.kernels import port_kernel
    from haet_torch.utils.profiling import device_trace, kernel_events

    fn()
    torch.cuda.synchronize()
    with device_trace() as prof:
        for _ in range(reps):
            fn()
    ours, other = {}, {}
    for e in kernel_events(prof):
        mine = (port_kernel(e.key)[0] is not None
                or re.search(r"\bsum_partials\b", e.key))
        (ours if mine else other)[e.key] = e.count
    print(f"  {what}: {reps} calls ran {sum(ours.values())} of the port's "
          f"kernels and {sum(other.values())} others", flush=True)
    check(not other and sum(ours.values()) >= reps,
          f"{what}: kernels beside the port's: {other}")
    return sorted(ours)


def bf16_slice_phase(dev):
    """10a, the slice kernels and their backwards in bf16 against their
    plain versions on the same bf16 inputs, at ``BF16_SLICE``: bf16
    outputs within ``BF16_RTOL``, float32 outputs (m, s, the float32
    states, every parameter gradient) as in phases 3 and 3b; the public
    states the rounding of the float32 ones; two calls bit-identical; each
    wrapper call runs its kernels and nothing else. At the training batch:
    device us per call with the L2 flushed beside the float32 kernels' on
    the same values, and the bound of the bf16 bytes."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    bf = torch.bfloat16
    recs = {k: {"err": 0.0, "us": {}, "f32_us": {}, "bound_us": {},
                "names": set()} for k in ("slice_states", "deslice",
                                          "slice_states_bwd", "deslice_bwd")}
    for i, tag in enumerate(BF16_SLICE):
        shape = SLICE_TIMED[tag]
        b, h, n, c, gs = shape
        print(f"phase 10a: slice kernels in bf16 ({tag})  x [{b}, {h}, {n}, "
              f"{c}] bf16, G {gs}; "
              f"{slice_launches(dev, shape, tuple(SLICE_BWD_GRADS), 2)}",
              flush=True)
        x32, ws, bs, wa, ba, st32 = sb.inputs(shape, dev, SEED + 40 + i)
        gst32, gout32 = sb.grads(shape, dev, SEED + 40 + i)
        x, st, g_st, g_out = (t.to(bf) for t in (x32, st32, gst32, gout32))
        with torch.inference_mode():
            got = sk.slice_states_with_residual(x, ws, bs, wa, ba)
            again = sk.slice_states_with_residual(x, ws, bs, wa, ba)
            p32, m, s = sk.slice_states_plain_f32(x, ws, bs, wa, ba)
            torch.cuda.synchronize()
            check(got[0].dtype == bf and got[1].dtype == torch.float32,
                  "slice_states dtypes")
            r = recs["slice_states"]
            r["err"] = max(r["err"], compare("states (bf16)", got[0],
                                             p32.to(bf), BF16_RTOL))
            for nm, a, w in (("states (float32 residual)", got[1], p32),
                             ("m", got[2], m), ("s", got[3], s)):
                compare(nm, a, w, KERNEL_RTOL)
            check(torch.equal(got[0], got[1].to(bf)),
                  "the bf16 states are not the float32 states rounded")
            same = all(torch.equal(a, w) for a, w in zip(got, again))
            outs = [sk.deslice(x, ws, bs, wa, ba, st, m, s) for _ in (0, 1)]
            want = sk.deslice_plain(x, ws, bs, wa, ba, st, m, s)
            torch.cuda.synchronize()
            check(outs[0].dtype == bf, "deslice dtype")
            recs["deslice"]["err"] = max(
                recs["deslice"]["err"],
                compare("out (bf16)", outs[0], want, BF16_RTOL))
            same = same and torch.equal(*outs)
            bwd_args = {
                "slice_states_bwd": (x, ws, bs, wa, ba, p32, m, s, g_st),
                "deslice_bwd": (x, ws, bs, wa, ba, st, m, s, g_out)}
            fns = {"slice_states_bwd": (sk.slice_states_bwd,
                                        sk.slice_states_bwd_plain),
                   "deslice_bwd": (sk.deslice_bwd, sk.deslice_bwd_plain)}
            for kind, (fn, plain_fn) in fns.items():
                a_k = bwd_args[kind]
                got_b, again_b = fn(*a_k), fn(*a_k)
                want_b = plain_fn(*a_k)
                torch.cuda.synchronize()
                for name, a, w in zip(SLICE_BWD_GRADS[kind], got_b, want_b):
                    low = name in ("dx", "dstates")
                    check(a.dtype == (bf if low else torch.float32),
                          f"{kind} {name} is {a.dtype}")
                    err = compare(f"{kind} {name}", a, w,
                                  BF16_RTOL if low else slice_bwd_rtol(name))
                    recs[kind]["err"] = max(recs[kind]["err"], err)
                same = same and all(torch.equal(a, w)
                                    for a, w in zip(got_b, again_b))
            print(f"  two calls bit-identical (the forwards' outputs and "
                  f"every gradient): {same}", flush=True)
            check(same, f"bf16 slice kernels at {tag} are not deterministic")
            calls = {
                "slice_states": lambda: sk.slice_states(x, ws, bs, wa, ba),
                "deslice": lambda: sk.deslice(x, ws, bs, wa, ba, st, m, s),
                "slice_states_bwd": lambda: sk.slice_states_bwd(
                    *bwd_args["slice_states_bwd"]),
                "deslice_bwd": lambda: sk.deslice_bwd(
                    *bwd_args["deslice_bwd"])}
            for kind, fn in calls.items():
                recs[kind]["names"].update(alone(f"{kind} bf16", fn))
            print("  each bf16 call runs the port's kernels and no other "
                  "kernel", flush=True)
            if tag != "train_b1":
                continue
            f32_calls = {
                "slice_states": lambda: sk.slice_states(x32, ws, bs, wa, ba),
                "deslice": lambda: sk.deslice(x32, ws, bs, wa, ba, st32, m,
                                              s),
                "slice_states_bwd": lambda: sk.slice_states_bwd(
                    x32, ws, bs, wa, ba, p32, m, s, gst32),
                "deslice_bwd": lambda: sk.deslice_bwd(
                    x32, ws, bs, wa, ba, st32, m, s, gout32)}
            plain_calls = {
                "slice_states": lambda: sk.slice_states_plain(
                    x, ws, bs, wa, ba),
                "deslice": lambda: sk.deslice_plain(x, ws, bs, wa, ba, st,
                                                    m, s),
                "slice_states_bwd": lambda: sk.slice_states_bwd_plain(
                    *bwd_args["slice_states_bwd"]),
                "deslice_bwd": lambda: sk.deslice_bwd_plain(
                    *bwd_args["deslice_bwd"])}
            for kind, fn in calls.items():
                r = recs[kind]
                if kind in SLICE_BWD_GRADS:
                    r["launches_per_call"] = launches_per_call(kind, fn,
                                                               shape, True)
                us, _ = sb.flushed_us(fn, 30, None)
                us32, _ = sb.flushed_us(f32_calls[kind], 30, None)
                bound = sb.bound_us(kind, shape, isz=2)
                r["us"][tag], r["f32_us"][tag] = us, us32
                r["bound_us"][tag] = bound[0]
                r["ms"] = cuda_ms(fn)
                r["plain_ms"] = cuda_ms(plain_calls[kind], reps=5)
                r["bound"] = (bound[0] / 1e3, bound[1])
                print(f"  {kind} bf16: device {us:.2f} us per call (profiler,"
                      f" L2 flushed) against {us32:.2f} us in float32; bound "
                      f"{bound[0]:.2f} us ({bound[1]}; the bf16 bytes, the "
                      f"passes of each product's operand types), "
                      f"{bound[0] / us:.0%} of it", flush=True)
                print_times(r["ms"], r["plain_ms"], r["bound"])
        del x, x32, st, st32, g_out, gout32
        torch.cuda.empty_cache()
    replaces = {"slice_states": "haet_tpu/ops/pallas/slice_kernels.py:73",
                "deslice": "haet_tpu/ops/pallas/slice_kernels.py:125",
                "slice_states_bwd": "haet_tpu/ops/pallas/slice_kernels.py:327",
                "deslice_bwd": "haet_tpu/ops/pallas/slice_kernels.py:448"}
    return [kernel_record(f"{k}_bf16", "haet_torch/csrc/slice_kernels.cu",
                          replaces[k], r["err"], r["ms"], r["plain_ms"],
                          r["bound"], dtype="bfloat16",
                          launches_per_call=r.get("launches_per_call"),
                          device_us_per_call=r["us"],
                          float32_device_us_per_call=r["f32_us"],
                          bound_us=r["bound_us"],
                          kernel_names=sorted(r["names"]))
            for k, r in recs.items()]


def bf16_erwin_phase(dev):
    """10a, the fused Erwin block forward and backward in bf16 (``x``,
    ``pos``, ``dout``; the parameters float32) at both car block shapes
    against the plain block on the same inputs: out, dx and dpos within
    ``BF16_RTOL``, every parameter gradient within ``KERNEL_RTOL``; two
    calls bit-identical; each call runs the port's kernels alone; device us
    per call beside the float32 kernels'."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 50)
    out = {k: {"err": 0.0, "us": {}, "f32_us": {}, "names": set(),
               "ms": [], "plain_ms": [], "bound": []}
           for k in ("fwd", "bwd")}
    for n_e, c_e, ball, weight in ((32, 32, 32, 16), (16, 64, 16, 8)):
        print(f"phase 10a: fused_erwin_block in bf16  x [8, {n_e}, {c_e}] "
              f"bf16, 8 heads, ball {ball}", flush=True)
        xe32, pe32, params, kw = erwin_inputs(dev, g, n_e, c_e, ball)
        xe, pe = xe32.to(bf), pe32.to(bf)
        dout = torch.randn(xe.shape, generator=g).to(dev).to(bf)
        # no_grad, not inference_mode: the plain backward is autograd
        with torch.no_grad():
            o_k = [eb.fused_erwin_block(xe, pe, params, **kw) for _ in (0, 1)]
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            check(o_k[0].dtype == bf, "Erwin out dtype")
            out["fwd"]["err"] = max(out["fwd"]["err"], compare(
                "out (bf16)", o_k[0], o_p, BF16_RTOL))
            b_k = [eb.fused_erwin_block_bwd(xe, pe, dout, params, **kw)
                   for _ in (0, 1)]
            b_p = eb.erwin_block_bwd_plain(xe, pe, dout, params, **kw)
            torch.cuda.synchronize()
            for name, a, w in (("dx", b_k[0][0], b_p[0]),
                               ("dpos", b_k[0][1], b_p[1]),
                               *((k, b_k[0][2][k], b_p[2][k])
                                 for k in eb.GRAD_NAMES)):
                low = name in ("dx", "dpos")
                check(a.dtype == (bf if low else torch.float32),
                      f"Erwin {name} is {a.dtype}")
                out["bwd"]["err"] = max(out["bwd"]["err"], compare(
                    f"{name}", a, w, BF16_RTOL if low else KERNEL_RTOL))
            same = torch.equal(*o_k) and all(
                torch.equal(a, w) for a, w in
                zip((b_k[0][0], b_k[0][1], *b_k[0][2].values()),
                    (b_k[1][0], b_k[1][1], *b_k[1][2].values())))
            print(f"  two calls bit-identical (out, dx, dpos, gradients): "
                  f"{same}", flush=True)
            check(same, "bf16 Erwin kernels are not deterministic")
            fns = {"fwd": (lambda: eb.fused_erwin_block(xe, pe, params, **kw),
                           lambda: eb.fused_erwin_block(xe32, pe32, params,
                                                        **kw),
                           lambda: eb.erwin_block_plain(xe, pe, params, **kw),
                           ERWIN_FWD_KERNELS),
                   "bwd": (lambda: eb.fused_erwin_block_bwd(
                               xe, pe, dout, params, **kw),
                           lambda: eb.fused_erwin_block_bwd(
                               xe32, pe32, dout.float(), params, **kw),
                           lambda: eb.erwin_block_bwd_plain(
                               xe, pe, dout, params, **kw),
                           ERWIN_BWD_KERNELS)}
            w_elems, flops = erwin_work(n_e, c_e, ball)
            rows, pts = 8 * n_e * c_e, 8 * n_e * 3
            bounds = {"fwd": bound_ms(2 * (2 * rows + pts) + 4 * w_elems,
                                      flops),
                      "bwd": bound_ms(2 * (3 * rows + 2 * pts)
                                      + 4 * (2 * w_elems - 8), 3 * flops)}
            for k, (fn, fn32, plain_fn, names) in fns.items():
                r = out[k]
                r["names"].update(alone(f"Erwin {k} bf16", fn))
                us, us32 = device_us(fn, names), device_us(fn32, names)
                r["us"][f"n{n_e}_c{c_e}"] = us
                r["f32_us"][f"n{n_e}_c{c_e}"] = us32
                r["ms"].append((cuda_ms(fn), weight))
                r["plain_ms"].append((cuda_ms(plain_fn), weight))
                r["bound"].append((bounds[k], weight))
                print(f"  {k} bf16: device {us:.2f} us per call (profiler) "
                      f"against {us32:.2f} us in float32; bound "
                      f"{bounds[k][0] * 1e3:.3f} us ({bounds[k][1]})",
                      flush=True)
    mix = lambda xs: sum(t * w for t, w in xs) / 24  # noqa: E731
    recs = []
    for k, name, line in (("fwd", "fused_erwin_block_bf16", 163),
                          ("bwd", "fused_erwin_block_bwd_bf16", 187)):
        r = out[k]
        bound = (mix([(bd[0], w) for bd, w in r["bound"]]),
                 "bytes" if all(bd[1] == "bytes" for bd, _ in r["bound"])
                 else "operations")
        recs.append(kernel_record(
            name, "haet_torch/csrc/erwin_block.cu",
            f"haet_tpu/ops/pallas/erwin_block.py:{line}", r["err"],
            mix(r["ms"]), mix(r["plain_ms"]), bound, dtype="bfloat16",
            device_us_per_call=r["us"], float32_device_us_per_call=r["f32_us"],
            kernel_names=sorted(r["names"])))
    return recs


def bf16_serve_phase(dev):
    """10b: the bf16 car model (both kernel flags; phase 4's weights)
    behind a ``BatchingServer``, as phase 4 drives it: launches 2 + 2 + 24
    per forward, no plain route, the answers the exact float32 widening of
    the model's bf16 output and within ``BF16_SERVE_RTOL`` of the float32
    model on the same weights; the batch-1 forward's wall and device
    time. Returns ``(launch counts, forwards, profile)``."""
    import torch

    from haet_torch.models import HAETransolverIrregularMesh
    from haet_torch.utils.config import shapenet_car_config

    kwargs = shapenet_car_config().model_kwargs()
    kwargs.update(use_pallas=True, use_pallas_erwin=True, device=dev,
                  seed=SEED)
    model = HAETransolverIrregularMesh(**kwargs)
    g = torch.Generator().manual_seed(SEED + 1)   # phase 4's perturbation
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
    low = HAETransolverIrregularMesh(**{**kwargs, "dtype": torch.bfloat16})
    low.load_state_dict(model.state_dict())
    model.eval()
    low.eval()
    samples = serve_samples()
    x0 = torch.from_numpy(samples[0][None]).to(dev)
    with torch.inference_mode():   # warm-up
        direct = low(x0)[0]
        torch.cuda.synchronize()
    check(direct.dtype == torch.bfloat16, "the bf16 model's output dtype")
    outs, counts, forwards, bundle = drive_server(low, samples, dev)
    program = bundle.bind(low.state_dict()).predict(samples[0][None], None)
    check(program.dtype == torch.bfloat16, "the bf16 program's output dtype")
    check(outs[0].dtype == np.float32 and np.array_equal(
        outs[0], program[0].float().cpu().numpy()),
        "the served answer is not the bf16 program's output widened")
    print("  the served batch-1 answer is the bf16 program's output, "
          "widened exactly; the program against the eager bf16 model: "
          f"max abs {float((program - direct).abs().max()):.3e}",
          flush=True)
    rel = compare_served(outs, samples, model, dev, "the float32 model",
                         BF16_SERVE_RTOL)
    print("phase 10b: profile one bf16 batch-1 forward", flush=True)
    prof = profile_phase(low, samples[0], dev)
    del model, low
    torch.cuda.empty_cache()
    return counts, forwards, {**prof, "rel_err_vs_float32": rel}


def bf16_phase(dev):
    """Phase 10: the bf16 kernels (10a), serving (10b), training (10c) and
    the drivers (10d). The bf16 records' ``launches`` are 10c-d's counts:
    the eager steps after the restore. Returns ``(records, summary)``."""
    import torch

    t0 = time.perf_counter()
    print("phase 10a: the kernels on the path in bf16", flush=True)
    records = bf16_slice_phase(dev) + bf16_erwin_phase(dev)
    t_a = time.perf_counter() - t0
    print("phase 10b: serve the ShapeNet-Car preset in bf16", flush=True)
    _, forwards, served = bf16_serve_phase(dev)
    walls = graph_phase(dev, bf16=True)
    for r in records:
        r["launches"] = walls["restored_launches"][BF16_RECORDS[r["name"]]]
    print("phase 10d: car_train --epochs 1 --bf16 1 --mu_bf16 1, then "
          "car_eval --which last (float32)", flush=True)
    drivers = drivers_car_phase(dev, epochs=1, bf16=True)
    torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t0:.1f} s (10a {t_a:.1f} s)",
          flush=True)
    return records, {"serve_forwards": forwards, "serve": served,
                     "graphs": walls, "drivers": drivers}


def print_bf16_beside_f32(bf16, f32_walls, f32_profile) -> None:
    """Phase 10's step and serve numbers beside phases 9e's and 5's."""
    for name in ("graphed", "eager"):
        b, f = bf16["graphs"][name], f32_walls[name]
        print(f"  10c {name} step, bf16 against float32 (9e): wall "
              f"{b['wall_ms']:.3f} / {f['wall_ms']:.3f} ms, device "
              f"{b['device_ms']:.3f} / {f['device_ms']:.3f} ms, kernels "
              f"{b['kernels']} / {f['kernels']}, busy {b['busy']:.3f} / "
              f"{f['busy']:.3f}, memory {b['step_mb']:.1f} / "
              f"{f['step_mb']:.1f} MiB", flush=True)
    served = bf16["serve"]
    print(f"  10b batch-1 forward, bf16 against float32 (phase 5): wall "
          f"{served['wall_ms']:.3f} / {f32_profile['wall_ms']:.3f} ms, "
          f"device {served['device_ms']:.3f} / {f32_profile['device_ms']:.3f}"
          f" ms", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: the serving path over exported programs.
# ---------------------------------------------------------------------------

#: the point buckets ``car_eval --export_point_buckets`` writes, at the
#: batch sizes of the JAX driver's family: six programs
SERVE_BUCKETS = (32768, 34816)
SERVE_BATCHES = (1, 2, 4)
#: a served program against the eager model on the same weights and inputs
#: (another process, another trace of the same float32 forward)
PROGRAM_RTOL = 1e-4


def program_input(shape) -> np.ndarray:
    """The seeded input of a program of ``shape`` in phase 11a (the fresh
    process and this one make the same)."""
    return np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)


def load_bundle_main(argv) -> int:
    """11a's fresh process (``chip_smoke.py --load-bundle BUNDLE CKPT OUT
    DEVICE``): imports no model code; loads each program of the bundle, binds
    the ``last`` checkpoint, runs it once on its seeded input with the
    launch counters zeroed and once under the profiler, and writes the
    answers to ``OUT`` (npz). Prints one JSON line: each program's load and
    bind time, first call, counters and device calls."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    from haet_torch.export import load_artifact
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        profile_launches,
                                        reset_launch_counts)
    from haet_torch.serve_http import _load_variables

    bundle_dir, ckpt, out, device = argv
    dev = torch.device(device)
    t0 = time.perf_counter()
    variables = _load_variables(ckpt, "last")
    rec = {"variables_s": time.perf_counter() - t0, "programs": {},
           "models_imported": "haet_torch.models" in sys.modules}
    answers = {}
    for name in sorted(os.listdir(bundle_dir)):
        t0 = time.perf_counter()
        em = load_artifact(os.path.join(bundle_dir, name), device=dev)
        t1 = time.perf_counter()
        fn = em.bind(variables)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        x = program_input(em.input_shapes[0])
        reset_launch_counts()
        y = fn(x, None)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = launch_counts()
        _, prof = profile_launches(fn, x, None)
        answers[name] = y.float().cpu().numpy()
        rec["programs"][name] = {
            "shape": em.input_shapes[0], "load_s": t1 - t0,
            "bind_s": t2 - t1, "first_call_s": t3 - t2,
            "launches": counts, "calls": prof["calls"],
            "plain_routes": plain_route_counts(), "lost": prof["lost"],
            "device_ms": prof["device_ms"]}
    np.savez(out, **answers)
    rec["models_imported"] = "haet_torch.models" in sys.modules
    print(json.dumps(rec))
    return 0


def served_model(dev, ckpt):
    """The eager car model (float32, both kernel flags) with ``last``."""
    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.train import Checkpointer
    from haet_torch.utils.config import shapenet_car_config

    state = Checkpointer(ckpt).restore("last", map_location=dev)["model"]
    model = build_model(shapenet_car_config(), dev)
    model.load_state_dict(state)
    model.eval()
    return model, {k: v.detach().clone() for k, v in state.items()}


def eager(model, x, dev):
    import torch

    with torch.inference_mode():
        return model(torch.from_numpy(x).to(dev), None)


def export_phase(dev, ckpt, root):
    """11a: ``car_eval --export_artifact --export_point_buckets`` on the
    ``car_train`` checkpoint (phase 8b's): six programs, each one's export
    time; then a fresh process loads and binds them (no model code), and
    each answer is held to the eager model within ``PROGRAM_RTOL`` and
    counts exactly 2 + 2 + 24 kernel calls, no plain route."""
    import os
    import tempfile

    import torch

    from haet_torch import export as hexport
    from haet_torch.benchmarks import car_eval

    times = {}
    save = hexport.save_artifact

    def timed(path, *args, **kwargs):
        t0 = time.perf_counter()
        out = save(path, *args, **kwargs)
        times[os.path.basename(path)] = time.perf_counter() - t0
        return out

    hexport.save_artifact = timed
    try:
        car_eval.main(["--data_dir", f"{ckpt}/absent", "--which", "last",
                       "--checkpoint_dir", ckpt, "--export_artifact", root,
                       "--export_point_buckets",
                       ",".join(map(str, SERVE_BUCKETS))])
    finally:
        hexport.save_artifact = save
    check(len(times) == len(SERVE_BUCKETS) * len(SERVE_BATCHES),
          f"car_eval exported {sorted(times)}")
    for name, t in sorted(times.items()):
        print(f"  exported {name} in {t:.2f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="haet_answers_") as td:
        npz = os.path.join(td, "answers.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--load-bundle",
             root, ckpt, npz, str(dev)], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"the fresh process failed:\n{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        answers = dict(np.load(npz))
    check(not res["models_imported"],
          "the fresh process imported haet_torch.models")
    print(f"  fresh process ({wall:.1f} s, no model code imported): "
          f"checkpoint read in {res['variables_s']:.2f} s", flush=True)
    model, state = served_model(dev, ckpt)
    for name, r in sorted(res["programs"].items()):
        print(f"  {name}: load {r['load_s']:.3f} s, bind {r['bind_s']:.3f} "
              f"s, first call {r['first_call_s']:.3f} s, device "
              f"{r['device_ms']:.3f} ms (trace lost {r['lost']})",
              flush=True)
        expect_counts(f"11a {name} launches", r["launches"], PER_FORWARD)
        expect_counts(f"11a {name} device calls", r["calls"], PER_FORWARD)
        check(all(v == 0 for v in r["plain_routes"].values()),
              f"{name}: plain routes {r['plain_routes']}")
        want = eager(model, program_input(r["shape"]), dev)
        r["rel_err"] = compare(f"11a {name} against the eager model",
                               torch.from_numpy(answers[name]).to(dev), want,
                               PROGRAM_RTOL) / float(want.abs().max())
    return {"export_s": times, "programs": res["programs"]}, model, state


def ragged_phase(dev, bundle, model, state):
    """11b: ``pad_to_points`` and ``pipeline_depth`` over the bundle. A
    ragged sample of 32186 points rides the 32768 bucket, is truncated
    back, and equals the eager model on the padded input (its deviation
    from the exact-N forward printed); 8 requests form two batches of 4,
    depth 1 and depth 2 bit for bit equal; 2 + 2 + 24 launches per served
    forward (read before the eager references run)."""
    import torch

    from haet_torch.ops.kernels import launch_counts, reset_launch_counts
    from haet_torch.serve import BatchingServer

    rng = np.random.RandomState(SEED + 11)
    ragged = rng.randn(N_POINTS, 7).astype(np.float32)
    samples = [rng.randn(N_POINTS, 7).astype(np.float32) for _ in range(8)]
    reset_launch_counts()
    with BatchingServer(bundle, state, max_delay_s=0.0, pad_to_points=True,
                        pipeline_depth=2, device=dev) as srv:
        got = srv.predict(ragged, None, timeout=300)
        snap = srv.stats.snapshot()
    outs, hists = {}, {}
    for depth in (1, 2):
        with BatchingServer(bundle, state, max_delay_s=60.0,
                            pad_to_points=True, pipeline_depth=depth,
                            device=dev) as srv:
            futs = [srv.submit(x, None) for x in samples]
            outs[depth] = np.stack([f.result(timeout=300) for f in futs])
            hists[depth] = srv.stats.snapshot()["batch_histogram"]
    expect_counts("11b launches (5 served forwards)", launch_counts(),
                  expected_launches(0, 5))
    pad = SERVE_BUCKETS[0] - N_POINTS
    check(got.shape == (N_POINTS, 4), f"ragged answer shape {got.shape}")
    check(snap["padded_points"] == pad and snap["batch_histogram"] == {1: 1},
          f"ragged dispatch {snap}")

    def padded(x):
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])

    want = eager(model, padded(ragged)[None], dev)[0, :N_POINTS]
    compare(f"11b ragged {N_POINTS} -> {SERVE_BUCKETS[0]} against the eager "
            "model on the padded input", torch.from_numpy(got).to(dev), want,
            PROGRAM_RTOL)
    exact = eager(model, ragged[None], dev)[0].double().cpu().numpy()
    dev_rel = float(np.linalg.norm(got - exact) / np.linalg.norm(exact))
    dev_max = float(np.abs(got - exact).max() / np.abs(exact).max())
    print(f"  pad_to_points deviation from the exact-N forward (not "
          f"output-exact, as the JAX server documents): rel-L2 "
          f"{dev_rel:.6f}, max abs / max {dev_max:.6f}", flush=True)
    print(f"  8 requests: depth 1 histogram {hists[1]}, depth 2 "
          f"{hists[2]}", flush=True)
    check(hists[1] == hists[2] == {4: 2}, "no two batches of 4")
    check(np.array_equal(outs[1], outs[2]),
          "pipeline_depth 1 and 2 answer differently")
    batch = np.stack([padded(x) for x in samples[:4]])
    compare("11b burst batch of 4 against the eager model on that batch",
            torch.from_numpy(outs[2][:4]).to(dev),
            eager(model, batch, dev)[:, :N_POINTS], PROGRAM_RTOL)
    return {"pad_deviation_rel_l2": dev_rel, "pad_deviation_max": dev_max,
            "padded_points": pad}


def reload_phase(dev, bundle, model, state):
    """11c: ``reload`` on a depth-2 server while two clients keep
    submitting one sample: no request fails, every request submitted after
    ``reload`` returned answers with the new weights (within
    ``PROGRAM_RTOL`` of the eager model with them), and a structurally wrong
    state raises while the new weights keep serving."""
    import threading

    import torch

    from haet_torch.serve import BatchingServer

    rng = np.random.RandomState(SEED + 12)
    x = rng.randn(N_POINTS, 7).astype(np.float32)
    g = torch.Generator().manual_seed(SEED + 12)
    new = {k: (v + 0.01 * torch.randn(v.shape, generator=g).to(v.device)
               if v.is_floating_point() else v) for k, v in state.items()}
    srv = BatchingServer(bundle, state, max_delay_s=0.0, pad_to_points=True,
                         pipeline_depth=2, device=dev)
    futs, errs = [], []
    stop, lock = threading.Event(), threading.Lock()

    def client():
        try:
            while not stop.is_set():
                f = srv.submit(x, None)
                with lock:
                    futs.append(f)
                f.result(timeout=300)
        except Exception as e:  # noqa: BLE001 - checked below
            errs.append(e)

    threads = [threading.Thread(target=client) for _ in range(2)]
    try:
        old = srv.predict(x, None, timeout=300)
        for t in threads:
            t.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        srv.reload(new)
        t_reload = time.perf_counter() - t0
        with lock:
            n_at = len(futs) + 2  # the clients' next submits may be either
        deadline = time.perf_counter() + 120
        while len(futs) < n_at + 8 and time.perf_counter() < deadline:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=300)
        answers = [f.result(timeout=300) for f in futs]
        now = srv.predict(x, None, timeout=300)
        bad = dict(new)
        bad.pop(next(iter(bad)))
        try:
            srv.reload(bad)
            refused = False
        except ValueError as e:
            refused = "variables tree mismatch" in str(e)
        after = srv.predict(x, None, timeout=300)
    finally:
        stop.set()
        srv.close()
    check(not errs, f"requests failed during reload: {errs}")
    check(refused, "a structurally wrong state was not refused")
    check(np.array_equal(after, now), "the refused reload changed the answers")
    model.load_state_dict(new)
    padded = np.concatenate([x, np.repeat(x[-1:], SERVE_BUCKETS[0] -
                                          N_POINTS, axis=0)])
    want = eager(model, padded[None], dev)[0, :N_POINTS]
    model.load_state_dict(state)
    compare("11c after reload against the eager model with the new weights",
            torch.from_numpy(now).to(dev), want, PROGRAM_RTOL)
    moved = float(np.abs(now - old).max())
    check(moved > 1e-3, f"the new weights moved the answer by {moved}")
    late = answers[n_at:]
    check(len(late) > 0, "no request after the reload")
    for i, a in enumerate(late):
        check(float(np.abs(a - now).max()) <= PROGRAM_RTOL * float(
            np.abs(now).max()), f"request {n_at + i} after the reload is "
              "not the new weights'")
    print(f"  reload in {t_reload * 1e3:.1f} ms under traffic: "
          f"{len(answers)} requests, none failed, {len(late)} after it all "
          f"with the new weights (the answer moved {moved:.3e}); a wrong "
          "state refused, the new weights kept", flush=True)
    return {"reload_ms": t_reload * 1e3, "requests": len(answers)}


def http_phase(dev, bundle_dir, ckpt, bundle, state):
    """11d: ``python -m haet_torch.serve_http`` in a subprocess on a free
    port: ``/healthz``; ``/predict`` equal to the in-process server;
    ``/metrics`` with ``_count`` and ``_sum``; ``POST /reload``; SIGTERM
    while a request waits in the batcher: it is answered, exit 0."""
    import io
    import signal
    import socket
    import threading
    import urllib.request

    from haet_torch.serve import BatchingServer

    def post(base, path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()

    def predict(base, x):
        buf = io.BytesIO()
        np.savez(buf, arg0=x)
        status, body = post(base, "/predict", buf.getvalue())
        check(status == 200, f"/predict answered {status}")
        with np.load(io.BytesIO(body)) as z:
            return z["output"]

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "haet_torch.serve_http", "--bundle",
           bundle_dir, "--checkpoint", ckpt, "--which", "last", "--port",
           str(port), "--pad_to_points", "1", "--max_delay_ms", "1500",
           "--device", str(dev)]
    print(f"  {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        up = False
        while not up and time.perf_counter() - t0 < 300:
            if proc.poll() is not None:
                check(False, "serve_http exited early:\n"
                      f"{proc.stdout.read()[-3000:]}")
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    up = r.read() == b"ok"
            except OSError:
                time.sleep(0.5)
        check(up, "serve_http never answered /healthz")
        print(f"  /healthz ok after {time.perf_counter() - t0:.1f} s "
              "(load, bind, warm-up of 6 programs)", flush=True)
        x = np.random.RandomState(SEED + 13).randn(N_POINTS, 7).astype(
            np.float32)
        got = predict(base, x)
        with BatchingServer(bundle, state, max_delay_s=0.0,
                            pad_to_points=True, device=dev) as srv:
            want = srv.predict(x, None, timeout=300)
        err = float(np.abs(got - want).max())
        print(f"  /predict against the in-process server: max abs {err:.3e}"
              f" (bit for bit: {bool(err == 0.0)})", flush=True)
        check(err <= PROGRAM_RTOL * float(np.abs(want).max()),
              "/predict differs from the in-process server")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        lines = dict(ln.rsplit(" ", 1) for ln in metrics.splitlines()
                     if ln and not ln.startswith("#"))
        count = lines.get("haet_request_latency_seconds_count")
        total = lines.get("haet_request_latency_seconds_sum")
        print(f"  /metrics: latency summary _count {count}, _sum {total}",
              flush=True)
        check(count is not None and int(count) >= 1 and total is not None
              and float(total) > 0, "/metrics lacks _count/_sum")
        status, body = post(base, "/reload", json.dumps(
            {"which": "last"}).encode())
        check(status == 200 and json.loads(body) == {"reloaded": "last"},
              f"/reload answered {status} {body[:200]}")
        result = {}

        def inflight():
            try:
                result["out"] = predict(base, x)
            except Exception as e:  # noqa: BLE001 - checked below
                result["err"] = e

        t = threading.Thread(target=inflight)
        t.start()
        time.sleep(0.5)   # the request waits in the 1.5 s window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=300)
        rc = proc.wait(timeout=300)
        tail = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    check("err" not in result and "out" in result,
          f"the in-flight request failed: {result}")
    check(float(np.abs(result["out"] - got).max()) <= PROGRAM_RTOL * float(
        np.abs(got).max()), "the drained answer differs")
    check(rc == 0, f"serve_http exited {rc} after SIGTERM:\n{tail[-2000:]}")
    print(f"  SIGTERM with a request in flight: answered, exit {rc}",
          flush=True)
    return {"predict_max_abs_vs_in_process": err}


def micro_serving_phase(dev):
    """11e: the two serving drivers with short windows: every number of
    their JSON finite."""
    from haet_torch.benchmarks import (micro_serving_latency,
                                       micro_serving_server)

    def numbers(d):
        for v in d.values():
            if isinstance(v, dict):
                yield from numbers(v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                yield v

    lat = micro_serving_latency.main(["--rounds", "2", "--samples", "10"])
    srv = micro_serving_server.main(["--requests", "16", "--rounds", "1",
                                     "--batch_sizes", "1,4"])
    for name, res in (("micro_serving_latency", lat),
                      ("micro_serving_server", srv)):
        check(all(np.isfinite(v) for v in numbers(res)),
              f"{name}: a non-finite number")
    check(all(lat[k]["kernel_time_s"] > 0 for k in
              ("aot", "aot_bound", "eager")),
          "micro_serving_latency: no traced kernel time")
    print(f"  micro_serving_latency aot_bound e2e p50 "
          f"{lat['aot_bound']['e2e_p50_s'] * 1e3:.3f} ms, p95 "
          f"{lat['aot_bound']['e2e_p95_s'] * 1e3:.3f} ms, steady state "
          f"(device_latency_s) "
          f"{lat['aot_bound']['device_latency_s'] * 1e3:.3f} ms per call, "
          f"kernels {lat['aot_bound']['kernel_time_s'] * 1e3:.3f} ms; "
          f"micro_serving_server samples/s sequential_b1 "
          f"{srv['sequential_b1_rps']:.2f}, batched {srv['batched_rps']:.2f}"
          f", batched_pd2 {srv['batched_pd2_rps']:.2f}", flush=True)
    return {"latency": lat, "server": srv}


def serving_phase(dev, run_dir):
    """Phase 11: the serving path of the exported car model, 11a-11e."""
    import tempfile

    import torch

    from haet_torch.export import ServingBundle

    ckpt = f"{run_dir}/checkpoints/car"
    root = tempfile.mkdtemp(prefix="haet_serving_")
    try:
        t0 = time.perf_counter()
        print("phase 11a: car_eval --export_artifact --export_point_buckets "
              f"{','.join(map(str, SERVE_BUCKETS))}, then a fresh process",
              flush=True)
        out, model, state = export_phase(dev, ckpt, root)
        bundle = ServingBundle.load(root, device=dev)
        marks = [t0, time.perf_counter()]
        print("phase 11b: pad_to_points and pipeline_depth", flush=True)
        out["ragged"] = ragged_phase(dev, bundle, model, state)
        marks.append(time.perf_counter())
        print("phase 11c: reload under traffic", flush=True)
        out["reload"] = reload_phase(dev, bundle, model, state)
        marks.append(time.perf_counter())
        print("phase 11d: serve_http in a subprocess", flush=True)
        out["http"] = http_phase(dev, root, ckpt, bundle, state)
        del model, bundle
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        print("phase 11e: the serving drivers", flush=True)
        out["drivers"] = micro_serving_phase(dev)
        marks.append(time.perf_counter())
        print(f"phase 11: {marks[-1] - t0:.1f} s (" + ", ".join(
            f"11{c} {b - a:.1f} s" for c, a, b in zip("abcde", marks,
                                                      marks[1:])) + ")",
            flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 12: the structured-mesh PDE slice, the Darcy preset at full width.
# ---------------------------------------------------------------------------

#: B*H clouds of the PDE presets' Erwin stage (batch 4 x 8 heads)
PDE_CLOUDS = 32
#: the Darcy preset's Erwin block shapes ``tag: (n, C, ball, heads,
#: launches per step)`` at d 2 and SwiGLU hidden C (``mlp_ratio`` 1), G 64
#: slices of C 16: encoder0 and decoder0 (64 tokens in two balls of 32, 4
#: heads of width 4; 2 + 2 blocks a layer) and the bottleneck (32 tokens in
#: two balls of 16, 8 heads; 2 blocks a layer), 8 layers
DARCY_ERWIN = {"darcy_n64_c16": (64, 16, 32, 4, 32),
               "darcy_n32_c32": (32, 32, 16, 8, 16)}
#: the same block shapes at d 3: ``exp_3d`` at 32^3 (untimed)
VOLUME_ERWIN = {"heat3d_n64_c16": (64, 16, 32, 4, 0),
                "heat3d_n32_c32": (32, 32, 16, 8, 0)}
#: the slice kernels' shapes ``(B, H, N, C, G)``: the Darcy batch of 4 on
#: the 85 x 85 grid (timed) and ``exp_3d``'s on 32^3 (untimed)
DARCY_SLICE = {"darcy_b4": (4, 8, 85 * 85, 16, 64)}
#: the preset's downsampling of the 421^2 grid: 85 x 85
DARCY_DOWNSAMPLE = 5
VOLUME_SLICE = {"heat3d_b4": (4, 8, 32 ** 3, 16, 64)}
#: kernel launches per train step of the Darcy preset
DARCY_PER_STEP = {"slice_states": 8, "deslice": 8, "slice_states_bwd": 8,
                  "deslice_bwd": 8, "fused_erwin_block": 48,
                  "fused_erwin_block_bwd": 48, "copy_scale": 0}
DARCY_FORWARD = ("slice_states", "deslice", "fused_erwin_block")
DARCY_STEPS = 5
#: use_checkpoint against the plain step: each gradient within this of
#: its leaf's max (the recompute runs the same kernels on the same values)
CHECKPOINT_RTOL = 1e-6


def pde_erwin_phase(dev, timed=None, untimed=None, clouds=PDE_CLOUDS,
                    label="phase 12a", suffix="darcy", seed=SEED + 60):
    """12a: the Erwin kernels, forward and backward, at the Darcy block
    shapes (``timed``, default ``DARCY_ERWIN``: d 2, SwiGLU hidden C,
    ``clouds`` 32) against the plain block: out, dx, dpos and all 14
    parameter gradients within ``KERNEL_RTOL`` of each output's max, two
    calls bit-identical, device us per call beside the bound at d 2 and the
    plain version's time; then, untimed, the 3D preset's shapes
    (``untimed``, default ``VOLUME_ERWIN``: d 3). Returns the
    ``*_<suffix>`` records, their times mixed by each shape's launches per
    step (the last entry of a shape; none when every weight is 0, and then
    no shape is timed). Phase 13a runs it at the NS and the drivers'
    shapes."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    timed = DARCY_ERWIN if timed is None else timed
    untimed = VOLUME_ERWIN if untimed is None else untimed
    g = torch.Generator().manual_seed(seed)
    out = {k: {"err": 0.0, "us": {}, "ms": [], "plain_ms": [], "bound": []}
           for k in ("fwd", "bwd")}
    shapes = [(tag, *v, 2) for tag, v in timed.items()]
    shapes += [(tag, *v, 3) for tag, v in untimed.items()]
    for tag, n_e, c_e, ball, heads, weight, d in shapes:
        print(f"{label}: fused_erwin_block fwd/bwd ({tag})  x "
              f"[{clouds}, {n_e}, {c_e}], {heads} heads, ball {ball}, d "
              f"{d}, SwiGLU {c_e}; "
              f"{erwin_launch_line(n_e, c_e, ball, heads, 1, clouds, d)}",
              flush=True)
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball, heads, 1,
                                          clouds, d)
        dout = torch.randn(xe.shape, generator=g).to(dev)
        with torch.inference_mode():
            o_k = [eb.fused_erwin_block(xe, pe, params, **kw) for _ in (0, 1)]
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            err_f = compare("out", o_k[0], o_p, KERNEL_RTOL)
        b_k = [eb.fused_erwin_block_bwd(xe, pe, dout, params, **kw)
               for _ in (0, 1)]
        b_p = eb.erwin_block_bwd_plain(xe, pe, dout, params, **kw)
        torch.cuda.synchronize()
        err_b = max([compare("dx", b_k[0][0], b_p[0], KERNEL_RTOL),
                     compare("dpos", b_k[0][1], b_p[1], KERNEL_RTOL)]
                    + [compare(f"d {k}", b_k[0][2][k], b_p[2][k],
                               KERNEL_RTOL) for k in eb.GRAD_NAMES])
        same = torch.equal(*o_k) and all(
            torch.equal(a, w) for a, w in
            zip((b_k[0][0], b_k[0][1], *b_k[0][2].values()),
                (b_k[1][0], b_k[1][1], *b_k[1][2].values())))
        print(f"  two calls bit-identical (out, dx, dpos, 14 gradients): "
              f"{same}", flush=True)
        check(same, f"Erwin kernels at {tag} are not deterministic")
        out["fwd"]["err"] = max(out["fwd"]["err"], err_f)
        out["bwd"]["err"] = max(out["bwd"]["err"], err_b)
        if not weight:
            continue
        with torch.inference_mode():
            fwd = (lambda: eb.fused_erwin_block(xe, pe, params, **kw),
                   lambda: eb.erwin_block_plain(xe, pe, params, **kw))
            out["fwd"]["ms"].append((cuda_ms(fwd[0]), weight))
            out["fwd"]["plain_ms"].append((cuda_ms(fwd[1]), weight))
            out["fwd"]["us"][tag] = device_us(fwd[0], ERWIN_FWD_KERNELS)
        bwd = lambda: eb.fused_erwin_block_bwd(  # noqa: E731
            xe, pe, dout, params, **kw)
        out["bwd"]["ms"].append((cuda_ms(bwd), weight))
        out["bwd"]["plain_ms"].append((plain_bwd_ms(xe, pe, dout, params,
                                                    kw), weight))
        out["bwd"]["us"][tag] = device_us(bwd, ERWIN_BWD_KERNELS)
        args = (n_e, c_e, ball, heads, 1, clouds, d)
        out["fwd"]["bound"].append((erwin_fwd_bound(*args), weight))
        out["bwd"]["bound"].append((erwin_bwd_bound(*args), weight))
        for k in ("fwd", "bwd"):
            bd = out[k]["bound"][-1][0]
            print(f"  {k}: device {out[k]['us'][tag]:.2f} us per call "
                  f"(profiler); events {out[k]['ms'][-1][0]:.4f} ms, plain "
                  f"{out[k]['plain_ms'][-1][0]:.4f} ms; bound "
                  f"{bd[0] * 1e3:.3f} us ({bd[1]})", flush=True)
    total = sum(w for *_, w in timed.values())
    if not total:
        return []
    mix = lambda xs: sum(t * w for t, w in xs) / total  # noqa: E731
    recs = []
    for k, name, line in (("fwd", f"fused_erwin_block_{suffix}", 163),
                          ("bwd", f"fused_erwin_block_bwd_{suffix}", 187)):
        r = out[k]
        bound = (mix([(bd[0], w) for bd, w in r["bound"]]),
                 "bytes" if all(bd[1] == "bytes" for bd, _ in r["bound"])
                 else "operations")
        recs.append(kernel_record(
            name, "haet_torch/csrc/erwin_block.cu",
            f"haet_tpu/ops/pallas/erwin_block.py:{line}", r["err"],
            mix(r["ms"]), mix(r["plain_ms"]), bound,
            device_us_per_call=r["us"],
            per_shape_ms={t: ms for t, (ms, _) in zip(timed, r["ms"])}))
    return recs


def pde_slice_phase(dev):
    """12b: the slice forwards and backwards at the Darcy batch
    (``DARCY_SLICE``, G 64 at C 16) as phases 3 and 3b hold them, timed,
    and untimed at the 3D preset's (``VOLUME_SLICE``). Returns the
    ``*_darcy`` records."""
    recs = slice_phase(dev, DARCY_SLICE, timed=True, label="phase 12b")
    recs += slice_bwd_phase(dev, DARCY_SLICE, timed=True, label="phase 12b")
    slice_phase(dev, VOLUME_SLICE, timed=False, label="phase 12b")
    slice_bwd_phase(dev, VOLUME_SLICE, timed=False, label="phase 12b")
    for r in recs:
        r["name"] += "_darcy"
    return recs


def darcy_setup(dev):
    """The Darcy preset at full width (8 layers, n_hidden 128, 8 heads, G
    64, ``unified_pos`` ref 8, batch 4, AdamW + OneCycle) on the synthetic
    85 x 85 stand-in (``load_darcy`` of an empty directory: 32 training
    and 16 test samples), normalised as ``exp_darcy`` does; ``build(...)``
    makes a trainer with both kernel flags and seeded weights perturbed by
    0.05 N(0, 1), the same for every call."""
    import dataclasses
    import tempfile

    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.benchmarks.exp_darcy import darcy_loss
    from haet_torch.data.pde_datasets import load_darcy
    from haet_torch.data.synthetic import batch_iter
    from haet_torch.train import Trainer
    from haet_torch.train.normalizer import UnitTransformer
    from haet_torch.utils.config import darcy_config

    cfg = darcy_config(DARCY_DOWNSAMPLE)
    with tempfile.TemporaryDirectory() as empty:
        data = load_darcy(empty, 32, 16, DARCY_DOWNSAMPLE)
    s = data["s"]
    check(data["synthetic"] and s == cfg.model.H == cfg.model.W,
          "the Darcy stand-in")
    x_norm = UnitTransformer(data["train"]["x"])
    y_norm = UnitTransformer(data["train"]["y"])
    sets = {k: {"pos": data[k]["pos"],
                "fx": x_norm.encode(data[k]["x"])[..., None].astype(
                    np.float32),
                "y": data[k]["y"].astype(np.float32)}
            for k in ("train", "test")}
    loss_fn, eval_fn = darcy_loss(
        s, torch.tensor(np.float32(y_norm.mean.squeeze()), device=dev),
        torch.tensor(np.float32(y_norm.std.squeeze()), device=dev))
    bs = cfg.train.batch_size
    batches = list(batch_iter(sets["train"], bs, True, 1)())

    def build(eager=False, flags=True, train=None, **model):
        mc = dataclasses.replace(cfg.model, **model)
        net = (build_model(mc, dev, seed=SEED) if flags
               else mc.build(dev, seed=SEED))
        g = torch.Generator().manual_seed(SEED + 3)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
        tc = dataclasses.replace(cfg.train, **(train or {}))
        return Trainer(net, loss_fn, tc, total_steps=4 * len(batches),
                       batch_args=lambda b: (b["pos"], b["fx"]),
                       eval_fn=eval_fn, eager=eager)

    return cfg, sets, batches, build


def step_grads(trainer) -> dict:
    """The parameters' gradients after a step, by name (None: none)."""
    return {k: None if p.grad is None else p.grad.detach().clone()
            for k, p in trainer.model.named_parameters()}


def hold_grads(what, got, want, rtol) -> bool:
    """Every gradient of ``got`` within ``rtol`` of its leaf's max in
    ``want`` (the same leaves without one); returns whether all are
    bit-identical."""
    import torch

    identical, worst = True, (0.0, "")
    for k, w in want.items():
        g = got[k]
        check((g is None) == (w is None), f"{what}: {k} gradient presence")
        if w is None:
            continue
        err = float((g.double() - w.double()).abs().max())
        scale = max(float(w.double().abs().max()), 1e-30)
        check(err <= rtol * scale, f"{what}: {k} differs by {err} > {rtol} "
                                   f"x {scale}")
        worst = max(worst, (err / scale, k))
        identical = identical and torch.equal(g, w)
    print(f"  {what}: largest gradient error relative to its leaf's max "
          f"{worst[0]:.3e} ({worst[1]}); bit-identical {identical}",
          flush=True)
    return identical


def measured_step(trainer, batch):
    """One eager step: ``(its launch counts, zeroed just before it; its
    host wall in ms, between synchronizes; its temporaries at peak, MiB
    above what was allocated before it)``."""
    import torch

    from haet_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (launch_counts(), wall,
            (torch.cuda.max_memory_allocated() - start) / 2**20)


def darcy_phase(dev):
    """12c: the Darcy preset at full width, its eval forward against the
    plain path, graphed steps against eager ones with their kernel counts,
    walls, device time and memory, then ``use_checkpoint``,
    ``accum_steps`` 2 and dropout. Returns ``(launches of one eager step,
    summary)``."""
    import copy
    import gc

    import torch

    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        profile_launches,
                                        reset_launch_counts)
    from haet_torch.utils.profiling import device_trace, kernel_events

    cfg, sets, batches, build = darcy_setup(dev)
    per_fwd = {k: (v if k in DARCY_FORWARD else 0)
               for k, v in DARCY_PER_STEP.items()}
    out = {}

    print("phase 12c: the eval forward against the plain path", flush=True)
    graphed = build()
    n_params = graphed.num_params()
    plain = build(eager=True, flags=False)
    test = {k: torch.from_numpy(v[:4]).to(dev)
            for k, v in sets["test"].items()}
    with torch.inference_mode():
        graphed.model.eval()
        plain.model.eval()
        reset_launch_counts()
        got = graphed.model(test["pos"], test["fx"])
        torch.cuda.synchronize()
        counts = launch_counts()
        want = plain.model(test["pos"], test["fx"])
    expect_counts("launches of one eval forward", counts, per_fwd)
    out["eval_max_abs_err"] = compare("eval out", got, want, SERVE_RTOL)
    del plain, got, want
    print(f"  {n_params} parameters; {len(batches)} batches of "
          f"{cfg.train.batch_size} over {cfg.model.H} x {cfg.model.W}",
          flush=True)

    print(f"phase 12c: {DARCY_STEPS} graphed steps against eager ones",
          flush=True)
    eager = build(eager=True)
    hold_states("phase 12c: the two trainers' initial state", graphed, eager)
    # determinism first: two eager steps from one state (the conv's
    # backward in cuDNN sums in a fixed order only under the policy's
    # ``cudnn.deterministic``)
    snapshot = copy.deepcopy(eager.state_dict())
    first = {k: float(v) for k, v in eager.train_step(batches[0]).items()}
    g_first = step_grads(eager)
    eager.load_state_dict(snapshot)
    second = {k: float(v) for k, v in eager.train_step(batches[0]).items()}
    identical = first == second and all(
        (a is None and g_first[k] is None) or torch.equal(a, g_first[k])
        for k, a in step_grads(eager).items())
    print(f"  two eager steps from one state: bit-identical {identical}",
          flush=True)
    check(identical, "two eager Darcy steps from one state differ")
    eager.load_state_dict(snapshot)
    del snapshot
    same = True
    for i in range(DARCY_STEPS):
        b = batches[i]
        mg, me = graphed.train_step(b), eager.train_step(b)
        same = hold_step(f"12c step {i + 1}", mg, me,
                         (graphed.optimizer.hparams.cpu(),
                          eager.optimizer.hparams.cpu())) and same
    print(f"  every step's metrics bit-identical: {same}; captured in "
          f"{[round(t, 3) for t in getattr(graphed.graphs, 'capture_s', [])]}"
          f" s", flush=True)
    hold_states(f"phase 12c: state after {DARCY_STEPS} steps", graphed,
                eager)
    step_counts = measured_step(eager, batches[DARCY_STEPS])[0]
    expect_counts("launches of one eager step", step_counts, DARCY_PER_STEP)
    expect_counts("plain routes", plain_route_counts(),
                  {k: 0 for k in plain_route_counts()})
    _, replay = profile_launches(graphed.train_step, batches[DARCY_STEPS])
    expect_counts("kernel calls in one replay", replay["calls"],
                  DARCY_PER_STEP)
    walls = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    eager_walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager.train_step(batches[i])
        torch.cuda.synchronize()
        eager_walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls)) * 1e3
    with device_trace() as prof:
        graphed.train_step(batches[0])
    top = kernel_events(prof)[:12]
    print("  one replay's device time by kernel:", flush=True)
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    out["top_kernels_ms"] = {e.key[:90]: e.self_device_time_total / 1e3
                             for e in top}
    plain_peak = measured_step(eager, batches[0])[2]
    out.update(step_wall_ms=wall, step_walls_ms=[w * 1e3 for w in walls],
               eager_wall_ms=float(np.median(eager_walls)) * 1e3,
               device_ms=replay["device_ms"], kernels=replay["kernels"],
               copies=replay["copies"], busy=replay["device_ms"] / wall,
               eager_step_peak_mib=plain_peak,
               max_allocated_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(f"  graphed step wall median {wall:.3f} ms (min "
          f"{min(walls) * 1e3:.3f}) of 12; device {replay['device_ms']:.3f} ms "
          f"in {replay['kernels']} kernels and {replay['copies']} copies; "
          f"busy {out['busy']:.3f}; eager step wall median "
          f"{out['eager_wall_ms']:.3f} ms; the eager step's temporaries at "
          f"peak {plain_peak:.1f} MiB", flush=True)
    del graphed, eager
    gc.collect()
    torch.cuda.empty_cache()

    print("phase 12c: use_checkpoint against the plain step", flush=True)
    plain, remat = build(eager=True), build(eager=True, use_checkpoint=True)
    m_p = plain.train_step(batches[0])
    g_p, sd_p = step_grads(plain), copy.deepcopy(plain.model.state_dict())
    torch.cuda.synchronize()
    reset_launch_counts()
    m_r = remat.train_step(batches[0])
    torch.cuda.synchronize()
    remat_counts = launch_counts()
    want = {k: v * (2 if k in DARCY_FORWARD else 1)
            for k, v in DARCY_PER_STEP.items()}
    expect_counts("launches of one checkpointed eager step (forward "
                  "kernels twice)", remat_counts, want)
    check(abs(float(m_r["loss"]) - float(m_p["loss"]))
          <= CHECKPOINT_RTOL * abs(float(m_p["loss"])),
          f"checkpointed loss {float(m_r['loss'])} vs {float(m_p['loss'])}")
    out["checkpoint_grads_identical"] = hold_grads(
        "use_checkpoint gradients", step_grads(remat), g_p, CHECKPOINT_RTOL)
    sd_r = remat.model.state_dict()
    stats = [k for k in sd_p if "running_" in k or "num_batches" in k]
    check(bool(stats) and all(torch.equal(sd_r[k], sd_p[k]) for k in stats),
          "BatchNorm statistics after a checkpointed step differ")
    check({int(sd_r[k]) for k in stats if "num_batches" in k} == {1},
          "BatchNorm statistics updated more than once")
    remat_peak = measured_step(remat, batches[1])[2]
    plain_peak = measured_step(plain, batches[1])[2]
    print(f"  BatchNorm statistics ({len(stats)} tensors) equal, updated "
          f"once; the eager step's temporaries at peak: {remat_peak:.1f} MiB "
          f"with use_checkpoint, {plain_peak:.1f} MiB without", flush=True)
    remat_graphed = build(use_checkpoint=True)
    remat_ref = build(eager=True, use_checkpoint=True)
    hold_step("12c checkpointed step, graphed against eager",
              remat_graphed.train_step(batches[0]),
              remat_ref.train_step(batches[0]),
              (remat_graphed.optimizer.hparams.cpu(),
               remat_ref.optimizer.hparams.cpu()))
    hold_states("phase 12c: checkpointed state, graphed against eager",
                remat_graphed, remat_ref)
    remat_walls = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        remat_graphed.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        remat_walls.append(time.perf_counter() - t0)
    _, remat_replay = profile_launches(remat_graphed.train_step, batches[1])
    out.update(checkpoint_step_peak_mib=remat_peak,
               plain_step_peak_mib=plain_peak,
               checkpoint_step_wall_ms=float(np.median(remat_walls)) * 1e3,
               checkpoint_device_ms=remat_replay["device_ms"],
               checkpoint_kernels=remat_replay["kernels"])
    print(f"  graphed checkpointed step wall median "
          f"{out['checkpoint_step_wall_ms']:.3f} ms; device "
          f"{remat_replay['device_ms']:.3f} ms in {remat_replay['kernels']} "
          f"kernels", flush=True)
    del plain, remat, remat_graphed, remat_ref
    gc.collect()
    torch.cuda.empty_cache()

    print("phase 12c: accum_steps 2 against the eager step and the full "
          "batch", flush=True)
    full = build(eager=True)
    acc_g = build(train={"accum_steps": 2})
    acc_e = build(eager=True, train={"accum_steps": 2})
    full.train_step(batches[0])
    g_full = step_grads(full)
    hold_step("12c accum_steps 2, graphed against eager",
              acc_g.train_step(batches[0]), acc_e.train_step(batches[0]),
              (acc_g.optimizer.hparams.cpu(), acc_e.optimizer.hparams.cpu()))
    hold_states("phase 12c: accum_steps 2 state, graphed against eager",
                acc_g, acc_e)
    gmax = max(float(g.abs().max()) for g in g_full.values()
               if g is not None)
    dev_full = max(float((a - g_full[k]).abs().max())
                   for k, a in step_grads(acc_e).items()
                   if a is not None) / gmax
    acc_counts = measured_step(acc_e, batches[1])[0]
    expect_counts("launches of one eager accum_steps 2 step (2 "
                  "microbatches)", acc_counts,
                  {k: 2 * v for k, v in DARCY_PER_STEP.items()})
    print(f"  against the full batch of 4 (not held: train-mode BatchNorm "
          f"and the pseudo-positions' min-max see each microbatch alone): "
          f"largest gradient deviation relative to the largest |gradient| "
          f"{dev_full:.3e}", flush=True)
    out["accum_full_batch_rel"] = dev_full
    del full, acc_g, acc_e
    gc.collect()
    torch.cuda.empty_cache()

    print("phase 12c: dropout 0.1", flush=True)
    drop_g, drop_e = build(dropout=0.1), build(eager=True, dropout=0.1)
    hold_step("12c dropout step 1, graphed against eager (one generator "
              "state)", drop_g.train_step(batches[0]),
              drop_e.train_step(batches[0]),
              (drop_g.optimizer.hparams.cpu(),
               drop_e.optimizer.hparams.cpu()))
    snapshot = copy.deepcopy(drop_g.state_dict())
    gen = drop_g.model.dropout_generator
    state = gen.get_state()
    first = float(drop_g.train_step(batches[1])["loss"])
    drop_g.load_state_dict(snapshot)
    second = float(drop_g.train_step(batches[1])["loss"])
    drop_g.load_state_dict(snapshot)
    gen.set_state(state)
    again = float(drop_g.train_step(batches[1])["loss"])
    print(f"  two replays from one state: losses {first:.8f} and "
          f"{second:.8f} (fresh masks); from the first one's generator "
          f"state again {again:.8f}", flush=True)
    check(first != second, "two dropout replays drew the same masks")
    check(again == first, "a replay from one generator state differs")
    del drop_g, drop_e
    gc.collect()
    torch.cuda.empty_cache()
    out["params"] = n_params
    return step_counts, out


def pde_drivers_phase(dev):
    """12d: each PDE driver briefly on the card (full width): ``exp_darcy``
    on the stand-in, ``exp_pipe``, ``exp_airfoil`` and ``exp_elas`` on the
    fixtures, ``exp_3d`` at 32^3 (``use_checkpoint`` on, its default),
    1 epoch each: a finite ``rel_err``, every kernel of the path launched,
    no plain route."""
    import tempfile

    import torch

    from haet_torch.benchmarks import (exp_3d, exp_airfoil, exp_darcy,
                                       exp_elas, exp_pipe)
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)

    fixtures = str(ROOT / "tests" / "fixtures" / "data")
    one = ["--epochs", "1"]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {"exp_darcy": (exp_darcy, one + ["--data_path", tmp]),
                "exp_pipe": (exp_pipe, one + ["--data_path", fixtures]),
                "exp_airfoil": (exp_airfoil, one + [
                    "--data_path", fixtures, "--ntrain", "2",
                    "--ntest", "2"]),
                "exp_elas": (exp_elas, one + ["--data_path", fixtures]),
                "exp_3d": (exp_3d, one)}
        for name, (mod, argv) in runs.items():
            print(f"phase 12d: {name} {' '.join(argv)}", flush=True)
            reset_launch_counts()
            t0 = time.perf_counter()
            rel = mod.main(argv + ["--out_dir", f"{tmp}/{name}"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()
            print(f"  rel_err {rel}; {secs:.1f} s; launches {counts}",
                  flush=True)
            check(np.isfinite(rel), f"{name}: rel_err {rel}")
            check(all(counts[k] > 0 for k in DARCY_PER_STEP
                      if k != "copy_scale"),
                  f"{name}: a kernel of the path did not launch: {counts}")
            check(all(v == 0 for v in plain_route_counts().values()),
                  f"{name}: plain routes {plain_route_counts()}")
            res[name] = {"rel_err": rel, "seconds": secs,
                         "launches": counts}
            torch.cuda.empty_cache()
    return res


def pde_phase(dev):
    """Phase 12: 12a-12d. Returns ``(records, summary)``; the records'
    ``launches`` are 12c's counts of one eager step."""
    t0 = time.perf_counter()
    records = pde_erwin_phase(dev) + pde_slice_phase(dev)
    step_counts, darcy = darcy_phase(dev)
    for r in records:
        r["launches"] = step_counts[r["name"].removesuffix("_darcy")]
    drivers = pde_drivers_phase(dev)
    secs = time.perf_counter() - t0
    print(f"phase 12: {secs:.1f} s", flush=True)
    return records, {"darcy": darcy, "drivers": drivers, "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 13: the time-stepping PDE loops, rollout export, the Erwin baseline.
# ---------------------------------------------------------------------------

#: B*H clouds of the NS preset's Erwin stage (batch 2 x 8 heads)
NS_CLOUDS = 16
#: the NS preset's Erwin block shapes ``tag: (n, C, ball, heads, forward
#: launches per step)`` at d 2, SwiGLU hidden C, G 64 slices of C 32:
#: encoder0 and decoder0 (64 tokens in two balls of 32, 4 heads; 2 + 2
#: blocks a layer) and the bottleneck (32 tokens in two balls of 16, 8
#: heads; 2 blocks a layer); 8 layers, 10 frames, each frame's forward run
#: twice under the per-frame checkpoint
NS_ERWIN = {"ns_n64_c32": (64, 32, 32, 4, 640),
            "ns_n32_c64": (32, 64, 16, 8, 320)}
#: the slice kernels at the NS batch of 2 on the 64 x 64 grid
NS_SLICE = {"ns_b2": (2, 8, 64 * 64, 32, 64)}
#: the plasticity batch's clouds (batch 8 x 8 heads) and the same block
#: shapes at the Darcy batch's 32, for the one-wave comparison
PLAS_CLOUDS = (64, 32)
#: the slice kernels at the drivers' own shapes, held untimed: ``exp_ns``
#: at its default ``--n-hidden`` 128 (C 16) in training and eval (batch 2)
#: and its rollout program (batch 1); ``exp_plas`` (C 16 on 101 x 31) at
#: the preset's batch of 8 and the stand-in's of 3
DRIVER_SLICE = {"exp_ns_b2": (2, 8, 64 * 64, 16, 64),
                "exp_ns_b1": (1, 8, 64 * 64, 16, 64),
                "plas_b8": (8, 8, 101 * 31, 16, 64),
                "plas_b3": (3, 8, 101 * 31, 16, 64)}
#: their Erwin stages (the Darcy block shapes at C 16): ``exp_ns`` at batch
#: 2 and 1, the plasticity stand-in at batch 3 (the preset's 64 clouds are
#: ``PLAS_CLOUDS``), held untimed
DRIVER_CLOUDS = (16, 8, 24)
#: ``micro_rollout``'s forward kernels in bf16: the NS preset at batch 1
#: (the slice at C 32, ``NS_ERWIN`` on 8 clouds)
ROLLOUT_BF16_SLICE = {"rollout_b1": (1, 8, 64 * 64, 32, 64)}
ROLLOUT_CLOUDS = 8
NS_FRAMES = 10
#: the NS stand-in's grid side (the preset's 64 x 64)
NS_GRID = 64
#: kernel launches per NS training step: forward kernels 8 + 8 + 48 per
#: forward, twice per frame under the checkpoint; backwards once per frame
NS_PER_STEP = {"slice_states": 160, "deslice": 160, "slice_states_bwd": 80,
               "deslice_bwd": 80, "fused_erwin_block": 960,
               "fused_erwin_block_bwd": 480, "copy_scale": 0}
NS_UNCHECKED = {k: v // 2 if k in DARCY_FORWARD else v
                for k, v in NS_PER_STEP.items()}
#: the depth of 13c's and 13d's NS models (full width): a rollout program
#: unrolls layers x frames, and its export and load took ~1 s per
#: layer-frame on the card's host (72 s to load 8 x 10); the script must
#: end within its time limit on a slow host too
NS_PROGRAM_LAYERS = 1
#: 13c's rollout frames (the preset's 10 cut: the unrolled program's
#: export grows with layers x frames)
MICRO_ROLLOUT_FRAMES = 4


def rollout_per_call(layers: int) -> dict:
    """Launches of one call of an exported 10-frame rollout program of
    ``layers`` layers (its per-layer share of the forward)."""
    return {k: (v // 2 * layers // 8 if k in DARCY_FORWARD else 0)
            for k, v in NS_PER_STEP.items()}


def ns_kernel_phase(dev):
    """13a: the path kernels at the NS shapes (``NS_SLICE``, ``NS_ERWIN``)
    as phases 3, 3b and 12a hold them, timed; untimed at the drivers'
    shapes (``DRIVER_SLICE``, the Darcy block shapes at ``DRIVER_CLOUDS``)
    and ``micro_rollout``'s bf16 forwards; then the Erwin kernels at
    ``PLAS_CLOUDS`` clouds of the Darcy block shapes with each kernel's
    ``cudaOccupancyMaxActiveClusters``. Returns ``(the *_ns records, the
    plasticity comparison)``."""
    from haet_torch.ops.kernels import erwin_block as eb

    recs = slice_phase(dev, NS_SLICE, timed=True, label="phase 13a")
    recs += slice_bwd_phase(dev, NS_SLICE, timed=True, label="phase 13a")
    for r in recs:
        r["name"] += "_ns"
    recs += pde_erwin_phase(dev, NS_ERWIN, {}, NS_CLOUDS, "phase 13a", "ns",
                            SEED + 70)
    slice_phase(dev, DRIVER_SLICE, timed=False, label="phase 13a")
    slice_bwd_phase(dev, {k: v for k, v in DRIVER_SLICE.items()
                          if k != "exp_ns_b1"}, timed=False,
                    label="phase 13a")
    untimed = {tag: (*v[:4], 0) for tag, v in DARCY_ERWIN.items()}
    for clouds in DRIVER_CLOUDS:
        pde_erwin_phase(dev, untimed, {}, clouds, "phase 13a", "driver",
                        SEED + 90 + clouds)
    rollout_bf16_phase(dev)
    plas = {}
    for clouds in PLAS_CLOUDS:
        rs = pde_erwin_phase(dev, DARCY_ERWIN, {}, clouds, "phase 13a",
                             f"plas{clouds}", SEED + 80)
        plas[clouds] = {r["name"].split("_plas")[0]: r["device_us_per_call"]
                        for r in rs}
    occ = {tag: {k: eb.max_active_clusters(n_e, c_e, 2, c_e, heads, ball,
                                          bwd=k == "bwd")
                 for k in ("fwd", "bwd")}
           for tag, (n_e, c_e, ball, heads, _) in {**NS_ERWIN,
                                                   **DARCY_ERWIN}.items()}
    for tag in NS_ERWIN:
        print(f"phase 13a: Erwin at {tag}: cudaOccupancyMaxActiveClusters "
              f"fwd {occ[tag]['fwd']}, bwd {occ[tag]['bwd']}; "
              f"{NS_CLOUDS} clouds in one wave fwd "
              f"{NS_CLOUDS <= occ[tag]['fwd']}, bwd "
              f"{NS_CLOUDS <= occ[tag]['bwd']}", flush=True)
    for tag in DARCY_ERWIN:
        us = {c: (plas[c]["fused_erwin_block"][tag],
                  plas[c]["fused_erwin_block_bwd"][tag])
              for c in PLAS_CLOUDS}
        print(f"phase 13a: Erwin at {tag}: device us per call fwd / bwd, "
              f"{PLAS_CLOUDS[0]} clouds {us[PLAS_CLOUDS[0]][0]:.2f} / "
              f"{us[PLAS_CLOUDS[0]][1]:.2f}, {PLAS_CLOUDS[1]} clouds "
              f"{us[PLAS_CLOUDS[1]][0]:.2f} / {us[PLAS_CLOUDS[1]][1]:.2f}; "
              f"cudaOccupancyMaxActiveClusters (clusters of {eb.CLUSTER}) "
              f"fwd {occ[tag]['fwd']}, bwd {occ[tag]['bwd']}: "
              f"{PLAS_CLOUDS[0]} clouds in one wave fwd "
              f"{PLAS_CLOUDS[0] <= occ[tag]['fwd']}, bwd "
              f"{PLAS_CLOUDS[0] <= occ[tag]['bwd']}", flush=True)
        check(min(occ[tag].values()) > 0,
              f"no cluster of the Erwin kernels fits at {tag}")
    return recs, {"device_us_per_call": plas, "max_active_clusters": occ}


def rollout_bf16_phase(dev):
    """13a, ``micro_rollout``'s forward kernels in bf16 (the NS preset at
    batch 1: ``ROLLOUT_BF16_SLICE``, ``NS_ERWIN`` on ``ROLLOUT_CLOUDS``
    clouds) against their plain versions on the same bf16 inputs as phase
    10a holds them: bf16 outputs within ``BF16_RTOL``, m and s within
    ``KERNEL_RTOL``, two calls bit-identical."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import erwin_block as eb
    from haet_torch.ops.kernels import slice_kernels as sk

    bf = torch.bfloat16
    for i, (tag, shape) in enumerate(ROLLOUT_BF16_SLICE.items()):
        b, h, n, c, gs = shape
        print(f"phase 13a: slice_states / deslice in bf16 ({tag})  x [{b}, "
              f"{h}, {n}, {c}] bf16, G {gs}", flush=True)
        x32, ws, bs, wa, ba, st32 = sb.inputs(shape, dev, SEED + 100 + i)
        x, st = x32.to(bf), st32.to(bf)
        with torch.inference_mode():
            got = [sk.slice_states_with_residual(x, ws, bs, wa, ba)
                   for _ in (0, 1)]
            p32, m, s = sk.slice_states_plain_f32(x, ws, bs, wa, ba)
            outs = [sk.deslice(x, ws, bs, wa, ba, st, m, s) for _ in (0, 1)]
            want = sk.deslice_plain(x, ws, bs, wa, ba, st, m, s)
            torch.cuda.synchronize()
            check(got[0][0].dtype == bf and outs[0].dtype == bf,
                  "bf16 slice dtypes")
            compare("states (bf16)", got[0][0], p32.to(bf), BF16_RTOL)
            compare("m", got[0][2], m, KERNEL_RTOL)
            compare("s", got[0][3], s, KERNEL_RTOL)
            compare("out (bf16)", outs[0], want, BF16_RTOL)
            same = all(torch.equal(a, w) for a, w in zip(*got)) and \
                torch.equal(*outs)
        print(f"  two calls bit-identical (states, m, s, out): {same}",
              flush=True)
        check(same, f"bf16 slice kernels at {tag} are not deterministic")
        del x, x32, st, st32
    g = torch.Generator().manual_seed(SEED + 110)
    for tag, (n_e, c_e, ball, heads, _) in NS_ERWIN.items():
        print(f"phase 13a: fused_erwin_block in bf16 ({tag})  x "
              f"[{ROLLOUT_CLOUDS}, {n_e}, {c_e}] bf16, {heads} heads, ball "
              f"{ball}, d 2, SwiGLU {c_e}", flush=True)
        xe32, pe32, params, kw = erwin_inputs(dev, g, n_e, c_e, ball, heads,
                                              1, ROLLOUT_CLOUDS, 2)
        xe, pe = xe32.to(bf), pe32.to(bf)
        with torch.inference_mode():
            o_k = [eb.fused_erwin_block(xe, pe, params, **kw) for _ in (0, 1)]
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            check(o_k[0].dtype == bf, "Erwin out dtype")
            compare("out (bf16)", o_k[0], o_p, BF16_RTOL)
            same = torch.equal(*o_k)
        print(f"  two calls bit-identical (out): {same}", flush=True)
        check(same, f"bf16 Erwin kernel at {tag} is not deterministic")


def ns_data(dev):
    """The NS stand-in (``load_ns`` of an empty directory: 8 training and
    4 test samples of 64 x 64, ``T_IN`` 10 and ``T_OUT`` 10 frames), its
    training batches of 2 as ``exp_ns`` draws them, and the preset sized
    to it."""
    import tempfile

    from haet_torch.benchmarks import exp_ns
    from haet_torch.data.pde_datasets import load_ns
    from haet_torch.data.synthetic import batch_iter
    from haet_torch.utils.config import ns_config

    with tempfile.TemporaryDirectory() as empty:
        data = load_ns(empty, 8, 4, exp_ns.T_IN, exp_ns.T_OUT)
    check(data["synthetic"] and data["s"] == NS_GRID, "the NS stand-in")
    cfg = ns_config()
    cfg.model.fun_dim = exp_ns.T_IN
    cfg.model.H = cfg.model.W = data["s"]
    sets = {k: {n: v.astype(np.float32) for n, v in data[k].items()}
            for k in ("train", "test")}
    batches = list(batch_iter(sets["train"], cfg.train.batch_size, True,
                              0)())
    return cfg, sets, batches


def ns_trainer(dev, cfg, checkpoint_frames=True):
    """``exp_ns``'s eager trainer over the preset at full width, both
    kernel flags, seeded weights perturbed by 0.05 N(0, 1), the per-frame
    checkpoint on or off."""
    import torch

    from haet_torch.benchmarks import exp_ns
    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.train import Trainer

    net = build_model(cfg.model, dev, seed=SEED)
    g = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
    loss_fn, eval_fn = exp_ns.rollout_loss(NS_FRAMES, exp_ns.STEP)
    return Trainer(exp_ns.Rollout(net, NS_FRAMES, exp_ns.STEP,
                                  checkpoint_frames),
                   loss_fn, cfg.train, total_steps=8, eval_fn=eval_fn,
                   batch_args=lambda b: (b["pos"], b["x"], b["y"]),
                   eager=True)


def ns_step_phase(dev):
    """13b: the NS preset's rollout training step at full width. Returns
    ``(launches of one checkpointed eager step, summary)``."""
    import copy
    import gc

    import torch

    from haet_torch.ops.kernels import plain_route_counts, profile_launches

    cfg, sets, batches = ns_data(dev)
    out = {}
    remat = ns_trainer(dev, cfg)
    out["params"] = remat.num_params()
    print(f"phase 13b: NS preset, {out['params']} parameters; "
          f"{len(batches)} batches of {cfg.train.batch_size} over "
          f"{cfg.model.H} x {cfg.model.W}, "
          f"{NS_FRAMES} frames", flush=True)
    snapshot = copy.deepcopy(remat.state_dict())
    first = {k: float(v) for k, v in remat.train_step(batches[0]).items()}
    g_first = step_grads(remat)
    sd_first = copy.deepcopy(remat.model.state_dict())
    remat.load_state_dict(snapshot)
    second = {k: float(v) for k, v in remat.train_step(batches[0]).items()}
    identical = first == second and all(
        (a is None and g_first[k] is None) or torch.equal(a, g_first[k])
        for k, a in step_grads(remat).items())
    print(f"  two eager rollout steps from one state: bit-identical "
          f"{identical}; loss {first['loss']:.6f}, full {first['full']:.6f}",
          flush=True)
    check(identical, "two eager NS steps from one state differ")
    check(all(np.isfinite(v) for v in first.values()),
          f"NS step metrics {first}")

    plain = ns_trainer(dev, cfg, checkpoint_frames=False)
    m_p = plain.train_step(batches[0])
    check(abs(float(m_p["loss"]) - first["loss"])
          <= CHECKPOINT_RTOL * abs(first["loss"]),
          f"unchecked loss {float(m_p['loss'])} vs {first['loss']}")
    out["checkpoint_grads_identical"] = hold_grads(
        "per-frame checkpoint gradients", g_first, step_grads(plain),
        CHECKPOINT_RTOL)
    sd_p = plain.model.state_dict()
    stats = [k for k in sd_p if "running_" in k or "num_batches" in k]
    check(bool(stats) and all(torch.equal(sd_first[k], sd_p[k])
                              for k in stats),
          "BatchNorm statistics after a checkpointed NS step differ")
    check({int(sd_first[k]) for k in stats if "num_batches" in k}
          == {NS_FRAMES}, "BatchNorm statistics not updated once per frame")
    print(f"  BatchNorm statistics ({len(stats)} tensors) equal, updated "
          f"{NS_FRAMES} times (once per frame)", flush=True)
    del snapshot, sd_first, g_first

    step_counts = None
    for tag, trainer, want in (("checkpoint", remat, NS_PER_STEP),
                               ("unchecked", plain, NS_UNCHECKED)):
        counts, wall, peak = measured_step(trainer, batches[1])
        expect_counts(f"launches of one {tag} NS step", counts, want)
        expect_counts("plain routes", plain_route_counts(),
                      {k: 0 for k in plain_route_counts()})
        step_counts = step_counts or counts
        out[tag] = {"step_wall_ms": wall, "step_peak_mib": peak}
        print(f"  {tag}: eager step wall {wall:.1f} ms (the counted step); "
              f"the step's temporaries at peak {peak:.1f} MiB", flush=True)
    # the CUDA activity alone: a host trace of ~50k eager launches takes
    # the profiler tens of seconds to parse, so only the checkpointed
    # step, the drivers', is traced
    t0 = time.perf_counter()
    _, prof = profile_launches(remat.train_step, batches[2], host=False)
    t_prof = time.perf_counter() - t0
    wall = out["checkpoint"]["step_wall_ms"]
    out["checkpoint"].update(device_ms=prof["device_ms"],
                             kernels=prof["kernels"], copies=prof["copies"],
                             busy=prof["device_ms"] / wall)
    print(f"  checkpoint: device {prof['device_ms']:.3f} ms in "
          f"{prof['kernels']} kernels and {prof['copies']} copies (the "
          f"profiled step); busy {out['checkpoint']['busy']:.3f}; profiled "
          f"in {t_prof:.1f} s", flush=True)
    del remat, plain
    gc.collect()
    torch.cuda.empty_cache()
    return step_counts, out


def micro_rollout_phase(dev):
    """13c: ``micro_rollout`` in bf16, one round of its windows."""
    from haet_torch.benchmarks import micro_rollout

    t0 = time.perf_counter()
    res = micro_rollout.run(rounds=1, steps=MICRO_ROLLOUT_FRAMES,
                            device=dev, n_layers=NS_PROGRAM_LAYERS)
    print(f"phase 13c: micro_rollout {json.dumps(res)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(res["dtype"] == "bfloat16", "micro_rollout did not run in bf16")
    nums = [res["value_parity_max_abs"]] + [
        v for k in ("rollout_artifact", "per_frame_loop")
        for v in res[k].values()]
    check(all(np.isfinite(v) for v in nums), f"micro_rollout: {res}")
    return res


def check_path_run(name, counts, kinds=DARCY_FORWARD + (
        "slice_states_bwd", "deslice_bwd", "fused_erwin_block_bwd")):
    """Every kernel of ``kinds`` launched in a driver's run, no plain
    route."""
    from haet_torch.ops.kernels import plain_route_counts

    check(all(counts[k] > 0 for k in kinds),
          f"{name}: a kernel of the path did not launch: {counts}")
    check(all(v == 0 for v in plain_route_counts().values()),
          f"{name}: plain routes {plain_route_counts()}")


def rollout_program_check(dev, argv, run_dir, art_dir, sets):
    """The exported rollout program of ``exp_ns`` (run with ``argv``)
    bound to its run's ``last`` checkpoint, against the eager
    autoregressive loop of the model with those weights, on the first test
    sample: within ``PROGRAM_RTOL`` of max, and 10 frames of the forward's
    launches per call."""
    import torch

    from haet_torch.benchmarks import exp_ns
    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.benchmarks.pde_common import apply_model_args
    from haet_torch.export import load_artifact, rollout
    from haet_torch.ops.kernels import launch_counts, reset_launch_counts
    from haet_torch.train import Checkpointer
    from haet_torch.utils.config import ns_config

    state = Checkpointer(f"{run_dir}/checkpoints/ns").restore(
        "last", map_location=dev)["model"]
    variables = {k.removeprefix("model."): v for k, v in state.items()}
    cfg = apply_model_args(ns_config(), exp_ns.parse_args(argv))
    cfg.model.fun_dim = exp_ns.T_IN
    cfg.model.H = cfg.model.W = NS_GRID
    net = build_model(cfg.model, dev, seed=SEED).eval()
    net.load_state_dict(variables)
    pos = torch.from_numpy(sets["test"]["pos"][:1]).to(dev)
    fx = torch.from_numpy(sets["test"]["x"][:1]).to(dev)
    t0 = time.perf_counter()
    program = load_artifact(art_dir, device=dev).bind(variables)
    t_load = time.perf_counter() - t0
    with torch.inference_mode():
        want = rollout(net, pos, fx, NS_FRAMES, exp_ns.STEP)
        program(pos, fx)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = program(pos, fx)
        torch.cuda.synchronize()
        counts = launch_counts()
    err = compare("rollout program vs eager loop", got, want, PROGRAM_RTOL)
    equal = bool(torch.equal(got, want))
    print(f"  the program equals the eager loop bit for bit: {equal}; load "
          f"and bind {t_load:.2f} s", flush=True)
    expect_counts("launches of one rollout program call", counts,
                  rollout_per_call(cfg.model.n_layers))
    return {"max_abs_err": err, "bit_identical": equal, "load_s": t_load}


def car_fixture_folds(root):
    """A 2-fold miniature of the ShapeNet-Car layout from the car fixture
    (``param0``: 1 sample, ``param1``: 2), as the CPU tests build it."""
    fixture = ROOT / "tests" / "fixtures" / "data" / "car" / "param0" / \
        "fixturecar000"
    for fold, names in (("param0", ["car_a"]), ("param1", ["car_b",
                                                          "car_c"])):
        for name in names:
            shutil.copytree(fixture, f"{root}/{fold}/{name}")
    return root


def baseline_full_step(dev):
    """Two eager training steps and one eval forward of the Erwin-only
    baseline on a stand-in car (``car_like``: ~18-21k points, bucketed to
    a multiple of 2048, then padded to one Erwin cloud of 32768: the
    ball-grouped neighbour search at full size): finite, no Erwin launch,
    the second step's wall, temporaries and the device's peak."""
    import torch

    from haet_torch.benchmarks.erwin_baseline import ErwinCarModel
    from haet_torch.data.shapenet_car import CarSample
    from haet_torch.data.synthetic import car_like
    from haet_torch.train import Trainer
    from haet_torch.train.car import loss_fn_builder, make_batch
    from haet_torch.utils.config import TrainConfig

    d = car_like(n=1, npts=N_POINTS, seed=SEED)[0]
    batch = make_batch(CarSample(pos=d["pos"], x=d["x"], y=d["y"],
                                 surf=d["surf"]))
    model = ErwinCarModel(device=dev, seed=SEED)
    trainer = Trainer(model, loss_fn_builder(0.5),
                      TrainConfig(epochs=1, batch_size=1, max_grad_norm=1.0),
                      total_steps=4, batch_args=lambda b: (b["x"],),
                      eager=True)
    metrics = trainer.train_step(batch)
    counts, wall, temps = measured_step(trainer, batch)
    peak = torch.cuda.max_memory_allocated() / 2**20
    out = trainer.predict(batch)
    torch.cuda.synchronize()
    vals = [float(v) for v in metrics.values()]
    check(all(np.isfinite(v) for v in vals) and bool(out.isfinite().all()),
          "the Erwin baseline at full size is not finite")
    check(not any(counts.values()),
          f"the Erwin baseline at full size launched kernels: {counts}")
    n = batch["x"].shape[1]
    res = {"points": n, "cloud": 1 << (n - 1).bit_length(),
           "params": trainer.num_params(), "step_wall_ms": wall,
           "step_peak_mib": temps, "peak_mib": peak, "loss": vals[0]}
    print(f"  baseline on {len(d['pos'])} points, batch {n} (its bucket), "
          f"one Erwin cloud of {res['cloud']} ({res['params']} "
          f"parameters): eager step wall {wall:.2f} ms, its temporaries "
          f"{temps:.1f} MiB, peak device memory {peak:.1f} MiB; launches "
          f"{counts}; loss {vals[0]:.5f}", flush=True)
    return res


def ns_drivers_phase(dev):
    """13d: ``exp_ns --export_rollout`` and ``exp_plas`` on their
    stand-ins and ``erwin_baseline`` on the car fixture's fold layout, one
    epoch each at full width; the rollout program against the eager loop;
    the baseline's step at full size."""
    import tempfile

    import torch

    from haet_torch.benchmarks import erwin_baseline, exp_ns, exp_plas
    from haet_torch.ops.kernels import (erwin_block as eb, launch_counts,
                                        plain_route_counts,
                                        reset_launch_counts)

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        _, sets, _ = ns_data(dev)
        runs = {"exp_ns": (exp_ns, ["--data_path", tmp, "--export_rollout",
                                    f"{tmp}/rollout", "--n-layers",
                                    str(NS_PROGRAM_LAYERS)]),
                "exp_plas": (exp_plas, ["--data_path", tmp])}
        for name, (mod, argv) in runs.items():
            argv += ["--epochs", "1", "--out_dir", f"{tmp}/{name}"]
            print(f"phase 13d: {name} {' '.join(argv)}", flush=True)
            reset_launch_counts()
            t0 = time.perf_counter()
            rel = mod.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()
            print(f"  rel_err {rel}; {secs:.1f} s; launches {counts}",
                  flush=True)
            check(np.isfinite(rel), f"{name}: rel_err {rel}")
            check_path_run(name, counts)
            res[name] = {"rel_err": rel, "seconds": secs, "launches": counts}
            torch.cuda.empty_cache()
        res["rollout_program"] = rollout_program_check(
            dev, runs["exp_ns"][1], f"{tmp}/exp_ns", f"{tmp}/rollout", sets)

        argv = ["--epochs", "1", "--data_dir", car_fixture_folds(f"{tmp}/car"),
                "--out_dir", f"{tmp}/erwin"]
        print(f"phase 13d: erwin_baseline {' '.join(argv)}", flush=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = erwin_baseline.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        gate = eb.eligible(2048, 128, 8, 128, 512)
        print(f"  {secs:.1f} s; launches {counts}; 0 Erwin launches as the "
              f"gate routes it: the fused block takes clouds of at most 512 "
              f"points (eligible(2048, C 128) = {gate}), the baseline's one "
              f"cloud holds the sample's padded points (2048 here, 32768 "
              f"for a ShapeNet-Car sample); plain routes "
              f"{plain_route_counts()}", flush=True)
        check(all(np.isfinite(metrics[k]) for k in ("rel_l2_press",
                                                    "rel_l2_velo")),
              f"erwin_baseline metrics {metrics}")
        check(not gate and counts["fused_erwin_block"] == 0
              and counts["fused_erwin_block_bwd"] == 0,
              f"erwin_baseline launched Erwin kernels: {counts}")
        res["erwin_baseline"] = {"seconds": secs, "launches": counts,
                                 **{k: metrics[k] for k in (
                                     "rel_l2_press", "rel_l2_velo")}}
    print("phase 13d: the Erwin baseline at full size", flush=True)
    res["erwin_baseline_full"] = baseline_full_step(dev)
    torch.cuda.empty_cache()
    return res


def morton_phase(dev):
    """13e: the car preset with ``grouping="morton"`` (both kernel flags,
    seeded weights) against the same weights on the plain path: the eval
    forward on a 32186-point sample within ``SERVE_RTOL``, 2 + 2 + 24
    launches."""
    import dataclasses

    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)
    from haet_torch.utils.config import shapenet_car_config

    cfg = dataclasses.replace(shapenet_car_config(), grouping="morton")
    fast = build_model(cfg, dev, seed=SEED).eval()
    plain = cfg.build(dev, seed=SEED).eval()
    g = torch.Generator().manual_seed(SEED + 5)
    x = torch.randn(1, N_POINTS, 7, generator=g).to(dev)
    with torch.inference_mode():
        reset_launch_counts()
        got = fast(x, None)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = plain(x, None)
    print("phase 13e: the car preset with grouping='morton'", flush=True)
    err = compare("morton forward vs plain", got, want, SERVE_RTOL)
    expect_counts("launches of one morton forward", counts,
                  {"slice_states": 2, "deslice": 2, "fused_erwin_block": 24,
                   "slice_states_bwd": 0, "deslice_bwd": 0,
                   "fused_erwin_block_bwd": 0, "copy_scale": 0})
    check(all(v == 0 for v in plain_route_counts().values()),
          f"morton: plain routes {plain_route_counts()}")
    return {"max_abs_err": err}


def rollout_phase(dev):
    """Phase 13: 13a-13e. Returns ``(records, summary)``; the records'
    ``launches`` are 13b's counts of one checkpointed eager step."""
    t0 = time.perf_counter()
    marks = [t0]

    def lap():
        marks.append(time.perf_counter())

    records, plas = ns_kernel_phase(dev)
    lap()
    step_counts, ns = ns_step_phase(dev)
    for r in records:
        r["launches"] = step_counts[r["name"].removesuffix("_ns")]
    lap()
    micro = micro_rollout_phase(dev)
    lap()
    drivers = ns_drivers_phase(dev)
    lap()
    morton = morton_phase(dev)
    lap()
    secs = marks[-1] - t0
    parts = {f"13{c}": b - a for c, a, b in zip("abcde", marks, marks[1:])}
    print(f"phase 13: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")", flush=True)
    return records, {"plasticity_erwin": plas, "ns": ns,
                     "micro_rollout": micro, "drivers": drivers,
                     "morton": morton, "seconds": secs,
                     "sub_phase_seconds": parts}


# ---------------------------------------------------------------------------
# Phase 14: use_pallas="auto", the sweeps, the utils and the native readers.
# ---------------------------------------------------------------------------

#: 14b's points per sample and rounds (the A/B at the largest)
MFU_NS = (32768, 262144)
MFU_ROUNDS = 2
#: 14c's batch and the accumulation steps of its two probes
ACCUM_BATCH = 8
ACCUM_STEPS = (1, 8)
#: 14d's captured weights against the plain formula, and their sums over
#: the points against 1 (float32 softmax over 32186 points)
VIZ_ATOL = 1e-6
VIZ_SUM_ATOL = 1e-5
#: 14a's gradients of the auto model against the explicit model's: the
#: same computation, so equal but for any non-deterministic reduction
AUTO_GRAD_RTOL = 1e-6
NO_LAUNCH = {"slice_states": 0, "deslice": 0, "fused_erwin_block": 0,
             "slice_states_bwd": 0, "deslice_bwd": 0,
             "fused_erwin_block_bwd": 0, "copy_scale": 0}


def auto_threshold() -> int:
    """The car preset's ``use_pallas="auto"`` threshold: at its G 32 the
    rule's G scale is 1, so the config's base."""
    from haet_torch.utils.config import shapenet_car_config

    return shapenet_car_config().pallas_auto_threshold


def auto_phase(dev) -> dict:
    """14a: the car preset (float32, the Erwin kernel flag off as the
    preset sets it) with ``use_pallas="auto"``, against the explicit
    ``False`` and ``True`` models of the same weights, one N below the
    threshold and one at it: an eval forward, then a forward and backward
    of a scalar loss. Launches per the counters, outputs and gradients
    equal bit for bit (gradients within ``AUTO_GRAD_RTOL`` of each leaf's
    max, printed: whether bit-identical)."""
    import dataclasses

    import torch

    from haet_torch.ops.kernels import launch_counts, reset_launch_counts
    from haet_torch.utils.config import shapenet_car_config

    thr = auto_threshold()
    base = shapenet_car_config()
    models = {flag: dataclasses.replace(base, use_pallas=flag).build(
        dev, seed=SEED).eval() for flag in ("auto", False, True)}
    out = {"threshold": thr}
    for n, kernels in ((max(thr // 2, 1), False), (thr, True)):
        g = torch.Generator().manual_seed(SEED + n)
        x = torch.randn(1, n, 7, generator=g).to(dev)
        want_fwd = {**NO_LAUNCH, "slice_states": 2 * kernels,
                    "deslice": 2 * kernels}
        want_bwd = {**want_fwd, "slice_states_bwd": 2 * kernels,
                    "deslice_bwd": 2 * kernels}
        res = {}
        for flag, m in models.items():
            with torch.no_grad():
                reset_launch_counts()
                fwd = m(x, None)
                torch.cuda.synchronize()
                fwd_counts = launch_counts()
            m.zero_grad(set_to_none=True)
            reset_launch_counts()
            loss = (m(x, None) ** 2).mean()
            loss.backward()
            torch.cuda.synchronize()
            res[flag] = (fwd, fwd_counts, launch_counts(), {
                k: p.grad.clone() for k, p in m.named_parameters()
                if p.grad is not None})
        ref = res[kernels]
        fwd, fwd_counts, bwd_counts, grads = res["auto"]
        side = "at" if kernels else "below"
        expect_counts(f"auto forward at N {n} ({side} {thr})", fwd_counts,
                      want_fwd)
        expect_counts(f"auto forward+backward at N {n}", bwd_counts,
                      want_bwd)
        check(torch.equal(fwd, ref[0]),
              f"auto forward at N {n} differs from use_pallas={kernels}")
        check(sorted(grads) == sorted(ref[3]),
              f"auto's gradient leaves at N {n}: {sorted(grads)}")
        gerr = max(float((v - ref[3][k]).abs().max())
                   / max(float(ref[3][k].abs().max()), 1e-30)
                   for k, v in grads.items())
        same = all(torch.equal(v, ref[3][k]) for k, v in grads.items())
        print(f"  N {n}: the forward equals use_pallas={kernels}'s bit for "
              f"bit; {len(grads)} gradients bit-identical: {same} (max "
              f"relative difference {gerr:.3e}, tol {AUTO_GRAD_RTOL})",
              flush=True)
        check(gerr <= AUTO_GRAD_RTOL,
              f"auto gradients at N {n} differ from use_pallas={kernels}")
        out[f"n_{side}"] = n
    return out


def mfu_phase(dev) -> dict:
    """14b: ``mfu_sweep --ns 32768 262144 --rounds 2`` with its A/B at
    262144, in this process: every row finite; the A/B row's auto
    resolution as the model's attention resolves it."""
    from haet_torch.benchmarks import mfu_sweep

    rows = mfu_sweep.run(MFU_NS, rounds=MFU_ROUNDS, pallas_ab=True,
                         device=dev, emit=lambda r: print(
                             f"  {json.dumps(r)}", flush=True))
    check(len(rows) == len(MFU_NS) + 1, f"mfu_sweep rows: {rows}")
    for r in rows[:-1]:
        check(r["platform"] == "gpu" and r["sec_per_step"] > 0
              and r["mfu"] and np.isfinite(r["mfu"]), f"mfu row {r}")
    ab = rows[-1]
    check(ab["sec_per_step_xla"] > 0 and ab["sec_per_step_pallas_fused"] > 0,
          f"mfu A/B row {ab}")
    check(ab["auto_resolves_to"] == (
        "pallas" if max(MFU_NS) >= auto_threshold() else "xla"),
        f"auto at {max(MFU_NS)}: {ab['auto_resolves_to']}")
    return {"rows": rows}


def accum_phase() -> dict:
    """14c: one ``accum_mem_probe`` probe each at ``accum_steps`` 1 and 8,
    batch 8, past the auto threshold, each in a fresh process (both at
    once: each reads its own allocator's peak): accum 8's peak below
    accum 1's."""
    from concurrent.futures import ThreadPoolExecutor

    from haet_torch.benchmarks.accum_mem_probe import accum_probe_subprocess

    n = max(auto_threshold(), 65536)
    with ThreadPoolExecutor(len(ACCUM_STEPS)) as pool:
        futs = {a: pool.submit(accum_probe_subprocess, n, ACCUM_BATCH, a)
                for a in ACCUM_STEPS}
        recs = {a: f.result() for a, f in futs.items()}
    for a, r in recs.items():
        print(f"  accum {a}: {json.dumps(r)}", flush=True)
        check(r.get("ok") is True, f"accum probe {a} failed: {r}")
    lo, hi = (recs[a]["peak_memory_mb"] for a in ACCUM_STEPS)
    check(hi < lo, f"accum {ACCUM_STEPS[1]} peak {hi} MiB is not below "
          f"accum {ACCUM_STEPS[0]}'s {lo} MiB")
    return {"num_points": n, "batch": ACCUM_BATCH,
            "peak_memory_mb": {str(a): recs[a]["peak_memory_mb"]
                               for a in ACCUM_STEPS}}


def viz_phase(dev) -> dict:
    """14d: ``get_slice_weights`` on the car preset at full width (32186
    points, both kernel flags): the last block's capture against the plain
    formula on that block's own input (a forward hook), block 0's against
    the plain model's capture of the same weights, each within
    ``VIZ_ATOL``; every slice's weights summing to 1 over the points
    within ``VIZ_SUM_ATOL``; the capturing forward's output equal to an
    ordinary forward's; 2 + 2 + 24 launches for a forward with and
    without the capture."""
    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.ops.kernels import launch_counts, reset_launch_counts
    from haet_torch.utils.config import shapenet_car_config
    from haet_torch.utils.visualization import get_slice_weights

    cfg = shapenet_car_config()
    fast = build_model(cfg, dev, seed=SEED).eval()
    plain = cfg.build(dev, seed=SEED).eval()
    g = torch.Generator().manual_seed(SEED + 14)
    x = torch.randn(1, N_POINTS, 7, generator=g).to(dev)
    per_fwd = {**NO_LAUNCH, "slice_states": 2, "deslice": 2,
               "fused_erwin_block": 24}
    with torch.no_grad():
        reset_launch_counts()
        want_out = fast(x, None)
        torch.cuda.synchronize()
    expect_counts("a forward without capture", launch_counts(), per_fwd)
    seen = {}
    attn = fast.blocks[-1].Attn
    hooks = [attn.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("x", args[0].detach())),
        fast.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("out", out.detach()))]
    try:
        reset_launch_counts()
        w_last = get_slice_weights(fast, x, None)
        torch.cuda.synchronize()
        counts = launch_counts()
        w_first = get_slice_weights(fast, x, None, block=0)
    finally:
        for h in hooks:
            h.remove()
    expect_counts("the capturing forward", counts, per_fwd)
    check(torch.equal(seen["out"], want_out),
          "the capture changed the forward's output")
    with torch.no_grad():
        ref_last = attn.plain_slice_weights(
            attn._project(seen["x"]).contiguous()).cpu().numpy()
    ref_first = get_slice_weights(plain, x, None, block=0)
    errs = {"last": float(np.abs(w_last - ref_last).max()),
            "first": float(np.abs(w_first - ref_first).max())}
    sums = float(max(np.abs(w.sum(axis=2) - 1).max()
                     for w in (w_last, w_first)))
    print(f"  weights {w_last.shape}: against the plain formula, max abs "
          f"err last block {errs['last']:.3e}, block 0 {errs['first']:.3e} "
          f"(tol {VIZ_ATOL}); max |sum_n w - 1| {sums:.3e} "
          f"(tol {VIZ_SUM_ATOL})", flush=True)
    check(all(e <= VIZ_ATOL for e in errs.values()), f"capture: {errs}")
    check(sums <= VIZ_SUM_ATOL, f"slice weights sum to 1 within {sums}")
    return {"max_abs_err": errs, "max_sum_err": sums}


def car_fixture_layout(root: str) -> str:
    """A 2-fold miniature of the reference's ShapeNet-Car layout from the
    committed fixture pair (``param0``: 1 sample, ``param1``: 2)."""
    src = ROOT / "tests" / "fixtures" / "data" / "car" / "param0" / \
        "fixturecar000"
    for fold, names in (("param0", ("car_a",)), ("param1", ("car_b",
                                                            "car_c"))):
        for name in names:
            shutil.copytree(src, f"{root}/{fold}/{name}")
    return root


def import_phase(run_dir: str) -> dict:
    """14e: phase 8b's ``last`` weights written as a reference-format
    ``.pt`` (``{"epoch", "model_state_dict", "val_loss"}``), then ``car_eval
    --torch_checkpoint`` on the fixture fold against ``car_eval`` of the
    same checkpoint loaded directly: equal metrics."""
    import tempfile

    import torch

    from haet_torch.benchmarks import car_eval
    from haet_torch.train import Checkpointer
    from haet_torch.utils.torch_import import to_torch_state_dict

    tmp = tempfile.mkdtemp(prefix="haet_import_")
    try:
        data = car_fixture_layout(f"{tmp}/training_data")
        ckpt = f"{run_dir}/checkpoints/car"
        state = Checkpointer(ckpt).restore("last", map_location="cpu")
        check(state is not None, f"no checkpoint at {ckpt}")
        sd = to_torch_state_dict(state["model"])
        pt = f"{tmp}/reference.pt"
        torch.save({"epoch": 2, "model_state_dict": {
            k: torch.from_numpy(v) for k, v in sd.items()},
            "val_loss": np.float64(0.0)}, pt)
        common = ["--data_dir", data, "--out_dir", f"{tmp}/out"]
        got = car_eval.main(common + ["--torch_checkpoint", pt])
        want = car_eval.main(common + ["--checkpoint_dir", ckpt, "--which",
                                       "last"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = {k: (v == want[k]) or (np.isnan(v) and np.isnan(want[k]))
            for k, v in got.items() if k != "time_per_sample"}
    print(f"  {len(sd)} reference keys; car_eval --torch_checkpoint {got}; "
          f"direct {want}", flush=True)
    check(sorted(got) == sorted(want) and all(same.values()),
          f"imported metrics differ: {same}")
    # NaN (Spearman's rho of the one validation sample) as null: the
    # result line stays JSON
    return {"keys": len(sd), "metrics": {
        k: None if np.isnan(v) else v for k, v in got.items()}}


def native_phase(dev) -> dict:
    """14f: the native VTK reader (``use_native=True``: a failed build
    raises) against the numpy parser on both car fixture files, and the
    native ball tree's balls at every level against ``ball_groups``'
    on-device median split of a car sample's first 16384 points (the
    largest power of two it holds)."""
    import math

    import torch

    from haet_torch import native
    from haet_torch.data import synthetic
    from haet_torch.data.vtk_io import read_vtk_legacy
    from haet_torch.ops.ball_groups import median_split_perm

    fixture = ROOT / "tests" / "fixtures" / "data" / "car" / "param0" / \
        "fixturecar000"
    files = sorted(fixture.glob("*.vtk"))
    check(len(files) == 2, f"car fixture files: {files}")
    for f in files:
        nat = read_vtk_legacy(str(f), use_native=True)
        npy = read_vtk_legacy(str(f), use_native=False)
        check(np.array_equal(nat.points, npy.points)
              and np.array_equal(nat.quads, npy.quads)
              and sorted(nat.point_data) == sorted(npy.point_data)
              and all(np.array_equal(v, nat.point_data[k])
                      for k, v in npy.point_data.items()),
              f"native VTK read of {f.name} differs from numpy's")
    pos = synthetic.car_like(n=1, npts=N_POINTS, seed=0)[0]["pos"]
    n = 1 << int(math.log2(len(pos)))      # 16384 of the car's 17607
    p = np.ascontiguousarray(pos[:n], np.float32)
    idx, _ = native.build_balltree(p, np.zeros(n, np.int64))
    levels = int(math.log2(n)) - 1
    perm = median_split_perm(torch.from_numpy(p[None]).to(dev),
                             levels)[0].cpu().numpy()
    for lvl in range(levels + 1):
        seg = n >> lvl
        a = {frozenset(idx[i:i + seg].tolist()) for i in range(0, n, seg)}
        b = {frozenset(perm[i:i + seg].tolist()) for i in range(0, n, seg)}
        check(a == b, f"ball tree balls of {seg} differ from ball_groups'")
    print(f"  native VTK reads of {[f.name for f in files]} equal numpy's; "
          f"ball tree of {n} points: the same balls as ball_groups at all "
          f"{levels + 1} levels; libraries "
          f"{[native.library_path(k).name for k in native.LIBS]}",
          flush=True)
    return {"vtk_files": len(files), "balltree_points": n,
            "levels": levels + 1}


def utils_phase(dev, run_dir) -> dict:
    """Phase 14: 14a-14f, each part's seconds printed."""
    from haet_torch import native

    t0 = time.perf_counter()
    marks = [t0]
    for name in native.LIBS:     # a failed g++ build raises here
        native.build(name)
    out = {}
    for part, what, fn in (
            ("14a", "use_pallas='auto' below and at its threshold",
             lambda: auto_phase(dev)),
            ("14b", "mfu_sweep", lambda: mfu_phase(dev)),
            ("14c", "accum_mem_probe at accum 1 and 8", accum_phase),
            ("14d", "get_slice_weights on the car preset",
             lambda: viz_phase(dev)),
            ("14e", "car_eval --torch_checkpoint",
             lambda: import_phase(run_dir)),
            ("14f", "the native VTK reader and ball tree",
             lambda: native_phase(dev))):
        print(f"phase {part}: {what}", flush=True)
        out[part] = fn()
        marks.append(time.perf_counter())
    parts = {p: b - a for p, a, b in zip(out, marks, marks[1:])}
    secs = marks[-1] - t0
    print(f"phase 14: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")", flush=True)
    return {**out, "seconds": secs, "sub_phase_seconds": parts}


# ---------------------------------------------------------------------------
# Phase 15: data and head tensor parallelism on the card.
# ---------------------------------------------------------------------------

#: 15a's graphed steps, meshed and not
MESH_STEPS = 3
#: 15b's eager steps on each mesh of the two gloo ranks
GLOO_STEPS = 2
#: 15b's losses and gradient norms against the one-rank run on the card:
#: the same float32 kernels on the same rows, the BatchNorm statistics and
#: the gradients summed over the ranks in another order (the CPU tests of
#: the same meshes measure ~1e-6)
GLOO_RTOL = 1e-5
#: 15b's first step's gradient (summed over the ranks, then clipped)
#: against the one-rank run's, leaf by leaf: within GLOO_GRAD_RTOL of each
#: entry, plus 1e-5 of the leaf's largest |entry| or 1e-6 of the whole
#: gradient's, whichever is larger (the CPU tests' mesh tolerance, with
#: rtol 1e-4 for float32 sums over 32186 points in another order). A
#: missing or doubled reduction moves a leaf by the order of itself.
GLOO_GRAD_RTOL = 1e-4
#: 15b's meshes: (dp, tp) and the batch's samples (all N_POINTS long)
GLOO_MESHES = {"dp2": ((2, 1), 2), "tp2": ((1, 2), 1)}
#: the collectives of the port (all_reduce with SUM and MAX, all_gather,
#: broadcast), which 15b checks gloo carries on CUDA tensors
GLOO_PROBES = ("all_reduce_sum", "all_reduce_max", "all_gather",
               "broadcast")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_car(dev, bf16: bool, shard: bool, seed: int = SEED):
    """The car preset at full width with both kernel flags (``shard``:
    with ``shard_axes=("dp", "tp")``) and its training config."""
    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.utils.config import (shapenet_car_config,
                                         shapenet_car_train_config)

    cfg = shapenet_car_config()
    cfg.bf16 = bf16
    cfg.shard_axes = ("dp", "tp") if shard else None
    train = shapenet_car_train_config()
    train.mu_bf16 = bf16
    return build_model(cfg, dev, seed=seed), train


def collective_share(trainer, batch) -> dict:
    """One replay of ``trainer``'s step traced on the card: the NCCL
    kernels' names, count and device time, against the step's."""
    import torch

    from haet_torch.utils.profiling import device_trace

    with device_trace(host=False) as prof:
        trainer.train_step(batch)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    nccl = [e for e in dev_events if "nccl" in e.name.lower()]
    ms = sum(e.time_range.elapsed_us() for e in nccl) / 1e3
    return {"names": sorted({e.name for e in nccl}), "count": len(nccl),
            "nccl_ms": ms, "device_ms": total, "share": ms / total}


def step_walls(trainers: dict, batch, steps: int = WALL_STEPS) -> dict:
    """``{name: [ms of each step]}``: ``steps`` steps of each trainer, in
    turns (a, b, b, a, ...), so that a drift of the host's speed falls on
    both."""
    import torch

    walls = {name: [] for name in trainers}
    order = list(trainers)
    for i in range(steps):
        for name in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainers[name].train_step(batch)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return walls


def nccl_world_of_one(dev) -> dict:
    """15a: the script's own process joins a world of one over NCCL
    (``init_distributed`` from the ``HAET_*`` variables) and trains the car
    preset in bf16 over a (1, 1) mesh, ``shard_axes`` set, against the
    same steps without a mesh: every step's metrics and the whole state
    bit for bit, the counters at 2 + 2 + 24 forward and backward launches
    per step of the capture, NCCL kernels inside the replayed graph."""
    import os

    import torch
    import torch.distributed as dist

    from haet_torch import parallel
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)
    from haet_torch.train import Trainer
    from haet_torch.train.car import loss_fn_builder
    from haet_torch.train.graphs import WARMUP

    os.environ.update(HAET_COORDINATOR=f"127.0.0.1:{free_port()}",
                      HAET_NUM_PROCESSES="1", HAET_PROCESS_ID="0")
    check(not parallel.init_distributed(), "a world of one is multi-process")
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    mesh = parallel.make_mesh(1, 1)
    batches = graph_batches(N_POINTS, range(SEED + 50, SEED + 50
                                            + MESH_STEPS))
    trainers = {}
    for name, m in (("meshed", mesh), ("plain", None)):
        model, cfg = mesh_car(dev, bf16=True, shard=m is not None)
        trainers[name] = Trainer(model, loss_fn_builder(0.5), cfg,
                                 total_steps=4 * MESH_STEPS,
                                 batch_args=lambda b: (b["x"], None),
                                 mesh=m)
    meshed, plain = trainers["meshed"], trainers["plain"]
    check(meshed.graphs is not None, "the meshed trainer does not graph")
    print(f"phase 15a: {MESH_STEPS} graphed bf16 steps over {mesh}, "
          f"against the same steps without a mesh", flush=True)
    hold_states("15a: initial state", meshed, plain)
    calls = []
    reset_launch_counts()
    for i, b in enumerate(batches):
        with logged_collectives(calls):
            mm = meshed.train_step(b)
        counts = launch_counts() if i == 0 else counts
        mp_ = plain.train_step(b)
        same = all(torch.equal(mm[k], mp_[k]) for k in mp_)
        print(f"  step {i + 1}: loss meshed {float(mm['loss']):.8f} plain "
              f"{float(mp_['loss']):.8f}; bit-identical {same}", flush=True)
        check(same, f"15a step {i + 1}: the meshed step differs")
    check(hold_states(f"15a: state after {MESH_STEPS} steps", meshed,
                      plain), "15a: the meshed state is not bit-identical")
    expect_counts(f"15a launches (the capture's {WARMUP} warm-up steps and "
                  f"itself; a replay counts none)", counts,
                  expected_launches(WARMUP + 1, 0))
    check(all(v == 0 for v in plain_route_counts().values()),
          f"plain routes {plain_route_counts()}")
    # the capture's step: 2 min/max all-reduces (one a block), the output
    # gather and the gradient all-reduce, each an NCCL call in the graph
    captured = [c[0] for c in calls if c[1]]
    per_body = {"all_reduce": 3, "all_gather": 1}
    got = {k: captured.count(k) for k in per_body}
    expect_counts("15a NCCL calls captured in the graph", got, per_body)
    check(len(calls) == (WARMUP + 1) * sum(per_body.values()),
          f"15a: {len(calls)} collective calls in the warm-up and capture")
    replay = replay_calls("15a kernel calls in one meshed replay",
                          meshed.train_step, batches[0])
    share = collective_share(meshed, batches[0])
    print(f"  NCCL kernels in one replay: {share['count']} "
          f"({share['names']}), {share['nccl_ms']:.3f} ms of "
          f"{share['device_ms']:.3f} ms device time (share "
          f"{share['share']:.4f}); a world of one has NCCL elide an "
          f"in-place all-reduce and copy an all-gather on the device",
          flush=True)
    walls = {}
    for name, w in step_walls(trainers, batches[0]).items():
        walls[name] = {"wall_ms": float(np.median(w)), "min_ms": min(w)}
        print(f"  {name} graphed step: wall median "
              f"{walls[name]['wall_ms']:.3f} ms (min {min(w):.3f}) of "
              f"{len(w)}, in turns with the other", flush=True)
    del trainers, meshed, plain
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"launches": counts, "replay_calls": replay["calls"],
            "replay_device_ms": replay["device_ms"], "nccl": share,
            "captured_calls": got, "walls": walls}


def gloo_probe(dev) -> dict:
    """Which collectives gloo carries for CUDA tensors: each run once on
    the world of two ranks, ``"ok"`` or its error."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    t = torch.full((4,), float(rank + 1), device=dev)
    calls = {
        "all_reduce_sum": lambda: dist.all_reduce(t.clone()),
        "all_reduce_max": lambda: dist.all_reduce(
            t.clone(), op=dist.ReduceOp.MAX),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(2)], t),
        "broadcast": lambda: dist.broadcast(t.clone(), src=0),
    }
    out = {}
    for name in GLOO_PROBES:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:
            out[name] = f"refused: {str(e).splitlines()[0][:120]}"
    dist.barrier()
    return out


def mesh_batch(samples: int) -> dict:
    """``samples`` car-like samples of exactly N_POINTS points (no bucket
    padding: the kernels see ``[.., N_POINTS, 32]``), as one batch."""
    from haet_torch.data.shapenet_car import CarSample
    from haet_torch.train.car import make_batch

    parts = []
    for i in range(samples):
        rng = np.random.RandomState(SEED + 60 + i)
        x = rng.randn(N_POINTS, 7).astype(np.float32)
        y = rng.randn(N_POINTS, 4).astype(np.float32)
        surf = np.zeros(N_POINTS, bool)
        surf[-N_SURFACE:] = True
        parts.append(make_batch(CarSample(x[:, :3], x, y, surf),
                                n_pad=N_POINTS))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class _Shapes:
    """Records the leading shape a kernel wrapper is called with."""

    def __init__(self, fn, seen: list):
        self.fn, self.seen = fn, seen

    def __call__(self, x, *a, **k):
        self.seen.append(tuple(x.shape))
        return self.fn(x, *a, **k)


class _Calls:
    """A ``torch.distributed`` collective that records each call: its name,
    whether the current stream was capturing a CUDA graph, and its host
    seconds (gloo's calls on CUDA tensors return when the work is done)."""

    def __init__(self, fn, log: list):
        self.fn, self.log = fn, log

    def __call__(self, *a, **k):
        import torch

        capturing = (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **k)
        finally:
            self.log.append((self.fn.__name__, capturing,
                             time.perf_counter() - t0))


@contextmanager
def logged_collectives(log: list):
    """``all_reduce``, ``all_gather`` and ``broadcast`` of
    ``torch.distributed`` recorded into ``log`` (:class:`_Calls`)."""
    import torch.distributed as dist

    saved = dist.all_reduce, dist.all_gather, dist.broadcast
    dist.all_reduce, dist.all_gather, dist.broadcast = (
        _Calls(f, log) for f in saved)
    try:
        yield log
    finally:
        dist.all_reduce, dist.all_gather, dist.broadcast = saved


def mesh_steps(trainer, batch, steps: int) -> dict:
    """``steps`` eager steps: losses, gradient norms, walls, launch counts,
    the shapes the slice and Erwin kernels ran at, the first step's
    gradient by parameter name (on the host: what Adam took, summed over
    the mesh and clipped), and the host milliseconds per step spent in
    collectives (:func:`logged_collectives`)."""
    import torch

    from haet_torch.models import erwin as merwin
    from haet_torch.models import physics_attention as mpa
    from haet_torch.ops.kernels import launch_counts, reset_launch_counts

    slices, blocks, coll = [], [], []
    saved = mpa.sk.slice_states, merwin.fused_erwin_block
    mpa.sk.slice_states = _Shapes(saved[0], slices)
    merwin.fused_erwin_block = _Shapes(saved[1], blocks)
    out = {"loss": [], "grad_norm": [], "walls_ms": [], "collective_ms": []}
    try:
        with logged_collectives(coll):
            reset_launch_counts()
            for i in range(steps):
                first = len(coll)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.train_step(batch)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                out["walls_ms"].append((time.perf_counter() - t0) * 1e3)
                out["collective_ms"].append(
                    sum(c[2] for c in coll[first:]) * 1e3)
                if i == 0:
                    # the gradients are views of the trainer's flat buffer,
                    # which the next step overwrites
                    names = {id(p): k for k, p in
                             trainer.model.named_parameters()}
                    out["grad"] = {names[id(p)]: p.grad.float().cpu().numpy()
                                   for p in trainer._grad_params}
            out["launches"] = launch_counts()
    finally:
        mpa.sk.slice_states, merwin.fused_erwin_block = saved
    out["collectives"] = len(coll) // steps
    out["slice_shapes"] = sorted(set(slices))
    out["erwin_clouds"] = sorted({s[0] for s in blocks})
    return out


def grad_errors(got: dict, ref: dict) -> dict:
    """``{leaf: max |got - ref| over its allowance}`` (:data:`GLOO_GRAD_RTOL`):
    a value above 1 fails."""
    whole = max(float(np.abs(v).max()) for v in ref.values())
    out = {}
    for k, w in ref.items():
        allow = (GLOO_GRAD_RTOL * np.abs(w)
                 + max(1e-5 * float(np.abs(w).max()), 1e-6 * whole))
        out[k] = float((np.abs(got[k] - w) / allow).max())
    return out


def gloo_rank_main(rank: int, port: int, queue) -> None:
    """One of 15b's two ranks on the one card: joins the gloo group,
    probes its collectives on CUDA tensors, then trains the float32 car
    preset for ``GLOO_STEPS`` eager steps on each mesh of ``GLOO_MESHES``;
    puts ``(rank, results)`` on ``queue``."""
    import torch

    from haet_torch import parallel
    from haet_torch.train import Trainer
    from haet_torch.train.car import loss_fn_builder
    from haet_torch.utils.env import default_device

    try:
        dev = default_device(None)
        parallel.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                  backend="gloo")
        out = {"probe": gloo_probe(dev)}
        for name, ((n_dp, n_tp), samples) in GLOO_MESHES.items():
            mesh = parallel.make_mesh(n_dp, n_tp)
            model, cfg = mesh_car(dev, bf16=False, shard=True)
            trainer = Trainer(model, loss_fn_builder(0.5), cfg,
                              total_steps=4 * GLOO_STEPS,
                              batch_args=lambda b: (b["x"], None),
                              mesh=mesh, eager=True)
            out[name] = mesh_steps(trainer, mesh_batch(samples), GLOO_STEPS)
            del trainer, model
            torch.cuda.empty_cache()
        queue.put((rank, out))
    except Exception:
        import traceback

        queue.put((rank, {"error": traceback.format_exc()}))


def gloo_two_ranks(dev) -> dict:
    """15b: two ranks on the one card over gloo (NCCL refuses two ranks on
    one device), dp 2 (batch 2) and tp 2 (4 heads a rank), two eager steps
    each, against one rank of the same batches and weights in this
    process."""
    import multiprocessing

    import torch

    from haet_torch.train import Trainer
    from haet_torch.train.car import loss_fn_builder

    print(f"phase 15b: two gloo ranks on the card, {list(GLOO_MESHES)}, "
          f"{GLOO_STEPS} eager float32 steps each", flush=True)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=gloo_rank_main, args=(r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        ranks = dict(queue.get(timeout=400) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, res in sorted(ranks.items()):
        check("error" not in res, f"15b rank {r}:\n{res.get('error')}")
    probe = ranks[0]["probe"]
    print(f"  gloo on CUDA tensors (torch {torch.__version__}): {probe}",
          flush=True)
    for name in GLOO_PROBES:
        check(probe[name] == "ok", f"gloo refuses {name} on CUDA tensors")
    out = {"probe": probe}
    want_shapes = {"dp2": [(1, 8, N_POINTS, 32)],
                   "tp2": [(1, 4, N_POINTS, 32)]}
    want_clouds = {"dp2": 8, "tp2": 4}
    for name, ((n_dp, n_tp), samples) in GLOO_MESHES.items():
        batch = mesh_batch(samples)
        model, cfg = mesh_car(dev, bf16=False, shard=False)
        ref = mesh_steps(Trainer(model, loss_fn_builder(0.5), cfg,
                                 total_steps=4 * GLOO_STEPS,
                                 batch_args=lambda b: (b["x"], None),
                                 eager=True), batch, GLOO_STEPS)
        del model
        rows = []
        for r in (0, 1):
            got = ranks[r][name]
            expect_counts(f"15b {name} rank {r} launches ({GLOO_STEPS} eager "
                          f"steps)", got["launches"],
                          expected_launches(GLOO_STEPS, 0))
            check(got["slice_shapes"] == want_shapes[name],
                  f"15b {name} rank {r}: slice shapes {got['slice_shapes']}")
            check(got["erwin_clouds"] == [want_clouds[name]],
                  f"15b {name} rank {r}: Erwin clouds {got['erwin_clouds']}")
            for k in ("loss", "grad_norm"):
                err = max(abs(a - b) / abs(b) for a, b in
                          zip(got[k], ref[k]))
                check(err <= GLOO_RTOL,
                      f"15b {name} rank {r} {k}: {got[k]} vs {ref[k]}")
            check(set(got["grad"]) == set(ref["grad"]),
                  f"15b {name} rank {r}: other parameters have gradients")
            errs = grad_errors(got["grad"], ref["grad"])
            worst = max(errs, key=errs.get)
            check(errs[worst] <= 1.0,
                  f"15b {name} rank {r}: the first step's gradient of "
                  f"{worst} differs by {errs[worst]:.3g}x its allowance")
            rows.append(errs[worst])
            print(f"  {name} rank {r}: losses {got['loss']} (one rank "
                  f"{ref['loss']}), grad norms {got['grad_norm']}; slice "
                  f"kernels at {got['slice_shapes']}, Erwin over "
                  f"{got['erwin_clouds']} clouds; first step's gradient, "
                  f"{len(errs)} leaves, at most {errs[worst]:.3g}x the "
                  f"allowance ({worst}); eager step walls "
                  f"{[round(w, 3) for w in got['walls_ms']]} ms (one rank "
                  f"{[round(w, 3) for w in ref['walls_ms']]}); "
                  f"{got['collectives']} collectives per step, host ms in "
                  f"them {[round(c, 3) for c in got['collective_ms']]}",
                  flush=True)
        for r in (0, 1):
            check(ranks[r][name]["loss"] == ranks[0][name]["loss"],
                  f"15b {name}: the ranks' losses differ")
        out[name] = {"walls_ms": [ranks[r][name]["walls_ms"] for r in (0, 1)],
                     "one_rank_walls_ms": ref["walls_ms"],
                     "collective_ms": [ranks[r][name]["collective_ms"]
                                       for r in (0, 1)],
                     "one_rank_collective_ms": ref["collective_ms"],
                     "loss": ranks[0][name]["loss"], "one_rank_loss":
                     ref["loss"], "grad_err_of_allowance": max(rows),
                     "launches": ranks[0][name]["launches"]}
    torch.cuda.empty_cache()
    return out


def mesh_phase(dev, f32_walls, bf16) -> dict:
    """Phase 15: 15a (a world of one over NCCL, graphed), 15b (two gloo
    ranks on the card), 15c (the walls beside phases 9 and 10, printed)."""
    t0 = time.perf_counter()
    out = {"15a": nccl_world_of_one(dev)}
    t_a = time.perf_counter() - t0
    out["15b"] = gloo_two_ranks(dev)
    t_b = time.perf_counter() - t0 - t_a
    a = out["15a"]["walls"]
    print(f"phase 15c: the graphed bf16 step meshed "
          f"{a['meshed']['wall_ms']:.3f} ms, unmeshed {a['plain']['wall_ms']:.3f} ms (phase 10c "
          f"{bf16['graphs']['graphed']['wall_ms']:.3f} ms, phase 9e float32 "
          f"{f32_walls['graphed']['wall_ms']:.3f} ms); NCCL's share of the "
          f"meshed replay's device time {out['15a']['nccl']['share']:.4f}",
          flush=True)
    for k, v in out["15b"].items():
        if k == "probe":
            continue
        # the last step: the first pays each rank's warm-up
        walls = [w[-1] for w in v["walls_ms"]]
        coll = [c[-1] for c in v["collective_ms"]]
        v["last_step"] = {"walls_ms": walls, "collective_ms": coll,
                          "share": [c / w for c, w in zip(coll, walls)],
                          "one_rank_ms": v["one_rank_walls_ms"][-1]}
        print(f"  15b {k}, step {GLOO_STEPS} per rank: wall "
              f"{[round(w, 3) for w in walls]} ms (one rank "
              f"{v['one_rank_walls_ms'][-1]:.3f} ms), in gloo's "
              f"collectives {[round(c, 3) for c in coll]} ms (share "
              f"{[round(c / w, 3) for c, w in zip(coll, walls)]})",
              flush=True)
    out["seconds"] = {"15a": t_a, "15b": t_b,
                      "all": time.perf_counter() - t0}
    print(f"phase 15: {out['seconds']['all']:.1f} s (15a {t_a:.1f} s, 15b "
          f"{t_b:.1f} s)", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 16: the GPipe pipeline and serving over a mesh on the card.
# ---------------------------------------------------------------------------

#: 16a's and 16b's steps
PIPE_STEPS = 3
#: 16a's losses against the unpipelined trainer's: the same kernels on the
#: same rows, the gradient norm summed in another order (16b holds its
#: losses to 16a's M 2 run at phase 15's ``GLOO_RTOL``: its eager steps
#: take the whole model's norm over two stages)
PIPE_LOSS_RTOL = 1e-6
#: launches per microbatch of a pipelined car step, remat on: each block's
#: forward kernels again in the backward
PIPE_PER_STEP = {"slice_states": 4, "deslice": 4, "slice_states_bwd": 2,
                 "deslice_bwd": 2, "fused_erwin_block": 48,
                 "fused_erwin_block_bwd": 24, "copy_scale": 0}
#: 16c's presets and the tolerance of their served answers against the
#: single-device programs on the same batch: float32 at phase 15's mesh
#: tolerance (each entry within ``GLOO_RTOL`` of itself plus 1e-6 of the
#: max), which a collective left out would break (a sample's min-max over
#: its rank's rows alone moves the output by ~1e-3 of max); bf16 within
#: one bf16 ulp of the max (``BF16_RTOL``): a bf16 product over another
#: row count or head count rounds differently (~5.8e-3 of max at the
#: dp 2 batch on an H100), which hides the collectives
PIPE_SERVE_DTYPES = {"float32": GLOO_RTOL, "bfloat16": BF16_RTOL}
#: 16d's windows
TAX_ROUNDS = 2


def scaled(counts: dict, k: int) -> dict:
    return {name: v * k for name, v in counts.items()}


def pipe_trainer(dev, mesh, micro, eager=False):
    """The bf16 car preset's trainer, pipelined over ``mesh`` at ``micro``
    microbatches, or (``mesh`` None) unpipelined."""
    from haet_torch.parallel import PipelinedModel
    from haet_torch.train import Trainer
    from haet_torch.train.car import loss_fn_builder

    model, cfg = mesh_car(dev, bf16=True, shard=False)
    if mesh is not None:
        model = PipelinedModel(model, mesh, num_microbatches=micro,
                               dp_axis="dp")
    return Trainer(model, loss_fn_builder(0.5), cfg,
                   total_steps=4 * PIPE_STEPS,
                   batch_args=lambda b: (b["x"], None), mesh=mesh,
                   eager=eager)


def stacked_grads(trainer) -> dict:
    """The first step's gradients (clipped, as Adam took them) by name in
    the stacked layout, every stage's layers gathered, on the host."""
    from haet_torch.parallel.pipeline import pipelines, split_variables

    names = {id(p): k for k, p in trainer.model.named_parameters()}
    # copies: the gradients are views of the buffer the next step writes
    g = {names[id(p)]: p.grad.detach().float().clone()
         for p in trainer._grad_params}
    pipes = pipelines(trainer.model)
    if pipes:
        g = {k: pipes[0].gather_stages(v) if k.startswith("layers.") else v
             for k, v in g.items()}
    else:
        g = split_variables(g, len(trainer.model.blocks))
    return {k: v.cpu().numpy() for k, v in g.items()}


def pipe_steps(trainer, batch, steps: int) -> dict:
    """``steps`` steps: losses, walls, the first step's gradients and the
    launches from the first step on (a graphed trainer: its capture)."""
    import torch

    from haet_torch.ops.kernels import launch_counts, reset_launch_counts

    out = {"loss": [], "walls_ms": []}
    reset_launch_counts()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        out["loss"].append(float(m["loss"]))
        torch.cuda.synchronize()
        out["walls_ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["grad"] = stacked_grads(trainer)
    out["launches"] = launch_counts()
    return out


def hold_pipe(what, got: dict, want: dict,
              loss_rtol: float = PIPE_LOSS_RTOL) -> float:
    """Losses within ``loss_rtol`` and the first step's gradient within
    phase 15's allowance; returns the worst leaf's share of it."""
    for a, b in zip(got["loss"], want["loss"]):
        check(abs(a - b) <= loss_rtol * abs(b),
              f"{what}: losses {got['loss']} vs {want['loss']}")
    check(set(got["grad"]) == set(want["grad"]),
          f"{what}: other parameters have gradients")
    errs = grad_errors(got["grad"], want["grad"])
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1.0, f"{what}: the first step's gradient of "
          f"{worst} differs by {errs[worst]:.3g}x its allowance")
    print(f"  {what}: losses {got['loss']} (reference {want['loss']}); "
          f"first step's gradient, {len(errs)} leaves, at most "
          f"{errs[worst]:.3g}x the allowance ({worst})", flush=True)
    return errs[worst]


def pipe_world_of_one(dev) -> dict:
    """16a: the pipeline at pp 1 in a world of one over NCCL, graphed, at
    M 1 against the unpipelined trainer, and at M 2 on a batch of 2 (16b's
    reference: in bf16 its embedding and head take their parameters'
    gradients over both microbatches at once, rounded once, so it is not
    the unpipelined trainer's ``accum_steps`` 2). Leaves the process group
    up for 16d."""
    import os

    import torch
    import torch.distributed as dist

    from haet_torch import parallel
    from haet_torch.ops.kernels import plain_route_counts
    from haet_torch.train.graphs import WARMUP

    os.environ.update(HAET_COORDINATOR=f"127.0.0.1:{free_port()}",
                      HAET_NUM_PROCESSES="1", HAET_PROCESS_ID="0")
    parallel.init_distributed()
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    mesh = parallel.make_pp_mesh(1, 1)
    print(f"phase 16a: the bf16 car preset pipelined over {mesh}, "
          f"{PIPE_STEPS} graphed steps at M 1 and M 2", flush=True)
    out = {}
    one = graph_batches(N_POINTS, [SEED + 70])[0]
    two = mesh_batch(2)
    for name, micro, batch in (("m1", 1, one), ("m2", 2, two)):
        pipe = pipe_trainer(dev, mesh, micro)
        check(pipe.graphs is not None, "the pipelined trainer does not graph")
        got = pipe_steps(pipe, batch, PIPE_STEPS)
        del pipe
        rec = {"loss": got["loss"], "walls_ms": got["walls_ms"],
               "launches": got["launches"], "grad": got["grad"]}
        shown = ""
        if micro == 1:
            ref_tr = pipe_trainer(dev, None, 1)
            want = pipe_steps(ref_tr, batch, PIPE_STEPS)
            del ref_tr
            rec.update(ref_loss=want["loss"], ref_walls_ms=want["walls_ms"],
                       grad_err_of_allowance=hold_pipe(f"16a {name}", got,
                                                       want))
            shown = (f", unpipelined "
                     f"{[round(w, 3) for w in want['walls_ms']]} ms")
        torch.cuda.empty_cache()
        check(all(np.isfinite(got["loss"])), f"16a {name}: {got['loss']}")
        expect_counts(f"16a {name} launches (the capture's {WARMUP} warm-up "
                      f"steps and itself, {micro} microbatch(es) each)",
                      got["launches"],
                      scaled(PIPE_PER_STEP, (WARMUP + 1) * micro))
        check(all(v == 0 for v in plain_route_counts().values()),
              f"plain routes {plain_route_counts()}")
        print(f"  16a {name}: losses {got['loss']}; graphed step walls: "
              f"pipelined {[round(w, 3) for w in got['walls_ms']]} ms"
              f"{shown} (the first includes the capture)", flush=True)
        out[name] = rec
    return out


def pipe_rank_main(rank: int, port: int, root: str, queue) -> None:
    """16b and 16c on one of two gloo ranks on the card: the pipeline at
    pp 2, then the mesh exports and the server (rank 0) or its follower
    (rank 1); puts ``(rank, results)`` on ``queue``."""
    import os

    import torch

    from haet_torch import export as hexport
    from haet_torch import parallel, serve
    from haet_torch.ops.kernels import launch_counts, reset_launch_counts
    from haet_torch.utils.env import default_device, host_numpy

    try:
        dev = default_device(None)
        parallel.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                  backend="gloo")
        out = {}
        t0 = time.perf_counter()
        mesh = parallel.make_pp_mesh(1, 2)
        trainer = pipe_trainer(dev, mesh, 2, eager=True)
        res = pipe_steps(trainer, mesh_batch(2), PIPE_STEPS)
        res["stage_layers"] = trainer.model.local_layers
        out["16b"] = res
        del trainer
        torch.cuda.empty_cache()
        out["16b_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        x2 = mesh_batch(2)["x"]
        dp, tp = parallel.make_mesh(2, 1), parallel.make_mesh(1, 2)
        served = {}
        for dtype in PIPE_SERVE_DTYPES:
            bf16 = dtype == "bfloat16"
            model, _ = mesh_car(dev, bf16=bf16, shard=False)
            tp_model, _ = mesh_car(dev, bf16=bf16, shard=True)
            variables = model.eval().state_dict()
            tp_model.eval()
            at = os.path.join(root, dtype)

            def single_device(name, size):
                # rank 1's reference, while rank 0 exports a mesh program
                path = os.path.join(at, f"one_{name}")
                hexport.save_artifact(path, model, None, (x2[:size], None))
                one = hexport.load_artifact(path, device=dev)
                served[f"{dtype} {name} one"] = host_numpy(
                    one(variables, x2[:size]))

            if rank == 1:
                single_device("dp", 2)
            serve.export_batch_family(os.path.join(at, "dp"), model, None,
                                      (x2[:1], None), batch_sizes=(2,),
                                      mesh=dp)
            if rank == 1:
                single_device("tp", 1)
            hexport.save_artifact(os.path.join(at, "tp", "b1"), tp_model,
                                  None, (x2[:1], None), mesh=tp,
                                  data_axis=None)
            for name, mesh_, size in (("dp", dp, 2), ("tp", tp, 1)):
                bundle = hexport.ServingBundle.load(
                    os.path.join(at, name), mesh=mesh_, device=dev)
                reset_launch_counts()
                if rank != 0:
                    serve.follow(bundle, variables)
                else:
                    with serve.BatchingServer(bundle, variables, device=dev,
                                              max_delay_s=1.0) as srv:
                        futs = [srv.submit(x2[i], None) for i in range(size)]
                        served[f"{dtype} {name}"] = np.stack(
                            [f.result(300) for f in futs])
                torch.cuda.synchronize()
                served[f"{dtype} {name} launches"] = launch_counts()
            del model, tp_model
        out["16c"] = served
        out["16c_s"] = time.perf_counter() - t0
        queue.put((rank, out))
    except Exception:
        import traceback

        queue.put((rank, {"error": traceback.format_exc()}))


def pipe_two_ranks(dev, m2: dict) -> dict:
    """16b and 16c: two spawned gloo ranks on the card."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    root = tempfile.mkdtemp(prefix="haet_p16_")
    print(f"phase 16b: two gloo ranks on the card, pp 2 (one car block a "
          f"stage), M 2, {PIPE_STEPS} eager bf16 steps; 16c: a dp 2 b2 "
          f"family and a tp 2 b1 program served over them", flush=True)
    procs = [ctx.Process(target=pipe_rank_main, args=(r, port, root, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        ranks = dict(queue.get(timeout=500) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        shutil.rmtree(root, ignore_errors=True)
    for r, res in sorted(ranks.items()):
        check("error" not in res, f"16b/c rank {r}:\n{res.get('error')}")
    out = {"16b": {}, "16c": {}}
    for r in (0, 1):
        got = ranks[r]["16b"]
        check(got["stage_layers"] == 1, f"16b rank {r}: "
              f"{got['stage_layers']} layers in its stage")
        expect_counts(f"16b rank {r} launches ({PIPE_STEPS} eager steps of "
                      f"its one block, 2 microbatches)", got["launches"],
                      scaled(PIPE_PER_STEP, PIPE_STEPS))
        out["16b"][f"rank{r}"] = {
            "loss": got["loss"], "walls_ms": got["walls_ms"],
            "grad_err_of_allowance": hold_pipe(
                f"16b rank {r} against 16a m2", got, m2, GLOO_RTOL),
            "launches": got["launches"]}
        print(f"  16b rank {r} eager step walls "
              f"{[round(w, 3) for w in got['walls_ms']]} ms (16a m2 graphed "
              f"{[round(w, 3) for w in m2['walls_ms']]} ms)", flush=True)
    got, refs = ranks[0]["16c"], ranks[1]["16c"]
    for dtype, rtol in PIPE_SERVE_DTYPES.items():
        for name in ("dp", "tp"):
            key = f"{dtype} {name}"
            want, ans = refs[f"{key} one"], got[key]
            err = float(np.abs(ans - want).max())
            scale = float(np.abs(want).max())
            bad = np.abs(ans - want) > rtol * np.abs(want) + 1e-6 * scale
            if dtype == "bfloat16":
                bad = np.abs(ans - want) > rtol * scale
            print(f"  16c {key}: served {ans.shape} against the "
                  f"single-device program: max abs err {err:.3e} of max "
                  f"{scale:.3e}; {int(bad.sum())} entries past the "
                  f"tolerance", flush=True)
            check(np.isfinite(ans).all() and not bad.any(),
                  f"16c {key}: the served answers differ from the "
                  f"single-device program")
            for r in (0, 1):
                expect_counts(f"16c {key} rank {r} launches (one forward)",
                              ranks[r]["16c"][f"{key} launches"],
                              PER_FORWARD)
            out["16c"][key] = {"max_abs_err": err, "max_abs": scale}
    out["seconds"] = {"16b": max(ranks[r]["16b_s"] for r in (0, 1)),
                      "16c": max(ranks[r]["16c_s"] for r in (0, 1))}
    return out


def pipeline_phase(dev) -> dict:
    """Phase 16: 16a (the pipeline in a world of one over NCCL, graphed),
    16d (``micro_pipeline_tax``), then 16b and 16c (two gloo ranks)."""
    import torch
    import torch.distributed as dist

    from haet_torch.benchmarks import micro_pipeline_tax

    t0 = time.perf_counter()
    a = pipe_world_of_one(dev)
    t_a = time.perf_counter() - t0
    print(f"phase 16d: micro_pipeline_tax, {TAX_ROUNDS} rounds", flush=True)
    tax = micro_pipeline_tax.run(dev, rounds=TAX_ROUNDS)
    for name, rec in tax.items():
        check(np.isfinite(rec["ms_per_step"])
              and np.isfinite(rec["graph_ms_per_step"]),
              f"16d {name}: {rec}")
    t_d = time.perf_counter() - t0 - t_a
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    out = {"16a": {k: {kk: vv for kk, vv in v.items() if kk != "grad"}
                   for k, v in a.items()}, "16d": tax}
    out.update(pipe_two_ranks(dev, a["m2"]))
    secs = out.pop("seconds")
    out["seconds"] = {"16a": t_a, "16d": t_d, **secs,
                      "all": time.perf_counter() - t0}
    print("phase 16: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                   out["seconds"].items()), flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "haet_torch" / "__init__.py").exists():
        print(f"FAIL: haet_torch not found beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from haet_torch.ops.kernels import _build
    from haet_torch.utils.env import default_device

    dev = default_device(None)
    try:
        line = card_line()
        print(f"phase 1: card {line}; torch {torch.__version__}; "
              f"CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)}",
              flush=True)
        t0 = time.perf_counter()
        reports = _build.build_all()
        nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
        print(f"phase 2: built {sorted(reports)} in "
              f"{time.perf_counter() - t0:.1f} s ({nvcc})", flush=True)
        for name, rep in reports.items():
            for ln in rep.splitlines():
                if any(w in ln for w in ("Compiling entry", "registers",
                                         "spill", "smem")):
                    print(f"  {name}: {ln.strip()}", flush=True)
        records = kernel_phase(dev)
        backward_phase(dev, records)
        print("phase 4: serve the ShapeNet-Car preset", flush=True)
        serve_counts, forwards, model, sample = serve_phase(dev)
        print("phase 5: profile one batch-1 forward", flush=True)
        f32_profile = profile_phase(model, sample, dev)
        del model
        print(f"phase 6: train the ShapeNet-Car preset, {TRAIN_STEPS} steps",
              flush=True)
        counts, replay_calls = train_phase(dev)
        t7 = time.perf_counter()
        records.append(copy_phase(dev))
        t7b = time.perf_counter()
        driver_shape_phase(dev, records)
        t7c = time.perf_counter()
        large_slice_phase(dev)
        t7d = time.perf_counter()
        copy_launches, laps = drivers_phase(dev)
        print(f"phase 7: {time.perf_counter() - t7:.1f} s (7a {t7b - t7:.1f}"
              f" s, 7b {t7c - t7b:.1f} s, 7c {t7d - t7c:.1f} s, " + ", ".join(
                  f"{k} {v:.1f} s" for k, v in laps.items()) + ")",
              flush=True)
        t8 = time.perf_counter()
        print(f"phase 8a: Trainer.fit of the ShapeNet-Car preset, "
              f"{FIT_EPOCHS} epochs", flush=True)
        fit = fit_phase(dev)
        print(f"phase 8b: car_train --epochs {DRIVER_EPOCHS}, then car_eval "
              f"--which last", flush=True)
        fit.update(drivers_car_phase(dev, keep=True))
        run_dir = fit.pop("run_dir")
        print(f"phase 8: {time.perf_counter() - t8:.1f} s", flush=True)
        t9 = time.perf_counter()
        graphs = graph_phase(dev)
        print(f"phase 9: {time.perf_counter() - t9:.1f} s", flush=True)
        bf16_records, bf16 = bf16_phase(dev)
        print_bf16_beside_f32(bf16, graphs, f32_profile)
        try:
            serving = serving_phase(dev, run_dir)
            pde_records, pde = pde_phase(dev)
            ns_records, ns = rollout_phase(dev)
            utils = utils_phase(dev, run_dir)
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        mesh = mesh_phase(dev, graphs, bf16)
        pipeline = pipeline_phase(dev)
        print(f"chip_smoke: {time.perf_counter() - T0:.1f} s", flush=True)
    except CheckFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    counts["copy_scale"] = copy_launches
    for r in records:
        r["launches"] = counts[r["name"]]
        r["replay_launches"] = replay_calls[r["name"]]
        r["serve_launches"] = serve_counts[r["name"]]
    print(json.dumps({"kernels": records + bf16_records + pde_records
                      + ns_records,
                      "train_steps": TRAIN_STEPS,
                      "serve_forwards": forwards, "fit": fit,
                      "graphs": graphs, "bf16": bf16, "serving": serving,
                      "serve_profile": f32_profile, "pde": pde,
                      "rollout": ns, "utils": utils, "mesh": mesh,
                      "pipeline": pipeline}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--load-bundle"]:
        sys.exit(load_bundle_main(sys.argv[2:]))
    sys.exit(main())
