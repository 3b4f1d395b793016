"""Benchmark drivers of the port, run on the card by default.

Counterparts of the JAX repo's drivers (``bench.py`` is
:mod:`haet_torch.bench`):

* :mod:`.micro_erwin_fused` -- per-call cost of the copy kernel and of the
  Erwin block, plain against fused, forward and forward+backward;
* :mod:`.bench_flags` -- train-step A/B of the kernel flags;
* :mod:`.profile_step` -- per-component ablation of the car train step;
* :mod:`.mem_sweep` -- the most points a forward (or with ``--grad 1`` a
  forward and backward) holds, plain against the slice kernels, one fresh
  process per probe;
* :mod:`.velocity_mem_checker` -- forward latency and peak memory against
  the point count;
* :mod:`.copy_scale` -- the copy kernel against ``torch.mul``, and an A/B
  of two trees;
* :mod:`.car_train`, :mod:`.car_eval` -- the ShapeNet-Car training run and
  its evaluation from a checkpoint (and its serving programs);
* :mod:`.exp_darcy`, :mod:`.exp_pipe`, :mod:`.exp_airfoil`,
  :mod:`.exp_elas`, :mod:`.exp_3d` -- the PDE presets' training runs over
  ``Trainer.fit`` (:mod:`.pde_common`, their shared flags and tail);
* :mod:`.exp_ns`, :mod:`.exp_plas` -- the time-stepping PDE presets over
  loops of their own: the NS teacher-forced rollout (and its export as one
  program) and the plasticity time queries;
* :mod:`.micro_rollout` -- the exported NS rollout program against the
  per-frame loop of the single-step program;
* :mod:`.erwin_baseline` -- the Erwin-only ShapeNet-Car baseline (MPNN
  message passing over a radius graph);
* :mod:`.micro_serving_latency`, :mod:`.micro_serving_server` -- batch-1
  latency through an exported program, and the batching server's
  samples/s per mode;
* :mod:`.mfu_sweep` -- the car step's time and MFU against the point
  count, and the slice kernels against the plain path at the largest;
* :mod:`.accum_mem_probe` -- the most points a training step holds at
  batch B, plain against ``accum_steps``;
* :mod:`.parity_repro` -- every task's reference configuration through
  its driver, as one markdown table; :mod:`.model_dict` -- the model
  registry;
* :mod:`.timing` -- the interleaved differential timing they share;
* :mod:`.trace_loss` -- the device records a profiler trace loses as
  its process ages, and whether ``device_trace``'s sentinels take them.

Each runs as ``python -m haet_torch.benchmarks.<name>``; ``--device cpu``
runs it on the CPU, which is only plumbing: no CPU time is a device metric.
"""
