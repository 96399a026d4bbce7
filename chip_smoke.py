#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                # from the repo root, on a machine with a CUDA card
    python3 chip_smoke.py --profile      # also profile GraNd batches (torch.profiler)
    python3 chip_smoke.py --out DIR      # where the detail files go (default chip_smoke_out/)

Phases (the first failure exits non-zero; nothing is caught):

1. Device: require CUDA; print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every hand-written kernel from ``ops/csrc`` (one nvcc per
   source, in parallel) and print the build seconds and ptxas resource lines;
   the tensor-core (bf16) modes of the direct, megakernel and cat-dot kernels,
   and the Gram kernel and the stacked-BN vector mode in both dtypes, must not
   spill registers.
3. Kernels: hold each kernel against its plain PyTorch version at every
   ResNet-18 main-path geometry with B=512, in fp32 (TF32 off, rtol 1e-4) and
   bf16 (the same bf16 inputs on both sides, rtol 1e-3); time both. ``ms`` is
   one call between CUDA events (median after warm-up; the wrapper's host
   time included), ``device_ms`` the kernel's device time per launch over a
   run of ``RUN_LAUNCHES`` launches replayed from a CUDA graph (the host out
   of the run); rows whose inputs fit the 50 MB L2 say so (``l2_warm``), and
   the Gram and stacked-BN ones are also timed cold (``device_cold_ms``,
   cycling through input copies that exceed L2). The direct and Gram kernels
   also at ragged geometries (batch 37; not in the per-batch sums), and the
   Gram kernel at GROUP_CONV's batch 1,536; each bitwise equal on a
   permutation of the batch and from run to run, with ``torch.bmm``'s bf16
   time of the same product Pᵀ G (im2col patches P made outside the timed
   call) beside each direct geometry as a yardstick (``bmm_ms``).
   EL2N at logits [512, 10] and [512, 1000] and the route kernels likewise:
   last-layer GraNd at [512, 512] -> 10 and [512, 2048] -> 1000 (with the fp32
   ``F.linear`` of the same product as a yardstick, ``linear_ms``); both take
   the working dtype and int64 labels as given and are bitwise from run to
   run, on a permuted batch and on a 5-row slice (that each call launches one
   CUDA kernel and nothing else is checked under ``torch.profiler`` after the
   timed phases, phase 13: the profiler slows every later launch of the
   process); stacked BatchNorm at the four ResNet-18 BN shapes
   singly and 5 deep (every launch in the ``vector`` mode) and at ragged rows
   (``BN_RAGGED``: batch 37, C = 72, 100 and 98, S = 1, use_scale and use_bias
   off in turn), bitwise from run to run and on a permuted batch, cat-dot
   (``CATDOT_GEOMETRIES``: 16x16x128 and ragged ones at batch 37) with the
   direct kernel's time at the same layer as a yardstick (``direct_ms``), the
   megakernel (``MEGA_GEOMETRIES``: the stage-1/2/3 unit-stride geometries and
   ragged ones; its bf16 ``dx`` within two bf16 ulps, see ``MEGA_DX_TOL``)
   with a cuDNN input gradient plus the direct kernel's time as yardsticks
   (``dgrad_ms``, ``direct_ms``). Each launch of the direct, Gram, cat-dot
   and megakernel kernels is counted in the mode its dtype selects, and each
   stacked-BN launch in the mode ``bn_mode`` names; in bf16 each is bitwise
   equal from run to run and on a permuted batch, and the megakernel's norm
   bitwise equal to the direct kernel's.
4. Path: full-width ResNet-18 on CIFAR-10-geometry synthetic data (8192
   examples, seeds [0, 1], batch 512, bf16) through ``score_dataset`` for
   ``el2n`` and ``grand``; check finite scores, the launch counts (12 direct,
   all in the tensor-core mode, 3 Gram, 1 EL2N per batch per seed) and ex/s;
   then, on BN-randomized fp32 weights with TF32 off, the kernel route (direct
   launches in the fp32 mode) against the plain route end to end.
5. Routes: every GraNd route (``ROUTES``: ``grand_last_layer`` and the
   ``DDT_GRAND_*`` toggles, set as module attributes and restored) at the
   same width on 1024 examples x 2 seeds: exact launch counts per batch per
   seed (every direct, Gram, cat-dot and megakernel launch in the tensor-core
   mode, every stacked-BN launch in the vector mode, and every BatchNorm x and
   g an NHWC view, so the BN routes copy nothing), ex/s; on BN-randomized
   fp32 weights with TF32 off (every such launch in the fp32 mode, BN in the
   vector mode) each route against
   the default two-phase route (rtol 1e-4), and ``grand_vmap`` on 64 examples
   against it (rtol 2e-4, atol 1e-5); both against float64 (rtol 1e-4).
6. Serve: ``ServeEngine`` answers ``score_batch`` for 1, 100 and 512 ids
   bitwise equal to ``full_scores``, plus ``topk`` and ``rank``, for both
   methods; the keep-hardest count at sparsity 0.5. Then ``grand_last_layer``
   (kernel route) and ``grand`` on the fused megakernel route, bitwise too.
6b. Service: the port's HTTP service (``serve/``) on the path's model, data,
   seeds, batch and dtype. 1: ``ServeEngine`` + ``ServeService`` on port 0,
   the warm passes (the walls, each program key's first-call ``compile_s``)
   bitwise the path's scores; one served 512-row dispatch launches exactly
   12 direct (tensor-core) and 3 Gram per seed for GraNd, 1 EL2N per seed
   for EL2N; ``SERVICE_CLIENTS`` threads x ``SERVICE_REQUESTS`` ``POST
   /v1/score`` of 1..``SERVICE_MAX_IDS`` random ids per method, every answer
   200 and bitwise ``full_scores`` (request p50/p95 ms at the client and in
   the batcher, served ex/s, dispatches, ``batch_fill``, the phase summary);
   ``/v1/rank`` on 100 ids and ``/v1/topk?k=100`` bitwise the engine's, and a
   100-row images request bitwise the indices request. 2: ``serve.max_queue=2``
   with the first dispatch wedged (``DDT_FAULT_PLAN``
   ``wedge_dispatcher_after``): 429 + Retry-After past the queue, /healthz
   critical naming the stalled dispatcher, every queued request bitwise
   after the wedge. 3: steps 1 (init) and 2 (BN-randomized) written by the
   port's ``CheckpointManager``: ``/v1/refresh {"step": 2}`` installs, served
   scores and topk bitwise ``score_dataset`` on step 2; a truncated step 3
   -> 409, step 2 still serving. 4: ``cli serve`` as a subprocess (port from
   its ``obs_server`` record, first dispatch wedged): the accepted requests
   200 bitwise the in-process scores, a request after SIGTERM 503, exit 75
   with ``[preempted]`` within ``SERVICE_DRAIN_S`` + ``SERVICE_EXIT_GRACE_S``;
   every record of both services passes the port's ``tools/validate_metrics.py``. Cuts:
   8,192 of 50,000 examples, 2 of 10 seeds; widths as published.
6c. Fleet: ``cli serve --device cuda serve.replicas=2`` (the path's model, data,
   seeds, batch and dtype, both methods warm; the two replicas share the card)
   as a subprocess, driven through the router with the port's ``tools/serve_client.py``
   and Idempotency-Keys. Two such fleets boot at once (four replicas on the
   card); B's (c) runs first, then B's tuning roll (d) beside A's kill (a),
   and A's latency is read once B has stopped. Fleet A is a fleet of one-rank
   meshes (``mesh.multihost=true mesh.num_processes=1``: each replica its own
   NCCL group of one, started by the supervisor with its coordinator), with
   ``{"rank": 1, "kill_replica_after_requests": FLEET_KILL_AFTER}``: (f) neither fleet's
   supervisor is among ``nvidia-smi --query-compute-apps`` or holds a
   ``/dev/nvidia*`` file, while each of their replicas does; (a) ``FLEET_KILL_CLIENTS`` x
   ``FLEET_KILL_REQUESTS`` keyed requests through the kill, 0 failures, every
   answer bitwise the path's scores, a ``died`` (SIGKILL) naming rank 0 and a
   ``respawn`` of the group on the same port and a new coordinator, the
   respawn wall; the router's p50/p95 per method at the
   service phase's load, every answer bitwise; the launches of one 512-row
   dispatch on each replica from its ``/status`` ``kernel_launches`` (24
   direct, 6 Gram; 2 EL2N); (b) a stepless refresh onto a torn newest step
   -> 409 ``roll_aborted``, old model serving; a good step rolled one
   replica at a time under a hammer (capacity never 0, every answer bitwise
   the old or the new model's offline scores), the roll wall; (e) SIGTERM ->
   exit 75 (each rank 75), the stream valid and ending in ``run_summary``
   (its lineage one rank a replica). Fleet B, plain replicas, with
   ``{"rank": 0, "slow_replica_ms": FLEET_SLOW_MS, "slow_if_step": 4}``,
   ``serve.canary_requests`` and ``obs.slo_fleet_p95_ms``: (c) a good step in
   the watched directory rolls (canary pass), the regressed step 4 fails its
   canary on replica 0 and is rolled back, the prior model's answers bitwise;
   (d) a manifest signed by the port's ``build_tuning_manifest`` for backend
   ``cuda``, this card and the geometry, pinning ``DDT_GRAND_BN_KERNEL=1``:
   ``tuning_roll``, two ``tuning_respawn``, ``tuning_roll_complete``, each new
   replica's ``tuning_applied``, GraNd within ``FLEET_GRAND_RTOL`` of the
   default route on the config's model (a respawned replica boots on it, not
   on the step (c) rolled, as in JAX), a dispatch's launches those of the
   BN_KERNEL route; (e) again, and each tuned replica's ``metrics`` record
   counts ``bn_grad_norm``. Files in ``chip_smoke_out/fleet/`` (removed after a
   pass).
6d. Mesh serve: ``cli serve`` as ``MESH_WORLD`` = 2 ranks on cuda:0 over gloo
   (NCCL refuses two ranks on one card), each a worker process of this script
   (``--mesh-serve-worker``), with the service phase's model, data, seeds,
   batch 512 and bf16, both methods warm. Before ``cli.main`` each rank scores
   the dataset with ``score_dataset`` on the same two ranks at the same batch,
   for the boot variables and for the refresh step: the references. (a) every
   ``/v1/score`` (1, 100 and 512 ids: partial blocks and a full one),
   ``/v1/rank`` (100 ids) and ``/v1/topk?k=100`` answer bitwise the reference,
   both methods, with the largest difference from the single process (the
   path's scores) on the same ids reported; (b) one 512-row dispatch launches
   12 direct and 3 Gram per seed for GraNd, 1 EL2N per seed for EL2N on EACH
   rank (``/status`` ``rank_kernel_launches`` deltas, gathered every
   ``MESH_STATS_S``); (e) ``SERVICE_CLIENTS`` x ``SERVICE_REQUESTS`` requests
   per method, every answer bitwise, p50/p95 printed beside the single
   process's (6b) and the fleet router's (6c), not held; (c)
   ``/v1/refresh`` to a step written by the port's ``CheckpointManager``
   under a hammer: every answer bitwise the old or the new reference, none
   mixed, and then ``/v1/score`` and ``/v1/topk`` bitwise the new one; (d) a
   SIGTERM to rank 1 ends both ranks with exit 75, rank 0 after its drain
   (its ``preempted`` record: signal ``peer``, drained), and both ranks'
   streams (``metrics.jsonl``, ``metrics.rank1.jsonl``) pass
   ``tools/validate_metrics.py`` ending in ``run_summary`` ``preempted``, only
   rank 0's with an ``obs_server`` record. Files in
   ``chip_smoke_out/mesh_serve/`` (removed after a pass).
7. ResNet-50: ``create_model("resnet50", 100)`` on synthetic CIFAR-100-geometry
   data (1,024 examples, one seed, batch 512, bf16) through ``score_dataset``
   for ``el2n`` and ``grand_last_layer``: one launch of the kernel a batch,
   finite scores, ex/s; then in fp32 (TF32 off) the kernel route against the
   plain route (rtol 1e-4 for ``grand_last_layer``, rel 1e-5 or abs 1e-6 for
   EL2N).
8. Train: full-width ResNet-18 through the port's training slice, bf16,
   batch 128, on synthetic CIFAR-10-geometry data. A 2-epoch ``fit`` on
   ``TRAIN_N`` examples with eval (each epoch's ex/s, the steady step ms, the
   eval rate; loss falls, test accuracy above 1/10 + ``TRAIN_ACC_MARGIN``);
   two 20-step fits from one seed bitwise equal, and the step timed with
   cuDNN's deterministic and autotuned algorithms; fit(2) bitwise equal to
   fit(1) + a resume for 1 more through the port's checkpoint
   (``RESUME_N`` examples, augmented); 3 fp32 steps (TF32 off, one padded
   tail) on the card, on the CPU and on the CPU in float64: losses within
   rtol 1e-5 of the CPU's, variables within rtol 1e-4 and an atol of twice
   the CPU fp32 run's largest distance from float64 (floor 1e-6), the card
   no farther from float64; the north-star ``run``
   (``configs/cifar10_resnet18_grand10.yaml`` at ``TRAIN_N`` examples, seeds
   [0, 1], 2 retrain epochs): its stage walls, 12 direct and 3 Gram launches
   per batch per seed in the tensor-core mode, ``n_kept`` half the set, the
   prune manifest verified, a finite final accuracy; then on its pretrained
   seed-0 weights in fp32 each kernel route (``el2n``, ``grand``,
   ``grand_last_layer``, train-mode ``el2n``) against its plain route (rtol
   1e-4; EL2N + atol 1e-6). Cuts: 8,192 of CIFAR-10's 50,000 examples, 2 of
   the recipes' 198 epochs, 2 of the north star's 10 seeds; widths as
   published.
8a. Chunked: the chunked engine (``train.chunk_steps``, ``score.chunk_steps``;
   one CUDA-graph replay a chunk, ``graphs.py``). (a) ``fit`` of the train
   phase's recipe, augmented, at ``CHUNK_N`` examples (25 steps an epoch: a
   body of 16 and a tail of 9), 2 epochs, with ``train.chunk_steps`` null (16)
   twice and 1 once: state and history (walls aside) bitwise; the steady
   epoch's ex/s and step wall per engine, the device time of a step (CUDA
   events over ``CHUNK_TIMED`` back-to-back replays of a 16-step chunk) and
   the device-busy share it gives each engine, the chunk's capture wall and
   pool bytes. (b) ``evaluate`` over the 25 batches, chunked (with its
   captures, then replayed) against per batch, bitwise, ex/s each. (c)
   ``score_dataset`` GraNd (default route) and EL2N over ``N_PATH`` x
   ``SEEDS`` at batch ``B``: a warm chunked pass (the captures, in a shared
   ``GraphCache``), then per batch, chunked, per batch, chunked: every pass
   bitwise the first per-batch one; the counted chunked pass is one K = 16
   replay a seed (``dispatches_score_chunk`` = ``graph_replays:score_chunk``
   = 2) and launches exactly what the per-batch pass launches (384 direct and
   96 Gram; 32 EL2N); ex/s per pass, capture wall and pool bytes per
   capture. (d) ``cli run`` of the north star at ``CHUNK_RUN_N`` with the
   chunk settings at their defaults: every fit logs ``train_chunked`` with
   ``chunk_steps`` 16, its scoring launches the GraNd kernels (counted into
   the kernels line). (e) every chunk program's ``graph_replays:<program>``
   equals its ``dispatches_<program>``. Cuts: as phase 8's.
8b. Obs: the observability slice. The north-star ``run`` (``OBS_N``
   examples, ``OBS_SEEDS``, ``OBS_EPOCHS`` retrain epochs, per step:
   ``train.chunk_steps=1 score.chunk_steps=1``) through ``python -m
   data_diet_distributed_tpu_torch.cli`` as a subprocess, once with every
   instrument on (trace, flight recorder, introspection, memory watermark,
   score telemetry, SLOs, ``torch.profiler`` windows, resource monitor,
   perf ledger, Prometheus file, ``obs.server_port=0``) and once with none:
   exit 0 both; the scores and kept set bitwise equal; the stream passes
   ``tools/validate_metrics.py`` and ends in ``metrics`` then
   ``run_summary``, whose ``mfu`` is in (0, 1] with the peak from the table
   (``table:NVIDIA H100 80GB HBM3`` on that card); ``xla_program`` records of
   ``train_step`` and ``score_batch`` with FLOPs (the score program's kernel
   work counted), an ``hbm_watermark`` peak, ``score_stats`` for each seed
   and ``score_stability``; the trace nests run -> score -> seed -> fit ->
   epoch -> eval and run -> retrain -> fit; one capture per stage
   (``score_pretrain``, ``score``, ``final``), the ``score`` one holding the
   direct and Gram kernels; a ``/status`` poll
   after the first epoch answers with ``epoch``, ``mfu``, the watermark, the
   ETA and the lineage; the ledger line says ``cuda`` and the card; the
   monitor's duty samples; with ``obs.plots_dir`` on the first run, the
   ``[plots] wrote`` files (printed, with whether matplotlib imports) are
   ``OBS_PLOTS_CPU`` (what the same ``cli run --device cpu`` writes in
   ``tests/test_torch_plots.py``) and ``OBS_PLOTS_CARD`` where matplotlib
   imports, and none where it does not. The two walls are printed (start-up
   included).
   Then three processes at once: ``cli score`` with EL2N and a profile
   window (its capture holds ``el2n_kernel``), and two ``cli train`` drills
   at ``OBS_DRILL_N`` examples under ``DDT_FAULT_PLAN``: a NaN at epoch 1
   leaves ``flightrec_rank0.json`` with reason ``divergence:epoch1``, and a
   600-s hang under an ``OBS_HANG_TIMEOUT_S`` watchdog (introspection off: the
   flop counter's first step outlasts so short a deadline) is one ``hang``
   fault whose ``WatchdogTimeout`` names rank 0's last progress. Files in
   ``chip_smoke_out/obs/``, removed after a pass.
8c. Walkthrough: ``python -m data_diet_distributed_tpu_torch.examples.walkthrough
   --device cuda --arch resnet18 --size WALK_N`` (run by ``runpy`` in a
   worker process of this script, ``--walkthrough-worker``, which prints its
   launches), started with 8d before phase 7 and judged after phase 8, so it
   runs beside phases 7-8 (full-width ResNet-18, fp32, ``WALK_N`` synthetic
   examples at CIFAR geometry): exit 0; every cell's line in order; finite
   EL2N, GraNd, Spearman, forgetting and AUM figures; ``WALK_N`` / 2 kept; a
   retrain accuracy in [0, 1]; exactly one EL2N, 12 direct and 3 Gram
   launches a scoring batch of ``WALK_B``, the direct and Gram ones in the
   fp32 mode. Cuts: ``WALK_N`` of 50,000 examples.
8d. Serve soak: ``python -m data_diet_distributed_tpu_torch.tools.serve_soak
   --device cuda --arch resnet18 --method grand --schedule
   partition,autoscale,wedge`` as a subprocess beside phases 7-8b and 8c,
   judged after 8b (two replicas of full-width ResNet-18 scoring GraNd in
   fp32, 256 synthetic examples, 12 rps for ``SERVE_SOAK_LOAD_S`` a cycle; files in
   ``chip_smoke_out/serve_soak/``, removed after a pass): exit 0, every cycle
   passed (the tool's record forensics, stream validation and request
   attribution), the monitor exits the tool allows, zero client-visible
   failures and exit 75 in every cycle, and each cycle's replicas launched
   the direct and Gram kernels (their exit ``metrics`` records). The
   partition cycle's replicas ran through the remote backend (``serve.hosts``
   slots: the ``launch`` record places no card) and reconnected with the
   restart budget whole; its dark -> quarantined -> reconnected walls, the
   autoscale cycle's violation -> ``scale_up`` -> routable -> ``scale_down``
   and the wedge cycle's wedged -> reaped -> respawn -> routable are printed.
9. Resilience: on the north-star ``run`` of phase 8 (its own directory), A:
   a fault plan SIGTERMs after seed 0's score partial -> ``Preempted``, seed 0's
   partial on disk, ``score`` not complete; the re-invoked run pretrains and
   scores seed 1 only (12 direct and 3 Gram launches per batch, tensor-core)
   and its scores, kept set and final retrain arrays are bitwise phase 8's.
   B: the same config reusing A's scores, SIGTERM at epoch 0's end ->
   ``Preempted`` durable at one epoch of steps; the re-invoked run resumes
   ``retrain:final`` there and ends bitwise equal to A's retrain, launching
   nothing. F: B's newest step truncated, a resumed fit refuses it
   (``checkpoint_corrupt``), falls back one step and ends bitwise equal to B.
   On ``RESUME_N`` examples of the recipe: C, SIGTERM before step 2 -> a final
   save at step 3 (``preempted``, epoch -1), the resume ending at step 3 + 2
   epochs; D, NaN at epoch 1 -> one ``divergence``, a rollback to epoch 0's
   step at half the LR, bitwise a resume by hand; E, a 600-s hang in epoch 1
   with ``resilience.step_timeout_s`` = ``HANG_TIMEOUT_S`` -> one ``hang``
   (``WatchdogTimeout``) and a retry, under ``HANG_WALL_S`` of wall, bitwise
   an uninterrupted fit. G (in processes of its own, beside A-F):
   ``python -m data_diet_distributed_tpu_torch.cli run`` at ``G_N`` examples
   exits 75 with ``[preempted]`` under ``DDT_FAULT_PLAN`` and 0 without it
   (``n_kept`` half). Then the hooks'
   cost: ``OVERHEAD_PAIRS`` alternating pairs of fit's steady-epoch ex/s with
   resilience at its defaults and with preemption and the NaN check off.
10. Data: BASELINE config 5 (``configs/imagenet_resnet50_grand.yaml``: ResNet-50,
   imagenet stem, GraNd, batch 256, bf16) on ``DATA_N`` synthetic_imagenet
   examples (96x96, 100 classes) quantized to uint8 and written by the port as
   npz splits, ``.npy`` splits with ``stats.npz`` and ``DATA_SHARD``-row shards
   read through a two-shard cache (``DATA_CACHE``); the npy and shard planes
   built again from the npz plane by ``python -m
   data_diet_distributed_tpu_torch.tools.npz_to_npy`` and ``.make_shards``
   (subprocesses at once) are bitwise the inline writer's, arrays, shards and
   manifest. 1: the native assembler
   loads, and ``prefetch_stream`` over the shards yields CUDA batches bitwise
   the npy plane's host batches (all taken at once, so a pinned slot reused
   early would show). 2: ``cli run`` on the streamed shards (one seed, one
   epoch each): exit 0, ``n_kept`` half, the manifest verified, one
   ``data_plane`` record per fit and score pass within the cache budget and
   evicting, and the direct and Gram launches exactly what one batch's route
   log predicts, tensor-core; stage walls and epoch ex/s. 3: GraNd on the
   eager set, two seeds: streaming bitwise resident, partials included; ex/s.
   4: the npy and sharded planes streamed, bitwise equal. 5-6: fp32, TF32
   off, BN-randomized weights, ``DATA_PARITY_N`` examples: lazy against the
   dense npz (EL2N rel 1e-5 or abs 1e-6, GraNd rtol 1e-4), the kernel route
   against the plain one (rtol 1e-4), and every conv geometry with its route
   and its largest relative error against the plain version (fp32 1e-4, bf16
   1e-3); each kernel geometry timed in bf16 with its bound. 7: 20-step fits,
   streaming at depth 2 and 0 bitwise resident; epoch ex/s and
   ``stall_frac``. 8: storage drills: one EIO recovers in place with one
   ``data_fault`` record and bitwise scores; a torn shard fails the pass with
   ``ShardReadError`` naming it and a ``shard_quarantine`` record; the same
   under ``data.skip_quarantined`` lets ``cli run`` finish with the
   quarantined rows in its prune manifest. Cuts: 2,048 examples for an
   ImageNet-1k subset, one epoch for 30, synthetic data for real (none in the
   repo); widths as published.
11. WRN: BASELINE config 4 (``configs/cifar100_wrn28_10.yaml``: WideResNet-28-10
   / CIFAR-100, GraNd over seeds [0, 1, 2], prune sweep {30, 50, 70} %; bf16,
   training at batch 128, scoring at batch 512) on ``WRN_N`` synthetic
   CIFAR-100-geometry examples. 1: 36,479,194 parameters at 10 classes, and
   bf16 logits within ``WRN_LOGIT_RTOL`` of fp32 on BN-randomized weights. 2:
   one GraNd batch's route log is ``WRN_ROUTES`` (9 v1, 7 v2, 7 Gram, 5
   plain: 16 direct and 7 Gram launches a batch). 3: every conv geometry of
   a GraNd batch against its plain version on the layer's own x and g (fp32
   1e-4, bf16 1e-3), and the megakernel's 15 and the stacked-BN kernel's 25
   layers at their geometries on random inputs in both dtypes; each bf16
   geometry timed with its bound; EL2N and the last layer at config 4's head
   (logits [512, 100], features [512, 640]) in both dtypes, timed in fp32,
   the dtype the path hands them. 4: GraNd, EL2N and ``grand_last_layer``
   through ``score_dataset`` on the three seeds (ex/s, exact launches,
   tensor-core), then in fp32 each kernel route against its plain route on
   ``WRN_PARITY_N`` examples. 5: ``cli sweep`` with ``prune.sweep=[0.3,0.5,0.7]``
   on the set written as npz: exit 0, one scoring pass (the three seeds'
   launches, exact), ``n_kept`` of 70, 50 and 30 % with a verified prune
   manifest per level; stage walls and each fit's epoch ex/s. 6: with
   ``model.remat=true`` 16 training steps bitwise those without (losses,
   params, batch statistics, momentum) and GraNd bitwise; one step's peak
   CUDA memory with remat on and off. 7: ``cli score`` with ``forgetting`` and
   ``aum`` on the ResNet-18 north-star geometry (``TRAJ_N`` examples,
   ``TRAJ_EPOCHS`` epochs, seeds [0, 1], pixel noise ``TRAJ_NOISE``): finite
   scores, forgetting's
   per-seed counts in {0, 1} or never learned (``updates + 1``), two runs
   bitwise equal, and a run preempted after seed 0's partial resuming with
   seed 1 only, bitwise the uninterrupted one. Cuts: ``WRN_N`` of 50,000
   examples, 1 of 10 pretrain epochs, 1 of 200 retrain epochs per level;
   widths and seeds as published.
11b. TP: BASELINE config 4's ``cli run`` (``configs/cifar100_wrn28_10.yaml``:
   WideResNet-28-10, a 640 -> 100 head, GraNd over seeds [0, 1, 2], prune 50 %;
   bf16, training at batch 128, scoring at batch 512) on ``TP_N`` synthetic
   CIFAR-100-geometry examples written as npz, as ``TP_WORLD`` = 2 ranks on
   cuda:0 over gloo with ``mesh.model_axis=2 mesh.data_axis=1`` (each rank
   one worker process of this script, ``--tp-worker``, joined before
   ``cli.main``), and as one process (W = 1), all three at once. Each worker
   first pretrains in fp32 with TF32 off on ``TP_PARITY_N`` examples (three
   steps, seed 0, through ``score_variables_for_seeds``), then runs ``cli
   run`` with its launches counted; the ranks then join again for ``cli
   score`` with EL2N on the run's final checkpoint (``score.score_ckpt_step``).
   Gates: (a) each rank's pretrain and retrain fits end holding
   ``classifier.weight`` [50, 640] and ``bias`` [50] (and their momentum),
   and the two ranks' trunks (every other param and statistic) bitwise equal;
   (b) the fp32 pretrained variables within rtol 1e-4, atol 1e-6 of W = 1's
   (the train phase's card gate at its atol floor; the bf16 pretrained
   variables' largest difference is printed, not held: bf16 sums the head's
   two row blocks of ``∂L/∂h`` in another order); (c) the run's GraNd scores
   within rtol 1e-4 + 1e-5 and the EL2N scores within rtol 1e-5 + 1e-6 of
   ``score_dataset`` at W = 1 at the rank's batch of 256 on the same
   variables (the ranks' pretrained ones, the final checkpoint's), as the
   dist phase's (c); the difference from W = 1 at 512 is printed (bf16 WRN
   scores move with the batch's geometry); (d) each rank's launches: exactly the GraNd
   route's direct and Gram kernels (``route log`` at the rank's 256 rows) per
   batch per seed, tensor-core, and one EL2N per batch; (e) the final
   checkpoint restores at W = 1 to the logits the ranks' split head computed
   on the final state (fp32, TF32 off; within 1e-5 of the largest |logit|).
   Walls of both runs printed. Cuts: ``TP_N`` of 50,000 examples, 1 of 10
   pretrain epochs, 1 of 200 retrain epochs; widths and seeds as published.
   Files in ``chip_smoke_out/tp/`` (removed after a pass).
12. Dist: the port across ranks (``torch.distributed``), each step as worker
   processes of this script with a timeout. W = 1 over NCCL: the north-star
   ``cli run`` (``TRAIN_N`` examples, seeds [0, 1]) with ``mesh.multihost=true
   mesh.num_processes=1`` bitwise the same run without a group (scores, kept
   set, final checkpoint; launches equal), and the all-reduce of ResNet-18's
   44.7 MB fp32 gradient timed. Two NCCL ranks on cuda:0 must both fail at
   their first all-reduce ("Duplicate GPU detected"). W = 2 as two processes
   on cuda:0 over gloo (started beside the W = 1 run and the refused pair,
   so the timings of both steps are taken side by side)
   with CUDA tensors: (a) a bf16 ResNet-18 fit (``DIST_FIT_N`` examples,
   batch 128, augmented) ends bitwise equal on both ranks, and 3 fp32 steps
   (TF32 off) are within rtol 1e-5 (losses) and rtol 1e-4, atol 1e-6
   (variables: the train phase's card-against-CPU gate at its atol floor) of
   the fit at W = 1 here; (b)
   ZeRO-1 and the sharded update bitwise the replicated update, with rank 0's
   optimizer bytes; (c) GraNd and EL2N ``score_dataset`` over ``N_PATH`` x 2
   seeds at batch 512: both ranks' vectors bitwise equal, within
   ``tests/test_distributed.py``'s tolerances (GraNd rtol 1e-4 + 1e-5, EL2N
   rtol 1e-5 + 1e-6) of W = 1 at the rank's batch of 256, exactly 12 direct
   (tensor-core), 3 Gram and 1 EL2N launches per rank per batch per seed,
   ex/s per rank; (d) consensus drills, two CLI ranks each on tiny_cnn: a
   SIGTERM to rank 1 ends both with exit 75 at step 4, durable at 4, and the
   resume ends bitwise the uninterrupted W = 2 run; a NaN on rank 1 ends
   both with exit 69 at epoch 1 (``recovery_refused``); rank 1's newest step
   hidden makes both restore step 8 and end bitwise the uninterrupted run; a
   hang on rank 1 ends both with exit 69 (rank 1 from its watchdog or the
   peer's poison, the two deadlines running out together) and rank 0 within
   ``DRILL_GRACE_S`` + ``DRILL_EXIT_BOUND_S`` of the first poison;
   (e) the ZeRO-1 checkpoint written at W = 2 restores bitwise here at W = 1.
12b. Elastic: ``cli run`` of the north star (``ELASTIC_N`` examples, seeds
   [0, 1], one pretrain epoch, 3 retrain epochs of batch 128, a checkpoint
   every epoch, ``checkpoint.local_tier=true``) as subprocesses on the card,
   the supervised ones with ``elastic.enabled=true elastic.world=1`` and
   ``obs.slo_recovery_s=ELASTIC_SLO_S``, introspection off; all five at once:
   the GraNd run unsupervised and uninterrupted (R), the same with
   ``score.method=el2n`` (R_el2n), (a) and (b) below, and (c) GraNd
   supervised with ``rejoin_after_stage=score`` at
   ``elastic.max_world=1``: the join is denied and cleared and the run
   completes, its scores, kept set and final retrain state bitwise R's (when
   its stage barrier tripped on the pending join, the relaunch re-enters
   through the stage manifest). (a), host loss: ``{"rank": 0,
   "kill_rank_after_epoch": 1}`` SIGKILLs the worker after the retrain's
   epoch 1; the supervisor exits 0 with exactly ``launch ->
   children_exited(shrink) -> shrink(dead_ranks [0], new_world 1) ->
   launch(resume) -> complete``, the relaunch's ``resume`` record names a
   promoted tier step (``saved_world`` 1), and the scores, kept set and final
   state are bitwise R's. (a) runs with ``resilience.stage_resume=false``, so
   its relaunch pretrains and scores again: the attempt's ``metrics`` record
   counts the direct and Gram launches. (b), SIGTERM mid-promotion: EL2N,
   ``stage_resume=false``, ``checkpoint.promote_delay_s=ELASTIC_DELAY_S``,
   ``{"rank": 0, "sigterm_at_epoch_end": 1}``: the worker drains the tier and
   exits 75 (its ``preempted`` record durable at epoch 1's step, with the
   drain's wait and budget), the supervisor relaunches it (``restart``), the
   relaunch counts EL2N launches, and the result is bitwise R_el2n's. (d)
   ``python -m data_diet_distributed_tpu_torch.obs.postmortem`` over (a)'s
   directory exits 0 naming the shrink of rank 0 and the resume; the
   recovery wall (the classification to the first training step of attempt
   1, from the records) and the SLO's verdict are printed. Cuts: ``ELASTIC_N``
   of 50,000 examples, 2 of 10 seeds, 3 of 198 retrain epochs; one card runs
   W = 1 only (NCCL refuses two ranks on one card).
12c. Tune: ``python -m data_diet_distributed_tpu_torch.tools.autotune`` as a
   subprocess over the combos ``baseline`` and ``bn_kernel`` (ResNet-18,
   ``TUNE_N`` synthetic examples x 2 seeds at batch 512, two timed passes a
   measure child, no confirmation; files in ``chip_smoke_out/tune/``,
   removed after a pass): (a) exit 0; (b) the events ``search_start``, two
   ``measured`` with values > 0, ``verified``, ``winner``,
   ``manifest_written`` and no ``disqualified``; (c) the manifest reads back
   through ``tuning.read_tuning_manifest``, matches this card and the
   geometry (``match_manifest``: backend ``cuda``, the card's name; one
   device), pins all seven ``DDT_GRAND_*`` toggles, and the winner's
   exactness entry against ``grand_vmap`` (fp32, TF32 off) is ``ok`` (its max
   abs and rel errors printed); (d) the ``bn_kernel`` child launched
   ``bn_grad_norm`` and ``baseline`` did not, both the direct kernel (launches
   a batch from the children's ledger records, printed beside the routes
   phase's); (e) ``cli score`` on the same geometry with the manifest and
   ``tuning.apply=strict`` exits 0, logs ``tuning_applied`` with the winner's
   combo and launches the winner's route (``bn_grad_norm`` iff it pins
   ``DDT_GRAND_BN_KERNEL``); (f) ``tools.profile_dispatch`` in this process,
   while (e)'s process runs, for the score and the train chunk of ResNet-18
   at batch 512 and K = 1 and 16: t(1), t(16), ms a step, the overhead and
   the recommended K printed, every figure finite and the step > 0 ms.
12d. Duty: ``tools.validate_duty`` in this process, ``DUTY_IDLE_S`` idle,
   ``DUTY_BUSY_S`` of chained bf16 matmuls, ``DUTY_IDLE_S`` idle, under the
   port's ``ResourceMonitor``: samples taken, and the busy phase's duty above
   both idle phases' (the three printed).
12e. Demo: ``python -m data_diet_distributed_tpu_torch.tools.e2e_demo
   --device cuda`` as a subprocess, started with phase 12f's soak before
   phase 10 and judged after phase 11b, so both run beside phases 10-11b
   (ResNet-18 full width, bf16, ``DEMO_N``
   synthetic examples at CIFAR geometry, batch ``DEMO_B``, ``DEMO_EPOCHS``
   epochs, ``--pretrain-epochs 1``, sparsity ``DEMO_SPARSITY`` only, EL2N,
   one seed; files in ``chip_smoke_out/demo/``, removed after a pass): exit
   0; the JAX tool's headline keys; ``summary.jsonl`` holds the config and
   the dense, hardest and random rows; both policies keep ``DEMO_N`` / 2;
   the hardest row's ``score_method`` is ``el2n`` and the random row's starts
   with ``reused:``; every accuracy in [0, 1]; the legs' ``metrics`` records
   count ``DEMO_N`` / ``DEMO_B`` EL2N launches in the hardest sweep and none
   in the dense fit and the random sweep. Cuts: 2,048 of 50,000 examples, 2
   of 30 epochs, one of three sparsities.
12f. Soak: ``python -m data_diet_distributed_tpu_torch.tools.imagenet_soak
   --smoke --device cuda`` as a subprocess beside phases 10-11b and 12e,
   judged after 12e (files in ``chip_smoke_out/soak/``, removed after a
   pass): its
   cycles ``sigterm``, ``nan`` and ``kill`` of tiny-CNN ``cli train`` under
   the elastic supervisor; exit 0, every cycle recovered, every
   ``run_monitor --once`` and post-mortem exit 0, every cycle's
   ``run_summary`` ``ok`` with its SLO verdict ``ok`` and a valid stream, and
   the kill cycle relaunched (two attempts or more).
13. Calls: each EL2N and last-layer row of phase 3 runs one CUDA kernel per
   call, its own, and no copy, cast or memset (``torch.profiler``).

With ``--profile``: one batch under ``torch.profiler`` on each of the default,
FUSED+MEGAKERNEL, BN_KERNEL and BN_KERNEL+GROUP_BN+GROUP_CONV routes, and one
config 5 batch (phase 10) and one config 4 batch (phase 11) on the default
route; the cuDNN dgrad launches must drop from 19 to 9 on the megakernel
route, and the profiled BN and Gram time per batch is printed beside the
``device_ms`` sums.

Every counted run (phases 4, 5, 6b and 7, phase 6c's replicas, phase 6d's and 11b's ranks, phase 8's
``run``, phase 8a's ``cli run``, phase 8c's walkthrough, phase 8d's replicas, phase 9's runs of
``run_datadiet``, phase 10's ``cli run``, phase 11's ``score_dataset`` passes and ``cli sweep``,
and the relaunched attempts of phase 12b, and the three legs of phase 12e, each a new
process) starts with the launch counts at 0
and is read right after; the kernels line sums them. The line before the last is a
JSON object with one entry per kernel (launches on the main paths, max error,
ms, device ms, plain ms, bound ms); the last line is ``{"ok": true, "device":
{...}}``.
Per-geometry details go to ``<out>/chip_smoke.json`` (and the profile tables to
``<out>/chip_smoke_profile.txt``).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

B = 512
N_PATH = 8192
SEEDS = (0, 1)
PAD1 = ((1, 1), (1, 1))
PAD0 = ((0, 0), (0, 0))

# (kernel, entry, x shape, g shape, kernel size, strides, padding, layers of
# ResNet-18 at CIFAR-10 geometry with this shape, i.e. launches per GraNd batch, bias)
GEOMETRIES = [
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 32, 32, 64), (3, 3), (1, 1), PAD1, 4,
     False),
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 16, 16, 128), (3, 3), (2, 2), PAD1, 1,
     False),
    ("conv_grad_norm_direct", "v1", (B, 32, 32, 64), (B, 16, 16, 128), (1, 1), (2, 2), PAD0, 1,
     False),
    ("conv_grad_norm_direct", "v2", (B, 16, 16, 128), (B, 16, 16, 128), (3, 3), (1, 1), PAD1, 3,
     False),
    ("conv_grad_norm_direct", "v2", (B, 8, 8, 256), (B, 8, 8, 256), (3, 3), (1, 1), PAD1, 3,
     False),
    ("conv_grad_norm_gram", "gram", (B, 4, 4, 512), (B, 4, 4, 512), (3, 3), (1, 1), PAD1, 3,
     False),
    # The three stage-4 convs concatenated along the batch, as GROUP_CONV launches them
    # (one launch per batch on that route; not in the default route's per-batch sums).
    ("conv_grad_norm_gram", "gram", (3 * B, 4, 4, 512), (3 * B, 4, 4, 512), (3, 3), (1, 1),
     PAD1, 0, False),
    # Ragged direct geometries, on no ResNet-18 path: C and K off the 64 tile, a
    # strided 9x9 input, C not a multiple of 8, asymmetric padding; batch 37.
    ("conv_grad_norm_direct", "v2", (37, 12, 12, 72), (37, 12, 12, 136), (3, 3), (1, 1), PAD1, 0,
     False),
    ("conv_grad_norm_direct", "v1", (37, 9, 9, 48), (37, 5, 5, 80), (3, 3), (2, 2), PAD1, 0,
     False),
    ("conv_grad_norm_direct", "v1", (37, 10, 10, 20), (37, 10, 10, 24), (3, 3), (1, 1), PAD1, 0,
     False),
    ("conv_grad_norm_direct", "v1", (37, 11, 11, 64), (37, 11, 11, 40), (3, 3), (1, 1),
     ((0, 2), (2, 0)), 0, False),
    # Ragged Gram geometries at batch 37: C and K not multiples of 8 with the bias term
    # (scalar staging); a 5x5 map (25 positions, padded to 32) with asymmetric padding;
    # K = 4096, whose rows stream through the ring in chunks (gram_plan).
    ("conv_grad_norm_gram", "gram", (37, 4, 4, 100), (37, 4, 4, 70), (3, 3), (1, 1), PAD1, 0,
     True),
    ("conv_grad_norm_gram", "gram", (37, 5, 5, 64), (37, 5, 5, 64), (3, 3), (1, 1),
     ((0, 2), (2, 0)), 0, False),
    ("conv_grad_norm_gram", "gram", (37, 4, 4, 72), (37, 4, 4, 4096), (3, 3), (1, 1), PAD1, 0,
     True),
]
# Megakernel: (x shape, g shape, kernel size, padding, use_bias, layers per batch): the
# unit-stride 3x3 convs of stages 1-3 (megakernel route), then ragged geometries on no
# ResNet-18 path at batch 37 (C and K off the 64 tile; C and K not multiples of 8 with
# asymmetric padding; a (3, 2) kernel).
MEGA_GEOMETRIES = [((B, 32, 32, 64), (B, 32, 32, 64), (3, 3), PAD1, False, 4),
                   ((B, 16, 16, 128), (B, 16, 16, 128), (3, 3), PAD1, False, 3),
                   ((B, 8, 8, 256), (B, 8, 8, 256), (3, 3), PAD1, False, 3),
                   ((37, 12, 12, 72), (37, 12, 12, 136), (3, 3), PAD1, True, 0),
                   ((37, 10, 10, 20), (37, 10, 10, 30), (3, 3), ((0, 2), (2, 0)), False, 0),
                   ((37, 9, 11, 64), (37, 9, 11, 48), (3, 2), ((1, 1), (1, 0)), True, 0)]
# Cat-dot: (x shape, g shape, kernel size, padding, layers per batch): stage 2's
# unit-stride 3x3 conv (CATDOT route), then ragged ones at batch 37 (a non-square map
# with K = 256 and asymmetric padding; a (3, 2) kernel).
CATDOT_GEOMETRIES = [((B, 16, 16, 128), (B, 16, 16, 128), (3, 3), PAD1, 3),
                     ((37, 12, 10, 128), (37, 12, 10, 256), (3, 3), ((0, 2), (2, 0)), 0),
                     ((37, 9, 14, 128), (37, 9, 14, 128), (3, 2), ((1, 1), (1, 0)), 0)]
BN_SHAPES = [(B, 32, 32, 64), (B, 16, 16, 128), (B, 8, 8, 256), (B, 4, 4, 512)]
# Ragged stacked-BN rows at batch 37, on no ResNet-18 path: (x shape, layers, use_scale,
# use_bias). C = 72 takes the vector mode (9 vectors of 8 bf16); C = 100 the scalar
# mode in bf16 and the vector one in fp32; C = 98 the scalar mode in both; S = 1.
BN_RAGGED = [((37, 3, 3, 72), 3, True, True), ((37, 5, 5, 100), 3, True, False),
             ((37, 1, 1, 98), 3, False, True), ((37, 1, 1, 72), 1, True, True)]
# The megakernel's dx against the plain version's, elementwise:
# |dx - ref| <= rtol * |ref| + 1e-5 * max|ref|. fp32: rtol 1e-4. bf16 output:
# both sides round an fp32 sum of the same terms (in another order) to bf16,
# which can land one bf16 ulp (2^-8 relative) apart; rtol 2^-7 allows two.
MEGA_DX_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}

ROUTE_N = 1024
MEGA_ROUTE = {"FUSED_BWD": True, "MEGAKERNEL": True}
# Launch-table rows: (name, method, DDT_GRAND_* module attributes, launches
# per batch per seed).
ROUTES = [
    ("grand", "grand", {}, {"conv_grad_norm_direct": 12, "conv_grad_norm_gram": 3}),
    ("grand_last_layer", "grand_last_layer", {}, {"grand_last_layer": 1}),
    ("BN_KERNEL", "grand", {"USE_BN_KERNEL": True},
     {"conv_grad_norm_direct": 12, "conv_grad_norm_gram": 3, "bn_grad_norm": 20}),
    ("BN_KERNEL+GROUP_BN+GROUP_CONV", "grand",
     {"USE_BN_KERNEL": True, "GROUP_BN": True, "GROUP_CONV": True},
     {"conv_grad_norm_direct": 5, "conv_grad_norm_gram": 1, "bn_grad_norm": 4}),
    ("CATDOT", "grand", {"USE_CATDOT": True},
     {"conv_grad_norm_direct": 9, "conv_grad_norm_gram": 3, "conv_grad_norm_catdot": 3}),
    ("FUSED", "grand", {"FUSED_BWD": True},
     {"conv_grad_norm_direct": 12, "conv_grad_norm_gram": 3}),
    ("FUSED+MEGAKERNEL", "grand", MEGA_ROUTE,
     {"conv_grad_norm_direct": 2, "conv_grad_norm_gram": 3, "conv_bwd_grad_norm": 10}),
]

KERNEL_INFO = {
    "conv_grad_norm_direct": (
        "data_diet_distributed_tpu_torch/ops/csrc/conv_grad_norm_direct.cu",
        "data_diet_distributed_tpu/ops/pallas_kernels.py:327; "
        "data_diet_distributed_tpu/ops/pallas_kernels.py:683"),
    "conv_grad_norm_gram": (
        "data_diet_distributed_tpu_torch/ops/csrc/conv_grad_norm_gram.cu",
        "data_diet_distributed_tpu/ops/pallas_kernels.py:797"),
    "el2n": ("data_diet_distributed_tpu_torch/ops/csrc/el2n.cu",
             "data_diet_distributed_tpu/ops/pallas_kernels.py:100"),
    "grand_last_layer": ("data_diet_distributed_tpu_torch/ops/csrc/grand_last_layer.cu",
                         "data_diet_distributed_tpu/ops/pallas_kernels.py:933"),
    "bn_grad_norm": ("data_diet_distributed_tpu_torch/ops/csrc/bn_grad_norm.cu",
                     "data_diet_distributed_tpu/ops/pallas_kernels.py:883"),
    "conv_grad_norm_catdot": (
        "data_diet_distributed_tpu_torch/ops/csrc/conv_grad_norm_catdot.cu",
        "data_diet_distributed_tpu/ops/pallas_kernels.py:156"),
    "conv_bwd_grad_norm": ("data_diet_distributed_tpu_torch/ops/csrc/conv_bwd_grad_norm.cu",
                           "data_diet_distributed_tpu/ops/pallas_kernels.py:488"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_T0 = time.perf_counter()
_PHASES: list[str] = []   # the phases begun, in order


def phase(name: str) -> None:
    """A phase's banner, with the seconds since the script started."""
    _PHASES.append(name)
    print(f"== {name} (+{time.perf_counter() - _T0:.1f} s)", flush=True)


def time_ms(torch, fn, warmup: int = 2, iters: int = 7) -> float:
    """Median time of one call, by CUDA events around it with the device idle
    before it: the wrapper's host time (checks, allocation, launch) included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# Launches of one timed run (device_ms) and such runs whose median is taken.
RUN_LAUNCHES = 20
RUN_REPEATS = 3
# L2 cache of the H100: inputs of at most this many bytes are read warm in a run of
# launches on the same inputs.
L2_BYTES = 50 * 2**20


def device_ms(torch, fns, warmup: int = 3) -> float:
    """Device time per launch: a run of ``RUN_LAUNCHES`` back-to-back calls
    (cycling through ``fns``, one callable or a list of them on distinct
    input copies) captured once in a CUDA graph, then CUDA events around one
    replay of it, over the count; median of ``RUN_REPEATS`` replays after
    warm-up. The graph takes the wrapper's host time (checks, allocation,
    the ctypes call) out of the run, which for a short kernel is longer than
    the kernel: only the device's work and its launch gaps remain."""
    fns = fns if isinstance(fns, list) else [fns]
    n = max(RUN_LAUNCHES, len(fns))
    for i in range(max(warmup, len(fns))):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUN_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    del graph
    return statistics.median(times)


def cold_copies(nbytes: float) -> int:
    """Input copies a cold run cycles through: enough that one cycle reads at
    least twice the L2 cache, so no launch finds its inputs there."""
    return int(-(-2 * L2_BYTES // nbytes)) + 1


def bound_ms(flops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_modes(K, before: dict, n: int, mode: str, what: str,
                kernel: str = "conv_grad_norm_direct") -> None:
    """Exactly ``n`` launches of ``kernel`` since ``before`` (its mode counts),
    all in ``mode``."""
    after = K.mode_counts()[kernel]
    delta = {m: after[m] - before[m] for m in after}
    want = {m: (n if m == mode else 0) for m in after}
    check(delta == want, f"{what}: {kernel} launches by mode {delta}, want {want}")


def route_mode(K, kernel: str, dtype) -> str:
    """The mode every launch of ``kernel`` takes on a ResNet-18 route in
    ``dtype``: the stacked-BN kernel's vector mode (every ResNet-18 channel
    count is a multiple of 8), else the mode the dtype selects."""
    return "vector" if kernel == "bn_grad_norm" else K.DIRECT_MODES[dtype]


def check_bitwise(torch, gen, call, x, g, got, what: str) -> None:
    """``call(x, g)`` (a tensor or a tuple of them, batch first) gives ``got``
    again bit for bit, and each example the same bits wherever it sits in the
    batch (a permutation)."""
    as_tuple = (lambda r: r if isinstance(r, tuple) else (r,))
    perm = torch.randperm(x.shape[0], generator=gen, device="cuda")
    again = as_tuple(call(x, g))
    moved = as_tuple(call(x[perm].contiguous(), g[perm].contiguous()))
    check(all(torch.equal(a, b) and torch.equal(m, b[perm])
              for a, m, b in zip(again, moved, as_tuple(got))),
          f"{what}: not bitwise equal from run to run and on a permuted batch")


def check_bn_bitwise(torch, gen, call, xs, gs, got, what: str) -> None:
    """``call(xs, gs)`` of the stacked-BN kernel gives ``got`` again bit for
    bit, and each example the same bits wherever it sits in its layer's batch
    (every layer permuted alike; out is [L·B], layer-major)."""
    b = xs[0].shape[0]
    perm = torch.randperm(b, generator=gen, device="cuda")
    again = call(xs, gs)
    moved = call([x[perm].contiguous() for x in xs], [g[perm].contiguous() for g in gs])
    want = got.reshape(len(xs), b)[:, perm].reshape(-1)
    check(torch.equal(again, got) and torch.equal(moved, want),
          f"{what}: not bitwise equal from run to run and on a permuted batch")


def check_rows_bitwise(torch, gen, call, args, got, what: str) -> None:
    """``call(*args)`` (every arg batch-first) gives ``got`` again bit for bit,
    on a permuted batch the permuted bits, and on a 5-row slice those rows'."""
    b = args[0].shape[0]
    perm = torch.randperm(b, generator=gen, device="cuda")
    again = call(*args)
    moved = call(*(a[perm].contiguous() for a in args))
    part = call(*(a[3:8].contiguous() for a in args))
    check(torch.equal(again, got) and torch.equal(moved, got[perm])
          and torch.equal(part, got[3:8]),
          f"{what}: not bitwise equal from run to run, on a permuted batch and on a "
          "5-row slice")


# (row record, description, kernel name, call): the one-call launch checks, run by
# ``calls_phase`` after the timed phases (the profiler slows every later launch of
# the process).
CALL_CHECKS: list = []


def kernels_per_call(torch, call, tries: int = 3) -> list[str]:
    """Names of the CUDA kernels (copies and memsets included) one warmed-up
    ``call()`` runs, under ``torch.profiler``. A capture that recorded no
    device event at all lost its trace (a call launches at least one kernel;
    seen once in a whole run of this script), and is taken again, up to
    ``tries`` captures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def kernel_phase(torch, K, dtype, rtol, details) -> None:
    """Each kernel against its plain version at every main-path geometry."""
    dname = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for kernel, entry, xs, gs, ks, st, pad, layers, bias in GEOMETRIES:
        x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
        g = torch.randn(gs, generator=gen, device="cuda").to(dtype)
        if entry == "v1":
            def call(x, g):
                return K.conv_grad_norm_sq(x, g, ks, st, pad)

            def plain():
                return K.conv_grad_norm_sq_plain(x, g, ks, st, pad)
        elif entry == "v2":
            def call(x, g):
                return K.conv_grad_norm_sq_v2(x, g, ks, pad)

            def plain():
                return K.conv_grad_norm_sq_plain(x, g, ks, (1, 1), pad)
        else:
            def call(x, g, bias=bias):
                return K.conv_grad_norm_sq_gram(x, g, ks, pad, use_bias=bias)

            def plain():
                return K.conv_grad_norm_sq_gram_plain(x, g, ks, pad, use_bias=bias)

        def run():
            return call(x, g)
        what = f"{kernel}/{entry} {dname} x{list(xs)} g{list(gs)}"
        modes0 = K.mode_counts()[kernel]
        got = run()
        torch.cuda.synchronize()
        check_modes(K, modes0, 1, K.DIRECT_MODES[dtype], what, kernel)
        check_bitwise(torch, gen, call, x, g, got, what)
        ref = plain()
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-30)).max())
        # The package's one count of the work, which the MFU harvest reads too.
        flops, nbytes = K.kernel_work(kernel, x=xs, g=gs, kernel_size=ks,
                                      itemsize=x.element_size())
        bnd, by = bound_ms(flops, nbytes, dname)
        rec = {"kernel": kernel, "entry": entry, "dtype": dname, "x": list(xs),
               "g": list(gs), "kernel_size": list(ks), "strides": list(st),
               "padding": [list(p) for p in pad], "use_bias": bias,
               "layers_per_batch": layers, "max_abs_err": float(err.max()),
               "max_rel_err": rel, "ms": time_ms(torch, run), "device_ms": device_ms(torch, run),
               "plain_ms": time_ms(torch, plain, warmup=1, iters=3),
               "bound_ms": bnd, "bound_by": by, "input_bytes": nbytes,
               "l2_warm": nbytes <= L2_BYTES}
        if rec["l2_warm"] and kernel == "conv_grad_norm_gram":
            copies = [(x.clone(), g.clone()) for _ in range(cold_copies(nbytes))]
            rec["device_cold_ms"] = device_ms(torch, [lambda xc=xc, gc=gc: call(xc, gc)
                                                      for xc, gc in copies])
            del copies
        if kernel == "conv_grad_norm_direct" and dtype == torch.bfloat16:
            # Yardstick, not a library counterpart: one bf16 bmm of the same
            # product P^T G (no norm), with the patches P made outside the call.
            p = K.patches(x, ks, st, pad, gs[1:3]).to(dtype)
            g2 = g.reshape(gs[0], gs[1] * gs[2], gs[3])
            rec["bmm_ms"] = time_ms(torch, lambda: torch.bmm(p.transpose(1, 2), g2))
            del p
        details.append(rec)
        print(f"  {what} k{ks} s{st}: "
              f"rel_err={rel:.3e} (rtol {rtol}) ms={rec['ms']:.4f} "
              f"device_ms={rec['device_ms']:.4f}"
              + (f" (inputs {nbytes / 2**20:.1f} MiB fit L2; cold "
                 f"{rec['device_cold_ms']:.4f})" if "device_cold_ms" in rec else "")
              + f" plain_ms={rec['plain_ms']:.4f} bound_ms={bnd:.4f} ({by})"
              + (f" bmm_ms={rec['bmm_ms']:.4f}" if "bmm_ms" in rec else ""), flush=True)
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        check(rel <= rtol, f"{what}: max rel err {rel:.3e} > {rtol}")
    # EL2N at the path's logits geometry [512, 10] and a wide one [512, 1000]: the
    # logits in the working dtype itself, the labels int64, as a caller holds them.
    for c in (10, 1000):
        z = (torch.randn((B, c), generator=gen, device="cuda") * 3).to(dtype)
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = (torch.rand(B, generator=gen, device="cuda") > 0.1).float()
        what = f"el2n {dname} logits[{B},{c}]"
        got, ref = K.el2n(z, y, m), K.el2n_plain(z, y, m)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-6)).max())
        check_rows_bitwise(torch, gen, lambda z, y, m: K.el2n(z, y, m), (z, y, m), got, what)
        flops, nbytes = K.kernel_work("el2n", batch=B, classes=c, itemsize=z.element_size())
        rec = _measure(torch, {"kernel": "el2n", "entry": "el2n", "dtype": dname,
                               "logits": [B, c], "labels": "int64",
                               "layers_per_batch": 1 if c == 10 else 0,
                               "max_abs_err": float(err.max()), "max_rel_err": rel},
                       lambda: K.el2n(z, y, m), lambda: K.el2n_plain(z, y, m),
                       flops, nbytes, "float32")
        details.append(rec)
        CALL_CHECKS.append((rec, what, "el2n_kernel", lambda z=z, y=y, m=m: K.el2n(z, y, m)))
        print(f"  {what} (int64 labels): abs_err={rec['max_abs_err']:.3e} "
              f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.5f} "
              f"({rec['bound_by']})", flush=True)
        check(rel <= 1e-5 or float(err.max()) <= 1e-6, f"{what}: max rel err {rel:.3e}")


def _measure(torch, rec: dict, run, plain, flops: float, nbytes: float,
             peak: str) -> dict:
    """Fill ``rec`` with the kernel's one-call and device (run of launches)
    times, the plain version's time and the bound of ``flops`` at the
    ``peak`` type's rate and ``nbytes``."""
    bnd, by = bound_ms(flops, nbytes, peak)
    rec.update(ms=time_ms(torch, run), device_ms=device_ms(torch, run),
               plain_ms=time_ms(torch, plain, warmup=1, iters=3),
               bound_ms=bnd, bound_by=by, input_bytes=float(nbytes),
               l2_warm=bool(nbytes <= L2_BYTES))
    return rec


def _rel_err(got, ref) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs()
    return float(err.max()), float((err / ref.float().abs().clamp_min(1e-30)).max())


def bn_row(torch, K, gen, dtype, rtol, details, shape, depth: int, scale: bool,
           bias: bool, layers: int, main_path: bool) -> dict:
    """The stacked-BN kernel on ``depth`` random layers of ``shape`` against its
    plain version, bitwise from run to run and on a permuted batch, timed; a
    ``main_path`` shape must take the vector mode and is also timed cold."""
    dname = str(dtype).replace("torch.", "")
    item = torch.tensor([], dtype=dtype).element_size()
    c = shape[-1]
    xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(depth)]
    gs = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(depth)]
    stats = torch.stack([torch.randn((depth, c), generator=gen, device="cuda"),
                         torch.rand((depth, c), generator=gen, device="cuda") + 0.5],
                        dim=1)

    def call(xs, gs, stats=stats, scale=scale, bias=bias):
        return K.bn_grad_norm_sq(xs, gs, stats, scale, bias)
    what = f"bn_grad_norm {dname} x{list(shape)} x{depth} scale={scale} bias={bias}"
    mode = K.bn_mode(xs, gs)
    if main_path:
        check(mode == "vector", f"{what}: a main-path BN launch in mode {mode}")
    modes0 = K.mode_counts()["bn_grad_norm"]
    got = call(xs, gs)
    torch.cuda.synchronize()
    check_modes(K, modes0, 1, mode, what, "bn_grad_norm")
    check_bn_bitwise(torch, gen, call, xs, gs, got, what)
    ref = K.bn_grad_norm_sq_plain(xs, gs, stats, scale, bias)
    abs_err, rel = _rel_err(got, ref)
    flops, nbytes = K.kernel_work("bn_grad_norm", elements=depth * int(np.prod(shape)),
                                  layers=depth, channels=c, batch=shape[0], itemsize=item)
    rec = _measure(torch, {"kernel": "bn_grad_norm", "entry": "bn", "dtype": dname,
                           "x": list(shape), "layers": depth, "use_scale": scale,
                           "use_bias": bias, "mode": mode, "layers_per_batch": layers,
                           "max_abs_err": abs_err, "max_rel_err": rel},
                   lambda: call(xs, gs),
                   lambda: K.bn_grad_norm_sq_plain(xs, gs, stats, scale, bias),
                   flops, nbytes, "float32")
    if rec["l2_warm"] and main_path:
        copies = [([t.clone() for t in xs], [t.clone() for t in gs])
                  for _ in range(cold_copies(rec["input_bytes"]))]
        rec["device_cold_ms"] = device_ms(torch, [lambda xc=xc, gc=gc: call(xc, gc)
                                                  for xc, gc in copies])
        del copies
    details.append(rec)
    print(f"  {what} ({mode}): rel_err={rel:.3e} ms={rec['ms']:.4f} "
          f"device_ms={rec['device_ms']:.4f}"
          + (f" (inputs {rec['input_bytes'] / 2**20:.1f} MiB fit L2; cold "
             f"{rec['device_cold_ms']:.4f})" if "device_cold_ms" in rec else "")
          + f" plain_ms={rec['plain_ms']:.4f} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= rtol,
          f"{what}: max rel err {rel:.3e} > {rtol}")
    return rec


def mega_row(torch, K, gen, dtype, rtol, details, xs_, gs_, ks, pad, bias: bool,
             layers: int) -> dict:
    """The megakernel at one geometry on random x, g and weight against its plain
    version (the norm within ``rtol``, dx within ``MEGA_DX_TOL``), bitwise in
    bf16 and its norm bitwise the direct kernel's; timed with a cuDNN input
    gradient and the direct kernel as yardsticks."""
    dname = str(dtype).replace("torch.", "")
    item = torch.tensor([], dtype=dtype).element_size()
    x = torch.randn(xs_, generator=gen, device="cuda").to(dtype)
    g = torch.randn(gs_, generator=gen, device="cuda").to(dtype)
    w = torch.randn((gs_[3], xs_[3], *ks), generator=gen, device="cuda") * 0.05
    w = w.contiguous(memory_format=torch.channels_last)

    def call(x, g, w=w, ks=ks, pad=pad, bias=bias):
        return K.conv_bwd_grad_norm_sq(x, g, w, ks, pad, use_bias=bias)
    what = f"conv_bwd_grad_norm {dname} x{list(xs_)} g{list(gs_)} k{ks}"
    modes0 = K.mode_counts()["conv_bwd_grad_norm"]
    dx, ns = call(x, g)
    torch.cuda.synchronize()
    check_modes(K, modes0, 1, K.DIRECT_MODES[dtype], what, "conv_bwd_grad_norm")
    if dtype == torch.bfloat16:
        check_bitwise(torch, gen, call, x, g, (dx, ns), what)
        if not bias:   # the norm role is the direct kernel's walk, to the bit
            check(torch.equal(ns, K.conv_grad_norm_sq(x, g, ks, (1, 1), pad)),
                  f"{what}: norm not bitwise equal to the direct kernel's")
    rdx, rns = K.conv_bwd_grad_norm_sq_plain(x, g, w, ks, pad, use_bias=bias)
    abs_err, rel = _rel_err(ns, rns)
    dx_err = (dx.float() - rdx.float()).abs()
    scale = float(rdx.float().abs().max())
    dx_excess = float((dx_err - MEGA_DX_TOL[dname] * rdx.float().abs()).max())
    flops, nbytes = K.kernel_work("conv_bwd_grad_norm", x=tuple(xs_), g=tuple(gs_),
                                  kernel_size=tuple(ks), itemsize=item,
                                  weight_numel=w.numel())
    rec = _measure(torch, {"kernel": "conv_bwd_grad_norm", "entry": "mega",
                           "dtype": dname, "x": list(xs_), "g": list(gs_),
                           "kernel_size": list(ks), "padding": [list(p) for p in pad],
                           "use_bias": bias, "layers_per_batch": layers,
                           "max_abs_err": max(abs_err, float(dx_err.max())),
                           "max_rel_err": rel, "dx_max_abs_err": float(dx_err.max()),
                           "dx_scale": scale},
                   lambda: call(x, g),
                   lambda: K.conv_bwd_grad_norm_sq_plain(x, g, w, ks, pad, use_bias=bias),
                   flops, nbytes, dname)
    rec["direct_ms"] = time_ms(torch, lambda: K.conv_grad_norm_sq(x, g, ks, (1, 1), pad))
    rec["dgrad_ms"] = None
    if pad[0][0] == pad[0][1] and pad[1][0] == pad[1][1]:
        wd, gn = w.to(dtype), g.permute(0, 3, 1, 2)
        size = (xs_[0], xs_[3], xs_[1], xs_[2])
        rec["dgrad_ms"] = time_ms(torch, lambda: torch.nn.grad.conv2d_input(
            size, wd, gn, padding=(pad[0][0], pad[1][0])))
    details.append(rec)
    yard = ("" if rec["dgrad_ms"] is None else
            f" dgrad_ms={rec['dgrad_ms']:.4f} + direct_ms={rec['direct_ms']:.4f}")
    print(f"  {what}: norm rel_err={rel:.3e} "
          f"dx max abs err={float(dx_err.max()):.3e} (max |dx| {scale:.3e}) "
          f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
          f"plain_ms={rec['plain_ms']:.4f} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}){yard}", flush=True)
    check(dx.dtype == dtype and bool(torch.isfinite(dx).all())
          and bool(torch.isfinite(ns).all()), f"{what}: output")
    check(rel <= rtol, f"{what}: norm rel err {rel:.3e}")
    check(dx_excess <= 1e-5 * scale, f"{what}: dx beyond rtol {MEGA_DX_TOL[dname]}")
    return rec


def route_kernel_phase(torch, K, dtype, rtol, details) -> None:
    """The route kernels against their plain versions at the path's shapes."""
    dname = str(dtype).replace("torch.", "")
    item = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # Last-layer GraNd: features in the working type and int64 labels, read as they are;
    # ResNet-18's head and a wide one (a ResNet-50's, 1,000 classes). Bound: the
    # product's FLOPs at the tensor-core rate (both modes run there; the split's extra
    # products not counted), beside the old fp32 CUDA-core figure.
    for f, c, layers in ((512, 10, 1), (2048, 1000, 0)):
        h = randn(B, f)
        w = torch.randn((c, f), generator=gen, device="cuda") * f ** -0.5
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        y = torch.randint(0, c, (B,), generator=gen, device="cuda")
        m = (torch.rand(B, generator=gen, device="cuda") > 0.1).float()
        what = f"grand_last_layer {dname} [{B},{f}]->{c}"
        got, ref = K.grand_last_layer(h, w, bias, y, m), K.grand_last_layer_plain(h, w, bias, y, m)
        torch.cuda.synchronize()
        abs_err, rel = _rel_err(got, ref)
        check_rows_bitwise(torch, gen, lambda h, y, m: K.grand_last_layer(h, w, bias, y, m),
                           (h, y, m), got, what)
        flops, nbytes = K.kernel_work("grand_last_layer", batch=B, features=f, classes=c,
                                      itemsize=item)
        rec = _measure(torch, {"kernel": "grand_last_layer", "entry": "gll", "dtype": dname,
                               "features": [B, f], "classes": c, "labels": "int64",
                               "layers_per_batch": layers, "max_abs_err": abs_err,
                               "max_rel_err": rel, "plan": K.gll_plan(f, c, dtype),
                               "bound_fp32_cores_ms": bound_ms(flops, nbytes, "float32")[0]},
                       lambda: K.grand_last_layer(h, w, bias, y, m),
                       lambda: K.grand_last_layer_plain(h, w, bias, y, m),
                       flops, nbytes, "bfloat16")
        if c == 1000:
            # Yardstick, not a library counterpart: the classifier product alone, fp32
            # (cuBLAS, TF32 off), on fp32 features made outside the call.
            h32 = h.float()
            rec["linear_ms"] = time_ms(torch, lambda: torch.nn.functional.linear(h32, w, bias))
            rec["linear_device_ms"] = device_ms(
                torch, lambda: torch.nn.functional.linear(h32, w, bias))
        details.append(rec)
        print(f"  {what}: rel_err={rel:.3e} "
              f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}; fp32 CUDA cores "
              f"{rec['bound_fp32_cores_ms']:.4f})"
              + (f" F.linear fp32 ms={rec['linear_ms']:.4f} device_ms="
                 f"{rec['linear_device_ms']:.4f}" if "linear_ms" in rec else ""),
              flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= rtol,
              f"{what}: max rel err {rel:.3e} > {rtol}")
        CALL_CHECKS.append((rec, what, "gll_kernel",
                            lambda h=h, w=w, bias=bias, y=y, m=m:
                            K.grand_last_layer(h, w, bias, y, m)))
    # Stacked BatchNorm: every ResNet-18 BN shape, one layer (5 launches per batch on
    # the BN_KERNEL route) and 5 deep (1 launch per batch with GROUP_BN), then the
    # ragged rows (BN_RAGGED).
    rows = [(shape, depth, True, True, 5 if depth == 1 else 0)
            for shape in BN_SHAPES for depth in (1, 5)]
    rows += [(shape, depth, scale, bias, 0) for shape, depth, scale, bias in BN_RAGGED]
    for shape, depth, scale, bias, layers in rows:
        bn_row(torch, K, gen, dtype, rtol, details, shape, depth, scale, bias, layers,
               main_path=shape in BN_SHAPES)
    # Cat-dot at every CATDOT_GEOMETRIES row. Yardstick, not a library counterpart:
    # the direct kernel at the same layer (v2 where it takes the layer), which
    # computes the same function (``direct_ms``).
    for xs_, gs_, ks, pad, layers in CATDOT_GEOMETRIES:
        x, g = randn(*xs_), randn(*gs_)

        def call(x, g, ks=ks, pad=pad):
            return K.conv_grad_norm_sq_catdot(x, g, ks, pad)
        what = f"conv_grad_norm_catdot {dname} x{list(xs_)} g{list(gs_)} k{ks}"
        modes0 = K.mode_counts()["conv_grad_norm_catdot"]
        got = call(x, g)
        torch.cuda.synchronize()
        check_modes(K, modes0, 1, K.DIRECT_MODES[dtype], what, "conv_grad_norm_catdot")
        if dtype == torch.bfloat16:
            check_bitwise(torch, gen, call, x, g, got, what)
        ref = K.conv_grad_norm_sq_catdot_plain(x, g, ks, pad)
        abs_err, rel = _rel_err(got, ref)
        rec = _measure(torch, {"kernel": "conv_grad_norm_catdot", "entry": "catdot",
                               "dtype": dname, "x": list(xs_), "g": list(gs_),
                               "kernel_size": list(ks), "padding": [list(p) for p in pad],
                               "layers_per_batch": layers, "max_abs_err": abs_err,
                               "max_rel_err": rel},
                       lambda: call(x, g),
                       lambda: K.conv_grad_norm_sq_catdot_plain(x, g, ks, pad),
                       *K.kernel_work("conv_grad_norm_catdot", x=xs_, g=gs_,
                                      kernel_size=ks, itemsize=item), dname)
        if K.conv_grad_norm_v2_eligible(xs_, gs_, ks, (1, 1), pad):
            rec["direct_ms"] = time_ms(torch, lambda: K.conv_grad_norm_sq_v2(x, g, ks, pad))
        else:
            rec["direct_ms"] = time_ms(torch, lambda: K.conv_grad_norm_sq(x, g, ks, (1, 1), pad))
        details.append(rec)
        print(f"  {what}: rel_err={rel:.3e} ms={rec['ms']:.4f} "
              f"device_ms={rec['device_ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) direct_ms={rec['direct_ms']:.4f}", flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= rtol,
              f"{what}: max rel err {rel:.3e} > {rtol}")
    # Megakernel at every MEGA_GEOMETRIES row. Yardsticks, not library counterparts:
    # a cuDNN input gradient of the same conv in the same dtype (``dgrad_ms``; at
    # symmetric padding) plus the direct kernel's norm at the same layer
    # (``direct_ms``), the two launches the megakernel replaces on its route.
    for xs_, gs_, ks, pad, bias, layers in MEGA_GEOMETRIES:
        mega_row(torch, K, gen, dtype, rtol, details, xs_, gs_, ks, pad, bias, layers)


# Classifier scale of the parity weights: with the BatchNorms randomized the
# features grow through the blocks and the unscaled classifier gives logits
# spread over ~50-100 per row; the saturated softmax then moves fp32 scores by
# ~2e-4 from float64 (and by batch geometry). At 0.05 the logits' std is ~1
# and fp32 stays within ~4e-6 of float64.
PARITY_CLASSIFIER_SCALE = 0.05


def bn_randomized(torch, port, seed: int, device: str = "cuda", arch: str = "resnet18",
                  **init) -> dict:
    """``arch``'s variables (ResNet-18 by default; ``init`` goes to
    ``init_variables``) on ``device`` with every BatchNorm randomized (at
    init the closing BN scale is zero, which would zero half the convs'
    cotangents) and the classifier scaled by ``PARITY_CLASSIFIER_SCALE``."""
    v = port["init_variables"](arch, seed, device, **init)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, t in v.items():
        if t.dim() == 1 and not name.startswith("classifier"):
            if name.endswith("running_var"):
                v[name] = torch.rand(t.shape, generator=gen, device=device) + 0.5
            else:
                base = 1.0 if name.endswith(".weight") else 0.0
                v[name] = base + 0.3 * torch.randn(t.shape, generator=gen, device=device)
        elif name.startswith("classifier"):
            v[name] = PARITY_CLASSIFIER_SCALE * t
    return v


@contextlib.contextmanager
def toggles(gb, flags: dict):
    """Set ``DDT_GRAND_*`` module attributes of the port for a block."""
    old = {k: getattr(gb, k) for k in flags}
    for k, v in flags.items():
        setattr(gb, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(gb, k, v)


def path_phase(torch, port, details_out, card: str) -> dict:
    cfg = port["load_config"](os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={N_PATH}",
        "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}",
        f"score.batch_size={B}", "train.half_precision=true"])
    ds, _ = port["load_dataset"]("synthetic", synthetic_size=N_PATH, seed=0)
    model = port["create_model_from_cfg"](cfg)
    variables = [port["init_variables"]("resnet18", s, "cuda") for s in SEEDS]
    nb = -(-N_PATH // B)
    K = port["kernels"]
    # Warm-up on one batch (cuDNN heuristics, library load) before the counted run.
    warm = ds.subset(ds.indices[:B])
    for method in ("el2n", "grand"):
        port["score_dataset"](model, variables[:1], warm, method=method, batch_size=B,
                              device="cuda")
    K.reset_launch_counts()
    results = {}
    before = K.launch_counts()
    for method in ("el2n", "grand"):
        modes0 = K.mode_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = port["score_dataset"](model, variables, ds, method=method,
                                       batch_size=B, device="cuda")
        wall = time.perf_counter() - t0
        after = K.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        before = after
        for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram"):
            check_modes(K, modes0[kern], delta[kern], "tensor_core", method, kern)
        check(scores.shape == (N_PATH,), f"{method}: scores shape {scores.shape}")
        check(bool(np.isfinite(scores).all()), f"{method}: non-finite scores")
        check(bool((scores >= 0).all()), f"{method}: negative scores")
        want = dict.fromkeys(K.KERNELS, 0)
        if method == "el2n":
            check(bool((scores <= np.sqrt(2) + 1e-6).all()), "el2n above sqrt(2)")
            want["el2n"] = nb * len(SEEDS)
        else:
            want.update(conv_grad_norm_direct=12 * nb * len(SEEDS),
                        conv_grad_norm_gram=3 * nb * len(SEEDS))
        check(delta == want, f"{method}: launch counts {delta}, want {want}")
        ex_s = N_PATH * len(SEEDS) / wall
        results[method] = {"scores": scores, "wall_s": wall, "ex_per_s": ex_s,
                           "launches": delta}
        print(f"  {method}: {N_PATH} examples x {len(SEEDS)} seeds in {wall:.3f} s = "
              f"{ex_s:.1f} ex/s on {card}; launches {delta}; "
              f"mean score {scores.mean():.5f}", flush=True)
    counts = K.launch_counts()
    details_out["path"] = {m: {k: v for k, v in r.items() if k != "scores"}
                           for m, r in results.items()}

    # Kernel route vs plain route end to end: fp32, TF32 off, BN randomized.
    port["set_parity_mode"](True)
    cfg32 = port["load_config"](None, ["data.dataset=synthetic", "model.arch=resnet18",
                                       "train.half_precision=false"])
    model32 = port["create_model_from_cfg"](cfg32)
    v = bn_randomized(torch, port, 7)
    sub = ds.subset(ds.indices[:2 * B])
    for method in ("grand", "el2n"):
        modes0 = K.mode_counts()
        fast = port["score_dataset"](model32, [v], sub, method=method, batch_size=B,
                                     use_kernels=True, device="cuda")
        for kern, per_batch in (("conv_grad_norm_direct", 12), ("conv_grad_norm_gram", 3)):
            check_modes(K, modes0[kern], per_batch * 2 if method == "grand" else 0, "fp32",
                        f"{method} fp32", kern)
        plain = port["score_dataset"](model32, [v], sub, method=method, batch_size=B,
                                      use_kernels=False, device="cuda")
        rel = float(np.max(np.abs(fast - plain) / np.maximum(np.abs(plain), 1e-30)))
        print(f"  {method} fp32 kernel route vs plain route ({2 * B} examples, "
              f"BN randomized): max rel err {rel:.3e}", flush=True)
        details_out.setdefault("route_parity", {})[method] = rel
        check(rel <= 1e-4, f"{method}: kernel route vs plain route rel err {rel:.3e}")
    port["set_parity_mode"](False)
    return {"cfg": cfg, "ds": ds, "variables": variables, "results": results,
            "counts": counts}


def calls_phase(torch) -> None:
    """Each EL2N and last-layer row's call, on its kernel-phase inputs, runs one
    CUDA kernel, its own, and no copy, cast or memset (``kernels_per_call``)."""
    for rec, what, kernel, call in CALL_CHECKS:
        launched = kernels_per_call(torch, call)
        rec["kernels_per_call"] = launched
        print(f"  {what}: CUDA kernels per call {launched}", flush=True)
        check(len(launched) == 1 and kernel in launched[0],
              f"{what}: one call ran {launched}, want {kernel} alone")
    CALL_CHECKS.clear()


# ResNet-50 head pass: CIFAR-100 geometry (32x32x3, 100 classes), 1,024 examples.
R50_N = 1024
R50_CLASSES = 100
R50_REPEATS = 3   # timed passes per method (the launch counts are read after each)


def cifar100_dataset(port, n: int):
    """Synthetic CIFAR-100-geometry data (CIFAR-100 itself is not in the repo): a
    fixed template per class plus noise, drawn from seed 0."""
    rng = np.random.default_rng(0)
    templates = rng.normal(0.0, 0.5, size=(R50_CLASSES, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, R50_CLASSES, size=n).astype(np.int32)
    images = templates[labels] + rng.normal(0.0, 0.4, size=(n, 32, 32, 3)).astype(np.float32)
    return port["ArrayDataset"](images=images, labels=labels,
                                indices=np.arange(n, dtype=np.int32), num_classes=R50_CLASSES)


def resnet50_phase(torch, port, details_out, card: str) -> dict:
    """A ResNet-50 head ([512, 2048] -> 100) through both redesigned kernels on a
    real scoring path: ``score_dataset`` with ``el2n`` and ``grand_last_layer``
    at full width, bf16, batch 512, one seed (one launch a batch, finite
    scores, ex/s of each of ``R50_REPEATS`` passes, the first counted in the
    kernels line); then in fp32 parity mode (TF32 off) each against the plain
    route."""
    K = port["kernels"]
    ds = cifar100_dataset(port, R50_N)
    model = port["create_model"]("resnet50", R50_CLASSES, half_precision=True)
    v = [port["init_variables"]("resnet50", 0, "cuda", num_classes=R50_CLASSES)]
    nb = -(-R50_N // B)
    warm = ds.subset(ds.indices[:B])
    out, counts = {}, dict.fromkeys(K.KERNELS, 0)
    for method in ("el2n", "grand_last_layer"):
        port["score_dataset"](model, v, warm, method=method, batch_size=B, device="cuda")
        walls = []
        for rep in range(R50_REPEATS):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = port["score_dataset"](model, v, ds, method=method, batch_size=B,
                                           device="cuda")
            walls.append(time.perf_counter() - t0)
            got = K.launch_counts()
            want = {k: (nb if k == method else 0) for k in K.KERNELS}
            check(got == want, f"resnet50 {method}: launch counts {got}, want {want}")
            if rep == 0:
                for k, n in got.items():
                    counts[k] += n
        check(scores.shape == (R50_N,) and bool(np.isfinite(scores).all())
              and bool((scores >= 0).all()), f"resnet50 {method}: scores not finite/>= 0")
        ex_s = [R50_N / wall for wall in walls]
        out[method] = {"wall_s": walls, "ex_per_s": ex_s, "launches": nb}
        print(f"  resnet50 {method}: {R50_N} examples x 1 seed, {R50_REPEATS} passes: "
              + ", ".join(f"{x:.1f}" for x in ex_s) + f" ex/s on {card}; {nb} launches a "
              f"pass ({nb} batches); mean score {scores.mean():.5f}", flush=True)
    port["set_parity_mode"](True)
    model32 = port["create_model"]("resnet50", R50_CLASSES)
    for method in ("el2n", "grand_last_layer"):
        fast = port["score_dataset"](model32, v, ds, method=method, batch_size=B,
                                     use_kernels=True, device="cuda")
        plain = port["score_dataset"](model32, v, ds, method=method, batch_size=B,
                                      use_kernels=False, device="cuda")
        err = np.abs(fast - plain)
        rel = float(np.max(err / np.maximum(np.abs(plain), 1e-30)))
        ok = (rel <= 1e-4 if method == "grand_last_layer"
              else bool(np.all((err <= 1e-5 * np.abs(plain)) | (err <= 1e-6))))
        out[method]["fp32_rel_err_vs_plain_route"] = rel
        print(f"  resnet50 {method} fp32 kernel route vs plain route ({R50_N} examples): "
              f"max rel err {rel:.3e}, max abs err {float(err.max()):.3e}", flush=True)
        check(ok, f"resnet50 {method}: kernel route vs plain route rel err {rel:.3e}")
    port["set_parity_mode"](False)
    details_out["resnet50"] = out
    return {"counts": counts}


# Train phase: full-width ResNet-18, bf16, batch 128, synthetic CIFAR-10-geometry data.
TRAIN_N = 8192
TRAIN_B = 128
# The fit's final test accuracy must beat chance (1/10) by this much. The same recipe
# on the CPU in fp32 at 1,024 examples (2 epochs, 16 steps: ``cli train --device cpu``
# with these overrides and train.half_precision=false) reached 0.707.
TRAIN_ACC_MARGIN = 0.3
REPRO_N = 2560          # 20 steps of TRAIN_B
RESUME_N = 1024         # 8 steps an epoch
PARITY_N = 80           # batches of 32, 32 and a padded tail of 16
PARITY_B = 32
TIMED_STEPS = 20
# Checkpoints of the train phase (a ResNet-18 step is ~135 MB): in the ignored
# chip_smoke_out/ of the checkout, never in --out, and removed after the phase.
TRAIN_CKPT_DIR = os.path.join(REPO, "chip_smoke_out", "train_ckpt")


def train_cfg(port, *over):
    """The BASELINE ResNet-18 recipe (``configs/cifar10_resnet18.yaml``: lr 0.01,
    momentum 0.9, weight decay 5e-4, bf16) on synthetic CIFAR-10-geometry data."""
    return port["load_config"](os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={TRAIN_N}",
        f"data.batch_size={TRAIN_B}", "score.pretrain_epochs=0", *over])


def north_star_cfg(port, checkpoint_dir: str, n: int = TRAIN_N, *over):
    """The north-star ``configs/cifar10_resnet18_grand10.yaml`` at ``n`` synthetic
    examples, seeds [0, 1] and 2 retrain epochs."""
    return port["load_config"](
        os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml"),
        ["data.dataset=synthetic", f"data.synthetic_size={n}", "score.seeds=[0,1]",
         "train.num_epochs=2", f"train.checkpoint_dir={checkpoint_dir}", *over])


def ckpt_arrays(directory: str, step: int | None = None) -> tuple[int, dict]:
    """A checkpoint step's arrays as saved (the newest step by default)."""
    if step is None:
        step = max(int(n[len("step_"):]) for n in os.listdir(directory)
                   if n.startswith("step_") and n[len("step_"):].isdigit())
    with np.load(os.path.join(directory, f"step_{step}", "arrays.npz")) as f:
        return step, {k: f[k] for k in f.files}


def arrays_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def state_equal(torch, a, b) -> bool:
    return a.step == b.step and all(
        torch.equal(getattr(a, g)[k], getattr(b, g)[k])
        for g in ("params", "batch_stats", "momentum") for k in getattr(a, g))


def step_ms(torch, port, cfg, ds, deterministic: bool) -> float:
    """Host wall per train step over ``TIMED_STEPS`` steps (after 3 warm-up
    steps), ending in a synchronize, with cuDNN's deterministic algorithms or
    with its autotuned ones; the determinism switches are restored after."""
    T = port["train"]
    model = port["create_model_from_cfg"](cfg).to("cuda")
    state = T["create_train_state"](cfg, 0, "cuda", model)
    sgd = T["make_optimizer"](cfg, 64)
    batches = list(T["ResidentBatches"](ds, TRAIN_B, "cuda", torch.bfloat16)())
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = not deterministic
    try:
        for b in batches[:3]:
            T["train_step"](model, sgd, state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            T["train_step"](model, sgd, state, batches[i % len(batches)])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    finally:
        port["set_scoring_determinism"]()


def train_phase(torch, port, details_out, card: str) -> dict:
    """Training on the card: a fit, its reproducibility and resume, the card
    against the CPU, the north-star ``run`` (its scoring launches counted),
    and every kernel route against its plain route on pretrained weights.
    Checkpoints go to ``TRAIN_CKPT_DIR`` and are removed after."""
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        return _train_phase(torch, port, details_out, card)
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
        print(f"  train phase: {time.perf_counter() - t0:.1f} s", flush=True)


def _train_phase(torch, port, details_out, card: str) -> dict:
    T = port["train"]
    K = port["kernels"]
    rec: dict = {}
    cfg = train_cfg(port, "train.num_epochs=2")
    train_ds, test_ds = T["load_data_for"](cfg)
    steps_per_epoch = -(-TRAIN_N // TRAIN_B)

    # 1. Fit: 2 epochs with eval; epoch 1 is the steady one.
    res = T["fit"](cfg, train_ds, test_ds, device="cuda")
    hist = res.history
    for h in hist:
        print(f"  fit epoch {h['epoch']}: {h['examples_per_s']:.1f} ex/s "
              f"({h['epoch_s']:.3f} s), train loss {h['train_loss']:.4f}, "
              f"test accuracy {h['test_accuracy']:.4f} on {card}", flush=True)
    steady_step_ms = 1e3 * hist[1]["epoch_s"] / steps_per_epoch
    model = port["create_model_from_cfg"](cfg).to("cuda")
    resident = T["maybe_resident"](test_ds, cfg.data.eval_batch_size, "cuda",
                                   torch.bfloat16, enabled=True)
    T["evaluate"](model, res.state, test_ds, cfg.data.eval_batch_size, device="cuda",
                  resident=resident)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = T["evaluate"](model, res.state, test_ds, cfg.data.eval_batch_size,
                       device="cuda", resident=resident)
    eval_s = time.perf_counter() - t0
    eval_rate = len(test_ds) / eval_s
    print(f"  steady train step {steady_step_ms:.3f} ms (batch {TRAIN_B}, bf16); eval "
          f"{eval_rate:.1f} ex/s ({len(test_ds)} examples, batch "
          f"{cfg.data.eval_batch_size})", flush=True)
    check(hist[1]["train_loss"] < hist[0]["train_loss"],
          f"train loss did not fall: {[h['train_loss'] for h in hist]}")
    check(hist[-1]["test_accuracy"] > 0.1 + TRAIN_ACC_MARGIN,
          f"test accuracy {hist[-1]['test_accuracy']} not above chance + "
          f"{TRAIN_ACC_MARGIN}")
    check(ev["accuracy"] == hist[-1]["test_accuracy"], "evaluate disagrees with fit")
    rec["fit"] = {"history": hist, "steady_step_ms": steady_step_ms,
                  "eval_examples_per_s": eval_rate}

    # 2. Reproducibility: two fits of 20 steps from one seed, bitwise; and what
    # the deterministic cuDNN algorithms cost (deterministic, autotuned, autotuned,
    # deterministic).
    small = train_ds.subset(train_ds.indices[:REPRO_N])
    runs = [T["fit"](cfg, small, None, device="cuda", num_epochs=1, seed=3)
            for _ in range(2)]
    check(state_equal(torch, runs[0].state, runs[1].state),
          "two fits from one seed differ on the card")
    det = {True: [], False: []}
    for flag in (True, False, False, True):
        det[flag].append(step_ms(torch, port, cfg, small, flag))
    print(f"  reproducible: two 20-step fits from one seed bitwise equal; train step "
          f"{statistics.median(det[True]):.3f} ms with deterministic cuDNN "
          f"({det[True]}), {statistics.median(det[False]):.3f} ms autotuned "
          f"({det[False]})", flush=True)
    rec["step_ms_deterministic"] = det[True]
    rec["step_ms_autotuned"] = det[False]

    # 3. Resume: fit(2) == fit(1) + resume(1), through the port's checkpoint.
    rcfg = train_cfg(port, "train.num_epochs=2", "optim.cosine_t_max_epochs=2",
                     "data.augment=true")
    rds = train_ds.subset(train_ds.indices[:RESUME_N])
    whole = T["fit"](rcfg, rds, None, device="cuda")
    ckpt = os.path.join(TRAIN_CKPT_DIR, "resume")
    T["fit"](rcfg, rds, None, device="cuda", num_epochs=1, checkpoint_dir=ckpt)
    rcfg.train.resume = True
    rest = T["fit"](rcfg, rds, None, device="cuda", checkpoint_dir=ckpt)
    check([h["epoch"] for h in rest.history] == [1], "resume did not start at epoch 1")
    check(state_equal(torch, rest.state, whole.state),
          "fit(1) + resume(1) differs from fit(2) on the card")
    print(f"  resume: fit(2) == fit(1) + resume(1) bitwise ({RESUME_N} examples, "
          "augmented)", flush=True)

    # 4. The card against the CPU: 3 fp32 train steps, TF32 off, one padded tail;
    # and the CPU in float64, which measures fp32's own error on this net.
    port["set_parity_mode"](True)
    pcfg = train_cfg(port, "train.half_precision=false", "train.num_epochs=1",
                     f"data.batch_size={PARITY_B}")
    pds = train_ds.subset(train_ds.indices[:PARITY_N])
    v = bn_randomized(torch, port, 11, "cpu")
    results = {}
    for label, dev, dtype in (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                              ("f64", "cpu", torch.float64)):
        model = port["create_model_from_cfg"](pcfg).to(dev, dtype)
        model.dtype = dtype
        state = T["state_from_variables"](
            {k: t.to(dtype) for k, t in port["variables_to"](v, dev).items()}, model)
        sgd = T["make_optimizer"](pcfg, 3)
        losses = []
        for b in T["iterate_batches"](pds, PARITY_B):
            b = {k: (t.to(dtype) if t.is_floating_point() else t)
                 for k, t in T["to_device"](b, dev).items()}
            losses.append(float(T["train_step"](model, sgd, state, b)["loss"]))
        results[label] = (losses, {k: t.cpu().double() for k, t in state.variables.items()})
    port["set_parity_mode"](False)
    (l_gpu, v_gpu), (l_cpu, v_cpu), (_, v_64) = (results[k] for k in ("cuda", "cpu", "f64"))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    # fp32's own error here: the CPU fp32 run's largest distance from float64.
    eps_cpu = max(float((v_cpu[k] - v_64[k]).abs().max()) for k in v_64)
    eps_gpu = max(float((v_gpu[k] - v_64[k]).abs().max()) for k in v_64)
    atol = max(1e-6, 2 * eps_cpu)
    var_err, worst = max((float(((v_gpu[k] - v_cpu[k]).abs() - 1e-4 * v_cpu[k].abs()).max()),
                          k) for k in v_cpu)
    print(f"  card vs CPU, 3 fp32 steps (TF32 off, tail of {PARITY_N % PARITY_B}): losses "
          f"{l_gpu} vs {l_cpu}, max rel {loss_rel:.3e}; variables: max |d| - 1e-4|cpu| "
          f"{var_err:.3e} ({worst}); from float64: card {eps_gpu:.3e}, CPU {eps_cpu:.3e}",
          flush=True)
    check(loss_rel <= 1e-5, f"card vs CPU loss rel err {loss_rel:.3e}")
    check(var_err <= atol, f"card vs CPU variables beyond rtol 1e-4 / atol {atol:.3e} "
                           f"({var_err:.3e}, {worst})")
    check(eps_gpu <= atol, f"card fp32 {eps_gpu:.3e} from float64, CPU fp32 {eps_cpu:.3e}")
    rec["card_vs_cpu"] = {"loss_rel": loss_rel, "var_excess": var_err, "worst": worst,
                          "card_from_f64": eps_gpu, "cpu_from_f64": eps_cpu}

    # 5. The north-star run at 8,192 examples, 2 seeds, 2 epochs of retrain.
    run_cfg = north_star_cfg(port, os.path.join(TRAIN_CKPT_DIR, "run"))
    nb = -(-TRAIN_N // run_cfg.score.batch_size)
    K.reset_launch_counts()
    modes0 = K.mode_counts()
    t0 = time.perf_counter()
    summary = T["run_datadiet"](run_cfg, device="cuda")
    run_wall = time.perf_counter() - t0
    counts = K.launch_counts()
    want = dict.fromkeys(K.KERNELS, 0)
    want.update(conv_grad_norm_direct=12 * nb * 2, conv_grad_norm_gram=3 * nb * 2)
    check(counts == want, f"run: launch counts {counts}, want {want}")
    for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram"):
        check_modes(K, modes0[kern], want[kern], "tensor_core", "run", kern)
    npz = T["scores_npz_path"](run_cfg.train.checkpoint_dir)
    with np.load(npz) as f:
        kept = f["kept"]
        check(bool(np.isfinite(f["scores"]).all()), "run: non-finite scores")
    T["verify_prune_manifest"](npz, kept)
    check(summary["n_kept"] == TRAIN_N // 2 == len(kept), f"run: n_kept {summary['n_kept']}")
    check(summary["final_test_accuracy"] is not None
          and bool(np.isfinite(summary["final_test_accuracy"])),
          f"run: final test accuracy {summary['final_test_accuracy']}")
    walls = {k: summary[k] for k in ("pretrain_wall_s", "score_wall_s", "prune_wall_s",
                                     "train_wall_s")}
    print(f"  run ({TRAIN_N} examples, seeds [0, 1], score batch "
          f"{run_cfg.score.batch_size}, grand): {run_wall:.3f} s; stages "
          + ", ".join(f"{k[:-7]} {v:.3f} s" for k, v in walls.items())
          + f"; n_kept {summary['n_kept']}, final test accuracy "
          f"{summary['final_test_accuracy']:.4f}; launches {counts} (tensor-core mode); "
          "prune manifest verified", flush=True)
    rec["run"] = {"wall_s": run_wall, **walls, "n_kept": summary["n_kept"],
                  "final_test_accuracy": summary["final_test_accuracy"],
                  "launches": counts}
    # What the resilience phase's drills must reproduce bitwise.
    with np.load(npz) as f:
        run_art = {"scores": f["scores"], "kept": f["kept"], "walls": walls,
                   "arrays": ckpt_arrays(run_cfg.train.checkpoint_dir)[1]}

    # 6. Each kernel route against the plain route on the pretrained seed-0
    # variables, fp32, TF32 off: rtol 1e-4 (atol 1e-6 for EL2N, whose scores of
    # well-fit examples sit near 0).
    pretrained = T["score_variables_for_seeds"](run_cfg, train_ds, device="cuda",
                                                seeds=[0])
    port["set_parity_mode"](True)
    model32 = port["create_model"]("resnet18", 10)
    sub = train_ds.subset(train_ds.indices[:2 * B])
    rec["trained_parity"] = {}
    for method, eval_mode, atol in (("el2n", True, 1e-6), ("grand", True, 0.0),
                                    ("grand_last_layer", True, 0.0),
                                    ("el2n", False, 1e-6)):
        kw = dict(method=method, batch_size=B, eval_mode=eval_mode, device="cuda")
        fast = port["score_dataset"](model32, pretrained, sub, use_kernels=True, **kw)
        plain = port["score_dataset"](model32, pretrained, sub, use_kernels=False, **kw)
        err = np.abs(fast - plain)
        rel = float(np.max(err / np.maximum(np.abs(plain), 1e-30)))
        what = f"{method} ({'eval' if eval_mode else 'train'} mode)"
        print(f"  trained weights, {what}: kernel route vs plain route max rel err "
              f"{rel:.3e}, max abs err {float(err.max()):.3e}", flush=True)
        check(bool(np.all(err <= 1e-4 * np.abs(plain) + atol)),
              f"trained weights, {what}: kernel route vs plain route rel err {rel:.3e}")
        rec["trained_parity"][what] = {"max_rel": rel, "max_abs": float(err.max())}
    port["set_parity_mode"](False)
    details_out["train"] = rec
    return {"counts": counts, "run": run_art}


# Resilience phase: the north-star run preempted, resumed and corrupted on the card.
CHUNK_N = 3200          # 25 steps of TRAIN_B an epoch: a chunk of 16 and a tail of 9
CHUNK_K = 16            # train.chunk_steps null resolves to DEFAULT_CHUNK_STEPS
CHUNK_RUN_N = 4096      # (d): the north-star cli run
CHUNK_ROOT = os.path.join(REPO, "chip_smoke_out", "chunked")
CHUNK_TIMED = 4         # (a): train chunks replayed back to back for the device time


def _strip_walls(history: list[dict]) -> list[dict]:
    return [{k: v for k, v in h.items() if k not in ("epoch_s", "examples_per_s")}
            for h in history]


def chunked_phase(torch, port, details_out, card: str) -> dict:
    """The chunked engine on the card (phase 8a); see the module docstring.
    Files in ``CHUNK_ROOT`` (removed after)."""
    shutil.rmtree(CHUNK_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        return _chunked_phase(torch, port, details_out, card)
    finally:
        shutil.rmtree(CHUNK_ROOT, ignore_errors=True)
        print(f"  chunked phase: {time.perf_counter() - t0:.1f} s", flush=True)


def _chunked_phase(torch, port, details_out, card: str) -> dict:
    T, K, C = port["train"], port["kernels"], port["chunked"]
    reg = port["serve"]["registry"]
    rec: dict = {"card": card}
    details_out["chunked"] = rec
    registry = reg.install(reg.MetricsRegistry())
    # A logger object: with a registry installed a fit snapshots into it.
    log = port["serve"]["MetricsLogger"](None, echo=False)
    try:
        # (a) Fit: 2 epochs of 25 steps, augmented, chunked (null -> 16: a body
        # graph and a tail graph) against per step, bitwise.
        cfg = train_cfg(port, "train.num_epochs=2", "data.augment=true",
                        f"data.synthetic_size={CHUNK_N}")
        train_ds, test_ds = T["load_data_for"](cfg)
        spe = -(-CHUNK_N // TRAIN_B)
        runs = {}
        for label, over in (("chunked", None), ("per_step", 1), ("chunked2", None)):
            c = copy.deepcopy(cfg)
            c.train.chunk_steps = over
            runs[label] = T["fit"](c, train_ds, test_ds, device="cuda", log=log)
        a, b = runs["chunked"], runs["per_step"]
        check(a.chunk_steps == CHUNK_K and b.chunk_steps == 1,
              f"engines: chunk_steps {a.chunk_steps} and {b.chunk_steps}")
        check(state_equal(torch, a.state, b.state),
              "(a) the chunked fit's state differs from the per-step fit's")
        check(_strip_walls(a.history) == _strip_walls(b.history),
              f"(a) histories differ: {a.history} vs {b.history}")
        check(state_equal(torch, a.state, runs["chunked2"].state),
              "(a) two chunked fits differ")
        fit = {label: {"examples_per_s": r.history[1]["examples_per_s"],
                       "step_ms": 1e3 * r.history[1]["epoch_s"] / spe,
                       "epoch_s": r.history[1]["epoch_s"]} for label, r in runs.items()}
        # The device time of a train step: chunk replays back to back between
        # CUDA events, on a throwaway state (the fit's graphs are released).
        model = port["create_model_from_cfg"](cfg).to("cuda")
        state = T["create_train_state"](cfg, 0, "cuda", model)
        sgd = T["make_optimizer"](cfg, spe)
        resident = T["ResidentBatches"](train_ds, TRAIN_B, "cuda", torch.bfloat16)
        augment = (cfg.data.crop_pad, cfg.data.flip, cfg.train.seed)
        prog = C["make_train_chunk"](model, sgd, state, resident, CHUNK_K, augment)
        idx, mask = next(resident.chunk_indices(CHUNK_K, shuffle=True, seed=0, epoch=0))

        def chunk():
            C["dispatch_train_chunk"](prog, state, C["chunk_inputs"](sgd, state.step, idx,
                                                                    mask, augment))
        t_cap = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        capture_wall = time.perf_counter() - t_cap
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CHUNK_TIMED):
            chunk()
        end.record()
        torch.cuda.synchronize()
        device_step_ms = start.elapsed_time(end) / (CHUNK_TIMED * CHUNK_K)
        train_pool = prog.pool_bytes
        prog.release()
        for label in fit:
            fit[label]["device_busy"] = min(1.0, device_step_ms / fit[label]["step_ms"])
        rec.update(fit=fit, device_step_ms=device_step_ms, train_capture_s=prog.capture_s,
                   train_capture_wall_s=capture_wall, train_pool_bytes=train_pool)
        print(f"  (a) fit: chunked (K={CHUNK_K}, body + tail of {spe % CHUNK_K}) bitwise the "
              f"per-step fit over 2 epochs of {spe} steps (state and history, augmented); "
              "steady epoch " + ", ".join(
                  f"{k} {v['examples_per_s']:.1f} ex/s, step {v['step_ms']:.3f} ms, device "
                  f"busy {v['device_busy']:.3f}" for k, v in fit.items())
              + f"; device {device_step_ms:.3f} ms a step (CUDA events over "
              f"{CHUNK_TIMED} replays); capture of a {CHUNK_K}-step chunk "
              f"{prog.capture_s:.3f} s (warm-up, capture, first replay), pool "
              f"{train_pool / 2**20:.1f} MiB on {card}", flush=True)

        # (b) Evaluate: 25 batches of the train set, chunked (16 + 9) and per batch.
        ev = {}
        eval_graphs = C["GraphCache"]()   # as a fit keeps its eval captures
        for label, k in (("chunked", CHUNK_K), ("per_batch", 1), ("chunked2", CHUNK_K),
                         ("per_batch2", 1)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ev[label] = T["evaluate"](model, a.state, train_ds, TRAIN_B, device="cuda",
                                      resident=resident, chunk_steps=k,
                                      graphs=eval_graphs if k > 1 else None)
            ev[label]["wall_s"] = time.perf_counter() - t1
        eval_graphs.release()
        check({k: v for k, v in ev["chunked"].items() if k != "wall_s"}
              == {k: v for k, v in ev["per_batch"].items() if k != "wall_s"},
              f"(b) chunked eval differs: {ev}")
        rec["eval"] = ev
        print(f"  (b) evaluate: chunked bitwise per batch ({ev['chunked']['examples']} "
              f"examples, batch {TRAIN_B}); {CHUNK_N / ev['chunked']['wall_s']:.1f} ex/s "
              f"chunked with its captures, {CHUNK_N / ev['chunked2']['wall_s']:.1f} ex/s "
              f"replayed, {CHUNK_N / ev['per_batch2']['wall_s']:.1f} ex/s per batch",
              flush=True)

        # (c) Score: GraNd (default route) and EL2N over N_PATH x SEEDS at B,
        # one replay of K = 16 a seed, bitwise the per-batch pass; the launches
        # of the counted chunked pass exactly the per-batch pass's.
        ds, _ = port["load_dataset"]("synthetic", synthetic_size=N_PATH, seed=0)
        score_model = port["create_model_from_cfg"](port["load_config"](
            os.path.join(REPO, "configs", "cifar10_resnet18.yaml"),
            ["data.dataset=synthetic", "train.half_precision=true"]))
        seeds = [port["init_variables"]("resnet18", s, "cuda") for s in SEEDS]
        graphs = C["GraphCache"]()
        score = {}
        for method in ("grand", "el2n"):
            kw = dict(method=method, batch_size=B, device="cuda", device_resident=True)
            walls, counts, got = {}, {}, {}
            for label, k, cache in (("warm", None, graphs), ("per_batch", 1, None),
                                    ("chunked", None, graphs), ("per_batch2", 1, None),
                                    ("chunked2", None, graphs)):
                K.reset_launch_counts()
                before = registry.snapshot()["counters"]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got[label] = port["score_dataset"](score_model, seeds, ds, chunk_steps=k,
                                                   graphs=cache, **kw)
                walls[label] = time.perf_counter() - t1
                after = registry.snapshot()["counters"]
                counts[label] = K.launch_counts()
                if label == "chunked":
                    d = after.get("dispatches_score_chunk", 0) - before.get(
                        "dispatches_score_chunk", 0)
                    r = after.get("graph_replays:score_chunk", 0) - before.get(
                        "graph_replays:score_chunk", 0)
                    check(d == len(SEEDS) and r == d,
                          f"(c) {method}: {d} chunk dispatches, {r} replays; want "
                          f"{len(SEEDS)} each (one K = 16 replay a seed)")
            for label in ("warm", "chunked", "chunked2", "per_batch2"):
                check(np.array_equal(got[label], got["per_batch"]),
                      f"(c) {method}: the {label} pass differs from the per-batch pass")
            batches = (N_PATH // B) * len(SEEDS)
            want = ({"conv_grad_norm_direct": 12 * batches, "conv_grad_norm_gram": 3 * batches}
                    if method == "grand" else {"el2n": batches})
            for kern, n in want.items():
                check(counts["chunked"][kern] == n == counts["per_batch"][kern],
                      f"(c) {method}: {kern} launched {counts['chunked'][kern]} times "
                      f"chunked, {counts['per_batch'][kern]} per batch; want {n}")
            score[method] = {
                "examples_per_s": {lbl: N_PATH * len(SEEDS) / walls[lbl] for lbl in walls},
                "counts": {k2: counts["chunked"][k2] for k2 in want}}
            print(f"  (c) {method}: chunked bitwise per batch ({N_PATH} x {len(SEEDS)} seeds, "
                  f"batch {B}, one K = {N_PATH // B} replay a seed); launches "
                  f"{score[method]['counts']} = per batch; ex/s " + ", ".join(
                      f"{lbl} {v:.1f}" for lbl, v in score[method]["examples_per_s"].items()),
                  flush=True)
        rec["score"] = score
        rec["score_programs"] = graphs.stats()
        print("  (c) score captures: " + ", ".join(
            f"{st['key']} capture {st['capture_s']:.3f} s, pool "
            f"{st['pool_bytes'] / 2**20:.1f} MiB, {st['replays']} replays"
            for st in rec["score_programs"]), flush=True)
        graphs.release()

        # (d) cli run: the north-star at CHUNK_RUN_N with the chunk defaults.
        K.reset_launch_counts()
        before = registry.snapshot()["counters"]
        rc, summary, recs = run_cli(port, [
            "run", "--config", os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml"),
            "data.dataset=synthetic", f"data.synthetic_size={CHUNK_RUN_N}",
            "score.seeds=[0,1]", "train.num_epochs=2",
            f"train.checkpoint_dir={CHUNK_ROOT}/run", "--device", "cuda"])
        check(rc == 0 and summary is not None, f"(d) cli run exited {rc}")
        chunked = [r for r in recs if r["kind"] == "train_chunked"]
        check(chunked and all(r["chunk_steps"] == CHUNK_K for r in chunked),
              f"(d) train_chunked records: {chunked}")
        counts = K.launch_counts()
        check(counts["conv_grad_norm_direct"] > 0 and counts["conv_grad_norm_gram"] > 0,
              f"(d) the run's scoring launched no GraNd kernel: {counts}")
        rec["cli_run"] = {"train_chunked": chunked, "counts": counts}
        print(f"  (d) cli run (north-star at {CHUNK_RUN_N}, seeds [0, 1], chunk defaults): "
              f"{len(chunked)} fits chunked at K = {CHUNK_K}; launches {counts}", flush=True)

        # (e) Counters: every program's replays equal its dispatches (cuda).
        snap = registry.snapshot()["counters"]
        for prog_name in ("train_chunk", "eval_chunk", "score_chunk"):
            disp = snap.get(f"dispatches_{prog_name}", 0)
            reps = snap.get(f"graph_replays:{prog_name}", 0)
            check(disp > 0 and reps == disp,
                  f"(e) {prog_name}: {disp} dispatches, {reps} graph replays")
        rec["counters"] = {k: v for k, v in snap.items()
                           if k.startswith(("dispatches_", "graph_"))}
        print(f"  (e) replays equal dispatches: {rec['counters']}", flush=True)
        return {"counts": counts}
    finally:
        reg.uninstall()


RES_DIR = os.path.join(REPO, "chip_smoke_out", "resilience_ckpt")
HANG_TIMEOUT_S = 10      # resilience.step_timeout_s of drill E
HANG_WALL_S = 60         # drill E's whole fit_with_recovery must end within this
G_N = 1024               # drill G's examples (two CLI processes)
OVERHEAD_PAIRS = 1


class Events:
    """A ``log(kind, **fields)`` callable that keeps every record."""

    def __init__(self):
        self.records: list[dict] = []

    def __call__(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def of(self, kind: str) -> list[dict]:
        return [e for e in self.records if e["kind"] == kind]


def expect_preempted(port, fn):
    """``fn()`` must raise ``Preempted``; returns it."""
    try:
        fn()
    except port["Preempted"] as p:
        return p
    fail(f"{fn}: no Preempted raised")


def with_plan(port, plan: dict, fn):
    inject = port["inject"]
    inject.activate(inject.plan_from_dict(plan))
    try:
        return fn()
    finally:
        inject.deactivate()


def counted(K, fn):
    """``fn()`` with the launch counts set to 0 just before and read just after:
    (result, counts, mode counts before)."""
    K.reset_launch_counts()
    modes0 = K.mode_counts()
    out = fn()
    return out, K.launch_counts(), modes0


def resilience_phase(torch, port, details_out, trained: dict) -> dict:
    """The resilience core on the card (drills A-G and the hooks' overhead).
    Checkpoints go to ``RES_DIR`` and are removed after. Drill G runs in
    processes of its own beside drills A-F (they share only the card) and is
    read before the hooks' overhead is timed."""
    shutil.rmtree(RES_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()   # room on the card for G's processes
    g_procs: list = []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        drill_g = pool.submit(run_drill_g, g_procs)
        try:
            return _resilience_phase(torch, port, details_out, trained, drill_g)
        finally:
            for proc in g_procs:
                if proc.poll() is None:
                    proc.kill()
            shutil.rmtree(RES_DIR, ignore_errors=True)
            wall = time.perf_counter() - t0
            details_out.setdefault("resilience", {})["phase_wall_s"] = wall
            print(f"  resilience phase: {wall:.1f} s", flush=True)


def run_drill_g(procs: list) -> list[float]:
    """Drill G: the real command line in a process of its own exits 75 under a
    fault plan, then the same command finishes. Returns the two walls; each
    process is appended to ``procs`` as it starts."""
    dir_g = os.path.join(RES_DIR, "g")
    cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "run",
           "--config", os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml"),
           "data.dataset=synthetic", f"data.synthetic_size={G_N}", "score.seeds=[0,1]",
           "train.num_epochs=2", f"train.checkpoint_dir={dir_g}"]
    env = {k: v for k, v in os.environ.items() if k != "DDT_FAULT_PLAN"}
    env["PYTHONPATH"] = REPO
    walls = []
    for plan in ('{"sigterm_after_seed_scores": 1}', None):
        t1 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env={**env, "DDT_FAULT_PLAN": plan} if plan else env)
        procs.append(proc)
        stdout, stderr = proc.communicate(timeout=300)
        walls.append(time.perf_counter() - t1)
        if plan:
            check(proc.returncode == 75 and "[preempted]" in stdout,
                  f"G: exit {proc.returncode}, stdout {stdout[-300:]!r}, "
                  f"stderr {stderr[-1500:]!r}")
        else:
            check(proc.returncode == 0, f"G rerun: exit {proc.returncode}, "
                                        f"stderr {stderr[-1500:]!r}")
            out = json.loads(stdout.strip().splitlines()[-1])
            check(out["event"] == "run_done" and out["n_kept"] == G_N // 2,
                  f"G rerun: {out}")
    return walls


def _resilience_phase(torch, port, details_out, trained: dict, drill_g) -> dict:
    T, K = port["train"], port["kernels"]
    rec: dict = {}
    details_out["resilience"] = rec
    total = dict.fromkeys(K.KERNELS, 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # A. Preempt mid-scoring (after seed 0's partial), then re-invoke: only seed
    # 1 is pretrained and scored, and everything equals the train phase's run.
    dir_a = os.path.join(RES_DIR, "a")
    cfg = north_star_cfg(port, dir_a)
    nb = -(-TRAIN_N // cfg.score.batch_size)
    one_seed = dict.fromkeys(K.KERNELS, 0)
    one_seed.update(conv_grad_norm_direct=12 * nb, conv_grad_norm_gram=3 * nb)
    p, counts, modes0 = counted(K, lambda: with_plan(
        port, {"sigterm_after_seed_scores": 1},
        lambda: expect_preempted(port, lambda: T["run_datadiet"](cfg, device="cuda"))))
    add(counts)
    check(counts == one_seed, f"A, preempted pass: launches {counts}, want {one_seed}")
    parts = sorted(os.listdir(f"{dir_a}_score_partials"))
    manifest = port["StageManifest"](f"{dir_a}_stages.json",
                                     T["pipeline_fingerprint"](cfg))
    check(parts == ["seed0.npz"] and not manifest.completed("score"),
          f"A: partials {parts}, score stage {manifest.status('score')}")
    ev = Events()
    t1 = time.perf_counter()
    summary, counts, modes0 = counted(K, lambda: T["run_datadiet"](
        north_star_cfg(port, dir_a), device="cuda", log=ev))
    wall = time.perf_counter() - t1
    add(counts)
    check(counts == one_seed, f"A, resumed pass: launches {counts}, want {one_seed}")
    for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram"):
        check_modes(K, modes0[kern], one_seed[kern], "tensor_core", "A, resumed", kern)
    resumed = [(e["done"], e["todo"]) for e in ev.of("score_seeds_resumed")]
    check(resumed == [([0], [1])], f"A: score_seeds_resumed {resumed}")
    with np.load(T["scores_npz_path"](dir_a)) as f:
        scores_a, kept_a = f["scores"], f["kept"]
    arrays_a = ckpt_arrays(dir_a)[1]
    run = trained["run"]
    check(np.array_equal(scores_a, run["scores"]), "A: scores differ from the train "
          f"phase's run (max |d| {float(np.abs(scores_a - run['scores']).max()):.3e})")
    check(np.array_equal(kept_a, run["kept"]), "A: kept set differs")
    check(arrays_equal(arrays_a, run["arrays"]), "A: final retrain arrays differ")
    rec["A"] = {"resumed_wall_s": wall, "pretrain_wall_s": summary["pretrain_wall_s"],
                "score_wall_s": summary["score_wall_s"], "launches": counts,
                "uninterrupted": run["walls"]}
    print(f"  A preempt mid-scoring: Preempted after seed 0 ({p.signame}); resumed "
          f"run {wall:.3f} s, pretrain {summary['pretrain_wall_s']:.3f} s, score "
          f"{summary['score_wall_s']:.3f} s (uninterrupted: pretrain "
          f"{run['walls']['pretrain_wall_s']:.3f}, score "
          f"{run['walls']['score_wall_s']:.3f}); launches {counts}, tensor-core; "
          "scores, kept and final arrays bitwise equal", flush=True)

    # B. Preempt the retrain at epoch 0's end (scores reused from A: no
    # pretrain, nothing scored), then re-invoke: retrain:final resumes.
    dir_b = os.path.join(RES_DIR, "b")
    b_over = (f"score.scores_npz={T['scores_npz_path'](dir_a)}",)
    spe = -(-len(kept_a) // cfg.data.batch_size)
    p, counts, _ = counted(K, lambda: with_plan(
        port, {"sigterm_at_epoch_end": 0},
        lambda: expect_preempted(port, lambda: T["run_datadiet"](
            north_star_cfg(port, dir_b, TRAIN_N, *b_over), device="cuda"))))
    add(counts)
    check((p.durable_step, p.epoch) == (spe, 0),
          f"B: Preempted durable_step {p.durable_step} epoch {p.epoch}, want {spe}, 0")
    ev = Events()
    _, counts, _ = counted(K, lambda: T["run_datadiet"](
        north_star_cfg(port, dir_b, TRAIN_N, *b_over), device="cuda", log=ev))
    add(counts)
    check(not any(counts.values()), f"B: launches {counts}, want none")
    stage_ev = [(e["stage"], e["status"]) for e in ev.of("stage")]
    resumes = [(e["step"], e["epoch"]) for e in ev.of("resume")]
    check(("retrain:final", "resuming") in stage_ev and resumes == [(spe, 1)],
          f"B: stage events {stage_ev}, resumes {resumes}")
    step_b, arrays_b = ckpt_arrays(dir_b)
    check(arrays_equal(arrays_b, arrays_a), "B: final arrays differ from A's retrain")
    rec["B"] = {"durable_step": p.durable_step, "resumes": resumes}
    print(f"  B preempt at epoch end: durable step {p.durable_step}; retrain:final "
          f"resumed at step {resumes[0][0]}, epoch 1; final arrays bitwise equal to A's; "
          f"no launches", flush=True)

    # F. Truncate B's newest step: the resume falls back to the step before it.
    port["inject"].truncate_checkpoint(dir_b, step_b)
    cfg_b = north_star_cfg(port, dir_b, TRAIN_N, *b_over, "train.resume=true")
    train_ds, test_ds = T["load_data_for"](cfg_b)
    ev = Events()
    T["fit"](cfg_b, train_ds.subset(kept_a), test_ds, device="cuda", log=ev,
             checkpoint_dir=dir_b, tag="final")
    faults = [(e["fault"], e["step"]) for e in ev.of("fault")]
    resumes = [e["step"] for e in ev.of("resume")]
    check(faults == [("checkpoint_corrupt", step_b)] and resumes == [spe],
          f"F: faults {faults}, resumes {resumes}")
    check(arrays_equal(ckpt_arrays(dir_b)[1], arrays_b), "F: refit differs from B's")
    rec["F"] = {"faults": faults, "resume_step": resumes[0]}
    print(f"  F corrupt checkpoint: step {step_b} truncated, refused "
          f"(checkpoint_corrupt), fell back to step {resumes[0]}; final arrays bitwise "
          "equal to B's", flush=True)

    # C, D, E: plain fits of the recipe on RESUME_N examples (8 steps an epoch).
    small_cfg = train_cfg(port, "train.num_epochs=2", "train.checkpoint_every=1")
    rds = train_ds.subset(train_ds.indices[:RESUME_N])
    spe = -(-RESUME_N // TRAIN_B)
    whole = T["fit"](small_cfg, rds, None, device="cuda")

    # C. SIGTERM before step 2: the final synchronous save at step 3, epoch -1;
    # the resume replays epoch 0 with the counter continuing (at least once).
    dir_c = os.path.join(RES_DIR, "c")
    p = with_plan(port, {"sigterm_at_step": 2}, lambda: expect_preempted(
        port, lambda: T["fit"](small_cfg, rds, None, device="cuda", checkpoint_dir=dir_c)))
    meta = port["CheckpointManager"](dir_c).metrics(3)
    check((p.step, p.durable_step, p.epoch) == (3, 3, -1)
          and meta.get("preempted") is True and meta.get("epoch") == -1,
          f"C: Preempted step {p.step} durable {p.durable_step} epoch {p.epoch}, "
          f"saved metrics {meta}")
    c_cfg = copy.deepcopy(small_cfg)
    c_cfg.train.resume = True
    res = T["fit"](c_cfg, rds, None, device="cuda", checkpoint_dir=dir_c)
    check(res.state.step == 3 + 2 * spe, f"C: resumed to step {res.state.step}, "
          f"want {3 + 2 * spe}")
    rec["C"] = {"step": p.step, "final_step": res.state.step}
    print(f"  C preempt mid-epoch: final save at step 3 (epoch -1, preempted); resumed "
          f"to step {res.state.step} = 3 + 2 x {spe}", flush=True)

    # D. NaN at epoch 1: rollback to epoch 0's step at half the LR, bitwise the
    # fit resumed by hand from that checkpoint with optim.lr halved.
    dir_d = os.path.join(RES_DIR, "d")
    ev = Events()
    res = with_plan(port, {"nan_loss_at_epoch": 1}, lambda: T["fit_with_recovery"](
        small_cfg, rds, None, device="cuda", checkpoint_dir=dir_d, log=ev))
    faults = [e["fault"] for e in ev.of("fault")]
    recov = [(e["cause"], e["resume_step"], e["lr"]) for e in ev.of("recovery")]
    lr = small_cfg.optim.lr * small_cfg.resilience.nan_lr_factor
    check(faults == ["divergence"] and recov == [("divergence", spe, lr)],
          f"D: faults {faults}, recoveries {recov}")
    by_hand = os.path.join(RES_DIR, "d_by_hand")
    shutil.copytree(os.path.join(dir_d, f"step_{spe}"), os.path.join(by_hand, f"step_{spe}"))
    h_cfg = copy.deepcopy(small_cfg)
    h_cfg.optim.lr = lr
    h_cfg.train.resume = True
    want = T["fit"](h_cfg, rds, None, device="cuda", checkpoint_dir=by_hand)
    check(state_equal(torch, res.state, want.state),
          "D: rollback differs from a resume by hand at half the LR")
    rec["D"] = {"faults": faults, "recovery": recov}
    print(f"  D NaN rollback: divergence at epoch 1, resumed at step {spe} with lr {lr}; "
          "bitwise equal to a resume by hand", flush=True)

    # E. A hang in epoch 1: the watchdog turns it into a retry from epoch 0's step.
    dir_e = os.path.join(RES_DIR, "e")
    e_cfg = train_cfg(port, "train.num_epochs=2", "train.checkpoint_every=1",
                      f"resilience.step_timeout_s={HANG_TIMEOUT_S}",
                      "train.auto_resume_retries=1")
    ev = Events()
    t1 = time.perf_counter()
    res = with_plan(port, {"hang_at": spe + 2, "hang_seconds": 600},
                    lambda: T["fit_with_recovery"](e_cfg, rds, None, device="cuda",
                                                   checkpoint_dir=dir_e, log=ev))
    wall = time.perf_counter() - t1
    faults = [e for e in ev.of("fault")]
    check(len(faults) == 1 and faults[0]["fault"] == "hang"
          and "WatchdogTimeout" in faults[0]["error"], f"E: faults {faults}")
    check(wall < HANG_WALL_S, f"E: {wall:.1f} s of wall (limit {HANG_WALL_S})")
    check(state_equal(torch, res.state, whole.state), "E: differs from an uninterrupted fit")
    rec["E"] = {"wall_s": wall, "timeout_s": HANG_TIMEOUT_S}
    print(f"  E hang: WatchdogTimeout after {HANG_TIMEOUT_S} s, retried from step {spe}; "
          f"{wall:.3f} s of wall; bitwise equal to an uninterrupted fit", flush=True)

    # G (started beside A by resilience_phase): the real command line.
    walls = drill_g.result()
    rec["G"] = {"walls_s": walls}
    print(f"  G cli run ({G_N} examples): exit 75 with [preempted] under "
          f"DDT_FAULT_PLAN ({walls[0]:.1f} s), then exit 0, n_kept {G_N // 2} "
          f"({walls[1]:.1f} s)", flush=True)

    # The hooks' cost: fit's steady-epoch ex/s with resilience at its defaults
    # against preemption and the NaN check off, OVERHEAD_PAIRS alternating pairs.
    rates = {"on": [], "off": []}
    for i in range(OVERHEAD_PAIRS):
        for label in (("on", "off") if i % 2 == 0 else ("off", "on")):
            over = (() if label == "on" else
                    ("resilience.preemption=false", "resilience.nan_check=false"))
            hist = T["fit"](train_cfg(port, "train.num_epochs=2", *over), train_ds,
                            None, device="cuda").history
            rates[label].append(hist[1]["examples_per_s"])
    med = {k: statistics.median(v) for k, v in rates.items()}
    rec["overhead"] = {"examples_per_s": rates, "median": med,
                       "ratio_on_off": med["on"] / med["off"]}
    print(f"  hooks: steady epoch {med['on']:.1f} ex/s on vs {med['off']:.1f} off "
          f"(ratio {med['on'] / med['off']:.4f}; on {rates['on']}, off {rates['off']})",
          flush=True)
    return {"counts": total}


# Data phase: BASELINE config 5 (configs/imagenet_resnet50_grand.yaml: ResNet-50 with
# the imagenet stem, GraNd, batch 256) on synthetic_imagenet data (96x96, 100 classes:
# no ImageNet subset is in the repo), written by the port as npz, npy and shards.
DATA_ROOT = os.path.join(REPO, "chip_smoke_out", "data")
DATA_CONFIG = os.path.join(REPO, "configs", "imagenet_resnet50_grand.yaml")
DATA_N = 2048                 # train examples; the test split is the generator's 1,024
DATA_B = 256                  # config 5's data.batch_size and score.batch_size
DATA_CLASSES = 100
DATA_SHARD = 512              # rows a shard: 4 train shards, 2 test
DATA_CACHE = 2 * DATA_SHARD * 96 * 96 * 3   # two decoded shards: the cache must evict
DATA_PARITY_N = 512           # the fp32 comparisons' examples (two batches)
DATA_FIT_N = 2048             # 8 steps an epoch at batch 256: a 2-epoch fit is 16 steps
DATA_TORN_SHARD = 1


def quantize_u8(x: np.ndarray) -> np.ndarray:
    """synthetic_imagenet's float images as uint8 ([-4, 4] onto 0..255)."""
    return np.clip(np.rint((x + 4.0) * (255.0 / 8.0)), 0, 255).astype(np.uint8)


def write_data_planes(port, train, test) -> dict:
    """The uint8 quantization of ``train``/``test`` written three times: npz
    splits (stats derived at load), the same splits as ``.npy`` with the same
    stats in ``stats.npz``, and ``DATA_SHARD``-row shards with them in the
    manifest. Returns the three directories."""
    D = port["data"]
    q = {"train": quantize_u8(train.images), "test": quantize_u8(test.images)}
    labels = {"train": train.labels, "test": test.labels}
    norm = D["channel_stats"](q["train"])
    dirs = {k: os.path.join(DATA_ROOT, k) for k in ("npz", "npy", "shards")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for s in ("train", "test"):
        np.savez(os.path.join(dirs["npz"], f"{s}.npz"), images=q[s], labels=labels[s])
        np.save(os.path.join(dirs["npy"], f"{s}_images.npy"), q[s])
        np.save(os.path.join(dirs["npy"], f"{s}_labels.npy"), labels[s])
    np.savez(os.path.join(dirs["npy"], "stats.npz"), mean=norm[0], std=norm[1])
    splits = {s: D["write_split"](dirs["shards"], s, q[s], labels[s], DATA_SHARD)
              for s in ("train", "test")}
    D["write_manifest"](dirs["shards"], splits, DATA_CLASSES, norm)
    return dirs


def tool_planes(dirs: dict, root: str, shard_size: int) -> dict:
    """The npy and shard planes built again from ``dirs["npz"]`` by the port's
    ``tools.npz_to_npy`` and ``tools.make_shards``, two subprocesses at once
    on this host, under ``root``; each array, shard and manifest entry is held
    bitwise to the inline writer's in ``dirs``. Returns the tools' wall and
    the manifests' digests."""
    out = {"npy": os.path.join(root, "npy_tool"), "shards": os.path.join(root, "shards_tool")}
    tool = "data_diet_distributed_tpu_torch.tools."
    cmds = {"npy": [sys.executable, "-m", tool + "npz_to_npy", "--data-dir", dirs["npz"],
                    "--out", out["npy"]],
            "shards": [sys.executable, "-m", tool + "make_shards", dirs["npz"], "--out",
                       out["shards"], "--shard-size", str(shard_size)]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    for k, p in procs.items():
        text, _ = p.communicate(timeout=600)
        check(p.returncode == 0, f"tools ({k}) exited {p.returncode}: {text[-2000:]}")
    wall = time.perf_counter() - t0

    def arrays(path: str) -> dict:
        if path.endswith(".npz"):
            with np.load(path) as f:
                return {k: f[k] for k in f.files}
        return {"": np.load(path)}

    names = sorted(os.listdir(dirs["npy"]))
    check(sorted(os.listdir(out["npy"])) == names, f"tools npy plane: {os.listdir(out['npy'])}")
    for name in names:
        a, b = arrays(os.path.join(dirs["npy"], name)), arrays(os.path.join(out["npy"], name))
        check(a.keys() == b.keys() and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                                           for k in a),
              f"tools npy plane: {name} is not bitwise the inline writer's")
    manifests = {}
    for side, d in (("inline", dirs["shards"]), ("tool", out["shards"])):
        with open(os.path.join(d, "manifest.json")) as fh:
            manifests[side] = json.load(fh)
    conversion = manifests["tool"].pop("conversion", None)
    check(manifests["tool"] == manifests["inline"],
          "tools shard plane: the manifest differs from the inline writer's")
    files = sorted(os.listdir(dirs["shards"]))
    check(sorted(os.listdir(out["shards"])) == files,
          f"tools shard plane: {os.listdir(out['shards'])}")
    for name in files:
        if name != "manifest.json":
            with open(os.path.join(dirs["shards"], name), "rb") as fa, \
                    open(os.path.join(out["shards"], name), "rb") as fb:
                check(fa.read() == fb.read(), f"tools shard plane: {name} differs")
    digest = hashlib.sha256(json.dumps(manifests["inline"], sort_keys=True).encode()).hexdigest()
    print(f"  tools: python -m data_diet_distributed_tpu_torch.tools.npz_to_npy and "
          f".make_shards rebuilt the npy plane ({len(names)} files) and the shard plane "
          f"({sum(len(x['shards']) for x in manifests['inline']['splits'].values())} shards, "
          f"manifest sha256 {digest[:16]}) from the npz plane in {wall:.1f} s, bitwise the "
          f"inline writer's; conversion {conversion}", flush=True)
    shutil.rmtree(out["npy"], ignore_errors=True)
    shutil.rmtree(out["shards"], ignore_errors=True)
    return {"wall_s": wall, "manifest_sha256": digest, "files": names}


def run_cli(port, argv: list[str]) -> tuple[int, dict | None, list[dict]]:
    """``cli.main(argv)`` in this process (so its kernel launches are counted):
    (exit status, the summary line, the JSON records it logged)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port["data"]["cli"].main(argv)
    lines = out.getvalue().strip().splitlines()
    records = [json.loads(line) for line in err.getvalue().splitlines()
               if line.startswith("{")]
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), records


def config5_argv(data_dir: str, ckpt: str, *over) -> list[str]:
    return ["run", "--config", DATA_CONFIG, "data.dataset=sharded",
            f"data.data_dir={data_dir}", "data.data_plane=streaming",
            "train.num_epochs=1", "score.seeds=[0]",
            f"data.host_cache_bytes={DATA_CACHE}", f"train.checkpoint_dir={ckpt}", *over]


@contextlib.contextmanager
def conv_spy(gb, rows: dict):
    """While active, each conv layer the GraNd route sends to a kernel route is
    also computed on the plain route from the same x and g; ``rows`` gets, by
    distinct geometry, the route, the layers a batch and the largest relative
    error against the plain version (and the last x and g, for timing)."""
    orig = gb._conv_contrib

    def spy(rec, x, g, use_kernels, route_log):
        out = orig(rec, x, g, use_kernels, route_log)
        if use_kernels:
            pad = gb._explicit_padding(rec["padding"], x.shape, g.shape, rec)
            route = gb.conv_route(rec, x.shape, g.shape, pad)
            ref = orig(rec, x, g, False, None)
            key = (route, str(x.dtype), tuple(x.shape), tuple(g.shape),
                   tuple(rec["kernel_size"]), tuple(rec["strides"]),
                   tuple(tuple(p) for p in pad), bool(rec["use_bias"]))
            row = rows.setdefault(key, {"layers": 0, "max_rel_err": 0.0})
            row["layers"] += 1
            row["max_rel_err"] = max(row["max_rel_err"], _rel_err(out, ref)[1])
            row["x"], row["g"] = x, g
        return out
    gb._conv_contrib = spy
    try:
        yield
    finally:
        gb._conv_contrib = orig


def conv_geometry_rows(torch, K, geo: dict) -> list[dict]:
    """Hold each conv geometry ``conv_spy`` recorded (route, dtype, shapes) to
    its largest relative error against the plain version (fp32 1e-4, bf16
    1e-3), and time every bf16 kernel geometry on the layer's own x and g with
    its bound (``_measure``); returns those rows."""
    kernel_rows = []
    for (route, dt, xs, gs, ks, st, pad, bias), row in sorted(geo.items(),
                                                             key=lambda kv: kv[0][1:]):
        dname = dt.replace("torch.", "")
        tol = 1e-4 if dname == "float32" else 1e-3
        print(f"    {dname} {route:5s} x{list(xs[1:])} g{list(gs[1:])} k{ks} s{st}: "
              f"{row['layers']} a batch, max rel err vs plain {row['max_rel_err']:.3e}",
              flush=True)
        check(row["max_rel_err"] <= tol, f"{route} x{xs} g{gs}: rel err "
              f"{row['max_rel_err']:.3e} > {tol}")
        if route == "plain" or dname != "bfloat16":
            continue
        kern = "conv_grad_norm_gram" if route == "gram" else "conv_grad_norm_direct"
        x, g = row["x"], row["g"]
        if route == "v1":
            def run(x=x, g=g, ks=ks, st=st, pad=pad):
                return K.conv_grad_norm_sq(x, g, ks, st, pad)

            def plain_fn(x=x, g=g, ks=ks, st=st, pad=pad):
                return K.conv_grad_norm_sq_plain(x, g, ks, st, pad)
        elif route == "v2":
            def run(x=x, g=g, ks=ks, pad=pad, bias=bias):
                return K.conv_grad_norm_sq_v2(x, g, ks, pad, use_bias=bias)

            def plain_fn(x=x, g=g, ks=ks, pad=pad):
                return K.conv_grad_norm_sq_plain(x, g, ks, (1, 1), pad)
        else:
            def run(x=x, g=g, ks=ks, pad=pad, bias=bias):
                return K.conv_grad_norm_sq_gram(x, g, ks, pad, use_bias=bias)

            def plain_fn(x=x, g=g, ks=ks, pad=pad, bias=bias):
                return K.conv_grad_norm_sq_gram_plain(x, g, ks, pad, use_bias=bias)
        flops, nbytes = K.kernel_work(kern, x=xs, g=gs, kernel_size=ks,
                                      itemsize=x.element_size())
        kernel_rows.append(_measure(torch, {
            "kernel": kern, "entry": route, "dtype": dname, "x": list(xs), "g": list(gs),
            "kernel_size": list(ks), "strides": list(st), "layers_per_batch": row["layers"],
            "max_rel_err": row["max_rel_err"]}, run, plain_fn, flops, nbytes, dname))
    return kernel_rows


def per_batch_sums(kernel_rows: list[dict], kernels: list[str], what: str) -> dict:
    """Each kernel's rows summed over the layers of a batch (device, one-call,
    plain and bound ms), printed with every row."""
    out = {}
    for kern in kernels:
        rows = [r for r in kernel_rows if r["kernel"] == kern]
        tot = {k: sum(r["layers_per_batch"] * r[k] for r in rows)
               for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
        out[kern] = tot
        print(f"  {kern} at {what}: "
              f"{sum(r['layers_per_batch'] for r in rows)} launches a batch, device "
              f"{tot['device_ms']:.4f} ms, one-call {tot['ms']:.4f}, plain "
              f"{tot['plain_ms']:.4f}, bound {tot['bound_ms']:.4f} ms a batch", flush=True)
    for r in kernel_rows:
        print(f"    {r['kernel']}/{r['entry']} x{r['x'][1:]} g{r['g'][1:]} "
              f"k{r['kernel_size']} s{r['strides']} x{r['layers_per_batch']}: device "
              f"{r['device_ms']:.4f} ms, one-call {r['ms']:.4f}, plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return out


def data_phase(torch, port, details_out, card: str) -> dict:
    """BASELINE config 5 through the port's data planes on the card. Its files
    go to ``DATA_ROOT`` and are removed after."""
    shutil.rmtree(DATA_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        return _data_phase(torch, port, details_out.setdefault("data", {}), card)
    finally:
        shutil.rmtree(DATA_ROOT, ignore_errors=True)
        wall = time.perf_counter() - t0
        details_out["data"]["phase_wall_s"] = wall
        print(f"  data phase: {wall:.1f} s", flush=True)


def _data_phase(torch, port, rec: dict, card: str) -> dict:
    D, K, gb = port["data"], port["kernels"], port["grand_batched"]
    load, score = port["load_dataset"], port["score_dataset"]
    t0 = time.perf_counter()
    train, test = load("synthetic_imagenet", synthetic_size=DATA_N, seed=0)
    dirs = write_data_planes(port, train, test)
    rec["tools"] = tool_planes(dirs, DATA_ROOT, DATA_SHARD)
    npz_train, _ = load("npz", dirs["npz"])
    npy_train, _ = load("npz", dirs["npy"])

    def sharded_train(**kw):
        return load("sharded", dirs["shards"], host_cache_bytes=DATA_CACHE, **kw)[0]
    print(f"  data: {DATA_N} + {len(test)} synthetic_imagenet examples written as npz, "
          f"npy and {DATA_SHARD}-row shards in {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(npy_train.norm is not None and isinstance(npy_train.images, np.memmap)
          and npz_train.norm is None, "the npy plane is not lazy or the npz one not dense")

    # 1. The native assembler, and pinned uploads that are bitwise the host batches.
    check(D["native"].load() is not None, "the native assembler did not build or load")
    print(f"  native assembler: {D['native'].LIB_PATH}", flush=True)
    shards = sharded_train()
    kw = dict(shuffle=True, seed=1, epoch=0)
    stream = D["prefetch_stream"](shards, DATA_B, "cuda", depth=2, stage="check", **kw)
    with contextlib.closing(stream):
        got = list(stream)   # taken as fast as they come: slot reuse is raced
    host = list(D["iterate_batches"](npy_train, DATA_B, **kw))
    check(len(got) == len(host) == DATA_N // DATA_B, f"{len(got)} streamed batches")
    for i, (db, hb) in enumerate(zip(got, host)):
        check(all(t.is_cuda for t in db.values()), "prefetch_stream yielded a host tensor")
        check(all(torch.equal(db[k], torch.from_numpy(hb[k]).cuda()) for k in hb),
              f"prefetch_stream batch {i}: not bitwise the npy plane's host batch")
    cache = shards.images.cache
    print(f"  prefetch_stream (sharded, depth 2): {len(got)} CUDA batches, each bitwise "
          f"the npy-mmap plane's host batch; shard cache {cache.bytes_in_use} of "
          f"{cache.budget_bytes} B in use, {cache.evictions} evictions", flush=True)
    check(cache.evictions > 0 and cache.bytes_in_use <= cache.budget_bytes,
          "the shard cache did not evict within its budget")
    del got, host

    # 2. The main path: config 5's cli run on the streamed shards.
    model16 = port["create_model"]("resnet50", DATA_CLASSES, half_precision=True,
                                   stem="imagenet").to("cuda")
    seeds = [port["init_variables"]("resnet50", s, "cuda", num_classes=DATA_CLASSES,
                                    stem="imagenet") for s in (0, 1)]
    first = D["iterate_batches"](train, DATA_B).__next__()
    batch = [torch.from_numpy(first[k]).cuda() for k in ("image", "label", "mask")]
    route_log: list = []
    gb.batched_grand_scores(model16, seeds[0], *batch, use_kernels=True, route_log=route_log)
    routes = collections.Counter(r for _, r in route_log)
    per_batch = {"conv_grad_norm_direct": routes["v1"] + routes["v2"],
                 "conv_grad_norm_gram": routes["gram"]}
    print(f"  route log of one batch: {dict(routes)} -> launches a batch {per_batch}",
          flush=True)
    ckpt = os.path.join(DATA_ROOT, "ckpt")
    K.reset_launch_counts()
    modes0 = K.mode_counts()
    t0 = time.perf_counter()
    rc, summary, records = run_cli(port, config5_argv(dirs["shards"], ckpt))
    run_wall = time.perf_counter() - t0
    counts = K.launch_counts()
    check(rc == 0 and summary is not None, f"config 5 cli run exited {rc}")
    nb = DATA_N // DATA_B
    want = {k: nb * per_batch.get(k, 0) for k in K.KERNELS}
    check(counts == want, f"config 5 run: launch counts {counts}, want {want}")
    for kern in per_batch:
        check_modes(K, modes0[kern], want[kern], "tensor_core", "config 5 run", kern)
    check(summary["n_kept"] == DATA_N // 2, f"config 5 run: n_kept {summary['n_kept']}")
    npz = port["train"]["scores_npz_path"](ckpt)
    with np.load(npz) as f:
        port["train"]["verify_prune_manifest"](npz, f["kept"])
    planes = [r for r in records if r["kind"] == "data_plane"]
    check([p["stage"] for p in planes] == ["score_pretrain_seed0", "score", "final"],
          f"config 5 run: data_plane records {[p['stage'] for p in planes]}")
    for p in planes:
        # Streamed in one process: the chunked stream (score.chunk_steps and
        # train.chunk_steps null), as in the JAX package.
        check(p["fault"] is None and p["engine"] == "chunked_stream"
              and p["host_cache_bytes_in_use"] <= p.get("host_cache_budget_bytes",
                                                         DATA_CACHE),
              f"config 5 run: data_plane record {p}")
    check(all(p["host_cache_evictions"] > 0 for p in planes[:2]),
          "config 5 run: the shard cache never evicted")
    epochs = [r for r in records if r["kind"] == "epoch"]
    walls = {k: summary[k] for k in ("pretrain_wall_s", "score_wall_s", "prune_wall_s",
                                     "train_wall_s")}
    rec["run"] = {"wall_s": run_wall, "stage_walls_s": walls, "launches": counts,
                  "launches_per_batch": per_batch, "routes_per_batch": dict(routes),
                  "data_plane": planes, "epochs": epochs,
                  "final_test_accuracy": summary.get("final_test_accuracy")}
    print(f"  config 5 cli run (sharded, streaming, {DATA_N} examples, 1 seed, 1 epoch "
          f"each): exit 0 in {run_wall:.1f} s; n_kept {summary['n_kept']}, manifest "
          f"verified; stages {walls}; launches {counts} ({per_batch} a batch, "
          f"tensor-core)", flush=True)
    for p in planes:
        print(f"    data_plane {p['stage']}: {p['engine']}, stall_frac {p['stall_frac']} "
              f"(depth {p['prefetch_depth']}, {p.get('items')} blocks), cache "
              f"{p['host_cache_bytes_in_use']} B, evictions "
              f"{p.get('host_cache_evictions')}", flush=True)
    for e in epochs:
        print(f"    epoch {e['tag']}: {e['examples_per_s']:.1f} ex/s in {e['epoch_s']} s",
              flush=True)

    # 3. GraNd on the eager set, two seeds, bf16: streaming is bitwise resident.
    score(model16, seeds[:1], train.subset(train.indices[:DATA_B]), method="grand",
          batch_size=DATA_B, device="cuda")   # warm-up
    grand = {}
    for plane in ("resident", "streaming"):
        partials: list = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = score(model16, seeds, train, method="grand", batch_size=DATA_B,
                  data_plane=plane, on_seed_done=lambda k, v, p=partials: p.append(v),
                  device="cuda")
        wall = time.perf_counter() - t0
        grand[plane] = (s, partials, 2 * DATA_N / wall)
    check(np.array_equal(grand["streaming"][0], grand["resident"][0])
          and all(np.array_equal(a, b) for a, b in zip(grand["streaming"][1],
                                                       grand["resident"][1])),
          "GraNd: streaming scores or partials not bitwise the resident ones")
    check(bool(np.isfinite(grand["resident"][0]).all()), "GraNd: non-finite scores")
    rec["grand_ex_per_s"] = {p: grand[p][2] for p in grand}
    print(f"  GraNd, eager set, {DATA_N} x 2 seeds, bf16: streaming bitwise resident "
          f"(mean and both float64 partials); resident {grand['resident'][2]:.1f} ex/s, "
          f"streaming {grand['streaming'][2]:.1f} ex/s on {card}", flush=True)

    # 4. The lazy planes through the streaming plane: npy-mmap bitwise sharded.
    lazy = {}
    for name, ds in (("npy", npy_train), ("sharded", sharded_train())):
        ev = Events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lazy[name] = score(model16, seeds[:1], ds, method="grand", batch_size=DATA_B,
                           data_plane="streaming", log=ev, device="cuda")
        wall = time.perf_counter() - t0
        (plane,) = ev.of("data_plane")
        rec.setdefault("lazy", {})[name] = {"ex_per_s": DATA_N / wall,
                                            "stall_frac": plane["stall_frac"]}
        print(f"  GraNd, {name} plane, 1 seed: {DATA_N / wall:.1f} ex/s, stall_frac "
              f"{plane['stall_frac']}", flush=True)
    check(np.array_equal(lazy["npy"], lazy["sharded"]),
          "GraNd: the npy-mmap and sharded planes' scores differ")
    print("  npy-mmap and sharded planes: bitwise equal scores", flush=True)

    # 5-6. fp32, TF32 off: lazy against dense; the kernel route against the plain one.
    port["set_parity_mode"](True)
    model32 = port["create_model"]("resnet50", DATA_CLASSES, stem="imagenet").to("cuda")
    vr = bn_randomized(torch, port, 7, arch="resnet50", num_classes=DATA_CLASSES,
                       stem="imagenet")
    ids = np.arange(DATA_PARITY_N)
    dense_sub, lazy_sub = npz_train.subset(ids), npy_train.subset(ids)
    parity = {}
    for method in ("el2n", "grand"):
        a = score(model32, [vr], lazy_sub, method=method, batch_size=DATA_B,
                  data_plane="streaming", device="cuda")
        b = score(model32, [vr], dense_sub, method=method, batch_size=DATA_B,
                  data_plane="streaming", device="cuda")
        err = np.abs(a - b)
        rel = float(np.max(err / np.maximum(np.abs(b), 1e-30)))
        parity[f"{method}_lazy_vs_dense"] = rel
        ok = (rel <= 1e-4 if method == "grand"
              else bool(np.all(err <= 1e-5 * np.abs(b) + 1e-6)))
        print(f"  {method} fp32, lazy (npy) vs dense (npz), {DATA_PARITY_N} examples: max "
              f"rel err {rel:.3e}, max abs err {float(err.max()):.3e}", flush=True)
        check(ok, f"{method}: lazy vs dense rel err {rel:.3e}")
    fast = score(model32, [vr], dense_sub, method="grand", batch_size=DATA_B,
                 use_kernels=True, device="cuda")
    plain = score(model32, [vr], dense_sub, method="grand", batch_size=DATA_B,
                  use_kernels=False, device="cuda")
    rel = float(np.max(np.abs(fast - plain) / np.maximum(np.abs(plain), 1e-30)))
    parity["grand_kernel_vs_plain_route"] = rel
    print(f"  grand fp32 kernel route vs plain route, {DATA_PARITY_N} examples: max rel "
          f"err {rel:.3e}", flush=True)
    check(rel <= 1e-4, f"grand: kernel route vs plain route rel err {rel:.3e}")
    geo: dict = {}
    local32 = port["make_local_scores"](model32, "grand_batched", use_kernels=True)
    with conv_spy(gb, geo):
        local32(vr, *batch)
    port["set_parity_mode"](False)
    local16 = port["make_local_scores"](model16, "grand_batched", use_kernels=True)
    with conv_spy(gb, geo):
        local16(seeds[0], *batch)
    rec["parity"] = parity
    rec["kernel_rows"] = kernel_rows = conv_geometry_rows(torch, K, geo)
    rec["per_batch"] = per_batch_sums(kernel_rows, per_batch,
                                      f"config 5 (bf16, batch {DATA_B})")
    del geo

    # 7. Fits: streaming bitwise resident; prefetch depth 0 bitwise depth 2.
    fit_ds = train.subset(train.indices[:DATA_FIT_N])
    fits = {}
    for name, over in (("resident", ["data.data_plane=resident"]),
                       ("depth2", ["data.data_plane=streaming", "data.prefetch_depth=2"]),
                       ("depth0", ["data.data_plane=streaming", "data.prefetch_depth=0"])):
        cfg = port["load_config"](DATA_CONFIG, ["train.num_epochs=2",
                                                f"model.num_classes={DATA_CLASSES}", *over])
        ev = Events()
        fits[name] = (port["train"]["fit"](cfg, fit_ds, None, device="cuda", log=ev), ev)
    res0 = fits["resident"][0]
    for name in ("depth2", "depth0"):
        res = fits[name][0]
        check([h["train_loss"] for h in res.history]
              == [h["train_loss"] for h in res0.history]
              and all(torch.equal(v, res.state.variables[k])
                      for k, v in res0.state.variables.items()),
              f"fit {name}: not bitwise the resident fit")
    rec["fit"] = {}
    for name, (res, ev) in fits.items():
        (plane,) = ev.of("data_plane")
        rec["fit"][name] = {"examples_per_s": [h["examples_per_s"] for h in res.history],
                            "stall_frac": plane["stall_frac"]}
        print(f"  fit {name} ({2 * DATA_FIT_N // DATA_B} steps, batch {DATA_B}, bf16): "
              "epoch ex/s "
              + ", ".join(f"{h['examples_per_s']:.1f}" for h in res.history)
              + f"; data_plane {plane['engine']} stall_frac {plane['stall_frac']}",
              flush=True)
    print("  fits: streaming (depth 2 and 0) bitwise the resident fit", flush=True)

    # 8. Storage drills on the shards.
    ev = Events()
    s = with_plan(port, {"eio_shard_read": 2}, lambda: score(
        model16, seeds[:1], sharded_train(read_backoff_s=0.0), method="grand",
        batch_size=DATA_B, data_plane="streaming", log=ev, device="cuda"))
    faults = ev.of("data_fault")
    check(len(faults) == 1 and faults[0]["recovered"] is True and faults[0]["shard"] == 2,
          f"EIO drill: data_fault records {faults}")
    check(np.array_equal(s, lazy["sharded"]), "EIO drill: scores not bitwise the clean ones")
    print(f"  EIO drill: recovered in place ({faults[0]}), scores bitwise the clean ones",
          flush=True)
    ev = Events()
    err = None
    try:
        with_plan(port, {"torn_shard_read": DATA_TORN_SHARD}, lambda: score(
            model16, seeds[:1], sharded_train(read_backoff_s=0.0), method="grand",
            batch_size=DATA_B, data_plane="streaming", log=ev, device="cuda"))
    except D["ShardReadError"] as e:
        err = e
    check(err is not None and err.split == "train" and err.shard == DATA_TORN_SHARD,
          f"torn drill: no ShardReadError naming train shard {DATA_TORN_SHARD} ({err!r})")
    quarantine = ev.of("shard_quarantine")
    check(len(quarantine) == 1 and quarantine[0]["shard"] == DATA_TORN_SHARD
          and ev.of("data_plane")[0]["fault"] is not None,
          f"torn drill: records {ev.records}")
    print(f"  torn drill: ShardReadError ({err.split} shard {err.shard}, "
          f"{err.error_class}), shard_quarantine {quarantine[0]}", flush=True)
    ckpt_q = os.path.join(DATA_ROOT, "ckpt_quarantined")
    rc, summary, records = with_plan(
        port, {"torn_shard_read": DATA_TORN_SHARD},
        lambda: run_cli(port, config5_argv(dirs["shards"], ckpt_q,
                                           "data.skip_quarantined=true")))
    check(rc == 0 and summary is not None, f"skip_quarantined run exited {rc}")
    with open(port["train"]["scores_npz_path"](ckpt_q) + ".provenance.json") as fh:
        manifest = json.load(fh)
    check(manifest.get("quarantined_shards") == [DATA_TORN_SHARD]
          and manifest.get("quarantined_rows") == DATA_SHARD
          and summary["n_kept"] == DATA_N // 2 - manifest["quarantined_dropped_from_kept"],
          f"skip_quarantined run: manifest {manifest.get('quarantined_shards')}, "
          f"{manifest.get('quarantined_rows')} rows, n_kept {summary['n_kept']}")
    print(f"  skip_quarantined run: exit 0, n_kept {summary['n_kept']}; manifest lists "
          f"shard {manifest['quarantined_shards']} ({manifest['quarantined_rows']} rows, "
          f"{manifest['quarantined_dropped_from_kept']} dropped from the kept set)",
          flush=True)
    cfg5 = port["load_config"](DATA_CONFIG, [f"model.num_classes={DATA_CLASSES}"])
    return {"counts": counts,
            "profile": {"ds": train, "cfg": cfg5, "variables": seeds, "batch": DATA_B}}


# BASELINE config 4 (phase 11): WideResNet-28-10 / CIFAR-100, GraNd over 3 seeds and a
# prune sweep, on synthetic CIFAR-100-geometry data (``cifar100_dataset``). Widths as
# published; the cuts are in ``wrn_phase``'s docstring.
WRN_CONFIG = os.path.join(REPO, "configs", "cifar100_wrn28_10.yaml")
WRN_ROOT = os.path.join(REPO, "chip_smoke_out", "wrn")
WRN_N = 2048                  # train examples (CIFAR-100 has 50,000)
WRN_TEST = 1024               # test examples
WRN_CLASSES = 100
WRN_SEEDS = (0, 1, 2)         # config 4's score.seeds
WRN_TRAIN_B = 128             # config 4's data.batch_size
WRN_SWEEP = (0.3, 0.5, 0.7)   # config 4's sweep levels
WRN_PARITY_N = 1024           # the fp32 route comparisons: two batches
WRN_PARAMS = 36_479_194       # WRN-28-10 at 10 classes (the JAX package's test_models.py)
# bf16 against fp32 logits on the same weights: the largest difference over the largest
# |fp32 logit| (the port's CPU run of the same comparison reads 0.6 %).
WRN_LOGIT_RTOL = 0.02
WRN_ROUTES = {"v1": 9, "v2": 7, "gram": 7, "plain": 5}   # one GraNd batch's convs
WRN_REMAT_STEPS = 16          # all of WRN_N at WRN_TRAIN_B
# Trajectory scores on the ResNet-18 north-star geometry. The synthetic set's default
# pixel noise (0.4) is learned whole in two epochs, which leaves every forgetting count
# at 0: TRAJ_NOISE makes examples that are forgotten or never learned.
TRAJ_N = 1024
TRAJ_EPOCHS = 2
TRAJ_SEEDS = (0, 1)
TRAJ_NOISE = 6.0


def layer_shapes(torch, gb, model, variables, image) -> list:
    """(record, NHWC x shape, NHWC output shape) of every Conv and BatchNorm of
    ``model`` in one forward of ``image``."""
    names = {mod: path for path, mod in model.named_modules()}
    layers = []

    def nhwc(t):
        return (t.shape[0], t.shape[2], t.shape[3], t.shape[1])

    def hook(mod, args, out):
        layers.append((gb._record_for(names[mod], mod), nhwc(args[0]), nhwc(out)))
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d))]
    try:
        with torch.no_grad():
            torch.func.functional_call(model.eval(), variables, (image,))
    finally:
        for h in handles:
            h.remove()
    return layers


def wrn_argv(data_dir: str, ckpt: str, *over) -> list[str]:
    return ["sweep", "--config", WRN_CONFIG, "data.dataset=npz", f"data.data_dir={data_dir}",
            "score.pretrain_epochs=1", "train.num_epochs=1", f"score.batch_size={B}",
            f"prune.sweep=[{','.join(str(s) for s in WRN_SWEEP)}]",
            f"train.checkpoint_dir={ckpt}", *over]


def wrn_phase(torch, port, details_out, card: str) -> dict:
    """BASELINE config 4 (``configs/cifar100_wrn28_10.yaml``: WideResNet-28-10 /
    CIFAR-100, GraNd over seeds [0, 1, 2], prune sweep {30, 50, 70} %) on the
    card, bf16, training at batch 128 and scoring at batch 512, on
    ``WRN_N`` synthetic CIFAR-100-geometry examples (no CIFAR-100 is in the
    repo). Cuts: ``WRN_N`` of 50,000 examples, ``score.pretrain_epochs`` 1 of
    10, ``train.num_epochs`` 1 of 200 per sweep level; widths and seeds as
    published. Its files go to ``WRN_ROOT`` and are removed after."""
    shutil.rmtree(WRN_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    rec = details_out.setdefault("wrn", {})
    try:
        return _wrn_phase(torch, port, rec, card)
    finally:
        shutil.rmtree(WRN_ROOT, ignore_errors=True)
        port["set_parity_mode"](False)
        rec["phase_wall_s"] = wall = time.perf_counter() - t0
        print(f"  wrn phase: {wall:.1f} s", flush=True)


def _wrn_phase(torch, port, rec: dict, card: str) -> dict:
    K, gb, score = port["kernels"], port["grand_batched"], port["score_dataset"]
    T, arch = port["train"], "wideresnet28_10"
    full = cifar100_dataset(port, WRN_N + WRN_TEST)
    train = full.subset(full.indices[:WRN_N])
    nb = WRN_N // B
    counts = dict.fromkeys(K.KERNELS, 0)

    # 1. The model: its size, and bf16 logits against fp32 on the same weights.
    n10, n100 = (sum(p.numel() for p in port["create_model"](arch, c).parameters())
                 for c in (10, WRN_CLASSES))
    check(n10 == WRN_PARAMS and n100 == WRN_PARAMS + 90 * 641,
          f"WRN-28-10 has {n10} parameters at 10 classes, {n100} at 100")
    model16 = port["create_model"](arch, WRN_CLASSES, half_precision=True).to("cuda")
    model32 = port["create_model"](arch, WRN_CLASSES).to("cuda")
    port["set_parity_mode"](True)
    vr = bn_randomized(torch, port, 7, arch=arch, num_classes=WRN_CLASSES)
    first = port["data"]["iterate_batches"](train, B).__next__()
    batch = [torch.from_numpy(first[k]).cuda() for k in ("image", "label", "mask")]
    with torch.no_grad():
        l32 = torch.func.functional_call(model32, vr, (batch[0],))
        l16 = torch.func.functional_call(model16, vr, (batch[0],))
    gap = float((l16 - l32).abs().max() / l32.abs().max())
    rec["model"] = {"params_10": n10, "params_100": n100, "bf16_logit_gap": gap}
    print(f"  WRN-28-10: {n10} parameters at 10 classes, {n100} at {WRN_CLASSES}; bf16 "
          f"vs fp32 logits (batch {B}, BN randomized): largest difference "
          f"{gap:.3e} of the largest |logit| (limit {WRN_LOGIT_RTOL})", flush=True)
    check(bool(torch.isfinite(l16).all()) and gap <= WRN_LOGIT_RTOL,
          f"WRN bf16 logits {gap:.3e} from fp32")

    # 2. The route of one GraNd batch (bf16, seed 0 at init).
    seeds16 = [port["init_variables"](arch, s, "cuda", num_classes=WRN_CLASSES)
               for s in WRN_SEEDS]
    route_log: list = []
    gb.batched_grand_scores(model16, seeds16[0], *batch, use_kernels=True,
                            route_log=route_log)
    routes = collections.Counter(r for _, r in route_log)
    per_batch = {"conv_grad_norm_direct": routes["v1"] + routes["v2"],
                 "conv_grad_norm_gram": routes["gram"]}
    rec["routes_per_batch"] = dict(routes)
    print(f"  route log of one batch: {dict(routes)} -> launches a batch {per_batch}",
          flush=True)
    check(dict(routes) == WRN_ROUTES, f"WRN route log {dict(routes)}, want {WRN_ROUTES}")

    # 3. Every kernel geometry against its plain version, fp32 and bf16; bf16 timed.
    geo: dict = {}
    with conv_spy(gb, geo):
        port["make_local_scores"](model32, "grand_batched", use_kernels=True)(vr, *batch)
    port["set_parity_mode"](False)
    with conv_spy(gb, geo):
        port["make_local_scores"](model16, "grand_batched", use_kernels=True)(vr, *batch)
    for dname in ("float32", "bfloat16"):
        got = collections.Counter()
        for key, row in geo.items():
            if key[1] == f"torch.{dname}":
                got[key[0]] += row["layers"]
        check(dict(got) == WRN_ROUTES, f"WRN {dname} conv_spy routes {dict(got)}")
    rec["kernel_rows"] = kernel_rows = conv_geometry_rows(torch, K, geo)
    del geo
    rec["per_batch"] = per_batch_sums(kernel_rows, per_batch,
                                      f"config 4 (bf16, batch {B})")
    layers = layer_shapes(torch, gb, model16, seeds16[0], batch[0])
    mega = collections.Counter(
        (xs, gs, r["kernel_size"], r["padding"], r["use_bias"]) for r, xs, gs in layers
        if r["kind"] == "conv" and gb._mega_conv_route(r, xs, gs))
    bns = collections.Counter(xs for r, xs, _ in layers if r["kind"] == "bn")
    check(sum(mega.values()) == 15 and sum(bns.values()) == 25,
          f"WRN: {sum(mega.values())} megakernel convs, {sum(bns.values())} BatchNorms")
    rec["mega_rows"], rec["bn_rows"] = [], []
    gen = torch.Generator(device="cuda").manual_seed(2468)
    port["set_parity_mode"](True)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        for (xs, gs, ks, pad, bias), n in sorted(mega.items()):
            mega_row(torch, K, gen, dtype, rtol, rec["mega_rows"], xs, gs, ks, pad, bias,
                     n)
        for shape, n in sorted(bns.items()):
            bn_row(torch, K, gen, dtype, rtol, rec["bn_rows"], shape, 1, True, True, n,
                   main_path=True)
    for what, rows in (("megakernel (FUSED+MEGAKERNEL)", rec["mega_rows"]),
                       ("stacked BN (BN_KERNEL)", rec["bn_rows"])):
        bf = [r for r in rows if r["dtype"] == "bfloat16"]
        tot = {k: sum(r["layers_per_batch"] * r[k] for r in bf)
               for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
        print(f"  {what} at config 4 (bf16, batch {B}): "
              f"{sum(r['layers_per_batch'] for r in bf)} launches a batch, device "
              f"{tot['device_ms']:.4f} ms, one-call {tot['ms']:.4f}, plain "
              f"{tot['plain_ms']:.4f}, bound {tot['bound_ms']:.4f} ms a batch", flush=True)

    # EL2N and the last layer at config 4's head, in fp32 as the path hands them over
    # (the model returns fp32 logits and features) and in bf16: logits [512, 100],
    # features [512, 640] -> 100 classes; fp32 timed with its bound.
    rec["head_rows"] = []
    feats = model16.classifier.in_features
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        z = (torch.randn((B, WRN_CLASSES), generator=gen, device="cuda") * 3).to(dtype)
        h = torch.randn((B, feats), generator=gen, device="cuda").to(dtype)
        w = torch.randn((WRN_CLASSES, feats), generator=gen, device="cuda") * feats ** -0.5
        bias = 0.1 * torch.randn(WRN_CLASSES, generator=gen, device="cuda")
        y = torch.randint(0, WRN_CLASSES, (B,), generator=gen, device="cuda")
        m = (torch.rand(B, generator=gen, device="cuda") > 0.1).float()
        item = z.element_size()
        for kern, shape, call, plain, flops, nbytes, peak in (
                ("el2n", f"logits [{B}, {WRN_CLASSES}]", lambda: K.el2n(z, y, m),
                 lambda: K.el2n_plain(z, y, m),
                 *K.kernel_work("el2n", batch=B, classes=WRN_CLASSES, itemsize=item),
                 "float32"),
                ("grand_last_layer", f"[{B}, {feats}] -> {WRN_CLASSES}",
                 lambda: K.grand_last_layer(h, w, bias, y, m),
                 lambda: K.grand_last_layer_plain(h, w, bias, y, m),
                 *K.kernel_work("grand_last_layer", batch=B, features=feats,
                                classes=WRN_CLASSES, itemsize=item),
                 "bfloat16")):
            got, ref = call(), plain()
            abs_err, rel = _rel_err(got, ref)
            ok = (rel <= 1e-5 or abs_err <= 1e-6) if kern == "el2n" else rel <= 1e-4
            what = f"{kern} {dname} at config 4's head"
            check(bool(torch.isfinite(got).all()) and ok, f"{what}: rel err {rel:.3e}")
            row = {"kernel": kern, "dtype": dname, "max_abs_err": abs_err,
                   "max_rel_err": rel, "layers_per_batch": 1}
            if dtype == torch.float32:
                row = _measure(torch, row, call, plain, flops, nbytes, peak)
                print(f"  {what} ({shape}): rel_err={rel:.3e} "
                      f"ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} plain_ms="
                      f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
                      f"({row['bound_by']})", flush=True)
            rec["head_rows"].append(row)
    port["set_parity_mode"](False)

    # 4. Scoring through score_dataset, bf16, config 4's seeds: ex/s and exact launches.
    warm = train.subset(train.indices[:B])
    methods = ("grand", "el2n", "grand_last_layer")
    for method in methods:
        score(model16, seeds16[:1], warm, method=method, batch_size=B, device="cuda")
    rec["score"] = {}
    for method in methods:
        K.reset_launch_counts()
        modes0 = K.mode_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = score(model16, seeds16, train, method=method, batch_size=B, device="cuda")
        wall = time.perf_counter() - t0
        got = K.launch_counts()
        if method == "grand":
            want = {k: nb * len(WRN_SEEDS) * per_batch.get(k, 0) for k in K.KERNELS}
            for kern in per_batch:
                check_modes(K, modes0[kern], want[kern], "tensor_core", "WRN grand", kern)
        else:
            want = {k: (nb * len(WRN_SEEDS) if k == method else 0) for k in K.KERNELS}
        check(got == want, f"WRN {method}: launch counts {got}, want {want}")
        check(scores.shape == (WRN_N,) and bool(np.isfinite(scores).all())
              and bool((scores >= 0).all()), f"WRN {method}: scores not finite/>= 0")
        for k, n in got.items():
            counts[k] += n
        ex_s = WRN_N * len(WRN_SEEDS) / wall
        rec["score"][method] = {"wall_s": wall, "ex_per_s": ex_s, "launches": got}
        print(f"  {method}: {WRN_N} examples x {len(WRN_SEEDS)} seeds in {wall:.3f} s = "
              f"{ex_s:.1f} ex/s on {card}; launches {got}; mean score "
              f"{scores.mean():.5f}", flush=True)
    port["set_parity_mode"](True)
    sub = train.subset(train.indices[:WRN_PARITY_N])
    for method in methods:
        fast = score(model32, [vr], sub, method=method, batch_size=B, use_kernels=True,
                     device="cuda")
        plain = score(model32, [vr], sub, method=method, batch_size=B, use_kernels=False,
                      device="cuda")
        err = np.abs(fast - plain)
        rel = float(np.max(err / np.maximum(np.abs(plain), 1e-30)))
        ok = (bool(np.all((err <= 1e-5 * np.abs(plain)) | (err <= 1e-6)))
              if method == "el2n" else rel <= 1e-4)
        rec["score"][method]["fp32_rel_err_vs_plain_route"] = rel
        print(f"  {method} fp32 kernel route vs plain route ({WRN_PARITY_N} examples, BN "
              f"randomized): max rel err {rel:.3e}, max abs err {float(err.max()):.3e}",
              flush=True)
        check(ok, f"WRN {method}: kernel route vs plain route rel err {rel:.3e}")
    port["set_parity_mode"](False)

    # 5. Config 4's cli sweep: one scoring pass of 3 seeds, three verified levels.
    data_dir = os.path.join(WRN_ROOT, "npz")
    os.makedirs(data_dir, exist_ok=True)
    for split, rows in (("train", slice(0, WRN_N)), ("test", slice(WRN_N, None))):
        np.savez(os.path.join(data_dir, f"{split}.npz"), images=full.images[rows],
                 labels=full.labels[rows])
    ckpt = os.path.join(WRN_ROOT, "ckpt")
    K.reset_launch_counts()
    modes0 = K.mode_counts()
    t0 = time.perf_counter()
    rc, summary, records = run_cli(port, wrn_argv(data_dir, ckpt))
    sweep_wall = time.perf_counter() - t0
    got = K.launch_counts()
    check(rc == 0 and summary is not None, f"config 4 cli sweep exited {rc}")
    want = {k: nb * len(WRN_SEEDS) * per_batch.get(k, 0) for k in K.KERNELS}
    check(got == want, f"config 4 sweep: launch counts {got}, want {want}")
    for kern in per_batch:
        check_modes(K, modes0[kern], want[kern], "tensor_core", "config 4 sweep", kern)
    for k, n in got.items():
        counts[k] += n
    levels = summary["levels"]
    check([lv["sparsity"] for lv in levels] == list(WRN_SWEEP),
          f"config 4 sweep levels {[lv['sparsity'] for lv in levels]}")
    for lv in levels:
        n_kept = int((1.0 - lv["sparsity"]) * WRN_N)
        check(lv["n_kept"] == n_kept, f"sweep level {lv['sparsity']}: n_kept {lv['n_kept']}")
        npz = T["scores_npz_path"](port["train"]["sweep_level_dir"](ckpt, lv["sparsity"]))
        with np.load(npz) as f:
            check(len(f["kept"]) == n_kept, f"{npz}: {len(f['kept'])} kept")
            T["verify_prune_manifest"](npz, f["kept"])
    epochs = [r for r in records if r["kind"] == "epoch"]
    walls = [{k: lv[k] for k in ("sparsity", "n_kept", "pretrain_wall_s", "score_wall_s",
                                  "prune_wall_s", "train_wall_s")} for lv in levels]
    rec["sweep"] = {"wall_s": sweep_wall, "levels": walls, "launches": got,
                    "epochs": epochs}
    print(f"  config 4 cli sweep ({WRN_N} examples, seeds {list(WRN_SEEDS)}, 1 pretrain "
          f"epoch a seed, 1 retrain epoch a level): exit 0 in {sweep_wall:.1f} s; "
          f"launches {got} (one scoring pass); levels {walls}", flush=True)
    for e in epochs:
        print(f"    epoch {e['tag']}: {e['examples_per_s']:.1f} ex/s in {e['epoch_s']} s",
              flush=True)

    # 6. Remat: WRN_REMAT_STEPS steps bitwise without it; GraNd bitwise; one step's peak
    # memory.
    steps = {}
    fit_ds = train.subset(train.indices[:WRN_REMAT_STEPS * WRN_TRAIN_B])
    batches = list(T["ResidentBatches"](fit_ds, WRN_TRAIN_B, "cuda", torch.bfloat16)())
    for remat in (False, True):
        cfg = port["load_config"](WRN_CONFIG, [f"model.num_classes={WRN_CLASSES}",
                                               f"model.remat={str(remat).lower()}"])
        model = port["create_model_from_cfg"](cfg).to("cuda")
        check(model.remat is remat, "model.remat not applied")
        state = T["create_train_state"](cfg, 0, "cuda", model)
        sgd = T["make_optimizer"](cfg, WRN_REMAT_STEPS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = [T["train_step"](model, sgd, state, batches[0])["loss"]]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        losses += [T["train_step"](model, sgd, state, b)["loss"] for b in batches[1:]]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (len(batches) - 1)
        grand = score(model, seeds16[:1], warm, method="grand", batch_size=B,
                      device="cuda")
        steps[remat] = (torch.stack(losses).cpu(), state, grand)
        rec.setdefault("remat", {})[str(remat).lower()] = {
            "peak_bytes": peak, "state_bytes": base, "step_ms": 1e3 * step_s}
        print(f"  train step (batch {WRN_TRAIN_B}, bf16) remat={remat}: peak CUDA memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB before the step), {1e3 * step_s:.1f} ms a step "
              f"on {card}", flush=True)
    (l0, s0, g0), (l1, s1, g1) = steps[False], steps[True]
    check(torch.equal(l0, l1) and state_equal(torch, s0, s1),
          "remat: the steps' losses, variables or batch statistics differ")
    check(np.array_equal(g0, g1), "remat: GraNd scores differ")
    print(f"  remat: {len(batches)} steps bitwise (losses, params, batch statistics, "
          f"momentum), GraNd bitwise; peak {rec['remat']['true']['peak_bytes'] / 2**30:.3f} "
          f"vs {rec['remat']['false']['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    del steps, batches

    # 7. Trajectory scores: cli score on the ResNet-18 north-star geometry.
    rec["trajectory"] = {}
    for method in ("forgetting", "aum"):
        runs = {}
        for name in ("a", "b", "cut"):
            argv = ["score", "--config",
                    os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml"),
                    "data.dataset=synthetic", f"data.synthetic_size={TRAJ_N}",
                    f"data.synthetic_noise={TRAJ_NOISE}",
                    f"score.seeds=[{','.join(str(s) for s in TRAJ_SEEDS)}]",
                    f"score.pretrain_epochs={TRAJ_EPOCHS}", f"score.method={method}",
                    f"train.checkpoint_dir={os.path.join(WRN_ROOT, method + '_' + name)}"]
            t0 = time.perf_counter()
            if name == "cut":
                rc, _, _ = with_plan(port, {"sigterm_after_seed_scores": 1},
                                     lambda: run_cli(port, argv))
                check(rc == 75, f"{method}: the preempted cli score exited {rc}")
            rc, summary, records = run_cli(port, argv)
            wall = time.perf_counter() - t0
            check(rc == 0, f"{method} cli score ({name}) exited {rc}")
            ckpt_dir = os.path.join(WRN_ROOT, f"{method}_{name}")
            with np.load(T["scores_npz_path"](ckpt_dir)) as f:
                s = f["scores"]
            partials = []
            for seed in TRAJ_SEEDS:
                with np.load(os.path.join(f"{ckpt_dir}_score_partials",
                                          f"seed{seed}.npz")) as f:
                    partials.append(f["scores"])
            done = [r["seed"] for r in records if r["kind"] == f"{method}_seed_done"]
            runs[name] = (s, wall, done, records)
            check(s.shape == (TRAJ_N,) and bool(np.isfinite(s).all()),
                  f"{method} ({name}): scores not finite")
            if method == "forgetting":
                for p in partials:   # counts of 0 or 1, or never learned: updates + 1
                    check(set(np.unique(p)) <= {0.0, 1.0, float(TRAJ_EPOCHS + 1)},
                          f"forgetting partial values {np.unique(p)}")
                if name == "a":
                    rec["trajectory"]["forgetting_per_seed"] = [
                        {"forgotten": int((p == 1).sum()),
                         "never_learned": int((p == TRAJ_EPOCHS + 1).sum())}
                        for p in partials]
            else:
                check(bool((np.abs(s) <= 1.0).all()), "aum: margins outside [-1, 1]")
        resumed = [r for r in runs["cut"][3] if r["kind"] == "score_seeds_resumed"]
        check(runs["a"][2] == list(TRAJ_SEEDS) and runs["cut"][2] == [TRAJ_SEEDS[1]]
              and len(resumed) == 1 and resumed[0]["done"] == [TRAJ_SEEDS[0]],
              f"{method}: seeds fit {runs['a'][2]}, resumed run {runs['cut'][2]}")
        check(np.array_equal(runs["a"][0], runs["b"][0]),
              f"{method}: two cli score runs differ")
        check(np.array_equal(runs["a"][0], runs["cut"][0]),
              f"{method}: the resumed run is not bitwise the uninterrupted one")
        rec["trajectory"][method] = {"walls_s": {k: v[1] for k, v in runs.items()},
                                     "mean": float(runs["a"][0].mean())}
        print(f"  {method} cli score ({TRAJ_N} examples, seeds {list(TRAJ_SEEDS)}, "
              f"{TRAJ_EPOCHS} epochs): {runs['a'][1]:.1f} s, again {runs['b'][1]:.1f} s "
              f"(bitwise), preempted after seed {TRAJ_SEEDS[0]} and resumed with seed "
              f"{TRAJ_SEEDS[1]} only in {runs['cut'][1]:.1f} s (bitwise); mean "
              f"{runs['a'][0].mean():.5f}"
              + (f"; per seed {rec['trajectory']['forgetting_per_seed']}"
                 if method == "forgetting" else ""), flush=True)
    cfg4 = port["load_config"](WRN_CONFIG, [f"model.num_classes={WRN_CLASSES}"])
    return {"counts": counts,
            "profile": {"ds": train, "cfg": cfg4, "variables": seeds16, "batch": B}}


@contextlib.contextmanager
def bn_layout_spy(gb, seen: list):
    """Record, for every stacked-BN group the GraNd route scores, whether each
    layer's x and g are NHWC views of their memory (so the route's
    ``permute(0, 2, 3, 1).contiguous()`` copies nothing)."""
    orig = gb._bn_group_contrib

    def spy(items, *args, **kwargs):
        for _, x, g in items:
            seen.append(x.permute(0, 2, 3, 1).is_contiguous()
                        and g.permute(0, 2, 3, 1).is_contiguous())
        return orig(items, *args, **kwargs)
    gb._bn_group_contrib = spy
    try:
        yield
    finally:
        gb._bn_group_contrib = orig


def routes_phase(torch, port, details_out, card: str) -> dict:
    """Every launch-table route at full width: counts, ex/s, then parity."""
    gb, K = port["grand_batched"], port["kernels"]
    cfg = port["load_config"](os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={ROUTE_N}",
        "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}",
        f"score.batch_size={B}", "train.half_precision=true"])
    ds, _ = port["load_dataset"]("synthetic", synthetic_size=ROUTE_N, seed=0)
    model = port["create_model_from_cfg"](cfg)
    variables = [port["init_variables"]("resnet18", s, "cuda") for s in SEEDS]
    runs = ROUTE_N // B * len(SEEDS)
    warm = ds.subset(ds.indices[:B])
    totals = dict.fromkeys(K.KERNELS, 0)
    results = {}
    for name, method, flags, per_batch in ROUTES:
        with toggles(gb, flags):
            port["score_dataset"](model, variables[:1], warm, method=method,
                                  batch_size=B, device="cuda")
            K.reset_launch_counts()
            views: list = []
            with bn_layout_spy(gb, views):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scores = port["score_dataset"](model, variables, ds, method=method,
                                               batch_size=B, device="cuda")
                wall = time.perf_counter() - t0
            counts = K.launch_counts()
        if flags.get("USE_BN_KERNEL"):
            print(f"  route {name}: {sum(views)} of {len(views)} BatchNorm (x, g) pairs are "
                  "NHWC views (the stacked-BN kernel's inputs copy nothing)", flush=True)
            check(views and all(views), f"route {name}: a BatchNorm input or cotangent is "
                                        "not an NHWC view, so the route copies it")
        want = {k: per_batch.get(k, 0) * runs for k in K.KERNELS}
        check(counts == want, f"route {name}: launch counts {counts}, want {want}")
        for kern, modes in K.mode_counts().items():   # every bf16 launch on the tensor
            check_modes(K, dict.fromkeys(modes, 0), counts[kern],   # cores, BN in vector
                        route_mode(K, kern, torch.bfloat16), f"route {name}", kern)
        check(scores.shape == (ROUTE_N,) and bool(np.isfinite(scores).all())
              and bool((scores >= 0).all()), f"route {name}: scores not finite/>= 0")
        for k, n in counts.items():
            totals[k] += n
        ex_s = ROUTE_N * len(SEEDS) / wall
        results[name] = {"scores": scores, "wall_s": wall, "ex_per_s": ex_s,
                         "launches": {k: n for k, n in counts.items() if n}}
        print(f"  route {name}: {ROUTE_N} examples x {len(SEEDS)} seeds in {wall:.3f} s = "
              f"{ex_s:.1f} ex/s on {card}; launches per batch per seed "
              f"{ {k: n // runs for k, n in counts.items() if n} }", flush=True)

    # Each route against the default two-phase route: fp32, TF32 off, BN randomized.
    port["set_parity_mode"](True)
    cfg32 = port["load_config"](None, ["data.dataset=synthetic", "model.arch=resnet18",
                                       "train.half_precision=false"])
    model32 = port["create_model_from_cfg"](cfg32)
    v = bn_randomized(torch, port, 11)
    sub = ds.subset(ds.indices[:B])
    parity = {}

    def score32(method, data, batch_size=B, **kw):
        return port["score_dataset"](model32, [v], data, method=method,
                                     batch_size=batch_size, device="cuda", **kw)
    base = score32("grand", sub)
    for name, method, flags, _ in ROUTES[1:]:
        launches0, modes0 = K.launch_counts(), K.mode_counts()
        with toggles(gb, flags):
            got = score32(method, sub)
        for kern in modes0:   # every fp32 parity launch on the CUDA cores, BN in vector
            check_modes(K, modes0[kern], K.launch_counts()[kern] - launches0[kern],
                        route_mode(K, kern, torch.float32), f"route {name} fp32", kern)
        ref = base if method == "grand" else score32(method, sub, use_kernels=False)
        parity[name] = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)))
        against = "default two-phase route" if method == "grand" else "plain route"
        print(f"  route {name} fp32 vs the {against} ({B} examples, BN randomized): "
              f"max rel err {parity[name]:.3e}", flush=True)
        check(parity[name] <= 1e-4, f"route {name}: rel err {parity[name]:.3e} > 1e-4")
    # grand_vmap (its own chunk of 32) on the first 64 examples against the default
    # route's batch-512 scores of them; both against the plain route in float64.
    n64 = 64
    sub64 = ds.subset(ds.indices[:n64])
    t0 = time.perf_counter()
    vmap = score32("grand_vmap", sub64, batch_size=n64, chunk=32)
    vmap_s = time.perf_counter() - t0
    batched = base[:n64]
    model64 = port["create_model_from_cfg"](cfg32).to("cuda").double()
    model64.dtype = torch.float64     # the ResNet casts its input to this type
    v64 = {k: t.double() for k, t in v.items()}
    ref64 = port["grand_batched"].batched_grand_scores(
        model64, v64, torch.from_numpy(sub64.images).to("cuda").double(),
        torch.from_numpy(sub64.labels).to("cuda"),
        torch.ones(n64, device="cuda", dtype=torch.float64)).cpu().numpy()

    def max_rel(got, ref):
        return float(np.max(np.abs(got - ref) / np.abs(ref)))
    parity.update(grand_vmap=max_rel(vmap, batched), grand_vmap_vs_fp64=max_rel(vmap, ref64),
                  grand_vs_fp64=max_rel(batched, ref64))
    print(f"  grand_vmap fp32 vs the default route ({n64} examples; chunk 32 against "
          f"batch {B}, {vmap_s:.3f} s): max rel err {parity['grand_vmap']:.3e}; against "
          f"the plain route in float64: grand_vmap {parity['grand_vmap_vs_fp64']:.3e}, "
          f"default route {parity['grand_vs_fp64']:.3e} (rtol 1e-4)", flush=True)
    check(bool(np.all(np.abs(vmap - batched) <= 1e-5 + 2e-4 * np.abs(batched))),
          "grand_vmap: not within rtol 2e-4, atol 1e-5 of grand")
    check(parity["grand_vmap_vs_fp64"] <= 1e-4 and parity["grand_vs_fp64"] <= 1e-4,
          "grand_vmap or grand: not within rtol 1e-4 of the float64 plain route")
    port["set_parity_mode"](False)
    details_out["routes"] = {n: {k: x for k, x in r.items() if k != "scores"}
                             for n, r in results.items()}
    details_out["route_parity"].update(parity)
    return {"cfg": cfg, "ds": ds, "variables": variables, "results": results,
            "counts": totals}


def serve_routes_phase(torch, port, routes, details_out) -> None:
    """``score_batch`` bitwise equal to ``full_scores`` on the last-layer kernel
    route and on the fused megakernel route."""
    ds = routes["ds"]
    rng = np.random.default_rng(1)
    with toggles(port["grand_batched"], MEGA_ROUTE):
        engine = port["ServeEngine"](routes["cfg"], device="cuda")
        engine.register_tenant("routes", ds, routes["variables"])
        for method, route in (("grand_last_layer", "grand_last_layer"),
                              ("grand", "FUSED+MEGAKERNEL")):
            full = engine.full_scores("routes", method)
            check(np.array_equal(full, routes["results"][route]["scores"]),
                  f"{route}: ServeEngine.full_scores differs from score_dataset")
            for n in (1, 100, 512):
                ids = rng.choice(ds.indices, size=n, replace=False)
                images, labels = engine.examples_for("routes", ids)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = engine.score_batch("routes", method, images, labels)
                ms = 1e3 * (time.perf_counter() - t0)
                want = full[engine.tenant("routes").pos_of(ids)]
                check(got.dtype == np.float32 and np.array_equal(got, want),
                      f"{route}: score_batch({n}) not bitwise equal to full_scores "
                      f"(max abs diff {np.abs(got - want).max():.3e})")
                details_out.setdefault("serve", {})[f"{route}_score_batch_{n}_ms"] = ms
                print(f"  {route}: score_batch({n}) bitwise equal to full_scores, "
                      f"{ms:.2f} ms", flush=True)


def serve_phase(torch, port, path, details_out) -> None:
    engine = port["ServeEngine"](path["cfg"], device="cuda")
    ds = path["ds"]
    engine.register_tenant("synthetic", ds, path["variables"])
    rng = np.random.default_rng(0)
    for method in ("el2n", "grand"):
        t0 = time.perf_counter()
        full = engine.full_scores("synthetic", method)
        full_s = time.perf_counter() - t0
        check(np.array_equal(full, path["results"][method]["scores"]),
              f"{method}: ServeEngine.full_scores differs from score_dataset")
        for n in (1, 100, 512):
            ids = rng.choice(ds.indices, size=n, replace=False)
            images, labels = engine.examples_for("synthetic", ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = engine.score_batch("synthetic", method, images, labels)
            ms = 1e3 * (time.perf_counter() - t0)
            want = full[engine.tenant("synthetic").pos_of(ids)]
            check(got.dtype == np.float32 and np.array_equal(got, want),
                  f"{method}: score_batch({n}) not bitwise equal to full_scores "
                  f"(max abs diff {np.abs(got - want).max():.3e})")
            print(f"  {method}: score_batch({n}) bitwise equal to full_scores, "
                  f"{ms:.2f} ms", flush=True)
            details_out.setdefault("serve", {})[f"{method}_score_batch_{n}_ms"] = ms
        top = list(engine.topk("synthetic", method, 10))
        order = np.lexsort((ds.indices, -full))[:10]
        check([i for i, _ in top] == [int(ds.indices[p]) for p in order],
              f"{method}: topk order")
        ids = rng.choice(ds.indices, size=64, replace=False)
        r_ids, r_scores = engine.rank("synthetic", method, ids)
        check(bool(np.all(np.diff(r_scores) <= 0)), f"{method}: rank not descending")
        check(sorted(r_ids.tolist()) == sorted(ids.tolist()), f"{method}: rank ids")
        kept = port["select_indices"](full, ds.indices, 0.5, keep="hardest")
        check(len(kept) == N_PATH // 2, f"{method}: kept {len(kept)}")
        print(f"  {method}: full_scores {full_s:.3f} s, topk(10) {top[:2]}..., "
              f"rank(64) ok, keep-hardest at sparsity 0.5 keeps {len(kept)}", flush=True)


# Service phase: the port's HTTP service (``serve/``, ``cli serve``) at the path's
# geometry. Its checkpoints and records go to the ignored chip_smoke_out/ and are
# removed after a pass.
SERVICE_ROOT = os.path.join(REPO, "chip_smoke_out", "service")
SERVICE_CLIENTS = 4            # client threads per method
SERVICE_REQUESTS = 25          # requests per client thread
SERVICE_MAX_IDS = 64           # a request scores 1..64 random ids
SERVICE_WEDGE_S = 3.0          # the wedged dispatch's hang
SERVICE_STALL_S = 0.5          # serve.dispatch_stall_s of the admission drill
SERVICE_DRAIN_S = 10.0         # serve.drain_timeout_s of the cli serve process
SERVICE_EXIT_GRACE_S = 20.0    # its exit after the drain: teardown of the CUDA context


def http_call(port: int, path: str, body=None, timeout: float = 120.0):
    """``(status, headers, body bytes)`` of one request to the local service;
    an HTTP error status is a result, a transport error raises."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def scores_of(raw: bytes) -> np.ndarray:
    return np.asarray(json.loads(raw)["scores"], np.float32)


def service_cfg(port, *over):
    return port["load_config"](os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={N_PATH}",
        "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}",
        f"score.batch_size={B}", "train.half_precision=true", "serve.port=0",
        "serve.methods=[el2n,grand]", "serve.tenant=synthetic",
        f"obs.metrics_path={SERVICE_ROOT}/metrics.jsonl",
        f"obs.heartbeat_dir={SERVICE_ROOT}/hb",
        f"train.checkpoint_dir={SERVICE_ROOT}/ckpt", *over])


def validate_stream(path: str, expect_terminal: bool = False) -> int:
    """Every record of a metrics stream passes the port's
    ``tools/validate_metrics.py``'s ``validate_lines``, ending in
    ``run_summary`` when ``expect_terminal``; returns the count."""
    from data_diet_distributed_tpu_torch.tools import validate_metrics as vm
    with open(path) as fh:
        lines = fh.read().splitlines()
    problems = vm.validate_lines(lines, where=path, expect_terminal=expect_terminal)
    check(problems == [], f"{path}: {problems[:5]}")
    return len(lines)


def service_phase(torch, port, path, details_out, card: str) -> dict:
    """The serving slice end to end on the card (ResNet-18 full width, the path's
    ``N_PATH`` examples, seeds [0, 1], batch 512, bf16, ``el2n`` and ``grand``):
    1, an in-process ``ServeService`` on port 0 under load, every answer bitwise
    the offline pass and the launches of one served dispatch exact; 2, admission
    (429) and a wedged dispatcher (/healthz critical); 3, refresh to a
    checkpoint step (bitwise an offline pass on it) and the refusal of a
    truncated one (409); 4, ``cli serve`` as a subprocess: bitwise over HTTP and
    the SIGTERM drain to exit 75. Nothing is caught; the walls are printed."""
    t0 = time.perf_counter()
    shutil.rmtree(SERVICE_ROOT, ignore_errors=True)
    os.makedirs(SERVICE_ROOT)
    rec = details_out.setdefault("service", {})
    counts = _service_in_process(torch, port, path, rec, card)
    _service_cli(torch, port, path, rec)
    rec["phase_wall_s"] = wall = time.perf_counter() - t0
    print(f"  service phase: {wall:.1f} s", flush=True)
    shutil.rmtree(SERVICE_ROOT, ignore_errors=True)
    return {"counts": counts}


def _service_in_process(torch, port, path, rec: dict, card: str) -> dict:
    sv = port["serve"]
    K = port["kernels"]
    ds, full = path["ds"], {m: path["results"][m]["scores"] for m in ("el2n", "grand")}
    cfg = service_cfg(port)
    logger = sv["MetricsLogger"](cfg.obs.metrics_path, echo=False)
    with sv["ObsSession"](cfg, logger=logger):
        K.reset_launch_counts()
        engine = port["ServeEngine"](cfg, device="cuda", logger=logger)
        engine.register_tenant("synthetic", ds, path["variables"])
        warm = {}
        for method in ("el2n", "grand"):
            t0 = time.perf_counter()
            got = engine.full_scores("synthetic", method)
            warm[method] = time.perf_counter() - t0
            check(np.array_equal(got, full[method]),
                  f"service {method}: the warm pass differs from score_dataset")
        programs = engine.program_stats()
        print(f"  warm (full_scores on the main thread, before the socket binds): "
              + ", ".join(f"{m} {w:.3f} s" for m, w in warm.items())
              + "; first call per program key: "
              + ", ".join(f"{k} {v['compile_s']} s" for k, v in programs.items()), flush=True)
        rec["warm_s"], rec["programs"] = warm, programs
        service = sv["ServeService"](engine, cfg, logger=logger)
        check(service.start(), "service: the socket did not bind")
        try:
            _service_load(torch, sv, K, service, ds, full, rec, card)
        finally:
            service.stop()
        counts = K.launch_counts()
        for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram", "el2n"):
            check(counts[kern] > 0, f"service: {kern} never launched: {counts}")
        _service_admission(torch, port, engine, ds, full, rec)
        _service_refresh(torch, port, engine, ds, rec)
    logger.close()
    n = validate_stream(cfg.obs.metrics_path)
    print(f"  service records: {n} lines, all valid", flush=True)
    return counts


def _service_load(torch, sv, K, service, ds, full, rec: dict, card: str) -> None:
    import threading
    sp = service.port
    tenant = service.engine.tenant("synthetic")
    # Launches of one served full-batch dispatch, exact.
    for method in ("grand", "el2n"):
        ids = np.random.default_rng(7).choice(ds.indices, size=B, replace=False)
        before, modes0 = K.launch_counts(), K.mode_counts()
        status, _, raw = http_call(sp, "/v1/score", {"indices": ids.tolist(),
                                                    "method": method})
        after = K.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = dict.fromkeys(K.KERNELS, 0)
        if method == "grand":
            want.update(conv_grad_norm_direct=12 * len(SEEDS),
                        conv_grad_norm_gram=3 * len(SEEDS))
            for kern in ("conv_grad_norm_direct", "conv_grad_norm_gram"):
                check_modes(K, modes0[kern], want[kern], "tensor_core", "served grand", kern)
        else:
            want["el2n"] = len(SEEDS)
        check(status == 200 and delta == want,
              f"served {method} dispatch of {B} rows: status {status}, launches {delta}, "
              f"want {want}")
        check(np.array_equal(scores_of(raw), full[method][tenant.pos_of(ids)]),
              f"served {method} full batch not bitwise full_scores")
        print(f"  one served {method} dispatch of {B} rows: launches "
              f"{ {k: v for k, v in delta.items() if v} } (per seed: "
              f"{ {k: v // len(SEEDS) for k, v in delta.items() if v} }), bitwise", flush=True)
    # Four client threads x 25 requests of 1..64 random ids, per method.
    for method in ("el2n", "grand"):
        sv["registry"].install(sv["registry"].MetricsRegistry())   # per-method phases
        b0 = service.batcher.stats()
        lat, bad, n_ids = [], [], [0]
        lock = threading.Lock()

        def client(k: int) -> None:
            rng = np.random.default_rng(100 + k)
            for _ in range(SERVICE_REQUESTS):
                ids = rng.choice(ds.indices, size=int(rng.integers(1, SERVICE_MAX_IDS + 1)),
                                 replace=False)
                t1 = time.perf_counter()
                status, _, raw = http_call(sp, "/v1/score", {"indices": ids.tolist(),
                                                            "method": method})
                ms = 1e3 * (time.perf_counter() - t1)
                ok = status == 200 and np.array_equal(
                    scores_of(raw), full[method][tenant.pos_of(ids)])
                with lock:
                    lat.append(ms)
                    n_ids[0] += len(ids)
                    if not ok:
                        bad.append((status, raw[:200]))

        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVICE_CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t1
        check(not any(t.is_alive() for t in threads), f"service {method}: clients hung")
        check(not bad, f"service {method}: {len(bad)} answers not 200 and bitwise: {bad[:3]}")
        b1 = service.batcher.stats()
        dispatches = b1["dispatches"] - b0["dispatches"]
        rows = b1["rows_dispatched"] - b0["rows_dispatched"]
        phases = sv["reqtrace"].phase_summary()
        # The batcher's own wall (enqueue -> scores ready), without HTTP and JSON.
        queued = sv["registry"].current().snapshot()["histograms"]["serve_request_ms"]
        out = {"requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)), "ex_per_s": n_ids[0] / wall,
               "wall_s": wall, "dispatches": dispatches,
               "batch_fill": rows / max(1, dispatches * B),
               "batcher_p50_ms": queued["p50"], "batcher_p95_ms": queued["p95"],
               "phases_p50_ms": {k: v["p50"] for k, v in phases.items()},
               "phases_p95_ms": {k: v["p95"] for k, v in phases.items()}}
        rec.setdefault("load", {})[method] = out
        print(f"  {method}: {SERVICE_CLIENTS} clients x {SERVICE_REQUESTS} requests "
              f"({n_ids[0]} ids) all 200 and bitwise; request p50 {out['p50_ms']:.2f} ms, "
              f"p95 {out['p95_ms']:.2f} ms (in the batcher p50 {queued['p50']:.2f}, p95 "
              f"{queued['p95']:.2f}); {out['ex_per_s']:.1f} served ex/s; "
              f"{dispatches} dispatches, batch_fill {out['batch_fill']:.4f}; phase p50/p95 ms "
              + ", ".join(f"{k} {v['p50']:.3f}/{v['p95']:.3f}" for k, v in phases.items())
              + f" on {card}", flush=True)
    # /v1/rank on 100 ids, /v1/topk?k=100, and the images route.
    rng = np.random.default_rng(11)
    for method in ("el2n", "grand"):
        ids = rng.choice(ds.indices, size=100, replace=False)
        status, _, raw = http_call(sp, "/v1/rank", {"indices": ids.tolist(), "method": method})
        r_ids, r_scores = service.engine.rank("synthetic", method, ids)
        got = json.loads(raw)
        check(status == 200 and got["indices"] == r_ids.tolist()
              and np.array_equal(np.asarray(got["scores"], np.float32), r_scores),
              f"service {method}: /v1/rank not the engine's rank")
        status, _, raw = http_call(sp, f"/v1/topk?k=100&method={method}")
        items = [json.loads(x) for x in raw.splitlines() if x.strip()]
        want = list(service.engine.topk("synthetic", method, 100))
        check(status == 200 and [(i["index"], np.float32(i["score"])) for i in items]
              == [(i, np.float32(s)) for i, s in want],
              f"service {method}: /v1/topk not the engine's topk")
        rows = rng.choice(ds.indices, size=100, replace=False)
        images, labels = service.engine.examples_for("synthetic", rows)
        s_img, _, raw_img = http_call(sp, "/v1/score", {
            "images": images.tolist(), "labels": labels.tolist(), "method": method})
        s_idx, _, raw_idx = http_call(sp, "/v1/score", {"indices": rows.tolist(),
                                                        "method": method})
        check(s_img == s_idx == 200 and np.array_equal(scores_of(raw_img), scores_of(raw_idx)),
              f"service {method}: the images route differs from the indices route")
    print("  /v1/rank (100 ids) and /v1/topk?k=100 bitwise the engine's; a 100-row "
          "images request bitwise the indices request, both methods", flush=True)


def _service_admission(torch, port, engine, ds, full, rec: dict) -> None:
    """``serve.max_queue=2`` and a dispatcher wedged by ``DDT_FAULT_PLAN``: a
    submit past the queue gets 429 + Retry-After, /healthz turns critical
    naming the stalled dispatcher, and every queued request completes bitwise."""
    import threading
    sv, inject = port["serve"], port["inject"]
    cfg = service_cfg(port, "serve.max_queue=2", f"serve.dispatch_stall_s={SERVICE_STALL_S}")
    service = sv["ServeService"](engine, cfg, logger=None)
    check(service.start(), "admission drill: the socket did not bind")
    os.environ["DDT_FAULT_PLAN"] = json.dumps({"wedge_dispatcher_after": 1,
                                               "hang_seconds": SERVICE_WEDGE_S})
    inject.activate_from_env()
    try:
        sp, pos_of = service.port, engine.tenant("synthetic").pos_of
        out: dict = {}

        def send(key, ids):
            out[key] = (ids, http_call(sp, "/v1/score", {"indices": ids, "method": "grand"}))

        threads = []
        for i, key in enumerate(("wedged", "queued1", "queued2")):
            threads.append(threading.Thread(target=send, args=(key, [3 * i, 3 * i + 1])))
            threads[-1].start()
            time.sleep(0.3)   # the first is taken and wedged, the next two queue
        status, headers, raw = http_call(sp, "/v1/score", {"indices": [99],
                                                           "method": "grand"})
        check(status == 429 and int(headers.get("Retry-After", 0)) >= 1,
              f"admission: a submit past serve.max_queue got {status} {headers}")
        deadline, health = time.monotonic() + 10, None
        while time.monotonic() < deadline:
            code, _, raw = http_call(sp, "/healthz")
            health = json.loads(raw)
            if code == 503:
                break
            time.sleep(0.05)
        check(health["status"] == "critical"
              and any("serve dispatcher stalled" in r for r in health["reasons"]),
              f"admission: /healthz did not turn critical: {health}")
        for t in threads:
            t.join(120)
        for key, (ids, (code, _, raw)) in out.items():
            check(code == 200 and np.array_equal(scores_of(raw),
                                                 full["grand"][pos_of(np.asarray(ids))]),
                  f"admission: {key} request got {code} or differs after the wedge")
        check(json.loads(http_call(sp, "/healthz")[2])["status"] == "ok",
              "admission: /healthz not ok after the wedge")
    finally:
        inject.deactivate()
        del os.environ["DDT_FAULT_PLAN"]
        service.stop()
    rec["admission"] = {"reject_status": 429, "retry_after_s": headers.get("Retry-After"),
                        "healthz_reasons": health["reasons"]}
    print(f"  admission: 429 + Retry-After {headers.get('Retry-After')} past "
          f"serve.max_queue=2; /healthz critical ({health['reasons'][0]}); the wedged and "
          "queued requests completed bitwise after the wedge", flush=True)


def _service_refresh(torch, port, engine, ds, rec: dict) -> None:
    """Steps 1 (init) and 2 (BN-randomized) written with the port's
    ``CheckpointManager``: ``/v1/refresh {"step": 2}`` installs, and the served
    scores and topk equal an offline ``score_dataset`` on step 2's variables
    bitwise; a truncated step 3 gives 409 and step 2 keeps serving."""
    sv, inject = port["serve"], port["inject"]
    cfg = service_cfg(port)
    model = port["create_model_from_cfg"](cfg)
    mngr = port["CheckpointManager"](cfg.train.checkpoint_dir)
    to_state = port["train"]["state_from_variables"]
    mngr.save(1, to_state(port["init_variables"]("resnet18", 0, "cuda"), model))
    mngr.save(2, to_state(bn_randomized(torch, port, 2), model))
    mngr.save(3, to_state(bn_randomized(torch, port, 3), model))
    inject.truncate_checkpoint(cfg.train.checkpoint_dir, 3)
    service = sv["ServeService"](engine, cfg, logger=None)
    check(service.start(), "refresh: the socket did not bind")
    try:
        sp = service.port
        t0 = time.perf_counter()
        status, _, raw = http_call(sp, "/v1/refresh", {"step": 2})
        wall = time.perf_counter() - t0
        check(status == 200 and json.loads(raw)["status"] == "installed",
              f"refresh to step 2: {status} {raw[:300]}")
        v2 = mngr.restore_variables(2, "cuda")
        ids = np.random.default_rng(5).choice(ds.indices, size=200, replace=False)
        pos = engine.tenant("synthetic").pos_of(ids)
        offline = {}
        for method in ("el2n", "grand"):
            offline[method] = port["score_dataset"](model, [v2], ds, method=method,
                                                    batch_size=B, device="cuda")
            code, _, raw = http_call(sp, "/v1/score", {"indices": ids.tolist(),
                                                       "method": method})
            check(code == 200 and np.array_equal(scores_of(raw), offline[method][pos]),
                  f"refresh: served {method} not bitwise score_dataset on step 2")
            code, _, raw = http_call(sp, f"/v1/topk?k=100&method={method}")
            order = np.lexsort((ds.indices, -offline[method]))[:100]
            items = [json.loads(x) for x in raw.splitlines() if x.strip()]
            check([i["index"] for i in items] == ds.indices[order].tolist()
                  and np.array_equal(np.asarray([i["score"] for i in items], np.float32),
                                     offline[method][order]),
                  f"refresh: {method} topk not bitwise score_dataset on step 2")
        code, _, raw = http_call(sp, "/v1/refresh", {"step": 3})
        check(code == 409 and json.loads(raw)["status"] == "rejected",
              f"refresh to truncated step 3: {code} {raw[:300]}")
        code, _, raw = http_call(sp, "/v1/score", {"indices": ids.tolist(), "method": "grand"})
        check(code == 200 and np.array_equal(scores_of(raw), offline["grand"][pos]),
              "refresh: after the refused step 3 the scores are not step 2's")
    finally:
        service.stop()
    rec["refresh_ms"] = 1e3 * wall
    print(f"  refresh: step 2 installed in {1e3 * wall:.1f} ms; served scores and topk "
          "bitwise score_dataset on step 2; truncated step 3 -> 409, step 2 still "
          "serving bitwise", flush=True)


def _service_cli(torch, port, path, rec: dict) -> None:
    """``python -m data_diet_distributed_tpu_torch.cli serve`` on the card: the
    port from its ``obs_server`` record; with its first dispatch wedged
    (``DDT_FAULT_PLAN``) several requests are accepted, a SIGTERM lands, a later
    request gets 503, every accepted one answers 200 bitwise the in-process
    scores, and the process exits 75 with ``[preempted]`` within
    ``SERVICE_DRAIN_S`` + ``SERVICE_EXIT_GRACE_S``; every record is valid."""
    import queue
    import signal
    import threading
    metrics = os.path.join(SERVICE_ROOT, "cli_metrics.jsonl")
    args = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve",
            "--config", os.path.join(REPO, "configs", "cifar10_resnet18.yaml"),
            "data.dataset=synthetic", f"data.synthetic_size={N_PATH}",
            "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}",
            f"score.batch_size={B}", "train.half_precision=true", "serve.port=0",
            "serve.methods=[el2n,grand]", f"serve.drain_timeout_s={SERVICE_DRAIN_S}",
            f"obs.metrics_path={metrics}", f"train.checkpoint_dir={SERVICE_ROOT}/cli_ckpt"]
    env = {**os.environ, "PYTHONPATH": REPO,
           "DDT_FAULT_PLAN": json.dumps({"wedge_dispatcher_after": 1,
                                         "hang_seconds": SERVICE_WEDGE_S})}
    t_boot = time.perf_counter()
    proc = subprocess.Popen(args, cwd=SERVICE_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    # Its stderr (records and the banner) drains on a thread, so the process
    # never blocks on a full pipe and the wait for the port has a deadline.
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stderr], daemon=True).start()
    try:
        sp = None
        while sp is None:
            left = 300 - (time.perf_counter() - t_boot)
            check(left > 0 and proc.poll() is None,
                  f"cli serve never announced its port (exit {proc.poll()})")
            try:
                line = lines.get(timeout=min(left, 5.0))
            except queue.Empty:
                continue
            if line.startswith("{") and json.loads(line).get("kind") == "obs_server":
                sp = json.loads(line)["port"]
        boot = time.perf_counter() - t_boot
        full = path["results"]["grand"]["scores"]
        out: dict = {}

        def send(key, ids):
            out[key] = (ids, http_call(sp, "/v1/score", {"indices": ids, "method": "grand"}))

        threads = []
        for i in range(6):   # the first wedges the dispatcher, the rest queue
            threads.append(threading.Thread(target=send, args=(i, [5 * i, 5 * i + 2, N_PATH // 2 + i])))
            threads[-1].start()
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        t_term = time.perf_counter()
        time.sleep(0.5)
        late, _, late_raw = http_call(sp, "/v1/score", {"indices": [1], "method": "grand"})
        for t in threads:
            t.join(120)
        rc = proc.wait(timeout=SERVICE_DRAIN_S + SERVICE_EXIT_GRACE_S)
        exit_s = time.perf_counter() - t_term
        stdout = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(late == 503, f"cli serve: a request after SIGTERM got {late} {late_raw[:200]}")
    ds = path["ds"]
    pos = {int(i): k for k, i in enumerate(ds.indices)}
    for key, (ids, (code, _, raw)) in sorted(out.items()):
        check(code == 200 and np.array_equal(scores_of(raw), full[[pos[i] for i in ids]]),
              f"cli serve: accepted request {key} got {code} or differs from the "
              "in-process scores")
    check(rc == 75 and "[preempted]" in stdout, f"cli serve: exit {rc}, stdout {stdout[-500:]}")
    check(exit_s <= SERVICE_DRAIN_S + SERVICE_EXIT_GRACE_S, f"cli serve: exit took {exit_s:.1f} s")
    n = validate_stream(metrics)
    with open(metrics) as fh:
        recs = [json.loads(x) for x in fh if x.strip()]
    warm = {r["method"]: r["warm_s"] for r in recs
            if r["kind"] == "serve_stats" and r.get("event") == "warm"}
    programs = next(r["programs"] for r in recs if r["kind"] == "serve_stats"
                    and r.get("programs"))
    check(recs[-1]["kind"] == "run_summary" and recs[-1]["exit_class"] == "preempted",
          f"cli serve: the stream ends with {recs[-1]}")
    rec["cli"] = {"boot_s": boot, "warm_s": warm, "programs": programs,
                  "exit_after_sigterm_s": exit_s, "records": n}
    print(f"  cli serve: port {sp} announced {boot:.1f} s after launch (warm "
          + ", ".join(f"{m} {w} s" for m, w in warm.items()) + "; first calls "
          + ", ".join(f"{k} {v['compile_s']} s" for k, v in programs.items())
          + f"); {len(out)} accepted requests 200 and bitwise the in-process scores, a "
          f"request after SIGTERM 503; exit 75 with [preempted] {exit_s:.1f} s after "
          f"SIGTERM; {n} records valid", flush=True)


# Device-time groups for the profile, by kernel name (first match wins).
PROFILE_GROUPS = (
    ("conv_grad_norm_direct", ("::direct_kernel<", "::direct_mma_kernel(",
                               "::finalize_kernel<")),
    ("conv_grad_norm_gram", ("::gram_kernel<",)),
    ("el2n", ("::el2n_kernel",)),
    ("conv_bwd_grad_norm (megakernel)", ("::bwd_norm_kernel(", "::bwd_norm_mma_kernel(")),
    ("conv_grad_norm_catdot", ("::catdot_kernel(", "::catdot_mma_kernel(")),
    ("bn_grad_norm", ("::bn_vector_kernel<", "::bn_scalar_kernel<")),
    ("grand_last_layer", ("::gll_kernel",)),
    ("cuDNN conv (forward, input gradient)", ("fprop", "dgrad", "cudnn", "nhwcAddPadding")),
    ("batch norm (forward, backward)", ("batch_norm",)),
    ("copies and dtype casts", ("copy", "Memcpy", "Memset", "CatArray")),
    ("cuBLAS (plain-route bmm, classifier)", ("gemm",)),
)


def _profile_group(name: str) -> str:
    for group, needles in PROFILE_GROUPS:
        if any(n in name for n in needles):
            return group
    return "other elementwise and reductions"


def _profile_batch(torch, port, path, out_dir: str, label: str) -> dict:
    """torch.profiler over one GraNd batch (one seed, ``path["batch"]`` examples,
    512 by default, the whole ``score_dataset`` call) on the route the toggles
    select: device time by kernel, the device-busy share of the call's wall,
    and the count of cuDNN input-gradient (dgrad) kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = path.get("batch", B)
    ds = path["ds"].subset(path["ds"].indices[:batch])
    model = port["create_model_from_cfg"](path["cfg"])
    args = dict(method="grand", batch_size=batch, device="cuda")
    port["score_dataset"](model, path["variables"][:1], ds, **args)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port["score_dataset"](model, path["variables"][:1], ds, **args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # Device-side events only (kernels, copies): operator rows also carry the
    # device time of the kernels they launch, so summing them would count it twice.
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in device)
    by_kernel = sorted(((e.key, 1e-3 * e.self_device_time_total) for e in device),
                       key=lambda kv: -kv[1])
    dgrad = sum(e.count for e in device if "dgrad" in e.key.lower())
    groups: dict[str, float] = {}
    for key, ms in by_kernel:
        groups[_profile_group(key)] = groups.get(_profile_group(key), 0.0) + ms
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "a") as fh:
        fh.write(f"== {label}\n")
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40) + "\n")
    print(f"  {label}: one GraNd batch ({batch} examples, 1 seed): wall {wall_ms:.3f} ms under "
          f"the profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %); cuDNN dgrad kernel launches: {dgrad}",
          flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.3f} ms  {100 * ms / busy_ms:5.1f} %  {group}", flush=True)
    for key, ms in by_kernel[:16]:
        print(f"    {ms:9.3f} ms  {key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "dgrad_launches": dgrad,
            "device_ms_by_group": groups, "device_ms_by_kernel": by_kernel}


# Profiled routes: (label, DDT_GRAND_* module attributes, details key).
PROFILE_ROUTES = [
    ("default route", {}, "profile"),
    ("FUSED+MEGAKERNEL route", MEGA_ROUTE, "profile_megakernel"),
    ("BN_KERNEL route", {"USE_BN_KERNEL": True}, "profile_bn_kernel"),
    ("BN_KERNEL+GROUP_BN+GROUP_CONV route",
     {"USE_BN_KERNEL": True, "GROUP_BN": True, "GROUP_CONV": True}, "profile_bn_grouped"),
]


def profile_phase(torch, port, path, details_out, out_dir: str, config5: dict,
                  config4: dict) -> None:
    """Profile one GraNd batch on the default route, the fused megakernel route
    and the two stacked-BN routes, and one batch each of config 5 (ResNet-50
    at 96x96, batch 256; ``config5`` from the data phase) and config 4
    (WRN-28-10, batch 512; ``config4`` from the wrn phase) on the default route;
    report whether a cuDNN dgrad ran for the megakernel's layers, and hold
    each route's profiled BN and Gram kernel time per batch beside the kernel
    phase's device_ms sums."""
    os.makedirs(out_dir, exist_ok=True)
    open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w").close()   # batches append
    for label, flags, key in PROFILE_ROUTES:
        with toggles(port["grand_batched"], flags):
            details_out[key] = _profile_batch(torch, port, path, out_dir, label)
    details_out["profile_config5"] = _profile_batch(
        torch, port, config5, out_dir, "config 5 (ResNet-50, 96x96, batch 256), default route")
    details_out["profile_config4"] = _profile_batch(
        torch, port, config4, out_dir, "config 4 (WRN-28-10, batch 512), default route")
    base = details_out["profile"]["dgrad_launches"]
    mega = details_out["profile_megakernel"]
    # The default route runs a dgrad for 19 convs (every conv but the stem); on the
    # megakernel route 10 of them get dx from the megakernel instead.
    print(f"  cuDNN dgrad launches per batch: default route {base}, megakernel route "
          f"{mega['dgrad_launches']}", flush=True)
    check(base > 0 and base % 19 == 0 and mega["dgrad_launches"] == base - 10 * base // 19,
          "a cuDNN dgrad ran for a megakernel layer (or none was identified by name)")
    # Cross-check: the kernel phase's device_ms (bf16, a run of launches on random
    # inputs), summed over the launches each route makes, against the profiler.
    rows = [r for r in details_out["kernels"] if r["dtype"] == "bfloat16"]

    def dev(kernel, **match):
        return sum(r["device_ms"] for r in rows if r["kernel"] == kernel
                   and all(r.get(k) == v for k, v in match.items()))
    want = {"profile": {"conv_grad_norm_gram": 3 * dev("conv_grad_norm_gram", x=[B, 4, 4, 512])},
            "profile_bn_kernel": {
                "bn_grad_norm": 5 * dev("bn_grad_norm", layers=1, layers_per_batch=5),
                "conv_grad_norm_gram": 3 * dev("conv_grad_norm_gram", x=[B, 4, 4, 512])},
            "profile_bn_grouped": {
                "bn_grad_norm": dev("bn_grad_norm", layers=5),
                "conv_grad_norm_gram": dev("conv_grad_norm_gram", x=[3 * B, 4, 4, 512])}}
    for key, kernels in want.items():
        got = details_out[key]["device_ms_by_group"]
        for kernel, ms in kernels.items():
            print(f"  {key}: {kernel} profiled {got.get(kernel, 0.0):.4f} ms per batch, "
                  f"device_ms sum {ms:.4f}", flush=True)
            details_out[key].setdefault("device_ms_sum", {})[kernel] = ms


def function_properties(log: str, needle: str) -> list[str]:
    """ptxas's stack and spill line of each kernel whose name contains ``needle``."""
    lines = log.splitlines()
    return [lines[i + 1].strip() for i, line in enumerate(lines[:-1])
            if "Function properties for" in line and needle in line]


# Dist phase: the port across ranks over torch.distributed, on the one card. W = 1
# over NCCL; W = 2 as two processes sharing cuda:0 over gloo with CUDA tensors (NCCL
# refuses two ranks on one card). Each step is a pair of ``--dist-worker``
# processes of this script (one for W = 1), each with a timeout; a rank that
# fails fails the phase.
DIST_ROOT = os.path.join(REPO, "chip_smoke_out", "dist")
DIST_TIMEOUT_S = 300           # each worker process
DIST_FIT_N = 1024              # (a): full-width ResNet-18, batch 128, 2 epochs of 8 steps
DIST_PARITY_N = 384            # (a) fp32: 3 steps of batch 128 ...
DIST_SHARD_N = 384             # (b): 3 steps per update layout
DIST_GRAD_ELEMS = 11_173_962   # ResNet-18's parameters (10 classes): the gradient
DRILL_GRACE_S = 3.0            # resilience.consensus_grace_s of the drills
DRILL_TIMEOUT_S = 10.0         # resilience.step_timeout_s of the hang drill
DRILL_EXIT_BOUND_S = 10.0      # rank 0 exits within grace + this of the first poison


def dist_ms(torch, fn, iters: int = 5) -> float:
    """Host wall of ``fn()`` ending in a synchronize, median of ``iters``."""
    times = []
    for _ in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def state_digest(torch, state) -> str:
    """sha256 over every params, batch_stats and momentum tensor's fp32 bytes."""
    import hashlib
    h = hashlib.sha256()
    for g in ("params", "batch_stats", "momentum"):
        for k in sorted(getattr(state, g)):
            t = getattr(state, g)[k].detach().float().cpu()
            h.update(k.encode() + t.numpy().tobytes())
    return h.hexdigest()


def dist_worker(argv: list[str]) -> int:
    """``--dist-worker STEP RANK WORLD PORT OUT``: one rank of a dist step."""
    import torch
    step, rank, world, port_no, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    check(torch.cuda.is_available(), "CUDA is not available")
    port = load_port()
    from data_diet_distributed_tpu_torch.config import MeshConfig
    from data_diet_distributed_tpu_torch.parallel import collectives, mesh
    from data_diet_distributed_tpu_torch.train.state import gather_slots, optimizer_bytes
    K = port["kernels"]
    result: dict = {"rank": rank}
    mc = MeshConfig(multihost=True, coordinator_address=f"127.0.0.1:{port_no}",
                    num_processes=world, process_id=rank)
    if step == "w1":
        # The north-star run without a group, then the same run joined to a W = 1
        # NCCL group through the mesh keys.
        cli = port["data"]["cli"]
        base = ["run", "--config", os.path.join(REPO, "configs",
                                                "cifar10_resnet18_grand10.yaml"),
                "data.dataset=synthetic", f"data.synthetic_size={TRAIN_N}",
                "score.seeds=[0,1]", "train.num_epochs=2"]
        for name, over in (("plain", []),
                           ("nccl", ["mesh.multihost=true", f"mesh.coordinator_address="
                                     f"127.0.0.1:{port_no}", "mesh.num_processes=1",
                                     "mesh.process_id=0"])):
            ckpt = os.path.join(out, f"w1_{name}")
            t0 = time.perf_counter()
            K.reset_launch_counts()
            rc = cli.main([*base, f"train.checkpoint_dir={ckpt}", *over])
            check(rc == 0, f"w1 {name}: cli run exit {rc}")
            result[name] = {"wall_s": time.perf_counter() - t0,
                            "launches": K.launch_counts(), "ckpt": ckpt}
        # A group of its own for the timing (the run's port may linger in TIME_WAIT).
        mesh.initialize_multihost(dataclasses.replace(mc, coordinator_address=
                                                      f"127.0.0.1:{free_port()}"), "cuda")
        grads = torch.ones(DIST_GRAD_ELEMS, device="cuda")
        result["backend"] = torch.distributed.get_backend()
        result["all_reduce_ms"] = dist_ms(torch, lambda: collectives.all_reduce_sum_(grads))
    elif step == "nccl_shared":
        # Two NCCL ranks on one card: NCCL refuses them at the first collective,
        # and nothing in the port catches that.
        mesh.initialize_multihost(mc, "cuda:0")
        x = torch.ones(4, device="cuda:0")
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
    elif step == "w2":
        mesh.initialize_multihost(mc, "cuda:0", backend="gloo")
        device = "cuda:0"
        T = port["train"]
        grads = [torch.ones(DIST_GRAD_ELEMS, device=device)]
        result["all_reduce_ms"] = dist_ms(torch, lambda: collectives.all_reduce_flat(grads))
        # (a) bf16: 16 steps of batch 128 (64 a rank), augmented.
        cfg = train_cfg(port, f"data.synthetic_size={DIST_FIT_N}", "train.num_epochs=2",
                        "data.augment=true")
        ds, _ = T["load_data_for"](cfg)
        res = T["fit"](cfg, ds, None, device=device)
        result["fit"] = {"digest": state_digest(torch, res.state),
                         "history": res.history}
        # (a) fp32, TF32 off: three epochs of one step.
        port["set_parity_mode"](True)
        cfg32 = train_cfg(port, f"data.synthetic_size={TRAIN_B}", "train.num_epochs=3",
                          "train.half_precision=false")
        ds32, _ = T["load_data_for"](cfg32)
        res = T["fit"](cfg32, ds32, None, device=device)
        port["set_parity_mode"](False)
        result["fp32_losses"] = [h["train_loss"] for h in res.history]
        if rank == 0:
            np.savez(os.path.join(out, "w2_fp32.npz"),
                     **{k: v.float().cpu().numpy() for k, v in res.state.variables.items()})
        # (b) the three update layouts, 3 steps each; (e) the ZeRO-1 one checkpoints.
        result["layouts"] = {}
        for name, over in (("replicated", ()), ("zero1", ("mesh.shard_opt_state=true",)),
                           ("sharded", ("mesh.shard_weight_update=true",))):
            lcfg = train_cfg(port, f"data.synthetic_size={DIST_SHARD_N}",
                             "train.num_epochs=1", *over)
            lds, _ = T["load_data_for"](lcfg)
            ckpt = os.path.join(out, "w2_zero1_ckpt") if name == "zero1" else None
            res = T["fit"](lcfg, lds, None, device=device, checkpoint_dir=ckpt)
            opt = T["make_optimizer"](lcfg, 3)
            result["layouts"][name] = {
                "digest": state_digest(torch, gather_slots(res.state, opt)),
                "optimizer_bytes": optimizer_bytes(res.state)}
        # (c) GraNd and EL2N over 8,192 examples x 2 seeds at batch 512 (256 a rank).
        model = port["create_model_from_cfg"](cfg)
        sds, _ = port["load_dataset"]("synthetic", synthetic_size=N_PATH, seed=0)
        variables = [port["init_variables"]("resnet18", s, device) for s in SEEDS]
        port["score_dataset"](model, variables[:1], sds.subset(sds.indices[:B]),
                              method="grand", batch_size=B, device=device)   # warm-up
        result["scores"] = {}
        for method in ("grand", "el2n"):
            K.reset_launch_counts()
            modes0 = K.mode_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = port["score_dataset"](model, variables, sds, method=method,
                                           batch_size=B, device=device)
            wall = time.perf_counter() - t0
            modes = K.mode_counts()
            result["scores"][method] = {
                "wall_s": wall, "launches": K.launch_counts(),
                "direct_modes": {m: modes["conv_grad_norm_direct"][m]
                                 - modes0["conv_grad_norm_direct"][m]
                                 for m in modes["conv_grad_norm_direct"]}}
            np.save(os.path.join(out, f"w2_{method}_{rank}.npy"), scores)
    else:
        fail(f"unknown dist step {step!r}")
    with open(os.path.join(out, f"{step}_{rank}.json"), "w") as fh:
        json.dump(result, fh, default=str)
    sys.stdout.flush()
    # No teardown: the W = 2 group is left to the exit.
    os._exit(0)


def drill_worker(argv: list[str]) -> int:
    """``--drill-worker RANK PORT [cli arguments]``: ``cli.main`` as one of two
    ranks sharing cuda:0 over gloo (joined here: the command line has no
    backend key, and NCCL refuses two ranks on one card)."""
    rank, port_no, cli_argv = int(argv[0]), argv[1], argv[2:]
    port = load_port()
    from data_diet_distributed_tpu_torch.config import MeshConfig
    from data_diet_distributed_tpu_torch.parallel import mesh
    mesh.initialize_multihost(MeshConfig(multihost=True,
                                         coordinator_address=f"127.0.0.1:{port_no}",
                                         num_processes=2, process_id=rank),
                              "cuda:0", backend="gloo")
    rc = port["data"]["cli"].main([*cli_argv, "--device", "cuda:0"])
    sys.stdout.flush()
    os._exit(rc)


def spawn(args: list[str], tag: str, plan: str | None = None, root: str = DIST_ROOT) -> dict:
    """Start this script as a worker (with ``plan`` as its ``DDT_FAULT_PLAN``);
    its output goes to ``<root>/<tag>.log``."""
    log = open(os.path.join(root, f"{tag}.log"), "w")
    env = {k: v for k, v in os.environ.items() if k != "DDT_FAULT_PLAN"}
    env["PYTHONPATH"] = REPO
    if plan is not None:
        env["DDT_FAULT_PLAN"] = plan
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args], cwd=REPO,
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    log.close()
    return {"proc": proc, "tag": tag, "t0": time.time(), "root": root}


def finish(workers: list[dict], timeout: float = DIST_TIMEOUT_S) -> None:
    """Wait for every worker (each within ``timeout``); record exit codes and
    times. A worker past its timeout is killed, with every other one."""
    try:
        for w in workers:
            w["rc"] = w["proc"].wait(timeout=max(1.0, w["t0"] + timeout - time.time()))
            w["t_exit"] = time.time()
    finally:
        for w in workers:
            if w["proc"].poll() is None:
                w["proc"].kill()
                w["proc"].wait(timeout=30)
    for w in workers:
        with open(os.path.join(w["root"], f"{w['tag']}.log")) as fh:
            w["log"] = fh.read()


def worker_tail(w: dict) -> str:
    return f"{w['tag']} exit {w.get('rc')}:\n{w.get('log', '')[-2500:]}"


def free_port() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def pair(step: str, world: int = 2) -> list[dict]:
    return collect(step, start_pair(step, world))


def collect(step: str, ws: list[dict]) -> list[dict]:
    """Wait for a started step's ranks; each must exit 0; their results."""
    finish(ws)
    for w in ws:
        check(w["rc"] == 0, f"dist {step}: a rank failed: {worker_tail(w)}")
    out = []
    for r in range(len(ws)):
        with open(os.path.join(DIST_ROOT, f"{step}_{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def start_pair(step: str, world: int = 2) -> list[dict]:
    port_no = free_port()
    return [spawn(["--dist-worker", step, str(r), str(world), port_no, DIST_ROOT],
                  f"{step}_r{r}") for r in range(world)]


def records(log: str) -> list[dict]:
    """The JSON records of a CLI rank's output (stderr and stdout joined)."""
    out = []
    for line in log.splitlines():
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


DRILL_ARGV = ["train", "--config", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
              "data.synthetic_size=256", "data.batch_size=64", "data.eval_batch_size=64",
              "model.arch=tiny_cnn", "train.num_epochs=3", "train.checkpoint_every=1",
              "train.log_every_steps=1000", f"resilience.consensus_grace_s={DRILL_GRACE_S}"]


def drills(name_plans: list[tuple[str, str | None, list[str]]]) -> dict:
    """Run each ``(name, DDT_FAULT_PLAN or None, extra arguments)`` drill as two
    CLI ranks, all drills at once; returns the workers by drill."""
    running = {}
    for name, plan, extra in name_plans:
        port_no = free_port()
        running[name] = [spawn(["--drill-worker", str(r), port_no, *DRILL_ARGV,
                                f"train.checkpoint_dir={os.path.join(DIST_ROOT, name)}",
                                *extra], f"drill_{name}_{len(running)}_r{r}", plan)
                         for r in range(2)]
    finish([w for ws in running.values() for w in ws])
    return running


def dist_phase(torch, port, details_out, card: str, path: dict, trained: dict) -> None:
    shutil.rmtree(DIST_ROOT, ignore_errors=True)
    os.makedirs(DIST_ROOT)
    rec: dict = {}
    t_phase = time.perf_counter()

    # NCCL refuses two ranks on one card: the reason W = 2 runs over gloo here.
    # That pair, and the W = 2 gloo pair of (a)-(c), are started beside the W = 1
    # run (their own groups, ports and files); the W = 2 ranks are read after it.
    refused = start_pair("nccl_shared")
    w2_ranks = start_pair("w2")
    try:
        _dist_groups(torch, port, rec, card, path, trained, refused, w2_ranks)
    finally:
        for w in w2_ranks:
            if w["proc"].poll() is None:
                w["proc"].kill()
                w["proc"].wait(timeout=30)
    _dist_drills(rec)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"  dist phase {rec['wall_s']:.1f} s", flush=True)
    details_out["dist"] = rec
    shutil.rmtree(DIST_ROOT, ignore_errors=True)


def _dist_groups(torch, port, rec: dict, card: str, path: dict, trained: dict,
                 refused: list[dict], w2_ranks: list[dict]) -> None:
    """W = 1 over NCCL (and the refused NCCL pair beside it), then W = 2 over
    gloo: (a)-(c), (e)."""
    T = port["train"]
    # W = 1 over NCCL: the north-star run joined to a group, bitwise the run without.
    try:
        w1 = pair("w1", world=1)[0]
    finally:
        finish(refused, timeout=120)
    plain, nccl = w1["plain"], w1["nccl"]
    for what in ("scores", "kept"):
        with np.load(T["scores_npz_path"](plain["ckpt"])) as a, \
                np.load(T["scores_npz_path"](nccl["ckpt"])) as b:
            check(np.array_equal(a[what], b[what]), f"W=1 NCCL: {what} differ")
    check(arrays_equal(ckpt_arrays(plain["ckpt"])[1], ckpt_arrays(nccl["ckpt"])[1]),
          "W=1 NCCL: final parameters differ from the run without a group")
    check(nccl["launches"] == plain["launches"], f"W=1 NCCL launches {nccl['launches']}")
    check(w1["backend"] == "nccl", f"W=1 backend {w1['backend']}")
    with np.load(T["scores_npz_path"](plain["ckpt"])) as a:
        same_as_phase8 = (np.array_equal(a["scores"], trained["run"]["scores"])
                          and arrays_equal(ckpt_arrays(plain["ckpt"])[1],
                                           trained["run"]["arrays"]))
    grad_mb = DIST_GRAD_ELEMS * 4 / 1e6
    rec["w1"] = {"wall_s": {"plain": plain["wall_s"], "nccl": nccl["wall_s"]},
                 "all_reduce_ms": w1["all_reduce_ms"], "grad_mb": grad_mb,
                 "same_as_train_phase": same_as_phase8}
    print(f"  W=1 NCCL: north-star run ({TRAIN_N} examples, seeds [0, 1]) in a group "
          f"{nccl['wall_s']:.1f} s, without {plain['wall_s']:.1f} s: scores, kept and "
          f"final parameters bitwise equal (and {'equal' if same_as_phase8 else 'NOT equal'}"
          f" to the train phase's run in this process); launches {nccl['launches']}; "
          f"all-reduce of the {grad_mb:.1f} MB fp32 gradient {w1['all_reduce_ms']:.3f} ms "
          f"on {card}", flush=True)

    for w in refused:
        check(w["rc"] not in (0, None) and "Duplicate GPU detected" in w["log"],
              f"two NCCL ranks on one card were not refused: {worker_tail(w)}")
    quote = next(line.strip() for line in refused[0]["log"].splitlines()
                 if "Duplicate GPU detected" in line)
    rec["nccl_shared_card"] = quote
    print(f"  two NCCL ranks on cuda:0: both exit non-zero at the first all-reduce: "
          f"{quote}", flush=True)

    # W = 2 on the one card over gloo: (a) fits, (b) update layouts, (c) scoring, (e).
    w2 = collect("w2", w2_ranks)
    r0, r1 = w2
    check(r0["fit"]["digest"] == r1["fit"]["digest"],
          "W=2 bf16 fit: the ranks' final states differ")
    steady = [h["examples_per_s"] for h in r0["fit"]["history"]][1:]
    # The W = 1 reference of the fp32 fit, here, TF32 off.
    port["set_parity_mode"](True)
    cfg32 = train_cfg(port, f"data.synthetic_size={TRAIN_B}", "train.num_epochs=3",
                      "train.half_precision=false")
    ds32, _ = T["load_data_for"](cfg32)
    ref = T["fit"](cfg32, ds32, None, device="cuda")
    port["set_parity_mode"](False)
    want_losses = [h["train_loss"] for h in ref.history]
    loss_rel = float(np.max(np.abs(np.asarray(r0["fp32_losses"]) - want_losses)
                            / np.abs(want_losses)))
    check(r0["fp32_losses"] == r1["fp32_losses"] and loss_rel <= 1e-5,
          f"W=2 fp32 losses {r0['fp32_losses']} vs W=1 {want_losses} (rel {loss_rel:.3e})")
    worst = 0.0   # the largest |W=2 - W=1| of any variable
    with np.load(os.path.join(DIST_ROOT, "w2_fp32.npz")) as f:
        for k, v in ref.state.variables.items():
            w = v.float().cpu().numpy()
            worst = max(worst, float(np.abs(f[k] - w).max()))
            check(bool(np.all(np.abs(f[k] - w) <= 1e-4 * np.abs(w) + 1e-6)),
                  f"W=2 fp32 {k}: beyond rtol 1e-4, atol 1e-6 of W=1")
    print(f"  W=2 gloo on cuda:0 (a): bf16 fit of {DIST_FIT_N} examples at batch {TRAIN_B} "
          f"({TRAIN_B // 2} a rank, augmented), 2 epochs: ranks bitwise equal; rank 0 "
          f"steady epoch {steady[0]:.1f} ex/s of the global batch; all-reduce of the "
          f"{grad_mb:.1f} MB gradient through the host {r0['all_reduce_ms']:.3f} ms; fp32 "
          f"3 steps vs W=1: losses rel {loss_rel:.3e} (<= 1e-5), variables within rtol "
          f"1e-4, atol 1e-6 (largest difference {worst:.3e})", flush=True)
    lay = [r["layouts"] for r in w2]
    for r in lay:
        check(r["zero1"]["digest"] == r["replicated"]["digest"] == r["sharded"]["digest"],
              f"W=2 (b): update layouts differ: {r}")
    check(lay[0]["zero1"]["digest"] == lay[1]["zero1"]["digest"], "W=2 (b): ranks differ")
    opt = {k: v["optimizer_bytes"] for k, v in lay[0].items()}
    print(f"  W=2 (b): ZeRO-1 and the sharded update bitwise the replicated update after "
          f"3 steps; rank 0 optimizer bytes {opt}", flush=True)
    restored = port["CheckpointManager"](os.path.join(DIST_ROOT, "w2_zero1_ckpt")).restore(
        device="cuda")
    check(state_digest(torch, restored) == lay[0]["zero1"]["digest"],
          "W=2 (e): the ZeRO-1 checkpoint does not restore bitwise at W=1")
    print("  W=2 (e): the ZeRO-1 checkpoint written at W=2 restores bitwise at W=1",
          flush=True)
    nb = -(-N_PATH // B)
    sds, _ = port["load_dataset"]("synthetic", synthetic_size=N_PATH, seed=0)
    model = port["create_model_from_cfg"](path["cfg"])
    rec["scores"] = {}
    for method, rtol, atol in (("grand", 1e-4, 1e-5), ("el2n", 1e-5, 1e-6)):
        got = [np.load(os.path.join(DIST_ROOT, f"w2_{method}_{r}.npy")) for r in range(2)]
        check(np.array_equal(got[0], got[1]), f"W=2 {method}: the ranks' vectors differ")
        w1_256 = port["score_dataset"](model, path["variables"], sds, method=method,
                                       batch_size=B // 2, device="cuda")
        rel = float(np.max(np.abs(got[0] - w1_256) / np.maximum(np.abs(w1_256), 1e-30)))
        check(bool(np.all(np.abs(got[0] - w1_256) <= rtol * np.abs(w1_256) + atol)),
              f"W=2 {method} vs W=1 at batch {B // 2}: rel {rel:.3e}")
        w1_512 = path["results"][method]["scores"]
        rel512 = float(np.max(np.abs(got[0] - w1_512) / np.maximum(np.abs(w1_512), 1e-30)))
        s = [r["scores"][method] for r in w2]
        want = dict.fromkeys(port["kernels"].KERNELS, 0)
        if method == "grand":
            want.update(conv_grad_norm_direct=12 * nb * 2, conv_grad_norm_gram=3 * nb * 2)
        else:
            want["el2n"] = nb * 2
        for r, x in enumerate(s):
            check(x["launches"] == want, f"W=2 {method} rank {r}: launches {x['launches']}")
            if method == "grand":
                check(x["direct_modes"] == {m: (12 * nb * 2 if m == "tensor_core" else 0)
                                            for m in x["direct_modes"]},
                      f"W=2 grand rank {r}: direct modes {x['direct_modes']}")
        # The pass's rate (every example, both ranks) and each rank's own rows.
        ex_s = [N_PATH * 2 / x["wall_s"] for x in s]
        rec["scores"][method] = {"ex_per_s": ex_s, "rank_ex_per_s": [e / 2 for e in ex_s],
                                 "rel_w1_256": rel, "rel_w1_512": rel512,
                                 "launches_per_rank": s[0]["launches"]}
        print(f"  W=2 (c) {method}: {N_PATH} x 2 seeds at batch {B} ({B // 2} a rank): ranks "
              f"bitwise equal; vs W=1 at batch {B // 2} max rel {rel:.3e} (rtol {rtol}, "
              f"atol {atol}), vs W=1 at batch {B} {rel512:.3e}; per rank per batch per "
              f"seed {[f'{k} {v // (nb * 2)}' for k, v in s[0]['launches'].items() if v]}"
              f" (tensor-core); the pass {ex_s[0]:.1f}, {ex_s[1]:.1f} ex/s as each rank "
              f"timed it, {ex_s[0] / 2:.1f}, {ex_s[1] / 2:.1f} ex/s of each rank's own rows "
              "(the two ranks share the card)", flush=True)
    rec["w2"] = {"all_reduce_ms": r0["all_reduce_ms"], "steady_ex_per_s": steady,
                 "fp32_loss_rel": loss_rel, "fp32_var_max_abs": worst,
                 "optimizer_bytes": opt}


def _dist_drills(rec: dict) -> None:
    """(d) Consensus drills: two CLI ranks each, tiny_cnn, 256 examples, 4 steps
    an epoch."""
    wave1 = drills([
        ("whole", None, []),
        ("sigterm", '{"rank": 1, "sigterm_at_epoch_end": 0}', []),
        ("nan", '{"rank": 1, "nan_loss_at_epoch": 1}', []),
        ("hang", '{"rank": 1, "hang_at": 5, "hang_seconds": 600}',
         [f"resilience.step_timeout_s={DRILL_TIMEOUT_S}"])])
    for w in wave1["whole"]:
        check(w["rc"] == 0, f"drill whole: {worker_tail(w)}")
    for w in wave1["sigterm"]:
        check(w["rc"] == 75 and "[preempted] preempted by" in w["log"]
              and "at step 4; checkpoint durable at step 4" in w["log"],
              f"drill sigterm: {worker_tail(w)}")
    pre = [r for r in records(wave1["sigterm"][0]["log"]) if r.get("kind") == "preempted"]
    check(len(pre) == 1 and pre[0]["step"] == pre[0]["durable_step"] == 4,
          f"drill sigterm: preempted records {pre}")
    for w in wave1["nan"]:
        check(w["rc"] == 69 and "DivergenceError" in w["log"] and "at epoch 1 " in w["log"],
              f"drill nan: {worker_tail(w)}")
    check(any(r.get("kind") == "recovery_refused" for r in records(wave1["nan"][0]["log"])),
          "drill nan: no recovery_refused record")
    hang0, hang1 = wave1["hang"]
    check(hang0["rc"] == 69 and hang1["rc"] == 69,
          f"drill hang: {worker_tail(hang0)}\n{worker_tail(hang1)}")
    # Both watchdogs' deadlines run out about together (rank 0 waits in a
    # collective from the step rank 1 hangs in): the first poison may be either's.
    channel = os.path.join(DIST_ROOT, "hang_sidechannel")
    poisons = []
    for name in sorted(os.listdir(channel)):
        with open(os.path.join(channel, name)) as fh:
            poisons.append(json.load(fh))
    check(bool(poisons), "drill hang: no rank poisoned the side channel")
    first = min(poisons, key=lambda p: p["ts"])
    after = hang0["t_exit"] - first["ts"]
    check(after <= DRILL_GRACE_S + DRILL_EXIT_BOUND_S,
          f"drill hang: rank 0 exited {after:.1f} s after the first poison {first}")
    shutil.copytree(os.path.join(DIST_ROOT, "whole"), os.path.join(DIST_ROOT, "hidden"))
    wave2 = drills([("sigterm", None, ["train.resume=true"]),
                    ("hidden", '{"rank": 1, "hide_latest_durable": true}',
                     ["train.resume=true"])])
    whole_arrays = ckpt_arrays(os.path.join(DIST_ROOT, "whole"))
    for name in ("sigterm", "hidden"):
        for w in wave2[name]:
            check(w["rc"] == 0, f"drill {name} resume: {worker_tail(w)}")
        check(ckpt_arrays(os.path.join(DIST_ROOT, name))[0] == whole_arrays[0] == 12
              and arrays_equal(ckpt_arrays(os.path.join(DIST_ROOT, name))[1],
                               whole_arrays[1]),
              f"drill {name}: the resumed run's final step differs from the whole run's")
    agreed = [r for r in records(wave2["hidden"][0]["log"])
              if r.get("kind") == "consensus" and r.get("event") == "restore_agreed"]
    check(len(agreed) == 1 and agreed[0]["step"] == 8, f"drill hidden: {agreed}")
    rec["drills"] = {"hang_rank0_after_poison_s": after,
                     "walls_s": {n: [w["t_exit"] - w["t0"] for w in ws]
                                 for wave in (wave1, wave2) for n, ws in wave.items()}}
    print(f"  (d) drills on tiny_cnn (two CLI ranks each): SIGTERM to rank 1 -> both exit "
          f"75 at step 4, durable at 4, the resume bitwise the whole W=2 run; NaN on "
          f"rank 1 -> both exit 69 at epoch 1 (recovery_refused); rank 1's newest step "
          f"hidden -> both restore step 8 and end bitwise the whole run; a rank-1 hang -> "
          f"both exit 69, rank 0 {after:.1f} s after the first poison (rank "
          f"{first['rank']}'s; bound {DRILL_GRACE_S + DRILL_EXIT_BOUND_S:.0f} s)", flush=True)



# ------------------------------------------------------------------ obs phase

OBS_ROOT = os.path.join(REPO, "chip_smoke_out", "obs")
#: Examples of the obs phase's north-star runs (a cut of the train phase's).
OBS_N = 2048
OBS_SEEDS = (0, 1)            # the north-star run's seeds (of 10)
OBS_EPOCHS = 2                # its retrain epochs (of 198)
OBS_TIMEOUT_S = 400
#: Examples of the drills' ``cli train`` runs and the drill watchdog's timeout.
OBS_DRILL_N = 512
OBS_HANG_TIMEOUT_S = 10
#: The CUDA functions of the path's kernels, as a profile capture names them.
OBS_KERNEL_FUNCTIONS = {"conv_grad_norm_direct": "direct_mma_kernel",
                        "conv_grad_norm_gram": "gram_kernel", "el2n": "el2n_kernel"}
#: Every instrument off (the metrics stream too).
OBS_OFF = ["obs.metrics_path=null", "obs.trace=false", "obs.heartbeat=false",
           "obs.flightrec=false", "obs.xla_introspect=false", "obs.score_telemetry=false",
           "obs.fleet=false"]


#: The PNGs ``obs.plots_dir`` holds after the obs phase's ``cli run``: what
#: the same ``cli run --device cpu`` writes in ``tests/test_torch_plots.py``
#: (which holds its files to this list), and on a card the monitor's duty
#: and memory charts.
OBS_PLOTS_CPU = ("cpu_utilization.png", "eval_accuracy.png", "score_distribution.png",
                 "score_stats_grand.png", "throughput.png", "train_loss.png")
OBS_PLOTS_CARD = ("device_duty_cycle.png", "device_memory.png")


def summary_line(stdout: str) -> dict:
    """A command's summary: its last JSON line (``[plots]`` lines follow it)."""
    return json.loads([x for x in stdout.splitlines() if x.startswith("{")][-1])


def check_plots(stdout: str, plots_dir: str) -> dict:
    """The ``[plots] wrote`` lines of a ``cli run`` with ``obs.plots_dir``:
    every file of ``OBS_PLOTS_CPU`` and ``OBS_PLOTS_CARD`` where matplotlib
    imports, none where it does not."""
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    lines = [x for x in stdout.splitlines() if x.startswith("[plots]")]
    check(all(x.startswith("[plots] wrote ") for x in lines), f"plots: {lines}")
    names = sorted(os.path.basename(x[len("[plots] wrote "):]) for x in lines)
    on_disk = sorted(os.listdir(plots_dir)) if os.path.isdir(plots_dir) else []
    want = sorted(OBS_PLOTS_CPU + OBS_PLOTS_CARD) if has_mpl else []
    check(names == on_disk == want, f"plots: wrote {names}, on disk {on_disk}, want {want}")
    print(f"  plots: matplotlib {'imports' if has_mpl else 'does not import'}; "
          f"obs.plots_dir holds {len(names)} files {names}", flush=True)
    return {"matplotlib": has_mpl, "files": names}


def obs_on(d: str) -> list[str]:
    """Every instrument on, its files under ``d``."""
    return [f"obs.metrics_path={d}/m.jsonl", f"obs.profile_dir={d}/prof",
            "obs.monitor=true", f"obs.monitor_path={d}/util.jsonl",
            f"obs.perf_ledger={d}/ledger.jsonl", f"obs.prom_path={d}/m.prom",
            "obs.server_port=0", "obs.slo_throughput_floor=1",
            "obs.slo_nonfinite_frac=0.0", "obs.slo_eval_accuracy_floor=0.0"]


class CliProcess:
    """``python -m data_diet_distributed_tpu_torch.cli`` as a subprocess of
    the repo root; its stderr records are read on a thread as they come."""

    def __init__(self, args: list[str], plan: dict | None = None):
        env = {**os.environ, "PYTHONPATH": REPO}
        if plan is not None:
            env["DDT_FAULT_PLAN"] = json.dumps(plan)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.records: list[dict] = []
        self.tail: list[str] = []
        self.stdout: list[str] = []

        def drain():
            for line in self.proc.stderr:
                self.tail = (self.tail + [line])[-40:]
                if line.startswith("{"):
                    try:
                        self.records.append(json.loads(line))
                    except ValueError:
                        pass
        # One reader per pipe (``communicate`` would read stderr too and split
        # its lines between two readers).
        self._readers = [threading.Thread(target=drain, daemon=True),
                         threading.Thread(target=lambda: self.stdout.extend(self.proc.stdout),
                                          daemon=True)]
        for t in self._readers:
            t.start()

    def first(self, kind: str, timeout: float) -> dict:
        """The first record of ``kind`` (waits for it)."""
        deadline = time.perf_counter() + timeout
        while True:
            for r in list(self.records):
                if r.get("kind") == kind:
                    return r
            check(time.perf_counter() < deadline and self.proc.poll() is None,
                  f"cli never logged a {kind} record (exit {self.proc.poll()}): "
                  f"{''.join(self.tail)[-2000:]}")
            time.sleep(0.1)

    def wait(self, timeout: float = OBS_TIMEOUT_S) -> tuple[int, str, float]:
        """(exit status, stdout, wall s); kills it past ``timeout``."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            fail(f"cli did not end within {timeout} s: {''.join(self.tail)[-2000:]}")
        wall = time.perf_counter() - self.t0
        for t in self._readers:
            t.join(timeout=30)
        return self.proc.returncode, "".join(self.stdout), wall


def span_nesting(path: str) -> set:
    """(parent, child) span-name pairs of a trace: a span's parent is the
    innermost span of its thread that contains it."""
    with open(path) as fh:
        events = [e for e in json.load(fh) if e]
    spans = sorted((e for e in events if e.get("ph") == "X"),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    pairs, stack = set(), []
    for e in spans:
        while stack and not (stack[-1]["tid"] == e["tid"]
                             and e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"]):
            stack.pop()
        pairs.add((stack[-1]["name"] if stack else None, e["name"]))
        stack.append(e)
    return pairs


def capture_kernels(path: str) -> dict[str, int]:
    """Device-kernel events of a profile capture (``export_chrome_trace``), by
    the path's kernel they belong to."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(fn in n for n in names) for k, fn in OBS_KERNEL_FUNCTIONS.items()}


def obs_phase(torch, port, details_out, card: str) -> None:
    """The observability slice on the card; see the module docstring. Files in
    ``OBS_ROOT`` (removed after a pass)."""
    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    os.makedirs(OBS_ROOT)
    rec: dict = {}
    details_out["obs"] = rec
    north = os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml")

    def run_args(d: str) -> list[str]:
        # Per step, as the JAX package's observability tests run: the
        # train_step and score_batch programs are harvested from kernel-route
        # calls (the chunked engine's harvest is its warm-up, on the plain
        # route; the chunked phase drives that engine).
        return ["run", "--config", north, "data.dataset=synthetic",
                f"data.synthetic_size={OBS_N}",
                f"score.seeds=[{','.join(str(x) for x in OBS_SEEDS)}]",
                f"train.num_epochs={OBS_EPOCHS}", "train.chunk_steps=1",
                "score.chunk_steps=1", f"train.checkpoint_dir={d}/ckpt"]

    # 1: every instrument on; /status polled once an epoch is done.
    on = os.path.join(OBS_ROOT, "on")
    cp = CliProcess(run_args(on) + obs_on(on) + [f"obs.plots_dir={on}/plots"])
    sport = cp.first("obs_server", OBS_TIMEOUT_S)["port"]
    cp.first("epoch", OBS_TIMEOUT_S)
    code, _, raw = http_call(sport, "/status", timeout=30)
    status = json.loads(raw)
    check(code == 200 and {"epoch", "mfu", "hbm_peak_bytes", "eta_s", "lineage"} <= set(status),
          f"/status mid-run: {code} {status}")
    rc, out_on, wall_on = cp.wait()
    check(rc == 0, f"cli run with every instrument on exited {rc}: {''.join(cp.tail)[-2000:]}")
    # 2: every instrument off.
    off = os.path.join(OBS_ROOT, "off")
    cp_off = CliProcess(run_args(off) + OBS_OFF)
    rc, out_off, wall_off = cp_off.wait()
    check(rc == 0, f"cli run with every instrument off exited {rc}")
    rec["plots"] = check_plots(out_on, f"{on}/plots")
    walls = {side: {k: round(v, 3) for k, v in summary_line(out).items()
                    if k.endswith("_wall_s")}
             for side, out in (("on", out_on), ("off", out_off))}
    with np.load(f"{on}/ckpt_scores.npz") as a, np.load(f"{off}/ckpt_scores.npz") as b:
        check(np.array_equal(a["scores"], b["scores"]) and np.array_equal(a["kept"], b["kept"]),
              "scores or kept set differ with the instruments on")
    n_records = validate_stream(f"{on}/m.jsonl", expect_terminal=True)
    with open(f"{on}/m.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    summary = recs[-1]
    check([r["kind"] for r in recs[-2:]] == ["metrics", "run_summary"]
          and summary["exit_class"] == "ok", f"stream ends {recs[-2:]}")
    mfu = summary.get("mfu")
    want_source = (f"table:{torch.cuda.get_device_name(0)}"
                   if torch.cuda.get_device_name(0) in ("NVIDIA H100 80GB HBM3",)
                   else "calibrated")
    check(mfu is not None and 0 < mfu <= 1 and summary.get("peak_flops_source") == want_source,
          f"run_summary mfu {mfu} from {summary.get('peak_flops_source')}, want {want_source}")
    programs = {r["program"]: r for r in recs if r["kind"] == "xla_program"}
    check(all(programs.get(p, {}).get("flops", 0) > 0 for p in ("train_step", "score_batch")),
          f"xla_program records: {list(programs)}")
    check(programs["score_batch"]["kernel_flops"] > 0,
          "the score program counted no kernel work")
    marks = [r for r in recs if r["kind"] == "hbm_watermark"]
    check(marks and max(r["peak_bytes"] or 0 for r in marks) > 0, f"hbm_watermark: {marks}")
    stats = sorted(r["seed"] for r in recs if r["kind"] == "score_stats")
    check(stats == list(OBS_SEEDS) and any(r["kind"] == "score_stability" for r in recs)
          and "score_stability" in summary, f"score telemetry: seeds {stats}")
    pairs = span_nesting(f"{on}/trace.json")
    want_pairs = {("run", "score"), ("score", "seed"), ("seed", "fit"), ("fit", "epoch"),
                  ("run", "retrain:final"), ("retrain:final", "fit"), ("epoch", "eval"),
                  ("fit", "checkpoint_save")}
    check(want_pairs <= pairs, f"span nesting: missing {want_pairs - pairs}")
    captures = {}
    for tag in ("score_pretrain", "score", "final"):
        path = os.path.join(on, "prof", tag, "trace.json")
        check(os.path.exists(path), f"no profile capture for stage {tag}")
        captures[tag] = capture_kernels(path)
    check(captures["score"]["conv_grad_norm_direct"] > 0
          and captures["score"]["conv_grad_norm_gram"] > 0,
          f"the score capture lacks the GraNd kernels: {captures['score']}")
    with open(f"{on}/ledger.jsonl") as fh:
        ledger = [json.loads(line) for line in fh]
    check(len(ledger) == 1 and ledger[0]["backend"] == "cuda"
          and ledger[0]["device_kind"] == torch.cuda.get_device_name(0), f"ledger {ledger}")
    with open(f"{on}/util.jsonl") as fh:
        util = [json.loads(line) for line in fh]
    duty = [u["duty_cycle"] for u in util if u.get("duty_cycle") is not None]
    check(util and duty, f"utilization samples {len(util)}, duty {duty}")
    hbm_peak = max((r["peak_bytes"] or 0 for r in marks), default=0)
    xla = summary["xla"]
    rec.update(wall_on_s=wall_on, wall_off_s=wall_off, stage_walls=walls,
               compile_s={p: xla[p].get("compile_s") for p in xla},
               n_records=n_records, mfu=mfu,
               mfu_train_step=summary_gauge(recs, "mfu:train_step"),
               mfu_score_batch=summary_gauge(recs, "mfu:score_batch"),
               peak_flops_source=summary["peak_flops_source"],
               flops_per_example={p: xla[p]["flops_per_example"] for p in xla},
               kernel_flops_score_batch=xla["score_batch"]["kernel_flops"],
               program_peak_bytes={p: xla[p].get("peak_bytes") for p in xla},
               hbm_peak_bytes=hbm_peak,
               duty_cycle_mean=sum(duty) / len(duty) if duty else None,
               duty_samples=len(duty), stage_s=summary["stage_s"], captures=captures,
               status_keys=sorted(status))
    print(f"  cli run x{OBS_N} (seeds {list(OBS_SEEDS)}, {OBS_EPOCHS} retrain epochs): "
          f"wall with every "
          f"instrument {wall_on:.1f} s, without {wall_off:.1f} s (subprocess, start-up "
          f"included); scores bitwise; stage walls on {walls['on']}, off {walls['off']}; "
          f"first calls (compile_s) {rec['compile_s']}", flush=True)
    print(f"  mfu {mfu:.4f} (train_step {rec['mfu_train_step']}, score_batch "
          f"{rec['mfu_score_batch']}; peak {rec['peak_flops_source']}); flops/example "
          f"{rec['flops_per_example']}; HBM peak {hbm_peak / 2**30:.2f} GiB, program peaks "
          f"{rec['program_peak_bytes']}; duty {rec['duty_cycle_mean']} over "
          f"{len(duty)} samples; {n_records} records; captures {captures}", flush=True)
    # 3: EL2N's kernel in a capture, and the drills, three processes at once.
    el2n = os.path.join(OBS_ROOT, "el2n")
    drill_args = ["train", "--config", os.path.join(REPO, "configs", "cifar10_resnet18.yaml"),
                  "data.dataset=synthetic", f"data.synthetic_size={OBS_DRILL_N}",
                  "train.num_epochs=2"]
    nan_d, hang_d = os.path.join(OBS_ROOT, "nan"), os.path.join(OBS_ROOT, "hang")
    procs = {
        "el2n": CliProcess(["score", "--config", north, "data.dataset=synthetic",
                            f"data.synthetic_size={OBS_N}", "score.method=el2n",
                            "score.pretrain_epochs=0", "score.seeds=[0]",
                            f"train.checkpoint_dir={el2n}/ckpt",
                            f"obs.metrics_path={el2n}/m.jsonl",
                            f"obs.profile_dir={el2n}/prof"]),
        "nan": CliProcess(drill_args + [f"train.checkpoint_dir={nan_d}/ckpt",
                                        f"obs.metrics_path={nan_d}/m.jsonl"],
                          plan={"nan_loss_at_epoch": 1}),
        # Without the harvest, whose first step (~8 s on the card, the flop
        # counter's first use) would itself outlast this short deadline.
        "hang": CliProcess(drill_args + [f"train.checkpoint_dir={hang_d}/ckpt",
                                         f"obs.metrics_path={hang_d}/m.jsonl",
                                         "obs.xla_introspect=false",
                                         f"resilience.step_timeout_s={OBS_HANG_TIMEOUT_S}",
                                         "train.auto_resume_retries=1"],
                           plan={"hang_at": 2, "hang_seconds": 600})}
    done = {k: p.wait() for k, p in procs.items()}
    for k, (rc, _, _) in done.items():
        check(rc == 0, f"{k}: exit {rc}: {''.join(procs[k].tail)[-2000:]}")
    el2n_capture = capture_kernels(os.path.join(el2n, "prof", "score", "trace.json"))
    check(el2n_capture["el2n"] > 0, f"the EL2N capture lacks its kernel: {el2n_capture}")
    with open(os.path.join(nan_d, "flightrec_rank0.json")) as fh:
        nan_dump = json.load(fh)
    check(nan_dump["reason"] == "divergence:epoch1", f"NaN drill dump: {nan_dump['reason']}")
    hangs = [r for r in procs["hang"].records if r.get("kind") == "fault"
             and r.get("fault") == "hang"]
    check(len(hangs) == 1 and "rank0 last progress" in hangs[0]["error"],
          f"hang drill: {hangs}; faults "
          f"{[r for r in procs['hang'].records if r.get('kind') == 'fault']}; "
          f"{''.join(procs['hang'].tail)[-1500:]}")
    rec.update(el2n_capture=el2n_capture, nan_dump_reason=nan_dump["reason"],
               hang_error=hangs[0]["error"])
    print(f"  EL2N capture {el2n_capture}; NaN drill dump {nan_dump['reason']!r}; hang "
          f"drill: {hangs[0]['error'][:160]}", flush=True)
    shutil.rmtree(OBS_ROOT, ignore_errors=True)


# -------------------------------------------------------------- elastic phase

ELASTIC_ROOT = os.path.join(REPO, "chip_smoke_out", "elastic")
#: Examples of the elastic phase's runs (the obs phase's cut).
ELASTIC_N = 2048
ELASTIC_TIMEOUT_S = 300
#: The recovery SLO's budget (classification to the first training step).
ELASTIC_SLO_S = 60
#: The promotion delay that lands (b)'s SIGTERM while a promotion is in flight.
ELASTIC_DELAY_S = 2.0
#: The supervisor's events of a W = 1 host loss, in order.
ELASTIC_CHAIN = ["supervise", "launch", "children_exited", "shrink", "launch",
                 "children_exited", "complete"]


def final_state(port, directory: str):
    """The newest checkpoint of ``directory`` on the CPU, restored through the
    port's manager (digests checked)."""
    mngr = port["CheckpointManager"](directory)
    return mngr.latest_step(), mngr.restore(device="cpu")


def same_run(torch, port, a: str, b: str) -> bool:
    """Whether two ``cli run`` directories hold the same scores, kept set and
    final retrain state, bit for bit."""
    with np.load(f"{a}/ckpt_scores.npz") as x, np.load(f"{b}/ckpt_scores.npz") as y:
        if not (np.array_equal(x["scores"], y["scores"])
                and np.array_equal(x["kept"], y["kept"])):
            return False
    (sa, ta), (sb, tb) = final_state(port, f"{a}/ckpt"), final_state(port, f"{b}/ckpt")
    return sa == sb and state_equal(torch, ta, tb)


def attempt_launches(recs: list[dict], attempt: int) -> dict[str, int]:
    """The kernels' launches of one attempt's worker (its ``metrics`` record)."""
    snaps = [r for r in recs if r["kind"] == "metrics" and r.get("attempt") == attempt]
    gauges = snaps[-1]["gauges"] if snaps else {}
    return {k[len("kernel_launches:"):]: int(v) for k, v in gauges.items()
            if k.startswith("kernel_launches:")}


def elastic_phase(torch, port, details_out, card: str) -> dict:
    """The elastic slice on the card; see the module docstring. Returns the
    relaunched attempts' launches by kernel. Files in ``ELASTIC_ROOT``
    (removed after a pass)."""
    t_phase = time.perf_counter()
    shutil.rmtree(ELASTIC_ROOT, ignore_errors=True)
    os.makedirs(ELASTIC_ROOT)
    rec: dict = {}
    details_out["elastic"] = rec
    north = os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml")
    supervised = ["elastic.enabled=true", "elastic.world=1", "elastic.backoff_s=0",
                  f"obs.slo_recovery_s={ELASTIC_SLO_S}"]

    def run_args(name: str, *over: str) -> list[str]:
        d = os.path.join(ELASTIC_ROOT, name)
        # Without the introspection harvest, whose first step (~10 s on the
        # card) every worker start would pay.
        return ["run", "--config", north, "data.dataset=synthetic",
                f"data.synthetic_size={ELASTIC_N}", "score.seeds=[0,1]",
                "train.num_epochs=3", "train.checkpoint_every=1",
                "checkpoint.local_tier=true", f"train.checkpoint_dir={d}/ckpt",
                f"obs.metrics_path={d}/m.jsonl", "obs.xla_introspect=false", *over]

    def finished(name: str, cp: CliProcess) -> tuple[list[dict], float]:
        rc, _, wall = cp.wait(ELASTIC_TIMEOUT_S)
        logs = "".join(cp.tail)[-1500:]
        child = os.path.join(ELASTIC_ROOT, name, "ckpt_elastic")
        for log in sorted(os.listdir(child)) if os.path.isdir(child) else []:
            with open(os.path.join(child, log), errors="replace") as fh:
                logs += f"\n[{log}] " + fh.read()[-1500:]
        check(rc == 0, f"elastic {name}: exit {rc}: {logs}")
        with open(os.path.join(ELASTIC_ROOT, name, "m.jsonl")) as fh:
            return records(fh.read()), wall

    def events(recs: list[dict]) -> list[dict]:
        return [r for r in recs if r["kind"] == "elastic_event"]

    # All five at once on the card.
    procs = {"ref": CliProcess(run_args("ref")),
             "ref_el2n": CliProcess(run_args("ref_el2n", "score.method=el2n")),
             "join": CliProcess(run_args("join", *supervised, "elastic.max_world=1"),
                                plan={"rejoin_after_stage": "score"}),
             "term": CliProcess(run_args("term", *supervised, "score.method=el2n",
                                         "resilience.stage_resume=false",
                                         f"checkpoint.promote_delay_s={ELASTIC_DELAY_S}"),
                                plan={"rank": 0, "sigterm_at_epoch_end": 1}),
             "kill": CliProcess(run_args("kill", *supervised, "resilience.stage_resume=false"),
                                plan={"rank": 0, "kill_rank_after_epoch": 1})}
    done = {name: finished(name, cp) for name, cp in procs.items()}
    join_events = [e["event"] for e in events(done["join"][0])]
    check("join_denied" in join_events and join_events[-1] == "complete"
          and not os.path.exists(os.path.join(ELASTIC_ROOT, "join", "ckpt_elastic",
                                              "join.json")),
          f"(c) join at max_world=1: {join_events}")
    check(same_run(torch, port, os.path.join(ELASTIC_ROOT, "ref"),
                   os.path.join(ELASTIC_ROOT, "join")), "(c) not bitwise the reference")
    join_resumed = [r for r in done["join"][0] if r["kind"] == "score_seeds_resumed"]
    rec["c"] = {"events": join_events, "wall_s": done["join"][1],
                "stage_manifest_reentry": bool(join_resumed)}
    print(f"  five at once: R {done['ref'][1]:.1f} s, R_el2n {done['ref_el2n'][1]:.1f} s, "
          f"(a) {done['kill'][1]:.1f} s, (b) {done['term'][1]:.1f} s, (c) "
          f"{done['join'][1]:.1f} s; (c) join denied: {join_events}; its relaunch "
          f"through the stage manifest: {bool(join_resumed)}", flush=True)

    # (b): SIGTERM while epoch 1's promotion is in flight.
    recs_b, wall_b = done["term"]
    ev_b = [e["event"] for e in events(recs_b)]
    check(ev_b == ["supervise", "launch", "children_exited", "restart", "launch",
                   "children_exited", "complete"]
          and events(recs_b)[2]["action"] == "preempted" and events(recs_b)[2]["rcs"] == [75],
          f"(b) chain {ev_b}")
    pre = [r for r in recs_b if r["kind"] == "preempted" and r.get("attempt") == 0]
    check(len(pre) == 1 and pre[0]["durable_step"] == pre[0]["step"]
          and pre[0].get("drain_timed_out") is False
          and pre[0].get("drain_wait_s", 0) > 0 and pre[0].get("drain_budget_s") == 120.0,
          f"(b) preempted {pre}")
    resumes_b = [r for r in recs_b if r["kind"] == "resume" and r.get("attempt") == 1]
    check(len(resumes_b) == 1 and resumes_b[0]["step"] == pre[0]["durable_step"],
          f"(b) resume {resumes_b} after {pre}")
    check(same_run(torch, port, os.path.join(ELASTIC_ROOT, "ref_el2n"),
                   os.path.join(ELASTIC_ROOT, "term")), "(b) not bitwise R_el2n")
    b_counts = attempt_launches(recs_b, 1)
    check(b_counts.get("el2n", 0) > 0, f"(b)'s relaunch launched {b_counts}")
    rec["b"] = {"wall_s": wall_b, "preempted": pre[0], "resume": resumes_b[0],
                "launches_relaunch": b_counts}
    print(f"  (b) SIGTERM mid-promotion: {ev_b}; drained {pre[0]['drain_wait_s']} s of "
          f"{pre[0]['drain_budget_s']} s, durable at {pre[0]['durable_step']}; bitwise "
          f"R_el2n; relaunch launches {b_counts}", flush=True)

    # (a): host loss.
    recs, wall_a = done["kill"]
    ev = events(recs)
    check([e["event"] for e in ev] == ELASTIC_CHAIN, f"(a) chain {[e['event'] for e in ev]}")
    check(ev[2]["action"] == "shrink" and ev[2]["rcs"] == [-9]
          and ev[3]["dead_ranks"] == [0] and ev[3]["new_world"] == 1
          and ev[4]["resume"] is True, f"(a) events {ev}")
    resumes = [r for r in recs if r["kind"] == "resume" and r.get("attempt") == 1]
    tiers = port["tier_steps"](os.path.join(ELASTIC_ROOT, "kill", "ckpt"))
    check(len(resumes) == 1 and resumes[0]["tag"] == "final"
          and resumes[0]["step"] in tiers and resumes[0]["saved_world"] == 1
          and resumes[0]["world"] == 1, f"(a) resume {resumes}; tier steps {tiers}")
    check(same_run(torch, port, os.path.join(ELASTIC_ROOT, "ref"),
                   os.path.join(ELASTIC_ROOT, "kill")), "(a) not bitwise the reference")
    a_counts = attempt_launches(recs, 1)
    check(a_counts.get("conv_grad_norm_direct", 0) > 0
          and a_counts.get("conv_grad_norm_gram", 0) > 0,
          f"(a)'s relaunch launched {a_counts}")
    validate_stream(os.path.join(ELASTIC_ROOT, "kill", "m.jsonl"), expect_terminal=True)
    summary = recs[-1]
    slo_wall = summary_gauge([r for r in recs if r.get("attempt") == 1
                              and r["kind"] != "elastic_event"], "slo_recovery_wall_s")
    worker_slo = [r["slo"] for r in recs if r["kind"] == "run_summary"
                  and r.get("attempt") == 1 and "slo" in r]
    rec["a"] = {"wall_s": wall_a, "resume": resumes[0], "lineage": summary["lineage"],
                "launches_relaunch": a_counts, "slo_recovery_wall_s": slo_wall,
                "slo": worker_slo[-1] if worker_slo else None}
    print(f"  (a) kill after epoch 1: chain "
          f"{[e['event'] for e in ev]}; resume at step {resumes[0]['step']} (tier steps "
          f"{tiers}); bitwise R; relaunch launches {a_counts}; lineage "
          f"{summary['lineage']}", flush=True)

    # (d): the post-mortem of (a).
    pm = subprocess.run([sys.executable, "-m", "data_diet_distributed_tpu_torch.obs.postmortem",
                         os.path.join(ELASTIC_ROOT, "kill", "m.jsonl"), "--json"],
                        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                        capture_output=True, text=True, timeout=120)
    check(pm.returncode == 0, f"(d) post-mortem exit {pm.returncode}: {pm.stdout[-2000:]}")
    report = json.loads(pm.stdout.strip().splitlines()[-1])
    chains = [c for c in report["recoveries"] if c["type"] == "relaunch"]
    check(len(chains) == 1 and chains[0]["action"] == "shrink"
          and chains[0]["dead_ranks"] == [0]
          and chains[0]["resume_step"] == resumes[0]["step"]
          and chains[0]["recovery_wall_s"] is not None, f"(d) chains {chains}")
    slo_ok = bool(rec["a"]["slo"] and rec["a"]["slo"]["ok"]) and report["slo_violations"] == 0
    rec["d"] = {"recovery_wall_s": chains[0]["recovery_wall_s"],
                "lost_wall_s": report["lost_wall_s"], "slo_held": slo_ok}
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"  (d) post-mortem exit 0: kill -> shrink(dead [0]) -> resume at step "
          f"{chains[0]['resume_step']}; recovery wall {chains[0]['recovery_wall_s']} s "
          f"(classification to the first training record), SLO clock {slo_wall} s "
          f"against {ELASTIC_SLO_S} s: {'held' if slo_ok else 'MISSED'}", flush=True)
    check(slo_ok, f"(a) recovery SLO missed: {rec['a']['slo']}")
    print(f"  elastic phase {rec['wall_s']:.1f} s", flush=True)
    shutil.rmtree(ELASTIC_ROOT, ignore_errors=True)
    return {k: a_counts.get(k, 0) + b_counts.get(k, 0) for k in port["kernels"].KERNELS}


FLEET_ROOT = os.path.join(REPO, "chip_smoke_out", "fleet")
FLEET_BOOT_S = 300             # a fleet's replicas answering /healthz, warm-up included
FLEET_KILL_AFTER = 6           # replica 1 SIGKILLs itself with its 7th dispatch in flight
FLEET_KILL_CLIENTS = 4         # (a)'s client threads, FLEET_KILL_REQUESTS each
FLEET_KILL_REQUESTS = 10
FLEET_HAMMER_IDS = 64          # ids of each request of (b)'s hammer
FLEET_CANARY_REQUESTS = 4      # serve.canary_requests of (c)
FLEET_SLOW_MS = 600.0          # the regressed step's injected latency
# The fleet p95 floor of (c): above a healthy replica's GraNd p95 on the card
# (~70-200 ms in the service and fleet phases, PERF.md), below FLEET_SLOW_MS.
FLEET_P95_FLOOR_MS = 400.0
FLEET_GRAND_RTOL = 1e-4        # (d): the BN-kernel route's GraNd vs the default route's
FLEET_STEPS = {"good": 2, "torn": 3, "regressed": 4}


def fleet_argv(root: str, *over: str) -> list[str]:
    """``cli serve`` of a two-replica fleet on the path's model, data, seeds,
    batch and dtype, both methods warm, the router on a free port."""
    return [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve",
            "--device", "cuda",
            "--config", os.path.join(REPO, "configs", "cifar10_resnet18.yaml"),
            "data.dataset=synthetic", f"data.synthetic_size={N_PATH}",
            "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}",
            f"score.batch_size={B}", "train.half_precision=true",
            "serve.methods=[el2n,grand]", "serve.tenant=synthetic", "serve.replicas=2",
            "serve.router_port=0", "serve.port=0", "serve.health_poll_s=0.25",
            "serve.breaker_reset_s=0.5", "serve.stats_every_s=2",
            "serve.request_timeout_s=120", f"serve.drain_timeout_s={SERVICE_DRAIN_S}",
            "elastic.max_restarts=2", "elastic.backoff_s=0.2",
            f"obs.metrics_path={root}/metrics.jsonl", f"obs.heartbeat_dir={root}/hb",
            f"train.checkpoint_dir={root}/ckpt", *over]


def jsonl(path: str) -> list[dict]:
    """The JSON records of a file (``records``: text lines and a killed
    writer's partial line skipped); none while it does not exist."""
    if not os.path.exists(path):
        return []
    with open(path, errors="replace") as fh:
        return records(fh.read())


class Fleet:
    """One ``cli serve`` fleet subprocess (its own process group, so a failed
    phase can stop its replicas too) and the views of it the drills read."""

    def __init__(self, root: str, plan: dict | None, *over: str):
        from data_diet_distributed_tpu_torch.tools import serve_client
        self.sc = serve_client
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.metrics = os.path.join(root, "metrics.jsonl")
        env = {**os.environ, "PYTHONPATH": REPO}
        env.pop("DDT_FAULT_PLAN", None)
        if plan is not None:
            env["DDT_FAULT_PLAN"] = json.dumps(plan)
        self.log = open(os.path.join(root, "supervisor.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(fleet_argv(root, *over), cwd=root, env=env,
                                     stdout=self.log, stderr=subprocess.STDOUT,
                                     start_new_session=True)
        launch = self.wait_record(lambda r: r.get("kind") == "serve_fleet"
                                  and r.get("event") == "launch", "launch", 120)
        self.url = f"http://127.0.0.1:{launch['router_port']}"
        self.client = self.sc.ServeClient(self.url, timeout_s=120.0, retries=6,
                                          backoff_s=0.25)
        self.probe = self.sc.ServeClient(self.url, timeout_s=10.0)

    def records(self) -> list[dict]:
        return jsonl(self.metrics)

    def tail(self) -> str:
        with open(os.path.join(self.root, "supervisor.log"), errors="replace") as fh:
            return fh.read()[-3000:]

    def wait_record(self, pred, what: str, budget_s: float, during=None) -> dict:
        """The first record ``pred`` accepts; ``during()`` runs between looks
        (traffic a canary hold needs)."""
        deadline = time.perf_counter() + budget_s
        while True:
            check(self.proc.poll() is None,
                  f"fleet: the supervisor exited {self.proc.returncode} waiting for "
                  f"{what}: {self.tail()}")
            hit = next((r for r in self.records() if pred(r)), None)
            if hit is not None:
                return hit
            check(time.perf_counter() < deadline, f"fleet: no {what} within {budget_s} s")
            if during is not None:
                during()
            else:
                time.sleep(0.25)

    def wait_available(self, n: int, budget_s: float = FLEET_BOOT_S) -> float:
        """Waits until the router's /healthz reports ``n`` routable replicas;
        returns the wall clock then."""
        deadline = time.perf_counter() + budget_s
        verdict = None
        while time.perf_counter() < deadline:
            check(self.proc.poll() is None, f"fleet: the supervisor exited: {self.tail()}")
            try:
                verdict = self.probe.healthz()
            except self.sc.ServeError:
                verdict = None
            if verdict and verdict.get("available") == n:
                return time.time()
            time.sleep(0.1)
        fail(f"fleet: never {n} routable replicas within {budget_s} s: {verdict}")

    def replica_ports(self) -> list[int]:
        return [r["port"] for r in self.records() if r.get("kind") == "replica_event"
                and r.get("event") == "spawn"]

    def replica_logs(self) -> dict[tuple[int, int], list[dict]]:
        """(replica, generation) -> that process's records (rank 0's in a
        fleet of meshes), from its log."""
        import re
        d = os.path.join(self.root, "ckpt_fleet")
        out = {}
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            m = re.fullmatch(r"replica(\d+)(?:_r(\d+))?_g(\d+)\.log", name)
            if m and m.group(2) in (None, "0"):
                out[(int(m.group(1)), int(m.group(3)))] = jsonl(os.path.join(d, name))
        return out

    def stop(self) -> tuple[int, float]:
        """SIGTERM to the supervisor: drain, exit. Returns (rc, seconds)."""
        import signal
        t = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=SERVICE_DRAIN_S + SERVICE_EXIT_GRACE_S + 30)
        self.log.close()
        return rc, time.perf_counter() - t

    def kill(self) -> None:
        """After a failure: stop the supervisor and every replica."""
        import signal
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        with contextlib.suppress(Exception):
            self.proc.wait(timeout=30)
        self.log.close()


def served(fleet: Fleet, ids, method: str) -> np.ndarray:
    return np.asarray(fleet.client.score(indices=[int(i) for i in ids],
                                         method=method)["scores"], np.float32)


def replica_delta(fleet: Fleet, port: int, method: str) -> dict:
    """The launches of one 512-row dispatch on one replica: its /status
    ``kernel_launches`` across one direct request of B ids."""
    def launches():
        code, _, raw = http_call(port, "/status")
        check(code == 200, f"fleet: replica /status {code}")
        return json.loads(raw)["kernel_launches"]
    before = launches()
    code, _, raw = http_call(port, "/v1/score", {"indices": list(range(B)), "method": method})
    check(code == 200, f"fleet: direct {method} request to replica {port}: {code} {raw[:200]}")
    after = launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def cuda_holders(pids) -> dict[int, bool]:
    """pid -> whether it holds a /dev/nvidia* file (a CUDA context opens them)."""
    out = {}
    for pid in pids:
        held = False
        with contextlib.suppress(OSError):
            for fd in os.listdir(f"/proc/{pid}/fd"):
                with contextlib.suppress(OSError):
                    held |= os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        out[pid] = held
    return out


def children_of(pid: int) -> list[int]:
    kids = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            with contextlib.suppress(OSError, ValueError, IndexError):
                with open(f"/proc/{d}/stat") as fh:
                    if int(fh.read().rsplit(")", 1)[1].split()[1]) == pid:
                        kids.append(int(d))
    return kids


def fleet_phase(torch, port, path, details_out, card: str) -> dict:
    """The fleet slice on the card; see the module docstring. Returns the
    replicas' launches by kernel (each replica a new process, read from its
    final ``metrics`` record). Files in ``FLEET_ROOT`` (removed after a pass)."""
    t_phase = time.perf_counter()
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    os.makedirs(FLEET_ROOT)
    rec: dict = {}
    details_out["fleet"] = rec
    K = port["kernels"]
    ds, cfg = path["ds"], path["cfg"]
    pos = {int(i): k for k, i in enumerate(ds.indices)}
    init = {m: path["results"][m]["scores"] for m in ("el2n", "grand")}
    rng = np.random.default_rng(16)

    def truth(scores, ids):
        return scores[[pos[int(i)] for i in ids]]

    # The refresh source: a good step, a newer torn one, and the regressed step
    # the canary drill sees, written by the port's CheckpointManager.
    model = port["create_model_from_cfg"](cfg)
    refresh_dir = os.path.join(FLEET_ROOT, "refresh_ck")
    mngr = port["CheckpointManager"](refresh_dir)
    for step, seed in ((FLEET_STEPS["good"], 5), (FLEET_STEPS["torn"], 9)):
        mngr.save(step, port["train"]["state_from_variables"](
            port["init_variables"]("resnet18", seed, "cuda"), model))
    port["inject"].truncate_checkpoint(refresh_dir, FLEET_STEPS["torn"])
    good_vars = mngr.restore_variables(FLEET_STEPS["good"], "cuda")
    new = {m: port["score_dataset"](model, [good_vars], ds, method=m, batch_size=B,
                                    device="cuda") for m in ("el2n", "grand")}
    check(not np.array_equal(new["grand"], init["grand"]), "fleet: the good step scores as init")
    counts = dict.fromkeys(K.KERNELS, 0)

    def add_launches(fleet: Fleet) -> dict:
        """Adds each replica process's launches (its last ``metrics``
        record) to ``counts``; returns them by ``(replica, generation)``."""
        per = {}
        for key, recs in fleet.replica_logs().items():
            snaps = [r for r in recs if r.get("kind") == "metrics"]
            if snaps:
                per[key] = {k[len("kernel_launches:"):]: int(v)
                            for k, v in snaps[-1]["gauges"].items()
                            if k.startswith("kernel_launches:")}
                for k, v in per[key].items():
                    counts[k] += v
        return per

    # ---- Both fleets boot at once. A carries (a) the kill, the router's latency,
    # the launches of a dispatch and (b) the refresh roll; B carries (c) the
    # canary rollback and (d) the tuning roll, whose two sequential replica boots
    # run while A's killed replica respawns. The latency is read after B stops.
    watch = os.path.join(FLEET_ROOT, "watched")
    manifest_path = os.path.join(FLEET_ROOT, "tuning_manifest.json")
    fleets: list[Fleet] = []
    try:
        # A: a fleet of one-rank meshes, each replica its own NCCL group.
        fleets.append(Fleet(os.path.join(FLEET_ROOT, "a"),
                            {"rank": 1, "kill_replica_after_requests": FLEET_KILL_AFTER},
                            f"serve.refresh_from={refresh_dir}", "mesh.multihost=true",
                            "mesh.num_processes=1"))
        fleets.append(Fleet(os.path.join(FLEET_ROOT, "b"),
                            {"rank": 0, "slow_replica_ms": FLEET_SLOW_MS,
                             "slow_if_step": FLEET_STEPS["regressed"]},
                            f"serve.refresh_from={watch}", "serve.refresh_poll_s=0.5",
                            f"serve.canary_requests={FLEET_CANARY_REQUESTS}",
                            "serve.canary_timeout_s=30",
                            f"obs.slo_fleet_p95_ms={FLEET_P95_FLOOR_MS}",
                            f"tuning.manifest={manifest_path}"))
        fleet, fleet_b = fleets
        for f in fleets:
            f.wait_available(2)
        rec["boot_s"] = boot = {k: time.perf_counter() - f.t0 for k, f in zip("ab", fleets)}
        sups = [f.proc.pid for f in fleets]
        replicas = {sup: children_of(sup) for sup in sups}
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        check(smi.returncode == 0, f"nvidia-smi --query-compute-apps failed: {smi.stderr}")
        smi_pids = {int(x) for x in smi.stdout.split() if x.strip().isdigit()}
        holders = cuda_holders(sups + [p for ps in replicas.values() for p in ps])
        for sup in sups:
            check(sup not in smi_pids, f"(f) the supervisor {sup} is a compute app: {smi_pids}")
            check(not holders[sup] and len(replicas[sup]) == 2
                  and all(holders[p] for p in replicas[sup]),
                  f"(f) /dev/nvidia* holders {holders} (supervisor {sup})")
        rec["f"] = {"supervisors": sups, "replicas": replicas,
                    "compute_apps": sorted(smi_pids), "nvidia_fds": holders}
        print(f"  (f) fleets A and B up {boot['a']:.1f} s and {boot['b']:.1f} s after launch "
              f"(booting at once, 2 replicas each, warm); supervisors {sups} not among "
              f"nvidia-smi's compute apps {sorted(smi_pids)} and hold no /dev/nvidia* file; "
              f"the replicas {replicas} hold them", flush=True)

        # (c) on B, A idle: a good step rolls with its canary passing; the regressed
        # step fails its canary on replica 0 and is rolled back.
        sweep = rng.choice(N_PATH, size=B, replace=False)

        def burst() -> None:
            ids = rng.choice(N_PATH, size=8, replace=False)
            for _ in range(2):
                served(fleet_b, ids, "el2n")

        def refresh_rec(status, step):
            return lambda r: (r.get("kind") == "model_refresh" and r.get("status") == status
                              and r.get("step") == step and "replica" not in r)

        os.makedirs(watch)
        wm = port["CheckpointManager"](watch)
        wm.save(FLEET_STEPS["good"], port["train"]["state_from_variables"](good_vars, model))
        started = fleet_b.wait_record(refresh_rec("roll_started", FLEET_STEPS["good"]),
                                      "roll_started", 60)
        done = fleet_b.wait_record(refresh_rec("roll_complete", FLEET_STEPS["good"]),
                                   "roll_complete", 120, during=burst)
        check((done.get("canary") or {}).get("verdict") == "pass",
              f"(c) the good step's canary {done.get('canary')}")
        check(np.array_equal(served(fleet_b, sweep, "grand"), truth(new["grand"], sweep)),
              "(c) the good step's answers differ from the offline pass")
        good_roll_s = done["ts"] - started["ts"]
        wm.save(FLEET_STEPS["regressed"], port["train"]["state_from_variables"](
            port["init_variables"]("resnet18", 11, "cuda"), model))
        started = fleet_b.wait_record(refresh_rec("roll_started", FLEET_STEPS["regressed"]),
                                      "roll_started", 60)
        back = fleet_b.wait_record(lambda r: r.get("kind") == "model_refresh"
                                   and r.get("status") == "rolled_back", "rolled_back", 120,
                                   during=burst)
        canary = back.get("canary") or {}
        check(back.get("step") == FLEET_STEPS["regressed"] and canary.get("verdict") == "fail"
              and canary.get("replica") == 0
              and (back.get("prior") or {}).get("step") == FLEET_STEPS["good"]
              and any("p95" in x for x in canary.get("reasons") or []),
              f"(c) rollback record {back}")
        check(not any(refresh_rec("roll_complete", FLEET_STEPS["regressed"])(r)
                      for r in fleet_b.records()), "(c) the regressed step reached the fleet")
        for m in ("el2n", "grand"):
            check(np.array_equal(served(fleet_b, sweep, m), truth(new[m], sweep)),
                  f"(c) {m} after the rollback is not the prior model's")
        bad_roll_s = back["ts"] - started["ts"]
        rec["canary"] = {"good_roll_s": good_roll_s, "rollback_s": bad_roll_s,
                         "canary": canary}
        print(f"  (c) step {FLEET_STEPS['good']} rolled with its canary passing in "
              f"{good_roll_s:.2f} s; step {FLEET_STEPS['regressed']} ({FLEET_SLOW_MS:g} ms "
              f"slower while installed) failed its canary (p95 {canary.get('p95_ms')} ms > "
              f"{FLEET_P95_FLOOR_MS:g} ms over {canary.get('requests')} requests) and was "
              f"rolled back in {bad_roll_s:.2f} s; the prior model serves bitwise", flush=True)

        # (d) starts: a signed manifest for this card pins the BN kernel; B rolls it
        # one replica at a time while (a) runs on A.
        tuning = port["tuning"]
        manifest = tuning.build_tuning_manifest(
            task="score", method="grand", arch="resnet18", dataset="synthetic",
            batch_size=B, backend="cuda", device_kind=torch.cuda.get_device_name(0),
            n_devices=1, env={"DDT_GRAND_BN_KERNEL": "1"}, config={},
            chosen_combo="bn_kernel", metric="fleet_phase", value=0.0, unit="none",
            baseline_value=None, exactness=[], candidates_considered=1,
            source="chip_smoke.py")
        tuning.write_tuning_manifest(manifest_path, manifest)
        roll = fleet_b.wait_record(lambda r: r.get("kind") == "serve_fleet"
                                   and r.get("event") == "tuning_roll", "tuning_roll", 60)

        # (a) replica 1 of A dies mid-dispatch under keyed load: no failure, all bitwise.
        errors, answers, lat = [], [], []

        def client_loop(k: int) -> None:
            c = fleet.sc.ServeClient(fleet.url, timeout_s=120.0, retries=6, backoff_s=0.25)
            r = np.random.default_rng(100 + k)
            for i in range(FLEET_KILL_REQUESTS):
                m = ("el2n", "grand")[(k + i) % 2]
                ids = r.choice(N_PATH, size=int(r.integers(1, SERVICE_MAX_IDS + 1)),
                               replace=False)
                t = time.perf_counter()
                try:
                    got = np.asarray(c.score(indices=ids.tolist(), method=m)["scores"],
                                     np.float32)
                    lat.append((time.perf_counter() - t) * 1e3)
                    answers.append(np.array_equal(got, truth(init[m], ids)))
                except Exception as exc:   # noqa: BLE001 — counted, then failed on
                    errors.append(repr(exc)[:200])

        threads = [threading.Thread(target=client_loop, args=(k,))
                   for k in range(FLEET_KILL_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        died = fleet.wait_record(lambda r: r.get("kind") == "replica_event"
                                 and r.get("event") == "died", "died", 60)
        check(errors == [], f"(a) client-visible failures through the kill: {errors[:3]}")
        check(len(answers) == FLEET_KILL_CLIENTS * FLEET_KILL_REQUESTS and all(answers),
              f"(a) {answers.count(False)} of {len(answers)} answers differ from the "
              "offline pass")
        check(died["replica"] == 1 and died["signal"] == 9 and died.get("rank") == 0,
              f"(a) died record {died}")
        respawn = fleet.wait_record(lambda r: r.get("kind") == "replica_event"
                                    and r.get("event") == "respawn", "respawn", 60)
        t_back = fleet.wait_available(2)
        spawn = [r for r in fleet.records() if r.get("kind") == "replica_event"
                 and r.get("event") == "spawn"][1]
        spawn_port = spawn["port"]
        check(respawn["replica"] == 1 and respawn["generation"] == 1
              and respawn["port"] == spawn_port and respawn.get("dead_rank") == 0
              and respawn["coordinator"] != spawn["coordinator"],
              f"(a) respawn {respawn}, spawn {spawn}")
        rec["respawn_wall_s"] = respawn_wall = t_back - died["ts"]
        for m in ("el2n", "grand"):
            check(np.array_equal(served(fleet, sweep, m), truth(init[m], sweep)),
                  f"(a) {m} after the respawn differs from the offline pass")
        print(f"  (a) {len(answers)} keyed requests from {FLEET_KILL_CLIENTS} clients, "
              f"replica 1 (rank 0 of its one-rank mesh) SIGKILLed after {FLEET_KILL_AFTER} "
              f"requests: 0 failures, every answer bitwise the offline pass; the group "
              f"respawned on port {spawn_port} with coordinator {spawn['coordinator']} -> "
              f"{respawn['coordinator']} and routable again {respawn_wall:.1f} s after the "
              "death (B's tuning roll booting beside it)", flush=True)

        # (d) ends, is checked and B stops before the latency is read, so only
        # A's two replicas are on the card then, as in a fleet of its own.
        complete = fleet_b.wait_record(lambda r: r.get("kind") == "serve_fleet"
                                       and r.get("event") in ("tuning_roll_complete",
                                                              "tuning_roll_abort"),
                                       "tuning_roll_complete", 2 * FLEET_BOOT_S)
        check(complete["event"] == "tuning_roll_complete"
              and complete["digest"] == manifest["digest"], f"(d) {complete}")
        fleet_b.wait_available(2)
        # (d) on B: each tuning respawn boots on the config's model, so after the
        # roll B serves the init weights again, not step 2 that (c) had rolled
        # (the JAX fleet does the same; ROADMAP Queue 3). The gate expects that.
        respawns = [r for r in fleet_b.records() if r.get("kind") == "replica_event"
                    and r.get("event") == "tuning_respawn"]
        check([r["replica"] for r in respawns] == [0, 1], f"(d) tuning respawns {respawns}")
        tuned = [(r["replica"], r["generation"]) for r in respawns]
        logs = fleet_b.replica_logs()
        for key in tuned:
            applied = [r for r in logs.get(key, []) if r.get("kind") == "tuning_applied"]
            check(len(applied) == 1 and applied[0]["applied"]
                  and applied[0]["knobs"] == {"DDT_GRAND_BN_KERNEL": "1"}
                  and applied[0]["digest"] == manifest["digest"],
                  f"(d) replica {key} tuning_applied {applied}")
        got = served(fleet_b, sweep, "grand")
        ref = truth(init["grand"], sweep)
        rel = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)))
        check(rel <= FLEET_GRAND_RTOL, f"(d) BN-kernel GraNd vs the default route: "
              f"max rel {rel:.3e}")
        bn = replica_delta(fleet_b, fleet_b.replica_ports()[0], "grand")
        per_seed = next(r[3] for r in ROUTES if r[0] == "BN_KERNEL")
        check(bn == {k: v * len(SEEDS) for k, v in per_seed.items()},
              f"(d) a tuned dispatch's launches {bn}, want {per_seed} per seed")
        rec["tuning"] = {"roll_s": complete["ts"] - roll["ts"], "grand_max_rel": rel,
                         "dispatch_launches": bn}
        print(f"  (d) manifest {manifest['digest'][:12]} (backend cuda, "
              f"{torch.cuda.get_device_name(0)}, DDT_GRAND_BN_KERNEL=1) rolled one replica "
              f"at a time in {complete['ts'] - roll['ts']:.1f} s (beside (a)); each new "
              f"replica logged tuning_applied; served GraNd (the config's model, as the "
              f"respawns boot on it) max rel {rel:.2e} from the default route's; one {B}-row "
              f"dispatch launches {bn}", flush=True)
        rc_b, exit_b = fleet_b.stop()

        # The router's request latency per method at the service phase's load.
        rec["latency"] = {}
        for m in ("el2n", "grand"):
            ms, bad = [], []

            def lat_loop(k: int, m=m, ms=ms, bad=bad) -> None:
                c = fleet.sc.ServeClient(fleet.url, timeout_s=120.0)
                r = np.random.default_rng(200 + k)
                for _ in range(SERVICE_REQUESTS):
                    ids = r.choice(N_PATH, size=int(r.integers(1, SERVICE_MAX_IDS + 1)),
                                   replace=False)
                    t = time.perf_counter()
                    got = np.asarray(c.score(indices=ids.tolist(), method=m)["scores"],
                                     np.float32)
                    ms.append((time.perf_counter() - t) * 1e3)
                    if not np.array_equal(got, truth(init[m], ids)):
                        bad.append(ids[:4].tolist())

            threads = [threading.Thread(target=lat_loop, args=(k,))
                       for k in range(SERVICE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            check(len(ms) == SERVICE_CLIENTS * SERVICE_REQUESTS and not bad,
                  f"fleet latency {m}: {len(ms)} answers, {len(bad)} differ")
            p50, p95 = (float(np.percentile(ms, q)) for q in (50, 95))
            rec["latency"][m] = {"p50_ms": p50, "p95_ms": p95, "n": len(ms)}
            print(f"  router {m}: {SERVICE_CLIENTS} clients x {SERVICE_REQUESTS} requests "
                  f"of 1-{SERVICE_MAX_IDS} ids, p50 {p50:.2f} ms p95 {p95:.2f} ms, all "
                  f"bitwise (on {card})", flush=True)

        # Launches of one 512-row dispatch on each replica, by /status deltas.
        rec["per_dispatch"] = {}
        for r, p in enumerate(fleet.replica_ports()):
            g, e = replica_delta(fleet, p, "grand"), replica_delta(fleet, p, "el2n")
            check(g == {"conv_grad_norm_direct": 12 * len(SEEDS),
                        "conv_grad_norm_gram": 3 * len(SEEDS)}
                  and e == {"el2n": len(SEEDS)}, f"fleet: replica {r} dispatch launches "
                  f"grand {g} el2n {e}")
            rec["per_dispatch"][r] = {"grand": g, "el2n": e}
        print(f"  launches of one {B}-row dispatch (both replicas): grand "
              f"{rec['per_dispatch'][0]['grand']}, el2n {rec['per_dispatch'][0]['el2n']}",
              flush=True)

        # (b) the torn newest step is refused; the good one rolls one replica at a time.
        try:
            torn = fleet.client.refresh()
        except fleet.sc.ServeError as err:
            torn = {"status_code": err.status, **err.payload}
        check(torn.get("status_code") == 409 and torn.get("status") == "roll_aborted",
              f"(b) a stepless refresh onto the torn step: {torn}")
        check(np.array_equal(served(fleet, sweep, "grand"), truth(init["grand"], sweep)),
              "(b) the old model stopped serving after the refused refresh")
        hammered, avail, stop = [], [], threading.Event()

        def hammer() -> None:
            c = fleet.sc.ServeClient(fleet.url, timeout_s=120.0, retries=6)
            r = np.random.default_rng(300)
            while not stop.is_set():
                ids = r.choice(N_PATH, size=FLEET_HAMMER_IDS, replace=False)
                got = np.asarray(c.score(indices=ids.tolist(), method="grand")["scores"],
                                 np.float32)
                hammered.append(np.array_equal(got, truth(init["grand"], ids))
                                or np.array_equal(got, truth(new["grand"], ids)))

        def capacity() -> None:
            while not stop.is_set():
                with contextlib.suppress(fleet.sc.ServeError):
                    avail.append(fleet.probe.healthz().get("available"))
                time.sleep(0.05)

        threads = [threading.Thread(target=hammer), threading.Thread(target=capacity)]
        for t in threads:
            t.start()
        t = time.perf_counter()
        try:
            refreshed = fleet.client.refresh(step=FLEET_STEPS["good"])
        finally:
            rec["refresh_roll_s"] = roll_s = time.perf_counter() - t
            time.sleep(0.3)
            stop.set()
            for th in threads:
                th.join(120)
        check(refreshed.get("status") == "rolled"
              and [x.get("code") for x in refreshed["replicas"]] == [200, 200],
              f"(b) refresh roll {refreshed}")
        check(hammered and all(hammered), f"(b) {hammered.count(False)} of {len(hammered)} "
              "answers during the roll are neither the old nor the new model")
        check(avail and min(avail) >= 1, f"(b) capacity fell to {min(avail or [0])}")
        for m in ("el2n", "grand"):
            check(np.array_equal(served(fleet, sweep, m), truth(new[m], sweep)),
                  f"(b) {m} after the roll differs from the offline pass on the step")
        print(f"  (b) torn step {FLEET_STEPS['torn']} refused (409 roll_aborted, old model "
              f"serving); step {FLEET_STEPS['good']} rolled one replica at a time in "
              f"{roll_s:.2f} s under a hammer of {len(hammered)} requests, each bitwise old "
              f"or new, capacity never below {min(avail)}", flush=True)
        rc_a, exit_a = fleet.stop()

    except BaseException:
        for f in fleets:
            f.kill()
        raise
    fleet, fleet_b = fleets
    recs = fleet.records()
    check(rc_a == 75, f"(e) fleet A exit {rc_a}: {fleet.tail()}")
    validate_stream(fleet.metrics, expect_terminal=True)
    lin = recs[-1].get("lineage") or {}
    check(recs[-1]["exit_class"] == "preempted" and lin.get("respawns") == 1
          and lin.get("ranks") == 1, f"(e) fleet A run_summary {recs[-1]}")
    ended = [r for r in recs if r.get("kind") == "serve_fleet"
             and r.get("event") == "preempted_exit"]
    check(len(ended) == 1 and ended[0].get("rank_rcs") == [[75], [75]],
          f"(e) fleet A's ranks' exits {ended}")
    rec["a_launches"] = {f"r{r}g{g}": v for (r, g), v in add_launches(fleet).items()}
    check(rc_b == 75, f"(e) fleet B exit {rc_b}: {fleet_b.tail()}")
    n = validate_stream(fleet_b.metrics, expect_terminal=True)
    check(fleet_b.records()[-1]["exit_class"] == "preempted", "(e) fleet B run_summary")
    per = add_launches(fleet_b)
    for key in tuned:
        check(per.get(key, {}).get("bn_grad_norm", 0) > 0,
              f"(d) tuned replica {key}'s metrics record: {per.get(key)}")
    rec["b_launches"] = {f"r{r}g{g}": v for (r, g), v in per.items()}
    rec["exit_s"] = {"a": exit_a, "b": exit_b}
    rec["phase_wall_s"] = wall = time.perf_counter() - t_phase
    print(f"  (e) both fleets exited 75 on SIGTERM ({exit_a:.1f} s and {exit_b:.1f} "
          f"s after it), streams valid ({n} records in B); replica launches {counts}; "
          f"fleet phase: {wall:.1f} s", flush=True)
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    return counts


MESH_ROOT = os.path.join(REPO, "chip_smoke_out", "mesh_serve")
MESH_WORLD = 2                 # two ranks on cuda:0 over gloo (NCCL refuses two a card)
MESH_BOOT_S = 300              # both ranks booted, the references and warm passes scored
MESH_STATS_S = 0.5             # serve.stats_every_s: the cadence of the launches gather
MESH_GRACE_S = 60.0            # resilience.consensus_grace_s: two ranks share the card
MESH_REFRESH_STEP = 2
MESH_PARTIAL = (1, 100, B)     # request sizes of (a): partial blocks and a full one


def mesh_serve_worker(argv: list[str]) -> int:
    """``--mesh-serve-worker RANK PORT REF_DIR [cli serve arguments]``: one of
    two ranks on cuda:0 over gloo. Before ``cli.main`` it scores the
    service's dataset with ``score_dataset`` on the same two ranks at the same
    batch, for the boot variables and for the refresh step, and writes each
    rank's vectors to ``REF_DIR``: what every served answer is held against."""
    rank, port_no, ref_dir, cli_argv = int(argv[0]), argv[1], argv[2], argv[3:]
    port = load_port()
    from data_diet_distributed_tpu_torch.config import MeshConfig
    from data_diet_distributed_tpu_torch.parallel import mesh
    mesh.initialize_multihost(MeshConfig(multihost=True,
                                         coordinator_address=f"127.0.0.1:{port_no}",
                                         num_processes=MESH_WORLD, process_id=rank),
                              "cuda:0", backend="gloo")
    config = cli_argv[cli_argv.index("--config") + 1]
    cfg = port["load_config"](config, [a for a in cli_argv if "=" in a])
    T = port["train"]
    ds, _ = T["load_data_for"](cfg)
    model = port["create_model_from_cfg"](cfg)
    sets = {"boot": T["score_variables_for_seeds"](cfg, ds, device="cuda:0"),
            "step": [port["CheckpointManager"](cfg.train.checkpoint_dir).restore_variables(
                MESH_REFRESH_STEP, "cuda:0")]}
    for name, variables in sets.items():
        for method in ("el2n", "grand"):
            scores = port["score_dataset"](model, variables, ds, method=method,
                                           batch_size=cfg.score.batch_size, device="cuda:0")
            np.save(os.path.join(ref_dir, f"{name}_{method}_r{rank}.npy"), scores)
    rc = port["data"]["cli"].main([*cli_argv, "--device", "cuda:0"])
    sys.stdout.flush()
    os._exit(rc)


def mesh_serve_phase(torch, port, path, details_out, card: str) -> dict:
    """``cli serve`` as ``MESH_WORLD`` ranks on the card (the service phase's
    model, data, seeds, batch and dtype, both methods warm); gates (a)-(e) of
    the module docstring. Returns the ranks' launches by kernel (each rank a
    new process, read from its stream's last ``metrics`` record). Files in
    ``MESH_ROOT`` (removed after a pass)."""
    import signal
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    os.makedirs(MESH_ROOT)
    rec: dict = {}
    details_out["mesh_serve"] = rec
    K = port["kernels"]
    ds, cfg = path["ds"], path["cfg"]
    pos = {int(i): k for k, i in enumerate(ds.indices)}
    single = {m: path["results"][m]["scores"] for m in ("el2n", "grand")}

    def truth(scores, ids):
        return scores[[pos[int(i)] for i in ids]]

    ckpt = os.path.join(MESH_ROOT, "ckpt")
    port["CheckpointManager"](ckpt).save(MESH_REFRESH_STEP, port["train"][
        "state_from_variables"](port["init_variables"]("resnet18", 5, "cuda"),
                                port["create_model_from_cfg"](cfg)))
    metrics = os.path.join(MESH_ROOT, "metrics.jsonl")
    argv = ["serve", "--config", os.path.join(REPO, "configs", "cifar10_resnet18.yaml"),
            "data.dataset=synthetic", f"data.synthetic_size={N_PATH}",
            "score.pretrain_epochs=0", f"score.seeds={list(SEEDS)}", f"score.batch_size={B}",
            "train.half_precision=true", "serve.port=0", "serve.methods=[el2n,grand]",
            f"serve.stats_every_s={MESH_STATS_S}", f"serve.drain_timeout_s={SERVICE_DRAIN_S}",
            f"resilience.consensus_grace_s={MESH_GRACE_S}", f"obs.metrics_path={metrics}",
            f"train.checkpoint_dir={ckpt}"]
    port_no = free_port()
    ranks = [spawn(["--mesh-serve-worker", str(r), port_no, MESH_ROOT, *argv],
                   f"rank{r}", root=MESH_ROOT) for r in range(MESH_WORLD)]
    try:
        t_boot = time.perf_counter()
        sp = None
        while sp is None:
            check(time.perf_counter() - t_boot < MESH_BOOT_S
                  and all(w["proc"].poll() is None for w in ranks),
                  f"mesh_serve: rank 0 never announced its port "
                  f"({[w['proc'].poll() for w in ranks]})")
            time.sleep(0.2)
            with open(os.path.join(MESH_ROOT, "rank0.log")) as fh:
                sp = next((r["port"] for r in records(fh.read())
                           if r.get("kind") == "obs_server"), None)
        rec["boot_s"] = boot = time.perf_counter() - t_boot
        ref = {}
        for name in ("boot", "step"):
            for m in ("el2n", "grand"):
                got = [np.load(os.path.join(MESH_ROOT, f"{name}_{m}_r{r}.npy"))
                       for r in range(MESH_WORLD)]
                check(all(np.array_equal(got[0], g) for g in got),
                      f"mesh_serve: the ranks' score_dataset vectors differ ({name} {m})")
                ref[name, m] = got[0]
        print(f"  {MESH_WORLD} ranks of cli serve on cuda:0 over gloo answered on port {sp} "
              f"{boot:.1f} s after launch (each rank's score_dataset references and warm "
              f"passes included)", flush=True)

        def score(ids, m):
            code, _, raw = http_call(sp, "/v1/score", {"indices": [int(i) for i in ids],
                                                       "method": m})
            check(code == 200, f"mesh_serve: /v1/score {m}: {code} {raw[:300]}")
            return scores_of(raw)

        # (a) bitwise score_dataset on the same ranks at the same batch.
        rng = np.random.default_rng(17)
        rec["max_abs_vs_single"] = {}
        for m in ("el2n", "grand"):
            worst = 0.0
            for n in MESH_PARTIAL:
                ids = rng.choice(ds.indices, size=n, replace=False)
                got = score(ids, m)
                check(np.array_equal(got, truth(ref["boot", m], ids)),
                      f"(a) {m}: {n} ids not bitwise score_dataset at W = {MESH_WORLD}")
                worst = max(worst, float(np.max(np.abs(got - truth(single[m], ids)))))
            ids = rng.choice(ds.indices, size=100, replace=False)
            code, _, raw = http_call(sp, "/v1/rank", {"indices": ids.tolist(), "method": m})
            s = truth(ref["boot", m], ids)
            order = np.lexsort((ids, -s))
            got = json.loads(raw)
            check(code == 200 and got["indices"] == ids[order].tolist()
                  and np.array_equal(np.asarray(got["scores"], np.float32), s[order]),
                  f"(a) {m}: /v1/rank not bitwise score_dataset's ranking")
            code, _, raw = http_call(sp, f"/v1/topk?k=100&method={m}")
            order = np.lexsort((ds.indices, -ref["boot", m]))[:100]
            items = [json.loads(x) for x in raw.splitlines() if x.strip()]
            check(code == 200 and [i["index"] for i in items] == ds.indices[order].tolist()
                  and np.array_equal(np.asarray([i["score"] for i in items], np.float32),
                                     ref["boot", m][order]),
                  f"(a) {m}: /v1/topk not bitwise score_dataset's")
            rec["max_abs_vs_single"][m] = worst
        print(f"  (a) /v1/score of {list(MESH_PARTIAL)} ids, /v1/rank (100 ids) and "
              f"/v1/topk?k=100 bitwise score_dataset on the same {MESH_WORLD} ranks at "
              f"batch {B}, both methods; largest |difference| from the single process "
              f"{rec['max_abs_vs_single']}", flush=True)

        # (b) each rank's launches for one served dispatch, from /status deltas of
        # the launches gathered at the stats cadence.
        def rank_launches():
            time.sleep(3 * MESH_STATS_S)
            code, _, raw = http_call(sp, "/status")
            check(code == 200, f"mesh_serve: /status {code}")
            body = json.loads(raw)
            check(body.get("world") == MESH_WORLD, f"mesh_serve: /status world {body.get('world')}")
            return body["rank_kernel_launches"]

        rec["per_dispatch"] = {}
        want = {"grand": {"conv_grad_norm_direct": 12 * len(SEEDS),
                          "conv_grad_norm_gram": 3 * len(SEEDS)},
                "el2n": {"el2n": len(SEEDS)}}
        for m in ("grand", "el2n"):
            before = rank_launches()
            score(rng.choice(ds.indices, size=B, replace=False), m)
            after = rank_launches()
            deltas = [{k: a[k] - b.get(k, 0) for k in a if a[k] - b.get(k, 0)}
                      for a, b in zip(after, before)]
            check(deltas == [want[m]] * MESH_WORLD,
                  f"(b) {m}: launches per rank for one {B}-row dispatch {deltas}")
            rec["per_dispatch"][m] = deltas
        print(f"  (b) one {B}-row dispatch launches on each rank: grand "
              f"{rec['per_dispatch']['grand'][0]}, el2n {rec['per_dispatch']['el2n'][0]} "
              f"(the single process's, per rank)", flush=True)

        # (e) latency at the service phase's load.
        import threading
        rec["latency"] = {}
        for m in ("el2n", "grand"):
            ms, bad = [], []

            def client(k: int, m=m, ms=ms, bad=bad) -> None:
                r = np.random.default_rng(400 + k)
                for _ in range(SERVICE_REQUESTS):
                    ids = r.choice(ds.indices, size=int(r.integers(1, SERVICE_MAX_IDS + 1)),
                                   replace=False)
                    t = time.perf_counter()
                    code, _, raw = http_call(sp, "/v1/score", {"indices": ids.tolist(),
                                                               "method": m})
                    ms.append((time.perf_counter() - t) * 1e3)
                    if code != 200 or not np.array_equal(scores_of(raw),
                                                         truth(ref["boot", m], ids)):
                        bad.append((code, ids[:4].tolist()))

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(SERVICE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            check(len(ms) == SERVICE_CLIENTS * SERVICE_REQUESTS and not bad,
                  f"(e) {m}: {len(ms)} answers, {len(bad)} not 200 and bitwise: {bad[:3]}")
            p50, p95 = (float(np.percentile(ms, q)) for q in (50, 95))
            one = details_out.get("service", {}).get("load", {}).get(m, {})
            fl = details_out.get("fleet", {}).get("latency", {}).get(m, {})
            rec["latency"][m] = {"p50_ms": p50, "p95_ms": p95, "n": len(ms),
                                 "single": one, "fleet": fl}
            print(f"  (e) {m}: {SERVICE_CLIENTS} clients x {SERVICE_REQUESTS} requests of "
                  f"1-{SERVICE_MAX_IDS} ids, all bitwise; p50 {p50:.2f} ms, p95 {p95:.2f} ms "
                  f"(single process {one.get('p50_ms', float('nan')):.2f} / "
                  f"{one.get('p95_ms', float('nan')):.2f}, fleet router "
                  f"{fl.get('p50_ms', float('nan')):.2f} / {fl.get('p95_ms', float('nan')):.2f}) "
                  f"on {card}", flush=True)

        # (c) a refresh under a hammer: each answer is the old or the new model's,
        # and after it both ranks answer with the new one.
        hammered, stop = [], threading.Event()

        def hammer() -> None:
            r = np.random.default_rng(500)
            while not stop.is_set():
                ids = r.choice(ds.indices, size=SERVICE_MAX_IDS, replace=False)
                code, _, raw = http_call(sp, "/v1/score", {"indices": ids.tolist(),
                                                           "method": "grand"})
                got = scores_of(raw) if code == 200 else None
                hammered.append(f"status {code}" if got is None
                                else "old" if np.array_equal(got, truth(ref["boot", "grand"],
                                                                        ids))
                                else "new" if np.array_equal(got, truth(ref["step", "grand"],
                                                                        ids))
                                else "mixed")

        th = threading.Thread(target=hammer)
        th.start()
        time.sleep(1.0)
        t = time.perf_counter()
        code, _, raw = http_call(sp, "/v1/refresh", {"step": MESH_REFRESH_STEP})
        rec["refresh_ms"] = 1e3 * (time.perf_counter() - t)
        time.sleep(1.0)
        stop.set()
        th.join(120)
        check(code == 200 and json.loads(raw)["status"] == "installed",
              f"(c) refresh: {code} {raw[:300]}")
        check(set(hammered) == {"old", "new"} and hammered[0] == "old"
              and hammered[-1] == "new",
              f"(c) answers during the refresh: {collections.Counter(hammered)}")
        for m in ("el2n", "grand"):
            ids = rng.choice(ds.indices, size=100, replace=False)
            check(np.array_equal(score(ids, m), truth(ref["step", m], ids)),
                  f"(c) {m} after the refresh: not score_dataset on the step")
            code, _, raw = http_call(sp, f"/v1/topk?k=100&method={m}")
            order = np.lexsort((ds.indices, -ref["step", m]))[:100]
            items = [json.loads(x) for x in raw.splitlines() if x.strip()]
            check(code == 200 and np.array_equal(
                np.asarray([i["score"] for i in items], np.float32), ref["step", m][order]),
                  f"(c) {m}: /v1/topk after the refresh not score_dataset on the step")
        print(f"  (c) refresh to step {MESH_REFRESH_STEP} installed on both ranks in "
              f"{rec['refresh_ms']:.1f} ms under a hammer of {len(hammered)} requests "
              f"({collections.Counter(hammered)}), none mixed; afterwards /v1/score and "
              "/v1/topk bitwise score_dataset on the step", flush=True)

        # (d) SIGTERM to rank 1: both ranks exit 75, rank 0 after its drain.
        ranks[1]["proc"].send_signal(signal.SIGTERM)
        t_term = time.time()
        finish(ranks, timeout=t_term - ranks[0]["t0"] + SERVICE_DRAIN_S
               + SERVICE_EXIT_GRACE_S)
    except BaseException:
        for w in ranks:
            if w["proc"].poll() is None:
                w["proc"].kill()
        raise
    check([w["rc"] for w in ranks] == [75] * MESH_WORLD,
          "(d) " + " | ".join(worker_tail(w) for w in ranks))
    exit_s = [w["t_exit"] - t_term for w in ranks]
    counts = dict.fromkeys(K.KERNELS, 0)
    for r, stream in enumerate([metrics] + [metrics.replace(".jsonl", f".rank{k}.jsonl")
                                            for k in range(1, MESH_WORLD)]):
        n = validate_stream(stream, expect_terminal=True)
        recs = jsonl(stream)
        check(recs[-1]["kind"] == "run_summary" and recs[-1]["exit_class"] == "preempted"
              and any(x["kind"] == "preempted" for x in recs)
              and any(x["kind"] == "obs_server" for x in recs) == (r == 0),
              f"(d) rank {r}'s stream ({n} records) ends {recs[-1]}")
        for k in counts:
            counts[k] += int(summary_gauge(recs, f"kernel_launches:{k}") or 0)
        if r == 0:
            drain = next(x for x in recs if x["kind"] == "preempted")
            check(drain.get("signal") == "peer" and drain.get("drained") is True,
                  f"(d) rank 0's preempted record {drain}")
    rec["exit_after_sigterm_s"] = exit_s
    rec["launches"] = counts
    rec["phase_wall_s"] = wall = time.perf_counter() - t_phase
    print(f"  (d) SIGTERM to rank 1: both ranks exit 75 ({', '.join(f'{x:.1f}' for x in exit_s)}"
          f" s after it; rank 0 drained), both streams valid and ending in run_summary "
          f"preempted; the ranks' launches {counts}; mesh_serve phase: {wall:.1f} s",
          flush=True)
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    return counts


TP_ROOT = os.path.join(REPO, "chip_smoke_out", "tp")
TP_WORLD = 2                   # {data: 1, model: 2}: two ranks on cuda:0 over gloo
TP_N = 1024                    # train examples (CIFAR-100 has 50,000)
TP_TEST = 512                  # test examples
TP_SEEDS = (0, 1, 2)           # config 4's score.seeds
TP_PARITY_N = 384              # (b): three fp32 steps of batch 128, TF32 off
TP_LOGIT_ROWS = 64             # (e): the rows whose logits the ranks and W = 1 compute
TP_LOGIT_RTOL = 1e-5           # (e): of the largest |logit|
TP_TIMEOUT_S = 600             # each worker process


def tp_argv(data_dir: str, ckpt: str, metrics: str, *over) -> list[str]:
    return ["run", "--config", WRN_CONFIG, "data.dataset=npz", f"data.data_dir={data_dir}",
            "score.pretrain_epochs=1", "train.num_epochs=1", f"score.batch_size={B}",
            f"score.seeds=[{','.join(str(s) for s in TP_SEEDS)}]", "prune.sparsity=0.5",
            "obs.xla_introspect=false", f"obs.metrics_path={metrics}",
            f"train.checkpoint_dir={ckpt}", *over]


def tp_worker(argv: list[str]) -> int:
    """``--tp-worker RANK WORLD PORT PORT2 OUT [cli run arguments]``: one rank of
    the tp phase on cuda:0 (over gloo at WORLD > 1, ``mesh.model_axis`` = WORLD,
    joined at PORT, and at PORT2 for the EL2N ``cli score``; WORLD = 1 joins
    nothing and scores nothing more). Writes ``OUT/result_<RANK>.json`` and,
    on rank 0, the fp32 pretrained variables, the bf16 pretrained ones (every
    seed at WORLD > 1, seed 0 at 1), the final state's logits and the run's
    GraNd scores."""
    import torch
    rank, world, port_no, port2, out = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                        argv[4])
    cli_argv = argv[5:]
    check(torch.cuda.is_available(), "CUDA is not available")
    port = load_port()
    from data_diet_distributed_tpu_torch.config import MeshConfig
    from data_diet_distributed_tpu_torch.parallel import mesh
    from data_diet_distributed_tpu_torch.train import loop
    K, T, cli = port["kernels"], port["train"], port["data"]["cli"]
    device = "cuda:0"
    os.makedirs(out, exist_ok=True)

    def join(p: str) -> None:
        if world > 1:
            mesh.initialize_multihost(MeshConfig(
                multihost=True, coordinator_address=f"127.0.0.1:{p}", num_processes=world,
                process_id=rank, model_axis=world), device, backend="gloo")

    join(port_no)
    config = cli_argv[cli_argv.index("--config") + 1]
    over = [a for a in cli_argv if "=" in a]
    result: dict = {"rank": rank, "world": world}
    # (b) fp32, TF32 off: the pretrain of seed 0 on TP_PARITY_N examples.
    port["set_parity_mode"](True)
    cfg32 = port["load_config"](config, [*over, "train.half_precision=false",
                                         "score.seeds=[0]"])
    ds, _ = T["load_data_for"](cfg32)
    (v32,) = T["score_variables_for_seeds"](cfg32, ds.subset(ds.indices[:TP_PARITY_N]),
                                            device=device)
    port["set_parity_mode"](False)
    if rank == 0:
        np.savez(os.path.join(out, "fp32_pretrained.npz"),
                 **{k: v.float().cpu().numpy() for k, v in v32.items()})
    x = torch.from_numpy(np.asarray(ds.images[:TP_LOGIT_ROWS], np.float32)).to(device)
    model32 = port["create_model"](cfg32.model.arch, cfg32.model.num_classes).to(device)

    heads: list = []
    real_fit, real_vars = loop.fit, loop.score_variables_for_seeds

    def recording_fit(*args, **kwargs):
        res = real_fit(*args, **kwargs)
        st = res.state
        heads.append({"tag": kwargs.get("tag"),
                      "weight": list(st.params["classifier.weight"].shape),
                      "bias": list(st.params["classifier.bias"].shape),
                      "momentum": list(st.momentum["classifier.weight"].shape),
                      "trunk": trunk_digest(st)})
        if kwargs.get("tag") == "final":
            # (e): this rank's forward of the final state, the head as it holds it.
            port["set_parity_mode"](True)
            with torch.no_grad():
                logits = torch.func.functional_call(model32.eval(), st.variables, (x,))
            port["set_parity_mode"](False)
            if rank == 0:
                np.savez(os.path.join(out, "final_logits.npz"), x=x.cpu().numpy(),
                         logits=logits.cpu().numpy())
        return res

    def saving_vars(*args, **kwargs):
        got = real_vars(*args, **kwargs)
        for k, v in enumerate(got):
            if rank == 0 and (world > 1 or k == 0):
                torch.save({n: t.float().cpu() for n, t in v.items()},
                           os.path.join(out, f"pretrained_seed{k}.pt"))
        return got

    loop.fit, loop.score_variables_for_seeds = recording_fit, saving_vars
    K.reset_launch_counts()
    modes0 = K.mode_counts()
    t0 = time.perf_counter()
    rc = cli.main([*cli_argv, "--device", device])
    result["run"] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                     "launches": K.launch_counts(), "modes": _mode_delta(K, modes0),
                     "heads": heads}
    loop.fit, loop.score_variables_for_seeds = real_fit, real_vars
    cfg = port["load_config"](config, over)
    ckpt = cfg.train.checkpoint_dir
    if world > 1 and rc == 0:
        if rank == 0:
            shutil.copyfile(T["scores_npz_path"](ckpt), os.path.join(out, "grand_scores.npz"))
        step = port["CheckpointManager"](ckpt).latest_step()
        join(port2)
        score_argv = ["score", *[a for a in cli_argv if a != "run"], "score.method=el2n",
                      f"score.score_ckpt_step={step}"]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc2 = cli.main([*score_argv, "--device", device])
        result["el2n"] = {"rc": rc2, "wall_s": time.perf_counter() - t0, "step": step,
                          "launches": K.launch_counts()}
    with open(os.path.join(out, f"result_{rank}.json"), "w") as fh:
        json.dump(result, fh)
    sys.stdout.flush()
    os._exit(0)


def trunk_digest(state) -> str:
    """sha256 over the params and statistics a model group holds whole (every
    leaf but the head's)."""
    import hashlib
    h = hashlib.sha256()
    for g in ("params", "batch_stats"):
        for k in sorted(getattr(state, g)):
            if not k.startswith("classifier."):
                h.update(k.encode() + getattr(state, g)[k].detach().float().cpu().numpy()
                         .tobytes())
    return h.hexdigest()


def _mode_delta(K, before: dict) -> dict:
    """Launches by kernel and mode since ``before`` (``K.mode_counts()``)."""
    now = K.mode_counts()
    return {k: {m: now[k][m] - before[k].get(m, 0) for m in now[k]} for k in now}


def tp_phase(torch, port, details_out, card: str) -> dict:
    """Config 4's ``cli run`` with ``mesh.model_axis=2`` on the card; gates
    (a)-(e) of the module docstring. Returns the launches of the counted runs
    by kernel (each rank's and the W = 1 run's: each a new process, read by
    it right after). Files in ``TP_ROOT`` (removed after a pass)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()   # the earlier phases' cached blocks: three processes share the card
    shutil.rmtree(TP_ROOT, ignore_errors=True)
    os.makedirs(TP_ROOT)
    rec: dict = {}
    details_out["tp"] = rec
    K, T, gb = port["kernels"], port["train"], port["grand_batched"]
    full = cifar100_dataset(port, TP_N + TP_TEST)
    data_dir = os.path.join(TP_ROOT, "npz")
    os.makedirs(data_dir)
    for split, rows in (("train", slice(0, TP_N)), ("test", slice(TP_N, None))):
        np.savez(os.path.join(data_dir, f"{split}.npz"), images=full.images[rows],
                 labels=full.labels[rows])
    runs = {"tp": os.path.join(TP_ROOT, "tp"), "w1": os.path.join(TP_ROOT, "w1")}
    argv = {name: tp_argv(data_dir, os.path.join(d, "ckpt"), os.path.join(d, "metrics.jsonl"),
                          *(["mesh.model_axis=2", "mesh.data_axis=1"] if name == "tp" else []))
            for name, d in runs.items()}
    ports = (free_port(), free_port())
    workers = [spawn(["--tp-worker", str(r), str(TP_WORLD), *ports, runs["tp"], *argv["tp"]],
                     f"tp_r{r}", root=TP_ROOT) for r in range(TP_WORLD)]
    workers.append(spawn(["--tp-worker", "0", "1", "-", "-", runs["w1"], *argv["w1"]],
                         "w1", root=TP_ROOT))
    # Meanwhile: the GraNd route of one rank's 256 rows (seed 0 at init, bf16).
    cfg = port["load_config"](WRN_CONFIG, [f"model.num_classes={R50_CLASSES}"])
    model16 = port["create_model_from_cfg"](cfg).to("cuda")
    rows_rank = B // TP_WORLD
    first = next(port["data"]["iterate_batches"](full, rows_rank))
    batch = [torch.from_numpy(first[k]).cuda() for k in ("image", "label", "mask")]
    route_log: list = []
    gb.batched_grand_scores(model16, port["init_variables"](cfg.model.arch, 0, "cuda",
                                                            num_classes=R50_CLASSES),
                            *batch, use_kernels=True, route_log=route_log)
    routes = collections.Counter(r for _, r in route_log)
    per_batch = {"conv_grad_norm_direct": routes["v1"] + routes["v2"],
                 "conv_grad_norm_gram": routes["gram"]}
    finish(workers, timeout=TP_TIMEOUT_S)
    for w in workers:
        check(w["rc"] == 0, f"tp: a worker failed: {worker_tail(w)}")
    res = {name: [] for name in runs}
    for r in range(TP_WORLD):
        with open(os.path.join(runs["tp"], f"result_{r}.json")) as fh:
            res["tp"].append(json.load(fh))
    with open(os.path.join(runs["w1"], "result_0.json")) as fh:
        res["w1"].append(json.load(fh))
    for name, rs in res.items():
        for r in rs:
            check(r["run"]["rc"] == 0, f"tp: {name} rank {r['rank']}: cli run exit "
                                       f"{r['run']['rc']}")
    for r in res["tp"]:
        check(r["el2n"]["rc"] == 0, f"tp: rank {r['rank']}: cli score exit {r['el2n']['rc']}")

    # (a) each rank holds its 50 rows of the head through the pretrain and the retrain.
    classes = R50_CLASSES // TP_WORLD
    for r in res["tp"]:
        tags = [h["tag"] for h in r["run"]["heads"]]
        check(tags == [f"score_pretrain_seed{s}" for s in TP_SEEDS] + ["final"],
              f"(a) rank {r['rank']}: fits {tags}")
        for h in r["run"]["heads"]:
            check(h["weight"] == [classes, 640] and h["bias"] == [classes]
                  and h["momentum"] == [classes, 640],
                  f"(a) rank {r['rank']} {h['tag']}: head {h}")
    digests = [[h["trunk"] for h in r["run"]["heads"]] for r in res["tp"]]
    check(all(len(set(d)) == 1 for d in zip(*digests)),
          "(a) the ranks' trunks differ after a fit")
    print(f"  (a) both ranks of {{data: 1, model: {TP_WORLD}}} end each of "
          f"{len(TP_SEEDS)} pretrain fits and the retrain holding classifier.weight "
          f"[{classes}, 640], bias [{classes}] and their momentum, and the same trunk "
          f"(params and statistics bitwise)", flush=True)

    # (b) the fp32 pretrained variables against W = 1; the bf16 ones reported.
    with np.load(os.path.join(runs["tp"], "fp32_pretrained.npz")) as a, \
            np.load(os.path.join(runs["w1"], "fp32_pretrained.npz")) as b:
        worst = max(float(np.max(np.abs(a[k] - b[k]) - (1e-6 + 1e-4 * np.abs(b[k]))))
                    for k in b.files)
        gap32 = max(float(np.max(np.abs(a[k] - b[k]))) for k in b.files)
    load = lambda name: torch.load(os.path.join(runs[name], "pretrained_seed0.pt"))
    a16, b16 = load("tp"), load("w1")
    gaps16 = {k: float((a16[k] - b16[k]).abs().max() / max(float(b16[k].abs().max()), 1e-30))
              for k in b16}
    worst16 = max(gaps16, key=gaps16.get)
    gap16 = gaps16[worst16]
    del a16, b16
    rec["pretrained"] = {"fp32_max_abs": gap32, "bf16_max_rel": gap16,
                         "bf16_worst_tensor": worst16}
    print(f"  (b) fp32 pretrain ({TP_PARITY_N} examples, 3 steps, TF32 off): largest "
          f"|difference| from W = 1 {gap32:.3e} (rtol 1e-4, atol 1e-6); bf16 pretrain of "
          f"seed 0 ({TP_N} examples): largest difference {gap16:.3e} of a tensor's "
          f"largest magnitude, in {worst16} (not held)", flush=True)
    check(worst <= 0, f"(b) fp32 pretrained variables differ from W = 1 by {gap32:.3e}")

    # (c) the run's scores against score_dataset at W = 1 on the same variables.
    cfg_run = port["load_config"](WRN_CONFIG, [a for a in argv["tp"] if "=" in a])
    train_ds, _ = T["load_data_for"](cfg_run)
    model = port["create_model_from_cfg"](cfg_run)
    kw = dict(batch_size=B, chunk=cfg_run.score.grand_chunk, eval_mode=cfg_run.score.eval_mode,
              use_kernels=cfg_run.score.use_pallas, device="cuda")
    rec["scores"] = {}
    pre = [torch.load(os.path.join(runs["tp"], f"pretrained_seed{k}.pt"))
           for k in range(len(TP_SEEDS))]
    step = res["tp"][0]["el2n"]["step"]
    final = port["CheckpointManager"](cfg_run.train.checkpoint_dir).restore_variables(
        step, "cuda")
    with np.load(os.path.join(runs["tp"], "grand_scores.npz")) as f:
        grand = f["scores"]
    with np.load(T["scores_npz_path"](cfg_run.train.checkpoint_dir)) as f:
        el2n = f["scores"]
    for method, got, variables, rtol, atol in (("grand", grand, pre, 1e-4, 1e-5),
                                               ("el2n", el2n, [final], 1e-5, 1e-6)):
        # Held at the rank's batch, as the dist phase's (c): in bf16 a WRN's
        # scores move with the batch's geometry (cuDNN's algorithms), not its rank.
        want = port["score_dataset"](model, variables, train_ds, method=method,
                                     **{**kw, "batch_size": rows_rank})
        at512 = float(np.abs(got - port["score_dataset"](model, variables, train_ds,
                                                         method=method, **kw)).max())
        err = np.abs(got - want)
        ok = bool(np.all(err <= atol + rtol * np.abs(want)))
        rec["scores"][method] = {"max_abs": float(err.max()), "max_abs_vs_512": at512,
                                 "bitwise": bool(np.array_equal(got, want)),
                                 "mean": float(want.mean())}
        print(f"  (c) {method}: the ranks' flat pass ({rows_rank} rows a rank) against W = 1 "
              f"at batch {rows_rank} on the same variables: largest |difference| "
              f"{float(err.max()):.3e} (rtol {rtol} + {atol}), bitwise "
              f"{rec['scores'][method]['bitwise']}; against W = 1 at {B}: {at512:.3e} "
              f"(mean score {float(want.mean()):.4f})", flush=True)
        check(got.shape == (TP_N,) and bool(np.isfinite(got).all()) and ok,
              f"(c) {method}: scores {float(err.max()):.3e} from W = 1")
    del pre

    # (d) each rank's launches on the scoring passes.
    nb = TP_N // B
    want_g = {k: nb * len(TP_SEEDS) * per_batch.get(k, 0) for k in K.KERNELS}
    want_e = {k: (nb if k == "el2n" else 0) for k in K.KERNELS}
    counts = dict.fromkeys(K.KERNELS, 0)
    for r in res["tp"]:
        check(r["run"]["launches"] == want_g,
              f"(d) rank {r['rank']}: GraNd launches {r['run']['launches']}, want {want_g}")
        for kern in per_batch:
            modes = r["run"]["modes"][kern]
            check(modes.get("tensor_core", 0) == want_g[kern]
                  and sum(modes.values()) == want_g[kern],
                  f"(d) rank {r['rank']}: {kern} modes {modes}")
        check(r["el2n"]["launches"] == want_e,
              f"(d) rank {r['rank']}: EL2N launches {r['el2n']['launches']}, want {want_e}")
    for r in res["tp"] + res["w1"]:
        for part in ("run", "el2n"):
            for k, n in r.get(part, {}).get("launches", {}).items():
                counts[k] += n
    rec["launches_per_rank"] = {"grand": want_g, "el2n": want_e, "route": dict(routes)}
    print(f"  (d) each rank: GraNd {nb} batches x {len(TP_SEEDS)} seeds x {per_batch} "
          f"(route of {rows_rank} rows: {dict(routes)}), tensor-core; EL2N {nb} launches",
          flush=True)

    # (e) the final checkpoint at W = 1 against the ranks' split-head logits.
    with np.load(os.path.join(runs["tp"], "final_logits.npz")) as f:
        x, split_logits = torch.from_numpy(f["x"]).cuda(), f["logits"]
    model32 = port["create_model"](cfg_run.model.arch, R50_CLASSES).to("cuda").eval()
    port["set_parity_mode"](True)
    with torch.no_grad():
        whole = torch.func.functional_call(model32, final, (x,)).cpu().numpy()
    port["set_parity_mode"](False)
    gap = float(np.max(np.abs(whole - split_logits)) / np.max(np.abs(split_logits)))
    rec["final_logits_rel"] = gap
    print(f"  (e) final checkpoint (step {step}) restored at W = 1: fp32 logits of "
          f"{TP_LOGIT_ROWS} rows within {gap:.3e} of the largest |logit| of the ranks' "
          f"split head (limit {TP_LOGIT_RTOL}); head {list(final['classifier.weight'].shape)}",
          flush=True)
    check(tuple(final["classifier.weight"].shape) == (R50_CLASSES, 640)
          and gap <= TP_LOGIT_RTOL, f"(e) restored logits {gap:.3e} from the ranks'")

    # Walls.
    rec["walls"] = {}
    for name, d in runs.items():
        recs = jsonl(os.path.join(d, "metrics.jsonl"))
        summ = next(r for r in recs if r["kind"] == "summary")
        epochs = [(e["tag"], e["examples_per_s"]) for e in recs if e["kind"] == "epoch"]
        wall = res[name][0]["run"]["wall_s"]
        rec["walls"][name] = {"run_wall_s": wall, "epochs": epochs,
                              **{k: summ[k] for k in ("pretrain_wall_s", "score_wall_s",
                                                      "train_wall_s", "n_kept")}}
        print(f"  {name}: cli run in {wall:.1f} s (three processes on the card at once): "
              f"pretrain {summ['pretrain_wall_s']:.1f} s, score {summ['score_wall_s']:.1f} s, "
              f"retrain {summ['train_wall_s']:.1f} s, n_kept {summ['n_kept']}; epochs "
              f"{[(t, round(e, 1)) for t, e in epochs]} ex/s on {card}", flush=True)
        check(summ["n_kept"] == TP_N // 2, f"tp {name}: n_kept {summ['n_kept']}")
    shutil.rmtree(TP_ROOT, ignore_errors=True)
    rec["phase_wall_s"] = wall = time.perf_counter() - t_phase
    print(f"  tp phase: {wall:.1f} s", flush=True)
    return counts


# ------------------------------------------------------------ tune, duty phases

TUNE_ROOT = os.path.join(REPO, "chip_smoke_out", "tune")
TUNE_N = 2048                  # the measure children's examples (x 2 seeds, batch B)
TUNE_COMBOS = ("baseline", "bn_kernel")
TUNE_TIMEOUT_S = 400           # the tuner and its children, and (e)'s cli score
TUNE_K_LONG = 16               # (f): the difference quotient's long chunk
TUNE_EVENTS = ["search_start", "measured", "measured", "verified", "winner",
               "manifest_written"]
DUTY_IDLE_S, DUTY_BUSY_S = 3.0, 6.0


def tune_phase(torch, port, routes: dict, card: str) -> dict:
    """The port's tuner on the card: ``python -m
    data_diet_distributed_tpu_torch.tools.autotune`` over ``TUNE_COMBOS``
    (ResNet-18, ``TUNE_N`` x 2 seeds at batch ``B``, 2 timed passes a child, no
    confirmation), its files in ``chip_smoke_out/tune/``: (a) exit 0; (b) the
    events ``TUNE_EVENTS``, both values > 0, no ``disqualified``; (c) the
    manifest reads back, matches this card (backend ``cuda``, the card's name,
    one device) and the geometry, pins all seven ``DDT_GRAND_*`` toggles, and
    its winner's exactness entry is ``ok``; (d) the ``bn_kernel`` child
    launched ``bn_grad_norm`` and ``baseline`` did not, both the direct kernel
    (launches a batch from the ledger, beside the routes phase's); (e) ``cli
    score`` on the geometry with ``tuning.apply=strict`` logs ``tuning_applied``
    with the winner's combo and launches the winner's route; (f)
    ``profile_dispatch`` in this process, beside (e)'s, for the score and the
    train chunk at batch ``B`` and K = ``TUNE_K_LONG``: every figure finite, a
    step > 0 ms."""
    tools, tuning = port["tools"], port["tuning"]
    shutil.rmtree(TUNE_ROOT, ignore_errors=True)
    os.makedirs(TUNE_ROOT)
    t_phase = time.perf_counter()
    out, events, ledger = (os.path.join(TUNE_ROOT, f) for f in
                           ("tuning_manifest.json", "events.jsonl", "ledger.jsonl"))
    cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.tools.autotune",
           "--task", "score", "--method", "grand", "--arch", "resnet18",
           "--combos", ",".join(TUNE_COMBOS),
           "--size", str(TUNE_N), "--batch", str(B), "--repeats", "2", "--no-confirm",
           "--out", out, "--events", events, "--ledger", ledger, "--device", "cuda"]
    proc = subprocess.run(cmd, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=TUNE_TIMEOUT_S)
    tune_s = time.perf_counter() - t_phase
    check(proc.returncode == 0, f"(a) the tuner exited {proc.returncode}: "
                                f"{(proc.stdout + proc.stderr)[-3000:]}")
    evs = jsonl(events)
    names = [e["event"] for e in evs]
    measured = {e["combo"]: e["value"] for e in evs if e["event"] == "measured"}
    check(names == TUNE_EVENTS and sorted(measured) == sorted(TUNE_COMBOS)
          and all((v or 0) > 0 for v in measured.values()),
          f"(b) the tuner's events {names}: {evs}")
    winner = evs[names.index("winner")]["combo"]
    print(f"  (a)-(b) tuner exit 0 in {tune_s:.1f} s: events {names}; "
          + ", ".join(f"{c} {v:.1f} ex/s" for c, v in measured.items())
          + f" ({TUNE_N} x 2 seeds, batch {B}, median of 2 passes) on {card}; "
          f"winner {winner}", flush=True)
    manifest = tuning.read_tuning_manifest(out)
    cfg = port["load_config"](None, ["model.arch=resnet18", "data.dataset=synthetic",
                                     f"score.batch_size={B}"])
    ok, reason = tuning.match_manifest(manifest, cfg, backend="cuda",
                                       device_kind=torch.cuda.get_device_name(0))
    gates = sorted(k for k in manifest["env"] if k.startswith("DDT_GRAND_"))
    [exact] = [e for e in manifest["exactness"] if e["combo"] == winner]
    check(ok and manifest["n_devices"] == 1 and len(gates) == 7
          and manifest["chosen_combo"] == winner and exact["ok"] is True
          and manifest["source"] == "data_diet_distributed_tpu_torch/tools/autotune.py",
          f"(c) manifest: {reason}; {manifest}")
    print(f"  (c) manifest {manifest['digest'][:12]}: backend {manifest['backend']}, "
          f"{manifest['device_kind']}, {manifest['n_devices']} device, matches this card and "
          f"the geometry; pins {len(gates)} DDT_GRAND_* toggles; {winner} against "
          f"grand_vmap (fp32, TF32 off): max abs err {exact['max_abs_err']:.3e}, max rel "
          f"err {exact['max_rel_err']:.3e} (rtol {exact['rtol']}, atol {exact['atol']})",
          flush=True)
    per_batch = {r["autotune"]["combo"]: r["launches_per_batch"]
                 for r in tools["perf_sentry"].load_ledger(ledger) if r.get("autotune")}
    base, bnk = per_batch["baseline"], per_batch["bn_kernel"]
    check(bnk["bn_grad_norm"] > 0 and base["bn_grad_norm"] == 0
          and bnk["conv_grad_norm_direct"] > 0 and base["conv_grad_norm_direct"] > 0,
          f"(d) launches a batch: {per_batch}")
    runs = ROUTE_N // B * len(SEEDS)
    route_counts = {name: {k: n // runs for k, n in routes["results"][name]["launches"].items()}
                    for name in ("grand", "BN_KERNEL")}
    print(f"  (d) launches a batch a seed: baseline {({k: v for k, v in base.items() if v})}, "
          f"bn_kernel {({k: v for k, v in bnk.items() if v})}; the routes phase's default "
          f"route {route_counts['grand']}, BN_KERNEL {route_counts['BN_KERNEL']} (the "
          "combos pin STEM_XLA off: the 3-channel stem on the direct kernel)", flush=True)

    # (e)'s process starts while (f) times the chunks in this process.
    d = os.path.join(TUNE_ROOT, "cli")
    cp = CliProcess(["score", "--device", "cuda", "data.dataset=synthetic",
                     f"data.synthetic_size={TUNE_N}", "model.arch=resnet18",
                     f"score.batch_size={B}", "score.method=grand", "score.pretrain_epochs=0",
                     "score.seeds=[0]", f"tuning.manifest={out}", "tuning.apply=strict",
                     f"train.checkpoint_dir={d}/ckpt", *OBS_OFF[1:],
                     f"obs.metrics_path={d}/m.jsonl"])
    prof = {}
    for task in ("score", "train"):
        r = tools["profile_dispatch"].main(["--task", task, "--arch", "resnet18",
                                            "--batch", str(B), "--k-long", str(TUNE_K_LONG),
                                            "--device", "cuda"])
        figures = (r["t1"], r["tl"], r["t_step"], r["overhead"])
        check(all(np.isfinite(figures)) and r["t_step"] > 0, f"(f) {task}: {r}")
        prof[task] = r
        print(f"  (f) {task} chunk at batch {B} (beside (e)'s cli score): t(1) "
              f"{1e3 * r['t1']:.3f} ms, t({TUNE_K_LONG}) {1e3 * r['tl']:.3f} ms, "
              f"{1e3 * r['t_step']:.3f} ms a step, overhead {1e3 * r['overhead']:.3f} ms, "
              f"recommended K {r['recommended']} on {card}", flush=True)

    rc, _, cli_s = cp.wait(TUNE_TIMEOUT_S)
    recs = jsonl(f"{d}/m.jsonl")
    applied = [r for r in recs if r["kind"] == "tuning_applied"]
    bn = int(summary_gauge(recs, "kernel_launches:bn_grad_norm") or 0)
    direct = int(summary_gauge(recs, "kernel_launches:conv_grad_norm_direct") or 0)
    check(rc == 0 and len(applied) == 1 and applied[0]["applied"] is True
          and applied[0]["chosen_combo"] == winner and direct > 0
          and (bn > 0) == (manifest["env"]["DDT_GRAND_BN_KERNEL"] == "1"),
          f"(e) cli score exit {rc}, tuning_applied {applied}, launches direct {direct} "
          f"bn {bn}: {''.join(cp.tail)[-2000:]}")
    print(f"  (e) cli score with tuning.apply=strict: exit 0 in {cli_s:.1f} s, tuning_applied "
          f"{winner} (knobs {len(applied[0]['knobs'])}), its scoring pass launched direct "
          f"{direct}, bn_grad_norm {bn}", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"  tune phase {wall:.1f} s", flush=True)
    shutil.rmtree(TUNE_ROOT, ignore_errors=True)
    return {"measured": measured, "winner": winner, "exactness": exact,
            "launches_per_batch": per_batch, "profile": prof, "cli_s": cli_s,
            "tune_s": tune_s, "wall_s": wall}


def duty_phase(port, card: str) -> dict:
    """``validate_duty`` in this process: ``DUTY_IDLE_S`` idle, ``DUTY_BUSY_S``
    of chained bf16 matmuls, ``DUTY_IDLE_S`` idle, the monitor sampling; gate:
    samples taken, and the busy phase's duty above both idle phases'."""
    r = port["tools"]["validate_duty"].main([
        "--idle-s", str(DUTY_IDLE_S), "--busy-s", str(DUTY_BUSY_S), "--device", "cuda"])
    idle = [r["duty_idle_pre"], r["duty_idle_post"]]
    check(r["n_samples"] > 0 and r["duty_busy"] is not None and None not in idle
          and r["duty_busy"] > max(idle), f"duty: {r}")
    print(f"  duty: idle {r['duty_idle_pre']}, busy {r['duty_busy']}, idle "
          f"{r['duty_idle_post']} ({r['n_samples']} samples; a block of matmuls "
          f"{r['block_ms']} ms, {r['blocks_per_enqueue']} an enqueue) on {card}", flush=True)
    return r


# -------------------------------------------------------- demo and soak phases

DEMO_ROOT = os.path.join(REPO, "chip_smoke_out", "demo")
DEMO_N = 2048                  # synthetic examples (the card's demo runs 50,000)
DEMO_B = 256                   # the demo's batch
DEMO_EPOCHS = 2                # retrain epochs (the card's demo runs 30)
DEMO_SPARSITY = 0.5
DEMO_TIMEOUT_S = 400
SOAK_ROOT = os.path.join(REPO, "chip_smoke_out", "soak")
SOAK_FAULTS = ["sigterm", "nan", "kill"]   # the tool's SMOKE_SCHEDULE
SOAK_TIMEOUT_S = 400


class ToolProcess:
    """``python -m data_diet_distributed_tpu_torch.tools.<name>`` (or
    ``command``) as a subprocess of the repo root in a session of its own
    (``stop`` ends its children too), its output in ``log``."""

    def __init__(self, name: str, args: list[str], log: str,
                 command: list[str] | None = None):
        self.name, self.log = name, log
        self.since = len(_PHASES)
        self.t0 = time.perf_counter()
        self.fh = open(log, "w")
        command = command or [sys.executable, "-m",
                              f"data_diet_distributed_tpu_torch.tools.{name}"]
        self.proc = subprocess.Popen(
            [*command, *args], cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
            stdout=self.fh, stderr=subprocess.STDOUT, start_new_session=True)

    def beside(self) -> list[str]:
        """The phases that ran while this tool did: those begun after its
        start, up to the one judging it."""
        return _PHASES[self.since:-1]

    def stop(self) -> None:
        """Ends the tool and whatever of its session is left (a child that
        outlived it included)."""
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        self.fh.close()

    def wait(self, timeout: float) -> dict:
        """The tool's last JSON line; fails unless it exits 0 within
        ``timeout`` of this call."""
        text = self.wait_text(timeout)
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        check(bool(lines), f"{self.name}: no JSON line: {text[-3000:]}")
        return json.loads(lines[-1])

    def wait_text(self, timeout: float) -> str:
        """The tool's output; fails unless it exits 0 within ``timeout`` of
        this call. ``wall_s`` is then its wall from start to exit."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        self.wall_s = time.perf_counter() - self.t0
        self.stop()
        with open(self.log, errors="replace") as fh:
            text = fh.read()
        check(rc == 0, f"{self.name}: exit {rc}: {text[-3000:]}")
        return text


def start_soak() -> ToolProcess:
    """The smoke soak on the card, started before the data phase so it runs
    beside the data, wrn and tp phases; ``soak_phase`` judges it. Files in
    ``SOAK_ROOT``."""
    shutil.rmtree(SOAK_ROOT, ignore_errors=True)
    os.makedirs(SOAK_ROOT)
    return ToolProcess("imagenet_soak", [
        "--smoke", "--device", "cuda", "--workdir", os.path.join(SOAK_ROOT, "wd"),
        "--quiet"], os.path.join(SOAK_ROOT, "soak.log"))


def start_demo() -> ToolProcess:
    """The prune demo on the card, started with the soak; ``demo_phase``
    judges it. Files in ``DEMO_ROOT``."""
    shutil.rmtree(DEMO_ROOT, ignore_errors=True)
    os.makedirs(DEMO_ROOT)
    return ToolProcess("e2e_demo", [
        "--device", "cuda", "--arch", "resnet18", "--half-precision",
        "--size", str(DEMO_N), "--batch", str(DEMO_B), "--epochs", str(DEMO_EPOCHS),
        "--pretrain-epochs", "1", "--sparsities", str(DEMO_SPARSITY),
        "--score-method", "el2n", "--workdir", os.path.join(DEMO_ROOT, "wd"),
        "--out", os.path.join(DEMO_ROOT, "out")], os.path.join(DEMO_ROOT, "demo.log"))


def demo_phase(port, demo: ToolProcess, card: str) -> dict:
    """Waits for the prune demo ``start_demo`` began and judges it; see the
    module docstring. Returns its launches by kernel. Files in ``DEMO_ROOT``
    (removed after a pass)."""
    headline = demo.wait(DEMO_TIMEOUT_S)
    wd = os.path.join(DEMO_ROOT, "wd")
    # Three rows, half of DEMO_N kept by both policies, the random sweep on
    # the hardest sweep's scores, the JAX tool's headline keys.
    mid = f"{DEMO_SPARSITY}"
    check(set(headline) == {"dense_accuracy", f"hardest@{mid}", f"random@{mid}",
                            "hardest_beats_random_at_mid", "summary", "plot",
                            "total_wall_s"}, f"demo headline {headline}")
    with open(headline["summary"]) as fh:
        config, *rows = [json.loads(line) for line in fh]
    by = {r["keep"]: r for r in rows}
    check(config["kind"] == "config" and [r["keep"] for r in rows]
          == ["dense", "hardest", "random"], f"demo rows {rows}")
    check(by["hardest"]["n_kept"] == by["random"]["n_kept"] == DEMO_N // 2
          and by["hardest"]["score_method"] == "el2n"
          and by["random"]["score_method"].startswith("reused:")
          and all(0.0 <= r["final_test_accuracy"] <= 1.0 for r in rows),
          f"demo rows {rows}")
    launches = {}
    for leg in ("dense", "hard", "rand"):
        with open(os.path.join(wd, f"metrics_{leg}.jsonl")) as fh:
            snaps = [r for r in records(fh.read()) if r["kind"] == "metrics"]
        launches[leg] = {k[len("kernel_launches:"):]: int(v)
                         for k, v in snaps[-1]["gauges"].items()
                         if k.startswith("kernel_launches:")}
    # One EL2N launch a batch of the hardest sweep's one scoring pass; the
    # dense fit and the random sweep (its scores reused) launch none.
    check(launches == {"dense": {}, "hard": {"el2n": DEMO_N // DEMO_B}, "rand": {}},
          f"demo launches {launches}")
    print(f"  demo (ResNet-18, {DEMO_N} examples, {DEMO_EPOCHS} epochs, EL2N, sparsity "
          f"{DEMO_SPARSITY}): exit 0, total_wall_s {headline['total_wall_s']} (beside the "
          f"data, wrn and tp phases); dense "
          f"{by['dense']['final_test_accuracy']:.4f}, hardest "
          f"{by['hardest']['final_test_accuracy']:.4f}, random "
          f"{by['random']['final_test_accuracy']:.4f} ({by['random']['score_method']}); "
          f"launches {launches} on {card}", flush=True)
    shutil.rmtree(DEMO_ROOT, ignore_errors=True)
    return {k: sum(c.get(k, 0) for c in launches.values()) for k in port["kernels"].KERNELS}


def soak_phase(soak: ToolProcess, card: str) -> dict:
    """Waits for the smoke soak ``start_soak`` began and judges it: every
    cycle recovered, every monitor and post-mortem verdict 0. Returns its
    report."""
    report = soak.wait(SOAK_TIMEOUT_S)
    cycles = report["per_cycle"]
    check(report["ok"] is True and report["faults"] == SOAK_FAULTS
          and report["recovered"] == len(SOAK_FAULTS)
          and report["monitor_exits"] == [0] * len(SOAK_FAULTS)
          and report["postmortem_exits"] == [0] * len(SOAK_FAULTS)
          and all(c["exit_class"] == "ok" and c["slo"] and c["slo"]["ok"]
                  and c["stream_problems"] == [] for c in cycles)
          and cycles[SOAK_FAULTS.index("kill")]["attempts"] >= 2,
          f"soak report {json.dumps(report)[:3000]}")
    print(f"  soak --smoke {report['faults']}: exit 0, wall_s {report['wall_s']} (beside "
          f"the data, wrn and tp phases and the demo), "
          f"recovered {report['recovered']}/{report['cycles']}, monitor exits "
          f"{report['monitor_exits']}, post-mortem exits {report['postmortem_exits']}, "
          f"cycle walls {report['recovery_wall_s']} s, attempts "
          f"{[c['attempts'] for c in cycles]} on {card}", flush=True)
    shutil.rmtree(SOAK_ROOT, ignore_errors=True)
    return {k: v for k, v in report.items() if k != "per_cycle"}


# ------------------------------------------------ serve soak and walkthrough

SERVE_SOAK_ROOT = os.path.join(REPO, "chip_smoke_out", "serve_soak")
# The cycles of the tool's schedule that no other phase drives: the partition
# quarantine over the remote backend, the autoscaler, a wedge inside a fleet.
SERVE_SOAK_FAULTS = ["partition", "autoscale", "wedge"]
# Load seconds a cycle (the tool's default is 6): each fresh replica's first
# call takes 2-5 s on the card, and the autoscaler grows only after two 1-s
# ticks under pressure, which a 6-s window left out in one of three card runs.
SERVE_SOAK_LOAD_S = 12
SERVE_SOAK_TIMEOUT_S = 600
WALK_ROOT = os.path.join(REPO, "chip_smoke_out", "walkthrough")
WALK_N = 4096                  # synthetic examples (the card's walkthrough runs 50,000)
WALK_B = 256                   # the walkthrough's scoring batch
WALK_TIMEOUT_S = 400
# Each walkthrough cell's printed line, in order.
WALK_PRINTS = ["device=", "pretrain: ", "EL2N: ", "GraNd: ", "spearman(EL2N, GraNd) = ",
               "kept ", "retrain on 50%: ", "forgetting: ", "aum: "]


def start_serve_soak() -> ToolProcess:
    """The serve soak's ``SERVE_SOAK_FAULTS`` cycles on the card (ResNet-18,
    GraNd, two replicas); ``serve_soak_phase`` judges it. Files in
    ``SERVE_SOAK_ROOT``."""
    shutil.rmtree(SERVE_SOAK_ROOT, ignore_errors=True)
    os.makedirs(SERVE_SOAK_ROOT)
    return ToolProcess("serve_soak", [
        "--device", "cuda", "--arch", "resnet18", "--method", "grand",
        "--schedule", ",".join(SERVE_SOAK_FAULTS), "--duration", str(SERVE_SOAK_LOAD_S),
        "--workdir", os.path.join(SERVE_SOAK_ROOT, "wd"), "--quiet"],
        os.path.join(SERVE_SOAK_ROOT, "serve_soak.log"))


def start_walkthrough() -> ToolProcess:
    """The walkthrough on the card (ResNet-18, ``WALK_N`` examples) in a
    worker process of this script (``--walkthrough-worker``), which reports
    its launches; ``walkthrough_phase`` judges it. Its log in ``WALK_ROOT``."""
    shutil.rmtree(WALK_ROOT, ignore_errors=True)
    os.makedirs(WALK_ROOT)
    return ToolProcess("walkthrough", [
        "--device", "cuda", "--arch", "resnet18", "--size", str(WALK_N)],
        os.path.join(WALK_ROOT, "walkthrough.log"),
        command=[sys.executable, os.path.join(REPO, "chip_smoke.py"), "--walkthrough-worker"])


def walkthrough_worker(argv: list[str]) -> int:
    """``python -m data_diet_distributed_tpu_torch.examples.walkthrough
    <argv>`` in this process (``runpy``, as ``-m`` runs it), then one JSON
    line: its launches by kernel and by mode, counted from 0."""
    import runpy

    from data_diet_distributed_tpu_torch.ops import kernels as K
    sys.argv = ["walkthrough", *argv]
    K.reset_launch_counts()
    runpy.run_module("data_diet_distributed_tpu_torch.examples.walkthrough",
                     run_name="__main__")
    print(json.dumps({"launches": K.launch_counts(), "modes": K.mode_counts()}), flush=True)
    return 0


def _floats(line: str) -> list[float]:
    import re
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", line)]


def walkthrough_phase(port, walk: ToolProcess, card: str) -> dict:
    """Waits for the walkthrough ``start_walkthrough`` began and judges it:
    exit 0, every cell's line in order, finite scores, half the set kept, an
    accuracy in [0, 1], and exactly the EL2N and GraNd cells' launches (one
    EL2N, 12 direct and 3 Gram a batch of ``WALK_B``, fp32: the walkthrough
    trains and scores in fp32). Returns its launches by kernel."""
    text = walk.wait_text(WALK_TIMEOUT_S)
    lines = [ln for ln in text.splitlines() if ln.startswith(tuple(WALK_PRINTS))]
    check([next(p for p in WALK_PRINTS if ln.startswith(p)) for ln in lines] == WALK_PRINTS,
          f"walkthrough: the cells' lines {lines}: {text[-3000:]}")
    check(lines[0] == f"device=cuda  train={WALK_N} examples"
          and lines[5] == f"kept {WALK_N // 2}/{WALK_N} hardest examples",
          f"walkthrough: {lines[0]!r}, {lines[5]!r}")
    for ln in lines[2:5] + lines[6:]:
        check(bool(_floats(ln)) and all(np.isfinite(_floats(ln))), f"walkthrough: {ln!r}")
    check(0.0 <= _floats(lines[6])[-1] <= 1.0, f"walkthrough: {lines[6]!r}")
    out = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
    nb = -(-WALK_N // WALK_B)
    want = {"el2n": nb, "conv_grad_norm_direct": 12 * nb, "conv_grad_norm_gram": 3 * nb}
    launches = out["launches"]
    check({k: v for k, v in launches.items() if v} == want
          and all(out["modes"][k].get("fp32") == want[k]
                  for k in ("conv_grad_norm_direct", "conv_grad_norm_gram")),
          f"walkthrough launches {launches}, modes {out['modes']}, want {want}")
    print(f"  walkthrough (ResNet-18, {WALK_N} examples, fp32): exit 0 in "
          f"{walk.wall_s:.1f} s beside {walk.beside()}; "
          + "; ".join(lines[1:]).replace("pretrain: ", "pretrain ")[:900]
          + f"; launches {want} (fp32) on {card}", flush=True)
    shutil.rmtree(WALK_ROOT, ignore_errors=True)
    return {k: launches.get(k, 0) for k in port["kernels"].KERNELS}


def _at(cycle: dict, what: str, field: str = "t_s"):
    """A field of the first row of a cycle's timeline named ``what`` (a
    prefix for ``slo_violation:``), else None."""
    row = next((r for r in cycle["timeline"] if r["what"] == what
                or (what.endswith(":") and r["what"].startswith(what))), None)
    return None if row is None else row.get(field)


def _span(cycle: dict, a: str, b: str):
    ta, tb = _at(cycle, a), _at(cycle, b)
    return None if ta is None or tb is None else round(tb - ta, 3)


def serve_soak_phase(port, soak: ToolProcess, card: str) -> dict:
    """Waits for the serve soak ``start_serve_soak`` began and judges it as
    ``soak_phase`` does: exit 0, every cycle passed (the tool's forensics,
    stream validation and request attribution), the monitor exits the tool
    allows, zero client-visible failures; and in every cycle the replicas
    launched the direct and Gram kernels. The partition cycle's replicas were
    placed through the remote backend (no card placement) and reconnected
    with the restart budget whole. Returns the replicas' launches by kernel.
    Files in ``SERVE_SOAK_ROOT`` (removed after a pass)."""
    report = soak.wait(SERVE_SOAK_TIMEOUT_S)
    tool = port["tools"]["serve_soak"]
    cycles = report["per_cycle"]
    check(report["ok"] is True and report["faults"] == SERVE_SOAK_FAULTS
          and report["passed"] == len(SERVE_SOAK_FAULTS)
          and all(c["monitor_exit"] in tool.MONITOR_OK.get(c["fault"], (0,))
                  and c["requests"] > 0 and c["errors"] == 0 and c["rejected"] == 0
                  and c["rc"] == 75 for c in cycles),
          f"serve soak report {json.dumps(report)[:3000]}")
    for c in cycles:
        kl = c["kernel_launches"]
        check(kl.get("conv_grad_norm_direct", 0) > 0 and kl.get("conv_grad_norm_gram", 0) > 0,
              f"serve soak: cycle {c['fault']} launched no direct or Gram kernel: {kl}")
    by = dict(zip(report["faults"], cycles))
    metrics = os.path.join(SERVE_SOAK_ROOT, "wd",
                           f"cycle{SERVE_SOAK_FAULTS.index('partition')}_partition",
                           "metrics.jsonl")
    launch = next(r for r in jsonl(metrics) if r.get("kind") == "serve_fleet"
                  and r.get("event") == "launch")
    part = by["partition"]
    budget = (part["refresh"] or {}).get("max_restarts")
    before = _at(part, "replica_event:partitioned", "restarts_left")
    after = _at(part, "replica_event:reconnected", "restarts_left")
    check(launch.get("placement") == [None] * report["replicas"] and before == after == budget,
          f"serve soak partition: placement {launch.get('placement')}, restarts_left "
          f"{before} -> {after} of {budget}")
    launches = {k: sum(c["kernel_launches"].get(k, 0) for c in cycles)
                for k in port["kernels"].KERNELS}
    auto, wedge = by["autoscale"], by["wedge"]
    walls = {
        "partition": {"dark_to_quarantined_s": _span(part, "dark", "replica_event:partitioned"),
                      "quarantined_to_reconnected_s": _span(
                          part, "replica_event:partitioned", "replica_event:reconnected"),
                      "restarts_left": [before, after]},
        "autoscale": {"violation_s": _at(auto, "slo_violation:"),
                      "scale_up_s": _at(auto, "autoscale_event:scale_up"),
                      "grown_routable_s": _at(auto, "grown_routable"),
                      "scale_down_s": _at(auto, "autoscale_event:scale_down")},
        "wedge": {"wedged_s": _at(wedge, "replica_event:wedged"),
                  "reaped_s": _at(wedge, "replica_event:wedged_reaped"),
                  "respawn_s": _at(wedge, "replica_event:respawn"),
                  "recovered_s": _at(wedge, "recovered")}}
    print(f"  serve soak {report['faults']} (ResNet-18 GraNd, fp32, {report['replicas']} "
          f"replicas): exit 0, wall_s {report['wall_s']} beside {soak.beside()}; "
          f"passed {report['passed']}/{report['cycles']}, monitor exits "
          f"{report['monitor_exits']}, cycle walls {report['cycle_wall_s']} s, p95 "
          f"{[None if p is None else round(p, 2) for p in report['p95_ms']]} ms, requests "
          f"{[c['requests'] for c in cycles]} with 0 failed; partition placement "
          f"{launch.get('placement')} (remote slots); walls (s since the fleet's launch) "
          f"{json.dumps(walls)}; launches {[c['kernel_launches'] for c in cycles]} on {card}",
          flush=True)
    shutil.rmtree(SERVE_SOAK_ROOT, ignore_errors=True)
    return {"launches": launches, "walls": walls,
            "report": {k: v for k, v in report.items() if k != "per_cycle"}}


def summary_gauge(recs: list[dict], name: str):
    """A gauge of the stream's last registry snapshot."""
    snaps = [r for r in recs if r["kind"] == "metrics"]
    return snaps[-1]["gauges"].get(name) if snaps else None


def load_port() -> dict:
    """The port's entry points and modules this script drives, by name; fails
    when the package is not importable next to this script."""
    try:
        from data_diet_distributed_tpu_torch.config import load_config
        from data_diet_distributed_tpu_torch.data import pipeline
        from data_diet_distributed_tpu_torch.data.datasets import ArrayDataset, load_dataset
        from data_diet_distributed_tpu_torch.device import (set_parity_mode,
                                                            set_scoring_determinism)
        from data_diet_distributed_tpu_torch.models import create_model, create_model_from_cfg
        from data_diet_distributed_tpu_torch.ops import build
        from data_diet_distributed_tpu_torch.ops import grand_batched
        from data_diet_distributed_tpu_torch.ops import kernels as K
        from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
        from data_diet_distributed_tpu_torch.pruning import select_indices
        from data_diet_distributed_tpu_torch.pruning import verify_prune_manifest
        from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager, tier_steps
        from data_diet_distributed_tpu_torch import cli, tuning
        from data_diet_distributed_tpu_torch.data import native, sharded
        from data_diet_distributed_tpu_torch.data.datasets import _chunked_channel_stats
        from data_diet_distributed_tpu_torch.ops.scores import make_local_scores
        from data_diet_distributed_tpu_torch.resilience import inject
        from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
        from data_diet_distributed_tpu_torch.resilience.stages import StageManifest
        from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
        from data_diet_distributed_tpu_torch.serve.server import ServeService
        from data_diet_distributed_tpu_torch.obs import registry, reqtrace
        from data_diet_distributed_tpu_torch.obs.metrics import MetricsLogger
        from data_diet_distributed_tpu_torch.obs.session import ObsSession
        from data_diet_distributed_tpu_torch.train import loop, state, steps
        from data_diet_distributed_tpu_torch.weights import init_variables, variables_to
        from data_diet_distributed_tpu_torch.graphs import GraphCache
        from data_diet_distributed_tpu_torch.tools import (perf_sentry, profile_dispatch,
                                                           serve_soak, validate_duty)
    except ImportError as err:
        fail(f"the port package is not importable next to this script: {err}")
    return {"load_config": load_config, "load_dataset": load_dataset,
            "ArrayDataset": ArrayDataset, "set_parity_mode": set_parity_mode,
            "create_model": create_model,
            "create_model_from_cfg": create_model_from_cfg, "kernels": K,
            "build": build, "grand_batched": grand_batched,
            "score_dataset": score_dataset, "select_indices": select_indices,
            "ServeEngine": ServeEngine, "init_variables": init_variables,
            "serve": {"ServeService": ServeService, "MetricsLogger": MetricsLogger,
                      "ObsSession": ObsSession, "registry": registry,
                      "reqtrace": reqtrace},
            "variables_to": variables_to,
            "chunked": {"GraphCache": GraphCache, "make_train_chunk": steps.make_train_chunk,
                        "dispatch_train_chunk": steps.dispatch_train_chunk,
                        "chunk_inputs": steps.chunk_inputs},
            "set_scoring_determinism": set_scoring_determinism,
            "inject": inject, "Preempted": Preempted, "StageManifest": StageManifest,
            "tuning": tuning,
            "tools": {"perf_sentry": perf_sentry, "profile_dispatch": profile_dispatch,
                      "serve_soak": serve_soak, "validate_duty": validate_duty},
            "CheckpointManager": CheckpointManager, "tier_steps": tier_steps,
            "make_local_scores": make_local_scores,
            "data": {"cli": cli, "native": native, "write_split": sharded.write_split,
                     "write_manifest": sharded.write_manifest,
                     "ShardReadError": sharded.ShardReadError,
                     "channel_stats": _chunked_channel_stats,
                     "iterate_batches": pipeline.iterate_batches,
                     "prefetch_stream": pipeline.prefetch_stream},
            "train": {"fit": loop.fit, "evaluate": loop.evaluate,
                      "fit_with_recovery": loop.fit_with_recovery,
                      "pipeline_fingerprint": loop.pipeline_fingerprint,
                      "load_data_for": loop.load_data_for,
                      "run_datadiet": loop.run_datadiet,
                      "score_variables_for_seeds": loop.score_variables_for_seeds,
                      "scores_npz_path": loop.scores_npz_path,
                      "sweep_level_dir": loop.sweep_level_dir,
                      "verify_prune_manifest": verify_prune_manifest,
                      "create_train_state": state.create_train_state,
                      "state_from_variables": state.state_from_variables,
                      "make_optimizer": state.make_optimizer,
                      "train_step": steps.train_step,
                      "ResidentBatches": pipeline.ResidentBatches,
                      "maybe_resident": pipeline.maybe_resident,
                      "iterate_batches": pipeline.iterate_batches,
                      "to_device": pipeline.to_device}}


def main(argv: list[str]) -> int:
    # The dist phase's processes: one rank each (never run by hand).
    if argv[:1] == ["--dist-worker"]:
        return dist_worker(argv[1:])
    if argv[:1] == ["--drill-worker"]:
        return drill_worker(argv[1:])
    if argv[:1] == ["--mesh-serve-worker"]:
        return mesh_serve_worker(argv[1:])
    if argv[:1] == ["--tp-worker"]:
        return tp_worker(argv[1:])
    if argv[:1] == ["--walkthrough-worker"]:
        return walkthrough_worker(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile GraNd batches with torch.profiler")
    parser.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"),
                        help="directory for the detail files")
    args = parser.parse_args(argv)
    import torch
    phase("device")
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    port = load_port()
    K, build = port["kernels"], port["build"]
    set_parity_mode = port["set_parity_mode"]
    details: dict = {"card": card, "torch": torch.__version__,
                     "cuda": torch.version.cuda}

    phase("build")
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"  built {sorted(build.SOURCES)} in {build_s:.1f} s", flush=True)
    for name in sorted(build.SOURCES):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  [{name}] {line.strip()}", flush=True)
    # (kernel, function, instances): the bf16 modes on the tensor cores, and the
    # Gram kernel and the stacked-BN vector mode in both dtypes, must not spill.
    for name, fn, count in (("conv_grad_norm_direct", "direct_mma_kernel", 1),
                            ("conv_bwd_grad_norm", "bwd_norm_mma_kernel", 1),
                            ("conv_grad_norm_catdot", "catdot_mma_kernel", 1),
                            ("conv_grad_norm_gram", "gram_kernel", 2),
                            ("bn_grad_norm", "bn_vector_kernel", 2)):
        props = function_properties(build.build_log(name), fn)
        print(f"  {fn}: {props}", flush=True)
        check(len(props) == count
              and all("0 bytes spill stores, 0 bytes spill loads" in p for p in props),
              f"{name}: {fn} spills registers (or was not found): {props}")
    details["build_s"] = build_s

    phase("kernels")
    kernel_details: list = []
    set_parity_mode(True)   # the plain versions' fp32 products stay full fp32
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        kernel_phase(torch, K, dtype, rtol, kernel_details)
        route_kernel_phase(torch, K, dtype, rtol, kernel_details)
    set_parity_mode(False)
    details["kernels"] = kernel_details

    phase("path")
    path = path_phase(torch, port, details, card)

    phase("routes")
    routes = routes_phase(torch, port, details, card)

    phase("serve")
    serve_phase(torch, port, path, details)
    serve_routes_phase(torch, port, routes, details)

    phase("service")
    service = service_phase(torch, port, path, details, card)

    phase("fleet")
    fleet = fleet_phase(torch, port, path, details, card)

    phase("mesh_serve")
    mesh_serve = mesh_serve_phase(torch, port, path, details, card)

    # The serve soak and the walkthrough run beside the resnet50, train, chunked
    # and obs phases, which hold no timing gate.
    ssoak_proc, walk_proc = start_serve_soak(), start_walkthrough()
    try:
        phase("resnet50")
        r50 = resnet50_phase(torch, port, details, card)

        phase("train")
        trained = train_phase(torch, port, details, card)

        phase("walkthrough")
        walk = walkthrough_phase(port, walk_proc, card)

        phase("chunked")
        chunked = chunked_phase(torch, port, details, card)

        phase("obs")
        obs_phase(torch, port, details, card)

        phase("serve_soak")
        ssoak = serve_soak_phase(port, ssoak_proc, card)
        details["serve_soak"] = {k: ssoak[k] for k in ("walls", "report")}
    finally:
        walk_proc.stop()
        ssoak_proc.stop()

    phase("resilience")
    resil = resilience_phase(torch, port, details, trained)

    phase("data")
    # The demo and the soak run beside the data, wrn and tp phases.
    soak, demo_proc = start_soak(), start_demo()
    try:
        data = data_phase(torch, port, details, card)

        phase("wrn")
        wrn = wrn_phase(torch, port, details, card)

        phase("tp")
        tp = tp_phase(torch, port, details, card)

        phase("demo")
        demo = demo_phase(port, demo_proc, card)

        phase("soak")
        details["soak"] = soak_phase(soak, card)
    finally:
        demo_proc.stop()
        soak.stop()

    phase("dist")
    dist_phase(torch, port, details, card, path, trained)

    phase("elastic")
    elastic = elastic_phase(torch, port, details, card)

    phase("tune")
    tune = tune_phase(torch, port, routes, card)
    details["tune"] = tune

    phase("duty")
    details["duty"] = duty_phase(port, card)


    phase("calls")
    calls_phase(torch)

    if args.profile:
        phase("profile")
        profile_phase(torch, port, path, details, args.out, data["profile"], wrn["profile"])

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)

    # One entry per kernel: per-batch sums over the layers of the route that runs
    # it, bf16; launches summed over the counted runs of the path, routes and
    # resnet50 phases, the train phase's run, the resilience phase's runs, the data
    # phase's run, the wrn phase's passes and sweep, the tp phase's ranks and its
    # W = 1 run, the elastic phase's relaunched attempts, the demo's three legs, the
    # walkthrough's run and the serve soak's replicas.
    launches = {k: path["counts"][k] + routes["counts"][k] + service["counts"][k]
                + fleet[k] + mesh_serve[k] + r50["counts"][k] + trained["counts"][k]
                + chunked["counts"][k] + resil["counts"][k]
                + data["counts"][k] + wrn["counts"][k] + tp[k] + elastic[k] + demo[k]
                + walk[k] + ssoak["launches"][k]
                for k in K.KERNELS}
    check(all(launches[k] > 0 for k in KERNEL_INFO), f"a kernel never launched: {launches}")
    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = [r for r in kernel_details if r["kernel"] == name]
        path_rows = [r for r in rows if r["dtype"] == "bfloat16"
                     and r["layers_per_batch"] > 0]
        t_ops = sum(r["layers_per_batch"] * r["bound_ms"] for r in path_rows
                    if r["bound_by"] == "operations")
        t_bytes = sum(r["layers_per_batch"] * r["bound_ms"] for r in path_rows
                      if r["bound_by"] == "bytes")
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["layers_per_batch"] * r["ms"] for r in path_rows),
            "device_ms": sum(r["layers_per_batch"] * r["device_ms"] for r in path_rows),
            "plain_ms": sum(r["layers_per_batch"] * r["plain_ms"] for r in path_rows),
            "bound_ms": t_ops + t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    print("kernels: " + ", ".join(sorted(KERNEL_INFO)), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
