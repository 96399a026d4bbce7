#!/usr/bin/env python3
"""The PyTorch port across every card of one machine, one rank a card over NCCL.

    python3 tools/multi_card.py [--out DIR]                # W = every visible card
    python3 tools/multi_card.py --device cpu --world 4 --examples 512  # gloo rehearsal
    python3 tools/multi_card.py --only-elastic [--out DIR]  # step 7 alone
    python3 tools/multi_card.py --only-elastic --device cpu --world 4 --examples 256
    python3 tools/multi_card.py --only-serve [--out DIR]    # step 8 alone
    python3 tools/multi_card.py --only-serve --device cpu --world 4 --examples 256
    python3 tools/multi_card.py --only-tp [--out DIR]       # step 9 alone
    python3 tools/multi_card.py --only-tp --device cpu --world 4 --examples 256
    python3 tools/multi_card.py --only-fleet-mesh [--out DIR]  # step 10 alone
    python3 tools/multi_card.py --only-fleet-mesh --device cpu --world 4 --examples 256

Starts W rank processes of this script (each with a timeout; a rank that
fails fails the run) that join a group through
``parallel.mesh.initialize_multihost`` from the ``mesh`` keys, and then:

1. time the collectives of a training step on ResNet-18's 11,173,962 fp32
   gradients (44.7 MB): the all-reduce of the replicated update, and the
   reduce-scatter plus all-gather of the sharded update;
2. fit full-width ResNet-18 (the ``configs/cifar10_resnet18.yaml`` recipe,
   bf16, augmented) at a global batch of 128 a rank for 2 epochs, with the
   consensus hooks and with ``resilience.consensus=false``: every rank ends
   with the same state, bitwise, either way; each epoch's ex/s;
3. run 3 fp32 steps (TF32 off) at a global batch of 128 replicated, under
   ZeRO-1 and under the sharded update: each layout's ranks bitwise equal,
   rank 0's optimizer bytes, and here (W = 1 on the first card) the
   replicated run within rtol 1e-5 (losses) and rtol 1e-4, atol 1e-6
   (variables), each layout against the replicated one likewise (a sum of
   more than two operands depends on the order NCCL adds them in);
4. score GraNd and EL2N over the examples x 2 seeds at batch 512: the ranks'
   vectors bitwise equal, within ``tests/test_distributed.py``'s tolerances
   of W = 1 here at the rank's batch, launches per rank per batch per seed,
   ex/s; GraNd again at batch 512 a rank against W = 1 at 512; then the
   fit of step 2 here on one card at the rank's batch of 128, for its ex/s,
   and a train step of each profiled (``torch.profiler``: host wall, device
   time, busy share, NCCL kernel time, launches; rank 0's and the one
   card's tables in ``<out>/multi_card_profile_*.txt``);
5. restore the ZeRO-1 run's checkpoint here at W = 1, bitwise the ranks'
   gathered state;
6. run ``cli train`` (tiny_cnn, 256 examples) as W ranks: whole; a SIGTERM to
   rank 1 (every rank exits 75 at step 4, durable at 4) and its resume
   (bitwise the whole run); a hang on rank 1 (every rank exits 69);
7. the elastic drill: ``cli sweep`` (ResNet-18 at full width, GraNd at
   initialization over seeds [0, 1], ``prune.sweep=[0.5,0.7]``, 3 retrain
   epochs at a global batch of ``ELASTIC_BATCH``, ZeRO-1, the local tier)
   under an ``ElasticSupervisor`` of W ranks, each rank one process of this
   script around ``cli.main`` that records a digest of its replicated
   variables after every fit and of its scores. Attempt 0's fault plan
   SIGKILLs rank W-1 after the first level's retrain epoch 1: the supervisor
   names it dead (survivors wedged in NCCL are reaped, not counted) and
   relaunches W-1 ranks, which restore a tier step saved at W (the ZeRO-1
   momentum re-sliced) and finish the level; attempt 1's plan writes a join
   request when that level completes, and the supervisor grows the world
   back to W at the second level's boundary. Checks: the supervisor exits 0
   with shrink (dead [W-1]), join_requested, grow (W) and complete; the
   ``resume`` of attempt 1 is at W-1 from a step saved at W; each attempt's
   ranks hold bitwise equal variables and scores; the scores against W = 1
   here at the rank's batch (bitwise or not is reported; within
   ``tests/test_distributed.py``'s tolerance); the port's post-mortem exits
   0 over the stream; the walls. With ``--only-elastic`` only this step
   (and its W = 1 reference) runs;
8. serving across the cards: ``cli serve`` (the ``cifar10_resnet18.yaml``
   recipe at full width, the examples, seeds [0, 1], batch 512, both methods,
   ``serve.warm=false``) as W ranks, one a card, then as one process on the
   first card. Each service answers on rank 0's port; the first
   ``/v1/topk?k=100`` per method runs the first whole-dataset pass (its wall is
   reported at W and at 1); at W every ``/v1/score`` (100 and 512 ids),
   ``/v1/rank`` (100 ids) and ``/v1/topk`` answer is bitwise ``score_dataset``
   on the same W ranks at batch 512 (step 4's vectors, or with
   ``--only-serve`` the same pass by W ranks of this script), and at 1 the
   largest difference from them is reported; p50/p95 per method under 4
   clients x 25 requests of 1-64 random ids; a SIGTERM to rank 0 ends every
   rank with exit 75. With ``--only-serve`` only this step runs.
9. tensor parallelism across the cards: BASELINE config 4's ``cli run``
   (``configs/cifar100_wrn28_10.yaml``: WideResNet-28-10, GraNd over seeds
   [0, 1, 2], prune 50 %, bf16; tiny_cnn in fp32 on the CPU) on the examples
   of synthetic CIFAR-100-geometry data written as npz (1 pretrain and 1
   retrain epoch), as W ranks with ``mesh.model_axis=2`` (``{data: W / 2,
   model: 2}``, NCCL), then as one process on the first card. Checks: every
   rank exits 0; each rank ends each pretrain and the retrain holding its
   ``[50, 640]`` rows of the head and their momentum; the scores within
   ``tests/test_distributed.py``'s GraNd tolerance (rtol 1e-4 + 1e-5) of
   ``score_dataset`` at W = 1 at the rank's batch (512 / W) on the ranks'
   pretrained variables; each
   rank's launches of the scoring pass equal W = 1's (one a layer a batch,
   on a W-th of the rows); the
   final checkpoint restores at W = 1 with the whole head. Walls and
   per-epoch ex/s of both runs, the one card's scores' largest difference
   from the W ranks', and before each run ten train steps of the recipe
   profiled on each rank as in step 4 (host wall, device time, busy share,
   NCCL time, launches; rank 0's tables in
   ``<out>/multi_card_tp_profile_w<W>.txt``). With ``--only-tp`` only this
   step runs.
10. a fleet of meshes across the cards (``--only-fleet-mesh`` runs it, and
   only it): ``cli serve serve.replicas=W/2 mesh.multihost=true
   mesh.num_processes=2`` (step 8's recipe, ``serve.warm=false``; NCCL, each
   replica on its own two cards, placed by the fleet), each rank's card
   shown from outside it (its ``CUDA_VISIBLE_DEVICES``, the card uuids a
   CUDA process sees under that list matched to ``nvidia-smi``'s indices)
   and from the cards' side: the memory in use per card, read before the
   fleet starts and once it is routable, must rise by at least
   ``CONTEXT_MIB`` on every placed card and by less on any other
   (``nvidia-smi --query-compute-apps`` is reported beside it). Every answer
   through the
   router (``/v1/topk``, ``/v1/score`` of 100 and 512 ids, ``/v1/rank``, and
   4 clients x 25 requests of 1-64 ids per method) is bitwise
   ``score_dataset`` on two ranks at batch 512, scored first by two ranks of
   this script; p50/p95 per method. Then rank 1 of replica 1 is SIGKILLed
   under keyed load (2 clients, retries): 0 failures, every answer bitwise,
   a ``died`` record naming that rank, the group respawned on its port on a
   new coordinator, the respawn wall (death to both replicas routable);
   SIGTERM -> 75 from the supervisor and every rank. Then ``serve.replicas=W``
   plain replicas, one a card: the same answers, bitwise ``score_dataset`` on
   one rank at 512, p50/p95, SIGTERM -> 75. On the CPU (gloo) nothing is
   placed.

Prints one line per step and, as the last line, a JSON object of the
numbers (also written to ``<out>/multi_card.json``), with the cards' name and
power limit on a line before it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GRAD_ELEMS = 11_173_962       # ResNet-18's parameters (10 classes)
WORKER_TIMEOUT_S = 600
DRILL_GRACE_S = 3.0
SEEDS = (0, 1)
SCORE_B = 512
ELASTIC_BATCH = 384           # a multiple of W and of W - 1 (4 and 3)
ELASTIC_TIMEOUT_S = 1200
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_IDS = 4, 25, 64
SERVE_BOOT_S = 600
DRILL_ARGV = ["train", "--config", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
              "data.synthetic_size=256", "data.batch_size=64", "data.eval_batch_size=64",
              "model.arch=tiny_cnn", "train.num_epochs=3", "train.checkpoint_every=1",
              "train.log_every_steps=1000", f"resilience.consensus_grace_s={DRILL_GRACE_S}"]


def fail(msg: str) -> None:
    print(f"multi_card: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def recipe(load_config, n: int, *over):
    return load_config(os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), [
        "data.dataset=synthetic", f"data.synthetic_size={n}", "score.pretrain_epochs=0",
        *over])


def digest(state) -> str:
    h = hashlib.sha256()
    for g in ("params", "batch_stats", "momentum"):
        for k in sorted(getattr(state, g)):
            t = getattr(state, g)[k].detach().float().cpu()
            h.update(k.encode() + t.numpy().tobytes())
    return h.hexdigest()


def save_variables(path: str, state) -> None:
    np.savez(path, **{f"{g}/{k}": v.detach().float().cpu().numpy()
                      for g in ("params", "batch_stats", "momentum")
                      for k, v in getattr(state, g).items()})


def timed_ms(torch, cuda: bool, fn, iters: int = 5) -> float:
    """Median host wall of ``fn()``, ending in a synchronize on a card."""
    times = []
    for _ in range(iters + 1):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def step_profile(torch, cuda: bool, cfg, ds, dev, steps: int = 10) -> tuple[dict, str]:
    """Train steps of ``cfg`` on device-resident batches of ``ds`` (this rank's
    rows): host wall a step (synchronized, after warm-up), then under
    ``torch.profiler`` the device time a step, its busy share, the NCCL
    kernels' share and the launches; with the tables by device and CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from data_diet_distributed_tpu_torch.data.pipeline import ResidentBatches
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.parallel.mesh import batch_slice
    from data_diet_distributed_tpu_torch.train.state import (create_train_state,
                                                             make_optimizer, shard_slots)
    from data_diet_distributed_tpu_torch.train.steps import train_step

    model = create_model_from_cfg(cfg).to(dev)
    sgd = make_optimizer(cfg, 64)
    state = shard_slots(create_train_state(cfg, 0, dev, model), sgd)
    batches = list(ResidentBatches(ds, cfg.data.batch_size, dev, torch.bfloat16,
                                   batch_slice())())
    augment = (cfg.data.crop_pad, cfg.data.flip, 0)

    def run(k):
        for i in range(k):
            train_step(model, sgd, state, batches[i % len(batches)], augment)
        if cuda:
            torch.cuda.synchronize()

    run(3)
    t0 = time.perf_counter()
    run(steps)
    wall = 1e3 * (time.perf_counter() - t0) / steps
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(steps)
        prof_wall = 1e3 * (time.perf_counter() - t0) / steps
    dev_events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.device_time for e in dev_events) / 1e3 / steps
    nccl_ms = sum(e.device_time for e in dev_events if "nccl" in e.name.lower()) / 1e3 / steps
    avg = prof.key_averages()
    tables = (avg.table(sort_by="self_device_time_total" if cuda else "self_cpu_time_total",
                        row_limit=20) + "\n\n"
              + avg.table(sort_by="self_cpu_time_total", row_limit=20))
    return {"wall_ms": wall, "profiled_wall_ms": prof_wall, "device_ms": device_ms,
            "busy_share": device_ms / prof_wall, "nccl_ms": nccl_ms,
            "launches": len(dev_events) / steps}, tables


def worker(rank: int, world: int, port: str, out: str, device: str, n: int) -> None:
    """One rank: steps 1-4 of the module docstring; results in ``out``."""
    import torch

    from data_diet_distributed_tpu_torch.config import MeshConfig, load_config
    from data_diet_distributed_tpu_torch.data.datasets import load_dataset
    from data_diet_distributed_tpu_torch.device import set_parity_mode
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
    from data_diet_distributed_tpu_torch.parallel import collectives, mesh
    from data_diet_distributed_tpu_torch.train import loop
    from data_diet_distributed_tpu_torch.train.state import (gather_slots, make_optimizer,
                                                             optimizer_bytes)
    from data_diet_distributed_tpu_torch.weights import init_variables

    cuda = device == "cuda"
    mesh.initialize_multihost(MeshConfig(multihost=True,
                                         coordinator_address=f"127.0.0.1:{port}",
                                         num_processes=world, process_id=rank),
                              None if cuda else "cpu")
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    res: dict = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(dev)}
    grads = [torch.ones(GRAD_ELEMS, device=dev)]
    # The reduce-scatter needs equal slices: the largest multiple of W elements.
    per_rank = [[c] for c in torch.ones(GRAD_ELEMS - GRAD_ELEMS % world,
                                        device=dev).chunk(world)]
    res["all_reduce_ms"] = timed_ms(torch, cuda, lambda: collectives.all_reduce_flat(grads))
    res["reduce_scatter_ms"] = timed_ms(torch, cuda,
                                        lambda: collectives.reduce_scatter_flat(per_rank))
    res["all_gather_ms"] = timed_ms(torch, cuda,
                                    lambda: collectives.all_gather_flat(per_rank[rank]))

    # 2. The bf16 fit at 128 a rank, with the consensus hooks (a host all-gather
    # a step for the preemption poll) and without them.
    res["fit"] = {}
    for name, over in (("consensus", ()), ("no_consensus", ("resilience.consensus=false",))):
        cfg = recipe(load_config, n, f"data.batch_size={128 * world}", "train.num_epochs=2",
                     "data.augment=true", f"train.checkpoint_dir={out}/fit", *over)
        ds, _ = loop.load_data_for(cfg)
        fit = loop.fit(cfg, ds, None, device=dev)
        res["fit"][name] = {"digest": digest(fit.state),
                            "examples_per_s": [h["examples_per_s"] for h in fit.history]}
    res["step"], tables = step_profile(torch, cuda, cfg, ds, dev)
    if rank == 0:
        with open(os.path.join(out, "profile_rank0.txt"), "w") as fh:
            fh.write(tables)

    # 3. Three fp32 steps in each update layout (TF32 off).
    set_parity_mode(True)
    res["layouts"] = {}
    for name, over in (("replicated", ()), ("zero1", ("mesh.shard_opt_state=true",)),
                       ("sharded", ("mesh.shard_weight_update=true",))):
        lcfg = recipe(load_config, 128, "data.batch_size=128", "train.num_epochs=3",
                      "train.half_precision=false", f"train.checkpoint_dir={out}/fit", *over)
        lds, _ = loop.load_data_for(lcfg)
        ckpt = os.path.join(out, "zero1_ckpt") if name == "zero1" else None
        fit = loop.fit(lcfg, lds, None, device=dev, checkpoint_dir=ckpt)
        whole = gather_slots(fit.state, make_optimizer(lcfg, 1))
        res["layouts"][name] = {"digest": digest(whole), "optimizer_bytes":
                                optimizer_bytes(fit.state),
                                "losses": [h["train_loss"] for h in fit.history]}
        if rank == 0:
            save_variables(os.path.join(out, f"layout_{name}.npz"), whole)
    set_parity_mode(False)

    # 4. Scoring at batch 512.
    model = create_model_from_cfg(cfg)
    sds, _ = load_dataset("synthetic", synthetic_size=n, seed=0)
    variables = [init_variables("resnet18", s, dev) for s in SEEDS]
    res["scores"] = score_at_batch(torch, cuda, model, variables, sds, dev, rank, out)
    # GraNd again with the batch grown with W (512 rows a rank).
    t0 = time.perf_counter()
    scores = score_dataset(model, variables, sds, method="grand", batch_size=SCORE_B * world,
                           device=dev)
    res["scores"]["grand_wide"] = {"wall_s": time.perf_counter() - t0}
    np.save(os.path.join(out, f"scores_grand_wide_{rank}.npy"), scores)
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as fh:
        json.dump(res, fh)
    sys.stdout.flush()
    os._exit(0)


def score_at_batch(torch, cuda: bool, model, variables, sds, dev, rank: int,
                   out: str) -> dict:
    """GraNd and EL2N ``score_dataset`` at batch ``SCORE_B`` on this rank
    (after a one-batch warm-up): walls and launches; the vectors in
    ``out/scores_<method>_<rank>.npy``."""
    from data_diet_distributed_tpu_torch.ops import kernels as K
    from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
    score_dataset(model, variables[:1], sds.subset(sds.indices[:SCORE_B]), method="grand",
                  batch_size=SCORE_B, device=dev)   # warm-up
    res = {}
    for method in ("grand", "el2n"):
        K.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = score_dataset(model, variables, sds, method=method, batch_size=SCORE_B,
                               device=dev)
        res[method] = {"wall_s": time.perf_counter() - t0, "launches": K.launch_counts()}
        np.save(os.path.join(out, f"scores_{method}_{rank}.npy"), scores)
    return res


def score_rank(rank: int, world: int, port: str, out: str, device: str, n: int,
               config: str, over: list[str]) -> None:
    """One rank of step 8's reference with ``--only-serve``: step 4's scoring of
    the service's recipe."""
    import torch

    from data_diet_distributed_tpu_torch.config import MeshConfig, load_config
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.parallel import mesh
    from data_diet_distributed_tpu_torch.train import loop
    cuda = device == "cuda"
    mesh.initialize_multihost(MeshConfig(multihost=True,
                                         coordinator_address=f"127.0.0.1:{port}",
                                         num_processes=world, process_id=rank),
                              None if cuda else "cpu")
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    cfg = load_config(config, over)
    ds, _ = loop.load_data_for(cfg)
    variables = loop.score_variables_for_seeds(cfg, ds, device=dev)
    score_at_batch(torch, cuda, create_model_from_cfg(cfg), variables, ds, dev, rank, out)
    sys.stdout.flush()
    os._exit(0)


def drill_rank(rank: int, world: int, port: str, device: str, cli_argv: list[str]) -> None:
    """One rank of a ``cli`` drill, joined through the ``mesh`` keys."""
    from data_diet_distributed_tpu_torch import cli
    argv = [*cli_argv, "mesh.multihost=true", f"mesh.coordinator_address=127.0.0.1:{port}",
            f"mesh.num_processes={world}", f"mesh.process_id={rank}"]
    if device == "cpu":
        argv += ["--device", "cpu"]
    rc = cli.main(argv)
    sys.stdout.flush()
    os._exit(rc)


def elastic_rank(digest_path: str, cli_argv: list[str]) -> None:
    """One rank of the elastic drill: ``cli.main`` with every fit's replicated
    variables and every scoring pass's scores digested into ``digest_path``
    (the ranks of an attempt must agree)."""
    from data_diet_distributed_tpu_torch import cli
    from data_diet_distributed_tpu_torch.train import loop
    digests: dict = {}

    def dump() -> None:
        with open(digest_path, "w") as fh:
            json.dump(digests, fh)

    real_fit, real_scores = loop.fit, loop.compute_scores

    def fit(*a, **kw):
        res = real_fit(*a, **kw)
        h = hashlib.sha256()
        for g in ("params", "batch_stats"):
            for k in sorted(getattr(res.state, g)):
                h.update(k.encode() + getattr(res.state, g)[k].float().cpu().numpy().tobytes())
        digests[f"fit:{kw.get('tag', 'train')}"] = h.hexdigest()
        dump()
        return res

    def compute_scores(*a, **kw):
        scores, timings = real_scores(*a, **kw)
        digests["scores"] = hashlib.sha256(np.ascontiguousarray(scores).tobytes()).hexdigest()
        dump()
        return scores, timings

    loop.fit, loop.compute_scores = fit, compute_scores
    rc = cli.main(cli_argv)
    sys.stdout.flush()
    os._exit(rc)


def elastic_drill(world: int, device: str, n: int, work: str, load_config) -> dict:
    """Step 7 (see the module docstring); returns its numbers."""
    from data_diet_distributed_tpu_torch.obs import postmortem, timeline
    from data_diet_distributed_tpu_torch.resilience import elastic
    d = os.path.join(work, "elastic")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    over = ["data.dataset=synthetic", f"data.synthetic_size={n}", "score.seeds=[0,1]",
            "score.pretrain_epochs=0", "prune.sweep=[0.5,0.7]", "train.num_epochs=3",
            "train.checkpoint_every=1", f"data.batch_size={ELASTIC_BATCH}",
            "checkpoint.local_tier=true", "mesh.shard_opt_state=true",
            "resilience.step_timeout_s=60", f"train.checkpoint_dir={d}/ckpt",
            f"obs.metrics_path={d}/metrics.jsonl", "elastic.enabled=true",
            f"elastic.world={world}", f"elastic.max_world={world}", "elastic.backoff_s=0",
            "elastic.reap_timeout_s=30"]
    if device == "cpu":
        over += ["model.arch=tiny_cnn", "train.half_precision=false", "score.batch_size=128"]
    config = os.path.join(REPO, "configs", "cifar10_resnet18_grand10.yaml")
    cfg = load_config(config, over)
    plans = {0: {"rank": world - 1, "kill_rank_after_epoch": 1},
             1: {"rejoin_after_stage": "retrain:final_s0p5"}}

    class Drill(elastic.ElasticSupervisor):
        def _child_argv(self, w, rank):
            argv = super()._child_argv(w, rank)
            return [sys.executable, os.path.abspath(__file__), "--elastic-rank",
                    os.path.join(d, f"digests_a{self.attempt}_r{rank}.json"), *argv[3:]]

    logger = elastic.JsonlLogger(cfg.obs.metrics_path, echo=False)
    sup = Drill(cfg, "sweep", config_path=config, overrides=over, logger=logger,
                device="cpu" if device == "cpu" else None,
                fault_env=lambda a: ({"DDT_FAULT_PLAN": json.dumps(plans[a])}
                                     if a in plans else {}))
    t0 = time.perf_counter()
    rc = sup.run()
    wall = time.perf_counter() - t0
    logger.log("run_summary", wall_s=round(wall, 3), exit_class=sup.exit_class(rc),
               command="sweep", lineage=sup.lineage_block())
    logger.close()
    logs = ""
    for name in sorted(os.listdir(f"{d}/ckpt_elastic")):
        if name.endswith(".log"):
            with open(os.path.join(d, "ckpt_elastic", name), errors="replace") as fh:
                logs += f"\n[{name}] " + fh.read()[-1500:]
    events = [e["event"] for e in sup.events]
    check(rc == 0, f"7. the supervised sweep exited {rc}: {events}{logs}")
    by = {e["event"]: e for e in sup.events}
    check(by.get("shrink", {}).get("dead_ranks") == [world - 1]
          and by["shrink"]["new_world"] == world - 1
          and by.get("grow", {}).get("new_world") == world and events[-1] == "complete"
          and "join_requested" in events and sup.worlds == [world, world - 1, world],
          f"7. events {sup.events}")
    records = timeline.read_records(cfg.obs.metrics_path)
    resume = [r for r in records if r.get("kind") == "resume" and r.get("attempt") == 1]
    check(len(resume) == 1 and resume[0]["world"] == world - 1
          and resume[0]["saved_world"] == world, f"7. attempt 1's resume: {resume}")
    agree = {}
    for a, w in enumerate(sup.worlds):
        ranks = []
        for r in range(w):
            with open(os.path.join(d, f"digests_a{a}_r{r}.json")) as fh:
                ranks.append(json.load(fh))
        keys = set.intersection(*(set(x) for x in ranks))
        check(keys and all(len({x[k] for x in ranks}) == 1 for k in keys),
              f"7. attempt {a}'s ranks disagree: {ranks}")
        agree[a] = sorted(keys)
    report = postmortem.build_report(timeline.discover_artifacts(cfg.obs.metrics_path))
    check(report["exit_code"] == 0, f"7. post-mortem: {report['problems']}")
    chains = [{k: c.get(k) for k in ("action", "dead_ranks", "reaped_ranks", "new_world",
                                     "resume_step", "saved_world", "recovery_wall_s")}
              for c in report["recoveries"] if c["type"] == "relaunch"]
    with np.load(f"{d}/ckpt_s0p5_scores.npz") as f:
        scores = f["scores"]
    shutil.copy(cfg.obs.metrics_path,
                os.path.join(os.path.dirname(work), "multi_card_elastic_metrics.jsonl"))
    return {"wall_s": wall, "events": events, "worlds": sup.worlds, "resume": resume[0],
            "agreeing_keys": agree, "chains": chains, "lost_wall_s": report["lost_wall_s"],
            "lineage": sup.lineage_block(), "scores": scores, "config": config,
            "over": over}


def spawn(args: list[str], log_path: str, plan: str | None = None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "DDT_FAULT_PLAN"}
    env["PYTHONPATH"] = REPO
    if plan is not None:
        env["DDT_FAULT_PLAN"] = plan
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args], cwd=REPO,
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    log.close()
    return {"proc": proc, "log_path": log_path, "t0": time.time()}


def finish(procs: list[dict]) -> None:
    try:
        for p in procs:
            p["rc"] = p["proc"].wait(timeout=max(1.0, p["t0"] + WORKER_TIMEOUT_S - time.time()))
            p["t_exit"] = time.time()
    finally:
        for p in procs:
            if p["proc"].poll() is None:
                p["proc"].kill()
                p["proc"].wait(timeout=30)
    for p in procs:
        with open(p["log_path"]) as fh:
            p["log"] = fh.read()


def tail(p: dict) -> str:
    return f"{p['log_path']} exit {p.get('rc')}:\n{p.get('log', '')[-2500:]}"


def fmt_step(x: dict) -> str:
    return (f"{x['wall_ms']:.2f} ms ({x['profiled_wall_ms']:.2f}, {x['device_ms']:.2f}, "
            f"{100 * x['busy_share']:.1f} %, {x['nccl_ms']:.3f}, {x['launches']:.0f})")


def ckpt_arrays(directory: str) -> tuple[int, dict]:
    step = max(int(d[len("step_"):]) for d in os.listdir(directory)
               if d.startswith("step_") and d[len("step_"):].isdigit())
    with np.load(os.path.join(directory, f"step_{step}", "arrays.npz")) as f:
        return step, {k: f[k] for k in f.files}


def close_to(a: dict, b: dict, rtol: float, atol: float) -> float:
    """The largest |a - b| over the arrays; fails past rtol·|b| + atol."""
    worst = 0.0
    for k in b:
        d = np.abs(a[k] - b[k])
        worst = max(worst, float(d.max()) if d.size else 0.0)
        check(bool(np.all(d <= rtol * np.abs(b[k]) + atol)), f"{k}: beyond rtol {rtol}, "
                                                             f"atol {atol}")
    return worst


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        r, w, port, out, device, n = argv[1:7]
        worker(int(r), int(w), port, out, device, int(n))
    if argv[:1] == ["--drill"]:
        r, w, port, device = argv[1:5]
        drill_rank(int(r), int(w), port, device, argv[5:])
    if argv[:1] == ["--elastic-rank"]:
        elastic_rank(argv[1], argv[2:])
    if argv[:1] == ["--tp-rank"]:
        r, w, port, port2, out, device = argv[1:7]
        tp_rank(int(r), int(w), port, port2, out, device, argv[7:])
    if argv[:1] == ["--score-rank"]:
        r, w, port, out, device, n, config = argv[1:8]
        score_rank(int(r), int(w), port, out, device, int(n), config, argv[8:])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--world", type=int, default=None,
                        help="ranks (default: every visible card; required with --device cpu)")
    parser.add_argument("--examples", type=int, default=8192)
    parser.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"))
    parser.add_argument("--only-elastic", action="store_true",
                        help="run step 7 (the elastic drill) alone")
    parser.add_argument("--only-serve", action="store_true",
                        help="run step 8 (serving across the cards) alone")
    parser.add_argument("--only-tp", action="store_true",
                        help="run step 9 (the tensor-parallel head) alone")
    parser.add_argument("--only-fleet-mesh", action="store_true",
                        help="run step 10 (a fleet of meshes across the cards) alone")
    args = parser.parse_args(argv)
    import torch
    cuda = args.device == "cuda"
    if cuda:
        check(torch.cuda.is_available(), "CUDA is not available")
        world = args.world or torch.cuda.device_count()
        check(2 <= world <= torch.cuda.device_count(), f"{world} ranks need as many cards")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        cards = smi.stdout.strip().splitlines()
    else:
        check(args.world is not None and args.world >= 2, "--device cpu needs --world >= 2")
        world, cards = args.world, ["CPU rehearsal"]
    from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
    from data_diet_distributed_tpu_torch.config import load_config
    from data_diet_distributed_tpu_torch.data.datasets import load_dataset
    from data_diet_distributed_tpu_torch.device import set_parity_mode, set_scoring_determinism
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
    from data_diet_distributed_tpu_torch.train import loop
    from data_diet_distributed_tpu_torch.weights import init_variables

    if cuda:
        # Once, before the ranks start: they load the libraries this builds.
        from data_diet_distributed_tpu_torch.ops import build
        build.build_all()
    work = os.path.join(args.out, "multi_card")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    print(f"{world} ranks on {args.device}; torch {torch.__version__}", flush=True)
    t_run = time.perf_counter()
    if args.only_elastic:
        out = {"world": world, "cards": cards, "elastic": elastic_step(
            torch, world, args.device, args.examples, work, load_config)}
        return finish_run(args, out, work, cards, t_run)
    if args.only_serve:
        out = {"world": world, "cards": cards,
               "serve": serve_step(world, args.device, args.examples, work, reference=None)}
        return finish_run(args, out, work, cards, t_run)
    if args.only_tp:
        out = {"world": world, "cards": cards,
               "tp": tp_step(torch, world, args.device, args.examples, work, args.out)}
        return finish_run(args, out, work, cards, t_run)
    if args.only_fleet_mesh:
        out = {"world": world, "cards": cards,
               "fleet_mesh": fleet_mesh_step(world, args.device, args.examples, work)}
        return finish_run(args, out, work, cards, t_run)
    port = free_port()
    ranks = [spawn(["--worker", str(r), str(world), port, work, args.device,
                    str(args.examples)], os.path.join(work, f"rank_{r}.log"))
             for r in range(world)]
    finish(ranks)
    for p in ranks:
        check(p["rc"] == 0, f"a rank failed: {tail(p)}")
    res = []
    for r in range(world):
        with open(os.path.join(work, f"rank_{r}.json")) as fh:
            res.append(json.load(fh))
    r0 = res[0]
    out: dict = {"world": world, "cards": cards, "backend": r0["backend"],
                 "devices": [x["device"] for x in res]}
    check(len(set(out["devices"])) == world if cuda else True,
          f"ranks share a card: {out['devices']}")
    mb = GRAD_ELEMS * 4 / 1e6
    out["collectives_ms"] = {k: r0[k] for k in ("all_reduce_ms", "reduce_scatter_ms",
                                                "all_gather_ms")}
    print(f"  1. {r0['backend']}, one rank a card ({out['devices']}): the {mb:.1f} MB "
          f"gradient's all-reduce {r0['all_reduce_ms']:.3f} ms, reduce-scatter "
          f"{r0['reduce_scatter_ms']:.3f} ms + all-gather {r0['all_gather_ms']:.3f} ms "
          f"(rank 0)", flush=True)
    check(len({x["fit"][k]["digest"] for x in res for k in x["fit"]}) == 1,
          "2. the ranks' fits differ, or differ with and without the consensus hooks")
    rates = {k: v["examples_per_s"] for k, v in r0["fit"].items()}
    out["fit_examples_per_s"] = rates
    print(f"  2. bf16 fit, {args.examples} examples at {128 * world} ({128} a rank), "
          f"augmented, 2 epochs: every rank's state bitwise equal, with the consensus "
          f"hooks and without; epoch ex/s {rates}", flush=True)

    # 3. Against W = 1 here, and the layouts against each other.
    set_scoring_determinism()
    dev = "cuda" if cuda else "cpu"
    set_parity_mode(True)
    lcfg = recipe(load_config, 128, "data.batch_size=128", "train.num_epochs=3",
                  "train.half_precision=false")
    lds, _ = loop.load_data_for(lcfg)
    ref = loop.fit(lcfg, lds, None, device=dev)
    set_parity_mode(False)
    want_losses = [h["train_loss"] for h in ref.history]
    layouts = {}
    for name in ("replicated", "zero1", "sharded"):
        check(len({x["layouts"][name]["digest"] for x in res}) == 1,
              f"3. {name}: the ranks differ")
        with np.load(os.path.join(work, f"layout_{name}.npz")) as f:
            layouts[name] = {k: f[k] for k in f.files}
    got_losses = r0["layouts"]["replicated"]["losses"]
    loss_rel = float(np.max(np.abs(np.asarray(got_losses) - want_losses)
                            / np.abs(want_losses)))
    check(loss_rel <= 1e-5, f"3. losses {got_losses} vs W=1 {want_losses}")
    w1 = {f"params/{k}": v.float().cpu().numpy() for k, v in ref.state.params.items()}
    w1.update({f"batch_stats/{k}": v.float().cpu().numpy()
               for k, v in ref.state.batch_stats.items()})
    var_abs = close_to(layouts["replicated"], w1, 1e-4, 1e-6)
    bitwise = {name: r0["layouts"][name]["digest"] == r0["layouts"]["replicated"]["digest"]
               for name in ("zero1", "sharded")}
    layout_abs = {name: close_to(layouts[name], layouts["replicated"], 1e-4, 1e-6)
                  for name in ("zero1", "sharded")}
    opt = {k: v["optimizer_bytes"] for k, v in r0["layouts"].items()}
    out.update(fp32_loss_rel=loss_rel, fp32_var_max_abs=var_abs, layout_bitwise=bitwise,
               layout_max_abs=layout_abs, optimizer_bytes=opt)
    print(f"  3. fp32, 3 steps at 128: every rank equal in each layout; vs W=1 losses rel "
          f"{loss_rel:.3e}, variables max abs {var_abs:.3e} (rtol 1e-4, atol 1e-6); ZeRO-1 "
          f"and sharded vs replicated: bitwise {bitwise}, max abs {layout_abs}; rank 0 "
          f"optimizer bytes {opt}", flush=True)

    # 4. Scores against W = 1 at the rank's batch.
    sds, _ = load_dataset("synthetic", synthetic_size=args.examples, seed=0)
    model = create_model_from_cfg(recipe(load_config, args.examples))
    variables = [init_variables("resnet18", s, dev) for s in SEEDS]
    nb = -(-args.examples // SCORE_B)
    out["scores"] = {}
    for method, rtol, atol in (("grand", 1e-4, 1e-5), ("el2n", 1e-5, 1e-6)):
        got = [np.load(os.path.join(work, f"scores_{method}_{r}.npy")) for r in range(world)]
        check(all(np.array_equal(got[0], g) for g in got), f"4. {method}: ranks differ")
        want = score_dataset(model, variables, sds, method=method,
                             batch_size=SCORE_B // world, device=dev)
        rel = float(np.max(np.abs(got[0] - want) / np.maximum(np.abs(want), 1e-30)))
        check(bool(np.all(np.abs(got[0] - want) <= rtol * np.abs(want) + atol)),
              f"4. {method} vs W=1: rel {rel:.3e}")
        launches = [{k: v / (nb * len(SEEDS)) for k, v in
                     x["scores"][method]["launches"].items() if v} for x in res]
        per_batch = launches[0]
        if cuda:
            want = ({"conv_grad_norm_direct": 12, "conv_grad_norm_gram": 3}
                    if method == "grand" else {"el2n": 1})
            check(all(x == want for x in launches),
                  f"4. {method}: launches per rank per batch {launches}")
        ex_s = args.examples * len(SEEDS) / r0["scores"][method]["wall_s"]
        out["scores"][method] = {"rel_w1": rel, "ex_per_s": ex_s,
                                 "launches_per_rank_batch": per_batch}
        print(f"  4. {method}: {args.examples} x {len(SEEDS)} seeds at {SCORE_B} "
              f"({SCORE_B // world} a rank): ranks bitwise equal; vs W=1 at "
              f"{SCORE_B // world} max rel {rel:.3e}; per rank per batch per seed "
              f"{per_batch}; {ex_s:.1f} ex/s of the pass, {ex_s / world:.1f} a rank",
              flush=True)

    got = [np.load(os.path.join(work, f"scores_grand_wide_{r}.npy")) for r in range(world)]
    check(all(np.array_equal(got[0], g) for g in got), "4. grand, wide batch: ranks differ")
    want = score_dataset(model, variables, sds, method="grand", batch_size=SCORE_B, device=dev)
    rel = float(np.max(np.abs(got[0] - want) / np.maximum(np.abs(want), 1e-30)))
    check(bool(np.all(np.abs(got[0] - want) <= 1e-4 * np.abs(want) + 1e-5)),
          f"4. grand at {SCORE_B * world} vs W=1 at {SCORE_B}: rel {rel:.3e}")
    ex_s = args.examples * len(SEEDS) / r0["scores"]["grand_wide"]["wall_s"]
    out["scores"]["grand_wide"] = {"rel_w1": rel, "ex_per_s": ex_s}
    print(f"  4. grand at {SCORE_B * world} ({SCORE_B} a rank): ranks bitwise equal; vs W=1 "
          f"at {SCORE_B} max rel {rel:.3e}; {ex_s:.1f} ex/s of the pass, "
          f"{ex_s / world:.1f} a rank", flush=True)
    # One card, the same fit at the rank's batch: what W ranks are held against.
    cfg1 = recipe(load_config, args.examples, "data.batch_size=128", "train.num_epochs=2",
                  "data.augment=true")
    one = loop.fit(cfg1, loop.load_data_for(cfg1)[0], None, device=dev)
    out["fit_one_card_examples_per_s"] = [h["examples_per_s"] for h in one.history]
    out["step"] = {"ranks": [x["step"] for x in res]}
    out["step"]["one_card"], tables1 = step_profile(torch, cuda, cfg1,
                                                    loop.load_data_for(cfg1)[0], dev)
    shutil.copy(os.path.join(work, "profile_rank0.txt"),
                os.path.join(args.out, "multi_card_profile_rank0.txt"))
    with open(os.path.join(args.out, "multi_card_profile_one_card.txt"), "w") as fh:
        fh.write(tables1)
    print(f"  2'. the same fit on one card at batch 128: epoch ex/s "
          f"{out['fit_one_card_examples_per_s']}; a train step (host wall, profiled: wall, "
          f"device ms, busy, NCCL ms, launches): rank 0 of {world} "
          f"{fmt_step(res[0]['step'])}, one card {fmt_step(out['step']['one_card'])}",
          flush=True)

    # 5. The ZeRO-1 checkpoint at W = 1.
    restored = CheckpointManager(os.path.join(work, "zero1_ckpt")).restore(device=dev)
    check(digest(restored) == r0["layouts"]["zero1"]["digest"],
          "5. the ZeRO-1 checkpoint does not restore bitwise at W = 1")
    print("  5. the ZeRO-1 checkpoint restores bitwise at W = 1", flush=True)

    # 6. The CLI across the ranks: whole, SIGTERM to rank 1, hang on rank 1; a resume.
    def drill(name, plan, *extra):
        port = free_port()
        return [spawn(["--drill", str(r), str(world), port, args.device, *DRILL_ARGV,
                       f"train.checkpoint_dir={os.path.join(work, name)}", *extra],
                      os.path.join(work, f"drill_{name}_{len(extra)}_{r}.log"), plan)
                for r in range(world)]
    wave = {"whole": drill("whole", None),
            "sigterm": drill("sigterm", '{"rank": 1, "sigterm_at_epoch_end": 0}'),
            "hang": drill("hang", '{"rank": 1, "hang_at": 5, "hang_seconds": 600}',
                          "resilience.step_timeout_s=15")}
    finish([p for ps in wave.values() for p in ps])
    for p in wave["whole"]:
        check(p["rc"] == 0, f"6. whole: {tail(p)}")
    for p in wave["sigterm"]:
        check(p["rc"] == 75 and "at step 4; checkpoint durable at step 4" in p["log"],
              f"6. sigterm: {tail(p)}")
    for p in wave["hang"]:
        check(p["rc"] == 69, f"6. hang: {tail(p)}")
    hang_s = max(p["t_exit"] for p in wave["hang"]) - min(p["t_exit"] for p in wave["hang"])
    resume = drill("sigterm", None, "train.resume=true")
    finish(resume)
    for p in resume:
        check(p["rc"] == 0, f"6. resume: {tail(p)}")
    whole = ckpt_arrays(os.path.join(work, "whole"))
    again = ckpt_arrays(os.path.join(work, "sigterm"))
    check(whole[0] == again[0] == 12 and whole[1].keys() == again[1].keys()
          and all(np.array_equal(whole[1][k], again[1][k]) for k in whole[1]),
          "6. the resumed run's final step differs from the whole run's")
    out["hang_exit_spread_s"] = hang_s
    print(f"  6. cli train as {world} ranks: whole exit 0; SIGTERM to rank 1 -> every rank "
          f"75 at step 4, durable at 4, the resume bitwise the whole run; a hang on rank 1 "
          f"-> every rank 69, within {hang_s:.1f} s of each other", flush=True)
    out["elastic"] = elastic_step(torch, world, args.device, args.examples, work, load_config)
    # Step 4's vectors are the service's reference on the card (the CPU
    # rehearsal serves tiny_cnn, so there step 8 scores its own).
    out["serve"] = serve_step(world, args.device, args.examples, work,
                              reference=work if cuda else None)
    return finish_run(args, out, work, cards, t_run)


def elastic_step(torch, world: int, device: str, n: int, work: str, load_config) -> dict:
    """Step 7 and its W = 1 reference here; prints its line."""
    from data_diet_distributed_tpu_torch.data.datasets import load_dataset
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
    from data_diet_distributed_tpu_torch.weights import init_variables
    e = elastic_drill(world, device, n, work, load_config)
    cfg = load_config(e["config"], [o for o in e["over"] if not o.startswith("elastic.")])
    dev = "cuda" if device == "cuda" else "cpu"
    ds, _ = load_dataset("synthetic", synthetic_size=n, seed=0)
    variables = [init_variables(cfg.model.arch, s, dev) for s in SEEDS]
    want = score_dataset(create_model_from_cfg(cfg), variables, ds, method="grand",
                         batch_size=-(-cfg.score.batch_size // world), device=dev)
    got = e.pop("scores")
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    check(bool(np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5)),
          f"7. scores vs W=1: rel {rel:.3e}")
    e.update(scores_bitwise_w1=bool(np.array_equal(got, want)), scores_rel_w1=rel)
    print(f"  7. elastic sweep: {e['events']}; worlds {e['worlds']}; attempt 1 resumed at "
          f"step {e['resume']['step']} (world {e['resume']['world']}, saved at "
          f"{e['resume']['saved_world']}); ranks agree per attempt on {e['agreeing_keys']}; "
          f"scores vs W=1 bitwise {e['scores_bitwise_w1']} (max rel {rel:.3e}); chains "
          f"{e['chains']}; supervised wall {e['wall_s']:.1f} s, lost {e['lost_wall_s']} s",
          flush=True)
    return e


def serve_over(device: str, n: int, d: str) -> tuple[str, list[str]]:
    """Step 8's recipe (config, overrides); tiny on the CPU."""
    over = ["data.dataset=synthetic", f"data.synthetic_size={n}", "score.pretrain_epochs=0",
            f"score.seeds={list(SEEDS)}", f"score.batch_size={SCORE_B}",
            f"train.checkpoint_dir={d}/ckpt"]
    if device == "cpu":
        over += ["model.arch=tiny_cnn", "train.half_precision=false"]
    return os.path.join(REPO, "configs", "cifar10_resnet18.yaml"), over


def http(port: int, path: str, body=None) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def served_port(p: dict, budget_s: float = SERVE_BOOT_S) -> int:
    """The port rank 0 announced (its ``obs_server`` record)."""
    t0 = time.time()
    while time.time() - t0 < budget_s:
        check(p["proc"].poll() is None, f"8. a serve rank exited: {p['proc'].poll()}")
        with open(p["log_path"], errors="replace") as fh:
            for line in fh:
                if line.startswith("{") and '"obs_server"' in line:
                    return json.loads(line)["port"]
        time.sleep(0.2)
    fail("8. rank 0 never announced its port")


def drive_service(sp: int, ds, ref: dict) -> dict:
    """One service's numbers: the first whole-dataset pass per method (the first
    ``/v1/topk``), the largest difference of every answer from ``ref`` and
    whether all were bitwise, and p50/p95 per method under load."""
    import threading
    pos = {int(i): k for k, i in enumerate(ds.indices)}

    def truth(m, ids):
        return ref[m][[pos[int(i)] for i in ids]]

    res = {"first_pass_s": {}, "max_abs": {}, "bitwise": True, "latency": {}}

    def note(m, got, want):
        res["max_abs"][m] = max(res["max_abs"].get(m, 0.0), float(np.max(np.abs(got - want))))
        res["bitwise"] &= bool(np.array_equal(got, want))

    rng = np.random.default_rng(8)
    for m in ("grand", "el2n"):
        t0 = time.perf_counter()
        code, raw = http(sp, f"/v1/topk?k=100&method={m}")
        res["first_pass_s"][m] = time.perf_counter() - t0
        items = [json.loads(x) for x in raw.splitlines() if x.strip()]
        order = np.lexsort((ds.indices, -ref[m]))[:100]
        check(code == 200 and len(items) == 100, f"8. /v1/topk {m}: {code}")
        note(m, np.asarray([i["score"] for i in items], np.float32), ref[m][order])
        res["bitwise"] &= [i["index"] for i in items] == ds.indices[order].tolist()
        for size in (100, min(SCORE_B, len(ds))):
            ids = rng.choice(ds.indices, size=size, replace=False)
            code, raw = http(sp, "/v1/score", {"indices": ids.tolist(), "method": m})
            check(code == 200, f"8. /v1/score {m}: {code} {raw[:200]}")
            note(m, np.asarray(json.loads(raw)["scores"], np.float32), truth(m, ids))
        ids = rng.choice(ds.indices, size=100, replace=False)
        code, raw = http(sp, "/v1/rank", {"indices": ids.tolist(), "method": m})
        got = json.loads(raw)
        s = truth(m, ids)
        o = np.lexsort((ids, -s))
        check(code == 200, f"8. /v1/rank {m}: {code}")
        note(m, np.asarray(got["scores"], np.float32), s[o])
        res["bitwise"] &= got["indices"] == ids[o].tolist()
    for m in ("el2n", "grand"):
        ms, bad = [], []

        def client(k: int, m=m, ms=ms, bad=bad) -> None:
            r = np.random.default_rng(100 + k)
            for _ in range(SERVE_REQUESTS):
                ids = r.choice(ds.indices, size=int(r.integers(1, SERVE_MAX_IDS + 1)),
                               replace=False)
                t = time.perf_counter()
                code, raw = http(sp, "/v1/score", {"indices": ids.tolist(), "method": m})
                ms.append((time.perf_counter() - t) * 1e3)
                if code != 200:
                    bad.append(code)
                else:
                    note(m, np.asarray(json.loads(raw)["scores"], np.float32), truth(m, ids))

        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(len(ms) == SERVE_CLIENTS * SERVE_REQUESTS and not bad,
              f"8. {m}: {len(ms)} answers, statuses {bad[:5]}")
        res["latency"][m] = {"p50_ms": float(np.percentile(ms, 50)),
                             "p95_ms": float(np.percentile(ms, 95))}
    return res


def serve_step(world: int, device: str, n: int, work: str, reference: str | None) -> dict:
    """Step 8 (see the module docstring); ``reference`` holds step 4's vectors,
    or None to score them here first. Prints its line; returns its numbers."""
    import signal

    from data_diet_distributed_tpu_torch.config import load_config
    from data_diet_distributed_tpu_torch.train import loop
    d = os.path.join(work, "serve")
    os.makedirs(d, exist_ok=True)
    config, over = serve_over(device, n, d)
    if reference is None:
        reference, port = d, free_port()
        ranks = [spawn(["--score-rank", str(r), str(world), port, d, device, str(n), config,
                        *over], os.path.join(d, f"ref_{r}.log")) for r in range(world)]
        finish(ranks)
        for p in ranks:
            check(p["rc"] == 0, f"8. reference: {tail(p)}")
    ref = {}
    for m in ("grand", "el2n"):
        got = [np.load(os.path.join(reference, f"scores_{m}_{r}.npy")) for r in range(world)]
        check(all(np.array_equal(got[0], g) for g in got), f"8. reference {m}: ranks differ")
        ref[m] = got[0]
    ds, _ = loop.load_data_for(load_config(config, over))
    argv = ["serve", "--config", config, *over, "serve.port=0", "serve.methods=[el2n,grand]",
            "serve.warm=false", "serve.drain_timeout_s=30"]
    out = {}
    for label, w in ((f"w{world}", world), ("w1", 1)):
        metrics = os.path.join(d, f"{label}_metrics.jsonl")
        args = [*argv, f"obs.metrics_path={metrics}"]
        if w > 1:
            port = free_port()
            procs = [spawn(["--drill", str(r), str(w), port, device, *args],
                           os.path.join(d, f"{label}_rank{r}.log")) for r in range(w)]
        else:
            procs = [spawn(["--drill", "0", "1", free_port(), device, *args],
                           os.path.join(d, f"{label}_rank0.log"))]
        t0 = time.time()
        try:
            sp = served_port(procs[0])
            res = drive_service(sp, ds, ref)
            res["boot_s"] = time.time() - t0
        except BaseException:
            for p in procs:
                p["proc"].kill()
            raise
        procs[0]["proc"].send_signal(signal.SIGTERM)
        finish(procs)
        rcs = [p["rc"] for p in procs]
        check(rcs == [75] * w, f"8. {label}: exits {rcs}: " + tail(procs[0]))
        if w > 1:
            check(res["bitwise"], f"8. W = {w}: an answer differs from score_dataset at "
                                  f"W = {w}: max abs {res['max_abs']}")
        res["exits"] = rcs
        out[label] = res
    big, one = out[f"w{world}"], out["w1"]
    print(f"  8. cli serve as {world} ranks: every answer bitwise score_dataset on the same "
          f"{world} ranks at {SCORE_B}; first whole-dataset pass (topk) "
          f"{ {m: round(v, 3) for m, v in big['first_pass_s'].items()} } s against "
          f"{ {m: round(v, 3) for m, v in one['first_pass_s'].items()} } s on one card; p50/p95 "
          f"ms { {m: (round(v['p50_ms'], 2), round(v['p95_ms'], 2)) for m, v in big['latency'].items()} } "
          f"against { {m: (round(v['p50_ms'], 2), round(v['p95_ms'], 2)) for m, v in one['latency'].items()} }; "
          f"one card's max abs from the W-rank vectors {one['max_abs']}; SIGTERM -> every "
          f"rank 75", flush=True)
    return out


FLEET_RANKS = 2                # ranks a replica of step 10's fleet of meshes
FLEET_BOOT_S = 600


def fleet_records(path: str) -> list[dict]:
    out = []
    if os.path.exists(path):
        with open(path, errors="replace") as fh:
            for line in fh:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out


def card_evidence(pids: list[int]) -> dict:
    """Where the ranks run, from outside them: each process's
    ``CUDA_VISIBLE_DEVICES``; which cards (``nvidia-smi`` indices) such a
    list means, asked of a CUDA process started with it (``uuid`` of each
    visible device against ``nvidia-smi --query-gpu=index,uuid``); the memory
    in use per card; and the contexts ``nvidia-smi --query-compute-apps``
    attributes per card (reported only: in a container it may name other
    pids and cards)."""
    def smi(query: str) -> list[list[str]]:
        out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60).stdout
        return [[x.strip() for x in line.split(",")] for line in out.strip().splitlines()]
    gpus = smi("--query-gpu=index,uuid,pci.bus_id,memory.used")
    by_uuid = {u.lower().removeprefix("gpu-"): int(i) for i, u, _, _ in gpus}
    by_bus = {b: int(i) for i, _, b, _ in gpus}
    apps: dict[int, int] = {}
    for _, bus in smi("--query-compute-apps=pid,gpu_bus_id"):
        apps[by_bus.get(bus, -1)] = apps.get(by_bus.get(bus, -1), 0) + 1
    visible = {}
    for pid in pids:
        with open(f"/proc/{pid}/environ", "rb") as fh:
            pairs = [x.split(b"=", 1) for x in fh.read().split(b"\0") if b"=" in x]
        visible[pid] = dict(pairs).get(b"CUDA_VISIBLE_DEVICES", b"").decode()
    means = {}
    for v in sorted(set(visible.values())):
        probe = subprocess.run(
            [sys.executable, "-c", "import torch; print(' '.join(str(torch.cuda."
             "get_device_properties(i).uuid) for i in range(torch.cuda.device_count())))"],
            env={**os.environ, "CUDA_VISIBLE_DEVICES": v}, capture_output=True, text=True,
            timeout=120)
        means[v] = [by_uuid.get(u.lower().removeprefix("gpu-"), -1)
                    for u in probe.stdout.split()]
    return {"visible_by_pid": visible, "cards_of_visible": means,
            "memory_used_mib": {int(i): float(m) for i, _, _, m in gpus},
            "apps_per_card_reported": dict(sorted(apps.items()))}


FLEET_STATS_S = 1.0           # serve.stats_every_s: the cadence of the ranks' launch gather
#: A card that took a rank's CUDA context rises by at least this much memory
#: (a context with the port's kernels and the model on an H100 is ~800 MiB).
CONTEXT_MIB = 256.0


def card_memory() -> dict[int, float]:
    """``nvidia-smi``'s memory in use per card (MiB), by card index."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=index,memory.used",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout
    return {int(i): float(m) for i, m in (line.split(",") for line in out.strip().splitlines())}


def dispatch_launches(port: int, ds) -> list[dict]:
    """Each rank's kernel launches for one ``SCORE_B``-id GraNd and one EL2N
    dispatch on the replica answering at ``port``: ``/status``
    ``rank_kernel_launches`` (gathered at each stats point) across them."""
    def snap() -> list[dict]:
        time.sleep(2.5 * FLEET_STATS_S)
        code, raw = http(port, "/status")
        check(code == 200, f"10. /status of replica port {port}: {code}")
        return json.loads(raw)["rank_kernel_launches"]
    before = snap()
    for m in ("grand", "el2n"):
        code, raw = http(port, "/v1/score", {"indices": ds.indices[:SCORE_B].tolist(),
                                             "method": m})
        check(code == 200, f"10. a {m} dispatch on port {port}: {code}")
    after = snap()
    return [{k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
            for a, b in zip(after, before)]


def fleet_run(label: str, d: str, argv: list[str], device: str, ds, ref: dict,
              ranks: int, kill: bool) -> dict:
    """One ``cli serve`` fleet of step 10: booted, placed, driven through the
    router (every answer held bitwise to ``ref``), optionally the kill drill,
    then SIGTERMed. Returns its numbers."""
    import importlib.util
    import signal
    import threading
    spec = importlib.util.spec_from_file_location(
        "serve_client", os.path.join(REPO, "tools", "serve_client.py"))
    sc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sc)
    metrics = os.path.join(d, f"{label}_metrics.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "DDT_FAULT_PLAN"}
    env["PYTHONPATH"] = REPO
    log = open(os.path.join(d, f"{label}_supervisor.log"), "w")
    mem_before = card_memory() if device == "cuda" else {}
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve", "--device",
         device, *argv, f"obs.metrics_path={metrics}",
         f"train.checkpoint_dir={d}/{label}_ckpt"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    res: dict = {}
    try:
        def wait_for(pred, what, budget):
            end = time.time() + budget
            while time.time() < end:
                check(proc.poll() is None, f"10. {label}: the supervisor exited {proc.poll()}")
                hit = next((r for r in fleet_records(metrics) if pred(r)), None)
                if hit is not None:
                    return hit
                time.sleep(0.2)
            fail(f"10. {label}: no {what} within {budget} s")

        launch = wait_for(lambda r: r.get("kind") == "serve_fleet"
                          and r.get("event") == "launch", "launch", 120)
        rport = launch["router_port"]
        probe = sc.ServeClient(f"http://127.0.0.1:{rport}", timeout_s=5.0)

        def available(n: int) -> float:
            end = time.time() + FLEET_BOOT_S
            while time.time() < end:
                check(proc.poll() is None, f"10. {label}: the supervisor exited")
                try:
                    if probe.healthz().get("available") == n:
                        return time.time()
                except sc.ServeError:
                    pass
                time.sleep(0.1)
            fail(f"10. {label}: never {n} routable replicas")

        replicas = launch["replicas"]
        res["boot_s"] = available(replicas) - t0
        spawns = sorted((r for r in fleet_records(metrics) if r.get("kind") == "replica_event"
                         and r.get("event") == "spawn"), key=lambda r: r["replica"])
        res["placement"] = launch["placement"]
        if device == "cuda":
            mem_after = card_memory()   # before the probes below open contexts
            ev = card_evidence([p for r in spawns for p in r["pids"]])
            res["cards"] = ev
            want = [[int(c) for c in cards] for cards in launch["placement"]]
            # Rank r of a replica takes cuda:r of its visible list
            # (parallel/mesh.py), so it runs on cards_of_visible[...][r].
            got = [[ev["cards_of_visible"][ev["visible_by_pid"][p]][r]
                    for r, p in enumerate(rec["pids"])] for rec in spawns]
            check(all(len(cards) == ranks for cards in want) and got == want,
                  f"10. {label}: placed {want}, ranks on cards {got}: {ev}")
            # From the cards' side: every placed card took a context, no other did.
            rise = {c: mem_after[c] - mem_before.get(c, 0.0) for c in mem_after}
            placed = {c for cards in want for c in cards}
            res["memory_rise_mib"] = rise
            check(all(rise[c] >= CONTEXT_MIB for c in placed)
                  and all(rise[c] < CONTEXT_MIB for c in rise if c not in placed),
                  f"10. {label}: memory in use rose {rise} MiB a card; placed {sorted(placed)}")
        res.update(drive_service(rport, ds, ref))
        check(res["bitwise"], f"10. {label}: an answer differs from score_dataset at "
                              f"W = {ranks}: max abs {res['max_abs']}")
        res["dispatch_launches"] = dispatch_launches(spawns[0]["port"], ds)
        # On the CPU the kernels' plain versions run and count nothing.
        check(len(res["dispatch_launches"]) == ranks
              and (device != "cuda" or all(res["dispatch_launches"])),
              f"10. {label}: a rank launched nothing: {res['dispatch_launches']}")
        if kill:
            victim = spawns[1]["pids"][1]
            errors, answers, stop = [], [], threading.Event()
            pos = {int(i): k for k, i in enumerate(ds.indices)}

            def client(k: int) -> None:
                c = sc.ServeClient(f"http://127.0.0.1:{rport}", timeout_s=120.0, retries=6,
                                   backoff_s=0.25)
                r = np.random.default_rng(300 + k)
                while not stop.is_set():
                    m = ("grand", "el2n")[len(answers) % 2]
                    ids = r.choice(ds.indices, size=int(r.integers(1, SERVE_MAX_IDS + 1)),
                                   replace=False)
                    try:
                        got = np.asarray(c.score(indices=ids.tolist(), method=m)["scores"],
                                         np.float32)
                        answers.append(np.array_equal(
                            got, ref[m][[pos[int(i)] for i in ids]]))
                    except Exception as exc:   # noqa: BLE001 — counted, then failed on
                        errors.append(repr(exc)[:200])

            threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
            for t in threads:
                t.start()
            time.sleep(2.0)
            os.kill(victim, signal.SIGKILL)
            died = wait_for(lambda r: r.get("kind") == "replica_event"
                            and r.get("event") == "died", "died", 120)
            respawn = wait_for(lambda r: r.get("kind") == "replica_event"
                               and r.get("event") == "respawn", "respawn", 120)
            back = available(replicas)
            time.sleep(1.0)
            stop.set()
            for t in threads:
                t.join(300)
            check(errors == [], f"10. {label}: client-visible failures: {errors[:3]}")
            check(answers and all(answers), f"10. {label}: {answers.count(False)} of "
                                            f"{len(answers)} answers through the kill differ")
            check(died["replica"] == 1 and died.get("rank") == 1 and died["signal"] == 9,
                  f"10. {label}: died {died}")
            check(respawn["replica"] == 1 and respawn["port"] == spawns[1]["port"]
                  and respawn["coordinator"] != spawns[1]["coordinator"],
                  f"10. {label}: respawn {respawn}")
            res["kill"] = {"requests": len(answers), "died": died, "respawn": respawn,
                           "respawn_wall_s": back - died["ts"],
                           "reap_s": respawn["ts"] - died["ts"]}
        proc.send_signal(signal.SIGTERM)
        res["rc"] = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        log.close()
    recs = fleet_records(metrics)
    ended = next((r for r in recs if r.get("kind") == "serve_fleet"
                  and r.get("event") == "preempted_exit"), {})
    res["rank_rcs"] = ended.get("rank_rcs") or ended.get("rcs")
    check(res["rc"] == 75 and recs and recs[-1].get("exit_class") == "preempted",
          f"10. {label}: exit {res['rc']}, last record {recs[-1:]}")
    flat = [x for v in res["rank_rcs"] for x in (v if isinstance(v, list) else [v])]
    check(flat and all(x == 75 for x in flat), f"10. {label}: ranks exited {res['rank_rcs']}")
    return res


def fleet_mesh_step(world: int, device: str, n: int, work: str) -> dict:
    """Step 10 (see the module docstring). Prints its lines; returns its numbers."""
    from data_diet_distributed_tpu_torch.config import load_config
    from data_diet_distributed_tpu_torch.train import loop
    check(world % FLEET_RANKS == 0, f"10. {world} ranks do not tile replicas of "
                                    f"{FLEET_RANKS}")
    d = os.path.join(work, "fleet_mesh")
    os.makedirs(d, exist_ok=True)
    config, over = serve_over(device, n, d)
    # The references at once: score_dataset on two ranks and on one.
    groups = {}
    for w in (FLEET_RANKS, 1):
        port, out = free_port(), os.path.join(d, f"ref_w{w}")
        os.makedirs(out)
        groups[w] = [spawn(["--score-rank", str(r), str(w), port, out, device, str(n), config,
                            *over], os.path.join(out, f"rank{r}.log")) for r in range(w)]
    for w, ranks in groups.items():
        finish(ranks)
        for p in ranks:
            check(p["rc"] == 0, f"10. reference W = {w}: {tail(p)}")
    refs = {}
    for w in groups:
        refs[w] = {}
        for m in ("grand", "el2n"):
            got = [np.load(os.path.join(d, f"ref_w{w}", f"scores_{m}_{r}.npy"))
                   for r in range(w)]
            check(all(np.array_equal(got[0], g) for g in got), f"10. reference {m}: differ")
            refs[w][m] = got[0]
    ds, _ = loop.load_data_for(load_config(config, over))
    base = [*over, "--config", config, "serve.methods=[el2n,grand]", "serve.warm=false",
            "serve.router_port=0", "serve.port=0", "serve.health_poll_s=0.25",
            "serve.breaker_reset_s=0.5", "serve.drain_timeout_s=30",
            f"serve.stats_every_s={FLEET_STATS_S}",
            "serve.request_timeout_s=300", "elastic.max_restarts=2", "elastic.backoff_s=0.2"]
    out = {"mesh": fleet_run("mesh", d, [*base, f"serve.replicas={world // FLEET_RANKS}",
                                         "mesh.multihost=true",
                                         f"mesh.num_processes={FLEET_RANKS}"],
                             device, ds, refs[FLEET_RANKS], FLEET_RANKS, kill=True)}
    m = out["mesh"]
    print(f"  10. fleet of {world // FLEET_RANKS} meshes of {FLEET_RANKS} ranks, placed "
          f"{m['placement']} (on the cards: {m.get('cards')}): every answer "
          f"through the router bitwise score_dataset on {FLEET_RANKS} ranks at {SCORE_B}; "
          f"p50/p95 ms { {k: (round(v['p50_ms'], 2), round(v['p95_ms'], 2)) for k, v in m['latency'].items()} }; "
          f"each rank's launches a {SCORE_B}-id GraNd + EL2N dispatch "
          f"{m['dispatch_launches']}; "
          f"rank 1 of replica 1 SIGKILLed under {m['kill']['requests']} keyed requests: 0 "
          f"failures, peers reaped and the group respawned {m['kill']['reap_s']:.2f} s after "
          f"the death, routable {m['kill']['respawn_wall_s']:.1f} s after it; SIGTERM -> "
          f"{m['rank_rcs']}; boot {m['boot_s']:.1f} s", flush=True)
    out["plain"] = fleet_run("plain", d, [*base, f"serve.replicas={world}"], device, ds,
                             refs[1], 1, kill=False)
    p = out["plain"]
    print(f"  10. {world} plain replicas placed {p['placement']} (on the cards: "
          f"{p.get('cards')}): every answer bitwise "
          f"score_dataset on one rank at {SCORE_B}; a dispatch's launches "
          f"{p['dispatch_launches']}; p50/p95 ms "
          f"{ {k: (round(v['p50_ms'], 2), round(v['p95_ms'], 2)) for k, v in p['latency'].items()} }; "
          f"SIGTERM -> {p['rank_rcs']}; boot {p['boot_s']:.1f} s", flush=True)
    return out


TP_MODEL = 2                   # mesh.model_axis of step 9
TP_SEEDS = (0, 1, 2)           # config 4's score.seeds
TP_CLASSES = 100


def tp_data(d: str, n: int) -> str:
    """``n`` train and ``n // 4`` test examples of synthetic CIFAR-100-geometry
    data (a fixed template per class plus noise, seed 0) as npz in ``d``."""
    rng = np.random.default_rng(0)
    total = n + n // 4
    templates = rng.normal(0.0, 0.5, size=(TP_CLASSES, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, TP_CLASSES, size=total).astype(np.int32)
    images = templates[labels] + rng.normal(0.0, 0.4, size=(total, 32, 32, 3)).astype(
        np.float32)
    os.makedirs(d, exist_ok=True)
    for split, rows in (("train", slice(0, n)), ("test", slice(n, None))):
        np.savez(os.path.join(d, f"{split}.npz"), images=images[rows], labels=labels[rows])
    return d


def tp_rank(rank: int, world: int, port: str, port2: str, out: str, device: str,
            cli_argv: list[str]) -> None:
    """One rank of step 9 (``world`` 1: the one-card run): train steps of the
    recipe profiled in a group of their own (joined at ``port``), then ``cli
    run``, joined through the ``mesh`` keys at ``port2`` at ``world`` > 1,
    with each fit's head shapes, the launches and the wall recorded, and on
    rank 0 the pretrained variables of every seed and the profile tables."""
    import torch

    from data_diet_distributed_tpu_torch import cli
    from data_diet_distributed_tpu_torch.config import MeshConfig, load_config
    from data_diet_distributed_tpu_torch.ops import kernels
    from data_diet_distributed_tpu_torch.parallel import mesh
    from data_diet_distributed_tpu_torch.train import loop
    cuda = device == "cuda"
    model_axis = TP_MODEL if world > 1 else 1
    mesh.initialize_multihost(MeshConfig(multihost=True, model_axis=model_axis,
                                         coordinator_address=f"127.0.0.1:{port}",
                                         num_processes=world, process_id=rank),
                              None if cuda else "cpu")
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    config = cli_argv[cli_argv.index("--config") + 1]
    cfg = load_config(config, [a for a in cli_argv if "=" in a]
                      + [f"mesh.model_axis={model_axis}"])
    ds, _ = loop.load_data_for(cfg)
    step, tables = step_profile(torch, cuda, cfg, ds, dev)
    if rank == 0:
        with open(os.path.join(out, f"tp_profile_w{world}.txt"), "w") as fh:
            fh.write(tables)
    mesh.shutdown()
    heads: list = []
    real_fit, real_vars = loop.fit, loop.score_variables_for_seeds

    def fit(*a, **kw):
        res = real_fit(*a, **kw)
        heads.append([kw.get("tag"), list(res.state.params["classifier.weight"].shape),
                      list(res.state.momentum["classifier.weight"].shape)])
        return res

    def score_variables_for_seeds(*a, **kw):
        got = real_vars(*a, **kw)
        if rank == 0:
            for k, v in enumerate(got):
                torch.save({n: t.float().cpu() for n, t in v.items()},
                           os.path.join(out, f"pretrained_w{world}_seed{k}.pt"))
        return got

    loop.fit, loop.score_variables_for_seeds = fit, score_variables_for_seeds
    argv = list(cli_argv)
    if world > 1:
        argv += ["mesh.multihost=true", f"mesh.coordinator_address=127.0.0.1:{port2}",
                 f"mesh.num_processes={world}", f"mesh.process_id={rank}",
                 f"mesh.model_axis={TP_MODEL}"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "--device", device])
    with open(os.path.join(out, f"tp_w{world}_rank{rank}.json"), "w") as fh:
        json.dump({"rc": rc, "wall_s": time.perf_counter() - t0, "heads": heads,
                   "launches": kernels.launch_counts(), "step": step}, fh)
    sys.stdout.flush()
    os._exit(rc)


def tp_step(torch, world: int, device: str, n: int, work: str, out_dir: str) -> dict:
    """Step 9 (see the module docstring). Prints its line; returns its numbers."""
    from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
    from data_diet_distributed_tpu_torch.config import load_config
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
    from data_diet_distributed_tpu_torch.train import loop
    check(world % TP_MODEL == 0, f"9. {world} ranks do not tile model_axis={TP_MODEL}")
    d = os.path.join(work, "tp")
    data = tp_data(os.path.join(d, "npz"), n)
    config = os.path.join(REPO, "configs", "cifar100_wrn28_10.yaml")
    over = ["data.dataset=npz", f"data.data_dir={data}", "score.pretrain_epochs=1",
            "train.num_epochs=1", f"score.batch_size={SCORE_B}",
            f"score.seeds=[{','.join(str(s) for s in TP_SEEDS)}]", "prune.sparsity=0.5",
            "obs.xla_introspect=false"]
    if device == "cpu":
        over += ["model.arch=tiny_cnn", "train.half_precision=false"]
    out: dict = {}
    for w in (world, 1):
        label = f"w{w}"
        argv = ["run", "--config", config, *over, f"train.checkpoint_dir={d}/{label}_ckpt",
                f"obs.metrics_path={d}/{label}_metrics.jsonl"]
        ports = (free_port(), free_port())
        procs = [spawn(["--tp-rank", str(r), str(w), *ports, d, device, *argv],
                       os.path.join(d, f"{label}_rank{r}.log")) for r in range(w)]
        finish(procs)
        for p in procs:
            check(p["rc"] == 0, f"9. W = {w}: {tail(p)}")
        ranks = []
        for r in range(w):
            with open(os.path.join(d, f"tp_{label}_rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        recs = [json.loads(x) for x in open(os.path.join(d, f"{label}_metrics.jsonl"))
                if x.startswith("{")]
        summary = next(x for x in recs if x["kind"] == "summary")
        with np.load(loop.scores_npz_path(f"{d}/{label}_ckpt")) as f:
            scores = f["scores"]
        out[label] = {"wall_s": ranks[0]["wall_s"], "heads": [x["heads"] for x in ranks],
                      "step": [x["step"] for x in ranks],
                      "launches": [x["launches"] for x in ranks], "scores": scores,
                      "epochs": [(x["tag"], x["examples_per_s"]) for x in recs
                                 if x["kind"] == "epoch"],
                      **{k: summary[k] for k in ("pretrain_wall_s", "score_wall_s",
                                                 "train_wall_s", "n_kept")}}
    big, one = out[f"w{world}"], out["w1"]
    for w in (world, 1):
        shutil.copy(os.path.join(d, f"tp_profile_w{w}.txt"),
                    os.path.join(out_dir, f"multi_card_tp_profile_w{w}.txt"))
    cfg = load_config(config, [*over, f"train.checkpoint_dir={d}/w{world}_ckpt"])
    ds, _ = loop.load_data_for(cfg)
    rows = cfg.model.num_classes // TP_MODEL
    for r, heads in enumerate(big["heads"]):
        check([h[0] for h in heads] == [f"score_pretrain_seed{s}" for s in TP_SEEDS]
              + ["final"], f"9. rank {r}: fits {heads}")
        check(all(h[1][0] == rows and h[2][0] == rows for h in heads),
              f"9. rank {r}: head rows {heads}")
    check(all(h[1][0] == cfg.model.num_classes for h in one["heads"][0]),
          f"9. W = 1: head rows {one['heads']}")
    check(big["n_kept"] == one["n_kept"] == n // 2, f"9. n_kept {big['n_kept']}")
    dev = "cuda" if device == "cuda" else "cpu"
    pre = [torch.load(os.path.join(d, f"pretrained_w{world}_seed{k}.pt"))
           for k in range(len(TP_SEEDS))]
    # At the rank's batch: in bf16 a WRN's scores move with the batch's geometry.
    want = score_dataset(create_model_from_cfg(cfg), pre, ds, method=cfg.score.method,
                         batch_size=SCORE_B // world, chunk=cfg.score.grand_chunk,
                         eval_mode=cfg.score.eval_mode, use_kernels=cfg.score.use_pallas,
                         device=dev)
    err = np.abs(big["scores"] - want)
    check(bool(np.all(err <= 1e-4 * np.abs(want) + 1e-5)),
          f"9. the W-rank scores are {float(err.max()):.3e} from W = 1 on their variables")
    for r, got in enumerate(big["launches"]):
        check(got == one["launches"][0],
              f"9. rank {r}: launches {got}, W = 1 {one['launches'][0]}")
    final = CheckpointManager(f"{d}/w{world}_ckpt").restore_variables(device="cpu")
    check(final["classifier.weight"].shape[0] == cfg.model.num_classes,
          "9. the final checkpoint's head is not whole")
    res = {"mesh": {"data": world // TP_MODEL, "model": TP_MODEL},
           "max_abs_vs_w1_same_variables": float(err.max()),
           "max_abs_vs_one_card_run": float(np.max(np.abs(big["scores"] - one["scores"]))),
           "launches_per_rank": big["launches"][0], "launches_w1": one["launches"][0]}
    for label, x in out.items():
        res[label] = {k: x[k] for k in ("wall_s", "pretrain_wall_s", "score_wall_s",
                                        "train_wall_s", "n_kept", "epochs", "step")}
    print(f"  9. cli run of config 4 as {{data: {world // TP_MODEL}, model: {TP_MODEL}}}: "
          f"every rank ends each fit with {rows} rows of the head; {world} ranks in "
          f"{big['wall_s']:.1f} s (pretrain {big['pretrain_wall_s']:.1f}, score "
          f"{big['score_wall_s']:.1f}, retrain {big['train_wall_s']:.1f}) against one card's "
          f"{one['wall_s']:.1f} s ({one['pretrain_wall_s']:.1f}, {one['score_wall_s']:.1f}, "
          f"{one['train_wall_s']:.1f}); scores within {float(err.max()):.3e} of W = 1 on "
          f"the same variables at {SCORE_B // world} rows a batch, "
          f"{res['max_abs_vs_one_card_run']:.3e} from the one card's "
          f"own run; launches a rank {big['launches'][0]}; epochs {big['epochs']} against "
          f"{one['epochs']} ex/s; a train step (wall ms (profiled, device, busy, NCCL, "
          f"launches)) on each rank {[fmt_step(x) for x in big['step']]} against one card's "
          f"{fmt_step(one['step'][0])}", flush=True)
    return res


def finish_run(args, out: dict, work: str, cards: list[str], t_run: float) -> int:
    out["wall_s"] = time.perf_counter() - t_run
    with open(os.path.join(args.out, "multi_card.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    shutil.rmtree(work, ignore_errors=True)
    for card in cards:
        print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
