#!/usr/bin/env python3
"""The PyTorch port across every card of one machine, one rank a card over NCCL.

    python3 tools/multi_card.py [--out DIR]                # W = every visible card
    python3 tools/multi_card.py --device cpu --world 4 --examples 512  # gloo rehearsal

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
   (bitwise the whole run); a hang on rank 1 (every rank exits 69).

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
    from data_diet_distributed_tpu_torch.parallel.mesh import image_slice
    from data_diet_distributed_tpu_torch.train.state import (create_train_state,
                                                             make_optimizer)
    from data_diet_distributed_tpu_torch.train.steps import train_step

    model = create_model_from_cfg(cfg).to(dev)
    state = create_train_state(cfg, 0, dev, model)
    sgd = make_optimizer(cfg, 64)
    batches = list(ResidentBatches(ds, cfg.data.batch_size, dev, torch.bfloat16,
                                   image_slice())())
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
    from data_diet_distributed_tpu_torch.ops import kernels as K
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
    score_dataset(model, variables[:1], sds.subset(sds.indices[:SCORE_B]), method="grand",
                  batch_size=SCORE_B, device=dev)   # warm-up
    res["scores"] = {}
    for method in ("grand", "el2n"):
        K.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = score_dataset(model, variables, sds, method=method, batch_size=SCORE_B,
                               device=dev)
        res["scores"][method] = {"wall_s": time.perf_counter() - t0,
                                 "launches": K.launch_counts()}
        np.save(os.path.join(out, f"scores_{method}_{rank}.npy"), scores)
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--world", type=int, default=None,
                        help="ranks (default: every visible card; required with --device cpu)")
    parser.add_argument("--examples", type=int, default=8192)
    parser.add_argument("--out", default=os.path.join(REPO, "chip_smoke_out"))
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
