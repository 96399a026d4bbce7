"""One rank of the PyTorch port's multi-process CPU tests (gloo).

    python tests/torch_dist_worker.py RANK WORLD PORT OUT_DIR GROUP

imports only the port (never JAX), joins a gloo group on
``127.0.0.1:PORT`` through ``parallel.mesh.initialize_multihost``, runs the
scenarios of GROUP and writes ``OUT_DIR/result_<RANK>.npz`` and
``OUT_DIR/result_<RANK>.json``:

* ``numerics`` (``test_torch_dist.py``): three training steps of the narrow
  ResNet from ``OUT_DIR/inputs.npz`` with injected augmentation draws,
  replicated, under ZeRO-1 and under the sharded update, with and without a
  gradient clip; EL2N and GraNd ``score_dataset`` in both BatchNorm modes
  and both data planes; ``evaluate``; a ZeRO-1 ``fit`` whose checkpoint the
  test restores in one process; AUM ``trajectory_scores``.
* ``drills`` (``test_torch_consensus.py``): rank-1 SIGTERM and the resume,
  rank-1 NaN through ``fit_with_recovery``, and the min-agreed restore.
* ``hang``: a rank-1 hang; rank 1 exits 69 from its watchdog, rank 0 from
  the peer's poison or its escalation.
* ``serve`` (``test_torch_serve_mesh.py``): a ``ServeEngine`` of the narrow
  ResNet on each rank; the warm passes together, then rank 0 leads (partial
  and full blocks, ``topk``, ``rank``, refreshes to a good, a truncated and
  a step rank 1 refuses to restore, the launches gather) while rank 1
  follows; then ``score_dataset`` at W = 2 on the boot and the refreshed
  variables.
* ``tp`` (``test_torch_tensor_parallel.py``, W = 4 joined as ``{data: 2,
  model: 2}``): three training steps of tiny_cnn from ``OUT_DIR/inputs.npz``
  in the tensor-parallel layout (replicated, ZeRO-1, a global clip norm
  under the sharded update, and with ``copy_to_model`` turned into the
  identity) and in the ``{data: 4}`` layout of the same ranks; ``evaluate``;
  EL2N and GraNd ``score_dataset`` on the flat grid; forgetting
  ``trajectory_scores``; a ZeRO-1 ``fit`` through the local tier; then the
  group is left and ``cli run`` joins a new one with ``mesh.multihost=true
  mesh.model_axis=2``, each fit's head shapes recorded.
* ``fleet_ref`` (``test_torch_serve_fleet_mesh.py``): EL2N and GraNd
  ``score_dataset`` at W = 2 of the served configuration whose overrides
  ``OUT_DIR/args.json`` holds, on the checkpoint ``score.score_ckpt_step``
  it serves.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)

from data_diet_distributed_tpu_torch.config import MeshConfig, load_config  # noqa: E402
from data_diet_distributed_tpu_torch.data import augment as augment_mod  # noqa: E402
from data_diet_distributed_tpu_torch.data.datasets import (ArrayDataset,  # noqa: E402
                                                           load_dataset)
from data_diet_distributed_tpu_torch.data.pipeline import (iterate_batches,  # noqa: E402
                                                           local_rows, to_device)
from data_diet_distributed_tpu_torch.models import (BasicBlock, ResNet,  # noqa: E402
                                                    create_model)
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset  # noqa: E402
from data_diet_distributed_tpu_torch.parallel import mesh  # noqa: E402
from data_diet_distributed_tpu_torch.resilience import inject  # noqa: E402
from data_diet_distributed_tpu_torch.resilience.consensus import PeerPoisoned  # noqa: E402
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted  # noqa: E402
from data_diet_distributed_tpu_torch.resilience.sentinel import DivergenceError  # noqa: E402
from data_diet_distributed_tpu_torch.resilience.watchdog import WatchdogTimeout  # noqa: E402
from data_diet_distributed_tpu_torch.train import loop  # noqa: E402
from data_diet_distributed_tpu_torch.train.state import (gather_slots,  # noqa: E402
                                                         make_optimizer, optimizer_bytes,
                                                         shard_slots, state_from_variables)
from data_diet_distributed_tpu_torch.train.steps import train_step  # noqa: E402

EXIT_PREEMPTED, EXIT_RETRIABLE, EXIT_DIVERGED = 75, 69, 13
TRAIN_OVER = ["train.num_epochs=1", "optim.lr=0.1", "optim.weight_decay=0.01",
              "train.half_precision=false"]


def _group(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items()
            if k.startswith(prefix)}


def three_steps(inputs: dict, over: list[str]) -> dict:
    """Three steps of the narrow ResNet on the rank's rows, with the test's
    augmentation draws; the whole (gathered) state and per-step metrics."""
    draws = {s: (torch.from_numpy(inputs["flips"][s]), torch.from_numpy(inputs["offsets"][s]))
             for s in range(3)}
    augment_mod.draw_augment = lambda seed, step, batch, crop_pad=4, flip=True: draws[step]
    cfg = load_config(None, [*TRAIN_OVER, *over])
    model = ResNet((1, 1, 1, 1), BasicBlock, width=16)
    ds = ArrayDataset(inputs["x"], inputs["y"], np.arange(len(inputs["y"]), dtype=np.int32),
                      10)
    rows = mesh.batch_slice()
    state = state_from_variables(_group(inputs, "var/"), model)
    sgd = make_optimizer(cfg, 3)
    state = shard_slots(state, sgd)
    slot_bytes = optimizer_bytes(state)
    metrics = []
    for b in iterate_batches(ds, 16, image_slice=rows):
        m = train_step(model, sgd, state, to_device(local_rows(b, rows), "cpu"),
                       augment=(4, True, 0))
        metrics.append([float(m["loss"]), float(m["correct"]), float(m["examples"])])
    whole = gather_slots(state, sgd)
    out = {f"{g}/{k}": v.numpy().copy() for g in ("params", "batch_stats", "momentum")
           for k, v in getattr(whole, g).items()}
    out["metrics"] = np.asarray(metrics)
    out["slot_bytes"] = np.asarray(slot_bytes)
    return out


def numerics(out_dir: str) -> dict:
    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    result = {}
    for name, over in (("replicated", []), ("zero1", ["mesh.shard_opt_state=true"]),
                       ("sharded", ["mesh.shard_weight_update=true"]),
                       ("replicated_clip", ["optim.grad_clip_norm=0.5"]),
                       ("sharded_clip", ["optim.grad_clip_norm=0.5",
                                         "mesh.shard_weight_update=true"])):
        for k, v in three_steps(inputs, over).items():
            result[f"{name}:{k}"] = v
    ds = ArrayDataset(inputs["score_x"], inputs["score_y"], inputs["score_idx"], 10)
    seeds = [_group(inputs, f"s{s}/") for s in (0, 1)]
    model = create_model("tiny_cnn", 10)
    for method in ("el2n", "grand"):
        for eval_mode in (True, False):
            key = f"score:{method}:{'eval' if eval_mode else 'train'}"
            for resident in (True, False):
                scores = score_dataset(model, seeds, ds, method=method, batch_size=15,
                                       chunk=4, eval_mode=eval_mode, device="cpu",
                                       device_resident=resident)
                result[f"{key}:{'resident' if resident else 'stream'}"] = scores
    ev = loop.evaluate(model, state_from_variables(seeds[0], model), ds, 15, device="cpu")
    result["eval"] = np.asarray([ev["loss"], ev["accuracy"], ev["examples"]])
    cfg = load_config(None, ["data.dataset=synthetic", "data.synthetic_size=64",
                             "data.batch_size=32", "model.arch=tiny_cnn",
                             "train.num_epochs=1", "train.half_precision=false",
                             "mesh.shard_opt_state=true",
                             f"train.checkpoint_dir={out_dir}/ckpt"])
    train_ds, _ = loop.load_data_for(cfg)
    res = loop.fit(cfg, train_ds, None, device="cpu", checkpoint_dir=cfg.train.checkpoint_dir)
    whole = gather_slots(res.state, make_optimizer(cfg, 2))
    for g in ("params", "batch_stats", "momentum"):
        for k, v in getattr(whole, g).items():
            result[f"fit:{g}/{k}"] = v.numpy().copy()
    result["fit:step"] = np.asarray(res.state.step)
    traj = load_config(None, [str(o) for o in inputs["traj_over"]]
                       + [f"train.checkpoint_dir={out_dir}/traj"])
    traj_ds, _ = loop.load_data_for(traj)
    result["aum"] = loop.trajectory_scores(traj, traj_ds, device="cpu")
    return result


def drill_fit(out_dir: str, scenario: str, plan: inject.FaultPlan | None, over=(),
              recovery: bool = False) -> dict:
    """One consensus drill on tiny_cnn: 64 examples, 4 steps an epoch."""
    cfg = load_config(None, [
        "data.dataset=synthetic", "data.synthetic_size=64", "data.batch_size=16",
        "model.arch=tiny_cnn", "optim.lr=0.1", "train.num_epochs=3",
        "train.half_precision=false", "train.checkpoint_every=1",
        f"train.checkpoint_dir={out_dir}/{scenario.split(':')[0]}",
        "resilience.consensus_grace_s=1.0", *over])
    train_ds, _ = load_dataset("synthetic", synthetic_size=64, seed=0)
    records: list = []
    if plan is not None:
        inject.activate(plan)
    rec = {"scenario": scenario}
    try:
        fn = loop.fit_with_recovery if recovery else loop.fit
        res = fn(cfg, train_ds, None, device="cpu", checkpoint_dir=cfg.train.checkpoint_dir,
                 log=lambda kind, **f: records.append({"kind": kind, **f}))
        rec.update(outcome="completed", final_step=res.state.step,
                   epochs_run=[h["epoch"] for h in res.history],
                   params_digest=float(sum(v.double().sum() for v in
                                           res.state.params.values())))
    except Preempted as p:
        rec.update(outcome="preempted", step=p.step, durable_step=p.durable_step,
                   epoch=p.epoch, rc=EXIT_PREEMPTED)
    except DivergenceError as err:
        rec.update(outcome="divergence", epoch=err.epoch, remote=err.remote,
                   rc=EXIT_DIVERGED)
    finally:
        inject.deactivate()
    rec["kinds"] = [r["kind"] for r in records]
    rec["restore_agreed"] = [r.get("step") for r in records
                             if r.get("event") == "restore_agreed"]
    return rec


def drills(out_dir: str) -> dict:
    return {"runs": [
        drill_fit(out_dir, "sigterm", inject.FaultPlan(rank=1, sigterm_at_epoch_end=0)),
        drill_fit(out_dir, "sigterm:resume", None, ["train.resume=true"]),
        drill_fit(out_dir, "nan", inject.FaultPlan(rank=1, nan_loss_at_epoch=1),
                  recovery=True),
        drill_fit(out_dir, "restore", None, ["train.num_epochs=2"]),
        drill_fit(out_dir, "restore:resume", inject.FaultPlan(rank=1, hide_latest_durable=True),
                  ["train.num_epochs=2", "train.resume=true"]),
    ]}


def hang(out_dir: str) -> dict:
    t0 = time.monotonic()
    rec = {}
    try:
        drill_fit(out_dir, "hang", inject.FaultPlan(rank=1, hang_at=5, hang_seconds=600.0),
                  ["resilience.step_timeout_s=2.0", "train.num_epochs=2"])
        rec["outcome"] = "completed"
    except (WatchdogTimeout, PeerPoisoned) as err:
        rec.update(outcome="aborted", error=f"{type(err).__name__}: {err}"[:300])
    except RuntimeError as err:   # a collective torn by the peer's exit
        rec.update(outcome="torn", error=f"{type(err).__name__}: {err}"[:300])
    rec["wall_s"] = time.monotonic() - t0
    return rec


TP_OVER = ["mesh.model_axis=2"]


def _layout(model: int):
    """Switch this rank's layout between the joined ``{data: 2, model: 2}``
    (``model`` 2) and the ``{data: 4}`` layout of the same four ranks (1)."""
    saved = (mesh._MODEL, mesh._DATA_GROUP, mesh._MODEL_GROUP)
    if model == 1:
        mesh._MODEL, mesh._DATA_GROUP, mesh._MODEL_GROUP = 1, None, None
    return saved


def _restore_layout(saved) -> None:
    mesh._MODEL, mesh._DATA_GROUP, mesh._MODEL_GROUP = saved


def tp_steps(inputs: dict, over: list[str], model: int) -> dict:
    """Three steps of tiny_cnn on 40 rows at a global batch of 16 (a padded
    tail) in the ``{data: 4 / model, model: model}`` layout: the whole
    (gathered) state, per-step metrics and this rank's head shapes."""
    saved = _layout(model)
    try:
        cfg = load_config(None, [*TRAIN_OVER, *over])
        tm = create_model("tiny_cnn", 10)
        ds = ArrayDataset(inputs["x"], inputs["y"],
                          np.arange(len(inputs["y"]), dtype=np.int32), 10)
        rows = mesh.batch_slice()
        sgd = make_optimizer(cfg, 3)
        state = shard_slots(state_from_variables(_group(inputs, "var/"), tm), sgd)
        out = {f"shape:{g}/{k}": np.asarray(v.shape) for g in ("params", "momentum")
               for k, v in getattr(state, g).items() if k.startswith("classifier.")}
        metrics = []
        for b in iterate_batches(ds, 16, image_slice=rows):
            m = train_step(tm, sgd, state, to_device(local_rows(b, rows), "cpu"))
            metrics.append([float(m["loss"]), float(m["correct"]), float(m["examples"])])
        whole = gather_slots(state, sgd)
    finally:
        _restore_layout(saved)
    out.update({f"{g}/{k}": v.numpy().copy() for g in ("params", "batch_stats", "momentum")
                for k, v in getattr(whole, g).items()})
    out["metrics"] = np.asarray(metrics)
    return out


def tp(out_dir: str) -> dict:
    from data_diet_distributed_tpu_torch import cli
    from data_diet_distributed_tpu_torch.parallel import collectives

    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    result = {}
    runs = (("tp", TP_OVER, 2), ("tp_zero1", [*TP_OVER, "mesh.shard_opt_state=true"], 2),
            ("tp_clip", [*TP_OVER, "optim.grad_clip_norm=0.5",
                         "mesh.shard_weight_update=true"], 2),
            ("dp", [], 1), ("dp_clip", ["optim.grad_clip_norm=0.5"], 1))
    for name, over, model in runs:
        for k, v in tp_steps(inputs, over, model).items():
            result[f"{name}:{k}"] = v
    real = collectives.copy_to_model
    collectives.copy_to_model = lambda x: x
    try:
        for k, v in tp_steps(inputs, TP_OVER, 2).items():
            result[f"tp_nocopy:{k}"] = v
    finally:
        collectives.copy_to_model = real
    tm = create_model("tiny_cnn", 10)
    cfg = load_config(None, [*TRAIN_OVER, *TP_OVER])
    eval_state = shard_slots(state_from_variables(_group(inputs, "var/"), tm),
                             make_optimizer(cfg, 1))
    ev = loop.evaluate(tm, eval_state, ArrayDataset(
        inputs["eval_x"], inputs["eval_y"], np.arange(64, dtype=np.int32), 10), 64,
        device="cpu")
    result["eval"] = np.asarray([ev["loss"], ev["accuracy"], ev["examples"]])
    ds = ArrayDataset(inputs["score_x"], inputs["score_y"], inputs["score_idx"], 10)
    for method in ("el2n", "grand"):
        result[f"score:{method}"] = score_dataset(tm, [_group(inputs, "var/")], ds,
                                                  method=method, batch_size=15, chunk=4,
                                                  device="cpu")
    traj = load_config(None, [str(o) for o in inputs["traj_over"]] + TP_OVER
                       + [f"train.checkpoint_dir={out_dir}/traj"])
    result["forgetting"] = loop.trajectory_scores(traj, loop.load_data_for(traj)[0],
                                                  device="cpu")
    fit_cfg = load_config(None, ["data.dataset=synthetic", "data.synthetic_size=64",
                                 "data.batch_size=32", "model.arch=tiny_cnn",
                                 "train.num_epochs=1", "train.half_precision=false",
                                 "mesh.shard_opt_state=true", "checkpoint.local_tier=true",
                                 f"train.checkpoint_dir={out_dir}/ckpt", *TP_OVER])
    res = loop.fit(fit_cfg, loop.load_data_for(fit_cfg)[0], None, device="cpu",
                   checkpoint_dir=fit_cfg.train.checkpoint_dir)
    whole = gather_slots(res.state, make_optimizer(fit_cfg, 2))
    for g in ("params", "batch_stats", "momentum"):
        for k, v in getattr(whole, g).items():
            result[f"fit:{g}/{k}"] = v.numpy().copy()
    result["fit:step"] = np.asarray(res.state.step)
    rank = mesh.process_index()
    mesh.shutdown()

    # cli run joins a group of its own, as a user would start it.
    heads = []
    real_fit = loop.fit

    def recording_fit(*args, **kwargs):
        res = real_fit(*args, **kwargs)
        heads.append([kwargs.get("tag", "train"),
                      list(res.state.params["classifier.weight"].shape),
                      list(res.state.momentum["classifier.weight"].shape)])
        return res

    loop.fit = recording_fit
    argv = ["run", "--device", "cpu", *[str(a) for a in inputs["cli_argv"]],
            "mesh.multihost=true", f"mesh.coordinator_address=127.0.0.1:{inputs['cli_port']}",
            "mesh.num_processes=4", f"mesh.process_id={rank}", *TP_OVER]
    result["cli_rc"] = np.asarray(cli.main(argv))
    loop.fit = real_fit
    result["cli_heads"] = np.asarray(json.dumps(heads))
    return result


def serve(out_dir: str) -> dict:
    from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
    from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
    from data_diet_distributed_tpu_torch.serve.server import ServeService

    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    rank = mesh.process_index()
    ckpt = os.path.join(out_dir, "ckpt")
    cfg = load_config(None, ["data.dataset=synthetic", "model.arch=tiny_cnn",
                             "train.half_precision=false", "score.batch_size=15",
                             "score.grand_chunk=4", "score.pretrain_epochs=0",
                             f"train.checkpoint_dir={ckpt}",
                             "resilience.consensus_grace_s=30"])
    ds = ArrayDataset(inputs["score_x"], inputs["score_y"], inputs["score_idx"], 10)
    seeds = [_group(inputs, f"s{s}/") for s in (0, 1)]
    model = ResNet((1, 1, 1, 1), BasicBlock, width=16).eval()
    engine = ServeEngine(cfg, device="cpu")
    engine.model = model
    engine.register_tenant("syn", ds, seeds)
    result: dict = {"batch_size": engine.batch_size}
    methods = ("el2n", "grand")
    for m in methods:   # the boot's warm passes, every rank together
        result[f"full:{m}"] = engine.full_scores("syn", m).tolist()
    if rank == 1:
        real_load = engine.load_checkpoint_variables

        def refuse_step_4(directory, step=None):
            if step == 4:
                raise OSError("rank 1 cannot read step 4")
            return real_load(directory, step)

        engine.load_checkpoint_variables = refuse_step_4
        result["stop"] = engine.follow()
        t = engine.tenant("syn")
        result["peer_scores"] = {m: v.tolist() for m, v in t.scores.items()}
        result["peer_seeds"] = len(t.variables_seeds)
    else:
        service = ServeService(engine, cfg)
        engine.lead()
        partial = inputs["partial_ids"]
        block = inputs["block_ids"]
        for m in methods:
            result[f"partial:{m}"] = engine.score_batch(
                "syn", m, *engine.examples_for("syn", partial)).tolist()
            result[f"block:{m}"] = engine.score_batch(
                "syn", m, *engine.examples_for("syn", block)).tolist()
            result[f"topk:{m}"] = list(engine.topk("syn", m, 10))
            ids, scores = engine.rank("syn", m, inputs["rank_ids"])
            result[f"rank:{m}"] = [ids.tolist(), scores.tolist()]
        refresh = {}
        for step in (2, 3, 4):
            code, payload, _ = service.refresh("syn", step=step)
            refresh[step] = {"code": code, "status": payload.get("status")}
            result[f"refresh{step}:partial:grand"] = engine.score_batch(
                "syn", "grand", *engine.examples_for("syn", partial)).tolist()
            for m in methods:
                result[f"refresh{step}:full:{m}"] = engine.full_scores("syn", m).tolist()
        result["refresh"] = refresh
        result["rank_launches"] = engine.gather_rank_launches()
        engine.stop_group("done")
    # Out of the operations: the port's own W = 2 scoring on the same inputs.
    step2 = CheckpointManager(ckpt).restore_variables(2, "cpu")
    for m in methods:
        result[f"offline:{m}"] = score_dataset(model, seeds, ds, method=m, batch_size=15,
                                               chunk=4, device="cpu").tolist()
        result[f"offline2:{m}"] = score_dataset(model, [step2], ds, method=m,
                                                batch_size=15, chunk=4,
                                                device="cpu").tolist()
    return result


def fleet_ref(out_dir: str) -> dict:
    from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg

    with open(os.path.join(out_dir, "args.json")) as fh:
        cfg = load_config(None, json.load(fh))
    ds, _ = loop.load_data_for(cfg)
    variables = CheckpointManager(cfg.train.checkpoint_dir).restore_variables(
        cfg.score.score_ckpt_step, "cpu")
    model = create_model_from_cfg(cfg)
    return {m: score_dataset(model, [variables], ds, method=m,
                             batch_size=cfg.score.batch_size, chunk=cfg.score.grand_chunk,
                             device="cpu").tolist() for m in ("el2n", "grand")}


def main() -> None:
    rank, world, port, out_dir, group = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5])
    mesh.initialize_multihost(MeshConfig(multihost=True,
                                         coordinator_address=f"127.0.0.1:{port}",
                                         num_processes=world, process_id=rank,
                                         model_axis=2 if group == "tp" else 1), "cpu")
    result = {"numerics": numerics, "drills": drills, "hang": hang,
              "serve": serve, "tp": tp, "fleet_ref": fleet_ref}[group](out_dir)
    result["rank"] = rank
    if group in ("numerics", "tp"):
        np.savez(os.path.join(out_dir, f"result_{rank}.npz"), **result)
    else:
        with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as fh:
            json.dump(result, fh)
    rc = 0
    if group == "hang":
        rc = EXIT_RETRIABLE if result["outcome"] in ("aborted", "torn") else 0
    sys.stdout.flush()
    sys.stderr.flush()
    # No teardown: after a drill a peer may be gone, and a group's teardown
    # with a dead peer can hang (the CLI exits the same way).
    os._exit(rc)


if __name__ == "__main__":
    main()
