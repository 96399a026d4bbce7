"""PyTorch port at W = 2 over gloo against the JAX package on a ``{data: 2}`` mesh.

One module-scoped launch of two ``torch_dist_worker.py`` processes (the port
only) runs every scenario in one process group while this process computes
the references: JAX's ``make_train_step``, ``score_dataset`` with
``BatchSharder(mesh2)`` and ``evaluate`` on ``Mesh(jax.devices()[:2])``,
and the port at W = 1. Tolerances are stated at each comparison.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from data_diet_distributed_tpu.data import datasets as flax_datasets
from data_diet_distributed_tpu.data.pipeline import BatchSharder
from data_diet_distributed_tpu.models import create_model as flax_create_model
from data_diet_distributed_tpu.ops.scoring import score_dataset as flax_score_dataset
from data_diet_distributed_tpu.parallel.mesh import replicate
from data_diet_distributed_tpu.train import loop as flax_loop
from data_diet_distributed_tpu.train.steps import make_train_step as flax_make_train_step
from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data import augment as augment_mod
from data_diet_distributed_tpu_torch.data.datasets import ArrayDataset
from data_diet_distributed_tpu_torch.data.pipeline import iterate_batches, to_device
from data_diet_distributed_tpu_torch.models import BasicBlock, ResNet, create_model
from data_diet_distributed_tpu_torch.models.resnet import collect_batch_stats
from data_diet_distributed_tpu_torch.ops.scores import cross_entropy
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.train.state import make_optimizer, state_from_variables
from data_diet_distributed_tpu_torch.train.steps import train_step
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_models import ported, randomize_bn
from test_torch_train import both_cfgs, flax_train_state, to_port

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
TRAIN_OVER = ["train.num_epochs=1", "optim.lr=0.1", "optim.weight_decay=0.01",
              "train.half_precision=false"]
GROUPS = ("params", "batch_stats", "momentum")
#: AUM over one 2-epoch fit of tiny_cnn, 40 examples at batch 16 (a padded tail).
TRAJ_OVER = ["data.dataset=synthetic", "data.synthetic_size=40", "data.batch_size=16",
             "model.arch=tiny_cnn", "optim.lr=0.1", "train.half_precision=false",
             "score.method=aum", "score.pretrain_epochs=2", "score.seeds=[0]"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out_dir, group: str, world: int = 2) -> list[subprocess.Popen]:
    """``world`` worker processes of ``group`` (stdout and stderr to files)."""
    port = str(free_port())
    procs = []
    for r in range(world):
        log = open(os.path.join(out_dir, f"log_{group}_{r}.txt"), "w")
        path = os.pathsep.join([os.path.dirname(WORKER),
                                os.path.dirname(os.path.dirname(WORKER))])
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), port, str(out_dir), group],
            stdout=log, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": path}))
        log.close()
    return procs


def wait(procs, out_dir, group: str, timeout: float = 120.0) -> list[int]:
    """Every worker's exit code; kills them all when one outlives ``timeout``."""
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    logs = [open(os.path.join(out_dir, f"log_{group}_{r}.txt")).read()[-3000:]
            for r in range(len(procs))]
    return rcs, logs


def tiny_seed_variables(seed: int):
    """tiny_cnn's Flax model, BN-randomized variables from ``seed`` and their port."""
    fm = flax_create_model("tiny_cnn", 10)
    init = jax.jit(fm.init, static_argnames=("train",))
    tree = randomize_bn(init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)), train=False),
                        np.random.default_rng(seed))
    return fm, tree, params_from_flax(tree, create_model("tiny_cnn", 10))


def jax_draws(step: int, batch: int = 16):
    """``augment_images``' flip mask and crop offsets for ``step`` at seed 0."""
    k_flip, k_crop = jax.random.split(jax.random.fold_in(jax.random.key(0), step))
    return (np.asarray(jax.random.bernoulli(k_flip, 0.5, (batch,))),
            np.asarray(jax.random.randint(k_crop, (batch, 2), 0, 9)).astype(np.int64))


def port_three_steps(variables, x, y, draws):
    """The port at W = 1: the same three steps as the workers."""
    saved = augment_mod.draw_augment
    augment_mod.draw_augment = lambda seed, step, batch, crop_pad=4, flip=True: tuple(
        torch.from_numpy(d) for d in draws[step])
    try:
        model = ResNet((1, 1, 1, 1), BasicBlock, width=16)
        _, cfg = both_cfgs(TRAIN_OVER)
        state = state_from_variables(variables, model)
        sgd = make_optimizer(cfg, 3)
        ds = ArrayDataset(x, y, np.arange(len(y), dtype=np.int32), 10)
        metrics = [train_step(model, sgd, state, to_device(b, "cpu"), augment=(4, True, 0))
                   for b in iterate_batches(ds, 16)]
    finally:
        augment_mod.draw_augment = saved
    return state, np.asarray([[float(m[k]) for k in ("loss", "correct", "examples")]
                              for m in metrics])


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Start the workers, compute the references meanwhile, then collect."""
    out = tmp_path_factory.mktemp("dist")
    fm, tree, _, variables, x, y = ported("narrow", 40, seed=3)
    draws = [jax_draws(s) for s in range(3)]
    score_x, score_y = flax_datasets._synthetic(45, 10, 3, "train")
    score_idx = (np.random.default_rng(0).permutation(45) + 1000).astype(np.int32)
    seeds = [tiny_seed_variables(s) for s in (0, 1)]
    inputs = {"x": x, "y": y, "flips": np.stack([d[0] for d in draws]),
              "offsets": np.stack([d[1] for d in draws]), "score_x": score_x,
              "score_y": score_y, "score_idx": score_idx, "traj_over": np.array(TRAJ_OVER),
              **{f"var/{k}": v.numpy() for k, v in variables.items()},
              **{f"s{s}/{k}": v.numpy() for s in (0, 1) for k, v in seeds[s][2].items()}}
    np.savez(out / "inputs.npz", **inputs)
    procs = launch(out, "numerics")
    try:
        ref: dict = {"variables": variables, "x": x, "y": y}
        mesh2 = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
        jcfg, _ = both_cfgs(TRAIN_OVER)
        jstate = replicate(flax_train_state(fm, tree, jcfg, 3), mesh2)
        jstep = flax_make_train_step(fm, augment=(4, True, 0))
        sharder = BatchSharder(mesh2)
        fds = flax_datasets.ArrayDataset(x, y, np.arange(40, dtype=np.int32), 10)
        jm = []
        for b in iterate_batches(fds, 16):
            jstate, m = jstep(jstate, sharder(b))
            jm.append([float(m["loss"]), float(m["correct"]), float(m["examples"])])
        ref["jax_metrics"], ref["jax_vars"] = np.asarray(jm), to_port(jstate)
        ref["w1_state"], ref["w1_metrics"] = port_three_steps(variables, x, y, draws)
        sfds = flax_datasets.ArrayDataset(score_x, score_y, score_idx, 10)
        for method in ("el2n", "grand"):
            for eval_mode in (True, False):
                ref[f"score:{method}:{'eval' if eval_mode else 'train'}"] = flax_score_dataset(
                    seeds[0][0], [replicate(t, mesh2) for _, t, _ in seeds], sfds,
                    method=method, batch_size=15, chunk=4, eval_mode=eval_mode,
                    sharder=BatchSharder(mesh2))
        traj = load_config(None, TRAJ_OVER + [f"train.checkpoint_dir={out}/traj"])
        ref["aum"] = loop.trajectory_scores(traj, loop.load_data_for(traj)[0], device="cpu")
        ref["eval"] = flax_loop.evaluate(seeds[0][0], replicate(
            flax_train_state(seeds[0][0], seeds[0][1], jcfg, 1), mesh2), sfds, sharder, 15)
    finally:
        rcs, logs = wait(procs, out, "numerics")
    assert rcs == [0, 0], logs
    results = []
    for r in range(2):
        with np.load(out / f"result_{r}.npz") as f:
            results.append({k: f[k] for k in f.files})
    return results, ref, out


def by_group(result: dict, run: str) -> dict:
    pre = f"{run}:"
    return {k[len(pre):]: v for k, v in result.items()
            if k.startswith(pre) and k[len(pre):].split("/")[0] in GROUPS}


def test_three_steps_match_jax_on_a_two_device_mesh(dist_run):
    """Global BatchNorm, the global-count loss over a padded tail (third batch:
    8 of 16 rows) and the global batch's augmentation rows: losses within
    rtol 5e-4 (1e-5 on the first step), params and statistics within rtol
    1e-4, atol 3e-3 (the narrow ResNet's port-against-JAX tolerances)."""
    results, ref, _ = dist_run
    got = results[0]["replicated:metrics"]
    np.testing.assert_allclose(got[0, 0], ref["jax_metrics"][0, 0], rtol=1e-5)
    np.testing.assert_allclose(got[:, 0], ref["jax_metrics"][:, 0], rtol=5e-4)
    assert np.array_equal(got[:, 1:], ref["jax_metrics"][:, 1:])
    assert list(got[:, 2]) == [16, 16, 8]
    want = ref["jax_vars"]
    grouped = by_group(results[0], "replicated")
    for k, v in want.items():
        g = "params" if f"params/{k}" in grouped else "batch_stats"
        np.testing.assert_allclose(grouped[f"{g}/{k}"], v.numpy(), rtol=1e-4, atol=3e-3,
                                   err_msg=k)


def test_three_steps_match_the_port_in_one_process(dist_run):
    """W = 2 against W = 1 on the same draws: losses within rtol 1e-5, every
    params, statistics and momentum entry within rtol 1e-5 of its tensor's
    largest magnitude (the ranks' partial sums reorder fp32 additions)."""
    results, ref, _ = dist_run
    np.testing.assert_allclose(results[0]["replicated:metrics"], ref["w1_metrics"],
                               rtol=1e-5)
    w1 = ref["w1_state"]
    for key, v in by_group(results[0], "replicated").items():
        g, name = key.split("/", 1)
        want = getattr(w1, g)[name].numpy()
        np.testing.assert_allclose(v, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)


def test_per_rank_batchnorm_would_miss_the_tolerance(dist_run):
    """The batch tells global from per-rank statistics: normalizing each rank's
    8 rows by their own statistics moves the first step's loss by more than
    the 3e-3 the JAX comparison allows, so a port without global BatchNorm
    fails it."""
    _, ref, _ = dist_run
    model = ResNet((1, 1, 1, 1), BasicBlock, width=16).train()
    x = torch.from_numpy(ref["x"][:16])
    y = torch.from_numpy(ref["y"][:16])

    def loss(parts):
        with torch.no_grad(), collect_batch_stats():
            logits = torch.cat([torch.func.functional_call(model, ref["variables"], (p,))
                                for p in parts])
        return float(cross_entropy(logits, y).mean())

    assert abs(loss([x[:8], x[8:]]) - loss([x])) > 3e-3


@pytest.mark.parametrize("run", ["zero1", "sharded"])
def test_sharded_updates_equal_the_replicated_update_bitwise(dist_run, run):
    """ZeRO-1 and the sharded weight update: losses, params, statistics and the
    gathered momentum bitwise the replicated update's, on both ranks; each
    rank holds the momentum of its half of every leaf the rule shards."""
    results, _, _ = dist_run
    for res in results:
        assert np.array_equal(res[f"{run}:metrics"], res["replicated:metrics"])
        want = by_group(res, "replicated")
        got = by_group(res, run)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (run, k)
        assert res[f"{run}:slot_bytes"] < 0.6 * res["replicated:slot_bytes"]


def test_sharded_update_with_a_global_clip_norm(dist_run):
    """Under ``optim.grad_clip_norm`` the sharded update clips by the norm of
    the WHOLE gradient, whose squares it sums in another order (its shards,
    then the ranks): not bitwise, within rtol 1e-6 and an atol of 1e-6 of each
    tensor's largest magnitude of the replicated clipped update."""
    results, _, _ = dist_run
    res = results[0]
    assert not np.array_equal(res["replicated_clip:metrics"], res["replicated:metrics"])
    want = by_group(res, "replicated_clip")
    for k, v in by_group(res, "sharded_clip").items():
        np.testing.assert_allclose(v, want[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("method,mode", [("el2n", "eval"), ("grand", "eval"),
                                         ("el2n", "train"), ("grand", "train")])
def test_scores_match_jax_sharded_scoring(dist_run, method, mode):
    """Batch 15 rounds to 16 (8 rows a rank) on both sides; train mode
    normalizes by each rank's rows, as JAX's ``shard_map`` does. Tolerances of
    ``test_torch_scoring.py`` (eval: EL2N rtol 1e-5, GraNd 2e-4, atol 1e-6) and
    ``test_torch_fit.py`` (train mode: rtol 1e-4, atol 1e-7). Both ranks hold
    the same vector bitwise, and the streamed plane is bitwise the resident."""
    results, ref, _ = dist_run
    key = f"score:{method}:{mode}"
    got = results[0][f"{key}:resident"]
    assert np.array_equal(got, results[1][f"{key}:resident"])
    assert np.array_equal(got, results[0][f"{key}:stream"])
    rtol, atol = ({"el2n": 1e-5, "grand": 2e-4}[method], 1e-6) if mode == "eval" else (1e-4,
                                                                                      1e-7)
    np.testing.assert_allclose(got, ref[key], rtol=rtol, atol=atol)


def test_eval_counts_are_global(dist_run):
    """``evaluate`` sums the ranks: 45 examples at batch 15 -> 16 (8 a rank),
    the JAX package's counts and accuracy exactly, the loss within rtol 1e-5."""
    results, ref, _ = dist_run
    for res in results:
        loss, acc, n = res["eval"]
        assert n == ref["eval"]["examples"] == 45
        assert acc == ref["eval"]["accuracy"]
        np.testing.assert_allclose(loss, ref["eval"]["loss"], rtol=1e-5)


def test_checkpoint_written_at_two_ranks_restores_in_one(dist_run):
    """A ZeRO-1 fit at W = 2 checkpoints the whole momentum from rank 0; one
    process restores it bitwise the ranks' gathered state."""
    results, _, out = dist_run
    state = CheckpointManager(str(out / "ckpt")).restore(device="cpu")
    assert state.step == int(results[0]["fit:step"]) == 2
    for g in GROUPS:
        for k, v in getattr(state, g).items():
            assert np.array_equal(v.numpy(), results[0][f"fit:{g}/{k}"]), (g, k)
            assert np.array_equal(v.numpy(), results[1][f"fit:{g}/{k}"]), (g, k)


def test_trajectory_scores_join_the_ranks(dist_run):
    """AUM over a 2-epoch fit (40 examples at batch 16, a padded tail): each
    epoch's margin vector joins the ranks' rows by one float64 sum, so both
    ranks hold the same scores bitwise, within rtol 1e-5, atol 1e-6 of the
    scores at W = 1 (the fits' fp32 sums run in another order)."""
    results, ref, _ = dist_run
    assert np.array_equal(results[0]["aum"], results[1]["aum"])
    assert results[0]["aum"].shape == (40,) and np.isfinite(results[0]["aum"]).all()
    np.testing.assert_allclose(results[0]["aum"], ref["aum"], rtol=1e-5, atol=1e-6)
