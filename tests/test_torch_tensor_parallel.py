"""PyTorch port at ``{data: 2, model: 2}`` over gloo against the JAX package on
``Mesh(jax.devices()[:4]).reshape(2, 2)`` (``tests/test_tensor_parallel.py``'s
calls: ``place_state``, ``make_train_step``, ``BatchSharder``,
``score_dataset``).

One module-scoped launch of four ``torch_dist_worker.py`` processes (group
``tp``: the port only) runs every scenario while this process computes the
references: the JAX package's three steps, eval and scores on the 2x2 mesh,
its ZeRO-1 placement, and the port's forgetting scores in one process. The
workers also run the same steps in the ``{data: 4}`` layout of the same ranks,
and finally ``cli run`` with ``mesh.multihost=true mesh.model_axis=2``.
Tolerances are stated at each comparison.
"""

import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from data_diet_distributed_tpu.data import datasets as flax_datasets
from data_diet_distributed_tpu.data.pipeline import BatchSharder
from data_diet_distributed_tpu.ops.scoring import score_dataset as flax_score_dataset
from data_diet_distributed_tpu.parallel.mesh import place_state, replicate
from data_diet_distributed_tpu.train import loop as flax_loop
from data_diet_distributed_tpu.train.steps import make_train_step as flax_make_train_step
from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.pipeline import iterate_batches
from data_diet_distributed_tpu_torch.train import loop
from test_torch_dist import free_port, launch, wait
from test_torch_models import ported
from test_torch_train import both_cfgs, flax_train_state, to_port
from torch_threads import one_intra_op_thread  # noqa: F401

TRAIN_OVER = ["train.num_epochs=1", "optim.lr=0.1", "optim.weight_decay=0.01",
              "train.half_precision=false"]
GROUPS = ("params", "batch_stats", "momentum")
TRUNK = ("Conv_0.weight", "Conv_1.weight", "BatchNorm_0.weight", "BatchNorm_1.weight")
#: JAX ``test_forgetting_on_tensor_parallel_mesh``'s recipe.
TRAJ_OVER = ["data.dataset=synthetic", "data.synthetic_size=128", "data.batch_size=32",
             "model.arch=tiny_cnn", "score.method=forgetting", "score.pretrain_epochs=2",
             "score.seeds=[0]", "train.half_precision=false", "train.log_every_steps=1000"]
CLI_OVER = ["data.dataset=synthetic", "data.synthetic_size=64", "data.batch_size=16",
            "model.arch=tiny_cnn", "train.num_epochs=1", "train.half_precision=false",
            "score.method=el2n", "score.pretrain_epochs=1", "score.seeds=[0]",
            "score.batch_size=16", "prune.sparsity=0.5", "train.log_every_steps=1000",
            "obs.xla_introspect=false"]


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Start the workers, compute the references meanwhile, then collect."""
    out = tmp_path_factory.mktemp("tp")
    fm, tree, _, variables, x, y = ported("tiny", 40, seed=3)
    score_x, score_y = flax_datasets._synthetic(45, 10, 3, "train")
    score_idx = (np.random.default_rng(0).permutation(45) + 1000).astype(np.int32)
    eval_x, eval_y = flax_datasets._synthetic(64, 10, 5, "train")
    ckpt = out / "run"
    inputs = {"x": x, "y": y, "score_x": score_x, "score_y": score_y,
              "eval_x": eval_x, "eval_y": eval_y,
              "score_idx": score_idx, "traj_over": np.array(TRAJ_OVER),
              "cli_argv": np.array(CLI_OVER + [f"train.checkpoint_dir={ckpt}",
                                               f"obs.metrics_path={out}/run.jsonl"]),
              "cli_port": np.asarray(int(free_port())),
              **{f"var/{k}": v.numpy() for k, v in variables.items()}}
    np.savez(out / "inputs.npz", **inputs)
    procs = launch(out, "tp", world=4)
    try:
        ref: dict = {}
        mesh22 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
        sharder = BatchSharder(mesh22)
        jcfg, _ = both_cfgs(TRAIN_OVER)
        jstate = place_state(flax_train_state(fm, tree, jcfg, 3), mesh22)
        jstep = flax_make_train_step(fm)
        fds = flax_datasets.ArrayDataset(x, y, np.arange(40, dtype=np.int32), 10)
        jm = []
        for b in iterate_batches(fds, 16):
            jstate, m = jstep(jstate, sharder(b))
            jm.append([float(m["loss"]), float(m["correct"]), float(m["examples"])])
        ref["jax_metrics"], ref["jax_vars"] = np.asarray(jm), to_port(jstate)
        ref["jax_head_spec"] = jstate.params["classifier"]["kernel"].sharding.spec
        z1 = place_state(flax_train_state(fm, tree, jcfg, 3), mesh22, shard_opt_state=True)
        ref["jax_zero1"] = {
            path[-1].key: (leaf.sharding.spec, leaf.addressable_shards[0].data.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(z1.opt_state)[0]
            if len(path) > 1 and getattr(path[-2], "key", None) == "classifier"}
        ev_ds = flax_datasets.ArrayDataset(eval_x, eval_y, np.arange(64, dtype=np.int32), 10)
        ref["eval"] = flax_loop.evaluate(fm, place_state(flax_train_state(fm, tree, jcfg, 1),
                                                         mesh22), ev_ds, sharder, 64)
        sfds = flax_datasets.ArrayDataset(score_x, score_y, score_idx, 10)
        for method in ("el2n", "grand"):
            ref[f"score:{method}"] = flax_score_dataset(
                fm, [replicate(tree, mesh22)], sfds, method=method, batch_size=15, chunk=4,
                sharder=BatchSharder(mesh22))
        traj = load_config(None, TRAJ_OVER + [f"train.checkpoint_dir={out}/traj1"])
        ref["forgetting"] = loop.trajectory_scores(traj, loop.load_data_for(traj)[0],
                                                   device="cpu")
    finally:
        rcs, logs = wait(procs, out, "tp", timeout=150.0)
    assert rcs == [0, 0, 0, 0], logs
    results = []
    for r in range(4):
        with np.load(out / f"result_{r}.npz") as f:
            results.append({k: f[k] for k in f.files})
    return results, ref, out


def by_group(result: dict, run: str) -> dict:
    pre = f"{run}:"
    return {k[len(pre):]: v for k, v in result.items()
            if k.startswith(pre) and k[len(pre):].split("/")[0] in GROUPS}


def test_three_steps_match_jax_on_a_2x2_mesh(tp_run):
    """Global BatchNorm over the data group, the global-count loss over a
    padded tail (8 of 16 rows) and the gathered logits: losses within rtol
    5e-4 (1e-5 on the first step), params and statistics within rtol 1e-4,
    atol 3e-3 (the narrow ResNet's port-against-JAX tolerances); the four
    ranks' gathered states bitwise equal (the model ranks' trunks never
    diverge)."""
    results, ref, _ = tp_run
    got = results[0]["tp:metrics"]
    np.testing.assert_allclose(got[0, 0], ref["jax_metrics"][0, 0], rtol=1e-5)
    np.testing.assert_allclose(got[:, 0], ref["jax_metrics"][:, 0], rtol=5e-4)
    assert np.array_equal(got[:, 1:], ref["jax_metrics"][:, 1:])
    assert list(got[:, 2]) == [16, 16, 8]
    grouped = by_group(results[0], "tp")
    for k, v in ref["jax_vars"].items():
        g = "params" if f"params/{k}" in grouped else "batch_stats"
        np.testing.assert_allclose(grouped[f"{g}/{k}"], v.numpy(), rtol=1e-4, atol=3e-3,
                                   err_msg=k)
    for res in results[1:]:
        for k, v in by_group(res, "tp").items():
            assert np.array_equal(v, grouped[k]), k


def test_each_rank_holds_its_rows_of_the_head_and_its_momentum(tp_run):
    """The head's weight [10, 32] and bias [10] are split by output rows over
    the model group: each rank holds [5, 32] and [5] of the params and the
    momentum, the JAX spec ``P(None, "model")`` on Flax's [32, 10] kernel.
    Under ZeRO-1 the momentum of the weight also splits its other dim over
    the data group, [5, 16], as JAX places ``P("data", "model")`` (a [16, 5]
    shard); the bias, 5 rows on a 2-wide data axis, stays whole on the rows.
    In the ``{data: 4}`` layout the head is whole."""
    results, ref, _ = tp_run
    assert ref["jax_head_spec"] == P(None, "model")
    spec, shard = ref["jax_zero1"]["kernel"]
    assert spec == P("data", "model") and shard == (16, 5)
    assert ref["jax_zero1"]["bias"][0] == P("model")
    for res in results:
        for run, w_mom in (("tp", [5, 32]), ("tp_zero1", [5, 16]), ("dp", [10, 32])):
            rows = w_mom[0]
            assert list(res[f"{run}:shape:params/classifier.weight"]) == [rows, 32]
            assert list(res[f"{run}:shape:params/classifier.bias"]) == [rows]
            assert list(res[f"{run}:shape:momentum/classifier.weight"]) == w_mom
            assert list(res[f"{run}:shape:momentum/classifier.bias"]) == [rows]


def test_2x2_matches_the_port_on_data_4(tp_run):
    """The 2x2 run against the ``{data: 4}`` run of the same ranks (the JAX
    TP-against-DP pin: rtol 2e-4, atol 1e-5); ZeRO-1 under TP bitwise the
    replicated TP update."""
    results, _, _ = tp_run
    res = results[0]
    np.testing.assert_allclose(res["tp:metrics"], res["dp:metrics"], rtol=2e-4, atol=1e-5)
    dp = by_group(res, "dp")
    for k, v in by_group(res, "tp").items():
        np.testing.assert_allclose(v, dp[k], rtol=2e-4, atol=1e-5, err_msg=k)
    for k, v in by_group(res, "tp_zero1").items():
        assert np.array_equal(v, by_group(res, "tp")[k]), k
    assert np.array_equal(res["tp_zero1:metrics"], res["tp:metrics"])


def test_global_clip_norm_sums_over_both_groups(tp_run):
    """``optim.grad_clip_norm`` under TP with the sharded update (the head's
    rows over the model group, the ZeRO-1 slices over the data group) against
    the clipped ``{data: 4}`` update: rtol 2e-4, atol 1e-5; the clip binds."""
    results, _, _ = tp_run
    res = results[0]
    assert not np.allclose(res["tp_clip:params/Conv_0.weight"], res["tp:params/Conv_0.weight"],
                           rtol=2e-4, atol=1e-5)
    want = by_group(res, "dp_clip")
    for k, v in by_group(res, "tp_clip").items():
        np.testing.assert_allclose(v, want[k], rtol=2e-4, atol=1e-5, err_msg=k)


def test_without_copy_to_model_the_trunk_leaves_the_tolerance(tp_run):
    """With ``copy_to_model`` the identity each rank's trunk gets only its
    head rows' share of ``∂L/∂h``: after three steps the trunk is outside the
    rtol 2e-4, atol 1e-5 that holds the 2x2 run to ``{data: 4}``, so a port
    without the op fails that comparison."""
    results, _, _ = tp_run
    res = results[0]
    worst = max(float(np.max(np.abs(res[f"tp_nocopy:params/{k}"] - res[f"dp:params/{k}"])
                             - (1e-5 + 2e-4 * np.abs(res[f"dp:params/{k}"]))))
                for k in TRUNK)
    assert worst > 0


def test_eval_counts_the_data_ranks_once(tp_run):
    """``evaluate`` at 2x2 on 64 examples at batch 64: 64 examples, not 128
    (``test_tp_eval_globally_reduced``), the JAX package's accuracy exactly
    and its loss within rtol 1e-5."""
    results, ref, _ = tp_run
    for res in results:
        loss, acc, n = res["eval"]
        assert n == ref["eval"]["examples"] == 64
        assert acc == ref["eval"]["accuracy"]
        np.testing.assert_allclose(loss, ref["eval"]["loss"], rtol=1e-5)


@pytest.mark.parametrize("method", ["el2n", "grand"])
def test_scores_on_the_flat_grid_match_jax(tp_run, method):
    """Scoring flattens the mesh: batch 15 rounds to 16, 4 rows on each of
    the four ranks, as JAX's ``BatchSharder.flat``; within rtol 1e-4, atol
    1e-5 of the JAX 2x2 mesh, every rank's vector bitwise equal."""
    results, ref, _ = tp_run
    got = results[0][f"score:{method}"]
    for res in results[1:]:
        assert np.array_equal(res[f"score:{method}"], got)
    np.testing.assert_allclose(got, ref[f"score:{method}"], rtol=1e-4, atol=1e-5)


def test_forgetting_on_the_2x2_training_layout(tp_run):
    """Forgetting events over two epochs of the training layout (the head
    split, the correctness pass on the data ranks' rows) on every rank equal
    the port's in one process, within JAX's bounds [0, 3]."""
    results, ref, _ = tp_run
    got = results[0]["forgetting"]
    assert got.shape == (128,) and (got >= 0).all() and (got <= 3).all()
    for res in results[1:]:
        assert np.array_equal(res["forgetting"], got)
    np.testing.assert_array_equal(got, ref["forgetting"])


def test_2x2_tier_checkpoint_restores_whole_at_one_rank(tp_run):
    """A ZeRO-1 fit at 2x2 through the local tier (the head gathered over the
    model group, the slices written by model index 0): one process restores
    the whole state bitwise the ranks' gathered state."""
    results, _, out = tp_run
    state = CheckpointManager(str(out / "ckpt")).restore(device="cpu")
    assert state.step == int(results[0]["fit:step"]) == 2
    assert tuple(state.params["classifier.weight"].shape) == (10, 32)
    for g in GROUPS:
        for k, v in getattr(state, g).items():
            for res in results:
                assert np.array_equal(v.numpy(), res[f"fit:{g}/{k}"]), (g, k)


def test_cli_run_over_four_ranks_with_a_model_axis(tp_run):
    """``cli run`` with ``mesh.multihost=true mesh.num_processes=4
    mesh.model_axis=2``: every rank exits 0; the pretrain and the retrain each
    end with the rank's [5, 32] rows of the head and its momentum; half the
    set is kept; the final checkpoint restores at W = 1 with the whole head."""
    results, _, out = tp_run
    for res in results:
        assert int(res["cli_rc"]) == 0
        heads = json.loads(str(res["cli_heads"]))
        assert [h[0] for h in heads] == ["score_pretrain_seed0", "final"]
        assert all(h[1] == [5, 32] and h[2] == [5, 32] for h in heads)
    with np.load(loop.scores_npz_path(str(out / "run"))) as f:
        assert len(f["kept"]) == 32 and np.isfinite(f["scores"]).all()
    state = CheckpointManager(str(out / "run")).restore(device="cpu")
    assert tuple(state.params["classifier.weight"].shape) == (10, 32)
    assert os.path.exists(out / "run.jsonl")
