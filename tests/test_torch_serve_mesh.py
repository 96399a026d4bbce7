"""PyTorch port: ``cli serve`` across two gloo ranks, held against the JAX
``ServeEngine`` on a two-device mesh and the port's own W = 2 scoring.

One module-scoped launch of two ``torch_dist_worker.py`` ranks (group
``serve``) serves the narrow ResNet of ``test_torch_dist.py`` (its variables
the JAX init, BN-randomized, carried by ``weights.params_from_flax``) while
this process builds the JAX engine on ``make_mesh(devices=jax.devices()[:2])``
over the same 45 examples and seeds. Eval-mode tolerances against JAX are
``test_torch_dist.py``'s scoring ones (EL2N rtol 1e-5, GraNd rtol 2e-4, atol
1e-6); against the port's own ``score_dataset`` at W = 2 every answer is
bitwise. The process tests start ``cli serve --device cpu`` as two ranks.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu.data import datasets as flax_datasets
from data_diet_distributed_tpu.parallel.mesh import make_mesh
from data_diet_distributed_tpu.serve.engine import ServeEngine as JaxServeEngine
from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.train.state import state_from_variables
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_dist import free_port, launch, wait
from test_torch_models import flax_and_torch, randomize_bn
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOL = {"el2n": (1e-5, 1e-6), "grand": (2e-4, 1e-6)}
METHODS = ("el2n", "grand")
N = 45


def _validator():
    spec = importlib.util.spec_from_file_location(
        "validate_metrics", REPO / "tools" / "validate_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mesh_serve(tmp_path_factory):
    """The two ranks' results and the JAX engine's answers on the same inputs."""
    out = tmp_path_factory.mktemp("serve_mesh")
    score_x, score_y = flax_datasets._synthetic(N, 10, 3, "train")
    score_idx = (np.random.default_rng(0).permutation(N) + 1000).astype(np.int32)
    # The narrow ResNet's BN-randomized JAX init per seed (scoring seeds 0, 1;
    # checkpoint steps 2, 3, 4) and its port.
    fm, tm = flax_and_torch("narrow")
    init = jax.jit(fm.init, static_argnames=("train",))
    trees = [randomize_bn(init(jax.random.key(s), jnp.zeros((1, 32, 32, 3)), train=False),
                          np.random.default_rng(s)) for s in range(5)]
    port_vars = [params_from_flax(t, tm) for t in trees]
    rng = np.random.default_rng(4)
    inputs = {"score_x": score_x, "score_y": score_y, "score_idx": score_idx,
              "partial_ids": rng.choice(score_idx, 5, replace=False),
              "block_ids": rng.choice(score_idx, 16, replace=False),
              "rank_ids": rng.choice(score_idx, 12, replace=False),
              **{f"s{s}/{k}": v.numpy() for s in (0, 1) for k, v in port_vars[s].items()}}
    np.savez(out / "inputs.npz", **inputs)
    mngr = CheckpointManager(str(out / "ckpt"))
    for step in (2, 3, 4):
        mngr.save(step, state_from_variables(port_vars[step], tm))
    inject.truncate_checkpoint(str(out / "ckpt"), 3)
    procs = launch(out, "serve")
    try:
        jcfg = jax_load_config(None, ["data.dataset=synthetic", "model.arch=tiny_cnn",
                                      "train.half_precision=false", "score.batch_size=15",
                                      "score.grand_chunk=4"])
        jengine = JaxServeEngine(jcfg, mesh=make_mesh(None, devices=jax.devices()[:2]))
        jengine.model = fm
        jds = flax_datasets.ArrayDataset(score_x, score_y, score_idx, 10)
        jengine.register_tenant("syn", jds, variables_seeds=trees[:2])
        pos = jengine.tenant("syn").pos_of
        ref = {"batch_size": jengine.batch_size}
        for m in METHODS:
            for key in ("partial", "block"):
                ids = inputs[f"{key}_ids"]
                ref[f"{key}:{m}"] = jengine.score_batch(
                    "syn", m, score_x[pos(ids)], score_y[pos(ids)])
            ref[f"full:{m}"] = jengine.full_scores("syn", m)
            ref[f"topk:{m}"] = list(jengine.topk("syn", m, 10))
            ref[f"rank:{m}"] = jengine.rank("syn", m, inputs["rank_ids"])
    finally:
        rcs, logs = wait(procs, out, "serve")
    assert rcs == [0, 0], logs
    results = [json.loads((out / f"result_{r}.json").read_text()) for r in range(2)]
    return results, ref, inputs


def _close(got, want, method):
    rtol, atol = TOL[method]
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _ids_agree(got_ids, want_ids, want_scores, method):
    """Equal ranked ids wherever the neighbouring scores are not within
    tolerance of a tie (where they are, either order is right)."""
    rtol, atol = TOL[method]
    s = np.asarray(want_scores, np.float64)
    tie = np.zeros(len(s), bool)
    gaps = np.abs(np.diff(s)) <= 2 * (rtol * np.abs(s[1:]) + atol)
    tie[:-1] |= gaps
    tie[1:] |= gaps
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    assert np.array_equal(got_ids[~tie], want_ids[~tie])


@pytest.mark.parametrize("method", METHODS)
def test_served_answers_match_jax_on_a_two_device_mesh(mesh_serve, method):
    """``score_batch`` of a partial block (5 of 16 rows) and of a full one,
    ``full_scores``, ``topk`` and ``rank`` against the JAX ``ServeEngine`` on
    two devices: EL2N within rtol 1e-5, GraNd within rtol 2e-4, atol 1e-6
    (``test_torch_dist.py``'s scoring tolerances); ranked ids equal away from
    ties."""
    results, ref, _ = mesh_serve
    got = results[0]
    for key in ("partial", "block", "full"):
        _close(got[f"{key}:{method}"], ref[f"{key}:{method}"], method)
    jt = ref[f"topk:{method}"]
    _close([s for _, s in got[f"topk:{method}"]], [s for _, s in jt], method)
    _ids_agree([i for i, _ in got[f"topk:{method}"]], [i for i, _ in jt],
               [s for _, s in jt], method)
    jids, jscores = ref[f"rank:{method}"]
    _close(got[f"rank:{method}"][1], jscores, method)
    _ids_agree(got[f"rank:{method}"][0], jids, jscores, method)


@pytest.mark.parametrize("method", METHODS)
def test_both_ranks_hold_score_dataset_bitwise(mesh_serve, method):
    """Both ranks hold the same whole-dataset vector, bitwise the port's own
    ``score_dataset`` at W = 2 and batch 15; every served answer (a partial
    and a full block, ``topk``, ``rank``) is bitwise that vector's."""
    results, _, inputs = mesh_serve
    r0, r1 = results
    offline = np.asarray(r0[f"offline:{method}"], np.float32)
    assert np.array_equal(np.asarray(r1[f"offline:{method}"], np.float32), offline)
    for res in results:
        assert np.array_equal(np.asarray(res[f"full:{method}"], np.float32), offline)
    idx = inputs["score_idx"]
    pos = {int(i): k for k, i in enumerate(idx)}
    for key in ("partial", "block"):
        want = offline[[pos[int(i)] for i in inputs[f"{key}_ids"]]]
        assert np.array_equal(np.asarray(r0[f"{key}:{method}"], np.float32), want)
    order = np.lexsort((idx, -offline))[:10]
    assert r0[f"topk:{method}"] == [[int(idx[p]), float(offline[p])] for p in order]
    ids = inputs["rank_ids"]
    s = offline[[pos[int(i)] for i in ids]]
    o = np.lexsort((ids, -s))
    assert r0[f"rank:{method}"] == [ids[o].tolist(), s[o].tolist()]


def test_request_geometry_rounds_up_to_the_world(mesh_serve):
    """``score.batch_size=15`` serves at B = 16 on two ranks, as JAX's engine
    on two devices; each rank gathered its own kernel launches."""
    results, ref, _ = mesh_serve
    assert [r["batch_size"] for r in results] == [16, 16] == [ref["batch_size"]] * 2
    launches = results[0]["rank_launches"]
    assert len(launches) == 2 and all(isinstance(d, dict) for d in launches)


def test_refresh_installs_on_every_rank_or_none(mesh_serve):
    """Step 2 installs on both ranks (both then hold ``score_dataset`` on step
    2's variables, bitwise); the truncated step 3 and step 4, which rank 1
    cannot restore, are 409 and leave both ranks on step 2."""
    results, _, inputs = mesh_serve
    r0, r1 = results
    assert {k: v["code"] for k, v in r0["refresh"].items()} == {"2": 200, "3": 409, "4": 409}
    assert r0["refresh"]["4"]["status"] == "rejected"
    idx = inputs["score_idx"]
    pos = [{int(i): k for k, i in enumerate(idx)}[int(i)] for i in inputs["partial_ids"]]
    for m in METHODS:
        offline2 = np.asarray(r0[f"offline2:{m}"], np.float32)
        for step in (2, 3, 4):
            assert np.array_equal(np.asarray(r0[f"refresh{step}:full:{m}"], np.float32),
                                  offline2), (m, step)
        assert np.array_equal(np.asarray(r1["peer_scores"][m], np.float32), offline2)
        assert not np.array_equal(offline2, np.asarray(r0[f"offline:{m}"], np.float32))
    for step in (2, 3, 4):
        assert np.array_equal(np.asarray(r0[f"refresh{step}:partial:grand"], np.float32),
                              np.asarray(r0["offline2:grand"], np.float32)[pos])
    assert r1["peer_seeds"] == 1 and r1["stop"]["reason"] == "done"


def _cli_rank(tmp, rank: int, port: str, name: str, *over: str) -> subprocess.Popen:
    args = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve",
            "--device", "cpu", "data.dataset=synthetic", "data.synthetic_size=40",
            "model.arch=tiny_cnn", "train.half_precision=false", "score.pretrain_epochs=0",
            "score.batch_size=15", "score.seeds=[0,1]", "serve.port=0",
            "serve.methods=[el2n,grand]", "serve.drain_timeout_s=10",
            f"obs.metrics_path={tmp}/{name}/m.jsonl", f"train.checkpoint_dir={tmp}/{name}/c",
            "mesh.multihost=true", f"mesh.coordinator_address=127.0.0.1:{port}",
            "mesh.num_processes=2", f"mesh.process_id={rank}", *over]
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "DDT_FAULT_PLAN")}
    env.update(PYTHONPATH=str(REPO), **SUBPROCESS_ENV)
    os.makedirs(f"{tmp}/{name}", exist_ok=True)
    with open(f"{tmp}/{name}/out{rank}.txt", "w") as out, \
            open(f"{tmp}/{name}/err{rank}.txt", "w") as err:
        return subprocess.Popen(args, stdout=out, stderr=err, env=env)


def _records(path) -> list[dict]:
    out = []
    for line in Path(path).read_text().splitlines():
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def _served_port(tmp, name, procs, budget_s: float = 120.0) -> int:
    t0 = time.monotonic()
    while time.monotonic() - t0 < budget_s:
        for rec in _records(f"{tmp}/{name}/err0.txt"):
            if rec.get("kind") == "obs_server":
                return rec["port"]
        assert all(p.poll() is None for p in procs), [p.poll() for p in procs]
        time.sleep(0.1)
    raise AssertionError(f"{name}: rank 0 never announced its port")


def _score(port: int, ids) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/score",
                                 data=json.dumps({"indices": ids}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_cli_serve_two_ranks_sigterm_and_sigkill(tmp_path):
    """``cli serve`` as two gloo ranks (two pairs at once). Rank 0 answers on
    the port it announced and rank 1 announces none. Pair A: a SIGTERM to rank
    1 ends both with exit 75 and ``[preempted]``, and both streams (rank 1's
    ``m.rank1.jsonl``) pass ``tools/validate_metrics.py`` ending in
    ``run_summary`` ``preempted``. Pair B: after a SIGKILL of rank 1, rank 0
    exits non-zero within its deadline (``resilience.consensus_grace_s=3``)
    plus 10 s, instead of hanging."""
    grace = 3.0
    pairs = {}
    for name in ("term", "kill"):
        port = free_port()
        pairs[name] = [_cli_rank(tmp_path, r, str(port), name,
                                 f"resilience.consensus_grace_s={grace}") for r in (0, 1)]
    try:
        served = {name: _served_port(tmp_path, name, procs) for name, procs in pairs.items()}
        for name in pairs:
            got = _score(served[name], [1, 2, 3])
            assert got["n"] == 3 and np.isfinite(got["scores"]).all()
        pairs["term"][1].send_signal(signal.SIGTERM)
        pairs["kill"][1].kill()
        t_kill = time.monotonic()
        rc_kill = pairs["kill"][0].wait(timeout=grace + 10)
        kill_s = time.monotonic() - t_kill
        rcs_term = [p.wait(timeout=60) for p in pairs["term"]]
    finally:
        for procs in pairs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
    assert rc_kill not in (0, None) and kill_s <= grace + 10, (rc_kill, kill_s)
    assert rcs_term == [75, 75], [Path(f"{tmp_path}/term/err{r}.txt").read_text()[-2000:]
                                  for r in (0, 1)]
    vm = _validator()
    for r, stream in enumerate(("m.jsonl", "m.rank1.jsonl")):
        assert "[preempted]" in Path(f"{tmp_path}/term/out{r}.txt").read_text()
        lines = Path(f"{tmp_path}/term/{stream}").read_text().splitlines()
        assert vm.validate_lines(lines, where=stream, expect_terminal=True) == []
        recs = [json.loads(x) for x in lines]
        assert recs[-1]["kind"] == "run_summary" and recs[-1]["exit_class"] == "preempted"
        assert any(x["kind"] == "preempted" for x in recs)
        assert any(x["kind"] == "obs_server" for x in recs) == (r == 0)
    assert not any(x.get("kind") == "obs_server"
                   for x in _records(f"{tmp_path}/term/err1.txt"))
