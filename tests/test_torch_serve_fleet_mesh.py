"""PyTorch port: a fleet of meshes, ``cli serve --device cpu serve.replicas=2
mesh.multihost=true mesh.num_processes=2``: two replicas, each a group of two
gloo ranks, behind the router.

The fleet serves tiny_cnn on 40 synthetic examples at batch 15 (16 at W = 2)
from a checkpoint of JAX init variables (BN-randomized) carried by
``weights.params_from_flax`` (``score.score_ckpt_step``). While it boots, two
ranks of ``torch_dist_worker.py`` (group ``fleet_ref``) score the same
configuration with ``score_dataset`` at W = 2, and this process builds the JAX
``ServeEngine`` on two CPU devices over the same examples and variables.
Every answer through the router is bitwise the W = 2 vector and within
``test_torch_serve_mesh.py``'s tolerances of JAX (EL2N rtol 1e-5, GraNd rtol
2e-4, atol 1e-6). Then rank 1 of replica 0 is SIGKILLed under keyed load and
the fleet is SIGTERMed. The placement arithmetic and its refusals are unit
tests with no processes.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu.data import datasets as flax_datasets
from data_diet_distributed_tpu.parallel.mesh import make_mesh
from data_diet_distributed_tpu.serve.engine import ServeEngine as JaxServeEngine
from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.serve import fleet as fleet_mod
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.train.state import state_from_variables
from test_torch_dist import launch, tiny_seed_variables, wait
from torch_threads import SUBPROCESS_ENV, one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOL = {"el2n": (1e-5, 1e-6), "grand": (2e-4, 1e-6)}
METHODS = ("el2n", "grand")
N, STEP, GRACE_S = 40, 2, 30.0
SERVED = ["data.dataset=synthetic", f"data.synthetic_size={N}", "model.arch=tiny_cnn",
          "train.half_precision=false", "score.pretrain_epochs=0", "score.batch_size=15",
          "score.grand_chunk=8", f"score.score_ckpt_step={STEP}"]
FLEET = ["serve.replicas=2", "mesh.multihost=true", "mesh.num_processes=2",
         # The operator's coordinator and id give way to the fleet's.
         "mesh.coordinator_address=127.0.0.1:1", "mesh.process_id=0",
         "serve.router_port=0", "serve.port=0", "serve.methods=[el2n,grand]",
         "serve.health_poll_s=0.25", "serve.breaker_reset_s=0.5", "serve.stats_every_s=2",
         "serve.request_timeout_s=60", "serve.drain_timeout_s=10",
         f"resilience.consensus_grace_s={GRACE_S}", "elastic.max_restarts=2",
         "elastic.backoff_s=0.2"]
SUBSETS = {"one": [7], "partial": [3, 11, 29, 0, 38], "block": list(range(5, 21)),
           "all": list(range(N))}


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sc = _tool("serve_client")


def _records(path: Path) -> list[dict]:
    out = []
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def _wait(proc, metrics: Path, pred, what: str, budget_s: float = 120.0) -> dict:
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()[-4000:]
        hit = next((r for r in _records(metrics) if pred(r)), None)
        if hit is not None:
            return hit
        time.sleep(0.2)
    raise AssertionError(f"no {what} record within {budget_s} s")


def _wait_available(proc, probe, n: int, budget_s: float = 120.0) -> float:
    deadline = time.monotonic() + budget_s
    verdict = None
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()[-4000:]
        try:
            verdict = probe.healthz()
        except sc.ServeError:
            verdict = None
        if verdict and verdict.get("available") == n:
            return time.time()
        time.sleep(0.1)
    raise AssertionError(f"never {n} routable replicas: {verdict}")


def _served(client, ids) -> dict:
    return {m: np.asarray(client.score(indices=ids, method=m)["scores"], np.float32)
            for m in METHODS}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_mesh")
    fm, tree, port_vars = tiny_seed_variables(3)
    ckpt = tmp / "ckpt"
    CheckpointManager(str(ckpt)).save(STEP, state_from_variables(
        port_vars, create_model("tiny_cnn", 10)))
    args = SERVED + [f"train.checkpoint_dir={ckpt}"]
    metrics = tmp / "metrics.jsonl"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DDT_") and k != "PYTHONPATH"}
    env.update(SUBPROCESS_ENV, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve", "--device",
         "cpu", *args, *FLEET, f"obs.metrics_path={metrics}"],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out: dict = {"metrics": metrics}
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    (ref_dir / "args.json").write_text(json.dumps(args))
    ranks = launch(ref_dir, "fleet_ref")
    try:
        # While the replicas boot: the JAX engine on two devices, the same
        # examples and variables.
        ds, _ = loop.load_data_for(load_config(None, args))
        jcfg = jax_load_config(None, ["data.dataset=synthetic", "model.arch=tiny_cnn",
                                      "train.half_precision=false", "score.batch_size=15",
                                      "score.grand_chunk=8"])
        jengine = JaxServeEngine(jcfg, mesh=make_mesh(None, devices=jax.devices()[:2]))
        jengine.model = fm
        jengine.register_tenant("syn", flax_datasets.ArrayDataset(
            ds.images, ds.labels, ds.indices, 10), variables_seeds=[tree])
        out["jax"] = {m: np.asarray(jengine.full_scores("syn", m)) for m in METHODS}
        out["jax_batch"] = jengine.batch_size
        out["indices"] = ds.indices
        rcs, logs = wait(ranks, ref_dir, "fleet_ref")
        assert rcs == [0, 0], logs
        refs = [json.loads((ref_dir / f"result_{r}.json").read_text()) for r in (0, 1)]
        out["w2"] = {m: np.asarray(refs[0][m], np.float32) for m in METHODS}
        out["w2_ranks_equal"] = all(refs[0][m] == refs[1][m] for m in METHODS)

        launch_rec = _wait(proc, metrics, lambda r: r.get("kind") == "serve_fleet"
                           and r.get("event") == "launch", "launch")
        out["launch"] = launch_rec
        url = f"http://127.0.0.1:{launch_rec['router_port']}"
        client = sc.ServeClient(url, timeout_s=60.0, retries=6, backoff_s=0.25)
        probe = sc.ServeClient(url, timeout_s=5.0)
        _wait_available(proc, probe, 2)
        out["answers"] = {k: _served(client, ids) for k, ids in SUBSETS.items()}

        # Rank 1 of replica 0 SIGKILLed under keyed load from two clients.
        spawn0 = next(r for r in _records(metrics) if r.get("kind") == "replica_event"
                      and r.get("event") == "spawn" and r["replica"] == 0)
        out["spawn0"] = spawn0
        errors, answers, stop = [], [], threading.Event()

        def client_loop(k: int) -> None:
            c = sc.ServeClient(url, timeout_s=60.0, retries=6, backoff_s=0.25)
            rng = np.random.default_rng(k)
            while not stop.is_set():
                ids = rng.choice(N, size=int(rng.integers(1, 17)), replace=False).tolist()
                m = METHODS[len(answers) % 2]
                try:
                    got = np.asarray(c.score(indices=ids, method=m)["scores"], np.float32)
                    answers.append((m, ids, got))
                except Exception as exc:   # noqa: BLE001 — counted, then asserted on
                    errors.append(repr(exc)[:200])

        threads = [threading.Thread(target=client_loop, args=(k,), daemon=True)
                   for k in range(2)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        t_kill = time.time()
        os.kill(spawn0["pids"][1], signal.SIGKILL)
        out["t_kill"] = t_kill
        out["died"] = _wait(proc, metrics, lambda r: r.get("kind") == "replica_event"
                            and r.get("event") == "died", "died")
        out["respawn"] = _wait(proc, metrics, lambda r: r.get("kind") == "replica_event"
                               and r.get("event") == "respawn", "respawn")
        out["t_back"] = _wait_available(proc, probe, 2)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        out["errors"], out["load"] = errors, answers
        out["after"] = _served(client, SUBSETS["all"])
        proc.send_signal(signal.SIGTERM)
        out["rc"] = proc.wait(timeout=90)
        out["stdout"] = proc.stdout.read()
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out["records"] = _records(metrics)
    return out


@pytest.mark.parametrize("method", METHODS)
def test_router_answers_bitwise_score_dataset_at_w2(fleet, method):
    """Every answer through the router (one id, a partial block, a full block,
    all 40) is bitwise the port's W = 2 ``score_dataset`` on the same
    variables, which both reference ranks hold."""
    assert fleet["w2_ranks_equal"]
    pos = {int(i): k for k, i in enumerate(fleet["indices"])}
    for key, ids in SUBSETS.items():
        want = fleet["w2"][method][[pos[i] for i in ids]]
        np.testing.assert_array_equal(fleet["answers"][key][method], want, err_msg=key)
    np.testing.assert_array_equal(fleet["after"][method], fleet["w2"][method])


@pytest.mark.parametrize("method", METHODS)
def test_router_answers_match_jax_on_two_devices(fleet, method):
    """The fleet's whole-dataset answers against the JAX ``ServeEngine`` on a
    two-device mesh (batch 16 on both sides) on the same variables."""
    rtol, atol = TOL[method]
    assert fleet["jax_batch"] == 16
    np.testing.assert_allclose(np.asarray(fleet["answers"]["all"][method], np.float64),
                               np.asarray(fleet["jax"][method], np.float64),
                               rtol=rtol, atol=atol)


def test_launch_reports_the_groups_and_the_overridden_keys(fleet):
    launch = fleet["launch"]
    assert launch["replicas"] == 2 and launch["ranks"] == 2
    assert launch["placement"] == [None, None]   # the CPU: no cards to place
    assert launch["mesh_overridden"] == {"coordinator_address": "127.0.0.1:1",
                                         "process_id": 0}
    spawns = [r for r in fleet["records"] if r.get("kind") == "replica_event"
              and r.get("event") == "spawn"]
    assert sorted(r["replica"] for r in spawns) == [0, 1]
    for r in spawns:
        assert len(r["pids"]) == 2 and r["coordinator"] != "127.0.0.1:1"
    assert spawns[0]["coordinator"] != spawns[1]["coordinator"]


def test_sigkill_of_one_rank_respawns_the_group_with_no_failed_request(fleet):
    """0 failed keyed requests, every answer bitwise; a ``died`` record naming
    rank 1 of replica 0 by SIGKILL, written once its peer is reaped, well
    before ``resilience.consensus_grace_s`` (the peer SIGKILLed by the
    supervisor, or gone first with 69 when a collective in flight tore at
    once); the whole group respawned on the slot's port on a new coordinator
    and routable again."""
    assert fleet["errors"] == [], fleet["errors"][:3]
    assert len(fleet["load"]) > 10
    pos = {int(i): k for k, i in enumerate(fleet["indices"])}
    for m, ids, got in fleet["load"]:
        np.testing.assert_array_equal(got, fleet["w2"][m][[pos[i] for i in ids]])
    died, respawn, spawn0 = fleet["died"], fleet["respawn"], fleet["spawn0"]
    assert died["replica"] == 0 and died["rank"] == 1 and died["signal"] == 9
    assert died["rank_rcs"][1] == -9 and died["rank_rcs"][0] in (-9, 69)
    assert died["ts"] - fleet["t_kill"] < GRACE_S / 3
    assert respawn["replica"] == 0 and respawn["dead_rank"] == 1
    assert respawn["generation"] == 1 and respawn["port"] == spawn0["port"]
    assert respawn["coordinator"] != spawn0["coordinator"]
    assert set(respawn["pids"]).isdisjoint(spawn0["pids"])
    assert fleet["t_back"] > died["ts"]


def test_sigterm_every_rank_and_the_supervisor_exit_75(fleet):
    vm = _tool("validate_metrics")
    assert fleet["rc"] == 75, fleet["stdout"][-3000:]
    assert vm.validate_file(str(fleet["metrics"]), expect_terminal=True) == []
    ended = next(r for r in fleet["records"] if r.get("kind") == "serve_fleet"
                 and r.get("event") == "preempted_exit")
    assert ended["rank_rcs"] == [[75, 75], [75, 75]]
    summary = fleet["records"][-1]
    assert summary["exit_class"] == "preempted"
    assert summary["lineage"]["ranks"] == 2 and summary["lineage"]["respawns"] == 1


# ---------------------------------------------------------------- no processes


LOCAL2, LOCAL4 = [None] * 2, [None] * 4


@pytest.mark.parametrize("hosts,world,device,cards,want", [
    (LOCAL2, 2, "cuda", ["0", "1", "2", "3"], [["0", "1"], ["2", "3"]]),
    (LOCAL4, 1, "cuda", ["0", "1", "2", "3"], [["0"], ["1"], ["2"], ["3"]]),
    (LOCAL2, 1, "cuda", ["0"], [["0"], ["0"]]),      # one-rank replicas share the card
    (LOCAL2, 1, "cuda:0", ["0", "1"], [None, None]),  # the card the operator named
    (LOCAL2, 2, "cpu", [], [None, None]),
    (LOCAL2, 2, "cuda", ["4", "5", "6", "7"], [["4", "5"], ["6", "7"]]),
    ([None], 2, "cuda", ["0", "1", "2"], [["0", "1"]]),
    # An autoscaled bound past the cards: one-rank replicas wrap round-robin.
    ([None] * 8, 1, "cuda", ["0", "1", "2", "3"],
     [["0"], ["1"], ["2"], ["3"], ["0"], ["1"], ["2"], ["3"]]),
    ([None] * 3, 1, "cuda", [], [None, None, None]),
    # Remote slots keep their host's own view; local slots are numbered
    # among themselves, whatever the supervisor's card count.
    (["hA", "hB"], 1, "cuda", ["0"], [None, None]),
    (["hA", "hB"], 2, "cuda", [], [None, None]),
    ([None, "hA", None, "hA"], 1, "cuda", ["0", "1"], [["0"], None, ["1"], None]),
    ([None, "hA", None, "hA"], 2, "cuda", ["0", "1", "2", "3"],
     [["0", "1"], None, ["2", "3"], None]),
])
def test_placement(hosts, world, device, cards, want):
    assert fleet_mod.place_replicas(hosts, world, device, cards) == want


@pytest.mark.parametrize("hosts,world,device,cards,match", [
    (LOCAL2, 2, "cuda", ["0", "1", "2"], "needs 4 cards"),
    (LOCAL2, 2, "cuda", ["0"], "NCCL refuses two ranks"),
    (LOCAL2, 2, "cuda:1", ["0", "1", "2", "3"], "--device cuda:1 with mesh.num_processes=2"),
    ([None, "hA", None], 2, "cuda", ["0", "1", "2"], "2 replicas of 2 ranks on this host"),
    (["hA", "hB"], 2, "cuda:0", [], "--device cuda:0 with mesh.num_processes=2"),
])
def test_placement_refusals(hosts, world, device, cards, match):
    with pytest.raises(ValueError, match=match):
        fleet_mod.place_replicas(hosts, world, device, cards)


def _fleet_cfg(tmp_path, *over):
    return load_config(None, ["serve.replicas=2", "mesh.multihost=true",
                              "mesh.num_processes=2", f"train.checkpoint_dir={tmp_path}/c",
                              "obs.metrics_path=null", *over])


def test_fleet_refuses_before_any_spawn(tmp_path):
    spawned = []
    for device, cards in (("cuda", ["0", "1", "2"]), ("cuda:0", ["0", "1", "2", "3"])):
        with pytest.raises(ValueError):
            fleet_mod.ServeFleet(_fleet_cfg(tmp_path), device=device, cards=cards,
                                 spawn=lambda i, g: spawned.append(i))
    # The autoscaler's bound is placed too: 3 slots of 2 ranks need 6 cards.
    with pytest.raises(ValueError, match="needs 6 cards"):
        fleet_mod.ServeFleet(_fleet_cfg(tmp_path, "serve.max_replicas=3"), device="cuda",
                             cards=["0", "1", "2", "3"], spawn=lambda i, g: None)
    assert spawned == []


def test_rank_argv_and_env_carry_the_group_and_its_cards(tmp_path):
    f = fleet_mod.ServeFleet(_fleet_cfg(tmp_path, "mesh.coordinator_address=h:1",
                                        "mesh.process_id=1"),
                             device="cuda", cards=["0", "1", "2", "3"],
                             spawn=lambda i, g: None)
    argv = f._child_argv(1, rank=1, coordinator="127.0.0.1:999")
    # Appended after the operator's: the fleet's geometry wins.
    assert argv[-4:] == ["mesh.multihost=true", "mesh.num_processes=2",
                         "mesh.coordinator_address=127.0.0.1:999", "mesh.process_id=1"]
    # One heartbeat root a slot: its ranks write heartbeat_rank<k>.json in it.
    assert any(a.endswith("hb_r1") for a in argv)
    env = f._child_env(1, 0)
    assert env["CUDA_VISIBLE_DEVICES"] == "2,3" and env["DDT_SERVE_REPLICA"] == "1"
    assert f.mesh_overridden == {"coordinator_address": "h:1", "process_id": 1}
    assert f._log_path(1, 2, rank=1).endswith("replica1_r1_g2.log")


@pytest.mark.parametrize("env,smi,want", [
    ("2,3", None, ["2", "3"]),                 # the operator's list wins
    (None, "GPU 0: H100 (UUID: a)\nGPU 1: H100 (UUID: b)\n", ["0", "1"]),
    (None, None, []),                          # no nvidia-smi: a host without cards
])
def test_visible_cards_are_counted_without_cuda(tmp_path, monkeypatch, env, smi, want):
    if env is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
    if smi is not None:
        tool = tmp_path / "nvidia-smi"
        tool.write_text(f"#!/bin/sh\nprintf '{smi}'\n")
        tool.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert fleet_mod.visible_cards() == want


REMOTE = ["serve.hosts=[hostA,hostB]",
          "serve.remote_launch='/usr/bin/env DDT_REMOTE_HOST={host}'"]


@pytest.mark.parametrize("world", [1, 2])
def test_remote_slots_keep_their_hosts_view_and_meet_there(tmp_path, monkeypatch, world):
    """``serve.hosts`` slots are not placed from the supervisor's cards (one
    here, where a local fleet of meshes would need four): each rank runs
    through the launch template on its slot's host with that host's own
    view, and a mesh's coordinator is a port asked of that host."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    mesh = ["mesh.multihost=true", f"mesh.num_processes={world}"] if world > 1 else []
    cfg = load_config(None, ["serve.replicas=2", f"train.checkpoint_dir={tmp_path}/c",
                             "obs.metrics_path=null", *REMOTE, *mesh])
    f = fleet_mod.ServeFleet(cfg, device="cuda", cards=["0"], spawn=lambda i, g: None)
    assert f.placement == [None, None]
    assert "CUDA_VISIBLE_DEVICES" not in f._child_env(1, 0)
    argv = f._remote_argv(1, 0, "hostB", rank=world - 1, coordinator="hostB:4321")
    assert argv[:2] == ["/usr/bin/env", "DDT_REMOTE_HOST=hostB"]
    assert not any(t.startswith("CUDA_VISIBLE_DEVICES=") for t in argv)
    assert "serve.host=hostB" in argv
    mesh_keys = [t for t in argv if t.startswith("mesh.")]
    assert mesh_keys == ([] if world == 1 else
                         ["mesh.multihost=true", "mesh.num_processes=2",
                          "mesh.coordinator_address=hostB:4321", "mesh.process_id=1"])
    # The probe runs through the template, as the ranks do.
    assert 0 < f._remote_free_port("hostB") < 65536
    asked, launched = [], []
    f._remote_free_port = lambda host: asked.append(host) or 4321
    f._spawn_rank = lambda i, g, r, c: launched.append((i, g, r, c)) or _Proc(100 + r)
    group = f._spawn(1, 3)
    want = None if world == 1 else "hostB:4321"
    assert group.coordinator == want and group.cards is None
    assert asked == ([] if world == 1 else ["hostB"])
    assert launched == [(1, 3, r, want) for r in range(world)]


def test_remote_port_probe_failure_names_the_host(tmp_path):
    cfg = load_config(None, ["serve.replicas=2", f"train.checkpoint_dir={tmp_path}/c",
                             "obs.metrics_path=null", "serve.hosts=[hostA]",
                             "serve.remote_launch='/usr/bin/env false {host}'"])
    f = fleet_mod.ServeFleet(cfg, device="cpu", spawn=lambda i, g: None)
    with pytest.raises(RuntimeError, match="no free port from hostA"):
        f._remote_free_port("hostA")


def test_config_accepts_a_fleet_of_meshes_and_still_checks_a_mesh():
    cfg = load_config(None, ["serve.max_replicas=3", "mesh.multihost=true",
                             "mesh.num_processes=2"])
    assert cfg.mesh.coordinator_address is None and cfg.mesh.process_id is None
    with pytest.raises(ValueError, match="coordinator_address"):
        load_config(None, ["mesh.multihost=true", "mesh.num_processes=2"])
    with pytest.raises(ValueError, match="process_id=2"):
        load_config(None, ["serve.replicas=2", "mesh.multihost=true",
                           "mesh.num_processes=2", "mesh.process_id=2"])


class _Proc:
    def __init__(self, pid, rc=None):
        self.pid, self.returncode, self.signals = pid, rc, []

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        if self.returncode is None:
            raise subprocess.TimeoutExpired("rank", timeout)
        return self.returncode

    def terminate(self):
        self.signals.append("TERM")

    def kill(self):
        self.signals.append("KILL")
        self.returncode = -9


def test_replica_group_names_the_rank_that_died():
    procs = [_Proc(10), _Proc(11), _Proc(12)]
    g = fleet_mod.ReplicaGroup(procs, "127.0.0.1:5", ["0", "1", "2"])
    assert g.poll() is None and g.returncode is None and g.pid == 10
    procs[0].returncode, procs[2].returncode = 69, -9   # rank 2 killed, rank 0 torn
    assert g.poll() == -9 and g.dead_rank == 2
    with pytest.raises(subprocess.TimeoutExpired):
        g.wait(timeout=0)
    g.kill()
    assert procs[1].signals == ["KILL"] and procs[0].signals == []
    assert g.wait() == -9 and g.rank_rcs == [69, -9, -9]
