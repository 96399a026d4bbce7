"""PyTorch port: elastic supervision (``resilience/elastic.py``) and the elastic
pieces of the mesh, the fault plan and the stage manifest, against the JAX
package.

Every supervisor scenario of ``tests/test_elastic.py`` runs through the JAX
``ElasticSupervisor`` and the port's with the same scripted fake children
(``spawn`` injected, so no process starts): the two ``events`` lists must be
equal, and so must the workers' argv but for the module each launches. The
control plane (request files, ``stage_barrier``, ``survivors``,
``classify_rc``, ``RestartBudget``, the relaunch environment) and the
``run_mesh`` remap give the JAX outputs on the same inputs. The real 2-rank
drill of the port's CLI is in ``tests/test_torch_postmortem.py``.
"""

import json
import os
import time

import pytest

from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu.resilience import elastic as jax_elastic
from data_diet_distributed_tpu.resilience import inject as jax_inject
from data_diet_distributed_tpu.resilience import stages as jax_stages
from data_diet_distributed_tpu.resilience.preemption import Preempted as JaxPreempted
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.parallel import mesh as torch_mesh
from data_diet_distributed_tpu_torch.resilience import elastic
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.resilience import stages
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted

SIDES = {"jax": (jax_elastic, jax_load_config), "torch": (elastic, load_config)}


class _ListLogger:
    def __init__(self):
        self.records = []

    def log(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


class _FakeProc:
    def __init__(self, rc):
        self.returncode = None
        self._rc = rc

    def poll(self):
        self.returncode = self._rc
        return self._rc

    def wait(self, timeout=None):
        self.returncode = self._rc
        return self._rc

    def terminate(self):
        pass

    kill = terminate


class _WedgedProc:
    """Never exits on its own: the supervisor's reap is its only way out."""

    def __init__(self):
        self.returncode = None

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        assert self.returncode is not None, "waited on a running fake"
        return self.returncode

    def terminate(self):
        self.returncode = -15

    def kill(self):
        self.returncode = -9


def _normalized(events):
    """The coordinator is a free port and a request's ``ts`` a clock: equal in
    kind, not in number."""
    out = []
    for e in events:
        e = dict(e, coordinator=None) if e.get("coordinator") else dict(e)
        if isinstance(e.get("request"), dict):
            e["request"] = {k: v for k, v in e["request"].items() if k != "ts"}
        out.append(e)
    return out


def _argv_tail(argv):
    """A worker's argv past the interpreter and the module (the one
    difference between the packages), the free port left out."""
    assert argv[1] == "-m" and argv[2] in ("data_diet_distributed_tpu.cli",
                                           "data_diet_distributed_tpu_torch.cli")
    return [a.split(":")[0] if a.startswith("mesh.coordinator_address=") else a
            for a in argv[3:]]


def _drive(side, tmp_path, *, attempts=None, procs=None, over=None, before_classify=None,
           poll_in_classify=False):
    """One supervised run on ``side``: children replay ``attempts``
    (per-attempt exit codes by rank) or come from ``procs(world, rank,
    attempt)``; ``before_classify(mod, sup, ckpt)`` runs when attempt 0 is
    classified. Returns the events, the records, the spawns, the rc and the
    supervisor."""
    mod, load = SIDES[side]
    ckpt = str(tmp_path / side / "ckpt")
    base = {"elastic.world": 2, "elastic.backoff_s": 0, "elastic.reap_timeout_s": 1}
    base.update(over or {})
    cfg = load(None, [f"train.checkpoint_dir={ckpt}", "elastic.enabled=true"]
               + [f"{k}={v}" for k, v in base.items()])
    logger = _ListLogger()
    spawned = []
    holder = {}

    def spawn(world, rank, attempt, coordinator):
        sup = holder["sup"]
        spawned.append({"world": world, "rank": rank, "attempt": attempt,
                        "argv": _argv_tail(sup._child_argv(world, rank))})
        if procs is not None:
            return procs(world, rank, attempt)
        rcs = attempts[min(attempt, len(attempts) - 1)]
        return _FakeProc(rcs[rank] if rank < len(rcs) else 0)

    sup = mod.ElasticSupervisor(cfg, "train", overrides=[], logger=logger, spawn=spawn)
    holder["sup"] = sup
    if before_classify is not None or poll_in_classify:
        real = sup._classify

        def classify(rcs):
            if sup.attempt == 0 and before_classify is not None:
                before_classify(mod, sup, ckpt)
            if poll_in_classify:
                sup._poll_join_request()
            return real(rcs)
        sup._classify = classify
    rc = sup.run()
    return {"rc": rc, "events": _normalized(sup.events), "records": logger.records,
            "spawned": spawned, "sup": sup, "ckpt": ckpt}


def _both(tmp_path, **kw):
    jax_out = _drive("jax", tmp_path, **kw)
    torch_out = _drive("torch", tmp_path, **kw)
    assert torch_out["events"] == jax_out["events"]
    assert torch_out["spawned"] == jax_out["spawned"]
    assert torch_out["rc"] == jax_out["rc"]
    assert torch_out["sup"].lineage_block()["worlds"] == jax_out["sup"].lineage_block()["worlds"]
    return torch_out


def _wedged_then(code):
    def procs(world, rank, attempt):
        if attempt == 0:
            return _WedgedProc() if rank == 0 else _FakeProc(code)
        return _FakeProc(0)
    return procs


def _join(reason, **kw):
    def hook(mod, sup, ckpt):
        mod.request_join(ckpt, reason=reason, **kw)
    return hook


def _corrupt_resize(mod, sup, ckpt):
    mod._write_request(mod.resize_request_path(ckpt), {"corrupt": True})


SCENARIOS = {
    # Attempt 0: rank 1 dies by SIGKILL, rank 0 exits 69; attempt 1 (world 1)
    # completes.
    "shrink_on_host_loss": dict(attempts=[[69, -9], [0]]),
    "restart_budget_bounded": dict(attempts=[[69, 69]], over={"elastic.max_restarts": 2}),
    "reaped_survivors_not_dead": dict(procs=_wedged_then(-9),
                                      over={"elastic.reap_timeout_s": 0.3}),
    "reap_on_positive_exit": dict(procs=_wedged_then(1),
                                  over={"elastic.reap_timeout_s": 0.3}),
    "invalid_resize_cleared": dict(attempts=[[75, 75], [0, 0]],
                                   before_classify=_corrupt_resize),
    "preempted_join_grows": dict(attempts=[[75, 75], [0, 0, 0]],
                                 over={"elastic.max_world": 3},
                                 before_classify=_join("late host", ranks=1)),
    "join_at_max_denied": dict(attempts=[[75, 75], [0, 0]], over={"elastic.max_world": 2},
                               before_classify=_join("no room", ranks=1)),
    "never_below_min_world": dict(attempts=[[-9, -9], [0, 0]],
                                  over={"elastic.min_world": 2}),
    "grow_at_stage_boundary": dict(attempts=[[75], [0, 0]],
                                   over={"elastic.world": 1, "elastic.max_world": 2},
                                   before_classify=_join("host back", ranks=1),
                                   poll_in_classify=True),
    "clean_run": dict(attempts=[[0, 0]]),
    "preempted_exit_without_resume": dict(attempts=[[75, 75]],
                                          over={"elastic.resume_preempted": "false"}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_events_match_jax(tmp_path, name):
    out = _both(tmp_path, **SCENARIOS[name])
    events = [e["event"] for e in out["events"]]
    if name == "shrink_on_host_loss":
        assert out["rc"] == 0 and events[-1] == "complete"
        shrink = next(e for e in out["events"] if e["event"] == "shrink")
        assert shrink["dead_ranks"] == [1] and shrink["new_world"] == 1
        relaunch = [s for s in out["spawned"] if s["attempt"] == 1]
        assert len(relaunch) == 1 and "train.resume=true" in relaunch[0]["argv"]
        assert "mesh.multihost=false" in relaunch[0]["argv"]
    elif name == "restart_budget_bounded":
        assert out["rc"] == 69 and events.count("restart") == 2
        assert events[-1] == "give_up" and len(out["spawned"]) == 6
    elif name == "reaped_survivors_not_dead":
        shrink = next(e for e in out["events"] if e["event"] == "shrink")
        assert shrink["dead_ranks"] == [1] and shrink["reaped_ranks"] == [0]
    elif name == "reap_on_positive_exit":
        assert "reap_timeout" in events and "shrink" not in events and "restart" in events
    elif name == "invalid_resize_cleared":
        assert "resize_invalid" in events and events.count("restart") == 1
        assert elastic.read_resize_request(out["ckpt"]) is None
    elif name == "preempted_join_grows":
        assert next(e for e in out["events"] if e["event"] == "grow")["new_world"] == 3
        assert "restart" not in events
    elif name == "join_at_max_denied":
        assert "join_denied" in events and elastic.read_join_request(out["ckpt"]) is None
    elif name == "never_below_min_world":
        assert next(e for e in out["events"] if e["event"] == "shrink")["new_world"] == 2
    elif name == "grow_at_stage_boundary":
        assert "join_requested" in events and "grow" in events
        assert [s["world"] for s in out["spawned"] if s["attempt"] == 1] == [2, 2]
        assert out["sup"].restarts_left == out["sup"].cfg.elastic.max_restarts
    elif name == "preempted_exit_without_resume":
        assert out["rc"] == 75 and events[-1] == "preempted_exit"


@pytest.mark.parametrize("case", ["shrink", "grow"])
def test_supervisor_keeps_whole_model_groups(tmp_path, case):
    """With ``mesh.model_axis=2`` the port's supervisor keeps whole model
    groups: 4 ranks that lost one relaunch as 2 (a relaunch at 3 would fail
    ``remap_mesh``), a join of one rank grows 2 to 4, and the default floor of
    1 rounds up to 2. A world the axis cannot tile is refused by name."""
    over = {"mesh.model_axis": 2, "elastic.max_world": 4}
    if case == "shrink":
        out = _drive("torch", tmp_path, attempts=[[69, 69, 69, -9], [0, 0]],
                     over={**over, "elastic.world": 4})
        event = next(e for e in out["events"] if e["event"] == "shrink")
        assert event["dead_ranks"] == [3] and event["new_world"] == 2
    else:
        out = _drive("torch", tmp_path, attempts=[[75, 75], [0, 0, 0, 0]],
                     over={**over, "elastic.world": 2},
                     before_classify=_join("host back", ranks=1))
        assert next(e for e in out["events"] if e["event"] == "grow")["new_world"] == 4
    relaunch = [s["world"] for s in out["spawned"] if s["attempt"] == 1]
    assert out["rc"] == 0 and len(set(relaunch)) == 1 and relaunch[0] % 2 == 0
    assert out["sup"].min_world == 2
    for bad in (["elastic.world=3"], ["elastic.max_world=5"]):
        with pytest.raises(ValueError, match="model_axis"):
            load_config(None, ["mesh.model_axis=2", *bad])


def test_join_is_not_dropped_while_a_resize_is_pending(tmp_path):
    outs = {}
    for side, (mod, _) in SIDES.items():
        out = _drive(side, tmp_path, attempts=[[0, 0]], over={"elastic.max_world": 4})
        sup, ckpt = out["sup"], out["ckpt"]
        mod.request_resize(ckpt, 3, reason="already in flight")
        mod.request_join(ckpt, ranks=1, reason="second host")
        sup._poll_join_request()
        standing = mod.read_join_request(ckpt) is not None
        mod.clear_resize_request(ckpt)
        sup._poll_join_request()
        outs[side] = (standing, mod.read_join_request(ckpt),
                      mod.read_resize_request(ckpt)["world"],
                      _normalized(sup.events)[-1])
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][:3] == (True, None, 3)
    assert outs["torch"][3]["event"] == "join_requested"


def test_request_files_roundtrip_like_jax(tmp_path):
    for side, (mod, _) in SIDES.items():
        ckpt = str(tmp_path / side / "ckpt")
        assert mod.read_join_request(ckpt) is None
        mod.request_join(ckpt, ranks=2, reason="node arrived")
        req = mod.read_join_request(ckpt)
        assert (req["ranks"], req["reason"]) == (2, "node arrived")
        mod.clear_join_request(ckpt)
        assert mod.read_join_request(ckpt) is None
        mod.request_resize(ckpt, 4, reason="grow")
        assert mod.read_resize_request(ckpt)["world"] == 4
        mod.clear_resize_request(ckpt)
        mod.clear_resize_request(ckpt)   # absent: a no-op
        with open(mod.join_request_path(ckpt), "w") as fh:
            fh.write("{torn")
        assert mod.read_join_request(ckpt) == {"corrupt": True}
        assert os.path.relpath(mod.join_request_path(ckpt), tmp_path / side) \
            == os.path.join("ckpt_elastic", "join.json")
    assert elastic.checkpoint_dir_from_manifest("/a/b/ckpt_stages.json") == "/a/b/ckpt"
    with pytest.raises(ValueError):
        elastic.checkpoint_dir_from_manifest("/a/b/other.json")


@pytest.mark.parametrize("request_kind", ["resize", "join"])
def test_stage_barrier_exits_cleanly_like_jax(tmp_path, request_kind):
    outs = {}
    for side, (mod, load) in SIDES.items():
        preempted = JaxPreempted if side == "jax" else Preempted
        cfg = load(None, [f"train.checkpoint_dir={tmp_path}/{side}/ckpt",
                          "elastic.enabled=true"])
        logger = _ListLogger()
        mod.stage_barrier(cfg, logger, boundary="retrain:final")   # nothing pending
        if request_kind == "resize":
            mod.request_resize(cfg.train.checkpoint_dir, 2, reason="join")
        else:
            mod.request_join(cfg.train.checkpoint_dir, reason="arrived late")
        with pytest.raises(preempted) as exc:
            mod.stage_barrier(cfg, logger, boundary="retrain:final")
        assert exc.value.signame == "ELASTIC"
        cfg.elastic.enabled = False
        mod.stage_barrier(cfg, logger, boundary="retrain:final")   # off: never
        outs[side] = logger.records
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][-1]["event"] == ("resize_honored" if request_kind == "resize"
                                          else "join_pending")


def test_stage_barrier_takes_a_log_callable(tmp_path):
    """The pipeline's ``log(kind, **fields)`` (not only a ``.log`` object)."""
    cfg = load_config(None, [f"train.checkpoint_dir={tmp_path}/ckpt", "elastic.enabled=true"])
    seen = []
    elastic.request_resize(cfg.train.checkpoint_dir, 3)
    with pytest.raises(Preempted):
        elastic.stage_barrier(cfg, lambda kind, **f: seen.append((kind, f)),
                              boundary="retrain:final_s0p5")
    assert seen == [("elastic_event", {"event": "resize_honored",
                                       "boundary": "retrain:final_s0p5", "world": 3,
                                       "reason": ""})]


def test_survivors_classify_rc_and_budget_match_jax(tmp_path):
    from data_diet_distributed_tpu_torch.obs.heartbeat import Heartbeat
    hb_dir = str(tmp_path / "hb")
    now = time.time()
    for rank in (0, 1, 2):
        Heartbeat(hb_dir, rank, min_interval_s=0).beat(step=5, force=True)
    path = os.path.join(hb_dir, "heartbeat_rank1.json")
    rec = json.load(open(path))
    rec["ts"] = now - 120.0
    json.dump(rec, open(path, "w"))
    for stale in (30.0, 200.0):
        assert elastic.survivors(hb_dir, 3, stale_after_s=stale, now=now) \
            == jax_elastic.survivors(hb_dir, 3, stale_after_s=stale, now=now)
    assert elastic.survivors(hb_dir, 3, stale_after_s=30.0, now=now) == ([0, 2], [1])
    assert elastic.survivors(None, 3) == jax_elastic.survivors(None, 3) == ([0, 1, 2], [])
    for rc in (0, 75, 69, 13, 1, -9, 2):
        assert elastic.classify_rc(rc) == jax_elastic.classify_rc(rc)
    assert (elastic.EXIT_PREEMPTED, elastic.EXIT_RETRIABLE, elastic.EXIT_DIVERGED,
            elastic.CHILD_ENV) == (jax_elastic.EXIT_PREEMPTED, jax_elastic.EXIT_RETRIABLE,
                                   jax_elastic.EXIT_DIVERGED, jax_elastic.CHILD_ENV)
    a, b = elastic.RestartBudget(3, 0.5), jax_elastic.RestartBudget(3, 0.5)
    waits = []
    for exponent in (0, 1, 9):
        waits.append((a.spend(exponent), b.spend(exponent), a.exhausted(), b.exhausted()))
    assert all(x[0] == x[1] and x[2] == x[3] for x in waits)
    assert waits[-1] == (32.0, 32.0, True, True)


def test_clear_rank_artifacts_archives_like_jax(tmp_path):
    from data_diet_distributed_tpu_torch.obs.heartbeat import Heartbeat
    listings = {}
    for side, (mod, _) in SIDES.items():
        root = tmp_path / side
        hb = str(root / "hb")
        for rank in (0, 1):
            Heartbeat(hb, rank, min_interval_s=0).beat(step=3, force=True)
        side_dir = root / "ckpt_sidechannel"
        side_dir.mkdir(parents=True)
        (side_dir / "poison.rank1.json").write_text("{}")
        mod.clear_rank_artifacts(str(root / "ckpt"), hb, [1], attempt=2)
        listings[side] = (sorted(os.listdir(hb)), sorted(os.listdir(side_dir)))
    assert listings["torch"] == listings["jax"]
    assert "heartbeat_rank1.json.a2" in listings["torch"][0]


def test_relaunch_argv_strips_the_plan_and_forwards_the_device(tmp_path, monkeypatch):
    """``_spawn_local``: the env fault plan fires in attempt 0 only, every
    worker runs the port's CLI with the supervisor's ``--device``, and the
    JAX supervisor builds the same environment."""
    import subprocess as sp
    captured = {}

    def fake_popen(argv, stdout=None, stderr=None, env=None):
        captured[(argv[2], int(env["DDT_ELASTIC_ATTEMPT"]))] = (argv, env)
        return _FakeProc(0)

    monkeypatch.setattr(sp, "Popen", fake_popen)
    monkeypatch.setenv("DDT_FAULT_PLAN", '{"sigterm_at_epoch_end": 0}')
    for side, (mod, load) in SIDES.items():
        cfg = load(None, [f"train.checkpoint_dir={tmp_path}/{side}/ckpt",
                          "elastic.enabled=true", "elastic.world=2"])
        kw = {"device": "cpu"} if side == "torch" else {}
        sup = mod.ElasticSupervisor(cfg, "run", overrides=["data.synthetic_size=64"], **kw)
        sup._coordinator = "127.0.0.1:1"
        sup._spawn_local(2, 1, 0, "127.0.0.1:1")
        sup.attempt = 1
        sup._spawn_local(1, 0, 1, "127.0.0.1:1")
    (t0, e0), (t1, e1) = (captured[("data_diet_distributed_tpu_torch.cli", a)] for a in (0, 1))
    (j0, f0), (j1, f1) = (captured[("data_diet_distributed_tpu.cli", a)] for a in (0, 1))
    assert e0["DDT_FAULT_PLAN"] == f0["DDT_FAULT_PLAN"] == '{"sigterm_at_epoch_end": 0}'
    assert "DDT_FAULT_PLAN" not in e1 and "DDT_FAULT_PLAN" not in f1
    assert e0[elastic.CHILD_ENV] == "1"
    for k in ("DDT_ELASTIC_ATTEMPT", "DDT_ELASTIC_WORLD", "DDT_RUN_ID"):
        assert k in e1
    assert t0[3:6] == ["run", "--device", "cpu"]
    assert t0[6:] == j0[4:] and t1[6:] == j1[4:]   # the overrides and the mesh keys
    assert t0[-4:] == ["mesh.multihost=true", "mesh.coordinator_address=127.0.0.1:1",
                       "mesh.num_processes=2", "mesh.process_id=1"]
    assert t1[-2:] == ["mesh.multihost=false", "train.resume=true"]


def test_jsonl_logger_matches_jax_shape(tmp_path):
    from data_diet_distributed_tpu.obs import lineage as jax_lineage
    from data_diet_distributed_tpu_torch.obs import lineage
    out = {}
    for side, mod, lin in (("jax", jax_elastic, jax_lineage), ("torch", elastic, lineage)):
        prev = lin.current()
        lin.install(lin.Lineage(run_id="runB", attempt=1))
        try:
            logger = mod.JsonlLogger(str(tmp_path / f"{side}.jsonl"), echo=False)
            logger.log("elastic_event", event="launch", attempt=2, world=4)
            logger.close()
        finally:
            lin.install(prev) if prev else lin.uninstall()
        rec = json.loads(open(tmp_path / f"{side}.jsonl").read())
        rec.pop("ts")
        out[side] = rec
    assert out["torch"] == out["jax"]
    assert out["torch"]["attempt"] == 2 and out["torch"]["run_id"] == "runB"


@pytest.mark.parametrize("world", [1, 3, 8])
def test_run_mesh_remaps_a_stale_data_axis_like_jax(world):
    import jax
    from data_diet_distributed_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from data_diet_distributed_tpu.parallel.mesh import remap_mesh as jax_remap
    from data_diet_distributed_tpu.parallel.mesh import run_mesh as jax_run_mesh
    cfg, jcfg = load_config(None, ["mesh.data_axis=16"]), jax_load_config(None, ["mesh.data_axis=16"])
    with pytest.raises(ValueError):
        torch_mesh.run_mesh(cfg.mesh, elastic=False, world=world)
    with pytest.raises(ValueError):
        jax_make_mesh(jcfg.mesh, devices=jax.devices()[:world])
    got = torch_mesh.run_mesh(cfg.mesh, elastic=True, world=world)
    want = jax_remap(jcfg.mesh, devices=jax.devices()[:world])
    assert (got.data, got.model) == (want.shape["data"], want.shape["model"]) == (world, 1)
    if world == len(jax.devices()):
        assert jax_run_mesh(jcfg.mesh, elastic=True).shape["data"] == got.data
    # An unpinned or a matching pin is left as it is.
    assert torch_mesh.remap_mesh(load_config(None, [f"mesh.data_axis={world}"]).mesh,
                                 world).data == world


def test_relaunched_world_keeps_a_pinned_data_axis_under_elastic():
    """A shrunken relaunch carries the first world's pin with the new
    process count: the config accepts it under elastic only."""
    keys = ["mesh.multihost=true", "mesh.coordinator_address=127.0.0.1:1",
            "mesh.num_processes=3", "mesh.process_id=0", "mesh.data_axis=4"]
    with pytest.raises(ValueError, match="data_axis"):
        load_config(None, keys)
    assert load_config(None, keys + ["elastic.enabled=true"]).mesh.data_axis == 4


def test_rejoin_after_stage_writes_a_join_request_like_jax(tmp_path):
    outs = {}
    for side, st, inj, mod in (("jax", jax_stages, jax_inject, jax_elastic),
                               ("torch", stages, inject, elastic)):
        ckpt = str(tmp_path / side / "ckpt")
        manifest = st.StageManifest(f"{ckpt}_stages.json", "fp", enabled=True)
        inj.activate(inj.FaultPlan(rejoin_after_stage="score"))
        try:
            manifest.start("score")
            assert mod.read_join_request(ckpt) is None   # started is not done
            manifest.complete("score", n=10)
        finally:
            inj.deactivate()
        req = mod.read_join_request(ckpt)
        req.pop("ts")
        mod.clear_join_request(ckpt)
        manifest.complete("score", n=10)   # fired once: no second request
        outs[side] = (req, mod.read_join_request(ckpt))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == {"ranks": 1, "reason": "injected rejoin after score"}


def test_elastic_config_validation_matches_jax():
    bad = [["elastic.world=4", "elastic.max_world=2"],
           ["elastic.world=1", "elastic.min_world=3", "elastic.max_world=3"],
           ["elastic.world=0"], ["elastic.min_world=0"], ["elastic.max_restarts=-1"],
           ["elastic.backoff_s=-1"], ["elastic.reap_timeout_s=0"],
           ["checkpoint.drain_timeout_s=0"], ["checkpoint.promote_delay_s=-1"],
           ["obs.slo_recovery_s=0"]]
    for over in bad:
        with pytest.raises(ValueError):
            jax_load_config(None, over)
        with pytest.raises(ValueError):
            load_config(None, over)
    good = ["elastic.enabled=true", "elastic.world=2", "elastic.max_world=4",
            "checkpoint.local_tier=true", "checkpoint.local_dir=/x", "obs.slo_recovery_s=30"]
    t, j = load_config(None, good), jax_load_config(None, good)
    assert vars(t.elastic) == vars(j.elastic)
    assert vars(t.checkpoint) == vars(j.checkpoint)
    assert t.obs.slo_recovery_s == j.obs.slo_recovery_s == 30
    for key in ("elastic.bogus=1", "checkpoint.bogus=1"):
        with pytest.raises(KeyError):
            load_config(None, [key])


def test_cli_metrics_record_counts_the_kernels_launches(tmp_path, monkeypatch, capsys):
    """A worker's ``metrics`` record carries its process's kernel launches
    (``kernel_launches:<name>`` gauges, nonzero ones only): how a supervisor's
    reader tells which kernels a relaunched attempt ran."""
    from data_diet_distributed_tpu_torch import cli
    from data_diet_distributed_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, "launch_counts",
                        lambda: {"el2n": 3, "conv_grad_norm_gram": 0})
    metrics = tmp_path / "m.jsonl"
    assert cli.main(["score", "--device", "cpu", "data.dataset=synthetic",
                     "data.synthetic_size=32", "model.arch=tiny_cnn",
                     "train.half_precision=false", "score.pretrain_epochs=0",
                     "score.method=el2n", "score.seeds=[0]", "score.batch_size=16",
                     f"train.checkpoint_dir={tmp_path}/ckpt",
                     f"obs.metrics_path={metrics}"]) == 0
    recs = [json.loads(line) for line in open(metrics)]
    gauges = [r for r in recs if r["kind"] == "metrics"][-1]["gauges"]
    assert gauges["kernel_launches:el2n"] == 3
    assert "kernel_launches:conv_grad_norm_gram" not in gauges
    assert recs[-1]["kind"] == "run_summary" and recs[-1]["exit_class"] == "ok"
