"""PyTorch port: the observability units against their JAX twins, on the same
seeded inputs: score statistics and cross-seed stability (equal to 1e-12),
the weight update's collective bytes (exact), the training SLO verdicts and
the ledger baseline, the fleet view, the staleness line and the watchdog's
diagnosis, the flight recorder, the tracer, the profile window's schedule and
the lineage stamp (equal); and the port-only parts on the CPU: the memory
monitor stands down, a tensor field is summarized, the unported ``obs`` keys
refuse by name, and ``kernel_work`` is the count the on-card bounds use."""

import json
import math
import os
import time

import jax
import numpy as np
import pytest
import torch

from data_diet_distributed_tpu.models import create_model as jax_create_model
from data_diet_distributed_tpu.obs import comm as jcomm
from data_diet_distributed_tpu.obs import fleet as jfleet
from data_diet_distributed_tpu.obs import flightrec as jflightrec
from data_diet_distributed_tpu.obs import heartbeat as jheartbeat
from data_diet_distributed_tpu.obs import lineage as jlineage
from data_diet_distributed_tpu.obs import profiler as jprofiler
from data_diet_distributed_tpu.obs import scoreboard as jscoreboard
from data_diet_distributed_tpu.obs import slo as jslo
from data_diet_distributed_tpu.obs import tracing as jtracing
from data_diet_distributed_tpu.parallel.mesh import UpdateSharding as JaxUpdateSharding
from data_diet_distributed_tpu.resilience.watchdog import Watchdog as JaxWatchdog
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.obs import (comm, fleet, flightrec, heartbeat,
                                                 introspect, lineage, profiler,
                                                 scoreboard, slo, tracing)
from data_diet_distributed_tpu_torch.ops import kernels
from data_diet_distributed_tpu_torch.parallel.mesh import Mesh, UpdateSharding
from data_diet_distributed_tpu_torch.resilience.watchdog import Watchdog
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.weights import params_from_flax

NOW = 1_800_000_000.0


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny ops: the test workers share
    the machine's cores, and oversubscribed thread pools make each op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def frozen_time(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    return NOW


def test_score_statistics_match_jax():
    rng = np.random.default_rng(0)
    seeds = {s: rng.standard_normal(300) for s in (0, 3, 7)}
    seeds[3][[5, 9]] = seeds[3][[7, 11]]   # ties
    a = seeds[0].copy()
    a[[1, 2]] = [np.nan, np.inf]
    got, want = scoreboard.score_stats(a, 16), jscoreboard.score_stats(a, 16)
    assert got.keys() == want.keys()
    for k in ("n", "nan_count", "inf_count"):
        assert got[k] == want[k]
    for k in ("mean", "std", "min", "max", "p5", "p50", "p95"):
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    assert got["hist"]["counts"] == want["hist"]["counts"]
    np.testing.assert_allclose(got["hist"]["edges"], want["hist"]["edges"], atol=1e-12)
    got, want = (scoreboard.rank_stability(seeds, (0.3, 0.5)),
                 jscoreboard.rank_stability(seeds, (0.3, 0.5)))
    assert got.keys() == want.keys() and got["overlap_at_keep"] == want["overlap_at_keep"]
    np.testing.assert_allclose(got["spearman_pairwise"], want["spearman_pairwise"], atol=1e-12)
    for k in ("spearman_pairwise_mean", "spearman_pairwise_min", "spearman_vs_mean_mean"):
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    for k in (1, 30, 299):
        assert scoreboard.overlap_at_k(seeds[0], seeds[3], k) == pytest.approx(
            jscoreboard.overlap_at_k(seeds[0], seeds[3], k), abs=1e-12)


def test_update_comm_bytes_match_jax():
    model = jax_create_model("tiny_cnn", 10)
    tree = jax.device_get(jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), train=False))
    port_model = create_model("tiny_cnn", 10)
    sd = params_from_flax(tree, port_model)
    params = {k: sd[k] for k, _ in port_model.named_parameters()}
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    mesh = Mesh(2)
    for jshard, shard in ((None, None), (JaxUpdateSharding(jmesh), UpdateSharding(2, 0))):
        want = jcomm.estimate_update_comm(tree["params"], jmesh, jshard)
        got = comm.estimate_update_comm(params, mesh, shard)
        assert got == want
    assert comm.estimate_update_comm(params, Mesh(1))["bytes_per_step"] == 0


def test_update_comm_bytes_match_jax_with_a_model_axis():
    """At ``{data: 2, model: 2}`` a rank holds 5 of the head's 10 rows; the
    bytes are the whole tree's, and the head's weight shards its other dim
    over ``data``, as JAX's global arrays and TP specs count them."""
    model = jax_create_model("tiny_cnn", 10)
    tree = jax.device_get(jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), train=False))
    port_model = create_model("tiny_cnn", 10)
    sd = params_from_flax(tree, port_model)
    params = {k: (sd[k][:5] if k.startswith("classifier.") else sd[k])
              for k, _ in port_model.named_parameters()}
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    mesh = Mesh(2, 2)
    for jshard, shard in ((None, None), (JaxUpdateSharding(jmesh), UpdateSharding(2, 0, 2))):
        want = jcomm.estimate_update_comm(tree["params"], jmesh, jshard)
        got = comm.estimate_update_comm(params, mesh, shard)
        assert got == want


def _ledger(path):
    rows = [{"kind": "perf_history", "examples_per_s": v, "backend": b,
             "geometry": {"arch": "tiny_cnn"}, "exit_class": e}
            for v, b, e in ((100.0, "cpu", "ok"), (120.0, "cpu", "ok"), (500.0, "tpu", "ok"),
                            (90.0, "cpu", "fatal:X"), (110.0, "cpu", "ok"))]
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
            fh.write("not json\n")


def _beats(directory, stamps):
    os.makedirs(directory, exist_ok=True)
    for rank, (ts, step) in stamps.items():
        with open(os.path.join(directory, f"heartbeat_rank{rank}.json"), "w") as fh:
            json.dump({"rank": rank, "ts": ts, "step": step, "epoch": 1,
                       "stage": "final", "host": "h"}, fh)


def test_training_slos_and_ledger_baseline_match_jax(tmp_path, frozen_time):
    ledger = str(tmp_path / "ledger.jsonl")
    _ledger(ledger)
    for backend in ("cpu", "tpu", None):
        assert slo.ledger_baseline(ledger, geometry={"arch": "tiny_cnn"}, backend=backend) \
            == jslo.ledger_baseline(ledger, geometry={"arch": "tiny_cnn"}, backend=backend)
    hb_dir = str(tmp_path / "hb")
    _beats(hb_dir, {0: (NOW - 1.0, 40), 1: (NOW - 30.0, 31)})
    kw = dict(throughput_floor=50.0, throughput_frac=0.9, ledger=ledger,
              heartbeat_stale_s=10.0, nonfinite_frac=0.0, eval_accuracy_floor=0.5,
              geometry={"arch": "tiny_cnn"})
    port, jaxe = slo.SloEngine(backend="cpu", **kw), jslo.SloEngine(**kw)
    heartbeat.install(heartbeat.Heartbeat(hb_dir, 0))
    jheartbeat.install(jheartbeat.Heartbeat(hb_dir, 0))
    try:
        for engine in (port, jaxe):
            for epoch, (eps, acc, steady) in enumerate(((10.0, 0.9, False), (95.0, 0.4, True),
                                                        (120.0, 0.6, True), (95.0, 0.4, True))):
                engine.check_epoch(tag="final", epoch=epoch % 3, examples_per_s=eps,
                                   eval_accuracy=acc, steady=steady)
            engine.check_scores("grand", np.array([1.0, np.nan, 2.0]))
            engine.check_scores("grand", np.array([1.0, np.inf, 2.0]))
    finally:
        heartbeat.uninstall()
        jheartbeat.uninstall()
    assert port.verdict() == jaxe.verdict()
    assert port.total_violations == jaxe.total_violations > 0


def test_fleet_view_staleness_and_watchdog_diagnosis_match_jax(tmp_path, frozen_time):
    hb_dir = str(tmp_path / "hb")
    _beats(hb_dir, {0: (NOW - 2.0, 12), 1: (NOW - 75.5, 9), 2: (NOW - 3.0, 12)})
    assert fleet.fleet_view(hb_dir) == jfleet.fleet_view(hb_dir)
    assert fleet.fleet_view(hb_dir, stale_budget_s=100.0) == \
        jfleet.fleet_view(hb_dir, stale_budget_s=100.0)
    assert fleet.fleet_view(str(tmp_path / "none")) is None
    line = heartbeat.describe_stale(hb_dir)
    assert line == jheartbeat.describe_stale(hb_dir) and line.startswith("rank1 ")
    heartbeat.install(heartbeat.Heartbeat(hb_dir, 0))
    jheartbeat.install(jheartbeat.Heartbeat(hb_dir, 0))
    try:
        got = str(Watchdog(5.0, label="final step loop",
                           diagnose=heartbeat.describe)._timeout_error())
        want = str(JaxWatchdog(5.0, label="final step loop",
                               diagnose=jheartbeat.describe)._timeout_error())
    finally:
        heartbeat.uninstall()
        jheartbeat.uninstall()
    assert got == want and "rank1 last progress 75.5s ago" in got
    # A departed rank's heartbeat moved aside, as the elastic supervisor does.
    for mod, d in ((heartbeat, "p"), (jheartbeat, "j")):
        _beats(str(tmp_path / d), {0: (NOW, 3), 1: (NOW - 9.0, 2)})
        assert mod.archive_heartbeat(str(tmp_path / d), 1, attempt=2)
    assert heartbeat.read_heartbeat_residue(str(tmp_path / "p")) == \
        jheartbeat.read_heartbeat_residue(str(tmp_path / "j"))
    assert sorted(heartbeat.read_heartbeats(str(tmp_path / "p"))) == [0]


def test_flight_recorder_matches_jax(tmp_path, frozen_time):
    events = [("epoch", {"epoch": 1, "loss": np.float32(0.5), "arr": np.arange(4)}),
              ("fault", {"fault": "divergence", "big": np.zeros((8, 8)), "n": None}),
              ("signal", {"signal": "SIGTERM", "nested": {"a": (1, 2.5)}})]
    lineage.install(lineage.Lineage("run-1"))
    jlineage.install(jlineage.Lineage("run-1"))
    try:
        port = flightrec.FlightRecorder(str(tmp_path / "p"), rank=1, capacity=2)
        jax_rec = jflightrec.FlightRecorder(str(tmp_path / "j"), rank=1, capacity=2)
        for kind, fields in events:
            port.record(kind, **fields)
            jax_rec.record(kind, **fields)
        assert port.snapshot() == jax_rec.snapshot() and len(port.snapshot()) == 2
        got = json.load(open(port.dump("divergence:epoch1")))
        want = json.load(open(jax_rec.dump("divergence:epoch1")))
    finally:
        lineage.uninstall()
        jlineage.uninstall()
    assert os.path.basename(port.dump("x")) == "flightrec_rank1.json"
    for d in (got, want):
        d.pop("pid")
    assert got == want
    assert flightrec.read_dumps(str(tmp_path / "p"))[0]["reason"] == "x"
    for v in (np.float64(2.5), np.array([1, 2]), np.zeros(64), "s", [np.int8(3)]):
        assert flightrec.json_safe(v) == jflightrec.json_safe(v)
    assert flightrec.json_safe(torch.tensor(3.5)) == 3.5
    assert flightrec.json_safe(torch.arange(3)) == [0, 1, 2]
    assert flightrec.json_safe(torch.zeros(64)).startswith("<tensor shape=(64,)")


def test_tracer_events_read_back_as_jax(tmp_path):
    def drive(mod, path):
        tr = mod.Tracer(path, rank=0)
        with tr.span("run", cat="run", command="run"):
            with tr.span("score", cat="stage"):
                t0 = time.perf_counter()
                with tr.span("seed", cat="seed", seed=3, role="score_pretrain"):
                    tr.instant("seed_scored", cat="seed", seed=3)
                tr.complete("epoch", t0, cat="epoch", epoch=0, tag="x")
        tr.close()
        return mod.read_trace(path)

    got = drive(tracing, str(tmp_path / "p.json"))
    want = drive(jtracing, str(tmp_path / "j.json"))

    def shape(events):
        return [(e["ph"], e["name"], e.get("cat"), e.get("args"), e.get("tid"))
                for e in events]
    assert shape(got) == shape(want)
    assert tracing.trace_path_for("t.json", 2, 1) == jtracing.trace_path_for("t.json", 2, 1)


def test_profile_window_schedule_matches_jax(tmp_path, monkeypatch):
    log = {"port": [], "jax": []}
    unit = {"n": 0}
    monkeypatch.setattr(profiler, "_start_capture",
                        lambda device_type: log["port"].append(("start", unit["n"])))
    monkeypatch.setattr(profiler, "_stop_capture",
                        lambda prof, d, device_type, tag: log["port"].append(
                            ("stop", os.path.basename(d), unit["n"])))
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: log["jax"].append(("start", unit["n"])))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: log["jax"].append(("stop", None, unit["n"])))
    plans = [("a", 0, 3, 2), ("b", 0, 1, 3), ("c", 1, 3, 8), ("a", 0, 2, 2),
             ("d", 0, 2, 1), ("e", 0, 2, 1), ("f", 0, 2, 1)]
    for side, cls in (("port", profiler.ProfileWindow), ("jax", jprofiler.ProfileWindow)):
        cls.reset()
        unit["n"] = 0
        for tag, start, num, chunks in plans:
            w = cls(str(tmp_path), tag, start_epoch=start, num_epochs=num,
                    window_chunks=chunks)
            for epoch in range(start, num):
                for _ in range(4):
                    unit["n"] += 1
                    w.tick(epoch)
                w.epoch_end(epoch)
            w.close()
        cls.reset()
    # The stop's tag: the port names it, the JAX stop_trace takes none.
    port = [(e[0], e[-1]) for e in log["port"]]
    assert port == [(e[0], e[-1]) for e in log["jax"]]
    assert [e[1] for e in log["port"] if e[0] == "stop"] == ["a", "b", "c", "d"]


def test_lineage_stamp_matches_jax(monkeypatch):
    env = {"DDT_RUN_ID": "r-7", "DDT_ELASTIC_ATTEMPT": "2", "DDT_ELASTIC_WORLD": "4"}
    assert lineage.from_env(env) == lineage.Lineage(**vars(jlineage.from_env(env)))
    lineage.install(lineage.from_env(env))
    jlineage.install(jlineage.from_env(env))
    try:
        for rec in ({"kind": "epoch"}, {"kind": "resume", "attempt": 9}):
            assert lineage.stamp(dict(rec)) == jlineage.stamp(dict(rec))
    finally:
        lineage.uninstall()
        jlineage.uninstall()
    assert lineage.suffixed_path("t.json", 3) == jlineage.suffixed_path("t.json", 3)
    assert lineage.from_env({}).attempt == 0 and lineage.from_env({}).world is None


def test_memory_monitor_stands_down_on_cpu_and_kernels_report_work():
    assert introspect.HbmMonitor(device="cpu").poll() is None
    intro = introspect.Introspector(device="cpu")
    x, g = torch.randn(2, 8, 8, 16), torch.randn(2, 8, 8, 16)
    out = intro.call("norms", kernels.conv_grad_norm_sq_v2, (x, g, (3, 3), ((1, 1), (1, 1))),
                     {}, key="k", examples=2)
    assert torch.equal(out, kernels.conv_grad_norm_sq_v2(x, g, (3, 3), ((1, 1), (1, 1))))
    flops, nbytes = kernels.kernel_work("conv_grad_norm_direct", x=(2, 8, 8, 16),
                                        g=(2, 8, 8, 16), kernel_size=(3, 3), itemsize=4)
    assert intro.programs["norms"]["flops"] == flops == 2.0 * 2 * 9 * 64 * 16 * 16
    assert nbytes == (2 * 2 * 8 * 8 * 16) * 4 + 8
    # The formulas the on-card bounds used before they moved into the package.
    b, h, w, c, s, k = 4, 4, 4, 512, 16, 512
    assert kernels.kernel_work("conv_grad_norm_gram", x=(b, h, w, c), g=(b, 4, 4, k),
                               kernel_size=(3, 3), itemsize=2)[0] \
        == 2.0 * b * ((h * w) ** 2 * c + s * s * k) + b * s * s * 11
    assert kernels.kernel_work("el2n", batch=512, classes=10, itemsize=2) \
        == (5.0 * 512 * 10, 512 * 10 * 2 + 512 * 16.0)
    assert math.isclose(introspect.device_peak_flops("cpu")[0] or 0, 0) is False


@pytest.mark.parametrize("key", ["slo_fleet_p95_ms=5",
                                 "slo_fleet_available_frac=0.5", "slo_recovery_s=9"])
def test_unported_obs_keys_refuse_by_name(key):
    """The recovery SLO (ported with the elastic supervisor) and the fleet
    SLOs (ported with the serving fleet) are accepted and armed."""
    name, value = key.split("=")
    cfg = load_config(None, [f"obs.{key}"])
    assert getattr(cfg.obs, name) == float(value)
    assert slo.SloEngine.from_cfg(cfg).objectives() == {name[4:]: float(value)}


def test_mfu_units_leave_out_the_warm_up_and_a_capture(tmp_path, monkeypatch):
    monkeypatch.setattr(profiler, "_start_capture", lambda device_type: object())
    monkeypatch.setattr(profiler, "_stop_capture", lambda *a: None)
    profiler.ProfileWindow.reset()
    window = profiler.ProfileWindow(str(tmp_path), "score", start_epoch=0, num_epochs=3,
                                    window_chunks=2, device_type="cpu")
    for epoch in range(3):
        for _ in range(3):
            window.tick(epoch)
        window.epoch_end(epoch)
    profiler.ProfileWindow.reset()
    assert window.captured_epoch == 1
    assert loop._steady([5.0, 9.0, 2.0], window) == [2.0]
    assert loop._steady([5.0, 2.0, 3.0], None) == [2.0, 3.0]
    assert loop._steady([5.0], None) == [5.0] and loop._steady([], None) == []
