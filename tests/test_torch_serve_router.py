"""PyTorch port: the serving router and the fleet's control logic
(``serve/router.py``, ``serve/fleet.py``, ``obs/slo.py``), held against the
JAX package's on the CPU.

Every router scenario runs once through each package's ``ServeRouter`` against
fresh fake replicas (stdlib HTTP servers) configured the same way; the status
codes, the headers that carry meaning, the counters, the per-attempt trace
rows and the ``replica_event`` / ``model_refresh`` sequences must be equal:
the breaker lifecycle and its half-open single probe, keyed failover, the
keyless 502, GET failover, the breaker routing around a dead replica, the
replay cache, hedging, the bounded 503 when every replica is dead,
stop-admission, the refresh roll and its abort, and the canary hold with its
rollback. The fleets' tuning roll (one replica at a time, and its abort) runs
on both ``ServeFleet`` classes with scripted children; both ``Autoscaler``s
take the same evidence sequences, and both ``judge_canary`` and
``check_fleet`` the same inputs. The port's own checkpoint layouts go through
``discover_steps`` and its remote launch line through ``_remote_argv``.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu.obs import lineage as jax_lineage
from data_diet_distributed_tpu.obs import slo as jax_slo
from data_diet_distributed_tpu.serve import fleet as jax_fleet
from data_diet_distributed_tpu.serve import router as jax_router
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.obs import lineage
from data_diet_distributed_tpu_torch.obs import slo
from data_diet_distributed_tpu_torch.serve import fleet, router

SIDES = {"jax": (jax_router, jax_fleet, jax_slo, jax_load_config),
         "torch": (router, fleet, slo, load_config)}


class _FakeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # noqa: A002
        pass

    def _reply(self, code, payload):
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass   # a hedge closed our socket

    def do_POST(self):   # noqa: N802
        fake = self.server.fake
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(n)
        if self.path == "/v1/refresh":
            with fake.lock:
                fake.refresh_hits.append(time.monotonic())
                code = fake.refresh_codes.pop(0) if fake.refresh_codes else 200
            if code == 200:
                self._reply(200, {"status": "installed", "step": 10, "tenant": "tiny"})
            else:
                self._reply(code, {"status": "rejected", "error": "fake corrupt"})
            return
        with fake.lock:
            fake.dispatches += 1
        if fake.delay_s:
            time.sleep(fake.delay_s)
        self._reply(200, {"scores": [float(fake.index)], "served_by": fake.index})

    do_GET = do_POST   # noqa: N815


class _Fake:
    def __init__(self, index):
        self.index = index
        self.delay_s = 0.0
        self.dispatches = 0
        self.refresh_hits = []
        self.refresh_codes = []
        self.lock = threading.Lock()
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _FakeHandler)
        self.httpd.daemon_threads = True
        self.httpd.fake = self
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()

    def kill(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _Log:
    def __init__(self):
        self.records = []
        self.lock = threading.Lock()

    def log(self, kind, **fields):
        with self.lock:
            self.records.append({"kind": kind, **fields})

    def events(self):
        """The replica_event / model_refresh sequence, port numbers and error
        text (which differ between two runs) left out."""
        return [(r["kind"], r.get("replica"), r.get("event") or r.get("status"))
                for r in self.records if r["kind"] in ("replica_event", "model_refresh")]

    def attempts(self):
        return [(r["status"], r.get("replica"), r.get("retries"), r.get("hedged"),
                 r.get("replay"), [(a["replica"], a["outcome"], a["hedge"])
                                   for a in r.get("attempts") or []])
                for r in self.records if r["kind"] == "serve_trace"]


def _mk_router(mod, fakes, log, **kw):
    reps = [mod.Replica(f.index, "127.0.0.1", f.port,
                        breaker_failures=kw.pop("breaker_failures", 3),
                        breaker_reset_s=kw.pop("breaker_reset_s", 0.3)) for f in fakes]
    r = mod.ServeRouter(reps, timeout_s=kw.pop("timeout_s", 10.0), logger=log,
                        trace_sample_frac=1.0, **kw)
    r.bind()
    return r


HEADERS = ("Idempotency-Key", "X-Served-By", "Retry-After", "X-Idempotent-Replay")


def _req(r, path="/v1/score", method="POST", key=None):
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Idempotency-Key"] = key
    data = json.dumps({"indices": [0]}).encode() if method == "POST" else None
    req = urllib.request.Request(f"http://127.0.0.1:{r.port}{path}", data=data,
                                 headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            code, body, hdrs = resp.status, json.load(resp), resp.headers
    except urllib.error.HTTPError as err:
        code, body, hdrs = err.code, json.load(err), err.headers
    body.pop("detail", None)   # repr of a socket error: names a port
    return code, body, {k: hdrs.get(k) for k in HEADERS if hdrs.get(k) is not None}


def _counters(r, *keys):
    return {k: r.counters[k] for k in keys}


# ----------------------------------------------------------- scenarios
# Each takes (router module, fakes, log) and returns what both packages must
# agree on.

def breaker_lifecycle(mod, fakes, log):
    b = mod.CircuitBreaker(failures=3, reset_s=0.2)
    seq = [b.state, b.allowing(), b.failure(), b.failure(), b.allowing(), b.failure(),
           b.state, b.allowing()]
    time.sleep(0.25)
    seq += [b.allowing(), b.acquire(), b.acquire(), b.success(), b.state]
    for _ in range(3):
        b.failure()
    time.sleep(0.25)
    seq += [b.acquire(), b.failure(), b.state, b.allowing()]
    b2 = mod.CircuitBreaker(failures=3, reset_s=1.0)
    b2.failure(), b2.failure()
    seq += [b2.success(), b2.failure(), b2.failure(), b2.state]
    return {"seq": seq}


def half_open_single_probe(mod, fakes, log):
    b = mod.CircuitBreaker(failures=1, reset_s=0.2)
    b.failure()
    rounds = []
    for _ in range(2):
        time.sleep(0.25)
        wins, barrier = [], threading.Barrier(8)

        def race():
            barrier.wait()
            wins.append(b.acquire())

        threads = [threading.Thread(target=race) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        rounds.append((sum(wins), b.failure(), b.state))
    return {"rounds": rounds}


def keyed_failover(mod, fakes, log):
    fakes[0].kill()
    r = _mk_router(mod, fakes, log, retries=2)
    try:
        out = _req(r, key="k-failover")
        return {"resp": out, "c": _counters(r, "retries", "transport_failures", "proxied"),
                "attempts": log.attempts()}
    finally:
        r.stop()


def keyless_502(mod, fakes, log):
    fakes[0].kill()
    r = _mk_router(mod, fakes, log, retries=2)
    try:
        return {"resp": _req(r), "dispatched": fakes[1].dispatches,
                "attempts": log.attempts()}
    finally:
        r.stop()


def get_failover(mod, fakes, log):
    fakes[0].kill()
    r = _mk_router(mod, fakes, log, retries=2)
    try:
        return {"resp": _req(r, path="/v1/topk?k=3", method="GET"),
                "attempts": log.attempts()}
    finally:
        r.stop()


def breaker_routes_around(mod, fakes, log):
    fakes[0].kill()
    r = _mk_router(mod, fakes, log, retries=2, breaker_failures=2, breaker_reset_s=30.0)
    try:
        codes = [_req(r, key=f"k-{i}")[0] for i in range(4)]
        before = r.counters["transport_failures"]
        codes += [_req(r, key=f"k2-{i}")[0] for i in range(3)]
        return {"codes": codes, "state": r.replicas[0].breaker.state,
                "new_failures": r.counters["transport_failures"] - before,
                "events": log.events()}
    finally:
        r.stop()


def replay_cache(mod, fakes, log):
    r = _mk_router(mod, fakes, log, retries=2)
    try:
        first = _req(r, key="k-replay")
        n1 = fakes[0].dispatches + fakes[1].dispatches
        second = _req(r, key="k-replay")
        n2 = fakes[0].dispatches + fakes[1].dispatches
        _req(r, key="k-fresh")
        n3 = fakes[0].dispatches + fakes[1].dispatches
        return {"first": first, "second": second, "dispatches": (n1, n2, n3),
                "c": _counters(r, "replays", "proxied"), "attempts": log.attempts()}
    finally:
        r.stop()


def hedging(mod, fakes, log):
    fakes[0].delay_s = 3.0
    r = _mk_router(mod, fakes, log, retries=2, hedge_ms=100)
    try:
        t0 = time.monotonic()
        code, body, hdrs = _req(r, key="k-hedge")
        return {"resp": (code, body, hdrs), "fast": time.monotonic() - t0 < 2.5,
                "c": _counters(r, "hedges", "hedge_wins")}
    finally:
        r.stop()


def all_dead_bounded_503(mod, fakes, log):
    for f in fakes:
        f.kill()
    r = _mk_router(mod, fakes, log, retries=1, retry_after_s=1.5, breaker_reset_s=30.0)
    try:
        t0 = time.monotonic()
        resps = [_req(r, key=f"k-part-{i}") for i in range(6)]
        return {"resps": resps, "fast": time.monotonic() - t0 < 20,
                "states": [x.breaker.state for x in r.replicas],
                "available": r.available(), "health": r.health()["status"],
                "c": _counters(r, "no_replica"), "events": log.events()}
    finally:
        r.stop()


def stop_admission(mod, fakes, log):
    r = _mk_router(mod, fakes, log)
    try:
        r.stop_admission()
        return {"resp": _req(r, key="k-drain"), "health": r.health()["status"]}
    finally:
        r.stop()


def no_routable_503(mod, fakes, log):
    r = _mk_router(mod, fakes, log, retry_after_s=2.5)
    try:
        r.set_health(0, False)
        r.set_health(1, False)
        return {"resp": _req(r, key="k-none"), "c": _counters(r, "no_replica"),
                "available": r.available(), "health": r.health()["status"]}
    finally:
        r.stop()


def refresh_roll_and_abort(mod, fakes, log):
    r = _mk_router(mod, fakes, log)
    try:
        ok = _req(r, path="/v1/refresh")
        ordered = fakes[0].refresh_hits[0] <= fakes[1].refresh_hits[0]
        fakes[0].refresh_codes = [409]
        n1 = len(fakes[1].refresh_hits)
        rejected = _req(r, path="/v1/refresh")
        untouched = len(fakes[1].refresh_hits) == n1
        r.set_health(1, False)
        unreachable = _req(r, path="/v1/refresh")
        return {"ok": ok, "ordered": ordered, "rejected": rejected,
                "untouched": untouched, "unreachable": unreachable,
                "events": log.events()}
    finally:
        r.stop()


def canary_rollback(mod, fakes, log):
    """A first roll passes its canary and becomes the prior; a second roll
    whose canary (replica 0) is slow past the floor rolls back to it."""
    r = _mk_router(mod, fakes, log, canary_requests=3, canary_timeout_s=10.0,
                   canary_p95_floor_ms=150.0)
    stop = threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            _req(r, key=f"k-c-{i}")
            i += 1

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        code1, body1 = r.roll_refresh_direct({"step": 10, "dir": "/ck"})
        fakes[0].delay_s = 0.3
        code2, body2 = r.roll_refresh_direct({"step": 999, "dir": "/ck"})
    finally:
        stop.set()
        t.join(timeout=30)
        r.stop()
    return {"first": (code1, body1["status"], body1["canary"]["verdict"]),
            "second": (code2, body2["status"], body2["canary"]["verdict"],
                       body2["prior"], body2["rollback"].get("code")),
            "refreshes": [(e[1], e[2]) for e in log.events() if e[0] == "model_refresh"]}


SCENARIOS = {f.__name__: f for f in (
    breaker_lifecycle, half_open_single_probe, keyed_failover, keyless_502, get_failover,
    breaker_routes_around, replay_cache, hedging, all_dead_bounded_503, stop_admission,
    no_routable_503, refresh_roll_and_abort, canary_rollback)}


@pytest.fixture(scope="module")
def outcomes():
    """Every scenario through both packages' routers, each on fresh fakes;
    the two packages' runs of one scenario side by side (most of a run is
    waiting: breaker resets, a server's shutdown poll)."""
    out, errors = {}, []

    def run(name, side, mod):
        fakes = [_Fake(0), _Fake(1)]
        try:
            out[(name, side)] = SCENARIOS[name](mod, fakes, _Log())
        except BaseException as exc:   # noqa: BLE001 — re-raised below
            errors.append((name, side, exc))
        finally:
            for f in fakes:
                try:
                    f.kill()
                except OSError:
                    pass

    for name in SCENARIOS:
        threads = [threading.Thread(target=run, args=(name, side, mods[0]))
                   for side, mods in SIDES.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    if errors:
        raise errors[0][2]
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_scenario_matches_jax(outcomes, name):
    got, want = outcomes[(name, "torch")], outcomes[(name, "jax")]
    assert got == want, (got, want)
    # What each scenario shows, on the port's side.
    if name == "keyed_failover":
        code, body, hdrs = got["resp"]
        assert code == 200 and body["served_by"] == 1
        assert hdrs == {"Idempotency-Key": "k-failover", "X-Served-By": "1"}
        assert got["attempts"][0][5] == [(0, "transport_error", False), (1, "ok", False)]
    elif name == "keyless_502":
        assert got["resp"][0] == 502 and "not retried" in got["resp"][1]["error"]
        assert got["dispatched"] == 0
    elif name == "get_failover":
        assert got["resp"][0] == 200 and got["resp"][1]["served_by"] == 1
    elif name == "breaker_routes_around":
        assert got["codes"] == [200] * 7 and got["state"] == "open"
        assert got["new_failures"] == 0
        assert ("replica_event", 0, "breaker_open") in got["events"]
    elif name == "replay_cache":
        assert got["second"][2]["X-Idempotent-Replay"] == "1"
        n1, n2, n3 = got["dispatches"]
        assert n1 == n2 == n3 - 1 and got["second"][1] == got["first"][1]
    elif name == "hedging":
        assert got["resp"][1]["served_by"] == 1 and got["fast"]
        assert got["c"] == {"hedges": 1, "hedge_wins": 1}
    elif name == "all_dead_bounded_503":
        assert all(c == 503 and h["Retry-After"] == "1.5" for c, _, h in got["resps"])
        assert got["fast"] and got["states"] == ["open", "open"]
        assert got["available"] == 0 and got["health"] == "critical"
    elif name in ("stop_admission", "no_routable_503"):
        assert got["resp"][0] == 503 and got["health"] == "critical"
    elif name == "refresh_roll_and_abort":
        assert got["ok"][0] == 200 and got["ok"][1]["status"] == "rolled"
        assert got["ordered"] and got["untouched"]
        assert got["rejected"][0] == 409 and got["rejected"][1]["status"] == "roll_aborted"
        assert got["unreachable"][1]["replicas"][-1]["status"] == "unreachable"
    elif name == "canary_rollback":
        assert got["first"] == (200, "rolled", "pass")
        assert got["second"] == (409, "rolled_back", "fail", {"dir": "/ck", "step": 10}, 200)
    elif name == "half_open_single_probe":
        assert got["rounds"] == [(1, True, "open")] * 2


# ------------------------------------------------------ fleet control logic

@pytest.fixture
def restore_lineage():
    """A ``ServeFleet`` installs its lineage in the process: put both back."""
    before = (jax_lineage.current(), lineage.current())
    yield
    for mod, lin in zip((jax_lineage, lineage), before):
        if lin is None:
            mod.uninstall()
        else:
            mod.install(lin)


class _RollProc:
    pid = None

    def __init__(self):
        self.terminated = False

    def poll(self):
        return 0 if self.terminated else None

    @property
    def returncode(self):
        return self.poll()

    def terminate(self):
        self.terminated = True

    def wait(self, timeout=None):   # noqa: ARG002
        return 0

    def kill(self):
        self.terminated = True


def _fleet_cfg(load, tmp, *extra):
    return load(None, ["data.dataset=synthetic", "model.arch=tiny_cnn",
                       f"train.checkpoint_dir={tmp}/ckpt", "serve.replicas=2",
                       "serve.health_poll_s=0.05", *extra])


def _tuning_roll(fleet_mod, load, tmp):
    spawned, log = [], _Log()

    def spawn(index, gen):
        spawned.append((index, gen))
        return _RollProc()

    f = fleet_mod.ServeFleet(_fleet_cfg(load, tmp), logger=log, spawn=spawn)
    originals = [_RollProc() for _ in range(f.n)]
    # The port supervises every replica as a group (of one process here).
    group = getattr(fleet_mod, "ReplicaGroup", None)
    for i, p in enumerate(originals):
        f.procs[i] = p if group is None else group([p], None, None)
    f._poll_health = lambda rep: {"status": "ok"}
    ok = f._tuning_roll("m.json", "d1")
    first = {"ok": ok, "spawned": list(spawned), "terminated": [p.terminated for p in originals],
             "gens": list(f.gens), "events": [e["event"] for e in f.events],
             "replica_events": log.events()}
    spawned.clear()
    f.events.clear()
    f.tuning_roll_wait_s = 0.2
    f._poll_health = lambda rep: None
    ok = f._tuning_roll("m.json", "d2")
    second = {"ok": ok, "spawned": list(spawned), "gens": list(f.gens),
              "events": [e["event"] for e in f.events]}
    return first, second


def test_tuning_roll_one_at_a_time_and_abort_match_jax(tmp_path, restore_lineage):
    port = _tuning_roll(fleet, load_config, tmp_path / "t")
    ref = _tuning_roll(jax_fleet, jax_load_config, tmp_path / "j")
    assert port == ref
    first, second = port
    assert first["ok"] and first["spawned"] == [(0, 1), (1, 1)]
    assert first["terminated"] == [True, True] and first["gens"] == [1, 1]
    assert first["events"] == ["tuning_roll", "tuning_roll_complete"]
    assert [e[2] for e in first["replica_events"]] == ["tuning_respawn"] * 2
    assert second == {"ok": False, "spawned": [(0, 2)], "gens": [2, 1],
                      "events": ["tuning_roll", "tuning_roll_abort"]}


HOT = {"p95_ms": 250.0, "requests": 40, "queue_depth": 0, "reject_frac": 0.0}
IDLE = {"p95_ms": None, "requests": 0, "queue_depth": 0, "reject_frac": 0.0}
STEADY = {"p95_ms": 80.0, "requests": 40, "queue_depth": 0, "reject_frac": 0.0}
QUEUED = {"p95_ms": 300.0, "requests": 10, "queue_depth": 9, "reject_frac": 0.5}

#: (autoscaler settings, [(now, replicas, routable, evidence), ...]).
AUTOSCALE = {
    "sustained_pressure": ({}, [(0, 1, 1, HOT), (1, 1, 1, HOT)]),
    "steady_resets": ({}, [(0, 1, 1, HOT), (1, 1, 1, STEADY), (2, 1, 1, HOT),
                           (3, 2, 2, IDLE), (4, 2, 2, IDLE), (5, 2, 2, STEADY),
                           (6, 2, 2, IDLE), (7, 2, 2, IDLE), (8, 2, 2, IDLE)]),
    "cooldown": ({"cooldown_s": 30.0}, [(0, 1, 1, HOT), (1, 1, 1, HOT), (2, 2, 2, HOT),
                                        (3, 2, 2, HOT), (4, 2, 2, HOT), (40, 2, 2, HOT)]),
    "at_max": ({"max_replicas": 2}, [(0, 2, 2, HOT), (1, 2, 2, HOT)]),
    "floor_and_unroutable": ({"min_replicas": 2}, [(t, 2, 2, IDLE) for t in range(4)]),
    "n_minus_1": ({}, [(t, 2, 1, IDLE) for t in range(4)]
                  + [(4, 2, 2, IDLE), (5, 2, 2, IDLE)]),
    "every_floor_named": ({"queue_floor": 4, "reject_frac_floor": 0.05},
                          [(0, 1, 1, QUEUED), (1, 1, 1, QUEUED)]),
}


@pytest.mark.parametrize("case", list(AUTOSCALE))
def test_autoscaler_decisions_match_jax(case):
    settings, ticks = AUTOSCALE[case]
    kw = {"min_replicas": 1, "max_replicas": 3, "up_after": 2, "down_after": 3,
          "cooldown_s": 10.0, "p95_floor_ms": 100.0, **settings}
    runs = []
    for mod in (fleet, jax_fleet):
        a = mod.Autoscaler(**kw)
        runs.append([a.evaluate(now=float(now), replicas=n, routable=r, ev=ev)
                     for now, n, r, ev in ticks])
    assert runs[0] == runs[1]
    actions = [d and d["action"] for d in runs[0]]
    assert actions[-1] == {"sustained_pressure": "scale_up", "steady_resets": "scale_down",
                           "cooldown": "scale_up", "at_max": "at_max",
                           "floor_and_unroutable": None, "n_minus_1": "scale_down",
                           "every_floor_named": "scale_up"}[case], actions
    if case == "every_floor_named":
        assert len(runs[0][-1]["reasons"]) == 3


CANARY = [dict(served=10, errors=0, p95_ms=80.0, p95_floor_ms=150.0),
          dict(served=10, errors=1, p95_ms=80.0, p95_floor_ms=150.0),
          dict(served=10, errors=1, p95_ms=80.0, p95_floor_ms=150.0, error_frac_floor=0.2),
          dict(served=4, errors=0, p95_ms=620.0, p95_floor_ms=150.0),
          dict(served=4, errors=4, p95_ms=900.0, p95_floor_ms=None),
          dict(served=0, errors=0, p95_ms=None, p95_floor_ms=150.0)]


@pytest.mark.parametrize("inputs", CANARY)
def test_judge_canary_matches_jax(inputs):
    assert slo.judge_canary(**inputs) == jax_slo.judge_canary(**inputs)


def test_check_fleet_matches_jax():
    points = [(1, 50.0, 0.0), (1, 50.0, 0.0), (2, 5.0, 1.0), (3, None, 0.4), (4, 11.0, None)]
    views = []
    for mod in (slo, jax_slo):
        eng = mod.SloEngine(fleet_p95_ms=10.0, fleet_available_frac=0.5)
        for point, p95, frac in points:
            eng.check_fleet(point=point, p95_ms=p95, available_frac=frac)
        views.append((eng.total_violations, eng.violations, eng.objectives()))
    assert views[0] == views[1]
    assert views[0][0] == 4
    assert {v["slo"] for v in views[0][1]} == {"fleet_p95", "fleet_availability"}
    for load in (load_config, jax_load_config):
        for bad in ("obs.slo_fleet_p95_ms=0", "obs.slo_fleet_available_frac=1.5"):
            with pytest.raises(ValueError):
                load(None, [bad])


def test_discover_steps_reads_the_port_layouts(tmp_path):
    d = tmp_path / "ck"
    for name in ("step_3", "step_12", "step_7", "not-a-step", "step_x"):
        (d / name).mkdir(parents=True)
    for name in ("step_3", "step_12", "not-a-step"):
        (d / name / "manifest.json").write_text("{}")   # step_7: a torn save
    tiered = tmp_path / "ck_tiered" / "step_20"
    tiered.mkdir(parents=True)
    (tiered / "promoted.rank0.json").write_text(json.dumps({"world": 2}))
    assert fleet.discover_steps(str(d)) == [3, 12]   # rank 1's marker missing
    (tiered / "promoted.rank1.json").write_text(json.dumps({"world": 2}))
    assert fleet.discover_steps(str(d)) == [3, 12, 20]
    assert fleet.discover_steps(str(tmp_path / "nope")) == []


def test_child_and_remote_argv_carry_device_and_never_rearm(tmp_path, monkeypatch,
                                                            restore_lineage):
    monkeypatch.setenv("DDT_FAULT_PLAN", '{"rank": 0}')
    cfg = _fleet_cfg(load_config, tmp_path, "serve.hosts=[hostA,hostB]",
                     "serve.remote_launch='ssh -T {host}'")
    f = fleet.ServeFleet(cfg, logger=None, device="cuda")
    argv = f._remote_argv(1, 0, "hostB")
    assert argv[:3] == ["ssh", "-T", "hostB"]
    py = argv.index(sys.executable)
    carried = argv[argv.index("env") + 1:py]
    assert "DDT_SERVE_REPLICA=1" in carried
    assert any(t.startswith("DDT_FAULT_PLAN=") for t in carried)
    tail = argv[py:]
    assert tail[1:5] == ["-m", "data_diet_distributed_tpu_torch.cli", "serve", "--device"]
    assert tail[5] == "cuda"
    for tok in (f"serve.port={f.ports[1]}", "serve.host=hostB", "serve.replicas=1",
                "serve.min_replicas=null", "serve.max_replicas=null",
                "serve.refresh_poll_s=null", "elastic.enabled=false"):
        assert tok in tail, tok
    argv1 = f._remote_argv(1, 1, "hostB")
    assert argv1[argv1.index("env"):][:3] == ["env", "-u", "DDT_FAULT_PLAN"]
    assert not any(t.startswith("DDT_FAULT_PLAN=") for t in argv1)
    # The child's overrides pass the port's validation as a replica's.
    child = load_config(None, [t for t in tail[6:] if "=" in t])
    assert child.serve.replicas == 1 and child.serve.max_replicas is None


def test_dead_supervisor_thread_flips_healthz_critical(tmp_path, restore_lineage):
    log = _Log()
    f = fleet.ServeFleet(_fleet_cfg(load_config, tmp_path), logger=log)
    t = threading.Thread(target=lambda: None, name="fleet-health")
    t.start()
    t.join()
    f._threads.append(t)
    f._check_threads()
    f._check_threads()   # first sighting only
    health = f.router.health()
    assert health["status"] == "critical" and len(f.router.supervisor_faults) == 1
    assert log.events() == [("replica_event", None, "supervisor_thread_dead")]
