"""PyTorch port: the perf sentry (``data_diet_distributed_tpu_torch.tools.perf_sentry``)
held against ``tools/perf_sentry.py`` on the same ledgers.

On the cases of ``tests/test_perf_sentry.py`` (wedge shapes, improvement,
regression, threshold, window, poisoned baselines, stale blind groups,
seconds, geometry groups, comm and serve-phase sub-metrics) the port's
``classify_record``, ``group_key``, ``check_ledger``, rendered report, JSON
report and exit code equal the JAX tool's. A ``cuda`` record never shares a
group with a ``tpu`` record of the same metric and geometry, nor with another
kind of card, and ``--import-bench`` (the TPU rounds' backfill) refuses.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest

from data_diet_distributed_tpu_torch.tools import perf_sentry as ps

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_ps():
    spec = importlib.util.spec_from_file_location("jax_tool_perf_sentry",
                                                  REPO / "tools" / "perf_sentry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(value, *, metric="m", unit="examples/sec/chip", **extra):
    return {"kind": "perf_history", "ts": 0.0, "source": "test",
            "metric": metric, "value": value, "unit": unit, **extra}


def _comm(v, bytes_per_step):
    return _rec(v, comm={"bytes_per_step": bytes_per_step, "overlap_ratio": 0.9})


def _phases(v, queue_ms):
    return _rec(v, unit="ms", phases={"queue_wait": {"p95_ms": queue_ms},
                                      "dispatch": {"p95_ms": 20.0}})


# name -> (records, extra argv); the cases of tests/test_perf_sentry.py.
CASES = {
    "wedge_shapes": ([_rec(100.0), _rec(0.0), _rec(-5.0), _rec(None),
                      _rec(100.0, error="probe hung"), _rec(100.0, exit_class="retriable"),
                      _rec(100.0, exit_class="ok"), _rec(True)], []),
    "improvement": ([_rec(100.0), _rec(102.0), _rec(150.0)], []),
    "regression": ([_rec(100.0), _rec(101.0), _rec(99.0), _rec(80.0)], []),
    "threshold_default": ([_rec(100.0), _rec(100.0), _rec(85.0)], []),
    "threshold_0.2": ([_rec(100.0), _rec(100.0), _rec(85.0)], ["--threshold", "0.2"]),
    "wedge_never_poisons": ([_rec(100.0), _rec(0.0, error="probe hung"),
                             _rec(0.0, error="probe hung"), _rec(101.0), _rec(95.0)], []),
    "newest_wedge": ([_rec(100.0), _rec(0.0, error="wedge")], []),
    "stale_blind_group": ([_rec(0.0, metric="old_metric", error="wedge"),
                           _rec(100.0, metric="new_metric"),
                           _rec(101.0, metric="new_metric")], []),
    "seconds_regression": ([_rec(60.0, unit="seconds"), _rec(61.0, unit="seconds"),
                            _rec(80.0, unit="seconds")], []),
    "seconds_improvement": ([_rec(60.0, unit="seconds"), _rec(40.0, unit="seconds")], []),
    "geometry_groups": ([_rec(1000.0, geometry={"size": 50000}, backend="tpu"),
                         _rec(100.0, geometry={"size": 256}, backend="cpu")], []),
    "window_3": ([_rec(v) for v in (50.0, 52.0, 100.0, 101.0, 102.0, 90.0)],
                 ["--window", "3"]),
    "metric_filter": ([_rec(100.0, metric="a"), _rec(50.0, metric="b"),
                       _rec(70.0, metric="a")], ["--metric", "a"]),
    "comm_regression": ([_comm(100.0 + i, 1_000_000) for i in range(4)]
                        + [_comm(104.0, 1_250_000)], []),
    "comm_within": ([_comm(100.0 + i, 1_000_000) for i in range(4)]
                    + [_comm(104.0, 1_050_000)], []),
    "comm_absent": ([_rec(100.0), _rec(101.0), _rec(102.0, comm={"bytes_per_step": 0}),
                     _rec(103.0, comm={"bytes_per_step": 500_000})], []),
    "phase_regression": ([_phases(50.0, 10.0), _phases(50.0, 11.0), _phases(50.0, 10.5),
                          _phases(51.0, 40.0)], []),
    "autotune_combos": ([_rec(100.0, metric="autotune.baseline.x", autotune={"combo":
                                                                               "baseline"}),
                         _rec(90.0, metric="autotune.stem_xla.x")], []),
}


def _ledger(tmp_path, records, name="ledger.jsonl") -> str:
    path = tmp_path / name
    with open(path, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return str(path)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sentry_matches_jax(jax_ps, tmp_path, case):
    records, argv = CASES[case]
    path = _ledger(tmp_path, records)
    for r in records:
        assert ps.classify_record(r) == jax_ps.classify_record(r)
        assert ps.group_key(r) == jax_ps.group_key(r)
        assert ps.autotune_combo(r) == jax_ps.autotune_combo(r)
    kw = {"threshold": float(argv[1])} if argv[:1] == ["--threshold"] else {}
    kw.update({"window": int(argv[1])} if argv[:1] == ["--window"] else {})
    kw.update({"metric": argv[1]} if argv[:1] == ["--metric"] else {})
    loaded = ps.load_ledger(path)
    assert loaded == jax_ps.load_ledger(path)
    assert ps.check_ledger(loaded, **kw) == jax_ps.check_ledger(loaded, **kw)
    for extra in ([], ["--json"]):
        assert _run(ps.main, [path, *argv, *extra]) == _run(jax_ps.main,
                                                            [path, *argv, *extra])


@pytest.mark.parametrize("case,status,code", [
    ("improvement", ps.IMPROVEMENT, ps.EXIT_OK),
    ("regression", ps.REGRESSION, ps.EXIT_REGRESSION),
    ("threshold_0.2", ps.OK, ps.EXIT_OK),
    ("newest_wedge", ps.NEWEST_CAPTURE_ERROR, ps.EXIT_CAPTURE_ERROR),
    ("seconds_regression", ps.REGRESSION, ps.EXIT_REGRESSION),
    ("comm_regression", ps.REGRESSION, ps.EXIT_REGRESSION),
    ("phase_regression", ps.REGRESSION, ps.EXIT_REGRESSION),
])
def test_exit_code_contract(tmp_path, case, status, code):
    """The exit codes the contract names (0 ok, 1 regression, 2 the newest
    record blind), read from the port alone."""
    records, argv = CASES[case]
    rc, out = _run(ps.main, [_ledger(tmp_path, records), *argv, "--json"])
    report = json.loads(out)
    assert rc == code == report["exit_code"]
    assert report["groups"][-1]["status"] == status


def test_cuda_record_never_meets_a_tpu_record(jax_ps, tmp_path):
    """The same metric and geometry measured on a TPU, on the H100 and on
    another card: three groups, each without a baseline, so a card's number is
    never judged against another device's; the JAX tool already splits the
    backends, the port also the kinds of card."""
    geom = {"task": "score", "arch": "resnet18", "size": 8192, "batch": 512}
    tpu = _rec(9000.0, geometry=geom, backend="tpu", device_kind="TPU v5 lite")
    h100 = _rec(25000.0, geometry=geom, backend="cuda", device_kind="NVIDIA H100 80GB HBM3")
    a100 = _rec(12000.0, geometry=geom, backend="cuda", device_kind="NVIDIA A100-SXM4-80GB")
    rep = ps.check_ledger([tpu, h100, a100])
    assert len({ps.group_key(r) for r in (tpu, h100, a100)}) == 3
    assert [g["status"] for g in rep["groups"]] == [ps.NO_BASELINE] * 3
    assert rep["exit_code"] == ps.EXIT_OK
    assert ps.group_key(tpu) != ps.group_key(h100)
    assert jax_ps.group_key(tpu) != jax_ps.group_key(h100)
    # A slower H100 record after two clean ones is judged on the H100 trail only.
    rep = ps.check_ledger([h100, tpu, dict(h100), {**h100, "value": 20000.0}])
    [g_cuda] = [g for g in rep["groups"] if g["n_records"] == 3]
    assert g_cuda["baseline_median"] == 25000.0 and g_cuda["status"] == ps.REGRESSION


def test_tpu_backfill_refused(tmp_path, capsys):
    """``--import-bench`` would carry TPU rounds into the port's trail: it
    refuses, names why, and writes nothing."""
    out = tmp_path / "ledger.jsonl"
    with pytest.raises(SystemExit) as exc:
        ps.main(["--import-bench", str(REPO / "BENCH_r01.json"), "--ledger", str(out)])
    assert exc.value.code == 2
    assert "measured on a TPU" in capsys.readouterr().err
    assert not out.exists()


def test_missing_ledger_is_ok(tmp_path):
    assert ps.main([str(tmp_path / "none.jsonl")]) == ps.EXIT_OK
