"""PyTorch port: the two standard-library validators
(``data_diet_distributed_tpu_torch.tools.validate_metrics`` and
``.serve_client``) held against the JAX side's ``tools/validate_metrics.py``
and ``tools/serve_client.py``, loaded by path.

* the known kinds, required fields and stage statuses are the JAX tool's;
* on one valid stream, holding a record of every kind, and on streams broken
  in each way the JAX validator catches, both return the same error lists
  (``validate_lines``, ``validate_file``) and ``main`` the same exit and
  output;
* ``percentile`` and the client's retry backoff equal the JAX tool's, and on
  one fake service that sheds load (429 with Retry-After, 503, a dead
  endpoint) both clients retry, rotate and sleep alike;
* both modules import with JAX and the JAX package unimportable.
"""

from __future__ import annotations

import contextlib
import http.server
import importlib.util
import io
import json
import os
import random
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from data_diet_distributed_tpu_torch.tools import serve_client, validate_metrics

REPO = Path(__file__).resolve().parent.parent


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_VM = _load("validate_metrics")
JAX_SC = _load("serve_client")


def test_schema_tables_match():
    assert validate_metrics.KNOWN_KINDS == JAX_VM.KNOWN_KINDS
    assert validate_metrics.REQUIRED_FIELDS == JAX_VM.REQUIRED_FIELDS
    assert validate_metrics.STAGE_STATUSES == JAX_VM.STAGE_STATUSES


def _record(kind: str, i: int) -> dict:
    rec = {"ts": 1000.0 + i, "kind": kind, "run_id": "r", "attempt": 0}
    rec.update({f: 0 for f in JAX_VM.REQUIRED_FIELDS.get(kind, ())})
    if kind == "stage":
        rec["status"] = "done"
    if kind == "serve_trace":
        rec["phases"] = {"dispatch": 1.0}
    return rec


def _valid_lines() -> list[str]:
    """One record of every known kind, ending in ``run_summary``."""
    kinds = sorted(JAX_VM.KNOWN_KINDS - {"run_summary"}) + ["run_summary"]
    return [json.dumps(_record(k, i)) for i, k in enumerate(kinds)]


def _broken(lines: list[str], i: int, rec=None, raw: str | None = None) -> list[str]:
    out = list(lines)
    out[i] = raw if raw is not None else json.dumps(rec)
    return out


def _streams() -> dict[str, tuple[list[str], bool]]:
    """name -> (lines, expect_terminal): the valid stream, then each break."""
    ok = _valid_lines()
    first = json.loads(ok[0])
    streams = {
        "valid": (ok, False),
        "valid_terminal": (ok, True),
        "partial_trailing_line": (ok + ['{"ts": 1, "kind'], True),
        "not_json": (_broken(ok, 2, raw="{not json"), False),
        "not_an_object": (_broken(ok, 2, raw="[1, 2]"), False),
        "no_ts": (_broken(ok, 0, {k: v for k, v in first.items() if k != "ts"}), False),
        "string_ts": (_broken(ok, 0, {**first, "ts": "now"}), False),
        "no_kind": (_broken(ok, 0, {k: v for k, v in first.items() if k != "kind"}), False),
        "unknown_kind": (_broken(ok, 0, {**first, "kind": "tarin_step"}), False),
        "run_id_not_string": (_broken(ok, 0, {**first, "run_id": 7}), False),
        "attempt_negative": (_broken(ok, 0, {**first, "attempt": -1}), False),
        "attempt_bool": (_broken(ok, 0, {**first, "attempt": True}), False),
        "stage_status": ([json.dumps({**_record("stage", 0), "status": "half"})], False),
        "serve_trace_phases": ([json.dumps({**_record("serve_trace", 0), "phases": []})],
                               False),
        "no_terminal": (ok[:-1], True),
        "empty": ([], False),
        "blank_lines": (["", "   "], False),
    }
    for kind, fields in sorted(JAX_VM.REQUIRED_FIELDS.items()):
        rec = _record(kind, 0)
        streams[f"{kind}_missing_{fields[-1]}"] = (
            [json.dumps({k: v for k, v in rec.items() if k != fields[-1]})], False)
    return streams


STREAMS = _streams()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_validate_lines_matches_jax(name):
    lines, terminal = STREAMS[name]
    got = validate_metrics.validate_lines(lines, where="s", expect_terminal=terminal)
    want = JAX_VM.validate_lines(lines, where="s", expect_terminal=terminal)
    assert got == want
    assert (got == []) == name.startswith(("valid", "partial"))


@pytest.mark.parametrize("name", ["valid", "no_terminal", "unknown_kind", "not_json"])
def test_validate_file_and_main_match_jax(tmp_path, capsys, name):
    lines, terminal = STREAMS[name]
    path = tmp_path / "m.jsonl"
    path.write_text("\n".join(lines) + "\n")
    assert validate_metrics.validate_file(str(path), expect_terminal=terminal) \
        == JAX_VM.validate_file(str(path), expect_terminal=terminal)
    argv = [str(path)] + (["--expect-terminal"] if terminal else [])
    rc = validate_metrics.main(argv)
    port_out = capsys.readouterr()
    assert rc == JAX_VM.main(argv)
    assert port_out == capsys.readouterr()


def test_percentile_matches_jax():
    rng = random.Random(0)
    assert serve_client.percentile([], 0.5) is JAX_SC.percentile([], 0.5) is None
    for n in (1, 2, 3, 7, 20, 101):
        values = [rng.uniform(0, 100) for _ in range(n)]
        for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert serve_client.percentile(values, q) == JAX_SC.percentile(values, q)


@pytest.mark.parametrize("backoff_s", [0.01, 0.25, 1.0])
def test_backoff_matches_jax(backoff_s):
    port = serve_client.ServeClient("http://127.0.0.1:1", backoff_s=backoff_s)
    jax = JAX_SC.ServeClient("http://127.0.0.1:1", backoff_s=backoff_s)
    for attempt in range(1, 12):
        assert port._backoff(attempt) == jax._backoff(attempt)


class _Shedding(http.server.BaseHTTPRequestHandler):
    """A service that answers each POST of a key with 429 (Retry-After), then
    503, then 200 echoing the key; GETs answer 200."""

    seen: dict = {}

    def log_message(self, *args):
        pass

    def _reply(self, code: int, body: dict, headers=()) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._reply(200, {"ok": True})

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        key = self.headers["Idempotency-Key"]
        n = self.seen[key] = self.seen.get(key, 0) + 1
        if n == 1:
            self._reply(429, {"error": "busy"}, [("Retry-After", "0.01")])
        elif n == 2:
            self._reply(503, {"error": "draining"})
        else:
            self._reply(200, {"scores": [0.5], "key": key})


@pytest.fixture(scope="module")
def shedding():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Shedding)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def _drive(module, url: str, monkeypatch) -> dict:
    sleeps: list[float] = []
    monkeypatch.setattr(module.time, "sleep", sleeps.append)
    dead = "http://127.0.0.1:9"   # nothing listens on the discard port
    client = module.ServeClient([dead, url], retries=3, backoff_s=0.05)
    out = client.score(indices=[1], method="el2n")
    with pytest.raises(module.ServeError) as exc:
        module.ServeClient(dead, retries=2, backoff_s=0.05).score(indices=[1])
    return {"reply": {k: v for k, v in out.items() if k != "key"},
            "retries": client.retry_count, "failovers": client.failovers,
            "base": client.base, "sleeps": sleeps, "dead_status": exc.value.status,
            "health": client.healthz()}


def test_client_retries_match_jax(shedding, monkeypatch):
    port = _drive(serve_client, shedding, monkeypatch)
    jax = _drive(JAX_SC, shedding, monkeypatch)
    assert port == jax
    assert port["retries"] == 2 and port["dead_status"] == 0
    assert port["sleeps"] == [0.01, 0.1, 0.05, 0.1]


@pytest.mark.parametrize("name", ["validate_metrics", "serve_client"])
def test_help_without_jax(tmp_path, name):
    code = ("import runpy, sys\n"
            "for m in ('jax', 'data_diet_distributed_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['{name}', '--help']\n"
            f"runpy.run_module('data_diet_distributed_tpu_torch.tools.{name}', "
            "run_name='__main__')\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage:" in proc.stdout


def test_main_on_a_stream_from_the_command_line(tmp_path):
    """``python -m`` of the port's validator on a broken stream: exit 1, each
    problem on stderr, as the JAX tool prints them."""
    path = tmp_path / "m.jsonl"
    path.write_text("\n".join(STREAMS["unknown_kind"][0]) + "\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    runs = [subprocess.run(argv + [str(path)], env=env, capture_output=True, text=True,
                           timeout=60)
            for argv in ([sys.executable, "-m",
                          "data_diet_distributed_tpu_torch.tools.validate_metrics"],
                         [sys.executable, str(REPO / "tools" / "validate_metrics.py")])]
    assert [r.returncode for r in runs] == [1, 1]
    assert runs[0].stderr == runs[1].stderr and "unknown kind" in runs[0].stderr
    with contextlib.redirect_stderr(io.StringIO()):
        assert validate_metrics.main([str(path)]) == 1


def test_chip_smoke_loads_the_port_copies():
    """``chip_smoke.py`` takes both validators from the port and joins no path
    under the repo's ``tools/``."""
    src = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r'join\(\s*REPO\s*,\s*"tools"', src)
    assert "from data_diet_distributed_tpu_torch.tools import validate_metrics" in src
    assert "from data_diet_distributed_tpu_torch.tools import serve_client" in src
