"""PyTorch port: the card host's tools (``data_diet_distributed_tpu_torch.tools``)
and ``utils/trees.py``, each held against the JAX package's counterpart on the
same inputs.

* ``make_shards`` and ``npz_to_npy``: the files they write are bitwise the JAX
  tools' (arrays, labels, stats, manifests with their digests) and their
  stdout is the same but for the output directory's name;
* ``score_report``, ``trace_report``, ``request_report`` and ``run_monitor
  --once``: the same report, text and JSON, on one tiny ``cli run --device
  cpu`` of the port (metrics stream, trace, heartbeats, scores npz) and on a
  stream of ``serve_trace`` records, with the clock held still;
* ``param_count`` and ``tree_bytes`` on weights carried by
  ``weights.params_from_flax`` equal JAX's on the Flax variables.
"""

import contextlib
import importlib.util
import io
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from data_diet_distributed_tpu.utils import trees as jax_trees
from data_diet_distributed_tpu_torch import cli
from data_diet_distributed_tpu_torch.tools import (make_shards, npz_to_npy, request_report,
                                                   run_monitor, score_report, trace_report)
from data_diet_distributed_tpu_torch.utils import trees
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_models import flax_and_torch, randomize_bn
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PORT_TOOLS = {"make_shards": make_shards, "npz_to_npy": npz_to_npy,
              "score_report": score_report, "trace_report": trace_report,
              "request_report": request_report, "run_monitor": run_monitor}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv) -> tuple[object, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(name, argv):
    """(rc, stdout, stderr) of the JAX tool and of the port's on ``argv``."""
    return _run(_jax_tool(name).main, argv), _run(PORT_TOOLS[name].main, argv)


def _tree_files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _npz_dir(d: Path, dtype, stats: bool = False) -> Path:
    rng = np.random.default_rng(0)
    d.mkdir(parents=True)
    for split, n in (("train", 40), ("test", 12)):
        x = (rng.integers(0, 256, (n, 8, 8, 3)).astype(np.uint8) if dtype == np.uint8
             else rng.normal(size=(n, 8, 8, 3)).astype(np.float32))
        extra = ({"mean": np.asarray([0.4, 0.5, 0.6], np.float32),
                  "std": np.asarray([0.2, 0.25, 0.3], np.float32)}
                 if stats and split == "train" else {})
        np.savez(d / f"{split}.npz", images=x, labels=rng.integers(0, 5, n), **extra)
    return d


@pytest.mark.parametrize("dtype,stats", [(np.uint8, False), (np.uint8, True),
                                         (np.float32, False)],
                         ids=["uint8", "uint8-explicit-stats", "float32"])
def test_npz_to_npy_writes_the_jax_tools_bytes(tmp_path, monkeypatch, dtype, stats):
    src = _npz_dir(tmp_path / "src", dtype, stats)
    outs = {side: tmp_path / side for side in ("jax", "torch")}
    (jrc, jout, _), (prc, pout, _) = (
        _run(lambda a: _jax_main_npz(a, monkeypatch), ["--data-dir", str(src), "--out",
                                                       str(outs["jax"])]),
        _run(npz_to_npy.main, ["--data-dir", str(src), "--out", str(outs["torch"])]))
    assert jrc is None and prc is None
    assert pout.replace(str(outs["torch"]), "OUT") == jout.replace(str(outs["jax"]), "OUT")
    files = {side: _tree_files(d) for side, d in outs.items()}
    assert files["torch"] == files["jax"]
    assert ("stats.npz" in files["torch"]) == (dtype == np.uint8)


def _jax_main_npz(argv, monkeypatch):
    """The JAX tool reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", ["npz_to_npy.py", *argv])
    return _jax_tool("npz_to_npy").main()


@pytest.mark.parametrize("source", ["npz-uint8", "npz-float32", "npy", "synthetic",
                                    "synthetic_imagenet"])
def test_make_shards_writes_the_jax_tools_shards_and_manifest(tmp_path, source):
    """Shards, labels and manifest (digests, norm, the conversion block) are
    bitwise the JAX tool's; so is ``--verify``'s report, and a second
    conversion into the same directory reuses every shard in both."""
    if source.startswith("npz"):
        src = _npz_dir(tmp_path / "src", np.uint8 if source == "npz-uint8" else np.float32)
        args = [str(src)]
    elif source == "npy":
        src = _npz_dir(tmp_path / "npz", np.uint8)
        npz_to_npy.main(["--data-dir", str(src), "--out", str(tmp_path / "npy")])
        args = [str(tmp_path / "npy")]
    else:
        args = [str(tmp_path), "--dataset", source, "--size", "24", "--seed", "3"]
    outs = {side: tmp_path / f"shards_{side}" for side in ("jax", "torch")}
    for _ in range(2):   # the second conversion resumes over the first
        (jrc, jout, _), (prc, pout, _) = (
            _run(_jax_tool("make_shards").main, [*args, "--out", str(outs["jax"]),
                                                 "--shard-size", "16"]),
            _run(make_shards.main, [*args, "--out", str(outs["torch"]),
                                    "--shard-size", "16"]))
        assert jrc == prc == 0
        assert (pout.replace(str(outs["torch"]), "OUT")
                == jout.replace(str(outs["jax"]), "OUT"))
    files = {side: _tree_files(d) for side, d in outs.items()}
    assert files["torch"] == files["jax"] and "manifest.json" in files["torch"]
    manifest = json.loads(files["torch"]["manifest.json"])
    assert manifest["conversion"]["resumed"] is True
    (jrc, jout, jerr), (prc, pout, perr) = (
        _run(_jax_tool("make_shards").main, ["--verify", str(outs["jax"])]),
        _run(make_shards.main, ["--verify", str(outs["torch"])]))
    assert jrc == prc == 0
    assert pout.replace(str(outs["torch"]), "OUT") == jout.replace(str(outs["jax"]), "OUT")


def test_make_shards_verify_fails_on_a_torn_shard_as_jax_does(tmp_path):
    src = _npz_dir(tmp_path / "src", np.uint8)
    reports = {}
    for side, main in (("jax", _jax_tool("make_shards").main), ("torch", make_shards.main)):
        out = tmp_path / side
        assert _run(main, [str(src), "--out", str(out), "--shard-size", "16"])[0] == 0
        shard = sorted(out.rglob("*.npy"))[0]
        shard.write_bytes(shard.read_bytes()[:-7])
        rc, stdout, stderr = _run(main, ["--verify", str(out)])
        reports[side] = (rc, stderr.replace(str(out), "OUT"))
    assert reports["torch"] == reports["jax"] and reports["torch"][0] == 1


# ------------------------------------------------------------------- reports


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny port ``cli run --device cpu`` with the trace, heartbeats and
    score telemetry on, and a stream of ``serve_trace`` records."""
    d = tmp_path_factory.mktemp("tools_run")
    argv = ["run", "--device", "cpu", "data.dataset=synthetic", "data.synthetic_size=64",
            "data.batch_size=32", "score.batch_size=32", "score.grand_chunk=8",
            "model.arch=tiny_cnn", "score.pretrain_epochs=1", "score.seeds=[0,1]",
            "train.num_epochs=1", "train.half_precision=false",
            f"train.checkpoint_dir={d}/ckpt", f"obs.metrics_path={d}/metrics.jsonl",
            f"obs.heartbeat_dir={d}/hb", "obs.heartbeat_interval_s=0"]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(argv) == 0
    rng = np.random.default_rng(5)
    with open(d / "serve.jsonl", "w") as fh:
        for i in range(40):
            where = ("router", "replica")[i % 2]
            phases = ({"admission": rng.uniform(0.1, 1), "proxy": rng.uniform(2, 9)}
                      if where == "router" else
                      {"queue_wait": rng.uniform(0.5, 4),
                       "dispatch": rng.uniform(1, 5) + (300 if i in (7, 21) else 0)})
            fh.write(json.dumps({"kind": "serve_trace", "ts": 100.0 + i,
                                 "trace_id": f"{i:032x}", "where": where, "status": 200,
                                 "wall_ms": float(sum(phases.values())),
                                 "phases": phases, "sampled": True}) + "\n")
    return d


@pytest.fixture
def still_clock(monkeypatch):
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)


@pytest.mark.parametrize("args", [[], ["--json"], ["--b", "{d}"], ["--keep-fraction", "0.3"],
                                  ["{d}/metrics.jsonl"]])
def test_score_report_same_report(run_dir, args):
    args = [a.format(d=run_dir) for a in args]
    argv = args if args[:1] == [f"{run_dir}/metrics.jsonl"] else [str(run_dir), *args]
    (jrc, jout, _), (prc, pout, _) = _both("score_report", argv)
    assert jrc == prc == 0 and pout == jout and "seed" in pout


@pytest.mark.parametrize("args", [["{d}/trace.json"], ["{d}"], ["{d}/trace.json", "--json"],
                                  ["{d}/trace.json", "--heartbeats", "{d}/hb"],
                                  ["{d}/trace.json", "--metrics", "{d}/metrics.jsonl"]])
def test_trace_report_same_report(run_dir, still_clock, args):
    (jrc, jout, _), (prc, pout, _) = _both("trace_report",
                                           [a.format(d=run_dir) for a in args])
    assert jrc == prc == 0 and pout == jout and pout.strip()


@pytest.mark.parametrize("args", [[], ["--json"], ["--where", "replica"],
                                  ["--tail-q", "0.99", "--exemplars", "1"]])
def test_request_report_same_report(run_dir, args):
    (jrc, jout, _), (prc, pout, _) = _both("request_report",
                                           [str(run_dir / "serve.jsonl"), *args])
    assert jrc == prc == 0 and pout == jout and "dispatch" in pout


def test_request_report_exit_2_without_traces(run_dir):
    (jrc, jout, jerr), (prc, pout, perr) = _both("request_report",
                                                 [str(run_dir / "metrics.jsonl")])
    assert jrc == prc == 2 and (pout, perr) == (jout, jerr)


@pytest.mark.parametrize("args", [["--metrics", "{d}/metrics.jsonl"],
                                  ["--metrics", "{d}/metrics.jsonl", "--json"],
                                  ["--heartbeat-dir", "{d}/hb", "--json"],
                                  ["--metrics", "{d}/serve.jsonl", "--json"],
                                  ["--port", "1", "--timeout", "0.2", "--json"]])
def test_run_monitor_once_same_view(run_dir, still_clock, args):
    argv = [a.format(d=run_dir) for a in args] + ["--once"]
    (jrc, jout, _), (prc, pout, _) = _both("run_monitor", argv)
    assert jrc == prc and pout == jout and pout.strip()


# --------------------------------------------------------------------- trees


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_param_count_and_tree_bytes_equal_jax_on_converted_weights(name):
    fm, tm = flax_and_torch(name)
    init = jax.jit(fm.init, static_argnames=("train",))
    tree = randomize_bn(init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False),
                        np.random.default_rng(0))
    variables = params_from_flax(tree, tm)
    assert trees.param_count(variables) == jax_trees.param_count(tree) > 0
    assert trees.tree_bytes(variables) == jax_trees.tree_bytes(tree)
    # Nested containers and numpy leaves count the same.
    nested = {"a": [np.zeros((2, 3), np.float32), None], "b": (np.zeros(4, np.int8),)}
    assert (trees.param_count(nested), trees.tree_bytes(nested)) == (10, 28)
