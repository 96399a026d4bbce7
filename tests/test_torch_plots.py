"""PyTorch port: the post-run plots (``obs/plots.py``) and ``obs.plots_dir``,
held against the JAX package's module and CLI.

* ``score_hist_series`` and the PNG names ``plot_metrics``, ``plot_score_stats``,
  ``plot_scores`` and ``plot_utilization`` write equal the JAX module's on the
  same stream, npz and monitor log; without matplotlib both write nothing;
* ``cli run --device cpu obs.plots_dir=...`` writes the files, and prints the
  ``[plots] wrote`` lines, that the JAX ``cli run`` writes and prints for the
  same tiny config (tiny_cnn, 64 synthetic examples, ``obs.monitor`` on) but
  the duty chart, whose samples the port's monitor takes only on a card; and
  ``cli sweep`` one score histogram per level;
* a rendering failure prints ``[plots] rendering failed: ...`` and the command
  still exits 0.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from data_diet_distributed_tpu import cli as jax_cli
from data_diet_distributed_tpu.obs import plots as jax_plots
# The JAX CLI imports its training loop at first dispatch; importing it here
# keeps that once-per-process cost out of the fixture's runs.
from data_diet_distributed_tpu.train import loop as _jax_loop  # noqa: F401
from data_diet_distributed_tpu_torch import cli, obs
from data_diet_distributed_tpu_torch.obs import plots
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = ["data.dataset=synthetic", "data.synthetic_size=64", "data.batch_size=32",
        "data.eval_batch_size=64", "score.batch_size=32", "score.grand_chunk=8",
        "model.arch=tiny_cnn", "score.method=grand", "score.pretrain_epochs=1",
        "score.seeds=[0,1]", "train.num_epochs=2", "train.half_precision=false",
        "train.chunk_steps=1", "obs.heartbeat_interval_s=0"]
COMMANDS = {"run": ["run", "obs.monitor=true"],
            "sweep": ["sweep", "prune.sweep=[0.3,0.5]", "train.num_epochs=1"]}


def _cli_run(main, command: str, d: Path, device: list[str]) -> tuple[int, list[str]]:
    d.mkdir(parents=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main([*COMMANDS[command], *device, *TINY, f"train.checkpoint_dir={d}/ckpt",
                   f"obs.metrics_path={d}/m.jsonl", f"obs.monitor_path={d}/util.jsonl",
                   f"obs.plots_dir={d}/plots"])
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plots_cli")
    runs = {(side, "run"): _cli_run(main, "run", tmp / side / "run", device)
            for side, main, device in (("jax", jax_cli.main, []),
                                       ("torch", cli.main, ["--device", "cpu"]))}
    runs[("torch", "sweep")] = _cli_run(cli.main, "sweep", tmp / "torch" / "sweep",
                                        ["--device", "cpu"])
    return runs


def _names(paths) -> list[str]:
    return sorted(Path(p).name for p in paths)


def _written(lines: list[str]) -> list[str]:
    """The names the ``[plots]`` lines announce, checked against the files."""
    plot_lines = [x for x in lines if x.startswith("[plots]")]
    assert plot_lines and all(x.startswith("[plots] wrote ") for x in plot_lines), lines
    paths = [x[len("[plots] wrote "):] for x in plot_lines]
    assert sorted(p.name for p in Path(paths[0]).parent.iterdir()) == _names(paths)
    return _names(paths)


def test_cli_run_writes_what_the_jax_cli_writes(cli_runs):
    assert cli_runs[("jax", "run")][0] == cli_runs[("torch", "run")][0] == 0
    written = {side: _written(cli_runs[(side, "run")][1]) for side in ("jax", "torch")}
    # The one difference is the monitor's, not the plots': on the CPU the JAX
    # monitor's duty probe times its CPU backend, the port's monitor reports
    # no duty without a card (obs/monitor.py), so no duty chart is drawn.
    assert written["torch"] == [n for n in written["jax"] if n != "device_duty_cycle.png"]
    # chip_smoke.py's obs phase expects these on the card, beside the card's
    # duty and memory charts.
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert written["torch"] == sorted(smoke.OBS_PLOTS_CPU)
    # The port prints them after its summary line, as JAX after its own.
    lines = cli_runs[("torch", "run")][1]
    assert max(i for i, x in enumerate(lines) if x.startswith("{")) \
        < min(i for i, x in enumerate(lines) if x.startswith("[plots]"))


def test_cli_sweep_writes_one_histogram_per_level(cli_runs):
    rc, lines = cli_runs[("torch", "sweep")]
    assert rc == 0
    assert {"score_distribution_s0p3.png", "score_distribution_s0p5.png",
            "accuracy_vs_sparsity.png"} <= set(_written(lines))


def _stream(tmp_path: Path) -> Path:
    rng = np.random.default_rng(0)
    recs = [{"kind": "epoch", "ts": 10.0 + e, "epoch": e, "train_loss": 2.0 - 0.1 * e,
             "test_accuracy": 0.1 * e, "examples_per_s": 100.0 + e} for e in range(4)]
    for m, seed in (("grand", 0), ("grand", 1), ("el2n", 0)):
        counts = rng.integers(0, 9, 6).tolist()
        recs.append({"kind": "score_stats", "ts": 20.0, "method": m, "seed": seed,
                     "hist": {"edges": np.linspace(0, 1, 7).tolist(), "counts": counts}})
    recs.append({"kind": "score_stats", "ts": 21.0, "method": "aum", "seed": 0,
                 "hist": None})   # an all-NaN vector: skipped
    recs += [{"kind": "summary", "ts": 30.0 + i, "sparsity": s, "score_method": "grand",
              "final_test_accuracy": 0.5 - s / 4} for i, s in enumerate((0.3, 0.5, 0.3))]
    path = tmp_path / "m.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n{partial")
    return path


def test_score_hist_series_equals_jax(tmp_path):
    recs = jax_plots._read_jsonl(str(_stream(tmp_path)))
    assert plots._read_jsonl(str(tmp_path / "m.jsonl")) == recs
    got = plots.score_hist_series(recs)
    assert got == jax_plots.score_hist_series(recs)
    assert sorted(got) == ["el2n", "grand"] and [s for s, _, _ in got["grand"]] == [0, 1]


def _monitor_log(tmp_path: Path) -> Path:
    recs = [{"ts": 5.0 + i, "cpu_pct": 10.0 * i, "duty_cycle": 0.1 * i,
             "devices": [{"device": f"cuda:{k}", "bytes_in_use": 2**30 * (i + k),
                          "bytes_limit": 2**34, "duty_cycle": 0.05 * i} for k in (0, 1)]}
            for i in range(5)]
    path = tmp_path / "util.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    return path


def _npz(tmp_path: Path) -> Path:
    rng = np.random.default_rng(1)
    path = tmp_path / "s_scores.npz"
    np.savez(path, scores=rng.random(200).astype(np.float32), indices=np.arange(200),
             kept=np.arange(0, 200, 2), keep="hardest", class_balance=False)
    return path


@pytest.mark.parametrize("fn,args,kw", [
    ("plot_metrics", ["stream"], {}),
    ("plot_metrics", ["stream"], {"since_ts": 12.5}),
    ("plot_score_stats", ["stream"], {}),
    ("plot_scores", ["npz"], {}),
    ("plot_scores", ["npz"], {"name": "score_distribution_s0.5.png"}),
    ("plot_utilization", ["monitor"], {}),
    ("plot_utilization", ["monitor"], {"since_ts": 100.0}),
    ("plot_scores", ["missing"], {}),
])
def test_plot_functions_write_the_jax_modules_files(tmp_path, fn, args, kw):
    inputs = {"stream": _stream(tmp_path), "npz": _npz(tmp_path),
              "monitor": _monitor_log(tmp_path), "missing": tmp_path / "none.npz"}
    paths = [str(inputs[a]) for a in args]
    got = getattr(plots, fn)(*paths, str(tmp_path / "torch"), **kw)
    want = getattr(jax_plots, fn)(*paths, str(tmp_path / "jax"), **kw)
    assert _names(got) == _names(want)
    assert all(Path(p).stat().st_size > 0 for p in got)
    assert getattr(obs, fn) is getattr(plots, fn)


def test_without_matplotlib_every_function_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "plots")
    assert plots.plot_metrics(str(_stream(tmp_path)), out) == []
    assert plots.plot_score_stats(str(tmp_path / "m.jsonl"), out) == []
    assert plots.plot_scores(str(_npz(tmp_path)), out) == []
    assert plots.plot_utilization(str(_monitor_log(tmp_path)), out) == []
    assert jax_plots.plot_metrics(str(tmp_path / "m.jsonl"), out) == []
    assert not (tmp_path / "plots").exists()


def test_a_rendering_failure_leaves_the_command_successful(tmp_path, monkeypatch, capsys):
    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(plots, "plot_metrics", broken)
    rc = cli.main(["score", "--device", "cpu", *TINY, "score.pretrain_epochs=0",
                   f"train.checkpoint_dir={tmp_path}/ckpt", f"obs.metrics_path={tmp_path}/m",
                   f"obs.plots_dir={tmp_path}/plots"])
    out = capsys.readouterr().out
    assert rc == 0 and "[plots] rendering failed: OSError('disk full')" in out
