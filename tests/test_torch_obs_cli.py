"""PyTorch port: ``cli run`` with every instrument on, held against the JAX
package's ``cli run`` on the same tiny config (tiny_cnn, 64 synthetic
examples, one pretrain epoch a seed, two seeds, GraNd, two retrain epochs):

* both streams pass ``tools/validate_metrics.py --expect-terminal``;
* every record kind of the JAX stream is in the port's, with at least the
  JAX record's keys (``JAX_ONLY_KINDS`` names the exception);
* ``tools/trace_report.py`` reads the port's trace, and its span names and
  their nesting equal the JAX trace's (the JAX chunked engine's ``chunk``
  span aside; both runs take the per-step path here);
* the port's scores are bitwise those of the same run with every instrument
  off;
* the score program's FLOPs per example do not depend on what runs inside the
  kernel functions;
* the port's ``train_step`` FLOPs per example lie within [0.75, 1.25] of the
  JAX harvest's (XLA counts elementwise work, ``FlopCounterMode`` does not;
  the JAX record is per partition of its 8-device CPU mesh).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu import cli as jax_cli
# The JAX CLI imports its training loop (and Orbax with it, ~10 s on the CPU)
# at first dispatch; importing it with the module keeps that once-per-process
# cost out of the runs the fixture times.
from data_diet_distributed_tpu.train import loop as _jax_loop  # noqa: F401
from data_diet_distributed_tpu_torch import cli
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.obs import introspect
from data_diet_distributed_tpu_torch.ops import kernels
from data_diet_distributed_tpu_torch.ops.scores import make_local_scores, resolve_score_method
from data_diet_distributed_tpu_torch.weights import init_variables

REPO = Path(__file__).resolve().parent.parent

#: Kinds of the JAX stream the port does not emit, with the reason (ROADMAP
#: Queue 3 carries them): ``tuning_applied`` is the autotuner's manifest
#: verdict, and the autotuner (``data_diet_distributed_tpu/tuning.py``) is not
#: ported.
JAX_ONLY_KINDS = {"tuning_applied"}

RUN = ["run", "data.dataset=synthetic", "data.synthetic_size=64", "data.batch_size=32",
       "data.eval_batch_size=64", "score.batch_size=32", "score.grand_chunk=8",
       "model.arch=tiny_cnn", "score.method=grand", "score.pretrain_epochs=1",
       "score.seeds=[0,1]", "train.num_epochs=2", "train.half_precision=false",
       "train.chunk_steps=1"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny ops: the test workers share
    the machine's cores, and oversubscribed thread pools make each op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instruments(d: Path) -> list[str]:
    return [f"train.checkpoint_dir={d}/ckpt", f"obs.metrics_path={d}/m.jsonl",
            f"obs.profile_dir={d}/prof", "obs.monitor=true",
            f"obs.monitor_path={d}/util.jsonl", f"obs.perf_ledger={d}/ledger.jsonl",
            f"obs.prom_path={d}/m.prom", "obs.server_port=0",
            "obs.heartbeat_interval_s=0", "obs.slo_throughput_floor=1",
            "obs.slo_nonfinite_frac=0.0", "obs.slo_eval_accuracy_floor=0.0"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for line in open(path) if line.strip()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_cli")
    out = {}
    for side in ("jax", "torch"):
        (tmp / side).mkdir()   # the JAX monitor thread opens its file there at once
    assert jax_cli.main(RUN + _instruments(tmp / "jax")) == 0
    out["jax"] = tmp / "jax"
    assert cli.main(RUN + ["--device", "cpu"] + _instruments(tmp / "torch")) == 0
    out["torch"] = tmp / "torch"
    off = tmp / "off"
    assert cli.main(RUN + ["--device", "cpu", f"train.checkpoint_dir={off}/ckpt",
                           f"obs.metrics_path={off}/m.jsonl", "obs.trace=false",
                           "obs.heartbeat=false", "obs.flightrec=false",
                           "obs.xla_introspect=false", "obs.score_telemetry=false",
                           "obs.fleet=false"]) == 0
    out["off"] = off
    return out


def test_streams_validate_and_port_has_every_jax_kind_and_key(runs):
    vm = _tool("validate_metrics")
    for side in ("jax", "torch"):
        assert vm.validate_file(str(runs[side] / "m.jsonl"), expect_terminal=True) == []
    jax_recs, port_recs = _records(runs["jax"] / "m.jsonl"), _records(runs["torch"] / "m.jsonl")
    assert [r["kind"] for r in port_recs[-2:]] == ["metrics", "run_summary"]

    def keys_by_kind(recs):
        out: dict[str, set] = {}
        for r in recs:
            out.setdefault(r["kind"], set()).update(r)
        return out

    want, got = keys_by_kind(jax_recs), keys_by_kind(port_recs)
    assert JAX_ONLY_KINDS <= set(want)
    for kind in sorted(set(want) - JAX_ONLY_KINDS):
        assert kind in got, kind
        assert want[kind] <= got[kind], (kind, want[kind] - got[kind])
    summary = port_recs[-1]
    for block in ("stage_s", "xla", "mfu", "slo", "score_stability", "final"):
        assert block in summary, block
    assert 0 < summary["mfu"] <= 1 and summary["peak_flops_source"] == "calibrated"
    assert all(r["run_id"] == summary["run_id"] and r["attempt"] == 0 for r in port_recs)
    ledger = _records(runs["torch"] / "ledger.jsonl")
    assert len(ledger) == 1 and ledger[0]["backend"] == "cpu"
    assert set(_records(runs["jax"] / "ledger.jsonl")[0]) - {"device_kind"} <= set(ledger[0])
    # A sample a second: a run this short may end before the first.
    assert all({"ts", "cpu_pct", "devices"} <= set(r)
               for r in _records(runs["torch"] / "util.jsonl"))


def _nesting(events: list[dict]) -> set:
    """(parent, child) span-name pairs: a span's parent is the innermost span
    of its thread containing it; ``chunk`` spans are left out."""
    spans = sorted((e for e in events if e.get("ph") == "X" and e["name"] != "chunk"),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    pairs, stack = set(), []
    for e in spans:
        while stack and not (stack[-1]["tid"] == e["tid"]
                             and e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"]):
            stack.pop()
        pairs.add((stack[-1]["name"] if stack else None, e["name"]))
        stack.append(e)
    return pairs


def test_trace_spans_nest_as_jax(runs, capsys):
    tr = _tool("trace_report")
    assert tr.main(["--json", str(runs["torch"] / "trace.json")]) == 0
    report = json.loads(capsys.readouterr().out)
    assert {"score", "prune:final", "retrain:final"} <= set(report["stages"])
    events = {side: tr.read_trace(str(runs[side] / "trace.json")) for side in ("jax", "torch")}
    assert _nesting(events["torch"]) == _nesting(events["jax"])
    assert ("run", "score") in _nesting(events["torch"])
    assert ("fit", "epoch") in _nesting(events["torch"])


def test_scores_bitwise_with_instruments_off(runs):
    with np.load(runs["torch"] / "ckpt_scores.npz") as on, \
            np.load(runs["off"] / "ckpt_scores.npz") as off:
        assert np.array_equal(on["scores"], off["scores"])
        assert np.array_equal(on["kept"], off["kept"])
    recs = _records(runs["off"] / "m.jsonl")
    assert [r["kind"] for r in recs[-2:]] == ["metrics", "run_summary"]
    assert not {"xla_program", "score_stats"} & {r["kind"] for r in recs}
    for name in ("trace.json", "prof"):
        assert not (runs["off"] / name).exists()


def test_train_step_flops_per_example_near_jax(runs):
    jax_recs = _records(runs["jax"] / "m.jsonl")
    partitions = next(r["data_axis"] for r in jax_recs if r["kind"] == "comm_stats")
    jax_fpe = next(r["flops_per_example"] for r in jax_recs
                   if r["kind"] == "xla_program" and r["program"] == "train_step")
    port_fpe = next(r["flops_per_example"] for r in _records(runs["torch"] / "m.jsonl")
                    if r["kind"] == "xla_program" and r["program"] == "train_step")
    ratio = port_fpe / (jax_fpe * partitions)
    assert 0.75 <= ratio <= 1.25, ratio


def test_score_flops_do_not_depend_on_the_norm_implementation(monkeypatch):
    """The same scoring batch harvested twice: once with the kernel functions'
    plain versions as they are, once with extra counted work inside them. The
    count reads the kernels' analytic work, so the two agree exactly."""
    model = create_model("tiny_cnn", 10).eval()
    variables = init_variables("tiny_cnn", 0, "cpu", num_classes=10)
    local = make_local_scores(model, resolve_score_method("grand", True), use_kernels=True)
    gen = torch.Generator().manual_seed(0)
    image = torch.randn((4, 32, 32, 3), generator=gen)
    label = torch.randint(0, 10, (4,), generator=gen)
    mask = torch.ones(4)

    def harvest():
        intro = introspect.Introspector(device="cpu")
        intro.call("score_batch", local, (variables, image, label, mask), {},
                   key="k", examples=4)
        return intro.programs["score_batch"]

    first = harvest()
    assert first["flops_source"] == "flop_counter+kernel_work" and first["kernel_flops"] > 0
    for name in ("conv_grad_norm_sq_plain", "conv_grad_norm_sq_gram_plain"):
        orig = getattr(kernels, name)

        def slower(*args, _orig=orig, **kw):
            torch.mm(torch.ones(64, 64), torch.ones(64, 64))   # counted work
            return _orig(*args, **kw)
        monkeypatch.setattr(kernels, name, slower)
    second = harvest()
    assert second["flops"] == first["flops"]
    assert second["flops_per_example"] == first["flops_per_example"]
