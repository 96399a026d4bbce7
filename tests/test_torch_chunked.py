"""PyTorch port: the chunked engine (``train.chunk_steps``; ``graphs.py``,
``train/steps.py::make_train_chunk``), case by case after the JAX package's
``tests/test_chunked.py``.

On the CPU a chunk stages its inputs into the same buffers the card's graph
reads and runs its K bodies eagerly, so these tests hold the staging, the
in-place state and the stacked metrics: the chunked fit is bitwise the
port's per-step fit (state, history, eval), its selection policy is the JAX
package's on every case of a grid, its resilience hooks act at chunk
boundaries, and three chunked steps agree with the JAX package's per-step
fit (atol 3e-3 on the variables, as the port's other train comparisons).
The JAX package's own bitwise pin of its chunked fit
(``test_chunked.py::test_chunked_fit_bit_identical``) fails on this CPU lane,
so the port is held to the JAX per-step fit, never to JAX's chunked numbers.
"""

import json
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from data_diet_distributed_tpu.config import load_config as flax_load_config
from data_diet_distributed_tpu.data import pipeline as flax_pipeline
from data_diet_distributed_tpu.data.datasets import load_dataset as flax_load_dataset
from data_diet_distributed_tpu.resilience import inject as flax_inject
from data_diet_distributed_tpu.train import loop as flax_loop
from data_diet_distributed_tpu.train import state as flax_state
from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.data.pipeline import ResidentBatches, maybe_resident
from data_diet_distributed_tpu_torch.graphs import ChunkProgram, GraphCache
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.ops import kernels
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
from data_diet_distributed_tpu_torch.resilience.sentinel import DivergenceError
from data_diet_distributed_tpu_torch.train import loop
from data_diet_distributed_tpu_torch.train import state as state_mod
from data_diet_distributed_tpu_torch.train.loop import (DEFAULT_CHUNK_STEPS, MAX_CHUNK_STEPS,
                                                        evaluate, fit, resolve_chunk_steps)
from data_diet_distributed_tpu_torch.train.state import TrainState, make_optimizer
from data_diet_distributed_tpu_torch.weights import variables_to
from test_torch_train import assert_variables_close, to_port
from torch_threads import one_intra_op_thread  # noqa: F401

#: Wall-clock fields: everything else in an epoch record is bitwise.
WALL_KEYS = ("epoch_s", "examples_per_s")

#: 256 examples at batch 64: 4 steps an epoch (a chunk of 3 and a tail of 1).
BASE = ["data.dataset=synthetic", "data.synthetic_size=256", "data.batch_size=64",
        "data.eval_batch_size=64", "model.arch=tiny_cnn", "optim.lr=0.1",
        "train.num_epochs=2", "train.half_precision=false",
        "train.log_every_steps=1000", "train.checkpoint_every=1",
        "train.device_resident_data=true", "score.pretrain_epochs=0"]


@pytest.fixture(autouse=True)
def _disarm_injectors():
    yield
    inject.deactivate()
    flax_inject.deactivate()


def _cfg(tmp_path, *extra):
    return load_config(None, [*BASE, f"train.checkpoint_dir={tmp_path}/ckpt",
                              f"obs.metrics_path={tmp_path}/metrics.jsonl", *extra])


@pytest.fixture(scope="module")
def data():
    return loop.load_data_for(load_config(None, BASE))


def _strip_wall(history):
    return [{k: v for k, v in rec.items() if k not in WALL_KEYS} for rec in history]


def _assert_state_bit_identical(a: TrainState, b: TrainState):
    assert a.step == b.step
    for group in ("params", "batch_stats", "momentum"):
        ga, gb = getattr(a, group), getattr(b, group)
        assert ga.keys() == gb.keys()
        for k in ga:
            assert torch.equal(ga[k], gb[k]), (group, k)


class _Log:
    """``log(kind, **fields)`` collecting records."""

    def __init__(self):
        self.records = []

    def __call__(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def of(self, kind):
        return [r for r in self.records if r["kind"] == kind]


# ------------------------------------------------------------ bit-exactness


@pytest.mark.parametrize("augment", [False, True])
def test_chunked_fit_bit_identical(tmp_path, data, augment):
    """chunk_steps=3 over 4 steps an epoch (a chunk of 3 and a tail of 1) and
    the auto size (4, clamped to the epoch) against per step: the same final
    state bits and the same history, eval included (the chunked eval rides
    the same engine), with and without augmentation."""
    train_ds, test_ds = data
    over = [f"data.augment={str(augment).lower()}"]
    r1 = fit(_cfg(tmp_path / "a", "train.chunk_steps=1", *over), train_ds, test_ds,
             device="cpu")
    r3 = fit(_cfg(tmp_path / "b", "train.chunk_steps=3", *over), train_ds, test_ds,
             device="cpu")
    rn = fit(_cfg(tmp_path / "c", *over), train_ds, test_ds, device="cpu")
    assert (r1.chunk_steps, r3.chunk_steps, rn.chunk_steps) == (1, 3, 4)
    assert _strip_wall(r1.history) == _strip_wall(r3.history) == _strip_wall(rn.history)
    assert "test_accuracy" in r1.history[-1]
    assert r1.state.step == r3.state.step == 8
    _assert_state_bit_identical(r1.state, r3.state)
    _assert_state_bit_identical(r1.state, rn.state)


def test_chunked_stream_fit_bit_identical(tmp_path, data):
    """``data.data_plane=streaming`` feeds the chunks prefetched blocks (the
    ``chunked_stream`` engine), bitwise the resident chunks and the
    per-step fit; one ``data_plane`` record names the engine."""
    train_ds, test_ds = data
    log = _Log()
    r1 = fit(_cfg(tmp_path / "a", "train.chunk_steps=1", "data.augment=true"), train_ds,
             test_ds, device="cpu")
    rs = fit(_cfg(tmp_path / "b", "train.chunk_steps=3", "data.augment=true",
                  "data.data_plane=streaming"), train_ds, test_ds, device="cpu", log=log)
    assert rs.chunk_steps == 3
    assert _strip_wall(r1.history) == _strip_wall(rs.history)
    _assert_state_bit_identical(r1.state, rs.state)
    (ev,) = log.of("train_chunked")
    assert ev["engine"] == "stream"
    (plane,) = log.of("data_plane")
    assert plane["engine"] == "chunked_stream" and plane["items"] == 2 * 2


def test_evaluate_chunked_matches_per_batch(tmp_path, data):
    """``evaluate`` over a resident set with chunk_steps > 1 runs K batches a
    dispatch and reports the per-batch metrics exactly."""
    train_ds, _ = data
    cfg = _cfg(tmp_path, "train.num_epochs=1")
    res = fit(cfg, train_ds, None, device="cpu")
    model = create_model_from_cfg(cfg)
    resident = maybe_resident(train_ds, 64, "cpu", torch.float32, enabled=True)
    ev_stream = evaluate(model, res.state, train_ds, 64, device="cpu")
    ev_batch = evaluate(model, res.state, train_ds, 64, device="cpu", resident=resident,
                        chunk_steps=1)
    graphs = GraphCache()
    ev_chunk = evaluate(model, res.state, train_ds, 64, device="cpu", resident=resident,
                        chunk_steps=3, graphs=graphs)
    assert ev_chunk == ev_batch == ev_stream
    assert ev_chunk["examples"] == len(train_ds)
    assert sorted(p["k"] for p in graphs.stats()) == [1, 3]


def test_resident_chunk_indices_composition(mesh8):
    """``chunk_indices`` equals the JAX package's exactly: the permutation,
    row-0 tail padding with mask 0, the remainder block."""
    ds, _ = load_dataset("synthetic", synthetic_size=100, seed=0)
    jds, _ = flax_load_dataset("synthetic", synthetic_size=100, seed=0)
    res = ResidentBatches(ds, 32, "cpu")
    want = list(flax_pipeline.ResidentBatches(jds, mesh8, batch_size=32).chunk_indices(
        3, shuffle=True, seed=7, epoch=2))
    got = list(res.chunk_indices(3, shuffle=True, seed=7, epoch=2))
    assert [g[0].shape for g in got] == [(3, 32), (1, 32)]
    for (gi, gm), (wi, wm) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


# ------------------------------------------------- selection / fallback logic


@pytest.mark.parametrize("plan", [None, "sigterm_at_step", "hang_at", "step_exception_at",
                                  "nan_loss_at_epoch"])
@pytest.mark.parametrize("chunk_steps", [None, 0, 1, 4, 100])
def test_chunk_steps_policy_equals_jax(chunk_steps, plan):
    """``resolve_chunk_steps`` returns what the JAX package's returns for every
    epoch length, feed (resident, stream, none) and consensus, under each
    fault plan (the exact-step ones route to the per-step path)."""
    if plan is not None:
        inject.activate(inject.FaultPlan(**{plan: 2}))
        flax_inject.activate(flax_inject.FaultPlan(**{plan: 2}))
    over = [] if chunk_steps is None else [f"train.chunk_steps={chunk_steps}"]
    cfg, jcfg = load_config(None, over), flax_load_config(None, over)
    for steps in (1, 3, 16, 40, 1000):
        for feed in (object(), object(), None):   # resident, stream, none
            for consensus in (None, object()):
                assert (resolve_chunk_steps(cfg, steps, feed, consensus)
                        == flax_loop.resolve_chunk_steps(jcfg, steps, feed, consensus))
    assert (DEFAULT_CHUNK_STEPS, MAX_CHUNK_STEPS) == (flax_loop.DEFAULT_CHUNK_STEPS,
                                                      flax_loop.MAX_CHUNK_STEPS)


def test_chunk_steps_config_validation():
    with pytest.raises(ValueError, match="chunk_steps"):
        load_config(None, ["train.chunk_steps=-1"])
    with pytest.raises(ValueError, match="score.chunk_steps"):
        load_config(None, ["score.chunk_steps=-1"])
    assert load_config(None, ["train.chunk_steps=0"]).train.chunk_steps == 0
    assert load_config(None, []).train.chunk_steps is None


def test_chunked_event_and_result_equal_jax(tmp_path, data, tiny_ds):
    """The ``train_chunked`` record and ``FitResult.chunk_steps`` equal the
    JAX package's on the same config; ``log_every_steps`` hoists to chunk
    boundaries (K=2 over 4 steps, every 2: steps 2 and 4)."""
    train_ds, _ = data
    over = ["train.chunk_steps=2", "train.num_epochs=1", "train.log_every_steps=2"]
    cfg = _cfg(tmp_path / "port", *over)
    log = _Log()
    res = fit(cfg, train_ds, None, device="cpu", log=log)
    jcfg = flax_load_config(None, [*BASE, *over,
                                   f"obs.metrics_path={tmp_path}/jax.jsonl"])
    from data_diet_distributed_tpu.obs import MetricsLogger
    jres = flax_loop.fit(jcfg, tiny_ds[0], None,
                         logger=MetricsLogger(jcfg.obs.metrics_path, echo=False))
    with open(jcfg.obs.metrics_path) as fh:
        jrecs = [json.loads(line) for line in fh if line.strip()]
    keys = ("tag", "chunk_steps", "steps_per_epoch", "engine")
    (want,) = [{k: r[k] for k in keys} for r in jrecs if r["kind"] == "train_chunked"]
    (got,) = [{k: r[k] for k in keys} for r in log.of("train_chunked")]
    assert got == want == {"tag": "train", "chunk_steps": 2, "steps_per_epoch": 4,
                           "engine": "resident"}
    assert res.chunk_steps == jres.chunk_steps == 2
    assert ([r["step"] for r in log.of("train_step")]
            == [r["step"] for r in jrecs if r["kind"] == "train_step"] == [2, 4])


def test_three_chunked_steps_match_jax_per_step(monkeypatch):
    """Three steps as one chunk (from the JAX init, ``params_from_flax``)
    against the JAX package's per-step fit: atol 3e-3 on the variables, as
    the port's other train comparisons."""
    over = ["data.synthetic_size=192", "train.num_epochs=1",
            "train.device_resident_data=true"]
    jcfg = flax_load_config(None, [*BASE, *over, "train.chunk_steps=0"])
    train_ds, _ = flax_loop.load_data_for(jcfg)
    init = to_port(flax_state.create_train_state(jcfg, jax.random.key(jcfg.train.seed), 3))
    want = flax_loop.fit(jcfg, train_ds, None)
    monkeypatch.setattr(state_mod, "init_variables",
                        lambda arch, seed, device=None, **kw: variables_to(init, device))
    cfg = load_config(None, [*BASE, *over, "train.chunk_steps=3"])
    got = fit(cfg, loop.load_data_for(cfg)[0], None, device="cpu")
    assert got.chunk_steps == 3 and got.state.step == int(want.state.step) == 3
    assert_variables_close(got.state.variables, to_port(want.state), rtol=0, atol=3e-3)
    np.testing.assert_allclose(got.history[0]["train_loss"], want.history[0]["train_loss"],
                               rtol=1e-4)


# ------------------------------------------- resilience at chunk boundaries


def test_sigterm_honored_within_one_chunk(tmp_path, data, monkeypatch):
    """A SIGTERM while a chunk runs is honoured at the next chunk boundary: a
    synchronous checkpoint, ``Preempted`` at that step; the resume from the
    mid-epoch checkpoint finishes chunked (2 saved + the replayed epoch 0 +
    epoch 1 = 10 steps)."""
    train_ds, _ = data
    cfg = _cfg(tmp_path, "train.chunk_steps=2")
    log = _Log()
    real = loop._dispatch_chunk
    calls = []

    def sigterm_after_first_chunk(program, state, host):
        out = real(program, state, host)
        calls.append(host["idx"].shape[0])
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(loop, "_dispatch_chunk", sigterm_after_first_chunk)
    with pytest.raises(Preempted) as exc_info:
        fit(cfg, train_ds, None, device="cpu", log=log,
            checkpoint_dir=cfg.train.checkpoint_dir)
    assert exc_info.value.step == 2 and exc_info.value.durable_step == 2
    assert calls == [2]
    (ev,) = log.of("preempted")
    assert ev["signal"] == "SIGTERM" and ev["durable_step"] == 2
    monkeypatch.setattr(loop, "_dispatch_chunk", real)
    cfg.train.resume = True
    res = fit(cfg, train_ds, None, device="cpu", log=log,
              checkpoint_dir=cfg.train.checkpoint_dir)
    assert res.chunk_steps == 2 and res.state.step == 10 and len(res.history) == 2


def test_chunked_nan_sentinel_raises_before_checkpoint(tmp_path, data):
    """The NaN verdict stays an epoch-boundary check: under the chunked engine
    the diverged state never becomes durable."""
    train_ds, _ = data
    cfg = _cfg(tmp_path, "train.chunk_steps=4")
    log = _Log()
    inject.activate(inject.FaultPlan(nan_loss_at_epoch=0))
    with pytest.raises(DivergenceError):
        fit(cfg, train_ds, None, device="cpu", log=log,
            checkpoint_dir=cfg.train.checkpoint_dir)
    assert CheckpointManager(cfg.train.checkpoint_dir).latest_step() is None
    assert [f["fault"] for f in log.of("fault")] == ["divergence"]


def test_chunked_watchdog_deadline_scales_with_chunk(tmp_path, data, monkeypatch):
    """One heartbeat a chunk: the watchdog's deadline is step_timeout_s × K."""
    from data_diet_distributed_tpu_torch.resilience.watchdog import Watchdog

    seen = []

    class Recording(Watchdog):
        def __init__(self, timeout_s, *a, **kw):
            seen.append(timeout_s)
            super().__init__(timeout_s, *a, **kw)

    monkeypatch.setattr(loop, "Watchdog", Recording)
    train_ds, _ = data
    for k in (4, 1):
        fit(_cfg(tmp_path / str(k), f"train.chunk_steps={k}", "train.num_epochs=1",
                 "resilience.step_timeout_s=30"), train_ds, None, device="cpu")
    assert seen == [120, 30]


def test_step_targeted_sigterm_falls_back_to_per_step(tmp_path, data):
    """An exact-step SIGTERM under a chunked config runs the per-step engine:
    honoured at step 3, as per step, not at a chunk-4 boundary; no
    ``train_chunked`` record."""
    train_ds, _ = data
    cfg = _cfg(tmp_path, "train.chunk_steps=4", "train.num_epochs=1")
    log = _Log()
    inject.activate(inject.FaultPlan(sigterm_at_step=2))
    with pytest.raises(Preempted) as exc_info:
        fit(cfg, train_ds, None, device="cpu", log=log,
            checkpoint_dir=cfg.train.checkpoint_dir)
    assert exc_info.value.step == 3
    assert log.of("train_chunked") == []


# ------------------------------------------------------ staging and counts


def test_chunk_program_reads_its_new_block():
    """A program run twice stages its second block into the same buffers: it
    reads the new inputs, not the old, and returns fresh outputs."""
    prog = ChunkProgram("probe", lambda inp: {"s": inp["x"].sum(dim=1) * inp["lr"]
                                              + inp["img"].sum(dim=(1, 2))}, "cpu", k=2,
                        staged={"x": ((2, 3), torch.int64), "lr": ((2,), torch.float32)},
                        copied={"img": ((2, 4, 4), torch.float32)})
    a = prog({"x": np.ones((2, 3)), "lr": np.float32([1, 2])},
             {"img": torch.zeros(2, 4, 4)})["s"].clone()
    b = prog({"x": np.full((2, 3), 5), "lr": np.float32([3, 4])},
             {"img": torch.ones(2, 4, 4)})["s"]
    assert a.tolist() == [3.0, 6.0] and b.tolist() == [61.0, 76.0]
    with pytest.raises(ValueError, match="shape"):
        prog({"x": np.ones((3, 3)), "lr": np.float32([1, 2])}, {"img": torch.zeros(2, 4, 4)})


def test_staged_learning_rate_is_bitwise_the_host_float(data):
    """The chunk's update by a staged 0-dim fp32 ``lr`` is bitwise the
    per-step update by the host float from the same schedule."""
    gen = torch.Generator().manual_seed(0)
    params = {f"w{i}": torch.randn(7, 5, generator=gen) for i in range(3)}
    grads = {k: torch.randn(7, 5, generator=gen) for k in params}
    cfg = load_config(None, BASE)
    sgd = make_optimizer(cfg, 4)
    states = [TrainState({k: v.clone() for k, v in params.items()}, {},
                         {k: torch.zeros_like(v) for k, v in params.items()}, step=s)
              for s in (5, 5)]
    sgd.update(states[0], grads)
    sgd.update(states[1], grads, lr=torch.tensor(np.float32(sgd.schedule(5))))
    assert states[0].step == 6 and states[1].step == 5   # the chunk advances its own
    for k in params:
        assert torch.equal(states[0].params[k], states[1].params[k])
        assert torch.equal(states[0].momentum[k], states[1].momentum[k])


def test_captured_launches_count_at_replay(monkeypatch):
    """A launch inside ``kernels.recording`` (a graph capture) is tallied, not
    counted; ``add_launches`` counts the tally once a replay, with its mode."""
    kern = kernels.CONV_GRAD_NORM_GRAM
    monkeypatch.setattr(kern, "_entry", (None, lambda *args: 0))
    kernels.reset_launch_counts()
    with kernels.recording() as tally:
        kern.launch(mode="tensor_core")
        # A capture's backward launches from the autograd engine's thread.
        worker = threading.Thread(target=kern.launch, kwargs={"mode": "tensor_core"})
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert kernels.launch_counts()["conv_grad_norm_gram"] == 0
    assert tally == {("conv_grad_norm_gram", "tensor_core"): 2}
    for _ in range(3):
        kernels.add_launches(tally)
    kern.launch(mode="fp32")
    assert kernels.launch_counts()["conv_grad_norm_gram"] == 7
    assert kernels.mode_counts()["conv_grad_norm_gram"] == {"tensor_core": 6, "fp32": 1}
    kernels.reset_launch_counts()
