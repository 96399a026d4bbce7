"""PyTorch port: the resilience core (``resilience/``) and its hooks in ``fit`` and
``fit_with_recovery``.

The jax-free classes (preemption, sentinel, watchdog, fault plans) and the
checkpoint manifest check run the same inputs through the JAX package's class
and the port's, and must reach the same outcome. The fit-level cases use the
coordinates of ``tests/test_resilience.py`` (tiny_cnn, 256 examples, batch
64: 4 steps an epoch) and assert the values the JAX tests pin there; each
recovered fit is held bitwise against the port's own uninterrupted fit. A NaN
rollback and an epoch-end SIGTERM also run through JAX's ``fit_with_recovery``
beside the port's, and their records must agree field by field.
"""

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu.obs import MetricsLogger
from data_diet_distributed_tpu.resilience import inject as jax_inject
from data_diet_distributed_tpu.resilience import integrity as jax_integrity
from data_diet_distributed_tpu.resilience import preemption as jax_preemption
from data_diet_distributed_tpu.resilience import sentinel as jax_sentinel
from data_diet_distributed_tpu.resilience import watchdog as jax_watchdog
from data_diet_distributed_tpu.train import loop as jax_loop
from data_diet_distributed_tpu_torch.checkpoint import CheckpointManager
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.resilience import inject
from data_diet_distributed_tpu_torch.resilience import integrity
from data_diet_distributed_tpu_torch.resilience import preemption
from data_diet_distributed_tpu_torch.resilience import sentinel
from data_diet_distributed_tpu_torch.resilience import watchdog
from data_diet_distributed_tpu_torch.resilience.integrity import CheckpointCorrupt
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
from data_diet_distributed_tpu_torch.resilience.sentinel import DivergenceError
from data_diet_distributed_tpu_torch.train import loop

SIDES = {"jax": (jax_preemption, jax_sentinel, jax_watchdog, jax_inject),
         "torch": (preemption, sentinel, watchdog, inject)}


@pytest.fixture(autouse=True)
def _disarm_injectors():
    yield
    inject.deactivate()
    jax_inject.deactivate()


def _both(scenario):
    """The scenario's outcome on each side; they must be equal."""
    out = {name: scenario(*mods) for name, mods in SIDES.items()}
    assert out["jax"] == out["torch"], out
    return out["torch"]


# ---------------------------------------------------------------- preemption


def test_preemption_first_signal_sets_flag_only():
    def scenario(pre, *_):
        with pre.PreemptionHandler() as handler:
            active = handler.active
            signal.raise_signal(signal.SIGTERM)
            seen = (handler.requested, handler.signame)
        return active, seen, signal.getsignal(signal.SIGTERM) is handler._handle
    assert _both(scenario) == (True, (True, "SIGTERM"), False)


def test_preemption_mixed_signals_do_not_escalate():
    def scenario(pre, *_):
        with pre.PreemptionHandler() as handler:
            signal.raise_signal(signal.SIGTERM)
            signal.raise_signal(signal.SIGINT)
            return handler.requested, handler.signame
    assert _both(scenario) == (True, "SIGINT")   # the last signal names it


def test_preemption_second_sigint_escalates_to_default():
    def scenario(pre, *_):
        try:
            with pre.PreemptionHandler(signals=(signal.SIGINT,)) as handler:
                signal.raise_signal(signal.SIGINT)
                first = handler.requested
                signal.raise_signal(signal.SIGINT)
        except KeyboardInterrupt:
            return first, "KeyboardInterrupt"
        return first, None
    assert _both(scenario) == (True, "KeyboardInterrupt")


def test_preempted_message_and_fields():
    def scenario(pre, *_):
        p = pre.Preempted("SIGTERM", step=3, epoch=-1, durable_step=3)
        return str(p), p.step, p.epoch, p.durable_step
    assert _both(scenario)[1:] == (3, -1, 3)
    assert preemption.EXIT_PREEMPTED == jax_preemption.EXIT_PREEMPTED == 75


# ------------------------------------------------------------------ sentinel


@pytest.mark.parametrize("value", [0.25, float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("enabled", [True, False])
def test_loss_sentinel_matches_jax(value, enabled):
    def scenario(_, sen, *__):
        try:
            sen.LossSentinel(enabled).check(value, epoch=2, tag="final")
        except sen.DivergenceError as err:
            return ("raised", err.epoch, err.tag, repr(err.value),
                    "non-finite train loss" in str(err))
        return ("ok",)
    out = _both(scenario)
    assert out[0] == ("raised" if enabled and not math.isfinite(value) else "ok")


# ------------------------------------------------------------------ watchdog


def test_watchdog_converts_hang_to_retriable_timeout():
    def scenario(_, __, wd, ___):
        t0 = time.monotonic()
        try:
            with wd.Watchdog(timeout_s=0.3, label="unit"):
                time.sleep(30)
        except wd.WatchdogTimeout as err:
            return ("timeout", "no heartbeat within" in str(err),
                    time.monotonic() - t0 < 5.0, isinstance(err, RuntimeError))
        return ("no timeout",)
    assert _both(scenario) == ("timeout", True, True, True)


def test_watchdog_heartbeat_keeps_section_alive():
    def scenario(_, __, wd, ___):
        with wd.Watchdog(timeout_s=0.5) as guard:
            for _ in range(6):
                guard.beat()
                time.sleep(0.15)   # 0.9 s in all: only the beats keep it alive
        return guard.fired
    assert _both(scenario) is False


def test_watchdog_suspend_covers_long_blocking_section():
    def scenario(_, __, wd, ___):
        with wd.Watchdog(timeout_s=0.3) as guard:
            guard.suspend()
            time.sleep(0.8)
        return guard.fired
    assert _both(scenario) is False


def test_watchdog_requires_main_thread():
    def scenario(_, __, wd, ___):
        caught = {}

        def run():
            try:
                with wd.Watchdog(timeout_s=1.0):
                    pass
            except RuntimeError as err:
                caught["err"] = "main thread" in str(err)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        return caught
    assert _both(scenario) == {"err": True}


def test_watchdog_escalates_when_the_raise_cannot_land(tmp_path):
    """A main thread that never runs the handler (here: SIGUSR1 blocked, as
    in a native call) is ended with the retriable status after escalate_s."""
    script = (
        "import signal, time\n"
        "from data_diet_distributed_tpu_torch.resilience.watchdog import Watchdog\n"
        "signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGUSR1})\n"
        "with Watchdog(timeout_s=0.2, escalate_s=0.3, escalate_code=69):\n"
        "    time.sleep(30)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 69, proc.stderr[-2000:]
    assert time.monotonic() - t0 < 20.0


def test_probe_devices_reports_success_and_crash(monkeypatch):
    monkeypatch.setattr(watchdog, "PROBE_SNIPPET",
                        'print(\'{"n": 1, "platform": "cuda"}\')')
    info = watchdog.probe_devices(attempts=1, timeout_s=60.0, backoff_s=0.0)
    assert info["n"] == 1 and info["attempts"] == 1 and info["resets"] == 0
    monkeypatch.setattr(watchdog, "PROBE_SNIPPET",
                        'raise SystemExit("CUDA init refused the device")')
    info = watchdog.probe_devices(attempts=1, timeout_s=60.0, backoff_s=0.0)
    assert "CUDA init refused the device" in info["error"]
    assert "after 1 attempts" in info["error"]


def test_probe_devices_bounds_a_wedge_and_runs_the_reset(monkeypatch, tmp_path):
    marker = tmp_path / "reset_ran"
    monkeypatch.setattr(watchdog, "PROBE_SNIPPET", "import time; time.sleep(60)")
    monkeypatch.setenv(watchdog.CLAIM_RESET_CMD_ENV, f"touch {marker}")
    retries = []
    t0 = time.monotonic()
    info = watchdog.probe_devices(attempts=2, timeout_s=1.0, backoff_s=0.05,
                                  on_retry=lambda n, err: retries.append(err))
    assert "wedge" in info["error"] and info["attempts"] == 2 and info["resets"] == 1
    assert marker.exists() and len(retries) == 1
    assert time.monotonic() - t0 < 10.0


def test_probe_snippet_initializes_cuda_through_torch():
    assert "torch.cuda.init()" in watchdog.PROBE_SNIPPET
    assert "jax" not in watchdog.PROBE_SNIPPET


# -------------------------------------------------------------- fault plans


def test_fault_plan_from_env_matches_jax(monkeypatch):
    spec = ('{"hang_at": 3, "hang_seconds": 1.5, "sigterm_after_seed_scores": 2, '
            '"nan_loss_at_epoch": 1}')
    monkeypatch.setenv("DDT_FAULT_PLAN", spec)

    def scenario(*mods):
        inj = mods[3]
        plan = inj.activate_from_env()
        fields = (plan.hang_at, plan.hang_seconds, plan.sigterm_after_seed_scores,
                  plan.nan_loss_at_epoch, plan.step_exception_at)
        armed = inj.active_plan() is plan
        inj.deactivate()
        return fields, armed, inj.active_plan()
    assert _both(scenario) == ((3, 1.5, 2, 1, None), True, None)
    monkeypatch.setenv("DDT_FAULT_PLAN", '{"hangat": 3}')
    for inj in (jax_inject, inject):   # a typo never disarms a drill
        with pytest.raises(ValueError, match="hangat"):
            inj.activate_from_env()


@pytest.mark.parametrize("key,value", [("rank", 1), ("kill_rank_after_epoch", 0),
                                       ("rejoin_after_stage", "score"),
                                       ("hide_latest_durable", True),
                                       ("wedge_dispatcher_after", 2),
                                       ("torn_shard_read", 0)])
def test_fault_plan_arming_an_unported_class_refuses_by_name(monkeypatch, key, value):
    import json
    monkeypatch.setenv("DDT_FAULT_PLAN", json.dumps({"hang_at": 1, key: value}))
    assert jax_inject.activate_from_env() is not None   # the JAX package fires it
    with pytest.raises(ValueError, match=f"{key}.*not ported"):
        inject.activate_from_env()
    assert inject.active_plan() is None


def test_faults_fire_once_at_their_coordinate():
    def scenario(*mods):
        inj = mods[3]
        inj.activate(inj.FaultPlan(step_exception_at=2, nan_loss_at_epoch=1))
        raised = []
        for step in (0, 1, 2, 2, 3):
            try:
                inj.fire("step", epoch=0, step=step)
            except RuntimeError as err:
                raised.append((step, str(err)))
        losses = [inj.transform("epoch_loss", 0.5, epoch=e) for e in (0, 1, 1)]
        return raised, [repr(x) for x in losses]
    assert _both(scenario) == ([(2, "injected step exception at global step 2")],
                               ["0.5", "nan", "0.5"])


# ------------------------------------------------------ checkpoint manifest


def test_manifest_verification_matches_jax():
    w = np.ones((2, 3), np.float32)
    m = np.zeros(3, np.float32)

    def jax_check(params, step):
        payload = {"params": {"w": jnp.asarray(w)}, "batch_stats": {},
                   "opt_state": {"m": jnp.asarray(m)}, "step": 5}
        manifest = jax_integrity.build_manifest(payload, 5)
        got = dict(payload, params={"w": jnp.asarray(params)})
        try:
            jax_integrity.verify_restored(got, manifest, step=step)
        except jax_integrity.CheckpointCorrupt as err:
            return str(err)
        return "ok"

    def port_check(params, step):
        manifest = integrity.build_manifest({"params/w": w, "momentum/m": m}, 5, 5)
        try:
            integrity.verify_restored({"params/w": params, "momentum/m": m},
                                      manifest, step)
        except CheckpointCorrupt as err:
            return str(err)
        return "ok"

    cases = {"clean": (w, 5, "ok"), "wrong step": (w, 6, "records step"),
             "shape drift": (np.ones((2, 4), np.float32), 5, "shape"),
             "poisoned": (np.full((2, 3), np.nan, np.float32), 5, "non-finite")}
    for name, (params, step, want) in cases.items():
        for got in (jax_check(params, step), port_check(params, step)):
            assert want in got, (name, got)
    flipped = w.copy()
    flipped[0, 0] = 1.0 + 2 ** -20   # same shape, finite: only a digest sees it
    assert "sha256" in port_check(flipped, 5)
    assert issubclass(CheckpointCorrupt, ValueError)


# ------------------------------------------ injected faults through fit, end to end


def _mk_cfg(tmp_path, *extra):
    return load_config(None, [
        "data.dataset=synthetic", "data.synthetic_size=256",
        "data.batch_size=64", "data.eval_batch_size=64",
        "model.arch=tiny_cnn", "optim.lr=0.1",
        "train.num_epochs=1", "train.half_precision=false",
        "train.log_every_steps=1000", "train.checkpoint_every=1",
        f"train.checkpoint_dir={tmp_path}/ckpt",
        "score.pretrain_epochs=0", "score.batch_size=64", *extra])


class Events:
    """A ``log`` callable that keeps every record."""

    def __init__(self):
        self.records = []

    def __call__(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def of(self, kind):
        return [e for e in self.records if e["kind"] == kind]


def _pin(history):
    return [{k: rec[k] for k in ("epoch", "train_loss", "train_accuracy")}
            for rec in history]


def _states_equal(a, b):
    return a.step == b.step and all(
        torch.equal(getattr(a, g)[k], getattr(b, g)[k])
        for g in ("params", "batch_stats", "momentum") for k in getattr(a, g))


@pytest.fixture(scope="module")
def data():
    cfg = load_config(None, ["data.dataset=synthetic", "data.synthetic_size=256"])
    return loop.load_data_for(cfg)[0]


@pytest.fixture(scope="module")
def baseline1(tmp_path_factory, data):
    return loop.fit(_mk_cfg(tmp_path_factory.mktemp("b1")), data, None, device="cpu")


@pytest.fixture(scope="module")
def baseline2(tmp_path_factory, data):
    cfg = _mk_cfg(tmp_path_factory.mktemp("b2"), "train.num_epochs=2")
    return loop.fit(cfg, data, None, device="cpu")


def test_injected_step_exception_recovers_pinned(tmp_path, data, baseline1):
    cfg = _mk_cfg(tmp_path, "train.auto_resume_retries=2")
    ev = Events()
    inject.activate(inject.FaultPlan(step_exception_at=1))
    res = loop.fit_with_recovery(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt",
                                 device="cpu", log=ev)
    # No checkpoint was durable at step 1: the retry restarts from scratch.
    assert _pin(res.history) == _pin(baseline1.history)
    assert _states_equal(res.state, baseline1.state)
    assert [f["fault"] for f in ev.of("fault")] == ["step_exception"]
    rec = ev.of("recovery")[0]
    assert rec["cause"] == "exception" and rec["retry"] == 1 and rec["retries_left"] == 1
    assert rec["resume"] is False


def test_step_exception_without_retries_raises(tmp_path, data):
    inject.activate(inject.FaultPlan(step_exception_at=1))
    with pytest.raises(RuntimeError, match="injected step exception at global step 1"):
        loop.fit_with_recovery(_mk_cfg(tmp_path), data, None,
                               checkpoint_dir=f"{tmp_path}/ckpt", device="cpu")


def test_injected_hang_watchdog_kills_and_recovery_repins(tmp_path, data, baseline1):
    cfg = _mk_cfg(tmp_path, "resilience.step_timeout_s=2", "train.auto_resume_retries=2")
    ev = Events()
    inject.activate(inject.FaultPlan(hang_at=2, hang_seconds=600.0))
    t0 = time.monotonic()
    res = loop.fit_with_recovery(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt",
                                 device="cpu", log=ev)
    assert time.monotonic() - t0 < 30.0   # vs. the 600 s injected hang
    assert _states_equal(res.state, baseline1.state)
    faults = ev.of("fault")
    assert [f["fault"] for f in faults] == ["hang"]
    assert "WatchdogTimeout" in faults[0]["error"]


def test_sigterm_at_epoch_end_preempts_then_resumes_pinned(tmp_path, data, baseline2):
    cfg = _mk_cfg(tmp_path, "train.num_epochs=2")
    ev = Events()
    inject.activate(inject.FaultPlan(sigterm_at_epoch_end=0))
    with pytest.raises(Preempted) as exc_info:
        loop.fit_with_recovery(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt",
                               device="cpu", log=ev)
    # Epoch 0's checkpoint (step 4) was already durable.
    assert exc_info.value.durable_step == 4 and exc_info.value.epoch == 0
    pre = ev.of("preempted")
    assert pre and pre[0]["signal"] == "SIGTERM" and pre[0]["durable_step"] == 4
    assert "preempted" not in CheckpointManager(f"{tmp_path}/ckpt").metrics(4)
    cfg.train.resume = True
    res = loop.fit_with_recovery(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt",
                                 device="cpu", log=ev)
    assert res.state.step == 8
    assert _pin(res.history) == _pin(baseline2.history)[1:]
    assert _states_equal(res.state, baseline2.state)


def test_sigterm_mid_epoch_saves_final_sync_checkpoint(tmp_path, data):
    cfg = _mk_cfg(tmp_path, "train.num_epochs=2")
    inject.activate(inject.FaultPlan(sigterm_at_step=2))
    with pytest.raises(Preempted) as exc_info:
        loop.fit_with_recovery(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt",
                               device="cpu")
    # The signal came before step 2; that step still ran, then the poll.
    assert exc_info.value.step == 3 and exc_info.value.durable_step == 3
    assert exc_info.value.epoch == -1
    mngr = CheckpointManager(f"{tmp_path}/ckpt")
    assert mngr.all_steps() == [3]
    meta = mngr.metrics(3)
    assert meta["preempted"] is True and meta["epoch"] == -1
    # At least once: the resume replays epoch 0 from its start, the step
    # counter continuing from 3, so 3 + 2 epochs x 4 steps.
    inject.deactivate()
    cfg.train.resume = True
    ev = Events()
    res = loop.fit(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt", device="cpu",
                   log=ev)
    assert ev.of("resume")[0]["step"] == 3 and ev.of("resume")[0]["epoch"] == 0
    assert [h["epoch"] for h in res.history] == [0, 1] and res.state.step == 11


def test_truncated_checkpoint_falls_back_to_earlier_step(tmp_path, data, baseline2):
    cfg = _mk_cfg(tmp_path, "train.num_epochs=2")
    ckdir = f"{tmp_path}/ckpt"
    inject.activate(inject.FaultPlan(truncate_after_save_step=8))
    loop.fit(cfg, data, None, checkpoint_dir=ckdir, device="cpu")
    inject.deactivate()
    cfg.train.resume = True
    ev = Events()
    res = loop.fit(cfg, data, None, checkpoint_dir=ckdir, device="cpu", log=ev)
    assert res.state.step == 8
    assert _pin(res.history) == _pin(baseline2.history)[1:]
    assert _states_equal(res.state, baseline2.state)
    faults = ev.of("fault")
    assert [f["fault"] for f in faults] == ["checkpoint_corrupt"]
    assert faults[0]["step"] == 8 and ev.of("resume")[0]["step"] == 4


def test_all_checkpoints_corrupt_refuses_loudly(tmp_path, data):
    cfg = _mk_cfg(tmp_path)
    ckdir = f"{tmp_path}/ckpt"
    loop.fit(cfg, data, None, checkpoint_dir=ckdir, device="cpu")
    assert inject.truncate_checkpoint(ckdir, 4)[0].endswith("step_4/arrays.npz")
    cfg.train.resume = True
    ev = Events()
    with pytest.raises(CheckpointCorrupt, match="failed restore"):
        loop.fit(cfg, data, None, checkpoint_dir=ckdir, device="cpu", log=ev)
    assert ev.of("fault")[-1]["fault"] == "checkpoint_corrupt"
    with pytest.raises(FileNotFoundError, match="no non-empty files"):
        inject.truncate_checkpoint(ckdir, 99)


def test_verify_restore_off_resumes_newest_without_fallback(tmp_path, data):
    """``resilience.verify_restore=false``: the resume takes the newest step
    as it is. The port's format still checks what it reads, so a truncated
    newest step raises instead of falling back to an earlier one."""
    cfg = _mk_cfg(tmp_path, "train.num_epochs=2", "resilience.verify_restore=false")
    ckdir = f"{tmp_path}/ckpt"
    inject.activate(inject.FaultPlan(truncate_after_save_step=8))
    loop.fit(cfg, data, None, checkpoint_dir=ckdir, device="cpu")
    inject.deactivate()
    cfg.train.resume = True
    ev = Events()
    with pytest.raises(CheckpointCorrupt, match="step_8"):
        loop.fit(cfg, data, None, checkpoint_dir=ckdir, device="cpu", log=ev)
    assert ev.of("fault") == [] and ev.of("resume") == []
    # An intact newest step resumes as with verification on.
    shutil.rmtree(f"{ckdir}/step_8")
    res = loop.fit(cfg, data, None, checkpoint_dir=ckdir, device="cpu", log=ev)
    assert ev.of("resume")[0]["step"] == 4 and res.state.step == 8


def test_nan_loss_rolls_back_with_reduced_lr(tmp_path, data):
    cfg = _mk_cfg(tmp_path, "train.num_epochs=2")
    assert cfg.train.auto_resume_retries == 0   # divergence has its OWN budget
    ev = Events()
    inject.activate(inject.FaultPlan(nan_loss_at_epoch=1))
    res = loop.fit_with_recovery(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt",
                                 device="cpu", log=ev)
    assert res.state.step == 8 and res.history[-1]["epoch"] == 1
    assert math.isfinite(res.history[-1]["train_loss"])
    faults = ev.of("fault")
    assert [f["fault"] for f in faults] == ["divergence"]
    assert faults[0]["epoch"] == 1 and faults[0]["step"] == 8 and faults[0]["loss"] == "nan"
    rec = ev.of("recovery")[0]
    assert rec["cause"] == "divergence" and rec["resume_step"] == 4
    assert rec["lr"] == pytest.approx(cfg.optim.lr * cfg.resilience.nan_lr_factor)
    # Bitwise what a resume by hand from epoch 0's checkpoint at half the LR gives.
    by_hand = f"{tmp_path}/by_hand"
    os.makedirs(by_hand)
    shutil.copytree(f"{tmp_path}/ckpt/step_4", f"{by_hand}/step_4")
    hcfg = _mk_cfg(tmp_path, "train.num_epochs=2", "optim.lr=0.05", "train.resume=true")
    want = loop.fit(hcfg, data, None, checkpoint_dir=by_hand, device="cpu")
    assert _states_equal(res.state, want.state)


def test_nan_loss_budget_exhausted_refuses(tmp_path, data):
    cfg = _mk_cfg(tmp_path, "resilience.nan_retry_budget=0")
    ev = Events()
    inject.activate(inject.FaultPlan(nan_loss_at_epoch=0))
    with pytest.raises(DivergenceError, match="non-finite train loss"):
        loop.fit_with_recovery(cfg, data, None, checkpoint_dir=f"{tmp_path}/ckpt",
                               device="cpu", log=ev)
    assert [f["fault"] for f in ev.of("fault")] == ["divergence"]
    # Detected before the save: the diverged state never reached the disk.
    assert CheckpointManager(f"{tmp_path}/ckpt").all_steps() == []


def test_nan_check_off_keeps_the_nan_loss(tmp_path, data):
    cfg = _mk_cfg(tmp_path, "resilience.nan_check=false")
    inject.activate(inject.FaultPlan(nan_loss_at_epoch=0))
    res = loop.fit(cfg, data, None, device="cpu")
    assert math.isnan(res.history[0]["train_loss"])


#: Keys of a JAX event that a single-process port does not log: when and in
#: which attempt (the metrics logger's), and the elastic world sizes.
_JAX_ONLY_KEYS = ("ts", "run_id", "attempt", "world", "saved_world")


@pytest.mark.parametrize("plan", [{"nan_loss_at_epoch": 1}, {"sigterm_at_epoch_end": 0}],
                         ids=["nan_rollback", "sigterm_epoch_end"])
def test_fit_with_recovery_outcome_matches_jax(tmp_path, tiny_ds, data, plan):
    """The same tiny config and fault plan through JAX's ``fit_with_recovery``
    and the port's (resumed once when preempted): the same ``Preempted``
    fields, the same ``fault``/``recovery``/``preempted``/``resume`` records
    field by field (``lr`` after the rollback included) and the same final
    step."""
    kinds = ("fault", "recovery", "preempted", "resume")
    out = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        over = [f"obs.metrics_path={d}/metrics.jsonl"] if side == "jax" else []
        cfg = (jax_load_config if side == "jax" else load_config)(None, [
            "data.dataset=synthetic", "data.synthetic_size=256",
            "data.batch_size=64", "data.eval_batch_size=64",
            "model.arch=tiny_cnn", "optim.lr=0.1",
            "train.num_epochs=2", "train.half_precision=false",
            "train.log_every_steps=1000", "train.checkpoint_every=1",
            "score.pretrain_epochs=0", "score.batch_size=64", *over])
        ev = Events()
        if side == "jax":
            inj, exc = jax_inject, jax_preemption.Preempted
            logger = MetricsLogger(cfg.obs.metrics_path, echo=False)
            fit = lambda: jax_loop.fit_with_recovery(  # noqa: E731
                cfg, tiny_ds[0], None, checkpoint_dir=f"{d}/ckpt", logger=logger)
        else:
            inj, exc = inject, Preempted
            fit = lambda: loop.fit_with_recovery(  # noqa: E731
                cfg, data, None, checkpoint_dir=f"{d}/ckpt", device="cpu", log=ev)
        inj.activate(inj.FaultPlan(**plan))
        preempted = None
        try:
            res = fit()
        except exc as p:
            preempted = (p.signame, p.step, p.epoch, p.durable_step, str(p))
            inj.deactivate()
            cfg.train.resume = True
            res = fit()
        inj.deactivate()
        if side == "jax":
            with open(cfg.obs.metrics_path) as fh:
                records = [json.loads(line) for line in fh if line.strip()]
        else:
            records = ev.records
        records = [{k: v for k, v in e.items() if k not in _JAX_ONLY_KEYS}
                   for e in records if e["kind"] in kinds]
        out[side] = (preempted, records, int(res.state.step))
    assert out["torch"] == out["jax"]
    preempted, records, step = out["torch"]
    assert step == 8 and [e["kind"] for e in records] == (
        ["fault", "recovery", "resume"] if preempted is None else ["preempted", "resume"])


def test_resilience_config_loads_and_validates():
    cfg = load_config(None, ["resilience.step_timeout_s=2.5",
                             "resilience.nan_retry_budget=3",
                             "resilience.preemption=false",
                             "resilience.consensus_poll_steps=4",
                             "train.auto_resume_retries=2"])
    assert cfg.resilience.step_timeout_s == 2.5 and cfg.resilience.nan_retry_budget == 3
    assert cfg.resilience.preemption is False and cfg.train.auto_resume_retries == 2
    for bad, match in (("resilience.nan_lr_factor=0", "nan_lr_factor"),
                       ("resilience.step_timeout_s=-1", "step_timeout_s"),
                       ("resilience.consensus_grace_s=0", "consensus_grace_s"),
                       ("resilience.probe_attempts=0", "probe")):
        with pytest.raises(ValueError, match=match):
            load_config(None, [bad])
    with pytest.raises(KeyError):
        load_config(None, ["resilience.no_such_key=1"])
