"""PyTorch port: the stage-resumable pipeline (``resilience/stages.py`` and its use in
``train/loop.py``), the cases of ``tests/test_stages.py`` but the trajectory one.

A preemption at each stage boundary of ``run`` must lose at most the unit in
flight, and re-invocation must skip completed stages and reproduce an
uninterrupted run bitwise. ``StageManifest``, ``ScorePartialStore`` and the
fingerprints are held against the JAX package's on the same calls, and one
preempted-and-resumed ``run_datadiet`` on each side must leave the same stage
statuses, partials and ``stage`` events.
"""

import copy
import json
import os

import numpy as np
import pytest

from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu.resilience import inject as jax_inject
from data_diet_distributed_tpu.resilience import stages as jax_stages
from data_diet_distributed_tpu.resilience.preemption import Preempted as JaxPreempted
from data_diet_distributed_tpu.train import loop as jax_loop
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.resilience import inject, stages
from data_diet_distributed_tpu_torch.resilience.preemption import Preempted
from data_diet_distributed_tpu_torch.train.loop import (load_data_for, load_scores_npz,
                                                        pipeline_fingerprint,
                                                        run_datadiet, run_sweep,
                                                        score_fingerprint)


@pytest.fixture(autouse=True)
def _disarm_injectors():
    yield
    inject.deactivate()
    jax_inject.deactivate()


def _overrides(tmp_path, *extra):
    os.makedirs(tmp_path, exist_ok=True)
    return ["data.dataset=synthetic", "data.synthetic_size=256",
            "data.batch_size=64", "data.eval_batch_size=64",
            "model.arch=tiny_cnn", "optim.lr=0.1",
            "train.num_epochs=1", "train.half_precision=false",
            "train.log_every_steps=1000", "train.checkpoint_every=1",
            f"train.checkpoint_dir={tmp_path}/ckpt",
            f"obs.metrics_path={tmp_path}/metrics.jsonl",
            "score.pretrain_epochs=0", "score.seeds=[0,1,2,3]",
            "score.batch_size=64", "prune.sparsity=0.5", *extra]


def _mk_cfg(tmp_path, *extra):
    return load_config(None, _overrides(tmp_path, *extra))


class Events:
    """A ``log`` callable that keeps every record."""

    def __init__(self):
        self.records = []

    def __call__(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def of(self, kind):
        return [e for e in self.records if e["kind"] == kind]


def _run(cfg, ev=None, fn=run_datadiet):
    return fn(cfg, device="cpu", log=ev)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage_base")
    summary = _run(_mk_cfg(tmp))
    return summary, dict(np.load(f"{tmp}/ckpt_scores.npz"))


def test_preempt_mid_scoring_loses_at_most_one_seed(tmp_path, uninterrupted):
    base_summary, base_art = uninterrupted
    inject.activate(inject.FaultPlan(sigterm_after_seed_scores=2))
    with pytest.raises(Preempted):
        _run(_mk_cfg(tmp_path))
    inject.deactivate()
    assert sorted(os.listdir(f"{tmp_path}/ckpt_score_partials")) == \
        ["seed0.npz", "seed1.npz"]
    ev = Events()
    summary = _run(_mk_cfg(tmp_path), ev)
    resumed = ev.of("score_seeds_resumed")
    assert resumed and resumed[-1]["done"] == [0, 1] and resumed[-1]["todo"] == [2, 3]
    art = dict(np.load(f"{tmp_path}/ckpt_scores.npz"))
    np.testing.assert_array_equal(art["scores"], base_art["scores"])
    np.testing.assert_array_equal(np.sort(art["kept"]), np.sort(base_art["kept"]))
    assert summary["n_kept"] == base_summary["n_kept"]
    assert summary["final_test_accuracy"] == base_summary["final_test_accuracy"]


def test_preempt_mid_retrain_resumes_from_checkpoint(tmp_path, uninterrupted):
    _, base_art = uninterrupted
    ev = Events()
    # pretrain_epochs=0: the retrain is the pipeline's only fit.
    inject.activate(inject.FaultPlan(sigterm_at_epoch_end=0))
    with pytest.raises(Preempted) as exc_info:
        _run(_mk_cfg(tmp_path, "train.num_epochs=2"), ev)
    inject.deactivate()
    assert exc_info.value.durable_step == 2   # 128 kept / 64 per batch
    assert ev.of("stage")[-1]["stage"] == "retrain:final"
    base2 = _run(_mk_cfg(tmp_path.parent / f"{tmp_path.name}_base", "train.num_epochs=2"))
    summary = _run(_mk_cfg(tmp_path, "train.num_epochs=2"), ev)
    assert ev.of("score_seeds_resumed")[-1]["todo"] == []
    assert any(e["status"] == "resuming" and e["stage"] == "retrain:final"
               for e in ev.of("stage"))
    resumes = ev.of("resume")
    assert resumes and resumes[-1]["step"] == 2 and resumes[-1]["epoch"] == 1
    assert summary["final_test_accuracy"] == base2["final_test_accuracy"]
    np.testing.assert_array_equal(np.load(f"{tmp_path}/ckpt_scores.npz")["scores"],
                                  base_art["scores"])


def test_completed_run_skips_and_returns_recorded_summary(tmp_path):
    s1 = _run(_mk_cfg(tmp_path, "score.seeds=[0]"))
    ev = Events()
    s2 = _run(_mk_cfg(tmp_path, "score.seeds=[0]"), ev)
    assert s2["final_test_accuracy"] == s1["final_test_accuracy"]
    assert s2["n_kept"] == s1["n_kept"]
    skipped = [e for e in ev.of("stage") if e["status"] == "skipped"]
    assert skipped and skipped[-1]["stage"] == "retrain:final"
    assert not ev.of("epoch")   # nothing retrained


def test_changed_config_invalidates_stage_manifest(tmp_path):
    _run(_mk_cfg(tmp_path, "score.seeds=[0]"))
    ev = Events()
    s2 = _run(_mk_cfg(tmp_path, "score.seeds=[0]", "prune.sparsity=0.25"), ev)
    assert s2["n_kept"] == 192   # retrained at the new sparsity
    resets = [e for e in ev.of("stage") if e["status"] == "reset"]
    assert resets and resets[-1]["reason"] == "config fingerprint changed"
    # Sparsity does not change scores: the seed-0 partial was reused.
    assert ev.of("score_seeds_resumed")[-1]["done"] == [0]


def test_changed_score_recipe_invalidates_partials(tmp_path):
    _run(_mk_cfg(tmp_path, "score.seeds=[0]", "score.pretrain_epochs=1"))
    ev = Events()
    _run(_mk_cfg(tmp_path, "score.seeds=[0]", "score.pretrain_epochs=1",
                 "optim.lr=0.05"), ev)
    invalid = [e for e in ev.of("stage") if e["status"] == "invalid"]
    assert invalid and "fingerprint" in invalid[0]["error"]
    assert not [e for e in ev.of("score_seeds_resumed") if e["done"]]


def test_sweep_interrupted_at_level_resumes_remaining(tmp_path):
    over = ("prune.sweep=[0.25,0.5]", "train.num_epochs=2", "score.seeds=[0,1]")
    base = _run(_mk_cfg(tmp_path.parent / f"{tmp_path.name}_base", *over), fn=run_sweep)
    inject.activate(inject.FaultPlan(sigterm_at_epoch_end=0))
    with pytest.raises(Preempted):
        _run(_mk_cfg(tmp_path, *over), fn=run_sweep)
    inject.deactivate()
    ev = Events()
    summaries = _run(_mk_cfg(tmp_path, *over), ev, fn=run_sweep)
    assert [s["sparsity"] for s in summaries] == [0.25, 0.5]
    assert [s["n_kept"] for s in summaries] == [s["n_kept"] for s in base]
    assert [s["final_test_accuracy"] for s in summaries] == \
        [s["final_test_accuracy"] for s in base]
    assert any(e["status"] == "resuming" and e["stage"] == "retrain:final_s0p25"
               for e in ev.of("stage"))


def test_dense_run_is_a_stage_too(tmp_path):
    over = ("prune.sparsity=0.0", "train.num_epochs=2")
    base = _run(_mk_cfg(tmp_path.parent / f"{tmp_path.name}_base", *over))
    inject.activate(inject.FaultPlan(sigterm_at_epoch_end=0))
    with pytest.raises(Preempted):
        _run(_mk_cfg(tmp_path, *over))
    inject.deactivate()
    ev = Events()
    resumed = _run(_mk_cfg(tmp_path, *over), ev)
    assert [e["status"] for e in ev.of("stage") if e["stage"] == "dense:final"] == \
        ["resuming", "started", "done"]
    assert ev.of("resume")[-1]["step"] == 4
    assert resumed["final_test_accuracy"] == base["final_test_accuracy"]
    ev = Events()
    again = _run(_mk_cfg(tmp_path, *over), ev)
    assert [(e["stage"], e["status"]) for e in ev.of("stage")] == \
        [("dense:final", "skipped")]
    assert again["final_test_accuracy"] == base["final_test_accuracy"]


def test_stage_resume_off_recomputes_everything(tmp_path):
    _run(_mk_cfg(tmp_path, "score.seeds=[0]"))
    ev = Events()
    _run(_mk_cfg(tmp_path, "score.seeds=[0]", "resilience.stage_resume=false"), ev)
    assert not ev.of("stage") and not ev.of("score_seeds_resumed") and ev.of("epoch")


# ------------------------------------------------- npz hardening satellites


def test_truncated_scores_npz_detected_not_deserialized(tmp_path):
    train_ds, _ = load_data_for(_mk_cfg(tmp_path))
    path = str(tmp_path / "scores.npz")
    np.savez(path, scores=np.arange(256, dtype=np.float32), indices=np.arange(256),
             method="el2n")
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 3)
    with pytest.raises(ValueError, match="truncated or corrupt"):
        load_scores_npz(path, train_ds)
    with pytest.raises(ValueError, match="scores.npz"):
        load_scores_npz(path, train_ds)


def test_scores_npz_method_mismatch_refuses(tmp_path):
    train_ds, _ = load_data_for(_mk_cfg(tmp_path))
    path = str(tmp_path / "scores.npz")
    np.savez(path, scores=np.arange(256, dtype=np.float32), indices=np.arange(256),
             method="el2n")
    with pytest.raises(ValueError, match="score.method"):
        load_scores_npz(path, train_ds, expect_method="grand")
    assert load_scores_npz(path, train_ds, expect_method="el2n").shape == (256,)
    np.savez(path, scores=np.arange(256, dtype=np.float32), indices=np.arange(256))
    assert load_scores_npz(path, train_ds, expect_method="grand").shape == (256,)
    np.savez(path, scores=np.arange(256, dtype=np.float32), indices=np.arange(256),
             method="reused:/old.npz")
    assert load_scores_npz(path, train_ds, expect_method="grand").shape == (256,)


def test_corrupt_partial_is_recomputed(tmp_path):
    pdir = f"{tmp_path}/ckpt_score_partials"
    os.makedirs(pdir)
    with open(f"{pdir}/seed0.npz", "wb") as fh:
        fh.write(b"not a zip at all")
    ev = Events()
    summary = _run(_mk_cfg(tmp_path, "score.seeds=[0,1]"), ev)
    assert summary["n_kept"] == 128
    invalid = [e for e in ev.of("stage") if e["status"] == "invalid"]
    assert invalid and invalid[0]["stage"] == "score_seed:0"
    assert not ev.of("score_seeds_resumed")


# ------------------------------------------- the same calls on both sides


class JaxLogger:
    """The JAX package's logger interface, recording ``stage`` events as the
    port's ``log`` gets them."""

    def __init__(self):
        self.ev = Events()

    def stage(self, stage, status, **fields):
        self.ev("stage", stage=stage, status=status, **fields)


def _json_without_ts(path):
    with open(path) as fh:
        data = json.load(fh)
    for entry in data["stages"].values():
        entry.pop("ts")
    return data


def test_stage_manifest_matches_jax(tmp_path):
    def scenario(side):
        path = str(tmp_path / side / "stages.json")
        if side == "jax":
            logger = JaxLogger()
            make = lambda fp, **kw: jax_stages.StageManifest(path, fp, logger=logger, **kw)  # noqa: E731
            ev = logger.ev
        else:
            ev = Events()
            make = lambda fp, **kw: stages.StageManifest(path, fp, log=ev, **kw)  # noqa: E731
        decisions = []
        m = make("fp1")
        decisions.append(m.completed("x"))
        m.start("x", detail=1)
        decisions += [m.started("x"), m.completed("x")]
        m.complete("x", summary={"a": 1, "acc": 0.5})
        m.complete("score", method="el2n", n=256, reused_seeds=[0, 1])
        decisions.append(m.completed("x"))
        snapshot = _json_without_ts(path)
        m2 = make("fp1")
        decisions += [m2.completed("x"), m2.info("x")["summary"] == {"a": 1, "acc": 0.5}]
        decisions.append(make("fp2").completed("x"))          # fingerprint changed
        with open(path, "w") as fh:
            fh.write("{truncated")
        decisions.append(make("fp1").completed("x"))          # unreadable: reset
        m5 = make("fp1", enabled=False)
        m5.complete("y")
        decisions.append(m5.completed("y"))                   # disabled: inert
        leftovers = [n for n in os.listdir(os.path.dirname(path)) if n.endswith(".tmp")]
        events = [(e["stage"], e["status"], e.get("reason", "")[:20])
                  for e in ev.of("stage")]
        return decisions, snapshot, leftovers, events
    jax_out, port_out = scenario("jax"), scenario("torch")
    assert port_out == jax_out
    assert port_out[0] == [False, True, False, True, True, True, False, False, False]


def test_score_partial_store_matches_jax(tmp_path):
    idx = np.arange(16)
    arr = np.linspace(0, 1, 16)

    def scenario(mod, side):
        d = str(tmp_path / side)
        store = mod.ScorePartialStore(d, method="el2n", indices=idx, fingerprint="fp")
        store.save(3, arr)
        store.save(5, np.full(16, np.nan))
        store.save(6, arr[:8])
        with open(store.path(7), "wb") as fh:
            fh.write(b"garbage")
        other = {"method": mod.ScorePartialStore(d, method="grand", indices=idx,
                                                 fingerprint="fp").load(3),
                 "indices": mod.ScorePartialStore(d, method="el2n", indices=idx + 1,
                                                  fingerprint="fp").load(3),
                 "fingerprint": mod.ScorePartialStore(d, method="el2n", indices=idx,
                                                      fingerprint="other").load(3)}
        loaded = store.load_all([3, 4, 5, 6, 7])
        with np.load(store.path(3)) as f:
            saved = {k: f[k].tolist() for k in f.files}
        return ({k: v is None for k, v in other.items()},
                {k: v.tolist() for k, v in loaded.items()}, saved)
    jax_out = scenario(jax_stages, "jax")
    port_out = scenario(stages, "torch")
    assert port_out == jax_out
    assert port_out[0] == {"method": True, "indices": True, "fingerprint": True}
    assert list(port_out[1]) == [3]


FINGERPRINT_VARIANTS = [(), ("prune.sparsity=0.3",), ("score.method=grand_last_layer",),
                        ("score.seeds=[0,1]",), ("train.seed=7",), ("optim.lr=0.2",),
                        ("score.pretrain_epochs=2",), ("train.half_precision=true",),
                        ("data.synthetic_size=512",), ("prune.sweep=[0.25,0.5]",)]


@pytest.mark.parametrize("extra", FINGERPRINT_VARIANTS, ids=lambda e: e[0] if e else "base")
def test_fingerprints_equal_jax(tmp_path, extra):
    over = _overrides(tmp_path, *extra)
    jcfg, pcfg = jax_load_config(None, over), load_config(None, over)
    assert pipeline_fingerprint(pcfg) == jax_loop.pipeline_fingerprint(jcfg)
    assert score_fingerprint(pcfg) == jax_loop.score_fingerprint(jcfg)


def test_pipeline_fingerprint_tracks_compute_relevant_config(tmp_path):
    cfg = _mk_cfg(tmp_path)
    fp = pipeline_fingerprint(cfg)
    assert fp == pipeline_fingerprint(copy.deepcopy(cfg))
    for mutate in (lambda c: setattr(c.prune, "sparsity", 0.3),
                   lambda c: setattr(c.score, "method", "grand_last_layer"),
                   lambda c: setattr(c.score, "seeds", (0, 1)),
                   lambda c: setattr(c.train, "seed", 7),
                   lambda c: setattr(c.optim, "lr", 0.2)):
        c = copy.deepcopy(cfg)
        mutate(c)
        assert pipeline_fingerprint(c) != fp
    c = copy.deepcopy(cfg)
    c.train.checkpoint_every = 17   # where it logs and saves, not what it computes
    assert pipeline_fingerprint(c) == fp


def _jax_events(path, kind):
    with open(path) as fh:
        return [e for e in (json.loads(line) for line in fh if line.strip())
                if e["kind"] == kind]


def test_preempted_run_resumes_like_jax(tmp_path):
    """One tiny run on each side, preempted after the first of two seeds'
    scores, then re-invoked: the same exception, partials on disk, stage
    statuses and sequence of ``stage`` events."""
    over = ("score.seeds=[0,1]",)
    out = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        ov = _overrides(d, *over)
        ev = Events()
        if side == "jax":
            inject_mod, exc = jax_inject, JaxPreempted
            run = lambda: jax_loop.run_datadiet(jax_load_config(None, ov))  # noqa: E731
        else:
            inject_mod, exc = inject, Preempted
            run = lambda: run_datadiet(load_config(None, ov), device="cpu", log=ev)  # noqa: E731
        inject_mod.activate(inject_mod.FaultPlan(sigterm_after_seed_scores=1))
        with pytest.raises(exc):
            run()
        inject_mod.deactivate()
        first = (sorted(os.listdir(f"{d}/ckpt_score_partials")),
                 os.path.exists(f"{d}/ckpt_stages.json"))
        summary = run()
        if side == "jax":
            stage_ev = _jax_events(f"{d}/metrics.jsonl", "stage")
            resumed = _jax_events(f"{d}/metrics.jsonl", "score_seeds_resumed")
        else:
            stage_ev, resumed = ev.of("stage"), ev.of("score_seeds_resumed")
        statuses = {k: v["status"] for k, v in
                    _json_without_ts(f"{d}/ckpt_stages.json")["stages"].items()}
        out[side] = (first, [(e["stage"], e["status"]) for e in stage_ev],
                     [(e["done"], e["todo"]) for e in resumed], statuses,
                     summary["n_kept"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == (["seed0.npz"], False)
    assert out["torch"][1] == [("score", "done"), ("prune:final", "done"),
                               ("retrain:final", "started"), ("retrain:final", "done")]
