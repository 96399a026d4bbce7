"""PyTorch port: ``fit`` and train-mode scores against the JAX package.

The JAX ``fit`` runs per step (``train.chunk_steps=0``) from JAX's own init,
handed to the port's ``fit`` by replacing the port's init; fp32 on the CPU,
tolerances stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_diet_distributed_tpu.ops import scores as flax_scores
from data_diet_distributed_tpu.train import loop as flax_loop
from data_diet_distributed_tpu.train import state as flax_state
from data_diet_distributed_tpu_torch.ops.scores import (make_local_scores,
                                                        resolve_score_method)
from data_diet_distributed_tpu_torch.train import loop, state as state_mod
from data_diet_distributed_tpu_torch.weights import variables_to
from test_torch_models import ported
from test_torch_train import BASE, assert_variables_close, both_cfgs, to_port


@pytest.fixture(scope="module")
def jax_fit_two_epochs():
    """JAX ``fit`` of tiny_cnn for 2 epochs on 200 synthetic examples (batch
    64: three full batches and a padded tail of 8), per step, and its init."""
    jcfg, _ = both_cfgs([*BASE, "train.num_epochs=2"])
    train_ds, test_ds = flax_loop.load_data_for(jcfg)
    init = flax_state.create_train_state(jcfg, jax.random.key(jcfg.train.seed), 4)
    res = flax_loop.fit(jcfg, train_ds, test_ds)
    return to_port(init), res


def _port_fit_from(monkeypatch, init: dict, over=()):
    monkeypatch.setattr(state_mod, "init_variables",
                        lambda arch, seed, device=None, **kw: variables_to(init, device))
    _, cfg = both_cfgs([*BASE, "train.num_epochs=2", *over])
    train_ds, test_ds = loop.load_data_for(cfg)
    return loop.fit(cfg, train_ds, test_ds, device="cpu")


def test_fit_two_epochs_matches_jax(monkeypatch, jax_fit_two_epochs):
    init, want = jax_fit_two_epochs
    got = _port_fit_from(monkeypatch, init)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=1e-4)
        assert g["test_accuracy"] == w["test_accuracy"]
        assert g["train_accuracy"] == w["train_accuracy"]
    assert got.state.step == int(want.state.step) == 8
    assert_variables_close(got.state.variables, to_port(want.state), rtol=1e-4,
                           atol=1e-6)
    summary = got.throughput_summary()
    assert summary["epochs"] == 2 and summary["epoch_s"]["count"] == 1
    assert summary["final_test_accuracy"] == want.final_test_accuracy


def test_fit_resident_equals_host_batches(monkeypatch, jax_fit_two_epochs):
    init, _ = jax_fit_two_epochs
    a = _port_fit_from(monkeypatch, init, ["train.device_resident_data=true"])
    b = _port_fit_from(monkeypatch, init, ["train.device_resident_data=false"])
    assert [h["train_loss"] for h in a.history] == [h["train_loss"] for h in b.history]
    for k, v in a.state.variables.items():
        assert torch.equal(v, b.state.variables[k]), k


def test_fit_is_deterministic_on_cpu():
    _, cfg = both_cfgs([*BASE, "train.num_epochs=1", "data.augment=true"])
    train_ds, _ = loop.load_data_for(cfg)
    runs = [loop.fit(cfg, train_ds, None, device="cpu", seed=5) for _ in range(2)]
    for k, v in runs[0].state.variables.items():
        assert torch.equal(v, runs[1].state.variables[k]), k
    for k, v in runs[0].state.momentum.items():
        assert torch.equal(v, runs[1].state.momentum[k]), k
    other = loop.fit(cfg, train_ds, None, device="cpu", seed=6)
    assert not torch.equal(other.state.params["classifier.weight"],
                           runs[0].state.params["classifier.weight"])


@pytest.mark.parametrize("method", ["el2n", "grand", "grand_last_layer"])
def test_train_mode_scores_match_jax(method):
    """``score.eval_mode=false``: BatchNorm on the scoring batch's statistics
    (padded rows included); ``grand`` resolves to ``grand_vmap``, one
    example per BatchNorm. rtol 1e-4; the seed variables stay unwritten."""
    fm, tree, tm, variables, x, y = ported("tiny", 12, seed=2)
    mask = np.ones(12, np.float32)
    mask[9:] = 0.0
    resolved = resolve_score_method(method, False)
    assert resolved == ("grand_vmap" if method == "grand" else method)
    jfn = jax.jit(flax_scores.make_local_scores(fm, resolved, chunk=4, eval_mode=False,
                                                use_pallas=False))
    want = np.asarray(jfn(tree, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    before = {k: v.clone() for k, v in variables.items()}
    fn = make_local_scores(tm, resolved, chunk=4, eval_mode=False, use_kernels=True)
    got = fn(variables, torch.from_numpy(x), torch.from_numpy(y),
             torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert (got[9:] == 0).all() and (got[:9] > 0).all()
    for k, v in before.items():
        assert torch.equal(variables[k], v), k
