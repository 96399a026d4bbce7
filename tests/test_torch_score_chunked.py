"""PyTorch port: the chunked score engine (``score.chunk_steps``;
``ops/scores.py::make_score_chunk``), case by case after the JAX package's
``tests/test_score_chunked.py``.

A chunked ``score_dataset`` returns scores bitwise the per-batch pass's for
every method of the registry, per-seed partials included, in one dispatch a
seed on the auto sizing; its policy and its blocks are the JAX package's; and
its scores agree with the JAX package's ``score_dataset`` (EL2N rtol 1e-5,
GraNd 2e-4, atol 1e-6, as the port's other score comparisons). The serving
engine answers through the same chunks, bitwise the offline pass.
"""

import jax
import numpy as np
import pytest

from data_diet_distributed_tpu.config import load_config as flax_load_config
from data_diet_distributed_tpu.data.datasets import load_dataset as flax_load_dataset
from data_diet_distributed_tpu.models import create_model as flax_create_model
from data_diet_distributed_tpu.ops import scoring as flax_scoring
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.data.pipeline import iterate_batches
from data_diet_distributed_tpu_torch.graphs import GraphCache
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.ops import scoring as scoring_mod
from data_diet_distributed_tpu_torch.ops.scoring import (MAX_SCORE_CHUNK_STEPS, ScoreResident,
                                                         ScoreStream, resolve_score_chunk_steps,
                                                         score_dataset)
from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
from data_diet_distributed_tpu_torch.weights import params_from_flax
from test_torch_models import numpy_tree
from torch_threads import one_intra_op_thread  # noqa: F401

METHODS = ["el2n", "grand", "grand_last_layer", "margin", "grand_vmap"]


@pytest.fixture(scope="module")
def scoring_setup():
    """100 examples (a padded tail at batch 32), tiny_cnn and two seeds from
    the JAX init, in both packages."""
    jds, _ = flax_load_dataset("synthetic", synthetic_size=100, seed=0)
    ds, _ = load_dataset("synthetic", synthetic_size=100, seed=0)
    fm = flax_create_model("tiny_cnn", jds.num_classes)
    init = jax.jit(fm.init, static_argnames=("train",))
    trees = [init(jax.random.key(s), np.zeros((1, *jds.images.shape[1:]), np.float32),
                  train=False) for s in range(2)]
    seeds = [params_from_flax(numpy_tree(t)) for t in trees]
    return ds, create_model("tiny_cnn", ds.num_classes), seeds, (jds, fm, trees)


# ------------------------------------------------------------ bit-exactness


@pytest.mark.parametrize("method", METHODS)
def test_chunked_scores_bit_identical(method, scoring_setup):
    """K=3 over 4 batches (a chunk of 3 and a tail of 1), the auto size (the
    whole epoch in one dispatch) and the streamed blocks against per batch:
    the float32 vectors equal to the bit, for every registry method."""
    ds, model, seeds, _ = scoring_setup
    kw = dict(method=method, batch_size=32, chunk=4, device="cpu")
    per_batch = score_dataset(model, seeds, ds, chunk_steps=0, **kw)
    chunked = score_dataset(model, seeds, ds, chunk_steps=3, **kw)
    auto = score_dataset(model, seeds, ds, chunk_steps=None, **kw)
    stream = score_dataset(model, seeds, ds, chunk_steps=3, data_plane="streaming", **kw)
    for got in (chunked, auto, stream):
        np.testing.assert_array_equal(per_batch, got)
    assert per_batch.dtype == np.float32 and per_batch.shape == (100,)
    assert (per_batch != 0).any()


@pytest.mark.parametrize("method,rtol", [("el2n", 1e-5), ("grand", 2e-4),
                                         ("grand_last_layer", 1e-5)])
def test_chunked_scores_match_jax(method, rtol, scoring_setup):
    """The chunked pass against the JAX package's ``score_dataset`` on the
    same init and data (EL2N rtol 1e-5, GraNd 2e-4, atol 1e-6)."""
    ds, model, seeds, (jds, fm, trees) = scoring_setup
    got = score_dataset(model, seeds, ds, method=method, batch_size=32, device="cpu",
                        chunk_steps=None)
    want = flax_scoring.score_dataset(fm, trees, jds, method=method, batch_size=32,
                                      chunk_steps=0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


def test_chunked_seed_partials_bit_identical(scoring_setup):
    """``on_seed_done`` gets the same float64 per-seed vectors from either
    engine: the stage-resume partials do not depend on the engine."""
    ds, model, seeds, _ = scoring_setup

    def collect(chunk_steps):
        got = {}
        score_dataset(model, seeds, ds, method="el2n", batch_size=32, device="cpu",
                      chunk_steps=chunk_steps,
                      on_seed_done=lambda k, v: got.__setitem__(k, v.copy()))
        return got

    per_batch, chunked = collect(0), collect(None)
    assert set(per_batch) == set(chunked) == {0, 1}
    for k in per_batch:
        assert per_batch[k].dtype == np.float64
        np.testing.assert_array_equal(per_batch[k], chunked[k])


def test_chunked_one_dispatch_per_seed(scoring_setup, monkeypatch):
    """Auto chunking collapses the 4-batch epoch to ONE dispatch a seed; K=3
    gives a chunk and a tail a seed; one program per block length."""
    ds, model, seeds, _ = scoring_setup
    calls = []
    real = scoring_mod._dispatch_score_chunk

    def counting(program, variables, images, *args):
        calls.append(images.shape[0])
        return real(program, variables, images, *args)

    monkeypatch.setattr(scoring_mod, "_dispatch_score_chunk", counting)
    score_dataset(model, seeds, ds, method="el2n", batch_size=32, device="cpu",
                  chunk_steps=None)
    assert calls == [4, 4]
    calls.clear()
    graphs = GraphCache()
    score_dataset(model, seeds, ds, method="el2n", batch_size=32, device="cpu",
                  chunk_steps=3, graphs=graphs)
    assert calls == [3, 1, 3, 1]
    assert sorted((p["k"], p["dispatches"]) for p in graphs.stats()) == [(1, 2), (3, 2)]


def test_per_batch_engine_never_dispatches_a_chunk(scoring_setup, monkeypatch):
    """``score.chunk_steps`` 0 or 1 keeps the per-batch engine (the JAX
    package's caller-supplied step pins the same: no chunk runs)."""
    ds, model, seeds, _ = scoring_setup
    monkeypatch.setattr(scoring_mod, "_dispatch_score_chunk",
                        lambda *a: pytest.fail("the chunked engine ran"))
    for k in (0, 1):
        scores = score_dataset(model, seeds, ds, method="el2n", batch_size=32,
                               device="cpu", chunk_steps=k)
        assert scores.shape == (100,)


# ------------------------------------------------- selection / block layout


@pytest.mark.parametrize("chunk_steps", [None, 0, 1, 3, 4, 8, 100])
def test_resolve_score_chunk_steps_equals_jax(chunk_steps):
    for n_batches in (1, 4, 32, 1000):
        for resident in (True, False):
            assert (resolve_score_chunk_steps(chunk_steps, n_batches, resident)
                    == flax_scoring.resolve_score_chunk_steps(chunk_steps, n_batches,
                                                              resident))
    assert MAX_SCORE_CHUNK_STEPS == flax_scoring.MAX_SCORE_CHUNK_STEPS


@pytest.mark.parametrize("feed", ["resident", "stream"])
def test_score_blocks_equal_jax(feed):
    """``ScoreResident.blocks`` and ``ScoreStream.blocks`` hold the JAX
    package's ``ScoreResident`` blocks exactly: dataset order, row-0 tail
    images, zeroed labels, mask 0, the remainder block."""
    ds, _ = load_dataset("synthetic", synthetic_size=100, seed=0)
    jds, _ = flax_load_dataset("synthetic", synthetic_size=100, seed=0)
    port = (ScoreResident(ds, 32, "cpu") if feed == "resident"
            else ScoreStream(ds, 32, "cpu", prefetch_depth=1))
    want = list(flax_scoring.ScoreResident(jds, 32).blocks(3))
    got = list(port.blocks(3))
    assert [g[0].shape[0] for g in got] == [3, 1]
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    batches = list(iterate_batches(ds, 32))
    np.testing.assert_array_equal(got[1][0][0].numpy(), batches[3]["image"])


def test_score_chunk_steps_config_validation():
    with pytest.raises(ValueError, match="score.chunk_steps"):
        load_config(None, ["score.chunk_steps=-1"])
    assert load_config(None, ["score.chunk_steps=0"]).score.chunk_steps == 0
    assert load_config(None, []).score.chunk_steps is None
    assert (flax_load_config(None, []).score.chunk_steps
            == load_config(None, []).score.chunk_steps)


def test_compute_scores_passes_chunk_steps(tmp_path, monkeypatch):
    """The config knob reaches ``score_dataset`` (the run's wiring)."""
    from data_diet_distributed_tpu_torch.train import loop

    seen = {}
    real = score_dataset

    def spy(*args, **kwargs):
        seen["chunk_steps"] = kwargs.get("chunk_steps", "missing")
        return real(*args, **kwargs)

    monkeypatch.setattr(loop, "score_dataset", spy)
    cfg = load_config(None, [
        "data.dataset=synthetic", "data.synthetic_size=64", "data.batch_size=32",
        "model.arch=tiny_cnn", "score.pretrain_epochs=0", "score.batch_size=32",
        "score.chunk_steps=2", f"train.checkpoint_dir={tmp_path}/ckpt"])
    train_ds, _ = loop.load_data_for(cfg)
    loop.compute_scores(cfg, train_ds, device="cpu")
    assert seen["chunk_steps"] == 2


# --------------------------------------------------------------- serving


def test_serve_engine_answers_through_the_chunks_bitwise(scoring_setup):
    """The serving engine's warm pass and its requests run the score chunks
    (a block of the resident epoch, a ``[1, B]`` block a request), bitwise the
    offline per-batch pass for the same ids; the program cache keeps its key."""
    ds, _, seeds, _ = scoring_setup
    cfg = load_config(None, ["data.dataset=synthetic", "data.synthetic_size=100",
                             "model.arch=tiny_cnn", "score.batch_size=32",
                             "score.pretrain_epochs=0", "train.half_precision=false"])
    engine = ServeEngine(cfg, device="cpu")
    engine.register_tenant("t", ds, seeds)
    offline = score_dataset(create_model("tiny_cnn", ds.num_classes), seeds, ds,
                            method="grand", batch_size=32, device="cpu", chunk_steps=0)
    np.testing.assert_array_equal(engine.full_scores("t", "grand"), offline)
    ids = [5, 17, 99]
    images, labels = engine.examples_for("t", ids)
    np.testing.assert_array_equal(engine.score_batch("t", "grand", images, labels),
                                  offline[ids])
    assert engine.last_dispatch_info["cold"] is True
    engine.score_batch("t", "grand", images, labels)
    assert engine.last_dispatch_info["cold"] is False
    assert sorted(p["k"] for p in engine._graphs.stats()) == [1, 4]
    assert set(engine.program_stats()) == {"tiny_cnn:(32, 32, 32, 3):grand"}
