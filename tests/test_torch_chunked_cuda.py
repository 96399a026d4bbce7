"""PyTorch port: the chunk programs as CUDA graphs, on the card only (marked
``cuda``; each skips here, where there is none). A train chunk's replays
against the same steps run eagerly, and a score chunk's replay against the
per-batch calls, bitwise; the kernels a score capture records count at each
replay. Imports no JAX, so it runs on the card's machine:
``pytest --noconftest -m cuda tests/test_torch_chunked_cuda.py``."""

import numpy as np
import pytest
import torch

from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.data.pipeline import ResidentBatches
from data_diet_distributed_tpu_torch.device import set_scoring_determinism
from data_diet_distributed_tpu_torch.graphs import GraphCache
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.ops import kernels
from data_diet_distributed_tpu_torch.ops.scores import make_local_scores, make_warmup_scores
from data_diet_distributed_tpu_torch.ops.scoring import ScoreChunks, ScoreResident
from data_diet_distributed_tpu_torch.train.state import create_train_state, make_optimizer
from data_diet_distributed_tpu_torch.train.steps import (chunk_inputs, dispatch_train_chunk,
                                                         make_train_chunk, train_step)
from data_diet_distributed_tpu_torch.weights import init_variables


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a chunk is a CUDA graph there")
    set_scoring_determinism()
    return torch.device("cuda")


def _cfg():
    return load_config(None, ["data.dataset=synthetic", "data.synthetic_size=640",
                              "data.batch_size=64", "model.arch=resnet18",
                              "train.half_precision=true", "data.augment=true"])


@pytest.mark.cuda
def test_train_chunk_replays_bitwise_the_eager_steps(cuda):
    """Two replays of a 4-step chunk (a capture, then a replay) leave the
    state the eager per-step path leaves after the same 8 steps, bit for bit,
    with the same stacked metrics."""
    cfg = _cfg()
    ds, _ = load_dataset("synthetic", synthetic_size=640, seed=0)
    resident = ResidentBatches(ds, 64, cuda, torch.bfloat16)
    augment = (cfg.data.crop_pad, cfg.data.flip, cfg.train.seed)
    states, metrics = [], []
    for engine in ("graph", "eager"):
        model = create_model_from_cfg(cfg).to(cuda)
        state = create_train_state(cfg, 0, cuda, model)
        sgd = make_optimizer(cfg, 10)
        out = []
        blocks = list(resident.chunk_indices(4, shuffle=True, seed=0, epoch=0))[:2]
        if engine == "graph":
            prog = make_train_chunk(model, sgd, state, resident, 4, augment)
            for idx, mask in blocks:
                out.append(dispatch_train_chunk(prog, state,
                                                chunk_inputs(sgd, state.step, idx, mask,
                                                             augment))["loss"])
            assert prog.replays == 2 and state.step == 8
        else:
            batches = list(resident(shuffle=True, seed=0, epoch=0))[:8]
            out = [torch.stack([train_step(model, sgd, state, b, augment)["loss"].float()
                                for b in batches[j:j + 4]]) for j in (0, 4)]
        states.append(state)
        metrics.append(torch.cat(out))
    assert torch.equal(metrics[0], metrics[1])
    for group in ("params", "batch_stats", "momentum"):
        for k, v in getattr(states[0], group).items():
            assert torch.equal(v, getattr(states[1], group)[k]), (group, k)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["grand_batched", "el2n"])
def test_score_chunk_replay_bitwise_per_batch(cuda, method):
    """A score chunk of 4 batches, replayed for two seeds, bitwise the
    per-batch calls; its launches count at each replay, as many as the
    per-batch calls launch."""
    cfg = _cfg()
    ds, _ = load_dataset("synthetic", synthetic_size=256, seed=0)
    model = create_model_from_cfg(cfg).to(cuda).eval()
    local = make_local_scores(model, method, use_kernels=True)
    chunks = ScoreChunks(local, GraphCache(), cuda, method,
                         warm_scores=make_warmup_scores(model, method))
    resident = ScoreResident(ds, 64, cuda)
    seeds = [init_variables("resnet18", s, cuda) for s in (0, 1)]
    kernels.reset_launch_counts()
    want = [torch.stack([local(v, resident.images[i], resident.labels[i], resident.mask[i])
                         for i in range(resident.nb)]) for v in seeds]
    per_batch = kernels.launch_counts()
    kernels.reset_launch_counts()
    got = [chunks.dispatch(v, resident.images, resident.labels, resident.mask) for v in seeds]
    assert kernels.launch_counts() == per_batch and sum(per_batch.values()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
