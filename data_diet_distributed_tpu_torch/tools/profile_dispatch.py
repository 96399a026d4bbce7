"""Per-dispatch overhead of the chunked engines, by difference quotient.

The port's copy of ``tools/profile_dispatch.py``: the same arguments and
output lines, run without JAX::

    python -m data_diet_distributed_tpu_torch.tools.profile_dispatch [--task train|score]
        [--arch resnet18] [--batch 1024] [--method grand] [--k-long 16] [--frac 0.05]

The chunked engines (``train/steps.py::make_train_chunk`` for training,
``ops/scores.py::make_score_chunk`` through
``ops/scoring.py::score_resident_pass`` for scoring) run K steps as one
dispatch, on the card one CUDA-graph replay. This tool MEASURES what a
dispatch costs through those chunk programs themselves: one dispatch of a
K-step chunk costs ``t(K) = overhead + K * t_step``, so two chunk lengths give
both unknowns without trusting a host-side timer around a single op::

    t_step   = (t(K_long) - t(1)) / (K_long - 1)     # dispatch tax cancels
    overhead = t(1) - t_step

From those ``recommend`` derives the chunk size at which the dispatch tax
drops below ``--frac`` of compute, clamped to the engine's limit
(``MAX_SCORE_CHUNK_STEPS``, ``MAX_CHUNK_STEPS``): the measurement behind
``train/loop.py::DEFAULT_CHUNK_STEPS`` and ``score.chunk_steps`` on the card.
Each ``t(K)`` is the median of ``--reps`` dispatches, each ended by
``torch.cuda.synchronize`` (the score chunk's stacked fetch on the CPU);
both program lengths are built and captured before the timing.

Runs on ``--device cuda`` (default; without a card it exits non-zero) or
``--device cpu``, where the numbers describe CPU execution, useful only for
relative sanity. ``--nproc > 1`` and ``--sharded-update`` refuse: the port
runs W > 1 per step (``train/loop.py::resolve_chunk_steps``), so there is
no chunk across ranks to profile yet.
"""

from __future__ import annotations

import argparse
import math
import statistics
import time

import numpy as np

#: Why ``--nproc > 1`` and ``--sharded-update`` refuse.
NO_RANK_CHUNK = ("--nproc > 1 / --sharded-update: the port runs W > 1 per step "
                 "(train/loop.py::resolve_chunk_steps), so there is no chunk "
                 "across ranks to profile yet")


def recommend(t1: float, tl: float, k_long: int, frac: float,
              clamp: int) -> dict:
    """The difference quotient of one dispatch of 1 and of ``k_long`` steps
    (seconds): ``t_step``, ``overhead`` and the recommended chunk (None when
    the overhead or the step is within noise, <= 0), at least 1 and at most
    ``clamp``."""
    t_step = (tl - t1) / (k_long - 1)
    overhead = t1 - t_step
    rec = None
    if overhead > 0 and t_step > 0:
        rec = max(1, min(math.ceil(overhead / (frac * t_step)), clamp))
    return {"t_step": t_step, "overhead": overhead, "recommended": rec}


def report(args, label: str, unit_name: str, t1: float, tl: float,
           batch: int, clamp: int, platform: str) -> dict:
    """Print the JAX tool's lines (``recommended <label> >= N`` is what the
    autotuner parses) and return ``recommend``'s dict with ``t1`` and ``tl``."""
    r = recommend(t1, tl, args.k_long, args.frac, clamp)
    t_step, overhead = r["t_step"], r["overhead"]
    plural = "es" if unit_name.endswith("ch") else "s"
    print(f"task={args.task} arch={args.arch} batch={batch} "
          f"devices=1 ({platform})")
    print(f"t(1)        = {t1 * 1e3:8.2f} ms   (one dispatch, one {unit_name})")
    print(f"t({args.k_long:<2})       = {tl * 1e3:8.2f} ms   "
          f"(one dispatch, {args.k_long} {unit_name}{plural})")
    print(f"per-{unit_name:<7} = {t_step * 1e3:8.2f} ms   "
          f"({batch / max(t_step, 1e-9):9.0f} ex/s device-side)")
    print(f"per-dispatch overhead = {overhead * 1e3:.2f} ms "
          f"({100 * overhead / max(t1, 1e-9):.0f}% of a single-{unit_name} "
          "dispatch)")
    if r["recommended"] is None:
        print(f"overhead within measurement noise — chunking buys nothing "
              f"here; {label}=1 is fine")
    else:
        print(f"recommended {label} >= {r['recommended']} "
              f"(dispatch tax <= {args.frac:.0%} of compute; clamp {clamp})")
    return {"t1": t1, "tl": tl, **r}


def _timed(dispatch, k_long: int, reps: int) -> tuple[float, float]:
    """``t(1)`` and ``t(k_long)``: both lengths run once (build, capture),
    then the median of ``reps`` dispatches each, interleaved."""
    for k in (1, k_long):
        dispatch(k)
    t1, tl = [], []
    for _ in range(reps):
        t1.append(dispatch(1))
        tl.append(dispatch(k_long))
    return statistics.median(t1), statistics.median(tl)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_train(args, device) -> dict:
    """One replay of the train chunk (``make_train_chunk`` over the resident
    set) at K = 1 and K = ``--k-long``; the chunk's metrics come back on the
    device and the synchronize is the barrier."""
    import torch

    from ..config import load_config
    from ..data.datasets import load_dataset
    from ..data.pipeline import ResidentBatches
    from ..models import create_model_from_cfg
    from ..train.loop import MAX_CHUNK_STEPS
    from ..train.state import create_train_state, make_optimizer
    from ..train.steps import chunk_inputs, dispatch_train_chunk, make_train_chunk

    size = args.size or args.batch
    cfg = load_config(None, [
        "data.dataset=synthetic", f"data.synthetic_size={size}",
        f"data.batch_size={args.batch}", f"model.arch={args.arch}",
        f"train.half_precision={'false' if args.no_half else 'true'}",
        "train.log_every_steps=100000"])
    train_ds, _ = load_dataset("synthetic", synthetic_size=size, seed=0)
    model = create_model_from_cfg(cfg).to(device)
    state = create_train_state(cfg, 0, device, model)
    sgd = make_optimizer(cfg, steps_per_epoch=1)
    resident = ResidentBatches(train_ds, args.batch, device,
                               torch.float32 if args.no_half else torch.bfloat16)
    programs = {k: make_train_chunk(model, sgd, state, resident, k)
                for k in (1, args.k_long)}

    def dispatch(k: int) -> float:
        idx = (np.arange(k * args.batch) % len(train_ds)).reshape(k, args.batch)
        host = chunk_inputs(sgd, state.step, idx, np.ones((k, args.batch), np.float32),
                            None)
        _sync(device)
        t0 = time.perf_counter()
        dispatch_train_chunk(programs[k], state, host)
        _sync(device)
        return time.perf_counter() - t0

    try:
        t1, tl = _timed(dispatch, args.k_long, args.reps)
    finally:
        for prog in programs.values():
            prog.release()
    return report(args, "train.chunk_steps", "step", t1, tl, args.batch,
                  MAX_CHUNK_STEPS, device.type)


class _Prefix:
    """The first ``k`` batches of a ``ScoreResident`` as a block feed: one
    block of ``k`` for ``score_resident_pass``."""

    def __init__(self, resident, k: int):
        self.resident, self.k = resident, k
        self.n = k * resident.batch_size

    def blocks(self, k_chunk: int):
        r, k = self.resident, self.k
        yield r.images[:k], r.labels[:k], r.mask[:k]


def profile_score(args, device) -> dict:
    """The same difference quotient through the production SCORE chunk: one
    ``score_resident_pass`` over K resident batches is one dispatch (a
    ``make_score_chunk`` replay on the card) and one fetch of the stacked
    scores."""
    from ..data.datasets import load_dataset
    from ..device import set_scoring_determinism
    from ..graphs import GraphCache
    from ..models import create_model
    from ..ops.scores import (make_local_scores, make_warmup_scores,
                              resolve_score_method)
    from ..ops.scoring import (MAX_SCORE_CHUNK_STEPS, ScoreChunks, ScoreResident,
                               score_resident_pass)
    from ..weights import init_variables

    size = args.size or args.k_long * args.batch
    train_ds, _ = load_dataset("synthetic", synthetic_size=size, seed=0)
    if device.type == "cuda":
        set_scoring_determinism()
    model = create_model(args.arch, train_ds.num_classes,
                         half_precision=not args.no_half).to(device).eval()
    variables = init_variables(args.arch, 0, device, num_classes=train_ds.num_classes)
    resident = ScoreResident(train_ds, args.batch, device)
    if resident.nb < args.k_long:
        # A short long-dispatch silently corrupts the difference quotient
        # (t(K) would really be t(nb) while the divisor stays K-1).
        raise SystemExit(
            f"--size {size} gives only {resident.nb} batches at batch "
            f"{args.batch}; the difference quotient needs >= --k-long "
            f"({args.k_long}) — raise --size or lower --k-long")
    method = resolve_score_method(args.method, True)
    local = make_local_scores(model, method, chunk=args.grand_chunk, use_kernels=True)
    graphs = GraphCache()
    chunks = ScoreChunks(local, graphs, device, method, warm_scores=make_warmup_scores(
        model, method, chunk=args.grand_chunk), harvest=False)

    def dispatch(k: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        score_resident_pass(chunks, _Prefix(resident, k), variables, k)
        return time.perf_counter() - t0   # the fetch is the barrier

    try:
        t1, tl = _timed(dispatch, args.k_long, args.reps)
    finally:
        graphs.release()
    return report(args, "score.chunk_steps", "batch", t1, tl, args.batch,
                  MAX_SCORE_CHUNK_STEPS, device.type)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="train", choices=["train", "score"],
                    help="which chunk program to profile: the train chunk "
                         "(default) or the score chunk")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--method", default="grand",
                    help="score task: scoring method (grand | el2n | ...)")
    ap.add_argument("--grand-chunk", type=int, default=64,
                    help="score task: vmap(grad) chunk for grand_vmap")
    ap.add_argument("--size", type=int, default=None,
                    help="synthetic dataset size (default: --batch for "
                         "train, k_long*batch for score)")
    ap.add_argument("--k-long", type=int, default=16,
                    help="long chunk length for the difference quotient")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions (the median is reported)")
    ap.add_argument("--frac", type=float, default=0.05,
                    help="target dispatch-tax fraction for the recommended "
                         "chunk size")
    ap.add_argument("--no-half", action="store_true",
                    help="fp32 compute (CPU-lane runs)")
    ap.add_argument("--nproc", type=int, default=1,
                    help="refused above 1: the port has no chunk across ranks")
    ap.add_argument("--sharded-update", action="store_true",
                    help="refused: the port has no chunk across ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Profile one task; returns ``report``'s dict (also printed)."""
    args = build_parser().parse_args(argv)
    if args.k_long < 2:
        raise SystemExit("--k-long must be >= 2 for a difference quotient")
    if args.nproc > 1 or args.sharded_update:
        raise SystemExit(NO_RANK_CHUNK)
    from ..device import resolve_device
    from .autotune import device_error
    err = device_error(args.device)
    if err:
        raise SystemExit(f"[profile_dispatch] {err}")
    device = resolve_device(args.device)
    return (profile_score if args.task == "score" else profile_train)(args, device)


if __name__ == "__main__":
    main()
