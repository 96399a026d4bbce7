"""The warm scoring engine behind serving (counterpart of
``data_diet_distributed_tpu/serve/engine.py::ServeEngine``).

``fit``, ``evaluate`` and ``score`` are composable units over the process
group's devices (one per rank) and one model: ``fit``/``evaluate`` run the
port's ``train/loop.py``, ``score`` the tenant's resident score vector. Per
registered TENANT (a named dataset + per-seed scoring variables) the engine
keeps the dense dataset rows on the host, the dataset pre-batched on the
device (``ScoreResident``) and the resident score vector per method. A
request is padded to the engine's one batch geometry ``[B]``
(``serve.batch_size``, else ``score.batch_size``) exactly as the resident
tail is (row-0 images, zeroed labels, mask 0) and runs the same per-batch
score function, so it scores bit-identical to ``full_scores`` for the same
ids (seeds averaged the same way). That rests on fixed per-example
arithmetic: deterministic cuDNN algorithm choice for one geometry and kernels
without atomics. On CUDA the engine sets ``set_scoring_determinism()``, which
is process-wide, so an ``engine.fit`` in a serving process trains with
cuDNN's deterministic algorithms too (as every port fit does); it is never
toggled per call.

In one process the engine scores as the JAX engine does, through the
chunked score engine (``ops/scoring.py``): the warm pass behind ``/v1/topk``,
``/v1/rank`` and ``full_scores`` is ``score_resident_pass`` over the
tenant's resident blocks of up to ``MAX_SCORE_CHUNK_STEPS`` batches, and a
request is a ``[1, B]`` block through the same score chunk; on the card
each is one CUDA-graph replay a seed, captured once per method and block
length (``graphs.py``). Across ranks both stay per batch, as
``resolve_score_chunk_steps`` rules.

The program cache, keyed ``(arch, request geometry, method)`` like the JAX
package's, has nothing to compile in PyTorch: an entry's ``compile_s`` is the
wall of the FIRST call at that key (the first seed's warm pass, its graph
captures included, or the first request), to the card's completion (cuDNN
plans, kernel module loads, allocator growth), kept under the JAX field names
so ``/status`` has the same shape. A dispatch that makes its key's first call,
or captures the request's ``[1, B]`` chunk, is ``cold``: its first seed's
call is its ``compile_ms`` and the other seeds' calls its ``dispatch_ms``
(until the score function returns) and ``fetch_ms`` (the ``.cpu()`` that
waits for the card). The GraNd path syncs inside the call, so there
``dispatch_ms`` holds the device time.

``refresh_tenant`` swaps a tenant's variables in one assignment under the
dispatch lock and clears its cached scores in the same critical section;
``load_checkpoint_variables`` restores exactly the named (or newest) step of
the port's ``CheckpointManager``, digest-verified, with no fallback. Thread
model: every device call (the batcher's dispatcher, handler threads' cold
``topk``/``rank`` passes, a refresh install) is serialized behind ``_lock``.
Grad mode is thread-local; the score functions set it themselves.

Across W ranks (a process group, one device a rank: the counterpart of the
JAX engine's mesh, flattened: a ``{data: D, model: M}`` group serves as W =
D x M ranks, each with the whole head) the request geometry rounds up to a
multiple of W
(``global_batch_size_for``: 15 -> 16 at W = 2) and every operation is a
collective over the host group (``parallel/collectives.py``):

* ``score_batch``: rank 0 pads the request to ``B`` as above, each rank
  receives rows ``[r·B/W, (r+1)·B/W)`` of the padded block (the rows
  ``flat_slice()`` gives ``ScoreResident``), scores them with every seed,
  and rank 0 gathers the per-seed rows and takes the float64 seed mean and
  the ``[:n]`` cut as at W = 1;
* ``full_scores``: ``score_dataset``'s W > 1 pass (``ScoreResident`` of the
  rank's rows, ``score_pass``, ``sum_float64`` per seed); every rank holds
  the vector;
* ``refresh_tenant``: every rank restores the step rank 0 names, and the new
  variables are installed on every rank only when every rank restored them
  (else each keeps the old ones and rank 0 raises: the 409);
* the stats gather of each rank's kernel launches, an idle ``tick`` and
  ``stop``.

During the boot every rank calls the same methods in the same order
(``register_tenant``, the warm ``full_scores``). Then rank 0 ``lead``s: it
announces each operation as a JSON record while it holds ``_lock``, before it
touches the device, so the peers (in ``follow``) run the operations in rank
0's one order; it also sends a ``tick`` after ``TICK_S`` idle. Every
operation ends in a reply that carries each rank's outcome and preemption
flag: an operation that failed on any rank raises ``OpFailed`` on every rank
after all of its collectives ran, so the group stays in step, and a
preempted peer sets ``preempt_agreed`` on rank 0, whose serve loop then drains
the service as for its own SIGTERM.

The group's deadline is ``resilience.consensus_grace_s``, the watchdog's
escalation deadline under consensus in ``cli train``: a rank that has waited
in one of the service's collectives for that long (a dead or wedged peer)
exits ``EXIT_RETRIABLE`` (69) from a monitor thread, and a collective that a
dead peer tears raises at once; either way the failure is the group's
(``group_error``), no later operation runs, and rank 0 never answers from a
partial group.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..config import SERVABLE_METHODS, Config
from ..data.datasets import ArrayDataset, make_position_joiner
from ..data.pipeline import pad_batch
from ..device import resolve_device, set_scoring_determinism
from ..graphs import GraphCache
from ..models import create_model_from_cfg
from ..obs import flightrec
from ..obs import heartbeat as obs_heartbeat
from ..obs import registry as obs_registry
from ..ops import kernels
from ..ops.scores import (make_local_scores, make_warmup_scores, resolve_score_method,
                          resolve_use_kernels)
from ..ops.scoring import (MAX_SCORE_CHUNK_STEPS, ScoreChunks, ScoreResident, score_pass,
                           score_resident_pass)
from ..parallel.collectives import (all_gather_host, broadcast_json, gather_json,
                                    gather_rows, scatter_rows, sum_float64)
from ..parallel.mesh import (flat_slice, global_batch_size_for, process_index,
                             sync_hosts, world_size)
from ..resilience.watchdog import EXIT_RETRIABLE
from ..train.loop import evaluate, fit, score_variables_for_seeds
from ..weights import variables_to

#: Rank 0 sends a ``tick`` after this many seconds without an operation, so a
#: peer's SIGTERM reaches it within about this long.
TICK_S = 1.0


class OpFailed(RuntimeError):
    """An operation of the service failed on at least one rank. Every
    collective of the operation ran, so the group is still in step."""


class GroupLost(RuntimeError):
    """A collective of the service failed (a peer died or the group was
    stopped): no operation runs after it."""


@dataclass
class Tenant:
    """One named dataset + scoring variables resident on the device."""

    name: str
    ds: ArrayDataset
    variables_seeds: list
    weight: int = 1
    images: np.ndarray | None = None     # dense float32 rows, host
    labels: np.ndarray | None = None
    pos_of: Any = None                   # global id -> row position joiner
    resident: ScoreResident | None = None
    scores: dict[str, np.ndarray] = field(default_factory=dict)


class ServeEngine:
    """Warm-callable ``fit`` / ``score`` / ``evaluate`` units over the group's
    devices (one device in one process).

    ``cfg`` supplies the model recipe and scoring knobs; ``device`` defaults
    to CUDA and raises without it (pass ``"cpu"`` for the CPU); ``logger`` (a
    ``MetricsLogger``) gets ``fit``'s records. Built on every rank of a
    group, at the same point (its first barrier absorbs the ranks' start-up
    skew)."""

    def __init__(self, cfg: Config, *, device=None, logger=None):
        self.cfg = cfg
        self.logger = logger
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_scoring_determinism()
        self.world, self.rank_index = world_size(), process_index()
        self.batch_size = global_batch_size_for(cfg.serve.batch_size or cfg.score.batch_size,
                                                flat=True)
        self.model = create_model_from_cfg(cfg).to(self.device)
        self.tenants: dict[str, Tenant] = {}
        self._local: dict[str, Any] = {}
        # One process: the score chunks by method, their captures in _graphs.
        self._graphs = GraphCache()
        self._chunks: dict[str, ScoreChunks] = {}
        # (arch, geometry, method) -> {"compiles", "dispatches", "compile_s"}.
        self._programs: dict[tuple, dict] = {}
        self._lock = threading.Lock()
        # Phase timing of the latest score_batch, read by the batcher's single
        # dispatcher thread right after the call.
        self.last_dispatch_info: dict | None = None
        # Each rank's kernel launches by kernel, as of the last stats gather.
        self.rank_launches: list[dict] = [kernels.launch_counts()]
        # --- the group (W > 1) ----------------------------------------------
        self.deadline_s = float(cfg.resilience.consensus_grace_s)
        self.group_error: BaseException | None = None
        self.preempt_agreed = threading.Event()
        self._local_preempt = lambda: False
        self._leading = self._stopped = False
        self._waiting_since: float | None = None
        self._last_op = time.monotonic()
        self._tick_stop = threading.Event()
        if self.world > 1:
            sync_hosts("serve-engine")
            threading.Thread(target=self._watch_deadline, daemon=True,
                             name="serve-group-deadline").start()

    # ------------------------------------------------------ composable units

    def fit(self, train_ds: ArrayDataset, test_ds: ArrayDataset | None = None, **kwargs):
        """The training unit: the port's ``train/loop.fit`` on the engine's
        device, records to the engine's logger."""
        return fit(self.cfg, train_ds, test_ds, device=self.device,
                   log=self.logger, **kwargs)

    def evaluate(self, state, ds: ArrayDataset, batch_size: int | None = None):
        """The eval unit: ``train/loop.evaluate`` of the engine's model."""
        return evaluate(self.model, state, ds, batch_size or self.cfg.data.eval_batch_size,
                        device=self.device)

    def scoring_variables(self, ds: ArrayDataset,
                          seeds: Sequence[int] | None = None) -> list:
        """Per-seed scoring variables from the config's recipe: a pretrain of
        ``score.pretrain_epochs`` epochs on ``ds`` per seed (one upload shared
        by the seeds), the checkpoint ``score.score_ckpt_step``, or the init."""
        return score_variables_for_seeds(self.cfg, ds, device=self.device,
                                         log=self.logger, seeds=seeds)

    def score(self, tenant: str, method: str | None = None) -> np.ndarray:
        """The scoring unit: the tenant's resident score vector."""
        return self.full_scores(tenant, method or self.cfg.score.method)

    # ------------------------------------------------------------- tenants

    def register_tenant(self, name: str, ds: ArrayDataset,
                        variables_seeds: Sequence | None = None, *,
                        weight: int = 1) -> Tenant:
        """Make a dataset + scoring variables resident under ``name``;
        ``variables_seeds`` None builds them from the config's recipe.
        ``weight`` is the tenant's share of the batcher's round-robin."""
        if weight < 1:
            raise ValueError(f"tenant weight must be >= 1, got {weight}")
        if variables_seeds is None:
            variables_seeds = self.scoring_variables(ds)
        dense = ds.dense()
        tenant = Tenant(name=name, ds=ds,
                        variables_seeds=[variables_to(v, self.device)
                                         for v in variables_seeds],
                        weight=weight,
                        images=np.asarray(dense.images, np.float32),
                        labels=np.asarray(dense.labels, np.int32),
                        pos_of=make_position_joiner(ds.indices))
        with self._lock:
            self.tenants[name] = tenant
        return tenant

    def load_checkpoint_variables(self, directory: str,
                                  step: int | None = None) -> tuple[dict, int]:
        """Scoring variables of checkpoint ``step`` (None = the newest) in
        ``directory``, verified against the step's manifest before anything
        is installed, with no fallback: a missing, truncated or corrupt step
        raises here while the old model keeps serving. Returns ``(variables,
        step)``. Not under ``_lock``: the restore is the slow half of a
        refresh and must not stall dispatches (the other ranks of a group
        restore inside the refresh operation, so there it does)."""
        mngr = CheckpointManager(directory, max_to_keep=self.cfg.train.keep_checkpoints)
        step = mngr.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"{directory}: no checkpoint step to refresh from")
        return mngr.restore_variables(step, self.device), step

    def refresh_tenant(self, name: str, variables_seeds: Sequence, *,
                       source: tuple[str, int] | None = None) -> None:
        """Install new scoring variables for ``name``: ONE assignment under
        ``_lock``, which every dispatch and resident pass holds for its whole
        duration, so a request is served entirely by the old or entirely by
        the new variables; the cached score vectors (the old model's) are
        cleared in the same critical section. The ``ScoreResident`` upload
        (the dataset, not the model) survives. Across ranks ``source`` names
        the checkpoint ``(directory, step)`` the variables came from: every
        other rank restores it inside the operation, and nothing is installed
        anywhere unless every rank restored it (``OpFailed``)."""
        if not variables_seeds:
            raise ValueError("refresh needs at least one variables dict")
        if self.world > 1 and source is None:
            raise ValueError("a refresh across ranks names the checkpoint "
                             "(directory, step) every rank restores")
        variables_seeds = [variables_to(v, self.device) for v in variables_seeds]
        t = self.tenant(name)
        with self._lock:
            op = {"op": "refresh", "tenant": name}
            if source is not None:
                op.update(dir=source[0], step=int(source[1]))
            self._announce(op)
            self._op_refresh(t, op, variables_seeds)

    def tenant(self, name: str) -> Tenant:
        try:
            return self.tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; registered: "
                           f"{sorted(self.tenants)}") from None

    def tenant_weight(self, name: str) -> int:
        """The batcher's fairness weight (1 for an unknown name)."""
        t = self.tenants.get(name)
        return t.weight if t is not None else 1

    def examples_for(self, tenant: str, ids) -> tuple[np.ndarray, np.ndarray]:
        """Dense float32 rows + labels for global example ids (KeyError for
        ids not in the tenant's dataset: the 400 path)."""
        t = self.tenant(tenant)
        pos = t.pos_of(np.asarray(ids, np.int64))
        return t.images[pos], t.labels[pos]

    # ------------------------------------------------------ program cache

    @staticmethod
    def _check_method(method: str) -> None:
        if method not in SERVABLE_METHODS:
            raise ValueError(f"unservable score method {method!r} "
                             f"(servable: {', '.join(SERVABLE_METHODS)})")

    def _local_scores(self, method: str):
        self._check_method(method)
        fn = self._local.get(method)
        if fn is None:
            sc = self.cfg.score
            fn = self._local[method] = make_local_scores(
                self.model, resolve_score_method(method, sc.eval_mode),
                chunk=sc.grand_chunk, eval_mode=sc.eval_mode,
                use_kernels=resolve_use_kernels(sc.use_pallas))
        return fn

    def _score_chunks(self, method: str) -> ScoreChunks:
        """The method's score chunks (one process): one capture per block
        length, for the warm pass's blocks and the requests' ``[1, B]``."""
        chunks = self._chunks.get(method)
        if chunks is None:
            sc = self.cfg.score
            plain = make_warmup_scores(self.model, resolve_score_method(method, sc.eval_mode),
                                       chunk=sc.grand_chunk, eval_mode=sc.eval_mode)
            chunks = self._chunks[method] = ScoreChunks(self._local_scores(method),
                                                        self._graphs, self.device, method,
                                                        warm_scores=plain, harvest=False)
        return chunks

    def _program_key(self, tenant: Tenant, method: str) -> tuple:
        return (self.cfg.model.arch, (self.batch_size, *tenant.images.shape[1:]), method)

    def _first_call(self, key: tuple, local):
        """``local``, timed on its first call when ``key`` has no cache entry
        yet (then the entry is created with that call's wall, to the card's
        completion, as ``compile_s``). Call with ``_lock`` held."""
        if key in self._programs:
            return local

        def timed(*args):
            if key in self._programs:   # a later batch of the same pass
                return local(*args)
            t0 = time.perf_counter()
            out = local(*args)
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            compile_s = time.perf_counter() - t0
            self._programs[key] = {"compiles": 1, "dispatches": 0,
                                   "compile_s": round(compile_s, 4)}
            obs_registry.observe("serve_compile_s", compile_s)
            return out
        return timed

    def program_stats(self) -> dict[str, dict]:
        """The cache as data for /status and serve_stats: one row per
        ``arch:geometry:method`` key."""
        with self._lock:
            return {f"{a}:{g}:{m}": dict(e) for (a, g, m), e in self._programs.items()}

    # ------------------------------------------------------------ scoring

    def score_batch(self, tenant: str, method: str, images: np.ndarray,
                    labels: np.ndarray) -> np.ndarray:
        """Score ``n <= B`` examples: ``scores[n]`` float32, bit-identical to
        ``full_scores`` for the same examples. Sets ``last_dispatch_info``
        (rank 0's: the scatter's time is in ``dispatch_ms``, the gather's in
        ``fetch_ms``)."""
        self._check_method(method)
        t = self.tenant(tenant)
        n = len(images)
        with self._lock:
            block = pad_batch(np.asarray(images, np.float32),
                              np.asarray(labels, np.int32), self.batch_size, t.images[0])
            self._announce({"op": "score", "tenant": tenant, "method": method})
            per_seed = self._op_score(t, method, list(block))
        total = np.zeros(n, np.float64)
        for scores in per_seed:
            total += scores.astype(np.float64)[:n]
        return (total / len(per_seed)).astype(np.float32)

    def _op_score(self, t: Tenant, method: str, block: list | None) -> np.ndarray | None:
        """The body of a score operation on every rank (``block``, the padded
        ``[images, labels, mask]``, on rank 0 only): the rank's rows of the
        block through every seed's score function; returns the per-seed
        scores ``[S, B]`` on rank 0, None elsewhere."""
        key = self._program_key(t, method)
        cold = key not in self._programs
        n_seeds, rows = len(t.variables_seeds), self.batch_size // self.world
        t0 = time.perf_counter()
        ops = self._collective(scatter_rows, block, rows, [
            (t.images.shape[1:], np.float32), ((), np.int32), ((), np.float32)])
        dispatch_s = time.perf_counter() - t0
        fetch_s = compile_s = 0.0
        outs, error = [], None
        try:
            local = self._local_scores(method)
            ops = [torch.from_numpy(a).to(self.device) for a in ops]
            if self.world == 1:
                # The request as a [1, B] block through the score chunk, as
                # the JAX engine dispatches it.
                chunks = self._score_chunks(method)
                ops = [o[None] for o in ops]
                cold = cold or not chunks.captured(ops[0])

                def local(variables, *blk):
                    return chunks.dispatch(variables, *blk)[0]
            for k, variables in enumerate(t.variables_seeds):
                td = time.perf_counter()
                out = (self._first_call(key, local) if k == 0 else local)(variables, *ops)
                tf = time.perf_counter()
                outs.append(out.cpu().numpy())
                now = time.perf_counter()
                if cold and k == 0:
                    compile_s = now - td
                else:
                    dispatch_s += tf - td
                    fetch_s += now - tf
            self._programs[key]["dispatches"] += n_seeds
        except Exception as exc:   # noqa: BLE001 — reported in the reply, on every rank
            error = exc
        mine = (np.stack(outs).astype(np.float32, copy=False) if error is None
                else np.zeros((n_seeds, rows), np.float32))
        tg = time.perf_counter()
        joined = self._collective(gather_rows, np.ascontiguousarray(mine.T))
        self._reply(error, "score")
        fetch_s += time.perf_counter() - tg
        obs_registry.observe("serve_dispatch_s", time.perf_counter() - t0)
        self.last_dispatch_info = {"cold": cold, "dispatch_ms": dispatch_s * 1e3,
                                   "fetch_ms": fetch_s * 1e3,
                                   "compile_ms": compile_s * 1e3}
        return None if joined is None else joined.T

    def full_scores(self, tenant: str, method: str) -> np.ndarray:
        """The tenant's whole-dataset score vector (cached), through the same
        ``score_pass`` as ``score_dataset`` (and, across ranks, its
        ``flat_slice`` rows and ``sum_float64`` join)."""
        self._check_method(method)
        t = self.tenant(tenant)
        cached = t.scores.get(method)
        if cached is not None:
            return cached
        with self._lock:
            cached = t.scores.get(method)   # double-checked under the lock
            if cached is not None:
                return cached
            self._announce({"op": "full", "tenant": tenant, "method": method})
            return self._op_full(t, method)

    def _op_full(self, t: Tenant, method: str) -> np.ndarray:
        """The body of a whole-dataset pass on every rank; every rank caches
        and returns the same vector."""
        t0 = time.perf_counter()
        error = None
        try:
            local = self._local_scores(method)
            if t.resident is None:
                t.resident = ScoreResident(t.ds, self.batch_size, self.device, flat_slice())
            key = self._program_key(t, method)
        except Exception as exc:   # noqa: BLE001 — reported in the reply, on every rank
            error = exc
        n = len(t.ds)
        total = np.zeros(n, np.float64)
        for k, variables in enumerate(t.variables_seeds):
            seed_scores = np.zeros(n, np.float64)
            if error is None:
                try:
                    if self.world == 1:
                        seed_scores = self._chunked_pass(t, method, key, variables)
                    else:
                        fn = self._first_call(key, local) if k == 0 else local
                        seed_scores = score_pass(fn, variables, t.resident.batches(), n,
                                                 t.pos_of)
                except Exception as exc:   # noqa: BLE001 — the seeds' sums still run
                    error = exc
            total += self._collective(sum_float64, seed_scores)
        self._reply(error, "full pass")
        obs_registry.observe("serve_dispatch_s", time.perf_counter() - t0)
        scores = (total / len(t.variables_seeds)).astype(np.float32)
        t.scores[method] = scores
        return scores

    def _chunked_pass(self, t: Tenant, method: str, key: tuple, variables: dict) -> np.ndarray:
        """One seed's warm pass in one process: ``score_resident_pass`` over
        the tenant's resident blocks of up to ``MAX_SCORE_CHUNK_STEPS``
        batches (the JAX engine's), the key's first pass timed as its
        ``compile_s`` (the captures are in it)."""
        k_chunk = max(1, min(t.resident.nb, MAX_SCORE_CHUNK_STEPS))
        t0 = time.perf_counter()
        scores = score_resident_pass(self._score_chunks(method), t.resident, variables,
                                     k_chunk)
        if key not in self._programs:
            compile_s = time.perf_counter() - t0
            self._programs[key] = {"compiles": 1, "dispatches": 0,
                                   "compile_s": round(compile_s, 4)}
            obs_registry.observe("serve_compile_s", compile_s)
        return scores

    def _op_refresh(self, t: Tenant, op: dict, variables_seeds: list | None) -> None:
        """The body of a refresh on every rank: a rank without
        ``variables_seeds`` restores ``op``'s step; the install (and the
        clearing of the cached scores) happens on every rank or on none."""
        error = None
        if variables_seeds is None:
            try:
                variables_seeds = [self.load_checkpoint_variables(op["dir"], op["step"])[0]]
            except Exception as exc:   # noqa: BLE001 — every rank keeps the old model
                error = exc
        self._reply(error, "refresh")
        t.variables_seeds = variables_seeds
        t.scores = {}

    # ------------------------------------------------------------ the group

    def gather_rank_launches(self) -> list[dict]:
        """Each rank's kernel launches by kernel (``rank_launches``, by rank):
        a gather at the stats cadence, not per request."""
        with self._lock:
            self._announce({"op": "stats"})
            return self._op_stats()

    def _op_stats(self) -> list[dict] | None:
        joined = self._collective(gather_json, kernels.launch_counts())
        self._reply(None, "stats")
        if joined is not None:
            self.rank_launches = joined
        return joined

    def lead(self) -> None:
        """Rank 0, after the boot's lockstep calls: from here on every
        operation is announced to the peers (``follow``), and an idle
        ``tick`` carries their preemption flags. A no-op at W = 1."""
        if self.world <= 1:
            return
        if self.rank_index != 0:
            raise RuntimeError("only rank 0 leads the service's group")
        self._leading = True
        self._last_op = time.monotonic()
        threading.Thread(target=self._tick_loop, daemon=True, name="serve-group-tick").start()

    def follow(self, preempted=lambda: False) -> dict:
        """The loop of the ranks above 0: receive rank 0's next operation and
        run the same body on this rank's rows, until rank 0 sends ``stop``
        (returned). ``preempted()`` is this rank's preemption flag, carried in
        every operation's reply. An operation that failed (``OpFailed``)
        leaves the group in step and the loop goes on; a failed collective
        raises."""
        if self.rank_index == 0:
            raise RuntimeError("rank 0 leads the service's group; it does not follow")
        self._local_preempt = preempted
        while True:
            op = self._collective(broadcast_json, None)
            obs_heartbeat.beat(stage="serve")
            kind = op["op"]
            if kind == "stop":
                self._stopped = True
                return op
            try:
                if kind == "score":
                    self._op_score(self.tenant(op["tenant"]), op["method"], None)
                elif kind == "full":
                    self._op_full(self.tenant(op["tenant"]), op["method"])
                elif kind == "refresh":
                    self._op_refresh(self.tenant(op["tenant"]), op, None)
                elif kind == "stats":
                    self._op_stats()
                elif kind == "tick":
                    self._reply(None, "tick")
                else:
                    raise GroupLost(f"rank {self.rank_index}: unknown operation {op!r}")
            except OpFailed as exc:
                flightrec.record("fault", fault="serve_op_failed", op=kind,
                                 error=str(exc)[:300])

    def stop_group(self, reason: str, **fields) -> None:
        """Rank 0: send the peers ``stop`` (``reason`` and ``fields`` in the
        record; ``preempted`` makes them exit 75) and announce nothing after
        it. Nothing to send at W = 1, before ``lead``, after a failed
        collective, or twice."""
        self._tick_stop.set()
        with self._lock:
            if self._leading and not self._stopped and self.group_error is None:
                try:
                    self._announce({"op": "stop", "reason": reason, **fields})
                except GroupLost:
                    pass   # group_error holds the cause
            self._stopped = True

    def _announce(self, op: dict) -> None:
        """Rank 0, holding ``_lock``: the operation record to every rank,
        before any device work. Nothing at W = 1 or before ``lead``."""
        if not self._leading:
            return
        if self._stopped:
            raise GroupLost(f"the service's group was stopped; {op['op']!r} not run")
        self._collective(broadcast_json, op)
        self._last_op = time.monotonic()

    def _collective(self, fn, *args):
        """``fn(*args)``, one of the service's collectives, timed against the
        group's deadline; a failure is the group's (``group_error``)."""
        if self.world <= 1:
            return fn(*args)
        if self.group_error is not None:
            raise GroupLost(f"rank {self.rank_index}: the group failed earlier: "
                            f"{self.group_error!r}") from self.group_error
        self._waiting_since = time.monotonic()
        try:
            return fn(*args)
        except Exception as exc:   # noqa: BLE001 — a torn collective ends the group
            self.group_error = exc
            raise GroupLost(f"rank {self.rank_index}: a collective of the service failed: "
                            f"{exc!r}") from exc
        finally:
            self._waiting_since = None

    def _reply(self, error: BaseException | None, what: str) -> None:
        """The end of every operation: each rank's outcome and preemption flag
        on every rank. Raises on every rank when the operation failed on any
        (``OpFailed`` across ranks; the error itself at W = 1)."""
        if self.world <= 1:
            if error is not None:
                raise error
            return
        flags = self._collective(all_gather_host, np.asarray(
            [error is not None, bool(self._local_preempt())], np.int8))
        if flags[:, 1].any():
            self.preempt_agreed.set()
        failed = [r for r in range(self.world) if flags[r, 0]]
        if failed:
            raise OpFailed(f"{what} failed on rank(s) {failed}"
                           + (f": {error!r}" if error is not None else "")) from error

    def _tick_loop(self) -> None:
        while not self._tick_stop.wait(TICK_S / 4):
            if time.monotonic() - self._last_op < TICK_S:
                continue
            with self._lock:
                if self._stopped or self.group_error is not None:
                    return
                if time.monotonic() - self._last_op < TICK_S:
                    continue
                try:
                    self._announce({"op": "tick"})
                    self._reply(None, "tick")
                except GroupLost:
                    return   # group_error holds the cause; the serve loop raises it

    def _watch_deadline(self) -> None:
        """Exit ``EXIT_RETRIABLE`` when a collective outlasts the deadline: a
        dead or wedged peer, which no Python in this rank can interrupt."""
        while True:
            time.sleep(min(1.0, self.deadline_s / 10))
            since = self._waiting_since
            if since is None or time.monotonic() - since <= self.deadline_s:
                continue
            msg = (f"rank {self.rank_index}: a collective of the service waited more than "
                   f"resilience.consensus_grace_s={self.deadline_s:g} s (a peer is gone "
                   "or wedged): exit without teardown")
            try:
                flightrec.record("fault", fault="serve_group_deadline", error=msg)
                flightrec.dump("serve_group_deadline")
            except Exception:   # noqa: BLE001 — forensics never block the exit
                pass
            print(f"[resilience] {msg}", file=sys.stderr, flush=True)
            os._exit(EXIT_RETRIABLE)

    # ----------------------------------------------------- ranked answers

    def topk(self, tenant: str, method: str, k: int):
        """Top-``k`` hardest ``(index, score)`` pairs as an iterator; ties
        break by global index (pruning's lexsort discipline)."""
        scores = self.full_scores(tenant, method)
        t = self.tenant(tenant)
        k = max(0, min(int(k), len(scores)))
        order = np.lexsort((t.ds.indices, -scores))[:k]
        for pos in order:
            yield int(t.ds.indices[pos]), float(scores[pos])

    def rank(self, tenant: str, method: str, ids) -> tuple[np.ndarray, np.ndarray]:
        """Re-rank a slice hardest-first: ``(sorted_ids, sorted_scores)``."""
        scores = self.full_scores(tenant, method)
        t = self.tenant(tenant)
        ids = np.asarray(ids, np.int64)
        s = scores[t.pos_of(ids)]
        order = np.lexsort((ids, -s))
        return ids[order], s[order]
