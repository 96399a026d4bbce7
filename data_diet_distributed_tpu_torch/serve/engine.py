"""The warm scoring engine behind serving (counterpart of
``data_diet_distributed_tpu/serve/engine.py::ServeEngine``).

``fit``, ``evaluate`` and ``score`` are composable units over one device and
one model: ``fit``/``evaluate`` run the port's ``train/loop.py``, ``score``
the tenant's resident score vector. Per registered TENANT (a named dataset +
per-seed scoring variables) the engine keeps the dense dataset rows on the
host, the dataset pre-batched on the device (``ScoreResident``) and the
resident score vector per method. A request is padded to the engine's one
batch geometry ``[B]`` (``serve.batch_size``, else ``score.batch_size``)
exactly as the resident tail is (row-0 images, zeroed labels, mask 0) and
runs the same per-batch score function, so it scores bit-identical to
``full_scores`` for the same ids (seeds averaged the same way). That rests on
fixed per-example arithmetic: deterministic cuDNN algorithm choice for one
geometry and kernels without atomics. On CUDA the engine sets
``set_scoring_determinism()``, which is process-wide, so an ``engine.fit`` in a
serving process trains with cuDNN's deterministic algorithms too (as every
port fit does); it is never toggled per call.

The program cache, keyed ``(arch, request geometry, method)`` like the JAX
package's, has nothing to compile in PyTorch: an entry's ``compile_s`` is the
wall of the FIRST call of the score function at that geometry, to the card's
completion (cuDNN plans, kernel module loads, allocator growth), kept under
the JAX field names so ``/status`` has the same shape. A dispatch that makes
that first call is ``cold``: its first seed's call is its ``compile_ms`` and
the other seeds' calls its ``dispatch_ms`` (until the score function returns)
and ``fetch_ms`` (the ``.cpu()`` that waits for the card). The GraNd path
syncs inside the call, so there ``dispatch_ms`` holds the device time.

``refresh_tenant`` swaps a tenant's variables in one assignment under the
dispatch lock and clears its cached scores in the same critical section;
``load_checkpoint_variables`` restores exactly the named (or newest) step of
the port's ``CheckpointManager``, digest-verified, with no fallback. Thread
model: every device call (the batcher's dispatcher, handler threads' cold
``topk``/``rank`` passes, a refresh install) is serialized behind ``_lock``.
Grad mode is thread-local; the score functions set it themselves.
"""

from __future__ import annotations

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
from ..models import create_model_from_cfg
from ..obs import registry as obs_registry
from ..ops.scores import make_local_scores, resolve_score_method, resolve_use_kernels
from ..ops.scoring import ScoreResident, score_pass
from ..train.loop import evaluate, fit, score_variables_for_seeds
from ..weights import variables_to


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
    """Warm-callable ``fit`` / ``score`` / ``evaluate`` units over one device.

    ``cfg`` supplies the model recipe and scoring knobs; ``device`` defaults
    to CUDA and raises without it (pass ``"cpu"`` for the CPU); ``logger`` (a
    ``MetricsLogger``) gets ``fit``'s records."""

    def __init__(self, cfg: Config, *, device=None, logger=None):
        self.cfg = cfg
        self.logger = logger
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_scoring_determinism()
        self.batch_size = int(cfg.serve.batch_size or cfg.score.batch_size)
        self.model = create_model_from_cfg(cfg).to(self.device)
        self.tenants: dict[str, Tenant] = {}
        self._local: dict[str, Any] = {}
        # (arch, geometry, method) -> {"compiles", "dispatches", "compile_s"}.
        self._programs: dict[tuple, dict] = {}
        self._lock = threading.Lock()
        # Phase timing of the latest score_batch, read by the batcher's single
        # dispatcher thread right after the call.
        self.last_dispatch_info: dict | None = None

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
        refresh and must not stall dispatches."""
        mngr = CheckpointManager(directory, max_to_keep=self.cfg.train.keep_checkpoints)
        step = mngr.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"{directory}: no checkpoint step to refresh from")
        return mngr.restore_variables(step, self.device), step

    def refresh_tenant(self, name: str, variables_seeds: Sequence) -> None:
        """Install new scoring variables for ``name``: ONE assignment under
        ``_lock``, which every dispatch and resident pass holds for its whole
        duration, so a request is served entirely by the old or entirely by
        the new variables; the cached score vectors (the old model's) are
        cleared in the same critical section. The ``ScoreResident`` upload
        (the dataset, not the model) survives."""
        if not variables_seeds:
            raise ValueError("refresh needs at least one variables dict")
        variables_seeds = [variables_to(v, self.device) for v in variables_seeds]
        t = self.tenant(name)
        with self._lock:
            t.variables_seeds = variables_seeds
            t.scores = {}

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

    def _local_scores(self, method: str):
        if method not in SERVABLE_METHODS:
            raise ValueError(f"unservable score method {method!r} "
                             f"(servable: {', '.join(SERVABLE_METHODS)})")
        fn = self._local.get(method)
        if fn is None:
            sc = self.cfg.score
            fn = self._local[method] = make_local_scores(
                self.model, resolve_score_method(method, sc.eval_mode),
                chunk=sc.grand_chunk, eval_mode=sc.eval_mode,
                use_kernels=resolve_use_kernels(sc.use_pallas))
        return fn

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
        ``full_scores`` for the same examples. Sets ``last_dispatch_info``."""
        t = self.tenant(tenant)
        n = len(images)
        with self._lock:
            local = self._local_scores(method)
            key = self._program_key(t, method)
            cold = key not in self._programs
            imgs, labs, mask = pad_batch(np.asarray(images, np.float32),
                                         np.asarray(labels, np.int32),
                                         self.batch_size, t.images[0])
            ops = [torch.from_numpy(a).to(self.device) for a in (imgs, labs, mask)]
            total = np.zeros(n, np.float64)
            dispatch_s = fetch_s = compile_s = 0.0
            t0 = time.perf_counter()
            for k, variables in enumerate(t.variables_seeds):
                td = time.perf_counter()
                out = (self._first_call(key, local) if k == 0 else local)(variables, *ops)
                tf = time.perf_counter()
                total += out.cpu().numpy().astype(np.float64)[:n]
                now = time.perf_counter()
                if cold and k == 0:
                    compile_s = now - td
                else:
                    dispatch_s += tf - td
                    fetch_s += now - tf
            self._programs[key]["dispatches"] += len(t.variables_seeds)
            obs_registry.observe("serve_dispatch_s", time.perf_counter() - t0)
            self.last_dispatch_info = {"cold": cold, "dispatch_ms": dispatch_s * 1e3,
                                       "fetch_ms": fetch_s * 1e3,
                                       "compile_ms": compile_s * 1e3}
        return (total / len(t.variables_seeds)).astype(np.float32)

    def full_scores(self, tenant: str, method: str) -> np.ndarray:
        """The tenant's whole-dataset score vector (cached), through the same
        ``score_pass`` as ``score_dataset``."""
        t = self.tenant(tenant)
        cached = t.scores.get(method)
        if cached is not None:
            return cached
        with self._lock:
            cached = t.scores.get(method)   # double-checked under the lock
            if cached is not None:
                return cached
            local = self._local_scores(method)
            if t.resident is None:
                t.resident = ScoreResident(t.ds, self.batch_size, self.device)
            key = self._program_key(t, method)
            total = np.zeros(t.resident.n, np.float64)
            t0 = time.perf_counter()
            for k, variables in enumerate(t.variables_seeds):
                fn = self._first_call(key, local) if k == 0 else local
                total += score_pass(fn, variables, t.resident.batches(),
                                    t.resident.n, t.pos_of)
            obs_registry.observe("serve_dispatch_s", time.perf_counter() - t0)
            scores = (total / len(t.variables_seeds)).astype(np.float32)
            t.scores[method] = scores
        return scores

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
