"""The warm scoring engine behind serving (counterpart of
``data_diet_distributed_tpu/serve/engine.py::ServeEngine``).

Per registered TENANT (a named dataset + per-seed scoring variables) it keeps
the dense dataset rows on the host, the dataset pre-batched on the device
(``ScoreResident``) and the resident score vector per method. A request is
padded to the engine's one batch geometry ``[B]`` exactly as the resident tail
is (row-0 images, zeroed labels, mask 0) and runs the same per-batch score
function, so it scores bit-identical to ``full_scores`` for the same ids
(seeds averaged the same way). That rests on fixed per-example arithmetic:
deterministic cuDNN algorithm choice for one geometry and kernels without
atomics.

The scoring variables come from the config's recipe
(``score_variables_for_seeds``: a pretrain per seed, a fixed checkpoint, or
the init). Not ported yet: ``fit``/``evaluate``, checkpoint refresh, the
batcher, the HTTP server, the router and the fleet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.datasets import ArrayDataset, make_position_joiner
from ..data.pipeline import pad_batch
from ..device import resolve_device, set_scoring_determinism
from ..models import create_model_from_cfg
from ..ops.scores import make_local_scores, resolve_score_method, resolve_use_kernels
from ..ops.scoring import ScoreResident, score_pass
from ..train.loop import score_variables_for_seeds
from ..weights import variables_to

#: Checkpoint-based score methods the engine can answer for.
SERVABLE_METHODS = ("el2n", "margin", "grand", "grand_vmap", "grand_last_layer")


@dataclass
class Tenant:
    """One named dataset + scoring variables resident on the device."""

    name: str
    ds: ArrayDataset
    variables_seeds: list
    images: np.ndarray | None = None     # dense float32 rows, host
    labels: np.ndarray | None = None
    pos_of: Any = None                   # global id -> row position joiner
    resident: ScoreResident | None = None
    scores: dict[str, np.ndarray] = field(default_factory=dict)


class ServeEngine:
    """Warm-callable scoring over registered tenants on one device.

    ``cfg`` supplies the model recipe and scoring knobs; ``device`` defaults
    to CUDA and raises without it (pass ``"cpu"`` for the CPU). Requests and
    resident passes share one batch geometry, ``score.batch_size``. Every
    device call is serialized behind one lock."""

    def __init__(self, cfg: Config, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_scoring_determinism()
        self.batch_size = int(cfg.score.batch_size)
        self.model = create_model_from_cfg(cfg).to(self.device)
        self.tenants: dict[str, Tenant] = {}
        self._local: dict[str, Any] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- tenants

    def scoring_variables(self, ds: ArrayDataset,
                          seeds: Sequence[int] | None = None) -> list:
        """Per-seed scoring variables from the config's recipe: a pretrain of
        ``score.pretrain_epochs`` epochs on ``ds`` per seed (one upload shared
        by the seeds), the checkpoint ``score.score_ckpt_step``, or the init."""
        return score_variables_for_seeds(self.cfg, ds, device=self.device, seeds=seeds)

    def register_tenant(self, name: str, ds: ArrayDataset,
                        variables_seeds: Sequence | None = None) -> Tenant:
        """Make a dataset + scoring variables resident under ``name``;
        ``variables_seeds`` None builds them from the config's recipe."""
        if variables_seeds is None:
            variables_seeds = self.scoring_variables(ds)
        tenant = Tenant(name=name, ds=ds,
                        variables_seeds=[variables_to(v, self.device)
                                         for v in variables_seeds],
                        images=np.asarray(ds.images, np.float32),
                        labels=np.asarray(ds.labels, np.int32),
                        pos_of=make_position_joiner(ds.indices))
        with self._lock:
            self.tenants[name] = tenant
        return tenant

    def tenant(self, name: str) -> Tenant:
        try:
            return self.tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; registered: "
                           f"{sorted(self.tenants)}") from None

    def examples_for(self, tenant: str, ids) -> tuple[np.ndarray, np.ndarray]:
        """Dense float32 rows + labels for global example ids (KeyError for
        ids not in the tenant's dataset)."""
        t = self.tenant(tenant)
        pos = t.pos_of(np.asarray(ids, np.int64))
        return t.images[pos], t.labels[pos]

    # ------------------------------------------------------------ scoring

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

    def score_batch(self, tenant: str, method: str, images: np.ndarray,
                    labels: np.ndarray) -> np.ndarray:
        """Score ``n <= B`` examples: ``scores[n]`` float32, bit-identical to
        ``full_scores`` for the same examples."""
        t = self.tenant(tenant)
        n = len(images)
        with self._lock:
            local = self._local_scores(method)
            imgs, labs, mask = pad_batch(np.asarray(images, np.float32),
                                         np.asarray(labels, np.int32),
                                         self.batch_size, t.images[0])
            ops = [torch.from_numpy(a).to(self.device) for a in (imgs, labs, mask)]
            total = np.zeros(n, np.float64)
            for variables in t.variables_seeds:
                out = local(variables, *ops)
                total += out.cpu().numpy().astype(np.float64)[:n]
        return (total / len(t.variables_seeds)).astype(np.float32)

    def full_scores(self, tenant: str, method: str) -> np.ndarray:
        """The tenant's whole-dataset score vector (cached), through the same
        ``score_pass`` as ``score_dataset``."""
        t = self.tenant(tenant)
        cached = t.scores.get(method)
        if cached is not None:
            return cached
        with self._lock:
            cached = t.scores.get(method)
            if cached is not None:
                return cached
            local = self._local_scores(method)
            if t.resident is None:
                t.resident = ScoreResident(t.ds, self.batch_size, self.device)
            total = np.zeros(t.resident.n, np.float64)
            for variables in t.variables_seeds:
                total += score_pass(local, variables, t.resident.batches(),
                                    t.resident.n, t.pos_of)
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
