"""Chunk programs: K steps as one dispatch, a CUDA graph on the card.

The device half of the JAX package's chunked engine: ``jax.jit`` over the
unrolled ``jax.lax.scan`` of ``make_train_chunk`` / ``make_eval_chunk``
(``data_diet_distributed_tpu/train/steps.py:159-230``) and of
``make_score_chunk`` (``ops/scores.py:343-400``). PyTorch runs eagerly, so a
chunk of K bodies becomes a ``torch.cuda.CUDAGraph`` captured once per chunk
length and geometry and then replayed: one launch from the host for K steps'
kernels.

A ``ChunkProgram`` owns fixed storage and a ``run(inputs)`` that executes
the K bodies reading only from it:

* ``staged``: the host-side inputs of one chunk (the ``[K, B]`` index and mask
  block, the K learning rates, the K steps' augmentation draws), packed into
  one byte buffer and uploaded with ONE copy from pinned memory (two pinned
  slots take turns, so the host writes one while the other's copy is in
  flight);
* ``copied``: device tensors copied into static buffers before each dispatch
  (a streamed block's images, a scoring seed's variables, each buffer laid
  out as its template, strides included), so one capture serves every block
  and every seed;
* state the program is bound to (a fit's parameters, momentum and BatchNorm
  statistics) is not copied: ``run`` updates it in place, so the graph writes
  the very tensors the per-step path reads.

On CUDA the first dispatch stages its inputs, runs the ``warmup`` (one body,
on a side stream, on a clone of any bound state, so that neither an
optimizer step is skipped nor one repeated; kernels build here, never inside
a capture), captures ``run`` into a graph with a private memory pool and
replays it; every later dispatch stages and replays. A capture that fails
raises and names the program: nothing runs a chunk eagerly on the card (the
opt-out is ``train.chunk_steps=1`` / ``score.chunk_steps=1``). The outputs
live in the graph's pool and are overwritten by the next replay, so each
dispatch returns clones. On the CPU the same program stages into the same
buffers and runs ``run`` eagerly: the tests exercise the staging, the
in-place state and the stacked outputs that the card captures.

Counted in the registry: ``graph_replays:<program>`` per replay,
``graph_capture_s:<program>`` (warm-up, capture and first replay to the
card's completion) per capture, ``graph_captures`` and the ``graph_pool_bytes``
gauge (bytes the allocator reserved during the program's captures, still
held). The hand-written kernels a capture launches are recorded
(``ops/kernels.py::recording``) and added to their launch counts on every
replay, so launch counts mean launches on the card whichever engine ran.
"""

from __future__ import annotations

import gc
import time
from collections.abc import Callable

import numpy as np
import torch

from .obs import introspect
from .obs import registry as obs_registry
from .ops import kernels

#: Byte alignment of each field in the staging buffer.
_ALIGN = 16


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()


class ChunkProgram:
    """K bodies as one dispatch (see the module docstring).

    ``run(inputs) -> {name: tensor}`` executes the chunk from ``inputs``, the
    static tensors by field name; ``warmup(inputs)`` runs one body eagerly
    without touching bound state (CUDA only); ``examples`` is the examples of
    one body, for the introspector's harvest of the warm-up (on the card) or
    of the first eager chunk (on the CPU); ``harvest=False`` leaves the
    program out of the introspector (a serving engine's request path)."""

    def __init__(self, name: str, run: Callable[[dict], dict], device, *, k: int,
                 staged: dict[str, tuple[tuple, torch.dtype]] | None = None,
                 copied: dict[str, tuple[tuple, torch.dtype] | torch.Tensor] | None = None,
                 warmup: Callable[[dict], object] | None = None,
                 key=None, examples: int | None = None, harvest: bool = True):
        self.name = name
        self.k = int(k)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._run = run
        self._warmup = warmup
        self.key = key
        self.examples = examples
        self.harvest = harvest
        self.dispatches = 0
        self.replays = 0
        self.capture_s: float | None = None
        self.pool_bytes = 0
        self._graph = None
        self._outputs: dict | None = None
        self._tally: dict = {}
        staged = staged or {}
        self._fields: dict[str, tuple[int, tuple, torch.dtype]] = {}
        offset = 0
        for field, (shape, dtype) in staged.items():
            self._fields[field] = (offset, tuple(shape), dtype)
            offset += -(-_nbytes(shape, dtype) // _ALIGN) * _ALIGN
        size = max(offset, _ALIGN)
        self._dev_bytes = torch.empty(size, dtype=torch.uint8, device=self.device)
        self._host = [torch.empty(size, dtype=torch.uint8, pin_memory=self.cuda)
                      for _ in range(2 if self.cuda else 1)]
        self._uploaded: list = [None] * len(self._host)
        self._slot = 0
        self.inputs: dict[str, torch.Tensor] = {}
        for field, (off, shape, dtype) in self._fields.items():
            n = _nbytes(shape, dtype)
            self.inputs[field] = self._dev_bytes[off:off + n].view(dtype).view(shape)
        for field, spec in (copied or {}).items():
            # A template tensor gives its strides too: a weight's layout picks
            # the kernels that read it, so the copy keeps the per-step layout.
            self.inputs[field] = (torch.empty_like(spec, device=self.device)
                                  if isinstance(spec, torch.Tensor) else
                                  torch.empty(spec[0], dtype=spec[1], device=self.device))

    # ------------------------------------------------------------- staging

    def _stage(self, host: dict[str, np.ndarray]) -> None:
        """Every staged field from ``host`` into the device buffer, one copy."""
        if set(host) != set(self._fields):
            raise KeyError(f"{self.name}: staged fields {sorted(host)}, want "
                           f"{sorted(self._fields)}")
        slot = self._slot
        buf = self._host[slot]
        if self._uploaded[slot] is not None:
            self._uploaded[slot].synchronize()   # its last upload has landed
        for field, (off, shape, dtype) in self._fields.items():
            arr = np.asarray(host[field])
            if arr.shape != shape:
                raise ValueError(f"{self.name}: {field} has shape {arr.shape}, "
                                 f"the program was built for {shape}")
            view = buf[off:off + _nbytes(shape, dtype)].view(dtype).view(shape)
            view.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        self._dev_bytes.copy_(buf, non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._uploaded[slot] = ev
            self._slot = (slot + 1) % len(self._host)

    def _copy_in(self, device: dict[str, torch.Tensor]) -> None:
        for field, src in device.items():
            dst = self.inputs[field]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{self.name}: {field} has shape {tuple(src.shape)}, "
                                 f"the program was built for {tuple(dst.shape)}")
            dst.copy_(src)

    # ------------------------------------------------------------ dispatch

    def __call__(self, host: dict[str, np.ndarray] | None = None,
                 device: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """Stage ``host`` and copy ``device`` into the program's storage, then
        run the chunk: a graph replay on the card, the bodies eagerly on the
        CPU. Returns the outputs (clones on the card)."""
        self._stage(host or {})
        self._copy_in(device or {})
        self.dispatches += 1
        if not self.cuda:   # the first eager chunk is the harvested call
            if not self.harvest:
                return self._run(self.inputs)
            return introspect.call(self.name, self._run, (self.inputs,), key=self.key,
                                   examples=(self.examples or 0) * self.k or None)
        if self._graph is None:
            self._capture()
        else:
            self._replay()
        return {k: v.clone() for k, v in self._outputs.items()}

    def _replay(self) -> None:
        self._graph.replay()
        self.replays += 1
        obs_registry.inc(f"graph_replays:{self.name}")
        kernels.add_launches(self._tally)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        if self._warmup is not None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                if self.harvest:
                    introspect.call(self.name, self._warmup, (self.inputs,), key=self.key,
                                    examples=self.examples)
                else:
                    self._warmup(self.inputs)
            stream.wait_stream(side)
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()   # as the capture does: the baseline of its pool
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            # Thread-local: another thread's CUDA calls (a serving engine's
            # checkpoint restore, a monitor's event query) must not void the
            # capture; the capture's own backward launches onto its stream.
            with kernels.recording() as tally, \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self._run(self.inputs)
        except RuntimeError as err:
            raise RuntimeError(
                f"chunk program {self.name!r} (K={self.k}, {self.key}) could not be "
                f"captured as a CUDA graph: {err}. The chunk does not run eagerly on "
                "the card; train.chunk_steps=1 / score.chunk_steps=1 take the "
                "per-step path") from err
        self._graph, self._outputs, self._tally = graph, outputs, dict(tally)
        self.pool_bytes = max(0, torch.cuda.memory_reserved(self.device) - reserved)
        self._replay()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        obs_registry.inc("graph_captures")
        obs_registry.observe(f"graph_capture_s:{self.name}", self.capture_s)

    def release(self) -> None:
        """Drop the graph, its pool and the static buffers."""
        self._graph = self._outputs = None
        self.inputs = {}
        self._dev_bytes = None
        self._host = []


class GraphCache:
    """The chunk programs of one owner (a fit, a scoring call, a serving
    engine), keyed by program, K, batch geometry and dtype; ``release``
    frees them all, so captures do not pile up across a multi-seed
    pretrain's fits."""

    def __init__(self):
        self.programs: dict[tuple, ChunkProgram] = {}

    def get(self, key: tuple, factory: Callable[[], ChunkProgram]) -> ChunkProgram:
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = factory()
        return prog

    def stats(self) -> list[dict]:
        """Per program: its name, K, geometry key, dispatches, replays,
        capture wall and pool bytes."""
        return [{"program": p.name, "k": p.k, "key": str(p.key),
                 "dispatches": p.dispatches, "replays": p.replays,
                 "capture_s": p.capture_s, "pool_bytes": p.pool_bytes}
                for p in self.programs.values()]

    def pool_bytes(self) -> int:
        return sum(p.pool_bytes for p in self.programs.values())

    def release(self) -> None:
        for p in self.programs.values():
            p.release()
        self.programs.clear()
        obs_registry.set_gauge("graph_pool_bytes", 0)

    def note_pool(self) -> None:
        obs_registry.set_gauge("graph_pool_bytes", self.pool_bytes())
