"""Communication telemetry (counterpart of
``data_diet_distributed_tpu/obs/comm.py``): the weight update's collective
bytes per step, the schedulable overlap bound, and the score-fetch wall.

* ``estimate_update_comm``: derived from the parameter tensors and the
  mesh by the ring cost model: a replicated update all-reduces every gradient
  byte (``2 (D-1)/D`` per byte); the sharded update
  (``parallel/mesh.py::UpdateSharding``) reduce-scatters the gradients and
  all-gathers the weights of the shardable leaves (``(D-1)/D`` each) and
  all-reduces the rest. ``D = 1`` moves nothing (zeros). The bytes are
  those of the whole parameter tree, as the JAX package's global arrays
  count them: at ``{data: D, model: M}`` a rank holds only its rows of the
  head, which count M times.
* ``overlap_ratio``: ``min(1, compute_s / comm_s)`` with the compute time
  the harvested ``train_step`` FLOPs over the MFU peak
  (``obs/introspect.py``) and the comm time the bytes over the link rate. The
  link rate resolves from ``DDT_INTERCONNECT_BYTES_PER_S``, else
  ``LINK_BYTES_PER_S`` by device name, else None, and the ratio is then null.
  An estimate, not a measurement (``overlap_ratio_source`` says so).
* the ``score_fetch_s`` histogram (the scoring pass's device-to-host fetch),
  summarized into the block when one accumulated.

One ``{"kind": "comm_stats"}`` record per fit and ``comm_*`` gauges. Host
arithmetic over tensor metadata only. The JAX package's XLA overlap flags
have no counterpart (``overlap_flags`` is empty, ``overlap_reason`` says why).
"""

from __future__ import annotations

import os
from typing import Any

from . import registry as obs_registry

#: NVLink bandwidth per device by ``torch.cuda.get_device_name()`` (bytes/s,
#: one direction). NVIDIA H100 SXM5: 900 GB/s NVLink total bidirectional,
#: 450 GB/s each way (NVIDIA H100 Tensor Core GPU data sheet). Used only for
#: the overlap estimate, never for MFU.
LINK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 450e9}

#: Why the JAX package's ``overlap_flags`` is empty here.
OVERLAP_REASON = "no XLA scheduler flags: the port issues its collectives itself"


def link_bandwidth(device=None) -> tuple[float | None, str]:
    """(bytes/s per device, source): the env override, the device table, or
    (None, "unknown")."""
    env = os.environ.get("DDT_INTERCONNECT_BYTES_PER_S")
    if env:
        try:
            val = float(env)
            if val > 0:
                return val, "env"
        except ValueError:
            pass
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        if name in LINK_BYTES_PER_S:
            return LINK_BYTES_PER_S[name], f"table:{name}"
    return None, "unknown"


def _param_bytes(params: dict, model: int = 1) -> int:
    """Bytes of the whole tree of which ``params`` holds a rank's layout."""
    from ..parallel.mesh import param_layout
    return sum(int(t.numel() * t.element_size())
               * (model if param_layout(k, model) is not None else 1)
               for k, t in params.items())


def estimate_update_comm(params: dict, mesh, update_sharding=None) -> dict[str, Any]:
    """Per-step collective bytes of the weight update over ``mesh``'s data
    axis (``params``: name -> tensor, in a rank's layout)."""
    data = int(mesh.data) if mesh is not None else 1
    param_bytes = _param_bytes(params, int(mesh.model) if mesh is not None else 1)
    ring = (data - 1) / data if data > 1 else 0.0
    sharded_frac = (update_sharding.sharded_fraction(params)
                    if update_sharding is not None and data > 1 else 0.0)
    shardable = int(param_bytes * sharded_frac)
    rest = param_bytes - shardable
    out = {
        "data_axis": data,
        "param_bytes": int(param_bytes),
        "sharded_update": update_sharding is not None,
        "sharded_frac": round(sharded_frac, 4),
        "reduce_scatter_bytes": int(shardable * ring),
        "all_gather_bytes": int(shardable * ring),
        "all_reduce_bytes": int((rest if update_sharding is not None
                                 else param_bytes) * 2 * ring),
    }
    out["bytes_per_step"] = (out["reduce_scatter_bytes"] + out["all_gather_bytes"]
                             + out["all_reduce_bytes"])
    return out


def overlap_ratio(comm_bytes: int, flops_per_step: float | None,
                  device=None) -> tuple[float | None, str]:
    """(schedulable-overlap bound, source); 1.0 ``no-comm`` when nothing
    moves, null when a rate is unknown."""
    if not comm_bytes:
        return 1.0, "no-comm"
    if not flops_per_step or flops_per_step <= 0:
        return None, "no-cost-analysis"
    bw, bw_source = link_bandwidth(device)
    if not bw:
        return None, f"no-link-bandwidth:{bw_source}"
    from . import introspect
    intro = introspect.current()
    peak = intro.peak_flops_per_device()[0] if intro is not None else None
    if not peak:
        peak, _ = introspect.device_peak_flops(device)
    if not peak:
        return None, "no-peak-flops"
    return min(1.0, (flops_per_step / peak) / (comm_bytes / bw)), f"estimated:{bw_source}"


def comm_block(params: dict, mesh, update_sharding=None, program: str | None = None,
               device=None) -> dict[str, Any]:
    """The byte estimates, the overlap ratio and the fetch-wall summary."""
    block = estimate_update_comm(params, mesh, update_sharding)
    flops = None
    if program is not None:
        from . import introspect
        intro = introspect.current()
        rec = intro.programs.get(program) if intro is not None else None
        if rec is not None:
            flops = rec.get("flops")
    ratio, source = overlap_ratio(block["bytes_per_step"], flops, device)
    block["overlap_ratio"] = None if ratio is None else round(ratio, 4)
    block["overlap_ratio_source"] = source
    block["overlap_flags"] = []
    block["overlap_reason"] = OVERLAP_REASON
    reg = obs_registry.current()
    hist = reg.peek_histogram("score_fetch_s") if reg is not None else None
    if hist is not None and hist.count:
        block["fetch_wall_s"] = hist.summary(digits=4)
    return block


def note_update_comm(params: dict, mesh, update_sharding=None, *, logger=None,
                     program: str | None = None, tag: str = "", device=None) -> dict:
    """Publish the comm block once per fit: the ``comm_*`` gauges and the
    ``comm_stats`` record. Returns the block."""
    block = comm_block(params, mesh, update_sharding, program=program, device=device)
    for g in ("reduce_scatter_bytes", "all_gather_bytes", "all_reduce_bytes",
              "bytes_per_step"):
        obs_registry.set_gauge(f"comm_{g}", block[g])
    if block.get("overlap_ratio") is not None:
        obs_registry.set_gauge("comm_overlap_ratio", block["overlap_ratio"])
    if logger is not None:
        logger("comm_stats", tag=tag, mesh={"data": int(mesh.data), "model": int(mesh.model)},
               **block)
    return block
