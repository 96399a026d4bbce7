"""Multi-rank fault consensus: every rank fails, and recovers, in lockstep (copy
of ``data_diet_distributed_tpu/resilience/consensus.py`` over
``torch.distributed``).

Across ranks each single-process mechanism is a desync hazard: a SIGTERM on
one rank, a NaN seen by one rank, a restore where each rank trusts its own
newest checkpoint, a hang that leaves the peers waiting in a collective.
Four agreements close them:

* **OR-reduced preemption**: ``Consensus.agree_preempt`` gathers the local
  flags, so every rank sees the preemption at the same step, writes the same
  final checkpoint and exits 75.
* **Agreed divergence**: the NaN sentinel's verdict is OR-reduced
  (``Consensus.agree``): every rank raises ``DivergenceError`` at the same
  epoch.
* **Min-agreed restore**: each rank's verified steps are gathered and
  intersected (``agree_common``); every rank restores the newest step all of
  them can verify, exactly, with no per-rank fallback.
* **Poison side channel**: a file per rank under a directory every rank sees
  (``<checkpoint_dir>_sidechannel``). A firing watchdog writes a poison
  record; the peers poll it between steps and from their own watchdog's
  monitor thread and abort with ``PeerPoisoned`` before the next collective;
  a peer already stuck inside one exits ``EXIT_RETRIABLE`` after
  ``consensus_grace_s`` (the watchdog's escalation).

The agreements are collectives over the host group (gloo, CPU tensors:
``parallel.mesh.host_group``; ``all_gather_host`` and ``broadcast_json`` of
``parallel/collectives.py``), so a host value never waits behind the card's
stream. ``Consensus.create`` returns None with one rank or with
``resilience.consensus=false``, and the module's functions are identities
with one rank.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..parallel.collectives import all_gather_host, broadcast_json  # noqa: F401
from ..parallel.mesh import process_index, sync_hosts, world_size
from .watchdog import EXIT_RETRIABLE  # noqa: F401 — the JAX package exports it here

#: Width of the gathered step and seed sets: each rank's newest this many.
MAX_AGREE_ITEMS = 64


class PeerPoisoned(RuntimeError):
    """A peer rank poisoned the side channel: abort before the next collective
    instead of hanging in it (a ``RuntimeError``, so a multi-rank job is
    restarted and resumed)."""


def agree_any(flag: bool) -> bool:
    """OR of a host boolean across the ranks (identity with one). Collective:
    every rank calls it at the same point."""
    if world_size() <= 1:
        return bool(flag)
    return bool(all_gather_host(np.asarray([flag], np.int8)).any())


def agree_common(values, max_items: int = MAX_AGREE_ITEMS) -> set[int]:
    """The non-negative ints EVERY rank holds (identity with one rank): each
    rank's newest ``max_items`` are gathered, padded with -1, and intersected.
    Collective across ranks."""
    local = sorted({int(v) for v in values if int(v) >= 0})[-max_items:]
    if world_size() <= 1:
        return set(local)
    arr = np.full(max_items, -1, np.int64)
    arr[:len(local)] = local
    rows = all_gather_host(arr)
    return set.intersection(*({int(v) for v in row if v >= 0} for row in rows))


class SideChannel:
    """One ``poison.rank<k>.json`` per rank under a shared directory; writes are
    atomic (temp + rename), reads a directory listing, cheap enough to poll
    from the step loop and the watchdog's monitor thread."""

    def __init__(self, directory: str, rank: int):
        self.directory = os.path.abspath(directory)
        self.rank = rank
        self._own = os.path.join(self.directory, f"poison.rank{rank}.json")

    def open(self) -> None:
        """Create the directory and clear THIS rank's stale poison (the caller
        then waits at a barrier, so no rank reads a peer's stale poison)."""
        os.makedirs(self.directory, exist_ok=True)
        try:
            os.remove(self._own)
        except FileNotFoundError:
            pass

    def poison(self, reason: str) -> None:
        tmp = f"{self._own}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"rank": self.rank, "reason": str(reason)[:500],
                       "ts": round(time.time(), 3)}, fh)
        os.replace(tmp, self._own)

    def peer_poison(self) -> dict | None:
        """The first peer's poison record, or None; an unreadable poison file
        (a rank that died mid-write) still counts."""
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return None
        own = os.path.basename(self._own)
        for name in names:
            if name.startswith("poison.rank") and name.endswith(".json") and name != own:
                try:
                    with open(os.path.join(self.directory, name)) as fh:
                        return json.load(fh)
                except (OSError, ValueError):
                    return {"rank": -1, "reason": f"unreadable poison file {name}"}
        return None


class Consensus:
    """Per-fit agreement state: the side channel and the preemption latch.
    Every ``agree*`` method is a collective, reached by every rank at the
    same point (the training loop polls on shared step indices)."""

    def __init__(self, channel_dir: str, *, poll_every: int = 1, grace_s: float = 15.0,
                 log=None, tag: str = ""):
        self.rank = process_index()
        self.world = world_size()
        self.poll_every = max(1, int(poll_every))
        self.grace_s = float(grace_s)
        self.log = log
        self.tag = tag
        self.channel = SideChannel(channel_dir, self.rank)
        self._preempt_latch = False
        self.channel.open()
        sync_hosts(f"consensus-open:{tag}")

    @classmethod
    def create(cls, cfg, *, log=None, tag: str = "") -> "Consensus | None":
        """None unless ``resilience.consensus`` is on and there are several ranks."""
        if not cfg.resilience.consensus or world_size() <= 1:
            return None
        channel_dir = (cfg.resilience.sidechannel_dir
                       or f"{cfg.train.checkpoint_dir}_sidechannel")
        return cls(channel_dir, poll_every=cfg.resilience.consensus_poll_steps,
                   grace_s=cfg.resilience.consensus_grace_s, log=log, tag=tag)

    def _log(self, event: str, **fields) -> None:
        if self.log is not None:
            self.log("consensus", event=event, tag=self.tag, rank=self.rank, **fields)

    def agree(self, flag: bool) -> bool:
        """OR of ``flag`` across the ranks (collective)."""
        return agree_any(flag)

    def agree_preempt(self, local: bool, unit: int | None = None) -> bool:
        """The preemption poll: OR ``local`` every ``poll_every`` units
        (``unit=None`` forces a poll, at epoch ends). Once agreed the latch
        stays set with no further collective."""
        if self._preempt_latch:
            return True
        if unit is not None and unit % self.poll_every:
            return False
        if self.agree(local):
            self._preempt_latch = True
            self._log("preempt_agreed", unit=unit, local=bool(local))
        return self._preempt_latch

    def agree_restore_step(self, candidates) -> int | None:
        """The newest step every rank verified (None when they share none)."""
        common = agree_common(candidates)
        agreed = max(common) if common else None
        self._log("restore_agreed", step=agreed,
                  local_latest=max(candidates) if len(candidates) else None)
        return agreed

    def poison(self, reason: str) -> None:
        """Write this rank's poison (the watchdog's ``on_fire``; safe from the
        monitor thread: no collective)."""
        self.channel.poison(reason)
        self._log("poison", reason=str(reason)[:300])

    def peer_exception(self) -> PeerPoisoned | None:
        """A ``PeerPoisoned`` for the first peer's poison, or None (the
        watchdog's ``peer_check``; safe from the monitor thread)."""
        info = self.channel.peer_poison()
        if info is None:
            return None
        return PeerPoisoned(
            f"rank {info.get('rank')} poisoned the run: {info.get('reason')!r} — "
            "aborting before the next collective (restart the job with "
            "train.resume=true)")

    def check_peers(self, unit: int | None = None) -> None:
        """Raise ``PeerPoisoned`` when a peer poisoned the run; polled every
        ``poll_every`` units (``unit=None`` forces it). A file listing, no
        collective."""
        if unit is not None and unit % self.poll_every:
            return
        exc = self.peer_exception()
        if exc is not None:
            self._log("peer_poisoned", error=str(exc)[:300])
            raise exc

    def watchdog_kwargs(self) -> dict:
        """A ``Watchdog``'s wiring under consensus: firing poisons the channel,
        the monitor polls for a peer's poison, and a main thread stuck in a
        collective exits ``EXIT_RETRIABLE`` after ``grace_s``."""
        return {"on_fire": self.poison, "peer_check": self.peer_exception,
                "escalate_s": self.grace_s, "escalate_code": EXIT_RETRIABLE}
