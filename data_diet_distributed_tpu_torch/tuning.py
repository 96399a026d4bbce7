"""Signed tuning manifests (copy of ``data_diet_distributed_tpu/tuning.py``):
the autotuner's output, the CLI's startup input.

A manifest is an atomic, sha256-digest-signed ``tuning_manifest.json`` that
pins ``DDT_*`` gates and a few config knobs for one geometry (arch, dataset,
batch size) on one kind of hardware. ``cli.py`` consults it at startup
through :func:`maybe_apply_manifest`, after the device is resolved and before
any module that reads a ``DDT_GRAND_*`` gate at import is imported; the serve
fleet watches its digest and rolls replicas one at a time when it changes
(``serve/fleet.py``).

Precedence is absolute and mode-independent: an env gate the user already
set and a config knob the user explicitly changed from its default ALWAYS
win over the manifest. The manifest only fills untouched knobs.

The port names its hardware (``cli.py::_hardware``, the perf ledger's
naming too) as ``backend`` ``"cuda"`` or ``"cpu"`` and ``device_kind``
``torch.cuda.get_device_name(device)`` on the card (``NVIDIA H100 80GB
HBM3``) or ``"cpu"``, so the repo's CPU manifest matches a port CPU run as it
matches a JAX CPU run, and a TPU manifest never matches on the card.

Knobs the port accepts and applies (and logs) but that change nothing in it:
``DDT_SCORE_FETCH`` (the JAX package's score-fetch engine), and
``score.chunk_steps`` and ``train.chunk_steps`` (the port runs the per-batch
and per-step paths). Every ``DDT_GRAND_*`` gate, ``DDT_SHARDED_UPDATE``,
``score.use_pallas``, ``mesh.shard_weight_update``, ``data.prefetch_depth``
and ``data.data_plane`` take effect.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable

from .config import Config
from .utils.io import atomic_write_json

#: Bump when the manifest's field set changes incompatibly.
TUNING_MANIFEST_VERSION = 1

#: Where the autotuner writes and the CLI looks when ``tuning.manifest`` is
#: null. Relative paths resolve against the process CWD.
DEFAULT_MANIFEST_PATH = os.path.join("artifacts", "tuning_manifest.json")

#: Env gates a manifest may pin. Anything else in a manifest's ``env`` block
#: is refused (a manifest must not become an arbitrary environment injector).
ALLOWED_ENV_KNOBS = (
    "DDT_GRAND_GROUP_CONV",
    "DDT_GRAND_GROUP_BN",
    "DDT_GRAND_BN_KERNEL",
    "DDT_GRAND_CATDOT",
    "DDT_GRAND_STEM_XLA",
    "DDT_GRAND_FUSED",
    "DDT_GRAND_MEGAKERNEL",
    "DDT_SHARDED_UPDATE",
    "DDT_SCORE_FETCH",
)

#: Config knobs a manifest may set, as dotted paths. Same refusal rule.
ALLOWED_CONFIG_KNOBS = (
    "score.chunk_steps",
    "score.use_pallas",
    "train.chunk_steps",
    "mesh.shard_weight_update",
    "data.prefetch_depth",
    "data.data_plane",
)


class TuningError(RuntimeError):
    """A manifest the run must not proceed with: corrupt JSON, a digest
    mismatch (tampered or half-copied file), an unknown knob, or, under
    ``tuning.apply=strict``, any condition ``auto`` would merely skip."""


# ---------------------------------------------------------------------------
# digest + read/write


def manifest_digest(manifest: dict) -> str:
    """sha256 over the canonical JSON of the manifest minus its own
    ``digest`` field (sorted keys, no whitespace)."""
    body = {k: v for k, v in manifest.items() if k != "digest"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def build_tuning_manifest(*, task: str, method: str, arch: str, dataset: str,
                          batch_size: int, backend: str, device_kind: str,
                          n_devices: int, env: dict[str, str],
                          config: dict[str, Any], chosen_combo: str,
                          metric: str, value: float, unit: str,
                          baseline_value: float | None,
                          exactness: list[dict],
                          candidates_considered: int,
                          source: str = "tools/autotune.py") -> dict:
    """Assemble and sign a manifest. ``env`` must pin every allowed toggle
    the winning combo depends on (absent is not off); ``config`` maps dotted
    knob paths to values. ``exactness`` records one entry per verified gated
    path (engine, reference, rtol/atol, ok)."""
    for key in env:
        if key not in ALLOWED_ENV_KNOBS:
            raise TuningError(f"manifest env knob {key!r} is not in the "
                              f"allowed set {ALLOWED_ENV_KNOBS}")
    for key in config:
        if key not in ALLOWED_CONFIG_KNOBS:
            raise TuningError(f"manifest config knob {key!r} is not in the "
                              f"allowed set {ALLOWED_CONFIG_KNOBS}")
    manifest = {
        "version": TUNING_MANIFEST_VERSION,
        "source": source,
        "task": task,
        "method": method,
        "geometry": {"arch": arch, "dataset": dataset,
                     "batch_size": int(batch_size)},
        "backend": backend,
        "device_kind": device_kind,
        "n_devices": int(n_devices),
        "chosen_combo": chosen_combo,
        "metric": metric,
        "value": float(value),
        "unit": unit,
        "baseline_value": (None if baseline_value is None
                           else float(baseline_value)),
        "candidates_considered": int(candidates_considered),
        "exactness": exactness,
        "env": dict(env),
        "config": dict(config),
    }
    manifest["digest"] = manifest_digest(manifest)
    return manifest


def write_tuning_manifest(path: str, manifest: dict) -> str:
    """Atomic write (temp + rename). The manifest must already be signed; an
    unsigned or mis-signed dict is a caller bug and refuses."""
    if manifest.get("digest") != manifest_digest(manifest):
        raise TuningError(f"refusing to write {path}: manifest digest does "
                          "not match its body (sign with "
                          "build_tuning_manifest)")
    atomic_write_json(path, manifest)
    return path


def read_tuning_manifest(path: str) -> dict:
    """Read and verify a manifest. Corruption and a digest mismatch ALWAYS
    raise :class:`TuningError`: a tampered manifest is never silently
    ignored, in any apply mode."""
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except json.JSONDecodeError as err:
        raise TuningError(
            f"{path}: corrupt tuning manifest ({err}) — re-run "
            "tools/autotune.py or delete the file") from err
    if not isinstance(manifest, dict):
        raise TuningError(f"{path}: tuning manifest is not a JSON object")
    want = manifest.get("digest")
    got = manifest_digest(manifest)
    if want != got:
        raise TuningError(
            f"{path}: tuning manifest digest mismatch (recorded "
            f"{str(want)[:12]}…, recomputed {got[:12]}…) — the file was "
            "edited or truncated after signing; re-run tools/autotune.py")
    version = manifest.get("version")
    if version != TUNING_MANIFEST_VERSION:
        raise TuningError(
            f"{path}: tuning manifest version {version!r} is not "
            f"{TUNING_MANIFEST_VERSION} — re-run tools/autotune.py")
    for key in manifest.get("env", {}):
        if key not in ALLOWED_ENV_KNOBS:
            raise TuningError(f"{path}: manifest env knob {key!r} is not "
                              "in the allowed set")
    for key in manifest.get("config", {}):
        if key not in ALLOWED_CONFIG_KNOBS:
            raise TuningError(f"{path}: manifest config knob {key!r} is "
                              "not in the allowed set")
    return manifest


# ---------------------------------------------------------------------------
# matching + application


def _cfg_get(cfg: Config, dotted: str) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        node = getattr(node, part)
    return node


def _cfg_set(cfg: Config, dotted: str, value: Any) -> None:
    *parents, leaf = dotted.split(".")
    node: Any = cfg
    for part in parents:
        node = getattr(node, part)
    setattr(node, leaf, value)


def match_manifest(manifest: dict, cfg: Config, *, backend: str | None,
                   device_kind: str | None) -> tuple[bool, str]:
    """Does this manifest describe THIS run? Geometry (arch, dataset,
    effective batch size for the manifest's task) and hardware (backend,
    device_kind) must all agree. Returns (ok, reason); reason names the
    first mismatch."""
    geo = manifest.get("geometry", {})
    if geo.get("arch") != cfg.model.arch:
        return False, (f"arch mismatch (manifest {geo.get('arch')!r}, "
                       f"run {cfg.model.arch!r})")
    if geo.get("dataset") != cfg.data.dataset:
        return False, (f"dataset mismatch (manifest {geo.get('dataset')!r}, "
                       f"run {cfg.data.dataset!r})")
    if manifest.get("task") == "score":
        run_batch = cfg.score.batch_size or cfg.data.batch_size
    else:
        run_batch = cfg.data.batch_size
    if int(geo.get("batch_size", -1)) != int(run_batch):
        return False, (f"batch_size mismatch (manifest "
                       f"{geo.get('batch_size')}, run {run_batch})")
    if backend is not None and manifest.get("backend") != backend:
        return False, (f"backend mismatch (manifest "
                       f"{manifest.get('backend')!r}, run {backend!r})")
    if device_kind is not None and manifest.get("device_kind") != device_kind:
        return False, (f"device_kind mismatch (manifest "
                       f"{manifest.get('device_kind')!r}, run "
                       f"{device_kind!r})")
    return True, "match"


def apply_manifest(manifest: dict, cfg: Config,
                   environ: dict | None = None) -> dict:
    """Apply a (verified, matching) manifest's knobs with user precedence.

    An env gate already present in ``environ`` is skipped (reason ``env``);
    a config knob whose current value differs from the fresh-``Config()``
    default is skipped (reason ``user-config``). Everything else is applied:
    env knobs into ``environ`` (before the gated ops modules import), config
    knobs onto ``cfg`` in place.

    Returns ``{"applied": {...}, "skipped": {knob: reason, ...}}``."""
    environ = os.environ if environ is None else environ
    defaults = Config()
    applied: dict[str, Any] = {}
    skipped: dict[str, str] = {}
    for key, value in manifest.get("env", {}).items():
        if key in environ:
            skipped[key] = "env"
            continue
        environ[key] = str(value)
        applied[key] = str(value)
    for dotted, value in manifest.get("config", {}).items():
        if _cfg_get(cfg, dotted) != _cfg_get(defaults, dotted):
            skipped[dotted] = "user-config"
            continue
        _cfg_set(cfg, dotted, value)
        applied[dotted] = value
    return {"applied": applied, "skipped": skipped}


def maybe_apply_manifest(cfg: Config, *, backend: str | None = None,
                         device_kind: str | None = None,
                         environ: dict | None = None,
                         read: Callable[[str], dict] | None = None,
                         ) -> dict | None:
    """The CLI's one startup call: resolve ``cfg.tuning`` into an
    applied/skipped decision.

    Returns the ``tuning_applied`` record fields (``applied`` bool,
    ``mode``, ``manifest`` path, plus ``reason``/``knobs``/``skipped``/
    ``digest``/``chosen_combo`` as applicable), or ``None`` when there is
    nothing to log (``apply=off``, or no manifest at the default path).

    Raises :class:`TuningError` for corrupt/mis-signed manifests in every
    mode, and for missing/mismatched manifests under ``strict``."""
    mode = cfg.tuning.apply
    if mode == "off":
        return None
    explicit = cfg.tuning.manifest is not None
    path = cfg.tuning.manifest or DEFAULT_MANIFEST_PATH
    if not os.path.exists(path):
        if mode == "strict":
            raise TuningError(f"tuning.apply=strict but manifest {path} "
                              "does not exist")
        if not explicit:
            return None    # default path absent: the common untuned case
        return {"applied": False, "mode": mode, "manifest": path,
                "reason": "manifest-missing"}
    manifest = (read or read_tuning_manifest)(path)   # raises on corruption
    ok, reason = match_manifest(manifest, cfg, backend=backend,
                                device_kind=device_kind)
    if not ok:
        if mode == "strict":
            raise TuningError(f"tuning.apply=strict: manifest {path} does "
                              f"not match this run — {reason}")
        return {"applied": False, "mode": mode, "manifest": path,
                "reason": reason, "digest": manifest.get("digest")}
    result = apply_manifest(manifest, cfg, environ=environ)
    return {"applied": True, "mode": mode, "manifest": path,
            "reason": "match", "digest": manifest.get("digest"),
            "chosen_combo": manifest.get("chosen_combo"),
            "knobs": result["applied"], "skipped": result["skipped"]}
