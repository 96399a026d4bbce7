"""PyTorch port on the card's host, which has no JAX: this file imports none,
so it runs there as ``pytest --noconftest tests/test_torch_card_host.py``.

* the npy and shard planes that ``tools.npz_to_npy`` and ``tools.make_shards``
  build as subprocesses are bitwise what ``chip_smoke.py``'s inline writer
  writes (runs here too);
* card only (marked ``cuda``; skips without one): a fleet of two one-rank
  meshes, ``cli serve --device cuda serve.replicas=2 mesh.multihost=true
  mesh.num_processes=1`` (each replica its own NCCL group on the card),
  answers through the router bitwise ``score_dataset`` on the card, and
  exits 75 on SIGTERM from every rank.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tool_built_planes_equal_the_inline_ones(tmp_path, monkeypatch):
    smoke = _module("chip_smoke", REPO / "chip_smoke.py")
    monkeypatch.setattr(smoke, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(smoke, "DATA_SHARD", 64)
    port = smoke.load_port()
    train, test = port["load_dataset"]("synthetic_imagenet", synthetic_size=256, seed=0)
    # An npz source names no class count: make_shards takes the largest label
    # + 1, as the JAX tool does, where the inline writer is told the 100.
    assert max(train.labels.max(), test.labels.max()) + 1 == smoke.DATA_CLASSES
    dirs = smoke.write_data_planes(port, train, test)
    got = smoke.tool_planes(dirs, str(tmp_path), smoke.DATA_SHARD)
    assert got["files"] == ["stats.npz", "test_images.npy", "test_labels.npy",
                            "train_images.npy", "train_labels.npy"]
    assert not os.path.exists(tmp_path / "shards_tool")   # removed after the check


@pytest.mark.cuda
def test_fleet_of_one_rank_meshes_serves_bitwise_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: each replica is an NCCL group there")
    from data_diet_distributed_tpu_torch.config import load_config
    from data_diet_distributed_tpu_torch.models import create_model_from_cfg
    from data_diet_distributed_tpu_torch.ops.scoring import score_dataset
    from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
    from data_diet_distributed_tpu_torch.train import loop

    sc = _module("serve_client", REPO / "tools" / "serve_client.py")
    over = ["data.dataset=synthetic", "data.synthetic_size=256", "model.arch=resnet18",
            "train.half_precision=true", "score.pretrain_epochs=0", "score.seeds=[0,1]",
            "score.batch_size=64", f"train.checkpoint_dir={tmp_path}/ckpt"]
    cfg = load_config(None, over)
    ds, _ = loop.load_data_for(cfg)
    variables = ServeEngine(cfg, device="cuda").scoring_variables(ds)
    truth = {m: score_dataset(create_model_from_cfg(cfg), variables, ds, method=m,
                              batch_size=64, device="cuda") for m in ("el2n", "grand")}
    metrics = tmp_path / "m.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "DDT_FAULT_PLAN"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", "serve", "--device",
         "cuda", *over, "serve.replicas=2", "mesh.multihost=true", "mesh.num_processes=1",
         "serve.router_port=0", "serve.port=0", "serve.methods=[el2n,grand]",
         "serve.health_poll_s=0.25", f"obs.metrics_path={metrics}"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 300
        url = None
        while url is None and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            for line in metrics.read_text().splitlines() if metrics.exists() else []:
                rec = json.loads(line)
                if rec.get("kind") == "serve_fleet" and rec.get("event") == "launch":
                    url = f"http://127.0.0.1:{rec['router_port']}"
            time.sleep(0.2)
        client = sc.ServeClient(url, timeout_s=120.0, retries=6, backoff_s=0.25)
        while client.healthz().get("available") != 2:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        pos = {int(i): k for k, i in enumerate(ds.indices)}
        rng = np.random.default_rng(0)
        for _ in range(6):
            ids = rng.choice(ds.indices, size=int(rng.integers(1, 65)), replace=False)
            for m in ("el2n", "grand"):
                got = np.asarray(client.score(indices=ids.tolist(), method=m)["scores"],
                                 np.float32)
                np.testing.assert_array_equal(got, truth[m][[pos[int(i)] for i in ids]])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    recs = [json.loads(x) for x in metrics.read_text().splitlines() if x.startswith("{")]
    ended = next(r for r in recs if r.get("event") == "preempted_exit")
    assert ended["rank_rcs"] == [[75], [75]]
    assert recs[-1]["lineage"]["ranks"] == 1
