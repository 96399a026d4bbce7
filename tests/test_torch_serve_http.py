"""PyTorch port: the serving slice over HTTP, held against the JAX package.

The JAX ``ServeService`` and the port's boot side by side on tiny_cnn (64
synthetic examples, batch 16, port 0); the port's variables are the JAX init
converted by ``weights.params_from_flax``. Both answer the same ``/v1/score``
(indices and images), ``/v1/rank`` and ``/v1/topk`` requests: EL2N within rtol
1e-5, atol 1e-6 and GraNd within rtol 2e-4, atol 1e-6 (the tolerances of
``test_torch_scoring.py``), ranked ids equal wherever the scores are not
within tolerance of a tie. The error statuses, the 404 endpoint list, the
``/healthz`` keys and verdict and the ``/status`` serve block's keys match, and
``tools/run_monitor.py --once`` judges the port's live service healthy.
"""

import importlib.util
import json
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from data_diet_distributed_tpu.config import load_config as jax_load_config
from data_diet_distributed_tpu.data.datasets import load_dataset as jax_load_dataset
from data_diet_distributed_tpu.obs import MetricsLogger as JaxMetricsLogger
from data_diet_distributed_tpu.serve.engine import ServeEngine as JaxServeEngine
from data_diet_distributed_tpu.serve.server import ServeService as JaxServeService
from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.data.datasets import load_dataset
from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.obs.metrics import MetricsLogger
from data_diet_distributed_tpu_torch.serve.engine import ServeEngine
from data_diet_distributed_tpu_torch.serve.server import ServeService
from data_diet_distributed_tpu_torch.weights import params_from_flax
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
N, B = 64, 16
TOL = {"el2n": (1e-5, 1e-6), "grand": (2e-4, 1e-6)}


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _overrides(tmp, side):
    return ["data.dataset=synthetic", f"data.synthetic_size={N}", "model.arch=tiny_cnn",
            "train.half_precision=false", f"train.checkpoint_dir={tmp}/{side}_ckpt",
            "score.pretrain_epochs=0", f"score.batch_size={B}", "serve.port=0",
            "serve.coalesce_ms=2", "serve.tenant=tiny",
            f"obs.metrics_path={tmp}/{side}_metrics.jsonl",
            f"obs.heartbeat_dir={tmp}/{side}_hb"]


def _call(port, path, body=None):
    """(status, payload) of one request; payload is parsed JSON, or the list of
    ndjson items of a streamed ``/v1/topk``."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        status, raw = err.code, err.read()
    if path.startswith("/v1/topk") and status == 200:
        return status, [json.loads(line) for line in raw.splitlines() if line.strip()]
    return status, json.loads(raw)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_http")
    jcfg = jax_load_config(None, _overrides(tmp, "jax"))
    cfg = load_config(None, _overrides(tmp, "torch"))
    jds, _ = jax_load_dataset("synthetic", synthetic_size=N, seed=0)
    ds, _ = load_dataset("synthetic", synthetic_size=N, seed=0)
    assert np.array_equal(jds.images, ds.images) and np.array_equal(jds.labels, ds.labels)

    jlogger = JaxMetricsLogger(jcfg.obs.metrics_path, echo=False)
    jengine = JaxServeEngine(jcfg, logger=jlogger)
    tree = jax.jit(jengine.model.init, static_argnames=("train",))(
        jax.random.key(0), np.zeros((1, *jds.images.shape[1:]), np.float32), train=False)
    jengine.register_tenant("tiny", jds, variables_seeds=[tree])
    logger = MetricsLogger(cfg.obs.metrics_path, echo=False)
    engine = ServeEngine(cfg, device="cpu", logger=logger)
    engine.register_tenant("tiny", ds, [params_from_flax(jax.device_get(tree),
                                                         create_model("tiny_cnn", 10))])
    jservice = JaxServeService(jengine, jcfg, logger=jlogger)
    service = ServeService(engine, cfg, logger=logger)
    assert jservice.start() and service.start()
    yield {"jax": jservice.port, "torch": service.port, "service": service, "ds": ds}
    service.stop()
    jservice.stop()
    logger.close()
    jlogger.close()


def _both(services, path, body=None):
    return _call(services["jax"], path, body), _call(services["torch"], path, body)


def _close(got, want, method):
    rtol, atol = TOL[method]
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _ranked_ids_agree(got_ids, want_ids, want_scores, method):
    """Equal ids wherever the neighbouring scores are not within tolerance of a
    tie (where they are, either order is right)."""
    rtol, atol = TOL[method]
    want_scores = np.asarray(want_scores, np.float64)
    tie = np.zeros(len(want_ids), bool)
    gaps = np.abs(np.diff(want_scores)) <= 2 * (rtol * np.abs(want_scores[1:]) + atol)
    tie[:-1] |= gaps
    tie[1:] |= gaps
    assert sorted(got_ids) == sorted(want_ids)
    assert [g for g, t in zip(got_ids, tie) if not t] == \
        [w for w, t in zip(want_ids, tie) if not t]


@pytest.mark.parametrize("method", ["el2n", "grand"])
def test_score_by_indices_and_images_agree_with_jax(services, method):
    ids = [3, 7, 10, 60, 0]
    (js, jp), (ts, tp) = _both(services, "/v1/score", {"indices": ids, "method": method})
    assert js == ts == 200
    assert tp["indices"] == jp["indices"] == ids and tp["n"] == jp["n"] == len(ids)
    _close(tp["scores"], jp["scores"], method)
    # New examples: float32 -> JSON -> float32 round-trips exactly.
    rows = services["ds"].images[[5, 9, 33]]
    body = {"images": rows.tolist(), "labels": [1, 2, 3], "method": method}
    (js, jp), (ts, tp) = _both(services, "/v1/score", body)
    assert js == ts == 200
    _close(tp["scores"], jp["scores"], method)


@pytest.mark.parametrize("method", ["el2n", "grand"])
def test_rank_and_topk_agree_with_jax(services, method):
    body = {"indices": list(range(0, N, 3)), "method": method}
    (js, jp), (ts, tp) = _both(services, "/v1/rank", body)
    assert js == ts == 200
    _close(tp["scores"], jp["scores"], method)
    _ranked_ids_agree(tp["indices"], jp["indices"], jp["scores"], method)
    (js, jp), (ts, tp) = _both(services, f"/v1/topk?k=10&method={method}")
    assert js == ts == 200 and len(tp) == len(jp) == 10
    _close([r["score"] for r in tp], [r["score"] for r in jp], method)
    _ranked_ids_agree([r["index"] for r in tp], [r["index"] for r in jp],
                      [r["score"] for r in jp], method)


@pytest.mark.parametrize("path,body", [
    ("/v1/score", {"tenant": "nobody", "indices": [1]}),
    ("/v1/score", {"images": [[[[0.0] * 3] * 32] * 32]}),
    ("/v1/score", {"indices": [1], "method": "forgetting"}),
    ("/v1/score", {"indices": [10_000]}),
    ("/v1/score", {}),
    ("/v1/rank", {"indices": []}),
    ("/v1/rank", {"tenant": "nobody", "indices": [1]}),
    ("/v1/nope", {"indices": [1]}),
    ("/nope", None),
    ("/v1/topk?tenant=nobody", None),
])
def test_error_statuses_match_jax(services, path, body):
    (js, jp), (ts, tp) = _both(services, path, body)
    assert ts == js and ts in (400, 404), (ts, tp, js, jp)
    if ts == 404:
        assert tp["endpoints"] == jp["endpoints"]


def test_health_status_and_monitor_match_jax(services):
    (js, jh), (ts, th) = _both(services, "/healthz")
    assert js == ts == 200 and th["status"] == jh["status"] == "ok"
    assert set(th) == set(jh)
    (_, jst), (_, tst) = _both(services, "/status")
    assert set(tst["serve"]) == set(jst["serve"])
    assert tst["serve"]["tenants"] == ["tiny"]
    (_, jf), (_, tf) = _both(services, "/flightrec")
    assert tf == {"installed": False, "events": []} and set(tf) <= set(jf)
    rm = _load_tool("run_monitor")
    assert rm.main(["--port", str(services["torch"]), "--once", "--json"]) == 0
