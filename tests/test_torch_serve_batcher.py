"""PyTorch port: the batcher (``serve/batcher.py``) held against the JAX
package's on every scenario of ``tests/test_serve_batcher.py``.

Each scenario runs through both batchers over that file's ``FakeEngine``
(scores are the image values, so the row scatter and re-join are directly
checkable); the dispatch logs ``(tenant, method, rows)``, the results and the
raised errors must be equal. Requests a scenario submits concurrently are
staggered by a few milliseconds so both batchers see one arrival order.
"""

import threading
import time

import numpy as np
import pytest

from data_diet_distributed_tpu.serve import batcher as jax_batcher
from data_diet_distributed_tpu_torch.serve import batcher
from test_serve_batcher import FakeEngine, _imgs

STAGGER_S = 0.02


def _submit_async(b, tenant, method, values, out, key):
    def run():
        try:
            out[key] = list(b.submit(tenant, method, _imgs(values),
                                     np.zeros(len(values), np.int32)))
        except Exception as exc:   # noqa: BLE001 — compared by the test
            out[key] = repr(exc)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(STAGGER_S)
    return t


def _join(threads):
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)


def coalesce(mod):
    eng = FakeEngine(batch_size=8)
    b = mod.ScoreBatcher(eng, coalesce_window_s=0.3).start()
    out = {}
    threads = [_submit_async(b, "a", "el2n", [1, 2], out, "r1"),
               _submit_async(b, "a", "el2n", [3], out, "r2")]
    _join(threads)
    b.stop()
    return {"log": eng.dispatches, "out": out}


def window_deadline(mod):
    eng = FakeEngine(batch_size=8)
    b = mod.ScoreBatcher(eng, coalesce_window_s=0.25).start()
    t0 = time.monotonic()
    scores = list(b.submit("a", "el2n", _imgs([7]), np.zeros(1, np.int32)))
    wall = time.monotonic() - t0
    b.stop()
    return {"log": eng.dispatches, "out": scores, "waited": 0.2 <= wall < 1.5}


def full_batch(mod):
    eng = FakeEngine(batch_size=4)
    b = mod.ScoreBatcher(eng, coalesce_window_s=5.0).start()
    t0 = time.monotonic()
    scores = list(b.submit("a", "el2n", _imgs([1, 2, 3, 4]), np.zeros(4, np.int32)))
    wall = time.monotonic() - t0
    b.stop()
    return {"log": eng.dispatches, "out": scores, "fast": wall < 2.0}


def split_rejoin(mod):
    eng = FakeEngine(batch_size=4)
    b = mod.ScoreBatcher(eng, coalesce_window_s=0.0).start()
    scores = list(b.submit("a", "el2n", _imgs(list(range(10))), np.zeros(10, np.int32)))
    b.stop()
    return {"log": eng.dispatches, "out": scores}


def methods_apart(mod):
    eng = FakeEngine(batch_size=8)
    b = mod.ScoreBatcher(eng, coalesce_window_s=0.2).start()
    out = {}
    eng.gate.clear()   # hold the worker so both queue up
    threads = [_submit_async(b, "a", "el2n", [1], out, "r1"),
               _submit_async(b, "a", "grand", [2], out, "r2")]
    time.sleep(0.1)
    eng.gate.set()
    _join(threads)
    b.stop()
    return {"log": eng.dispatches, "out": out}


def round_robin(mod):
    eng = FakeEngine(batch_size=4)
    b = mod.ScoreBatcher(eng, coalesce_window_s=0.0).start()
    eng.gate.clear()   # wedge the worker while both queues load
    out = {}
    threads = [_submit_async(b, "a", "el2n", [i] * 4, out, f"a{i}") for i in range(4)]
    time.sleep(0.1)
    threads += [_submit_async(b, "b", "el2n", [9] * 4, out, f"b{i}") for i in range(2)]
    time.sleep(0.1)
    eng.gate.set()
    _join(threads)
    b.stop()
    return {"log": eng.dispatches, "out": out}


def weighted_round_robin(mod):
    eng = FakeEngine(batch_size=4, weights={"heavy": 2, "light": 1})
    b = mod.ScoreBatcher(eng, coalesce_window_s=0.0).start()
    eng.gate.clear()
    out = {}
    threads = [_submit_async(b, "heavy", "el2n", [i] * 4, out, f"h{i}") for i in range(4)]
    threads += [_submit_async(b, "light", "el2n", [i] * 4, out, f"l{i}") for i in range(2)]
    time.sleep(0.15)
    eng.gate.set()
    _join(threads)
    b.stop()
    return {"log": eng.dispatches, "out": out}


def backpressure_draining(mod):
    eng = FakeEngine(batch_size=4)
    b = mod.ScoreBatcher(eng, max_queue=1, retry_after_s=3.0,
                         coalesce_window_s=0.0).start()
    eng.gate.clear()
    out = {}
    threads = [_submit_async(b, "a", "el2n", [1], out, "r1")]
    time.sleep(0.2)    # the worker has taken r1 and is wedged dispatching it
    threads.append(_submit_async(b, "a", "el2n", [2], out, "r2"))
    time.sleep(0.2)    # r2 fills the single queue slot
    with pytest.raises(mod.Backpressure) as err:
        b.submit("a", "el2n", _imgs([4]), np.zeros(1, np.int32))
    rejected = b.stats()["rejected"]
    eng.gate.set()
    _join(threads)
    b.stop_admission()
    with pytest.raises(mod.Draining):
        b.submit("a", "el2n", _imgs([5]), np.zeros(1, np.int32))
    drained = b.drain(5.0)
    b.stop()
    return {"log": eng.dispatches, "out": out, "retry_after_s": err.value.retry_after_s,
            "rejected": rejected, "drained": drained}


def dispatch_failure(mod):
    class FailingEngine(FakeEngine):
        def score_batch(self, tenant, method, images, labels):
            raise RuntimeError("kaboom")

    b = mod.ScoreBatcher(FailingEngine(), coalesce_window_s=0.0).start()
    with pytest.raises(RuntimeError, match="kaboom") as err:
        b.submit("a", "el2n", _imgs([1]), np.zeros(1, np.int32))
    failed = b.stats()["failed"]
    b.stop()
    return {"error": repr(err.value), "failed": failed}


def _heavy_before_second_light(r) -> int:
    order = [t for t, *_ in r["log"]]
    return order[:order.index("light", order.index("light") + 1)].count("heavy")


#: Each scenario with the property the JAX test pins on its outcome.
SCENARIOS = {
    "coalesce": (coalesce, lambda r: r["log"] == [("a", "el2n", 3)]
                 and r["out"] == {"r1": [1.0, 2.0], "r2": [3.0]}),
    "window_deadline": (window_deadline, lambda r: r["out"] == [7.0] and r["waited"]),
    "full_batch": (full_batch, lambda r: r["out"] == [1.0, 2.0, 3.0, 4.0] and r["fast"]),
    "split_rejoin": (split_rejoin, lambda r: [n for *_, n in r["log"]] == [4, 4, 2]
                     and r["out"] == [float(v) for v in range(10)]),
    "methods_apart": (methods_apart,
                      lambda r: sorted(m for _, m, _ in r["log"]) == ["el2n", "grand"]),
    "round_robin": (round_robin, lambda r: sorted(t for t, *_ in r["log"])
                    == ["a"] * 4 + ["b"] * 2
                    and max(i for i, (t, *_) in enumerate(r["log"]) if t == "b") <= 4),
    "weighted_round_robin": (weighted_round_robin, lambda r: _heavy_before_second_light(r) >= 2),
    "backpressure_draining": (backpressure_draining,
                              lambda r: r["retry_after_s"] == 3.0 and r["rejected"] == 1
                              and r["drained"] is True
                              and r["out"] == {"r1": [1.0], "r2": [2.0]}),
    "dispatch_failure": (dispatch_failure, lambda r: r["failed"] == 1),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_matches_jax_batcher(name):
    scenario, holds = SCENARIOS[name]
    want = scenario(jax_batcher)
    got = scenario(batcher)
    assert holds(want), want
    assert holds(got), got
    assert got == want
