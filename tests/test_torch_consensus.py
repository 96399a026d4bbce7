"""The PyTorch port's consensus drills at two processes over gloo (the drills
``tests/test_consensus_multihost.py`` runs for the JAX package).

Two launches of ``torch_dist_worker.py`` on tiny_cnn, 64 examples, 4 steps
an epoch, ``resilience.consensus_grace_s=1``: ``drills`` runs the rank-1
SIGTERM and its resume, the rank-1 NaN through ``fit_with_recovery``, and
the min-agreed restore in one process group; ``hang`` hangs rank 1 and
bounds both exits.
"""

import json
import os
import time

import pytest

from test_torch_dist import launch, wait

EXIT_RETRIABLE = 69


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    out = tmp_path_factory.mktemp("drills")
    rcs, logs = wait(launch(out, "drills"), out, "drills")
    assert rcs == [0, 0], logs
    runs = []
    for r in range(2):
        with open(out / f"result_{r}.json") as fh:
            runs.append({run["scenario"]: run for run in json.load(fh)["runs"]})
    return runs


def test_rank1_sigterm_preempts_both_ranks_at_one_step_and_resumes(drills):
    """A SIGTERM to rank 1 after epoch 0: both ranks leave with ``Preempted``
    at step 4, durable at step 4; the resume restores the agreed step 4 on both
    and runs epochs 1-2 to step 12, the ranks' parameters equal."""
    for runs in drills:
        pre = runs["sigterm"]
        assert (pre["outcome"], pre["step"], pre["durable_step"], pre["epoch"]) == (
            "preempted", 4, 4, 0)
        res = runs["sigterm:resume"]
        assert res["outcome"] == "completed" and res["restore_agreed"] == [4]
        assert res["epochs_run"] == [1, 2] and res["final_step"] == 12
    assert drills[0]["sigterm:resume"]["params_digest"] == \
        drills[1]["sigterm:resume"]["params_digest"]


def test_rank1_nan_diverges_on_both_ranks_and_recovery_refuses(drills):
    """A NaN loss on rank 1 at epoch 1: ``DivergenceError`` on both ranks at
    epoch 1 (rank 0's ``remote``), and ``fit_with_recovery`` refuses an
    in-process retry across ranks (``recovery_refused``)."""
    for rank, runs in enumerate(drills):
        nan = runs["nan"]
        assert (nan["outcome"], nan["epoch"], nan["remote"]) == ("divergence", 1, rank == 0)
        assert nan["kinds"][-1] == "recovery_refused" and "fault" in nan["kinds"]


def test_hidden_newest_checkpoint_restores_the_min_agreed_step(drills):
    """Rank 1's newest verified step (8) hidden: both ranks restore step 4 and
    re-run epoch 1 alone."""
    for runs in drills:
        assert runs["restore"]["final_step"] == 8
        res = runs["restore:resume"]
        assert res["restore_agreed"] == [4]
        assert res["epochs_run"] == [1] and res["final_step"] == 8


def test_rank1_hang_poisons_and_both_ranks_exit_bounded(tmp_path):
    """Rank 1 hangs before step 5 for 600 s under a 2-s step watchdog, while
    rank 0 waits in that step's first collective: both deadlines run out about
    together, so the first poison is either rank's. Rank 1's sleep is broken
    by a ``WatchdogTimeout`` or the peer's ``PeerPoisoned`` and it exits 69;
    rank 0 exits 69 (the poison, its watchdog's escalation after the 1-s
    grace, or the collective torn by the peer's exit); both within 60 s."""
    t0 = time.monotonic()
    rcs, logs = wait(launch(tmp_path, "hang"), tmp_path, "hang", timeout=100.0)
    wall = time.monotonic() - t0
    assert rcs == [EXIT_RETRIABLE, EXIT_RETRIABLE], logs
    assert wall < 60
    with open(tmp_path / "result_1.json") as fh:
        r1 = json.load(fh)
    assert r1["outcome"] == "aborted" and "no heartbeat within 2s" in r1["error"]
    assert os.listdir(tmp_path / "hang_sidechannel")
