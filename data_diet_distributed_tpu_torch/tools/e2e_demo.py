"""End-to-end Data Diet demonstration: dense vs pruned-retrain accuracy sweep.

The port's copy of ``tools/e2e_demo.py``: the same three legs, arguments,
``summary.jsonl`` rows and headline line, run without JAX, with
``--platform cpu|tpu`` as ``--device cuda|cpu``. The claim the framework
exists for: score once, prune a large fraction of the training set keeping
the hardest examples, retrain from scratch, and lose little accuracy while
beating a random subset of the same size. Three CLI invocations, each
``python -m data_diet_distributed_tpu_torch.cli … --device <d>``:

1. ``cli train``: the dense baseline;
2. ``cli sweep``: ONE scoring pass, then prune and retrain per sparsity
   level, keeping hardest (the paper's policy);
3. ``cli sweep``: the same levels with ``prune.keep=random``, REUSING the
   first sweep's scores (``score.scores_npz``), so the comparison is
   score-for-score identical and costs no second scoring pass.

Writes ``<out>/summary.jsonl`` (one row per trained model) and, where
matplotlib is installed, ``<out>/accuracy_vs_sparsity.png``, and prints one
JSON line with the headline comparison at the middle sparsity.

The device is ``cuda`` unless ``--device cpu``; without a card the tool
exits non-zero before any child starts, and a child that fails fails the
tool. Nothing falls back to the CPU. The children run in ``--workdir``, so
their default files (traces, ledgers) land there.

CPU (small tier)::

    python -m data_diet_distributed_tpu_torch.tools.e2e_demo --device cpu \\
        --size 8192 --epochs 12 --arch resnet18 --out artifacts/e2e_demo

Card (the full tier, BASELINE geometry, 64 Zipf clusters a class)::

    python -m data_diet_distributed_tpu_torch.tools.e2e_demo --size 50000 \\
        --epochs 30 --noise 0.5 --clusters 64 --arch resnet18 --half-precision \\
        --workdir /tmp/e2e_demo --out /tmp/e2e_demo/out
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

from .autotune import _child_env, device_error


def run_cli(command: str, overrides: list[str], device: str, workdir: str,
            env: dict[str, str], timeout: int) -> None:
    cmd = [sys.executable, "-m", "data_diet_distributed_tpu_torch.cli", command,
           *overrides, "--device", device]
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, cwd=workdir, timeout=timeout)
    if proc.returncode != 0:
        raise SystemExit(f"{command} failed rc={proc.returncode}: {overrides}")
    print(f"[e2e_demo] {command} done in {time.time() - t0:.0f}s", flush=True)


def read_records(metrics_path: str, kind: str) -> list[dict]:
    out = []
    with open(metrics_path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") == kind:
                out.append(rec)
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m data_diet_distributed_tpu_torch.tools.e2e_demo",
        description="Dense baseline, keep-hardest sweep, keep-random sweep on "
                    "the hardest sweep's scores")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="every child's --device (cuda: no fallback)")
    parser.add_argument("--size", type=int, default=8192)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--pretrain-epochs", type=int, default=2,
                        help="dense epochs before the scoring pass (the "
                             "reference scores at ~10%% of its recipe)")
    parser.add_argument("--arch", default="resnet18")
    parser.add_argument("--noise", type=float, default=0.4,
                        help="data.synthetic_noise (per-pixel std)")
    parser.add_argument("--clusters", type=int, default=1,
                        help="data.synthetic_clusters (>1: Zipf mixture per "
                             "class — the sample-starved regime where pruning "
                             "policy matters; 1 is ceiling-easy at 50k)")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--score-method", default="el2n")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0],
                        help="scoring seeds (paper averages 10)")
    parser.add_argument("--sparsities", type=float, nargs="+",
                        default=[0.3, 0.5, 0.7])
    parser.add_argument("--half-precision", action="store_true")
    parser.add_argument("--workdir", default="/tmp/e2e_demo")
    parser.add_argument("--out", default="artifacts/e2e_demo")
    parser.add_argument("--timeout", type=int, default=4 * 3600,
                        help="per-CLI-invocation timeout (seconds)")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    err = device_error(args.device)
    if err:
        raise SystemExit(err)

    env = _child_env({})
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    # MetricsLogger appends and read_records collects every matching row, and
    # a stale checkpoint dir would resume mid-recipe — a rerun in the same
    # workdir must start from a clean slate.
    for sub in ("dense", "hard", "rand"):
        # Sweep outputs are SIBLINGS of the checkpoint dir ({dir}_s0p5/,
        # {dir}_s0p5_scores.npz — train.loop.sweep_level_dir/scores_npz_path),
        # so the clean slate must cover {sub}_* as well as {sub}/.
        shutil.rmtree(os.path.join(wd, sub), ignore_errors=True)
        for stale in glob.glob(os.path.join(wd, f"{sub}_*")):
            if os.path.isdir(stale):
                shutil.rmtree(stale, ignore_errors=True)
            else:
                os.unlink(stale)
    for m in ("metrics_dense.jsonl", "metrics_hard.jsonl",
              "metrics_rand.jsonl"):
        with open(os.path.join(wd, m), "w"):
            pass
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)

    common = [
        "data.dataset=synthetic", f"data.synthetic_size={args.size}",
        f"data.synthetic_noise={args.noise}",
        f"data.synthetic_clusters={args.clusters}",
        f"data.batch_size={args.batch}", f"data.eval_batch_size={args.batch}",
        f"model.arch={args.arch}", f"optim.lr={args.lr}",
        f"train.num_epochs={args.epochs}",
        f"train.half_precision={str(args.half_precision).lower()}",
        "train.device_resident_data=true", "train.log_every_steps=100000",
        # Only the final-epoch checkpoint (saved unconditionally).
        "train.checkpoint_every=100000",
        f"score.method={args.score_method}",
        f"score.seeds=[{','.join(str(s) for s in args.seeds)}]",
        f"score.pretrain_epochs={args.pretrain_epochs}",
        f"score.batch_size={args.batch}",
    ]
    sweep = "prune.sweep=[" + ",".join(str(s) for s in args.sparsities) + "]"
    t_start = time.time()

    def leg(command: str, *over: str) -> None:
        run_cli(command, common + list(over), args.device, wd, env, args.timeout)

    # 1. Dense baseline.
    m_dense = f"{wd}/metrics_dense.jsonl"
    leg("train", f"train.checkpoint_dir={wd}/dense", f"obs.metrics_path={m_dense}")

    # 2. Keep-hardest sweep (scores computed once, here).
    m_hard = f"{wd}/metrics_hard.jsonl"
    leg("sweep", sweep, "prune.keep=hardest", f"train.checkpoint_dir={wd}/hard",
        f"obs.metrics_path={m_hard}")

    # 3. Keep-random sweep, reusing the hardest sweep's scores artifact so no
    #    second pretrain+scoring pass is paid.
    from ..train.loop import scores_npz_path, sweep_level_dir
    scores_npz = scores_npz_path(sweep_level_dir(f"{wd}/hard", args.sparsities[0]))
    m_rand = f"{wd}/metrics_rand.jsonl"
    leg("sweep", sweep, "prune.keep=random", f"score.scores_npz={scores_npz}",
        f"train.checkpoint_dir={wd}/rand", f"obs.metrics_path={m_rand}")

    # Assemble the artifact rows. The dense run's final test accuracy lives in
    # its last tagged epoch record, so read the epoch stream.
    rows = []
    evals = [r for r in read_records(m_dense, "epoch") if "test_accuracy" in r]
    if not evals:
        raise SystemExit("dense run produced no test_accuracy epochs")
    dense_acc = float(evals[-1]["test_accuracy"])
    rows.append({"keep": "dense", "sparsity": 0.0,
                 "final_test_accuracy": dense_acc})
    for keep, path in (("hardest", m_hard), ("random", m_rand)):
        for s in read_records(path, "summary"):
            rows.append({"keep": keep, "sparsity": float(s["sparsity"]),
                         "final_test_accuracy": float(s["final_test_accuracy"]),
                         "n_kept": s.get("n_kept"),
                         "score_method": s.get("score_method"),
                         "train_wall_s": s.get("train_wall_s")})

    config = {**vars(args), "total_wall_s": round(time.time() - t_start, 1)}
    with open(f"{out_dir}/summary.jsonl", "w") as fh:
        fh.write(json.dumps({"kind": "config", **config}) + "\n")
        for row in rows:
            fh.write(json.dumps(row) + "\n")

    png = plot(rows, out_dir, config)

    by = {(r["keep"], r["sparsity"]): r["final_test_accuracy"] for r in rows}
    mid = args.sparsities[len(args.sparsities) // 2]
    headline = {
        "dense_accuracy": dense_acc,
        f"hardest@{mid}": by.get(("hardest", mid)),
        f"random@{mid}": by.get(("random", mid)),
        "hardest_beats_random_at_mid": (
            by.get(("hardest", mid), 0) >= by.get(("random", mid), 1)),
        "summary": f"{out_dir}/summary.jsonl", "plot": png,
        "total_wall_s": config["total_wall_s"],
    }
    print(json.dumps(headline), flush=True)
    return headline


def plot(rows: list[dict], out_dir: str, config: dict) -> str | None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    fig, ax = plt.subplots(figsize=(6, 4))
    dense = [r for r in rows if r["keep"] == "dense"][0]
    ax.axhline(dense["final_test_accuracy"], color="0.4", ls="--", lw=1,
               label=f"dense ({dense['final_test_accuracy']:.3f})")
    for keep, color in (("hardest", "tab:blue"), ("random", "tab:orange")):
        pts = sorted([(r["sparsity"], r["final_test_accuracy"])
                      for r in rows if r["keep"] == keep])
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "o-",
                    color=color, label=f"keep {keep}")
    ax.set_xlabel("sparsity (fraction of training data pruned)")
    ax.set_ylabel("final test accuracy")
    ax.set_title(f"Data Diet: {config['arch']} on synthetic-{config['size']}, "
                 f"{config['epochs']} epochs, {config['score_method']}")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    path = f"{out_dir}/accuracy_vs_sparsity.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


if __name__ == "__main__":
    main()
