# %% [markdown]
# # Data Diet scoring walkthrough
#
# Interactive counterpart to the reference's `test.ipynb` (its only "test"
# artifact — a manual replay of the scoring workflow: load a checkpointed model,
# run the EL2N loop, sort, keep the top half). Same journey here, on the
# PyTorch/CUDA port: each step below is one notebook cell (`# %%` markers — open
# in VS Code / Jupytext, or just run
# `python -m data_diet_distributed_tpu_torch.examples.walkthrough`).
#
# Runs on the card by default and on the CPU with `--device cpu` (tiny_cnn,
# ~a minute on one core); no datasets needed. From a source checkout, run it
# from the repo root (or with `PYTHONPATH=.`), or `pip install -e .` first.
# Options: `--device cuda|cpu`, `--arch` (model.arch), `--size`
# (data.synthetic_size). Without a card and without `--device cpu` it exits
# non-zero before it trains.

# %% Setup: the device, synthetic CIFAR-shaped data
import argparse

from data_diet_distributed_tpu_torch.config import load_config
from data_diet_distributed_tpu_torch.device import resolve_device
from data_diet_distributed_tpu_torch.models import create_model_from_cfg
from data_diet_distributed_tpu_torch.train.loop import fit, load_data_for

parser = argparse.ArgumentParser(
    prog="python -m data_diet_distributed_tpu_torch.examples.walkthrough",
    description="The Data Diet scoring walkthrough on the PyTorch port")
parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every cell runs (cuda: no fallback)")
# tiny_cnn keeps this runnable in ~a minute on one CPU core; on the card, pass
# --arch resnet18 --size 50000 — nothing else changes.
parser.add_argument("--arch", default="tiny_cnn", help="model.arch")
parser.add_argument("--size", type=int, default=2048, help="data.synthetic_size")
# A notebook kernel's own arguments are not ours: leave them be.
args, _ = parser.parse_known_args()
try:
    device = resolve_device(args.device)
except RuntimeError:
    raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU "
                     "(no fallback)") from None

cfg = load_config(None, [
    "data.dataset=synthetic", f"data.synthetic_size={args.size}", "data.batch_size=128",
    f"model.arch={args.arch}", "train.num_epochs=1", "train.half_precision=false",
    "train.log_every_steps=1000",
])
train_ds, test_ds = load_data_for(cfg)
print(f"device={device}  train={len(train_ds)} examples")

# %% Train briefly — scores are computed from an EARLY checkpoint (the paper
# scores at epoch ~10-20 of 200; the reference hard-loads ckpt_19.pth).
result = fit(cfg, train_ds, test_ds, device=device)
print(f"pretrain: {result.history[-1]}")

# %% Score every example: EL2N = ||softmax(f(x)) - onehot(y)||2 per example,
# on the card (the reference scored on ONE GPU, ddp.py:56).
from data_diet_distributed_tpu_torch.ops.scoring import score_dataset

model = create_model_from_cfg(cfg)
variables = result.state.variables
el2n = score_dataset(model, [variables], train_ds, method="el2n",
                     batch_size=256, device=device)
print(f"EL2N: mean={el2n.mean():.3f} std={el2n.std():.3f}")

# %% GraNd = per-example gradient norm over ALL parameters — the score the
# reference lacks. The batched exact algorithm (ops/grand_batched.py) computes
# it without per-example backwards.
grand = score_dataset(model, [variables], train_ds, method="grand",
                      batch_size=256, device=device)
print(f"GraNd: mean={grand.mean():.3f} std={grand.std():.3f}")

# %% Compare the two rankings. (On real data with enough pretraining they
# correlate strongly — the paper's observation; on randomly-labeled synthetic
# data after one epoch, expect noise.)
from data_diet_distributed_tpu_torch.utils.stats import spearman

print(f"spearman(EL2N, GraNd) = {spearman(el2n, grand):.3f}")

# %% Prune: keep the hardest half (the reference's sort + top-k,
# get_scores_and_prune.py:22-27, as one call).
from data_diet_distributed_tpu_torch.pruning import select_indices

kept = select_indices(grand, train_ds.indices, sparsity=0.5, keep="hardest")
subset = train_ds.subset(kept)
print(f"kept {len(subset)}/{len(train_ds)} hardest examples")

# %% Retrain a FRESH model on the pruned subset and evaluate.
retrain = fit(cfg, subset, test_ds, device=device,
              seed=cfg.train.seed + 1, tag="retrain")
print(f"retrain on 50%: test_accuracy={retrain.final_test_accuracy:.3f}")

# %% Forgetting-events scores (Toneva et al. 2019) — the third scoring method:
# train-and-track instead of score-from-checkpoint. The tracker counts
# correct->incorrect transitions per example across epochs.
import copy

from data_diet_distributed_tpu_torch.obs.metrics import MetricsLogger
from data_diet_distributed_tpu_torch.train.loop import forgetting_scores

cfg_f = copy.deepcopy(cfg)
cfg_f.score.method = "forgetting"
cfg_f.score.pretrain_epochs = 2
forget = forgetting_scores(cfg_f, train_ds, device=device,
                           log=MetricsLogger(None, echo=False))
# Never-learned examples sit at the sentinel (updates + 1), strictly above
# any possible event count (at most pretrain_epochs - 1 events).
print(f"forgetting: mean={forget.mean():.2f} events, "
      f"never-learned={(forget > cfg_f.score.pretrain_epochs).sum()}")

# %% AUM (Pleiss et al. 2020) rides the same trajectory hook: the mean
# probability margin across training epochs (higher = harder/mislabeled-ish).
from data_diet_distributed_tpu_torch.train.loop import trajectory_scores

cfg_a = copy.deepcopy(cfg)
cfg_a.score.method = "aum"
cfg_a.score.pretrain_epochs = 2
aum = trajectory_scores(cfg_a, train_ds, device=device,
                        log=MetricsLogger(None, echo=False))
print(f"aum: mean margin={aum.mean():+.3f}, "
      f"spearman(AUM, GraNd)={spearman(aum, grand):.3f}")

# %% The whole pipeline above is one config-driven call (or `python -m
# data_diet_distributed_tpu_torch.cli run ...`); a sparsity sweep shares one
# scoring pass across levels (`... cli sweep ...`):
# from data_diet_distributed_tpu_torch.train.loop import run_datadiet, run_sweep
# summary = run_datadiet(cfg, device=device)
# summaries = run_sweep(cfg_with_prune_sweep, device=device)
