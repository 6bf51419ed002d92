"""Per-region autotuning end to end on the PyTorch port (the paper's §4.2
vision) — ``examples/autotune_regions.py`` on ``repro_torch``.

Runs the greedy counter-driven tuner on a reduced hybrid model (zamba2:
SSM + shared-attention + MLP regions have different profiles), prints the
hypothesis -> measure -> accept/reject log, saves the winning plan to JSON
(PdtTagger's "config file"), trains a decision tree from the search
corpus, and exports the corpus as JSONL — the serve engine can merge it
(``python -m repro_torch.launch.serve --corpus-in``) and keep refining it
online.  Each candidate's train step is counted on the meta device and
scored by its roofline bound on the H100, so nothing runs on the card.

  PYTHONPATH=src python examples/autotune_regions_torch.py
  PYTHONPATH=src python examples/autotune_regions_torch.py --device cpu
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import make_generator, resolve_device  # noqa: E402
from repro_torch.autotune import Tuner  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.policy import RegionPlan  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCH = "zamba2-2.7b"


def make_batch(cfg, device) -> dict:
    """Tokens and labels (4, 128) from generators seeded 1 and 2."""
    def draw(seed):
        return torch.randint(0, cfg.vocab_size, (4, 128),
                             generator=make_generator(device, seed),
                             device=device, dtype=torch.int32)
    return {"tokens": draw(1), "labels": draw(2)}


def search(model, params, device):
    """The tuner's greedy search over the train step; returns its
    ``TuneResult``."""
    opt = adamw.init_state(params)
    batch = make_batch(model.cfg, device)

    def build_step(plan: RegionPlan):
        step = trainer.make_train_step(model, plan, unroll=False)
        return step, (params, opt, batch)

    return Tuner(kind="train", max_iters=4, verbose=True).autotune(
        build_step, mesh=None)


def report(result, out_dir: pathlib.Path) -> dict:
    """Print the summary and write the plan JSON and the corpus JSONL
    under ``out_dir``; returns their paths."""
    print(f"\nbaseline bound: {result.baseline_bound_s*1e3:.2f} ms")
    print(f"tuned bound:    {result.best_bound_s*1e3:.2f} ms "
          f"({result.baseline_bound_s/max(result.best_bound_s,1e-12):.2f}x)")
    print("\nchosen per-region configs:")
    for region, rc in result.plan.region_configs.items():
        knobs = {k: v for k, v in rc.to_json().items()
                 if v not in (0, False, {}, None, 1)}
        if knobs:
            print(f"  {region:20s} {knobs}")

    out_dir.mkdir(parents=True, exist_ok=True)
    plan_path = out_dir / "tuned_plan.json"
    plan_path.write_text(result.plan.to_json())
    print(f"\nplan saved to {plan_path} "
          f"(use: python -m repro_torch.launch.train --plan {plan_path})")

    tree = result.train_dtree()
    if tree is not None:
        print("decision tree trained on the search corpus "
              f"({len(result.corpus)} samples)")
    else:
        print("no decision tree: the search corpus holds "
              f"{len(result.corpus)} sample(s), a tree needs 2")

    corpus_path = out_dir / "tuned_corpus.jsonl"
    n = result.to_corpus().save_jsonl(str(corpus_path))
    print(f"search corpus saved to {corpus_path} ({n} entries) "
          "(use: python -m repro_torch.launch.serve --online-retrain "
          f"--corpus-in {corpus_path})")
    return {"plan": plan_path, "corpus": corpus_path, "entries": n}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the weights live on (cuda unless "
                         "asked)")
    ap.add_argument("--out-dir", default=str(ROOT / "build" / "examples"),
                    help="where the plan JSON and the corpus JSONL go")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = build(get_config(ARCH).reduced())
    params = model.init(0, device=dev)
    result = search(model, params, dev)
    return report(result, pathlib.Path(args.out_dir))


if __name__ == "__main__":
    main()
