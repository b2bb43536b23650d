"""Collect the port's pipeline-eval summaries into a results table and a
results record (the counterpart of tools/collect_results.py for
unetseg_tpu_torch; it imports nothing of the JAX package).

Usage: python tools/collect_results_torch.py EVAL_DIR [--latest PATH]
           [--ship ROW] [--run-dirs DIR,DIR,...] [--config RECIPE]

Prints a markdown table of every eval row under EVAL_DIR (a directory
holding summary.json: s0/s1/s2/ens/flagship/...) with per-sequence
SEG/TRA/DET and the 3-seed means, as tools/collect_results.py prints it.
With --latest it writes the record there (tools/reproduce_flagship_torch.sh
passes docs/results_torch_latest.json, the file
`python -m unetseg_tpu_torch bench` reads; never docs/results_latest.json,
the JAX package's). The record keeps tools/collect_results.py's rules:
the top-level seg/tra keys always carry the shipped row ("flagship" if
present, else "ens", or --ship), and seed means alone may start a record
but never replace its headline nor re-stamp its provenance. Its
provenance names the package, the recipe's hash, the eval date, the
checkpoint directories and the card with its power limit, read from
EVAL_DIR/device.txt; without that file it refuses to publish.
"""
import json
import os
import statistics
import sys
from datetime import date

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from unetseg_tpu_torch.utils.provenance import recipe_hash  # noqa: E402

PACKAGE = "unetseg_tpu_torch"
RECIPE = os.path.join(REPO, "configs", "best_recipe.json")


def read_runs(eval_dir: str) -> dict:
    runs = {}
    for name in sorted(os.listdir(eval_dir)):
        p = os.path.join(eval_dir, name, "summary.json")
        if os.path.isfile(p):
            with open(p) as f:
                runs[name] = json.load(f)
    if not runs:
        raise SystemExit(f"no summaries under {eval_dir}")
    return runs


def vals_of(s: dict) -> list:
    return [s.get(q, {}).get(m) for q in ("01", "02") for m in ("SEG", "TRA", "DET")]


def print_table(runs: dict):
    """The table; returns the seed rows' (mean, sd) per column, or
    (None, None) without two complete seed rows."""
    cols = ["01 SEG", "01 TRA", "01 DET", "02 SEG", "02 TRA", "02 DET"]
    print("| run | " + " | ".join(cols) + " |")
    print("|" + "---|" * (len(cols) + 1))
    for name, s in runs.items():
        cells = [f"{v:.4f}" if v is not None else "—" for v in vals_of(s)]
        print(f"| {name} | " + " | ".join(cells) + " |")
    cols_v = [vals_of(runs[n]) for n in ("s0", "s1", "s2") if n in runs]
    if len(cols_v) < 2 or any(v is None for c in cols_v for v in c):
        return None, None
    mean = [statistics.mean(c[i] for c in cols_v) for i in range(6)]
    sd = [statistics.pstdev(c[i] for c in cols_v) for i in range(6)]
    print("| seed mean | " + " | ".join(f"{m:.4f}±{s:.4f}" for m, s in zip(mean, sd)) + " |")
    return mean, sd


def read_device(eval_dir: str) -> str:
    """The card's "name, power limit" line that the eval ran on."""
    path = os.path.join(eval_dir, "device.txt")
    lines = []
    if os.path.isfile(path):
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    if not lines:
        raise SystemExit(f"refusing to publish {eval_dir}: no device.txt naming the card "
                         "(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)")
    return lines[0]


def update_record(latest: dict, runs: dict, mean, sd, eval_dir: str, ship: str, run_dirs,
                  device: str, recipe: str) -> dict:
    """tools/collect_results.py's record rules over `latest` (changed in
    place and returned)."""
    n_seeds = sum(1 for n in ("s0", "s1", "s2") if n in runs)
    round_key = os.path.basename(os.path.normpath(eval_dir))
    if mean is not None:
        smm = latest.get("single_model_3seed_means") or {}
        smm[round_key] = {
            "seg_seq01": round(mean[0], 4), "tra_seq01": round(mean[1], 4),
            "seg_seq02": round(mean[3], 4), "tra_seq02": round(mean[4], 4),
            "spread_seg_seq02": round(sd[3], 4),
        }
        latest["single_model_3seed_means"] = smm
    if ship and ship not in runs:
        raise SystemExit(f"--ship {ship}: no such eval row under {eval_dir}")
    shipped = ship or next((n for n in ("flagship", "ens") if n in runs), None)
    headline_exists = "seg_seq01" in latest
    top_updated = shipped is not None or (mean is not None and not headline_exists)
    recipe_name = os.path.relpath(recipe, REPO) if recipe.startswith(REPO) else recipe
    if shipped is not None:
        v = vals_of(runs[shipped])
        latest.update({
            "seg_seq01": v[0], "tra_seq01": v[1], "seg_seq02": v[3], "tra_seq02": v[4],
            "source": (f"shipped config ({recipe_name}): '{shipped}' eval row, pipeline eval "
                       f"by {PACKAGE} at {eval_dir} on {device}"),
        })
    elif mean is not None and not headline_exists:
        latest.update({
            "seg_seq01": round(mean[0], 4), "tra_seq01": round(mean[1], 4),
            "seg_seq02": round(mean[3], 4), "tra_seq02": round(mean[4], 4),
            "source": (f"{n_seeds}-seed {recipe_name} SINGLE-MODEL means by {PACKAGE} (no "
                       f"flagship/ens row under {eval_dir}) on {device}: below the shipped "
                       f"ensemble config's numbers"),
        })
    if "ens" in runs:
        e = vals_of(runs["ens"])
        latest["ensemble"] = {"seg_seq01": e[0], "tra_seq01": e[1],
                              "seg_seq02": e[3], "tra_seq02": e[4]}
    if top_updated:
        # stamp only when the headline was refreshed: re-stamping on a side
        # collection would mark stale numbers current
        latest["eval_date"] = date.today().isoformat()
        latest["recipe_hash"] = recipe_hash(recipe)
        latest["package"] = PACKAGE
        latest["device"] = device
        if run_dirs:
            latest["checkpoint_dirs"] = [os.path.abspath(d) for d in run_dirs]
    latest["note"] = (f"machine-readable record of the latest shipped-recipe CTC evaluation "
                      f"by {PACKAGE}, written by tools/collect_results_torch.py")
    return latest


def main(eval_dir: str, latest_path=None, run_dirs=None, ship: str = "",
         recipe: str = RECIPE) -> None:
    runs = read_runs(eval_dir)
    mean, sd = print_table(runs)
    if latest_path is None:
        return
    if os.path.abspath(latest_path) == os.path.join(REPO, "docs", "results_latest.json"):
        raise SystemExit("refusing to write docs/results_latest.json: it is the JAX "
                         "package's record")
    device = read_device(eval_dir)
    latest = {}
    if os.path.isfile(latest_path):
        with open(latest_path) as f:
            latest = json.load(f)
    update_record(latest, runs, mean, sd, eval_dir, ship, run_dirs, device, recipe)
    os.makedirs(os.path.dirname(os.path.abspath(latest_path)), exist_ok=True)
    with open(latest_path, "w") as f:
        json.dump(latest, f, indent=1)
        f.write("\n")
    print(f"\nwrote {latest_path}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("eval_dir")
    ap.add_argument("--latest", default=None,
                    help="write the record here (e.g. docs/results_torch_latest.json)")
    ap.add_argument("--run-dirs", default=None,
                    help="comma-separated checkpoint dirs recorded as provenance")
    ap.add_argument("--ship", default="", help="eval row to publish as the top-level numbers")
    ap.add_argument("--config", default=RECIPE, help="the recipe the eval ran, hashed")
    a = ap.parse_args()
    main(a.eval_dir, latest_path=a.latest,
         run_dirs=[d for d in (a.run_dirs or "").split(",") if d] or None,
         ship=a.ship, recipe=a.config)
