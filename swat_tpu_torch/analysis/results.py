# Copied from swat_tpu/analysis/results.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Result aggregation & baseline comparison.

The reference ships analysis scripts over result CSVs plus the paper's
hard-coded accuracy tables (reference plots_tables/fig2_domain_gap/
benchmark.py).  Here: parse the harness CSVs (scripts/*.sh output), average
over seeds, tabulate per dataset x shots, and diff against the published
SWAT numbers (BASELINE.md) to check the ±0.5% reproduction bar.

Usage:
    python -m swat_tpu_torch.analysis.results --results_dir results/swat_vitb32_T2T500
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

# SWAT (T2T500) paper accuracies, 4/8/16-shot (BASELINE.md, from the
# reference's plots_tables/fig2_domain_gap/benchmark.py:123-135)
SWAT_PAPER = {
    "semi-aves": (58.5, 61.3, 63.1),
    "flowers102": (90.6, 94.1, 96.4),
    "fgvc-aircraft": (55.7, 59.1, 62.4),
    "eurosat": (83.4, 88.7, 92.9),
    "dtd": (58.3, 62.6, 66.3),
    "oxford_pets": (91.3, 91.5, 91.6),
    "food101": (77.3, 77.6, 78.3),
    "stanford_cars": (81.1, 83.5, 85.4),
    "imagenet": (65.8, 66.6, 67.6),
}

ZEROSHOT_PAPER = {  # OpenCLIP ZS / REAL-Prompt (benchmark.py:29-53)
    "dtd": (53.5, 59.2), "eurosat": (51.1, 56.9),
    "fgvc-aircraft": (17.1, 18.0), "flowers102": (68.2, 76.0),
    "semi-aves": (8.4, 43.4), "oxford_pets": (88.7, 88.7),
    "food101": (77.2, 77.1), "stanford_cars": (79.2, 80.6),
    "imagenet": (63.0, 63.6),
}

# Every remaining published table from benchmark.py (4/8/16-shot tuples;
# scalars for the shot-independent rows), dataset keys normalized to this
# repo's registry names (pets->oxford_pets, food->food101,
# cars->stanford_cars).  These are the acceptance targets themselves —
# they must match the paper verbatim.
REAL_LINEAR_PAPER = {  # benchmark.py:55-66 (shot-independent)
    "dtd": 61.0, "eurosat": 51.5, "fgvc-aircraft": 27.3,
    "flowers102": 79.4, "semi-aves": 49.2, "oxford_pets": 89.7,
    "food101": 78.0, "stanford_cars": 81.7, "imagenet": 65.5,
}

CMLP_PAPER = {  # crossmodal_map, benchmark.py:69-80 (50ep, no WiSE-FT)
    "dtd": (62.2, 67.2, 71.9), "eurosat": (74.8, 80.6, 85.2),
    "fgvc-aircraft": (25.1, 27.9, 32.4), "flowers102": (88.9, 92.5, 95.5),
    "semi-aves": (29.1, 38.8, 46.8), "oxford_pets": (88.3, 88.8, 89.1),
    "food101": (76.7, 77.3, 77.5), "stanford_cars": (80.7, 82.7, 84.7),
    "imagenet": (63.2, 63.1, 63.1),
}

CLAP_PAPER = {  # clap_map, benchmark.py:83-94
    "dtd": (63.0, 66.4, 69.9), "eurosat": (74.7, 77.4, 81.7),
    "fgvc-aircraft": (28.0, 33.6, 39.1), "flowers102": (90.1, 92.9, 94.8),
    "semi-aves": (34.0, 42.9, 49.2), "oxford_pets": (87.0, 87.8, 88.4),
    "food101": (76.7, 77.5, 78.5), "stanford_cars": (84.9, 86.1, 87.8),
    "imagenet": (64.0, 65.6, 67.1),
}

FT_FEWSHOT_PAPER = {  # ft_fs_map (FTFS w/ CutMix), benchmark.py:97-108
    "semi-aves": (48.0, 52.3, 56.5), "flowers102": (92.2, 95.2, 97.1),
    "fgvc-aircraft": (28.8, 35.4, 42.7), "eurosat": (81.8, 89.4, 94.3),
    "dtd": (66.7, 70.6, 73.4), "oxford_pets": (89.0, 89.6, 89.6),
    "food101": (76.1, 77.0, 78.2), "stanford_cars": (82.5, 85.3, 87.8),
    "imagenet": (62.4, 64.8, 66.9),
}

FT_RETRIEVED_PAPER = {  # ft_retr_map, benchmark.py:110-120 (shot-indep)
    "semi-aves": 52.1, "flowers102": 81.6, "fgvc-aircraft": 48.3,
    "eurosat": 27.9, "dtd": 53.3, "oxford_pets": 90.3, "food101": 75.7,
    "stanford_cars": 75.3, "imagenet": 60.9,
}

SWAT_PLUS_PAPER = {  # swat_plus_map, benchmark.py:138-149 (stage-2 FSFT)
    "semi-aves": (59.9, 62.7, 64.7), "flowers102": (94.2, 96.7, 98.3),
    "fgvc-aircraft": (55.6, 56.8, 60.2), "eurosat": (83.4, 89.7, 93.5),
    "dtd": (61.5, 67.0, 69.8), "oxford_pets": (91.6, 91.9, 92.2),
    "food101": (77.9, 78.4, 79.1), "stanford_cars": (83.7, 87.0, 89.2),
    "imagenet": (66.6, 68.1, 69.3),
}

SWAT_IMPROVED_PAPER = {  # swat_improved_map (T2T10), benchmark.py:152-157
    "dtd": (63.5, 69.1, 72.9), "stanford_cars": (83.5, 86.8, 88.6),
    "flowers102": (91.8, 95.2, 97.0), "eurosat": (84.7, 90.0, 94.0),
}

PAPER_TABLES = {
    "swat": SWAT_PAPER,
    "swat+": SWAT_PLUS_PAPER,
    "swat-improved": SWAT_IMPROVED_PAPER,
    "cmlp": CMLP_PAPER,
    "clap": CLAP_PAPER,
    "ft-fewshot": FT_FEWSHOT_PAPER,
    "ft-retrieved": FT_RETRIEVED_PAPER,
    "real-linear": REAL_LINEAR_PAPER,
}

SHOT_INDEX = {4: 0, 8: 1, 16: 2}


def read_results_csv(path: str) -> List[dict]:
    with open(path) as f:
        reader = csv.DictReader(f)
        return [row for row in reader if row.get("Dataset")]


def aggregate(rows: List[dict], acc_col: str = "Stage2LPAcc"
              ) -> Dict[Tuple[str, int], Tuple[float, float, int]]:
    """(dataset, shots) -> (mean, std, n) over seeds."""
    groups: Dict[Tuple[str, int], List[float]] = defaultdict(list)
    for row in rows:
        try:
            acc = float(row[acc_col])
            shots = int(row["Shots"])
        except (KeyError, ValueError):
            continue
        if acc < 0:
            continue
        groups[(row["Dataset"], shots)].append(acc)
    return {k: (float(np.mean(v)), float(np.std(v)), len(v))
            for k, v in groups.items()}


def compare_to_paper(agg, tolerance: float = 0.5,
                     table: str = "swat") -> List[str]:
    """Diff aggregated results against a published table (PAPER_TABLES).
    Shot-independent tables (real-linear, ft-retrieved) use their scalar
    for every shot count."""
    paper_map = PAPER_TABLES[table]
    lines = ["dataset        shots  ours(mean±std)  paper   delta  within±0.5"]
    deltas = []
    for (ds, shots), (mean, std, n) in sorted(agg.items()):
        paper = None
        cell = paper_map.get(ds)
        if isinstance(cell, tuple) and shots in SHOT_INDEX:
            paper = cell[SHOT_INDEX[shots]]
        elif isinstance(cell, (int, float)):
            paper = float(cell)
        if paper is None:
            lines.append(f"{ds:14s} {shots:5d}  {mean:5.1f}±{std:4.1f}"
                         f" (n={n})   --")
            continue
        delta = mean - paper
        deltas.append(delta)
        ok = "yes" if abs(delta) <= tolerance else "NO"
        lines.append(f"{ds:14s} {shots:5d}  {mean:5.1f}±{std:4.1f} (n={n})"
                     f"  {paper:5.1f}  {delta:+5.1f}  {ok}")
    if deltas:
        lines.append(f"mean delta: {np.mean(deltas):+.2f} over "
                     f"{len(deltas)} cells")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--results_dir", required=True)
    p.add_argument("--acc_col", default="Stage2LPAcc",
                   help="Stage1Acc | WSFTAcc | Stage2LPAcc | Stage2FSFTAcc")
    p.add_argument("--tolerance", type=float, default=0.5)
    p.add_argument("--paper_table", default="swat",
                   choices=sorted(PAPER_TABLES),
                   help="published table to diff against "
                        "(benchmark.py's per-method maps)")
    args = p.parse_args(argv)

    rows: List[dict] = []
    for fn in sorted(os.listdir(args.results_dir)):
        if fn.endswith(".csv"):
            rows.extend(read_results_csv(os.path.join(args.results_dir, fn)))
    agg = aggregate(rows, args.acc_col)
    for line in compare_to_paper(agg, args.tolerance,
                                 table=args.paper_table):
        print(line)


if __name__ == "__main__":
    main()
