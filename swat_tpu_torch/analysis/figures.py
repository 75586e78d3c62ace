# Copied from swat_tpu/analysis/figures.py, its ablate_table on the port's analysis.results; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Analysis figures & tables over run outputs (reference plots_tables/).

Ports the *capabilities* of the reference's paper-artifact scripts so the
same analyses run against this framework's outputs:

  head_tail_accuracy / stagewise_head_tail_row
      table3_stagewise_head_tail/get_head_tail_acc.py:173-196 — classes
      sorted by retrieved-image count, head = top 90%, tail = bottom 10%,
      accuracies from the per-class recall in stage score JSONs.
  head_weight_norms / plot_weight_norms
      same script's plot_norm (:8-38): per-class classifier-row norms
      before/after stage-2 probing, sorted by training count.
  plot_loss_curves
      fig4_no_overfit/plot_loss.py — Train_loss + Test_acc twin-axis plot
      from a run's loss.csv.
  retrieved_distribution / plot_retrieved_distribution
      fig3_imbalanced_distribution — per-class retrieved-count histogram.
  collect_stage_accs
      table4_ablate_SWAT/get_dataset_accuracy.py — walk output dirs and
      tabulate stage-1/2/3 test accuracies per dataset.

All plotting is optional (matplotlib imported lazily, Agg backend); every
function also returns the underlying arrays so tests and notebooks can
consume the numbers directly.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def class_counts_from_split(split_path: str) -> Dict[str, int]:
    """'path label is_fewshot' lines -> {class_id: count} (reference
    get_head_tail_acc.py:94-103)."""
    counts: Dict[str, int] = defaultdict(int)
    with open(split_path) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                counts[toks[-2]] += 1
    return dict(counts)


def head_tail_accuracy(scores: dict, counts: Dict[str, int],
                       head_frac: float = 0.9) -> Dict[str, float]:
    """Head/tail/overall accuracy from a stage scores dict
    (eval.metrics.calculate_scores output) + per-class counts.

    Classes sorted by count descending; head = first 90% (reference
    :173-194). Returns percentages."""
    recall = scores["per_class_recall"]
    num_classes = len(recall)
    order = sorted(range(num_classes),
                   key=lambda c: counts.get(str(c), 0), reverse=True)
    accs = [recall[str(c)] if str(c) in recall else recall[c]
            for c in order]
    head_len = int(head_frac * num_classes)
    head = accs[:head_len]
    tail = accs[head_len:]
    return {
        "head_acc": float(np.mean(head) * 100) if head else 0.0,
        "tail_acc": float(np.mean(tail) * 100) if tail else 0.0,
        "overall_acc": float(scores["acc"] * 100),
    }


def stagewise_head_tail_row(output_dir: str, counts: Dict[str, int],
                            head_frac: float = 0.9) -> Dict[str, float]:
    """One table-3 row for a run dir holding stage{1,2}_test_scores.json."""
    row: Dict[str, float] = {}
    for stage in (1, 2):
        path = os.path.join(output_dir, f"stage{stage}_test_scores.json")
        with open(path) as f:
            scores = json.load(f)
        ht = head_tail_accuracy(scores, counts, head_frac)
        for k, v in ht.items():
            row[f"stage{stage}_{k}"] = round(v, 1)
    return row


def head_weight_norms(head: np.ndarray,
                      counts: Optional[Dict[str, int]] = None
                      ) -> np.ndarray:
    """Per-class row norms of a classifier head [C, D]; when ``counts`` is
    given, returned in decreasing-training-count order (plot_norm's x
    axis)."""
    norms = np.linalg.norm(np.asarray(head), axis=-1)
    if counts is None:
        return norms
    order = sorted(range(norms.shape[0]),
                   key=lambda c: counts.get(str(c), 0), reverse=True)
    return norms[order]


def plot_weight_norms(norms_before: np.ndarray, norms_after: np.ndarray,
                      dataset: str, out_png: str):
    """plot_norm equivalent (get_head_tail_acc.py:8-38)."""
    plt = _plt()
    plt.figure(figsize=(10, 5))
    plt.plot(norms_before, alpha=0.8, label="Before probing", linewidth=2)
    plt.plot(norms_after, alpha=0.8, label="After probing", linewidth=2)
    plt.xlabel("Classes sorted by decreasing number of training images")
    plt.ylabel("Norm")
    plt.legend()
    plt.title(f"Norm of per-class weights of learned classifier - {dataset}")
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    plt.savefig(out_png, dpi=150)
    plt.close()


def read_loss_csv(loss_csv: str) -> Dict[str, np.ndarray]:
    """loss.csv -> column arrays (Epoch, Iter, Train_loss, Val_loss,
    Val_acc, Test_acc)."""
    cols: Dict[str, List[float]] = defaultdict(list)
    with open(loss_csv) as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                cols[k].append(float(v))
    return {k: np.asarray(v) for k, v in cols.items()}


def plot_loss_curves(loss_csv: str, out_png: Optional[str] = None
                     ) -> Dict[str, np.ndarray]:
    """Train-loss + test-acc twin-axis plot (fig4 plot_loss.py)."""
    cols = read_loss_csv(loss_csv)
    if out_png:
        plt = _plt()
        fig, ax1 = plt.subplots()
        ax1.set_xlabel("Epoch")
        ax1.set_ylabel("Train Loss", color="tab:blue")
        ax1.plot(cols["Train_loss"], color="tab:blue")
        ax2 = ax1.twinx()
        ax2.set_ylabel("Test acc", color="tab:red")
        ax2.plot(cols["Test_acc"], color="tab:red")
        fig.tight_layout()
        os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
        fig.savefig(out_png, dpi=150)
        plt.close(fig)
    return cols


def retrieved_distribution(split_path: str, num_classes: int
                           ) -> np.ndarray:
    """Per-class retrieved-count vector, sorted descending
    (fig3_imbalanced_distribution)."""
    counts = class_counts_from_split(split_path)
    vec = np.asarray([counts.get(str(c), 0) for c in range(num_classes)])
    return np.sort(vec)[::-1]


def plot_retrieved_distribution(split_path: str, num_classes: int,
                                out_png: str) -> np.ndarray:
    vec = retrieved_distribution(split_path, num_classes)
    plt = _plt()
    plt.figure(figsize=(8, 4))
    plt.bar(np.arange(vec.shape[0]), vec, width=1.0)
    plt.xlabel("Classes sorted by retrieved count")
    plt.ylabel("# retrieved images")
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    plt.savefig(out_png, dpi=150)
    plt.close()
    return vec


def collect_stage_accs(output_root: str) -> List[Dict[str, object]]:
    """Walk run dirs under output_root (output_{dataset}/{case_name}/) and
    tabulate per-stage test accuracies from stage{N}_test_scores.json
    (table4_ablate_SWAT/get_dataset_accuracy.py equivalent)."""
    rows: List[Dict[str, object]] = []
    for scores_path in sorted(glob.glob(os.path.join(
            output_root, "**", "stage1_test_scores.json"), recursive=True)):
        run_dir = os.path.dirname(scores_path)
        row: Dict[str, object] = {"run": os.path.basename(run_dir)}
        for stage in (1, 2, 3):
            p = os.path.join(run_dir, f"stage{stage}_test_scores.json")
            if os.path.exists(p):
                with open(p) as f:
                    row[f"stage{stage}_acc"] = round(
                        json.load(f)["acc"] * 100, 1)
        rows.append(row)
    return rows


def plot_ablation_curve(xs: Sequence[float],
                        series: Dict[str, Sequence[float]],
                        vline: Optional[float] = None,
                        vline_label: str = "",
                        xlabel: str = "", ylabel: str = "Accuracy (%)",
                        out_png: Optional[str] = None):
    """Generic parameter-sweep curve: the data-driven form of the
    reference's hardcoded fig_mixing_ratio/plot_mixing_ratio.py:8-35 and
    fig_stage1_epochs/plot_stage1_epochs.py:8-31 (per-dataset accuracy
    vs mixing ratio / stage-1 epochs with the chosen setting marked)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 2))
    for name, ys in series.items():
        ax.plot(xs, ys, label=name, marker="o", alpha=0.85)
    if vline is not None:
        ax.axvline(x=vline, color="red", linestyle="--")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    labels = list(series) + ([vline_label] if vline is not None else [])
    ax.legend(labels, loc="center right", fontsize="small")
    fig.tight_layout()
    if out_png:
        fig.savefig(out_png)
    plt.close(fig)
    return xs, series


def collect_sweep_accs(run_dirs: Dict[float, str],
                       stage: int = 2) -> Tuple[list, list]:
    """Accuracy-vs-parameter points for plot_ablation_curve from a sweep
    of run output dirs ({parameter value: run_dir})."""
    xs, ys = [], []
    for x in sorted(run_dirs):
        path = os.path.join(run_dirs[x], f"stage{stage}_test_scores.json")
        with open(path) as f:
            ys.append(json.load(f)["acc"] * 100)
        xs.append(x)
    return xs, ys


def plot_sorted_retrieved_counts(
        counts_by_dataset: Dict[str, Dict[str, int]],
        out_png: Optional[str] = None):
    """fig3_imbalanced_distribution/plot_imbalanced.py:40-92 — per
    dataset, classes sorted by retrieved-image count, log-y curve showing
    the natural imbalance of retrieval.  Input: the
    ``{prefix}_num_imgs_sampled.json`` dicts the sampler writes."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3))
    data = {}
    for name, counts in counts_by_dataset.items():
        ys = np.sort(np.asarray(list(counts.values())))[::-1]
        xs = np.linspace(0, 100, len(ys))   # percentile of classes
        ax.plot(xs, ys, label=name, linewidth=2)
        data[name] = ys
    ax.set_yscale("log")
    ax.set_xlabel("Sorted class percentile (%)")
    ax.set_ylabel("# retrieved images")
    ax.legend(fontsize="small")
    fig.tight_layout()
    if out_png:
        fig.savefig(out_png)
    plt.close(fig)
    return data


def plot_retraining_curves(loss_csvs: Dict[str, Sequence[str]],
                           column: str = "Test_acc",
                           out_png: Optional[str] = None):
    """fig4_no_overfit/plot_retraining_cls_acc_*.py — per-dataset
    mean +/- std accuracy across retraining epochs, aggregated over the
    seed runs' loss.csv files ({dataset: [loss.csv, ...]})."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3))
    out = {}
    for name, paths in loss_csvs.items():
        runs = [read_loss_csv(p)[column] for p in paths]
        n = min(len(r) for r in runs)
        arr = np.stack([np.asarray(r[:n], np.float64) for r in runs])
        mean, std = arr.mean(axis=0), arr.std(axis=0)
        epochs = np.arange(1, n + 1)
        ax.plot(epochs, mean, label=name, marker="o", markersize=3)
        ax.fill_between(epochs, mean - std, mean + std, alpha=0.2)
        out[name] = (mean, std)
    ax.set_xlabel("Retraining epochs")
    ax.set_ylabel(f"{column.replace('_', ' ')} (%)")
    ax.legend(fontsize="small")
    fig.tight_layout()
    if out_png:
        fig.savefig(out_png)
    plt.close(fig)
    return out


def plot_domain_gap(measured: Dict[str, Dict[str, float]],
                    out_png: Optional[str] = None):
    """fig2_domain_gap/plot_domain_gap.py — grouped per-dataset bars of
    method accuracies exposing the retrieval domain gap (zero-shot vs
    finetune-on-retrieved vs SWAT ...).  Input
    {method: {dataset: acc}}; the paper's own numbers are available from
    analysis.results.PAPER_TABLES for overlay."""
    plt = _plt()
    methods = list(measured)
    datasets = sorted({d for accs in measured.values() for d in accs})
    width = 0.8 / max(len(methods), 1)
    fig, ax = plt.subplots(figsize=(max(6, len(datasets)), 3))
    xs = np.arange(len(datasets))
    for i, m in enumerate(methods):
        ys = [measured[m].get(d, np.nan) for d in datasets]
        ax.bar(xs + i * width, ys, width, label=m)
    ax.set_xticks(xs + 0.4 - width / 2)
    ax.set_xticklabels(datasets, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("Test accuracy (%)")
    ax.legend(fontsize="small")
    fig.tight_layout()
    if out_png:
        fig.savefig(out_png)
    plt.close(fig)
    return datasets


def match_vs_download_counts(class_frequency: Dict[str, object],
                             download_counts: Dict[int, int]
                             ) -> Dict[int, Dict[str, int]]:
    """retrieval_analysis.ipynb cell 1 (lines 1-30) — join per-class
    string-match frequency with per-class downloaded-image counts, sorted
    by match frequency descending.  ``class_frequency`` accepts both the
    reference's nested ``{class: {"actual_freq": n}}`` JSON
    (laion_parser.py:231-233) and this repo's flat ``{class: n}``
    ``*_class_frequency.json``."""
    out = {}
    for k, v in class_frequency.items():
        freq = int(v["actual_freq"]) if isinstance(v, dict) else int(v)
        out[int(k)] = {"match_ct": freq,
                       "download_ct": int(download_counts.get(int(k), 0))}
    return dict(sorted(out.items(), key=lambda kv: kv[1]["match_ct"],
                       reverse=True))


def read_download_counts(path: str) -> Dict[int, int]:
    """Parse the notebook's ``download_ct.txt`` line format
    (``... <class_id> ... <count>`` — fields 1 and 3)."""
    counts = {}
    with open(path) as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) >= 4:
                counts[int(parts[1])] = int(parts[3])
    return counts


def plot_match_vs_download(class_frequency: Dict[str, object],
                           download_counts: Dict[int, int],
                           out_png: Optional[str] = None) -> np.ndarray:
    """retrieval_analysis.ipynb cell 1 (lines 32-60) — matched-caption vs
    downloaded-image counts per class, sorted by match frequency, log-y."""
    plt = _plt()
    joined = match_vs_download_counts(class_frequency, download_counts)
    match = np.asarray([v["match_ct"] for v in joined.values()])
    down = np.asarray([v["download_ct"] for v in joined.values()])
    fig, ax = plt.subplots(figsize=(5, 3))
    xs = np.arange(len(joined))
    ax.plot(xs, match, label="String Matching")
    ax.plot(xs, down, label="Downloaded")
    ax.set_yscale("log")
    ax.set_xlabel("Class")
    ax.set_ylabel("Frequency")
    ax.legend()
    fig.tight_layout()
    if out_png:
        fig.savefig(out_png)
    plt.close(fig)
    return np.stack([match, down])


def ablate_table(configs: Dict[str, str],
                 acc_col: str = "Stage2LPAcc") -> List[dict]:
    """table4_ablate_SWAT/get_dataset_accuracy.py:22-108 — one row per
    ablation config ({config name: results csv path}), mean accuracy per
    dataset across seeds plus the overall mean."""
    from swat_tpu_torch.analysis.results import aggregate, read_results_csv

    rows = []
    for name, csv_path in configs.items():
        agg = aggregate(read_results_csv(csv_path), acc_col=acc_col)
        row: Dict[str, object] = {"config": name}
        means = []
        for (dataset, shots), (mean, _std, _n) in sorted(agg.items()):
            row[f"{dataset}@{shots}"] = round(mean, 1)
            means.append(mean)
        row["mean"] = round(float(np.mean(means)), 1) if means else None
        rows.append(row)
    return rows


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="swat-tpu analysis figures")
    sub = p.add_subparsers(dest="cmd", required=True)

    ht = sub.add_parser("head-tail")
    ht.add_argument("--output_dir", required=True)
    ht.add_argument("--split", required=True,
                    help="retrieved split file for class counts")

    ls = sub.add_parser("loss-curve")
    ls.add_argument("--loss_csv", required=True)
    ls.add_argument("--out", required=True)

    dist = sub.add_parser("distribution")
    dist.add_argument("--split", required=True)
    dist.add_argument("--num_classes", type=int, required=True)
    dist.add_argument("--out", required=True)

    tab = sub.add_parser("stage-table")
    tab.add_argument("--output_root", required=True)

    im = sub.add_parser("imbalance")
    im.add_argument("--counts", nargs="+", required=True,
                    help="name=path pairs of *_num_imgs_sampled.json")
    im.add_argument("--out", required=True)

    mv = sub.add_parser("match-vs-download")
    mv.add_argument("--class_frequency", required=True,
                    help="*_class_frequency.json (flat or reference nested)")
    mv.add_argument("--download_ct", required=True,
                    help="download_ct.txt ('... <class> ... <count>' lines)")
    mv.add_argument("--out", required=True)

    at = sub.add_parser("ablate-table")
    at.add_argument("--configs", nargs="+", required=True,
                    help="name=results.csv pairs")
    at.add_argument("--acc_col", default="Stage2LPAcc")

    args = p.parse_args(argv)
    if args.cmd == "head-tail":
        counts = class_counts_from_split(args.split)
        print(json.dumps(stagewise_head_tail_row(args.output_dir, counts)))
    elif args.cmd == "loss-curve":
        plot_loss_curves(args.loss_csv, args.out)
        print(f"Wrote {args.out}")
    elif args.cmd == "imbalance":
        counts = {}
        for pair in args.counts:
            name, path = pair.split("=", 1)
            with open(path) as f:
                counts[name] = json.load(f)
        plot_sorted_retrieved_counts(counts, args.out)
        print(f"Wrote {args.out}")
    elif args.cmd == "match-vs-download":
        with open(args.class_frequency) as f:
            freq = json.load(f)
        plot_match_vs_download(freq, read_download_counts(args.download_ct),
                               args.out)
        print(f"Wrote {args.out}")
    elif args.cmd == "ablate-table":
        configs = dict(pair.split("=", 1) for pair in args.configs)
        for row in ablate_table(configs, acc_col=args.acc_col):
            print(json.dumps(row))
    elif args.cmd == "distribution":
        plot_retrieved_distribution(args.split, args.num_classes, args.out)
        print(f"Wrote {args.out}")
    elif args.cmd == "stage-table":
        for row in collect_stage_accs(args.output_root):
            print(json.dumps(row))


if __name__ == "__main__":
    main()
