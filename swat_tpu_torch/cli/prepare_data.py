# Copied from swat_tpu/cli/prepare_data.py, its create command on the port's data.creators; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Data preparation CLIs.

* ``fewshot``  — sample ``fewshot{K}_seed{S}.txt`` files from a dataset's
  train split (reference prepare_fewshot_txt.py:26-105): per-class random
  sample of K paths, all paths kept when a class has < K, source flag 1.
* ``labels``   — build ``train/val/test.txt`` label files from CoOp-style
  split JSONs (reference prepare_datasets_labels.py:4-45): entries
  ``[path, label, classname]`` per split, lines ``{prefix}{path} {label} 1``
  sorted by label.
* ``cleanup``  — delete cached pre-extracted features / prompt tensors
  (reference clean_up.py).

Usage:
    python -m swat_tpu_torch.cli.prepare_data fewshot --dataset semi-aves \
        --shots 4 8 16 --seeds 1 2 3
    python -m swat_tpu_torch.cli.prepare_data labels --dataset oxford_pets \
        --split_json split_zhou_OxfordPets.json --prefix images/
    python -m swat_tpu_torch.cli.prepare_data cleanup --dataset semi-aves
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil


def random_sample_fewshot(dataset_dir: str, dataset: str, shots: int,
                          seed: int) -> str:
    """reference prepare_fewshot_txt.random_sample_fewshot."""
    train_fn = "ltrain+val.txt" if dataset == "semi-aves" else "train.txt"
    with open(os.path.join(dataset_dir, train_fn)) as f:
        lines = f.readlines()

    by_class: dict[str, list[str]] = {}
    for line in lines:
        path, class_id, _ = line.strip("\n").split(" ")
        by_class.setdefault(class_id, []).append(path)

    random.seed(seed)
    out_path = os.path.join(dataset_dir, f"fewshot{shots}_seed{seed}.txt")
    out_lines = []
    # iterate classes in file-encounter order: the single seeded RNG stream
    # is consumed per class, so iteration order determines WHICH images each
    # class gets (reference train.items(), prepare_fewshot_txt.py:50-52).
    # tests/test_reference_artifacts.py proves this reproduces every shipped
    # fewshot{K}_seed{S}.txt byte-for-byte.
    for class_id, paths in by_class.items():
        picked = paths if len(paths) < shots else random.sample(paths, shots)
        for p in picked:
            out_lines.append(f"{p} {class_id} 1")  # 1 = few-shot source
    with open(out_path, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    print(f"Created {out_path}, {len(out_lines)} lines")
    return out_path


def create_labels_from_split_json(dataset_dir: str, split_json: str,
                                  prefix: str = "") -> None:
    """CoOp split json {'train':[[path,label,classname],...],'val':...,
    'test':...} -> train/val/test.txt (reference format_txt)."""
    with open(os.path.join(dataset_dir, split_json)) as f:
        splits = json.load(f)
    for split_name in ("train", "val", "test"):
        if split_name not in splits:
            continue
        txt = [f"{prefix}{e[0]} {e[1]} 1" for e in splits[split_name]]
        txt.sort(key=lambda x: int(x.split(" ")[1]))
        out = os.path.join(dataset_dir, f"{split_name}.txt")
        with open(out, "w") as f:
            f.write("\n".join(txt))
        print(f"Created {out}, {len(txt)} lines")


def cleanup(dataset_dir: str) -> None:
    for sub in ("pre_extracted", "prompts"):
        path = os.path.join(dataset_dir, sub)
        if os.path.isdir(path):
            shutil.rmtree(path)
            print(f"Removed {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description="swat-tpu data preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    fs = sub.add_parser("fewshot")
    fs.add_argument("--dataset", required=True)
    fs.add_argument("--dataset_path", default="data")
    fs.add_argument("--shots", type=int, nargs="+", default=[4, 8, 16])
    fs.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])

    lb = sub.add_parser("labels")
    lb.add_argument("--dataset", required=True)
    lb.add_argument("--dataset_path", default="data")
    lb.add_argument("--split_json", required=True)
    lb.add_argument("--prefix", default="")

    # per-benchmark creators with dataset-specific quirks (reference
    # prepare_datasets_labels.py:47-284; swat_tpu_torch.data.creators)
    cr = sub.add_parser("create")
    cr.add_argument("--dataset", required=True)
    cr.add_argument("--raw_root", required=True,
                    help="root of the raw dataset downloads (the "
                         "reference's config.yml dataset_path)")
    cr.add_argument("--dataset_path", default="data")

    cl = sub.add_parser("cleanup")
    cl.add_argument("--dataset", required=True)
    cl.add_argument("--dataset_path", default="data")

    args = p.parse_args(argv)
    ddir = os.path.join(args.dataset_path, args.dataset)
    if args.cmd == "fewshot":
        for shots in args.shots:
            for seed in args.seeds:
                random_sample_fewshot(ddir, args.dataset, shots, seed)
    elif args.cmd == "labels":
        create_labels_from_split_json(ddir, args.split_json, args.prefix)
    elif args.cmd == "create":
        from swat_tpu_torch.data.creators import create_labels

        create_labels(args.dataset, args.raw_root, ddir)
    elif args.cmd == "cleanup":
        cleanup(ddir)


if __name__ == "__main__":
    main()
