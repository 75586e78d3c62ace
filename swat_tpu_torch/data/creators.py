# Copied from swat_tpu/data/creators.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Per-benchmark label-file creators: raw dataset download -> the
``train/val/test.txt`` files the pipeline consumes.

One creator per benchmark, mirroring the dataset-specific quirks of
reference prepare_datasets_labels.py:47-284:

  oxford_pets    CoOp split json, prefix ``images/``            (:49-62)
  food101        CoOp split json, prefix ``images/``            (:65-78)
  stanford_cars  CoOp split json, NO prefix                     (:80-94)
  imagenet       CMLP split json; train = train+val merged; the on-disk
                 file names are rewritten ({cls}_{id}_{cls}.JPEG /
                 ILSVRC2012_val_{id}_{cls}.JPEG); test split doubles as
                 val.txt and test.txt                           (:97-117, 18-45)
  dtd            CoOp split json, prefix ``dtd/dtd/images/``    (:134-149)
  eurosat        CoOp split json, prefix ``eurosat/EuroSAT_RGB/`` (:152-166)
  flowers102     CoOp split json, prefix ``flowers102/jpg/``    (:168-182)
  fgvc-aircraft  images_variant_{split}.txt, label = variant-name index
                 from variants.txt, ``.jpg`` appended           (:184-231)
  semi-aves      l_train/val/test.txt relabeled with prefix ``semi-aves/``;
                 also writes the merged ``ltrain+val.txt`` the few-shot
                 sampler draws from                             (:235-263)

All lines are ``{prefix}{path} {label} 1`` (1 = downstream/few-shot
source flag) sorted by label, identical to reference format_txt (:4-16).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List


def _write_sorted(lines: List[str], output_file: str) -> None:
    lines.sort(key=lambda x: int(x.split(" ")[1]))
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with open(output_file, "w") as f:
        f.write("\n".join(lines))
    print(f"Created {output_file}, {len(lines)} lines")


def _format_txt(split_list, prefix: str, output_file: str) -> None:
    _write_sorted([f"{prefix}{e[0]} {e[1]} 1" for e in split_list],
                  output_file)


def _coop_json_creator(json_rel: str, prefix: str):
    def create(raw_root: str, out_dir: str) -> None:
        with open(os.path.join(raw_root, json_rel)) as f:
            data = json.load(f)
        for split in ("train", "val", "test"):
            _format_txt(data[split], prefix,
                        os.path.join(out_dir, f"{split}.txt"))
    return create


def _imagenet_path(path: str, split: str) -> str:
    """Rewrite a CMLP-split path onto the restructured on-disk names
    (reference format_imagenet_txt, prepare_datasets_labels.py:18-45)."""
    segs = path.split("/")
    folder, cls_code = segs[0], segs[1]
    image_id = segs[-1].split(".")[0].split("_")[-1]
    if split == "train":
        return f"{folder}/{cls_code}_{image_id}_{cls_code}.JPEG"
    if split in ("val", "test"):
        return f"{folder}/ILSVRC2012_val_{image_id}_{cls_code}.JPEG"
    raise ValueError(f"Invalid split: {split}")


def create_imagenet(raw_root: str, out_dir: str) -> None:
    with open(os.path.join(raw_root, "imagenet",
                           "split_ImageNet.json")) as f:
        data = json.load(f)
    # the true train split = train + val merged; the CMLP test split
    # serves as both val.txt and test.txt (reference :108-117)
    train = data["train"] + data["val"]
    test = data["test"]
    prefix = "images/"

    def fmt(split_list, split, name):
        _write_sorted(
            [f"{prefix}{_imagenet_path(e[0], split)} {e[1]} 1"
             for e in split_list],
            os.path.join(out_dir, name))

    fmt(train, "train", "train.txt")
    fmt(test, "val", "val.txt")
    fmt(test, "test", "test.txt")


def create_aircraft(raw_root: str, out_dir: str) -> None:
    base = os.path.join(raw_root, "fgvc-aircraft", "fgvc-aircraft-2013b",
                        "data")
    with open(os.path.join(base, "variants.txt")) as f:
        label_dict = {name.strip(): i for i, name in enumerate(f)}
    prefix = "fgvc-aircraft/fgvc-aircraft-2013b/data/images/"
    for split in ("train", "val", "test"):
        with open(os.path.join(base, f"images_variant_{split}.txt")) as f:
            rows = f.readlines()
        lines = []
        for row in rows:
            entry = row.strip().split(" ")
            path, label_name = entry[0], " ".join(entry[1:])
            lines.append(f"{prefix}{path}.jpg {label_dict[label_name]} 1")
        _write_sorted(lines, os.path.join(out_dir, f"{split}.txt"))


def create_semi_aves(raw_root: str, out_dir: str) -> None:
    base = os.path.join(raw_root, "dataset", "semi-aves")
    prefix = "semi-aves/"
    names = {"ltrain": "l_train.txt", "val": "val.txt", "test": "test.txt"}
    for out_name, src in names.items():
        with open(os.path.join(base, src)) as f:
            rows = [r.strip().split(" ") for r in f if r.strip()]
        _write_sorted([f"{prefix}{r[0]} {r[1]} 1" for r in rows],
                      os.path.join(out_dir, f"{out_name}.txt"))
    # merged pool the few-shot sampler draws from (the repo ships this
    # file in the reference's data/semi-aves; here it is derived)
    with open(os.path.join(out_dir, "ltrain.txt")) as f:
        merged = f.read().splitlines()
    with open(os.path.join(out_dir, "val.txt")) as f:
        merged += f.read().splitlines()
    _write_sorted(merged, os.path.join(out_dir, "ltrain+val.txt"))


CREATORS: Dict[str, Callable[[str, str], None]] = {
    "oxford_pets": _coop_json_creator(
        "oxford_pets/split_zhou_OxfordPets.json", "images/"),
    "food101": _coop_json_creator(
        "food101/split_zhou_Food101.json", "images/"),
    "stanford_cars": _coop_json_creator(
        "stanford_cars/split_zhou_StanfordCars.json", ""),
    "dtd": _coop_json_creator(
        "dtd/dtd/split_zhou_DescribableTextures.json", "dtd/dtd/images/"),
    "eurosat": _coop_json_creator(
        "eurosat/split_zhou_EuroSAT.json", "eurosat/EuroSAT_RGB/"),
    "flowers102": _coop_json_creator(
        "flowers102/split_zhou_OxfordFlowers.json", "flowers102/jpg/"),
    "imagenet": create_imagenet,
    "fgvc-aircraft": create_aircraft,
    "semi-aves": create_semi_aves,
}


def create_labels(dataset: str, raw_root: str, out_dir: str) -> None:
    if dataset not in CREATORS:
        raise SystemExit(
            f"No creator for '{dataset}'; known: {sorted(CREATORS)}")
    CREATORS[dataset](raw_root, out_dir)
