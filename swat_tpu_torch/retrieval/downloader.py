# Copied from swat_tpu/retrieval/downloader.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Image download plumbing (host-side; network tooling optional).

Step [2] of the retrieval pipeline (SURVEY.md §3.3).  The reference builds
per-class URL parquet files from the matched captions (sampling all or a
random subset), bulk-downloads via img2dataset, and restructures the flat
shard dump into per-class folders with re-keyed metadata (reference
retrieval/laion_downloader.py:108-234).  Those behaviors live here;
img2dataset itself is an optional import (it is a network tool — not
performance-relevant to TPU, SURVEY.md §2.4 item 5).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple


def select_samples(matches: Sequence[Tuple[str, int]], sampling: str,
                   max_images: Optional[int], seed: int = 0) -> List[int]:
    """caption ids to download for one class ('all' | 'random' | 'few',
    reference create_parquet, laion_downloader.py:143-159)."""
    import numpy as np

    ids = [cid for _, cid in matches]
    if sampling == "few":  # first 5 (reference :152-153)
        return ids[:5]
    if sampling == "all" or max_images is None or len(ids) <= max_images:
        return ids
    if sampling == "random":
        rng = np.random.default_rng(seed)
        return list(rng.choice(ids, size=max_images, replace=False))
    raise NotImplementedError(f"sampling {sampling}")


def build_url_rows(retrieved: Dict[str, Sequence[Tuple[str, int]]],
                   meta_store, *, sampling: str = "all",
                   max_images: Optional[int] = 2000, seed: int = 0,
                   skip_nsfw: bool = True
                   ) -> Tuple[List[dict], Dict[str, list]]:
    """Join per-class caption matches with the metadata store to produce
    downloadable URL rows (reference create_parquet + process_sample,
    laion_downloader.py:132-195: per-sample URL lookup via find_by_id,
    NSFW-flagged rows skipped as in the legacy worker, :51-54).

    retrieved: {class_id: [(synonym, caption_id)]} — the stringmatch
    output.  Returns (rows for write_url_parquet, download metadata
    {class: [(shard, rowid, caption, url)]} — the .meta equivalent)."""
    rows: List[dict] = []
    metadata: Dict[str, list] = {}
    def sort_key(k):
        ks = str(k)
        return (0, int(ks), "") if ks.isdigit() else (1, 0, ks)

    for cls in sorted(retrieved, key=sort_key):
        ids = select_samples(retrieved[cls], sampling, max_images,
                             seed=seed)
        metadata[str(cls)] = []
        for cid in ids:
            m = meta_store.lookup(int(cid))
            if skip_nsfw and m["nsfw"] == "NSFW":
                continue
            if not m["url"]:
                continue
            rows.append({"class_id": str(cls), "caption": m["caption"],
                         "url": m["url"], "caption_id": int(cid)})
            metadata[str(cls)].append(
                (m["shard"], m["rowid"], m["caption"], m["url"]))
    return rows, metadata


def write_url_parquet(path: str, rows: Sequence[dict]):
    """rows: [{'class_id', 'caption', 'url', 'caption_id'}] -> parquet
    (falls back to jsonl when pyarrow is unavailable)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq

        table = pa.Table.from_pylist(list(rows))
        pq.write_table(table, path)
    except ImportError:
        with open(path + ".jsonl", "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


def download_with_img2dataset(parquet_path: str, output_dir: str,
                              processes: int = 16, threads: int = 16,
                              min_image_size: int = 85):
    """Bulk download (reference img2dataset_download,
    laion_downloader.py:108-130: resize_mode 'no', encode_quality 100,
    min_image_size 85).  Requires the img2dataset package + network;
    raises ImportError otherwise."""
    import img2dataset

    img2dataset.download(
        url_list=parquet_path, input_format="parquet",
        url_col="url", caption_col="caption", output_folder=output_dir,
        output_format="files", processes_count=processes,
        thread_count=threads, resize_mode="no", encode_quality=100,
        min_image_size=min_image_size,
        number_sample_per_shard=2_000_000)


def restructure_download(flat_dir: str, out_dir: str,
                         key_to_class: Dict[str, int]
                         ) -> Dict[str, Dict[str, str]]:
    """Flat img2dataset dump (00000/000000123.jpg + .json sidecars) ->
    per-class folders with sequential ids; returns the caption map
    {class: {img_idx: caption}} (reference restructure_download,
    laion_downloader.py:198-234 + process_meta_map.py)."""
    counters: Dict[int, int] = {}
    caption_map: Dict[str, Dict[str, str]] = {}
    for shard in sorted(os.listdir(flat_dir)):
        shard_dir = os.path.join(flat_dir, shard)
        if not os.path.isdir(shard_dir):
            continue
        for fname in sorted(os.listdir(shard_dir)):
            if not fname.endswith(".json"):
                continue
            with open(os.path.join(shard_dir, fname)) as f:
                meta = json.load(f)
            if meta.get("status") != "success":
                continue
            key = str(meta.get("key", fname.split(".")[0]))
            if key not in key_to_class:
                continue
            cls = key_to_class[key]
            img_src = os.path.join(shard_dir, fname.replace(".json", ".jpg"))
            if not os.path.exists(img_src):
                continue
            idx = counters.get(cls, 0)
            counters[cls] = idx + 1
            cls_dir = os.path.join(out_dir, str(cls))
            os.makedirs(cls_dir, exist_ok=True)
            shutil.copyfile(img_src, os.path.join(cls_dir, f"{idx}.jpg"))
            caption_map.setdefault(str(cls), {})[str(idx)] = meta.get(
                "caption", "")
    return caption_map
