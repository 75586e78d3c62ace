# Copied from swat_tpu/retrieval/ingest.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""LAION metadata ingest: parquet shards -> caption-index shards + a
caption_id -> (url, caption, nsfw) metadata store.

Replaces the reference's SQLite build (``LaionParser.create_table`` /
``create_fts_table``, reference retrieval/laion_parser.py:48-79: one
``part{shard}`` row table + one ``_fts{shard}`` FTS5 table per parquet
shard, 32 tables for LAION-400M) and the per-sample URL lookup
(``find_by_id``, laion_parser.py:55-61).

Design: one ingest shard per input parquet file, matching the reference's
table-per-part layout.  Each shard produces

  captions_{i:05d}.txt   normalized caption corpus (C++ index input)
  index_{i:05d}.bin      serialized native caption index (optional)
  meta_{i:05d}.npz       packed url/caption blobs + offsets + nsfw codes

plus a ``manifest.json`` with per-shard caption counts and cumulative
offsets.  A *global caption id* is ``offset[shard] + rowid``, so matches
from the sharded index join the metadata store with O(1) array slicing —
no database needed, and shards memory-map lazily (a 400M-caption corpus
never has to fit in RAM at query time).
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from swat_tpu_torch.retrieval.stringmatch import normalize_caption

NSFW_CODES = {"UNLIKELY": 0, "UNSURE": 1, "NSFW": 2}
NSFW_NAMES = {v: k for k, v in NSFW_CODES.items()}
NSFW_NAMES[3] = ""


def _unpack_string(blob: np.ndarray, offsets: np.ndarray, i: int) -> str:
    return blob[offsets[i]: offsets[i + 1]].tobytes().decode(
        "utf-8", errors="replace")


def _iter_rows(path: str, text_col: str, url_col: str, nsfw_col: str):
    """One metadata shard -> batches of (texts, urls, nsfw).

    Parquet streams by row group (pyarrow iter_batches) so a shard never
    has to fit in memory twice; .jsonl/.json accepted for tests and
    non-parquet exports."""
    if path.endswith((".jsonl", ".json")):
        texts, urls, nsfw = [], [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                texts.append(row.get(text_col) or "")
                urls.append(row.get(url_col) or "")
                nsfw.append(row.get(nsfw_col) or "")
        yield texts, urls, nsfw
        return
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    cols = {c.lower(): c for c in pf.schema_arrow.names}

    def col(batch, name, default=""):
        c = cols.get(name.lower())
        if c is None:
            return [default] * batch.num_rows
        return [v if v is not None else default
                for v in batch.column(c).to_pylist()]

    wanted = [cols[n.lower()] for n in (text_col, url_col, nsfw_col)
              if n.lower() in cols]
    for batch in pf.iter_batches(batch_size=262_144,
                                 columns=wanted or None):
        yield (col(batch, text_col), col(batch, url_col),
               col(batch, nsfw_col))


def ingest_shards(inputs: Sequence[str], out_dir: str, *,
                  text_col: str = "TEXT", url_col: str = "URL",
                  nsfw_col: str = "NSFW", build_index: bool = True,
                  prefer_native: bool = True) -> dict:
    """Ingest metadata files (one shard each) into ``out_dir``.

    Returns the manifest. Mirrors reference create_table/create_fts_table
    (laion_parser.py:48-79) with the FTS5 DB replaced by the C++ index and
    the row tables by packed-array stores."""
    paths: List[str] = []
    for pat in inputs:
        hits = sorted(_glob.glob(pat))
        paths.extend(hits if hits else [pat])
    if not paths:
        raise FileNotFoundError(f"no input files match {inputs}")
    os.makedirs(out_dir, exist_ok=True)

    counts: List[int] = []
    for i, path in enumerate(paths):
        cap_file = os.path.join(out_dir, f"captions_{i:05d}.txt")
        url_parts: List[bytes] = []
        cap_parts: List[bytes] = []
        url_lens: List[int] = []
        cap_lens: List[int] = []
        nsfw_codes_parts: List[np.ndarray] = []
        n_rows = 0
        with open(cap_file, "w") as f:
            for texts, urls, nsfw in _iter_rows(path, text_col, url_col,
                                                nsfw_col):
                norm = [normalize_caption(t).replace("\n", " ")
                        for t in texts]
                if norm:
                    f.write("\n".join(norm) + "\n")
                for u in urls:
                    b = u.encode("utf-8", errors="replace")
                    url_parts.append(b)
                    url_lens.append(len(b))
                for c in norm:
                    b = c.encode("utf-8", errors="replace")
                    cap_parts.append(b)
                    cap_lens.append(len(b))
                nsfw_codes_parts.append(np.asarray(
                    [NSFW_CODES.get(s, 3) for s in nsfw], np.uint8))
                n_rows += len(norm)

        if build_index:
            _build_shard_index(cap_file,
                               os.path.join(out_dir, f"index_{i:05d}.bin"),
                               prefer_native)

        def offsets_of(lens):
            off = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            return off

        # one .npy per field: unlike .npz members, plain .npy files load
        # with mmap_mode='r' as TRUE memory maps, so MetaStore lookups are
        # O(1) page-ins instead of whole-blob reads
        meta_dir = os.path.join(out_dir, f"meta_{i:05d}")
        os.makedirs(meta_dir, exist_ok=True)
        fields = {
            "url_blob": np.frombuffer(b"".join(url_parts), np.uint8),
            "url_off": offsets_of(url_lens),
            "cap_blob": np.frombuffer(b"".join(cap_parts), np.uint8),
            "cap_off": offsets_of(cap_lens),
            "nsfw": (np.concatenate(nsfw_codes_parts)
                     if nsfw_codes_parts else np.zeros(0, np.uint8)),
        }
        for name, arr in fields.items():
            np.save(os.path.join(meta_dir, f"{name}.npy"), arr)
        counts.append(n_rows)

    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + c)
    manifest = {
        "num_shards": len(counts), "counts": counts, "offsets": offsets,
        "sources": [os.path.basename(p) for p in paths],
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _build_shard_index(cap_file: str, index_path: str, prefer_native: bool):
    if prefer_native:
        try:
            from swat_tpu_torch.retrieval.indexer import NativeCaptionIndex

            NativeCaptionIndex(path=cap_file).save(index_path)
            return
        except RuntimeError:
            pass
    # no native engine: queries will rebuild the python index per shard
    # from the captions file (slower, same results)


def _load_manifest(store_dir: str) -> dict:
    with open(os.path.join(store_dir, "manifest.json")) as f:
        return json.load(f)


class MetaStore:
    """caption_id -> (url, caption, nsfw) over the ingested shards
    (replaces reference ``find_by_id``, laion_parser.py:55-61 /
    ``process_sample``, laion_downloader.py:179-195). Shards load lazily
    and are memory-mapped."""

    def __init__(self, store_dir: str):
        self.dir = store_dir
        self.manifest = _load_manifest(store_dir)
        self.offsets = np.asarray(self.manifest["offsets"], np.int64)
        self._shards: Dict[int, dict] = {}

    def __len__(self):
        return int(self.offsets[-1])

    def shard_rowid(self, gid: int) -> Tuple[int, int]:
        shard = int(np.searchsorted(self.offsets, gid, side="right") - 1)
        return shard, int(gid - self.offsets[shard])

    def _shard(self, i: int) -> dict:
        if i not in self._shards:
            meta_dir = os.path.join(self.dir, f"meta_{i:05d}")
            self._shards[i] = {
                name: np.load(os.path.join(meta_dir, f"{name}.npy"),
                              mmap_mode="r")
                for name in ("url_blob", "url_off", "cap_blob", "cap_off",
                             "nsfw")
            }
        return self._shards[i]

    def evict(self):
        """Drop shard mappings (they re-open lazily)."""
        self._shards.clear()

    def lookup(self, gid: int) -> dict:
        shard, row = self.shard_rowid(int(gid))
        m = self._shard(shard)
        return {
            "url": _unpack_string(m["url_blob"], m["url_off"], row),
            "caption": _unpack_string(m["cap_blob"], m["cap_off"], row),
            "nsfw": NSFW_NAMES.get(int(m["nsfw"][row]), ""),
            "shard": shard, "rowid": row,
        }


class ShardedCaptionIndex:
    """Query interface over all index shards: AND/phrase matching per
    shard with results offset to global caption ids (the reference loops
    32 FTS tables per query, laion_parser.py:157-167)."""

    def __init__(self, store_dir: str, prefer_native: bool = True):
        self.dir = store_dir
        self.manifest = _load_manifest(store_dir)
        self.offsets = self.manifest["offsets"]
        self.prefer_native = prefer_native
        self._indexes: Dict[int, object] = {}

    def __len__(self):
        return int(self.offsets[-1])

    @property
    def num_shards(self):
        return int(self.manifest["num_shards"])

    def _index(self, i: int):
        if i not in self._indexes:
            bin_path = os.path.join(self.dir, f"index_{i:05d}.bin")
            cap_path = os.path.join(self.dir, f"captions_{i:05d}.txt")
            idx = None
            if self.prefer_native and os.path.exists(bin_path):
                try:
                    from swat_tpu_torch.retrieval.indexer import NativeCaptionIndex

                    idx = NativeCaptionIndex(index_path=bin_path)
                except RuntimeError:
                    idx = None
            if idx is None:
                from swat_tpu_torch.retrieval.indexer import make_index

                idx = make_index(path=cap_path,
                                 prefer_native=self.prefer_native)
            self._indexes[i] = idx
        return self._indexes[i]

    def query(self, name: str, phrase: bool = False) -> np.ndarray:
        out = []
        for i in range(self.num_shards):
            ids = self._index(i).query(name, phrase=phrase)
            if len(ids):
                out.append(np.asarray(ids, np.int64) + self.offsets[i])
        if not out:
            return np.empty(0, np.int64)
        return np.concatenate(out)

    def evict(self):
        """Drop loaded shard indexes (bound memory on huge corpora)."""
        self._indexes.clear()
