# Copied from swat_tpu/retrieval/indexer/__init__.py, with the locked, atomic build of utils/native_build.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""ctypes bindings for the C++ caption index, with automatic build and
pure-python fallback (swat_tpu_torch.retrieval.stringmatch.CaptionIndex)."""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from swat_tpu_torch.utils import native_build

_DIR = os.path.dirname(os.path.abspath(__file__))


def build_library(force: bool = False) -> Optional[str]:
    """The index's library, built at first use under a lock and moved onto
    its name whole (``utils.native_build``) -> its path, or None without
    g++ / make."""
    return native_build.build_library(
        _DIR, "libcaptionindex.so", ("caption_index.cpp", "unicode61_table.h"),
        force=force)


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.idx_build_file.restype = ctypes.c_void_p
    lib.idx_build_file.argtypes = [ctypes.c_char_p]
    lib.idx_build_buffer.restype = ctypes.c_void_p
    lib.idx_build_buffer.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.idx_num_captions.restype = ctypes.c_long
    lib.idx_num_captions.argtypes = [ctypes.c_void_p]
    lib.idx_query.restype = ctypes.c_long
    lib.idx_query.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_int, ctypes.POINTER(ctypes.c_long),
                              ctypes.c_long]
    lib.idx_free.restype = None
    lib.idx_free.argtypes = [ctypes.c_void_p]
    lib.idx_save.restype = ctypes.c_long
    lib.idx_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.idx_load.restype = ctypes.c_void_p
    lib.idx_load.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


class NativeCaptionIndex:
    """C++-backed index; same .query API as stringmatch.CaptionIndex.
    Queries pass through stringmatch.clean_text for identical semantics."""

    def __init__(self, captions: Optional[Sequence[str]] = None,
                 path: Optional[str] = None, max_results: int = 5_000_000,
                 index_path: Optional[str] = None):
        """Build from ``captions`` / corpus file ``path``, or reload a
        serialized index via ``index_path`` (see .save())."""
        lib = _load()
        if lib is None:
            raise RuntimeError("libcaptionindex.so unavailable "
                               "(g++/make missing?)")
        self._lib = lib
        self.max_results = max_results
        if index_path is not None:
            self._h = lib.idx_load(index_path.encode())
        elif path is not None:
            self._h = lib.idx_build_file(path.encode())
        else:
            buf = "\n".join(c.replace("\n", " ") for c in captions)
            data = buf.encode("utf-8", errors="replace")
            self._h = lib.idx_build_buffer(data, len(data))
        if not self._h:
            raise RuntimeError("index build/load failed")

    def save(self, path: str):
        """Serialize to disk; reload with index_path= (build once over a
        corpus-scale caption set, reload instantly)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        rc = self._lib.idx_save(self._h, path.encode())
        if rc == -2:
            raise ValueError(
                "this index was opened from a memory-mapped v2 file and "
                "is read-only; copy the file on disk instead of re-saving")
        if rc != 0:
            raise IOError(f"index save failed: {path}")

    def __len__(self):
        return int(self._lib.idx_num_captions(self._h))

    def query(self, name: str, phrase: bool = False) -> np.ndarray:
        from swat_tpu_torch.retrieval.stringmatch import clean_text

        q = clean_text(name).replace("(", "").replace(")", "")
        out = np.empty(self.max_results, np.int64)
        n = self._lib.idx_query(
            self._h, q.encode("utf-8", errors="replace"), int(phrase),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            self.max_results)
        if n > self.max_results:
            import warnings

            warnings.warn(
                f"caption index query {name!r} matched {n} captions; "
                f"returning only the first {self.max_results} "
                "(raise max_results to keep them all)")
        return out[: min(n, self.max_results)].copy()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.idx_free(self._h)
        except Exception:
            pass


def make_index(captions: Optional[Sequence[str]] = None,
               path: Optional[str] = None, prefer_native: bool = True):
    """Best-available caption index."""
    if prefer_native:
        try:
            return NativeCaptionIndex(captions, path)
        except RuntimeError:
            pass
    from swat_tpu_torch.retrieval.stringmatch import CaptionIndex

    if captions is None:
        with open(path) as f:
            captions = f.read().splitlines()
    return CaptionIndex(captions)
