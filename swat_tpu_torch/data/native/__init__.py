# Copied from swat_tpu/data/native/__init__.py, with the per-image fallback on the port's own transforms and the locked, atomic build of utils/native_build.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""ctypes bindings for the native image loader (decoder.cpp), with
automatic build and per-image PIL fallback.

Exports batch_train_canvases / batch_eval_pixels, the two host-side batch
preprocessing operations feeding the device (semantics identical to
swat_tpu_torch.data.transforms.train_canvas / eval_crop; resampling can
differ from PIL by +-1 uint8 LSB).  Files the decoder rejects (PNG, CMYK,
...) and every file when the library does not build (no libjpeg headers)
decode through PIL on a thread pool.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from swat_tpu_torch.data.transforms import eval_crop, load_image, train_canvas
from swat_tpu_torch.utils import native_build

_DIR = os.path.dirname(os.path.abspath(__file__))


def build_library(force: bool = False) -> Optional[str]:
    """The decoder's library, built at first use under a lock and moved
    onto its name whole (``utils.native_build``), or None without g++ or
    libjpeg."""
    return native_build.build_library(_DIR, "libswatdecoder.so",
                                      ("decoder.cpp",), force=force)


_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    path = build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dec_canvas_batch.restype = ctypes.c_long
    lib.dec_canvas_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
        c_u8p, c_i32p, c_i32p, ctypes.c_long]
    lib.dec_eval_batch.restype = ctypes.c_long
    lib.dec_eval_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
        c_u8p, c_i32p, ctypes.c_long]
    _lib = lib
    return lib


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _fallback(paths: Sequence[str], status: np.ndarray, outs, transform,
              threads: int) -> None:
    """Rows whose status is nonzero (not decoded natively): the port's PIL
    transform ``transform(image) -> row values``, on a thread pool."""
    todo = np.nonzero(status)[0]
    if not len(todo):
        return
    with cf.ThreadPoolExecutor(max(1, threads)) as pool:
        for i, rows in zip(todo, pool.map(
                lambda i: transform(load_image(paths[i])), todo)):
            for out, row in zip(outs, rows):
                out[i] = row


def batch_train_canvases(paths: Sequence[str], canvas: int = 256,
                         threads: int = 16
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """[N] paths -> (uint8 canvases [N,canvas,canvas,3], valid_hw [N,2]).
    Falls back to PIL per image when native decode fails (PNG, CMYK...)."""
    n = len(paths)
    out = np.zeros((n, canvas, canvas, 3), np.uint8)
    valid_hw = np.zeros((n, 2), np.int32)
    lib = _load()
    status = np.ones(n, np.int32)
    if lib is not None and n:
        lib.dec_canvas_batch(
            _paths_array(paths), n, canvas,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            valid_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max(1, threads))
    _fallback(paths, status, (out, valid_hw),
              lambda img: train_canvas(img, canvas), threads)
    return out, valid_hw


def batch_eval_pixels(paths: Sequence[str], n_px: int = 224,
                      threads: int = 16) -> np.ndarray:
    """[N] paths -> uint8 center-cropped pixels [N, n_px, n_px, 3]
    (normalization happens downstream, on device or in numpy)."""
    n = len(paths)
    out = np.zeros((n, n_px, n_px, 3), np.uint8)
    lib = _load()
    status = np.ones(n, np.int32)
    if lib is not None and n:
        lib.dec_eval_batch(
            _paths_array(paths), n, n_px,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max(1, threads))
    _fallback(paths, status, (out,),
              lambda img: (np.asarray(eval_crop(img, n_px), np.uint8),),
              threads)
    return out
