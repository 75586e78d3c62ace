"""The port's native libraries build once and load whole however many
processes ask for them at once (``swat_tpu_torch.utils.native_build``): the
JPEG decoder and the caption index, each from a fresh copy of its sources
in a directory with no built library, loaded by six processes started
together."""

import ctypes
import multiprocessing as mp
import os
import shutil

import pytest

from swat_tpu_torch.data import native
from swat_tpu_torch.retrieval import indexer
from swat_tpu_torch.utils import native_build

LIBRARIES = {
    "decoder": (native._DIR, "libswatdecoder.so", ("decoder.cpp",)),
    "indexer": (indexer._DIR, "libcaptionindex.so",
                ("caption_index.cpp", "unicode61_table.h")),
}
N_PROCESSES = 6
TIMEOUT_S = 300


def _build_and_load(args):
    directory, target, sources, barrier = args
    barrier.wait()
    path = native_build.build_library(directory, target, sources)
    if path is None:
        return "not built"
    try:
        ctypes.CDLL(path)
    except OSError as e:
        return f"not loaded: {e}"
    return "loaded"


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_concurrent_builds_all_load_a_whole_library(tmp_path, name):
    source_dir, target, sources = LIBRARIES[name]
    for f in ("Makefile", *sources):
        shutil.copy2(os.path.join(source_dir, f), tmp_path)
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        barrier = manager.Barrier(N_PROCESSES)
        with ctx.Pool(N_PROCESSES) as pool:
            got = pool.map_async(_build_and_load, [
                (str(tmp_path), target, sources, barrier)] * N_PROCESSES
            ).get(timeout=TIMEOUT_S)
    assert got == ["loaded"] * N_PROCESSES
    # the build left the library and its lock file, and no temporary copy
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["Makefile", *sources, target, target + ".lock"])
