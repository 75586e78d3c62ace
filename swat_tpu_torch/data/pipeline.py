# Copied in part (_prefetch, EvalLoader, TrainLoader) from swat_tpu/data/pipeline.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Host input pipeline (counterpart of ``swat_tpu/data/pipeline.py:32-162,
216-307``).

A threaded decode pool with one-batch prefetch.  Eval batches are fully
preprocessed on the host, in a fixed order, and the final batch is padded
to the batch size with a validity mask, as in the JAX package (whose static
shapes needed it; here it keeps the two engines' batches identical).  Train
batches are shuffled and drop-last, and carry uint8 canvases for the
on-device augmentation (or, in ``eval`` mode, eval-preprocessed images).
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from swat_tpu_torch.data import native
from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.data.transforms import (CANVAS_SIZE, eval_preprocess,
                                            load_image, normalize_u8)


def _prefetch(gen, depth: int = 2):
    """Run a generator in a background thread with a small queue.  Leaving
    the iteration early stops the worker: it polls a stop flag on every
    bounded put, and closes the source generator on its way out."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in gen:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the consumer, raised there
            err.append(e)
        finally:
            if not stop.is_set():
                q.put(end)
            gen.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def eval_pixels_u8(samples: Sequence[Sample], n_px: int,
                   num_workers: int) -> np.ndarray:
    """uint8 center crops [N, n_px, n_px, 3]: the native decoder where it
    decodes the image, PIL threads for the rest."""
    return native.batch_eval_pixels([s.path for s in samples], n_px,
                                    num_workers)


class EvalLoader:
    """Deterministic order, fixed batch shape, final batch padded + masked.
    Yields numpy batches: images [bs, n_px, n_px, 3] float32 (normalized),
    labels, source, mask."""

    def __init__(self, samples: Sequence[Sample], batch_size: int = 256,
                 n_px: int = 224, num_workers: int = 16):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.n_px = n_px
        # torch DataLoader semantics: num_workers=0 loads in-process; a
        # 1-thread pool is the threaded equivalent
        self.num_workers = max(1, num_workers)

    def __len__(self):
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        for start in range(0, len(self.samples), bs):
            chunk = self.samples[start: start + bs]
            images = normalize_u8(eval_pixels_u8(chunk, self.n_px,
                                                 self.num_workers))
            n = len(chunk)
            if n < bs:  # pad with zeros, masked out
                images = np.concatenate(
                    [images, np.zeros((bs - n,) + images.shape[1:],
                                      images.dtype)])
            yield {
                "images": images,
                "labels": np.array(
                    [s.label for s in chunk] + [0] * (bs - n), np.int32),
                "source": np.array(
                    [s.is_fewshot for s in chunk] + [0] * (bs - n),
                    np.int32),
                "mask": np.arange(bs) < n,
            }

    def __iter__(self):
        return _prefetch(self._batches())


def train_canvases(samples: Sequence[Sample], num_workers: int):
    """uint8 canvases [N, CANVAS_SIZE, CANVAS_SIZE, 3] and valid_hw [N, 2]
    int32: the native decoder where it decodes the image, PIL threads for
    the rest."""
    return native.batch_train_canvases([s.path for s in samples],
                                       CANVAS_SIZE, num_workers)


class TrainLoader:
    """Shuffled, drop-last train batches (``swat_tpu.data.pipeline.
    TrainLoader``, same ``np.random.default_rng(seed)`` order, so both
    packages see the same batches).

    mode='canvas': uint8 canvases + valid_hw for the on-device augment.
    mode='eval': the deterministic eval preprocess applied to train batches
    (the lock-step harness).  mode='host', the reference's PIL augment, is
    not ported yet (ROADMAP Queue A item 3)."""

    def __init__(self, samples: Sequence[Sample], batch_size: int = 32,
                 seed: int = 1, mode: str = "canvas", n_px: int = 224,
                 num_workers: int = 16):
        if mode not in ("canvas", "eval"):
            raise NotImplementedError(
                f"--aug_mode {mode} is not ported to swat_tpu_torch yet (see "
                "ROADMAP, Queue A item 3); run it with swat_tpu")
        if batch_size > len(samples):
            raise ValueError(
                f"batch_size {batch_size} > dataset size {len(samples)} "
                "(drop_last leaves no batches)")
        self.samples = list(samples)
        self.batch_size = batch_size
        self.mode = mode
        self.n_px = n_px
        self.num_workers = max(1, num_workers)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples) // self.batch_size

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._rng.permutation(len(self.samples))
        bs = self.batch_size
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order) - bs + 1, bs):
                chunk = [self.samples[i] for i in order[start: start + bs]]
                batch: Dict[str, np.ndarray] = {
                    "labels": np.array([s.label for s in chunk], np.int32),
                    "source": np.array([s.is_fewshot for s in chunk],
                                       np.int32),
                }
                if self.mode == "canvas":
                    batch["canvases"], batch["valid_hw"] = train_canvases(
                        chunk, self.num_workers)
                else:
                    batch["images"] = np.stack(list(pool.map(
                        lambda s: eval_preprocess(load_image(s.path),
                                                  self.n_px),
                        chunk))).astype(np.float32)
                yield batch

    def __iter__(self):
        return _prefetch(self._batches())
