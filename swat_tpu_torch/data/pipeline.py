# Copied in part (_prefetch, EvalLoader, TrainSnapshotLoader, TrainLoader, FeatureBatches) from swat_tpu/data/pipeline.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Host input pipeline (counterpart of ``swat_tpu/data/pipeline.py:32-307,
329-371``).

A threaded decode pool with one-batch prefetch.  Eval batches are fully
preprocessed on the host, in a fixed order, and the final batch is padded
to the batch size with a validity mask, as in the JAX package (whose static
shapes needed it; here it keeps the two engines' batches identical).  Train
batches are shuffled and drop-last, and carry uint8 canvases for the
on-device augmentation (or, in ``host`` mode, the reference's PIL train
transform; in ``eval`` mode, eval-preprocessed images).
``TrainSnapshotLoader`` is the eval-shaped pass that extracts probing's
train features through the train transform, once an image, and
``FeatureBatches`` batches pre-extracted features.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import zlib
from typing import Dict, Iterator, List, Sequence

import numpy as np

from swat_tpu_torch.data import native
from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.data.transforms import (CANVAS_SIZE, eval_preprocess,
                                            host_train_preprocess,
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

    def _load_chunk(self, chunk, pool) -> np.ndarray:
        """Normalized float32 pixels of a chunk of samples."""
        return normalize_u8(eval_pixels_u8(chunk, self.n_px,
                                           self.num_workers))

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(self.samples), bs):
                chunk = self.samples[start: start + bs]
                images = self._load_chunk(chunk, pool)
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


class TrainSnapshotLoader(EvalLoader):
    """An EvalLoader-shaped pass (fixed order, padded and masked) that
    applies the TRAIN transform once an image: the reference extracts
    pre-extracted train features with ``transform(224, 'train')``, one
    random crop / flip snapshot an image (pre_extract_feature,
    utils/dataloader.py:72-81; extract_train_dataloader :278-287).  Each
    image's generator is keyed on (seed, crc32(path)), so the snapshot, and
    the feature cache made from it, is the same in every run and in both
    packages.  mode='eval' takes the eval transform instead.

    ``shuffle_drop_bsz``: stage 2's extract_train_dataloader extracts with
    shuffle=True, drop_last=True at bsz 128 (:285-286), dropping up to 127
    random samples from the probing train set; set it to do the same
    (stage 1's pre_extract_feature keeps every sample, :79-80)."""

    def __init__(self, samples, batch_size: int = 256, n_px: int = 224,
                 num_workers: int = 16, seed: int = 1,
                 shuffle_drop_bsz: int = 0, mode: str = "train"):
        samples = list(samples)
        if shuffle_drop_bsz:
            order = np.random.default_rng(seed).permutation(len(samples))
            keep = max(1, len(samples) // shuffle_drop_bsz) \
                * shuffle_drop_bsz
            samples = [samples[i] for i in order[:keep]]
        super().__init__(samples, batch_size, n_px, num_workers)
        self.seed = seed
        self.mode = mode

    def _load_chunk(self, chunk, pool) -> np.ndarray:
        def load(s):
            if self.mode == "eval":
                return eval_preprocess(load_image(s.path), self.n_px)
            rng = np.random.default_rng(
                (self.seed, zlib.crc32(s.path.encode())))
            return host_train_preprocess(load_image(s.path), rng, self.n_px)

        return np.stack(list(pool.map(load, chunk))).astype(np.float32)


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
    mode='host': the reference's PIL train transform on the host
    (``host_train_preprocess``), one generator an image, seeded from the
    loader's own draws after each batch's order, as in ``swat_tpu``.
    mode='eval': the deterministic eval preprocess applied to train batches
    (the lock-step harness)."""

    def __init__(self, samples: Sequence[Sample], batch_size: int = 32,
                 seed: int = 1, mode: str = "canvas", n_px: int = 224,
                 num_workers: int = 16):
        if mode not in ("canvas", "host", "eval"):
            raise ValueError(f"unknown --aug_mode {mode!r}")
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
                elif self.mode == "eval":
                    batch["images"] = np.stack(list(pool.map(
                        lambda s: eval_preprocess(load_image(s.path),
                                                  self.n_px),
                        chunk))).astype(np.float32)
                else:
                    # one generator an image (a Generator is not thread
                    # safe), seeded in the batch's order
                    seeds = self._rng.integers(2 ** 63, size=len(chunk))
                    batch["images"] = np.stack(list(pool.map(
                        lambda task: host_train_preprocess(
                            load_image(task[0].path),
                            np.random.default_rng(task[1]), self.n_px),
                        zip(chunk, seeds)))).astype(np.float32)
                yield batch

    def __iter__(self):
        return _prefetch(self._batches())


class FeatureBatches:
    """Batches over pre-extracted (features, labels) arrays; a short last
    batch (without drop_last) is padded and masked."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int = 128, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, source=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.source = (np.asarray(source, np.int32) if source is not None
                       else np.full(len(self.labels), -1, np.int32))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.labels)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def __iter__(self):
        n = len(self.labels)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        end = n - bs + 1 if self.drop_last else n
        for start in range(0, end, bs):
            idx = order[start: start + bs]
            feats = self.features[idx]
            labels = self.labels[idx]
            src = self.source[idx]
            k = len(idx)
            if k < bs:  # pad + mask (eval path only)
                feats = np.concatenate(
                    [feats, np.zeros((bs - k,) + feats.shape[1:],
                                     feats.dtype)])
                labels = np.concatenate([labels, np.zeros(bs - k, np.int32)])
                src = np.concatenate([src, np.full(bs - k, -1, np.int32)])
            yield {
                "features": feats,
                "labels": labels.astype(np.int32),
                "source": src.astype(np.int32),
                "mask": np.arange(bs) < k,
            }
