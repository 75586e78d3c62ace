# Copied in part (_prefetch, EvalLoader, TrainSnapshotLoader, TrainLoader, CyclingLoader, FeatureBatches, WeightedSampler, WeightedTrainLoader) from swat_tpu/data/pipeline.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Host input pipeline (counterpart of ``swat_tpu/data/pipeline.py:32-413``).

A threaded decode pool with one-batch prefetch.  Eval batches are fully
preprocessed on the host, in a fixed order, and the final batch is padded
to the batch size with a validity mask, as in the JAX package (whose static
shapes needed it; here it keeps the two engines' batches identical).  Train
batches are shuffled and drop-last, and carry uint8 canvases for the
on-device augmentation (or, in ``host`` mode, the reference's PIL train
transform; in ``eval`` mode, eval-preprocessed images).
``TrainSnapshotLoader`` is the eval-shaped pass that extracts probing's
train features through the train transform, once an image, and
``FeatureBatches`` batches pre-extracted features.  The twin-loader
methods cycle a second loader (``CyclingLoader``): the few-shot split, or
for CMO the train split drawn with inverse class frequencies
(``WeightedTrainLoader``).

Under a device mesh (``mesh=``, ``core/mesh.py``) every rank builds the
same batches from the same seed, and decodes only its rows of each: the
keys of ``LOCAL_KEYS`` hold those rows, every other key (labels, source,
mask, prompt tokens) the whole batch.  An eval batch is padded to a
multiple of the data axis and its pad rows masked; a train batch must
divide it.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from swat_tpu_torch.core.mesh import Mesh, active, pad_to_multiple
from swat_tpu_torch.data import native
from swat_tpu_torch.data.splits import Sample
from swat_tpu_torch.data.transforms import (CANVAS_SIZE, eval_preprocess,
                                            host_train_preprocess,
                                            load_image, normalize_u8)


# the keys of a batch that hold only this rank's rows under a mesh (the
# decoded ones); the trainer gathers them (``Mesh.gather_batch``)
LOCAL_KEYS = ("canvases", "valid_hw", "images")
# the suffixes of a second loader's keys in a composed batch: the twin
# split's (``train.trainer.compose_twin``) and FixMatch's unlabeled one
SECOND_LOADER_SUFFIXES = ("_fs", "_u")


def local_keys(batch: Dict) -> List[str]:
    """The keys of ``batch`` that hold this rank's rows alone under a mesh:
    ``LOCAL_KEYS``, also with a second loader's suffix."""
    return [k for k in batch
            if any(k == base + suffix for base in LOCAL_KEYS
                   for suffix in ("",) + SECOND_LOADER_SUFFIXES)]


def _check_divides(batch_size: int, mesh: Optional[Mesh]) -> None:
    if mesh is not None and batch_size % mesh.data:
        raise ValueError(
            f"batch size {batch_size} is not divisible by the data axis "
            f"({mesh.data} ranks)")


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
    labels, source, mask.  Under a ``mesh`` a batch is padded to a multiple
    of the data axis and ``images`` holds this rank's rows of it."""

    def __init__(self, samples: Sequence[Sample], batch_size: int = 256,
                 n_px: int = 224, num_workers: int = 16,
                 mesh: Optional[Mesh] = None):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.n_px = n_px
        # torch DataLoader semantics: num_workers=0 loads in-process; a
        # 1-thread pool is the threaded equivalent
        self.num_workers = max(1, num_workers)
        self.mesh = active(mesh)

    def __len__(self):
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def _load_chunk(self, chunk, pool) -> np.ndarray:
        """Normalized float32 pixels of a chunk of samples."""
        return normalize_u8(eval_pixels_u8(chunk, self.n_px,
                                           self.num_workers))

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self.batch_size
        bs = (step if self.mesh is None
              else pad_to_multiple(step, self.mesh.data))
        mine = slice(0, bs) if self.mesh is None else self.mesh.rows(bs)
        k = mine.stop - mine.start
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(self.samples), step):
                chunk = self.samples[start: start + step]
                part = chunk[mine]
                images = (self._load_chunk(part, pool) if part else
                          np.zeros((0, self.n_px, self.n_px, 3), np.float32))
                if len(part) < k:  # pad with zeros, masked out
                    images = np.concatenate(
                        [images, np.zeros((k - len(part),) + images.shape[1:],
                                          images.dtype)])
                n = len(chunk)
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
                 shuffle_drop_bsz: int = 0, mode: str = "train",
                 mesh: Optional[Mesh] = None):
        samples = list(samples)
        if shuffle_drop_bsz:
            order = np.random.default_rng(seed).permutation(len(samples))
            keep = max(1, len(samples) // shuffle_drop_bsz) \
                * shuffle_drop_bsz
            samples = [samples[i] for i in order[:keep]]
        super().__init__(samples, batch_size, n_px, num_workers, mesh)
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
    (the lock-step harness).
    ``tokenized_prompts`` (class id -> [n, context] token rows; FLYP): each
    batch also carries ``prompt_tokens`` [B, context] int32, one row of its
    class's prompts a sample, drawn from the loader's own generator after
    the batch's images and host-aug seeds, as in ``swat_tpu``.
    Under a ``mesh`` every rank draws the whole batch's order, seeds and
    prompt rows, and decodes its rows of the batch alone (``LOCAL_KEYS``)."""

    def __init__(self, samples: Sequence[Sample], batch_size: int = 32,
                 seed: int = 1, mode: str = "canvas", n_px: int = 224,
                 num_workers: int = 16,
                 tokenized_prompts: Optional[Dict[str, np.ndarray]] = None,
                 mesh: Optional[Mesh] = None):
        if mode not in ("canvas", "host", "eval"):
            raise ValueError(f"unknown --aug_mode {mode!r}")
        if batch_size > len(samples):
            raise ValueError(
                f"batch_size {batch_size} > dataset size {len(samples)} "
                "(drop_last leaves no batches)")
        _check_divides(batch_size, mesh)
        self.rows = slice(0, batch_size) if mesh is None else mesh.rows(
            batch_size)
        self.samples = list(samples)
        self.batch_size = batch_size
        self.mode = mode
        self.n_px = n_px
        self.num_workers = max(1, num_workers)
        self.tokenized_prompts = tokenized_prompts
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples) // self.batch_size

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._rng.permutation(len(self.samples))
        bs = self.batch_size
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order) - bs + 1, bs):
                chunk = [self.samples[i] for i in order[start: start + bs]]
                mine = chunk[self.rows]
                batch: Dict[str, np.ndarray] = {
                    "labels": np.array([s.label for s in chunk], np.int32),
                    "source": np.array([s.is_fewshot for s in chunk],
                                       np.int32),
                }
                if self.mode == "canvas":
                    batch["canvases"], batch["valid_hw"] = train_canvases(
                        mine, self.num_workers)
                elif self.mode == "eval":
                    batch["images"] = np.stack(list(pool.map(
                        lambda s: eval_preprocess(load_image(s.path),
                                                  self.n_px),
                        mine))).astype(np.float32)
                else:
                    # one generator an image (a Generator is not thread
                    # safe), seeded in the batch's order
                    seeds = self._rng.integers(2 ** 63, size=len(chunk))
                    batch["images"] = np.stack(list(pool.map(
                        lambda task: host_train_preprocess(
                            load_image(task[0].path),
                            np.random.default_rng(task[1]), self.n_px),
                        zip(mine, seeds[self.rows])))).astype(np.float32)
                if self.tokenized_prompts is not None:
                    rows = [self.tokenized_prompts[str(s.label)]
                            for s in chunk]
                    batch["prompt_tokens"] = np.stack(
                        [r[self._rng.integers(r.shape[0])] for r in rows]
                    ).astype(np.int32)
                yield batch

    def __iter__(self):
        return _prefetch(self._batches())


class CyclingLoader:
    """Wraps a loader to cycle forever (the reference's try/except
    StopIteration pattern for the second loader of mixed methods,
    utils/training.py:724-737)."""

    def __init__(self, loader):
        self.loader = loader
        self._it = None

    def next(self):
        if self._it is None:
            self._it = iter(self.loader)
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)


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


class WeightedSampler:
    """Inverse-class-frequency sampling with replacement: the CMO second
    loader (reference utils/dataloader.py:229-246)."""

    def __init__(self, samples: Sequence[Sample], num_classes: int,
                 cmo_alpha: float = 1.0, seed: int = 1):
        counts = np.bincount([s.label for s in samples],
                             minlength=num_classes).astype(np.float64)
        counts = np.maximum(counts, 1)
        cls_weight = 1.0 / (counts ** cmo_alpha)
        cls_weight = cls_weight / cls_weight.sum()
        self.p = np.array([cls_weight[s.label] for s in samples])
        self.p = self.p / self.p.sum()
        self.samples = list(samples)
        self._rng = np.random.default_rng(seed)

    def draw(self, n: int) -> List[Sample]:
        idx = self._rng.choice(len(self.samples), size=n, replace=True,
                               p=self.p)
        return [self.samples[i] for i in idx]


class WeightedTrainLoader(TrainLoader):
    """TrainLoader whose epoch is a WeightedSampler draw of as many samples
    as the split holds, shuffled; the sampler is seeded from the loader's
    own generator at construction, before the first permutation."""

    def __init__(self, samples, num_classes: int, cmo_alpha: float = 1.0,
                 **kw):
        super().__init__(samples, **kw)
        self._sampler = WeightedSampler(
            samples, num_classes, cmo_alpha,
            seed=int(self._rng.integers(2 ** 31)))

    def _batches(self):
        drawn = self._sampler.draw(len(self.samples))
        orig = self.samples
        self.samples = drawn
        try:
            yield from super()._batches()
        finally:
            self.samples = orig
