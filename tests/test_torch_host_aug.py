"""The host train transform and the loaders of stage 2 against swat_tpu's:
host_train_preprocess (the reference's PIL RandomResizedCrop + flip +
normalize, --aug_mode host), TrainLoader(mode="host"), TrainSnapshotLoader
(probing's train-transform feature snapshot, with the reference's
shuffle-and-drop extraction) and FeatureBatches.  Both packages draw from
numpy generators seeded alike, so every array must be bit-equal."""

import numpy as np
import pytest
from PIL import Image

from swat_tpu.data import pipeline as JP
from swat_tpu.data import transforms as JT
from swat_tpu.data.splits import Sample as JaxSample
from swat_tpu_torch.data import pipeline as P
from swat_tpu_torch.data import transforms as T
from swat_tpu_torch.data.splits import Sample

# (width, height, mode): wide and tall images miss some or all of the ten
# crop attempts at scale (0.9, 1) (all of them: the ratio-clamped centre
# crop); palette and greyscale images resample in their own mode and
# convert after
SIZES = [(48, 40, "RGB"), (60, 40, "RGB"), (40, 60, "RGB"), (33, 33, "RGB"),
         (120, 35, "RGB"), (50, 47, "P"), (45, 52, "L"), (41, 39, "RGBA")]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("imgs")
    paths = []
    for i, (w, h, mode) in enumerate(SIZES * 2):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img = Image.fromarray(arr, "RGB")
        if mode == "P":
            img = img.quantize(32)
        elif mode != "RGB":
            img = img.convert(mode)
        path = str(root / f"img{i}.{'png' if mode != 'RGB' else 'jpg'}")
        img.save(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_host_train_preprocess_is_swat_tpus(images, seed):
    for path in images:
        got = T.host_train_preprocess(T.load_image(path),
                                      np.random.default_rng(seed), 32)
        ref = JT.host_train_preprocess(JT.load_image(path),
                                       np.random.default_rng(seed), 32)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=path)


def test_host_train_preprocess_takes_the_centre_crop_fallback(images):
    """A 3:2 image at scale (0.9, 1.0) and ratio (1, 1): every attempt
    leaves the image, and the crop is the ratio-clamped centre, whatever
    the draws."""
    crops = {T.host_train_preprocess(T.load_image(images[1]),
                                     np.random.default_rng(s), 32,
                                     ratio=(1.0, 1.0)).tobytes()
             for s in range(6)}
    # the only draw left is the flip: two images
    assert len(crops) == 2


def _samples(paths, cls):
    return [cls(p, i % 3, i % 2) for i, p in enumerate(paths)]


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) and len(got) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k


@pytest.mark.parametrize("seed", [1, 5])
def test_train_loader_host_mode_is_swat_tpus(images, seed):
    """Two epochs of shuffled, drop-last batches, each image through its
    own generator seeded from the loader's draws."""
    got_loader = P.TrainLoader(_samples(images, Sample), batch_size=5,
                               seed=seed, mode="host", n_px=32,
                               num_workers=2)
    ref_loader = JP.TrainLoader(_samples(images, JaxSample), batch_size=5,
                                seed=seed, mode="host", n_px=32,
                                num_workers=2)
    for _ in range(2):
        _assert_batches_equal(list(got_loader), list(ref_loader))


@pytest.mark.parametrize("mode,drop", [("train", 0), ("train", 4),
                                       ("eval", 0), ("eval", 4)])
def test_train_snapshot_loader_is_swat_tpus(images, mode, drop):
    """The snapshot pass: padded, masked batches in a fixed order, each image
    through its (seed, crc32(path)) generator; with shuffle_drop_bsz the
    reference's shuffled drop-last extraction (at 4, 16 images keep 16 and
    14 keep 12)."""
    for samples in (images, images[:14]):
        kw = dict(batch_size=6, n_px=32, num_workers=2, seed=3,
                  shuffle_drop_bsz=drop, mode=mode)
        got = list(P.TrainSnapshotLoader(_samples(samples, Sample), **kw))
        ref = list(JP.TrainSnapshotLoader(_samples(samples, JaxSample), **kw))
        _assert_batches_equal(got, ref)
        kept = sum(int(b["mask"].sum()) for b in got)
        assert kept == (len(samples) // drop * drop if drop
                        else len(samples))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False),
                                               (True, False)])
def test_feature_batches_are_swat_tpus(shuffle, drop_last):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((11, 8)).astype(np.float32)
    labels = rng.integers(0, 3, 11).astype(np.int32)
    for source in (None, rng.integers(0, 2, 11)):
        kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
                  seed=7, source=source)
        got = P.FeatureBatches(feats, labels, **kw)
        ref = JP.FeatureBatches(feats, labels, **kw)
        assert len(got) == len(ref)
        for _ in range(2):
            _assert_batches_equal(list(got), list(ref))
