"""The port's retrieval CLI (``python -m swat_tpu_torch.retrieval.cli``,
``--device cpu``) against ``swat_tpu.retrieval.cli`` on the same inputs:
a mined tree of 3 classes x 4 JPEGs with its download metadata and the
test-size towers' OpenCLIP ``.pt``.

``captionmap`` -> ``extract`` -> ``sample``: the caption maps byte-equal;
the mined-feature bundles with the same keys, dtypes, labels, paths and
captions, their features within the bf16 towers' bound (cosine >= 1 -
1e-3, tests/test_torch_towers.py; ``swat_tpu``'s runs in the
excess-precision subprocess, so that XLA keeps the port's bf16 roundings),
fp32 and ``--quantize int8``; ``sample``'s split file, debug lists and
``_num_imgs_sampled.json`` byte-equal when both packages read the same
bundle, each package's in turn.  ``filter-synonyms``'s output byte-equal.
The host-only subcommands (``stringmatch``, ``ingest``, ``make-urls`` from
a local table, ``check-metrics``, ``mine-synonyms --recorded``): their
files byte-equal.  Each comparison of scores asserts first that no score
lies within 1e-5 of a gate or of a rival, nor within 1e-6 of a 4-decimal
rounding edge of a debug line, so that equal outputs are not luck."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_lib import (TORCH_THREADS, cosine,
                            excess_precision_subprocess, random_state_dict,
                            same_native_decoders)

from swat_tpu.retrieval import cli as jax_cli
from swat_tpu_torch.data.features import batched_encode, make_text_encoder
from swat_tpu_torch.data.prompts import save_prompt_tensors
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.models.tokenizer import get_tokenizer
from swat_tpu_torch.retrieval import cli

torch.set_num_threads(TORCH_THREADS)

MODEL = "test_tiny"
CFG = get_model_config(MODEL)
NAMES = ["red thing", "green thing", "blue thing"]
PER_CLASS = 4
TOWER_MIN_COS = 1 - 1e-3
MARGIN = 1e-5
QUANTIZE = ("none", "int8")
SYNONYMS = {"0": ["crimson thing", "scarlet item", "ruby"],
            "1": ["emerald object", "lime thing", "leaf"],
            "2": ["azure item", "indigo thing", "ocean"]}


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _synonym_texts():
    return ([f"a photo of a {n}" for n in NAMES]
            + [f"a photo of a {s}" for k in sorted(SYNONYMS)
               for s in SYNONYMS[k]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, both packages' captionmap, extract (fp32 and int8) and
    filter-synonyms runs; swat_tpu's extract and filter-synonyms in one
    excess-precision subprocess."""
    same_native_decoders()
    base = tmp_path_factory.mktemp("retrieval")
    rng = np.random.default_rng(0)
    metadata = {}
    for c, name in enumerate(NAMES):
        os.makedirs(base / "mined" / str(c))
        metadata[str(c)] = {}
        for i in range(PER_CLASS):
            img = rng.integers(0, 256, (40 + 6 * i, 48, 3), dtype=np.uint8)
            Image.fromarray(img).save(base / "mined" / str(c) / f"{i}.jpg")
            metadata[str(c)][str(i)] = {"caption": f"photo {i} of a {name}"}
    (base / "meta.json").write_text(json.dumps(metadata))
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(CFG, seed=0), ckpt)
    (base / "synonyms.json").write_text(json.dumps({
        k: {"query_name": NAMES[int(k)],
            "synonyms": {s: 1 for s in v}} for k, v in SYNONYMS.items()}))

    def argvs(pkg):
        out = base / pkg
        os.makedirs(out)
        tower = ["--model_cfg", MODEL, "--checkpoint_path", ckpt]
        extract = [["extract", "--mined_dir", str(base / "mined"),
                    "--caption_map", str(base / "cmap.json"),
                    "--bsz", "8", "--quantize", q, *tower,
                    "--output", str(out / f"mined_{q}.npz")]
                   for q in QUANTIZE]
        synonyms = [["filter-synonyms", "--synonyms",
                     str(base / "synonyms.json"), *tower,
                     "--output", str(out / "synonyms.json")]]
        return extract + synonyms

    outs = {}
    for pkg, main in (("jax", jax_cli.main), ("port", cli.main)):
        os.makedirs(base / "cmaps" / pkg)
        main(["captionmap", "--metadata", str(base / "meta.json"),
              "--output", str(base / "cmaps" / pkg / "cmap.json")])
    (base / "cmap.json").write_bytes(
        (base / "cmaps" / "jax" / "cmap.json").read_bytes())
    jax_argvs = argvs("jax")
    outs["jax"] = excess_precision_subprocess(
        f"jax_retrieval_runs({jax_argvs!r}, {_synonym_texts()!r}, "
        f"{ckpt!r}, {MODEL!r}, {str(base / 'jax_text.npz')!r})",
        str(base / "jax_text.npz"))
    for argv in argvs("port"):
        cli.main(argv + ["--device", "cpu"])
    return base, ckpt, outs["jax"]["text_features"]


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_captionmap_byte_equal(runs):
    base = runs[0]
    assert _files(base / "cmaps" / "port") == _files(base / "cmaps" / "jax")


@pytest.mark.parametrize("quantize", QUANTIZE)
def test_extract_matches_swat_tpu(runs, quantize):
    base = runs[0]
    got = _load(base / "port" / f"mined_{quantize}.npz")
    ref = _load(base / "jax" / f"mined_{quantize}.npz")
    assert sorted(got) == sorted(ref) == [
        "caption_features", "captions", "file_paths", "image_features",
        "labels"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
    for k in ("captions", "file_paths", "labels"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["image_features"].shape == (3 * PER_CLASS, CFG.embed_dim)
    assert got["captions"][1] == "photo 1 of a red thing"
    for k in ("image_features", "caption_features"):
        assert cosine(got[k], ref[k]).min() >= TOWER_MIN_COS, k


def _sample_margins(bundle, prompts, fewshot, gates):
    """No score the sample runs below print or compare lies within MARGIN of
    a rival or a gate, or within 1e-6 of a 4-decimal rounding edge: the
    prompt's against captions and images, the exemplars' max against
    images, the zero-shot logits' top two, and the images' pairwise
    similarities against the dedup threshold."""
    img = bundle["image_features"].astype(np.float64)
    cap = bundle["caption_features"].astype(np.float64)
    labels = bundle["labels"]
    head = np.stack([prompts[str(c)] for c in range(len(NAMES))])
    t2t = np.einsum("nd,nd->n", cap, head[labels])
    t2i = np.einsum("nd,nd->n", img, head[labels])
    i2i = np.array([(fewshot[c] @ x).max() for x, c in zip(img, labels)])
    for values in (t2t, t2i, i2i):
        for c in range(len(NAMES)):
            v = np.sort(values[labels == c])
            assert np.diff(v).min() > MARGIN
        assert np.abs(values[:, None] - np.asarray(gates)).min() > MARGIN
        edge = np.abs(values * 1e4 - np.floor(values * 1e4) - 0.5)
        assert edge.min() * 1e-4 > 1e-6
    logits = np.sort(img @ head.T, axis=1)
    assert (logits[:, -1] - logits[:, -2]).min() > MARGIN
    sims = img @ img.T
    assert np.abs(sims - 0.9).min() > MARGIN


SAMPLE_CASES = {
    "T2T-I2I-tshd-dedup": ["--strategy", "T2T-rank-I2I-tshd",
                           "--threshold", "-0.5", "--t2i_threshold", "-0.5",
                           "--num_samples", "3",
                           "--remove_duplicates", "--fewshot_features",
                           "{fs}"],
    "T2T-zeroshot-filter": ["--strategy", "T2T-rank", "--num_samples", "3",
                            "--zeroshot_filter"],
    "T2I-per-class": ["--strategy", "T2I-rank", "--threshold", "-0.1",
                      "--num_samples", "2", "--engine", "per-class"],
    "Random-threshold": ["--strategy", "Random", "--threshold", "0.1",
                         "--num_samples", "2", "--seed", "3"],
}


@pytest.mark.parametrize("bundle_of", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_byte_equal_on_either_bundle(runs, tmp_path, case,
                                           bundle_of):
    base = runs[0]
    features = str(base / bundle_of / "mined_none.npz")
    bundle = _load(features)
    rng = np.random.default_rng(7)
    prompts = {str(c): rng.normal(size=CFG.embed_dim) for c in range(3)}
    prompts = {c: (v / np.linalg.norm(v)).astype(np.float32)
               for c, v in prompts.items()}
    save_prompt_tensors(str(tmp_path / "prompts.npz"),
                        {c: {"all": v[None], "mean": v}
                         for c, v in prompts.items()})
    fewshot = {c: rng.normal(size=(2, CFG.embed_dim)).astype(np.float32) / 4
               for c in range(3)}
    np.savez(tmp_path / "fs.npz",
             image_features=np.concatenate([fewshot[c] for c in range(3)]),
             labels=np.repeat(np.arange(3), 2))
    _sample_margins(bundle, prompts, fewshot, gates=[0.1, -0.1, -0.5])
    extra = [a.replace("{fs}", str(tmp_path / "fs.npz"))
             for a in SAMPLE_CASES[case]]
    for pkg, main in (("jax", jax_cli.main), ("port", cli.main)):
        argv = ["sample", "--features", features, "--prompts",
                str(tmp_path / "prompts.npz"), "--relative_to",
                str(base / "mined"), *extra,
                "--output", str(tmp_path / pkg / "T2T3.txt")]
        main(argv + (["--device", "cpu"] if pkg == "port" else []))
    got = _files(tmp_path / "port")
    assert sorted(got) == ["T2T3.txt", "T2T3_filtered_list.txt",
                           "T2T3_num_imgs_sampled.json",
                           "T2T3_sampled_list.txt"]
    assert got == _files(tmp_path / "jax")
    assert got["T2T3.txt"].count(b"\n") > 0


def test_filter_synonyms_byte_equal(runs):
    """The same kept synonyms: each synonym's argmax over the class prompts
    wins by more than both packages' logits differ."""
    base, ckpt, jax_text = runs
    model = cli.load_model(MODEL, ckpt, "cpu")
    tokens = get_tokenizer(None, vocab_size=CFG.text.vocab_size)(
        _synonym_texts(), CFG.text.context_length)
    ours = batched_encode(make_text_encoder(model), np.asarray(tokens))
    c = len(NAMES)
    logits, ref = ours[c:] @ ours[:c].T, jax_text[c:] @ jax_text[:c].T
    apart = np.abs(logits - ref).max()
    top = np.sort(logits, axis=1)
    assert (top[:, -1] - top[:, -2]).min() > 2 * apart + MARGIN
    got = (base / "port" / "synonyms.json").read_bytes()
    assert got == (base / "jax" / "synonyms.json").read_bytes()
    kept = json.loads(got)
    n_kept = sum(len(v["synonyms_filtered"]) for v in kept.values())
    assert 0 < n_kept < 9


# ---------------------------------------------------------------------------
# the host-only subcommands

SHARDS = [
    [{"TEXT": "a photo of a red-winged blackbird", "URL": "http://a/0.jpg",
      "NSFW": "UNLIKELY"},
     {"TEXT": "sunset over the ocean", "URL": "http://a/1.jpg",
      "NSFW": "UNLIKELY"},
     {"TEXT": "blackbird singing at dawn", "URL": "http://a/2.jpg",
      "NSFW": "NSFW"}],
    [{"TEXT": "the common blackbird in a tree", "URL": "http://b/0.jpg",
      "NSFW": "UNSURE"},
     {"TEXT": "Ocean waves, Common Blackbird", "URL": "http://b/1.jpg",
      "NSFW": None},
     {"TEXT": "a magpie photo", "URL": "", "NSFW": "UNLIKELY"}],
]
METRICS = {
    "1": {"name": "magpie", "alternates": {"magpie": 1, "pica pica": 1}},
    "0": {"name": "common blackbird",
          "alternates": "{'blackbird': 1, 'common blackbird': 1}"},
}


def _host_inputs(root):
    for i, rows in enumerate(SHARDS):
        with open(root / f"part{i}.jsonl", "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    (root / "metrics.json").write_text(json.dumps(METRICS))
    (root / "captions.txt").write_text("\n".join(
        r["TEXT"] or "" for rows in SHARDS for r in rows) + "\n")
    (root / "classes.json").write_text(json.dumps(["kite", "dove"]))
    (root / "recorded.json").write_text(json.dumps(
        {"kite": "1. Black Kite", "dove": "1. Rock Dove\n2. Pigeon (feral)"}))


def _host_argvs(root, out):
    return [
        ["ingest", str(root / "part*.jsonl"), "--output_dir",
         str(out / "store")],
        ["stringmatch", "--index_dir", str(out / "store"), "--metrics",
         str(root / "metrics.json"), "--output_dir", str(out / "sharded"),
         "--threads", "2"],
        ["stringmatch", "--captions", str(root / "captions.txt"),
         "--metrics", str(root / "metrics.json"), "--output_dir",
         str(out / "python"), "--no_native", "--threads", "2"],
        ["stringmatch", "--captions", str(root / "captions.txt"),
         "--metrics", str(root / "metrics.json"), "--output_dir",
         str(out / "native"), "--threads", "2", "--index_path",
         str(out / "native" / "index.bin")],
        ["make-urls", "--matches",
         str(out / "sharded" / "laion_mined_captions.json"), "--store_dir",
         str(out / "store"), "--output", str(out / "urls" / "urls.parquet"),
         "--sampling", "random", "--max_images", "1", "--seed", "3"],
        ["mine-synonyms", "--dataset", "test", "--class_names",
         str(root / "classes.json"), "--recorded",
         str(root / "recorded.json"), "--output", str(out / "syn.json")],
        ["check-metrics", "--metrics", str(out / "metrics.json"),
         "--reformat"],
    ]


def test_host_subcommands_byte_equal(tmp_path, capsys):
    """Every file the host-only subcommands write, and check-metrics'
    report; no URL is fetched (make-urls only writes the table)."""
    _host_inputs(tmp_path)
    printed = {}
    for pkg, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / pkg
        os.makedirs(out)
        (out / "metrics.json").write_text(json.dumps(
            {k: dict(v, alternates={"x": 1}) for k, v in METRICS.items()}))
        for argv in _host_argvs(tmp_path, out):
            main(argv)
        printed[pkg] = [ln for ln in capsys.readouterr().out.splitlines()
                        if "problem" in ln or "not in alternates" in ln]
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert printed["port"] == printed["jax"] == [
        "1: magpie not in alternates",
        "0: common blackbird not in alternates",
        "2 problem(s) in 2 classes"]
    matched = json.loads(got["sharded/laion_mined_captions.json"])
    assert matched and matched == json.loads(
        got["python/laion_mined_captions.json"])
    assert "urls/urls.parquet" in got and "urls/urls.meta.json" in got
    assert json.loads(got["syn.json"])["1"]["synonyms"] == {
        "rock dove": 0, "pigeon": 0, "dove": 0}


def test_device_cuda_without_gpu_raises(runs, monkeypatch, tmp_path):
    """--device cuda (the default) without a card raises before any output,
    with --mesh_data above 1 too (it runs data-parallel under a launcher,
    tests/test_torch_multihost.py)."""
    base, ckpt, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = ["--mined_dir", str(base / "mined"), "--caption_map",
              str(base / "cmap.json"), "--model_cfg", MODEL,
              "--checkpoint_path", ckpt,
              "--output", str(tmp_path / "out.npz")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["extract", *common])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["sample", "--features", str(base / "port" /
                                              "mined_none.npz"),
                  "--prompts", "absent.npz", "--output",
                  str(tmp_path / "s.txt")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["extract", *common, "--mesh_data", "2"])
    assert not os.listdir(tmp_path)
