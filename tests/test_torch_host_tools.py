"""The port's host-only copies against swat_tpu's on the same inputs:
analysis.results (the paper tables, aggregate, compare_to_paper, main),
analysis.figures (every numeric function; each plot writes a PNG),
eval.analysis.worst_k_classes, data.creators and cli.prepare_data (the
output trees byte-equal on the reference tests' synthetic raw trees), and
data.legacy's split readers."""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from swat_tpu.analysis import figures as jax_figures
from swat_tpu.analysis import results as jax_results
from swat_tpu.cli import prepare_data as jax_prepare
from swat_tpu.data import creators as jax_creators
from swat_tpu.data import legacy as jax_legacy
from swat_tpu.eval import analysis as jax_analysis
from swat_tpu_torch.analysis import figures, results
from swat_tpu_torch.cli import prepare_data
from swat_tpu_torch.data import creators, legacy
from swat_tpu_torch.eval import analysis
from swat_tpu_torch.eval.metrics import calculate_scores

def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        value = fn(*args, **kw)
    return value, buf.getvalue()


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _same(a, b):
    """Deep equality of results that hold numpy arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------- results

TABLES = ["SWAT_PAPER", "ZEROSHOT_PAPER", "REAL_LINEAR_PAPER", "CMLP_PAPER",
          "CLAP_PAPER", "FT_FEWSHOT_PAPER", "FT_RETRIEVED_PAPER",
          "SWAT_PLUS_PAPER", "SWAT_IMPROVED_PAPER", "PAPER_TABLES",
          "SHOT_INDEX"]


@pytest.mark.parametrize("name", TABLES)
def test_results_tables_match(name):
    assert getattr(results, name) == getattr(jax_results, name)


def _results_dir(tmp_path):
    rng = np.random.default_rng(0)
    header = ("Dataset,Method,DataSource,Init,Shots,Seed,Retrieve,Stage1Acc,"
              "WSFTAcc,Stage2LPAcc,Stage2FSFTAcc")
    d = tmp_path / "results"
    d.mkdir()
    for ds in ("semi-aves", "dtd", "eurosat", "some-other"):
        lines = [header]
        for shots in (4, 8, 16):
            for seed in (1, 2, 3):
                accs = rng.uniform(40, 95, 4).round(1)
                if seed == 3 and shots == 8:
                    accs[2] = -1.0                 # a run without stage 2
                lines.append(f"{ds},cutmix,fewshot+retrieved,REAL-Prompt,"
                             f"{shots},{seed},T2T500,"
                             + ",".join(str(a) for a in accs))
        (d / f"{ds}.csv").write_text("\n".join(lines) + "\n")
    (d / "notes.txt").write_text("not a csv\n")
    return d


@pytest.mark.parametrize("table", sorted(results.PAPER_TABLES))
@pytest.mark.parametrize("acc_col", ["Stage1Acc", "Stage2LPAcc"])
def test_results_aggregate_compare_and_main_match(tmp_path, table, acc_col):
    d = _results_dir(tmp_path)
    rows = [r for fn in sorted(os.listdir(d)) if fn.endswith(".csv")
            for r in results.read_results_csv(str(d / fn))]
    jrows = [r for fn in sorted(os.listdir(d)) if fn.endswith(".csv")
             for r in jax_results.read_results_csv(str(d / fn))]
    assert rows == jrows and len(rows) == 36
    agg = results.aggregate(rows, acc_col)
    assert agg == jax_results.aggregate(rows, acc_col)
    assert (results.compare_to_paper(agg, 0.7, table=table)
            == jax_results.compare_to_paper(agg, 0.7, table=table))
    argv = ["--results_dir", str(d), "--acc_col", acc_col,
            "--paper_table", table, "--tolerance", "1.5"]
    got, jgot = _printed(results.main, argv), _printed(jax_results.main, argv)
    assert got == jgot and "mean delta" in got[1]


# ---------------------------------------------------------------- figures

def _scores(recall, acc):
    return {"acc": acc,
            "per_class_recall": {str(i): r for i, r in enumerate(recall)}}


@pytest.fixture
def figure_inputs(tmp_path):
    rng = np.random.default_rng(1)
    split = tmp_path / "T2T.txt"
    split.write_text("".join(f"r/{i}.jpg {c} 0\n" for i, c in enumerate(
        rng.integers(0, 12, 200))))
    runs = {}
    for x in (10, 50, 90):
        run = tmp_path / "out" / "output_x" / f"case{x}"
        run.mkdir(parents=True)
        for stage in (1, 2, 3):
            recall = rng.uniform(0, 1, 12).round(3).tolist()
            (run / f"stage{stage}_test_scores.json").write_text(json.dumps(
                _scores(recall, float(np.mean(recall)))))
        runs[x] = str(run)
    csvs = []
    for seed in (1, 2, 3):
        p = tmp_path / f"loss{seed}.csv"
        p.write_text("Epoch,Iter,Train_loss,Val_loss,Val_acc,Test_acc\n"
                     + "".join(f"{e},{10 * e},{1 / (e + seed)},{0.5 / e},"
                               f"{40 + e},{38 + e + seed}\n"
                               for e in range(1, 7 - seed)))
        csvs.append(str(p))
    freq = {str(c): ({"name": f"c{c}", "actual_freq": int(n)} if c % 2
                     else int(n))
            for c, n in enumerate(rng.integers(1, 900, 12))}
    dl = tmp_path / "download_ct.txt"
    dl.write_text("".join(f"class {c} ct {int(n)}\n"
                          for c, n in enumerate(rng.integers(0, 700, 11))))
    res = _results_dir(tmp_path)
    return {"split": str(split), "runs": runs, "csvs": csvs, "freq": freq,
            "download_ct": str(dl), "root": str(tmp_path / "out"),
            "results": {"a": str(res / "dtd.csv"),
                        "b": str(res / "semi-aves.csv")},
            "head": rng.normal(size=(12, 8)),
            "counts": {str(c): int(n) for c, n in
                       enumerate(rng.integers(0, 50, 12))},
            "sampled": {"A": {str(c): int(n) for c, n in
                              enumerate(rng.integers(1, 400, 20))},
                        "B": {str(c): int(n) for c, n in
                              enumerate(rng.integers(1, 90, 9))}}}


NUMERIC = {
    "class_counts_from_split": lambda F, i, out: F.class_counts_from_split(
        i["split"]),
    "head_tail_accuracy": lambda F, i, out: F.head_tail_accuracy(
        _scores(np.linspace(0, 1, 12).tolist(), 0.5), i["counts"], 0.75),
    "stagewise_head_tail_row": lambda F, i, out: F.stagewise_head_tail_row(
        i["runs"][50], i["counts"]),
    "head_weight_norms": lambda F, i, out: F.head_weight_norms(i["head"]),
    "head_weight_norms_sorted": lambda F, i, out: F.head_weight_norms(
        i["head"], i["counts"]),
    "read_loss_csv": lambda F, i, out: F.read_loss_csv(i["csvs"][0]),
    "retrieved_distribution": lambda F, i, out: F.retrieved_distribution(
        i["split"], 14),
    "collect_stage_accs": lambda F, i, out: F.collect_stage_accs(i["root"]),
    "collect_sweep_accs": lambda F, i, out: F.collect_sweep_accs(i["runs"],
                                                                 stage=3),
    "match_vs_download_counts": lambda F, i, out: F.match_vs_download_counts(
        i["freq"], F.read_download_counts(i["download_ct"])),
    "read_download_counts": lambda F, i, out: F.read_download_counts(
        i["download_ct"]),
    "ablate_table": lambda F, i, out: F.ablate_table(i["results"]),
    "ablate_table_stage1": lambda F, i, out: F.ablate_table(
        i["results"], acc_col="Stage1Acc"),
}

PLOTS = {
    "plot_weight_norms": lambda F, i, out: F.plot_weight_norms(
        F.head_weight_norms(i["head"]), F.head_weight_norms(i["head"] * 2),
        "dtd", out),
    "plot_loss_curves": lambda F, i, out: F.plot_loss_curves(i["csvs"][1],
                                                             out),
    "plot_retrieved_distribution":
        lambda F, i, out: F.plot_retrieved_distribution(i["split"], 12, out),
    "plot_ablation_curve": lambda F, i, out: F.plot_ablation_curve(
        *F.collect_sweep_accs(i["runs"])[:1],
        {"Aves": F.collect_sweep_accs(i["runs"])[1]}, vline=50,
        vline_label="SWAT", xlabel="epochs", out_png=out),
    "plot_sorted_retrieved_counts":
        lambda F, i, out: F.plot_sorted_retrieved_counts(i["sampled"], out),
    "plot_retraining_curves": lambda F, i, out: F.plot_retraining_curves(
        {"Aves": i["csvs"]}, out_png=out),
    "plot_domain_gap": lambda F, i, out: F.plot_domain_gap(
        {"zeroshot": {"semi-aves": 54.9}, "SWAT": {"semi-aves": 63.1,
                                                   "dtd": 68.0}}, out),
    "plot_match_vs_download": lambda F, i, out: F.plot_match_vs_download(
        i["freq"], F.read_download_counts(i["download_ct"]), out),
}


@pytest.mark.parametrize("name", sorted(NUMERIC) + sorted(PLOTS))
def test_figures_match(figure_inputs, tmp_path, name):
    fn = NUMERIC.get(name) or PLOTS[name]
    outs = [str(tmp_path / f"{pkg}_{name}.png") for pkg in ("port", "jax")]
    got = fn(figures, figure_inputs, outs[0])
    ref = fn(jax_figures, figure_inputs, outs[1])
    assert _same(got, ref), (got, ref)
    if name in PLOTS:
        with open(outs[0], "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert os.path.getsize(outs[0]) > 1000


def test_figures_cli_matches(figure_inputs, tmp_path):
    i = figure_inputs
    argvs = [["head-tail", "--output_dir", i["runs"][10], "--split",
              i["split"]],
             ["stage-table", "--output_root", i["root"]],
             ["ablate-table", "--configs", f"a={i['results']['a']}",
              f"b={i['results']['b']}", "--acc_col", "WSFTAcc"]]
    for argv in argvs:
        assert _printed(figures.main, argv) == _printed(jax_figures.main,
                                                        argv)


# ---------------------------------------------------------------- worst-k

@pytest.mark.parametrize("n_worst,top,names", [(30, 15, False), (3, 2, True),
                                               (5, 4, True)])
def test_worst_k_classes_match(n_worst, top, names):
    rng = np.random.default_rng(n_worst)
    cm = rng.integers(0, 6, (9, 9))
    np.fill_diagonal(cm, rng.integers(1, 6, 9))
    cm[2] = 0                                  # the one recall of 0
    cm[2, 5] = cm[2, 6] = 4                    # a tie among the confusions
    scores = calculate_scores(cm)
    id_to_name = ({str(c): f"class {c}" for c in range(9)} if names
                  else None)
    got = analysis.worst_k_classes(scores, cm, n_worst, top, id_to_name)
    ref = jax_analysis.worst_k_classes(scores, cm, n_worst, top,
                                       id_to_name)
    assert got == ref and list(got)[0] == "2"


# ---------------------------------------------------------------- creators

COOP_JSON = {
    "oxford_pets": "oxford_pets/split_zhou_OxfordPets.json",
    "food101": "food101/split_zhou_Food101.json",
    "stanford_cars": "stanford_cars/split_zhou_StanfordCars.json",
    "dtd": "dtd/dtd/split_zhou_DescribableTextures.json",
    "eurosat": "eurosat/split_zhou_EuroSAT.json",
    "flowers102": "flowers102/split_zhou_OxfordFlowers.json",
}


def _write_raw(raw, dataset):
    """A raw download tree for ``dataset`` in the shape of
    tests/test_creators.py's."""
    rng = np.random.default_rng(len(dataset))
    if dataset in COOP_JSON:
        path = raw / COOP_JSON[dataset]
        path.parent.mkdir(parents=True, exist_ok=True)
        split = {s: [[f"cls{c}/{s}_{i}.jpg", int(c), f"name {c}"]
                     for i, c in enumerate(rng.integers(0, 5, n))]
                 for s, n in (("train", 9), ("val", 4), ("test", 6))}
        path.write_text(json.dumps(split))
    elif dataset == "imagenet":
        (raw / "imagenet").mkdir(parents=True)
        split = {
            "train": [["train/n01440764/n01440764_10026.JPEG", 1, "tench"],
                      ["train/n01443537/n01443537_2.JPEG", 0, "goldfish"]],
            "val": [["train/n01440764/n01440764_999.JPEG", 1, "tench"]],
            "test": [["val/n01440764/ILSVRC2012_val_00000293.JPEG", 1,
                      "tench"],
                     ["val/n01443537/ILSVRC2012_val_00000236.JPEG", 0,
                      "goldfish"]]}
        (raw / "imagenet" / "split_ImageNet.json").write_text(
            json.dumps(split))
    elif dataset == "fgvc-aircraft":
        base = raw / "fgvc-aircraft" / "fgvc-aircraft-2013b" / "data"
        base.mkdir(parents=True)
        (base / "variants.txt").write_text("707-320\nA300 B4\nDC-9-30\n")
        for split, rows in [("train", ["0034309 A300 B4", "0034958 707-320",
                                       "0035001 DC-9-30"]),
                            ("val", ["1111111 A300 B4"]),
                            ("test", ["2222222 707-320", "2222223 DC-9-30"])]:
            (base / f"images_variant_{split}.txt").write_text(
                "\n".join(rows) + "\n")
    else:
        assert dataset == "semi-aves"
        base = raw / "dataset" / "semi-aves"
        base.mkdir(parents=True)
        (base / "l_train.txt").write_text(
            "trainval_images/a.jpg 5 0\ntrainval_images/b.jpg 2 0\n")
        (base / "val.txt").write_text("trainval_images/c.jpg 2 0\n")
        (base / "test.txt").write_text("test_images/d.jpg 5 0\n")


@pytest.mark.parametrize("dataset", sorted(jax_creators.CREATORS))
def test_creators_write_swat_tpu_trees(tmp_path, dataset):
    assert sorted(creators.CREATORS) == sorted(jax_creators.CREATORS)
    raw = tmp_path / "raw"
    _write_raw(raw, dataset)
    trees, logs = {}, {}
    for pkg, mod in (("port", creators), ("jax", jax_creators)):
        out = tmp_path / pkg / dataset
        _, logs[pkg] = _printed(mod.create_labels, dataset, str(raw),
                                str(out))
        trees[pkg] = _tree(out)
    assert trees["port"] == trees["jax"] and len(trees["port"]) >= 3
    assert logs["port"] == logs["jax"].replace(str(tmp_path / "jax"),
                                               str(tmp_path / "port"))
    with pytest.raises(SystemExit):
        creators.create_labels("nope", str(raw), str(tmp_path))


def _prepare_tree(root):
    ds = root / "semi-aves"
    ds.mkdir(parents=True)
    lines = [f"imgs/{c}_{i}.jpg {c} 1" for c in (3, 0, 7, 1) for i in
             range(7 if c != 7 else 2)]
    (ds / "ltrain+val.txt").write_text("\n".join(lines) + "\n")
    split = {"train": [["b/y.jpg", 1, "dog"], ["a/x.jpg", 0, "cat"]],
             "test": [["c/z.jpg", 1, "dog"]]}
    (ds / "split.json").write_text(json.dumps(split))
    for sub in ("pre_extracted", "prompts"):
        (ds / sub).mkdir()
        (ds / sub / "cache.pth").write_bytes(b"features")
    return ds


PREPARE = {
    "fewshot": ["fewshot", "--dataset", "semi-aves", "--shots", "2", "4",
                "--seeds", "1", "2", "3"],
    "labels": ["labels", "--dataset", "semi-aves", "--split_json",
               "split.json", "--prefix", "images/"],
    "cleanup": ["cleanup", "--dataset", "semi-aves"],
    "create": ["create", "--dataset", "fgvc-aircraft", "--raw_root", "RAW"],
}


@pytest.mark.parametrize("cmd", sorted(PREPARE))
def test_prepare_data_writes_swat_tpu_trees(tmp_path, cmd):
    """Each subcommand through both packages' main on the same tree: the
    same files, byte for byte (the few-shot files drawn with Python's
    random under the same seeds), and the same lines printed."""
    raw = tmp_path / "raw"
    _write_raw(raw, "fgvc-aircraft")
    trees, logs = {}, {}
    for pkg, mod in (("port", prepare_data), ("jax", jax_prepare)):
        root = tmp_path / pkg
        _prepare_tree(root)
        argv = [str(raw) if a == "RAW" else a for a in PREPARE[cmd]]
        _, out = _printed(mod.main, argv + ["--dataset_path", str(root)])
        logs[pkg] = out.replace(str(root), "<root>")
        trees[pkg] = _tree(root)
    assert trees["port"] == trees["jax"]
    assert logs["port"] == logs["jax"] and logs["port"]
    if cmd == "cleanup":
        assert not any(p.startswith(("semi-aves/pre", "semi-aves/prom"))
                       for p in trees["port"])


# ---------------------------------------------------------------- legacy

def _samples(rows):
    return [(s.path, s.label, s.is_fewshot) for s in rows]


@pytest.mark.parametrize("task,pl", [("All", None), ("All", ["x/p.jpg 4"]),
                                     ("semi_fungi", ["images/z.JPG 5"])])
def test_legacy_split_reader_matches(tmp_path, task, pl):
    if task == "semi_fungi":
        (tmp_path / "u_train.txt").write_text(
            "images/x y.JPG 2\nimages/w.JPG 0\n\n")
    else:
        (tmp_path / "u_train.txt").write_text(
            "trainval_images/a.jpg 3\ntrainval_images/b.jpg 7\n")
    got = legacy.read_legacy_split(str(tmp_path), "u_train", task, pl)
    ref = jax_legacy.read_legacy_split(str(tmp_path), "u_train", task, pl)
    assert _samples(got) == _samples(ref) and len(got) == 2 + bool(pl)


@pytest.mark.parametrize("train", [True, False])
def test_cub200_reader_matches(tmp_path, train):
    meta = tmp_path / "CUB_200_2011"
    meta.mkdir()
    (meta / "images.txt").write_text("".join(
        f"{i} {1 + i % 3:03d}.Bird/{i}.jpg\n" for i in range(1, 12)))
    (meta / "image_class_labels.txt").write_text("".join(
        f"{i} {1 + i % 3}\n" for i in range(1, 11)))       # 11 unlabeled
    (meta / "train_test_split.txt").write_text("".join(
        f"{i} {i % 2}\n" for i in range(1, 12)))
    got = legacy.read_cub200_split(str(tmp_path), train)
    ref = jax_legacy.read_cub200_split(str(tmp_path), train)
    assert _samples(got) == _samples(ref) and len(got) == 5
