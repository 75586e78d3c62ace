"""The serving side of the PyTorch port on the CPU against swat_tpu's: the
standalone eval CLI (``swat_tpu_torch.cli.test``) and the checkpoint
converter (``swat_tpu_torch.cli.convert``) on the same OpenCLIP-format
checkpoint, stage bundle and synthetic dataset, and ``--checkpoint_path``
given a converted ``.msgpack`` bundle.

Tolerances: the printed lines, the confusion matrices, the predicted
labels, the ``--utrain_out`` files and the bundles are equal; the
predicted rows' max logits (fp32 dot products of features from another
framework's products) agree to 1e-5 relative to the largest of the
split's: logits near 0 carry the cancellation error of their terms, 1.1e-6
measured beside logits up to 1.36."""

import os

import numpy as np
import pytest
import torch
from torch_port_lib import (DATASET, TORCH_THREADS, make_dataset,
                            random_state_dict, register_dataset, run_kwargs,
                            summary_line, write_v2_tree)

from swat_tpu.cli import convert as jax_convert_cli
from swat_tpu.cli import test as jax_test_cli
from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.eval import metrics as jax_metrics
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.cli import convert as convert_cli
from swat_tpu_torch.cli import test as test_cli
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.eval import metrics
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.checkpoint import save_best_model
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)

CFG = get_model_config("test_tiny")
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """dataset_path, the OpenCLIP .pt, a stage-1 bundle (finetuned
    weights, head, best-tau head, WiSE-FT head and backbone), and the
    port's fp32 and int8 conversions of the .pt."""
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=10)
    write_v2_tree(dataset_path)
    sd = random_state_dict(CFG, seed=0)
    ckpt = str(base / "tiny.pt")
    torch.save(sd, ckpt)
    rng = np.random.default_rng(0)

    def head():
        return rng.normal(size=(3, CFG.embed_dim)).astype(np.float32)

    bundle = save_best_model(
        str(base), 1, best_records={"best_epoch": 3},
        model_params=random_state_dict(CFG, seed=1), head=head(),
        logit_scale=np.float32(3.2), test_acc=50.0, best_tau=0.5,
        best_tau_head=head(), wsft_head=head(),
        wsft_backbone=random_state_dict(CFG, seed=2))
    converted = {}
    for quantize in ("none", "int8"):
        converted[quantize] = str(base / f"tiny_{quantize}.msgpack")
        convert_cli.convert(ckpt, "test_tiny", converted[quantize],
                            quantize=quantize, device="cpu")
    yield dataset_path, ckpt, bundle, converted
    undo()


def _argv(dataset_path, folder, extra):
    return ["--dataset", DATASET, "--dataset_path", dataset_path,
            "--retrieved_path", dataset_path, "--model_cfg", "test_tiny",
            "--bsz", "8", "--num_workers", "2", "--folder", str(folder),
            *extra]


def _run(main, module, argv, capsys, monkeypatch):
    """-> (printed lines, the confusion matrix calculate_scores got)."""
    seen = []
    real = module.calculate_scores

    def record(cm):
        seen.append(np.asarray(cm))
        return real(cm)

    monkeypatch.setattr(module, "calculate_scores", record)
    main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith((f"{DATASET},", "{"))]
    (cm,) = seen
    return lines, cm


# one run of each CLI a case: the stage bundle through each --which_head,
# with --predict_labels / --utrain_out, --tau with the OOD sweep, and
# --quantize int8
CASES = {
    "head-predict": ["--which_head", "head", "--predict_labels", "{tmp}/p",
                     "--utrain_out", "{tmp}/u"],
    "best_tau_head-tau-ood": ["--which_head", "best_tau_head", "--tau", "0.5",
                              "--test_imagenet_ood"],
    "wsft_head-int8": ["--which_head", "wsft_head", "--quantize", "int8"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_test_matches_swat_tpu(setup, tmp_path, capsys, monkeypatch,
                                   case):
    dataset_path, _, bundle, _ = setup
    outs = {}
    for pkg, main, module in (("jax", jax_test_cli.main, jax_metrics),
                              ("port", test_cli.main, metrics)):
        extra = [a.replace("{tmp}", str(tmp_path / pkg))
                 for a in CASES[case]]
        os.makedirs(tmp_path / pkg)
        argv = _argv(dataset_path, tmp_path / pkg / "out",
                     ["--model_path", bundle, *extra])
        if pkg == "port":
            argv += ["--device", "cpu"]
        outs[pkg] = _run(main, module, argv, capsys, monkeypatch)
    (lines, cm), (ref_lines, ref_cm) = outs["port"], outs["jax"]
    assert lines == ref_lines
    assert lines[0].startswith(f"{DATASET},test.txt,")
    np.testing.assert_array_equal(cm, ref_cm)
    assert cm.sum() == 30
    if "ood" in case:
        assert lines[1].startswith('{"imagenet_v2": ')
    if case == "head-predict":
        got = np.loadtxt(tmp_path / "port" / "p")
        ref = np.loadtxt(tmp_path / "jax" / "p")
        assert got.shape == ref.shape == (30, 2)
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])
        np.testing.assert_allclose(
            got[:, 1], ref[:, 1], rtol=LOGIT_RTOL,
            atol=LOGIT_RTOL * np.abs(ref[:, 1]).max())
        with open(tmp_path / "port" / "u", "rb") as f, \
                open(tmp_path / "jax" / "u", "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_convert_cli_bundles_byte_equal(setup, tmp_path, capsys, quantize):
    """The same printed JSON report, bundle and sidecar, fp32 and int8."""
    _, ckpt, _, _ = setup
    outs = {}
    for pkg, main in (("jax", jax_convert_cli.main),
                      ("port", convert_cli.main)):
        out = str(tmp_path / f"{pkg}.msgpack")
        argv = ["--checkpoint", ckpt, "--model_cfg", "test_tiny",
                "--output", out, "--quantize", quantize]
        main(argv + (["--device", "cpu"] if pkg == "port" else []))
        with open(out, "rb") as f, open(out + ".json", "rb") as g:
            outs[pkg] = (capsys.readouterr().out, f.read(), g.read())
    assert outs["port"] == outs["jax"]
    assert ('"quantize": "int8"' in outs["port"][0]) == (quantize == "int8")


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_zeroshot_from_converted_checkpoint(setup, tmp_path, capsys,
                                            quantize):
    """--checkpoint_path <bundle>.msgpack: fp32 gives the .pt run's
    summary line and prompt tensors; int8 (a W8A8 zero-shot run, prompts
    encoded by the int8 text tower) swat_tpu's line from the same bundle."""
    dataset_path, ckpt, _, converted = setup
    port = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path / "port",
        checkpoint_path=converted[quantize])))
    port.run()
    line = summary_line(capsys.readouterr().out)
    assert port.model.is_int8 == (quantize == "int8")
    if quantize == "none":
        ref = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
            dataset_path, tmp_path / "pt", checkpoint_path=ckpt)))
        for cid, t in ref.prompt_tensors.items():
            assert np.array_equal(port.prompt_tensors[cid]["all"], t["all"])
    else:
        ref = JaxPipeline(JaxRunConfig(**run_kwargs(
            dataset_path, tmp_path / "jax",
            checkpoint_path=converted[quantize])).derived())
    ref.run()
    assert line == summary_line(capsys.readouterr().out)


def test_training_from_an_int8_checkpoint_is_refused(setup, tmp_path):
    dataset_path, _, _, converted = setup
    pipe = SwatPipeline(RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=converted["int8"],
        method="finetune", epochs=1, skip_stage2=True)))
    with pytest.raises(ValueError, match="int8"):
        pipe.run()
