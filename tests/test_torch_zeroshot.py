"""The zero-shot slice end to end on the CPU: the same OpenCLIP-format
checkpoint and synthetic JPEG dataset through swat_tpu's SwatPipeline and
swat_tpu_torch's, under both eval engines (--resident on: the split held on
the device; off: the streaming loader).  Both runs use --recal_prompt, so
each package encodes the prompts with its own text tower (the prompt cache
path is shared)."""

import os

import numpy as np
import pytest
import torch
from torch_port_lib import (DATASET, TORCH_THREADS, make_dataset,
                            random_state_dict, register_dataset, run_kwargs,
                            write_v2_tree)

from swat_tpu.core.config import RunConfig as JaxRunConfig
from swat_tpu.train.stages import SwatPipeline as JaxPipeline
from swat_tpu_torch.core.config import RunConfig
from swat_tpu_torch.data.features import extract_image_features
from swat_tpu_torch.kernels import flash_attention as FA
from swat_tpu_torch.models.configs import get_model_config
from swat_tpu_torch.train.stages import SwatPipeline

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    undo = register_dataset()
    base = tmp_path_factory.mktemp("data")
    dataset_path = make_dataset(base, n_test_per_class=50)
    ckpt = str(base / "tiny.pt")
    torch.save(random_state_dict(get_model_config("test_tiny"), seed=0), ckpt)
    yield dataset_path, ckpt
    undo()


def _summary(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(f"{DATASET},")]
    assert len(lines) == 1, out
    return lines[0]


def _run_both(setup, tmp_path, capsys, resident):
    dataset_path, ckpt = setup
    kw = run_kwargs(dataset_path, tmp_path / "jax", checkpoint_path=ckpt,
                    resident=resident)
    jax_pipe = JaxPipeline(JaxRunConfig(**kw).derived())
    jax_pipe.run()
    jax_line = _summary(capsys.readouterr().out)
    kw["folder"] = str(tmp_path / "torch")
    port = SwatPipeline(RunConfig(device="cpu", **kw).derived())
    port.run()
    port_line = _summary(capsys.readouterr().out)
    return jax_pipe, jax_line, port, port_line


@pytest.mark.parametrize("resident", ["on", "off"])
def test_zeroshot_summary_and_confusion_match_swat_tpu(setup, tmp_path,
                                                       capsys, resident):
    jax_pipe, jax_line, port, port_line = _run_both(setup, tmp_path, capsys,
                                                    resident)
    assert port_line == jax_line
    assert port_line.split(",")[:2] == [DATASET, "zeroshot"]

    # the prompt tensors each package encoded with its own text tower
    assert sorted(port.prompt_tensors) == sorted(jax_pipe.prompt_tensors)
    for cid, ref in jax_pipe.prompt_tensors.items():
        for kind in ("all", "mean"):
            np.testing.assert_allclose(port.prompt_tensors[cid][kind],
                                       np.asarray(ref[kind]), atol=1e-5,
                                       err_msg=f"{cid}/{kind}")

    # accuracy, loss and confusion matrix of the engine under test
    log100 = float(np.log(100.0))
    j_acc, j_loss, j_cm = jax_pipe._validate_images(
        jax_pipe.params, jax_pipe.zeroshot_head, log100,
        jax_pipe.cfg.test_split, return_confusion=True)
    p_acc, p_loss, p_cm = port._validate_images(
        port.model, port.zeroshot_head, log100, port.cfg.test_split,
        return_confusion=True)
    assert p_acc == pytest.approx(j_acc, abs=1e-9)
    assert p_loss == pytest.approx(j_loss, rel=1e-5)
    np.testing.assert_array_equal(p_cm, np.asarray(j_cm))
    assert p_cm.sum() == 3 * 50

    # the same output files
    port.loss_logger.close()
    for name in ("loss.csv", "main.log"):
        assert os.path.exists(os.path.join(port.cfg.output_dir, name))
    with open(os.path.join(port.cfg.output_dir, "loss.csv")) as f:
        assert f.read() == "Epoch,Iter,Train_loss,Val_loss,Val_acc,Test_acc\n"


def test_zeroshot_logits_match_swat_tpu_per_image(setup, tmp_path, capsys):
    """The per-image zero-shot logits behind the summary, not only its
    rounded accuracy."""
    from swat_tpu.data.features import (
        extract_image_features as jax_extract_image_features)
    from swat_tpu.data.pipeline import EvalLoader as JaxEvalLoader
    from swat_tpu_torch.data.pipeline import EvalLoader

    jax_pipe, _, port, _ = _run_both(setup, tmp_path, capsys, "off")
    samples = port._samples(port.cfg.test_split)
    ref = jax_extract_image_features(jax_pipe.model, jax_pipe.params,
                                     JaxEvalLoader(samples, 128, 32, 2))
    got = extract_image_features(port.model, EvalLoader(samples, 128, 32, 2))
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    ref_logits = ref["image_features"] @ np.asarray(jax_pipe.zeroshot_head).T
    got_logits = got["image_features"] @ port.zeroshot_head.numpy().T
    np.testing.assert_allclose(got_logits, ref_logits, atol=2e-5)
    np.testing.assert_array_equal(got_logits.argmax(-1),
                                  ref_logits.argmax(-1))


def test_resident_and_streaming_agree(setup, tmp_path, capsys):
    dataset_path, ckpt = setup
    accs = []
    for resident in ("on", "off"):
        kw = run_kwargs(dataset_path, tmp_path / resident,
                        checkpoint_path=ckpt, resident=resident)
        accs.append(SwatPipeline(RunConfig(device="cpu", **kw)).run_zeroshot())
    assert accs[0] == pytest.approx(accs[1], abs=1e-4)


def test_cli_main_prints_the_summary_on_cpu(setup, tmp_path, capsys):
    from swat_tpu_torch.cli.main import main

    dataset_path, ckpt = setup
    yml = tmp_path / "config.yml"
    yml.write_text(f"dataset_path: {dataset_path}\n"
                   f"retrieved_path: {dataset_path}\n")
    before = FA.LAUNCHES
    main(["--dataset", DATASET, "--method", "zeroshot", "--model_cfg",
          "test_tiny", "--shots", "4", "--config_yml", str(yml),
          "--checkpoint_path", ckpt, "--num_workers", "2", "--folder",
          str(tmp_path / "cli"), "--mesh_data", "1", "--device", "cpu",
          "--recal_prompt", "--resident", "off", "--use_pallas", "True",
          "--remat", "full", "--accum", "2"])
    line = _summary(capsys.readouterr().out)
    assert line.startswith(f"{DATASET},zeroshot,fewshot,REAL-Prompt,4,1,")
    assert FA.LAUNCHES == before                 # the CPU runs no kernel


@pytest.mark.parametrize("kw,match", [
    ({"method": "finetune", "trace_dir": "trace"}, "Queue A"),
])
def test_unported_paths_raise(setup, tmp_path, kw, match):
    dataset_path, ckpt = setup
    cfg = RunConfig(device="cpu", **run_kwargs(
        dataset_path, tmp_path, checkpoint_path=ckpt, **kw))
    with pytest.raises(NotImplementedError, match=match):
        SwatPipeline(cfg).run()


def test_test_imagenet_ood_sweeps_the_last_bundle(setup, tmp_path,
                                                  monkeypatch):
    """--test_imagenet_ood after stage 1 and stage 2: the sweep runs on the
    most downstream bundle (stage 2's few-shot finetuning, stage 3's file),
    with swat_tpu's accuracies for that bundle."""
    dataset_path, ckpt = setup
    write_v2_tree(dataset_path)
    swept = []
    real = SwatPipeline.run_ood

    def record(self, model_path=None):
        swept.append((model_path, real(self, model_path)))
        return swept[-1][1]

    monkeypatch.setattr(SwatPipeline, "run_ood", record)
    kw = run_kwargs(dataset_path, tmp_path, checkpoint_path=ckpt,
                    method="finetune", epochs=1, no_wsft=True,
                    test_imagenet_ood=True)
    port = SwatPipeline(RunConfig(device="cpu", **kw))
    port.run()
    port.loss_logger.close()
    ((path, accs),) = swept
    assert os.path.basename(path).startswith("stage3_model")
    jax_pipe = JaxPipeline(JaxRunConfig(**kw).derived())
    assert accs == jax_pipe.run_ood(path)
    assert list(accs) == ["imagenet_v2"]


@pytest.mark.parametrize("kw", [{"mesh_data": 4}, {"trace_dir": "trace"}])
def test_unported_options_raise_at_start(setup, tmp_path, kw, caplog):
    """--trace_dir raises at start; a mesh is ported (ROADMAP Queue A item
    10): larger than the one process here, it runs on it with a WARNING
    naming both sizes and no process group, as swat_tpu drops a mesh too
    large for its devices."""
    import torch.distributed as dist

    dataset_path, ckpt = setup
    args = run_kwargs(dataset_path, tmp_path, checkpoint_path=ckpt)
    args.update(kw)
    if "trace_dir" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SwatPipeline(RunConfig(device="cpu", **args))
        return
    pipe = SwatPipeline(RunConfig(device="cpu", **args))
    pipe.loss_logger.close()
    assert pipe.mesh.shape == {"data": 1, "model": 1}
    assert not dist.is_initialized()
    with open(os.path.join(pipe.cfg.output_dir, "main.log")) as f:
        assert "mesh 4x1 does not fit the 1 process(es)" in f.read()


@pytest.mark.parametrize("fmt", ["full", "visual_only"])
def test_model_path_warm_start_matches_swat_tpu(setup, tmp_path, fmt):
    """--model_path is loaded before the zero-shot check: a full stage
    bundle, or a visual-tower-only file over the pretrained text tower,
    written by swat_tpu; the zero-shot summary of the loaded weights (with
    the prompt head of the pretrained text tower) equals swat_tpu's."""
    from swat_tpu.train.checkpoint import save_bundle
    from torch_port_lib import jax_params_from_state_dict

    dataset_path, ckpt = setup
    cfg = get_model_config("test_tiny")
    params, _ = jax_params_from_state_dict(random_state_dict(cfg, seed=3),
                                           cfg)
    arrays = ({"clip": params, "head": np.zeros((3, 32), np.float32),
               "logit_scale": np.asarray(np.float32(4.6))}
              if fmt == "full" else {"model": {"visual": params["visual"]}})
    path = str(tmp_path / "warm.msgpack")
    save_bundle(path, arrays, {})
    kw = run_kwargs(dataset_path, tmp_path, checkpoint_path=ckpt,
                    model_path=path, resident="off")
    jax_pipe = JaxPipeline(JaxRunConfig(**kw).derived())
    jax_acc = jax_pipe.run_stage1()[0]
    port = SwatPipeline(RunConfig(device="cpu", **kw))
    acc = port.run_stage1()[0]
    assert acc == pytest.approx(jax_acc, abs=1e-4)
    visual = {k: v for k, v in port.model.state_dict().items()
              if k.startswith("visual.")}
    ref = random_state_dict(cfg, seed=3)
    assert all(torch.equal(v, ref[k]) for k, v in visual.items())


def test_skip_stage1_without_a_bundle_matches_swat_tpu(setup, tmp_path):
    """--skip_stage1 with no --stage1_model_path: no stage runs and every
    accuracy field of the summary is -1.0, as in swat_tpu."""
    dataset_path, ckpt = setup
    kw = run_kwargs(dataset_path, tmp_path, checkpoint_path=ckpt,
                    method="cutmix", skip_stage1=True)
    jax_pipe = JaxPipeline(JaxRunConfig(**kw).derived())
    jax_summary = jax_pipe.run()
    jax_pipe.loss_logger.close()
    port = SwatPipeline(RunConfig(device="cpu", **kw))
    summary = port.run()
    port.loss_logger.close()
    assert summary == jax_summary
    assert summary.split(",")[7:] == ["-1.0"] * 4
