# Copied from swat_tpu/cli/test.py, plus --device; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Standalone evaluation CLI of the PyTorch port (reference
testing.py:548-764).

Loads a stage bundle (or raw pretrained weights), evaluates on a dataset
split, optionally sweeps the ImageNet OOD suite.  The flags, the printed
``{dataset},{split},{acc}`` line, the ``--predict_labels`` /
``--utrain_out`` files and the OOD sweep's JSON line are ``swat_tpu``'s;
``--device`` (default cuda) picks the card or the CPU.  ``--quantize
int8`` runs W8A8 inference (``models/quant.py``): the weights are
quantized in the JAX layout, bit for bit as ``swat_tpu`` quantizes them.

Usage:
    python -m swat_tpu_torch.cli.test --dataset semi-aves \
        --model_path output/.../stage1_model_best-epoch_50_best.msgpack
    python -m swat_tpu_torch.cli.test --dataset imagenet \
        --test_imagenet_ood --checkpoint_path /path/openclip_vitb32.pt
"""

from __future__ import annotations

import argparse
import json


def _cls_head(head):
    """The classification head array (multitask stores {'cls','dataset'})."""
    if isinstance(head, dict):
        return head["cls"]
    return head


def main(argv=None):
    p = argparse.ArgumentParser(description="swat-tpu-torch standalone eval")
    p.add_argument("--dataset", required=True)
    p.add_argument("--dataset_path", default="data")
    p.add_argument("--retrieved_path", default="data/retrieved")
    p.add_argument("--split", default="test.txt")
    p.add_argument("--model_cfg", default="vitb32_openclip_laion400m")
    p.add_argument("--model_path", default=None,
                   help="stage bundle (.msgpack) to evaluate")
    p.add_argument("--which_head", default="head",
                   choices=["head", "best_tau_head", "wsft_head"])
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--bpe_path", default=None)
    p.add_argument("--cls_init", default="REAL-Prompt")
    p.add_argument("--prompt_name", default="most_common_name")
    p.add_argument("--bsz", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--test_imagenet_ood", action="store_true")
    p.add_argument("--predict_labels", default=None,
                   help="write '<pred> <max_logit>' lines here (pseudo-"
                        "labels for the utrain flow, testing.py:466-480)")
    p.add_argument("--utrain_out", default=None,
                   help="write '<path> <pred> 0' lines here — a ready "
                        "--utrain split for pseudo-label training "
                        "(reference utils/dataloader.py:188-202)")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8 = W8A8 quantized inference (models/quant.py); "
                        "eval-only")
    p.add_argument("--tau", type=float, default=0.0,
                   help="apply tau-normalization to the head at test "
                        "time (reference testing.py:568,721-724)")
    p.add_argument("--folder", default="output/eval")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the card and its kernels; cpu: the plain "
                        "PyTorch path")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from swat_tpu_torch.core.config import RunConfig
    from swat_tpu_torch.train.stages import SwatPipeline

    cfg = RunConfig(
        dataset=args.dataset, dataset_path=args.dataset_path,
        retrieved_path=args.retrieved_path, model_cfg=args.model_cfg,
        checkpoint_path=args.checkpoint_path, bpe_path=args.bpe_path,
        cls_init=args.cls_init, prompt_name=args.prompt_name,
        num_workers=args.num_workers, folder=args.folder,
        method="zeroshot", device=args.device).derived()
    pipe = SwatPipeline(cfg)

    params, head, logit_scale = None, pipe.zeroshot_head, np.log(100.0)
    if args.model_path:
        from swat_tpu_torch.train.checkpoint import load_bundle

        arrays, meta = load_bundle(args.model_path)
        params = arrays["clip"]
        logit_scale = arrays["logit_scale"]
        if args.which_head == "head":
            head = arrays["head"]
        else:
            alt = arrays.get(args.which_head) or {}
            head = alt.get("w", arrays["head"])
        pipe.logger.info(f"Loaded {args.model_path}: meta={meta}")

    if args.quantize == "int8":
        from swat_tpu_torch.models.loader import jax_params_from_state_dict
        from swat_tpu_torch.models.quant import quantize_tree

        if params is None:
            params = jax_params_from_state_dict(pipe.model.state_dict())[0]
        params = quantize_tree(params)
        pipe.logger.info("int8 W8A8 quantized inference (models/quant.py)")
    if params is not None:
        pipe._load_params(params)
    model = pipe.model
    logit_scale = float(np.asarray(logit_scale))
    # the head on the CPU first, so that --tau gives the same head on
    # either device
    head = _cls_head(head)
    head = (head.detach().cpu() if isinstance(head, torch.Tensor)
            else torch.from_numpy(np.array(head, np.float32)))

    if args.tau != 0:
        from swat_tpu_torch.models.head import tau_normalize

        head = tau_normalize(head, args.tau)
        pipe.logger.info(f"TAU normalization: tau = {args.tau}")
    head = head.to(pipe.device)

    split = ([args.split], [cfg.dataset_dir])
    if args.predict_labels or args.utrain_out:
        import os
        import tempfile

        from swat_tpu_torch.data.pipeline import EvalLoader

        predict_path = args.predict_labels
        if predict_path is None:
            fd, predict_path = tempfile.mkstemp(
                prefix="swat_predict_labels_", suffix=".txt")
            os.close(fd)
        samples = pipe._samples(split)
        loader = EvalLoader(samples, batch_size=args.bsz,
                            n_px=pipe.model_cfg.vision.image_size,
                            num_workers=args.num_workers)
        acc, loss, cm = pipe.evaluator.validate(
            model, head, logit_scale, loader, return_confusion=True,
            predict_labels_path=predict_path)
        if args.utrain_out:
            # pair the split's sample order (EvalLoader is deterministic)
            # with the dumped predictions -> a ready --utrain split
            with open(predict_path) as f:
                preds = [line.split()[0] for line in f if line.strip()]
            assert len(preds) == len(samples), (len(preds), len(samples))
            os.makedirs(os.path.dirname(args.utrain_out) or ".",
                        exist_ok=True)
            with open(args.utrain_out, "w") as f:
                for s, pred in zip(samples, preds):
                    f.write(f"{s.path} {pred} 0\n")
            pipe.logger.info(f"utrain split ({len(preds)} pseudo-labeled "
                             f"samples) saved to: {args.utrain_out}")
    else:
        acc, loss, cm = pipe._validate_images(
            model, head, logit_scale, split, return_confusion=True,
            bsz=args.bsz)
    from swat_tpu_torch.eval.metrics import calculate_scores

    scores = calculate_scores(cm)
    pipe.logger.info(f"Test Acc: {round(acc, 3)}  Loss: {round(loss, 4)}  "
                     f"avg-class-acc: {round(scores['avg_class_accuracy'], 3)}")
    print(f"{args.dataset},{args.split},{round(acc, 3)}")

    if args.test_imagenet_ood:
        from swat_tpu_torch.data.pipeline import EvalLoader
        from swat_tpu_torch.eval.ood import test_imagenet_ood

        def make_loader(samples):
            return EvalLoader(samples, batch_size=args.bsz,
                              n_px=pipe.model_cfg.vision.image_size,
                              num_workers=args.num_workers)

        accs = test_imagenet_ood(pipe.evaluator, model, head, logit_scale,
                                 args.dataset_path, make_loader, pipe.logger)
        print(json.dumps(accs))


if __name__ == "__main__":
    main()
