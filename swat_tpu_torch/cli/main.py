# Copied from swat_tpu/cli/main.py, plus --device; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""main.py-compatible CLI of the PyTorch port.

Same flags, same output formats, same one-line CSV summary as the reference
(utils/parser.py:7-218, main.py:604-606), so the reference's shell harness
(scripts/run_dataset_seed_*.sh) drives this framework unchanged.  A few
TPU-native flags are added at the end (mesh shape, aug mode, precision,
pretrained checkpoint path — the reference downloads weights via open_clip;
here they come from a converted checkpoint file).

The port adds ``--device {cuda,cpu}``.  ``--use_pallas`` is accepted and
does nothing (the kernels always run on the card); ``--remat`` and
``--accum`` act in training only (``--accum`` in streaming epochs only, as
in ``swat_tpu``).  Under ``torch.distributed.run`` the run is
data-parallel over ``--mesh_data`` processes, one a GPU (``--mesh_model M``
makes data groups of world / M ranks whose M ranks compute the same rows,
as ``swat_tpu``'s CLI does not shard the towers); rank 0 writes the files
and prints the summary, which equals the one-process run's.  Ported so far:
``--method zeroshot``; stage 1 of ``--method finetune`` / ``cutmix`` /
``mixup`` / ``resizemix`` / ``saliencymix`` / ``attentivemix`` /
``finetune-mixed`` / ``cutmix-fs`` / ``mixup-fs`` / ``CMO`` / ``probing`` /
``REAL-Linear`` / ``CMLP`` (``--use_attribute``) / ``FLYP``
(``--locked_text``, ``--lr_projector``) / ``finetune-multitask``
(``--dataset_wd``) / ``fixmatch`` (``--mu``, ``--threshold``,
``--lambda_u``, ``--unlabeled_split``) (``--aug_mode canvas | host |
eval``), with ``--optim AdamW | SGD`` and ``--utrain``; stage 2 (probing,
then few-shot finetuning), or ``--skip_stage2``; ``--method dataset-cls``
(``--data_source dataset-cls``), which ends after stage 1's epochs with no
summary row; ``--skip_stage1 --stage1_model_path``, ``--model_path``,
``--save_ckpt`` / ``--resume``.  Every registered ``--model_cfg`` builds:
the ViT-B/32, B/16 and L/14 towers, and the RN50 ones
(``rn50_openclip_openai``, ``rn50_clip``; their BatchNorm trains with batch
statistics, and ``--accum`` > 1 raises for them as in ``swat_tpu``).  The
``.msgpack`` bundles are those of ``swat_tpu``: either package reads the
other's.

Usage:
    python -m swat_tpu_torch.cli.main --dataset semi-aves --method zeroshot \
        --checkpoint_path /path/to/openclip_vitb32.pt
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m swat_tpu_torch.cli.main --dataset semi-aves --method cutmix \
        --data_source fewshot+retrieved --mesh_data 4 \
        --checkpoint_path /path/to/openclip_vitb32.pt
    python -m swat_tpu_torch.cli.main --dataset semi-aves --method cutmix \
        --data_source fewshot+retrieved --epochs 10 \
        --checkpoint_path /path/to/openclip_vitb32.pt
"""

from __future__ import annotations

import argparse
import os
import sys


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def str2remat(v):
    """--remat accepts booleans plus the selective checkpoint policies
    ('full' == True; 'dots' / 'dots_all' save matmul outputs; 'first<K>'
    checkpoints only the first K blocks, see
    models.clip.resolve_remat_policy)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("dots", "dots_all"):
        return v.lower()
    if v.lower() == "full":
        return True
    if v.lower().startswith("first") and v[len("first"):].isdigit() \
            and int(v[len("first"):]) > 0:
        return v.lower()
    try:
        return str2bool(v)
    except argparse.ArgumentTypeError:
        raise argparse.ArgumentTypeError(
            f"--remat expects a boolean, 'full', 'dots', 'dots_all' or "
            f"'first<K>'; got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="swat-tpu-torch")

    # logging
    p.add_argument("--log_mode", type=str, default="both",
                   choices=["console", "file", "both"])
    p.add_argument("--folder", type=str, default="output")
    p.add_argument("--prefix", type=str, default=None)

    # model
    p.add_argument("--model_cfg", type=str,
                   default="vitb32_openclip_laion400m")
    p.add_argument("--model_path", default=None, type=str)

    # prompt
    p.add_argument("--prompt_name", type=str, default="most_common_name",
                   choices=["most_common_name", "most_common_name_REAL",
                            "name", "name-80prompts", "c-name", "s-name",
                            "t-name", "f-name", "c-name-80prompts"])
    p.add_argument("--use_attribute", default=False, type=str2bool)

    # dataset
    p.add_argument("--dataset", type=str, default="semi-aves")
    p.add_argument("--test_imagenet_ood", default=False,
                   action="store_true")
    p.add_argument("--database", type=str, default="LAION400M")

    # training data
    p.add_argument("--data_source", type=str, default="fewshot",
                   choices=["fewshot", "retrieved", "fewshot+retrieved",
                            "dataset-cls", "ltrain", "ltrain+val",
                            "ltrain+val+unlabeled",
                            "ltrain+val+unlabeled+retrieved",
                            "fewshot+unlabeled",
                            "fewshot+retrieved+unlabeled"])
    p.add_argument("--shots", type=int, default=16)
    p.add_argument("--retrieval_split", type=str,
                   default="T2T500+T2I0.25.txt")
    p.add_argument("--unlabeled_split", type=str,
                   default="u_train_in_oracle.txt")
    p.add_argument("--val_split", type=str, default="fewshotX.txt")
    p.add_argument("--test_split", type=str, default="test.txt")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--training_seed", type=int, default=1)

    # method
    p.add_argument("--method", type=str, default="finetune",
                   choices=["zeroshot", "REAL-Linear", "probing",
                            "finetune", "finetune-mixed",
                            "finetune-multitask", "CMLP", "mixup",
                            "mixup-fs", "cutmix", "cutmix-fs", "resizemix",
                            "dataset-cls", "saliencymix", "attentivemix",
                            "CMO", "FLYP", "fixmatch"])
    p.add_argument("--fewshot_ratio", type=float, default=0.5)
    p.add_argument("--cls_init", type=str, default="REAL-Prompt",
                   choices=["random", "text", "REAL-Prompt", "REAL-Linear"])
    p.add_argument("--no_wsft", default=False, action="store_true")
    p.add_argument("--no_tau", default=False, action="store_true")
    p.add_argument("--mix_prob", type=float, default=0.5)
    p.add_argument("--mixup_alpha", type=float, default=1.0)
    p.add_argument("--skip_stage1", default=False, action="store_true")
    p.add_argument("--skip_stage2", default=False, action="store_true")
    p.add_argument("--stage1_model_path", default=None, type=str)
    p.add_argument("--attentive_threshold", type=float, default=0.85)
    p.add_argument("--attentive_name", type=str, default="c-name",
                   choices=["general", "c-name", "s-name"])
    p.add_argument("--cutmix_beta", type=float, default=1.0)
    p.add_argument("--cmo_alpha", type=float, default=1.0)
    p.add_argument("--recal_prompt", action="store_true")
    p.add_argument("--recal_fea", action="store_true")
    p.add_argument("--pre_extracted", default=False, action="store_true")
    p.add_argument("--locked_text", action="store_true")
    p.add_argument("--freeze_visual", default=False, type=str2bool)
    p.add_argument("--tau_norm", default=True, type=str2bool)

    # fixmatch
    p.add_argument("--mu", type=int, default=1)
    p.add_argument("--threshold", type=float, default=0.95)
    p.add_argument("--lambda_u", type=float, default=1.0)

    # control
    p.add_argument("--check_zeroshot", action="store_true")
    p.add_argument("--zeroshot_only", action="store_true")
    p.add_argument("--early_stop", default=False, type=str2bool)
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--stop_epochs", type=int, default=200)

    # optimization
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--start_validation", type=int, default=0)
    p.add_argument("--lr_classifier", type=float, default=1e-4)
    p.add_argument("--lr_backbone", type=float, default=1e-6)
    p.add_argument("--lr_projector", type=float, default=None)
    p.add_argument("--wd", type=float, default=1e-2)
    p.add_argument("--bsz", type=int, default=32)
    p.add_argument("--optim", type=str, default="AdamW",
                   choices=["AdamW", "SGD"])
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--alpha", type=float, default=0.5)

    # loss
    p.add_argument("--loss_name", type=str, default="CE",
                   choices=["CE", "WeightedCE", "Focal", "BalancedSoftmax"])
    p.add_argument("--dataset_wd", type=float, default=1.0)
    p.add_argument("--fewshot_weight", type=float, default=1.0)
    p.add_argument("--focal_alpha", type=float, default=1.0)
    p.add_argument("--focal_gamma", type=float, default=2.0)

    # save
    p.add_argument("--save_ckpt", default=False, type=str2bool)
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--resume", default=False, type=str2bool)
    p.add_argument("--utrain", type=str, default=None)

    # TPU-native additions
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="converted OpenCLIP torch checkpoint (.pt)")
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--aug_mode", type=str, default="canvas",
                   choices=["canvas", "host", "eval"],
                   help="canvas: on-device augment; host: reference PIL "
                        "augment; eval: DETERMINISTIC eval preprocess on "
                        "train batches (differential-oracle harness)")
    p.add_argument("--use_pallas", default=False, type=str2bool)
    p.add_argument("--remat", default=False, type=str2remat,
                   help="False | True/full (recompute whole blocks in the "
                        "backward) | first<K> (the first K blocks only) | "
                        "dots (keep the projections' product outputs, "
                        "recompute attention and elementwise work) | "
                        "dots_all (keep every product's output)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step "
                        "(CE and mixing methods, streaming epochs); the "
                        "batch is augmented and mixed whole, then "
                        "encode+loss runs per microbatch: the same "
                        "gradient to summation order, 1/accum of the "
                        "activation memory, no recompute")
    p.add_argument("--resident", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="whole-epoch-on-device scan execution: auto picks "
                        "it when the split fits --resident_budget_bytes")
    p.add_argument("--resident_budget_bytes", type=int,
                   default=6_000_000_000)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--trace_dir", type=str, default=None)
    p.add_argument("--config_yml", type=str, default="config.yml")
    # port only
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda launches the hand-written kernels; cpu runs "
                        "their plain PyTorch versions")
    return p


def parse_config(argv=None):
    from swat_tpu_torch.core.config import RunConfig

    args = build_parser().parse_args(argv)

    dataset_path, retrieved_path = "data", "data/retrieved"
    if os.path.exists(args.config_yml):
        import yaml

        with open(args.config_yml) as f:
            yml = yaml.safe_load(f)
        dataset_path = yml.get("dataset_path", dataset_path)
        retrieved_path = yml.get("retrieved_path", retrieved_path)

    # the reference unconditionally overwrites --val_split/--test_split
    # with the derived fewshot/test files (utils/parser.py:188-189); keep
    # that behavior but warn instead of silently ignoring an override
    if args.val_split != "fewshotX.txt":
        print(f"WARNING: --val_split={args.val_split} ignored; the val "
              "split is always the fewshot file (reference parser.py:188)")
    if args.test_split != "test.txt":
        print(f"WARNING: --test_split={args.test_split} ignored; the test "
              "split is always test.txt (reference parser.py:189)")
    drop = {"config_yml", "val_split", "test_split"}
    kwargs = {k: v for k, v in vars(args).items() if k not in drop}
    cfg = RunConfig(dataset_path=dataset_path,
                    retrieved_path=retrieved_path, **kwargs)
    return cfg.derived()


def main(argv=None):
    cfg = parse_config(argv)
    import torch.distributed as dist

    from swat_tpu_torch.train.stages import SwatPipeline

    started_here = not dist.is_initialized()
    pipeline = SwatPipeline(cfg)
    pipeline.run()
    if started_here and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
