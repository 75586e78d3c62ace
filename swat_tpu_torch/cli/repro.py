# Copied from swat_tpu/cli/repro.py, on the port's loader, towers, pipeline, converter and analysis.results, with the card's own rates and --device; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""One-command paper-reproduction runbook.

    python -m swat_tpu_torch.cli.repro --checkpoint vit_b_32-laion400m_e32.pt \
        --bpe_path bpe_simple_vocab_16e6.txt.gz [--datasets semi-aves ...] \
        [--configs zeroshot real-linear ft-fewshot swat] [--shots 4 8 16] \
        [--seeds 1 2 3] [--execute] [--device cuda|cpu]

Chains everything between "assets mounted" and "the ±0.5% table":

  1. PREFLIGHT — the checkpoint loads and encodes finite normalized
     features on ``--device`` (plus the feature-cosine bar when
     SWAT_OPENCLIP_ACTS points at dumped reference activations); the BPE
     vocab builds the real 49408-entry tokenizer (hash fallback refused
     unless --allow_hash_tokenizer, which exists for runs on synthetic
     assets); every requested dataset has its metrics json, test/fewshot
     splits, readable images, and — for retrieved configs — the retrieval
     split.
  2. PLAN — per-run wall-clock estimates from the card's measured
     throughputs (``TRAIN_RATE`` / ``EVAL_RATE``, PERF.md §5), printed
     before anything runs.
  3. RUN (--execute) — optional convert-to-msgpack, then every
     config x dataset x shots x seed through SwatPipeline on ``--device``,
     appending the reference-format summary CSV per dataset
     (scripts/run_dataset_seed_SWAT.sh:80-100 layout).
  4. SCORE — analysis.results.compare_to_paper against each config's
     published table (plots_tables/fig2_domain_gap/benchmark.py) at ±0.5%.

Without --execute it is a dry run: preflight + plan only (so the command
is safe to probe before committing a multi-hour sweep).  ``--device``
defaults to cuda, which raises without a GPU; pass cpu to run on the host.

Reference match: scripts/run_dataset_seed_SWAT.sh +
plots_tables/fig2_domain_gap/benchmark.py:123-135.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List

# the card the rates were measured on (nvidia-smi's name and power limit)
RATE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# measured train rates on that card, fp32 (RunConfig's default
# compute_dtype), img/s: B/32 a 200.46 ms cutmix step at bsz 256, B/16 at
# bsz 128, L/14 at bsz 64, RN50 at bsz 256 (PERF.md §5, chip_smoke.py)
TRAIN_RATE = {"vitb32_openclip_laion400m": 256 / 0.20046,
              "vitb16_openclip_laion400m": 354.2,
              "vitl14_openclip_laion400m": 82.3,
              "rn50_openclip_openai": 518.3}
# the B/32 image forward at B = 256, fp32 (PERF.md §5, chip_smoke.py)
EVAL_RATE = {"vitb32_openclip_laion400m": 3843.9}

# the BASELINE.json configs, as SwatPipeline settings + scoring target
CONFIGS: Dict[str, dict] = {
    "zeroshot": dict(method="zeroshot", data_source="fewshot",
                     epochs=0, acc_col="Stage1Acc", table="zeroshot"),
    "real-linear": dict(method="REAL-Linear", data_source="fewshot",
                        epochs=10, acc_col="Stage1Acc",
                        table="real-linear"),
    "ft-fewshot": dict(method="cutmix", data_source="fewshot",
                       epochs=50, acc_col="Stage1Acc",
                       table="ft-fewshot"),
    "ft-retrieved": dict(method="finetune", data_source="retrieved",
                         epochs=50, acc_col="Stage1Acc",
                         table="ft-retrieved"),
    "swat": dict(method="cutmix", data_source="fewshot+retrieved",
                 epochs=50, acc_col="Stage2LPAcc", table="swat"),
}

CSV_HEADER = ("Dataset,Method,DataSource,Init,Shots,Seed,Retrieve,"
              "Stage1Acc,WSFTAcc,Stage2LPAcc,Stage2FSFTAcc")


def _check(ok: bool, name: str, detail: str, failures: list, log):
    log(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}")
    if not ok:
        failures.append(f"{name}: {detail}")


def preflight(args, log=print) -> List[str]:
    """Validate every asset the sweep needs; returns failure list."""
    import numpy as np

    failures: List[str] = []
    log("== preflight ==")

    # ---- checkpoint
    if not args.checkpoint or not os.path.exists(args.checkpoint):
        _check(False, "checkpoint", f"{args.checkpoint!r} not found",
               failures, log)
    else:
        try:
            import torch

            from swat_tpu_torch.core.precision import FP32_PRECISION
            from swat_tpu_torch.models.clip import CLIPModel
            from swat_tpu_torch.models.configs import get_model_config
            from swat_tpu_torch.models.loader import load_torch_checkpoint
            from swat_tpu_torch.train.stages import resolve_device

            dev = resolve_device(args.device)
            cfg = get_model_config(args.model_cfg)
            state_dict, logit_scale = load_torch_checkpoint(args.checkpoint)
            model = CLIPModel(cfg, precision=FP32_PRECISION)
            model.load_weights(state_dict).to(dev).eval()

            def encode(images):
                with torch.inference_mode():
                    return model.encode_image(
                        torch.as_tensor(images, dtype=torch.float32,
                                        device=dev),
                        normalize=True).cpu().numpy()

            feats = encode(np.zeros((2, cfg.vision.image_size,
                                     cfg.vision.image_size, 3), np.float32))
            scale_ok = 1.0 <= float(np.exp(logit_scale)) <= 400.0
            _check(bool(np.isfinite(feats).all()) and scale_ok,
                   "checkpoint",
                   f"{args.model_cfg} loads, encodes finite normalized "
                   f"features, exp(logit_scale)={np.exp(logit_scale):.1f}",
                   failures, log)
            acts = os.environ.get("SWAT_OPENCLIP_ACTS")
            if acts and os.path.exists(acts):
                a = np.load(acts)
                got = encode(a["images"])
                ref = a["image_features"]
                ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
                cos = (got * ref).sum(-1).min()
                _check(bool(cos >= 1 - 1e-5), "feature-cosine bar",
                       f"min image-feature cosine {cos:.7f} vs dumped "
                       "reference activations (>= 1-1e-5)", failures, log)
            else:
                log("  [--] feature-cosine bar: SWAT_OPENCLIP_ACTS not "
                    "set — structural checks only (full bar also runs as "
                    "tests/test_real_weights.py once set)")
        except Exception as e:          # noqa: BLE001 — report, don't die
            _check(False, "checkpoint", f"load/encode failed: {e!r}",
                   failures, log)

    # ---- tokenizer
    try:
        from swat_tpu_torch.models.tokenizer import (HashTokenizer,
                                                     get_tokenizer)

        tok = get_tokenizer(args.bpe_path)
        if isinstance(tok, HashTokenizer) and not args.allow_hash_tokenizer:
            _check(False, "tokenizer",
                   "no BPE asset (--bpe_path / SWAT_BPE_PATH); refusing "
                   "the hash fallback for a paper reproduction", failures,
                   log)
        else:
            ids = tok(["a photo of a dog."])[0]
            n = int((ids != 0).sum())
            ok = (tok.vocab_size in (49408, getattr(tok, "vocab_size", 0))
                  and ids[0] == tok.sot_token and n >= 4
                  and ids[n - 1] == tok.eot_token)
            _check(bool(ok), "tokenizer",
                   f"{type(tok).__name__} vocab={tok.vocab_size}, "
                   f"'a photo of a dog.' -> {n} tokens", failures, log)
    except Exception as e:              # noqa: BLE001
        _check(False, "tokenizer", f"{e!r}", failures, log)

    # ---- datasets
    from swat_tpu_torch.core.config import RunConfig

    needs_retrieved = any(CONFIGS[c]["data_source"] != "fewshot"
                          for c in args.configs)
    for ds in args.datasets:
        cfg0 = RunConfig(dataset=ds, dataset_path=args.dataset_path,
                         retrieved_path=args.retrieved_path,
                         retrieval_split=args.retrieval_split)
        root = cfg0.dataset_dir
        missing = []
        for fn in ["test.txt"] + [f"fewshot{k}_seed{s}.txt"
                                  for k in args.shots for s in args.seeds]:
            if not os.path.exists(os.path.join(root, fn)):
                missing.append(fn)
        if not os.path.exists(cfg0.metrics_file):
            missing.append(os.path.basename(cfg0.metrics_file))
        if needs_retrieved and not os.path.exists(
                os.path.join(cfg0.retrieved_dir, args.retrieval_split)):
            missing.append(f"retrieved:{args.retrieval_split}")
        img_detail = ""
        if not missing:
            from PIL import Image

            with open(os.path.join(root, "test.txt")) as f:
                first = [ln.split()[0] for ln, _ in zip(f, range(3))]
            bad = []
            for rel in first:
                p = os.path.join(root, rel)
                try:
                    Image.open(p).convert("RGB")
                except Exception:       # noqa: BLE001
                    bad.append(rel)
            if bad:
                missing.append(f"unreadable images: {bad}")
            else:
                img_detail = f"; {len(first)} sample images decode"
        _check(not missing, f"dataset {ds}",
               ("complete" + img_detail) if not missing
               else f"missing {missing}", failures, log)
    return failures


def _estimate_seconds(config: dict, ds: str, shots: int,
                      model_cfg: str) -> float:
    """Rough wall-clock from the measured rates: train epochs + the two
    per-epoch evals + stage-2."""
    from swat_tpu_torch.data.registry import NUM_CLASSES_DICT

    n_cls = NUM_CLASSES_DICT.get(ds, 200)
    n_fs = n_cls * shots
    n_retr = n_cls * 500 if config["data_source"] != "fewshot" else 0
    n_train = (n_fs if config["data_source"] == "fewshot"
               else n_fs + n_retr)
    n_eval = {"semi-aves": 8000, "imagenet": 50000}.get(ds, 5000)
    rate = TRAIN_RATE.get(model_cfg, 1000.0)
    erate = EVAL_RATE.get(model_cfg, rate * 2.5)
    epochs = 10 if ds == "imagenet" else config["epochs"]
    t = epochs * (n_train / rate + 2 * n_eval / erate)
    if config["acc_col"].startswith("Stage2"):
        t += 10 * n_fs / rate + 2 * n_eval / erate      # stage-2 LP+FSFT
    return t + 120.0                                    # compile overhead


def score(out_dir: str, configs: List[str], tolerance: float) -> None:
    """The SCORE section: each config's rows in ``out_dir`` aggregated over
    seeds and set against its published table."""
    print("\n== score vs paper ==")
    from swat_tpu_torch.analysis import results as RZ

    for cname in configs:
        rows = []
        for fn in os.listdir(out_dir):
            if fn.startswith(cname + "_") and fn.endswith(".csv"):
                rows.extend(RZ.read_results_csv(os.path.join(out_dir, fn)))
        if not rows:
            continue
        c = CONFIGS[cname]
        print(f"\n-- {cname} ({c['acc_col']} vs table "
              f"{c['table']!r}, ±{tolerance}) --")
        agg = RZ.aggregate(rows, c["acc_col"])
        if cname == "zeroshot":
            # ZEROSHOT_PAPER rows are (OpenCLIP-ZS, REAL-Prompt) pairs
            for (ds, _), (mean, std, n) in sorted(agg.items()):
                paper = RZ.ZEROSHOT_PAPER.get(ds)
                if paper is None:
                    continue
                delta = mean - paper[1]     # REAL-Prompt column
                ok = "yes" if abs(delta) <= tolerance else "NO"
                print(f"{ds:14s}  {mean:5.1f}±{std:4.1f} (n={n})  "
                      f"{paper[1]:5.1f}  {delta:+5.1f}  {ok}")
        else:
            for line in RZ.compare_to_paper(agg, tolerance,
                                            table=c["table"]):
                print(line)


def run(argv=None):
    p = argparse.ArgumentParser(
        description="asset preflight + paper-reproduction sweep")
    p.add_argument("--checkpoint",
                   default=os.environ.get("SWAT_OPENCLIP_CKPT"))
    p.add_argument("--bpe_path", default=os.environ.get("SWAT_BPE_PATH"))
    p.add_argument("--model_cfg", default="vitb32_openclip_laion400m")
    p.add_argument("--dataset_path", default="data")
    p.add_argument("--retrieved_path", default="data/retrieved")
    p.add_argument("--retrieval_split", default="T2T500+T2I0.25.txt")
    p.add_argument("--datasets", nargs="+", default=None)
    p.add_argument("--configs", nargs="+", default=list(CONFIGS),
                   choices=list(CONFIGS))
    p.add_argument("--shots", nargs="+", type=int, default=[4, 8, 16])
    p.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    p.add_argument("--epochs_override", type=int, default=None,
                   help="override per-config epochs (CI smoke)")
    p.add_argument("--bsz", type=int, default=32,
                   help="train batch size (reference default 32)")
    p.add_argument("--out", default="results/repro")
    p.add_argument("--execute", action="store_true",
                   help="actually run the sweep (default: preflight+plan)")
    p.add_argument("--convert", action="store_true",
                   help="convert the checkpoint to msgpack first")
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="CI/synthetic-assets mode")
    p.add_argument("--tolerance", type=float, default=0.5)
    # port only
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="where the preflight encodes and the runs run: "
                        "cuda launches the hand-written kernels (and "
                        "raises without a GPU); cpu runs their plain "
                        "versions")
    args = p.parse_args(argv)
    from swat_tpu_torch.train.stages import resolve_device

    resolve_device(args.device)
    if args.datasets is None:
        from swat_tpu_torch.data.registry import DATASETS

        args.datasets = list(DATASETS)

    failures = preflight(args)
    if failures:
        print(f"\npreflight FAILED ({len(failures)}):")
        for f in failures:
            print(f"  - {f}")
        return 1

    print("\n== plan ==")
    total = 0.0
    runs = []
    for cname in args.configs:
        cfg = CONFIGS[cname]
        shot_list = args.shots if cname != "zeroshot" else [args.shots[0]]
        seed_list = args.seeds if cname != "zeroshot" else [args.seeds[0]]
        for ds in args.datasets:
            for k in shot_list:
                for s in seed_list:
                    est = (30.0 if cname == "zeroshot" else
                           _estimate_seconds(cfg, ds, k, args.model_cfg))
                    runs.append((cname, ds, k, s, est))
                    total += est
    for cname, ds, k, s, est in runs:
        print(f"  {cname:12s} {ds:14s} {k:2d}-shot seed{s}  "
              f"~{est / 60:6.1f} min")
    print(f"  TOTAL ~{total / 3600:.1f} h on one {RATE_CARD} "
          f"({len(runs)} runs; rates: PERF.md §5)")

    if not args.execute:
        print("\ndry run only — pass --execute to run the sweep")
        return 0

    ckpt = args.checkpoint
    if args.convert:
        from swat_tpu_torch.cli.convert import convert

        msg = os.path.join(args.out, "converted.msgpack")
        os.makedirs(args.out, exist_ok=True)
        convert(ckpt, args.model_cfg, msg, verify=True, device=args.device)
        ckpt = msg
        print(f"converted checkpoint -> {msg}")

    from swat_tpu_torch.core.config import RunConfig
    from swat_tpu_torch.train.stages import SwatPipeline

    os.makedirs(args.out, exist_ok=True)
    csv_paths = {}
    for cname, ds, k, s, est in runs:
        c = CONFIGS[cname]
        t0 = time.time()
        rc = RunConfig(
            dataset=ds, model_cfg=args.model_cfg, checkpoint_path=ckpt,
            bpe_path=args.bpe_path, method=c["method"],
            data_source=c["data_source"], shots=k, seed=s,
            training_seed=s,
            epochs=(args.epochs_override if args.epochs_override
                    else (10 if ds == "imagenet" else c["epochs"])),
            bsz=args.bsz,
            dataset_path=args.dataset_path,
            retrieved_path=args.retrieved_path,
            retrieval_split=args.retrieval_split,
            folder=os.path.join(args.out, "runs"),
            skip_stage2=not c["acc_col"].startswith("Stage2"),
            device=args.device,
        ).derived()
        pipe = SwatPipeline(rc)
        if cname == "zeroshot":
            # the pipeline's zeroshot flow prints the reference's short
            # 8-field line and returns ""; synthesize the 11-field row so
            # every config shares one CSV schema
            acc = pipe.run_zeroshot()
            summary = (f"{ds},zeroshot,{c['data_source']},REAL-Prompt,"
                       f"{k},{s},{args.retrieval_split},"
                       f"{round(acc, 1)},-1.0,-1.0,-1.0")
        else:
            summary = pipe.run()
        path = os.path.join(args.out, f"{cname}_{ds}.csv")
        if path not in csv_paths:
            csv_paths[path] = True
            if not os.path.exists(path):
                with open(path, "w") as f:
                    f.write(CSV_HEADER + "\n")
        with open(path, "a") as f:
            f.write(summary + "\n")
        print(f"[{cname}/{ds}/{k}shot/seed{s}] {summary} "
              f"({(time.time() - t0) / 60:.1f} min, est "
              f"{est / 60:.1f})")

    score(args.out, args.configs, args.tolerance)
    return 0


if __name__ == "__main__":
    sys.exit(run())
