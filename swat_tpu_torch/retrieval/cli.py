"""Retrieval pipeline CLI of the PyTorch port (counterpart of
``swat_tpu/retrieval/cli.py``): the reference's 4-step offline chain
(SURVEY.md §3.3) as subcommands of one entry point, with every subcommand
and flag of ``swat_tpu``'s, and the same files out:

  stringmatch     captions corpus + metrics json -> matched caption ids,
                  synonym frequencies, most-common names
                  (replaces retrieval/laion_parser.py:314-384)
  captionmap      download metadata -> {class: {img_idx: caption}} map
                  (replaces retrieval/process_meta_map.py)
  extract         encode mined images + captions with the CLIP towers
                  (replaces retrieval/extract_mined_feature.py:284)
  sample          rank + filter + write the training split
                  (replaces retrieval/sample_retrieval.py:1673-1746)
  filter-synonyms zero-shot text filter of mined synonyms
  ingest, make-urls, mine-synonyms, check-metrics: host-only steps

``extract``, ``sample`` and ``filter-synonyms`` run on ``--device``
(default cuda; cpu runs the plain PyTorch path on the host).  Every fp32
product runs in full fp32 (no TF32).  Without ``--checkpoint_path`` the
towers are ``CLIPModel.init_random`` from seed 0 (not flax's init), with
a WARNING.  Under ``torch.distributed.run`` ``extract --mesh_data N`` runs
over N processes, each encoding its rows of every batch, and ``sample``
over all of the launcher's processes, each ranking its block of the
candidates; rank 0 writes the files, equal to the one-process run's.

Usage:
    python -m swat_tpu_torch.retrieval.cli extract --mined_dir mined/ \
        --caption_map cmap.json --output mined_features.npz \
        --checkpoint_path vitb32.pt
    python -m swat_tpu_torch.retrieval.cli sample --dataset semi-aves \
        --features retrieved/semi-aves/mined_features.npz \
        --prompts data/semi-aves/prompts/..._prompt_tensors.npz \
        --strategy T2T-rank-T2I-tshd --num_samples 500 \
        --output data/retrieved/semi-aves/T2T500+T2I0.25.txt
"""

from __future__ import annotations

import argparse
import json
import os
import time


def cmd_ingest(args):
    """LAION parquet/jsonl shards -> caption-index shards + metadata store
    (replaces reference create_table/create_fts_table,
    laion_parser.py:48-79)."""
    from swat_tpu_torch.retrieval.ingest import ingest_shards

    t0 = time.time()
    manifest = ingest_shards(
        args.inputs, args.output_dir, text_col=args.text_col,
        url_col=args.url_col, nsfw_col=args.nsfw_col,
        build_index=not args.no_index,
        prefer_native=not args.no_native)
    n = manifest["offsets"][-1]
    print(f"Ingested {n} captions into {manifest['num_shards']} shards "
          f"under {args.output_dir} in {time.time() - t0:.1f}s")


def cmd_make_urls(args):
    """stringmatch output + metadata store -> downloadable URL parquet
    (replaces reference create_parquet, laion_downloader.py:132-176)."""
    from swat_tpu_torch.retrieval.downloader import (build_url_rows,
                                                     write_url_parquet)
    from swat_tpu_torch.retrieval.ingest import MetaStore

    with open(args.matches) as f:
        retrieved = json.load(f)
    meta = MetaStore(args.store_dir)
    rows, metadata = build_url_rows(
        retrieved, meta, sampling=args.sampling,
        max_images=args.max_images, seed=args.seed,
        skip_nsfw=not args.keep_nsfw)
    write_url_parquet(args.output, rows)
    meta_path = args.output.rsplit(".", 1)[0] + ".meta.json"
    with open(meta_path, "w") as f:
        json.dump(metadata, f)
    print(f"Wrote {len(rows)} URL rows ({len(metadata)} classes) to "
          f"{args.output}; download metadata to {meta_path}")


def load_model(model_cfg: str, checkpoint_path, device,
               quantize: str = "none"):
    """The CLIP towers of ``model_cfg`` on ``device``, in the default (bf16)
    policy as ``swat_tpu``'s retrieval CLI builds them: the checkpoint's
    weights (``.pt`` or a ``cli.convert`` bundle), else ``init_random``
    from seed 0 with a WARNING; ``quantize="int8"`` swaps in W8A8 weights,
    quantized in the JAX layout as ``swat_tpu`` quantizes them."""
    import torch

    from swat_tpu_torch.models.clip import CLIPModel
    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.models.loader import load_torch_checkpoint

    model = CLIPModel(get_model_config(model_cfg))
    if checkpoint_path:
        state_dict, _ = load_torch_checkpoint(checkpoint_path)
        model.load_weights(state_dict)
    else:
        model.init_random(torch.Generator().manual_seed(0))
        print("WARNING: random weights (no --checkpoint_path)")
    if quantize == "int8":
        from swat_tpu_torch.models.loader import (jax_params_from_state_dict,
                                                  state_dict_from_jax_params)
        from swat_tpu_torch.models.quant import quantize_tree

        params, logit_scale = jax_params_from_state_dict(model.state_dict())
        model.load_weights(state_dict_from_jax_params(
            quantize_tree(params), logit_scale))
    return model.to(device).eval().requires_grad_(False)


def cmd_filter_synonyms(args):
    """Zero-shot text filter of mined synonyms (replaces reference
    query_synonyms/clip_text_filtering.py)."""
    from swat_tpu_torch.data.features import make_text_encoder
    from swat_tpu_torch.models.tokenizer import get_tokenizer
    from swat_tpu_torch.retrieval.synonyms import filter_synonyms
    from swat_tpu_torch.train.stages import resolve_device

    device = resolve_device(args.device)
    model = load_model(args.model_cfg, args.checkpoint_path, device)
    encode = make_text_encoder(model)

    with open(args.synonyms) as f:
        names = json.load(f)
    tok = get_tokenizer(args.bpe_path, vocab_size=model.cfg.text.vocab_size)
    t0 = time.time()
    names = filter_synonyms(encode, tok, names,
                            context_length=model.cfg.text.context_length,
                            log=print)
    kept = sum(len(v["synonyms_filtered"]) for v in names.values())
    total = sum(len(v["synonyms"]) for v in names.values())
    print(f"Kept {kept}/{total} synonyms in {time.time() - t0:.1f}s")
    with open(args.output, "w") as f:
        f.write(json.dumps(names, indent=4))
    print(f"Wrote {args.output}")


def cmd_mine_synonyms(args):
    """LLM synonym mining (reference query_synonyms.py:16-127) with a
    pluggable backend: --recorded replays a committed fixture; --openai
    uses the live API when available."""
    from swat_tpu_torch.retrieval.query_synonyms import (mine_synonyms,
                                                         openai_backend,
                                                         recorded_backend)

    with open(args.class_names) as f:
        class_names = json.load(f)
    if isinstance(class_names, dict):
        class_names = [class_names[k] for k in
                       sorted(class_names, key=int)]
    definitions = None
    if args.definitions:
        with open(args.definitions) as f:
            definitions = json.load(f)
    backend = (recorded_backend(args.recorded) if args.recorded
               else openai_backend(args.model))
    out = mine_synonyms(args.dataset, class_names, backend,
                        definitions=definitions, log=print)
    with open(args.output, "w") as f:
        json.dump(out, f, indent=4)
    print(f"Wrote {args.output} ({len(out)} classes)")


def cmd_check_metrics(args):
    """Sanity checks on a metrics json (reference check_metric_file.py:
    every class name must appear among its alternates) + canonical
    reformatting (format_metrics.py: int-key sort, indent 4)."""
    with open(args.metrics) as f:
        metrics = json.load(f)
    problems = 0
    for key, value in metrics.items():
        name = str(value.get("name", "")).lower()
        alts = value.get("alternates", {})
        alt_set = {a.lower() for a in (alts if isinstance(alts, dict)
                                       else list(alts))}
        if name and name not in alt_set:
            print(f"{key}: {name} not in alternates")
            problems += 1
    if args.reformat:
        ordered = dict(sorted(((int(k), v) for k, v in metrics.items())))
        with open(args.metrics, "w") as f:
            json.dump(ordered, f, indent=4)
        print(f"Done reformatting {args.metrics}!")
    print(f"{problems} problem(s) in {len(metrics)} classes")


def cmd_stringmatch(args):
    from swat_tpu_torch.retrieval.indexer import make_index
    from swat_tpu_torch.retrieval.stringmatch import match_all_classes

    t0 = time.time()
    if args.index_dir:
        from swat_tpu_torch.retrieval.ingest import ShardedCaptionIndex

        index = ShardedCaptionIndex(args.index_dir,
                                    prefer_native=not args.no_native)
    elif args.index_path and os.path.exists(args.index_path):
        from swat_tpu_torch.retrieval.indexer import NativeCaptionIndex

        index = NativeCaptionIndex(index_path=args.index_path)
    elif args.captions is None:
        raise SystemExit(
            f"--index_path {args.index_path} does not exist and no "
            "--captions corpus was given to build it from")
    else:
        index = make_index(path=args.captions,
                           prefer_native=not args.no_native)
        if args.index_path and hasattr(index, "save"):
            index.save(args.index_path)
            print(f"Saved index to {args.index_path}")
    print(f"Index built over {len(index)} captions "
          f"in {time.time() - t0:.1f}s ({type(index).__name__})")

    with open(args.metrics) as f:
        metrics = json.load(f)
    # alternates may be serialized as strings in the metrics jsons
    import ast

    for m in metrics.values():
        if isinstance(m.get("alternates"), str):
            m["alternates"] = ast.literal_eval(m["alternates"])

    t0 = time.time()
    retrieved, metrics, class_frequency = match_all_classes(
        index, metrics, prefix=args.prefix, num_threads=args.threads)
    print(f"Matched {sum(class_frequency.values())} captions "
          f"in {time.time() - t0:.1f}s")

    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.join(args.output_dir, args.tag)
    with open(f"{base}_mined_captions.json", "w") as f:
        json.dump({k: v for k, v in retrieved.items()}, f)
    with open(f"{base}_metrics.json", "w") as f:
        json.dump(metrics, f, indent=2)
    with open(f"{base}_class_frequency.json", "w") as f:
        json.dump(class_frequency, f, indent=2)
    print(f"Wrote {base}_mined_captions.json / _metrics.json / "
          "_class_frequency.json")


def cmd_captionmap(args):
    from swat_tpu_torch.retrieval.mined import build_caption_map

    with open(args.metadata) as f:
        metadata = json.load(f)
    cmap = build_caption_map(metadata)
    with open(args.output, "w") as f:
        json.dump(cmap, f)
    print(f"Wrote caption map for {len(cmap)} classes to {args.output}")


def _start_mesh(device, mesh_data=-1):
    """The data-parallel mesh of a subcommand run under a launcher (or with
    ``mesh_data`` other than -1 / 1, which on one process warns and runs
    on it) -> (mesh or None, whether this is rank 0)."""
    import torch.distributed as dist

    from swat_tpu_torch.core.distributed import maybe_initialize_distributed
    from swat_tpu_torch.core.mesh import MeshSpec, active, create_mesh

    started = maybe_initialize_distributed(device=device.type)
    if not started and mesh_data in (-1, 1):
        return None, True
    mesh = active(create_mesh(MeshSpec(mesh_data, 1)))
    return mesh, not started or dist.get_rank() == 0


def cmd_extract(args):
    from swat_tpu_torch.models.tokenizer import get_tokenizer
    from swat_tpu_torch.retrieval.mined import (extract_mined_features,
                                                find_mined_images,
                                                save_mined_features)
    from swat_tpu_torch.train.stages import resolve_device

    device = resolve_device(args.device)
    mesh, main = _start_mesh(device, args.mesh_data)
    model = load_model(args.model_cfg, args.checkpoint_path, device,
                       args.quantize)

    samples = find_mined_images(args.mined_dir)
    with open(args.caption_map) as f:
        cmap = json.load(f)
    tok = get_tokenizer(args.bpe_path, vocab_size=model.cfg.text.vocab_size)
    t0 = time.time()
    feats = extract_mined_features(
        model, samples, cmap, tok, batch_size=args.bsz,
        image_size=model.cfg.vision.image_size, mesh=mesh)
    n = len(samples)
    dt = time.time() - t0
    if main:
        print(f"Encoded {n} images + captions in {dt:.1f}s "
              f"({n / dt:.1f} pairs/s)")
        save_mined_features(args.output, feats)
        print(f"Wrote {args.output}")
    if mesh is not None:
        mesh.barrier()


def cmd_sample(args):
    import numpy as np

    from swat_tpu_torch.data.prompts import load_prompt_tensors
    from swat_tpu_torch.retrieval.mined import load_mined_features
    from swat_tpu_torch.retrieval.sampler import (MinedPool,
                                                  group_fewshot_features,
                                                  sample_retrieved,
                                                  sample_retrieved_fused,
                                                  write_debug_lists,
                                                  write_split_file)
    from swat_tpu_torch.train.stages import resolve_device

    device = resolve_device(args.device)
    mesh, main = _start_mesh(device)
    feats = load_mined_features(args.features)
    pool = MinedPool(
        [str(p) for p in feats["file_paths"]], feats["labels"],
        feats["image_features"], feats.get("caption_features"),
        captions=([str(c) for c in feats["captions"]]
                  if "captions" in feats else None))
    prompts = load_prompt_tensors(args.prompts)

    fewshot_by_class = None
    if args.fewshot_features:
        with np.load(args.fewshot_features, allow_pickle=False) as fs:
            fewshot_by_class = group_fewshot_features(
                fs["image_features"], fs["labels"])

    zs_head = None
    if args.zeroshot_filter:
        from swat_tpu_torch.data.prompts import class_embedding_matrix

        zs_head = class_embedding_matrix(prompts)

    t0 = time.time()
    # fused = one class-masked product + top-k over ALL classes (O(1)
    # device passes); per-class is the reference-shaped oracle loop
    sampler = (sample_retrieved_fused if args.engine == "fused"
               else sample_retrieved)
    extra = {}
    if args.engine == "fused":
        extra = {"approx": (args.rank_mode if args.rank_mode == "auto"
                            else args.rank_mode == "approx"),
                 "rank_chunk": args.rank_chunk, "mesh": mesh}
    res = sampler(
        pool, prompts, strategy=args.strategy,
        num_samples=args.num_samples, threshold=args.threshold,
        t2i_threshold=args.t2i_threshold,
        fewshot_feats_by_class=fewshot_by_class,
        remove_duplicates=args.remove_duplicates,
        zeroshot_filter_head=zs_head, seed=args.seed, device=device,
        **extra)
    total = len(res["file_list"])
    if not main:
        mesh.barrier()
        return
    print(f"Sampled {total} images "
          f"({args.strategy}) in {time.time() - t0:.1f}s")
    write_split_file(args.output, res["file_list"], res["label_list"],
                     relative_to=args.relative_to)
    prefix = os.path.basename(args.output).rsplit(".", 1)[0]
    out_dir = os.path.dirname(args.output) or "."
    write_debug_lists(out_dir, prefix, res)
    # per-class sampled counts (reference {prefix}_num_imgs_sampled.json,
    # consumed by the fig3 imbalance plot)
    with open(os.path.join(out_dir,
                           f"{prefix}_num_imgs_sampled.json"), "w") as f:
        json.dump({str(k): v for k, v in res["num_sampled"].items()}, f,
                  indent=4)
    print(f"Wrote {args.output}")
    if mesh is not None:
        mesh.barrier()


def _add_device(parser):
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the card; cpu: the plain PyTorch path")


def main(argv=None):
    from swat_tpu_torch.core.precision import DEFAULT_PRECISION
    from swat_tpu_torch.retrieval.sampler import STRATEGIES

    # the ranking's gates compare full-fp32 products (>= 0.25, >= 0.65,
    # > 0.9): TF32 would move scores across them
    DEFAULT_PRECISION.apply_backend_flags()

    p = argparse.ArgumentParser(description="swat-tpu-torch retrieval "
                                            "pipeline")
    sub = p.add_subparsers(dest="cmd", required=True)

    ms = sub.add_parser("mine-synonyms")
    ms.add_argument("--dataset", required=True)
    ms.add_argument("--class_names", required=True,
                    help="json list of class names (or [sname, cname] "
                         "pairs for semi-aves)")
    ms.add_argument("--output", required=True)
    ms.add_argument("--recorded", default=None,
                    help="fixture json {label: response} to replay "
                         "instead of calling an API")
    ms.add_argument("--model", default="gpt-3.5-turbo")
    ms.add_argument("--definitions", default=None,
                    help="json list of per-class definitions "
                         "(required for caltech-101)")

    ck = sub.add_parser("check-metrics")
    ck.add_argument("--metrics", required=True)
    ck.add_argument("--reformat", action="store_true",
                    help="sort by int key and rewrite with indent=4")

    fs = sub.add_parser("filter-synonyms")
    fs.add_argument("--synonyms", required=True,
                    help="{class: {'query_name', 'synonyms': {...}}} json")
    fs.add_argument("--output", required=True)
    fs.add_argument("--model_cfg", default="vitb32_openclip_laion400m")
    fs.add_argument("--checkpoint_path", default=None)
    fs.add_argument("--bpe_path", default=None)
    _add_device(fs)

    ing = sub.add_parser("ingest")
    ing.add_argument("inputs", nargs="+",
                     help="parquet/jsonl metadata shards (globs ok)")
    ing.add_argument("--output_dir", required=True)
    ing.add_argument("--text_col", default="TEXT")
    ing.add_argument("--url_col", default="URL")
    ing.add_argument("--nsfw_col", default="NSFW")
    ing.add_argument("--no_index", action="store_true",
                     help="skip building native index shards")
    ing.add_argument("--no_native", action="store_true")

    mu = sub.add_parser("make-urls")
    mu.add_argument("--matches", required=True,
                    help="stringmatch *_mined_captions.json")
    mu.add_argument("--store_dir", required=True,
                    help="ingest output dir (metadata store)")
    mu.add_argument("--output", required=True, help="URL parquet path")
    mu.add_argument("--sampling", default="all",
                    choices=["all", "random", "few"])
    mu.add_argument("--max_images", type=int, default=2000)
    mu.add_argument("--seed", type=int, default=0)
    mu.add_argument("--keep_nsfw", action="store_true")

    sm = sub.add_parser("stringmatch")
    sm.add_argument("--captions", default=None,
                    help="newline-separated caption corpus file")
    sm.add_argument("--index_dir", default=None,
                    help="sharded index dir from `ingest` (overrides "
                         "--captions/--index_path)")
    sm.add_argument("--metrics", required=True)
    sm.add_argument("--output_dir", required=True)
    sm.add_argument("--tag", default="laion")
    sm.add_argument("--prefix", default=None)
    sm.add_argument("--threads", type=int, default=16)
    sm.add_argument("--no_native", action="store_true")
    sm.add_argument("--index_path", default=None,
                    help="serialized index: reload if present, else save")

    cm = sub.add_parser("captionmap")
    cm.add_argument("--metadata", required=True)
    cm.add_argument("--output", required=True)

    ex = sub.add_parser("extract")
    ex.add_argument("--mined_dir", required=True)
    ex.add_argument("--caption_map", required=True)
    ex.add_argument("--output", required=True)
    ex.add_argument("--model_cfg", default="vitb32_openclip_laion400m")
    ex.add_argument("--checkpoint_path", default=None)
    ex.add_argument("--bpe_path", default=None)
    ex.add_argument("--bsz", type=int, default=256)
    ex.add_argument("--mesh_data", type=int, default=-1,
                    help="data-parallel processes under a launcher (-1: "
                         "every one); 1 without one")
    ex.add_argument("--quantize", default="none", choices=["none", "int8"],
                    help="int8 = W8A8 quantized inference "
                         "(models/quant.py)")
    _add_device(ex)

    sp = sub.add_parser("sample")
    sp.add_argument("--dataset", default=None)
    sp.add_argument("--features", required=True)
    sp.add_argument("--prompts", required=True)
    sp.add_argument("--strategy", default="T2T-rank", choices=STRATEGIES)
    sp.add_argument("--num_samples", type=int, default=500)
    sp.add_argument("--engine", choices=("fused", "per-class"),
                    default="fused")
    sp.add_argument("--threshold", type=float, default=0.0)
    sp.add_argument("--t2i_threshold", type=float, default=None,
                    help="aux-gate threshold; default = the strategy's "
                         "reference value (0.25, or 0.65 for I2I-tshd)")
    sp.add_argument("--fewshot_features", default=None,
                    help="pre-extracted few-shot feature .npz "
                         "(image_features + labels) for the I2I/I2T "
                         "strategies and gates (reference "
                         "get_fewshot_features)")
    sp.add_argument("--rank_mode", choices=("exact", "approx", "auto"),
                    default="auto",
                    help="accepted as swat_tpu's; every mode ranks exactly "
                         "here (retrieval/rank.py)")
    sp.add_argument("--rank_chunk", type=int, default=None,
                    help="stream candidates through the ranking product in "
                         "chunks of this many rows (auto-engages at "
                         "LAION-scale pools)")
    sp.add_argument("--remove_duplicates", action="store_true")
    sp.add_argument("--zeroshot_filter", action="store_true")
    sp.add_argument("--relative_to", default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--output", required=True)
    _add_device(sp)

    args = p.parse_args(argv)
    if args.cmd == "stringmatch" and not (args.captions or args.index_dir
                                          or args.index_path):
        p.error("stringmatch needs --captions, --index_dir or --index_path")
    import torch.distributed as dist

    started_here = not dist.is_initialized()
    {"stringmatch": cmd_stringmatch, "captionmap": cmd_captionmap,
     "extract": cmd_extract, "sample": cmd_sample, "ingest": cmd_ingest,
     "mine-synonyms": cmd_mine_synonyms,
     "make-urls": cmd_make_urls,
     "filter-synonyms": cmd_filter_synonyms,
     "check-metrics": cmd_check_metrics}[args.cmd](args)
    if started_here and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
