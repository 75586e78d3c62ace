# Copied from swat_tpu/cli/convert.py, on the port's loader and bundle writer; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Checkpoint conversion CLI of the PyTorch port: OpenCLIP/CLIP torch
``.pt`` -> msgpack bundle.

    python -m swat_tpu_torch.cli.convert --checkpoint vitb32_laion400m_e32.pt \
        --model_cfg vitb32_openclip_laion400m --output vitb32.msgpack

The bundle holds the JAX package's param tree (``clip``) and
``logit_scale``, byte for byte the bundle ``swat_tpu.cli.convert`` writes
(fp32 or, with ``--quantize int8``, W8A8), with the same JSON report as its
``.json`` sidecar and on stdout.  Either package takes it as
``--checkpoint_path``.

Round-trip validation (on by default; ``--no_verify`` skips it): the
converted tree is carried back to a state dict
(``loader.state_dict_from_jax_params``) and every tensor must equal the
source's bit for bit, compared on ``--device`` (default cuda; cpu for a
host without a GPU).  ``--quantize int8`` quantizes after that check.
"""

from __future__ import annotations

import argparse
import json


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def convert(checkpoint: str, model_cfg: str, output: str,
            verify: bool = True, quantize: str = "none",
            device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from swat_tpu_torch.models.configs import get_model_config
    from swat_tpu_torch.models.loader import (jax_params_from_state_dict,
                                              load_torch_checkpoint,
                                              state_dict_from_jax_params)
    from swat_tpu_torch.train.checkpoint import save_bundle
    from swat_tpu_torch.train.stages import resolve_device

    dev = resolve_device(device)
    get_model_config(model_cfg)
    sd, logit_scale = load_torch_checkpoint(checkpoint)
    params, _ = jax_params_from_state_dict(sd)

    report = {"model_cfg": model_cfg, "source": checkpoint,
              "logit_scale": float(logit_scale),
              "num_params": int(sum(np.asarray(x).size
                                    for x in _leaves(params)))}
    if verify:
        back = state_dict_from_jax_params(params, logit_scale)
        mismatched = []
        for k, v in back.items():
            if k not in sd:
                mismatched.append(f"missing {k}")
            elif not torch.equal(v.to(dev), sd[k].to(dev).float()):
                mismatched.append(k)
        report["roundtrip_mismatches"] = mismatched
        if mismatched:
            raise ValueError(f"round-trip mismatch: {mismatched[:10]}")

    if quantize == "int8":
        # W8A8 serving bundle (models/quant.py), quantized after the
        # round-trip check; training from it is refused
        # (train.state.create_train_state)
        from swat_tpu_torch.models.quant import quantize_tree

        params = quantize_tree(params)
        report["quantize"] = "int8"
    elif quantize != "none":
        raise ValueError(f"unknown quantize mode {quantize!r}")

    save_bundle(output, {"clip": params, "logit_scale": logit_scale},
                meta=report)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        description="swat-tpu-torch checkpoint converter")
    p.add_argument("--checkpoint", required=True,
                   help="OpenCLIP/CLIP .pt/.bin state dict")
    p.add_argument("--model_cfg", default="vitb32_openclip_laion400m")
    p.add_argument("--output", required=True, help="msgpack bundle path")
    p.add_argument("--no_verify", action="store_true",
                   help="skip the round-trip check")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8 = write a W8A8 inference bundle "
                        "(models/quant.py): ~4x smaller, eval-only")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the round-trip check compares")
    args = p.parse_args(argv)
    report = convert(args.checkpoint, args.model_cfg, args.output,
                     verify=not args.no_verify, quantize=args.quantize,
                     device=args.device)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
