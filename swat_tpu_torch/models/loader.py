"""Pretrained weights for the port's towers.

``CLIPModel`` carries OpenCLIP's own parameter names, so an OpenCLIP / CLIP
``.pt`` state dict loads as it is (``load_torch_checkpoint``, counterpart of
``swat_tpu/models/loader.py:302``).  ``state_dict_from_jax_params`` carries
the JAX package's param tree (as numpy arrays) across, mirroring
``swat_tpu.models.loader.params_to_torch_state_dict`` without importing it
(key map in that module's docstring); ``jax_params_from_state_dict`` is its
reverse, the port's counterpart of ``torch_state_dict_to_params`` (``:75``),
which the bundles and the feature-cache fingerprint use.  Only ViT towers:
the ResNet tower is not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch


def load_torch_checkpoint(path: str) -> Tuple[dict, float]:
    """An OpenCLIP/CLIP ``.pt``/``.bin`` state dict (optionally wrapped in
    ``{"state_dict": ...}`` and/or carrying DataParallel's ``module.``
    prefix), or OpenAI's TorchScript archive -> (state_dict of tensors,
    logit_scale)."""
    # weights_only=False as in swat_tpu: a TorchScript archive (OpenAI's
    # CLIP releases) cannot be loaded with weights_only=True
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif hasattr(ckpt, "state_dict"):  # jit-scripted archive
        ckpt = ckpt.state_dict()
    # OpenAI's archives also carry these three scalars, which are config,
    # not parameters (openai/CLIP clip/model.py build_model drops them too)
    sd = {k.removeprefix("module."): v for k, v in ckpt.items()
          if k not in ("input_resolution", "context_length", "vocab_size")}
    return sd, float(sd["logit_scale"].reshape(()))


def state_dict_from_jax_params(params: Mapping[str, Any],
                               logit_scale: float) -> dict:
    """The JAX package's ViT CLIP param tree (numpy leaves; transformer
    blocks stacked on a leading layer axis) -> the port's state dict."""
    out: dict = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def put_ln(flax_ln, name):
        put(f"{name}.weight", flax_ln["ln"]["scale"])
        put(f"{name}.bias", flax_ln["ln"]["bias"])

    def put_blocks(blocks, prefix):
        n = np.asarray(blocks["ln_1"]["ln"]["scale"]).shape[0]
        linears = (("attn", "qkv", "attn.in_proj_weight", "attn.in_proj_bias"),
                   ("attn", "out", "attn.out_proj.weight",
                    "attn.out_proj.bias"),
                   ("mlp", "fc", "mlp.c_fc.weight", "mlp.c_fc.bias"),
                   ("mlp", "proj", "mlp.c_proj.weight", "mlp.c_proj.bias"))
        for i in range(n):
            pre = f"{prefix}{i}"
            for ln in ("ln_1", "ln_2"):
                put(f"{pre}.{ln}.weight", np.asarray(blocks[ln]["ln"]["scale"])[i])
                put(f"{pre}.{ln}.bias", np.asarray(blocks[ln]["ln"]["bias"])[i])
            for group, name, w_key, b_key in linears:
                lin = blocks[group][name]
                # flax kernels are [in, out]; torch weights [out, in]
                put(f"{pre}.{w_key}", np.asarray(lin["kernel"])[i].T)
                put(f"{pre}.{b_key}", np.asarray(lin["bias"])[i])

    vis, txt = params["visual"], params["text"]
    if "patch_embed" not in vis:
        raise NotImplementedError("ResNet image towers are not ported yet "
                                  "(ROADMAP Queue A item 7)")
    k = np.asarray(vis["patch_embed"]["kernel"], np.float32)  # [p*p*3, w]
    ppc, w = k.shape
    side = int(round((ppc // 3) ** 0.5))
    put("visual.conv1.weight", k.reshape(side, side, 3, w).transpose(3, 2, 0, 1))
    put("visual.class_embedding", vis["class_embedding"])
    put("visual.positional_embedding", vis["positional_embedding"])
    put("visual.proj", vis["proj"])
    put_ln(vis["ln_pre"], "visual.ln_pre")
    put_ln(vis["ln_post"], "visual.ln_post")
    put_blocks(vis["transformer"]["blocks"], "visual.transformer.resblocks.")

    put("token_embedding.weight", txt["token_embedding"])
    put("positional_embedding", txt["positional_embedding"])
    put("text_projection", txt["text_projection"])
    put_ln(txt["ln_final"], "ln_final")
    put_blocks(txt["transformer"]["blocks"], "transformer.resblocks.")
    put("logit_scale", np.float32(logit_scale))
    return out


def _f32(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t)).astype(np.float32)


def _layers(sd: Mapping[str, Any], prefix: str) -> int:
    return sum(1 for k in sd
               if k.startswith(prefix) and k.endswith(".ln_1.weight"))


def jax_params_from_state_dict(sd: Mapping[str, Any]) -> Tuple[dict, float]:
    """The port's (OpenCLIP-named) state dict -> (the JAX package's ViT CLIP
    param tree of float32 numpy arrays, logit_scale): flax kernels [in,
    out], each tower's blocks stacked on a leading layer axis, the patch
    embedding as a [p*p*3, width] matrix in the NHWC unfold order.  Bit
    for bit what ``swat_tpu.models.loader.torch_state_dict_to_params``
    makes of the same tensors."""
    if "visual.conv1.weight" not in sd:
        raise NotImplementedError("ResNet image towers are not ported yet "
                                  "(ROADMAP Queue A item 7)")

    def blocks(prefix):
        n = _layers(sd, prefix)

        def stack(name, transpose=False):
            mats = [_f32(sd[f"{prefix}{i}.{name}"]) for i in range(n)]
            return np.stack([m.T for m in mats] if transpose else mats)

        def linear(w, b):
            return {"kernel": stack(w, True), "bias": stack(b)}

        return {
            "ln_1": {"ln": {"scale": stack("ln_1.weight"),
                            "bias": stack("ln_1.bias")}},
            "ln_2": {"ln": {"scale": stack("ln_2.weight"),
                            "bias": stack("ln_2.bias")}},
            "attn": {"qkv": linear("attn.in_proj_weight",
                                   "attn.in_proj_bias"),
                     "out": linear("attn.out_proj.weight",
                                   "attn.out_proj.bias")},
            "mlp": {"fc": linear("mlp.c_fc.weight", "mlp.c_fc.bias"),
                    "proj": linear("mlp.c_proj.weight", "mlp.c_proj.bias")},
        }

    def ln(name):
        return {"ln": {"scale": _f32(sd[f"{name}.weight"]),
                       "bias": _f32(sd[f"{name}.bias"])}}

    conv1 = _f32(sd["visual.conv1.weight"])          # [w, 3, p, p]
    w, c, p, _ = conv1.shape
    params = {
        "visual": {
            "patch_embed": {"kernel": conv1.transpose(2, 3, 1, 0).reshape(
                p * p * c, w)},
            "class_embedding": _f32(sd["visual.class_embedding"]),
            "positional_embedding": _f32(sd["visual.positional_embedding"]),
            "ln_pre": ln("visual.ln_pre"),
            "ln_post": ln("visual.ln_post"),
            "proj": _f32(sd["visual.proj"]),
            "transformer": {"blocks": blocks(
                "visual.transformer.resblocks.")},
        },
        "text": {
            "token_embedding": _f32(sd["token_embedding.weight"]),
            "positional_embedding": _f32(sd["positional_embedding"]),
            "ln_final": ln("ln_final"),
            "text_projection": _f32(sd["text_projection"]),
            "transformer": {"blocks": blocks("transformer.resblocks.")},
        },
    }
    return params, float(_f32(sd["logit_scale"]).reshape(()))
