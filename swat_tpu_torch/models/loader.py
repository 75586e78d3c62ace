"""Pretrained weights for the port's towers.

``CLIPModel`` carries OpenCLIP's own parameter names, so an OpenCLIP / CLIP
``.pt`` state dict loads as it is (``load_torch_checkpoint``, counterpart of
``swat_tpu/models/loader.py:302``).  ``state_dict_from_jax_params`` carries
the JAX package's param tree (as numpy arrays) across, mirroring
``swat_tpu.models.loader.params_to_torch_state_dict`` without importing it
(key map in that module's docstring); ``jax_params_from_state_dict`` is its
reverse, the port's counterpart of ``torch_state_dict_to_params`` (``:75``),
which the bundles and the feature-cache fingerprint use.  Both image
towers: the ViT, and the RN50 ``ModifiedResNet`` (``swat_tpu``'s
``torch_rn50_visual_to_params`` / ``_rn50_visual_to_torch``, ``:133-163``,
``:247-318``): convolution kernels torch ``[out, in, kh, kw]`` <-> flax
``[kh, kw, in, out]`` under ``conv/kernel``, blocks ``layer{s}_{i}`` with
``down_conv`` / ``down_bn``, BatchNorm leaves ``scale`` / ``bias`` /
``mean`` / ``var``, the blocks per stage read off the state dict.

A W8A8 tree (``models/quant.py``) crosses both ways too: a dense leaf
``{"kernel_q", "scale", "bias"?}`` is the state dict's ``<weight>_q``
(int8, [out, in] per layer: the stacked ``[L, in, out]`` codes
transposed) and ``<weight>_scale`` ([out] per layer, of the ``[L, out]``
scales), beside its bias; the patch embedding's ``[(kh, kw, in), width]``
codes become ``visual.conv1.weight_q`` ``[width, (kh, kw, in)]``, and the
projections' dicts ``visual.proj_q`` / ``text_projection_q`` ``[embed,
width]`` with their scales (``CLIPModel.int8_`` holds them).
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch


def load_torch_checkpoint(path: str) -> Tuple[dict, float]:
    """An OpenCLIP/CLIP ``.pt``/``.bin`` state dict (optionally wrapped in
    ``{"state_dict": ...}`` and/or carrying DataParallel's ``module.``
    prefix), OpenAI's TorchScript archive, or a ``.msgpack`` bundle of
    ``cli.convert`` (fp32 or int8, either package's) -> (state_dict of
    tensors, logit_scale)."""
    if path.endswith(".msgpack"):
        from swat_tpu_torch.train.checkpoint import load_bundle

        arrays, _ = load_bundle(path)
        logit_scale = float(np.asarray(arrays["logit_scale"]))
        return (state_dict_from_jax_params(arrays["clip"], logit_scale),
                logit_scale)
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
    """The JAX package's CLIP param tree (numpy leaves; transformer blocks
    stacked on a leading layer axis; a ViT or a ModifiedResNet image
    tower) -> the port's state dict."""
    out: dict = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def put_weight(key, leaf, i=None):
        """A flax kernel {"kernel": [in, out]} (torch's [out, in]
        transposed), a bare projection [width, embed] (kept), or a
        quantized leaf's codes (transposed) and scales; ``i`` picks a layer
        of a stacked leaf."""
        if isinstance(leaf, dict) and "kernel_q" in leaf:
            codes, scale = (np.asarray(leaf[k]) for k in ("kernel_q", "scale"))
            if i is not None:
                codes, scale = codes[i], scale[i]
            out[f"{key}_q"] = torch.from_numpy(np.array(codes.T, np.int8))
            put(f"{key}_scale", scale)
            return
        arr = np.asarray(leaf["kernel"] if isinstance(leaf, dict) else leaf)
        arr = arr if i is None else arr[i]
        put(key, arr.T if isinstance(leaf, dict) else arr)

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
                put_weight(f"{pre}.{w_key}", lin, i)
                put(f"{pre}.{b_key}", np.asarray(lin["bias"])[i])

    vis, txt = params["visual"], params["text"]
    if "patch_embed" not in vis:
        _rn50_visual_to_torch(vis, put)
        _put_text(txt, put, put_weight, put_ln, put_blocks)
        put("logit_scale", np.float32(logit_scale))
        return out
    if "kernel_q" in vis["patch_embed"]:
        put_weight("visual.conv1.weight", vis["patch_embed"])
    else:
        k = np.asarray(vis["patch_embed"]["kernel"], np.float32)  # [p*p*3, w]
        ppc, w = k.shape
        side = int(round((ppc // 3) ** 0.5))
        put("visual.conv1.weight",
            k.reshape(side, side, 3, w).transpose(3, 2, 0, 1))
    put("visual.class_embedding", vis["class_embedding"])
    put("visual.positional_embedding", vis["positional_embedding"])
    put_weight("visual.proj", vis["proj"])
    put_ln(vis["ln_pre"], "visual.ln_pre")
    put_ln(vis["ln_post"], "visual.ln_post")
    put_blocks(vis["transformer"]["blocks"], "visual.transformer.resblocks.")
    _put_text(txt, put, put_weight, put_ln, put_blocks)
    put("logit_scale", np.float32(logit_scale))
    return out


def _put_text(txt, put, put_weight, put_ln, put_blocks) -> None:
    put("token_embedding.weight", txt["token_embedding"])
    put("positional_embedding", txt["positional_embedding"])
    put_weight("text_projection", txt["text_projection"])
    put_ln(txt["ln_final"], "ln_final")
    put_blocks(txt["transformer"]["blocks"], "transformer.resblocks.")


def _rn50_visual_to_torch(vis: Mapping[str, Any], put) -> None:
    """The JAX package's ModifiedResNet tree -> ``put(key, array)`` of the
    port's (OpenCLIP's) names."""

    def put_conv(flax_conv, key):
        put(key, np.asarray(flax_conv["conv"]["kernel"]).transpose(3, 2, 0, 1))

    def put_bn(flax_bn, prefix):
        for leaf, name in (("scale", "weight"), ("bias", "bias"),
                           ("mean", "running_mean"), ("var", "running_var")):
            put(f"{prefix}.{name}", flax_bn[leaf])

    for i in (1, 2, 3):
        put_conv(vis[f"conv{i}"], f"visual.conv{i}.weight")
        put_bn(vis[f"bn{i}"], f"visual.bn{i}")
    for name, blk in vis.items():
        if not name.startswith("layer"):
            continue
        stage, idx = name[len("layer"):].split("_")
        pre = f"visual.layer{stage}.{idx}"
        for j in (1, 2, 3):
            put_conv(blk[f"conv{j}"], f"{pre}.conv{j}.weight")
            put_bn(blk[f"bn{j}"], f"{pre}.bn{j}")
        if "down_conv" in blk:
            put_conv(blk["down_conv"], f"{pre}.downsample.0.weight")
            put_bn(blk["down_bn"], f"{pre}.downsample.1")
    ap = vis["attnpool"]
    put("visual.attnpool.positional_embedding", ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        put(f"visual.attnpool.{name}.weight", np.asarray(ap[name]["kernel"]).T)
        put(f"visual.attnpool.{name}.bias", ap[name]["bias"])


def _np(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def _f32(t) -> np.ndarray:
    return _np(t).astype(np.float32)


def _layers(sd: Mapping[str, Any], prefix: str) -> int:
    return sum(1 for k in sd
               if k.startswith(prefix) and k.endswith(".ln_1.weight"))


def _rn50_visual_params(sd: Mapping[str, Any]) -> dict:
    """OpenCLIP's ModifiedResNet tensors -> the JAX package's tree; the
    blocks per stage are read off the state dict, so RN50's (3, 4, 6, 3)
    and smaller test towers alike load (``num_batches_tracked`` is not
    read)."""
    layers = tuple(
        1 + max(int(k.split(".")[2]) for k in sd
                if k.startswith(f"visual.layer{s}."))
        for s in (1, 2, 3, 4))

    def conv(key):
        return {"conv": {"kernel": _f32(sd[key]).transpose(2, 3, 1, 0)}}

    def bn(prefix):
        return {"scale": _f32(sd[f"{prefix}.weight"]),
                "bias": _f32(sd[f"{prefix}.bias"]),
                "mean": _f32(sd[f"{prefix}.running_mean"]),
                "var": _f32(sd[f"{prefix}.running_var"])}

    v: dict = {}
    for i in (1, 2, 3):
        v[f"conv{i}"] = conv(f"visual.conv{i}.weight")
        v[f"bn{i}"] = bn(f"visual.bn{i}")
    for stage, blocks in enumerate(layers):
        for i in range(blocks):
            pre = f"visual.layer{stage + 1}.{i}"
            blk = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = conv(f"{pre}.conv{j}.weight")
                blk[f"bn{j}"] = bn(f"{pre}.bn{j}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["down_conv"] = conv(f"{pre}.downsample.0.weight")
                blk["down_bn"] = bn(f"{pre}.downsample.1")
            v[f"layer{stage + 1}_{i}"] = blk
    ap = "visual.attnpool"
    v["attnpool"] = {"positional_embedding":
                     _f32(sd[f"{ap}.positional_embedding"])}
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        v["attnpool"][name] = {"kernel": _f32(sd[f"{ap}.{name}.weight"]).T,
                               "bias": _f32(sd[f"{ap}.{name}.bias"])}
    return v


def jax_params_from_state_dict(sd: Mapping[str, Any]) -> Tuple[dict, float]:
    """The port's (OpenCLIP-named) state dict -> (the JAX package's CLIP
    param tree of float32 numpy arrays, logit_scale): flax kernels [in,
    out], each tower's blocks stacked on a leading layer axis, the patch
    embedding as a [p*p*3, width] matrix in the NHWC unfold order (a ViT),
    or the ModifiedResNet tree (an RN50).  Bit for bit what
    ``swat_tpu.models.loader.torch_state_dict_to_params`` makes of the same
    tensors."""

    def blocks(prefix):
        n = _layers(sd, prefix)

        def stack(name, transpose=False):
            mats = [_f32(sd[f"{prefix}{i}.{name}"]) for i in range(n)]
            return np.stack([m.T for m in mats] if transpose else mats)

        def linear(w, b):
            if f"{prefix}0.{w}_q" in sd:
                return {"kernel_q": np.stack([
                            _np(sd[f"{prefix}{i}.{w}_q"]).T
                            for i in range(n)]),
                        "scale": stack(f"{w}_scale"), "bias": stack(b)}
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

    def quantized(key):
        return {"kernel_q": _np(sd[f"{key}_q"]).T,
                "scale": _f32(sd[f"{key}_scale"])}

    def projection(key):
        return quantized(key) if f"{key}_q" in sd else _f32(sd[key])

    if "visual.layer1.0.conv1.weight" in sd:
        visual = _rn50_visual_params(sd)
    else:
        if "visual.conv1.weight_q" in sd:
            patch_embed = quantized("visual.conv1.weight")
        else:
            conv1 = _f32(sd["visual.conv1.weight"])      # [w, 3, p, p]
            w, c, p, _ = conv1.shape
            patch_embed = {"kernel": conv1.transpose(2, 3, 1, 0).reshape(
                p * p * c, w)}
        visual = {
            "patch_embed": patch_embed,
            "class_embedding": _f32(sd["visual.class_embedding"]),
            "positional_embedding": _f32(sd["visual.positional_embedding"]),
            "ln_pre": ln("visual.ln_pre"),
            "ln_post": ln("visual.ln_post"),
            "proj": projection("visual.proj"),
            "transformer": {"blocks": blocks(
                "visual.transformer.resblocks.")},
        }
    params = {
        "visual": visual,
        "text": {
            "token_embedding": _f32(sd["token_embedding.weight"]),
            "positional_embedding": _f32(sd["positional_embedding"]),
            "ln_final": ln("ln_final"),
            "text_projection": projection("text_projection"),
            "transformer": {"blocks": blocks("transformer.resblocks.")},
        },
    }
    return params, float(_f32(sd["logit_scale"]).reshape(()))
