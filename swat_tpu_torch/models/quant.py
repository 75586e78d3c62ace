# Copied from swat_tpu/models/quant.py, on numpy trees (np.asarray where swat_tpu has jnp.asarray); the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Post-training W8A8 quantization for CLIP inference towers.

Weights are quantized offline to int8 with one fp32 scale per output
channel; activations are quantized dynamically per row (absmax / 127)
right before each product, so no calibration data is needed.  Everything
else (LayerNorm, softmax, attention internals, residuals, the final L2
normalize) stays in the regular bf16/fp32 policy.

This is inference-only and opt-in (``--quantize int8`` on the eval CLI
and the converter): the reference has no quantized path at all (it runs
fp32 torch end to end).

Mechanics: ``quantize_tree`` rewrites every dense kernel of the ViT param
tree (the JAX package's layout, numpy leaves) into {"kernel_q": int8,
"scale": fp32[out], "bias": ...}, per output channel over the contraction
axis with ``np.rint``, so its codes and scales are those of
``swat_tpu.models.quant`` bit for bit.  ``models.loader`` carries such a
tree into a state dict of int8 codes and scales, which
``CLIPModel.int8_`` gives the towers room for (buffers, not parameters),
and ``models.clip.dense`` / ``project`` run the W8A8 product where they
find them.  Gradients are meaningless through the rounding: never train on
a quantized tree (``train.state.create_train_state`` refuses one).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

# leaves living inside dicts that also hold a dense "kernel"
_DENSE_KEYS = ("qkv", "out", "fc", "proj", "patch_embed")


def quantize_weight(w, reduce_axes=None):
    """Symmetric int8 with one fp32 scale per output channel: returns
    (w_q, scale) with w ~= w_q * scale.  ``reduce_axes`` defaults to the
    contraction (``in``) axis only, so stacked per-layer kernels
    [L, in, out] get an independent scale per (layer, channel) — layers
    with different weight ranges never crush each other's resolution."""
    w = np.asarray(w, np.float32)
    if reduce_axes is None:
        reduce_axes = (w.ndim - 2,)
    absmax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return w_q, np.squeeze(scale, axis=reduce_axes)


def _quantize_dense(p: Dict[str, Any]) -> Dict[str, Any]:
    """{"kernel": [.., in, out], "bias"?} -> {"kernel_q", "scale", "bias"?}.

    Stacked block leaves are [L, in, out]; the per-channel scale is then
    per (layer, channel) — [L, out] — so each layer keeps its own range."""
    w_q, scale = quantize_weight(np.asarray(p["kernel"], np.float32))
    out = {"kernel_q": np.asarray(w_q), "scale": np.asarray(scale)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _quantize_proj(leaf):
    """Bare projection matrices (visual 'proj', text 'text_projection'):
    [width, embed] arrays become the same dict form."""
    w_q, scale = quantize_weight(np.asarray(leaf, np.float32))
    return {"kernel_q": np.asarray(w_q), "scale": np.asarray(scale)}


def _walk(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if k in _DENSE_KEYS and "kernel" in v:
                out[k] = _quantize_dense(v)
            else:
                out[k] = _walk(v)
        elif k in ("proj", "text_projection"):
            out[k] = _quantize_proj(v)
        else:
            out[k] = v
    return out


def quantize_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize a CLIP param tree (ViT towers only) for int8 inference.

    Dense kernels (per-layer qkv / attn-out / mlp fc / mlp proj, the
    patch embedding, and both final projections) become int8 +
    per-channel scales; embeddings, LayerNorms, and biases stay fp32.
    """
    if "visual" in params and "patch_embed" not in params.get(
            "visual", {}):
        raise ValueError(
            "quantize_tree supports ViT param trees only (the RN50 tower "
            "has no quantized path)")
    return _walk(params)


def is_quantized(params: Dict[str, Any]) -> bool:
    vis = params.get("visual", params)
    pe = vis.get("patch_embed", {})
    return isinstance(pe, dict) and "kernel_q" in pe
