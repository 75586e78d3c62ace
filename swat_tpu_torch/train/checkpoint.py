"""Bundles, train checkpoints and score files (counterpart of
``swat_tpu/train/checkpoint.py:33-170,209-218``).

The same files as the JAX package: a bundle is one flax-msgpack file of
numpy arrays (``train/msgpack_tree.py``) plus a ``.json`` sidecar of
scalars, and the model inside it is the JAX package's param tree
(``models.loader.jax_params_from_state_dict``), so either package reads
the other's stage bundles.  The score files and the ``.npy`` confusion
matrices are the same too.

Train checkpoints (``--save_ckpt``, ``ckpt_ep{E}_it{I}.msgpack``) hold the
model, head, logit_scale, step and the port's own AdamW state, keyed by
parameter name.  optax's multi-transform state does not map one to one
onto torch's AdamW, so a train checkpoint resumes only in the package that
wrote it (ROADMAP Queue C, recorded departures).  The orbax pair of the
JAX package has no counterpart here.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from swat_tpu_torch.models.loader import (jax_params_from_state_dict,
                                          state_dict_from_jax_params)
from swat_tpu_torch.train import msgpack_tree


def to_numpy(tree):
    """Tensors (any device) and numbers -> float32 / own-dtype numpy arrays,
    through dicts; what a bundle stores."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_bundle(path: str, arrays: dict, meta: Optional[dict] = None):
    """arrays: a dict tree of arrays -> one msgpack file; meta -> the json
    sidecar (``swat_tpu.train.checkpoint.save_bundle``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        msgpack_tree.write(f, to_numpy(arrays))
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=4, default=float)


def load_bundle(path: str) -> Tuple[dict, dict]:
    """-> (arrays, meta); the arrays are read-only numpy views of the
    file's bytes."""
    with open(path, "rb") as f:
        arrays = msgpack_tree.unpackb(f.read())
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return arrays, meta


def best_model_path(output_dir: str, stage: int, best_epoch: int) -> str:
    # reference naming: utils/models.py:116
    return os.path.join(
        output_dir, f"stage{stage}_model_best-epoch_{best_epoch}_best.msgpack")


def save_best_model(output_dir: str, stage: int, *, best_records: dict,
                    model_params, head, logit_scale, test_acc: float,
                    best_tau=None, best_tau_test_acc: float = -1,
                    wsft_test_acc: float = -1, best_tau_head=None,
                    wsft_backbone=None, wsft_head=None) -> str:
    """Stage-final bundle (reference utils/models.py:110-146) with its
    sibling stage{N}_val_scores_best.json and confusion matrix.
    ``model_params`` / ``wsft_backbone``: state dicts of the port, written
    as the JAX package's param trees."""
    path = best_model_path(output_dir, stage,
                           best_records.get("best_epoch", -1))
    with open(os.path.join(
            output_dir, f"stage{stage}_val_scores_best.json"), "w") as f:
        json.dump(best_records.get("best_scores", {}), f, indent=4,
                  default=float)
    cm = best_records.get("best_confusion_matrix")
    if cm is not None:
        np.save(os.path.join(
            output_dir, f"stage{stage}_val_confusion_matrix_best.npy"), cm)

    arrays = {
        "clip": jax_params_from_state_dict(model_params)[0],
        "head": head,
        "logit_scale": np.asarray(to_numpy(logit_scale), np.float32),
        "best_tau_head": ({} if best_tau_head is None else
                          {"w": best_tau_head}),
        "wsft_head": {} if wsft_head is None else {"w": wsft_head},
        "wsft_backbone": ({} if wsft_backbone is None
                          else jax_params_from_state_dict(wsft_backbone)[0]),
    }
    meta = {
        "best_val_acc": best_records.get("best_val_acc", -1),
        "best_epoch": best_records.get("best_epoch", -1),
        "best_iter": best_records.get("best_iter", -1),
        "test_acc": round(float(test_acc), 3),
        "best_tau": best_tau,
        "best_tau_test_acc": round(float(best_tau_test_acc), 3),
        "wsft_test_acc": round(float(wsft_test_acc), 3),
    }
    save_bundle(path, arrays, meta)
    return path


def load_best_model(path: str, params_template=None, head_template=None):
    """-> (JAX param tree, head, logit_scale, meta) with the reference's
    three formats (testing.py:85-117), as
    ``swat_tpu.train.checkpoint.load_best_model``:

    1. 'clip' + 'head'      the full stage bundle;
    2. 'model'              visual tower only: its weights replace the
                            template's, the text tower and the head stay
                            the caller's;
    3. 'best_tau_head' only the tau-normalized head, into the template.

    Formats 2 and 3 give logit_scale ln(100).  The tau and WiSE-FT
    artifacts stay readable through ``load_bundle``."""
    arrays, meta = load_bundle(path)
    if "clip" in arrays:
        return (arrays["clip"], arrays["head"],
                float(np.asarray(arrays["logit_scale"])), meta)
    log100 = float(np.log(100.0))
    if "model" in arrays:
        if params_template is None:
            raise ValueError(f"{path} is a visual-only checkpoint; a "
                             "params template is required")
        params = dict(params_template)
        params["visual"] = arrays["model"].get("visual", arrays["model"])
        return params, head_template, log100, meta
    tau = arrays.get("best_tau_head")
    if tau is not None and len(tau):   # {} when save_best_model had none
        if params_template is None:
            raise ValueError(f"{path} is a tau-head-only checkpoint; a "
                             "params template is required")
        head = tau["w"] if isinstance(tau, dict) else tau
        return params_template, head, log100, meta
    raise ValueError(f"no model weights found in {path}: {list(arrays)}")


# ---------------------------------------------------------------------------
# periodic train checkpoints (--save_ckpt / --resume)

def _opt_names(state) -> dict:
    """id(parameter) -> its place in the trainable tree, ('model', name),
    ('head',) or ('logit_scale',)."""
    names = {id(p): ("model", n) for n, p in state.model.named_parameters()}
    names[id(state.head)] = ("head",)
    names[id(state.logit_scale)] = ("logit_scale",)
    return names


def _opt_state_tree(state) -> dict:
    """The AdamW state of every parameter in the optimizer, keyed as the
    trainable tree: {'model': {name: {...}}, 'head': {...}, ...}."""
    names = _opt_names(state)
    tree: dict = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            slots = {k: to_numpy(v) for k, v in
                     state.optimizer.state.get(p, {}).items()}
            where = names[id(p)]
            if where[0] == "model":
                tree.setdefault("model", {})[where[1]] = slots
            else:
                tree[where[0]] = slots
    return tree


def save_train_ckpt(ckpt_dir: str, tag: str, state, best_records: dict):
    """``ckpt_{tag}.msgpack``: model (JAX param tree), head, logit_scale,
    the AdamW state and the step (reference save_model_ckpt)."""
    path = os.path.join(ckpt_dir, f"ckpt_{tag}.msgpack")
    arrays = {
        "model": jax_params_from_state_dict(state.model.state_dict())[0],
        "head": state.head,
        "logit_scale": state.logit_scale,
        "opt_state": _opt_state_tree(state),
        "step": np.asarray(state.step, np.int32),
    }
    meta = {k: v for k, v in best_records.items()
            if isinstance(v, (int, float, str))}
    save_bundle(path, arrays, meta)
    return path


def load_train_ckpt(path: str, state):
    """Restores a checkpoint of ``save_train_ckpt`` into ``state`` in place,
    optimizer state included -> (state, meta).  A checkpoint of the JAX
    package (optax state) raises ValueError."""
    arrays, meta = load_bundle(path)
    opt = arrays.get("opt_state")
    if not isinstance(opt, dict) or not isinstance(opt.get("head"), dict) \
            or "exp_avg" not in opt["head"]:
        raise ValueError(
            f"{path} does not hold the port's AdamW state (a checkpoint of "
            "swat_tpu?); train checkpoints resume only in the package that "
            "wrote them (ROADMAP Queue C)")
    sd = state_dict_from_jax_params(arrays["model"],
                                    state.model.logit_scale.item())
    state.model.load_state_dict(sd)
    with torch.no_grad():
        state.head.copy_(torch.from_numpy(np.array(arrays["head"])))
        state.logit_scale.copy_(torch.from_numpy(
            np.array(arrays["logit_scale"])))
    names = _opt_names(state)
    saved = {}
    index = 0
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            where = names[id(p)]
            slots = (opt["model"][where[1]] if where[0] == "model"
                     else opt[where[0]])
            saved[index] = {k: torch.from_numpy(np.array(v))
                            for k, v in slots.items()}
            index += 1
    full = state.optimizer.state_dict()
    full["state"] = saved
    state.optimizer.load_state_dict(full)
    state.step = int(np.asarray(arrays["step"]))
    return state, meta


def save_test_scores(scores: dict, confusion_matrix, output_dir: str,
                     tag: str, stage: int = 1):
    """reference utils/models.py:149-159 (npy instead of pickle)."""
    with open(os.path.join(output_dir,
                           f"stage{stage}_{tag}_scores.json"), "w") as f:
        json.dump(scores, f, indent=4, default=float)
    if confusion_matrix is not None:
        np.save(os.path.join(
            output_dir, f"stage{stage}_{tag}_confusion_matrix.npy"),
            confusion_matrix)
