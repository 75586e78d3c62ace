"""Retrieval samplers: rank the mined pool per class, apply thresholds /
dedup / zero-shot filters, write the split file training consumes
(counterpart of ``swat_tpu/retrieval/sampler.py``).

Mirrors the 9 live strategies of the reference ``sampling()`` dispatch
(reference retrieval/sample_retrieval.py:1471-1670).  Each strategy is a
(rank score, threshold gate, optional aux gate) triple:

  Random            random order; gate prompt.img >= threshold when
                    threshold != 0 (random_sampler, :592-663)
  Random-I2I        random order; gate fewshot-MEAN.img >= threshold when
                    threshold != 0 (random_sampler_i2i, :664-722)
  I2I-rank          rank by mean p2p sim(few-shot imgs, img)
                    (i2i_ranked_sampler_p2p, :1016-1077)
  I2T-rank          rank by mean p2p sim(few-shot imgs, CAPTION)
                    (i2t_rank_sampler, :1079-1137)
  T2T-rank          rank by prompt.caption  (SWAT default, :724-771)
  T2T-rank-T2I-tshd T2T rank + prompt.img >= 0.25
                    (t2t_ranked_t2i_tshd_sampler, :774-829)
  T2T-rank-I2T-tshd T2T rank + max p2p sim(few-shot imgs, caption) >= 0.25
                    (t2t_rank_i2t_tshd_sampler, :831-891)
  T2T-rank-I2I-tshd T2T rank + max p2p sim(few-shot imgs, img) >= 0.65
                    (t2t_rank_i2i_tshd_sampler, :893-956)
  T2I-rank          rank by prompt.img  (t2i_ranked_sampler, :1195-1244)

Output: ``{prefix}.txt`` with ``path label 0`` lines
(save_sample_file_list, :1457-1469) + sampled/filtered debug lists.

Both engines take an explicit ``device`` (default the card); the Random
strategies walk the host ``np.random.default_rng(seed)`` as ``swat_tpu``
does, so their draws are identical.  ``mesh=`` ranks the fused sampler's
candidates over a data-parallel mesh (``rank.rank_candidates``); the masks
and the host walk are the same on every rank.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from swat_tpu_torch.retrieval import rank as R

STRATEGIES = ("Random", "Random-I2I", "I2I-rank", "I2T-rank", "T2T-rank",
              "T2T-rank-T2I-tshd", "T2T-rank-I2T-tshd",
              "T2T-rank-I2I-tshd", "T2I-rank")

# reference aux-gate defaults: add_t2t_ranked_t2i_tshd_to_split's
# t2i_threshold=0.25 (:540) and the I2I variant's explicit 0.65 (:943)
AUX_THRESHOLD_DEFAULTS = {
    "T2T-rank-T2I-tshd": 0.25,
    "T2T-rank-I2T-tshd": 0.25,
    "T2T-rank-I2I-tshd": 0.65,
}


def strategy_needs_fewshot(strategy: str, threshold: float = 0.0) -> bool:
    """Strategies whose score or gate reads few-shot exemplar features
    (reference get_fewshot_features callers).  Random-I2I touches them
    only when thresholding (random_sampler_i2i :764-771)."""
    if strategy in ("I2I-rank", "I2T-rank", "T2T-rank-I2T-tshd",
                    "T2T-rank-I2I-tshd"):
        return True
    return strategy == "Random-I2I" and threshold != 0


def _check_fewshot(strategy, threshold, fewshot_feats_by_class, classes):
    """Both engines fail identically and early when few-shot features are
    required but absent."""
    if not strategy_needs_fewshot(strategy, threshold):
        return
    if fewshot_feats_by_class is None:
        raise ValueError(
            f"strategy {strategy!r} requires few-shot exemplar features "
            "(fewshot_feats_by_class / --fewshot_features)")
    missing = [c for c in classes if c not in fewshot_feats_by_class]
    if missing:
        raise ValueError(
            f"strategy {strategy!r}: no few-shot features for pool "
            f"class(es) {missing}")


class MinedPool:
    """Per-class candidates: file paths + image/caption embeddings.

    Built from the mined-feature bundle (swat_tpu_torch.retrieval.mined),
    the equivalent of the reference's transform_extracted_fea regrouping
    (sample_retrieval.py:1387-1415)."""

    def __init__(self, file_paths: Sequence[str], labels: np.ndarray,
                 image_feats: np.ndarray,
                 caption_feats: Optional[np.ndarray] = None,
                 captions: Optional[Sequence[str]] = None):
        self.file_paths = list(file_paths)
        self.labels = np.asarray(labels, np.int32)
        self.image_feats = np.asarray(image_feats, np.float32)
        self.caption_feats = (None if caption_feats is None
                              else np.asarray(caption_feats, np.float32))
        self.captions = list(captions) if captions is not None else None

    def classes(self) -> List[int]:
        return sorted(set(int(c) for c in self.labels))

    def class_indices(self, cls: int) -> np.ndarray:
        return np.where(self.labels == cls)[0]


def sample_retrieved(
    pool: MinedPool,
    prompt_tensors: Dict[str, dict],
    strategy: str = "T2T-rank",
    num_samples: int = 500,
    threshold: float = 0.0,
    t2i_threshold: Optional[float] = None,
    fewshot_feats_by_class: Optional[Dict[int, np.ndarray]] = None,
    remove_duplicates: bool = False,
    zeroshot_filter_head: Optional[np.ndarray] = None,
    seed: int = 0,
    device="cuda",
) -> Dict[str, list]:
    """The per-class oracle.  Returns {'file_list', 'label_list',
    'score_list', 'sampled_info', 'filtered_info', 'num_sampled'}; feed
    'file_list'/'label_list' to `write_split_file`.  ``t2i_threshold=None``
    uses the strategy's reference default (AUX_THRESHOLD_DEFAULTS)."""
    if strategy not in STRATEGIES:
        raise NotImplementedError(f"strategy {strategy}")
    if t2i_threshold is None:
        t2i_threshold = AUX_THRESHOLD_DEFAULTS.get(strategy, 0.25)
    _check_fewshot(strategy, threshold, fewshot_feats_by_class,
                   pool.classes())
    rng = np.random.default_rng(seed)

    drop: Dict[int, set] = defaultdict(set)
    if remove_duplicates:
        for cls in pool.classes():
            idx = pool.class_indices(cls)
            local = R.near_duplicate_indices(pool.image_feats[idx],
                                             device=device)
            drop[cls].update(int(idx[i]) for i in local)
    if zeroshot_filter_head is not None:
        bad = R.zeroshot_misclassified(
            pool.image_feats, pool.labels, zeroshot_filter_head,
            device=device)
        for i in bad:
            drop[int(pool.labels[i])].add(int(i))

    out = {"file_list": [], "label_list": [], "score_list": [],
           "sampled_info": [], "filtered_info": [], "num_sampled": {}}

    for cls in pool.classes():
        idx = pool.class_indices(cls)
        if idx.size == 0:
            continue
        img = pool.image_feats[idx]
        cap = (pool.caption_feats[idx]
               if pool.caption_feats is not None else None)
        prompt = np.asarray(prompt_tensors[str(cls)]["mean"],
                            np.float32)[None, :]

        # (score, order) + optional aux gate per reference strategy table
        # (module docstring).  ``score`` is always the value compared to
        # ``threshold``; the Random strategies ORDER randomly but GATE on
        # a similarity (sim literally 1.0 when threshold==0, reference
        # random_sampler :621-628).
        t2i = None
        if strategy in ("Random", "Random-I2I"):
            if threshold == 0:
                score = np.ones(idx.size, np.float32)
            elif strategy == "Random":
                score = R.t2i_similarity(prompt, img, device)
            else:
                fs_mean = np.asarray(fewshot_feats_by_class[cls],
                                     np.float32).mean(axis=0)
                score = R.i2i_similarity(fs_mean[None, :], img, device)
            order = rng.permutation(idx.size)
        else:
            if strategy == "I2I-rank":
                fs = fewshot_feats_by_class[cls]
                score = R.i2i_similarity_p2p(fs, img, "mean", device)
            elif strategy == "I2T-rank":
                fs = fewshot_feats_by_class[cls]
                score = R.i2i_similarity_p2p(fs, cap, "mean", device)
            elif strategy == "T2I-rank":
                score = R.t2i_similarity(prompt, img, device)
            else:   # the T2T-rank family
                score = R.t2t_similarity(prompt, cap, device)
                if strategy == "T2T-rank-T2I-tshd":
                    t2i = R.t2i_similarity(prompt, img, device)
                elif strategy == "T2T-rank-I2T-tshd":
                    fs = fewshot_feats_by_class[cls]
                    t2i = R.i2i_similarity_p2p(fs, cap, "max", device)
                elif strategy == "T2T-rank-I2I-tshd":
                    fs = fewshot_feats_by_class[cls]
                    t2i = R.i2i_similarity_p2p(fs, img, "max", device)
            order = np.argsort(-score, kind="stable")

        ct = 0
        for local_i in order:
            if ct == num_samples:
                break
            gi = int(idx[local_i])
            s = float(score[local_i])
            path = pool.file_paths[gi]
            keep = (s >= threshold and gi not in drop[cls])
            if t2i is not None:
                keep = keep and float(t2i[local_i]) >= t2i_threshold
            info = (f"{round(s, 4)}/{threshold}"
                    + (f", {round(float(t2i[local_i]), 4)}/{t2i_threshold}"
                       if t2i is not None else "")
                    + f", {path}"
                    + (f", {pool.captions[gi]}" if pool.captions else ""))
            if keep:
                out["file_list"].append(path)
                out["label_list"].append(cls)
                out["score_list"].append(s)
                out["sampled_info"].append(info)
                ct += 1
            else:
                out["filtered_info"].append(info)
        out["num_sampled"][cls] = ct
    return out


def _strategy_matrices(pool: MinedPool, prompt_tensors: Dict[str, dict],
                       strategy: str,
                       fewshot_feats_by_class) -> tuple:
    """Express a strategy's rank score as ``score[n] = X[n] . W[label[n]]``.

    Every ranked strategy reduces to a per-class vector:
      * T2T family / T2I: the class prompt mean (vs caption / image)
      * I2I / I2T: mean p2p similarity over few-shot exemplars == dot
        with the exemplars' MEAN embedding (linearity of the dot
        product), vs image / caption embeddings respectively
    Returns (W [C, D], X [N, D], C) with C = max label + 1.
    """
    d = pool.image_feats.shape[1]
    classes = pool.classes()
    C = max(classes) + 1

    P = np.zeros((C, d), np.float32)
    for c in classes:
        P[c] = np.asarray(prompt_tensors[str(c)]["mean"], np.float32)
    M = None
    if strategy in ("I2I-rank", "I2T-rank", "Random-I2I"):
        M = np.zeros((C, d), np.float32)
        for c in classes:
            M[c] = np.asarray(fewshot_feats_by_class[c],
                              np.float32).mean(axis=0)

    cap, img = pool.caption_feats, pool.image_feats
    if strategy in ("T2T-rank", "T2T-rank-T2I-tshd", "T2T-rank-I2T-tshd",
                    "T2T-rank-I2I-tshd"):
        return P, cap, C
    if strategy == "T2I-rank":
        return P, img, C
    if strategy == "I2I-rank":
        return M, img, C
    if strategy == "I2T-rank":
        return M, cap, C
    if strategy == "Random-I2I":
        return M, img, C   # the threshold gate's score; order is host rng
    if strategy == "Random":
        return P, img, C   # ditto (prompt.img gate when threshold != 0)
    raise NotImplementedError(strategy)


def _rowwise_scores(X, W, labels, chunk: int = 1 << 18,
                    device="cuda") -> np.ndarray:
    """score[n] = X[n] . W[labels[n]] in O(1) chunked device passes.  ``X``
    may be a tensor on ``device`` (uploaded once by the caller) or a host
    array, whose chunks upload one at a time (the corpus-scale streaming
    mode)."""
    w = torch.as_tensor(np.asarray(W, np.float32), device=device)
    ls = torch.as_tensor(np.asarray(labels), dtype=torch.long,
                         device=device)
    out = []
    for i in range(0, X.shape[0], chunk):
        x = R._f32(X[i:i + chunk], device)
        out.append(torch.einsum("nd,nd->n", x, w[ls[i:i + chunk]])
                   .cpu().numpy())
    return (np.concatenate(out) if out
            else np.empty(0, np.float32)).astype(np.float32)


def sample_retrieved_fused(
    pool: MinedPool,
    prompt_tensors: Dict[str, dict],
    strategy: str = "T2T-rank",
    num_samples: int = 500,
    threshold: float = 0.0,
    t2i_threshold: Optional[float] = None,
    fewshot_feats_by_class: Optional[Dict[int, np.ndarray]] = None,
    remove_duplicates: bool = False,
    zeroshot_filter_head: Optional[np.ndarray] = None,
    seed: int = 0,
    mesh=None,
    approx=False,
    rank_chunk: Optional[int] = None,
    device="cuda",
) -> Dict[str, list]:
    """Fused production sampler: ONE class-masked [C, N] product + top-k
    selects every class's kept candidates in O(1) device passes
    (rank.rank_candidates), with thresholds / dedup / zero-shot filters
    applied as batched masks BEFORE the top-k.  ``sample_retrieved`` above
    is the per-class oracle; the two select the same candidates in the same
    order.

    Random strategies keep host-rng ordering (identical draws to the
    oracle) over one fused threshold-gate pass."""
    if strategy not in STRATEGIES:
        raise NotImplementedError(f"strategy {strategy}")
    if t2i_threshold is None:
        t2i_threshold = AUX_THRESHOLD_DEFAULTS.get(strategy, 0.25)
    _check_fewshot(strategy, threshold, fewshot_feats_by_class,
                   pool.classes())

    labels = pool.labels
    n = labels.shape[0]
    random_strategy = strategy in ("Random", "Random-I2I")
    if random_strategy and threshold == 0:
        # reference random_sampler :621-628: gate sim is literally 1.0
        # (and the few-shot features are never touched)
        W = X = C = None
        score = np.ones(n, np.float32)
    else:
        W, X, C = _strategy_matrices(pool, prompt_tensors, strategy,
                                     fewshot_feats_by_class)
        # ONE upload of X, reused by the score pass and the ranking
        # product; with rank_chunk set (pools that do not fit the card) X
        # stays on the host and both passes stream it
        if rank_chunk is None:
            X = R._f32(X, device)
        score = _rowwise_scores(X, W, labels, device=device)

    t2i = None
    if strategy == "T2T-rank-T2I-tshd":
        # W is already the [C, D] prompt-mean matrix for the T2T family
        t2i = _rowwise_scores(pool.image_feats, W, labels, device=device)
    elif strategy == "T2T-rank-I2T-tshd":
        t2i = R.rowwise_p2p_scores(pool.caption_feats,
                                   fewshot_feats_by_class, labels, C, "max",
                                   device=device)
    elif strategy == "T2T-rank-I2I-tshd":
        t2i = R.rowwise_p2p_scores(pool.image_feats,
                                   fewshot_feats_by_class, labels, C, "max",
                                   device=device)

    dropped = np.zeros(n, bool)
    if remove_duplicates:
        # all classes in a few padded [G, M, M] masked pairwise passes
        dropped[R.near_duplicate_indices_by_class(
            pool.image_feats, labels, device=device)] = True
    if zeroshot_filter_head is not None:
        bad = R.zeroshot_misclassified(
            pool.image_feats, labels, zeroshot_filter_head, device=device)
        dropped[bad] = True

    keep = (score >= threshold) & ~dropped & np.isfinite(score)
    if t2i is not None:
        keep &= t2i >= t2i_threshold

    def info_line(gi):
        s = float(score[gi])
        return (f"{round(s, 4)}/{threshold}"
                + (f", {round(float(t2i[gi]), 4)}/{t2i_threshold}"
                   if t2i is not None else "")
                + f", {pool.file_paths[gi]}"
                + (f", {pool.captions[gi]}" if pool.captions else ""))

    out = {"file_list": [], "label_list": [], "score_list": [],
           "sampled_info": [], "filtered_info": [], "num_sampled": {}}

    if random_strategy:
        # host walk in random order over the fused gate scores: consumes
        # the rng identically to the oracle (one permutation per class,
        # class-sorted), so the outputs match exactly
        rng = np.random.default_rng(seed)
        for cls in pool.classes():
            idx = pool.class_indices(cls)
            if idx.size == 0:
                continue
            order = rng.permutation(idx.size)
            ct = 0
            for local_i in order:
                if ct == num_samples:
                    break
                gi = int(idx[local_i])
                if keep[gi]:
                    out["file_list"].append(pool.file_paths[gi])
                    out["label_list"].append(cls)
                    out["score_list"].append(float(score[gi]))
                    out["sampled_info"].append(info_line(gi))
                    ct += 1
                else:
                    out["filtered_info"].append(info_line(gi))
            out["num_sampled"][cls] = ct
        return out

    # the fused selection: class-masked product + top-k on the device
    cls_for_rank = np.where(keep, labels, -1).astype(np.int32)
    top_by_class, _ = R.rank_candidates(W, X, cls_for_rank, num_samples,
                                        mesh=mesh, approx=approx,
                                        chunk=rank_chunk, device=device)
    cutoff = np.full(C, -np.inf, np.float32)

    for cls in pool.classes():
        kept = [int(g) for g in top_by_class[cls] if g >= 0]
        for gi in kept:
            out["file_list"].append(pool.file_paths[gi])
            out["label_list"].append(cls)
            out["score_list"].append(float(score[gi]))
            out["sampled_info"].append(info_line(gi))
        out["num_sampled"][cls] = len(kept)
        if len(kept) == num_samples:
            cutoff[cls] = score[kept[-1]]

    # filtered_info = candidates the oracle walk would have encountered
    # before filling the quota: not kept AND outranking the class cutoff
    filt = ~keep & (score > cutoff[labels])
    fi = np.where(filt)[0]
    fi = fi[np.lexsort((-score[fi], labels[fi]))]
    out["filtered_info"] = [info_line(int(g)) for g in fi]
    return out


def group_fewshot_features(image_features: np.ndarray,
                           labels: np.ndarray) -> Dict[int, np.ndarray]:
    """Group a pre-extracted few-shot feature bundle by class (reference
    get_fewshot_features, sample_retrieval.py:997-1014, which loads the
    probing run's ``{ds}_..._train_features.pth``)."""
    labels = np.asarray(labels).reshape(-1)
    feats = np.asarray(image_features, np.float32)
    return {int(c): feats[labels == c] for c in np.unique(labels)}


def write_split_file(path: str, file_list: Sequence[str],
                     label_list: Sequence[int],
                     relative_to: Optional[str] = None):
    """``path label 0`` lines (reference save_sample_file_list,
    sample_retrieval.py:1457-1469; 0 = retrieved source flag)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for p, lbl in zip(file_list, label_list):
            if relative_to:
                p = os.path.relpath(p, relative_to)
            f.write(f"{p} {lbl} 0\n")


def write_debug_lists(output_dir: str, prefix: str, result: Dict[str, list]):
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, f"{prefix}_sampled_list.txt"),
              "w") as f:
        f.write("\n".join(result["sampled_info"]))
    with open(os.path.join(output_dir, f"{prefix}_filtered_list.txt"),
              "w") as f:
        f.write("\n".join(result["filtered_info"]))
