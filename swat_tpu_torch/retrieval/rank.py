"""Embedding ranking: the retrieval pipeline's compute core (counterpart of
``swat_tpu/retrieval/rank.py``).

The reference ranks per class with small GPU matmuls in a python loop
(reference retrieval/sample_retrieval.py:335-416,724-771).  Here ranking is
one class-masked ``[C, N]`` fp32 product plus a per-class top-k over the
whole pool, streamed in candidate chunks through a running ``[C, top_k]``
carry once the dense matrix would pass ``MAX_DENSE_ELEMS``.

Every function takes host arrays (or tensors) and an explicit ``device``
and returns numpy.  Every product is full fp32 (``swat_tpu``'s
``precision="highest"``): callers keep TF32 off
(``core.precision.Precision.apply_backend_flags``), or a near-gate score
may cross its threshold.

Top-k order is ``jax.lax.top_k``'s: value descending, and among equal
values the lower candidate index first, at the k-th boundary too.
``torch.topk`` promises no order among ties, so the selection runs on one
int64 key a candidate (the value's order-preserving bits above, the
reversed index below), which no two candidates share.

Departures from ``swat_tpu``: ``approx=True`` / ``"auto"`` take the exact
path (``jax.lax.approx_max_k`` has no torch counterpart; exact is what it
re-ranks to whenever its shortlist holds the true top-k, and on the CPU
``swat_tpu``'s is exact too).

Under a data-parallel mesh (``mesh=``, ``core/mesh.py``) each rank ranks
its contiguous block of candidates, when the data axis divides N, into a
per-class top-k of keys carrying global indices; the ranks' ``[C, top_k]``
keys are all-gathered and merged by one more top-k under the same key, so
ties at the cutoff fall as in the one-device ranking.  When the axis does
not divide N every rank ranks the whole pool, as ``swat_tpu`` leaves it
unsharded (``rank.py:245-248``).  The chunked path streams its block
through the running merge inside each rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swat_tpu_torch.core.mesh import active

# Dense [C, N] similarity matrices beyond this many elements (1 GiB f32)
# switch to the chunked streaming merge
MAX_DENSE_ELEMS = 256 * 1024 * 1024

# the low half of a selection key: INDEX_SPAN - 1 - index, so that the
# lower index ranks first; indices run from -1 (padding) to 2^31 - 2
_INDEX_SPAN = 1 << 31


def _f32(x, device) -> torch.Tensor:
    """A host array or a tensor -> an fp32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _sim(embeddings, exemplars, device) -> torch.Tensor:
    """[N, D] x [P, D] -> [N, P] fp32."""
    return torch.matmul(_f32(embeddings, device), _f32(exemplars, device).T)


def t2t_similarity(class_prompts, caption_embeddings,
                   device="cuda") -> np.ndarray:
    """[P, D] x [N, D] -> [N]; mean over prompts when P > 1 (reference
    t2t_similarity, sample_retrieval.py:397-416)."""
    sim = _sim(caption_embeddings, class_prompts, device)
    if sim.ndim > 1 and sim.shape[-1] > 1:
        sim = sim.mean(dim=-1)
    return sim.cpu().numpy().reshape(-1)


def t2i_similarity(class_prompts, image_embeddings,
                   device="cuda") -> np.ndarray:
    """Same product against image embeddings (sample_retrieval.py:335-353)."""
    return t2t_similarity(class_prompts, image_embeddings, device)


def i2i_similarity(fewshot_embeddings, image_embeddings,
                   device="cuda") -> np.ndarray:
    """Mean similarity to the few-shot exemplars
    (sample_retrieval.py:356-394)."""
    sim = _sim(image_embeddings, fewshot_embeddings, device)
    return sim.mean(dim=-1).cpu().numpy().reshape(-1)


def i2i_similarity_p2p(fewshot_embeddings, embeddings, mode: str = "mean",
                       device="cuda") -> np.ndarray:
    """Point-to-point exemplar similarity, reduced min/max/mean over the
    few-shot set (reference i2i_similarity_p2p, sample_retrieval.py:
    369-394).  ``embeddings`` may be image OR caption embeddings."""
    sim = _sim(embeddings, fewshot_embeddings, device)
    if mode == "min":
        out = sim.amin(dim=-1)
    elif mode == "max":
        out = sim.amax(dim=-1)
    elif mode == "mean":
        out = sim.mean(dim=-1)
    else:
        raise ValueError(f"Invalid mode {mode!r}")
    return out.cpu().numpy().reshape(-1)


# ---------------------------------------------------------------------------
# batched whole-dataset ranking


def _p2p_rowwise(x, fs, counts, ls, mode: str) -> torch.Tensor:
    # x [n, D], fs [C, Kmax, D] (zero-padded), counts [C], ls [n]
    sims = torch.einsum("nd,nkd->nk", x, fs[ls])
    valid = (torch.arange(fs.shape[1], device=x.device)[None, :]
             < counts[ls][:, None])
    if mode == "max":
        return sims.masked_fill(~valid, -torch.inf).amax(dim=-1)
    if mode == "min":
        return sims.masked_fill(~valid, torch.inf).amin(dim=-1)
    return (sims.masked_fill(~valid, 0.0).sum(dim=-1)
            / counts[ls].clamp(min=1))


def rowwise_p2p_scores(embeddings, fewshot_by_class: Dict[int, np.ndarray],
                       labels, num_classes: int, mode: str = "max",
                       chunk: int = 1 << 17, device="cuda") -> np.ndarray:
    """Fused form of per-class ``i2i_similarity_p2p``: score[n] =
    reduce_mode(sim(embeddings[n], exemplar) for exemplars of class
    labels[n]) in O(1) chunked device passes.  Variable exemplar counts
    become fixed shapes via zero-padding + a count mask."""
    if mode not in ("min", "max", "mean"):
        raise ValueError(f"Invalid mode {mode!r}")
    d = embeddings.shape[1]
    kmax = max((np.asarray(v).shape[0] for v in fewshot_by_class.values()),
               default=1)
    fs = np.zeros((num_classes, kmax, d), np.float32)
    counts = np.zeros(num_classes, np.int32)
    for c, v in fewshot_by_class.items():
        if c >= num_classes:   # class absent from the candidate pool
            continue
        v = np.asarray(v, np.float32)
        fs[c, : v.shape[0]] = v
        counts[c] = v.shape[0]

    fs_d = torch.from_numpy(fs).to(device)
    counts_d = torch.from_numpy(counts).to(device)
    ls = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    out = []
    for i in range(0, embeddings.shape[0], chunk):
        out.append(_p2p_rowwise(_f32(embeddings[i: i + chunk], device),
                                fs_d, counts_d, ls[i: i + chunk],
                                mode).cpu().numpy())
    return (np.concatenate(out) if out
            else np.empty(0, np.float32)).astype(np.float32)


def _masked_sims(prompts, cands, cls_ids, num_classes) -> torch.Tensor:
    sims = torch.matmul(prompts, cands.T)
    mask = (cls_ids[None, :]
            == torch.arange(num_classes, device=cls_ids.device)[:, None])
    return sims.masked_fill_(~mask, -torch.inf)


def _keys(sims: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """One int64 a candidate ordered as (value, -index): the fp32 value's
    bits made order-preserving as a signed int above (IEEE total order,
    -0.0 below +0.0, as XLA's top_k orders them), INDEX_SPAN - 1 - index
    below."""
    bits = sims.view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return ((bits.to(torch.int64) << 32)
            | (_INDEX_SPAN - 1 - index.to(torch.int64)))


def _from_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``_keys`` -> (values fp32, indices int32), indices
    -1 where the value is -inf."""
    bits = (keys >> 32).to(torch.int32)
    sims = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).view(torch.float32)
    index = (_INDEX_SPAN - 1 - (keys & 0xFFFFFFFF)).to(torch.int32)
    return sims, torch.where(torch.isfinite(sims), index, -1)


def _select_top(sims: torch.Tensor, index: torch.Tensor,
                top_k: int) -> torch.Tensor:
    """The top_k keys of each row of [C, n] scores whose candidates carry
    global indices ``index`` ([n] or [C, n]), in ``jax.lax.top_k``'s order
    (value descending, lower index first among equal values)."""
    return torch.topk(_keys(sims, index), top_k, dim=1).values


def rank_candidates(prompt_matrix, candidate_embeddings, candidate_class,
                    top_k: int, mesh=None, approx=False,
                    chunk: Optional[int] = None, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One fused pass over ALL classes' candidates.

    prompt_matrix:       [C, D]  (per-class mean prompt embeddings)
    candidate_embeddings:[N, D]  (caption or image embeddings; numpy, or a
                                  tensor already on ``device``)
    candidate_class:     [N]     class id per candidate
    approx: accepted as in ``swat_tpu`` (False, True or "auto"); every mode
    ranks exactly here (module docstring).
    chunk: stream candidates through a running per-class top-k merge in
    chunks of this many rows, bounding device memory at [C, chunk]
    instead of [C, N]; auto-engages when C*N exceeds MAX_DENSE_ELEMS.
    mesh: a data-parallel mesh; each rank ranks its block of candidates
    and the blocks' top-k are merged (module docstring).
    Returns (top_idx [C, top_k] indices into N, top_sim [C, top_k]);
    entries beyond a class's candidate count hold -1 / -inf.
    """
    del approx   # exact in every mode
    C = prompt_matrix.shape[0]
    N = candidate_embeddings.shape[0]
    if chunk is None and C * N > MAX_DENSE_ELEMS:
        chunk = max(top_k, (MAX_DENSE_ELEMS // max(C, 1)) // 1024 * 1024
                    or 1024)
    mesh = active(mesh)
    classes = np.asarray(candidate_class, np.int32)
    if mesh is not None and N % mesh.data == 0:
        mine = mesh.rows(N)
        keys = _top_keys(prompt_matrix, candidate_embeddings[mine],
                         classes[mine], top_k, chunk, device,
                         offset=mine.start, pad=True)
        every = mesh.gather(keys[None])            # [data, C, top_k]
        keys = torch.topk(every.permute(1, 0, 2).reshape(C, -1), top_k,
                          dim=1).values
    else:
        keys = _top_keys(prompt_matrix, candidate_embeddings, classes,
                         top_k, chunk, device)
    top_sim, top_idx = _from_keys(keys)
    return top_idx.cpu().numpy(), top_sim.cpu().numpy()


def _padding_keys(rows: int, k: int, device) -> torch.Tensor:
    """Keys that rank below every candidate (-inf, index -1)."""
    return _keys(torch.full((rows, k), -torch.inf, device=device),
                 torch.full((k,), -1, device=device))


def _top_keys(prompt_matrix, candidate_embeddings, classes: np.ndarray,
              top_k: int, chunk: Optional[int], device, offset: int = 0,
              pad: bool = False) -> torch.Tensor:
    """The per-class top-k keys [C, top_k] of candidates whose global
    indices start at ``offset``: one dense pass, or the chunked merge when
    ``chunk`` is set; ``pad``: fill a block of fewer than top_k candidates
    with padding keys (a dense pass over the whole pool needs top_k <= N,
    as ``jax.lax.top_k`` does)."""
    C = prompt_matrix.shape[0]
    if chunk is not None:
        return _chunked_keys(prompt_matrix, candidate_embeddings, classes,
                             top_k, int(chunk), device, offset)
    n = candidate_embeddings.shape[0]
    cls = torch.as_tensor(classes, dtype=torch.int32, device=device)
    sims = _masked_sims(_f32(prompt_matrix, device),
                        _f32(candidate_embeddings, device), cls, C)
    index = torch.arange(offset, offset + n, device=sims.device)
    if not pad or n >= top_k:
        return _select_top(sims, index, top_k)
    return torch.cat([_select_top(sims, index, n),
                      _padding_keys(C, top_k - n, sims.device)], dim=1)


def _chunked_keys(prompt_matrix, candidate_embeddings, classes: np.ndarray,
                  top_k: int, chunk: int, device, offset: int = 0
                  ) -> torch.Tensor:
    """Streaming per-class top-k: fold candidate chunks into a running
    [C, top_k] carry of keys.  The carry comes before the chunk, and its
    keys hold global indices, so an earlier candidate wins a tie as in the
    dense pass.  (``swat_tpu`` pads the short last chunk with class -1 rows
    for one compile; a masked row never enters the top-k, so the port takes
    the chunk as it is.)"""
    C = prompt_matrix.shape[0]
    N = candidate_embeddings.shape[0]
    prompts = _f32(prompt_matrix, device)
    carry = _padding_keys(C, top_k, prompts.device)
    for b in range(0, N, chunk):
        cands = _f32(candidate_embeddings[b: b + chunk], device)
        cls = torch.from_numpy(classes[b: b + chunk]).to(device)
        sims = _masked_sims(prompts, cands, cls, C)
        index = torch.arange(offset + b, offset + b + cands.shape[0],
                             dtype=torch.int32, device=prompts.device)
        chunk_top = _select_top(sims, index, min(top_k, cands.shape[0]))
        carry = torch.topk(torch.cat([carry, chunk_top], dim=1), top_k,
                           dim=1).values
    return carry


def _block_pair(a, b, ia: int, ib: int, threshold: float) -> torch.Tensor:
    sims = torch.matmul(a, b.T)
    rows = ia + torch.arange(a.shape[0], device=a.device)[:, None]
    cols = ib + torch.arange(b.shape[0], device=a.device)[None, :]
    hit = (sims > threshold) & (rows < cols)
    return hit.any(dim=0)


def near_duplicate_indices(embeddings, threshold: float = 0.9,
                           block: int = 4096, device="cuda") -> np.ndarray:
    """Indices j to drop where sim(i, j) > threshold for some i < j
    (reference remove_near_duplicates2, sample_retrieval.py:237-275),
    computed in blocks so the NxN matrix never materializes."""
    n = embeddings.shape[0]
    emb = _f32(embeddings, device)
    drop = np.zeros(n, bool)
    for jb in range(0, n, block):
        b = emb[jb: jb + block]
        col_hit = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
        for ib in range(0, min(jb + block, n), block):
            col_hit |= _block_pair(emb[ib: ib + block], b, ib, jb,
                                   threshold)
        drop[jb: jb + b.shape[0]] |= col_hit.cpu().numpy()
    return np.where(drop)[0]


def _class_dup(feats, valid, threshold: float) -> torch.Tensor:
    # feats [G, M, D], valid [G, M] -> drop [G, M]: within each class,
    # drop local j where sim(i, j) > threshold for some valid i < j
    # (padding rows are invalid and never match)
    sims = torch.einsum("gmd,gnd->gmn", feats, feats)
    m = feats.shape[1]
    ar = torch.arange(m, device=feats.device)
    tri = ar[:, None] < ar[None, :]
    hit = ((sims > threshold) & tri & valid[:, :, None]
           & valid[:, None, :])
    return hit.any(dim=1)


def near_duplicate_indices_by_class(embeddings, labels,
                                    threshold: float = 0.9,
                                    max_elems: int = 1 << 27,
                                    device="cuda") -> np.ndarray:
    """Fused per-class near-dup detection for the production sampler: all
    classes padded to the max class size and swept in a few [G, M, M]
    masked pairwise passes (ceil(C/G) of them, not one per class).

    Within-class local order is ascending global index, identical to the
    per-class oracle (``MinedPool.class_indices`` returns ascending
    positions).  Returns global indices to drop."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    if n == 0:
        return np.empty(0, np.int64)
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.flatnonzero(np.r_[True, sorted_labels[1:]
                                  != sorted_labels[:-1]])
    ends = np.r_[starts[1:], n]
    counts = ends - starts
    m = int(counts.max())
    c = len(starts)

    # padded gather map [C, M] of global indices (-1 = padding)
    gather = np.full((c, m), -1, np.int64)
    for ci, (s, e) in enumerate(zip(starts, ends)):
        gather[ci, : e - s] = order[s:e]

    g = max(1, min(c, max_elems // max(m * m, 1)))
    emb = _f32(embeddings, device)
    drop_global = []
    for b in range(0, c, g):
        chunk = torch.from_numpy(gather[b: b + g]).to(emb.device)
        valid = chunk >= 0
        feats = emb[chunk.clamp(min=0)] * valid[..., None]
        drop = _class_dup(feats, valid, float(threshold))
        drop_global.append(chunk[drop & valid].cpu().numpy())
    return np.sort(np.concatenate(drop_global))


def zeroshot_misclassified(embeddings, labels, head, batch: int = 8192,
                           device="cuda") -> np.ndarray:
    """Indices whose zero-shot prediction != label (reference
    zeroshot_clip_img_filter, sample_retrieval.py:278-329)."""
    hd = _f32(head, device)
    preds = []
    for i in range(0, embeddings.shape[0], batch):
        x = _f32(embeddings[i: i + batch], device)
        preds.append(torch.argmax(torch.matmul(x, hd.T), dim=-1)
                     .cpu().numpy())
    preds = np.concatenate(preds) if preds else np.empty(0, np.int64)
    return np.where(preds != np.asarray(labels))[0]
