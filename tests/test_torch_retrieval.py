"""The port's retrieval ranking and samplers (swat_tpu_torch.retrieval.rank
and .sampler, on the CPU) against swat_tpu's on the same seeded inputs.

Every input lies on a dyadic grid (multiples of 2^-8, few-shot exemplars of
2^-6) small enough that each fp32 product and sum here is exact in either
framework, whatever its summation order: both packages compute the same
scores bit for bit, so exact duplicate rows tie exactly, and the ties are
real.  Each test also asserts that any two of its scores either tie
exactly or lie more than 1e-5 apart, and that no score lies within 1e-5 of
a gate, so that equal outputs are not luck.  Tolerance: indices, split
files and debug lines equal; scores within 1e-6."""

import numpy as np
import pytest
import torch
from torch_port_lib import (TORCH_THREADS, gapped_pool, grid, rank_inputs,
                            reference_pool)

from swat_tpu.retrieval import rank as JR
from swat_tpu.retrieval import sampler as JS
from swat_tpu_torch.core.mesh import Mesh
from swat_tpu_torch.retrieval import rank as R
from swat_tpu_torch.retrieval import sampler as S

torch.set_num_threads(TORCH_THREADS)

MARGIN = 1e-5
SCORE_ATOL = 1e-6
CPU = "cpu"


def assert_separated(values, gates=()):
    """Any two values tie exactly or lie more than MARGIN apart; none lies
    within MARGIN of a gate."""
    v = np.unique(np.asarray(values, np.float64).reshape(-1))
    v = v[np.isfinite(v)]
    if v.size > 1:
        assert np.diff(v).min() > MARGIN
    for g in gates:
        assert np.abs(v - g).min() > MARGIN, g


# ---------------------------------------------------------------------------
# rank


@pytest.mark.parametrize("top_k", [3, 5, 7])
@pytest.mark.parametrize("mode", ["dense", "chunked", "approx",
                                  "chunked_approx", "auto_chunked"])
def test_rank_candidates_matches_swat_tpu(mode, top_k, monkeypatch):
    prompts, cands, cls = rank_inputs()
    sims = prompts @ cands.T
    assert_separated(sims)
    # the five copies tie in class 0 after four others: its k-th place at
    # 5 and 7 falls among them
    order = np.sort(sims[0][cls == 0])[::-1]
    assert (order[4:9] == order[4]).all() and order[3] > order[4]
    # chunks of 16 meet the copies' edge at 16; of 24, a short last chunk
    kw = ({"chunk": 16 if mode == "chunked" else 24}
          if mode.startswith("chunked") else {})
    if "approx" in mode:
        kw["approx"] = True
    if mode == "auto_chunked":   # C * N past the dense limit in both
        for mod in (R, JR):
            monkeypatch.setattr(mod, "MAX_DENSE_ELEMS", 64)
    ref_idx, ref_sim = JR.rank_candidates(prompts, cands, cls, top_k, **kw)
    idx, sim = R.rank_candidates(prompts, cands, cls, top_k, device=CPU,
                                 **kw)
    assert idx.dtype == np.int32 and sim.dtype == np.float32
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(sim, ref_sim, atol=SCORE_ATOL, rtol=0)
    # the lower index first among the tied copies
    tied = [i for i in idx[0] if i in (3, 14, 15, 16, 33)]
    assert tied == sorted(tied) and len(tied) == min(5, max(0, top_k - 4))


def test_rank_candidates_masked_rows_and_mesh():
    """Classes with fewer candidates than k pad with -1 / -inf, as
    swat_tpu's; a one-rank mesh ranks as no mesh (a 2-rank mesh:
    tests/test_torch_distributed.py)."""
    prompts, cands, cls = rank_inputs(seed=1)
    assert np.bincount(cls).min() < 20
    for chunk in (None, 24):      # a last chunk of 16 rows, fewer than k
        idx, sim = R.rank_candidates(prompts, cands, cls, 20, chunk=chunk,
                                     device=CPU)
        ref_idx, ref_sim = JR.rank_candidates(prompts, cands, cls, 20,
                                              chunk=chunk)
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(sim, ref_sim)
        assert (idx == -1).any() and np.isneginf(sim[idx == -1]).all()
    for chunk in (None, 24):
        got = R.rank_candidates(prompts, cands, cls, 20, chunk=chunk,
                                mesh=Mesh(1, 1), device=CPU)
        ref = R.rank_candidates(prompts, cands, cls, 20, chunk=chunk,
                                device=CPU)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_select_keys_order_negative_zero_as_xla():
    """-0.0 ranks below +0.0 (IEEE total order), as XLA's top_k puts it;
    -inf entries decode to index -1."""
    sims = torch.tensor([[0.0, -0.0, 0.0, -0.0, -np.inf]])
    top_sim, top_idx = R._from_keys(R._select_top(sims, torch.arange(5), 5))
    ref_sim, ref_idx = JR._select_top(sims.numpy(), 5, False)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(np.signbit(top_sim.numpy()),
                                  np.signbit(np.asarray(ref_sim)))


@pytest.mark.parametrize("mode", ["min", "max", "mean"])
def test_rowwise_p2p_scores_match_swat_tpu(mode):
    rng = np.random.default_rng(2)
    d = 8
    labels = np.array([0] * 6 + [2] * 5 + [3] * 4, np.int32)
    emb = grid(rng.normal(size=(len(labels), d)) / 4)
    # ragged exemplar counts, and a class (5) absent from the pool
    fs = {c: grid(rng.normal(size=(k, d)) / 4, 2.0 ** -6)
          for c, k in ((0, 4), (2, 1), (3, 2), (5, 4))}
    got = R.rowwise_p2p_scores(emb, fs, labels, 4, mode, chunk=7,
                               device=CPU)
    ref = JR.rowwise_p2p_scores(emb, fs, labels, 4, mode, chunk=7)
    assert_separated(ref)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=SCORE_ATOL, rtol=0)
    for c in (0, 2, 3):
        one = R.i2i_similarity_p2p(fs[c], emb[labels == c], mode, CPU)
        np.testing.assert_allclose(
            one, JR.i2i_similarity_p2p(fs[c], emb[labels == c], mode),
            atol=SCORE_ATOL, rtol=0)


def dup_inputs():
    """Unit rows with engineered near-duplicates: in-class (dropped) and
    across classes (kept), in ragged, gapped classes."""
    rng = np.random.default_rng(3)
    labels = np.concatenate([np.full(9, 0), np.full(5, 3), np.full(1, 4),
                             np.full(12, 7)]).astype(np.int32)
    emb = grid(rng.normal(size=(len(labels), 16)) / 4)
    emb[3] = emb[1]
    emb[20] = emb[16]
    emb[20, 0] += 2.0 ** -8
    emb[15] = emb[2]                       # class 4 copy of class 0: kept
    emb = grid(emb / np.linalg.norm(emb, axis=1, keepdims=True))
    return emb, labels


def test_near_duplicates_match_swat_tpu():
    emb, labels = dup_inputs()
    sims = emb @ emb.T
    assert_separated(sims, gates=[0.9])
    ref = JR.near_duplicate_indices_by_class(emb, labels)
    assert 3 in ref and 20 in ref and 15 not in ref
    for max_elems in (1 << 27, 12 * 12):    # one pass; a class a pass
        got = R.near_duplicate_indices_by_class(emb, labels,
                                                max_elems=max_elems,
                                                device=CPU)
        np.testing.assert_array_equal(got, ref)
    for block in (4096, 5):
        np.testing.assert_array_equal(
            R.near_duplicate_indices(emb, block=block, device=CPU),
            JR.near_duplicate_indices(emb, block=block))


def test_zeroshot_misclassified_matches_swat_tpu():
    emb, labels = dup_inputs()
    head = grid(np.random.default_rng(4).normal(size=(8, 16)) / 4)
    logits = emb @ head.T
    assert_separated(logits)
    got = R.zeroshot_misclassified(emb, labels, head, batch=10, device=CPU)
    ref = JR.zeroshot_misclassified(emb, labels, head, batch=10)
    np.testing.assert_array_equal(got, ref)
    assert 0 < len(got) < len(labels)


# ---------------------------------------------------------------------------
# samplers


POOLS = {"reference": (reference_pool, dict(num_samples=7, threshold=0.005,
                                             t2i_threshold=0.3, seed=5)),
         "gapped": (gapped_pool, dict(num_samples=5, threshold=-0.1,
                                      t2i_threshold=0.1, seed=2))}


def _scores(arrays, prompts, fs):
    """Every score and gate value any strategy computes on the pool, in
    float64: prompt.caption, prompt.image, the exemplars' mean and max
    against images and captions, and the exemplar mean's."""
    _, labels, img, cap = arrays
    out = []
    for k in np.unique(labels):
        m = labels == k
        p = np.asarray(prompts[str(k)]["mean"], np.float64)
        e = np.asarray(fs[int(k)], np.float64)
        for x in (img[m].astype(np.float64), cap[m].astype(np.float64)):
            sims = x @ e.T
            out += [x @ p, sims.mean(1), sims.max(1), x @ e.mean(0)]
    return np.concatenate(out)


def _pools(name):
    make, kw = POOLS[name]
    arrays, prompts, fs = make()
    captions = [f"caption {i}" for i in range(len(arrays[0]))]
    pools = (S.MinedPool(*arrays, captions=captions),
             JS.MinedPool(*arrays, captions=captions))
    return pools, prompts, fs, kw, arrays


def _assert_same(got, ref):
    for key in ("file_list", "label_list", "num_sampled", "sampled_info",
                "filtered_info"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["score_list"], ref["score_list"],
                               atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("engine", ["fused", "per-class"])
@pytest.mark.parametrize("strategy", S.STRATEGIES)
@pytest.mark.parametrize("pool_name", sorted(POOLS))
def test_samplers_match_swat_tpu(pool_name, strategy, engine):
    (pool, jax_pool), prompts, fs, kw, arrays = _pools(pool_name)
    assert_separated(_scores(arrays, prompts, fs),
                     gates=[kw["threshold"], kw["t2i_threshold"]])
    kw = dict(kw, fewshot_feats_by_class=fs)
    ours = (S.sample_retrieved_fused if engine == "fused"
            else S.sample_retrieved)
    theirs = (JS.sample_retrieved_fused if engine == "fused"
              else JS.sample_retrieved)
    got = ours(pool, prompts, strategy, device=CPU, **kw)
    ref = theirs(jax_pool, prompts, strategy, **kw)
    _assert_same(got, ref)
    assert len(got["file_list"]) > 0


@pytest.mark.parametrize("engine", ["fused", "per-class"])
def test_samplers_with_filters_match_swat_tpu(engine):
    """Dedup (the copies at 33 and 38 of 30 go) and the zero-shot filter as
    masks, with the T2I aux gate."""
    (pool, jax_pool), prompts, fs, kw, arrays = _pools("reference")
    head = np.stack([prompts[str(c)]["mean"] for c in range(3)])
    img = arrays[2]
    assert_separated(np.concatenate([(img @ img.T).ravel(),
                                     (img @ head.T).ravel()]), gates=[0.9])
    kw = dict(kw, remove_duplicates=True, zeroshot_filter_head=head,
              num_samples=10)
    ours = (S.sample_retrieved_fused if engine == "fused"
            else S.sample_retrieved)
    theirs = (JS.sample_retrieved_fused if engine == "fused"
              else JS.sample_retrieved)
    got = ours(pool, prompts, "T2T-rank-T2I-tshd", device=CPU, **kw)
    ref = theirs(jax_pool, prompts, "T2T-rank-T2I-tshd", **kw)
    _assert_same(got, ref)
    assert not {"/pool/1/00013.jpg", "/pool/1/00018.jpg"} & set(
        got["file_list"])


def test_fused_sampler_chunked_and_streamed():
    """rank_chunk (X stays on the host, each chunk uploads on its own)
    selects what the dense pass selects, as in swat_tpu."""
    (pool, jax_pool), prompts, fs, kw, _ = _pools("reference")
    kw = dict(kw, fewshot_feats_by_class=fs)
    got = S.sample_retrieved_fused(pool, prompts, "I2T-rank", rank_chunk=7,
                                   device=CPU, **kw)
    ref = JS.sample_retrieved_fused(jax_pool, prompts, "I2T-rank",
                                    rank_chunk=7, **kw)
    _assert_same(got, ref)
    dense = S.sample_retrieved_fused(pool, prompts, "I2T-rank", device=CPU,
                                     **kw)
    assert got["file_list"] == dense["file_list"]


def test_missing_fewshot_features_raise_as_swat_tpu():
    (pool, _), prompts, fs, _, _ = _pools("gapped")
    for engine in (S.sample_retrieved, S.sample_retrieved_fused):
        with pytest.raises(ValueError, match="fewshot"):
            engine(pool, prompts, "I2I-rank", num_samples=3, device=CPU)
        with pytest.raises(ValueError, match=r"class\(es\) \[2\]"):
            engine(pool, prompts, "I2T-rank", num_samples=3, device=CPU,
                   fewshot_feats_by_class={0: fs[0], 4: fs[4]})
    with pytest.raises(ValueError, match="fewshot"):
        S.sample_retrieved_fused(pool, prompts, "I2I-rank", num_samples=3,
                                 mesh=Mesh(1, 1), device=CPU)


def test_split_and_debug_files_byte_equal(tmp_path):
    """The I2I gate at its default 0.65 filters some candidates."""
    (pool, jax_pool), prompts, fs, kw, arrays = _pools("reference")
    assert_separated(_scores(arrays, prompts, fs), gates=[0.005, 0.65])
    kw = dict(kw, fewshot_feats_by_class=fs, t2i_threshold=None)
    for pkg, mod, p in (("port", S, pool), ("jax", JS, jax_pool)):
        extra = {"device": CPU} if pkg == "port" else {}
        res = mod.sample_retrieved_fused(p, prompts, "T2T-rank-I2I-tshd",
                                         **kw, **extra)
        mod.write_split_file(str(tmp_path / pkg / "T2T.txt"),
                             res["file_list"], res["label_list"],
                             relative_to="/pool")
        mod.write_debug_lists(str(tmp_path / pkg), "T2T", res)
    for name in ("T2T.txt", "T2T_sampled_list.txt", "T2T_filtered_list.txt"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes() and got, name
    groups = S.group_fewshot_features(np.eye(4, 3), np.array([1, 0, 1, 2]))
    ref = JS.group_fewshot_features(np.eye(4, 3), np.array([1, 0, 1, 2]))
    assert sorted(groups) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(groups[k], ref[k])


@pytest.mark.parametrize("engine", ["fused", "per-class"])
def test_tie_at_the_cutoff_filtered_lines_as_swat_tpu(engine):
    """Candidate 1 ties the class's cutoff (0.25) and fails the T2I gate: the
    per-class walk meets it before the quota fills and lists it as
    filtered, the fused engine lists only candidates that outrank the
    cutoff strictly; the port keeps both engines' lines as swat_tpu's."""
    e = np.eye(4, dtype=np.float32)
    cap = np.stack([0.5 * e[0]] + [0.25 * e[0]] * 4 + [0.125 * e[0]])
    img = np.stack([e[0], 0.125 * e[1]] + [e[0]] * 4)
    files = [f"/{i}.jpg" for i in range(6)]
    prompts = {"0": {"mean": e[0]}}
    kw = dict(num_samples=3, t2i_threshold=0.5)
    assert_separated(cap @ e[0], gates=[0.0])
    assert_separated(img @ e[0], gates=[0.5])
    labels = np.zeros(6, np.int32)
    ours = (S.sample_retrieved_fused if engine == "fused"
            else S.sample_retrieved)
    theirs = (JS.sample_retrieved_fused if engine == "fused"
              else JS.sample_retrieved)
    got = ours(S.MinedPool(files, labels, img, cap), prompts,
               "T2T-rank-T2I-tshd", device=CPU, **kw)
    ref = theirs(JS.MinedPool(files, labels, img, cap), prompts,
                 "T2T-rank-T2I-tshd", **kw)
    _assert_same(got, ref)
    assert got["file_list"] == ["/0.jpg", "/2.jpg", "/3.jpg"]
    assert len(got["filtered_info"]) == (engine == "per-class")
