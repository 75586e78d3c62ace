"""The port's multi-process start-up and mesh helpers
(swat_tpu_torch/core/distributed.py, core/mesh.py; the counterpart of
tests/test_distributed.py): when ``maybe_initialize_distributed`` starts a
group and with which backend, ``process_local_slice``'s shards, the
row-major layout of ``create_multislice_mesh`` and its refusals, and
``rank_candidates`` on a 2-rank gloo mesh against the one-device ranking
and swat_tpu's, index for index, ties at the cutoff and across the ranks'
blocks included."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_multichip import _free_port, run_cluster
from torch_port_lib import TORCH_THREADS, make_dataset, rank_inputs

import torch_dist_worker as W
from swat_tpu.retrieval import rank as JR
from swat_tpu_torch.core import distributed as D
from swat_tpu_torch.core.mesh import Mesh, MeshSpec, create_mesh

torch.set_num_threads(TORCH_THREADS)

LAUNCHER = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
            "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCHER:
        monkeypatch.delenv(var, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_single_process_noop(no_launcher):
    assert D.maybe_initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert D.local_device("cuda") == torch.device("cuda")


def test_explicit_arguments_start_a_gloo_group(no_launcher):
    assert D.maybe_initialize_distributed(
        f"127.0.0.1:{_free_port()}", 1, 0, device="cpu") is True
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    # a second call finds the group started
    assert D.maybe_initialize_distributed(device="cpu") is True


def test_launcher_variables_start_a_group(no_launcher, monkeypatch):
    for var, value in (("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(_free_port())), ("RANK", "0"),
                       ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(var, value)
    assert D.launched()
    assert D.maybe_initialize_distributed(device="cpu") is True
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    # a mesh larger than the world runs on the ranks there are
    mesh = create_mesh(MeshSpec(4, 1))
    assert (mesh.data, mesh.model) == (1, 1)
    assert D.local_device("cuda") == torch.device("cuda", 0)


def test_cuda_device_picks_nccl(no_launcher, monkeypatch):
    calls = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.update(device=d))
    assert D.maybe_initialize_distributed("10.0.0.1:1234", 4, 2,
                                          device="cuda") is True
    assert calls == {"backend": "nccl", "init_method": "tcp://10.0.0.1:1234",
                     "world_size": 4, "rank": 2,
                     "device": torch.device("cuda")}


def _fake_world(monkeypatch, world, rank, groups):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: world)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: rank)

    def new_group(ranks):
        groups.append(tuple(ranks))
        return tuple(ranks)

    monkeypatch.setattr(dist, "new_group", new_group)


def test_process_local_slice_partitions_evenly(monkeypatch):
    covered = []
    for rank in range(4):
        _fake_world(monkeypatch, 4, rank, [])
        s = D.process_local_slice(100)
        assert s.stop - s.start == 25
        covered.extend(range(s.start, s.stop))
    assert covered == list(range(100))


def test_multislice_mesh_layout(monkeypatch):
    """2 nodes x 2 data ranks x 2 model ranks: the data axis spans the
    nodes, a model group is two consecutive ranks of one node."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    for rank in range(8):
        groups = []
        _fake_world(monkeypatch, 8, rank, groups)
        mesh = D.create_multislice_mesh(dcn_data=2, ici_data=2, ici_model=2)
        assert mesh.shape == {"data": 4, "model": 2}
        assert (mesh.data_rank, mesh.model_rank) == (rank // 2, rank % 2)
        assert mesh.data_group == tuple(range(rank % 2, 8, 2))
        assert mesh.model_group == (rank - rank % 2, rank - rank % 2 + 1)
        # every rank makes every group, in one order
        assert groups == [(0, 2, 4, 6), (1, 3, 5, 7), (0, 1), (2, 3),
                          (4, 5), (6, 7)]
    with pytest.raises(ValueError, match="needs 9 processes"):
        D.create_multislice_mesh(dcn_data=3, ici_data=3, ici_model=1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="span nodes"):
        D.create_multislice_mesh(dcn_data=4, ici_data=1, ici_model=2)


def test_mesh_rows_and_refusals():
    mesh = Mesh(4, 2, rank=5)
    assert (mesh.data_rank, mesh.model_rank) == (2, 1)
    assert mesh.rows(16) == slice(8, 12)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rows(10)


RANK_CASES = [dict(name=f"k{k}{'_chunk' if chunk else ''}", run="rank",
                   mesh=(2, 1), top_k=k, chunk=chunk)
              for k, chunk in ((3, None), (5, None), (7, None), (7, 16))]


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    prompts, cands, cls = rank_inputs()
    cases = [dict(c, prompts=prompts, cands=cands, cls=cls)
             for c in RANK_CASES]
    outs = run_cluster(cases, 2, str(tmp_path_factory.mktemp("rank")))
    return cases, outs


@pytest.mark.parametrize("i", range(len(RANK_CASES)),
                         ids=[c["name"] for c in RANK_CASES])
def test_rank_candidates_on_two_ranks(ranked, i):
    """Rows 3, 14, 15, 16 and 33 are copies in class 0 that tie at its 5th
    to 9th place, 33 in the second rank's block: the merge keeps the lower
    index first, as one device and swat_tpu do."""
    cases, outs = ranked
    case = cases[i]
    one = W.run_case(case, None)
    kw = {"chunk": case["chunk"]} if case["chunk"] else {}
    ref_idx, ref_sim = JR.rank_candidates(case["prompts"], case["cands"],
                                          case["cls"], case["top_k"], **kw)
    for out in outs:
        got = out[case["name"]]
        np.testing.assert_array_equal(got["idx"], one["idx"])
        np.testing.assert_array_equal(got["sim"], one["sim"])
        np.testing.assert_array_equal(got["idx"], ref_idx)
        np.testing.assert_allclose(got["sim"], ref_sim, atol=1e-6, rtol=0)
    if case["top_k"] >= 5:
        tied = [j for j in one["idx"][0] if j in (3, 14, 15, 16, 33)]
        assert tied == sorted(tied)


@pytest.mark.parametrize("mode", ["canvas", "host", "eval"])
def test_loaders_feed_each_rank_its_rows(tmp_path, mode):
    """Under a 2-rank mesh every rank's TrainLoader yields the one-device
    batches' labels, source and prompt rows whole and its own rows of the
    decoded keys (canvases and valid_hw, or host-augmented or eval images:
    the same seeds drawn for the whole batch); an EvalLoader's batches are
    padded to a multiple of the axis (a batch of 5 to 6), labels and mask
    whole, images the rank's rows."""
    from swat_tpu_torch.data.pipeline import LOCAL_KEYS, EvalLoader, TrainLoader
    from swat_tpu_torch.data.splits import read_split

    root = os.path.join(make_dataset(tmp_path, n_test_per_class=3),
                        "test3port")
    samples = read_split(root, (["test.txt"], [root]))
    tokens = {str(c): np.arange(6 * (c + 1)).reshape(-1, 2) + c
              for c in range(3)}

    def train(mesh):
        return list(TrainLoader(samples, batch_size=4, seed=3, mode=mode,
                                n_px=32, num_workers=1,
                                tokenized_prompts=tokens, mesh=mesh))

    one = train(None)
    ranks = [train(Mesh(2, 1, rank=r)) for r in range(2)]
    assert len(one) == 2
    for b, whole in enumerate(one):
        for key, value in whole.items():
            parts = [r[b][key] for r in ranks]
            if key in LOCAL_KEYS:
                np.testing.assert_array_equal(np.concatenate(parts), value)
            else:
                for part in parts:
                    np.testing.assert_array_equal(part, value)
    with pytest.raises(ValueError, match="not divisible"):
        TrainLoader(samples, batch_size=3, mesh=Mesh(2, 1))

    def evals(mesh):
        return list(EvalLoader(samples, batch_size=5, n_px=32,
                               num_workers=1, mesh=mesh))

    one = evals(None)
    ranks = [evals(Mesh(2, 1, rank=r)) for r in range(2)]
    for b, whole in enumerate(one):
        images = np.concatenate([r[b]["images"] for r in ranks])
        assert images.shape[0] == 6
        n = int(whole["mask"].sum())
        np.testing.assert_array_equal(images[:n], whole["images"][:n])
        assert not images[n:].any()
        for r in ranks:
            assert r[b]["mask"].sum() == n and len(r[b]["mask"]) == 6
            np.testing.assert_array_equal(r[b]["labels"][:5],
                                          whole["labels"])
