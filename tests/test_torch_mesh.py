"""The port's mesh (cocosnet_tpu_torch/mesh.py) and the data side of its
parallelism against the JAX package's: process_shard and the rank layout
against cocosnet_tpu.mesh, the process groups of a (data, model) job of
gloo workers, the loader's shards and eval-tail padding against JAX's
DataLoader at the same explicit process index and count (as
tests/test_multihost.py drives it), and what check_ported /
check_loop_ported take and refuse."""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import mesh as JM
from cocosnet_tpu.data import loader as JLD
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.cli import common as CM
from cocosnet_tpu_torch.data import loader as TLD
from cocosnet_tpu_torch.data import synthetic as SYN
from cocosnet_tpu_torch.train import steps as TST
from test_torch_threads import torch_threads  # noqa: F401
from torch_fixtures import mesh_worker, spawn_job


@pytest.mark.parametrize("batch,index,count", [
    (32, 0, 8), (32, 7, 8), (8, 1, 2), (6, 2, 3), (4, 0, 1)])
def test_process_shard_matches_jax(batch, index, count):
    assert M.process_shard(batch, index, count) == JM.process_shard(
        batch, index, count)


def test_process_shard_refuses_what_jax_refuses():
    for mod in (M, JM):
        with pytest.raises(ValueError, match="must be divisible"):
            mod.process_shard(10, 0, 4)


@pytest.mark.parametrize("data,model", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_rank_layout_is_jax_device_order(data, model):
    """Rank r of the port's mesh sits where device r sits in JAX's
    create_mesh over the same (data, model): rank = d * model + k."""
    import jax
    jmesh = JM.create_mesh(data=data, model=model,
                           devices=jax.devices()[:data * model])
    ids = {dev.id: i for i, dev in enumerate(jax.devices())}
    for d in range(data):
        for k in range(model):
            rank = ids[jmesh.devices[d, k].id]
            mesh = M.Mesh(data, model, rank)
            assert (mesh.data_rank, mesh.model_rank) == (d, k)


def test_one_process_mesh():
    """Without a job the mesh is one process, whatever data = 0 means."""
    mesh = M.create_mesh(0, 1)
    assert (mesh.data, mesh.model, mesh.rank) == (1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="needs 2 processes"):
        M.create_mesh(2, 1)
    with pytest.raises(ValueError, match="must divide"):
        M.create_mesh(0, 2)
    assert M.global_mesh().size == 1


def test_groups_of_a_two_by_two_job(tmp_path):
    """Four gloo workers as a 2 x 2 mesh: each rank's data group is every
    model-th rank, its model group its consecutive ranks, and gather_data
    concatenates in data-rank order."""
    spawn_job(mesh_worker, 4, tmp_path, 2, 2, str(tmp_path))
    for rank in range(4):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        d, k = divmod(rank, 2)
        assert (got["data_rank"], got["model_rank"]) == (d, k)
        assert got["over_data"] == k + (k + 2)
        assert got["over_model"] == 2 * d + (2 * d + 1)
        assert got["gathered"].tolist() == [k, k + 2]


@pytest.fixture(scope="module")
def ade_root():
    base = tempfile.mkdtemp(prefix="tmesh_")
    root = os.path.join(base, "ade")
    SYN.make_ade20k_tree(root, n_train=7, n_val=5, size=(96, 80),
                         n_classes=13, block=8)
    yield root
    shutil.rmtree(base, ignore_errors=True)


def _argv(root, is_train):
    return ["--dataset_mode", "ade20k", "--dataroot", root, "--label_nc",
            "20", "--batchSize", "4", "--crop_size", "64", "--nThreads",
            "0", "--seed", "3", "--load_size", "72" if is_train else "64"]


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("index", [0, 1])
def test_loader_shards_match_jax(ade_root, is_train, index):
    """A data rank's batches (random draws included: each rank's dataset
    draws for its own items from its own seeded generator) are JAX's
    DataLoader's for the same process index and count; in evaluation the
    ragged last batch is padded with wrap-around duplicates."""
    argv = _argv(ade_root, is_train)
    jopt = JCFG.parse_options(argv, is_train=is_train)
    topt = TCFG.parse_options(argv, is_train=is_train)
    jl = JLD.DataLoader(JLD_dataset(jopt), jopt, process_index=index,
                        process_count=2)
    tl = TLD.create_dataloader(topt, index, 2)
    assert len(tl) == len(jl)
    want, got = list(jl), list(tl)
    assert len(got) == len(want) == (1 if is_train else 2)
    for g, w in zip(got, want):
        assert g["path"] == w["path"] and len(g["path"]) == 2
        for k in ("label", "image", "ref", "label_ref", "self_ref"):
            assert np.array_equal(g[k], w[k]), k


def test_eval_tail_covers_every_photo(ade_root):
    """5 validation photos in global batches of 4 over 2 data ranks: the
    ragged second batch (one photo) is padded with the first three, so the
    ranks load 2 + 2 photos a batch and together every photo."""
    opt = TCFG.parse_options(_argv(ade_root, False), is_train=False)
    seen = []
    for index in (0, 1):
        batches = list(TLD.create_dataloader(opt, index, 2))
        assert [len(b["path"]) for b in batches] == [2, 2]
        seen += [p for b in batches for p in b["path"]]
    names = {p for p in os.listdir(os.path.join(ade_root, "validation"))
             if p.endswith(".jpg")}
    assert {os.path.basename(p) for p in seen} == names and len(names) == 5


def JLD_dataset(opt):
    """The JAX package's dataset of `opt` (its registry's lookup)."""
    return JLD.dataset_registry()[opt.dataset_mode](opt)


def test_check_ported_takes_the_mesh_flags():
    """--mesh_model, --mesh_data and --distributed are taken, with --D_cam
    and --steps_per_dispatch too; the model group's correlation refuses spatial centering at run
    time, as JAX's; an even match_kernel is refused."""
    base = dict(dataset_mode="ade20k", label_nc=5, crop_size=64,
                load_size=64, ngf=8, ndf=8, PONO=True, PONO_C=True,
                use_attention=True, maskmix=True,
                warp_mask_losstype="direct", isTrain=True)
    for kw in (dict(mesh_model=4), dict(mesh_data=2), dict(distributed=True),
               dict(mesh_model=2, match_kernel=1, PONO_C=False)):
        opt = TCFG.test_defaults(**dict(base, **kw))
        TP.check_ported(opt)
    # --steps_per_dispatch is taken: the chunked step builds (eager on the
    # CPU) and a job of one process may capture it
    opt = TCFG.test_defaults(**dict(base, steps_per_dispatch=2))
    TP.check_ported(opt)
    M.check_capturable()
    assert callable(TST.make_multi_train_step(TP.Pix2PixNets(opt,
                                                             device="cpu")))
    TP.check_ported(TCFG.test_defaults(**dict(base, D_cam=1.0)))
    with pytest.raises(NotImplementedError, match="match_kernel"):
        TP.check_ported(TCFG.test_defaults(**dict(base, match_kernel=2)))


def test_job_size_follows_the_mesh_flags():
    """Processes of the job and of this host: --mesh_data x --mesh_model
    (data 0: --mesh_model on the CPU, a host each under --distributed);
    the global batch must split over the data ranks; the test twin builds
    a mesh only when a flag exceeds 1."""
    def opt(**kw):
        return TCFG.test_defaults(platform="cpu", batchSize=4, **kw)
    assert CM.job_size(opt()) == (1, 1)
    assert CM.job_size(opt(mesh_data=2)) == (2, 2)
    assert CM.job_size(opt(mesh_model=2)) == (2, 2)
    assert CM.job_size(opt(mesh_data=2, mesh_model=2)) == (4, 4)
    host = dict(distributed=True, num_processes=2, process_id=1,
                coordinator_address="localhost:1")
    assert CM.job_size(opt(mesh_data=4, **host)) == (4, 2)
    assert CM.job_size(opt(), all_devices=False) == (1, 1)
    with pytest.raises(ValueError, match="must be divisible"):
        CM.job_size(opt(mesh_data=3))
    with pytest.raises(ValueError, match="does not split"):
        CM.job_size(opt(mesh_data=3, **host))
    with pytest.raises(ValueError, match="coordinator_address"):
        CM.job_size(opt(mesh_data=4, distributed=True, num_processes=2))


def test_distributed_needs_its_address():
    opt = TCFG.test_defaults(distributed=True)
    with pytest.raises(ValueError, match="coordinator_address"):
        M.maybe_init_distributed(opt, torch.device("cpu"))
    assert M.world() == (0, 1)
    assert M.backend_for(torch.device("cpu")) == "gloo"
    assert M.backend_for(torch.device("cuda")) == "nccl"
