"""Data and spatial parallelism of the port's steps and twins, in gloo
worker processes on the CPU, against one process on the same weights and
the same global batch.

- data 2: one flagship G+D train step (make_train_step) with the global
  batch of 2 shared over two data ranks, each net's gradients averaged
  over the ranks before its Adam step, against one process at batch 2.
  The batch's self_ref is [1, 0], so the batch-coupled terms (the feature
  matching weights, the mask loss's weight sum) read global denominators.
  Bounds: every loss at rel 2e-3 with |t| + 1e-2 below, as
  tests/test_torch_train.py holds one port step to JAX's, and the fake of
  each rank's shard at 2e-4;
- model 2: the correlation's query rows shared over two ranks (the shift9
  core at nq = N / 2 against N keys, its plain versions here), inference
  and one train step with the cycle warp (its column warp shares its rows
  too), at tests/test_mesh_model.py's bounds: the fake at atol 2e-4 / rtol
  1e-4, losses rtol 2e-2 / atol 5e-3, parameters after the step rtol 2e-2
  / atol 5e-4 (tau = 0.01 amplifies the reduction order 100x in the
  logits);
- the train twin at --mesh_data 2 for 2 steps writes the single process's
  loss log (its 3 printed decimals; the second step at rel 2e-2), and the
  test twin at --mesh_model 2 the single process's
  images (on flags whose items need no random draw: each data rank's
  dataset draws for its own items, as the JAX package's hosts do).
"""

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch.cli import test as TTEST
from cocosnet_tpu_torch.cli import train as TTRAIN
from cocosnet_tpu_torch.data import synthetic as SYN
from test_torch_threads import torch_threads  # noqa: F401
from torch_fixtures import parallel_step, spawn_job, step_worker

BASE = dict(dataset_mode="ade20k", label_nc=5, contain_dontcare_label=True,
            crop_size=64, load_size=64, batchSize=2, ngf=8, ndf=8,
            PONO=True, PONO_C=True, vgg_normal_correct=True,
            use_attention=True, maskmix=True, warp_mask_losstype="direct",
            weight_mask=50.0, use_ema=True, isTrain=True)
TRAIN = TCFG.test_defaults(**BASE)
CYCLE = TCFG.test_defaults(**dict(BASE, warp_cycle_w=1.0))
INFER = TCFG.test_defaults(**dict(BASE, isTrain=False))
LOSS_KEYS = ["no_vgg_feat", "GAN", "GAN_Feat", "fm", "perc", "contextual",
             "mask", "D_Fake", "D_real"]


def _batch():
    rs = np.random.RandomState(3)
    b, h = 2, 64
    return {
        "label": rs.randint(0, 6, (b, h, h, 1)).astype(np.float32),
        "image": (rs.rand(b, h, h, 3) * 2 - 1).astype(np.float32),
        "ref": (rs.rand(b, h, h, 3) * 2 - 1).astype(np.float32),
        "label_ref": rs.randint(0, 6, (b, h, h, 1)).astype(np.float32),
        "self_ref": np.asarray([1.0, 0.0], np.float32),
    }


def _job(tmp, data, model, opts):
    spawn_job(step_worker, data * model, tmp, data, model,
              [o.replace(mesh_data=data, mesh_model=model) for o in opts],
              _batch(), str(tmp))
    return [torch.load(tmp / f"rank{r}.pt") for r in range(data * model)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"one": [single-process results], "data": [per rank], "model": [per
    rank]}: TRAIN, then (model only) INFER and CYCLE."""
    M.set_global_mesh(None)
    one = [parallel_step(o, _batch()) for o in (TRAIN, INFER, CYCLE)]
    return {"one": one,
            "data": _job(tmp_path_factory.mktemp("data"), 2, 1, [TRAIN]),
            "model": _job(tmp_path_factory.mktemp("model"), 1, 2,
                          [TRAIN, INFER, CYCLE])}


def _rel(got, want):
    return abs(got - want) / (abs(want) + 1e-2)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_data_parallel_losses(runs, key):
    want = runs["one"][0]["losses"][key]
    for rank in runs["data"]:
        got = rank[0]["losses"][key]
        assert _rel(got, want) <= 2e-3, (key, got, want)


def test_data_parallel_fakes_and_parameters(runs):
    """Each rank's fake is its shard of the single process's, and every
    rank ends the step with the same parameters, the single process's."""
    one = runs["one"][0]
    for d, rank in enumerate(runs["data"]):
        np.testing.assert_allclose(rank[0]["fake"].numpy(),
                                   one["fake"][d:d + 1].numpy(), atol=2e-4)
    first = runs["data"][0][0]["params"]
    for net, params in first.items():
        for name, p in params.items():
            assert torch.equal(runs["data"][1][0]["params"][net][name], p)
            np.testing.assert_allclose(p.numpy(),
                                       one["params"][net][name].numpy(),
                                       rtol=2e-2, atol=5e-4,
                                       err_msg=f"{net}.{name}")


def test_model_parallel_inference(runs):
    want = runs["one"][1]["fake"].numpy()
    for rank in runs["model"]:
        np.testing.assert_allclose(rank[1]["fake"].numpy(), want,
                                   atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("which", [0, 2], ids=["direct", "cycle"])
def test_model_parallel_train_step(runs, which):
    one = runs["one"][which]
    for rank in runs["model"]:
        got = rank[which]
        assert set(got["losses"]) == set(one["losses"])
        for k, want in one["losses"].items():
            np.testing.assert_allclose(got["losses"][k], want, rtol=2e-2,
                                       atol=5e-3, err_msg=k)
        for net, params in one["params"].items():
            for name, p in params.items():
                np.testing.assert_allclose(
                    got["params"][net][name].numpy(), p.numpy(), rtol=2e-2,
                    atol=5e-4, err_msg=f"{net}.{name}")
    a, b = (r[which]["params"] for r in runs["model"])
    assert all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


# ------------------------------------------------------------ the twins

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("twins")
    root = str(base / "ade")
    SYN.make_ade20k_tree(root, n_train=4, n_val=4, size=(80, 64),
                         n_classes=6, block=8)
    return base, root


def _flags(root):
    # crop = load, no flip and the table's first exemplar: items without
    # random draws
    return ["--dataset_mode", "ade20k", "--dataroot", root, "--label_nc",
            "5", "--batchSize", "2", "--crop_size", "64", "--load_size",
            "64", "--no_flip", "--ngf", "8", "--use_attention", "--maskmix",
            "--warp_mask_losstype", "direct", "--PONO", "--PONO_C",
            "--platform", "cpu", "--compute_dtype", "f32", "--nThreads",
            "1"]


def _losses(path):
    """[{term: value}] of each line of a loss_log.txt, its img/s (host
    time) left out."""
    out = []
    with open(path) as f:
        for line in f:
            losses = line.split(")")[-1].split("img/s")[0]
            out.append({k: float(v) for k, v in
                        re.findall(r"(\w+): (-?[\d.]+)", losses)})
    return out


def test_train_twin_data_parallel_writes_the_loss_log(tree):
    base, root = tree
    flags = _flags(root) + [
        "--ndf", "8", "--niter", "1", "--niter_decay", "0",
        "--real_reference_probability", "1", "--hard_reference_probability",
        "0", "--weight_mask", "100.0", "--use_ema", "--print_freq", "2",
        "--display_freq", "4", "--name", "t"]
    logs = []
    for tag, extra in (("one", []), ("data", ["--mesh_data", "2"])):
        run = TTRAIN.main(flags + ["--checkpoints_dir", str(base / tag),
                                   "--output_dir", str(base / f"{tag}_out")]
                          + extra)
        assert (run is None) == bool(extra)
        logs.append(_losses(base / tag / "t" / "loss_log.txt"))
        assert os.path.exists(base / tag / "t" / "state_latest")
        assert os.listdir(base / f"{tag}_out" / "training" / "t")
    one, data = logs
    assert len(one) == len(data) == 2
    # the first step's losses at rel 2e-3 and the second's (after one Adam
    # update) at 2e-2, as tests/test_torch_train.py holds them; the log
    # prints 3 decimals, so one unit of its last digit passes too
    for a, b, tol in zip(data, one, (2e-3, 2e-2)):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-3 or _rel(a[k], b[k]) <= tol, (
                k, a[k], b[k])


def test_test_twin_model_parallel_writes_the_images(tree):
    base, root = tree
    flags = _flags(root) + ["--name", "s", "--allow_random_weights",
                            "--checkpoints_dir", str(base / "none")]
    for tag, extra in (("one", []), ("model", ["--mesh_model", "2"]),
                       ("data", ["--mesh_data", "2"])):
        TTEST.main(flags + ["--output_dir", str(base / f"t_{tag}")] + extra)
    names = sorted(os.listdir(base / "t_one" / "test" / "s"))
    assert names == ["0.png", "1.png"]
    for tag in ("model", "data"):
        assert sorted(os.listdir(base / f"t_{tag}" / "test" / "s")) == names
        for n in names:
            want = np.asarray(Image.open(base / "t_one" / "test" / "s" / n),
                              np.int32)
            got = np.asarray(Image.open(base / f"t_{tag}" / "test" / "s" / n),
                             np.int32)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1, (tag, n)
