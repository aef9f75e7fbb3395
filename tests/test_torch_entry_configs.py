"""The train twin (`cocosnet_tpu_torch.cli.train`) on a configuration other
than ADE20k, against the JAX package's train.py, on the CPU at f32: the
celebahq configuration's training flags (maskmix, the direct mask loss,
--warp_bilinear, the cycle warp, --adaptor_kernel 4) at 64 px, ngf 8, ndf
8, batch 2, on a seeded synthetic CelebA-HQ tree of 4 training photos
(cocosnet_tpu_torch.data.synthetic), one epoch of two G steps.

Both run in this process from the same weights, drawn as
tests/test_torch_train.py draws them (so every layer carries signal) in
place of train.py's `init_all`, and loaded into the twin's nets with
cocosnet_tpu_torch.convert. Both loaders run on the calling
thread (--nThreads 0; --mesh_data 1 keeps train.py's batch of 2 on one
of the test session's 8 host devices), and the twin's takes one batch
before its loop as train.py's does to build its nets, so both loops see
the same batches
(tests/test_torch_data_configs.py holds the two loaders bit for bit). The
losses each logs (print_current_errors, recorded at full precision) after
step 1 at rel 2e-3 and after step 2 at rel 2e-2, the key sets equal, the
tolerances of tests/test_torch_train.py; both write the visual grid
(label, ref, warp, fake, real rows)."""

import importlib.util
import os

import numpy as np
import pytest
from PIL import Image

from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.utils import logging as JLOG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.cli import train as TTRAIN
from cocosnet_tpu_torch.convert import load_flax_variables
from cocosnet_tpu_torch.data import synthetic as SYN
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.ops import shift9 as S
from test_torch_threads import torch_threads  # noqa: F401
from test_torch_train import _jnp, _variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELEBAHQ_TRAIN = ["--use_attention", "--maskmix", "--warp_mask_losstype",
                  "direct", "--weight_mask", "100.0", "--PONO", "--PONO_C",
                  "--warp_bilinear", "--warp_cycle_w", "0.1",
                  "--which_perceptual", "4_2", "--weight_perceptual",
                  "0.001", "--fm_ratio", "1.0", "--adaptor_kernel", "4",
                  "--vgg_normal_correct"]


def _argv(base, root, tables, name):
    return ["--dataset_mode", "celebahq", "--dataroot", root,
            "--ref_table_dir", tables, "--name", name, "--batchSize", "2",
            "--crop_size", "64", "--load_size", "72", "--ngf", "8", "--ndf",
            "8", "--nThreads", "0", "--mesh_data", "1", "--compute_dtype",
            "f32", "--platform",
            "cpu", "--niter", "1", "--niter_decay", "0", "--print_freq",
            "2", "--display_freq", "4", "--save_epoch_freq", "1",
            "--checkpoints_dir", os.path.join(base, "ck"), "--output_dir",
            os.path.join(base, "out")] + CELEBAHQ_TRAIN


def _recorder(logged):
    def record(opt, epoch, i, errors, t):
        logged.append({k: float(v) for k, v in errors.items()
                       if k != "img/s"})
    return record


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX train.py's logged losses, the twin's, the twin's run record,
    the shift9 backward's plain calls in the twin, the output base)."""
    base = str(tmp_path_factory.mktemp("tentry_cfg"))
    root, tables = os.path.join(base, "celeb"), os.path.join(base, "tables")
    SYN.make_celebahq_tree(root, n_train=4, n_val=2, size=80, seed=1,
                           table_dir=tables)
    mp = pytest.MonkeyPatch()
    policy = TL.get_compute_dtype()
    try:
        jvars, jlogged = {}, []

        def drawn_init(self, rng, batch):
            jvars.update(_variables(self, self.opt))
            return _jnp(jvars)

        mp.setattr(JP.Pix2PixNets, "init_all", drawn_init)
        mp.setattr(JLOG, "print_current_errors", _recorder(jlogged))
        spec = importlib.util.spec_from_file_location(
            "jax_train_cli", os.path.join(ROOT, "train.py"))
        cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cli)
        mp.setattr("sys.argv", ["train.py"] + _argv(base, root, tables,
                                                    "jax"))
        cli.main()

        tlogged = []
        build = TP.Pix2PixNets

        def with_jax_weights(opt, device=None, seed=0):
            nets = build(opt, device=device, seed=seed)
            for name in ("gen", "corr", "disc", "vgg"):
                load_flax_variables(getattr(nets, name), jvars[name])
            return nets

        create = TTRAIN.create_dataloader

        def one_batch_ahead(opt, *shard):
            loader = create(opt, *shard)
            next(iter(loader))      # train.py's batch to build its nets
            return loader

        mp.setattr(TP, "Pix2PixNets", with_jax_weights)
        mp.setattr(TTRAIN, "create_dataloader", one_batch_ahead)
        mp.setattr(TTRAIN, "print_current_errors", _recorder(tlogged))
        calls = S.attend_shift9_backward.plain_calls
        run = TTRAIN.main(_argv(base, root, tables, "port"))
        calls = S.attend_shift9_backward.plain_calls - calls
    finally:
        mp.undo()
        TL.set_compute_dtype(policy)
    return jlogged, tlogged, run, calls, base


@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
def test_train_twin_losses_match_jax_train_py(runs, step, tol):
    jlogged, tlogged, *_ = runs
    assert len(jlogged) == len(tlogged) == 2
    want, got = jlogged[step], tlogged[step]
    assert set(got) == set(want)
    assert {"G_warp_cycle", "mask", "GAN"} <= set(got)
    for k, t in want.items():
        assert abs(got[k] - t) / (abs(t) + 1e-2) < tol, (k, step, t, got[k])


def test_train_twin_runs_the_column_warp(runs):
    """Two G steps, each running the shift9 backward for the row and the
    column warp; the last losses are the second step's."""
    _, tlogged, run, calls, _ = runs
    assert (run.g_steps, run.d_steps) == (2, 0) and calls == 4
    assert run.losses == pytest.approx(tlogged[1])


def test_train_twin_writes_the_grid_of_train_py(runs):
    """The grid after the second step: label colours, ref, warp, fake and
    real rows of 2 columns at 64 px, in both packages."""
    *_, base = runs
    for name in ("jax", "port"):
        grid = Image.open(os.path.join(base, "out", "training", name,
                                       "1_4.png"))
        assert grid.size == (128, 320)
        assert np.asarray(grid).std() > 0
