"""The port's entry points on the CPU at 64 px (ngf 8, ndf 8, label_nc 12,
batch 2, f32):

- make_d_step against the JAX package's make_d_step from the same weights
  (JAX variables converted with cocosnet_tpu_torch.convert) on the same
  batch and fake: the D losses at rel 2e-3 and D's updated parameters and
  spectral u/v, the tolerances tests/test_torch_train.py holds the fused
  step to;
- the train twin (`cocosnet_tpu_torch.cli.train`) with --platform cpu on a
  synthetic ADE20k tree for one epoch of two iterations under
  --D_steps_per_G 2 (a G step, then a D-only step on its fake), then
  --continue_train for a second epoch from iter.txt and state_latest;
- the test twin (`cocosnet_tpu_torch.cli.test`) with --platform cpu
  --compute_dtype f32 on the saved state, and on a checkpoint the port
  wrote with weights at unit signal scale, beside the JAX package's
  test.py on the same tree and the same weights (the port's
  state_<label>/net_{G,Corr}.pth copied to <label>_net_{G,Corr}.pth in a
  checkpoints directory of their own, which test.py reads through its
  torch path): the grids differ by at most 1 level of 255 per pixel;
- the options the twins refuse."""

import importlib.util
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.train import state as JS
from cocosnet_tpu.train import steps as JST
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.cli import test as TTEST
from cocosnet_tpu_torch.cli import train as TTRAIN
from cocosnet_tpu_torch.convert import flax_path, load_flax_variables
from cocosnet_tpu_torch.data import synthetic as SYN
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.ops import shift9 as S
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_threads import torch_threads  # noqa: F401
from torch_fixtures import condition, jit_quick
from test_torch_train import OPT, _batch, _jnp, _variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_policy():
    """The twins set the port's process-wide conv policy; restore it."""
    prev = TL.get_compute_dtype()
    yield
    TL.set_compute_dtype(prev)


def _rel(got, want):
    return abs(got - want) / (abs(want) + 1e-2)


def test_d_step_matches_jax():
    jopt = JCFG.test_defaults(**OPT)
    topt = TCFG.test_defaults(**OPT)
    jnets = JP.Pix2PixNets(jopt)
    variables = _variables(jnets, jopt)
    batch = _batch()
    fake = (np.random.RandomState(5).rand(2, 64, 64, 3) * 2 - 1).astype(
        np.float32)
    lr = JS.lrs_for_epoch(jopt, 1)

    jstate = JS.create_train_state(jopt, _jnp(variables),
                                   jax.random.PRNGKey(1))
    args = (jstate, _jnp(batch), jnp.asarray(lr), jnp.asarray(fake))
    jstate, jlosses = jit_quick(JST.make_d_step(jnets), *args)(*args)
    jdisc = jax.tree.map(np.asarray, jstate.variables["disc"])

    tnets = TP.Pix2PixNets(topt, device="cpu")
    for name in ("gen", "corr", "disc", "vgg"):
        load_flax_variables(getattr(tnets, name), variables[name])
    tstate = TS.create_train_state(topt, tnets)
    p0 = {k: v.clone() for k, v in tnets.disc.state_dict().items()}
    g0 = {k: v.clone() for k, v in tnets.gen.state_dict().items()}
    calls = S.attend_shift9_backward.plain_calls
    losses = TST.make_d_step(tnets)(tstate, batch, lr, torch.from_numpy(fake))

    assert set(losses) == set(jlosses) == {"D_Fake", "D_real"}
    for k, v in losses.items():
        assert _rel(float(v), float(jlosses[k])) < 2e-3, k
    assert tstate.step == int(jstate.step) == 1
    assert S.attend_shift9_backward.plain_calls == calls
    sd = tnets.disc.state_dict()
    num = den = 0.0
    for name, v in sd.items():
        collection, path, kind = flax_path(name, v.dim())
        want = jdisc[collection]
        for p in path:
            want = want[p]
        if kind == "hwio":
            want = np.transpose(want, (3, 2, 0, 1))
        want = want.reshape(tuple(v.shape))
        if collection == "spectral":
            # advanced once, from the drawn u/v, in both packages
            np.testing.assert_allclose(v.numpy(), want, atol=2e-5)
            assert not torch.equal(v, p0[name]), name
            continue
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(v.numpy(), want, atol=2e-3 * scale)
        move, want_move = v - p0[name], want - p0[name].numpy()
        num += float(((move.numpy() - want_move) ** 2).sum())
        den += float((want_move ** 2).sum())
    # the Adam moves themselves (about lr_D per element) agree in L2
    assert den > 0 and (num / den) ** 0.5 < 2e-3, (num / den) ** 0.5
    # G and Corr are not touched by a D-only step
    for k, v in tnets.gen.state_dict().items():
        assert torch.equal(v, g0[k]), k


# ------------------------------------------------------------- the twins

@pytest.fixture(scope="module")
def tree():
    base = tempfile.mkdtemp(prefix="tentry_")
    root = os.path.join(base, "ade")
    SYN.make_ade20k_tree(root, n_train=4, n_val=4, size=(80, 72),
                         n_classes=13, block=8)
    yield base, root
    shutil.rmtree(base, ignore_errors=True)


def _flags(base, root):
    return ["--dataset_mode", "ade20k", "--dataroot", root, "--label_nc",
            "12", "--batchSize", "2", "--crop_size", "64", "--ngf", "8",
            "--use_attention", "--maskmix", "--warp_mask_losstype", "direct",
            "--PONO", "--PONO_C", "--compute_dtype", "f32", "--nThreads",
            "2", "--checkpoints_dir", os.path.join(base, "ck"), "--name",
            "entry"]


def _train_flags(base, root):
    return _flags(base, root) + [
        "--platform", "cpu", "--load_size", "72", "--ndf", "8",
        "--weight_mask", "100.0", "--use_ema", "--vgg_normal_correct",
        "--niter", "1", "--niter_decay", "0", "--D_steps_per_G", "2",
        "--save_epoch_freq", "1", "--print_freq", "2", "--display_freq", "2",
        "--output_dir", os.path.join(base, "out")]


@pytest.fixture(scope="module")
def trained(tree):
    """The train twin's first run, its continued run, and the shift9
    backward's plain calls in each."""
    base, root = tree
    calls = []
    runs = []
    for extra in ([], ["--continue_train", "--niter", "2"]):
        n = S.attend_shift9_backward.plain_calls
        runs.append(TTRAIN.main(_train_flags(base, root) + extra))
        calls.append(S.attend_shift9_backward.plain_calls - n)
    return runs, calls


def test_train_twin_runs_g_and_d_only_steps(tree, trained):
    base, _ = tree
    (first, _), (calls, _) = trained[0], trained[1]
    ck = os.path.join(base, "ck", "entry")
    assert (first.g_steps, first.d_steps) == (1, 1)
    assert calls == first.g_steps  # one shift9 backward per G step only
    assert first.state.step == 2
    assert set(first.losses) == {"D_Fake", "D_real"}  # the D-only step's
    assert all(np.isfinite(v) for v in first.losses.values())
    for d in ("state_latest", "state_1"):
        assert set(os.listdir(os.path.join(ck, d))) == {
            *C.NET_FILES.values(), *C.EMA_FILES.values(), C.OPTIMIZER_FILE}
    assert TCFG.load_options(os.path.join(ck, "opt.json")).D_steps_per_G == 2
    with open(os.path.join(ck, "loss_log.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("(epoch: 1, iters: 2,") and "GAN:" in lines[0]
    assert "img/s:" in lines[0]
    # the G step's visual grid (display_freq 2): label, ref, warp, fake,
    # real rows of 2 columns at 64 px
    grid = Image.open(os.path.join(base, "out", "training", "entry",
                                   "1_2.png"))
    assert grid.size == (128, 320)


def test_train_twin_continues_from_iter_txt(tree, trained, capsys):
    base, _ = tree
    (first, second), (_, calls) = trained
    ck = os.path.join(base, "ck", "entry")
    assert (second.g_steps, second.d_steps) == (1, 1) and calls == 1
    # resumed at epoch 2 from state_latest: the step counter goes on
    assert second.state.step == 4
    with open(os.path.join(ck, "iter.txt")) as f:
        assert f.read().split() == ["3", "0"]
    assert os.path.isdir(os.path.join(ck, "state_2"))
    with open(os.path.join(ck, "loss_log.txt")) as f:
        assert any(line.startswith("(epoch: 2,") for line in f)


def test_test_twin_runs_on_the_saved_state(tree, trained, capsys):
    base, root = tree
    run = TTEST.main(_flags(base, root) + [
        "--platform", "cpu", "--load_size", "64", "--output_dir",
        os.path.join(base, "out")])
    assert "state_latest/net_G.pth" in capsys.readouterr().out
    assert (run.images, run.batches) == (4, 2)
    second = trained[0][1]
    for k, v in run.nets.gen.state_dict().items():
        assert torch.equal(v, second.nets.gen.state_dict()[k]), k
    for i in range(2):
        grid = Image.open(os.path.join(base, "out", "test", "entry",
                                       f"{i}.png"))
        assert grid.size == (128, 192)


def _run_jax_test_py(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_test_cli", os.path.join(ROOT, "test.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr("sys.argv", ["test.py"] + argv)
    cli.main()


def test_test_twin_matches_jax_test_py(tree, trained, monkeypatch):
    """Weights at unit signal scale (so the fakes are far from flat),
    saved by the port; the port's twin and JAX's test.py write the same
    grids to within 1 level."""
    base, root = tree
    opt = TCFG.parse_options(_train_flags(base, root), is_train=True)
    nets = TP.Pix2PixNets(opt, device="cpu")
    state = TS.create_train_state(opt, nets)
    C.load_state(opt, state, nets, "latest")
    condition(nets.gen, 11)
    condition(nets.corr, 12)
    path = C.save_state(opt, state, nets, "cond")
    jck = os.path.join(base, "jax_ck", "entry")
    os.makedirs(jck)
    for net in ("G", "Corr"):
        shutil.copy(os.path.join(path, f"net_{net}.pth"),
                    os.path.join(jck, f"cond_net_{net}.pth"))
    common = _flags(base, root) + ["--load_size", "64", "--which_epoch",
                                   "cond"]
    TTEST.main(common + ["--platform", "cpu", "--output_dir",
                         os.path.join(base, "port_out")])
    jargs = [a if a != os.path.join(base, "ck") else
             os.path.join(base, "jax_ck") for a in common]
    _run_jax_test_py(jargs + ["--output_dir", os.path.join(base, "jax_out")],
                     monkeypatch)
    for i in range(2):
        got = np.asarray(Image.open(os.path.join(
            base, "port_out", "test", "entry", f"{i}.png")), np.int32)
        want = np.asarray(Image.open(os.path.join(
            base, "jax_out", "test", "entry", f"{i}.png")), np.int32)
        assert got.shape == want.shape == (192, 128, 3)
        assert np.abs(got - want).max() <= 1
        fake = want[128:]
        assert fake.std() > 10  # the fake row is not flat


def test_twins_refuse_what_they_do_not_run(tree):
    base, root = tree
    flags = _train_flags(base, root)
    # --steps_per_dispatch is taken (tests/test_torch_multi_step.py runs
    # it): the option parses, and the run's chunked step builds
    opt = TTRAIN.parse(flags + ["--steps_per_dispatch", "2"])
    assert opt.steps_per_dispatch == 2
    assert callable(TST.make_multi_train_step(TP.Pix2PixNets(opt,
                                                             device="cpu")))
    for extra, err, match in (
            # the mesh flags are taken: a mesh the global batch does not
            # split over, or --distributed without its address, is refused
            (["--mesh_data", "3"], ValueError, "must be divisible"),
            (["--distributed"], ValueError, "coordinator_address"),
            (["--platform", "tpu"], SystemExit, "tpu")):
        with pytest.raises(err, match=match):
            TTRAIN.main(flags + extra)
    test_flags = _flags(base, root) + ["--platform", "cpu", "--name",
                                       "absent"]
    with pytest.raises(SystemExit, match="No checkpoint found"):
        TTEST.main(test_flags)
    # the test twin ignores --steps_per_dispatch, as test.py does, and the
    # nets build
    run = TTEST.main(test_flags + ["--allow_random_weights", "--how_many",
                                   "2", "--save_per_img", "--output_dir",
                                   os.path.join(base, "rnd"),
                                   "--steps_per_dispatch", "2"])
    assert run.batches == 1
    assert sorted(os.listdir(os.path.join(base, "rnd", "test_per_img",
                                          "absent"))) == [
        "ADE_val_00000001.jpg", "ADE_val_00000002.jpg"]
    TP.Pix2PixNets(run.nets.opt.replace(steps_per_dispatch=2,
                                        distributed=True, mesh_data=2),
                   device="cpu")
