"""The port's checkpoints (train/checkpoints.py) on the CPU at 64 px (ngf 8,
ndf 8, label_nc 12, batch 2, f32): a save / load round trip is bit for bit
(every net's parameters and spectral u/v, the EMA shadows, both Adam
states and the step, so a resumed step equals the uninterrupted one), the
two-rename swap leaves no side directory and a leftover state_<label>.old
loads, the reference's flat <label>_net_*.pth files load (a mismatched one
through the tolerant strict=False path, which prints its keys), and a
checkpoint the port wrote is read by the JAX package: its net_G.pth and
net_Corr.pth through tools/convert_weights.convert_generator /
convert_corr, after which JAX's make_inference_step gives the port's
make_inference_step output within 5e-4 (the slice tolerance of
tests/test_torch_model.py)."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.train import steps as JST
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_threads import torch_threads  # noqa: F401
from torch_fixtures import condition
from tools.convert_weights import convert_corr, convert_generator

OPT = dict(dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
           crop_size=64, load_size=64, batchSize=2, ngf=8, ndf=8,
           use_attention=True, maskmix=True, PONO=True, PONO_C=True,
           warp_mask_losstype="direct", weight_mask=100.0,
           vgg_normal_correct=True, compute_dtype="f32")
B, H = 2, 64


def batch(seed=0, nc=13):
    rs = np.random.RandomState(seed)
    return {
        "label": rs.randint(0, nc, (B, H, H, 1)).astype(np.float32),
        "image": (rs.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
        "ref": (rs.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
        "label_ref": rs.randint(0, nc, (B, H, H, 1)).astype(np.float32),
        "self_ref": np.asarray([1.0, 0.0], np.float32),
    }


def _train(tmp_path, seed, use_ema=True, **kw):
    opt = TCFG.test_defaults(**OPT, isTrain=True, use_ema=use_ema,
                             checkpoints_dir=str(tmp_path), name="ck", **kw)
    nets = TP.Pix2PixNets(opt, device="cpu", seed=seed)
    return opt, nets, TS.create_train_state(opt, nets)


def _snapshot(nets, state):
    out = {f"{n}.{k}": v.clone() for n in ("gen", "corr", "disc")
           for k, v in getattr(nets, n).state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in state.ema.items()})
    for side in ("opt_g", "opt_d"):
        for i, st in getattr(state, side).state_dict()["state"].items():
            out.update({f"{side}.{i}.{k}": torch.as_tensor(v).clone()
                        for k, v in st.items()})
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A state one step in, saved as state_1, and its snapshot."""
    tmp = tmp_path_factory.mktemp("ck")
    opt, nets, state = _train(tmp, seed=0)
    lr = TS.lrs_for_epoch(opt, 1)
    TST.make_train_step(nets)(state, batch(), lr)
    C.save_state(opt, state, nets, "1")
    return tmp, opt, nets, state, _snapshot(nets, state)


def test_save_load_roundtrip_is_bitwise(trained):
    tmp, opt, nets, state, want = trained
    _, nets2, state2 = _train(tmp, seed=5)
    assert C.load_state(opt, state2, nets2, "1").endswith("state_1")
    got = _snapshot(nets2, state2)
    assert got.keys() == want.keys()
    assert any(k.endswith("weight_u") for k in got)
    assert any(k.startswith("opt_d.") and k.endswith("exp_avg_sq")
               for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert state2.step == state.step == 1


def test_resumed_step_equals_the_uninterrupted_one(trained):
    """One more G+D step and one D-only step from the loaded state give the
    same bits from nets of another seed. (The frozen VGG is not part of a
    checkpoint: it loads from --vgg_weights, here the fixture's.)"""
    tmp, opt, trained_nets, _, _ = trained
    lr = TS.lrs_for_epoch(opt, 1)
    runs = []
    for seed in (0, 7):
        _, nets, state = _train(tmp, seed=seed)
        C.load_state(opt, state, nets, "1")
        nets.vgg.load_state_dict(trained_nets.vgg.state_dict())
        losses, vis = TST.make_train_step(nets)(state, batch(1), lr)
        d = TST.make_d_step(nets)(state, batch(2), lr, vis["fake_image"])
        runs.append(({**losses, **d}, _snapshot(nets, state), state.step))
    (la, sa, na), (lb, sb, nb) = runs
    assert na == nb == 3
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_swap_leaves_no_side_directory_and_old_loads(trained, capsys):
    tmp, opt, nets, state, want = trained
    C.save_state(opt, state, nets, "swap")
    C.save_state(opt, state, nets, "swap")
    names = sorted(os.listdir(tmp / "ck"))
    assert "state_swap" in names
    assert not [n for n in names if n.endswith((".new", ".old"))]
    assert sorted(os.listdir(tmp / "ck" / "state_swap")) == sorted(
        ["net_G.pth", "net_Corr.pth", "net_D.pth", "net_G_ema.pth",
         "net_netCorr_ema.pth", "optimizer.pth"])
    # a crash between the two renames leaves only state_<label>.old
    os.rename(tmp / "ck" / "state_swap", tmp / "ck" / "state_swap.old")
    _, nets2, state2 = _train(tmp, seed=3)
    assert C.load_state(opt, state2, nets2, "swap").endswith(".old")
    assert "falling back" in capsys.readouterr().out
    got = _snapshot(nets2, state2)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    iopt = opt.replace(isTrain=False, use_ema=False)
    inf = TP.Pix2PixNets(iopt, device="cpu", seed=4)
    assert "state_swap.old" in C.load_inference(iopt, inf, "swap")
    for k, v in inf.corr.state_dict().items():
        assert torch.equal(v, want[f"corr.{k}"]), k
    with pytest.raises(FileNotFoundError):
        C.load_state(opt, state2, nets2, "absent")
    # a checkpoint without EMA files (trained without --use_ema) loads
    # nothing into a run with EMA: the run starts fresh, not half-loaded
    os.remove(tmp / "ck" / "state_swap.old" / "net_G_ema.pth")
    _, nets3, state3 = _train(tmp, seed=3)
    before = _snapshot(nets3, state3)
    with pytest.raises(FileNotFoundError, match="net_G_ema.pth"):
        C.load_state(opt, state3, nets3, "swap")
    after = _snapshot(nets3, state3)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert C.load_inference(iopt, inf, "absent") is None


@pytest.mark.parametrize("use_ema", [False, True])
def test_load_inference_takes_ema_under_use_ema(trained, use_ema):
    tmp, opt, nets, state, _ = trained
    inf = TP.Pix2PixNets(opt.replace(isTrain=False, use_ema=use_ema),
                         device="cpu", seed=4)
    C.load_inference(inf.opt, inf, "1")
    want = (TS.ema_state_dicts(state, nets) if use_ema else
            {"gen": nets.gen.state_dict(), "corr": nets.corr.state_dict()})
    for name in ("gen", "corr"):
        for k, v in getattr(inf, name).state_dict().items():
            assert torch.equal(v, want[name][k]), (name, k)
    # the EMA shadows moved off the parameters in the step
    ema = TS.ema_state_dicts(state, nets)["gen"]
    assert any(not torch.equal(ema[k], v)
               for k, v in nets.gen.state_dict().items())


def test_reference_flat_files_load(trained, capsys):
    """<label>_net_G.pth / <label>_net_Corr.pth (and the _ema files under
    --use_ema) load strictly; a file with a key too many and one missing
    loads through strict=False, which prints both."""
    tmp, opt, nets, state, _ = trained
    flat = tmp / "flat"
    os.makedirs(flat / "ck")
    sd_g, sd_c = nets.gen.state_dict(), nets.corr.state_dict()
    torch.save(sd_g, flat / "ck" / "9_net_G.pth")
    torch.save(sd_c, flat / "ck" / "9_net_Corr.pth")
    ema = TS.ema_state_dicts(state, nets)
    torch.save(ema["gen"], flat / "ck" / "9_net_G_ema.pth")
    torch.save(ema["corr"], flat / "ck" / "9_net_netCorr_ema.pth")
    for use_ema in (False, True):
        fopt = opt.replace(checkpoints_dir=str(flat), isTrain=False,
                           use_ema=use_ema)
        inf = TP.Pix2PixNets(fopt, device="cpu", seed=4)
        assert "9_net_G" + ("_ema" if use_ema else "") in \
            C.load_inference(fopt, inf, "9")
        want = ema if use_ema else {"gen": sd_g, "corr": sd_c}
        for k, v in inf.gen.state_dict().items():
            assert torch.equal(v, want["gen"][k]), k
    bad = dict(sd_c)
    dropped = next(iter(bad))
    del bad[dropped]
    bad["dec.extra.weight"] = torch.zeros(1)
    torch.save(bad, flat / "ck" / "9_net_Corr.pth")
    fopt = opt.replace(checkpoints_dir=str(flat), isTrain=False,
                       use_ema=False)
    inf = TP.Pix2PixNets(fopt, device="cpu", seed=4)
    capsys.readouterr()
    C.load_inference(fopt, inf, "9")
    out = capsys.readouterr().out
    assert "strict=False" in out and dropped in out
    assert "dec.extra.weight" in out
    for k, v in inf.corr.state_dict().items():
        if k != dropped:
            assert torch.equal(v, sd_c[k]), k


def _structure(init):
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        dict(jax.eval_shape(init)))


def test_jax_reads_a_port_checkpoint(tmp_path):
    """Port-written net_G.pth / net_Corr.pth -> tools/convert_weights ->
    JAX's make_inference_step, against the port's make_inference_step on
    the same batch."""
    opt, nets, state = _train(tmp_path, seed=0, use_ema=False)
    condition(nets.gen, 1)
    condition(nets.corr, 2)
    path = C.save_state(opt, state, nets, "latest")
    data = batch(3)
    got = TST.make_inference_step(nets)(data)

    jopt = JCFG.test_defaults(**{**OPT, "isTrain": False})
    jnets = JP.Pix2PixNets(jopt)
    key = jax.random.PRNGKey(0)
    sem = jnp.zeros((B, H, H, jopt.semantic_nc))
    img = jnp.zeros((B, H, H, 3))
    cbn = jnp.zeros((B, H, H, 3 + jopt.semantic_nc))
    variables = {
        "gen": convert_generator(os.path.join(path, "net_G.pth"), _structure(
            lambda: jnets.gen.init(key, sem, cbn, train=False))),
        "corr": convert_corr(os.path.join(path, "net_Corr.pth"), _structure(
            lambda: jnets.corr.init(key, img, None, sem, sem,
                                    train=False)))}
    want = JST.make_inference_step(jnets)(
        variables, {k: jnp.asarray(v) for k, v in data.items()})
    assert float(np.asarray(want["fake_image"]).std()) > 0.05  # signal
    for k in ("fake_image", "warp_out"):
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape == (B, H, H, 3)
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0, err_msg=k)
    shutil.rmtree(path)
