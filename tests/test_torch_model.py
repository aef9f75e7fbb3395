"""The port's blocks and its whole inference slice against the JAX package
on the CPU at f32: the same numpy inputs and the same weights (JAX
variables converted with cocosnet_tpu_torch.convert) through both.

The whole slice is held at atol 5e-4, the tolerance the earlier torch
parity harness held (README.md): tau = 0.01 amplifies conv rounding in the
correlation logits 100x. Blocks are held at 1e-5 relative to their scale.

Weights: both packages' inits draw conv kernels at xavier gain 0.02, zero
biases and the spectral u/v at random, which leaves sigma = u.(W v) near 0
and the activations far from unit scale. `_condition` draws kernels at
1/sqrt(fan_in) and biases at 0.1, sets the attention gate and the PReLU
slopes, and sets u/v to the leading singular vectors, so every layer
carries signal at unit scale. The JAX variables' structure comes from
jax.eval_shape of the JAX init, and the JAX forward is jitted, which keeps
the file within seconds."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.models.generator import (
    AdaptiveFeatureGenerator as JAdaptive)
from cocosnet_tpu.nn import blocks as JB
from cocosnet_tpu.nn.layers import OneHotLabels as JOneHot
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import load_flax_variables
from cocosnet_tpu_torch.models import correspondence as TCR
from cocosnet_tpu_torch.models.generator import (
    AdaptiveFeatureGenerator as TAdaptive)
from cocosnet_tpu_torch.nn import blocks as TB
from cocosnet_tpu_torch.nn.layers import OneHotLabels as TOneHot
from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.ops import corr as K
from cocosnet_tpu_torch.ops import shift9 as S
from test_torch_threads import torch_threads  # noqa: F401

FLAGSHIP_SMALL = dict(
    dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
    crop_size=64, load_size=64, batchSize=2, ngf=8, use_attention=True,
    maskmix=True, PONO=True, PONO_C=True, warp_mask_losstype="direct",
    isTrain=False)


def _structure(init, *args):
    """Zero numpy variables with the structure and shapes `init` would
    give, from jax.eval_shape: nothing is computed or compiled."""
    shapes = jax.eval_shape(init, *args)
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        dict(shapes))


def _condition(variables, seed=0):
    """Draws the weights of one net's numpy variables in place (see the
    module docstring)."""
    rs = np.random.RandomState(seed)
    params, spectral = variables["params"], variables.get("spectral", {})

    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v, s.get(k, {}) if isinstance(s, dict) else {})
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                p[k] = (rs.randn(*v.shape) / np.sqrt(fan_in)).astype(
                    np.float32)
            elif k == "bias":
                p[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "gamma":
                p[k] = np.full(v.shape, 0.5, np.float32)
            elif k == "alpha":
                p[k] = np.full(v.shape, 0.2, np.float32)
        if "u" in s and "kernel" in p:
            k = p["kernel"]
            w = np.transpose(k, (3, 2, 0, 1)).reshape(k.shape[-1], -1)
            u, _, vt = np.linalg.svd(w.astype(np.float64),
                                     full_matrices=False)
            s["u"] = u[:, 0].astype(np.float32)
            s["v"] = vt[0].astype(np.float32)

    walk(params, spectral)
    return variables


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(semantic_nc, b, h, w, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "label": rs.randint(0, semantic_nc, (b, h, w, 1)).astype(np.float32),
        "image": rs.rand(b, h, w, 3).astype(np.float32) * 2 - 1,
        "ref": rs.rand(b, h, w, 3).astype(np.float32) * 2 - 1,
        "label_ref": rs.randint(0, semantic_nc,
                                (b, h, w, 1)).astype(np.float32),
        "self_ref": np.ones((b,), np.float32),
    }


COUNTED = (C.conv3x3_fused, C.conv3x3_fused_stats, C.conv3x3_onehot,
           S.attend_shift9, K.attend_corr)


def _run_both(opt_kw, b, h, w):
    """(JAX outputs, port outputs, plain calls per entry) for one batch."""
    jopt = JCFG.test_defaults(**opt_kw)
    topt = TCFG.test_defaults(**opt_kw)
    batch = _batch(jopt.semantic_nc, b, h, w)
    jnets = JP.Pix2PixNets(jopt)
    key = jax.random.PRNGKey(0)
    sem = jnp.zeros((b, h, w, jopt.semantic_nc))
    img = jnp.zeros((b, h, w, 3))
    cbn = jnp.zeros((b, h, w, 3 + jopt.semantic_nc))
    variables = {
        "gen": _condition(_structure(
            lambda: jnets.gen.init(key, sem, cbn, train=False)), 0),
        "corr": _condition(_structure(
            lambda: jnets.corr.init(key, img, None, sem, sem, train=False)),
            1)}
    jout = jax.jit(lambda v, d: JP.inference(
        jnets, v, JP.preprocess_input(jopt, d)))(_jnp(variables),
                                                 _jnp(batch))
    tnets = TP.Pix2PixNets(topt, device="cpu")
    load_flax_variables(tnets.gen, variables["gen"])
    load_flax_variables(tnets.corr, variables["corr"])
    before = [f.plain_calls for f in COUNTED]
    tout = TP.inference(tnets, TP.preprocess_input(topt, batch,
                                                   device="cpu"))
    calls = {f.__name__: f.plain_calls - n for f, n in zip(COUNTED, before)}
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()}, calls)


@pytest.fixture(scope="module")
def flagship_small():
    return _run_both(FLAGSHIP_SMALL, 2, 64, 64)


@pytest.mark.parametrize("key", ["fake_image", "warp_out", "warp_mask",
                                 "adaptive_feature_seg",
                                 "adaptive_feature_img"])
def test_slice_matches_jax(flagship_small, key):
    jout, tout, _ = flagship_small
    assert tout[key].shape == jout[key].shape
    assert np.isfinite(tout[key]).all()
    np.testing.assert_allclose(tout[key], jout[key], atol=5e-4)


def test_slice_plain_counters(flagship_small):
    """One forward at crop 64 / ngf 8: shift9 runs once. No conv here meets
    the kernels' size gates: the one-hot conv's needs W % 128 == 0 and Cout
    >= 64 (pallas_conv.conv3x3_onehot_supported), the dense entries' c and
    cout >= 64 with h*w >= 2048, so the labels are densified and every conv
    takes the library; the wide case below moves the dense entries."""
    *_, calls = flagship_small
    assert calls == {"conv3x3_fused": 0, "conv3x3_fused_stats": 0,
                     "conv3x3_onehot": 0, "attend_shift9": 1,
                     "attend_corr": 0}


def test_wide_slice_moves_every_counter():
    """A 128 x 256 batch at ngf 16 puts 32 x 64 feature maps (2048
    positions, the width the shift9 kernel tiles) with >= 64 channels
    through the residual stack, the adaptors' last layers and the
    generator's top blocks, so the dense entries and shift9 run their plain
    versions; the one-hot conv's Cout = ngf = 16 < 64 keeps it off its
    kernel, as the JAX gate does; the outputs still match the JAX
    package."""
    kw = dict(FLAGSHIP_SMALL, crop_size=256, load_size=256, aspect_ratio=2.0,
              ngf=16, batchSize=1)
    jout, tout, calls = _run_both(kw, 1, 128, 256)
    assert calls == {"conv3x3_fused": 52, "conv3x3_fused_stats": 18,
                     "conv3x3_onehot": 0, "attend_shift9": 1,
                     "attend_corr": 0}
    for key in ("fake_image", "warp_out", "warp_mask"):
        np.testing.assert_allclose(tout[key], jout[key], atol=5e-4)


@pytest.fixture(scope="module", params=[True, False],
                ids=["pono_c", "positions"])
def mk1_small(request):
    """The flagship flags at match_kernel=1, with the descriptors centered
    over channels (PONO_C) or over positions."""
    return _run_both(dict(FLAGSHIP_SMALL, match_kernel=1,
                          PONO_C=request.param), 2, 64, 64)


@pytest.mark.parametrize("key", ["fake_image", "warp_out", "warp_mask",
                                 "adaptive_feature_seg",
                                 "adaptive_feature_img"])
def test_mk1_slice_matches_jax(mk1_small, key):
    """Dense descriptors through attend_corr (its plain version) against
    the JAX net's _descriptor and attend, at atol 5e-4 (measured: 1.4e-5 on
    warp_mask, 4.5e-6 on fake_image)."""
    jout, tout, _ = mk1_small
    assert tout[key].shape == jout[key].shape
    assert np.isfinite(tout[key]).all()
    np.testing.assert_allclose(tout[key], jout[key], atol=5e-4)


def test_mk1_slice_plain_counters(mk1_small):
    """An mk1 forward runs attend_corr once and shift9 never (and, at crop
    64, no conv kernel)."""
    *_, calls = mk1_small
    assert calls == {"conv3x3_fused": 0, "conv3x3_fused_stats": 0,
                     "conv3x3_onehot": 0, "attend_shift9": 0,
                     "attend_corr": 1}


@pytest.mark.parametrize("match_kernel", [3, 1])
def test_use_pallas_false_takes_the_library_route(monkeypatch, match_kernel):
    """opt.use_pallas False (the JAX package's switch, correspondence.py:
    241, :314) sends the warp to the library route, attend_unfold at
    match_kernel 3 and attend at 1: neither correlation kernel runs, and
    the slice still matches the JAX package with the same switch."""
    ran = []
    for name in ("attend_unfold", "attend"):
        fn = getattr(TCR, name)
        monkeypatch.setattr(TCR, name, lambda *a, _fn=fn, _name=name, **k: (
            ran.append(_name), _fn(*a, **k))[1])
    jout, tout, calls = _run_both(dict(FLAGSHIP_SMALL, use_pallas=False,
                                       match_kernel=match_kernel), 2, 64, 64)
    assert ran == ["attend_unfold" if match_kernel == 3 else "attend"]
    assert calls["attend_shift9"] == calls["attend_corr"] == 0
    for key in ("fake_image", "warp_out", "warp_mask"):
        np.testing.assert_allclose(tout[key], jout[key], atol=5e-4)


# ------------------------------------------------------------------ blocks

def _block_pair(jmod, tmod, args_j, args_t, seed=0):
    variables = _condition(_structure(
        lambda: jmod.init(jax.random.PRNGKey(seed), *args_j)), seed=seed)
    want = np.asarray(jmod.apply(_jnp(variables), *args_j))
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(*args_t).numpy()
    return got, want


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * max(
        1.0, float(np.abs(want).max())))


def test_residual_block_matches_jax():
    x = np.random.RandomState(0).randn(2, 8, 8, 24).astype(np.float32)
    got, want = _block_pair(JB.ResidualBlock(24), TB.ResidualBlock(24),
                            (jnp.asarray(x),), (torch.from_numpy(x),))
    _close(got, want)


@pytest.mark.parametrize("fin,fout,config,pono", [
    (32, 16, "spadesyncbatch3x3", True),     # learned shortcut, PONO
    (16, 16, "spadeinstance3x3", False),     # identity shortcut, IN
])
def test_spade_resnet_block_matches_jax(fin, fout, config, pono):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, fin).astype(np.float32)
    seg = rs.randn(2, 16, 16, 5).astype(np.float32)
    jm = JB.SPADEResnetBlock(fin, fout, config, 5, pono=pono)
    tm = TB.SPADEResnetBlock(fin, fout, config, 5, pono=pono)
    got, want = _block_pair(
        jm, tm, (jnp.asarray(x), jnp.asarray(seg), False),
        (torch.from_numpy(x), torch.from_numpy(seg)))
    _close(got, want)


def test_attention_matches_jax():
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    got, want = _block_pair(JB.Attention(32, True), TB.Attention(32, True),
                            (jnp.asarray(x),), (torch.from_numpy(x),))
    _close(got, want)


def test_adaptive_feature_generator_onehot_input_matches_jax():
    """The seg adaptor fed the integer map (OneHotLabels -> one-hot conv)
    in the port against the JAX adaptor fed the same map."""
    opt_kw = dict(FLAGSHIP_SMALL, crop_size=32)
    jopt, topt = JCFG.test_defaults(**opt_kw), TCFG.test_defaults(**opt_kw)
    nc = jopt.semantic_nc
    lab = np.random.RandomState(3).randint(0, nc, (2, 32, 32)).astype(
        np.int32)
    dense = np.eye(nc, dtype=np.float32)[lab]
    got, want = _block_pair(
        JAdaptive(jopt, nc), TAdaptive(topt, nc),
        (JOneHot(jnp.asarray(lab), nc), jnp.asarray(dense), False),
        (TOneHot(torch.from_numpy(lab), nc), torch.from_numpy(dense)))
    _close(got, want)
