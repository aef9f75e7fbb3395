"""The architecture branches off the flagship, trained by the port against
the JAX package on the CPU at f32, at tests/test_train_variants.py's size
(crop 64, ngf 8, ndf 8, label_nc 5, batch 2), from the same weights (JAX
variables converted with cocosnet_tpu_torch.convert) and the same numpy
batch, each configuration one JAX make_train_step compile
(torch_fixtures.XLA_QUICK) combining several branches, as
tests/test_train_variants.py:106-120 combines them:

- the extras and the noise: the flagship's flags with --use_coordconv
  (the residual stack at 4 ngf + 3 + semantic_nc channels), --adaptor_se,
  --adaptor_nonlocal, --adaptor_res_deeper --dilation_conv (dilated
  blocks, the de-gridding convs), --eqlr_sn, --D_cam 1 (the CAM head),
  --gan_mode ls, --no_TTUR, and --mask_noise and --noise_for_mask past
  --mask_epoch 0: the draws JAX makes inside its compiled step are
  recorded (jax.debug.callback on jax.random.normal) and fed to the port's
  step (pix2pix.draw_noise), which cannot reproduce jax.random's bits;
- the reference's default norm (synchronized BatchNorm SPADE) with the
  domain classifier: tests/test_torch_batchnorm.py runs it through
  `run_variant` below.
Two compiles, not three: the suite runs at its time limit, and a JAX
train-step compile costs 100-350 s of one worker under six-way load.

Checked, with tests/test_torch_train.py's tolerances: every loss of two
steps at rel 2e-3 after step 0 and 2e-2 after step 1, the loss-key sets
equal; after step 0 the spectral u/v at 2e-5 and the BatchNorm running
statistics at rel 2e-3; the train-mode correspondence outputs of step 0
(the step's warp_out and warp_mask) at atol 5e-4. Also, without a JAX
step: wta_scale and grad_reverse forward and backward against JAX's, the
explicit-matrix correspondence (return_corr, WTA_scale_weight 1e-4) and
match_kernel 5 against the JAX net (forward, un-jitted), --show_corr's
bilinear warp, and the noise branches' refusals."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.models import generator as JGEN
from cocosnet_tpu.ops import correlation as JCOR
from cocosnet_tpu.train import state as JS
from cocosnet_tpu.train import steps as JST
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import flax_path, load_flax_variables
from cocosnet_tpu_torch.models import generator as TGEN
from cocosnet_tpu_torch.ops import correlation as TCOR
from cocosnet_tpu_torch.ops import shift9 as S
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_threads import torch_threads  # noqa: F401
from test_torch_train import OPT, _batch, _jnp, _spectral
from torch_fixtures import XLA_QUICK

B, H = 2, 64
FLAGSHIP = dict(OPT, use_ema=False)
EXTRAS = dict(FLAGSHIP, use_coordconv=True, adaptor_se=True,
              adaptor_nonlocal=True, adaptor_res_deeper=True,
              dilation_conv=True, eqlr_sn=True, D_cam=1.0, gan_mode="ls",
              no_TTUR=True, mask_noise=True, noise_for_mask=True,
              mask_epoch=0)


def _leaf(path, shape, rs):
    """tests/test_torch_train.py's draws (kernels at 1/sqrt(fan_in), biases
    at 0.1, gates 0.5, PReLU 0.2, spectral u/v random unit vectors), with
    BatchNorm scales at 1 + 0.1 N, running means at 0.1 N and variances
    in [0.5, 1.5], and the CAM head's gap_fc_/gmp_fc_ leaves."""
    name = path[-1].key
    if name.endswith("kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return rs.randn(*shape) / np.sqrt(fan_in)
    if name == "bias":
        return rs.randn(*shape) * 0.1
    if name == "scale":
        return 1 + rs.randn(*shape) * 0.1
    if name == "mean":
        return rs.randn(*shape) * 0.1
    if name == "var":
        return rs.rand(*shape) + 0.5
    if name == "gamma":
        return np.full(shape, 0.5)
    if name == "alpha":
        return np.full(shape, 0.2)
    if name in ("u", "v") or name.endswith(("_u", "_v")):
        x = rs.randn(*shape)
        return x / np.linalg.norm(x)
    raise KeyError(name)


def draw_variables(jnets, jopt):
    """Drawn numpy variables of every net the JAX nets build, the domain
    classifier included."""
    key = jax.random.PRNGKey(0)
    sem = jnp.zeros((B, H, H, jopt.semantic_nc))
    img = jnp.zeros((B, H, H, 3))
    cbn = jnp.zeros((B, H, H, 3 + jopt.semantic_nc))
    d_in = jnp.zeros((2 * B, H, H, jopt.semantic_nc + 3))
    inits = {
        "gen": lambda: jnets.gen.init({"params": key}, sem, cbn, train=True),
        "corr": lambda: jnets.corr.init({"params": key, "noise": key}, img,
                                        img, sem, sem, train=True),
        "disc": lambda: jnets.disc.init({"params": key}, d_in, train=True),
        "vgg": lambda: jnets.vgg.init({"params": key}, img, JP.VGG_KEYS),
    }
    if jnets.domain_classifier is not None:
        feat = jnp.zeros((B, H // 4, H // 4, 4 * jopt.ngf))
        inits["domain_classifier"] = lambda: jnets.domain_classifier.init(
            {"params": key}, feat, train=True)
    out = {}
    for i, (k, f) in enumerate(inits.items()):
        rs = np.random.RandomState(i)
        out[k] = jax.tree_util.tree_map_with_path(
            lambda p, s: _leaf(p, s.shape, rs).astype(np.float32),
            dict(jax.eval_shape(f)))
    return out


def _record_normal(monkeypatch, draws):
    """jax.random.normal, each draw also handed to the host (shape,
    values) as the compiled step runs it."""
    real = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        x = real(key, shape, dtype)
        jax.debug.callback(lambda v: draws.append(np.asarray(v)), x)
        return x

    monkeypatch.setattr(jax.random, "normal", normal)


def run_variant(kw, monkeypatch, record_noise=False):
    """Two train steps of the configuration `kw` through JAX
    make_train_step and the port's, from the same weights and batch.
    Returns {"jax": losses per step, "port": losses per step, "jax_state0",
    "port_sd0": the port's state dicts after step 0, "jax_vis0",
    "port_vis0": step 0's visuals, "calls": the shift9 core's plain calls
    (forward, backward) over the two steps}."""
    jopt = JCFG.test_defaults(**kw)
    topt = TCFG.test_defaults(**kw)
    jnets = JP.Pix2PixNets(jopt)
    variables = draw_variables(jnets, jopt)
    batch = _batch()
    lr = JS.lrs_for_epoch(jopt, 1)
    draws = []
    if record_noise:
        _record_normal(monkeypatch, draws)
    jstate = JS.create_train_state(jopt, _jnp(variables),
                                   jax.random.PRNGKey(1))
    jbatch, jlr = _jnp(batch), jnp.asarray(lr)
    jstep = jax.jit(JST.make_train_step(jnets)).lower(
        jstate, jbatch, jlr).compile(XLA_QUICK)
    res = {"jax": [], "port": []}
    steps_draws = []
    for i in range(2):
        jstate, metrics, vis = jstep(jstate, jbatch, jlr)
        res["jax"].append({k: float(v) for k, v in metrics.items()})
        jax.effects_barrier()
        steps_draws.append({d.shape: d for d in draws})
        draws.clear()
        if i == 0:
            res["jax_state0"] = jax.tree.map(np.asarray, jstate)
            res["jax_vis0"] = {k: np.asarray(v) for k, v in vis.items()
                               if v is not None}

    tnets = TP.Pix2PixNets(topt, device="cpu")
    for name, v in variables.items():
        load_flax_variables(getattr(tnets, name), v)
    if record_noise:
        step_no = iter(range(2))

        def draw_noise(opt, data, generator, train):
            res["draws"] = res.get("draws", 0) + 1
            mine = steps_draws[next(step_no)]
            sem = data["input_semantics"].shape
            small = (B, H // opt.down, H // opt.down, sem[-1])
            assert set(mine) == {tuple(sem), small}
            return {"seg_noise": torch.from_numpy(mine[tuple(sem)]),
                    "ref_seg_noise": torch.from_numpy(mine[small])}

        monkeypatch.setattr(TP, "draw_noise", draw_noise)
    tstate = TS.create_train_state(topt, tnets)
    tstep = TST.make_train_step(tnets)
    counted = (S.attend_shift9, S.attend_shift9_backward)
    before = [f.plain_calls for f in counted]
    for i in range(2):
        got, vis = tstep(tstate, batch, lr)
        res["port"].append({k: float(v) for k, v in got.items()})
        if i == 0:
            res["port_vis0"] = {k: v.numpy() for k, v in vis.items()}
            res["port_sd0"] = {
                name: {k: v.clone() for k, v in
                       getattr(tnets, name).state_dict().items()}
                for name in ("gen", "corr", "disc")}
    res["calls"] = tuple(f.plain_calls - n for f, n in zip(counted, before))
    res["nets"] = tnets
    return res


def check_losses(res, step, tol):
    want, got = res["jax"][step], res["port"][step]
    assert set(got) == set(want)
    for k, t in want.items():
        assert np.isfinite(got[k]), k
        assert abs(got[k] - t) / (abs(t) + 1e-2) < tol, (k, step, t, got[k])


def check_state(res, net, suffixes, collection, tol, rel=False):
    """The port's `suffixes` buffers of `net` after step 0 against the JAX
    state's `collection` leaves: atol `tol`, or rel `tol` of each leaf's
    scale."""
    want = _spectral(res["jax_state0"].variables[net].get(collection, {}))
    sd = res["port_sd0"][net]
    names = [k for k in sd if k.endswith(suffixes)]
    assert len(names) == len(want)
    for name in names:
        _, path, _ = flax_path(name, 1)
        w = want[path]
        atol = tol * max(float(np.abs(w).max()), 1e-3) if rel else tol
        np.testing.assert_allclose(sd[name].numpy(), w, atol=atol,
                                   err_msg=name)
    return len(names)


def check_visuals(res):
    """Step 0's train-mode correspondence outputs (and the fake)."""
    for key in ("warp_out", "warp_mask", "fake_image"):
        want, got = res["jax_vis0"][key], res["port_vis0"][key]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=key)


@pytest.fixture(scope="module")
def variant():
    with pytest.MonkeyPatch.context() as mp:
        return run_variant(EXTRAS, mp, record_noise=True)


@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
def test_variant_losses_match_jax(variant, step, tol):
    check_losses(variant, step, tol)


@pytest.mark.parametrize("net", ["gen", "corr", "disc"])
def test_variant_spectral_state_matches_jax(variant, net):
    """u/v after one step: under --eqlr_sn the equal-lr convs have none,
    so the spectral state is G's and D's attention blocks' and the CAM
    head's; Corr (whose nonlocal block has no spectral norm) holds none."""
    n = check_state(variant, net, ("weight_u", "weight_v"), "spectral",
                    2e-5)
    assert (n > 0) == (net != "corr")


def test_variant_correspondence_outputs_match_jax(variant):
    check_visuals(variant)


def test_variant_builds_its_branches(variant):
    """The configuration's modules exist and ran: the coordconv stack's
    width, the SE layers, the dilated blocks, the CAM head; the shift9
    core once forward and once backward a step; both noise draws fed."""
    nets = variant["nets"]
    assert variant["calls"] == (2, 2)
    adaptor = nets.corr.adaptive_model_seg
    assert adaptor.head_0.se_layar is not None
    assert adaptor.deeper2.conv_0.dilation == 4
    assert nets.corr.layer[0].conv1.weight.shape[1] == 4 * 8 + 3 + 6
    assert nets.disc.discriminator_0.gap_fc.weight_orig.shape == (1, 64)
    assert variant["draws"] == 2


# ------------------------------------------------------------- functions

def test_wta_scale_matches_jax():
    """Forward and backward against JAX's custom VJP, with ties at the row
    max (both tied entries count as max)."""
    rs = np.random.RandomState(0)
    f = rs.randn(3, 5, 7).astype(np.float32)
    f[0, 1, 2] = f[0, 1, 4] = f[0, 1].max() + 1
    g = rs.randn(3, 5, 7).astype(np.float32)
    jy, vjp = jax.vjp(lambda x: JCOR.wta_scale(x, 1e-2), jnp.asarray(f))
    jg, = vjp(jnp.asarray(g))
    tf = torch.from_numpy(f).requires_grad_()
    ty = TCOR.wta_scale(tf, 1e-2)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-6)
    np.testing.assert_allclose(tf.grad.numpy(), jg, rtol=1e-6)
    assert float(ty[0, 1, 2]) == float(ty[0, 1, 4]) == f[0, 1, 2]


def test_grad_reverse_matches_jax():
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    g = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    jy, vjp = jax.vjp(lambda v: JGEN.grad_reverse(v, 0.3), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = TGEN.grad_reverse(tx, 0.3)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.grad.numpy(), vjp(jnp.asarray(g))[0],
                               rtol=1e-6)


def _corr_pair(kw, seed=1):
    """The JAX correspondence net's drawn variables in eval mode and the
    port's net with them, the batch preprocessed by both."""
    jopt = JCFG.test_defaults(**kw)
    topt = TCFG.test_defaults(**kw)
    jnets = JP.Pix2PixNets(jopt)
    key = jax.random.PRNGKey(0)
    sem = jnp.zeros((B, H, H, jopt.semantic_nc))
    img = jnp.zeros((B, H, H, 3))
    rs = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(p, s.shape, rs).astype(np.float32),
        dict(jax.eval_shape(lambda: jnets.corr.init(
            key, img, None, sem, sem, train=False))))
    tnets = TP.Pix2PixNets(topt, device="cpu")
    load_flax_variables(tnets.corr, variables)
    batch = _batch(3)
    jdata = JP.preprocess_input(jopt, _jnp(batch))
    tdata = TP.preprocess_input(topt, batch, device="cpu")
    return jnets, _jnp(variables), jdata, tnets, tdata


def _both(jnets, variables, jdata, tnets, tdata, **kw):
    jout = jnets.corr.apply(variables, jdata["ref_image"], None,
                            jdata["input_semantics"],
                            jdata["ref_semantics"], train=False, **kw)
    with torch.no_grad():
        tout = tnets.corr(tdata["ref_image"], tdata["input_semantics"],
                          tdata["ref_semantics"], **kw)
    return jout, tout


INFER = dict(FLAGSHIP, isTrain=False, use_attention=False)


@pytest.mark.parametrize("mk,kw", [
    (3, dict(WTA_scale_weight=1e-4, return_corr=True)),
    (3, dict(WTA_scale_weight=1e-4)),
    (1, dict(return_corr=True)),
    (1, dict(WTA_scale_weight=1e-4))],
    ids=["3-wta_corr", "3-wta", "1-corr", "1-wta"])
def test_explicit_matrix_path_matches_jax(mk, kw):
    """The explicit (B, N, M) matrix of the (unfold) descriptors, WTA
    scaled, over tau: `corr` itself at rel 1e-4 of its scale (tau 0.01
    amplifies the descriptors' f32 error 100x), or the warp and mask it
    makes at atol 5e-4, un-jitted JAX."""
    pair = _corr_pair(dict(INFER, match_kernel=mk))
    jout, tout = _both(*pair, **kw)
    if kw.get("return_corr"):
        assert set(tout) == set(jout)
        want = np.asarray(jout["corr"])
        assert tout["corr"].shape == want.shape == (B, 256, 256)
        np.testing.assert_allclose(tout["corr"].numpy(), want,
                                   atol=1e-4 * float(np.abs(want).max()))
    else:
        for key in ("warp_out", "warp_mask"):
            np.testing.assert_allclose(tout[key].numpy(),
                                       np.asarray(jout[key]), atol=5e-4)


def test_match_kernel_5_and_show_corr_match_jax():
    """match_kernel 5 on the streaming unfold (the shift9 kernels are the
    3 x 3 case), with --show_corr's bilinear warp_out_bi, against the JAX
    net (its XLA route) at atol 5e-4."""
    pair = _corr_pair(dict(INFER, match_kernel=5, show_corr=True))
    before = S.attend_shift9.plain_calls
    jout, tout = _both(*pair)
    assert S.attend_shift9.plain_calls == before
    for key in ("warp_out", "warp_mask", "warp_out_bi"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=5e-4, err_msg=key)


def test_noise_branches_need_their_draws():
    """A training forward with --mask_noise or --noise_for_mask and no draw
    raises, as JAX's make_rng would (correspondence.py:176-181); an eval
    forward with --noise_for_mask and no draw takes a fixed one, the same
    each call."""
    jnets, variables, jdata, tnets, tdata = _corr_pair(dict(
        INFER, noise_for_mask=True, mask_noise=True))
    args = (tdata["ref_image"], tdata["input_semantics"],
            tdata["ref_semantics"])
    with torch.no_grad():
        a = tnets.corr(*args)["warp_out"]
        b = tnets.corr(*args)["warp_out"]
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        tnets.corr.train()
        for missing in ("seg_noise", "ref_seg_noise"):
            noise = TP.draw_noise(tnets.opt, tdata, torch.Generator(), True)
            del noise[missing]
            with pytest.raises(ValueError, match="draw"):
                tnets.corr(*args, real_img=tdata["real_image"], **noise)
