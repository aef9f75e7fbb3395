"""The port's training slice against the JAX package on the CPU at f32: the
discriminator, VGG, GAN and contextual losses, the mask loss and train-mode
spectral norm module by module, then two flagship-branch train steps
(crop 64, ngf 8 / ndf 8, label_nc 5, batch 2: tests/test_train_variants.py's
size) through JAX make_train_step and the port's, from the same weights
(JAX variables converted with cocosnet_tpu_torch.convert) and the same
numpy batch.

Tolerances: modules at 1e-5 relative to their scale (the same math in
another framework's f32 order); the losses of the first step at rel 2e-3
and of the second at 2e-2, with |t| + 1e-2 in the denominator, the
tolerances tests/test_trajectory_parity.py holds the JAX package to against
torch: the first step is pure loss parity, the second compounds one Adam
update of both sides, and tau = 0.01 makes the warp softmax argmax-like.

Weights are drawn as tests/test_torch_model.py draws them (kernels at
1/sqrt(fan_in), biases at 0.1) so every layer carries signal; the spectral
u/v are random unit vectors, so the power iterations move them. The JAX
step is jitted once per module (about half a minute on the CPU)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.losses import contextual as JCX
from cocosnet_tpu.losses import gan as JG
from cocosnet_tpu.losses import perceptual as JPL
from cocosnet_tpu.models.discriminator import MultiscaleDiscriminator as JD
from cocosnet_tpu.nn import layers as JL
from cocosnet_tpu.ops import image as JI
from cocosnet_tpu.nn.vgg import VGG19Features as JVGG
from cocosnet_tpu.train import state as JS
from cocosnet_tpu.train import steps as JST
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import (ema_from_flax, flax_path,
                                        load_flax_variables)
from cocosnet_tpu_torch.losses import contextual as TCX
from cocosnet_tpu_torch.losses import gan as TG
from cocosnet_tpu_torch.losses import perceptual as TPL
from cocosnet_tpu_torch.models.discriminator import \
    MultiscaleDiscriminator as TD
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.nn.vgg import VGG19Features as TVGG
from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.ops import image as TI
from cocosnet_tpu_torch.ops import shift9 as S
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_threads import torch_threads  # noqa: F401

OPT = dict(dataset_mode="ade20k", label_nc=5, contain_dontcare_label=True,
           crop_size=64, load_size=64, batchSize=2, ngf=8, ndf=8,
           PONO=True, PONO_C=True, vgg_normal_correct=True,
           use_attention=True, maskmix=True, warp_mask_losstype="direct",
           weight_mask=100.0, use_ema=True, isTrain=True)
B, H = 2, 64


def _draw(shapes, seed):
    """Numpy variables with the structure `shapes` (from jax.eval_shape):
    kernels at 1/sqrt(fan_in), biases at 0.1, the attention gates at 0.5,
    PReLU slopes at 0.2, spectral u/v random unit vectors."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "bias":
            return (rs.randn(*s.shape) * 0.1).astype(np.float32)
        if name == "gamma":
            return np.full(s.shape, 0.5, np.float32)
        if name == "alpha":
            return np.full(s.shape, 0.2, np.float32)
        if name in ("u", "v"):
            x = rs.randn(*s.shape)
            return (x / np.linalg.norm(x)).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "label": rs.randint(0, 6, (B, H, H, 1)).astype(np.float32),
        "image": (rs.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
        "ref": (rs.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
        "label_ref": rs.randint(0, 6, (B, H, H, 1)).astype(np.float32),
        "self_ref": np.ones((B,), np.float32),
    }


def _variables(jnets, opt):
    key = jax.random.PRNGKey(0)
    sem = jnp.zeros((B, H, H, opt.semantic_nc))
    img = jnp.zeros((B, H, H, 3))
    cbn = jnp.zeros((B, H, H, 3 + opt.semantic_nc))
    d_in = jnp.zeros((2 * B, H, H, opt.semantic_nc + 3))
    inits = {
        "gen": lambda: jnets.gen.init({"params": key}, sem, cbn, train=True),
        "corr": lambda: jnets.corr.init({"params": key, "noise": key}, img,
                                        img, sem, sem, train=True),
        "disc": lambda: jnets.disc.init({"params": key}, d_in, train=True),
        "vgg": lambda: jnets.vgg.init({"params": key}, img, JP.VGG_KEYS),
    }
    return {k: _draw(jax.eval_shape(f), i)
            for i, (k, f) in enumerate(inits.items())}


def _spectral(tree, prefix=()):
    """{path: u or v} of a flax variable tree's spectral collection."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spectral(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def two_steps():
    """(JAX losses per step, port losses per step, JAX states, port
    snapshots per step, port nets, the port's G-side parameters before the
    first step, the plain shift9 calls) for two train steps on one
    batch."""
    jopt = JCFG.test_defaults(**OPT)
    topt = TCFG.test_defaults(**OPT)
    jnets = JP.Pix2PixNets(jopt)
    variables = _variables(jnets, jopt)
    batch = _batch()
    lr = JS.lrs_for_epoch(jopt, 1)

    jstate = JS.create_train_state(jopt, _jnp(variables),
                                   jax.random.PRNGKey(1))
    jstep = jax.jit(JST.make_train_step(jnets))
    jlosses, jstates = [], []
    for _ in range(2):
        jstate, metrics, _ = jstep(jstate, _jnp(batch), jnp.asarray(lr))
        jlosses.append({k: float(v) for k, v in metrics.items()})
        jstates.append(jax.tree.map(np.asarray, jstate))

    tnets = TP.Pix2PixNets(topt, device="cpu")
    for name in ("gen", "corr", "disc", "vgg"):
        load_flax_variables(getattr(tnets, name), variables[name])
    tstate = TS.create_train_state(topt, tnets)
    p0 = {k: p.detach().clone()
          for k, p in TS.g_named_parameters(tnets).items()}
    tstep = TST.make_train_step(tnets)
    tlosses, snaps = [], []
    before = (S.attend_shift9.plain_calls,
              S.attend_shift9_backward.plain_calls)
    for _ in range(2):
        losses, _ = tstep(tstate, batch, lr)
        tlosses.append({k: float(v) for k, v in losses.items()})
        snaps.append({name: {k: v.clone() for k, v in
                             getattr(tnets, name).state_dict().items()}
                      for name in ("gen", "corr", "disc")}
                     | {"ema": {k: v.clone()
                                for k, v in tstate.ema.items()}})
    calls = (S.attend_shift9.plain_calls - before[0],
             S.attend_shift9_backward.plain_calls - before[1])
    return jlosses, tlosses, jstates, snaps, tnets, p0, calls


LOSS_KEYS = ["no_vgg_feat", "GAN", "GAN_Feat", "fm", "perc", "contextual",
             "mask", "D_Fake", "D_real"]


@pytest.mark.parametrize("key", LOSS_KEYS)
@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
def test_train_step_losses_match_jax(two_steps, key, step, tol):
    jlosses, tlosses, *_ = two_steps
    assert set(tlosses[step]) == set(jlosses[step])
    t, o = jlosses[step][key], tlosses[step][key]
    assert np.isfinite(o)
    assert abs(o - t) / (abs(t) + 1e-2) < tol, (key, step, t, o)


@pytest.mark.parametrize("net", ["gen", "corr", "disc"])
def test_train_step_spectral_state_matches_jax(two_steps, net):
    """After one step the u/v of every spectral conv (G's and Corr's
    advanced once, D's twice) equal the JAX state's."""
    _, _, jstates, snaps, *_ = two_steps
    want = _spectral(jstates[0].variables[net]["spectral"])
    sd = snaps[0][net]
    names = [k for k in sd if k.endswith(("weight_u", "weight_v"))]
    assert len(names) == len(want) > 0
    for name in names:
        _, path, _ = flax_path(name, 1)
        np.testing.assert_allclose(sd[name].numpy(), want[path], atol=2e-5)


def test_train_step_ema_matches_jax(two_steps):
    """The EMA shadows after one step. The move, shadow - p0, is about 1e-3
    of one Adam step (~1e-7), far below the parameters, so it is held two
    ways. (1) Each shadow element is 0.999 p0 + 0.001 p1 of the port's own
    updated parameters, to 2 ulps of the larger of |p0| and |shadow| (the
    f32 rounding); an EMA that did not move, or moved towards p0, misses
    by the whole move. (2) The moves of the whole G side equal the JAX
    state's to 10% in relative L2 (measured: 3%; Adam's first step is near
    lr * sign(g), so the few elements whose gradient lies near eps = 1e-3
    move differently in the two packages' f32 orders)."""
    _, _, jstates, snaps, tnets, p0, _ = two_steps
    want = ema_from_flax(TS.g_named_parameters(tnets), jstates[0].ema)
    num = den = 0.0
    for k, v in snaps[0]["ema"].items():
        net, name = k.split(".", 1)
        q = p0[k].double().numpy()
        p1 = snaps[0][net][name].double().numpy()
        got = v.double().numpy()
        ulp = np.spacing(np.maximum(np.abs(p0[k].numpy()),
                                    np.abs(v.numpy()))).astype(np.float64)
        rule = np.abs(got - (0.999 * q + 0.001 * p1)) / ulp
        assert rule.max() <= 2, (k, rule.max())
        ref = want[k].double().numpy()
        num += float(((got - ref) ** 2).sum())
        den += float(((ref - q) ** 2).sum())
    assert den > 0
    assert (num / den) ** 0.5 <= 0.1, (num / den) ** 0.5


def test_train_step_runs_the_shift9_backward(two_steps):
    """Each step runs the shift9 core forward and backward once (their
    plain versions on the CPU)."""
    *_, calls = two_steps
    assert calls == (2, 2)


# ------------------------------------------------------------- modules

def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * max(
        1.0, float(np.abs(want).max())))


def test_discriminator_train_mode_matches_jax():
    """Every scale's features and logits, and the u/v that one train-mode
    forward leaves behind."""
    opt = JCFG.test_defaults(**OPT)
    jd = JD(opt)
    x = np.random.RandomState(4).randn(2, 64, 64, opt.semantic_nc + 3)
    x = x.astype(np.float32)
    variables = _draw(jax.eval_shape(
        lambda: jd.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                        train=True)), 5)
    (jouts, _), upd = jd.apply(_jnp(variables), jnp.asarray(x), train=True,
                               mutable=["spectral"])
    td = TD(TCFG.test_defaults(**OPT))
    load_flax_variables(td, variables)
    td.train()
    with torch.no_grad():
        touts = td(torch.from_numpy(x))
    assert len(touts) == len(jouts) == 2
    for js, ts in zip(jouts, touts):
        assert len(js) == len(ts) == 5
        for a, b in zip(ts, js):
            _close(a.numpy(), b)
    sd = td.state_dict()
    want = _spectral(jax.tree.map(np.asarray, upd["spectral"]))
    for name in (k for k in sd if k.endswith(("weight_u", "weight_v"))):
        _, path, _ = flax_path(name, 1)
        np.testing.assert_allclose(sd[name].numpy(), want[path], atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16, 24, 5), (1, 7, 9, 3),
                                   (2, 1, 2, 4)])
def test_avg_pool_3x3_s2_p1_matches_jax_and_torch(shape):
    """The discriminator's inter-scale downsample: forward against the JAX
    op, forward and gradient against F.avg_pool2d(3, 2, 1,
    count_include_pad=False) on a contiguous NCHW tensor, at even, odd
    and one-row sizes."""
    rs = np.random.RandomState(8)
    x = rs.randn(*shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TI.avg_pool_3x3_s2_p1(xt)
    _close(got.detach().numpy(), JI.avg_pool_3x3_s2_p1(jnp.asarray(x)))
    xr = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    xr.requires_grad_(True)
    want = torch.nn.functional.avg_pool2d(
        xr, 3, 2, 1, count_include_pad=False).permute(0, 2, 3, 1)
    _close(got.detach().numpy(), want.detach().numpy())
    gy = torch.from_numpy(rs.randn(*want.shape).astype(np.float32))
    gx, = torch.autograd.grad(got, xt, gy)
    gr, = torch.autograd.grad(want, xr, gy)
    _close(gx.numpy(), gr.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("normal_correct", [False, True])
def test_vgg_matches_jax(normal_correct):
    jv = JVGG(vgg_normal_correct=normal_correct)
    x = np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    keys = ["r12", "r22", "r32", "r42", "r52", "p3"]
    variables = _draw(jax.eval_shape(
        lambda: jv.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                        keys)), 7)
    want = jv.apply(_jnp(variables), jnp.asarray(x), keys)
    tv = TVGG(normal_correct)
    load_flax_variables(tv, variables)
    assert not any(p.requires_grad for p in tv.parameters())
    got = tv(torch.from_numpy(x), keys)
    for a, b in zip(got, want):
        _close(a.numpy(), b)


@pytest.mark.parametrize("pono", [False, True])
def test_contextual_loss_matches_jax(pono):
    rs = np.random.RandomState(8)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    y = (x + rs.randn(2, 8, 8, 16) * 0.5).astype(np.float32)
    want = JCX.contextual_loss(jnp.asarray(x), jnp.asarray(y), pono=pono)
    got = TCX.contextual_loss(torch.from_numpy(x), torch.from_numpy(y),
                              pono=pono)
    _close(got.numpy(), want)


def test_contextual_loss_clamps_the_distance():
    """Identical features give cos = 1 up to rounding; the clamp keeps
    d = 1 - cos >= 0, so the loss stays finite (and near its floor)."""
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 4, 4, 8).astype(
        np.float32))
    loss = TCX.contextual_loss(x, x.clone())
    assert torch.isfinite(loss).all()


@pytest.mark.parametrize("mode", ["hinge", "ls", "original", "w"])
@pytest.mark.parametrize("real,for_d", [(True, True), (False, True),
                                        (True, False)])
def test_gan_loss_matches_jax(mode, real, for_d):
    rs = np.random.RandomState(10)
    pred = [[rs.randn(2, 4, 4, 3).astype(np.float32),
             rs.randn(2, 5, 5, 1).astype(np.float32)],
            [rs.randn(2, 3, 3, 1).astype(np.float32)]]
    want = JG.gan_loss([[jnp.asarray(t) for t in s] for s in pred], real,
                       for_d, mode)
    got = TG.gan_loss([[torch.from_numpy(t) for t in s] for s in pred], real,
                      for_d, mode)
    _close(got.numpy(), want)


def test_feature_matching_and_weighted_l1_match_jax():
    rs = np.random.RandomState(11)
    fake = [[rs.randn(2, 4, 4, 3).astype(np.float32) for _ in range(3)]
            for _ in range(2)]
    real = [[rs.randn(2, 4, 4, 3).astype(np.float32) for _ in range(3)]
            for _ in range(2)]
    want = JG.feature_matching_loss(
        [[jnp.asarray(t) for t in s] for s in fake],
        [[jnp.asarray(t) for t in s] for s in real])
    got = TG.feature_matching_loss(
        [[torch.from_numpy(t) for t in s] for s in fake],
        [[torch.from_numpy(t) for t in s] for s in real])
    _close(got.numpy(), want)
    w = np.asarray([0.3, 0.7], np.float32)[:, None, None, None]
    _close(TG.weighted_l1_loss(torch.from_numpy(fake[0][0]),
                               torch.from_numpy(real[0][0]),
                               torch.from_numpy(w)).numpy(),
           JG.weighted_l1_loss(jnp.asarray(fake[0][0]),
                               jnp.asarray(real[0][0]), jnp.asarray(w)))


def test_perceptual_losses_match_jax():
    rs = np.random.RandomState(15)
    xs = [rs.randn(2, 8 >> i, 8 >> i, 4).astype(np.float32) for i in range(5)]
    ys = [(x + rs.randn(*x.shape) * 0.3).astype(np.float32) for x in xs]
    _close(TPL.vgg_feature_matching([torch.from_numpy(x) for x in xs],
                                    [torch.from_numpy(y) for y in ys]).numpy(),
           JPL.vgg_feature_matching([jnp.asarray(x) for x in xs],
                                    [jnp.asarray(y) for y in ys]))
    _close(TPL.perceptual_mse(torch.from_numpy(xs[0]),
                              torch.from_numpy(ys[0])).numpy(),
           JPL.perceptual_mse(jnp.asarray(xs[0]), jnp.asarray(ys[0])))


def test_warp_mask_loss_matches_jax():
    rs = np.random.RandomState(12)
    opt = JCFG.test_defaults(**OPT)
    nc = opt.semantic_nc
    wm = rs.dirichlet(np.ones(nc), size=(2, 16, 16)).astype(np.float32)
    lab = rs.randint(0, nc, (2, 64, 64)).astype(np.int32)
    ref = rs.randint(1, nc, (2, 64, 64)).astype(np.int32)
    want = JP.warp_mask_loss(opt, jnp.asarray(wm), jnp.asarray(lab),
                             jnp.asarray(ref))
    got = TP.warp_mask_loss(TCFG.test_defaults(**OPT), torch.from_numpy(wm),
                            torch.from_numpy(lab), torch.from_numpy(ref))
    _close(got.numpy(), want)


@pytest.mark.parametrize("weight_norm", ["spectral", "equal_lr"])
def test_conv_train_mode_matches_jax(weight_norm):
    """A train-mode forward: one power iteration, then the conv, and the
    new u/v stored; a second forward advances them again."""
    x = np.random.RandomState(13).randn(2, 6, 8, 5).astype(np.float32)
    jmod = JL.Conv2d(7, 3, padding=1, weight_norm=weight_norm)
    variables = _draw(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), 14)
    tmod = TL.Conv2d(5, 7, 3, padding=1, weight_norm=weight_norm)
    load_flax_variables(tmod, variables)
    tmod.train()
    jv = _jnp(variables)
    for _ in range(2):
        want, upd = jmod.apply(jv, jnp.asarray(x), mutable=["spectral"])
        jv = {**jv, **upd}
        with torch.no_grad():
            got = tmod(torch.from_numpy(x))
        _close(got.numpy(), want)
    if weight_norm == "spectral":
        np.testing.assert_allclose(tmod.weight_u.numpy(),
                                   np.asarray(jv["spectral"]["u"]), atol=1e-6)
        np.testing.assert_allclose(tmod.weight_v.numpy(),
                                   np.asarray(jv["spectral"]["v"]), atol=1e-6)


def test_eval_mode_keeps_the_spectral_vectors():
    tmod = TL.Conv2d(5, 7, 3, padding=1, weight_norm="spectral")
    TL.init_weights(tmod, torch.Generator().manual_seed(0))
    u = tmod.weight_u.clone()
    tmod.eval()
    tmod(torch.randn(1, 4, 4, 5))
    assert torch.equal(tmod.weight_u, u)
    tmod.train()
    tmod(torch.randn(1, 4, 4, 5))
    assert not torch.equal(tmod.weight_u, u)


def test_ema_state_dicts_swap_in_the_shadows():
    """gen's and corr's state dicts with the EMA shadows in place of their
    parameters (JAX state.ema_variables); buffers and D are untouched."""
    opt = TCFG.test_defaults(**OPT)
    nets = TP.Pix2PixNets(opt, device="cpu")
    state = TS.create_train_state(opt, nets)
    for k, v in state.ema.items():
        v.fill_(float(len(k)))
    sds = TS.ema_state_dicts(state, nets)
    assert set(sds) == {"gen", "corr"}
    for net in ("gen", "corr"):
        live = getattr(nets, net).state_dict()
        assert set(sds[net]) == set(live)
        for k, v in sds[net].items():
            key = f"{net}.{k}"
            if key in state.ema:
                assert torch.equal(v, state.ema[key])
            else:   # spectral u/v and other buffers
                assert torch.equal(v, live[k])
        getattr(nets, net).load_state_dict(sds[net])


@pytest.mark.parametrize("epoch", [1, 100, 101, 150, 200])
@pytest.mark.parametrize("no_ttur", [False, True])
def test_learning_rates_match_jax(epoch, no_ttur):
    kw = dict(OPT, no_TTUR=no_ttur)
    np.testing.assert_array_equal(
        TS.lrs_for_epoch(TCFG.test_defaults(**kw), epoch),
        JS.lrs_for_epoch(JCFG.test_defaults(**kw), epoch))


def test_training_routes_every_conv_to_the_library():
    """Inside training() a conv of the fused entries' shape, and a one-hot
    input, go to F.conv2d: the kernel entries' counters stay put, and the
    result still carries a gradient."""
    x = torch.randn(1, 32, 64, 64, requires_grad=True)
    k = torch.randn(3, 3, 64, 64) / 24
    lab = TL.OneHotLabels(torch.randint(0, 5, (1, 32, 64)), 5)
    before = (C.conv3x3_fused.plain_calls, C.conv3x3_fused_stats.plain_calls,
              C.conv3x3_onehot.plain_calls)
    with TL.training():
        y = TL.conv2d(x, k, reflect=True)
        y2, mean, var = TL.conv2d(x, k, padding=1, want_stats=True)
        y3 = TL.conv2d(lab, torch.randn(3, 3, 5, 64), padding=1)
    assert (C.conv3x3_fused.plain_calls, C.conv3x3_fused_stats.plain_calls,
            C.conv3x3_onehot.plain_calls) == before
    assert y.grad_fn is not None and y3.shape == (1, 32, 64, 64)
    want = C.conv3x3_plain(x, k, None, want_stats=True)
    for a, b in zip((y2, mean, var), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # outside it, the same conv takes the fused entry
    TL.conv2d(x.detach(), k, reflect=True)
    assert C.conv3x3_fused.plain_calls == before[0] + 1


def test_conv_kernel_entries_refuse_grad():
    """The CUDA conv kernels have no backward: their entries raise on an
    input that requires grad (checked before the launch), and take one
    under no_grad."""
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        C._refuse_grad("conv3x3_fused", torch.ones(2), w)
    with torch.no_grad():
        C._refuse_grad("conv3x3_fused", torch.ones(2), w)
    C._refuse_grad("conv3x3_onehot", torch.ones(2), None)


@pytest.mark.parametrize("flag", [dict(mask_noise=True),
                                  dict(noise_for_mask=True),
                                  dict(D_cam=1.0), dict(D_steps_per_G=2),
                                  dict(remat=True),
                                  dict(weight_domainC=1.0, domain_rela=True)])
def test_unported_training_options_raise(flag):
    opt = TCFG.test_defaults(**dict(OPT, **flag))
    with pytest.raises(NotImplementedError, match=next(iter(flag))):
        TP.Pix2PixNets(opt, device="cpu")
