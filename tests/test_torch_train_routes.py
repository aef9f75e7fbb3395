"""Two flagship-branch train steps of the port on each training conv route,
against two steps of the port's default route from the same weights and
batch, on the CPU at f32:
- "dw all": COCOSNET_PALLAS_DW=all, every conv of the dW gate's sizes on
  ops/conv3x3.conv3x3_xla_pdw (library forward and dx, dW on conv3x3_dw,
  its plain version here);
- "fused": COCOSNET_FUSED_CONV_TRAIN=1, the fused gate's convs on
  conv3x3_fused forward and backward (plain versions here).
The reference is the default route (every conv a library conv), which
tests/test_torch_train.py holds against JAX make_train_step; the routes are
not held against JAX directly because a JAX step at a size where their
gates take convs costs more than 80 s to jit on the CPU (the JAX side runs
its XLA convs there either way: its gates need a TPU), too much for the
suite's time.

The size is 64 x 128 (crop 128 at aspect ratio 2), ngf 16 / ndf 16,
label_nc 12, batch 1: the adaptors' feature maps pass the conv gates' size
conditions (W % 16 = 0, W >= 32, H W >= 2048, both channel counts >= 64),
so both routes' counters move. The flags and the weight draw are
tests/test_torch_train.py's, and so are the tolerances: the losses of the
first step at rel 2e-3 and of the second at 2e-2, |t| + 1e-2 in the
denominator. The routes run the same functions in another order of f32
sums."""

import numpy as np
import pytest

import jax

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import load_flax_variables
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.tools.ab_dw import predicted_launches, record_convs
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_train import LOSS_KEYS, OPT, _draw
from test_torch_threads import torch_threads  # noqa: F401

ROUTES_OPT = dict(OPT, label_nc=12, crop_size=128, load_size=128,
                  aspect_ratio=2.0, batchSize=1, ngf=16, ndf=16)
B, H, W = 1, 64, 128
ROUTES = {"default": None, "dw all": (C.DW_ENV, "all"),
          "fused": (TL.FUSED_TRAIN_ENV, "1")}
COUNTED = ("conv3x3_fused", "conv3x3_fused_backward", "conv3x3_fused_stats",
           "conv3x3_dw")


def _variables(jnets, opt):
    """Numpy weights drawn as tests/test_torch_train.py draws them, in the
    JAX package's variable structure (jax.eval_shape, no compute)."""
    key = jax.random.PRNGKey(0)
    sem = jax.ShapeDtypeStruct((B, H, W, opt.semantic_nc), np.float32)
    img = jax.ShapeDtypeStruct((B, H, W, 3), np.float32)
    cbn = jax.ShapeDtypeStruct((B, H, W, 3 + opt.semantic_nc), np.float32)
    d_in = jax.ShapeDtypeStruct((2 * B, H, W, opt.semantic_nc + 3),
                                np.float32)
    inits = {
        "gen": lambda s, c: jnets.gen.init({"params": key}, s, c,
                                           train=True),
        "corr": lambda i, s: jnets.corr.init({"params": key, "noise": key},
                                             i, i, s, s, train=True),
        "disc": lambda d: jnets.disc.init({"params": key}, d, train=True),
        "vgg": lambda i: jnets.vgg.init({"params": key}, i, JP.VGG_KEYS),
    }
    args = {"gen": (sem, cbn), "corr": (img, sem), "disc": (d_in,),
            "vgg": (img,)}
    return {k: _draw(jax.eval_shape(f, *args[k]), i)
            for i, (k, f) in enumerate(inits.items())}


def _batch(nc):
    rs = np.random.RandomState(0)
    return {
        "label": rs.randint(0, nc, (B, H, W, 1)).astype(np.float32),
        "image": (rs.rand(B, H, W, 3) * 2 - 1).astype(np.float32),
        "ref": (rs.rand(B, H, W, 3) * 2 - 1).astype(np.float32),
        "label_ref": rs.randint(0, nc, (B, H, W, 1)).astype(np.float32),
        "self_ref": np.ones((B,), np.float32),
    }


@pytest.fixture(scope="module")
def runs():
    """{route: (losses per step, plain calls of the conv entries over the
    first step, their predicted launches)}."""
    variables = _variables(JP.Pix2PixNets(JCFG.test_defaults(**ROUTES_OPT)),
                           JCFG.test_defaults(**ROUTES_OPT))
    topt = TCFG.test_defaults(**ROUTES_OPT)
    batch = _batch(topt.semantic_nc)
    lr = TS.lrs_for_epoch(topt, 1)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for route, env in ROUTES.items():
            mp.delenv(C.DW_ENV, raising=False)
            mp.delenv(TL.FUSED_TRAIN_ENV, raising=False)
            if env is not None:
                mp.setenv(*env)
            tnets = TP.Pix2PixNets(topt, device="cpu")
            for name in ("gen", "corr", "disc", "vgg"):
                load_flax_variables(getattr(tnets, name), variables[name])
            tstate = TS.create_train_state(topt, tnets)
            tstep = TST.make_train_step(tnets)
            before = {n: getattr(C, n).plain_calls for n in COUNTED}
            tlosses = []
            records = record_convs(
                lambda: tlosses.append(tstep(tstate, batch, lr)[0]))
            calls = {n: getattr(C, n).plain_calls - before[n]
                     for n in COUNTED}
            predicted = {n: predicted_launches(records)[n] for n in COUNTED}
            tlosses.append(tstep(tstate, batch, lr)[0])
            out[route] = ([{k: float(v) for k, v in ls.items()}
                           for ls in tlosses], calls, predicted)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("route", ["dw all", "fused"])
@pytest.mark.parametrize("key", LOSS_KEYS)
@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
def test_route_train_step_losses_match_the_default_route(runs, route, key,
                                                         step, tol):
    want = runs["default"][0][step]
    got = runs[route][0][step]
    assert set(got) == set(want)
    t, o = want[key], got[key]
    assert np.isfinite(o)
    assert abs(o - t) / (abs(t) + 1e-2) < tol, (route, key, step, t, o)


@pytest.mark.parametrize("route,moves", [
    ("default", ()),
    ("dw all", ("conv3x3_dw",)),
    ("fused", ("conv3x3_fused", "conv3x3_fused_backward"))])
def test_route_runs_its_kernels(runs, route, moves):
    """The route's entries ran in the step (their plain versions), as often
    as the routing predicts from the step's recorded convs, and no other
    conv entry ran: the statistics kernel never runs in training."""
    _, calls, predicted = runs[route]
    assert calls == predicted
    assert all(calls[n] > 0 for n in moves)
    assert all(calls[n] == 0 for n in COUNTED if n not in moves)
