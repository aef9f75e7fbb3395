"""Two match_kernel=1 train steps of the port against JAX make_train_step on
the CPU at f32, on both of the port's routes for the correlation:
- "library": the default, ops/correlation.attend (matmul, softmax and
  autograd), as the JAX package trains match_kernel=1 through XLA;
- "kernels": COCOSNET_PALLAS_MK1_TRAIN=1, ops/corr.attend_corr forward and
  backward (their plain versions on the CPU), as the JAX package's switch
  of the same name puts training on its Pallas kernel;
- "use_pallas off": COCOSNET_PALLAS_MK1_TRAIN=1 with opt.use_pallas False,
  which overrides it (correspondence.py:314-319): the library route again.
The JAX side takes its XLA attend on the CPU either way (its Pallas gate
needs a TPU), so one JAX run serves all three.

The flags, size, weights and batch are tests/test_torch_train.py's
(flagship flags, crop 64, ngf 8 / ndf 8, label_nc 5, batch 2), with
match_kernel=1; so are the tolerances: the losses of the first step at rel
2e-3 and of the second at 2e-2 (|t| + 1e-2 in the denominator; measured
5.0e-6 at step 0 on both routes, 1.4e-4 on the library route and 6.9e-5
on the kernel route at step 1), the spectral u/v after the first step at
2e-5. The JAX step is jitted once for the module."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.train import state as JS
from cocosnet_tpu.train import steps as JST
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import flax_path, load_flax_variables
from cocosnet_tpu_torch.models import correspondence as TCR
from cocosnet_tpu_torch.ops import corr as K
from cocosnet_tpu_torch.ops import shift9 as S
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_train import (LOSS_KEYS, OPT, _batch, _jnp, _spectral,
                              _variables)
from test_torch_threads import torch_threads  # noqa: F401

MK1 = dict(OPT, match_kernel=1)
ROUTES = ("library", "kernels", "use_pallas off")
COUNTED = (K.attend_corr, K.attend_corr_backward, S.attend_shift9,
           S.attend_shift9_backward)


@pytest.fixture(scope="module")
def runs():
    """{"jax": (losses per step, states per step), route: (losses per step,
    state-dict snapshot after step 0, plain calls per counted entry)}."""
    jopt = JCFG.test_defaults(**MK1)
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
    out = {"jax": (jlosses, jstates)}

    mp = pytest.MonkeyPatch()
    try:
        for route in ROUTES:
            if route == "library":
                mp.delenv(TCR.MK1_TRAIN_ENV, raising=False)
            else:
                mp.setenv(TCR.MK1_TRAIN_ENV, "1")
            topt = TCFG.test_defaults(**dict(
                MK1, use_pallas=route != "use_pallas off"))
            tnets = TP.Pix2PixNets(topt, device="cpu")
            for name in ("gen", "corr", "disc", "vgg"):
                load_flax_variables(getattr(tnets, name), variables[name])
            tstate = TS.create_train_state(topt, tnets)
            tstep = TST.make_train_step(tnets)
            before = [f.plain_calls for f in COUNTED]
            tlosses, snap = [], None
            for _ in range(2):
                losses, _ = tstep(tstate, batch, lr)
                tlosses.append({k: float(v) for k, v in losses.items()})
                if snap is None:
                    snap = {name: {k: v.clone() for k, v in
                                   getattr(tnets, name).state_dict().items()}
                            for name in ("gen", "corr", "disc")}
            calls = {f.__name__: f.plain_calls - n
                     for f, n in zip(COUNTED, before)}
            out[route] = (tlosses, snap, calls)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("key", LOSS_KEYS)
@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
def test_mk1_train_step_losses_match_jax(runs, route, key, step, tol):
    jlosses, _ = runs["jax"]
    tlosses, *_ = runs[route]
    assert set(tlosses[step]) == set(jlosses[step])
    t, o = jlosses[step][key], tlosses[step][key]
    assert np.isfinite(o)
    assert abs(o - t) / (abs(t) + 1e-2) < tol, (route, key, step, t, o)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("net", ["gen", "corr", "disc"])
def test_mk1_train_step_spectral_state_matches_jax(runs, route, net):
    _, jstates = runs["jax"]
    _, snap, _ = runs[route]
    want = _spectral(jstates[0].variables[net]["spectral"])
    sd = snap[net]
    names = [k for k in sd if k.endswith(("weight_u", "weight_v"))]
    assert len(names) == len(want) > 0
    for name in names:
        _, path, _ = flax_path(name, 1)
        np.testing.assert_allclose(sd[name].numpy(), want[path], atol=2e-5)


@pytest.mark.parametrize("route,want", [
    ("library", {"attend_corr": 0, "attend_corr_backward": 0}),
    ("kernels", {"attend_corr": 2, "attend_corr_backward": 2}),
    ("use_pallas off", {"attend_corr": 0, "attend_corr_backward": 0})])
def test_mk1_train_route(runs, route, want):
    """Two steps: the library route leaves attend_corr alone; the kernel
    route runs its forward and backward once per step; use_pallas False
    keeps the library route under COCOSNET_PALLAS_MK1_TRAIN=1. None runs
    shift9."""
    *_, calls = runs[route]
    assert calls == dict(want, attend_shift9=0, attend_shift9_backward=0)
