"""The training of the three other published configurations, the port
against the JAX package on the CPU at f32, at tests/test_train_variants.py's
size (crop 64, ngf 8, ndf 8, batch 2), from the same weights (JAX variables
converted with cocosnet_tpu_torch.convert) and the same numpy batch:

- celebahq (mask to face): maskmix, the direct mask loss, --warp_bilinear
  and the cycle warp (--warp_cycle_w 0.1): the row warp at D 22 (3 colours
  and 19 mask columns), the column warp at D 3;
- celebahqedge (edge to face): the row and the column warp at D 3;
- deepfashion (pose to image): --warp_patch (the row warp at D 48, the
  exemplar's 4 x 4 patches), --warp_self_w 100, --video_like, no mask loss.

Each configuration takes the flagship's --use_attention --PONO --PONO_C
--vgg_normal_correct and --adaptor_kernel 4 (tests/test_train_variants.py
holds the JAX package to the same flags, from the reference README's
training command lines).

Checked, with tests/test_torch_train.py's tolerances: every loss of two
train steps (JAX make_train_step against the port's) at rel 2e-3 after
step 0 and 2e-2 after step 1, the loss-key sets equal, the spectral u/v
after one step at 2e-5; the train-mode correspondence net's outputs
(warp_out, warp_mask, warp_cycle, and warp_i2r / warp_i2r2i where the
configuration makes them) at atol 5e-4, tests/test_torch_configs.py's
bound; the shift9 core's calls a step, forward and backward, one for the
row warp and one for each column warp (their plain versions on the CPU).
JAX runs its CPU route (attend_unfold), the port its plain shift9 versions
with use_pallas on. Each configuration's JAX step is compiled once for
the module, at XLA's lowest backend optimization level without LLVM's
expensive passes (torch_fixtures.XLA_QUICK; about half a minute each on
one CPU worker)."""

import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.train import state as JS
from cocosnet_tpu.train import steps as JST
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import flax_path, load_flax_variables
from cocosnet_tpu_torch.models import correspondence as TCR
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.ops import corr as Kc
from cocosnet_tpu_torch.ops import shift9 as S
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_configs import CONFIGS, TRAIN_FLAGS, batch_for
from test_torch_threads import torch_threads  # noqa: F401
from test_torch_train import _batch, _jnp, _spectral, _variables
from torch_fixtures import XLA_QUICK

SMALL = dict(crop_size=64, load_size=64, batchSize=2, ngf=8, ndf=8,
             use_attention=True, PONO=True, PONO_C=True,
             vgg_normal_correct=True, isTrain=True)
# each configuration's inference flags (with --adaptor_kernel 4) and its
# training flags
PUBLISHED = {mode: dict(CONFIGS[mode], **TRAIN_FLAGS[mode])
             for mode in CONFIGS}
# the shift9 core's calls (forward, backward) a train step: the row warp,
# and the column warp of --warp_cycle_w
PUBLISHED_CALLS = {"celebahq": (2, 2), "celebahqedge": (2, 2),
                   "deepfashion": (1, 1)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORR_KEYS = ("warp_out", "warp_mask", "warp_cycle", "warp_i2r",
             "warp_i2r2i")
B, H = 2, 64


def batch_of(opt, seed=0):
    """A loader batch of the configuration's mode: ade20k's class ids
    (tests/test_torch_train.py's), celebahq's ids with a glasses mask, the
    edge and pose modes' dense channels."""
    if opt.dataset_mode == "ade20k":
        return _batch(seed)
    return batch_for(opt.dataset_mode, opt.semantic_nc, B, H, H, seed)


def _corr_outputs_jax(jnets, jopt, variables, batch):
    """The JAX correspondence net's outputs in train mode (one power
    iteration of its spectral norms, as in the step)."""
    def corr(v, d):
        data = JP.preprocess_input(jopt, d)
        out, _ = jnets.corr.apply(v, data["ref_image"], data["real_image"],
                                  data["input_semantics"],
                                  data["ref_semantics"], train=True,
                                  mutable=["spectral"])
        return {k: out[k] for k in CORR_KEYS if k in out}
    args = (_jnp(variables["corr"]), _jnp(batch))
    return {k: np.asarray(v) for k, v in jax.jit(corr).lower(
        *args).compile(XLA_QUICK)(*args).items()}


def _corr_outputs_port(topt, variables, batch):
    nets = TP.Pix2PixNets(topt, device="cpu")
    load_flax_variables(nets.corr, variables["corr"])
    data = TP.preprocess_input(topt, batch, device="cpu")
    nets.set_train(True)
    with torch.no_grad(), TL.training():
        out = TP.generate_fake(nets, data, train=True)
    return {k: out[k].numpy() for k in CORR_KEYS if k in out}


def run_pair(kw, routes=("default",)):
    """Two train steps of the configuration `kw` through JAX
    make_train_step and through the port's on each of `routes`
    ("default", or "mk1 kernels": COCOSNET_PALLAS_MK1_TRAIN=1), from the
    same weights and batch, and the train-mode correspondence outputs of
    both. Returns {"jax": [losses per step], "jax_state0": the JAX state
    after one step, "jax_corr", "port_corr", route: (losses per step,
    the port's state dicts after one step, calls (shift9 forward and
    backward, attend_corr forward and backward) over the two steps)}."""
    jopt = JCFG.test_defaults(**dict(SMALL, **kw))
    topt = TCFG.test_defaults(**dict(SMALL, **kw))
    jnets = JP.Pix2PixNets(jopt)
    variables = _variables(jnets, jopt)
    batch = batch_of(jopt)
    lr = JS.lrs_for_epoch(jopt, 1)
    res = {"jax_corr": _corr_outputs_jax(jnets, jopt, variables, batch),
           "port_corr": _corr_outputs_port(topt, variables, batch)}

    jstate = JS.create_train_state(jopt, _jnp(variables),
                                   jax.random.PRNGKey(1))
    jbatch, jlr = _jnp(batch), jnp.asarray(lr)
    jstep = jax.jit(JST.make_train_step(jnets)).lower(
        jstate, jbatch, jlr).compile(XLA_QUICK)
    res["jax"] = []
    for i in range(2):
        jstate, metrics, _ = jstep(jstate, jbatch, jlr)
        res["jax"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            res["jax_state0"] = jax.tree.map(np.asarray, jstate)

    counted = (S.attend_shift9, S.attend_shift9_backward, Kc.attend_corr,
               Kc.attend_corr_backward)
    for route in routes:
        prev = os.environ.pop(TCR.MK1_TRAIN_ENV, None)
        if route == "mk1 kernels":
            os.environ[TCR.MK1_TRAIN_ENV] = "1"
        try:
            tnets = TP.Pix2PixNets(topt, device="cpu")
            for name in ("gen", "corr", "disc", "vgg"):
                load_flax_variables(getattr(tnets, name), variables[name])
            tstate = TS.create_train_state(topt, tnets)
            tstep = TST.make_train_step(tnets)
            before = [f.plain_calls for f in counted]
            losses, sds = [], None
            for i in range(2):
                got, _ = tstep(tstate, batch, lr)
                losses.append({k: float(v) for k, v in got.items()})
                if i == 0:
                    sds = {name: {k: v.clone() for k, v in
                                  getattr(tnets, name).state_dict().items()}
                           for name in ("gen", "corr", "disc")}
            calls = tuple(f.plain_calls - n for f, n in zip(counted, before))
        finally:
            os.environ.pop(TCR.MK1_TRAIN_ENV, None)
            if prev is not None:
                os.environ[TCR.MK1_TRAIN_ENV] = prev
        res[route] = (losses, sds, calls)
    return res


def check_losses(res, route, step, tol):
    """Equal loss-key sets, every loss finite and within rel `tol` of
    JAX's (|t| + 1e-2 in the denominator)."""
    want, got = res["jax"][step], res[route][0][step]
    assert set(got) == set(want)
    for k, t in want.items():
        assert np.isfinite(got[k]), k
        assert abs(got[k] - t) / (abs(t) + 1e-2) < tol, (k, step, t, got[k])


def check_spectral(res, route, net):
    """The u/v of every spectral conv of `net` after one step (G's and
    Corr's advanced once, D's twice) equal the JAX state's."""
    want = _spectral(res["jax_state0"].variables[net]["spectral"])
    sd = res[route][1][net]
    names = [k for k in sd if k.endswith(("weight_u", "weight_v"))]
    assert len(names) == len(want) > 0
    for name in names:
        _, path, _ = flax_path(name, 1)
        np.testing.assert_allclose(sd[name].numpy(), want[path], atol=2e-5)


def check_corr(res, key):
    """A correspondence output both packages make, or neither."""
    want, got = res["jax_corr"], res["port_corr"]
    assert (key in want) == (key in got)
    if key in want:
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=5e-4)


@pytest.fixture(scope="module")
def published():
    return {mode: run_pair(kw) for mode, kw in PUBLISHED.items()}


@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
@pytest.mark.parametrize("mode", list(PUBLISHED))
def test_train_step_losses_match_jax(published, mode, step, tol):
    check_losses(published[mode], "default", step, tol)


@pytest.mark.parametrize("net", ["gen", "corr", "disc"])
@pytest.mark.parametrize("mode", list(PUBLISHED))
def test_train_step_spectral_state_matches_jax(published, mode, net):
    check_spectral(published[mode], "default", net)


@pytest.mark.parametrize("key", CORR_KEYS)
@pytest.mark.parametrize("mode", list(PUBLISHED))
def test_train_mode_correspondence_matches_jax(published, mode, key):
    check_corr(published[mode], key)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mode", list(PUBLISHED))
def test_loss_terms_of_each_configuration(published, mode):
    """The cycle loss where --warp_cycle_w asks for it, the mask loss on
    celebahq only, the self-warp loss on deepfashion only: the JAX
    package's terms, which chip_smoke.py holds the card's steps to."""
    keys = set(published[mode]["jax"][0])
    assert ("G_warp_cycle" in keys) == (mode != "deepfashion")
    assert ("mask" in keys) == (mode == "celebahq")
    assert ("G_warp_self" in keys) == (mode == "deepfashion")
    assert keys == _chip_smoke().CONFIG_LOSS_KEYS[mode]


def test_chip_smoke_trains_the_flags_held_here():
    """chip_smoke.py's phase 10 runs the training flags these tests hold
    against the JAX package."""
    assert _chip_smoke().CONFIG_TRAIN == TRAIN_FLAGS


@pytest.mark.parametrize("mode", list(PUBLISHED))
def test_train_step_runs_the_shift9_kernels(published, mode):
    """Over two steps, the shift9 core forward and backward once for the
    row warp and once for each column warp a step (their plain versions
    on the CPU), attend_corr never."""
    fwd, bwd = PUBLISHED_CALLS[mode]
    assert published[mode]["default"][2] == (2 * fwd, 2 * bwd, 0, 0)
