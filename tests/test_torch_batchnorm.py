"""The synchronized BatchNorm of the port (nn/norms.py) against the JAX
package's BatchNorm, SPADE (its `syncbatch` param-free norm: the
reference's default norm_G) and NormConv (`spectralsync_batch`), in train
mode (batch moments, running statistics updated) and in eval mode
(running statistics), at f32 on the CPU, un-jitted; the moments' gradient
over two gloo ranks against one process on the whole batch; a BatchNorm
configuration's checkpoint read through the JAX package's importer
(tools/convert_weights); and two train steps of the reference's default
norm with the domain classifier against JAX make_train_step (one compile,
tests/test_torch_variants.run_variant's checks).

Tolerances: outputs and gradients at 1e-5 relative to their scale (the
same f32 math in another framework's order), running statistics at 1e-6."""

import os

import numpy as np
import pytest
import torch
from flax import linen as fnn

import jax
import jax.numpy as jnp

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.nn import norms as JN
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import flax_path, load_flax_variables
from cocosnet_tpu_torch.nn import norms as TN
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_threads import torch_threads  # noqa: F401
from tools.convert_weights import convert_corr, convert_generator
from test_torch_variants import (FLAGSHIP, check_losses, check_state,
                                 check_visuals, run_variant)
from torch_fixtures import bn_worker, condition, spawn_job


def _close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


class _Stats(fnn.Module):
    """JAX's BatchNorm under a parent, so its variables sit at `bn`."""
    features: int
    affine: bool

    @fnn.compact
    def __call__(self, x, train):
        return JN.BatchNorm(self.features, affine=self.affine,
                            name="bn")(x, train)


@pytest.mark.parametrize("shape", [(4, 5, 6, 7), (6, 100)],
                         ids=["nhwc", "features"])
@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_matches_jax(shape, affine):
    """Train mode: the batch moments normalize and the running statistics
    take momentum 0.1 of them (the unbiased variance); the gradients of x
    and of the affine weight and bias agree. Eval mode: the running
    statistics normalize."""
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)
    c = shape[-1]
    jm = _Stats(c, affine)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    if affine:
        variables = {"params": {"bn": {
            "scale": jnp.asarray(rs.rand(c) + 0.5, jnp.float32),
            "bias": jnp.asarray(rs.randn(c), jnp.float32)}},
            "batch_stats": variables["batch_stats"]}
    variables["batch_stats"] = {"bn": {
        "mean": jnp.asarray(rs.randn(c), jnp.float32),
        "var": jnp.asarray(rs.rand(c) + 0.5, jnp.float32)}}

    def jloss(params, x):
        v = dict(variables, params=params) if affine else variables
        y, upd = jm.apply(v, x, True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w)), (y, upd)

    (_, (jy, upd)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables.get("params", {}),
                                              jnp.asarray(x))
    tm = TN.BatchNorm(c, affine=affine)
    with torch.no_grad():
        tm.running_mean.copy_(_t(variables["batch_stats"]["bn"]["mean"]))
        tm.running_var.copy_(_t(variables["batch_stats"]["bn"]["var"]))
        if affine:
            tm.weight.copy_(_t(variables["params"]["bn"]["scale"]))
            tm.bias.copy_(_t(variables["params"]["bn"]["bias"]))
    tx = _t(x).requires_grad_()
    ty = tm.train()(tx)
    (ty * _t(w)).sum().backward()
    _close(ty.detach(), jy, what="train y")
    _close(tx.grad, jgx, what="dx")
    _close(tm.running_mean, upd["batch_stats"]["bn"]["mean"], 1e-6)
    _close(tm.running_var, upd["batch_stats"]["bn"]["var"], 1e-6)
    assert int(tm.num_batches_tracked) == 1
    if affine:
        _close(tm.weight.grad, jgp["bn"]["scale"], what="dscale")
        _close(tm.bias.grad, jgp["bn"]["bias"], what="dbias")
    # eval: the updated running statistics
    jv = dict(variables, batch_stats=upd["batch_stats"])
    je = jm.apply(jv, jnp.asarray(x), False)
    with torch.no_grad():
        te = tm.eval()(_t(x))
    _close(te, je, what="eval y")


def test_batchnorm_keeps_bf16_and_f32_moments():
    """Under bf16 the moments are f32 and the output bf16 (norms.py:92-100):
    the same normalization as the f32 input's, rounded once."""
    x = torch.randn(4, 3, 3, 8, generator=torch.Generator().manual_seed(1))
    bn = TN.BatchNorm(8, affine=False).train()
    y16 = bn(x.bfloat16())
    assert y16.dtype == torch.bfloat16
    y32 = TN.BatchNorm(8, affine=False).train()(x.bfloat16().float())
    torch.testing.assert_close(y16, y32.bfloat16(), rtol=0, atol=0)


def _spade_pair(norm, pono=False):
    """(JAX SPADE, port SPADE with the same drawn weights, inputs)."""
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 8, 8, 16) * 2 + 0.5).astype(np.float32)
    seg = rs.rand(2, 16, 16, 5).astype(np.float32)
    jm = JN.SPADE(norm, 16, 5, pono=pono)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(seg), False)
    variables = {"params": jax.tree.map(
        lambda a: jnp.asarray(rs.randn(*a.shape) * 0.2, jnp.float32),
        variables["params"])}
    variables["batch_stats"] = {"param_free_norm": {
        "mean": jnp.asarray(rs.randn(16) * 0.1, jnp.float32),
        "var": jnp.asarray(rs.rand(16) + 0.5, jnp.float32)}}
    tm = TN.SPADE(norm, 16, 5, pono=pono)
    load_flax_variables(tm, variables)
    return jm, variables, tm, x, seg


@pytest.mark.parametrize("norm", ["spadesyncbatch3x3", "spadebatch3x3"])
def test_spade_batch_matches_jax(norm):
    """SPADE's param-free BatchNorm (norms.py:134-136): train mode with the
    running statistics and the gradient of x, then eval mode."""
    jm, variables, tm, x, seg = _spade_pair(norm)
    w = np.random.RandomState(3).randn(2, 8, 8, 16).astype(np.float32)

    def jloss(x):
        y, upd = jm.apply(variables, x, jnp.asarray(seg), True,
                          mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w)), (y, upd)

    (_, (jy, upd)), jgx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tx = _t(x).requires_grad_()
    ty = tm.train()(tx, _t(seg))
    (ty * _t(w)).sum().backward()
    _close(ty.detach(), jy, what="y")
    _close(tx.grad, jgx, what="dx")
    stats = upd["batch_stats"]["param_free_norm"]
    _close(tm.param_free_norm.running_mean, stats["mean"], 1e-6)
    _close(tm.param_free_norm.running_var, stats["var"], 1e-6)
    je = jm.apply(dict(variables, batch_stats=upd["batch_stats"]),
                  jnp.asarray(x), jnp.asarray(seg), False)
    with torch.no_grad():
        _close(tm.eval()(_t(x), _t(seg)), je, what="eval")


class _Layer(fnn.Module):
    """JAX's NormConv named `layer1`, as the adaptor names it."""
    norm: str

    @fnn.compact
    def __call__(self, x, train):
        return JN.NormConv(8, 3, self.norm, padding=1, name="layer1")(x,
                                                                      train)


class _Holder(torch.nn.Module):
    def __init__(self, norm):
        super().__init__()
        self.layer1 = TN.NormConv(4, 8, 3, norm, padding=1)


@pytest.mark.parametrize("norm", ["spectralsync_batch", "batch"])
def test_normconv_batch_matches_jax(norm):
    """NormConv with a BatchNorm (norms.py:188-190): the conv without bias
    as child 0, the affine BatchNorm as child 1 (layer1.1 <-> layer1/norm),
    in train mode (spectral u/v advance too) and in eval mode."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 6, 6, 4).astype(np.float32)
    jm = _Layer(norm)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    variables = dict(variables)
    variables["params"] = jax.tree.map(
        lambda a: jnp.asarray(rs.randn(*a.shape) * 0.3 + (
            1.0 if a.ndim == 1 else 0.0), jnp.float32), variables["params"])
    mutable = [k for k in variables if k != "params"]
    jy, upd = jm.apply(variables, jnp.asarray(x), True, mutable=mutable)
    holder = _Holder(norm)
    load_flax_variables(holder, variables)
    sd = holder.state_dict()
    assert "layer1.1.running_mean" in sd and "layer1.0.bias" not in sd
    ty = holder.layer1.train()(_t(x))
    _close(ty.detach(), jy, what="train")
    _close(holder.layer1._modules["1"].running_var,
           upd["batch_stats"]["layer1"]["norm"]["var"], 1e-6)
    if norm.startswith("spectral"):
        _close(holder.layer1._modules["0"].weight_u,
               upd["spectral"]["layer1"]["conv"]["u"], 1e-5)
    je = jm.apply({**variables, **upd}, jnp.asarray(x), False)
    with torch.no_grad():
        _close(holder.layer1.eval()(_t(x)), je, what="eval")


def test_unknown_norms_are_refused():
    """A norm neither package has is refused, in SPADE and in NormConv."""
    with pytest.raises(ValueError, match="param-free norm"):
        TN.SPADE("spadegroup3x3", 8, 3)
    with pytest.raises(ValueError, match="not recognized"):
        TN.NormConv(4, 8, 3, "spectralgroup")


def test_synchronized_moments_over_two_ranks(tmp_path):
    """Two gloo ranks, each with half the batch, against one process on the
    whole batch: the output and the running statistics are the whole
    batch's; each rank's dx is d(both ranks' losses)/d(its shard) (the
    moments' gradient crosses the ranks); the affine gradients sum to the
    one process's."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy((rs.randn(4, 3, 5, 6) * 2 + 1).astype(np.float32))
    w = torch.from_numpy(rs.randn(4, 3, 5, 6).astype(np.float32))
    spawn_job(bn_worker, 2, tmp_path, 2, 1, x, w, str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    bn = TN.BatchNorm(6).train()
    xs = x.clone().requires_grad_()
    y = bn(xs)
    (y * w).sum().backward()
    _close(torch.cat([r[0] for r in ranks]), y.detach(), what="y")
    _close(torch.cat([r[1] for r in ranks]), xs.grad, what="dx")
    _close(ranks[0][2] + ranks[1][2], bn.weight.grad, what="dweight")
    _close(ranks[0][3] + ranks[1][3], bn.bias.grad, what="dbias")
    for r in ranks:
        _close(r[4], bn.running_mean, 1e-6)
        _close(r[5], bn.running_var, 1e-6)


OPT_A = dict(dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
             crop_size=64, load_size=64, batchSize=2, ngf=8, ndf=8,
             use_attention=True, maskmix=True, warp_mask_losstype="direct",
             weight_mask=100.0, isTrain=True)


def _batch(seed, b=2, h=64, nc=13):
    rs = np.random.RandomState(seed)
    return {"label": rs.randint(0, nc, (b, h, h, 1)).astype(np.float32),
            "image": (rs.rand(b, h, h, 3) * 2 - 1).astype(np.float32),
            "ref": (rs.rand(b, h, h, 3) * 2 - 1).astype(np.float32),
            "label_ref": rs.randint(0, nc, (b, h, h, 1)).astype(np.float32),
            "self_ref": np.ones((b,), np.float32)}


def _structure(init):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        dict(jax.eval_shape(init)))


def test_jax_reads_a_batchnorm_checkpoint(tmp_path):
    """The reference's default norm (syncbatch SPADE, no PONO) with the
    domain classifier: one port train step moves every running statistic;
    the checkpoint holds them under the reference's names
    (...param_free_norm.running_mean, num_batches_tracked) beside
    net_DomainClassifier.pth; JAX's importer (tools/convert_weights) reads
    net_G.pth and net_Corr.pth into exactly the variables of JAX's own
    nets, batch_stats included, with the port's values; the port reloads
    the checkpoint bit for bit."""
    opt = TCFG.test_defaults(**OPT_A, checkpoints_dir=str(tmp_path),
                             name="bn", weight_domainC=1.0, domain_rela=True)
    nets = TP.Pix2PixNets(opt, device="cpu")
    for i, net in enumerate(nets.modules()):
        condition(net, i)
    state = TS.create_train_state(opt, nets)
    before = nets.gen.head_0.norm_0.param_free_norm.running_mean.clone()
    TST.make_train_step(nets)(state, _batch(0), TS.lrs_for_epoch(opt, 1))
    stats = nets.gen.head_0.norm_0.param_free_norm
    assert not torch.equal(stats.running_mean, before)
    assert int(stats.num_batches_tracked) == 1
    path = C.save_state(opt, state, nets, "latest")
    assert os.path.exists(os.path.join(path, C.DOMAIN_FILE))

    jopt = JCFG.test_defaults(**dict(OPT_A, isTrain=False))
    jnets = JP.Pix2PixNets(jopt)
    key = jax.random.PRNGKey(0)
    b, h = 2, 64
    sem = jnp.zeros((b, h, h, jopt.semantic_nc))
    img = jnp.zeros((b, h, h, 3))
    cbn = jnp.zeros((b, h, h, 3 + jopt.semantic_nc))
    inits = {"gen": lambda: jnets.gen.init(key, sem, cbn, train=False),
             "corr": lambda: jnets.corr.init(key, img, None, sem, sem,
                                             train=False)}
    for net, fname, convert in (("gen", "net_G.pth", convert_generator),
                                ("corr", "net_Corr.pth", convert_corr)):
        template = jax.eval_shape(inits[net])
        got = convert(os.path.join(path, fname))
        want = dict(jax.tree_util.tree_leaves_with_path(dict(template)))
        leaves = dict(jax.tree_util.tree_leaves_with_path(got))
        assert set(leaves) == set(want), net
        assert any("batch_stats" in str(p) for p in leaves)
        for k, v in getattr(nets, net).state_dict().items():
            collection, fpath, kind = flax_path(k, v.dim())
            if kind == "keep":
                continue
            leaf = got[collection]
            for part in fpath:
                leaf = leaf[part]
            leaf = np.asarray(leaf)
            if kind == "hwio":
                leaf = leaf.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(leaf.reshape(v.shape), v.numpy(),
                                          err_msg=k)
    again = TP.Pix2PixNets(opt, device="cpu")
    state2 = TS.create_train_state(opt, again)
    C.load_state(opt, state2, again, "latest")
    for net in ("gen", "corr", "domain_classifier"):
        for k, v in getattr(nets, net).state_dict().items():
            assert torch.equal(getattr(again, net).state_dict()[k], v), k


# ------------------------------------------------- the training, vs JAX

BN_CONFIG = dict(FLAGSHIP, PONO=False, PONO_C=False, weight_domainC=1.0,
                 domain_rela=True)


@pytest.fixture(scope="module")
def bn_steps():
    with pytest.MonkeyPatch.context() as mp:
        return run_variant(BN_CONFIG, mp)


@pytest.mark.parametrize("step,tol", [(0, 2e-3), (1, 2e-2)])
def test_batchnorm_config_losses_match_jax(bn_steps, step, tol):
    """The reference's default norm_G (spectralspadesyncbatch3x3) without
    --PONO, with the domain classifier beside D: two steps' losses."""
    check_losses(bn_steps, step, tol)


@pytest.mark.parametrize("net", ["gen", "corr", "disc"])
def test_batchnorm_config_state_matches_jax(bn_steps, net):
    """After one step: the spectral u/v at 2e-5, and every running mean and
    variance (G's and Corr's SPADE norms, updated once a forward; the
    exemplar adaptor's twice, for the exemplar and the real image) at rel
    2e-3."""
    assert check_state(bn_steps, net, ("weight_u", "weight_v"), "spectral",
                       2e-5) > 0
    n = check_state(bn_steps, net, ("running_mean", "running_var"),
                    "batch_stats", 2e-3, rel=True)
    assert n > 0 or net == "disc"


def test_batchnorm_config_correspondence_matches_jax(bn_steps):
    check_visuals(bn_steps)


def test_batchnorm_config_counts_its_forwards(bn_steps):
    """num_batches_tracked: one train forward of G's norms a step, two of
    the exemplar adaptor's; the domain classifier's parameters stay where
    they were (no loss reaches them)."""
    sd = bn_steps["port_sd0"]
    assert int(sd["gen"]["head_0.norm_0.param_free_norm."
                         "num_batches_tracked"]) == 1
    assert int(sd["corr"]["adaptive_model_img.head_0.norm_0."
                          "param_free_norm.num_batches_tracked"]) == 2
    dc = bn_steps["nets"].domain_classifier
    want = bn_steps["jax_state0"].variables["domain_classifier"]["params"]
    np.testing.assert_array_equal(dc.fc0.weight.detach().numpy(),
                                  want["fc0"]["kernel"].T)
