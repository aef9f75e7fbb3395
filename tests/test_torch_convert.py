"""JAX variables -> the port's state dicts (cocosnet_tpu_torch.convert) ->
the JAX package's own torch importer (train/checkpoints.convert_torch_module
with default_name_map) gives back every leaf of both nets, exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.train.checkpoints import (convert_torch_module,
                                            default_name_map)
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import flax_path, load_flax_variables
from test_torch_threads import torch_threads  # noqa: F401

OPT = dict(dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
           crop_size=64, load_size=64, batchSize=2, ngf=8,
           use_attention=True, maskmix=True, PONO=True, PONO_C=True,
           warp_mask_losstype="direct", isTrain=False)


def _random_variables(init, seed):
    """Every leaf of the structure `init` gives (from jax.eval_shape, so
    nothing is compiled) drawn at random."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(init)
    return jax.tree.map(
        lambda s: np.asarray(rs.randn(*s.shape), np.float32), dict(shapes))


@pytest.fixture(scope="module")
def nets_and_variables():
    jopt = JCFG.test_defaults(**OPT)
    jnets = JP.Pix2PixNets(jopt)
    key = jax.random.PRNGKey(0)
    b, h, nc = 2, 64, jopt.semantic_nc
    sem = jnp.zeros((b, h, h, nc))
    img = jnp.zeros((b, h, h, 3))
    cbn = jnp.zeros((b, h, h, 3 + nc))
    variables = {
        "gen": _random_variables(
            lambda: jnets.gen.init(key, sem, cbn, train=False), 0),
        "corr": _random_variables(
            lambda: jnets.corr.init(key, img, None, sem, sem, train=False),
            1)}
    tnets = TP.Pix2PixNets(TCFG.test_defaults(**OPT), device="cpu")
    return tnets, variables


@pytest.mark.parametrize("net", ["gen", "corr"])
def test_round_trip_gives_back_every_leaf(nets_and_variables, net):
    tnets, variables = nets_and_variables
    module = getattr(tnets, net)
    load_flax_variables(module, variables[net])
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    back = convert_torch_module(sd, default_name_map)
    want = jax.tree_util.tree_leaves_with_path(variables[net])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def test_mk1_corr_round_trip_gives_back_every_leaf():
    """At match_kernel=1 the JAX net's theta/phi are created in _descriptor,
    with the same names and shapes as the match_kernel=3 branch's: the
    port's mapping carries them unchanged."""
    kw = dict(OPT, match_kernel=1)
    jnets = JP.Pix2PixNets(JCFG.test_defaults(**kw))
    b, h = 2, 64
    nc = jnets.opt.semantic_nc
    sem = jnp.zeros((b, h, h, nc))
    img = jnp.zeros((b, h, h, 3))
    variables = _random_variables(
        lambda: jnets.corr.init(jax.random.PRNGKey(0), img, None, sem, sem,
                                train=False), 2)
    assert {"theta", "phi"} <= set(variables["params"])
    module = TP.Pix2PixNets(TCFG.test_defaults(**kw), device="cpu").corr
    load_flax_variables(module, variables)
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    back = dict(jax.tree_util.tree_leaves_with_path(
        convert_torch_module(sd, default_name_map)))
    want = jax.tree_util.tree_leaves_with_path(variables)
    assert len(back) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(back[path]), leaf)


@pytest.mark.parametrize("name,ndim,want", [
    ("adaptive_model_seg.layer1.0.weight_orig", 4,
     ("params", ("adaptive_model_seg", "layer1", "conv", "kernel"), "hwio")),
    ("layer.2.conv1.bias", 1, ("params", ("layer_2", "conv1", "bias"),
                               "same")),
    ("layer.0.prelu.weight", 1, ("params", ("layer_0", "prelu", "alpha"),
                                 "reshape")),
    ("up_1.norm_s.mlp_shared.1.weight", 4,
     ("params", ("up_1", "norm_s", "mlp_shared", "kernel"), "hwio")),
    ("attn.gamma", 1, ("params", ("attn", "gamma"), "reshape")),
    ("head_0.conv_0.weight_u", 1, ("spectral", ("head_0", "conv_0", "u"),
                                   "same")),
])
def test_flax_path(name, ndim, want):
    assert flax_path(name, ndim) == want
