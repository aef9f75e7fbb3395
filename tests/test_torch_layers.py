"""The port's layers and norms against the JAX package and against their
definitions, with the traps a port falls into: the unbiased PONO variance
beside the biased instance-norm one, eval-mode spectral norm without a
power iteration, the bf16 policy."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.nn import layers as JL
from cocosnet_tpu.nn import norms as JN
from cocosnet_tpu_torch.convert import load_flax_variables
from cocosnet_tpu_torch.nn import layers as L
from cocosnet_tpu_torch.nn import norms as N
from test_torch_threads import torch_threads  # noqa: F401


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_positional_norm_is_unbiased_and_instance_norm_biased():
    x = _x(0, 2, 5, 6, 7) * 3 + 1
    pono = N.positional_norm(torch.from_numpy(x)).numpy()
    inorm = N.instance_norm(torch.from_numpy(x)).numpy()
    mc = x.mean(-1, keepdims=True)
    np.testing.assert_allclose(
        pono, (x - mc) / np.sqrt(x.var(-1, ddof=1, keepdims=True) + 1e-5),
        atol=1e-5)
    ms = x.mean((1, 2), keepdims=True)
    np.testing.assert_allclose(
        inorm, (x - ms) / np.sqrt(x.var((1, 2), ddof=0, keepdims=True)
                                  + 1e-5), atol=1e-5)
    np.testing.assert_allclose(pono, np.asarray(JN.positional_norm(
        jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(inorm, np.asarray(JN.instance_norm(
        jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("weight_norm", ["spectral", "equal_lr", None])
def test_conv2d_module_matches_jax_eval(weight_norm):
    """Eval-mode spectral norm: sigma = u.(W v) from the stored vectors,
    which stay as they were; with u/v not the singular vectors sigma is not
    the spectral norm, and both packages must still agree."""
    x = _x(1, 2, 6, 8, 5)
    jmod = JL.Conv2d(7, 3, padding=1, weight_norm=weight_norm)
    variables = jax.tree.map(np.asarray, dict(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    variables["params"]["bias"] = _x(2, 7)
    want = np.asarray(jmod.apply(jax.tree.map(jnp.asarray, variables),
                                 jnp.asarray(x)))
    tmod = L.Conv2d(5, 7, 3, padding=1, weight_norm=weight_norm)
    load_flax_variables(tmod, variables)
    tmod.eval()   # a module in train mode advances its power iteration
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), f"{k} moved in eval"
    if weight_norm == "spectral":
        w = before["weight_orig"].reshape(7, -1)
        sigma = before["weight_u"] @ w @ before["weight_v"]
        torch.testing.assert_close(tmod.effective_weight(),
                                   before["weight_orig"] / sigma)


def test_one_hot_labels_dense_matches_jax():
    lab = np.random.RandomState(3).randint(-1, 9, (2, 4, 5)).astype(np.int32)
    got = L.OneHotLabels(torch.from_numpy(lab), 8).dense().numpy()
    want = np.asarray(JL.OneHotLabels(jnp.asarray(lab), 8).dense())
    np.testing.assert_array_equal(got, want)
    assert L.OneHotLabels(torch.from_numpy(lab), 8).shape == (2, 4, 5, 8)


def test_prelu_and_leaky_relu():
    x = _x(4, 3, 4)
    p = L.PReLU()
    p.reset_parameters(torch.Generator())
    np.testing.assert_allclose(p(torch.from_numpy(x)).detach().numpy(),
                               np.where(x >= 0, x, 0.25 * x))
    np.testing.assert_allclose(L.leaky_relu(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.leaky_relu(jnp.asarray(x))))


def test_bf16_policy_rounds_operands_and_output():
    """Under the bf16 policy a conv's operands and output are bf16 and the
    accumulation f32: the result is the f32 conv of the rounded operands,
    rounded once."""
    x = torch.from_numpy(_x(5, 1, 6, 6, 8))
    k = torch.from_numpy(_x(6, 3, 3, 8, 4))
    prev = L.get_compute_dtype()
    L.set_compute_dtype(torch.bfloat16)
    try:
        y = L.conv2d(x, k, padding=1)
    finally:
        L.set_compute_dtype(prev)
    assert y.dtype == torch.bfloat16
    want = L.conv2d(x.bfloat16().float(), k.bfloat16().float(), padding=1)
    torch.testing.assert_close(y.float(), want.bfloat16().float())


def test_init_is_seeded():
    a, b = L.Conv2d(4, 8, 3, weight_norm="spectral"), \
        L.Conv2d(4, 8, 3, weight_norm="spectral")
    L.init_weights(a, torch.Generator().manual_seed(3))
    L.init_weights(b, torch.Generator().manual_seed(3))
    for (k, v), (_, w) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(v, w), k
    std = float(a.weight_orig.std())
    assert 0.5 * 0.02 * (2 / (36 + 72)) ** 0.5 < std < 0.02
