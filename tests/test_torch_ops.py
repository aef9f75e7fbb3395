"""The port's image ops and the plain versions of its conv kernels against
the JAX package: image ops exactly, the conv entries against the Pallas
kernels run in interpret mode (as tests/test_pallas_conv.py runs them), at
that file's tolerance, atol/rtol 1e-4. Also the conv2d routing and the
launch/plain counters, on CPU tensors."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from cocosnet_tpu.ops import image as JI
from cocosnet_tpu.ops import pallas_conv as JC
from cocosnet_tpu_torch.nn import layers as L
from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.ops import image as I
from test_torch_threads import torch_threads  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _x(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- image ops

@pytest.mark.parametrize("size", [(16, 16), (24, 40), (7, 5), (64, 64)])
def test_resize_nearest_matches_jax_and_torch(size):
    """torch 'nearest' index rule src = floor(dst * in/out): equal to the
    JAX op and to F.interpolate itself, for up, down and odd factors."""
    x = _x(np.random.RandomState(0), 2, 32, 48, 3)
    got = I.resize_nearest(_t(x), *size)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JI.resize_nearest(jnp.asarray(x), *size)))
    want = F.interpolate(_t(x).permute(0, 3, 1, 2), size=size,
                         mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_upsample_and_pools_match_jax():
    x = _x(np.random.RandomState(1), 2, 8, 12, 5)
    xj, xt = jnp.asarray(x), _t(x)
    np.testing.assert_array_equal(I.upsample_nearest(xt, 4).numpy(),
                                  np.asarray(JI.upsample_nearest(xj, 4)))
    np.testing.assert_allclose(I.avg_pool(xt, 4).numpy(),
                               np.asarray(JI.avg_pool(xj, 4)), atol=1e-6)
    np.testing.assert_array_equal(I.max_pool(xt, 2).numpy(),
                                  np.asarray(JI.max_pool(xj, 2)))


def test_one_hot_scatter_matches_jax():
    """Ids outside [0, C), the -1 sentinel among them, give zero rows."""
    lab = np.random.RandomState(2).randint(-1, 14, (2, 6, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        I.one_hot_scatter(_t(lab), 12).numpy(),
        np.asarray(JI.one_hot_scatter(jnp.asarray(lab), 12)))


# ---------------------------------------------------------------- dense conv

@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 64), (1, 4, 16, 151, 128)])
def test_conv3x3_fused_matches_pallas(shape, reflect):
    b_, h, w, ci, co = shape
    rs = np.random.RandomState(0)
    x, k, b = _x(rs, b_, h, w, ci), _x(rs, 3, 3, ci, co, scale=0.05), \
        _x(rs, co)
    want = JC.conv3x3_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                            reflect=reflect)
    got = C.conv3x3_fused(_t(x), _t(k), _t(b), reflect=reflect)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv3x3_fused_leaky_matches_pallas():
    rs = np.random.RandomState(1)
    x, k, b = _x(rs, 1, 8, 16, 64), _x(rs, 3, 3, 64, 64, scale=0.05), \
        _x(rs, 64)
    want = JC.conv3x3_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                            leaky=0.2)
    got = C.conv3x3_fused(_t(x), _t(k), _t(b), leaky=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 64), (1, 4, 16, 151, 135)])
def test_conv3x3_fused_stats_matches_pallas(shape, reflect):
    b_, h, w, ci, co = shape
    rs = np.random.RandomState(3)
    x, k, b = _x(rs, b_, h, w, ci), _x(rs, 3, 3, ci, co, scale=0.05), \
        _x(rs, co)
    want = JC.conv3x3_fused_stats(jnp.asarray(x), jnp.asarray(k),
                                  jnp.asarray(b), reflect=reflect)
    got = C.conv3x3_fused_stats(_t(x), _t(k), _t(b), reflect=reflect)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


def test_stats_single_pass_variance_against_two_pass():
    """The stats entries take the variance single-pass, E[y^2] - E[y]^2
    clamped at 0, as the kernel does; the JAX package off the TPU takes it
    two-pass (nn/layers.conv2d). At activations whose mean is several
    times their spread (|mean|/std ~ 8 here) the two agree to 1e-4
    relative in f32; the clamp keeps a constant channel at 0, not
    negative."""
    rs = np.random.RandomState(4)
    x, k = _x(rs, 2, 16, 16, 64), _x(rs, 3, 3, 64, 64, scale=0.05)
    b = np.full(64, 8.0, np.float32)
    y, mean, var = C.conv3x3_fused_stats(_t(x), _t(k), _t(b))
    y64 = y.double()
    np.testing.assert_allclose(mean.numpy()[:, 0, 0],
                               y64.mean(dim=(1, 2)).numpy(), atol=1e-5)
    np.testing.assert_allclose(var.numpy()[:, 0, 0],
                               y64.var(dim=(1, 2), unbiased=False).numpy(),
                               rtol=1e-4, atol=1e-6)
    _, _, var0 = C.conv3x3_fused_stats(_t(x), _t(np.zeros_like(k)), _t(b))
    assert float(var0.min()) >= 0.0


# ---------------------------------------------------------------- one-hot

@pytest.mark.parametrize("nc,co", [(151, 64), (128, 128)])
def test_conv3x3_onehot_matches_pallas(nc, co):
    rs = np.random.RandomState(7)
    lab = rs.randint(0, nc, (2, 8, 128)).astype(np.int32)
    k, b = _x(rs, 3, 3, nc, co, scale=0.05), _x(rs, co)
    want = JC.conv3x3_onehot(jnp.asarray(lab), jnp.asarray(k), jnp.asarray(b),
                             dtype=jnp.float32)
    got = C.conv3x3_onehot(_t(lab), _t(k), _t(b), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv3x3_onehot_stats_leaky_matches_pallas():
    rs = np.random.RandomState(8)
    nc, co = 151, 64
    lab = rs.randint(0, nc, (1, 8, 128)).astype(np.int32)
    k, b = _x(rs, 3, 3, nc, co, scale=0.05), _x(rs, co)
    want = JC.conv3x3_onehot(jnp.asarray(lab), jnp.asarray(k), jnp.asarray(b),
                             dtype=jnp.float32, leaky=0.2, want_stats=True)
    got = C.conv3x3_onehot(_t(lab), _t(k), _t(b), dtype=torch.float32,
                           leaky=0.2, want_stats=True)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


def test_conv3x3_onehot_sentinel_and_out_of_range_ids():
    """Ids outside [0, C), the -1 sentinel among them, contribute nothing:
    the same as a zero one-hot row, at the ring and inside the image."""
    rs = np.random.RandomState(9)
    nc, co = 19, 64
    lab = rs.randint(-1, nc + 2, (2, 6, 10)).astype(np.int32)
    k, b = _x(rs, 3, 3, nc, co, scale=0.05), _x(rs, co)
    dense = (lab[..., None] == np.arange(nc)).astype(np.float32)
    want = C.conv3x3_plain(_t(dense), _t(k), _t(b))
    got = C.conv3x3_onehot(_t(lab), _t(k), _t(b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# ---------------------------------------------------------------- routing

def _counts():
    return {f.__name__: f.plain_calls for f in
            (C.conv3x3_fused, C.conv3x3_fused_stats, C.conv3x3_onehot)}


@pytest.mark.parametrize("case,route", [
    (dict(x=(1, 8, 256, 64), k=64, padding=1), "conv3x3_fused"),
    (dict(x=(1, 8, 256, 64), k=64, reflect=True), "conv3x3_fused"),
    (dict(x=(1, 8, 256, 64), k=64, padding=1, want_stats=True),
     "conv3x3_fused_stats"),
    (dict(x=(1, 8, 256, 64), k=64, onehot=True, padding=1, want_stats=True),
     "conv3x3_onehot"),
    (dict(x=(1, 8, 256, 64), k=32, padding=1), None),        # cout < 64
    (dict(x=(1, 8, 128, 64), k=64, padding=1), None),        # h*w < 2048
    (dict(x=(1, 16, 256, 64), k=64, padding=1, stride=2), None),
    (dict(x=(1, 8, 256, 3), k=64, padding=1), None),         # 3 channels
])
def test_conv2d_routing(case, route):
    """conv2d sends a conv to the entry the JAX package sends to Pallas on
    a TPU, and everything else to F.conv2d; on CPU tensors each entry runs
    its plain version and counts it there, never as a launch."""
    rs = np.random.RandomState(10)
    b_, h, w, c = case["x"]
    k = _t(_x(rs, 3, 3, c, case["k"], scale=0.05))
    bias = _t(_x(rs, case["k"]))
    if case.get("onehot"):
        lab = _t(rs.randint(0, c, (b_, h, w)).astype(np.int32))
        x = L.OneHotLabels(lab, c)
        dense = x.dense()
    else:
        x = dense = _t(_x(rs, b_, h, w, c))
    kw = dict(stride=case.get("stride", 1), padding=case.get("padding", 0),
              reflect=case.get("reflect", False),
              want_stats=case.get("want_stats", False))
    before = _counts()
    launches = [f.launches for f in (C.conv3x3_fused, C.conv3x3_fused_stats,
                                     C.conv3x3_onehot)]
    got = L.conv2d(x, k, bias, **kw)
    moved = {n for n, v in _counts().items() if v != before[n]}
    assert moved == ({route} if route else set())
    assert launches == [f.launches for f in (
        C.conv3x3_fused, C.conv3x3_fused_stats, C.conv3x3_onehot)]
    xc = dense.permute(0, 3, 1, 2)
    if kw["reflect"]:
        xc = F.pad(xc, (1, 1, 1, 1), mode="reflect")
    want = F.conv2d(xc, k.permute(3, 2, 0, 1), bias, stride=kw["stride"],
                    padding=kw["padding"]).permute(0, 2, 3, 1)
    y = got[0] if kw["want_stats"] else got
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-5)


def test_kernel_entries_refuse_other_devices():
    """A wrapper takes its plain version only for a CPU tensor; any other
    device launches the kernel or raises, never falls back."""
    x = torch.zeros(1, 8, 16, 64, device="meta")
    k = torch.zeros(3, 3, 64, 64, device="meta")
    with pytest.raises(ValueError):
        C.conv3x3_fused(x, k)
    with pytest.raises(ValueError):
        C.conv3x3_fused_stats(x, k)
    with pytest.raises(ValueError):
        C.conv3x3_onehot(torch.zeros(1, 8, 16, dtype=torch.int32,
                                     device="meta"), k)
