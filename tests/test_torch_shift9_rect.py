"""The port's shift9 core at a query count Nq and a key count Nk that
differ (ops/shift9.shift9_core_plain, shift9_bwd_plain and the autograd
Function _Shift9Core on CPU tensors), against the JAX package's Pallas core
`pallas_shift9._core` at the same nq != nk in interpret mode, against the
matching rows of the port's square result, and against an f64 reference
formed from explicit 3x3-unfold descriptors.

Two forms of nq != nk:
- a query shard, nq < nk: image rows [r0, r0 + hl) of the queries' map
  against every key, the inputs cut from shift9_inputs of the whole maps,
  as ops/corr_sp.py cuts them (its rows of f3 and qv). Its output is the
  square result's rows r0 W .. (r0 + hl) W, held at 2e-5 (the same f32
  products; the softmax's row sums over the same keys);
- a wide query map, nq > nk: a query image of Hq rows against a key image
  of Hk < Hq rows, each side's inputs from its own map (PONO_C: the query
  terms read only the queries' map). Held against the f64 descriptors at
  2e-5.

Tolerances: the Pallas core multiplies in bf16x3, 3e-4 on the forward as
tests/test_torch_shift9.py holds the square form; the gradients through
_Shift9Core against jax.grad of _core at atol = rtol = 2e-3, the bound of
tests/test_corr_sp.py:180 and tests/test_torch_shift9_grad.py, at D 3 as
that JAX test runs (at D 22 the bf16x3 core puts a few of dkv's ks entries,
whose scale is ~100, 6e-3 to 9e-3 from the port, whose own f32 and f64
runs agree to 1e-5 of scale there); the plain backward against autograd of
the plain forward in f64 at 1e-10 of each output's largest magnitude, on
every shape (the same products, reassociated; in f32 dqs = sum_j gl
logits / qs cancels, as tests/test_torch_shift9_grad.py notes).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.ops.pallas_shift9 import _core as j_core
from cocosnet_tpu_torch.ops import shift9 as S
from test_torch_threads import torch_threads  # noqa: F401

TAU = 0.01
# (H, W, C, D, r0, hl): query shards of an H x W map, nq = hl W < nk = H W;
# hl = 1 is a shard of one image row, r0 = 0 and r0 + hl = H the shards at
# the map's edges, whose outer halo rows are the unfold's zero padding
SHARDS = [(8, 8, 16, 3, 0, 4), (8, 8, 16, 22, 4, 4), (8, 8, 16, 3, 3, 1),
          (12, 8, 16, 48, 9, 3)]
# (Hq, Hk, W, C, D): nq = Hq W > nk = Hk W
WIDE = [(8, 4, 8, 16, 3), (6, 2, 8, 16, 22)]


def _maps(h, w, c, d, seed, hk=None):
    rs = np.random.RandomState(seed)
    f = rs.randn(2, h, w, c).astype(np.float32)
    g = (rs.randn(2, h if hk is None else hk, w, c) * 1.5
         + 0.2).astype(np.float32)
    v = rs.randn(2, (h if hk is None else hk) * w, d).astype(np.float32)
    return f, g, v


def _shard_inputs(shape, pono_c, seed=3):
    """(f3, g3, v, qv, kv) of the query shard, and the whole maps' square
    inputs."""
    h, w, c, d, r0, hl = shape
    f, g, v = (torch.from_numpy(a) for a in _maps(h, w, c, d, seed))
    f3, g3, qv, kv = S.shift9_inputs(f, g, TAU, pono_c)
    rows = slice(r0 * w, (r0 + hl) * w)
    shard = (f3[:, rows].contiguous(), g3, v, qv[:, rows].contiguous(), kv)
    return shard, (f3, g3, v, qv, kv), rows


def _wide_inputs(shape, seed=4):
    """(f3, g3, v, qv, kv) of a query map with more rows than the key map;
    PONO_C, each side's terms from its own map."""
    hq, hk, w, c, d = shape
    f, g, v = (torch.from_numpy(a) for a in _maps(hq, w, c, d, seed, hk))
    f3, _, qv, _ = S.shift9_inputs(f, f, TAU, True)
    _, g3, _, kv = S.shift9_inputs(g, g, TAU, True)
    return (f3, g3, v, qv, kv), (f.double(), g.double(), v.double())


def _j_core(args, w):
    f3, g3, v, qv, kv = (jnp.asarray(a.numpy()) for a in args)
    return j_core(f3, g3, jnp.swapaxes(v, 1, 2), qv, kv, w)


def _descriptors(x):
    """(B, H W, 9 C) f64 PONO_C descriptors: the 3x3 zero-padded unfold,
    centered over its entries and L2-normalized (the correspondence net's
    match_kernel 3 descriptor)."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    desc = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], -1).reshape(b, h * w, 9 * c)
    desc = desc - desc.mean(-1, keepdim=True)
    return desc / (desc.norm(dim=-1, keepdim=True) + 2.220446049250313e-16)


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHARDS)
def test_query_shard_forward(shape, pono_c):
    """A query shard against every key is the square result's rows, and the
    Pallas core's at the same nq < nk."""
    shard, square, rows = _shard_inputs(shape, pono_c)
    w = shape[1]
    o, lse = S.shift9_core_plain(*shard, w)
    assert o.shape == (2, shape[5] * w, shape[3])
    so, slse = S.shift9_core_plain(*square, w)
    np.testing.assert_allclose(o.numpy(), so[:, rows].numpy(), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), slse[:, rows].numpy(),
                               rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(_j_core(shard, w)),
                               atol=3e-4)


@pytest.mark.parametrize("shape", WIDE)
def test_wide_query_map_forward(shape):
    """nq > nk: the plain core against f64 descriptors formed explicitly,
    and against the Pallas core at the same shapes."""
    args, (f, g, v) = _wide_inputs(shape)
    w = shape[2]
    o, _ = S.shift9_core_plain(*args, w)
    logits = _descriptors(f) @ _descriptors(g).transpose(1, 2) / TAU
    want = torch.softmax(logits, -1) @ v
    np.testing.assert_allclose(o.numpy(), want.numpy(), atol=2e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(_j_core(args, w)),
                               atol=3e-4)


def _rect_cases(d=None):
    cases = ([("shard", s, p) for s in SHARDS[:3] for p in (True, False)]
             + [("wide", s, True) for s in WIDE])
    return [c for c in cases if d is None or c[1][-3 if c[0] == "shard"
                                                  else -1] == d]


def _case_inputs(kind, shape, pono_c):
    if kind == "shard":
        return _shard_inputs(shape, pono_c)[0], shape[1]
    return _wide_inputs(shape)[0], shape[2]


@pytest.mark.parametrize("kind,shape,pono_c", _rect_cases(d=3))
def test_gradients_match_pallas_core(kind, shape, pono_c):
    """Autograd through _Shift9Core (the plain backward on CPU tensors) at
    nq != nk against jax.grad of the Pallas core, every input: f3, g3, v
    and the rank-1 terms qv and kv. The loss is sum(sin(out)), so every
    output element gets its own cotangent."""
    args, w = _case_inputs(kind, shape, pono_c)
    leaves = [a.clone().requires_grad_() for a in args]
    before = S.attend_shift9_backward.plain_calls
    out = S._Shift9Core.apply(*leaves, w)
    torch.sin(out).sum().backward()
    assert S.attend_shift9_backward.plain_calls == before + 1
    got = [t.grad.numpy() for t in leaves]

    f3, g3, v, qv, kv = (jnp.asarray(a.numpy()) for a in args)

    def loss(f3, g3, vt, qv, kv):
        return jnp.sum(jnp.sin(j_core(f3, g3, vt, qv, kv, w)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        f3, g3, jnp.swapaxes(v, 1, 2), qv, kv)
    want = [np.asarray(x) for x in want]
    want[2] = np.swapaxes(want[2], 1, 2)
    for name, a, b in zip(("dF3", "dG3", "dV", "dqv", "dkv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("kind,shape,pono_c", _rect_cases())
def test_plain_backward_is_autograd_of_plain_forward(kind, shape, pono_c):
    """shift9_bwd_plain's five outputs at nq != nk against autograd through
    shift9_core_plain, in f64, at 1e-10 of each output's largest
    magnitude: the plain backward is the forward's derivative."""
    args, w = _case_inputs(kind, shape, pono_c)
    f3, g3, v, qv, kv = (a.double().requires_grad_() for a in args)
    o, lse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    go = torch.from_numpy(np.random.RandomState(5).randn(*o.shape))
    want = torch.autograd.grad(o, (f3, qv, g3, kv, v), go)
    dd = (go * o).sum(-1)
    got = S.shift9_bwd_plain(*(a.detach() for a in (f3, g3, v, qv, kv, lse)),
                             go, dd.detach(), w)
    for name, a, b in zip(S_NAMES, got, want):
        scale = float(b.abs().max())
        if name == "dkv":   # its fourth row has no input to flow into
            a, b = a[:, :3], b[:, :3]
        assert float((a - b).abs().max()) <= 1e-10 * scale, name


S_NAMES = ("dF3", "dqv", "dG3", "dkv", "dV")


def test_kernel_shape_checks_name_both_sides():
    """The kernel wrappers refuse a side that is not whole image rows before
    any library loads (this host has no nvcc), naming both sides' shapes."""
    (f3, g3, v, qv, kv), _, _ = _shard_inputs(SHARDS[0], True)
    with pytest.raises(ValueError, match="whole image rows"):
        S._check_rows("shift9 kernel", f3[:, :-1], g3, v, qv[:, :-1], kv, 8)
    with pytest.raises(ValueError, match="whole image rows"):
        S._check_rows("shift9 kernel", f3, g3[:, 1:], v, qv, kv, 8)
    S._check_rows("shift9 kernel", f3, g3, v, qv, kv, 8)
