"""The arithmetic of the shift9 backward kernel (csrc/shift9_bwd.cu),
emulated on the CPU: every product of the kernel, S3 = F3 G3^T, dP = gO
V^T, dF3 = dS3 G3, dG3 = dS3^T F3 and dV = P^T gO, is issued as the split
of tests/test_torch_corr_split.py (3xTF32: each operand x as hi = tf32(x)
and lo = tf32(x - hi), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the
products exact, summed here in f64), and the elementwise work between them
(the shifts, the logits, P, gl, da, the side gradients' sums) runs in f32
as in shift9_bwd_plain.

The emulation is held:
- against shift9_bwd_plain at chip_smoke.py's BWD_REL_TOL (1e-4 of each
  output's largest magnitude), pono_c True and False, at an odd image
  width, D 5 and 154;
- against jax.grad of the JAX package's Pallas shift9 core (its bf16x3
  kernels, interpret mode) at 2e-3 of each output's largest magnitude, the
  tolerance at which tests/test_torch_shift9_grad.py holds the plain
  version against that kernel;
and the alternatives are held to what they give: one TF32 pass misses
BWD_REL_TOL by more than 5x (tau = 0.01 amplifies its 2^-11 logit error
100x), and bf16x3, which holds it for the dense correlation's backward
(tests/test_torch_corr_split.py), misses it here on every case (measured
1.3e-4 to 1.3e-3, in dqv): the kernel takes 3xTF32 (measured up to 5.9e-5,
where the plain version itself is 5.1e-5 from f64).

dqs = sum_j gl logits / qs cancels across a row (gl sums to zero), so its
error is the largest of the five, in the plain version as in the split
(chip_smoke.py's BWD_REL_TOL note).

The forward kernel (csrc/shift9_fwd.cu) is emulated the same way: S3 = F3
G3^T and P V each issued as 3xTF32, the shifts and the logits in f32 as in
shift9_core_plain, the softmax from the row max (P = exp(logits - m), o =
P V / sum P, lse = m + log sum P). It is held against shift9_core_plain at
chip_smoke.py's forward tolerances (o 1e-4, outputs convex combinations of
v in [-1, 1]; lse 1e-3), pono_c True and False, at the odd widths above,
D 5 and 154, and against the JAX package's Pallas forward (interpret mode)
at 3e-4, tests/test_torch_shift9.py's tolerance for it (measured: o
within 2.6e-6, lse within 1.1e-5). bf16x3, the Pallas kernel's split,
holds the forward's tolerances too, with less margin (o 3.6e-5 to
8.9e-5). One TF32 pass misses the o tolerance (3.1e-3 to 4.3e-3), and so
does P V in one TF32 pass after S3 in 3xTF32 (2.7e-4 to 3.2e-4): the
kernel issues both products in 3xTF32, the split its backward needs.

What the emulation cannot show is the tensor cores' own summation, which
rounds each mma's sum toward zero: the kernels sum at most one 32-wide
stage of S3 per partial before adding it in f32, and chip_smoke.py holds
them to their tolerances on the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.ops import pallas_shift9
from cocosnet_tpu.ops.pallas_shift9 import attend_shift9 as j_attend_shift9
from cocosnet_tpu_torch.ops import shift9 as S
from test_torch_corr_split import _mm
from test_torch_threads import torch_threads  # noqa: F401

TAU = 0.01
BWD_REL_TOL = 1e-4
NAMES = ("dF3", "dqv", "dG3", "dkv", "dV")


def emulated_bwd(f3, g3, v, qv, kv, lse, go, dd, w, split="3xtf32"):
    """shift9_bwd_plain's function with every product issued as
    `split`."""
    s3 = _mm(f3, g3.transpose(1, 2), split)
    logits = S._logits(S._shift_sum(s3, w), qv, kv)
    p = torch.exp(logits - lse[..., None])
    gl = p * (_mm(go, v.transpose(1, 2), split) - dd[..., None])
    qs, qmul = qv[..., 0:1], qv[..., 1:2]
    ks, kmul = kv[:, 0:1, :], kv[:, 1:2, :]
    da = gl * qs * ks
    gll = gl * logits
    dqadd = da.sum(-1)
    dqv = torch.stack([gll.sum(-1) / qs[..., 0], -(da * kmul).sum(-1),
                       dqadd, dqadd], -1)
    dkadd = da.sum(1)
    dkv = torch.stack([gll.sum(1) / ks[:, 0], -(da * qmul).sum(1), dkadd,
                       torch.zeros_like(dkadd)], 1)
    ds3 = S._unshift_sum(da, w)
    return (_mm(ds3, g3, split), dqv, _mm(ds3.transpose(1, 2), f3, split),
            dkv, _mm(p.transpose(1, 2), go, split))


def _features(b, h, w, c, d, seed):
    """Raw features as chip_smoke.py draws them, values in [-1, 1]."""
    rs = np.random.RandomState(seed)
    f = rs.randn(b, h, w, c).astype(np.float32)
    g = (rs.randn(b, h, w, c) * 1.5 + 0.2).astype(np.float32)
    v = (rs.rand(b, h * w, d) * 2 - 1).astype(np.float32)
    return f, g, v


def _core_args(f, g, v, pono_c, go=None, seed=0):
    """(f3, g3, v, qv, kv, lse, go, dd, w) as the autograd Function hands
    them to the backward: lse from the plain forward, go random unless
    given (a callable of the output)."""
    w = f.shape[2]
    f3, g3, qv, kv = S.shift9_inputs(torch.from_numpy(f), torch.from_numpy(g),
                                     TAU, pono_c)
    tv = torch.from_numpy(v)
    o, lse = S.shift9_core_plain(f3, g3, tv, qv, kv, w)
    if go is None:
        go = torch.from_numpy(np.random.RandomState(seed).randn(
            *o.shape).astype(np.float32))
    else:
        go = go(o)
    return f3, g3, tv, qv, kv, lse, go, (go * o).sum(-1), w


def _rel_errs(got, want):
    return [float((a.double() - b.double()).abs().max())
            / float(b.abs().max()) for a, b in zip(got, want)]


# (B, H, W, C, D): an odd image width (positions wrap mid-row in every
# tile), a 3C that is no multiple of 4, the flagship's D
SHAPES = {"W7_D5": (2, 9, 7, 5, 5), "W13_D154": (1, 6, 13, 16, 154)}


@pytest.fixture(scope="module", params=[
    (name, pono_c) for name in sorted(SHAPES) for pono_c in (True, False)],
    ids=lambda p: f"{p[0]}-pono_c={p[1]}")
def case(request):
    """The backward's arguments and shift9_bwd_plain's outputs."""
    name, pono_c = request.param
    args = _core_args(*_features(*SHAPES[name], seed=3), pono_c, seed=4)
    return args, S.shift9_bwd_plain(*args)


def test_3xtf32_holds_bwd_rel_tol(case):
    args, want = case
    errs = _rel_errs(emulated_bwd(*args), want)
    assert max(errs) <= BWD_REL_TOL, dict(zip(NAMES, errs))


@pytest.mark.parametrize("split,factor", [("bf16x3", 1), ("1xtf32", 5)])
def test_cheaper_splits_do_not(case, split, factor):
    """bf16x3 misses BWD_REL_TOL on every case (dqv's cancelling sum, 1.3e-4
    to 1.3e-3), one TF32 pass by more than 5x."""
    args, want = case
    errs = _rel_errs(emulated_bwd(*args, split=split), want)
    assert max(errs) > factor * BWD_REL_TOL, dict(zip(NAMES, errs))


def test_3xtf32_is_closer_than_bf16x3(case):
    args, want = case
    tf = max(_rel_errs(emulated_bwd(*args, split="3xtf32"), want))
    bf = max(_rel_errs(emulated_bwd(*args, split="bf16x3"), want))
    assert tf < bf, (tf, bf)


@pytest.mark.parametrize("pono_c", [True, False])
def test_emulation_matches_pallas_grads(pono_c):
    """The core's five gradients of sum(sin(o)) by the emulated backward
    (go = cos(o)) against jax.grad of the Pallas core at a size its blocks
    take whole (tests/test_torch_shift9_grad.py's (16, 8) shape)."""
    f, g, v = _features(2, 16, 8, 16, 3, seed=2)
    args = _core_args(f, g, v, pono_c, go=torch.cos)
    got = emulated_bwd(*args)
    f3, g3, tv, qv, kv = (jnp.asarray(t.numpy()) for t in args[:5])
    w = args[-1]

    def loss(f3_, g3_, vt_, qv_, kv_):
        return jnp.sum(jnp.sin(pallas_shift9._core(f3_, g3_, vt_, qv_, kv_,
                                                   w)))
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        f3, g3, jnp.swapaxes(tv, 1, 2), qv, kv)
    df3, dg3, dvt, dqv, dkv = (np.asarray(t) for t in want)
    for name, a, b in zip(NAMES, got, (df3, dqv, dg3, dkv,
                                       np.swapaxes(dvt, 1, 2))):
        # the Pallas kernel reports cadd's gradient in dqv's column 3 and
        # nothing in dkv's row 3, as the port does
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-3 * float(np.abs(b).max()),
                                   err_msg=name)


def emulated_fwd(f3, g3, v, qv, kv, w, s_split="3xtf32", pv_split="3xtf32"):
    """shift9_core_plain's function with S3 issued as s_split and P V as
    pv_split: (o, lse)."""
    s3 = _mm(f3, g3.transpose(1, 2), s_split)
    logits = S._logits(S._shift_sum(s3, w), qv, kv)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1)
    return _mm(p, v, pv_split) / l[..., None], m[..., 0] + torch.log(l)


def _fwd_args(f, g, v, pono_c):
    """(f3, g3, v, qv, kv, w) of the forward kernel from raw features."""
    f3, g3, qv, kv = S.shift9_inputs(torch.from_numpy(f), torch.from_numpy(g),
                                     TAU, pono_c)
    return f3, g3, torch.from_numpy(v), qv, kv, f.shape[2]


@pytest.fixture(scope="module", params=[
    (name, pono_c) for name in sorted(SHAPES) for pono_c in (True, False)],
    ids=lambda p: f"{p[0]}-pono_c={p[1]}")
def fwd_case(request):
    """The forward's arguments and shift9_core_plain's outputs."""
    name, pono_c = request.param
    args = _fwd_args(*_features(*SHAPES[name], seed=5), pono_c)
    return args, S.shift9_core_plain(*args)


def _fwd_errs(got, want):
    return [float((a - b).abs().max()) for a, b in zip(got, want)]


@pytest.mark.parametrize("split", ["3xtf32", "bf16x3"])
def test_fwd_split_holds_fwd_tol(fwd_case, split):
    args, want = fwd_case
    eo, el = _fwd_errs(emulated_fwd(*args, s_split=split, pv_split=split),
                       want)
    assert eo <= 1e-4 and el <= 1e-3, (split, eo, el)


@pytest.mark.parametrize("s_split,pv_split", [("1xtf32", "1xtf32"),
                                              ("3xtf32", "1xtf32")])
def test_fwd_one_tf32_pass_does_not(fwd_case, s_split, pv_split):
    args, want = fwd_case
    eo, _ = _fwd_errs(emulated_fwd(*args, s_split=s_split,
                                   pv_split=pv_split), want)
    assert eo > 1e-4, eo


@pytest.mark.parametrize("pono_c", [True, False])
def test_fwd_emulation_matches_pallas(pono_c):
    """The emulated forward against the JAX package's Pallas forward at a
    size its blocks take whole (tests/test_torch_shift9.py's shapes)."""
    f, g, v = _features(2, 16, 8, 16, 3, seed=6)
    got, _ = emulated_fwd(*_fwd_args(f, g, v, pono_c))
    want = j_attend_shift9(jnp.asarray(f), jnp.asarray(g), jnp.asarray(v),
                           TAU, pono_c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-4)
