"""The arithmetic of the correlation backward kernels (csrc/corr_bwd.cu,
at C = 256 for ops/corr and C = 2304 for ops/corr_bigc), emulated on the
CPU: each operand x of every product splits into hi = tf32(x) and lo =
tf32(x - hi), TF32 being f32 rounded to 10 mantissa bits, to nearest, ties
away, as the kernels round it (half a TF32 ulp added to the f32 pattern,
the 13 bits below masked off), and a b is a_lo b_hi + a_hi b_lo + a_hi
b_hi (3xTF32, the products exact, summed here in f64). The kernels' S =
q k^T, dP = gO v^T, dq = dS k, dk = dS^T q and dv = P^T gO are formed so,
with P = exp(S / tau - lse) and dS = P (dP - dd) / tau in f32.

The emulation is held:
- against corr_bwd_plain at chip_smoke.py's BWD_REL_TOL (1e-4 of each
  output's largest magnitude), at C 256 / D 154 and C 2304 / D 3 with
  ragged N and M, at tau = 0.01;
- against jax.grad of the JAX package's `attend_pallas` and
  `attend_pallas_bigc` (interpret mode) at 1e-3, the tolerance at which
  tests/test_torch_corr.py and test_torch_corr_bigc.py hold the plain
  version against those kernels (their bf16x3 and bf16x4 products);
and the alternatives are held to what they give: one TF32 pass misses
BWD_REL_TOL by more than 5x (tau = 0.01 amplifies its 2^-11 logit error
100x; measured 6.5e-4 to 3.4e-3), and the bf16x3 split of
`pallas_corr._dot` (hi = bf16(x), lo = bf16(x - hi), lo b_lo dropped)
holds it with less margin (measured up to 5.6e-5, against 6.6e-6 for
3xTF32): the kernels take 3xTF32.

The forward kernel (csrc/corr_fwd.cu, both widths) is emulated the same
way: S = q k^T and P V in 3xTF32, the softmax in f32 (P = exp(S / tau -
m) with m the row max, o = P V / sum P). It is held against
corr_fwd_plain at chip_smoke.py's forward tolerances (o 1e-4, outputs
convex combinations of v in [-1, 1]; lse 1e-3) and against the JAX
package's Pallas forwards (interpret mode) at 5e-4, tests/test_torch_corr.
py's tolerance for them; one TF32 pass misses the o tolerance (measured
3.4e-4 and 3.0e-3), and so does P V in one TF32 pass after S in 3xTF32
(1.9e-4 and 3.2e-4: P in [0, 1] and v in [-1, 1] keep 11 bits): both
products take 3xTF32 (measured 5.4e-7 and 7.5e-6).

What the emulation cannot show is the tensor cores' own summation, which
rounds each mma's sum toward zero: the kernels sum at most one 32-wide
stage per partial before adding it in f32 (tc_split.cuh), and
chip_smoke.py holds them to BWD_REL_TOL on the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.ops.pallas_corr import attend_pallas
from cocosnet_tpu.ops.pallas_corr_bigc import attend_pallas_bigc
from cocosnet_tpu_torch.ops import corr as K
from test_torch_threads import torch_threads  # noqa: F401

TAU = 0.01
BWD_REL_TOL = 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), round to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _parts(x: torch.Tensor, split: str):
    """The terms x is multiplied as: (hi, lo), or (hi,) for one pass."""
    rnd = _bf16 if split == "bf16x3" else _tf32
    hi = rnd(x)
    return (hi,) if split == "1xtf32" else (hi, rnd(x - hi))


def _mm(a: torch.Tensor, b: torch.Tensor, split: str) -> torch.Tensor:
    """a @ b (batched) as the split issues it: every pair of terms but
    lo lo, products and sums in f64, rounded once to f32."""
    pa, pb = _parts(a, split), _parts(b, split)
    out = 0
    for i, x in enumerate(pa):
        for j, y in enumerate(pb):
            if i + j < 2:
                out = out + torch.matmul(x.double(), y.double())
    return out.float()


def emulated_bwd(q, k, v, tau, lse, go, dd, split="3xtf32"):
    """corr_bwd_plain's function with every product issued as `split`."""
    s = _mm(q, k.transpose(1, 2), split)
    p = torch.exp(s * (1.0 / tau) - lse[..., None])
    dp = _mm(go, v.transpose(1, 2), split)
    ds = p * (dp - dd[..., None]) * (1.0 / tau)
    return (_mm(ds, k, split), _mm(ds.transpose(1, 2), q, split),
            _mm(p.transpose(1, 2), go, split))


def _inputs(b, n, m, c, d, seed):
    """Unit-norm descriptors and values in [-1, 1], as chip_smoke.py's
    corr_inputs."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, n, c).astype(np.float32)
    k = rs.randn(b, m, c).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = (rs.rand(b, m, d) * 2 - 1).astype(np.float32)
    return q, k, v


def _backward_args(q, k, v, go=None, seed=0):
    """(q, k, v, tau, lse, go, dd) as the autograd Function hands them to
    the backward: lse from the plain forward, go random unless given."""
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = K.corr_fwd_plain(tq, tk, tv, TAU)
    if go is None:
        go = torch.from_numpy(np.random.RandomState(seed).randn(
            *o.shape).astype(np.float32))
    elif callable(go):
        go = go(o)
    return tq, tk, tv, TAU, lse, go, (go * o).sum(-1)


def _rel_errs(got, want):
    return [float((a.double() - b.double()).abs().max())
            / float(b.abs().max()) for a, b in zip(got, want)]


# (B, N, M, C, D): the two kernels' widths, ragged N and M, N != M
SHAPES = {"C256": (2, 300, 260, 256, 154), "C2304": (1, 200, 170, 2304, 3)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    """The backward's arguments and corr_bwd_plain's outputs."""
    args = _backward_args(*_inputs(*SHAPES[request.param], seed=4))
    return args, K.corr_bwd_plain(*args)


@pytest.mark.parametrize("split", ["3xtf32", "bf16x3"])
def test_split_holds_bwd_rel_tol(case, split):
    args, want = case
    errs = _rel_errs(emulated_bwd(*args, split=split), want)
    assert max(errs) <= BWD_REL_TOL, (split, errs)


def test_one_tf32_pass_does_not(case):
    args, want = case
    errs = _rel_errs(emulated_bwd(*args, split="1xtf32"), want)
    assert min(errs) > 5 * BWD_REL_TOL, errs


def test_3xtf32_is_closer_than_bf16x3(case):
    args, want = case
    tf = _rel_errs(emulated_bwd(*args, split="3xtf32"), want)
    bf = _rel_errs(emulated_bwd(*args, split="bf16x3"), want)
    assert all(a < b for a, b in zip(tf, bf)), (tf, bf)


@pytest.mark.parametrize("fn,shape", [
    (attend_pallas, (1, 256, 256, 256, 154)),
    (attend_pallas_bigc, (1, 256, 256, 2304, 3))],
    ids=["attend_pallas", "attend_pallas_bigc"])
def test_emulation_matches_pallas_grads(fn, shape):
    """The gradients of sum(sin(o)) by the emulated backward (go = cos(o))
    against jax.grad of the Pallas kernel, at sizes it takes whole (N and
    M multiples of its blocks)."""
    q, k, v = _inputs(*shape, seed=5)
    got = emulated_bwd(*_backward_args(q, k, v, go=torch.cos))
    js = [jnp.asarray(a) for a in (q, k, v)]
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a, TAU))),
                    argnums=(0, 1, 2))(*js)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * float(np.abs(b).max()),
                                   err_msg=name)


def emulated_fwd(q, k, v, tau, s_split="3xtf32", pv_split="3xtf32"):
    """corr_fwd_plain's function with S issued as s_split and P V as
    pv_split: (o, lse)."""
    s = _mm(q, k.transpose(1, 2), s_split) * (1.0 / tau)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    return _mm(p, v, pv_split) / l[..., None], m[..., 0] + torch.log(l)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def fwd_case(request):
    """The forward's inputs and corr_fwd_plain's outputs."""
    q, k, v = map(torch.from_numpy, _inputs(*SHAPES[request.param], seed=4))
    return (q, k, v), K.corr_fwd_plain(q, k, v, TAU)


def _fwd_errs(got, want):
    return [float((a - b).abs().max()) for a, b in zip(got, want)]


def test_fwd_3xtf32_holds_fwd_tol(fwd_case):
    args, want = fwd_case
    eo, el = _fwd_errs(emulated_fwd(*args, TAU), want)
    assert eo <= 1e-4 and el <= 1e-3, (eo, el)


@pytest.mark.parametrize("s_split,pv_split", [("1xtf32", "1xtf32"),
                                              ("3xtf32", "1xtf32")])
def test_fwd_one_tf32_pass_does_not(fwd_case, s_split, pv_split):
    args, want = fwd_case
    eo, _ = _fwd_errs(emulated_fwd(*args, TAU, s_split, pv_split), want)
    assert eo > 1e-4, eo


@pytest.mark.parametrize("fn,shape", [
    (attend_pallas, (1, 256, 256, 256, 154)),
    (attend_pallas_bigc, (1, 256, 256, 2304, 3))],
    ids=["attend_pallas", "attend_pallas_bigc"])
def test_fwd_emulation_matches_pallas(fn, shape):
    """The emulated forward against the Pallas forward at a size it takes
    whole."""
    q, k, v = _inputs(*shape, seed=6)
    got, _ = emulated_fwd(*map(torch.from_numpy, (q, k, v)), TAU)
    want = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v)), TAU))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
