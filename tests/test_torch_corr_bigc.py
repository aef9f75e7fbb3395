"""The port's large-descriptor correlation (ops/corr_bigc) on the CPU: its
plain versions against the JAX package's `attend_pallas_bigc` (interpret
mode) and `attend_reference`, forward and gradients, at
tests/test_correlation.py:103's shape and at the 2304-dim descriptors of
the A/B tool; the ragged sizes the Pallas kernel drops; and
ops/image.unfold_descriptors against JAX's.

Tolerances:
- against `attend_reference` (f32, XLA on the CPU): 1e-5 x max|v| on the
  output and 1e-4 of each gradient's largest magnitude (the same products
  summed in another order, 1/tau = 100 in the logits);
- against the Pallas kernel: atol 5e-4 on the output and 1e-3 on the
  gradients, as tests/test_correlation.py:98-118 holds it against the
  reference (its bf16x4 products, 1/tau = 100).

The loss is sum(sin(out)), so every output element gets its own cotangent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.ops import correlation as JC
from cocosnet_tpu.ops import image as JI
from cocosnet_tpu.ops.pallas_corr_bigc import attend_pallas_bigc
from cocosnet_tpu_torch.ops import corr_bigc as KB
from cocosnet_tpu_torch.ops import image as TI
from test_torch_threads import torch_threads  # noqa: F401

TAU = 0.01


def _inputs(b, n, m, c, d, seed):
    """Unit-norm descriptors, values ~ N(0, 1), as test_correlation.py."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, n, c).astype(np.float32)
    k = rs.randn(b, m, c).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rs.randn(b, m, d).astype(np.float32)
    return q, k, v


def _port(q, k, v):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (KB.attend_corr_bigc.plain_calls,
              KB.attend_corr_bigc_backward.plain_calls)
    o = KB.attend_corr_bigc(*ts, TAU)
    grads = torch.autograd.grad(torch.sin(o).sum(), ts)
    assert (KB.attend_corr_bigc.plain_calls,
            KB.attend_corr_bigc_backward.plain_calls) == (before[0] + 1,
                                                          before[1] + 1)
    return o.detach().numpy(), [t.numpy() for t in grads]


def _jax(fn, q, k, v):
    js = [jnp.asarray(a) for a in (q, k, v)]
    o = fn(*js, TAU)
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a, TAU))),
                     argnums=(0, 1, 2))(*js)
    return np.asarray(o), [np.asarray(t) for t in grads]


def _rel_close(got, want, rel):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.fixture(scope="module", params=[(1, 256, 256, 256, 6),
                                        (1, 256, 256, 2304, 3)],
                ids=["C256", "C2304"])
def case(request):
    """(inputs, port output and gradients) at (B, N, M, C, D)."""
    q, k, v = _inputs(*request.param, seed=0)
    return (q, k, v), _port(q, k, v)


def test_plain_matches_reference(case):
    (q, k, v), (o, grads) = case
    wo, wgrads = _jax(JC.attend_reference, q, k, v)
    np.testing.assert_allclose(o, wo, rtol=0,
                               atol=1e-5 * float(np.abs(v).max()))
    _rel_close(grads, wgrads, 1e-4)


def test_plain_matches_pallas(case):
    (q, k, v), (o, grads) = case
    wo, wgrads = _jax(attend_pallas_bigc, q, k, v)
    np.testing.assert_allclose(o, wo, rtol=0, atol=5e-4)
    _rel_close(grads, wgrads, 1e-3)


def test_ragged_n_and_m_match_reference():
    """The port takes every query row and key at any N and M, where the
    Pallas kernel drops work: its grid is N // min(256, N) query blocks and
    M // min(256, M) key blocks (pallas_corr_bigc.py:102-106), so at N =
    320, M = 300 it writes 256 rows, each against the first 256 keys."""
    n, m = 320, 300
    q, k, v = _inputs(1, n, m, 64, 3, seed=2)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got, _ = _port(q, k, v)
    want = np.asarray(JC.attend_reference(jq, jk, jv, TAU))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(v).max()))
    pallas = np.asarray(attend_pallas_bigc(jq, jk, jv, TAU))
    rows, keys = n // 256 * 256, m // 256 * 256
    seen = np.asarray(JC.attend_reference(jq, jk[:, :keys], jv[:, :keys],
                                          TAU))
    np.testing.assert_allclose(pallas[:, :rows], seen[:, :rows], atol=5e-4)
    assert not np.allclose(pallas, want, atol=5e-4)


@pytest.mark.parametrize("shape,k", [((2, 5, 7, 3), 3), ((1, 8, 8, 4), 1),
                                     ((1, 6, 9, 2), 5)])
def test_unfold_descriptors_matches_jax(shape, k):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    got = TI.unfold_descriptors(torch.from_numpy(x), k)
    want = np.asarray(JI.unfold_descriptors(jnp.asarray(x), k))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_attend_corr_bigc_refuses_other_devices():
    t = torch.zeros(1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KB.attend_corr_bigc(t, t, torch.zeros(1, 16, 3, device="meta"), TAU)
