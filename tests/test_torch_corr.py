"""The port's match_kernel=1 correlation on the CPU: the plain versions of
the ops/corr kernels and the library route ops/correlation against the JAX
package's `attend_reference`, `attend_chunked`, `attend` and its Pallas
`attend_pallas` (interpret mode), forward and gradients.

Tolerances:
- f32 against f32 (`attend_reference`, XLA on the CPU): 1e-5 x max|v| on the
  output (measured 1.1e-6 at N = M = 256, C = 256: the same products summed
  in another order, with 1/tau = 100 in the logits);
- against the Pallas kernel, atol 5e-4 on the output, as
  tests/test_correlation.py holds it: its bf16x3 products lie 3.3e-5 from
  f32 here, up to ~2e-4 elsewhere, once 1/tau amplifies them;
- gradients against jax.grad, 1e-3 of each gradient's largest magnitude
  (test_correlation.py:53; measured 1.7e-6 against attend_reference and
  2.6e-5 against the Pallas kernel);
- the plain backward against autograd through the port's
  attend_reference, 1e-5 of each output's largest magnitude.

The loss is sum(sin(out)), so every output element gets its own cotangent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.ops import correlation as JC
from cocosnet_tpu.ops.pallas_corr import attend_pallas as j_attend_pallas
from cocosnet_tpu_torch.ops import corr as K
from cocosnet_tpu_torch.ops import correlation as TC
from test_torch_threads import torch_threads  # noqa: F401

TAU = 0.01


def _inputs(b=2, n=256, m=256, c=256, d=7, seed=0):
    """Unit-norm descriptors, as the correspondence net hands them over."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, n, c).astype(np.float32)
    k = rs.randn(b, m, c).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = (rs.rand(b, m, d) * 2 - 1).astype(np.float32)
    return q, k, v


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _port_grads(fn, q, k, v):
    tq, tk, tv = _t(q, k, v, grad=True)
    loss = torch.sin(fn(tq, tk, tv, TAU)).sum()
    return [t.numpy() for t in torch.autograd.grad(loss, (tq, tk, tv))]


def _jax_grads(fn, q, k, v):
    def loss(q_, k_, v_):
        return jnp.sum(jnp.sin(fn(q_, k_, v_, TAU)))
    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _rel_close(got, want, rel, names=("dq", "dk", "dv")):
    for name, a, b in zip(names, got, want):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale,
                                   err_msg=name)


@pytest.fixture(scope="module")
def flagship_like():
    """N = M = 256, C 256 (the theta/phi width), D 7."""
    return _inputs()


def test_fwd_plain_matches_reference(flagship_like):
    q, k, v = flagship_like
    o, lse = K.corr_fwd_plain(*_t(q, k, v), TAU)
    want = np.asarray(JC.attend_reference(*map(jnp.asarray, (q, k, v)), TAU))
    np.testing.assert_allclose(o.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(v).max()))
    s = np.einsum("bnc,bmc->bnm", q.astype(np.float64), k) / TAU
    smax = s.max(-1)
    want_lse = smax + np.log(np.exp(s - smax[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-4)


def test_fwd_plain_matches_pallas(flagship_like):
    q, k, v = flagship_like
    o, _ = K.corr_fwd_plain(*_t(q, k, v), TAU)
    want = np.asarray(j_attend_pallas(*map(jnp.asarray, (q, k, v)), TAU))
    np.testing.assert_allclose(o.numpy(), want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("jax_fn", ["reference", "pallas"])
def test_plain_grads_match_jax(flagship_like, jax_fn):
    """Autograd through attend_corr (its backward: corr_bwd_plain) against
    jax.grad of attend_reference and of the Pallas kernel's custom VJP."""
    q, k, v = flagship_like
    before = K.attend_corr_backward.plain_calls
    got = _port_grads(K.attend_corr, q, k, v)
    assert K.attend_corr_backward.plain_calls == before + 1
    fn = JC.attend_reference if jax_fn == "reference" else j_attend_pallas
    _rel_close(got, _jax_grads(fn, q, k, v), 1e-3)


@pytest.mark.parametrize("nm", [(48, 48), (40, 72), (72, 40)])
def test_bwd_plain_equals_autograd_of_reference(nm):
    """dq, dk, dv of corr_bwd_plain, from the plain forward's lse, against
    autograd through the port's attend_reference, N and M apart."""
    n, m = nm
    q, k, v = _t(*_inputs(2, n, m, 32, 5, seed=3), grad=True)
    o = TC.attend_reference(q, k, v, TAU)
    go = torch.from_numpy(np.random.RandomState(4).randn(*o.shape).astype(
        np.float32))
    want = torch.autograd.grad(o, (q, k, v), go)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o2, lse = K.corr_fwd_plain(qd, kd, vd, TAU)
    torch.testing.assert_close(o2, o.detach(), rtol=0, atol=1e-5)
    got = K.corr_bwd_plain(qd, kd, vd, TAU, lse, go, (go * o2).sum(-1))
    _rel_close([t.numpy() for t in got], [t.numpy() for t in want], 1e-5)


def test_chunked_and_attend_match_jax():
    """The library route: attend_chunked (checkpointed 64-row chunks) and
    the attend dispatch against JAX's, forward and gradients."""
    q, k, v = _inputs(2, 256, 256, 64, 5, seed=1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for port, jax_fn in (
            (lambda a, b, c, t: TC.attend_chunked(a, b, c, t, chunk=64),
             lambda a, b, c, t: JC.attend_chunked(a, b, c, t, chunk=64)),
            (TC.attend, lambda a, b, c, t: JC.attend(a, b, c, t, False))):
        got = port(*_t(q, k, v), TAU).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_fn(jq, jk, jv, TAU)),
                                   rtol=0, atol=1e-5)
        _rel_close(_port_grads(port, q, k, v), _jax_grads(jax_fn, q, k, v),
                   1e-4)


def test_attend_switches_to_chunks_at_2_26_logits(monkeypatch):
    """B N M >= 2^26 takes the chunked form, below the dense one."""
    calls = []
    monkeypatch.setattr(TC, "attend_chunked",
                        lambda *a, **kw: calls.append("chunked"))
    monkeypatch.setattr(TC, "attend_reference",
                        lambda *a, **kw: calls.append("dense"))
    z = torch.zeros(1, 1, 1)
    TC.attend(torch.zeros(4, 4096, 1), torch.zeros(4, 4095, 1), z, TAU)
    TC.attend(torch.zeros(4, 4096, 1), torch.zeros(4, 4096, 1), z, TAU)
    assert calls == ["dense", "chunked"]


def test_ragged_n_and_m_match_reference():
    """The port takes every query row and key at any N and M, where the
    Pallas kernel drops work: its grid is N // 128 query blocks (at N = 320
    it writes 256 rows; interpret mode leaves the rest NaN) and its key loop
    runs M // min(1024, M) chunks (at M = 1100 it reads 1024 keys)."""
    for n, m, seed in ((320, 320, 2), (128, 1100, 5)):
        q, k, v = _inputs(1, n, m, 8, 3, seed=seed)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        got, _ = K.corr_fwd_plain(*_t(q, k, v), TAU)
        want = np.asarray(JC.attend_reference(jq, jk, jv, TAU))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        pallas = np.asarray(j_attend_pallas(jq, jk, jv, TAU))
        rows, keys = n // 128 * 128, m // min(1024, m) * min(1024, m)
        seen = np.asarray(JC.attend_reference(jq, jk[:, :keys], jv[:, :keys],
                                              TAU))
        np.testing.assert_allclose(pallas[:, :rows], seen[:, :rows],
                                   atol=5e-4)
        assert not np.allclose(pallas, want, atol=5e-4)


def test_attend_corr_refuses_other_devices():
    """A tensor on neither CPU nor CUDA gets no plain version."""
    t = torch.zeros(1, 16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.attend_corr(t, t, torch.zeros(1, 16, 3, device="meta"), TAU)
