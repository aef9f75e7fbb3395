"""The gradients of the port's shift9 correlation on the CPU: autograd through
ops/shift9.attend_shift9, whose backward is `shift9_bwd_plain` on CPU
tensors, against jax.grad of the JAX package's Pallas `attend_shift9`
(interpret mode) and of its XLA `attend_unfold`; and the plain backward's
five outputs against autograd through the plain forward.

Tolerances:
- against the Pallas kernel, atol = rtol = 2e-3, as tests/test_corr_shift.py
  holds that kernel's own VJP against autodiff of attend_unfold: its bf16x3
  products lie ~1e-4 from f32 in the forward and the backward's 1/tau scale
  amplifies that;
- against autodiff of attend_unfold (both f32), atol = rtol = 2e-4: the two
  sides sum the 2304-wide descriptor products in different orders, and the
  logits carry 1/tau = 100 (measured up to 2e-5 on gradients of magnitude
  ~5; the Pallas kernel's are up to 2.1e-4 off);
- the plain backward against autograd of the plain forward, 1e-5 of each
  output's largest magnitude: the same f32 products, reassociated.

The loss is sum(sin(out)), so every output element gets its own cotangent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.ops.corr_shift import attend_unfold as j_attend_unfold
from cocosnet_tpu.ops.pallas_shift9 import attend_shift9 as j_attend_shift9
from cocosnet_tpu_torch.ops import shift9 as S
from test_torch_threads import torch_threads  # noqa: F401

# (H, W, C, D): test_corr_shift.py's gradient shape and one at W = 16
SHAPES = [(16, 8, 16, 3), (8, 16, 16, 3)]


def _inputs(h, w, c, d, seed=2):
    rs = np.random.RandomState(seed)
    f = rs.randn(2, h, w, c).astype(np.float32)
    g = (rs.randn(2, h, w, c) * 1.5 + 0.2).astype(np.float32)
    v = rs.randn(2, h * w, d).astype(np.float32)
    return f, g, v


def _torch_grads(f, g, v, pono_c):
    tf, tg, tv = (torch.from_numpy(a).requires_grad_() for a in (f, g, v))
    before = S.attend_shift9_backward.plain_calls
    loss = torch.sin(S.attend_shift9(tf, tg, tv, 0.01, pono_c)).sum()
    grads = torch.autograd.grad(loss, (tf, tg, tv))
    assert S.attend_shift9_backward.plain_calls == before + 1
    return [t.numpy() for t in grads]


def _jax_grads(attend, f, g, v):
    def loss(f_, g_, v_):
        return jnp.sum(jnp.sin(attend(f_, g_, v_)))
    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(f), jnp.asarray(g), jnp.asarray(v))]


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_pallas(shape, pono_c):
    f, g, v = _inputs(*shape)
    got = _torch_grads(f, g, v, pono_c)
    want = _jax_grads(lambda a, b, c: j_attend_shift9(a, b, c, 0.01, pono_c),
                      f, g, v)
    for name, a, b in zip(("df", "dg", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_unfold_autodiff(shape, pono_c):
    f, g, v = _inputs(*shape)
    got = _torch_grads(f, g, v, pono_c)
    want = _jax_grads(lambda a, b, c: j_attend_unfold(a, b, c, 0.01, 3, pono_c,
                                                      row_chunk=4), f, g, v)
    for name, a, b in zip(("df", "dg", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(4, 12, 8, 5)])
def test_bwd_plain_equals_autograd_of_forward(shape, pono_c):
    """dF3, dqv, dG3, dkv, dV of shift9_bwd_plain against autograd through
    shift9_core_plain, with the layout of the kernel's outputs: dqv's
    column 3 (cadd) equals column 2 (qadd), dkv's row 3 is zero."""
    h, w, c, d = shape
    f, g, v = (torch.from_numpy(a) for a in _inputs(h, w, c, d, seed=5))
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, pono_c)
    ins = [t.detach().clone().requires_grad_() for t in (f3, g3, v, qv, kv)]
    o, lse = S.shift9_core_plain(*ins, w)
    go = torch.from_numpy(np.random.RandomState(6).randn(*o.shape).astype(
        np.float32))
    want = torch.autograd.grad(o, ins, go)
    dd = (go * o.detach()).sum(-1)
    df3, dqv, dg3, dkv, dv = S.shift9_bwd_plain(
        *(t.detach() for t in ins), lse.detach(), go, dd, w)
    got = dict(df3=df3, dg3=dg3, dv=dv, dqv=dqv, dkv=dkv)
    for name, t in zip(("df3", "dg3", "dv", "dqv", "dkv"), want):
        scale = float(t.abs().max())
        torch.testing.assert_close(got[name], t, rtol=0, atol=1e-5 * scale,
                                   msg=name)
    assert torch.equal(dqv[..., 3], dqv[..., 2])
    assert torch.equal(dkv[:, 3], torch.zeros_like(dkv[:, 3]))


def test_attend_shift9_refuses_other_devices():
    """A tensor on neither CPU nor CUDA gets no plain version."""
    t = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        S.attend_shift9(t, t, torch.zeros(1, 16, 3, device="meta"), 0.01)
