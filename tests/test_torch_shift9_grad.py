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
  output's largest magnitude: the same f32 products, reassociated; and,
  on every shape, the two in f64 at 1e-10 (in f32 both lie up to 7e-5 of
  dqv's largest magnitude from the f64 result, since dqs = sum_j gl *
  logits / qs cancels, so at D 22, 48 and with the roles swapped the two
  f32 results are up to 1.8e-5 apart).

The loss is sum(sin(out)), so every output element gets its own cotangent.
The forward outputs are held too, against the Pallas kernel at 3e-4 and
against attend_unfold at 2e-5 (tests/test_torch_shift9.py's bounds).

The shapes take the warp's value widths: D 3 (the colours), 22 and 48 (the
row warps of the celebahq and deepfashion configurations), and swapped
roles, attend_shift9(g, f, v): the column (cycle) warp calls the kernel
with the label side's features as keys and the exemplar's as queries.
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

# (H, W, C, D, swapped): test_corr_shift.py's gradient shape and one at
# W = 16, at D 3; D 22; D 48 and D 3 with the roles swapped
SHAPES = [(16, 8, 16, 3, False), (8, 16, 16, 3, False),
          (16, 8, 16, 22, False), (8, 16, 16, 48, True),
          (16, 8, 16, 3, True)]


def _inputs(h, w, c, d, swapped=False, seed=2):
    """(f, g, v): the queries' and the keys' features, the values; with
    `swapped` the draws of f and g trade places."""
    rs = np.random.RandomState(seed)
    f = rs.randn(2, h, w, c).astype(np.float32)
    g = (rs.randn(2, h, w, c) * 1.5 + 0.2).astype(np.float32)
    v = rs.randn(2, h * w, d).astype(np.float32)
    return (g, f, v) if swapped else (f, g, v)


def _torch_grads(f, g, v, pono_c):
    """(out, [df, dg, dv]) of sum(sin(attend_shift9(f, g, v)))."""
    tf, tg, tv = (torch.from_numpy(a).requires_grad_() for a in (f, g, v))
    before = S.attend_shift9_backward.plain_calls
    out = S.attend_shift9(tf, tg, tv, 0.01, pono_c)
    grads = torch.autograd.grad(torch.sin(out).sum(), (tf, tg, tv))
    assert S.attend_shift9_backward.plain_calls == before + 1
    return out.detach().numpy(), [t.numpy() for t in grads]


def _jax_grads(attend, f, g, v):
    out, vjp = jax.vjp(attend, jnp.asarray(f), jnp.asarray(g),
                       jnp.asarray(v))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.cos(out))]


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_pallas(shape, pono_c):
    f, g, v = _inputs(*shape)
    out, got = _torch_grads(f, g, v, pono_c)
    jout, want = _jax_grads(
        lambda a, b, c: j_attend_shift9(a, b, c, 0.01, pono_c), f, g, v)
    np.testing.assert_allclose(out, jout, atol=3e-4)
    for name, a, b in zip(("df", "dg", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_unfold_autodiff(shape, pono_c):
    f, g, v = _inputs(*shape)
    out, got = _torch_grads(f, g, v, pono_c)
    jout, want = _jax_grads(
        lambda a, b, c: j_attend_unfold(a, b, c, 0.01, 3, pono_c,
                                        row_chunk=4), f, g, v)
    np.testing.assert_allclose(out, jout, atol=2e-5)
    for name, a, b in zip(("df", "dg", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=name)


def _bwd_plain_and_autograd(shape, pono_c, dtype):
    """shift9_bwd_plain's outputs by name, and autograd's through
    shift9_core_plain in the same order, at `dtype`."""
    h, w, c, d, swapped = shape
    f, g, v = (torch.from_numpy(a)
               for a in _inputs(h, w, c, d, swapped, seed=5))
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, pono_c)
    ins = [t.detach().to(dtype).requires_grad_()
           for t in (f3, g3, v, qv, kv)]
    o, lse = S.shift9_core_plain(*ins, w)
    go = torch.from_numpy(np.random.RandomState(6).randn(*o.shape).astype(
        np.float32)).to(dtype)
    want = torch.autograd.grad(o, ins, go)
    dd = (go * o.detach()).sum(-1)
    df3, dqv, dg3, dkv, dv = S.shift9_bwd_plain(
        *(t.detach() for t in ins), lse.detach(), go, dd, w)
    return dict(df3=df3, dg3=dg3, dv=dv, dqv=dqv, dkv=dkv), want


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:2] + [(4, 12, 8, 5, False)])
def test_bwd_plain_equals_autograd_of_forward(shape, pono_c):
    """dF3, dqv, dG3, dkv, dV of shift9_bwd_plain against autograd through
    shift9_core_plain, with the layout of the kernel's outputs: dqv's
    column 3 (cadd) equals column 2 (qadd), dkv's row 3 is zero."""
    got, want = _bwd_plain_and_autograd(shape, pono_c, torch.float32)
    for name, t in zip(("df3", "dg3", "dv", "dqv", "dkv"), want):
        scale = float(t.abs().max())
        torch.testing.assert_close(got[name], t, rtol=0, atol=1e-5 * scale,
                                   msg=name)
    assert torch.equal(got["dqv"][..., 3], got["dqv"][..., 2])
    assert torch.equal(got["dkv"][:, 3], torch.zeros_like(got["dkv"][:, 3]))


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_equals_autograd_of_forward_in_f64(shape, pono_c):
    """The same in f64, where reassociation leaves no visible error: the
    plain backward is the forward's derivative at D 3, 22 and 48 and with
    the roles swapped."""
    got, want = _bwd_plain_and_autograd(shape, pono_c, torch.float64)
    for name, t in zip(("df3", "dg3", "dv", "dqv", "dkv"), want):
        scale = float(t.abs().max())
        torch.testing.assert_close(got[name], t, rtol=0, atol=1e-10 * scale,
                                   msg=name)


def test_attend_shift9_refuses_other_devices():
    """A tensor on neither CPU nor CUDA gets no plain version."""
    t = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        S.attend_shift9(t, t, torch.zeros(1, 16, 3, device="meta"), 0.01)
