"""The plain version of the port's shift9 kernel (ops/shift9.attend_shift9
on CPU tensors) against the unfold reference, at tests/test_corr_shift.py's
shapes, atol 2e-5, and against the JAX Pallas kernel in interpret mode.

The Pallas kernel computes S3 and P.V as bf16x3 products (three bf16
passes, ~2^-16 relative error each, amplified 100x by 1/tau in the
logits): it lies up to 1.4e-4 from the f32 unfold reference on these
shapes. So the port is held to 2e-5 against the f32 reference and to 3e-4,
about twice that measured bf16x3 gap, against the Pallas kernel."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cocosnet_tpu.ops.corr_shift import attend_unfold as j_attend_unfold
from cocosnet_tpu.ops.pallas_shift9 import attend_shift9 as j_attend_shift9
from cocosnet_tpu_torch.ops import shift9 as S
from cocosnet_tpu_torch.ops.corr_shift import attend_unfold
from test_torch_threads import torch_threads  # noqa: F401

SHAPES = [(8, 8, 16, 3), (32, 8, 16, 5), (16, 16, 8, 3)]


def _inputs(h, w, c, d, seed=1):
    rs = np.random.RandomState(seed)
    f = rs.randn(2, h, w, c).astype(np.float32)
    g = (rs.randn(2, h, w, c) * 1.5 + 0.2).astype(np.float32)
    v = rs.randn(2, h * w, d).astype(np.float32)
    return f, g, v


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_shift9_plain_matches_pallas_and_unfold(pono_c, shape):
    f, g, v = _inputs(*shape)
    tf, tg, tv = (torch.from_numpy(a) for a in (f, g, v))
    before = S.attend_shift9.plain_calls
    got = S.attend_shift9(tf, tg, tv, 0.01, pono_c).numpy()
    assert S.attend_shift9.plain_calls == before + 1
    jf, jg, jv = jnp.asarray(f), jnp.asarray(g), jnp.asarray(v)
    np.testing.assert_allclose(
        got, np.asarray(j_attend_unfold(jf, jg, jv, 0.01, 3, pono_c,
                                        row_chunk=4)), atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(j_attend_shift9(jf, jg, jv, 0.01, pono_c)),
        atol=3e-4)


@pytest.mark.parametrize("pono_c", [True, False])
def test_attend_unfold_matches_jax(pono_c):
    """The port's own unfold reference agrees with the JAX package's."""
    f, g, v = _inputs(16, 8, 16, 3, seed=2)
    got = attend_unfold(*(torch.from_numpy(a) for a in (f, g, v)), 0.01, 3,
                        pono_c, row_chunk=4)
    want = j_attend_unfold(jnp.asarray(f), jnp.asarray(g), jnp.asarray(v),
                           0.01, 3, pono_c, row_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_shift9_lse_is_the_row_logsumexp():
    """The core's second output is the logsumexp of each query row's logits
    (what the backward will read); o rows are convex combinations of V."""
    f, g, v = _inputs(8, 8, 16, 3, seed=3)
    f3, g3, qv, kv = S.shift9_inputs(torch.from_numpy(f), torch.from_numpy(g),
                                     0.01)
    o, lse = S.shift9_core_plain(f3, g3, torch.from_numpy(v), qv, kv, 8)
    assert lse.shape == (2, 64) and torch.isfinite(lse).all()
    vmin, vmax = v.min(axis=1)[:, None], v.max(axis=1)[:, None]
    assert (o.numpy() >= vmin - 1e-5).all() and (o.numpy() <= vmax + 1e-5).all()


@pytest.mark.parametrize("blocks,regions,parts", [
    # the flagship forward at B 6 (33 query tiles x 6, 67 key regions):
    # 198 blocks are 1.5 waves of 132 SMs, two parts make three whole ones
    (198, 67, 2),
    # at B 8 (the train step) 264 blocks are two whole waves already
    (264, 67, 1),
    # tests/test_torch_cuda.py's wave shapes
    (144, 5, 3), (120, 5, 1), (144, 17, 4),
    # no part is left empty: 5 regions in 4 parts would leave one
    (6, 5, 3), (2, 2, 2), (1, 1, 1)])
def test_forward_parts_fill_whole_waves(blocks, regions, parts):
    """The forward kernel's key regions are cut into the parts that fill
    the last wave of a 132-SM H100 best, the fewest on a tie."""
    assert S.fwd_parts(blocks, regions, 132) == parts
