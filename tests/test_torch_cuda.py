"""The port's CUDA kernels against their plain versions on the card, at small
shapes, through the public wrappers. Marked `cuda`: each test skips where
there is no CUDA device. On a GPU machine, from the repository root
(--noconftest: tests/conftest.py sets up JAX, which this file does not use):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(chip_smoke.py holds the same kernels at the flagship shapes.)"""

import pytest
import torch

from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.ops import corr as K
from cocosnet_tpu_torch.ops import corr_bigc as KB
from cocosnet_tpu_torch.ops import image as I
from cocosnet_tpu_torch.ops import shift9 as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    # the plain versions must run in full f32 (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator().manual_seed(0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        flags


def _r(g, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)


def _tol(ref, dtype):
    # f32: reordered sums, ~sqrt(K) ulps of the scale; bf16: one rounding
    scale = float(ref.float().abs().max())
    return (2.0 ** -7 if dtype == torch.bfloat16 else 3e-5) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 8, 16, 64, 64), (1, 4, 16, 151, 135), (1, 3, 5, 7, 9),
    # channel counts not a multiple of 8 (the channel-padded copy), a
    # ragged last output-channel tile, H W = 216 not a multiple of the
    # 128-pixel tile
    (2, 9, 24, 407, 200),
    # Cin a multiple of 8 but not of the 64-channel stage, a ragged second
    # 128-channel tile, three samples of 160 pixels
    (3, 10, 16, 24, 136),
    # the 64-channel tile (Cout <= 64), H W = 240
    (2, 12, 20, 128, 48),
    # the smallest reflect ring
    (2, 2, 2, 64, 64)])
def test_conv3x3_kernel_matches_plain(gen, shape, stats, reflect, dtype):
    """Every branch of csrc/conv3x3.cu (both tile widths, inputs with and
    without the channel-padded copy, ragged pixel and channel tiles, the
    statistics epilogue) against conv3x3_plain on the same operands."""
    b, h, w, ci, co = shape
    x = _r(gen, b, h, w, ci, dtype=dtype)
    k = _r(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5, dtype=dtype)
    bias = _r(gen, co, scale=0.1)
    entry = C.conv3x3_fused_stats if stats else C.conv3x3_fused
    n = entry.launches
    got = entry(x, k, bias, reflect=reflect)
    assert entry.launches == n + 1
    want = C.conv3x3_plain(x, k, bias, reflect=reflect, want_stats=stats)
    got, want = (got, want) if stats else ((got,), (want,))
    assert got[0].dtype == dtype
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=_tol(want[0], dtype))
    for a, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


def test_conv3x3_kernel_leaky(gen):
    x, k = _r(gen, 1, 8, 16, 64), _r(gen, 3, 3, 64, 64, scale=1 / 24)
    got = C.conv3x3_fused(x, k, None, leaky=0.2)
    want = C.conv3x3_plain(x, k, None, leaky=0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=_tol(want, x.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 9, 33, 70, 19),
    # widths not a multiple of the 128-column tile, heights not one of its
    # 4 rows, Cout 70 (the table padded to 72, stores channel by channel)
    (1, 7, 200, 70, 19), (3, 6, 130, 70, 19),
    # Cout a multiple of 8 (16-byte stores); three channel blocks
    (2, 5, 140, 64, 19), (1, 8, 128, 136, 19),
    # 151 classes: 64 channels a block in bf16, 32 in f32; 183 classes
    # (COCO-Stuff with its don't-care label): 32 in bf16, 16 in f32
    (2, 12, 256, 64, 151), (1, 9, 140, 64, 183)])
def test_onehot_kernel_matches_plain(gen, dtype, shape):
    b, h, w, cout, nc = shape
    lab = torch.randint(-1, nc + 2, (b, h, w), generator=gen).to("cuda")
    k, bias = _r(gen, 3, 3, nc, cout, scale=0.3), _r(gen, cout, scale=0.1)
    n = C.conv3x3_onehot.launches
    got = C.conv3x3_onehot(lab, k, bias, dtype=dtype, want_stats=True)
    assert C.conv3x3_onehot.launches == n + 1
    want = C.onehot_plain(lab, k, bias, dtype=dtype, want_stats=True)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=_tol(want[0], dtype))
    for a, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
    plain = C.conv3x3_onehot(lab, k, bias, dtype=dtype, leaky=0.2)
    torch.testing.assert_close(
        plain.float(), C.onehot_plain(lab, k, bias, dtype=dtype,
                                      leaky=0.2).float(),
        rtol=0, atol=_tol(want[0], dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_kernel_gives_the_same_bits(gen, dtype):
    """Two launches give the same output and moments: the statistics are
    summed per tile and then over the tiles in a fixed order, no
    atomics."""
    lab = torch.randint(-1, 153, (3, 37, 200), generator=gen).to("cuda")
    k, bias = _r(gen, 3, 3, 151, 64, scale=0.3), _r(gen, 64, scale=0.1)
    got = C.conv3x3_onehot(lab, k, bias, dtype=dtype, want_stats=True)
    again = C.conv3x3_onehot(lab, k, bias, dtype=dtype, want_stats=True)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", [(8, 8, 16, 3), (32, 8, 16, 5),
                                   (16, 16, 8, 3), (4, 64, 32, 40),
                                   (4, 128, 16, 7), (5, 13, 8, 4),
                                   (4, 16, 16, 154),
                                   # N = 260, a multiple of neither the
                                   # 126-query tiles nor the 62-key
                                   # regions, at an odd width
                                   (20, 13, 8, 5)])
def test_shift9_kernel_matches_plain(gen, shape, pono_c):
    h, w, c, d = shape
    f, g = _r(gen, 2, h, w, c), _r(gen, 2, h, w, c, scale=1.5) + 0.2
    v = _r(gen, 2, h * w, d)
    n = S.attend_shift9.launches
    got = S.attend_shift9(f, g, v, 0.01, pono_c)
    assert S.attend_shift9.launches == n + 1
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, pono_c)
    want, wlse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)[1]
    torch.testing.assert_close(lse, wlse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [
    # 3 x 48 = 144 query tiles, cut into 3 parts of the key regions: 432
    # blocks, 3.3 waves of 132 SMs
    (48, 16, 16, 8, 5),
    # 120 blocks in one part; the flagship's D in 144 query tiles, 4 parts
    (40, 16, 16, 8, 5), (16, 64, 16, 32, 154)])
def test_shift9_kernel_spans_waves(gen, shape):
    """Batches whose blocks span more than one wave of the card, with the
    key regions in one part and in several, against the plain version."""
    b, h, w, c, d = shape
    f, g = _r(gen, b, h, w, c), _r(gen, b, h, w, c, scale=1.5) + 0.2
    v = _r(gen, b, h * w, d)
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, True)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    want, wlse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.testing.assert_close(o, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=1e-4)


def test_shift9_kernel_geometry(gen):
    """The forward kernel's blocks a part and key regions, which the
    wrapper's choice of parts (S.fwd_parts, held on the CPU) reads: 126
    queries a block, 62 keys a region, value columns in chunks of 160."""
    from cocosnet_tpu_torch.ops import _build
    lib = _build.library("shift9_fwd")
    assert [lib.cocosnet_shift9_fwd_blocks(*a) for a in (
        (48, 256, 5), (6, 4096, 154), (8, 4096, 154), (1, 126, 161))] == [
        144, 198, 264, 2]
    assert [lib.cocosnet_shift9_fwd_key_regions(n)
            for n in (256, 4096, 62, 63)] == [5, 67, 1, 2]


@pytest.mark.parametrize("shape", [(20, 13, 8, 5), (48, 16, 16, 8, 5),
                                   (4, 64, 16, 154)])
def test_shift9_kernel_gives_the_same_bits(gen, shape):
    """Two launches of the forward kernel give the same o and lse: each
    part's sums run in one order, and the parts combine in order."""
    b, (h, w, c, d) = (2, shape) if len(shape) == 4 else (shape[0],
                                                          shape[1:])
    f, g = _r(gen, b, h, w, c), _r(gen, b, h, w, c, scale=1.5) + 0.2
    v = _r(gen, b, h * w, d)
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, False)
    got = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    again = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("pono_c", [True, False])
@pytest.mark.parametrize("shape", [(8, 16, 16, 3), (16, 16, 8, 5),
                                   (4, 128, 16, 7), (2, 128, 32, 40),
                                   (5, 13, 8, 4), (4, 16, 16, 154),
                                   # N = 260, a multiple of neither the
                                   # 124-position tiles nor the 128-row
                                   # scratch, at an odd width
                                   (20, 13, 8, 5)])
def test_shift9_bwd_kernel_matches_plain(gen, shape, pono_c):
    """The backward kernel's five outputs against shift9_bwd_plain on the
    same inputs, each within 1e-4 of its largest magnitude (3xTF32
    products, sums over N in another order, 1/tau = 100 in the logits)."""
    h, w, c, d = shape
    f, g = _r(gen, 2, h, w, c), _r(gen, 2, h, w, c, scale=1.5) + 0.2
    v, go = _r(gen, 2, h * w, d), _r(gen, 2, h * w, d)
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, pono_c)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    args = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
    got = S.shift9_bwd_kernel(*args)
    want = S.shift9_bwd_plain(*args)
    for name, a, r in zip(("dF3", "dqv", "dG3", "dkv", "dV"), got, want):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)
    assert torch.equal(got[1][..., 3], got[1][..., 2])
    assert not got[3][:, 3].any()


@pytest.mark.parametrize("shape", [(20, 13, 8, 5), (4, 64, 16, 154)])
def test_shift9_bwd_kernel_gives_the_same_bits(gen, shape):
    """Two launches of the backward kernel on the same inputs give the
    same bits: every sum (the scores' partials, their reduce over the
    tiles, the three GEMMs) runs in one order, with no atomics."""
    h, w, c, d = shape
    f, g = _r(gen, 2, h, w, c), _r(gen, 2, h, w, c, scale=1.5) + 0.2
    v, go = _r(gen, 2, h * w, d), _r(gen, 2, h * w, d)
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, True)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    args = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
    got = S.shift9_bwd_kernel(*args)
    again = S.shift9_bwd_kernel(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("w", [16, 128])
def test_shift9_autograd_runs_the_backward_kernel(gen, w):
    """attend_shift9 on CUDA tensors that require grad: one forward and one
    backward launch, gradients of f, g and v as the plain versions give
    them on the CPU."""
    f = _r(gen, 2, 8, w, 16).requires_grad_()
    g = (_r(gen, 2, 8, w, 16, scale=1.5) + 0.2).requires_grad_()
    v = _r(gen, 2, 8 * w, 5).requires_grad_()
    n = (S.attend_shift9.launches, S.attend_shift9_backward.launches)
    loss = torch.sin(S.attend_shift9(f, g, v, 0.01)).sum()
    got = torch.autograd.grad(loss, (f, g, v))
    assert (S.attend_shift9.launches,
            S.attend_shift9_backward.launches) == (n[0] + 1, n[1] + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in (f, g, v)]
    want = torch.autograd.grad(
        torch.sin(S.attend_shift9(*cpu, 0.01)).sum(), cpu)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.cpu(), r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()))


def _unit(t):
    return torch.nn.functional.normalize(t, dim=-1)


@pytest.mark.parametrize("shape", [(2, 64, 64, 256, 154), (1, 100, 77, 32, 3),
                                   (2, 130, 200, 40, 7), (1, 5, 300, 17, 33),
                                   (3, 257, 65, 256, 256)])
def test_corr_kernels_match_plain(gen, shape):
    """corr_fwd.cu and corr_bwd.cu against their plain versions on the same
    inputs (B, N, M, C, D), with partial query and key tiles, N != M, and C
    and D not multiples of 4 (the wrapper's zero-padded copies): o within
    2e-5 (outputs are convex combinations of v ~ N(0, 1), 1/tau = 100 in
    the logits), lse within 1e-4, and each gradient within 1e-4 of its
    largest magnitude (3xTF32 products, sums over N or M in another order);
    the backward gives the same bits twice."""
    b, n, m, c, d = shape
    q, k = _unit(_r(gen, b, n, c)), _unit(_r(gen, b, m, c))
    v, go = _r(gen, b, m, d), _r(gen, b, n, d)
    o, lse = K.corr_fwd_kernel(q, k, v, 0.01)
    po, plse = K.corr_fwd_plain(q, k, v, 0.01)
    torch.testing.assert_close(o, po, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    args = (q, k, v, 0.01, lse, go, (go * o).sum(-1))
    got = K.corr_bwd_kernel(*args)
    want = K.corr_bwd_plain(*args)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)
    again = K.corr_bwd_kernel(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_corr_autograd_runs_the_kernels(gen):
    """attend_corr on CUDA tensors that require grad: one forward and one
    backward launch, gradients of q, k and v as the plain versions give
    them on the CPU."""
    q = _unit(_r(gen, 2, 70, 24)).requires_grad_()
    k = _unit(_r(gen, 2, 90, 24)).requires_grad_()
    v = _r(gen, 2, 90, 5).requires_grad_()
    n = (K.attend_corr.launches, K.attend_corr_backward.launches)
    got = torch.autograd.grad(torch.sin(K.attend_corr(q, k, v, 0.01)).sum(),
                              (q, k, v))
    assert (K.attend_corr.launches,
            K.attend_corr_backward.launches) == (n[0] + 1, n[1] + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        torch.sin(K.attend_corr(*cpu, 0.01)).sum(), cpu)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.cpu(), r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()))


def test_kernels_raise_on_what_they_do_not_take(gen):
    """A CUDA tensor launches the kernel or raises: no plain fallback."""
    f = _r(gen, 1, 4, 128, 8)     # W = 128 runs; D = 300 > 256 is refused
    with pytest.raises(ValueError, match="D <= 256"):
        S.attend_shift9(f, f, _r(gen, 1, 512, 300), 0.01)
    q = _r(gen, 1, 40, 8)
    with pytest.raises(ValueError, match="D <= 256"):
        K.attend_corr(q, q, _r(gen, 1, 40, 300), 0.01)
    # the backward kernels' grid holds B in its third dimension
    qb = _r(gen, 65536, 1, 4)
    lb = qb[..., 0].contiguous()
    for fn in (K.corr_bwd_kernel, KB.corr_bigc_bwd_kernel):
        with pytest.raises(ValueError, match="B <= 65535"):
            fn(qb, qb, qb, 0.01, lb, qb, lb)
    x = _r(gen, 1, 8, 16, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        C.conv3x3_fused(x, _r(gen, 3, 3, 64, 64, dtype=torch.float16))
    # the one-hot kernel holds its weight table in shared memory
    with pytest.raises(ValueError, match="does not fit"):
        C.conv3x3_onehot(torch.zeros(1, 8, 16, dtype=torch.int32,
                                     device="cuda"),
                         _r(gen, 3, 3, 3000, 64), dtype=torch.bfloat16)


@pytest.mark.parametrize("entry", ["stats", "onehot"])
def test_conv_kernels_refuse_inputs_that_require_grad(gen, entry):
    """The statistics and one-hot conv kernels have no backward (nor do
    the JAX package's): a CUDA input that requires grad raises instead of
    coming back without a grad_fn. conv3x3_fused has one (below)."""
    k = _r(gen, 3, 3, 64, 64, scale=1 / 24).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        if entry == "onehot":
            C.conv3x3_onehot(torch.zeros(1, 8, 16, dtype=torch.int32,
                                         device="cuda"), k)
        else:
            C.conv3x3_fused_stats(_r(gen, 1, 8, 32, 64), k)


@pytest.mark.parametrize("leaky", [None, 0.2])
@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 64), (1, 6, 9, 24, 40),
                                   (2, 9, 24, 151, 136)])
def test_fused_conv_gradients_match_the_cpu(gen, shape, reflect, leaky):
    """conv3x3_fused on CUDA tensors that require grad: one forward launch
    and one backward (dx) launch, and the x, kernel and bias gradients of
    sum(sin(y)) as the plain versions give them on the CPU, f32, within
    1e-5 of each gradient's largest magnitude (f32 sums reordered)."""
    b, h, w, ci, co = shape
    ts = [_r(gen, b, h, w, ci), _r(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5),
          _r(gen, co, scale=0.1)]
    ts = [t.requires_grad_() for t in ts]
    n = (C.conv3x3_fused.launches, C.conv3x3_fused_backward.launches)
    got = torch.autograd.grad(torch.sin(C.conv3x3_fused(
        *ts, reflect=reflect, leaky=leaky)).sum(), ts)
    assert (C.conv3x3_fused.launches,
            C.conv3x3_fused_backward.launches) == (n[0] + 1, n[1] + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in ts]
    want = torch.autograd.grad(torch.sin(C.conv3x3_fused(
        *cpu, reflect=reflect, leaky=leaky)).sum(), cpu)
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        torch.testing.assert_close(a.cpu(), r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()), msg=name)


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 64), (1, 6, 9, 24, 40),
                                   (2, 9, 24, 407, 151), (2, 10, 16, 136, 24),
                                   (2, 2, 2, 64, 64)])
def test_fused_backward_dx_bf16_matches_plain(gen, shape, reflect):
    """The fused conv's backward dx in bf16 (the rotated-kernel launch of
    csrc/conv3x3.cu, which swaps the channel counts, then the reflect
    ring's scatter) against conv3x3_fused_backward_plain on the same
    operands, within one bf16 rounding of the scale (the scatter rounds
    once more)."""
    b, h, w, ci, co = shape
    x = _r(gen, b, h, w, ci, dtype=torch.bfloat16)
    k = _r(gen, 3, 3, ci, co, scale=(9 * ci) ** -0.5, dtype=torch.bfloat16)
    gy = _r(gen, b, h, w, co, dtype=torch.bfloat16)
    need = (True, False, False)
    n = C.conv3x3_fused_backward.launches
    got = C.conv3x3_fused_backward(x, k, None, gy, reflect=reflect,
                                   need=need)[0]
    assert C.conv3x3_fused_backward.launches == n + 1
    want = C.conv3x3_fused_backward_plain(x, k, None, gy, reflect=reflect,
                                          need=need)[0]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2 * _tol(want, torch.bfloat16))


@pytest.mark.parametrize("reflect", [False, True])
def test_xla_pdw_gradients_match_the_cpu(gen, reflect):
    """The dW route on the card: one conv3x3_dw launch, and the gradients
    of sum(sin(y)) as on the CPU (f32, 1e-5 of each largest magnitude)."""
    ts = [_r(gen, 2, 8, 32, 64), _r(gen, 3, 3, 64, 96, scale=1 / 24),
          _r(gen, 96, scale=0.1)]
    ts = [t.requires_grad_() for t in ts]
    n = C.conv3x3_dw.launches
    got = torch.autograd.grad(torch.sin(C.conv3x3_xla_pdw(
        *ts, reflect)).sum(), ts)
    assert C.conv3x3_dw.launches == n + 1
    cpu = [t.detach().cpu().requires_grad_() for t in ts]
    want = torch.autograd.grad(torch.sin(C.conv3x3_xla_pdw(
        *cpu, reflect)).sum(), cpu)
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        torch.testing.assert_close(a.cpu(), r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()), msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 8, 16, 64, 64), (1, 4, 16, 151, 200), (3, 5, 7, 9, 70),
    (2, 32, 64, 64, 128),
    # channel counts not a multiple of 8 on both sides, ragged tiles
    (2, 9, 24, 407, 136),
    # the smallest reflect ring; one 32-pixel chunk, so one split
    (2, 2, 2, 7, 9),
    # 16-byte loads, Cin not a multiple of 128, a ragged second Cout tile
    (3, 10, 16, 24, 136),
    # tiles that fill whole waves: one split over 128 pixels
    (2, 8, 8, 1024, 1408)])
def test_dw_kernel_matches_plain(gen, shape, reflect, dtype):
    """conv3x3_dw.cu against conv3x3_dw_plain (odd channel counts, ragged
    tiles, one and several splits of the pixels), each output within 1e-4
    of its largest magnitude (f32 sums reordered; bf16 products are exact in
    f32), and two launches give the same bits."""
    b, h, w, ci, co = shape
    x, g = _r(gen, b, h, w, ci, dtype=dtype), _r(gen, b, h, w, co,
                                                  dtype=dtype)
    n = C.conv3x3_dw.launches
    got = C.conv3x3_dw(x, g, reflect=reflect)
    assert C.conv3x3_dw.launches == n + 1
    want = C.conv3x3_dw_plain(x, g, reflect=reflect)
    for name, a, r in zip(("dw", "db"), got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)
    again = C.conv3x3_dw(x, g, reflect=reflect)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_dw_splits_fill_two_waves(gen):
    """The split count of csrc/conv3x3_dw.cu: one where the tiles alone
    fill whole waves of the card or there is one 32-pixel chunk, several
    otherwise, and tiles x splits at least two waves of 132 SMs at the
    flagship's dW shapes (batch 8), 512->512 among them."""
    from cocosnet_tpu_torch.ops import _build
    lib = _build.library("conv3x3_dw")
    for is_bf16, tile in ((1, 128), (0, 64)):
        assert lib.cocosnet_conv3x3_dw_splits(2, 8, 8, 1024, 1408,
                                              is_bf16) == 1
        assert lib.cocosnet_conv3x3_dw_splits(2, 2, 2, 7, 9, is_bf16) == 1
        assert lib.cocosnet_conv3x3_dw_splits(2, 32, 64, 64, 128,
                                              is_bf16) > 1
        for h, w, ci, co, _ in C.DW_WINNERS | {(8, 8, 154, 128, True),
                                               (64, 64, 3, 128, True)}:
            s = lib.cocosnet_conv3x3_dw_splits(8, h, w, ci, co, is_bf16)
            tiles = 9 * -(-ci // tile) * -(-co // tile)
            assert tiles * s >= 2 * 132, (h, w, ci, co, is_bf16, s)


@pytest.mark.parametrize("shape", [(1, 200, 300, 2304, 3), (2, 64, 90, 256, 7),
                                   (1, 33, 70, 1000, 40),
                                   # N and M ragged against the forward's
                                   # 128-query and 64-key tiles
                                   (2, 130, 100, 2304, 3)])
def test_bigc_kernels_match_plain(gen, shape):
    """The large-descriptor path: corr_fwd.cu and corr_bwd.cu against
    the plain versions (B, N, M, C, D), N != M: o within 2e-5, lse within
    1e-4, each gradient within 1e-4 of its largest magnitude; the backward
    gives the same bits twice."""
    b, n, m, c, d = shape
    q, k = _unit(_r(gen, b, n, c)), _unit(_r(gen, b, m, c))
    v, go = _r(gen, b, m, d), _r(gen, b, n, d)
    o, lse = K.corr_fwd_kernel(q, k, v, 0.01)
    po, plse = K.corr_fwd_plain(q, k, v, 0.01)
    torch.testing.assert_close(o, po, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    args = (q, k, v, 0.01, lse, go, (go * o).sum(-1))
    got = KB.corr_bigc_bwd_kernel(*args)
    want = K.corr_bwd_plain(*args)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)
    again = KB.corr_bigc_bwd_kernel(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_bigc_autograd_runs_the_kernels(gen):
    """attend_corr_bigc on CUDA tensors that require grad: one forward and
    one backward launch, gradients as the plain versions give them on the
    CPU."""
    q = _unit(_r(gen, 1, 70, 2304)).requires_grad_()
    k = _unit(_r(gen, 1, 90, 2304)).requires_grad_()
    v = _r(gen, 1, 90, 3).requires_grad_()
    n = (KB.attend_corr_bigc.launches, KB.attend_corr_bigc_backward.launches)
    got = torch.autograd.grad(
        torch.sin(KB.attend_corr_bigc(q, k, v, 0.01)).sum(), (q, k, v))
    assert (KB.attend_corr_bigc.launches,
            KB.attend_corr_bigc_backward.launches) == (n[0] + 1, n[1] + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        torch.sin(KB.attend_corr_bigc(*cpu, 0.01)).sum(), cpu)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.cpu(), r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()))


@pytest.mark.parametrize("shape", [(2, 64, 128, 16), (1, 8, 8, 1),
                                   (2, 7, 9, 5)])
def test_discriminator_downsample_gradient_matches_the_cpu(gen, shape):
    """avg_pool_3x3_s2_p1 forward and gradient on the card equal the CPU's
    (F.avg_pool2d's CUDA backward on an NHWC view got them wrong)."""
    x = torch.randn(*shape, generator=gen)
    gy = torch.randn(shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2,
                     shape[3], generator=gen)
    outs = []
    for dev in ("cpu", "cuda"):
        xt = x.clone().to(dev).requires_grad_(True)
        y = I.avg_pool_3x3_s2_p1(xt)
        gx, = torch.autograd.grad(y, xt, gy.to(dev))
        outs.append((y.detach().cpu(), gx.cpu()))
    (yc, gc), (yg, gg) = outs
    torch.testing.assert_close(yg, yc, rtol=0, atol=1e-6)
    torch.testing.assert_close(gg, gc, rtol=0, atol=1e-6)
