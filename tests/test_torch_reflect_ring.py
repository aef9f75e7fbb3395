"""ops/ring.reflect_ring, the reflect ring of an NHWC tensor, against
F.pad(mode="reflect") on its NCHW view.

On the CPU: the plain version's values and gradients equal F.pad's exactly
at f32, and no launch is counted. Marked `cuda` (skipping without a CUDA
device): csrc/reflect_ring.cu's forward bit for bit against F.pad on the
card, its backward within one rounding of the f64 sum and the same bits on
a second run, both kernels captured in a CUDA graph and replayed, one
launch each a library reflect conv of a train step, and no CUDA tensor on
the plain version. No JAX: on a GPU machine, from the repository root,

    python -m pytest tests/test_torch_reflect_ring.py -q --noconftest
"""

import pytest
import torch
import torch.nn.functional as F

from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.ops import ring as R
from test_torch_threads import torch_threads  # noqa: F401

# (B, H, W, C, p): rings of 1 and 2, H != W, odd sizes, 3 and 154 channels
# (a bf16 pixel of 154 channels takes 4-byte vectors), H = p + 1 (the
# mirrors of both edges land on one row)
CASES = [(2, 5, 7, 3, 1), (1, 6, 9, 154, 2), (2, 2, 5, 3, 1),
         (1, 3, 4, 154, 2), (1, 7, 3, 154, 1)]


def _pad_nchw(x, p):
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")


@pytest.mark.parametrize("case", CASES)
def test_plain_ring_is_f_pad(case):
    """Values and the gradient of the CPU path, exactly F.pad's."""
    b, h, w, c, p = case
    g = torch.Generator().manual_seed(sum(case))
    x = torch.randn(b, h, w, c, generator=g)
    gy = torch.randn(b, h + 2 * p, w + 2 * p, c, generator=g)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = R.reflect_ring(xa, p)
    want = _pad_nchw(xb, p)
    assert got.shape == (b, h + 2 * p, w + 2 * p, c)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    (da,) = torch.autograd.grad(got, xa, gy)
    (db,) = torch.autograd.grad(want, xb, gy.permute(0, 3, 1, 2))
    assert torch.equal(da, db)


@pytest.mark.parametrize("p", [1, 2])
def test_cpu_ring_counts_no_launch(p):
    before = dict(R.RING_LAUNCHES)
    x = torch.randn(1, 4, 5, 3, requires_grad=True)
    R.reflect_ring(x, p).sum().backward()
    assert dict(R.RING_LAUNCHES) == before


@pytest.mark.parametrize("nbytes,ptrs,want", [
    (256, (0, 4096), 16), (308, (0, 512), 4), (616, (0, 256), 8),
    (6, (0, 0), 2), (256, (0, 8), 8), (12, (4, 0), 4)])
def test_vector_divides_pixel_and_alignment(nbytes, ptrs, want):
    assert R._vector(nbytes, *ptrs) == want


# ---- on the card -------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator().manual_seed(0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        flags


# the CPU cases, bf16 pixels of 8 and 16 bytes, and a flagship row
CARD_CASES = CASES + [(2, 8, 16, 64, 1), (2, 5, 6, 4, 2), (1, 16, 256, 128, 1),
                      (2, 9, 11, 154, 4)]


def _bwd_reference(gy, shape, p):
    """The f64 sum of the gradient over the ring and of its magnitudes."""
    out = []
    for g in (gy.double(), gy.double().abs()):
        x = torch.zeros(shape, dtype=torch.float64, device=gy.device,
                        requires_grad=True)
        (d,) = torch.autograd.grad(_pad_nchw(x, p), x,
                                   g.permute(0, 3, 1, 2))
        out.append(d)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_ring_kernels_match_f_pad(card, case, dtype):
    """Forward bit for bit against F.pad on the card; backward within one
    rounding of the f64 sum, the same bits on a second run."""
    b, h, w, c, p = case
    x = torch.randn(b, h, w, c, generator=card).to("cuda", dtype)
    gy = torch.randn(b, h + 2 * p, w + 2 * p, c,
                     generator=card).to("cuda", dtype)
    xr = x.clone().requires_grad_()
    y = R.reflect_ring(xr, p)
    assert y.is_contiguous()
    assert torch.equal(y, _pad_nchw(x, p).permute(0, 2, 3, 1))
    (d1,) = torch.autograd.grad(y, xr, gy, retain_graph=True)
    (d2,) = torch.autograd.grad(y, xr, gy)
    assert d1.dtype == dtype and torch.equal(d1, d2)
    want, mag = _bwd_reference(gy, x.shape, p)
    # one rounding of the result, and the f32 sum's own error
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -21
    assert bool(((d1.double() - want).abs() <= ulp * mag).all())


@pytest.mark.cuda
def test_ring_kernels_replay_in_a_cuda_graph(card):
    b, h, w, c, p = 2, 16, 32, 154, 2
    x = torch.randn(b, h, w, c, generator=card).to("cuda", torch.bfloat16)
    gy = torch.randn(b, h + 2 * p, w + 2 * p, c,
                     generator=card).to("cuda", torch.bfloat16)
    R._ring_bwd(gy, p, x.shape)           # load the library before capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = R._ring_fwd(x, p)
        dx = R._ring_bwd(gy, p, x.shape)
    x.copy_(torch.randn(x.shape, generator=card))
    gy.copy_(torch.randn(gy.shape, generator=card))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, R._ring_fwd(x, p))
    assert torch.equal(dx, R._ring_bwd(gy, p, x.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 2])
def test_library_reflect_conv_launches_the_ring_once_each_way(
        card, monkeypatch, dilation):
    """A library reflect conv of a train step: one forward and one backward
    launch, a contiguous NHWC output, the plain version never taken, and
    values and gradients of F.pad + F.conv2d at f32."""
    monkeypatch.delenv(TL.FUSED_TRAIN_ENV, raising=False)
    monkeypatch.delenv(C.DW_ENV, raising=False)

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(R, "reflect_ring_plain", no_plain)
    x = torch.randn(2, 12, 20, 64, generator=card).cuda().requires_grad_()
    k = (torch.randn(3, 3, 64, 32, generator=card) * 0.05).cuda()
    k.requires_grad_()
    gy = torch.randn(2, 12, 20, 32, generator=card).cuda()
    before = dict(R.RING_LAUNCHES)
    with TL.training():
        y = TL.conv2d(x, k, None, reflect=True, dilation=dilation)
        dx, dk = torch.autograd.grad(y, (x, k), gy)
    moved = {key: n - before.get(key, 0)
             for key, n in R.RING_LAUNCHES.items() if n != before.get(key, 0)}
    assert moved == {("fwd", torch.float32, dilation): 1,
                     ("bwd", torch.float32, dilation): 1}
    assert y.is_contiguous()
    xr, kr = x.detach().requires_grad_(), k.detach().requires_grad_()
    yr = F.conv2d(_pad_nchw(xr, dilation), kr.permute(3, 2, 0, 1),
                  dilation=dilation).permute(0, 2, 3, 1)
    dxr, dkr = torch.autograd.grad(yr, (xr, kr), gy)
    for a, r in ((y, yr), (dx, dxr), (dk, dkr)):
        tol = 1e-5 * float(r.abs().max())
        assert float((a - r).abs().max()) <= tol

