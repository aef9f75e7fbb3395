"""The port's CUDA kernels against their plain versions on the card, at small
shapes, through the public wrappers. Marked `cuda`: each test skips where
there is no CUDA device. On a GPU machine, from the repository root
(--noconftest: tests/conftest.py sets up JAX, which this file does not use):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(chip_smoke.py holds the same kernels at the flagship shapes.)"""

import os

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
    (2, 2, 2, 64, 64),
    # the flagship's channel pairs at reduced spatial size (rows of 64 and
    # 32 pixels: the tensor-copy path where the rule takes it), and a
    # request's 64 x 64 grid
    (1, 16, 64, 407, 407), (2, 8, 64, 128, 512), (2, 16, 32, 154, 128),
    (1, 16, 64, 151, 128), (1, 8, 64, 512, 256), (2, 16, 32, 128, 64),
    (1, 64, 64, 128, 512)])
def test_conv3x3_kernel_matches_plain(gen, shape, stats, reflect, dtype):
    """Every branch of csrc/conv3x3.cu (the tiles the rule takes, inputs
    with and without the channel-padded copy, ragged pixel and channel
    tiles, the statistics epilogue) against conv3x3_plain on the same
    operands."""
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


def _conv_operands(g, b, h, w, ci, co):
    return (_r(g, b, h, w, ci, dtype=torch.bfloat16),
            _r(g, 3, 3, ci, co, scale=(9 * ci) ** -0.5, dtype=torch.bfloat16),
            _r(g, co, scale=0.1))


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("path", C.CONV_PATHS)
@pytest.mark.parametrize("tile", C.CONV_TILES,
                         ids=[f"{m}x{n}" for m, n in C.CONV_TILES])
@pytest.mark.parametrize("shape", [(2, 16, 64, 407, 407),
                                   (1, 8, 128, 128, 136)],
                         ids=["407-407-rows64", "128-136-rows128"])
def test_conv3x3_kernel_runs_every_configuration(gen, monkeypatch, shape,
                                                 tile, path, reflect):
    """Each configuration the tile rule can choose, (TM, TN) of CONV_TILES
    by either path, forced on the flagship's 407 -> 407 statistics conv at
    16 x 64 and on a ragged 136-channel output at 8 x 128 (whole row
    segments at every TM, so "box" runs its tensor copies): the output and
    the moments as conv3x3_plain's, and the launch counted under it."""
    b, h, w, ci, co = shape
    x, k, bias = _conv_operands(gen, b, h, w, ci, co)
    monkeypatch.setattr(C, "tile_config", lambda *a, **kw: tile + (path,))
    n = C.TILE_LAUNCHES[tile + (path,)]
    got = C.conv3x3_fused_stats(x, k, bias, reflect=reflect)
    assert C.TILE_LAUNCHES[tile + (path,)] == n + 1
    want = C.conv3x3_plain(x, k, bias, reflect=reflect, want_stats=True)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=_tol(want[0], torch.bfloat16))
    for a, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 64, 407, 407),
                                   (1, 16, 64, 128, 512),
                                   (2, 8, 256, 154, 128)],
                         ids=["407-407", "128-512", "154-128"])
def test_conv3x3_kernel_gives_the_same_bits(gen, shape):
    """Two calls on the same operands: the same output and moments bit for
    bit (no atomics; the statistics' partials summed in a fixed order)."""
    x, k, bias = _conv_operands(gen, *shape)
    first = C.conv3x3_fused_stats(x, k, bias, reflect=True)
    again = C.conv3x3_fused_stats(x, k, bias, reflect=True)
    for a, r in zip(first, again):
        assert torch.equal(a, r)


def test_conv3x3_kernel_graph_replays_the_eager_call(gen):
    """Calls captured in a CUDA graph (as GraphStep captures the forward)
    and replayed on new operands copied into the captured inputs: the eager
    calls' bits. Nothing of one launch carries to the next."""
    shapes = [(2, 16, 64, 407, 407), (1, 16, 64, 128, 512)]
    ops = [_conv_operands(gen, *s) for s in shapes]

    def calls():
        return [C.conv3x3_fused_stats(x, k, bias, reflect=True)
                for x, k, bias in ops]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for _ in range(2):
        for (x, k, bias), s in zip(ops, shapes):
            new = _conv_operands(gen, *s)
            x.copy_(new[0])
            k.copy_(new[1])
            bias.copy_(new[2])
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, calls()):
            for a, r in zip(got, want):
                assert torch.equal(a, r)


def test_b6_serve_forward_takes_the_rules_configurations(gen):
    """The flagship's B6 serve graph (ADE20k, 256 px, ngf 64, bf16): the
    capture call's conv3x3.cu launches, counted by configuration in
    TILE_LAUNCHES, are those tile_config gives the forward's 100 calls
    (torch_fixtures.FORWARD_CONVS)."""
    import collections

    from cocosnet_tpu_torch import config as TCFG
    from cocosnet_tpu_torch import pix2pix as TP
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.tools import serve as SV
    from torch_fixtures import FORWARD_CONVS, condition
    opt = TCFG.test_defaults(
        dataset_mode="ade20k", label_nc=150, contain_dontcare_label=True,
        crop_size=256, load_size=256, batchSize=6, ngf=64,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", match_kernel=3, isTrain=False)
    L.set_compute_dtype(torch.bfloat16)
    try:
        nets = TP.Pix2PixNets(opt, device="cuda")
        condition(nets.gen, 1)
        condition(nets.corr, 2)
        step = SV.make_serve_step(nets, 6)
        step.warm_up()
        before = collections.Counter(C.TILE_LAUNCHES)
        step.capture()
        taken = collections.Counter(C.TILE_LAUNCHES)
        taken.subtract(before)
        taken = +taken
    finally:
        L.set_compute_dtype(None)
    want = collections.Counter()
    for (b, h, w, ci, co, _, _), n in FORWARD_CONVS["ade20k-b6"]:
        want[C.tile_config(b, h, w, ci, co)] += n
    assert sum(taken.values()) == 100
    assert taken == want


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
                                   (20, 13, 8, 5),
                                   # the celebahq and deepfashion warps'
                                   # value widths
                                   (16, 16, 16, 22), (8, 64, 16, 48)])
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
                                   (20, 13, 8, 5),
                                   # the warp widths of the other
                                   # configurations: D 22 (32-column dV
                                   # tiles), 48 (one 96-column tile, half
                                   # zero) and 3 (padded to 4)
                                   (16, 16, 16, 22), (8, 32, 16, 48),
                                   (16, 16, 16, 3)])
def test_shift9_bwd_kernel_matches_plain(gen, shape, pono_c):
    """The backward kernel's five outputs against shift9_bwd_plain in f64
    on the same inputs, each within 1e-4 of its largest magnitude (3xTF32
    products, sums over N in another order, 1/tau = 100 in the logits).
    The yardstick is f64: the f32 plain version is itself up to 1.2e-4
    from it on some draws (tools/shift9_bwd_accuracy.py)."""
    h, w, c, d = shape
    f, g = _r(gen, 2, h, w, c), _r(gen, 2, h, w, c, scale=1.5) + 0.2
    v, go = _r(gen, 2, h * w, d), _r(gen, 2, h * w, d)
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, pono_c)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    args = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
    got = S.shift9_bwd_kernel(*args)
    want = [t.float() for t in S.shift9_bwd_plain(*(
        a.double() if torch.is_tensor(a) else a for a in args))]
    for name, a, r in zip(("dF3", "dqv", "dG3", "dkv", "dV"), got, want):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)
    assert torch.equal(got[1][..., 3], got[1][..., 2])
    assert not got[3][:, 3].any()


@pytest.mark.parametrize("d", [3, 22, 48])
def test_shift9_kernels_match_plain_with_roles_swapped(gen, d):
    """The column (cycle) warp's call, attend_shift9(g, f, v): the same
    draws with the queries' and the keys' features traded, so the rank-1
    terms qv and kv (and kv's transposed layout in the backward) carry the
    other side's statistics. The forward within 1e-4 of the plain version,
    the backward's outputs within 1e-4 of each one's largest magnitude of
    the f64 plain run."""
    h, w, c = 16, 16, 16
    f, g = _r(gen, 2, h, w, c), _r(gen, 2, h, w, c, scale=1.5) + 0.2
    v, go = _r(gen, 2, h * w, d), _r(gen, 2, h * w, d)
    f3, g3, qv, kv = S.shift9_inputs(g, f, 0.01, True)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    po, plse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.testing.assert_close(o, po, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    args = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
    got = S.shift9_bwd_kernel(*args)
    want = [t.float() for t in S.shift9_bwd_plain(*(
        a.double() if torch.is_tensor(a) else a for a in args))]
    for name, a, r in zip(("dF3", "dqv", "dG3", "dkv", "dV"), got, want):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)


@pytest.mark.parametrize("h,w,c,d,r0,hl,swap", [
    # query shards against every key (nq < nk): a middle shard, the first
    # and the last (their outer halo the unfold's zero padding), one image
    # row, an odd width, D 22 and 154; roles swapped as the column warp
    (16, 24, 32, 5, 5, 3, False), (16, 24, 32, 22, 0, 4, False),
    (16, 24, 32, 3, 15, 1, True), (40, 40, 64, 48, 10, 20, False),
    (32, 64, 256, 154, 16, 16, True)])
def test_shift9_kernels_on_a_query_shard(gen, h, w, c, d, r0, hl, swap):
    """The forward and backward kernels at nq = hl W queries (rows r0 ..
    r0 + hl of the queries' map, as ops/corr_sp.py cuts them) against nk =
    H W keys: the forward within 1e-4 of the plain version and equal to the
    square kernel's rows there within 1e-4, the backward within 1e-4 of
    each output's largest magnitude of the f64 plain run, the same bits on
    two launches."""
    f, g = _r(gen, 2, h, w, c), _r(gen, 2, h, w, c, scale=1.5) + 0.2
    if swap:
        f, g = g, f
    v, go = _r(gen, 2, h * w, d), _r(gen, 2, hl * w, d)
    f3, g3, qv, kv = S.shift9_inputs(f, g, 0.01, True)
    rows = slice(r0 * w, (r0 + hl) * w)
    square = S.shift9_core_kernel(f3, g3, v, qv, kv, w)[0][:, rows]
    f3, qv = f3[:, rows].contiguous(), qv[:, rows].contiguous()
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    po, plse = S.shift9_core_plain(f3, g3, v, qv, kv, w)
    torch.testing.assert_close(o, po, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    torch.testing.assert_close(o, square, rtol=0, atol=1e-4)
    args = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
    got = S.shift9_bwd_kernel(*args)
    want = [t.float() for t in S.shift9_bwd_plain(*(
        a.double() if torch.is_tensor(a) else a for a in args))]
    for name, a, r in zip(("dF3", "dqv", "dG3", "dkv", "dV"), got, want):
        assert a.shape == r.shape, name
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)
    again = S.shift9_bwd_kernel(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_shift9_kernels_on_a_wide_query_map(gen):
    """nq > nk: a query map of 40 rows against a key map of 12 (each
    side's terms from its own map), forward and backward against the plain
    versions (the f64 run for the backward)."""
    w, c, d = 32, 64, 22
    f, g = _r(gen, 2, 40, w, c), _r(gen, 2, 12, w, c)
    v, go = _r(gen, 2, 12 * w, d), _r(gen, 2, 40 * w, d)
    f3, _, qv, _ = S.shift9_inputs(f, f, 0.01, True)
    _, g3, _, kv = S.shift9_inputs(g, g, 0.01, True)
    o, lse = S.shift9_core_kernel(f3, g3, v, qv, kv, w)
    torch.testing.assert_close(o, S.shift9_core_plain(f3, g3, v, qv, kv,
                                                      w)[0],
                               rtol=0, atol=1e-4)
    args = (f3, g3, v, qv, kv, lse, go, (go * o).sum(-1), w)
    got = S.shift9_bwd_kernel(*args)
    want = [t.float() for t in S.shift9_bwd_plain(*(
        a.double() if torch.is_tensor(a) else a for a in args))]
    for name, a, r in zip(("dF3", "dqv", "dG3", "dkv", "dV"), got, want):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()), msg=name)


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


def test_test_twin_on_the_card_matches_its_cpu_run(gen, tmp_path):
    """cli/test.py at 64 px (ngf 8, label_nc 12, f32) on a synthetic ADE20k
    tree, from weights at unit signal scale saved as the reference's flat
    <label>_net_{G,Corr}.pth: --platform gpu against --platform cpu, every
    output within 5e-4 (the CPU parity tests' slice tolerance), the card
    run through the shift9 kernel once a batch."""
    from cocosnet_tpu_torch import config as TCFG
    from cocosnet_tpu_torch import pix2pix as TP
    from cocosnet_tpu_torch.cli import test as TTEST
    from cocosnet_tpu_torch.data import synthetic as SYN
    from cocosnet_tpu_torch.nn import layers as TL
    from torch_fixtures import condition
    root = str(tmp_path / "ade")
    SYN.make_ade20k_tree(root, n_train=2, n_val=4, size=(80, 72),
                         n_classes=13, block=8)
    argv = ["--dataroot", root, "--label_nc", "12", "--crop_size", "64",
            "--load_size", "64", "--ngf", "8", "--use_attention",
            "--maskmix", "--warp_mask_losstype", "direct", "--PONO",
            "--PONO_C", "--batchSize", "2", "--compute_dtype", "f32",
            "--checkpoints_dir", str(tmp_path / "ck"), "--name", "card",
            "--output_dir", str(tmp_path / "out")]
    nets = TP.Pix2PixNets(TCFG.parse_options(argv, is_train=False),
                          device="cpu")
    condition(nets.gen, 1)
    condition(nets.corr, 2)
    os.makedirs(tmp_path / "ck" / "card")
    torch.save(nets.gen.state_dict(),
               tmp_path / "ck" / "card" / "latest_net_G.pth")
    torch.save(nets.corr.state_dict(),
               tmp_path / "ck" / "card" / "latest_net_Corr.pth")
    policy = TL.get_compute_dtype()
    try:
        n = S.attend_shift9.launches
        card = TTEST.main(argv + ["--platform", "gpu"])
        assert S.attend_shift9.launches == n + card.batches
        cpu = TTEST.main(argv + ["--platform", "cpu"])
    finally:
        TL.set_compute_dtype(policy)
    assert card.batches == cpu.batches == 2
    assert card.nets.device.type == "cuda"
    assert float(cpu.first_fake.std()) > 0.05  # the output carries signal
    torch.testing.assert_close(torch.from_numpy(card.first_fake),
                               torch.from_numpy(cpu.first_fake), rtol=0,
                               atol=5e-4)


def test_serve_graph_replays_the_eager_forward(gen):
    """tools/serve.make_serve_step at 256 px (ngf 16, label_nc 12, batch 2,
    f32, weights at unit signal scale: a 64 x 64 feature map, which takes
    the shift9 kernel and both dense conv kernels) on the card: each kernel
    launched as often on the capture call as in one eager forward, and the
    replayed graph's uint8 output the bits of the eager forward quantized
    the same way, on two batches after one capture."""
    from cocosnet_tpu_torch import config as TCFG
    from cocosnet_tpu_torch import pix2pix as TP
    from cocosnet_tpu_torch.tools import serve as SV
    from cocosnet_tpu_torch.train.steps import make_inference_step
    from torch_fixtures import condition
    opt = TCFG.test_defaults(
        dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
        crop_size=256, load_size=256, batchSize=2, ngf=16,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", compute_dtype="f32", isTrain=False)
    nets = TP.Pix2PixNets(opt, device="cuda")
    condition(nets.gen, 1)
    condition(nets.corr, 2)
    counted = (S.attend_shift9, C.conv3x3_fused, C.conv3x3_fused_stats,
               C.conv3x3_onehot)

    def batch():
        return {
            "label": torch.randint(0, 13, (2, 256, 256, 1),
                                   generator=gen).float(),
            "image": torch.zeros(2, 256, 256, 3),
            "ref": torch.rand(2, 256, 256, 3, generator=gen) * 2 - 1,
            "label_ref": torch.randint(0, 13, (2, 256, 256, 1),
                                       generator=gen).float(),
            "self_ref": torch.zeros(2)}

    infer = make_inference_step(nets)
    batches = [batch(), batch()]
    n = [fn.launches for fn in counted]
    eager = [SV.quantize(infer(b)["fake_image"]) for b in batches]
    per_forward = [(fn.launches - k) // 2 for fn, k in zip(counted, n)]
    assert per_forward[0] == 1 and min(per_forward[1:3]) > 0
    step = SV.make_serve_step(nets, 2)
    step.warm_up()
    n = [fn.launches for fn in counted]
    step.capture()
    assert [fn.launches - k for fn, k in zip(counted, n)] == per_forward
    for b, want in zip(batches, eager):
        got = step(b)
        assert got.dtype == torch.uint8 and got.shape == (2, 256, 256, 3)
        assert torch.equal(got, want)
    assert float(eager[0].float().std()) > 10   # far from flat
    # a replay does not run the Python wrappers
    assert [fn.launches - k for fn, k in zip(counted, n)] == per_forward


@pytest.mark.parametrize("flags", [
    dict(remat=True, remat_policy="conv_small"),
    dict(remat=True, remat_full=True)], ids=["conv_small", "block_and_full"])
def test_remat_steps_on_the_card_equal_the_plain_steps(gen, monkeypatch,
                                                       flags):
    """tests/test_torch_remat.py's step (the default BatchNorm norm, mask
    noise) on the card, where the autograd engine recomputes on a thread of
    its own: remat's losses, u/v and running statistics at rel 1e-4 of
    each one's scale, its gradients at 1e-4 of the largest of their
    optimizer's, as the plain step's on the card. One step: the card's
    backward sums some gradients with atomics (the gather and index
    backwards), and D's Adam (eps 1e-8) turns a near-zero gradient's sign
    into a whole step, so a second step compares two trajectories."""
    from test_torch_remat import STATE, _run, check_same_steps
    plain = _run(monkeypatch, device="cuda", steps=1)
    check_same_steps(_run(monkeypatch, device="cuda", steps=1, **flags),
                     plain, rel=1e-4, grad_rel=1e-4, only=STATE)


@pytest.mark.parametrize("route", [
    "shift9", "mk1 kernels", "dW kernel", "fused conv", "remat",
    "remat_full", "noise"])
def test_chunk_graph_replays_the_eager_steps(gen, monkeypatch, tmp_path,
                                             route):
    """train.steps.make_multi_train_step on the card (chip_smoke.py phase
    15 (a) at 64 px, ngf 64, ndf 16, label_nc 12, batch 2, f32, weights at
    unit signal scale) on each training route: a first chunk of 2 runs the
    eager warm-up steps; its state, saved by train.checkpoints (Adam's
    step counts on the card), loads into a second run; then the graph's
    chunk of 2 (the capture, two replays) against two eager steps of the
    second run: the route's kernels launched on the capture call as on an
    eager step, every loss at rel 1e-5, the parameters' moves at 1e-2
    relative L2 (the card's reductions are not deterministic run to run:
    phase 15 measured up to 5e-3 between two eager runs of two steps),
    the state's step counter and the noise generator carried on."""
    from cocosnet_tpu_torch import config as TCFG
    from cocosnet_tpu_torch import pix2pix as TP
    from cocosnet_tpu_torch.models import correspondence as CR
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.train import checkpoints as CK
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    from torch_fixtures import condition
    env, kw, kernels = {
        "shift9": ({}, {}, (S.attend_shift9, S.attend_shift9_backward)),
        "mk1 kernels": ({CR.MK1_TRAIN_ENV: "1"}, dict(match_kernel=1),
                        (K.attend_corr, K.attend_corr_backward)),
        "dW kernel": ({C.DW_ENV: "all"}, {}, (C.conv3x3_dw,)),
        "fused conv": ({L.FUSED_TRAIN_ENV: "1"}, {},
                       (C.conv3x3_fused, C.conv3x3_fused_backward)),
        "remat": ({}, dict(remat=True), (S.attend_shift9,)),
        "remat_full": ({}, dict(remat=True, remat_full=True),
                       (S.attend_shift9,)),
        "noise": ({}, dict(mask_noise=True, noise_for_mask=True),
                  (S.attend_shift9,))}[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    opt = TCFG.test_defaults(**{**dict(
        dataset_mode="ade20k", label_nc=12, contain_dontcare_label=True,
        crop_size=64, load_size=64, batchSize=2, ngf=64, ndf=16,
        use_attention=True, maskmix=True, PONO=True, PONO_C=True,
        warp_mask_losstype="direct", weight_mask=100.0, use_ema=True,
        vgg_normal_correct=True, compute_dtype="f32", isTrain=True,
        checkpoints_dir=str(tmp_path), name="chunk"), **kw})

    def batch():
        return {"label": torch.randint(0, 13, (2, 64, 64, 1),
                                       generator=gen).float().cuda(),
                "image": (torch.rand(2, 64, 64, 3, generator=gen) * 2
                          - 1).cuda(),
                "ref": (torch.rand(2, 64, 64, 3, generator=gen) * 2
                        - 1).cuda(),
                "label_ref": torch.randint(0, 13, (2, 64, 64, 1),
                                           generator=gen).float().cuda(),
                "self_ref": torch.ones(2, device="cuda")}

    def run():
        nets = TP.Pix2PixNets(opt, device="cuda")
        for i, net in enumerate(nets.modules()):
            condition(net, i)
        return nets, TS.create_train_state(opt, nets)

    warm, chunk = [batch(), batch()], [batch(), batch()]
    lr = TS.lrs_for_epoch(opt, 1)
    nets, state = run()
    multi = ST.make_multi_train_step(nets)
    multi(state, warm, lr)
    CK.save_state(opt, state, nets, "warm")
    nets2, state2 = run()
    CK.load_state(opt, state2, nets2, "warm")
    assert state2.step == state.step == 2
    assert all(st["step"].is_cuda for st in state2.opt_g.state.values())
    p0 = {k: p.detach().clone() for k, p in state.g_params.items()}
    n = [fn.launches for fn in kernels]
    got, vis = multi(state, chunk, lr)
    per_capture = [fn.launches - k for fn, k in zip(kernels, n)]
    n = [fn.launches for fn in kernels]
    step = ST.make_train_step(nets2)
    want = [step(state2, b, lr)[0] for b in chunk]
    assert all(k > 0 for k in per_capture)
    assert [(fn.launches - k) // 2 for fn, k in zip(kernels, n)] \
        == per_capture
    for j, w in enumerate(want):
        for k, v in w.items():
            t, o = float(v), float(got[k][j])
            assert abs(o - t) / (abs(t) + 1e-2) <= 1e-5, (j, k, o, t)
    num = den = 0.0
    for k, p in state.g_params.items():
        w = state2.g_params[k].detach().double()
        num += float(((p.detach().double() - w) ** 2).sum())
        den += float(((w - p0[k].double()) ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-2
    assert state.step == state2.step == 4
    assert torch.equal(state.noise.get_state(), state2.noise.get_state())
    assert vis["fake_image"].shape == (2, 64, 64, 3)


def _marks_recorded(fn):
    """The stage marks a profile of fn's device work records, in order,
    after the padding that takes a session's lost head records."""
    from torch.profiler import ProfilerActivity, profile

    from cocosnet_tpu_torch.utils import profiling as PR
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        PR._pad_session()
        fn()
        torch.cuda.synchronize()
    kernels, _ = PR._device_events(prof)
    marks = sorted((start, name) for name, start, _ in kernels
                   if PR.MARK_KERNEL in name)
    return [name.split(PR.MARK_KERNEL, 1)[1].split("(")[0]
            for _, name in marks]


def test_graph_replays_record_every_stage_mark_once(gen):
    """A tiny serve graph (64 px, ngf 8, label_nc 12, batch 1, f32) and a
    tiny chunk graph (batch 2) captured, then replayed under the profiler:
    each replay records each of its stage marks once, in order."""
    from cocosnet_tpu_torch import config as TCFG
    from cocosnet_tpu_torch import pix2pix as TP
    from cocosnet_tpu_torch.tools import serve as SV
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    from cocosnet_tpu_torch.utils import profiling as PR
    model = dict(dataset_mode="ade20k", label_nc=12,
                 contain_dontcare_label=True, crop_size=64, load_size=64,
                 ngf=8, ndf=8, use_attention=True, maskmix=True, PONO=True,
                 PONO_C=True, warp_mask_losstype="direct",
                 compute_dtype="f32")

    def batch(b):
        return {"label": torch.randint(0, 13, (b, 64, 64, 1),
                                       generator=gen).float(),
                "image": torch.rand(b, 64, 64, 3, generator=gen) * 2 - 1,
                "ref": torch.rand(b, 64, 64, 3, generator=gen) * 2 - 1,
                "label_ref": torch.randint(0, 13, (b, 64, 64, 1),
                                           generator=gen).float(),
                "self_ref": torch.ones(b)}

    nets = TP.Pix2PixNets(TCFG.test_defaults(**model, batchSize=1,
                                             isTrain=False), device="cuda")
    step = SV.make_serve_step(nets, 1)
    x = {k: v.numpy() for k, v in batch(1).items()}
    step(x)                      # warm-up, capture, first replay
    got = _marks_recorded(lambda: [step(x) for _ in range(3)])
    assert got == ["prep", "corr", "gen", "end"] * 3

    opt = TCFG.test_defaults(**model, batchSize=2, isTrain=True,
                             use_ema=True, vgg_normal_correct=True,
                             weight_mask=100.0)
    nets = TP.Pix2PixNets(opt, device="cuda")
    state = TS.create_train_state(opt, nets)
    multi = ST.make_multi_train_step(nets)
    lr = TS.lrs_for_epoch(opt, 1)
    batches = [{k: v.cuda() for k, v in batch(2).items()} for _ in range(3)]
    multi(state, batches, lr)    # two eager steps, the capture, a replay
    assert multi.graph is not None
    got = _marks_recorded(lambda: multi(state, batches, lr))
    assert got == list(PR.STAGES) * 3
