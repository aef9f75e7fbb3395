"""The port's training convolutions on the CPU at small shapes, against the
JAX package: the dW kernel's plain version against pallas_conv.conv3x3_dw
(interpret mode), the conv3x3_xla_pdw Function and the conv3x3_fused
Function (its backward: dx through the conv kernel's plain version, the
reflect ring's scatter, the library dW) against jax.grad of their JAX
counterparts, the bf16 dtype contract of the dW route, the conv gates
against the JAX gates on every 3x3 conv shape of the flagship forward and
train step, and the routing inside nn.layers.training() under each setting
of COCOSNET_FUSED_CONV_TRAIN and COCOSNET_PALLAS_DW.

Tolerances, each relative to the largest magnitude of the reference: 2e-5
for the f32 weight gradients (sums over B*H*W = 256 products of N(0, 1)
values, reordered; measured below 2e-6) and 1e-5 for everything else (the
same math in another framework's f32 order). The loss is sum(sin(y)), so
every output element gets its own cotangent."""

from contextlib import nullcontext

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu.ops import pallas_conv as PC
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.tools.ab_dw import predicted_launches, record_convs
from test_torch_threads import torch_threads  # noqa: F401


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _inputs(shape, seed):
    b, h, w, ci, co = shape
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, ci).astype(np.float32)
    k = (rs.randn(3, 3, ci, co) * 0.05).astype(np.float32)
    bias = rs.randn(co).astype(np.float32)
    g = rs.randn(b, h, w, co).astype(np.float32)
    return x, k, bias, g


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 64), (1, 4, 16, 151, 200)])
def test_dw_plain_matches_pallas_dw(shape, reflect):
    """conv3x3_dw on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode, at tests/test_pallas_conv.py's shapes."""
    x, _, _, g = _inputs(shape, 3)
    before = C.conv3x3_dw.plain_calls
    dw, db = C.conv3x3_dw(torch.from_numpy(x), torch.from_numpy(g),
                          reflect=reflect)
    assert C.conv3x3_dw.plain_calls == before + 1
    assert dw.dtype == db.dtype == torch.float32
    jdw, jdb = PC.conv3x3_dw(jnp.asarray(x), jnp.asarray(g), reflect=reflect)
    _close(dw.numpy(), jdw, 2e-5)
    _close(db.numpy(), jdb, 1e-5)


def _grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y = fn(*ts)
    gs = torch.autograd.grad(torch.sin(y).sum(), ts)
    return y.detach().numpy(), [t.numpy() for t in gs]


def _jax_grads(fn, arrays):
    js = [jnp.asarray(a) for a in arrays]
    y = fn(*js)
    gs = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))),
                  argnums=tuple(range(len(js))))(*js)
    return np.asarray(y), [np.asarray(t) for t in gs]


@pytest.mark.parametrize("reflect", [False, True])
def test_xla_pdw_grads_match_jax(reflect):
    """The dW route's Function: output and the x, kernel and bias gradients
    against jax.grad of pallas_conv.conv3x3_xla_pdw (tests/
    test_pallas_conv.py:257-283's shapes); the backward runs conv3x3_dw
    once."""
    x, k, bias, _ = _inputs((2, 8, 16, 64, 64), 4)
    before = C.conv3x3_dw.plain_calls
    y, got = _grads(lambda a, b, c: C.conv3x3_xla_pdw(a, b, c, reflect),
                    (x, k, bias))
    assert C.conv3x3_dw.plain_calls == before + 1
    jy, want = _jax_grads(
        lambda a, b, c: PC.conv3x3_xla_pdw(a, b, c, reflect), (x, k, bias))
    _close(y, jy, 1e-5)
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        _close(a, r, 2e-5 if name == "dw" else 1e-5)


@pytest.mark.parametrize("leaky", [None, 0.2])
@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 16, 64, 64), (2, 6, 32, 96, 64)])
def test_fused_grads_match_jax(shape, reflect, leaky):
    """conv3x3_fused on inputs that require grad (the _FusedConv Function)
    against jax.grad of pallas_conv.conv3x3_fused in interpret mode, whose
    custom VJP runs dx through the same kernel and the reflect ring's
    scatter: every ring cell and corner of dx is held."""
    x, k, bias, _ = _inputs(shape, 5)
    before = (C.conv3x3_fused.plain_calls,
              C.conv3x3_fused_backward.plain_calls)
    y, got = _grads(lambda a, b, c: C.conv3x3_fused(a, b, c, reflect=reflect,
                                                    leaky=leaky),
                    (x, k, bias))
    assert (C.conv3x3_fused.plain_calls,
            C.conv3x3_fused_backward.plain_calls) == (before[0] + 1,
                                                      before[1] + 1)
    jy, want = _jax_grads(
        lambda a, b, c: PC.conv3x3_fused(a, b, c, reflect=reflect,
                                         leaky=leaky), (x, k, bias))
    _close(y, jy, 1e-5)
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        _close(a, r, 2e-5 if name == "dw" else 1e-5)


def test_fused_backward_skips_what_no_input_needs():
    """A frozen kernel and bias (the VGG's) take no dW; an input that needs
    no gradient takes no dx launch."""
    x, k, bias, _ = _inputs((1, 8, 16, 64, 64), 6)
    xt = torch.from_numpy(x).requires_grad_()
    n = C.conv3x3_fused_backward.plain_calls
    gx, = torch.autograd.grad(C.conv3x3_fused(
        xt, torch.from_numpy(k), torch.from_numpy(bias)).sum(), xt)
    assert gx.shape == xt.shape and C.conv3x3_fused_backward.plain_calls == n + 1
    kt = torch.from_numpy(k).requires_grad_()
    gk, = torch.autograd.grad(C.conv3x3_fused(torch.from_numpy(x), kt).sum(),
                              kt)
    assert gk.dtype == torch.float32
    assert C.conv3x3_fused_backward.plain_calls == n + 1


@pytest.mark.parametrize("reflect", [False, True])
def test_pdw_bf16_dw_reaches_an_f32_weight_unrounded(reflect):
    """Under the bf16 policy the dW route's kernel is the f32 weight, rounded
    to bf16 inside: its gradient is conv3x3_dw's f32 result, not a bf16
    rounding of it, as JAX's custom VJP hands back an f32 dw (pallas_conv.
    py:570) that reaches the f32 parameter through the cast's transpose."""
    x, k, bias, _ = _inputs((1, 8, 32, 16, 24), 7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    kt = torch.from_numpy(k).requires_grad_()
    y = C.conv3x3_xla_pdw(xb, kt, torch.from_numpy(bias), reflect)
    assert y.dtype == torch.bfloat16
    gy = torch.autograd.grad((y.float() ** 2).sum(), y, retain_graph=True)[0]
    gk, = torch.autograd.grad((y.float() ** 2).sum(), kt)
    assert gk.dtype == torch.float32
    dw, _ = C.conv3x3_dw_plain(xb, gy, reflect=reflect)
    assert torch.equal(gk, dw)
    assert not torch.equal(gk, gk.to(torch.bfloat16).float())

    def jloss(kk):
        yy = PC.conv3x3_xla_pdw(jnp.asarray(xb.float().numpy()).astype(
            jnp.bfloat16), kk.astype(jnp.bfloat16), jnp.asarray(bias),
            reflect)
        return jnp.sum(yy.astype(jnp.float32) ** 2)

    jgk = jax.grad(jloss)(jnp.asarray(k))
    assert jgk.dtype == jnp.float32
    # both sides round y (and so g = 2y) to bf16 after their own f32 convs:
    # an element of g may land one bf16 ulp apart
    _close(gk.numpy(), jgk, 2e-2)


# ------------------------------------------------------------------ gates

# every 3x3 conv of one flagship forward (256 px, ngf 64, 151 classes) and
# one flagship train step, as (H, W, Cin, Cout, stride, padding, reflect),
# recorded with tools/ab_dw.record_convs; then edge shapes (odd channel
# counts, a width that is no multiple of 16, the pad-ratio boundary)
FLAGSHIP_SHAPES = [
    (8, 8, 128, 1024, 1, 0, True), (8, 8, 154, 128, 1, 0, True),
    (8, 8, 154, 1024, 1, 1, False), (8, 8, 1024, 1024, 1, 0, True),
    (16, 16, 128, 1024, 1, 0, True), (16, 16, 154, 128, 1, 0, True),
    (16, 16, 512, 512, 1, 1, False), (16, 16, 1024, 1024, 1, 0, True),
    (32, 32, 128, 512, 1, 0, True), (32, 32, 128, 1024, 1, 0, True),
    (32, 32, 154, 128, 1, 0, True), (32, 32, 256, 512, 1, 1, False),
    (32, 32, 512, 512, 1, 0, True), (32, 32, 512, 512, 1, 1, False),
    (32, 32, 1024, 512, 1, 0, True), (64, 64, 3, 128, 1, 0, True),
    (64, 64, 128, 256, 1, 0, True), (64, 64, 128, 256, 1, 1, False),
    (64, 64, 128, 512, 1, 0, True), (64, 64, 151, 128, 1, 0, True),
    (64, 64, 154, 128, 1, 0, True), (64, 64, 256, 256, 1, 0, True),
    (64, 64, 256, 256, 1, 1, False), (64, 64, 407, 407, 1, 0, True),
    (64, 64, 512, 256, 1, 0, True), (64, 64, 512, 512, 1, 0, True),
    (64, 64, 512, 512, 1, 1, False), (128, 128, 64, 128, 1, 1, False),
    (128, 128, 128, 128, 1, 0, True), (128, 128, 128, 128, 1, 1, False),
    (128, 128, 128, 256, 1, 0, True), (128, 128, 128, 256, 1, 1, False),
    (128, 128, 154, 128, 1, 0, True), (128, 128, 256, 128, 1, 0, True),
    (128, 128, 256, 512, 2, 1, False), (256, 256, 3, 64, 1, 1, False),
    (256, 256, 64, 3, 1, 1, False), (256, 256, 64, 64, 1, 0, True),
    (256, 256, 64, 64, 1, 1, False), (256, 256, 64, 128, 2, 1, False),
    (256, 256, 128, 64, 1, 0, True), (256, 256, 128, 128, 1, 0, True),
    (256, 256, 151, 64, 1, 1, False), (256, 256, 154, 128, 1, 0, True),
]
EDGE_SHAPES = [
    (64, 24, 128, 128, 1, 1, False), (32, 64, 64, 64, 1, 1, False),
    (16, 64, 64, 64, 1, 1, False), (64, 64, 151, 151, 1, 0, True),
    (64, 64, 154, 154, 1, 1, False), (64, 64, 407, 128, 1, 0, True),
    (64, 64, 256, 257, 1, 0, True), (64, 64, 257, 257, 1, 0, True),
    (64, 64, 512, 407, 1, 0, True), (64, 64, 64, 64, 1, 2, False),
    (64, 64, 63, 64, 1, 1, False),
]


def _vmem_feasible(h, w, c, co):
    """Whether the JAX gates' TPU tile searches (pallas_conv._pick_tiles
    in both orientations, _pick_tiles_dw) find tiles within its 12 MiB of
    VMEM at bf16. The port drops that condition, which has no H100
    meaning, so shapes where it fails are left out of the comparison."""
    cp, cop = PC._round_up(c, 128), PC._round_up(co, 128)
    return (PC._pick_tiles(h, w, cp, cop, 2) is not None
            and PC._pick_tiles(h, w, cop, cp, 2) is not None
            and PC._pick_tiles_dw(h, w, cp, cop, 2) is not None)


def test_gate_shapes_are_vmem_feasible():
    """Every listed shape that passes the size conditions is one the TPU's
    tile search takes, so no shape of the list is left out."""
    for h, w, c, co, *_ in FLAGSHIP_SHAPES + EDGE_SHAPES:
        if w % 16 == 0 and w >= 32 and h >= 8 and h * w >= 2048 \
                and min(c, co) >= 64:
            assert _vmem_feasible(h, w, c, co), (h, w, c, co)


@pytest.mark.parametrize("fused_train", [None, "1"])
@pytest.mark.parametrize("dw", [None, "1", "all"])
def test_gates_agree_with_jax(monkeypatch, fused_train, dw):
    """conv3x3_supported, conv3x3_stats_supported and conv3x3_dw_supported
    of the port against the JAX package's, with its TPU check patched to
    True, on every listed shape, inside and outside training."""
    monkeypatch.setattr(PC, "_is_tpu", lambda: True)
    for env, val in ((TL.FUSED_TRAIN_ENV, fused_train), (C.DW_ENV, dw)):
        if val is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, val)
    for training in (False, True):
        for h, w, c, co, stride, padding, reflect in (FLAGSHIP_SHAPES
                                                      + EDGE_SHAPES):
            xs, ks = (8, h, w, c), (3, 3, c, co)
            kw = dict(stride=stride, padding=1 if reflect else padding)
            with (PC.training_trace() if training else nullcontext()):
                want = (PC.conv3x3_supported(xs, ks, dilation=1, **kw),
                        PC.conv3x3_stats_supported(xs, ks, dilation=1, **kw),
                        PC.conv3x3_dw_supported(xs, ks, reflect=reflect))
            with (TL.training() if training else nullcontext()):
                got = (TL.conv3x3_supported(xs, ks, **kw),
                       TL.conv3x3_stats_supported(xs, ks, **kw),
                       C.conv3x3_dw_supported(xs, ks, reflect=reflect))
            assert got == want, (training, xs, ks, kw, got, want)


# (label map shape, classes, Cout): the flagship's seg adaptor conv, and
# each size condition of the one-hot gate just met and just missed
ONEHOT_SHAPES = [
    ((6, 256, 256), 151, 64), ((1, 128, 256), 13, 16), ((2, 64, 64), 13, 8),
    ((1, 16, 128), 12, 64), ((1, 8, 128), 12, 64), ((1, 4, 512), 12, 64),
    ((1, 8, 256), 151, 64), ((2, 512, 512), 151, 64), ((1, 16, 128), 12, 63),
    ((1, 16, 192), 12, 64), ((1, 16, 384), 200, 256), ((1, 16, 128, 1), 12,
                                                       64),
]


def test_onehot_shapes_are_vmem_feasible():
    """Every listed shape that passes the one-hot gate's size conditions is
    one the TPU's tile search (pallas_conv._pick_tiles_onehot) takes, so the
    JAX gate can be compared on all of them."""
    for lab, nc, co in ONEHOT_SHAPES:
        if len(lab) == 3 and lab[2] % 128 == 0 and lab[1] >= 8 \
                and lab[1] * lab[2] >= 2048 and co >= 64:
            assert PC._pick_tiles_onehot(
                lab[1], lab[2], PC._round_up(nc, 128), PC._round_up(co, 128),
                2) is not None, (lab, nc, co)


@pytest.mark.parametrize("onehot_env", [None, "1", "0", "false"])
def test_onehot_gate_agrees_with_jax(monkeypatch, onehot_env):
    """conv3x3_onehot_supported of the port against the JAX package's, with
    its TPU check patched to True, on every listed shape, inside and
    outside training, under each setting of COCOSNET_ONEHOT_CONV."""
    monkeypatch.setattr(PC, "_is_tpu", lambda: True)
    if onehot_env is None:
        monkeypatch.delenv(TL.ONEHOT_ENV, raising=False)
    else:
        monkeypatch.setenv(TL.ONEHOT_ENV, onehot_env)
    taken = 0
    for training in (False, True):
        for lab, nc, co in ONEHOT_SHAPES:
            with (PC.training_trace() if training else nullcontext()):
                want = PC.conv3x3_onehot_supported(lab, nc, co)
            with (TL.training() if training else nullcontext()):
                got = TL.conv3x3_onehot_supported(lab, nc, co)
            assert got == want, (training, lab, nc, co, got, want)
            taken += got
    assert taken == (0 if onehot_env in ("0", "false") else 5)


# (switch, value, plain calls of the three inference convs below)
SWITCHES = [
    (None, None, {"conv3x3_onehot": 1, "conv3x3_fused_stats": 1,
                  "conv3x3_fused": 1}),
    ("FUSED_ENV", "0", {"conv3x3_onehot": 1}),
    ("FUSED_ENV", "false", {"conv3x3_onehot": 1}),
    ("FUSED_ENV", "1", {"conv3x3_onehot": 1, "conv3x3_fused_stats": 1,
                        "conv3x3_fused": 1}),
    # the stats request takes the conv below it: the fused kernel
    ("FUSED_STATS_ENV", "0", {"conv3x3_onehot": 1, "conv3x3_fused": 2}),
    # the labels densify: 12 input channels take the library conv
    ("ONEHOT_ENV", "false", {"conv3x3_fused_stats": 1, "conv3x3_fused": 1}),
]


@pytest.mark.parametrize("switch,value,expected", SWITCHES)
def test_inference_switches_route_to_the_library(monkeypatch, switch, value,
                                                 expected):
    """Outside training, one conv of each inference kernel (the one-hot conv
    of a 16 x 128 label map, a statistics conv and a reflect-ring conv at
    64 channels) under each setting of the JAX package's switches: the
    plain calls of each entry are what the routing predicts (a switch that
    is off leaves its kernel at 0) and the outputs match the JAX package's
    nn.layers.conv2d under the same switch (XLA convs on the CPU)."""
    from cocosnet_tpu.nn import layers as JL
    for name in ("FUSED_ENV", "FUSED_STATS_ENV", "ONEHOT_ENV"):
        monkeypatch.delenv(getattr(TL, name), raising=False)
    if switch is not None:
        monkeypatch.setenv(getattr(TL, switch), value)
    rs = np.random.RandomState(9)
    labels = rs.randint(0, 12, (1, 16, 128)).astype(np.int32)
    x = rs.randn(1, 32, 64, 64).astype(np.float32)
    k1 = (rs.randn(3, 3, 12, 64) * 0.2).astype(np.float32)
    k2 = (rs.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    bias = rs.randn(64).astype(np.float32)
    cases = [
        (lambda m, t: m.OneHotLabels(t, 12), labels, k1,
         dict(padding=1, want_stats=True)),
        (lambda m, t: t, x, k2, dict(padding=1, want_stats=True)),
        (lambda m, t: t, x, k2, dict(reflect=True)),
    ]
    before = {n: getattr(C, n).plain_calls for n in COUNTED}
    got, want = [], []
    for wrap, inp, k, kw in cases:
        got.append(TL.conv2d(wrap(TL, torch.from_numpy(inp)),
                             torch.from_numpy(k), torch.from_numpy(bias),
                             **kw))
        want.append(JL.conv2d(wrap(JL, jnp.asarray(inp)), jnp.asarray(k),
                              jnp.asarray(bias), **kw))
    moved = {n: getattr(C, n).plain_calls - before[n] for n in COUNTED}
    assert {n: v for n, v in moved.items() if v} == expected
    for g, w in zip(got, want):
        for a, r in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            _close(a.numpy(), np.asarray(r), 1e-5)


# ---------------------------------------------------------------- routing

# (name, x shape, cout, conv2d keywords): shapes of the gates' sizes, small
# enough for the CPU; the second is a winner of COCOSNET_PALLAS_DW=1
ROUTING_CONVS = [
    ("reflect 64->64", (1, 32, 64, 64), 64, dict(reflect=True)),
    ("winner 154->128", (1, 64, 64, 154), 128, dict(reflect=True)),
    ("stats 64->64", (1, 32, 64, 64), 64, dict(padding=1, want_stats=True)),
    ("stride 2", (1, 32, 64, 64), 64, dict(padding=1, stride=2)),
    ("frozen 64->64", (1, 32, 64, 64), 64, dict(padding=1)),
]
COUNTED = ("conv3x3_fused", "conv3x3_fused_stats", "conv3x3_fused_backward",
           "conv3x3_dw", "conv3x3_onehot")


@pytest.mark.parametrize("fused_train,dw,expected", [
    (None, None, {}),
    (None, "1", {"conv3x3_dw": 1}),
    (None, "all", {"conv3x3_dw": 3}),
    ("1", None, {"conv3x3_fused": 4, "conv3x3_fused_backward": 4}),
    ("1", "all", {"conv3x3_fused": 4, "conv3x3_fused_backward": 4}),
])
def test_training_routing_counts(monkeypatch, fused_train, dw, expected):
    """One forward and backward of the ROUTING_CONVS inside training(): the
    calls of each entry (their plain versions here) are what the routing
    predicts, tools/ab_dw.predicted_launches agrees, and the results equal
    the library route's. The frozen conv's weight takes no gradient, so it
    takes no dW; the stats request takes the conv below it and torch
    moments (no statistics kernel in training)."""
    for env, val in ((TL.FUSED_TRAIN_ENV, fused_train), (C.DW_ENV, dw)):
        if val is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, val)
    rs = np.random.RandomState(8)
    convs = []
    for name, xs, co, kw in ROUTING_CONVS:
        x = torch.from_numpy(rs.randn(*xs).astype(np.float32))
        k = torch.from_numpy((rs.randn(3, 3, xs[3], co) * 0.05).astype(
            np.float32))
        convs.append((x.requires_grad_(), k.requires_grad_(name != "frozen "
                                                           "64->64"), kw))

    def run():
        out = []
        for x, k, kw in convs:
            y = TL.conv2d(x, k, None, **kw)
            out.append(y[0] + y[1] + y[2] if kw.get("want_stats") else y)
        return out

    before = {n: getattr(C, n).plain_calls for n in COUNTED}
    with TL.training():
        outs = []
        records = record_convs(lambda: outs.extend(run()))
        leaves = [t for x, k, _ in convs for t in (x, k) if t.requires_grad]
        grads = torch.autograd.grad(sum(torch.sin(y).sum() for y in outs),
                                    leaves)
    moved = {n: getattr(C, n).plain_calls - before[n] for n in COUNTED}
    assert {n: v for n, v in moved.items() if v} == expected
    assert {n: v for n, v in predicted_launches(records).items() if v} \
        == expected
    monkeypatch.delenv(TL.FUSED_TRAIN_ENV, raising=False)
    monkeypatch.delenv(C.DW_ENV, raising=False)
    with TL.training():
        want = run()
        wgrads = torch.autograd.grad(sum(torch.sin(y).sum() for y in want),
                                     leaves)
    for a, r in zip(outs, want):
        _close(a.detach().numpy(), r.detach().numpy(), 1e-5)
    for a, r in zip(grads, wgrads):
        _close(a.numpy(), r.numpy(), 2e-5)
