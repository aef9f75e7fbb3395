"""--remat, --remat_policy and --remat_full against the port's own plain step
on the CPU at f32, with no JAX jit (the JAX package's remat is held by
tests/test_train_variants.py): two train steps of the reference's default
norm (synchronized BatchNorm in every SPADE block) with --mask_noise, so
that the recompute meets every module that keeps state (each spectral
norm's power iteration, each BatchNorm's running statistics) and a noise
draw (batch 1, crop 64, ngf 8). The losses, the gradients of both
sides, the spectral u/v and the
running statistics equal the plain step's within f32 reordering (rel
1e-5). Also the tape of nn/remat.py itself: a region re-run for its
backward reads back the u and v of its first run, nested regions too,
and the conv policies save the conv outputs they name."""

import numpy as np
import pytest
import torch

from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.nn import remat
from cocosnet_tpu_torch.nn.norms import BatchNorm
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from test_torch_threads import torch_threads  # noqa: F401

B, H = 1, 64
_MEAN_OVER_JOB = M.mean_over_job
OPT = dict(dataset_mode="ade20k", label_nc=5, contain_dontcare_label=True,
           crop_size=H, load_size=H, batchSize=B, ngf=8, ndf=8,
           vgg_normal_correct=True, use_attention=True, maskmix=True,
           warp_mask_losstype="direct", weight_mask=100.0, mask_noise=True,
           use_ema=True, isTrain=True)


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {
        "label": rs.randint(0, 6, (B, H, H, 1)).astype(np.float32),
        "image": (rs.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
        "ref": (rs.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
        "label_ref": rs.randint(0, 6, (B, H, H, 1)).astype(np.float32),
        "self_ref": np.ones((B,), np.float32),
    }


def _signal(nets):
    """Kernels at 1/sqrt(fan_in), biases at 0.1, the attention gates at
    0.5, spectral u/v random unit vectors (so every power iteration moves
    them: a second advance on a recompute would show)."""
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for net in nets.modules():
            for name, t in net.named_parameters():
                if name.endswith(("weight", "weight_orig")) and t.dim() > 1:
                    t.copy_(torch.randn(t.shape, generator=g)
                            * t[0].numel() ** -0.5)
                elif name.endswith("bias"):
                    t.copy_(torch.randn(t.shape, generator=g) * 0.1)
                elif name.endswith("gamma"):
                    t.fill_(0.5)
            for name, t in net.named_buffers():
                if name.endswith(("weight_u", "weight_v")):
                    x = torch.randn(t.shape, generator=g)
                    t.copy_(x / x.norm())


def _run(monkeypatch, device="cpu", steps=2, **flags):
    """`steps` steps on `device`: (losses per step, the gradients each
    step's two optimizers took, every net's state dict after them, on the
    host)."""
    opt = TCFG.test_defaults(**dict(OPT, **flags))
    nets = TP.Pix2PixNets(opt, device="cpu")
    _signal(nets)
    if device != "cpu":
        # the same drawn weights on the card
        sds = [m.state_dict() for m in nets.modules()]
        nets = TP.Pix2PixNets(opt, device=device)
        for m, sd in zip(nets.modules(), sds):
            m.load_state_dict(sd)
    state = TS.create_train_state(opt, nets)
    grads = []
    # _apply_grads hands each optimizer's gradients to mean_over_job (the
    # unpatched one: a second run under the same monkeypatch must not
    # chain onto the first run's recorder)
    monkeypatch.setattr(TST.M, "mean_over_job",
                        lambda ts: grads.append([t.cpu() for t in ts])
                        or _MEAN_OVER_JOB(ts))
    step = TST.make_train_step(nets)
    lr = TS.lrs_for_epoch(opt, 1)
    losses = [{k: float(v) for k, v in step(state, _batch(i), lr)[0].items()}
              for i in range(steps)]
    sds = {name: {k: v.cpu().clone() for k, v in
                  getattr(nets, name).state_dict().items()}
           for name in ("gen", "corr", "disc")}
    return losses, grads, sds


@pytest.fixture(scope="module")
def plain():
    with pytest.MonkeyPatch.context() as mp:
        return _run(mp)


def _close(a, b, what, rel=1e-5):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    scale = max(float(a.abs().max()), 1e-3)
    err = float((a - b).abs().max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("flags", [
    dict(remat=True, remat_policy="block"),
    dict(remat=True, remat_policy="conv"),
    dict(remat=True, remat_policy="conv_small"),
    dict(remat_full=True),
    dict(remat=True, remat_full=True)],
    ids=["block", "conv", "conv_small", "full", "block_and_full"])
def test_remat_step_equals_the_plain_step(plain, monkeypatch, flags):
    check_same_steps(_run(monkeypatch, **flags), plain)


STATE = ("weight_u", "weight_v", "running_mean", "running_var",
         "num_batches_tracked")


def check_same_steps(got_run, want_run, rel=1e-5, grad_rel=None,
                     only=None):
    """Losses, gradients and the state-dict entries (all, or those ending
    in `only`) of two runs of `_run`, each at `rel` of its own scale; with
    `grad_rel`, each gradient at grad_rel of the largest gradient its
    optimizer took (a bias whose gradient cancels to 1e-3 carries the
    sums' reordering at a larger share of its own scale)."""
    losses, grads, sds = got_run
    want_losses, want_grads, want_sds = want_run
    for step, (got, want) in enumerate(zip(losses, want_losses)):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], (step, k), rel)
    assert len(grads) == len(want_grads)
    for i, (got, want) in enumerate(zip(grads, want_grads)):
        top = max(float(w.abs().max()) for w in want)
        for j, (g, w) in enumerate(zip(got, want)):
            if grad_rel is None:
                _close(g, w, ("grad", i, j), rel)
            else:
                err = float((g.double() - w.double()).abs().max())
                assert err <= grad_rel * top, ("grad", i, j, err, top)
    for net, sd in want_sds.items():
        assert (any(k.endswith("running_var") for k in sd)
                or net == "disc")
        for k in sd:
            if only is None or k.endswith(only):
                _close(sds[net][k], sd[k], (net, k), rel)


class _Spectral(torch.nn.Module):
    """One spectral conv twice and a BatchNorm, each call a region of its
    own inside an outer one."""

    def __init__(self, policy):
        super().__init__()
        self.conv = TL.Conv2d(4, 4, 3, padding=1, weight_norm="spectral")
        self.bn = BatchNorm(4, affine=False)
        self.policy = policy

    def block(self, x):
        return torch.tanh(self.bn(self.conv(x)))

    def forward(self, x, inner, outer):
        def body(x):
            for _ in range(2):
                x = (remat.checkpoint(self.block, x, policy=self.policy)
                     if inner else self.block(x))
            return x
        return remat.checkpoint(body, x, policy="block") if outer else body(x)


@pytest.mark.parametrize("policy", ["block", "conv", "conv_small"])
@pytest.mark.parametrize("inner,outer", [(True, False), (False, True),
                                         (True, True)])
def test_regions_read_back_what_their_first_run_used(policy, inner, outer):
    """The same module twice in a step, each call under its own region
    (and both inside an outer one): gradients, u/v and running statistics
    equal the plain run's."""
    results = []
    for use in ((False, False), (inner, outer)):
        g = torch.Generator().manual_seed(0)
        m = _Spectral(policy).train()
        TL.init_weights(m, g)
        with torch.no_grad():
            m.conv.weight_orig.normal_(generator=g)
        x = torch.randn(2, 6, 6, 4, generator=g, requires_grad=True)
        y = m(x, *use)
        (y * torch.arange(y.numel()).reshape(y.shape).sin()).sum().backward()
        results.append((y.detach(), x.grad, m.conv.weight_orig.grad,
                        m.conv.weight_u.clone(), m.conv.weight_v.clone(),
                        m.bn.running_mean.clone(), m.bn.running_var.clone(),
                        m.bn.num_batches_tracked.clone()))
    for got, want in zip(*results[::-1]):
        _close(got, want, "region")
    assert int(results[1][-1]) == 2


def test_conv_policies_save_what_they_name():
    """`conv` keeps every conv output, `conv_small` those of at most 64 x
    64 positions, `block` none: the backward re-runs the others."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Convs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.sides = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                self.sides.append(args[0].shape[-1])
            return func(*args, **(kwargs or {}))

    conv = TL.Conv2d(2, 2, 3, padding=1)

    def body(a, b):
        # the squares' backward reads the conv outputs
        return (conv(a) ** 2).sum() + (conv(b) ** 2).sum()

    for policy, reruns in (("block", [64, 96]), ("conv_small", [96]),
                           ("conv", [])):
        a = torch.randn(1, 64, 64, 2, requires_grad=True)
        b = torch.randn(1, 96, 96, 2, requires_grad=True)
        loss = remat.checkpoint(body, a, b, policy=policy)
        with Convs() as seen:
            loss.backward()
        assert sorted(seen.sides) == reruns, policy
    with pytest.raises(ValueError, match="remat_policy"):
        remat.checkpoint(body, a, b, policy="all")
