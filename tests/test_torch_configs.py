"""The three other published inference configurations of the port against
the JAX package on the CPU at f32, at 64 px, ngf 8 and batch 2 (the size of
tests/test_torch_model.py), with the weights carried across by
cocosnet_tpu_torch.convert:

- celebahq: the glasses channel interleaved with the class ids and put at
  one-hot slot -3, maskmix (a 256 + 19 channel residual stack), the direct
  mask, --warp_bilinear, --adaptor_kernel 4;
- celebahqedge: the 15 dense edge and distance-transform channels;
- deepfashion: the 20 dense pose channels, --warp_patch (the exemplar's
  4 x 4 patches as the warp's values), --warp_bilinear, --video_like.

preprocess_input -> inference of both packages on the same numpy batch:
fake_image, warp_out, warp_mask (celebahq) and both adaptive features at
atol 5e-4, as tests/test_torch_model.py holds the flagship slice. Also the
new image ops against JAX's at 1e-6, the seg_label gate by dataset mode,
the conv gates against JAX's on every 3x3 conv of each configuration at
full width (256 px, ngf 64), the plain counters of one forward, the
weights' names at adaptor_kernel 4, and what check_ported accepts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.ops import image as JI
from cocosnet_tpu.ops import pallas_conv as PC
from cocosnet_tpu.train.checkpoints import (convert_torch_module,
                                            default_name_map)
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.convert import load_flax_variables
from cocosnet_tpu_torch.models import correspondence as TCR
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.ops import conv3x3 as C
from cocosnet_tpu_torch.ops import image as TI
from cocosnet_tpu_torch.ops import shift9 as S
from cocosnet_tpu_torch.tools.ab_dw import record_convs
from test_torch_conv_train import _vmem_feasible
from test_torch_model import _condition, _jnp, _structure
from test_torch_threads import torch_threads  # noqa: F401
from torch_fixtures import jit_quick

SMALL = dict(crop_size=64, load_size=64, batchSize=2, ngf=8, isTrain=False)
# the flags of each configuration beyond its dataset defaults
# (BASELINE.json, with the flagship's --use_attention --PONO --PONO_C)
CONFIGS = {
    "celebahq": dict(dataset_mode="celebahq", label_nc=19,
                     contain_dontcare_label=False, use_attention=True,
                     maskmix=True, warp_mask_losstype="direct", PONO=True,
                     PONO_C=True, warp_bilinear=True, adaptor_kernel=4),
    "celebahqedge": dict(dataset_mode="celebahqedge", label_nc=15,
                         contain_dontcare_label=False, use_attention=True,
                         PONO=True, PONO_C=True, adaptor_kernel=4),
    "deepfashion": dict(dataset_mode="deepfashion", label_nc=20,
                        contain_dontcare_label=False, use_attention=True,
                        PONO=True, PONO_C=True, warp_bilinear=True,
                        no_flip=True, warp_patch=True, video_like=True,
                        adaptor_kernel=4),
}
# the training flags of each configuration beyond its inference ones
# (tests/test_train_variants.py, from the reference README's training
# command lines); celebahqedge's are an assumption, recorded in PERF.md: no
# test or command line in the repository holds them
TRAIN_FLAGS = {
    "celebahq": dict(weight_mask=100.0, warp_cycle_w=0.1,
                     which_perceptual="4_2", weight_perceptual=0.001,
                     fm_ratio=1.0),
    "celebahqedge": dict(warp_bilinear=True, warp_cycle_w=0.1,
                         which_perceptual="4_2", weight_perceptual=0.001,
                         fm_ratio=1.0),
    "deepfashion": dict(warp_self_w=100.0, real_reference_probability=0.0,
                        which_perceptual="4_2"),
}
MODES = list(CONFIGS)
COUNTED = (C.conv3x3_fused, C.conv3x3_fused_stats, C.conv3x3_onehot,
           S.attend_shift9)


def batch_for(mode, semantic_nc, b, h, w, seed=0):
    """A loader batch of `mode`: celebahq's class ids interleaved with a
    0/1 glasses mask, or the dense [0, 1] channels of the edge and pose
    labels."""
    rs = np.random.RandomState(seed)

    def label():
        if mode == "celebahq":
            return np.concatenate(
                [rs.randint(0, semantic_nc, (b, h, w, 1)),
                 rs.rand(b, h, w, 1) < 0.3], -1).astype(np.float32)
        return rs.rand(b, h, w, semantic_nc).astype(np.float32)

    return {"label": label(),
            "image": rs.rand(b, h, w, 3).astype(np.float32) * 2 - 1,
            "ref": rs.rand(b, h, w, 3).astype(np.float32) * 2 - 1,
            "label_ref": label(),
            "self_ref": np.ones((b,), np.float32)}


_VARIABLES = {}


def _variables(jnets, jopt, b, h, w):
    """The conditioned variables of jopt's JAX nets at (b, h, w): a function
    of its arguments, kept for the module's later callers (the slices
    fixture's celebahq variables serve test_adaptor_kernel_4_keeps_the_
    names too)."""
    cache_key = (repr(jopt), b, h, w)
    if cache_key not in _VARIABLES:
        _VARIABLES[cache_key] = _draw_variables(jnets, jopt, b, h, w)
    return _VARIABLES[cache_key]


def _draw_variables(jnets, jopt, b, h, w):
    key = jax.random.PRNGKey(0)
    sem = jnp.zeros((b, h, w, jopt.semantic_nc))
    img = jnp.zeros((b, h, w, 3))
    cbn = jnp.zeros((b, h, w, 3 + jopt.semantic_nc))
    return {
        "gen": _condition(_structure(
            lambda: jnets.gen.init(key, sem, cbn, train=False)), 0),
        "corr": _condition(_structure(
            lambda: jnets.corr.init(key, img, None, sem, sem, train=False)),
            1)}


@pytest.fixture(scope="module")
def slices():
    """{mode: (JAX outputs, port outputs, the port's plain calls)}."""
    out = {}
    b, h, w = 2, 64, 64
    for mode, kw in CONFIGS.items():
        kw = dict(SMALL, **kw)
        jopt, topt = JCFG.test_defaults(**kw), TCFG.test_defaults(**kw)
        batch = batch_for(mode, jopt.semantic_nc, b, h, w)
        jnets = JP.Pix2PixNets(jopt)
        variables = _variables(jnets, jopt, b, h, w)
        args = (_jnp(variables), _jnp(batch))
        jout = jit_quick(lambda v, d: JP.inference(
            jnets, v, JP.preprocess_input(jopt, d)), *args)(*args)
        tnets = TP.Pix2PixNets(topt, device="cpu")
        load_flax_variables(tnets.gen, variables["gen"])
        load_flax_variables(tnets.corr, variables["corr"])
        before = [f.plain_calls for f in COUNTED]
        tout = TP.inference(tnets, TP.preprocess_input(topt, batch,
                                                       device="cpu"))
        calls = {f.__name__: f.plain_calls - n
                 for f, n in zip(COUNTED, before)}
        out[mode] = ({k: np.asarray(v) for k, v in jout.items()},
                     {k: v.numpy() for k, v in tout.items()}, calls)
    return out


@pytest.mark.parametrize("key", ["fake_image", "warp_out", "warp_mask",
                                 "adaptive_feature_seg",
                                 "adaptive_feature_img"])
@pytest.mark.parametrize("mode", MODES)
def test_slice_matches_jax(slices, mode, key):
    want, got, _ = slices[mode]
    if key == "warp_mask" and mode != "celebahq":
        # the direct mask is celebahq's only (its warp_mask_losstype)
        assert key not in want and key not in got
        return
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], atol=5e-4)


def test_slice_shapes(slices):
    """The warp's values: 3 colours + 19 mask columns (celebahq), 3
    colours (celebahqedge), 3 x 4 x 4 patch values (deepfashion)."""
    assert slices["celebahq"][1]["warp_mask"].shape == (2, 16, 16, 19)
    for mode in MODES:
        assert slices[mode][1]["warp_out"].shape == (2, 64, 64, 3)
        assert slices[mode][1]["fake_image"].shape == (2, 64, 64, 3)


@pytest.mark.parametrize("mode", MODES)
def test_slice_plain_counters(slices, mode):
    """One forward: the shift9 core once, the one-hot conv never (these
    modes give the correspondence net no integer labels), the dense conv
    kernels never at 64 px, ngf 8 (their gates want 64 channels)."""
    assert slices[mode][2] == {"conv3x3_fused": 0, "conv3x3_fused_stats": 0,
                               "conv3x3_onehot": 0, "attend_shift9": 1}


@pytest.mark.parametrize("mode", ["ade20k", "flickr"] + MODES)
def test_seg_label_goes_only_to_the_mask_modes(mode, monkeypatch):
    """generate_fake hands the correspondence net the integer labels on
    ade20k and flickr only (cocosnet_tpu/pix2pix.py:187-196): elsewhere the
    glasses, edge or pose channels are part of the semantics."""
    kw = dict(SMALL, **CONFIGS.get(mode, dict(
        dataset_mode=mode, label_nc=12, contain_dontcare_label=True,
        use_attention=True, PONO=True, PONO_C=True)))
    opt = TCFG.test_defaults(**kw)
    nets = TP.Pix2PixNets(opt, device="cpu")
    seen = []
    forward = nets.corr.forward

    def spy(*args, **kwargs):
        seen.append(sorted(kwargs))
        return forward(*args, **kwargs)

    monkeypatch.setattr(nets.corr, "forward", spy)
    if mode in CONFIGS:
        batch = batch_for(mode, opt.semantic_nc, 2, 64, 64)
    else:
        batch = batch_for("celebahq", opt.semantic_nc, 2, 64, 64)
        batch = {k: v[..., :1] if k.startswith("label") else v
                 for k, v in batch.items()}
    TP.inference(nets, TP.preprocess_input(opt, batch, device="cpu"))
    assert seen == [["seg_label"] if mode in ("ade20k", "flickr") else []]


def test_celebahq_glasses_go_to_slot_minus_3():
    opt = TCFG.test_defaults(**dict(SMALL, **CONFIGS["celebahq"]))
    batch = batch_for("celebahq", opt.semantic_nc, 2, 8, 8)
    data = TP.preprocess_input(opt, batch, device="cpu")
    want = JP.preprocess_input(JCFG.test_defaults(**dict(
        SMALL, **CONFIGS["celebahq"])), _jnp(batch))
    for k in ("input_semantics", "ref_semantics", "input_label",
              "ref_label"):
        assert np.array_equal(data[k].numpy(), np.asarray(want[k])), k
    glasses = batch["label"][..., 1]
    assert np.array_equal(data["input_semantics"][..., -3].numpy(), glasses)


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_bilinear_matches_jax(scale):
    x = np.random.RandomState(scale).randn(2, 5, 7, 3).astype(np.float32)
    got = TI.upsample_bilinear(torch.from_numpy(x), scale).numpy()
    want = np.asarray(JI.upsample_bilinear(jnp.asarray(x), scale))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # nn.Upsample's bilinear, align_corners=False, on the NCHW tensor
    ref = torch.nn.Upsample(scale_factor=scale, mode="bilinear")(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("d", [2, 4])
def test_patches_match_jax(d):
    x = np.random.RandomState(d).randn(2, 8, 12, 3).astype(np.float32)
    p = TI.space_to_patches(torch.from_numpy(x), d)
    np.testing.assert_allclose(
        p.numpy(), np.asarray(JI.space_to_patches(jnp.asarray(x), d)),
        atol=1e-6)
    # F.unfold's channel-major order c*d*d + kh*d + kw
    cols = torch.nn.functional.unfold(torch.from_numpy(x).permute(0, 3, 1, 2),
                                      d, stride=d).transpose(1, 2)
    assert torch.equal(p, cols)
    back = TI.patches_to_space(p * 2, d, 8, 12)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(JI.patches_to_space(
            jnp.asarray(p.numpy() * 2), d, 8, 12)), atol=1e-6)
    assert torch.equal(TI.patches_to_space(p, d, 8, 12),
                       torch.from_numpy(x))


def _stub_conv(x, kernel, bias=None, *, stride=1, padding=0, reflect=False,
               want_stats=False):
    """conv2d's output shape (zeros), for recording a forward's convs
    without computing them."""
    b, h, w, _ = x.shape
    k = kernel.shape[0]
    if reflect:
        h, w = h + k - 1, w + k - 1
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    y = torch.zeros(b, ho, wo, kernel.shape[3])
    if want_stats:
        z = torch.zeros(b, 1, 1, kernel.shape[3])
        return y, z, z + 1
    return y


def full_width_convs(mode, monkeypatch):
    """The conv records of one forward of `mode` at full width (256 px,
    ngf 64, batch 1), recorded with the convs and the correlation
    stubbed."""
    opt = TCFG.test_defaults(**dict(CONFIGS[mode], crop_size=256,
                                    load_size=256, batchSize=1, ngf=64,
                                    isTrain=False))
    nets = TP.Pix2PixNets(opt, device="cpu")
    monkeypatch.setattr(TL, "conv2d", _stub_conv)
    monkeypatch.setattr(TCR, "attend_shift9", lambda f, g, v, *a: torch.zeros(
        v.shape))
    data = TP.preprocess_input(opt, batch_for(mode, opt.semantic_nc, 1, 256,
                                              256), device="cpu")
    with torch.no_grad():
        return record_convs(lambda: TP.inference(nets, data))


@pytest.mark.parametrize("mode", MODES)
def test_conv_gates_agree_with_jax(mode, monkeypatch):
    """conv3x3_supported and conv3x3_stats_supported of the port against
    the JAX package's (its TPU check patched to True) on every 3x3 conv of
    one full-width forward of the configuration; the seg adaptor's first
    conv reads the dense label channels (no one-hot input), and celebahq's
    275-channel residual stack takes the statistics kernel."""
    records = full_width_convs(mode, monkeypatch)
    monkeypatch.setattr(PC, "_is_tpu", lambda: True)
    nc = CONFIGS[mode]["label_nc"]
    assert not any(r["onehot"] for r in records)
    assert any(r["x_shape"][3] == nc for r in records)
    compared = 0
    routed = set()
    for r in records:
        xs, ks = r["x_shape"], r["kernel_shape"]
        if tuple(ks[:2]) != (3, 3):
            continue
        _, h, w, c = xs
        co = ks[3]
        kw = dict(stride=r["stride"],
                  padding=1 if r["reflect"] else r["padding"])
        got = (TL.conv3x3_supported(xs, ks, **kw),
               TL.conv3x3_stats_supported(xs, ks, **kw))
        if got[1] and r["want_stats"]:
            routed.add((c, co, "stats"))
        if not _vmem_feasible(h, w, c, co):
            continue
        want = (PC.conv3x3_supported(xs, ks, dilation=1, **kw),
                PC.conv3x3_stats_supported(xs, ks, dilation=1, **kw))
        assert got == want, (xs, ks, kw, got, want)
        compared += 1
    assert compared > 20
    if mode == "celebahq":
        assert (275, 275, "stats") in routed
    # the 4 x 4 stride-2 adaptor convs are library convs
    assert sum(tuple(r["kernel_shape"][:2]) == (4, 4)
               and r["stride"] == 2 for r in records) == 4


def test_adaptor_kernel_4_keeps_the_names():
    """--adaptor_kernel 4 makes the adaptors' stride-2 convs 4 x 4: the
    port's state-dict names are those of the 3 x 3 build, no parameter or
    buffer is added, and the JAX -> port -> JAX round trip gives back
    every leaf."""
    kw = dict(SMALL, **CONFIGS["celebahq"])
    sd4 = TP.Pix2PixNets(TCFG.test_defaults(**kw), device="cpu").corr
    sd3 = TP.Pix2PixNets(TCFG.test_defaults(**dict(kw, adaptor_kernel=3)),
                         device="cpu").corr.state_dict()
    assert list(sd4.state_dict()) == list(sd3)
    changed = [k for k, v in sd4.state_dict().items()
               if v.shape != sd3[k].shape]
    # the kernel and the spectral v (Cin k k entries) of the four convs
    assert sorted(changed) == sorted(
        f"adaptive_model_{a}.{layer}.0.{leaf}" for a in ("seg", "img")
        for layer in ("layer2", "layer4")
        for leaf in ("weight_orig", "weight_v"))
    jopt = JCFG.test_defaults(**kw)
    variables = _variables(JP.Pix2PixNets(jopt), jopt, 2, 64, 64)["corr"]
    load_flax_variables(sd4, variables)
    conv = sd4.adaptive_model_seg.layer2._modules["0"]
    assert tuple(conv.weight_orig.shape[2:]) == (4, 4)
    sd = {k: v.numpy() for k, v in sd4.state_dict().items()}
    back = dict(jax.tree_util.tree_leaves_with_path(
        convert_torch_module(sd, default_name_map)))
    want = jax.tree_util.tree_leaves_with_path(variables)
    assert len(back) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(back[path]), leaf)


@pytest.mark.parametrize("mode", MODES)
def test_check_ported_takes_inference_refuses_training(mode):
    """Each configuration's inference flags and training flags are taken,
    with a model mesh too, and with mask noise and the CAM discriminator
    (once refused, now ported); an even match_kernel is refused."""
    kw = dict(SMALL, **CONFIGS[mode])
    TP.check_ported(TCFG.test_defaults(**kw))
    train = dict(kw, isTrain=True, ndf=8, **TRAIN_FLAGS[mode])
    TP.check_ported(TCFG.test_defaults(**train))
    TP.check_ported(TCFG.test_defaults(**dict(train, mesh_model=2)))
    for flag, value in (("mask_noise", True), ("D_cam", 1.0)):
        TP.check_ported(TCFG.test_defaults(**dict(train, **{flag: value})))
    with pytest.raises(NotImplementedError, match="match_kernel"):
        TP.check_ported(TCFG.test_defaults(**dict(train, match_kernel=4)))


@pytest.mark.parametrize("flags", [
    dict(warp_cycle_w=1.0), dict(warp_cycle_w=1.0, two_cycle=True),
    dict(warp_mask_losstype="cycle", weight_mask=10.0),
    dict(warp_patch=True, warp_cycle_w=0.1), dict(warp_bilinear=True)])
def test_check_ported_takes_the_cycle_warps(flags):
    """ade20k training with the cycle warps, the cycle mask loss and the
    warp flags of the other configurations; an unknown mask loss type is
    refused."""
    kw = dict(SMALL, dataset_mode="ade20k", label_nc=12, maskmix=True,
              isTrain=True, ndf=8, **flags)
    TP.check_ported(TCFG.test_defaults(**kw))
    with pytest.raises(NotImplementedError, match="warp_mask_losstype"):
        TP.check_ported(TCFG.test_defaults(**dict(
            kw, warp_mask_losstype="exact")))
