"""The plain reference of CoCosNet's networks (CVPR 2020), in float32 NCHW
PyTorch with every convolution on F.conv2d and every product on
torch.matmul: no kernel, no cache, no batching tricks.

It follows the published networks as the port under test implements
them (its parameter and buffer names are the reference code's, so the
benchmark loads one set of weights into both):
- CorrespondenceNet: two domain adaptors (five spectral-instance-normed
  convs, then three SPADE residual blocks conditioned on the adaptor's own
  input), the channel L2 norm, with --maskmix the label map appended, four
  residual blocks (reflect-padded convs, instance norm, one shared PReLU),
  theta / phi 1x1 convs, then the 3x3-unfold correlation: descriptors
  centred (over the descriptor with --PONO_C, over positions without) and
  L2-normalized, softmax over the exemplar's positions at temperature
  0.01, and the warp of the exemplar's avg-pooled colours (or its 4x4
  patches with --warp_patch) and, with the direct mask loss, its label
  map.
- SPADEGenerator: a 3x3 conv on the conditioning map at 1/32, seven SPADE
  residual blocks with x2 nearest upsampling, self-attention at 4 ngf,
  a tanh head. SPADE: a parameter-free norm (positional norm with --PONO),
  then gamma and beta from a 128-channel reflect-padded conv MLP.
- MultiscaleDiscriminator (two PatchGAN scales of four 4x4 convs, the
  inner ones spectral-instance-normed, attention before the last) and the
  frozen VGG19 of the perceptual and contextual losses.
Spectral norm follows torch.nn.utils.spectral_norm: in train mode one
power iteration per forward, stored; in eval mode sigma from the stored
vectors.

`rounding(fn)` makes every convolution round its input, its weight and its
output by `fn`: the control of the comparison computes the same networks
with every convolution in a lower precision, where the configurations'
bf16 policy keeps a convolution's operands and output in bf16
(compare.fp8_round).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = sys.float_info.epsilon
TEMPERATURE = 0.01
NHIDDEN = 128

_ROUND: Optional[Callable] = None


@contextlib.contextmanager
def rounding(fn: Optional[Callable]):
    """Every convolution inside rounds its operands and output with fn."""
    global _ROUND
    prev, _ROUND = _ROUND, fn
    try:
        yield
    finally:
        _ROUND = prev


def _rnd(x: torch.Tensor) -> torch.Tensor:
    return x if _ROUND is None else _ROUND(x)


def l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (v.norm() + 1e-12)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class Conv(nn.Module):
    """A conv with zero padding `pad` or a reflect ring of (k - 1) / 2, an
    optional bias, and optional spectral norm (weight_orig, weight_u,
    weight_v)."""

    def __init__(self, cin, cout, k, *, stride=1, pad=0, bias=True,
                 sn=False, reflect=False):
        super().__init__()
        self.stride, self.pad, self.reflect, self.sn = stride, pad, reflect, sn
        w = nn.Parameter(torch.empty(cout, cin, k, k))
        if sn:
            self.weight_orig = w
            self.register_buffer("weight_u", torch.empty(cout))
            self.register_buffer("weight_v", torch.empty(cin * k * k))
        else:
            self.weight = w
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def effective_weight(self) -> torch.Tensor:
        if not self.sn:
            return self.weight
        w = self.weight_orig
        wm = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if self.training:
            # the new vectors, stored; sigma reads these tensors, not the
            # buffers a later forward overwrites
            with torch.no_grad():
                v = l2n(wm.t() @ u)
                u = l2n(wm @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return w / torch.dot(u, wm @ v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight()
        if self.reflect:
            p = (w.shape[-1] - 1) // 2
            x = F.pad(x, (p, p, p, p), mode="reflect")
        return _rnd(F.conv2d(_rnd(x), _rnd(w), self.bias, self.stride,
                             self.pad))


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def positional_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=True, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


def nearest_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') to (h, w) at an integer factor."""
    if x.shape[2:] == (h, w):
        return x
    return x[:, :, :: x.shape[2] // h, :: x.shape[3] // w]


class NormConv(nn.Module):
    """A spectral conv without bias followed by instance norm (the
    'spectralinstance' norm of the adaptors and the discriminator); the
    conv is child "0"."""

    def __init__(self, cin, cout, k, stride, pad=1):
        super().__init__()
        self.add_module("0", Conv(cin, cout, k, stride=stride, pad=pad,
                                  bias=False, sn=True))

    def forward(self, x):
        return instance_norm(self._modules["0"](x))


class SPADE(nn.Module):
    def __init__(self, norm_nc, label_nc, pono):
        super().__init__()
        self.pono = pono
        self.mlp_shared = nn.Sequential(
            nn.Identity(), Conv(label_nc, NHIDDEN, 3, reflect=True), nn.ReLU())
        self.mlp_gamma = Conv(NHIDDEN, norm_nc, 3, reflect=True)
        self.mlp_beta = Conv(NHIDDEN, norm_nc, 3, reflect=True)

    def forward(self, x, seg):
        normalized = positional_norm(x) if self.pono else instance_norm(x)
        actv = self.mlp_shared(nearest_to(seg, x.shape[2], x.shape[3]))
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADEResBlock(nn.Module):
    def __init__(self, fin, fout, label_nc, pono):
        super().__init__()
        fmid = min(fin, fout)
        self.shortcut = fin != fout
        if self.shortcut:
            self.norm_s = SPADE(fin, label_nc, pono)
            self.conv_s = Conv(fin, fout, 1, bias=False, sn=True)
        self.norm_0 = SPADE(fin, label_nc, pono)
        self.conv_0 = Conv(fin, fmid, 3, sn=True, reflect=True)
        self.norm_1 = SPADE(fmid, label_nc, pono)
        self.conv_1 = Conv(fmid, fout, 3, sn=True, reflect=True)

    def forward(self, x, seg):
        seg = nearest_to(seg, x.shape[2], x.shape[3])
        x_s = self.conv_s(self.norm_s(x, seg)) if self.shortcut else x
        dx = self.conv_0(leaky(self.norm_0(x, seg)))
        dx = self.conv_1(leaky(self.norm_1(dx, seg)))
        return x_s + dx


class Attention(nn.Module):
    """SAGAN self-attention with spectral 1x1 convs and a gate gamma."""

    def __init__(self, ch):
        super().__init__()
        self.theta = Conv(ch, ch // 8, 1, bias=False, sn=True)
        self.phi = Conv(ch, ch // 8, 1, bias=False, sn=True)
        self.g = Conv(ch, ch // 2, 1, bias=False, sn=True)
        self.o = Conv(ch // 2, ch, 1, bias=False, sn=True)
        self.gamma = nn.Parameter(torch.empty(1))

    def forward(self, x):
        b, c, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)
        phi = F.max_pool2d(self.phi(x), 2).flatten(2)
        g = F.max_pool2d(self.g(x), 2).flatten(2).transpose(1, 2)
        beta = torch.softmax(torch.matmul(theta, phi), dim=-1)
        o = torch.matmul(beta, g).transpose(1, 2).reshape(b, c // 2, h, w)
        return self.gamma * self.o(o) + x


class Adaptor(nn.Module):
    """The domain adaptor: the map (or image) to 4 ngf channels at 1/4."""

    def __init__(self, cfg, ic):
        super().__init__()
        nf, ak = cfg["ngf"], cfg["adaptor_kernel"]
        self.layer1 = NormConv(ic, nf, 3, 1)
        self.layer2 = NormConv(nf, 2 * nf, ak, 2)
        self.layer3 = NormConv(2 * nf, 4 * nf, 3, 1)
        self.layer4 = NormConv(4 * nf, 8 * nf, ak, 2)
        self.layer5 = NormConv(8 * nf, 8 * nf, 3, 1)
        pono = cfg["PONO"]
        self.head_0 = SPADEResBlock(8 * nf, 8 * nf, ic, pono)
        self.G_middle_0 = SPADEResBlock(8 * nf, 8 * nf, ic, pono)
        self.G_middle_1 = SPADEResBlock(8 * nf, 4 * nf, ic, pono)

    def forward(self, x, seg):
        h = self.layer1(x)
        for name in ("layer2", "layer3", "layer4", "layer5"):
            h = getattr(self, name)(leaky(h))
        h = self.head_0(h, seg)
        h = self.G_middle_0(h, seg)
        return self.G_middle_1(h, seg)


class ResidualBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3, reflect=True)
        self.conv2 = Conv(ch, ch, 3, reflect=True)
        self.prelu = nn.PReLU()

    def forward(self, x):
        out = self.prelu(instance_norm(self.conv1(x)))
        return self.prelu(instance_norm(self.conv2(out)) + x)


def channel_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(1, keepdim=True) + 1e-24) + EPS)


def descriptors(y: torch.Tensor, k: int, pono_c: bool) -> torch.Tensor:
    """(B, N, C k k) k x k-unfold descriptors, centred and L2-normalized."""
    d = F.unfold(y, kernel_size=k, padding=k // 2).transpose(1, 2)
    d = d - d.mean(dim=-1 if pono_c else 1, keepdim=True)
    return d / (torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-24) + EPS)


class Correspondence(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        nc = cfg["semantic_nc"]
        self.adaptive_model_seg = Adaptor(cfg, nc)
        self.adaptive_model_img = Adaptor(cfg, 3)
        ch = 4 * cfg["ngf"] + (nc if cfg["maskmix"] else 0)
        self.layer = nn.Sequential(*[ResidualBlock(ch) for _ in range(4)])
        self.theta = Conv(ch, 256, 1)
        self.phi = Conv(ch, 256, 1)

    def forward(self, ref_img, seg_map, ref_seg_map, real_img=None):
        cfg = self.cfg
        out = {}
        b, _, h, w = ref_img.shape
        fh, fw = h // 4, w // 4
        feat_seg = channel_normalize(self.adaptive_model_seg(seg_map, seg_map))
        feat_img = channel_normalize(self.adaptive_model_img(ref_img, ref_img))
        if self.training and real_img is not None:
            pair = channel_normalize(self.adaptive_model_img(real_img,
                                                             real_img))
            out["loss_novgg_featpair"] = ((feat_seg - pair).abs().mean()
                                          * cfg["novgg_featpair"])
        seg_small = nearest_to(seg_map, fh, fw)
        ref_seg_small = nearest_to(ref_seg_map, fh, fw)
        if cfg["maskmix"]:
            cont = self.layer(torch.cat([feat_seg, seg_small], 1))
            ref = self.layer(torch.cat([feat_img, ref_seg_small], 1))
        else:
            cont, ref = self.layer(feat_seg), self.layer(feat_img)
        k, pono_c = cfg["match_kernel"], cfg["PONO_C"]
        q = descriptors(self.theta(cont), k, pono_c)
        key = descriptors(self.phi(ref), k, pono_c)
        if cfg["warp_patch"]:
            values = F.unfold(ref_img, 4, stride=4).transpose(1, 2)
        else:
            values = F.avg_pool2d(ref_img, 4).flatten(2).transpose(1, 2)
        dv = values.shape[-1]
        direct = cfg["warp_mask_losstype"] == "direct"
        if direct:
            values = torch.cat(
                [values, ref_seg_small.flatten(2).transpose(1, 2)], -1)
        prob = torch.softmax(torch.matmul(q, key.transpose(1, 2))
                             / TEMPERATURE, dim=-1)
        warped = torch.matmul(prob, values)
        if cfg["warp_patch"]:
            out["warp_out"] = F.fold(warped[..., :dv].transpose(1, 2),
                                     (h, w), 4, stride=4)
        else:
            y = warped[..., :dv].transpose(1, 2).reshape(b, dv, fh, fw)
            mode = "bilinear" if cfg["warp_bilinear"] else "nearest"
            out["warp_out"] = F.interpolate(
                y, scale_factor=4, mode=mode,
                **({"align_corners": False} if mode == "bilinear" else {}))
        if direct:
            out["warp_mask"] = warped[..., dv:]          # (B, N, nc)
        return out


class Generator(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        nf, pono = cfg["ngf"], cfg["PONO"]
        ic = 3 + cfg["semantic_nc"]          # CBN_intype warp_mask

        def block(fin, fout):
            return SPADEResBlock(fin, fout, ic, pono)

        self.fc = Conv(ic, 16 * nf, 3, pad=1)
        self.head_0 = block(16 * nf, 16 * nf)
        self.G_middle_0 = block(16 * nf, 16 * nf)
        self.G_middle_1 = block(16 * nf, 16 * nf)
        self.up_0 = block(16 * nf, 8 * nf)
        self.up_1 = block(8 * nf, 4 * nf)
        self.attn = Attention(4 * nf)
        self.up_2 = block(4 * nf, 2 * nf)
        self.up_3 = block(2 * nf, nf)
        self.conv_img = Conv(nf, 3, 3, pad=1)

    def forward(self, seg):
        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        s = seg.shape[2] // 32
        x = self.fc(nearest_to(seg, s, s))
        x = up(self.head_0(x, seg))
        x = self.G_middle_1(self.G_middle_0(x, seg), seg)
        x = up(x)
        x = up(self.up_0(x, seg))
        x = up(self.up_1(x, seg))
        x = self.up_2(self.attn(x), seg)
        x = self.up_3(up(x), seg)
        return torch.tanh(self.conv_img(leaky(x)))


class PatchD(nn.Module):
    def __init__(self, cfg, input_nc):
        super().__init__()
        nf = cfg["ndf"]
        self.n = cfg["n_layers_D"]
        self.model0 = nn.Sequential(Conv(input_nc, nf, 4, stride=2, pad=1),
                                    nn.LeakyReLU(0.2))
        for n in range(1, self.n):
            prev, nf = nf, min(nf * 2, 512)
            if n == self.n - 1:
                self.attn = Attention(prev)
            self.add_module(f"model{n}", nn.Sequential(
                NormConv(prev, nf, 4, 1 if n == self.n - 1 else 2),
                nn.LeakyReLU(0.2)))
        self.add_module(f"model{self.n}", nn.Sequential(
            Conv(nf, 1, 4, pad=1)))

    def forward(self, x) -> List[torch.Tensor]:
        res = [self.model0(x)]
        for n in range(1, self.n):
            h = res[-1]
            if n == self.n - 1:
                h = self.attn(h)
            res.append(self._modules[f"model{n}"](h))
        res.append(self._modules[f"model{self.n}"](res[-1]))
        return res


class MultiscaleD(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        for i in range(cfg["num_D"]):
            self.add_module(f"discriminator_{i}",
                            PatchD(cfg, cfg["semantic_nc"] + 3))

    def forward(self, x):
        out = []
        for d in self.children():
            out.append(d(x))
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return out


VGG_LAYERS = [("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128),
              ("conv2_2", 128), ("conv3_1", 256), ("conv3_2", 256),
              ("conv3_3", 256), ("conv3_4", 256), ("conv4_1", 512),
              ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
              ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
              ("conv5_4", 512)]
VGG_TAPS = ("r12", "r22", "r32", "r42", "r52")
VGG_MEAN_BGR = (0.40760392, 0.45795686, 0.48501961)


class VGG19(nn.Module):
    """The frozen VGG19 with caffe preprocessing (BGR, mean, x255; from
    [-1, 1] to [0, 1] first with --vgg_normal_correct)."""

    def __init__(self, normal_correct: bool):
        super().__init__()
        self.normal_correct = normal_correct
        cin = 3
        for name, width in VGG_LAYERS:
            self.add_module(name, Conv(cin, width, 3, pad=1))
            cin = width
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, x) -> List[torch.Tensor]:
        if self.normal_correct:
            x = (x + 1.0) / 2.0
        mean = torch.tensor(VGG_MEAN_BGR, device=x.device)[None, :, None, None]
        h = (x.flip(1) - mean) * 255.0
        taps: Dict[str, torch.Tensor] = {}
        for name, _ in VGG_LAYERS:
            block, idx = name[4], name[6]
            h = torch.relu(self._modules[name](h))
            taps[f"r{block}{idx}"] = h
            if idx == ("2" if block in "12" else "4"):
                h = F.max_pool2d(h, 2)
        return [taps[k] for k in VGG_TAPS]


class Nets(nn.Module):
    """corr and gen, and for training disc and vgg, under the names the
    port's Pix2PixNets gives them."""

    def __init__(self, cfg, train: bool):
        super().__init__()
        self.cfg = cfg
        self.corr = Correspondence(cfg)
        self.gen = Generator(cfg)
        if train:
            self.disc = MultiscaleD(cfg)
            self.vgg = VGG19(cfg["vgg_normal_correct"])
        self.eval()


def semantics(cfg, label: torch.Tensor) -> torch.Tensor:
    """(B, H, W, Cl) loader labels -> the NCHW semantic map: the one-hot
    of the class ids, or the dense channels as they are."""
    if cfg["label_mode"] == "ids":
        classes = torch.arange(cfg["semantic_nc"], device=label.device)
        return (label[..., 0:1].long() == classes).float().permute(0, 3, 1, 2)
    return label.float().permute(0, 3, 1, 2)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def inference(nets: Nets, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """fake_image (B, H, W, 3) f32 in [-1, 1] for a loader batch (NHWC)."""
    cfg = nets.cfg
    sem = semantics(cfg, batch["label"])
    out = nets.corr(nchw(batch["ref"]), sem,
                    semantics(cfg, batch["label_ref"]))
    fake = nets.gen(torch.cat([out["warp_out"], sem], 1))
    return fake.permute(0, 2, 3, 1)


def quantize(y: torch.Tensor) -> torch.Tensor:
    """The served uint8 levels of an image in [-1, 1], rounding half up."""
    return torch.clamp(torch.floor((y + 1.0) * 127.5 + 0.5), 0, 255).to(
        torch.uint8)
