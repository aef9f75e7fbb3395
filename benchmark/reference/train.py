"""The plain reference of CoCosNet's training step, in float32 PyTorch: the
generator's terms (the adaptors' feature-pair L1, the hinge GAN loss, the
discriminator feature matching, the VGG feature matching weighted by
self_ref, the relu5_2 perceptual MSE, the contextual loss at relu5_2,
relu4_2 and pooled relu3_2, the warp mask NLL), Adam on netG + netCorr,
the EMA of their parameters, then the discriminator's hinge terms on the
detached fake and Adam on netD, with the two-timescale rates and
betas (0, 0.9) of TTUR.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import model as R

FM_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def contextual_loss(x: torch.Tensor, y: torch.Tensor, h: float = 0.1,
                    pono: bool = True) -> torch.Tensor:
    """Per-sample contextual loss of NCHW features x against targets y."""
    y_mean = (y.mean(dim=1, keepdim=True) if pono
              else y.mean(dim=(2, 3), keepdim=True))
    x, y = x - y_mean, y - y_mean

    def flat(f):
        f = f.flatten(2).transpose(1, 2)
        return f / (torch.sqrt((f * f).sum(-1, keepdim=True) + 1e-24) + R.EPS)

    d = torch.clamp(1.0 - torch.matmul(flat(x), flat(y).transpose(1, 2)),
                    min=0.0)
    d_norm = d / (d.min(dim=-1, keepdim=True).values + 1e-3)
    w = torch.exp((1.0 - d_norm) / h)
    a = w / (w.sum(dim=-1, keepdim=True) + 1e-12)
    cx = a.max(dim=-1).values.mean(dim=1)
    return -torch.log(torch.clamp(cx, min=1e-12))


def discriminate(nets, sem, fake, real):
    outs = nets.disc(torch.cat([torch.cat([sem, fake], 1),
                                torch.cat([sem, real], 1)], 0))
    half = fake.shape[0]
    return ([[t[:half] for t in s] for s in outs],
            [[t[half:] for t in s] for s in outs])


def hinge_g(pred) -> torch.Tensor:
    return sum(-p[-1].mean() for p in pred) / len(pred)


def hinge_d(pred, real: bool) -> torch.Tensor:
    sign = 1.0 if real else -1.0
    return sum(-torch.clamp(sign * p[-1] - 1, max=0.0).mean()
               for p in pred) / len(pred)


def mask_loss(cfg, warp_mask, label, ref_label) -> torch.Tensor:
    """NLL of the warped exemplar labels at the label map's classes, the
    classes absent from the exemplar and class 0 left out."""
    b, n, nc = warp_mask.shape
    side = int(round(n ** 0.5))
    gt = R.nearest_to(label.permute(0, 3, 1, 2)[:, :1], side, side)
    ref = R.nearest_to(ref_label.permute(0, 3, 1, 2)[:, :1], side, side)
    gt = gt.long().reshape(b, n)
    present = torch.zeros(b, nc, device=gt.device)
    present.scatter_(1, ref.long().reshape(b, n), 1.0)
    w = torch.gather(present, 1, gt) * (gt != 0)
    nll = -torch.gather(torch.log(warp_mask + 1e-10), 2, gt[..., None])[..., 0]
    return (nll * w).sum() / (w.sum() + 1e-5) * cfg["weight_mask"]


def generator_losses(nets, batch) -> Tuple[Dict[str, torch.Tensor],
                                           torch.Tensor]:
    cfg = nets.cfg
    sem = R.semantics(cfg, batch["label"])
    ref_sem = R.semantics(cfg, batch["label_ref"])
    real, ref = R.nchw(batch["image"]), R.nchw(batch["ref"])
    out = nets.corr(ref, sem, ref_sem, real_img=real)
    fake = nets.gen(torch.cat([out["warp_out"], sem], 1))
    with torch.no_grad():
        ref_feats = nets.vgg(ref)
        real_feats = nets.vgg(real)
    losses = {"no_vgg_feat": out["loss_novgg_featpair"]}
    self_ref = batch["self_ref"].float()
    weights = (self_ref / (self_ref.sum() + 1e-5))[:, None, None, None]
    pred_fake, pred_real = discriminate(nets, sem, fake, real)
    losses["GAN"] = hinge_g(pred_fake) * cfg["weight_gan"]
    fm_d = sum((f - r.detach()).abs().mean()
               for pf, pr in zip(pred_fake, pred_real)
               for f, r in zip(pf[:-1], pr[:-1]))
    losses["GAN_Feat"] = fm_d / len(pred_fake) * cfg["lambda_feat"]
    fake_feats = nets.vgg(fake)
    fm = sum(w * ((ff - rf).abs() * weights).mean()
             for w, ff, rf in zip(FM_WEIGHTS, fake_feats, real_feats))
    losses["fm"] = fm * cfg["lambda_vgg"] * cfg["fm_ratio"]
    losses["perc"] = (((fake_feats[-1] - real_feats[-1]) ** 2).mean()
                      * cfg["weight_perceptual"])

    def ctx(x, y):
        return contextual_loss(x, y, pono=cfg["PONO"]).mean()

    losses["contextual"] = (
        ctx(fake_feats[-1], ref_feats[-1]) * 8
        + ctx(fake_feats[-2], ref_feats[-2]) * 4
        + ctx(F.avg_pool2d(fake_feats[-3], 2),
              F.avg_pool2d(ref_feats[-3], 2)) * 2
    ) * cfg["lambda_vgg"] * cfg["ctx_w"]
    if cfg["warp_mask_losstype"] == "direct":
        losses["mask"] = mask_loss(cfg, out["warp_mask"], batch["label"],
                                   batch["label_ref"])
    return losses, fake


def discriminator_losses(nets, batch, fake) -> Dict[str, torch.Tensor]:
    cfg = nets.cfg
    sem = R.semantics(cfg, batch["label"])
    pred_fake, pred_real = discriminate(nets, sem, fake.detach(),
                                        R.nchw(batch["image"]))
    return {"D_Fake": hinge_d(pred_fake, False) * cfg["weight_gan"],
            "D_real": hinge_d(pred_real, True) * cfg["weight_gan"]}


def step_work(nets, batch, g_params, d_params, update=None):
    """The step's forward and backward work (corr, gen and disc in train
    mode): the G terms and their gradients, `update("g", grads)`, then the
    D terms on the detached fake and theirs, `update("d", grads)`. Returns
    (losses, G gradients, D gradients)."""
    for m in (nets.corr, nets.gen, nets.disc):
        m.train(True)
    g_losses, fake = generator_losses(nets, batch)
    grads = torch.autograd.grad(sum(g_losses.values()), g_params,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(g_params, grads)]
    if update is not None:
        update("g", grads)
    d_losses = discriminator_losses(nets, batch, fake)
    d_grads = list(torch.autograd.grad(sum(d_losses.values()), d_params))
    if update is not None:
        update("d", d_grads)
    for m in (nets.corr, nets.gen, nets.disc):
        m.train(False)
    return {**g_losses, **d_losses}, grads, d_grads


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas,
                 eps: float):
        self.params, self.lr, self.eps = params, lr, eps
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = (1 - self.b2 ** self.t) ** 0.5
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt() / bc2 + self.eps, value=-self.lr / bc1)


class Trainer:
    """The reference's training run of `nets` (train mode for corr, gen
    and disc): TTUR Adam, the EMA shadows of the generator side."""

    def __init__(self, nets):
        cfg = nets.cfg
        self.nets = nets
        self.g_names = ([f"gen.{k}" for k, _ in nets.gen.named_parameters()]
                        + [f"corr.{k}" for k, _ in
                           nets.corr.named_parameters()])
        self.g_params = (list(nets.gen.parameters())
                         + list(nets.corr.parameters()))
        self.d_names = [f"disc.{k}" for k, _ in nets.disc.named_parameters()]
        self.d_params = list(nets.disc.parameters())
        lr = cfg["lr"]
        self.opt_g = Adam(self.g_params, lr * 0.5, (0.0, 0.9), 1e-3)
        self.opt_d = Adam(self.d_params, lr * 2.0, (0.0, 0.9), 1e-8)
        self.ema = [p.detach().clone() for p in self.g_params]
        self.ema_beta = cfg["ema_beta"]

    def step(self, batch) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        """One train step: (losses, the gradient of each trained leaf by
        name)."""
        losses, g_grads, d_grads = step_work(self.nets, batch, self.g_params,
                                             self.d_params, self._update)
        named = dict(zip(self.g_names, g_grads))
        named.update(zip(self.d_names, d_grads))
        return {k: float(v.detach()) for k, v in losses.items()}, named

    def _update(self, side: str, grads) -> None:
        if side == "g":
            self.opt_g.step(grads)
            with torch.no_grad():
                for s, p in zip(self.ema, self.g_params):
                    s.mul_(self.ema_beta).add_(p, alpha=1 - self.ema_beta)
        else:
            self.opt_d.step(grads)

    def state(self) -> dict:
        """What a run resumes from, copied: {"weights": the nets' state
        dict, "adam": {leaf: (first moment, second moment, steps)},
        "ema": {leaf: shadow}}."""
        adam = {}
        for opt, names in ((self.opt_g, self.g_names),
                           (self.opt_d, self.d_names)):
            for k, m, v in zip(names, opt.m, opt.v):
                adam[k] = (m.clone(), v.clone(), opt.t)
        return {"weights": {k: v.detach().clone()
                            for k, v in self.nets.state_dict().items()},
                "adam": adam,
                "ema": {k: s.clone() for k, s in zip(self.g_names,
                                                     self.ema)}}

    @torch.no_grad()
    def resume(self, state: dict) -> None:
        """Takes up Adam's moments and step counts and the EMA shadows of
        `state` (the weights are the nets' own: load them first)."""
        for opt, names in ((self.opt_g, self.g_names),
                           (self.opt_d, self.d_names)):
            for k, m, v in zip(names, opt.m, opt.v):
                m.copy_(state["adam"][k][0])
                v.copy_(state["adam"][k][1])
                opt.t = int(state["adam"][k][2])
        for k, s in zip(self.g_names, self.ema):
            s.copy_(state["ema"][k])

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every trained leaf and EMA shadow by name."""
        out = dict(zip(self.g_names, self.g_params))
        out.update(zip(self.d_names, self.d_params))
        out.update(("ema." + k, s) for k, s in zip(self.g_names, self.ema))
        return out
