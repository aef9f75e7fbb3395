"""Training state: the Adam optimizers of the two sides, the EMA shadows of
the generator side's parameters and the step counter, beside the networks
that hold the parameters.

Counterpart of cocosnet_tpu/train/state.py (pix2pix_model.py:88-107,
pix2pix_trainer.py:105-125):
- TTUR (the default): betas (0, 0.9); G and Corr at lr * 0.5, D at lr * 2.
  Adam eps 1e-3 for G and Corr, 1e-8 for D. torch.optim.Adam places eps as
  optax.adam does: lr * m_hat / (sqrt(v_hat) + eps).
- no_TTUR: betas (beta1, beta2), both sides at the rates lrs_for_epoch
  gives.
- linear decay after epoch niter (lr_for_epoch / lrs_for_epoch); the train
  step sets each optimizer's rate from the lr it is handed.
- EMA (generator.py:259-287): shadow = beta * shadow + (1 - beta) * p over
  the G and Corr parameters, after each G update.
- The domain classifier's parameters (--weight_domainC with --domain_rela)
  sit beside D's in the D optimizer (state.py:101-102); no loss reaches
  them, so Adam leaves them where they are.
- The noise stream of --mask_noise / --noise_for_mask: an explicit
  torch.Generator on the nets' device, seeded from --seed (the JAX
  TrainState's noise_rng, state.py:38, :107-118; the port's bits are its
  own).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from cocosnet_tpu_torch.config import Options


def lr_for_epoch(opt: Options, epoch: int) -> float:
    """Base learning rate while training epoch `epoch`: the reference
    updates it at the end of each epoch (train.py:109) and it moves once
    the epoch passes niter, so epoch e trains at
    lr - max(0, e - 1 - niter) * lr / niter_decay."""
    decay_steps = max(0, epoch - 1 - opt.niter)
    decayed = opt.lr - decay_steps * opt.lr / max(opt.niter_decay, 1)
    return max(decayed, 0.0)


def lrs_for_epoch(opt: Options, epoch: int) -> np.ndarray:
    """Effective (G, D) learning rates for `epoch`: the G optimizer's
    parameter groups carry lr * 0.5 (pix2pix_model.py:90-91), which holds
    under TTUR and no_TTUR until the first decay update; after it, TTUR
    splits new_lr / 2 and new_lr * 2, no_TTUR gives both new_lr."""
    base = lr_for_epoch(opt, epoch)
    if opt.no_TTUR:
        decay_started = epoch - 1 > opt.niter
        g = base if decay_started else opt.lr * 0.5
        d = base
    else:
        g, d = base * 0.5, base * 2.0
    return np.asarray([g, d], np.float32)


def g_named_parameters(nets) -> Dict[str, torch.nn.Parameter]:
    """The generator side's trainable parameters, netG + netCorr
    (pix2pix_model.py:90-91), by "gen." / "corr." name."""
    out = {f"gen.{k}": p for k, p in nets.gen.named_parameters()}
    out.update({f"corr.{k}": p for k, p in nets.corr.named_parameters()})
    return out


def d_parameters(nets) -> List[torch.nn.Parameter]:
    params = list(nets.disc.parameters())
    if nets.domain_classifier is not None:
        params += list(nets.domain_classifier.parameters())
    return params


class TrainState:
    """The optimizers, the EMA shadows (None without --use_ema), the step
    counter and the noise generator of one training run of `nets`."""

    def __init__(self, opt: Options, nets):
        b1, b2 = (opt.beta1, opt.beta2) if opt.no_TTUR else (0.0, 0.9)
        lr_g, lr_d = (float(x) for x in lrs_for_epoch(opt, 1))
        self.g_params = g_named_parameters(nets)
        self.opt_g = torch.optim.Adam(list(self.g_params.values()), lr=lr_g,
                                      betas=(b1, b2), eps=1e-3)
        self.opt_d = torch.optim.Adam(d_parameters(nets), lr=lr_d,
                                      betas=(b1, b2), eps=1e-8)
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if opt.use_ema:
            self.ema = {k: p.detach().clone()
                        for k, p in self.g_params.items()}
        self.step = 0
        self.noise = torch.Generator(nets.device).manual_seed(opt.seed)


def create_train_state(opt: Options, nets) -> TrainState:
    return TrainState(opt, nets)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], beta: float) -> None:
    """shadow = beta * shadow + (1 - beta) * p, in place."""
    for k, s in ema.items():
        s.mul_(beta).add_(params[k].detach(), alpha=1.0 - beta)


def ema_state_dicts(state: TrainState, nets) -> Dict[str, Dict]:
    """State dicts of gen and corr with the EMA shadows in place of their
    parameters (generator.py:276-281), for evaluation."""
    out = {}
    for name in ("gen", "corr"):
        sd = dict(getattr(nets, name).state_dict())
        if state.ema is not None:
            for k, v in state.ema.items():
                if k.startswith(name + "."):
                    sd[k[len(name) + 1:]] = v.clone()
        out[name] = sd
    return out
