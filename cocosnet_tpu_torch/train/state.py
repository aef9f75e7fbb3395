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
  step sets each optimizer's rate from the lr it is handed (set_lrs).
- On a CUDA device both optimizers are capturable (their step counts live
  on the device) and each rate is a 0-d device tensor in its parameter
  group, written in place outside any graph, so that a CUDA graph of the
  step (train/steps.make_multi_train_step) holds them; every step of a
  card run, captured or not, uses these optimizers, so a chunk and its
  single steps do the same arithmetic. On the CPU, Adam is torch's default
  with a float rate.
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
        self.opt_g = _adam(list(self.g_params.values()), lr_g, (b1, b2),
                           1e-3, nets.device)
        self.opt_d = _adam(d_parameters(nets), lr_d, (b1, b2), 1e-8,
                           nets.device)
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if opt.use_ema:
            self.ema = {k: p.detach().clone()
                        for k, p in self.g_params.items()}
        self.lrs = (lr_g, lr_d)     # the rates the optimizers hold, or None
        self.step = 0
        self.noise = torch.Generator(nets.device).manual_seed(opt.seed)


def _adam(params, lr: float, betas, eps: float,
          device: torch.device) -> torch.optim.Adam:
    if device.type == "cuda":
        return torch.optim.Adam(params, lr=torch.tensor(lr, device=device),
                                betas=betas, eps=eps, capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)


def create_train_state(opt: Options, nets) -> TrainState:
    return TrainState(opt, nets)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every parameter group of `optimizer` at rate `lr`: the device
    tensor's value in place (outside a graph: a fill inside one would
    record the value), or the float on the CPU."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def set_lrs(state: TrainState, lr) -> None:
    """lr: (lr_G, lr_D), as lrs_for_epoch gives them, written where they
    differ from the rates the optimizers hold: once an epoch."""
    lrs = (float(lr[0]), float(lr[1]))
    if lrs != state.lrs:
        set_lr(state.opt_g, lrs[0])
        set_lr(state.opt_d, lrs[1])
        state.lrs = lrs


def load_optimizer(optimizer: torch.optim.Optimizer, saved: Dict) -> None:
    """optimizer.load_state_dict(saved), keeping this run's own kind of
    Adam: a state saved on the card loads on the CPU and the other way
    round. The group's rate object stays (a device tensor takes the saved
    value in place) and so does its `capturable`; the step counts move to
    the parameters' device where capturable, to the host otherwise."""
    kept = [(g["lr"], g["capturable"]) for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for group, (lr, capturable) in zip(optimizer.param_groups, kept):
        rate = float(group["lr"])
        group["lr"], group["capturable"] = lr, capturable
        if torch.is_tensor(lr):
            lr.fill_(rate)
        else:
            group["lr"] = rate
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    p.device if capturable else "cpu", torch.float32)


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
