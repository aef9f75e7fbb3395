"""The fused train step: generator forward + its loss terms + Adam update on
netG + netCorr, the EMA shadows, then the discriminator update on the same
fake, detached.

Counterpart of cocosnet_tpu/train/steps.py `make_train_step` (the
reference's per-iteration schedule, train.py:54-58, pix2pix_trainer.py:
52-74). The step runs inside nn.layers.training(), where the convs route
as the JAX package's training trace routes them: library convs by default,
conv3x3_fused forward and backward under COCOSNET_FUSED_CONV_TRAIN=1, the
dW kernel under COCOSNET_PALLAS_DW=1 or =all (nn/layers.conv2d); and with
gen, corr and disc in train mode, so each spectral norm advances
its power iteration on each forward, as torch's pre-hook does: G's and
Corr's once per step, D's twice (in the G step's discriminate and in the D
step). The correlation runs as models/correspondence routes it: on the
shift9 kernels forward and backward at match_kernel 3; at match_kernel 1
as matmul + softmax under autograd, or on attend_corr's kernels under
COCOSNET_PALLAS_MK1_TRAIN=1. The step updates the networks' parameters,
the optimizer state, the spectral u/v and the EMA shadows in place.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from cocosnet_tpu_torch import pix2pix as P
from cocosnet_tpu_torch.nn import layers as L
from cocosnet_tpu_torch.train import state as S


def _apply_grads(optimizer: torch.optim.Optimizer, params: Sequence,
                 loss: torch.Tensor, lr: float) -> None:
    """One Adam step of `params` on d(loss)/d(params); a parameter the loss
    does not reach takes a zero gradient, as in optax."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_train_step(nets: P.Pix2PixNets):
    """step(state, batch, lr) -> (losses, visuals). batch: the loader's
    dict (label, image, ref, label_ref, self_ref); lr: (lr_G, lr_D) from
    S.lrs_for_epoch. The losses are 0-d f32 tensors on the nets' device
    (reading them synchronises)."""
    opt = nets.opt

    def train_step(state: S.TrainState, batch, lr
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        lr_g, lr_d = (float(x) for x in lr)
        data = P.preprocess_input(opt, batch, device=nets.device)
        nets.set_train(True)
        try:
            with L.training():
                # ---------------- generator step ------------------------
                out = P.generate_fake(nets, data, train=True)
                with torch.no_grad():
                    out["ref_features"] = P.vgg_features(nets,
                                                         data["ref_image"])
                    out["real_features"] = P.vgg_features(nets,
                                                          data["real_image"])
                g_losses = P.compute_generator_losses(nets, data, out)
                g_params = list(state.g_params.values())
                _apply_grads(state.opt_g, g_params, sum(g_losses.values()),
                             lr_g)
                if state.ema is not None:
                    S.ema_update(state.ema, state.g_params, opt.ema_beta)

                # ---------------- discriminator step --------------------
                d_losses = P.compute_discriminator_losses(
                    nets, data, out["fake_image"])
                _apply_grads(state.opt_d, S.d_parameters(nets),
                             sum(d_losses.values()), lr_d)
        finally:
            nets.set_train(False)
        state.step += 1
        losses = {k: v.detach() for k, v in {**g_losses, **d_losses}.items()}
        visuals = {k: out[k].detach() for k in ("fake_image", "warp_out",
                                                "warp_mask") if k in out}
        return losses, visuals

    return train_step
