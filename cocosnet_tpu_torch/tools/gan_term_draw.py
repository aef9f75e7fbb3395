"""Phase 3b's GAN-term gradient check on the draw where it missed with no
fault in the port: chip_smoke.py's phases 2 and 3 with phase 2's checks at
the other configurations' warp widths drawing from phase 3b's generator
(the order an earlier version of the script had), then

- on the match_kernel 1 kernel route, dGAN/dfake of the card's fake: in the
  train step's graph, and afresh with cuDNN on, deterministic and off,
  each against D in f64 on the CPU at the same fake; the f64 D with the
  card's LeakyReLU branches; the CPU's f32 D; the LeakyReLU inputs
  nearest 0;
- phase 3b's check (chip_smoke.train_reference_check) on every route, a
  miss printed and not fatal.

Needs the GPU. From the repository root:

    python3 -m cocosnet_tpu_torch.tools.gan_term_draw
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rel(a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm())


def dgan_dfake(P, L, opt, batch, disc_state, fake, device, dtype,
               masks=None):
    """dGAN/dfake of D (from disc_state, in train mode) at `fake`, on
    `device` in `dtype`; with `masks`, each LeakyReLU takes those
    branches. Also the smallest |input| of D's LeakyReLUs."""
    from cocosnet_tpu_torch.losses.gan import gan_loss
    from cocosnet_tpu_torch.models.discriminator import \
        MultiscaleDiscriminator
    disc = MultiscaleDiscriminator(opt)
    disc.load_state_dict(disc_state)
    disc.to(device, dtype).train(True)
    nearest, hooks = [], []
    for name, m in disc.named_modules():
        if not isinstance(m, torch.nn.LeakyReLU):
            continue

        def hook(mod, inp, out, name=name):
            nearest.append(float(inp[0].abs().min()))
            if masks is not None:
                return torch.where(masks[name].to(inp[0].device), inp[0],
                                   mod.negative_slope * inp[0])
            return None
        hooks.append(m.register_forward_hook(hook))
    data = P.preprocess_input(opt, batch, device=device)
    x = fake.detach().to(device, dtype).requires_grad_()
    nets = type("D", (), {"opt": opt, "disc": disc})()
    try:
        with L.training():
            pred_fake, _ = P.discriminate(
                nets, data["input_semantics"].to(dtype), x,
                data["real_image"].to(dtype))
            gan = gan_loss(pred_fake, True, for_discriminator=False,
                           gan_mode=opt.gan_mode) * opt.weight_gan
            u = torch.autograd.grad(gan, x)[0]
    finally:
        for h in hooks:
            h.remove()
    return u, min(nearest)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gan_term_draw runs on a CUDA device; none found")
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from cocosnet_tpu_torch import config as cfg
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn import layers as L
    from cocosnet_tpu_torch.ops import _build
    from cocosnet_tpu_torch.ops import conv3x3 as C
    from cocosnet_tpu_torch.ops import corr as Kc
    from cocosnet_tpu_torch.ops import corr_bigc as KB
    from cocosnet_tpu_torch.ops import correlation as TC
    from cocosnet_tpu_torch.ops import shift9 as S
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    CS.kernel_checks(P, cfg, L, C, S, Kc, KB, TC, g, g)
    for mk in (3, 1):
        CS.reference_check(P, cfg, g, mk)
    refs = {}
    for mk in (3, 1):
        opt = CS.small_train_opt(cfg, match_kernel=mk)
        refs[mk] = CS.cpu_train_reference(
            P, L, TS, ST, g, opt, CS.make_batch(g, 1, 128, 256,
                                               opt.semantic_nc))

    ref = refs[1]
    opt, batch = ref["opt"], ref["batch"]
    disc_state = ref["start"][2]
    with CS.train_route("kernels"):
        gpu = P.Pix2PixNets(opt, device="cuda", seed=1)
        for sd, m in zip(ref["start"], gpu.modules()):
            m.load_state_dict(sd)
        with CS.leaky_masks(gpu.disc) as masks:
            _, kept = CS.term_gradients(P, L, gpu, batch, keep=True)
        u_graph = torch.autograd.grad(kept["gan"], kept["fake"],
                                      retain_graph=True)[0]
        fake = kept["fake"].detach()
        del gpu, kept
    exact, _ = dgan_dfake(P, L, opt, batch, disc_state, fake, "cpu",
                          torch.float64)
    branched, _ = dgan_dfake(P, L, opt, batch, disc_state, fake, "cpu",
                             torch.float64, masks)
    cpu32, nearest = dgan_dfake(P, L, opt, batch, disc_state, fake, "cpu",
                                torch.float32)
    print(f"match_kernel 1 kernel route, dGAN/dfake relative L2 from D in "
          f"f64 on the CPU at the card's fake: the card in the step's graph "
          f"{_rel(u_graph, exact):.3g} (from the f64 D on the card's "
          f"branches {_rel(u_graph, branched):.3g}); the CPU's f32 D "
          f"{_rel(cpu32, exact):.3g}; D's LeakyReLU input nearest 0 "
          f"{nearest:.3g}", flush=True)
    for what, flags in (("cuDNN", {}),
                        ("cuDNN deterministic", {"deterministic": True}),
                        ("cuDNN off", {"enabled": False})):
        with torch.backends.cudnn.flags(**{
                "enabled": True, "benchmark": False, "deterministic": False,
                "allow_tf32": False, **flags}):
            u, _ = dgan_dfake(P, L, opt, batch, disc_state, fake, "cuda",
                              torch.float32)
        print(f"  the card afresh, {what}: {_rel(u, exact):.3g}", flush=True)

    missed = []

    def check(ok, msg):
        print(("ok   " if ok else "MISS ") + msg, flush=True)
        if not ok:
            missed.append(msg)
    CS._check = check
    for mk, route in ((3, "kernels"), (1, "library"), (1, "kernels"),
                      (3, "dw all"), (3, "fused")):
        with CS.train_route(route):
            CS.train_reference_check(P, L, TS, ST, refs[mk],
                                     f"match_kernel {mk} ({route} route)",
                                     CS._corr_launches(mk, route), route)
        torch.cuda.empty_cache()
    print(f"phase 3b's check on this draw: {len(missed)} missed", flush=True)


if __name__ == "__main__":
    main()
