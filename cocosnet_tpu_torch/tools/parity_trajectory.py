"""Training-dynamics trajectory: N fused G + D steps of the port's train
step (train/steps.make_train_step) from given weights on given data, one
curve per loss term. Twin of tools/parity_trajectory.py, whose setting
(`_TRAIN_OVERRIDES`: match_kernel 1, 64 px, batch 2, ngf 64, ndf 16, 12
classes, the spectralspadesyncbatch3x3 generator norm, PONO / PONO_C, EMA,
TTUR) and data (`_make_batches`) are copied here.

A trajectory holds what one step cannot: the TTUR Adam updates, the hinge
G <-> D coupling, the train-mode normalisation statistics and the EMA
shadows, compounded over steps. This tool runs the port only; the test
(tests/test_torch_trajectory.py) runs the JAX package's step beside it from
the same weights, and its `__main__` writes the 50-step comparison.

Routes of the correlation: "library" (the default: matmul + softmax under
autograd, as JAX's use_pallas=False), "kernels" (COCOSNET_PALLAS_MK1_TRAIN=1
with opt.use_pallas True: csrc/corr_fwd.cu and corr_bwd.cu on the card,
their plain versions on the CPU). --compute_dtype bf16 puts the convs on
the bf16 activation policy; TF32 stays off either way.

Weights: the port's nets under --seed, conditioned to unit signal scale
(nn.layers.condition_weights), or --init DIR with net_G.pth, net_Corr.pth
and net_D.pth (a checkpoint's state_<label>/); the VGG19 seeded random
(--vgg_seed) unless --vgg_weights names its .npz or .pth.

    python -m cocosnet_tpu_torch.tools.parity_trajectory --steps 50 \\
        [--route kernels] [--compute_dtype bf16] [--platform cpu] \\
        [--out curves.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

ROUTES = ("library", "kernels")
NETS = (("G", "gen"), ("Corr", "corr"), ("D", "disc"))


def _make_batches(n_steps: int, b: int, size: int, label_nc: int, seed=123):
    """Identical per-step batches for both frameworks (numpy, NHWC)."""
    rs = np.random.RandomState(seed)
    batches = []
    for _ in range(n_steps):
        lab = rs.randint(0, label_nc + 1, (b, size, size, 1)).astype(np.float32)
        img = (rs.rand(b, size, size, 3).astype(np.float32) * 2 - 1)
        # exemplar = shifted real so the correlation has signal
        ref = np.roll(img, 5, axis=1) * 0.9 + 0.1 * rs.rand(
            b, size, size, 3).astype(np.float32)
        lab_ref = np.roll(lab, 5, axis=1)
        batches.append({
            "label": lab, "image": img, "ref": ref, "label_ref": lab_ref,
            "self_ref": np.ones((b,), np.float32),
        })
    return batches


_TRAIN_OVERRIDES = dict(
    isTrain=True, phase="train",
    norm_G="spectralspadesyncbatch3x3", norm_D="spectralinstance",
    norm_E="spectralinstance",
    label_nc=12, contain_dontcare_label=True, semantic_nc=13,
    crop_size=64, batchSize=2, ngf=64, ndf=16, num_D=2, n_layers_D=4,
    use_attention=True, maskmix=True, warp_mask_losstype="direct",
    weight_mask=100.0, match_kernel=1, PONO=True, PONO_C=True,
    vgg_normal_correct=True, use_ema=True, ema_beta=0.999,
    lr=1e-4, beta1=0.5, beta2=0.999, no_TTUR=False,
    lambda_feat=10.0, lambda_vgg=10.0, no_ganFeat_loss=False,
    gan_mode="hinge", which_perceptual="5_2", weight_perceptual=0.01,
    weight_gan=10.0, novgg_featpair=10.0, fm_ratio=0.1, ctx_w=1.0,
    use_22ctx=False, warp_self_w=0.0, warp_cycle_w=0.0,
    D_steps_per_G=1, continue_train=False, mask_epoch=-1,
)


def make_batches(n_steps: int, seed: int = 123):
    """`n_steps` batches at _TRAIN_OVERRIDES's size, as the JAX tool draws
    them."""
    return _make_batches(n_steps, b=_TRAIN_OVERRIDES["batchSize"],
                         size=_TRAIN_OVERRIDES["crop_size"],
                         label_nc=_TRAIN_OVERRIDES["label_nc"], seed=seed)


def train_opt(route: str = "library", compute_dtype: str = "f32"):
    """The port's options at _TRAIN_OVERRIDES's setting (run_ours's:
    ade20k, load_size 64), use_pallas True on the kernel route."""
    from cocosnet_tpu_torch.config import test_defaults
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    return test_defaults(
        dataset_mode="ade20k", load_size=64, use_pallas=route == "kernels",
        compute_dtype=compute_dtype,
        **{k: v for k, v in _TRAIN_OVERRIDES.items()
           if k not in ("phase", "semantic_nc")})


def make_init_sd(seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"G", "Corr", "D": state dict}, the reference's names, on the CPU:
    the port's nets under `seed`, each conditioned to unit signal scale
    from one generator of that seed (the init leaves spectral sigma near 0,
    ROADMAP trap "Random init")."""
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.nn.layers import condition_weights
    nets = P.Pix2PixNets(train_opt(), device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, name in NETS:
        net = getattr(nets, name)
        condition_weights(net, g, "cpu")
        out[key] = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return out


def make_vgg_sd(seed: int = 7) -> Dict[str, torch.Tensor]:
    """A seeded random VGG19 state dict standing in for vgg19_conv.pth (not
    in the repository), as the JAX tool's make_vgg_sd does: both sides
    share it, so the perceptual and contextual losses run on one feature
    extractor."""
    from cocosnet_tpu_torch.nn.layers import init_weights
    from cocosnet_tpu_torch.nn.vgg import VGG19Features
    vgg = VGG19Features(vgg_normal_correct=True)
    init_weights(vgg, torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in vgg.state_dict().items()}


def load_init(init_dir: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """net_G.pth, net_Corr.pth and net_D.pth of a checkpoint directory."""
    return {key: torch.load(os.path.join(init_dir, f"net_{key}.pth"),
                            map_location="cpu", weights_only=True)
            for key, _ in NETS}


@contextlib.contextmanager
def numerics(route: str, compute_dtype: str):
    """The route's switch (COCOSNET_PALLAS_MK1_TRAIN), the activation
    policy of compute_dtype and TF32 off, restored after."""
    from cocosnet_tpu_torch.models.correspondence import MK1_TRAIN_ENV
    from cocosnet_tpu_torch.nn import layers as L
    env = os.environ.get(MK1_TRAIN_ENV)
    policy = L.get_compute_dtype()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    if route == "kernels":
        os.environ[MK1_TRAIN_ENV] = "1"
    else:
        os.environ.pop(MK1_TRAIN_ENV, None)
    L.set_compute_dtype(torch.bfloat16 if compute_dtype == "bf16" else None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        if env is None:
            os.environ.pop(MK1_TRAIN_ENV, None)
        else:
            os.environ[MK1_TRAIN_ENV] = env
        L.set_compute_dtype(policy)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def run_port(batches, init_sd, vgg_sd, device="cuda", route="library",
             compute_dtype="f32", vgg_weights: str = ""
             ) -> Tuple[Dict[str, List[float]], SimpleNamespace]:
    """len(batches) steps of the port's make_train_step from init_sd (and
    vgg_sd, or the file vgg_weights) on `route` in `compute_dtype`.
    Returns ({term: [value per step]}, the final state: nets and the
    TrainState)."""
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.train import checkpoints as CK
    from cocosnet_tpu_torch.train import state as S
    from cocosnet_tpu_torch.train import steps as ST
    opt = train_opt(route, compute_dtype)
    curves: Dict[str, List[float]] = {}
    with numerics(route, compute_dtype):
        nets = P.Pix2PixNets(opt, device=device, seed=0)
        for key, name in NETS:
            getattr(nets, name).load_state_dict(init_sd[key])
        if vgg_weights:
            if CK.load_vgg(SimpleNamespace(vgg_weights=vgg_weights),
                           nets) is None:
                raise FileNotFoundError(f"no VGG weights at {vgg_weights}")
        else:
            nets.vgg.load_state_dict(vgg_sd)
        state = S.create_train_state(opt, nets)
        step = ST.make_train_step(nets)
        lr = S.lrs_for_epoch(opt, 1)
        for batch in batches:
            losses, _ = step(state, batch, lr)
            for k, v in losses.items():
                curves.setdefault(k, []).append(float(v))
    return curves, SimpleNamespace(nets=nets, state=state)


def main(argv=None) -> dict:
    from cocosnet_tpu_torch.cli.common import device_for
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default="parity_curves.json")
    ap.add_argument("--platform", default="",
                    help="'' or gpu: the card (raises without one); cpu: "
                         "the plain versions")
    ap.add_argument("--route", default="library", choices=ROUTES)
    ap.add_argument("--compute_dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vgg_seed", type=int, default=7)
    ap.add_argument("--init", default="",
                    help="a directory with net_G.pth, net_Corr.pth, "
                         "net_D.pth in place of the seeded weights")
    ap.add_argument("--vgg_weights", default="",
                    help="the VGG19's .npz or .pth in place of the seeded "
                         "random one")
    args = ap.parse_args(argv)
    device = device_for(args.platform)
    init_sd = load_init(args.init) if args.init else make_init_sd(args.seed)
    vgg_sd = None if args.vgg_weights else make_vgg_sd(args.vgg_seed)
    curves, _ = run_port(make_batches(args.steps), init_sd, vgg_sd, device,
                         args.route, args.compute_dtype, args.vgg_weights)
    for k, v in sorted(curves.items()):
        print(f"{k:12s} first {v[0]:.4f} final {v[-1]:.4f} "
              f"finite {bool(np.isfinite(v).all())}")
    report = {"route": args.route, "compute_dtype": args.compute_dtype,
              "device": str(device), "steps": args.steps, "curves": curves}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
