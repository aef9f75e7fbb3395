"""The system under test: the entries of the PyTorch/CUDA port that a
cell's window drives, built from the cell's configuration and loaded with
the benchmark's weights.

- serving: tools/serve.make_serve_step (a GraphStep on the card: the
  inference forward and the uint8 quantization captured once as a CUDA
  graph) and tools/serve.to_host;
- training: train/steps.make_multi_train_step (on the card a ChunkGraph:
  two eager warm-up steps, then the fused G + D step captured once and
  replayed a step at a time) on a train/state.TrainState.

The nets are built without the port's own seeded init (the benchmark
loads every parameter and buffer by name right after), directly on the
run's device.
"""

from __future__ import annotations

from typing import Dict
from unittest import mock

import torch


def options(config: dict, train: bool, batch: int):
    """The port's Options for the configuration's flags at `batch`, held
    to every value the plain reference assumes."""
    from cocosnet_tpu_torch.config import parse_options
    opt = parse_options(list(config["flags"]) + ["--batchSize", str(batch)],
                        is_train=train)
    differ = {k: (getattr(opt, k), v) for k, v in config["model"].items()
              if hasattr(opt, k) and getattr(opt, k) != v}
    if differ:
        raise ValueError(f"the port's options differ from what the "
                         f"reference assumes (port, reference): {differ}")
    return opt


def set_numerics(opt) -> None:
    from cocosnet_tpu_torch.cli import common
    common.set_numerics(opt)


def build_nets(opt, device, weights: Dict[str, torch.Tensor]):
    """Pix2PixNets of opt on device, holding `weights` (reference names,
    prefixed corr. / gen. / disc. / vgg.); raises where the port's state
    names or shapes are not the reference's."""
    from cocosnet_tpu_torch import pix2pix as P
    with torch.device(device), mock.patch.object(P, "init_weights",
                                                 lambda net, gen: None):
        nets = P.Pix2PixNets(opt, device=device, seed=0)
    named = {"corr": nets.corr, "gen": nets.gen}
    if nets.disc is not None:
        named.update(disc=nets.disc, vgg=nets.vgg)
    want = {k.split(".", 1)[0] for k in weights}
    if set(named) != want:
        raise ValueError(f"nets {sorted(named)} against weights for "
                         f"{sorted(want)}")
    with torch.no_grad():
        for prefix, net in named.items():
            sd = {k.split(".", 1)[1]: v for k, v in weights.items()
                  if k.startswith(prefix + ".")}
            own = net.state_dict()
            bad = sorted(set(own) ^ set(sd)) + sorted(
                k for k in own if k in sd and own[k].shape != sd[k].shape)
            if bad:
                raise ValueError(f"{prefix}: state names or shapes differ "
                                 f"from the reference's: {bad[:8]}")
            net.load_state_dict(sd)
    return nets


def serve_step(nets, batch: int):
    from cocosnet_tpu_torch.tools import serve
    return serve.make_serve_step(nets, batch)


def to_host(out: torch.Tensor):
    from cocosnet_tpu_torch.tools import serve
    return serve.to_host(out)


def trainer(opt, nets):
    """(state, multi_step, lr) of a training run from step 0."""
    from cocosnet_tpu_torch.train import state as S
    from cocosnet_tpu_torch.train import steps
    state = S.create_train_state(opt, nets)
    return state, steps.make_multi_train_step(nets), S.lrs_for_epoch(opt, 1)


def _adam_states(state, nets) -> Dict[str, dict]:
    """{leaf name: its torch.optim.Adam state} of both optimizers."""
    from cocosnet_tpu_torch.train import state as S
    out = {k: state.opt_g.state[p] for k, p in state.g_params.items()}
    names = [f"disc.{k}" for k, _ in nets.disc.named_parameters()]
    for k, p in zip(names, S.d_parameters(nets)):
        out[k] = state.opt_d.state[p]
    return out


def first_moments(state, nets) -> Dict[str, torch.Tensor]:
    """{leaf name: Adam's first moment} of both optimizers: after one step
    at beta1 = 0, the gradient each leaf's optimizer got."""
    return {k: s["exp_avg"] for k, s in _adam_states(state, nets).items()}


def snapshot(state, nets) -> dict:
    """The run's state copied to the host in the reference's terms
    (reference/train.Trainer.state): the nets' weights and buffers, Adam's
    moments and step counts by leaf, the EMA shadows."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    weights = {}
    for prefix in ("corr", "gen", "disc", "vgg"):
        weights.update((f"{prefix}.{k}", host(v)) for k, v in
                       getattr(nets, prefix).state_dict().items())
    adam = {k: (host(s["exp_avg"]), host(s["exp_avg_sq"]), int(s["step"]))
            for k, s in _adam_states(state, nets).items()}
    return {"weights": weights, "adam": adam,
            "ema": {k: host(v) for k, v in (state.ema or {}).items()}}


def trained_leaves(state, nets) -> Dict[str, torch.Tensor]:
    """Every trained leaf and EMA shadow by the reference's names."""
    out = dict(state.g_params)
    out.update((f"disc.{k}", p) for k, p in nets.disc.named_parameters())
    out.update((f"ema.{k}", s) for k, s in (state.ema or {}).items())
    return out
