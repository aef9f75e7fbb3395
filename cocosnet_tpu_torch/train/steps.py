"""The fused train step: generator forward + its loss terms + Adam update on
netG + netCorr, the EMA shadows, then the discriminator update on the same
fake, detached; K of them as one chunk (--steps_per_dispatch: on the card
one CUDA graph replayed a step at a time); the discriminator-only step of
--D_steps_per_G > 1; the generator half alone (tools/profile_train.py
times it apart); and the inference step.

Counterpart of cocosnet_tpu/train/steps.py `make_train_step`,
`make_multi_train_step`, `make_d_step` and `make_inference_step` (the
reference's per-iteration schedule,
train.py:54-58, pix2pix_trainer.py:52-74). The train step runs inside
nn.layers.training(), where the convs route as the JAX package's training
trace routes them: library convs by default,
conv3x3_fused forward and backward under COCOSNET_FUSED_CONV_TRAIN=1, the
dW kernel under COCOSNET_PALLAS_DW=1 or =all (nn/layers.conv2d); and with
gen, corr and disc in train mode, so each spectral norm advances
its power iteration on each forward, as torch's pre-hook does: G's and
Corr's once per step, D's twice (in the G step's discriminate and in the D
step). The correlation runs as models/correspondence routes it: on the
shift9 kernels forward and backward at match_kernel 3; at match_kernel 1
as matmul + softmax under autograd, or on attend_corr's kernels under
COCOSNET_PALLAS_MK1_TRAIN=1; once a step for the row warp and once more
for each column (cycle) warp the configuration asks for. The step updates
the networks' parameters, the optimizer state, the spectral u/v and the
EMA shadows in place.

Across processes (a mesh of data and model ranks, cocosnet_tpu_torch/
mesh.py), each net's gradients are averaged over the job before its Adam
step, as one flat bucket and one all_reduce (the JAX package's one program
sums them over the `data` axis): the ranks of a model group hold the same
gradients already, so the mean is over the data ranks, and every rank
takes the same step. The reported losses are their means over the job,
the global batch's losses. The batch-coupled loss terms read their global
denominators in pix2pix (mesh.data_sum), and every BatchNorm the global
batch's moments (nn/norms.py, mesh.data_sum_grad).

A BatchNorm in train mode updates its running statistics on each forward:
G's and Corr's in the G step, D's in the G step's discriminate and in the
D step (fake and real as one batch). The noise of --mask_noise and
--noise_for_mask is drawn once a step from the state's generator, before
the forward (pix2pix.draw_noise; steps.py:100-107). --remat recomputes
each SPADE block and the fake's VGG tower in the backward; --remat_full
the whole correspondence + generator forward (steps.py:109-115), so the
recompute adds the correlation's forward launches (not its backward's);
either way each spectral norm and BatchNorm advances once a forward
(nn/remat.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch import pix2pix as P
from cocosnet_tpu_torch.nn import layers as L
from cocosnet_tpu_torch.nn import remat
from cocosnet_tpu_torch.train import state as S
from cocosnet_tpu_torch.utils import profiling


def _apply_grads(optimizer: torch.optim.Optimizer, params: Sequence,
                 loss: torch.Tensor,
                 stages: Optional[Tuple[str, str]] = None) -> None:
    """One Adam step of `params` on d(loss)/d(params), averaged over the
    job's ranks, at the rate the optimizer holds (S.set_lrs); a parameter
    the loss does not reach takes a zero gradient, as in optax. `stages`:
    the stage marks (utils/profiling.mark) before the gradient and before
    the update."""
    if stages:
        profiling.mark(stages[0], loss.device)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = M.mean_over_job([torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)])
    if stages:
        profiling.mark(stages[1], loss.device)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def _g_phase(nets: P.Pix2PixNets, state: S.TrainState, data: P.Batch
             ) -> Tuple[Dict[str, torch.Tensor], P.Batch]:
    """The generator half of a step, inside train mode and
    nn.layers.training(): the forward and its loss terms, Adam on netG +
    netCorr, the EMA shadows. Returns (G losses, the forward's outputs).
    Marks the stages `losses` (the VGG features and the loss terms),
    `loss_backward` (the gradient until it reaches the fake image: the
    loss terms' backward through VGG and D), `net_backward` (from the
    fake's gradient hook: the generator's and the correspondence's
    backward) and `g_update` (the Adam step and the EMA)."""
    opt = nets.opt
    noise = P.draw_noise(opt, data, state.noise, train=True)
    if opt.remat_full:
        out = remat.checkpoint(P.generate_fake, nets, data, True, noise)
    else:
        out = P.generate_fake(nets, data, train=True, noise=noise)
    if out["fake_image"].requires_grad:
        out["fake_image"].register_hook(
            lambda g: profiling.mark("net_backward", g.device))
    profiling.mark("losses", nets.device)
    with torch.no_grad():
        out["ref_features"] = P.vgg_features(nets, data["ref_image"])
        out["real_features"] = P.vgg_features(nets, data["real_image"])
    g_losses = P.compute_generator_losses(nets, data, out)
    g_params = list(state.g_params.values())
    _apply_grads(state.opt_g, g_params, sum(g_losses.values()),
                 ("loss_backward", "g_update"))
    if state.ema is not None:
        S.ema_update(state.ema, state.g_params, opt.ema_beta)
    return g_losses, out


def _d_phase(nets: P.Pix2PixNets, state: S.TrainState, data: P.Batch,
             fake_image: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The discriminator half, on the fake detached, inside train mode and
    nn.layers.training(): its losses and Adam on D. Marks the stage
    `d_step`."""
    profiling.mark("d_step", nets.device)
    d_losses = P.compute_discriminator_losses(nets, data, fake_image)
    _apply_grads(state.opt_d, S.d_parameters(nets), sum(d_losses.values()))
    return d_losses


def make_train_step(nets: P.Pix2PixNets):
    """step(state, batch, lr) -> (losses, visuals). batch: the loader's
    dict (label, image, ref, label_ref, self_ref); lr: (lr_G, lr_D) from
    S.lrs_for_epoch, written into the optimizers where it changed
    (S.set_lrs). The losses are 0-d f32 tensors on the nets' device
    (reading them synchronises). `step.fused(state, batch)` is the step
    without the rates and the host's step counter: what
    make_multi_train_step captures. It marks its stages
    (utils/profiling.STAGES) in order, `prep` first and `end` last."""
    opt = nets.opt

    def fused(state: S.TrainState, batch
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        profiling.mark("prep", nets.device)
        data = P.preprocess_input(opt, batch, device=nets.device)
        nets.set_train(True)
        try:
            with L.training():
                g_losses, out = _g_phase(nets, state, data)
                d_losses = _d_phase(nets, state, data, out["fake_image"])
        finally:
            nets.set_train(False)
        losses = _global_losses({**g_losses, **d_losses})
        visuals = {k: out[k].detach() for k in ("fake_image", "warp_out",
                                                "warp_mask") if k in out}
        profiling.mark("end", nets.device)
        return losses, visuals

    def train_step(state: S.TrainState, batch, lr
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        S.set_lrs(state, lr)
        losses, visuals = fused(state, batch)
        state.step += 1
        return losses, visuals

    train_step.fused = fused
    return train_step


# eager steps of a chunk before its capture (on the capture stream): the
# optimizers' state, the kernels' libraries, cuBLAS's workspace and cuDNN's
# plans exist after them
WARM_UP_STEPS = 2


def make_multi_train_step(nets: P.Pix2PixNets):
    """multi_step(state, batches, lr) -> (losses, visuals): K fused train
    steps of make_train_step on a list of K loader batches, with one host
    sync a chunk at most, the counterpart of the JAX package's
    make_multi_train_step (cocosnet_tpu/train/steps.py:61, K steps as one
    lax.scan). losses: {name: (K,) f32 on the nets' device}, the columns
    of one (K, n) buffer, step j's losses in row j; visuals: the last
    step's. lr: (lr_G, lr_D) for the whole chunk.

    On the CPU it runs the K steps eagerly. On the card it holds a CUDA
    graph of `step.fused` on one batch (ChunkGraph): the first
    WARM_UP_STEPS steps it is handed run eagerly on the capture stream,
    real steps of the run; then the step is captured once and each later
    step replays it. The graph is bound to the first state it is handed,
    and to the noise phase nets.opt names: under --noise_for_mask a new
    phase takes a new multi step. A capture that fails raises; nothing
    falls back to the eager step. A gloo job of more than one rank raises
    on the card (mesh.check_capturable)."""
    step = make_train_step(nets)
    if nets.device.type == "cuda":
        M.check_capturable()
        return ChunkGraph(nets, step)

    def multi_step(state: S.TrainState, batches: Sequence, lr):
        rows = []
        for batch in batches:
            losses, visuals = step(state, batch, lr)
            rows.append(torch.stack(list(losses.values())))
        return dict(zip(losses, torch.stack(rows).unbind(1))), visuals

    return multi_step


class ChunkGraph:
    """make_multi_train_step on the card: the fused step captured once as a
    CUDA graph, replayed from static inputs.

    Before the capture, WARM_UP_STEPS steps run eagerly on the capture
    stream (as tools/serve.GraphStep warms up), each a step of the run.
    The capture records `step.fused(state, inputs)` on static input
    tensors shaped as the batch it is made on; preprocessing, both Adam
    steps (capturable, their rates and step counts on the device:
    train/state.py), the EMA, the spectral u/v, the BatchNorm statistics
    and under NCCL the gradients' all_reduce are inside it. A capture
    moves no state: it records work without running it. With
    --mask_noise or --noise_for_mask the state's noise generator is
    registered with the graph, so each replay draws what an eager step
    would draw from it; a torch without register_generator_state refuses
    those flags here. A replay copies its batch into the inputs, replays,
    and copies the graph's losses into its row of the chunk's (K, n)
    buffer; the visuals are cloned after the last replay. state.step
    advances on the host. The kernels' Python launch counts advance on the
    capture call only."""

    def __init__(self, nets: P.Pix2PixNets, step):
        self.nets, self.step = nets, step
        self.stream = torch.cuda.Stream(nets.device)
        self.warm = 0
        self.state = None
        self.graph = None
        self.inputs: Dict[str, torch.Tensor] = {}
        self.losses = None      # the graph's (n,) losses
        self.visuals: Dict[str, torch.Tensor] = {}
        self.names = None
        self.draws = bool(nets.opt.mask_noise
                          or P.uses_ref_noise(nets.opt, train=True))
        if self.draws and not hasattr(torch.cuda.CUDAGraph,
                                      "register_generator_state"):
            raise NotImplementedError(
                f"--mask_noise / --noise_for_mask with --steps_per_dispatch "
                f"> 1: torch {torch.__version__} cannot register the noise "
                f"generator with a CUDA graph")

    def _eager(self, state: S.TrainState, batch):
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.step.fused(state, batch)
        current.wait_stream(self.stream)
        return out

    def _capture(self, state: S.TrainState, batch) -> None:
        self.inputs = {k: torch.empty_like(torch.as_tensor(v),
                                           device=self.nets.device)
                       for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        if self.draws:
            graph.register_generator_state(state.noise)
        with torch.cuda.graph(graph, stream=self.stream):
            losses, self.visuals = self.step.fused(state, self.inputs)
            self.losses = torch.stack(list(losses.values()))
        self.graph = graph

    def __call__(self, state: S.TrainState, batches: Sequence, lr):
        if self.state is None:
            self.state = state
        elif state is not self.state:
            raise ValueError("this chunk's graph holds another train state")
        S.set_lrs(state, lr)
        rows = None
        for j, batch in enumerate(batches):
            if self.graph is None and self.warm < WARM_UP_STEPS:
                losses, visuals = self._eager(state, batch)
                self.warm += 1
                self.names = list(losses)
                row = torch.stack(list(losses.values()))
            else:
                if self.graph is None:
                    self._capture(state, batch)
                for k, dst in self.inputs.items():
                    dst.copy_(torch.as_tensor(batch[k]), non_blocking=True)
                self.graph.replay()
                row, visuals = self.losses, self.visuals
            if rows is None:
                rows = torch.empty((len(batches), row.numel()),
                                   dtype=row.dtype, device=row.device)
            rows[j].copy_(row)
        state.step += len(batches)
        visuals = {k: v.clone() for k, v in visuals.items()}
        return dict(zip(self.names, rows.unbind(1))), visuals


def make_g_step(nets: P.Pix2PixNets):
    """step(state, batch, lr) -> (G losses, the forward's outputs): the
    train step's generator half alone (tools/profile_train.py times it
    apart); state.step stays where it is."""
    def g_step(state: S.TrainState, batch, lr):
        S.set_lrs(state, lr)
        data = P.preprocess_input(nets.opt, batch, device=nets.device)
        nets.set_train(True)
        try:
            with L.training():
                g_losses, out = _g_phase(nets, state, data)
        finally:
            nets.set_train(False)
        return _global_losses(g_losses), out

    return g_step


def make_d_step(nets: P.Pix2PixNets):
    """step(state, batch, lr, fake_image) -> {"D_Fake", "D_real"}: the
    discriminator-only update of the iterations where --D_steps_per_G > 1
    skips the generator, on the last G step's fake, detached (reference
    train.py:54-58, pix2pix_trainer.py:64-74). D runs in train mode, so its
    spectral u/v advance once; Adam steps opt_d at lr_D; state.step counts
    the step."""
    def d_step(state: S.TrainState, batch, lr,
               fake_image: torch.Tensor) -> Dict[str, torch.Tensor]:
        S.set_lrs(state, lr)
        data = P.preprocess_input(nets.opt, batch, device=nets.device)
        nets.set_train(True)
        try:
            with L.training():
                d_losses = _d_phase(nets, state, data, fake_image)
        finally:
            nets.set_train(False)
        state.step += 1
        return _global_losses(d_losses)

    return d_step


def _global_losses(losses: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The losses, detached, as their means over the job's ranks."""
    return dict(zip(losses, M.mean_over_job([v.detach()
                                             for v in losses.values()])))


def make_inference_step(nets: P.Pix2PixNets):
    """step(batch, rng=None) -> {"fake_image", "warp_out"} for one loader
    batch, under torch.inference_mode(). The nets hold their weights, so
    the step takes no variables; rng, a torch.Generator on the nets'
    device, feeds the eval-time draw of --noise_for_mask (a fixed draw
    without one)."""
    opt = nets.opt

    def inference_step(batch, rng=None) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            data = P.preprocess_input(opt, batch, device=nets.device)
            out = P.inference(nets, data, generator=rng)
            return {"fake_image": out["fake_image"],
                    "warp_out": out.get("warp_out")}

    return inference_step
