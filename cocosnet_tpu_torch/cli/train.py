"""Training CLI: the twin of the repository's train.py, flag for flag
(reference train.py). From the repository root:

  python -m cocosnet_tpu_torch.cli.train --name ade20k --dataset_mode ade20k \\
      --dataroot <path> --niter 100 --niter_decay 100 --use_attention \\
      --maskmix --warp_mask_losstype direct --weight_mask 100.0 --PONO \\
      --PONO_C --batchSize 32 --vgg_normal_correct

The structure of reference train.py:27-122: per iteration the fused G + D
step (train.steps.make_train_step), or under --D_steps_per_G > 1 a
D-only step on the last fake where i % D_steps_per_G != 0
(make_d_step); loss lines (with img/s) to stdout and loss_log.txt every
--print_freq images, visual grids every --display_freq, `latest` every
--save_latest_freq with iter.txt, `latest` and `<epoch>` at the epoch ends
(train.checkpoints: torch.save state dicts under the reference's names),
the learning rates of train.state.lrs_for_epoch each epoch, and a NaN loss
saves `nan_debug` and stops. --continue_train --which_epoch resumes from
that checkpoint and from iter.txt. Runs on the GPU; --platform cpu runs
the kernels' plain versions on the CPU. Under --noise_for_mask the steps
are rebuilt when the epoch passes --mask_epoch (pix2pix.set_noise_phase).

--steps_per_dispatch K > 1, as train.py:121-260: the loader's batches
gather into chunks of K, each run by train.steps.make_multi_train_step (on
the card one CUDA-graph replay a step, after two eager warm-up steps in
the first chunk of each noise phase; on the CPU K eager steps), with one
host copy of the chunk's stacked losses and one NaN check; the loss lines,
visuals and events still come a step at a time, from the chunk's rows (the
visuals of a chunk are its last step's); a `latest` save that falls inside
a chunk is made at its boundary, with iter.txt counting the chunk's end;
the epoch's tail shorter than a chunk runs a step at a time; with
--profile_dir the third chunk is traced; --D_steps_per_G > 1 prints
train.py's message and runs K = 1.

Parallelism, as train.py's mesh (cocosnet_tpu_torch/mesh.py): every
visible card joins the data axis unless --mesh_data says how many;
--mesh_model N shares the correlation's query rows over N ranks; one
worker process a card, spawned here (--platform cpu: one a rank, over
gloo), or started by torchrun; --distributed with --coordinator_address,
--num_processes (hosts) and --process_id joins the hosts. --batchSize is
the global batch: each data rank loads its shard. Every rank starts from
the same seed, and after a resume takes rank 0's state; rank 0 alone
prints, writes loss_log.txt, the visuals (of the global batch) and the
checkpoints (after a barrier). The nets hold their weights,
so no batch is taken before the loop to build them (train.py takes one,
which draws a shuffle): the first epoch runs the loader's first shuffle,
as the reference's train.py does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch import pix2pix as P
from cocosnet_tpu_torch.cli import common
from cocosnet_tpu_torch.config import parse_options, save_options
from cocosnet_tpu_torch.data.loader import create_dataloader, to_device
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train import state as S
from cocosnet_tpu_torch.train import steps as ST
from cocosnet_tpu_torch.utils import visuals as V
from cocosnet_tpu_torch.utils.iter_counter import StepEvents, TrainProgress
from cocosnet_tpu_torch.utils.logging import print_current_errors
from cocosnet_tpu_torch.utils.profiling import maybe_trace


@dataclasses.dataclass
class TrainRun:
    """What a run did: its G steps and D-only steps, the host seconds of
    each iteration (from the losses of the one before on the host, or the
    epoch's start, to its own: the logging and saving between them, the
    wait for the loader, the copy and the device's work; under
    --steps_per_dispatch K each step of a chunk counts the chunk's seconds
    divided by K), the last losses, the nets and the train state it ended
    with."""
    g_steps: int
    d_steps: int
    step_seconds: List[float]
    losses: Dict[str, float]
    nets: P.Pix2PixNets
    state: S.TrainState


def parse(argv):
    return parse_options(argv, is_train=True)


def main(argv=None):
    """The run in this process (its TrainRun), or in the workers the mesh
    flags ask for (None: rank 0 printed and wrote what it does)."""
    opt = parse(argv)
    return common.run_job("cocosnet_tpu_torch.cli.train:train_loop", argv, opt)


def train_loop(opt, device, mesh: M.Mesh) -> TrainRun:
    """The training loop on this rank of `mesh`."""
    rank0 = mesh.rank == 0
    common.set_numerics(opt)
    if rank0:
        save_options(opt, os.path.join(opt.checkpoints_dir, opt.name,
                                       "opt.json"))

    dataloader = create_dataloader(opt, mesh.data_rank, mesh.data)
    progress = TrainProgress(opt, len(dataloader.dataset),
                             write_record=rank0)
    nets = P.Pix2PixNets(opt, device=device, seed=opt.seed)

    # pretrained VGG for the perceptual losses
    vgg = C.load_vgg(opt, nets)
    if vgg is not None:
        print(f"loaded VGG weights from {vgg}")
    else:
        print(f"WARNING: VGG weights not found at {opt.vgg_weights}; "
              "perceptual losses use random features")

    state = S.create_train_state(opt, nets)
    if opt.continue_train:
        try:
            C.load_state(opt, state, nets, opt.which_epoch)
            print(f"resumed train state from {opt.which_epoch}")
        except FileNotFoundError as e:
            print(f"could not resume ({e}); starting fresh")
        # every rank read the same files; rank 0's state is the run's
        M.broadcast_from_rank0(_state_tensors(nets, state))

    spd = opt.steps_per_dispatch
    if spd > 1 and opt.D_steps_per_G > 1:
        print("steps_per_dispatch > 1 is unsupported with D_steps_per_G > 1;"
              " running per-step dispatch")
        spd = 1
    save_root = common.save_root(opt)
    run = TrainRun(g_steps=0, d_steps=0, step_seconds=[], losses={},
                   nets=nets, state=state)

    def save(label):
        M.barrier()
        if rank0:
            C.save_state(opt, state, nets, label)

    def nan_bail(epoch):
        save("nan_debug")
        raise FloatingPointError(
            f"loss went NaN at epoch {epoch}, iter {progress.epoch_iter} — "
            f"state saved as 'nan_debug' for inspection; rerun with "
            f"--compute_dtype f32 and/or a lower --lr")

    def handle_events(events, epoch, batch, visuals):
        if events.print_losses and rank0:
            print_current_errors(
                opt, epoch, progress.epoch_iter,
                {**run.losses,
                 "img/s": opt.batchSize / run.step_seconds[-1]},
                progress.time_per_img)
        if events.display_visuals and visuals:
            batch, visuals = _global_visuals(batch, visuals)
            try:
                if rank0:
                    _save_visuals(opt, batch, visuals, epoch,
                                  progress.images_seen, save_root)
            except OSError as err:
                print(err)
        if events.save_latest:
            print(f"saving the latest model (epoch {epoch}, "
                  f"total_steps {progress.images_seen})")
            save("latest")
            progress.save_record()

    def record(names, values, seconds, epoch):
        """The steps' host rows of losses: NaN check, TrainRun."""
        run.step_seconds += [seconds / len(values)] * len(values)
        if bool(torch.isnan(values).any()):
            nan_bail(epoch)
        run.losses = dict(zip(names, values[-1].tolist()))

    phase = None
    last_fake = None
    for epoch in progress.epochs():
        progress.begin_epoch(epoch)
        if phase is None or P.noise_phase(opt, epoch) != phase:
            # the --noise_for_mask phase changes the step (train.py's
            # get_steps): rebuilt, and on the card recaptured
            phase = P.set_noise_phase(nets, epoch)
            train_step = ST.make_train_step(nets)
            d_only_step = (ST.make_d_step(nets) if opt.D_steps_per_G > 1
                           else None)
            multi_step = ST.make_multi_train_step(nets) if spd > 1 else None
        lr = S.lrs_for_epoch(opt, epoch)  # (lr_G, lr_D)
        pending = []    # (arrays, host batch) awaiting a full chunk
        t0 = time.perf_counter()

        def one_step(i, arrays, batch):
            nonlocal last_fake, t0
            events = progress.step()
            trace_this = bool(opt.profile_dir) and epoch == 1 and i == 2
            with maybe_trace(opt.profile_dir, trace_this):
                if d_only_step is not None and i % opt.D_steps_per_G != 0 \
                        and last_fake is not None:
                    # D-only iteration (reference train.py:54-58)
                    metrics = d_only_step(state, arrays, lr, last_fake)
                    visuals = {}
                    run.d_steps += 1
                else:
                    metrics, visuals = train_step(state, arrays, lr)
                    last_fake = visuals["fake_image"]
                    run.g_steps += 1
            # one copy to the host for all the losses; it waits for the step
            values = torch.stack(list(metrics.values())).float().cpu()
            record(list(metrics), values[None], time.perf_counter() - t0,
                   epoch)
            t0 = time.perf_counter()
            handle_events(events, epoch, batch, visuals)

        def run_chunk(chunk_i):
            nonlocal pending, t0
            chunk, pending = pending, []
            trace_this = bool(opt.profile_dir) and epoch == 1 \
                and chunk_i == 2
            with maybe_trace(opt.profile_dir, trace_this):
                metrics, visuals = multi_step(state, [a for a, _ in chunk],
                                              lr)
            # one host copy and one NaN check a chunk
            values = torch.stack(list(metrics.values()), 1).float().cpu()
            record(list(metrics), values, time.perf_counter() - t0, epoch)
            t0 = time.perf_counter()
            run.g_steps += len(chunk)
            # a `latest` save inside the chunk waits for its boundary: the
            # state holds the chunk's end, and iter.txt must count it
            want_save = False
            for j in range(len(chunk)):
                run.losses = dict(zip(metrics, values[j].tolist()))
                events = progress.step()
                want_save = want_save or events.save_latest
                handle_events(dataclasses.replace(events, save_latest=False),
                              epoch, chunk[-1][1], visuals)
            if want_save:
                handle_events(StepEvents(save_latest=True), epoch, None, {})

        for i, batch in enumerate(dataloader):
            arrays, _ = to_device(batch, device)
            if multi_step is not None:
                pending.append((arrays, batch))
                if len(pending) == spd:
                    run_chunk(i // spd)
                continue
            one_step(i, arrays, batch)
        # the epoch's tail shorter than a chunk: a step at a time
        for arrays, batch in pending:
            one_step(-1, arrays, batch)
        pending = []
        progress.end_epoch()
        if epoch % opt.save_epoch_freq == 0 or epoch == progress.final_epoch:
            print(f"saving the model at the end of epoch {epoch}, "
                  f"iters {progress.images_seen}")
            save("latest")
            save(str(epoch))

    print("Training was successfully finished.")
    return run


def _state_tensors(nets, state) -> List[torch.Tensor]:
    """Every tensor of the run's state on the nets' device: the nets'
    parameters and buffers (spectral u/v), the EMA shadows and the
    optimizers' moments, and on the card their step counts (capturable
    Adam keeps them there; on the CPU they stay on the host, equal on
    every rank)."""
    out = [t for net in nets.modules() for t in net.state_dict().values()]
    out += list((state.ema or {}).values())
    for o in (state.opt_g, state.opt_d):
        for st in o.state.values():
            out += [t for t in st.values() if torch.is_tensor(t)]
    return [t for t in out if t.device.type == nets.device.type]


def _global_visuals(batch, visuals):
    """The global batch's host arrays and visuals, gathered over the data
    ranks (every rank calls it; the batch and visuals themselves on one
    data rank)."""
    if M.global_mesh().data == 1:
        return batch, visuals
    return (common.global_batch(batch),
            {k: M.gather_data(v) for k, v in visuals.items()})


def _save_visuals(opt, batch, visuals, epoch, step, save_root) -> None:
    """label / exemplar / warp / output / real rows, one column per sample
    (train.py:278-299)."""
    fake = common.host(visuals["fake_image"])
    rows = [common.label_visual(batch["label"], opt.dataset_mode),
            batch["ref"]]
    if visuals.get("warp_out") is not None:
        rows.append(common.host(visuals["warp_out"]))
    rows += [fake, batch["image"]]
    imgs = (np.concatenate(rows, axis=0) + 1.0) / 2.0
    V.save_image_grid(
        imgs, os.path.join(save_root, "training", opt.name,
                           f"{epoch}_{step}.png"), nrow=fake.shape[0])


if __name__ == "__main__":
    main()
