"""Batch inference CLI: the twin of the repository's test.py, flag for flag
(reference test.py). From the repository root:

  python -m cocosnet_tpu_torch.cli.test --name ade20k --dataset_mode ade20k \\
      --dataroot ./imgs/ade20k --batchSize 6 --use_attention --maskmix \\
      --warp_mask_losstype direct --PONO --PONO_C

Loads G and Corr from <checkpoints_dir>/<name>/state_<which_epoch>/ (the
train twin's checkpoint) or from the reference's flat
<which_epoch>_net_{G,Corr}.pth files, and writes per batch the label /
exemplar / output comparison grid output/test/<name>/<i>.png, or with
--save_per_img each output as output/test_per_img/<name>/<image name>, as
test.py does (reference test.py:27-69). Runs on the GPU; --platform cpu
runs the kernels' plain versions on the CPU.

Each batch's noise (--noise_for_mask) comes from a generator keyed by
--seed and the batch index (noise_generator), as test.py folds the batch
index into its key (test.py:91-94); the bits are the port's own. With
--show_corr each batch's warped exemplars go to
output/test/<name>_corr/<i>_<j>.png (test.py:98-102).

--mesh_model N (the 512 px single-image inference of the README) shares
the correlation's query rows over N ranks, and --mesh_data the batch, one
worker process a card as the train twin runs them (cli/common.run_job):
each data rank loads its shard of each batch (the last one padded with
duplicates), and rank 0 writes the global batch's images, as test.py's
one process does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch import pix2pix as P
from cocosnet_tpu_torch.cli import common
from cocosnet_tpu_torch.config import parse_options
from cocosnet_tpu_torch.data.loader import create_dataloader, to_device
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train.steps import make_inference_step
from cocosnet_tpu_torch.utils import visuals as V


@dataclasses.dataclass
class InferenceRun:
    """What a run did: images and batches through the loop, its seconds
    (host clock, the host pipeline included), the nets it ran, and the
    first batch (as the loader gave it) with its fake_image."""
    images: int
    batches: int
    seconds: float
    nets: P.Pix2PixNets
    first_batch: Optional[Dict] = None
    first_fake: Optional[np.ndarray] = None


def parse(argv):
    return parse_options(argv, is_train=False)


def main(argv=None):
    """The run in this process (its InferenceRun), or in the workers the
    mesh flags ask for (None: rank 0 printed and wrote the images)."""
    opt = parse(argv)
    return common.run_job("cocosnet_tpu_torch.cli.test:test_loop", argv, opt,
                          all_devices=False)


def noise_generator(seed: int, index: int, device) -> torch.Generator:
    """The noise generator of batch `index`: --seed with the index folded
    in."""
    return torch.Generator(device).manual_seed(seed * 1_000_003 + index)


def test_loop(opt, device, mesh: M.Mesh) -> InferenceRun:
    """The inference loop on this rank of `mesh`."""
    rank0 = mesh.rank == 0
    common.set_numerics(opt)

    dataloader = create_dataloader(opt, mesh.data_rank, mesh.data)
    nets = P.Pix2PixNets(opt, device=device, seed=opt.seed)

    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.name)
    loaded = C.load_inference(opt, nets, opt.which_epoch)
    if loaded is not None:
        print(loaded)
    elif opt.allow_random_weights:
        print(f"WARNING: no checkpoint found under {ckpt_dir}; "
              "running with random weights (--allow_random_weights)")
    else:
        raise SystemExit(
            f"No checkpoint found under {ckpt_dir} (tried "
            f"state_{opt.which_epoch} and torch "
            f"{opt.which_epoch}_net_G/Corr.pth). Pass "
            f"--allow_random_weights to run with random weights anyway.")

    inference_step = make_inference_step(nets)
    save_root = common.save_root(opt)
    run = InferenceRun(images=0, batches=0, seconds=0.0, nets=nets)
    t_start = time.perf_counter()
    for i, batch in enumerate(dataloader):
        print(f"{i} / {len(dataloader)}")
        if i * opt.batchSize >= opt.how_many:
            break
        arrays, paths = to_device(batch, device)
        out = inference_step(arrays, noise_generator(opt.seed, i, device))
        fake, warp = out["fake_image"], out["warp_out"]
        if mesh.data > 1:   # the global batch, in data-rank order
            fake, warp = M.gather_data(fake), M.gather_data(warp)
            batch = common.global_batch(batch)
            paths = {k: batch[k] for k in paths}
        fake = common.host(fake)
        if i == 0:
            run.first_batch, run.first_fake = batch, fake
        run.images += fake.shape[0]
        run.batches += 1

        if not rank0:
            continue
        if opt.show_corr:
            warp = (common.host(warp) + 1.0) / 2.0
            for j in range(warp.shape[0]):
                V.save_image(warp[j], os.path.join(
                    save_root, "test", opt.name + "_corr", f"{i}_{j}.png"))
        if opt.save_per_img:
            root = os.path.join(save_root, "test_per_img", opt.name)
            imgs = (fake + 1.0) / 2.0
            for j in range(imgs.shape[0]):
                V.save_image(imgs[j], os.path.join(root, common.image_name(
                    paths["path"][j], opt.dataset_mode)))
        else:
            imgs = np.concatenate([common.label_visual(batch["label"],
                                                       opt.dataset_mode),
                                   batch["ref"], fake], axis=0)
            imgs = (imgs + 1.0) / 2.0
            V.save_image_grid(
                imgs, os.path.join(save_root, "test", opt.name, f"{i}.png"),
                nrow=fake.shape[0])
    run.seconds = time.perf_counter() - t_start
    print(f"processed {run.images} images in {run.seconds:.2f}s "
          f"({run.images / run.seconds:.2f} img/s incl. host pipeline)")
    return run


if __name__ == "__main__":
    main()
