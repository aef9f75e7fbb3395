"""What the two entry points share: the device a --platform names, the
process-wide numerics (TF32 off, the bf16 policy), where outputs go, the
label map drawn for the visual grids and the per-image output names; and
the job of processes that --mesh_data, --mesh_model and --distributed ask
for (`run_job`: one worker per device, spawned here, or the processes
torchrun started)."""

from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.nn import layers as L
from cocosnet_tpu_torch.utils import visuals as V


def device_for(platform: str, local_rank: int = 0) -> torch.device:
    """--platform: "" (the default), "gpu" or "cuda" mean the card (the
    local_rank-th visible one, made the current device: "cuda" then names
    it), and raise without one; "cpu" runs the kernels' plain versions;
    "tpu" is the JAX package's and is refused."""
    if platform in ("", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; "
                               "pass --platform cpu to run its plain "
                               "versions on the CPU")
        torch.cuda.set_device(local_rank)
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise SystemExit(f"--platform {platform!r}: the port runs on 'gpu' "
                     "(the default) or 'cpu'")


def job_size(opt: Options, all_devices: bool = True) -> tuple[int, int]:
    """(processes of the job, processes on this host) that the mesh flags
    ask for, JAX's device counts with one process a device: --mesh_data x
    --mesh_model, or with --mesh_data 0 every visible card of every host
    (--num_processes hosts under --distributed; on the CPU one a host, or
    --mesh_model), or one process where `all_devices` is False and neither
    flag exceeds 1 (test.py builds a mesh only then). Raises where the
    cards do not suffice or the global batch does not split over the data
    ranks."""
    if opt.distributed:
        M.check_distributed_flags(opt)
    hosts = opt.num_processes if opt.distributed else 1
    cuda = opt.platform != "cpu"
    cards = torch.cuda.device_count() if cuda else 0
    if not (all_devices or opt.distributed or opt.mesh_data > 1
            or opt.mesh_model > 1):
        return 1, 1
    if opt.mesh_data > 0:
        size = opt.mesh_data * opt.mesh_model
    else:
        size = (cards if cuda else opt.mesh_model) * max(hosts, 1)
    if hosts < 1 or size % hosts or size % opt.mesh_model:
        raise ValueError(f"a mesh of {opt.mesh_data} x {opt.mesh_model} "
                         f"does not split over {hosts} host(s)")
    local = size // hosts
    if cuda and local > cards:
        raise ValueError(f"the mesh needs {local} cards a host; "
                         f"{cards} are visible")
    data = size // opt.mesh_model
    if opt.batchSize % data:
        raise ValueError(f"global batchSize {opt.batchSize} must be "
                         f"divisible by the data axis {data}")
    return size, local


def global_batch(batch: dict) -> dict:
    """A loader batch (host arrays and path lists) of the global batch:
    every data rank's shard, in data-rank order (every rank calls it)."""
    parts = M.gather_data_objects(batch)
    return {k: (sum((p[k] for p in parts), []) if isinstance(v, list)
                else np.concatenate([p[k] for p in parts]))
            for k, v in batch.items()}


def run_job(entry: str, argv, opt: Options, all_devices: bool = True):
    """Runs `entry` ("module:function", taking (opt, device, mesh)) as the
    job the mesh flags ask for (job_size), and returns what it returns, or
    None where workers ran it: in this process alone (one process a host);
    in the processes torchrun started (its environment); or in one worker
    per local device, spawned here and joined (a worker that fails ends
    them all, and this raises), each the rank process_id x local +
    local_rank of the job. The module's `parse(argv)` gives each worker its
    options. Rank 0 alone prints."""
    device_for(opt.platform)  # raises without the device asked for
    if M.env_job():
        return _run_rank(entry, opt, M.env_local_rank(), 1, "")
    size, local = job_size(opt, all_devices)
    if local == 1:
        return _run_rank(entry, opt, 0, 1, "")
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="cocosnet_job_")
    init = "" if opt.distributed else "file://" + os.path.join(tmp, "store")
    try:
        argv = sys.argv[1:] if argv is None else list(argv)
        mp.start_processes(_worker, args=(entry, argv, local, init),
                           nprocs=local, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return None


def _worker(local_rank: int, entry: str, argv, local: int, init: str):
    module = importlib.import_module(entry.split(":")[0])
    opt = module.parse(argv)
    if opt.platform == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    _run_rank(entry, opt, local_rank, local, init)


def _run_rank(entry: str, opt: Options, local_rank: int, local: int,
              init: str):
    module, fn = entry.split(":")
    device = device_for(opt.platform, local_rank)
    M.maybe_init_distributed(opt, device, local_rank, local, init)
    mesh = M.create_mesh(opt.mesh_data, opt.mesh_model)
    M.set_global_mesh(mesh)
    quiet = mesh.rank != 0
    stdout = sys.stdout
    if quiet:
        sys.stdout = open(os.devnull, "w")
    elif mesh.size > 1:
        print(f"mesh: {mesh}")
    try:
        return getattr(importlib.import_module(module), fn)(opt, device,
                                                            mesh)
    finally:
        if quiet:
            sys.stdout.close()
            sys.stdout = stdout
        M.shutdown()


def set_numerics(opt: Options) -> None:
    """TF32 off in cuDNN and matmul (their default would round f32 convs
    and products to TF32), and the conv activation policy of
    --compute_dtype for the process."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    L.set_compute_dtype(torch.bfloat16 if opt.compute_dtype == "bf16"
                        else None)


def save_root(opt: Options) -> str:
    """output/ beside the checkpoints directory, or --output_dir."""
    if opt.output_dir != "./output":
        return opt.output_dir
    return os.path.join(os.path.dirname(opt.checkpoints_dir), "output")


def label_visual(label: np.ndarray, dataset_mode: str) -> np.ndarray:
    """(B, H, W, Cl) loader labels -> (B, H, W, 3) for a grid in the
    images' [-1, 1] scale (test.py:114-121): deepfashion's pose sticks (its
    first 3 channels), celebahqedge's edge map as grey, otherwise the class
    ids' colours."""
    if dataset_mode == "deepfashion":
        return label[..., :3]
    if dataset_mode == "celebahqedge":
        return np.repeat(label[..., :1], 3, axis=-1)
    rgb = V.masktorgb(label[..., 0])
    return np.transpose(rgb, (0, 2, 3, 1)) / 128.0 - 1.0


def image_name(path: str, dataset_mode: str) -> str:
    """The file name of an image's output under --save_per_img
    (test.py:103-107): deepfashion's path under Dataset/DeepFashion/ with
    its slashes as underscores, otherwise the image's own name."""
    if dataset_mode == "deepfashion":
        return path.split("Dataset/DeepFashion/")[-1].replace("/", "_")
    return os.path.basename(path)


def host(t) -> np.ndarray:
    """A tensor (any device, any float dtype) as an f32 numpy array."""
    return t.detach().float().cpu().numpy()
