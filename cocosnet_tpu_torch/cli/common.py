"""What the two entry points share: the device a --platform names, the
process-wide numerics (TF32 off, the bf16 policy), where outputs go, and
the label map drawn for the visual grids."""

from __future__ import annotations

import os

import numpy as np
import torch

from cocosnet_tpu_torch.config import Options
from cocosnet_tpu_torch.nn import layers as L
from cocosnet_tpu_torch.utils import visuals as V


def device_for(platform: str) -> torch.device:
    """--platform: "" (the default), "gpu" or "cuda" mean the card, and
    raise without one; "cpu" runs the kernels' plain versions; "tpu" is the
    JAX package's and is refused."""
    if platform in ("", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; "
                               "pass --platform cpu to run its plain "
                               "versions on the CPU")
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise SystemExit(f"--platform {platform!r}: the port runs on 'gpu' "
                     "(the default) or 'cpu'")


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


def label_visual(label: np.ndarray) -> np.ndarray:
    """(B, H, W, 1) class ids -> (B, H, W, 3) colours in [-1, 1) for a
    grid (test.py:112-118)."""
    rgb = V.masktorgb(label[..., 0])
    return np.transpose(rgb, (0, 2, 3, 1)) / 128.0 - 1.0


def host(t) -> np.ndarray:
    """A tensor (any device, any float dtype) as an f32 numpy array."""
    return t.detach().float().cpu().numpy()
