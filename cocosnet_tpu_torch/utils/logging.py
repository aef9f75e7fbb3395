"""Loss printing/logging with the reference's loss_log.txt format
(util/util.py:320-331); the port's copy of cocosnet_tpu/utils/logging.py."""

from __future__ import annotations

import os
import time
from typing import Dict

from cocosnet_tpu_torch.config import Options


def print_current_errors(opt: Options, epoch: int, i: int,
                         errors: Dict[str, float], t: float) -> None:
    message = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) "
    for k, v in errors.items():
        message += f"{k}: {float(v):.3f} "
    print(message, flush=True)
    log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
    try:
        os.makedirs(os.path.dirname(log_name), exist_ok=True)
        with open(log_name, "a") as log_file:
            log_file.write(f"{message}\n")
    except OSError as err:
        print(err)
