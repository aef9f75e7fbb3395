"""Export a train checkpoint to a lean inference checkpoint: the twin of
tools/export_inference.py. It reads `<checkpoints_dir>/<name>/state_<which_
epoch>/` (the train twin's checkpoint) and writes `state_infer_<which_
epoch>/` beside it, holding net_G.pth and net_Corr.pth only, the EMA
shadows in place of the parameters under --use_ema
(train/checkpoints.save_inference). The test twin and the serve twin load
it first (train/checkpoints.load_inference). From the repository root:

  python -m cocosnet_tpu_torch.tools.export_inference --name ade20k \\
      --checkpoints_dir ./checkpoints [--which_epoch latest] [--use_ema] \\
      <the other model flags of the training run>

Runs on the GPU; --platform cpu loads and writes on the CPU.
"""

from __future__ import annotations

from cocosnet_tpu_torch import pix2pix as P
from cocosnet_tpu_torch.cli import common
from cocosnet_tpu_torch.config import parse_options
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train import state as S


def main(argv=None) -> str:
    """Returns the path of the directory written."""
    opt = parse_options(argv, is_train=True)
    device = common.device_for(opt.platform)
    nets = P.Pix2PixNets(opt, device=device, seed=opt.seed)
    state = S.create_train_state(opt, nets)
    C.load_state(opt, state, nets, opt.which_epoch)
    print(f"loaded train state '{opt.which_epoch}' at step {state.step}")
    path = C.save_inference(opt, state, nets, opt.which_epoch)
    print(f"wrote {path}" + (" (EMA weights)" if opt.use_ema else ""))
    return path


if __name__ == "__main__":
    main()
