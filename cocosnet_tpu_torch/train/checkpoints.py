"""Checkpoints with torch.save: the port's counterpart of
cocosnet_tpu/train/checkpoints.py (orbax there).

A training checkpoint is the directory `<checkpoints_dir>/<name>/state_<label>/`
holding each net's state dict under the reference's file names
(util/util.py:226-250, pix2pix_trainer.py:95-99):
- net_G.pth, net_Corr.pth, net_D.pth, and with the domain classifier
  net_DomainClassifier.pth;
- with --use_ema, net_G_ema.pth and net_netCorr_ema.pth (the EMA shadows in
  place of the parameters, train.state.ema_state_dicts);
- optimizer.pth: both Adam states, the step counter and the state of the
  noise generator. A card run's Adam keeps its step counts and rate on the
  device; train.state.load_optimizer loads either kind into either.
The spectral weight_u / weight_v and the BatchNorms' running_mean /
running_var / num_batches_tracked are buffers, so they travel in the state
dicts, under the reference's names. An inference checkpoint, `state_infer_<label>/` (`save_inference`,
the output of tools/export_inference.py), holds net_G.pth and net_Corr.pth
only, the EMA shadows in place of the parameters under --use_ema. Both
are written beside their target and swapped in with two renames, so the
directory always names a complete checkpoint; a crash between the renames
leaves `<dir>.old`, which the loaders take. `load_inference` also reads
the reference's flat `<label>_net_G.pth` / `<label>_net_Corr.pth` files.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from cocosnet_tpu_torch import convert
from cocosnet_tpu_torch.train import state as S

# file name per net, and per net's EMA shadows (the reference's labels)
NET_FILES = {"gen": "net_G.pth", "corr": "net_Corr.pth", "disc": "net_D.pth"}
DOMAIN_FILE = "net_DomainClassifier.pth"
EMA_FILES = {"gen": "net_G_ema.pth", "corr": "net_netCorr_ema.pth"}
OPTIMIZER_FILE = "optimizer.pth"


def ckpt_dir(opt, label: str) -> str:
    return os.path.abspath(
        os.path.join(opt.checkpoints_dir, opt.name, f"state_{label}"))


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def _save_swapped(path: str, files: Dict[str, object]) -> str:
    """torch.save of each {file name: object} into path.new, then the old
    directory renamed to .old, .new renamed into place and .old removed
    (checkpoints.py:31-62); returns path."""
    new_path, old_path = path + ".new", path + ".old"
    shutil.rmtree(new_path, ignore_errors=True)
    shutil.rmtree(old_path, ignore_errors=True)
    os.makedirs(new_path)
    for fname, obj in files.items():
        torch.save(obj, os.path.join(new_path, fname))
    if os.path.exists(path):
        os.rename(path, old_path)
    os.rename(new_path, path)   # atomic on POSIX
    shutil.rmtree(old_path, ignore_errors=True)
    return path


def _net_files(nets) -> Dict[str, str]:
    """{net attribute: file name} of the nets `nets` holds."""
    files = {n: f for n, f in NET_FILES.items()
             if getattr(nets, n) is not None}
    if getattr(nets, "domain_classifier", None) is not None:
        files["domain_classifier"] = DOMAIN_FILE
    return files


def save_state(opt, state: S.TrainState, nets, label: str) -> str:
    """Writes state_<label>/ (see the module docstring) and returns its
    path."""
    files = {fname: _cpu(getattr(nets, name).state_dict())
             for name, fname in _net_files(nets).items()}
    if state.ema is not None:
        for name, sd in S.ema_state_dicts(state, nets).items():
            files[EMA_FILES[name]] = _cpu(sd)
    files[OPTIMIZER_FILE] = {"opt_g": state.opt_g.state_dict(),
                             "opt_d": state.opt_d.state_dict(),
                             "step": state.step,
                             "noise": state.noise.get_state()}
    return _save_swapped(ckpt_dir(opt, label), files)


def save_inference(opt, state: S.TrainState, nets, label: str) -> str:
    """Writes state_infer_<label>/ with G's and Corr's state dicts under
    net_G.pth and net_Corr.pth: the EMA shadows in place of the
    parameters when the state keeps them (--use_ema), as
    tools/export_inference.py exports them. Returns its path."""
    # ema_state_dicts gives the live parameters where state.ema is None
    sds = S.ema_state_dicts(state, nets)
    return _save_swapped(ckpt_dir(opt, f"infer_{label}"),
                         {NET_FILES[name]: _cpu(sd)
                          for name, sd in sds.items()})


def resolve_ckpt_path(path: str) -> Optional[str]:
    """`path` if it exists, else `path.old` (left behind by a crash between
    save_state's two renames), else None."""
    if os.path.isdir(path):
        return path
    old_path = path + ".old"
    if os.path.isdir(old_path):
        print(f"WARNING: {path} missing; falling back to {old_path} "
              "(interrupted checkpoint swap)")
        return old_path
    return None


def _load(path: str, device) -> Dict:
    return torch.load(path, map_location=device, weights_only=True)


def load_state(opt, state: S.TrainState, nets, label: str) -> str:
    """Restores every net, the EMA shadows, both Adam states and the step
    counter from state_<label>/ (or .old) for --continue_train; returns the
    directory read. Raises FileNotFoundError when there is none."""
    want = ckpt_dir(opt, label)
    path = resolve_ckpt_path(want)
    if path is None:
        raise FileNotFoundError(f"no checkpoint at {want}")
    # every file first, so that a checkpoint without one loads nothing
    needed = list(_net_files(nets).values())
    needed += list(EMA_FILES.values()) if state.ema is not None else []
    missing = [f for f in needed + [OPTIMIZER_FILE]
               if not os.path.exists(os.path.join(path, f))]
    if missing:
        raise FileNotFoundError(f"{path} has no {', '.join(missing)}")
    for name, fname in _net_files(nets).items():
        getattr(nets, name).load_state_dict(
            _load(os.path.join(path, fname), nets.device))
    if state.ema is not None:
        for name, fname in EMA_FILES.items():
            sd = _load(os.path.join(path, fname), nets.device)
            with torch.no_grad():
                for k, shadow in state.ema.items():
                    net, param = k.split(".", 1)
                    if net == name:
                        shadow.copy_(sd[param])
    saved = _load(os.path.join(path, OPTIMIZER_FILE), nets.device)
    S.load_optimizer(state.opt_g, saved["opt_g"])
    S.load_optimizer(state.opt_d, saved["opt_d"])
    state.lrs = None    # the saved rates: the next step writes its own
    state.step = int(saved["step"])
    noise = saved.get("noise")
    if noise is not None and noise.numel() == state.noise.get_state().numel():
        # a state of the other kind of generator (the CPU's or the card's)
        # leaves this run's seeded stream
        state.noise.set_state(noise.cpu())
    return path


def load_network(net: torch.nn.Module, path: str, device) -> None:
    """The reference's tolerant load (util/util.py:226-250): strict first;
    on a mismatch, the error and the missing and unexpected keys printed,
    then strict=False."""
    weights = _load(path, device)
    try:
        net.load_state_dict(weights)
    except RuntimeError as err:
        print(err)
        result = net.load_state_dict(weights, strict=False)
        print(f"loaded {path} with strict=False; missing keys: "
              f"{list(result.missing_keys)}, unexpected keys: "
              f"{list(result.unexpected_keys)}")


def load_inference(opt, nets, label: str) -> Optional[str]:
    """Loads G and Corr for inference, in test.py's order
    (test.py:133-183): the export's state_infer_<label>/, then the port's
    state_<label>/ (each or its .old), taking the EMA files under
    --use_ema when they are there; else the reference's flat
    <label>_net_G.pth + <label>_net_Corr.pth beside them, preferring
    <label>_net_G_ema.pth / <label>_net_netCorr_ema.pth under --use_ema.
    Returns a description of what was loaded, None when nothing was
    found."""
    root = os.path.join(opt.checkpoints_dir, opt.name)
    for which in (f"infer_{label}", label):
        path = resolve_ckpt_path(ckpt_dir(opt, which))
        if path is None:
            continue
        files = {}
        for name in ("gen", "corr"):
            ema = os.path.join(path, EMA_FILES[name])
            files[name] = (ema if opt.use_ema and os.path.exists(ema)
                           else os.path.join(path, NET_FILES[name]))
            getattr(nets, name).load_state_dict(
                _load(files[name], nets.device))
        return f"loaded {files['gen']}, {files['corr']}"
    g_path = os.path.join(root, f"{label}_net_G.pth")
    corr_path = os.path.join(root, f"{label}_net_Corr.pth")
    if opt.use_ema:
        g_ema = os.path.join(root, f"{label}_net_G_ema.pth")
        corr_ema = os.path.join(root, f"{label}_net_netCorr_ema.pth")
        g_path = g_ema if os.path.exists(g_ema) else g_path
        corr_path = corr_ema if os.path.exists(corr_ema) else corr_path
    if os.path.exists(g_path) and os.path.exists(corr_path):
        load_network(nets.gen, g_path, nets.device)
        load_network(nets.corr, corr_path, nets.device)
        return f"loaded torch checkpoints {g_path}, {corr_path}"
    return None


def load_vgg(opt, nets) -> Optional[str]:
    """The VGG19 of the perceptual losses from opt.vgg_weights: the .npz of
    tools/convert_weights.py (flax leaf paths such as conv1_1/kernel, HWIO)
    through convert.load_flax_variables, or a .pth beside it (the
    reference's vgg19_conv.pth names) by name. Returns the file read, None
    when neither exists (the seeded random VGG stays)."""
    npz = opt.vgg_weights
    pth = npz.replace(".npz", ".pth")
    if os.path.exists(npz):
        params: Dict = {}
        with np.load(npz) as data:
            for key in data.files:
                node = params
                *parents, leaf = key.split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = data[key]
        convert.load_flax_variables(nets.vgg, {"params": params})
        return npz
    if os.path.exists(pth):
        sd = _load(pth, nets.device)
        own = nets.vgg.state_dict()
        nets.vgg.load_state_dict({k: sd[k] for k in own}, strict=True)
        return pth
    return None
