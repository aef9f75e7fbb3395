"""Loads the JAX package's variables into the port's modules.

The JAX nets keep their variables as nested dicts, per net
{"params": ..., "spectral": ...}, with HWIO conv kernels; the port keeps the
reference's state-dict names and OIHW shapes. `flax_path` maps a port name
onto its flax leaf with the same rules as the JAX package's
`default_name_map` (train/checkpoints.py) and, for the discriminator, of
its `_disc_name_map` (tools/convert_weights.py), read in the other
direction, so a port state dict also converts back through those
importers. The EMA shadows convert from the JAX TrainState's `ema` tree
(params of gen and corr) with the same names.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def flax_path(name: str, ndim: int) -> Tuple[str, Tuple[str, ...], str]:
    """(collection, path, kind) of the flax leaf behind a port state-dict
    entry; kind says how the value is laid out there."""
    parts = name.split(".")
    if (len(parts) > 2 and parts[0].startswith("discriminator_")
            and parts[1].startswith("model")):
        # model0.0 -> model0_conv, modelN.0.0 (norm-wrapped) ->
        # modelN_conv.conv, the last modelK.0 -> modelK_conv
        rest = parts[2:]
        if rest[:1] == ["0"]:
            rest = rest[1:]
            if rest[:1] == ["0"]:
                rest = ["conv"] + rest[1:]
        parts = [parts[0], parts[1] + "_conv"] + rest
    leaf, path = parts[-1], []
    for i, p in enumerate(parts[:-1]):
        if not p.isdigit():
            path.append(p)
            continue
        prev = parts[i - 1] if i else ""
        if prev == "layer":                  # layer.0 -> layer_0
            path[-1:] = [f"layer_{p}"]
        elif prev.startswith(("layer", "degridding")):
            path.append("conv")              # layer1.0 -> layer1/conv
        elif prev != "mlp_shared":           # mlp_shared.1 -> mlp_shared
            path.append(p)
    if leaf in ("weight", "weight_orig"):
        if ndim == 4:
            return "params", (*path, "kernel"), "hwio"
        if ndim == 2:
            return "params", (*path, "kernel"), "transpose"
        if leaf == "weight":
            return "params", (*path, "alpha"), "reshape"
    if leaf == "bias":
        return "params", (*path, "bias"), "same"
    if leaf == "weight_u":
        return "spectral", (*path, "u"), "same"
    if leaf == "weight_v":
        return "spectral", (*path, "v"), "same"
    if leaf == "gamma":
        return "params", (*path, "gamma"), "reshape"
    raise KeyError(f"no flax counterpart for {name!r}")


def _get(tree: Mapping, path) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _leaf(name: str, ref: torch.Tensor, variables: Mapping) -> torch.Tensor:
    """The port tensor `name` (shaped like ref) from one net's variables."""
    collection, path, kind = flax_path(name, ref.dim())
    v = _get(variables[collection], path)
    if kind == "hwio":
        v = np.transpose(v, (3, 2, 0, 1))
    elif kind == "transpose":
        v = v.T
    elif kind == "reshape":
        v = v.reshape(tuple(ref.shape))
    if tuple(v.shape) != tuple(ref.shape):
        raise ValueError(f"{name}: flax shape {v.shape} does not match "
                         f"{tuple(ref.shape)}")
    return torch.from_numpy(np.ascontiguousarray(v, np.float32))


def state_dict_from_flax(template: Mapping[str, torch.Tensor],
                         variables: Mapping) -> Dict[str, torch.Tensor]:
    """A state dict with template's names and shapes, filled from the flax
    variables of the same net (numpy arrays)."""
    return {name: _leaf(name, ref, variables)
            for name, ref in template.items()}


def load_flax_variables(module: torch.nn.Module, variables: Mapping) -> None:
    """Copies one net's flax variables into `module`, every entry of its
    state dict (strict)."""
    sd = state_dict_from_flax(module.state_dict(), variables)
    module.load_state_dict(sd, strict=True)


def ema_from_flax(template: Mapping[str, torch.Tensor],
                  ema: Mapping) -> Dict[str, torch.Tensor]:
    """EMA shadows named like train.state.g_named_parameters ("gen.<name>",
    "corr.<name>"; template gives names and shapes) from the JAX
    TrainState's ema tree {"gen": params, "corr": params}."""
    out = {}
    for key, ref in template.items():
        net, name = key.split(".", 1)
        out[key] = _leaf(name, ref, {"params": ema[net]}).to(ref.device)
    return out
