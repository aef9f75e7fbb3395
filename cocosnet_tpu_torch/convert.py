"""Loads the JAX package's variables into the port's modules.

The JAX nets keep their variables as nested dicts, per net
{"params": ..., "spectral": ...}, with HWIO conv kernels; the port keeps the
reference's state-dict names and OIHW shapes. `flax_path` maps a port name
onto its flax leaf with the same rules as the JAX package's
`default_name_map` (train/checkpoints.py), read in the other direction, so
a port state dict also converts back through that importer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def flax_path(name: str, ndim: int) -> Tuple[str, Tuple[str, ...], str]:
    """(collection, path, kind) of the flax leaf behind a port state-dict
    entry; kind says how the value is laid out there."""
    parts = name.split(".")
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


def state_dict_from_flax(template: Mapping[str, torch.Tensor],
                         variables: Mapping) -> Dict[str, torch.Tensor]:
    """A state dict with template's names and shapes, filled from the flax
    variables of the same net (numpy arrays)."""
    out = {}
    for name, ref in template.items():
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
        out[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return out


def load_flax_variables(module: torch.nn.Module, variables: Mapping) -> None:
    """Copies one net's flax variables into `module`, every entry of its
    state dict (strict)."""
    sd = state_dict_from_flax(module.state_dict(), variables)
    module.load_state_dict(sd, strict=True)
