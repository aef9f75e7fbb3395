"""Activation recomputation: --remat (each SPADE block, and the VGG tower of
the fake) and --remat_full (the whole correspondence + generator forward),
with --remat_policy saying what a SPADE block keeps.

Counterpart of the JAX package's nn.remat / jax.checkpoint uses
(models/generator.py:40-57, :97-99, :161-163; pix2pix.py:349-353;
train/steps.py:109-115), on torch.utils.checkpoint (non-reentrant):
- `block`: a block keeps its inputs only, and the backward re-runs it;
- `conv`: it also keeps every conv output (a selective-checkpoint policy
  that saves aten.convolution), so the backward re-runs only the norms and
  the elementwise chains;
- `conv_small`: it keeps the conv outputs of at most 64 x 64 positions
  (the JAX package's "conv_small" tag, layers.py:150), re-running the
  larger convs.

The trap: torch re-runs a region's forward in the backward, and the
port's modules mutate state on a train-mode forward (a spectral norm's
power iteration writes u and v; a BatchNorm's running statistics move).
JAX's remat keeps the primal's updates only, and its recompute sees the
u and v the primal saw. So every region keeps a tape: on its first run
each stateful module records what it used (`stateful`), and on the
recompute it reads that back instead of advancing again (`replaying`
tells the BatchNorm to leave its statistics). A region inside another
(--remat with --remat_full) writes to and reads from the outer region's
tape at its own offset, so a block re-run inside the outer recompute, and
again for its own backward, sees the same u and v both times. The tape
is a plain module global, not thread-local: the autograd engine runs a
CUDA backward, and with it the recompute, on a thread of its own, while
the forward's thread waits for it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch
from torch.utils import checkpoint as _cp

# the cursor of the innermost active region's tape, or None
_ACTIVE = None

# conv outputs of at most this many positions are "small" (64 x 64)
SMALL_CONV_POSITIONS = 4096

POLICIES = ("block", "conv", "conv_small")


class _Cursor:
    def __init__(self, tape: List, pos: int, replay: bool):
        self.tape, self.pos, self.replay = tape, pos, replay


def replaying() -> bool:
    """True while a region's forward is being re-run for its backward."""
    return _ACTIVE is not None and _ACTIVE.replay


def stateful(make: Callable):
    """make() outside a region and in a region's first run (recording its
    value on the region's tape); on the recompute, the recorded value,
    without calling make."""
    cur = _ACTIVE
    if cur is None:
        return make()
    if cur.replay:
        value = cur.tape[cur.pos]
        cur.pos += 1
        return value
    value = make()
    cur.tape.append(value)
    return value


class _Region:
    """The tape context of one checkpoint call: `forward` for its first
    run, `recompute` for the re-run in the backward."""

    def __init__(self):
        self.tape: List = []
        self.start = 0

    @contextlib.contextmanager
    def forward(self):
        global _ACTIVE
        prev = _ACTIVE
        if prev is None:
            _ACTIVE = _Cursor(self.tape, 0, replay=False)
        else:
            # nested: the outer region's tape, from where this one starts
            self.tape = prev.tape
            self.start = prev.pos if prev.replay else len(prev.tape)
        try:
            yield
        finally:
            _ACTIVE = prev

    @contextlib.contextmanager
    def recompute(self):
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = _Cursor(self.tape, self.start, replay=True)
        try:
            yield
        finally:
            _ACTIVE = prev


def _conv_positions(args) -> int:
    """Output positions of an aten.convolution call from its arguments
    (input NCHW, weight OIHW, bias, stride, padding, dilation, ...)."""
    x, w = args[0], args[1]
    stride, padding, dilation = args[3], args[4], args[5]
    n = 1
    for i in range(2):
        k = w.shape[2 + i]
        n *= ((x.shape[2 + i] + 2 * padding[i] - dilation[i] * (k - 1) - 1)
              // stride[i] + 1)
    return n


def _policy_fn(small_only: bool):
    save = _cp.CheckpointPolicy.MUST_SAVE
    recompute = _cp.CheckpointPolicy.PREFER_RECOMPUTE

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.convolution.default and (
                not small_only
                or _conv_positions(args) <= SMALL_CONV_POSITIONS):
            return save
        return recompute
    return policy


def _contexts(policy: str):
    region = _Region()
    if policy == "block":
        return region.forward(), region.recompute()
    if policy not in POLICIES:
        raise ValueError(f"unknown --remat_policy {policy!r}")
    fwd, rec = _cp.create_selective_checkpoint_contexts(
        _policy_fn(policy == "conv_small"))
    return (_both(region.forward(), fwd), _both(region.recompute(), rec))


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def checkpoint(fn: Callable, *args, policy: Optional[str] = "block"):
    """fn(*args) with its activations recomputed in the backward (under
    `policy`, one of POLICIES), its stateful modules advanced once. Where
    no gradient is being recorded it is fn(*args)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return _cp.checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: _contexts(policy or "block"))
