"""The tile rule of csrc/conv3x3.cu's bf16 kernel (ops/conv3x3.tile_config)
on the CPU, at the conv3x3.cu calls of the flagship's forwards
(torch_fixtures.FORWARD_CONVS: ADE20k at B6 and B1, DeepFashion at B4): the
configuration each call takes is one the kernel instantiates, the work it
issues stays near the work counted, and a single request's calls spread
over the card's SMs."""

import math
import os
import re

import pytest

from cocosnet_tpu_torch.ops import conv3x3 as C
from test_torch_threads import torch_threads  # noqa: F401
from torch_fixtures import FORWARD_CONVS

SOURCE = os.path.join(os.path.dirname(os.path.dirname(C.__file__)), "csrc",
                      "conv3x3.cu")
CASES = [(name, shape) for name in sorted(FORWARD_CONVS)
         for shape, _ in FORWARD_CONVS[name]]


def _case_id(case):
    name, (b, h, w, ci, co, reflect, stats) = case
    return (f"{name}-{h}x{w}-{ci}-{co}" + ("" if reflect else "-zero")
            + ("-stats" if stats else ""))


def _instantiated():
    """The (TM, TN) list of COCOSNET_CONV3X3_TILES in the kernel's source."""
    with open(SOURCE) as f:
        src = f.read()
    block = re.search(r"#define COCOSNET_CONV3X3_TILES\(X\)(.*?)\n\n", src,
                      re.S).group(1)
    return [(int(m), int(n)) for m, n in re.findall(r"X\((\d+), (\d+)\)",
                                                     block)]


def _tiles(b, h, w, cout, tm, tn):
    return b * -(-(h * w) // tm) * -(-cout // tn)


def test_the_rule_and_the_kernel_list_the_same_tiles():
    assert _instantiated() == list(C.CONV_TILES)
    assert len(set(C.CONV_TILES)) == len(C.CONV_TILES)


@pytest.mark.parametrize("name,calls", [("ade20k-b6", 100),
                                        ("ade20k-b1", 100),
                                        ("deepfashion-b4", 84)])
def test_the_forward_lists_hold_every_call(name, calls):
    assert sum(n for _, n in FORWARD_CONVS[name]) == calls


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_every_call_maps_to_an_instantiated_configuration(case):
    _, (b, h, w, ci, co, _, _) = case
    tm, tn, path = C.tile_config(b, h, w, ci, co)
    assert (tm, tn) in _instantiated()
    assert path in C.CONV_PATHS
    assert path == "gather" or C.box_fits(tm, w)
    # a function of the shape alone
    assert C.tile_config(b, h, w, ci, co) == (tm, tn, path)


@pytest.mark.parametrize("name", ["ade20k-b6", "ade20k-b1"])
def test_the_407_stack_issues_at_most_a_tenth_more_than_it_counts(name):
    """The residual stack's 407 -> 407 statistics convs: output channels in
    two 208-wide tiles (416 issued, not 512) and each tap's channels cut to
    the k16 steps that hold them (416, not 448)."""
    stack = [s for s, _ in FORWARD_CONVS[name] if s[3] == s[4] == 407]
    assert stack
    for b, h, w, ci, co, _, _ in stack:
        tm, tn, _ = C.tile_config(b, h, w, ci, co)
        issued = (b * -(-(h * w) // tm) * tm) * (-(-co // tn) * tn) \
            * C.k16_steps(ci) * 16
        counted = b * h * w * co * 9 * ci
        assert issued / counted <= 1.10, (tm, tn, issued / counted)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "ade20k-b1"],
                         ids=[_case_id(c) for c in CASES
                              if c[0] == "ade20k-b1"])
def test_a_requests_calls_reach_nearly_every_sm(case):
    """A B1 request at 64 x 64 has 4096 output pixels: 128-pixel tiles of
    256 channels would leave more than half of the 132 SMs idle. Every call
    of the request gives at least 128 tiles (no more than 4 SMs without
    work in the first round), and a call of more than one round does not
    leave most SMs idle in its last."""
    _, (b, h, w, ci, co, _, _) = case
    tm, tn, _ = C.tile_config(b, h, w, ci, co)
    tiles = _tiles(b, h, w, co, tm, tn)
    assert tiles >= 128, (tm, tn, tiles)
    rounds = math.ceil(tiles / C.H100_SMS)
    assert tiles / (rounds * C.H100_SMS) >= 0.9, (tm, tn, tiles)


def test_k16_steps_cut_each_taps_last_stage():
    assert C.k16_steps(512) == 9 * 32
    assert C.k16_steps(407) == 9 * 26   # 408 channels a tap: 6 x 4 + 2
    assert C.k16_steps(151) == 9 * 10   # 152: 2 x 4 + 2
    assert C.k16_steps(7) == 9          # 8: one step


def test_the_box_path_takes_whole_row_segments():
    assert C.box_fits(128, 256) and C.box_fits(256, 256)
    assert C.box_fits(128, 64) and C.box_fits(256, 64)
    assert not C.box_fits(256, 32)     # eight rows
    assert not C.box_fits(128, 96)     # neither divides the other
    assert not C.box_fits(64, 20)      # nor here


def test_the_rule_adapts_to_the_grid():
    """The same channels take a smaller tile where the larger leaves SMs
    idle: 512 -> 512 at 64 x 64 takes 128 x 256 tiles at B6 (384 tiles)
    and 64-pixel tiles at B1."""
    assert C.tile_config(6, 64, 64, 512, 512)[:2] == (128, 256)
    assert C.tile_config(1, 64, 64, 512, 512)[0] == 64
    assert C.tile_config(6, 256, 256, 128, 64)[:2] == (256, 64)
