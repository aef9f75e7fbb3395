"""Rules of the port that hold for the package as a whole: it imports no
JAX and nothing of cocosnet_tpu, its entry points default to CUDA and
raise without it, and its kernel wrappers never fall back silently."""

import ast
import os
import re

import pytest
import torch

from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from test_torch_threads import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cocosnet_tpu_torch")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_nothing_of_cocosnet_tpu(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "cocosnet_tpu")]
    assert not bad, f"{path} imports {bad}"
    with open(path) as f:
        text = f.read()
    # no dynamic import of them either, and no environment switch but the
    # JAX package's kernel switches (test_env_switches_are_the_jax_
    # package's), each named by its constant
    assert not re.search(r"import_module\(\s*['\"](jax|cocosnet_tpu\b)",
                         text)
    for m in re.finditer(r"\bos\.(environ|getenv)\b(.{0,24})", text):
        assert re.search(r"\b(MK1_TRAIN|DW|FUSED_TRAIN|FUSED|FUSED_STATS|"
                         r"ONEHOT)_ENV\b",
                         m.group(2)), (path, m.group(0))


def test_env_switches_are_the_jax_packages():
    """The port reads the environment switches the JAX package reads to
    route its kernels (pallas_conv.py:521, :600, :635, :664, :795;
    correspondence.py:313), by the same names."""
    from cocosnet_tpu_torch.models import correspondence as TCR
    from cocosnet_tpu_torch.nn import layers as TL
    from cocosnet_tpu_torch.ops import conv3x3 as C
    with open(os.path.join(ROOT, "cocosnet_tpu", "ops",
                           "pallas_conv.py")) as f:
        conv_src = f.read()
    with open(os.path.join(ROOT, "cocosnet_tpu", "models",
                           "correspondence.py")) as f:
        corr_src = f.read()
    for name, src in ((C.DW_ENV, conv_src), (TL.FUSED_TRAIN_ENV, conv_src),
                      (TL.FUSED_ENV, conv_src), (TL.FUSED_STATS_ENV, conv_src),
                      (TL.ONEHOT_ENV, conv_src),
                      (TCR.MK1_TRAIN_ENV, corr_src)):
        assert f'"{name}"' in src, name


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = TCFG.test_defaults(dataset_mode="ade20k", label_nc=12,
                             contain_dontcare_label=True, crop_size=64,
                             ngf=8, PONO=True, isTrain=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.Pix2PixNets(opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.preprocess_input(opt, {}, device=None)
    TP.Pix2PixNets(opt, device="cpu")  # the explicit CPU request is taken


def test_unported_options_raise():
    opt = TCFG.test_defaults(dataset_mode="ade20k", label_nc=12, ngf=8,
                             PONO=True, isTrain=False, warp_patch=True)
    with pytest.raises(NotImplementedError, match="warp_patch"):
        TP.Pix2PixNets(opt, device="cpu")


@pytest.mark.parametrize("match_kernel,ported", [(1, True), (3, True),
                                                 (5, False)])
def test_match_kernel_values(match_kernel, ported):
    opt = TCFG.test_defaults(dataset_mode="ade20k", label_nc=12, ngf=8,
                             PONO=True, isTrain=False,
                             match_kernel=match_kernel)
    if ported:
        TP.check_ported(opt)
    else:
        with pytest.raises(NotImplementedError, match="match_kernel"):
            TP.check_ported(opt)


def test_kernel_sources_build_from_the_package():
    """Every kernel the build knows has its source in the package, and the
    build writes under the checkout (build/kernels), nowhere else."""
    from cocosnet_tpu_torch.ops import _build
    for name in _build.SOURCES:
        assert os.path.exists(os.path.join(_build.CSRC, name + ".cu"))
    assert os.path.commonpath([_build.BUILD_DIR, ROOT]) == ROOT
