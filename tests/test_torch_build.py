"""ops/_build names each kernel library by a hash of its source and of the
headers the source includes, followed recursively, so that an edited header
rebuilds every library that includes it and no other. Checked on a copy of
csrc/ (no nvcc needed: _target only hashes)."""

import shutil

import pytest

from cocosnet_tpu_torch.ops import _build
from test_torch_threads import torch_threads  # noqa: F401


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, d)
    monkeypatch.setattr(_build, "CSRC", str(d))
    return d


def _targets():
    return {name: _build._target(name) for name in _build.SOURCES}


def test_an_edited_header_changes_the_libraries_that_include_it(csrc):
    before = _targets()
    hdr = csrc / "conv3x3_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = _targets()
    changed = {n for n in before if after[n] != before[n]}
    assert changed == {"conv3x3", "conv3x3_dw"}


def test_an_edited_tensor_core_header_rebuilds_the_correlation_kernels(csrc):
    """tc_split.cuh (the 3xTF32 split, mma, ring, mainloop and GEMM) is
    shared by the correlation kernels, the shift9 forward among them, and
    by nothing else."""
    before = _targets()
    hdr = csrc / "tc_split.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = _targets()
    changed = {n for n in before if after[n] != before[n]}
    assert changed == {"corr_bwd", "corr_fwd", "shift9_fwd", "shift9_bwd"}


def test_an_edited_source_changes_its_library_only(csrc):
    before = _targets()
    src = csrc / "corr_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _targets()
    assert {n for n in before if after[n] != before[n]} == {"corr_fwd"}


def test_includes_are_followed_recursively(csrc):
    (csrc / "extra.cuh").write_text("// one\n")
    hdr = csrc / "conv3x3_common.cuh"
    hdr.write_text('#include "extra.cuh"\n' + hdr.read_text())
    first = _build._target("conv3x3")
    (csrc / "extra.cuh").write_text("// two\n")
    assert _build._target("conv3x3") != first
    assert _build._target("conv3x3").startswith(_build.BUILD_DIR)


def test_the_checked_in_sources_hash_with_their_headers():
    for name in _build.SOURCES:
        data = _build._source_bytes(name)
        assert data.startswith(open(f"{_build.CSRC}/{name}.cu", "rb").read())
    common = open(f"{_build.CSRC}/conv3x3_common.cuh", "rb").read()
    for name in ("conv3x3", "conv3x3_dw"):
        assert common in _build._source_bytes(name)
