"""The kernels' build cache: a library's path is keyed by its source, by
every header in ``csrc/`` and by the compiler flags, so an edit to any of
them builds a new library. Nothing here needs ``nvcc`` or a card."""
import shutil

import pytest

from repro_torch.kernels import _build

NAMES = ["segment_rf", "edge_spmv", "flash_attention", "decode_attention", "full_reorder"]


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


@pytest.mark.parametrize("name", NAMES)
def test_library_path_changes_when_a_header_changes(csrc_copy, name):
    before = _build.library_path(name)
    header = csrc_copy / "flash_attention.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before and after.parent == before.parent and after.name.startswith(f"{name}-")


@pytest.mark.parametrize("name", NAMES)
def test_library_path_is_stable_and_follows_its_source(csrc_copy, name):
    before = _build.library_path(name)
    assert _build.library_path(name) == before
    src = csrc_copy / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


def test_a_new_header_changes_the_path(csrc_copy):
    before = _build.library_path("flash_attention")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("flash_attention") != before
