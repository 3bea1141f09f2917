"""The kernels' build cache: a library's path is keyed by its source, by
every header in ``csrc/`` and by the compiler flags, so an edit to any of
them builds a new library. Nothing here needs ``nvcc`` or a card."""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import re
import shutil

import pytest

from repro_torch.kernels import _build

NAMES = ["segment_rf", "edge_spmv", "flash_attention", "decode_attention", "full_reorder", "rescale_migrate",
         "packed_sort"]


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


def test_only_their_own_sources_hold_the_names_the_benchmark_matches():
    """``perfbench/sut.py`` finds ``segment_rf``'s and ``rescale_migrate``'s
    launches in a device trace by the substrings ``segment_rf_kernel`` and
    ``rescale_migrate_kernel``: no other source may name a kernel so."""
    names = {src.stem: re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                  src.read_text())
             for src in sorted(_build.CSRC.glob("*.cu"))}
    assert sum(map(len, names.values())) == sum(src.read_text().count("__global__") for src in _build.CSRC.glob("*.cu"))
    assert names["segment_rf"] and names["rescale_migrate"] and names["packed_sort"]
    for stem, kernels in names.items():
        for kernel in kernels:
            for matched in ("segment_rf_kernel", "rescale_migrate_kernel"):
                if matched in kernel:
                    assert stem == matched[: -len("_kernel")], f"{stem}.cu defines {kernel}"
