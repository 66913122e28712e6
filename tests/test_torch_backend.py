"""The kernel library's build cache: named by everything a build reads.

The library under ``build/repro_torch/`` is named by a hash of the CUDA
sources, the headers they include and the nvcc flags, so an edit to any of
them loads a fresh build; only the ``*.cu`` files are compiled.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import backend  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(backend, "CSRC_DIR", tmp_path)
    return tmp_path


def test_only_sources_are_compiled(csrc):
    assert [p.name for p in backend._sources()] == ["a.cu"]


@pytest.mark.parametrize("edit", ["source", "header", "flags"])
def test_library_name_follows_every_build_input(csrc, monkeypatch, edit):
    before = backend.library_path()
    assert backend.library_path() == before  # stable for an unchanged tree
    if edit == "source":
        (csrc / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    elif edit == "header":
        (csrc / "h.cuh").write_text("// v2\n")
    else:
        monkeypatch.setattr(backend, "NVCC_FLAGS", (*backend.NVCC_FLAGS, "-lineinfo"))
    assert backend.library_path() != before


def test_the_package_sources_include_every_kernel():
    names = {p.name for p in backend._sources()}
    assert {"auction_bid.cu", "auction_rounds.cu", "auction_fused.cu", "flash_attention.cu", "ssd_chunk.cu",
            "demand_accum.cu"} <= names
    assert all(name.endswith(".cu") for name in names)
