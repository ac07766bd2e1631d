"""The kernel build cache (``kernels/build.library_path``): a library's name
hashes its source, every ``csrc/*.cuh`` header and the nvcc flags, so an
edited header gives both sources that include it a fresh library."""
import shutil

from semantic_segmentation_torch.kernels import build

CLUSTER_SOURCES = ("histogram256", "equalize_uint8")


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def test_editing_the_shared_header_renames_both_libraries(tmp_path,
                                                          monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: build.library_path(n) for n in build.SIGNATURES}
    header = csrc / "hist256_cluster.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.SIGNATURES}
    for name in CLUSTER_SOURCES:
        assert '#include "hist256_cluster.cuh"' in (
            csrc / f"{name}.cu").read_text()
        assert after[name] != before[name]
        assert after[name].name.startswith(f"lib{name}-")


def test_unchanged_sources_keep_their_library(tmp_path, monkeypatch):
    original = {n: build.library_path(n) for n in build.SIGNATURES}
    _copy_csrc(tmp_path, monkeypatch)
    assert {n: build.library_path(n) for n in build.SIGNATURES} == original


def test_editing_one_source_renames_only_its_library(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: build.library_path(n) for n in build.SIGNATURES}
    src = csrc / "histogram256.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.SIGNATURES}
    assert [n for n in before if after[n] != before[n]] == ["histogram256"]
