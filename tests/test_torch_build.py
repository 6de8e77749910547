"""The kernels' build cache (pebblesdr_tpu_torch/kernels/build.py): a
library's name hashes its source, every header in csrc/ and the nvcc flags,
so an edit to any of them loads a freshly built library.  CPU only: nothing
is compiled here."""

import shutil

import pytest

from pebblesdr_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary copy of csrc/ that build.py reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_csrc_has_the_ring_header():
    assert (build.CSRC / "bulk_ring.cuh").exists()


@pytest.mark.parametrize("name", ["front", "wfm_tail"])
def test_library_path_is_stable(csrc, name):
    assert build.library_path(name) == build.library_path(name)
    assert build.library_path(name).name.startswith(f"lib{name}_")


@pytest.mark.parametrize("name", ["front", "wfm_tail"])
def test_editing_a_header_changes_the_library(csrc, name):
    before = build.library_path(name)
    header = csrc / "bulk_ring.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) != before


def test_a_new_header_changes_the_library(csrc):
    before = build.library_path("front")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("front") != before


def test_editing_the_source_changes_only_its_library(csrc):
    front, tail = build.library_path("front"), build.library_path("wfm_tail")
    src = csrc / "front.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("front") != front
    assert build.library_path("wfm_tail") == tail


def test_other_files_do_not_change_the_library(csrc):
    before = build.library_path("front")
    (csrc / "notes.txt").write_text("not a header\n")
    assert build.library_path("front") == before


# ---- the ring sweep's variant sources (tools/ring_sweep.py) ---------------

def test_ring_sweep_variant_source_sets_the_constants():
    from pebblesdr_tpu_torch.tools import ring_sweep
    src = (build.CSRC / "front.cu").read_text()
    out = ring_sweep.variant_source(src, (128, 8192, 16384, 3))
    for name, value in zip(ring_sweep.CONSTANTS, (128, 8192, 16384, 3)):
        assert f"constexpr int {name} = {value};" in out
    assert out.count("\n") == src.count("\n")


def test_ring_sweep_rejects_a_source_without_the_constants():
    from pebblesdr_tpu_torch.tools import ring_sweep
    with pytest.raises(ValueError, match="kMeansThreads"):
        ring_sweep.variant_source("// no constants\n", (1, 2, 3, 4))


def test_ring_sweep_needs_a_card():
    import torch

    from pebblesdr_tpu_torch.tools import ring_sweep
    if torch.cuda.is_available():
        pytest.skip("builds and times kernels on a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ring_sweep.main(["built"])


@pytest.mark.parametrize("variant", ["part8", "part16", "stages_deep",
                                     "block_per_item"])
def test_ring_sweep_march_variants_set_front_fir_constants(variant):
    """Each --march variant rewrites front_fir's constants once."""
    from pebblesdr_tpu_torch.tools import ring_sweep
    src = (build.CSRC / "front.cu").read_text()
    values = ring_sweep.MARCH_VARIANTS[variant]
    out = ring_sweep.variant_source(src, values, ring_sweep.MARCH_CONSTANTS)
    for name, value in zip(ring_sweep.MARCH_CONSTANTS, values):
        assert f"constexpr int {name} = {value};" in out
    assert out.count("\n") == src.count("\n")


def test_ring_sweep_march_needs_a_card():
    import torch

    from pebblesdr_tpu_torch.tools import ring_sweep
    if torch.cuda.is_available():
        pytest.skip("builds and times kernels on a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ring_sweep.main(["--march", "built"])


# ---- the stereo tail's sweep (tools/tail_cells.py --sweep) ----------------

from pebblesdr_tpu_torch.tools import tail_cells  # noqa: E402


@pytest.mark.parametrize("variant", list(tail_cells.SWEEP))
def test_tail_sweep_variants_apply_to_the_source(variant):
    """Each --sweep variant sets its constants and replaces its text once in
    csrc/wfm_tail.cu as it stands."""
    src = (build.CSRC / "wfm_tail.cu").read_text()
    consts, subs = tail_cells.SWEEP[variant]
    out = tail_cells.variant_source(src, consts, subs)
    for name, value in consts.items():
        assert f"constexpr int {name} = {value};" in out
    for _, new in subs:
        assert new in out
    assert (out == src) == (not consts and not subs)


def test_tail_sweep_rejects_text_it_cannot_find():
    with pytest.raises(ValueError, match="kWarps"):
        tail_cells.variant_source("// no constants\n", {"kWarps": 4}, [])
    with pytest.raises(ValueError, match="occurs 0 times"):
        tail_cells.variant_source("// nothing\n", {}, [("sinf(", "x")])


def test_tail_cells_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks and times K2 on a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tail_cells.sweep(["built"])
