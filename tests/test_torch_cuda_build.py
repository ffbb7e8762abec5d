"""The name of a kernel library follows its source and every header of the
package that the source includes (rsvldm_tpu_torch/utils/cuda_build.py), so
an edited header is never served by a stale library. Nothing is compiled:
the tests work on a temporary csrc/ and build/."""

from __future__ import annotations

import pytest

from rsvldm_tpu_torch.utils import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    (src / "sub").mkdir(parents=True)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    (src / "kern.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\n'
        '  #  include "sub/c.cuh"\nint k;\n')
    (src / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (src / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint b;\n')
    # resolved beside the file that includes it: sub/d.cuh, not d.cuh
    (src / "sub" / "c.cuh").write_text('#include "d.cuh"\n')
    (src / "sub" / "d.cuh").write_text("int d;\n")
    (src / "d.cuh").write_text("int top_level_d;\n")
    (src / "other.cuh").write_text("int other;\n")
    (src / "other.cu").write_text('#include "other.cuh"\n')
    return src


def test_library_lives_in_the_build_dir_named_after_the_source(csrc):
    path = cuda_build.library_path("kern.cu")
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libkern-") and path.suffix == ".so"
    assert path != cuda_build.library_path("other.cu")


def test_sources_follow_includes_transitively(csrc):
    names = sorted(p.relative_to(csrc).as_posix()
                   for p in cuda_build._sources("kern.cu"))
    # the include cycle a -> b -> a ends; <cuda_runtime.h> is the toolkit's
    assert names == ["a.cuh", "b.cuh", "kern.cu", "sub/c.cuh", "sub/d.cuh"]


@pytest.mark.parametrize("edited, changes", [
    ("kern.cu", True),
    ("a.cuh", True),        # included directly
    ("b.cuh", True),        # included by a header
    ("sub/d.cuh", True),    # included from a subdirectory
    ("d.cuh", False),       # same name, not the one included
    ("other.cuh", False),   # included by another source only
    ("other.cu", False),
])
def test_library_path_changes_only_with_what_the_source_includes(
        csrc, edited, changes):
    before = cuda_build.library_path("kern.cu")
    f = csrc / edited
    f.write_text(f.read_text() + "// edited\n")
    assert (cuda_build.library_path("kern.cu") != before) is changes


def test_a_built_library_is_not_rebuilt(csrc, monkeypatch):
    def no_nvcc():
        raise AssertionError("nvcc called for a library already built")
    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    path = cuda_build.library_path("kern.cu")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    assert cuda_build.build("kern.cu") == ""


def test_the_port_sources_hash_their_headers():
    names = lambda src: {p.name for p in cuda_build._sources(src)}
    assert names("flash_fwd.cu") == {"flash_fwd.cu", "hopper.cuh"}
    assert names("flash_bwd.cu") == {"flash_bwd.cu", "hopper.cuh"}
    assert names("int4_decode.cu") == {"int4_decode.cu"}
