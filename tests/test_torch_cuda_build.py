"""The kernel build's cache key, on the CPU: a library is named by the hash
of its source and of every shared header, so an edit to either builds it
anew (nothing is compiled here)."""

import os

from whisper_flamingo_tpu_torch.ops import cuda_build


def test_lib_path_follows_source_and_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    assert cuda_build.build_log("k") == ""  # not built
    first = cuda_build._lib_path("k")
    assert os.path.basename(first).startswith("libk-") and first.endswith(".so")
    assert cuda_build._lib_path("k") == first
    (csrc / "h.cuh").write_text("// v2\n")
    second = cuda_build._lib_path("k")
    assert second != first
    (csrc / "other.cuh").write_text("// a new header\n")
    third = cuda_build._lib_path("k")
    assert third not in (first, second)
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert cuda_build._lib_path("k") not in (first, second, third)


def test_lib_path_of_another_source_directory(tmp_path, monkeypatch):
    """Another checkout's sources (``csrc=``) share a library with this
    one's only where every source and header is the same."""
    dirs = [tmp_path / "this", tmp_path / "other"]
    for d in dirs:
        d.mkdir()
        (d / "k.cu").write_text('#include "h.cuh"\n')
        (d / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(dirs[0]))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    assert cuda_build._lib_path("k", str(dirs[1])) == cuda_build._lib_path("k")
    (dirs[1] / "k.cu").write_text("// an earlier version, no header\n")
    (dirs[1] / "h.cuh").unlink()
    other = cuda_build._lib_path("k", str(dirs[1]))
    assert other != cuda_build._lib_path("k")
    assert os.path.dirname(other) == str(tmp_path / "build")
