"""The kernel build's host side, checked without nvcc or a GPU.

The CUDA sources compile only on the GPU machine; what can go wrong here is
the ctypes binding (an argument list that disagrees with the C prototype is
not caught by ctypes) and the rebuild rule.
"""

import re
import shutil

import pytest
import torch

from raytrace_tpu_torch import _build


def _c_prototypes():
    protos = {}
    for src in _build.sources():
        text = src.read_text()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            protos[name] = [a.strip() for a in args.split(",")]
    return protos


def test_ctypes_signatures_match_c_prototypes():
    protos = _c_prototypes()
    assert set(protos) == set(_build._SIGNATURES)
    assert {"rt_march_paths", "rt_denoise_pass", "rt_march_paths_vol",
            "rt_trace_hf", "rt_trace_rays_vol"} <= set(protos)
    for name, args in protos.items():
        kinds = [_build._P if "*" in a else _build._I for a in args]
        assert kinds == _build._SIGNATURES[name], name


def test_library_name_follows_sources(tmp_path, monkeypatch):
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    assert _build.library_path() == first
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    assert _build.library_path() == first
    (csrc / "extra.cu").write_text("// a new source changes the hash\n")
    assert _build.library_path() != first
    assert csrc / "extra.cu" in _build.sources()


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """An edit to a shared header rebuilds: the hash covers every file
    under csrc/, not only the .cu sources."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    first = _build.library_path()
    assert (csrc / "heightfield.cuh").exists()
    assert [p.name for p in _build.sources()] == sorted(p.name for p in csrc.glob("*.cu"))
    header = csrc / "heightfield.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    edited = _build.library_path()
    assert edited != first
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path() not in (first, edited)


def test_check_tensor_and_launch_errors():
    t = torch.zeros(4, 3)
    _build.check_tensor("k", t, torch.float32, (4, 3), t.device)
    with pytest.raises(ValueError, match=r"\(not contiguous\)"):
        _build.check_tensor("k", t.t(), torch.float32, (3, 4), t.device)
    with pytest.raises(ValueError, match="int32"):
        _build.check_tensor("k", t, torch.int32, (4, 3), t.device)
    _build.check_launch("k", 0)
    with pytest.raises(RuntimeError, match="error 9"):
        _build.check_launch("k", 9)
