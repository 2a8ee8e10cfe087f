"""The port's kernel build (ops/cuda/_build.py) without a GPU: the library
name is keyed by the sources, a built library is reused, a failed or
impossible build raises with the compiler's message, and the launch-side
plane checks refuse what the kernels do not take. A stand-in ``nvcc``
script plays the compiler."""

import os
import stat

import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build


@pytest.fixture
def toolchain(tmp_path, monkeypatch):
    """Sources, build directory and a stand-in nvcc, all under tmp_path."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// kernel a\n")
    (src / "common.cuh").write_text("// shared\n")
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(home))
    return src, home / "bin" / "nvcc", tmp_path / "calls"


def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def test_library_path_keyed_by_sources(toolchain):
    src, _, _ = toolchain
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    assert first == _build.library_path()
    (src / "common.cuh").write_text("// shared, edited\n")
    assert _build.library_path() != first


def test_build_compiles_once_and_reuses(toolchain):
    _, nvcc, calls = toolchain
    # writes its -o target and counts the calls
    _fake_nvcc(nvcc, f'echo x >> "{calls}"\n'
               'while [ "$1" != "-o" ]; do shift; done\n'
               ': > "$2"\n')
    out = _build.build()
    assert out.is_file() and out == _build.library_path()
    assert _build.build() == out
    # one compile per source, then one link; none on the second call
    assert calls.read_text().count("x") == 2
    assert not list(out.parent.glob("*.tmp"))


def test_failed_build_raises_with_compiler_message(toolchain):
    _, nvcc, _ = toolchain
    _fake_nvcc(nvcc, 'echo "a.cu(3): error: bad thing" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="bad thing"):
        _build.build()
    assert not _build.library_path().exists()


def test_missing_nvcc_raises(toolchain, monkeypatch):
    monkeypatch.setenv("PATH", os.fspath(toolchain[0]))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("bad,err,match", [
    (lambda x: x.double(), TypeError, "float32"),
    (lambda x: x.t(), ValueError, "contiguous"),
    (lambda x: x[:, :4], ValueError, "shape"),
])
def test_check_rejects_bad_planes(bad, err, match):
    x = torch.zeros(8, 8)
    with pytest.raises(err, match=match):
        _build.check("k", (x, bad(x)), (8, 8), x.device)
