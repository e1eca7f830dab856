"""The port's nvcc build keys (CPU, no nvcc needed): a library's name holds a
hash of its source, of the headers beside it and of its flags, so an edit to
a shared header rebuilds every source that may include it, and a source from
another directory never takes the package's library. Then :func:`launch`,
the one launch path of the kernel wrappers, with the C entry point and the
stream faked: what it passes, what it raises and what it counts."""

import collections

import pytest
import torch

from ivid_tpu_torch import cuda_build


def _write(d, files):
    d.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (d / name).write_text(text)
    return d


def test_library_key_follows_source_and_headers(tmp_path):
    d = _write(tmp_path / "src", {"k.cu": "// kernel\n", "common.cuh": "// v1\n"})
    first = cuda_build._library("k", d)
    assert first == cuda_build._library("k", d)
    (d / "common.cuh").write_text("// v2\n")
    second = cuda_build._library("k", d)
    assert second != first
    (d / "k.cu").write_text("// kernel, edited\n")
    assert cuda_build._library("k", d) not in (first, second)
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("libk-")


def test_other_directory_and_link_flags_change_the_key(tmp_path):
    files = {"packed_attention.cu": "// same text\n"}
    a = cuda_build._library("packed_attention", _write(tmp_path / "a", files))
    b = cuda_build._library("packed_attention", _write(tmp_path / "b", files))
    assert a != b
    assert cuda_build._flags("packed_attention")[-1] == "-lcuda"
    assert cuda_build._flags("packed_attention_bwd")[-1] == "-lcuda"
    assert "-lcuda" not in cuda_build._flags("dense_raster")
    assert set(cuda_build.SOURCES) >= {"packed_attention", "packed_attention_bwd", "dense_raster",
                                       "zbuffer_resolve", "binned_resolve", "tile_resolve",
                                       "group_norm"}
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").exists()
        assert cuda_build._library(name).name.startswith(f"lib{name}-")


class _FakeStream:
    cuda_stream = 1234


@pytest.mark.parametrize("rc, count", [
    (0, ("GN",)),
    (0, ("K1", ("K1", 768), "K1 f32")),
    (0, ()),
    (700, ("K1", ("K1", 768))),
    (1, ()),
], ids=["one_key", "key_and_extras", "no_key", "error", "error_no_key"])
def test_launch_passes_the_stream_raises_on_errors_and_counts(rc, count, monkeypatch):
    """The entry point gets the arguments, then the current stream; a zero
    return code counts one launch under each key given, a non-zero one
    raises, naming the kernel, and counts nothing."""
    calls, looked_up = [], []

    def function(*args):
        looked_up.append(args)
        return lambda *a: calls.append(a) or rc

    monkeypatch.setattr(cuda_build, "function", function)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(cuda_build, "launches", collections.Counter({"K2": 5}))
    args = ("lib", "lib_launch", ["argtypes"], torch.device("cpu"), 11, 2.5)
    if rc:
        with pytest.raises(RuntimeError, match=f"lib_launch kernel launch failed: CUDA error {rc}"):
            cuda_build.launch(*args, count=count)
        assert cuda_build.launches == {"K2": 5}
    else:
        cuda_build.launch(*args, count=count)
        assert cuda_build.launches == collections.Counter({"K2": 5}) + collections.Counter(count)
        assert all(cuda_build.launches[k] == 1 for k in count)
    assert looked_up == [("lib", "lib_launch", ["argtypes"])]
    assert calls == [(11, 2.5, 1234)]
